"""Export a JAX checkpoint of this repo to one `.npz` that the PyTorch port
reads without JAX.

  JAX_PLATFORMS=cpu python tools/export_jax_checkpoint.py \
      results/round3/vocoder_ckpt/step_4000 \
      music_spectrogram_diffusion_tpu_torch/assets/magnitude_gl_step4000.npz

  JAX_PLATFORMS=cpu python tools/export_jax_checkpoint.py \
      <t5x dir>/checkpoint_500000 model.npz --preset ismir2021_base

The checkpoint is a `step_<N>` directory, or a model directory (its latest
step), restored through `music_spectrogram_diffusion_tpu.train.checkpoints
.restore_checkpoint`; or a T5X checkpoint directory (one that holds a
`checkpoint` index file, as the published checkpoints do), read through
`load_t5x_checkpoint`, which also renames the reference's modules to this
repo's. The `.npz` holds:

* `params/<path>`: every leaf of the restored `params` tree, its path
  joined with `/`, as the restore gives it (no renaming: a vocoder
  checkpoint keeps the extra `params` level its trainer saved, so its
  leaves are `params/params/conv_in/kernel` and so on);
* `config_json`: the checkpoint's `config.json` sidecar as text (an
  ExperimentConfig for a model of any family, `{"arch": ..., "hidden":
  ...}` for a vocoder), or "" if it has none; for a T5X directory, which
  carries gin and no config.json, the ExperimentConfig of `--preset`;
* `step`: the step of its METADATA (of a T5X directory: N of its
  `checkpoint_<N>` name), -1 if it has none.

The port reads it with `music_spectrogram_diffusion_tpu_torch.convert
.read_export`. This tool is the only place JAX is imported on the way to
the port.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict, Mapping, Optional

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def flatten(tree: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
  out = {}
  for key, value in tree.items():
    path = f"{prefix}/{key}"
    if isinstance(value, Mapping):
      out.update(flatten(value, path))
    else:
      out[path] = np.asarray(value)
  return out


def is_t5x(checkpoint: str) -> bool:
  return os.path.isfile(os.path.join(checkpoint, "checkpoint"))


def restore_t5x(checkpoint: str, preset: Optional[str]) -> Dict[str, Any]:
  """A T5X directory as `restore_checkpoint` gives a JAX one: the params
  renamed to this repo's layout, `preset`'s ExperimentConfig as
  config_json, the step from the directory's name."""
  from music_spectrogram_diffusion_tpu import config
  from music_spectrogram_diffusion_tpu.train import checkpoints
  restored = {"params": checkpoints.load_t5x_checkpoint(checkpoint)}
  if preset:
    restored["config_json"] = config.preset(preset).to_json()
  name = os.path.basename(os.path.normpath(checkpoint))
  if name.startswith("checkpoint_") and name[11:].isdigit():
    restored["step"] = int(name[11:])
  return restored


def export(checkpoint: str, output: str,
           preset: Optional[str] = None) -> Dict[str, np.ndarray]:
  """Restore `checkpoint` and write it to `output`; returns what was
  written. `preset` names the experiment of a T5X directory."""
  sys.path.insert(0, ROOT)
  if is_t5x(checkpoint):
    restored = restore_t5x(checkpoint, preset)
  else:
    if preset:
      raise ValueError("--preset is for T5X directories; a JAX checkpoint "
                       "of this repo carries its own config.json")
    from music_spectrogram_diffusion_tpu.train import checkpoints
    restored = checkpoints.restore_checkpoint(checkpoint)
  arrays = flatten(restored["params"], "params")
  arrays["config_json"] = np.asarray(restored.get("config_json", ""))
  arrays["step"] = np.asarray(int(restored.get("step", -1)), np.int64)
  os.makedirs(os.path.dirname(os.path.abspath(output)), exist_ok=True)
  tmp = output + ".tmp.npz"
  np.savez(tmp, **arrays)
  os.replace(tmp, output)
  return arrays


def main(argv=None) -> None:
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("checkpoint", help="step_<N> directory, model directory "
                 "or T5X checkpoint directory")
  p.add_argument("output", help="the .npz to write")
  p.add_argument("--preset", default=None,
                 help="a T5X directory's experiment (e.g. ismir2021_base, "
                      "ar_base), written as its config_json")
  args = p.parse_args(argv)
  arrays = export(args.checkpoint, args.output, args.preset)
  n_params = sum(v.size for k, v in arrays.items() if k.startswith("params/"))
  print(f"wrote {args.output}: {len(arrays) - 2} leaves, {n_params} values, "
        f"step {int(arrays['step'])}, config {arrays['config_json']}")


if __name__ == "__main__":
  main()
