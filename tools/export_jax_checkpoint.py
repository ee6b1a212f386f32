"""Export a JAX checkpoint of this repo to one `.npz` that the PyTorch port
reads without JAX.

  JAX_PLATFORMS=cpu python tools/export_jax_checkpoint.py \
      results/round3/vocoder_ckpt/step_4000 \
      music_spectrogram_diffusion_tpu_torch/assets/magnitude_gl_step4000.npz

The checkpoint is a `step_<N>` directory, or a model directory (its latest
step), restored through `music_spectrogram_diffusion_tpu.train.checkpoints
.restore_checkpoint`. The `.npz` holds:

* `params/<path>`: every leaf of the restored `params` tree, its path
  joined with `/`, as the restore gives it (no renaming: a vocoder
  checkpoint keeps the extra `params` level its trainer saved, so its
  leaves are `params/params/conv_in/kernel` and so on);
* `config_json`: the checkpoint's `config.json` sidecar as text (an
  ExperimentConfig for a diffusion model, `{"arch": ..., "hidden": ...}`
  for a vocoder), or "" if it has none;
* `step`: the step of its METADATA, -1 if it has none.

The port reads it with `music_spectrogram_diffusion_tpu_torch.convert
.read_export`. This tool is the only place JAX is imported on the way to
the port.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict, Mapping

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


def export(checkpoint: str, output: str) -> Dict[str, np.ndarray]:
  """Restore `checkpoint` and write it to `output`; returns what was
  written."""
  sys.path.insert(0, ROOT)
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
  p.add_argument("checkpoint", help="step_<N> directory or model directory")
  p.add_argument("output", help="the .npz to write")
  args = p.parse_args(argv)
  arrays = export(args.checkpoint, args.output)
  n_params = sum(v.size for k, v in arrays.items() if k.startswith("params/"))
  print(f"wrote {args.output}: {len(arrays) - 2} leaves, {n_params} values, "
        f"step {int(arrays['step'])}, config {arrays['config_json']}")


if __name__ == "__main__":
  main()
