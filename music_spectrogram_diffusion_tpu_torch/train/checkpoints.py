"""Checkpoints of the port's training: save, find the latest, restore.

The layout of music_spectrogram_diffusion_tpu/train/checkpoints.py:
`<model_dir>/step_<N>/` holds the state, the experiment as `config.json`
and `METADATA` ({"step", "has_opt_state"}). The state is the port's own
format, not orbax: one `torch.save` file, `state.pt`, of {"params": the
module's state_dict (every parameter, the fixed position tables too, as
the JAX params tree holds them), "opt_state": the optimizer state}, every
tensor on the CPU. `config.json` and `METADATA` are written first and
the state last, to a temporary name that is then renamed: a save cut
short leaves no `state.pt`, `latest_checkpoint` skips that directory, and
one it accepts always has its step.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Mapping, Optional

import torch

STATE_FILE = "state.pt"


def _to_cpu(tree):
  if isinstance(tree, torch.Tensor):
    return tree.detach().cpu()
  if isinstance(tree, Mapping):
    return {k: _to_cpu(v) for k, v in tree.items()}
  return tree


def save_checkpoint(ckpt_dir: str, step: int,
                    params: Mapping[str, torch.Tensor],
                    opt_state: Optional[Mapping[str, Any]] = None,
                    config_json: Optional[str] = None) -> str:
  """Save params (and the optimizer state) under ckpt_dir/step_<N>/."""
  path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")
  os.makedirs(path, exist_ok=True)
  payload = {"params": _to_cpu(dict(params))}
  if opt_state is not None:
    payload["opt_state"] = _to_cpu(dict(opt_state))
  if config_json is not None:
    with open(os.path.join(path, "config.json"), "w") as f:
      f.write(config_json)
  with open(os.path.join(path, "METADATA"), "w") as f:
    json.dump({"step": step, "has_opt_state": opt_state is not None}, f)
  tmp = os.path.join(path, STATE_FILE + ".tmp")
  torch.save(payload, tmp)
  os.replace(tmp, os.path.join(path, STATE_FILE))
  return path


def checkpoint_metadata(path: str) -> Dict[str, Any]:
  """The METADATA of a step_<N> directory ({} if absent)."""
  meta_path = os.path.join(path, "METADATA")
  if not os.path.exists(meta_path):
    return {}
  with open(meta_path) as f:
    return json.load(f)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
  """The step_<N> directory with the largest N that holds a state."""
  if not os.path.isdir(ckpt_dir):
    return None
  steps = []
  for name in os.listdir(ckpt_dir):
    m = re.fullmatch(r"step_(\d+)", name)
    if m and os.path.exists(os.path.join(ckpt_dir, name, STATE_FILE)):
      steps.append(int(m.group(1)))
  if not steps:
    return None
  return os.path.join(ckpt_dir, f"step_{max(steps)}")


def restore_checkpoint(path: str, device="cpu") -> Dict[str, Any]:
  """{"params", "opt_state" (if saved), "step", "config_json" (if saved)}
  from a step_<N> directory, or from the latest one under `path`; the
  tensors on `device`."""
  if not os.path.basename(os.path.normpath(path)).startswith("step_"):
    latest = latest_checkpoint(path)
    if latest is None:
      raise FileNotFoundError(f"no checkpoints under {path}")
    path = latest
  restored = dict(torch.load(os.path.join(path, STATE_FILE),
                             map_location=device, weights_only=True))
  meta = checkpoint_metadata(path)
  if "step" in meta:
    restored["step"] = meta["step"]
  config_path = os.path.join(path, "config.json")
  if os.path.exists(config_path):
    with open(config_path) as f:
      restored["config_json"] = f.read()
  return restored
