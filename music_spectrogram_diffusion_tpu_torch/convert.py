"""Weight bridge: a Flax `params` tree -> the port's `state_dict`.

The tree is nested dicts of numpy arrays, as `flax.serialization` or an
`.npz` export of a JAX checkpoint gives it (the `params` level itself, not
`{"params": ...}`). Every leaf is copied exactly in float32:

* names: `layers_<i>` -> `layers.<i>`, `cross_attention_<i>` ->
  `cross_attentions.<i>`, FiLM's `DenseGeneral_0` -> `dense`, `/` -> `.`;
* DenseGeneral kernels are reshaped to the port's flat [in, out] layout
  (a no-op for this repo's trees, which store them flat; t5x-style
  [emb, heads, head_dim] kernels flatten row-major to the same matrix);
* the position tables, FiLM kernels and norm scales are parameters and are
  copied like any other leaf (the permuted tables are never recomputed).

An int8 serving tree (the JAX package's `quantize_params` output) is taken
too: an int8 `kernel` and its sibling float32 `kernel_scale` are copied
exactly, as int8 and float32, and load into the DenseGeneral's int8 form
(`infer.inference.load_serving_state_`). Float leaves of such a tree (bf16
after the serving cast) are copied exactly in float32, like any other.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

_RENAMES = (
    (re.compile(r"(^|/)layers_(\d+)(?=/)"), r"\1layers/\2"),
    (re.compile(r"(^|/)cross_attention_(\d+)(?=/)"), r"\1cross_attentions/\2"),
    (re.compile(r"(^|/)DenseGeneral_0(?=/)"), r"\1dense"),
)


def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
  """Nested dicts -> {'a/b/c': leaf}."""
  out = {}
  for key, value in tree.items():
    path = f"{prefix}/{key}" if prefix else str(key)
    if isinstance(value, Mapping):
      out.update(flatten(value, path))
    else:
      out[path] = value
  return out


def torch_name(flax_path: str) -> str:
  """'decoder/layers_3/mlp_film/DenseGeneral_0/kernel' ->
  'decoder.layers.3.mlp_film.dense.kernel'."""
  for pattern, repl in _RENAMES:
    flax_path = pattern.sub(repl, flax_path)
  return flax_path.replace("/", ".")


def flax_to_state_dict(params: Mapping[str, Any],
                       module: nn.Module) -> Dict[str, torch.Tensor]:
  """Map a Flax params tree onto `module`'s state_dict keys and shapes.

  `module` is the float model; an int8 kernel maps onto its float
  kernel's name and shape, and its `kernel_scale` onto a new name beside
  it. Raises if a leaf has no counterpart, a counterpart has no leaf, a
  size differs, or an int8 kernel and its scale do not come in a pair.
  """
  if "params" in params and len(params) == 1:
    raise ValueError("pass the tree under 'params', not the variables dict")
  flat = flatten(params)
  target = module.state_dict()
  out: Dict[str, torch.Tensor] = {}
  for path, leaf in flat.items():
    arr = np.asarray(leaf)
    name = torch_name(path)
    if path.endswith("/kernel_scale"):
      kernel_path = path[:-len("_scale")]
      if np.asarray(flat.get(kernel_path)).dtype != np.int8:
        raise ValueError(f"{path} without an int8 kernel beside it")
      kernel = target.get(name[:-len("_scale")])
      if kernel is None or arr.shape != (kernel.shape[1],):
        raise ValueError(f"{path}: {arr.shape} does not fit the columns of "
                         f"{name[:-len('_scale')]}")
      out[name] = torch.from_numpy(np.array(arr, dtype=np.float32))
      continue
    if arr.dtype == np.int8 and f"{path}_scale" not in flat:
      raise ValueError(f"int8 leaf {path} has no kernel_scale beside it")
    if name not in target:
      raise KeyError(f"Flax leaf {path} -> {name}: no such parameter")
    want = tuple(target[name].shape)
    if arr.size != int(np.prod(want)):
      raise ValueError(f"{path}: {arr.shape} does not fit {name} {want}")
    dtype = np.int8 if arr.dtype == np.int8 else np.float32
    out[name] = torch.from_numpy(np.array(arr, dtype=dtype).reshape(want))
  missing = sorted(set(target) - set(out))
  if missing:
    raise KeyError(f"parameters without a Flax leaf: {missing}")
  return out
