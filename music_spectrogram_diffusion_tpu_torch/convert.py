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

The vocoders' convolutions map with `flax_convs_to_state_dict`: a Flax
`Conv` / `ConvTranspose` kernel [k, in, out] becomes torch's conv weight
[out, in, k], its bias is copied as it is.

The trees of all three model families map this way: the context and
notes-only diffusion networks and the autoregressive one (whose position
tables are computed, not stored, in both packages).

A JAX checkpoint reaches the port as one `.npz` written by
`tools/export_jax_checkpoint.py`; `read_export` reads it. A published T5X
checkpoint names its modules as the reference code does; `remap_t5x_params`
(a copy of the JAX package's, train/checkpoints.py) renames such a tree to
this repo's names, as the JAX package's `load_t5x_checkpoint` does.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping, Tuple

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


def unflatten(flat: Mapping[str, Any]) -> Dict[str, Any]:
  """{'a/b/c': leaf} -> nested dicts."""
  tree: Dict[str, Any] = {}
  for path, value in flat.items():
    node = tree
    parts = path.split("/")
    for part in parts[:-1]:
      node = node.setdefault(part, {})
    node[parts[-1]] = value
  return tree


# The reference module tree -> this repo's (JAX train/checkpoints.py
# _T5X_RENAMES): the published checkpoints name layer norms
# `*_layer_norm`, leave cross-attention and FiLM modules unnamed (so Flax
# numbered them) and create the position encoders inline as `Embed_0`.
_T5X_RENAMES = (
    (r"pre_attention_layer_norm", "pre_attention_norm"),
    (r"pre_mlp_layer_norm", "pre_mlp_norm"),
    (r"pre_self_attention_layer_norm", "pre_self_attention_norm"),
    (r"pre_cross_attention_layer_norm", "pre_cross_attention_norm"),
    (r"MultiHeadDotProductAttention_(\d+)", r"cross_attention_\1"),
    (r"FiLMLayer_0/DenseGeneral_0", "self_attention_film/DenseGeneral_0"),
    (r"FiLMLayer_1/DenseGeneral_0", "mlp_film/DenseGeneral_0"),
    (r"Embed_0", "position_encoder"),
)


def t5x_rename(path: str) -> str:
  """One '/'-joined path of a reference tree -> this repo's."""
  for pattern, replacement in _T5X_RENAMES:
    path = re.sub(pattern, replacement, path)
  return path


def remap_t5x_params(t5x_params: Mapping[str, Any]) -> Dict[str, Any]:
  """A reference (T5X) params tree in this repo's layout, leaves as given."""
  return unflatten({t5x_rename(k): v for k, v in flatten(t5x_params).items()})


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


EXPORT_TOOL = "tools/export_jax_checkpoint.py"


def read_export(path: str) -> Tuple[Dict[str, Any], str, int]:
  """An exported JAX checkpoint -> (params tree of numpy arrays,
  config_json text, step).

  Raises ValueError, naming the export tool, for anything that is not
  such an export (an orbax directory, another `.npz`)."""
  path = os.fspath(path)
  hint = (f"{path} is not an exported JAX checkpoint; export one to .npz "
          f"with {EXPORT_TOOL}")
  if os.path.isdir(path) or not path.endswith(".npz"):
    raise ValueError(hint)
  with np.load(path) as z:
    if "config_json" not in z.files or "step" not in z.files:
      raise ValueError(hint)
    tree = unflatten({key[len("params/"):]: z[key] for key in z.files
                      if key.startswith("params/")})
    return tree, str(z["config_json"].item()), int(z["step"])


def conv_weight(kernel: np.ndarray) -> torch.Tensor:
  """A Flax Conv/ConvTranspose kernel [k, in, out] -> torch [out, in, k],
  exactly, in float32."""
  arr = np.asarray(kernel)
  if arr.ndim != 3:
    raise ValueError(f"a 1-d conv kernel has 3 dims, got {arr.shape}")
  return torch.from_numpy(np.ascontiguousarray(
      np.array(arr, dtype=np.float32).transpose(2, 1, 0)))


def flax_convs_to_state_dict(params: Mapping[str, Any],
                             module: nn.Module) -> Dict[str, torch.Tensor]:
  """Map a Flax params tree of 1-d convolutions onto `module`'s state_dict:
  'a/b/kernel' -> 'a.b.weight' (`conv_weight`), 'a/b/bias' -> 'a.b.bias'.
  Raises if a leaf has no counterpart, a counterpart has no leaf, or a
  shape differs."""
  target = module.state_dict()
  out: Dict[str, torch.Tensor] = {}
  for path, leaf in flatten(params).items():
    stem, _, leaf_name = path.rpartition("/")
    stem = stem.replace("/", ".")
    if leaf_name == "kernel":
      name, value = f"{stem}.weight", conv_weight(leaf)
    elif leaf_name == "bias":
      name = f"{stem}.bias"
      value = torch.from_numpy(np.array(leaf, dtype=np.float32))
    else:
      raise KeyError(f"Flax leaf {path}: not a conv kernel or bias")
    if name not in target:
      raise KeyError(f"Flax leaf {path} -> {name}: no such parameter")
    if tuple(value.shape) != tuple(target[name].shape):
      raise ValueError(f"{path}: {tuple(value.shape)} does not fit {name} "
                       f"{tuple(target[name].shape)}")
    out[name] = value
  missing = sorted(set(target) - set(out))
  if missing:
    raise KeyError(f"parameters without a Flax leaf: {missing}")
  return out
