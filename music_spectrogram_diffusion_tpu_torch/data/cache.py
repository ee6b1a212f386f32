"""Offline task cache: tokenized examples -> TFRecord shards -> Dataset.

A copy of music_spectrogram_diffusion_tpu/data/cache.py (the port imports
nothing of the JAX package). Tokenization runs once, offline: the
pre-cache chain tokenize -> rekey -> split into <= 2000-frame chunks is
written to disk, and every training epoch reads the chunks back.

  * `write_cache(ds, cache_dir)` serializes any example stream into
    TFRecord shards with a self-describing feature encoding (per-feature
    shape and dtype side entries, a pickle for rich objects).
  * `read_cache(cache_dir)` streams them back as a Dataset, each example
    exactly as it was written.
  * `Task` integration lives in tasks.Task.{build_cache,tokenized}.

The wire format is the JAX package's byte for byte (tf.train.Example in
TFRecord framing), so a cache that either package wrote reads in the other.
A pickled object that names a class of the JAX package (the tokenized
chunks' `sequence`, a NoteSequence) is read as the port's copy of that
class, so reading a JAX-written cache imports nothing of the JAX package.
"""

from __future__ import annotations

import glob as globlib
import importlib
import io
import json
import os
import pickle
from typing import Any, Dict, Iterator, Optional

import numpy as np

from music_spectrogram_diffusion_tpu_torch.data import core
from music_spectrogram_diffusion_tpu_torch.data import datasets

_SHAPE = "__shape__"
_DTYPE = "__dtype__"
_PICKLE = "__pickle__"
SHARD_TEMPLATE = "cache-{:05d}.tfrecord"
METADATA_FILE = "CACHE_METADATA.json"
# The JAX package, and the port that holds a copy of each of its modules
# that a cached object can name.
_JAX_PACKAGE = "music_spectrogram_diffusion_tpu"
_PORT_PACKAGE = "music_spectrogram_diffusion_tpu_torch"


class _PortUnpickler(pickle.Unpickler):
  """Unpickles a class of the JAX package as the port's copy of it (the
  same module path under the port's package)."""

  def find_class(self, module: str, name: str):
    if module == _JAX_PACKAGE or module.startswith(_JAX_PACKAGE + "."):
      module = _PORT_PACKAGE + module[len(_JAX_PACKAGE):]
      return getattr(importlib.import_module(module), name)
    return super().find_class(module, name)


def _unpickle(raw: bytes) -> Any:
  return _PortUnpickler(io.BytesIO(raw)).load()


def encode_example(example: Dict[str, Any]) -> bytes:
  """Serialize one example dict to a tf.train.Example record.

  Arrays ride as raw little-endian bytes (BytesList features) with
  dtype/shape side entries, so decoding is one np.frombuffer per feature.
  """
  features: Dict[str, Any] = {}
  for key, value in example.items():
    if isinstance(value, (bytes, str)):
      features[key] = value
      features[_DTYPE + key] = "bytes"
      continue
    arr = np.asarray(value)
    if arr.dtype == object or arr.dtype.kind in "US":
      features[key] = pickle.dumps(value)
      features[_DTYPE + key] = _PICKLE
      continue
    if arr.dtype.kind not in "fiub":
      raise TypeError(f"unsupported feature {key!r}: {arr.dtype}")
    arr = arr.astype(arr.dtype.newbyteorder("<"))
    features[_DTYPE + key] = arr.dtype.str
    features[_SHAPE + key] = np.asarray(arr.shape, np.int64)
    features[key] = arr.tobytes()
  return datasets.serialize_example(features)


def decode_example(record: bytes) -> Dict[str, Any]:
  """Inverse of encode_example."""
  raw = datasets.parse_example(record)
  out: Dict[str, Any] = {}
  for key, value in raw.items():
    if key.startswith(_SHAPE) or key.startswith(_DTYPE):
      continue
    dtype_entry = raw.get(_DTYPE + key)
    dtype = (dtype_entry[0].decode() if isinstance(dtype_entry, list)
             else None)
    if dtype == "bytes" or dtype is None and isinstance(value, list):
      out[key] = value[0]
    elif dtype == _PICKLE:
      out[key] = _unpickle(value[0])
    else:
      shape = tuple(int(x) for x in raw.get(_SHAPE + key, []))
      out[key] = np.frombuffer(
          value[0], dtype=np.dtype(dtype)).reshape(shape)
  return out


def write_cache(ds: core.Dataset, cache_dir: str,
                examples_per_shard: int = 128) -> Dict[str, Any]:
  """Materialize a dataset into TFRecord shards under cache_dir.

  Returns the metadata dict (also written to CACHE_METADATA.json:
  num_examples / num_shards).
  """
  os.makedirs(cache_dir, exist_ok=True)
  # Drop the metadata first, so that an interrupted rebuild leaves a cache
  # that cache_exists() reports absent (and gets re-tokenized) instead of a
  # half-built shard set with stale example counts.
  meta_path = os.path.join(cache_dir, METADATA_FILE)
  if os.path.exists(meta_path):
    os.remove(meta_path)
  # A rebuild may need fewer shards; stale leftovers would be globbed back
  # in by read_cache and duplicate examples, so clear the old build first.
  for stale in globlib.glob(os.path.join(cache_dir, "cache-*.tfrecord")):
    os.remove(stale)
  shard: list = []
  shard_idx = 0
  n = 0
  for ex in ds:
    shard.append(encode_example(ex))
    n += 1
    if len(shard) >= examples_per_shard:
      datasets.write_tfrecord(
          os.path.join(cache_dir, SHARD_TEMPLATE.format(shard_idx)), shard)
      shard, shard_idx = [], shard_idx + 1
  if shard:
    datasets.write_tfrecord(
        os.path.join(cache_dir, SHARD_TEMPLATE.format(shard_idx)), shard)
    shard_idx += 1
  meta = {"num_examples": n, "num_shards": shard_idx}
  # Atomic publish: the metadata file is the cache's validity marker, so it
  # appears only once every shard is on disk.
  tmp_path = meta_path + ".tmp"
  with open(tmp_path, "w") as f:
    json.dump(meta, f)
  os.replace(tmp_path, meta_path)
  return meta


def cache_exists(cache_dir: Optional[str]) -> bool:
  return bool(cache_dir) and os.path.exists(
      os.path.join(cache_dir, METADATA_FILE))


def cache_metadata(cache_dir: str) -> Dict[str, Any]:
  with open(os.path.join(cache_dir, METADATA_FILE)) as f:
    return json.load(f)


def read_cache(cache_dir: str) -> core.Dataset:
  """Stream a cache back; each epoch visits the shards in written order
  (downstream stages shuffle)."""
  pattern = os.path.join(cache_dir, "cache-*.tfrecord")

  def gen() -> Iterator[Dict[str, Any]]:
    paths = sorted(globlib.glob(pattern))
    if not paths:
      raise FileNotFoundError(f"no cache shards under {cache_dir}")
    for path in paths:
      for record in datasets.iter_tfrecords(path):
        yield decode_example(record)
  return core.Dataset.from_generator(gen)
