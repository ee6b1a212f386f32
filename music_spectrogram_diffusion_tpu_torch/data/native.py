"""The TFRecord reader's host C++ (`ops/csrc/msd_native.cc`).

Port of the JAX package's native extension (native/msd_native.cc), all but
its PGHI heap, which is `ops/csrc/pghi_heap.cc`: `masked_crc32c`,
`split_tfrecords` (with the CRC check on request) and `decode_varints`,
each the extension's function of the same name, bit for bit. The source is
compiled by g++ on first use and bound with ctypes (`ops/_build.py`);
without g++ the first call raises: there is no quiet Python fallback.
`data/datasets.py` keeps the plain Python versions.
"""

from __future__ import annotations

import ctypes
from typing import List

import numpy as np

from music_spectrogram_diffusion_tpu_torch.ops import _build

# csrc/msd_native.cc's error codes, as the JAX extension raises them.
_ERRORS = {
    -1: (IOError, "truncated TFRecord"),
    -2: (IOError, "TFRecord length CRC mismatch"),
    -3: (IOError, "TFRecord data CRC mismatch"),
    -4: (ValueError, "varint too long"),
    -5: (ValueError, "truncated varint"),
}


def _library() -> ctypes.CDLL:
  lib = _build.load("msd_native")
  if not getattr(lib, "_msd_typed", False):
    buf, i64, ptr = ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p
    lib.msd_masked_crc32c.argtypes = [buf, i64]
    lib.msd_masked_crc32c.restype = ctypes.c_uint32
    lib.msd_split_tfrecords.argtypes = [buf, i64, ctypes.c_int, ptr, i64]
    lib.msd_split_tfrecords.restype = i64
    lib.msd_decode_varints.argtypes = [buf, i64, ptr, i64]
    lib.msd_decode_varints.restype = i64
    lib._msd_typed = True
  return lib


def _raise_on(code: int) -> int:
  if code < 0:
    error, message = _ERRORS[code]
    raise error(message)
  return code


def masked_crc32c(data: bytes) -> int:
  """The TFRecord masked CRC32C (Castagnoli) of `data`."""
  data = bytes(data)
  return int(_library().msd_masked_crc32c(data, len(data)))


def split_tfrecords(data: bytes, verify_crc: bool = False) -> List[bytes]:
  """The records of a whole TFRecord file's bytes. A truncated record, or
  with `verify_crc` a length or data CRC that disagrees, raises IOError."""
  data = bytes(data)
  lib = _library()
  # A first pass counts without checking CRCs; the second checks and fills.
  count = _raise_on(lib.msd_split_tfrecords(data, len(data), 0, None, 0))
  offsets = np.empty((count, 2), np.int64)
  _raise_on(lib.msd_split_tfrecords(data, len(data), int(verify_crc),
                                    offsets.ctypes.data, count))
  view = memoryview(data)
  return [bytes(view[o:o + n]) for o, n in offsets.tolist()]


def decode_varints(data: bytes) -> List[int]:
  """A packed run of base-128 varints as unsigned ints. A varint longer
  than 10 bytes, or one cut short, raises ValueError."""
  data = bytes(data)
  out = np.empty(len(data), np.uint64)
  count = _raise_on(_library().msd_decode_varints(
      data, len(data), out.ctypes.data, len(data)))
  return out[:count].tolist()
