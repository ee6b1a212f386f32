"""TFRecord framing and the tf.train.Example wire format, in pure Python.

The record functions of music_spectrogram_diffusion_tpu/data/datasets.py
that the offline cache (`data/cache.py`) needs, copied (the port imports
nothing of the JAX package): `serialize_example`, `parse_example`,
`write_tfrecord` and `iter_tfrecords`. The dataset configurations stay in
the JAX package until the real datasets are ported. `iter_tfrecords` reads
local files with the pure-Python splitter (the JAX package also has a
native one and remote paths; both yield the same records).
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Mapping, Sequence

import numpy as np


def iter_tfrecords(path: str) -> Iterator[bytes]:
  """Yield the raw records of a local TFRecord file (CRCs not checked)."""
  with open(path, "rb") as f:
    while True:
      header = f.read(8)
      if len(header) < 8:
        return
      (length,) = struct.unpack("<Q", header)
      f.read(4)  # length CRC
      data = f.read(length)
      if len(data) < length:
        raise IOError(f"truncated record in {path}")
      f.read(4)  # data CRC
      yield data


def _read_varint(buf: bytes, pos: int):
  result = 0
  shift = 0
  while True:
    b = buf[pos]
    pos += 1
    result |= (b & 0x7F) << shift
    if not b & 0x80:
      return result, pos
    shift += 7


def _parse_protobuf_fields(buf: bytes) -> Iterator:
  """Yield (field_number, wire_type, value) from a protobuf message."""
  pos = 0
  n = len(buf)
  while pos < n:
    tag, pos = _read_varint(buf, pos)
    field, wire = tag >> 3, tag & 7
    if wire == 0:  # varint
      value, pos = _read_varint(buf, pos)
    elif wire == 1:  # 64-bit
      value = buf[pos:pos + 8]
      pos += 8
    elif wire == 2:  # length-delimited
      length, pos = _read_varint(buf, pos)
      value = buf[pos:pos + length]
      pos += length
    elif wire == 5:  # 32-bit
      value = buf[pos:pos + 4]
      pos += 4
    else:
      raise ValueError(f"unsupported wire type {wire}")
    yield field, wire, value


def parse_example(record: bytes) -> Dict[str, object]:
  """Parse a serialized tf.train.Example into {name: list-of-values}.

  Wire layout: Example{1: Features{1: map<string, Feature>}} where
  Feature is a oneof {1: BytesList, 2: FloatList, 3: Int64List} and each
  *List has repeated field 1 (floats/ints may be packed).
  """
  out: Dict[str, object] = {}
  for field, _, features_buf in _parse_protobuf_fields(record):
    if field != 1:
      continue
    for ffield, _, entry_buf in _parse_protobuf_fields(features_buf):
      if ffield != 1:
        continue
      name, feature_buf = None, None
      for efield, _, v in _parse_protobuf_fields(entry_buf):
        if efield == 1:
          name = v.decode("utf-8")
        elif efield == 2:
          feature_buf = v
      if name is None or feature_buf is None:
        continue
      for kind, _, list_buf in _parse_protobuf_fields(feature_buf):
        if kind == 1:  # BytesList
          values: List[object] = [
              v for f, _, v in _parse_protobuf_fields(list_buf) if f == 1]
          out[name] = values
        elif kind == 2:  # FloatList (packed or repeated)
          chunks: List[np.ndarray] = []
          for f, wire, v in _parse_protobuf_fields(list_buf):
            if f != 1:
              continue
            if wire == 2:  # packed
              chunks.append(np.frombuffer(v, "<f4"))
            else:
              chunks.append(
                  np.asarray([struct.unpack("<f", v)[0]], np.float32))
          out[name] = (np.concatenate(chunks).astype(np.float32)
                       if chunks else np.zeros((0,), np.float32))
        elif kind == 3:  # Int64List
          ints: List[int] = []
          for f, wire, v in _parse_protobuf_fields(list_buf):
            if f != 1:
              continue
            if wire == 2:  # packed varints
              pos = 0
              while pos < len(v):
                x, pos = _read_varint(v, pos)
                ints.append(x)
              continue
            ints.append(v)
          # Negative int64s ride the wire as two's-complement uint64.
          out[name] = np.asarray(ints, np.uint64).astype(np.int64)
  return out


def _encode_varint(value: int) -> bytes:
  out = bytearray()
  while True:
    b = value & 0x7F
    value >>= 7
    if value:
      out.append(b | 0x80)
    else:
      out.append(b)
      return bytes(out)


def _encode_field(field: int, wire: int, payload: bytes) -> bytes:
  return _encode_varint((field << 3) | wire) + payload


def serialize_example(features: Mapping[str, object]) -> bytes:
  """Serialize {name: bytes | [bytes] | float array | int array} to a
  tf.train.Example wire-format message (lists of bytes/str become
  repeated BytesList values — the multitrack schemas' sequence lists)."""
  entries = b""
  for name, value in features.items():
    if isinstance(value, (bytes, str)) or (
        isinstance(value, (list, tuple)) and value
        and all(isinstance(v, (bytes, str)) for v in value)):
      values = [value] if isinstance(value, (bytes, str)) else list(value)
      inner = b"".join(
          _encode_field(1, 2, _encode_varint(len(raw)) + raw)
          for raw in (v.encode("utf-8") if isinstance(v, str) else v
                      for v in values))
      feature = _encode_field(1, 2, _encode_varint(len(inner)) + inner)
    else:
      arr = np.asarray(value)
      if np.issubdtype(arr.dtype, np.floating):
        packed = arr.astype("<f4").tobytes()
        inner = _encode_field(1, 2, _encode_varint(len(packed)) + packed)
        feature = _encode_field(2, 2, _encode_varint(len(inner)) + inner)
      elif np.issubdtype(arr.dtype, np.integer):
        packed = b"".join(_encode_varint(int(x) & 0xFFFFFFFFFFFFFFFF)
                          for x in arr.reshape(-1))
        inner = _encode_field(1, 2, _encode_varint(len(packed)) + packed)
        feature = _encode_field(3, 2, _encode_varint(len(inner)) + inner)
      else:
        raise TypeError(f"unsupported feature {name}: {arr.dtype}")
    name_raw = name.encode("utf-8")
    entry = (_encode_field(1, 2, _encode_varint(len(name_raw)) + name_raw)
             + _encode_field(2, 2,
                             _encode_varint(len(feature)) + feature))
    entries += _encode_field(1, 2, _encode_varint(len(entry)) + entry)
  return _encode_field(1, 2, _encode_varint(len(entries)) + entries)


_CRC_TABLE = None


def _masked_crc32c(data: bytes) -> int:
  """CRC32C with the TFRecord masking (software table implementation)."""
  global _CRC_TABLE
  if _CRC_TABLE is None:
    poly = 0x82F63B78
    table = []
    for i in range(256):
      crc = i
      for _ in range(8):
        crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
      table.append(crc)
    _CRC_TABLE = table
  crc = 0xFFFFFFFF
  for b in data:
    crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
  crc ^= 0xFFFFFFFF
  return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


def write_tfrecord(path: str, records: Sequence[bytes]) -> None:
  """Write records in TFRecord framing (with valid masked CRCs)."""
  with open(path, "wb") as f:
    for record in records:
      header = struct.pack("<Q", len(record))
      f.write(header)
      f.write(struct.pack("<I", _masked_crc32c(header)))
      f.write(record)
      f.write(struct.pack("<I", _masked_crc32c(record)))
