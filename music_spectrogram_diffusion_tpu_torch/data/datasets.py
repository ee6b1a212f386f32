"""Dataset configurations + a TF-free TFRecord/tf.train.Example reader.

The port's own copy of music_spectrogram_diffusion_tpu/data/datasets.py
(the port imports nothing of the JAX package). The seven dataset configs
mirror the reference's datasets.py, including the published GCS TFRecord
paths; the reader parses TFRecord framing and the tf.train.Example wire
format in pure Python/numpy so the pipeline has no TensorFlow dependency.
`iter_tfrecords` splits records with the host C++ of `data/native.py`, as
the JAX package's reader does with its native extension; the Python reader
(`iter_tfrecords_py`), `_read_varint` and `_masked_crc32c` are the plain
versions the tests hold it against.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, Iterator, List, Mapping, Optional, Sequence

import numpy as np

from music_spectrogram_diffusion_tpu_torch.data import core
from music_spectrogram_diffusion_tpu_torch.data import native
from music_spectrogram_diffusion_tpu_torch.data import remote_io
from music_spectrogram_diffusion_tpu_torch.midi import sequences


# ---------------------------------------------------------------------------
# Feature specs (replacing tf.io.FixedLen[Sequence]Feature).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FeatureSpec:
  """Declared feature: kind in {'bytes','float','int64'}; sequence=True
  for variable-length lists (FixedLenSequenceFeature equivalents)."""
  kind: str
  sequence: bool = False
  shape: Optional[Sequence[int]] = None


def bytes_feature() -> FeatureSpec:
  return FeatureSpec("bytes")


def float_feature() -> FeatureSpec:
  return FeatureSpec("float")


def int64_feature(shape: Optional[Sequence[int]] = None) -> FeatureSpec:
  return FeatureSpec("int64", shape=shape)


def bytes_seq_feature() -> FeatureSpec:
  return FeatureSpec("bytes", sequence=True)


def float_seq_feature() -> FeatureSpec:
  return FeatureSpec("float", sequence=True)


def int64_seq_feature() -> FeatureSpec:
  return FeatureSpec("int64", sequence=True)


# ---------------------------------------------------------------------------
# TFRecord framing + tf.train.Example wire-format parsing (pure Python).
# ---------------------------------------------------------------------------


def iter_tfrecords(path: str, verify_crc: bool = False) -> Iterator[bytes]:
  """Yield the raw records of a TFRecord file (local, or a scheme that
  data/remote_io serves), split by the C++ splitter
  (`native.split_tfrecords`, which raises where g++ is missing). With
  `verify_crc`, a record whose masked CRC32C (of its length or of its
  data) disagrees raises IOError; so does a truncated record."""
  with remote_io.open_file(path, "rb") as f:
    data = f.read()
  try:
    records = native.split_tfrecords(data, verify_crc)
  except IOError as e:
    raise IOError(f"{e} in {path}") from None
  yield from records


def iter_tfrecords_py(path: str, verify_crc: bool = False
                      ) -> Iterator[bytes]:
  """The plain version of `iter_tfrecords`: the records in Python, read
  one at a time."""
  with remote_io.open_file(path, "rb") as f:
    while True:
      header = f.read(8)
      if len(header) < 8:
        return
      (length,) = struct.unpack("<Q", header)
      length_crc = f.read(4)
      data = f.read(length)
      data_crc = f.read(4)
      if len(data) < length or len(data_crc) < 4:
        raise IOError(f"truncated record in {path}")
      if verify_crc and (
          struct.unpack("<I", length_crc)[0] != _masked_crc32c(header)
          or struct.unpack("<I", data_crc)[0] != _masked_crc32c(data)):
        raise IOError(f"TFRecord CRC mismatch in {path}")
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


def tfrecord_source(filepattern: str,
                    features: Mapping[str, FeatureSpec]) -> core.Dataset:
  """Dataset over TFRecord shards matching a glob pattern.

  Local paths glob directly; gs:// (and registered schemes) go through
  data/remote_io — so the published GCS paths are readable wherever a
  gcs backend exists, without a manual mirror.
  """
  def gen():
    paths = sorted(remote_io.glob(filepattern.replace("?????", "*")))
    if not paths:
      raise FileNotFoundError(f"no files match {filepattern}")
    for path in paths:
      for record in iter_tfrecords(path):
        raw = parse_example(record)
        ex = {}
        for name, spec in features.items():
          if name not in raw:
            continue
          value = raw[name]
          if spec.kind == "bytes" and not spec.sequence:
            ex[name] = value[0]
          else:
            ex[name] = value
        yield ex
  return core.Dataset.from_generator(gen)


# ---------------------------------------------------------------------------
# Dataset configurations (the reference's datasets.py:24-296).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InferEvalSplit:
  name: str
  suffix: str
  include_in_mixture: bool = True


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
  name: str
  paths: Mapping[str, str]
  features: Mapping[str, FeatureSpec]
  train_split: str
  train_eval_split: str
  infer_eval_splits: Sequence[InferEvalSplit]
  track_specs: Sequence[sequences.TrackSpec] = ()


_WAV_NS_FEATURES = {
    "audio": bytes_feature(),
    "sequence": bytes_feature(),
    "id": bytes_feature(),
}

_MAESTRO_SPLITS = [
    InferEvalSplit("train", "eval_train_full", include_in_mixture=False),
    InferEvalSplit("train_subset", "eval_train"),
    InferEvalSplit("validation", "validation_full",
                   include_in_mixture=False),
    InferEvalSplit("validation_subset", "validation"),
    InferEvalSplit("test", "test", include_in_mixture=False),
]

MAESTROV1_CONFIG = DatasetConfig(
    name="maestrov1",
    paths={
        "train": "gs://magentadata/datasets/maestro/v1.0.0/maestro-v1.0.0_ns_wav_train.tfrecord-?????-of-00010",
        "train_subset": "gs://magentadata/datasets/maestro/v1.0.0/maestro-v1.0.0_ns_wav_train.tfrecord-00002-of-00010",
        "validation": "gs://magentadata/datasets/maestro/v1.0.0/maestro-v1.0.0_ns_wav_validation.tfrecord-?????-of-00010",
        "validation_subset": "gs://magentadata/datasets/maestro/v1.0.0/maestro-v1.0.0_ns_wav_validation.tfrecord-0000[06]-of-00010",
        "test": "gs://magentadata/datasets/maestro/v1.0.0/maestro-v1.0.0_ns_wav_test.tfrecord-?????-of-00010",
    },
    features=_WAV_NS_FEATURES,
    train_split="train",
    train_eval_split="validation_subset",
    infer_eval_splits=_MAESTRO_SPLITS)

MAESTROV3_CONFIG = DatasetConfig(
    name="maestrov3",
    paths={
        "train": "gs://magentadata/datasets/maestro/v3.0.0/maestro-v3.0.0_ns_wav_train.tfrecord-?????-of-00025",
        "train_subset": "gs://magentadata/datasets/maestro/v3.0.0/maestro-v3.0.0_ns_wav_train.tfrecord-00004-of-00025",
        "validation": "gs://magentadata/datasets/maestro/v3.0.0/maestro-v3.0.0_ns_wav_validation.tfrecord-?????-of-00025",
        "validation_subset": "gs://magentadata/datasets/maestro/v3.0.0/maestro-v3.0.0_ns_wav_validation.tfrecord-0002?-of-00025",
        "test": "gs://magentadata/datasets/maestro/v3.0.0/maestro-v3.0.0_ns_wav_test.tfrecord-?????-of-00025",
    },
    features=_WAV_NS_FEATURES,
    train_split="train",
    train_eval_split="validation_subset",
    infer_eval_splits=_MAESTRO_SPLITS)

GUITARSET_CONFIG = DatasetConfig(
    name="guitarset",
    paths={
        "train": "gs://mt3/data/datasets/guitarset/train.tfrecord-?????-of-00019",
        "validation": "gs://mt3/data/datasets/guitarset/validation.tfrecord-?????-of-00006",
    },
    features={
        "sequence": bytes_feature(),
        "audio": bytes_feature(),
        "velocity_range": bytes_feature(),
        "id": bytes_feature(),
    },
    train_split="train",
    train_eval_split="validation",
    infer_eval_splits=[
        InferEvalSplit("train", "eval_train"),
        InferEvalSplit("validation", "validation"),
    ])

URMP_CONFIG = DatasetConfig(
    name="urmp",
    paths={
        "train": "gs://mt3/data/datasets/urmp/train.tfrecord",
        "validation": "gs://mt3/data/datasets/urmp/validation.tfrecord",
    },
    features={
        "id": bytes_feature(),
        "tracks": int64_seq_feature(),
        "inst_names": bytes_seq_feature(),
        "audio": bytes_feature(),
        "sequence": bytes_feature(),
        "instrument_sequences": bytes_seq_feature(),
    },
    train_split="train",
    train_eval_split="validation",
    infer_eval_splits=[
        InferEvalSplit("train", "eval_train"),
        InferEvalSplit("validation", "validation"),
    ])

MUSICNET_CONFIG = DatasetConfig(
    name="musicnet",
    paths={
        "train": "gs://mt3/data/datasets/musicnet/musicnet-train.tfrecord-?????-of-00036",
        "validation": "gs://mt3/data/datasets/musicnet/musicnet-validation.tfrecord-?????-of-00005",
        "test": "gs://mt3/data/datasets/musicnet/musicnet-test.tfrecord-?????-of-00003",
    },
    features={
        "id": bytes_feature(),
        "sample_rate": float_feature(),
        "audio": float_seq_feature(),
        "sequence": bytes_feature(),
    },
    train_split="train",
    train_eval_split="validation",
    infer_eval_splits=[
        InferEvalSplit("train", "eval_train"),
        InferEvalSplit("validation", "validation"),
        InferEvalSplit("test", "test", include_in_mixture=False),
    ])

_SLAKH_FEATURES = {
    "audio_sample_rate": int64_feature(),
    "inst_names": bytes_seq_feature(),
    "midi_class": int64_seq_feature(),
    "mix": float_seq_feature(),
    "note_sequences": bytes_seq_feature(),
    "plugin_name": int64_seq_feature(),
    "program_num": int64_seq_feature(),
    "slakh_class": int64_seq_feature(),
    "src_ids": bytes_seq_feature(),
    "stems": float_seq_feature(),
    "stems_shape": int64_feature(shape=[2]),
    "target_type": bytes_feature(),
    "track_id": bytes_feature(),
}

_SLAKH_SPLITS = [
    InferEvalSplit("train", "eval_train_full", include_in_mixture=False),
    InferEvalSplit("train_subset", "eval_train"),
    InferEvalSplit("validation", "validation_full",
                   include_in_mixture=False),
    InferEvalSplit("validation_subset", "validation"),
    InferEvalSplit("test", "test", include_in_mixture=False),
]

CERBERUS4_CONFIG = DatasetConfig(
    name="cerberus4",
    paths={
        "train": "gs://mt3/data/datasets/cerberus4/slakh_multi_cerberus_train_bass:drums:guitar:piano.tfrecord-?????-of-00286",
        "train_subset": "gs://mt3/data/datasets/cerberus4/slakh_multi_cerberus_train_bass:drums:guitar:piano.tfrecord-00000-of-00286",
        "validation": "gs://mt3/data/datasets/cerberus4/slakh_multi_cerberus_validation_bass:drums:guitar:piano.tfrecord-?????-of-00212",
        "validation_subset": "gs://mt3/data/datasets/cerberus4/slakh_multi_cerberus_validation_bass:drums:guitar:piano.tfrecord-0000?-of-00212",
        "test": "gs://mt3/data/datasets/cerberus4/slakh_multi_cerberus_test_bass:drums:guitar:piano.tfrecord-?????-of-00106",
    },
    features=_SLAKH_FEATURES,
    train_split="train",
    train_eval_split="validation_subset",
    infer_eval_splits=_SLAKH_SPLITS,
    track_specs=[
        sequences.TrackSpec("bass", program=32),
        sequences.TrackSpec("drums", is_drum=True),
        sequences.TrackSpec("guitar", program=24),
        sequences.TrackSpec("piano", program=0),
    ])

SLAKH_CONFIG = DatasetConfig(
    name="slakh",
    paths={
        "train": "gs://mt3/data/datasets/slakh/slakh_multi_full_subsets_10_train_all_inst.tfrecord-?????-of-02307",
        "train_subset": "gs://mt3/data/datasets/slakh/slakh_multi_full_subsets_10_train_all_inst.tfrecord-00000-of-02307",
        "validation": "gs://mt3/data/datasets/slakh/slakh_multi_full_validation_all_inst.tfrecord-?????-of-00168",
        "validation_subset": "gs://mt3/data/datasets/slakh/slakh_multi_full_validation_all_inst.tfrecord-0000?-of-00168",
        "test": "gs://mt3/data/datasets/slakh/slakh_multi_full_test_all_inst.tfrecord-?????-of-00109",
    },
    features=_SLAKH_FEATURES,
    train_split="train",
    train_eval_split="validation_subset",
    infer_eval_splits=_SLAKH_SPLITS)

ALL_DATASET_CONFIGS = {
    c.name: c for c in [
        MAESTROV1_CONFIG, MAESTROV3_CONFIG, GUITARSET_CONFIG, URMP_CONFIG,
        MUSICNET_CONFIG, CERBERUS4_CONFIG, SLAKH_CONFIG,
    ]
}

# The six datasets in the reference "mega" training mixture
# (reference tasks.py:496-503).
SYNTH_MIXTURE_DATASET_CONFIGS = [
    MAESTROV3_CONFIG, GUITARSET_CONFIG, URMP_CONFIG, MUSICNET_CONFIG,
    CERBERUS4_CONFIG, SLAKH_CONFIG,
]
