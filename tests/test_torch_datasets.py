"""The port's data/datasets.py, midi/proto.py and data/remote_io.py against
the JAX package's: the seven configs, the records' bytes, their parse and
the TFRecord sources, on records in every published schema that the test
writes (data/dataset_records.py); and remote_io's local, custom-scheme and
gs:// cases."""

import fnmatch
import io
import struct

import numpy as np
import pytest

from music_spectrogram_diffusion_tpu.data import datasets as jax_datasets
from music_spectrogram_diffusion_tpu.data import remote_io as jax_remote
from music_spectrogram_diffusion_tpu.midi import proto as jax_proto
from music_spectrogram_diffusion_tpu_torch.data import dataset_records
from music_spectrogram_diffusion_tpu_torch.data import datasets
from music_spectrogram_diffusion_tpu_torch.data import remote_io
from music_spectrogram_diffusion_tpu_torch.midi import proto
# clean_registries and no_gcs_backend are autouse fixtures.
from torch_data_parity import (  # noqa: F401
    NAMES, SECONDS, assert_streams_equal, assert_values_equal,
    clean_registries, no_gcs_backend, notes, write_mirror)


@pytest.fixture(scope="module")
def mirror(tmp_path_factory):
  return write_mirror(tmp_path_factory.mktemp("mirror"))


def _spec(spec):
  return (spec.kind, spec.sequence,
          None if spec.shape is None else tuple(spec.shape))


def test_configs_equal_jax():
  assert list(datasets.ALL_DATASET_CONFIGS) == list(
      jax_datasets.ALL_DATASET_CONFIGS) == list(NAMES)
  for name, want in jax_datasets.ALL_DATASET_CONFIGS.items():
    got = datasets.ALL_DATASET_CONFIGS[name]
    assert got.paths == want.paths, name
    assert {k: _spec(v) for k, v in got.features.items()} == {
        k: _spec(v) for k, v in want.features.items()}, name
    assert (got.train_split, got.train_eval_split) == (
        want.train_split, want.train_eval_split)
    assert [(s.name, s.suffix, s.include_in_mixture)
            for s in got.infer_eval_splits] == [
                (s.name, s.suffix, s.include_in_mixture)
                for s in want.infer_eval_splits]
    assert [(t.name, t.program, t.is_drum) for t in got.track_specs] == [
        (t.name, t.program, t.is_drum) for t in want.track_specs]
  assert [c.name for c in datasets.SYNTH_MIXTURE_DATASET_CONFIGS] == [
      c.name for c in jax_datasets.SYNTH_MIXTURE_DATASET_CONFIGS]
  assert datasets.SLAKH_CONFIG.features["stems_shape"].shape == [2]


@pytest.mark.parametrize("name", NAMES)
def test_serialize_example_bytes_equal_jax(name):
  for seed in (1, 2):
    features = dataset_records.record(name, seed, SECONDS)
    raw = datasets.serialize_example(features)
    assert raw == jax_datasets.serialize_example(features)
    got, want = datasets.parse_example(raw), jax_datasets.parse_example(raw)
    assert sorted(got) == sorted(want) == sorted(features)
    for k in want:
      assert_values_equal(got[k], want[k], k)


def test_serialize_note_sequence_bytes_equal_jax():
  ns = dataset_records.song(3, 4.0, program=33)
  ns.notes[0].is_drum = True
  ccs = dataset_records.sustain_pedal(3, 4.0)
  raw = proto.serialize_note_sequence(ns, ccs)
  assert raw == jax_proto.serialize_note_sequence(ns, ccs)
  got, want = proto.parse_note_sequence(raw), jax_proto.parse_note_sequence(
      raw)
  assert notes(got[0]) == notes(want[0])
  assert got[1:] == want[1:] and len(got[1]) == len(ccs)
  # The sustain pedal extends notes as JAX's does.
  assert notes(proto.apply_sustain_control_changes(got[0], got[1])) == notes(
      jax_proto.apply_sustain_control_changes(want[0], want[1]))


def _varint(value):
  return datasets._encode_varint(value & 0xFFFFFFFFFFFFFFFF)


def _field(num, wire, payload):
  return datasets._encode_field(num, wire, payload)


def _delimited(num, payload):
  return _field(num, 2, _varint(len(payload)) + payload)


def _example(entries):
  features = b"".join(
      _delimited(1, _delimited(1, name.encode()) + _delimited(2, feature))
      for name, feature in entries)
  return _delimited(1, features)


def test_parse_example_wire_types_equal_jax():
  """Packed and unpacked int64 and float lists (negative ints as their
  two's complement), empty lists, and lists of bytes."""
  unpacked_ints = b"".join(_field(1, 0, _varint(v)) for v in (3, -2, 1 << 40))
  packed_ints = _delimited(1, b"".join(_varint(v) for v in (7, -1)))
  unpacked_floats = b"".join(_field(1, 5, struct.pack("<f", v))
                             for v in (0.5, -3.25))
  packed_floats = _delimited(1, np.asarray([1.5, 2e-3], "<f4").tobytes())
  raw = _example([
      ("ints_unpacked", _delimited(3, unpacked_ints)),
      ("ints_packed", _delimited(3, packed_ints)),
      ("ints_mixed", _delimited(3, packed_ints + unpacked_ints)),
      ("floats_unpacked", _delimited(2, unpacked_floats)),
      ("floats_packed", _delimited(2, packed_floats)),
      ("floats_empty", _delimited(2, b"")),
      ("names", _delimited(1, _delimited(1, b"bass") + _delimited(1, b""))),
  ])
  got, want = datasets.parse_example(raw), jax_datasets.parse_example(raw)
  assert sorted(got) == sorted(want)
  for k in want:
    assert_values_equal(got[k], want[k], k)
  np.testing.assert_array_equal(got["ints_unpacked"], [3, -2, 1 << 40])
  assert got["ints_mixed"].tolist() == [7, -1, 3, -2, 1 << 40]
  assert got["floats_unpacked"].dtype == np.float32
  assert got["names"] == [b"bass", b""]


@pytest.mark.parametrize("name", NAMES)
def test_tfrecord_source_equals_jax(name, mirror):
  config = datasets.ALL_DATASET_CONFIGS[name]
  jax_config = jax_datasets.ALL_DATASET_CONFIGS[name]
  for split in config.paths:
    pattern = mirror + "/" + config.paths[split][len("gs://"):]
    try:
      want = list(jax_datasets.tfrecord_source(pattern, jax_config.features))
    except FileNotFoundError:  # a split the mirror leaves out (test)
      with pytest.raises(FileNotFoundError, match="no files match"):
        list(datasets.tfrecord_source(pattern, config.features))
      continue
    got = list(datasets.tfrecord_source(pattern, config.features))
    assert_streams_equal(got, want, at_least=2)
    if name == "musicnet":
      assert got[0]["sample_rate"].tolist() == [44100.0]
      assert got[0]["audio"].dtype == np.float32
    if name in ("slakh", "cerberus4"):
      assert got[0]["stems"].size == np.prod(got[0]["stems_shape"])
      assert isinstance(got[0]["track_id"], bytes)


def test_tfrecord_source_missing_shard_raises(tmp_path):
  source = datasets.tfrecord_source(
      str(tmp_path / "maestro-v3.0.0_ns_wav_train.tfrecord-?????-of-00025"),
      datasets.MAESTROV3_CONFIG.features)
  with pytest.raises(FileNotFoundError, match="no files match"):
    next(iter(source))


def test_iter_tfrecords_verifies_crc(tmp_path, mirror):
  path = dataset_records.shard_path(datasets.URMP_CONFIG, "train", mirror)
  records = list(datasets.iter_tfrecords(path, verify_crc=True))
  assert records == list(jax_datasets.iter_tfrecords(path)) == list(
      datasets.iter_tfrecords(path))
  raw = bytearray(open(path, "rb").read())
  raw[20] ^= 0xFF  # a byte of the first record's data
  bad = tmp_path / "bad.tfrecord"
  bad.write_bytes(bytes(raw))
  assert len(list(datasets.iter_tfrecords(str(bad)))) == len(records)
  with pytest.raises(IOError, match="CRC"):
    list(datasets.iter_tfrecords(str(bad), verify_crc=True))
  bad.write_bytes(bytes(raw[:-2]))
  with pytest.raises(IOError, match="truncated"):
    list(datasets.iter_tfrecords(str(bad)))


def test_shard_paths_match_the_published_globs(tmp_path):
  """Each written shard is matched by its split's published glob (and by
  the full split's, for a subset)."""
  for name, config in datasets.ALL_DATASET_CONFIGS.items():
    for split, pattern in config.paths.items():
      base = split[:-len("_subset")] if split.endswith("_subset") else split
      path = dataset_records.shard_path(config, base, str(tmp_path))
      local = str(tmp_path) + "/" + pattern[len("gs://"):]
      assert fnmatch.fnmatch(path, local.replace("?????", "*")), (
          name, split, path)


def test_remote_io_local_and_custom_scheme(tmp_path):
  """Filesystem registry: local passthrough + custom scheme handler."""
  (tmp_path / "a.txt").write_bytes(b"hello")
  assert remote_io.glob(str(tmp_path / "*.txt")) == [str(tmp_path / "a.txt")]
  with remote_io.open_file(str(tmp_path / "a.txt")) as f:
    assert f.read() == b"hello"

  class FakeFs:
    def glob(self, pattern):
      return ["fake://x/1", "fake://x/2"]

    def open(self, path, mode="rb"):
      return io.BytesIO(path.encode())

  remote_io.register_filesystem("fake", FakeFs)
  try:
    assert remote_io.glob("fake://x/*") == ["fake://x/1", "fake://x/2"]
    assert remote_io.open_file("fake://x/1").read() == b"fake://x/1"
  finally:
    remote_io._FACTORIES.pop("fake", None)
    remote_io._INSTANCES.pop("fake", None)
  with pytest.raises(ValueError, match="no filesystem registered"):
    remote_io.glob("nope://x/*")


def test_tfrecord_source_reads_through_a_registered_scheme(tmp_path, mirror):
  """A source on a custom scheme reads the same records as the local
  path (the role gcsfs plays for gs:// where it is reachable)."""
  local = dataset_records.shard_path(datasets.MUSICNET_CONFIG, "train",
                                     mirror)

  class MirrorFs:
    def glob(self, pattern):
      return ["mirror://" + p for p in remote_io.glob(
          pattern[len("mirror://"):])]

    def open(self, path, mode="rb"):
      return open(path[len("mirror://"):], mode)

  remote_io.register_filesystem("mirror", MirrorFs)
  try:
    got = list(datasets.tfrecord_source("mirror://" + local,
                                        datasets.MUSICNET_CONFIG.features))
  finally:
    remote_io._FACTORIES.pop("mirror", None)
    remote_io._INSTANCES.pop("mirror", None)
  want = list(datasets.tfrecord_source(local,
                                       datasets.MUSICNET_CONFIG.features))
  assert_streams_equal(got, want, at_least=2)


def test_gs_without_backend_raises_and_never_lists_empty(monkeypatch):
  """As on a machine without gcsfs and gsutil: _default_gcs tries both and
  raises FileNotFoundError naming them, never an empty listing (the
  backends' constructors are made to fail here; nothing is contacted)."""
  def no_gcsfs(self):
    raise ImportError("No module named 'gcsfs'")

  monkeypatch.setattr(remote_io.GcsFsFilesystem, "__init__", no_gcsfs)
  monkeypatch.setattr(remote_io.GsutilCacheFilesystem, "_find_cli",
                      staticmethod(lambda: None))
  monkeypatch.setitem(remote_io._FACTORIES, "gs", remote_io._default_gcs)
  with pytest.raises(FileNotFoundError, match="no gs:// backend") as e:
    remote_io.glob("gs://magentadata/does/not/matter*")
  assert "GcsFsFilesystem" in str(e.value)
  assert "GsutilCacheFilesystem" in str(e.value)
  source = datasets.tfrecord_source(datasets.MAESTROV3_CONFIG.paths["train"],
                                    datasets.MAESTROV3_CONFIG.features)
  with pytest.raises(FileNotFoundError, match="no gs:// backend"):
    next(iter(source))


def test_gcsfs_auth_error_classifier():
  """Only auth-shaped failures trigger the anonymous retry; transient or
  missing-file errors surface as-is (no permanent anon downgrade)."""
  for is_auth in (remote_io.GcsFsFilesystem._is_auth_error,
                  jax_remote.GcsFsFilesystem._is_auth_error):
    assert is_auth(Exception("HTTP 403: Forbidden"))
    assert is_auth(PermissionError("access denied on bucket"))
    assert is_auth(Exception("invalid_grant: bad credentials"))
    assert is_auth(Exception("Anonymous caller does not have access"))
    assert not is_auth(FileNotFoundError("gs://b/missing.tfrecord"))
    assert not is_auth(Exception("HTTP 500: backend error"))
    assert not is_auth(TimeoutError("read timed out"))


def test_gsutil_cache_local_path(tmp_path, monkeypatch):
  """The gsutil backend's cache keeps the bucket path under its directory
  and downloads once (the CLI stubbed: nothing is contacted)."""
  calls = []

  def fake_run(cmd, check=True, **kwargs):
    calls.append(cmd)
    with open(cmd[-1], "wb") as f:
      f.write(b"data")

  monkeypatch.setattr(remote_io.GsutilCacheFilesystem, "_find_cli",
                      staticmethod(lambda: ["gsutil"]))
  monkeypatch.setattr(remote_io.subprocess, "run", fake_run)
  fs = remote_io.GsutilCacheFilesystem(cache_dir=str(tmp_path))
  for _ in range(2):
    with fs.open("gs://bucket/a/b.tfrecord") as f:
      assert f.read() == b"data"
  assert len(calls) == 1 and calls[0][:2] == ["gsutil", "cp"]
  assert (tmp_path / "bucket" / "a" / "b.tfrecord").exists()
