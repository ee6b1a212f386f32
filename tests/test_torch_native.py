"""The port's TFRecord host C++ (data/native.py, ops/csrc/msd_native.cc)
against its plain Python versions and the JAX package's native extension,
bit for bit."""

import os
import struct

import numpy as np
import pytest

from music_spectrogram_diffusion_tpu import native as jax_native
from music_spectrogram_diffusion_tpu.data import datasets as jax_datasets
from music_spectrogram_diffusion_tpu_torch.data import datasets
from music_spectrogram_diffusion_tpu_torch.data import native

PAYLOADS = [b"", b"hello world", bytes(range(256)) * 7,
            np.random.RandomState(0).bytes(4099)]


@pytest.fixture(scope="module")
def jax_mod():
  mod = jax_native.get()
  assert mod is not None, "the JAX package's extension did not build"
  return mod


@pytest.mark.parametrize("payload", PAYLOADS, ids=["empty", "text", "ramp",
                                                   "random"])
def test_masked_crc32c(payload, jax_mod):
  crc = native.masked_crc32c(payload)
  assert crc == datasets._masked_crc32c(payload) == jax_mod.masked_crc32c(
      payload)


def _tfrecord(tmp_path, records):
  path = os.path.join(tmp_path, "t.tfrecord")
  datasets.write_tfrecord(path, records)
  with open(path, "rb") as f:
    return path, f.read()


@pytest.mark.parametrize("verify", [False, True])
def test_split_tfrecords(tmp_path, jax_mod, verify):
  records = [b"first", b"", b"x" * 1000] + PAYLOADS
  path, data = _tfrecord(tmp_path, records)
  got = native.split_tfrecords(data, verify)
  assert got == records == jax_mod.split_tfrecords(data, verify)
  assert list(datasets.iter_tfrecords(path, verify)) == records
  assert list(datasets.iter_tfrecords_py(path, verify)) == records
  assert native.split_tfrecords(b"", verify) == []


def test_split_tfrecords_refuses_a_bad_crc(tmp_path, jax_mod):
  _, data = _tfrecord(tmp_path, [b"payload", b"second"])
  for offset, what in ((14, "data"), (9, "length")):
    bad = bytearray(data)
    bad[offset] ^= 0xFF
    with pytest.raises(IOError, match=f"{what} CRC mismatch"):
      native.split_tfrecords(bytes(bad), True)
    with pytest.raises(IOError):
      jax_mod.split_tfrecords(bytes(bad), True)
  # Unchecked, the flipped data byte is read back as it is.
  bad = bytearray(data)
  bad[14] ^= 0xFF
  assert native.split_tfrecords(bytes(bad), False) == jax_mod.split_tfrecords(
      bytes(bad), False)


@pytest.mark.parametrize("cut", [1, 4, 10])
def test_split_tfrecords_refuses_a_truncated_record(tmp_path, jax_mod, cut):
  path, data = _tfrecord(tmp_path, [b"payload", b"second record"])
  with open(path, "wb") as f:
    f.write(data[:-cut])
  with pytest.raises(IOError, match="truncated"):
    native.split_tfrecords(data[:-cut])
  with pytest.raises(IOError, match="truncated"):
    jax_mod.split_tfrecords(data[:-cut], False)
  with pytest.raises(IOError, match="truncated"):
    list(datasets.iter_tfrecords(path))
  with pytest.raises(IOError, match="truncated"):
    list(datasets.iter_tfrecords_py(path))
  # A length so large that pos + length wraps around is truncated too.
  huge = struct.pack("<Q", 2 ** 64 - 8) + b"\0" * 8
  with pytest.raises(IOError, match="truncated"):
    native.split_tfrecords(huge)


def test_decode_varints(jax_mod):
  values = [0, 1, 127, 128, 300, 2 ** 21, 2 ** 40, 2 ** 63, 2 ** 64 - 1]
  buf = b"".join(datasets._encode_varint(v) for v in values)
  assert native.decode_varints(buf) == values == jax_mod.decode_varints(buf)
  pos, plain = 0, []
  while pos < len(buf):
    value, pos = datasets._read_varint(buf, pos)
    plain.append(value)
  assert plain == values
  assert native.decode_varints(b"") == []


def test_decode_varints_refuses_bad_input(jax_mod):
  with pytest.raises(ValueError, match="truncated varint"):
    native.decode_varints(b"\x96")
  with pytest.raises(ValueError, match="varint too long"):
    native.decode_varints(b"\xff" * 11 + b"\x01")
  for bad in (b"\x96", b"\xff" * 11 + b"\x01"):
    with pytest.raises(ValueError):
      jax_mod.decode_varints(bad)


def test_iter_tfrecords_on_examples(tmp_path):
  """tf.train.Example records, through both readers and JAX's."""
  records = [datasets.serialize_example(
      {"id": np.asarray([i], np.int64),
       "audio": np.arange(i, dtype=np.float32)}) for i in range(5)]
  path = os.path.join(tmp_path, "ex.tfrecord")
  datasets.write_tfrecord(path, records)
  got = list(datasets.iter_tfrecords(path, verify_crc=True))
  assert got == records == list(datasets.iter_tfrecords_py(path, True))
  assert got == list(jax_datasets.iter_tfrecords(path, verify_crc=True))
