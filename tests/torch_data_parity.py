"""Shared pieces of the data pipeline's parity tests (tests/test_torch_
datasets.py, test_torch_tokenizers.py, test_torch_registry.py and
test_torch_data_cli.py): a mirror of the seven datasets' records, written
by the port's data/dataset_records.py, that both packages read; gs:// with
no backend in either package (no test reaches the network); and the
equality of two examples, bit for bit, across the packages' classes."""

import dataclasses

import numpy as np
import pytest

from music_spectrogram_diffusion_tpu_torch.data import dataset_records
from music_spectrogram_diffusion_tpu_torch.data import remote_io

NAMES = ("maestrov1", "maestrov3", "guitarset", "urmp", "musicnet",
         "cerberus4", "slakh")
# A few short songs each: long enough for a chunk of the small lengths
# below and for two full-song segments.
SONGS, SECONDS = 2, 2.0
SMALL_LENGTHS = {"inputs": 256, "targets": 64, "targets_context": 64}


def write_mirror(root) -> str:
  """Every dataset's train and validation shards under root."""
  dataset_records.write_all(str(root), SONGS, SECONDS)
  return str(root)


def _no_backend():
  raise FileNotFoundError("no gs:// backend available (test)")


@pytest.fixture(autouse=True)
def no_gcs_backend(monkeypatch):
  """gs:// as on a machine without gcsfs and gsutil, in both packages."""
  from music_spectrogram_diffusion_tpu.data import remote_io as jax_remote
  for module in (remote_io, jax_remote):
    monkeypatch.setitem(module._FACTORIES, "gs", _no_backend)
    monkeypatch.delitem(module._INSTANCES, "gs", raising=False)


@pytest.fixture(autouse=True)
def clean_registries():
  """The task and mixture registries are module globals: each test starts
  and ends with both packages' empty."""
  from music_spectrogram_diffusion_tpu.data import tasks as jax_tasks
  from music_spectrogram_diffusion_tpu_torch.data import tasks
  for module in (tasks, jax_tasks):
    module.TASK_REGISTRY.clear()
    module.MIXTURE_REGISTRY.clear()
  yield
  for module in (tasks, jax_tasks):
    module.TASK_REGISTRY.clear()
    module.MIXTURE_REGISTRY.clear()


def notes(ns):
  return [dataclasses.astuple(n) for n in ns.notes], ns.total_time


def assert_values_equal(got, want, key=""):
  if dataclasses.is_dataclass(want) and hasattr(want, "notes"):
    assert type(got).__name__ == type(want).__name__, key
    assert notes(got) == notes(want), key
  elif isinstance(want, (bytes, str)):
    assert got == want, key
  elif isinstance(want, (list, tuple)) and want and isinstance(
      want[0], (bytes, str)):
    assert list(got) == list(want), key
  else:
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.dtype == want.dtype and got.shape == want.shape, (
        key, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=key)


def assert_examples_equal(got, want):
  """Same keys, and each value the same bit for bit (a NoteSequence note
  for note, across the packages' copies of the class)."""
  assert sorted(got) == sorted(want)
  for k in want:
    assert_values_equal(got[k], want[k], k)


def assert_streams_equal(got, want, at_least=1):
  got, want = list(got), list(want)
  assert len(got) == len(want) >= at_least, (len(got), len(want))
  for g, w in zip(got, want):
    assert_examples_equal(g, w)
