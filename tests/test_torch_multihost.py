"""parallel/multihost.py on one process, against the JAX package's
multihost tests (tests/test_multihost.py): the batch share, the round-robin
example shards (by data group on a mesh), the primary process, the
rendezvous arguments. The multi-process runs are in
tests/test_torch_parallel.py."""

import numpy as np
import pytest
import torch

from music_spectrogram_diffusion_tpu.data import core as jax_core
from music_spectrogram_diffusion_tpu.parallel import multihost as jax_multihost
from music_spectrogram_diffusion_tpu_torch.data import core
from music_spectrogram_diffusion_tpu_torch.parallel import mesh as mesh_lib
from music_spectrogram_diffusion_tpu_torch.parallel import multihost


def test_process_local_batch_size():
  assert multihost.process_local_batch_size(256) == 256  # 1 process
  assert multihost.process_local_batch_size(
      256, mesh_lib.Mesh(4, 2)) == 64  # the rows of one data group
  with pytest.raises(ValueError, match="not divisible"):
    multihost.process_local_batch_size(10, mesh_lib.Mesh(4, 1))


def _ids(ds):
  return [int(e["i"]) for e in ds]


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_shard_for_host_round_robin_as_jax(shards):
  examples = [{"i": np.asarray(i)} for i in range(10)]
  ds = core.Dataset.from_list(examples)
  jds = jax_core.Dataset.from_list(examples)
  got = [_ids(multihost.shard_for_host(ds, shards, i))
         for i in range(shards)]
  want = [[int(e["i"]) for e in jax_multihost.shard_for_host(jds, shards, i)]
          for i in range(shards)]
  assert got == want
  assert sorted(sum(got, [])) == list(range(10))


def test_shard_for_host_deals_by_data_group():
  """On a 2x2 mesh ranks 0 and 1 (one model group) read the same
  examples, ranks 2 and 3 the others."""
  ds = core.Dataset.from_list([{"i": np.asarray(i)} for i in range(6)])
  got = [_ids(multihost.shard_for_host(ds, mesh=mesh_lib.Mesh(2, 2, rank)))
         for rank in range(4)]
  assert got == [[0, 2, 4], [0, 2, 4], [1, 3, 5], [1, 3, 5]]


def test_one_process():
  assert multihost.is_primary()
  assert (multihost.process_count(), multihost.process_index()) == (1, 0)
  mesh = multihost.global_mesh()
  assert mesh.shape == {"data": 1, "model": 1}
  local = {"x": np.arange(32, dtype=np.float32).reshape(8, 4),
           "y": np.arange(8, dtype=np.int32)}
  out = multihost.host_local_batch_to_global(local, mesh, "cpu")
  assert torch.equal(out["x"], torch.from_numpy(local["x"]))
  assert out["y"].dtype == torch.int32
  with pytest.raises(ValueError, match="disagree"):
    multihost.host_local_batch_to_global(
        {"x": np.zeros(3), "y": np.zeros(4)}, mesh, "cpu")


def test_initialize_needs_a_rendezvous(monkeypatch):
  for name in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
    monkeypatch.delenv(name, raising=False)
  with pytest.raises(ValueError, match="torchrun"):
    multihost.initialize(device="cpu")
  with pytest.raises(ValueError, match="num_processes"):
    multihost.initialize("localhost:1234", device="cpu")
  with pytest.raises(ValueError, match="backend"):
    multihost.initialize(backend="mpi", device="cpu")
  with pytest.raises(RuntimeError, match="is_available"):
    multihost.initialize("localhost:1234", 1, 0, device="cuda")
