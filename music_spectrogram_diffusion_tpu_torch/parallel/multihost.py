"""Multi-process training: the process group, the global mesh and each
process's share of the data.

Port of music_spectrogram_diffusion_tpu/parallel/multihost.py. Each
process runs the same program on one device (rank r on card
r % cards-per-host, or the CPU), feeds its own rows of the global batch,
and the mesh's collectives join them:

  * `initialize()` wraps `torch.distributed.init_process_group`: with a
    coordinator address, `tcp://<coordinator>`; without arguments,
    torchrun's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).
    The backend is NCCL for ranks on CUDA and gloo on the CPU; a caller
    may name one (two ranks that share one card use gloo, which takes
    CUDA tensors for all_reduce and broadcast, the only collectives the
    port uses). Nothing switches backend on its own.
  * `global_mesh()` is the ('data', 'model') mesh over every rank.
  * `host_local_batch_to_global()` puts this process's rows on its device,
    after checking that every process feeds as many.
  * `is_primary()` gates checkpoint and metrics writes to rank 0.

Launch, one process a card:

  torchrun --nproc_per_node 8 -m music_spectrogram_diffusion_tpu_torch.cli.train \
      --distributed --mesh 4x2 --preset context_base --model_dir /ckpt

or, without torchrun, on each of N processes:

  python -m music_spectrogram_diffusion_tpu_torch.cli.train --distributed \
      --coordinator host0:1234 --num_processes N --process_id $RANK ...

The ranks of one model group split the weights of one batch shard, so
they must read the same examples: `shard_for_host` deals the example
stream round-robin by data-group index, not by rank.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from music_spectrogram_diffusion_tpu_torch.data import core
from music_spectrogram_diffusion_tpu_torch.parallel import mesh as mesh_lib

BACKENDS = ("nccl", "gloo")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, *, device: str = "cuda",
               init_method: Optional[str] = None,
               timeout_s: float = 600.0) -> torch.device:
  """Join the process group; returns this rank's device.

  `coordinator_address` ('host:port', with `num_processes` and
  `process_id`) or `init_method` (e.g. 'file:///tmp/rendezvous') name the
  rendezvous; with neither, torchrun's environment does. `backend`
  defaults to 'nccl' for `device` 'cuda' and 'gloo' for 'cpu'. On CUDA
  rank r takes card r % torch.cuda.device_count().
  """
  if backend is None:
    backend = "nccl" if device == "cuda" else "gloo"
  if backend not in BACKENDS:
    raise ValueError(f"backend {backend!r} not in {BACKENDS}")
  kwargs = {}
  if coordinator_address is not None or init_method is not None:
    if num_processes is None or process_id is None:
      raise ValueError("a coordinator (or init_method) needs num_processes "
                       "and process_id")
    kwargs = dict(init_method=init_method or f"tcp://{coordinator_address}",
                  world_size=num_processes, rank=process_id)
  elif not {"MASTER_ADDR", "WORLD_SIZE", "RANK"} <= set(os.environ):
    raise ValueError("no coordinator given and no torchrun environment "
                     "(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)")
  rank = process_id if process_id is not None else int(os.environ["RANK"])
  if device == "cuda":
    if not torch.cuda.is_available():
      raise RuntimeError("device 'cuda' requested but "
                         "torch.cuda.is_available() is False")
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
  else:
    dev = torch.device(device)
  dist.init_process_group(backend, timeout=datetime.timedelta(
      seconds=timeout_s), **kwargs)
  return dev


def shutdown() -> None:
  """Leave the process group (if there is one)."""
  if dist.is_initialized():
    dist.destroy_process_group()


def process_count() -> int:
  return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
  return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
  """True on the process that owns checkpoint and metrics writes."""
  return process_index() == 0


def global_mesh(data: Optional[int] = None, model: int = 1
                ) -> mesh_lib.Mesh:
  """('data', 'model') mesh over every process."""
  return mesh_lib.make_mesh(data=data, model=model)


def process_local_batch_size(global_batch_size: int,
                             mesh: Optional[mesh_lib.Mesh] = None) -> int:
  """The examples this process feeds a step: the global batch over the
  mesh's data groups (the ranks of a model group feed the same rows)."""
  n = mesh.data if mesh is not None else process_count()
  if global_batch_size % n != 0:
    raise ValueError(f"global batch {global_batch_size} not divisible "
                     f"by process count {n}")
  return global_batch_size // n


def host_local_batch_to_global(local_batch: Mapping[str, np.ndarray],
                               mesh: mesh_lib.Mesh, device
                               ) -> Dict[str, torch.Tensor]:
  """This process's rows of the global batch, on `device`. Every process
  calls it with its own rows; a process that feeds a different number of
  rows than the others raises (a collective over every rank)."""
  sizes = {len(np.asarray(v)) for v in local_batch.values()}
  if len(sizes) != 1:
    raise ValueError(f"local batch arrays disagree on rows: {sizes}")
  rows = sizes.pop()
  out = {k: torch.as_tensor(np.asarray(v), device=device)
         for k, v in local_batch.items()}
  if mesh.size > 1:
    total = torch.tensor([rows, 1], dtype=torch.int64, device=device)
    dist.all_reduce(total)
    fed, processes = total.tolist()
    if fed != rows * processes:
      raise ValueError(f"process {process_index()} feeds {rows} rows, "
                       f"the {processes} processes {fed} in all")
  return out


def shard_for_host(ds: core.Dataset,
                   num_shards: Optional[int] = None,
                   shard_index: Optional[int] = None,
                   mesh: Optional[mesh_lib.Mesh] = None) -> core.Dataset:
  """Each shard keeps every num_shards-th example (round-robin, the
  reference Beam shard semantics). Given a mesh, the shards are its data
  groups and this process's data-group index picks one, so the ranks of
  one model group keep the same examples; without one, one shard a
  process, as JAX's."""
  if num_shards is None:
    num_shards = mesh.data if mesh is not None else process_count()
  if shard_index is None:
    shard_index = mesh.data_index if mesh is not None else process_index()
  n, i = num_shards, shard_index
  if n <= 1:
    return ds

  def gen(epoch):
    for j, ex in enumerate(ds._gen_fn(epoch)):  # noqa: SLF001
      if j % n == i:
        yield ex
  return core.Dataset(gen)
