"""Steps captured as CUDA graphs and replayed: the port's counterpart of
the JAX package's one-program `lax.scan` loops (the sampler, the
autoregressive decode).

A step is a function of no arguments that reads and writes tensors at fixed
addresses: static buffers made before it is first called, whose values the
caller refreshes with `copy_` between runs. `StepGraphs.run(key, step)`
runs the first call of a key eagerly (so that every one-time setup, a
kernel's shared-memory attribute or a plan cache, happens outside a
capture), then captures the step under the key, and replays the graph on
every later call. A step must not read a tensor on the host: what it needs
from the host is fixed when it is captured, and is part of its key.

Every graph of one `StepGraphs` draws its memory from one pool. That is
safe because whatever a step hands to the next lives in the static
buffers, outside the pool: a graph's own tensors die with its replay, so
the next graph may reuse their memory.

The kernels' launch counters (`flash_attention.launches`,
`quantized_matmul.launches`) count launches on the device: a capture
launches nothing, so the counts it adds are taken back and kept with the
graph, which adds them once per replay.

There is no fallback: a failed capture or replay raises. Graphs run on a
CUDA device only; `use_graphs` resolves a caller's request.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, Hashable, Optional, Tuple

import torch

from music_spectrogram_diffusion_tpu_torch.ops import attention
from music_spectrogram_diffusion_tpu_torch.ops import quantize

# The counted kernel wrappers whose launches a replay adds.
COUNTED = (attention.flash_attention, quantize.quantized_matmul)


def use_graphs(device, graphs: Optional[bool]) -> bool:
  """Whether a call runs captured steps: `graphs` None captures on a CUDA
  device and runs eagerly elsewhere, False runs eagerly, True captures and
  raises where there is no CUDA device."""
  device = torch.device(device)
  if graphs is None:
    return device.type == "cuda"
  if graphs and device.type != "cuda":
    raise ValueError(f"CUDA graphs asked for on {device}: graphs run on a "
                     "cuda device only")
  return bool(graphs)


def model_step_graphs(model) -> Optional["StepGraphs"]:
  """`model.step_graphs`, made on first use where the model's device is a
  CUDA device (None elsewhere). Its stream runs every step loop of the
  model, captured or eager, so that both run their library calls (cuBLAS)
  on one stream."""
  if model.device.type != "cuda":
    return None
  if model.step_graphs is None:
    model.step_graphs = StepGraphs(model.device)
  return model.step_graphs


def on_stream(step_graphs: Optional["StepGraphs"]):
  """`step_graphs.on_stream()`, or no change of stream without graphs (the
  CPU)."""
  if step_graphs is None:
    return contextlib.nullcontext()
  return step_graphs.on_stream()


def _counts() -> Tuple[int, ...]:
  return tuple(fn.launches for fn in COUNTED)


@dataclasses.dataclass
class Captured:
  """One captured step: the graph, each counted kernel's launches in one
  replay, and how often it was replayed."""
  graph: torch.cuda.CUDAGraph
  launches: Tuple[int, ...]
  replays: int = 0


def copy_tree_(static, fresh) -> None:
  """Copy every tensor of `fresh` into the tensor at the same place of
  `static` (nested lists and tuples of tensors of the same shapes)."""
  if isinstance(static, torch.Tensor):
    static.copy_(fresh)
    return
  if len(static) != len(fresh):
    raise ValueError(f"{len(fresh)} entries for {len(static)} buffers")
  for s, f in zip(static, fresh):
    copy_tree_(s, f)


class StepGraphs:
  """Steps captured once each, on one side stream, and replayed on it."""

  def __init__(self, device):
    self.device = torch.device(device)
    if self.device.type != "cuda":
      raise ValueError(f"StepGraphs on {self.device}: CUDA graphs need a "
                       "cuda device")
    self.stream = torch.cuda.Stream(self.device)
    self.pool = torch.cuda.graph_pool_handle()
    self.graphs: Dict[Hashable, Captured] = {}
    self.capture_seconds = 0.0

  @contextlib.contextmanager
  def on_stream(self):
    """Run the body on the graphs' stream, ordered after the caller's
    stream's work so far, and the caller's stream after the body's."""
    caller = torch.cuda.current_stream(self.device)
    self.stream.wait_stream(caller)
    with torch.cuda.stream(self.stream):
      yield
    caller.wait_stream(self.stream)

  def run(self, key: Hashable, step: Callable[[], None]) -> None:
    """Replay `key`'s graph, or run `step` eagerly and capture it as
    `key`'s graph (its first call). Inside `on_stream()` only."""
    if torch.cuda.current_stream(self.device) != self.stream:
      raise RuntimeError("StepGraphs.run outside on_stream()")
    captured = self.graphs.get(key)
    if captured is not None:
      captured.graph.replay()
      captured.replays += 1
      for fn, n in zip(COUNTED, captured.launches):
        fn.launches += n
      return
    step()
    before = _counts()
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
      step()
    self.capture_seconds += time.perf_counter() - t0
    launches = tuple(a - b for a, b in zip(_counts(), before))
    for fn, n in zip(COUNTED, before):
      fn.launches = n
    self.graphs[key] = Captured(graph, launches)
