"""Profiling helpers: a device trace, named regions, a device barrier and a
rolling step timer.

Port of music_spectrogram_diffusion_tpu/utils/profiling.py on
`torch.profiler`: `trace` records the host and, where there is a card, its
kernels into a Chrome trace file under `log_dir` that TensorBoard's profile
plugin or Perfetto opens; `annotate` names a region of that trace;
`device_sync` waits for a tensor's device and returns its sum, as the JAX
helper does; `StepTimer` is the same rolling wall-clock timer.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch
from torch import profiler


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profiler.profile]:
  """Profile the block: the host's operators, and the CUDA kernels when a
  card is present. On exit the trace is written to
  `<log_dir>/trace.<pid>.pt.trace.json`. Yields the profiler, whose
  `key_averages()` gives the same events as a table."""
  activities = [profiler.ProfilerActivity.CPU]
  if torch.cuda.is_available():
    activities.append(profiler.ProfilerActivity.CUDA)
  os.makedirs(log_dir, exist_ok=True)
  prof = profiler.profile(activities=activities)
  prof.start()
  try:
    yield prof
  finally:
    if torch.cuda.is_available():
      torch.cuda.synchronize()
    prof.stop()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace.{os.getpid()}.pt.trace.json"))


def annotate(name: str) -> profiler.record_function:
  """Named region that shows up in profiler traces."""
  return profiler.record_function(name)


def device_sync(x: torch.Tensor) -> float:
  """Wait for the work on `x`'s device and fetch its sum to the host."""
  if x.device.type == "cuda":
    torch.cuda.synchronize(x.device)
  return float(x.sum())


class StepTimer:
  """Rolling wall-clock stats for step loops (median/p90)."""

  def __init__(self, window: int = 100):
    self._times = []
    self._window = window
    self._t0: Optional[float] = None

  def start(self) -> None:
    self._t0 = time.time()

  def stop(self) -> float:
    assert self._t0 is not None
    dt = time.time() - self._t0
    self._times.append(dt)
    if len(self._times) > self._window:
      self._times.pop(0)
    self._t0 = None
    return dt

  def stats(self) -> Dict[str, float]:
    if not self._times:
      return {}
    arr = np.asarray(self._times)
    return {
        "step_seconds_median": float(np.median(arr)),
        "step_seconds_p90": float(np.percentile(arr, 90)),
        "step_seconds_mean": float(arr.mean()),
    }
