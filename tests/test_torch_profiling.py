"""utils/profiling.py against the JAX package's: StepTimer's statistics
from the same step times are equal; `trace` writes a trace file on the
CPU that names its annotated regions; `device_sync` returns the sum."""

import glob
import json
import os

import numpy as np
import torch

from music_spectrogram_diffusion_tpu.utils import profiling as jax_profiling
from music_spectrogram_diffusion_tpu_torch.utils import profiling


def _timed(module, monkeypatch, times, window):
  clock = iter(times)
  monkeypatch.setattr(module.time, "time", lambda: next(clock))
  timer = module.StepTimer(window=window)
  assert timer.stats() == {}
  for _ in range(len(times) // 2):
    timer.start()
    timer.stop()
  return timer.stats()


def test_step_timer_equals_jax(monkeypatch):
  r = np.random.RandomState(0)
  starts = np.cumsum(r.uniform(0.5, 2.0, 40))
  times = [float(x) for t0 in starts
           for x in (t0, t0 + r.uniform(0.01, 0.3))]
  for window in (100, 7):
    got = _timed(profiling, monkeypatch, times, window)
    want = _timed(jax_profiling, monkeypatch, times, window)
    assert set(got) == {"step_seconds_median", "step_seconds_p90",
                        "step_seconds_mean"}
    assert got == want


def test_trace_writes_a_file_with_the_annotations(tmp_path):
  log_dir = str(tmp_path / "trace")
  with profiling.trace(log_dir) as prof:
    with profiling.annotate("distill/teacher"):
      x = torch.randn(64, 64) @ torch.randn(64, 64)
    total = profiling.device_sync(x)
  assert np.isclose(total, float(x.sum()))
  files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
  assert len(files) == 1 and os.path.getsize(files[0]) > 0
  events = json.load(open(files[0]))["traceEvents"]
  assert any(e.get("name") == "distill/teacher" for e in events)
  assert any(e.key == "distill/teacher" for e in prof.key_averages())
