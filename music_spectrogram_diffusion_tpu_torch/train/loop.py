"""The training loop: data -> steps -> checkpoints -> logs.

Port of music_spectrogram_diffusion_tpu/train/loop.py on one process:
checkpoint every `checkpoint_period` steps and at the end, log the loss
and throughput metrics every `log_period` steps, run the held-out eval
pass (`eval_fn`, if given) every `eval_period` steps and log its metrics as
`eval/<name>`, and resume the full state (parameters, optimizer state and
step) from the latest checkpoint.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from music_spectrogram_diffusion_tpu_torch import config as cfg_lib
from music_spectrogram_diffusion_tpu_torch.train import checkpoints
from music_spectrogram_diffusion_tpu_torch.train import metrics as metrics_lib
from music_spectrogram_diffusion_tpu_torch.train import trainer as trainer_lib


class MetricsLogger:
  """JSONL metrics writer (one line per log step) + stdout echo."""

  def __init__(self, log_dir: Optional[str], echo: bool = True):
    self._file = None
    self._echo = echo
    if log_dir:
      os.makedirs(log_dir, exist_ok=True)
      self._file = open(os.path.join(log_dir, "metrics.jsonl"), "a")

  def write(self, step: int, metrics: Dict[str, Any]) -> None:
    payload = {"step": step}
    for k, v in metrics.items():
      try:
        payload[k] = float(v)
      except (TypeError, ValueError, RuntimeError):
        continue
    if self._file:
      self._file.write(json.dumps(payload) + "\n")
      self._file.flush()
    if self._echo:
      parts = " ".join(f"{k}={v:.5g}" for k, v in payload.items()
                       if k != "step")
      print(f"[step {step}] {parts}")

  def close(self):
    if self._file:
      self._file.close()


@dataclasses.dataclass
class TrainLoop:
  """Drives a Trainer over a data iterator with checkpointing."""
  trainer: trainer_lib.Trainer
  experiment: cfg_lib.ExperimentConfig
  model_dir: str
  log_period: int = 100
  # The held-out eval pass: the train state in, scalar metrics out.
  eval_fn: Optional[Callable[[trainer_lib.TrainState],
                             Dict[str, float]]] = None

  def maybe_resume(self, state: trainer_lib.TrainState
                   ) -> trainer_lib.TrainState:
    """The state of the latest checkpoint in model_dir, if any: its
    parameters go into the model, its optimizer state (or a fresh one, for
    a params-only checkpoint) and step into the returned state."""
    latest = checkpoints.latest_checkpoint(self.model_dir)
    if latest is None:
      return state
    restored = checkpoints.restore_checkpoint(latest,
                                              device=self.trainer.device)
    with torch.no_grad():
      self.trainer.model.module.load_state_dict(restored["params"])
    has_opt = "opt_state" in restored
    opt_state = restored["opt_state"] if has_opt else state.opt_state
    step = restored.get("step", 0)
    print(f"resumed from {latest} at step {step} "
          f"(opt_state={'restored' if has_opt else 'fresh'})")
    return trainer_lib.TrainState(step=step, opt_state=opt_state)

  def run(self,
          train_iter: Iterator[Dict[str, np.ndarray]],
          state: trainer_lib.TrainState,
          num_steps: Optional[int] = None,
          seed: int = 0) -> trainer_lib.TrainState:
    train_cfg = self.experiment.train
    num_steps = num_steps or train_cfg.train_steps
    logger = MetricsLogger(self.model_dir)

    start_step = state.step
    window_t0 = time.time()
    window_start = start_step
    window_frames = 0.0
    window_seqs = 0.0
    # Counters stay on the device between log periods, so the loop waits
    # for the card only at the log and checkpoint boundaries.
    for step in range(start_step + 1, num_steps + 1):
      state, metrics = self.trainer.train_step(state, next(train_iter), seed)
      window_frames = window_frames + metrics["n_frames"]
      window_seqs = window_seqs + metrics["n_seqs"]

      if step % self.log_period == 0 or step == num_steps:
        window_frames, window_seqs = float(window_frames), float(window_seqs)
        elapsed = time.time() - window_t0
        # seconds_per_step is the per-step mean over the window.
        logged = dict(metrics)
        logged.update(metrics_lib.throughput_metrics(
            window_seqs, window_frames, max(elapsed, 1e-9), 1,
            num_steps=max(step - window_start, 1)))
        logger.write(step, logged)
        window_t0 = time.time()
        window_start = step
        window_frames = window_seqs = 0.0

      if step % train_cfg.checkpoint_period == 0 or step == num_steps:
        path = checkpoints.save_checkpoint(
            self.model_dir, step, self.trainer.model.module.state_dict(),
            opt_state=state.opt_state,
            config_json=self.experiment.to_json())
        print(f"saved checkpoint: {path}")

      if self.eval_fn is not None and step % train_cfg.eval_period == 0:
        logger.write(step, {f"eval/{k}": v
                            for k, v in self.eval_fn(state).items()})

    logger.close()
    return state
