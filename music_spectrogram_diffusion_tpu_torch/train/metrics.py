"""Evaluation metrics: embedding distances, Fréchet audio distance,
timing rates.

A copy of music_spectrogram_diffusion_tpu/train/metrics.py, which imports
no JAX (numpy and scipy only): streaming mean/covariance with full
covariance up to 1024 dims (diagonal above), the TTUR-stable sqrtm trace,
per-example embedding L2, the mel-space proxy metrics, and the training
throughput rates reported per step.
"""

from __future__ import annotations

import collections
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
from scipy import linalg


def throughput_metrics(num_seqs: float, num_frames: float,
                       step_seconds: float,
                       num_devices: int = 1,
                       num_steps: int = 1) -> Dict[str, float]:
  """Throughput over a window of `num_steps` steps taking
  `step_seconds` wall seconds total."""
  out = {
      "timing/seqs_per_second": num_seqs / step_seconds,
      "timing/target_frames_per_second": num_frames / step_seconds,
      "timing/seconds_per_step": step_seconds / max(num_steps, 1),
  }
  out["timing/seqs_per_second_per_core"] = (
      out["timing/seqs_per_second"] / num_devices)
  out["timing/target_frames_per_second_per_core"] = (
      out["timing/target_frames_per_second"] / num_devices)
  return out


# ---------------------------------------------------------------------------
# Embedding distance + Fréchet audio distance.
# ---------------------------------------------------------------------------


def embedding_distance(embeddings_1: np.ndarray,
                       embeddings_2: np.ndarray) -> float:
  """Mean per-frame L2 distance over the common prefix."""
  num_frames = min(len(embeddings_1), len(embeddings_2))
  diff = embeddings_1[:num_frames] - embeddings_2[:num_frames]
  return float(np.mean(np.linalg.norm(diff, axis=1)))


def _stable_trace_sqrt_product(sigma_test: np.ndarray,
                               sigma_train: np.ndarray,
                               eps: float = 1e-7) -> float:
  """tr(sqrt(S1 S2)) with singular-product and imag-drift guards."""
  # No `disp` argument: newer scipy has none (the product is the same).
  sqrt_product = linalg.sqrtm(sigma_test.dot(sigma_train))
  if not np.isfinite(sqrt_product).all():
    offset = np.eye(sigma_test.shape[0]) * eps
    sqrt_product = linalg.sqrtm(
        (sigma_test + offset).dot(sigma_train + offset))
  if not np.allclose(np.diagonal(sqrt_product).imag, 0, atol=3e-3):
    m = np.max(np.abs(sqrt_product.imag))
    raise ValueError(f"sqrt_product contains large complex numbers: {m}")
  return float(np.trace(sqrt_product.real))


def frechet_distance(mu_1: np.ndarray, sigma_1: np.ndarray,
                     mu_2: np.ndarray, sigma_2: np.ndarray) -> float:
  """Fréchet distance between two Gaussians (full or diagonal cov)."""
  assert mu_1.shape == mu_2.shape
  assert sigma_1.shape == sigma_2.shape
  mu_diff = mu_1 - mu_2
  mu_dist = float(mu_diff.dot(mu_diff))
  if sigma_1.ndim == 2:
    trace_sqrt = _stable_trace_sqrt_product(sigma_1, sigma_2)
    return (mu_dist + float(np.trace(sigma_1)) + float(np.trace(sigma_2))
            - 2.0 * trace_sqrt)
  return (mu_dist + float(np.sum(sigma_1)) + float(np.sum(sigma_2))
          - 2.0 * float(np.sum(np.sqrt(sigma_1 * sigma_2))))


class StreamingMultivariateGaussian:
  """Streaming mean/covariance; diagonal above 1024 dims."""

  _MAX_FULL_COVARIANCE_DIM = 1024

  def __init__(self):
    self.n = 0
    self.mu: Optional[np.ndarray] = None
    self._sigma_accum: Optional[np.ndarray] = None

  def update(self, x: np.ndarray) -> None:
    n, d = x.shape
    if self.n == 0:
      self.n = n
      self.mu = np.mean(x, axis=0)
      x_res = x - self.mu[None, :]
      if d <= self._MAX_FULL_COVARIANCE_DIM:
        self._sigma_accum = np.dot(x_res.T, x_res)
      else:
        self._sigma_accum = np.sum(x_res * x_res, axis=0)
    else:
      x_res_pre = x - self.mu[None, :]
      self.n += n
      self.mu += np.sum(x_res_pre, axis=0) / self.n
      x_res_post = x - self.mu[None, :]
      if d <= self._MAX_FULL_COVARIANCE_DIM:
        self._sigma_accum += np.dot(x_res_pre.T, x_res_post)
      else:
        self._sigma_accum += np.sum(x_res_pre * x_res_post, axis=0)

  @property
  def sigma(self) -> np.ndarray:
    return self._sigma_accum / self.n


def reconstruction_metrics(
    targets: Sequence[Mapping], predictions: Sequence[Mapping]
) -> Dict[str, float]:
  """Per-embedding-type mean distance + Fréchet audio distance.

  Each element carries {'embeddings': {type: [frames, dim] array}}.
  """
  scores = collections.defaultdict(list)
  target_gaussians = collections.defaultdict(StreamingMultivariateGaussian)
  pred_gaussians = collections.defaultdict(StreamingMultivariateGaussian)

  for target, prediction in zip(targets, predictions):
    t_emb, p_emb = target["embeddings"], prediction["embeddings"]
    assert t_emb.keys() == p_emb.keys()
    for etype in t_emb:
      scores[f"{etype}_distance"].append(
          embedding_distance(t_emb[etype], p_emb[etype]))
      target_gaussians[etype].update(t_emb[etype])
      pred_gaussians[etype].update(p_emb[etype])

  result = {k: float(np.mean(v)) for k, v in scores.items()}
  for name in target_gaussians:
    result[f"{name}_frechet"] = frechet_distance(
        target_gaussians[name].mu, target_gaussians[name].sigma,
        pred_gaussians[name].mu, pred_gaussians[name].sigma)
  return result


def count_examples(targets, predictions) -> Dict[str, int]:
  assert len(targets) == len(predictions)
  return {"num_examples": len(targets)}


def model_timing(targets, predictions) -> Dict[str, float]:
  """Average the realtime factors recorded during rendering."""
  out = collections.defaultdict(list)
  for prediction in predictions:
    for k, v in prediction.get("timings", {}).items():
      out[k].append(v)
  return {k: float(np.mean(v)) for k, v in out.items()}


# ---------------------------------------------------------------------------
# Mel-domain proxy metrics (no pretrained embedder needed).
# ---------------------------------------------------------------------------


def mel_spectral_metrics(target_mel: np.ndarray,
                         pred_mel: np.ndarray) -> Dict[str, float]:
  """Cheap spectrogram-space distances: L1/L2 and mel-frame FAD.

  Used when VGGish/TRILL embedders are unavailable: treats mel frames
  themselves as the embedding space (full 128-dim covariance).
  """
  n = min(len(target_mel), len(pred_mel))
  t, p = np.asarray(target_mel[:n]), np.asarray(pred_mel[:n])
  out = {
      "mel_l1": float(np.mean(np.abs(t - p))),
      "mel_l2": float(np.mean((t - p) ** 2)),
  }
  tg, pg = StreamingMultivariateGaussian(), StreamingMultivariateGaussian()
  tg.update(t)
  pg.update(p)
  try:
    out["mel_frechet"] = frechet_distance(tg.mu, tg.sigma, pg.mu, pg.sigma)
  except ValueError:
    # Degenerate covariance (e.g. constant frames / random-weight runs):
    # fall back to the diagonal-covariance distance.
    out["mel_frechet"] = frechet_distance(
        tg.mu, np.diagonal(tg.sigma).copy(),
        pg.mu, np.diagonal(pg.sigma).copy())
  return out
