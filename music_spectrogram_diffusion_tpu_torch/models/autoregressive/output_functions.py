"""Output heads of the autoregressive model: network output -> loss per
frame, and -> a sampled frame.

Port of music_spectrogram_diffusion_tpu/models/autoregressive/
output_functions.py. A head that samples takes a step's float32 standard
normal draws, [b, *] of `draw_shape`, as a tensor: the decode loop draws
every step's from a `NoiseFn` (ops/diffusion.py) before it starts, one
generator per batch row (`generator_noise`) so that a row's samples do
not depend on its batch neighbours, and a step reads its row of that
table on the device; tests inject draws. As in JAX, a sample is
float32 whatever the network's dtype (bf16 output plus float32 noise). The mixture's component
is drawn by inverting its cumulative probabilities at u = Phi(n), a uniform
made from the first normal draw of the row.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


class Deterministic:
  """Point-estimate head: mean squared error over a frame's dims; sampling
  returns the output, plus normal noise x `sampling_dither_amount` when
  that is positive."""

  expected_num_dims = 0  # the decoder's natural output size

  def __init__(self, sampling_dither_amount: float = 0.0):
    self.sampling_dither_amount = sampling_dither_amount

  def get_loss(self, outputs: torch.Tensor,
               targets: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(outputs - targets), dim=-1)

  def draw_shape(self, batch: int, out_dims: int):
    """The draws of one step for `batch` outputs of `out_dims`: None
    without dither."""
    return (batch, out_dims) if self.sampling_dither_amount > 0 else None

  def get_sample(self, outputs: torch.Tensor,
                 draws: Optional[torch.Tensor]) -> torch.Tensor:
    """outputs [b, dims] -> a frame [b, dims]; `draws` [b, dims] with
    dither, else None."""
    if self.sampling_dither_amount > 0:
      outputs = outputs + draws * self.sampling_dither_amount
    return outputs


class GaussianMixture:
  """Mixture of diagonal Gaussians over each frame.

  Network output per frame: [n_components logits, n_components x dims mu,
  n_components x dims raw sigma], sigma squashed into [min_sigma,
  max_sigma] by a sigmoid.
  """

  def __init__(self, n_components: int = 10, dims_per_component: int = 128,
               min_sigma: float = 0.1, max_sigma: float = 1.0):
    self.n_components = n_components
    self.dims_per_component = dims_per_component
    self.min_sigma, self.max_sigma = min_sigma, max_sigma

  @property
  def expected_num_dims(self) -> int:
    return self.n_components + 2 * self.n_components * self.dims_per_component

  def unpack(self, outputs: torch.Tensor):
    """(logits [..., n], mu [..., n, dims], sigma [..., n, dims])."""
    if outputs.shape[-1] != self.expected_num_dims:
      raise ValueError(
          f"GaussianMixture expects {self.expected_num_dims} dims, got "
          f"{outputs.shape[-1]} (shape {tuple(outputs.shape)})")
    n, dims = self.n_components, self.dims_per_component
    logits = outputs[..., :n]
    rest = outputs[..., n:]
    half = rest.shape[-1] // 2
    comp_shape = tuple(outputs.shape[:-1]) + (n, dims)
    mu = rest[..., :half].reshape(comp_shape)
    sigma = torch.sigmoid(rest[..., half:].reshape(comp_shape))
    sigma = (self.max_sigma - self.min_sigma) * sigma + self.min_sigma
    return logits, mu, sigma

  def get_loss(self, outputs: torch.Tensor,
               targets: torch.Tensor) -> torch.Tensor:
    """-log p(target) under the mixture, per frame."""
    logits, mu, sigma = self.unpack(outputs)
    log_mix = F.log_softmax(logits, dim=-1)
    x = targets[..., None, :]
    log_norm = -0.5 * (torch.square((x - mu) / sigma)
                       + 2.0 * torch.log(sigma) + math.log(2.0 * math.pi))
    return -torch.logsumexp(log_mix + log_norm.sum(dim=-1), dim=-1)

  def draw_shape(self, batch: int, out_dims: int):
    """One step's draws: [batch, 1 + dims]."""
    del out_dims  # expected_num_dims
    return (batch, 1 + self.dims_per_component)

  def get_sample(self, outputs: torch.Tensor,
                 draws: torch.Tensor) -> torch.Tensor:
    """outputs [b, expected_num_dims] -> a frame [b, dims] from the step's
    draws [b, 1 + dims], the first column picking the component."""
    logits, mu, sigma = self.unpack(outputs)
    comp = sample_component(logits.float(), draws[:, 0])
    pick = comp[:, None, None].expand(-1, 1, self.dims_per_component)
    mu_sel = torch.gather(mu, -2, pick)[:, 0]
    sigma_sel = torch.gather(sigma, -2, pick)[:, 0]
    return mu_sel + sigma_sel * draws[:, 1:]


def sample_component(logits: torch.Tensor, normal: torch.Tensor
                     ) -> torch.Tensor:
  """The categorical draw of each row of `logits` [b, n] from one standard
  normal per row: the first k whose cumulative probability exceeds
  Phi(normal)."""
  u = torch.special.ndtr(normal.float())
  cdf = torch.cumsum(torch.softmax(logits, dim=-1), dim=-1)
  comp = torch.sum(cdf < u[:, None], dim=-1)
  return torch.clamp(comp, max=logits.shape[-1] - 1)


def build(kind: str, n_dims: int):
  """The head `ar_output` names, as the JAX package's build_model makes
  it: 'deterministic', or 'gaussian_mixture' with 10 components of
  n_dims."""
  if kind == "deterministic":
    return Deterministic()
  if kind == "gaussian_mixture":
    return GaussianMixture(n_components=10, dims_per_component=n_dims)
  raise ValueError(f"unknown ar_output: {kind}")
