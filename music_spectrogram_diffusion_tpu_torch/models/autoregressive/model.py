"""Autoregressive model: the teacher-forced loss and the cached decode loop
in PyTorch.

Port of music_spectrogram_diffusion_tpu/models/autoregressive/model.py
(`AutoregressiveModel`). `predict` encodes once, projects the
cross-attention K/V once, and then runs `target_len` single-frame decode
steps against the self-attention cache, each step's sampled frame feeding
the next. The loop is a Python loop of eager steps; JAX's is one
`lax.scan`.

Batch schema:
  encoder_input_tokens   int   [B, L_in]
  decoder_input_tokens   f32   [B, L_tgt, n_dims]  (teacher forcing: the
                                                    targets shifted by one)
  decoder_target_tokens  f32   [B, L_tgt, n_dims]  (shape only in predict)
  decoder_target_mask    bool  [B, L_tgt]          (loss_fn only)
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from music_spectrogram_diffusion_tpu_torch.audio import codecs
from music_spectrogram_diffusion_tpu_torch.models.autoregressive import (
    network)
from music_spectrogram_diffusion_tpu_torch.ops import diffusion as dops


class AutoregressiveModel:
  """Continuous-output encoder-decoder with an output head."""

  USES_CONTEXT = False

  def __init__(self, module: network.ARTransformer, output_function,
               audio_codec: codecs.MelGan):
    self.module = module
    self.output_function = output_function
    self.audio_codec = audio_codec

  @property
  def device(self) -> torch.device:
    return self.module.decoder.spec_out_dense.kernel.device

  def init(self, seed: int) -> "AutoregressiveModel":
    """Random weights from `seed`, drawn on the CPU in float32, then moved
    to the module's device."""
    device = self.device
    cpu = network.ARTransformer(self.module.config).init_weights(
        torch.Generator().manual_seed(seed))
    with torch.no_grad():
      for name, t in self.module.state_dict().items():
        t.copy_(cpu.state_dict()[name].to(device))
    return self

  def loss_fn(self, batch: Mapping[str, torch.Tensor],
              dropout_generator: Optional[torch.Generator] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The head's loss per frame x decoder_target_mask, summed, and scalar
    metrics. Dropout runs when `dropout_generator` is given."""
    targets = batch["decoder_target_tokens"]
    outputs = self.module(batch["encoder_input_tokens"],
                          batch["decoder_input_tokens"],
                          generator=dropout_generator)
    mask = batch["decoder_target_mask"]
    loss = self.output_function.get_loss(outputs, targets)
    loss = torch.sum(loss * mask.to(loss.dtype))
    n_frames = mask.sum().float()
    return loss, {
        "loss": loss,
        "loss_per_frame": loss / torch.clamp(n_frames, min=1.0),
        "n_frames": n_frames,
        "n_seqs": torch.tensor(float(targets.shape[0]), device=loss.device),
    }

  @torch.inference_mode()
  def predict(self, batch: Mapping[str, torch.Tensor],
              noise: dops.NoiseFn) -> torch.Tensor:
    """Generate one segment per row, frame by frame; returns features
    [B, L_tgt, n_dims] float32. `noise` feeds the head's sampling (one
    generator per row: `synthesize.seeded_noise`); the deterministic head
    without dither draws nothing."""
    tokens = batch["encoder_input_tokens"]
    batch_size, target_len = batch["decoder_target_tokens"].shape[:2]
    encoded = self.module.encode(tokens)
    cache = self.module.init_cache(encoded, tokens, target_len)
    frame = torch.zeros(batch_size, 1, self.audio_codec.n_dims,
                        device=tokens.device)
    frames = []
    for i in range(target_len):
      out = self.module.decode_step(cache, frame, i)
      frame = self.output_function.get_sample(out[:, 0], noise, i)[:, None]
      frames.append(frame)
    return torch.cat(frames, dim=1).float()
