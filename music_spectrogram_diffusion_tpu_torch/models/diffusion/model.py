"""Context diffusion model: the sampler's predict path in PyTorch.

Port of music_spectrogram_diffusion_tpu/models/diffusion/model.py
(`ContextDiffusionModel.predict`; training waits). Per segment the encoders
run once and the cross-attention K/V are projected once; every sampler
step then runs the fused CFG pair as one 2B-row decoder forward whose
unconditional rows skip cross-attention.

Batch schema:
  encoder_input_tokens      int   [B, L_in]
  encoder_continuous_inputs f32   [B, L_ctx, n_dims]
  encoder_continuous_mask   bool  [B, L_ctx]
  decoder_target_tokens     f32   [B, L_tgt, n_dims]  (shape only)
"""

from __future__ import annotations

from typing import Mapping

import torch

from music_spectrogram_diffusion_tpu_torch.audio import codecs
from music_spectrogram_diffusion_tpu_torch.models.diffusion import network
from music_spectrogram_diffusion_tpu_torch.ops import diffusion as dops


class ContextDiffusionModel:
  """Dual-encoder model with previous-segment context."""

  def __init__(self, module: network.ContextTransformer,
               diffusion_config: dops.DiffusionConfig,
               audio_codec: codecs.MelGan):
    self.module = module
    self.diffusion_config = diffusion_config
    self.audio_codec = audio_codec

  @property
  def device(self) -> torch.device:
    return self.module.decoder.spec_out_dense.kernel.device

  def encode(self, batch: Mapping[str, torch.Tensor]):
    context = self.audio_codec.scale_features(
        batch["encoder_continuous_inputs"], output_range=(-1.0, 1.0),
        clip=True)
    return self.module.encode(batch["encoder_input_tokens"], context,
                              batch["encoder_continuous_mask"])

  @torch.inference_mode()
  def predict(self, batch: Mapping[str, torch.Tensor],
              noise: dops.NoiseFn) -> torch.Tensor:
    """Sample one spectrogram segment per row; returns features in the
    codec's range, [B, L_tgt, n_dims] float32."""
    target_shape = tuple(batch["decoder_target_tokens"].shape)
    batch_size = target_shape[0]
    encodings = self.encode(batch)
    cross_kv = self.module.precompute_cross_kv(encodings)

    def denoise_cond_fn(z, time):
      return self.module.decode(encodings, z, time, cross_kv=cross_kv)

    if self.diffusion_config.guidance.eval_condition_weight != 1.0:
      def denoise_pair_fn(z, time):
        out = self.module.decode(
            encodings, torch.cat([z, z]), torch.cat([time, time]),
            cross_kv=cross_kv, cond_rows=batch_size)
        return out[:batch_size], out[batch_size:]
    else:
      def denoise_pair_fn(z, time):
        out = denoise_cond_fn(z, time)
        return out, out

    pred_x0 = dops.sample(noise, target_shape, self.diffusion_config,
                          denoise_pair_fn=denoise_pair_fn,
                          denoise_cond_fn=denoise_cond_fn,
                          device=self.device)
    return self.audio_codec.scale_to_features(pred_x0,
                                              input_range=(-1.0, 1.0))
