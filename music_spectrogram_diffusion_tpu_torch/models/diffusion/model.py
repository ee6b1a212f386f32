"""Diffusion models: the training loss and the sampler's predict path in
PyTorch.

Port of music_spectrogram_diffusion_tpu/models/diffusion/model.py:
`DiffusionModelBase` (`loss_fn`, `predict`), `DiffusionModel` (notes only)
and `ContextDiffusionModel` (notes and the previous segment's context). In
`loss_fn` a row whose condition is dropped sees no tokens (and no context);
its all-masked cross-attention is exactly zero (`zero_if_all_masked`). In
`predict` the encoders run once per segment and the cross-attention K/V are
projected once, eagerly; every sampler step then runs the fused CFG pair
as one 2B-row decoder forward whose unconditional rows skip
cross-attention (inside the guidance interval) or the conditional forward
alone (outside it). On a CUDA device each kind of step is captured once as
a CUDA graph (`ops/graphs.py`) and replayed: the encodings, K/V and
sampler state it reads are buffers kept per shape and refilled by `copy_`.

Batch schema:
  encoder_input_tokens      int   [B, L_in]
  encoder_continuous_inputs f32   [B, L_ctx, n_dims]  (context model only)
  encoder_continuous_mask   bool  [B, L_ctx]          (context model only)
  decoder_target_tokens     f32   [B, L_tgt, n_dims]  (shape only in predict)
  decoder_target_mask       bool  [B, L_tgt]          (loss_fn only)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from music_spectrogram_diffusion_tpu_torch.audio import codecs
from music_spectrogram_diffusion_tpu_torch.models.diffusion import network
from music_spectrogram_diffusion_tpu_torch.ops import diffusion as dops
from music_spectrogram_diffusion_tpu_torch.ops import graphs as graphs_lib
from music_spectrogram_diffusion_tpu_torch.parallel import mesh as mesh_lib


@dataclasses.dataclass
class _Segment:
  """What a segment's sampler steps read: the encodings and masks, the
  cached cross-attention K/V and the sampler's state. A captured model
  keeps one for each shape and sampler (its step graphs read these
  tensors) and refills it for every segment of that shape."""
  encodings: list
  cross_kv: list
  state: dops.SamplerState


class DiffusionModelBase:
  """The training loss and the sampler, shared by both diffusion models."""

  # Whether predict() takes the previous segment's features as context.
  USES_CONTEXT = False
  # The loss takes a step's draws (train.trainer.Trainer).
  takes_draws = True

  def __init__(self, module: nn.Module,
               diffusion_config: dops.DiffusionConfig,
               audio_codec: codecs.MelGan):
    self.module = module
    self.diffusion_config = diffusion_config
    self.audio_codec = audio_codec
    self.step_graphs = None  # graphs_lib.model_step_graphs
    self._slots: Dict[tuple, _Segment] = {}

  @property
  def device(self) -> torch.device:
    return self.module.decoder.spec_out_dense.kernel.device

  def init(self, seed: int) -> "DiffusionModelBase":
    """Random weights from `seed`, drawn on the CPU in float32 (so a seed
    gives the same weights on every device), then moved to the module's
    device."""
    device = self.device
    cpu = type(self.module)(self.module.config).init_weights(
        torch.Generator().manual_seed(seed))
    with torch.no_grad():
      for name, t in self.module.state_dict().items():
        t.copy_(cpu.state_dict()[name].to(device))
    return self

  def encode(self, batch: Mapping[str, torch.Tensor]):
    raise NotImplementedError

  @staticmethod
  def draws(generator: torch.Generator) -> dops.DrawsFn:
    """`loss_fn`'s draws from a step's generator."""
    return dops.generator_draws(generator)

  def _apply_train(self, batch: Mapping[str, torch.Tensor], z_t, time,
                   include: torch.Tensor,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """The training forward, the condition dropped where `include` is 0."""
    raise NotImplementedError

  def loss_fn(self, batch: Mapping[str, torch.Tensor], draws: dops.DrawsFn,
              dropout_generator: Optional[torch.Generator] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Masked, summed diffusion loss and scalar metrics.

    `draws` gives the step's eps, time and condition drop (JAX draws them
    from its key); rows whose condition is dropped see no tokens and no
    context. Dropout runs when `dropout_generator` is given (JAX: a
    dropout key), and not without one (JAX's eval pass).
    """
    targets = self.audio_codec.scale_features(
        batch["decoder_target_tokens"], output_range=(-1.0, 1.0), clip=True)
    z_t, eps, time, include = dops.training_input(draws, targets,
                                                  self.diffusion_config)
    model_output = self._apply_train(batch, z_t, time, include,
                                     dropout_generator)
    loss = dops.training_loss(targets, eps, z_t, time, model_output,
                              self.diffusion_config)
    mask = batch["decoder_target_mask"]
    loss = torch.sum(loss * mask[..., None].to(loss.dtype))
    n_frames = mask.sum().float()
    metrics = {
        "loss": loss,
        "loss_per_frame": loss / torch.clamp(n_frames, min=1.0),
        "n_frames": n_frames,
        "n_seqs": torch.tensor(float(targets.shape[0]), device=loss.device),
    }
    return loss, metrics

  def _denoisers(self, encodings, cross_kv, batch_size: int):
    """The sampler's two forwards over a segment's encodings and cached
    cross-attention K/V: the CFG pair as one 2B-row decoder forward whose
    unconditional rows skip cross-attention, and the conditional one."""
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
    return dict(denoise_pair_fn=denoise_pair_fn,
                denoise_cond_fn=denoise_cond_fn)

  @torch.inference_mode()
  def predict(self, batch: Mapping[str, torch.Tensor],
              noise: dops.NoiseFn,
              graphs: Optional[bool] = None) -> torch.Tensor:
    """Sample one spectrogram segment per row; returns features in the
    codec's range, [B, L_tgt, n_dims] float32.

    `graphs` None (the default) replays captured sampler steps on a CUDA
    device and runs them eagerly on the CPU; False runs them eagerly; True
    captures, and raises on the CPU (`ops.graphs.use_graphs`). Captured
    or eager, a segment's result is the same bit for bit.
    """
    config = self.diffusion_config
    target_shape = tuple(batch["decoder_target_tokens"].shape)
    captured = graphs_lib.use_graphs(
        self.device, graphs, collectives=mesh_lib.splits_model(self.module))
    encodings = self.encode(batch)
    cross_kv = self.module.precompute_cross_kv(encodings)
    key = (tuple(tuple(e.shape) for e, _ in encodings), target_shape, config)
    slot = self._slots.get(key) if captured else None
    if slot is None:
      slot = _Segment(encodings, cross_kv,
                      dops.SamplerState(target_shape, config, self.device))
      if captured:
        self._slots[key] = slot
    else:
      # The step graphs read the slot's buffers: refill them in place.
      graphs_lib.copy_tree_((slot.encodings, slot.cross_kv),
                            (encodings, cross_kv))
    state = slot.state
    state.start(noise)
    fns = self._denoisers(slot.encodings, slot.cross_kv, target_shape[0])
    step_graphs = graphs_lib.model_step_graphs(self)
    with graphs_lib.on_stream(step_graphs):
      dops.run(state, config, key=key,
               step_graphs=step_graphs if captured else None, **fns)
    return self.audio_codec.scale_to_features(state.z,
                                              input_range=(-1.0, 1.0))


def _drop_tokens(tokens: torch.Tensor, include: torch.Tensor) -> torch.Tensor:
  return tokens * dops.bcast_left(include, tokens.shape).to(tokens.dtype)


class DiffusionModel(DiffusionModelBase):
  """Notes-only model (JAX `DiffusionModel`): a dropped condition zeroes the
  tokens, so the whole key mask is 0 and cross-attention returns zero."""

  def encode(self, batch: Mapping[str, torch.Tensor]):
    return self.module.encode(batch["encoder_input_tokens"])

  def _apply_train(self, batch, z_t, time, include, generator):
    return self.module(_drop_tokens(batch["encoder_input_tokens"], include),
                       z_t, time, generator=generator)


class ContextDiffusionModel(DiffusionModelBase):
  """Dual-encoder model with previous-segment context; a dropped condition
  zeroes the tokens and the context mask."""

  USES_CONTEXT = True

  def _context(self, batch):
    return self.audio_codec.scale_features(
        batch["encoder_continuous_inputs"], output_range=(-1.0, 1.0),
        clip=True)

  def encode(self, batch: Mapping[str, torch.Tensor]):
    return self.module.encode(batch["encoder_input_tokens"],
                              self._context(batch),
                              batch["encoder_continuous_mask"])

  def _apply_train(self, batch, z_t, time, include, generator):
    ctx_mask = batch["encoder_continuous_mask"]
    ctx_mask = ctx_mask * dops.bcast_left(include, ctx_mask.shape).to(
        ctx_mask.dtype)
    return self.module(_drop_tokens(batch["encoder_input_tokens"], include),
                       self._context(batch), ctx_mask, z_t, time,
                       generator=generator)

  def loss_fn(self, batch, draws, dropout_generator=None):
    loss, metrics = super().loss_fn(batch, draws, dropout_generator)
    metrics["context_frames"] = batch["encoder_continuous_mask"].sum(
        dim=-1).float().mean()
    return loss, metrics
