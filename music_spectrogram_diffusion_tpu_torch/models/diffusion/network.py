"""Spectrogram-diffusion transformers (notes-only and context) in PyTorch.

Port of music_spectrogram_diffusion_tpu/models/diffusion/network.py: a
T5.1.1 token encoder (`Transformer`, the notes-only model) or a token
encoder and a context encoder over the previous segment's spectrogram
(`ContextTransformer`), and a FiLM-conditioned non-causal decoder that
denoises a whole segment at once.

As in the JAX module, `precompute_cross_kv` projects the cross-attention
K/V once per segment, and `decode(..., cond_rows=B)` runs the fused CFG
pair as one 2B-row forward whose unconditional rows skip cross-attention
(their output is exactly zero); both are for serving. Module and parameter
names follow the Flax tree (`layers_<i>` become `layers.<i>`, see
convert.py).

Training: every forward takes an optional `generator`; with one, dropout
runs at the JAX module's sites (rate `dropout_rate`), with the same
broadcast over the length axis where JAX has it. Without one the forward
is deterministic. With `remat` every encoder and decoder layer is
rematerialized in grad mode, as JAX's `nn.remat` of each layer
(`_run_layer`): its activations are recomputed in the backward pass, with
the same dropout masks.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils import checkpoint

from music_spectrogram_diffusion_tpu_torch.models import layers
from music_spectrogram_diffusion_tpu_torch.ops import diffusion as dops

# (encoded [b, l, emb], bool keep-mask [b, l]) per encoder.
EncodingsAndMasks = List[Tuple[torch.Tensor, torch.Tensor]]
# Per decoder layer: per cross-attention module, cached (key, value).
CrossKVCache = List[List[Tuple[torch.Tensor, torch.Tensor]]]


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
  """Transformer hyperparameters (as the JAX NetworkConfig)."""
  vocab_size: int
  dtype: torch.dtype = torch.float32
  emb_dim: int = 512
  num_heads: int = 8
  num_encoder_layers: int = 6
  num_decoder_layers: int = 6
  head_dim: int = 64
  mlp_dim: int = 2048
  mlp_activations: Sequence[str] = ("relu",)
  # Applied only when a forward is given a generator (training).
  dropout_rate: float = 0.1
  max_decoder_noise_time: float = 2e4
  cross_attend_style: str = "sum_cross_attends"  # | 'concat_encodings'
  # 'fixed' | 'fixed_permuted_offset' (frozen tables) |
  # 'learnable_permuted_offset' | 'random' (trained tables)
  position_encoding: str = "fixed"
  context_positions: str = "regular"  # | 'terminal_relative'
  max_input_length: int = 2048
  max_context_length: int = 256
  max_target_length: int = 256
  output_dim: int = 128
  # Per-layer rematerialization in grad mode (training); serving ignores it.
  remat: bool = False


def sequence_length_from_mask(mask: torch.Tensor) -> torch.Tensor:
  """Per row of a [b, l] mask: length of the leading non-zero run."""
  zero = mask == 0
  first_zero = torch.argmax(zero.int(), dim=-1)
  return torch.where(zero.any(dim=-1), first_zero,
                     torch.full_like(first_zero, mask.shape[-1]))


def terminal_relative_positions(positions: torch.Tensor,
                                seq_len: torch.Tensor) -> torch.Tensor:
  """Roll each row so its last valid element sits at position max_len-1:
  max length 5, length 2 gives [3, 4, 0, 1, 2]."""
  length = positions.shape[-1]
  idx = torch.arange(length, device=positions.device)
  src = (idx[None, :] - seq_len[:, None]) % length
  return torch.gather(positions, -1, src)


# position_encoding -> (sinusoidal table with permuted bands and random
# phases, or not; a normal table, or not; trained), as JAX's
# `position_encoder`.
_POSITION_ENCODINGS = {
    "fixed": (False, False, False),
    "fixed_permuted_offset": (True, False, False),
    "learnable_permuted_offset": (True, False, True),
    "random": (False, True, True),
}


class PositionEncoder(layers.Embed):
  """Position table, a parameter. 'fixed' and 'fixed_permuted_offset' are
  sinusoidal and never trained; 'learnable_permuted_offset' starts as the
  permuted table and is trained; 'random' starts as a normal of std
  features^-0.5 (Flax's variance scaling, fan in) and is trained."""

  def __init__(self, cfg: NetworkConfig, max_length: int):
    if cfg.position_encoding not in _POSITION_ENCODINGS:
      raise ValueError(
          f"Unknown position_encoding: {cfg.position_encoding}")
    permuted, self.normal_init, trained = _POSITION_ENCODINGS[
        cfg.position_encoding]
    super().__init__(max_length, cfg.emb_dim, dtype=cfg.dtype,
                     fixed=not trained)
    self.permuted = permuted

  def init_weights(self, generator):
    with torch.no_grad():
      if self.normal_init:
        self.embedding.normal_(std=self.embedding.shape[1] ** -0.5,
                               generator=generator)
      else:
        self.embedding.copy_(layers.sinusoidal_table(
            *self.embedding.shape,
            generator=generator if self.permuted else None))


def _dropout(x, rate, generator, broadcast: bool = True):
  """The JAX module's nn.Dropout, one draw along the length axis unless
  `broadcast` is False."""
  return layers.dropout(x, rate, generator,
                        broadcast_dims=(-2,) if broadcast else ())


def _run_layer(layer: nn.Module, remat: bool,
               generator: Optional[torch.Generator], *args):
  """layer(*args, generator), rematerialized when `remat` and grad mode is
  on: the layer's activations are not kept, and its forward runs again in
  the backward pass (torch.utils.checkpoint, non-reentrant, so the rerun
  sees grad mode on and attention takes the same differentiable path).

  Dropout draws from `generator`, which checkpoint's RNG stashing does not
  cover. So the layer runs, both times, from a generator restored to the
  state `generator` had before it, and `generator` then takes the state the
  first run left: the masks of the rerun are the first run's, and
  `generator` advances as it does without remat, so remat on and off give
  the same masks (as JAX's nn.remat, which replays the layer's key).
  """
  if not (remat and torch.is_grad_enabled()):
    return layer(*args, generator)
  if generator is None:
    return checkpoint.checkpoint(layer, *args, None, use_reentrant=False)
  start, after = generator.get_state(), []

  def run(*inputs):
    replay = torch.Generator(device=generator.device)
    replay.set_state(start)
    out = layer(*inputs, replay)
    if not after:  # the first run; the rerun draws the same
      after.append(replay.get_state())
    return out

  out = checkpoint.checkpoint(run, *args, use_reentrant=False)
  generator.set_state(after[0])
  return out


def _init_children(module: nn.Module, generator: torch.Generator):
  for child in module.children():
    if hasattr(child, "init_weights"):
      child.init_weights(generator)
    else:
      _init_children(child, generator)


class EncoderLayer(nn.Module):
  """Pre-norm self-attention + MLP block."""

  def __init__(self, cfg: NetworkConfig):
    super().__init__()
    d, rate = cfg.dtype, cfg.dropout_rate
    self.dropout_rate = rate
    self.pre_attention_norm = layers.RMSNorm(cfg.emb_dim, dtype=d)
    self.attention = layers.MultiHeadAttention(
        cfg.emb_dim, cfg.num_heads, cfg.head_dim, cfg.emb_dim, dtype=d,
        dropout_rate=rate)
    self.pre_mlp_norm = layers.RMSNorm(cfg.emb_dim, dtype=d)
    self.mlp = layers.MlpBlock(cfg.emb_dim, cfg.mlp_dim, cfg.mlp_activations,
                               dtype=d, dropout_rate=rate)

  def init_weights(self, generator):
    _init_children(self, generator)

  def forward(self, inputs: torch.Tensor, mask: torch.Tensor,
              generator: Optional[torch.Generator] = None):
    # The padding mask rides as a [b, len] key mask: padded query rows
    # attend the valid keys, and every consumer masks them anyway.
    x = self.pre_attention_norm(inputs)
    x = self.attention(x, x, kv_mask=mask, generator=generator)
    x = _dropout(x, self.dropout_rate, generator) + inputs
    y = self.mlp(self.pre_mlp_norm(x), generator)
    return _dropout(y, self.dropout_rate, generator) + x


class _Encoder(nn.Module):
  def __init__(self, cfg: NetworkConfig, max_length: int):
    super().__init__()
    self.cfg = cfg
    self.position_encoder = PositionEncoder(cfg, max_length)
    self.layers = nn.ModuleList(
        EncoderLayer(cfg) for _ in range(cfg.num_encoder_layers))
    self.encoder_norm = layers.RMSNorm(cfg.emb_dim, dtype=cfg.dtype)

  def init_weights(self, generator):
    _init_children(self, generator)

  def _run(self, x, mask, generator):
    rate = self.cfg.dropout_rate
    x = _dropout(x, rate, generator).to(self.cfg.dtype)
    for layer in self.layers:
      x = _run_layer(layer, self.cfg.remat, generator, x, mask)
    return _dropout(self.encoder_norm(x), rate, generator,
                    broadcast=False), mask


class TokenEncoder(_Encoder):
  """Encodes note event tokens [b, l] (0 = padding)."""

  def __init__(self, cfg: NetworkConfig):
    super().__init__(cfg, cfg.max_input_length)
    self.token_embedder = layers.Embed(cfg.vocab_size, cfg.emb_dim,
                                       dtype=cfg.dtype)

  def init_weights(self, generator):
    with torch.no_grad():
      self.token_embedder.embedding.normal_(generator=generator)
    super().init_weights(generator)

  def forward(self, token_ids: torch.Tensor, mask: torch.Tensor,
              generator: Optional[torch.Generator] = None):
    seq_length = token_ids.shape[1]
    if seq_length > self.cfg.max_input_length:
      raise ValueError(f"{seq_length} > max_input_length "
                       f"{self.cfg.max_input_length}")
    positions = torch.arange(seq_length, device=token_ids.device)[None, :]
    x = self.token_embedder(token_ids) + self.position_encoder(positions)
    return self._run(x, mask, generator)


class ContinuousEncoder(_Encoder):
  """Encodes the previous segment's spectrogram (the context)."""

  def __init__(self, cfg: NetworkConfig):
    super().__init__(cfg, cfg.max_context_length)
    self.input_proj = layers.DenseGeneral(cfg.output_dim, cfg.emb_dim,
                                          dtype=cfg.dtype)

  def forward(self, continuous_inputs: torch.Tensor, mask: torch.Tensor,
              generator: Optional[torch.Generator] = None):
    batch, max_positions = continuous_inputs.shape[:2]
    if max_positions > self.cfg.max_context_length:
      raise ValueError(f"{max_positions} > max_context_length "
                       f"{self.cfg.max_context_length}")
    x = self.input_proj(continuous_inputs)
    positions = torch.arange(max_positions, device=x.device).expand(
        batch, max_positions)
    if self.cfg.context_positions == "terminal_relative":
      positions = terminal_relative_positions(
          positions, sequence_length_from_mask(mask))
    elif self.cfg.context_positions != "regular":
      raise ValueError(
          f"Unknown context_positions: {self.cfg.context_positions}")
    return self._run(x + self.position_encoder(positions), mask, generator)


class DecoderLayer(nn.Module):
  """FiLM-conditioned self-attention (no causal mask) + cross-attention
  over the encoder memory + gated MLP."""

  def __init__(self, cfg: NetworkConfig):
    super().__init__()
    self.cfg = cfg
    d, e, rate = cfg.dtype, cfg.emb_dim, cfg.dropout_rate
    if cfg.cross_attend_style == "concat_encodings":
      n_cross = 1
    elif cfg.cross_attend_style == "sum_cross_attends":
      n_cross = 2
    else:
      raise ValueError(
          f"Unknown cross_attend_style: {cfg.cross_attend_style}")
    self.pre_self_attention_norm = layers.RMSNorm(e, dtype=d)
    self.self_attention_film = layers.FiLM(4 * e, e)
    self.self_attention = layers.MultiHeadAttention(
        e, cfg.num_heads, cfg.head_dim, e, dtype=d, dropout_rate=rate)
    self.pre_cross_attention_norm = layers.RMSNorm(e, dtype=d)
    self.cross_attentions = nn.ModuleList(
        layers.MultiHeadAttention(e, cfg.num_heads, cfg.head_dim, e, dtype=d,
                                  dropout_rate=rate)
        for _ in range(n_cross))
    self.pre_mlp_norm = layers.RMSNorm(e, dtype=d)
    self.mlp_film = layers.FiLM(4 * e, e)
    self.mlp = layers.MlpBlock(e, cfg.mlp_dim, cfg.mlp_activations, dtype=d,
                               dropout_rate=rate)

  def init_weights(self, generator):
    _init_children(self, generator)

  def precompute_cross_kv(self, encodings_and_masks: EncodingsAndMasks):
    """Cross-attention K/V for each memory; done once per segment."""
    if self.cfg.cross_attend_style == "concat_encodings":
      encoded = torch.cat([e for e, _ in encodings_and_masks], dim=1)
      return [self.cross_attentions[0].project_kv(encoded)]
    return [attn.project_kv(e)
            for attn, (e, _) in zip(self.cross_attentions,
                                    encodings_and_masks)]

  def forward(self, inputs: torch.Tensor,
              encodings_and_masks: EncodingsAndMasks,
              conditioning: torch.Tensor,
              cross_kv: Optional[List[Tuple[torch.Tensor, torch.Tensor]]],
              cond_rows: Optional[int] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    rate = self.cfg.dropout_rate
    x = self.self_attention_film(self.pre_self_attention_norm(inputs),
                                 conditioning)
    x = self.self_attention(x, x, generator=generator)
    x = _dropout(x, rate, generator) + inputs

    y = self.pre_cross_attention_norm(x)
    # CFG fast path: rows >= cond_rows are the unconditional half, whose
    # cross-attention output is exactly zero; compute the others only.
    tail = 0
    if cond_rows is not None and cond_rows < y.shape[0]:
      tail = y.shape[0] - cond_rows
      y = y[:cond_rows]

    if self.cfg.cross_attend_style == "concat_encodings":
      pairs = [(torch.cat([e for e, _ in encodings_and_masks], dim=1),
                torch.cat([m for _, m in encodings_and_masks], dim=-1))]
    else:
      pairs = list(encodings_and_masks)
    out = 0
    for idx, (encoded, mask) in enumerate(pairs):
      attn = self.cross_attentions[idx]
      if cross_kv is not None:
        y_n = attn(y, cached_kv=cross_kv[idx], kv_mask=mask,
                   generator=generator)
      else:
        y_n = attn(y, encoded, kv_mask=mask, generator=generator)
      # JAX drops each sum term, or the one concatenated term.
      out = out + _dropout(layers.zero_if_all_masked(y_n, mask), rate,
                           generator)
    if tail:
      out = torch.cat([out, out.new_zeros((tail,) + out.shape[1:])], dim=0)
    y = out + x

    z = self.mlp_film(self.pre_mlp_norm(y), conditioning)
    return _dropout(self.mlp(z, generator), rate, generator) + y


class Decoder(nn.Module):
  """Denoising decoder: z_t and the diffusion time -> model output."""

  def __init__(self, cfg: NetworkConfig):
    super().__init__()
    self.cfg = cfg
    e = cfg.emb_dim
    self.time_emb_dense0 = layers.DenseGeneral(e, 4 * e, dtype=cfg.dtype)
    self.time_emb_dense1 = layers.DenseGeneral(4 * e, 4 * e, dtype=cfg.dtype)
    self.continuous_inputs_projection = layers.DenseGeneral(
        cfg.output_dim, e, dtype=cfg.dtype)
    self.position_encoder = PositionEncoder(cfg, cfg.max_target_length)
    self.layers = nn.ModuleList(
        DecoderLayer(cfg) for _ in range(cfg.num_decoder_layers))
    self.decoder_norm = layers.RMSNorm(e, dtype=cfg.dtype)
    # Final projection in float32 for the sampler's numerical stability.
    self.spec_out_dense = layers.DenseGeneral(e, cfg.output_dim,
                                              dtype=torch.float32)

  def init_weights(self, generator):
    _init_children(self, generator)

  def _conditioning(self, noise_time: torch.Tensor) -> torch.Tensor:
    """Diffusion time -> FiLM conditioning [b, 1, 4*emb]."""
    cfg = self.cfg
    emb = dops.timing_embedding(noise_time * cfg.max_decoder_noise_time,
                                cfg.emb_dim,
                                max_timescale=cfg.max_decoder_noise_time)
    emb = F.silu(self.time_emb_dense0(emb))
    emb = F.silu(self.time_emb_dense1(emb))
    return emb[:, None, :]

  def precompute_cross_kv(self, encodings_and_masks) -> CrossKVCache:
    return [lyr.precompute_cross_kv(encodings_and_masks)
            for lyr in self.layers]

  def forward(self, encodings_and_masks: EncodingsAndMasks,
              decoder_input_tokens: torch.Tensor,
              decoder_noise_time: torch.Tensor,
              cross_kv: Optional[CrossKVCache] = None,
              cond_rows: Optional[int] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    cfg = self.cfg
    batch, seq_length, n_out = decoder_input_tokens.shape
    if seq_length > cfg.max_target_length or n_out != cfg.output_dim:
      raise ValueError(
          f"decoder input {tuple(decoder_input_tokens.shape)} exceeds "
          f"max_target_length {cfg.max_target_length} or is not "
          f"output_dim {cfg.output_dim} wide")
    if tuple(decoder_noise_time.shape) != (batch,):
      raise ValueError(f"noise time {tuple(decoder_noise_time.shape)} is "
                       f"not [{batch}]")
    conditioning = self._conditioning(decoder_noise_time)
    positions = torch.arange(seq_length, device=decoder_input_tokens.device)
    y = (self.continuous_inputs_projection(decoder_input_tokens) +
         self.position_encoder(positions)[None])
    y = _dropout(y, cfg.dropout_rate, generator).to(cfg.dtype)
    for i, lyr in enumerate(self.layers):
      y = _run_layer(lyr, cfg.remat, generator, y, encodings_and_masks,
                     conditioning,
                     cross_kv[i] if cross_kv is not None else None,
                     cond_rows)
    y = _dropout(self.decoder_norm(y), cfg.dropout_rate, generator)
    return self.spec_out_dense(y)


class Transformer(nn.Module):
  """Single-encoder (notes only) diffusion transformer; the decoder's one
  cross-attention attends the token encoding (`concat_encodings` over one
  encoding)."""

  def __init__(self, cfg: NetworkConfig):
    super().__init__()
    self.config = cfg
    self.encoder = TokenEncoder(cfg)
    self.decoder = Decoder(cfg)

  def init_weights(self, generator: torch.Generator) -> "Transformer":
    """Random weights drawn as Flax draws them (its initializers and
    scales, not its random numbers)."""
    _init_children(self, generator)
    return self

  def encode(self, input_tokens: torch.Tensor,
             generator: Optional[torch.Generator] = None
             ) -> EncodingsAndMasks:
    return [self.encoder(input_tokens, input_tokens > 0, generator)]

  def precompute_cross_kv(self, encodings_and_masks) -> CrossKVCache:
    return self.decoder.precompute_cross_kv(encodings_and_masks)

  def decode(self, encodings_and_masks: EncodingsAndMasks,
             input_tokens: torch.Tensor, noise_time: torch.Tensor,
             cross_kv: Optional[CrossKVCache] = None,
             cond_rows: Optional[int] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return self.decoder(encodings_and_masks, input_tokens, noise_time,
                        cross_kv=cross_kv, cond_rows=cond_rows,
                        generator=generator).to(self.config.dtype)

  def forward(self, encoder_input_tokens, decoder_input_tokens,
              decoder_noise_time,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The training forward (JAX `__call__`): dropout when `generator` is
    given, none without."""
    encodings = self.encode(encoder_input_tokens, generator)
    return self.decode(encodings, decoder_input_tokens, decoder_noise_time,
                       generator=generator)


class ContextTransformer(nn.Module):
  """Dual-encoder (notes + previous-segment context) diffusion transformer."""

  def __init__(self, cfg: NetworkConfig):
    super().__init__()
    self.config = cfg
    self.token_encoder = TokenEncoder(cfg)
    self.continuous_encoder = ContinuousEncoder(cfg)
    self.decoder = Decoder(cfg)

  def init_weights(self, generator: torch.Generator) -> "ContextTransformer":
    """Random weights drawn as Flax draws them (its initializers and
    scales, not its random numbers)."""
    _init_children(self, generator)
    return self

  def encode(self, input_tokens: torch.Tensor,
             continuous_inputs: torch.Tensor,
             continuous_mask: torch.Tensor,
             generator: Optional[torch.Generator] = None
             ) -> EncodingsAndMasks:
    tokens_mask = input_tokens > 0
    continuous_mask = continuous_mask > 0
    return [self.token_encoder(input_tokens, tokens_mask, generator),
            self.continuous_encoder(continuous_inputs, continuous_mask,
                                    generator)]

  def precompute_cross_kv(self, encodings_and_masks) -> CrossKVCache:
    return self.decoder.precompute_cross_kv(encodings_and_masks)

  def decode(self, encodings_and_masks: EncodingsAndMasks,
             input_tokens: torch.Tensor, noise_time: torch.Tensor,
             cross_kv: Optional[CrossKVCache] = None,
             cond_rows: Optional[int] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return self.decoder(encodings_and_masks, input_tokens, noise_time,
                        cross_kv=cross_kv, cond_rows=cond_rows,
                        generator=generator).to(self.config.dtype)

  def forward(self, encoder_input_tokens, encoder_continuous_inputs,
              encoder_continuous_mask, decoder_input_tokens,
              decoder_noise_time,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The training forward (JAX `__call__`): dropout when `generator` is
    given (JAX's enable_dropout), none without."""
    encodings = self.encode(encoder_input_tokens, encoder_continuous_inputs,
                            encoder_continuous_mask, generator)
    return self.decode(encodings, decoder_input_tokens, decoder_noise_time,
                       generator=generator)
