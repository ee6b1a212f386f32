"""Autoregressive spectrogram transformer (the baseline family) in PyTorch.

Port of music_spectrogram_diffusion_tpu/models/autoregressive/network.py: a
plain T5.1.1 encoder-decoder that predicts continuous mel frames one at a
time. Module and parameter names follow the Flax tree (`layers_<i>` become
`layers.<i>`, see convert.py); the position tables are fixed sinusoids and
no parameters, as in Flax.

Attention routing:
* the encoder's self-attention and the full-length cross-attention (the
  teacher-forced pass and training) go through `MultiHeadAttention`, so
  through the flash-attention kernels (`ops/attention.py`: the forward
  kernel, and the backward kernel when training), on the card;
* the decoder's causal self-attention and every single-frame decode step
  (its self-attention over the cache and its cross-attention over the
  cached encoder K/V) run `layers.dot_product_attention`, plain einsums.
  The JAX package computes all of its AR attention in einsums
  (`use_fused_attention` off); the functions are the same.

The reference's quirk is kept: the encoder's self-attention mask is all
ones, so padding is attended (JAX network.py:204-207); the cross mask is
tokens > 0.

Decoding: `init_cache` projects the encoder memory's cross-attention K/V
once per generation (JAX DecoderLayer :90-110) and allocates each layer's
self-attention cache of the generation's full length; `decode_step(cache,
frame, index)` then runs the step at `index`, a device tensor (JAX's
`cache_index`), so that every step has the same shapes and one CUDA graph
replays them all (`models/autoregressive/model.py`).

Dropout runs at every JAX site when a forward gets a `generator` (rate
`dropout_rate`, broadcast along the length axis where JAX broadcasts it).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from music_spectrogram_diffusion_tpu_torch.models import layers
from music_spectrogram_diffusion_tpu_torch.models.diffusion import network


@dataclasses.dataclass(frozen=True)
class ARConfig:
  """Hyperparameters, as the JAX ARConfig."""
  vocab_size: int
  dtype: torch.dtype = torch.float32
  emb_dim: int = 512
  num_heads: int = 8
  num_encoder_layers: int = 6
  num_decoder_layers: int = 6
  head_dim: int = 64
  mlp_dim: int = 2048
  output_dim: int = 0  # 0: the decoder input's depth
  audio_dim: int = 128  # the decoder input (previous frame) depth
  mlp_activations: Sequence[str] = ("relu",)
  dropout_rate: float = 0.1
  # Per-layer rematerialization in grad mode (training), as the diffusion
  # networks' `remat`.
  remat: bool = False


def _dropout(x, rate, generator, broadcast: bool = True):
  return layers.dropout(x, rate, generator,
                        broadcast_dims=(-2,) if broadcast else ())


def _attention(cfg: ARConfig, cls=layers.MultiHeadAttention):
  return cls(cfg.emb_dim, cfg.num_heads, cfg.head_dim, cfg.emb_dim,
             dtype=cfg.dtype, dropout_rate=cfg.dropout_rate)


def _mlp(cfg: ARConfig):
  return layers.MlpBlock(cfg.emb_dim, cfg.mlp_dim, cfg.mlp_activations,
                         dtype=cfg.dtype, dropout_rate=cfg.dropout_rate)


class EncoderLayer(nn.Module):
  """Pre-norm self-attention (over every position) + MLP block."""

  def __init__(self, cfg: ARConfig):
    super().__init__()
    self.cfg = cfg
    self.pre_attention_norm = layers.RMSNorm(cfg.emb_dim, dtype=cfg.dtype)
    self.attention = _attention(cfg)
    self.pre_mlp_norm = layers.RMSNorm(cfg.emb_dim, dtype=cfg.dtype)
    self.mlp = _mlp(cfg)

  def init_weights(self, generator):
    network._init_children(self, generator)

  def forward(self, inputs: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    rate = self.cfg.dropout_rate
    x = self.pre_attention_norm(inputs)
    x = self.attention(x, x, generator=generator)
    x = _dropout(x, rate, generator) + inputs
    y = self.mlp(self.pre_mlp_norm(x), generator)
    return _dropout(y, rate, generator) + x


class DecoderCache:
  """What a generation keeps between decode steps: per layer the
  self-attention cache and the cached cross-attention (key, value)
  [b, h, l_enc, d], and the cross key mask [b, l_enc]."""

  def __init__(self, self_kv: List[layers.KVCache],
               cross_kv: List[Tuple[torch.Tensor, torch.Tensor]],
               cross_bias: torch.Tensor):
    self.self_kv, self.cross_kv, self.cross_bias = (self_kv, cross_kv,
                                                    cross_bias)


class DecoderLayer(nn.Module):
  """Causal self-attention + cross-attention over the encoder + MLP."""

  def __init__(self, cfg: ARConfig):
    super().__init__()
    self.cfg = cfg
    e, d = cfg.emb_dim, cfg.dtype
    self.pre_self_attention_norm = layers.RMSNorm(e, dtype=d)
    self.self_attention = _attention(cfg, layers.DecodeCacheAttention)
    self.pre_cross_attention_norm = layers.RMSNorm(e, dtype=d)
    self.encoder_decoder_attention = _attention(cfg)
    self.pre_mlp_norm = layers.RMSNorm(e, dtype=d)
    self.mlp = _mlp(cfg)

  def init_weights(self, generator):
    network._init_children(self, generator)

  def _mlp_part(self, y, generator):
    z = self.mlp(self.pre_mlp_norm(y), generator)
    return _dropout(z, self.cfg.dropout_rate, generator) + y

  def forward(self, inputs: torch.Tensor, encoded: torch.Tensor,
              causal_bias: torch.Tensor, cross_mask: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The teacher-forced pass over the whole target."""
    rate = self.cfg.dropout_rate
    x = self.self_attention(self.pre_self_attention_norm(inputs),
                            causal_bias, generator)
    x = _dropout(x, rate, generator) + inputs
    y = self.pre_cross_attention_norm(x)
    y = self.encoder_decoder_attention(y, encoded, kv_mask=cross_mask,
                                       generator=generator)
    y = _dropout(y, rate, generator) + x
    return self._mlp_part(y, generator)

  def step(self, inputs: torch.Tensor, self_kv: layers.KVCache,
           cross_kv: Tuple[torch.Tensor, torch.Tensor],
           cross_bias: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """The decode step at `index` (int64 [1] on the device) on one frame
    [b, 1, emb] (no dropout)."""
    x = self.self_attention.step(self.pre_self_attention_norm(inputs),
                                 self_kv, index) + inputs
    cross = self.encoder_decoder_attention
    y = layers.dot_product_attention(
        cross.query(self.pre_cross_attention_norm(x)), *cross_kv,
        cross_bias, kv_transposed=True)
    return self._mlp_part(cross.out(y) + x, None)


class Encoder(nn.Module):
  def __init__(self, cfg: ARConfig):
    super().__init__()
    self.cfg = cfg
    self.token_embedder = layers.Embed(cfg.vocab_size, cfg.emb_dim,
                                       dtype=cfg.dtype)
    self.position_embedder = layers.FixedEmbed(cfg.emb_dim)
    self.layers = nn.ModuleList(
        EncoderLayer(cfg) for _ in range(cfg.num_encoder_layers))
    self.encoder_norm = layers.RMSNorm(cfg.emb_dim, dtype=cfg.dtype)

  def init_weights(self, generator):
    with torch.no_grad():
      self.token_embedder.embedding.normal_(generator=generator)
    network._init_children(self, generator)

  def forward(self, tokens: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    cfg = self.cfg
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = self.token_embedder(tokens) + self.position_embedder(positions)[None]
    x = _dropout(x, cfg.dropout_rate, generator).to(cfg.dtype)
    for layer in self.layers:
      x = network._run_layer(layer, cfg.remat, generator, x)
    return _dropout(self.encoder_norm(x), cfg.dropout_rate, generator,
                    broadcast=False)


class Decoder(nn.Module):
  def __init__(self, cfg: ARConfig):
    super().__init__()
    self.cfg = cfg
    e = cfg.emb_dim
    self.continuous_inputs_projection = layers.DenseGeneral(
        cfg.audio_dim, e, dtype=cfg.dtype)
    self.position_embedder = layers.FixedEmbed(e)
    self.layers = nn.ModuleList(
        DecoderLayer(cfg) for _ in range(cfg.num_decoder_layers))
    self.decoder_norm = layers.RMSNorm(e, dtype=cfg.dtype)
    # The output projection computes in float32, as in JAX.
    self.spec_out_dense = layers.DenseGeneral(
        e, cfg.output_dim or cfg.audio_dim, dtype=torch.float32)

  def init_weights(self, generator):
    network._init_children(self, generator)

  def _out(self, y, generator):
    y = _dropout(self.decoder_norm(y), self.cfg.dropout_rate, generator)
    return self.spec_out_dense(y)

  def forward(self, encoded: torch.Tensor, decoder_inputs: torch.Tensor,
              cross_mask: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    cfg = self.cfg
    length = decoder_inputs.shape[1]
    positions = torch.arange(length, device=decoder_inputs.device)
    y = (self.continuous_inputs_projection(decoder_inputs)
         + self.position_embedder(positions)[None])
    y = _dropout(y, cfg.dropout_rate, generator).to(cfg.dtype)
    # The target mask is all ones (JAX decode), so the decoder mask is the
    # causal mask.
    causal_bias = layers.mask_to_bias(layers.make_decoder_mask(
        torch.ones(decoder_inputs.shape[:2], device=y.device), torch.float32))
    for layer in self.layers:
      y = network._run_layer(layer, cfg.remat, generator, y, encoded,
                             causal_bias, cross_mask)
    return self._out(y, generator)

  def step(self, cache: DecoderCache, frame: torch.Tensor,
           index: torch.Tensor) -> torch.Tensor:
    y = (self.continuous_inputs_projection(frame)
         + self.position_embedder.step(index)).to(self.cfg.dtype)
    for layer, self_kv, cross_kv in zip(self.layers, cache.self_kv,
                                        cache.cross_kv):
      y = layer.step(y, self_kv, cross_kv, cache.cross_bias, index)
    return self._out(y, None)


class ARTransformer(nn.Module):
  """Encoder-decoder transformer for autoregressive mel generation."""

  def __init__(self, cfg: ARConfig):
    super().__init__()
    self.config = cfg
    self.encoder = Encoder(cfg)
    self.decoder = Decoder(cfg)

  def init_weights(self, generator: torch.Generator) -> "ARTransformer":
    """Random weights drawn as Flax draws them (its initializers and
    scales, not its random numbers)."""
    network._init_children(self, generator)
    return self

  def encode(self, encoder_input_tokens: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    # All-ones self-attention mask (padding attended), as the reference.
    return self.encoder(encoder_input_tokens, generator)

  def decode(self, encoded: torch.Tensor, encoder_input_tokens: torch.Tensor,
             decoder_input_tokens: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The teacher-forced pass: frame t sees decoder inputs 0..t."""
    out = self.decoder(encoded, decoder_input_tokens,
                       encoder_input_tokens > 0, generator)
    return out.to(self.config.dtype)

  def forward(self, encoder_input_tokens: torch.Tensor,
              decoder_input_tokens: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    encoded = self.encode(encoder_input_tokens, generator)
    return self.decode(encoded, encoder_input_tokens, decoder_input_tokens,
                       generator)

  def init_cache(self, encoded: torch.Tensor,
                 encoder_input_tokens: torch.Tensor,
                 length: int) -> DecoderCache:
    """The decode cache of a generation of `length` frames: the cross K/V
    projected once, empty self-attention caches."""
    cfg = self.config
    batch = encoded.shape[0]
    cross_kv = [layer.encoder_decoder_attention.project_kv(encoded)
                for layer in self.decoder.layers]
    dtype = cross_kv[0][0].dtype
    self_kv = [layers.KVCache(batch, cfg.num_heads, length, cfg.head_dim,
                              dtype=dtype, device=encoded.device)
               for _ in self.decoder.layers]
    cross_bias = layers.mask_to_bias(
        (encoder_input_tokens > 0)[:, None, None, :])
    return DecoderCache(self_kv, cross_kv, cross_bias)

  def decode_step(self, cache: DecoderCache, frame: torch.Tensor,
                  index: torch.Tensor) -> torch.Tensor:
    """Output [b, 1, n_out] of the decode step at `index` (int64 [1] on the
    device, so that every step has the same shapes) on the previous frame
    [b, 1, audio_dim]; writes the step's keys and values into `cache`."""
    return self.decoder.step(cache, frame, index).to(self.config.dtype)
