"""MT3 transcription model (audio -> note events) in PyTorch.

Port of music_spectrogram_diffusion_tpu/infer/mt3.py. MT3 (Gardner et al.
2022) is a T5.1.1 encoder-decoder: the encoder reads log-mel spectrogram
frames (a dense projection and fixed sinusoidal positions), the decoder
emits event tokens of the token language of midi/event_codec.py and
midi/sequences.py. It is built on the port's autoregressive layers, as the
JAX package builds it on its own: `EncoderLayer` (with the frames key
mask), `DecoderLayer` and `DecoderLayer.step`, `layers.KVCache`.

Attention routing: the encoder's self-attention and the teacher-forced
cross-attention go through `MultiHeadAttention`, so through the flash
attention kernels on the card (the forward kernel, and the backward
kernel when the transcriber trains). The decoder's causal self-attention
and every decode step's attention are plain einsums, as the
autoregressive decode's. The kernel takes a key mask only, where JAX
masks queries and keys (`make_attention_mask(mask, mask)`): the encoder's
padded frames (the tail of a clip's last segment) differ from JAX's, and
the decoder's cross-attention masks them out, so logits and tokens do not.

Decoding: JAX runs `max_tokens` steps as one `lax.scan` over the flax
cache, with no early exit. Here one step reads its token and its index
from device buffers and writes the next ones there, so that on a CUDA
device it is captured once as a CUDA graph (`ops/graphs.py`) and replayed
for every token; `graphs=False` runs the same step eagerly. A captured
decode keeps its static buffers (the KV caches) and its graph for as long
as the module lives, one set per (kind, batch, frames, max_tokens), so
`MT3Transcriber` decodes a song's segments in batches of a fixed
`DECODE_BATCH`, the last one padded: one set serves songs of every length
(JAX decodes a song's segments as one batch; each segment's tokens are
the same either way). Greedy takes
the first maximum (as `jnp.argmax`); beam search (t5x semantics) takes its
top-k by a stable descending sort, which puts the lower index first among
equal scores, as `jax.lax.top_k` does, and reorders the self-attention KV
caches along the beam axis with `index_select` + `copy_` into the static
buffers (JAX `_gather_beams`; the cross-attention K/V are equal across the
beams of a row, so their reorder is the identity and is skipped). The EOS
zeroing runs once, after the loop.

Spectrogram frontend (mt3/spectrograms.py defaults): 16 kHz, hop 128
(125 frames/s), FFT 2048, 512 HTK mel bins from 20 Hz, log(mel + eps);
segments of 256 frames (2.048 s); up to 1024 tokens per segment.

Weights: `load_mt3_checkpoint` reads a T5X checkpoint exported to `.npz`
by tools/export_jax_checkpoint.py and renames it (`remap_mt3_params`);
`load_trained_transcriber` reads a checkpoint of cli/train_transcriber.py
(the port's) or a JAX transcriber exported to `.npz`.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import re
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from music_spectrogram_diffusion_tpu_torch import convert
from music_spectrogram_diffusion_tpu_torch.midi import (run_length, sequences,
                                                        vocabularies)
from music_spectrogram_diffusion_tpu_torch.models import layers
from music_spectrogram_diffusion_tpu_torch.models.autoregressive import (
    network as ar_net)
from music_spectrogram_diffusion_tpu_torch.models.diffusion import network
from music_spectrogram_diffusion_tpu_torch.ops import graphs as graphs_lib
from music_spectrogram_diffusion_tpu_torch.ops import stft as stft_ops

# mt3/spectrograms.py defaults.
SAMPLE_RATE = 16000
HOP_WIDTH = 128
NUM_MEL_BINS = 512
FFT_SIZE = 2048
MEL_LO_HZ = 20.0
SPEC_LOG_EPS = 1e-6
FRAMES_PER_SECOND = SAMPLE_RATE // HOP_WIDTH  # 125

INPUT_FRAMES = 256  # 2.048 s segments (mt3 gin inputs length)
MAX_OUTPUT_TOKENS = 1024
# Segments `MT3Transcriber` decodes at once. At the published geometry a
# segment's decode buffers take 31 MB a beam (the 1024-long self-attention
# caches of 8 layers, and the cross K/V).
DECODE_BATCH = 16
NEG_INF = -1e7  # the beam pools' empty score (JAX's)


@functools.lru_cache(maxsize=1)
def _mel_matrix() -> np.ndarray:
  return stft_ops.linear_to_mel_matrix(
      num_mel_bins=NUM_MEL_BINS, num_spectrogram_bins=FFT_SIZE // 2 + 1,
      sample_rate=SAMPLE_RATE, lower_edge_hertz=MEL_LO_HZ,
      upper_edge_hertz=SAMPLE_RATE / 2.0)


def spectrogram(audio: np.ndarray) -> np.ndarray:
  """[n_samples] -> [ceil(n/hop), 512] log-mel (mt3 frontend), numpy on
  the host (pad_end framing, periodic Hann)."""
  audio = np.asarray(audio, np.float32)
  n = len(audio)
  n_frames = -(-n // HOP_WIDTH)  # ceil (pad_end=True framing)
  pad = max(0, (n_frames - 1) * HOP_WIDTH + FFT_SIZE - n)
  audio = np.pad(audio, (0, pad))
  idx = (np.arange(FFT_SIZE)[None, :]
         + HOP_WIDTH * np.arange(n_frames)[:, None])
  frames = audio[idx] * stft_ops.hann_window(FFT_SIZE)
  mag = np.abs(np.fft.rfft(frames, n=FFT_SIZE, axis=-1))
  return np.log(mag @ _mel_matrix() + SPEC_LOG_EPS).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class MT3Config:
  """T5.1.1-small geometry (the published MT3 checkpoint's size)."""
  vocab_size: int
  dtype: torch.dtype = torch.float32
  emb_dim: int = 512
  num_heads: int = 6
  num_encoder_layers: int = 8
  num_decoder_layers: int = 8
  head_dim: int = 64
  mlp_dim: int = 1024
  mlp_activations: Sequence[str] = ("gelu", "linear")
  dropout_rate: float = 0.0
  input_depth: int = NUM_MEL_BINS

  def ar_config(self) -> ar_net.ARConfig:
    return ar_net.ARConfig(
        vocab_size=self.vocab_size, dtype=self.dtype, emb_dim=self.emb_dim,
        num_heads=self.num_heads, head_dim=self.head_dim,
        mlp_dim=self.mlp_dim, mlp_activations=self.mlp_activations,
        dropout_rate=self.dropout_rate,
        num_encoder_layers=self.num_encoder_layers,
        num_decoder_layers=self.num_decoder_layers)


class MT3Encoder(nn.Module):
  """Spectrogram-frame encoder."""

  def __init__(self, cfg: MT3Config):
    super().__init__()
    self.cfg = cfg
    self.input_proj = layers.DenseGeneral(cfg.input_depth, cfg.emb_dim,
                                          dtype=cfg.dtype)
    self.position_embedder = layers.FixedEmbed(cfg.emb_dim)
    self.layers = nn.ModuleList(ar_net.EncoderLayer(cfg.ar_config())
                                for _ in range(cfg.num_encoder_layers))
    self.encoder_norm = layers.RMSNorm(cfg.emb_dim, dtype=cfg.dtype)

  def init_weights(self, generator):
    network._init_children(self, generator)

  def forward(self, spec_frames: torch.Tensor,
              mask: Optional[torch.Tensor]) -> torch.Tensor:
    """spec_frames [b, l, depth], mask bool [b, l] (None: all valid)."""
    positions = torch.arange(spec_frames.shape[1], device=spec_frames.device)
    x = (self.input_proj(spec_frames)
         + self.position_embedder(positions)[None]).to(self.cfg.dtype)
    for layer in self.layers:
      x = layer(x, None, mask)
    return self.encoder_norm(x)


class MT3Decoder(nn.Module):
  """Token decoder with a decode cache; separate logits head (T5.1.1)."""

  def __init__(self, cfg: MT3Config):
    super().__init__()
    self.cfg = cfg
    e = cfg.emb_dim
    self.token_embedder = layers.Embed(cfg.vocab_size, e, dtype=cfg.dtype)
    self.position_embedder = layers.FixedEmbed(e)
    self.layers = nn.ModuleList(ar_net.DecoderLayer(cfg.ar_config())
                                for _ in range(cfg.num_decoder_layers))
    self.decoder_norm = layers.RMSNorm(e, dtype=cfg.dtype)
    self.logits_dense = layers.DenseGeneral(e, cfg.vocab_size,
                                            dtype=torch.float32)

  def init_weights(self, generator):
    with torch.no_grad():
      self.token_embedder.embedding.normal_(generator=generator)
    network._init_children(self, generator)

  def forward(self, encoded: torch.Tensor, tokens: torch.Tensor,
              self_bias: torch.Tensor,
              cross_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The teacher-forced pass: logits [b, l, vocab] float32."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    y = (self.token_embedder(tokens)
         + self.position_embedder(positions)[None]).to(self.cfg.dtype)
    for layer in self.layers:
      y = layer(y, encoded, self_bias, cross_mask)
    return self.logits_dense(self.decoder_norm(y))

  def step(self, cache: ar_net.DecoderCache, token: torch.Tensor,
           index: torch.Tensor) -> torch.Tensor:
    """The decode step at `index` (int64 [1] on the device) on tokens
    [b, 1]: logits [b, 1, vocab] float32."""
    y = (self.token_embedder(token)
         + self.position_embedder.step(index)).to(self.cfg.dtype)
    for layer, self_kv, cross_kv in zip(self.layers, cache.self_kv,
                                        cache.cross_kv):
      y = layer.step(y, self_kv, cross_kv, cache.cross_bias, index)
    return self.logits_dense(self.decoder_norm(y))


class MT3Transformer(nn.Module):
  """The encoder-decoder. `step_graphs` (made on first use on a CUDA
  device) holds the captured decode steps, `_slots` the static buffers
  they read, one per (kind, batch, frames, max_tokens)."""

  def __init__(self, cfg: MT3Config):
    super().__init__()
    self.config = cfg
    self.encoder = MT3Encoder(cfg)
    self.decoder = MT3Decoder(cfg)
    self.step_graphs = None
    self._slots: Dict[tuple, Dict[str, Any]] = {}

  @property
  def device(self) -> torch.device:
    return self.decoder.logits_dense.kernel.device

  def init_weights(self, generator: torch.Generator) -> "MT3Transformer":
    """Random weights drawn as Flax draws them (its initializers and
    scales, not its random numbers)."""
    network._init_children(self, generator)
    return self

  def encode(self, spec_frames: torch.Tensor,
             frames_mask: Optional[torch.Tensor]) -> torch.Tensor:
    return self.encoder(spec_frames, frames_mask)

  def forward(self, spec_frames: torch.Tensor,
              frames_mask: Optional[torch.Tensor],
              decoder_input_tokens: torch.Tensor,
              decoder_target_tokens: torch.Tensor) -> torch.Tensor:
    """Teacher-forced logits (training, parity checks). frames_mask None:
    every frame valid (the training batches' all-ones mask)."""
    encoded = self.encode(spec_frames, frames_mask)
    self_bias = layers.mask_to_bias(layers.make_decoder_mask(
        (decoder_target_tokens > 0).float(), torch.float32))
    return self.decoder(encoded, decoder_input_tokens, self_bias,
                        frames_mask)

  def init_cache(self, encoded: torch.Tensor, frames_mask: torch.Tensor,
                 length: int) -> ar_net.DecoderCache:
    """A generation's cache: the cross K/V projected once (JAX's
    cache-init pass), empty self-attention caches of `length`."""
    cfg = self.config
    cross_kv = [layer.encoder_decoder_attention.project_kv(encoded)
                for layer in self.decoder.layers]
    self_kv = [layers.KVCache(encoded.shape[0], cfg.num_heads, length,
                              cfg.head_dim, dtype=cross_kv[0][0].dtype,
                              device=encoded.device)
               for _ in self.decoder.layers]
    cross_bias = layers.mask_to_bias(frames_mask[:, None, None, :])
    return ar_net.DecoderCache(self_kv, cross_kv, cross_bias)


def _after_eos_zeroed(tokens: torch.Tensor, eos_id: int) -> torch.Tensor:
  """Zero everything after the first EOS (the EOS itself kept)."""
  is_eos = (tokens == eos_id).to(torch.int64)
  keep = (torch.cumsum(is_eos, dim=1) - is_eos) == 0
  return torch.where(keep, tokens, torch.zeros_like(tokens))


def _run_steps(module: MT3Transformer, key: tuple, step, count: int,
               graphs: Optional[bool]) -> None:
  """`count` runs of `step`: captured once and replayed on a CUDA device
  (unless graphs is False), eager elsewhere."""
  captured = graphs_lib.use_graphs(module.device, graphs)
  step_graphs = graphs_lib.model_step_graphs(module)
  with graphs_lib.on_stream(step_graphs):
    for _ in range(count):
      if captured:
        step_graphs.run(key, step)
      else:
        step()


def _slot(module: MT3Transformer, key: tuple, fresh: Dict[str, Any],
          graphs: Optional[bool]) -> Dict[str, Any]:
  """The decode's buffers: `fresh` itself when eager; when captured, the
  key's static buffers (made from `fresh` on first use, refilled from it
  on every later one), which the key's step graph reads. Every tensor a
  step reads, other than the module's weights, must be one of them."""
  if not graphs_lib.use_graphs(module.device, graphs):
    return fresh
  slot = module._slots.get(key)
  if slot is None:
    module._slots[key] = fresh
    return fresh
  for name, value in fresh.items():
    if name == "cache":
      graphs_lib.copy_tree_(slot["cache"].buffers(), value.buffers())
    else:
      slot[name].copy_(value)
  return slot


@torch.inference_mode()
def greedy_decode(module: MT3Transformer, spec_frames: torch.Tensor,
                  frames_mask: torch.Tensor,
                  max_tokens: int = MAX_OUTPUT_TOKENS, eos_id: int = 1,
                  graphs: Optional[bool] = None) -> torch.Tensor:
  """Greedy decoding of `max_tokens` steps (no early exit, as JAX's
  scan): tokens [batch, max_tokens] int64, zeroed after the first EOS."""
  batch = spec_frames.shape[0]
  device = spec_frames.device
  encoded = module.encode(spec_frames, frames_mask)
  key = ("greedy", batch, spec_frames.shape[1], max_tokens)
  s = _slot(module, key, {
      "cache": module.init_cache(encoded, frames_mask, max_tokens),
      "token": torch.zeros(batch, 1, dtype=torch.int64, device=device),
      "index": torch.zeros(1, dtype=torch.int64, device=device),
      "tokens": torch.zeros(batch, max_tokens, dtype=torch.int64,
                            device=device)}, graphs)

  def step():
    logits = module.decoder.step(s["cache"], s["token"], s["index"])
    next_token = torch.argmax(logits[:, 0], dim=-1)[:, None]
    s["tokens"].index_copy_(1, s["index"], next_token)
    s["token"].copy_(next_token)
    s["index"].add_(1)

  _run_steps(module, key, step, max_tokens, graphs)
  return _after_eos_zeroed(s["tokens"].clone(), eos_id)


def stable_top_k(x: torch.Tensor, k: int):
  """(values, indices) of the k largest along the last axis, the lower
  index first among equal values (as jax.lax.top_k)."""
  values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
  return values[..., :k], indices[..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
  """take_along_axis on axis 1 with idx [b, n] over x [b, m, ...], as one
  index_select of whole rows (a gather with an index expanded over the
  trailing axes takes a vectorized CUDA path that asserts on it)."""
  b, m = x.shape[:2]
  rows = (torch.arange(b, device=x.device)[:, None] * m + idx).reshape(-1)
  return x.reshape(b * m, *x.shape[2:]).index_select(0, rows).reshape(
      *idx.shape, *x.shape[2:])


def _brevity_penalty(length: torch.Tensor, alpha: float) -> torch.Tensor:
  """t5x/decoding.py brevity penalty: ((5 + len) / 6) ** alpha."""
  return torch.pow((5.0 + length) / 6.0, alpha)


@torch.inference_mode()
def beam_decode(module: MT3Transformer, spec_frames: torch.Tensor,
                frames_mask: torch.Tensor,
                max_tokens: int = MAX_OUTPUT_TOKENS, beam_size: int = 4,
                alpha: float = 0.6, eos_id: int = 1,
                graphs: Optional[bool] = None) -> torch.Tensor:
  """Beam search with t5x semantics (decoding.py beam_search), as the JAX
  package's: an alive pool of `beam_size` prefixes and a finished pool
  scored with the ((5+len)/6)**alpha brevity penalty; 2*beam_size
  candidates per step; the self-attention KV caches reordered along the
  beam axis each step; `max_tokens` steps, no early exit.

  Returns [batch, max_tokens] tokens of the best finished beam (best
  alive beam when nothing finished), zeroed after the first EOS.
  """
  batch, frames = spec_frames.shape[:2]
  k = beam_size
  device = spec_frames.device
  encoded = module.encode(spec_frames, frames_mask)
  # Beam-flatten: each batch row repeated k times ([b0 b0.. b1 b1..]).
  encoded = torch.repeat_interleave(encoded, k, dim=0)
  mask_flat = torch.repeat_interleave(frames_mask, k, dim=0)
  live0 = torch.full((batch, k), NEG_INF, dtype=torch.float32,
                     device=device)
  live0[:, 0] = 0.0  # only beam 0 starts alive
  key = ("beam", batch, frames, max_tokens, k, alpha)
  s = _slot(module, key, {
      "cache": module.init_cache(encoded, mask_flat, max_tokens),
      "cur_token": torch.zeros(batch, k, dtype=torch.int64, device=device),
      "live_logprobs": live0,
      "live_seqs": torch.zeros(batch, k, max_tokens, dtype=torch.int64,
                               device=device),
      "fin_scores": torch.full((batch, k), NEG_INF, dtype=torch.float32,
                               device=device),
      "fin_seqs": torch.zeros(batch, k, max_tokens, dtype=torch.int64,
                              device=device),
      "index": torch.zeros(1, dtype=torch.int64, device=device),
      # Constants the step reads: in the slot too, since a captured graph
      # reads them at the addresses it was captured with.
      "positions": torch.arange(max_tokens, device=device),
      "beam_base": (torch.arange(batch, device=device) * k)[:, None]},
      graphs)
  positions, beam_base = s["positions"], s["beam_base"]

  def step():
    index = s["index"]
    logits = module.decoder.step(s["cache"], s["cur_token"].reshape(-1, 1),
                                 index)
    logprobs = F.log_softmax(logits[:, 0].float(), dim=-1).reshape(
        batch, k, -1)
    vocab = logprobs.shape[-1]
    total = s["live_logprobs"][:, :, None] + logprobs        # [b, k, V]
    top_scores, top_idx = stable_top_k(total.reshape(batch, k * vocab),
                                       2 * k)               # [b, 2k]
    parent = torch.div(top_idx, vocab, rounding_mode="floor")
    token = top_idx % vocab
    is_eos = token == eos_id

    # Candidate sequences: parent's prefix + the new token at slot index.
    cand_seqs = torch.where(positions == index, token[:, :, None],
                            _take(s["live_seqs"], parent))  # [b, 2k, L]

    # Finished pool: EOS candidates, brevity-normalized, merged with
    # the existing pool; keep the top k.
    cand_fin = torch.where(
        is_eos, top_scores / _brevity_penalty(index + 1.0, alpha),
        torch.full_like(top_scores, NEG_INF))
    fin_scores, fin_top = stable_top_k(
        torch.cat([s["fin_scores"], cand_fin], dim=1), k)
    fin_seqs = _take(torch.cat([s["fin_seqs"], cand_seqs], dim=1), fin_top)

    # Alive pool: best k non-EOS candidates.
    cand_live = torch.where(is_eos, torch.full_like(top_scores, NEG_INF),
                            top_scores)
    live_logprobs, live_top = stable_top_k(cand_live, k)
    live_parent = torch.gather(parent, 1, live_top)
    rows = (beam_base + live_parent).reshape(-1)
    for kv in s["cache"].self_kv:
      kv.key.copy_(kv.key.index_select(0, rows))
      kv.value.copy_(kv.value.index_select(0, rows))
    s["cur_token"].copy_(torch.gather(token, 1, live_top))
    s["live_seqs"].copy_(_take(cand_seqs, live_top))
    s["live_logprobs"].copy_(live_logprobs)
    s["fin_scores"].copy_(fin_scores)
    s["fin_seqs"].copy_(fin_seqs)
    index.add_(1)

  _run_steps(module, key, step, max_tokens, graphs)
  # Prefer finished beams; fall back to the best alive prefix when no
  # hypothesis emitted EOS (t5x decoding.py does the same).
  none_finished = s["fin_scores"][:, 0] <= NEG_INF
  best = torch.where(none_finished[:, None], s["live_seqs"][:, 0],
                     s["fin_seqs"][:, 0])
  return _after_eos_zeroed(best.clone(), eos_id)


def build_module(config: MT3Config, *,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 seed: int = 0, device="cuda") -> MT3Transformer:
  """An MT3Transformer on `device` for inference: `state_dict`'s weights,
  else random ones from `seed` (drawn on the CPU in float32)."""
  from music_spectrogram_diffusion_tpu_torch.infer import inference
  dev = inference.resolve_device(device)
  module = MT3Transformer(config)
  if state_dict is None:
    module.init_weights(torch.Generator().manual_seed(seed))
  else:
    module.load_state_dict(dict(state_dict), strict=True)
  return module.to(dev).eval().requires_grad_(False)


class MT3Transcriber:
  """audio [n_samples] @16 kHz -> NoteSequence.

  Splits audio into 256-frame segments, decodes their event tokens on
  `device` (beam search or greedy) in batches of `DECODE_BATCH` segments,
  then decodes tokens to notes with the shared state machine (reference
  transcription_inference.py:157-233 structure).
  """

  def __init__(self, params: Optional[Mapping[str, Any]] = None,
               vocab_config: Optional[
                   vocabularies.VocabularyConfig] = None,
               max_tokens: int = MAX_OUTPUT_TOKENS,
               decode_mode: str = "beam",
               beam_size: int = 4,
               alpha: float = 0.6,
               config: Optional[MT3Config] = None,
               *,
               state_dict: Optional[Mapping[str, torch.Tensor]] = None,
               device="cuda"):
    """params: a Flax params tree in this module's names (as
    `load_mt3_checkpoint` returns it); or `state_dict`, the port module's
    (one of the two). decode_mode: 'beam' (t5x beam search, the
    reference's decode) or 'greedy' (cheaper). `config` overrides the
    default T5.1.1-small geometry (e.g. the compact transcriber of
    cli/train_transcriber.py). On a CUDA device the decodes replay
    captured steps."""
    if decode_mode not in ("beam", "greedy"):
      raise ValueError(f"unknown decode_mode {decode_mode!r}")
    if (params is None) == (state_dict is None):
      raise ValueError("pass params or state_dict (one of them)")
    self.vocab_config = vocab_config or vocabularies.VocabularyConfig(
        num_velocity_bins=1)
    self.codec = vocabularies.build_codec(self.vocab_config)
    self.vocabulary = vocabularies.vocabulary_from_codec(self.codec)
    vocab_size = vocabularies.num_embeddings(self.vocabulary)
    config = config or MT3Config(vocab_size=vocab_size)
    if params is not None:
      state_dict = convert.flax_to_state_dict(params, MT3Transformer(config))
    self.module = build_module(config, state_dict=state_dict, device=device)
    self.max_tokens = max_tokens
    self.decode_mode, self.beam_size, self.alpha = (decode_mode, beam_size,
                                                    alpha)

  @property
  def device(self) -> torch.device:
    return self.module.device

  def decode(self, segs: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Segments [n, 256, 512] and their frame mask -> tokens [n,
    max_tokens] (numpy). Decoded `DECODE_BATCH` segments at a time, the
    last batch padded with segments that have no valid frame, so that
    every call reuses one captured step and its buffers."""
    n = len(segs)
    pad = -n % DECODE_BATCH
    segs = np.pad(segs, ((0, pad), (0, 0), (0, 0)))
    mask = np.pad(mask, ((0, pad), (0, 0)))
    out = []
    for i in range(0, n + pad, DECODE_BATCH):
      spec = torch.as_tensor(segs[i:i + DECODE_BATCH], device=self.device)
      frames = torch.as_tensor(mask[i:i + DECODE_BATCH], device=self.device)
      if self.decode_mode == "beam":
        tokens = beam_decode(self.module, spec, frames, self.max_tokens,
                             beam_size=self.beam_size, alpha=self.alpha)
      else:
        tokens = greedy_decode(self.module, spec, frames, self.max_tokens)
      out.append(tokens.cpu().numpy())
    return np.concatenate(out)[:n]

  def __call__(self, audio: np.ndarray) -> sequences.NoteSequence:
    spec = spectrogram(audio)
    n_frames = len(spec)
    n_segments = max(1, -(-n_frames // INPUT_FRAMES))
    pad = n_segments * INPUT_FRAMES - n_frames
    spec = np.pad(spec, ((0, pad), (0, 0)))
    segs = spec.reshape(n_segments, INPUT_FRAMES, NUM_MEL_BINS)
    mask = (np.arange(n_segments * INPUT_FRAMES).reshape(
        n_segments, INPUT_FRAMES) < n_frames)
    tokens = self.decode(segs, mask)

    # Decode each segment's tokens at its absolute start time through
    # the shared note state machine (it spans segment boundaries). MT3
    # emits NoteEncodingWithTiesSpec streams: every segment OPENS with a
    # tie section re-declaring the still-active notes, so the decoder
    # must enter tie-section mode per segment (begin_decoding_segment_fn)
    # or held notes get split/mistaken for fresh onsets at each 2.048 s
    # boundary.
    spec_fns = sequences.NoteEncodingWithTiesSpec
    state = spec_fns.init_decoding_state_fn()
    for i in range(n_segments):
      start_time = i * INPUT_FRAMES / FRAMES_PER_SECOND
      codec_ids = self.vocabulary.decode(tokens[i])
      codec_ids = codec_ids[codec_ids >= 0]  # drop EOS/invalid/pad
      spec_fns.begin_decoding_segment_fn(state)
      run_length.decode_events(
          state=state,
          tokens=np.asarray(codec_ids, np.int32),
          start_time=start_time,
          max_time=None,
          codec=self.codec,
          decode_event_fn=spec_fns.decode_event_fn)
    return spec_fns.flush_decoding_state_fn(state)


# Reference t5x/mt3 module names -> this module tree (the JAX package's
# _MT3_RENAMES). The mt3 network is the standard t5x T5 with a
# continuous-input encoder; its param names follow t5x network.py.
_MT3_RENAMES = [
    (r"pre_self_attention_layer_norm", "pre_self_attention_norm"),
    (r"pre_cross_attention_layer_norm", "pre_cross_attention_norm"),
    (r"pre_attention_layer_norm", "pre_attention_norm"),
    (r"pre_mlp_layer_norm", "pre_mlp_norm"),
    (r"continuous_inputs_projection", "input_proj"),
    # t5x keeps the shared embedder at the checkpoint top level
    # (network.py shared_embedding -> 'token_embedder'); only the
    # decoder uses it here (the encoder input is continuous).
    (r"^token_embedder/", "decoder/token_embedder/"),
]


def remap_mt3_params(params: Mapping[str, Any]) -> Dict[str, Any]:
  """t5x/mt3 checkpoint param tree -> MT3Transformer's Flax-named tree:
  the port's T5X renaming (`convert.t5x_rename`, which
  `load_t5x_checkpoint` applies in the JAX package) and then MT3's."""
  def rename(k: str) -> str:
    k = convert.t5x_rename(k)
    for pat, rep in _MT3_RENAMES:
      k = re.sub(pat, rep, k)
    return k
  return convert.unflatten({rename(k): v
                            for k, v in convert.flatten(params).items()})


def load_mt3_checkpoint(path: str) -> Dict[str, Any]:
  """The published MT3 T5X checkpoint, exported to `.npz` by
  tools/export_jax_checkpoint.py, remapped into MT3Transformer's names
  (a Flax-named tree of numpy arrays, for `MT3Transcriber(params)`)."""
  params, _, _ = convert.read_export(path)
  return remap_mt3_params(params)


def _transcriber_config(cfg: Mapping[str, Any]):
  """(vocab config, MT3Config) of a transcriber's config.json sidecar."""
  if cfg.get("kind") != "mt3_transcriber":
    raise ValueError(f"not a transcriber checkpoint "
                     f"(kind={cfg.get('kind')!r})")
  vocab_config = vocabularies.VocabularyConfig(**cfg["vocab"])
  vocabulary = vocabularies.vocabulary_from_codec(
      vocabularies.build_codec(vocab_config))
  return vocab_config, MT3Config(
      vocab_size=vocabularies.num_embeddings(vocabulary), **cfg["arch"])


def load_trained_transcriber(model_dir: str,
                             decode_mode: str = "greedy",
                             beam_size: int = 4,
                             max_tokens: Optional[int] = None,
                             device="cuda") -> MT3Transcriber:
  """Load a transcriber trained by cli/train_transcriber.py.

  `model_dir` is a step_<N> dir or a training model_dir (latest step) of
  the port's CLI, or a JAX transcriber checkpoint exported to `.npz` by
  tools/export_jax_checkpoint.py; the config.json sidecar (kind
  'mt3_transcriber') carries the compact architecture and vocab. A
  checkpoint of another kind raises ValueError.
  """
  from music_spectrogram_diffusion_tpu_torch.train import checkpoints
  if not os.path.isdir(model_dir):
    params, config_json, _ = convert.read_export(model_dir)
    cfg = json.loads(config_json) if config_json else {}
    vocab_config, config = _transcriber_config(cfg)
    state_dict = convert.flax_to_state_dict(params, MT3Transformer(config))
  else:
    path = model_dir
    if not os.path.basename(os.path.normpath(path)).startswith("step_"):
      path = checkpoints.latest_checkpoint(model_dir)
      if path is None:
        raise FileNotFoundError(f"no step_<N> checkpoint under {model_dir}")
    restored = checkpoints.restore_checkpoint(path)
    cfg = json.loads(restored.get("config_json", "{}"))
    vocab_config, config = _transcriber_config(cfg)
    state_dict = restored["params"]
  return MT3Transcriber(
      vocab_config=vocab_config,
      max_tokens=max_tokens or cfg.get("max_tokens", MAX_OUTPUT_TOKENS),
      decode_mode=decode_mode, beam_size=beam_size, config=config,
      state_dict=state_dict, device=device)


def register(checkpoint_path: Optional[str] = None,
             params: Optional[Mapping[str, Any]] = None,
             device="cuda") -> bool:
  """Install MT3 as the transcription plug-in (infer/transcription.py).

  Pass an exported T5X checkpoint path or an already-loaded param tree.
  Returns True when registered.
  """
  from music_spectrogram_diffusion_tpu_torch.infer import transcription
  if params is None:
    if not checkpoint_path:
      return False
    params = load_mt3_checkpoint(checkpoint_path)
  transcription.register_transcriber(MT3Transcriber(params, device=device))
  return True
