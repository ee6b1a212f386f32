"""Full-song synthesis by segment chaining, in PyTorch.

Port of `Synthesizer` from music_spectrogram_diffusion_tpu/infer/
synthesize.py: per segment the model runs with the previous segment's
prediction as its context (the first segment's context is masked out),
songs are batched so the sequential dependency is only along segments, and
the concatenated spectrogram is vocoded at the end (`render_songs`); or
one song is streamed, each segment vocoded as soon as it is denoised
(`stream_song`). The notes-only diffusion model and the autoregressive
model take no context: their segments render independently.
"""

from __future__ import annotations

import dataclasses
import time
from typing import (Callable, Dict, Iterator, List, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from music_spectrogram_diffusion_tpu_torch.ops import diffusion as dops

# (segment index, number of songs) -> the noise of that segment's sampler.
SegmentNoise = Callable[[int, int], dops.NoiseFn]


@dataclasses.dataclass
class SongRender:
  """Result of rendering one song."""
  mel: np.ndarray  # [frames, n_dims] in codec feature space
  audio: Optional[np.ndarray]  # [samples] if a vocoder was attached
  timings: Dict[str, float]


def seeded_noise(seed: int, device) -> SegmentNoise:
  """One generator per (song, segment), seeded from (seed, song, segment),
  so a song renders the same whether batched with others or alone."""
  def for_segment(segment: int, n_songs: int) -> dops.NoiseFn:
    gens = []
    for song in range(n_songs):
      state = np.random.SeedSequence((seed, song, segment)).generate_state(1)
      gens.append(torch.Generator(device).manual_seed(int(state[0])))
    return dops.generator_noise(gens, device)
  return for_segment


def _sync(device: torch.device):
  if device.type == "cuda":
    torch.cuda.synchronize(device)


def _capture_seconds(model) -> float:
  """The seconds the model has spent capturing step graphs so far."""
  graphs = model.step_graphs
  return 0.0 if graphs is None else graphs.capture_seconds


class Synthesizer:
  """Segment-by-segment renderer for every model family (context chained
  for the context diffusion model)."""

  # Smallest bucket that fits the longest segment: padding is masked out
  # of every attention, so a shorter bucket gives the same result faster.
  INPUT_BUCKETS = (256, 512, 1024, 2048)

  def __init__(self, model, task_feature_lengths: Mapping[str, int],
               vocoder=None, bucket_inputs: bool = True):
    """Args:
      model: a diffusion or autoregressive model (anything with their
        .predict, .device, .audio_codec, .step_graphs and USES_CONTEXT).
      task_feature_lengths: {'inputs', 'targets'} and, for the context
        model, 'targets_context'.
      vocoder: optional callable [B, T, D] mel -> [B, T*hop] audio.
      bucket_inputs: pad the tokens to the smallest of INPUT_BUCKETS that
        fits the longest segment (False: always to the task's inputs).
    """
    self.model = model
    self.lengths = dict(task_feature_lengths)
    l_ctx = self.lengths.get("targets_context")
    if l_ctx is not None and l_ctx > self.lengths["targets"]:
      raise ValueError(
          f"targets_context ({l_ctx}) > targets ({self.lengths['targets']}) "
          "is unsupported: segment chaining uses the previous segment's "
          "prediction as context")
    self.vocoder = vocoder
    self.bucket_inputs = bucket_inputs

  def _input_length(self, max_tokens: int) -> int:
    cap = self.lengths["inputs"]
    if not self.bucket_inputs:
      return cap
    for bucket in self.INPUT_BUCKETS:
      if max_tokens <= bucket <= cap:
        return bucket
    return cap

  @property
  def _uses_context(self) -> bool:
    """Chaining applies to the context model only; the notes-only and
    autoregressive models render each segment on its own."""
    return ("targets_context" in self.lengths
            and getattr(self.model, "USES_CONTEXT", False))

  def _context_length(self) -> int:
    return self.lengths.get("targets_context", self.lengths["targets"])

  def _segment_batch(self, tokens: np.ndarray, context: torch.Tensor,
                     context_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    device = self.model.device
    shape = (tokens.shape[0], self.lengths["targets"],
             self.model.audio_codec.n_dims)
    out = {
        "encoder_input_tokens": torch.as_tensor(tokens, device=device),
        "decoder_target_tokens": torch.zeros(shape, device=device),
    }
    if self._uses_context:
      out["encoder_continuous_inputs"] = context
      out["encoder_continuous_mask"] = context_mask
    else:
      # The autoregressive model's teacher-forcing placeholder.
      out["decoder_input_tokens"] = torch.zeros(shape, device=device)
    return out

  def render_songs(self,
                   songs: Sequence[Sequence[np.ndarray]],
                   noise: Optional[SegmentNoise] = None,
                   vocode: bool = True,
                   always_mask_context: bool = False,
                   graphs: Optional[bool] = None) -> List[SongRender]:
    """Render a batch of songs, chaining context across segments.

    Args:
      songs: per song, its per-segment `encoder_input_tokens` (1-d ints,
        padded/EOS'd to at most the task inputs length).
      noise: the sampler noise per segment; default `seeded_noise(0)`.
      vocode: run the attached vocoder (if any) on the result.
      always_mask_context: keep every segment's context mask at 0 (the
        reference's ablation that renders every segment blind).
      graphs: the model's `predict` option: None replays captured steps on
        a CUDA device (eager on the CPU), False runs them eagerly.

    Timings: the sampler's seconds (`prediction_seconds`, the captures
    included), the steady segment's (the median after the first), the
    seconds spent capturing step graphs (`capture_seconds`, all in the
    segments that first used a shape), the vocoder's and the audio's.
    """
    device = self.model.device
    if noise is None:
      noise = seeded_noise(0, device)
    codec = self.model.audio_codec
    n_songs = len(songs)
    max_segments = max(len(s) for s in songs)
    max_tokens = max((len(seg) for s in songs for seg in s), default=1)
    l_in = self._input_length(max_tokens)
    l_ctx = self._context_length()
    l_tgt = self.lengths["targets"]

    tokens = np.zeros((max_segments, n_songs, l_in), np.int64)
    for si, song in enumerate(songs):
      for gi, seg in enumerate(song):
        seg = np.asarray(seg)[:l_in]
        tokens[gi, si, :len(seg)] = seg

    context = torch.full((n_songs, l_ctx, codec.n_dims), codec.pad_value,
                         dtype=torch.float32, device=device)
    context_mask = torch.zeros((n_songs, l_ctx), dtype=torch.bool,
                               device=device)
    mel_segments, seg_times = [], []
    captures_before = _capture_seconds(self.model)
    for gi in range(max_segments):
      batch = self._segment_batch(tokens[gi], context, context_mask)
      _sync(device)
      t0 = time.perf_counter()
      pred = self.model.predict(batch, noise(gi, n_songs), graphs=graphs)
      _sync(device)
      seg_times.append(time.perf_counter() - t0)
      mel_segments.append(pred)
      context = pred[:, -l_ctx:, :]
      context_mask = torch.full((n_songs, l_ctx), not always_mask_context,
                                dtype=torch.bool, device=device)
    mel = torch.cat(mel_segments, dim=1)
    capture_time = _capture_seconds(self.model) - captures_before

    audio, vocode_time = None, 0.0
    if vocode and self.vocoder is not None:
      t0 = time.perf_counter()
      audio = self.vocoder(mel)
      _sync(audio.device)
      vocode_time = time.perf_counter() - t0
      audio = audio.cpu().numpy()

    # The realtime factor leaves out the first segment, as the reference's
    # timing does; songs render batched, so rates are per batch.
    frame_rate = codec.frame_rate
    steady = seg_times[1:] if len(seg_times) > 1 else seg_times
    seg_audio = l_tgt / frame_rate
    steady_rate = float(np.sum(steady)) / max(
        len(steady) * seg_audio * n_songs, 1e-9)
    mel_np = mel.cpu().numpy()
    results = []
    for si, song in enumerate(songs):
      n_frames = len(song) * l_tgt
      results.append(SongRender(
          mel=mel_np[si, :n_frames],
          audio=(audio[si, :n_frames * codec.hop_size]
                 if audio is not None else None),
          timings={
              "prediction_seconds": float(np.sum(seg_times)),
              "prediction_seconds_per_audio_second": steady_rate,
              "steady_segment_seconds": float(np.median(steady)),
              "capture_seconds": capture_time,
              "audio_decode_seconds": vocode_time,
              "audio_seconds": n_frames / frame_rate,
          }))
    return results

  def render_song(self, segments: Sequence[np.ndarray],
                  noise: Optional[SegmentNoise] = None,
                  vocode: bool = True,
                  graphs: Optional[bool] = None) -> SongRender:
    return self.render_songs([segments], noise=noise, vocode=vocode,
                             graphs=graphs)[0]

  def stream_song(self, segments: Sequence[np.ndarray],
                  noise: Optional[SegmentNoise] = None,
                  vocoder_context_frames: int = 16,
                  graphs: Optional[bool] = None
                  ) -> Iterator[Tuple[int, np.ndarray, Optional[np.ndarray]]]:
    """Low-latency render of one song: yields (segment index, mel
    [l_tgt, n_dims], audio [l_tgt * hop] or None) as each segment is
    denoised.

    The vocoder runs on [the previous `vocoder_context_frames` mel frames |
    the segment] and the context's samples are dropped (the codec's
    warm-up convention). The noise of segment i is `noise(i, 1)`, what
    `render_songs` draws for song 0, so the streamed mel equals the batch
    renderer's exactly. Griffin-Lim's phase is chunk-local, so streamed
    audio differs slightly from whole-song vocoding. `graphs` as in
    `render_songs`.
    """
    device = self.model.device
    if noise is None:
      noise = seeded_noise(0, device)
    codec = self.model.audio_codec
    l_ctx = self._context_length()
    l_in = self._input_length(max((len(s) for s in segments), default=1))
    context = torch.full((1, l_ctx, codec.n_dims), codec.pad_value,
                         dtype=torch.float32, device=device)
    context_mask = torch.zeros((1, l_ctx), dtype=torch.bool, device=device)
    prev_tail = None  # the last vocoder_context_frames of mel
    for gi, seg in enumerate(segments):
      tokens = np.zeros((1, l_in), np.int64)
      seg = np.asarray(seg)[:l_in]
      tokens[0, :len(seg)] = seg
      pred = self.model.predict(
          self._segment_batch(tokens, context, context_mask), noise(gi, 1),
          graphs=graphs)
      audio = None
      if self.vocoder is not None:
        if prev_tail is None:
          audio = self.vocoder(pred)[0]
        else:
          audio = self.vocoder(torch.cat([prev_tail, pred], dim=1))[
              0, vocoder_context_frames * codec.hop_size:]
        audio = audio.cpu().numpy()
        if vocoder_context_frames > 0:
          prev_tail = pred[:, -vocoder_context_frames:, :]
      context = pred[:, -l_ctx:, :]
      context_mask = torch.ones((1, l_ctx), dtype=torch.bool, device=device)
      yield gi, pred[0].cpu().numpy(), audio
