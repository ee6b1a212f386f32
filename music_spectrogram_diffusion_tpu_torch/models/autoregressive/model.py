"""Autoregressive model: the teacher-forced loss and the cached decode loop
in PyTorch.

Port of music_spectrogram_diffusion_tpu/models/autoregressive/model.py
(`AutoregressiveModel`). `predict` encodes once, projects the
cross-attention K/V once, and then runs `target_len` single-frame decode
steps against a self-attention cache of fixed length, each step's sampled
frame feeding the next. JAX runs the loop as one `lax.scan`; here the step
reads its position from a device tensor (JAX's `cache_index`), so on a
CUDA device one captured graph of the step is replayed for every frame
(`ops/graphs.py`), and on the CPU the same step runs eagerly.

Batch schema:
  encoder_input_tokens   int   [B, L_in]
  decoder_input_tokens   f32   [B, L_tgt, n_dims]  (teacher forcing: the
                                                    targets shifted by one)
  decoder_target_tokens  f32   [B, L_tgt, n_dims]  (shape only in predict)
  decoder_target_mask    bool  [B, L_tgt]          (loss_fn only)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch

from music_spectrogram_diffusion_tpu_torch.audio import codecs
from music_spectrogram_diffusion_tpu_torch.models.autoregressive import (
    network)
from music_spectrogram_diffusion_tpu_torch.ops import diffusion as dops
from music_spectrogram_diffusion_tpu_torch.ops import graphs as graphs_lib


class AutoregressiveModel:
  """Continuous-output encoder-decoder with an output head."""

  USES_CONTEXT = False

  def __init__(self, module: network.ARTransformer, output_function,
               audio_codec: codecs.MelGan):
    self.module = module
    self.output_function = output_function
    self.audio_codec = audio_codec
    self.step_graphs = None  # graphs_lib.model_step_graphs
    self._slots: Dict[tuple, "_Generation"] = {}

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
              noise: dops.NoiseFn,
              graphs: Optional[bool] = None) -> torch.Tensor:
    """Generate one segment per row, frame by frame; returns features
    [B, L_tgt, n_dims] float32. `noise` feeds the head's sampling (one
    generator per row: `synthesize.seeded_noise`), every step's draws
    taken before the loop in the order of the steps; the deterministic
    head without dither draws nothing. `graphs` as the diffusion models'
    `predict`: on a CUDA device the decode step is captured once and
    replayed for every frame, unless `graphs` is False."""
    captured = graphs_lib.use_graphs(self.device, graphs)
    tokens = batch["encoder_input_tokens"]
    batch_size, target_len = batch["decoder_target_tokens"].shape[:2]
    device = tokens.device
    encoded = self.module.encode(tokens)
    cache = self.module.init_cache(encoded, tokens, target_len)
    cfg = self.module.config
    shape = self.output_function.draw_shape(batch_size,
                                            cfg.output_dim or cfg.audio_dim)
    draws = None if shape is None else torch.stack(
        [noise(i, shape).to(device) for i in range(target_len)])
    key = (tuple(tokens.shape), target_len)
    gen = self._slots.get(key) if captured else None
    if gen is None:
      n_dims = self.audio_codec.n_dims
      gen = _Generation(
          cache, torch.zeros(batch_size, 1, n_dims, device=device),
          torch.zeros(batch_size, target_len, n_dims, device=device), draws,
          torch.zeros(1, dtype=torch.int64, device=device))
      if captured:
        self._slots[key] = gen
    else:
      # The step graph reads the generation's buffers: refill them.
      graphs_lib.copy_tree_(_buffers(gen.cache), _buffers(cache))
      if draws is not None:
        gen.draws.copy_(draws)
      gen.frame.zero_()
      gen.index.zero_()

    def step():
      out = self.module.decode_step(gen.cache, gen.frame, gen.index)
      row = (None if gen.draws is None else
             gen.draws.index_select(0, gen.index)[0])
      frame = self.output_function.get_sample(out[:, 0], row)[:, None]
      gen.frames.index_copy_(1, gen.index, frame.float())
      gen.frame.copy_(frame)
      gen.index.add_(1)

    step_graphs = graphs_lib.model_step_graphs(self)
    with graphs_lib.on_stream(step_graphs):
      for _ in range(target_len):
        if captured:
          step_graphs.run(key, step)
        else:
          step()
    return gen.frames.clone() if captured else gen.frames


@dataclasses.dataclass
class _Generation:
  """What a generation's decode steps read and write: the decode cache,
  the frame that feeds the next step, the frames so far [B, L, n_dims]
  (float32), each step's draws [L, *draw_shape] (None where the head
  draws nothing) and the next step's index (int64 [1]). A captured model
  keeps one for each shape, read by its step graph."""
  cache: network.DecoderCache
  frame: torch.Tensor
  frames: torch.Tensor
  draws: Optional[torch.Tensor]
  index: torch.Tensor


def _buffers(cache: network.DecoderCache) -> tuple:
  return (cache.cross_kv, cache.cross_bias,
          [(kv.key, kv.value) for kv in cache.self_kv])
