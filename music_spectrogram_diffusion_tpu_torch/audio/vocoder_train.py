"""Vocoder training: mel -> audio with multi-resolution spectral losses.

Port of music_spectrogram_diffusion_tpu/audio/vocoder_train.py:
`stft_loss`, which also scores a vocoder (cli/eval_vocoder.py); the
reconstruction trainer of the SoundStream-style decoder (`VocoderTrainer`:
multi-resolution STFT loss plus waveform L1), the MagnitudeNet trainer of
the HybridGLVocoder (`MagnitudeTrainer`), the SoundStream GAN fine-tuning
over audio/discriminators.py (`AdversarialVocoderTrainer`), and the data
helpers `prefetch` and `vocoder_batches`.

Parameters live in the trainer's modules on its device (`device`, default
cuda); a state holds them by name (the modules' own tensors, updated in
place), the optimizer state and the step count. The optimizer is optax's
`adamw` at a constant learning rate, written out by hand
(`train/trainer.py AdamW`). `create_state(seed)` draws the modules' weights
with PyTorch's initializers from `seed` on the CPU (JAX's draws cannot be
reproduced); `seed=None` keeps the weights the modules hold, e.g. loaded
from a checkpoint or a Flax tree.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from music_spectrogram_diffusion_tpu_torch.audio import codecs
from music_spectrogram_diffusion_tpu_torch.audio import discriminators
from music_spectrogram_diffusion_tpu_torch.audio import vocoder as vocoder_lib
from music_spectrogram_diffusion_tpu_torch.infer import inference
from music_spectrogram_diffusion_tpu_torch.ops import stft as stft_ops
from music_spectrogram_diffusion_tpu_torch.train import trainer as trainer_lib

Tensors = Dict[str, torch.Tensor]

# (fft_length, hop, win) triples for the multi-resolution loss.
DEFAULT_RESOLUTIONS: Tuple[Tuple[int, int, int], ...] = (
    (2048, 512, 1200), (1024, 256, 600), (512, 128, 240),
)


def stft_loss(pred: torch.Tensor, target: torch.Tensor,
              resolutions: Sequence[Tuple[int, int, int]] = (
                  DEFAULT_RESOLUTIONS)) -> Dict[str, torch.Tensor]:
  """Multi-resolution STFT loss (Yamamoto et al. 2020): spectral
  convergence ||T - P|| / ||T|| and the mean |log T - log P| (magnitudes
  clamped at 1e-5), each averaged over the resolutions."""
  sc_total = mag_total = 0.0
  for n_fft, hop, win in resolutions:
    p = stft_ops.stft_magnitude(pred, frame_length=win, frame_step=hop,
                                fft_length=n_fft)
    t = stft_ops.stft_magnitude(target, frame_length=win, frame_step=hop,
                                fft_length=n_fft)
    sc = torch.linalg.norm(t - p) / torch.clamp(torch.linalg.norm(t),
                                                min=1e-6)
    mag = torch.mean(torch.abs(torch.log(torch.clamp(t, min=1e-5))
                               - torch.log(torch.clamp(p, min=1e-5))))
    sc_total = sc_total + sc
    mag_total = mag_total + mag
  n = len(resolutions)
  return {"spectral_convergence": sc_total / n,
          "log_magnitude": mag_total / n}


def _reset_(modules: Sequence[nn.Module], seed: int, device) -> None:
  """Draw the modules' weights from `seed` (one CPU stream, in order, with
  each layer's own initializer), then move them to `device`."""
  with torch.random.fork_rng(devices=[]):
    torch.manual_seed(seed)
    for module in modules:
      module.to("cpu")
      subs = list(module.modules())
      # The children's initializers first, then the module's own (which
      # may overrule them, as MagnitudeNet's zero head does).
      for sub in subs[1:] + subs[:1]:
        if hasattr(sub, "reset_parameters"):
          sub.reset_parameters()
  for module in modules:
    module.to(device)


def _params(module: nn.Module) -> Tensors:
  return dict(module.named_parameters())


def _grads(loss: torch.Tensor, params: Tensors) -> Tensors:
  """d loss / d params; zero where the loss does not reach (as JAX)."""
  grads = torch.autograd.grad(loss, list(params.values()),
                              allow_unused=True)
  return {n: torch.zeros_like(p) if g is None else g
          for (n, p), g in zip(params.items(), grads)}


def _to(x, device) -> torch.Tensor:
  return torch.as_tensor(x, dtype=torch.float32, device=device)


def _detached(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
  return {k: v.detach() for k, v in metrics.items()}


@dataclasses.dataclass
class VocoderTrainState:
  """The step count, the parameters by name (the module's own tensors) and
  the optimizer state."""
  step: int
  params: Tensors
  opt_state: Dict[str, Any]


class _SingleNetTrainer:
  """What the reconstruction and magnitude trainers share: one net, AdamW
  at a constant learning rate, a step that updates the net in place."""

  net: nn.Module

  def _setup(self, learning_rate: float, device) -> None:
    self.device = inference.resolve_device(device)
    self.net.to(self.device).train()
    self.optimizer = trainer_lib.AdamW(
        trainer_lib.constant_schedule(learning_rate))

  def create_state(self, seed: Optional[int] = 0) -> VocoderTrainState:
    """A fresh state; the weights drawn from `seed`, or kept (None)."""
    if seed is not None:
      _reset_([self.net], seed, self.device)
    params = _params(self.net)
    return VocoderTrainState(step=0, params=params,
                             opt_state=self.optimizer.init(params))

  def loss_fn(self, mel: torch.Tensor, audio: torch.Tensor
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    raise NotImplementedError

  def train_step(self, state: VocoderTrainState, mel, audio
                 ) -> Tuple[VocoderTrainState, Dict[str, torch.Tensor]]:
    """One AdamW step on (mel [B, T, mel], audio [B, T * hop]); the
    metrics are 0-d tensors on the device."""
    total, metrics = self.loss_fn(_to(mel, self.device),
                                  _to(audio, self.device))
    grads = _grads(total, state.params)
    opt_state = self.optimizer.step_(state.params, grads, state.opt_state)
    return VocoderTrainState(step=state.step + 1, params=state.params,
                             opt_state=opt_state), _detached(metrics)


class VocoderTrainer(_SingleNetTrainer):
  """Reconstruction trainer for the SoundStream-style mel inverter."""

  def __init__(self, decoder: vocoder_lib.SoundStreamDecoder,
               audio_codec: codecs.MelGan, learning_rate: float = 1e-4,
               waveform_weight: float = 10.0, device="cuda"):
    self.net = self.decoder = decoder
    self.audio_codec = audio_codec
    self.waveform_weight = waveform_weight
    self._setup(learning_rate, device)

  def loss_fn(self, mel, audio):
    pred = self.decoder(mel)
    n = min(pred.shape[-1], audio.shape[-1])
    pred, audio = pred[..., :n], audio[..., :n]
    losses = stft_loss(pred, audio)
    wav_l1 = torch.mean(torch.abs(pred - audio))
    total = (losses["spectral_convergence"] + losses["log_magnitude"]
             + self.waveform_weight * wav_l1)
    metrics = dict(losses)
    metrics["waveform_l1"] = wav_l1
    metrics["loss"] = total
    return total, metrics

  def as_codec_decoder(self, state: VocoderTrainState):
    """(apply_fn, params) pair for AudioCodec.set_vocoder; the weights are
    the decoder's, so the params slot is unused."""
    del state

    @torch.inference_mode()
    def apply_fn(_params, feats):
      return self.decoder(_to(feats, self.device))
    return apply_fn, None


class MagnitudeTrainer(_SingleNetTrainer):
  """Trainer for the MagnitudeNet mel inversion (HybridGLVocoder).

  Supervised per-frame regression: the target linear STFT magnitude is
  computed from the paired audio with the SAME frame geometry Griffin-Lim
  inverts (640/320/1024), so train and inference operate on identical
  frames. Loss = spectral convergence + log-magnitude L1 on the PREDICTED
  magnitudes directly (no audio reconstruction in the loop; phase recovery
  is not trained)."""

  def __init__(self, net: vocoder_lib.MagnitudeNet,
               audio_codec: codecs.MelGan, learning_rate: float = 1e-3,
               frame_length: int = 640, fft_length: int = 1024,
               device="cuda"):
    self.net = net
    self.audio_codec = audio_codec
    self.frame_length, self.fft_length = frame_length, fft_length
    self._setup(learning_rate, device)

  def loss_fn(self, mel, audio):
    pred = self.net(mel)
    true = stft_ops.stft_magnitude(
        audio, frame_length=self.frame_length,
        frame_step=self.audio_codec.hop_size, fft_length=self.fft_length)
    n = min(pred.shape[1], true.shape[1])
    pred, true = pred[:, :n], true[:, :n]
    sc = torch.linalg.norm(true - pred) / torch.clamp(
        torch.linalg.norm(true), min=1e-6)
    mag = torch.mean(torch.abs(torch.log(torch.clamp(true, min=1e-5))
                               - torch.log(torch.clamp(pred, min=1e-5))))
    total = sc + mag
    return total, {"spectral_convergence": sc, "log_magnitude": mag,
                   "loss": total}


@dataclasses.dataclass
class AdversarialTrainState:
  """The step count; the generator's and the discriminator's parameters
  (the modules' own tensors) and optimizer states."""
  step: int
  g_params: Tensors
  g_opt_state: Dict[str, Any]
  d_params: Tensors
  d_opt_state: Dict[str, Any]


class AdversarialVocoderTrainer:
  """SoundStream-style GAN fine-tuning: reconstruction + hinge adversarial
  + feature-matching losses over the discriminator ensemble
  (audio/discriminators.py).

  A step, in JAX's order: the generator steps against the current
  discriminator (its loss's gradient taken over the generator's parameters
  only), then the discriminator steps on audio the updated generator makes
  afresh. Both optimizers are AdamW with b1 0.5 and b2 0.9."""

  def __init__(self, decoder: vocoder_lib.SoundStreamDecoder,
               audio_codec: codecs.MelGan, g_learning_rate: float = 1e-4,
               d_learning_rate: float = 1e-4, waveform_weight: float = 10.0,
               adversarial_weight: float = 1.0,
               feature_matching_weight: float = 10.0, device="cuda"):
    self.decoder = decoder
    self.audio_codec = audio_codec
    self.waveform_weight = waveform_weight
    self.adversarial_weight = adversarial_weight
    self.feature_matching_weight = feature_matching_weight
    self.device = inference.resolve_device(device)
    self.disc = discriminators.VocoderDiscriminators()
    self.decoder.to(self.device).train()
    self.disc.to(self.device).train()
    self.g_optimizer = trainer_lib.AdamW(
        trainer_lib.constant_schedule(g_learning_rate), b1=0.5, b2=0.9)
    self.d_optimizer = trainer_lib.AdamW(
        trainer_lib.constant_schedule(d_learning_rate), b1=0.5, b2=0.9)

  def create_state(self, seed: Optional[int] = 0) -> AdversarialTrainState:
    """A fresh state; the generator's then the discriminator's weights
    drawn from `seed` (one stream), or both kept (None)."""
    if seed is not None:
      _reset_([self.decoder, self.disc], seed, self.device)
    g_params, d_params = _params(self.decoder), _params(self.disc)
    return AdversarialTrainState(
        step=0, g_params=g_params,
        g_opt_state=self.g_optimizer.init(g_params), d_params=d_params,
        d_opt_state=self.d_optimizer.init(d_params))

  def _generate(self, mel, audio):
    pred = self.decoder(mel)
    n = min(pred.shape[-1], audio.shape[-1])
    return pred[..., :n], audio[..., :n]

  def g_loss_fn(self, mel, audio):
    pred, target = self._generate(mel, audio)
    rec = stft_loss(pred, target)
    wav_l1 = torch.mean(torch.abs(pred - target))
    fake_out = self.disc(pred)
    real_out = self.disc(target)
    adv = discriminators.hinge_g_loss(fake_out)
    fm = discriminators.feature_matching_loss(real_out, fake_out)
    total = (rec["spectral_convergence"] + rec["log_magnitude"]
             + self.waveform_weight * wav_l1 + self.adversarial_weight * adv
             + self.feature_matching_weight * fm)
    return total, {"g_loss": total, "adv": adv, "feature_matching": fm,
                   "waveform_l1": wav_l1, **rec}

  def d_loss_fn(self, mel, audio):
    with torch.no_grad():
      pred, target = self._generate(mel, audio)
    return discriminators.hinge_d_loss(self.disc(target), self.disc(pred))

  def train_step(self, state: AdversarialTrainState, mel, audio
                 ) -> Tuple[AdversarialTrainState, Dict[str, torch.Tensor]]:
    mel, audio = _to(mel, self.device), _to(audio, self.device)
    g_total, metrics = self.g_loss_fn(mel, audio)
    g_grads = _grads(g_total, state.g_params)
    g_opt = self.g_optimizer.step_(state.g_params, g_grads,
                                   state.g_opt_state)
    d_loss = self.d_loss_fn(mel, audio)
    d_grads = _grads(d_loss, state.d_params)
    d_opt = self.d_optimizer.step_(state.d_params, d_grads,
                                   state.d_opt_state)
    metrics = _detached(metrics)
    metrics["d_loss"] = d_loss.detach()
    return AdversarialTrainState(
        step=state.step + 1, g_params=state.g_params, g_opt_state=g_opt,
        d_params=state.d_params, d_opt_state=d_opt), metrics


def prefetch(iterator: Iterator, depth: int = 4) -> Iterator:
  """Run an iterator in a daemon thread, buffering `depth` items.

  Overlaps host-side batch assembly with device compute. Exceptions from
  the producer re-raise at the consumer's next __next__.
  """
  q: "queue.Queue" = queue.Queue(maxsize=depth)
  done = object()

  def worker():
    try:
      for item in iterator:
        q.put(item)
      q.put(done)
    except BaseException as e:  # surface producer errors downstream
      q.put(e)

  threading.Thread(target=worker, daemon=True).start()
  while True:
    item = q.get()
    if item is done:
      return
    if isinstance(item, BaseException):
      raise item
    yield item


def vocoder_batches(audio_source: Iterator[np.ndarray],
                    audio_codec: codecs.MelGan,
                    *,
                    segment_frames: int = 64,
                    batch_size: int = 8,
                    seed: int = 0
                    ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
  """(mel, audio) training pairs from raw audio clips, as CPU tensors: a
  segment of segment_frames x hop samples from each clip long enough,
  its start drawn by `np.random.RandomState(seed)` (as JAX draws it), and
  its log-mel frames."""
  rng = np.random.RandomState(seed)
  hop = audio_codec.hop_size
  seg_samples = segment_frames * hop
  mels, audios = [], []
  for clip in audio_source:
    clip = np.asarray(clip, np.float32)
    if len(clip) < seg_samples:
      continue
    start = rng.randint(0, len(clip) - seg_samples + 1)
    seg = clip[start:start + seg_samples]
    mel = audio_codec.encode(torch.from_numpy(seg[None]))[0][:segment_frames]
    mels.append(mel)
    audios.append(torch.from_numpy(seg))
    if len(mels) == batch_size:
      yield torch.stack(mels), torch.stack(audios)
      mels, audios = [], []
