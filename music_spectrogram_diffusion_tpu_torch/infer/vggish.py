"""VGGish audio-embedding model in PyTorch, for Fréchet Audio Distance.

Port of music_spectrogram_diffusion_tpu/infer/vggish.py, the public VGGish
architecture (github.com/tensorflow/models/research/audioset/vggish):

  input:   96x64 log-mel patches (0.96 s @ 16 kHz)
  convs:   64 - 128 - 256x2 - 512x2 (3x3, ReLU, 2x2 max-pool after each
           group)
  fcs:     4096 - 4096 - 128 (all ReLU, as vggish_slim's arg scope:
           VGGish embeddings are non-negative)

The feature frontend (`log_mel_frames`, `log_mel_patches`) is a numpy copy
of the JAX package's, which reproduces audioset/mel_features.py: frames of
400 samples, hop 160, symmetric Hann, no end padding; |rfft| at 512; 64 HTK
mel bands over 125-7500 Hz; log(mel + 0.01); non-overlapping 96-frame
patches.

Weights: the `.npz` that tools/convert_vggish.py writes from the public
checkpoint, '<layer>/kernel' and '<layer>/bias' in the TF (= Flax) layout:
conv kernels HWIO, dense kernels [in, out]. `load_params` turns them into
this module's state_dict (conv kernels to torch's OIHW, dense kernels
transposed for nn.Linear). The trunk computes in NCHW; the flatten before
`fc1_1` is taken in NHWC order, as TF slim's, so that the converted
`fc1_1` kernel reads its rows in the order it was trained on.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from music_spectrogram_diffusion_tpu_torch.ops import stft as stft_ops

SAMPLE_RATE = 16000
STFT_WINDOW = 400  # 25 ms
STFT_HOP = 160  # 10 ms
FFT_LENGTH = 512
NUM_MEL_BINS = 64
MEL_MIN_HZ = 125.0
MEL_MAX_HZ = 7500.0
LOG_OFFSET = 0.01
PATCH_FRAMES = 96  # 0.96 s
EMBEDDING_SIZE = 128

CONVS = (("conv1", 1, 64), ("conv2", 64, 128), ("conv3_1", 128, 256),
         ("conv3_2", 256, 256), ("conv4_1", 256, 512), ("conv4_2", 512, 512))
FCS = (("fc1_1", 6 * 4 * 512, 4096), ("fc1_2", 4096, 4096),
       ("fc2", 4096, EMBEDDING_SIZE))


def log_mel_frames(audio: np.ndarray) -> np.ndarray:
  """[n_samples] @16 kHz -> [n_frames, 64] audioset log-mel frames.

  Matches audioset/mel_features.py (symmetric Hann, no padding,
  magnitude spectrogram, HTK mel, log(x + 0.01)). Shared by the VGGish
  and TRILL frontends, which window these frames differently.
  """
  audio = np.asarray(audio, np.float32)
  n = len(audio)
  n_frames = max(0, (n - STFT_WINDOW) // STFT_HOP + 1)
  if n_frames <= 0:
    return np.zeros((0, NUM_MEL_BINS), np.float32)
  idx = (np.arange(STFT_WINDOW)[None, :] +
         STFT_HOP * np.arange(n_frames)[:, None])
  frames = audio[idx] * np.hanning(STFT_WINDOW).astype(np.float32)
  mag = np.abs(np.fft.rfft(frames, n=FFT_LENGTH, axis=-1))
  # audioset's spectrogram_to_mel_matrix == tf.signal's (HTK formula,
  # zero DC row) — reuse the shared implementation.
  mel_mat = stft_ops.linear_to_mel_matrix(
      num_mel_bins=NUM_MEL_BINS, num_spectrogram_bins=FFT_LENGTH // 2 + 1,
      sample_rate=SAMPLE_RATE, lower_edge_hertz=MEL_MIN_HZ,
      upper_edge_hertz=MEL_MAX_HZ)
  return np.log(mag @ mel_mat + LOG_OFFSET).astype(np.float32)


def log_mel_patches(audio: np.ndarray) -> np.ndarray:
  """[n_samples] float audio @16 kHz -> [n_patches, 96, 64] log-mel.

  Non-overlapping 96-frame patches; a tail shorter than one patch is
  dropped (audioset example windowing).
  """
  log_mel = log_mel_frames(audio)
  n_patches = len(log_mel) // PATCH_FRAMES
  if n_patches == 0:
    return np.zeros((0, PATCH_FRAMES, NUM_MEL_BINS), np.float32)
  return log_mel[:n_patches * PATCH_FRAMES].reshape(
      n_patches, PATCH_FRAMES, NUM_MEL_BINS)


class VGGish(nn.Module):
  """The VGGish trunk; input [batch, 96, 64] -> [batch, 128]."""

  def __init__(self):
    super().__init__()
    for name, c_in, c_out in CONVS:
      self.add_module(name, nn.Conv2d(c_in, c_out, 3, padding=1))
    for name, d_in, d_out in FCS:
      self.add_module(name, nn.Linear(d_in, d_out))

  def forward(self, patches: torch.Tensor) -> torch.Tensor:
    x = patches[:, None]  # NCHW with one channel: H = frames, W = mel bins

    def conv(x, name):
      return F.relu(getattr(self, name)(x))

    x = F.max_pool2d(conv(x, "conv1"), 2)
    x = F.max_pool2d(conv(x, "conv2"), 2)
    x = F.max_pool2d(conv(conv(x, "conv3_1"), "conv3_2"), 2)
    x = F.max_pool2d(conv(conv(x, "conv4_1"), "conv4_2"), 2)
    # [batch, 512, 6, 4] -> the NHWC row-major flatten of TF slim.
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = F.relu(self.fc1_1(x))
    x = F.relu(self.fc1_2(x))
    # vggish_slim applies the arg-scope ReLU to fc2 as well: embeddings
    # are non-negative.
    return F.relu(self.fc2(x))


def flax_to_torch(arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
  """Converted '/'-joined Flax leaves -> torch state_dict entries: conv
  kernels HWIO -> OIHW, dense kernels [in, out] -> nn.Linear's [out, in],
  every other leaf as it is ('/' -> '.'), in float32."""
  out = {}
  for key, value in arrays.items():
    stem, _, leaf = key.rpartition("/")
    value = np.asarray(value, np.float32)
    if leaf == "kernel":
      leaf = "weight"
      value = (value.transpose(3, 2, 0, 1) if value.ndim == 4
               else value.T)
    name = f"{stem}/{leaf}".replace("/", ".") if stem else leaf
    out[name] = torch.from_numpy(np.ascontiguousarray(value))
  return out


def read_npz(npz_path: str) -> Dict[str, np.ndarray]:
  with np.load(npz_path) as raw:
    return {key: raw[key] for key in raw.files}


def load_params(npz_path: str) -> Dict[str, torch.Tensor]:
  """The converted weights (tools/convert_vggish.py output) as VGGish's
  state_dict (see `flax_to_torch`)."""
  return flax_to_torch(read_npz(npz_path))


def random_weights(seed: int) -> Dict[str, np.ndarray]:
  """Random weights in the converted layout (He-scaled kernels, small
  biases), from `seed`: what the tests and the smoke run embed with, since
  the repository holds no trained VGGish."""
  rng = np.random.RandomState(seed)
  out = {}
  for name, c_in, c_out in CONVS:
    out[f"{name}/kernel"] = (rng.randn(3, 3, c_in, c_out)
                             * np.sqrt(2.0 / (9 * c_in))).astype(np.float32)
    out[f"{name}/bias"] = (rng.randn(c_out) * 0.01).astype(np.float32)
  for name, d_in, d_out in FCS:
    out[f"{name}/kernel"] = (rng.randn(d_in, d_out)
                             * np.sqrt(2.0 / d_in)).astype(np.float32)
    out[f"{name}/bias"] = (rng.randn(d_out) * 0.01).astype(np.float32)
  return out


class VGGishEmbedder:
  """audio [n_samples] @16 kHz -> [n_patches, 128] embeddings, the net on
  `device`."""

  def __init__(self, npz_path: str, device="cuda"):
    from music_spectrogram_diffusion_tpu_torch.infer import inference
    self.device = inference.resolve_device(device)
    self.module = VGGish()
    self.module.load_state_dict(load_params(npz_path), strict=True)
    self.module.to(self.device).eval().requires_grad_(False)

  @torch.inference_mode()
  def __call__(self, audio: np.ndarray) -> np.ndarray:
    patches = log_mel_patches(audio)
    if patches.shape[0] == 0:
      return np.zeros((0, EMBEDDING_SIZE), np.float32)
    return self.module(torch.as_tensor(patches, device=self.device)
                       ).cpu().numpy()


def register(npz_path: Optional[str] = None, device="cuda") -> bool:
  """Register VGGish in postprocessors.EMBEDDING_MODELS.

  Uses `npz_path` or $MSD_VGGISH_WEIGHTS. Returns True when registered
  (weights found); False otherwise (evaluation falls back to mel-FAD).
  """
  from music_spectrogram_diffusion_tpu_torch.infer import postprocessors
  path = npz_path or os.environ.get("MSD_VGGISH_WEIGHTS")
  if not path or not os.path.exists(path):
    return False
  postprocessors.register_embedding_model(
      "vggish", VGGishEmbedder(path, device))
  return True
