"""TRILL audio-embedding model in PyTorch, for Fréchet Audio Distance.

Port of music_spectrogram_diffusion_tpu/infer/trill.py. TRILL (Shor et al.
2020) is the VGGish log-mel frontend (96x64 patches, infer/vggish.py)
windowed at a 17-frame (0.17 s) hop, feeding "ResNetish-50" (a ResNet-50
v1 trunk: [3, 4, 6, 3] bottlenecks, a 7x7/2 stem and a 3x3/2 max-pool,
global average pool to 2048) and the 512-d embedding layer (the TF-Hub
module's 'embedding' output).

BatchNorm is in its folded inference form, a per-channel (scale, bias)
after each bias-free conv, as tools/convert_trill.py writes it. Flax's
padding="SAME" is not torch's `padding=`: with stride 2 it pads the extra
row and column at the end, and its max-pool pads with -inf. Both are an
explicit `F.pad` here (`_same_pad`). Weights load from the converter's
`.npz` ('/'-joined paths of the Flax tree, conv kernels HWIO) through
`vggish.flax_to_torch`.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from music_spectrogram_diffusion_tpu_torch.infer import vggish as vggish_lib

PATCH_FRAMES = 96
PATCH_HOP_FRAMES = 17  # 0.17 s — TRILL's ~0.167 s window step
NUM_MEL_BINS = vggish_lib.NUM_MEL_BINS
EMBEDDING_SIZE = 512
BLOCKS_PER_STAGE = (3, 4, 6, 3)  # ResNet-50
STAGE_FILTERS = (64, 128, 256, 512)


def log_mel_patches(audio: np.ndarray) -> np.ndarray:
  """[n_samples] @16 kHz -> [n_patches, 96, 64] log-mel, 0.17 s hop.

  The shared audioset frontend (vggish_lib.log_mel_frames) windowed at
  TRILL's ~0.167 s step instead of VGGish's non-overlapping patches."""
  log_mel = vggish_lib.log_mel_frames(audio)
  n_frames = len(log_mel)
  if n_frames < PATCH_FRAMES:
    return np.zeros((0, PATCH_FRAMES, NUM_MEL_BINS), np.float32)
  starts = np.arange(0, n_frames - PATCH_FRAMES + 1, PATCH_HOP_FRAMES)
  return np.stack([log_mel[s:s + PATCH_FRAMES] for s in starts])


def _same_pad(x: torch.Tensor, kernel: Sequence[int],
              strides: Sequence[int], value: float = 0.0) -> torch.Tensor:
  """Pad NCHW `x` as Flax/XLA's padding="SAME" does: out = ceil(in /
  stride), the total pad split with the odd element at the end."""
  pads = []
  for size, k, s in zip(x.shape[2:], kernel, strides):
    total = max((-(-size // s) - 1) * s + k - size, 0)
    pads.append((total // 2, total - total // 2))
  (top, bottom), (left, right) = pads
  return F.pad(x, (left, right, top, bottom), value=value)


class ConvBnRelu(nn.Module):
  """conv -> folded-BN affine -> optional relu (BN has no conv bias)."""

  def __init__(self, c_in: int, features: int, kernel: Sequence[int],
               strides: Sequence[int] = (1, 1), relu: bool = True):
    super().__init__()
    self.kernel, self.strides, self.relu = (tuple(kernel), tuple(strides),
                                            relu)
    self.conv = nn.Conv2d(c_in, features, self.kernel, self.strides,
                          bias=False)
    self.bn_scale = nn.Parameter(torch.ones(features))
    self.bn_bias = nn.Parameter(torch.zeros(features))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x = self.conv(_same_pad(x, self.kernel, self.strides))
    x = x * self.bn_scale[:, None, None] + self.bn_bias[:, None, None]
    return F.relu(x) if self.relu else x


class Bottleneck(nn.Module):
  """ResNet v1 bottleneck: 1x1 -> 3x3 -> 1x1(x4) + projected shortcut."""

  def __init__(self, c_in: int, filters: int,
               strides: Sequence[int] = (1, 1), project: bool = False):
    super().__init__()
    if project:
      self.proj = ConvBnRelu(c_in, filters * 4, (1, 1), strides, relu=False)
    else:
      self.proj = None
    self.conv1 = ConvBnRelu(c_in, filters, (1, 1), strides)
    self.conv2 = ConvBnRelu(filters, filters, (3, 3))
    self.conv3 = ConvBnRelu(filters, filters * 4, (1, 1), relu=False)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    shortcut = x if self.proj is None else self.proj(x)
    y = self.conv3(self.conv2(self.conv1(x)))
    return F.relu(y + shortcut)


def block_names():
  """(name, input channels, filters, strides, project) of every
  bottleneck, in trunk order."""
  out, c_in = [], 64
  for stage, (blocks, filters) in enumerate(
      zip(BLOCKS_PER_STAGE, STAGE_FILTERS)):
    for block in range(blocks):
      strides = (2, 2) if stage > 0 and block == 0 else (1, 1)
      out.append((f"stage{stage + 1}_block{block}", c_in, filters, strides,
                  block == 0))
      c_in = filters * 4
  return out


class ResNetish50(nn.Module):
  """[batch, 96, 64] log-mel -> [batch, 512] TRILL embedding."""

  def __init__(self):
    super().__init__()
    self.stem = ConvBnRelu(1, 64, (7, 7), (2, 2))
    self.blocks = []
    for name, c_in, filters, strides, project in block_names():
      self.add_module(name, Bottleneck(c_in, filters, strides, project))
      self.blocks.append(name)
    self.embedding = nn.Linear(STAGE_FILTERS[-1] * 4, EMBEDDING_SIZE)

  def forward(self, patches: torch.Tensor) -> torch.Tensor:
    x = self.stem(patches[:, None])
    x = F.max_pool2d(_same_pad(x, (3, 3), (2, 2), float("-inf")), 3, 2)
    for name in self.blocks:
      x = getattr(self, name)(x)
    return self.embedding(torch.mean(x, dim=(2, 3)))  # global average pool


def load_params(npz_path: str) -> Dict[str, torch.Tensor]:
  """The converted weights (tools/convert_trill.py output: keys are
  '/'-joined module paths such as 'stage1_block0/conv2/conv/kernel',
  'stem/bn_scale', 'embedding/kernel') as ResNetish50's state_dict."""
  return vggish_lib.flax_to_torch(vggish_lib.read_npz(npz_path))


def random_weights(seed: int) -> Dict[str, np.ndarray]:
  """Random weights in the converted layout, from `seed` (He-scaled
  kernels; folded-BN scales around 0.5 so that the residual stream stays
  finite): what the tests and the smoke run embed with, since the
  repository holds no trained TRILL."""
  rng = np.random.RandomState(seed)
  out = {}

  def conv_bn(name, c_in, c_out, k):
    out[f"{name}/conv/kernel"] = (
        rng.randn(k, k, c_in, c_out) * np.sqrt(2.0 / (k * k * c_in))
    ).astype(np.float32)
    out[f"{name}/bn_scale"] = (0.5 + 0.1 * rng.randn(c_out)).astype(
        np.float32)
    out[f"{name}/bn_bias"] = (0.01 * rng.randn(c_out)).astype(np.float32)

  conv_bn("stem", 1, 64, 7)
  for name, c_in, filters, _, project in block_names():
    if project:
      conv_bn(f"{name}/proj", c_in, filters * 4, 1)
    conv_bn(f"{name}/conv1", c_in, filters, 1)
    conv_bn(f"{name}/conv2", filters, filters, 3)
    conv_bn(f"{name}/conv3", filters, filters * 4, 1)
  d_in = STAGE_FILTERS[-1] * 4
  out["embedding/kernel"] = (rng.randn(d_in, EMBEDDING_SIZE)
                             / np.sqrt(d_in)).astype(np.float32)
  out["embedding/bias"] = (0.01 * rng.randn(EMBEDDING_SIZE)).astype(
      np.float32)
  return out


class TRILLEmbedder:
  """audio [n_samples] @16 kHz -> [n_windows, 512] embeddings, the net on
  `device`."""

  def __init__(self, npz_path: str, device="cuda"):
    from music_spectrogram_diffusion_tpu_torch.infer import inference
    self.device = inference.resolve_device(device)
    self.module = ResNetish50()
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
  """Register TRILL in postprocessors.EMBEDDING_MODELS.

  Uses `npz_path` or $MSD_TRILL_WEIGHTS. Returns True when registered
  (weights found); False otherwise."""
  from music_spectrogram_diffusion_tpu_torch.infer import postprocessors
  path = npz_path or os.environ.get("MSD_TRILL_WEIGHTS")
  if not path or not os.path.exists(path):
    return False
  postprocessors.register_embedding_model(
      "trill", TRILLEmbedder(path, device))
  return True
