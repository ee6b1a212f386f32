"""Typed configuration presets, as in the JAX package's config.py.

Model sizes match gin/models/diffusion/{basic,context}/t5_*.gin:
  small: 512d / 6h  / 8+8 layers  / mlp 1024
  base:  768d / 12h / 12+12       / mlp 2048
  large: 1024d / 16h / 24+24      / mlp 2816
All with gated-gelu MLPs, concat_encodings cross-attention and
fixed_permuted_offset positions; context models use terminal-relative
context positions. The JSON an ExperimentConfig writes is the same in both
packages, so a config saved beside a JAX checkpoint reads here.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, Optional

import torch

from music_spectrogram_diffusion_tpu_torch.midi import vocabularies
from music_spectrogram_diffusion_tpu_torch.models.diffusion import network
from music_spectrogram_diffusion_tpu_torch.ops import diffusion as dops


def padded_vocab_size(base_size: int, multiple: int = 128) -> int:
  return multiple * math.ceil(base_size / multiple)


@dataclasses.dataclass(frozen=True)
class TaskLengths:
  """Feature lengths (reference gin/tasks/mt3/base.gin)."""
  inputs: int = 2048
  targets: int = 256
  targets_context: int = 256


@dataclasses.dataclass(frozen=True)
class TrainConfig:
  """Training hyperparameters (train/trainer.py, train/loop.py)."""
  batch_size: int = 256
  learning_rate: float = 1e-3
  warmup_steps: int = 1000
  train_steps: int = 500_000
  adafactor_decay_rate: float = 0.8
  checkpoint_period: int = 10_000
  eval_period: int = 10_000
  num_microbatches: int = 1


_SIZES: Dict[str, Dict[str, int]] = {
    "tiny": dict(emb_dim=64, num_heads=2, num_encoder_layers=2,
                 num_decoder_layers=2, head_dim=32, mlp_dim=128),
    "small": dict(emb_dim=512, num_heads=6, num_encoder_layers=8,
                  num_decoder_layers=8, head_dim=64, mlp_dim=1024),
    "base": dict(emb_dim=768, num_heads=12, num_encoder_layers=12,
                 num_decoder_layers=12, head_dim=64, mlp_dim=2048),
    "large": dict(emb_dim=1024, num_heads=16, num_encoder_layers=24,
                  num_decoder_layers=24, head_dim=64, mlp_dim=2816),
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def default_vocab_size(num_velocity_bins: int = 1) -> int:
  """Embedding rows of the task vocabulary, padded to a multiple of 128."""
  vocab = vocabularies.vocabulary_from_codec(vocabularies.build_codec(
      vocabularies.VocabularyConfig(num_velocity_bins=num_velocity_bins)))
  return padded_vocab_size(vocab.vocab_size)


def network_config(size: str = "base",
                   *,
                   with_context: bool = True,
                   vocab_size: Optional[int] = None,
                   dtype: str = "float32",
                   dropout_rate: float = 0.1,
                   remat: bool = False) -> network.NetworkConfig:
  """The transformer config for a model size."""
  if size not in _SIZES:
    raise ValueError(f"Unknown size {size!r}; have {sorted(_SIZES)}")
  return network.NetworkConfig(
      vocab_size=vocab_size if vocab_size is not None else default_vocab_size(),
      dtype=_DTYPES[dtype],
      mlp_activations=("gelu", "linear"),
      dropout_rate=dropout_rate,
      cross_attend_style="concat_encodings",
      position_encoding="fixed_permuted_offset",
      context_positions=("terminal_relative" if with_context else "regular"),
      remat=remat,
      **_SIZES[size])


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
  """Fully-resolved experiment: model + diffusion + task + train.

  Same fields as the JAX package's ExperimentConfig; the port serves and
  trains the context diffusion family.
  """
  size: str = "base"
  with_context: bool = True
  dtype: str = "float32"
  dropout_rate: float = 0.1
  remat: bool = False
  codec_name: str = "melgan"
  task_lengths: TaskLengths = TaskLengths()
  diffusion: dops.DiffusionConfig = dops.DiffusionConfig()
  train: TrainConfig = TrainConfig()
  vocab_size: Optional[int] = None
  model_family: str = "diffusion"
  ar_output: str = "deterministic"
  num_velocity_bins: int = 1
  onsets_only: bool = False
  include_ties: bool = True
  program_granularity: str = "full"

  def vocab_config(self) -> vocabularies.VocabularyConfig:
    return vocabularies.VocabularyConfig(
        num_velocity_bins=self.num_velocity_bins)

  def note_rep(self):
    from music_spectrogram_diffusion_tpu_torch.data import tasks
    return tasks.NoteRepresentationConfig(
        onsets_only=self.onsets_only, include_ties=self.include_ties)

  def network(self) -> network.NetworkConfig:
    vocab_size = self.vocab_size
    if vocab_size is None and self.num_velocity_bins != 1:
      vocab_size = default_vocab_size(self.num_velocity_bins)
    return network_config(self.size, with_context=self.with_context,
                          vocab_size=vocab_size, dtype=self.dtype,
                          dropout_rate=self.dropout_rate, remat=self.remat)

  def to_json(self) -> str:
    def default(o: Any):
      if dataclasses.is_dataclass(o):
        return {"__dc__": type(o).__name__, **dataclasses.asdict(o)}
      raise TypeError(o)
    return json.dumps(dataclasses.asdict(self), default=default, indent=2)

  @staticmethod
  def from_json(text: str) -> "ExperimentConfig":
    raw = json.loads(text)
    raw["task_lengths"] = TaskLengths(**raw["task_lengths"])
    d = raw["diffusion"]
    d["train_schedule"] = dops.Schedule(**d["train_schedule"])
    g = d["guidance"]
    if g.get("interval") is not None:
      g["interval"] = tuple(g["interval"])  # JSON gives lists
    d["guidance"] = dops.GuidanceConfig(**g)
    s = d["sampler"]
    s["schedule"] = dops.Schedule(**s["schedule"])
    d["sampler"] = dops.SamplerConfig(**s)
    raw["diffusion"] = dops.DiffusionConfig(**d)
    raw["train"] = TrainConfig(**raw["train"])
    return ExperimentConfig(**raw)


def preset(name: str) -> ExperimentConfig:
  """Named presets mirroring the reference gin model files."""
  presets = {
      "diffusion_tiny": ExperimentConfig(size="tiny", with_context=False),
      "diffusion_small": ExperimentConfig(size="small", with_context=False),
      "diffusion_base": ExperimentConfig(size="base", with_context=False),
      "context_tiny": ExperimentConfig(size="tiny", with_context=True),
      "context_small": ExperimentConfig(size="small", with_context=True),
      "context_base": ExperimentConfig(size="base", with_context=True),
      "context_large": ExperimentConfig(size="large", with_context=True),
      "ar_tiny": ExperimentConfig(size="tiny", with_context=False,
                                  model_family="autoregressive"),
      "ar_small": ExperimentConfig(size="small", with_context=False,
                                   model_family="autoregressive"),
      "ar_base": ExperimentConfig(size="base", with_context=False,
                                  model_family="autoregressive"),
  }
  for sz in ("tiny", "small", "base"):
    presets[f"ismir2021_{sz}"] = ExperimentConfig(
        size=sz, with_context=False,
        task_lengths=TaskLengths(inputs=2048, targets=512,
                                 targets_context=512),
        train=TrainConfig(train_steps=400_000),
        num_velocity_bins=127, include_ties=False,
        program_granularity="flat")
  if name not in presets:
    raise ValueError(f"Unknown preset {name!r}; have {sorted(presets)}")
  return presets[name]
