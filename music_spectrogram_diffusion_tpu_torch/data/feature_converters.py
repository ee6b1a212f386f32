"""Task features -> model batch conversion.

music_spectrogram_diffusion_tpu/data/feature_converters.py, copied: trims
and pads task features to fixed lengths and emits the model's batch schema
(`ContinuousOutputsFeatureConverter` for the notes-only and autoregressive
models, `ContinuousContextFeatureConverter` for the context model).
Packing is not supported (2D continuous targets, all equal length).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from music_spectrogram_diffusion_tpu_torch.data import core

Example = core.Example


def _trim_pad_1d(x: np.ndarray, length: int, pad_value=0) -> np.ndarray:
  x = np.asarray(x)[:length]
  if len(x) < length:
    pad = [(0, length - len(x))] + [(0, 0)] * (x.ndim - 1)
    x = np.pad(x, pad, constant_values=pad_value)
  return x


def _length_mask(actual: int, max_len: int) -> np.ndarray:
  return (np.arange(max_len) < actual)


class ContinuousOutputsFeatureConverter:
  """inputs/targets -> encoder tokens + decoder continuous targets.

  Emits (reference feature_converters.py:23-120):
    encoder_input_tokens   int32 [L_in]
    decoder_target_tokens  f32   [L_tgt, D]
    decoder_input_tokens   f32   [L_tgt, D]  (teacher forcing, shifted)
    decoder_target_mask    bool  [L_tgt]
  """

  def __init__(self, pack: bool = False):
    if pack:
      raise NotImplementedError("packing not supported for 2D features")

  def __call__(self, ex: Example,
               task_feature_lengths: Mapping[str, int]) -> Example:
    targets = np.asarray(ex["targets"], np.float32)
    l_tgt = task_feature_lengths["targets"]
    decoder_target = _trim_pad_1d(targets, l_tgt)
    # Autoregressive shift: input t receives target t-1 (zeros first).
    decoder_input = np.roll(decoder_target, 1, axis=0)
    decoder_input[0] = 0.0
    return {
        "encoder_input_tokens": _trim_pad_1d(
            np.asarray(ex["inputs"], np.int32),
            task_feature_lengths["inputs"]),
        "decoder_target_tokens": decoder_target,
        "decoder_input_tokens": decoder_input,
        "decoder_target_mask": _length_mask(
            min(targets.shape[0], l_tgt), l_tgt),
    }

  def model_feature_lengths(
      self, task_feature_lengths: Mapping[str, int]) -> Mapping[str, int]:
    return {
        "encoder_input_tokens": task_feature_lengths["inputs"],
        "decoder_target_tokens": task_feature_lengths["targets"],
        "decoder_input_tokens": task_feature_lengths["targets"],
        "decoder_target_mask": task_feature_lengths["targets"],
    }


class ContinuousContextFeatureConverter:
  """Adds the previous-segment context features.

  Emits (reference models/diffusion/feature_converters.py:23-121):
    encoder_input_tokens      int32 [L_in]
    encoder_continuous_inputs f32   [L_ctx, D]
    encoder_continuous_mask   bool  [L_ctx]
    decoder_target_tokens     f32   [L_tgt, D]
    decoder_target_mask       bool  [L_tgt]
  """

  def __init__(self, pack: bool = False):
    if pack:
      raise NotImplementedError("packing not supported for 2D features")

  def __call__(self, ex: Example,
               task_feature_lengths: Mapping[str, int]) -> Example:
    targets = np.asarray(ex["targets"], np.float32)
    context = np.asarray(ex["targets_context"], np.float32)
    l_tgt = task_feature_lengths["targets"]
    l_ctx = task_feature_lengths["targets_context"]

    if context.size == 0:
      context = np.zeros((0, targets.shape[-1]), np.float32)

    return {
        "encoder_input_tokens": _trim_pad_1d(
            np.asarray(ex["inputs"], np.int32),
            task_feature_lengths["inputs"]),
        "encoder_continuous_inputs": _trim_pad_1d(context, l_ctx),
        "encoder_continuous_mask": _length_mask(
            min(context.shape[0], l_ctx), l_ctx),
        "decoder_target_tokens": _trim_pad_1d(targets, l_tgt),
        "decoder_target_mask": _length_mask(
            min(targets.shape[0], l_tgt), l_tgt),
    }

  def model_feature_lengths(
      self, task_feature_lengths: Mapping[str, int]) -> Mapping[str, int]:
    return {
        "encoder_input_tokens": task_feature_lengths["inputs"],
        "encoder_continuous_inputs":
            task_feature_lengths["targets_context"],
        "encoder_continuous_mask":
            task_feature_lengths["targets_context"],
        "decoder_target_tokens": task_feature_lengths["targets"],
        "decoder_target_mask": task_feature_lengths["targets"],
    }


def convert_dataset(ds: core.Dataset, converter,
                    task_feature_lengths: Mapping[str, int]) -> core.Dataset:
  """Apply a feature converter over a Dataset."""
  return ds.map(lambda ex: converter(ex, task_feature_lengths))
