"""Ready-to-predict model from a config and weights.

Port of music_spectrogram_diffusion_tpu/infer/inference.py. The weights
come from a port `state_dict` (for a JAX checkpoint: `convert.py` on its
params tree) or are drawn at random from a seed; the orbax restore stays
in the JAX package. The port serves the context diffusion family in
float32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import torch

from music_spectrogram_diffusion_tpu_torch import config as cfg_lib
from music_spectrogram_diffusion_tpu_torch.audio import codecs
from music_spectrogram_diffusion_tpu_torch.models.diffusion import (
    model as diffusion_model, network as diffusion_network)


def resolve_device(device) -> torch.device:
  """torch.device(device), refusing 'cuda' where there is no card: the port
  runs on the CPU only when the caller asks for it."""
  dev = torch.device(device)
  if dev.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError(
        f"device {str(dev)!r} requested but torch.cuda.is_available() is "
        "False; pass device='cpu' to run on the CPU")
  return dev


def build_model(experiment: cfg_lib.ExperimentConfig,
                *,
                state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                seed: int = 0,
                device="cuda") -> diffusion_model.ContextDiffusionModel:
  """The model an ExperimentConfig describes, on `device`.

  Weights: `state_dict` if given, else random from `seed` (drawn on the
  CPU, so a seed gives the same weights on every device).
  """
  if experiment.model_family != "diffusion" or not experiment.with_context:
    raise NotImplementedError(
        f"{experiment.model_family} (with_context={experiment.with_context})"
        " is not ported yet; the port serves the context diffusion family")
  dev = resolve_device(device)
  module = diffusion_network.ContextTransformer(experiment.network())
  if state_dict is not None:
    module.load_state_dict(state_dict, strict=True)
  else:
    module.init_weights(torch.Generator().manual_seed(seed))
  module.to(dev).eval()
  return diffusion_model.ContextDiffusionModel(
      module, experiment.diffusion, codecs.get_codec(experiment.codec_name))


def with_sampler(experiment: cfg_lib.ExperimentConfig, *,
                 sampler_steps: Optional[int] = None,
                 sampler_name: Optional[str] = None,
                 guidance_interval: Optional[Tuple[float, float]] = None
                 ) -> cfg_lib.ExperimentConfig:
  """The experiment with its sampler steps, family or guidance interval
  replaced (None keeps the experiment's own)."""
  diffusion = experiment.diffusion
  overrides = {}
  if sampler_steps is not None:
    overrides["num_steps"] = sampler_steps
  if sampler_name is not None:
    overrides["name"] = sampler_name
  if overrides:
    diffusion = dataclasses.replace(
        diffusion, sampler=dataclasses.replace(diffusion.sampler,
                                               **overrides))
  if guidance_interval is not None:
    diffusion = dataclasses.replace(
        diffusion, guidance=dataclasses.replace(
            diffusion.guidance, interval=tuple(guidance_interval)))
  return dataclasses.replace(experiment, diffusion=diffusion)


class InferenceModel:
  """A built model plus its task lengths; the serving entry point."""

  def __init__(self, experiment: cfg_lib.ExperimentConfig,
               *,
               state_dict: Optional[Mapping[str, torch.Tensor]] = None,
               seed: int = 0,
               device="cuda"):
    """See `build_model`; `with_sampler` changes the sampler first."""
    self.experiment = experiment
    self.model = build_model(experiment, state_dict=state_dict, seed=seed,
                             device=device)

  @property
  def task_lengths(self) -> Dict[str, int]:
    tl = self.experiment.task_lengths
    return {"inputs": tl.inputs, "targets": tl.targets,
            "targets_context": tl.targets_context}

  @property
  def audio_codec(self) -> codecs.MelGan:
    return self.model.audio_codec

  def synthesizer(self, vocoder=None):
    from music_spectrogram_diffusion_tpu_torch.infer import synthesize
    return synthesize.Synthesizer(self.model, self.task_lengths,
                                  vocoder=vocoder)
