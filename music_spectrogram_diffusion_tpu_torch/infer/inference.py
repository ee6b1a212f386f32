"""Ready-to-predict model from a config and weights.

Port of music_spectrogram_diffusion_tpu/infer/inference.py. The weights
come from a port `state_dict`, from a JAX checkpoint exported to `.npz` by
tools/export_jax_checkpoint.py (`load_export`: the experiment from its
config_json, the params through `convert.py`), from a port training
checkpoint (`load_checkpoint`), or are drawn at random from a seed; the
orbax restore stays in the JAX package. The port serves every model
family of the JAX package's `build_model`: the context diffusion model, the
notes-only diffusion model and the autoregressive baseline (with either
output head), in float32, or with `compute_dtype` in bfloat16
(`cast_params_bf16`) or with weight-only int8 kernels on a bfloat16 network
(`ops.quantize`), as the JAX package's InferenceModel does.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from music_spectrogram_diffusion_tpu_torch import config as cfg_lib
from music_spectrogram_diffusion_tpu_torch import convert
from music_spectrogram_diffusion_tpu_torch.audio import codecs
from music_spectrogram_diffusion_tpu_torch.models import layers
from music_spectrogram_diffusion_tpu_torch.models.autoregressive import (
    model as ar_model, network as ar_network, output_functions)
from music_spectrogram_diffusion_tpu_torch.models.diffusion import (
    model as diffusion_model, network as diffusion_network)
from music_spectrogram_diffusion_tpu_torch.ops import diffusion as dops
from music_spectrogram_diffusion_tpu_torch.ops import quantize

COMPUTE_DTYPES = (None, "float32", "bfloat16", "int8")

# What `build_model` returns, by family.
Model = Union[diffusion_model.DiffusionModelBase,
              ar_model.AutoregressiveModel]


def resolve_device(device) -> torch.device:
  """torch.device(device), refusing 'cuda' where there is no card: the port
  runs on the CPU only when the caller asks for it."""
  dev = torch.device(device)
  if dev.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError(
        f"device {str(dev)!r} requested but torch.cuda.is_available() is "
        "False; pass device='cpu' to run on the CPU")
  return dev


def cast_params_bf16(state: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
  """Cast float32 tensors to bfloat16 for serving.

  As the JAX package's `cast_params_bf16`: every float32 tensor is cast,
  position tables, norm scales, embeddings and FiLM kernels included,
  except those under `spec_out_dense` (the output projection, computed in
  float32). The scales of int8 kernels stay float32, as the kernel takes
  them.
  """
  def keep(name: str, tensor: torch.Tensor) -> bool:
    parts = name.split(".")
    return (tensor.dtype != torch.float32 or "spec_out_dense" in parts
            or parts[-1] == "kernel_scale")
  return {name: t if keep(name, t) else t.to(torch.bfloat16)
          for name, t in state.items()}


def load_serving_state_(module: nn.Module,
                        state: Mapping[str, torch.Tensor]) -> None:
  """Load `state` into `module` keeping each tensor's dtype (strict).

  Every DenseGeneral whose `kernel_scale` the state holds takes its int8
  form first; every other parameter takes the state's dtype, so a
  bfloat16 tensor is stored, not converted on each call. A float
  DenseGeneral that computes in another dtype than its kernel's (FiLM
  computes in float32 in a bfloat16 network) stores the kernel's values in
  its compute dtype: bf16-rounded values held in float32, as the JAX
  package's FiLM computes with them, and no per-call cast.
  """
  for prefix, sub in module.named_modules():
    if (isinstance(sub, layers.DenseGeneral)
        and f"{prefix}.kernel_scale" in state and not sub.is_int8):
      layers.quantize_dense_(sub, state[f"{prefix}.kernel"],
                             state[f"{prefix}.kernel_scale"])
  module.load_state_dict(state, strict=True, assign=True)
  for sub in module.modules():
    if (isinstance(sub, layers.DenseGeneral) and not sub.is_int8
        and sub.kernel.dtype != sub.dtype):
      sub.kernel = nn.Parameter(sub.kernel.to(sub.dtype), requires_grad=False)


def serving_experiment(experiment: cfg_lib.ExperimentConfig,
                       compute_dtype: Optional[str]
                       ) -> cfg_lib.ExperimentConfig:
  """The experiment with the network dtype `compute_dtype` asks for: int8
  computes the network in bfloat16; None keeps the experiment's own."""
  if compute_dtype not in COMPUTE_DTYPES:
    raise ValueError(f"compute_dtype {compute_dtype!r} not in "
                     f"{COMPUTE_DTYPES}")
  if compute_dtype is None:
    return experiment
  return dataclasses.replace(
      experiment,
      dtype="bfloat16" if compute_dtype == "int8" else compute_dtype)


def network(experiment: cfg_lib.ExperimentConfig) -> nn.Module:
  """The network of the experiment's family, uninitialized, as the JAX
  package's `build_model` makes it: ContextTransformer, Transformer (notes
  only) or ARTransformer (whose output width follows its head)."""
  net_cfg = experiment.network()
  if experiment.model_family == "autoregressive":
    n_dims = codecs.get_codec(experiment.codec_name).n_dims
    head = output_functions.build(experiment.ar_output, n_dims)
    return ar_network.ARTransformer(ar_network.ARConfig(
        vocab_size=net_cfg.vocab_size, dtype=net_cfg.dtype,
        emb_dim=net_cfg.emb_dim, num_heads=net_cfg.num_heads,
        num_encoder_layers=net_cfg.num_encoder_layers,
        num_decoder_layers=net_cfg.num_decoder_layers,
        head_dim=net_cfg.head_dim, mlp_dim=net_cfg.mlp_dim,
        output_dim=head.expected_num_dims,
        audio_dim=n_dims,
        mlp_activations=net_cfg.mlp_activations,
        dropout_rate=net_cfg.dropout_rate, remat=net_cfg.remat))
  if experiment.model_family != "diffusion":
    raise ValueError(f"unknown model_family: {experiment.model_family}")
  if experiment.with_context:
    return diffusion_network.ContextTransformer(net_cfg)
  return diffusion_network.Transformer(net_cfg)


def wrap(experiment: cfg_lib.ExperimentConfig, module: nn.Module) -> Model:
  """The model (loss and predict) around `network(experiment)`'s module."""
  codec = codecs.get_codec(experiment.codec_name)
  if experiment.model_family == "autoregressive":
    return ar_model.AutoregressiveModel(
        module, output_functions.build(experiment.ar_output, codec.n_dims),
        codec)
  cls = (diffusion_model.ContextDiffusionModel if experiment.with_context
         else diffusion_model.DiffusionModel)
  return cls(module, experiment.diffusion, codec)


def build_model(experiment: cfg_lib.ExperimentConfig,
                *,
                state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                seed: int = 0,
                device="cuda",
                compute_dtype: Optional[str] = None) -> Model:
  """The model an ExperimentConfig describes, on `device`, of any family.

  Weights: `state_dict` if given (float, or an int8 serving state such as
  `convert.py` makes of an int8 Flax tree), else random from `seed` (drawn
  on the CPU in float32, so a seed gives the same weights on every
  device). `compute_dtype` 'bfloat16' casts them with `cast_params_bf16`
  and runs the network in bf16; 'int8' also quantizes every large kernel
  from its bf16 values (`ops.quantize.quantize_params`, as the JAX
  package's `quantize_params(cast_params_bf16(params))`).
  """
  return _build_served(serving_experiment(experiment, compute_dtype),
                       state_dict=state_dict, seed=seed, device=device,
                       compute_dtype=compute_dtype)


def _build_served(experiment: cfg_lib.ExperimentConfig, *, state_dict,
                  seed: int, device, compute_dtype: Optional[str]) -> Model:
  """`build_model` on an experiment `serving_experiment` has resolved."""
  dev = resolve_device(device)
  module = network(experiment)
  if state_dict is None:
    module.init_weights(torch.Generator().manual_seed(seed))
    state = module.state_dict()
  else:
    state = dict(state_dict)
  if compute_dtype in ("bfloat16", "int8"):
    state = cast_params_bf16(state)
  if compute_dtype == "int8":
    state = quantize.quantize_params(state)
  load_serving_state_(module, state)
  module.to(dev).eval().requires_grad_(False)  # serving never trains
  return wrap(experiment, module)


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
               device="cuda",
               compute_dtype: Optional[str] = None,
               step: int = -1):
    """See `build_model`; `with_sampler` changes the sampler first.

    compute_dtype: None or 'float32' (the default: the experiment's own
    dtype), 'bfloat16' or 'int8'. The sampler's state and the output
    projection stay float32 in every case. `step`: the training step of
    the weights (-1: not from a checkpoint).
    """
    self.experiment = serving_experiment(experiment, compute_dtype)
    self.model = _build_served(self.experiment, state_dict=state_dict,
                               seed=seed, device=device,
                               compute_dtype=compute_dtype)
    self.step = step

  @property
  def task_lengths(self) -> Dict[str, int]:
    """The task's lengths; targets_context only for the context model."""
    tl = self.experiment.task_lengths
    out = {"inputs": tl.inputs, "targets": tl.targets}
    if self.experiment.with_context:
      out["targets_context"] = tl.targets_context
    return out

  @property
  def audio_codec(self) -> codecs.MelGan:
    return self.model.audio_codec

  def predict(self, batch: Mapping[str, np.ndarray], seed: int = 0,
              noise: Optional[dops.NoiseFn] = None) -> np.ndarray:
    """One batched segment prediction, numpy in and out: mel features
    [B, L_tgt, n_dims]. `batch` as the model's `predict` takes it. The
    noise is `noise` if given (e.g. replayed draws), else row i's
    generator seeded from (seed, i, 0), as `synthesize.seeded_noise`
    draws a song's first segment."""
    from music_spectrogram_diffusion_tpu_torch.infer import synthesize
    device = self.model.device
    dtypes = {"encoder_input_tokens": torch.int64,
              "encoder_continuous_mask": torch.bool,
              "decoder_target_mask": torch.bool}
    tensors = {k: torch.as_tensor(np.asarray(v), device=device,
                                  dtype=dtypes.get(k, torch.float32))
               for k, v in batch.items()}
    if noise is None:
      rows = tensors["decoder_target_tokens"].shape[0]
      noise = synthesize.seeded_noise(seed, device)(0, rows)
    return self.model.predict(tensors, noise).cpu().numpy()

  def synthesizer(self, vocoder=None, bucket_inputs: bool = True):
    from music_spectrogram_diffusion_tpu_torch.infer import synthesize
    return synthesize.Synthesizer(self.model, self.task_lengths,
                                  vocoder=vocoder,
                                  bucket_inputs=bucket_inputs)


def load_export(path: str, *, device="cuda",
                compute_dtype: Optional[str] = None,
                sampler_steps: Optional[int] = None,
                sampler_name: Optional[str] = None,
                guidance_interval: Optional[Tuple[float, float]] = None
                ) -> InferenceModel:
  """An InferenceModel from a JAX checkpoint (any family) exported to `.npz`
  (tools/export_jax_checkpoint.py): the experiment from its config_json
  (`ExperimentConfig.from_json`), the sampler overrides of
  `with_sampler`, the params through `convert.flax_to_state_dict`.
  Raises ValueError naming the tool for anything that is not an export."""
  params, config_json, step = convert.read_export(path)
  if not config_json:
    raise ValueError(f"{path} has no config_json: not an experiment")
  experiment = with_sampler(cfg_lib.ExperimentConfig.from_json(config_json),
                            sampler_steps=sampler_steps,
                            sampler_name=sampler_name,
                            guidance_interval=guidance_interval)
  state = convert.flax_to_state_dict(params, network(experiment))
  return InferenceModel(experiment, state_dict=state, device=device,
                        compute_dtype=compute_dtype, step=step)


def load_checkpoint(path: str, *, device="cuda",
                    compute_dtype: Optional[str] = None,
                    sampler_steps: Optional[int] = None,
                    sampler_name: Optional[str] = None,
                    guidance_interval: Optional[Tuple[float, float]] = None
                    ) -> InferenceModel:
  """An InferenceModel from a checkpoint: an exported JAX checkpoint
  (`.npz`, `load_export`), or a port training checkpoint, a step_<N>
  directory of `train/checkpoints.py` (or the model directory holding
  them, for the latest), its experiment from `config.json` and its weights
  from the saved state. Anything else (an orbax directory) raises
  ValueError naming tools/export_jax_checkpoint.py."""
  from music_spectrogram_diffusion_tpu_torch.train import checkpoints
  overrides = dict(sampler_steps=sampler_steps, sampler_name=sampler_name,
                   guidance_interval=guidance_interval)
  if not os.path.isdir(path):
    return load_export(path, device=device, compute_dtype=compute_dtype,
                       **overrides)
  step_dir = (path if os.path.basename(os.path.normpath(path)).startswith(
      "step_") else checkpoints.latest_checkpoint(path))
  if step_dir is None or not os.path.exists(
      os.path.join(step_dir, checkpoints.STATE_FILE)):
    convert.read_export(path)  # raises, naming the export tool
  restored = checkpoints.restore_checkpoint(step_dir)
  if "config_json" not in restored:
    raise ValueError(f"{path} has no config.json")
  experiment = with_sampler(cfg_lib.ExperimentConfig.from_json(
      restored["config_json"]), **overrides)
  return InferenceModel(experiment, state_dict=restored["params"],
                        device=device, compute_dtype=compute_dtype,
                        step=int(restored.get("step", -1)))
