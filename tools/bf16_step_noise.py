"""How far two bf16 training steps of context_tiny lie apart, and from the
float32 step, on the CPU: the noise floor that the bf16 training checks
(tests/test_torch_train_bf16.py, chip_smoke.py phase 20) are set against.

    JAX_PLATFORMS=cpu python tools/bf16_step_noise.py [--loss_norm l1|l2]

One step of the JAX package's context_tiny (batch 2, no dropout, a real
key, every attention through its Pallas kernels in interpret mode) in
float32 with float32 products (mxu_bf16 off) and in bfloat16 (mxu_bf16
on), and the PyTorch port's step in float32 and bfloat16 from the same
params and JAX's draws. Prints, over the gradients, the largest max |diff|
over the max and the largest and median relative RMS of: JAX bf16 vs JAX
f32, port bf16 vs JAX f32, port bf16 vs JAX bf16, port f32 vs JAX f32;
then the losses. Imports JAX and the JAX package (a tool beside the port,
not part of it); takes about a minute.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import torch

from music_spectrogram_diffusion_tpu import config as jax_config
from music_spectrogram_diffusion_tpu.audio import codecs as jax_codecs
from music_spectrogram_diffusion_tpu.models import layers as jax_layers
from music_spectrogram_diffusion_tpu.models.diffusion import (
    model as jax_model, network as jax_network)
from music_spectrogram_diffusion_tpu.ops import attention as jax_attention
from music_spectrogram_diffusion_tpu.ops import diffusion as jd
from music_spectrogram_diffusion_tpu_torch import config, convert
from music_spectrogram_diffusion_tpu_torch.audio import codecs
from music_spectrogram_diffusion_tpu_torch.models.diffusion import (
    model, network)
from music_spectrogram_diffusion_tpu_torch.ops import diffusion as d


def batch_of(rows: int = 2) -> dict:
  r = np.random.RandomState(0)
  batch = {
      "encoder_input_tokens": r.randint(1, 200, (rows, 24)).astype(np.int32),
      "encoder_continuous_inputs": (r.randn(rows, 16, 128) * 3 - 4).astype(
          np.float32),
      "encoder_continuous_mask": np.ones((rows, 16), bool),
      "decoder_target_tokens": (r.randn(rows, 16, 128) * 3 - 4).astype(
          np.float32),
      "decoder_target_mask": np.ones((rows, 16), bool),
  }
  batch["encoder_input_tokens"][-1, 10:] = 0
  batch["encoder_continuous_mask"][0, 9:] = False
  return batch


def jax_step(batch, dtype: str, mxu_bf16: bool, loss_norm: str, params=None):
  """(params, loss, {path: gradient}, draws) of JAX's step."""
  jax_attention.DEFAULT_MXU_BF16 = mxu_bf16
  cfg = jd.DiffusionConfig(loss_norm=loss_norm)
  jm = jax_model.ContextDiffusionModel(
      jax_network.ContextTransformer(config=jax_config.network_config(
          "tiny", with_context=True, vocab_size=256, dropout_rate=0.0,
          dtype=dtype)), cfg, jax_codecs.MelGan())
  if params is None:
    params = jax.jit(lambda key: jm.init_variables(
        key, {k: v.shape for k, v in batch.items()},
        {k: v.dtype for k, v in batch.items()}))(
            jax.random.PRNGKey(0))["params"]
  key = jax.random.PRNGKey(3)
  jb = {k: jnp.asarray(v) for k, v in batch.items()}
  (loss, _), grads = jax.value_and_grad(
      lambda p: jm.loss_fn(p, jb, key), has_aux=True)(params)
  targets = jm.audio_codec.scale_features(
      jb["decoder_target_tokens"], output_range=(-1.0, 1.0), clip=True)
  _, eps, time, include = jd.training_input(jax.random.split(key)[1],
                                            targets, cfg)
  flat = convert.flatten(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                      grads))
  return params, float(loss), flat, (eps, time, include)


def port_step(batch, params, dtype: str, loss_norm: str, draws):
  module = network.ContextTransformer(config.network_config(
      "tiny", with_context=True, vocab_size=256, dropout_rate=0.0,
      dtype=dtype))
  module.load_state_dict(convert.flax_to_state_dict(params, module))
  pm = model.ContextDiffusionModel(
      module, d.DiffusionConfig(loss_norm=loss_norm), codecs.MelGan())
  arrays = [torch.from_numpy(np.array(x)) for x in draws]
  loss, _ = pm.loss_fn({k: torch.from_numpy(v) for k, v in batch.items()},
                       lambda x0, cfg: tuple(arrays))
  loss.backward()
  named = dict(module.named_parameters())
  return loss.item(), {
      path: named[convert.torch_name(path)].grad.numpy()
      for path in convert.flatten(jax.tree.map(np.asarray, params))
      if named[convert.torch_name(path)].requires_grad}


def gaps(got, want) -> tuple:
  """(largest max-rel, largest relative RMS, median relative RMS)."""
  max_rel, rms = [], []
  for path, g in got.items():
    w = want[path].reshape(g.shape)
    scale = np.abs(w).max()
    if scale > 0:
      max_rel.append(np.abs(g - w).max() / scale)
      rms.append(np.sqrt(np.mean((g - w) ** 2) / np.mean(w ** 2)))
  return max(max_rel), max(rms), float(np.median(rms))


def main():
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--loss_norm", default="l2", choices=["l1", "l2"])
  args = parser.parse_args()
  jax_layers.FLASH_MIN_SCORE_BYTES = 0  # every attention through Pallas
  batch = batch_of()
  params, loss32, g32, draws = jax_step(batch, "float32", False,
                                        args.loss_norm)
  _, loss16, g16, _ = jax_step(batch, "bfloat16", True, args.loss_norm,
                               params)
  port16_loss, p16 = port_step(batch, params, "bfloat16", args.loss_norm,
                               draws)
  port32_loss, p32 = port_step(batch, params, "float32", args.loss_norm,
                               draws)
  print(f"loss {args.loss_norm}: gradients, largest max-rel / largest "
        f"relative RMS / median relative RMS")
  for name, (a, b) in {"JAX bf16 vs JAX f32": (g16, g32),
                       "port bf16 vs JAX f32": (p16, g32),
                       "port bf16 vs JAX bf16": (p16, g16),
                       "port f32 vs JAX f32": (p32, g32)}.items():
    print(f"  {name}: " + " / ".join(f"{x:.4g}" for x in gaps(
        {k: v for k, v in a.items() if k in b}, b)))
  print(f"  losses: JAX f32 {loss32:.7g}, JAX bf16 {loss16:.7g}, port bf16 "
        f"{port16_loss:.7g}, port f32 {port32_loss:.7g}")


if __name__ == "__main__":
  main()
