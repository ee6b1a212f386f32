"""The port's flash-attention wrapper against the JAX package's kernel.

On the CPU the port runs its plain version; the JAX kernel runs in Pallas
interpret mode with f32 products (as tests/test_attention.py runs it).
Tolerance 1e-5: both sides are float32 throughout and differ only in the
order of the softmax sums. The CUDA kernel itself is held against the plain
version by the `cuda`-marked test below, on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_spectrogram_diffusion_tpu.ops import attention as jax_attention
from music_spectrogram_diffusion_tpu_torch.ops import attention

CASES = {
    # name: (b, q, kv, h, d, bias_heads, mask, kv_transposed, kv_block)
    "no_bias": (2, 16, 32, 4, 64, 0, False, False, None),
    "per_head_bias": (2, 16, 32, 2, 64, 2, False, False, None),
    "shared_bias_and_mask": (2, 8, 256, 2, 64, 1, True, False, 128),
    "key_mask_all_masked_row": (2, 12, 40, 2, 32, 0, True, False, None),
    "kv_transposed": (2, 16, 48, 3, 64, 0, True, True, None),
    "ragged_kv": (1, 12, 200, 2, 64, 0, True, False, 128),
    "ragged_kv_transposed_multi_block": (2, 9, 333, 2, 16, 0, True, True,
                                         128),
}


def _inputs(b, q, kv, h, d, bias_heads, mask, kv_transposed, seed):
  r = np.random.RandomState(seed)
  kv_shape = (b, h, kv, d) if kv_transposed else (b, kv, h, d)
  arrays = {
      "query": r.randn(b, q, h, d).astype(np.float32),
      "key": r.randn(*kv_shape).astype(np.float32),
      "value": r.randn(*kv_shape).astype(np.float32),
      "bias": (r.randn(b, bias_heads, q, kv).astype(np.float32)
               if bias_heads else None),
      "kv_mask": None,
  }
  if mask:
    keep = r.rand(b, kv) > 0.3
    keep[-1] = False  # a batch row whose keys are all masked
    arrays["kv_mask"] = keep
  return arrays


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax_flash_attention(case):
  b, q, kv, h, d, bias_heads, mask, transposed, kv_block = CASES[case]
  a = _inputs(b, q, kv, h, d, bias_heads, mask, transposed,
              seed=sorted(CASES).index(case))
  want = jax_attention.flash_attention(
      *(jnp.asarray(a[k]) if a[k] is not None else None
        for k in ("query", "key", "value", "bias")),
      kv_mask=None if a["kv_mask"] is None else jnp.asarray(a["kv_mask"]),
      kv_transposed=transposed, interpret=True, mxu_bf16=False,
      kv_block_size=kv_block)
  t = {k: torch.from_numpy(v) if v is not None else None
       for k, v in a.items()}
  launches = attention.flash_attention.launches
  got = attention.flash_attention(t["query"], t["key"], t["value"],
                                  t["bias"], t["kv_mask"],
                                  kv_transposed=transposed)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                             atol=1e-5)
  # CPU tensors take the plain version and launch nothing.
  assert attention.flash_attention.launches == launches


def test_all_masked_row_is_the_even_average():
  a = _inputs(2, 4, 10, 1, 8, 0, True, False, seed=3)
  got = attention.flash_attention(
      *(torch.from_numpy(a[k]) for k in ("query", "key", "value")),
      kv_mask=torch.from_numpy(a["kv_mask"]))
  even = a["value"][-1].mean(axis=0)  # [h, d]
  np.testing.assert_allclose(got[-1].numpy(),
                             np.broadcast_to(even, got[-1].shape),
                             rtol=1e-5, atol=1e-6)


def test_transpose_kv_matches_jax():
  r = np.random.RandomState(0)
  k = r.randn(2, 5, 3, 4).astype(np.float32)
  v = r.randn(2, 5, 3, 4).astype(np.float32)
  want = jax_attention.transpose_kv(jnp.asarray(k), jnp.asarray(v))
  got = attention.transpose_kv(torch.from_numpy(k), torch.from_numpy(v))
  for g, w in zip(got, want):
    assert g.is_contiguous()
    np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _bad_calls():
  q = torch.zeros(1, 4, 2, 8)
  kv = torch.zeros(1, 6, 2, 8)
  return {
      "query_not_4d": ((q[0], kv, kv), {}),
      "kv_head_mismatch": ((q, torch.zeros(1, 6, 3, 8),
                            torch.zeros(1, 6, 3, 8)), {}),
      "head_dim_over_128": ((torch.zeros(1, 4, 1, 129),
                             torch.zeros(1, 6, 1, 129),
                             torch.zeros(1, 6, 1, 129)), {}),
      "float16": ((q.half(), kv.half(), kv.half()), {}),
      "mixed_dtypes": ((q, kv.bfloat16(), kv), {}),
      "mask_not_bool": ((q, kv, kv), {"kv_mask": torch.ones(1, 6)}),
      "mask_wrong_shape": ((q, kv, kv),
                           {"kv_mask": torch.ones(1, 5, dtype=torch.bool)}),
      "bias_wrong_heads": ((q, kv, kv, torch.zeros(1, 3, 4, 6)), {}),
      "bias_not_f32": ((q, kv, kv, torch.zeros(1, 1, 4, 6).double()), {}),
      "not_contiguous": ((q.transpose(1, 2).contiguous().transpose(1, 2),
                          kv, kv), {}),
      "layout_mismatch": ((q, kv, kv), {"kv_transposed": True}),
  }


@pytest.mark.parametrize("name", sorted(_bad_calls()))
def test_wrapper_rejects_what_the_kernel_does_not_take(name):
  args, kwargs = _bad_calls()[name]
  with pytest.raises((ValueError, TypeError)):
    attention.flash_attention(*args, **kwargs)


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
  return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_kernel_matches_plain_version_on_card(cuda_device, dtype, tol):
  for case in sorted(CASES):
    b, q, kv, h, d, bias_heads, mask, transposed, _ = CASES[case]
    a = _inputs(b, q, kv, h, d, bias_heads, mask, transposed, seed=1)
    t = {k: (torch.from_numpy(v).to(cuda_device) if v is not None else None)
         for k, v in a.items()}
    qkv = [t[k].to(dtype) for k in ("query", "key", "value")]
    before = attention.flash_attention.launches
    got = attention.flash_attention(*qkv, t["bias"], t["kv_mask"],
                                    kv_transposed=transposed)
    torch.cuda.synchronize()
    assert attention.flash_attention.launches == before + 1
    want = attention.attention_reference(*qkv, t["bias"], t["kv_mask"],
                                         kv_transposed=transposed)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, (case, err)
