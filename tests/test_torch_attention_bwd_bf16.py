"""The port's bf16 flash-attention backward against the JAX package's.

JAX's fused backward (`flash_attention_diff`, Pallas interpret mode,
mxu_bf16=True) on bf16 inputs takes its products on bf16 operands with f32
sums, rounds p and dS to bf16 before the products that use them, computes
delta in f32 and returns the gradients in the inputs' dtype. On the CPU the
port's `flash_attention_diff` in bf16 runs the kernels' plain versions,
whose backward (`flash_attention_bwd_reference`) rounds at the same
places. Each gradient is held to 2^-6 of JAX's largest entry (the bf16
forward kernel's limit, a few bf16 steps: the two round the outputs once
each, and the sums run in other orders).

As in tests/test_torch_attention_bwd.py, a batch row whose keys are all
masked is the exception: JAX rebuilds p = exp(s - lse) from lse alone, and
with every score at -1e10 lse rounds to -1e10, so p is 1 where the forward
used 1 / kv_len; the test records that JAX's gradients there are kv_len
times the port's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_spectrogram_diffusion_tpu.ops import attention as jax_attention
from music_spectrogram_diffusion_tpu_torch.ops import attention

LIMIT = 2.0 ** -6

# name: (b, q, kv, h, d, kv_mask, kv_transposed, jax kwargs)
CASES = {
    "masked_multi_kv_blocks": (2, 16, 200, 2, 64, "every_third", False,
                               dict(kv_block_size=128)),
    "transposed_masked": (2, 9, 150, 2, 32, "random", True,
                          dict(kv_block_size=128)),
    "all_masked_row": (2, 8, 16, 2, 8, "all_masked_row", False, {}),
}


def _inputs(b, q, kv, h, d, mask, transposed, seed):
  r = np.random.RandomState(seed)
  kv_shape = (b, h, kv, d) if transposed else (b, kv, h, d)
  a = {"query": (r.randn(b, q, h, d) * d ** -0.5).astype(np.float32),
       "key": r.randn(*kv_shape).astype(np.float32),
       "value": r.randn(*kv_shape).astype(np.float32)}
  if mask == "every_third":
    a["kv_mask"] = np.broadcast_to(np.arange(kv) % 3 != 0, (b, kv)).copy()
  else:
    a["kv_mask"] = r.rand(b, kv) > 0.3
    if mask == "all_masked_row":
      a["kv_mask"][-1] = False
  return a


def _cotangent(shape):
  return np.cos(np.arange(int(np.prod(shape))).reshape(shape)).astype(
      np.float32)


def _jax_grads(a, transposed, **kw):
  w = jnp.asarray(_cotangent(a["query"].shape))
  mask = jnp.asarray(a["kv_mask"])

  def loss(q, k, v):
    out = jax_attention.flash_attention_diff(
        q, k, v, None, mask, kv_transposed=transposed, interpret=True,
        mxu_bf16=True, **kw)
    assert out.dtype == jnp.bfloat16
    return jnp.sum(out.astype(jnp.float32) * w)

  grads = jax.grad(loss, argnums=(0, 1, 2))(
      *(jnp.asarray(a[k]).astype(jnp.bfloat16)
        for k in ("query", "key", "value")))
  assert all(g.dtype == jnp.bfloat16 for g in grads)
  return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _port_grads(a, transposed):
  q, k, v = (torch.from_numpy(a[n]).to(torch.bfloat16).requires_grad_()
             for n in ("query", "key", "value"))
  out = attention.flash_attention_diff(q, k, v, None,
                                       torch.from_numpy(a["kv_mask"]),
                                       kv_transposed=transposed)
  assert out.dtype == torch.bfloat16
  (out.float() * torch.from_numpy(_cotangent(out.shape))).sum().backward()
  assert all(x.grad.dtype == torch.bfloat16 for x in (q, k, v))
  return [x.grad.float().numpy() for x in (q, k, v)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_grads_match_jax_fused(case):
  b, q, kv, h, d, mask, transposed, kw = CASES[case]
  a = _inputs(b, q, kv, h, d, mask, transposed,
              seed=60 + sorted(CASES).index(case))
  got = _port_grads(a, transposed)
  want = _jax_grads(a, transposed, **kw)
  rows = slice(0, b - 1) if mask == "all_masked_row" else slice(None)
  for name, g, w in zip("qkv", got, want):
    assert np.isfinite(g).all()
    g_rows, w_rows = g[rows], w[rows]
    err = np.abs(g_rows - w_rows).max()
    assert err <= LIMIT * np.abs(w_rows).max(), (name, err)
  if mask == "all_masked_row":
    # The finding: on the all-masked row JAX's dV is kv_len times the
    # port's (p = 1 instead of 1 / kv_len), within bf16's rounding.
    np.testing.assert_allclose(want[2][-1], kv * got[2][-1],
                               rtol=2.0 ** -6, atol=2.0 ** -6 * kv)
    assert np.abs(want[2][-1] - got[2][-1]).max() > 0.1


@pytest.mark.parametrize("transposed", [False, True])
def test_bf16_reference_rounds_p_and_ds(transposed):
  """The plain bf16 backward equals the f32 arithmetic with p and dS
  rounded to bf16 before their products and each output rounded once."""
  a = _inputs(2, 12, 40, 2, 16, "random", transposed, seed=70)
  q, k, v = (torch.from_numpy(a[n]).to(torch.bfloat16)
             for n in ("query", "key", "value"))
  mask = torch.from_numpy(a["kv_mask"])
  out, stats = attention.flash_attention(q, k, v, kv_mask=mask,
                                         kv_transposed=transposed,
                                         return_stats=True)
  dout = torch.from_numpy(_cotangent(out.shape)).to(torch.bfloat16)
  got = attention.flash_attention_bwd_reference(
      q, k, v, None, mask, out, stats, dout, kv_transposed=transposed)
  assert [g.dtype for g in got] == [torch.bfloat16] * 3
  k_sub = "bhkd" if transposed else "bkhd"
  s = torch.einsum(f"bqhd,{k_sub}->bhqk", q.float(), k.float())
  s = s + ((mask.float() - 1.0) * 1e10)[:, None, None, :]
  p = torch.exp(s - stats[0][..., None]) / stats[1][..., None]
  delta = torch.einsum("bqhd,bqhd->bhq", dout.float(), out.float())
  dp = torch.einsum(f"bqhd,{k_sub}->bhqk", dout.float(), v.float())
  ds = (p * (dp - delta[..., None])).to(torch.bfloat16).float()
  p = p.to(torch.bfloat16).float()
  want = (torch.einsum(f"bhqk,{k_sub}->bqhd", ds, k.float()),
          torch.einsum(f"bhqk,bqhd->{k_sub}", ds, q.float()),
          torch.einsum(f"bhqk,bqhd->{k_sub}", p, dout.float()))
  for g, w in zip(got, want):
    assert torch.equal(g, w.to(torch.bfloat16))
  # And the rounding is felt: the f32 arithmetic gives other bits.
  f32 = attention.flash_attention_bwd_reference(
      q.float(), k.float(), v.float(), None, mask, out.float(), stats,
      dout.float(), kv_transposed=transposed)
  assert not torch.equal(got[0], f32[0].to(torch.bfloat16))


def test_bf16_cpu_diff_is_the_plain_versions():
  """On CPU tensors in bf16, flash_attention_diff's backward is
  flash_attention_bwd's plain version, from the forward's output and
  statistics, and launches nothing."""
  a = _inputs(2, 8, 24, 2, 16, "random", False, seed=71)
  q, k, v = (torch.from_numpy(a[n]).to(torch.bfloat16)
             for n in ("query", "key", "value"))
  mask = torch.from_numpy(a["kv_mask"])
  qkv = [x.clone().requires_grad_() for x in (q, k, v)]
  launches = (attention.flash_attention.launches,
              attention.flash_attention_bwd.launches)
  out = attention.flash_attention_diff(*qkv, kv_mask=mask)
  dout = torch.from_numpy(_cotangent(out.shape)).to(torch.bfloat16)
  out.backward(dout)
  assert launches == (attention.flash_attention.launches,
                      attention.flash_attention_bwd.launches)
  ref_out, stats = attention.flash_attention(q, k, v, kv_mask=mask,
                                             return_stats=True)
  assert torch.equal(out.detach(), ref_out)
  want = attention.flash_attention_bwd_reference(q, k, v, None, mask,
                                                 ref_out, stats, dout)
  for x, w in zip(qkv, want):
    assert torch.equal(x.grad, w)


@pytest.mark.cuda
def test_cuda_bf16_bwd_kernel_matches_plain():
  """On the card: the bf16 backward kernel against its plain version, an
  all-masked row finite, two launches bitwise equal, bf16 out."""
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU and nvcc")
  g = torch.Generator("cuda").manual_seed(0)
  b, q, kv, h, d = 2, 100, 150, 3, 64
  qq = (torch.randn(b, q, h, d, device="cuda", generator=g)
        * d ** -0.5).bfloat16()
  k = torch.randn(b, kv, h, d, device="cuda", generator=g).bfloat16()
  v = torch.randn(b, kv, h, d, device="cuda", generator=g).bfloat16()
  mask = torch.rand(b, kv, device="cuda", generator=g) > 0.3
  mask[-1] = False
  out, stats = attention.flash_attention(qq, k, v, kv_mask=mask,
                                         return_stats=True)
  dout = torch.randn(out.shape, device="cuda", generator=g).bfloat16()
  args = (qq, k, v, None, mask, out, stats, dout)
  got = attention.flash_attention_bwd(*args)
  again = attention.flash_attention_bwd(*args)
  want = attention.flash_attention_bwd_reference(*args)
  for x, y, z in zip(got, again, want):
    assert x.dtype == torch.bfloat16
    assert torch.isfinite(x.float()).all()
    assert torch.equal(x, y)
    err = (x.float() - z.float()).abs().max().item()
    assert err <= LIMIT * z.float().abs().max().item()
