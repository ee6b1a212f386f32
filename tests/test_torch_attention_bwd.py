"""The port's flash-attention gradients against the JAX package's.

On the CPU `flash_attention_diff` in float32 is autograd through the plain
version, and `flash_attention_bwd` runs `flash_attention_bwd_reference`, the plain
version of the backward kernel's arithmetic (p rebuilt from the forward's
row max and sum). Both are held against `jax.grad` of the JAX package's
`attention_reference` and against its fused `flash_attention_diff` (Pallas
interpret mode, f32 products), in the cases of tests/test_attention.py's
VJP tests. Tolerance 1e-4, as those tests use: f32 throughout, sums in
other orders.

An all-masked key row is the exception, and a finding about the reference:
JAX's fused backward rebuilds p = exp(s - lse) from lse alone, and with
every score at -1e10 lse rounds to -1e10, so p is 1 where the forward used
1 / kv_len. The port matches the plain gradient there; the test records
JAX's fused difference.

The CUDA kernel itself is held against the plain version by the
`cuda`-marked test at the end, on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_spectrogram_diffusion_tpu.ops import attention as jax_attention
from music_spectrogram_diffusion_tpu_torch.ops import attention

TOL = dict(rtol=1e-4, atol=1e-4)

# name: (b, q, kv, h, d, bias, kv_mask, kv_transposed, jax kwargs), the
# cases of tests/test_attention.py:183-237 and the transposed layout.
CASES = {
    "no_bias": (2, 16, 32, 4, 64, None, None, False, {}),
    "kv_mask_unaligned": (2, 12, 200, 2, 64, None, "every_third", False,
                          dict(kv_block_size=128)),
    "mask_bias": (2, 16, 32, 4, 64, "second_half", None, False, {}),
    "multi_kv_blocks_head_groups": (2, 16, 640, 4, 64, None, None, False,
                                    dict(kv_block_size=256,
                                         head_block_size=2)),
    "transposed_masked": (2, 9, 333, 2, 16, None, "random", True,
                          dict(kv_block_size=128)),
}


def _inputs(b, q, kv, h, d, bias, mask, transposed, seed):
  r = np.random.RandomState(seed)
  kv_shape = (b, h, kv, d) if transposed else (b, kv, h, d)
  a = {"query": r.randn(b, q, h, d).astype(np.float32),
       "key": r.randn(*kv_shape).astype(np.float32),
       "value": r.randn(*kv_shape).astype(np.float32),
       "bias": None, "kv_mask": None}
  if bias == "second_half":
    keep = np.ones((b, 1, q, kv), np.float32)
    keep[..., kv // 2:] = 0
    a["bias"] = np.where(keep > 0, 0.0, -1e10).astype(np.float32)
  if mask == "every_third":
    a["kv_mask"] = np.broadcast_to(np.arange(kv) % 3 != 0, (b, kv)).copy()
  elif mask == "random":
    a["kv_mask"] = r.rand(b, kv) > 0.3
  elif mask == "all_masked_row":
    a["kv_mask"] = r.rand(b, kv) > 0.3
    a["kv_mask"][-1] = False
  return a


def _cotangent(shape):
  """The weights tests/test_attention.py puts on the output."""
  return np.cos(np.arange(int(np.prod(shape))).reshape(shape)).astype(
      np.float32)


def _jax_grads(a, transposed, fused, **kw):
  bias = None if a["bias"] is None else jnp.asarray(a["bias"])
  mask = None if a["kv_mask"] is None else jnp.asarray(a["kv_mask"])
  w = jnp.asarray(_cotangent(a["query"].shape))

  def loss(q, k, v):
    if fused:
      out = jax_attention.flash_attention_diff(
          q, k, v, bias, mask, kv_transposed=transposed, interpret=True,
          mxu_bf16=False, **kw)
    else:
      if transposed:  # the JAX reference takes [b, kv, h, d]
        k, v = jnp.swapaxes(k, 1, 2), jnp.swapaxes(v, 1, 2)
      out = jax_attention.attention_reference(q, k, v, bias, mask)
    return jnp.sum(out * w)

  grads = jax.grad(loss, argnums=(0, 1, 2))(
      *(jnp.asarray(a[k]) for k in ("query", "key", "value")))
  return [np.asarray(g) for g in grads]


def _port_grads(a, transposed):
  t = {k: None if v is None else torch.from_numpy(v) for k, v in a.items()}
  q, k, v = (t[n].clone().requires_grad_() for n in ("query", "key",
                                                      "value"))
  out = attention.flash_attention_diff(q, k, v, t["bias"], t["kv_mask"],
                                       kv_transposed=transposed)
  (out * torch.from_numpy(_cotangent(out.shape))).sum().backward()
  return [x.grad.numpy() for x in (q, k, v)]


def _assert_close(got, want, **tol):
  for g, w, name in zip(got, want, "qkv"):
    np.testing.assert_allclose(g, w, err_msg=f"d{name}", **(tol or TOL))


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_diff_grads_match_jax(case):
  b, q, kv, h, d, bias, mask, transposed, kw = CASES[case]
  a = _inputs(b, q, kv, h, d, bias, mask, transposed,
              seed=20 + sorted(CASES).index(case))
  got = _port_grads(a, transposed)
  _assert_close(got, _jax_grads(a, transposed, fused=False))
  _assert_close(got, _jax_grads(a, transposed, fused=True, **kw))


@pytest.mark.parametrize("transposed", [False, True])
def test_all_masked_row_matches_plain_not_jax_fused(transposed):
  """b=2, q=8, kv=16, h=2, d=8; the second row's keys all masked."""
  a = _inputs(2, 8, 16, 2, 8, None, "all_masked_row", transposed, seed=5)
  got = _port_grads(a, transposed)
  want = _jax_grads(a, transposed, fused=False)
  _assert_close(got, want)
  for g in got:
    assert np.isfinite(g).all()
  # The finding: JAX's fused backward differs on the all-masked row, its
  # dV there kv_len times the plain one (p = 1 instead of 1 / kv_len).
  fused = _jax_grads(a, transposed, fused=True)
  dv_fused, dv_plain = fused[2][1], want[2][1]
  np.testing.assert_allclose(dv_fused, 16 * dv_plain, rtol=1e-4, atol=1e-4)
  assert np.abs(dv_fused - dv_plain).max() > 0.1
  # ... and agrees on the row that has keys.
  _assert_close([f[0] for f in fused], [w[0] for w in want])


BWD_CASES = {
    # name: (b, q, kv, h, d, bias heads, mask, transposed)
    "plain": (2, 12, 20, 3, 16, 0, None, False),
    "per_head_bias_masked": (2, 9, 70, 2, 32, 2, "random", False),
    "shared_bias_transposed": (1, 16, 40, 2, 8, 1, "random", True),
    "all_masked_row": (2, 8, 16, 2, 8, 0, "all_masked_row", False),
    "all_masked_row_transposed": (2, 8, 16, 2, 8, 0, "all_masked_row", True),
}


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_bwd_reference_matches_autograd(case):
  """flash_attention_bwd (its plain version on the CPU), from the forward's
  output and statistics, against autograd through attention_reference."""
  b, q, kv, h, d, bias_heads, mask, transposed = BWD_CASES[case]
  a = _inputs(b, q, kv, h, d, None, mask, transposed, seed=40)
  if bias_heads:
    a["bias"] = np.random.RandomState(41).randn(
        b, bias_heads, q, kv).astype(np.float32)
  t = {k: None if v is None else torch.from_numpy(v) for k, v in a.items()}
  out, stats = attention.flash_attention(
      t["query"], t["key"], t["value"], t["bias"], t["kv_mask"],
      kv_transposed=transposed, return_stats=True)
  assert stats.shape == (2, b, h, q) and stats.dtype == torch.float32
  dout = torch.from_numpy(_cotangent(out.shape))
  launches = attention.flash_attention_bwd.launches
  got = attention.flash_attention_bwd(
      t["query"], t["key"], t["value"], t["bias"], t["kv_mask"], out, stats,
      dout, kv_transposed=transposed)
  assert attention.flash_attention_bwd.launches == launches  # CPU: plain
  qkv = [t[n].clone().requires_grad_() for n in ("query", "key", "value")]
  ref = attention.attention_reference(*qkv, t["bias"], t["kv_mask"],
                                      kv_transposed=transposed)
  ref.backward(dout)
  _assert_close([g.numpy() for g in got], [x.grad.numpy() for x in qkv],
                rtol=1e-5, atol=1e-5)


def test_stats_give_jax_lse():
  """m + log l is the row log-sum-exp the JAX kernel saves; on an
  all-masked row, m and l keep the even average that lse loses."""
  a = _inputs(2, 8, 16, 2, 8, None, "all_masked_row", False, seed=7)
  t = {k: None if v is None else torch.from_numpy(v) for k, v in a.items()}
  _, stats = attention.flash_attention(
      t["query"], t["key"], t["value"], kv_mask=t["kv_mask"],
      return_stats=True)
  _, lse = jax_attention.flash_attention(
      *(jnp.asarray(a[k]) for k in ("query", "key", "value")),
      kv_mask=jnp.asarray(a["kv_mask"]), interpret=True, mxu_bf16=False,
      return_lse=True)
  b, h, q = 2, 2, 8
  lse = np.asarray(lse).reshape(b, h, -1)[..., :q]
  ours = (stats[0] + torch.log(stats[1])).numpy()
  np.testing.assert_allclose(ours[0], lse[0], rtol=1e-5, atol=1e-5)
  np.testing.assert_array_equal(stats[1, 1].numpy(), 16.0)  # kv_len


def test_value_scale_equals_weight_dropout():
  """Attention dropout that keeps a key for every query of a head, folded
  in as a scale on the value rows, equals dropping the softmax weights
  (tests/test_attention.py's identity, through the port's diff path)."""
  r = np.random.RandomState(24)
  q, k, v = (torch.from_numpy(r.randn(*s).astype(np.float32))
             for s in ((1, 8, 2, 16), (1, 32, 2, 16), (1, 32, 2, 16)))
  keep = torch.from_numpy((r.rand(1, 2, 32) > 0.5).astype(np.float32) / 0.5)
  got = attention.flash_attention_diff(
      q, k, v * keep.transpose(1, 2)[..., None])
  weights = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
  want = torch.einsum("bhqk,bkhd->bqhd", weights * keep[:, :, None, :], v)
  np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                             atol=1e-5)


def test_bwd_refuses_what_the_kernel_does_not_take():
  q = torch.zeros(1, 4, 2, 8)
  kv = torch.zeros(1, 6, 2, 8)
  stats = torch.ones(2, 1, 2, 4)
  # One dtype for q, k, v, out and dout (float32 or bfloat16).
  with pytest.raises(TypeError, match="one dtype"):
    attention.flash_attention_bwd(q.bfloat16(), kv.bfloat16(), kv.bfloat16(),
                                  None, None, q, stats, q.bfloat16())
  with pytest.raises(TypeError, match="one dtype"):
    attention.flash_attention_bwd(q, kv, kv, None, None, q, stats,
                                  q.bfloat16())
  with pytest.raises(TypeError, match="dtypes differ"):
    attention.flash_attention_bwd(q, kv.bfloat16(), kv, None, None, q, stats,
                                  q)
  with pytest.raises(ValueError, match="stats"):
    attention.flash_attention_bwd(q, kv, kv, None, None, q, stats[:, :, :1],
                                  q)
  with pytest.raises(ValueError, match="dout"):
    attention.flash_attention_bwd(q, kv, kv, None, None, q, stats, q[:, :3])


@pytest.mark.cuda
def test_cuda_bwd_kernel_matches_plain():
  """On the card: the backward kernel against its plain version and
  autograd, an all-masked row finite, two launches bitwise equal."""
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU and nvcc")
  g = torch.Generator("cuda").manual_seed(0)
  b, q, kv, h, d = 2, 100, 150, 3, 64
  qq = torch.randn(b, q, h, d, device="cuda", generator=g) * d ** -0.5
  k = torch.randn(b, kv, h, d, device="cuda", generator=g)
  v = torch.randn(b, kv, h, d, device="cuda", generator=g)
  mask = torch.rand(b, kv, device="cuda", generator=g) > 0.3
  mask[-1] = False
  out, stats = attention.flash_attention(qq, k, v, kv_mask=mask,
                                         return_stats=True)
  dout = torch.randn(out.shape, device="cuda", generator=g)
  got = attention.flash_attention_bwd(qq, k, v, None, mask, out, stats, dout)
  again = attention.flash_attention_bwd(qq, k, v, None, mask, out, stats,
                                        dout)
  want = attention.flash_attention_bwd_reference(qq, k, v, None, mask, out,
                                                 stats, dout)
  for x, y, z in zip(got, again, want):
    assert torch.isfinite(x).all()
    assert torch.equal(x, y)
    torch.testing.assert_close(x, z, rtol=1e-4, atol=1e-4)
