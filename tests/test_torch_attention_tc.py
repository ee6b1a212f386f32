"""The arithmetic of the port's tensor-core attention kernels, on the CPU.

The CUDA kernels (`ops/csrc/flash_fwd.cu`, `flash_bwd.cu`) cannot run here;
their new arithmetic has plain versions in `ops/attention.py` that these
tests hold against the plain attention and against the JAX package:

- `split_tf32` / `einsum_3xtf32`: every f32 product of both kernels is three
  TF32 tensor-core products (3xTF32). The split rounds as `cvt.rna.tf32.f32`
  does (checked against an independent frexp rounding), keeps NaN and inf
  (a NaN of any payload stays NaN), and attention and
  its backward taken that way stay within the kernels' f32 tolerances
  (1e-4; 1e-4 x max(1, |grad| max) for gradients) of the f32 plain versions
  and of JAX's kernel (Pallas interpret mode, f32 products), where one TF32
  product alone does not.
- `attention_split_kv_reference`: the forward's split-KV path with its
  combine equals the plain attention and its statistics (1e-5: f32 on both
  sides, sums in another order), with an all-masked batch row and a split
  whose keys are all masked.
- `kv_split`: the policy gives one split where the grid fills the card and
  several for the b=1 cross-attention; every split starts below kv_len.

The `cuda`-marked tests at the end hold the kernels themselves to the same
arithmetic on the card (the split path, the statistics, two launches
bitwise equal, the TF32 rounding against the instruction, NaN in and out);
they skip here. JAX is imported only by the tests that compare with it, so
that the `cuda` tests also run where JAX is not installed
(`pytest --noconftest -m cuda`).
"""

import numpy as np
import pytest
import torch

from music_spectrogram_diffusion_tpu_torch.ops import attention

H100_SMS = 132
# The forward kernel's block shape, (query rows a block, keys a K/V tile),
# as csrc/flash_fwd.cu is built (`attention.fwd_tile`; the card test
# checks it).
F32_TILE, BF16_TILE = (128, 64), (64, 64)


def _jax_flash_attention(a, tr):
  """JAX's kernel on the arrays `a`, Pallas interpret mode, f32 products."""
  import jax.numpy as jnp  # pylint: disable=import-outside-toplevel
  from music_spectrogram_diffusion_tpu.ops import attention as jax_attention  # pylint: disable=import-outside-toplevel
  return np.asarray(jax_attention.flash_attention(
      *(None if a[k] is None else jnp.asarray(a[k])
        for k in ("query", "key", "value", "bias")),
      kv_mask=None if a["kv_mask"] is None else jnp.asarray(a["kv_mask"]),
      kv_transposed=tr, interpret=True, mxu_bf16=False))


def _inputs(b, q, kv, h, d, *, bias=False, mask=False, transposed=False,
            scale=1.0, seed=0):
  r = np.random.RandomState(seed)
  kv_shape = (b, h, kv, d) if transposed else (b, kv, h, d)
  a = {"query": (scale * r.randn(b, q, h, d)).astype(np.float32),
       "key": r.randn(*kv_shape).astype(np.float32),
       "value": r.randn(*kv_shape).astype(np.float32),
       "bias": r.randn(b, 1, q, kv).astype(np.float32) if bias else None,
       "kv_mask": None}
  if mask:
    keep = r.rand(b, kv) > 0.3
    keep[-1] = False  # a batch row whose keys are all masked
    a["kv_mask"] = keep
  return a


def _torch(a):
  return {k: None if v is None else torch.from_numpy(v) for k, v in a.items()}


def _frexp_round_tf32(x):
  """x rounded to 11 significant bits, ties away from zero, via frexp."""
  mant, exp = np.frexp(x.astype(np.float64))
  scaled = np.abs(mant) * 2.0 ** 11
  return (np.sign(mant) * np.floor(scaled + 0.5) * 2.0 ** (exp - 11)).astype(
      np.float32)


# ---- (i) the 3xTF32 split -------------------------------------------------


def test_split_tf32_rounds_as_cvt_rna():
  r = np.random.RandomState(0)
  x = np.concatenate([
      r.randn(4096).astype(np.float32) * 10.0 ** r.randint(-6, 7, 4096),
      np.float32([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),  # ties: away
                  1.0 + 3 * 2.0 ** -11, 0.0, -0.0, 65504.0, 1e-30]),
  ]).astype(np.float32)
  big, small = attention.split_tf32(torch.from_numpy(x))
  for part in (big, small):  # TF32 values: the 13 low mantissa bits clear
    assert not (part.view(torch.int32) & 0x1FFF).any()
  np.testing.assert_array_equal(big.numpy(), _frexp_round_tf32(x))
  assert big[4096].item() == 1.0 + 2.0 ** -10
  assert big[4097].item() == -(1.0 + 2.0 ** -10)
  assert big[4098].item() == 1.0 + 2.0 ** -9
  np.testing.assert_array_equal(small.numpy(),
                                _frexp_round_tf32(x - big.numpy()))
  err = np.abs((big.double() + small.double()).numpy() - x)
  assert (err <= 2.0 ** -21 * np.abs(x)).all()


def test_split_tf32_keeps_nan_and_inf():
  # NaNs of every payload, the card's own 0x7fffffff among them, and inf:
  # big alone may lose a NaN (the integer add carries a high payload into
  # the sign, as cvt.rna.tf32.f32 turns a low one into inf), small keeps it.
  nan_bits = [0x7F800001, 0x7FC00000, 0x7FFFEFFF, 0x7FFFF000, 0x7FFFFFFF]
  nan_bits += [b | 0x80000000 for b in nan_bits]
  bits = np.array(nan_bits + [0x7F800000, 0xFF800000], np.uint32)
  x = torch.from_numpy(bits.view(np.int32)).view(torch.float32)
  big, small = attention.split_tf32(x)
  assert torch.isnan(small).all()
  assert big[-2].item() == float("inf") and big[-1].item() == float("-inf")
  assert big[4].item() == 0.0  # 0x7fffffff: the add alone gives -0
  # A NaN or inf operand makes every 3xTF32 product it enters NaN.
  for bad in (x[4], x[9], x[-2]):
    a = torch.ones(3, 4)
    a[1, 2] = bad
    out = attention.einsum_3xtf32("ik,kj->ij", a, torch.ones(4, 2))
    assert torch.isnan(out[1]).all() and torch.isfinite(out[[0, 2]]).all()


def _one_tf32(equation, a, b):
  return torch.einsum(equation, attention.split_tf32(a)[0],
                      attention.split_tf32(b)[0])


CASES = {
    # name: (b, q, kv, h, d, bias, mask, transposed)
    "masked_all_masked_row": (2, 24, 200, 2, 64, False, True, False),
    "bias": (1, 16, 96, 3, 32, True, False, False),
    "transposed_masked": (2, 9, 333, 2, 16, False, True, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_3xtf32_attention_within_f32_tolerance(case):
  b, q, kv, h, d, bias, mask, tr = CASES[case]
  # Scores of a few units, as the model's: one TF32 product is off there.
  a = _inputs(b, q, kv, h, d, bias=bias, mask=mask, transposed=tr,
              scale=0.5, seed=sorted(CASES).index(case))
  t = _torch(a)
  args = (t["query"], t["key"], t["value"], t["bias"], t["kv_mask"])
  want = attention.attention_reference(*args, kv_transposed=tr)
  got = attention.attention_reference(*args, kv_transposed=tr,
                                      einsum=attention.einsum_3xtf32)
  jax_out = _jax_flash_attention(a, tr)
  assert (got - want).abs().max().item() <= 1e-5
  assert np.abs(got.numpy() - jax_out).max() <= 1e-4
  stats = attention.softmax_stats_reference(*args[:2], t["bias"],
                                            t["kv_mask"], kv_transposed=tr)
  stats3 = attention.softmax_stats_reference(
      *args[:2], t["bias"], t["kv_mask"], kv_transposed=tr,
      einsum=attention.einsum_3xtf32)
  torch.testing.assert_close(stats3, stats, rtol=1e-5, atol=1e-4)
  # One TF32 product alone misses the kernels' 1e-4 (why the f32 path
  # takes three).
  one = attention.attention_reference(*args, kv_transposed=tr,
                                      einsum=_one_tf32)
  assert (one - want).abs().max().item() > 1e-4


@pytest.mark.parametrize("case", sorted(CASES))
def test_3xtf32_backward_within_f32_tolerance(case):
  b, q, kv, h, d, bias, mask, tr = CASES[case]
  a = _inputs(b, q, kv, h, d, bias=bias, mask=mask, transposed=tr,
              scale=0.5, seed=10 + sorted(CASES).index(case))
  t = _torch(a)
  args = (t["query"], t["key"], t["value"], t["bias"], t["kv_mask"])
  out, stats = attention.flash_attention(*args, kv_transposed=tr,
                                         return_stats=True)
  dout = torch.from_numpy(np.random.RandomState(1).randn(
      *out.shape).astype(np.float32))
  want = attention.flash_attention_bwd_reference(*args, out, stats, dout,
                                                 kv_transposed=tr)
  got = attention.flash_attention_bwd_reference(
      *args, out, stats, dout, kv_transposed=tr,
      einsum=attention.einsum_3xtf32)
  # And against autograd through the JAX-checked plain forward.
  qkv = [x.clone().requires_grad_() for x in args[:3]]
  attention.attention_reference(*qkv, *args[3:],
                                kv_transposed=tr).backward(dout)
  for g, w, auto in zip(got, want, qkv):
    assert torch.isfinite(g).all()
    for ref in (w, auto.grad):
      tol = 1e-4 * max(1.0, ref.abs().max().item())
      assert (g - ref).abs().max().item() <= tol


# ---- (ii) split-KV with its combine ---------------------------------------


SPLIT_CASES = {
    # name: (b, q, kv, h, d, bias, transposed, keys_per_split)
    "three_splits": (2, 12, 200, 2, 32, False, False, 64),
    "ragged_last_split": (2, 9, 333, 2, 16, False, True, 128),
    "bias_two_splits": (1, 16, 130, 3, 32, True, False, 128),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_kv_combine_equals_plain(case):
  b, q, kv, h, d, bias, tr, per = SPLIT_CASES[case]
  a = _inputs(b, q, kv, h, d, bias=bias, mask=True, transposed=tr,
              seed=sorted(SPLIT_CASES).index(case))
  a["kv_mask"][0, per:2 * per] = False  # a split whose keys are all masked
  t = _torch(a)
  args = (t["query"], t["key"], t["value"], t["bias"], t["kv_mask"])
  out, stats = attention.attention_split_kv_reference(
      *args, kv_transposed=tr, keys_per_split=per)
  want = attention.attention_reference(*args, kv_transposed=tr)
  want_stats = attention.softmax_stats_reference(*args[:2], t["bias"],
                                                 t["kv_mask"],
                                                 kv_transposed=tr)
  torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
  torch.testing.assert_close(stats, want_stats, rtol=1e-5, atol=1e-5)
  # The all-masked batch row: the even average of its real keys.
  v = t["value"][-1].transpose(0, 1) if tr else t["value"][-1]
  torch.testing.assert_close(out[-1], v.mean(dim=0).expand_as(out[-1]),
                             rtol=1e-5, atol=1e-5)
  again = attention.attention_split_kv_reference(
      *args, kv_transposed=tr, keys_per_split=per)
  assert torch.equal(out, again[0]) and torch.equal(stats, again[1])


# ---- (iii) the split policy -----------------------------------------------


def test_split_policy_on_the_main_shapes():
  # Grids that fill the card: one split, over all keys.
  assert attention.kv_split(2, 12, 2048, 2048, H100_SMS, *BF16_TILE) == (
      1, 2048)
  assert attention.kv_split(8, 12, 256, 2304, H100_SMS, *F32_TILE) == (
      1, 2304)
  # The b=1 cross-attention (48 bf16 blocks) splits its 2304 keys.
  splits, per = attention.kv_split(1, 12, 256, 2304, H100_SMS, *BF16_TILE)
  assert splits > 1 and per % BF16_TILE[1] == 0
  assert (splits - 1) * per < 2304 <= splits * per
  # One K/V tile cannot split.
  assert attention.kv_split(1, 1, 16, 64, H100_SMS, *BF16_TILE) == (1, 64)


def test_every_split_holds_a_scored_key():
  r = np.random.RandomState(0)
  for _ in range(2000):
    b, h = r.randint(1, 9), r.randint(1, 17)
    q, kv = r.randint(1, 3000), r.randint(1, 5000)
    sm, rows = r.choice([16, 108, 132]), r.choice([64, 128])
    keys = r.choice([32, 64, 128])
    splits, per = attention.kv_split(b, h, q, kv, sm, rows, keys)
    assert (splits, per) == attention.kv_split(b, h, q, kv, sm, rows, keys)
    assert splits >= 1
    if splits == 1:
      assert per == kv
      continue
    assert per % keys == 0
    assert (splits - 1) * per < kv <= splits * per
    assert b * h * -(-q // rows) < sm


# ---- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
  return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2.0 ** -6)])
def test_kernel_split_path_and_stats_on_card(cuda_device, dtype, tol):
  """The forward at the b=1 cross-attention shape (split-KV and combine)
  and at a shape that fills the card: output and, in f32, statistics
  against the plain versions; two launches bitwise equal. The limits are
  chip_smoke.py's: 1e-4 in f32, 2^-6 x max |plain| in bf16."""
  g = torch.Generator("cuda").manual_seed(0)
  sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
  assert attention.fwd_tile(torch.float32) == F32_TILE
  assert attention.fwd_tile(torch.bfloat16) == BF16_TILE
  for b, q, kv, transposed in ((1, 256, 2304, True), (2, 1024, 1024, False)):
    kv_shape = (b, 12, kv, 64) if transposed else (b, kv, 12, 64)
    qq = (torch.randn(b, q, 12, 64, device=cuda_device, generator=g)
          * 0.125).to(dtype)
    k = torch.randn(kv_shape, device=cuda_device, generator=g).to(dtype)
    v = torch.randn(kv_shape, device=cuda_device, generator=g).to(dtype)
    mask = torch.rand(b, kv, device=cuda_device, generator=g) > 0.25
    mask[:, 64:448] = False  # whole splits masked
    splits, _ = attention.kv_split(b, 12, q, kv, sms,
                                   *attention.fwd_tile(dtype))
    before = attention.flash_attention.launches
    out, stats = attention.flash_attention(qq, k, v, kv_mask=mask,
                                           kv_transposed=transposed,
                                           return_stats=True)
    again, stats_again = attention.flash_attention(
        qq, k, v, kv_mask=mask, kv_transposed=transposed, return_stats=True)
    torch.cuda.synchronize()
    assert attention.flash_attention.launches == before + 2
    assert torch.equal(out, again) and torch.equal(stats, stats_again)
    want = attention.attention_reference(qq, k, v, kv_mask=mask,
                                         kv_transposed=transposed)
    scale = 1.0 if dtype == torch.float32 else want.float().abs().max()
    assert (out.float() - want.float()).abs().max().item() <= tol * scale, (
        splits)
    if dtype == torch.float32:
      want_stats = attention.softmax_stats_reference(
          qq, k, kv_mask=mask, kv_transposed=transposed)
      torch.testing.assert_close(stats, want_stats, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_bwd_kernel_bitwise_at_training_shape_on_card(cuda_device):
  """The backward at the cross-attention training shape (b=8, a key mask
  with an all-masked row): against its plain version, finite, two launches
  bitwise equal."""
  g = torch.Generator("cuda").manual_seed(1)
  b, q, kv = 8, 256, 2304
  qq = torch.randn(b, q, 12, 64, device=cuda_device, generator=g) * 0.125
  k = torch.randn(b, kv, 12, 64, device=cuda_device, generator=g)
  v = torch.randn(b, kv, 12, 64, device=cuda_device, generator=g)
  mask = torch.rand(b, kv, device=cuda_device, generator=g) > 0.25
  mask[-1] = False
  out, stats = attention.flash_attention(qq, k, v, kv_mask=mask,
                                         return_stats=True)
  dout = torch.randn(out.shape, device=cuda_device, generator=g)
  got = attention.flash_attention_bwd(qq, k, v, None, mask, out, stats, dout)
  again = attention.flash_attention_bwd(qq, k, v, None, mask, out, stats,
                                        dout)
  want = attention.flash_attention_bwd_reference(qq, k, v, None, mask, out,
                                                 stats, dout)
  for x, y, z in zip(got, again, want):
    assert torch.isfinite(x).all()
    assert torch.equal(x, y)
    tol = 1e-4 * max(1.0, z.abs().max().item())
    assert (x - z).abs().max().item() <= tol


@pytest.mark.cuda
def test_tf32_rounding_matches_cvt_rna_on_card(cuda_device):
  """The kernels' integer TF32 rounding gives cvt.rna.tf32.f32's bits for
  every finite and infinite f32 input tried, and the split's small term is
  NaN for every NaN (and equals the plain split's bit for bit)."""
  g = torch.Generator("cuda").manual_seed(0)
  bits = torch.cat([
      torch.tensor([0x7F7FFFFF, 0x7F800000, 0x7F800001, 0x7FC00000,
                    0x7FFFF000, 0x7FFFFFFF, -1, -0x800000, 0x3F801000,
                    0x1000, 0], dtype=torch.int32, device=cuda_device),
      torch.randint(-2 ** 31, 2 ** 31, (1 << 20,), device=cuda_device,
                    generator=g, dtype=torch.int64).to(torch.int32)])
  ours, cvt, small = attention.tf32_round_probe(bits)
  nan = torch.isnan(bits.view(torch.float32))
  assert torch.equal(ours[~nan], cvt[~nan])
  assert torch.isnan(small[nan].view(torch.float32)).all()
  # The plain split gives the card's small terms bit for bit.
  want = attention.split_tf32(bits.cpu().view(torch.float32))[1]
  assert torch.equal(small.cpu(), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nan_in_gives_nan_out_on_card(cuda_device, dtype):
  """A NaN with the card's own bits (0x7fffffff) in q or in v comes out
  NaN exactly where the plain version's does, in the split-KV forward and
  in one that fills the card; in f32 also a NaN in dO through the
  backward."""
  g = torch.Generator("cuda").manual_seed(2)
  nan_word = 0x7FFF if dtype == torch.bfloat16 else 0x7FFFFFFF
  word_type = torch.int16 if dtype == torch.bfloat16 else torch.int32
  for b, q, kv in ((1, 256, 2304), (8, 256, 256)):
    for where in range(2):
      qkv = [torch.randn(b, n, 12, 64, device=cuda_device, generator=g)
             for n in (q, kv, kv)]
      qkv[0] = qkv[0] * 0.125
      qkv = [x.to(dtype) for x in qkv]
      qkv[2 * where].view(word_type).view(-1)[5] = nan_word
      mask = torch.rand(b, kv, device=cuda_device, generator=g) > 0.25
      got = attention.flash_attention(*qkv, kv_mask=mask)
      want = attention.attention_reference(*qkv, kv_mask=mask)
      assert torch.isnan(want).any()
      assert torch.equal(torch.isnan(got), torch.isnan(want))
    if dtype == torch.float32:
      qkv = [x.clone() for x in qkv]
      qkv[2] = torch.randn(qkv[2].shape, device=cuda_device, generator=g)
      out, stats = attention.flash_attention(*qkv, kv_mask=mask,
                                             return_stats=True)
      dout = torch.randn(out.shape, device=cuda_device, generator=g)
      dout.view(torch.int32).view(-1)[9] = 0x7FFFFFFF
      got = attention.flash_attention_bwd(*qkv, None, mask, out, stats, dout)
      want = attention.flash_attention_bwd_reference(*qkv, None, mask, out,
                                                     stats, dout)
      for x, y in zip(got, want):
        assert torch.isnan(y).any()
        assert torch.equal(torch.isnan(x), torch.isnan(y))
