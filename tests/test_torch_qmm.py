"""The int8 GEMM kernel's arithmetic and plan, on the CPU; the kernel on the card.

The CUDA kernel (`ops/csrc/qmm.cu`) cannot run here; what it does beyond
`qmm_reference` has plain versions in `ops/quantize.py` that these tests
hold:

- `widen_int8_reference`: the kernel's int8 -> float widening (a byte
  permute into 0x4B000000 and one subtraction, no conversion instruction)
  gives float(b) exactly for all 256 byte values, and each is exact in
  bf16, so the tensor-core route's bf16 weights are the integers.
- `qmm_split_reference`: the split-K order (K cut into equal ranges, each
  summed, the range sums added in order) stays within 1e-5 of the output's
  max of `qmm_reference` in f32 (the same exact products summed in another
  order), and within the tolerances of tests/test_torch_quantize.py of
  JAX's Pallas kernel run interpreted.
- `plan`: the route cut-off, the K splits and grids at the 16 (M, K, N)
  of the int8 serving path of context_base.

The `cuda`-marked tests at the end hold the kernel itself to the plain
version on the card at every serving shape and on both sides of the route
cut-off, at every tile configuration and split the kernel takes, two
launches and a CUDA-graph replay bit for bit; they skip here. JAX is
imported only by the test that compares with it, so that the `cuda` tests
also run where JAX is not installed (`pytest --noconftest -m cuda`).
"""

import numpy as np
import pytest
import torch

from music_spectrogram_diffusion_tpu_torch.ops import quantize

H100_SMS = 132
BF16, F32 = torch.bfloat16, torch.float32
# The 16 (M, K, N, x dtype) of the int8 path of context_base (chip_smoke.py
# qmm_shapes): the token encoder and cross K/V (2048-2304 rows), the
# context encoder and the decoder (256 or 512 rows), FiLM in f32 and the
# time embedding (1-2 rows).
SERVING_SHAPES = (
    (2304, 768, 768, BF16), (2048, 768, 768, BF16), (2048, 768, 2048, BF16),
    (2048, 2048, 768, BF16), (512, 768, 768, BF16), (512, 768, 2048, BF16),
    (512, 2048, 768, BF16), (256, 768, 768, BF16), (256, 768, 2048, BF16),
    (256, 2048, 768, BF16), (2, 768, 3072, BF16), (2, 3072, 1536, F32),
    (2, 3072, 3072, BF16), (1, 768, 3072, BF16), (1, 3072, 1536, F32),
    (1, 3072, 3072, BF16))


def _operands(m, k, n, seed, x_dtype=F32):
  r = np.random.RandomState(seed)
  w = (r.randn(k, n) / np.sqrt(k)).astype(np.float32)
  q, s = quantize.quantize_kernel(torch.from_numpy(w))
  x = torch.from_numpy(r.randn(m, k).astype(np.float32)).to(x_dtype)
  return x, q, s


def test_widen_int8_bits_exact():
  q = torch.arange(-128, 128, dtype=torch.int16).to(torch.int8)
  got = quantize.widen_int8_reference(q)
  assert got.dtype == torch.float32
  np.testing.assert_array_equal(got.numpy(), np.arange(-128, 128,
                                                       dtype=np.float32))
  # 2^23 + b + 128 before the subtraction: the float the permute builds.
  flipped = (q.view(torch.uint8) ^ 0x80).to(torch.int32) | 0x4B000000
  np.testing.assert_array_equal(flipped.view(torch.float32).numpy(),
                                2.0 ** 23 + 128 + np.arange(-128, 128))
  np.testing.assert_array_equal(got.to(BF16).float().numpy(), got.numpy())


@pytest.mark.parametrize("splits", [1, 2, 3, 4, 6, 12])
@pytest.mark.parametrize("x_dtype", [F32, BF16])
def test_split_reference_matches_plain(splits, x_dtype):
  x, q, s = _operands(5, 768, 256, splits, x_dtype)
  want = quantize.qmm_reference(x, q, s, F32)
  got = quantize.qmm_split_reference(x, q, s, F32, splits=splits)
  peak = want.abs().max().item()
  assert (got - want).abs().max().item() <= 1e-5 * peak
  if splits == 1:
    torch.testing.assert_close(got, want, rtol=0, atol=0)
  again = quantize.qmm_split_reference(x, q, s, F32, splits=splits)
  assert torch.equal(got, again)


def test_split_reference_refuses_a_ragged_split():
  x, q, s = _operands(2, 256, 128, 0)
  with pytest.raises(ValueError):
    quantize.qmm_split_reference(x, q, s, splits=3)


@pytest.mark.parametrize("m,splits", [(1, 4), (2, 8), (16, 2), (100, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_reference_matches_pallas_kernel(m, splits, dtype):
  """Tolerances as test_torch_quantize.py's: f32 out atol 3e-6, bf16 out
  one bf16 step (rtol 2^-7)."""
  import jax.numpy as jnp  # pylint: disable=import-outside-toplevel
  from music_spectrogram_diffusion_tpu.ops import quantize as jax_quantize  # pylint: disable=import-outside-toplevel
  r = np.random.RandomState(m * 10 + splits)
  x = r.randn(m, 512).astype(np.float32)
  w = (r.randn(512, 256) / np.sqrt(512)).astype(np.float32)
  q, s = jax_quantize.quantize_kernel(jnp.asarray(w))
  want = np.asarray(jax_quantize.quantized_matmul(
      jnp.asarray(x).astype(dtype), q, s, use_pallas=True, interpret=True,
      partitioned=False).astype(jnp.float32))
  got = quantize.qmm_split_reference(
      torch.from_numpy(x).to(getattr(torch, dtype)),
      torch.from_numpy(np.array(q)), torch.from_numpy(np.array(s)),
      splits=splits).float().numpy()
  if dtype == "float32":
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-6)
  else:
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)


@pytest.mark.parametrize("m,k,n,dtype", SERVING_SHAPES)
def test_plan_on_serving_shapes(m, k, n, dtype):
  del dtype  # the plan depends on the shape only
  p = quantize.plan(m, k, n, H100_SMS)
  assert p == quantize.plan(m, k, n, H100_SMS)
  route, rows, cols = quantize.CONFIGS[p.config][:3]
  assert (p.route, p.rows, p.cols) == (route, rows, cols)
  gemv = p.route == quantize.GEMV
  assert gemv == (m <= 2)  # every 1-2 row call of the path takes GEMV
  step = quantize.k_step(p.config)
  assert p.splits * p.k_per_split == k and p.k_per_split % step == 0
  assert 1 <= p.splits <= quantize.MAX_SPLITS
  if gemv:
    assert p.grid == (n // cols, p.splits, 1)
  else:
    assert p.grid == (n // cols, -(-m // rows), p.splits)


@pytest.mark.parametrize("m,want", [(1, (quantize.GEMV, 32, 1)),
                                    (2, (quantize.GEMV, 128, 8)),
                                    (quantize.GEMV_MAX_M, (quantize.GEMV, 128, 8)),
                                    (quantize.GEMV_MAX_M + 1,
                                     (quantize.WGMMA, 64, 4))])
def test_plan_route_cut_off(m, want):
  """Either side of the cut-off at 768 x 3072 (the time embedding's first
  projection): one row takes 32-column GEMV blocks unsplit, more rows
  128-column blocks split 8 ways (3 K rows a thread), past the cut-off the
  tensor cores."""
  p = quantize.plan(m, 768, 3072, H100_SMS)
  assert (p.route, p.cols, p.splits) == want


def test_plan_forced_choices_and_refusals():
  p = quantize.plan(512, 768, 768, H100_SMS, config=2, splits=2)
  assert (p.config, p.rows, p.cols, p.splits, p.k_per_split) == (
      2, 128, 64, 2, 384)
  with pytest.raises(ValueError, match="GEMV"):
    quantize.plan(5, 768, 768, H100_SMS, config=0)
  with pytest.raises(ValueError, match="splits"):
    quantize.plan(512, 768, 768, H100_SMS, splits=3)  # powers of two
  with pytest.raises(ValueError, match="splits"):
    quantize.plan(512, 768, 768, H100_SMS, splits=16)  # at most 8
  with pytest.raises(ValueError, match="splits"):
    quantize.plan(1, 768, 768, H100_SMS, config=1, splits=4)  # 6 K steps
  with pytest.raises(ValueError, match="K % 64"):
    quantize.plan(8, 96, 128, H100_SMS)
  with pytest.raises(ValueError, match="N % 64"):
    quantize.plan(8, 128, 96, H100_SMS)
  with pytest.raises(ValueError, match="N % 128"):
    quantize.plan(2, 768, 192, H100_SMS, config=0)


# The shards of context_base's int8 kernels on 1x2 and 1x4 meshes (K, N) at
# the rows they run: N-split q/k/v 768 / model and wi 2048 / model; K-split
# attention out (768 / model), wo (2048 / model), FiLM (3072 / model) and
# the time embedding's (768 and 3072 / model).
SHARD_SHAPES = [(m, k, n) for model in (2, 4) for m, k, n in (
    (512, 768, 768 // model), (512, 768, 2048 // model),
    (2, 768, 768 // model), (2, 768, 2048 // model),
    (512, 768 // model, 768), (512, 2048 // model, 768),
    (1, 3072 // model, 1536), (2, 3072 // model, 1536),
    (1, 768 // model, 3072), (2, 3072 // model, 3072))]


@pytest.mark.parametrize("m,k,n", SHARD_SHAPES)
def test_plan_takes_every_shard_shape(m, k, n):
  """Every shard of the 1x2 and 1x4 meshes has a plan: N = 192 takes the
  32-column GEMV blocks or the 64-column tiles, K = 192 the 128-column
  GEMV blocks (whose K step is 32)."""
  p = quantize.plan(m, k, n, H100_SMS)
  assert n % p.cols == 0 and p.k_per_split % quantize.k_step(p.config) == 0
  assert p.splits * p.k_per_split == k
  assert p.route == (quantize.GEMV if m <= quantize.GEMV_MAX_M
                     else quantize.WGMMA)


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
  return torch.device("cuda")


def _card_operands(m, k, n, dtype, device, seed):
  gen = torch.Generator(device).manual_seed(seed)
  q, s = quantize.quantize_kernel(
      torch.randn(k, n, device=device, generator=gen) * k ** -0.5)
  x = torch.randn(m, k, device=device, generator=gen).to(dtype)
  return x, q, s


def _tolerance(want):
  # f32: the same exact products summed in another order; bf16: one
  # rounding step of the output (chip_smoke.py QMM_TOLERANCE).
  rel = 1e-5 if want.dtype == F32 else 2.0 ** -7
  return rel * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,dtype,out_dtype", [
    *((m, k, n, d, d) for m, k, n, d in SERVING_SHAPES),
    (quantize.GEMV_MAX_M, 768, 3072, BF16, BF16),      # the cut-off: GEMV
    (quantize.GEMV_MAX_M + 1, 768, 3072, BF16, BF16),  # and the tensor cores
    (3, 2048, 384, F32, BF16), (100, 512, 256, BF16, BF16),
    (100, 512, 256, F32, F32), (77, 1024, 640, BF16, F32)])
def test_kernel_matches_plain_version_on_card(cuda_device, m, k, n, dtype,
                                              out_dtype):
  torch.backends.cuda.matmul.allow_tf32 = False
  x, q, s = _card_operands(m, k, n, dtype, cuda_device, m + k + n)
  before = quantize.quantized_matmul.launches
  got = quantize.quantized_matmul(x, q, s, out_dtype=out_dtype)
  torch.cuda.synchronize()
  assert quantize.quantized_matmul.launches == before + 1
  assert got.dtype == out_dtype and got.shape == (m, n)
  want = quantize.qmm_reference(x, q, s, out_dtype)
  assert (got.float() - want.float()).abs().max().item() <= _tolerance(want)
  p = quantize.plan(m, k, n, torch.cuda.get_device_properties(
      cuda_device).multi_processor_count)
  split = quantize.qmm_split_reference(x, q, s, out_dtype, splits=p.splits)
  assert (got.float() - split.float()).abs().max().item() <= _tolerance(want)
  # Two launches, and a CUDA-graph replay, give the same bits.
  assert torch.equal(quantize.quantized_matmul(x, q, s, out_dtype=out_dtype),
                     got)
  stream = torch.cuda.Stream()
  stream.wait_stream(torch.cuda.current_stream())
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph, stream=stream):
    replayed = quantize.quantized_matmul(x, q, s, out_dtype=out_dtype)
  graph.replay()
  graph.replay()
  torch.cuda.synchronize()
  assert torch.equal(replayed, got)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,dtype", [
    (512, 768, 768, BF16), (2, 3072, 1536, F32), (quantize.GEMV_MAX_M + 1,
                                                  768, 3072, BF16),
    (2304, 768, 768, BF16), (256, 2048, 768, BF16), (3, 768, 1536, BF16)])
def test_every_config_and_split_on_card(cuda_device, m, k, n, dtype):
  """Every tile configuration of the call's route, at every K split it
  takes: within the tolerance of the plain version, bitwise repeatable."""
  torch.backends.cuda.matmul.allow_tf32 = False
  x, q, s = _card_operands(m, k, n, dtype, cuda_device, 7)
  want = quantize.qmm_reference(x, q, s)
  tol = _tolerance(want)
  gemv = m <= quantize.GEMV_MAX_M
  tried = 0
  for config, row in enumerate(quantize.CONFIGS):
    if (row[0] == quantize.GEMV) != gemv:
      continue
    for splits in range(1, quantize.MAX_SPLITS + 1):
      try:
        p = quantize.plan(m, k, n, 132, config=config, splits=splits)
      except ValueError:
        continue
      launch = quantize.Launch(p, dtype, dtype)
      outs = []
      for _ in range(2):
        outs.append(torch.empty(m, n, dtype=dtype, device=cuda_device))
        launch(x, q, s, outs[-1])
      torch.cuda.synchronize()
      err = (outs[0].float() - want.float()).abs().max().item()
      assert err <= tol, (config, splits, err, tol)
      assert torch.equal(outs[0], outs[1]), (config, splits)
      tried += 1
  assert tried >= 3


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
  x, q, s = _card_operands(4, 96, 128, BF16, cuda_device, 0)
  with pytest.raises(ValueError, match="K % 64"):
    quantize.quantized_matmul(x, q, s)
  x, q, s = _card_operands(4, 128, 128, BF16, cuda_device, 0)
  with pytest.raises(ValueError, match="contiguous"):
    quantize.quantized_matmul(x, q.t().contiguous().t(), s)
