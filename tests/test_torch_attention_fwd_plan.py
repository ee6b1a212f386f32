"""The flash-attention forward's routing and its key split.

`csrc/flash_fwd.cu` sends a call to one of two routes (`wgmma_route`, whose
mirror `attention.fwd_route` is held here): bf16 and f32 at head_dim 64
without a bias, with 16-byte-aligned tensors, to the wgmma route
(`csrc/flash_fwd_wgmma.cuh` in bf16, `csrc/flash_fwd_tf32.cuh` in f32);
every other call, a call with a bias among them, to the mma.sync route.
Every call that the three families make when they serve or train takes the
wgmma route. The route cuts the keys into ranges where its work items
cannot fill the card (`attention.fwd_key_split`, given the block shape the
built kernel reports: 128 or 192 query rows in bf16, 128 in f32, over
64-key tiles); every key must fall in one range, the ranges in order, each
starting below kv_len. The CUDA kernels cannot run here; the
`cuda`-marked tests hold the routed kernel against its plain version on
the card at ragged lengths, both K/V layouts, an all-masked row, with the
statistics and with split-KV (they import no JAX: `pytest --noconftest -m
cuda`).
"""

import dataclasses

import pytest
import torch

from music_spectrogram_diffusion_tpu_torch import config
from music_spectrogram_diffusion_tpu_torch.infer import inference
from music_spectrogram_diffusion_tpu_torch.ops import attention

# The H100's SMs, and the wgmma route's block shape as msd_flash_fwd_tile
# reports it: the queries a work item owns (bf16: 192 at q = 2048, where
# such items fill the queries, else 128, as at q = 256; f32: 128) and the
# keys a K/V tile.
SMS, KEYS = 132, 64
ROWS = {2048: 192, 256: 128}
F32_ROWS = 128
HEADS = 12
# (q, kv): the attentions of the three families, serving and training
# (chip_smoke.py SHAPES and FAMILY_SHAPES).
MAIN_SHAPES = {
    "encoder_self": (2048, 2048),
    "context_self": (256, 256),
    "decoder_self": (256, 256),
    "cross": (256, 2304),
    "notes_cross": (256, 2048),
}
LIMIT = 2.0 ** -6  # the bf16 forward's limit, of max |plain|


def _ranges(kv_len, splits, keys_per_split):
  return [(s * keys_per_split, min((s + 1) * keys_per_split, kv_len))
          for s in range(splits)]


def _assert_covers(kv_len, splits, per):
  assert 1 <= splits <= attention.FWD_MAX_SPLITS
  assert splits == 1 or per % KEYS == 0
  covered = []
  for start, stop in _ranges(kv_len, splits, per):
    assert start < kv_len, "a range holds no key"
    covered.extend(range(start, stop))
  assert covered == list(range(kv_len))


@pytest.mark.parametrize("q_len,kv_len", sorted(set(MAIN_SHAPES.values())))
@pytest.mark.parametrize("batch", [1, 2, 8, 32])
@pytest.mark.parametrize("heads", [HEADS, 6, 3])
def test_fwd_key_split_at_the_main_shapes(q_len, kv_len, batch, heads):
  splits, per = attention.fwd_key_split(batch, heads, q_len, kv_len, SMS,
                                        ROWS[q_len], KEYS)
  _assert_covers(kv_len, splits, per)


@pytest.mark.parametrize("q_len,kv_len", sorted(set(MAIN_SHAPES.values())))
@pytest.mark.parametrize("batch", [1, 2, 8, 32])
@pytest.mark.parametrize("heads", [HEADS, 6, 4, 3])
def test_fwd_key_split_f32_tile_at_the_main_shapes(q_len, kv_len, batch,
                                                   heads):
  """The f32 route's block shape (128 query rows, 64-key tiles) at the
  families' shapes, the shards' heads and the transcriber's 4."""
  splits, per = attention.fwd_key_split(batch, heads, q_len, kv_len, SMS,
                                        F32_ROWS, KEYS)
  _assert_covers(kv_len, splits, per)


def test_fwd_key_split_f32_plans():
  """The f32 route's items are 128 query rows at every q_len: 2048 queries
  make 16 items a head, which fill the card at b=2 with one range; the
  cross-attentions' 48 or 24 items cut their keys into ranges."""
  plan = {name: attention.fwd_key_split(2, HEADS, q, kv, SMS, F32_ROWS, KEYS)
          for name, (q, kv) in MAIN_SHAPES.items()}
  assert plan["encoder_self"] == (1, 2048)
  assert plan["decoder_self"] == plan["context_self"] == (1, 256)
  assert plan["cross"] == (2, 1152)  # 96 items of 18 tiles
  assert plan["notes_cross"] == (2, 1024)  # 96 items of 16 tiles
  assert attention.fwd_key_split(1, HEADS, 256, 2304, SMS, F32_ROWS,
                                 KEYS) == (5, 512)  # 120 items of 8 tiles
  for batch in (8, 32):
    for q, kv in MAIN_SHAPES.values():
      if q == 2048 or batch == 32:
        assert attention.fwd_key_split(batch, HEADS, q, kv, SMS, F32_ROWS,
                                       KEYS) == (1, kv)


@pytest.mark.parametrize("q_len,kv_len", [(1, 1), (1, 65), (300, 2303),
                                          (129, 64), (5, 64 * 37 + 1),
                                          (64, 8192), (2048, 1)])
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("rows", [128, 192])
def test_fwd_key_split_covers_every_key_once_in_order(q_len, kv_len, batch,
                                                      rows):
  _assert_covers(kv_len, *attention.fwd_key_split(batch, HEADS, q_len,
                                                  kv_len, SMS, rows, KEYS))


def test_fwd_key_split_plans():
  """The 2048-query shapes fill the card in whole waves (11 items of 192
  rows a head: 264 at b=2, 132 at b=1) and take one range; the
  cross-attentions' 48 or 24 items of 128 rows cut their 32-36 tiles into
  ranges that fill one wave; 256 keys (4 tiles) are not cut."""
  plan = {name: attention.fwd_key_split(2, HEADS, q, kv, SMS, ROWS[q], KEYS)
          for name, (q, kv) in MAIN_SHAPES.items()}
  assert plan["encoder_self"] == (1, 2048)
  assert plan["decoder_self"] == plan["context_self"] == (1, 256)
  assert plan["cross"] == (2, 1152)  # 96 items of 18 tiles
  assert plan["notes_cross"] == (2, 1024)  # 96 items of 16 tiles
  assert attention.fwd_key_split(1, HEADS, 2048, 2048, SMS, 192,
                                 KEYS) == (1, 2048)
  assert attention.fwd_key_split(1, HEADS, 256, 2304, SMS, 128,
                                 KEYS) == (5, 512)  # 120 items of 8 tiles
  assert attention.fwd_key_split(1, HEADS, 256, 256, SMS, 128,
                                 KEYS) == (1, 256)
  # Training's batch 8 and 32 fill the card at every shape: one range.
  for batch in (8, 32):
    for q, kv in MAIN_SHAPES.values():
      if q == 2048 or batch == 32:
        assert attention.fwd_key_split(batch, HEADS, q, kv, SMS, ROWS[q],
                                       KEYS) == (1, kv)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("head_dim", [32, 64, 128])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("has_bias", [False, True])
def test_fwd_route_rule(dtype, head_dim, aligned, has_bias):
  """wgmma for bf16 and f32 at head_dim 64, aligned, without a bias; a
  bias goes to mma.sync, which adds the bias tile to S."""
  want = ("wgmma" if head_dim == 64 and aligned and not has_bias
          else "mma_sync")
  assert attention.fwd_route(dtype, head_dim, aligned, has_bias) == want


def _record_calls(monkeypatch):
  """Wraps the two attention entries; each call's route (as fwd_route
  would give it on the card) is appended to the returned list."""
  routes = []

  def wrap(fn):
    def recorded(query, key, value, bias=None, kv_mask=None, **kw):
      tensors = [query, key, value] + ([kv_mask] if kv_mask is not None
                                       else [])
      assert all(t.is_contiguous() for t in tensors)
      aligned = all(t.data_ptr() % attention.WGMMA_ALIGN == 0
                    for t in tensors)
      routes.append((query.dtype, query.shape[-1], bias is None,
                     attention.fwd_route(query.dtype, query.shape[-1],
                                         aligned, bias is not None)))
      return fn(query, key, value, bias, kv_mask, **kw)
    return recorded

  monkeypatch.setattr(attention, "flash_attention",
                      wrap(attention.flash_attention))
  monkeypatch.setattr(attention, "flash_attention_diff",
                      wrap(attention.flash_attention_diff))
  return routes


@pytest.mark.parametrize("preset", ["context_base", "diffusion_base",
                                    "ar_base"])
def test_main_path_bf16_calls_take_the_wgmma_route(monkeypatch, preset):
  """Each family at its base preset's widths (12 heads of 64), cut to one
  encoder and one decoder layer and a few positions, in bf16: its serving
  calls (encoders, the decoder over cached cross K/V, no grad) and its
  training calls (the forward with grad, then the backward) all take the
  wgmma route: head_dim 64, no bias."""
  base = dict(config._SIZES["base"])  # pylint: disable=protected-access
  monkeypatch.setitem(config._SIZES, "base", dict(  # pylint: disable=protected-access
      base, num_encoder_layers=1, num_decoder_layers=1))
  experiment = dataclasses.replace(config.preset(preset), dtype="bfloat16",
                                   dropout_rate=0.0)
  module = inference.network(experiment).init_weights(
      torch.Generator().manual_seed(0))
  routes = _record_calls(monkeypatch)
  gen = torch.Generator().manual_seed(1)
  tokens = torch.randint(1, 100, (2, 12), generator=gen)
  tokens[-1, 8:] = 0
  frames = torch.randn(2, 8, 128, generator=gen)
  if experiment.model_family == "autoregressive":
    with torch.no_grad():
      module.encode(tokens)
    module.decode(module.encode(tokens), tokens, frames).float().sum().backward()
  else:
    enc_args = (tokens,)
    if experiment.with_context:
      enc_args += (torch.randn(2, 8, 128, generator=gen),
                   torch.ones(2, 8, dtype=torch.bool))
    time = torch.rand(2, generator=gen)
    with torch.no_grad():
      encodings = module.encode(*enc_args)
      module.decode(encodings, frames, time,
                    cross_kv=module.precompute_cross_kv(encodings))
    module.decode(module.encode(*enc_args), frames,
                  time).float().sum().backward()
  assert routes, "no attention call"
  assert {r[:3] for r in routes} == {(torch.bfloat16, 64, True)}
  assert {r[3] for r in routes} == {"wgmma"}


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU and nvcc")
  return torch.device("cuda")


def _inputs(b, q, kv, transposed, gen, device):
  kv_shape = (b, HEADS, kv, 64) if transposed else (b, kv, HEADS, 64)
  qq = (torch.randn(b, q, HEADS, 64, device=device, generator=gen)
        * 0.125).bfloat16()
  k = torch.randn(kv_shape, device=device, generator=gen).bfloat16()
  v = torch.randn(kv_shape, device=device, generator=gen).bfloat16()
  mask = torch.rand(b, kv, device=device, generator=gen) > 0.3
  mask[-1] = False  # a batch row whose keys are all masked
  return qq, k, v, mask


@pytest.mark.cuda
@pytest.mark.parametrize("kv_len", [1, 63, 65, 2303, 2304])
@pytest.mark.parametrize("transposed", [False, True])
def test_cuda_routed_fwd_matches_plain(cuda_device, kv_len, transposed):
  """The routed bf16 kernel at q = 300 against its plain version: out
  within 2^-6 of max |plain|, finite with an all-masked row, the statistics
  within 2^-6 of the plain ones (the row max absolutely below 1, the sum
  relatively), two launches bitwise equal; the library routes as
  `fwd_route` says and plans by the block shape the test assumes."""
  g = torch.Generator("cuda").manual_seed(kv_len + transposed)
  qq, k, v, mask = _inputs(2, 300, kv_len, transposed, g, cuda_device)
  lib = attention._library("flash_fwd")  # pylint: disable=protected-access
  assert lib.msd_flash_fwd_route(1, 64, 1, 0) == 1
  assert lib.msd_flash_fwd_route(1, 64, 1, 1) == 0
  assert attention.fwd_wgmma_tile(2048) == (ROWS[2048], KEYS)
  assert attention.fwd_wgmma_tile(256) == (ROWS[256], KEYS)
  out, stats = attention.flash_attention(qq, k, v, kv_mask=mask,
                                         kv_transposed=transposed,
                                         return_stats=True)
  again = attention.flash_attention(qq, k, v, kv_mask=mask,
                                    kv_transposed=transposed)
  torch.cuda.synchronize()
  want = attention.attention_reference(qq, k, v, kv_mask=mask,
                                       kv_transposed=transposed)
  want_stats = attention.softmax_stats_reference(qq, k, kv_mask=mask,
                                                 kv_transposed=transposed)
  assert out.dtype == torch.bfloat16
  assert torch.isfinite(out.float()).all()
  assert torch.equal(out, again)
  err = (out.float() - want.float()).abs().max().item()
  assert err <= LIMIT * want.float().abs().max().item(), err
  m_err = ((stats[0] - want_stats[0]).abs()
           / want_stats[0].abs().clamp(min=1.0)).max().item()
  l_err = ((stats[1] - want_stats[1]).abs() / want_stats[1]).max().item()
  assert m_err <= LIMIT and l_err <= LIMIT, (m_err, l_err)
  # The all-masked row: its max is exactly the mask's -1e10.
  assert (stats[0][-1] == -1e10).all()


@pytest.mark.cuda
def test_cuda_split_kv_bitwise_and_in_a_graph(cuda_device):
  """The cross-attention shape at b=2 and b=1 cuts its keys into ranges
  (the combine runs): within the limit, two launches bitwise equal, and a
  CUDA-graph replay equal to the eager call."""
  g = torch.Generator("cuda").manual_seed(7)
  sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
  for batch in (2, 1):
    qq, k, v, mask = _inputs(batch, 256, 2304, True, g, cuda_device)
    splits, _ = attention.fwd_key_split(batch, HEADS, 256, 2304, sms,
                                        *attention.fwd_wgmma_tile(256))
    assert splits > 1

    def call():
      return attention.flash_attention(qq, k, v, kv_mask=mask,
                                       kv_transposed=True, return_stats=True)

    out, stats = call()
    again, stats_again = call()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
      call()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
      captured, captured_stats = call()
    graph.replay()
    torch.cuda.synchronize()
    want = attention.attention_reference(qq, k, v, kv_mask=mask,
                                         kv_transposed=True)
    err = (out.float() - want.float()).abs().max().item()
    assert err <= LIMIT * want.float().abs().max().item(), (batch, err)
    assert torch.equal(out, again) and torch.equal(stats, stats_again)
    assert torch.equal(out, captured) and torch.equal(stats, captured_stats)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_len", [1, 63, 65, 2303, 2304])
@pytest.mark.parametrize("transposed", [False, True])
def test_cuda_routed_fwd_f32_matches_plain(cuda_device, kv_len, transposed):
  """The routed f32 kernel (3xTF32 on wgmma) at q = 300 against its plain
  version: out within 1e-4, finite with an all-masked row, the statistics
  within 1e-4 (the row max absolutely below 1, the sum relatively), two
  launches bitwise equal; the library routes f32 at head_dim 64 to it,
  and plans by 128-row items."""
  g = torch.Generator("cuda").manual_seed(kv_len + transposed)
  qq, k, v, mask = (t if t.dtype == torch.bool else t.float()
                    for t in _inputs(2, 300, kv_len, transposed, g,
                                     cuda_device))
  lib = attention._library("flash_fwd")  # pylint: disable=protected-access
  assert lib.msd_flash_fwd_route(0, 64, 1, 0) == 1
  assert lib.msd_flash_fwd_route(0, 64, 1, 1) == 0
  assert attention.fwd_wgmma_tile(2048, torch.float32) == (F32_ROWS, KEYS)
  attention.route_launches.clear()
  out, stats = attention.flash_attention(qq, k, v, kv_mask=mask,
                                         kv_transposed=transposed,
                                         return_stats=True)
  again = attention.flash_attention(qq, k, v, kv_mask=mask,
                                    kv_transposed=transposed)
  torch.cuda.synchronize()
  assert attention.route_launches["fwd", "float32", "wgmma"] == 2
  want = attention.attention_reference(qq, k, v, kv_mask=mask,
                                       kv_transposed=transposed)
  want_stats = attention.softmax_stats_reference(qq, k, kv_mask=mask,
                                                 kv_transposed=transposed)
  assert torch.isfinite(out).all() and torch.equal(out, again)
  assert (out - want).abs().max().item() <= 1e-4
  m_err = ((stats[0] - want_stats[0]).abs()
           / want_stats[0].abs().clamp(min=1.0)).max().item()
  l_err = ((stats[1] - want_stats[1]).abs() / want_stats[1]).max().item()
  assert m_err <= 1e-4 and l_err <= 1e-4, (m_err, l_err)
  assert (stats[0][-1] == -1e10).all()
