"""The flash-attention backward's routing and its dq key split.

`csrc/flash_bwd.cu` sends a call to one of two routes (`wgmma_route`, whose
mirror `attention.bwd_route` is held here): bf16 at head_dim 64 with
16-byte-aligned tensors to the wgmma route of `csrc/flash_bwd_wgmma.cuh`,
every other call to the mma.sync route. The wgmma route's dq pass cuts the
keys into ranges where the queries are few (`attention.dq_key_split`, given
the block shape the built kernel reports); every key must fall in one range,
the ranges in order. The CUDA kernels cannot run here; the `cuda`-marked test
holds the routed kernel against its plain version on the card at ragged
lengths, both K/V layouts, with a bias, at d = 32, 64 and 128 (it imports no
JAX: `pytest --noconftest -m cuda`).
"""

import pytest
import torch

from music_spectrogram_diffusion_tpu_torch.ops import attention

# The H100's SMs, and the wgmma route's block shape as msd_flash_bwd_tile
# reports it: the queries a dq work item owns (192 where the queries fill
# such items, as at q = 2048; else 128, as at q = 256) and the rows of a
# streamed tile.
SMS, KEYS = 132, 64
ROWS = {2048: 192, 256: 128}
HEADS, BATCH = 12, 8
TRAINING_SHAPES = {  # (q, kv): the context model's attentions in training
    "encoder_self": (2048, 2048),
    "context_self": (256, 256),
    "decoder_self": (256, 256),
    "cross": (256, 2304),
}
LIMIT = 2.0 ** -6  # the bf16 backward's limit, of max |plain|


def _ranges(kv_len, splits, keys_per_split):
  return [(s * keys_per_split, min((s + 1) * keys_per_split, kv_len))
          for s in range(splits)]


@pytest.mark.parametrize("q_len,kv_len", sorted(set(TRAINING_SHAPES.values()))
                         + [(300, 2300), (1, 1), (1, 65), (129, 64),
                            (256, 64 * 37 + 1), (64, 8192)])
@pytest.mark.parametrize("batch", [1, BATCH])
@pytest.mark.parametrize("rows", sorted(set(ROWS.values())))
def test_dq_key_split_covers_every_key_once_in_order(q_len, kv_len, batch,
                                                     rows):
  splits, per = attention.dq_key_split(batch, HEADS, q_len, kv_len, SMS,
                                       rows, KEYS)
  assert 1 <= splits <= attention.DQ_MAX_SPLITS
  assert per % KEYS == 0
  covered = []
  for start, stop in _ranges(kv_len, splits, per):
    assert start < kv_len, "a range holds no key"
    covered.extend(range(start, stop))
  assert covered == list(range(kv_len))


def test_dq_key_split_at_the_training_shapes():
  """2048 queries fill the card; the 256-query shapes split their keys."""
  plans = {name: attention.dq_key_split(BATCH, HEADS, q, kv, SMS, ROWS[q],
                                        KEYS)
           for name, (q, kv) in TRAINING_SHAPES.items()}
  assert plans["encoder_self"] == (1, 2048)
  assert plans["cross"] == (3, 768)  # 192 items x 3 >= 4 x 132
  assert plans["context_self"] == plans["decoder_self"] == (2, 128)
  # More queries never split more.
  for rows in set(ROWS.values()):
    for q in (256, 512, 1024, 2048, 4096):
      more = attention.dq_key_split(BATCH, HEADS, 2 * q, 2304, SMS, rows, KEYS)
      assert more[0] <= attention.dq_key_split(BATCH, HEADS, q, 2304, SMS,
                                               rows, KEYS)[0]


@pytest.mark.parametrize("dtype,head_dim,aligned,route", [
    (torch.bfloat16, 64, True, "wgmma"),
    (torch.bfloat16, 64, False, "mma_sync"),
    (torch.bfloat16, 32, True, "mma_sync"),
    (torch.bfloat16, 128, True, "mma_sync"),
    (torch.bfloat16, 48, True, "mma_sync"),
    (torch.float32, 64, True, "mma_sync"),
    (torch.float32, 128, True, "mma_sync"),
])
def test_bwd_route_rule(dtype, head_dim, aligned, route):
  assert attention.bwd_route(dtype, head_dim, aligned) == route


def test_training_calls_take_the_wgmma_route():
  """Every attention of context_base trained in bf16 has head_dim 64."""
  from music_spectrogram_diffusion_tpu_torch import config
  net = config.preset("context_base").network()
  assert net.head_dim == attention.WGMMA_HEAD_DIM
  assert attention.bwd_route(torch.bfloat16, net.head_dim) == "wgmma"
  assert attention.bwd_route(torch.float32, net.head_dim) == "mma_sync"


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU and nvcc")
  return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [32, 64, 128])
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
def test_cuda_routed_bwd_matches_plain(cuda_device, head_dim, transposed,
                                       with_bias):
  """The routed bf16 kernel at ragged lengths (q = 300, kv = 2300) against
  its plain version: each gradient within 2^-6 of its max |plain|, finite
  with an all-masked row, two launches bitwise equal; the library routes
  as `bwd_route` says."""
  g = torch.Generator("cuda").manual_seed(head_dim + 2 * transposed
                                          + 4 * with_bias)
  b, q, kv, h = 2, 300, 2300, 3
  kv_shape = (b, h, kv, head_dim) if transposed else (b, kv, h, head_dim)
  qq = (torch.randn(b, q, h, head_dim, device=cuda_device, generator=g)
        * head_dim ** -0.5).bfloat16()
  k = torch.randn(kv_shape, device=cuda_device, generator=g).bfloat16()
  v = torch.randn(kv_shape, device=cuda_device, generator=g).bfloat16()
  mask = torch.rand(b, kv, device=cuda_device, generator=g) > 0.3
  mask[-1] = False
  bias = (torch.randn(b, h, q, kv, device=cuda_device, generator=g)
          if with_bias else None)
  out, stats = attention.flash_attention(qq, k, v, bias, mask,
                                         kv_transposed=transposed,
                                         return_stats=True)
  dout = torch.randn(out.shape, device=cuda_device, generator=g).bfloat16()
  args = (qq, k, v, bias, mask, out, stats, dout)
  lib = attention._library("flash_bwd")  # pylint: disable=protected-access
  route = attention.bwd_route(torch.bfloat16, head_dim)
  assert route == ("wgmma" if lib.msd_flash_bwd_route(1, head_dim, 1)
                   else "mma_sync")
  got = attention.flash_attention_bwd(*args, kv_transposed=transposed)
  again = attention.flash_attention_bwd(*args, kv_transposed=transposed)
  want = attention.flash_attention_bwd_reference(*args,
                                                 kv_transposed=transposed)
  torch.cuda.synchronize()
  for x, y, z in zip(got, again, want):
    assert x.dtype == torch.bfloat16
    assert torch.isfinite(x.float()).all()
    assert torch.equal(x, y)
    err = (x.float() - z.float()).abs().max().item()
    assert err <= LIMIT * z.float().abs().max().item(), (route, err)
