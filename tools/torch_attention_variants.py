"""Design choices of the port's attention kernels, timed on the card, and
faults planted in them, caught by chip_smoke.py's tolerances.

    python3 tools/torch_attention_variants.py [--profile] [variant ...]

Builds `ops/csrc/flash_fwd.cu` and `flash_bwd.cu` as they are, and variants
of them made by replacing lines of the sources in a temporary copy, and
times each in turns (base, variants, variants reversed, base) at the
inputs of chip_smoke.py phases 3 and 22 (forward, the six shapes at b=2
and b=1 in float32 and bfloat16, and the training encoder's 2048x2048 at
b=8 in bfloat16: 25 runs, each timed as CUDA-graph replays; only when a
chosen variant touches the forward), 10, 22 and 28 (backward in float32:
the six training shapes at b=8 and the transcriber's two at b=32, 4 heads)
and 19 (backward in bfloat16, the context model's four shapes at b=8), all
of them or those named. For each forward run it also prints, once, the plain
version's and SDPA's times (graph replays; SDPA a yardstick only) and the
bound. Each variant's results are held against the plain versions at
chip_smoke's tolerances; a variant marked `same_bits` must also give the
base's output bit for bit. Prints the nvidia-smi name and power limit,
each variant's ptxas registers and spills, and a table of the best of its
two times per run (a variant that changes the forward's rows a block also
changes its split-KV counts, and so its bits), then each variant's worst
error over its tolerance (forward, f32 backward, bf16 backward) and the
backward's worst relative RMS against its plain version. A fault
(`fault_*`) is not timed: at each forward run where it changes the output,
its error against the plain version and chip_smoke's limit there are
printed, and the tool fails unless the limit catches it. With --profile,
each backward run of the base and of each timed variant is also traced
with torch.profiler (five calls), and each kernel's device ms a call is
printed (the backward's prologue, passes and combine); so is each forward
run's (the main kernel and, where the keys are split, the combine). The
variants:

  fwd_f32_4warps   f32 blocks of 4 warps (64 rows) instead of 8;
  fwd_bf16_8warps  bf16 blocks of 8 warps (128 rows) instead of 4;
  fwd_f32_3stages  a third f32 K/V stage;
  fwd_old_route    bf16 and f32 calls that the forward's wgmma route takes
                   go to the mma.sync route, as before it existed (the
                   before of a before-and-after, other bits);
  fwd_f32_old_route  f32 calls that the forward's wgmma route takes go to
                   the mma.sync route, as before its f32 route existed
                   (other bits);
  fwd_4stages      the forward's wgmma route with a ring of 4 K/V tiles, not 6
                   (same bits);
  bwd_dkdv_16rows  dkdv streams 16 query rows a tile instead of 32 (d = 64);
  bwd_dkdv_64rows  dkdv streams 64 query rows a tile instead of 32 (d = 64);
  bwd_dq_64rows    dq streams 64 key rows a tile instead of 32 (d = 64);
  bwd_3stages, bwd_4stages  the mma.sync backward's cp.async ring of 3 or 4
                   stages instead of 2, each step waiting only for its own
                   tile (same bits);
  bwd_straight_sums  the mma.sync backward sums each output straight on the
                   tensor cores instead of per tile and then in f32 (other
                   bits);
  bwd_old_route    bf16 and f32 calls that the wgmma route takes go to the
                   mma.sync route, as before it existed (the before of a
                   before-and-after, other bits);
  bwd_f32_old_route  f32 calls that the backward's wgmma route takes go to
                   the mma.sync route, as before its f32 route existed
                   (other bits);
  bwd_f32_dq_2stages  the f32 route's dq pass with a ring of 2 streamed
                   tiles, not 3 (same bits);
  bwd_dq_two_warpgroups  the wgmma route's dq pass with two consumer
                   warpgroups at every q_len, not three where the queries
                   fill 192-row items;
  cvt_rna          the TF32 rounding by cvt.rna.tf32.f32 instead of the
                   integer add-and-mask (same bits);
  nan_unkept       the split without the clamp that keeps a NaN operand's
                   small term NaN (same bits on these finite inputs);
  truncate         TF32 terms by truncation instead of rounding (other bits);
  fault_skip_tile  the forward leaves out keys 64-127 (one K/V tile);
  fault_drop_split the split-KV combine leaves out the last split.

Needs the CUDA toolkit (nvcc) and a card; imports torch, the port and
chip_smoke.py, not JAX.
"""

import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
# pylint: disable=wrong-import-position
import chip_smoke as cs
from music_spectrogram_diffusion_tpu_torch.ops import _build, attention

ROUND = "return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;"
SKIP_AT = "const int k0 = k_begin + it * kBlockK;"


def ring(stages):
  """The mma.sync backward's cp.async ring with `stages` stages: the first
  stages - 1 tiles in flight before the loop, each step waiting for its own
  tile only."""
  edits = {"constexpr int kStages = 2;": f"constexpr int kStages = {stages};",
           "msd::cp_async_wait<0>();": "msd::cp_async_wait<kStages - 2>();"}
  for fn in ("load_q", "load_kv"):
    edits[f"if (it + 1 < n_tiles) {fn}(it + 1, (it + 1) % kStages);"] = (
        f"if (it + kStages - 1 < n_tiles) {fn}(it + kStages - 1, "
        f"(it + kStages - 1) % kStages);")
    edits[f"  {fn}(0, 0);\n  msd::cp_async_commit();"] = (
        f"  for (int s = 0; s < kStages - 1; ++s) {{\n"
        f"    if (s < n_tiles) {fn}(s, s);\n    msd::cp_async_commit();\n  }}")
  return edits


# name: (source, {old text: new text}, same bits)
VARIANTS = {
    "fwd_f32_4warps": ("flash_fwd", {"kWarps = kF32 ? 8 : 4;":
                                     "kWarps = kF32 ? 4 : 4;"}, False),
    "fwd_bf16_8warps": ("flash_fwd", {"kWarps = kF32 ? 8 : 4;":
                                      "kWarps = kF32 ? 8 : 8;"}, False),
    "fwd_f32_3stages": ("flash_fwd", {"kStages = kF32 ? 2 : 3;":
                                      "kStages = kF32 ? 3 : 3;"}, True),
    "fwd_old_route": ("flash_fwd", {
        "constexpr bool kFwdWgmmaRoute = true;":
        "constexpr bool kFwdWgmmaRoute = false;"}, False),
    "fwd_f32_old_route": ("flash_fwd", {
        "constexpr bool kFwdTf32Route = true;":
        "constexpr bool kFwdTf32Route = false;"}, False),
    "fwd_4stages": ("flash_fwd", {
        "constexpr int kStages = 6;  // the TMA ring of K/V tiles":
        "constexpr int kStages = 4;  // the TMA ring of K/V tiles"}, True),
    "bwd_dkdv_16rows": ("flash_bwd", {
        "kDkdvRows = D <= 64 ? 32 : 16;": "kDkdvRows = 16;"}, False),
    "bwd_dkdv_64rows": ("flash_bwd", {
        "kDkdvRows = D <= 64 ? 32 : 16;": "kDkdvRows = D <= 64 ? 64 : 16;"},
                        False),
    "bwd_dq_64rows": ("flash_bwd", {
        "kDqRows = D <= 32 ? 64 : (D <= 64 ? 32 : 16);":
        "kDqRows = D <= 64 ? 64 : 16;"}, False),
    "bwd_straight_sums": ("flash_bwd", {
        "kTileSums = D <= 64;": "kTileSums = false;",
        "msd::mma_3xtf32(dq_t[n],": "msd::mma_3xtf32(dq[n],",
        "msd::mma_bf16(dq_t[2 * n2], a,": "msd::mma_bf16(dq[2 * n2], a,",
        "msd::mma_bf16(dq_t[2 * n2 + 1], a,":
        "msd::mma_bf16(dq[2 * n2 + 1], a,",
        "msd::add_to(dq, dq_t);": ""}, False),
    "bwd_3stages": ("flash_bwd", ring(3), True),
    "bwd_4stages": ("flash_bwd", ring(4), True),
    "bwd_old_route": ("flash_bwd", {"constexpr bool kWgmmaRoute = true;":
                                    "constexpr bool kWgmmaRoute = false;"},
                      False),
    "bwd_f32_old_route": ("flash_bwd", {"constexpr bool kTf32Route = true;":
                                        "constexpr bool kTf32Route = false;"},
                          False),
    "bwd_f32_dq_2stages": ("flash_bwd", {
        "constexpr int kDqStages = 3;": "constexpr int kDqStages = 2;"}, True),
    "bwd_dq_two_warpgroups": ("flash_bwd", {
        "return (q_len + 191) / 192 * 192 * 8 <= 9 * q_len ? 3 : 2;":
        "return 2;"}, False),
    "cvt_rna": (None, {ROUND: 'uint32_t r; asm("cvt.rna.tf32.f32 %0, %1;" '
                              ': "=r"(r) : "f"(x)); return r;'}, True),
    "nan_unkept": (None, {"min(rest, 0x7fffefff)": "rest"}, True),
    "truncate": (None, {ROUND: "return __float_as_uint(x) & 0xffffe000u;"},
                 False),
    "fault_skip_tile": ("flash_fwd", {
        SKIP_AT: SKIP_AT + " if (k0 == kBlockK) continue;"}, False),
    "fault_drop_split": ("flash_fwd", {
        "for (int s = 0; s < p.splits; ++s)":
        "for (int s = 0; s < p.splits - 1; ++s)"}, False),
}


def start_build(name, work):
  """Starts nvcc on each source that variant `name` (None: the base)
  changes, all at once; returns {library: (path, process)}."""
  src = work / (name or "base")
  shutil.copytree(_build.CSRC, src, ignore=shutil.ignore_patterns("build"))
  target, edits, _ = VARIANTS[name] if name else (None, {}, True)
  matched = set()
  for path in src.glob("*.cu*"):
    text = path.read_text()
    for old, new in edits.items():
      if old in text:
        matched.add(old)
        text = text.replace(old, new)
    path.write_text(text)
  if matched != set(edits):
    raise RuntimeError(f"variant {name}: no source line {set(edits) - matched}")
  procs = {}
  for lib in ("flash_fwd", "flash_bwd"):
    if target in (None, lib):
      out = src / f"lib{lib}.so"
      procs[lib] = (out, subprocess.Popen(
          [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out),
           str(src / f"{lib}.cu")], stdout=subprocess.PIPE,
          stderr=subprocess.PIPE, text=True))
  return procs


def finish_build(name, procs):
  libs = {}
  for lib, (out, proc) in procs.items():
    stdout, stderr = proc.communicate()
    if proc.returncode:
      raise RuntimeError(f"{name} {lib}: nvcc failed\n{stdout}{stderr}")
    for line in cs.ptxas_lines(stdout + stderr):
      print(f"  {name or 'base'} {lib}.cu ptxas: {line}", flush=True)
    libs[lib] = ctypes.CDLL(str(out))
  return libs


def kernel_ms(fn, calls: int = 5):
  """(kernel name, device ms a call) of each kernel `fn` launches, from
  torch.profiler over `calls` calls after a warm-up, largest first."""
  from torch.profiler import ProfilerActivity, profile  # pylint: disable=import-outside-toplevel
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(calls):
      fn()
    torch.cuda.synchronize()
  events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
  return [(e.key[:60], e.self_device_time_total / 1e3 / calls) for e in
          sorted(events, key=lambda e: -e.self_device_time_total)]


def sdpa_ms(q, k, v, mask, transposed, stream):
  """SDPA's time (graph replays) on the inputs of a forward run, as
  chip_smoke.py phase 3 takes it: [b, h, l, d], the mask as an additive
  bias in the inputs' dtype, no scaling."""
  qs = q.transpose(1, 2).contiguous()
  ks, vs = ((k, v) if transposed else (k.transpose(1, 2).contiguous(),
                                       v.transpose(1, 2).contiguous()))
  bias = (None if mask is None else
          ((mask.float() - 1.0) * 1e10)[:, None, None, :].to(q.dtype))
  return cs.graph_ms(lambda _: torch.nn.functional.scaled_dot_product_attention(
      qs, ks, vs, attn_mask=bias, scale=1.0), 10, stream)


def main() -> int:
  if not torch.cuda.is_available():
    print("needs an NVIDIA GPU", file=sys.stderr)
    return 1
  args = sys.argv[1:]
  profile = "--profile" in args
  chosen = [a for a in args if a != "--profile"] or list(VARIANTS)
  unknown = set(chosen) - set(VARIANTS)
  if unknown:
    print(f"no variant {sorted(unknown)}; there are {list(VARIANTS)}",
          file=sys.stderr)
    return 2
  timed = [n for n in chosen if not n.startswith("fault_")]
  faults = [n for n in chosen if n.startswith("fault_")]
  torch.backends.cuda.matmul.allow_tf32 = False
  print(cs.card_line(), flush=True)
  work = Path(tempfile.mkdtemp())
  try:
    started = {name: start_build(name, work) for name in (None, *chosen)}
    libs = {name: finish_build(name, procs) for name, procs in started.items()}
    gen = torch.Generator("cuda").manual_seed(0)
    fwd_runs = []
    if any(VARIANTS[n][0] != "flash_bwd" for n in chosen):
      shapes = [(s, batch, dtype) for s in cs.SHAPES + cs.FAMILY_SHAPES
                for batch, dtype in cs.RUNS]
      shapes.append((cs.SHAPES[0], 8, torch.bfloat16))  # training's encoder
      for (shape, q_len, kv_len, masked, tr), batch, dtype in shapes:
        fwd_runs.append((f"{shape} b={batch} {str(dtype)[6:]}", tr, dtype,
                         cs.attention_inputs(batch, q_len, kv_len, masked,
                                             tr, dtype, gen)))
    stream = torch.cuda.Stream()
    bwd_runs = []
    bwd_shapes = ([(s, 8, torch.float32) for s in cs.SHAPES + cs.FAMILY_SHAPES]
                  + [(s, cs.TRANSCRIBER_BATCH, torch.float32)
                     for s in cs.TRANSCRIBER_SHAPES]
                  + [(s, 8, torch.bfloat16) for s in cs.SHAPES])
    for (shape, q_len, kv_len, masked, _, *more), batch, dtype in bwd_shapes:
      heads = more[0] if more else cs.HEADS
      q, k, v, mask = cs.attention_inputs(batch, q_len, kv_len, masked, False,
                                          dtype, gen, heads)
      out, stats = attention.flash_attention(q, k, v, kv_mask=mask,
                                             return_stats=True)
      dout = torch.randn(out.shape, device="cuda", generator=gen).to(dtype)
      bwd_runs.append((f"bwd {shape} b={batch} h={heads} {str(dtype)[6:]}",
                       (q, k, v, None, mask, out, stats, dout)))

    def use(name):
      for lib, handle in {**libs[None], **libs[name]}.items():
        _build._libraries[lib] = handle  # pylint: disable=protected-access

    def forward(label, tr, q, k, v, mask):
      got = attention.flash_attention(q, k, v, kv_mask=mask, kv_transposed=tr)
      want = attention.attention_reference(q, k, v, kv_mask=mask,
                                           kv_transposed=tr)
      return got, (got.float() - want.float()).abs().max().item(), \
          cs.fwd_tolerance(got.dtype, want)

    def bwd_error(got, want):
      """(error over its tolerance, relative RMS) of one gradient: f32 as
      phase 10 holds it, bf16 as phase 19 does."""
      g, w = got.float(), want.float()
      err = (g - w).abs().max().item()
      tol = (cs.bwd_bf16_tolerance(want) if got.dtype == torch.bfloat16
             else cs.BWD_TOLERANCE * max(1.0, w.abs().max().item()))
      cs.check(err <= tol, f"{name} {label}: {err} > {tol}")
      return err / tol, ((g - w).pow(2).mean() / w.pow(2).mean()).sqrt().item()

    order = [None, *timed, *reversed(timed), None]
    times, base, worst = {}, {}, {}
    for name in order:
      use(name)
      same_bits = VARIANTS[name][2] if name else True
      w = worst.setdefault(name, [0.0] * 5)
      for label, tr, dtype, (q, k, v, mask) in fwd_runs:

        def fn():
          return attention.flash_attention(q, k, v, kv_mask=mask,
                                            kv_transposed=tr)

        got, err, tol = forward(label, tr, q, k, v, mask)
        cs.check(err <= tol, f"{name} {label}: {err} > {tol}")
        w[0] = max(w[0], err / tol)
        if same_bits:
          cs.check(torch.equal(base.setdefault(label, got), got),
                   f"{name} {label}: other bits than the base")
        times.setdefault((label, name), []).append(
            cs.graph_ms(lambda _: fn(), 20, stream))
      for label, args in bwd_runs:

        def fn():
          return attention.flash_attention_bwd(*args)

        got = fn()
        low = got[0].dtype == torch.bfloat16
        for g, ref in zip(got,
                          attention.flash_attention_bwd_reference(*args)):
          ratio, rms = bwd_error(g, ref)
          w[2 if low else 1] = max(w[2 if low else 1], ratio)
          w[4 if low else 3] = max(w[4 if low else 3], rms)
        if same_bits:
          cs.check(all(torch.equal(a, b) for a, b in zip(
              base.setdefault(label, got), got)),
                   f"{name} {label}: other bits than the base")
        times.setdefault((label, name), []).append(cs.cuda_ms(fn, 5))
    names = [None, *timed]
    print("ms, best of two | " + " | ".join(n or "base" for n in names))
    for label in [r[0] for r in fwd_runs] + [r[0] for r in bwd_runs]:
      print(f"{label} | " + " | ".join(
          f"{min(times[(label, n)]):.4f}" for n in names), flush=True)
    for label, tr, dtype, (q, k, v, mask) in fwd_runs:
      plain_ms = cs.graph_ms(lambda _: attention.attention_reference(
          q, k, v, kv_mask=mask, kv_transposed=tr), 10, stream)
      bound, bound_by, _ = cs.bound_ms(q.shape[0], q.shape[1],
                                       k.shape[2 if tr else 1],
                                       mask is not None, dtype)
      print(f"{label}: plain {plain_ms:.4f} ms, sdpa "
            f"{sdpa_ms(q, k, v, mask, tr, stream):.4f} ms, bound "
            f"{bound:.4f} ms ({bound_by})", flush=True)
    for n in names:
      fwd, bwd, bwd_bf16, rms, rms_bf16 = worst[n]
      print(f"{n or 'base'}: worst error / tolerance {fwd:.3g} forward, "
            f"{bwd:.3g} backward f32, {bwd_bf16:.3g} backward bf16; backward "
            f"relative RMS {rms:.3g} f32, {rms_bf16:.3g} bf16")
    if profile:
      for name in names:
        use(name)
        for label, tr, _, (q, k, v, mask) in fwd_runs:
          print(f"{name or 'base'} {label}: " + "; ".join(
              f"{k_} {ms:.4f} ms" for k_, ms in kernel_ms(
                  lambda: attention.flash_attention(
                      q, k, v, kv_mask=mask, kv_transposed=tr))), flush=True)
        for label, args_ in bwd_runs:
          print(f"{name or 'base'} {label}: " + "; ".join(
              f"{k} {ms:.4f} ms" for k, ms in kernel_ms(
                  lambda: attention.flash_attention_bwd(*args_))), flush=True)
    missed = []
    for name in faults:
      use(name)
      caught = []
      for label, tr, dtype, (q, k, v, mask) in fwd_runs:
        got, err, tol = forward(label, tr, q, k, v, mask)
        if torch.equal(got, base[label]):
          continue  # the fault does not touch this run
        caught.append(err / tol)
        print(f"{name} {label}: max |kernel - plain| {err:.4g}, limit "
              f"{tol:.4g} ({err / tol:.3g}x)", flush=True)
        if err <= tol:
          missed.append(f"{name} {label}")
      print(f"{name}: changes {len(caught)} of {len(fwd_runs)} runs, "
            f"error / limit at least {min(caught, default=0.0):.3g}")
    cs.check(not missed, f"faults within the limits: {missed}")
  finally:
    shutil.rmtree(work, ignore_errors=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
