"""Card times of the port's int8 GEMM kernel (`ops/csrc/qmm.cu`).

    python3 tools/torch_qmm_times.py <tree root> <label>
    python3 tools/torch_qmm_times.py --sweep
    python3 tools/torch_qmm_times.py --scan
    python3 tools/torch_qmm_times.py --faults

The first form builds the `qmm.cu` of the tree at <tree root> (a checkout
of the repo, e.g. an older commit unpacked with `git archive` into a
git-ignored directory) and times that tree's `quantized_matmul` at the 16
(M, K, N, dtype) of chip_smoke.py phase 4, on the same seeded inputs in
every tree: the kernel as CUDA-graph replays over weights cycled past the
50 MB L2 (each call reads its weight from HBM, as on the main path), the
kernel eager a call (host clock over back-to-back calls, synchronized:
the wrapper's host time included), and the bf16 matmul (cuBLAS on x in
bf16 times the dequantized bf16 weight, the yardstick). Prints one line
`RESULT {json}` with the card's nvidia-smi name and power limit. To
compare two trees on one card, run them in turns in one command:

    for t in "old old" ". new" ". new" "old old"; do
      python3 tools/torch_qmm_times.py $t; done

--sweep times this tree's kernel at every tile configuration
(`quantize.CONFIGS`) and K split the kernel takes at each of the 16
shapes, each held against the plain version at chip_smoke's QMM_TOLERANCE
and two launches bitwise equal; the plan's own choice is marked. It is the
measurement `quantize.plan`'s rule was set from.

--scan times a few configurations against K (see `scan`).

--faults builds this tree's kernel with one planted fault at a time, in a
temporary copy of the sources: `fault_skip_tile` leaves 64 rows of K out
of the first K range (one 64-wide K step of the wgmma route, rows 64-127
of the GEMV route), `fault_drop_split` leaves the last split out of the
split-K sum. At every shape where a fault changes the output it prints the
error against the plain version over chip_smoke's limit there, and fails
unless the limit catches it.

Needs a card and, for a build, the CUDA toolkit (nvcc). Imports torch and
the tree's port package and chip_smoke.py, not JAX.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

FAULTS = {
    "fault_skip_tile": {
        "    const uint64_t a = msd::sw128_desc(":
        "    if (split == 0 && kt == 1) {\n"
        "      if (kt + 1 < num_k) widen(kt + 1);\n"
        "      continue;\n"
        "    }\n"
        "    const uint64_t a = msd::sw128_desc(",
        "      const bool ok = k0 + kl + j * kGemvLanes < kps;":
        "      const bool ok = k0 + kl + j * kGemvLanes < kps &&\n"
        "                      !(split == 0 && k0 + kl + j * kGemvLanes >= 64 &&\n"
        "                        k0 + kl + j * kGemvLanes < 128);"},
    "fault_drop_split": {"    if (z < splits) sum += v[z];":
                         "    if (z < splits - 1) sum += v[z];",
                         "    if (z < splits) {\n      sum.x += v[z].x;":
                         "    if (z < splits - 1) {\n      sum.x += v[z].x;"},
}

def build_edited(work, name, edits):
  """Starts nvcc on a copy of csrc/ with `edits` (old text: new text) made
  to qmm.cu; returns (library path, process)."""
  # pylint: disable=import-outside-toplevel
  from music_spectrogram_diffusion_tpu_torch.ops import _build
  src = work / name
  shutil.copytree(_build.CSRC, src, ignore=shutil.ignore_patterns("build"))
  text = (src / "qmm.cu").read_text()
  for old, new in edits.items():
    if old not in text:
      raise RuntimeError(f"{name}: no source line {old!r}")
    text = text.replace(old, new)
  (src / "qmm.cu").write_text(text)
  return src / "qmm.so", subprocess.Popen(
      [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(src / "qmm.so"),
       str(src / "qmm.cu")], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
      text=True)


def load_built(name, path, proc):
  stdout, stderr = proc.communicate()
  if proc.returncode:
    raise RuntimeError(f"{name}: nvcc failed\n{stdout}{stderr}")
  return ctypes.CDLL(str(path))


def use_library(lib):
  """Makes `quantize` launch `lib` from its next plan on."""
  # pylint: disable=import-outside-toplevel,protected-access
  from music_spectrogram_diffusion_tpu_torch.ops import _build, quantize
  _build._libraries["qmm"] = lib
  quantize._LAUNCHES.clear()


def inputs(cs, quantize, torch):
  """[(shape row, x, weights cycled past the L2, scales)] at phase 4's
  shapes, from one seeded generator."""
  gen = torch.Generator("cuda").manual_seed(0)
  experiment = cs.serving_experiment()
  out = []
  for m, k, n, dtype, per_segment, what in cs.qmm_shapes(
      experiment, experiment.task_lengths.inputs):
    copies = int(-(-cs.L2_BYTES // (k * n))) + 1
    q, s = quantize.quantize_kernel(
        torch.randn(k, n, device="cuda", generator=gen) * k ** -0.5)
    x = torch.randn(m, k, device="cuda", generator=gen).to(dtype)
    out.append(((m, k, n, dtype, per_segment, what), x,
                [q] + [q.clone() for _ in range(copies - 1)],
                [s] + [s.clone() for _ in range(copies - 1)]))
  return out


def eager_ms(torch, fn, iters):
  """Mean host ms of fn(i) over back-to-back calls, synchronized."""
  for i in range(3):
    fn(i)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for i in range(iters):
    fn(i)
  torch.cuda.synchronize()
  return 1e3 * (time.perf_counter() - t0) / iters


def times(root, label):
  sys.path.insert(0, os.path.abspath(root))
  os.chdir(root)
  # The tree's own modules, imported once its root is on the path.
  # pylint: disable=import-outside-toplevel
  import torch
  import chip_smoke as cs
  from music_spectrogram_diffusion_tpu_torch.ops import _build, quantize
  t0 = time.perf_counter()
  _build.build("qmm")
  build_s = time.perf_counter() - t0
  stream = torch.cuda.Stream()
  sms = torch.cuda.get_device_properties(0).multi_processor_count
  rows = {}
  for (m, k, n, dtype, per_segment, what), x, qs, ss in inputs(
      cs, quantize, torch):
    copies = len(qs)
    iters = max(2 * copies, 50)

    def kernel(i):
      return quantize.quantized_matmul(x, qs[i % copies], ss[i % copies])

    xb = x.to(torch.bfloat16)
    wb = [quantize.dequantize_kernel(qi, si, torch.bfloat16)
          for qi, si in zip(qs, ss)]
    if hasattr(quantize, "plan"):
      p = quantize.plan(m, k, n, sms)
      route = f"{'gemv' if p.route == quantize.GEMV else 'wgmma'} {p.rows}x{p.cols}"
      splits = p.splits
    else:
      route, splits = "wmma", quantize.split_k(m, k, n, sms)
    dt = str(dtype).replace("torch.", "")
    rows[f"{m}x{k}x{n} {dt}"] = dict(
        launches_per_segment=per_segment, route=route, splits=splits,
        graph_ms=cs.graph_ms(kernel, iters, stream),
        eager_ms=eager_ms(torch, kernel, iters),
        bf16_matmul_ms=cs.graph_ms(lambda i: xb @ wb[i % copies], iters,
                                   stream))
    del wb
  per_segment = sum(r["graph_ms"] * r["launches_per_segment"]
                    for r in rows.values())
  print("RESULT", json.dumps({
      "label": label, "card": cs.card_line(), "build_s": build_s,
      "ms_per_segment": per_segment, "shapes": rows}), flush=True)
  return 0


def sweep():
  # pylint: disable=import-outside-toplevel
  import torch
  import chip_smoke as cs
  from music_spectrogram_diffusion_tpu_torch.ops import _build, quantize
  _build.build("qmm")
  print(cs.card_line(), flush=True)
  for line in cs.ptxas_usage("qmm"):
    print(f"  ptxas qmm: {line}", flush=True)
  stream = torch.cuda.Stream()
  sms = torch.cuda.get_device_properties(0).multi_processor_count
  results, failed = {}, []
  for (m, k, n, dtype, per_segment, _), x, qs, ss in inputs(
      cs, quantize, torch):
    copies = len(qs)
    iters = max(2 * copies, 50)
    want = quantize.qmm_reference(x, qs[0], ss[0])
    tol = cs.QMM_TOLERANCE[dtype] * want.float().abs().max().item()
    chosen = quantize.plan(m, k, n, sms)
    configs = [c for c, row in enumerate(quantize.CONFIGS)
               if (row[0] == quantize.GEMV) == (m <= quantize.GEMV_MAX_M)]
    shape = f"{m}x{k}x{n} {str(dtype)[6:]}"
    line = []
    for config in configs:
      for splits in range(1, quantize.MAX_SPLITS + 1):
        try:
          p = quantize.plan(m, k, n, sms, config=config, splits=splits)
        except ValueError:
          continue
        launch = quantize.Launch(p, dtype, dtype)

        def run(i, launch=launch):
          out = torch.empty(m, n, dtype=dtype, device="cuda")
          launch(x, qs[i % copies], ss[i % copies], out)
          return out

        got, again = run(0), run(0)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if err > tol or not torch.equal(got, again):
          failed.append(f"{shape} c{config} s{splits}: err {err:.3g} (tol "
                        f"{tol:.3g}), repeat equal {torch.equal(got, again)}")
          line.append(f"c{config}/s{splits} FAILED")
          continue
        ms = cs.graph_ms(run, iters, stream)
        mark = "*" if p == chosen else ""
        results[f"{shape} c{config} s{splits}"] = ms
        line.append(f"c{config}/s{splits}{mark} {1e3 * ms:.2f}")
    print(f"{shape} ({per_segment} a segment), us: " + ", ".join(line),
          flush=True)
  print("RESULT", json.dumps({"card": cs.card_line(), "us": {
      k: 1e3 * v for k, v in results.items()}, "failed": failed}), flush=True)
  for line in failed:
    print(f"FAILED {line}", flush=True)
  return 1 if failed else 0


def scan():
  """Time against K at fixed M and N, one configuration and no split, beside
  the bf16 matmul: the slope is the cost of K, the intercept the call's
  fixed cost. Then copies of 1-16 MiB, from HBM and from L2."""
  # pylint: disable=import-outside-toplevel
  import torch
  import chip_smoke as cs
  from music_spectrogram_diffusion_tpu_torch.ops import _build, quantize
  _build.build("qmm")
  print(cs.card_line(), flush=True)
  stream = torch.cuda.Stream()
  gen = torch.Generator("cuda").manual_seed(0)
  for m, n, config in ((1, 3072, 1), (2, 3072, 1), (1, 3072, 0),
                       (2, 3072, 0), (512, 768, 2)):
    line = []
    for k in (256, 512, 1024, 2048):
      copies = int(-(-cs.L2_BYTES // (k * n))) + 1
      qs = [torch.randint(-127, 128, (k, n), dtype=torch.int8, device="cuda",
                          generator=gen) for _ in range(copies)]
      s = torch.rand(n, device="cuda", generator=gen)
      x = torch.randn(m, k, device="cuda", generator=gen).to(torch.bfloat16)
      p = quantize.plan(m, k, n, 132, config=config, splits=1)
      launch = quantize.Launch(p, x.dtype, x.dtype)
      out = torch.empty(m, n, dtype=x.dtype, device="cuda")
      ms = cs.graph_ms(lambda i: launch(x, qs[i % copies], s, out),
                       max(2 * copies, 50), stream)
      wb = [qi.to(torch.bfloat16) for qi in qs]
      lib = cs.graph_ms(lambda i: x @ wb[i % copies], max(2 * copies, 50),
                        stream)
      line.append(f"K={k} {1e3 * ms:.2f} (bf16 matmul {1e3 * lib:.2f})")
      del wb
    print(f"M={m} N={n} config {config} (us): " + ", ".join(line), flush=True)
  for mb in (1, 4, 16):
    n = mb * 2 ** 20
    copies = int(-(-cs.L2_BYTES // n)) + 1
    src = [torch.empty(n, dtype=torch.uint8, device="cuda")
           for _ in range(copies)]
    dst = torch.empty(n, dtype=torch.uint8, device="cuda")
    ms = cs.graph_ms(lambda i: dst.copy_(src[i % copies]),
                     max(2 * copies, 50), stream)
    hot = cs.graph_ms(lambda i: dst.copy_(src[0]), 50, stream)
    print(f"copy {mb} MiB: {1e3 * ms:.2f} us from HBM, {1e3 * hot:.2f} us "
          "from L2", flush=True)
  return 0


def faults():
  # pylint: disable=import-outside-toplevel
  import torch
  import chip_smoke as cs
  from music_spectrogram_diffusion_tpu_torch.ops import quantize
  print(cs.card_line(), flush=True)
  work = Path(tempfile.mkdtemp())
  try:
    started = {n: build_edited(work, n, e) for n, e in FAULTS.items()}
    libs = {n: load_built(n, *started[n]) for n in FAULTS}
    data = inputs(cs, quantize, torch)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst = {}
    for name, lib in libs.items():
      use_library(lib)
      for (m, k, n, dtype, _, _), x, qs, ss in data:
        want = quantize.qmm_reference(x, qs[0], ss[0])
        tol = cs.QMM_TOLERANCE[dtype] * want.float().abs().max().item()
        p = quantize.plan(m, k, n, sms)
        err = (quantize.quantized_matmul(x, qs[0], ss[0]).float()
               - want.float()).abs().max().item()
        shape = f"{m}x{k}x{n} {str(dtype)[6:]} (splits {p.splits})"
        if err <= tol:
          print(f"  {name} {shape}: err {err:.3g} within the limit "
                f"{tol:.3g}: unchanged here", flush=True)
          cs.check(name != "fault_skip_tile" and p.splits == 1,
                   f"{name} at {shape} is not caught")
          continue
        worst[name] = min(worst.get(name, float("inf")), err / tol)
        print(f"  {name} {shape}: err {err:.3g}, {err / tol:.1f}x the "
              f"limit {tol:.3g}", flush=True)
    print("RESULT", json.dumps({"card": cs.card_line(),
                                "least_over_limit": worst}), flush=True)
  finally:
    shutil.rmtree(work, ignore_errors=True)
  return 0


def main() -> int:
  sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
  import torch  # pylint: disable=import-outside-toplevel
  if not torch.cuda.is_available():
    print("needs an NVIDIA GPU", file=sys.stderr)
    return 1
  torch.backends.cuda.matmul.allow_tf32 = False
  if sys.argv[1:] == ["--sweep"]:
    return sweep()
  if sys.argv[1:] == ["--faults"]:
    return faults()
  if sys.argv[1:] == ["--scan"]:
    return scan()
  if len(sys.argv) != 3:
    print(__doc__, file=sys.stderr)
    return 2
  return times(sys.argv[1], sys.argv[2])


if __name__ == "__main__":
  sys.exit(main())
