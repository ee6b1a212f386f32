"""Card times of the PyTorch port's attention kernels in one tree.

    python3 tools/torch_attention_times.py <tree root> <label>

Builds `ops/csrc/flash_fwd.cu` and `flash_bwd.cu` of the tree at <tree
root> (a checkout of the repo, e.g. an older commit unpacked with
`git archive` into a git-ignored directory) and times them as
`chip_smoke.py` phases 3 and 10 do, on the same seeded inputs: the forward
at the 16 (shape, batch, dtype) runs of phase 3 and the backward at the 4
training shapes at b=8. Prints one line `RESULT {json}` with the card's
nvidia-smi name and power limit and the ms of each run. Kernel calls only:
no plain version, no SDPA, no correctness check (chip_smoke does those).

To compare two trees on one card, run them in turns in one command, e.g.

    for t in "old old" ". new" ". new" "old old"; do
      python3 tools/torch_attention_times.py $t; done

Imports torch and the tree's port package and chip_smoke.py, not JAX.
"""

import json
import os
import sys
import time


def main() -> int:
  root, label = sys.argv[1], sys.argv[2]
  sys.path.insert(0, os.path.abspath(root))
  os.chdir(root)
  # The tree's own modules, imported once its root is on the path.
  # pylint: disable=import-outside-toplevel
  import torch
  import chip_smoke as cs
  from music_spectrogram_diffusion_tpu_torch.ops import _build, attention
  if not torch.cuda.is_available():
    print("needs an NVIDIA GPU", file=sys.stderr)
    return 1
  torch.backends.cuda.matmul.allow_tf32 = False
  t0 = time.perf_counter()
  _build.build("flash_fwd", "flash_bwd")
  build_s = time.perf_counter() - t0
  gen = torch.Generator("cuda").manual_seed(0)
  forward = {}
  for name, q_len, kv_len, masked, transposed in cs.SHAPES:
    for batch, dtype in cs.RUNS:
      q, k, v, mask = cs.attention_inputs(batch, q_len, kv_len, masked,
                                          transposed, dtype, gen)
      dt = str(dtype).replace("torch.", "")
      forward[f"{name} b={batch} {dt}"] = cs.cuda_ms(
          lambda: attention.flash_attention(q, k, v, kv_mask=mask,
                                            kv_transposed=transposed),
          20 if q_len > 256 else 100)
  backward = {}
  for name, q_len, kv_len, masked, _ in cs.SHAPES:
    q, k, v, mask = cs.attention_inputs(8, q_len, kv_len, masked, False,
                                        torch.float32, gen)
    out, stats = attention.flash_attention(q, k, v, kv_mask=mask,
                                           return_stats=True)
    dout = torch.randn(out.shape, device="cuda", generator=gen)
    backward[name] = cs.cuda_ms(
        lambda: attention.flash_attention_bwd(q, k, v, None, mask, out, stats,
                                              dout),
        3 if q_len > 256 else 20)
  print("RESULT", json.dumps({
      "label": label, "card": cs.card_line(), "build_s": build_s,
      "forward": forward, "backward": backward}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
