"""Build the port's native code and load it through ctypes.

Each source under `ops/csrc/` exposes a plain C interface, so it is
compiled alone into a shared library: no PyTorch headers, no CUTLASS, no
ninja. A CUDA kernel (`<name>.cu`) is compiled by `nvcc`; host code
(`<name>.cc`, the PGHI heap) by `g++`. The library is built on first use
into `ops/csrc/build/` (git-ignored), under a name keyed by a hash of the
source, for a `.cu` of every header in `csrc/` (`*.cuh`, which the kernels
share), and of the flags, so an edited source or header is rebuilt and an
unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# The JAX package's flags for its host heap (native/__init__.py): no
# -march, so no FMA contraction and the same float arithmetic as there.
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_libraries: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
  """The CUDA compiler: `nvcc` on PATH, else the toolkit's default place."""
  found = shutil.which("nvcc")
  if found:
    return found
  default = Path("/usr/local/cuda/bin/nvcc")
  if default.exists():
    return str(default)
  raise RuntimeError(
      "nvcc not found (neither on PATH nor at /usr/local/cuda/bin/nvcc); "
      "the port's CUDA kernels are built from source on first use")


def gxx_path() -> str:
  """The host C++ compiler: `g++` on PATH."""
  found = shutil.which("g++")
  if not found:
    raise RuntimeError("g++ not found on PATH; the port's host code "
                       "(csrc/*.cc) is built from source on first use")
  return found


def _source(name: str) -> Path:
  """`csrc/<name>.cu` if there is one, else `csrc/<name>.cc`."""
  cu = CSRC / f"{name}.cu"
  return cu if cu.exists() else CSRC / f"{name}.cc"


def _command(name: str, out: str) -> List[str]:
  src = _source(name)
  if src.suffix == ".cu":
    return [nvcc_path(), *NVCC_FLAGS, "-o", out, str(src)]
  return [gxx_path(), *GXX_FLAGS, "-o", out, str(src)]


def library_path(name: str) -> Path:
  """Where `csrc/<name>.cu` (or `.cc`) is built: keyed by the source, for a
  `.cu` the headers in `csrc/`, and the flags."""
  src = _source(name)
  digest = hashlib.sha256(src.read_bytes())
  if src.suffix == ".cu":
    for header in sorted(CSRC.glob("*.cuh")):
      digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
  else:
    digest.update(" ".join(GXX_FLAGS).encode())
  return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(*names: str) -> None:
  """Compile each `csrc/<name>.cu` (or `.cc`) that has no build of its
  source yet.

  The compilers all start together and run in parallel. Each
  compiler's report (registers, shared memory, spills per kernel, from
  `-Xptxas -v`) is kept beside its library as `<library>.log`. Whatever
  fails, no compiler is left running and no temporary file is left behind.
  """
  todo = [name for name in names if not library_path(name).exists()]
  if not todo:
    return
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  temps, procs, failures = [], [], []
  try:
    for name in todo:
      fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
      os.close(fd)
      temps.append(tmp)
      procs.append(subprocess.Popen(
          _command(name, tmp), stdout=subprocess.PIPE,
          stderr=subprocess.PIPE, text=True))
    for name, tmp, proc in zip(todo, temps, procs):
      stdout, stderr = proc.communicate()
      if proc.returncode != 0:
        src = _source(name)
        compiler = "nvcc" if src.suffix == ".cu" else "g++"
        failures.append(f"{compiler} failed on {src.name} (exit "
                        f"{proc.returncode}):\n{stdout}\n{stderr}")
        continue
      out = library_path(name)
      Path(str(out) + ".log").write_text(stdout + stderr)
      os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
  finally:
    for proc in procs:
      if proc.poll() is None:
        proc.kill()
        proc.wait()
    for tmp in temps:
      if os.path.exists(tmp):
        os.remove(tmp)
  if failures:
    raise RuntimeError("\n".join(failures))


def load(name: str) -> ctypes.CDLL:
  """Build (if needed) and load `csrc/<name>.cu` (or `.cc`); one handle per
  process."""
  with _lock:
    if name not in _libraries:
      build(name)
      _libraries[name] = ctypes.CDLL(str(library_path(name)))
    return _libraries[name]


def compiler_report(name: str) -> str:
  """The `-Xptxas -v` report of the current build of `csrc/<name>.cu`."""
  log = Path(str(library_path(name)) + ".log")
  return log.read_text() if log.exists() else ""
