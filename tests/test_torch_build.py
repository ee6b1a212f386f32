"""The port's kernel build (`ops/_build.py`) with a stand-in compiler.

The real compiler is `nvcc`, which only the card's machine has; these tests
give `build` a shell script in its place and check what `build` does around
the compilers it starts: a failed source is reported while the others are
kept, a built source is not compiled again, and a failure part-way through
leaves no compiler running and no temporary file behind; an edited shared
header (`csrc/*.cuh`) starts a new build.
"""

import subprocess

import pytest

from music_spectrogram_diffusion_tpu_torch.ops import _build

# Compiles `*.cu` to the `-o` path and reports registers, as nvcc -Xptxas -v
# does; a source named bad.cu fails.
FAKE_NVCC = """#!/bin/sh
for arg; do src=$arg; done
while [ $# -gt 0 ]; do
  if [ "$1" = -o ]; then out=$2; fi
  shift
done
case $src in *bad.cu) echo "error in $src" >&2; exit 2;; esac
echo "ptxas info    : Used 32 registers"
echo built > "$out"
"""


@pytest.fixture
def tree(tmp_path, monkeypatch):
  csrc = tmp_path / "csrc"
  csrc.mkdir()
  for name in ("good", "bad", "other"):
    (csrc / f"{name}.cu").write_text(f"// {name}\n")
  nvcc = tmp_path / "nvcc"
  nvcc.write_text(FAKE_NVCC)
  nvcc.chmod(0o755)
  monkeypatch.setattr(_build, "CSRC", csrc)
  monkeypatch.setattr(_build, "BUILD_DIR", csrc / "build")
  monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
  return csrc / "build"


def test_build_reports_failures_and_keeps_what_built(tree, monkeypatch):
  with pytest.raises(RuntimeError, match=r"nvcc failed on bad\.cu"):
    _build.build("good", "bad")
  lib = _build.library_path("good")
  assert lib.read_text() == "built\n"
  assert "32 registers" in _build.compiler_report("good")
  assert not _build.library_path("bad").exists()
  assert sorted(p.name for p in tree.iterdir()) == sorted(
      [lib.name, lib.name + ".log"])
  # A source that is built already starts no compiler.

  def no_compiler():
    raise AssertionError("nvcc started for a built source")

  monkeypatch.setattr(_build, "nvcc_path", no_compiler)
  _build.build("good")


def test_build_stops_started_compilers_when_a_launch_fails(tree, tmp_path,
                                                           monkeypatch):
  slow = tmp_path / "slow_nvcc"
  slow.write_text("#!/bin/sh\nexec sleep 60\n")
  slow.chmod(0o755)
  paths = iter([str(slow)])

  def nvcc_path():
    path = next(paths, None)
    if path is None:
      raise RuntimeError("nvcc not found")
    return path

  started = []
  popen = subprocess.Popen

  def recording_popen(*args, **kwargs):
    started.append(popen(*args, **kwargs))
    return started[-1]

  monkeypatch.setattr(_build, "nvcc_path", nvcc_path)
  monkeypatch.setattr(subprocess, "Popen", recording_popen)
  with pytest.raises(RuntimeError, match="nvcc not found"):
    _build.build("good", "other")
  assert len(started) == 1
  assert started[0].poll() is not None  # stopped, not left running
  assert list(tree.iterdir()) == []  # no temporary library left


def test_editing_a_shared_header_rebuilds(tree):
  """The sources include `csrc/*.cuh`: an edited header names a new
  library, so the next build compiles again instead of loading a stale one."""
  header = _build.CSRC / "shared.cuh"
  header.write_text("// v1\n")
  _build.build("good")
  first = _build.library_path("good")
  assert first.exists()
  header.write_text("// v2\n")
  second = _build.library_path("good")
  assert second != first and not second.exists()
  _build.build("good")
  assert second.read_text() == "built\n"
  # An unchanged tree keeps its path.
  assert _build.library_path("good") == second
