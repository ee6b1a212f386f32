"""The port stands alone: importing every module of it (and chip_smoke.py
and the port's card tools, tools/torch_*.py) pulls in neither JAX nor the
JAX package, and a request for the card on a
machine without one raises instead of running on the CPU: serving (every
model family), the MIDI CLI, the vocoders (weights-free and trained), and
training (the trainer and cli/train.py)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import music_spectrogram_diffusion_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__,
                                                port.__name__ + ".")]
for name in names:
  importlib.import_module(name)
importlib.import_module("chip_smoke")
import glob, importlib.util
for path in sorted(glob.glob("tools/torch_*.py")):
  spec = importlib.util.spec_from_file_location(path[6:-3], path)
  spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax",
                                    "music_spectrogram_diffusion_tpu"))
assert not bad, bad
assert len(names) >= 20, names

import torch
assert not torch.cuda.is_available()
from music_spectrogram_diffusion_tpu_torch import config
from music_spectrogram_diffusion_tpu_torch.audio import vocoder
from music_spectrogram_diffusion_tpu_torch.cli import synthesize_midi
from music_spectrogram_diffusion_tpu_torch.cli import train as train_cli
from music_spectrogram_diffusion_tpu_torch.infer import inference
from music_spectrogram_diffusion_tpu_torch.train import trainer
import tempfile
never_written = tempfile.mkdtemp()
for make in (lambda: inference.InferenceModel(config.preset("context_tiny")),
             lambda: inference.build_model(config.preset("context_tiny")),
             lambda: inference.InferenceModel(config.preset("ar_tiny")),
             lambda: inference.InferenceModel(config.preset("diffusion_tiny"),
                                              compute_dtype="int8"),
             lambda: trainer.build_model(config.preset("ar_tiny")),
             lambda: trainer.build_model(config.preset("diffusion_tiny")),
             lambda: inference.InferenceModel(config.preset("context_tiny"),
                                              compute_dtype="int8"),
             lambda: synthesize_midi.build_model(synthesize_midi.parse_args(
                 ["--midi", "song.mid", "--output", "song.wav",
                  "--size", "tiny"])),
             lambda: vocoder.GriffinLimVocoder(),
             lambda: vocoder.load_trained(vocoder.TRAINED_MAGNITUDE_GL),
             lambda: trainer.build_model(config.preset("context_tiny")),
             lambda: train_cli.main(["--synthetic", "--preset",
                                     "context_tiny", "--model_dir",
                                     never_written])):
  try:
    make()
  except RuntimeError as e:
    assert "cuda" in str(e), e
  else:
    raise AssertionError("a cuda request ran without a card")
import os
assert not os.listdir(never_written)
os.rmdir(never_written)
print("isolated", len(names))
"""


def test_port_imports_no_jax_and_refuses_missing_cuda():
  env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
  env["CUDA_VISIBLE_DEVICES"] = ""  # no card, even on a machine with one
  proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                        capture_output=True, text=True, timeout=300)
  assert proc.returncode == 0, proc.stderr
  assert "isolated" in proc.stdout
