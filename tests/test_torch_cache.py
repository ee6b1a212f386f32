"""The port's offline tokenization cache against the JAX package's.

The record format is the JAX package's byte for byte: the same examples
written by both `write_cache`s give the same shard files. A synthetic
cache the JAX package wrote (its chunks hold a pickled NoteSequence of the
JAX package) is read by the port, in a process that never imports the JAX
package, as the chunks the port tokenizes itself; and a task with a
`cache_dir` reads its chunks back from there.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from music_spectrogram_diffusion_tpu.audio import codecs as jax_codecs
from music_spectrogram_diffusion_tpu.data import cache as jax_cache
from music_spectrogram_diffusion_tpu.data import core as jax_core
from music_spectrogram_diffusion_tpu.data import registry as jax_registry
from music_spectrogram_diffusion_tpu_torch import config
from music_spectrogram_diffusion_tpu_torch.audio import codecs
from music_spectrogram_diffusion_tpu_torch.data import cache, core
from music_spectrogram_diffusion_tpu_torch.data import datasets, registry
from music_spectrogram_diffusion_tpu_torch.midi import sequences

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _examples(n=5):
  r = np.random.RandomState(0)
  return [{
      "inputs": r.randint(0, 1000, r.randint(1, 40)).astype(np.int32),
      "targets": r.randn(r.randint(1, 9), 7).astype(np.float32),
      "times": r.rand(3).astype(np.float64),
      "flags": r.rand(4) > 0.5,
      "big": np.asarray([2 ** 40 + i, -3], np.int64),
      "scalar": np.float32(i),
      "id": f"song-{i}",
      "raw": bytes([i, 255, 0]),
  } for i in range(n)]


def _assert_examples_equal(got, want):
  assert set(got) == set(want)
  for k, w in want.items():
    g = got[k]
    if isinstance(w, (bytes, str)):
      assert g == (w.encode() if isinstance(w, str) else w), k
    elif isinstance(w, sequences.NoteSequence):
      assert g == w, k
    else:
      w = np.asarray(w)
      assert g.dtype == w.dtype and g.shape == w.shape, k
      np.testing.assert_array_equal(g, w, err_msg=k)


def test_round_trip(tmp_path):
  examples = _examples()
  meta = cache.write_cache(core.Dataset.from_list(examples), str(tmp_path),
                           examples_per_shard=2)
  assert meta == {"num_examples": 5, "num_shards": 3}
  assert cache.cache_exists(str(tmp_path))
  assert cache.cache_metadata(str(tmp_path)) == meta
  got = list(cache.read_cache(str(tmp_path)))
  assert len(got) == 5
  for g, w in zip(got, examples):
    _assert_examples_equal(g, w)
  # A rebuild with fewer shards leaves no stale shard behind.
  cache.write_cache(core.Dataset.from_list(examples[:1]), str(tmp_path))
  assert sorted(os.listdir(tmp_path)) == [cache.METADATA_FILE,
                                          "cache-00000.tfrecord"]
  assert len(list(cache.read_cache(str(tmp_path)))) == 1


def test_an_unfinished_cache_does_not_exist(tmp_path, monkeypatch):
  cache.write_cache(core.Dataset.from_list(_examples(2)), str(tmp_path))

  def broken():
    yield _examples(1)[0]
    raise OSError("disk full")

  with pytest.raises(OSError):
    cache.write_cache(core.Dataset.from_generator(broken), str(tmp_path))
  assert not cache.cache_exists(str(tmp_path))
  assert not cache.cache_exists(None)


@pytest.mark.parametrize("per_shard", [2, 128])
def test_shards_byte_identical_to_jax(tmp_path, per_shard):
  examples = _examples()
  cache.write_cache(core.Dataset.from_list(examples), str(tmp_path / "port"),
                    examples_per_shard=per_shard)
  jax_cache.write_cache(jax_core.Dataset.from_list(examples),
                        str(tmp_path / "jax"), examples_per_shard=per_shard)
  names = sorted(os.listdir(tmp_path / "jax"))
  assert sorted(os.listdir(tmp_path / "port")) == names
  for name in names:
    assert ((tmp_path / "port" / name).read_bytes()
            == (tmp_path / "jax" / name).read_bytes()), name
  for record, example in zip(
      datasets.iter_tfrecords(str(tmp_path / "jax" / "cache-00000.tfrecord")),
      examples):
    assert record == cache.encode_example(example)


def _task_kwargs(experiment):
  return dict(vocab_config=experiment.vocab_config(),
              note_rep=experiment.note_rep(), with_context=True,
              program_granularity=experiment.program_granularity,
              num_examples=2, duration=3.0, seed=5)


def _jax_task(experiment, cache_root):
  from music_spectrogram_diffusion_tpu.data import tasks as jax_tasks
  kwargs = _task_kwargs(experiment)
  kwargs["note_rep"] = jax_tasks.NoteRepresentationConfig(
      onsets_only=experiment.onsets_only,
      include_ties=experiment.include_ties)
  return jax_registry.synthetic_cached_task(
      "train", audio_codec=jax_codecs.MelGan(), cache_root=cache_root,
      **kwargs)


_READER = r"""
import json, sys
import numpy as np
from music_spectrogram_diffusion_tpu_torch.data import cache
from music_spectrogram_diffusion_tpu_torch.midi import sequences
chunks = list(cache.read_cache(sys.argv[1]))
seqs = [c.pop("sequence") for c in chunks]
assert all(type(s) is sequences.NoteSequence for s in seqs), seqs
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax",
                                    "music_spectrogram_diffusion_tpu"))
assert not bad, bad
np.savez(sys.argv[2], **{f"{i}/{k}": v for i, c in enumerate(chunks)
                        for k, v in c.items() if not isinstance(v, bytes)})
print(json.dumps({"chunks": len(chunks), "notes": [len(s.notes) for s in seqs],
                  "ids": [c["id"].decode() for c in chunks]}))
"""


def test_port_reads_a_jax_written_synthetic_cache(tmp_path):
  """In a process without the JAX package: the JAX-written chunks decode,
  their NoteSequences as the port's class, and equal the port's own
  tokenized chunks of the same songs."""
  experiment = config.preset("context_tiny")
  jax_task = _jax_task(experiment, str(tmp_path))
  assert jax_task.cache_dir == str(tmp_path / "train_2ex_s5_vb1_3s")
  env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
  proc = subprocess.run(
      [sys.executable, "-c", _READER, jax_task.cache_dir,
       str(tmp_path / "read.npz")], cwd=ROOT, env=env, capture_output=True,
      text=True, timeout=300)
  assert proc.returncode == 0, proc.stderr
  summary = json.loads(proc.stdout.strip().splitlines()[-1])
  read = np.load(tmp_path / "read.npz")

  port_task = registry.synthetic_cached_task(
      "train", audio_codec=codecs.MelGan(), **_task_kwargs(experiment))
  fresh = list(port_task.tokenized())
  assert summary["chunks"] == len(fresh) > 0
  for i, chunk in enumerate(fresh):
    assert summary["ids"][i] == chunk["id"]
    assert summary["notes"][i] == len(chunk["sequence"].notes)
    for k, v in chunk.items():
      if k not in ("sequence", "id"):
        np.testing.assert_array_equal(read[f"{i}/{k}"], v, err_msg=k)


def test_synthetic_task_builds_then_reads_its_cache(tmp_path, capsys):
  """`cache_root` builds the cache under the JAX package's name, in the JAX
  package's bytes; the task then reads it (also when its songs are gone)
  and its batches are those of the uncached task."""
  experiment = config.preset("context_tiny")
  task = registry.synthetic_cached_task(
      "train", audio_codec=codecs.MelGan(), cache_root=str(tmp_path / "port"),
      **_task_kwargs(experiment))
  assert "building synthetic cache train_2ex_s5_vb1_3s" in (
      capsys.readouterr().out)
  assert task.cache_dir == str(tmp_path / "port" / "train_2ex_s5_vb1_3s")
  # The JAX package's cache of the same songs: the same chunks (its
  # pickled NoteSequence read as the port's).
  jax_task = _jax_task(experiment, str(tmp_path / "jax"))
  assert sorted(os.listdir(jax_task.cache_dir)) == sorted(
      os.listdir(task.cache_dir))
  ours = list(cache.read_cache(task.cache_dir))
  theirs = list(cache.read_cache(jax_task.cache_dir))
  assert len(ours) == len(theirs) == 2
  for g, w in zip(ours, theirs):
    _assert_examples_equal(g, w)
  capsys.readouterr()
  again = registry.synthetic_cached_task(
      "train", audio_codec=codecs.MelGan(), cache_root=str(tmp_path / "port"),
      **_task_kwargs(experiment))
  assert "building" not in capsys.readouterr().out
  again.source_fn = lambda: (_ for _ in ()).throw(AssertionError("songs"))
  lengths = {"inputs": 64, "targets": 16, "targets_context": 16}
  uncached = registry.synthetic_cached_task(
      "train", audio_codec=codecs.MelGan(), **_task_kwargs(experiment))
  want = list(uncached.model_dataset(lengths, seed=3).repeat().batch(2)
              .take(2))
  got = list(again.model_dataset(lengths, seed=3).repeat().batch(2)
             .take(2))
  assert len(got) == len(want) == 2
  for g, w in zip(got, want):
    assert set(g) == set(w)
    for k in w:
      np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_build_cache_needs_a_directory():
  experiment = config.preset("context_tiny")
  task = registry.synthetic_cached_task(
      "train", audio_codec=codecs.MelGan(), **_task_kwargs(experiment))
  assert task.cache_dir is None
  with pytest.raises(ValueError, match="no cache_dir"):
    task.build_cache()
