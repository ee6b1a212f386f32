"""The port's data/tasks.py and data/registry.py against the JAX package's,
on records in every published schema that the test writes: each dataset
task's training batches and full-song segments bit for bit, the task
registry's names, the mega mixture's rates (with and without a cache) and
its draws, and a dataset cache that either package writes serving the
other, in the same bytes."""

import os

import numpy as np
import pytest

from music_spectrogram_diffusion_tpu.audio import codecs as jax_codecs
from music_spectrogram_diffusion_tpu.data import core as jax_core
from music_spectrogram_diffusion_tpu.data import datasets as jax_datasets
from music_spectrogram_diffusion_tpu.data import registry as jax_registry
from music_spectrogram_diffusion_tpu.data import tasks as jax_tasks
from music_spectrogram_diffusion_tpu_torch.audio import codecs
from music_spectrogram_diffusion_tpu_torch.data import core
from music_spectrogram_diffusion_tpu_torch.data import datasets
from music_spectrogram_diffusion_tpu_torch.data import registry
from music_spectrogram_diffusion_tpu_torch.data import tasks
# clean_registries and no_gcs_backend are autouse fixtures.
from torch_data_parity import (  # noqa: F401
    NAMES, SMALL_LENGTHS, assert_examples_equal, assert_streams_equal,
    clean_registries, no_gcs_backend, write_mirror)


@pytest.fixture(scope="module")
def mirror(tmp_path_factory):
  return write_mirror(tmp_path_factory.mktemp("mirror"))


def _tasks(name, split, mirror, cache_root=None, ismir=False, **kw):
  """The same dataset task in both packages."""
  out = []
  for reg, ds_mod, tasks_mod, codec_mod in (
      (registry, datasets, tasks, codecs),
      (jax_registry, jax_datasets, jax_tasks, jax_codecs)):
    extra = dict(kw)
    if ismir:
      extra.update(note_rep=reg.ISMIR2021_NOTE_REP,
                   program_granularity="flat")
    out.append(reg.make_dataset_task(
        ds_mod.ALL_DATASET_CONFIGS[name], split,
        vocab_config=(reg.VOCAB_CONFIG_FULL if ismir
                      else reg.VOCAB_CONFIG_NOVELOCITY),
        data_root=mirror, audio_codec=codec_mod.MelGan(),
        cache_root=cache_root, **extra))
  return out


def _batches(ds, n):
  return list(ds.repeat().batch(2).take(n))


@pytest.mark.parametrize("name", NAMES)
def test_training_batches_equal_jax(name, mirror):
  """model_dataset(training=True, seed=7), batched, bit for bit."""
  port, jax = _tasks(name, "train", mirror)
  assert port.name == jax.name
  assert port.source_is_tokenized and jax.source_is_tokenized
  got = _batches(port.model_dataset(SMALL_LENGTHS, training=True, seed=7), 3)
  want = _batches(jax.model_dataset(SMALL_LENGTHS, training=True, seed=7), 3)
  assert_streams_equal(got, want, at_least=3)
  assert got[0]["decoder_target_tokens"].shape == (2, 64, 128)
  assert got[0]["encoder_continuous_inputs"].shape == (2, 64, 128)


@pytest.mark.parametrize("name", NAMES)
def test_full_song_segments_equal_jax(name, mirror):
  """full_song_dataset on the eval split (the original NoteSequence kept),
  and model_dataset(training=False) with passthrough keys."""
  config = datasets.ALL_DATASET_CONFIGS[name]
  port, jax = _tasks(name, config.train_eval_split, mirror)
  lengths = dict(SMALL_LENGTHS, targets=32)
  got = list(port.full_song_dataset(lengths))
  want = list(jax.full_song_dataset(lengths))
  assert_streams_equal(got, want, at_least=4)  # 2 songs, >= 2 segments
  assert all(ex["targets_context"].shape == (0, 128) for ex in got)
  keys = ("id", "sequence", "inputs_pretokenized")
  got = list(port.model_dataset(lengths, training=False,
                                passthrough_keys=keys))
  want = list(jax.model_dataset(lengths, training=False,
                                passthrough_keys=keys))
  assert_streams_equal(got, want, at_least=4)
  assert all(k in got[0] for k in keys)


def test_ismir2021_task_batches_equal_jax(mirror):
  """MAESTRO v3 with 127 velocity bins, no ties and flat programs."""
  port, jax = _tasks("maestrov3", "train", mirror, ismir=True)
  assert port.name == jax.name == (
      "synthesis_with_context_maestrov3_notes_melgan_train")
  assert_streams_equal(
      _batches(port.model_dataset(SMALL_LENGTHS, training=True, seed=3), 2),
      _batches(jax.model_dataset(SMALL_LENGTHS, training=True, seed=3), 2),
      at_least=2)


def test_notes_only_task_batches_equal_jax(mirror):
  port, jax = _tasks("urmp", "train", mirror, with_context=False)
  assert port.name == jax.name == "synthesis_urmp_notes_ties_melgan_vb1_train"
  lengths = {"inputs": 256, "targets": 64}
  assert_streams_equal(
      _batches(port.model_dataset(lengths, training=True, seed=5), 2),
      _batches(jax.model_dataset(lengths, training=True, seed=5), 2),
      at_least=2)


def test_construct_task_name_equals_jax():
  for onsets, ties in ((False, True), (True, False), (False, False)):
    got = tasks.construct_task_name(
        "synthesis", "slakh", codecs.MelGan(), registry.VOCAB_CONFIG_FULL,
        tasks.NoteRepresentationConfig(onsets_only=onsets,
                                       include_ties=ties), task_suffix="eval")
    want = jax_tasks.construct_task_name(
        "synthesis", "slakh", jax_codecs.MelGan(),
        jax_registry.VOCAB_CONFIG_FULL,
        jax_tasks.NoteRepresentationConfig(onsets_only=onsets,
                                           include_ties=ties),
        task_suffix="eval")
    assert got == want
  assert codecs.MelGan().abbrev_str == jax_codecs.MelGan().abbrev_str


@pytest.mark.parametrize("with_context", [True, False])
def test_register_all_tasks_names_equal_jax(with_context, tmp_path):
  got = registry.register_all_tasks(data_root=str(tmp_path),
                                    with_context=with_context)
  want = jax_registry.register_all_tasks(data_root=str(tmp_path),
                                         with_context=with_context)
  assert got == want and len(got) == len(set(got))
  assert sorted(tasks.TASK_REGISTRY) == sorted(jax_tasks.TASK_REGISTRY)
  assert sorted(tasks.MIXTURE_REGISTRY) == sorted(jax_tasks.MIXTURE_REGISTRY)
  # 6 train tasks, 22 eval-split tasks, 6 ismir2021 tasks, the mixture.
  assert len(got) == 6 + 22 + 6 + 1
  for name in got[:-1]:
    p, j = tasks.get_task(name), jax_tasks.get_task(name)
    assert (p.with_context, p.program_granularity, p.note_rep.include_ties,
            p.vocab_config.num_velocity_bins) == (
                j.with_context, j.program_granularity,
                j.note_rep.include_ties, j.vocab_config.num_velocity_bins)
  with pytest.raises(ValueError, match="Unknown task"):
    tasks.get_task("nope")


def test_register_ismir2021_tasks_names_equal_jax():
  got = registry.register_ismir2021_tasks(include_eval_splits=True)
  want = jax_registry.register_ismir2021_tasks(include_eval_splits=True)
  assert got == want and len(got) == 6
  assert registry.ISMIR2021_NOTE_REP == tasks.NoteRepresentationConfig(
      onsets_only=False, include_ties=False)


def _mega(module):
  return module.MIXTURE_REGISTRY["synthesis_with_context_mega"]


def test_mega_rates_equal_jax_without_and_with_a_cache(tmp_path, mirror):
  """Without a cache, the published song counts; with one, each cached
  task's chunk count (here two of the six datasets cached)."""
  cache_root = str(tmp_path / "cache")
  for kw in ({}, {"cache_root": cache_root}):
    registry.register_all_tasks(data_root=mirror, include_eval_splits=False,
                                **kw)
    jax_registry.register_all_tasks(data_root=mirror,
                                    include_eval_splits=False, **kw)
    got, want = _mega(tasks), _mega(jax_tasks)
    assert got.task_names == want.task_names
    assert got.rates == want.rates
  defaults = [registry.DEFAULT_TRAIN_NUM_EXAMPLES[c.name]
              for c in datasets.SYNTH_MIXTURE_DATASET_CONFIGS]
  assert got.rates == tasks.example_proportional_rates(
      defaults, temperature=registry.MIXING_TEMPERATURE)
  for name in ("guitarset", "slakh"):
    port, _ = _tasks(name, "train", mirror, cache_root=cache_root)
    port.build_cache()
  registry.register_all_tasks(data_root=mirror, include_eval_splits=False,
                              cache_root=cache_root)
  jax_registry.register_all_tasks(data_root=mirror, include_eval_splits=False,
                                  cache_root=cache_root)
  got, want = _mega(tasks), _mega(jax_tasks)
  assert got.rates == want.rates != defaults
  counts = dict(registry.DEFAULT_TRAIN_NUM_EXAMPLES, guitarset=2, slakh=2)
  assert got.rates == tasks.example_proportional_rates(
      [counts[c.name] for c in datasets.SYNTH_MIXTURE_DATASET_CONFIGS],
      temperature=10 / 3)
  assert registry.DEFAULT_TRAIN_NUM_EXAMPLES == (
      jax_registry.DEFAULT_TRAIN_NUM_EXAMPLES)


def test_example_proportional_rates_equal_jax():
  for args in (([10, 1000, 3], 10 / 3, None), ([10, 1000, 3], 1.0, 100),
               ([5], 2.0, None)):
    assert tasks.example_proportional_rates(*args) == (
        jax_tasks.example_proportional_rates(*args))


@pytest.mark.parametrize("seed", [0, 11])
def test_mixture_first_64_picks_equal_jax(seed, monkeypatch, tmp_path):
  """The same random.Random(seed).choices draws: each task's stream stood
  in by its name, the first 64 picks of the mega mixture are JAX's."""
  registry.register_all_tasks(data_root=str(tmp_path),
                              include_eval_splits=False)
  jax_registry.register_all_tasks(data_root=str(tmp_path),
                                  include_eval_splits=False)

  def named(core_mod):
    def model_dataset(self, lengths, training=True, seed=0, **kw):
      return core_mod.Dataset.from_list([{"task": self.name}])
    return model_dataset

  monkeypatch.setattr(tasks.Task, "model_dataset", named(core))
  monkeypatch.setattr(jax_tasks.Task, "model_dataset", named(jax_core))
  got = [ex["task"] for ex in _mega(tasks).dataset(
      SMALL_LENGTHS, seed=seed).take(64)]
  want = [ex["task"] for ex in _mega(jax_tasks).dataset(
      SMALL_LENGTHS, seed=seed).take(64)]
  assert got == want and len(set(got)) >= 4


def test_mixture_examples_equal_jax(mirror):
  """The mega mixture's first batches, bit for bit, from raw records."""
  registry.register_all_tasks(data_root=mirror, include_eval_splits=False)
  jax_registry.register_all_tasks(data_root=mirror, include_eval_splits=False)
  lengths = dict(SMALL_LENGTHS, inputs=128, targets=32, targets_context=32)
  got = list(_mega(tasks).dataset(lengths, seed=2, shuffle_buffer_size=4,
                                  num_threads=2).batch(4).take(2))
  want = list(_mega(jax_tasks).dataset(lengths, seed=2,
                                       shuffle_buffer_size=4).batch(4)
              .take(2))
  assert_streams_equal(got, want, at_least=2)


@pytest.mark.parametrize("name", ["slakh", "musicnet"])
def test_dataset_cache_shards_equal_and_serve_both(name, tmp_path, mirror):
  """Each package's cache of the same task: the same files, the same bytes
  (the pickled NoteSequence under the JAX package's class name); the port
  reads the JAX-written cache at the task's name (its raw records unread)
  and its batches are JAX's from the same cache."""
  port, jax = _tasks(name, "train", mirror,
                     cache_root=str(tmp_path / "port"))
  _, jax = _tasks(name, "train", mirror, cache_root=str(tmp_path / "jax"))
  port_meta = port.build_cache(examples_per_shard=1)
  jax_meta = jax.build_cache(examples_per_shard=1)
  assert port_meta == jax_meta and port_meta["num_shards"] == 2
  assert port.cache_dir.endswith(os.path.join("port", port.name))
  files = sorted(os.listdir(jax.cache_dir))
  assert sorted(os.listdir(port.cache_dir)) == files
  for f in files:
    with open(os.path.join(port.cache_dir, f), "rb") as a, open(
        os.path.join(jax.cache_dir, f), "rb") as b:
      assert a.read() == b.read(), f
  served, _ = _tasks(name, "train", mirror, cache_root=str(tmp_path / "jax"))
  assert served.cache_dir == jax.cache_dir
  served.source_fn = lambda: (_ for _ in ()).throw(AssertionError("raw"))
  assert_streams_equal(served.tokenized(), jax.tokenized(), at_least=2)
  assert_streams_equal(
      _batches(served.model_dataset(SMALL_LENGTHS, seed=4), 2),
      _batches(jax.model_dataset(SMALL_LENGTHS, training=True, seed=4), 2),
      at_least=2)
  # The full-song path always reads the raw records.
  with pytest.raises(AssertionError, match="raw"):
    next(iter(served.full_song_dataset(SMALL_LENGTHS)))


@pytest.mark.parametrize("name", ["maestrov3", "urmp"])
def test_audio_source_equals_jax_with_its_audio(name, mirror):
  """JAX's examples, and the port's 'audio': the song's 16 kHz samples
  (the tokenized frames, flattened), which JAX's lack."""
  for split, training in ((None, True), (None, False),
                          ("validation", False)):
    got = list(registry.audio_source(name, split, codecs.MelGan(),
                                     data_root=mirror, is_training=training))
    want = list(jax_registry.audio_source(name, split, jax_codecs.MelGan(),
                                          data_root=mirror,
                                          is_training=training))
    assert all("audio" not in ex for ex in want)
    audio = [ex.pop("audio") for ex in got]
    assert_streams_equal(got, want, at_least=2)
    for a, ex in zip(audio, want):
      np.testing.assert_array_equal(a, ex["inputs"].reshape(-1))
      assert 0 <= a.size - 2.0 * 16000 <= 320
  with pytest.raises(ValueError, match="unknown dataset"):
    registry.audio_source("maestro", None, codecs.MelGan())


def test_missing_shard_and_gs_without_backend_raise(tmp_path):
  """No synthetic data stands in: a missing shard raises, and so does a
  published gs:// path with no backend (no data_root)."""
  port, _ = _tasks("maestrov3", "train", str(tmp_path))
  with pytest.raises(FileNotFoundError, match="no files match"):
    next(iter(port.model_dataset(SMALL_LENGTHS)))
  port, _ = _tasks("maestrov3", "train", None)
  with pytest.raises(FileNotFoundError, match="no gs:// backend"):
    next(iter(port.model_dataset(SMALL_LENGTHS)))
  assert registry._localize("gs://b/x", None) == "gs://b/x"
  assert registry._localize("gs://b/x", "/m") == "/m/b/x"
  assert registry._localize("/local/x", "/m") == "/local/x"


def test_synthetic_task_unchanged_by_the_dataset_paths():
  """The synthetic task still tokenizes through the generic path."""
  port = registry.synthetic_cached_task(
      "train", audio_codec=codecs.MelGan(),
      vocab_config=registry.VOCAB_CONFIG_NOVELOCITY,
      note_rep=tasks.NoteRepresentationConfig(), with_context=True,
      program_granularity="full", num_examples=2, duration=3.0, seed=5)
  jax = jax_registry.synthetic_cached_task(
      "train", audio_codec=jax_codecs.MelGan(),
      vocab_config=jax_registry.VOCAB_CONFIG_NOVELOCITY,
      note_rep=jax_tasks.NoteRepresentationConfig(), with_context=True,
      program_granularity="full", num_examples=2, duration=3.0, seed=5)
  assert not port.source_is_tokenized
  assert port.name == jax.name == "train_2ex_s5_vb1_3s"
  assert_streams_equal(
      _batches(port.model_dataset(SMALL_LENGTHS, seed=1), 2),
      _batches(jax.model_dataset(SMALL_LENGTHS, training=True, seed=1), 2),
      at_least=2)
  for g, w in zip(port.full_song_dataset(SMALL_LENGTHS),
                  jax.full_song_dataset(SMALL_LENGTHS)):
    assert_examples_equal(g, w)


def test_skip_too_long_drops_training_examples_only(mirror):
  """skip_too_long: a training chunk whose inputs outgrow the length is
  dropped; without it, or on the full-song path, the length guard raises,
  as JAX's."""
  lengths = dict(SMALL_LENGTHS, inputs=45)  # the chunks need 43 and 48
  kept = []
  for task in _tasks("cerberus4", "train", mirror):
    with pytest.raises(ValueError, match="exceeds maximum length"):
      list(task.train_dataset(lengths, shuffle_buffer_size=0))
    with pytest.raises(ValueError, match="exceeds maximum length"):
      list(task.full_song_dataset(dict(lengths, inputs=8)))
    task.skip_too_long = True
    kept.append([int((ex["inputs"] != 0).sum()) for ex in
                 task.train_dataset(lengths, shuffle_buffer_size=0)])
  assert kept[0] == kept[1] == [43]


def test_codec_decode_dither_equals_jax(monkeypatch):
  """decode: features plus dither_amount x noise through the attached
  vocoder. With the same noise injected into both packages' draws the
  outputs agree within 1e-6; the port draws from an explicit generator
  and, as JAX without an rng, raises without one."""
  import jax
  import jax.numpy as jnp
  import torch
  rng = np.random.RandomState(0)
  features = rng.randn(2, 5, 128).astype(np.float32)
  noise = rng.randn(2, 5, 128).astype(np.float32)

  def apply_fn(params, f):
    return f.reshape(f.shape[0], -1) * params

  port = codecs.MelGan(decode_dither_amount=0.05)
  want_codec = jax_codecs.MelGan(decode_dither_amount=0.05)
  with pytest.raises(ValueError, match="No vocoder"):
    port.decode(torch.as_tensor(features))
  port.set_vocoder(apply_fn, 1.5)
  want_codec.set_vocoder(apply_fn, 1.5)
  with pytest.raises(ValueError, match="torch.Generator"):
    port.decode(torch.as_tensor(features))
  with pytest.raises(ValueError, match="rng"):
    want_codec.decode(jnp.asarray(features))
  gen = torch.Generator().manual_seed(3)
  drawn = port.decode(torch.as_tensor(features), gen)
  again = port.decode(torch.as_tensor(features),
                      torch.Generator().manual_seed(3))
  assert torch.equal(drawn, again) and drawn.shape == (2, 5 * 128)
  assert not torch.equal(drawn, port.decode(torch.as_tensor(features), gen))
  monkeypatch.setattr(codecs, "_dither_noise",
                      lambda f, g: torch.as_tensor(noise))
  monkeypatch.setattr(jax.random, "normal",
                      lambda key, shape: jnp.asarray(noise))
  got = port.decode(torch.as_tensor(features), gen).numpy()
  want = np.asarray(want_codec.decode(jnp.asarray(features),
                                      jax.random.PRNGKey(0)))
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
  np.testing.assert_allclose(got, (features + 0.05 * noise).reshape(2, -1)
                             * 1.5, rtol=0, atol=1e-6)
  plain = codecs.MelGan()
  plain.set_vocoder(lambda _, mel: mel * 2)
  assert torch.equal(plain.decode(torch.ones(1, 2, 128)),
                     torch.full((1, 2, 128), 2.0))


def test_codec_to_images_equals_jax():
  import jax.numpy as jnp
  import torch
  features = np.random.RandomState(1).uniform(-12, 5, (2, 4, 128)).astype(
      np.float32)
  got = codecs.MelGan().to_images(torch.as_tensor(features)).numpy()
  want = np.asarray(jax_codecs.MelGan().to_images(jnp.asarray(features)))
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
  with pytest.raises(AssertionError):
    codecs.MelGan().to_images(torch.zeros(4, 128))
