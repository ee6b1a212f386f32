"""Instantiate the reference task matrix over the dataset configs.

The port's own copy of music_spectrogram_diffusion_tpu/data/registry.py
(the port imports nothing of the JAX package). The reference's tasks.py
registers synthesis / synthesis_with_context tasks for every dataset x
vocab config at import time (tasks.py:509-649) plus the 'mega' mixture.
This module does the same lazily: call `register_all_tasks(data_root=...)`
with a directory holding the TFRecord shards (paths in data/datasets.py
are gs:// URLs; pass a local mirror root that preserves the path
suffixes).

A task's name encodes everything that changes the tokenized bytes, so a
name means one dataset in both packages, and with `cache_root` the task's
offline cache lives in `<cache_root>/<name>`, where the JAX package puts it
(a cache either package built serves the other).
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Optional, Sequence

from music_spectrogram_diffusion_tpu_torch.audio import codecs
from music_spectrogram_diffusion_tpu_torch.data import cache as cache_lib
from music_spectrogram_diffusion_tpu_torch.data import core
from music_spectrogram_diffusion_tpu_torch.data import datasets
from music_spectrogram_diffusion_tpu_torch.data import preprocessors
from music_spectrogram_diffusion_tpu_torch.data import synthetic
from music_spectrogram_diffusion_tpu_torch.data import tasks
from music_spectrogram_diffusion_tpu_torch.data import tokenizers
from music_spectrogram_diffusion_tpu_torch.midi import vocabularies

# Vocab configs used by the reference registrations (tasks.py:492-493).
VOCAB_CONFIG_FULL = vocabularies.VocabularyConfig()
VOCAB_CONFIG_NOVELOCITY = vocabularies.VocabularyConfig(
    num_velocity_bins=1)

# Train-split example counts used for example-proportional mixture rates
# (reference tasks.py:636-649 passes seqio.mixing_rate_num_examples with
# temperature 10/3, which reads per-task cached-example stats). Without
# cached stats in this environment, these are the published dataset
# train-split song/track counts; pass exact cached-chunk counts to
# register_all_tasks(num_examples=...) when a cache exists.
DEFAULT_TRAIN_NUM_EXAMPLES = {
    "maestrov1": 954,
    "maestrov3": 962,
    "guitarset": 238,
    "urmp": 35,
    "musicnet": 320,
    "cerberus4": 1289,
    "slakh": 1289,
}

MIXING_TEMPERATURE = 10 / 3  # reference tasks.py:596


def _localize(path: str, data_root: Optional[str]) -> str:
  """Map a gs:// path to a local mirror under data_root."""
  if data_root is None:
    return path
  if path.startswith("gs://"):
    return os.path.join(data_root, path[len("gs://"):])
  return path


def dataset_source(config: datasets.DatasetConfig, split: str,
                   codec: codecs.MelGan,
                   event_codec_obj,
                   note_rep: tasks.NoteRepresentationConfig,
                   data_root: Optional[str] = None,
                   is_training: bool = True) -> core.Dataset:
  """Raw TFRecords -> tokenized {'sequence','audio',...} examples."""
  tokenize = tokenizers.TOKENIZERS[config.name]
  kwargs = dict(audio_codec=codec, codec=event_codec_obj,
                is_training_data=is_training,
                onsets_only=note_rep.onsets_only,
                include_ties=note_rep.include_ties)
  if config.name in ("cerberus4",) and config.track_specs:
    kwargs["track_specs"] = config.track_specs
  pattern = _localize(config.paths[split], data_root)
  raw = datasets.tfrecord_source(pattern, config.features)
  return raw.flat_map(lambda ex: tokenize(ex, **kwargs))


def audio_source(dataset_name: str, split: Optional[str],
                 codec: codecs.MelGan,
                 data_root: Optional[str] = None,
                 is_training: bool = True) -> core.Dataset:
  """Audio-bearing examples from a dataset config (vocoder train/eval).

  The note features are tokenized with the no-velocity vocab purely to
  satisfy the per-dataset tokenizers; callers consume only ex['audio'].
  split=None resolves to the train split (is_training) or the
  train_eval split.

  The tokenizers keep a song's 16 kHz samples as hop-size frames
  ('inputs'), and JAX's audio_source hands its examples on with no 'audio'
  key, so its callers' ex['audio'] raises KeyError there; the port adds
  'audio', the frames flattened (the song's samples, its last frame
  zero-padded).
  """
  if dataset_name not in datasets.ALL_DATASET_CONFIGS:
    raise ValueError(f"unknown dataset {dataset_name!r}; "
                     f"known: {sorted(datasets.ALL_DATASET_CONFIGS)}")
  config = datasets.ALL_DATASET_CONFIGS[dataset_name]
  split = split or (config.train_split if is_training
                    else config.train_eval_split)
  return dataset_source(
      config, split, codec,
      vocabularies.build_codec(VOCAB_CONFIG_NOVELOCITY),
      tasks.NoteRepresentationConfig(), data_root=data_root,
      is_training=is_training).map(
          lambda ex: dict(ex, audio=preprocessors.flatten_frames(
              ex["inputs"])))


def synthetic_cached_task(prefix: str, *,
                          audio_codec: codecs.MelGan,
                          vocab_config: vocabularies.VocabularyConfig,
                          note_rep: tasks.NoteRepresentationConfig,
                          with_context: bool,
                          program_granularity: str,
                          num_examples: int,
                          duration: float = 12.0,
                          seed: int = 0,
                          timbre: str = "sine",
                          drum_fraction: float = 0.0,
                          cache_root: Optional[str] = None
                          ) -> tasks.Task:
  """Synthetic-source Task whose name (= cache key) encodes everything
  that changes the tokenized bytes — example count, vocab, note rep,
  program granularity, clip duration, generator seed — so a cache built
  under one configuration is never silently reused under another."""
  sig = [prefix, f"{num_examples}ex"]
  if seed:
    sig.append(f"s{seed}")
  if vocab_config.abbrev_str:
    sig.append(vocab_config.abbrev_str)
  if not note_rep.include_ties:
    sig.append("noties")
  if note_rep.onsets_only:
    sig.append("onsets")
  if program_granularity != "full":
    sig.append(program_granularity)
  if duration != 12.0:
    sig.append(f"{duration:g}s")
  if timbre != "sine":
    sig.append(timbre)
  if drum_fraction:
    sig.append(f"dr{drum_fraction:g}")
  name = "_".join(sig)
  task = tasks.Task(
      name=name,
      source_fn=functools.partial(synthetic.synthetic_source,
                                  num_examples, duration=duration,
                                  seed=seed, timbre=timbre,
                                  drum_fraction=drum_fraction),
      audio_codec=audio_codec,
      vocab_config=vocab_config,
      note_rep=note_rep,
      with_context=with_context,
      program_granularity=program_granularity)
  if cache_root:
    cache_dir = os.path.join(cache_root, name)
    if not cache_lib.cache_exists(cache_dir):
      print(f"building synthetic cache {name}: "
            f"{task.build_cache(cache_dir)}")
    task.cache_dir = cache_dir
  return task


def make_dataset_task(config: datasets.DatasetConfig,
                      split: str,
                      *,
                      vocab_config: vocabularies.VocabularyConfig,
                      with_context: bool = True,
                      note_rep: Optional[
                          tasks.NoteRepresentationConfig] = None,
                      program_granularity: str = "full",
                      data_root: Optional[str] = None,
                      audio_codec: Optional[codecs.MelGan] = None,
                      name_suffix: Optional[str] = None,
                      cache_root: Optional[str] = None
                      ) -> tasks.Task:
  """One reference-style task for (dataset, split)."""
  note_rep = note_rep or tasks.NoteRepresentationConfig()
  audio_codec = audio_codec or codecs.MelGan()
  event_codec_obj = vocabularies.build_codec(vocab_config)
  prefix = "synthesis_with_context" if with_context else "synthesis"
  name = tasks.construct_task_name(
      prefix, config.name, audio_codec, vocab_config, note_rep,
      task_suffix=name_suffix or split)

  # Training reads the offline tokenization cache when one was built
  # (cli/cache_task.py); otherwise it re-tokenizes raw records each
  # epoch, which starves the accelerator at production batch sizes.
  task = tasks.Task(
      name=name,
      source_fn=functools.partial(
          _raw_source, config, split, audio_codec, event_codec_obj,
          note_rep, data_root),
      audio_codec=audio_codec,
      vocab_config=vocab_config,
      note_rep=note_rep,
      with_context=with_context,
      program_granularity=program_granularity,
      source_is_tokenized=True,
      cache_dir=os.path.join(cache_root, name) if cache_root else None)
  return task


def _raw_source(config, split, audio_codec, event_codec_obj, note_rep,
                data_root):
  # tasks.Task tokenizes via preprocessors.tokenize_example; dataset
  # tokenizers already produce the tokenized schema, so wrap the stream
  # as pre-tokenized examples. Task.tokenized() starts from
  # {'sequence','audio'} for the generic path, so for dataset-specific
  # tokenizers we return tokenized examples directly and Task handles it.
  # Eval splits keep the ORIGINAL NoteSequence (no overlapping-note
  # trim): ground truth for transcription metrics must be unaltered
  # (tokenizers.py Slakh/Cerberus4 branch on is_training_data).
  return dataset_source(config, split, audio_codec, event_codec_obj,
                        note_rep, data_root,
                        is_training=(split == config.train_split))


def register_all_tasks(data_root: Optional[str] = None,
                       with_context: bool = True,
                       include_eval_splits: bool = True,
                       num_examples: Optional[Dict[str, int]] = None,
                       cache_root: Optional[str] = None
                       ) -> Sequence[str]:
  """Register train tasks for every mixture dataset + eval-split tasks
  + the mega mixture.

  The mega mixture uses num_velocity_bins=1 (reference
  gin/tasks/mt3/base.gin); eval tasks are registered per InferEvalSplit
  like reference tasks.py:211-253 ('_full' variants come from using
  Task.full_song_dataset on the same task).
  """
  num_examples = {**DEFAULT_TRAIN_NUM_EXAMPLES, **(num_examples or {})}
  names = []
  train_names = []
  train_counts = []
  for config in datasets.SYNTH_MIXTURE_DATASET_CONFIGS:
    task = make_dataset_task(
        config, config.train_split,
        vocab_config=VOCAB_CONFIG_NOVELOCITY,
        with_context=with_context, data_root=data_root,
        cache_root=cache_root)
    tasks.register_task(task)
    names.append(task.name)
    train_names.append(task.name)
    # Exact cached-chunk counts (seqio uses these for mixing rates) beat
    # the approximate song-count table when a cache exists.
    if cache_lib.cache_exists(task.cache_dir):
      train_counts.append(
          cache_lib.cache_metadata(task.cache_dir)["num_examples"])
    else:
      train_counts.append(num_examples[config.name])
    if include_eval_splits:
      for split in config.infer_eval_splits:
        eval_task = make_dataset_task(
            config, split.name,
            vocab_config=VOCAB_CONFIG_NOVELOCITY,
            with_context=with_context, data_root=data_root,
            name_suffix=split.suffix)
        tasks.register_task(eval_task)
        names.append(eval_task.name)
  # ismir2021 piano family (reference tasks.py:509-521 registers MAESTRO
  # with the FULL vocab — 127 velocity bins — and the 'flat' no-ties
  # representation alongside the no-velocity tasks; gin/tasks/
  # ismir2021.gin trains on it). Not part of the mega mixture.
  names.extend(register_ismir2021_tasks(
      data_root=data_root, with_context=with_context,
      include_eval_splits=include_eval_splits, cache_root=cache_root))
  mixture = tasks.Mixture(
      name=("synthesis_with_context_mega" if with_context
            else "synthesis_mega"),
      task_names=list(train_names),
      # Temperature-10/3 example-proportional rates, matching the
      # reference mega mixture (tasks.py:594-649).
      rates=tasks.example_proportional_rates(
          train_counts, temperature=MIXING_TEMPERATURE))
  tasks.register_mixture(mixture)
  return names + [mixture.name]


# NoteRepresentationConfig for the ismir2021 piano model: velocities
# kept (127 bins), no tie section ('flat' decoding, reference
# gin/tasks/ismir2021.gin ONSETS_ONLY=False USE_TIES=False).
ISMIR2021_NOTE_REP = tasks.NoteRepresentationConfig(
    onsets_only=False, include_ties=False)


def register_ismir2021_tasks(data_root: Optional[str] = None,
                             with_context: bool = True,
                             include_eval_splits: bool = True,
                             cache_root: Optional[str] = None
                             ) -> Sequence[str]:
  """MAESTRO v3 with the full 127-velocity-bin vocab + flat programs.

  Mirrors the reference's piano registrations (tasks.py:509-521, gin/
  tasks/ismir2021.gin: NUM_VELOCITY_BINS=127, PROGRAM_GRANULARITY='flat',
  USE_TIES=False).
  """
  config = datasets.MAESTROV3_CONFIG
  names = []
  task = make_dataset_task(
      config, config.train_split,
      vocab_config=VOCAB_CONFIG_FULL,
      note_rep=ISMIR2021_NOTE_REP,
      program_granularity="flat",
      with_context=with_context, data_root=data_root,
      cache_root=cache_root)
  tasks.register_task(task)
  names.append(task.name)
  if include_eval_splits:
    for split in config.infer_eval_splits:
      eval_task = make_dataset_task(
          config, split.name,
          vocab_config=VOCAB_CONFIG_FULL,
          note_rep=ISMIR2021_NOTE_REP,
          program_granularity="flat",
          with_context=with_context, data_root=data_root,
          name_suffix=split.suffix)
      tasks.register_task(eval_task)
      names.append(eval_task.name)
  return names
