"""Task assembly: tokenize -> cache split -> chunk -> RLE -> mel -> batch.

The port's own copy of music_spectrogram_diffusion_tpu/data/tasks.py (the
port imports nothing of the JAX package). It re-creates the reference's
seqio task chains (the music_spectrogram_diffusion reference's tasks.py)
over the plain Dataset abstraction:

  pre-cache:  tokenize -> rekey (transcription->synthesis) -> split into
              <=2000-frame chunks (written once to the offline cache,
              `data/cache.py`, when the task has a `cache_dir`)
  post-cache: random-chunk-with-context (train) or full-song split (eval)
              -> slice events + tie prefix -> program map -> RLE shifts
              -> mel encode -> length guard -> vocab encode + EOS

Tasks and mixtures register in module-level registries (`TASK_REGISTRY`,
`MIXTURE_REGISTRY`); data/registry.py fills them for the datasets.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Sequence

import numpy as np

from music_spectrogram_diffusion_tpu_torch.audio import codecs
from music_spectrogram_diffusion_tpu_torch.data import cache as cache_lib
from music_spectrogram_diffusion_tpu_torch.data import core
from music_spectrogram_diffusion_tpu_torch.data import feature_converters
from music_spectrogram_diffusion_tpu_torch.data import preprocessors
from music_spectrogram_diffusion_tpu_torch.midi import vocabularies

MAX_NUM_CACHED_FRAMES = 2000  # reference tasks.py:38


@dataclasses.dataclass(frozen=True)
class NoteRepresentationConfig:
  onsets_only: bool = False
  include_ties: bool = True


def construct_task_name(task_prefix: str, dataset_name: str,
                        audio_codec: codecs.MelGan,
                        vocab_config: vocabularies.VocabularyConfig,
                        note_rep: NoteRepresentationConfig,
                        task_suffix: Optional[str] = None) -> str:
  """Same naming scheme as reference tasks.py:50-73."""
  task_type = "onsets" if note_rep.onsets_only else "notes"
  if note_rep.include_ties:
    task_type += "_ties"
  fields = [task_prefix, dataset_name, task_type]
  if audio_codec.abbrev_str:
    fields.append(audio_codec.abbrev_str)
  if vocab_config.abbrev_str:
    fields.append(vocab_config.abbrev_str)
  if task_suffix:
    fields.append(task_suffix)
  return "_".join(fields)


@dataclasses.dataclass
class Task:
  """A fully-wired data task."""
  name: str
  source_fn: Callable[[], core.Dataset]  # yields {'sequence','audio','id'}
  audio_codec: codecs.MelGan
  vocab_config: vocabularies.VocabularyConfig
  note_rep: NoteRepresentationConfig
  with_context: bool = True
  program_granularity: str = "full"
  onsets_only: bool = False
  skip_too_long: bool = False
  # True when source_fn already yields the tokenized schema (inputs/
  # targets/indices), e.g. dataset-specific tokenizers in data/registry.
  source_is_tokenized: bool = False
  # Directory holding (or to hold) the offline tokenization cache
  # (reference CacheDatasetPlaceholder, tasks.py:38,325). When the cache
  # exists, `tokenized(split_sequences=True)` streams it instead of
  # re-tokenizing raw records every epoch.
  cache_dir: Optional[str] = None

  def __post_init__(self):
    self.codec = vocabularies.build_codec(self.vocab_config)
    self.vocabulary = vocabularies.vocabulary_from_codec(self.codec)

  # -- pre-cache ------------------------------------------------------------

  def tokenized(self, split_sequences: bool = True) -> core.Dataset:
    """tokenize -> rekey -> (optionally) split into cacheable chunks.

    Reads the offline cache instead when one was built (the cache stores
    the post-split chunks, so it only serves split_sequences=True — the
    full-song eval path always re-tokenizes to keep whole songs)."""
    if split_sequences and cache_lib.cache_exists(self.cache_dir):
      return cache_lib.read_cache(self.cache_dir)
    return self._tokenized_fresh(split_sequences)

  def _tokenized_fresh(self, split_sequences: bool) -> core.Dataset:
    def tokenize(ex):
      return preprocessors.tokenize_example(
          ns=ex["sequence"], samples=ex["audio"],
          audio_codec=self.audio_codec, codec=self.codec,
          onsets_only=self.note_rep.onsets_only,
          include_ties=self.note_rep.include_ties,
          example_id=ex.get("id"))

    ds = self.source_fn()
    if not self.source_is_tokenized:
      ds = ds.map(tokenize)
    ds = ds.map(preprocessors.rekey_transcription_to_synthesis)
    if split_sequences:
      ds = ds.flat_map(
          lambda ex: self._split_cached(ex))
    return ds

  def build_cache(self, cache_dir: Optional[str] = None,
                  examples_per_shard: int = 128):
    """Materialize tokenize->rekey->split to TFRecord shards on disk.

    Afterwards every epoch reads the cache (set / keep `cache_dir` on
    the task). Returns {'num_examples', 'num_shards'}.
    """
    cache_dir = cache_dir or self.cache_dir
    if not cache_dir:
      raise ValueError(f"task {self.name}: no cache_dir given")
    self.cache_dir = cache_dir
    # Always re-tokenize for the write (never read a stale cache).
    return cache_lib.write_cache(
        self._tokenized_fresh(split_sequences=True), cache_dir,
        examples_per_shard=examples_per_shard)

  def _split_cached(self, ex):
    return preprocessors.split_cached_frames(ex, MAX_NUM_CACHED_FRAMES)

  # -- post-cache (train) ---------------------------------------------------

  def train_dataset(self,
                    task_feature_lengths: Mapping[str, int],
                    seed: int = 0,
                    shuffle_buffer_size: int = 256,
                    num_threads: int = 1) -> core.Dataset:
    """Random-chunk training examples with task features.

    Chunk starts are drawn fresh every epoch (epoch-mixed seeds) and the
    chunk stream is reservoir-shuffled, matching the reference's
    post-cache shuffle + seeded random-chunk maps (reference
    preprocessors.py:751-860, seqio shuffle). Set shuffle_buffer_size=0
    to disable shuffling (deterministic order, e.g. for goldens).
    """
    ds = self.tokenized(split_sequences=True)
    l_tgt = task_feature_lengths["targets"]
    l_ctx = task_feature_lengths.get("targets_context", 0)

    if self.with_context:
      def chunk(ex, ex_seed):
        return preprocessors.select_random_chunk_with_feature_context(
            ex, seed=ex_seed, feature_key="targets",
            feature_context_key="targets_context",
            max_feature_length=l_tgt, max_context_length=l_ctx,
            audio_codec=self.audio_codec,
            additional_feature_keys=[
                "event_start_indices", "event_end_indices",
                "state_event_indices"],
            passthrough_feature_keys=["inputs", "state_events"])
      ds = ds.map_with_seed(chunk, base_seed=seed)
    else:
      def chunk(ex, ex_seed):
        rng = np.random.RandomState(ex_seed)
        tokens = ex["targets"]
        n = len(tokens)
        start = int(rng.randint(0, max(1, n)))
        end = min(start + l_tgt, n)
        extra = self.audio_codec.additional_frames_for_encoding
        out = {"targets": tokens[start:end + extra]}
        for k in ("event_start_indices", "event_end_indices",
                  "state_event_indices"):
          out[k] = ex[k][start:end]
        for k in ("inputs", "state_events"):
          out[k] = ex[k]
        return out
      ds = ds.map_with_seed(chunk, base_seed=seed)

    if shuffle_buffer_size:
      ds = ds.shuffle(shuffle_buffer_size, seed=seed)
    return self._finalize(ds, task_feature_lengths, training=True,
                          num_threads=num_threads)

  # -- post-cache (full-song eval) ------------------------------------------

  def full_song_dataset(
      self, task_feature_lengths: Mapping[str, int]) -> core.Dataset:
    """Consecutive segments of each song (context filled at inference)."""
    ds = self.tokenized(split_sequences=False)
    l_tgt = task_feature_lengths["targets"]

    def split(ex):
      for i, seg in enumerate(preprocessors.split_full_song(
          ex, feature_key="targets", max_tokens=l_tgt,
          audio_codec=self.audio_codec,
          additional_feature_keys=[
              "event_start_indices", "event_end_indices",
              "state_event_indices"],
          passthrough_feature_keys=["inputs", "state_events", "id",
                                    "sequence"])):
        if self.with_context:
          seg["targets_context"] = np.zeros(
              (0,) + np.asarray(ex["targets"]).shape[1:], np.float32)
        yield seg
    ds = ds.flat_map(split)
    return self._finalize(ds, task_feature_lengths, training=False)

  # -- shared tail ----------------------------------------------------------

  def _finalize(self, ds: core.Dataset,
                task_feature_lengths: Mapping[str, int],
                training: bool,
                num_threads: int = 1) -> core.Dataset:
    context_keys = ["targets_context"] if self.with_context else []

    def transform(ex):
      """The full post-cache per-example chain (one function so it can
      run on a thread pool: mel encoding is the data-pipeline hot spot,
      and numpy's FFT releases the GIL)."""
      ex = preprocessors.note_representation_chain(
          ex, codec=self.codec,
          include_ties=self.note_rep.include_ties,
          granularity_type=self.program_granularity,
          feature_key="inputs")
      ex = preprocessors.encode_audio(
          ex, audio_codec=self.audio_codec,
          sequence_lengths=task_feature_lengths,
          targets_keys=["targets"],
          context_keys=[k for k in context_keys if k in ex],
          keys_to_pad=["targets"] if training else None)
      ex = preprocessors.handle_too_long(
          ex, sequence_lengths=task_feature_lengths,
          lengths_include_eos_keys=("inputs",),
          skip=self.skip_too_long and training)
      if ex is None:
        return None
      ex = dict(ex)
      ex["inputs_pretokenized"] = ex["inputs"]
      return preprocessors.tokenize_and_append_eos(
          ex, self.vocabulary, keys=("inputs",))

    if num_threads > 1:
      ds = ds.parallel_map(transform, num_threads=num_threads)
    else:
      ds = ds.map(transform)
    return ds.filter(lambda ex: ex is not None)

  # -- model batches --------------------------------------------------------

  def feature_converter(self):
    if self.with_context:
      return feature_converters.ContinuousContextFeatureConverter()
    return feature_converters.ContinuousOutputsFeatureConverter()

  def model_dataset(self, task_feature_lengths: Mapping[str, int],
                    training: bool = True, seed: int = 0,
                    passthrough_keys: Sequence[str] = (),
                    shuffle_buffer_size: int = 256,
                    num_threads: int = 1) -> core.Dataset:
    ds = (self.train_dataset(task_feature_lengths, seed=seed,
                             shuffle_buffer_size=shuffle_buffer_size,
                             num_threads=num_threads)
          if training
          else self.full_song_dataset(task_feature_lengths))
    return feature_converters.convert_dataset(
        ds, self.feature_converter(), task_feature_lengths,
        passthrough_keys=passthrough_keys)


# ---------------------------------------------------------------------------
# Registry + mixtures.
# ---------------------------------------------------------------------------

TASK_REGISTRY: Dict[str, Task] = {}


def register_task(task: Task) -> Task:
  TASK_REGISTRY[task.name] = task
  return task


def get_task(name: str) -> Task:
  if name not in TASK_REGISTRY:
    raise ValueError(
        f"Unknown task {name!r}; registered: {sorted(TASK_REGISTRY)}")
  return TASK_REGISTRY[name]


@dataclasses.dataclass
class Mixture:
  """Temperature-weighted mixture over tasks (reference tasks.py:594-649)."""
  name: str
  task_names: Sequence[str]
  rates: Optional[Sequence[float]] = None

  def dataset(self, task_feature_lengths, training=True, seed=0,
              shuffle_buffer_size: int = 256,
              num_threads: int = 1) -> core.Dataset:
    import random
    tasks = [get_task(n) for n in self.task_names]
    rates = (list(self.rates) if self.rates
             else [1.0] * len(tasks))
    total = sum(rates)
    probs = [r / total for r in rates]
    def gen():
      # Streams are created INSIDE the generator so the Dataset is
      # re-iterable (each iteration gets fresh, independent per-task
      # iterators — matching core.py's per-epoch contract).
      streams = [iter(t.model_dataset(task_feature_lengths,
                                      training=training, seed=seed,
                                      shuffle_buffer_size=(
                                          shuffle_buffer_size),
                                      num_threads=num_threads)
                      .repeat())
                 for t in tasks]
      rng = random.Random(seed)
      while True:
        i = rng.choices(range(len(streams)), weights=probs)[0]
        yield next(streams[i])
    return core.Dataset.from_generator(gen)


MIXTURE_REGISTRY: Dict[str, Mixture] = {}


def register_mixture(mixture: Mixture) -> Mixture:
  MIXTURE_REGISTRY[mixture.name] = mixture
  return mixture


def example_proportional_rates(num_examples: Sequence[int],
                               temperature: float = 10 / 3,
                               maximum: Optional[int] = None
                               ) -> Sequence[float]:
  """seqio-style temperature-scaled example-proportional mixing rates."""
  rates = []
  for n in num_examples:
    r = float(min(n, maximum) if maximum else n)
    rates.append(r ** (1.0 / temperature))
  return rates
