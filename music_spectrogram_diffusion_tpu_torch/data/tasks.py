"""The synthetic training task: tokenize -> split -> chunk -> RLE -> mel ->
batch.

The training half of music_spectrogram_diffusion_tpu/data/tasks.py, copied
(`Task.tokenized`, `build_cache`, `train_dataset`, `_finalize`,
`feature_converter`, `model_dataset`) without the full-song eval split and
the mixtures:

  pre-cache:  tokenize -> rekey (transcription->synthesis) -> split into
              <=2000-frame chunks (written once to the offline cache,
              `data/cache.py`, when the task has a `cache_dir`)
  post-cache: random chunk (with the previous frames as context, for the
              context model) -> slice events + tie prefix -> program map ->
              RLE shifts -> mel encode -> length guard -> vocab encode + EOS
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional

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


@dataclasses.dataclass
class Task:
  """A fully-wired training task (of the context model, or with
  `with_context` False of the notes-only and autoregressive models)."""
  name: str
  source_fn: Callable[[], core.Dataset]  # yields {'sequence','audio','id'}
  audio_codec: codecs.MelGan
  vocab_config: vocabularies.VocabularyConfig
  note_rep: NoteRepresentationConfig
  with_context: bool = True
  program_granularity: str = "full"
  # The directory of the offline tokenization cache (reference
  # CacheDatasetPlaceholder, tasks.py:38,325): once the cache exists there,
  # `tokenized()` streams it instead of tokenizing the songs every epoch.
  cache_dir: Optional[str] = None

  def __post_init__(self):
    self.codec = vocabularies.build_codec(self.vocab_config)
    self.vocabulary = vocabularies.vocabulary_from_codec(self.codec)

  def tokenized(self) -> core.Dataset:
    """tokenize -> rekey -> split into <= MAX_NUM_CACHED_FRAMES chunks, or
    those chunks read back from the cache when one was built."""
    if cache_lib.cache_exists(self.cache_dir):
      return cache_lib.read_cache(self.cache_dir)
    return self._tokenized_fresh()

  def build_cache(self, cache_dir: Optional[str] = None,
                  examples_per_shard: int = 128):
    """Write tokenize -> rekey -> split to TFRecord shards under
    `cache_dir` (or the task's), which the task reads from then on.
    Returns {'num_examples', 'num_shards'}."""
    cache_dir = cache_dir or self.cache_dir
    if not cache_dir:
      raise ValueError(f"task {self.name}: no cache_dir given")
    self.cache_dir = cache_dir
    # Always tokenize anew for the write (never read a stale cache).
    return cache_lib.write_cache(self._tokenized_fresh(), cache_dir,
                                 examples_per_shard=examples_per_shard)

  def _tokenized_fresh(self) -> core.Dataset:
    def tokenize(ex):
      return preprocessors.tokenize_example(
          ns=ex["sequence"], samples=ex["audio"],
          audio_codec=self.audio_codec, codec=self.codec,
          onsets_only=self.note_rep.onsets_only,
          include_ties=self.note_rep.include_ties,
          example_id=ex.get("id"))

    return (self.source_fn().map(tokenize)
            .map(preprocessors.rekey_transcription_to_synthesis)
            .flat_map(lambda ex: preprocessors.split_cached_frames(
                ex, MAX_NUM_CACHED_FRAMES)))

  def train_dataset(self,
                    task_feature_lengths: Mapping[str, int],
                    seed: int = 0,
                    shuffle_buffer_size: int = 256,
                    num_threads: int = 1) -> core.Dataset:
    """Random-chunk training examples (with the previous frames as
    context, for the context model).

    Chunk starts are drawn fresh every epoch (epoch-mixed seeds) and the
    chunk stream is reservoir-shuffled; shuffle_buffer_size=0 keeps the
    order.
    """
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

    ds = self.tokenized().map_with_seed(chunk, base_seed=seed)
    if shuffle_buffer_size:
      ds = ds.shuffle(shuffle_buffer_size, seed=seed)
    return self._finalize(ds, task_feature_lengths, num_threads=num_threads)

  def _finalize(self, ds: core.Dataset,
                task_feature_lengths: Mapping[str, int],
                num_threads: int = 1) -> core.Dataset:
    def transform(ex):
      """The post-split per-example chain (one function, so it can run on
      a thread pool: numpy's FFT releases the GIL)."""
      ex = preprocessors.note_representation_chain(
          ex, codec=self.codec,
          include_ties=self.note_rep.include_ties,
          granularity_type=self.program_granularity,
          feature_key="inputs")
      ex = preprocessors.encode_audio(
          ex, audio_codec=self.audio_codec,
          sequence_lengths=task_feature_lengths,
          targets_keys=["targets"],
          context_keys=[k for k in ("targets_context",)
                        if self.with_context and k in ex],
          keys_to_pad=["targets"])
      ex = dict(preprocessors.handle_too_long(
          ex, sequence_lengths=task_feature_lengths,
          lengths_include_eos_keys=("inputs",)))
      ex["inputs_pretokenized"] = ex["inputs"]
      return preprocessors.tokenize_and_append_eos(
          ex, self.vocabulary, keys=("inputs",))

    if num_threads > 1:
      return ds.parallel_map(transform, num_threads=num_threads)
    return ds.map(transform)

  def model_dataset(self, task_feature_lengths: Mapping[str, int],
                    seed: int = 0,
                    shuffle_buffer_size: int = 256,
                    num_threads: int = 1) -> core.Dataset:
    """Training batches' examples in the model's schema."""
    ds = self.train_dataset(task_feature_lengths, seed=seed,
                            shuffle_buffer_size=shuffle_buffer_size,
                            num_threads=num_threads)
    return feature_converters.convert_dataset(ds, self.feature_converter(),
                                              task_feature_lengths)

  def feature_converter(self):
    if self.with_context:
      return feature_converters.ContinuousContextFeatureConverter()
    return feature_converters.ContinuousOutputsFeatureConverter()
