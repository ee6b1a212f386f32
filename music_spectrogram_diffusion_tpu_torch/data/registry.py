"""The synthetic training task, named as the JAX package names it.

`synthetic_cached_task` of music_spectrogram_diffusion_tpu/data/registry.py,
copied without its offline cache (the port has no `cache_root`): the task's
name encodes everything that changes the tokenized bytes, so a name means
one dataset in both packages.
"""

from __future__ import annotations

import functools

from music_spectrogram_diffusion_tpu_torch.audio import codecs
from music_spectrogram_diffusion_tpu_torch.data import synthetic
from music_spectrogram_diffusion_tpu_torch.data import tasks
from music_spectrogram_diffusion_tpu_torch.midi import vocabularies


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
                          drum_fraction: float = 0.0) -> tasks.Task:
  """Synthetic-source Task of the context model (seeds [seed, seed + N))."""
  if not with_context:
    raise NotImplementedError(
        "the port trains the context model only (with_context=True)")
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
  return tasks.Task(
      name="_".join(sig),
      source_fn=functools.partial(synthetic.synthetic_source,
                                  num_examples, duration=duration,
                                  seed=seed, timbre=timbre,
                                  drum_fraction=drum_fraction),
      audio_codec=audio_codec,
      vocab_config=vocab_config,
      note_rep=note_rep,
      program_granularity=program_granularity)
