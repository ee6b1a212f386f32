"""The synthetic training task, named as the JAX package names it.

`synthetic_cached_task` of music_spectrogram_diffusion_tpu/data/registry.py,
copied: the task's name encodes everything that changes the tokenized
bytes, so a name means one dataset in both packages, and with `cache_root`
the task's offline cache lives in `<cache_root>/<name>`, where the JAX
package puts it (a cache either package built serves the other).
"""

from __future__ import annotations

import functools
import os
from typing import Optional

from music_spectrogram_diffusion_tpu_torch.audio import codecs
from music_spectrogram_diffusion_tpu_torch.data import cache as cache_lib
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
                          drum_fraction: float = 0.0,
                          cache_root: Optional[str] = None) -> tasks.Task:
  """Synthetic-source Task (seeds [seed, seed + N)) of the context model,
  or with `with_context` False of the notes-only and autoregressive
  models. The name leaves the family out, as JAX's does: the cache holds
  the tokenized chunks, which are the same for every family. With
  `cache_root`, the task reads its cache there, built first if it is not
  there yet."""
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
