"""Notes -> per-segment event tokens, on the host.

A small encoder for note lists (start, end, pitch, program) that follows
the event layout of the JAX package's tokenizer (midi/run_length.py,
midi/sequences.py): each segment opens with a tie section naming the notes
still sounding (program, pitch ... tie), then per event time a shift token
holding the absolute step within the segment, then program, velocity bin
(1 = onset, 0 = offset) and pitch; EOS closes the segment. MIDI-file
parsing and the full task pipeline are not ported yet (ROADMAP).
"""

from __future__ import annotations

from typing import List

import numpy as np

from music_spectrogram_diffusion_tpu_torch.midi import event_codec
from music_spectrogram_diffusion_tpu_torch.midi import vocabularies


def random_notes(seed: int, seconds: float, *, notes_per_second: float = 4.0,
                 programs=(0, 24, 32, 40)) -> np.ndarray:
  """A seeded note list [n, 4] of (start, end, pitch, program)."""
  rng = np.random.default_rng(seed)
  n = max(1, int(seconds * notes_per_second))
  start = np.sort(rng.uniform(0.0, seconds, n))
  end = np.minimum(start + rng.uniform(0.1, 1.5, n), seconds)
  pitch = rng.integers(36, 96, n)
  program = rng.choice(np.asarray(programs), n)
  return np.stack([start, end, pitch, program], axis=1)


def segment_tokens(notes: np.ndarray, *, num_segments: int,
                   segment_seconds: float, max_tokens: int,
                   codec: event_codec.Codec,
                   vocab: vocabularies.TokenVocabulary) -> List[np.ndarray]:
  """One int32 token array per segment, EOS-terminated, zero-padded (or
  cut, keeping the EOS) to `max_tokens`."""
  sps = codec.steps_per_second
  out = []
  for g in range(num_segments):
    t0, t1 = g * segment_seconds, (g + 1) * segment_seconds
    ids = []
    tied = sorted((int(prog), int(p)) for s, e, p, prog in notes
                  if s < t0 < e)
    for prog, p in tied:
      ids += [codec.encode_event(event_codec.Event("program", prog)),
              codec.encode_event(event_codec.Event("pitch", p))]
    ids.append(codec.encode_event(event_codec.Event("tie", 0)))
    timed = []
    for s, e, p, prog in notes:
      for t, velocity in ((s, 1), (e, 0)):
        if t0 <= t < t1:
          step = min(int(round((t - t0) * sps)), codec.max_shift_steps)
          timed.append((step, velocity, int(prog), int(p)))
    cur_step = 0
    for step, velocity, prog, p in sorted(timed):
      if step > cur_step:
        ids.append(codec.encode_event(event_codec.Event("shift", step)))
        cur_step = step
      ids += [codec.encode_event(event_codec.Event("program", prog)),
              codec.encode_event(event_codec.Event("velocity", velocity)),
              codec.encode_event(event_codec.Event("pitch", p))]
    tokens = np.zeros(max_tokens, np.int32)
    body = vocab.encode(np.asarray(ids[:max_tokens - 1], np.int32))
    tokens[:len(body)] = body
    tokens[len(body)] = vocab.eos_id
    out.append(tokens)
  return out
