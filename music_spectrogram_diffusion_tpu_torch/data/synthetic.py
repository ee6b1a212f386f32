"""Synthetic (NoteSequence, audio) source for tests and benchmarks.

Generates random note sequences and renders them with a cheap additive
sine synthesizer so the full task pipeline (tokenize -> chunk -> mel ->
model) can run end-to-end without any real dataset on disk.

A copy of music_spectrogram_diffusion_tpu/data/synthetic.py: the same
seeds give the same songs and the same audio.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from music_spectrogram_diffusion_tpu_torch.data import core
from music_spectrogram_diffusion_tpu_torch.midi import sequences


def midi_to_hz(pitch: np.ndarray) -> np.ndarray:
  return 440.0 * 2.0 ** ((np.asarray(pitch, np.float64) - 69.0) / 12.0)


def _program_timbre(program: int):
  """Deterministic per-program harmonic recipe for the 'rich' render.

  Returns (harmonic_amps[8], decay_tau_seconds, transient_gain). Seeded
  by the program number so the same program always sounds the same —
  the model can in principle learn program->timbre, which is exactly
  what the pure-sine render made unlearnable (every program identical).
  """
  rng = np.random.RandomState(program * 7919 + 13)
  rolloff = rng.uniform(0.35, 0.85)
  amps = rolloff ** np.arange(8) * rng.uniform(0.6, 1.0, 8)
  amps[0] = 1.0
  amps /= amps.sum()
  decay_tau = float(rng.uniform(0.15, 1.2))   # percussive .. sustained
  transient_gain = float(rng.uniform(0.05, 0.35))
  return amps.astype(np.float64), decay_tau, transient_gain


def render_note_sequence(ns: sequences.NoteSequence,
                         sample_rate: int,
                         duration: Optional[float] = None,
                         timbre: str = "sine") -> np.ndarray:
  """Render a NoteSequence (test fixture, not a product).

  timbre='sine' (default): the original additive-sine render — kept
  bit-identical so every committed FAD/F1 number stays reproducible.
  timbre='rich': program-keyed harmonic stacks with exponential decay +
  sustain, a filtered-noise onset transient, and noise-burst drums —
  closer to real instrument texture so quality metrics stop being
  pure-tone artifacts.
  """
  if timbre not in ("sine", "rich"):
    raise ValueError(f"unknown timbre {timbre!r}")
  total = duration if duration is not None else ns.total_time
  n = int(round(total * sample_rate)) + 1
  audio = np.zeros(n, np.float32)
  for note in ns.notes:
    start = int(round(note.start_time * sample_rate))
    end = min(int(round(note.end_time * sample_rate)), n)
    if end <= start:
      continue
    num = end - start
    t = np.arange(num) / sample_rate
    vel = note.velocity / 127.0
    if timbre == "sine":
      freq = float(midi_to_hz(note.pitch))
      env = np.minimum(1.0, (num - np.arange(num)) / 1000.0)
      audio[start:end] += vel * 0.2 * env * np.sin(
          2 * np.pi * freq * t).astype(np.float32)
      continue
    note_rng = np.random.RandomState(
        (note.pitch * 131 + note.program * 31 + start) % (2 ** 31))
    if note.is_drum:
      # Noise burst ring-modulated by a pitch-keyed carrier: broadband
      # attack + a resonant body, decaying fast.
      tau = 0.03 + 0.002 * (note.pitch % 16)
      env = np.exp(-t / tau)
      noise = note_rng.randn(num)
      carrier = 0.5 + 0.5 * np.sin(
          2 * np.pi * float(midi_to_hz(min(note.pitch, 60))) * t)
      audio[start:end] += (vel * 0.35 * env * noise * carrier
                           ).astype(np.float32)
      continue
    amps, decay_tau, transient_gain = _program_timbre(note.program)
    freq = float(midi_to_hz(note.pitch))
    # 5 ms linear attack, exponential decay to a 30% sustain floor,
    # 20 ms release ramp at note end.
    env = (np.minimum(t / 0.005, 1.0)
           * (0.3 + 0.7 * np.exp(-t / decay_tau))
           * np.minimum(1.0, (num - np.arange(num)) / (0.02 * sample_rate)))
    wave = np.zeros(num)
    phase_rng = np.random.RandomState(note.program * 101 + 7)
    for k, amp in enumerate(amps):
      f_k = freq * (k + 1)
      if f_k >= sample_rate / 2:
        break
      wave += amp * np.sin(2 * np.pi * f_k * t
                           + phase_rng.uniform(0, 2 * np.pi))
    # Onset transient: 10 ms decaying noise, high-passed by first
    # differencing (cheap), scaled by the program's attack character.
    trans = note_rng.randn(num) * np.exp(-t / 0.01)
    trans = np.diff(trans, prepend=0.0)
    audio[start:end] += (vel * 0.25 * (env * wave + transient_gain * trans)
                         ).astype(np.float32)
  return np.clip(audio, -1.0, 1.0)


def random_note_sequence(rng: np.random.RandomState,
                         duration: float = 10.0,
                         notes_per_second: float = 3.0,
                         num_programs: int = 2,
                         drum_fraction: float = 0.0) -> sequences.NoteSequence:
  """Random notes; drum_fraction > 0 adds percussive (is_drum) hits.

  Kept bit-identical at drum_fraction=0 (the default) so seeded
  held-out sets regenerate exactly.
  """
  ns = sequences.NoteSequence()
  n_notes = max(1, int(duration * notes_per_second))
  programs = rng.choice(128, size=num_programs, replace=False)
  for _ in range(n_notes):
    start = float(rng.uniform(0, duration - 0.2))
    length = float(rng.uniform(0.1, min(2.0, duration - start)))
    ns.add(start_time=start,
           end_time=start + length,
           pitch=int(rng.randint(36, 96)),
           velocity=int(rng.randint(1, 128)),
           program=int(rng.choice(programs)),
           is_drum=False)
  if drum_fraction > 0:
    n_drums = int(n_notes * drum_fraction)
    for _ in range(n_drums):
      start = float(rng.uniform(0, duration - 0.1))
      ns.add(start_time=start,
             end_time=start + 0.1,  # drums are onset-only events
             pitch=int(rng.choice([36, 38, 42, 46, 49])),  # GM kit staples
             velocity=int(rng.randint(64, 128)),
             program=0,
             is_drum=True)
  sequences.assign_instruments(ns)
  return ns


def synthetic_source(num_examples: int,
                     sample_rate: int = 16000,
                     duration: float = 10.0,
                     seed: int = 0,
                     timbre: str = "sine",
                     drum_fraction: float = 0.0) -> core.Dataset:
  """Dataset of {'sequence': NoteSequence, 'audio': samples, 'id': str}.

  The NOTE STREAM depends only on (seed, duration, drum_fraction), so a
  timbre='rich' regeneration scores the same held-out songs as the
  committed sine evals — only the rendered texture changes.
  """
  def gen() -> Iterator[core.Example]:
    for i in range(num_examples):
      rng = np.random.RandomState(seed + i)
      ns = random_note_sequence(rng, duration=duration,
                                drum_fraction=drum_fraction)
      audio = render_note_sequence(ns, sample_rate, duration=duration,
                                   timbre=timbre)
      yield {"sequence": ns, "audio": audio, "id": f"synthetic-{i}"}
  return core.Dataset.from_generator(gen)
