"""Records in the seven published TFRecord schemas, made from seeded songs.

Nothing is downloaded. The tests and chip_smoke.py write a few generated
songs of each dataset under a local data root, each at its published path's
suffix (`shard_path`), so that data/registry.py reads them as it would a
mirror of the published shards (`data_root=`). Every record carries each
feature of its dataset's schema (data/datasets.py), in the wire types the
published files use: WAV bytes (MAESTRO, GuitarSet, URMP), float samples
with their rate (MusicNet, and Slakh's and Cerberus4's mix and stems), and
NoteSequence protos, one a song or one a track. MAESTRO's and MusicNet's
audio is written at 44.1 kHz, as the published recordings are, so that the
pipeline resamples it to the codec's 16 kHz; the rest at 16 kHz.

  python -m music_spectrogram_diffusion_tpu_torch.data.dataset_records \
      --data_root /tmp/mirror [--songs 2] [--seconds 12] [--workers 4]

(`--workers` processes write the shards: the TFRecord CRCs are computed in
Python, about 0.14 s a MB.)
"""

from __future__ import annotations

import argparse
import functools
import multiprocessing
import os
import re
import time
from typing import Dict, Optional, Sequence

import numpy as np

from music_spectrogram_diffusion_tpu_torch.audio import wav_io
from music_spectrogram_diffusion_tpu_torch.data import datasets
from music_spectrogram_diffusion_tpu_torch.data import synthetic
from music_spectrogram_diffusion_tpu_torch.midi import proto
from music_spectrogram_diffusion_tpu_torch.midi import sequences

# The audio rate each dataset's records are written at.
SAMPLE_RATES = {"maestrov1": 44100, "maestrov3": 44100, "guitarset": 16000,
                "urmp": 16000, "musicnet": 44100, "cerberus4": 16000,
                "slakh": 16000}
# The tracks of the multitrack schemas: URMP's instrument codes, Cerberus4's
# TrackSpecs in order (bass, drums, guitar, piano), Slakh's classes.
URMP_INSTRUMENTS = ("vn", "fl")
SLAKH_CLASSES = ("Acoustic Piano", "Electric Bass", "Drums")


def song(seed: int, seconds: float, program: int = 0,
         is_drum: bool = False) -> sequences.NoteSequence:
  """One instrument's random notes (data/synthetic.py), on one program."""
  ns = synthetic.random_note_sequence(np.random.RandomState(seed),
                                      duration=seconds, num_programs=1)
  for note in ns.notes:
    note.program = program
    note.is_drum = is_drum
  return ns


def sustain_pedal(seed: int, seconds: float) -> list:
  """A few presses of the sustain pedal (CC 64), as MAESTRO's protos hold."""
  rng = np.random.RandomState(seed + 7)
  ccs = []
  for start in np.sort(rng.uniform(0, seconds - 0.5, 3)):
    ccs.append({"time": float(start), "control_number": 64,
                "control_value": 127})
    ccs.append({"time": float(start + rng.uniform(0.1, 0.5)),
                "control_number": 64, "control_value": 0})
  return ccs


def render(tracks: Sequence[sequences.NoteSequence], seconds: float,
           sample_rate: int) -> np.ndarray:
  """The tracks' sine renders, each at 1 / len(tracks): [n_samples]."""
  return np.mean([synthetic.render_note_sequence(t, sample_rate,
                                                 duration=seconds)
                  for t in tracks], axis=0).astype(np.float32)


def record(name: str, seed: int, seconds: float) -> Dict[str, object]:
  """One song's features in dataset `name`'s schema."""
  sr = SAMPLE_RATES[name]
  if name in ("maestrov1", "maestrov3", "guitarset"):
    program = 24 if name == "guitarset" else 0
    ns = song(seed, seconds, program=program)
    ccs = sustain_pedal(seed, seconds) if name != "guitarset" else ()
    out = {"sequence": proto.serialize_note_sequence(ns, ccs),
           "audio": wav_io.encode_wav(render([ns], seconds, sr), sr),
           "id": f"{name}-{seed}".encode()}
    if name == "guitarset":
      out["velocity_range"] = b"\x08\x01\x10\x7f"
    return out
  if name == "urmp":
    tracks = [song(seed * 10 + k, seconds)
              for k in range(len(URMP_INSTRUMENTS))]
    return {"id": f"urmp-{seed}".encode(),
            "tracks": np.arange(1, len(tracks) + 1, dtype=np.int64),
            "inst_names": [i.encode() for i in URMP_INSTRUMENTS],
            "audio": wav_io.encode_wav(render(tracks, seconds, sr), sr),
            "sequence": proto.serialize_note_sequence(song(seed, seconds)),
            "instrument_sequences": [proto.serialize_note_sequence(t)
                                     for t in tracks]}
  if name == "musicnet":
    ns = song(seed, seconds, program=40)
    return {"id": f"musicnet-{seed}".encode(),
            "sample_rate": np.asarray([float(sr)], np.float32),
            "audio": render([ns], seconds, sr),
            "sequence": proto.serialize_note_sequence(ns)}
  if name in ("cerberus4", "slakh"):
    if name == "cerberus4":
      specs = datasets.CERBERUS4_CONFIG.track_specs
      names = [s.name for s in specs]
      tracks = [song(seed * 10 + k, seconds, program=s.program or 0,
                     is_drum=s.is_drum) for k, s in enumerate(specs)]
    else:
      names = list(SLAKH_CLASSES)
      tracks = [song(seed * 10 + k, seconds, program=p, is_drum=d)
                for k, (p, d) in enumerate(((0, False), (33, False),
                                            (0, True)))]
    stems = np.stack([render([t], seconds, sr) for t in tracks])
    n = len(tracks)
    return {"audio_sample_rate": np.asarray([sr], np.int64),
            "inst_names": [s.encode() for s in names],
            "midi_class": np.arange(n, dtype=np.int64),
            "mix": stems.mean(axis=0),
            "note_sequences": [proto.serialize_note_sequence(t)
                               for t in tracks],
            "plugin_name": np.arange(n, dtype=np.int64) + 100,
            "program_num": np.asarray([t.notes[0].program for t in tracks],
                                      np.int64),
            "slakh_class": np.arange(n, dtype=np.int64) + 10,
            "src_ids": [f"S{k:02d}".encode() for k in range(n)],
            "stems": stems.reshape(-1),
            "stems_shape": np.asarray(stems.shape, np.int64),
            "target_type": b"notes",
            "track_id": f"{name}-{seed}".encode()}
  raise ValueError(f"unknown dataset {name!r}")


def shard_path(config: datasets.DatasetConfig, split: str,
               data_root: str) -> str:
  """The local file of one shard of `split` under data_root: the published
  path's suffix with its glob made concrete. A split with a `_subset`
  (MAESTRO's, Slakh's and Cerberus4's train and validation) takes the
  subset's shard, so that one file serves both."""
  pattern = config.paths.get(f"{split}_subset", config.paths[split])
  pattern = re.sub(r"\[(.)[^\]]*\]", r"\1", pattern).replace("?", "0")
  assert pattern.startswith("gs://"), pattern
  return os.path.join(data_root, pattern[len("gs://"):])


def write_split(data_root: str, name: str, split: str,
                seeds: Sequence[int], seconds: float) -> str:
  """Writes one shard of `seeds`' songs; returns its path."""
  path = shard_path(datasets.ALL_DATASET_CONFIGS[name], split, data_root)
  os.makedirs(os.path.dirname(path), exist_ok=True)
  datasets.write_tfrecord(path, [
      datasets.serialize_example(record(name, s, seconds))
      for s in seeds])
  return path


def write_all(data_root: str, songs: int, seconds: float,
              workers: int = 1) -> Dict[str, Dict[str, str]]:
  """Every dataset's train and validation shards (the latter serves the
  eval splits), `songs` songs each; seeds differ across datasets and
  splits. `workers` processes write the shards. Returns
  {dataset: {split: path}}."""
  jobs = [(name, split, [1 + 1000 * i + 100 * j + k for k in range(songs)])
          for i, name in enumerate(sorted(datasets.ALL_DATASET_CONFIGS))
          for j, split in enumerate(("train", "validation"))]
  write = functools.partial(_write_job, data_root, seconds)
  if workers > 1:
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
      paths = pool.map(write, jobs, chunksize=1)
  else:
    paths = [write(job) for job in jobs]
  out: Dict[str, Dict[str, str]] = {}
  for (name, split, _), path in zip(jobs, paths):
    out.setdefault(name, {})[split] = path
  return out


def _write_job(data_root: str, seconds: float, job) -> str:
  name, split, seeds = job
  return write_split(data_root, name, split, seeds, seconds)


def main(argv: Optional[Sequence[str]] = None) -> None:
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--data_root", required=True)
  p.add_argument("--songs", type=int, default=2)
  p.add_argument("--seconds", type=float, default=12.0)
  p.add_argument("--workers", type=int, default=1)
  args = p.parse_args(argv)
  t0 = time.perf_counter()
  written = write_all(args.data_root, args.songs, args.seconds,
                      workers=args.workers)
  for name, paths in written.items():
    for split, path in paths.items():
      print(f"{name} {split}: {path}")
  print(f"wrote {sum(len(v) for v in written.values())} shards in "
        f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
  main()
