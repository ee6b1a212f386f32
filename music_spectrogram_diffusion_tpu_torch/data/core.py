"""Minimal lazy dataset abstraction (replaces tf.data + seqio plumbing).

A copy of music_spectrogram_diffusion_tpu/data/core.py (the port imports
nothing of the JAX package).

Examples are plain dicts of numpy arrays; a Dataset is a re-iterable lazy
pipeline over them. Heavyweight parallelism lives in `prefetch` (a
background thread pool) — everything else is simple composition, which
keeps the pipeline picklable, debuggable, and free of TF.

Epoch semantics: every pipeline stage receives an epoch number.
`repeat()` bumps it once per pass, and seeded stages (`map_with_seed`,
`shuffle`) mix it into their seeds, so repeated epochs draw *fresh*
random chunks/orders while a fixed base seed still reproduces the whole
run — the same contract tf.data's seeded maps give the reference
pipeline (reference preprocessors.py:751-860).
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import numpy as np

Example = Dict[str, Any]


def _mix_seed(*parts: int) -> int:
  """Deterministically mix integers into one 32-bit seed."""
  return int(np.random.SeedSequence(list(parts)).generate_state(1)[0])


class Dataset:
  """A re-iterable stream of example dicts.

  The underlying generator function takes the current epoch number;
  `iter(ds)` starts epoch 0.
  """

  def __init__(self, gen_fn: Callable[[int], Iterator[Example]]):
    self._gen_fn = gen_fn

  def __iter__(self) -> Iterator[Example]:
    return self._gen_fn(0)

  def epoch(self, epoch: int) -> Iterator[Example]:
    """Iterate one specific epoch (seeded stages reseed per epoch)."""
    return self._gen_fn(epoch)

  # -- constructors ---------------------------------------------------------

  @staticmethod
  def from_list(examples) -> "Dataset":
    examples = list(examples)
    return Dataset(lambda epoch: iter(examples))

  @staticmethod
  def from_generator(gen_fn: Callable[[], Iterable[Example]]) -> "Dataset":
    return Dataset(lambda epoch: iter(gen_fn()))

  # -- transforms -----------------------------------------------------------

  def map(self, fn: Callable[[Example], Example]) -> "Dataset":
    return Dataset(lambda epoch: (fn(ex) for ex in self._gen_fn(epoch)))

  def map_with_seed(self, fn: Callable[[Example, int], Example],
                    base_seed: int = 0) -> "Dataset":
    """Map with a per-example deterministic seed (epoch + position)."""
    def gen(epoch):
      for i, ex in enumerate(self._gen_fn(epoch)):
        yield fn(ex, _mix_seed(base_seed, epoch, i))
    return Dataset(gen)

  def filter(self, pred: Callable[[Example], bool]) -> "Dataset":
    return Dataset(
        lambda epoch: (ex for ex in self._gen_fn(epoch) if pred(ex)))

  def flat_map(self,
               fn: Callable[[Example], Iterable[Example]]) -> "Dataset":
    def gen(epoch):
      for ex in self._gen_fn(epoch):
        yield from fn(ex)
    return Dataset(gen)

  def repeat(self, count: Optional[int] = None) -> "Dataset":
    """Repeat the dataset; each pass runs as a distinct epoch."""
    def gen(epoch):
      if count is not None:
        for i in range(count):
          yield from self._gen_fn(epoch * count + i)
      else:
        for i in itertools.count():
          yield from self._gen_fn(i)
    return Dataset(gen)

  def take(self, n: int) -> "Dataset":
    return Dataset(
        lambda epoch: itertools.islice(self._gen_fn(epoch), n))

  def take_while(self, pred: Callable[[Example], bool]) -> "Dataset":
    """Stop the stream at the first failing example.

    Unlike filter() — which keeps pulling (and paying for) upstream
    examples after a limit is reached — this terminates iteration, so
    bounded evaluation doesn't tokenize the rest of the split."""
    return Dataset(
        lambda epoch: itertools.takewhile(pred, self._gen_fn(epoch)))

  def take_while_stateful(
      self, pred_factory: Callable[[], Callable[[Example], bool]]
  ) -> "Dataset":
    """take_while with per-iteration predicate state.

    `pred_factory()` is called at the start of EVERY iteration and must
    return a fresh predicate, so predicates that accumulate state (e.g.
    "first N distinct song ids") behave identically when the dataset is
    iterated more than once — a plain take_while over a stateful closure
    silently yields nothing on the second pass."""
    return Dataset(
        lambda epoch: itertools.takewhile(pred_factory(),
                                          self._gen_fn(epoch)))

  def shuffle(self, buffer_size: int, seed: int = 0) -> "Dataset":
    """Streaming shuffle with a fixed-size reservoir (tf.data semantics);
    the order reshuffles every epoch."""
    def gen(epoch):
      import random
      rng = random.Random(_mix_seed(seed, epoch))
      buf = []
      for ex in self._gen_fn(epoch):
        buf.append(ex)
        if len(buf) >= buffer_size:
          idx = rng.randrange(len(buf))
          buf[idx], buf[-1] = buf[-1], buf[idx]
          yield buf.pop()
      rng.shuffle(buf)
      yield from buf
    return Dataset(gen)

  def batch(self, batch_size: int, drop_remainder: bool = True) -> "Dataset":
    """Stack examples into batched arrays."""
    def gen(epoch):
      buf = []
      for ex in self._gen_fn(epoch):
        buf.append(ex)
        if len(buf) == batch_size:
          yield {k: np.stack([b[k] for b in buf]) for k in buf[0]}
          buf = []
      if buf and not drop_remainder:
        yield {k: np.stack([b[k] for b in buf]) for k in buf[0]}
    return Dataset(gen)

  def prefetch(self, buffer_size: int = 2,
               num_threads: int = 1) -> "Dataset":
    """Run the upstream pipeline in background threads.

    With num_threads > 1, upstream examples are processed out of order
    (each thread pulls from a shared iterator); ordering is not
    guaranteed, matching tf.data's parallel map semantics.
    """
    def gen(epoch):
      q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
      src = self._gen_fn(epoch)
      src_lock = threading.Lock()
      _END = object()
      n_done = [0]
      done_lock = threading.Lock()

      def worker():
        while True:
          with src_lock:
            try:
              ex = next(src)
            except StopIteration:
              break
            except Exception as e:  # surface pipeline errors to consumer
              q.put(("error", e))
              break
          q.put(("ok", ex))
        with done_lock:
          n_done[0] += 1
          if n_done[0] == num_threads:
            q.put(("end", _END))

      threads = [threading.Thread(target=worker, daemon=True)
                 for _ in range(num_threads)]
      for t in threads:
        t.start()
      while True:
        kind, item = q.get()
        if kind == "end":
          break
        if kind == "error":
          raise item
        yield item
    return Dataset(gen)

  def parallel_map(self, fn: Callable[[Example], Example],
                   num_threads: int = 4,
                   buffer_size: Optional[int] = None) -> "Dataset":
    """Apply `fn` with a thread pool, preserving input order
    (tf.data `map(num_parallel_calls=...)` with deterministic=True).

    Upstream iteration stays single-threaded; only `fn` runs in
    parallel. numpy releases the GIL for most heavy kernels, so this
    gives real speedups for featurization-bound pipelines.
    """
    if buffer_size is None:
      buffer_size = 2 * num_threads

    def gen(epoch):
      from concurrent import futures
      src = self._gen_fn(epoch)
      with futures.ThreadPoolExecutor(num_threads) as pool:
        pending = []
        for ex in src:
          pending.append(pool.submit(fn, ex))
          if len(pending) >= buffer_size:
            yield pending.pop(0).result()
        for fut in pending:
          yield fut.result()
    return Dataset(gen)

  # -- materialisation ------------------------------------------------------

  def as_list(self):
    return list(self)

  def first(self) -> Example:
    return next(iter(self))
