"""Data pipeline: deterministic synthetic LM stream + file-backed corpus,
host-sharded loading, background prefetch (the port's copy of
``repro.data.pipeline``, numpy only: its batches are bitwise the
reference's).

* **Determinism/restart**: batches are a pure function of (seed, step),
  so a job restored from a step-N checkpoint consumes exactly the
  batches it would have — no data-loader state to checkpoint.
* **Host sharding**: each host materializes only its slice of the
  global batch (``host_id/num_hosts``), matching the dp-axis sharding
  the runtime expects.
* **Prefetch**: a daemon thread keeps ``depth`` batches ready so step N's
  compute overlaps step N+1's data.
"""

from __future__ import annotations

import queue
import threading

import numpy as np


class SyntheticLM:
    """Zipf-ish token stream — shaped like web text frequencies, cheap to
    generate, fully deterministic per (seed, step)."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, host_id: int = 0, num_hosts: int = 1):
        if global_batch % num_hosts:
            raise ValueError(f"global_batch {global_batch} is not a multiple of "
                             f"num_hosts {num_hosts}")
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.local_batch = global_batch // num_hosts
        self.seed = seed
        self.host_id = host_id
        # zipf-ish ranks; clip to vocab
        self._alpha = 1.1

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id])
        )
        z = rng.zipf(self._alpha, size=(self.local_batch, self.seq_len + 1))
        tokens = np.minimum(z - 1, self.vocab - 1).astype(np.int32)
        return {"tokens": tokens}


class MemmapCorpus:
    """File-backed token corpus (flat int32 binary).  Sequential windows
    per (step, host) — the restartable file analogue of SyntheticLM."""

    def __init__(self, path: str, seq_len: int, global_batch: int,
                 host_id: int = 0, num_hosts: int = 1):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.local_batch = global_batch // num_hosts
        self.host_id = host_id
        self.num_hosts = num_hosts
        self._per_step = global_batch * (seq_len + 1)
        self.num_steps = len(self.tokens) // self._per_step

    def batch(self, step: int) -> dict:
        step = step % max(self.num_steps, 1)
        base = step * self._per_step + self.host_id * self.local_batch * (self.seq_len + 1)
        flat = np.asarray(
            self.tokens[base : base + self.local_batch * (self.seq_len + 1)]
        )
        return {"tokens": flat.reshape(self.local_batch, self.seq_len + 1)}


class Prefetcher:
    """Background-thread prefetch of source.batch(step) for step=start.."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step

        def work():
            s = start_step
            while not self._stop.is_set():
                try:
                    self._q.put(source.batch(s), timeout=0.2)
                    s += 1
                except queue.Full:
                    continue

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def next(self) -> dict:
        return self._q.get()

    def close(self) -> None:
        self._stop.set()
        # drain so the worker can exit
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
