"""Host data pipeline: deterministic sharding + background prefetch (port
of ``repro/data/pipeline.py``).

Each host computes its own shard of the global batch from the (step,
host) key, so a restart resumes exactly from the step counter alone (the
checkpoint stores it).  A worker thread keeps up to ``prefetch`` batches
ready; ``close`` stops it.
"""
from __future__ import annotations

import queue
import threading

from .synthetic import SyntheticLM

__all__ = ["DataPipeline"]


class DataPipeline:
    def __init__(self, source: SyntheticLM, global_batch: int, seq: int,
                 host: int = 0, n_hosts: int = 1, prefetch: int = 2,
                 start_step: int = 0):
        if global_batch % n_hosts:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {n_hosts} hosts")
        self.source = source
        self.local_batch = global_batch // n_hosts
        self.seq = seq
        self.host, self.n_hosts = host, n_hosts
        self._step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            b = self.source.batch(self.local_batch, self.seq, step=step,
                                  host=self.host, n_hosts=self.n_hosts)
            b["step"] = step
            while not self._stop.is_set():
                try:
                    self._q.put(b, timeout=0.2)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self) -> dict:
        return self._q.get()

    def __iter__(self):
        return self

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
