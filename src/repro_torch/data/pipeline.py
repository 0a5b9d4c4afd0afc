"""Host-side double-buffered prefetcher (a copy of
repro/data/pipeline.py).

Straggler mitigation at the data layer: batch generation runs in a
background thread ahead of the training loop, so a slow host step (I/O
hiccup, contended CPU) overlaps with device compute instead of stalling
the step. The queue depth bounds memory; pipeline state stays exactly
resumable because batches are generated from (seed, step) only.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator

import numpy as np


class Prefetcher:
    def __init__(
        self,
        make_batch: Callable[[int], Dict[str, np.ndarray]],
        start_step: int = 0,
        depth: int = 2,
    ):
        self._make = make_batch
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._make(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch = self._q.get()
        return step, batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
