"""Completion-driven background prefetcher (ENEAC interrupt discipline).

The port's copy of ``repro.data.prefetch``.

The host thread that feeds the device never *builds* batches: a producer
thread prepares them ahead of time and parks on a bounded queue; the
training loop's ``get()`` sleeps on the queue's condition variable (no
polling) and almost always returns immediately — the data-pipeline
analogue of the paper's "host thread does not waste CPU cycles waiting".
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

__all__ = ["Prefetcher"]


class Prefetcher:
    def __init__(
        self,
        make_batch: Callable[[int], object],   # step -> batch
        *,
        depth: int = 2,
        start_step: int = 0,
    ) -> None:
        self.make_batch = make_batch
        self._q: "queue.Queue[tuple[int, object, Optional[BaseException]]]" = (
            queue.Queue(maxsize=depth)
        )
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._produce, daemon=True,
                                        name="eneac-prefetch")
        self._thread.start()

    def _produce(self) -> None:
        step = self._step
        while not self._stop.is_set():
            try:
                batch = self.make_batch(step)
            except BaseException as exc:  # delivered in order with the stream
                self._q.put((step, None, exc))
                return
            self._q.put((step, batch, None))  # blocks at depth (backpressure)
            step += 1

    def get(self, timeout: Optional[float] = 30.0):
        """Sleeps (no busy-wait) until the next batch is ready."""
        step, batch, err = self._q.get(timeout=timeout)
        if err is not None:
            raise err
        return step, batch

    def close(self) -> None:
        self._stop.set()
        # unblock the producer if it is parked on a full queue
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
