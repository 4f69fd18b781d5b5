"""Asynchronous inference for live feeds (port of
``loans_tpu/inference/async_worker.py``).

``AsynchronousLocalizer`` runs ``localizer.localize`` on a worker thread
between two queues of depth one: ``submit`` drops a frame while the
worker is busy (the feed never waits for the model), a new result replaces
a stale one that nobody fetched, ``fps`` is the rate of the last
``localize``, and ``shutdown`` stops the worker and drains both queues.

A thread, not a process: the forward releases the GIL while the card
computes, and the model and its weights stay in one CUDA context.
"""

from __future__ import annotations

import queue
import threading
import time


class AsynchronousLocalizer:
    def __init__(self, localizer):
        """``localizer``: a ``LocalizerInference`` or ``SSDInference``
        (anything with a ``localize(image)`` method)."""
        self.localizer = localizer
        self.localization_queue: queue.Queue = queue.Queue(maxsize=1)
        self.image_queue: queue.Queue = queue.Queue(maxsize=1)
        self.fps = 0.0
        self._stop = threading.Event()
        self._worker: threading.Thread | None = None

    def start_localization_worker(self):
        self._stop.clear()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()
        return self

    def submit(self, image) -> bool:
        """Queue a frame without waiting; False (frame dropped) while the
        worker is busy."""
        try:
            self.localization_queue.put_nowait(image)
            return True
        except queue.Full:
            return False

    def get_result(self):
        """The newest result without waiting; None when none is ready."""
        try:
            return self.image_queue.get_nowait()
        except queue.Empty:
            return None

    def _loop(self):
        while not self._stop.is_set():
            try:
                image = self.localization_queue.get(timeout=0.1)
            except queue.Empty:
                continue
            t0 = time.perf_counter()
            result = self.localizer.localize(image)
            dt = time.perf_counter() - t0
            self.fps = 1.0 / dt if dt > 0 else 0.0
            try:
                self.image_queue.put_nowait(result)
            except queue.Full:
                try:  # replace the stale result
                    self.image_queue.get_nowait()
                    self.image_queue.put_nowait(result)
                except queue.Empty:
                    pass

    def shutdown(self):
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=2.0)
        for q in (self.localization_queue, self.image_queue):
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
