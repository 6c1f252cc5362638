"""Labelled stopwatch (reference: src/common/timer.{hh,cc}).

The first call of a jitted function includes compilation; use ``Timer``
around warmed-up regions, and end the region with
``jax.block_until_ready`` on its outputs — device execution is
asynchronous.
"""

from __future__ import annotations

import time


class Timer:

    def __init__(self, label: str = ""):
        self.label = label
        self.reset()

    def reset(self):
        self._elapsed = 0.0
        self._running = False
        self._t0 = None

    def start(self):
        self._t0 = time.monotonic()
        self._running = True

    def stop(self):
        if self._running:
            self._elapsed += time.monotonic() - self._t0
            self._running = False

    @property
    def elapsed(self) -> float:
        if self._running:
            return self._elapsed + (time.monotonic() - self._t0)
        return self._elapsed

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    def __str__(self):
        return f"[timer {self.label}] : {self.elapsed:.4f} s"
