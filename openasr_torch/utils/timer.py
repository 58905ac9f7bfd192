"""Wall-clock timer.

Counterpart of openasr_tpu/utils/timer.py (`Timer`, :8): `tic` / `toc`
in seconds, or a context manager that leaves the elapsed seconds in
`elapsed`.  Host time only: a caller timing work on the card
synchronises it before `toc`.
"""

from __future__ import annotations

import time


class Timer:
    def __init__(self) -> None:
        self._start = None

    def tic(self) -> None:
        self._start = time.time()

    def toc(self) -> float:
        if self._start is None:
            raise RuntimeError("Timer not started; call tic() first.")
        return time.time() - self._start

    def __enter__(self) -> "Timer":
        self.tic()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = self.toc()
