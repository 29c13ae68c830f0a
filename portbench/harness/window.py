"""The measured window of a closed loop with one caller: each iteration
starts when the one before it has ended, and ends when its output is on
the device and synchronized (the driver's `iterate` returns then).

The window opens when the first iteration starts and closes when the last
iteration that started before the deadline ends, so a rate is all the work
completed over all the time of the window, and a tail is over every
iteration of it. Times are the host's clock around whole iterations.
"""
from __future__ import annotations

import dataclasses
import statistics
import time


@dataclasses.dataclass
class Window:
    times: list  # seconds of each completed iteration, in order
    start: float
    end: float
    attempted: int

    @property
    def completed(self) -> int:
        return len(self.times)

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def rate(self, work_per_iteration: float) -> float:
        """Work completed per second over the whole window."""
        return work_per_iteration * self.completed / self.seconds

    def percentile_ms(self, p: int) -> float:
        """The p-th percentile (1..99) of the iteration times, in ms, over
        every iteration of the window (statistics.quantiles, 'inclusive')."""
        if len(self.times) < 2:
            return 1e3 * self.times[0]
        return 1e3 * statistics.quantiles(self.times, n=100, method="inclusive")[p - 1]


def run_window(iterate, seconds: float, clock=time.perf_counter, first: int = 0,
               until=None) -> Window:
    """Call iterate(i) for i = first, first + 1, ... until `seconds` have
    passed since the first call started (or until(i) is true before
    iteration i starts). Every iteration that starts is completed."""
    start = clock()
    deadline = start + seconds
    times, i, now = [], first, start
    while now < deadline and not (until and until(i)):
        t0 = now
        iterate(i)
        now = clock()
        times.append(now - t0)
        i += 1
    return Window(times=times, start=start, end=now, attempted=len(times))
