"""Fault-tolerance runtime: preemption handling + straggler detection.
The port's own copy of `repro/runtime/fault.py`; `StepTimer` waits for
the device before it reads the clock.

On a real cluster the coordinator runs one `StragglerMonitor` fed by
per-host heartbeats (here: per-step timings from the local trainer, the
multi-host transport being `torch.distributed` in production). The
preemption handler turns SIGTERM/SIGINT into a clean "save-and-exit" at
the next step boundary — paired with the atomic checkpoint publish this
gives at-most-one-step loss on eviction.
"""
from __future__ import annotations

import collections
import signal
import statistics
import threading
import time
from typing import Dict, List, Optional

import torch


class PreemptionHandler:
    """SIGTERM/SIGINT -> flag; trainer checks `should_stop` each step."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._stop = threading.Event()
        self._prev = {}
        for s in signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:
                pass  # non-main thread (tests)

    def _handler(self, signum, frame):
        self._stop.set()

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()

    def trigger(self):  # testable without a real signal
        self._stop.set()

    def restore(self):
        for s, h in self._prev.items():
            signal.signal(s, h)


class StragglerMonitor:
    """Flags hosts whose recent step times exceed `threshold` x median.

    Production action: report to the coordinator which re-slices the data
    shards away from the slow host (or triggers replacement); here the
    decision logic is what we test.
    """

    def __init__(self, n_hosts: int, window: int = 16,
                 threshold: float = 1.8):
        self.window = window
        self.threshold = threshold
        self.times: Dict[int, collections.deque] = {
            h: collections.deque(maxlen=window) for h in range(n_hosts)}

    def record(self, host: int, step_time: float):
        self.times[host].append(step_time)

    def medians(self) -> Dict[int, float]:
        return {h: statistics.median(ts) if ts else 0.0
                for h, ts in self.times.items()}

    def stragglers(self) -> List[int]:
        meds = {h: m for h, m in self.medians().items() if m > 0}
        if len(meds) < 2:
            return []
        overall = statistics.median(meds.values())
        return [h for h, m in meds.items() if m > self.threshold * overall]

    def healthy(self) -> bool:
        return not self.stragglers()


class StepTimer:
    """Context manager collecting step wall-times for the monitor. On a
    CUDA `device` it synchronizes the device before each clock read, so
    a step's time includes its queued kernels."""

    def __init__(self, monitor: Optional[StragglerMonitor] = None,
                 host: int = 0, device=None):
        self.monitor = monitor
        self.host = host
        self.device = device
        self.last: float = 0.0

    def _sync(self):
        if self.device is not None and torch.device(self.device).type \
                == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.last = time.monotonic() - self._t0
        if self.monitor is not None:
            self.monitor.record(self.host, self.last)
        return False
