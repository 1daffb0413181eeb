"""Leveled logging, wall-clock stage timers and per-tick statistics.

Port of ``rtabmap_tpu/utils/logging.py`` without the profiler hooks:
``get_logger``, ``Timer`` and ``Statistics`` (a flat ``Timing/*``,
``Memory/*``, ``Loop/*`` ... name -> float map per ``process()`` call),
plus ``device_busy_us``, which reads a ``torch.profiler`` trace.
"""
from __future__ import annotations

import logging
import sys
import time
from contextlib import contextmanager
from typing import Dict, Tuple

_logger = logging.getLogger("rtabmap_tpu_torch")
if not _logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter(
        "[%(levelname).1s %(asctime)s %(name)s] %(message)s", "%H:%M:%S"))
    _logger.addHandler(_h)
    _logger.setLevel(logging.WARNING)


def get_logger(name: str = "") -> logging.Logger:
    return _logger.getChild(name) if name else _logger


class Timer:
    """Wall-clock timer started at construction (reference: UTimer)."""

    def __init__(self):
        self._t = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._t


class Statistics:
    """Flat named-metric map for one engine tick (reference: Statistics
    data(): string key -> float, grouped by prefix)."""

    def __init__(self):
        self.data: Dict[str, float] = {}
        self.stamp: float = 0.0
        self.ref_id: int = 0
        self.loop_closure_id: int = 0
        self.proximity_detection_id: int = 0
        self.extended: bool = False

    def add(self, key: str, value: float) -> None:
        self.data[key] = float(value)

    def get(self, key: str, default: float = 0.0) -> float:
        return self.data.get(key, default)

    @contextmanager
    def time_stage(self, key: str):
        t0 = time.perf_counter()
        yield
        self.data[key] = (time.perf_counter() - t0) * 1000.0  # ms


def device_busy_us(prof) -> Tuple[float, int]:
    """(union of the device intervals of a ``torch.profiler`` trace in us,
    their count): kernels and copies alike."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return 0.0, 0
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + cur_e - cur_s, len(spans)
