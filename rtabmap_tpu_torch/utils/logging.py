"""Leveled logging, wall-clock stage timers and per-tick statistics.

Port of ``rtabmap_tpu/utils/logging.py``: ``get_logger`` on the
``rtabmap_tpu_torch`` logger with ``set_level`` and ``add_file_sink``,
``Timer``, ``Statistics`` (a flat ``Timing/*``, ``Memory/*``, ``Loop/*``
... name -> float map per ``process()`` call), ``profile_trace`` (a
``torch.profiler`` trace of a run written into a directory, the twin's
JAX profiler trace; ``Tpu/ProfileDir``) and ``device_busy_us``, which
reads such a trace.
"""
from __future__ import annotations

import contextlib
import logging
import os
import socket
import sys
import time
from contextlib import contextmanager
from typing import Dict, Optional, Tuple

_logger = logging.getLogger("rtabmap_tpu_torch")
if not _logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter(
        "[%(levelname).1s %(asctime)s %(name)s] %(message)s", "%H:%M:%S"))
    _logger.addHandler(_h)
    _logger.setLevel(logging.WARNING)


def get_logger(name: str = "") -> logging.Logger:
    return _logger.getChild(name) if name else _logger


def set_level(level: str) -> None:
    _logger.setLevel(getattr(logging, level.upper()))


def add_file_sink(path: str) -> None:
    h = logging.FileHandler(path)
    h.setFormatter(logging.Formatter("[%(levelname).1s %(asctime)s %(name)s] %(message)s"))
    _logger.addHandler(h)


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
    their count): kernels and copies alike. ``record_function`` ranges
    (``profile_trace.step``) also appear on the device timeline, spanning
    their range's device work; they are left out."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
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


class profile_trace:
    """``torch.profiler`` trace of a run (CPU activities, and CUDA ones when
    a card is present), written on exit as a Chrome trace
    (``<host>_<pid>.<ms>.pt.trace.json``, TensorBoard's profiler layout)
    into ``trace_dir``; nothing at all when ``trace_dir`` is empty. After
    the block: ``path`` (the trace file), ``wall_us`` (the block's wall
    time, to a device synchronize), ``busy_us`` and ``device_ops``
    (``device_busy_us`` of the trace) and ``busy_share``.

    Usage::

        with profile_trace(params["Tpu/ProfileDir"]) as trace:
            for i, frame in enumerate(frames):
                with trace.step(i):
                    ... device work ...
        print(trace.busy_share)
    """

    def __init__(self, trace_dir: str = ""):
        self.dir = str(trace_dir or "")
        self.path: Optional[str] = None
        self.wall_us = self.busy_us = 0.0
        self.device_ops = 0
        self._prof = None

    def __enter__(self):
        if self.dir:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            import torch

            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.wall_us = (time.perf_counter() - self._t0) * 1e6
            self._prof.__exit__(*exc)
            os.makedirs(self.dir, exist_ok=True)
            self.path = os.path.join(self.dir, f"{socket.gethostname()}_{os.getpid()}."
                                               f"{int(time.time() * 1000)}.pt.trace.json")
            self._prof.export_chrome_trace(self.path)
            self.busy_us, self.device_ops = device_busy_us(self._prof)
            self._prof = None
        return False

    @property
    def busy_share(self) -> float:
        return self.busy_us / self.wall_us if self.wall_us else 0.0

    def step(self, i: int):
        """A ``slam_tick#i`` range in the trace (the twin's step annotation);
        no range when the trace is off."""
        if not self.dir:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(f"slam_tick#{i}")
