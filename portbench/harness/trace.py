"""The traced slice of a ``--trace 1`` run and its reduction.

The profiler records device activity only (``torch.profiler`` with CUDA
activity: kernels, copies, fills) over a slice that runs after the
window has closed (``window.traced_slice``), so the window of a traced
run is timed and counted as an untraced run's is. The start and the stop
each follow a device synchronize, and the slice's length is taken by the
host's clock between them; the events are reduced after the stop. The
reduction gives the device's busy seconds (the union of the activities'
intervals), each activity's count and seconds by name, and the longest
idle gaps between activities, each named by the activity that ended it.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

NAME_CHARS = 96


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def reduce_intervals(events):
    """``events``: ``(name, start_ns, end_ns)`` of device activities.
    Returns ``(busy_s, {name: [count, seconds]}, gaps)`` with ``gaps`` the
    idle intervals between merged activities as ``(seconds, next_name)``,
    longest first."""
    kernels: dict = {}
    for name, a, b in events:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (b - a) * 1e-9
    busy_ns, gaps = 0, []
    end = None
    for name, a, b in sorted(events, key=lambda e: e[1]):
        if end is None:
            busy_ns += b - a
            end = b
        elif a >= end:
            if a > end:
                gaps.append(((a - end) * 1e-9, name))
            busy_ns += b - a
            end = b
        elif b > end:
            busy_ns += b - end
            end = b
    gaps.sort(key=lambda g: -g[0])
    return busy_ns * 1e-9, kernels, gaps


class Tracer:
    """Profiles device activity on ``device`` between ``start`` and
    ``stop``, and reduces it after ``stop``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._prof = None
        self._t0 = None
        self.result: Optional[dict] = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _activities(self):
        from torch.profiler import ProfilerActivity

        return [ProfilerActivity.CUDA if self.device.type == "cuda"
                else ProfilerActivity.CPU]

    def warm(self) -> None:
        """One short profile: a process's first costs seconds."""
        from torch.profiler import profile

        with profile(activities=self._activities()):
            torch.ones(4, device=self.device).add_(1.0)
            self._sync()

    def start(self) -> None:
        from torch.profiler import profile

        self._sync()
        self._prof = profile(activities=self._activities())
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        self._sync()
        window_s = time.perf_counter() - self._t0
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        want = "CUDA" if self.device.type == "cuda" else "CPU"
        events = []
        for e in prof.profiler.kineto_results.events():
            if str(e.device_type()).endswith(want) and e.duration_ns() > 0:
                events.append((_short(e.name()), e.start_ns(),
                               e.start_ns() + e.duration_ns()))
        busy_s, kernels, gaps = reduce_intervals(events)
        top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
        self.result = {
            "busy_s": busy_s,
            "window_s": window_s,
            "kernels": kernels,
            "device_ops": [[name, secs] for name, (_, secs) in top],
            "idle_gaps": [[f"host, before {name}", secs] for secs, name in gaps[:10]],
        }
