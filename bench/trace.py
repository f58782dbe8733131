"""Device time from ``torch.profiler``: the busy share of a traced part of
the window, device time by kernel name, and the idle gaps by what the
host was doing.

The harness traces the window's last seconds (the mix's ``trace``
entry), starting and stopping the profiler between engine ticks, and
marks its own phases with ``record_function`` spans (``bench.*``), so an
idle gap is named after the benchmark's span and the innermost host
operation that were running while the device waited.
"""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

TRACED = "bench.traced"
# gaps shorter than this (a graph's kernels one after another) are summed
# under one name instead of being looked up one by one
SHORT_GAP_NS = 20_000
SHORT_GAP = "between kernels (gaps under 20 us)"


@dataclass
class Trace:
    window_s: float                     # length of the traced stretch
    busy_s: float                       # union of device activity in it
    kernels: dict = field(default_factory=dict)    # name -> seconds
    gaps: dict = field(default_factory=dict)       # host activity -> seconds

    def seconds_of(self, patterns) -> float:
        """Device seconds of the kernels whose names contain any of
        ``patterns``."""
        return sum(s for name, s in self.kernels.items()
                   if any(p in name for p in patterns))

    def breakdown(self, n: int = 10) -> dict:
        top = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k[:160], v] for k, v in top],
                "idle_gaps": [[k[:160], v] for k, v in gaps]}


def _is_device(e) -> bool:
    return str(e.device_type()).rsplit(".", 1)[-1] in ("CUDA", "PrivateUse1")


def _span_ns(e) -> tuple[int, int]:
    if hasattr(e, "start_ns"):
        start = e.start_ns()
        return start, start + e.duration_ns()
    start = int(e.start_us() * 1000)
    return start, start + int(e.duration_us() * 1000)


def events(prof) -> tuple[list, list]:
    """(device events, host events) of a stopped profiler, each as
    (start_ns, end_ns, name).  The benchmark's own spans are host events
    only: the profiler mirrors each onto the device's timeline as an
    annotation, which is no device work."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        a, b = _span_ns(e)
        name = e.name()
        if not _is_device(e):
            host.append((a, b, name))
        elif not name.startswith("bench."):
            dev.append((a, b, name))
    return dev, host


def merge(intervals: list[tuple[int, int]]) -> list[list[int]]:
    """The union of [start, end) intervals, sorted and disjoint."""
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _host_activity(host: list, t: int) -> str:
    """'<benchmark span> > <innermost host operation>' running at ``t``."""
    spans = [(b - a, name) for a, b, name in host if a <= t < b]
    if not spans:
        return "no host activity recorded"
    bench = [s for s in spans if s[1].startswith("bench.") and s[1] != TRACED]
    outer = max(bench)[1] if bench else "outside the benchmark's spans"
    inner = min(s for s in spans if s[1] != TRACED)[1] if len(spans) > 1 \
        else outer
    return outer if inner == outer else f"{outer} > {inner}"


def reduce(dev: list, host: list) -> Trace:
    """The traced stretch's figures: its bounds are the ``bench.traced``
    host span."""
    marks = [(a, b) for a, b, name in host if name == TRACED]
    if not marks:
        raise ValueError("the trace holds no bench.traced span")
    lo, hi = marks[0]
    inside = [(max(a, lo), min(b, hi), n) for a, b, n in dev if b > lo and a < hi]
    kernels: dict = defaultdict(float)
    for a, b, name in inside:
        kernels[name] += (b - a) * 1e-9
    busy = merge([(a, b) for a, b, _ in inside])
    gaps: dict = defaultdict(float)
    edge = lo
    for a, b in busy + [[hi, hi]]:
        if a - edge >= SHORT_GAP_NS:
            gaps[_host_activity(host, (a + edge) // 2)] += (a - edge) * 1e-9
        elif a > edge:
            gaps[SHORT_GAP] += (a - edge) * 1e-9
        edge = max(edge, b)
    return Trace(window_s=(hi - lo) * 1e-9,
                 busy_s=sum(b - a for a, b in busy) * 1e-9,
                 kernels=dict(kernels), gaps=dict(gaps))


ACTIVITIES = (torch.profiler.ProfilerActivity.CPU,
              torch.profiler.ProfilerActivity.CUDA)


def warm_profiler(device) -> None:
    """Trace one small operation, so that the profiler's first start (the
    device tracer's initialization, seconds) falls in set-up and not in
    the window."""
    with torch.profiler.profile(activities=list(ACTIVITIES)):
        torch.ones(1, device=device).add_(1)
        if device.type == "cuda":
            torch.cuda.synchronize(device)


class Tracer:
    """One traced stretch: :meth:`start` and :meth:`stop` between ticks."""

    def __init__(self):
        self.prof = None
        self._mark = None
        self.t0 = self.t1 = None       # host perf_counter bounds

    def start(self) -> None:
        self.prof = torch.profiler.profile(activities=list(ACTIVITIES))
        self.prof.start()
        self._mark = torch.profiler.record_function(TRACED)
        self._mark.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self._mark.__exit__(None, None, None)
        self.t1 = time.perf_counter()
        self.prof.stop()

    @property
    def running(self) -> bool:
        return self.prof is not None and self.t1 is None

    def result(self) -> Trace | None:
        """None where the stretch never started (the engine idle)."""
        return reduce(*events(self.prof)) if self.prof is not None else None
