"""The measured window: the schedule's requests driven through the port's
``ServeEngine.submit`` / ``ServeEngine.step``, and what each tick and each
token did, on the host's clock.

Open loop: a request is submitted at the first tick boundary at or after
its due time and is timed from its due time, so a tick that runs long
delays the requests due during it, and that wait counts; how late the
generator submitted is recorded.  Offline: every request is queued when
the window opens.  After the close the loop goes on (the mix's later
arrivals still coming) until every request due in the window has its
first token, or ``DRAIN_LIMIT_S`` has passed; nothing after the close
counts towards a rate.

A token's time is the host clock when the engine handed it over: a
request's first token at ``Request.admit_s`` (its prefill's sample), each
later one at the end of the tick whose decode produced it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from bench.trace import Tracer

DRAIN_LIMIT_S = 60.0


@dataclass
class Tick:
    t0: float
    t1: float
    admitted: list          # prompt lengths admitted (prefilled) this tick
    buckets: list           # their prefill buckets
    decoded: list           # per decoded slot: positions its token attended
    queue: int              # requests waiting for a slot after the tick
    busy: int = 0           # slots whose request got a token this tick
    traced: bool = False

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


@dataclass
class Served:
    """One submitted request: the planned entry, the engine's Request."""
    plan: object
    req: object
    due: float              # host clock it fell due
    submitted: float
    times: list = field(default_factory=list)     # host clock of each token


@dataclass
class Window:
    t_open: float
    t_close: float
    slots: int
    served: list = field(default_factory=list)
    ticks: list = field(default_factory=list)
    refused: int = 0
    tracer: Tracer | None = None
    end: float = 0.0                          # when the drain stopped

    @property
    def seconds(self) -> float:
        return self.t_close - self.t_open

    def in_window(self, t: float) -> bool:
        return self.t_open <= t < self.t_close

    def window_ticks(self) -> list:
        return [k for k in self.ticks if k.t0 < self.t_close]

    def measured(self) -> list:
        """The requests that count: due in the window."""
        return [s for s in self.served if s.plan.in_window]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(engine, plan: list, seconds: float, *, trace: dict | None = None,
        drain: bool = True) -> Window:
    """Drive ``engine`` through ``plan`` (``generator.Planned``, by due
    time) for ``seconds``; ``trace``: the mix's ``trace`` entry, to trace
    the window's last ``trace["seconds"]`` with ``torch.profiler``.  The
    profiler stops at the first tick boundary at or after the close, so
    that gathering its trace (seconds of host time) falls outside the
    window."""
    device = engine.device
    live: dict = {}                        # rid -> Served, not yet finished
    _sync(device)
    t_open = time.perf_counter()
    win = Window(t_open, t_open + seconds, engine.slots)
    if trace is not None:
        win.tracer = Tracer()
        tr0 = win.t_close - trace["seconds"]
    i, n = 0, len(plan)
    deadline = win.t_close + DRAIN_LIMIT_S
    while True:
        now = time.perf_counter()
        if win.tracer is not None:
            if win.tracer.running and now >= win.t_close:
                win.tracer.stop()
            elif win.tracer.t0 is None and tr0 <= now < win.t_close:
                win.tracer.start()
        if now >= win.t_close:
            pending = [s for s in win.measured() if not s.times]
            unsent = any(p.in_window for p in plan[i:])
            if (not drain or now >= deadline
                    or (not pending and not unsent)):
                break
        with torch.profiler.record_function("bench.submit"):
            while i < n and t_open + plan[i].due_s <= now:
                p = plan[i]
                i += 1
                try:
                    engine.submit(p.prompt, max_new_tokens=p.max_new_tokens)
                except ValueError:
                    win.refused += 1
                    continue
                req = engine.queue[-1]
                live[req.rid] = s = Served(p, req, t_open + p.due_s,
                                           time.perf_counter())
                win.served.append(s)
        if not engine.busy:
            limit = win.t_close if now < win.t_close else deadline
            nxt = t_open + plan[i].due_s if i < n else limit
            with torch.profiler.record_function("bench.idle"):
                time.sleep(max(0.0, min(nxt, limit) - now))
            continue
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.step"):
            engine.step()
        t1 = time.perf_counter()
        with torch.profiler.record_function("bench.record"):
            win.ticks.append(_record(engine, live, t0, t1, win.tracer))
    _sync(device)
    win.end = time.perf_counter()
    return win


def _record(engine, live: dict, t0: float, t1: float, tracer) -> Tick:
    admitted, buckets, decoded = [], [], []
    busy = 0
    for rid in list(live):
        s = live[rid]
        r = s.req
        new = len(r.generated) - len(s.times)
        if new <= 0:
            continue
        busy += 1
        if not s.times:                  # admitted this tick: first token
            s.times.append(r.admit_s)
            admitted.append(r.tokens.size)
            buckets.append(r.bucket)
            new -= 1
        for _ in range(new):             # this tick's decode
            # the fed token sits at position prompt + (j - 1) and attends
            # every position up to its own
            decoded.append(r.tokens.size + len(s.times))
            s.times.append(t1)
        if r.done:
            del live[rid]
    traced = (tracer is not None and tracer.t0 is not None
              and t0 >= tracer.t0 and (tracer.t1 is None or t1 <= tracer.t1))
    return Tick(t0, t1, admitted, buckets, decoded, len(engine.queue), busy,
                traced)
