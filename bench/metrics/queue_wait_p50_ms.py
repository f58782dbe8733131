"""Median over the requests due in the window of the ms from the due time
to ``Request.slot_s`` (a slot assigned, the prefill starting).  Program
span."""
from bench.stats import percentile


def read(run):
    waits = [s.req.slot_s - s.due for s in run.window.measured()
             if s.req.slot_s >= 0]
    return percentile(waits, 50) * 1e3 if waits else None
