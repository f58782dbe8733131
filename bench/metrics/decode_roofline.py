"""Share of the decode step's roofline: over the window's ticks that
admitted nothing, the sum of each tick's least time (the larger of its
bytes, every weight once and the live KV positions once, over the HBM
rate, and its model FLOPs over the bf16 peak) over the sum of their host
times, in %."""
from bench import counts


def read(run):
    ticks = [k for k in run.window.window_ticks()
             if not k.admitted and k.decoded]
    if not ticks:
        return None
    bound = sum(counts.decode_bound_s(run.dims, k.decoded) for k in ticks)
    return 100.0 * bound / sum(k.seconds for k in ticks)
