"""Model FLOPs utilization of the whole step: the needed FLOPs of every
token the window's ticks prefilled or decoded over (their summed host
time x the bf16 peak), in %."""
from bench import counts
from bench.stats import tick_flops


def read(run):
    ticks = run.window.window_ticks()
    if not ticks:
        return None
    flops = sum(tick_flops(run.dims, k) for k in ticks)
    return 100.0 * flops / (sum(k.seconds for k in ticks)
                            * counts.PEAK_BF16_FLOPS)
