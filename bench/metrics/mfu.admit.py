"""Model FLOPs utilization of the ticks that admitted: their needed FLOPs
(prefills and the tick's decode) over (their summed host time x the bf16
peak), in %."""
from bench import counts
from bench.stats import tick_flops


def read(run):
    ticks = [k for k in run.window.window_ticks() if k.admitted]
    if not ticks:
        return None
    flops = sum(tick_flops(run.dims, k) for k in ticks)
    return 100.0 * flops / (sum(k.seconds for k in ticks)
                            * counts.PEAK_BF16_FLOPS)
