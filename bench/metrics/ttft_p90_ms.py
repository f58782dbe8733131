"""90th percentile over every request due in the window of the seconds
from its due time to its first token, in ms; a request refused or never
answered counts as missing (infinite).  Host clock."""
import math

from bench.stats import percentile, ttfts


def read(run):
    v = percentile(ttfts(run.window), 90)
    if not math.isfinite(v):
        # past the drain limit: the least it can be
        v = run.window.end - min(s.due for s in run.window.measured()
                                 if not s.times)
    return v * 1e3
