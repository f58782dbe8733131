"""95th percentile over every output token of the window after a
request's first of the time since that request's previous token, in ms.
Host clock."""
from bench.stats import percentile, token_gaps


def read(run):
    gaps = token_gaps(run.window)
    return percentile(gaps, 95) * 1e3 if gaps else None
