"""Share of the prefill attention's roofline: over the traced stretch, the
sum of each prefill attention call's least time at the shapes it was made
with (its bucket, causal, grouped-query; one call a layer) over the
device time of the kernels named below, in %.  Device trace."""
from bench import counts

# the bf16 flash body and the combine of a split call
KERNELS = ("flash_wgmma_kernel", "flash_combine_kernel")


def read(run):
    if run.trace is None:
        return None
    device_s = run.trace.seconds_of(KERNELS)
    buckets = [b for k in run.window.ticks if k.traced for b in k.buckets]
    if not buckets or device_s <= 0:
        return None
    m = run.dims
    bound = m.layers * sum(counts.flash_call_bound_s(m, b) for b in buckets)
    return 100.0 * bound / device_s
