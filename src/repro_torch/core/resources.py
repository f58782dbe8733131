"""Resource estimation — the paper's Step 3 (HDL-stage precompile analogue).

On FPGA: generate per-loop OpenCL, compile *only to the HDL stage* (minutes),
read Flip-Flop/LUT utilization.  Here "lowering" a variant is one run on
``device="meta"`` tensors (shapes only — no kernel builds, no arithmetic):

* ``lower_ok``      — False when that run raised: the variant cannot take
  the region's arguments and is never built.
* ``aten_ops``      — the number of aten ops of that run, the counterpart
  of the JAX package's lowered-op count ("logic utilization" proxy).
* ``resource_bytes`` / ``resource_budget`` — what the variant claims of the
  card's on-chip memory, and the size of that memory:

  - a hand-written kernel reports its **shared memory per block** from an
    estimator registered beside its variant (``apps/``) with
    :func:`register_smem_estimator`, which mirrors its launch configuration,
    against ``SMEM_PER_BLOCK`` = 232,448 bytes — the most shared memory one
    Hopper block may use (227 KB of the SM's 256 KB).  A kernel that claims
    more does not launch at all, so this is Hopper's hard limit per block,
    the counterpart of an FPGA's resource ceiling.
  - a plain-PyTorch variant reports its largest live intermediate (the
    largest op output of the meta run) against ``L2_BYTES`` = 50 MB, the
    H100's L2 cache: the on-chip memory such a tensor could stay in between
    two kernels.  A larger intermediate round-trips through HBM.

``resource_fraction`` = bytes / budget is the denominator of the paper's
resource efficiency.  Patterns whose summed fraction exceeds the cap are
never built (paper: combinations over the FPGA resource limit are skipped).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

from repro_torch.core.intensity import count_ops
from repro_torch.launch.constants import L2_BYTES, SMEM_PER_BLOCK


# (region, variant) -> fn(*meta args, **tile params) -> shared-memory bytes
# per block, mirroring the kernel's launch configuration.
_SMEM_ESTIMATORS: dict[tuple[str, str], Callable] = {}


def register_smem_estimator(region: str, variant: str):
    def deco(fn):
        _SMEM_ESTIMATORS[(region, variant)] = fn
        return fn
    return deco


@dataclass
class ResourceEstimate:
    region: str
    variant: str
    resource_bytes: float
    resource_budget: float
    aten_ops: int
    lower_seconds: float
    lower_ok: bool
    error: str = ""

    @property
    def resource_fraction(self) -> float:
        """Fraction of the on-chip budget (>1.0 = does not fit, like FPGA
        overflow)."""
        return self.resource_bytes / self.resource_budget


def precompile(region: str, variant: str, fn: Callable, args,
               params: dict | None = None,
               static_kwargs: dict | None = None) -> ResourceEstimate:
    """The cheap lowering pass: one run of ``fn(*args, **static_kwargs,
    **params)`` on meta copies of ``args``; ``params`` are a tuned gene's
    tile knobs, ``static_kwargs`` the region's own (``Region.static_kwargs``)."""
    params = params or {}
    kwargs = {**(static_kwargs or {}), **params}
    est = _SMEM_ESTIMATORS.get((region, variant))
    budget = SMEM_PER_BLOCK if est else L2_BYTES
    t0 = time.perf_counter()
    try:
        counter, _ = count_ops(lambda *a: fn(*a, **kwargs), args)
        used = (float(est(*args, **params)) if est
                else float(counter.largest_bytes))
        return ResourceEstimate(region, variant, used, budget, counter.n_ops,
                                time.perf_counter() - t0, True)
    except Exception as e:  # noqa: BLE001 — a failed lower = unusable variant
        return ResourceEstimate(region, variant, float("inf"), budget, 0,
                                time.perf_counter() - t0, False,
                                f"{type(e).__name__}: {e}")


def precompile_many(jobs, mapper=None) -> list[ResourceEstimate]:
    """Step-3 fan-out over ``(region, variant, fn, args[, params[,
    static_kwargs]])`` jobs, in job order.  ``mapper`` is an
    order-preserving ``map(fn, items)`` — the verification executor's
    ``map_concurrent`` runs the meta runs on its worker pool; the default
    is the serial built-in map."""
    jobs = list(jobs)
    if mapper is None:
        return list(map(lambda j: precompile(*j), jobs))
    return list(mapper(lambda j: precompile(*j), jobs))

