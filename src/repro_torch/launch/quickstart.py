"""Quickstart on the port: the automatic offload planner on a user program
(the twin of ``examples/quickstart.py``).

Declare regions (the "loop statements"), each with a loop-faithful ``ref``
(Python loops over rows and pixels through ``fori_loop``, as the JAX
example's ``fori_loop``) and a vectorized ``offload`` variant; give the
planner the program, and it runs the staged search: AI filter ->
resource filter -> budgeted measured patterns -> best pattern.  The plan is
kept in the plan cache (``PlanCache.default()``), so a second run is served
from it without measuring.

    PYTHONPATH=src python -m repro_torch.launch.quickstart \\
        [--strategy surrogate] [--size 512] [--device cpu]

``--size`` is the image side (512 as in the JAX example; the ``hist`` ref
walks every pixel, so a smaller side keeps a CPU run short).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.loops import fori_loop
from repro_torch.core.plan_cache import PlanCache
from repro_torch.core.planner import AutoOffloader, PlannerConfig
from repro_torch.core.program import OffloadableProgram, Region, meta
from repro_torch.core.regions import dispatch, register_variant, variants
from repro_torch.core.strategies import STRATEGY_NAMES

BINS = 8


# --- 1. the compute regions: a loop-faithful ref and an offload variant
#        (what the accelerator kernel computes) ---------------------------
def blur_ref(img):
    def row(i, acc):
        acc[i] = (img[i - 1] + img[i] + img[i + 1]) / 3.0
        return acc
    return fori_loop(1, img.shape[0] - 1, row, torch.zeros_like(img))


def blur_offload(img):
    out = (img[:-2] + img[1:-1] + img[2:]) / 3.0
    return torch.nn.functional.pad(out, (0, 0, 1, 1))


def hist_ref(img):
    flat = img.reshape(-1)

    def px(i, acc):
        b = torch.clamp((flat[i] * BINS).to(torch.int64), 0, BINS - 1)
        return acc.index_put_((b,), torch.ones((), dtype=acc.dtype,
                                               device=acc.device),
                              accumulate=True)
    return fori_loop(0, flat.numel(), px,
                     torch.zeros(BINS, dtype=img.dtype, device=img.device))


def hist_offload(img):
    b = torch.clamp((img.reshape(-1) * BINS).to(torch.int64), 0, BINS - 1)
    return torch.zeros(BINS, dtype=img.dtype, device=img.device).index_add_(
        0, b, torch.ones_like(img.reshape(-1)))


def register() -> None:
    """Register the two regions' variants (once per process)."""
    if not variants("blur"):
        register_variant("blur", "ref")(blur_ref)
        register_variant("blur", "offload")(blur_offload)
    if not variants("hist"):
        register_variant("hist", "ref")(hist_ref)
        register_variant("hist", "offload")(hist_offload)


# --- 2. the program -------------------------------------------------------
def make_program(size: int = 512, device=None) -> OffloadableProgram:
    register()

    def build(impl):
        def run(img):
            img = dispatch("blur", impl, img)
            return dispatch("hist", impl, img)
        return run

    def sample(seed: int, dev):
        g = torch.Generator().manual_seed(seed)
        return (torch.rand((size, size), generator=g).to(dev),)

    abstract = meta((size, size), torch.float32)
    return OffloadableProgram(
        name="quickstart",
        regions=[Region("blur", blur_ref, (abstract,)),
                 Region("hist", hist_ref, (abstract,))],
        build=build, sample_inputs=sample, device=resolve_device(device),
        source_loop_count=3)


# --- 3. plan (cached: a second run is served without re-measuring) -------
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--strategy", default="staged",
                    choices=list(STRATEGY_NAMES),
                    help="Step-4 search strategy: staged (paper heuristic), "
                         "genetic (GA over mixed genomes), surrogate "
                         "(roofline-predicted fitness, fewer real "
                         "measurements), exhaustive (oracle), auto (pick by "
                         "space size)")
    ap.add_argument("--seed", type=int, default=0,
                    help="strategy RNG seed (GA)")
    ap.add_argument("--size", type=int, default=512, help="image side")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without a card)")
    args = ap.parse_args(argv)
    program = make_program(args.size, device=args.device)
    report = AutoOffloader(PlannerConfig(
        reps=args.reps, strategy=args.strategy, seed=args.seed)).plan(
        program, cache=PlanCache.default())
    print(report.summary())
    if report.from_cache:
        print("(plan served from cache; delete the plan cache file to "
              "re-measure)")
    return report


if __name__ == "__main__":
    main()
