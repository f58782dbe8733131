#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

1. device  — requires CUDA; prints the card's name and power limit as
   ``nvidia-smi`` reports them, the torch and CUDA versions, and turns TF32
   off for matrix products and convolutions (the plain versions and the
   library yardstick then run in full float32).
2. build   — builds every CUDA kernel from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, in parallel).
3. kernels — holds each kernel against its plain PyTorch version on the
   card, with the stated tolerance, at every shape phases 4 and 5 give it
   (the paper's full sizes, MRI-Q's bench size) and at one shape off the
   kernel's grain (FIR: N=4000, where the default block_n 512 is clamped
   to 500; MRI-Q: 300 x 200, ragged in both loops); times kernel, plain version and (for the FIR bank) a one-call
   PyTorch yardstick with CUDA events; prints the bound and each kernel's
   registers and shared memory beside the Step-3 estimate.
4. planner — the main path: the five-step planner on tdFIR (HPEC set 1)
   and MRI-Q (sampled at its bench size, analysed at Parboil "large"),
   strategy staged, d=4, against a temporary plan cache; a second plan is
   served from the cache with zero measurements.
5. run     — the main path continued: the ``hopper`` patterns of both apps
   at the paper's full sizes, held against the all-offload builds.  The
   kernels' launch counters are zeroed before phase 4 and read here: both
   must have launched.

The line before the last is one JSON object listing every ported kernel;
the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# published H100 SXM peaks at the full 700 W limit (NVIDIA data sheet):
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# the special-function units retire 16 sines/cosines per clock per SM
# against 128 FP32 FMAs (256 flops): 1/16 of the FP32 flop rate
SFU_OPS_PER_S = FP32_FLOPS_PER_S / 16

ROOT = Path(__file__).resolve().parent


def phase(name: str) -> None:
    print(f"\n== {name} ==", flush=True)


def cuda_ms(torch, fn, calls: int, groups: int = 7) -> tuple[float, str]:
    """Median over ``groups`` of the mean CUDA-event time of ``calls``
    back-to-back calls, after one untimed group of warm-up calls; and the
    range of the group means, as text."""
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times), f"[{min(times):.4f}-{max(times):.4f}]"


def clocks() -> str:
    """The card's SM clock, its maximum, power draw and temperature now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()


def max_abs_err(torch, got, want) -> float:
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def assert_close(torch, got, want, what: str, *, rtol: float,
                 atol: float) -> None:
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    for g, w in zip(got, want):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what}: non-finite output")
        torch.testing.assert_close(
            g, w, rtol=rtol, atol=atol,
            msg=lambda m: f"{what} (rtol={rtol}, atol={atol}, max_abs_err="
                          f"{float((g - w).abs().max()):.3e}): {m}")


def fir_bound_ms(m: int, n: int, k: int) -> tuple[float, str]:
    """Least time for y = causal FIR of x [m, n] with h [m, k] (complex64):
    each input read once and the output written once, against the complex
    MACs these shapes need (causal: sample i has min(i + 1, k) taps)."""
    macs = m * sum(min(i + 1, k) for i in range(n))
    t_ops = 8.0 * macs / FP32_FLOPS_PER_S
    t_bytes = 8.0 * (2 * m * n + m * k) / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def mriq_bound_ms(num_x: int, num_k: int) -> tuple[float, str]:
    """Least time for computeQ: 7 float32 inputs read once, 2 outputs
    written once; per (voxel, sample) pair 10 FP32 flops (phase: 3 mul,
    2 add, 1 scale; two multiply-adds) and 2 transcendentals on the SFUs."""
    pairs = num_x * num_k
    t_ops = max(10.0 * pairs / FP32_FLOPS_PER_S, 2.0 * pairs / SFU_OPS_PER_S)
    t_bytes = 4.0 * (5 * num_x + 4 * num_k) / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def main() -> int:
    import torch

    # ---- 1. device ------------------------------------------------------
    phase("1. device")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.apps import mriq as mriq_app
    from repro_torch.apps import tdfir as tdfir_app
    from repro_torch.configs.paper_apps import MRIQ_BENCH, MRIQ_FULL, TDFIR_FULL
    from repro_torch.core.plan_cache import PlanCache
    from repro_torch.core.planner import AutoOffloader, PlannerConfig
    from repro_torch.core.regions import Impl, variants
    from repro_torch.core.resources import precompile
    from repro_torch.kernels import _build
    from repro_torch.kernels import fir, mriq

    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    print(card)
    print(f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
          f"device {torch.cuda.get_device_name(dev)}  "
          f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}  "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # ---- 2. build -------------------------------------------------------
    phase("2. build")
    t0 = time.perf_counter()
    built = _build.build()
    print(f"built {built or 'nothing (up to date)'} in "
          f"{time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}")
    for name in _build.SOURCES:
        print(f"-- ptxas {name}.cu --\n{_build.ptxas_report(name).strip()}")

    # ---- 3. kernels against their plain versions -----------------------
    phase("3. kernels")
    g = torch.Generator().manual_seed(0)

    def cnormal(*shape):
        return torch.complex(torch.randn(shape, generator=g),
                             torch.randn(shape, generator=g)).to(dev)

    def normal(n, scale=1.0):
        return (torch.randn(n, generator=g) * scale).to(dev)

    rows = {}
    tol = 3e-4
    m, n, k = TDFIR_FULL.n_banks, TDFIR_FULL.n_samples, TDFIR_FULL.n_taps
    for label, (mm, nn, kk) in (("full", (m, n, k)), ("clamped", (m, 4000, k))):
        x, h = cnormal(mm, nn), cnormal(mm, kk)
        got = fir.fir_filter_bank(x, h)          # clamped: block_n 512 -> 500
        want = fir.fir_filter_bank_plain(x, h)
        torch.cuda.synchronize()
        assert_close(torch, got, want, f"fir_filter_bank {label}", rtol=tol,
                     atol=tol)
        err = max_abs_err(torch, got, want)
        print(f"fir_filter_bank {label} M={mm} N={nn} K={kk}: "
              f"max_abs_err={err:.3e} (tol rtol=atol={tol})")
        if label == "full":
            xp = torch.nn.functional.pad(x, (kk - 1, 0)).unsqueeze(0)
            hf = h.flip(1).unsqueeze(1)
            lib = torch.nn.functional.conv1d(xp, hf, groups=mm)[0]
            assert_close(torch, lib, want, "grouped complex conv1d", rtol=tol,
                         atol=tol)
            ms, ms_range = cuda_ms(torch, lambda: fir.fir_filter_bank(x, h),
                                   200)
            plain_ms, plain_range = cuda_ms(
                torch, lambda: fir.fir_filter_bank_plain(x, h), 20)
            lib_ms, lib_range = cuda_ms(torch, lambda: torch.nn.functional
                                        .conv1d(xp, hf, groups=mm), 50)
            bound_ms, bound_by = fir_bound_ms(mm, nn, kk)
            attrs = fir.kernel_attributes(1)
            print(f"  kernel {ms:.4f} ms {ms_range}  plain {plain_ms:.4f} ms "
                  f"{plain_range}  conv1d {lib_ms:.4f} ms {lib_range}  bound "
                  f"{bound_ms * 1e3:.2f} us ({bound_by})")
            print(f"  clocks.sm, clocks.max.sm, power.draw, temperature: "
                  f"{clocks()}")
            est = precompile("fir_bank", "hopper",
                             variants("fir_bank")["hopper"], (x, h))
            print(f"  cudaFuncGetAttributes: {attrs}; dynamic smem "
                  f"{fir.smem_bytes(fir.DEFAULT_BLOCK_N, kk)} B/block; "
                  f"Step-3 estimate {est.resource_bytes:.0f} B/block")
            rows["fir_filter_bank"] = {
                "name": "fir_filter_bank", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/fir.cu",
                "replaces": "src/repro/kernels/fir.py:69",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms}

    # Each MRI-Q output is a sum of numK terms phi_j * cos/sin(phase).  A
    # term's own error (float32 phase, __sincosf) is ~1e-6 |phi_j|; the
    # float32 sums of the kernel and of the plain version's matrix product
    # differ by a random walk of ~6e-8 |Q| sqrt(numK) <= 2.7e-6 sum|phi| at
    # numK = 2,048.  So the tolerance is absolute, 1e-5 sum|phi|, with no
    # relative part (|Q| reaches the thousands): a sample dropped or counted
    # twice moves Q by ~|phi_j|, about 1 here, far outside it.
    for label, (nx, nk) in (("full", (MRIQ_FULL.num_x, MRIQ_FULL.num_k)),
                            ("bench", (MRIQ_BENCH.num_x, MRIQ_BENCH.num_k)),
                            ("ragged", (300, 200))):
        args = (normal(nx), normal(nx), normal(nx), normal(nk, 0.1),
                normal(nk, 0.1), normal(nk, 0.1), normal(nk).square())
        tol = 1e-5 * float(args[6].abs().sum())
        got = mriq.mriq_compute_q(*args)
        want = mriq.mriq_compute_q_plain(*args)
        torch.cuda.synchronize()
        assert_close(torch, got, want, f"mriq_compute_q {label}", rtol=0.0,
                     atol=tol)
        err = max_abs_err(torch, got, want)
        print(f"mriq_compute_q {label} numX={nx} numK={nk}: "
              f"max_abs_err={err:.3e} (tol atol=1e-5*sum|phi|={tol:.3e}, "
              f"rtol=0)")
        if label == "full":
            ms, ms_range = cuda_ms(torch, lambda: mriq.mriq_compute_q(*args),
                                   20)
            plain_ms, plain_range = cuda_ms(
                torch, lambda: mriq.mriq_compute_q_plain(*args), 3)
            bound_ms, bound_by = mriq_bound_ms(nx, nk)
            print(f"  kernel {ms:.4f} ms {ms_range}  plain {plain_ms:.4f} ms "
                  f"{plain_range}  library: none  bound "
                  f"{bound_ms * 1e3:.2f} us ({bound_by})")
            print(f"  clocks.sm, clocks.max.sm, power.draw, temperature: "
                  f"{clocks()}")
            est = precompile("compute_q", "hopper",
                             variants("compute_q")["hopper"], args)
            print(f"  cudaFuncGetAttributes: {mriq.kernel_attributes()}; "
                  f"Step-3 estimate {est.resource_bytes:.0f} B/block")
            rows["mriq_compute_q"] = {
                "name": "mriq_compute_q", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/mriq.cu",
                "replaces": "src/repro/kernels/mriq.py:49",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None}
        del args, got, want
    torch.cuda.empty_cache()

    # ---- 4. planner (main path; launch counters zeroed here) ------------
    phase("4. planner")
    fir.fir_filter_bank.launches = 0
    mriq.mriq_compute_q.launches = 0
    cfg = PlannerConfig(strategy="staged", max_measurements=4, reps=3)
    with tempfile.TemporaryDirectory() as tmp:
        cache = PlanCache(Path(tmp) / "plans.json")
        for prog in (tdfir_app.make_program(TDFIR_FULL, TDFIR_FULL, device=dev),
                     mriq_app.make_program(device=dev)):
            t0 = time.perf_counter()
            report = AutoOffloader(cfg).plan(prog, cache=cache)
            print(report.summary())
            print(f"planned {prog.name} in {time.perf_counter() - t0:.1f} s, "
                  f"{len(report.measurements)} measurements")
            if not (report.baseline.ok and report.measurements
                    and len(report.measurements) <= cfg.max_measurements):
                raise AssertionError(f"{prog.name}: unsound plan")
            again = AutoOffloader(cfg).plan(prog, cache=cache)
            if not again.from_cache or again.measurements:
                raise AssertionError(f"{prog.name}: re-plan was not a cache hit")
            print(f"re-plan: served from plan cache with "
                  f"{len(again.measurements)} measurements, best "
                  f"{Impl(again.best_pattern).describe()}")

    print(f"launches during the two plans: "
          f"fir_filter_bank {fir.fir_filter_bank.launches}, "
          f"mriq_compute_q {mriq.mriq_compute_q.launches}")

    # ---- 5. the hopper patterns at full size (main path, continued) -----
    phase("5. run")
    for prog, impl, tols in (
            (tdfir_app.make_program(TDFIR_FULL, TDFIR_FULL, device=dev),
             Impl({"fir_bank": "hopper"}), (3e-4, 1e-3)),
            (mriq_app.make_program(MRIQ_FULL, MRIQ_FULL, device=dev),
             Impl({"compute_q": "hopper"}), (3e-3, 3e-3, 1e-3))):
        sample = prog.sample_inputs(0, dev)
        offload = Impl({r.name: "offload" for r in prog.regions})
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        got = prog.build(impl)(*sample)
        torch.cuda.synchronize()
        t_hopper = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = prog.build(offload)(*sample)
        torch.cuda.synchronize()
        t_offload = time.perf_counter() - t0
        # the checksums (last output) sum in another order than the
        # offload build (a sequential loop against a pairwise reduction):
        # their tolerance is the summation-order error, 1e-3 relative
        for i, (a, b, t) in enumerate(zip(got, want, tols)):
            if a.shape != b.shape:
                raise AssertionError(f"{prog.name} output {i}: shape "
                                     f"{tuple(a.shape)} vs {tuple(b.shape)}")
            assert_close(torch, a, b, f"{prog.name} output {i}", rtol=t,
                         atol=t)
        print(f"{prog.name} {impl.describe()} vs all-offload: outputs "
              f"{[tuple(a.shape) for a in got]} agree; hopper build "
              f"{t_hopper:.2f} s, offload build {t_offload:.2f} s (wall, "
              f"first call); peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        del sample, got, want
        torch.cuda.empty_cache()
    launches = {"fir_filter_bank": fir.fir_filter_bank.launches,
                "mriq_compute_q": mriq.mriq_compute_q.launches}
    print(f"launches on the main path (phases 4-5): {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
        rows[name]["launches"] = count

    print("kernels: fir_filter_bank ported (cuda), mriq_compute_q ported "
          "(cuda); to port: flash_attention, decode_attention, rmsnorm, "
          "ssm_scan, rglru_scan")
    print(json.dumps({"kernels": [
        {k: rows[name][k] for k in ("name", "route", "source", "replaces",
                                    "launches", "max_abs_err", "ms",
                                    "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")}
        for name in ("fir_filter_bank", "mriq_compute_q")]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
