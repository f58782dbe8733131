#!/usr/bin/env python3
"""Where the time of the port's rglru_scan and fir_filter_bank kernels
goes, on one NVIDIA card.

    python3 tools/probe_kernels.py

Builds each kernel's source as it is and as variants made by text
substitution (into ``build/probe_kernels/``, gitignored), and times every
build as a CUDA-graph replay of C-entry launches (``chip_smoke.graph_ms``)
beside the device time of each kernel and memset that ``torch.profiler``
records:

* ``rglru_scan`` at recurrentgemma-2b's 2,080-token bucket ([1, 2,080,
  2,560] bf16) at three tile points; the variant ``no waits`` takes every
  chunk's carry from h0 (wrong results: what the chunks cost without the
  chain of carries);
* ``fir_filter_bank`` at HPEC set 1 (M=64, N=4,096, K=128) at three tile
  points; the variants ``staging only`` (no tap loop: the copies in and
  the stores out) and ``4 outputs a thread``.

Every variant but ``no waits`` and ``staging only`` must match the plain
version.  Needs a card; exits 2 without one.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
OUT = ROOT / "build" / "probe_kernels"

RGLRU_VARIANTS = {"as built": [],
                  "no waits": [("if (k == 0) {", "if (true) {")]}
FIR_VARIANTS = {"as built": [],
                "staging only": [("if (k % STEP == 0) {", "if (false) {"),
                                 ("for (int j0 = 0; j0 < k; j0 += TAP_UNROLL)",
                                  "for (int j0 = 0; j0 < 0; j0 += TAP_UNROLL)")],
                "4 outputs a thread": [("constexpr int FIR_R = 8;",
                                        "constexpr int FIR_R = 4;")]}


def build_variants(nvcc, flags, name, variants):
    """{variant: ctypes.CDLL} of csrc/<name>.cu with each substitution
    list applied, one nvcc each, all started together."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for label, subs in variants.items():
        src = (_build.CSRC / f"{name}.cu").read_text()
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"{name}.cu has no {old!r}")
            src = src.replace(old, new)
        tag = re.sub(r"\W", "_", label)
        path = OUT / f"{name}_{tag}.cu"
        path.write_text(src)
        so = path.with_suffix(".so")
        jobs[label] = (so, subprocess.Popen(
            [nvcc, *flags, "-o", str(so), str(path)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    libs = {}
    for label, (so, proc) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name} {label}:\n{err}")
        regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers",
                                                  out + err)})
        print(f"built {name} ({label}): registers {regs}")
        libs[label] = ctypes.CDLL(str(so))
    return libs


def device_times(torch, fn, calls=20) -> str:
    """Mean device time of each kernel and memset over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0)
        if t and e.count >= calls and ("kernel" in e.key or "Memset" in e.key):
            rows.append(f"{e.key.split('(')[0][-24:]} {t / e.count:.2f} us")
    return "; ".join(rows)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_kernels: needs an NVIDIA card", file=sys.stderr)
        return 2
    import chip_smoke as C
    from repro_torch.kernels import _build, fir
    from repro_torch.kernels import rglru_scan as RS
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip())
    nvcc = _build._nvcc()
    vp, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    stream = torch.cuda.current_stream(dev).cuda_stream

    a = (torch.rand(1, 2080, 2560, generator=g, device=dev) * 0.5 + 0.5
         ).to(torch.bfloat16)
    b = torch.randn(1, 2080, 2560, generator=g, device=dev).to(torch.bfloat16)
    h0 = torch.randn(1, 2560, generator=g, device=dev)
    want = RS.rglru_scan_plain(a, b, h0)
    libs = build_variants(nvcc, _build.NVCC_FLAGS, "rglru_scan", RGLRU_VARIANTS)
    for label, lib in libs.items():
        lib.rglru_scan_launch.argtypes = [vp] * 5 + [i] * 6 + [vp, sz, vp]
        lib.rglru_scan_scratch_bytes.restype = sz
        lib.rglru_scan_scratch_bytes.argtypes = [i] * 5
        for bc, tc in ((128, 32), (64, 64), (128, 16)):
            h_all, hf = torch.empty_like(a), torch.empty_like(h0)
            n = lib.rglru_scan_scratch_bytes(*a.shape, bc, tc)
            work = torch.empty(n, dtype=torch.uint8, device=dev)
            args = (a.data_ptr(), b.data_ptr(), h0.data_ptr(), h_all.data_ptr(),
                    hf.data_ptr(), *a.shape, bc, tc, 1, work.data_ptr(), n)

            def make(on, args=args, keep=(h_all, hf, work), lib=lib):
                return C.held(lib.rglru_scan_launch, (*args, on), keep)

            ms, spread = C.graph_ms(torch, make, 20)
            err = float((h_all.float() - want[0].float()).abs().max())
            if label == "as built" and err > 2e-2:
                raise AssertionError(f"rglru_scan {bc}x{tc}: error {err:.3e}")
            print(f"rglru_scan ({label}) block_c {bc}, time_chunk {tc}: graph "
                  f"{ms:.4f} ms {spread}; max_abs_err {err:.2e}; device: "
                  f"{device_times(torch, make(stream))}")

    m, nn, k = 64, 4096, 128
    x = torch.complex(torch.randn(m, nn, generator=g, device=dev),
                      torch.randn(m, nn, generator=g, device=dev))
    h = torch.complex(torch.randn(m, k, generator=g, device=dev),
                      torch.randn(m, k, generator=g, device=dev))
    want = fir.fir_filter_bank_plain(x, h)
    libs = build_variants(nvcc, _build.NVCC_FLAGS, "fir", FIR_VARIANTS)
    for label, lib in libs.items():
        lib.fir_filter_bank_launch.argtypes = [vp] * 3 + [i] * 5 + [vp]
        for bn, tu in ((512, 1), (256, 1), (1024, 8)):
            y = torch.empty_like(x)
            args = (x.data_ptr(), h.data_ptr(), y.data_ptr(), m, nn, k, bn, tu)

            def make(on, args=args, y=y, lib=lib):
                return C.held(lib.fir_filter_bank_launch, (*args, on), y)

            ms, spread = C.graph_ms(torch, make, 200)
            err = float((y - want).abs().max())
            if label != "staging only" and err > 3e-4:
                raise AssertionError(f"fir {label} {bn}x{tu}: error {err:.3e}")
            print(f"fir_filter_bank ({label}) block_n {bn}, tap_unroll {tu}: "
                  f"graph {ms:.4f} ms {spread}; max_abs_err {err:.2e}; "
                  f"device: {device_times(torch, make(stream))}")
    print(f"clocks.sm, clocks.max.sm, power.draw, temperature: {C.clocks()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
