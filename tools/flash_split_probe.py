#!/usr/bin/env python3
"""The bf16 flash kernel's work split (split-KV) on one NVIDIA card.

    PYTHONPATH=src python3 tools/flash_split_probe.py [--sweep]
        [--parent PATH]

For each row of PERF.md's kernel table that runs the bf16 body (3, 3b, 3p
at S = 272 / 768 / 2,080, 3w at each bf16 tile point) it prints the split
plan the wrapper takes on this card (chunk_tiles, units and chunks of
each q tile, blocks an SM holds), holds the wrapper's output against
``flash_attention_plain`` (rtol = atol = 2e-2), and times, as CUDA-graph
replays of C-entry launches (median of 7 groups of 10): the plan's split
kernel with its combine, the combine alone, and SDPA.

``--sweep`` does the same for every distinct cut of the row
(chunk_tiles from the longest range down to 2) at the default tiles,
each checked against the plain version: the data behind split_plan's
cost model.

``--parent PATH`` builds PATH, a flash_attention.cu of an earlier commit
(``git show <commit>:src/repro_torch/kernels/csrc/flash_attention.cu``,
written into a gitignored directory before the run), with the same nvcc
flags, and times it against this source on rows 3 and 3b (and the
others) in 5 rounds of parent, this, this, parent, each a graph replay:
it prints both medians and the median of (this1 + this2) / (parent1 +
parent2).  Needs a card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402

# name: (b, hq, hkv, s, d, causal, window)
ROWS = {
    "3 serve": (1, 32, 8, 2048, 128, True, 0),
    "3b hybrid": (1, 10, 1, 2048, 256, True, 2048),
    "3p S=272": (1, 8, 1, 272, 256, True, 0),
    "3p S=768": (1, 8, 1, 768, 256, True, 0),
    "3p S=2080": (1, 8, 1, 2080, 256, True, 0),
    "3w encoder": (1, 12, 12, 1500, 64, False, 0),
}
CALLS, GROUPS, ROUNDS = 10, 7, 5
TOL = 2e-2


def graph_ms(launch, calls: int = CALLS, groups: int = GROUPS) -> float:
    """Median over groups of one replay of a graph of ``calls`` launches,
    per launch (ms)."""
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        launch(stream.cuda_stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="relaxed"):
        for _ in range(calls):
            launch(stream.cuda_stream)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def check(code: int, lib, what: str) -> None:
    if code:
        raise RuntimeError(f"{what}: CUDA error {code} "
                           f"({lib.repro_cuda_error_string(code).decode()})")


def schedule(lib, q, k, v, o, plan: FA.SplitPlan, part, *, split=True,
             combine=True):
    """One call of this source's kernels on ``plan``'s cut: a launch on a
    stream (its handle)."""
    b, hq, s, d = q.shape
    ptr = part.data_ptr() if part is not None else None
    n = part.numel() if part is not None else 0

    def launch(stream):
        if split:
            check(lib.flash_attention_launch_schedule(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b,
                hq, k.shape[1], s, d, plan.block_q, plan.block_k,
                int(plan.causal), plan.window, 1 / math.sqrt(d), 1,
                plan.chunk_tiles, ptr, n, stream), lib, "split kernel")
        if combine and plan.partials:
            check(lib.flash_attention_combine_launch(
                ptr, o.data_ptr(), b, hq, s, d, plan.block_q, plan.block_k,
                int(plan.causal), plan.window, plan.chunk_tiles, stream), lib,
                "combine")
    return launch


def describe(plan: FA.SplitPlan) -> str:
    return (f"chunk_tiles {plan.chunk_tiles}, {plan.units} units a head, "
            f"chunks a q tile (last first) "
            f"{[len(c) for _, c in plan.tiles]}, {plan.partials} partials "
            f"({plan.workspace_floats * 4 / 2**20:.2f} MiB)")


def run_cut(lib, q, k, v, want, plan: FA.SplitPlan, label: str) -> float:
    o = torch.empty_like(q)
    part = (torch.empty(plan.workspace_floats, dtype=torch.float32,
                        device=q.device) if plan.partials else None)
    schedule(lib, q, k, v, o, plan, part)(
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    err = float((o.float() - want.float()).abs().max())
    ok = torch.allclose(o.float(), want.float(), rtol=TOL, atol=TOL)
    both = graph_ms(schedule(lib, q, k, v, o, plan, part))
    line = (f"  {label}: {describe(plan)}; max_abs_err {err:.3e}"
            f"{'' if ok else ' OVER 2e-2'}; split + combine {both:.4f} ms")
    if plan.partials:
        alone = graph_ms(schedule(lib, q, k, v, o, plan, part, split=False))
        kern = graph_ms(schedule(lib, q, k, v, o, plan, part, combine=False))
        line += f" (split kernel {kern:.4f}, combine {alone:.4f})"
    print(line, flush=True)
    if not ok:
        raise AssertionError(f"{label}: the kernel disagrees with the plain "
                             f"version ({err:.3e})")
    return both


def cuts(row, bq, bk) -> list[FA.SplitPlan]:
    """Every distinct cut of the row, chunk_tiles from none down to 2."""
    b, hq, _, s, d, causal, window = row
    out, seen = [], set()
    longest = max(e - b_ for b_, e in (
        FA.visit_range(t, s, bq, bk, causal, window)
        for t in range(-(-s // bq))))
    for t in [0] + list(range(longest - 1, 1, -1)):
        p = FA.SplitPlan(b, hq, s, d, bq, bk, causal, window, t)
        key = tuple(len(c) for _, c in p.tiles)
        if key not in seen:
            seen.add(key)
            out.append(p)
    return out


def build_parent(path: Path):
    where = _build.build_dir() / "flash_split_probe"
    where.mkdir(parents=True, exist_ok=True)
    lib = where / "libparent_flash.so"
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                        str(path)], capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed for {path}:\n{r.stderr[-3000:]}")
    parent = ctypes.CDLL(str(lib))
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    parent.flash_attention_launch.argtypes = (vp, vp, vp, vp, i, i, i, i, i,
                                              i, i, i, i, f, i, vp)
    parent.repro_cuda_error_string.restype = ctypes.c_char_p
    return parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--parent", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA card (torch.cuda.is_available() is False)")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"card: {smi.stdout.strip() or torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda")
    lib = FA._lib()
    parent = build_parent(args.parent) if args.parent else None
    g = torch.Generator().manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name, row in ROWS.items():
        b, hq, hkv, s, d, causal, window = row
        q = torch.randn(b, hq, s, d, generator=g).to(dev, torch.bfloat16)
        k = torch.randn(b, hkv, s, d, generator=g).to(dev, torch.bfloat16)
        v = torch.randn(b, hkv, s, d, generator=g).to(dev, torch.bfloat16)
        want = FA.flash_attention_plain(q, k, v, causal=causal, window=window)
        dq, dk = FA.default_tiles(torch.bfloat16, d)
        points = ([(pq, pk) for pq in FA.WGMMA_BLOCK_QS
                   for pk in FA.WGMMA_BLOCK_KS
                   if FA.fits(pq, pk, d, torch.bfloat16)]
                  if name.startswith("3w") else [(dq, dk)])
        mask = None if window == 0 or window >= s else FA._mask(
            s, causal, window, dev)
        lib_ms = graph_ms(lambda on: sdpa(
            q, k, v, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=hq != hkv))
        print(f"{name} [{b}, {hq}/{hkv}, {s}, {d}] causal={causal} window="
              f"{window}: SDPA {lib_ms:.4f} ms", flush=True)
        for bq, bk in points:
            plan = FA.device_plan(dev, b, hq, s, d, bq, bk, causal, window)
            ctas = FA.ctas_per_sm(bq, bk, d, dev.index or 0)
            got = FA.flash_attention(q, k, v, causal=causal, window=window,
                                     block_q=bq, block_k=bk)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            print(f" tiles {bq}x{bk}: {ctas} block(s) an SM; wrapper "
                  f"max_abs_err {err:.3e}", flush=True)
            mine = run_cut(lib, q, k, v, want, plan, "plan")
            if args.sweep and (bq, bk) == (dq, dk):
                for cut in cuts(row, bq, bk):
                    run_cut(lib, q, k, v, want, cut, f"cut {cut.chunk_tiles}")
            if parent is None or (bq, bk) != (dq, dk):
                continue
            o = torch.empty_like(q)

            def old(stream, o=o, bq=bq, bk=bk):
                check(parent.flash_attention_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b,
                    hq, hkv, s, d, bq, bk, int(causal), window,
                    1 / math.sqrt(d), 1, stream), parent, "parent")
            old(torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            err = float((o.float() - want.float()).abs().max())
            part = (torch.empty(plan.workspace_floats, dtype=torch.float32,
                                device=dev) if plan.partials else None)
            new = schedule(lib, q, k, v, torch.empty_like(q), plan, part)
            a_ms, b_ms, ratios = [], [], []
            for _ in range(ROUNDS):
                a1, b1, b2, a2 = (graph_ms(old), graph_ms(new),
                                  graph_ms(new), graph_ms(old))
                a_ms += [a1, a2]
                b_ms += [b1, b2]
                ratios.append((b1 + b2) / (a1 + a2))
            print(f"  A/B parent {statistics.median(a_ms):.4f} ms "
                  f"[{min(a_ms):.4f}-{max(a_ms):.4f}] (max_abs_err "
                  f"{err:.3e}), this {statistics.median(b_ms):.4f} ms "
                  f"[{min(b_ms):.4f}-{max(b_ms):.4f}] (plan "
                  f"{mine:.4f}); this/parent median "
                  f"{statistics.median(ratios):.4f} "
                  f"[{min(ratios):.4f}-{max(ratios):.4f}]", flush=True)
        del q, k, v, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
