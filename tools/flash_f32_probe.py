#!/usr/bin/env python3
"""Where the float32 flash kernel's time goes, on one NVIDIA card.

    PYTHONPATH=src python3 tools/flash_f32_probe.py

Builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` as it stands and
three variants of its float32 body, each into its own library under the
build directory (``nvcc`` in parallel), and times every one's float32 tile
points at [1, 32/8, 2,048, 128], [1, 32/8, 2,048, 64] and [1, 10/1, 2,048,
256], causal, from the C entry point (median of 7 groups of 5 launches,
CUDA events), with its largest error against ``flash_attention_plain``:

* ``kernel``: the source as it is;
* ``one_product``: hi.hi alone in both products (TF32, not float32: its
  error is ~1e-3), the tensor cores' third of the work;
* ``no_split_stores``: the producer splits nothing into shared memory (the
  consumers read stale tiles: a wrong result), the consumers' side alone;
* ``producer_regs=N``: setmaxnreg gives the producer N registers and the
  consumers the rest of the block's 64,512 (N = 72 and 104).

It prints each variant's ptxas registers and stack frames (a spill shows
there) and the card's name and power limit.  Needs a card; exits 2
without one.
"""
from __future__ import annotations

import ctypes
import math
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402

SOURCE = _build.CSRC / "flash_attention.cu"
SHAPES = ((32, 8, 128), (32, 8, 64), (10, 1, 256))   # (Hq, Hkv, D)
SEQ = 2048
S_PRODUCTS = """            wgmma_tf32<BK>(s, al[set][h], dh, kk > 0);
            wgmma_tf32<BK>(s, ah[set][h], dl, 1);
            wgmma_tf32<BK>(s, ah[set][h], dh, 1);"""
PV_PRODUCTS = """          wgmma_tf32<D>(acc, pl[j], dh, 1);
          wgmma_tf32<D>(acc, ph[j], dl, 1);
          wgmma_tf32<D>(acc, ph[j], dh, 1);"""
REGS = re.compile(r"constexpr int TF32_PRODUCER_REGS = \d+;\n"
                  r"constexpr int TF32_CONSUMER_REGS = \d+;")


def variants(src: str) -> dict[str, str]:
    """The source and its diagnostic variants, by name."""
    for part in (S_PRODUCTS, PV_PRODUCTS):
        if part not in src or not REGS.search(src):
            raise SystemExit(f"{SOURCE} no longer has the float32 body this "
                             "probe edits")
    out = {"kernel": src,
           "one_product": src.replace(
               S_PRODUCTS, "            wgmma_tf32<BK>(s, ah[set][h], dh, "
               "kk > 0);").replace(
               PV_PRODUCTS, "          wgmma_tf32<D>(acc, ph[j], dh, 1);"),
           "no_split_stores": src.replace(
               'asm volatile("st.shared.v4.b32',
               'if (0) asm volatile("st.shared.v4.b32').replace(
               'asm volatile("st.shared.b32', 'if (0) asm volatile('
               '"st.shared.b32')}
    for producer in (72, 104):
        consumer = (64_512 - 128 * producer) // 256
        out[f"producer_regs={producer}"] = REGS.sub(
            f"constexpr int TF32_PRODUCER_REGS = {producer};\n"
            f"constexpr int TF32_CONSUMER_REGS = {consumer};", src)
    return out


def compile_all(sources: dict[str, str], where: Path) -> dict[str, tuple]:
    """{name: (library path, ptxas report)}; one nvcc a variant, together."""
    where.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()

    def one(item):
        name, text = item
        tag = re.sub(r"\W", "_", name)
        cu, lib = where / f"{tag}.cu", where / f"lib{tag}.so"
        cu.write_text(text)
        r = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
                           capture_output=True, text=True)
        if r.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{r.stderr[-3000:]}")
        return name, (lib, r.stdout + r.stderr)

    with ThreadPoolExecutor(len(sources)) as pool:
        return dict(pool.map(one, sources.items()))


def frames(report: str) -> str:
    """'D x block_q x block_k: registers/stack bytes' of each float32
    instance in a ptxas report."""
    out, name, frame = [], None, 0
    for line in report.splitlines():
        m = re.search(r"flash_tf32_kernelILi(\d+)ELi(\d+)ELi(\d+)E", line)
        if "Compiling entry function" in line:
            name = "x".join(m.groups()) if m else None
        m2 = re.search(r"(\d+) bytes stack frame", line)
        if m2:
            frame = int(m2.group(1))
        m3 = re.search(r"Used (\d+) registers", line)
        if m3 and name:
            out.append(f"{name}: {m3.group(1)}/{frame}")
            name, frame = None, 0
    return ", ".join(out)


def time_ms(fn, calls: int = 5, groups: int = 7) -> float:
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
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA card (torch.cuda.is_available() is False)")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"card: {smi.stdout.strip() or torch.cuda.get_device_name(0)}")
    libs = compile_all(variants(SOURCE.read_text()),
                       _build.build_dir() / "flash_f32_probe")
    for name, (_, report) in libs.items():
        print(f"{name}: registers/stack frame bytes {frames(report)}")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    loaded = {}
    for name, (path, _) in libs.items():
        lib = ctypes.CDLL(str(path))
        lib.flash_attention_launch.argtypes = (vp, vp, vp, vp, i, i, i, i, i,
                                               i, i, i, i, f, i, i, vp,
                                               ctypes.c_longlong, vp)
        loaded[name] = lib
    for hq, hkv, d in SHAPES:
        q = torch.randn(1, hq, SEQ, d, generator=g).to(dev)
        k = torch.randn(1, hkv, SEQ, d, generator=g).to(dev)
        v = torch.randn(1, hkv, SEQ, d, generator=g).to(dev)
        want = FA.flash_attention_plain(q, k, v)
        points = [(bq, bk) for bq in FA.BLOCK_QS for bk in FA.BLOCK_KS
                  if FA.fits(bq, bk, d, torch.float32)]
        for name, lib in loaded.items():
            for bq, bk in points:
                o = torch.empty_like(q)

                def run():
                    code = lib.flash_attention_launch(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                        1, hq, hkv, SEQ, d, bq, bk, 1, 0, 1 / math.sqrt(d), 0,
                        0, None, 0, torch.cuda.current_stream().cuda_stream)
                    if code:
                        raise RuntimeError(f"{name} {bq}x{bk}: launch {code}")
                run()
                torch.cuda.synchronize()
                err = float((o - want).abs().max())
                print(f"[1, {hq}/{hkv}, {SEQ}, {d}] {name} {bq}x{bk}: "
                      f"{time_ms(run):.4f} ms, max_abs_err {err:.2e}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
