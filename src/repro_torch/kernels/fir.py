"""tdFIR filter bank — wrapper of the hand-written CUDA kernel ``csrc/fir.cu``.

Complex FIR filter bank: for bank m, output sample n:
    y[m, n] = sum_k h[m, k] * x[m, n - k]      (complex MAC, causal)

:func:`fir_filter_bank` launches the CUDA kernel on CUDA tensors and runs
:func:`fir_filter_bank_plain`, the same function in plain PyTorch, on CPU
or meta tensors.  On a CUDA tensor it launches or raises; it never falls
back.  Proposed tile knobs are clamped with a warning, never asserted: the
tuner owns legality (the ``TuningSpace`` predicate in ``apps/tdfir.py``)
and an illegal point must still give a correct, measurable kernel.
"""
from __future__ import annotations

import ctypes
import functools
import warnings

import torch
import torch.nn.functional as F

from repro_torch.kernels import SMEM_PER_BLOCK, _build

# tap-loop unroll factors the CUDA source instantiates (the paper's knob b)
TAP_UNROLLS = (1, 2, 4, 8)
DEFAULT_BLOCK_N = 512        # output samples per block
FIR_R = 8                    # consecutive outputs per thread, as in csrc/fir.cu
FIR_MAX_THREADS = 256        # threads per block at most, as in csrc/fir.cu
MAX_BLOCK_N = FIR_R * FIR_MAX_THREADS


def largest_divisor(n: int, cap: int) -> int:
    """The largest divisor of ``n`` that is <= ``cap`` (>= 1).  Used to
    clamp proposed tile knobs to legal values."""
    cap = max(1, min(cap, n))
    for d in range(cap, 0, -1):
        if n % d == 0:
            return d
    return 1


def threads(block_n: int) -> int:
    """Threads of one block: FIR_R consecutive outputs each."""
    return -(-block_n // FIR_R)


def fir_pad(e: int) -> int:
    """Where window sample e is staged: one sample of padding after every
    FIR_R (``fir_pad`` in csrc/fir.cu)."""
    return e + e // FIR_R


def smem_bytes(block_n: int, n_taps: int) -> int:
    """Dynamic shared memory of one block, as complex64: the K taps (padded
    to an even count for 16-byte tap pairs) and the padded x window of
    ``threads * FIR_R + K`` samples."""
    window = threads(block_n) * FIR_R + n_taps
    return 8 * (n_taps + n_taps % 2 + fir_pad(window - 1) + 1)


def fir_filter_bank_plain(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the causally padded row times each tap,
    summed over taps in one pass."""
    n = x.shape[1]
    k = h.shape[1]
    # windows[m, t] = x[m, n + t - (K - 1)], the sample tap K - 1 - t multiplies
    windows = F.pad(x, (k - 1, 0)).unfold(1, n, 1)          # [M, K, N]
    return torch.einsum("mk,mkn->mn", h.flip(1), windows)


def clamp_tiles(n: int, k: int, block_n: int, tap_unroll: int) -> tuple[int, int]:
    """The tile knobs the kernel will run with: an invalid ``block_n`` (not
    dividing ``n``, or larger) is clamped to the largest divisor of ``n``
    below it, an invalid ``tap_unroll`` (not dividing ``k``, larger, or not
    instantiated in the CUDA source) to the largest instantiated divisor of
    ``k`` below it — each with a warning."""
    if block_n < 1 or n % block_n != 0 or block_n > n:
        eff = largest_divisor(n, block_n)
        warnings.warn(f"fir_filter_bank: block_n={block_n} invalid for n={n}; "
                      f"clamped to {eff}", stacklevel=3)
        block_n = eff
    if tap_unroll not in TAP_UNROLLS or k % tap_unroll != 0 or tap_unroll > k:
        eff = max((u for u in TAP_UNROLLS if u <= tap_unroll and k % u == 0),
                  default=1)
        warnings.warn(f"fir_filter_bank: tap_unroll={tap_unroll} invalid for "
                      f"k={k}; clamped to {eff}", stacklevel=3)
        tap_unroll = eff
    return block_n, tap_unroll


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fir")
    vp, i = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    _build.declare(lib, {
        "fir_filter_bank_launch": (i, (vp, vp, vp, i, i, i, i, i, vp)),
        "fir_filter_bank_attributes": (i, (i, ip, ip, ip)),
        "fir_outputs_per_thread": (i, ()),
        "fir_max_threads": (i, ()),
        "fir_smem_bytes": (i, (i, i)),
    })
    if (lib.fir_outputs_per_thread(), lib.fir_max_threads()) != (
            FIR_R, FIR_MAX_THREADS):
        raise RuntimeError("csrc/fir.cu and kernels/fir.py disagree on "
                           "FIR_R or FIR_MAX_THREADS")
    return lib


def kernel_smem_bytes(block_n: int, n_taps: int) -> int:
    """The dynamic shared memory the C entry point asks for at this tile
    (the kernel's own figure, held against :func:`smem_bytes`)."""
    return _lib().fir_smem_bytes(block_n, n_taps)


def kernel_attributes(tap_unroll: int = 1) -> dict:
    """``cudaFuncGetAttributes`` of the kernel instantiated for
    ``tap_unroll`` (its shared memory is dynamic: see :func:`smem_bytes`)."""
    return _build.func_attributes(_lib(), "fir_filter_bank_attributes",
                                  tap_unroll)


def fir_filter_bank(x: torch.Tensor, h: torch.Tensor, *,
                    block_n: int = DEFAULT_BLOCK_N,
                    tap_unroll: int = 1) -> torch.Tensor:
    """x: complex64 [M, N]; h: complex64 [M, K].  Returns y [M, N]."""
    if x.dim() != 2 or h.dim() != 2 or x.shape[0] != h.shape[0]:
        raise ValueError(f"fir_filter_bank: want x [M, N] and h [M, K], got "
                         f"{tuple(x.shape)} and {tuple(h.shape)}")
    if x.dtype != torch.complex64 or h.dtype != torch.complex64:
        raise TypeError(f"fir_filter_bank: want complex64, got {x.dtype} "
                        f"and {h.dtype}")
    if not (x.is_contiguous() and h.is_contiguous()):
        raise ValueError("fir_filter_bank: x and h must be contiguous")
    if x.device != h.device:
        raise ValueError(f"fir_filter_bank: x on {x.device}, h on {h.device}")
    m, n = x.shape
    k = h.shape[1]
    if x.numel() == 0 or k == 0:
        raise ValueError("fir_filter_bank: empty signal or filter")
    block_n, tap_unroll = clamp_tiles(n, k, block_n, tap_unroll)
    if x.device.type in ("cpu", "meta"):
        return fir_filter_bank_plain(x, h)
    if x.device.type != "cuda":
        raise ValueError(f"fir_filter_bank: no kernel for device {x.device}")
    if (m > 65_535 or m * n >= 2 ** 31 or block_n > MAX_BLOCK_N
            or smem_bytes(block_n, k) > SMEM_PER_BLOCK):
        raise ValueError(f"fir_filter_bank: shape M={m}, N={n}, K={k} with "
                         f"block_n={block_n} exceeds the kernel's limits")
    y = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.fir_filter_bank_launch(x.data_ptr(), h.data_ptr(),
                                          y.data_ptr(), m, n, k, block_n,
                                          tap_unroll, stream)
    _build.check(code, lib, "fir_filter_bank")
    fir_filter_bank.launches += 1
    return y


fir_filter_bank.launches = 0     # kernel launches since the last reset
