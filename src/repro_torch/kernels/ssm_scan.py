"""Mamba-1 selective scan — wrapper of the hand-written CUDA kernel
``csrc/ssm_scan.cu``.

    h_t = a_t * h_{t-1} + bx_t;   y_t = sum_n h_t[..., n] * c_t[n]

:func:`ssm_scan` launches the kernel on CUDA tensors and runs
:func:`ssm_scan_plain`, the same function in plain PyTorch, on CPU or meta
tensors.  On a CUDA tensor it launches or raises; it never falls back.
``block_c`` (channels per block, ``block_c * N / 2`` threads: a thread
holds two neighbouring states) and
``time_chunk`` (time steps whose loads are issued together) are the
kernel's tile sizes; S and D need not be multiples of either.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.loops import fori_loop
from repro_torch.kernels import _build

BLOCK_CS = (4, 8, 16, 32, 64)    # channels per block
TIME_CHUNKS = (8, 16, 32)        # time steps per chunk
STATE_SIZES = (2, 4, 8, 16, 32)
DEFAULT_BLOCK_C = 16
DEFAULT_TIME_CHUNK = 16
MAX_THREADS = 256


def fits(block_c: int, time_chunk: int, n: int) -> bool:
    """Whether the source instantiates (N, time_chunk) and the block is
    whole warps (the sum over N shuffles inside a warp) of at most
    ``MAX_THREADS`` threads, two states a thread.  The kernel keeps its
    chunks in registers and uses no shared memory, so that is the whole
    rule."""
    threads = block_c * n // 2
    return (n in STATE_SIZES and time_chunk in TIME_CHUNKS
            and threads % 32 == 0 and threads <= MAX_THREADS)


def ssm_scan_plain(a: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
                   h0: torch.Tensor):
    """Plain PyTorch version with the kernel's precision: h and the sum over
    N in float32, y stored in a's type, h_final float32."""
    h = h0.float()
    y = torch.empty(a.shape[:3], dtype=a.dtype, device=a.device)

    def step(t, h):
        h = a[:, t].float() * h + bx[:, t].float()
        y[:, t] = torch.einsum("bdn,bn->bd", h, c[:, t].float())
        return h

    return y, fori_loop(0, a.shape[1], step, h)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssm_scan")
    vp, i = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    _build.declare(lib, {
        "ssm_scan_launch": (i, (vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, i,
                                vp)),
        "ssm_scan_attributes": (i, (i, i, i, ip, ip, ip)),
    })
    return lib


def kernel_attributes(n: int = 16, time_chunk: int = DEFAULT_TIME_CHUNK,
                      bf16: bool = True) -> dict:
    """``cudaFuncGetAttributes`` of the instance for (N, time_chunk, type)."""
    return _build.func_attributes(_lib(), "ssm_scan_attributes", n,
                                  time_chunk, int(bf16))


def ssm_scan(a: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
             h0: torch.Tensor, *, block_c: int = DEFAULT_BLOCK_C,
             time_chunk: int = DEFAULT_TIME_CHUNK):
    """a, bx: [B, S, D, N]; c: [B, S, N], all bf16 or all float32; h0:
    [B, D, N] float32; all contiguous.  Returns (y [B, S, D] in a's type,
    h_final [B, D, N] float32)."""
    if a.dim() != 4 or bx.shape != a.shape:
        raise ValueError(f"ssm_scan: want a, bx [B, S, D, N], got "
                         f"{tuple(a.shape)}, {tuple(bx.shape)}")
    b, s, d, n = a.shape
    if tuple(c.shape) != (b, s, n) or tuple(h0.shape) != (b, d, n):
        raise ValueError(f"ssm_scan: c {tuple(c.shape)} / h0 "
                         f"{tuple(h0.shape)} do not fit a {tuple(a.shape)}")
    if a.dtype not in (torch.bfloat16, torch.float32) or not (
            a.dtype == bx.dtype == c.dtype) or h0.dtype != torch.float32:
        raise TypeError(f"ssm_scan: want a, bx, c all bfloat16 or all "
                        f"float32 and h0 float32, got {a.dtype}, {bx.dtype}, "
                        f"{c.dtype}, {h0.dtype}")
    if not all(t.is_contiguous() for t in (a, bx, c, h0)):
        raise ValueError("ssm_scan: a, bx, c and h0 must be contiguous")
    if not (a.device == bx.device == c.device == h0.device):
        raise ValueError(f"ssm_scan: a on {a.device}, bx on {bx.device}, c on "
                         f"{c.device}, h0 on {h0.device}")
    if a.numel() == 0:
        raise ValueError("ssm_scan: empty input")
    if a.device.type in ("cpu", "meta"):
        return ssm_scan_plain(a, bx, c, h0)
    if a.device.type != "cuda":
        raise ValueError(f"ssm_scan: no kernel for device {a.device}")
    if not fits(block_c, time_chunk, n):
        raise ValueError(f"ssm_scan: N={n} with block_c={block_c}, "
                         f"time_chunk={time_chunk} exceeds the kernel's "
                         f"limits (N in {STATE_SIZES}, time_chunk in "
                         f"{TIME_CHUNKS}, block_c * N / 2 a multiple of 32 "
                         f"and <= {MAX_THREADS})")
    if b > 65_535 or any(t.data_ptr() % 8 for t in (a, bx, c, h0)):
        raise ValueError(f"ssm_scan: batch {b} > 65,535 or a pointer not "
                         "8-byte aligned (the kernel loads pairs of states)")
    y = torch.empty((b, s, d), dtype=a.dtype, device=a.device)
    hf = torch.empty_like(h0)
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = lib.ssm_scan_launch(
            a.data_ptr(), bx.data_ptr(), c.data_ptr(), h0.data_ptr(),
            y.data_ptr(), hf.data_ptr(), b, s, d, n, block_c, time_chunk,
            int(a.dtype == torch.bfloat16), stream)
    _build.check(code, lib, "ssm_scan")
    ssm_scan.launches += 1
    return y, hf


ssm_scan.launches = 0            # kernel launches since the last reset
