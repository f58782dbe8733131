"""RG-LRU diagonal linear recurrence — wrapper of the hand-written CUDA
kernel ``csrc/rglru_scan.cu``.

    h_t = a_t * h_{t-1} + b_t   (every h_t is returned)

:func:`rglru_scan` launches the kernel on CUDA tensors and runs
:func:`rglru_scan_plain`, the same function in plain PyTorch, on CPU or
meta tensors.  On a CUDA tensor it launches or raises; it never falls
back.  ``block_c`` (threads per block, one channel each) and
``time_chunk`` (time steps whose loads are issued together) are the
kernel's tile sizes; S and D need not be multiples of either.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.loops import fori_loop
from repro_torch.kernels import _build

BLOCK_CS = (64, 128, 256)        # channels (threads) per block
TIME_CHUNKS = (8, 16, 32)        # time steps per chunk
DEFAULT_BLOCK_C = 128
DEFAULT_TIME_CHUNK = 16


def rglru_scan_plain(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """Plain PyTorch version with the kernel's precision: h float32, h_all
    stored in a's type, h_final float32."""
    h = h0.float()
    h_all = torch.empty_like(a)

    def step(t, h):
        h = a[:, t].float() * h + b[:, t].float()
        h_all[:, t] = h
        return h

    return h_all, fori_loop(0, a.shape[1], step, h)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("rglru_scan")
    vp, i = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    _build.declare(lib, {
        "rglru_scan_launch": (i, (vp, vp, vp, vp, vp, i, i, i, i, i, i, vp)),
        "rglru_scan_attributes": (i, (i, i, ip, ip, ip)),
    })
    return lib


def kernel_attributes(time_chunk: int = DEFAULT_TIME_CHUNK,
                      bf16: bool = True) -> dict:
    """``cudaFuncGetAttributes`` of the instance for (time_chunk, type)."""
    return _build.func_attributes(_lib(), "rglru_scan_attributes",
                                  time_chunk, int(bf16))


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor, *,
               block_c: int = DEFAULT_BLOCK_C,
               time_chunk: int = DEFAULT_TIME_CHUNK):
    """a, b: [B, S, D], both bf16 or both float32; h0: [B, D] float32; all
    contiguous.  Returns (h_all [B, S, D] in a's type, h_final [B, D]
    float32)."""
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"rglru_scan: want a, b [B, S, D], got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    bsz, s, d = a.shape
    if tuple(h0.shape) != (bsz, d):
        raise ValueError(f"rglru_scan: h0 {tuple(h0.shape)} does not fit a "
                         f"{tuple(a.shape)}")
    if a.dtype not in (torch.bfloat16, torch.float32) or a.dtype != b.dtype \
            or h0.dtype != torch.float32:
        raise TypeError(f"rglru_scan: want a, b both bfloat16 or both float32 "
                        f"and h0 float32, got {a.dtype}, {b.dtype}, "
                        f"{h0.dtype}")
    if not all(t.is_contiguous() for t in (a, b, h0)):
        raise ValueError("rglru_scan: a, b and h0 must be contiguous")
    if not (a.device == b.device == h0.device):
        raise ValueError(f"rglru_scan: a on {a.device}, b on {b.device}, h0 "
                         f"on {h0.device}")
    if a.numel() == 0:
        raise ValueError("rglru_scan: empty input")
    if a.device.type in ("cpu", "meta"):
        return rglru_scan_plain(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan: no kernel for device {a.device}")
    if block_c not in BLOCK_CS or time_chunk not in TIME_CHUNKS:
        raise ValueError(f"rglru_scan: block_c={block_c} / time_chunk="
                         f"{time_chunk} not in {BLOCK_CS} / {TIME_CHUNKS}")
    if bsz > 65_535:
        raise ValueError(f"rglru_scan: batch {bsz} > 65,535")
    h_all = torch.empty_like(a)
    hf = torch.empty_like(h0)
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = lib.rglru_scan_launch(
            a.data_ptr(), b.data_ptr(), h0.data_ptr(), h_all.data_ptr(),
            hf.data_ptr(), bsz, s, d, block_c, time_chunk,
            int(a.dtype == torch.bfloat16), stream)
    _build.check(code, lib, "rglru_scan")
    rglru_scan.launches += 1
    return h_all, hf


rglru_scan.launches = 0          # kernel launches since the last reset
