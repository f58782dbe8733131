"""RG-LRU diagonal linear recurrence — wrapper of the hand-written CUDA
kernel ``csrc/rglru_scan.cu``.

    h_t = a_t * h_{t-1} + b_t   (every h_t is returned)

:func:`rglru_scan` launches the kernel on CUDA tensors and runs
:func:`rglru_scan_plain`, the same function in plain PyTorch, on CPU or
meta tensors.  On a CUDA tensor it launches or raises; it never falls
back.  The kernel is a scan chunked over time: ``block_c`` channels by
``time_chunk`` steps per block (the JAX kernel's knobs, with its meaning
of ``time_chunk``: the steps one block owns).  Each chunk's carry-in is
composed, in a fixed order, from the run composites (``RUN`` chunks each)
and chunk aggregates since its group's first chunk (``GROUP`` chunks a
group), applied to that chunk's end state.  S and D need not be
multiples of either knob.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.loops import fori_loop
from repro_torch.kernels import _build

BLOCK_CS = (64, 128, 256)        # channels per block
TIME_CHUNKS = (16, 32, 64)       # time steps per block
DEFAULT_BLOCK_C = 128
DEFAULT_TIME_CHUNK = 32
GROUP = 32                       # chunks per group, W in csrc/rglru_scan.cu
RUN = 8                          # chunks per run, V in csrc/rglru_scan.cu


def smem_bytes(block_c: int, time_chunk: int, elem_size: int) -> int:
    """Shared memory of one block: the chunk's a and b (``time_chunk`` steps
    of ``block_c`` channels each, dynamic) and the chunk index its ticket
    drew (static: 16 bytes, the 16-byte alignment of the dynamic array)."""
    return 2 * time_chunk * block_c * elem_size + 16


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
    vp, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    ip = ctypes.POINTER(ctypes.c_int)
    _build.declare(lib, {
        "rglru_scan_launch": (i, (vp, vp, vp, vp, vp, i, i, i, i, i, i, vp,
                                  sz, vp)),
        "rglru_scan_scratch_bytes": (sz, (i, i, i, i, i)),
        "rglru_scan_attributes": (i, (i, i, ip, ip, ip)),
        "rglru_scan_group": (i, ()),
        "rglru_scan_run": (i, ()),
        "rglru_scan_smem_bytes": (i, (i, i, i)),
    })
    if (lib.rglru_scan_group(), lib.rglru_scan_run()) != (GROUP, RUN):
        raise RuntimeError("csrc/rglru_scan.cu and kernels/rglru_scan.py "
                           "disagree on GROUP or RUN")
    return lib


def kernel_smem_bytes(block_c: int, time_chunk: int, bf16: bool) -> int:
    """The dynamic shared memory the C entry point asks for at this tile
    (the kernel's own figure, held against :func:`smem_bytes`)."""
    return _lib().rglru_scan_smem_bytes(block_c, time_chunk, int(bf16))


def scratch(a: torch.Tensor, block_c: int, time_chunk: int) -> torch.Tensor:
    """The launch's scratch (status words, tickets, chunk aggregates, run
    composites and group end states) for a of shape [B, S, D]; the C entry
    point clears what needs clearing."""
    n = _lib().rglru_scan_scratch_bytes(*a.shape, block_c, time_chunk)
    return torch.empty(n, dtype=torch.uint8, device=a.device)


def kernel_attributes(time_chunk: int = DEFAULT_TIME_CHUNK,
                      bf16: bool = True) -> dict:
    """``cudaFuncGetAttributes`` of the instance for (time_chunk, type)."""
    return _build.func_attributes(_lib(), "rglru_scan_attributes",
                                  time_chunk, int(bf16))


@_build.on_mesh
def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor, *,
               block_c: int = DEFAULT_BLOCK_C,
               time_chunk: int = DEFAULT_TIME_CHUNK):
    """a, b: [B, S, D], both bf16 or both float32; h0: [B, D] float32; all
    contiguous.  Returns (h_all [B, S, D] in a's type, h_final [B, D]
    float32)."""
    _build.refuse_grad("rglru_scan", "rglru_scan", a, b, h0)
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
        work = scratch(a, block_c, time_chunk)
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = lib.rglru_scan_launch(
            a.data_ptr(), b.data_ptr(), h0.data_ptr(), h_all.data_ptr(),
            hf.data_ptr(), bsz, s, d, block_c, time_chunk,
            int(a.dtype == torch.bfloat16), work.data_ptr(), work.numel(),
            stream)
    _build.check(code, lib, "rglru_scan")
    rglru_scan.launches += 1
    return h_all, hf


rglru_scan.launches = 0          # kernel launches since the last reset
