"""RMSNorm — wrapper of the hand-written CUDA kernel ``csrc/rmsnorm.cu``.

    out = x * rsqrt(mean(x^2, last dim) + eps) * (1 + w)    (float32 inside)

:func:`rmsnorm` launches the kernel on CUDA tensors and runs
:func:`~repro_torch.kernels.ref.rmsnorm_plain`, the same function in plain
PyTorch, on CPU or meta tensors.  On a CUDA tensor it launches or raises;
it never falls back.  Like the JAX wrapper it flattens the leading dims
into rows; it takes them as one strided row axis and copies nothing, so
it refuses an ``x`` whose leading dims cannot be viewed as rows or whose
last dim is not contiguous.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm_plain

MAX_THREADS = 256                # threads per block (one block per row)
VPT = 4                          # 16-byte vectors a thread keeps in registers


def smem_bytes() -> int:
    """Static shared memory of one block: a float per warp, and the row's
    sum of squares."""
    return 4 * (MAX_THREADS // 32 + 1)


def threads(d: int, elem: int) -> int:
    """Threads of one row's block: ``VPT`` 16-byte vectors each, in whole
    warps, from 32 to ``MAX_THREADS``."""
    per_thread = VPT * (16 // elem)
    warps = -(-d // (32 * per_thread))
    return max(32, min(MAX_THREADS, 32 * warps))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("rmsnorm")
    vp, i = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    _build.declare(lib, {
        "rmsnorm_launch": (i, (vp, vp, vp, ctypes.c_longlong, i, i,
                               ctypes.c_float, i, i, i, vp)),
        "rmsnorm_attributes": (i, (i, i, ip, ip, ip)),
        "rmsnorm_max_threads": (i, ()),
        "rmsnorm_vectors_per_thread": (i, ()),
    })
    if (lib.rmsnorm_max_threads(), lib.rmsnorm_vectors_per_thread()) != (
            MAX_THREADS, VPT):
        raise RuntimeError("csrc/rmsnorm.cu and kernels/rmsnorm.py disagree "
                           "on the block size")
    return lib


def kernel_attributes(bf16: bool = True, w_bf16: bool = True) -> dict:
    """``cudaFuncGetAttributes`` of the instance for (x type, w type)."""
    return _build.func_attributes(_lib(), "rmsnorm_attributes", int(bf16),
                                  int(w_bf16))


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x: [..., D] bf16 or float32 with a contiguous last dim; w: [D]
    contiguous, bf16 or float32 (its own type).  Returns x's shape and
    type."""
    if x.dim() < 1 or w.dim() != 1 or w.shape[0] != x.shape[-1]:
        raise ValueError(f"rmsnorm: want x [..., D] and w [D], got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    ok = (torch.bfloat16, torch.float32)
    if x.dtype not in ok or w.dtype not in ok:
        raise TypeError(f"rmsnorm: want x and w bfloat16 or float32, got "
                        f"{x.dtype}, {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"rmsnorm: x on {x.device}, w on {w.device}")
    if x.device.type in ("cpu", "meta"):
        return rmsnorm_plain(x, w, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: no kernel for device {x.device}")
    d = x.shape[-1]
    if x.numel() == 0:
        return torch.empty_like(x)
    if x.stride(-1) != 1 or not w.is_contiguous():
        raise ValueError("rmsnorm: x's last dim and w must be contiguous")
    try:
        rows = x.view(-1, d)             # no copy: raises when impossible
    except RuntimeError as e:
        raise ValueError(f"rmsnorm: the leading dims of x (strides "
                         f"{x.stride()}) do not flatten into rows without "
                         f"a copy") from e
    n_rows, row_stride = rows.shape[0], rows.stride(0)
    if n_rows > 2**31 - 1 or row_stride > 2**31 - 1:
        raise ValueError(f"rmsnorm: {n_rows} rows of stride {row_stride}: "
                         f"more than the kernel's int32 grid and offsets")
    out = torch.empty((n_rows, d), dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.rmsnorm_launch(
            rows.data_ptr(), w.data_ptr(), out.data_ptr(), n_rows, d,
            row_stride, float(eps), int(x.dtype == torch.bfloat16),
            int(w.dtype == torch.bfloat16),
            threads(d, x.element_size()), stream)
    _build.check(code, lib, "rmsnorm")
    rmsnorm.launches += 1
    return out.view(x.shape)


rmsnorm.launches = 0             # kernel launches since the last reset
