"""MRI-Q computeQ — wrapper of the hand-written CUDA kernel ``csrc/mriq.cu``.

For every voxel i, accumulate over k-space samples j:
    phase    = 2*pi * (kx[j]*x[i] + ky[j]*y[i] + kz[j]*z[i])
    Q_re[i] += phiMag[j] * cos(phase)
    Q_im[i] += phiMag[j] * sin(phase)

:func:`mriq_compute_q` launches the CUDA kernel on CUDA tensors and runs
:func:`mriq_compute_q_plain` on CPU or meta tensors.  On a CUDA tensor it
launches or raises; it never falls back.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

MRIQ_THREADS = 256           # voxels per block, as in csrc/mriq.cu
MRIQ_CHUNK = 1024            # k-space samples staged per pass, as in csrc/mriq.cu


def smem_bytes() -> int:
    """Static shared memory of one block: MRIQ_CHUNK float4 samples."""
    return 16 * MRIQ_CHUNK


def mriq_compute_q_plain(x, y, z, kx, ky, kz, phi_mag):
    """Plain PyTorch version: the [numX, numK] phase matrix, then its cosine
    and sine reduced against phiMag."""
    phase = 2.0 * math.pi * (torch.outer(x, kx) + torch.outer(y, ky)
                             + torch.outer(z, kz))
    return torch.cos(phase) @ phi_mag, torch.sin(phase) @ phi_mag


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("mriq")
    vp, i = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    _build.declare(lib, {
        "mriq_compute_q_launch": (i, (vp,) * 9 + (i, i, vp)),
        "mriq_compute_q_attributes": (i, (ip, ip, ip)),
        "mriq_threads": (i, ()),
        "mriq_chunk": (i, ()),
    })
    if (lib.mriq_threads(), lib.mriq_chunk()) != (MRIQ_THREADS, MRIQ_CHUNK):
        raise RuntimeError("csrc/mriq.cu and kernels/mriq.py disagree on the "
                           "launch configuration")
    return lib


def kernel_attributes() -> dict:
    """``cudaFuncGetAttributes`` of the kernel."""
    return _build.func_attributes(_lib(), "mriq_compute_q_attributes")


@_build.on_mesh
def mriq_compute_q(x, y, z, kx, ky, kz, phi_mag):
    """All inputs float32 1-D: voxels x, y, z [numX]; samples kx, ky, kz,
    phiMag [numK].  Returns (Q_re [numX], Q_im [numX])."""
    _build.refuse_grad("mriq_compute_q", "compute_q", x, y, z, kx, ky, kz,
                       phi_mag)
    args = (x, y, z, kx, ky, kz, phi_mag)
    for a in args:
        if a.dim() != 1:
            raise ValueError(f"mriq_compute_q: want 1-D inputs, got "
                             f"{tuple(a.shape)}")
        if a.dtype != torch.float32:
            raise TypeError(f"mriq_compute_q: want float32, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError("mriq_compute_q: inputs must be contiguous")
        if a.device != x.device:
            raise ValueError(f"mriq_compute_q: inputs on {a.device} and "
                             f"{x.device}")
    num_x, num_k = x.shape[0], kx.shape[0]
    if y.shape[0] != num_x or z.shape[0] != num_x or any(
            a.shape[0] != num_k for a in (ky, kz, phi_mag)):
        raise ValueError("mriq_compute_q: x, y, z must share numX and kx, ky, "
                         "kz, phi_mag must share numK")
    if x.device.type in ("cpu", "meta"):
        return mriq_compute_q_plain(*args)
    if x.device.type != "cuda":
        raise ValueError(f"mriq_compute_q: no kernel for device {x.device}")
    if num_x == 0 or num_x >= 2 ** 31 or num_k >= 2 ** 31:
        raise ValueError(f"mriq_compute_q: numX={num_x}, numK={num_k} outside "
                         "the kernel's range")
    qr = torch.empty_like(x)
    qi = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.mriq_compute_q_launch(*(a.data_ptr() for a in args),
                                         qr.data_ptr(), qi.data_ptr(),
                                         num_x, num_k, stream)
    _build.check(code, lib, "mriq_compute_q")
    mriq_compute_q.launches += 1
    return qr, qi


mriq_compute_q.launches = 0      # kernel launches since the last reset
