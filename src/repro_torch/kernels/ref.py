"""Plain-PyTorch oracles for the kernels (the allclose targets).

Loop-faithful to the C originals (tdFIR, MRI-Q): the loops go through
:func:`repro_torch.core.loops.fori_loop`, so the planner's analysis sees
them as loop statements.  The ``*_loopy`` versions are NumPy loops
structured like the C code (the oracle's oracle, small sizes only).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.loops import fori_loop


# ---------------------------------------------------------------------------
# tdFIR
# ---------------------------------------------------------------------------
def fir_ref(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Causal complex FIR bank.  x: [M, N] c64; h: [M, K] c64 -> [M, N]."""
    n = x.shape[1]
    k = h.shape[1]
    xp = F.pad(x, (k - 1, 0))

    def tap(j, acc):
        # tap j multiplies x[n - j] => padded index n + k - 1 - j
        return acc + h[:, j:j + 1] * xp[:, k - 1 - j:k - 1 - j + n]

    return fori_loop(0, k, tap, torch.zeros_like(x))


def fir_ref_loopy(x: np.ndarray, h: np.ndarray) -> np.ndarray:
    """NumPy triple-loop — structured like the HPEC C code."""
    m, n = x.shape
    _, k = h.shape
    y = np.zeros((m, n), np.complex64)
    for b in range(m):                 # filter-bank loop
        for i in range(n):             # output-sample loop
            acc = 0j
            for j in range(k):         # tap loop
                if i - j >= 0:
                    acc += h[b, j] * x[b, i - j]
            y[b, i] = acc
    return y


# ---------------------------------------------------------------------------
# MRI-Q
# ---------------------------------------------------------------------------
def mriq_ref(x, y, z, kx, ky, kz, phi_mag, chunk: int = 1024):
    """Parboil MRI-Q computeQ.  Voxels x,y,z: [numX]; k-space kx,ky,kz,
    phiMag: [numK].  Returns (Q_re [numX], Q_im [numX]).  Each chunk holds
    [numX, chunk] f32 phase tiles."""
    num_k = kx.shape[0]
    chunk = min(chunk, num_k)
    pad = (-num_k) % chunk
    kxp, kyp, kzp, pmp = (F.pad(a, (0, pad)) for a in (kx, ky, kz, phi_mag))
    nc = (num_k + pad) // chunk

    def body(c, acc):
        qr, qi = acc
        s = c * chunk
        phase = 2.0 * math.pi * (torch.outer(x, kxp[s:s + chunk])
                                 + torch.outer(y, kyp[s:s + chunk])
                                 + torch.outer(z, kzp[s:s + chunk]))
        pmc = pmp[s:s + chunk]
        return qr + torch.cos(phase) @ pmc, qi + torch.sin(phase) @ pmc

    zero = torch.zeros_like(x)
    return fori_loop(0, nc, body, (zero, zero))


def mriq_ref_loopy(x, y, z, kx, ky, kz, phi_mag):
    """NumPy double-loop, structured like the Parboil C code."""
    qr = np.zeros(x.shape[0], np.float32)
    qi = np.zeros(x.shape[0], np.float32)
    for i in range(x.shape[0]):        # voxel loop
        for j in range(kx.shape[0]):   # k-space sample loop
            ph = 2.0 * np.pi * (kx[j] * x[i] + ky[j] * y[i] + kz[j] * z[i])
            qr[i] += phi_mag[j] * np.cos(ph)
            qi[i] += phi_mag[j] * np.sin(ph)
    return qr, qi


# ---------------------------------------------------------------------------
# Flash attention (causal / windowed, GQA)
# ---------------------------------------------------------------------------
def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """Dense softmax attention oracle.  q: [B,Hq,S,D], k/v: [B,Hkv,S,D]."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, s, d)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(),
                          k.float()) / math.sqrt(d)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window:
        mask = mask & (kpos > qpos - window)
    scores = torch.where(mask, scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(b, hq, s, d).to(q.dtype)


# ---------------------------------------------------------------------------
# RG-LRU / SSM scans (sequential oracles)
# ---------------------------------------------------------------------------
def rglru_scan_seq(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """Step-by-step linear recurrence h_t = a_t * h_{t-1} + b_t.
    a, b: [B, S, D]; h0: [B, D].  Returns (h_all [B, S, D], h_final)."""
    steps = []
    h = h0
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        steps.append(h)
    return torch.stack(steps, dim=1), h


def ssm_scan_seq(a: torch.Tensor, bx: torch.Tensor, c: torch.Tensor,
                 h0: torch.Tensor):
    """Step-by-step selective scan h_t = a_t * h_{t-1} + bx_t,
    y_t = h_t . c_t.  a, bx: [B, S, D, N]; c: [B, S, N]; h0: [B, D, N].
    Returns (y [B, S, D], h_final [B, D, N])."""
    ys = []
    h = h0
    for t in range(a.shape[1]):
        h = a[:, t] * h + bx[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, c[:, t]))
    return torch.stack(ys, dim=1), h


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * (1 + w) over the last dim, in float32,
    cast to x's type.  x: [..., D]; w: [D] in its own type."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)
