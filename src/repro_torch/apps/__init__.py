"""The paper's two evaluation applications, and :func:`from_numpy`, which
turns a program's sample arrays (as NumPy, e.g. the JAX package's samples)
into the port's input tuple."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device

# each program's positional inputs, by dtype
_INPUTS = {
    "tdfir": (np.complex64,) * 2,                 # x [M, N], h [M, K]
    "mriq": (np.float32,) * 8,                    # x, y, z, kx, ky, kz, phi_r, phi_i
}


def from_numpy(program_name: str, arrays, device=None) -> tuple:
    """The input tuple of ``program_name`` on ``device`` (default ``cuda``)
    from NumPy arrays, checked for count and dtype."""
    try:
        dtypes = _INPUTS[program_name]
    except KeyError:
        raise ValueError(f"unknown program {program_name!r}; "
                         f"have {sorted(_INPUTS)}") from None
    arrays = [np.asarray(a) for a in arrays]
    if len(arrays) != len(dtypes) or any(
            a.dtype != d for a, d in zip(arrays, dtypes)):
        raise ValueError(f"{program_name} takes {len(dtypes)} arrays of dtype "
                         f"{[np.dtype(d).name for d in dtypes]}, got "
                         f"{[a.dtype.name for a in arrays]}")
    dev = resolve_device(device)
    return tuple(torch.tensor(a, device=dev) for a in arrays)   # copies
