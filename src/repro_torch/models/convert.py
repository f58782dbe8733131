"""The weight carrier between the two packages.

The port's parameter and cache trees have the JAX package's structure
(nested dicts, per-layer leaves stacked along a leading ``layers`` axis),
so a JAX tree whose leaves are NumPy arrays converts leaf for leaf.  The
tests use this to make both packages compute the same thing: the JAX and
torch generators draw different numbers from one seed.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.params import tree_map


def _leaf(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # NumPy's bfloat16 (ml_dtypes) has no torch counterpart in
        # from_numpy: carry the bits over as int16 and reinterpret them
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.tensor(a, device=device)       # copies


def params_from_numpy(tree, device=None):
    """The port's tree of tensors on ``device`` (default ``cuda``) from a
    tree of NumPy arrays (bf16 leaves as NumPy's ``bfloat16``).  A JAX
    cache tree converts the same way into the port's cache, a JAX train
    state (params, AdamW moments, 0-d ``count`` and ``step``) into the
    port's train state, and a quantized tree (``{"q", "scale"}`` leaves)
    into the port's."""
    dev = resolve_device(device)
    return tree_map(lambda a: _leaf(a, dev), tree)
