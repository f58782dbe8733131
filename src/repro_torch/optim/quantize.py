"""int8 weight-only quantization for serving — the port of the JAX
package's ``optim/quantize.py``.

Per-output-channel symmetric int8: W[..., out] -> q int8 + scale
float32[out], the scale taken over **every axis but the last**, as in
JAX, so a leaf stacked along ``layers`` ([L, ..., out]) gets one scale per
output channel shared by all L layers.  Only matrix-shaped leaves (ndim
>= 2) of a floating type quantize; norms, biases and scalars keep their
type.  The quantized tree mirrors the parameter tree with each quantized
leaf replaced by ``{"q": int8, "scale": float32}``.

The JAX serve step dequantizes the whole tree at its top and XLA fuses the
convert into the consuming product.  The port dequantizes where each
weight is used instead (``models/lm.py::_layer``: a stacked leaf one
layer at a time), with the same values, so the bf16 tree is never whole
on the card (:func:`init_quantized` draws a quantized model the same way).

Stacked leaves are reduced and quantized one leading-dim slice at a time,
so the float32 scratch stays the size of one layer.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models import params as P
from repro_torch.models.params import DTYPES, ParamSpec, tree_leaves, tree_map

_FLOATS = ("bfloat16", "float32", "float16")


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _should_quantize(spec_or_leaf) -> bool:
    shape = getattr(spec_or_leaf, "shape", None)
    if shape is None or len(shape) < 2:
        return False
    return _dtype_name(getattr(spec_or_leaf, "dtype", "")) in _FLOATS


def is_quantized(x) -> bool:
    """Whether ``x`` is a quantized leaf ``{"q", "scale"}``."""
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def _amax(part: torch.Tensor) -> torch.Tensor:
    """float32 max of |part| over every axis but the last."""
    return part.float().abs().amax(dim=tuple(range(part.dim() - 1)))


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return amax.clamp_min(1e-12) / 127.0


def _q(part: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.round(part.float() / scale).clamp_(-127, 127).to(torch.int8)


def quantize_leaf(w: torch.Tensor) -> dict:
    parts = P.leading_slices(w)
    amax = _amax(parts[0])
    for part in parts[1:]:
        amax = torch.maximum(amax, _amax(part))
    scale = _scale(amax)                                       # [out]
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    for dst, part in zip(P.leading_slices(q), parts):
        dst.copy_(_q(part, scale))
    return {"q": q, "scale": scale}


def dequantize_leaf(qd: dict, dtype) -> torch.Tensor:
    """``q * scale`` in float32 (int8 times float32 promotes), rounded to
    ``dtype`` (a torch dtype or its name) as each product is stored: one
    elementwise pass, no float32 copy of the leaf."""
    dt = DTYPES[dtype] if isinstance(dtype, str) else dtype
    out = torch.empty(qd["q"].shape, dtype=dt, device=qd["q"].device)
    return torch.mul(qd["q"], qd["scale"], out=out)


def quantize_params(params):
    """Real-tensor quantization (the serving deploy path)."""
    return tree_map(lambda leaf: quantize_leaf(leaf) if _should_quantize(leaf)
                    else leaf, params)


def dequantize_params(qparams, ref_dtypes=None, default_dtype=torch.bfloat16):
    """Every quantized leaf of ``qparams`` dequantized to
    ``default_dtype``; ``ref_dtypes`` is unused, as in JAX."""
    if is_quantized(qparams):
        return dequantize_leaf(qparams, default_dtype)
    if isinstance(qparams, dict):
        return {k: dequantize_params(v, default_dtype=default_dtype)
                for k, v in qparams.items()}
    return qparams


def quantized_template(template):
    """ParamSpec tree -> quantized ParamSpec tree."""
    def one(spec: ParamSpec):
        if _should_quantize(spec):
            return {
                "q": dataclasses.replace(spec, dtype="int8", init="zeros"),
                "scale": ParamSpec((spec.shape[-1],), (spec.axes[-1],),
                                   "ones", dtype="float32"),
            }
        return spec
    return tree_map(one, template)


def quantized_bytes(template) -> tuple[int, int]:
    """(original_bytes, quantized_bytes) for a ParamSpec template."""
    orig = quant = 0
    for spec in tree_leaves(template):
        n = math.prod(spec.shape)
        size = DTYPES[spec.dtype].itemsize
        orig += n * size
        if _should_quantize(spec):
            quant += n * 1 + spec.shape[-1] * 4
        else:
            quant += n * size
    return orig, quant


def init_quantized(template, generator: torch.Generator):
    """``quantize_params(P.init(template, generator))`` without the whole
    unquantized tree: each quantizable ``normal``/``scaled`` leaf is drawn
    one layer slice at a time twice from the same generator state, first
    for the max that every slice's scale needs, then to quantize each
    slice, so no unquantized stacked leaf is ever whole.  Equal to the
    two-step form value for value."""
    def one(s: ParamSpec):
        if not _should_quantize(s) or P.normal_factor(s) is None:
            leaf = P.materialize(s, generator)
            return quantize_leaf(leaf) if _should_quantize(s) else leaf
        start = generator.get_state()
        amax = None
        for part in P.normal_draws(s, generator):
            m = _amax(part)
            amax = m if amax is None else torch.maximum(amax, m)
        generator.set_state(start)
        scale = _scale(amax)
        q = torch.empty(s.shape, dtype=torch.int8, device=generator.device)
        for dst, part in zip(P.leading_slices(q), P.normal_draws(s, generator)):
            dst.copy_(_q(part, scale))
        return {"q": q, "scale": scale}
    return tree_map(one, template)
