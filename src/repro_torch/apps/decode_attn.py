"""Single-region decode-attention program — the port of the program that
the JAX package's ``benchmarks/autotune.py`` plans (``make_decode_program``;
``launch/autotune.py`` is the port's twin of that benchmark).

One query step against a [B, Hkv, S, D] KV cache (GQA 8:2), every slot
valid.  The ``ref`` variant is the dense masked-softmax oracle registered
in ``kernels/ops.py``; ``hopper`` is the hand-written CUDA kernel, which
streams the cache in ``block_k`` tiles — the knob its TuningSpace exposes.
"""
from __future__ import annotations

import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.program import OffloadableProgram, Region, meta
from repro_torch.core.regions import dispatch, variants
from repro_torch.kernels import ops as _ops  # noqa: F401 (registers decode_attn)

DECODE = dict(b=2, hq=8, hkv=2, s=512, d=64)


def make_decode_program(device=None) -> OffloadableProgram:
    """The decode-attention program on ``device`` (default ``cuda``), at the
    JAX package's shapes, float32."""
    b, hq, hkv, s, d = (DECODE[k] for k in ("b", "hq", "hkv", "s", "d"))
    f32 = torch.float32
    q_abs = meta((b, hq, 1, d), f32)
    kv_abs = meta((b, hkv, s, d), f32)
    sp_abs = meta((b, s), torch.int32)
    cp_abs = meta((b,), torch.int32)

    def build(impl):
        def run(q, k, v, sp, cp):
            return dispatch("decode_attn", impl, q, k, v, sp, cp)
        return run

    def sample(seed: int, device: torch.device):
        g = torch.Generator().manual_seed(seed)
        q = torch.randn((b, hq, 1, d), generator=g)
        k = torch.randn((b, hkv, s, d), generator=g)
        v = torch.randn((b, hkv, s, d), generator=g)
        sp = torch.arange(s, dtype=torch.int32).expand(b, s).contiguous()
        cp = torch.full((b,), s - 1, dtype=torch.int32)
        return tuple(t.to(device) for t in (q, k, v, sp, cp))

    regions = [Region("decode_attn", variants("decode_attn")["ref"],
                      (q_abs, kv_abs, kv_abs, sp_abs, cp_abs),
                      measure_variant="hopper")]
    return OffloadableProgram(
        name="decode-attn-bench", regions=regions, build=build,
        sample_inputs=sample, device=resolve_device(device),
        source_loop_count=1,
        description="decode attention against a full KV cache (autotune)")
