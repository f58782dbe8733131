"""Plain float32 reference of the served decoders: a dense GQA decoder with
a SwiGLU FFN (Mistral-NeMo) and the same with a dropless top-2 mixture of
SwiGLU experts (Mixtral).

Plain ``torch`` operations in float32 with TF32 off, no cache and no
batching: a full causal forward pass over each sequence, one layer at a
time for all the sequences, so that at full width only one layer's
weights are ever copied to float32.  It reads the benchmark's weights
(``bench/weights.py``'s layout) and nothing of the program.

The equations are the served models', which depart from the published
Mistral and Mixtral ones in two reparametrizations that the program's
decoders make for every architecture: the token embedding is scaled by
sqrt(hidden_size), and an RMSNorm multiplies by (1 + w).  With weights
drawn at random, each is a change of the draw's scale, not of the model
family.  Everything else follows the published description: RoPE on
split halves with the configuration's theta, grouped-query attention
(query head h reads key/value head h // (heads / kv_heads)) scaled by
1/sqrt(head_dim), SwiGLU (silu(x Wg) * (x Wu)) Wd, and for the experts a
softmax router whose two largest probabilities, renormalized to sum to 1,
weigh the two experts' outputs; no token is dropped.

``quant="fp8"`` computes the same with every matrix product's operands
(weights per output channel, activations per row) rounded to float8 e4m3
with an absmax scale: the control, one precision step below the served
bf16.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.counts import Dims

FP8_MAX = 448.0


def fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one absmax scale per slice along
    ``dim``, back in float32."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class _Ops:
    """The matrix products and norms, in float32 or with fp8 operands."""

    def __init__(self, quant: str | None, eps: float):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown quantization {quant!r}")
        self.quant = quant
        self.eps = eps

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A [in, out] weight in float32 (fp8: one scale per column)."""
        w = w.float()
        return fp8(w, 0) if self.quant else w

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return fp8(x, -1) if self.quant else x

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x [.., in] (float32) @ w [in, out] (already through weight())."""
        return self.act(x) @ w

    def norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        var = (x * x).mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps) * (1.0 + w.float())


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [heads, S, hd] at positions 0..S-1, split halves."""
    hd, s = x.shape[-1], x.shape[-2]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(ops: _Ops, x, w: dict, m: Dims, theta: float,
              q_block: int = 512) -> torch.Tensor:
    """Causal GQA self-attention of one sequence x [S, D] (pre-normed)."""
    s = x.shape[0]
    hd, g = m.head_dim, m.heads // m.kv_heads
    q = ops.mm(x, w["wq"]).view(s, m.heads, hd).transpose(0, 1)
    k = ops.mm(x, w["wk"]).view(s, m.kv_heads, hd).transpose(0, 1)
    v = ops.mm(x, w["wv"]).view(s, m.kv_heads, hd).transpose(0, 1)
    q, k = rope(q, theta), rope(k, theta)
    k = ops.act(k).repeat_interleave(g, dim=0)
    v = ops.act(v).repeat_interleave(g, dim=0)
    q = ops.act(q)
    out = torch.empty_like(q)
    for a in range(0, s, q_block):
        b = min(a + q_block, s)
        scores = q[:, a:b] @ k[:, :b].transpose(1, 2) / math.sqrt(hd)
        mask = (torch.arange(b, device=x.device)[None, :]
                <= torch.arange(a, b, device=x.device)[:, None])
        p = torch.softmax(scores.masked_fill(~mask, -math.inf), dim=-1)
        out[:, a:b] = ops.act(p) @ v[:, :b]
    return ops.mm(out.transpose(0, 1).reshape(s, m.heads * hd), w["wo"])


def swiglu(ops: _Ops, x, wg, wu, wd) -> torch.Tensor:
    return ops.mm(F.silu(ops.mm(x, wg)) * ops.mm(x, wu), wd)


def moe(ops: _Ops, x, w: dict, m: Dims, layer: int) -> torch.Tensor:
    """Dropless top-k mixture of SwiGLU experts over x [T, D]."""
    probs = torch.softmax(ops.mm(x, ops.weight(w["router"][layer])), dim=-1)
    top, idx = torch.topk(probs, m.experts_per_token, dim=-1)
    top = top / top.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(m.experts):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        y = swiglu(ops, x[rows], ops.weight(w["w_gate"][layer, e]),
                   ops.weight(w["w_up"][layer, e]),
                   ops.weight(w["w_down"][layer, e]))
        out.index_add_(0, rows, y * top[rows, slot][:, None])
    return out


def logits(params: dict, m: Dims, theta: float, eps: float,
           seqs: list[torch.Tensor], keep: list[int], *,
           quant: str | None = None) -> list[torch.Tensor]:
    """float32 logits of the last ``keep[i]`` positions of each sequence
    ``seqs[i]`` (1-D token ids on the weights' device): a list of
    [keep[i], vocab] tensors."""
    ops = _Ops(quant, eps)
    scale = math.sqrt(m.d_model)
    bounds = [0]
    for t in seqs:
        bounds.append(bounds[-1] + t.numel())
    # every sequence's rows in one [T, D] tensor: the FFN is per token
    h = params["embed"][torch.cat(seqs).long()].float() * scale
    st = params["stack"]["l0"]
    for layer in range(m.layers):
        aw = {k: ops.weight(st["attn"][k][layer])
              for k in ("wq", "wk", "wv", "wo")}
        x = ops.norm(h, st["attn"]["ln"][layer])
        h = h + torch.cat([attention(ops, x[a:b], aw, m, theta)
                           for a, b in zip(bounds, bounds[1:])])
        del aw, x
        f = st["ffn"]
        x = ops.norm(h, f["ln"][layer])
        if m.experts:
            h = h + moe(ops, x, f, m, layer)
        else:
            h = h + swiglu(ops, x, *(ops.weight(f[k][layer])
                                     for k in ("w_gate", "w_up", "w_down")))
        del x
    table = params["embed"].t() if m.tied else params["unembed"]
    rows = torch.cat([torch.arange(b - n, b, device=h.device)
                      for b, n in zip(bounds[1:], keep)])
    last = ops.norm(h[rows], params["final_ln"])
    full = torch.cat([ops.mm(last, ops.weight(table[:, a:a + 16384]))
                      for a in range(0, m.vocab, 16384)], dim=-1)
    return list(full.split(list(keep)))
