"""The benchmark's weights: drawn from the run's seed, on the device, in
the type they are served in, in a few large calls.

One flat bf16 buffer holds every leaf; it is filled with standard normals
by one ``torch.randn`` call a chunk of ``CHUNK`` elements from a
``torch.Generator`` on the device, and each leaf, a view of the buffer,
is then scaled to its standard deviation.  The same seed gives the same
weights on the same device.

The tree is laid out as the served decoders are (per-layer leaves stacked
along a leading layer axis): the program and the plain reference are
handed the same tensors, and each reads them by this layout.
"""
from __future__ import annotations

import math

import torch

from bench.counts import Dims

CHUNK = 1 << 30
NORM_STD = 0.1          # norm weights w (the decoders scale by 1 + w)


def layout(m: Dims) -> dict:
    """name path -> (shape, std) of every leaf."""
    d, hd = m.d_model, m.head_dim
    q, kv = m.heads * hd, m.kv_heads * hd
    L, f = m.layers, m.d_ff
    out = {
        ("embed",): ((m.vocab, d), 1.0 / math.sqrt(d)),
        ("final_ln",): ((d,), NORM_STD),
        ("stack", "l0", "attn", "ln"): ((L, d), NORM_STD),
        ("stack", "l0", "attn", "wq"): ((L, d, q), 1.0 / math.sqrt(d)),
        ("stack", "l0", "attn", "wk"): ((L, d, kv), 1.0 / math.sqrt(d)),
        ("stack", "l0", "attn", "wv"): ((L, d, kv), 1.0 / math.sqrt(d)),
        ("stack", "l0", "attn", "wo"): ((L, q, d), 1.0 / math.sqrt(q)),
        ("stack", "l0", "ffn", "ln"): ((L, d), NORM_STD),
    }
    if not m.tied:
        out[("unembed",)] = ((d, m.vocab), 1.0 / math.sqrt(d))
    e = (m.experts,) if m.experts else ()
    if m.experts:
        out[("stack", "l0", "ffn", "router")] = ((L, d, m.experts),
                                                  1.0 / math.sqrt(d))
    out[("stack", "l0", "ffn", "w_gate")] = ((L, *e, d, f), 1.0 / math.sqrt(d))
    out[("stack", "l0", "ffn", "w_up")] = ((L, *e, d, f), 1.0 / math.sqrt(d))
    out[("stack", "l0", "ffn", "w_down")] = ((L, *e, f, d), 1.0 / math.sqrt(f))
    return out


def draw(m: Dims, seed: int, device, out: dict | None = None) -> dict:
    """The weights of ``seed`` as a nested dict of bf16 views of one buffer
    on ``device``; with ``out`` (an earlier draw of the same layout) the
    new values are written into its storage instead, so that whatever holds
    those tensors sees the new weights."""
    lay = layout(m)
    total = sum(math.prod(shape) for shape, _ in lay.values())
    if out is None:
        buf = torch.empty(total, dtype=torch.bfloat16, device=device)
    else:
        buf = out["_buffer"]
    gen = torch.Generator(device=buf.device).manual_seed(int(seed))
    for a in range(0, total, CHUNK):
        b = min(a + CHUNK, total)
        buf[a:b] = torch.randn(b - a, generator=gen, device=buf.device,
                               dtype=torch.bfloat16)
    tree: dict = {}
    off = 0
    for path, (shape, std) in lay.items():
        n = math.prod(shape)
        leaf = buf[off:off + n].view(shape)
        leaf.mul_(std)
        off += n
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    tree["_buffer"] = buf
    return tree


def params(tree: dict) -> dict:
    """The tree without its buffer entry: the program's parameters."""
    return {k: v for k, v in tree.items() if k != "_buffer"}


def nbytes(tree: dict) -> int:
    buf = tree["_buffer"]
    return buf.numel() * buf.element_size()
