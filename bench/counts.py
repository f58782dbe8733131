"""The yardstick: operations and bytes from shapes, and the card's peaks.

Everything here depends on the model's published sizes and on the shapes
of the work (prompt lengths, positions attended, buckets), never on which
variant of the program ran, so a later change to the program cannot move
it.  The peaks are NVIDIA's H100 SXM data sheet, dense rates without
sparsity, at the full 700 W power limit (copied from the port's
``launch/constants.py``; the copy here is the one the benchmark reads).

Model FLOPs count the needed work only: 2 x the parameters a token
touches (for a mixture of experts, its ``k`` routed experts and the
router), the unembedding where a logit row is needed (every decoded
token; the last real position of a prompt), and causal attention over
the positions each token really attends.  Padding to buckets, attention
over unused cache slots and expert capacity rows are not work.
"""
from __future__ import annotations

from dataclasses import dataclass

PEAK_BF16_FLOPS = 989e12        # tensor cores, dense bf16 flop/s
HBM_BYTES_PER_S = 3.35e12       # HBM3
SFU_OPS_PER_S = 67e12 / 16      # exps: 1/16 of the FP32 flop rate
BF16_BYTES = 2


@dataclass(frozen=True)
class Dims:
    """The sizes the counts need, read from a configuration file."""
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    experts: int = 0            # 0: a dense FFN
    experts_per_token: int = 0
    tied: bool = False

    @classmethod
    def from_config(cls, c: dict) -> "Dims":
        heads = c["num_attention_heads"]
        return cls(layers=c["num_hidden_layers"], d_model=c["hidden_size"],
                   heads=heads, kv_heads=c["num_key_value_heads"],
                   head_dim=c.get("head_dim") or c["hidden_size"] // heads,
                   d_ff=c["intermediate_size"], vocab=c["vocab_size"],
                   experts=c.get("num_local_experts", 0),
                   experts_per_token=c.get("num_experts_per_tok", 0),
                   tied=bool(c.get("tie_word_embeddings", False)))


def attn_params(m: Dims) -> int:
    """Wq, Wk, Wv, Wo of one layer."""
    return m.d_model * m.head_dim * (2 * m.heads + 2 * m.kv_heads)


def expert_params(m: Dims) -> int:
    """One SwiGLU FFN (a dense layer's, or one expert's)."""
    return 3 * m.d_model * m.d_ff


def ffn_active_params(m: Dims) -> int:
    """FFN parameters one token touches in one layer."""
    if m.experts:
        return (m.experts_per_token * expert_params(m)
                + m.d_model * m.experts)                 # + the router
    return expert_params(m)


def layer_active_params(m: Dims) -> int:
    return attn_params(m) + ffn_active_params(m)


def unembed_flops(m: Dims) -> int:
    return 2 * m.d_model * m.vocab


def attention_flops(m: Dims, attended: int) -> int:
    """QK^T and P.V of one token attending ``attended`` positions, every
    layer."""
    return m.layers * 4 * m.heads * m.head_dim * attended


def prefill_flops(m: Dims, n: int) -> int:
    """Needed work of prefilling an ``n``-token prompt: every token through
    every layer, token i attending i + 1 positions, one logit row."""
    return (2 * m.layers * layer_active_params(m) * n
            + attention_flops(m, n * (n + 1) // 2) + unembed_flops(m))


def decode_flops(m: Dims, attended: int) -> int:
    """Needed work of one decoded token attending ``attended`` positions
    (its own included)."""
    return (2 * m.layers * layer_active_params(m)
            + attention_flops(m, attended) + unembed_flops(m))


def kv_bytes_per_position(m: Dims) -> int:
    return m.layers * 2 * m.kv_heads * m.head_dim * BF16_BYTES


def experts_touched(m: Dims, tokens: int) -> float:
    """Experts of one layer that ``tokens`` tokens route to, expected under
    uniform top-k routing: E (1 - (1 - k/E)^T)."""
    if not m.experts:
        return 0.0
    miss = (1.0 - m.experts_per_token / m.experts) ** tokens
    return m.experts * (1.0 - miss)


def decode_weight_bytes(m: Dims, batch: int) -> float:
    """Weights one decode step of ``batch`` tokens reads once: every layer's
    attention and norms, the FFN (for a mixture of experts, the router and
    the experts the batch touches), the final norm, the unembedding, and
    the batch's embedding rows."""
    d = m.d_model
    per_layer = attn_params(m) + 2 * d
    if m.experts:
        per_layer += d * m.experts + experts_touched(m, batch) * expert_params(m)
    else:
        per_layer += expert_params(m)
    head = d * m.vocab + d + batch * d
    return BF16_BYTES * (m.layers * per_layer + head)


def decode_bound_s(m: Dims, attended: list[int]) -> float:
    """Least time of one decode step whose slots attend ``attended``
    positions each: the larger of its bytes (every weight once, the live
    KV positions once) over the HBM rate and its FLOPs over the bf16
    peak."""
    batch = len(attended)
    live = sum(attended)
    t_bytes = (decode_weight_bytes(m, batch)
               + kv_bytes_per_position(m) * live) / HBM_BYTES_PER_S
    t_ops = sum(decode_flops(m, a) for a in attended) / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops)


def attention_pairs(s: int, causal: bool) -> int:
    """(query, key) pairs one head of S x S attention admits."""
    return s * (s + 1) // 2 if causal else s * s


def flash_call_bound_s(m: Dims, s: int, causal: bool = True,
                       batch: int = 1) -> float:
    """Least time of one prefill attention call at the shapes it was made
    with ([batch, heads/kv_heads, s, head_dim], bf16): q, k, v read once,
    o written once; per admitted pair 4 * head_dim FLOPs at the bf16 peak
    and one exp on the special-function units."""
    pairs = batch * m.heads * attention_pairs(s, causal)
    t_ops = max(4.0 * m.head_dim * pairs / PEAK_BF16_FLOPS,
                pairs / SFU_OPS_PER_S)
    t_bytes = BF16_BYTES * batch * s * m.head_dim * (
        2 * m.heads + 2 * m.kv_heads) / HBM_BYTES_PER_S
    return max(t_ops, t_bytes)
