"""Model architecture configs and their registry (the port's own copy).

Mirrors the JAX package's ``configs/base.py``: one frozen
:class:`ModelConfig` per architecture, registered by a module in this
package (``configs/<arch>.py``), and :meth:`ModelConfig.reduced`, the tiny
same-family config the CPU tests and the planner's measurements use.

The registry loads every architecture of the JAX package: the dense
decoders, the two recurrent families (Mamba-1 SSM and the RG-LRU /
local-attention hybrid), the Mixture-of-Experts decoders, and the two
frontends: paligemma-3b (a stub of SigLIP patch embeddings prepended to
the decoder's tokens) and whisper-small (a conv stem, an encoder and
cross-attention).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence

# ---------------------------------------------------------------------------
# Layer-pattern vocabulary for hybrid archs.
# ---------------------------------------------------------------------------
ATTN = "attn"            # global (full) attention block
LOCAL_ATTN = "local"     # sliding-window attention block
RGLRU = "rglru"          # RG-LRU recurrent block (recurrentgemma)
SSM = "ssm"              # Mamba-1 selective-state-space block


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description.  All sizes are the FULL assigned config; use
    :meth:`reduced` for CPU smoke tests."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                # expert FFN width (if != d_ff)
    dense_residual_d_ff: int = 0     # arctic: parallel dense FFN next to MoE
    capacity_factor: float = 1.25

    # --- SSM (mamba-1) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0                 # 0 -> ceil(d_model / 16)

    # --- hybrid (recurrentgemma) ---
    layer_pattern: Sequence[str] = ()   # repeating block pattern
    attn_window: int = 0             # sliding window for LOCAL_ATTN layers
    rglru_d_rnn: int = 0             # RG-LRU recurrent width (0 -> d_model)

    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0             # fixed encoder positions (whisper: 1500)
    cross_attention: bool = False

    # --- frontends (stubs per assignment) ---
    frontend: str = "none"           # none | siglip_stub | audio_stub
    frontend_seq: int = 0            # number of patch/frame embeddings provided
    frontend_dim: int = 0            # embedding dim provided by the stub
    conv_stem: bool = False          # audio frontend is a real 2-conv stem

    # --- misc knobs ---
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    source: str = ""                 # provenance tag of the published config

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def resolved_dt_rank(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def d_inner(self) -> int:
        """Mamba inner width."""
        return self.ssm_expand * self.d_model

    @property
    def n_front(self) -> int:
        """Frontend tokens prepended to the decoder sequence (siglip patch
        embeddings; audio frames feed the encoder instead, not the prefix)."""
        return self.frontend_seq if self.frontend == "siglip_stub" else 0

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def layer_kinds(self) -> list[str]:
        """Expanded per-layer block kinds for the decoder stack."""
        if self.family == "ssm":
            return [SSM] * self.num_layers
        if self.layer_pattern:
            pat = list(self.layer_pattern)
            return [pat[i % len(pat)] for i in range(self.num_layers)]
        return [ATTN] * self.num_layers

    def param_count(self) -> int:
        """Analytic parameter count, as the JAX package reckons it (the
        frontend projection and the recurrent blocks' small vectors are
        left out there too)."""
        hd = self.resolved_head_dim
        emb = self.vocab_size * self.d_model
        out = 0 if self.tie_embeddings else self.vocab_size * self.d_model
        counts = {k: 0 for k in (ATTN, LOCAL_ATTN, RGLRU, SSM)}
        for k in self.layer_kinds():
            counts[k] += 1
        n_attn = counts[ATTN] + counts[LOCAL_ATTN]
        attn_p = (self.d_model * self.num_heads * hd          # Wq
                  + 2 * self.d_model * self.num_kv_heads * hd  # Wk, Wv
                  + self.num_heads * hd * self.d_model)        # Wo
        if self.qkv_bias:
            attn_p += (self.num_heads + 2 * self.num_kv_heads) * hd
        if self.is_moe:                     # SwiGLU experts + router
            eff = self.moe_d_ff or self.d_ff
            ffn_p = self.num_experts * 3 * self.d_model * eff
            ffn_p += self.d_model * self.num_experts
            if self.dense_residual_d_ff:
                ffn_p += 3 * self.d_model * self.dense_residual_d_ff
        else:
            ffn_p = 3 * self.d_model * self.d_ff
        per_layer = ffn_p + 2 * self.d_model                # + two norms
        total = emb + out + self.d_model                    # + final norm
        total += n_attn * attn_p + self.num_layers * per_layer
        if counts[RGLRU]:
            d_rnn = self.rglru_d_rnn or self.d_model
            rg_p = (2 * self.d_model * d_rnn
                    + 2 * d_rnn * (d_rnn // 8 if d_rnn >= 8 else d_rnn)
                    + d_rnn * self.d_model + 2 * d_rnn)
            total += counts[RGLRU] * rg_p
        if counts[SSM]:
            di, st, dtr = self.d_inner, self.ssm_state, self.resolved_dt_rank
            ssm_p = (self.d_model * 2 * di + di * self.ssm_conv
                     + di * (dtr + 2 * st) + dtr * di + di * st + di
                     + di * self.d_model)
            total += counts[SSM] * ssm_p
        if self.encoder_layers:
            total += self.encoder_layers * (
                attn_p + 3 * self.d_model * self.d_ff + 2 * self.d_model)
            if self.cross_attention:
                total += n_attn * attn_p
        if self.conv_stem:
            total += (3 * self.frontend_dim * self.d_model + self.d_model
                      + 3 * self.d_model * self.d_model + self.d_model)
        return int(total)

    def active_param_count(self) -> int:
        """Parameters a token activates (MoE: only its routed experts)."""
        if not self.is_moe:
            return self.param_count()
        eff = self.moe_d_ff or self.d_ff
        per_expert = self.num_layers * 3 * self.d_model * eff
        return int(self.param_count()
                   - (self.num_experts - self.experts_per_token) * per_expert)

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        pat = tuple(self.layer_pattern[:3]) if self.layer_pattern else ()
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=min(self.num_layers, len(pat) or 2) if pat else 2,
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=16,
            d_ff=min(self.d_ff, 128),
            vocab_size=256,
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            moe_d_ff=64 if self.moe_d_ff else 0,
            dense_residual_d_ff=64 if self.dense_residual_d_ff else 0,
            ssm_state=min(self.ssm_state, 8),
            dt_rank=4 if self.family == "ssm" else 0,
            layer_pattern=pat,
            attn_window=min(self.attn_window, 32) if self.attn_window else 0,
            rglru_d_rnn=64 if self.rglru_d_rnn else 0,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 16) if self.encoder_seq else 0,
            frontend_seq=(2 * min(self.encoder_seq, 16) if self.conv_stem
                          else min(self.frontend_seq, 16)
                          if self.frontend_seq else 0),
            frontend_dim=64 if self.frontend_dim else 0,
        )


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
# the JAX registry's architectures, in its order
ARCH_IDS = (
    "recurrentgemma-2b",
    "mistral-nemo-12b",
    "phi3-medium-14b",
    "qwen2-72b",
    "deepseek-67b",
    "kimi-k2-1t-a32b",
    "arctic-480b",
    "paligemma-3b",
    "whisper-small",
    "falcon-mamba-7b",
)

# beyond the JAX package's assigned archs; loaded into the registry all
# the same
BONUS_ARCH_IDS = (
    "mixtral-8x7b",
)

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def _load_all() -> None:
    import importlib

    for arch in ARCH_IDS + BONUS_ARCH_IDS:
        importlib.import_module("repro_torch.configs." + arch.replace("-", "_"))
