"""Block-level OffloadableProgram over an LM architecture — the port of the
JAX package's ``models/offload_program.py``.

The planner plans over the model's block-level regions (``attn_core``,
``moe_dispatch``, ``mlp_gelu`` or ``mlp_core``, ``conv_stem``,
``ssm_scan``, ``rglru_scan``), whose
ref/offload/hopper variants are the ones the model dispatches through, so
the selected pattern IS the model's deploy configuration.  As in the JAX
package, the regions' analysis arguments
are the FULL architecture's per-layer tensors (meta tensors, s = 4096),
while Step 4 measures ``forward`` on ``cfg.reduced()`` at ``batch`` x
``seq`` — so the measured speedups are those of the reduced model.  A
frontend arch's sample also holds its reduced ``patches`` or ``frames``,
which ``build`` feeds to the forward.  (The JAX program feeds the tokens
alone, and whisper's encoder then fails on the missing frames, so every
JAX pattern of whisper-small fails; the port measures the model.)
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import get_config
from repro_torch.core.device import resolve_device
from repro_torch.core.program import OffloadableProgram, Region, meta
from repro_torch.core.regions import Impl, variants
from repro_torch.models import factory as F
from repro_torch.models.moe import moe_capacity
from repro_torch.models.params import tree_map

ANALYSIS_SEQ = 4096      # the sequence length the regions are analysed at


def make_lm_program(arch: str, batch: int = 2, seq: int = 128,
                    device=None,
                    plan_extra: dict | None = None) -> OffloadableProgram:
    """Block-level program for ``arch`` on ``device`` (default ``cuda``).
    ``batch``/``seq`` are measurement conditions: they enter the plan and
    measurement keys (``cache_extra``).  ``plan_extra`` carries plan-key-only
    regime conditions (``core.planner.conditions_from_stats``), so an online
    replan under a new serving regime re-opens the search while staying
    ledger-primed by every sibling regime's measurements."""
    dev = resolve_device(device)
    cfg = get_config(arch).reduced()
    params_box: list = []          # lazy: a plan-cache hit never builds

    def params():
        if not params_box:
            params_box.append(F.init_params(
                cfg, torch.Generator(device=dev).manual_seed(0)))
        return params_box[0]

    key = F.frontend_key(cfg)

    def build(impl: Impl):
        merged = Impl({**F.default_impl(cfg), **impl})

        def run(tokens, frontend=None):
            p = params()
            if tokens.is_meta:          # the planner's counting pass
                p = tree_map(lambda t: torch.empty_like(t, device="meta"), p)
            batch = {"tokens": tokens}
            if frontend is not None:
                batch[key] = frontend
            return F.make_forward(cfg, impl=merged)(p, batch)
        return run

    # region analysis shapes: the FULL arch's per-layer tensors (the planner
    # reasons about production sizes; measurement runs the reduced model)
    full = get_config(arch)
    hd = full.resolved_head_dim
    bf16 = torch.bfloat16
    regions = []
    if full.num_heads:
        q = meta((1, full.num_heads, ANALYSIS_SEQ, hd), bf16)
        kv = meta((1, max(full.num_kv_heads, 1), ANALYSIS_SEQ, hd), bf16)
        regions.append(Region("attn_core", variants("attn_core")["ref"],
                              (q, kv, kv)))
    if full.is_moe:
        # the routed expert MLP is a moe_dispatch block (top-k gate and
        # capacity-bounded one-hot routing), not an mlp_core.  As in JAX,
        # the measured forward merges default_impl's moe_ffn=offload
        # (expert choice), which never reaches moe_dispatch
        e, f = full.num_experts, full.moe_d_ff or full.d_ff
        cap = moe_capacity(ANALYSIS_SEQ, e, full.experts_per_token,
                           full.capacity_factor)
        x = meta((ANALYSIS_SEQ, full.d_model), bf16)
        wr = meta((full.d_model, e), bf16)
        we = meta((e, full.d_model, f), bf16)
        wd = meta((e, f, full.d_model), bf16)
        regions.append(Region("moe_dispatch", variants("moe_dispatch")["ref"],
                              (x, wr, we, we, wd),
                              static_kwargs={"num_experts": e,
                                             "k": full.experts_per_token,
                                             "capacity": cap}))
    elif full.d_ff and full.family == "audio":
        # audio archs run a gelu MLP (dot -> gelu -> dot), not swiglu
        x = meta((ANALYSIS_SEQ, full.d_model), bf16)
        wu = meta((full.d_model, full.d_ff), bf16)
        bu = meta((full.d_ff,), bf16)
        wd = meta((full.d_ff, full.d_model), bf16)
        bd = meta((full.d_model,), bf16)
        regions.append(Region("mlp_gelu", variants("mlp_gelu")["ref"],
                              (x, wu, bu, wd, bd), deploy_variant="offload"))
    elif full.d_ff:
        x = meta((ANALYSIS_SEQ, full.d_model), bf16)
        wg = meta((full.d_model, full.d_ff), bf16)
        wd = meta((full.d_ff, full.d_model), bf16)
        regions.append(Region("mlp_core", variants("mlp_core")["ref"],
                              (x, wg, wg, wd), deploy_variant="offload"))
    if full.conv_stem:
        xa = meta((1, full.frontend_seq, full.frontend_dim), bf16)
        wc = meta((3, full.frontend_dim, full.d_model), bf16)
        bc = meta((full.d_model,), bf16)
        regions.append(Region("conv_stem", variants("conv_stem")["ref"],
                              (xa, wc, bc), deploy_variant="offload",
                              static_kwargs={"stride": 1}))
    if full.family == "ssm":
        di, n = full.d_inner, full.ssm_state
        a = meta((1, ANALYSIS_SEQ, di, n), bf16)
        c = meta((1, ANALYSIS_SEQ, n), bf16)
        h0 = meta((1, di, n), torch.float32)
        regions.append(Region("ssm_scan", variants("ssm_scan")["ref"],
                              (a, a, c, h0), measure_variant="seq"))
    if full.family == "hybrid":
        dr = full.rglru_d_rnn or full.d_model
        a = meta((1, ANALYSIS_SEQ, dr), bf16)
        h0 = meta((1, dr), torch.float32)
        regions.append(Region("rglru_scan", variants("rglru_scan")["ref"],
                              (a, a, h0)))

    def sample(seed: int, device: torch.device):
        g = torch.Generator().manual_seed(seed)
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=g,
                               dtype=torch.int64).to(device)
        if key is None:
            return (tokens,)
        frontend = torch.randn((batch, cfg.frontend_seq, cfg.frontend_dim),
                               generator=g).to(torch.bfloat16)
        return tokens, frontend.to(device)

    return OffloadableProgram(
        name=f"lm:{arch}", regions=regions, build=build, sample_inputs=sample,
        device=dev, source_loop_count=full.num_layers,
        description="block-level offload planning over an assigned arch",
        # batch/seq change every Step-4 timing but not the abstract region
        # args, so they must be part of the plan-cache key
        cache_extra={"batch": batch, "seq": seq},
        plan_extra=dict(plan_extra or {}))
