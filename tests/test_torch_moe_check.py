"""``models/moe_check.py``, the MoE prefill rule of ``chip_smoke.py``
phase 14, on reduced float32 Mixtral over the six draws of its seed rule,
with ``attn_core=offload`` standing in for ``hopper`` (its floor is 2 x 2
chunks: offload cannot be its own floor).  Correct attention passes on
every draw and the flips are reported (the float32 model flips no pick:
its final hidden state is rounded to bf16 before the unembedding, as in
both packages, so part 4 runs on the bf16 model, where picks flip and
its bound is reported); an off-by-one causal mask and
softmax scaled by 1.25x fail on every draw.  ``ExpertChoiceLog`` is inert
when unused: prefill, decode and served greedy streams are bit-equal to a
copy of the expert-choice routing without it (as it was before the log
existed), and replaying a run's own picks changes nothing."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.regions import (Impl, register_variant,
                                      unregister_variant, variants)
from repro_torch.models import factory as F
from repro_torch.models import layers as L
from repro_torch.models.moe import (ExpertChoiceLog, _expert_ffn,
                                    _router_logits, moe_capacity, top_k)
from repro_torch.models.moe_check import DRAWS, check_moe_prefill
from repro_torch.serving.engine import ServeEngine

CTX = 2080


def halves(q, k, v, **kw):
    return L.chunked_attention(q, k, v, q_chunk=max(q.shape[2] // 2, 1),
                               k_chunk=max(k.shape[2] // 2, 1), **kw)


def off_by_one_mask(q, k, v, **kw):
    """Each query also sees the key after it."""
    return L.chunked_attention(q, k, v, q_offset=1, **kw)


def scaled_softmax(q, k, v, **kw):
    """Softmax of 1.25x the scores."""
    return variants("attn_core")["ref"](q * 1.25, k, v, **kw)


_MODELS = {}


def _model(dtype: str):
    if dtype not in _MODELS:
        cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(),
                                  dtype=dtype)
        _MODELS[dtype] = (cfg, F.init_params(
            cfg, torch.Generator().manual_seed(3)))
    return _MODELS[dtype]


def _check(attn, length, seed):
    cfg, params = _model("float32")
    prompt, _ = F.synthetic_request(cfg, length, seed=seed)
    return check_moe_prefill(params, cfg, prompt, ctx=CTX, attn=attn,
                             floors={"halves": halves})


def test_the_draws_are_fixed_by_the_seed_rule():
    assert DRAWS == ((2060, 100), (300, 101), (9, 102), (2060, 103),
                     (300, 104), (9, 105))


@pytest.mark.parametrize("length,seed", DRAWS)
def test_correct_attention_passes_every_draw(length, seed):
    res = _check(variants("attn_core")["offload"], length, seed)
    assert res.ok, res.line()
    assert len(res.flips) == _model("float32")[0].num_layers
    assert res.kernel_tol == 2e-5 and res.kernel_err <= 2e-5
    assert res.pinned_tol >= 0.05
    assert (res.first_flip is None) == (sum(res.flips) == 0)
    assert "flips per layer" in res.line() and res.line().endswith(": PASS")


def test_flips_of_the_bf16_model_are_bounded_at_the_first_layer_that_flips():
    cfg, params = _model("bfloat16")
    results = []
    for length, seed in DRAWS:
        prompt, _ = F.synthetic_request(cfg, length, seed=seed)
        results.append(check_moe_prefill(
            params, cfg, prompt, ctx=CTX, attn=variants("attn_core")["offload"],
            floors={"halves": halves}))
    flipped = [r for r in results if sum(r.flips)]
    assert flipped, [r.line() for r in results]
    for r in results:
        assert r.kernel_tol == 2e-2 and r.kernel_err <= 2e-2
        if sum(r.flips):
            assert r.first_flip == next(i for i, f in enumerate(r.flips) if f)
            assert r.router_bound > 0 and r.router_diff is not None
            assert r.free_tol is None and f"L = {r.first_flip}" in r.line()
        else:
            assert r.first_flip is None and r.free_tol >= 0.05


@pytest.mark.parametrize("attn", [off_by_one_mask, scaled_softmax],
                         ids=["off_by_one_mask", "scaled_softmax"])
@pytest.mark.parametrize("length,seed", DRAWS)
def test_broken_attention_fails_every_draw(attn, length, seed):
    res = _check(attn, length, seed)
    assert not res.ok
    assert any("on ref's inputs" in f for f in res.failures), res.line()


def _parent_expert_choice(x, params, *, num_experts: int, k: int,
                          capacity_factor: float, group_size: int = 4096,
                          inner_impl=None):
    """``moe_expert_choice`` as it was before ``ExpertChoiceLog``."""
    t, d = x.shape
    g = max(1, t // group_size)
    while t % g:
        g -= 1
    tg = t // g
    e = num_experts
    xg = x.reshape(g, tg, d)
    probs = torch.softmax(_router_logits(xg, params["router"]), dim=-1)
    c = min(moe_capacity(tg, e, k, capacity_factor), tg)
    gate, idx = top_k(probs.transpose(1, 2), c)
    flat_idx = idx.reshape(g, e * c)
    xe = torch.gather(xg, 1, flat_idx[..., None].expand(g, e * c, d))
    xe = xe.reshape(g, e, c, d).transpose(0, 1).reshape(e, g * c, d)
    ye = _expert_ffn(xe, params["w_gate"], params["w_up"], params["w_down"])
    ye = ye.reshape(e, g, c, d).transpose(0, 1)
    ye = (ye * gate[..., None].to(ye.dtype)).to(x.dtype)
    out = torch.zeros((g, tg, d), dtype=x.dtype, device=x.device)
    for j in range(e):
        at = idx[:, j, :, None].expand(g, c, d)
        out.scatter_(1, at, out.gather(1, at) + ye[:, j])
    return out.reshape(t, d)


@pytest.fixture
def parent_routing():
    register_variant("moe_ffn", "_parent")(_parent_expert_choice)
    yield
    unregister_variant("moe_ffn", "_parent")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _prefill_and_decode(cfg, params, moe_ffn, log=None):
    impl = Impl({**F.default_impl(cfg), "moe_ffn": moe_ffn})
    prompt, _ = F.synthetic_request(cfg, 37, seed=7)
    padded = np.zeros((2, 64), np.int64)
    padded[:, :37] = prompt
    step = F.make_bucketed_prefill_step(cfg, impl=impl, ctx=80)
    if log is None:
        logits, cache = step(params, {"tokens": torch.from_numpy(padded)}, 37)
    else:
        with log.active():
            logits, cache = step(params, {"tokens": torch.from_numpy(padded)},
                                 37)
    tokens = logits.argmax(-1).reshape(2, 1)
    dec, cache = F.make_serve_step(cfg, impl=impl)(
        params, cache, tokens, torch.full((2,), 37))
    return [logits, dec, *_leaves(cache)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_the_log_unused_leaves_every_output_bit_equal(parent_routing, dtype):
    cfg, params = _model(dtype)
    got = _prefill_and_decode(cfg, params, "offload")
    want = _prefill_and_decode(cfg, params, "_parent")
    assert len(got) == len(want) > 2
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_replaying_a_runs_own_picks_changes_nothing():
    cfg, params = _model("bfloat16")
    first = ExpertChoiceLog()
    free = _prefill_and_decode(cfg, params, "offload", first)
    assert len(first.picks) == len(first.logits) == cfg.num_layers
    again = ExpertChoiceLog(replay=first.picks)
    replayed = _prefill_and_decode(cfg, params, "offload", again)
    assert all(torch.equal(a, b) for a, b in zip(free, replayed))
    assert all(torch.equal(a, b) for a, b in zip(first.picks, again.picks))


def test_served_greedy_streams_equal_the_routing_without_the_log(
        parent_routing):
    cfg, params = _model("bfloat16")
    streams = []
    for moe_ffn in ("offload", "_parent"):
        engine = ServeEngine(cfg, params, slots=2, ctx=64, seed=0,
                             impl=Impl({"moe_ffn": moe_ffn}))
        for r, n in enumerate((5, 20, 33)):
            prompt, _ = F.synthetic_request(cfg, n, seed=r)
            engine.submit(prompt, max_new_tokens=6)
        streams.append([list(req.generated)
                        for req in engine.run_to_completion()])
    assert streams[0] == streams[1] and all(len(s) == 6 for s in streams[0])
