"""The plain reference against the port's served path on the same weights,
at a size the CPU runs: prefill, then decode through the cache; and the
Mixtral configuration's routing (token choice at capacity factor E/k
through scatter slots) against plain dropless top-2."""
import json

import numpy as np
import pytest
import torch

from bench import check, counts, weights
from bench import model as M
from bench.reference import decoder
from bench.tests.conftest import DATA

from repro_torch.core.regions import Impl
from repro_torch.models import factory as F
from repro_torch.models.moe import moe_capacity, moe_token_onehot


def _config(name: str) -> dict:
    return json.loads((DATA / f"{name}.json").read_text())


def _served_logits(cfg, params, impl, tokens: np.ndarray, n_prompt: int,
                   ctx: int) -> torch.Tensor:
    """The port's logits predicting tokens ``n_prompt`` .. end: a bucketed
    prefill of the first ``n_prompt`` tokens, then one decode step a token
    through the cache it wrote."""
    bucket = F.prefill_bucket(n_prompt, ctx)
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :n_prompt] = tokens[:n_prompt]
    prefill = F.make_bucketed_prefill_step(cfg, impl=impl, ctx=ctx)
    logits, cache = prefill(params, {"tokens": torch.from_numpy(padded)},
                            n_prompt)
    rows = [logits[0, -1].float()]
    step = F.make_serve_step(cfg, impl=impl)
    for pos in range(n_prompt, tokens.size - 1):
        tok = torch.tensor([[tokens[pos]]], dtype=torch.int32)
        logits, cache = step(params, cache, tok,
                             torch.tensor([pos], dtype=torch.int32))
        rows.append(logits[0, -1].float())
    return torch.stack(rows)


@pytest.mark.parametrize("name", ["tiny", "tinymoe"])
def test_reference_agrees_with_the_served_path(name):
    config = _config(name)
    m = counts.Dims.from_config(config)
    cfg = M.port_config(config)
    params = weights.params(weights.draw(m, 1234, "cpu"))
    M.check_layout(cfg, params)
    impl = Impl({**F.default_impl(cfg), **config["pattern"]})
    rng = np.random.default_rng(5)
    worst = 0.0
    for n_prompt, n_total in ((5, 12), (17, 30), (31, 40)):
        tokens = rng.integers(0, m.vocab, n_total).astype(np.int32)
        got = _served_logits(cfg, params, impl, tokens, n_prompt, 64)
        want = decoder.logits(params, m, config["rope_theta"],
                              config["rms_norm_eps"],
                              [torch.from_numpy(tokens[:-1])],
                              [n_total - n_prompt])[0]
        assert got.shape == want.shape
        # the program rounds its activations to bf16 (8 bits of mantissa)
        # between operations; logits are O(1)
        worst = max(worst, float((got - want).abs().max()))
    assert worst < 0.1, worst
    # a wrong position or cache moves logits by O(1): shift the prompt by
    # one position and the same comparison fails
    tokens = rng.integers(0, m.vocab, 20).astype(np.int32)
    got = _served_logits(cfg, params, impl, tokens, 8, 64)
    want = decoder.logits(params, m, config["rope_theta"],
                          config["rms_norm_eps"],
                          [torch.from_numpy(tokens[1:-1])], [12])[0]
    assert float((got - want).abs().max()) > 0.3


@pytest.mark.parametrize("tokens", [1, 37, 64, 300])
def test_mixtral_routing_is_dropless_top2(tokens):
    """moe_ffn=ref with moe_dispatch=offload at capacity_factor E/k is
    plain dropless token-choice top-2: capacity >= tokens, and the output
    equals the reference's mixture on the same float32 weights."""
    e, k, d, f = 8, 2, 32, 48
    assert moe_capacity(tokens, e, k, e / k) >= tokens
    g = torch.Generator().manual_seed(tokens)
    # bf16-representable inputs: the port's router rounds x to bf16 first
    x = torch.randn(tokens, d, generator=g).to(torch.bfloat16).float()
    p = {"router": torch.randn(d, e, generator=g) / d ** 0.5,
         "w_gate": torch.randn(e, d, f, generator=g) / d ** 0.5,
         "w_up": torch.randn(e, d, f, generator=g) / d ** 0.5,
         "w_down": torch.randn(e, f, d, generator=g) / f ** 0.5}
    got = moe_token_onehot(x, p, num_experts=e, k=k, capacity_factor=e / k,
                           inner_impl=Impl({"moe_dispatch": "offload"}))
    m = counts.Dims(layers=1, d_model=d, heads=1, kv_heads=1, head_dim=d,
                    d_ff=f, vocab=2, experts=e, experts_per_token=k)
    ops = decoder._Ops(None, 1e-5)
    want = decoder.moe(ops, x, {kk: v[None] for kk, v in p.items()}, m, 0)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    # below E/k an expert's queue overflows and tokens are dropped
    if tokens >= 64:
        dropped = moe_token_onehot(
            x, p, num_experts=e, k=k, capacity_factor=0.5,
            inner_impl=Impl({"moe_dispatch": "offload"}))
        assert not torch.allclose(dropped, want, rtol=1e-3, atol=1e-3)


def test_served_greedy_tokens_have_no_gap():
    """The engine's greedy tokens, judged by the reference, lie at most a
    rounding below the reference's best."""
    config = _config("tiny")
    m = counts.Dims.from_config(config)
    cfg = M.port_config(config)
    params = weights.params(weights.draw(m, 99, "cpu"))
    eng = M.engine(cfg, params, {"slots": 3, "ctx": 64}, config, 99)
    rng = np.random.default_rng(1)
    for n, out in ((9, 7), (20, 12), (3, 5), (33, 9)):
        eng.submit(rng.integers(0, m.vocab, n).astype(np.int32),
                   max_new_tokens=out)
    done = eng.run_to_completion()
    res = check.judge(params, config, done)
    assert res["positions"] == 7 + 12 + 5 + 9
    assert res["gap"] < 0.05, res
