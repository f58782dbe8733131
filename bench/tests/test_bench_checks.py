"""The comparison that decides ``correct``, shown to fail: the control (the
reference one precision step below the served bf16) reads above the
cell's limit, and a run whose timed path is broken underneath comes out
not correct, once for each fault a one-card serving cell can have.  At a
size the CPU serves in seconds; the harness's look for a card is the
only part of a run skipped."""
import json

import pytest
import torch

from bench import harness
from bench.spec import Spec
from bench.tests.conftest import DATA

import repro_torch.models.layers as L
import repro_torch.models.lm as LM
import repro_torch.serving.engine as E

SECONDS = 4.0


def _run(root, cell: str, seed: int) -> dict:
    return harness.run_cell(Spec(root), cell, seed, SECONDS, False,
                            torch.device("cpu"))


@pytest.mark.parametrize("cell", ["tiny.chat", "tiny.batch"])
def test_a_sound_run_is_correct(checkout, cell):
    out = _run(checkout, cell, 2**31 + 11)
    assert out["correct"], out["checks"]
    assert {"output_tok_s", "setup_s"} <= set(out["metrics"])
    if cell == "tiny.chat":
        assert set(out["metrics"]) == {"ttft_p90_ms", "itl_p95_ms",
                                       "output_tok_s", "setup_s"}
        assert out["attempted"] == round(8 * SECONDS) and out["failed"] == 0
    assert list(out)[-1] == "checks"


def _state_unchanged(monkeypatch):
    """Decode steps that leave the KV cache as they found it."""
    monkeypatch.setattr(L, "cache_update", lambda k, v, sp, *a, **kw: (k, v, sp))


def _half_batch(monkeypatch):
    """A decode step that computes the first half of the slots and hands
    the second half the first half's logits."""
    real = LM.decode_step

    def half(params, cache, tokens, pos, **kw):
        logits, cache = real(params, cache, tokens, pos, **kw)
        h = logits.shape[0] // 2
        logits = logits.clone()
        logits[h:2 * h] = logits[:h]
        return logits, cache
    monkeypatch.setattr(LM, "decode_step", half)


def _token_altered(monkeypatch):
    """Each request's second token altered where the sampler produces it."""
    real = E.make_sampler

    def make(seed):
        sample = real(seed)

        def altered(logits, rids, steps, *rest, **kw):
            out = sample(logits, rids, steps, *rest, **kw)
            toks = out[0] if isinstance(out, tuple) else out
            for i, step in enumerate(steps):
                if int(step) == 1:
                    toks[i] = (toks[i] + 1) % logits.shape[-1]
            return out
        return altered
    monkeypatch.setattr(E, "make_sampler", make)


@pytest.mark.parametrize("plant", [_state_unchanged, _half_batch,
                                   _token_altered],
                         ids=["state_unchanged", "half_batch", "token_altered"])
def test_a_broken_timed_path_is_not_correct(checkout, monkeypatch, plant):
    # every slot busy from the start: a fault in any slot is served
    plant(monkeypatch)
    out = _run(checkout, "tiny.batch", 2**31 + 11)
    assert not out["correct"]
    gap = out["checks"]["max_logit_gap"]
    assert gap["value"] > gap["limit"] and not gap["passes"]


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_the_control_fails_the_limit(checkout, seed):
    """A run with the control (the fp8 reference) judged in the program's
    place comes out not correct by the cell's own checks and limits file,
    while the program's served tokens, read in the same run, pass."""
    limit = json.loads((DATA / "tiny.chat.limits.json").read_text())[
        "max_logit_gap"]
    out = harness.run_cell(Spec(checkout), "tiny.chat", 2**31 + seed,
                           SECONDS, False, torch.device("cpu"), control=True)
    assert not out["correct"]
    assert out["checks"]["compared_tokens"]["passes"]
    gap = out["checks"]["max_logit_gap"]
    assert out["readings"]["program"]["gap"] <= limit
    assert limit == gap["limit"] < gap["value"]
    assert out["readings"]["control"]["gap"] == gap["value"]


def test_too_few_compared_tokens_is_not_correct(checkout):
    """The served tokens compared have to reach the mix's
    ``check.served_tokens``."""
    path = checkout / "bench" / "traffic" / "tinychat.json"
    mix = json.loads(path.read_text())
    mix["check"]["served_tokens"] = 10_000
    path.write_text(json.dumps(mix))
    out = _run(checkout, "tiny.chat", 2**31 + 11)
    assert not out["correct"]
    assert not out["checks"]["compared_tokens"]["passes"]
    assert out["checks"]["compared_tokens"]["limit"] == 10_000
