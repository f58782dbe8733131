"""Hopper-vs-ref agreement of a Mixture-of-Experts model's prefill, on any
prompt.

Expert choice turns a one-ulp difference of a token's hidden state into
another pick at an expert's capacity boundary (the router's input is
rounded to bf16 before its float32 product, ``models/moe.py``), and from
that layer on the two runs diverge.  So the prefill logits of two correct
attention paths that round differently need not agree on a given prompt,
and a rule on the logits alone holds on chosen prompts only.
:func:`check_moe_prefill` holds the attention under test (``attn``, an
``attn_core`` function) against ``ref`` in four parts, each through the
engine's own prefill entry point (``factory.make_bucketed_prefill_step``:
the prompt right-padded to its bucket, every token of the bucket competing
for the experts, the logits taken at the last real position):

1. **The kernel on ref's own inputs.**  Every ``attn_core`` call of the
   ref prefill is recorded (a variant that calls ref and keeps what passed;
   no arithmetic changes), and ``attn`` runs on exactly those q, k and v.
   Each output is held to ref's at the flash tolerance of
   ``tests/test_kernels.py`` (bf16 2e-2, float32 2e-5).  No routing sits
   between those inputs and outputs.
2. **Logits with the routing pinned.**  ``attn``, and each plain attention
   of ``floors``, run the prefill with every expert-choice layer taking
   ref's picks (``ExpertChoiceLog(replay=...)``); each run computes its
   own router probabilities and takes its gates at ref's picks, so
   attention still acts through the gates.  max |logits(attn) -
   logits(ref)| must be at most ``max(LOGIT_NOISE_FACTOR x floor,
   LOGIT_TOL_MIN)``, the floor being the largest such difference of a
   ``floors`` run.
3. **Free-running, no flips.**  ``attn`` routes for itself, and its picks
   are compared with ref's layer by layer (as sets per group and expert).
   Where no pick differs, its logits must meet the rule of part 2 with
   the floor of the ``floors`` routing for themselves too: the rule the
   dense models are held to, unchanged.
4. **Free-running, with flips.**  Let L be the first layer whose picks
   differ.  The router's scores (its logits, every token of the bucket)
   of ``attn`` and ref at L may differ by at most ``LOGIT_NOISE_FACTOR``
   x the largest difference a ``floors`` run shows against ref at L, the
   floors taken from their pinned runs of part 2 (a floor that routes for
   itself may flip before L, and its difference at L would then bound
   nothing).  A flip is then a near-tie that a perturbation of ref's own
   rounding noise at L can turn; the margin of a flipped pick is not
   tested, since every flip has a margin below its own perturbation.

Only expert-choice routing (``moe_ffn=offload``, the default of every MoE
config) is covered, and decoder-only models.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch.core.regions import (Impl, gene_variant, register_variant,
                                      unregister_variant, variants)
from repro_torch.models import factory as F
from repro_torch.models.moe import ExpertChoiceLog

# the flash tolerances of tests/test_kernels.py (rtol = atol)
KERNEL_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# the prefill-logits rule of the dense models (chip_smoke.py): at most 3x
# the noise floor of two plain versions, and never below 0.05
LOGIT_NOISE_FACTOR = 3.0
LOGIT_TOL_MIN = 0.05

# the prompts the rule runs on, fixed before any run: draw i is a prompt of
# DRAW_LENGTHS[i % 3] tokens (buckets 2,080, 512 and 16 at ctx 2,080) drawn
# by ``factory.synthetic_request`` from seed 100 + i
DRAW_LENGTHS = (2060, 300, 9)
DRAWS = tuple((DRAW_LENGTHS[i % 3], 100 + i) for i in range(6))

_TEST, _REF, _FLOOR = "_moe_check_test", "_moe_check_ref", "_moe_check_floor_"


@dataclass
class MoeCheck:
    """The outcome of :func:`check_moe_prefill` on one prompt."""
    prompt_len: int
    bucket: int
    kernel_err: float = 0.0          # part 1: max |attn - ref|, ref's inputs
    kernel_tol: float = 0.0
    pinned_diff: float = 0.0         # part 2: logits on ref's picks
    pinned_floor: float = 0.0
    pinned_tol: float = 0.0
    flips: list = field(default_factory=list)  # per MoE layer, attn free
    free_diff: float = 0.0           # part 3: logits, each routing freely
    free_floor: float | None = None  # (run only when no pick flipped)
    free_tol: float | None = None
    first_flip: int | None = None    # part 4: L
    router_diff: float | None = None
    router_bound: float | None = None
    failures: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.failures

    def line(self) -> str:
        text = (f"prompt {self.prompt_len} (bucket {self.bucket}): kernel on "
                f"ref's inputs {self.kernel_err:.3e} (tol {self.kernel_tol}); "
                f"logits on ref's picks {self.pinned_diff:.3e} (tol "
                f"{self.pinned_tol:.3e}, floor {self.pinned_floor:.3e}); "
                f"flips per layer {self.flips}; free logits "
                f"{self.free_diff:.3e}")
        if self.first_flip is None:
            text += (f" (tol {self.free_tol:.3e}, floor "
                     f"{self.free_floor:.3e})")
        else:
            text += (f"; L = {self.first_flip}: router logits differ by "
                     f"{self.router_diff:.3e}, bound {self.router_bound:.3e}")
        return text + (": PASS" if self.ok else
                       ": FAIL: " + "; ".join(self.failures))


def _max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def _flip_count(want: torch.Tensor, got: torch.Tensor, tokens: int) -> int:
    """Tokens in ``want``'s picks [G, E, C] that ``got`` does not pick for
    the same (group, expert)."""
    def member(idx):
        m = torch.zeros(*idx.shape[:2], tokens, dtype=torch.bool,
                        device=idx.device)
        return m.scatter_(-1, idx, True)
    return int((member(want) & ~member(got)).sum())


@contextlib.contextmanager
def _registered(attn: Callable, floors: dict, calls: list):
    """The attention functions under private ``attn_core`` names; ref's
    records every call (q, k, v, kwargs, out) in ``calls``."""
    ref = variants("attn_core")["ref"]

    def ref_tap(q, k, v, **kw):
        out = ref(q, k, v, **kw)
        calls.append((q, k, v, kw, out))
        return out

    names = {_TEST: attn, _REF: ref_tap,
             **{_FLOOR + n: fn for n, fn in floors.items()}}
    for name, fn in names.items():
        register_variant("attn_core", name)(fn)
    try:
        yield
    finally:
        for name in names:
            unregister_variant("attn_core", name)


def check_moe_prefill(params, cfg, prompt: np.ndarray, *, ctx: int,
                      attn: Callable, floors: dict,
                      impl: Impl | None = None) -> MoeCheck:
    """Hold ``attn`` against ``ref`` on the prefill of ``prompt`` by the
    four parts of the module docstring.  ``floors``: name -> attention
    function, the plain versions whose distance from ref is the noise
    floor.  ``impl``: the served pattern, merged over the config's
    defaults as the engine merges it."""
    base = Impl({**F.default_impl(cfg), **(impl or {})})
    if not cfg.is_moe or gene_variant(base.get("moe_ffn", "ref")) != "offload":
        raise ValueError(f"{cfg.name}: the check covers expert-choice MoE "
                         "models (moe_ffn=offload)")
    if cfg.frontend != "none":
        raise ValueError(f"{cfg.name}: the check covers decoder-only models")
    if not floors:
        raise ValueError("the check needs at least one floor variant")
    dev = params["embed"].device
    n = int(prompt.size)
    bucket = F.prefill_bucket(n, ctx)
    padded = np.zeros((1, bucket), np.int64)
    padded[0, :n] = prompt
    batch = {"tokens": torch.from_numpy(padded).to(dev)}
    out = MoeCheck(prompt_len=n, bucket=bucket)
    calls: list = []

    def prefill(variant: str, replay=None):
        """The engine's bucketed prefill with ``attn_core=variant``: the
        logits at the last real position, and the routing log."""
        step = F.make_bucketed_prefill_step(
            cfg, impl=Impl({**base, "attn_core": variant}), ctx=ctx)
        log = ExpertChoiceLog(replay)
        with log.active():
            logits, _ = step(params, batch, n)
        return logits[0, -1].float(), log

    def tol(floor: float) -> float:
        return max(LOGIT_NOISE_FACTOR * floor, LOGIT_TOL_MIN)

    with _registered(attn, floors, calls), torch.no_grad():
        ref_logits, ref_log = prefill(_REF)
        # part 1: the kernel on every input of the ref prefill
        for i, (q, k, v, kw, want) in enumerate(calls):
            out.kernel_tol = KERNEL_TOL[q.dtype]
            got = attn(q, k, v, **kw)
            err = _max_diff(got, want)
            out.kernel_err = max(out.kernel_err, err)
            if not torch.allclose(got.float(), want.float(),
                                  rtol=out.kernel_tol, atol=out.kernel_tol):
                out.failures.append(f"attention call {i} differs from ref "
                                    f"on ref's inputs by {err:.3e}")
        calls.clear()
        # part 2: every run on ref's picks
        pinned, _ = prefill(_TEST, ref_log.picks)
        floor_logs = {}
        for name in floors:
            logits, floor_logs[name] = prefill(_FLOOR + name, ref_log.picks)
            out.pinned_floor = max(out.pinned_floor,
                                   _max_diff(logits, ref_logits))
        out.pinned_diff = _max_diff(pinned, ref_logits)
        out.pinned_tol = tol(out.pinned_floor)
        if not bool(torch.isfinite(pinned).all()):
            out.failures.append("non-finite logits")
        if not out.pinned_diff <= out.pinned_tol:
            out.failures.append(f"logits on ref's picks differ by "
                                f"{out.pinned_diff:.3e} > {out.pinned_tol:.3e}")
        # parts 3 and 4: the test routing for itself
        free, free_log = prefill(_TEST)
        out.free_diff = _max_diff(free, ref_logits)
        out.flips = [_flip_count(want, got, lg.shape[1]) for want, got, lg in
                     zip(ref_log.picks, free_log.picks, ref_log.logits)]
        flipped = [i for i, f in enumerate(out.flips) if f]
        if not flipped:
            out.free_floor = max(_max_diff(prefill(_FLOOR + name)[0],
                                           ref_logits) for name in floors)
            out.free_tol = tol(out.free_floor)
            if not out.free_diff <= out.free_tol:
                out.failures.append(f"free-running logits differ by "
                                    f"{out.free_diff:.3e} > "
                                    f"{out.free_tol:.3e} with no flip")
        else:
            at = out.first_flip = flipped[0]
            out.router_diff = _max_diff(free_log.logits[at],
                                        ref_log.logits[at])
            out.router_bound = LOGIT_NOISE_FACTOR * max(
                _max_diff(log.logits[at], ref_log.logits[at])
                for log in floor_logs.values())
            if not out.router_diff <= out.router_bound:
                out.failures.append(
                    f"layer {at}, the first that flips: router logits differ "
                    f"by {out.router_diff:.3e} > {out.router_bound:.3e}")
    return out
