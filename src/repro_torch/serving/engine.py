"""Continuous-batching serving engine (slot-based, vLLM-style admission) —
the port of the JAX package's ``serving/engine.py`` without plan swapping.

A fixed number of decode slots share one batched KV cache.  Each tick:

1. admit queued requests into every free slot (bucketed single-sequence
   prefill, its cache written into the slot),
2. one batched decode step for every slot,
3. retire finished sequences (max_new_tokens reached) and free the slots.

The correctness contract: a request's tokens are identical whether it runs
alone or interleaved with other requests — slot isolation comes from
per-slot cache rows, positions and per-request sampling seeds
(seed, rid, step).

Bucketed prefill: prompts are right-padded to power-of-two buckets
(``factory.prefill_bucket``) and prefilled with their true ``length``.
Eager PyTorch compiles nothing per shape, so the JAX engine's
``prefill_traces`` has no counterpart; ``stats()["buckets"]`` reports the
buckets seen.

Admission control: ``submit()`` rejects requests whose prompt +
max_new_tokens cannot fit the cache.

Not ported (slice 3 of the port): the JAX engine's plan generations and
hot swaps, its replanner hooks, its canary check, and its runtime guard
that rolls a faulting plan back to all-ref.  Here a kernel error
propagates to the caller: there is no fallback path.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.regions import Impl
from repro_torch.models import factory as F
from repro_torch.models.params import tree_leaves
from repro_torch.serving.sampling import GREEDY, SamplingParams, make_sampler


class ServeIncompleteError(RuntimeError):
    """``run_to_completion`` ran out of ticks with work still in flight.

    Carries the structured partial result: ``finished`` (completed requests)
    and ``pending`` (rids still queued or mid-decode)."""

    def __init__(self, finished: list, pending: list[int], max_ticks: int):
        self.finished = finished
        self.pending = pending
        super().__init__(
            f"run_to_completion exhausted max_ticks={max_ticks} with "
            f"{len(pending)} request(s) unfinished (rids {pending}); "
            f"{len(finished)} finished")


@dataclass
class Request:
    rid: int
    tokens: np.ndarray               # prompt [S]
    max_new_tokens: int
    sampling: SamplingParams = GREEDY
    generated: list = field(default_factory=list)
    done: bool = False
    # ---- lifecycle stats (perf_counter seconds; -1 = not reached) ----
    submit_s: float = -1.0
    slot_s: float = -1.0             # assigned a free slot (prefill starts)
    admit_s: float = -1.0            # prefill finished, first token sampled
    finish_s: float = -1.0
    bucket: int = 0                  # padded prefill length

    @property
    def queue_wait_s(self) -> float:
        """Seconds between submit() and assignment to a free slot."""
        return self.slot_s - self.submit_s if self.slot_s >= 0 else -1.0

    @property
    def ttft_s(self) -> float:
        """Time to first token (queue wait + prefill + first sample)."""
        return self.admit_s - self.submit_s if self.admit_s >= 0 else -1.0

    @property
    def decode_tps(self) -> float:
        """Decode throughput for this request (tokens after the first)."""
        n = len(self.generated) - 1
        dt = self.finish_s - self.admit_s
        return n / dt if n > 0 and dt > 0 else 0.0


def cache_insert(full_cache: dict, one_cache: dict, slot: int) -> dict:
    """Copy a batch-1 cache into slot ``slot`` of the batched cache, IN
    PLACE (the JAX function returns a new tree; a full-width cache is
    gigabytes).  Stacked (``stack``) leaves carry [layers, B, ...],
    unstacked (``tail``) leaves [B, ...].  Returns ``full_cache``."""
    for top, sub in full_cache.items():
        for dst, src in zip(tree_leaves(sub), tree_leaves(one_cache[top])):
            if top == "stack":
                dst[:, slot] = src[:, 0]
            else:
                dst[slot] = src[0]
    return full_cache


class ServeEngine:
    """Continuous-batching serving engine.

    * ``cfg`` (ModelConfig)  — architecture; ``cfg.reduced()`` for smoke
      runs.
    * ``params``             — model parameters (``factory.init_params`` or
      ``convert.params_from_numpy``); the engine runs on their device.
    * ``slots`` (int, 4)     — concurrent decode lanes sharing one batched
      KV cache.
    * ``ctx`` (int, 128)     — per-slot cache capacity; admission control
      rejects requests that cannot fit it.
    * ``seed`` (int, 0)      — sampling seed: the sampled token is a
      function of (seed, request id, step, logits row).
    * ``impl``               — offload pattern ({region -> variant}, e.g.
      the planner's ``PlanReport.best_impl()``) merged over the arch
      defaults; None = the defaults.
    """

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 ctx: int = 128, seed: int = 0, impl=None):
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.ctx = ctx
        self.seed = seed
        self.device = params["embed"].device
        self.impl = Impl({**F.default_impl(cfg), **dict(impl or {})})
        self._prefill = F.make_bucketed_prefill_step(cfg, impl=self.impl,
                                                     ctx=ctx)
        self._decode = F.make_serve_step(cfg, impl=self.impl)
        self._sample = make_sampler(seed)
        self.buckets_seen: set[int] = set()
        self.cache = F.init_cache(cfg, slots, ctx, self.device)
        self.queue: deque[Request] = deque()
        self.active: list[Optional[Request]] = [None] * slots
        self.pos = np.zeros(slots, np.int32)          # next absolute position
        self.last_tok = np.zeros(slots, np.int32)
        self.finished: list[Request] = []
        self.finished_total = 0          # lifetime count, survives drain
        self.ticks = 0
        self._next_rid = 0

    # ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16,
               sampling: Optional[SamplingParams] = None) -> int:
        """Queue a request; returns its request id (int).

        * ``prompt`` (1-D int32 array, required) — non-empty prompt tokens.
        * ``max_new_tokens`` (int, 16) — generation stops after this many
          tokens.
        * ``sampling`` (SamplingParams, greedy).

        Multimodal prefixes (the JAX engine's ``frontend``) come with the
        frontends, in slice 3 of the port.

        Raises ValueError if the request cannot fit the cache: prompt +
        max_new_tokens must be <= ctx (an overflow would silently overwrite
        the last cache slot)."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError(f"prompt must be a non-empty 1-D token array, "
                             f"got shape {prompt.shape}")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        need = prompt.size + max_new_tokens
        if need > self.ctx:
            raise ValueError(
                f"request needs {need} cache slots (prompt {prompt.size} + "
                f"max_new_tokens {max_new_tokens}) but ctx={self.ctx}")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, prompt, max_new_tokens, sampling=sampling or GREEDY)
        req.submit_s = time.perf_counter()
        self.queue.append(req)
        return rid

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.active)

    # ------------------------------------------------------------------
    def _retire(self, slot: int) -> None:
        req = self.active[slot]
        req.done = True
        req.finish_s = time.perf_counter()
        self.finished.append(req)
        self.finished_total += 1
        self.active[slot] = None

    def _admit(self) -> list[tuple[int, int]]:
        """Admit queued requests into every free slot (several per tick).
        Returns the (bucket, prompt_len) pairs admitted this tick."""
        admitted: list[tuple[int, int]] = []
        for slot in range(self.slots):
            if self.active[slot] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            req.slot_s = time.perf_counter()
            n = req.tokens.size
            bucket = F.prefill_bucket(n, self.ctx)
            req.bucket = bucket
            self.buckets_seen.add(bucket)
            padded = np.zeros((1, bucket), np.int32)
            padded[0, :n] = req.tokens
            batch = {"tokens": torch.from_numpy(padded).to(self.device)}
            logits, one_cache = self._prefill(self.params, batch, n)
            cache_insert(self.cache, one_cache, slot)
            del one_cache
            sp = req.sampling
            first = int(self._sample(logits[:, -1], [req.rid], [0],
                                     [sp.temperature], [sp.top_k])[0])
            req.generated.append(first)
            req.admit_s = time.perf_counter()
            self.active[slot] = req
            self.pos[slot] = n
            self.last_tok[slot] = first
            admitted.append((bucket, n))
            if len(req.generated) >= req.max_new_tokens:
                self._retire(slot)      # single-token request: done at prefill
        return admitted

    def _tick_decode(self) -> int:
        """One batched decode step; returns the number of slots decoded."""
        decoding = sum(r is not None for r in self.active)
        if not decoding:
            return 0
        toks = torch.from_numpy(self.last_tok[:, None].copy()).to(self.device)
        pos = torch.from_numpy(self.pos.copy()).to(self.device)
        logits, self.cache = self._decode(self.params, self.cache, toks, pos)
        reqs = self.active
        nxt = self._sample(
            logits[:, -1],
            [r.rid if r else 0 for r in reqs],
            [len(r.generated) if r else 0 for r in reqs],
            [r.sampling.temperature if r else 0.0 for r in reqs],
            [r.sampling.top_k if r else 0 for r in reqs])
        for slot, req in enumerate(reqs):
            if req is None:
                continue
            self.pos[slot] += 1
            req.generated.append(int(nxt[slot]))
            self.last_tok[slot] = nxt[slot]
            if len(req.generated) >= req.max_new_tokens:
                self._retire(slot)
        return decoding

    def step(self) -> None:
        """One engine tick: admit, then decode."""
        self.ticks += 1
        self._admit()
        self._tick_decode()

    def run_to_completion(self, max_ticks: int = 10_000, *,
                          raise_incomplete: bool = True) -> list[Request]:
        """Drive the engine until idle.  If ``max_ticks`` expires with work
        still queued or active, raises ServeIncompleteError — or, with
        ``raise_incomplete=False``, returns the finished list as it is."""
        ticks = 0
        while self.busy and ticks < max_ticks:
            self.step()
            ticks += 1
        if self.busy and raise_incomplete:
            pending = sorted([r.rid for r in self.queue]
                             + [r.rid for r in self.active if r is not None])
            raise ServeIncompleteError(
                sorted(self.finished, key=lambda r: r.rid), pending, max_ticks)
        return sorted(self.finished, key=lambda r: r.rid)

    def drain_finished(self) -> list[Request]:
        """Return and clear the finished list (long-lived engines drain
        periodically; ``finished_total`` survives)."""
        done, self.finished = sorted(self.finished, key=lambda r: r.rid), []
        return done

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """Lifecycle statistics over the *finished* requests:
        ``requests_finished``, ``generated_tokens``, ``ttft_s_mean`` /
        ``ttft_s_p50``, ``queue_wait_s_mean``, ``decode_tps_mean``,
        ``buckets`` (sorted bucket lengths seen), and the conserved counters
        ``requests_submitted == requests_finished_total + requests_pending
        + requests_active``."""
        done = self.finished
        ttfts = [r.ttft_s for r in done if r.ttft_s >= 0]
        waits = [r.queue_wait_s for r in done if r.slot_s >= 0]
        tps = [r.decode_tps for r in done if r.decode_tps > 0]
        active = sum(r is not None for r in self.active)
        return {
            "requests_finished": len(done),
            "generated_tokens": sum(len(r.generated) for r in done),
            "ttft_s_mean": float(np.mean(ttfts)) if ttfts else 0.0,
            "ttft_s_p50": float(np.median(ttfts)) if ttfts else 0.0,
            "queue_wait_s_mean": float(np.mean(waits)) if waits else 0.0,
            "decode_tps_mean": float(np.mean(tps)) if tps else 0.0,
            "buckets": sorted(self.buckets_seen),
            "requests_submitted": self._next_rid,
            "requests_pending": len(self.queue),
            "requests_active": active,
            "requests_finished_total": self.finished_total,
            "ticks": self.ticks,
            "slot_occupancy": active / self.slots if self.slots else 0.0,
        }
