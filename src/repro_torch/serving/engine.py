"""Continuous-batching serving engine (slot-based, vLLM-style admission) —
the port of the JAX package's ``serving/engine.py``.

A fixed number of decode slots share one batched KV cache.  Each tick:

1. install any pending plan generation (the hot-swap point — see
   ``PlanGeneration``),
2. admit queued requests into every free slot (bucketed single-sequence
   prefill, its cache written into the slot),
3. one batched decode step for every slot,
4. retire finished sequences (max_new_tokens reached) and free the slots.

The correctness contract: a request's tokens are identical whether it runs
alone or interleaved with other requests — slot isolation comes from
per-slot cache rows, positions and per-request sampling seeds
(seed, rid, step).  A plan swap between ticks never drops or re-queues a
request, and (for patterns with identical numerics) never changes a token.

Plan generations: a generation's prefill and decode steps are CUDA graphs
(``serving/graphs.py``), the counterpart of the JAX engine's jitted steps —
one graph per prefill bucket, one decode graph at the engine's slot count,
each captured at its first use (or by ``prepare_plan``) and replayed after
that.  On the CPU they are the eager step functions.  Generations with
equal keys share their graphs (the trace memo).

Bucketed prefill: prompts are right-padded to power-of-two buckets
(``factory.prefill_bucket``) and prefilled with their true ``length`` as a
device tensor, so one graph serves every prompt length in its bucket.
``prefill_traces`` counts one per (generation key, bucket) first use: one
capture on a card, one first call on the CPU.

Admission control: ``submit()`` rejects requests whose prompt +
max_new_tokens cannot fit the cache.

Not ported yet: the JAX engine's replanner hooks (``attach_replanner``),
its canary check, its runtime guard that rolls a faulting plan back to
all-ref (``rollbacks``, ``degraded``), a ``prepare_plan`` that builds on a
background thread while the engine ticks, and multimodal frontends.  Here
a kernel error or a failed capture propagates to the caller: there is no
fallback path.
"""
from __future__ import annotations

import time
from collections import Counter, deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.regions import Impl
from repro_torch.core.search import impl_key
from repro_torch.models import factory as F
from repro_torch.models.params import tree_leaves
from repro_torch.serving.graphs import StepGraph
from repro_torch.serving.sampling import GREEDY, SamplingParams, make_sampler

# per-tick event records retained for the windowed stats view; bounds the
# engine's memory on an infinite request stream
_EVENT_CAPACITY = 1024


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
    admit_tick: int = -1             # engine tick that admitted the request
    plan_generation: int = 0         # plan generation at admission time

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


class _BucketedPrefill:
    """A generation's bucketed prefill: one step per bucket, built (on a
    card: warmed and captured) at the bucket's first use.
    ``prefill(tokens [1, bucket] int32, n)`` -> (logits [1, 1, V], cache)."""

    def __init__(self, engine: "ServeEngine", step):
        self._engine = engine
        self._step = step
        self.steps: dict[int, StepGraph] = {}

    def _fn(self, params, tokens, length):
        return self._step(params, {"tokens": tokens}, length)

    def warm(self, bucket: int) -> StepGraph:
        step = self.steps.get(bucket)
        if step is None:
            feeds = {"tokens": np.zeros((1, bucket), np.int32),
                     "length": np.asarray(bucket, np.int32)}
            step = self._engine._make_step(self._fn, (self._engine.params,),
                                           feeds)
            self.steps[bucket] = step
            self._engine.prefill_traces += 1
        return step

    def __call__(self, tokens: np.ndarray, n: int):
        return self.warm(tokens.shape[1])(tokens, np.asarray(n, np.int32))


class _Decode:
    """A generation's batched decode step against the engine's live cache,
    built (on a card: warmed on a template cache and captured) at its first
    use.  ``decode(tokens [slots, 1] int32, pos [slots] int32)`` ->
    (logits [slots, 1, V], cache)."""

    def __init__(self, engine: "ServeEngine", step):
        self._engine = engine
        self._step = step
        self.step: Optional[StepGraph] = None

    def warm(self) -> StepGraph:
        if self.step is None:
            eng = self._engine
            feeds = {"tokens": np.zeros((eng.slots, 1), np.int32),
                     "pos": np.zeros(eng.slots, np.int32)}
            self.step = eng._make_step(self._step, (eng.params, eng.cache),
                                       feeds,
                                       warm_fixed=(eng.params,
                                                   eng._template_cache()))
        return self.step

    def __call__(self, tokens: np.ndarray, pos: np.ndarray):
        return self.warm()(tokens, pos)


@dataclass
class PlanGeneration:
    """One serving plan: the merged offload pattern plus its prefill and
    decode steps (CUDA graphs on a card, see ``serving/graphs.py``).

    The engine serves exactly one generation at a time.
    ``ServeEngine.prepare_plan`` builds the next one (graphs captured) and
    ``ServeEngine.offer_plan`` stages it.  The swap itself is a pointer
    assignment between ticks: ``step()`` installs the pending generation
    before admitting or decoding, so

    * no tick ever runs half-old half-new steps,
    * in-flight requests keep their cache rows — the cache layout depends
      only on (cfg, slots, ctx), never on the offload pattern,
    * a request's token stream does not depend on when (or whether) a
      swap landed, for patterns with identical numerics.

    ``generation`` is assigned by the engine when the generation is
    installed (the generation counter); ``key`` is the canonical pattern
    identity (``search.impl_key`` of the merged impl) — generations with
    equal keys share their graphs and a swap between them is a no-op.
    """
    impl: Impl                          # merged pattern the steps dispatch
    key: tuple                          # canonical identity (search.impl_key)
    prefill: _BucketedPrefill           # one graph per bucket
    decode: _Decode                     # one graph at the slot count
    generation: int = 0                 # assigned at install time
    plan_seconds: Optional[float] = None  # planner's measured seconds, if any


class ServeEngine:
    """Continuous-batching serving engine.

    * ``cfg`` (ModelConfig)  — architecture; ``cfg.reduced()`` for smoke
      runs.
    * ``params``             — model parameters (``factory.init_params`` or
      ``convert.params_from_numpy``); the engine runs on their device, and
      its graphs hold their storage: replace them in place, if at all.
    * ``slots`` (int, 4)     — concurrent decode lanes sharing one batched
      KV cache.
    * ``ctx`` (int, 128)     — per-slot cache capacity; admission control
      rejects requests that cannot fit it.
    * ``seed`` (int, 0)      — sampling seed: the sampled token is a
      function of (seed, request id, step, logits row).
    * ``impl``               — offload pattern ({region -> variant}, e.g.
      the planner's ``PlanReport.best_impl()``) merged over the arch
      defaults; None = the defaults.

    ``prepare_plan`` builds a generation for another pattern, ``offer_plan``
    stages it, and ``step`` installs it between ticks under the
    ``plan_generation`` counter.
    """

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 ctx: int = 128, seed: int = 0, impl=None):
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.ctx = ctx
        self.seed = seed
        self.device = params["embed"].device
        self._sample = make_sampler(seed)
        self.prefill_traces = 0
        self.buckets_seen: set[int] = set()
        self.cache = F.init_cache(cfg, slots, ctx, self.device)
        # the graphs' shared memory pool (graphs.py states the rule that
        # makes sharing safe); a throwaway cache the decode steps warm on
        self._pool = (torch.cuda.graph_pool_handle()
                      if self.device.type == "cuda" else None)
        self._warm_cache = None
        self.queue: deque[Request] = deque()
        self.active: list[Optional[Request]] = [None] * slots
        self.pos = np.zeros(slots, np.int32)          # next absolute position
        self.last_tok = np.zeros(slots, np.int32)
        # per-slot sampling state (mirrors the active request)
        self._rids = np.zeros(slots, np.int32)
        self._temps = np.zeros(slots, np.float32)
        self._top_ks = np.zeros(slots, np.int32)
        self.finished: list[Request] = []
        self.finished_total = 0          # lifetime count, survives drain
        self._next_rid = 0
        # ---- plan generations ----
        self.ticks = 0                   # completed step() calls
        self.plan_generation = 0         # bumped at every installed swap
        self.swaps = 0
        self.swap_ticks: list[int] = []  # tick number each swap landed before
        self._pending_plan: Optional[PlanGeneration] = None
        self._trace_memo: dict[tuple, tuple] = {}
        self._events: deque[dict] = deque(maxlen=_EVENT_CAPACITY)
        self._gen = self._generation_for(impl)

    # ------------------------------------------------------------------
    # plan generations
    # ------------------------------------------------------------------
    def _make_step(self, fn, fixed: tuple, feeds: dict,
                   warm_fixed=None) -> StepGraph:
        return StepGraph(fn, fixed, feeds, warm_fixed=warm_fixed,
                         pool=self._pool)

    def _template_cache(self) -> dict:
        if self._warm_cache is None:
            self._warm_cache = F.init_cache(self.cfg, self.slots, self.ctx,
                                            self.device)
        return self._warm_cache

    def _generation_for(self, impl,
                        plan_seconds: Optional[float] = None) -> PlanGeneration:
        """Build (or reuse from the trace memo) the prefill/decode pair for
        ``impl`` merged over the arch defaults.  Builds no graph and
        installs nothing."""
        merged = Impl({**F.default_impl(self.cfg), **dict(impl or {})})
        key = impl_key(merged)
        cached = self._trace_memo.get(key)
        if cached is None:
            cached = (
                _BucketedPrefill(self, F.make_bucketed_prefill_step(
                    self.cfg, impl=merged, ctx=self.ctx)),
                _Decode(self, F.make_serve_step(self.cfg, impl=merged)))
            self._trace_memo[key] = cached
        return PlanGeneration(impl=merged, key=key, prefill=cached[0],
                              decode=cached[1], plan_seconds=plan_seconds)

    def prepare_plan(self, impl=None, *, plan_seconds: Optional[float] = None,
                     warm: bool = True) -> PlanGeneration:
        """Build the steps for ``impl`` WITHOUT installing them.

        With ``warm`` (default) the decode step and every prefill bucket
        the engine has served are built — on a card warmed on throwaway
        inputs and captured — so the post-swap tick captures nothing.  Call
        it between ticks; the returned generation is staged with
        :meth:`offer_plan`."""
        gen = self._generation_for(impl, plan_seconds)
        if warm:
            self._warm(gen)
        return gen

    def _warm(self, gen: PlanGeneration) -> None:
        gen.decode.warm()
        for bucket in sorted(self.buckets_seen):
            gen.prefill.warm(bucket)

    def offer_plan(self, prepared: PlanGeneration) -> None:
        """Stage ``prepared`` for installation at the next tick boundary.

        The latest offer wins.  The engine installs it at the top of the
        next ``step()`` — never mid-tick — bumping ``plan_generation``.
        Offering a generation whose canonical key equals the serving one
        is a no-op (no counter bump)."""
        self._pending_plan = prepared

    def _install_pending(self) -> None:
        prepared, self._pending_plan = self._pending_plan, None
        if prepared is None or prepared.key == self._gen.key:
            return
        self.plan_generation += 1
        prepared.generation = self.plan_generation
        self._gen = prepared
        self.swaps += 1
        self.swap_ticks.append(self.ticks)

    @property
    def plan_key(self) -> tuple:
        """Canonical identity of the serving pattern (``search.impl_key``)."""
        return self._gen.key

    @property
    def plan_impl(self) -> Impl:
        """The merged offload pattern currently serving (a copy)."""
        return Impl(dict(self._gen.impl))

    @property
    def plan_seconds(self) -> Optional[float]:
        """The serving plan's measured seconds (None when never measured,
        e.g. the constructor-installed pattern)."""
        return self._gen.plan_seconds

    # ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16,
               sampling: Optional[SamplingParams] = None) -> int:
        """Queue a request; returns its request id (int).

        * ``prompt`` (1-D int32 array, required) — non-empty prompt tokens.
        * ``max_new_tokens`` (int, 16) — generation stops after this many
          tokens.
        * ``sampling`` (SamplingParams, greedy).

        Multimodal prefixes (the JAX engine's ``frontend``) come with the
        frontends.

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
        self._temps[slot] = 0.0
        self._top_ks[slot] = 0

    def _admit(self) -> list[tuple[int, int]]:
        """Admit queued requests into every free slot (several per tick).
        Returns the (bucket, prompt_len) pairs admitted this tick — the
        windowed stats view aggregates them."""
        admitted: list[tuple[int, int]] = []
        for slot in range(self.slots):
            if self.active[slot] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            req.slot_s = time.perf_counter()
            n = req.tokens.size
            bucket = F.prefill_bucket(n, self.ctx)
            req.bucket = bucket
            req.admit_tick = self.ticks
            req.plan_generation = self.plan_generation
            self.buckets_seen.add(bucket)
            padded = np.zeros((1, bucket), np.int32)
            padded[0, :n] = req.tokens
            # the graph's outputs are consumed (copied into the slot,
            # sampled) before any other graph replays: the shared-pool rule
            logits, one_cache = self._gen.prefill(padded, n)
            cache_insert(self.cache, one_cache, slot)
            sp = req.sampling
            first = int(self._sample(logits[:, -1], [req.rid], [0],
                                     [sp.temperature], [sp.top_k])[0])
            req.generated.append(first)
            req.admit_s = time.perf_counter()
            self.active[slot] = req
            self.pos[slot] = n
            self.last_tok[slot] = first
            self._rids[slot] = req.rid
            self._temps[slot] = sp.temperature
            self._top_ks[slot] = sp.top_k
            admitted.append((bucket, n))
            if len(req.generated) >= req.max_new_tokens:
                self._retire(slot)      # single-token request: done at prefill
        return admitted

    def _tick_decode(self) -> int:
        """One batched decode step; returns the number of slots decoded."""
        decoding = sum(r is not None for r in self.active)
        if not decoding:
            return 0
        logits, _ = self._gen.decode(self.last_tok[:, None], self.pos)
        steps = np.asarray([len(r.generated) if r is not None else 0
                            for r in self.active], np.int32)
        nxt = self._sample(logits[:, -1], self._rids, steps, self._temps,
                           self._top_ks)
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            self.pos[slot] += 1
            req.generated.append(int(nxt[slot]))
            self.last_tok[slot] = nxt[slot]
            if len(req.generated) >= req.max_new_tokens:
                self._retire(slot)
        return decoding

    def step(self) -> None:
        """One engine tick: install any pending plan (the hot-swap point —
        strictly between ticks), admit, decode, record the tick event."""
        self.ticks += 1
        self._install_pending()
        admitted = self._admit()
        decoded = self._tick_decode()
        self._events.append({
            "tick": self.ticks,
            "active": sum(r is not None for r in self.active),
            "queue": len(self.queue),
            "decode_tokens": decoded,
            "admitted": admitted,
        })

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
        periodically; ``finished_total`` and the windowed view survive)."""
        done, self.finished = sorted(self.finished, key=lambda r: r.rid), []
        return done

    # ------------------------------------------------------------------
    def _counts(self) -> dict:
        """Conserved lifecycle accounting, present in both stats views:
        ``requests_submitted == requests_finished_total + requests_pending
        + requests_active`` at every tick boundary."""
        active = sum(r is not None for r in self.active)
        return {
            "requests_submitted": self._next_rid,
            "requests_pending": len(self.queue),
            "requests_active": active,
            "requests_finished_total": self.finished_total,
            "ticks": self.ticks,
            "plan_generation": self.plan_generation,
            "swaps": self.swaps,
            "slot_occupancy": active / self.slots if self.slots else 0.0,
        }

    def stats(self, window: Optional[int] = None) -> dict:
        """Serving statistics, in two views (the JAX engine's keys, less
        its rollback telemetry).

        ``stats()`` aggregates lifecycle stats over *finished* requests:
        ``requests_finished``, ``generated_tokens``, ``ttft_s_mean`` /
        ``ttft_s_p50``, ``queue_wait_s_mean``, ``decode_tps_mean``, plus
        ``prefill_traces`` (one per (generation, bucket) first use) and
        ``buckets`` (sorted bucket lengths seen).

        ``stats(window=N)`` is the windowed in-flight view over the last N
        ticks: ``bucket_hist`` (admissions per prefill bucket, including
        still-running requests), ``prompt_len_mean``, ``occupancy_mean``
        (active slots / slots per tick), ``queue_depth_mean``,
        ``decode_tokens``, ``decode_prefill_ratio`` (decode steps per
        admission), ``requests_admitted``, ``ticks_observed``.

        Both views carry the conserved counters and ``ticks``,
        ``plan_generation``, ``swaps``, ``slot_occupancy``."""
        if window is not None:
            return self._stats_windowed(int(window))
        done = self.finished
        ttfts = [r.ttft_s for r in done if r.ttft_s >= 0]
        waits = [r.queue_wait_s for r in done if r.slot_s >= 0]
        tps = [r.decode_tps for r in done if r.decode_tps > 0]
        return {
            "requests_finished": len(done),
            "generated_tokens": sum(len(r.generated) for r in done),
            "ttft_s_mean": float(np.mean(ttfts)) if ttfts else 0.0,
            "ttft_s_p50": float(np.median(ttfts)) if ttfts else 0.0,
            "queue_wait_s_mean": float(np.mean(waits)) if waits else 0.0,
            "decode_tps_mean": float(np.mean(tps)) if tps else 0.0,
            "prefill_traces": self.prefill_traces,
            "buckets": sorted(self.buckets_seen),
            **self._counts(),
        }

    def _stats_windowed(self, window: int) -> dict:
        lo = self.ticks - max(window, 0)
        events = [e for e in self._events if e["tick"] > lo]
        buckets: Counter = Counter()
        lens: list[int] = []
        occ: list[float] = []
        qdepth: list[int] = []
        decode_tokens = 0
        for e in events:
            occ.append(e["active"] / self.slots if self.slots else 0.0)
            qdepth.append(e["queue"])
            decode_tokens += e["decode_tokens"]
            for bucket, plen in e["admitted"]:
                buckets[bucket] += 1
                lens.append(plen)
        admitted = len(lens)
        return {
            "window": window,
            "ticks_observed": len(events),
            "requests_admitted": admitted,
            "bucket_hist": dict(sorted(buckets.items())),
            "prompt_len_mean": float(np.mean(lens)) if lens else 0.0,
            "occupancy_mean": float(np.mean(occ)) if occ else 0.0,
            "queue_depth_mean": float(np.mean(qdepth)) if qdepth else 0.0,
            "decode_tokens": decode_tokens,
            "decode_prefill_ratio": decode_tokens / max(admitted, 1),
            **self._counts(),
        }
