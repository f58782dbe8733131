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

Graceful degradation: every tick-path plan call runs under a runtime guard
(``_plan_call``).  Each step also returns one device flag, "the logits are
finite", which reaches the host in the same copy as the sampled tokens —
no extra sync.  A built step that raises, or whose flag is False, rolls
the engine back to the last healthy generation (all-ref as the terminal
fallback) and retries the same call, so in-flight requests are never
dropped or corrupted.  A step that fails to build (its warm-up or capture;
on the CPU its first call) raises instead: a kernel that does not build is
a fault of the code, never quietly served by the plain version.  The
decode step writes the live cache in place, so while a generation is on
probation (until its first finite decode) the engine copies the
recurrent-state leaves (RG-LRU, SSM) into a backup before each decode, and
a rollback restores them; attention rows written at the step's position
are simply written again by the retry.  ``canary_check`` validates a
candidate before ``offer_plan`` (the rule is in its docstring); faulted
plan keys are refused re-installation.

Online replanning (``serving/replan.py``): ``prepare_plan`` may run on the
replanner's thread while the engine ticks.  Its graphs are captured on a
side stream of that thread in ``thread_local`` mode, into a memory pool of
the generation's own (``serving/graphs.py``), and ``offer_plan`` stages
the generation for the next tick boundary.  The trace memo keeps the
generations that serve, are pending or are rollback targets; the others
(faulted ones included) leave it at the next swap or rollback, and their
graphs and pool are freed once nothing else refers to them.  Multimodal
frontends are not ported.
"""
from __future__ import annotations

import threading
import time
from collections import Counter, deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.regions import Impl, canonical_gene, observe_dispatch
from repro_torch.core.search import impl_key
from repro_torch.models import factory as F
from repro_torch.models.params import tree_leaves
from repro_torch.serving.graphs import StepGraph
from repro_torch.serving.sampling import GREEDY, SamplingParams, make_sampler

# per-tick event records retained for the windowed stats view; bounds the
# engine's memory on an infinite request stream
_EVENT_CAPACITY = 1024
# rollback targets retained per engine: the newest N previously-healthy
# generations, newest last (all-ref is the terminal fallback anyway)
_FALLBACK_CAPACITY = 4
# the canary's tolerance where the candidate's decode arithmetic differs
# from the serving plan's: the rule of chip_smoke.py's serve parity — at
# most 3x the offload-vs-ref noise floor measured on the same batch, and
# never below 0.05 (a wrong kernel moves the logits by O(1))
CANARY_NOISE_FACTOR = 3.0
CANARY_TOL_MIN = 0.05
# cache subtrees a decode step overwrites whole (the recurrent states)
_STATE_KEYS = ("rglru", "ssm")


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


class PlanFault(RuntimeError):
    """A serving plan misbehaved on the tick path: a step raised, or it
    produced non-finite logits.  The engine catches this internally to roll
    back to the last healthy generation; it only escapes when even the
    all-reference plan faults (nothing left to roll back to)."""


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


def _state_leaves(cache: dict) -> list:
    """The leaves of ``cache`` a decode step overwrites whole."""
    out: list = []

    def walk(tree):
        for k, v in tree.items():
            if k in _STATE_KEYS:
                out.extend(tree_leaves(v))
            elif isinstance(v, dict):
                walk(v)
    walk(cache)
    return out


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


def _finite(logits: torch.Tensor) -> torch.Tensor:
    """The steps' one flag: every logit is finite (a 0-d bool tensor)."""
    return torch.isfinite(logits).all()


class _BucketedPrefill:
    """A generation's bucketed prefill: one step per bucket, built (on a
    card: warmed and captured into the generation's ``pool``) at the
    bucket's first use.  ``prefill(tokens [1, bucket] int32, n)`` ->
    (logits [1, 1, V], cache, finite flag)."""

    def __init__(self, engine: "ServeEngine", step, pool):
        self._engine = engine
        self._step = step
        self._pool = pool
        self._lock = threading.Lock()
        self.steps: dict[int, StepGraph] = {}

    def _fn(self, params, tokens, length):
        logits, cache = self._step(params, {"tokens": tokens}, length)
        return logits, cache, _finite(logits)

    def warm(self, bucket: int) -> StepGraph:
        with self._lock:
            step = self.steps.get(bucket)
            if step is None:
                feeds = {"tokens": np.zeros((1, bucket), np.int32),
                         "length": np.asarray(bucket, np.int32)}
                step = self._engine._make_step(
                    self._fn, (self._engine.params,), feeds, pool=self._pool)
                self.steps[bucket] = step
                self._engine.prefill_traces += 1
            return step

    def __call__(self, tokens: np.ndarray, n: int):
        return self.warm(tokens.shape[1])(tokens, np.asarray(n, np.int32))


class _Decode:
    """A generation's batched decode step against the engine's live cache,
    built (on a card: warmed on a template cache and captured into the
    generation's ``pool``) at its first use.  ``decode(tokens [slots, 1]
    int32, pos [slots] int32)`` -> (logits [slots, 1, V], cache, finite
    flag)."""

    def __init__(self, engine: "ServeEngine", step, pool):
        self._engine = engine
        self._inner = step
        self._pool = pool
        self._lock = threading.Lock()
        self.step: Optional[StepGraph] = None

    def _fn(self, params, cache, tokens, pos):
        logits, cache = self._inner(params, cache, tokens, pos)
        return logits, cache, _finite(logits)

    def warm(self) -> StepGraph:
        with self._lock:
            if self.step is None:
                eng = self._engine
                feeds = {"tokens": np.zeros((eng.slots, 1), np.int32),
                         "pos": np.zeros(eng.slots, np.int32)}
                template = eng._template_cache()
                self.step = eng._make_step(
                    self._fn, (eng.params, eng.cache), feeds,
                    warm_fixed=(eng.params, template), pool=self._pool)
            return self.step

    def eager(self, cache: dict, tokens: np.ndarray, pos: np.ndarray):
        """The step function called eagerly on another ``cache`` (the
        canary's): (logits, flag)."""
        eng = self._engine
        dev = eng.device
        logits, _, ok = self._fn(
            eng.params, cache, torch.from_numpy(tokens).to(dev),
            torch.from_numpy(pos).to(dev))
        return logits, ok

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
    # (the generation's graphs share one memory pool of their own)
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

    ``prepare_plan`` builds a generation for another pattern (from any
    thread), ``offer_plan`` stages it, and ``step`` installs it between
    ticks under the ``plan_generation`` counter.  ``attach_replanner`` hooks
    a ``serving.replan.Replanner``.
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
        # the decode steps' restore point: a copy of the recurrent-state
        # leaves, taken before each decode while the serving generation is
        # on probation (from the moment it serves to its first finite decode)
        self._backup = [t.clone() for t in _state_leaves(self.cache)]
        self._probation = True
        # a throwaway cache the decode steps warm on
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
        self._plan_lock = threading.Lock()
        self._pending_plan: Optional[PlanGeneration] = None
        self._trace_memo: dict[tuple, tuple] = {}
        self._replanner = None
        self._events: deque[dict] = deque(maxlen=_EVENT_CAPACITY)
        # ---- fault tolerance (graceful degradation) ----
        self.rollbacks = 0               # faulted generations rolled back
        self.degraded = False            # serving a rollback, not the offer
        self.last_fault: Optional[str] = None
        self._fallbacks: list[PlanGeneration] = []   # healthy gens, newest last
        self._faulted_keys: set[tuple] = set()       # plan keys seen faulting
        # a generation is "healthy" once it has served a full tick without
        # faulting; only healthy generations become rollback targets
        self._gen_healthy = True
        self._gen = self._generation_for(impl)

    # ------------------------------------------------------------------
    # plan generations
    # ------------------------------------------------------------------
    def _make_step(self, fn, fixed: tuple, feeds: dict,
                   warm_fixed=None, pool=None) -> StepGraph:
        return StepGraph(fn, fixed, feeds, warm_fixed=warm_fixed, pool=pool)

    def _template_cache(self) -> dict:
        with self._plan_lock:
            if self._warm_cache is None:
                self._warm_cache = F.init_cache(self.cfg, self.slots,
                                                self.ctx, self.device)
            return self._warm_cache

    def _generation_for(self, impl,
                        plan_seconds: Optional[float] = None) -> PlanGeneration:
        """Build (or reuse from the trace memo) the prefill/decode pair for
        ``impl`` merged over the arch defaults.  Builds no graph and
        installs nothing; thread-safe."""
        merged = Impl({**F.default_impl(self.cfg), **dict(impl or {})})
        key = impl_key(merged)
        with self._plan_lock:
            cached = self._trace_memo.get(key)
            if cached is None:
                # the generation's graphs share a memory pool of its own
                pool = (torch.cuda.graph_pool_handle()
                        if self.device.type == "cuda" else None)
                cached = (
                    _BucketedPrefill(self, F.make_bucketed_prefill_step(
                        self.cfg, impl=merged, ctx=self.ctx), pool),
                    _Decode(self, F.make_serve_step(self.cfg, impl=merged),
                            pool))
                self._trace_memo[key] = cached
        return PlanGeneration(impl=merged, key=key, prefill=cached[0],
                              decode=cached[1], plan_seconds=plan_seconds)

    def prepare_plan(self, impl=None, *, plan_seconds: Optional[float] = None,
                     warm: bool = True) -> PlanGeneration:
        """Build the steps for ``impl`` WITHOUT installing them.

        Safe to call from another thread while the engine keeps ticking: it
        touches no serving state.  With ``warm`` (default) the decode step
        and every prefill bucket the engine has served are built — on a
        card warmed on throwaway inputs and captured on this thread's side
        stream into the generation's own pool — so the post-swap tick
        captures nothing.  The trace memo holds what was built: preparing a
        key again captures nothing.  The returned generation is staged with
        :meth:`offer_plan`."""
        gen = self._generation_for(impl, plan_seconds)
        if warm:
            self._warm(gen)
        return gen

    def _warm(self, gen: PlanGeneration) -> None:
        gen.decode.warm()
        for bucket in sorted(set(self.buckets_seen)):
            gen.prefill.warm(bucket)

    def offer_plan(self, prepared: PlanGeneration) -> None:
        """Stage ``prepared`` for installation at the next tick boundary.

        Thread-safe; the latest offer wins.  The engine installs it at the
        top of the next ``step()`` — never mid-tick — bumping
        ``plan_generation``.  Offering a generation whose canonical key
        equals the serving one is a no-op (no counter bump)."""
        with self._plan_lock:
            self._pending_plan = prepared

    def _install_pending(self) -> None:
        with self._plan_lock:
            prepared, self._pending_plan = self._pending_plan, None
        if prepared is None or prepared.key == self._gen.key:
            return
        if prepared.key in self._faulted_keys:
            return                       # never re-install a plan that faulted
        if self._gen_healthy:
            # keep the outgoing generation as a rollback target — it served
            # at least one full tick without faulting
            self._fallbacks = [g for g in self._fallbacks
                               if g.key != self._gen.key]
            self._fallbacks.append(self._gen)
            del self._fallbacks[:-_FALLBACK_CAPACITY]
        # the incoming generation is no rollback target of its own
        self._fallbacks = [g for g in self._fallbacks if g.key != prepared.key]
        self._gen_healthy = False        # the incoming plan must earn trust
        self._probation = True
        self.degraded = False
        self.plan_generation += 1
        prepared.generation = self.plan_generation
        self._gen = prepared
        self.swaps += 1
        self.swap_ticks.append(self.ticks)
        self._sweep_memo()

    def _sweep_memo(self) -> None:
        """Keep in the trace memo only the generations that serve, are
        pending or are rollback targets.  The others (faulted ones, those
        pushed out of the fallbacks, prepared ones never offered) leave it:
        their graphs and memory pool are freed once nothing else refers to
        them.  A generation being prepared on another thread keeps its
        graphs and re-enters the memo when it is installed."""
        with self._plan_lock:
            live = {g.key: (g.prefill, g.decode)
                    for g in (*self._fallbacks, self._pending_plan, self._gen)
                    if g is not None}
            self._trace_memo = live

    # ------------------------------------------------------------------
    # fault tolerance: guarded plan calls, rollback, canary validation
    # ------------------------------------------------------------------
    def _all_ref_generation(self) -> PlanGeneration:
        """The terminal fallback: every region pinned to its loop-faithful
        ``ref`` variant (overriding any architectural defaults)."""
        return self._generation_for(
            Impl({r: "ref" for r in F.default_impl(self.cfg)}))

    @staticmethod
    def _built_step(gen: PlanGeneration, op: str, args: tuple):
        """(step, its fed inputs) of ``gen``'s ``op`` for ``args``, the step
        built first if it was not (on a card: warmed and captured)."""
        if op == "prefill":
            tokens, n = args
            return (gen.prefill.warm(tokens.shape[1]),
                    (tokens, np.asarray(n, np.int32)))
        return gen.decode.warm(), args

    def _plan_call(self, op: str, args: tuple, sampling: tuple):
        """Run one plan step (``"prefill"`` or ``"decode"``) under the
        runtime guard and sample its last position: returns (tokens, the
        step's cache).

        Build and run are told apart.  A step whose build raises (its
        warm-up or capture on a card; on the CPU its first call, which
        stands in for the capture) is a fault of the plan's code, not of a
        run: the error propagates and nothing rolls back.  A fault seen when
        a built step runs — it raises, or its finite flag comes back False
        with the tokens — rolls the engine back to the last healthy
        generation and the same call is retried.

        A decode writes the live cache in place.  While the serving
        generation is on probation the recurrent-state leaves are backed up
        first, and a rollback restores them.  A decode fault after probation
        in a model with recurrent state cannot be undone: it raises
        ``PlanFault``.  So does a fault of the all-ref plan, which has
        nothing left to roll back to."""
        backed_up = False
        while True:
            gen = self._gen
            step, fed = self._built_step(gen, op, args)
            built = step.built
            if (op == "decode" and self._backup and self._probation
                    and not backed_up):
                torch._foreach_copy_(self._backup, _state_leaves(self.cache))
                backed_up = True
            try:
                logits, cache, finite = step(*fed)
                tokens, ok = self._sample(logits[:, -1], *sampling,
                                          flag=finite)
            except Exception as err:  # noqa: BLE001 — a run's fault of any
                # type routes through rollback; a build's propagates
                if not built:
                    raise
                fault = err
            else:
                if ok:
                    if op == "decode":
                        self._probation = False
                    return tokens, cache
                fault = PlanFault(f"{op} produced non-finite logits under "
                                  f"plan {gen.impl.describe()!r}")
            if op == "decode" and self._backup and not backed_up:
                raise PlanFault(
                    f"decode faulted under plan {gen.impl.describe()!r} "
                    f"after its probation; the recurrent state it overwrote "
                    f"has no backup: {fault}") from fault
            if not self._rollback(gen, op, fault):
                raise fault
            if backed_up:
                torch._foreach_copy_(_state_leaves(self.cache), self._backup)

    def _rollback(self, failed: PlanGeneration, op: str,
                  err: Exception) -> bool:
        """Replace ``failed`` with the newest healthy fallback (all-ref as
        the terminal target).  Returns False when nothing is left to roll
        back to — the caller re-raises."""
        if failed is not self._gen:
            return True                  # already rolled past it: just retry
        self._faulted_keys.add(failed.key)
        self._fallbacks = [g for g in self._fallbacks
                           if g.key not in self._faulted_keys]
        target = None
        while self._fallbacks:
            cand = self._fallbacks.pop()
            if cand.key not in self._faulted_keys:
                target = cand
                break
        if target is None:
            target = self._all_ref_generation()
            if target.key == failed.key:
                return False             # the reference plan itself faulted
        self.plan_generation += 1
        target.generation = self.plan_generation
        self._gen = target
        self._gen_healthy = True         # fallbacks already earned trust
        self._probation = True
        self.rollbacks += 1
        self.degraded = True
        self.last_fault = f"{op}: {err}"
        with self._plan_lock:
            pending = self._pending_plan
            if pending is not None and pending.key in self._faulted_keys:
                self._pending_plan = None
        self._sweep_memo()
        rp = self._replanner
        if rp is not None and hasattr(rp, "on_plan_fault"):
            rp.on_plan_fault(failed.impl, self.last_fault)
        return True

    def _canary_logits(self, gen: PlanGeneration, tokens, pos):
        """(logits, flag, regions reached) of ``gen``'s decode step called
        eagerly on a fresh zero cache."""
        cache = F.init_cache(self.cfg, self.slots, self.ctx, self.device)
        with observe_dispatch() as reached:
            logits, ok = gen.decode.eager(cache, tokens, pos)
        return logits.float(), bool(ok), reached

    def canary_check(self, prepared: PlanGeneration, *,
                     reference: Optional[PlanGeneration] = None
                     ) -> tuple[bool, str]:
        """Validate ``prepared`` on a synthetic batch BEFORE it may serve.

        Runs the candidate's decode step eagerly on a fresh zero cache (one
        token per slot at position 0) and checks that it (a) does not
        raise, (b) produces finite logits, and (c) agrees with the
        reference generation (the serving plan by default) on the same
        inputs:

        * where both run the same decode arithmetic — the same canonical
          gene for every region the decode step reaches — bit for bit, as
          the JAX engine's canary requires;
        * otherwise within ``max(CANARY_NOISE_FACTOR x floor,
          CANARY_TOL_MIN)``, ``floor`` being the noise between two plain
          versions measured here on the same batch: the reference with the
          differing reached regions on ``offload`` against the same with
          them on ``ref``.  The port's ``hopper`` and ``ref`` patterns
          differ by rounding; a wrong kernel (scaled logits) moves the
          logits by O(1).

        Returns ``(ok, reason)``.  Safe off the tick path: it touches no
        serving state."""
        ref = reference if reference is not None else self._gen
        rng = np.random.default_rng(0)
        tokens = rng.integers(0, self.cfg.vocab_size,
                              (self.slots, 1)).astype(np.int32)
        pos = np.zeros(self.slots, np.int32)
        try:
            cand, ok, reached = self._canary_logits(prepared, tokens, pos)
        except Exception as err:  # noqa: BLE001 — any failure mode rejects
            return False, f"canary decode raised: {err}"
        if not ok:
            return False, "canary decode produced non-finite logits"
        if ref is None or prepared.key == ref.key:
            return True, "ok"
        try:
            want, _, ref_reached = self._canary_logits(ref, tokens, pos)
        except Exception as err:  # noqa: BLE001 — a faulting reference
            # cannot veto the candidate; the finite check already passed
            return True, f"reference decode raised ({err}); accepted"
        reached = reached | ref_reached
        differ = sorted(r for r in reached
                        if canonical_gene(r, prepared.impl.get(r, "ref"))
                        != canonical_gene(r, ref.impl.get(r, "ref")))
        if not differ:
            if torch.equal(cand, want):
                return True, "ok (same decode arithmetic, bit-equal)"
            return False, ("canary logits differ bitwise from the serving "
                           "plan under the same decode arithmetic")
        plain = {v: self._generation_for(
            {**ref.impl, **{r: v for r in differ}}) for v in ("offload", "ref")}
        floor = float((self._canary_logits(plain["offload"], tokens, pos)[0]
                       - self._canary_logits(plain["ref"], tokens, pos)[0]
                       ).abs().max())
        tol = max(CANARY_NOISE_FACTOR * floor, CANARY_TOL_MIN)
        diff = float((cand - want).abs().max())
        if diff > tol:
            return False, (f"canary logits differ by {diff:.3e} > tol "
                           f"{tol:.3e} (regions {differ})")
        return True, (f"ok (regions {differ}: max diff {diff:.3e} <= tol "
                      f"{tol:.3e})")

    def attach_replanner(self, replanner) -> None:
        """Hook a ``serving.replan.Replanner``: its ``on_tick(engine)`` runs
        after every tick (trigger evaluation only — search and graph
        building happen off the tick path)."""
        self._replanner = replanner
        attach = getattr(replanner, "attach", None)
        if attach is not None:
            attach(self)

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
            sp = req.sampling
            toks, one_cache = self._plan_call(
                "prefill", (padded, n),
                ([req.rid], [0], [sp.temperature], [sp.top_k]))
            cache_insert(self.cache, one_cache, slot)
            first = int(toks[0])
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
        steps = np.asarray([len(r.generated) if r is not None else 0
                            for r in self.active], np.int32)
        nxt, _ = self._plan_call(
            "decode", (self.last_tok[:, None], self.pos),
            (self._rids, steps, self._temps, self._top_ks))
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
        strictly between ticks), admit, decode, record the tick event, then
        let an attached replanner evaluate its triggers."""
        self.ticks += 1
        self._install_pending()
        admitted = self._admit()
        decoded = self._tick_decode()
        # the serving generation survived a full tick: it is now a trusted
        # rollback target for future swaps
        self._gen_healthy = True
        self._events.append({
            "tick": self.ticks,
            "active": sum(r is not None for r in self.active),
            "queue": len(self.queue),
            "decode_tokens": decoded,
            "admitted": admitted,
        })
        if self._replanner is not None:
            self._replanner.on_tick(self)

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
            "rollbacks": self.rollbacks,
            "degraded": self.degraded,
            "last_fault": self.last_fault,
            "slot_occupancy": active / self.slots if self.slots else 0.0,
        }

    def stats(self, window: Optional[int] = None) -> dict:
        """Serving statistics, in two views (the JAX engine's keys, plus
        ``last_fault``).

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
        ``plan_generation``, ``swaps``, ``rollbacks``, ``degraded``,
        ``last_fault`` (the last rollback's cause, None before any) and
        ``slot_occupancy``."""
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
