"""One run of one cell: set-up, the measured window, the metrics, the
comparison that decides ``correct``, and the result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the result's metrics are the cell's end-to-end ones;
with ``--trace 1`` its per-layer ones, the window's last seconds traced
by ``torch.profiler``.  The last line of standard output is the result, a
JSON object; the last lines of standard error are the numbers compared
for ``correct``, each beside its limit.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# top-level modules the process that prints a result must not hold: JAX
# and the JAX package the port was made from, and its benchmarks
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
_T_IMPORT = time.perf_counter()


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def process_age() -> float:
    """Seconds since this process started (its start time in /proc, to the
    kernel's clock tick), or since this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        boot_now = time.clock_gettime(time.CLOCK_BOOTTIME)
        return boot_now - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter() - _T_IMPORT


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache of the program at a fixed path inside
    the checkout, so that only a checkout's first run builds."""
    build = root / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "repro_torch")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")


def forbidden_modules() -> list[str]:
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


@dataclass
class RunView:
    """What a metric reader reads."""
    window: object          # serve.Window
    dims: object            # counts.Dims
    config: dict
    mix: dict
    trace: object           # trace.Trace or None
    setup_s: float


def _checks(res: dict, rollbacks: int, limits: dict,
            served_tokens: int) -> dict:
    """The numbers compared for ``correct``: name -> value, limit, and
    whether the value may not exceed (``max``) or fall below (``min``)
    it.  The widest gap's limit is the cell's limits file's; the served
    tokens compared are at least the mix's ``check.served_tokens``."""
    return {
        "max_logit_gap": {"value": res["gap"],
                          "limit": float(limits["max_logit_gap"]),
                          "is": "max"},
        "compared_tokens": {"value": res["positions"],
                            "limit": int(served_tokens), "is": "min"},
        "reference_nonfinite": {"value": 0 if res["finite"] else 1,
                                "limit": 0, "is": "max"},
        "rollbacks": {"value": rollbacks, "limit": 0, "is": "max"},
    }


def _spread(res: dict) -> dict:
    return {k: res.get(k) for k in ("gap", "gap_p99", "gap_mean",
                                    "flip_share", "positions")}


def _passes(c: dict) -> bool:
    v = c["value"]
    if not isinstance(v, (int, float)) or math.isnan(v):
        return False
    return v <= c["limit"] if c["is"] == "max" else v >= c["limit"]


def run_cell(spec, workload: str, seed: int, seconds: float, trace: bool,
             device, *, control: bool = False, rate: float | None = None,
             on_window=None) -> dict:
    """Set up, serve the window, read the metrics, free the program's
    state, compare with the reference; returns the result (``checks``
    last).

    ``control``: judge the control (the reference one precision step
    below the served bf16) in the program's place, by the same checks.
    ``readings`` holds how the gaps of the program's served tokens (and
    of the control's) spread, for setting a limit.
    ``rate``: an open-loop mix's arrival rate in place of its file's
    (while a cell's rate is being found).  ``on_window(window)`` is
    called once the window has closed, before the program's state goes.
    """
    import torch

    from bench import check, counts, generator, serve, weights
    from bench import model as M
    from bench.trace import warm_profiler

    cell = spec.workload(workload)
    config = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    if rate is not None:
        mix["rate_rps"] = float(rate)
    limits = spec.limits(workload)
    dims = counts.Dims.from_config(config)
    cuda = device.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.synchronize(device)      # the device's first use
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    cfg = M.port_config(config)
    tree = weights.draw(dims, seed, device)
    params = weights.params(tree)
    M.check_layout(cfg, params)
    if cuda:
        torch.cuda.synchronize(device)
    t_weights = time.perf_counter() - t
    plan = generator.schedule(mix, seed, seconds, dims.vocab)
    log(f"bench: {workload}: {generator.describe(mix, plan)}")
    eng = M.engine(cfg, params, mix, config, seed)
    t = time.perf_counter()
    bucket_list = M.buckets(plan, int(mix["ctx"]))
    M.warm(eng, bucket_list, dims.vocab, seed)
    if trace:
        warm_profiler(device)
    if cuda:
        torch.cuda.synchronize(device)
    t_warm = time.perf_counter() - t
    setup_s = process_age()
    log(f"bench: set-up {setup_s:.3f} s: weights {weights.nbytes(tree) / 1e9:.2f}"
        f" GB drawn in {t_weights:.3f} s; buckets {bucket_list} and the "
        f"decode graph captured and replayed in {t_warm:.3f} s "
        f"({eng.prefill_traces} prefill captures)")

    win = serve.run(eng, plan, seconds,
                    trace=mix["trace"] if trace else None,
                    drain=mix["kind"] == "open_loop")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if on_window is not None:
        on_window(win)
    st = eng.stats()
    rollbacks = int(st["rollbacks"])
    late = [s.submitted - s.due for s in win.served]
    log(f"bench: window {win.seconds:.3f} s, {len(win.window_ticks())} ticks;"
        f" drain to {win.end - win.t_close:.3f} s past the close; generator "
        f"lateness max {max(late, default=0) * 1e3:.3f} ms, mean "
        f"{(sum(late) / len(late) if late else 0) * 1e3:.3f} ms over "
        f"{len(late)} requests; {win.refused} refused; engine rollbacks "
        f"{rollbacks}, prefill captures {st['prefill_traces']}")
    tr = win.tracer.result() if trace else None
    view = RunView(win, dims, config, mix, tr, setup_s)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.metrics(workload, kind):
        v = spec.reader(m["name"]).read(view)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    measured = win.measured()
    finished = [s.req for s in measured if s.req.done]
    if mix["kind"] == "open_loop":
        # every request due in the window; one never answered failed
        attempted = len(measured) + win.refused
        failed = win.refused + sum(1 for s in measured if not s.times)
    else:
        # the queue holds more than a window serves: the requests started
        attempted = sum(1 for s in measured if s.times) + win.refused
        failed = win.refused

    # the program's state goes before the reference runs
    del eng, st
    win.tracer = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    chk = mix["check"]
    picked = check.sample(finished, seed, chk["served_tokens"],
                          chk["requests"])
    res = check.judge(params, config, picked, control=control)
    log(f"bench: reference over {res['requests']} of {len(finished)} "
        f"finished requests, {res['positions']} served tokens, in "
        f"{time.perf_counter() - t:.3f} s; served tokens below the "
        f"reference's best: {res['flipped']}; widest gap {res['gap']}")
    readings = {"program": _spread(res)}
    if control:
        log(f"bench: the control in the program's place: "
            f"{res['control_flipped']} tokens below the reference's best; "
            f"widest gap {res['control_gap']}")
        res = {**res, **{k[len("control_"):]: v for k, v in res.items()
                         if k.startswith("control_")}}
        readings["control"] = _spread(res)
    checks = _checks(res, rollbacks, limits, chk["served_tokens"])
    out = {"correct": all(_passes(c) for c in checks.values()),
           "attempted": attempted,
           "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else device.type,
                      "kind": (torch.cuda.get_device_name(device) if cuda
                               else device.type),
                      "count": 1,
                      "memory_peak_bytes": int(peak)}}
    if tr is not None:
        out["device"]["busy_s"] = tr.busy_s
        out["device"]["window_s"] = tr.window_s
        out["breakdown"] = tr.breakdown()
    out["readings"] = readings
    out["checks"] = {k: {**c, "passes": _passes(c)}
                     for k, c in checks.items()}
    return out


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cache_dirs(ROOT)
    from bench.spec import Spec
    spec = Spec(ROOT)
    cell = spec.workload(args.workload)
    import torch
    if not torch.cuda.is_available():
        log("bench: torch.cuda.is_available() is False; no result")
        return 3
    if torch.cuda.device_count() < int(cell["chips"]):
        log(f"bench: {torch.cuda.device_count()} cards, the cell needs "
            f"{cell['chips']}; no result")
        return 3
    device = torch.device("cuda:0")
    out = run_cell(spec, args.workload, args.seed, args.seconds,
                   bool(args.trace), device)
    bad = forbidden_modules()
    if bad:
        log(f"bench: the process holds {bad}; no result")
        return 4
    for k, c in out["checks"].items():
        op = "<=" if c["is"] == "max" else ">="
        log(f"check {k}: {c['value']} {op} {c['limit']}: "
            f"{'pass' if c['passes'] else 'FAIL'}")
    print(json.dumps(out), flush=True)
    return 0
