"""Static extraction on the port: recognizer accuracy and discovery-driven
planning — the twin of ``benchmarks/loop_extraction.py --extraction``.

Three sections:

1. accuracy — ``core/extract.py`` scored against the hand-annotated
   programs: the families ``make_lm_program(arch)`` registers by hand on
   mistral-nemo-12b, falcon-mamba-7b, recurrentgemma-2b, mixtral-8x7b,
   whisper-small and paligemma-3b (plus ``rmsnorm``, which every LM arch
   contains), and tdFIR's ``fir_bank``, are the ground truth.  The
   recognizers must reach 0.9 precision AND 0.9 recall micro-averaged and
   **per family** over the nine families, and each family must have a
   ground-truth case.  The archs are captured on fake tensors (a frontend
   arch's patches or frames too): without ``--reduced`` at full width and
   full depth, which allocates nothing.  Stitched ``left+right`` regions
   sit outside the scored universe (they are derived, not annotated).
2. autoplan — ``discover`` + ``AutoOffloader.plan`` on the six archs'
   reduced all-ref forwards (random weights from a seeded generator; the
   frontend archs' synthetic patches or frames closed over, as the JAX
   benchmark does), with nobody's annotations: >= 2 regions each, the
   re-plan must hit the plan cache, mixtral's routed block must be a
   ``moe_dispatch`` region, and whisper's stem and MLPs ``conv_stem`` and
   ``mlp_gelu`` regions.
3. stitch — Mistral-NeMo's fused ``rmsnorm+mlp_core`` region planned
   against its split halves: the fused region is measured first-class and
   its presence re-keys the plan cache.

The plans run on the reduced models, as the JAX benchmark's do.

``--conditions`` runs the paper's §5.1.2 evaluation-conditions table
instead (the twin of ``benchmarks/loop_extraction.py``'s default
section): tdFIR and MRI-Q through Steps 1-4 with the paper's budgets, one
row each: loop statements in the C source (tdFIR 36, MRI-Q 16), loops the
Step-1 census traced, regions, the widths after the arithmetic-intensity
filter (a <= 5) and the resource-efficiency filter (c <= 3), and the
patterns measured (d <= 4).  ``--json PATH`` writes the rows as a
``{"section": "conditions", ...}`` document, or, without
``--conditions``, the accuracy and autoplan rows as a ``{"section":
"extraction", ...}`` one.  Entry points default to ``cuda``:

    PYTHONPATH=src python -m repro_torch.launch.loop_extraction [--explain]
    PYTHONPATH=src python -m repro_torch.launch.loop_extraction \\
        --device cpu --reduced
    PYTHONPATH=src python -m repro_torch.launch.loop_extraction \\
        --conditions [--device cpu --reduced] [--json PATH]
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time

import torch

from repro_torch.apps import mriq, tdfir
from repro_torch.configs.base import get_config
from repro_torch.configs.paper_apps import TDFIR_FULL, MriQConfig, TdFirConfig
from repro_torch.core.device import backend_name, resolve_device
from repro_torch.core.extract import FAMILIES, discover, extract
from repro_torch.core.plan_cache import PlanCache, plan_cache_key
from repro_torch.core.planner import AutoOffloader, PlannerConfig
from repro_torch.core.regions import Impl
from repro_torch.models import factory as F
from repro_torch.models.offload_program import make_lm_program
from repro_torch.models.params import DTYPES, tree_map

UNIVERSE = frozenset(FAMILIES)
ARCHS = ("mistral-nemo-12b", "falcon-mamba-7b", "recurrentgemma-2b",
         "mixtral-8x7b", "whisper-small", "paligemma-3b")
SEQ = 32
TDFIR_SMALL = TdFirConfig(n_banks=4, n_taps=16, n_samples=256)


def trace_arch(arch: str, seq: int = SEQ, *, device, reduced: bool = True,
               concrete: bool = True):
    """``(fn, args)`` for an arch's all-ref forward (``fn(tokens)``; a
    frontend arch's synthetic patches or frames are closed over, as its
    weights are).  ``concrete``: weights drawn from a seeded generator on
    ``device`` and real tokens; else fake weights and tokens on
    ``device``, which hold no memory (a full-width capture on any
    machine)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    dev = torch.device(device)
    cfg = get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    fwd = F.make_forward(cfg, Impl())
    batch = {k: torch.from_numpy(v)
             for k, v in F.synthetic_batch(cfg, 1, seq, seed=1).items()}
    if concrete:
        params = F.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
        batch = {k: v.to(dev) for k, v in batch.items()}
    else:
        with FakeTensorMode(allow_non_fake_inputs=True) as mode:
            params = tree_map(lambda s: torch.empty(
                s.shape, dtype=DTYPES[s.dtype], device=dev), F.template(cfg))
            batch = {k: mode.from_tensor(v).to(dev) for k, v in batch.items()}
    tokens = batch.pop("tokens")
    return (lambda t: fwd(params, {"tokens": t, **batch})), (tokens,)


def ground_truth_cases(device, *, reduced: bool, seq: int = SEQ):
    """(name, fn, args, annotated-family set) per scored program."""
    cases = []
    for arch in ARCHS:
        fn, args = trace_arch(arch, seq, device=device, reduced=reduced,
                              concrete=False)
        annotated = {r.name for r in make_lm_program(arch, device=device)
                     .regions} & UNIVERSE
        # every LM arch normalizes with rms_norm blocks; the annotated path
        # doesn't register them as regions (the models call the layer
        # directly) but their presence in the graph is ground truth
        annotated.add("rmsnorm")
        cases.append((arch, fn, args, annotated))
    # tdfir exercises fir_bank (the paper's app #1)
    cfg = TDFIR_SMALL if reduced else TDFIR_FULL
    prog = tdfir.make_program(cfg, cfg, device=device)
    cases.append(("tdfir", prog.build(Impl()),
                  prog.sample_inputs(0, prog.device),
                  {r.name for r in prog.regions} & UNIVERSE))
    return cases


def run_accuracy(device, *, reduced: bool, seq: int = SEQ,
                 explain: bool = False):
    """Per-program recognizer hits vs annotation; micro AND per-family
    precision/recall.  Returns (rows, precision, recall, per_family)."""
    rows = []
    fam = {f: {"tp": 0, "fp": 0, "fn": 0} for f in sorted(UNIVERSE)}
    for name, fn, args, annotated in ground_truth_cases(device, reduced=reduced,
                                                        seq=seq):
        t0 = time.perf_counter()
        report = extract(fn, args, name=name)
        seconds = time.perf_counter() - t0
        found = {m.family for m in report.legal_matches}
        claimed = found & UNIVERSE
        for fa in claimed & annotated:
            fam[fa]["tp"] += 1
        for fa in claimed - annotated:
            fam[fa]["fp"] += 1
        for fa in annotated - claimed:
            fam[fa]["fn"] += 1
        rows.append({
            "app": name,
            "annotated": ",".join(sorted(annotated)),
            "discovered": ",".join(sorted(claimed)),
            "beyond_annotation": ",".join(sorted(found - UNIVERSE)),
            "tp": len(claimed & annotated),
            "fp": len(claimed - annotated),
            "fn": len(annotated - claimed),
            "rejections": len(report.rejections),
            "nodes": len(report.graph_module.graph.nodes),
            "loops": report.loop_count,
            "matches": len(report.legal_matches),
            "seconds": seconds,
        })
        if explain:
            print(f"--- {name} ---")
            print(report.summary())
    tp = sum(s["tp"] for s in fam.values())
    fp = sum(s["fp"] for s in fam.values())
    fn = sum(s["fn"] for s in fam.values())
    per_family = {
        f: {**s,
            "precision": s["tp"] / (s["tp"] + s["fp"])
            if s["tp"] + s["fp"] else 1.0,
            "recall": s["tp"] / (s["tp"] + s["fn"])
            if s["tp"] + s["fn"] else 1.0}
        for f, s in fam.items()}
    precision = tp / (tp + fp) if tp + fp else 1.0
    recall = tp / (tp + fn) if tp + fn else 1.0
    return rows, precision, recall, per_family


def print_accuracy(rows, precision, recall, per_family) -> None:
    """The accuracy table, and the 0.9 gates (raises when one fails)."""
    print("app,annotated,discovered,beyond_annotation,tp,fp,fn,rejections,"
          "graph_nodes,loops,legal_matches,capture_and_extract_s")
    for r in rows:
        print(f"{r['app']},{r['annotated']},{r['discovered']},"
              f"{r['beyond_annotation']},{r['tp']},{r['fp']},{r['fn']},"
              f"{r['rejections']},{r['nodes']},{r['loops']},{r['matches']},"
              f"{r['seconds']:.2f}")
    print(f"micro_precision={precision:.3f} micro_recall={recall:.3f}")
    print("family,tp,fp,fn,precision,recall")
    for fa, s in sorted(per_family.items()):
        print(f"{fa},{s['tp']},{s['fp']},{s['fn']},"
              f"{s['precision']:.3f},{s['recall']:.3f}")
    gates = [(precision >= 0.9, f"recognizer precision {precision:.3f} < 0.9"),
             (recall >= 0.9, f"recognizer recall {recall:.3f} < 0.9")]
    for fa, s in per_family.items():
        # a family nothing in the ground truth exercises would pass any
        # gate vacuously — that's a benchmark hole, fail loudly
        gates += [(s["tp"] + s["fn"] > 0,
                   f"no ground-truth program contains {fa}"),
                  (s["recall"] >= 0.9, f"{fa}: recall {s['recall']:.3f} < 0.9"),
                  (s["precision"] >= 0.9,
                   f"{fa}: precision {s['precision']:.3f} < 0.9")]
    failed = [why for ok, why in gates if not ok]
    if failed:
        raise AssertionError("; ".join(failed))


def run_autoplan(device, *, reps: int = 1, seq: int = SEQ) -> list[dict]:
    """discover() + plan + cached re-plan on the reduced archs."""
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        cache = PlanCache(f"{tmp}/plans.json")
        for arch in ARCHS:
            fn, args = trace_arch(arch, seq, device=device)
            prog = discover(fn, args, name=arch)
            planner = AutoOffloader(PlannerConfig(
                max_measurements=3, reps=reps, warmup=0))
            first = planner.plan(prog, cache=cache)
            replan = planner.plan(prog, cache=cache)
            rows.append({
                "app": arch,
                "regions": len(prog.regions),
                "families": ",".join(sorted(r.name for r in prog.regions)),
                "best_pattern": dict(first.best_pattern or {}),
                "plan_speedup": first.speedup,
                "measured": len(first.measurements),
                "cached_replan": bool(replan.from_cache
                                      and not replan.measurements),
            })
    return rows


def run_stitch_demo(device, *, reps: int = 1, seq: int = SEQ) -> dict:
    """Plan Mistral-NeMo's fused ``rmsnorm+mlp_core`` region against its
    split form: the stitched region must be proposed and measured
    first-class, and its presence must re-key the plan cache."""
    fn, args = trace_arch("mistral-nemo-12b", seq, device=device)
    fused_fams = ("rmsnorm", "mlp_core", "rmsnorm+mlp_core")
    prog = discover(fn, args, name="mistral-stitch", families=fused_fams)
    fused = sorted(r.name for r in prog.regions if "+" in r.name)
    if not fused:
        raise AssertionError("no stitched region discovered on "
                             "mistral-nemo-12b")
    cfg = PlannerConfig(max_measurements=6, reps=reps, warmup=0,
                        strategy="staged")
    rep = AutoOffloader(cfg).plan(prog)
    measured = {g for m in rep.measurements for g in (m.mapping() or {})}
    if fused[0] not in measured or not measured & set(fused[0].split("+")):
        raise AssertionError(f"stitched region {fused[0]} and its split form "
                             f"not both measured (got {sorted(measured)})")
    # fused regions are first-class in the plan-cache key: the same program
    # extracted without stitching keys differently
    split_prog = discover(fn, args, name="mistral-stitch",
                          families=("rmsnorm", "mlp_core"))
    backend = backend_name(prog.device)
    key_fused = plan_cache_key(prog, cfg, backend)
    key_split = plan_cache_key(split_prog, cfg, backend)
    if key_fused == key_split:
        raise AssertionError("fused/split region choice not reflected in the "
                             "plan-cache key")
    return {
        "app": "mistral-stitch",
        "fused_regions": ",".join(fused),
        "measured_genes": ",".join(sorted(measured)),
        "best_pattern": dict(rep.best_pattern or {}),
        "fused_key": key_fused,
        "split_key": key_split,
    }


MRIQ_SMALL = MriQConfig(num_x=300, num_k=200)


def run_conditions(device, *, reps: int = 2,
                   reduced: bool = False) -> list[dict]:
    """The paper's §5.1.2 conditions table: one staged plan per app with
    the paper's budgets, and its stage widths."""
    apps = (("tdfir", lambda: tdfir.make_program(TDFIR_SMALL, TDFIR_SMALL,
                                                 device=device)
             if reduced else tdfir.make_program(device=device)),
            ("mriq", lambda: mriq.make_program(MRIQ_SMALL, MRIQ_SMALL,
                                               device=device)
             if reduced else mriq.make_program(device=device)))
    rows = []
    for name, make in apps:
        rep = AutoOffloader(PlannerConfig(reps=reps)).plan(make())
        rows.append({
            "app": name,
            "source_loops": rep.source_loop_count,
            "traced_loops": rep.loop_count,
            "regions": len(rep.candidates),
            "after_ai": len(rep.ai_selected),
            "after_eff": len(rep.eff_selected),
            "measured": len(rep.measurements),
            "strategy": rep.strategy,
            "speedup": rep.speedup,
        })
    return rows


def main_conditions(device, *, reps: int = 2, reduced: bool = False,
                    json_path: str | None = None) -> list[dict]:
    """Print the conditions table (with the paper's bounds asserted) and
    write it to ``json_path`` when given."""
    rows = run_conditions(device, reps=reps, reduced=reduced)
    print("app,source_loops,traced_loops,regions,after_ai(a<=5),"
          "after_eff(c<=3),measured(d<=4)")
    for r in rows:
        print(f"{r['app']},{r['source_loops']},{r['traced_loops']},"
              f"{r['regions']},{r['after_ai']},{r['after_eff']},"
              f"{r['measured']}")
        if r["after_ai"] > 5 or r["after_eff"] > 3 or r["measured"] > 4:
            raise AssertionError(f"{r['app']}: stage widths {r} exceed the "
                                 "paper's budgets a=5, c=3, d=4")
    if json_path:
        with open(json_path, "w") as f:
            json.dump({"section": "conditions",
                       "backend": backend_name(device), "rows": rows}, f,
                      indent=2, sort_keys=True)
        print(f"# wrote {json_path}")
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; raises without a card)")
    ap.add_argument("--reduced", action="store_true",
                    help="score the reduced archs and tdFIR's small set "
                         "(default: full width and depth, on fake tensors); "
                         "with --conditions: plan the apps at small sizes")
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--explain", action="store_true",
                    help="print each program's full extraction summary "
                         "incl. rejection diagnostics")
    ap.add_argument("--conditions", action="store_true",
                    help="run the paper's conditions table instead")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the section's rows here")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    if a.conditions:
        return {"conditions": main_conditions(
            dev, reps=max(a.reps, 2), reduced=a.reduced, json_path=a.json)}
    acc = run_accuracy(dev, reduced=a.reduced, explain=a.explain)
    print_accuracy(*acc)

    plan_rows = run_autoplan(dev, reps=a.reps)
    print("app,regions,families,plan_speedup,measured,cached_replan")
    for r in plan_rows:
        print(f"{r['app']},{r['regions']},{r['families']},"
              f"{r['plan_speedup']:.2f},{r['measured']},{r['cached_replan']}")
        if r["regions"] < 2 or not r["cached_replan"]:
            raise AssertionError(f"{r['app']}: {r['regions']} discovered "
                                 f"regions (want >= 2), re-plan from the "
                                 f"cache: {r['cached_replan']}")
    # the MoE arch must auto-plan with its routed block as a region, and
    # whisper with its stem and gelu MLPs
    for arch, want in (("mixtral-8x7b", {"moe_dispatch"}),
                       ("whisper-small", {"conv_stem", "mlp_gelu"})):
        row = next(r for r in plan_rows if r["app"] == arch)
        if not want <= set(row["families"].split(",")):
            raise AssertionError(f"{arch} auto-plan lost {sorted(want)}: "
                                 f"{row['families']}")

    stitch_row = run_stitch_demo(dev, reps=a.reps)
    print(f"stitch: fused={stitch_row['fused_regions']} "
          f"measured={stitch_row['measured_genes']} "
          f"best={stitch_row['best_pattern']}")
    if a.json:
        rows, precision, recall, per_family = acc
        with open(a.json, "w") as f:
            json.dump({"section": "extraction", "backend": backend_name(dev),
                       "precision": precision, "recall": recall,
                       "per_family": per_family, "stitch": stitch_row,
                       "rows": rows + plan_rows}, f, indent=2,
                      sort_keys=True)
        print(f"# wrote {a.json}")
    return {"accuracy": acc, "autoplan": plan_rows, "stitch": stitch_row}


if __name__ == "__main__":
    main()
