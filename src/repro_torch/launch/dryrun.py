"""Multi-device dry-run: run one step of every (arch x shape x mesh) cell
on fake devices — the port of the JAX package's ``launch/dryrun.py``.

JAX lowers and compiles each cell for 256 or 512 fake host devices and
reads XLA's memory and cost analyses.  The port runs the cell's step once,
in one process, on a ``"fake"`` process group of that many ranks (its
collectives move nothing) under ``FakeTensorMode`` (tensors with shapes
and no storage): the params, train state, batch and cache are DTensors
laid out by ``launch/shardings.py``, rank 0 allocating its blocks, and the
train, prefill or decode step runs under ``parallel_context`` with the
arch's default impl (no Hopper kernel, as JAX's dry-run uses no Pallas
kernel).  ``launch/step_analysis.py`` counts what rank 0 runs.  For each
cell this shows (a) the sharding rules and the mesh code path run the
step, and records (b) per-device memory, flops, HBM bytes and collective
bytes for ``launch/roofline.py``, and (c) the ops DTensor could not shard
and the context gathered (``gathered``).

The record is JAX's JSONL: ``status`` ok/skip/error, ``devices``,
``pcfg``, ``memory.{argument,output,temp}_bytes``, ``hlo_cost`` (per-device
``flops``/``hbm_bytes``/``transcendentals``...) and ``collectives``.

Usage:
  python -m repro_torch.launch.dryrun --all                # every cell, both meshes
  python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k --mesh multi
  python -m repro_torch.launch.dryrun --arch recurrentgemma-2b --shape train_4k \\
      --devices 8 --mesh-shape 4,2 --reduced     # CI-sized smoke
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs.base import (ARCH_IDS, SHAPES, get_config,
                                      shape_applicable)
from repro_torch.core.regions import Impl
from repro_torch.launch import shardings as SH
from repro_torch.launch.mesh import PRODUCTION_SHAPES
from repro_torch.launch.step_analysis import StepCounter
from repro_torch.models import factory as F
from repro_torch.models import lm
from repro_torch.models.params import tree_map
from repro_torch.parallel.ctx import parallel_context
from repro_torch.parallel.presets import parallelism_for
from repro_torch.parallel.rules import (batch_shardings, local_shape,
                                        tree_shardings)
from repro_torch.runtime import steps as RS


def mesh_layout(mesh_kind: str, mesh_shape: str | None):
    """(shape, axes) of a production mesh or of ``--mesh-shape``."""
    if mesh_shape:
        dims = tuple(int(x) for x in mesh_shape.split(","))
        axes = (("pod", "data", "model") if len(dims) == 3
                else ("data", "model"))
        return dims, axes
    return PRODUCTION_SHAPES[mesh_kind == "multi"]


def fake_mesh(shape, axes):
    """A ``DeviceMesh`` over a fake process group of prod(shape) ranks
    (this process is rank 0); the group is made anew when its size
    differs."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = math.prod(shape)
    if dist.is_initialized() and dist.get_world_size() != n:
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def _laid_out(meta, shardings):
    """Meta tensors as DTensors laid out by ``shardings``, this rank
    holding empty blocks (call under ``FakeTensorMode``)."""
    from torch.distributed.tensor import DTensor

    if isinstance(meta, dict):
        return {k: _laid_out(v, shardings[k]) for k, v in meta.items()}
    sh = shardings
    block = torch.empty(local_shape(tuple(meta.shape), sh.spec, sh.mesh),
                        dtype=meta.dtype)
    return DTensor.from_local(block, sh.mesh, sh.placements, run_check=False,
                              shape=meta.shape, stride=meta.stride())


def _meta_tree(template):
    return tree_map(lambda s: torch.empty(s.shape, dtype=getattr(torch,
                                                                 s.dtype),
                                          device="meta"), template)


def lower_cell(arch: str, shape_name: str, mesh_kind: str,
               mesh_shape: str | None = None, reduced: bool = False,
               pcfg_override: dict | None = None,
               impl_override: dict | None = None) -> dict:
    """Run one cell's step on fake devices and return its record."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    shape = SHAPES[shape_name]
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                 "reduced": reduced}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        rec.update(status="skip", why=why)
        return rec

    dims, axes = mesh_layout(mesh_kind, mesh_shape)
    model_axis = dict(zip(axes, dims)).get("model", 1)
    pcfg = parallelism_for(cfg, shape, model_axis=model_axis)
    real = {k: v for k, v in (pcfg_override or {}).items()
            if not k.startswith("_")}
    if real:
        pcfg = dataclasses.replace(pcfg, **real)
    rec["devices"] = math.prod(dims)
    rec["pcfg"] = {"tp": pcfg.tp, "fsdp": pcfg.fsdp, "remat": pcfg.remat,
                   "microbatch": pcfg.microbatch, "sp": pcfg.sp}
    impl = F.default_impl(cfg)
    if impl_override:
        impl = Impl({**impl, **impl_override})
        rec["impl"] = dict(impl)

    t0 = time.perf_counter()
    try:
        mesh = fake_mesh(dims, axes)
        counter = StepCounter()
        with FakeTensorMode():
            b, s = shape.global_batch, shape.seq_len
            if shape.kind == "train":
                step = RS.make_train_step(cfg, pcfg, impl=impl)
                (state_sh, batch_sh), out_sh = SH.train_shardings(
                    cfg, shape, mesh, pcfg)
                args = (_laid_out(RS.abstract_train_state(cfg), state_sh),
                        _laid_out(F.batch_spec(cfg, shape), batch_sh))
            elif shape.kind == "prefill":
                step = RS.make_prefill_step(cfg, ctx=s + cfg.n_front,
                                            impl=impl)
                (p_sh, batch_sh), out_sh = SH.prefill_shardings(
                    cfg, shape, mesh, pcfg)
                args = (_laid_out(F.abstract_params(cfg), p_sh),
                        _laid_out(F.batch_spec(cfg, shape), batch_sh))
            else:  # decode
                in_sh, out_sh = SH.serve_shardings(cfg, shape, mesh, pcfg)
                specs = F.input_specs(cfg, shape)
                tok = batch_shardings(specs, mesh, pcfg)
                if pcfg_override and pcfg_override.get("_quant"):
                    from repro_torch.optim.quantize import quantized_template
                    qt = quantized_template(lm.model_template(cfg))
                    step = F.make_quantized_serve_step(cfg, impl=impl)
                    params = _laid_out(_meta_tree(qt),
                                       tree_shardings(qt, mesh, pcfg))
                    rec["quant_weights"] = True
                else:
                    step = RS.make_serve_step(cfg, impl=impl)
                    params = _laid_out(F.abstract_params(cfg), in_sh[0])
                args = (params,
                        _laid_out(F.abstract_cache(cfg, b, s), in_sh[1]),
                        _laid_out(specs["tokens"], tok["tokens"]),
                        _laid_out(specs["pos"], tok["pos"]))
            counter.arguments(args)
            t1 = time.perf_counter()
            with counter, parallel_context(mesh, pcfg) as pc:
                out = SH.distribute(step(*args), out_sh)
            rec["run_s"] = round(time.perf_counter() - t1, 2)
            counter.outputs(out)
            del out, args
        cost = counter.cost
        rec["memory"] = cost.memory_json()
        rec["hlo_cost"] = cost.to_json()     # per-device, local shards
        rec["collectives"] = {"bytes": dict(cost.collective_bytes),
                              "counts": dict(cost.collective_counts),
                              "total_bytes": cost.total_collective_bytes}
        rec["gathered"] = dict(pc.gathered)
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.perf_counter() - t0, 2)
    return rec


def already_done(out_path: str) -> set[tuple[str, str, str]]:
    done = set()
    if os.path.exists(out_path):
        with open(out_path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if r.get("status") in ("ok", "skip"):
                    done.add((r["arch"], r["shape"], r["mesh"]))
    return done


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true",
                    help="all cells, both meshes")
    ap.add_argument("--devices", type=int, default=None,
                    help="fake ranks (must equal the --mesh-shape product)")
    ap.add_argument("--mesh-shape", default=None, help="e.g. 4,2 or 2,2,2")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch.jsonl")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fsdp", default=None, choices=["on", "off"])
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--remat", default=None,
                    choices=["none", "dots", "full", "2level"])
    ap.add_argument("--impl", default=None,
                    help="region=variant[,region=variant] offload override")
    ap.add_argument("--quant-weights", action="store_true",
                    help="int8 weight quantization (decode cells)")
    ap.add_argument("--sp", default=None, choices=["on", "off"])
    args = ap.parse_args(argv)
    if args.devices is not None and args.mesh_shape and math.prod(
            int(x) for x in args.mesh_shape.split(",")) != args.devices:
        ap.error(f"--devices {args.devices} differs from the product of "
                 f"--mesh-shape {args.mesh_shape}")

    over: dict = {}
    if args.fsdp:
        over["fsdp"] = args.fsdp == "on"
    if args.microbatch is not None:
        over["microbatch"] = args.microbatch
    if args.remat:
        over["remat"] = args.remat
    if args.sp:
        over["sp"] = args.sp == "on"
    if args.quant_weights:
        over["_quant"] = True
    impl_over = (dict(kv.split("=") for kv in args.impl.split(","))
                 if args.impl else None)

    if args.all:
        cells = [(a, s, m) for a in ARCH_IDS for s in SHAPES
                 for m in ("single", "multi")]
    else:
        cells = [(a, s, args.mesh)
                 for a in ([args.arch] if args.arch else list(ARCH_IDS))
                 for s in ([args.shape] if args.shape else list(SHAPES))]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = already_done(args.out) if args.resume else set()
    records = []
    with open(args.out, "a") as f:
        for arch, shape, mesh in cells:
            if (arch, shape, mesh) in done:
                print(f"[dryrun] SKIP (done) {arch} {shape} {mesh}",
                      flush=True)
                continue
            print(f"[dryrun] {arch} {shape} {mesh} ...", flush=True)
            rec = lower_cell(arch, shape, mesh, mesh_shape=args.mesh_shape,
                             reduced=args.reduced, pcfg_override=over or None,
                             impl_override=impl_over)
            f.write(json.dumps(rec) + "\n")
            f.flush()
            records.append(rec)
            extra = rec.get("why") or rec.get("error", "")
            print(f"[dryrun]   -> {rec['status']} ({rec.get('total_s', 0)}s)"
                  f" {extra}", flush=True)
    print("[dryrun] done")
    return records


if __name__ == "__main__":
    main()
