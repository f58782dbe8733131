"""Multi-rank checks of the port's mesh code, run as CPU processes over
gloo (the tests that hold them against the JAX package read what these
write).  One job a call, all of its checks in one spawn of 4 ranks:

    python tests/torch_mesh_worker.py JOB OUTDIR

``parallel``: GPipe stages, placements' block order, the kernel entry
points under a mesh, the embedding's backward on a DTensor table, elastic
restore, shard_batch, and qwen2-72b (reduced) trained on 2x2, then on 1x1
and with no mesh by rank 0 alone.
``families``: every family's train and serve steps on 2x2.
``compression``: the int8 all-reduce.  Each rank's process group times out after PG_TIMEOUT_S.
"""
from __future__ import annotations

import datetime
import functools
import json
import os
import socket
import sys
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "src"
sys.path.insert(0, str(SRC))

WORLD = 4
PG_TIMEOUT_S = 120
QWEN_STEPS = 5
# one arch a family: hybrid, dense, MoE, SSM, VLM, audio; the hybrid's
# train step under the dots remat, the others' without remat
FAMILY_ARCHS = ("recurrentgemma-2b", "qwen2-72b", "mixtral-8x7b",
                "falcon-mamba-7b", "paligemma-3b", "whisper-small")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _init(rank: int, world: int, port: int):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)        # 4 ranks on a shared CPU
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))


def _dump(out: Path, name: str, obj) -> None:
    (out / name).write_text(json.dumps(obj))


def _pl(placements) -> list:
    """Placements as "S<dim>" / "R" / "P" (their str differs between
    torch releases)."""
    return [f"S{p.dim}" if p.is_shard() else "R" if p.is_replicate()
            else "P" for p in placements]


def _timed(name, fn, *args):
    import time
    t0 = time.perf_counter()
    fn(*args)
    print(f"[worker] {name} {time.perf_counter() - t0:.1f} s",
          file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# parallel
# ---------------------------------------------------------------------------
def _pipeline(rank, out):
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.parallel.pipeline import pipeline_apply

    mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("pod",))
    data = np.load(out / "pipeline_in.npz")
    stack = {"w": torch.from_numpy(data["w"])}
    x = torch.from_numpy(data["x"])
    unit = lambda c, p: torch.tanh(c @ p["w"])
    ref = x
    for i in range(stack["w"].shape[0]):
        ref = unit(ref, {"w": stack["w"][i]})
    res = {}
    for mb in (2, 4, 8):
        y = pipeline_apply(stack, x, unit_body=unit, mesh=mesh, axis="pod",
                           microbatches=mb)
        res[mb] = float((y - ref).abs().max())
        if rank == 0:
            np.save(out / f"pipeline_out_{mb}.npy", y.numpy())
    if rank == 0:
        _dump(out, "pipeline.json", res)


def _placements(rank, out):
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.parallel.rules import placements

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
    x = torch.arange(16.0).reshape(8, 2)
    d = distribute_tensor(x, mesh, placements((("pod", "data"), None), mesh))
    pod, data = mesh.get_coordinate()
    block = pod * 2 + data                 # JAX: pod-major
    ok = bool(torch.equal(d.to_local(), x[2 * block:2 * block + 2]))
    got = [None] * WORLD
    import torch.distributed as dist
    dist.all_gather_object(got, ok)
    if rank == 0:
        _dump(out, "placements.json", {"blocks_in_jax_order": all(got),
                                       "placements": _pl(d.placements)})


def _kernels(rank, out):
    """The Hopper entry points under a 2x2 mesh on the CPU: the helper
    gathers the DTensors, and the wrapper's plain version runs on them."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rglru_scan as RG
    from repro_torch.kernels import rmsnorm as RN

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(4, 4, 32, 16, generator=g) for _ in range(3))
    a = torch.rand(4, 32, 8, generator=g)
    bb = torch.randn(4, 32, 8, generator=g)
    h0 = torch.randn(4, 8, generator=g)
    x = torch.randn(4, 16, 64, generator=g)
    w = torch.randn(64, generator=g)
    heads = [Shard(0), Shard(1)]
    dq, dk, dv = (distribute_tensor(t, mesh, heads) for t in (q, k, v))
    with torch.no_grad():
        errs = {}
        o = FA.flash_attention(dq, dk, dv, causal=True)
        errs["flash_attention"] = (_pl(o.placements), float(
            (o.full_tensor() - FA.flash_attention(q, k, v)).abs().max()))
        rows = [Shard(0), Replicate()]
        ha, hf = RG.rglru_scan(distribute_tensor(a, mesh, rows),
                               distribute_tensor(bb, mesh, rows),
                               distribute_tensor(h0, mesh, rows))
        ra, rf = RG.rglru_scan(a, bb, h0)
        errs["rglru_scan"] = (_pl(ha.placements), max(
            float((ha.full_tensor() - ra).abs().max()),
            float((hf.full_tensor() - rf).abs().max())))
        y = RN.rmsnorm(distribute_tensor(x, mesh, rows),
                       distribute_tensor(w, mesh, [Replicate(), Replicate()]))
        errs["rmsnorm"] = (_pl(y.placements), float(
            (y.full_tensor() - RN.rmsnorm(x, w)).abs().max()))
    if rank == 0:
        _dump(out, "kernels.json", errs)


def _embed(rank, out):
    """``layers.embed``'s backward on a DTensor table over a 2x2 mesh, for
    each layout the rules give the table: the table's gradient against
    the plain lookup's, and its placements against the table's."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.models import layers as LY

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    g = torch.Generator().manual_seed(5)
    table = torch.randn(64, 16, generator=g)
    tokens = torch.randint(0, 64, (4, 8), generator=g, dtype=torch.int32)
    tokens[:, :3] = 7                          # repeated rows accumulate
    w = torch.randn(4, 8, 16, generator=g)
    ref = table.clone().requires_grad_(True)
    (LY.embed(tokens, ref) * w).sum().backward()
    dtok = distribute_tensor(tokens, mesh, [Shard(0), Replicate()])
    dw = distribute_tensor(w, mesh, [Replicate(), Replicate()])
    res = {}
    for layout in ([Replicate(), Shard(0)], [Shard(1), Shard(0)],
                   [Shard(0), Shard(1)], [Replicate(), Replicate()]):
        dt = distribute_tensor(table.clone(), mesh, layout).requires_grad_()
        y = LY.embed(dtok, dt)
        (y * dw).sum().full_tensor().backward()
        res["/".join(_pl(layout))] = {
            "forward_equal": bool(torch.equal(y.full_tensor(),
                                              table[tokens.long()])),
            "grad_err": float((dt.grad.full_tensor() - ref.grad).abs().max()),
            "placements": _pl(dt.grad.placements),
            "table_placements": _pl(dt.placements)}
    if rank == 0:
        _dump(out, "embed.json", res)


def _restore_and_batch(rank, out):
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import factory as F
    from repro_torch.models.params import tree_leaves
    from repro_torch.parallel.rules import ParallelismConfig
    from repro_torch.runtime import steps as RS

    cfg = get_config("qwen2-72b").reduced()
    mesh = make_host_mesh(2, 2)
    pcfg = ParallelismConfig(fsdp=True)
    template = RS.init_train_state(cfg, torch.Generator().manual_seed(7))
    ck = CheckpointManager(str(out / "ckpt"))
    state, meta = ck.restore(template, shardings=SH.train_state_shardings(
        cfg, mesh, pcfg))
    saved, _ = ck.restore(template)
    leaves = tree_leaves(state)
    same = all(torch.equal(d.full_tensor(), s)
               for d, s in zip(leaves, tree_leaves(saved)))
    sharded = sum(any(p.is_shard() for p in d.placements) for d in leaves)
    batch = F.synthetic_batch(cfg, 4, 8, seed=2)
    db = shard_batch(batch, mesh, pcfg)
    pod = mesh.get_coordinate()[0]
    rows_ok = bool(np.array_equal(db["tokens"].to_local().numpy(),
                                  batch["tokens"][2 * pod:2 * pod + 2]))
    if rank == 0:
        _dump(out, "restore.json", {"bit_equal": same, "step": meta["step"],
                                    "sharded_leaves": sharded,
                                    "leaves": len(leaves),
                                    "batch_rows": rows_ok})


def _families(rank, out):
    """Every family's train step and prefill + decode step on 2x2."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import factory as F
    from repro_torch.parallel.ctx import parallel_context
    from repro_torch.parallel.rules import ParallelismConfig, batch_shardings
    from repro_torch.runtime import steps as RS

    import time
    mesh = make_host_mesh(2, 2)
    res = {}
    for arch in FAMILY_ARCHS:
        t0 = time.perf_counter()
        cfg = get_config(arch).reduced()
        pcfg = ParallelismConfig(fsdp=True, remat="dots" if arch ==
                                 FAMILY_ARCHS[0] else "none")
        gen = torch.Generator().manual_seed(11)
        state = SH.distribute(RS.init_train_state(cfg, gen),
                              SH.train_state_shardings(cfg, mesh, pcfg))
        batch = F.synthetic_batch(cfg, 4, 16, seed=5)
        tstep = RS.make_train_step(cfg, pcfg)
        with parallel_context(mesh, pcfg) as pc:
            state, m = tstep(state, shard_batch(batch, mesh, pcfg))
        loss = m["loss"].full_tensor().item()
        t_train = time.perf_counter() - t0
        n_front = cfg.n_front
        ctx = 16 + n_front + 2
        params = state["params"]
        plain = {k: torch.as_tensor(v) for k, v in batch.items()}
        with torch.no_grad():
            whole = {k: v for k, v in _full(params).items()}
            lg, cache = F.make_prefill_step(cfg, ctx=ctx)(whole, plain)
            tok = lg.argmax(-1).to(torch.int32)
            pos = torch.full((4,), 16 + n_front, dtype=torch.int32)
            lg2, _ = F.make_serve_step(cfg)(whole, cache, tok, pos)
            with parallel_context(mesh, pcfg) as pc2:
                dlg, dcache = F.make_prefill_step(cfg, ctx=ctx)(
                    params, shard_batch(batch, mesh, pcfg))
                toks = batch_shardings({"t": tok, "p": pos}, mesh, pcfg)
                dtok = SH.distribute(tok, toks["t"])
                dpos = SH.distribute(pos, toks["p"])
                dlg2, _ = F.make_serve_step(cfg)(params, dcache, dtok, dpos)
        a, b2 = dlg.full_tensor(), dlg2.full_tensor()
        res[arch] = {
            "loss": loss, "finite": bool(torch.isfinite(a).all()
                                         and torch.isfinite(b2).all()
                                         and np.isfinite(loss)),
            "shapes": [list(a.shape), list(b2.shape)],
            "prefill_err": float((a - lg).abs().max()),
            "decode_err": float((b2 - lg2).abs().max()),
            "logit_scale": float(lg.abs().max()),
            "gathered": dict(pc.gathered) | {
                "serve:" + k: v for k, v in pc2.gathered.items()}}
        if rank == 0:
            print(f"[worker] {arch} {time.perf_counter() - t0:.1f} s "
                  f"(train {t_train:.1f})", file=sys.stderr, flush=True)
    if rank == 0:
        _dump(out, "families.json", res)


def _full(tree):
    if isinstance(tree, dict):
        return {k: _full(v) for k, v in tree.items()}
    return tree.full_tensor()


def _qwen_losses(mesh):
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim.schedule import constant
    from repro_torch.parallel.rules import ParallelismConfig
    from repro_torch.runtime.loop import LoopConfig, run_training

    cfg = get_config("qwen2-72b").reduced()
    wide = hasattr(mesh, "mesh_dim_names") and mesh.size() > 1
    pcfg = ParallelismConfig(tp=True, fsdp=wide, remat="none", microbatch=1)
    res = run_training(cfg, pcfg, mesh, SyntheticLM(cfg, 8, 32, seed=0),
                       LoopConfig(total_steps=QWEN_STEPS, checkpoint_every=0,
                                  log_every=0),
                       lr_fn=functools.partial(constant, peak_lr=1e-3))
    return {"losses": res.losses, "grad_norms": res.grad_norms}


def _parallel(rank, port, out):
    import torch.distributed as dist

    _init(rank, WORLD, port)
    _timed("pipeline", _pipeline, rank, out)
    _timed("placements", _placements, rank, out)
    _timed("kernels", _kernels, rank, out)
    _timed("embed", _embed, rank, out)
    _timed("restore", _restore_and_batch, rank, out)
    from repro_torch.launch.mesh import make_host_mesh
    two = _qwen_losses(make_host_mesh(2, 2))
    dist.destroy_process_group()
    if rank != 0:
        return
    _init(0, 1, _free_port())                # a world of 1: the 1x1 mesh
    one = _qwen_losses(make_host_mesh(1, 1))
    dist.destroy_process_group()
    none = _qwen_losses("cpu")
    _dump(out, "qwen.json", {"2x2": two, "1x1": one, "none": none})


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------
def _compression(rank, port, out):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.optim.compression import (compressed_psum,
                                               init_error_state,
                                               tree_compressed_psum)

    _init(rank, WORLD, port)
    data = np.load(out / "compression_in.npz")
    g = torch.from_numpy(data["grads"][rank])
    e = torch.from_numpy(data["errors"][rank])
    s, ne = compressed_psum(g, e)
    # over one dim of a 2x2 mesh: the pairs that share a data coordinate
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    s_model, _ = compressed_psum(g, e, mesh.get_group("model"))
    tree = {"a": g, "b": {"c": g[:5] * 3}}
    ts, te = tree_compressed_psum(tree, init_error_state(tree))
    got = [None] * WORLD
    dist.all_gather_object(got, {"sum": s.tolist(), "err": ne.tolist(),
                                 "sum_model": s_model.tolist(),
                                 "coord": mesh.get_coordinate(),
                                 "tree_a": ts["a"].tolist(),
                                 "tree_c": ts["b"]["c"].tolist(),
                                 "tree_err_c": te["b"]["c"].tolist()})
    if rank == 0:
        _dump(out, "compression.json", got)
    dist.destroy_process_group()


def _families_job(rank, port, out):
    import torch.distributed as dist

    _init(rank, WORLD, port)
    _timed("families", _families, rank, out)
    dist.destroy_process_group()


JOBS = {"parallel": _parallel, "families": _families_job,
        "compression": _compression}


def main() -> None:
    import torch.multiprocessing as mp

    job, out = sys.argv[1], Path(sys.argv[2])
    mp.spawn(JOBS[job], args=(_free_port(), out), nprocs=WORLD, join=True)


if __name__ == "__main__":
    main()
