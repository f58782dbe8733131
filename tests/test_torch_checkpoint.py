"""The port's checkpoints and training loop against the JAX package's:
the on-disk layout both packages read (a JAX-written checkpoint restores
into the port's state and a port-written one into JAX's, bf16 bit for
bit), ``keep_n``, ``LATEST``, async saves, the SIGTERM flush, and
``run_training``'s restart and convergence (tests/test_system.py at the
port's own small sizes), and the train launchers.
"""
import dataclasses
import functools
import importlib.util
import json
import os
import signal
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JaxCheckpointManager
from repro.configs import get_config as jax_get_config
from repro.runtime import steps as JRS
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import train as train_launcher
from repro_torch.launch import train_lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.params import tree_leaves
from repro_torch.optim.schedule import constant
from repro_torch.parallel.rules import ParallelismConfig
from repro_torch.runtime import steps as RS
from repro_torch.runtime.loop import LoopConfig, run_training

ARCH = "mistral-nemo-12b"
REPO = Path(__file__).resolve().parents[1]


def _pcfg():
    return ParallelismConfig(tp=True, fsdp=False, remat="none", microbatch=1)


def _jax_state():
    """A reduced bf16 JAX train state with nonzero moments and counters."""
    jcfg = jax_get_config(ARCH).reduced()
    state = JRS.init_train_state(jcfg, jax.random.PRNGKey(4))
    bump = lambda t: (t + jnp.asarray(0.25, t.dtype)) if t.ndim else t + 3
    return jax.tree.map(bump, state)


def _torch_state():
    return RS.init_train_state(get_config(ARCH).reduced(),
                               torch.Generator().manual_seed(0))


def _assert_bitwise(got, want):
    """A port tree against a tree of NumPy arrays (ml_dtypes bf16), bit for
    bit."""
    def check(t, a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)
    flat_want = {}

    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}/{k}")
        else:
            flat_want[prefix] = tree
    walk(want)
    seen = []

    def walk_got(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk_got(v, f"{prefix}/{k}")
        else:
            check(tree, flat_want[prefix])
            seen.append(prefix)
    walk_got(got)
    assert sorted(seen) == sorted(flat_want)


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    jstate = _jax_state()
    JaxCheckpointManager(str(tmp_path)).save(7, jstate, extra={"data": {
        "seed": 1, "step": 7}})
    ck = CheckpointManager(str(tmp_path))
    assert ck.latest_step() == 7
    template = params_from_numpy(jax.tree.map(np.zeros_like, jax.tree.map(
        np.asarray, jstate)), "cpu")
    state, meta = ck.restore(template)
    _assert_bitwise(state, jax.tree.map(np.asarray, jstate))
    assert meta["step"] == 7 and meta["extra"]["data"] == {"seed": 1,
                                                           "step": 7}


def test_port_checkpoint_has_the_layout_and_restores_into_jax(tmp_path):
    state = _torch_state()
    state["step"] += 5
    path = CheckpointManager(str(tmp_path)).save(5, state, extra={"x": 1})
    assert Path(path).name == "step_00000005"
    assert (tmp_path / "LATEST").read_text() == "step_00000005"
    meta = json.loads((Path(path) / "meta.json").read_text())
    with np.load(Path(path) / "arrays.npz") as z:
        keys = set(z.files)
        assert z["params/embed"].dtype == np.uint16       # bf16 bits
    assert "params/stack/l0/attn/wq" in keys and "opt/count" in keys
    assert meta["dtypes"]["params/embed"] == "bfloat16"
    assert meta["dtypes"]["step"] == "int32" and meta["n_leaves"] == len(keys)
    jtemplate = JRS.init_train_state(jax_get_config(ARCH).reduced(),
                                     jax.random.PRNGKey(9))
    jrestored, jmeta = JaxCheckpointManager(str(tmp_path)).restore(jtemplate)
    _assert_bitwise(state, jax.tree.map(np.asarray, jrestored))
    assert jmeta["extra"] == {"x": 1}


def test_keep_n_latest_and_async_then_restore(tmp_path):
    ck = CheckpointManager(str(tmp_path), keep_n=2)
    assert ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore(_torch_state())
    state = _torch_state()
    for step in (1, 2, 3):
        state["params"]["final_ln"] += 1
        ck.save_async(step, state, extra={"step": step})
        # the snapshot is taken at the call: a later in-place write (the
        # next train step's) must not reach the saved arrays
        state["params"]["final_ln"] += 100
        state["params"]["final_ln"] -= 100
    ck.wait()
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_00000002",
                                            "step_00000003"]
    assert ck.latest_step() == 3
    restored, meta = ck.restore(_torch_state())
    assert meta["extra"] == {"step": 3}
    for a, b in zip(tree_leaves(restored), tree_leaves(state)):
        assert torch.equal(a, b)
    older, _ = ck.restore(_torch_state(), step=2)
    assert torch.equal(older["params"]["final_ln"],
                       state["params"]["final_ln"] - 1)


def test_sigterm_flushes_exits_143_and_restores_the_old_handler(tmp_path):
    calls = []
    old = signal.signal(signal.SIGTERM, lambda *a: calls.append(a))
    try:
        ck = CheckpointManager(str(tmp_path))
        state = _torch_state()
        assert ck.install_sigterm_handler(lambda: (11, state)) is not None
        with pytest.raises(SystemExit) as exc:
            os.kill(os.getpid(), signal.SIGTERM)
            for _ in range(1000):           # the handler runs between bytecodes
                pass
        assert exc.value.code == 143
        assert ck.latest_step() == 11
        _, meta = ck.restore(_torch_state())
        assert meta["extra"] == {"preempted": True}
        os.kill(os.getpid(), signal.SIGTERM)   # the old handler again
        assert len(calls) == 1
    finally:
        signal.signal(signal.SIGTERM, old)


def _lr():
    return functools.partial(constant, peak_lr=1e-2)


def test_training_loss_decreases():
    cfg = get_config(ARCH).reduced()
    res = run_training(cfg, _pcfg(), "cpu", SyntheticLM(cfg, 8, 48, seed=0),
                       LoopConfig(total_steps=30, checkpoint_every=0,
                                  log_every=0), lr_fn=_lr())
    assert res.losses[-1] < res.losses[0] - 1.0
    assert res.final_step == 30 and res.restored_from is None
    assert len(res.step_times) == 30 and res.straggler_events >= 0


def test_restart_resumes_exactly(tmp_path):
    """20 steps with checkpoints every 10, then a run to 25 from the latest
    checkpoint: it restores step 20 (the data position too), runs only the
    last 5 steps, and their losses equal an uninterrupted run's bit for
    bit."""
    cfg = get_config(ARCH).reduced()
    loop = lambda n: LoopConfig(total_steps=n, checkpoint_every=10,
                                log_every=0)
    straight = run_training(cfg, _pcfg(), "cpu", SyntheticLM(cfg, 4, 32),
                            loop(25), lr_fn=_lr())
    ck = CheckpointManager(str(tmp_path), keep_n=2)
    handler = signal.getsignal(signal.SIGTERM)
    first = run_training(cfg, _pcfg(), "cpu", SyntheticLM(cfg, 4, 32),
                         loop(20), ckpt=ck, lr_fn=_lr())
    assert first.losses == straight.losses[:20]
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_00000010",
                                            "step_00000020"]
    second = run_training(cfg, _pcfg(), "cpu", SyntheticLM(cfg, 4, 32),
                          loop(25), ckpt=ck, lr_fn=_lr())
    assert second.restored_from == 20 and second.final_step == 25
    assert len(second.losses) == 5
    assert second.losses == straight.losses[20:]
    assert signal.getsignal(signal.SIGTERM) == handler   # put back


def test_straggler_watchdog_healthy_run():
    cfg = get_config("whisper-small").reduced()
    res = run_training(cfg, _pcfg(), "cpu", SyntheticLM(cfg, 2, 16, seed=0),
                       LoopConfig(total_steps=6, checkpoint_every=0,
                                  log_every=0, straggler_factor=50.0))
    assert res.straggler_events == 0
    assert len(res.step_times) == 6


def test_train_launcher_resumes_and_refuses_a_mesh(tmp_path, capsys):
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "3",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--checkpoint-every", "2"]
    res = train_launcher.main(argv)
    assert res.final_step == 3 and len(res.losses) == 3
    assert "final loss" in capsys.readouterr().out
    again = train_launcher.main(argv[:6] + ["5"] + argv[7:])
    assert again.restored_from == 3 and len(again.losses) == 2
    with pytest.raises(ValueError, match="one device"):
        train_launcher.main(argv + ["--model-mesh", "2"])
    if not torch.cuda.is_available():          # the default device is cuda
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_launcher.main(argv[:3] + ["--steps", "1"])


def test_hundred_m_config_matches_the_jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_train_lm_example", REPO / "examples" / "train_lm.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    for arch in ("qwen2-72b", "recurrentgemma-2b", "mixtral-8x7b",
                 "whisper-small"):
        want = dataclasses.asdict(example.hundred_m_config(arch))
        got = dataclasses.asdict(train_lm.hundred_m_config(arch))
        assert {k: got[k] for k in want} == want
        assert got.keys() == want.keys()
    cfg = train_lm.hundred_m_config("qwen2-72b")
    assert 80e6 < cfg.param_count() < 200e6


def test_train_lm_runs_on_the_cpu(tmp_path, capsys):
    res = train_lm.main(["--steps", "2", "--batch", "2", "--seq", "16",
                         "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert res.final_step == 2
    out = capsys.readouterr().out
    assert "loss:" in out and "params=" in out
    assert CheckpointManager(str(tmp_path)).latest_step() == 2
