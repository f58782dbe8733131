"""The port's train step against the JAX package's for every family:
dense (mistral-nemo-12b), SSM (falcon-mamba-7b), recurrent
(recurrentgemma-2b), MoE (mixtral-8x7b) and both frontends (whisper-small,
paligemma-3b), two steps from the same state on the same NumPy batch.

Setup and tolerances as in tests/test_torch_train.py (its helpers are
imported): loss, grad norm and lr 1e-5 relative, every parameter and
first moment 1e-5 after each step, AdamW's eps at 1e-3.
"""
import functools

import jax
import numpy as np
import pytest

from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro.parallel.rules import ParallelismConfig as JaxParallelismConfig
from repro.runtime import steps as JRS
from repro_torch.models.params import tree_leaves
from repro_torch.optim import adamw
from repro_torch.optim import schedule
from repro_torch.parallel.rules import ParallelismConfig
from repro_torch.runtime import steps as RS
from test_torch_train import (FAMILIES, LR, STEP_TOL, _batch, _cfgs,
                              _close_trees, _state, f32_heads)  # noqa: F401


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_jax(arch, f32_heads):
    """Two steps: loss, grad norm and every parameter and moment."""
    jcfg, tcfg = _cfgs(arch)
    jstate, tstate = _state(jcfg)
    jb, tb = _batch(tcfg)
    jstep = jax.jit(JRS.make_train_step(
        jcfg, JaxParallelismConfig(remat="none"),
        jadamw.AdamWConfig(eps=1e-3),
        functools.partial(jschedule.constant, peak_lr=LR)))
    tstep = RS.make_train_step(
        tcfg, ParallelismConfig(remat="none"), adamw.AdamWConfig(eps=1e-3),
        functools.partial(schedule.constant, peak_lr=LR))
    for step in range(2):
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(tm[key].item(), float(jm[key]),
                                       rtol=STEP_TOL, err_msg=f"{key} {step}")
        _close_trees(tstate["params"], jstate["params"], STEP_TOL,
                     f"{arch} step {step} params")
        _close_trees(tstate["opt"]["m"], jstate["opt"]["m"], STEP_TOL, "m")
        assert int(tstate["step"]) == int(jstate["step"]) == step + 1
    assert not any(p.requires_grad for p in tree_leaves(tstate["params"]))
