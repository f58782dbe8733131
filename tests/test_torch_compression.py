"""Gradient compression (``optim/compression.py``) against the JAX
package's: int8 quantization bit for bit (both round half to even), error
feedback unbiased over 50 steps and convergence parity (the tolerances of
tests/test_substrates.py), and on 4 gloo ranks ``compressed_psum`` equal
to the sum of the JAX-quantized payloads times the largest JAX scale."""
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.optim import compression as JC
from repro_torch.optim import compression as C

WORKER = Path(__file__).with_name("torch_mesh_worker.py")
sys.path.insert(0, str(WORKER.parent))
from torch_mesh_worker import run_job  # noqa: E402


@settings(max_examples=40, deadline=None)
@given(st.lists(st.floats(-100, 100, allow_nan=False, width=32), min_size=1,
                max_size=64))
def test_quantize_int8_is_bit_equal_to_jax(xs):
    x = np.asarray(xs, np.float32)
    jq, js = JC.quantize_int8(jnp.asarray(x))
    q, s = C.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.item() == float(js)
    err = np.abs(C.dequantize_int8(q, s).numpy() - x)
    assert err.max() <= s.item() * 0.5 + 1e-6


def test_round_half_to_even_at_the_ties():
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])   # scale 1.0
    q, s = C.quantize_int8(x)
    jq, _ = JC.quantize_int8(jnp.asarray(x.numpy()))
    assert s.item() == 1.0
    assert q.tolist() == [127, 0, 2, 2, 0, -2] == np.asarray(jq).tolist()


def test_error_feedback_is_unbiased_over_time():
    """Sum of dequantized grads + final residual == sum of true grads."""
    rng = np.random.default_rng(3)
    err = torch.zeros(32)
    total_true = torch.zeros(32)
    total_sent = torch.zeros(32)
    for _ in range(50):
        g = torch.from_numpy(rng.standard_normal(32).astype(np.float32))
        q, s, err = C.compress_with_feedback(g, err)
        total_sent += C.dequantize_int8(q, s)
        total_true += g
    np.testing.assert_allclose((total_sent + err).numpy(), total_true.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_compression_convergence_parity():
    rng = np.random.default_rng(0)
    A = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    finals = {}
    for compressed in (False, True):
        w = torch.zeros(32)
        err = torch.zeros(32)
        for _ in range(200):
            gr = 2.0 / 64 * A.t() @ (A @ w - b)
            if compressed:
                q, s, err = C.compress_with_feedback(gr, err)
                gr = C.dequantize_int8(q, s)
            w = w - 0.02 * gr
        finals[compressed] = float(torch.mean((A @ w - b) ** 2))
    assert abs(finals[True] - finals[False]) < 1e-3


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("compression")
    rng = np.random.default_rng(9)
    grads = rng.standard_normal((4, 48)).astype(np.float32) * \
        np.array([1.0, 3.0, 0.1, 10.0], np.float32)[:, None]
    errors = (rng.standard_normal((4, 48)) * 0.01).astype(np.float32)
    np.savez(out / "compression_in.npz", grads=grads, errors=errors)
    run_job("compression", out)
    return grads, errors, json.loads((out / "compression.json").read_text())


def _jax_sum(grads, errors, members):
    qs, ss = [], []
    for r in members:
        q, s, _ = JC.compress_with_feedback(jnp.asarray(grads[r]),
                                            jnp.asarray(errors[r]))
        qs.append(np.asarray(q, np.int32))
        ss.append(float(s))
    return (sum(qs).astype(np.float32) * np.float32(max(ss)))


def test_compressed_psum_equals_the_jax_payloads_on_4_ranks(ranks):
    grads, errors, got = ranks
    want = _jax_sum(grads, errors, range(4))
    for r in range(4):
        np.testing.assert_array_equal(np.asarray(got[r]["sum"], np.float32),
                                      want)
        _, _, jerr = JC.compress_with_feedback(jnp.asarray(grads[r]),
                                               jnp.asarray(errors[r]))
        np.testing.assert_allclose(got[r]["err"], np.asarray(jerr),
                                   rtol=0, atol=1e-6)


def test_compressed_psum_over_one_mesh_dim(ranks):
    grads, errors, got = ranks
    for r in range(4):
        data = got[r]["coord"][0]
        members = [q for q in range(4) if got[q]["coord"][0] == data]
        assert len(members) == 2
        np.testing.assert_array_equal(
            np.asarray(got[r]["sum_model"], np.float32),
            _jax_sum(grads, errors, members))


def test_tree_compressed_psum(ranks):
    grads, _, got = ranks
    zero = np.zeros_like(grads)
    np.testing.assert_array_equal(np.asarray(got[0]["tree_a"], np.float32),
                                  _jax_sum(grads, zero, range(4)))
    tree = {"a": jnp.asarray(grads[0]), "b": {"c": jnp.asarray(grads[0][:5])}}
    assert len(got[0]["tree_c"]) == 5 and len(got[0]["tree_err_c"]) == 5
    assert JC.init_error_state(tree)["b"]["c"].shape == (5,)
