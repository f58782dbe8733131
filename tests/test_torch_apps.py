"""The port's paper apps against the JAX package's: the same NumPy inputs
go through the JAX all-ref and all-offload builds and through the port's
all-ref, all-offload and hopper builds (the ``hopper`` variant runs its
kernel's plain version on the CPU).

Tolerances: the signal outputs use the kernel tolerances (tdFIR 3e-4,
MRI-Q 3e-3).  The scalar checksums (``fir_energy`` per bank, the
``mriq_check`` total) are sums of squares over a whole row or all voxels,
taken in another order on each side (a sequential loop against a pairwise
reduction, float32 throughout), so they are held to 1e-3 relative."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import mriq as jax_mriq
from repro.apps import tdfir as jax_tdfir
from repro.configs import paper_apps as JCFG
from repro.core.regions import Impl as JImpl
from repro_torch.apps import from_numpy
from repro_torch.apps import mriq as torch_mriq
from repro_torch.apps import tdfir as torch_tdfir
from repro_torch.configs import paper_apps as TCFG
from repro_torch.core.regions import Impl, variants

CHECKSUM_RTOL = 1e-3
APPS = {
    # name: (jax module, torch module, jax cfg, torch cfg, output tolerances)
    "tdfir": (jax_tdfir, torch_tdfir, JCFG.TdFirConfig(4, 16, 256),
              TCFG.TdFirConfig(4, 16, 256), (3e-4, CHECKSUM_RTOL)),
    "mriq": (jax_mriq, torch_mriq, JCFG.MriQConfig(300, 200),
             TCFG.MriQConfig(300, 200), (3e-3, 3e-3, CHECKSUM_RTOL)),
}


def _inputs(name: str, cfg) -> list[np.ndarray]:
    rng = np.random.default_rng(7)
    if name == "tdfir":
        def cn(*shape):
            return (rng.standard_normal(shape)
                    + 1j * rng.standard_normal(shape)).astype(np.complex64)
        return [cn(cfg.n_banks, cfg.n_samples), cn(cfg.n_banks, cfg.n_taps)]
    f = [rng.standard_normal(cfg.num_x).astype(np.float32) for _ in range(3)]
    k = [(rng.standard_normal(cfg.num_k) * 0.1).astype(np.float32)
         for _ in range(3)]
    phi = [rng.standard_normal(cfg.num_k).astype(np.float32) for _ in range(2)]
    return f + k + phi


@pytest.fixture(scope="module")
def jax_outputs():
    """Each app's JAX all-ref and all-offload outputs, as NumPy."""
    out = {}
    for name, (jmod, _, jcfg, _, _) in APPS.items():
        prog = jmod.make_program(jcfg, jcfg)
        args = [jnp.asarray(a) for a in _inputs(name, jcfg)]
        offload = JImpl({r.name: "offload" for r in prog.regions})
        out[name] = {label: [np.asarray(o) for o in prog.build(impl)(*args)]
                     for label, impl in (("all-ref", JImpl()),
                                         ("all-offload", offload))}
    return out


def _torch_impl(prog, pattern: str) -> Impl:
    if pattern == "all-ref":
        return Impl()
    if pattern == "all-offload":
        return Impl({r.name: "offload" for r in prog.regions})
    # hopper where a region has it, the loop-faithful ref elsewhere
    return Impl({r.name: "hopper" for r in prog.regions
                 if "hopper" in variants(r.name)})


@pytest.mark.parametrize("jax_pattern", ["all-ref", "all-offload"])
@pytest.mark.parametrize("pattern", ["all-ref", "all-offload", "hopper"])
@pytest.mark.parametrize("app", sorted(APPS))
def test_port_build_matches_jax_build(jax_outputs, app, pattern, jax_pattern):
    _, tmod, _, tcfg, tols = APPS[app]
    prog = tmod.make_program(tcfg, tcfg, device="cpu")
    impl = _torch_impl(prog, pattern)
    if pattern == "hopper":
        assert impl, "the app registers a hopper variant"
    args = from_numpy(app, _inputs(app, tcfg), device="cpu")
    got = prog.build(impl)(*args)
    want = jax_outputs[app][jax_pattern]
    assert len(got) == len(want) == len(tols)
    for i, (g, w, tol) in enumerate(zip(got, want, tols)):
        g = g.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, i
        atol = 0.0 if tol == CHECKSUM_RTOL else tol
        np.testing.assert_allclose(g, w, rtol=tol, atol=atol,
                                   err_msg=f"{app} output {i}")


def test_from_numpy_checks_count_and_dtype():
    x = np.zeros((2, 8), np.complex64)
    h = np.zeros((2, 4), np.complex64)
    got = from_numpy("tdfir", [x, h], device="cpu")
    assert [t.dtype for t in got] == [torch.complex64] * 2
    got[0][0, 0] = 1.0
    assert x[0, 0] == 0                        # a copy, not a view
    with pytest.raises(ValueError):
        from_numpy("tdfir", [x.astype(np.complex128), h], device="cpu")
    with pytest.raises(ValueError):
        from_numpy("mriq", [x, h], device="cpu")
    with pytest.raises(ValueError):
        from_numpy("nope", [x], device="cpu")


@pytest.mark.parametrize("app", sorted(APPS))
def test_sample_inputs_are_seeded_and_shaped(app):
    _, tmod, _, tcfg, _ = APPS[app]
    prog = tmod.make_program(tcfg, tcfg, device="cpu")
    a = prog.sample_inputs(3, torch.device("cpu"))
    b = prog.sample_inputs(3, torch.device("cpu"))
    c = prog.sample_inputs(4, torch.device("cpu"))
    want = [x.shape for x in _inputs(app, tcfg)]
    assert [t.shape for t in a] == want
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
    if app == "tdfir":                 # re and im are independent draws
        assert not torch.equal(a[0].real, a[0].imag)
