"""The port's region registry and gene model render exactly as the JAX
package's: plan-cache keys are built from ``Impl.describe()`` and
``canonical_gene``, so the same genes must give the same strings."""
import pytest

from repro.apps import tdfir as jax_tdfir  # noqa: F401 — registers JAX variants
from repro.core import regions as JR
from repro_torch.apps import tdfir as torch_tdfir  # noqa: F401 — registers port variants
from repro_torch.core import regions as TR

REGION = "torch_parity_region"
AXES = {"block_n": (128, 256, 512), "tap_unroll": (1, 2, 4)}
DEFAULTS = {"block_n": 256, "tap_unroll": 1}


def _valid(p, args):
    return p["block_n"] * p["tap_unroll"] <= 1024


GENES = [
    "tune",
    ("tune", {"block_n": 256}),                    # the default: bare gene
    ("tune", {"block_n": 512}),
    ("tune", {"block_n": 512, "tap_unroll": 4}),
    ["tune", [["tap_unroll", 2]]],                 # JSON round-trip form
    ("tune", {"bogus": 3}),                        # undeclared axis
    ("tune", (("block_n", 128), ("tap_unroll", 1))),
    "ref",
    "plain",
    ("plain", {"block_n": 512}),                   # no TuningSpace declared
]


@pytest.fixture
def both_registries():
    for mod in (JR, TR):
        mod.register_variant(REGION, "ref")(lambda x: x)
        mod.register_variant(REGION, "plain")(lambda x: x)
        mod.register_variant(REGION, "tune", tuning=mod.TuningSpace(
            AXES, DEFAULTS, _valid))(lambda x, **kw: kw)
    yield
    for mod in (JR, TR):
        for variant in ("ref", "plain", "tune"):
            assert mod.unregister_variant(REGION, variant)


@pytest.mark.parametrize("gene", GENES, ids=repr)
def test_gene_renderings_match_jax(both_registries, gene):
    assert TR.split_gene(gene) == JR.split_gene(gene)
    assert TR.gene_variant(gene) == JR.gene_variant(gene)
    assert TR.canonical_gene(REGION, gene) == JR.canonical_gene(REGION, gene)
    assert (TR.Impl({REGION: gene, "fir_bank": "offload"}).describe()
            == JR.Impl({REGION: gene, "fir_bank": "offload"}).describe())
    assert TR.Impl({REGION: gene}).pick(REGION) == JR.Impl({REGION: gene}).pick(REGION)


@pytest.mark.parametrize("gene", GENES[:7], ids=repr)
def test_dispatch_passes_the_same_tile_params(both_registries, gene):
    """Gene params win over caller kwargs and only declared axes pass."""
    got = TR.dispatch(REGION, TR.Impl({REGION: gene}), 0, block_n=128, extra=1)
    want = JR.dispatch(REGION, JR.Impl({REGION: gene}), 0, block_n=128, extra=1)
    assert got == want


def test_tuning_space_points_and_neighbors_match_jax(both_registries):
    j, t = JR.tuning_space(REGION, "tune"), TR.tuning_space(REGION, "tune")
    assert t.points() == j.points()
    assert t.size() == j.size() == 8
    assert t.signature() == j.signature()
    for p in j.points():
        assert t.neighbors(p) == j.neighbors(p)
        assert t.canonical(p) == j.canonical(p)
        assert t.full(p) == j.full(p)
    assert TR.variants(REGION).keys() == JR.variants(REGION).keys()
    assert TR.offload_variants(REGION).keys() == {"plain", "tune"}


def test_registries_are_separate(both_registries):
    assert TR.REGISTRY is not JR.REGISTRY
    TR.register_variant(REGION, "torch_only")(lambda x: x)
    try:
        assert "torch_only" not in JR.variants(REGION)
    finally:
        TR.unregister_variant(REGION, "torch_only")


def test_fir_bank_hopper_space_is_the_pallas_space():
    """The hopper variant declares the tile space of the JAX pallas variant,
    so bound to the paper-size arguments both give the same points."""
    from repro.configs.paper_apps import TDFIR_FULL
    t_prog = torch_tdfir.make_program(device="cpu")
    j_prog = jax_tdfir.make_program(TDFIR_FULL, TDFIR_FULL)
    t_space = TR.BoundTuningSpace(TR.tuning_space("fir_bank", "hopper"),
                                  t_prog.regions[1].analysis_args)
    j_space = JR.BoundTuningSpace(JR.tuning_space("fir_bank", "pallas"),
                                  j_prog.regions[1].analysis_args)
    assert t_space.space.signature() == j_space.space.signature()
    assert t_space.points() == j_space.points()
    assert t_space.neighbors({"block_n": 512}) == j_space.neighbors({"block_n": 512})
