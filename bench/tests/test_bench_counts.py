"""The yardstick's counts against figures worked out by hand, and their
independence of the variant that ran."""
import json
import math
from types import SimpleNamespace

import pytest

from bench import counts
from bench.tests.conftest import REPO


def _dims(name: str) -> counts.Dims:
    return counts.Dims.from_config(
        json.loads((REPO / "bench" / "configs" / f"{name}.json").read_text()))


def test_nemo_by_hand():
    m = _dims("nemo12b")
    # Wq, Wk, Wv, Wo: 5,120 x 128 x (32 + 32 + 8 + 8)
    assert counts.attn_params(m) == 52_428_800
    # SwiGLU: 3 x 5,120 x 14,336
    assert counts.ffn_active_params(m) == 220_200_960
    # 40 layers of both, and the 5,120 x 131,072 unembedding
    assert counts.decode_flops(m, 1) == (2 * 40 * 272_629_760
                                         + 40 * 4 * 32 * 128
                                         + 2 * 5_120 * 131_072)
    assert counts.decode_flops(m, 1) == 23_153_213_440
    # 4 prompt tokens attend 1 + 2 + 3 + 4 positions; one logit row
    assert counts.prefill_flops(m, 4) == 88_590_254_080
    # 40 layers x k and v x 8 heads x 128 x 2 bytes = 160 KiB a position
    assert counts.kv_bytes_per_position(m) == 163_840
    # the published size: 12.25 B parameters with the norms
    total = (40 * (counts.attn_params(m) + counts.expert_params(m) + 2 * 5_120)
             + 2 * 5_120 * 131_072 + 5_120)
    assert total == 12_247_782_400


def test_mixtral_by_hand():
    m = _dims("mixtral8x7b")
    assert (m.layers, m.experts, m.experts_per_token) == (16, 8, 2)
    assert counts.attn_params(m) == 41_943_040          # 4,096 x 128 x 80
    assert counts.expert_params(m) == 176_160_768       # 3 x 4,096 x 14,336
    # two experts and the 4,096 x 8 router: capacity padding is not work
    assert counts.ffn_active_params(m) == 352_354_304
    assert counts.decode_flops(m, 1) == 12_879_921_152
    assert counts.kv_bytes_per_position(m) == 65_536    # 64 KiB
    # at 64 tokens all 8 experts are read, up to (3/4)^64
    assert counts.experts_touched(m, 64) == pytest.approx(8.0, abs=1e-7)
    assert counts.experts_touched(m, 1) == pytest.approx(2.0)
    full = 32 * (counts.attn_params(m) + 8 * counts.expert_params(m)
                 + 4_096 * 8 + 2 * 4_096) + 2 * 4_096 * 32_000 + 4_096
    assert full == 46_702_792_704                       # Mixtral's 46.7 B


def test_decode_bound_by_hand():
    m = _dims("nemo12b")
    attended = [600, 1_000, 2_000, 1]
    weights = 2 * (40 * (52_428_800 + 220_200_960 + 2 * 5_120)
                   + 5_120 * 131_072 + 5_120 + 4 * 5_120)
    t_bytes = (weights + 163_840 * 3_601) / 3.35e12
    t_ops = sum(counts.decode_flops(m, a) for a in attended) / 989e12
    assert counts.decode_bound_s(m, attended) == pytest.approx(
        max(t_bytes, t_ops), rel=1e-12)
    assert t_bytes > t_ops                  # decode is bound by bytes


def test_flash_bound_matches_the_kernel_table():
    # the bf16 flash row at [1, 32/8, 2,048, 128]: 0.03476 ms, by operations
    m = _dims("nemo12b")
    pairs = 32 * 2_048 * 2_049 // 2
    assert counts.flash_call_bound_s(m, 2_048) == pytest.approx(
        4 * 128 * pairs / 989e12)
    assert round(counts.flash_call_bound_s(m, 2_048) * 1e3, 5) == 0.03476
    # bidirectional: every pair
    assert counts.attention_pairs(8, False) == 64
    assert counts.attention_pairs(8, True) == 36


@pytest.mark.parametrize("name", ["nemo12b", "mixtral8x7b"])
def test_counts_ignore_the_variant(name):
    """The counts read sizes and shapes only: the served pattern, the
    capacity factor and the program's bucket padding change nothing."""
    path = REPO / "bench" / "configs" / f"{name}.json"
    base = json.loads(path.read_text())
    other = {**base, "pattern": {"attn_core": "ref", "moe_ffn": "offload"},
             "capacity_factor": 1.25}
    assert counts.Dims.from_config(base) == counts.Dims.from_config(other)
    m = counts.Dims.from_config(base)
    from bench.stats import tick_flops
    # one prefill of 600 tokens whatever bucket it was padded to
    a = SimpleNamespace(admitted=[600], buckets=[1_024], decoded=[601, 9])
    b = SimpleNamespace(admitted=[600], buckets=[2_048], decoded=[601, 9])
    assert tick_flops(m, a) == tick_flops(m, b)
    assert math.isfinite(counts.decode_bound_s(m, [601, 9]))


def test_slot_occupancy_weighs_each_tick_by_its_seconds_in_the_window():
    """Slots at work over the whole window: a tick that straddles the close
    counts for its part inside, and a stretch with no tick for none."""
    from bench.serve import Tick, Window
    from bench.spec import Spec
    win = Window(t_open=0.0, t_close=10.0, slots=4)
    win.ticks = [Tick(0.0, 2.0, [], [], [], 0, busy=4),
                 Tick(2.0, 3.0, [], [], [], 0, busy=2),
                 Tick(9.0, 11.0, [], [], [], 0, busy=4)]
    read = Spec(REPO).reader("slot_occupancy").read
    assert read(SimpleNamespace(window=win)) == pytest.approx(
        100.0 * (4 * 2 + 2 * 1 + 4 * 1) / (4 * 10))


@pytest.mark.parametrize("traffic", ["chat", "batch"])
def test_every_seed_gets_the_same_schedule_on_other_tokens(traffic):
    from bench import generator
    mix = json.loads((REPO / "bench" / "traffic" / f"{traffic}.json")
                     .read_text())
    a, b = (generator.schedule(mix, s, 51.0, 32_000)
            for s in (2**31 + 1, 2**33 + 7))
    assert [(p.due_s, p.prompt.size, p.max_new_tokens, p.in_window)
            for p in a] == [(p.due_s, p.prompt.size, p.max_new_tokens,
                             p.in_window) for p in b]
    assert any((p.prompt != q.prompt).any() for p, q in zip(a, b))
