"""The CUDA kernels against their plain PyTorch versions, on the card.

Skipped without one (the decision is made in a fixture).  This file
imports neither JAX nor the JAX package, so it also runs where only the
port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import gc

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import fir, mriq
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import rglru_scan as RS
from repro_torch.kernels import rmsnorm as RN
from repro_torch.kernels import ssm_scan as SS
from repro_torch.kernels.ref import rmsnorm_plain

FIR_TOL = 3e-4
MRIQ_TOL = 3e-3
# attention: bf16 2e-2, float32 2e-5 (flash) and 5e-6 (decode), the
# tolerances of tests/test_kernels.py
ATTN_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
DECODE_TOL = {torch.bfloat16: 2e-2, torch.float32: 5e-6}
# scans: float32 1e-4 (ssm) and 1e-5 (rglru), the tolerances of
# tests/test_kernels.py (the order of the FMA and of the sum over N);
# bf16 2e-2: kernel and plain version read the same bf16 inputs and carry
# the same float32 state, so they differ only by the rounding of y (or
# h_all) to bf16, one ulp of values up to ~4
SCAN_TOL = {torch.bfloat16: 2e-2}
# rmsnorm: bf16 2e-2, the tolerance of tests/test_kernels.py (one rounding
# of the output to bf16); float32 1e-5 (the order of the row's sum)
NORM_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _cnormal(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,block_n,unroll", [
    (4, 1024, 64, 512, 1),
    (64, 4000, 128, 500, 4),     # N no power of two (500 divides it)
    (2, 256, 8, 128, 8),
    (64, 4096, 128, 512, 8),     # HPEC set 1, 16-byte tap pairs
    (64, 4000, 128, 500, 1),     # the last thread stores 4 of its 8 outputs
    (3, 100, 7, 100, 1),         # K odd: the tap count padded to even
    (1, 4096, 16, 2048, 2),      # 256 threads, the most a block takes
])
def test_fir_kernel_matches_plain_on_cuda(cuda_device, m, n, k, block_n, unroll):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_cnormal(rng, m, n)).to(cuda_device)
    h = torch.from_numpy(_cnormal(rng, m, k)).to(cuda_device)
    before = fir.fir_filter_bank.launches
    got = fir.fir_filter_bank(x, h, block_n=block_n, tap_unroll=unroll)
    torch.cuda.synchronize()
    assert fir.fir_filter_bank.launches == before + 1
    torch.testing.assert_close(got, fir.fir_filter_bank_plain(x, h),
                               rtol=FIR_TOL, atol=FIR_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("num_x,num_k", [(300, 200), (4096, 2048), (1, 1)])
def test_mriq_kernel_matches_plain_on_cuda(cuda_device, num_x, num_k):
    rng = np.random.default_rng(4)
    xyz = [rng.standard_normal(num_x) for _ in range(3)]
    ks = [rng.standard_normal(num_k) * 0.1 for _ in range(3)]
    args = [torch.tensor(a, dtype=torch.float32, device=cuda_device)
            for a in (*xyz, *ks, rng.uniform(size=num_k))]
    before = mriq.mriq_compute_q.launches
    got = mriq.mriq_compute_q(*args)
    torch.cuda.synchronize()
    assert mriq.mriq_compute_q.launches == before + 1
    for g, w in zip(got, mriq.mriq_compute_q_plain(*args)):
        torch.testing.assert_close(g, w, rtol=MRIQ_TOL, atol=MRIQ_TOL)


@pytest.mark.cuda
def test_kernels_refuse_mixed_devices(cuda_device):
    x = torch.zeros(2, 64, dtype=torch.complex64, device=cuda_device)
    with pytest.raises(ValueError):
        fir.fir_filter_bank(x, torch.zeros(2, 8, dtype=torch.complex64))


def _normal(rng, shape, dtype, device):
    return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                        device=device).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,s,d,dtype,window,bq,bk", [
    (1, 32, 8, 2080, 128, torch.bfloat16, 0, 64, 64),     # largest bucket
    (1, 32, 8, 2080, 128, torch.bfloat16, 512, 128, 64),  # windowed
    (2, 4, 2, 128, 16, torch.bfloat16, 0, 64, 128),       # planner's shape
    (1, 8, 2, 300, 64, torch.float32, 48, 64, 64),        # ragged, f32
    (1, 32, 8, 8, 128, torch.bfloat16, 0, 64, 64),        # smallest bucket
])
def test_flash_kernel_matches_plain_on_cuda(cuda_device, b, hq, hkv, s, d,
                                            dtype, window, bq, bk):
    rng = np.random.default_rng(s + d)
    q = _normal(rng, (b, hq, s, d), dtype, cuda_device)
    k = _normal(rng, (b, hkv, s, d), dtype, cuda_device)
    v = _normal(rng, (b, hkv, s, d), dtype, cuda_device)
    before = FA.flash_attention.launches
    got = FA.flash_attention(q, k, v, window=window, block_q=bq, block_k=bk)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    want = FA.flash_attention_plain(q, k, v, window=window)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,s,d,dtype,window,bk", [
    (4, 32, 8, 2080, 128, torch.bfloat16, 0, 128),
    (4, 32, 8, 2080, 128, torch.bfloat16, 300, 64),
    (2, 8, 2, 512, 64, torch.float32, 0, 128),
    (3, 4, 2, 100, 16, torch.float32, 20, 128),
])
def test_decode_kernel_matches_plain_on_cuda(cuda_device, b, hq, hkv, s, d,
                                             dtype, window, bk):
    rng = np.random.default_rng(s)
    q = _normal(rng, (b, hq, 1, d), dtype, cuda_device)
    k = _normal(rng, (b, hkv, s, d), dtype, cuda_device)
    v = _normal(rng, (b, hkv, s, d), dtype, cuda_device)
    sp = torch.arange(s, dtype=torch.int32, device=cuda_device).repeat(b, 1)
    sp[0, s // 3:] = -1                                   # empty slots
    cur = torch.full((b,), s - 1, dtype=torch.int32, device=cuda_device)
    cur[0] = s // 3 - 1
    before = DA.decode_attention.launches
    got = DA.decode_attention(q, k, v, sp, cur, window=window, block_k=bk)
    torch.cuda.synchronize()
    assert DA.decode_attention.launches == before + 1
    want = DA.decode_attention_plain(q, k, v, sp, cur, window=window)
    tol = DECODE_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("s", [8, 300, 2080])
@pytest.mark.parametrize("d", [16, 64, 128, 256])
def test_flash_bf16_every_tile_point_on_cuda(cuda_device, d, s, window):
    """The wgmma body at every tile point the bf16 tuning space admits at
    this head width: S below one tile, ragged, and the largest bucket;
    causal, with and without a window."""
    rng = np.random.default_rng(d + s + window)
    q = _normal(rng, (1, 4, s, d), torch.bfloat16, cuda_device)
    k = _normal(rng, (1, 2, s, d), torch.bfloat16, cuda_device)
    v = _normal(rng, (1, 2, s, d), torch.bfloat16, cuda_device)
    want = FA.flash_attention_plain(q, k, v, window=window)
    points = [(bq, bk) for bq in FA.BLOCK_QS for bk in FA.BLOCK_KS
              if FA.fits(bq, bk, d, torch.bfloat16)]
    assert len(points) == (2 if d == 256 else 4)
    for bq, bk in points:
        before = FA.flash_attention.launches
        got = FA.flash_attention(q, k, v, window=window, block_q=bq,
                                 block_k=bk)
        torch.cuda.synchronize()
        assert FA.flash_attention.launches == before + 1
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2, msg=lambda m: f"{bq}x{bk}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48), (False, 0)],
                         ids=["causal", "window48", "bidirectional"])
@pytest.mark.parametrize("s", [8, 300, 2080])
@pytest.mark.parametrize("d", [16, 64, 128, 256])
def test_flash_f32_every_tile_point_on_cuda(cuda_device, d, s, causal, window):
    """The split-TF32 wgmma body at every tile point the float32 tuning
    space admits at this head width, within the float32 tolerance of the
    plain version: S below one tile, ragged, and the largest bucket; GQA
    5:1; causal, windowed and bidirectional.  A point the body is not built
    for raises."""
    rng = np.random.default_rng(d + s + window + causal)
    q = _normal(rng, (1, 5, s, d), torch.float32, cuda_device)
    k = _normal(rng, (1, 1, s, d), torch.float32, cuda_device)
    v = _normal(rng, (1, 1, s, d), torch.float32, cuda_device)
    want = FA.flash_attention_plain(q, k, v, causal=causal, window=window)
    points = [(bq, bk) for bq in FA.BLOCK_QS for bk in FA.BLOCK_KS
              if FA.fits(bq, bk, d, torch.float32)]
    assert len(points) == {16: 4, 64: 4, 128: 3, 256: 1}[d]
    for bq, bk in points:
        before = FA.flash_attention.launches
        got = FA.flash_attention(q, k, v, causal=causal, window=window,
                                 block_q=bq, block_k=bk)
        torch.cuda.synchronize()
        assert FA.flash_attention.launches == before + 1
        torch.testing.assert_close(got, want, rtol=ATTN_TOL[torch.float32],
                                   atol=ATTN_TOL[torch.float32],
                                   msg=lambda m: f"{bq}x{bk}: {m}")
    for bq, bk in [(32, 32), (128, 128)]:
        with pytest.raises(ValueError):
            FA.flash_attention(q, k, v, causal=causal, window=window,
                               block_q=bq, block_k=bk)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 128, 256])
def test_flash_bf16_bidirectional_on_cuda(cuda_device, d):
    rng = np.random.default_rng(d)
    q = _normal(rng, (2, 4, 300, d), torch.bfloat16, cuda_device)
    k = _normal(rng, (2, 1, 300, d), torch.bfloat16, cuda_device)
    v = _normal(rng, (2, 1, 300, d), torch.bfloat16, cuda_device)
    before = FA.flash_attention.launches
    got = FA.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    want = FA.flash_attention_plain(q, k, v, causal=False)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case,b,hq,hkv,s,d,window,bk", [
    ("S < block_k", 2, 8, 2, 40, 64, 0, 128),
    ("S = 1", 3, 8, 2, 1, 64, 0, 64),
    ("empties", 4, 32, 8, 700, 128, 0, 64),
    ("window", 4, 32, 8, 700, 128, 100, 64),
    ("all masked", 2, 8, 2, 300, 64, 0, 64),
    ("serving", 4, 32, 8, 2080, 128, 0, 64),
])
def test_decode_split_k_edges_on_cuda(cuda_device, dtype, case, b, hq, hkv, s,
                                      d, window, bk):
    rng = np.random.default_rng(s + d)
    q = _normal(rng, (b, hq, 1, d), dtype, cuda_device)
    k = _normal(rng, (b, hkv, s, d), dtype, cuda_device)
    v = _normal(rng, (b, hkv, s, d), dtype, cuda_device)
    sp = torch.arange(s, dtype=torch.int32, device=cuda_device).repeat(b, 1)
    cur = torch.full((b,), s - 1, dtype=torch.int32, device=cuda_device)
    if case in ("empties", "window"):
        for i, n in enumerate((s, s - 3, s // 2, 5)[:b]):
            sp[i, n:] = -1
            cur[i] = n - 1
    if case == "all masked":
        sp[0] = -1                       # row 0: every slot empty
    if not DA.fits(hq // hkv, d, bk, dtype):
        bk = 64
    before = DA.decode_attention.launches
    got = DA.decode_attention(q, k, v, sp, cur, window=window, block_k=bk)
    torch.cuda.synchronize()
    assert DA.decode_attention.launches == before + 1
    want = DA.decode_attention_plain(q, k, v, sp, cur, window=window)
    tol = DECODE_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if case == "serving":
        assert DA.decode_splits(b * hkv, s, bk)[0] * b * hkv >= 264


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["dtype", "noncontig"])
def test_attention_wrappers_raise_on_cuda(cuda_device, bad):
    rng = np.random.default_rng(0)
    dt = torch.float16 if bad == "dtype" else torch.bfloat16
    q = _normal(rng, (1, 4, 32, 16), dt, cuda_device)
    k = _normal(rng, (1, 2, 32, 16), dt, cuda_device)
    v = _normal(rng, (1, 2, 32, 16), dt, cuda_device)
    qd = _normal(rng, (1, 4, 1, 16), dt, cuda_device)
    sp = torch.arange(32, dtype=torch.int32, device=cuda_device)[None]
    cur = torch.tensor([31], dtype=torch.int32, device=cuda_device)
    if bad == "noncontig":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
        k = k.transpose(2, 3).contiguous().transpose(2, 3)
    flash_before = FA.flash_attention.launches
    decode_before = DA.decode_attention.launches
    with pytest.raises((TypeError, ValueError)):
        FA.flash_attention(q, k, v)
    with pytest.raises((TypeError, ValueError)):
        DA.decode_attention(qd, k, v, sp, cur)
    assert FA.flash_attention.launches == flash_before
    assert DA.decode_attention.launches == decode_before


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,n,dtype,bc,tc", [
    (1, 2080, 8192, 16, torch.bfloat16, 16, 16),   # falcon-mamba's bucket
    (1, 16, 8192, 16, torch.bfloat16, 32, 8),      # smallest bucket
    (2, 9, 300, 16, torch.float32, 4, 8),          # ragged S and D
    (2, 128, 128, 8, torch.bfloat16, 8, 32),       # the planner's reduced
    (3, 37, 12, 4, torch.float32, 16, 16),
])
def test_ssm_kernel_matches_plain_on_cuda(cuda_device, b, s, d, n, dtype,
                                          bc, tc):
    rng = np.random.default_rng(s + d)
    a = torch.tensor(rng.uniform(0.5, 1.0, (b, s, d, n)), dtype=torch.float32,
                     device=cuda_device).to(dtype)
    bx = _normal(rng, (b, s, d, n), dtype, cuda_device)
    c = _normal(rng, (b, s, n), dtype, cuda_device)
    h0 = _normal(rng, (b, d, n), torch.float32, cuda_device)
    before = SS.ssm_scan.launches
    y, hf = SS.ssm_scan(a, bx, c, h0, block_c=bc, time_chunk=tc)
    torch.cuda.synchronize()
    assert SS.ssm_scan.launches == before + 1
    wy, wh = SS.ssm_scan_plain(a, bx, c, h0)
    tol = SCAN_TOL.get(dtype, 1e-4)
    torch.testing.assert_close(y.float(), wy.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(hf, wh, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,dtype,bc,tc", [
    (1, 2080, 2560, torch.bfloat16, 128, 16),      # recurrentgemma's bucket
    (1, 16, 2560, torch.bfloat16, 128, 16),
    (2, 9, 300, torch.float32, 64, 16),            # ragged S and D
    (2, 128, 64, torch.bfloat16, 256, 32),         # the planner's reduced
    (1, 31, 2560, torch.bfloat16, 128, 32),        # one chunk, one step short
    (1, 32, 2560, torch.bfloat16, 128, 32),        # one whole chunk
    (1, 33, 2560, torch.bfloat16, 128, 32),        # a second chunk of 1 step
    (2, 3000, 300, torch.bfloat16, 128, 32),       # 94 chunks: 3 groups a row
    (1, 2100, 301, torch.bfloat16, 64, 64),        # D odd: single bf16 words
    (3, 40000, 300, torch.bfloat16, 256, 16),      # 2,500 x 2 x 3 blocks
    (2, 2000, 77, torch.float32, 256, 64),
])
def test_rglru_kernel_matches_plain_on_cuda(cuda_device, b, s, d, dtype, bc,
                                            tc):
    rng = np.random.default_rng(s + d)
    a = torch.tensor(rng.uniform(0.5, 1.0, (b, s, d)), dtype=torch.float32,
                     device=cuda_device).to(dtype)
    bb = _normal(rng, (b, s, d), dtype, cuda_device)
    h0 = _normal(rng, (b, d), torch.float32, cuda_device)
    before = RS.rglru_scan.launches
    h_all, hf = RS.rglru_scan(a, bb, h0, block_c=bc, time_chunk=tc)
    torch.cuda.synchronize()
    assert RS.rglru_scan.launches == before + 1
    wa, wh = RS.rglru_scan_plain(a, bb, h0)
    tol = SCAN_TOL.get(dtype, 1e-5)
    torch.testing.assert_close(h_all.float(), wa.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(hf, wh, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rglru_kernel_exact_decays_and_graph_replays_on_cuda(cuda_device,
                                                             dtype):
    """a with exact 0s (the carry is cut) and 1s (it passes whole); the
    launch captured in a CUDA graph and replayed on these inputs, on others
    and on these again, its outputs poisoned before each replay: every
    replay gives the eager result bit for bit (the status words are
    cleared inside the launch, so no replay reads the last one's values)."""
    rng = np.random.default_rng(5)
    a = rng.uniform(0.5, 1.0, (2, 3000, 300))
    a[:, ::5] = 0.0
    a[:, 2::7] = 1.0
    a = torch.tensor(a, dtype=torch.float32, device=cuda_device).to(dtype)
    bb = _normal(rng, (2, 3000, 300), dtype, cuda_device)
    h0 = _normal(rng, (2, 300), torch.float32, cuda_device)
    eager = RS.rglru_scan(a, bb, h0)
    wa, wh = RS.rglru_scan_plain(a, bb, h0)
    tol = SCAN_TOL.get(dtype, 1e-5)
    torch.testing.assert_close(eager[0].float(), wa.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(eager[1], wh, rtol=1e-5, atol=1e-5)
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        RS.rglru_scan(a, bb, h0)                 # warm-up off the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = RS.rglru_scan(a, bb, h0)
    first = (a.clone(), bb.clone())
    other = (a.flip(1), bb.flip(1))
    other_eager = RS.rglru_scan(*other, h0)
    for (ai, bi), want in ((first, eager), (other, other_eager),
                           (first, eager)):
        a.copy_(ai)
        bb.copy_(bi)
        for t in out:
            t.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("s,dtype,window,bq,bk", [
    (2080, torch.bfloat16, 2048, 64, 64),    # recurrentgemma's local attention
    (2048, torch.bfloat16, 2048, 128, 64),
    (300, torch.float32, 48, 64, 32),        # ragged, windowed, f32
])
def test_flash_kernel_at_head_dim_256_on_cuda(cuda_device, s, dtype, window,
                                              bq, bk):
    rng = np.random.default_rng(s)
    q = _normal(rng, (1, 10, s, 256), dtype, cuda_device)
    k = _normal(rng, (1, 1, s, 256), dtype, cuda_device)
    v = _normal(rng, (1, 1, s, 256), dtype, cuda_device)
    before = FA.flash_attention.launches
    got = FA.flash_attention(q, k, v, window=window, block_q=bq, block_k=bk)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    want = FA.flash_attention_plain(q, k, v, window=window)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    with pytest.raises(ValueError):   # bf16: no block_k 32; f32: 270 KB
        FA.flash_attention(q, k, v, block_q=128, block_k=32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,w_dtype", [
    ((1, 2048, 5120), torch.bfloat16, torch.bfloat16),   # Mistral's prefill
    ((1, 2080, 4096), torch.bfloat16, torch.bfloat16),   # falcon-mamba's
    ((1, 2080, 2560), torch.bfloat16, torch.bfloat16),   # recurrentgemma's
    ((4, 1, 5120), torch.bfloat16, torch.bfloat16),      # a decode step
    ((9, 300), torch.bfloat16, torch.bfloat16),          # rows off 16 bytes
    ((4, 100, 512), torch.bfloat16, torch.float32),      # f32 w, bf16 x
    ((2, 3, 5, 128), torch.float32, torch.float32),
    ((9, 300), torch.float32, torch.float32),
    ((3, 20000), torch.bfloat16, torch.bfloat16),        # rows past registers
    ((2, 5120), torch.float32, torch.float32),           # the same in f32
])
def test_rmsnorm_kernel_matches_plain_on_cuda(cuda_device, shape, dtype,
                                              w_dtype):
    rng = np.random.default_rng(shape[-1])
    x = _normal(rng, shape, dtype, cuda_device)
    w = _normal(rng, (shape[-1],), w_dtype, cuda_device) * 0.1
    before = RN.rmsnorm.launches
    got = RN.rmsnorm(x, w, eps=1e-5)
    torch.cuda.synchronize()
    assert RN.rmsnorm.launches == before + 1
    assert got.shape == x.shape and got.dtype == x.dtype
    tol = NORM_TOL[dtype]
    torch.testing.assert_close(got.float(), rmsnorm_plain(x, w, 1e-5).float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
def test_rmsnorm_kernel_strided_rows_and_refusals(cuda_device):
    rng = np.random.default_rng(1)
    wide = _normal(rng, (9, 320), torch.bfloat16, cuda_device)
    x = wide[:, :300]                       # row stride 320: no copy
    w = _normal(rng, (300,), torch.bfloat16, cuda_device)
    got = RN.rmsnorm(x, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), rmsnorm_plain(x, w).float(),
                               rtol=2e-2, atol=2e-2)
    before = RN.rmsnorm.launches
    with pytest.raises(ValueError):         # last dim not contiguous
        RN.rmsnorm(wide.t(), _normal(rng, (9,), torch.bfloat16, cuda_device))
    with pytest.raises(ValueError):         # leading dims not one row axis
        RN.rmsnorm(_normal(rng, (4, 6, 64), torch.bfloat16,
                           cuda_device).transpose(0, 1), w[:64].contiguous())
    with pytest.raises(TypeError):
        RN.rmsnorm(x.half(), w)
    assert RN.rmsnorm.launches == before


def _reduced_mistral(device, seq=32):
    from repro_torch.configs.base import get_config
    from repro_torch.core.regions import Impl
    from repro_torch.models import factory as F
    cfg = get_config("mistral-nemo-12b").reduced()
    params = F.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    fwd = F.make_forward(cfg, Impl())
    tokens = torch.from_numpy(F.synthetic_batch(cfg, 1, seq, seed=1)["tokens"])
    return (lambda t: fwd(params, {"tokens": t})), (tokens.to(device),)


@pytest.mark.cuda
def test_capture_on_cuda_fake_tensors(cuda_device):
    """The capture of a forward whose weights live on the card: they become
    constants (references), the unembedding takes its card-only bf16 x bf16
    -> float32 product, and the graph replays on the card."""
    from repro_torch.core import extract as E
    fn, args = _reduced_mistral(cuda_device)
    report = E.extract(fn, args, name="mistral-cuda")
    assert set(report.families) == {"attn_core", "mlp_core", "rmsnorm",
                                    "rmsnorm+mlp_core"}, report.summary()
    gm = report.graph_module
    assert any(str(n.target) == "aten.mm.dtype" for n in gm.graph.nodes)
    torch.testing.assert_close(gm(*args), fn(*args), rtol=0, atol=0)


@pytest.mark.cuda
def test_discovered_mistral_rmsnorm_hopper_on_cuda(cuda_device):
    from repro_torch.core import extract as E
    from repro_torch.core.regions import Impl
    fn, args = _reduced_mistral(cuda_device)
    prog = E.discover(fn, args, name="mistral-cuda")
    ref = prog.build(Impl())(*args)
    before = RN.rmsnorm.launches
    got = prog.build(Impl({"rmsnorm": "hopper"}))(*args)
    torch.cuda.synchronize()
    # 2 layers x 2 norms + the final norm
    assert RN.rmsnorm.launches == before + 5
    assert bool(torch.isfinite(got).all())
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) / scale < 5e-2


# ---------------------------------------------------------------------------
# the serving engine's CUDA graphs (serving/graphs.py), reduced models in
# their serving type (bf16) with the hopper kernels on the prefill path
# ---------------------------------------------------------------------------
GRAPH_HOPPER = {"mistral-nemo-12b": {"attn_core": "hopper"},
                "falcon-mamba-7b": {"ssm_scan": "hopper"},
                "recurrentgemma-2b": {"rglru_scan": "hopper",
                                      "attn_core": "hopper"},
                "mixtral-8x7b": {"attn_core": "hopper"}}
GRAPH_CTX = 32


def _graph_model(arch, device):
    from repro_torch.configs.base import get_config
    from repro_torch.core.regions import Impl
    from repro_torch.models import factory as F
    cfg = get_config(arch).reduced()
    params = F.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    impl = Impl({**F.default_impl(cfg), **GRAPH_HOPPER[arch]})
    return cfg, params, impl


def _padded(n, bucket, seed):
    tokens = np.zeros((1, bucket), np.int32)
    tokens[0, :n] = np.random.default_rng(seed).integers(0, 256, n)
    return tokens


def _eager_prefill(step, params, tokens, n, device):
    return step(params, {"tokens": torch.from_numpy(tokens).to(device)},
                torch.tensor(n, dtype=torch.int32, device=device))


def _slot_leaves(cache, slot):
    from repro_torch.models.params import tree_leaves
    return [t[:, slot] if top == "stack" else t[slot]
            for top, sub in cache.items() for t in tree_leaves(sub)]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(GRAPH_HOPPER))
def test_step_graphs_replay_the_eager_steps_bit_for_bit_on_cuda(cuda_device,
                                                                arch):
    """Prefill graphs (one per bucket, fed every length in it) and the
    decode graph (captured against a live cache, warmed on another) give
    the eager step functions' logits and cache leaves bit for bit, step
    after step, with greedy tokens fed back."""
    from repro_torch.models import factory as F
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.serving.engine import cache_insert
    from repro_torch.serving.graphs import StepGraph
    cfg, params, impl = _graph_model(arch, cuda_device)
    prefill = F.make_bucketed_prefill_step(cfg, impl=impl, ctx=GRAPH_CTX)
    decode = F.make_serve_step(cfg, impl=impl)

    def prefill_fn(p, tokens, length):
        return prefill(p, {"tokens": tokens}, length)

    live = F.init_cache(cfg, 2, GRAPH_CTX, cuda_device)
    graphs = {b: StepGraph(prefill_fn, (params,),
                           {"tokens": np.zeros((1, b), np.int32),
                            "length": np.asarray(b, np.int32)})
              for b in (8, 16)}
    last = np.zeros(2, np.int32)
    for slot, (n, bucket) in enumerate(((5, 8), (13, 16))):
        for m in (n, bucket, 1):                  # every length in a bucket
            tokens = _padded(m, bucket, seed=m)
            g_logits, g_cache = graphs[bucket](tokens, np.asarray(m, np.int32))
            e_logits, e_cache = _eager_prefill(prefill, params, tokens, m,
                                               cuda_device)
            assert torch.equal(g_logits, e_logits), (bucket, m)
            for a, b in zip(tree_leaves(g_cache), tree_leaves(e_cache)):
                assert torch.equal(a, b), (bucket, m)
        cache_insert(live, e_cache, slot)
        last[slot] = int(e_logits[0, -1].argmax())
    twin = tree_map(lambda t: t.clone(), live)
    step = StepGraph(decode, (params, live),
                     {"tokens": np.zeros((2, 1), np.int32),
                      "pos": np.zeros(2, np.int32)},
                     warm_fixed=(params, F.init_cache(cfg, 2, GRAPH_CTX,
                                                      cuda_device)))
    pos = np.array([5, 13], np.int32)
    for _ in range(4):
        g_logits, _ = step(last[:, None], pos)
        e_logits, _ = decode(params, twin,
                             torch.from_numpy(last[:, None]).to(cuda_device),
                             torch.from_numpy(pos).to(cuda_device))
        assert torch.equal(g_logits, e_logits)
        for a, b in zip(tree_leaves(live), tree_leaves(twin)):
            assert torch.equal(a, b)
        last = e_logits[:, -1].argmax(-1).to(torch.int32).cpu().numpy()
        pos = pos + 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(GRAPH_HOPPER))
def test_step_graph_launch_counters_count_replays_on_cuda(cuda_device, arch):
    """A capture launches no kernel, so it adds nothing to the counters;
    every replay adds what one eager call launches."""
    from repro_torch.kernels import launch_counters
    from repro_torch.models import factory as F
    from repro_torch.serving.graphs import StepGraph
    cfg, params, impl = _graph_model(arch, cuda_device)
    prefill = F.make_bucketed_prefill_step(cfg, impl=impl, ctx=GRAPH_CTX)
    counters = launch_counters()

    def counts():
        return {c.__name__: c.launches for c in counters}

    tokens = _padded(6, 8, seed=0)
    before = counts()
    _eager_prefill(prefill, params, tokens, 6, cuda_device)
    torch.cuda.synchronize()
    per_call = {k: v - before[k] for k, v in counts().items()}
    assert any(per_call.values()), per_call
    before = counts()
    graph = StepGraph(lambda p, t, n: prefill(p, {"tokens": t}, n), (params,),
                      {"tokens": tokens, "length": np.asarray(8, np.int32)})
    # the warm-up is one eager call; the capture adds nothing
    assert counts() == {k: before[k] + per_call[k] for k in before}
    for replay in range(1, 4):
        graph(tokens, np.asarray(6, np.int32))
        assert counts() == {k: before[k] + (1 + replay) * per_call[k]
                            for k in before}


@pytest.mark.cuda
def test_a_host_sync_in_a_step_makes_capture_raise_on_cuda(cuda_device):
    """``.item()`` inside a step fails its capture, and StepGraph raises
    (no eager fallback).  Run in a child process, so that the failed
    capture leaves no state behind in this one."""
    import os
    import subprocess
    import sys
    import textwrap
    from pathlib import Path
    script = textwrap.dedent("""
        import numpy as np, torch
        from repro_torch.kernels import launch_counters
        from repro_torch.serving.graphs import StepGraph
        w = torch.ones(4, device="cuda")
        before = [c.launches for c in launch_counters()]
        try:
            StepGraph(lambda w, x: w * x.sum().item(), (w,),
                      {"x": np.ones(4, np.float32)})
        except Exception as err:
            print("raised", type(err).__name__, str(err).splitlines()[0])
        else:
            print("captured")
        assert [c.launches for c in launch_counters()] == before
    """)
    src = str(Path(__file__).resolve().parents[1] / "src")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": src})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("raised"), out.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(GRAPH_HOPPER))
def test_prefill_replays_of_two_buckets_keep_each_slot_on_cuda(cuda_device,
                                                               arch):
    """The shared-pool rule: both buckets captured first (bucket 16's
    outputs may lie where bucket 8 keeps its intermediates), then prefill
    replays of buckets 8, 16 and 8 into three slots — each slot holds its
    own request's eager prefill cache afterwards."""
    from repro_torch.models import factory as F
    from repro_torch.serving.engine import ServeEngine, cache_insert
    cfg, params, impl = _graph_model(arch, cuda_device)
    eng = ServeEngine(cfg, params, slots=3, ctx=GRAPH_CTX, impl=impl)
    gen = eng._gen
    gen.prefill.warm(8)
    gen.prefill.warm(16)
    assert eng.prefill_traces == 2
    prefill = F.make_bucketed_prefill_step(cfg, impl=impl, ctx=GRAPH_CTX)
    want = []
    for slot, (n, bucket) in enumerate(((5, 8), (14, 16), (7, 8))):
        tokens = _padded(n, bucket, seed=10 + slot)
        logits, one, finite = gen.prefill(tokens, n)
        assert bool(finite)
        cache_insert(eng.cache, one, slot)
        e_logits, e_cache = _eager_prefill(prefill, params, tokens, n,
                                           cuda_device)
        assert torch.equal(logits, e_logits)
        want.append(_slot_leaves(e_cache, 0))
    assert eng.prefill_traces == 2
    for slot, leaves in enumerate(want):
        for got, exp in zip(_slot_leaves(eng.cache, slot), leaves):
            assert torch.equal(got, exp), slot


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(GRAPH_HOPPER))
def test_graph_engine_serves_the_eager_twins_streams_on_cuda(cuda_device,
                                                            arch):
    """The engine (graphs) and an eager twin (the same step functions,
    called eagerly) serve the same greedy streams over mixed buckets; a
    second round on the graph engine captures nothing new."""
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.graphs import EagerStep

    class EagerTwin(ServeEngine):
        def _make_step(self, fn, fixed, feeds, **_):
            return EagerStep(fn, fixed)

    cfg, params, impl = _graph_model(arch, cuda_device)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, n).astype(np.int32)
               for n in (3, 12, 7, 16, 9)]
    runs = []
    for cls in (ServeEngine, EagerTwin):
        eng = cls(cfg, params, slots=2, ctx=GRAPH_CTX, impl=impl)
        rounds = []
        for _ in range(2):
            for p in prompts:
                eng.submit(p, max_new_tokens=6)
            eng.run_to_completion()
            rounds.append([r.generated for r in eng.drain_finished()])
            assert eng.prefill_traces == 2          # buckets 8 and 16
        assert rounds[0] == rounds[1]
        runs.append(rounds[0])
    assert runs[0] == runs[1]


# ---------------------------------------------------------------------------
# slice 9: the MoE layer on the card (no kernel of its own: bmm, sort,
# gather and scatter)
# ---------------------------------------------------------------------------
def _moe_weights(device, t, d, f, e, seed, w_scale=1.0):
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape, fan_in):
        return (torch.randn(shape, generator=g, device=device)
                * (w_scale / fan_in ** 0.5)).to(torch.bfloat16)

    x = normal(t, d, fan_in=1)
    return x, {"router": normal(d, e, fan_in=d),
               "w_gate": normal(e, d, f, fan_in=d),
               "w_up": normal(e, d, f, fan_in=d),
               "w_down": normal(e, f, d, fan_in=f)}


@pytest.mark.cuda
def test_expert_choice_combine_is_bit_identical_across_replays_on_cuda(
        cuda_device):
    """The expert-choice combine adds the experts' outputs one expert at a
    time, without atomics: two eager calls, two CUDA-graph replays (outputs
    poisoned before each) and the eager call agree bit for bit, with every
    token picked by several experts (capacity 640 of 2,048 tokens)."""
    from repro_torch.models import moe as M
    x, p = _moe_weights(cuda_device, 2048, 512, 1024, 8, seed=1)
    kw = {"num_experts": 8, "k": 2, "capacity_factor": 1.25}
    want = M.moe_expert_choice(x, p, **kw)
    assert torch.equal(M.moe_expert_choice(x, p, **kw), want)
    xin = x.clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        M.moe_expert_choice(xin, p, **kw)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = M.moe_expert_choice(xin, p, **kw)
    for _ in range(2):
        out.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)
    picks = M.top_k(M.router_probs(x, p["router"]).t(), 640)[1]
    assert int(torch.bincount(picks.flatten(), minlength=2048).max()) > 1
    del graph


@pytest.mark.cuda
def test_moe_dispatch_ref_matches_offload_at_full_width_on_cuda(cuda_device):
    """One mixtral-8x7b layer's routed block at a prefill of 2,048 tokens
    (capacity 640; expert 0 favoured, so tokens drop): the dense one-hot
    dispatch and the scatter slots are the same token-choice routing; they
    differ only
    in where the combine rounds to bf16 (tolerance 2e-2, the bf16
    tolerance of tests/test_kernels.py, on outputs of unit scale)."""
    from repro_torch.core.regions import variants
    from repro_torch.models import moe as M
    x, p = _moe_weights(cuda_device, 2048, 4096, 14336, 8, seed=2)
    # favour expert 0 for every token, so that its queue overflows
    x[:, 0] = x[:, 0].abs() + 1
    p["router"][0, 0] = 1
    cap = M.moe_capacity(2048, 8, 2, 1.25)
    assert cap == 640
    args = (x, p["router"], p["w_gate"], p["w_up"], p["w_down"])
    kw = {"num_experts": 8, "k": 2, "capacity": cap}
    ref = variants("moe_dispatch")["ref"](*args, **kw)
    off = variants("moe_dispatch")["offload"](*args, **kw)
    assert ref.dtype == off.dtype == torch.bfloat16
    assert bool(torch.isfinite(ref).all())
    torch.testing.assert_close(off.float(), ref.float(), rtol=2e-2, atol=2e-2)
    _, _, _, _, keep = M.route_tokens(x, p["router"], 8, 2, cap)
    assert not bool(keep.all())                  # the capacity binds
    dropped = ~keep.any(-1)
    assert bool((ref[dropped] == 0).all()) and bool((off[dropped] == 0).all())


# ---------------------------------------------------------------------------
# slice 8: a generation prepared on another thread, the device-side fault
# seam, and the drain after a run timeout
# ---------------------------------------------------------------------------
PROBE = {"replan_probe": "offload"}     # a region no block dispatches


@pytest.mark.cuda
def test_capture_on_a_worker_thread_while_the_engine_replays_on_cuda(
        cuda_device):
    """``prepare_plan`` on a worker thread captures its graphs (thread_local
    mode, its own side stream, its own pool) while the main thread keeps
    ticking the engine's replays; the swapped-in generation then serves,
    and every stream equals a never-swapped twin's bit for bit."""
    import threading
    from repro_torch.serving.engine import ServeEngine
    arch = "recurrentgemma-2b"
    cfg, params, impl = _graph_model(arch, cuda_device)
    eng = ServeEngine(cfg, params, slots=2, ctx=GRAPH_CTX, impl=impl)
    twin = ServeEngine(cfg, params, slots=2, ctx=GRAPH_CTX, impl=impl)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 256, n).astype(np.int32)
               for n in (3, 12, 7, 16, 9, 5, 14, 6)]
    for e in (eng, twin):
        for p in prompts[:2]:
            e.submit(p, max_new_tokens=12)
        e.step()                        # buckets 8 and 16 captured
    box = {}

    def prepare():
        try:
            box["gen"] = eng.prepare_plan({**impl, **PROBE})
        except BaseException as err:  # noqa: BLE001 — asserted below
            box["err"] = err

    worker = threading.Thread(target=prepare)
    worker.start()
    ticks_meanwhile = 0
    while worker.is_alive():
        eng.step()
        ticks_meanwhile += 1
        if not eng.busy:
            eng.submit(prompts[2], max_new_tokens=4)
            twin.submit(prompts[2], max_new_tokens=4)
    worker.join()
    for _ in range(ticks_meanwhile):
        twin.step()
    assert "err" not in box, box.get("err")
    gen = box["gen"]
    assert gen.decode.step.graph is not None and set(gen.prefill.steps) == {
        (8, None), (16, None)}
    assert gen.decode._pool != eng._gen.decode._pool   # a pool of its own
    eng.offer_plan(gen)
    for e in (eng, twin):
        for p in prompts[3:]:
            e.submit(p, max_new_tokens=6)
    done, want = eng.run_to_completion(), twin.run_to_completion()
    assert eng.swaps == 1 and eng.rollbacks == 0
    assert [r.generated for r in done] == [r.generated for r in want]


@pytest.mark.cuda
def test_device_nan_flag_in_a_replayed_graph_rolls_back_on_cuda(cuda_device):
    """A generation captured through ``DeviceNaN`` while disarmed replays
    NaN once armed: the finite flag that comes back with the tokens rolls
    the engine back within the tick, the recurrent state the faulted
    decode overwrote is restored, and the streams equal a twin's."""
    from repro_torch.core.faults import DeviceNaN
    from repro_torch.serving.engine import ServeEngine
    cfg, params, impl = _graph_model("recurrentgemma-2b", cuda_device)
    fault = DeviceNaN("mlp_core", base="ref", name="nan")
    try:
        eng = ServeEngine(cfg, params, slots=2, ctx=GRAPH_CTX, impl=impl)
        twin = ServeEngine(cfg, params, slots=2, ctx=GRAPH_CTX, impl=impl)
        rng = np.random.default_rng(4)
        prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (5, 11)]
        for e in (eng, twin):
            for p in prompts:
                e.submit(p, max_new_tokens=10)
            for _ in range(3):
                e.step()
        bad = eng.prepare_plan({**impl, "mlp_core": "nan"})  # captured clean
        fault.arm()
        eng.offer_plan(bad)
        eng.step()
        twin.step()
        assert eng.rollbacks == 1 and eng.degraded
        assert "non-finite" in eng.stats()["last_fault"]
        done, want = eng.run_to_completion(), twin.run_to_completion()
        assert [r.generated for r in done] == [r.generated for r in want]
        # the faulted generation left the trace memo: once nothing else
        # refers to it, its graphs and their pool are freed
        assert bad.key not in eng._trace_memo
        torch.cuda.synchronize(cuda_device)
        torch.cuda.empty_cache()
        held = torch.cuda.memory_reserved(cuda_device)
        del bad
        gc.collect()
        torch.cuda.empty_cache()
        assert torch.cuda.memory_reserved(cuda_device) < held
    finally:
        fault.close()


@pytest.mark.cuda
def test_a_run_timeout_drains_the_device_on_cuda(cuda_device):
    """A call whose thread outlives ``run_timeout_s`` is abandoned, and its
    launch still running on the card is drained before time_callable
    returns: the Measurement says ``drained`` and the stream is idle."""
    import time
    from repro_torch.core.search import time_callable
    x = torch.ones(4, device=cuda_device)

    def stuck(x):
        torch.cuda._sleep(1_500_000_000)      # ~1 s of device time
        time.sleep(3.0)                       # the host thread hangs too
        return x

    m = time_callable(stuck, (x,), warmup=0, reps=1, run_timeout_s=0.5)
    assert not m.ok and "RunTimeout" in m.error and m.drained
    assert m.failure_kind == "transient"
    assert torch.cuda.current_stream(cuda_device).query()
    own = time_callable(lambda t: t * 2, (x,), warmup=1, reps=3)
    assert own.ok and len(own.runs) == 3


# ---------------------------------------------------------------------------
# slice 10: the frontends (no kernel of their own; flash in two new regimes)
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_flash_bidirectional_at_whisper_encoder_shape_on_cuda(cuda_device):
    """whisper-small's encoder: [1, 12/12, 1,500, 64], causal=False, S no
    multiple of a tile."""
    rng = np.random.default_rng(1500)
    q, k, v = (_normal(rng, (1, 12, 1500, 64), torch.bfloat16, cuda_device)
               for _ in range(3))
    before = FA.flash_attention.launches
    got = FA.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    want = FA.flash_attention_plain(q, k, v, causal=False)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [272, 768, 2080])
def test_flash_paligemma_ragged_causal_gqa_on_cuda(cuda_device, s):
    """paligemma-3b's prefill: 8 query heads over 1 kv head of width 256,
    causal over the 256-patch prefix and a bucket (16, 512, 1,824)."""
    rng = np.random.default_rng(s)
    q = _normal(rng, (1, 8, s, 256), torch.bfloat16, cuda_device)
    k = _normal(rng, (1, 1, s, 256), torch.bfloat16, cuda_device)
    v = _normal(rng, (1, 1, s, 256), torch.bfloat16, cuda_device)
    got = FA.flash_attention(q, k, v)
    want = FA.flash_attention_plain(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


# ---------------------------------------------------------------------------
# the bf16 work split (split-KV) and its combine
# ---------------------------------------------------------------------------
def _cut(q, k, v, plan):
    """o of the split kernel and its combine under ``plan``'s cut (any
    chunk_tiles), from the C entry points on the current stream."""
    lib, (b, hq, s, d) = FA._lib(), q.shape
    o = torch.empty_like(q)
    part = (torch.empty(plan.workspace_floats, dtype=torch.float32,
                        device=q.device) if plan.partials else None)
    stream = torch.cuda.current_stream().cuda_stream
    ptr = part.data_ptr() if part is not None else None
    FA._build.check(lib.flash_attention_launch_schedule(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hq,
        k.shape[1], s, d, plan.block_q, plan.block_k, int(plan.causal),
        plan.window, 1 / np.sqrt(d), 1, plan.chunk_tiles, ptr,
        part.numel() if part is not None else 0, stream), lib, "split")
    if part is not None:
        FA._build.check(lib.flash_attention_combine_launch(
            ptr, o.data_ptr(), b, hq, s, d, plan.block_q, plan.block_k,
            int(plan.causal), plan.window, plan.chunk_tiles, stream), lib,
            "combine")
    return o


@pytest.mark.cuda
@pytest.mark.parametrize("case,b,hq,hkv,s,d,causal,window,bq,bk", [
    ("3p S=768", 1, 8, 1, 768, 256, True, 0, 128, 64),
    ("window empties chunks", 1, 4, 2, 700, 64, True, 150, 128, 64),
    ("S < block_q", 1, 4, 1, 100, 64, True, 0, 128, 64),
    ("B > 1, ragged", 3, 4, 2, 650, 256, True, 0, 64, 64),
    ("3w bidirectional", 1, 12, 12, 1500, 64, False, 0, 128, 128),
    ("bidirectional window", 2, 4, 4, 900, 64, False, 200, 64, 128),
])
def test_flash_every_split_cut_matches_plain_on_cuda(cuda_device, case, b,
                                                     hq, hkv, s, d, causal,
                                                     window, bq, bk):
    """Every distinct cut of the kv ranges (chunk_tiles from none down to
    2 tiles), each within 2e-2 of the plain version; a chunk that the
    window or the causal corner empties for some rows weighs 0."""
    rng = np.random.default_rng(s + d + window)
    q = _normal(rng, (b, hq, s, d), torch.bfloat16, cuda_device)
    k = _normal(rng, (b, hkv, s, d), torch.bfloat16, cuda_device)
    v = _normal(rng, (b, hkv, s, d), torch.bfloat16, cuda_device)
    want = FA.flash_attention_plain(q, k, v, causal=causal, window=window)
    longest = max(e - lo for lo, e in (
        FA.visit_range(t, s, bq, bk, causal, window)
        for t in range(-(-s // bq))))
    seen = set()
    for t in [0] + list(range(longest - 1, 1, -1)):
        plan = FA.SplitPlan(b, hq, s, d, bq, bk, causal, window, t)
        key = tuple(len(c) for _, c in plan.tiles)
        if key in seen:
            continue
        seen.add(key)
        got = _cut(q, k, v, plan)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2, msg=lambda m: f"cut {t}: {m}")
    assert len(seen) > (1 if case != "S < block_q" else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("s,d,causal", [(768, 256, True), (272, 256, True),
                                         (1500, 64, False)])
def test_flash_split_call_counts_replays_bit_equal_on_cuda(cuda_device, s, d,
                                                           causal):
    """The wrapper on rows 3p and 3w: one flash launch a call, one combine
    launch where the plan splits; two calls and a CUDA-graph replay (the
    workspace from the graph's pool) bit-equal to an eager call."""
    hq, hkv = (8, 1) if d == 256 else (12, 12)
    rng = np.random.default_rng(s)
    q = _normal(rng, (1, hq, s, d), torch.bfloat16, cuda_device)
    k = _normal(rng, (1, hkv, s, d), torch.bfloat16, cuda_device)
    v = _normal(rng, (1, hkv, s, d), torch.bfloat16, cuda_device)
    plan = FA.device_plan(cuda_device, 1, hq, s, d,
                          *FA.default_tiles(torch.bfloat16, d), causal, 0)
    before = (FA.flash_attention.launches, FA.flash_attention_combine.launches)
    first = FA.flash_attention(q, k, v, causal=causal)
    second = FA.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before[0] + 2
    assert (FA.flash_attention_combine.launches
            == before[1] + (2 if plan.partials else 0))
    assert torch.equal(first, second)
    torch.testing.assert_close(
        first.float(), FA.flash_attention_plain(q, k, v, causal=causal).float(),
        rtol=2e-2, atol=2e-2)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        FA.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = FA.flash_attention(q, k, v, causal=causal)
    for _ in range(2):
        out.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first)
    del graph


@pytest.mark.cuda
def test_flash_combine_kernel_matches_its_plain_version_on_cuda(cuda_device):
    """The combine alone on partials the split kernel wrote, against
    ``flash_attention_combine_plain`` on the same partials; a launch whose
    chunk_tiles is not the card's plan raises."""
    b, hq, s, d = 1, 8, 768, 256
    rng = np.random.default_rng(7)
    q = _normal(rng, (b, hq, s, d), torch.bfloat16, cuda_device)
    k = _normal(rng, (b, 1, s, d), torch.bfloat16, cuda_device)
    v = _normal(rng, (b, 1, s, d), torch.bfloat16, cuda_device)
    plan = FA.SplitPlan(b, hq, s, d, 128, 64, True, 0, 3)
    lib = FA._lib()
    o = torch.zeros_like(q)
    part = torch.empty(plan.workspace_floats, dtype=torch.float32,
                       device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    FA._build.check(lib.flash_attention_launch_schedule(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hq, 1, s,
        d, 128, 64, 1, 0, 1 / np.sqrt(d), 1, 3, part.data_ptr(), part.numel(),
        stream), lib, "split")
    torch.cuda.synchronize()
    want = FA.flash_attention_combine_plain(part, plan, o)
    before = FA.flash_attention_combine.launches
    got = FA.flash_attention_combine(part, plan, o.clone())
    torch.cuda.synchronize()
    assert FA.flash_attention_combine.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    card = FA.device_plan(cuda_device, b, hq, s, d, 128, 64, True, 0)
    code = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hq, 1, s,
        d, 128, 64, 1, 0, 1 / np.sqrt(d), 1, card.chunk_tiles + 1,
        part.data_ptr(), part.numel(), stream)
    assert code != 0


# whisper serves over ref attention (its cross-attention has s != sk)
FRONTEND_HOPPER = {"whisper-small": {}, "paligemma-3b": {"attn_core": "hopper"}}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(FRONTEND_HOPPER))
def test_prefill_replays_with_a_frontend_buffer_equal_the_eager_step_on_cuda(
        cuda_device, arch):
    """One prefill graph per (bucket, frontend shape): replays fed other
    frontends and lengths give the eager step's logits and cache leaves
    (``xkv`` included) bit for bit; the engine and an eager twin serve the
    same greedy streams with frontends."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.regions import Impl
    from repro_torch.models import factory as F
    from repro_torch.models.params import tree_leaves
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.graphs import EagerStep

    class EagerTwin(ServeEngine):
        def _make_step(self, fn, fixed, feeds, **_):
            return EagerStep(fn, fixed)

    cfg = get_config(arch).reduced()
    params = F.init_params(cfg, torch.Generator(device=cuda_device)
                           .manual_seed(0))
    impl = Impl({**F.default_impl(cfg), **FRONTEND_HOPPER[arch]})
    ctx = 16 + cfg.n_front + 8
    eng = ServeEngine(cfg, params, slots=2, ctx=ctx, impl=impl)
    prefill = F.make_bucketed_prefill_step(cfg, impl=impl, ctx=ctx)
    key = F.frontend_key(cfg)
    for seed, n in ((1, 13), (2, 16), (3, 9)):
        tokens, fe = F.synthetic_request(cfg, n, seed=seed)
        padded = _padded(n, 16, seed)
        logits, cache, finite = eng._gen.prefill(padded, n, fe[None])
        assert bool(finite)
        e_logits, e_cache = prefill(
            params, {"tokens": torch.from_numpy(padded).to(cuda_device),
                     key: torch.from_numpy(fe[None]).to(cuda_device)},
            torch.tensor(n, dtype=torch.int32, device=cuda_device))
        assert torch.equal(logits, e_logits), seed
        for a, b in zip(tree_leaves(cache), tree_leaves(e_cache)):
            assert torch.equal(a, b), seed
    assert eng.prefill_traces == 1
    requests = [F.synthetic_request(cfg, n, seed=10 + n) for n in (3, 12, 7)]
    streams = []
    for engine in (eng, EagerTwin(cfg, params, slots=2, ctx=ctx, impl=impl)):
        for tokens, fe in requests:
            engine.submit(tokens, max_new_tokens=6, frontend=fe)
        streams.append([r.generated for r in engine.run_to_completion()])
    assert streams[0] == streams[1]


@pytest.mark.cuda
def test_whisper_encoder_launches_flash_and_cross_attention_refuses_it_on_cuda(
        cuda_device):
    """The reduced encoder under attn_core=hopper launches the kernel once
    a layer and agrees with ref within 3x the offload-vs-ref floor (at
    least 0.05, chip_smoke.py's rule); a prefill under it raises at the
    cross-attention, with no plain version run in the kernel's place."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.regions import Impl
    from repro_torch.models import factory as F
    from repro_torch.models import lm
    cfg = get_config("whisper-small").reduced()
    params = F.init_params(cfg, torch.Generator(device=cuda_device)
                           .manual_seed(0))
    tokens, frames = F.synthetic_request(cfg, 5, seed=0)
    frames = torch.from_numpy(frames[None]).to(cuda_device)
    out = {}
    for variant in ("offload", "ref", "hopper"):
        before = FA.flash_attention.launches
        out[variant] = lm.encode(params, frames, cfg=cfg,
                                 impl=Impl({"attn_core": variant}))
        torch.cuda.synchronize()
    assert FA.flash_attention.launches - before == cfg.encoder_layers
    floor = float((out["offload"] - out["ref"]).abs().max())
    assert float((out["hopper"] - out["ref"]).abs().max()) <= max(
        3 * floor, 0.05)
    calls = []
    plain = FA.flash_attention_plain
    FA.flash_attention_plain = lambda *a, **kw: (calls.append(1),
                                                 plain(*a, **kw))[1]
    try:
        step = F.make_bucketed_prefill_step(
            cfg, impl=Impl({"attn_core": "hopper"}), ctx=16)
        with pytest.raises(ValueError, match="self-attention"):
            step(params, {"tokens": torch.from_numpy(_padded(5, 8, 0)).to(
                cuda_device), "frames": frames}, 5)
    finally:
        FA.flash_attention_plain = plain
    assert calls == []


# ---------------------------------------------------------------------------
# One-card training and int8 decode (phases 18-19 of chip_smoke.py)
# ---------------------------------------------------------------------------
def _train_pieces(arch, device):
    import functools

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.optim.schedule import constant
    from repro_torch.parallel.rules import ParallelismConfig
    from repro_torch.runtime import steps as TS
    cfg = get_config(arch).reduced()
    state = TS.init_train_state(cfg, torch.Generator(device=device)
                                .manual_seed(0))
    data = SyntheticLM(cfg, 2, 64, seed=0)
    steps = {m: TS.make_train_step(cfg, ParallelismConfig(remat=m),
                                   lr_fn=functools.partial(constant,
                                                           peak_lr=1e-2))
             for m in ("dots", "full")}
    return state, steps, lambda: to_device(next(data), device)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mixtral-8x7b",
                                  "whisper-small"])
def test_train_step_loss_falls_and_remat_modes_agree_on_cuda(cuda_device,
                                                             arch):
    from repro_torch.models.params import tree_leaves, tree_map
    state, steps, batch = _train_pieces(arch, cuda_device)
    losses = []
    for _ in range(6):
        state, m = steps["dots"](state, batch())
        losses.append(m["loss"].item())
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    b = batch()
    saved = tree_map(torch.clone, state)
    _, dots = steps["dots"](state, b)
    for dst, src in zip(tree_leaves(state), tree_leaves(saved)):
        dst.copy_(src)
    _, full = steps["full"](state, b)
    assert dots["loss"].item() == full["loss"].item()
    assert abs(dots["grad_norm"].item() - full["grad_norm"].item()) <= (
        1e-3 * dots["grad_norm"].item())


@pytest.mark.cuda
def test_bf16_logits_backward_is_the_float32_products_on_cuda(cuda_device):
    from repro_torch.models import layers as L
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(2, 8, 64, generator=g, device=cuda_device).to(
        torch.bfloat16).requires_grad_(True)
    w = (torch.randn(64, 300, generator=g, device=cuda_device) / 8).to(
        torch.bfloat16).requires_grad_(True)
    out = L.unembed(x, w, False)
    assert out.dtype == torch.float32
    seed = torch.randn(out.shape, generator=g, device=cuda_device)
    gx, gw = torch.autograd.grad((out * seed).sum(), (x, w))
    xf, wf = x.detach().float().requires_grad_(True), w.detach().float(
        ).requires_grad_(True)
    ref = xf.to(torch.bfloat16).float() @ wf
    rx, rw = torch.autograd.grad((ref * seed).sum(), (xf, wf))
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gx, rx.to(torch.bfloat16), rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(gw, rw.to(torch.bfloat16), rtol=1e-2, atol=1e-2)


@pytest.mark.cuda
def test_hopper_entry_points_refuse_gradients_on_cuda(cuda_device):
    q = torch.randn(1, 2, 64, 64, device=cuda_device, dtype=torch.bfloat16)
    before = FA.flash_attention.launches
    with pytest.raises(RuntimeError, match="no backward"):
        FA.flash_attention(q.clone().requires_grad_(True), q, q)
    x = torch.randn(4, 64, device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        RN.rmsnorm(x, torch.zeros(64, device=cuda_device))
    assert FA.flash_attention.launches == before
    with torch.no_grad():
        FA.flash_attention(q.clone().requires_grad_(True), q, q)
    assert FA.flash_attention.launches == before + 1


@pytest.mark.cuda
def test_quantized_decode_equals_the_dequantized_tree_on_cuda(cuda_device):
    """At-use dequantization against the whole dequantized tree, bf16 on
    the card: the same weights, so the same logits bit for bit; and the
    slice-by-slice draw equals quantizing the whole draw."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import factory as F
    from repro_torch.models import lm
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.optim import quantize as Q
    cfg = get_config("mixtral-8x7b").reduced()
    params = F.init_params(cfg, torch.Generator(device=cuda_device)
                           .manual_seed(5))
    qparams = Q.quantize_params(params)
    drawn = Q.init_quantized(lm.model_template(cfg), torch.Generator(
        device=cuda_device).manual_seed(5))
    for a, b in zip(tree_leaves(drawn), tree_leaves(qparams)):
        assert torch.equal(a, b)
    tokens = torch.randint(0, cfg.vocab_size, (4, 12), device=cuda_device)
    _, cache = F.make_prefill_step(cfg, ctx=16)(params, {"tokens": tokens})
    pos = torch.full((4,), 12, dtype=torch.int32, device=cuda_device)
    got, _ = F.make_quantized_serve_step(cfg)(
        qparams, tree_map(torch.clone, cache), tokens[:, -1:], pos)
    want, _ = F.make_serve_step(cfg)(Q.dequantize_params(qparams),
                                     cache, tokens[:, -1:], pos)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_checkpoint_of_a_cuda_state_restores_bit_for_bit(cuda_device,
                                                         tmp_path):
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models.params import tree_leaves
    state, steps, batch = _train_pieces("mistral-nemo-12b", cuda_device)
    state, _ = steps["dots"](state, batch())
    ck = CheckpointManager(str(tmp_path))
    ck.save_async(1, state)
    ck.wait()
    fresh, _, _ = _train_pieces("mistral-nemo-12b", cuda_device)
    restored, meta = ck.restore(fresh)
    assert meta["step"] == 1
    for a, b in zip(tree_leaves(restored), tree_leaves(state)):
        assert a.device == b.device and torch.equal(a, b)
