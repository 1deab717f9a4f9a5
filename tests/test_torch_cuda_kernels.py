"""Each CUDA kernel against its plain PyTorch version, on the card.

These tests need an NVIDIA GPU and skip elsewhere; they import no JAX, so
they run on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py

Tolerances: fp32 1e-5 absolute / relative for the normalized
aggregations (weighted means of O(1) values summed in another order; the
plain version's ``index_add_`` sums with atomics in a varying order) and
for attention (softmax-weighted means of O(1) values, exponentials and
sums taken in another order), the
unnormalized matmul against an fp64 product (see below), and 2e-6 for the
elementwise update (one fused multiply-add against two roundings); bf16
outputs within one bf16 ulp of the stored value (2**-7 relative), since
an fp32 sum that differs in its last bit can round either way.  The sLSTM
scan: atol 2e-5 / rtol 1e-5, and 5e-5 / 1e-4 with saturated gates (fp32
sums of P terms in another order, carried through the recurrence; the
tolerances of tests/test_slstm_kernel.py).
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import dual_proximal_sgd as tdps
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import masked_hier_agg as tmha
from repro_torch.kernels import ref
from repro_torch.kernels import slstm_scan as tss

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2 ** -7, atol=1e-5)
UPDATE = dict(rtol=2e-6, atol=2e-6)
SCAN = dict(rtol=1e-5, atol=2e-5)
SCAN_SATURATED = dict(rtol=1e-4, atol=5e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# (A, R, N): the main and paper fleets, odd shapes, then the edges of the
# agent split (at R = 4 and small N a block covers 128 columns in 16 agent
# groups): N below one block, one block and one column either side, A = 1
# (no split), A = 7 over 4 groups, and N large enough that no split is
# taken (K = 1), ragged
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("A,R,N", [(20, 4, 31_810), (100, 10, 31_810),
                                   (7, 9, 1001), (3, 1, 700), (2, 2, 5),
                                   (1000, 20, 513), (20, 4, 100),
                                   (20, 4, 127), (20, 4, 128), (20, 4, 129),
                                   (1, 1, 5000), (1, 3, 31_810),
                                   (7, 2, 40_000), (3, 2, 600_001)])
def test_cuda_aggregation_kernels_match_plain(cuda, dtype, A, R, N):
    g = torch.Generator(device=cuda).manual_seed(A + R)
    x = torch.randn(A, N, device=cuda, generator=g).to(dtype)
    prev = torch.randn(R, N, device=cuda, generator=g).to(dtype)
    w = torch.rand(A, device=cuda, generator=g) + 0.5
    mask = (torch.rand(A, device=cuda, generator=g) < 0.6).float()
    assign = torch.arange(A, device=cuda) % R
    mask[assign == 0] = 0.0
    tol = F32 if dtype == torch.float32 else BF16
    got, mass = tmha.agg_blend(x, w, mask, assign, R, prev)
    want, mass_r = ref.agg_blend_ref(x, w, mask, assign, R, prev)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.equal(got[0], prev[0])
    # unnormalized weights: held against the fp64 product, within 1e-6 of
    # the sum of |terms| (a few fp32 ulps of it, whatever the order) plus,
    # for bf16, one ulp of the stored value
    W = torch.randn(R, A, device=cuda, generator=g)
    got_mm = tmha.weighted_agg_matmul(W, x).double()
    exact = W.double() @ x.double()
    lim = 1e-6 * (W.double().abs() @ x.double().abs())
    if dtype == torch.bfloat16:
        lim += 2 ** -7 * exact.abs()
    assert bool(((got_mm - exact).abs() <= lim).all())
    cloud = torch.randn(N, device=cuda, generator=g)
    torch.testing.assert_close(tmha.cloud_blend(prev, mass_r + 1, cloud),
                               ref.cloud_blend_ref(prev, mass_r + 1, cloud),
                               **tol)
    arrivals = [(x, w * mask), (x.flip(0).contiguous(), w)]
    bm = torch.rand(R, device=cuda, generator=g)
    got3 = tmha.agg_absorb(arrivals, assign, R, prev, bm, keep=0.5)
    want3 = ref.agg_absorb_ref(arrivals, assign, R, prev, bm, keep=0.5)
    torch.testing.assert_close(got3[0].float(), want3[0].float(), **tol)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_weighted_agg_matmul_refuses_what_it_does_not_take(cuda):
    """The matmul's own launch path keeps every check of the shared one;
    a weight matrix in another dtype or layout is converted, as before."""
    x = torch.randn(6, 300, device=cuda)
    W = torch.randn(3, 6, device=cuda)
    for bad_w, bad_x in ((W, x.half()), (W, x.t().contiguous().t()),
                         (W[:, :5], x), (W.cpu(), x), (W[0], x),
                         (W[:, :0], x[:0])):
        with pytest.raises(ValueError):
            tmha.weighted_agg_matmul(bad_w, bad_x)
    want = W.double() @ x.double()
    for w in (W.double(), W.t().contiguous().t()):
        got = tmha.weighted_agg_matmul(w, x).double()
        assert bool(((got - want).abs()
                     <= 1e-6 * (W.double().abs() @ x.double().abs())).all())
    torch.cuda.synchronize()


# N % 4 == 2 (the engines' shapes), N % 4 == 0, and odd N (the scalar
# variant)
@pytest.mark.gpu
@pytest.mark.parametrize("N", [31_810, 31_812, 31_811])
@pytest.mark.parametrize("anchor_dtype", [torch.float32, torch.bfloat16])
def test_cuda_dual_proximal_sgd_matches_plain(cuda, anchor_dtype, N):
    g_ = torch.Generator(device=cuda).manual_seed(0)
    A = 20
    w, g, a1 = (torch.randn(A, N, device=cuda, generator=g_) for _ in range(3))
    a1 = a1.to(anchor_dtype)
    a2 = torch.randn(N, device=cuda, generator=g_).to(anchor_dtype)
    live = (torch.rand(A, device=cuda, generator=g_) < 0.5).float()
    kw = dict(lr=0.1, mu1=0.01, mu2=0.005)
    for scale, anchor2 in ((None, a2.expand(A, N).contiguous()), (live, a2)):
        got = tdps.dual_proximal_sgd(w, g, a1, anchor2, scale=scale, **kw)
        want = ref.dual_proximal_sgd_ref(w, g, a1, anchor2, scale=scale, **kw)
        torch.testing.assert_close(got, want, **UPDATE)
    torch.cuda.synchronize()


# A = 1, the largest A the wrapper takes (MAX_ROWS, at a small N), a row
# count that leaves a partial group of rows in flight, and a perception-
# wide row (one row group, the broadcast anchor read once)
@pytest.mark.gpu
@pytest.mark.parametrize("A,N", [(1, 1000), (1, 999), (tdps.MAX_ROWS, 6),
                                 (7, 40_002), (3, 1_000_002)])
def test_cuda_dual_proximal_sgd_rows_in_place_and_steps(cuda, A, N):
    """In place (``out=w``), the flat engine's ``active_steps``/``step``
    form bitwise equal to the float ``scale`` form it replaces, int32 and
    int64 steps, and a w whose rows are not 8-byte aligned (the scalar
    variant)."""
    g_ = torch.Generator(device=cuda).manual_seed(A)
    w, g, a1 = (torch.randn(A, N, device=cuda, generator=g_) for _ in range(3))
    a2 = torch.randn(N, device=cuda, generator=g_)
    active = torch.randint(0, 4, (A,), device=cuda, generator=g_,
                           dtype=torch.int32)
    kw = dict(lr=0.1, mu1=0.01, mu2=0.005)
    for step in (0, 2, 5):
        live = (step < active).float()
        want = ref.dual_proximal_sgd_ref(w, g, a1, a2, scale=live, **kw)
        by_scale = tdps.dual_proximal_sgd(w, g, a1, a2, scale=live, **kw)
        torch.testing.assert_close(by_scale, want, **UPDATE)
        for steps in (active, active.long()):
            got = tdps.dual_proximal_sgd(w, g, a1, a2, active_steps=steps,
                                         step=step, **kw)
            assert torch.equal(got, by_scale)
        torch.testing.assert_close(
            ref.dual_proximal_sgd_ref(w, g, a1, a2, active_steps=active,
                                      step=step, **kw), want, rtol=0, atol=0)
        w_in = w.clone()
        assert tdps.dual_proximal_sgd(w_in, g, a1, a2, active_steps=active,
                                      step=step, out=w_in, **kw) is w_in
        assert torch.equal(w_in, by_scale)
    flat = torch.empty(A * N + 1, device=cuda)[1:]       # 4 bytes off
    w_off = flat.view(A, N).copy_(w)
    got = tdps.dual_proximal_sgd(w_off, g, a1, a2, active_steps=active,
                                 step=0, **kw)
    torch.testing.assert_close(
        got, ref.dual_proximal_sgd_ref(w, g, a1, a2, active_steps=active,
                                       step=0, **kw), **UPDATE)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_dual_proximal_sgd_refuses_what_it_does_not_take(cuda):
    w = torch.randn(4, 10, device=cuda)
    a2 = torch.randn(10, device=cuda)
    steps = torch.ones(4, dtype=torch.int32, device=cuda)
    kw = dict(lr=0.1, mu1=0.1, mu2=0.1)
    for bad in (dict(scale=steps.float(), active_steps=steps),
                dict(active_steps=steps.float()),
                dict(active_steps=steps[:3]), dict(active_steps=steps.cpu()),
                dict(scale=steps)):
        with pytest.raises(ValueError):
            tdps.dual_proximal_sgd(w, w, w, a2, **kw, **bad)
    with pytest.raises(ValueError):
        tdps.dual_proximal_sgd(w, w, w.half(), a2, **kw)
    with pytest.raises(ValueError):
        tdps.dual_proximal_sgd(w, w, w, a2[:9], **kw)


def _agg_inputs(dev, A, R, N, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(A, N, device=dev, generator=g).to(dtype)
    prev = torch.randn(R, N, device=dev, generator=g).to(dtype)
    w = torch.rand(A, device=dev, generator=g) + 0.5
    mask = torch.rand(A, device=dev, generator=g) < 0.6
    assign = torch.arange(A, device=dev) % R
    if R > 1:
        mask[assign == 0] = False               # RSU 0 keeps its row
    return x, prev, w, mask, assign


# R = 1, the main path's 4, the paper's 10 (12 rows a pass), 16 (one full
# pass) and 17 (two passes); even and odd N
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("A,R,N", [(5, 1, 3001), (20, 4, 31_810),
                                   (100, 10, 31_810), (48, 16, 1000),
                                   (51, 17, 777), (40, 10, 100_001)])
def test_cuda_agg_blend_builds_weights_on_device(cuda, dtype, A, R, N):
    """One launch builds W, mass and the guard from (weights, mask,
    rsu_assign): the blend matches the plain version, a zero-mass RSU keeps
    its row bit for bit, mass agrees with ``cohort_mass`` within 1e-6
    relative, for a bool and a float mask and int64 and int32 RSU ids; an
    all-zero mask keeps every row."""
    from repro_torch.core.aggregation import cohort_mass
    x, prev, w, mask, assign = _agg_inputs(cuda, A, R, N, dtype, A + R + N)
    tol = F32 if dtype == torch.float32 else BF16
    want, _ = ref.agg_blend_ref(x, w, mask, assign, R, prev)
    want_mass = cohort_mass(w, mask, assign, R)
    for m, a in ((mask, assign), (mask.float(), assign.int())):
        before = tmha.launches["agg_blend"]
        got, mass = tmha.agg_blend(x, w, m, a, R, prev)
        assert tmha.launches["agg_blend"] == before + 1
        assert got.dtype == dtype and mass.shape == (R,)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        if R > 1:
            assert mass[0] == 0 and torch.equal(got[0], prev[0])
        torch.testing.assert_close(mass, want_mass, rtol=1e-6, atol=0)
    got, mass = tmha.agg_blend(x, w, torch.zeros_like(mask), assign, R, prev)
    assert torch.equal(got, prev) and not mass.any()
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,N", [(4, 31_810), (10, 9_999), (1, 5)])
def test_cuda_cloud_blend_builds_weights_on_device(cuda, dtype, R, N):
    """The R -> 1 layer into the fp32 master in one launch: against the
    plain version, and zero total mass keeps prev bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(R + N)
    rsu = torch.randn(R, N, device=cuda, generator=g).to(dtype)
    prev = torch.randn(N, device=cuda, generator=g)
    mass = torch.rand(R, device=cuda, generator=g)
    mass[0] = 0.0
    before = tmha.launches["cloud_blend"]
    got = tmha.cloud_blend(rsu, mass, prev)
    assert tmha.launches["cloud_blend"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (N,)
    torch.testing.assert_close(got, ref.cloud_blend_ref(rsu, mass, prev),
                               **(F32 if dtype == torch.float32 else BF16))
    assert torch.equal(tmha.cloud_blend(rsu, torch.zeros_like(mass), prev),
                       prev)
    torch.cuda.synchronize()


# (B, S, H, KV, D, causal, window): chip_smoke's cases (a small ragged one,
# the qwen3-0.6b layer, the same with a 1024 window), then odd shapes: one
# token, one row past a tile, a ragged thousand, a window wider than S,
# no GQA, non-causal with and without a window, and D = 32; then the edges
# of the D = 128 kernel's 128-row tiles: S = 1, 127, 128, 129 and 1000 over
# groups 1, 2 and 4, a window of 1, windows of S and more, non-causal
ATTN_CASES = [(2, 200, 4, 2, 64, True, 0), (1, 4096, 16, 8, 128, True, 0),
              (1, 4096, 16, 8, 128, True, 1024), (3, 1, 4, 2, 64, True, 0),
              (1, 65, 2, 1, 128, True, 0), (2, 1000, 4, 2, 64, True, 100),
              (1, 300, 4, 4, 32, True, 5000), (1, 257, 4, 1, 64, False, 0),
              (2, 130, 6, 3, 128, False, 33),
              (2, 1, 4, 1, 128, True, 0), (1, 127, 4, 2, 128, True, 0),
              (2, 128, 4, 4, 128, True, 1), (1, 128, 8, 2, 128, False, 0),
              (2, 129, 8, 2, 128, True, 0), (1, 129, 4, 4, 128, True, 129),
              (1, 1000, 8, 2, 128, True, 0), (2, 1000, 4, 1, 128, True, 1),
              (1, 1000, 4, 4, 128, True, 4096),
              (1, 1000, 8, 4, 128, False, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,D,causal,window", ATTN_CASES)
def test_cuda_flash_attention_matches_plain(cuda, dtype, B, S, H, KV, D,
                                            causal, window):
    g = torch.Generator(device=cuda).manual_seed(S + H + D)
    q, k, v = (torch.randn(B, S, n, D, device=cuda, generator=g).to(dtype)
               for n in (H, KV, KV))
    tol = F32 if dtype == torch.float32 else BF16
    before = tfa.launches["flash_attention"]
    got = tfa.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert tfa.launches["flash_attention"] == before + 1
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_flash_attention_prefill_shape_by_row(cuda):
    """The serving path's shape (qwen3-0.6b, B=4, S=8192) in bf16: one
    launch at full B, each batch row held against the plain version run on
    that row alone (its dense fp32 scores take about 4.3 GB a row)."""
    g = torch.Generator(device=cuda).manual_seed(11)
    B, S, H, KV, D = 4, 8192, 16, 8, 128
    q, k, v = (torch.randn(B, S, n, D, device=cuda, generator=g).to(
        torch.bfloat16) for n in (H, KV, KV))
    got = tfa.flash_attention(q, k, v, causal=True)
    for b in range(B):
        want = ref.flash_attention_ref(q[b:b + 1], k[b:b + 1], v[b:b + 1])
        torch.testing.assert_close(got[b:b + 1].float(), want.float(), **BF16)
        del want
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_flash_attention_reads_strided_views(cuda):
    """q/k/v as views into one fused (B, S, H + 2 KV, D) projection, as a
    caller that never copies would hand them over: at D = 64 (mma.sync) and
    D = 128 (the tensor maps of the TMA kernel)."""
    g = torch.Generator(device=cuda).manual_seed(7)
    B, S, H, KV = 2, 333, 8, 2
    for D in (64, 128):
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn(B, S, H + 2 * KV, D, device=cuda,
                              generator=g).to(dtype)
            q, k, v = qkv.split([H, KV, KV], dim=2)
            got = tfa.flash_attention(q, k, v, causal=True, window=64)
            want = ref.flash_attention_ref(q, k, v, causal=True, window=64)
            torch.testing.assert_close(
                got.float(), want.float(),
                **(F32 if dtype == torch.float32 else BF16))
    with pytest.raises(ValueError):
        tfa.flash_attention(q.float(), k, v)
    with pytest.raises(ValueError):
        tfa.flash_attention(q[..., :48].contiguous(), k[..., :48],
                            v[..., :48])
    # a bf16 view whose strides are whole 16-byte units but whose rows
    # start 8 bytes past a 16-byte boundary
    wide = torch.randn(B, S, H + 2 * KV, D + 8, device=cuda,
                       generator=g).to(torch.bfloat16)
    q, k, v = (t[..., 4:4 + D] for t in wide.split([H, KV, KV], dim=2))
    with pytest.raises(ValueError, match="16 bytes"):
        tfa.flash_attention(q, k, v)
    torch.cuda.synchronize()


def _scan_inputs(dev, B, S, H, P, r_dtype, seed=0, scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    d = H * P
    wx = torch.randn(B, S, 4 * d, device=dev, generator=g) * scale
    r = (torch.randn(H, P, 4 * P, device=dev, generator=g)
         * P ** -0.5).to(r_dtype)
    b = torch.randn(4 * d, device=dev, generator=g) * 0.1
    return wx, r, b


# (B, S, H, P, scale): the JAX kernel tests' shapes and saturated gates;
# then S = 1, 2, 3 (the first phases of each h buffer's mbarrier) at the
# layer's width and at P = 32, B = 5 rows at the layer's width, the latency
# floor's width (P = 8), and P = 24, which the shared-memory kernel runs
@pytest.mark.gpu
@pytest.mark.parametrize("r_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,scale", [(1, 17, 2, 32, 1.0),
                                           (2, 100, 4, 64, 1.0),
                                           (3, 256, 4, 32, 1.0),
                                           (1, 64, 8, 16, 1.0),
                                           (2, 48, 4, 32, 25.0),
                                           (1, 1, 4, 192, 1.0),
                                           (2, 2, 4, 192, 1.0),
                                           (1, 3, 4, 192, 1.0),
                                           (2, 1, 2, 32, 1.0),
                                           (1, 2, 2, 32, 1.0),
                                           (3, 3, 2, 32, 1.0),
                                           (5, 300, 4, 192, 1.0),
                                           (2, 40, 1, 8, 1.0),
                                           (2, 30, 2, 24, 1.0)])
def test_cuda_slstm_scan_matches_plain(cuda, r_dtype, B, S, H, P, scale):
    wx, r, b = _scan_inputs(cuda, B, S, H, P, r_dtype, seed=S, scale=scale)
    before = tss.launches["slstm_scan"]
    got = tss.slstm_scan(wx, r, b)
    want = ref.slstm_scan_ref(wx, r, b)
    assert got.shape == (B, S, H * P) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **(SCAN if scale == 1.0
                                              else SCAN_SATURATED))
    assert tss.launches["slstm_scan"] == before + 1
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("r_dtype", [torch.bfloat16, torch.float32])
def test_cuda_slstm_scan_layer_shape(cuda, r_dtype):
    """The xlstm-125m layer (B=4, S=8192, H=4, P=192): one cluster of 16
    CTAs a row, each keeping its columns of R (bf16 or fp32) in registers
    as fp32."""
    wx, r, b = _scan_inputs(cuda, 4, 8192, 4, 192, r_dtype, seed=3)
    assert tss.plan(768, 192, r_dtype) == {"cluster": 16,
                                           "r_lives_in": "registers"}
    got = tss.slstm_scan(wx, r, b)
    torch.testing.assert_close(got, ref.slstm_scan_ref(wx, r, b), **SCAN)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("d,P,r_dtype,want", [
    (64, 32, torch.float32, (1, "registers")),
    (256, 64, torch.bfloat16, (2, "registers")),
    (8, 8, torch.float32, (1, "registers")),
    (48, 24, torch.bfloat16, (1, "shared memory")),
    (1536, 192, torch.bfloat16, (8, "device memory"))])
def test_cuda_slstm_scan_plans(cuda, d, P, r_dtype, want):
    """Registers where the register kernel has the head size and whole
    warps fit its thread limit; else the shared-memory kernel, with R in
    device memory where 8 CTAs cannot hold it."""
    got = tss.plan(d, P, r_dtype)
    assert (got["cluster"], got["r_lives_in"]) == want


@pytest.mark.gpu
def test_cuda_slstm_scan_refuses_what_it_does_not_take(cuda):
    wx, r, b = _scan_inputs(cuda, 2, 10, 2, 32, torch.float32)
    with pytest.raises(ValueError):
        tss.slstm_scan(wx.to(torch.bfloat16), r, b)
    with pytest.raises(ValueError):
        tss.slstm_scan(wx.transpose(0, 1).contiguous().transpose(0, 1), r, b)
    with pytest.raises(ValueError):
        tss.slstm_scan(wx, r.cpu(), b)
    with pytest.raises(ValueError):
        tss.slstm_scan(wx[..., :-4], r, b)
    w12, r12, b12 = _scan_inputs(cuda, 1, 4, 2, 12, torch.float32)
    with pytest.raises(ValueError):
        tss.slstm_scan(w12, r12, b12)
    assert tss.slstm_scan(wx[:, :0], r, b).shape == (2, 0, 64)


@pytest.mark.gpu
def test_cuda_xlstm_prefill_runs_the_scan(cuda):
    """A reduced xlstm's forward on the card launches the kernel once for
    each of its three sLSTM layers and agrees with the host's."""
    from repro_torch import tree
    from repro_torch.configs.registry import get_reduced_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    cfg = get_reduced_config("xlstm-125m").replace(dtype="float32",
                                                   param_dtype="float32")
    host = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = tree.map_tree(lambda t: t.to(cuda), host)
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    ops.reset_launch_counts()
    with torch.no_grad():
        got, _ = M.forward(cfg, card, {"tokens": toks.to(cuda)})
        want, _ = M.forward(cfg, host, {"tokens": toks})
    assert ops.launch_counts()["slstm_scan"] == 3
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
