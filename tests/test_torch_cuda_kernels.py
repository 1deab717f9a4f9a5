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


def exact_mass(weights, assign, R):
    """The exact per-RSU sums of ``weights`` in fp64 ((A,) or (S, A) with
    ids (A,) or (S, A)): the yardstick for a kernel's fp32 masses, since
    the plain versions' ``index_add_`` adds in an order that varies from
    run to run."""
    onehot = assign[..., None, :] == torch.arange(R, device=assign.device)[
        :, None]
    return (onehot.double() * weights.double()[..., None, :]).sum(dim=-1)


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


# the sharded rounds' shapes: the paper fleet's pod of 50 agents over 5
# local RSUs (rsu_sharded, pods 2), its data shard of 25, the replicated
# round's 50 agents over all 10 RSUs, the main fleet's pod, and the
# N-sharded perception cell's 8 agents over 128 RSUs at a ragged N
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("A,R,N", [(50, 5, 31_810), (25, 5, 31_810),
                                   (50, 10, 31_810), (10, 2, 31_810),
                                   (8, 128, 100_001)])
def test_cuda_block_local_agg_matches_plain(cuda, dtype, A, R, N):
    """``ops.block_local_agg`` with shard-local RSU ids: one launch of the
    matmul kernel counted under its own entry, num in fp32 against the fp64
    sum (within 1e-6 of the sum of |terms|) as the plain version is, mass
    against the exact (fp64) sum within 1e-6 relative.  A weightless block
    (every agent of RSU 0 at weight 0, as an empty or disconnected cohort)
    gives num 0 and mass 0 there; an all-zero tick gives zeros."""
    from repro_torch.core.aggregation import scatter_accumulate
    from repro_torch.kernels import ops
    g = torch.Generator(device=cuda).manual_seed(A + R)
    x = torch.randn(A, N, device=cuda, generator=g).to(dtype)
    w = torch.rand(A, device=cuda, generator=g) + 0.5
    assign = torch.randint(0, R, (A,), device=cuda, generator=g)
    w[assign == 0] = 0.0
    w[::7] = 0.0
    for weights in (w, torch.zeros_like(w)):
        before = tmha.launches["block_local_agg"]
        num, mass = ops.block_local_agg(x, weights, assign, R)
        assert tmha.launches["block_local_agg"] == before + 1
        assert num.dtype == torch.float32 and num.shape == (R, N)
        onehot = (assign[None, :] == torch.arange(R, device=cuda)[:, None])
        W = (onehot * weights[None, :]).double()
        exact = W @ x.double()
        lim = 1e-6 * (W.abs() @ x.double().abs())
        want_num, _ = scatter_accumulate(x, weights, assign, R)
        for got in (num, want_num):
            assert bool(((got.double() - exact).abs() <= lim).all())
        torch.testing.assert_close(mass.double(),
                                   exact_mass(weights, assign, R),
                                   rtol=1e-6, atol=0)
        assert not num[0].any() and mass[0] == 0
    assert not num.any() and not mass.any()
    torch.cuda.synchronize()


# the async tick's shapes (main and paper fleets), one RSU, R past 16 and
# an odd N
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("A,R,N", [(20, 4, 31_810), (100, 10, 31_810),
                                   (7, 1, 1001), (40, 17, 777)])
def test_cuda_scatter_accumulate_matches_plain(cuda, dtype, A, R, N):
    """The async tick's unnormalized sums on the matmul kernel: num in fp32
    whatever the fleet dtype, held against the fp64 sum (within 1e-6 of
    the sum of |terms|, a few fp32 ulps whatever the order) as the plain
    version is; mass equal to the exact (fp64) sum within 1e-6 relative;
    one launch a call, counted under its own entry."""
    from repro_torch.core.aggregation import scatter_accumulate
    from repro_torch.kernels import ops
    x, _, w, mask, assign = _agg_inputs(cuda, A, R, N, dtype, A + R)
    w = w * mask                         # zero-weight rows
    before = tmha.launches["scatter_accumulate"]
    num, mass = ops.masked_scatter_accumulate(x, w, assign, R)
    assert tmha.launches["scatter_accumulate"] == before + 1
    assert num.dtype == torch.float32 and num.shape == (R, N)
    onehot = (assign[None, :] == torch.arange(R, device=cuda)[:, None])
    W = (onehot * w[None, :]).double()
    exact = W @ x.double()
    lim = 1e-6 * (W.abs() @ x.double().abs()) + 1e-30
    want_num, want_mass = scatter_accumulate(x, w, assign, R)
    for got in (num, want_num):
        assert bool(((got.double() - exact).abs() <= lim).all())
    torch.testing.assert_close(mass.double(), exact_mass(w, assign, R),
                               rtol=1e-6, atol=0)
    if R > 1:                            # RSU 0's cohort carries no weight
        assert not num[0].any() and mass[0] == 0
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("A,R,N", [(20, 4, 31_810), (100, 10, 31_810),
                                   (2334, 10, 1000)])
def test_cuda_agg_absorb_two_cohorts_vector_keep(cuda, dtype, A, R, N):
    """The async tick's RSU layer: two cohorts (fresh rows and due
    stragglers) and an (R,) keep on the card, in one launch.  Rows that
    screen_updates scrubbed back to their start (NaN payloads) carry
    weight 0.  An RSU with no mass and no retained buffer keeps its row
    bit for bit.  A = 2334 is the largest the ring takes at R = 10 (12 rows
    of weights for 2A agents and the copy ring in shared memory); one agent
    more takes the agent-tiled route (#2's sums, one launch a cohort)."""
    from repro_torch.core.aggregation import screen_updates
    x, prev, w, mask, assign = _agg_inputs(cuda, A, R, N, dtype, A * R)
    g = torch.Generator(device=cuda).manual_seed(N)
    start = x.flip(0).contiguous()
    bad = torch.arange(A, device=cuda) % 5 == 1
    poisoned = torch.where(bad[:, None], torch.full_like(x, float("nan")), x)
    w_imm = w * mask
    clean, okf, nq = screen_updates(poisoned, start, w_imm)
    assert int(nq) == int(((w_imm > 0) & bad).sum()) and torch.isfinite(
        clean.float()).all()
    w_imm = w_imm * okf
    pend = torch.randn(A, N, device=cuda, generator=g).to(dtype)
    w_due = torch.where(torch.arange(A, device=cuda) % 3 == 0, w * 0.25,
                        torch.zeros_like(w))
    w_due[assign == 0] = 0.0
    keep = torch.linspace(0.1, 0.9, R, device=cuda)
    bm = torch.rand(R, device=cuda, generator=g)
    bm[0] = 0.0                          # RSU 0: nothing to keep or absorb
    arrivals = ((clean, w_imm), (pend, w_due))
    before = tmha.launches["agg_absorb"]
    got, total, new = tmha.agg_absorb(arrivals, assign, R, prev, bm,
                                      keep=keep)
    assert tmha.launches["agg_absorb"] == before + 1
    want, _, _ = ref.agg_absorb_ref(arrivals, assign, R,
                                                    prev, bm, keep=keep)
    tol = F32 if dtype == torch.float32 else BF16
    torch.testing.assert_close(got.float(), want.float(), **tol)
    exact = exact_mass(w_imm, assign, R) + exact_mass(w_due, assign, R)
    torch.testing.assert_close(new.double(), exact, rtol=1e-6, atol=0)
    torch.testing.assert_close(total.double(),
                               keep.double() * bm.double() + exact,
                               rtol=1e-6, atol=0)
    assert torch.equal(got[0], prev[0]) and torch.isfinite(got.float()).all()
    if A == 2334:                        # one agent more: the tiled route
        one = torch.zeros(A + 1, device=cuda)
        more = [(torch.cat([c, c[:1]]), torch.cat([w_, one[:1]]))
                for c, w_ in arrivals]
        before = dict(tmha.launches)
        got2, _, new2 = tmha.agg_absorb(more, torch.cat([assign, assign[:1]]),
                                        R, prev, bm, keep=keep)
        assert tmha.launches["agg_absorb"] == before["agg_absorb"]
        assert (tmha.launches["agg_absorb_tiled"]
                == before["agg_absorb_tiled"] + 2)
        torch.testing.assert_close(got2.float(), want.float(), **tol)
        torch.testing.assert_close(new2.double(), exact, rtol=1e-6, atol=0)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("A,R,N", [(20, 4, 31_810), (100, 10, 31_810),
                                   (4668, 10, 1000)])
def test_cuda_agg_absorb_one_cohort(cuda, dtype, A, R, N):
    """The serve tick's RSU layer: one cohort (the tick's arrivals,
    weighted by data volume, mask and staleness) and a scalar keep, one
    launch.  Then a tick whose every arrival was rejected: all-zero
    weights, where an RSU that retains no mass keeps its row bit for bit
    through the mass guard and one that does is renormalized by its
    retained mass.  A = 4668 is the most one cohort takes on the ring at R
    = 10 (12 rows of weights and the copy ring in shared memory); one more
    takes the agent-tiled route.  The masses are
    held to the exact (fp64) sums: the plain version's ``index_add_``
    adds in an order that varies from run to run."""
    x, prev, w, mask, assign = _agg_inputs(cuda, A, R, N, dtype, A + N)
    g = torch.Generator(device=cuda).manual_seed(N)
    age = torch.randint(0, 3, (A,), device=cuda, generator=g)
    w_arr = w * mask.float() * 0.5 ** age.float()
    bm = torch.rand(R, device=cuda, generator=g)
    bm[0] = 0.0                          # RSU 0: nothing to keep or absorb
    tol = F32 if dtype == torch.float32 else BF16
    for weights in (w_arr, torch.zeros_like(w_arr)):
        before = tmha.launches["agg_absorb"]
        got, total, new = tmha.agg_absorb(((x, weights),), assign, R, prev,
                                          bm, keep=0.4)
        assert tmha.launches["agg_absorb"] == before + 1
        want, _, _ = ref.agg_absorb_ref(((x, weights),), assign, R, prev,
                                        bm, keep=0.4)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        exact = torch.zeros(R, dtype=torch.float64, device=cuda).index_add_(
            0, assign, weights.double())
        torch.testing.assert_close(new.double(), exact, rtol=1e-6, atol=0)
        torch.testing.assert_close(total.double(),
                                   0.4 * bm.double() + exact, rtol=1e-6,
                                   atol=0)
        assert torch.equal(got[0], prev[0])
        assert torch.isfinite(got.float()).all()
    assert not new.any()                 # the empty tick absorbed nothing
    torch.testing.assert_close(got.float(), prev.float(), **tol)
    if A == 4668:                        # one agent more: the tiled route
        more = ((torch.cat([x, x[:1]]),
                 torch.cat([w_arr, torch.zeros_like(w_arr[:1])])),)
        before = dict(tmha.launches)
        got, _, new = tmha.agg_absorb(more, torch.cat([assign, assign[:1]]),
                                      R, prev, bm, keep=0.4)
        assert tmha.launches["agg_absorb"] == before["agg_absorb"]
        assert (tmha.launches["agg_absorb_tiled"]
                == before["agg_absorb_tiled"] + 1)
        want, _, _ = ref.agg_absorb_ref(((x, w_arr),), assign, R, prev, bm,
                                        keep=0.4)
        torch.testing.assert_close(got.float(), want.float(), **tol)
    torch.cuda.synchronize()


# (B, S, H, KV, D, causal, window): chip_smoke's cases (a small ragged one,
# the qwen3-0.6b layer, the same with a 1024 window), then odd shapes: one
# token, one row past a tile, a ragged thousand, a window wider than S,
# no GQA, non-causal with and without a window, and D = 32; then the edges
# of the D = 128 kernel's 128-row tiles: S = 1, 127, 128, 129 and 1000 over
# groups 1, 2 and 4, a window of 1, windows of S and more, non-causal;
# then 36 (b, h) pairs, so that the TMA kernel's block order ends in a
# group of 4 pairs after two of 16; then D = 64 on the TMA + wgmma kernel
# at (64, 64) (its 128-row tiles and 2-stage K/V ring): S one row past a
# tile, a window of 1 and of 1024 over 4096 rows (past the ring's depth),
# GQA 8/2 and 4, 36 pairs, and one non-causal query (the split-key kernel
# over T = S = 1)
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
              (1, 1000, 8, 4, 128, False, 0),
              (3, 300, 12, 4, 128, True, 0),
              (1, 129, 4, 4, 64, True, 0), (2, 128, 4, 4, 64, True, 1),
              (1, 4096, 8, 8, 64, True, 1024), (1, 1000, 8, 2, 64, True, 0),
              (2, 513, 8, 2, 64, False, 0), (3, 300, 12, 4, 64, True, 0),
              (2, 1, 4, 4, 64, False, 0)]


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


# (B, S, H, KV, causal, window) at MLA's head dims (q/k 192, v 128):
# deepseek-v2-lite's layer (H = KV = 16) causal and with a 1024 window,
# one row past a tile, a ragged thousand non-causal, GQA 2 with a window,
# one token; then S ragged across the 128-row query and key tiles: one row
# short of the prefill's 8192, and 257 (two tiles and a row) non-causal;
# then 24 (b, h) pairs, a group of 16 and one of 8 in the block order
MLA_CASES = [(1, 4096, 16, 16, True, 0), (1, 4096, 16, 16, True, 1024),
             (2, 129, 16, 16, True, 0), (1, 1000, 16, 16, False, 0),
             (2, 300, 8, 4, True, 33), (3, 1, 4, 4, True, 0),
             (1, 8191, 16, 16, True, 0), (2, 257, 8, 8, False, 0),
             (2, 300, 12, 12, True, 0)]


def _mla_inputs(dev, B, S, H, KV, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k = (torch.randn(B, S, n, 192, device=dev, generator=g).to(dtype)
            for n in (H, KV))
    v = torch.randn(B, S, KV, 128, device=dev, generator=g).to(dtype)
    return q, k, v


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,causal,window", MLA_CASES)
def test_cuda_flash_attention_mla_dims_match_plain(cuda, dtype, B, S, H, KV,
                                                   causal, window):
    """Kernel #4 at Dqk = 192, Dv = 128 (in bf16 the TMA + wgmma kernel,
    Q and K rows in three 128-byte boxes; in fp32 the FMA kernel) against
    the plain version, scale 192**-0.5; the output is v's width."""
    q, k, v = _mla_inputs(cuda, B, S, H, KV, dtype, S + H)
    before = dict(tfa.launches)
    got = tfa.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == (B, S, H, 128)
    torch.testing.assert_close(got.float(), want.float(),
                               **(F32 if dtype == torch.float32 else BF16))
    assert (tfa.launches["flash_attention_mla"]
            == before["flash_attention_mla"] + 1)
    assert tfa.launches["flash_attention"] == before["flash_attention"]
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_flash_attention_mla_dims_read_strided_views(cuda):
    """At MLA's head dims, q as a slice of wider rows (64 bytes in) and k
    and v as the two parts of one fused (B, S, KV, 192 + 128) projection,
    read in place: the tensor maps take q's and k's 192 columns at their
    own strides (v starts 384 bytes into each row)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    B, S, H, KV = 2, 333, 8, 4
    for dtype in (torch.bfloat16, torch.float32):
        wide = torch.randn(B, S, H, 256, device=cuda, generator=g).to(dtype)
        kv = torch.randn(B, S, KV, 192 + 128, device=cuda,
                         generator=g).to(dtype)
        q = wide[..., 32:224]
        k, v = kv.split([192, 128], dim=-1)
        assert not (q.is_contiguous() or k.is_contiguous()
                    or v.is_contiguous())
        for causal, window in ((True, 0), (True, 64), (False, 0)):
            got = tfa.flash_attention(q, k, v, causal=causal, window=window)
            want = ref.flash_attention_ref(q, k, v, causal=causal,
                                           window=window)
            torch.testing.assert_close(
                got.float(), want.float(),
                **(F32 if dtype == torch.float32 else BF16))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,causal,window", [
    (2, 130, 16, 16, True, 0), (1, 1000, 8, 4, True, 100),
    (2, 257, 4, 4, False, 0)])
def test_cuda_flash_attention_mla_dims_lse_matches_plain(cuda, B, S, H, KV,
                                                         causal, window):
    """The log-sum-exp saved at MLA's head dims (scale 192**-0.5) against
    ``ref.attention_lse_ref``, as at D = 128 (1e-5 relative, a floor of
    1e-5 of the largest value), and the output unchanged by saving it."""
    q, k, v = _mla_inputs(cuda, B, S, H, KV, torch.bfloat16, S + 2 * H)
    kw = dict(causal=causal, window=window)
    before = tfa.launches["flash_attention_mla"]
    out, lse = tfa.flash_attention(q, k, v, return_lse=True, **kw)
    assert tfa.launches["flash_attention_mla"] == before + 1
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    want = ref.attention_lse_ref(q, k, **kw)
    torch.testing.assert_close(lse, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())
    assert torch.equal(out, tfa.flash_attention(q, k, v, **kw))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_flash_attention_mla_dims_refuse_grad_and_other_pairs(cuda):
    """Under grad at Dqk = 192 the route raises (no backward kernel takes
    MLA's head dims); (D, Dv) pairs without a kernel are refused."""
    from repro_torch.kernels import ops
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k = (torch.randn(1, 64, 4, 192, device=cuda, generator=g).to(
        torch.bfloat16) for _ in range(2))
    v = torch.randn(1, 64, 4, 128, device=cuda, generator=g).to(
        torch.bfloat16)
    with pytest.raises(NotImplementedError, match="the model zoo"):
        ops.flash_attention(q.requires_grad_(), k, v)
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).shape == (1, 64, 4, 128)
    with pytest.raises(ValueError, match="head dims"):
        tfa.flash_attention(q[..., :128].contiguous(), k[..., :128], v[..., :64])
    with pytest.raises(ValueError, match="head dims"):
        tfa.flash_attention(q.detach(), k, v[..., :96])
    torch.cuda.synchronize()


# (B, S, H, KV, causal, window) at the head dims 80 (zamba2-2.7b, d_model
# 2560 over 32 heads), 96 (phi-3-vision-4.2b, 3072 over 32) and 192
# (nemotron-4-340b, 18432 over 96 heads, q, k and v alike): the layer
# (H = KV = 32) causal and with a 1024 window, 65 rows, a ragged thousand
# non-causal, GQA 4 with a window, one token, GQA 2 non-causal with a
# window, 129 rows of 8 heads over 2; then the kernel's 128-row tile edges
# (one row short of a tile, one tile, one row short of 64 tiles), 2 x 32
# heads at S = 2048 (two batch rows of 32 heads, 16 query tiles each) with
# a 1024 window, so that the block order's decode of (b, h, tile) is
# checked where the blocks of several groups of 16 (b, h) pairs are in
# flight, and 36 pairs of GQA 3 (groups of 16, 16 and 4); last nemotron's
# layer (GQA 12: 96 heads over 8) causal, and GQA 12 with a window and
# ragged S (at 192 the bf16 kernel's K/V tiles hold 64 keys, so S = 1000
# ends mid-tile and the 256 window starts mid-tile)
WIDE_HEAD_DIMS = (80, 96, 192)
WIDE_CASES = [(1, 4096, 32, 32, True, 0), (1, 4096, 32, 32, True, 1024),
              (2, 65, 32, 32, True, 0), (1, 1000, 32, 32, False, 0),
              (2, 300, 8, 2, True, 33), (3, 1, 4, 4, True, 0),
              (1, 257, 4, 2, False, 17), (1, 129, 8, 2, True, 0),
              (1, 127, 4, 4, True, 0), (1, 128, 4, 4, True, 0),
              (1, 8191, 4, 4, True, 0), (2, 2048, 32, 32, True, 1024),
              (3, 700, 12, 4, True, 0), (1, 4096, 96, 8, True, 0),
              (2, 1000, 24, 2, True, 256)]
# the model whose training a grad at each dim names: at 192 no backward
# kernel takes the dim (80 and 96 have one)
WIDE_TRAINING = {192: "nemotron-4-340b training"}


def _wide_inputs(dev, B, S, H, KV, D, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(B, S, n, D, device=dev, generator=g).to(dtype)
                 for n in (H, KV, KV))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,causal,window", WIDE_CASES)
@pytest.mark.parametrize("D", WIDE_HEAD_DIMS)
def test_cuda_flash_attention_wide_head_matches_plain(cuda, D, dtype, B, S,
                                                      H, KV, causal, window):
    """Kernel #4 at D = 80, 96 and 192 (bf16: the TMA + wgmma kernel, q/k
    rows of two 128-byte boxes of which the second is zero past column 16
    or 32, PV as wgmma m64n80k16 or m64n96k16, or at 192 rows of three
    boxes, 64-key K/V tiles and PV as m64n192k16; fp32: the FMA kernel,
    whose third column group is ragged at 80) against the plain version,
    every output column; counted as ``flash_attention_d80`` / ``_d96`` /
    ``_d192``."""
    q, k, v = _wide_inputs(cuda, B, S, H, KV, D, dtype, S + H)
    key = f"flash_attention_d{D}"
    before = dict(tfa.launches)
    got = tfa.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == (B, S, H, D)
    torch.testing.assert_close(got.float(), want.float(),
                               **(F32 if dtype == torch.float32 else BF16))
    assert tfa.launches[key] == before[key] + 1
    assert all(tfa.launches[k] == before[k] for k in before if k != key)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("D", WIDE_HEAD_DIMS)
def test_cuda_flash_attention_wide_head_reads_strided_views(cuda, D):
    """At D = 80, 96 and 192, q/k/v as views into one fused (B, S, H + 2
    KV, D) projection, and q as a slice 16 values into wider rows, read in
    place (bf16: through the TMA kernel's tensor maps, D columns wide, so
    the columns past a view's D read as zeros and not as its
    neighbours)."""
    g = torch.Generator(device=cuda).manual_seed(D)
    B, S, H, KV = 2, 333, 8, 2
    for dtype in (torch.float32, torch.bfloat16):
        qkv = torch.randn(B, S, H + 2 * KV, D, device=cuda,
                          generator=g).to(dtype)
        q, k, v = qkv.split([H, KV, KV], dim=2)
        wide = torch.randn(B, S, H, D + 32, device=cuda,
                           generator=g).to(dtype)
        for qq in (q, wide[..., 16:16 + D]):
            assert not qq.is_contiguous()
            got = tfa.flash_attention(qq, k, v, causal=True, window=64)
            want = ref.flash_attention_ref(qq, k, v, causal=True, window=64)
            torch.testing.assert_close(
                got.float(), want.float(),
                **(F32 if dtype == torch.float32 else BF16))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,causal,window", [
    (2, 130, 32, 32, True, 0), (1, 1000, 8, 2, True, 100),
    (2, 257, 4, 4, False, 0), (1, 8191, 4, 4, True, 0),
    (2, 257, 8, 2, True, 100)])
@pytest.mark.parametrize("D", WIDE_HEAD_DIMS)
def test_cuda_flash_attention_wide_head_lse_matches_plain(cuda, D, B, S, H,
                                                          KV, causal,
                                                          window):
    """The log-sum-exp the D = 80 / 96 / 192 epilogue saves (scale D**-0.5)
    against ``ref.attention_lse_ref``, as at D = 128, and the output
    unchanged by saving it."""
    q, k, v = _wide_inputs(cuda, B, S, H, KV, D, torch.bfloat16, S + 2 * H)
    kw = dict(causal=causal, window=window)
    out, lse = tfa.flash_attention(q, k, v, return_lse=True, **kw)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    want = ref.attention_lse_ref(q, k, **kw)
    torch.testing.assert_close(lse, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())
    assert torch.equal(out, tfa.flash_attention(q, k, v, **kw))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("D", sorted(WIDE_TRAINING))
def test_cuda_flash_attention_wide_head_refuses_grad(cuda, D):
    """Under grad at D = 192 the route raises, naming nemotron-4-340b
    training (no backward kernel takes the dim), in bf16 and fp32; without
    grad it runs."""
    from repro_torch.kernels import ops
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _wide_inputs(cuda, 1, 64, 4, 2, D, dtype, 3)
        with pytest.raises(NotImplementedError, match=WIDE_TRAINING[D]):
            ops.flash_attention(q.requires_grad_(), k, v)
        with torch.no_grad():
            assert ops.flash_attention(q, k, v).shape == (1, 64, 4, D)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("D", [80, 96])
def test_cuda_flash_attention_wide_head_grad_runs_backward_kernel(cuda, D):
    """Under grad at D = 80 / 96 (zamba2-2.7b's and phi-3-vision's head
    dims) a bf16 call runs the forward kernel with the log-sum-exp and,
    in the backward pass, the backward kernel once (one
    ``flash_attention_bwd`` launch, one ``flash_attention_d80`` / ``_d96``
    forward launch, nothing else); an fp32 call still raises, since the
    backward kernel takes bf16 only."""
    from repro_torch.kernels import ops
    q, k, v = _wide_inputs(cuda, 1, 64, 4, 2, D, torch.bfloat16, 3)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    before = dict(tfa.launches)
    out = ops.flash_attention(*leaves, causal=True)
    out.float().square().sum().backward()
    after = dict(tfa.launches)
    want = dict(before, flash_attention_bwd=before["flash_attention_bwd"] + 1)
    want[f"flash_attention_d{D}"] += 1
    assert after == want
    for t in leaves:
        assert t.grad is not None and t.grad.shape == t.shape
        assert torch.isfinite(t.grad.float()).all()
    q, k, v = _wide_inputs(cuda, 1, 64, 4, 2, D, torch.float32, 3)
    with pytest.raises(NotImplementedError, match="bf16 self-attention"):
        ops.flash_attention(q.requires_grad_(), k, v)
    torch.cuda.synchronize()


# (B, S, T, H, KV, D): S queries over T keys of their own length,
# non-causal (cross-attention).  D = 64: whisper-tiny's prefill (32 x 448
# decoder tokens over 1500 frames, 6 heads) and 100 over a ragged 257 on
# the TMA + wgmma kernel at (64, 64) in bf16, as are five queries over
# 1500 frames (past the split-key kernel's cut-off of four); one query
# (the split-key kernel in bf16) over T = 1500 at B x H = 48 pairs
# (whisper's decode step) and 240 (past the card's 132 SMs), and over T =
# 1, 127, 128 and 257 (ragged ranges, GQA); two and three queries (its
# 2- and 4-query instances, the latter one query short); then the TMA +
# wgmma kernel at 128, 80 and 96 with T past a 128-key tile edge on either
# side of S, and one query over keys, and at 192 (64-key tiles) with T
# past a 64-key tile edge, GQA 12.  fp32 runs each on the FMA kernel.
CROSS_CASES = [(32, 448, 1500, 6, 6, 64), (8, 1, 1500, 6, 6, 64),
               (2, 100, 257, 4, 2, 64), (8, 5, 1500, 6, 6, 64),
               (8, 2, 1500, 6, 6, 64), (2, 3, 257, 4, 2, 64),
               (40, 1, 1500, 6, 6, 64), (2, 1, 1, 4, 2, 64),
               (2, 1, 127, 4, 4, 64), (1, 1, 128, 6, 6, 64),
               (2, 1, 257, 4, 2, 64), (2, 300, 1000, 8, 4, 128),
               (1, 129, 77, 4, 4, 128), (2, 1, 300, 8, 8, 80),
               (1, 200, 513, 4, 2, 80), (1, 70, 130, 4, 4, 96),
               (2, 1, 129, 4, 4, 96), (1, 300, 1000, 24, 2, 192),
               (2, 70, 65, 12, 1, 192)]


def _cross_inputs(dev, B, S, T, H, KV, D, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, S, H, D, device=dev, generator=g).to(dtype)
    k, v = (torch.randn(B, T, KV, D, device=dev, generator=g).to(dtype)
            for _ in range(2))
    return q, k, v


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,KV,D", CROSS_CASES)
def test_cuda_flash_attention_cross_matches_plain(cuda, dtype, B, S, T, H,
                                                  KV, D):
    """Kernel #4 with keys of their own length T != S, non-causal (the
    key tiles, their tail mask and the K/V loads and tensor maps on T; the
    query tiles and the output on S) against the plain version; counted as
    ``flash_attention_cross``: by the wrapper's own rule where T != S, and
    through the caller's ``cross=True`` (as ``xattn_apply`` passes it)
    where one query meets one key."""
    q, k, v = _cross_inputs(cuda, B, S, T, H, KV, D, dtype, S + T + D)
    before = dict(tfa.launches)
    got = tfa.flash_attention(q, k, v, causal=False, cross=S == T)
    want = ref.flash_attention_ref(q, k, v, causal=False)
    assert got.dtype == dtype and got.shape == (B, S, H, D)
    torch.testing.assert_close(got.float(), want.float(),
                               **(F32 if dtype == torch.float32 else BF16))
    assert tfa.launches["flash_attention_cross"] \
        == before["flash_attention_cross"] + 1
    assert all(tfa.launches[k] == before[k] for k in before
               if k != "flash_attention_cross")
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,T,H,KV,D", [(2, 100, 257, 4, 2, 64),
                                          (1, 129, 300, 4, 4, 128),
                                          (1, 70, 130, 4, 4, 96),
                                          (32, 448, 1500, 6, 6, 64),
                                          (8, 1, 1500, 6, 6, 64),
                                          (40, 1, 1500, 6, 6, 64),
                                          (2, 1, 257, 4, 2, 64),
                                          (2, 3, 257, 4, 2, 64)])
def test_cuda_flash_attention_cross_lse_matches_plain(cuda, B, S, T, H, KV,
                                                      D):
    """The log-sum-exp over T keys, (B, H, S), against
    ``ref.attention_lse_ref``, and the output unchanged by saving it.  At
    one query (the split-key kernel) the second call also shows that the
    first left its arrival counters at 0."""
    q, k, v = _cross_inputs(cuda, B, S, T, H, KV, D, torch.bfloat16, 7)
    out, lse = tfa.flash_attention(q, k, v, causal=False, return_lse=True)
    assert lse.shape == (B, H, S)
    want = ref.attention_lse_ref(q, k, causal=False)
    torch.testing.assert_close(lse, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())
    assert torch.equal(out, tfa.flash_attention(q, k, v, causal=False))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_flash_attention_cross_refusals(cuda):
    """Keys of their own length take causal=False and window=0 only (the
    wrapper raises otherwise, and for no keys at all); under grad bf16 at
    D = 64 runs the forward and one backward launch, and fp32 (no
    backward kernel) raises; without grad both run."""
    from repro_torch.kernels import ops
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _cross_inputs(cuda, 1, 20, 50, 4, 4, 64, dtype, 1)
        for kw in (dict(causal=True), dict(causal=False, window=8)):
            with pytest.raises(ValueError, match="causal=False"):
                tfa.flash_attention(q, k, v, **kw)
        with pytest.raises(ValueError, match="no keys"):
            tfa.flash_attention(q, k[:, :0], v[:, :0], causal=False)
        if dtype == torch.bfloat16:
            before = dict(tfa.launches)
            out = ops.flash_attention(q.clone().requires_grad_(), k, v,
                                      causal=False)
            out.float().sum().backward()
            for key in ("flash_attention_bwd", "flash_attention_bwd_cross",
                        "flash_attention_cross"):
                assert tfa.launches[key] == before[key] + 1
            with pytest.raises(ValueError, match="causal=False"):
                tfa.flash_attention_bwd(q, k, v, out.detach(), out.detach(),
                                        torch.zeros(1, 4, 20, device=cuda),
                                        causal=True)
        else:
            with pytest.raises(NotImplementedError, match="backward"):
                ops.flash_attention(q.clone().requires_grad_(), k, v,
                                    causal=False)
        with torch.no_grad():
            assert ops.flash_attention(q, k, v, causal=False).shape \
                == (1, 20, 4, 64)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_flash_attention_cross_flag_counts_equal_lengths(cuda):
    """A cross-attention whose memory is as long as its tokens (T == S)
    is counted under ``flash_attention_cross`` when the caller says so
    (``cross=True``, as ``xattn_apply`` does), takes causal=False and
    window=0 only, and under grad runs the backward kernel, its forward
    still counted as a cross-attention and its backward not (the keys'
    length is the queries')."""
    from repro_torch.kernels import ops
    q, k, v = _cross_inputs(cuda, 2, 64, 64, 4, 4, 64, torch.bfloat16, 2)
    before = dict(tfa.launches)
    got = ops.flash_attention(q, k, v, causal=False, cross=True)
    torch.testing.assert_close(
        got.float(), ref.flash_attention_ref(q, k, v, causal=False).float(),
        **BF16)
    assert tfa.launches["flash_attention_cross"] \
        == before["flash_attention_cross"] + 1
    assert all(tfa.launches[k] == before[k] for k in before
               if k != "flash_attention_cross")
    with pytest.raises(ValueError, match="causal=False"):
        tfa.flash_attention(q, k, v, causal=True, cross=True)
    before = dict(tfa.launches)
    ops.flash_attention(q.clone().requires_grad_(), k, v, causal=False,
                        cross=True).float().sum().backward()
    assert tfa.launches["flash_attention_cross"] \
        == before["flash_attention_cross"] + 1
    assert tfa.launches["flash_attention_bwd"] \
        == before["flash_attention_bwd"] + 1
    assert tfa.launches["flash_attention_bwd_cross"] \
        == before["flash_attention_bwd_cross"]
    assert tfa.launches["flash_attention"] == before["flash_attention"]
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
    caller that never copies would hand them over: at D = 64 and D = 128
    (the tensor maps of the TMA kernel at one and two 128-byte boxes a
    row)."""
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


# -- resident fleets past the ring's shared memory --------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_resident_fleets_past_the_ring(cuda, dtype):
    """``agg_blend`` at A = 5,000, R = 10 (the ring takes 4,001) and
    ``agg_absorb`` with two cohorts of 3,000 (the ring takes 2,334 each)
    take the agent-tiled route: no ring launch, one #2 launch a call or
    cohort, and the plain versions' results, the masses against the exact
    fp64 sums."""
    A, R, N = 5000, 10, 4099
    x, prev, w, mask, assign = _agg_inputs(cuda, A, R, N, dtype, 17)
    tol = F32 if dtype == torch.float32 else BF16
    before = dict(tmha.launches)
    got, mass = tmha.agg_blend(x, w, mask, assign, R, prev)
    assert tmha.launches["agg_blend"] == before["agg_blend"]
    assert tmha.launches["agg_blend_tiled"] == before["agg_blend_tiled"] + 1
    want, _ = ref.agg_blend_ref(x, w, mask, assign, R, prev)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    torch.testing.assert_close(mass.double(),
                               exact_mass(w * mask.float(), assign, R),
                               rtol=1e-6, atol=0)
    assert torch.equal(got[0], prev[0])      # RSU 0 has no mass
    a = 3000                             # two cohorts of 3,000 agents
    arrivals = ((x[:a], w[:a] * mask[:a].float()),
                (x[A - a:].flip(0).contiguous(), w[A - a:] * 0.5))
    bm = torch.linspace(0.0, 1.0, R, device=cuda)
    before = dict(tmha.launches)
    got, total, new = tmha.agg_absorb(arrivals, assign[:a], R, prev, bm,
                                      keep=0.5)
    assert tmha.launches["agg_absorb"] == before["agg_absorb"]
    assert tmha.launches["agg_absorb_tiled"] == before["agg_absorb_tiled"] + 2
    want, _, _ = ref.agg_absorb_ref(arrivals, assign[:a], R, prev, bm,
                                    keep=0.5)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    exact = sum(exact_mass(c_w, assign[:a], R) for _, c_w in arrivals)
    torch.testing.assert_close(new.double(), exact, rtol=1e-6, atol=0)
    torch.testing.assert_close(total.double(), 0.5 * bm.double() + exact,
                               rtol=1e-6, atol=0)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_ring_route_unchanged_below_its_limit(cuda):
    """At the ring's last fleet (4,001 agents at R = 10 for ``agg_blend``,
    4,668 in one cohort for ``agg_absorb``) the call is one ring launch and
    no tiled one, bit for bit the same on a repeat."""
    assert tmha.ring_fits(10, 4001, build=True)
    assert not tmha.ring_fits(10, 4002, build=True)
    assert tmha.ring_fits(10, 4668, build=False)
    assert not tmha.ring_fits(10, 4669, build=False)
    x, prev, w, mask, assign = _agg_inputs(cuda, 4668, 10, 1000,
                                           torch.float32, 5)
    before = dict(tmha.launches)
    got, _ = tmha.agg_blend(x[:4001], w[:4001], mask[:4001], assign[:4001],
                            10, prev)
    again, _ = tmha.agg_blend(x[:4001], w[:4001], mask[:4001], assign[:4001],
                              10, prev)
    absorbed, _, _ = tmha.agg_absorb(((x, w),), assign, 10, prev,
                                     torch.ones(10, device=cuda), keep=0.5)
    assert tmha.launches["agg_blend"] == before["agg_blend"] + 2
    assert tmha.launches["agg_absorb"] == before["agg_absorb"] + 1
    assert tmha.launches["agg_blend_tiled"] == before["agg_blend_tiled"]
    assert tmha.launches["agg_absorb_tiled"] == before["agg_absorb_tiled"]
    assert torch.equal(got, again)
    torch.testing.assert_close(
        got, ref.agg_blend_ref(x[:4001], w[:4001], mask[:4001],
                               assign[:4001], 10, prev)[0], **F32)
    torch.testing.assert_close(absorbed, ref.agg_absorb_ref(
        ((x, w),), assign, 10, prev, torch.ones(10, device=cuda),
        keep=0.5)[0], **F32)
    torch.cuda.synchronize()


# -- the scenario axis: S stacked fleets, one launch a call ----------------

# the sweep shape (Fig. 2's chunk of 16 at the paper fleet) and a ragged
# one (S=3, A=7, R=3, odd N)
SWEEP_SHAPES = [(16, 100, 10, 31_810), (3, 7, 3, 1001)]


def _sweep_inputs(dev, S, A, R, N, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(S, A, N, device=dev, generator=g).to(dtype)
    prev = torch.randn(S, R, N, device=dev, generator=g).to(dtype)
    w = torch.rand(S, A, device=dev, generator=g) + 0.5
    mask = torch.rand(S, A, device=dev, generator=g) < 0.6
    assign = torch.randint(0, R, (S, A), device=dev, generator=g)
    mask[0, assign[0] == 0] = False     # scenario 0's RSU 0 keeps its row
    return x, prev, w, mask, assign


def _count(entry, launches=tmha.launches):
    return launches[entry]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,A,R,N", SWEEP_SHAPES)
def test_cuda_sweep_agg_blend_and_cloud_blend(cuda, dtype, S, A, R, N):
    """agg_blend and cloud_blend over S scenarios in one launch each, with
    per-scenario and shared weights and RSU ids: against the plain S-axis
    version, and equal to S one-scenario calls bit for bit (the agent
    split does not depend on S); a scenario's zero-mass RSU keeps its row
    bit for bit."""
    x, prev, w, mask, assign = _sweep_inputs(cuda, S, A, R, N, dtype, S + A)
    tol = F32 if dtype == torch.float32 else BF16
    for ww, aa in ((w, assign), (w[0], assign[0]), (w, assign[0].int())):
        before = _count("agg_blend")
        got, mass = tmha.agg_blend(x, ww, mask, aa, R, prev)
        assert _count("agg_blend") == before + 1
        assert got.shape == (S, R, N) and mass.shape == (S, R)
        want, _ = ref.agg_blend_ref(x, ww, mask, aa, R, prev)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        torch.testing.assert_close(mass.double(),
                                   exact_mass(ww * mask, aa, R),
                                   rtol=1e-6, atol=0)
        for s in range(S):
            one, one_mass = tmha.agg_blend(
                x[s], ww if ww.dim() == 1 else ww[s], mask[s],
                aa if aa.dim() == 1 else aa[s], R, prev[s])
            assert torch.equal(got[s], one)
            assert torch.equal(mass[s], one_mass)
        dead = mass <= 0
        assert torch.equal(got[dead], prev[dead])
    cloud = torch.randn(S, N, device=cuda)
    rmass = torch.rand(S, R, device=cuda)
    rmass[0] = 0.0                      # scenario 0 keeps its cloud
    before = _count("cloud_blend")
    got = tmha.cloud_blend(prev, rmass, cloud)
    assert _count("cloud_blend") == before + 1
    assert got.shape == (S, N) and got.dtype == torch.float32
    torch.testing.assert_close(got, ref.cloud_blend_ref(prev, rmass, cloud),
                               **tol)
    assert torch.equal(got[0], cloud[0])
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,A,R,N", SWEEP_SHAPES)
def test_cuda_sweep_agg_absorb_and_matmul(cuda, dtype, S, A, R, N):
    """agg_absorb's two cohorts, the (S, R, A) @ (S, A, N) matmul (and a
    shared (R, A) W), the fp32-output scatter-accumulate and cloud_agg over
    S scenarios, one launch each, against the plain S-axis versions."""
    from repro_torch.core.aggregation import build_weight_matrix
    x, prev, w, mask, assign = _sweep_inputs(cuda, S, A, R, N, dtype, A + N)
    tol = F32 if dtype == torch.float32 else BF16
    x2 = x.flip(1).contiguous()
    arrivals = [(x, w * mask), (x2, w)]
    bm = torch.rand(S, R, device=cuda)
    for keep in (0.5, torch.rand(R, device=cuda)):
        before = _count("agg_absorb")
        got = tmha.agg_absorb(arrivals, assign, R, prev, bm, keep=keep)
        assert _count("agg_absorb") == before + 1
        want = ref.agg_absorb_ref(arrivals, assign, R, prev, bm, keep=keep)
        torch.testing.assert_close(got[0].float(), want[0].float(), **tol)
        exact = sum(exact_mass(ww, assign, R) for _, ww in arrivals)
        kept = torch.as_tensor(keep, device=cuda).double() * bm.double()
        for g_, w_ in zip(got[1:], (kept + exact, exact)):
            torch.testing.assert_close(g_.double(), w_, rtol=1e-6, atol=1e-6)
        one = tmha.agg_absorb([(a[1], b[1]) for a, b in arrivals], assign[1],
                              R, prev[1], bm[1], keep=keep)
        assert torch.equal(got[0][1], one[0])
    W = build_weight_matrix(w, mask, assign, R)              # (S, R, A)
    for WW in (W, W[1 % S]):
        before = _count("weighted_agg_matmul")
        got = tmha.weighted_agg_matmul(WW, x)
        assert _count("weighted_agg_matmul") == before + 1
        assert got.shape == (S, R, N) and got.dtype == dtype
        torch.testing.assert_close(
            got.float(), ref.weighted_agg_matmul_ref(WW, x).float(), **tol)
        for s in range(S):
            assert torch.equal(got[s], tmha.weighted_agg_matmul(
                WW if WW.dim() == 2 else WW[s], x[s]))
    from repro_torch.kernels import ops
    before = _count("scatter_accumulate")
    num, mass = ops.masked_scatter_accumulate(x, w * mask, assign, R)
    assert _count("scatter_accumulate") == before + 1
    assert num.dtype == torch.float32 and num.shape == (S, R, N)
    from repro_torch.core.aggregation import scatter_accumulate
    want_num, _ = scatter_accumulate(x, w * mask, assign, R)
    torch.testing.assert_close(num, want_num, **F32)
    torch.testing.assert_close(mass.double(), exact_mass(w * mask, assign, R),
                               rtol=1e-6, atol=0)
    rmass = torch.rand(S, R, device=cuda)
    torch.testing.assert_close(tmha.cloud_agg(prev, rmass).float(),
                               ref.cloud_agg_ref(prev, rmass).float(), **tol)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("anchor_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,A,R,N", SWEEP_SHAPES)
def test_cuda_sweep_dual_proximal_sgd(cuda, anchor_dtype, S, A, R, N):
    """S*A rows in one launch: the cloud anchor one row a scenario (S, N),
    lr / mu1 / mu2 each a float or an (S,) tensor read by the row's
    scenario, live from active_steps; against the plain version, and equal
    to S one-scenario launches bit for bit."""
    g_ = torch.Generator(device=cuda).manual_seed(S * A)
    w, g, a1 = (torch.randn(S * A, N, device=cuda, generator=g_)
                for _ in range(3))
    a1 = a1.to(anchor_dtype)
    a2 = torch.randn(S, N, device=cuda, generator=g_).to(anchor_dtype)
    active = torch.randint(0, 3, (S * A,), device=cuda, generator=g_,
                           dtype=torch.int32)
    lr = torch.rand(S, device=cuda, generator=g_) * 0.2
    mu1 = torch.rand(S, device=cuda, generator=g_) * 0.02
    mu1[0] = 0.0                          # scenario 0 drops the RSU term
    for hp in (dict(lr=lr, mu1=mu1, mu2=0.005),
               dict(lr=0.1, mu1=0.01, mu2=mu1)):
        before = _count("dual_proximal_sgd", tdps.launches)
        got = tdps.dual_proximal_sgd(w, g, a1, a2, active_steps=active,
                                     step=1, **hp)
        assert _count("dual_proximal_sgd", tdps.launches) == before + 1
        want = ref.dual_proximal_sgd_ref(w, g, a1, a2, active_steps=active,
                                         step=1, **hp)
        torch.testing.assert_close(got, want, **UPDATE)
        for s in range(S):
            rows = slice(s * A, (s + 1) * A)
            one = tdps.dual_proximal_sgd(
                w[rows], g[rows], a1[rows], a2[s], active_steps=active[rows],
                step=1, **{k: float(v[s]) if torch.is_tensor(v) else v
                           for k, v in hp.items()})
            assert torch.equal(got[rows], one)
    # a length that does not divide the rows, two lengths in one call, a
    # CPU tensor
    for bad in (dict(lr=torch.rand(S * A + 1, device=cuda)),
                dict(lr=lr, mu1=mu1[:1]), dict(lr=lr.cpu())):
        with pytest.raises(ValueError):
            tdps.dual_proximal_sgd(w, g, a1, a2, **dict(
                dict(lr=0.1, mu1=0.0, mu2=0.0), **bad))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_sweep_shared_memory_limit_is_per_scenario(cuda):
    """The ring kernel stages one scenario's weights a block, so the limit
    is on A, not S*A: 50 scenarios of 100 agents (5,000 rows, past what
    one scenario may hold at R = 10) run on the ring and match the plain
    version; one scenario of 4,100 agents takes the agent-tiled route and
    matches too."""
    S, A, R, N = 50, 100, 10, 513
    x, prev, w, mask, assign = _sweep_inputs(cuda, S, A, R, N, torch.float32,
                                             5)
    before = dict(tmha.launches)
    got, _ = tmha.agg_blend(x, w, mask, assign, R, prev)
    assert tmha.launches["agg_blend"] == before["agg_blend"] + 1
    want, _ = ref.agg_blend_ref(x, w, mask, assign, R, prev)
    torch.testing.assert_close(got, want, **F32)
    g = torch.Generator(device=cuda).manual_seed(9)
    big = torch.randn(1, 4100, 64, device=cuda, generator=g)
    args = (torch.ones(4100, device=cuda),
            torch.ones(1, 4100, device=cuda, dtype=torch.bool),
            torch.arange(4100, device=cuda) % R, R,
            torch.zeros(1, R, 64, device=cuda))
    before = dict(tmha.launches)
    got, _ = tmha.agg_blend(big, *args)
    assert tmha.launches["agg_blend"] == before["agg_blend"]
    assert tmha.launches["agg_blend_tiled"] == before["agg_blend_tiled"] + 1
    torch.testing.assert_close(got, ref.agg_blend_ref(big, *args)[0], **F32)
    torch.cuda.synchronize()


# #2 past one block's shared memory: A = 3,632 is the most whose 16 rows
# of weights a block stages whole (the parent's limit at R = 9-16), 3,633
# the first that takes agent tiles, 16,384 the streamed rounds' chunk; at
# N = 31,810 the agents split over groups, at N = 300,001 (R = 16) they do
# not
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("A,R,N", [(3632, 4, 31_810), (3633, 4, 31_810),
                                   (16_384, 4, 31_810), (3632, 16, 31_810),
                                   (3633, 16, 31_810), (16_384, 16, 31_810),
                                   (3633, 16, 300_001)])
def test_cuda_matmul_takes_any_agent_count(cuda, dtype, A, R, N):
    """The matmul kernels take any A: the product against the fp64 one
    (within 1e-6 of the sum of |terms|, plus one bf16 ulp for a bf16
    output), and ``chunk_agg`` (one-hot weights, a zero-weight tail, fp32
    sums) against its plain version, one launch each."""
    g = torch.Generator(device=cuda).manual_seed(A + R)
    x = torch.randn(A, N, device=cuda, generator=g).to(dtype)
    W = torch.randn(R, A, device=cuda, generator=g)
    before = tmha.launches["weighted_agg_matmul"]
    got = tmha.weighted_agg_matmul(W, x).double()
    assert tmha.launches["weighted_agg_matmul"] == before + 1
    exact = W.double() @ x.double()
    lim = 1e-6 * (W.double().abs() @ x.double().abs())
    if dtype == torch.bfloat16:
        lim += 2 ** -7 * exact.abs()
    assert ((got - exact).abs() <= lim).all()
    del got, exact, lim
    w = torch.rand(A, device=cuda, generator=g) + 0.5
    w[-7:] = 0.0
    assign = torch.arange(A, device=cuda) % R
    before = tmha.launches["chunk_agg"]
    num, mass = tmha.scatter_accumulate(x, w, assign, R, entry="chunk_agg")
    assert tmha.launches["chunk_agg"] == before + 1 and num.dtype == \
        torch.float32
    want, want_mass = ref.chunk_agg_ref(x, w, assign, R)
    scale = (torch.nn.functional.one_hot(assign, R).T.float() * w) @ \
        x.float().abs()
    assert ((num - want).abs() <= 2e-6 * scale).all()
    # the masses sum up to 4,096 weights an RSU, in another order
    torch.testing.assert_close(mass, want_mass, rtol=1e-5, atol=0)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_streamed_round_memory_does_not_grow_with_the_fleet(cuda):
    """The host-streamed flat round's peak device memory is the chunk's:
    the paper MLP in chunks of 512 agents, over fleets of 1,024 and 4,096
    host agents (one shared 4-sample shard), within 1% of each other."""
    import numpy as np
    from repro_torch.configs.mnist_mlp import CONFIG
    from repro_torch.core.flatten import spec_of
    from repro_torch.core.h2fed import H2FedParams
    from repro_torch.core.heterogeneity import HeterogeneityModel
    from repro_torch.data.partition import FederatedData
    from repro_torch.fedsim.simulator import SimConfig
    from repro_torch.fedsim.streaming import (init_stream_state,
                                              make_streamed_flat_round)
    from repro_torch.models import mlp
    rng = np.random.default_rng(0)
    x1 = rng.normal(size=(1, 4, 784)).astype(np.float32)
    y1 = rng.integers(0, 10, size=(1, 4)).astype(np.int32)
    params = mlp.init_params(CONFIG, torch.Generator().manual_seed(0),
                             device=cuda)
    spec = spec_of(params)
    peaks = []
    for A in (1024, 4096):
        fed = FederatedData(x=np.broadcast_to(x1, (A, 4, 784)),
                            y=np.broadcast_to(y1, (A, 4)),
                            n_per_agent=np.full((A,), 4, np.int32),
                            rsu_assign=np.arange(A, dtype=np.int32) % 16)
        cfg = SimConfig(n_agents=A, n_rsus=16, batch=4)
        round_fn = make_streamed_flat_round(
            cfg, H2FedParams(lar=1, local_epochs=1), HeterogeneityModel(),
            fed, spec, device=cuda, chunk_agents=512)
        state = round_fn(init_stream_state(cfg, spec, params, cuda))
        assert state.store.pinned
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state = round_fn(state)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated())
        first, last = state.store.gather(0, 1), state.store.gather(A - 1, A)
        assert torch.equal(first, last) and torch.isfinite(first).all()
        del state
    assert abs(peaks[1] - peaks[0]) <= 0.01 * peaks[0], peaks


# --------------------------------------------------------------------------
# the training path: #3 on bf16 leaves, #4's backward, no grad-less output
# --------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("N", [1001, 100_000])
@pytest.mark.parametrize("anchor_dtype", [torch.float32, torch.bfloat16])
def test_cuda_dual_proximal_sgd_bf16_leaves_match_plain(cuda, anchor_dtype,
                                                        N):
    """bf16 w, g and out (a training leaf): fp32 math rounded to bf16,
    within one bf16 ulp of the plain version (the kernel contracts the
    multiply-adds); in place too."""
    gen = torch.Generator(device=cuda).manual_seed(N)
    w, g = (torch.randn(N, device=cuda, generator=gen).bfloat16()
            for _ in range(2))
    a1, a2 = (torch.randn(N, device=cuda, generator=gen).to(anchor_dtype)
              for _ in range(2))
    kw = dict(lr=0.1, mu1=0.01, mu2=0.005)
    want = ref.dual_proximal_sgd_ref(w, g, a1, a2, **kw)
    got = tdps.dual_proximal_sgd(w, g, a1, a2, **kw)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **BF16)
    tdps.dual_proximal_sgd(w, g, a1, a2, out=w, **kw)
    assert torch.equal(w, got)
    with pytest.raises(ValueError):
        tdps.dual_proximal_sgd(w, g.float(), a1, a2, **kw)


def _bwd_inputs(dev, B, S, H, KV, D, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(B, S, n, D, device=dev, generator=gen).bfloat16()
            for n in (H, KV, KV, H)]


# (B, S, H, KV, D, causal, window) of the log-sum-exp checks: S ragged
# against the 128-row query tiles of the TMA + wgmma kernel at D = 128 and
# at (64, 64), GQA 8/2 at 64 past the 2-stage ring, and one non-causal
# query at 64 (the split-key kernel)
LSE_CASES = [(2, 130, 4, 2, 128, True, 0), (2, 200, 4, 2, 64, True, 0),
             (1, 1000, 8, 4, 128, True, 100), (2, 130, 4, 4, 64, True, 33),
             (2, 200, 4, 1, 128, False, 0), (1, 1000, 4, 2, 64, False, 0),
             (1, 1000, 8, 2, 64, True, 0), (3, 1, 4, 2, 64, False, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,D,causal,window", LSE_CASES)
def test_cuda_flash_attention_lse_matches_plain(cuda, B, S, H, KV, D,
                                                causal, window):
    """The forward's saved log-sum-exp against the plain masked logsumexp
    times log2 e (``ref.attention_lse_ref``, fp32): within 1e-5 relative,
    with a floor of 1e-5 of the largest value for rows near 0 (fp32
    scores and sums of exponentials in another order)."""
    q, k, v, _ = _bwd_inputs(cuda, B, S, H, KV, D)
    kw = dict(causal=causal, window=window)
    before = tfa.launches["flash_attention"]
    out, lse = tfa.flash_attention(q, k, v, return_lse=True, **kw)
    assert tfa.launches["flash_attention"] == before + 1
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    want = ref.attention_lse_ref(q, k, **kw)
    torch.testing.assert_close(lse, want, rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())
    with pytest.raises(ValueError, match="bf16"):
        tfa.flash_attention(q.float(), k.float(), v.float(), return_lse=True)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,D,causal,window", LSE_CASES)
def test_cuda_flash_attention_output_same_with_lse(cuda, B, S, H, KV, D,
                                                   causal, window):
    """Saving the log-sum-exp leaves the forward's output bit for bit."""
    q, k, v, _ = _bwd_inputs(cuda, B, S, H, KV, D)
    kw = dict(causal=causal, window=window)
    out, _ = tfa.flash_attention(q, k, v, return_lse=True, **kw)
    assert torch.equal(out, tfa.flash_attention(q, k, v, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,D,causal,window", [
    (2, 200, 4, 2, 64, True, 0), (1, 300, 4, 2, 64, True, 100),
    (1, 130, 4, 2, 128, True, 0), (1, 1000, 16, 8, 128, False, 0),
    (1, 1024, 16, 8, 128, True, 256), (2, 64, 4, 4, 64, False, 0),
    (1, 257, 4, 4, 128, True, 100), (1, 513, 8, 2, 128, True, 200),
    (2, 300, 4, 1, 64, True, 0), (1, 200, 8, 2, 128, False, 70),
    (1, 257, 8, 2, 64, True, 100), (2, 1000, 4, 4, 64, False, 0),
    (2, 130, 4, 4, 80, True, 0), (1, 257, 8, 2, 80, True, 100),
    (1, 1000, 16, 8, 80, False, 0), (1, 700, 12, 4, 80, True, 33),
    (2, 130, 4, 4, 96, True, 0), (1, 513, 8, 2, 96, True, 200),
    (1, 1000, 16, 4, 96, False, 0), (1, 300, 8, 1, 96, True, 70)])
def test_cuda_flash_attention_backward_matches_autograd_of_plain(
        cuda, B, S, H, KV, D, causal, window):
    """``ops.flash_attention`` under autograd on the card (the forward and
    backward kernels) against autograd of the plain version: dQ, dK, dV
    within 2^-7 (max|want| + |want|), the bf16 rounding of P and dS as
    product operands and of the outputs.  GQA groups 1, 2, 3, 4 and 8;
    windows that are not a multiple of the tiles; at D = 80 and 96 (rows
    of two boxes, the second zero past column 16 or 32) S ragged against
    the 64-row query and 128-key tiles."""
    from repro_torch.kernels import ops
    q, k, v, do = _bwd_inputs(cuda, B, S, H, KV, D)
    kw = dict(causal=causal, window=window)
    want_in = [t.clone().requires_grad_() for t in (q, k, v)]
    ref.flash_attention_ref(*want_in, **kw).backward(do)
    got_in = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(tfa.launches)
    out = ops.flash_attention(*got_in, **kw)
    assert out.grad_fn is not None
    out.backward(do)
    assert tfa.launches["flash_attention_bwd"] == (
        before["flash_attention_bwd"] + 1)
    for g, w in zip(got_in, want_in):
        tol = 2.0 ** -7
        torch.testing.assert_close(
            g.grad.float(), w.grad.float(), rtol=tol,
            atol=tol * w.grad.float().abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,D,causal,window", [
    (1, 1024, 16, 8, 128, True, 0), (2, 300, 4, 2, 64, True, 100),
    (1, 700, 8, 2, 80, True, 0), (1, 513, 8, 4, 96, True, 100)])
def test_cuda_flash_attention_backward_repeats_within_tolerance(
        cuda, B, S, H, KV, D, causal, window):
    """Two backward calls on the same inputs: dK and dV bit for bit (each
    sums in registers in a fixed order), dQ within 2^-7 (max|a| + |a|) of
    the first call's.  dQ sums the key tiles' shares by bulk reduce-adds
    in whatever order the blocks reach them, so its last bits may differ
    from run to run."""
    q, k, v, do = _bwd_inputs(cuda, B, S, H, KV, D)
    kw = dict(causal=causal, window=window)
    out, lse = tfa.flash_attention(q, k, v, return_lse=True, **kw)
    first = tfa.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    second = tfa.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    assert torch.equal(first[1], second[1])
    assert torch.equal(first[2], second[2])
    tol = 2.0 ** -7
    torch.testing.assert_close(
        second[0].float(), first[0].float(), rtol=tol,
        atol=tol * first[0].float().abs().max().item())


@pytest.mark.gpu
def test_cuda_no_gradless_kernel_output(cuda):
    """Under grad, a CUDA route either carries a gradient or raises: the
    forward kernel of a fp32 or D = 32 attention (no backward kernel) and
    the aggregation and update kernels (no backward) raise by name; the
    sLSTM scan carries its backward kernel's gradient."""
    from repro_torch.kernels import ops
    w = torch.randn(4, 10, device=cuda, requires_grad=True)
    weights = torch.ones(4, device=cuda)
    with pytest.raises(NotImplementedError, match="dual_proximal_sgd"):
        ops.dual_proximal_sgd(w, w.detach(), w.detach(), w.detach(),
                              lr=0.1, mu1=0.0, mu2=0.0)
    with pytest.raises(NotImplementedError, match="cloud_agg"):
        ops.cloud_agg(w, weights)
    with torch.no_grad():
        assert ops.cloud_agg(w, weights).shape == (10,)
    q, k, v, _ = _bwd_inputs(cuda, 1, 64, 4, 2, 32)
    with pytest.raises(NotImplementedError, match="backward"):
        ops.flash_attention(q.requires_grad_(), k, v)
    q, k, v, _ = _bwd_inputs(cuda, 1, 64, 4, 2, 64)
    with pytest.raises(NotImplementedError, match="backward"):
        ops.flash_attention(q.float().requires_grad_(), k.float(),
                            v.float())
    with torch.no_grad():
        assert ops.flash_attention(q.float(), k.float(), v.float()).shape \
            == q.shape
    wx = torch.randn(1, 8, 4 * 64, device=cuda, requires_grad=True)
    r = torch.randn(4, 16, 64, device=cuda)
    b = torch.zeros(4 * 64, device=cuda)
    out = ops.slstm_scan(wx, r, b)
    assert out.grad_fn is not None and out.shape == (1, 8, 64)
    with torch.no_grad():
        assert ops.slstm_scan(wx, r, b).grad_fn is None


# (B, S, T, H, KV) of #4's backward with keys of their own length (D = 64,
# non-causal): whisper's cross layer at its decoder context (448 tokens
# over 1500 frames), T past and short of S, ragged against the 64-key and
# 64-query tiles, GQA 2 and 4; and one and four queries, whose forward is
# the split-key kernel (its lse is what the backward reads)
CROSS_BWD_CASES = [(1, 448, 1500, 6, 6), (2, 100, 257, 4, 2),
                   (2, 300, 100, 4, 4), (1, 65, 63, 8, 2),
                   (3, 1, 257, 4, 2), (2, 4, 1500, 6, 6)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,T,H,KV", CROSS_BWD_CASES)
def test_cuda_flash_attention_cross_backward_matches_autograd_of_plain(
        cuda, B, S, T, H, KV):
    """``ops.flash_attention`` of S queries over T keys under autograd on
    the card against autograd of the plain version: dQ, dK, dV within 2^-7
    (max|want| + |want|), as at T == S; one forward launch counted as a
    cross-attention and one backward launch.  Run again on the same
    inputs, the backward gives dK and dV bit for bit and dQ within the
    same tolerance (its key tiles' shares sum in no fixed order).  The
    backward launch is also counted under ``flash_attention_bwd_cross``."""
    from repro_torch.kernels import ops
    q, k, v = _cross_inputs(cuda, B, S, T, H, KV, 64, torch.bfloat16, S + T)
    do = torch.randn(B, S, H, 64, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(T)).bfloat16()
    want_in = [t.clone().requires_grad_() for t in (q, k, v)]
    ref.flash_attention_ref(*want_in, causal=False).backward(do)
    got_in = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(tfa.launches)
    ops.flash_attention(*got_in, causal=False).backward(do)
    for key in ("flash_attention_bwd", "flash_attention_bwd_cross",
                "flash_attention_cross"):
        assert tfa.launches[key] == before[key] + 1
    tol = 2.0 ** -7
    for g, w in zip(got_in, want_in):
        torch.testing.assert_close(
            g.grad.float(), w.grad.float(), rtol=tol,
            atol=tol * w.grad.float().abs().max().item())
    out, lse = tfa.flash_attention(q, k, v, causal=False, return_lse=True)
    first = tfa.flash_attention_bwd(q, k, v, out, do, lse, causal=False)
    second = tfa.flash_attention_bwd(q, k, v, out, do, lse, causal=False)
    assert torch.equal(first[1], second[1])
    assert torch.equal(first[2], second[2])
    torch.testing.assert_close(
        second[0].float(), first[0].float(), rtol=tol,
        atol=tol * first[0].float().abs().max().item())
    torch.cuda.synchronize()


# #5's backward against autograd of the plain scan: |got - want| <= tol
# (max|want| + |want|), tol 1e-4, 1e-3 with saturated gates: fp32 sums in
# another order (the recomputed gates' h @ R, dh's R . dg, dR's sum over
# b and t) and transcendentals within an ulp of PyTorch's, carried back
# through every step; a bf16 dR also rounds once to bf16 (2^-8 relative)
SCAN_BWD_TOL = {1.0: 1e-4, 25.0: 1e-3}
SCAN_BWD_BF16_TOL = 2.0 ** -7

# (B, S, H, P, scale): xlstm-125m's layer width (H = 4, P = 192) at a
# short S, the reduced xlstm's P = 64, P = 32 at a ragged S, saturated
# gates, P = 24 (the shared-memory forward), S = 1 and 2 (the first steps'
# carries), and P = 1024 (the backward reads R from device memory)
SLSTM_BWD_CASES = [(2, 64, 4, 192, 1.0), (2, 100, 4, 64, 1.0),
                   (3, 37, 2, 32, 1.0), (2, 48, 4, 32, 25.0),
                   (2, 30, 2, 24, 1.0), (1, 1, 4, 192, 1.0),
                   (2, 2, 2, 32, 1.0), (1, 20, 1, 1024, 1.0)]


def _held(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol * want.float().abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("r_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,H,P,scale", SLSTM_BWD_CASES)
def test_cuda_slstm_scan_backward_matches_autograd_of_plain(
        cuda, r_dtype, B, S, H, P, scale):
    """``ops.slstm_scan`` under autograd on the card (the forward with its
    saved state, the reverse-scan kernel) against autograd of
    ``ref.slstm_scan_ref``: dwx, dR and db within ``SCAN_BWD_TOL``, one
    launch of each kernel.  The saved state equals the plain forward's
    (c, n, m) at the forward's tolerance, and a second backward call on the
    same inputs gives dwx bit for bit (one fixed order of sums)."""
    from repro_torch.kernels import ops
    wx, r, b = _scan_inputs(cuda, B, S, H, P, r_dtype, seed=S + P,
                            scale=scale)
    dh = torch.randn(B, S, H * P, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(5))
    want_in = [t.clone().requires_grad_() for t in (wx, r, b)]
    ref.slstm_scan_ref(*want_in).backward(dh)
    got_in = [t.clone().requires_grad_() for t in (wx, r, b)]
    before = dict(tss.launches)
    ops.slstm_scan(*got_in).backward(dh)
    assert tss.launches == {k: v + 1 for k, v in before.items()}
    tol = SCAN_BWD_TOL[scale]
    _held(got_in[0].grad, want_in[0].grad, tol)
    _held(got_in[1].grad, want_in[1].grad,
          SCAN_BWD_BF16_TOL if r_dtype == torch.bfloat16 else tol)
    _held(got_in[2].grad, want_in[2].grad, tol)
    out, state = tss.slstm_scan(wx, r, b, return_state=True)
    assert torch.equal(out, tss.slstm_scan(wx, r, b))
    want_out, want_state = ref.slstm_scan_ref(wx, r, b, return_state=True)
    torch.testing.assert_close(state, want_state, **(
        SCAN if scale == 1.0 else SCAN_SATURATED))
    first = tss.slstm_scan_bwd(dh, wx, r, b, out, state)
    second = tss.slstm_scan_bwd(dh, wx, r, b, out, state)
    assert torch.equal(first[0], second[0])
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("d,P,r_dtype,want", [
    (768, 192, torch.bfloat16, (8, "shared memory")),
    (768, 192, torch.float32, (16, "shared memory")),
    (256, 64, torch.bfloat16, (1, "shared memory")),
    (1024, 1024, torch.float32, (1, "device memory"))])
def test_cuda_slstm_scan_backward_plans(cuda, d, P, r_dtype, want):
    """The backward's cluster: the fewest CTAs whose rows of R fit their
    shared memory (xlstm-125m's layer: 8 in bf16, 16 in fp32, past the
    portable 8), else R read from device memory."""
    got = tss.bwd_plan(d, P, r_dtype)
    assert (got["cluster"], got["r_lives_in"]) == want
