"""The kernels' plain PyTorch versions against the JAX Pallas kernels run
in interpret mode (each CUDA kernel against its plain version is in
test_torch_cuda_kernels.py, which runs on a GPU).

Tolerances: fp32 2e-6 absolute / relative (sums of at most a few dozen
O(1) products in another order); bf16 outputs within one bf16 ulp of the
stored value (2**-7 relative), since an fp32 sum that differs in its last
bit can round to either neighbour.  Rows with zero mass keep the previous
buffer exactly on every route.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dual_proximal_sgd as jdps
from repro.kernels import masked_hier_agg as jmha

from repro_torch import convert
from repro_torch.kernels import dual_proximal_sgd as tdps
from repro_torch.kernels import masked_hier_agg as tmha
from repro_torch.kernels import ops

F32 = dict(rtol=2e-6, atol=2e-6)
BF16 = dict(rtol=2 ** -7, atol=2 ** -126)
INTERP = dict(interpret=True)
JAX_DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _pair(arr, dtype):
    """The same values as a JAX array and a torch tensor in ``dtype``."""
    j = jnp.asarray(arr).astype(JAX_DTYPES[dtype])
    return j, convert.tensor_from_numpy(np.asarray(j))


def _close(got, want, dtype):
    np.testing.assert_allclose(convert.tensor_to_numpy(got),
                               np.asarray(want, np.float32),
                               **(F32 if dtype == "f32" else BF16))


def _agg_inputs(A, R, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((A, N)).astype(np.float32)
    w = rng.uniform(1, 5, A).astype(np.float32)
    mask = rng.integers(0, 2, A).astype(np.float32)
    assign = (np.arange(A) % R).astype(np.int32)
    mask[assign == R - 1] = 0.0                   # one zero-mass RSU row
    prev = rng.standard_normal((R, N)).astype(np.float32)
    return x, w, mask, assign, prev


AGG_CASES = [(4, 2, 64, "f32"), (32, 4, 777, "f32"), (20, 4, 1000, "f32"),
             (16, 4, 512, "bf16"), (20, 4, 1001, "bf16")]


@pytest.mark.parametrize("A,R,N,dtype", AGG_CASES)
def test_agg_blend_ref_matches_pallas(A, R, N, dtype):
    x, w, mask, assign, prev = _agg_inputs(A, R, N, A + N)
    jx, tx = _pair(x, dtype)
    jprev, tprev = _pair(prev, dtype)
    want, jmass = jmha.agg_blend(jx, jnp.asarray(w), jnp.asarray(mask),
                                 jnp.asarray(assign), R, jprev, **INTERP)
    got, mass = ops.agg_blend(tx, torch.from_numpy(w), torch.from_numpy(mask),
                              torch.from_numpy(assign).long(), R, tprev)
    assert got.dtype == tprev.dtype
    _close(got, want, dtype)
    np.testing.assert_allclose(mass.numpy(), np.asarray(jmass), rtol=1e-6)
    dead = mass.numpy() == 0
    assert dead.any()
    assert torch.equal(got[torch.from_numpy(dead)],
                       tprev[torch.from_numpy(dead)])


@pytest.mark.parametrize("A,R,N,dtype", AGG_CASES)
def test_weighted_agg_matmul_and_masked_agg_match_pallas(A, R, N, dtype):
    x, w, mask, assign, _ = _agg_inputs(A, R, N, 3 * A + N)
    jx, tx = _pair(x, dtype)
    W = np.random.default_rng(N).standard_normal((R, A)).astype(np.float32)
    _close(ops.weighted_agg_matmul(torch.from_numpy(W), tx),
           jmha.weighted_agg_matmul(jnp.asarray(W), jx, **INTERP), dtype)
    got, mass = ops.masked_hier_agg(tx, torch.from_numpy(w),
                                    torch.from_numpy(mask),
                                    torch.from_numpy(assign).long(), R)
    want, jmass = jmha.masked_hier_agg(jx, jnp.asarray(w), jnp.asarray(mask),
                                       jnp.asarray(assign), R, **INTERP)
    assert got.dtype == tx.dtype
    _close(got, want, dtype)
    np.testing.assert_allclose(mass.numpy(), np.asarray(jmass), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("dead", [False, True])
def test_cloud_blend_and_agg_match_pallas(dtype, dead):
    rng = np.random.default_rng(11)
    R, N = 4, 1001
    rsu = rng.standard_normal((R, N)).astype(np.float32)
    mass = (np.zeros(R) if dead else rng.uniform(0, 3, R)).astype(np.float32)
    prev = rng.standard_normal(N).astype(np.float32)
    jr, tr = _pair(rsu, dtype)
    got = ops.cloud_blend(tr, torch.from_numpy(mass), torch.from_numpy(prev))
    want = jmha.cloud_blend(jr, jnp.asarray(mass), jnp.asarray(prev), **INTERP)
    assert got.dtype == torch.float32 and got.shape == (N,)
    _close(got, want, "f32" if dead else dtype)
    if dead:
        assert torch.equal(got, torch.from_numpy(prev))
    _close(ops.cloud_agg(tr, torch.from_numpy(mass)),
           jmha.cloud_agg(jr, jnp.asarray(mass), **INTERP), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_agg_absorb_ref_matches_pallas(dtype):
    """The two-pair form: two arrival cohorts plus the retained buffer,
    with one RSU that has neither (kept exactly)."""
    rng = np.random.default_rng(5)
    A, R, N = 12, 4, 777
    arr_j, arr_t = [], []
    for c in range(2):
        x = rng.standard_normal((A, N)).astype(np.float32)
        w = (rng.uniform(0, 2, A) * (np.arange(A) % R != R - 1)).astype(
            np.float32)
        jx, tx = _pair(x, dtype)
        arr_j.append((jx, jnp.asarray(w)))
        arr_t.append((tx, torch.from_numpy(w)))
    buf = rng.standard_normal((R, N)).astype(np.float32)
    bm = np.array([1.0, 0.5, 2.0, 0.0], np.float32)
    jb, tb = _pair(buf, dtype)
    assign = (np.arange(A) % R).astype(np.int32)
    want, jtot, jnew = jmha.agg_absorb(arr_j, jnp.asarray(assign), R, jb,
                                       jnp.asarray(bm), keep=0.5, **INTERP)
    got, tot, new = ops.agg_absorb(arr_t, torch.from_numpy(assign).long(), R,
                                   tb, torch.from_numpy(bm), keep=0.5)
    _close(got, want, dtype)
    np.testing.assert_allclose(tot.numpy(), np.asarray(jtot), rtol=1e-6)
    np.testing.assert_allclose(new.numpy(), np.asarray(jnew), rtol=1e-6)
    assert torch.equal(got[R - 1], tb[R - 1])


@pytest.mark.parametrize("mu1,mu2", [(0.0, 0.0), (0.3, 0.0), (0.0, 0.3),
                                     (0.01, 0.005), (1.0, 1.0)])
@pytest.mark.parametrize("shape", [(17,), (1000, 3), (8, 333)])
def test_dual_proximal_sgd_ref_matches_pallas(mu1, mu2, shape):
    rng = np.random.default_rng(len(shape) + shape[0])
    w, g, a1, a2 = (rng.standard_normal(shape).astype(np.float32)
                    for _ in range(4))
    kw = dict(lr=0.05, mu1=mu1, mu2=mu2)
    want = jdps.dual_proximal_sgd(*map(jnp.asarray, (w, g, a1, a2)), **kw,
                                  **INTERP)
    got = ops.dual_proximal_sgd(*map(torch.from_numpy, (w, g, a1, a2)), **kw)
    _close(got, want, "f32")


def test_dual_proximal_sgd_bf16_anchors_match_pallas():
    rng = np.random.default_rng(9)
    shape = (6, 129)
    w, g, a1, a2 = (rng.standard_normal(shape).astype(np.float32)
                    for _ in range(4))
    (ja1, ta1), (ja2, ta2) = _pair(a1, "bf16"), _pair(a2, "bf16")
    kw = dict(lr=0.1, mu1=0.2, mu2=0.3)
    want = jdps.dual_proximal_sgd(jnp.asarray(w), jnp.asarray(g), ja1, ja2,
                                  **kw, **INTERP)
    got = ops.dual_proximal_sgd(torch.from_numpy(w), torch.from_numpy(g),
                                ta1, ta2, **kw)
    _close(got, want, "f32")


def test_dual_proximal_sgd_scaled_broadcast_is_flat_engine_step():
    """Per-row ``live`` scale + (N,) cloud anchor == the flat engine's
    inline step (src/repro/fedsim/simulator.py, _local_train_flat), and
    ``out=w`` updates in place."""
    rng = np.random.default_rng(4)
    A, N, lr, mu1, mu2 = 5, 257, 0.1, 0.01, 0.005
    w, g, a1 = (rng.standard_normal((A, N)).astype(np.float32)
                for _ in range(3))
    a2 = rng.standard_normal(N).astype(np.float32)
    live = np.array([1, 0, 1, 1, 0], np.float32)
    want = (jnp.asarray(w) - lr * jnp.asarray(live)[:, None]
            * (jnp.asarray(g) + mu1 * (jnp.asarray(w) - jnp.asarray(a1))
               + mu2 * (jnp.asarray(w) - jnp.asarray(a2))))
    tw = torch.from_numpy(w.copy())
    out = ops.dual_proximal_sgd(tw, torch.from_numpy(g), torch.from_numpy(a1),
                                torch.from_numpy(a2), lr=lr, mu1=mu1, mu2=mu2,
                                scale=torch.from_numpy(live), out=tw)
    assert out is tw
    _close(tw, want, "f32")
    assert torch.equal(tw[1], torch.from_numpy(w[1]))   # live = 0 rows


@pytest.mark.parametrize("steps_dtype", [np.int32, np.int64])
def test_dual_proximal_sgd_active_steps_is_flat_engine_step(steps_dtype):
    """The ``active_steps``/``step`` form (the kernel forms ``live`` itself)
    against the reference's inline step, ``live = (step < active_steps)``
    in jnp, at every step of a local round and in place."""
    rng = np.random.default_rng(8)
    A, N, lr, mu1, mu2 = 6, 301, 0.1, 0.01, 0.005
    w, g, a1 = (rng.standard_normal((A, N)).astype(np.float32)
                for _ in range(3))
    a2 = rng.standard_normal(N).astype(np.float32)
    active = np.array([0, 1, 2, 3, 6, 9], steps_dtype)
    for step in range(4):
        live = (step < jnp.asarray(active)).astype(jnp.float32)
        want = (jnp.asarray(w) - lr * live[:, None]
                * (jnp.asarray(g) + mu1 * (jnp.asarray(w) - jnp.asarray(a1))
                   + mu2 * (jnp.asarray(w) - jnp.asarray(a2))))
        tw = torch.from_numpy(w.copy())
        out = ops.dual_proximal_sgd(tw, torch.from_numpy(g),
                                    torch.from_numpy(a1),
                                    torch.from_numpy(a2), lr=lr, mu1=mu1,
                                    mu2=mu2,
                                    active_steps=torch.from_numpy(active),
                                    step=step, out=tw)
        assert out is tw
        _close(tw, want, "f32")
        dead = torch.from_numpy(step >= active)
        assert torch.equal(tw[dead], torch.from_numpy(w)[dead])


def test_cpu_route_launches_nothing_and_wrappers_refuse_cpu():
    """A CPU tensor takes the plain version (no launch is counted); the
    CUDA wrappers themselves never fall back, they raise."""
    ops.reset_launch_counts()
    x = torch.randn(4, 50)
    w, m, a = torch.ones(4), torch.ones(4), torch.tensor([0, 1, 0, 1])
    ops.agg_blend(x, w, m, a, 2, torch.zeros(2, 50))
    ops.dual_proximal_sgd(x, x, x, x, lr=0.1, mu1=0.1, mu2=0.1)
    assert not any(ops.launch_counts().values())
    with pytest.raises(ValueError):
        tmha.agg_blend(x, w, m, a, 2, torch.zeros(2, 50))
    with pytest.raises(ValueError):
        tmha.weighted_agg_matmul(torch.ones(2, 4), x)
    with pytest.raises(ValueError):
        tdps.dual_proximal_sgd(x, x, x, x, lr=0.1, mu1=0.1, mu2=0.1)
    with pytest.raises(ValueError):
        tdps.dual_proximal_sgd(x, x, x, x, lr=0.1, mu1=0.1, mu2=0.1,
                               active_steps=a, step=1, out=x)
    with pytest.raises(ValueError):
        tmha.agg_blend(x, w, m.bool(), a, 2, torch.zeros(2, 50))
    with pytest.raises(ValueError):
        tmha.cloud_blend(torch.zeros(2, 50), torch.ones(2), torch.zeros(50))
    with pytest.raises(ValueError):
        tmha.agg_absorb([(x, w)], a, 2, torch.zeros(2, 50), torch.ones(2))
    assert not any(ops.launch_counts().values())


# -- the scenario axis: the plain S-axis versions against S one-scenario
# calls of the same plain versions (the CUDA kernels are held to these on
# the card, test_torch_cuda_kernels.py)

def _sweep_inputs(S, A, R, N, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((S, A, N)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(1, 5, (S, A)).astype(np.float32))
    mask = torch.from_numpy(rng.integers(0, 2, (S, A)).astype(bool))
    assign = torch.from_numpy(rng.integers(0, R, (S, A)))
    mask[0, assign[0] == 0] = False
    prev = torch.from_numpy(rng.standard_normal((S, R, N)).astype(np.float32))
    return x, w, mask, assign, prev


def _pick(t, s):
    """Scenario s's slice of a per-scenario operand; a shared one as is."""
    return t[s] if t.dim() == 2 else t


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("S,A,R,N", [(3, 7, 3, 1001), (4, 20, 4, 64)])
def test_sweep_aggregation_refs_are_per_scenario_refs(S, A, R, N, shared):
    """agg_blend, cloud_blend, agg_absorb, the matmul, the
    scatter-accumulate and cloud_agg on (S, ...) operands, with weights and
    RSU ids per scenario or shared, equal S calls on each scenario's
    slices."""
    from repro_torch.core.aggregation import (build_weight_matrix,
                                              scatter_accumulate)
    from repro_torch.kernels import ref
    x, w, mask, assign, prev = _sweep_inputs(S, A, R, N, S + A + shared)
    if shared:
        w, assign = w[0], assign[0]
    got, mass = ref.agg_blend_ref(x, w, mask, assign, R, prev)
    rmass = torch.rand(S, R)
    rmass[1] = 0.0
    cloud = torch.randn(S, N)
    got_cloud = ref.cloud_blend_ref(prev, rmass, cloud)
    arrivals = [(x, w * mask), (x.flip(1), w * ~mask)]
    bm = torch.rand(S, R)
    got_abs = ref.agg_absorb_ref(arrivals, assign, R, prev, bm, keep=0.5)
    W = build_weight_matrix(w, mask, assign, R)
    assert W.shape == (S, R, A)
    got_mm = ref.weighted_agg_matmul_ref(W, x)
    got_num, got_m = scatter_accumulate(x, w * mask, assign, R)
    got_cagg = ref.cloud_agg_ref(prev, rmass)
    for s in range(S):
        ws, a_s = _pick(w, s), _pick(assign, s)
        one, one_mass = ref.agg_blend_ref(x[s], ws, mask[s], a_s, R, prev[s])
        assert torch.equal(got[s], one) and torch.equal(mass[s], one_mass)
        assert torch.equal(got_cloud[s],
                           ref.cloud_blend_ref(prev[s], rmass[s], cloud[s]))
        one_abs = ref.agg_absorb_ref(
            [(xx[s], ww[s] if ww.dim() == 2 else ww) for xx, ww in arrivals],
            a_s, R, prev[s], bm[s], keep=0.5)
        for g_, o_ in zip(got_abs, one_abs):
            assert torch.equal(g_[s], o_)
        torch.testing.assert_close(
            got_mm[s], ref.weighted_agg_matmul_ref(W[s], x[s]), **F32)
        num, m = scatter_accumulate(x[s], (w * mask)[s], a_s, R)
        assert torch.equal(got_num[s], num) and torch.equal(got_m[s], m)
        torch.testing.assert_close(got_cagg[s],
                                   ref.cloud_agg_ref(prev[s], rmass[s]),
                                   **F32)
    assert torch.equal(got_cloud[1], cloud[1])     # zero mass keeps it


def test_sweep_update_ref_is_per_scenario_ref():
    """dual_proximal_sgd over S*A rows with the cloud anchor one row a
    scenario and per-scenario lr / mu1 / mu2 equals S one-scenario calls,
    through the CPU route (in place) as through the plain version."""
    from repro_torch.kernels import ref
    S, A, N = 3, 5, 257
    rng = np.random.default_rng(9)
    w, g, a1 = (torch.from_numpy(rng.standard_normal((S * A, N))
                                 .astype(np.float32)) for _ in range(3))
    a2 = torch.from_numpy(rng.standard_normal((S, N)).astype(np.float32))
    lr = torch.tensor([0.1, 0.05, 0.2])
    mu1 = torch.tensor([0.0, 0.01, 0.004])
    active = torch.from_numpy(rng.integers(0, 4, S * A).astype(np.int32))
    kw = dict(mu2=0.005, active_steps=active, step=1)
    got = ref.dual_proximal_sgd_ref(w, g, a1, a2, lr=lr, mu1=mu1, **kw)
    w_in = w.clone()
    assert ops.dual_proximal_sgd(w_in, g, a1, a2, lr=lr, mu1=mu1, out=w_in,
                                 **kw) is w_in
    assert torch.equal(w_in, got)
    for s in range(S):
        rows = slice(s * A, (s + 1) * A)
        one = ref.dual_proximal_sgd_ref(
            w[rows], g[rows], a1[rows], a2[s], lr=float(lr[s]),
            mu1=float(mu1[s]), mu2=0.005, active_steps=active[rows], step=1)
        assert torch.equal(got[rows], one)
