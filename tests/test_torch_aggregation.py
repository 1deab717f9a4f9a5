"""The port's weighting algebra against ``repro.core.aggregation`` (empty
cohorts included), and its torch-Generator heterogeneity draws checked
statistically (they cannot equal JAX's threefry draws bitwise).

Algebra tolerance 1e-6: the same fp32 sums over at most a few dozen
agents, taken in another order.  Draw tolerances: five binomial standard
deviations, so a correct sampler fails with probability < 1e-6."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg

from repro_torch.core import aggregation as tagg
from repro_torch.core.heterogeneity import (HeterogeneityModel,
                                            init_conn_state, sample_epochs,
                                            step_connectivity)
from repro_torch.fedsim.simulator import round_draws
from repro_torch.core.h2fed import H2FedParams


def _inputs(seed, A=12, R=4, empty_rsu=True):
    rng = np.random.default_rng(seed)
    w = rng.uniform(1, 5, A).astype(np.float32)
    mask = rng.integers(0, 2, A).astype(np.float32)
    assign = rng.integers(0, R, A).astype(np.int32)
    if empty_rsu:
        mask[assign == 0] = 0.0          # RSU 0 has an empty cohort
    return w, mask, assign, R


def _t(*arrs):
    return [torch.from_numpy(a).long() if a.dtype == np.int32
            else torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_weight_matrices_match(seed):
    w, mask, assign, R = _inputs(seed)
    tw, tm, ta = _t(w, mask, assign)
    for fn in ("unnormalized_weight_matrix", "build_weight_matrix",
               "cohort_mass"):
        got = getattr(tagg, fn)(tw, tm, ta, R).numpy()
        want = np.asarray(getattr(jagg, fn)(jnp.asarray(w), jnp.asarray(mask),
                                            jnp.asarray(assign), R))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    W = tagg.build_weight_matrix(tw, tm, ta, R)
    mass = tagg.cohort_mass(tw, tm, ta, R)
    assert float(mass[0]) == 0.0 and not W[0].any()
    live = mass > 0
    np.testing.assert_allclose(W[live].sum(1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("mask_all_zero", [False, True])
def test_normalized_weights_match(mask_all_zero):
    w, mask, _, _ = _inputs(5)
    if mask_all_zero:
        mask[:] = 0.0                    # uniform fallback on zero mass
    wn, mass = tagg.normalized_weights(*_t(w, mask))
    jwn, jmass = jagg.normalized_weights(jnp.asarray(w), jnp.asarray(mask))
    np.testing.assert_allclose(wn.numpy(), np.asarray(jwn), rtol=1e-6)
    np.testing.assert_allclose(float(mass), float(jmass), rtol=1e-6)


def test_normalize_blend_and_absorb_match():
    rng = np.random.default_rng(7)
    w, mask, assign, R = _inputs(3)
    x = rng.standard_normal((len(w), 33)).astype(np.float32)
    prev = rng.standard_normal((R, 33)).astype(np.float32)
    num, mass = tagg.scatter_accumulate(*_t(x, w * mask, assign), R)
    jnum, jmass = jagg.scatter_accumulate(jnp.asarray(x), jnp.asarray(w * mask),
                                          jnp.asarray(assign), R)
    np.testing.assert_allclose(num.numpy(), np.asarray(jnum), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(mass.numpy(), np.asarray(jmass), rtol=1e-6)
    got = tagg.normalize_blend(num, mass, torch.from_numpy(prev))
    want = jagg.normalize_blend(jnum, jmass, jnp.asarray(prev))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    bm = np.abs(rng.standard_normal(R)).astype(np.float32)
    got, tot = tagg.buffer_absorb(torch.from_numpy(prev), torch.from_numpy(bm),
                                  num, mass, keep=0.5)
    want, jtot = jagg.buffer_absorb(jnp.asarray(prev), jnp.asarray(bm), jnum,
                                    jmass, keep=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tot.numpy(), np.asarray(jtot), rtol=1e-6)


def _binom_ok(count, n, p):
    return abs(count - n * p) <= 5 * np.sqrt(n * p * (1 - p)) + 1e-9


@pytest.mark.parametrize("csr", [0.3, 0.7])
def test_connected_fraction_is_csr(csr):
    het = HeterogeneityModel(csr=csr, scd=1)
    gen = torch.Generator().manual_seed(0)
    state, A, rounds, hits = init_conn_state(200), 200, 50, 0
    for _ in range(rounds):
        state, conn = step_connectivity(gen, state, het)
        hits += int(conn.sum())
    assert _binom_ok(hits, A * rounds, csr)


def test_scd_holds_connections():
    """With scd=3 a connection lasts exactly 3 rounds before a re-draw."""
    het = HeterogeneityModel(csr=1.0, scd=3)
    gen = torch.Generator().manual_seed(1)
    state = init_conn_state(5)
    for _ in range(7):
        state, conn = step_connectivity(gen, state, het)
        assert bool(conn.all())
        assert 1 <= int(state.remaining.min()) <= 3


def test_fsr_epoch_distribution():
    """P(full E) = fsr; otherwise uniform on {0, ..., E-1}."""
    fsr, E, n = 0.4, 3, 20_000
    het = HeterogeneityModel(fsr=fsr)
    ep = sample_epochs(torch.Generator().manual_seed(2), n, het, E).numpy()
    assert set(np.unique(ep)) <= {0, 1, 2, 3}
    p_partial = (1 - fsr) / E
    assert _binom_ok(int((ep == E).sum()), n, fsr)
    for e in range(E):
        assert _binom_ok(int((ep == e).sum()), n, p_partial)


def test_round_draws_mask_rule():
    """mask = connected & (epochs*spe > 0), as the reference's round_draws."""
    het = HeterogeneityModel(csr=0.5, fsr=0.5)
    hp = H2FedParams(local_epochs=1)
    gen = torch.Generator().manual_seed(3)
    conn, mask, act = round_draws(gen, init_conn_state(500), het, hp, 500, 4)
    assert act.dtype == torch.int32 and set(act.unique().tolist()) <= {0, 4}
    assert torch.equal(mask, (conn.remaining > 0) & (act > 0))
    assert _binom_ok(int(mask.sum()), 500, 0.25)
