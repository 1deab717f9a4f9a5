"""The port's fault injection against the JAX package's, on the CPU.

A plan lowers to the same per-tick masks in both packages (numpy's
``default_rng`` with the same seeds), so the schedules are held bit for
bit.  The flat and async rounds under a plan run with the reference's
draws injected, from the same weights; quarantine counts are exact,
blocked masses and buffers within the fp32 tolerance of the round
parity tests (2e-5).  The port's empty plan must give ``faults=None``'s
result bit for bit on both engines.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import faults as jfaults
from repro.core import flatten as jflatten
from repro.core.h2fed import H2FedParams as JHP
from repro.core.heterogeneity import HeterogeneityModel as JHet
from repro.fedsim import simulator as jsim

from repro_torch import convert
from repro_torch.core import aggregation as tagg
from repro_torch.core import faults as tfaults
from repro_torch.core import flatten as tflatten
from repro_torch.core.faults import (ChurnWindow, CorruptSpec, FaultPlan,
                                     RsuOutage)
from repro_torch.core.h2fed import H2FedParams
from repro_torch.core.heterogeneity import HeterogeneityModel
from repro_torch.core.scenario import ScenarioSpec as TSpec
from repro_torch.fedsim import simulator as tsim
from repro_torch.fedsim.sweep import run_scenario

from test_torch_async import (A, BATCH, HET, HP, LAR, R, SEED, STATE_FIELDS,
                              assert_states_match, build_pair, close,
                              jax_async_draws, port_params)
from test_torch_async import setup  # noqa: F401  (the module fixture)

BASE = dict(n_agents=8, n_rsus=4, batch=8, n_train=400, n_test=100,
            rounds=2)
# every fault kind, an outage that recovers on the run's last tick, and a
# norm clip that catches the scaled payloads
PLAN = FaultPlan(
    churn=(ChurnWindow(frac=0.25, start=1, stop=3, seed=1),),
    outages=(RsuOutage(rsu=1, start=1, stop=3),),
    corrupt=(CorruptSpec(kind="nan", frac=0.2),
             CorruptSpec(kind="inf", frac=0.15, seed=1),
             CorruptSpec(kind="scale", frac=0.2, scale=1e4, seed=2),
             CorruptSpec(kind="stale", frac=0.25, seed=3)),
    norm_clip=50.0, seed=4)
PLANS = {
    "empty": FaultPlan(),
    "every_kind": PLAN,
    "dark_forever": FaultPlan(
        churn=(ChurnWindow(frac=0.5),),
        outages=(RsuOutage(rsu=0, start=2), RsuOutage(rsu=9, start=0)),
        corrupt=(CorruptSpec(kind="inf", frac=1.0, start=3, stop=5),),
        guard_nonfinite=False, seed=9),
}



@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread for this module: its tensors are small,
    and torch's waiting pool threads would otherwise compete with JAX's
    for the cores when test files run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def jax_plan(plan: FaultPlan):
    return jfaults.FaultPlan.from_dict(plan.to_dict())


@pytest.mark.parametrize("name", list(PLANS))
def test_lower_matches_reference(name):
    plan = PLANS[name]
    got, want = plan.lower(8, 4, 7), jax_plan(plan).lower(8, 4, 7)
    for k in tfaults.FAULT_FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    for t in (0, 3, 99):
        for k, v in got.tick_slice(t).items():
            np.testing.assert_array_equal(v, want.tick_slice(t)[k])
    for k, v in got.round_slice(3, 2).items():
        np.testing.assert_array_equal(v, want.round_slice(3, 2)[k])
    for k, v in got.stacked_rounds(3, 2).items():
        np.testing.assert_array_equal(v, want.stacked_rounds(3, 2)[k])
    np.testing.assert_array_equal(
        tfaults.FaultSchedule.benign(8, 4, 3).agent_up, np.ones((3, 8)))
    assert plan.static_fingerprint == jax_plan(plan).static_fingerprint
    assert plan.injects == jax_plan(plan).injects
    assert plan.corrupts == jax_plan(plan).corrupts


def test_plan_round_trip_and_cache_key():
    """to_dict / from_dict round trip, the spec's JSON round trip, and the
    reference's cache key for a spec with a plan."""
    from repro.core.scenario import ScenarioSpec as JSpec
    assert FaultPlan.from_dict(PLAN.to_dict()) == PLAN
    assert PLAN.to_dict() == jax_plan(PLAN).to_dict()
    spec = TSpec(n_agents=6, n_rsus=2, rounds=2, engine="async",
                 faults=PLAN)
    assert TSpec.from_json(spec.to_json()) == spec
    jspec = JSpec(n_agents=6, n_rsus=2, rounds=2, engine="async",
                  faults=jax_plan(PLAN))
    assert spec.cache_key == jspec.cache_key
    assert spec.replace(faults=None).cache_key != spec.cache_key
    with pytest.raises(ValueError, match="unknown FaultPlan"):
        FaultPlan.from_dict({"bogus": 1})


@pytest.mark.parametrize("bad", [
    dict(churn=(ChurnWindow(frac=1.5),)),
    dict(outages=(RsuOutage(rsu=4),)),
    dict(corrupt=(CorruptSpec(kind="zero", frac=0.1),)),
    dict(dup_frac=1.0), dict(norm_clip=-1.0)])
def test_invalid_plans_refuse(bad):
    with pytest.raises(ValueError):
        TSpec(n_agents=8, n_rsus=4, faults=FaultPlan(**bad)).validate()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm_clip", [0.0, 5.0])
def test_corruption_and_screen_match_reference(dtype, norm_clip):
    """apply_corruption then screen_updates against the reference's: NaN
    and Inf poison survive the cast to bf16 and are scrubbed back to the
    start rows; scaled rows trip the clip."""
    rng = np.random.default_rng(0)
    n_a, n = 40, 64
    f = PLAN.lower(n_a, 4, 3).tick_slice(1)
    assert f["poison_mask"].any() and (f["scale"] > 1).any()
    assert f["stale"].any()
    start = rng.standard_normal((n_a, n)).astype(np.float32)
    trained = start + 0.1 * rng.standard_normal((n_a, n)).astype(np.float32)
    prev = rng.standard_normal((n_a, n)).astype(np.float32)
    w = (rng.random(n_a) < 0.7).astype(np.float32)
    tdt = getattr(torch, dtype)
    t = [torch.from_numpy(a).to(tdt) for a in (trained, prev, start)]
    got = tfaults.apply_corruption(t[0], t[1], {
        k: torch.from_numpy(v) for k, v in f.items()})
    j = [jax.numpy.asarray(a).astype(dtype) for a in (trained, prev, start)]
    want = jfaults.apply_corruption(j[0], j[1], f)
    np.testing.assert_array_equal(convert.tensor_to_numpy(got),
                                  np.asarray(want, np.float32))
    assert not torch.isfinite(got.float()).all()
    clean, okf, nq = tagg.screen_updates(got, t[2], torch.from_numpy(w),
                                         norm_clip=norm_clip)
    jclean, jokf, jnq = jagg.screen_updates(want, j[2], w,
                                            norm_clip=norm_clip)
    np.testing.assert_array_equal(convert.tensor_to_numpy(clean),
                                  np.asarray(jclean, np.float32))
    np.testing.assert_array_equal(okf.numpy(), np.asarray(jokf))
    assert int(nq) == int(jnq) > 0
    assert torch.isfinite(clean.float()).all()
    if norm_clip:
        assert okf[torch.from_numpy(f["scale"] > 1)].eq(0).all()


def _fault_r(sched, r, lar):
    return sched.round_slice(r, lar), tfaults.round_tensors(sched, r, lar,
                                                            "cpu")


@pytest.mark.parametrize("fused", [True, False])
def test_flat_round_faults_parity(setup, fused):  # noqa: F811
    jfed, tfed, jparams = setup
    jcfg = jsim.SimConfig(n_agents=A, n_rsus=R, batch=BATCH, seed=SEED)
    jhp, jhet = JHP(**HP), JHet(**HET)
    jspec = jflatten.spec_of(jparams)
    jstate = jsim.init_flat_state(jcfg, jspec, jparams, jax.random.key(SEED))
    jround = jsim.make_flat_global_round(jcfg, jhp, jhet, jfed, jspec,
                                         fused=fused, faults=jax_plan(PLAN))
    cfg = tsim.SimConfig(n_agents=A, n_rsus=R, batch=BATCH, seed=SEED)
    tparams = port_params(jparams)
    spec = tflatten.spec_of(tparams)
    state = tsim.init_flat_state(cfg, spec, tparams, "cpu")
    body = tsim._make_flat_round_body(
        cfg, H2FedParams(**HP), HeterogeneityModel(**HET), tfed, spec,
        device="cpu", fused=fused, faults=PLAN)
    draws = [[(m, a) for m, a, _ in rd] for rd in
             jax_async_draws(jcfg, jhp, jhet, jfed, 2, jax.random.key(SEED))]
    sched = PLAN.lower(A, R, 2 * LAR)
    quarantined = 0
    for r in range(2):
        jf, tf = _fault_r(sched, r, LAR)
        jstate, jm = jround(jstate, jf)
        state, m = body(state, draws[r], tf)
        assert int(m["quarantined"]) == int(jm["quarantined"])
        quarantined += int(m["quarantined"])
    assert quarantined > 0
    for name in ("agent_flat", "rsu_flat", "cloud_flat"):
        close(getattr(state, name), getattr(jstate, name), "float32")
    assert torch.isfinite(state.agent_flat).all()


@pytest.mark.parametrize("fused", [True, False])
def test_async_round_faults_parity(setup, fused):  # noqa: F811
    """Stragglers under every fault kind, an outage with recovery and a
    cadence of 3: buffers, quarantine counts and blocked mass."""
    het_kw = dict(max_delay=2, delay_p=0.6)
    acfg_kw = dict(staleness_decay=0.5, buffer_keep=0.4, cloud_every=3)
    (jstate, jround), (state, body), draws = build_pair(
        setup, het_kw, acfg_kw, "float32", fused, faults=PLAN,
        jfaults=jax_plan(PLAN))
    sched = PLAN.lower(A, R, 2 * LAR)
    blocked = 0.0
    for r in range(2):
        jf, tf = _fault_r(sched, r, LAR)
        jstate, jm = jround(jstate, jf)
        state, m = body(state, draws[r], tf)
        assert set(m) == set(jm)
        np.testing.assert_array_equal(m["quarantined"].numpy(),
                                      np.asarray(jm["quarantined"]))
        for k in m:
            close(m[k], jm[k], "float32")
        blocked += float(m["blocked_mass"].sum())
    assert blocked > 0
    assert_states_match(state, jstate, "float32")
    for name in STATE_FIELDS:
        assert torch.isfinite(getattr(state, name).float()).all(), name


@pytest.mark.parametrize("engine", ["flat", "async"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_empty_plan_bit_identical(engine, dtype):
    """An empty plan runs the fault branches on benign masks: the result
    equals faults=None's bit for bit, with nothing quarantined."""
    kw = dict(BASE, engine=engine, fleet_dtype=dtype)
    if engine == "async":
        kw.update(het=HeterogeneityModel(csr=0.8, max_delay=2, delay_p=0.5),
                  staleness_decay=0.5, buffer_keep=0.5)
    clean_st, clean_h = run_scenario(TSpec(**kw), device="cpu")
    f_st, f_h = run_scenario(TSpec(**kw, faults=FaultPlan()), device="cpu")
    if engine == "flat":
        pairs = [(clean_st.cloud_params[k], f_st.cloud_params[k])
                 for k in clean_st.cloud_params]
        pairs += [(clean_st.agent_params[k], f_st.agent_params[k])
                  for k in clean_st.agent_params]
    else:
        pairs = [(getattr(clean_st, k), getattr(f_st, k))
                 for k in STATE_FIELDS]
        assert np.all(f_h["blocked_mass"] == 0)
    for a, b in pairs:
        assert torch.equal(a, b)
    np.testing.assert_array_equal(clean_h["acc"], f_h["acc"])
    assert np.all(f_h["quarantined"] == 0)


@pytest.mark.parametrize("engine", ["flat", "async"])
def test_guard_keeps_poison_out(engine):
    """Every update NaN every tick: all of it quarantined and the cloud
    never moves; with the screen off the poison reaches the fleet."""
    plan = FaultPlan(corrupt=(CorruptSpec(kind="nan", frac=1.0),))
    st, hist = run_scenario(TSpec(**BASE, engine=engine, faults=plan),
                            device="cpu")
    assert all(q > 0 for q in hist["quarantined"])
    assert len(set(hist["acc"].tolist())) == 1
    cloud = (st.cloud_flat if engine == "async" else
             torch.cat([v.flatten() for v in st.cloud_params.values()]))
    assert torch.isfinite(cloud).all()
    st, _ = run_scenario(TSpec(**BASE, engine=engine, faults=dataclasses.
                               replace(plan, guard_nonfinite=False)),
                         device="cpu")
    agents = (st.agent_flat if engine == "async" else
              torch.cat([v.flatten() for v in st.agent_params.values()]))
    assert not torch.isfinite(agents).all()


def test_run_scenario_history_parity():
    """run_scenario with a plan on the async engine, both packages, the
    reference's draws injected: every history key."""
    from repro.core.scenario import ScenarioSpec as JSpec
    from repro.fedsim.sweep import run_scenario as j_run
    from repro.models import mlp as jmlp
    from repro.configs.mnist_mlp import CONFIG as JCONFIG
    plan = dataclasses.replace(PLAN, outages=(RsuOutage(rsu=1, start=2,
                                                        stop=4),))
    kw = dict(n_agents=A, n_rsus=R, batch=BATCH, n_train=1500, n_test=400,
              pretrain_frac=0.2, rounds=3, seed=1, sim_seed=2,
              engine="async", staleness_decay=0.5, buffer_keep=0.4)
    het = dict(HET, max_delay=2, delay_p=0.6)
    jspec = JSpec(hp=JHP(**HP), het=JHet(**het), faults=jax_plan(plan), **kw)
    tspec = TSpec(hp=H2FedParams(**HP), het=HeterogeneityModel(**het),
                  faults=plan, **kw)
    jres = jspec.resolve()
    jparams = jmlp.init_params(JCONFIG, jax.random.key(11))
    _, jhist = j_run(jres, jparams)
    draws = jax_async_draws(jres.cfg, jspec.hp, jspec.het, jres.fed,
                            kw["rounds"])
    _, thist = run_scenario(tspec, port_params(jparams), device="cpu",
                            draws=draws)
    assert set(thist) == set(jhist)
    np.testing.assert_array_equal(thist["round"], jhist["round"])
    np.testing.assert_array_equal(thist["quarantined"], jhist["quarantined"])
    np.testing.assert_allclose(thist["acc"], jhist["acc"], atol=2e-3)
    for k in ("absorbed_mass", "pending_mass", "blocked_mass"):
        np.testing.assert_allclose(thist[k], jhist[k], rtol=1e-5)
    assert thist["blocked_mass"].sum() > 0 and thist["quarantined"].sum() > 0
