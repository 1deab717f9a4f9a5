"""The port's semi-async engine against the JAX package's, on the CPU.

The reference's own per-tick draws (connectivity and FSR from
``round_draws`` on the round's keys, latency from ``sample_latency`` on
``fold_in(key, 7)``, connectivity carried across ticks and rounds) are
injected into the port through its draws seam; both packages start from
the same weights and the same numpy-built data.  With a bf16 fleet the
reference's aggregation entries go to its Pallas kernels in interpret
mode, which keep the weights in fp32 as the port does.

Tolerances: fp32 buffers and masses 2e-5 absolute / relative (the
packages sum gradients and aggregations in different orders; the flat
round's tolerance); bf16 buffers one bf16 ulp of the stored value (2**-7
relative plus 2**-9 absolute); in-flight tick counts exact; accuracy
histories 2e-3.  A bf16 tick is held to the reference's tick from the
reference's state (see ``from_reference``).  The within-package anchors
hold the port to itself.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs.mnist_mlp import CONFIG as JCONFIG
from repro.core import aggregation as jagg
from repro.core import flatten as jflatten
from repro.core.h2fed import H2FedParams as JHP
from repro.core.heterogeneity import HeterogeneityModel as JHet
from repro.core.heterogeneity import init_conn_state as j_init_conn
from repro.core.heterogeneity import sample_latency as j_sample_latency
from repro.data.partition import scenario_two as j_scenario_two
from repro.data.synthetic import mnist_class_task as j_task
from repro.fedsim import async_engine as jae
from repro.fedsim import simulator as jsim
from repro.kernels import masked_hier_agg as jmha
from repro.kernels import ops as jops
from repro.models import mlp as jmlp

from repro_torch import convert
from repro_torch.core import aggregation as tagg
from repro_torch.core import flatten as tflatten
from repro_torch.core.h2fed import H2FedParams
from repro_torch.core.heterogeneity import HeterogeneityModel, sample_latency
from repro_torch.core.scenario import ScenarioSpec as TSpec
from repro_torch.data.partition import scenario_two
from repro_torch.data.synthetic import mnist_class_task
from repro_torch.fedsim import async_engine as tae
from repro_torch.fedsim import simulator as tsim
from repro_torch.fedsim.sweep import run_scenario
from repro_torch.kernels import ops as tops

A, R, LAR, BATCH, SEED = 8, 2, 2, 16, 3
HP = dict(mu1=0.01, mu2=0.005, lar=LAR, local_epochs=2, lr=0.1)
HET = dict(csr=0.6, scd=2, fsr=0.6, lar=LAR)
SYNC_LIMIT = dict(staleness_decay=1.0, buffer_keep=0.0, cloud_every=0)
# (het extras, AsyncConfig): the sync limit, stragglers with decay and
# keep, a cloud cadence that fires mid-round, per-RSU decay and keep
CONFIGS = {
    "sync_limit": ({}, SYNC_LIMIT),
    "stragglers": (dict(max_delay=2, delay_p=0.6),
                   dict(staleness_decay=0.5, buffer_keep=0.4)),
    "cloud_every_3": (dict(max_delay=2, delay_p=0.5),
                      dict(staleness_decay=0.5, buffer_keep=0.4,
                           cloud_every=3)),
    "per_rsu": (dict(max_delay=2, delay_p=0.6),
                dict(staleness_decay=(0.9, 0.3), buffer_keep=(0.2, 0.6))),
}
STATE_FIELDS = ("agent_flat", "rsu_flat", "rsu_mass", "cloud_flat",
                "pending_x", "pending_w", "pending_t", "cloud_macc")
FLEET_FIELDS = ("agent_flat", "rsu_flat", "pending_x")



@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread for this module: its tensors are small,
    and torch's waiting pool threads would otherwise compete with JAX's
    for the cores when test files run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def setup():
    j_train, _ = j_task(n_train=1200, n_test=200, seed=0)
    t_train, _ = mnist_class_task(n_train=1200, n_test=200, seed=0)
    jfed = j_scenario_two(j_train, n_agents=A, n_rsus=R, seed=0)
    tfed = scenario_two(t_train, n_agents=A, n_rsus=R, seed=0)
    jparams = jmlp.init_params(JCONFIG, jax.random.key(7))
    return jfed, tfed, jparams


def jax_async_draws(cfg, hp, het, fed, n_rounds, key=None):
    """The reference's per-tick draws in the async round's key discipline,
    as torch tensors: draws[round][tick] = (mask, active_steps, delays)."""
    spe = max(fed.x.shape[1] // cfg.batch, 1)
    rng = jax.random.key(cfg.seed) if key is None else key
    conn, out = j_init_conn(cfg.n_agents), []
    for _ in range(n_rounds):
        rng, k_rounds = jax.random.split(rng)
        keys = jsim.round_keys(k_rounds, hp.lar)
        rd = []
        for i in range(hp.lar):
            conn, mask, act = jsim.round_draws(keys[i], conn, het, hp,
                                               cfg.n_agents, spe)
            delays = j_sample_latency(
                jax.random.fold_in(keys[i], jae._LATENCY_FOLD),
                cfg.n_agents, het)
            rd.append(tuple(torch.from_numpy(np.array(t))
                            for t in (mask, act, delays)))
        out.append(rd)
    return out


def pallas_routes(monkeypatch):
    """Send the reference's aggregation entries to its Pallas kernels in
    interpret mode: off-TPU its bf16 routes cast W to the fleet dtype, the
    kernels (and the port) keep it fp32."""
    for name in ("agg_blend", "agg_absorb", "cloud_blend",
                 "weighted_agg_matmul"):
        kernel = getattr(jmha, name)
        monkeypatch.setattr(jops, name, lambda *a, _k=kernel, **kw: _k(
            *a, interpret=True, **kw))
    monkeypatch.setattr(jops, "masked_scatter_accumulate",
                        lambda *a: jmha.scatter_accumulate(*a,
                                                           interpret=True))


def close(got, want, dtype, exact=False):
    got = convert.tensor_to_numpy(got) if torch.is_tensor(got) else got
    want = np.asarray(want)
    if exact:
        np.testing.assert_array_equal(got, want)
    elif dtype == "float32":
        np.testing.assert_allclose(got, want.astype(np.float32), rtol=2e-5,
                                   atol=2e-5)
    else:
        np.testing.assert_allclose(got, want.astype(np.float32),
                                   rtol=2 ** -7, atol=2 ** -9)


def port_params(jparams):
    return convert.params_from_jax({k: np.asarray(v)
                                    for k, v in jparams.items()})


def build_pair(setup, het_kw, acfg_kw, dtype, fused, faults=None,
               jfaults=None, lar=LAR, n_rounds=2):
    """Both packages' async round, initial state and the reference's draws
    on the same config."""
    jfed, tfed, jparams = setup
    jcfg = jsim.SimConfig(n_agents=A, n_rsus=R, batch=BATCH, seed=SEED)
    hp_kw, het_kw = dict(HP, lar=lar), dict(HET, lar=lar, **het_kw)
    jhp, jhet = JHP(**hp_kw), JHet(**het_kw)
    jspec = jflatten.spec_of(jparams, storage_dtype=dtype)
    jstate = jae.init_async_state(jcfg, jspec, jparams,
                                  jax.random.key(SEED))
    jround = jae.make_async_global_round(
        jcfg, jhp, jhet, jfed, jspec, jae.AsyncConfig(**acfg_kw),
        fused=fused, faults=jfaults)
    cfg = tsim.SimConfig(n_agents=A, n_rsus=R, batch=BATCH, seed=SEED)
    tparams = port_params(jparams)
    spec = tflatten.spec_of(tparams, storage_dtype=dtype)
    state = tae.init_async_state(cfg, spec, tparams, "cpu")
    body = tae.make_async_global_round(
        cfg, H2FedParams(**hp_kw), HeterogeneityModel(**het_kw), tfed,
        spec, tae.AsyncConfig(**acfg_kw), device="cpu", fused=fused,
        faults=faults)
    draws = jax_async_draws(jcfg, jhp, jhet, jfed, n_rounds,
                            jax.random.key(SEED))
    return (jstate, jround), (state, body), draws


def from_reference(state, jstate):
    """The port's state with the reference's buffers and tick.  Each bf16
    tick starts from the reference's state: a one-ulp difference in a
    stored RSU row (the two packages sum in different orders, so an
    element near a rounding midpoint may round either way) can flip a
    hidden ReLU unit of an agent that trains from it on the next tick, and
    that unit's weights then differ by several ulps."""
    return state._replace(tick=int(jstate.tick), **{
        f: convert.tensor_from_numpy(np.asarray(getattr(jstate, f)))
        for f in STATE_FIELDS})


def assert_states_match(state, jstate, dtype):
    for name in STATE_FIELDS:
        got, want = getattr(state, name), getattr(jstate, name)
        if name == "pending_t":
            close(got, want, dtype, exact=True)
        elif name in FLEET_FIELDS or (name == "cloud_flat"
                                      and dtype != "float32"):
            close(got, want, dtype)
        else:
            close(got, want, "float32")
    assert state.tick == int(jstate.tick)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_async_round_parity(setup, monkeypatch, config, fused, dtype):
    if dtype == "bfloat16":
        pallas_routes(monkeypatch)
    het_kw, acfg_kw = CONFIGS[config]
    # fp32: two rounds of two ticks; bf16: four rounds of one tick, each
    # from the reference's state
    bf16 = dtype == "bfloat16"
    lar, n_rounds = (1, 4) if bf16 else (LAR, 2)
    (jstate, jround), (state, body), draws = build_pair(
        setup, het_kw, acfg_kw, dtype, fused, lar=lar, n_rounds=n_rounds)
    for r in range(n_rounds):
        if bf16 and r:
            state = from_reference(state, jstate)
        jstate, jm = jround(jstate)
        state, m = body(state, draws[r])
        assert set(m) == set(jm)
        for k in m:
            close(m[k], jm[k], "float32")
    assert state.agent_flat.dtype == state.pending_x.dtype == \
        tflatten.spec_of(port_params(setup[2]), storage_dtype=dtype
                         ).storage_dtype
    assert_states_match(state, jstate, dtype)
    if config != "sync_limit":
        # the draws must leave updates in flight and deliver some late
        assert any(int((d > 0).sum()) for rd in draws for _, _, d in rd)


def _sync_limit_specs(**kw):
    common = dict(n_agents=A, n_rsus=R, batch=BATCH, n_train=1200,
                  n_test=200, pretrain_frac=0.2, rounds=2, seed=1,
                  sim_seed=2, hp=H2FedParams(**HP),
                  het=HeterogeneityModel(**HET), **kw)
    return (TSpec(engine="flat", **common),
            TSpec(engine="async", **SYNC_LIMIT, **common))


@pytest.mark.parametrize("injected", [True, False])
def test_sync_limit_equals_flat(setup, injected):
    """Zero latency, no decay, keep 0, the per-round cadence: the async
    engine computes what the flat engine computes from the same draws
    (with the port's own draws too: a zero latency draws nothing)."""
    flat_spec, async_spec = _sync_limit_specs()
    res = flat_spec.resolve()
    tparams = port_params(setup[2])
    adraws = fdraws = None
    if injected:
        adraws = jax_async_draws(res.cfg, JHP(**HP), JHet(**HET), res.fed, 2)
        fdraws = [[(m, a) for m, a, _ in rd] for rd in adraws]
    sf, hf = run_scenario(res, tparams, device="cpu", draws=fdraws)
    sa, ha = run_scenario(async_spec.resolve(), tparams, device="cpu",
                          draws=adraws)
    np.testing.assert_allclose(ha["acc"], hf["acc"], atol=2e-3)
    spec = tflatten.spec_of(tparams)
    for want, got in ((spec.ravel(sf.cloud_params), sa.cloud_flat),
                      (spec.ravel_stacked(sf.agent_params), sa.agent_flat),
                      (spec.ravel_stacked(sf.rsu_params), sa.rsu_flat)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert float(sa.pending_w.sum()) == 0.0 and ha["pending_mass"].sum() == 0


def _port_rounds(setup, het_kw, acfg_kw, n_rounds, fused=True):
    """The port's own draws: per-round metrics as numpy."""
    _, tfed, jparams = setup
    cfg = tsim.SimConfig(n_agents=A, n_rsus=R, batch=BATCH, seed=SEED)
    tparams = port_params(jparams)
    spec = tflatten.spec_of(tparams)
    het = HeterogeneityModel(**dict(HET, **het_kw))
    body = tae.make_async_global_round(
        cfg, H2FedParams(**HP), het, tfed, spec, tae.AsyncConfig(**acfg_kw),
        device="cpu", fused=fused)
    state = tae.init_async_state(cfg, spec, tparams, "cpu")
    rounds = []
    for _ in range(n_rounds):
        state, m = body(state)
        rounds.append({k: v.numpy() for k, v in m.items()})
    return state, rounds


@pytest.mark.parametrize("fused", [True, False])
def test_cohort_mass_conservation(setup, fused):
    """Every enqueued weight is absorbed once or still pending: sum
    enqueued - sum due == pending at the end, and per tick absorbed ==
    immediate + due."""
    state, rounds = _port_rounds(
        setup, dict(csr=0.8, max_delay=3, delay_p=0.6),
        dict(staleness_decay=0.5, buffer_keep=0.4), 4, fused)
    enq = sum(r["enqueued_mass"].sum() for r in rounds)
    due = sum(r["due_mass"].sum() for r in rounds)
    np.testing.assert_allclose(enq - due, rounds[-1]["pending_mass"],
                               rtol=1e-5)
    for r in rounds:
        np.testing.assert_allclose(r["absorbed_mass"].sum(axis=1),
                                   r["immediate_mass"] + r["due_mass"],
                                   rtol=1e-5)
    assert due > 0


def test_all_agents_stale(setup):
    """delay_p = 1 puts every arrival at max_delay: no tick sees a fresh
    update, yet the buffers absorb the stale cohort and stay finite."""
    state, rounds = _port_rounds(
        setup, dict(csr=1.0, fsr=1.0, max_delay=2, delay_p=1.0),
        dict(staleness_decay=0.5, buffer_keep=0.5), 3)
    for r in rounds:
        np.testing.assert_array_equal(r["immediate_mass"], 0.0)
    assert sum(r["due_mass"].sum() for r in rounds) > 0
    assert torch.isfinite(state.cloud_flat).all()
    assert torch.isfinite(state.rsu_flat).all()


def test_decay_downweights_stragglers(setup):
    """Every arrival two ticks late: decay 0.25 absorbs 0.25**2 of the
    straggler mass that decay 1.0 absorbs."""
    het = dict(csr=1.0, fsr=1.0, max_delay=2, delay_p=1.0)
    _, soft = _port_rounds(setup, het, dict(staleness_decay=1.0), 2)
    _, hard = _port_rounds(setup, het, dict(staleness_decay=0.25), 2)
    m_soft = sum(r["due_mass"].sum() for r in soft)
    m_hard = sum(r["due_mass"].sum() for r in hard)
    assert 0 < m_hard < m_soft
    np.testing.assert_allclose(m_hard, m_soft * 0.25 ** 2, rtol=1e-5)


@pytest.mark.parametrize("max_delay,p", [(3, 0.6), (2, 0.3), (1, 0.9)])
def test_sample_latency_statistics(max_delay, p):
    """A censored geometric: P(d = k) = (1-p) p**k below max_delay and
    p**max_delay on it, within 5 sigma of sampling error at 20,000
    agents; P(d = 0) == 1 - p."""
    n = 20_000
    het = HeterogeneityModel(max_delay=max_delay, delay_p=p)
    d = sample_latency(torch.Generator().manual_seed(0), n, het).numpy()
    assert d.dtype == np.int32 and d.min() >= 0 and d.max() <= max_delay
    want = [(1 - p) * p ** k for k in range(max_delay)] + [p ** max_delay]
    for k, pk in enumerate(want):
        sigma = (pk * (1 - pk) / n) ** 0.5
        assert abs((d == k).mean() - pk) <= 5 * sigma, (k, (d == k).mean(),
                                                        pk)


def test_sample_latency_limits():
    """The exact limits draw nothing and agree with the reference's."""
    key = jax.random.key(0)
    for kw, want in ((dict(), 0), (dict(max_delay=3, delay_p=0.0), 0),
                     (dict(max_delay=3, delay_p=1.0), 3)):
        gen = torch.Generator().manual_seed(1)
        d = sample_latency(gen, 16, HeterogeneityModel(**kw))
        np.testing.assert_array_equal(d.numpy(), want)
        np.testing.assert_array_equal(
            np.asarray(j_sample_latency(key, 16, JHet(**kw))), d.numpy())
        assert torch.equal(torch.rand(3, generator=gen),
                           torch.rand(3, generator=torch.Generator()
                                      .manual_seed(1)))


@pytest.mark.parametrize("schedule,decay", [
    ("exp", 0.5), ("exp", 1.0), ("poly", 0.7), ("poly", 0.0),
    ("exp", "vector"), ("poly", "vector")])
def test_staleness_weights_match_reference(schedule, decay):
    tau = np.array([0, 1, 2, 3, 5, 0, 2, 4], np.int32)
    if decay == "vector":
        decay = np.linspace(0.1, 0.9, tau.size).astype(np.float32)
        tdecay = torch.from_numpy(decay)
    else:
        tdecay = decay
    got = tagg.staleness_weights(torch.from_numpy(tau), decay=tdecay,
                                 schedule=schedule)
    want = jagg.staleness_weights(tau, decay=decay, schedule=schedule)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert float(got[0]) == 1.0
    with pytest.raises(ValueError):
        tagg.staleness_weights(torch.from_numpy(tau), schedule="nope")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_scatter_accumulate_matches_reference(dtype):
    """The CPU route of the scatter-accumulate against the reference's,
    num in fp32 whatever the fleet dtype."""
    rng = np.random.default_rng(0)
    n_a, n_r, n = 11, 3, 517
    x = rng.standard_normal((n_a, n)).astype(np.float32)
    w = (rng.uniform(0, 2, n_a) * (rng.random(n_a) < 0.7)).astype(np.float32)
    assign = rng.integers(0, n_r, n_a).astype(np.int32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    num, mass = tops.masked_scatter_accumulate(
        tx, torch.from_numpy(w), torch.from_numpy(assign).long(), n_r)
    jx = jax.numpy.asarray(tx.float().numpy()).astype(dtype)
    jnum, jmass = jagg.scatter_accumulate(jx, w, assign, n_r)
    assert num.dtype == torch.float32
    close(num, jnum, "float32")
    close(mass, jmass, "float32")


@pytest.mark.parametrize("fused", [True, False])
def test_run_scenario_history_parity(fused):
    """run_scenario end to end on both packages, the reference's draws
    injected: every history key and value."""
    from repro.core.scenario import ScenarioSpec as JSpec
    from repro.fedsim.sweep import run_scenario as j_run
    kw = dict(n_agents=A, n_rsus=R, batch=BATCH, n_train=1500, n_test=400,
              pretrain_frac=0.2, rounds=3, seed=1, sim_seed=2, fused=fused,
              engine="async", staleness_decay=0.5, buffer_keep=0.4)
    het = dict(HET, max_delay=2, delay_p=0.6)
    jspec = JSpec(hp=JHP(**HP), het=JHet(**het), **kw)
    tspec = TSpec(hp=H2FedParams(**HP), het=HeterogeneityModel(**het), **kw)
    jres = jspec.resolve()
    jparams = jmlp.init_params(JCONFIG, jax.random.key(11))
    _, jhist = j_run(jres, jparams)
    draws = jax_async_draws(jres.cfg, jspec.hp, jspec.het, jres.fed,
                            kw["rounds"])
    final, thist = run_scenario(tspec, port_params(jparams), device="cpu",
                                draws=draws)
    assert set(thist) == set(jhist) == {"round", "acc", "absorbed_mass",
                                        "pending_mass"}
    np.testing.assert_array_equal(thist["round"], jhist["round"])
    np.testing.assert_allclose(thist["acc"], jhist["acc"], atol=2e-3)
    for k in ("absorbed_mass", "pending_mass"):
        np.testing.assert_allclose(thist[k], jhist[k], rtol=1e-5)
    assert isinstance(final, tae.AsyncSimState) and final.tick == 3 * LAR
