"""The port's cohort-streamed rounds against the JAX package's, on the CPU.

The reference's streamed rounds draw inside the round (the flat round's
key discipline; the async tick's latency keys folded with
``_LATENCY_FOLD``); the same draws go into the port through its draws
seam, and with a fault plan the reference's lowered schedule goes in as
each round's ``fault_r``.  Both packages start from the same weights and
the same numpy-built data, and stream the same chunk grid (a padded tail
included).

Tolerances: fp32 buffers 1e-5 absolute / relative (the packages sum
gradients and chunks in different orders); accuracy histories 2e-3; tick
counts, quarantine counts and chunk plans exact.  Within the port the
streamed rounds sum a fleet in the resident engines' order on the host, so
streamed == resident holds at the reference's own tolerance (atol 3e-6)
and in fact bit for bit; the zero-fault anchor and device-chunked == host
-streamed hold bit for bit.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs.mnist_mlp import CONFIG as JCONFIG
from repro.core import flatten as jflatten
from repro.core.faults import FaultPlan as JPlan
from repro.core.h2fed import H2FedParams as JHP
from repro.core.heterogeneity import HeterogeneityModel as JHet
from repro.core.heterogeneity import init_conn_state as j_init_conn
from repro.core.heterogeneity import sample_latency as j_sample_latency
from repro.core.scenario import ScenarioSpec as JSpec
from repro.data.partition import scenario_two as j_scenario_two
from repro.data.synthetic import mnist_class_task as j_task
from repro.fedsim import async_engine as jae
from repro.fedsim import run_scenario as j_run_scenario
from repro.fedsim import simulator as jsim
from repro.fedsim import streaming as jstr
from repro.models import mlp as jmlp

from repro_torch import convert
from repro_torch.core import flatten as tflatten
from repro_torch.core.faults import ChurnWindow, CorruptSpec, FaultPlan
from repro_torch.core.faults import RsuOutage
from repro_torch.core.h2fed import H2FedParams
from repro_torch.core.heterogeneity import HeterogeneityModel
from repro_torch.core.scenario import ScenarioSpec as TSpec
from repro_torch.data.partition import scenario_two
from repro_torch.data.synthetic import mnist_class_task
from repro_torch.fedsim import async_engine as tae
from repro_torch.fedsim import run_scenario, run_scenarios
from repro_torch.fedsim import simulator as tsim
from repro_torch.fedsim import streaming as tstr

A, R, LAR, BATCH, SEED, CHUNK = 8, 2, 2, 16, 3, 3
HP = dict(mu1=0.01, mu2=0.005, lar=LAR, local_epochs=2, lr=0.1)
HET = dict(csr=0.6, scd=2, fsr=0.6, lar=LAR)
ASYNC_HET = dict(HET, max_delay=2, delay_p=0.5)
F32 = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=0, atol=3e-6)          # the reference's streamed == resident
# the small scenario of the reference's own streaming tests
BASE = dict(n_agents=16, n_rsus=4, batch=8, n_train=400, n_test=100,
            rounds=2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread (this module also runs JAX)."""
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
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    return jfed, tfed, jparams, tparams


def reference_draws(seed, hp, het, fed, n_rounds, latency=False):
    """The reference's draws in its streamed rounds' key discipline, as
    torch tensors: draws[round][local round] = (mask, active_steps[,
    delays])."""
    spe = max(fed.x.shape[1] // BATCH, 1)
    n = fed.x.shape[0]
    rng, conn, out = jax.random.key(seed), j_init_conn(n), []
    for _ in range(n_rounds):
        rng, k_rounds = jax.random.split(rng)
        keys = jsim.round_keys(k_rounds, hp.lar)
        rd = []
        for i in range(hp.lar):
            conn, mask, act = jsim.round_draws(keys[i], conn, het, hp, n, spe)
            ts = [mask, act]
            if latency:
                ts.append(j_sample_latency(jax.random.fold_in(
                    keys[i], jae._LATENCY_FOLD), n, het))
            rd.append(tuple(torch.from_numpy(np.array(t)) for t in ts))
        out.append(rd)
    return out


def _np(t) -> np.ndarray:
    if torch.is_tensor(t):
        return convert.tensor_to_numpy(t)
    return np.asarray(t, np.float32)


def churn_outage_plan():
    """Churn and an RSU outage that recovers mid-run: what the streamed
    rounds take (no corrupted payloads)."""
    return FaultPlan(churn=(ChurnWindow(frac=0.3, start=1, stop=3, seed=1),),
                     outages=(RsuOutage(rsu=1, start=1, stop=3),), seed=4)


def _builders(engine, setup, store="host", plan=None, chunk_params=0):
    """(reference round, reference state, port round, port state) for one
    streamed engine on the module's fleet."""
    jfed, tfed, jparams, tparams = setup
    jcfg = jsim.SimConfig(n_agents=A, n_rsus=R, batch=BATCH, seed=SEED)
    tcfg = tsim.SimConfig(n_agents=A, n_rsus=R, batch=BATCH, seed=SEED)
    jhp, thp = JHP(**HP), H2FedParams(**HP)
    hk = ASYNC_HET if engine == "async" else HET
    jhet, thet = JHet(**hk), HeterogeneityModel(**hk)
    jspec, tspec = jflatten.spec_of(jparams), tflatten.spec_of(tparams)
    jplan = None if plan is None else JPlan.from_dict(plan.to_dict())
    key = jax.random.key(SEED)
    if engine == "async":
        kw = dict(staleness_decay=0.5, buffer_keep=0.4)
        jround = jstr.make_streamed_async_round(
            jcfg, jhp, jhet, jfed, jspec, jae.AsyncConfig(**kw),
            chunk_agents=CHUNK, faults=jplan)
        jstate = jstr.init_async_stream_state(jcfg, jspec, jparams, key,
                                              fleet_store=store)
        tround = tstr.make_streamed_async_round(
            tcfg, thp, thet, tfed, tspec, tae.AsyncConfig(**kw),
            device="cpu", chunk_agents=CHUNK, faults=plan)
        tstate = tstr.init_async_stream_state(tcfg, tspec, tparams, "cpu",
                                              fleet_store=store)
    elif chunk_params:
        tiles = jstr.make_ntile_plan(jspec.n, chunk_params)
        jround = jstr.make_streamed_twoaxis_round(
            jcfg, jhp, jhet, jfed, jspec, chunk_agents=CHUNK,
            chunk_params=chunk_params, faults=jplan)
        jstate = jstr.init_twoaxis_state(jcfg, jspec, jparams, key, tiles)
        tround = tstr.make_streamed_twoaxis_round(
            tcfg, thp, thet, tfed, tspec, device="cpu", chunk_agents=CHUNK,
            chunk_params=chunk_params, faults=plan)
        tstate = tstr.init_twoaxis_state(
            tcfg, tspec, tparams, "cpu",
            tstr.make_ntile_plan(tspec.n, chunk_params))
    else:
        jround = jstr.make_streamed_flat_round(jcfg, jhp, jhet, jfed, jspec,
                                               chunk_agents=CHUNK,
                                               faults=jplan)
        jstate = jstr.init_stream_state(jcfg, jspec, jparams, key,
                                        fleet_store=store)
        tround = tstr.make_streamed_flat_round(tcfg, thp, thet, tfed, tspec,
                                               device="cpu",
                                               chunk_agents=CHUNK,
                                               faults=plan)
        tstate = tstr.init_stream_state(tcfg, tspec, tparams, "cpu",
                                        fleet_store=store)
    sched = None if jplan is None else jplan.lower(A, R, 2 * LAR)
    draws = reference_draws(SEED, jhp, jhet, jfed, 2,
                            latency=engine == "async")
    return jround, jstate, tround, tstate, sched, draws


def _drive(jround, jstate, tround, tstate, sched, draws, r):
    """Round r on both sides: (reference state, its metrics, port state,
    its metrics)."""
    fr = None if sched is None else sched.round_slice(r, LAR)
    jout = jround(jstate) if fr is None else jround(jstate, fr)
    tfr = None if fr is None else {k: torch.from_numpy(np.asarray(v))
                                   for k, v in fr.items()}
    tout = tround(tstate, draws[r], tfr)
    # a plan or the async round: (state, metrics); states are named tuples
    jst, jm = jout if type(jout) is tuple else (jout, {})
    tst, tm = tout if type(tout) is tuple else (tout, {})
    return jst, jm, tst, tm


def _close_fields(jst, tst, names):
    for name in names:
        j, t = getattr(jst, name), getattr(tst, name)
        if name in ("store", "pending_store"):
            j, t = j.snapshot(), t.snapshot()
        np.testing.assert_allclose(_np(t), _np(j), **F32, err_msg=name)


@pytest.mark.parametrize("store", ["host", "device"])
def test_streamed_flat_matches_reference(setup, store):
    """2 streamed synchronous rounds, host-streamed and device-chunked: the
    cloud master, the RSU rows and every agent row in the store."""
    jround, jst, tround, tst, sched, draws = _builders("flat", setup, store)
    assert tround.plan == jround.plan and tround.plan.pad == 1
    for r in range(2):
        jst, _, tst, _ = _drive(jround, jst, tround, tst, sched, draws, r)
        _close_fields(jst, tst, ("cloud_flat", "rsu_flat", "store"))
    assert tst.store.kind == store


@pytest.mark.parametrize("engine", ["flat", "async", "twoaxis"])
def test_streamed_rounds_under_faults_match_reference(setup, engine):
    """Churn and an outage with recovery, the reference's lowered schedule
    injected: buffers within 1e-5, quarantine counts equal (0: the data is
    finite)."""
    jround, jst, tround, tst, sched, draws = _builders(
        "async" if engine == "async" else "flat", setup,
        plan=churn_outage_plan(),
        chunk_params=4096 if engine == "twoaxis" else 0)
    fields = ("cloud_flat", "rsu_flat", "store")
    if engine == "async":
        fields += ("rsu_mass", "cloud_macc", "pending_w")
    for r in range(2):
        jst, jm, tst, tm = _drive(jround, jst, tround, tst, sched, draws, r)
        _close_fields(jst, tst, fields)
        assert int(tm["quarantined"]) == int(jm["quarantined"]) == 0


@pytest.mark.parametrize("cloud_every", [0, 3])
def test_streamed_async_matches_reference(setup, cloud_every):
    """2 streamed semi-async rounds with stragglers, staleness decay and
    buffer keep, and with a cloud cadence that fires mid-round: the whole
    in-flight economy (agent and pending rows where in flight, weights,
    tick counts) and the per-tick absorbed masses."""
    jfed, tfed, jparams, tparams = setup
    jround, jst, tround, tst, sched, draws = _builders("async", setup)
    if cloud_every:
        kw = dict(staleness_decay=0.5, buffer_keep=0.4,
                  cloud_every=cloud_every)
        jcfg = jsim.SimConfig(n_agents=A, n_rsus=R, batch=BATCH, seed=SEED)
        tcfg = tsim.SimConfig(n_agents=A, n_rsus=R, batch=BATCH, seed=SEED)
        jround = jstr.make_streamed_async_round(
            jcfg, JHP(**HP), JHet(**ASYNC_HET), jfed,
            jflatten.spec_of(jparams), jae.AsyncConfig(**kw),
            chunk_agents=CHUNK)
        tround = tstr.make_streamed_async_round(
            tcfg, H2FedParams(**HP), HeterogeneityModel(**ASYNC_HET), tfed,
            tflatten.spec_of(tparams), tae.AsyncConfig(**kw), device="cpu",
            chunk_agents=CHUNK)
    for r in range(2):
        jst, jm, tst, tm = _drive(jround, jst, tround, tst, sched, draws, r)
        _close_fields(jst, tst, ("cloud_flat", "rsu_flat", "rsu_mass",
                                 "cloud_macc", "store", "pending_w"))
        np.testing.assert_array_equal(_np(tst.pending_t), _np(jst.pending_t))
        in_flight = np.asarray(jst.pending_t) > 0
        np.testing.assert_allclose(
            _np(tst.pending_store.snapshot())[in_flight],
            _np(jst.pending_store.snapshot())[in_flight], **F32)
        np.testing.assert_allclose(_np(tm["absorbed_mass"]),
                                   _np(jm["absorbed_mass"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["pending_mass"]),
                                   float(jm["pending_mass"]), rtol=1e-6)
        assert tst.tick == jst.tick == (r + 1) * LAR


def test_streamed_twoaxis_matches_reference(setup):
    """The two-axis round (4096-column tiles, N padded to 32,768): the host
    RSU rows, cloud master and store on the padded grid, the padded columns
    zero throughout."""
    jround, jst, tround, tst, sched, draws = _builders("flat", setup,
                                                       chunk_params=4096)
    assert tround.tiles == jround.tiles
    for r in range(2):
        jst, _, tst, _ = _drive(jround, jst, tround, tst, sched, draws, r)
        _close_fields(jst, tst, ("cloud_flat", "rsu_flat", "store"))
    n = tround.tiles.n
    assert not tst.cloud_flat[n:].any() and tst.cloud_flat.dtype == \
        torch.float32


@pytest.mark.parametrize("n_agents,chunk", [
    (16, 4), (16, 5), (16, 0), (4, 100), (100_000, 16_384), (25_000, 16_384),
    (1, 1), (1025, 0), (7, 7)])
def test_chunk_plan_matches_reference(n_agents, chunk):
    got, want = (tstr.make_chunk_plan(n_agents, chunk),
                 jstr.make_chunk_plan(n_agents, chunk))
    assert tuple(got) == tuple(want) and got.n_padded == want.n_padded
    for c in range(got.n_chunks):
        assert got.bounds(c) == want.bounds(c)


@pytest.mark.parametrize("n,chunk_params", [
    (1000, 256), (1000, 100), (1000, 0), (31_810, 4096),
    (9_540_010, 1_048_576), (100, 50)])
def test_ntile_plan_matches_reference(n, chunk_params):
    got, want = (tstr.make_ntile_plan(n, chunk_params),
                 jstr.make_ntile_plan(n, chunk_params))
    assert tuple(got) == tuple(want) and got.n_padded == want.n_padded
    assert got.bounds(got.n_tiles - 1) == want.bounds(want.n_tiles - 1)


@pytest.mark.parametrize("engine,store", [("flat", "host"), ("async", "host"),
                                          ("flat", "device"),
                                          ("async", "device")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transfer_bytes_match_reference(setup, engine, store, dtype):
    jfed, tfed, jparams, tparams = setup
    jp, tp = jstr.make_chunk_plan(A, 3), tstr.make_chunk_plan(A, 3)
    got = tstr.streamed_transfer_bytes(
        tp, tflatten.spec_of(tparams, storage_dtype=dtype),
        H2FedParams(**HP), tfed, engine=engine, fleet_store=store)
    want = jstr.streamed_transfer_bytes(
        jp, jflatten.spec_of(jparams, storage_dtype=dtype), JHP(**HP), jfed,
        engine=engine, fleet_store=store)
    assert got == want


# -- through run_scenario --------------------------------------------------

def spec_pair(**kw):
    """(reference spec, port spec) from the same fields."""
    hp = dict(HP, **kw.pop("hp", {}))
    het = dict(HET, **kw.pop("het", {}))
    plan = kw.pop("faults", None)
    fields = dict(n_agents=A, n_rsus=R, batch=BATCH, n_train=1200,
                  n_test=200, rounds=2, seed=0, sim_seed=SEED, **kw)
    return (JSpec(**fields, hp=JHP(**hp), het=JHet(**het),
                  faults=None if plan is None else
                  JPlan.from_dict(plan.to_dict())),
            TSpec(**fields, hp=H2FedParams(**hp),
                  het=HeterogeneityModel(**het), faults=plan))


@pytest.mark.parametrize("variant", ["flat", "async", "twoaxis"])
def test_run_scenario_matches_reference(setup, variant):
    """``run_scenario(spec.replace(fleet_store="host", chunk_agents=7))``
    runs the streamed flat and async rounds, and ``chunk_params`` the two-
    axis round; with the reference's draws injected, the accuracy history
    within 2e-3 and the cloud master within 1e-5 of the reference's."""
    _, _, jparams, tparams = setup
    kw = dict(fleet_store="host", chunk_agents=7)
    if variant == "async":
        kw.update(engine="async", het=dict(max_delay=2, delay_p=0.5))
    if variant == "twoaxis":
        kw.update(chunk_params=8192)
    jspec, tspec = spec_pair(**kw)
    jres = jspec.resolve()
    jst, jh = j_run_scenario(jres, jparams)
    draws = reference_draws(jres.cfg.seed, jspec.hp, jspec.het, jres.fed,
                            jspec.rounds, latency=variant == "async")
    tst, th = run_scenario(tspec, tparams, device="cpu", draws=draws)
    np.testing.assert_allclose(th["acc"], jh["acc"], atol=2e-3)
    n = tstr.make_ntile_plan(31_810).n
    np.testing.assert_allclose(_np(tst.cloud_flat)[:n],
                               _np(jst.cloud_flat)[:n], **F32)
    assert set(th) == set(jh)
    if variant == "async":
        np.testing.assert_allclose(th["absorbed_mass"], jh["absorbed_mass"],
                                   rtol=1e-6)
        np.testing.assert_allclose(th["pending_mass"], jh["pending_mass"],
                                   rtol=1e-6)


# -- within the port ---------------------------------------------------------

def _vec(state):
    if hasattr(state, "cloud_flat"):
        return state.cloud_flat
    return torch.cat([state.cloud_params[k].reshape(-1)
                      for k in sorted(state.cloud_params)])


@pytest.mark.parametrize("engine", ["flat", "async"])
def test_streamed_equals_resident(engine):
    """The reference's own anchor (its ``TOL``), on its own small scenario
    with the port's own draws: host-streamed in chunks of 5 (flat) or 7
    (async), a padded tail each, against the resident round."""
    spec = TSpec(**BASE)
    if engine == "async":
        spec = spec.replace(engine="async", het=HeterogeneityModel(
            csr=0.6, max_delay=2, delay_p=0.5))
    res_st, res_h = run_scenario(spec, device="cpu")
    str_st, str_h = run_scenario(
        spec.replace(fleet_store="host",
                     chunk_agents=5 if engine == "flat" else 7), device="cpu")
    np.testing.assert_allclose(str_h["acc"], res_h["acc"], **TOL)
    np.testing.assert_allclose(_vec(str_st), _vec(res_st), **TOL)
    if engine == "async":
        for k in ("absorbed_mass", "pending_mass"):
            np.testing.assert_allclose(str_h[k], res_h[k], rtol=1e-6)
        np.testing.assert_allclose(str_st.store.snapshot(),
                                   res_st.agent_flat, **TOL)
        assert torch.equal(str_st.pending_t, res_st.pending_t)
        assert torch.equal(str_st.pending_w, res_st.pending_w)


@pytest.mark.parametrize("engine", ["flat", "async"])
def test_device_chunked_equals_host_streamed(engine):
    """One chunk grid, two stores: the same rows land in both."""
    spec = TSpec(**BASE, engine=engine, chunk_agents=5)
    dev_st, dev_h = run_scenario(spec, device="cpu")
    host_st, host_h = run_scenario(spec.replace(fleet_store="host"),
                                   device="cpu")
    np.testing.assert_array_equal(dev_h["acc"], host_h["acc"])
    assert dev_st.store.kind == "device" and host_st.store.kind == "host"
    assert torch.equal(dev_st.store.snapshot(), host_st.store.snapshot())
    assert torch.equal(dev_st.cloud_flat, host_st.cloud_flat)


@pytest.mark.parametrize("variant", ["flat", "async", "twoaxis"])
def test_zero_fault_anchor(variant):
    """An empty plan folds as ``w * 1.0`` weights and an all-finite guard
    pass: bit for bit the round without a plan, on all three streamed
    rounds."""
    spec = TSpec(**BASE, fleet_store="host", chunk_agents=5)
    if variant == "async":
        spec = spec.replace(engine="async", het=HeterogeneityModel(
            csr=0.6, max_delay=2, delay_p=0.5))
    if variant == "twoaxis":
        spec = spec.replace(chunk_params=4096)
    clean, hc = run_scenario(spec, device="cpu")
    faulted, hf = run_scenario(spec.replace(faults=FaultPlan()), device="cpu")
    assert torch.equal(clean.cloud_flat, faulted.cloud_flat)
    assert torch.equal(clean.store.snapshot(), faulted.store.snapshot())
    np.testing.assert_array_equal(hc["acc"], hf["acc"])
    assert (hf["quarantined"] == 0).all()


def test_twoaxis_equals_one_axis():
    """Column independence: on the host the two-axis round equals the one-
    axis streamed round on the first N columns, and carries zeros in the
    padded ones."""
    spec = TSpec(**BASE, fleet_store="host", chunk_agents=5)
    one, h1 = run_scenario(spec, device="cpu")
    two, h2 = run_scenario(spec.replace(chunk_params=4096), device="cpu")
    n = one.cloud_flat.shape[0]
    np.testing.assert_array_equal(h1["acc"], h2["acc"])
    assert torch.equal(one.cloud_flat, two.cloud_flat[:n])
    assert torch.equal(one.rsu_flat, two.rsu_flat[:, :n])
    assert torch.equal(one.store.snapshot(), two.store.snapshot()[:, :n])
    assert not two.cloud_flat[n:].any()


def test_bf16_host_store():
    """bf16 rows in a CPU host store, an fp32 cloud master, finite, and
    within bf16 storage precision of the fp32 round."""
    spec = TSpec(**BASE, fleet_store="host", chunk_agents=6)
    st, h = run_scenario(spec.replace(fleet_dtype="bfloat16"), device="cpu")
    ref, _ = run_scenario(spec, device="cpu")
    assert st.store.dtype == torch.bfloat16 and not st.store.pinned
    assert st.rsu_flat.dtype == torch.bfloat16
    assert st.cloud_flat.dtype == torch.float32
    assert np.isfinite(h["acc"]).all()
    assert torch.isfinite(st.store.snapshot().float()).all()
    np.testing.assert_allclose(st.cloud_flat, ref.cloud_flat, atol=2e-2,
                               rtol=2 ** -7)


def test_run_scenarios_runs_streamed_cells_one_at_a_time():
    """A grid with streamed cells: each streamed cell's history is its own
    ``run_scenario``'s, in input order, beside a resident cell."""
    specs = [TSpec(**BASE, fleet_store="host", chunk_agents=5),
             TSpec(**BASE),
             TSpec(**BASE, fleet_store="host", chunk_agents=5, sim_seed=1)]
    hists = run_scenarios(specs, _mlp_params(), device="cpu")
    for spec, h in zip(specs, hists):
        _, alone = run_scenario(spec, _mlp_params(), device="cpu")
        np.testing.assert_array_equal(h["acc"], alone["acc"])


def _mlp_params():
    from repro_torch.configs.mnist_mlp import CONFIG
    from repro_torch.models import mlp
    return mlp.init_params(CONFIG, torch.Generator().manual_seed(0))


def test_streamed_fields_in_keys_match_reference():
    """``static_key`` and ``cache_key`` carry fleet_store, chunk_agents and
    chunk_params as the reference's do."""
    base = dict(fleet_store="host", chunk_agents=7, chunk_params=0)
    for kw in (base, dict(base, chunk_agents=5), dict(base, chunk_params=256),
               dict(base, fleet_store="device")):
        jspec, tspec = spec_pair(**kw)
        assert tspec.cache_key == jspec.cache_key
        assert tspec.resolve().static_key == jspec.resolve().static_key
    keys = {spec_pair(**kw)[1].cache_key for kw in (
        base, dict(base, chunk_agents=5), dict(base, chunk_params=256))}
    assert len(keys) == 3


@pytest.mark.parametrize("kw", [
    dict(fleet_store="host", engine="tree"),
    dict(chunk_agents=4, engine="sharded"),
    dict(chunk_params=256),
    dict(chunk_params=256, fleet_store="host", engine="async"),
    dict(fleet_store="host", faults=FaultPlan(
        corrupt=(CorruptSpec(kind="nan", frac=0.5),))),
    dict(chunk_agents=3, faults=FaultPlan(
        corrupt=(CorruptSpec(kind="scale", frac=0.5, scale=9.0),))),
    dict(fleet_store="warp")],
    ids=["host-tree", "chunked-sharded", "twoaxis-device-store",
         "twoaxis-async", "host-corrupt", "chunked-corrupt", "unknown-store"])
def test_validation_refuses_what_the_reference_refuses(kw):
    jspec, tspec = spec_pair(**kw)
    with pytest.raises((AssertionError, ValueError)):
        jspec.validate()
    with pytest.raises(ValueError):
        tspec.validate()


@pytest.mark.parametrize("kw", [
    dict(fleet_store="host"), dict(chunk_agents=4),
    dict(fleet_store="host", engine="async", chunk_agents=3),
    dict(fleet_store="host", chunk_params=256),
    dict(fleet_store="host", faults=churn_outage_plan())])
def test_validation_accepts_what_the_reference_accepts(kw):
    jspec, tspec = spec_pair(**kw)
    jspec.validate()
    tspec.validate()


def test_streamed_rounds_refuse_corrupting_plans(setup):
    _, tfed, _, tparams = setup
    plan = FaultPlan(corrupt=(CorruptSpec(kind="nan", frac=0.5),))
    cfg = tsim.SimConfig(n_agents=A, n_rsus=R, batch=BATCH)
    spec = tflatten.spec_of(tparams)
    for make in (tstr.make_streamed_flat_round,
                 tstr.make_streamed_twoaxis_round):
        with pytest.raises(ValueError, match="corrupted"):
            make(cfg, H2FedParams(**HP), HeterogeneityModel(**HET), tfed,
                 spec, device="cpu", faults=plan)
    with pytest.raises(ValueError, match="does not stream"):
        tstr.run_streamed_simulation(cfg, H2FedParams(**HP),
                                     HeterogeneityModel(**HET), tfed,
                                     tparams, 1, device="cpu", engine="tree")
