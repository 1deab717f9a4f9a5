"""The port's continuous serving loop against the JAX package's, on the CPU.

Both packages run the same serve-mode spec from the same weights, data and
event stream (the load generators are bit-equal, tests/test_torch_load_gen
.py); the reference's per-tick draws are injected into the port through
its ``draws`` seam, built in the reference loop's key discipline (the
state's key starts at ``key(cfg.seed)``, each virtual round splits it and
derives ``round_keys(k, lar)``, each tick draws ``round_draws`` on its
key, ``conn`` carried along).  A fault plan lowers to the same masks in
both packages.

Tolerances: the host-side schedule (every counter, drain sizes, queue
depths, event waits, model staleness) exactly; fp32 cloud, RSU and agent
buffers 1e-5 absolute / relative; masses and blocked mass 1e-5 relative;
accuracy histories 2e-3.  A bf16 tick is held to the reference's tick
from the reference's state within one bf16 ulp (a one-ulp difference in a
stored row can flip a hidden ReLU unit on the next tick, see
tests/test_torch_async.py).  The within-port tests hold the loop to
itself: the anchor to ``engine="async"``, replay and resume bit for bit.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.mnist_mlp import CONFIG as JCONFIG
from repro.core import faults as jfaults
from repro.core import load_gen as jlg
from repro.core import flatten as jflatten
from repro.core.heterogeneity import init_conn_state as j_init_conn
from repro.core.scenario import ScenarioSpec as JSpec
from repro.fedsim import serving as jserving
from repro.fedsim import simulator as jsim
from repro.fedsim.async_engine import AsyncConfig as JAsyncConfig
from repro.models import mlp as jmlp

from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.core import faults as tfaults
from repro_torch.core import flatten as tflatten
from repro_torch.core import load_gen as tlg
from repro_torch.core.heterogeneity import ConnState, HeterogeneityModel
from repro_torch.core.scenario import ScenarioSpec as TSpec
from repro_torch.fedsim import serving as tserving
from repro_torch.fedsim.async_engine import AsyncConfig, init_async_state
from repro_torch.fedsim.sweep import build_sweep, run_scenario, run_scenarios
from repro_torch.models import mlp as tmlp

from test_torch_async import pallas_routes

BASE = dict(n_agents=8, n_rsus=4, batch=8, n_train=400, n_test=100,
            staleness_decay=1.0, buffer_keep=0.0, cloud_every=0,
            engine="async")
A = BASE["n_agents"]
LAR = 5                       # H2FedParams' default
BUFFERS = ("agent_flat", "rsu_flat", "cloud_flat", "rsu_mass", "cloud_macc")
# the stats fields decided on the host: equal in both packages
SCHEDULE = ("events_generated", "events_absorbed", "events_dropped",
            "events_deferred", "events_coalesced", "events_lost_churn",
            "events_duplicated", "events_stale_rejected",
            "quarantined_updates", "n_ticks", "n_rounds", "n_cloud_aggs",
            "sim_time", "queue_depth", "drain_sizes", "event_wait",
            "event_age_ticks", "model_staleness", "serve_requests")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread for this module (torch's and JAX's
    thread pools compete when test files run side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    jparams = jmlp.init_params(JCONFIG, jax.random.key(0))
    return jparams, convert.params_from_jax(
        {k: np.asarray(v) for k, v in jparams.items()})


def plans(mod):
    """(module's FaultPlan for the parity cases, for the resume case)."""
    every = mod.FaultPlan(
        churn=(mod.ChurnWindow(frac=0.25, start=2, stop=9, seed=1),),
        outages=(mod.RsuOutage(rsu=1, start=3, stop=7),),
        corrupt=(mod.CorruptSpec(kind="nan", frac=0.2),
                 mod.CorruptSpec(kind="scale", frac=0.2, scale=1e4, seed=2),
                 mod.CorruptSpec(kind="stale", frac=0.2, seed=3)),
        dup_frac=0.25, clock_skew=0.05, norm_clip=50.0, seed=3)
    resume = mod.FaultPlan(churn=(mod.ChurnWindow(frac=0.25, start=2),),
                           dup_frac=0.2, clock_skew=0.05, seed=5)
    return every, resume


def specs(**kw):
    """The same serve-mode spec in both packages."""
    plan = kw.pop("faults", None)
    return (JSpec(**{**BASE, **kw},
                  faults=None if plan is None else plans(jfaults)[plan]),
            TSpec(**{**BASE, **kw},
                  faults=None if plan is None else plans(tfaults)[plan]))


def jax_serve_draws(res, n_ticks: int):
    """The reference loop's per-tick draws as torch tensors: draws[t] =
    (mask, active_steps) of global tick t."""
    cfg, hp, het = res.cfg, res.spec.hp, res.spec.het
    spe = max(res.fed.x.shape[1] // cfg.batch, 1)
    draw = jax.jit(lambda key, conn: jsim.round_draws(key, conn, het, hp,
                                                      cfg.n_agents, spe))
    rng, conn, out = jax.random.key(cfg.seed), j_init_conn(cfg.n_agents), []
    while len(out) < n_ticks:
        rng, k = jax.random.split(rng)
        keys = jsim.round_keys(k, hp.lar)
        for i in range(hp.lar):
            conn, mask, act = draw(keys[i], conn)
            out.append((torch.from_numpy(np.array(mask)),
                        torch.from_numpy(np.array(act))))
    return out


def both_loops(params, gen_of=None, n_events=0, **kw):
    """Both packages' loops on one spec, the reference's draws injected:
    ((jax state, history, stats), (port state, history, stats))."""
    jparams, tparams = params
    jspec, tspec = specs(**kw)
    jres, tres = jspec.resolve(), tspec.resolve()
    bound = 2 * max(n_events or jspec.serve_events, 1) + 2 * LAR
    jst, jh, js, _ = jserving.run_serve_loop(
        jres, jparams, gen=None if gen_of is None else gen_of(jres))
    tst, th, ts, _ = tserving.run_serve_loop(
        tres, tparams, device="cpu",
        gen=None if gen_of is None else gen_of(tres),
        draws=jax_serve_draws(jres, bound))
    return (jst, jh, js), (tst, th, ts)


def assert_loops_match(j, t):
    (jst, jh, js), (tst, th, ts) = j, t
    for name in SCHEDULE:
        assert getattr(ts, name) == getattr(js, name), name
    np.testing.assert_allclose(ts.blocked_mass, js.blocked_mass, rtol=1e-5)
    for name in BUFFERS:
        np.testing.assert_allclose(
            convert.tensor_to_numpy(getattr(tst, name)),
            np.asarray(getattr(jst, name)), rtol=1e-5, atol=1e-5,
            err_msg=name)
    assert tst.tick == int(jst.tick) == ts.n_ticks
    np.testing.assert_array_equal(th["round"], jh["round"])
    np.testing.assert_allclose(th["acc"], jh["acc"], atol=2e-3)
    np.testing.assert_allclose(th["absorbed_mass"], jh["absorbed_mass"],
                               rtol=1e-5)
    assert set(th["serve"]) == set(jh["serve"])


# --------------------------------------------------------------------------
# the event queue, both packages
# --------------------------------------------------------------------------

QUEUES = {"port": (tserving.EventQueue, tlg.Event),
          "reference": (jserving.EventQueue, jserving.Event)}


@pytest.mark.parametrize("pkg", list(QUEUES))
def test_event_queue(pkg):
    """The reference's queue cases: drop_oldest evicts the head and
    counts it, backpressure refuses without losing, drain coalesces to
    the newest event per agent, bad configurations raise."""
    Queue, Event = QUEUES[pkg]
    q = Queue(capacity=2, policy="drop_oldest")
    for i in range(4):
        assert q.push(Event(float(i), i, i), tick=0)
    assert q.dropped == 2
    batch, coalesced = q.drain(tick=3)
    assert [e.agent for e, _ in batch] == [2, 3]
    assert [age for _, age in batch] == [3, 3] and coalesced == 0

    q = Queue(capacity=2, policy="backpressure")
    assert q.push(Event(0.0, 0, 0), 0) and q.push(Event(0.1, 1, 1), 0)
    assert not q.push(Event(0.2, 2, 2), 0)
    assert q.dropped == 0 and len(q) == 2

    q = Queue()
    q.push(Event(0.0, 3, 0), 0)
    q.push(Event(0.5, 3, 1), 1)
    q.push(Event(0.7, 1, 2), 1)
    assert q.oldest_t == 0.0
    batch, coalesced = q.drain(tick=2)
    assert coalesced == 1
    assert [(e.agent, e.seq, age) for e, age in batch] == [(3, 1, 1),
                                                           (1, 2, 1)]
    q.load([(Event(0.1, 2, 5), 4)], dropped=7)
    assert q.entries() == [(Event(0.1, 2, 5), 4)] and q.dropped == 7

    with pytest.raises(ValueError):
        Queue(policy="explode")
    with pytest.raises(ValueError):
        Queue(capacity=-1)


# --------------------------------------------------------------------------
# the loop against the reference, its draws injected
# --------------------------------------------------------------------------

CASES = {
    "anchor": dict(rounds=2, serve_events=A * LAR * 2,
                   tick_trigger=f"batch:{A}"),
    "poisson": dict(rounds=2, serve_events=64, arrival_rate=1.5,
                    tick_trigger="batch:4,deadline:2.0", queue_capacity=16),
    "drop_oldest": dict(rounds=2, serve_events=96, arrival_rate=6.0,
                        tick_trigger="deadline:3.0", queue_capacity=6,
                        overload_policy="drop_oldest"),
    "backpressure": dict(rounds=2, serve_events=96, arrival_rate=6.0,
                         tick_trigger="batch:32", queue_capacity=4,
                         overload_policy="backpressure"),
    "faults": dict(rounds=2, serve_events=96, arrival_rate=2.0,
                   tick_trigger="batch:4,deadline:2.0", faults=0),
    "unfused_cadence": dict(rounds=2, serve_events=64, arrival_rate=1.5,
                            tick_trigger="batch:4,deadline:2.0",
                            fused=False, cloud_every=3, staleness_decay=0.5,
                            buffer_keep=0.4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_loop_parity(params, case):
    kw = dict(CASES[case])
    gen_of = None
    if case == "anchor":
        def gen_of(res):
            mod = tlg if isinstance(res.spec, TSpec) else jlg
            return mod.every_agent_once_trace(A, LAR * 2)
    j, t = both_loops(params, gen_of, **kw)
    assert_loops_match(j, t)
    ts = t[2]
    if case == "drop_oldest":
        assert ts.events_dropped > 0
        assert ts.events_generated == (ts.events_absorbed
                                       + ts.events_coalesced
                                       + ts.events_dropped)
    if case == "backpressure":
        assert ts.events_deferred > 0 and ts.events_dropped == 0
    if case == "faults":
        # the plan lowers to the reference's schedule, mask for mask
        jsched = plans(jfaults)[0].lower(A, BASE["n_rsus"], 200)
        tsched = plans(tfaults)[0].lower(A, BASE["n_rsus"], 200)
        for k in tfaults.FAULT_FIELDS:
            np.testing.assert_array_equal(getattr(tsched, k),
                                          getattr(jsched, k), err_msg=k)
        assert (ts.events_duplicated and ts.events_lost_churn
                and ts.quarantined_updates and ts.blocked_mass > 0)
        assert ts.events_generated == (
            ts.events_absorbed + ts.events_coalesced + ts.events_dropped
            + ts.events_lost_churn + ts.events_stale_rejected)


def test_bf16_tick_parity(params, monkeypatch):
    """One bf16 tick from the reference's state after 3 ticks of a Poisson
    run: the port's tick against the reference's tick, fused and not, half
    the fleet arriving, one bf16 ulp."""
    pallas_routes(monkeypatch)
    jparams, tparams = params
    kw = dict(rounds=2, serve_events=12, arrival_rate=1.5,
              tick_trigger="batch:4", fleet_dtype="bfloat16",
              staleness_decay=0.5, buffer_keep=0.4)
    jspec, tspec = specs(**kw)
    jres, tres = jspec.resolve(), tspec.resolve()
    jst0, _, jstats, _ = jserving.run_serve_loop(jres, jparams)
    assert jstats.n_ticks == 3
    cfg, hp, het = jres.cfg, jspec.hp, jspec.het
    spe = max(jres.fed.x.shape[1] // cfg.batch, 1)
    arrive = (np.arange(A) % 2).astype(np.float32)
    age = (np.arange(A) % 3).astype(np.int32)
    key = jax.random.key(9)
    _, mask, act = jsim.round_draws(key, jst0.conn, het, hp, A, spe)
    for fused in (True, False):
        jspec_f = jflatten.spec_of(jparams, storage_dtype="bfloat16")
        acfg = JAsyncConfig(staleness_decay=0.5, buffer_keep=0.4)
        jtick = jserving._make_serve_tick(cfg, hp, het, jres.fed, jspec_f,
                                          acfg, fused=fused)
        jst = jax.tree.map(lambda x: x.copy(), jst0)
        jout, jm = jtick(jst, key, jnp.asarray(arrive), jnp.asarray(age))
        tspec_f = tflatten.spec_of(tparams, storage_dtype="bfloat16")
        ttick = tserving._make_serve_tick(
            tres.cfg, tspec.hp, tspec.het, tres.fed, tspec_f,
            AsyncConfig(staleness_decay=0.5, buffer_keep=0.4), device="cpu",
            fused=fused)
        state = init_async_state(tres.cfg, tspec_f, tparams, "cpu")
        state = state._replace(
            tick=int(jst0.tick), conn=ConnState(convert.tensor_from_numpy(
                np.asarray(jst0.conn.remaining))),
            **{f: convert.tensor_from_numpy(np.asarray(getattr(jst0, f)))
               for f in BUFFERS})
        tout, tm = ttick(state, torch.from_numpy(arrive),
                         torch.from_numpy(age),
                         draw=(torch.from_numpy(np.array(mask)),
                               torch.from_numpy(np.array(act))))
        for f in ("agent_flat", "rsu_flat"):
            got = getattr(tout, f)
            assert got.dtype == torch.bfloat16
            np.testing.assert_allclose(
                convert.tensor_to_numpy(got),
                np.asarray(getattr(jout, f)).astype(np.float32),
                rtol=2 ** -7, atol=2 ** -9, err_msg=f)
        for f in ("cloud_flat", "rsu_mass", "cloud_macc"):
            np.testing.assert_allclose(
                convert.tensor_to_numpy(getattr(tout, f)),
                np.asarray(getattr(jout, f)), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tm["absorbed_mass"].numpy(),
                                   np.asarray(jm["absorbed_mass"]),
                                   rtol=1e-5)


# --------------------------------------------------------------------------
# within the port
# --------------------------------------------------------------------------

def _tspec(**kw):
    return TSpec(**{**BASE, **kw})


def test_anchor_equals_async(params):
    """Every agent arrives once per tick window with decay disabled: the
    serve loop is the async engine, with the port's own draws (a zero
    latency draws nothing, so both consume the generator alike)."""
    _, tparams = params
    rounds = 3
    st_a, h_a = run_scenario(_tspec(rounds=rounds), tparams, device="cpu")
    spec = _tspec(rounds=rounds, serve_events=A * LAR * rounds,
                  tick_trigger=f"batch:{A}")
    st_s, h_s, stats, _ = tserving.run_serve_loop(
        spec.resolve(), tparams, device="cpu",
        gen=tlg.every_agent_once_trace(A, LAR * rounds))
    assert stats.n_ticks == LAR * rounds and stats.n_rounds == rounds
    assert stats.events_coalesced == stats.events_dropped == 0
    # (the RSU buffers differ between rounds: the serve loop re-anchors
    # them at the round close, the async engine at the next round's start)
    for f in ("cloud_flat", "agent_flat"):
        np.testing.assert_allclose(getattr(st_s, f).numpy(),
                                   getattr(st_a, f).numpy(), rtol=2e-5,
                                   atol=2e-6, err_msg=f)
    np.testing.assert_allclose(h_s["acc"], h_a["acc"], atol=2e-6)
    np.testing.assert_allclose(h_s["absorbed_mass"], h_a["absorbed_mass"],
                               rtol=1e-6)


def test_anchor_mass_conserved(params):
    """Full connectivity, full-fleet ticks: every round absorbs lar x
    sum(n_per_agent), nothing lost on the event path."""
    _, tparams = params
    rounds = 2
    spec = _tspec(rounds=rounds, serve_events=A * LAR * rounds,
                  tick_trigger=f"batch:{A}",
                  het=HeterogeneityModel(csr=1.0, fsr=1.0))
    res = spec.resolve()
    _, hist, stats, _ = tserving.run_serve_loop(
        res, tparams, device="cpu",
        gen=tlg.every_agent_once_trace(A, LAR * rounds))
    per_round = LAR * float(np.sum(res.fed.n_per_agent))
    np.testing.assert_allclose(hist["absorbed_mass"], [per_round] * rounds,
                               rtol=1e-6)
    assert stats.events_absorbed == A * LAR * rounds


def test_replay_bit_identical(params, tmp_path):
    """A seeded Poisson run against the replay of its dumped trace: the
    same tick schedule and the same buffers, bit for bit."""
    _, tparams = params
    base = dict(rounds=2, serve_events=64, arrival_rate=1.5,
                tick_trigger="batch:4,deadline:2.0", queue_capacity=16)
    res = _tspec(**base).resolve()
    st1, h1, s1, _ = tserving.run_serve_loop(res, tparams, device="cpu")
    rates = tlg.agent_rates(res.spec.het, A, 1.5, seed=res.cfg.seed)
    p = tmp_path / "trace.jsonl"
    tlg.write_trace(tlg.PoissonLoadGen(rates, seed=res.cfg.seed,
                                       n_events=64).events(), p)
    st2, h2, s2, _ = tserving.run_serve_loop(
        _tspec(**base, serve_trace=str(p)).resolve(), tparams, device="cpu")
    assert s1.drain_sizes == s2.drain_sizes
    assert s1.queue_depth == s2.queue_depth and s1.n_ticks == s2.n_ticks
    for f in ("cloud_flat", "rsu_flat", "agent_flat"):
        assert torch.equal(getattr(st1, f), getattr(st2, f)), f
    np.testing.assert_array_equal(h1["acc"], h2["acc"])


def _resume_spec():
    return _tspec(serve_events=A * 10, tick_trigger=f"batch:{A}",
                  faults=plans(tfaults)[1], fused=False, cloud_every=3,
                  staleness_decay=0.5, buffer_keep=0.4)


def test_resume_bit_identical(params, tmp_path):
    """Resume from a mid-run snapshot equals the uninterrupted run bit
    for bit, the generator's state, conn and the host-side fault
    randomness included."""
    _, tparams = params
    spec = _resume_spec()
    gen = tlg.every_agent_once_trace(A, 10)
    d = tmp_path / "snaps"
    st1, h1, s1, _ = tserving.run_serve_loop(spec.resolve(), tparams,
                                             device="cpu", gen=gen,
                                             snapshot_dir=d,
                                             snapshot_every=2)
    assert len(list(d.glob("step_*"))) >= 3
    st2, h2, s2, _ = tserving.run_serve_loop(spec.resolve(), tparams,
                                             device="cpu", gen=gen,
                                             resume_from=d, resume_step=4)
    for f in ("cloud_flat", "rsu_flat", "agent_flat", "rsu_mass",
              "cloud_macc"):
        assert torch.equal(getattr(st1, f), getattr(st2, f)), f
    assert torch.equal(st1.conn.remaining, st2.conn.remaining)
    assert torch.equal(st1.gen.get_state(), st2.gen.get_state())
    np.testing.assert_array_equal(h1["acc"], h2["acc"])
    for name in SCHEDULE:
        assert getattr(s1, name) == getattr(s2, name), name


def test_interrupt_graceful_and_resumable(params, tmp_path):
    """A mid-loop exception raises ServeLoopInterrupted with finalized
    stats and a last-effort snapshot; resuming it finishes the run at the
    uninterrupted cloud master, bit for bit."""
    _, tparams = params
    spec = _tspec(serve_events=A * 10, tick_trigger=f"batch:{A}")
    gen = tlg.every_agent_once_trace(A, 10)
    res = spec.resolve()
    st_ref, _, s_ref, _ = tserving.run_serve_loop(res, tparams,
                                                  device="cpu", gen=gen)
    calls = {"n": 0}
    x = torch.from_numpy(res.test.x)
    y = torch.from_numpy(res.test.y).long()

    def bomb(p):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated crash")
        return float((tmlp.forward(p, x).argmax(-1) == y).float()
                     .mean())
    d = tmp_path / "snaps"
    with pytest.raises(tserving.ServeLoopInterrupted) as ei:
        tserving.run_serve_loop(spec.resolve(), tparams, device="cpu",
                                gen=gen, eval_fn=bomb, snapshot_dir=d)
    exc = ei.value
    assert exc.stats is not None and exc.stats.n_ticks > 0
    assert exc.snapshot_path is not None
    assert ckpt.latest_step(d) == exc.stats.n_ticks
    assert "serve" in exc.history
    st2, _, s2, _ = tserving.run_serve_loop(spec.resolve(), tparams,
                                            device="cpu", gen=gen,
                                            resume_from=d)
    assert torch.equal(st_ref.cloud_flat, st2.cloud_flat)
    assert s_ref.n_ticks == s2.n_ticks


def test_run_scenario_dispatch(params):
    """``run_scenario`` runs a serve-mode spec through the loop with the
    stats summary under ``history["serve"]``; ``run_scenarios`` runs such
    cells one at a time (the same histories), and the batched program
    refuses them."""
    _, tparams = params
    spec = _tspec(rounds=2, serve_events=48, queue_capacity=32)
    state, hist = run_scenario(spec, tparams, device="cpu")
    serve = hist["serve"]
    for k in ("updates_per_s", "tick_p50_ms", "tick_p99_ms",
              "queue_depth_max", "events_dropped", "model_staleness_mean",
              "event_wait_mean", "blocked_mass", "serve_p50_ms"):
        assert k in serve, k
    assert serve["events_generated"] == 48
    assert len(hist["acc"]) == len(hist["round"]) > 0
    assert state.tick == serve["n_ticks"]
    grid = run_scenarios([spec, spec.replace(sim_seed=1)], tparams,
                         device="cpu")
    np.testing.assert_array_equal(grid[0]["acc"], hist["acc"])
    assert grid[1]["serve"]["events_generated"] == 48
    with pytest.raises(ValueError, match="event-driven"):
        build_sweep([spec.resolve(), spec.resolve()], tparams, device="cpu")


def test_live_server_probes(params):
    """The server answers a probe every tick; its snapshot is a copy, the
    final cloud master, and does not alias the live state."""
    _, tparams = params
    res = _tspec(rounds=2, serve_events=32).resolve()
    st, _, stats, server = tserving.run_serve_loop(
        res, tparams, device="cpu", probe_x=res.test.x[:16])
    assert stats.serve_requests == stats.n_ticks > 0
    assert len(stats.serve_latency_s) == stats.n_ticks
    preds = server.request(res.test.x[:16])
    assert preds.shape == (16,) and preds.dtype == torch.int64
    assert torch.equal(server.snapshot, st.cloud_flat)
    assert server.snapshot.data_ptr() != st.cloud_flat.data_ptr()
    want = tmlp.forward(server.params(), torch.from_numpy(
        res.test.x[:16])).argmax(-1)
    assert torch.equal(preds, want)


@pytest.mark.parametrize("keep", [0.0, 0.4])
@pytest.mark.parametrize("fused", [True, False])
def test_empty_tick_keeps_buffers(params, fused, keep):
    """A tick with no arrivals (stale rejection can empty a drain): the
    absorb sees all-zero weights.  An RSU with no retained mass keeps its
    buffer through the mass guard bit for bit; one that retains ``keep *
    M > 0`` is renormalized by that mass, within an ulp.  The agents keep
    their rows and the retained mass stays."""
    _, tparams = params
    res = _tspec(serve_events=8, staleness_decay=0.5,
                 buffer_keep=keep).resolve()
    spec = tflatten.spec_of(tparams)
    tick = tserving._make_serve_tick(
        res.cfg, res.spec.hp, res.spec.het, res.fed, spec,
        AsyncConfig(staleness_decay=0.5, buffer_keep=keep), device="cpu",
        fused=fused)
    state = init_async_state(res.cfg, spec, tparams, "cpu")
    state = state._replace(rsu_flat=state.rsu_flat + torch.randn_like(
        state.rsu_flat), rsu_mass=torch.tensor([0.0, 2.0, 3.0, 0.5]))
    out, m = tick(state, torch.zeros(A), torch.zeros(A, dtype=torch.int32))
    held = state.rsu_mass * keep > 0
    assert torch.equal(out.rsu_flat[~held], state.rsu_flat[~held])
    np.testing.assert_allclose(out.rsu_flat[held].numpy(),
                               state.rsu_flat[held].numpy(), rtol=3e-7)
    assert torch.equal(out.agent_flat, state.agent_flat)
    np.testing.assert_allclose(out.rsu_mass.numpy(),
                               keep * state.rsu_mass.numpy(), rtol=1e-6)
    assert float(m["absorbed_weight"]) == 0.0
    assert not m["absorbed_mass"].any()


def test_rejects_foreign_trace(params):
    """A trace whose agents lie outside the fleet is a ValueError, not an
    index error nor an interrupt."""
    _, tparams = params
    with pytest.raises(ValueError, match="outside the fleet"):
        tserving.run_serve_loop(_tspec(rounds=2, serve_events=4).resolve(),
                                tparams, device="cpu",
                                gen=tlg.TraceLoadGen([tlg.Event(0.1, 99, 0)]))


@pytest.mark.parametrize("fields", [
    dict(engine="flat"), dict(fleet_store="host"), dict(chunk_agents=4),
    dict(rsu_sharded=True), dict(tick_trigger="nope"),
    dict(tick_trigger="batch:0"), dict(overload_policy="explode"),
    dict(queue_capacity=-1), dict(arrival_rate=0.0)],
    ids=["flat", "host_store", "chunked", "rsu_sharded", "bad_trigger",
         "empty_trigger", "bad_policy", "negative_capacity", "zero_rate"])
def test_validation_rules(fields):
    """What the reference refuses for a serve-mode spec the port refuses
    with a ValueError."""
    kw = dict(BASE, serve_events=8, **fields)
    with pytest.raises((AssertionError, ValueError)):
        JSpec(**kw).validate()
    with pytest.raises(ValueError):
        TSpec(**kw).validate()
    TSpec(**BASE, serve_events=8).validate()


def test_keys_carry_the_serve_fields():
    """Every serve field is part of ``cache_key`` and ``static_key``, as
    in the reference, so no two serve configurations share a cached
    result or a batched program."""
    base = _tspec(serve_events=8)
    res = base.resolve()
    for field, value in (("serve_events", 16), ("arrival_rate", 2.0),
                         ("tick_trigger", "batch:4"), ("queue_capacity", 8),
                         ("overload_policy", "backpressure"),
                         ("serve_trace", "t.jsonl")):
        other = base.replace(**{field: value})
        assert other.cache_key != base.cache_key, field
        assert dataclasses.replace(res, spec=other).static_key != \
            res.static_key, field
