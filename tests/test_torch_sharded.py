"""The port's sharded engines (``repro_torch/fedsim/sharded``, the
rsu-sharded tick of ``fedsim/async_engine``, a sweep over ranks) on the
CPU.

* At one rank, in process and with no process group (every collective the
  identity): the replicated, rsu_sharded (one pod) and ``model_shards=1``
  rounds against the JAX package's ``run_scenario(engine="sharded",
  mesh=make_fleet_mesh(1))``, the reference's draws injected.
* Over 2 and 4 ``gloo`` ranks (``launch.mesh.run_ranks``, one spawn
  each): every mode against the port's own flat round (the reference's
  anchor, ``sharded.py:30-36``), the rsu-sharded tick against the port's
  async engine and, with no delays, against the flat round; the counted
  collectives (none across pods inside the local-round loop, one a round
  in the cloud layer); a sweep laid over the ranks against its cells'
  sequential runs.  At 4 ranks one rsu_sharded case is also held against
  the reference on 4 forced host devices, the reference's draws injected.
* ``ops.block_local_agg``'s plain route against the reference's
  ``masked_hier_agg.block_local_agg`` in interpret mode.

Tolerances: fp32 buffers 1e-5 absolute / relative (the packages, and the
port's ranks, sum in different orders); accuracy histories 2e-3;
in-flight tick counts exact.  bf16 fleets are held only within a tick
elsewhere (ROADMAP.md, queue 3: a one-ulp difference of a stored row can
flip a hidden ReLU unit on the next tick), so the rounds here are fp32.  The rank functions import no
JAX: the spawned ranks import this module.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core.flatten import spec_of
from repro_torch.core.h2fed import H2FedParams
from repro_torch.core.heterogeneity import HeterogeneityModel
from repro_torch.core.scenario import ScenarioSpec as TSpec
from repro_torch.core.topology import make_fleet_mesh
from repro_torch.fedsim import run_scenario, run_scenarios
from repro_torch.fedsim import sharded as tsh
from repro_torch.kernels import ops as tops
from repro_torch.launch import collectives
from repro_torch.launch.mesh import run_ranks

BASE = dict(n_agents=8, n_rsus=4, batch=16, n_train=400, n_test=100,
            rounds=2)
HP = dict(mu1=0.01, mu2=0.005, lar=2, local_epochs=1, lr=0.1)
HET = dict(csr=0.6, scd=1)
DELAYED = dict(max_delay=2, delay_p=0.5)
ASYNC = dict(staleness_decay=0.5, buffer_keep=0.4)
F32 = dict(rtol=1e-5, atol=1e-5)
FLAT = ("agent_flat", "rsu_flat", "cloud_flat")
ASYNC_FIELDS = FLAT + ("rsu_mass", "pending_x", "pending_w", "cloud_macc")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread: the tensors are small, and torch's pool
    threads would otherwise compete with JAX's for the cores when test
    files run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tspec(hp=None, het=None, **kw) -> TSpec:
    return TSpec(**dict(BASE, **kw), hp=H2FedParams(**dict(HP, **(hp or {}))),
                 het=HeterogeneityModel(**dict(HET, **(het or {}))))


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules and weights (imported here, not at the
    top: the spawned ranks import this module)."""
    import jax

    from repro.configs.mnist_mlp import CONFIG
    from repro.models import mlp
    jparams = mlp.init_params(CONFIG, jax.random.key(7))
    tparams = convert.params_from_jax({k: np.asarray(v)
                                       for k, v in jparams.items()})
    return jparams, tparams


def jspec(s: TSpec):
    from repro.core.h2fed import H2FedParams as JHP
    from repro.core.heterogeneity import HeterogeneityModel as JHet
    from repro.core.scenario import ScenarioSpec as JSpec
    kw = {f.name: getattr(s, f.name) for f in dataclasses.fields(s)
          if f.name not in ("hp", "het", "faults")}
    return JSpec(**kw, hp=JHP(**dataclasses.asdict(s.hp)),
                 het=JHet(**dataclasses.asdict(s.het)))


def reference_draws(s: TSpec):
    """The reference's flat draws (its sharded rounds draw the same), as
    torch tensors: draws[round][local round] = (mask, active_steps)."""
    import jax

    from repro.core.heterogeneity import init_conn_state
    from repro.fedsim import simulator as jsim
    res = jspec(s).resolve()
    cfg, hp, het = res.cfg, res.spec.hp, res.spec.het
    spe = max(res.fed.x.shape[1] // cfg.batch, 1)
    rng, conn, out = jax.random.key(cfg.seed), init_conn_state(
        cfg.n_agents), []
    for _ in range(s.rounds):
        rng, k_rounds = jax.random.split(rng)
        keys = jsim.round_keys(k_rounds, hp.lar)
        rd = []
        for i in range(hp.lar):
            conn, mask, act = jsim.round_draws(keys[i], conn, het, hp,
                                               cfg.n_agents, spe)
            rd.append((torch.from_numpy(np.array(mask)),
                       torch.from_numpy(np.array(act))))
        out.append(rd)
    return out


def assert_state(got, want, fields, tol=F32, n=None):
    for k in fields:
        g = convert.tensor_to_numpy(getattr(got, k)) if torch.is_tensor(
            getattr(got, k)) else np.asarray(getattr(got, k))
        w = getattr(want, k)
        w = convert.tensor_to_numpy(w) if torch.is_tensor(w) else \
            np.asarray(w, np.float32)
        if n is not None and g.shape[-1] > n:
            assert not g[..., n:].any(), f"{k}: the padded tail moved"
            g = g[..., :n]
        np.testing.assert_allclose(g, w, err_msg=k, **tol)


# --------------------------------------------------------------------------
# one rank, against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["replicated", "rsu_sharded",
                                  "model_shards_1"])
def test_one_rank_matches_the_reference(ref, mode):
    """The reference's one-device anchor: no process group, the JAX draws
    injected; the returned state is the whole fleet, agents in the
    original order."""
    from repro.fedsim import sweep as jsweep
    from repro.launch import mesh as jmesh
    from repro.core import topology as jtopo
    jparams, tparams = ref
    s = tspec(engine="sharded", rsu_sharded=mode == "rsu_sharded")
    mesh_kw = dict(n_pods=1) if mode == "rsu_sharded" else {}
    jstate, jh = jsweep.run_scenario(
        jspec(s), jparams, mesh=jtopo.make_fleet_mesh(1, **mesh_kw))
    assert jmesh.n_agents(jtopo.make_fleet_mesh(1, **mesh_kw)) == 1
    mesh = None if mode == "model_shards_1" else make_fleet_mesh(1, **mesh_kw)
    collectives.reset()
    state, h = run_scenario(s, tparams, device="cpu", mesh=mesh,
                            draws=reference_draws(s))
    assert collectives.counts() == {}
    assert_state(state, jstate, FLAT)
    np.testing.assert_array_equal(h["round"], jh["round"])
    np.testing.assert_allclose(h["acc"], jh["acc"], atol=2e-3)


def test_empty_rsu_keeps_anchor(ref):
    """An RSU with no agents: the topology builds, the round runs, and its
    row keeps the round's cloud anchor as the flat round's does."""
    _, tparams = ref
    s = tspec(engine="sharded", rsu_sharded=True, het=dict(csr=0.8))
    res = s.resolve()
    assign = np.asarray(res.fed.rsu_assign).copy()
    assign[assign == 1] = 0
    res = dataclasses.replace(res, fed=dataclasses.replace(
        res.fed, rsu_assign=assign))
    topo = tsh.resolve_topology(res.cfg, res.fed,
                                make_fleet_mesh(1, n_pods=1),
                                rsu_sharded=True)
    assert (np.bincount(topo.rsu_assign, minlength=4) == 0).any()
    flat_res = dataclasses.replace(res, spec=s.replace(engine="flat",
                                                       rsu_sharded=False))
    sf, hf = run_scenario(flat_res, tparams, device="cpu")
    st, hs = run_scenario(res, tparams, device="cpu", mesh=topo)
    # both carry the same (R, N) buffer, the empty RSU's row included:
    # it keeps the round's cloud anchor rather than going to zero or NaN
    want = spec_of(tparams).ravel_stacked(sf.rsu_params)
    torch.testing.assert_close(st.rsu_flat, want, **F32)
    assert torch.isfinite(st.rsu_flat).all() and st.rsu_flat[1].any()
    np.testing.assert_allclose(hs["acc"], hf["acc"], atol=2e-3)


@pytest.mark.parametrize("kw,ok", [
    (dict(engine="sharded"), True),
    (dict(engine="sharded", rsu_sharded=True, model_shards=2), True),
    (dict(engine="async", rsu_sharded=True), True),
    (dict(engine="flat", rsu_sharded=True), True),
    (dict(model_shards=2), False),
    (dict(engine="async", model_shards=2), False),
    (dict(engine="sharded", model_shards=2, fleet_store="host"), False),
    (dict(engine="sharded", chunk_agents=4), False),
    (dict(engine="sharded", faults=True), False),
    (dict(engine="async", rsu_sharded=True, faults=True), False),
    (dict(engine="async", rsu_sharded=True, serve_events=8), False)],
    ids=["sharded", "nshard-rsu", "async-rsu", "flat-rsu", "nshard-flat",
         "nshard-async", "nshard-host", "sharded-chunked", "sharded-faults",
         "rsu-faults", "rsu-serve"])
def test_validation_is_the_reference(kw, ok):
    """The sharded fields are accepted and refused as the reference's
    ``ScenarioSpec.validate`` accepts and refuses them."""
    from repro.core.faults import FaultPlan as JPlan
    from repro_torch.core.faults import FaultPlan
    kw = dict(kw)
    faults = kw.pop("faults", False)
    t = tspec(**kw).replace(faults=FaultPlan() if faults else None)
    j = jspec(t.replace(faults=None)).replace(
        faults=JPlan() if faults else None)
    if ok:
        t.validate(), j.validate()
        return
    with pytest.raises((AssertionError, ValueError)):
        j.validate()
    with pytest.raises(ValueError):
        t.validate()


def test_pad_model_axis(ref):
    """A whole flat state padded to lane-aligned model shards: the model in
    the first N columns, zeros after; nothing to do at one shard."""
    from repro_torch.fedsim.simulator import init_flat_state

    class Duck:
        def __init__(self, shape, axes):
            self.shape, self.axis_names = dict(zip(axes, shape)), axes
    _, tparams = ref
    s = tspec()
    fspec = spec_of(tparams)
    state = init_flat_state(s.resolve().cfg, fspec, tparams, "cpu")
    for shards, n_pad in ((1, fspec.n), (2, 32_000), (4, 32_256)):
        topo = tsh.HierarchyTopology(8, 4, Duck((1, shards),
                                                ("data", "model")))
        out = tsh.pad_model_axis(state, topo, fspec.n)
        assert topo.model_pad(fspec.n) == n_pad
        for k in FLAT:
            v = getattr(out, k)
            assert v.shape[-1] == n_pad
            assert torch.equal(v[..., :fspec.n], getattr(state, k))
            assert not v[..., fspec.n:].any()
    assert tsh.pad_model_axis(state, tsh.HierarchyTopology(
        8, 4, Duck((1,), ("data",))), fspec.n) is state


def test_indivisible_agents_raise(ref):
    _, tparams = ref

    class Duck:
        shape, axis_names = {"data": 2}, ("data",)
    s = tspec(n_agents=7)
    res = s.resolve()
    with pytest.raises(ValueError, match="must divide"):
        tsh.make_sharded_global_round(res.cfg, s.hp, s.het, res.fed,
                                      spec_of(tparams), Duck(),
                                      device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_local_agg_plain_matches_reference(dtype):
    """Shard-local ids, zero-weight rows and an RSU with no agents, fp32
    and bf16 rows: (num, mass) against the reference's Pallas kernel in
    interpret mode."""
    import jax.numpy as jnp

    from repro.kernels import masked_hier_agg as jmha
    g = np.random.default_rng(5)
    for A, R, N in ((12, 3, 300), (5, 1, 129), (16, 4, 1000)):
        x = g.standard_normal((A, N)).astype(np.float32)
        w = (g.random(A) + 0.5).astype(np.float32)
        w[::3] = 0.0
        assign = g.integers(0, R, A).astype(np.int32)
        assign[assign == R - 1] = 0 if R > 1 else assign[assign == R - 1]
        xt = torch.from_numpy(x).to(dtype)
        num, mass = tops.block_local_agg(xt, torch.from_numpy(w),
                                         torch.from_numpy(assign).long(), R)
        jx = jnp.asarray(xt.float().numpy()).astype(
            jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
        jnum, jmass = jmha.block_local_agg(jx, jnp.asarray(w),
                                           jnp.asarray(assign), R,
                                           interpret=True)
        assert num.dtype == torch.float32 and num.shape == (R, N)
        np.testing.assert_allclose(num.numpy(), np.asarray(jnum), **F32)
        np.testing.assert_allclose(mass.numpy(), np.asarray(jmass),
                                   rtol=1e-6, atol=0)
        if R > 1:
            assert not num[R - 1].any() and mass[R - 1] == 0


# --------------------------------------------------------------------------
# gloo ranks
# --------------------------------------------------------------------------

def _result(state, hist) -> dict:
    out = {k: getattr(state, k).detach().cpu()
           for k in ASYNC_FIELDS + ("pending_t",) if hasattr(state, k)}
    out["tick"] = getattr(state, "tick", None)
    out["hist"] = hist
    out["counts"] = collectives.counts()
    out["lar_pod"] = collectives.calls("lar", "pod")
    out["lar_data"] = collectives.calls("lar", "data")
    out["cloud_pod"] = collectives.calls("cloud", "pod")
    return out


def rank_cases(cases, params):
    """Runs on every rank: each case is (spec, mesh kwargs, draws); returns
    each case's whole state, history and this rank's collective counts."""
    out = []
    for s, mesh_kw, draws in cases:
        collectives.reset()
        if isinstance(s, list):            # a grid laid over the ranks
            out.append({"hists": run_scenarios(s, params, device="cpu"),
                        "counts": collectives.counts()})
            continue
        state, hist = run_scenario(s, params, device="cpu", draws=draws,
                                   mesh=make_fleet_mesh(**mesh_kw))
        out.append(_result(state, hist))
    return out


def _flat(s, params, draws=None):
    st, h = run_scenario(s.replace(engine="flat", rsu_sharded=False,
                                   model_shards=1), params, device="cpu",
                         draws=draws)
    spec = spec_of(params)

    class Flat:
        agent_flat = spec.ravel_stacked(st.agent_params)
        rsu_flat = spec.ravel_stacked(st.rsu_params)
        cloud_flat = spec.ravel(st.cloud_params)
    return Flat, h


def _check_flat(got, s, params, n):
    want, h = _flat(s, params)
    assert_state(as_state(got), want, FLAT, n=n)
    np.testing.assert_allclose(got["hist"]["acc"], h["acc"], atol=2e-3)


def as_state(d: dict):
    """A rank result's fields as attributes."""
    return type("State", (), d)


SYNC_CASES = {
    # name: (spec overrides, mesh kwargs at world 2, at world 4)
    "replicated": (dict(), dict(), dict()),
    "rsu_sharded": (dict(rsu_sharded=True), dict(n_pods=2), dict(n_pods=2)),
    "nshard": (dict(model_shards=2), dict(n_model_shards=2),
               dict(n_model_shards=2)),
    "nshard_rsu": (dict(model_shards=2, rsu_sharded=True),
                   dict(n_model_shards=2, n_pods=1),
                   dict(n_model_shards=2, n_pods=2)),
}
ASYNC_CASES = {
    "stragglers": (dict(het=DELAYED, **ASYNC), dict(n_pods=2)),
    "cloud_every_3": (dict(het=DELAYED, cloud_every=3, **ASYNC),
                      dict(n_pods=2)),
    "sync_limit": (dict(staleness_decay=1.0, buffer_keep=0.0), dict(n_pods=2)),
}


def _cases(world, params):
    cases, names = [], []
    for name, (kw, m2, m4) in SYNC_CASES.items():
        cases.append((tspec(engine="sharded", **kw), m2 if world == 2 else m4,
                      None))
        names.append(name)
    for name, (kw, mesh_kw) in ASYNC_CASES.items():
        cases.append((tspec(engine="async", rsu_sharded=True, **kw), mesh_kw,
                      None))
        names.append(f"async_{name}")
    return cases, names


def _check_world(world, outs, names, params):
    spec_n = spec_of(params).n
    by = dict(zip(names, outs))
    for name, (kw, *_) in SYNC_CASES.items():
        _check_flat(by[name], tspec(engine="sharded", **kw), params, spec_n)
    # the counted collectives: the RSU layer never crosses pods; the cloud
    # layer crosses them once a round; replicated sums over every agent
    # axis once a local round
    rounds, lar = BASE["rounds"], HP["lar"]
    rs = by["rsu_sharded"]
    assert rs["lar_pod"] == 0 and rs["cloud_pod"] == rounds
    assert rs["lar_data"] == (rounds * lar if world == 4 else 0)
    rep = by["replicated"]
    assert rep["lar_data"] == rounds * lar and rep["cloud_pod"] == 0
    assert by["nshard"]["counts"]["round/model"]["calls"] == rounds
    for name, (kw, _) in ASYNC_CASES.items():
        got = by[f"async_{name}"]
        assert got["lar_pod"] == 0
        s = tspec(engine="async", **kw)
        if name == "sync_limit":
            _check_flat(got, s, params, spec_n)
            continue
        want, wh = run_scenario(s.replace(fused=False), params,
                                device="cpu")
        assert_state(as_state(got), want, ASYNC_FIELDS)
        assert torch.equal(got["pending_t"], want.pending_t)
        assert got["tick"] == want.tick
        for k in ("acc", "absorbed_mass", "pending_mass"):
            np.testing.assert_allclose(got["hist"][k], wh[k], rtol=1e-5,
                                       atol=2e-3 if k == "acc" else 1e-5)
    assert by["async_stragglers"]["cloud_pod"] == rounds
    assert by["async_cloud_every_3"]["cloud_pod"] == rounds * lar // 3


def test_two_gloo_ranks(ref):
    """World 2: replicated (data 2), rsu_sharded (pods 2), N-sharded
    (model 2, alone and with pods 2), the rsu-sharded tick (pods 2), and a
    4-cell grid laid over the ranks (2 cells each) against each cell's
    sequential run."""
    _, tparams = ref
    cases, names = _cases(2, tparams)
    grid = [tspec(het=dict(csr=c)) for c in (0.4, 0.6, 0.8, 1.0)]
    outs = run_ranks(2, rank_cases, cases + [(grid, None, None)], tparams)
    _check_world(2, outs[:-1], names, tparams)
    hists = outs[-1]["hists"]
    assert outs[-1]["counts"] == {"gather/sweep": outs[-1]["counts"][
        "gather/sweep"]} and outs[-1]["counts"]["gather/sweep"]["calls"] == 1
    for s, h in zip(grid, hists):
        want = run_scenario(s, tparams, device="cpu")[1]
        np.testing.assert_array_equal(h["round"], want["round"])
        np.testing.assert_allclose(h["acc"], want["acc"], atol=1e-6)


def test_four_gloo_ranks(ref, forced_devices_run, tmp_path):
    """World 4: replicated (pod 2 x data 2), rsu_sharded (pod 2 x data 2),
    N-sharded (data 2 x model 2, and pod 2 x model 2 rsu_sharded), the
    rsu-sharded tick (pod 2 x data 2); and one rsu_sharded case against
    the reference on 4 forced host devices, the reference's draws
    injected."""
    _, tparams = ref
    cases, names = _cases(4, tparams)
    cross = tspec(engine="sharded", rsu_sharded=True)
    outs = run_ranks(4, rank_cases,
                     cases + [(cross, dict(n_pods=2), reference_draws(cross))],
                     tparams)
    _check_world(4, outs[:-1], names, tparams)
    path = tmp_path / "ref.npz"
    code = f"""
import dataclasses, jax, numpy as np
from repro.configs.mnist_mlp import CONFIG
from repro.core.h2fed import H2FedParams
from repro.core.heterogeneity import HeterogeneityModel
from repro.core.scenario import ScenarioSpec
from repro.core.topology import make_fleet_mesh
from repro.fedsim.sweep import run_scenario
from repro.models import mlp
assert len(jax.devices()) == 4
s = ScenarioSpec(**{dict(BASE)!r}, engine="sharded", rsu_sharded=True,
                 hp=H2FedParams(**{HP!r}), het=HeterogeneityModel(**{HET!r}))
st, h = run_scenario(s, mlp.init_params(CONFIG, jax.random.key(7)),
                     mesh=make_fleet_mesh(4, n_pods=2))
np.savez({str(path)!r}, agent_flat=np.asarray(st.agent_flat),
         rsu_flat=np.asarray(st.rsu_flat), cloud_flat=np.asarray(st.cloud_flat),
         acc=h["acc"])
print("reference-ok")
"""
    assert "reference-ok" in forced_devices_run(code, devices=4, timeout=600)
    want = np.load(path)
    got = outs[-1]
    assert_state(as_state(got), as_state(dict(want)), FLAT)
    np.testing.assert_allclose(got["hist"]["acc"], want["acc"], atol=2e-3)
    assert got["lar_pod"] == 0 and got["cloud_pod"] == BASE["rounds"]
