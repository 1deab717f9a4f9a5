"""The port's flat H2-Fed round against the JAX package's, on the CPU.

JAX's threefry draws cannot be reproduced by a torch.Generator, so the
reference's own (mask, active_steps) draws, made with the flat round's key
discipline (``round_keys`` over the split round key, connectivity carried
across local and global rounds), are injected into the port through its
draws seam.  Both packages start from the same weights (the JAX init
carried over through numpy) and the same numpy-built data.

Tolerances: fp32 buffers 2e-5 absolute / relative (the packages sum the
per-agent gradients and the aggregation matmuls in different orders, and
~10 SGD steps amplify the last-ulp differences); bf16 buffers 2**-7
relative plus 2**-9 absolute, one bf16 ulp of the stored value, since an
fp32 difference of one ulp can round a stored element either way;
accuracy histories 2e-3 (one of 600 test samples may flip).
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.mnist_mlp import CONFIG as JCONFIG
from repro.core import flatten as jflatten
from repro.core.h2fed import H2FedParams as JHP
from repro.core.heterogeneity import HeterogeneityModel as JHet
from repro.core.heterogeneity import init_conn_state as j_init_conn
from repro.data.partition import scenario_two as j_scenario_two
from repro.data.synthetic import mnist_class_task as j_task
from repro.fedsim import simulator as jsim
from repro.kernels import masked_hier_agg as jmha
from repro.kernels import ops as jops
from repro.models import mlp as jmlp

from repro_torch import convert
from repro_torch.core import flatten as tflatten
from repro_torch.core.h2fed import H2FedParams
from repro_torch.core.heterogeneity import HeterogeneityModel
from repro_torch.core.scenario import ScenarioSpec as TSpec
from repro_torch.data.partition import scenario_two
from repro_torch.data.synthetic import mnist_class_task
from repro_torch.fedsim import pretrain as tpre
from repro_torch.fedsim import simulator as tsim
from repro_torch.fedsim.sweep import run_scenario

A, R, LAR, BATCH, SEED = 8, 2, 2, 16, 3
HP = dict(mu1=0.01, mu2=0.005, lar=LAR, local_epochs=2, lr=0.1)
HET = dict(csr=0.6, scd=2, fsr=0.6, lar=LAR)


@pytest.fixture(scope="module")
def setup():
    j_train, _ = j_task(n_train=1200, n_test=200, seed=0)
    t_train, _ = mnist_class_task(n_train=1200, n_test=200, seed=0)
    jfed = j_scenario_two(j_train, n_agents=A, n_rsus=R, seed=0)
    tfed = scenario_two(t_train, n_agents=A, n_rsus=R, seed=0)
    jparams = jmlp.init_params(JCONFIG, jax.random.key(7))
    return jfed, tfed, jparams


def jax_draws(cfg, hp, het, fed, n_rounds):
    """The reference's per-round draws, in the flat round's key
    discipline, as torch tensors: draws[round][local_round]."""
    spe = max(fed.x.shape[1] // cfg.batch, 1)
    rng, conn, out = jax.random.key(cfg.seed), j_init_conn(cfg.n_agents), []
    for _ in range(n_rounds):
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


def _close(got, want, dtype):
    got = convert.tensor_to_numpy(got)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -9)


def _pallas_routes(monkeypatch):
    """Send the reference's fused entry points to the Pallas kernel in
    interpret mode: off-TPU ``ops.agg_blend`` casts W to the fleet dtype,
    the kernel (and the port) keep it fp32."""
    monkeypatch.setattr(jops, "agg_blend", lambda *a: jmha.agg_blend(
        *a, interpret=True))
    monkeypatch.setattr(jops, "cloud_blend", lambda *a: jmha.cloud_blend(
        *a, interpret=True))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_rounds", [1, 2])
def test_flat_round_parity(setup, monkeypatch, dtype, n_rounds):
    jfed, tfed, jparams = setup
    if dtype == "bfloat16":
        _pallas_routes(monkeypatch)
    jcfg = jsim.SimConfig(n_agents=A, n_rsus=R, batch=BATCH, seed=SEED)
    jhp, jhet = JHP(**HP), JHet(**HET)
    jspec = jflatten.spec_of(jparams, storage_dtype=dtype)
    jstate = jsim.init_flat_state(jcfg, jspec, jparams, jax.random.key(SEED))
    jround = jsim.make_flat_global_round(jcfg, jhp, jhet, jfed, jspec)

    cfg = tsim.SimConfig(n_agents=A, n_rsus=R, batch=BATCH, seed=SEED)
    hp, het = H2FedParams(**HP), HeterogeneityModel(**HET)
    tparams = convert.params_from_jax({k: np.asarray(v)
                                       for k, v in jparams.items()})
    spec = tflatten.spec_of(tparams, storage_dtype=dtype)
    state = tsim.init_flat_state(cfg, spec, tparams, "cpu")
    body = tsim._make_flat_round_body(cfg, hp, het, tfed, spec, device="cpu")
    draws = jax_draws(jcfg, jhp, jhet, jfed, n_rounds)
    # the draws must exercise kept (empty-cohort) rows and partial epochs
    masks = np.stack([m.numpy() for rd in draws for m, _ in rd])
    assert masks.any() and not masks.all()

    for r in range(n_rounds):
        jstate = jround(jstate)
        state = body(state, draws[r])
    assert state.agent_flat.dtype == spec.storage_dtype
    assert state.cloud_flat.dtype == torch.float32
    _close(state.cloud_flat, jstate.cloud_flat, "float32" if dtype ==
           "float32" else dtype)
    _close(state.rsu_flat, jstate.rsu_flat, dtype)
    _close(state.agent_flat, jstate.agent_flat, dtype)


def test_fused_matches_unfused(setup):
    """fused=True and fused=False run the same algebra in the port."""
    _, tfed, jparams = setup
    cfg = tsim.SimConfig(n_agents=A, n_rsus=R, batch=BATCH, seed=SEED)
    hp, het = H2FedParams(**HP), HeterogeneityModel(**HET)
    tparams = convert.params_from_jax({k: np.asarray(v)
                                       for k, v in jparams.items()})
    spec = tflatten.spec_of(tparams)
    outs = []
    for fused in (True, False):
        state = tsim.init_flat_state(cfg, spec, tparams, "cpu")
        body = tsim._make_flat_round_body(cfg, hp, het, tfed, spec,
                                          device="cpu", fused=fused)
        for _ in range(2):
            state = body(state)      # the port's own draws, same seed
        outs.append(state)
    for a, b in zip(outs[0][:3], outs[1][:3]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_pretrain_parity(setup):
    """One OEM epoch from the same weights in the same batch order."""
    from repro.fedsim.pretrain import pretrain_to_target as j_pretrain
    from repro.data.partition import pretrain_split as j_split
    from repro_torch.data.partition import pretrain_split
    _, _, jparams = setup
    j_train, j_test = j_task(n_train=1200, n_test=200, seed=0)
    t_train, t_test = mnist_class_task(n_train=1200, n_test=200, seed=0)
    j_pre, _ = j_split(j_train, (7, 8, 9), frac=0.3, seed=0)
    t_pre, _ = pretrain_split(t_train, (7, 8, 9), frac=0.3, seed=0)
    jp, jacc = j_pretrain(jparams, j_pre, j_test.x, j_test.y,
                          target_acc=1.0, max_epochs=1, seed=5)
    tp, tacc = tpre.pretrain_to_target(
        convert.params_from_jax({k: np.asarray(v) for k, v in
                                 jparams.items()}),
        t_pre, t_test.x, t_test.y, target_acc=1.0, max_epochs=1, seed=5,
        device="cpu")
    assert abs(tacc - jacc) <= 2e-3 + 1e-9
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-4, atol=1e-5)


def test_train_centralized_parity(setup):
    """Plain SGD over a pool, same batch order, with the eval history."""
    from repro.fedsim.pretrain import train_centralized as j_train
    _, _, jparams = setup
    j_tr, j_te = j_task(n_train=400, n_test=100, seed=2)
    t_tr, t_te = mnist_class_task(n_train=400, n_test=100, seed=2)
    jp, jh = j_train(jparams, j_tr, lr=0.05, batch=32, epochs=2, seed=4,
                     x_test=j_te.x, y_test=j_te.y, eval_every=5)
    tp, th = tpre.train_centralized(
        convert.params_from_jax({k: np.asarray(v) for k, v in
                                 jparams.items()}),
        t_tr, lr=0.05, batch=32, epochs=2, seed=4, x_test=t_te.x,
        y_test=t_te.y, eval_every=5, device="cpu")
    np.testing.assert_array_equal(th["step"], jh["step"])
    np.testing.assert_allclose(th["acc"], jh["acc"], atol=2e-3)
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fused", [True, False])
def test_run_scenario_history_parity(fused):
    """run_scenario end to end (resolve -> rounds -> eval) on both
    packages with the reference's draws injected."""
    from repro.core.scenario import ScenarioSpec as JSpec
    from repro.fedsim.sweep import run_scenario as j_run
    kw = dict(n_agents=A, n_rsus=R, batch=BATCH, n_train=1500, n_test=400,
              pretrain_frac=0.2, rounds=3, seed=1, sim_seed=2, fused=fused)
    jspec = JSpec(hp=JHP(**HP), het=JHet(**HET), **kw)
    tspec = TSpec(hp=H2FedParams(**HP), het=HeterogeneityModel(**HET), **kw)
    jres = jspec.resolve()
    jparams = jmlp.init_params(JCONFIG, jax.random.key(11))
    _, jhist = j_run(jres, jparams)
    draws = jax_draws(jres.cfg, jspec.hp, jspec.het, jres.fed, kw["rounds"])
    tparams = convert.params_from_jax({k: np.asarray(v)
                                       for k, v in jparams.items()})
    final, thist = run_scenario(tspec, tparams, device="cpu", draws=draws)
    np.testing.assert_array_equal(thist["round"], jhist["round"])
    np.testing.assert_allclose(thist["acc"], jhist["acc"], atol=2e-3)
    assert set(final.cloud_params) == {"b0", "b1", "w0", "w1"}


def test_spec_fields_match_reference():
    """The port's ScenarioSpec keeps every field of the reference's, so a
    spec round-trips between the packages."""
    from repro.core.scenario import ScenarioSpec as JSpec
    assert ([f.name for f in dataclasses.fields(TSpec)]
            == [f.name for f in dataclasses.fields(JSpec)])
    spec = TSpec(n_agents=6, n_rsus=2, rounds=2)
    assert TSpec.from_json(spec.to_json()) == spec
