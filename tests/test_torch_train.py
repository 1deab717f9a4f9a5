"""The port's LLM training path on the CPU against the JAX package, on the
same numpy inputs and, for models, the reference's params carried across
by ``convert.tree_from_jax``: the optimizers (``optim/sgd``,
``optim/adam``), the adaptive-mu orchestrator, the token streams, the
per-example loss and analytic parameter count, the federated train step,
Eq. 6 over params trees (``ops.dual_proximal_sgd_tree`` against the
reference's Pallas kernel in interpret mode), and the training launcher
(``repro_torch.launch.train``).

Tolerances: optimizers fp32 1e-6; orchestrator, token streams and counts
bit-equal; per-example loss fp32 1e-5; the train step's params and loss
fp32 1e-5 after 3 steps, and in bf16 the bf16 tolerance of
tests/test_torch_transformer.py (0.15 absolute / 0.05 relative on the
loss; the params 5e-3 absolute / relative, the reference's own bf16 round
tolerance); Eq. 6 on bf16 leaves one bf16 ulp (2^-8 relative: the fp32
result may round the other way where the two programs contract the
multiply-adds differently).
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import orchestrator as jorch
from repro.core.h2fed import H2FedParams as JHP
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro.kernels.dual_proximal_sgd import dual_proximal_sgd_tree as j_tree
from repro.launch import steps as jsteps
from repro.models import model as JM
from repro.optim import adam as jadam
from repro.optim import sgd as jsgd

from repro_torch import convert, tree
from repro_torch.configs import registry as tregistry
from repro_torch.core import orchestrator as torch_orch
from repro_torch.core.h2fed import H2FedParams
from repro_torch.data import pipeline as tpipe
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import ops
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import model as TM
from repro_torch.optim import adam as tadam
from repro_torch.optim import sgd as tsgd

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(n_layers=2, d_model=64, d_ff=128, vocab_size=64, n_heads=4,
             n_kv_heads=2)
DTYPES = {"f32": dict(dtype="float32", param_dtype="float32"),
          "bf16": dict(dtype="bfloat16", param_dtype="bfloat16")}
F32 = dict(rtol=1e-5, atol=1e-5)
BF16_PARAMS = dict(rtol=5e-3, atol=5e-3)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread: the tensors are small, and torch's pool
    would compete with JAX's for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(seed: int, shapes=((3, 4), (5,), (2, 3, 2))):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal(shapes[0]).astype(np.float32),
            "b": [rng.standard_normal(shapes[1]).astype(np.float32),
                  {"c": rng.standard_normal(shapes[2]).astype(np.float32)}]}


def _close_trees(got, want, **tol):
    for a, b in zip(tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(convert.tensor_to_numpy(a),
                                   np.asarray(b, np.float32), **tol)


# --------------------------------------------------------------------------
# optimizers and orchestrator
# --------------------------------------------------------------------------

@pytest.mark.parametrize("momentum,wd", [(0.0, 0.0), (0.9, 0.01)])
def test_sgd_matches_reference(momentum, wd):
    w, a1, a2 = (_np_tree(s) for s in (0, 1, 2))
    jc = jsgd.SGDConfig(lr=0.1, momentum=momentum, weight_decay=wd)
    tc = tsgd.SGDConfig(lr=0.1, momentum=momentum, weight_decay=wd)
    jw, tw = jax.tree.map(jnp.asarray, w), convert.tree_from_jax(w)
    js, ts = jsgd.init(jc, jw), tsgd.init(tc, tw)
    anchors_j = ((0.01, jax.tree.map(jnp.asarray, a1)),
                 (0.005, jax.tree.map(jnp.asarray, a2)))
    anchors_t = ((0.01, convert.tree_from_jax(a1)),
                 (0.005, convert.tree_from_jax(a2)))
    for step in range(3):
        g = _np_tree(10 + step)
        jw, js = jsgd.step(jc, jw, jax.tree.map(jnp.asarray, g), js,
                           anchors=anchors_j)
        tw, ts = tsgd.step(tc, tw, convert.tree_from_jax(g), ts,
                           anchors=anchors_t)
    _close_trees(tw, jw, rtol=1e-6, atol=1e-6)
    if momentum:
        _close_trees(ts.momentum, js.momentum, rtol=1e-6, atol=1e-6)


def test_global_norm_and_clip_match_reference():
    g = _np_tree(3)
    tg = convert.tree_from_jax(g)
    jg = jax.tree.map(jnp.asarray, g)
    np.testing.assert_allclose(float(tsgd.global_norm(tg)),
                               float(jsgd.global_norm(jg)), rtol=1e-6)
    for max_norm in (0.5, 100.0):
        _close_trees(tsgd.clip_by_global_norm(tg, max_norm),
                     jsgd.clip_by_global_norm(jg, max_norm),
                     rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adam_matches_reference(wd):
    w, a1 = _np_tree(0), _np_tree(1)
    jc, tc = jadam.AdamConfig(weight_decay=wd), tadam.AdamConfig(
        weight_decay=wd)
    jw, tw = jax.tree.map(jnp.asarray, w), convert.tree_from_jax(w)
    js, ts = jadam.init(jc, jw), tadam.init(tc, tw)
    for step in range(3):
        g = _np_tree(20 + step)
        jw, js = jadam.step(jc, jw, jax.tree.map(jnp.asarray, g), js,
                            anchors=((0.01, jax.tree.map(jnp.asarray, a1)),))
        tw, ts = tadam.step(tc, tw, convert.tree_from_jax(g), ts,
                            anchors=((0.01, convert.tree_from_jax(a1)),))
    _close_trees(tw, jw, rtol=1e-6, atol=1e-6)
    _close_trees(ts.nu, js.nu, rtol=1e-6, atol=1e-6)
    assert ts.count.dtype == torch.int32 and int(ts.count) == int(js.count)


def test_orchestrator_bit_equal():
    base_j, base_t = JHP(mu1=0.001, mu2=0.005), H2FedParams(mu1=0.001,
                                                            mu2=0.005)
    js, ts = jorch.init_state(), torch_orch.init_state()
    jc, tc = jorch.AdaptiveMuConfig(), torch_orch.AdaptiveMuConfig()
    for obs in (1.0, 0.5, 0.05, 0.0, 0.3, 0.95, 0.8):
        jh, jb = jorch.schedule(js, jc, base_j)
        th, tb = torch_orch.schedule(ts, tc, base_t)
        assert (th.mu1, th.mu2, tb) == (jh.mu1, jh.mu2, jb)
        js = jorch.observe_csr(js, jc, obs, 1.0)
        ts = torch_orch.observe_csr(ts, tc, obs, 1.0)
        assert ts.csr_est == js.csr_est


# --------------------------------------------------------------------------
# data and model helpers
# --------------------------------------------------------------------------

def test_token_streams_bit_equal():
    for vocab, n, seed in ((512, 3000, 0), (64, 1000, 105)):
        np.testing.assert_array_equal(
            tsyn.lm_token_task(vocab=vocab, n_tokens=n, seed=seed),
            jsyn.lm_token_task(vocab=vocab, n_tokens=n, seed=seed))
    toks = jsyn.lm_token_task(vocab=64, n_tokens=2000, seed=1)
    jit_, tit = (m.lm_sequences(toks, 3, 16, seed=4) for m in (jpipe, tpipe))
    for _ in range(3):
        (jx, jy), (tx, ty) = next(jit_), next(tit)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "xlstm-125m"])
@pytest.mark.parametrize("reduced", [False, True])
def test_count_params_analytic_matches_reference(arch, reduced):
    get_j = jregistry.get_reduced_config if reduced else jregistry.get_config
    get_t = tregistry.get_reduced_config if reduced else tregistry.get_config
    assert (TM.count_params_analytic(get_t(arch))
            == JM.count_params_analytic(get_j(arch)))


def _configs(dtype: str):
    return (jregistry.get_reduced_config("qwen3-0.6b", **SMALL).replace(
                **DTYPES[dtype]),
            tregistry.get_reduced_config("qwen3-0.6b", **SMALL).replace(
                **DTYPES[dtype]))


def _batch(A: int, b: int, S: int, seed: int, vocab: int = 64):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, vocab, (A, b, S)).astype(np.int32)
    labels[0, 0, :3] = -1            # masked labels
    return {"tokens": rng.integers(0, vocab, (A, b, S)).astype(np.int32),
            "labels": labels}


def test_per_example_loss_matches_reference():
    jcfg, tcfg = _configs("f32")
    jp = JM.init_params(jcfg, jax.random.key(0))
    tp = convert.tree_from_jax(jax.tree.map(np.asarray, jp))
    b = {k: v[0] for k, v in _batch(1, 3, 12, 0).items()}
    jl, _ = JM.per_example_loss(jcfg, jp, jax.tree.map(jnp.asarray, b))
    tl, _ = TM.per_example_loss(tcfg, tp, {k: torch.from_numpy(v)
                                           for k, v in b.items()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_train_step_matches_reference(dtype):
    """Three steps of the federated train step (CSR mask, dual proximal
    momentum update) from the same params and batches."""
    jcfg, tcfg = _configs(dtype)
    hp = dict(mu1=0.05, mu2=0.01, lr=0.1)
    jp = JM.init_params(jcfg, jax.random.key(0))
    tp = convert.tree_from_jax(jax.tree.map(np.asarray, jp))
    jstate = jsteps.TrainState(
        params=jp, momentum=jax.tree.map(
            lambda l: jnp.zeros(l.shape, jnp.float32), jp),
        anchor_rsu=jp, anchor_cloud=jp)
    tstate = tsteps.train_state(tp)
    jstep = jax.jit(jsteps.make_train_step(jcfg, JHP(**hp)))
    tstep = tsteps.make_train_step(tcfg, H2FedParams(**hp), device="cpu")
    mask = np.array([1.0, 0.0, 1.0], np.float32)
    for s in range(3):
        batch = _batch(3, 2, 12, s)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch),
                           jnp.asarray(mask))
        tstate, tm = tstep(tstate, batch, mask)
        loss_tol = F32 if dtype == "f32" else dict(rtol=0.05, atol=0.15)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   **loss_tol)
    tol = F32 if dtype == "f32" else BF16_PARAMS
    _close_trees(tstate.params, jstate.params, **tol)
    _close_trees(tstate.momentum, jstate.momentum,
                 **(F32 if dtype == "f32" else dict(rtol=0.05, atol=0.05)))
    # the anchors are the initial params, untouched by three steps
    for name in ("anchor_rsu", "anchor_cloud"):
        for a, b in zip(tree.leaves(getattr(tstate, name)),
                        jax.tree.leaves(jp)):
            np.testing.assert_array_equal(convert.tensor_to_numpy(a),
                                          np.asarray(b, np.float32))


def test_train_step_leaves_its_input_state():
    _, tcfg = _configs("f32")
    params = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                            device="cpu")
    state = tsteps.train_state(params)
    before = [l.clone() for l in tree.leaves(state)]
    step = tsteps.make_train_step(tcfg, H2FedParams(mu1=0.05, mu2=0.01),
                                  device="cpu")
    new, _ = step(state, _batch(2, 1, 8, 0), np.ones(2, np.float32))
    for a, b in zip(tree.leaves(state), before):
        assert torch.equal(a, b)
    assert not any(torch.equal(a, b) for a, b in zip(
        tree.leaves(new.params), tree.leaves(state.params)))


def test_dual_proximal_sgd_tree_matches_reference():
    """Eq. 6 leaf by leaf on bf16 leaves against the Pallas kernel (in
    interpret mode), the output in each leaf's dtype."""
    import ml_dtypes
    trees = [jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16),
                          _np_tree(s)) for s in range(4)]
    kw = dict(lr=0.1, mu1=0.01, mu2=0.005)
    want = j_tree(*(jax.tree.map(jnp.asarray, t) for t in trees),
                  interpret=True, **kw)
    got = ops.dual_proximal_sgd_tree(
        *(convert.tree_from_jax(t) for t in trees), **kw)
    for a, b in zip(tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == torch.bfloat16 and tuple(a.shape) == b.shape
        np.testing.assert_allclose(convert.tensor_to_numpy(a),
                                   np.asarray(b, np.float32),
                                   rtol=2.0 ** -8, atol=0)


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

LAUNCH = ["--device", "cpu", "--mesh", "1,2,1", "--rounds", "2", "--lar",
          "2", "--seq", "32", "--batch", "2"]


def _lines(out: str, start: str):
    return [l.split(" loss ")[0] + " " + l.split(" csr_obs ")[1]
            for l in out.splitlines() if l.startswith(start)]


def test_launcher_prints_the_reference_schedule(capfd):
    """Two ranks over gloo: ``[done]``, and the same csr_obs / mu= / mass
    lines as the JAX launcher on 2 host devices under --adaptive-mu (the
    losses differ: each package draws its own initial params).  The JAX
    launcher runs while the ranks do."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-m", "repro.launch.train", "--devices", "2",
         *LAUNCH[2:], "--adaptive-mu"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    res = ttrain.main(LAUNCH + ["--adaptive-mu"])
    out = capfd.readouterr().out      # rank 0 prints from its own process
    ref_out, ref_err = ref.communicate(timeout=600)
    assert ref.returncode == 0, ref_err[-2000:]
    assert "[done]" in out and len(res["loss"]) == 2
    assert _lines(out, "[round") == _lines(ref_out, "[round")
    assert res["mu"] == [(0.0, 0.0), (0.0, 0.0)]


def test_launcher_checkpoint_restores_in_serve(tmp_path, capsys):
    """One rank, --ckpt-dir: the cloud params the serve launcher restores
    are the launcher's final ones."""
    from repro_torch.checkpoint import ckpt
    res = ttrain.main(["--device", "cpu", "--mesh", "1,1,1", "--rounds",
                       "2", "--lar", "1", "--seq", "16", "--batch", "1",
                       "--flat-agg", "--ckpt-dir", str(tmp_path)])
    assert ckpt.latest_step(tmp_path) == 2
    restored = ckpt.restore(tmp_path, like=res["cloud"])
    for a, b in zip(tree.leaves(restored), tree.leaves(res["cloud"])):
        assert torch.equal(a, b)
    from repro_torch.launch import serve
    served = serve.main(["--device", "cpu", "--ckpt-dir", str(tmp_path),
                         "--batch", "1", "--prompt-len", "2", "--gen", "1"])
    assert "[ckpt] restored step 2" in capsys.readouterr().out
    assert served["tokens"].shape == (1, 1)


def test_launcher_runs_a_scenario_json(tmp_path, capsys):
    from repro_torch.core.scenario import ScenarioSpec
    spec = ScenarioSpec(n_agents=4, n_rsus=2, n_train=300, n_test=60,
                        rounds=2)
    path = tmp_path / "spec.json"
    path.write_text(spec.to_json())
    res = ttrain.main(["--device", "cpu", "--scenario-json", str(path)])
    out = capsys.readouterr().out
    assert "[done]" in out and len(res["acc"]) == 2
    assert out.count("[round") == 2


def test_launcher_refuses_a_bad_mesh():
    with pytest.raises(SystemExit):
        ttrain.main(["--device", "cpu", "--mesh", "1,2,1", "--devices", "8"])
    with pytest.raises(SystemExit):
        ttrain.main(["--device", "cpu", "--mesh", "2,2"])


def test_finetune_example_runs_on_the_cpu(capsys):
    """``examples/federated_finetune_llm_torch.py`` at one rank, tiny."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "finetune", ROOT / "examples" / "federated_finetune_llm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    res = mod.main(["--device", "cpu", "--mesh", "1,1,1", "--rounds", "1",
                    "--lar", "1", "--epochs", "1", "--seq", "16",
                    "--batch", "1"])
    assert len(res["loss"]) == 1 and np.isfinite(res["loss"][0])
    assert "across 1 agents" in capsys.readouterr().out
