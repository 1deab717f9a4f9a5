"""The port's LLM hierarchical round (``repro_torch/launch/h2fed_round``)
on the CPU against the JAX package's ``make_h2fed_round``, the reference's
params carried across by ``convert.tree_from_jax``.

* One rank, in process and with no process group (every collective the
  identity), against the JAX round on a (1, 1, 1) mesh: the per-leaf and
  ``flat_agg`` rounds, ``async_rounds`` with injected delays and a kept
  buffer, and the bf16 fleet dtype, in fp32; per-leaf, async and the bf16
  fleet also with bf16 params.
* Four ``gloo`` ranks (2 pods x 2 agents, one spawn) against the JAX round
  on 4 forced host devices (one subprocess): per-leaf, ``flat_agg`` and
  ``quantize_cloud``, and the counted collectives of each.

Tolerances: fp32 params 1e-5 absolute / relative (the two packages sum the
collectives and the attention in different orders); bf16 params 5e-3
absolute / relative, the bf16 tolerance of the reference's own round test
(tests/test_launch.py: a rounding of an agent's bf16 update can fall the
other way, and the bf16 fleet rounds the weighted sum once more);
surviving masses exact.  The int8 cloud layer may round one element's
delta to the neighbouring step, so ``quantize_cloud`` adds a step at
either rounding (the leaf's largest update over 64, about two of the 127
steps of its delta's range) to the fp32 tolerance.  The module imports no JAX at
module level: the spawned ranks import it.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from repro_torch import convert, tree
from repro_torch.configs.registry import get_reduced_config
from repro_torch.core.h2fed import H2FedParams
from repro_torch.launch import collectives
from repro_torch.launch.h2fed_round import comm_model, make_h2fed_round
from repro_torch.launch.mesh import FleetMesh, run_ranks

SMALL = dict(n_layers=1, d_model=64, d_ff=128, vocab_size=64, n_heads=4,
             n_kv_heads=2)
HP = dict(mu1=0.05, mu2=0.01, lar=2, local_epochs=2, lr=0.1)
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=5e-3, rtol=5e-3)}
ONE_RANK = {"per_leaf": {}, "flat": dict(flat_agg=True),
            "async": dict(flat_agg=True, async_rounds=2, buffer_keep=0.5),
            "bf16_fleet": dict(flat_agg=True, fleet_dtype="bfloat16")}
FOUR_RANK = {"per_leaf": {}, "flat": dict(flat_agg=True),
             "quantized": dict(quantize_cloud=True)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread: the tensors are small, and torch's pool
    would compete with JAX's for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(dtype: str):
    return get_reduced_config("qwen3-0.6b", **SMALL).replace(
        dtype=dtype, param_dtype=dtype)


def _inputs(A: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(0, 64, (HP["lar"], A, 2, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    mask = rng.integers(0, 2, (HP["lar"], A)).astype(np.float32)
    mask[:, 0] = 1.0
    n_data = rng.uniform(1, 3, (A,)).astype(np.float32)
    delays = rng.integers(0, 3, (HP["lar"], A)).astype(np.int32)
    delays[0, 0] = 1            # one agent is in flight at the first tick
    return batch, mask, n_data, delays


def _close(got, want, dtype):
    for a, b in zip(tree.leaves(got), want):
        np.testing.assert_allclose(convert.tensor_to_numpy(a),
                                   np.asarray(b, np.float32), **TOL[dtype])


@pytest.mark.parametrize("case,dtype", [
    *((c, "float32") for c in ONE_RANK), ("per_leaf", "bfloat16"),
    ("async", "bfloat16"), ("bf16_fleet", "bfloat16")])
def test_one_rank_matches_reference(case, dtype):
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_reduced_config as j_cfg
    from repro.core.h2fed import H2FedParams as JHP
    from repro.launch.h2fed_round import make_h2fed_round as j_round
    from repro.launch.mesh import make_test_mesh
    from repro.models import model as JM

    kw = ONE_RANK[case]
    jcfg = j_cfg("qwen3-0.6b", **SMALL).replace(dtype=dtype,
                                               param_dtype=dtype)
    jp = JM.init_params(jcfg, jax.random.key(0))
    tp = convert.tree_from_jax(jax.tree.map(np.asarray, jp))
    batch, mask, n_data, delays = _inputs(1)
    extra = (delays,) if kw.get("async_rounds") else ()
    mesh = make_test_mesh((1, 1, 1))
    with mesh:
        jo, jm = jax.jit(j_round(jcfg, JHP(**HP), mesh, **kw))(
            jp, jax.tree.map(jnp.asarray, batch), jnp.asarray(mask),
            jnp.asarray(n_data), *map(jnp.asarray, extra))
    fn = make_h2fed_round(_cfg(dtype), H2FedParams(**HP), device="cpu", **kw)
    to, tm = fn(tp, batch, mask, n_data, *extra)
    _close(to, jax.tree.leaves(jo), dtype)
    assert float(tm["surviving_mass"]) == float(jm["surviving_mass"])
    np.testing.assert_array_equal(tm["lar_masses"].numpy(),
                                  np.asarray(jm["lar_masses"]))
    # the params handed in are left as they were
    for a, b in zip(tree.leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(convert.tensor_to_numpy(a),
                                      np.asarray(b, np.float32))


def test_refusals():
    cfg, hp = _cfg("float32"), H2FedParams(**HP)
    with pytest.raises(ValueError):
        make_h2fed_round(cfg, hp, device="cpu", flat_agg=True,
                         quantize_cloud=True)
    with pytest.raises(ValueError):
        make_h2fed_round(cfg, hp, device="cpu", async_rounds=2)
    with pytest.raises(ValueError):
        make_h2fed_round(cfg, hp, device="cpu", fleet_dtype="bfloat16")
    with pytest.raises(ValueError, match="model-axis size 1"):
        make_h2fed_round(cfg, hp, device="cpu", flat_agg=True,
                         mesh=type("M", (), {"shape": {"pod": 1, "data": 1,
                                                       "model": 2},
                                             "axis_names": ("pod", "data",
                                                            "model")})())


def _four_rank_cases(params, batch, mask, n_data) -> dict:
    """Runs on each of 4 gloo ranks: every FOUR_RANK case's new cloud and
    masses, and the collectives each made on this rank."""
    mesh = FleetMesh((2, 2, 1), ("pod", "data", "model"))
    out = {}
    for name, kw in FOUR_RANK.items():
        collectives.reset()
        fn = make_h2fed_round(_cfg("float32"), H2FedParams(**HP), mesh,
                              device="cpu", **kw)
        cloud, m = fn(params, batch, mask, n_data)
        out[name] = {"cloud": cloud, "mass": float(m["surviving_mass"]),
                     "lar_masses": m["lar_masses"].numpy(),
                     "collectives": collectives.counts()}
    return out


J_FOUR_RANK = """
import json, numpy as np, jax, jax.numpy as jnp
from repro.configs.registry import get_reduced_config
from repro.core.h2fed import H2FedParams
from repro.launch.h2fed_round import make_h2fed_round
from repro.launch.mesh import make_test_mesh
from repro.models import model as M
cfg = get_reduced_config('qwen3-0.6b', **SMALL).replace(
    dtype='float32', param_dtype='float32')
d = np.load(INPUTS)
batch = {k: jnp.asarray(d[k]) for k in ('tokens', 'labels')}
mesh = make_test_mesh((2, 2, 1))
params = M.init_params(cfg, jax.random.key(0))
out = {'params': [np.asarray(l) for l in jax.tree.leaves(params)]}
with mesh:
    for name, kw in CASES.items():
        o, m = jax.jit(make_h2fed_round(cfg, H2FedParams(**HP), mesh, **kw))(
            params, batch, jnp.asarray(d['mask']), jnp.asarray(d['n_data']))
        out[name] = [np.asarray(l) for l in jax.tree.leaves(o)]
        out[name + '_mass'] = float(m['surviving_mass'])
np.savez(OUT, **{k + '__' + str(i): a for k, v in out.items()
                 if isinstance(v, list) for i, a in enumerate(v)})
print(json.dumps({k: v for k, v in out.items() if k.endswith('_mass')}))
"""


def test_four_gloo_ranks_match_reference():
    """2 pods x 2 agents: the port over 4 gloo ranks against the reference
    on 4 forced host devices, the same params and inputs.  The reference's
    subprocess runs while the ranks do."""
    import jax
    from repro.configs.registry import get_reduced_config as j_cfg
    from repro.models import model as JM
    from conftest import SRC
    batch, mask, n_data, _ = _inputs(4, seed=1)
    jcfg = j_cfg("qwen3-0.6b", **SMALL).replace(dtype="float32",
                                               param_dtype="float32")
    jp = JM.init_params(jcfg, jax.random.key(0))
    params = convert.tree_from_jax(jax.tree.map(np.asarray, jp))
    with tempfile.TemporaryDirectory() as tmp:
        inputs, res = os.path.join(tmp, "in.npz"), os.path.join(tmp, "o.npz")
        np.savez(inputs, mask=mask, n_data=n_data, **batch)
        code = (f"SMALL, HP, CASES = {SMALL!r}, {HP!r}, {FOUR_RANK!r}\n"
                f"INPUTS, OUT = {inputs!r}, {res!r}\n" + J_FOUR_RANK)
        env = dict(os.environ, PYTHONPATH=SRC,
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
        ref_proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
        got = run_ranks(4, _four_rank_cases, params, batch, mask, n_data)
        out, err = ref_proc.communicate(timeout=600)
        assert ref_proc.returncode == 0, err[-4000:]
        masses = json.loads(out.strip().splitlines()[-1])
        ref = dict(np.load(res))
    n_leaves = len(tree.leaves(params))
    leaves = lambda name: [ref[f"{name}__{i}"] for i in range(n_leaves)]
    for a, b in zip(tree.leaves(params), leaves("params")):
        np.testing.assert_array_equal(a.numpy(), b)
    for name in FOUR_RANK:
        if name == "quantized":
            for a, b, p in zip(tree.leaves(got[name]["cloud"]),
                               leaves(name), leaves("params")):
                step = np.abs(b - p).max() / 64
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                           atol=1e-5 + step)
        else:
            _close(got[name]["cloud"], leaves(name), "float32")
        assert got[name]["mass"] == masses[name + "_mass"]
        colls = got[name]["collectives"]
        assert sum(c["calls"] for k, c in colls.items()
                   if k.startswith("lar/") and "pod" in k) == 0
        pod_calls = sum(c["calls"] for k, c in colls.items()
                        if k.startswith("cloud/pod"))
        n_leaf = len(tree.leaves(params))
        data_calls = colls["lar/data"]["calls"]
        # the pod mass, then each layer's mass and sums: one sum a leaf
        # (per-leaf), one of the raveled buffer (flat), or a max and a sum
        # a leaf (quantized, which takes the pod mass as its own)
        if name == "flat":
            assert (data_calls, pod_calls) == (2 * HP["lar"], 3)
        elif name == "per_leaf":
            assert data_calls == HP["lar"] * (1 + n_leaf)
            assert pod_calls == 2 + n_leaf
        else:
            assert data_calls == HP["lar"] * (1 + n_leaf)
            assert pod_calls == 1 + 2 * n_leaf


def test_comm_model_counts_the_reference_bytes():
    """The analytical model's bytes at the qwen3-0.6b width: LAR ring
    all-reduces over the data axis, one over the pods."""
    from repro_torch.configs.registry import get_config
    mesh = type("M", (), {"shape": {"pod": 2, "data": 4, "model": 1}})()
    cm = comm_model(get_config("qwen3-0.6b"), H2FedParams(lar=4), mesh)
    p = 596_042_752 * 4
    assert cm["ici_bytes_per_dev"] == 4 * 2 * 3 / 4 * p
    assert cm["dci_bytes_per_dev"] == 2 * 1 / 2 * p
