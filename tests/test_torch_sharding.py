"""``repro_torch/launch/sharding`` and the round's model axis on the CPU,
against the JAX package.

(a) The spec rules: ``param_spec`` (through ``param_shardings`` with each
    config's ``shard_strategy``), ``param_spec_model_only``,
    ``cache_spec``, ``act_spec``, ``act_spec_dp`` and ``batch_spec`` give
    the reference's specs leaf for leaf for all ten architectures, on
    ``AbstractMesh`` (16, 16), (2, 16, 16) and (2, 2, 2) against the
    port's ``ShapeMesh`` of the same shape.
(b) Eight ``gloo`` ranks at (pod 2, data 2, model 2) (one spawn) against
    the reference on 8 forced host devices (one subprocess), the reduced
    qwen3 of ``tests/test_torch_h2fed_round.py`` (``SMALL``, ``HP``) in
    fp32 with the reference's params carried over:
    - ``shard_tree``'s blocks equal the data that the reference's
      ``jax.device_put(x, NamedSharding(mesh, spec))`` puts on the device
      at the same mesh coordinate (found through ``mesh.devices``), bit
      for bit, in the round's layout, the FSDP x TP layout and the
      round's batch layout; ``gather_tree`` inverts ``shard_tree``;
    - the per-leaf and ``quantize_cloud`` rounds match the reference's
      ``make_h2fed_round`` at fp32 1e-5 absolute and relative (plus the
      int8 layer's one-step allowance of ``tests/test_torch_h2fed_round.
      py`` for ``quantize_cloud``), the masses exact;
    - the leaves whole in the compute layout are equal across the model
      ranks bit for bit when the round re-lays them at exit;
    - the counted ``tp``, ``round``, ``lar`` and ``cloud`` collectives
      equal ``round_collectives``'s reckoning, calls and bytes;
    - at two layers (the expert rule splits the MLP's layer axis in the
      round's layout) the re-lay to the compute layout and back is exact.
(c) The refusals at a model axis above 1: ``flat_agg`` (as the
    reference), a dim the axis does not divide, and every family but the
    decoder GQA one.

The module imports no JAX at module level: the spawned ranks import it.
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
from repro_torch.configs import registry as tregistry
from repro_torch.core.h2fed import H2FedParams
from repro_torch.launch import collectives
from repro_torch.launch import sharding as tshard
from repro_torch.launch.h2fed_round import (make_h2fed_round,
                                            round_collectives)
from repro_torch.launch.mesh import FleetMesh, ShapeMesh, run_ranks
from repro_torch.models import model as TM
from repro_torch.models import transformer as ttf
from test_torch_h2fed_round import HP, SMALL, _cfg, _inputs

MESHES = (((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2, 2), ("pod", "data", "model")))
AXES = ("pod", "data", "model")
ROUNDS = {"per_leaf": {}, "quantized": dict(quantize_cloud=True)}
B, S = 2, 16            # the sequences and tokens of ``_inputs``


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread: the tensors are small, and torch's pool
    would compete with JAX's for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jpaths(jtree):
    import jax
    flat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    return [("/".join(str(p) for p in path), leaf) for path, leaf in flat]


@pytest.mark.parametrize("arch", tregistry.ARCH_IDS)
def test_spec_rules_match_the_reference(arch):
    import jax
    from jax.sharding import AbstractMesh
    from repro.configs import registry as jregistry
    from repro.launch import sharding as jshard
    from repro.models import model as JM

    jc, tc = jregistry.get_config(arch), tregistry.get_config(arch)
    jp = jax.eval_shape(lambda: JM.init_params(jc, jax.random.key(0)))
    tp = TM.meta_params(tc)
    # the decode caches of decode_32k (batch 128) and long_500k (batch 1)
    caches = [(jax.eval_shape(lambda b=b: JM.init_cache(jc, b, 64)),
               ttf.stack_init_cache(tc, b, 64, device="meta"))
              for b in (128, 1)]
    acts = [(256, 4096), (16, 16, 4096), (32, 32768), (1, 1), (128,),
            (4, 576, 1024), (3, 8), (32, 2, 4096)]
    for shape, names in MESHES:
        jm, tm = AbstractMesh(shape, names), ShapeMesh(shape, names)
        for rule in ("param_spec", "param_spec_model_only"):
            want = [tuple(getattr(jshard, rule)(p, l.shape, jm))
                    for p, l in _jpaths(jp)]
            got = [getattr(tshard, rule)(p, tuple(l.shape), tm)
                   for p, l in tree.leaves_with_paths(tp)]
            assert got == want, (arch, shape, rule)
        want = [tuple(s.spec) for s in jax.tree.leaves(jshard.param_shardings(
            jp, jm, strategy=jc.shard_strategy))]
        got = [s.spec for s in tree.leaves(tshard.param_shardings(
            tp, tm, strategy=tc.shard_strategy))]
        assert got == want, (arch, shape)
        for jcache, tcache in caches:
            want = [tuple(s.spec) for s in jax.tree.leaves(
                jshard.cache_shardings(jcache, jm))]
            got = [s.spec for s in tree.leaves(
                tshard.cache_shardings(tcache, tm))]
            assert got == want, (arch, shape)
        for a in acts:
            for rule in ("act_spec", "act_spec_dp"):
                assert getattr(tshard, rule)(a, tm) == tuple(
                    getattr(jshard, rule)(a, jm)), (shape, a, rule)
        for ndim in (1, 2, 4):
            assert tshard.batch_spec(ndim, tm) == tuple(
                jshard.batch_spec(ndim, jm))
        assert tshard.replicated(tm).spec == tuple(jshard.replicated(jm).spec)


def _eight_ranks(params, batch, mask, n_data) -> dict:
    """Runs on each of 8 gloo ranks at (2, 2, 2): every rank's blocks of
    each layout (gathered to rank 0), the gather round trip, each round's
    gathered cloud, masses, counted collectives and the compute-layout
    whole leaves that every rank re-lays at exit."""
    mesh = FleetMesh((2, 2, 2), AXES)
    cfg = _cfg("float32")
    layouts = {"model_only": tshard.param_shardings_model_only(params, mesh),
               "fsdp": tshard.param_shardings(params, mesh)}
    mine = {name: tree.leaves(tshard.shard_tree(params, sd))
            for name, sd in layouts.items()}
    stacked = tshard.NamedSharding(mesh, (None, ("pod", "data")))
    mine["batch"] = [stacked.block(torch.as_tensor(batch["tokens"]))]
    for name, sd in layouts.items():
        back = tshard.gather_tree(tshard.shard_tree(params, sd), sd)
        for a, b in zip(tree.leaves(back), tree.leaves(params)):
            assert torch.equal(a, b), name
    out = {"blocks": collectives.all_gather_objects(
        (mesh.coord, mine), mesh, AXES, where="gather")}

    seen = {}
    relay = tshard.ModelAxis.to_storage

    def spy(self, shards, *, where):
        seen["whole"] = [t for t, s in zip(shards, self.split) if not s]
        return relay(self, shards, where=where)
    tshard.ModelAxis.to_storage = spy
    blocks = tshard.shard_tree(params, layouts["model_only"])
    for name, kw in ROUNDS.items():
        collectives.reset()
        fn = make_h2fed_round(cfg, H2FedParams(**HP), mesh, device="cpu",
                              **kw)
        cloud, m = fn(blocks, batch, mask, n_data)
        counts = collectives.counts()
        out[name] = {
            "cloud": tshard.gather_tree(cloud, layouts["model_only"]),
            "mass": float(m["surviving_mass"]),
            "lar_masses": m["lar_masses"].numpy(), "collectives": counts,
            "whole": collectives.all_gather_objects(
                seen["whole"], mesh, "model", where="gather")}
    tshard.ModelAxis.to_storage = relay

    cfg2 = cfg.replace(n_layers=2)
    p2 = TM.init_params(cfg2, torch.Generator().manual_seed(1),
                        device="cpu")
    axis = tshard.ModelAxis(cfg2, mesh)
    stored = [s.block(t).clone() for s, t in zip(axis.storage,
                                                 tree.leaves(p2))]
    comp = axis.to_compute(stored, where="round")
    back = axis.to_storage(comp, where="round")
    out["relay_exact"] = (
        all(torch.equal(a, s.block(t)) for a, s, t in zip(
            comp, axis.compute, tree.leaves(p2)))
        and all(torch.equal(a, b) for a, b in zip(back, stored))
        and any(s.spec[0] == "model" for s in axis.storage))
    return out


J_EIGHT = """
import json, numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.registry import get_reduced_config
from repro.core.h2fed import H2FedParams
from repro.launch import sharding as shard
from repro.launch.h2fed_round import make_h2fed_round
from repro.launch.mesh import make_test_mesh
from repro.models import model as M
cfg = get_reduced_config('qwen3-0.6b', **SMALL).replace(
    dtype='float32', param_dtype='float32')
d = np.load(INPUTS)
batch = {k: jnp.asarray(d[k]) for k in ('tokens', 'labels')}
mesh = make_test_mesh((2, 2, 2))
params = M.init_params(cfg, jax.random.key(0))
out = {'params__' + str(i): np.asarray(l)
       for i, l in enumerate(jax.tree.leaves(params))}
def shards(name, tree, shardings):
    placed = jax.device_put(tree, shardings)
    for i, arr in enumerate(jax.tree.leaves(placed)):
        by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
        for idx in np.ndindex(mesh.devices.shape):
            out[name + '__' + str(i) + '__' + ''.join(map(str, idx))] = \\
                by_dev[mesh.devices[idx]]
shards('model_only', params, shard.param_shardings_model_only(params, mesh))
shards('fsdp', params, shard.param_shardings(params, mesh))
shards('batch', [batch['tokens']],
       [NamedSharding(mesh, P(None, ('pod', 'data')))])
masses = {}
with mesh:
    for name, kw in CASES.items():
        o, m = jax.jit(make_h2fed_round(cfg, H2FedParams(**HP), mesh, **kw))(
            params, batch, jnp.asarray(d['mask']), jnp.asarray(d['n_data']))
        for i, l in enumerate(jax.tree.leaves(o)):
            out[name + '__' + str(i)] = np.asarray(l)
        masses[name] = [float(m['surviving_mass']),
                        np.asarray(m['lar_masses']).tolist()]
np.savez(OUT, **out)
print(json.dumps(masses))
"""


def test_eight_gloo_ranks_match_reference():
    """(pod 2, data 2, model 2): the port over 8 gloo ranks against the
    reference on 8 forced host devices, the same params and inputs; the
    reference's subprocess runs while the ranks do."""
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
        code = (f"SMALL, HP, CASES = {SMALL!r}, {HP!r}, {ROUNDS!r}\n"
                f"INPUTS, OUT = {inputs!r}, {res!r}\n" + J_EIGHT)
        env = dict(os.environ, PYTHONPATH=SRC,
                   XLA_FLAGS="--xla_force_host_platform_device_count=8")
        ref_proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
        got = run_ranks(8, _eight_ranks, params, batch, mask, n_data)
        out, err = ref_proc.communicate(timeout=600)
        assert ref_proc.returncode == 0, err[-4000:]
        masses = json.loads(out.strip().splitlines()[-1])
        ref = dict(np.load(res))
    leaves = tree.leaves(params)
    for i, a in enumerate(leaves):
        np.testing.assert_array_equal(a.numpy(), ref[f"params__{i}"])

    # blocks: every rank's, at its coordinate, bit for bit
    assert len(got["blocks"]) == 8
    for coord, mine in got["blocks"]:
        at = "".join(str(coord[a]) for a in AXES)
        for name, blocks in mine.items():
            for i, blk in enumerate(blocks):
                want = ref[f"{name}__{i}__{at}"]
                assert blk.shape == want.shape, (name, i, at)
                np.testing.assert_array_equal(blk.numpy(), want,
                                              err_msg=f"{name} {i} {at}")

    cfg, hp = _cfg("float32"), H2FedParams(**HP)
    mesh = ShapeMesh((2, 2, 2), AXES)
    for name, kw in ROUNDS.items():
        r = got[name]
        for i, (a, p) in enumerate(zip(tree.leaves(r["cloud"]), leaves)):
            want = ref[f"{name}__{i}"]
            step = (np.abs(want - p.numpy()).max() / 64 if name ==
                    "quantized" else 0.0)
            np.testing.assert_allclose(a.numpy(), want, rtol=1e-5,
                                       atol=1e-5 + step)
        assert r["mass"] == masses[name][0]
        np.testing.assert_array_equal(r["lar_masses"], masses[name][1])
        assert r["collectives"] == round_collectives(
            cfg, hp, mesh, B, S, **kw), name
        first, second = r["whole"]
        assert first and len(first) == len(second)
        for a, b in zip(first, second):
            assert torch.equal(a, b), name
    assert got["relay_exact"]


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "xlstm-125m",
                                  "zamba2-2.7b", "whisper-tiny",
                                  "phi-3-vision-4.2b", "kimi-k2-1t-a32b"])
def test_model_axis_refusals(arch):
    """At a model axis above 1: every family but the decoder GQA one
    raises by name, before any collective."""
    mesh = ShapeMesh((1, 1, 2), AXES)
    cfg = tregistry.get_reduced_config(arch)
    with pytest.raises(NotImplementedError, match="item 11b's remainder"):
        make_h2fed_round(cfg, H2FedParams(**HP), mesh, device="cpu")


def test_model_axis_value_errors():
    """``flat_agg`` (and so the async round and a bf16 fleet) raises as in
    the reference; a dim that the axis does not divide raises naming it."""
    cfg, hp = _cfg("float32"), H2FedParams(**HP)
    mesh = ShapeMesh((1, 1, 2), AXES)
    for kw in (dict(flat_agg=True), dict(flat_agg=True, async_rounds=2),
               dict(flat_agg=True, fleet_dtype="bfloat16")):
        with pytest.raises(ValueError, match="model-axis size 1"):
            make_h2fed_round(cfg, hp, mesh, device="cpu", **kw)
    with pytest.raises(ValueError, match="async_rounds requires flat_agg"):
        make_h2fed_round(cfg, hp, mesh, device="cpu", async_rounds=2)
    with pytest.raises(ValueError, match="n_kv_heads = 2"):
        make_h2fed_round(cfg, hp, ShapeMesh((1, 1, 4), AXES), device="cpu")
    with pytest.raises(ValueError, match="vocab_size = 64"):
        make_h2fed_round(cfg.replace(n_kv_heads=3, n_heads=6, d_ff=96),
                         hp, ShapeMesh((1, 1, 3), AXES), device="cpu")
