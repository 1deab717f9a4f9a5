"""Training zamba2-2.7b and phi-3-vision-4.2b in the port on the CPU against
the JAX package: the reduced configs' federated train step
(``launch/steps.make_train_step``), their hierarchical round at one rank
(``launch/h2fed_round.make_h2fed_round``) against the reference's on a
(1, 1, 1) mesh, phi-3-vision's batches carrying ``patch_embeds``, and the
training launcher on zamba2 (``repro_torch.launch.train --arch
zamba2-2.7b``).  The reference's params (made from ``jax.random.key``:
its zamba init reshapes split keys, which raw ``PRNGKey`` arrays do not
allow) are carried across by ``convert.tree_from_jax``, the batches made
from numpy seeds.  zamba2 differentiates its Mamba-2 SSD and the shared
attention block applied before every Mamba run; phi-3-vision its patch
projection and backbone.

Tolerances: the train step's params and loss fp32 1e-5 after 3 steps
(``tests/test_torch_train.py``'s) and its momentum, the running sum of
raw gradients, fp32 1e-4 (``tests/test_torch_zamba.py``'s model
tolerance: the port takes the SSD's carry in closed form where the
reference scans, and its gradient sums in another order, 2.6e-5 at most
here).  In bf16 the loss at that file's bf16 tolerance (0.15 absolute /
0.05 relative) and the params two ways: each leaf's update (final less
initial params) as near the reference's fp32 run from the same bf16
params as the reference's own bf16 run is, within 1.5x its 2-norm gap
(and 1e-3 of the update's norm for leaves where both are exact); and
phi-3-vision's params elementwise at 5e-3 absolute / relative (the
reference's own bf16 round tolerance).  zamba2's bf16 params are not held
elementwise to the reference's bf16 run: on the reduced zamba2 both
packages' bf16 gradients lie about 5% (2-norm, every leaf) from the fp32
gradient and as far from each other, so after 3 steps a leaf of the two
bf16 runs differs by 10-15% of its update, past 5e-3 on half the leaves,
while each is as near the fp32 run as the other.  The round's params fp32
1e-5 (``tests/test_torch_h2fed_round.py``'s) and the surviving and
per-LAR masses exact.
"""
from __future__ import annotations

import functools
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
from repro.core.h2fed import H2FedParams as JHP
from repro.launch import steps as jsteps
from repro.launch.h2fed_round import make_h2fed_round as j_round
from repro.launch.mesh import make_test_mesh
from repro.models import model as JM

from repro_torch import convert, tree
from repro_torch.configs import registry as tregistry
from repro_torch.core.h2fed import H2FedParams
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.launch.h2fed_round import make_h2fed_round

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("zamba2-2.7b", "phi-3-vision-4.2b")
DTYPES = {"f32": dict(dtype="float32", param_dtype="float32"),
          "bf16": dict(dtype="bfloat16", param_dtype="bfloat16")}
F32 = dict(rtol=1e-5, atol=1e-5)
F32_MOMENTUM = dict(rtol=1e-4, atol=1e-4)
BF16_LOSS = dict(rtol=0.05, atol=0.15)
# elementwise against the reference's bf16 run (see above: not zamba2)
BF16_PARAMS = {"phi-3-vision-4.2b": dict(rtol=5e-3, atol=5e-3)}
BF16_GAP = 1.5          # the port's update gap / the reference's bf16 one
HP_STEP = dict(mu1=0.05, mu2=0.01, lr=0.1)
HP_ROUND = dict(mu1=0.05, mu2=0.01, lar=2, local_epochs=2, lr=0.1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread: the tensors are small, and torch's pool
    would compete with JAX's for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(arch: str, dtype: str):
    """(JAX config, the port's, JAX params, the port's carried across)."""
    jc = jregistry.get_reduced_config(arch).replace(**DTYPES[dtype])
    tc = tregistry.get_reduced_config(arch).replace(**DTYPES[dtype])
    jp = jax.jit(lambda k: JM.init_params(jc, k))(jax.random.key(0))
    return jc, tc, jp, convert.tree_from_jax(jax.tree.map(np.asarray, jp))


def _batch(cfg, lead, S: int, seed: int) -> dict:
    """Tokens and labels (some masked) of shape ``lead + (S,)``, and for
    the VLM the patch embeddings ``lead + (P, d_embed)`` fp32."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, lead + (S,)).astype(np.int32)
    labels.reshape(-1, S)[0, :3] = -1
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  lead + (S,)).astype(np.int32),
           "labels": labels}
    if cfg.encoder.kind == "vision":
        out["patch_embeds"] = rng.standard_normal(
            lead + (cfg.encoder.n_positions, cfg.encoder.d_embed)).astype(
                np.float32)
    return out


def _close_trees(got, want, **tol):
    for a, b in zip(tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(convert.tensor_to_numpy(a),
                                   np.asarray(b, np.float32), **tol)


MASK = np.array([1.0, 0.0, 1.0], np.float32)


@functools.lru_cache(maxsize=None)
def _jax_step(jc):
    """The reference's jitted train step for ``jc`` (built once, so that
    the fp32 run beside a bf16 test reuses the fp32 test's program)."""
    return jax.jit(jsteps.make_train_step(jc, JHP(**HP_STEP)))


def _jax_steps(jc, jp, batches):
    """The reference's train step over ``batches`` from ``jp``: (final
    state, losses)."""
    state = jsteps.TrainState(
        params=jp, momentum=jax.tree.map(
            lambda l: jnp.zeros(l.shape, jnp.float32), jp),
        anchor_rsu=jp, anchor_cloud=jp)
    step = _jax_step(jc)
    losses = []
    for batch in batches:
        state, m = step(state, jax.tree.map(jnp.asarray, batch),
                        jnp.asarray(MASK))
        losses.append(float(m["loss"]))
    return state, losses


def _update_gap(final, init, truth) -> np.ndarray:
    """Per leaf, ||(final - init) - (truth - init)|| / ||truth - init||."""
    out = []
    for a, p, t in zip(final, init, truth):
        a, p, t = (np.asarray(x, np.float64) for x in (a, p, t))
        out.append(np.linalg.norm(a - t) / np.linalg.norm(t - p))
    return np.array(out)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, dtype):
    """Three steps of the federated train step (CSR mask [1, 0, 1], dual
    proximal momentum update) from the same params and batches: zamba2's
    gradient sums over the shared block's applications, phi-3-vision's
    reaches ``patch_proj`` through the merged patch embeddings."""
    jc, tc, jp, tp = _models(arch, dtype)
    batches = [_batch(tc, (3, 2), 24, s) for s in range(3)]
    jstate, jlosses = _jax_steps(jc, jp, batches)
    tstate = tsteps.train_state(tp)
    tstep = tsteps.make_train_step(tc, H2FedParams(**HP_STEP), device="cpu")
    for batch, jloss in zip(batches, jlosses):
        tstate, tm = tstep(tstate, batch, MASK)
        assert np.isfinite(float(tm["loss"]))
        np.testing.assert_allclose(
            float(tm["loss"]), jloss,
            **(F32 if dtype == "f32" else BF16_LOSS))
    if dtype == "f32":
        _close_trees(tstate.params, jstate.params, **F32)
        _close_trees(tstate.momentum, jstate.momentum, **F32_MOMENTUM)
    else:
        # the reference's fp32 run from the same (bf16) params
        truth, _ = _jax_steps(
            jc.replace(**DTYPES["f32"]),
            jax.tree.map(lambda l: l.astype(jnp.float32), jp), batches)
        init = [np.asarray(l, np.float32) for l in jax.tree.leaves(jp)]
        want = [np.asarray(l, np.float32) for l in
                jax.tree.leaves(truth.params)]
        port = _update_gap([convert.tensor_to_numpy(l) for l in
                            tree.leaves(tstate.params)], init, want)
        ref = _update_gap([np.asarray(l, np.float32) for l in
                           jax.tree.leaves(jstate.params)], init, want)
        worse = port > BF16_GAP * ref + 1e-3
        assert not worse.any(), [
            (path, g, r) for (path, _), g, r, w in zip(
                tree.leaves_with_paths(tp), port, ref, worse) if w]
        if arch in BF16_PARAMS:
            _close_trees(tstate.params, jstate.params, **BF16_PARAMS[arch])
    # every leaf moved: the gradient reached the shared block and the
    # patch projection
    moved = [not np.array_equal(convert.tensor_to_numpy(a),
                                np.asarray(b, np.float32))
             for a, b in zip(tree.leaves(tstate.params), jax.tree.leaves(jp))]
    assert all(moved), [p for p, m in zip(tree.leaves_with_paths(tp), moved)
                        if not m]
    if arch == "phi-3-vision-4.2b":
        assert "patch_proj" in tstate.params


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_round_matches_reference(arch):
    """One round at one rank (LAR 2, E 2, the per-leaf path) against the
    reference's round on a (1, 1, 1) mesh, in fp32; the batch is (LAR, A,
    b, ...) with phi-3-vision's ``patch_embeds`` beside the tokens."""
    jc, tc, jp, tp = _models(arch, "f32")
    batch = _batch(tc, (HP_ROUND["lar"], 1, 2), 16, 7)
    rng = np.random.default_rng(7)
    mask = np.ones((HP_ROUND["lar"], 1), np.float32)
    n_data = rng.uniform(1, 3, (1,)).astype(np.float32)
    mesh = make_test_mesh((1, 1, 1))
    with mesh:
        jo, jm = jax.jit(j_round(jc, JHP(**HP_ROUND), mesh))(
            jp, jax.tree.map(jnp.asarray, batch), jnp.asarray(mask),
            jnp.asarray(n_data))
    fn = make_h2fed_round(tc, H2FedParams(**HP_ROUND), device="cpu")
    to, tm = fn(tp, batch, mask, n_data)
    _close_trees(to, jo, **F32)
    assert float(tm["surviving_mass"]) == float(jm["surviving_mass"])
    np.testing.assert_array_equal(tm["lar_masses"].numpy(),
                                  np.asarray(jm["lar_masses"]))
    assert not all(np.array_equal(convert.tensor_to_numpy(a),
                                  np.asarray(b, np.float32))
                   for a, b in zip(tree.leaves(to), jax.tree.leaves(jp)))


LAUNCH = ["--arch", "zamba2-2.7b", "--reduced", "--mesh", "1,1,1",
          "--rounds", "2", "--lar", "2", "--seq", "32", "--batch", "2",
          "--adaptive-mu"]


def _lines(out: str, start: str):
    return [l.split(" loss ")[0] + " " + l.split(" csr_obs ")[1]
            for l in out.splitlines() if l.startswith(start)]


def test_launcher_trains_zamba2_on_the_reference_schedule(capfd):
    """``repro_torch.launch.train --arch zamba2-2.7b`` at one rank on the
    CPU: ``[done]``, finite eval losses, and the same csr_obs / mu= / mass
    lines as the JAX launcher on one host device under --adaptive-mu (the
    losses differ: each package draws its own initial params).  The JAX
    launcher runs while the port's does."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-m", "repro.launch.train", "--devices", "1",
         *LAUNCH], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env)
    res = ttrain.main(["--device", "cpu", *LAUNCH])
    out = capfd.readouterr().out
    ref_out, ref_err = ref.communicate(timeout=600)
    assert ref.returncode == 0, ref_err[-2000:]
    assert "[done]" in out and len(res["loss"]) == 2
    assert np.isfinite([res["init_loss"], *res["loss"]]).all()
    assert _lines(out, "[round") == _lines(ref_out, "[round")
    assert len(_lines(out, "[round")) == 2
