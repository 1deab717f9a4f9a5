"""The port's xLSTM (reduced xlstm-125m: 7 layers, d_model 256, 4 heads,
so sLSTM P=64 and mLSTM P=128) on the CPU against the JAX package, with the
JAX params carried across by ``convert.tree_from_jax`` and inputs made
from a numpy seed: the plain sLSTM scan, the mLSTM and sLSTM blocks, the
model's forward, loss, prefill step and decode, the serve launcher and the
checkpoint reader.

Tolerances:
- the plain sLSTM scan against the Pallas kernel (interpret mode) and JAX's
  ``slstm_scan_ref``: atol 2e-5 / rtol 1e-5, and 5e-5 / 1e-4 with
  saturated gates (inputs x25), those of tests/test_slstm_kernel.py (fp32
  sums of P terms in another order, carried through the recurrence);
- one mLSTM step 1e-5; mLSTM prefill, per-step and chunkwise (chunk 16 and
  128 on ragged S), atol 5e-5 / rtol 1e-4, tests/test_xlstm_chunkwise.py's;
- blocks and the model: fp32 1e-4 absolute / relative on outputs, logits
  and loss; bf16 atol 0.15 / rtol 0.05, the bf16 tolerance of
  tests/test_arch_smoke.py (bf16 rounds at other places in the two
  frameworks, and JAX's sLSTM prefill rounds h and h @ R to bf16 each step
  where the port's scan keeps them fp32);
- decode against the port's own prefill: the same 1e-4 / 0.15-0.05.
"""
from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import registry as jregistry
from repro.kernels.ref import slstm_scan_ref as jax_slstm_scan_ref
from repro.kernels.slstm_scan import slstm_scan as jax_slstm_scan
from repro.launch import steps as jsteps
from repro.models import model as JM
from repro.models import xlstm as JX

from repro_torch import convert, tree
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs import registry as tregistry
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as TM
from repro_torch.models import xlstm as TX

ARCH = "xlstm-125m"
SCAN = dict(atol=2e-5, rtol=1e-5)
SCAN_SATURATED = dict(atol=5e-5, rtol=1e-4)
CHUNK = dict(atol=5e-5, rtol=1e-4)
F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=0.05, atol=0.15)
DTYPES = {"f32": dict(dtype="float32", param_dtype="float32"),
          "bf16": dict(dtype="bfloat16", param_dtype="bfloat16")}


def _configs(dtype: str, **kw):
    return (jregistry.get_reduced_config(ARCH).replace(**DTYPES[dtype], **kw),
            tregistry.get_reduced_config(ARCH).replace(**DTYPES[dtype], **kw))


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _t(a):
    return convert.tensor_from_numpy(np.asarray(a))


def _close(got, want, tol):
    np.testing.assert_allclose(convert.tensor_to_numpy(got),
                               np.asarray(want, np.float32), **tol)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


# --------------------------------------------------------------------------
# the plain sLSTM scan (kernel #5's plain version)
# --------------------------------------------------------------------------

def _scan_inputs(B, S, H, P, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    d = H * P
    wx = (rng.standard_normal((B, S, 4 * d)) * scale).astype(np.float32)
    r = (rng.standard_normal((H, P, 4 * P)) * P ** -0.5).astype(np.float32)
    b = (rng.standard_normal(4 * d) * 0.1).astype(np.float32)
    return wx, r, b


@pytest.mark.parametrize("B,S,H,P", [(1, 17, 2, 32), (2, 100, 4, 64),
                                     (3, 256, 4, 32), (1, 64, 8, 16)])
def test_slstm_scan_ref_matches_pallas_and_jax_ref(B, S, H, P):
    wx, r, b = _scan_inputs(B, S, H, P)
    got = ref.slstm_scan_ref(_t(wx), _t(r), _t(b))
    assert got.shape == (B, S, H * P) and got.dtype == torch.float32
    pallas = jax_slstm_scan(jnp.asarray(wx), jnp.asarray(r), jnp.asarray(b),
                            block_s=16, interpret=True)
    _close(got, pallas, SCAN)
    _close(got, jax_slstm_scan_ref(jnp.asarray(wx), jnp.asarray(r),
                                   jnp.asarray(b)), SCAN)


def test_slstm_scan_ref_saturated_gates():
    """Pre-activations x25: the soft cap and the stabilizer keep both
    finite, and they still agree."""
    wx, r, b = _scan_inputs(2, 48, 4, 32, seed=1, scale=25.0)
    got = ref.slstm_scan_ref(_t(wx), _t(r), _t(b))
    assert torch.isfinite(got).all()
    pallas = jax_slstm_scan(jnp.asarray(wx), jnp.asarray(r), jnp.asarray(b),
                            block_s=16, interpret=True)
    _close(got, pallas, SCAN_SATURATED)


def test_slstm_scan_ref_batch_rows_independent():
    """Each batch row equals its own scan (the state starts afresh)."""
    wx, r, b = _scan_inputs(3, 40, 2, 32, seed=2)
    full = ref.slstm_scan_ref(_t(wx), _t(r), _t(b))
    for i in range(3):
        solo = ref.slstm_scan_ref(_t(wx[i:i + 1]), _t(r), _t(b))
        np.testing.assert_allclose(full[i:i + 1].numpy(), solo.numpy(),
                                   atol=1e-6)


def test_slstm_scan_ref_bf16_weights_and_cpu_route():
    """bf16 R is widened exactly, as in JAX's reference; ``ops`` sends CPU
    tensors to the plain version, with no launch counted."""
    wx, r, b = _scan_inputs(2, 33, 4, 16, seed=3)
    r_bf16 = jnp.asarray(r).astype(jnp.bfloat16)
    got = ref.slstm_scan_ref(_t(wx), _t(np.asarray(r_bf16)), _t(b))
    _close(got, jax_slstm_scan_ref(jnp.asarray(wx), r_bf16, jnp.asarray(b)),
           SCAN)
    before = ops.launch_counts()["slstm_scan"]
    routed = ops.slstm_scan(_t(wx), _t(np.asarray(r_bf16)), _t(b))
    assert torch.equal(routed, got)
    assert ops.launch_counts()["slstm_scan"] == before


# --------------------------------------------------------------------------
# mLSTM and sLSTM blocks
# --------------------------------------------------------------------------

def test_mlstm_step_matches_jax():
    jcfg, _ = _configs("f32")
    _, H, P = JX._mlstm_dims(jcfg)
    rng = np.random.default_rng(4)
    B = 2
    state = (rng.standard_normal((B, H, P, P)).astype(np.float32) * 0.1,
             rng.standard_normal((B, H, P)).astype(np.float32) * 0.1,
             rng.standard_normal((B, H)).astype(np.float32))
    qkvif = tuple(rng.standard_normal(s).astype(np.float32)
                  for s in ((B, H, P),) * 3 + ((B, H),) * 2)
    jstate, jh = JX._mlstm_step(JX.MLSTMState(*map(jnp.asarray, state)),
                                tuple(map(jnp.asarray, qkvif)))
    tstate, th = TX._mlstm_step(TX.MLSTMState(*map(_t, state)),
                                tuple(map(_t, qkvif)))
    tol = dict(atol=1e-5, rtol=1e-5)
    _close(th, jh, tol)
    for got, want in zip(tstate, jstate):
        _close(got, want, tol)


@pytest.mark.parametrize("chunk", [0, 16, 128])
@pytest.mark.parametrize("seq", [7, 130])
def test_mlstm_prefill_matches_jax(chunk, seq):
    """Per-step (chunk 0) and chunkwise prefill on ragged S, against the
    same form in JAX and against JAX's per-step oracle."""
    jcfg, tcfg = _configs("f32", mlstm_chunk=chunk)
    jp = JX.mlstm_init(jcfg, jax.random.key(0))
    tp = convert.tree_from_jax(_np(jp))
    x = (np.random.default_rng(seq).standard_normal(
        (2, seq, jcfg.d_model)) * 0.5).astype(np.float32)
    got = TX.mlstm_prefill(tcfg, tp, _t(x))
    _close(got, JX.mlstm_prefill(jcfg, jp, jnp.asarray(x)), CHUNK)
    _close(got, JX.mlstm_prefill(jcfg.replace(mlstm_chunk=0), jp,
                                 jnp.asarray(x)), CHUNK)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_slstm_prefill_and_decode_match_jax(dtype):
    """The block's prefill (through ``ops.slstm_scan``) and six decode steps
    whose state the port updates in place."""
    jcfg, tcfg = _configs(dtype)
    jp = JX.slstm_init(jcfg, jax.random.key(1))
    tp = convert.tree_from_jax(_np(jp))
    tol = F32 if dtype == "f32" else BF16
    x = (np.random.default_rng(5).standard_normal((2, 21, jcfg.d_model))
         ).astype(np.float32)
    jx = jnp.asarray(x, jcfg.activation_dtype)
    tx = _t(np.asarray(jx))
    _close(TX.slstm_prefill(tcfg, tp, tx), JX.slstm_prefill(jcfg, jp, jx),
           tol)
    jstate = JX.init_slstm_state(jcfg, 2)
    tstate = TX.init_slstm_state(tcfg, 2)
    held = tstate.c
    for t in range(6):
        jy, jstate = JX.slstm_decode(jcfg, jp, jx[:, t:t + 1], jstate)
        ty, tstate_out = TX.slstm_decode(tcfg, tp, tx[:, t:t + 1], tstate)
        assert tstate_out is tstate
        _close(ty, jy, tol)
    assert tstate.c is held           # updated in place
    for got, want in zip(tstate, jstate):
        _close(got, want, F32 if dtype == "f32" else dict(atol=0.05,
                                                           rtol=0.05))


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["f32", "bf16"])
def model(request):
    jcfg, tcfg = _configs(request.param)
    jp = JM.init_params(jcfg, jax.random.key(0))
    return request.param, jcfg, tcfg, jp, convert.tree_from_jax(_np(jp))


def test_params_tree_matches_jax(model):
    """Same structure, keys, shapes and dtypes as the JAX tree (b_if and
    b_gates fp32 in a bf16 config), leaf for leaf in JAX's order; the
    port's own init draws the same shapes."""
    dtype, jcfg, tcfg, jp, tp = model
    jleaves = jax.tree_util.tree_leaves(jp)
    own = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                         device="cpu")
    for got in (tree.leaves(tp), tree.leaves(own)):
        assert len(got) == len(jleaves)
        for t, j in zip(got, jleaves):
            assert tuple(t.shape) == j.shape
            assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
    assert jax.tree_util.tree_structure(jp) == jax.tree_util.tree_structure(
        tree.map_tree(lambda t: 0, own))
    segs = own["stack"]["segments"]
    assert segs[1]["slstm"]["inner"]["b_gates"].dtype == torch.float32
    assert torch.equal(segs[0]["mlstm"]["inner"]["b_if"][1],
                       torch.tensor([0.0] * 4 + [3.0] * 4))


def test_forward_loss_and_prefill_match_jax(model):
    dtype, jcfg, tcfg, jp, tp = model
    toks = _tokens(tcfg, 2, 24, 1)
    labels = _tokens(tcfg, 2, 24, 2)
    labels[0, :5] = -1
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          "labels": jnp.asarray(labels, jnp.int32)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    tol = F32 if dtype == "f32" else BF16
    jlogits, _ = JM.forward(jcfg, jp, jb)
    tlogits, _ = TM.forward(tcfg, tp, tb)
    assert tlogits.dtype == torch.float32
    _close(tlogits, jlogits, tol)
    jloss, _ = JM.loss_fn(jcfg, jp, jb)
    tloss, _ = TM.loss_fn(tcfg, tp, tb)
    _close(tloss, jloss, tol)
    want = jsteps.make_prefill_step(jcfg)(jp, {"tokens": jb["tokens"]})
    got = tsteps.make_prefill_step(tcfg, device="cpu")(
        tp, {"tokens": tb["tokens"]})
    assert got.shape == (2, tcfg.vocab_size) and got.dtype == torch.float32
    _close(got, want, tol)


def test_decode_steps_match_jax(model):
    """Eight greedy-fed decode steps through the recurrent states."""
    dtype, jcfg, tcfg, jp, tp = model
    B, n = 2, 8
    toks = _tokens(tcfg, B, n, 3)
    jcache = JM.init_cache(jcfg, B, n)
    tcache = TM.init_cache(tcfg, B, n, device="cpu")
    jstep = jax.jit(lambda p, c, t, pos: JM.decode_step(jcfg, p, c, t, pos))
    tstep = tsteps.make_serve_step(tcfg, device="cpu")
    for t in range(n):
        jl, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t:t + 1],
                                                   jnp.int32),
                           jnp.full((B,), t, jnp.int32))
        tl, tcache = tstep(tp, tcache, torch.from_numpy(toks[:, t:t + 1]),
                           torch.full((B,), t, dtype=torch.int32))
        _close(tl, jl[:, -1], F32 if dtype == "f32" else BF16)


@pytest.mark.parametrize("dtype,chunk", [("f32", 0), ("f32", 16),
                                         ("bf16", 0)])
def test_decode_matches_prefill(dtype, chunk):
    """The port alone: step-by-step decode logits == forward logits at
    every position (per-step or chunkwise mLSTM prefill, sLSTM scan)."""
    _, tcfg = _configs(dtype, mlstm_chunk=chunk)
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(1), device="cpu")
    s = 20
    toks = torch.from_numpy(_tokens(tcfg, 1, s, 4))
    full, _ = TM.forward(tcfg, tp, {"tokens": toks})
    cache = TM.init_cache(tcfg, 1, s, device="cpu")
    outs = []
    for t in range(s):
        logits, cache = TM.decode_step(tcfg, tp, cache, toks[:, t:t + 1],
                                       torch.tensor([t], dtype=torch.int32))
        outs.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).float().numpy(),
                               full.float().numpy(),
                               **(F32 if dtype == "f32" else BF16))


def test_restore_of_jax_checkpoint_is_bit_exact(tmp_path):
    """A bf16 xlstm checkpoint (with its fp32 gate biases) written by the
    JAX package, restored leaf by leaf in its dtypes."""
    jcfg, tcfg = _configs("bf16")
    jp = JM.init_params(jcfg, jax.random.key(3))
    jckpt.save(tmp_path, 7, jp)
    like = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")
    got = tckpt.restore(tmp_path, like=like)
    want = convert.tree_from_jax(_np(jp))
    dtypes = set()
    for g, w in zip(tree.leaves(got), tree.leaves(want)):
        assert g.dtype == w.dtype and torch.equal(g, w)
        dtypes.add(g.dtype)
    assert dtypes == {torch.bfloat16, torch.float32}


def test_serve_launcher_matches_jax(tmp_path, monkeypatch, capsys):
    """A JAX checkpoint served by both launchers with ``--arch xlstm-125m``
    at fp32: the same printed prompts and greedy tokens."""
    from repro.launch import serve as jserve
    jcfg, tcfg = _configs("f32")
    jckpt.save(tmp_path, 3, JM.init_params(jcfg, jax.random.key(5)))
    monkeypatch.setattr(jregistry, "get_reduced_config",
                        lambda arch, **kw: jcfg)
    monkeypatch.setattr(tserve, "get_reduced_config",
                        lambda arch, **kw: tcfg)
    argv = ["--arch", ARCH, "--ckpt-dir", str(tmp_path), "--batch", "3",
            "--prompt-len", "5", "--gen", "6"]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    jserve.main()
    jax_out = capsys.readouterr().out
    res = tserve.main([*argv, "--device", "cpu"])
    port_out = capsys.readouterr().out
    keep = ("[ckpt]", "[arch]", "  req")
    want = [ln for ln in jax_out.splitlines() if ln.startswith(keep)]
    got = [ln for ln in port_out.splitlines() if ln.startswith(keep)]
    assert len(want) == 4 and got == want
    assert res["tokens"].shape == (3, 6)


def test_serve_launcher_ignores_window():
    """``--window`` changes nothing for an attention-free model."""
    argv = ["--arch", ARCH, "--device", "cpu", "--batch", "2",
            "--prompt-len", "3", "--gen", "4"]
    plain = tserve.main(argv)
    windowed = tserve.main([*argv, "--window", "2"])
    np.testing.assert_array_equal(plain["tokens"], windowed["tokens"])
    assert torch.isfinite(plain["logits"]).all()


def test_config_matches_jax():
    """The full and reduced configs, field for field where the model reads
    them (layout, chunking, positions, head)."""
    for get in ("get_config", "get_reduced_config"):
        j = getattr(jregistry, get)(ARCH)
        t = getattr(tregistry, get)(ARCH)
        for field in ("layout_", "mlstm_chunk", "pos_embed", "attn_impl",
                      "tie_embeddings", "n_layers", "d_model", "n_heads",
                      "vocab_size", "norm_type", "norm_eps", "dtype",
                      "param_dtype", "source"):
            assert getattr(t, field) == getattr(j, field), (get, field)
    full = tregistry.get_config(ARCH)
    assert sum(r for _, r in full.layout_) == full.n_layers == 12
    assert tregistry.get_reduced_config(ARCH).mlstm_chunk == 0
