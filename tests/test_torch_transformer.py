"""The port's dense decoder (reduced qwen3-0.6b) on the CPU against the JAX
package, with the JAX params carried across by ``convert.tree_from_jax``:
forward logits and loss, the prefill step, KV-cache decode, the checkpoint
reader and the serve launcher.

Tolerances: fp32 1e-4 absolute / relative on logits and loss (two layers
of fp32 matmuls and softmaxes summed in another order; the JAX prefill
scans 32-key chunks where the port's plain attention is one dense
softmax); bf16 atol 0.15 / rtol 0.05, the bf16 tolerance of
tests/test_arch_smoke.py (bf16 activations round at other places in the
two frameworks, and the JAX prefill rounds its probabilities to bf16).
Decode against the port's own prefill: 1e-3 in fp32 (test_arch_smoke.py's
anchor), 0.15 / 0.05 in bf16.
"""
from __future__ import annotations

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import registry as jregistry
from repro.launch import steps as jsteps
from repro.models import model as JM

from repro_torch import convert, tree
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs import registry as tregistry
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as TM

SMALL = dict(n_layers=2, d_model=128, d_ff=256, vocab_size=128, n_heads=4,
             n_kv_heads=2)
F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=0.05, atol=0.15)
DTYPES = {"f32": dict(dtype="float32", param_dtype="float32"),
          "bf16": dict(dtype="bfloat16", param_dtype="bfloat16")}


def _configs(dtype: str, **kw):
    jcfg = jregistry.get_reduced_config("qwen3-0.6b", **SMALL).replace(
        **DTYPES[dtype], **kw)
    tcfg = tregistry.get_reduced_config("qwen3-0.6b", **SMALL).replace(
        **DTYPES[dtype], **kw)
    return jcfg, tcfg


def _params(jcfg, seed=0):
    jp = JM.init_params(jcfg, jax.random.key(seed))
    return jp, convert.tree_from_jax(jax.tree.map(np.asarray, jp))


def _close(got, want, dtype):
    np.testing.assert_allclose(convert.tensor_to_numpy(got),
                               np.asarray(want, np.float32),
                               **(F32 if dtype == "f32" else BF16))


@pytest.fixture(scope="module", params=["f32", "bf16"])
def model(request):
    jcfg, tcfg = _configs(request.param)
    jp, tp = _params(jcfg)
    return request.param, jcfg, tcfg, jp, tp


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def test_params_tree_matches_jax(model):
    """Same structure, keys, shapes and dtypes as the JAX tree, leaf for
    leaf in JAX's order; the port's own init draws the same shapes."""
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


def test_forward_loss_and_prefill_match_jax(model):
    dtype, jcfg, tcfg, jp, tp = model
    toks = _tokens(tcfg, 2, 24, 1)
    labels = _tokens(tcfg, 2, 24, 2)
    labels[0, :5] = -1
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          "labels": jnp.asarray(labels, jnp.int32)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    jlogits, _ = JM.forward(jcfg, jp, jb)
    tlogits, _ = TM.forward(tcfg, tp, tb)
    assert tlogits.dtype == torch.float32
    _close(tlogits, jlogits, dtype)
    jloss, _ = JM.loss_fn(jcfg, jp, jb)
    tloss, _ = TM.loss_fn(tcfg, tp, tb)
    _close(tloss, jloss, dtype)
    want = jsteps.make_prefill_step(jcfg)(jp, {"tokens": jb["tokens"]})
    got = tsteps.make_prefill_step(tcfg, device="cpu")(
        tp, {"tokens": tb["tokens"]})
    assert got.shape == (2, tcfg.vocab_size) and got.dtype == torch.float32
    _close(got, want, dtype)


def test_decode_steps_match_jax(model):
    """Eight greedy-fed decode steps through the KV cache."""
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
        _close(tl, jl[:, -1], dtype)


@pytest.mark.parametrize("dtype,window", [("f32", 0), ("bf16", 0),
                                          ("f32", 5)])
def test_decode_matches_prefill(dtype, window):
    """The port alone: token-by-token decode logits == forward logits at
    every position (cache correctness; with a window, the cache is a
    5-slot ring buffer)."""
    _, tcfg = _configs(dtype, attn_window=window)
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(1), device="cpu")
    s = 12
    toks = torch.from_numpy(_tokens(tcfg, 1, s, 4))
    full, _ = TM.forward(tcfg, tp, {"tokens": toks})
    cache = TM.init_cache(tcfg, 1, s, device="cpu")
    if window:
        assert cache[0]["attn"].k.shape[2] == window
    outs = []
    for t in range(s):
        logits, cache = TM.decode_step(tcfg, tp, cache, toks[:, t:t + 1],
                                       torch.tensor([t], dtype=torch.int32))
        outs.append(logits[:, 0])
    atol = 1e-3 if dtype == "f32" else 0.15
    np.testing.assert_allclose(torch.stack(outs, 1).float().numpy(),
                               full.float().numpy(), atol=atol, rtol=0.05)


def test_restore_of_jax_checkpoint_is_bit_exact(tmp_path):
    """npz layout, bf16 leaves widened to fp32 with the dtype in the
    manifest; and the legacy step_<n>/ directory layout."""
    jcfg, tcfg = _configs("bf16")
    jp, tp = _params(jcfg, seed=3)
    jckpt.save(tmp_path, 7, jp)
    like = TM.init_params(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")
    assert tckpt.latest_step(tmp_path) == 7
    got = tckpt.restore(tmp_path, like=like)
    for g, w in zip(tree.leaves(got), tree.leaves(tp)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    # the port writes the same format, and JAX reads it back
    tckpt.save(tmp_path / "port", 2, got)
    back = jckpt.restore(tmp_path / "port", like=jp)
    for b, j in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jp)):
        assert b.dtype == j.dtype
        np.testing.assert_array_equal(np.asarray(b, np.float32),
                                      np.asarray(j, np.float32))
    # legacy layout: step_<n>/manifest.json + arrays.npz
    with np.load(tmp_path / "step_00000007.npz") as z:
        manifest = json.loads(bytes(z["__manifest__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__manifest__"}
    legacy = tmp_path / "legacy" / "step_00000004"
    legacy.mkdir(parents=True)
    (legacy / "manifest.json").write_text(json.dumps(manifest))
    np.savez(legacy / "arrays.npz", **arrays)
    got = tckpt.restore(tmp_path / "legacy", like=like)
    for g, w in zip(tree.leaves(got), tree.leaves(tp)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        tckpt.restore(tmp_path, like={"only": like["final_norm"]["scale"]})


def test_serve_launcher_restores_jax_checkpoint(tmp_path, monkeypatch,
                                                capsys):
    """A checkpoint written by the JAX package, served by both launchers
    at fp32: the port prints ``restored step n`` and the same prompts and
    greedy tokens as JAX's ``launch.serve``."""
    from repro.launch import serve as jserve
    jcfg, tcfg = _configs("f32")
    jp, _ = _params(jcfg, seed=5)
    jckpt.save(tmp_path, 3, jp)
    monkeypatch.setattr(jregistry, "get_reduced_config",
                        lambda arch, **kw: jcfg)
    monkeypatch.setattr(tserve, "get_reduced_config",
                        lambda arch, **kw: tcfg)
    argv = ["--ckpt-dir", str(tmp_path), "--batch", "3", "--prompt-len", "5",
            "--gen", "6"]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    jserve.main()
    jax_out = capsys.readouterr().out
    res = tserve.main([*argv, "--device", "cpu"])
    port_out = capsys.readouterr().out
    assert "[ckpt] restored step 3" in port_out
    keep = ("[ckpt]", "[arch]", "  req")
    want = [ln for ln in jax_out.splitlines() if ln.startswith(keep)]
    got = [ln for ln in port_out.splitlines() if ln.startswith(keep)]
    assert len(want) == 4 and got == want
    assert res["tokens"].shape == (3, 6)


def _sub(cfg, name):
    """A sub-config (moe, mla, ssm) as a dict, None when absent."""
    sub = getattr(cfg, name)
    return None if sub is None else dataclasses.asdict(sub)


def test_registry_knows_every_jax_arch():
    """Each id of the JAX registry is ported: the same config, field for
    field (the source, the MoE, MLA and SSM sub-configs, the encoder stub
    and the layout included), full and reduced."""
    assert set(tregistry.ARCH_IDS) == set(jregistry.ARCH_IDS)
    for arch in tregistry.ARCH_IDS:
        j, t = jregistry.get_config(arch), tregistry.get_config(arch)
        for field in ("n_layers", "d_model", "n_heads", "n_kv_heads",
                      "head_dim_", "d_ff", "vocab_size", "qk_norm",
                      "rope_theta", "tie_embeddings", "mlp_type",
                      "attn_window", "norm_eps", "dtype", "param_dtype",
                      "attn_impl", "layout", "shared_every", "name",
                      "arch_type", "source", "mlp_bias", "norm_type",
                      "attn_bias", "pos_embed"):
            assert getattr(t, field) == getattr(j, field), field
        jr, tr = (jregistry.get_reduced_config(arch),
                  tregistry.get_reduced_config(arch))
        for name in ("moe", "mla", "ssm", "encoder"):
            assert _sub(t, name) == _sub(j, name), name
            assert _sub(tr, name) == _sub(jr, name), name
        assert tr == t.replace(
            moe=tr.moe, mla=tr.mla, ssm=tr.ssm, encoder=tr.encoder,
            **{f: getattr(jr, f) for f in (
                "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                "vocab_size", "head_dim", "max_seq_len", "attn_chunk",
                "attn_window", "layout", "mlstm_chunk")})
