"""MLA (``repro_torch/models/attention.py``: the prefill through
``ops.flash_attention`` with q/k and v of their own head dims, the
weight-absorbed decode over the compressed cache) and the two MoE archs
(reduced deepseek-v2-lite-16b: MLA + MoE; reduced kimi-k2-1t-a32b: GQA +
MoE) on the CPU against the JAX package, the JAX params carried across by
``convert.tree_from_jax`` and inputs made from a numpy seed.

Tolerances: the MLA blocks fp32 1e-5 absolute / relative (one layer's
matmuls, softmaxes and RoPE taken in another order); the models fp32 1e-4
(``tests/test_torch_transformer.py``'s: two layers, and the JAX prefill
scans 32-key chunks where the port's plain attention is one dense
softmax); decode against the port's own prefill 1e-3 in fp32
(``tests/test_arch_smoke.py``'s anchor), with a capacity factor of
n_experts so that no group drops a token (a 1-token decode group and a
64-token prefill group drop different ones, as in the reference's own
check).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import attention as JA
from repro.models import model as JM

from repro_torch import convert, tree
from repro_torch.configs import registry as tregistry
from repro_torch.kernels import ref
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as TA
from repro_torch.models import model as TM

DEEPSEEK, KIMI = "deepseek-v2-lite-16b", "kimi-k2-1t-a32b"
BLOCK = dict(rtol=1e-5, atol=1e-5)
F32 = dict(rtol=1e-4, atol=1e-4)
F32_CFG = dict(dtype="float32", param_dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread for this module: its tensors are small,
    and torch's waiting pool threads would otherwise compete with JAX's
    for the cores when test files run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch: str, **kw):
    return (jregistry.get_reduced_config(arch).replace(**F32_CFG, **kw),
            tregistry.get_reduced_config(arch).replace(**F32_CFG, **kw))


def _np(t):
    return convert.tensor_to_numpy(t)


@pytest.fixture(scope="module")
def mla_layer():
    jc, tc = _configs(DEEPSEEK)
    jp = JA.mla_init(jc, jax.random.key(0))
    return jc, tc, jp, convert.tree_from_jax(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("window", [0, 5])
def test_mla_prefill_matches_jax(mla_layer, window):
    jc, tc, jp, tp = mla_layer
    jc, tc = jc.replace(attn_window=window), tc.replace(attn_window=window)
    S = 19
    x = np.random.default_rng(window).standard_normal(
        (2, S, jc.d_model)).astype(np.float32)
    want = JA.mla_prefill(jc, jp, jnp.asarray(x), jnp.arange(S))
    got = TA.mla_prefill(tc, tp, torch.from_numpy(x), torch.arange(S))
    np.testing.assert_allclose(_np(got), np.asarray(want), **BLOCK)


def test_mla_decode_matches_jax(mla_layer):
    """Eight steps of the absorbed decode through a 6-slot ring cache (it
    wraps), written in place in the port."""
    jc, tc, jp, tp = mla_layer
    B, T = 2, 6
    jcache = JA.init_mla_cache(B, T, jc, jnp.float32)
    tcache = TA.init_mla_cache(B, T, tc, torch.float32)
    rng = np.random.default_rng(3)
    for t in range(8):
        x = rng.standard_normal((B, 1, jc.d_model)).astype(np.float32)
        pos = np.array([t, t + 1], np.int32)
        want, jcache = JA.mla_decode(jc, jp, jnp.asarray(x), jcache,
                                     jnp.asarray(pos))
        got, tcache = TA.mla_decode(tc, tp, torch.from_numpy(x), tcache,
                                    torch.from_numpy(pos))
        np.testing.assert_allclose(_np(got), np.asarray(want), **BLOCK)
    for name in ("ckv", "krope", "pos", "idx"):
        np.testing.assert_allclose(_np(getattr(tcache, name)),
                                   np.asarray(getattr(jcache, name)),
                                   **BLOCK)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 7),
                                           (False, 0)])
def test_flash_attention_ref_takes_its_own_v_width(causal, window):
    """The plain version with Dv != D (MLA's shape, 48 / 32 here) against
    the reference's ``chunked_attention`` on v zero-padded to D, sliced
    back: the same function without the padding."""
    rng = np.random.default_rng(7)
    B, S, H, D, Dv = 2, 21, 4, 48, 32
    q, k = (rng.standard_normal((B, S, H, D)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, S, H, Dv)).astype(np.float32)
    pad = np.pad(v, ((0, 0), (0, 0), (0, 0), (0, D - Dv)))
    pos = jnp.arange(S)
    want = JA.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(pad), pos, pos, window=window,
                                chunk=8, causal=causal)[..., :Dv]
    got = ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                  causal=causal, window=window)
    assert got.shape == (B, S, H, Dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK)


@pytest.fixture(scope="module", params=[DEEPSEEK, KIMI])
def model(request):
    jc, tc = _configs(request.param)
    jp = JM.init_params(jc, jax.random.key(1))
    return jc, tc, jp, convert.tree_from_jax(jax.tree.map(np.asarray, jp))


def test_params_tree_matches_jax(model):
    """The JAX params map into the port's tree leaf by leaf in JAX's leaf
    order (MLA's wq / wdkv / wuk / wuv / wo, the router, the experts with
    their E axis and the shared experts, all stacked on L); the port's own
    init draws the same shapes and dtypes."""
    jc, tc, jp, tp = model
    own = TM.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree_util.tree_structure(jp) == jax.tree_util.tree_structure(
        tree.map_tree(lambda t: 0, own))
    for t, o, j in zip(tree.leaves(tp), tree.leaves(own),
                       jax.tree_util.tree_leaves(jp)):
        assert tuple(t.shape) == tuple(o.shape) == j.shape
        assert str(o.dtype).removeprefix("torch.") == str(j.dtype)


def test_forward_loss_and_prefill_match_jax(model):
    """Logits, the summed aux loss, ``loss_fn`` (task + router_aux_weight x
    aux) and the prefill step."""
    jc, tc, jp, tp = model
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tc.vocab_size, (2, 24))
    labels = rng.integers(0, tc.vocab_size, (2, 24))
    labels[0, :5] = -1
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          "labels": jnp.asarray(labels, jnp.int32)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    jlogits, jaux = JM.forward(jc, jp, jb)
    tlogits, taux = TM.forward(tc, tp, tb)
    np.testing.assert_allclose(_np(tlogits), np.asarray(jlogits), **F32)
    assert float(jaux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), **F32)
    jloss, jparts = JM.loss_fn(jc, jp, jb)
    tloss, tparts = TM.loss_fn(tc, tp, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), **F32)
    np.testing.assert_allclose(float(tparts["task_loss"]),
                               float(jparts["task_loss"]), **F32)
    got = tsteps.make_prefill_step(tc, device="cpu")(
        tp, {"tokens": tb["tokens"]})
    np.testing.assert_allclose(_np(got), np.asarray(jlogits[:, -1]), **F32)


def test_greedy_decode_matches_jax(model):
    """Six greedy steps after a 4-token prompt through each package's
    cache (the MLA cache for deepseek, the KV cache for kimi): the same
    logits at every step and the same tokens."""
    jc, tc, jp, tp = model
    B, Sp, n = 2, 4, 6
    prompts = np.random.default_rng(2).integers(0, tc.vocab_size, (B, Sp))
    jstep = jax.jit(lambda p, c, t, pos: JM.decode_step(jc, p, c, t, pos))
    jcache = JM.init_cache(jc, B, Sp + n)
    tcache = TM.init_cache(tc, B, Sp + n, device="cpu")
    tstep = tsteps.make_serve_step(tc, device="cpu")
    tok = None
    for t in range(Sp + n):
        feed = prompts[:, t:t + 1] if t < Sp else tok
        jl, jcache = jstep(jp, jcache, jnp.asarray(feed, jnp.int32),
                           jnp.full((B,), t, jnp.int32))
        tl, tcache = tstep(tp, tcache, torch.from_numpy(np.asarray(feed)),
                           torch.full((B,), t, dtype=torch.int32))
        np.testing.assert_allclose(_np(tl), np.asarray(jl[:, -1]), **F32)
        tok = np.asarray(jl[:, -1]).argmax(-1)[:, None]
        assert np.array_equal(_np(tl).argmax(-1)[:, None], tok)


def test_decode_matches_prefill():
    """The port alone: token-by-token decode logits == forward logits at
    every position of the reduced deepseek, fp32, no capacity drops."""
    _, tc = _configs(DEEPSEEK)
    tc = tc.replace(moe=dataclasses.replace(
        tc.moe, capacity_factor=float(tc.moe.n_experts)))
    tp = TM.init_params(tc, torch.Generator().manual_seed(4), device="cpu")
    s = 12
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, tc.vocab_size, (1, s)))
    full, _ = TM.forward(tc, tp, {"tokens": toks})
    cache = TM.init_cache(tc, 1, s, device="cpu")
    outs = []
    for t in range(s):
        logits, cache = TM.decode_step(tc, tp, cache, toks[:, t:t + 1],
                                       torch.tensor([t], dtype=torch.int32))
        outs.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               atol=1e-3, rtol=0.05)


def test_serve_launcher_runs_both_archs_reduced_and_refuses_kimi_full():
    """``launch.serve --arch ... --device cpu`` runs both reduced; kimi's
    full config is refused before any allocation (its params do not fit
    one card)."""
    for arch in (DEEPSEEK, KIMI):
        res = tserve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                           "--prompt-len", "3", "--gen", "2"])
        assert res["tokens"].shape == (2, 2)
        assert torch.isfinite(res["logits"]).all()
    with pytest.raises(ValueError, match="one card"):
        tserve.main(["--arch", KIMI, "--full-config", "--device", "cpu"])
