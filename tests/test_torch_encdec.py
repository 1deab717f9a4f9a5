"""whisper-tiny's decoder (the ``encdec`` pattern of ``repro_torch/models/
transformer.py``: self-attention, cross-attention to the encoder memory,
GELU MLP; learned positions, layernorm, biases) reduced on the CPU against
the JAX package, the JAX params carried across by
``convert.tree_from_jax`` and tokens and memory made from a numpy seed;
the cross-attention block alone; the parameter counts; the serve
launcher; and #4's plain route with keys of their own length (S queries
over T keys, non-causal) against the reference's ``chunked_attention``.

Tolerances: the block fp32 1e-5 (one layer's matmuls and softmax taken in
another order, ``tests/test_torch_mla.py``'s), bf16 2**-6 (two bf16 ulps:
the block's output passes through three bf16 products, and the reference
rounds the probabilities to bf16 before the PV product where the port's
plain attention keeps them fp32); the models fp32 1e-4
(``tests/test_torch_transformer.py``'s: two layers, and the JAX prefill
scans 32-key chunks where the port takes one dense softmax); decode
against the port's own prefill 1e-3 in fp32 (``tests/test_arch_smoke.py``'s
anchor); attention 2e-5 (``tests/test_kernels.py``'s).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import attention as JA
from repro.models import model as JM
from repro.models.config import ArchConfig as JaxArchConfig
from repro.models.config import EncoderStub as JaxEncoderStub

from repro_torch import convert, tree
from repro_torch.configs import registry as tregistry
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models.config import ArchConfig, EncoderStub

ARCH = "whisper-tiny"
BLOCK = dict(rtol=1e-5, atol=1e-5)
BLOCK_BF16 = dict(rtol=2 ** -6, atol=2 ** -6)
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


def _np(t):
    return convert.tensor_to_numpy(t)


@pytest.fixture(scope="module")
def model():
    jc = jregistry.get_reduced_config(ARCH).replace(**F32_CFG)
    tc = tregistry.get_reduced_config(ARCH).replace(**F32_CFG)
    jp = jax.jit(lambda k: JM.init_params(jc, k))(jax.random.key(1))
    return jc, tc, jp, convert.tree_from_jax(jax.tree.map(np.asarray, jp))


def _memory(tc, B, seed):
    """Encoder frames (B, M, d_embed) fp32, M = the reduced 16."""
    return np.random.default_rng(seed).standard_normal(
        (B, tc.encoder.n_positions, tc.encoder.d_embed)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xattn_block_matches_jax(dtype):
    """``xattn_apply``: 19 decoder tokens over 24 memory frames of their
    own width (48, so wk and wv are (48, H hd)), the reference scanning
    them in chunks of 8; the port's params are the reference's."""
    kw = dict(d_model=32, n_heads=4, n_kv_heads=4, attn_chunk=8,
              dtype=dtype, param_dtype=dtype)
    jc = JaxArchConfig(name="t", arch_type="audio", source="test",
                       encoder=JaxEncoderStub("audio", 24, 48), **kw)
    tc = ArchConfig(name="t", arch_type="audio", source="test",
                    encoder=EncoderStub("audio", 24, 48), **kw)
    jp = JA.xattn_init(jc, jax.random.key(3))
    tp = convert.tree_from_jax(jax.tree.map(np.asarray, jp))
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        "wq": (32, 32), "wk": (48, 32), "wv": (48, 32), "wo": (32, 32)}
    own = TA.xattn_init(tc, torch.Generator().manual_seed(0))
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in tp.items()}
    rng = np.random.default_rng(5)
    x, mem = (jnp.asarray(rng.standard_normal(s).astype(np.float32))
              .astype(jc.activation_dtype) for s in ((2, 19, 32), (2, 24, 48)))
    want = JA.xattn_apply(jc, jp, x, mem)
    got = TA.xattn_apply(tc, tp, convert.tensor_from_numpy(np.asarray(x)),
                         convert.tensor_from_numpy(np.asarray(mem)))
    assert got.dtype == tc.activation_dtype and got.shape == (2, 19, 32)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **(BLOCK if dtype == "float32"
                                  else BLOCK_BF16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_and_cache_trees_match_jax(model, dtype):
    """The params: {"segments": [{"attn", "xattn", "ffn"} stacked on L]}
    with learned positions and layernorm biases; the cache: the self
    attention's KV cache only (the cross-attention keeps none).  The
    port's own init and cache have JAX's structure, shapes and dtypes."""
    jc, tc, _, tp = model
    jc = jc.replace(dtype=dtype, param_dtype=dtype)
    tc = tc.replace(dtype=dtype, param_dtype=dtype)
    jshapes = jax.eval_shape(lambda: JM.init_params(jc, jax.random.key(0)))
    own = TM.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    jl = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    tl = tree.leaves_with_paths(own)
    assert len(jl) == len(tl)
    for (jpath, j), (path, t) in zip(jl, tl):
        assert [str(getattr(k, "key", getattr(k, "idx", k))) for k in jpath] \
            == path.split("/")[1:]
        assert j.shape == tuple(t.shape)
        assert str(j.dtype) == str(t.dtype).removeprefix("torch.")
    assert sorted(own["stack"]["segments"][0]) == ["attn", "ffn", "xattn"]
    jcache = JM.init_cache(jc, 2, 9)
    tcache = TM.init_cache(tc, 2, 9, device="cpu")
    assert [sorted(c) for c in tcache] == [["attn"]]
    assert [j.shape for j in jax.tree_util.tree_leaves(jcache)] == [
        tuple(t.shape) for t in tree.leaves(tcache)]
    if dtype == "float32":
        assert [j.shape for j in jax.tree_util.tree_leaves(jshapes)] == [
            tuple(t.shape) for t in tree.leaves(tp)]


@pytest.mark.parametrize("reduced,want", [(True, 1_611_776),
                                          (False, 41_958_528)])
def test_param_count_matches_jax(reduced, want):
    """The port's count on the meta device against the reference's
    ``eval_shape`` count (nothing allocated at full size)."""
    jc = (jregistry.get_reduced_config if reduced
          else jregistry.get_config)(ARCH)
    tc = (tregistry.get_reduced_config if reduced
          else tregistry.get_config)(ARCH)
    assert JM.count_params_analytic(jc) == want
    assert TM.count_params_analytic(tc) == want
    assert (tc.layout, tc.encoder.kind, tc.pos_embed) == (
        jc.layout, jc.encoder.kind, jc.pos_embed)


def test_forward_loss_and_prefill_match_jax(model):
    """Logits of 21 tokens over 16 memory frames, the loss with some
    labels masked, the per-example loss, and the prefill step's last
    position, the memory handed in fp32 and cast by the model."""
    jc, tc, jp, tp = model
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tc.vocab_size, (2, 21))
    labels = rng.integers(0, tc.vocab_size, (2, 21))
    labels[0, :5] = -1
    mem = _memory(tc, 2, 2)
    jb = {"tokens": jnp.asarray(toks, jnp.int32), "memory": jnp.asarray(mem),
          "labels": jnp.asarray(labels, jnp.int32)}
    tb = {"tokens": torch.from_numpy(toks), "memory": torch.from_numpy(mem),
          "labels": torch.from_numpy(labels)}
    jlogits, _ = jax.jit(lambda p, b: JM.forward(jc, p, b))(jp, jb)
    tlogits, _ = TM.forward(tc, tp, tb)
    np.testing.assert_allclose(_np(tlogits), np.asarray(jlogits), **F32)
    jloss, _ = JM.loss_fn(jc, jp, jb)
    tloss, _ = TM.loss_fn(tc, tp, tb)
    np.testing.assert_allclose(tloss.item(), float(jloss), **F32)
    jper, _ = JM.per_example_loss(jc, jp, jb)
    tper, _ = TM.per_example_loss(tc, tp, tb)
    np.testing.assert_allclose(_np(tper), np.asarray(jper), **F32)
    got = tsteps.make_prefill_step(tc, device="cpu")(
        tp, {"tokens": tb["tokens"], "memory": tb["memory"]})
    np.testing.assert_allclose(_np(got), np.asarray(jlogits[:, -1]), **F32)


def test_greedy_decode_matches_jax(model):
    """Six greedy steps after a 4-token prompt through each package's
    caches, every step attending the same memory: the same logits at
    every step and the same tokens."""
    jc, tc, jp, tp = model
    B, Sp, n = 2, 4, 6
    prompts = np.random.default_rng(2).integers(0, tc.vocab_size, (B, Sp))
    mem = _memory(tc, B, 3)
    jstep = jax.jit(lambda p, c, t, pos, m: JM.decode_step(jc, p, c, t, pos,
                                                           memory=m))
    jcache = JM.init_cache(jc, B, Sp + n)
    tcache = TM.init_cache(tc, B, Sp + n, device="cpu")
    tstep = tsteps.make_serve_step(tc, device="cpu")
    tok = None
    for t in range(Sp + n):
        feed = prompts[:, t:t + 1] if t < Sp else tok
        jl, jcache = jstep(jp, jcache, jnp.asarray(feed, jnp.int32),
                           jnp.full((B,), t, jnp.int32), jnp.asarray(mem))
        tl, tcache = tstep(tp, tcache, torch.from_numpy(np.asarray(feed)),
                           torch.full((B,), t, dtype=torch.int32),
                           torch.from_numpy(mem))
        np.testing.assert_allclose(_np(tl), np.asarray(jl[:, -1]), **F32)
        tok = np.asarray(jl[:, -1]).argmax(-1)[:, None]
        assert np.array_equal(_np(tl).argmax(-1)[:, None], tok)
    for j, t in zip(jax.tree_util.tree_leaves(jcache), tree.leaves(tcache)):
        np.testing.assert_allclose(_np(t), np.asarray(j), **F32)


def test_decode_matches_prefill(model):
    """The port alone: token-by-token decode logits == forward logits at
    every position of the reduced whisper, fp32, with the same memory."""
    _, tc, _, tp = model
    s = 20
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, tc.vocab_size, (2, s)))
    mem = torch.from_numpy(_memory(tc, 2, 5))
    full, _ = TM.forward(tc, tp, {"tokens": toks, "memory": mem})
    cache = TM.init_cache(tc, 2, s, device="cpu")
    outs = []
    for t in range(s):
        logits, cache = TM.decode_step(tc, tp, cache, toks[:, t:t + 1],
                                       torch.full((2,), t, dtype=torch.int32),
                                       memory=mem)
        outs.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               atol=1e-3, rtol=0.0)


def test_loss_gradients_match_jax(model):
    """``loss_fn``'s gradient through the encdec stack (each layer
    recomputed under ``torch.utils.checkpoint``, the memory threaded
    through it) against ``jax.grad`` of the reference's, leaf by leaf,
    fp32, 1e-4 of the leaf's largest gradient; the self-attention's key
    bias, to which the softmax is blind, has a gradient of zero in exact
    arithmetic and rounding noise (~1e-9) in both packages, hence a floor
    of 1e-4 under that largest gradient."""
    jc, tc, jp, tp = model
    rng = np.random.default_rng(7)
    toks = rng.integers(0, tc.vocab_size, (2, 13))
    labels = rng.integers(0, tc.vocab_size, (2, 13))
    mem = _memory(tc, 2, 8)
    jb = {"tokens": jnp.asarray(toks, jnp.int32), "memory": jnp.asarray(mem),
          "labels": jnp.asarray(labels, jnp.int32)}
    jgrads = jax.jit(jax.grad(lambda p: JM.loss_fn(jc, p, jb)[0]))(jp)
    leaves = [t.clone().requires_grad_() for t in tree.leaves(tp)]
    loss, _ = TM.loss_fn(tc, tree.unflatten(tp, leaves),
                         {"tokens": torch.from_numpy(toks),
                          "memory": torch.from_numpy(mem),
                          "labels": torch.from_numpy(labels)})
    tgrads = torch.autograd.grad(loss, leaves)
    for j, t in zip(jax.tree_util.tree_leaves(jgrads), tgrads):
        j = np.asarray(j)
        np.testing.assert_allclose(_np(t), j, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(j).max(), 1e-4))


def test_serve_launcher_runs_whisper_reduced(capsys):
    """``launch.serve --arch whisper-tiny --device cpu`` draws the memory
    from the seed after the prompts, as the reference's launcher does
    (``rng.standard_normal((B, n_positions, d_embed))``), and decodes
    greedily with it: the same tokens as ``greedy_decode`` handed those
    prompts and that memory, and the JAX launcher's lines."""
    res = tserve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "3", "--gen", "2", "--seed", "4"])
    assert res["tokens"].shape == (2, 2)
    assert torch.isfinite(res["logits"]).all()
    out = capsys.readouterr().out
    assert f"[arch] {ARCH} (reduced) batch=2 cache=5" in out
    assert "[decode] 2 tok" in out
    cfg = tregistry.get_reduced_config(ARCH)
    params = TM.init_params(cfg, torch.Generator().manual_seed(4),
                            device="cpu")
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, cfg.vocab_size, (2, 3))
    mem = rng.standard_normal((2, cfg.encoder.n_positions,
                               cfg.encoder.d_embed)).astype(np.float32)
    again = tserve.greedy_decode(cfg, params, prompts, 2, device="cpu",
                                 memory=mem)
    assert np.array_equal(again["tokens"], res["tokens"])
    torch.testing.assert_close(again["logits"], res["logits"])


# (B, S, T, H, KV, D): decoder tokens over encoder frames (more keys than
# queries, fewer, one query as in decode), GQA 2, head dims 64 and 80, and
# whisper-tiny's decode step (one query over its 1500 frames, 6 heads)
CROSS_CASES = [(2, 19, 40, 4, 4, 64), (1, 33, 7, 2, 2, 32),
               (2, 1, 50, 4, 2, 64), (1, 10, 129, 2, 1, 80),
               (2, 1, 1500, 6, 6, 64)]


@pytest.mark.parametrize("B,S,T,H,KV,D", CROSS_CASES)
def test_flash_attention_ref_cross_matches_chunked(B, S, T, H, KV, D):
    """#4's plain route (what ``ops.flash_attention`` runs on CPU tensors)
    with keys of their own length, non-causal, against the reference's
    ``chunked_attention`` at ``q_pos = arange(S)``, ``kv_pos = arange(T)``
    (its xattn_apply), in chunks of 16 keys; and the log-sum-exp over those
    keys against numpy."""
    rng = np.random.default_rng(S + T)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, T, KV, D)).astype(np.float32)
            for _ in range(2))
    want = JA.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.arange(S), jnp.arange(T),
                                chunk=16, causal=False)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=False)
    assert got.shape == (B, S, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    s = np.einsum("bskgd,btkd->bkgst", q.reshape(B, S, KV, H // KV, D),
                  k) * D ** -0.5
    lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(
        ref.attention_lse_ref(tq, tk, causal=False).numpy(),
        (lse * np.log2(np.e)).reshape(B, H, S), rtol=1e-5, atol=1e-5)
