"""The port's attention and layers on the CPU against the JAX package.

``ops.flash_attention`` on CPU tensors runs the plain dense version
(``kernels/ref.flash_attention_ref``), held here against the JAX Pallas
kernel run in interpret mode and against the JAX prefill's jnp
``chunked_attention``; the CUDA kernel against the plain version is in
test_torch_cuda_kernels.py, which runs on a GPU.

Tolerances:
- fp32 attention 1e-5 absolute / relative: softmax-weighted means of O(1)
  values, with exponentials and sums taken in another order.
- bf16 attention 2**-7 relative with a 2**-7 floor on the O(1) scale of v:
  one bf16 ulp of the output, plus, against ``chunked_attention`` only,
  its rounding of the probabilities to bf16 before the PV product (at most
  2**-9 of sum(p |v|)), which an output near zero cannot absorb in a
  relative bound.
- layers: fp32 1e-6 (the same elementwise formulas), bf16 one ulp of the
  output (2**-7 relative) since an fp32 intermediate that differs in its
  last bit can round to either neighbour; the matmuls of the MLP and the
  head add fp32 sums in another order (1e-5 in fp32).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ref import flash_attention_ref as jax_flash_ref
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.config import ArchConfig as JaxArchConfig

from repro_torch import convert
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.config import ArchConfig

ATTN_F32 = dict(rtol=1e-5, atol=1e-5)
ATTN_BF16 = dict(rtol=2 ** -7, atol=2 ** -7)
LAYER_F32 = dict(rtol=1e-6, atol=1e-6)
MATMUL_F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2 ** -7, atol=2 ** -7)
JAX_DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _pair(arr, dtype):
    """The same values as a JAX array and a torch tensor in ``dtype``."""
    j = jnp.asarray(arr).astype(JAX_DTYPES[dtype])
    return j, convert.tensor_from_numpy(np.asarray(j))


def _close(got, want, tol):
    np.testing.assert_allclose(convert.tensor_to_numpy(got),
                               np.asarray(want, np.float32), **tol)


# (B, S, H, KV, D, causal, window): GQA groups 2 and 1, ragged S (not a
# multiple of the 128 block, or shorter than it), a window, non-causal
ATTN_CASES = [(2, 200, 4, 2, 64, True, 0), (1, 200, 4, 4, 32, True, 0),
              (2, 77, 4, 2, 32, True, 16), (1, 300, 2, 1, 64, True, 100),
              (1, 130, 4, 2, 32, False, 0), (1, 96, 4, 4, 64, False, 20)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,KV,D,causal,window", ATTN_CASES)
def test_flash_attention_matches_pallas_and_chunked(dtype, B, S, H, KV, D,
                                                    causal, window):
    rng = np.random.default_rng(S + H + D)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.standard_normal((B, S, n, D)).astype(np.float32), dtype)
        for n in (H, KV, KV))
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == (B, S, H, D)
    tol = ATTN_F32 if dtype == "f32" else ATTN_BF16
    pallas = jax_flash(jq, jk, jv, causal=causal, window=window,
                       interpret=True)
    _close(got, pallas, tol)
    _close(got, jax_flash_ref(jq, jk, jv, causal=causal, window=window), tol)
    pos = jnp.arange(S)
    chunked = jattn.chunked_attention(jq, jk, jv, pos, pos, window=window,
                                      chunk=32, causal=causal)
    _close(got, chunked, tol)


def _np_lse_log2(q, k, causal, window):
    """Masked logsumexp of the scaled scores times log2 e, in float64."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    kh = np.repeat(k.astype(np.float64), G, axis=2)
    s = np.einsum("bshd,bthd->bhst", q.astype(np.float64), kh) / np.sqrt(D)
    pos = np.arange(S)
    live = np.ones((S, S), bool)
    if causal:
        live &= pos[None, :] <= pos[:, None]
    if window:
        live &= pos[None, :] > pos[:, None] - window
    s = np.where(live, s, -np.inf)
    m = s.max(-1, keepdims=True)
    lse = m[..., 0] + np.log(np.exp(s - m).sum(-1))
    return lse / np.log(2.0)


# (B, S, H, KV, D, causal, window): ragged S, GQA, a window, non-causal
LSE_CASES = [(2, 70, 4, 2, 64, True, 0), (1, 130, 4, 4, 32, True, 16),
             (1, 65, 2, 1, 128, False, 0), (2, 33, 4, 2, 64, False, 8)]


@pytest.mark.parametrize("B,S,H,KV,D,causal,window", LSE_CASES)
def test_attention_lse_ref_matches_numpy(B, S, H, KV, D, causal, window):
    """``ref.attention_lse_ref`` (what the forward kernel saves for the
    backward) against a float64 numpy masked logsumexp times log2 e,
    within 1e-5 relative (fp32 scores and sums, with a 1e-5 floor on the
    largest value for rows whose lse is near 0); and 2^(score * D^-1/2 *
    log2 e - lse) are the plain version's probabilities: their PV product
    is its output within ATTN_F32."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(S + D)
    q, k, v = (rng.standard_normal((B, S, n, D)).astype(np.float32)
               for n in (H, KV, KV))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = ref.attention_lse_ref(tq, tk, causal=causal, window=window)
    want = _np_lse_log2(q, k, causal, window)
    assert got.dtype == torch.float32 and got.shape == (B, H, S)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    G = H // KV
    kh, vh = (torch.from_numpy(np.repeat(x, G, axis=2)) for x in (k, v))
    s = torch.einsum("bshd,bthd->bhst", tq, kh) * (D ** -0.5 / np.log(2.0))
    p = torch.exp2(s - got[..., None])
    pos = torch.arange(S)
    live = torch.ones((S, S), dtype=torch.bool)
    if causal:
        live &= pos[None, :] <= pos[:, None]
    if window:
        live &= pos[None, :] > pos[:, None] - window
    out = torch.einsum("bhst,bthd->bshd", torch.where(live, p, 0.0), vh)
    torch.testing.assert_close(
        out, ref.flash_attention_ref(tq, tk, tv, causal=causal,
                                     window=window), **ATTN_F32)


@pytest.mark.parametrize("window", [0, 6])
def test_gqa_prefill_matches_jax(window):
    """The whole GQA prefill (projections, qk-norm, RoPE, attention,
    output projection) in fp32; the matmuls add fp32 sums in another
    order (MATMUL_F32)."""
    kw = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=16, qk_norm=True,
              attn_window=window, attn_chunk=8, param_dtype="float32",
              dtype="float32")
    jcfg, tcfg = _cfgs(**kw)
    jp = jattn.gqa_init(jcfg, jax.random.key(2))
    tp = convert.tree_from_jax(jax.tree.map(np.asarray, jp))
    jx, tx = _pair(np.random.default_rng(7).standard_normal((2, 19, 32))
                   .astype(np.float32), "f32")
    want = jattn.gqa_prefill(jcfg, jp, jx, jnp.arange(19))
    _close(tattn.gqa_prefill(tcfg, tp, tx, torch.arange(19)), want,
           MATMUL_F32)


def test_gqa_prefill_refuses_positions_of_another_length():
    """The kernel masks positions 0..S-1, so positions that do not cover
    the S tokens are refused rather than masked differently from JAX."""
    _, tcfg = _cfgs(d_model=32, n_heads=4, n_kv_heads=2, head_dim=16,
                    param_dtype="float32", dtype="float32")
    tp = tattn.gqa_init(tcfg, torch.Generator().manual_seed(0))
    x = torch.zeros(1, 5, 32)
    with pytest.raises(ValueError, match="0..S-1"):
        tattn.gqa_prefill(tcfg, tp, x, torch.arange(3, 6))


def test_decode_attention_matches_jax():
    """One new token over a ring-buffered cache with empty slots, a
    window, and rows at different positions."""
    rng = np.random.default_rng(3)
    B, T, H, KV, D = 3, 12, 4, 2, 32
    for dtype in ("f32", "bf16"):
        (jq, tq), (jk, tk), (jv, tv) = (
            _pair(rng.standard_normal(s).astype(np.float32), dtype)
            for s in ((B, 1, H, D), (B, T, KV, D), (B, T, KV, D)))
        pos = np.array([np.arange(T), np.r_[np.arange(12, 20),
                                            np.full(4, -1)],
                        np.arange(30, 42)], np.int32)
        cur = np.array([11, 19, 41], np.int32)
        for window in (0, 5):
            want = jattn.decode_attention(jq, jk, jv, jnp.asarray(pos),
                                          jnp.asarray(cur), window=window)
            got = tattn.decode_attention(tq, tk, tv, torch.from_numpy(pos),
                                         torch.from_numpy(cur), window=window)
            _close(got, want, ATTN_F32 if dtype == "f32" else ATTN_BF16)


def test_cache_append_is_a_ring_buffer():
    """Slot idx % T, positions -1 for empty slots, idx + 1, per row."""
    B, T, KV, D = 2, 3, 1, 4
    jc = jattn.init_kv_cache(B, T, KV, D, jnp.float32)
    tc = tattn.init_kv_cache(B, T, KV, D, torch.float32)
    rng = np.random.default_rng(0)
    for t in range(5):
        k = rng.standard_normal((B, 1, KV, D)).astype(np.float32)
        v = rng.standard_normal((B, 1, KV, D)).astype(np.float32)
        p = np.array([t, t + 7], np.int32)
        jc = jattn.cache_append(jc, jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(p))
        tc = tattn.cache_append(tc, torch.from_numpy(k), torch.from_numpy(v),
                                torch.from_numpy(p))
        for name in ("k", "v", "pos", "idx"):
            np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                          np.asarray(getattr(jc, name)))


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def _cfgs(**kw):
    return (JaxArchConfig(name="t", arch_type="dense", source="test", **kw),
            ArchConfig(name="t", arch_type="dense", source="test", **kw))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rope_and_qk_norm_match_jax(dtype):
    rng = np.random.default_rng(1)
    B, S, H, D = 2, 9, 3, 64
    jx, tx = _pair(rng.standard_normal((B, S, H, D)).astype(np.float32) * 3,
                   dtype)
    tol = LAYER_F32 if dtype == "f32" else BF16
    for positions in (np.arange(S)[None, :], np.array([[5], [8191]])):
        sl = slice(0, positions.shape[1])
        jp = jnp.asarray(positions, jnp.int32)
        tp = torch.from_numpy(positions.astype(np.int32))
        # compiled, as the reference's model steps run it: its compiled
        # rope_freqs (the port's) differ from its op-by-op ones in the
        # last bit, which at position 8191 moves an angle by 5e-4 rad
        want = jax.jit(lambda x, p: jlayers.apply_rope(x, p, 1_000_000.0))(
            jx[:, sl], jp)
        _close(tlayers.apply_rope(tx[:, sl], tp, 1_000_000.0), want,
               dict(rtol=tol["rtol"], atol=max(tol["atol"], 1e-5)))
    _close(tlayers.rms_normalize(tx), jlayers.rms_normalize(jx), tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
def test_norms_match_jax(dtype, norm_type):
    rng = np.random.default_rng(2)
    jcfg, tcfg = _cfgs(d_model=48, norm_type=norm_type)
    jx, tx = _pair(rng.standard_normal((3, 5, 48)).astype(np.float32) + 0.5,
                   dtype)
    scale = rng.uniform(0.5, 1.5, 48).astype(np.float32)
    bias = rng.standard_normal(48).astype(np.float32)
    jp = {"scale": _pair(scale, dtype)[0], "bias": _pair(bias, dtype)[0]}
    tp = {"scale": _pair(scale, dtype)[1], "bias": _pair(bias, dtype)[1]}
    _close(tlayers.norm_apply(tcfg, tp, tx), jlayers.norm_apply(jcfg, jp, jx),
           dict(rtol=2e-6, atol=2e-6) if dtype == "f32" else BF16)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mlp_type,bias", [("swiglu", False),
                                           ("gelu", True),
                                           ("squared_relu", False)])
def test_mlp_matches_jax(dtype, mlp_type, bias):
    jcfg, tcfg = _cfgs(d_model=32, d_ff=64, mlp_type=mlp_type,
                       mlp_bias=bias, param_dtype="float32")
    jp = jlayers.mlp_init(jcfg, jax.random.key(0))
    jp = {k: v.astype(JAX_DTYPES[dtype]) for k, v in jp.items()}
    if bias:
        rng = np.random.default_rng(5)
        jp["b_up"] = jnp.asarray(rng.standard_normal(64) * 0.1,
                                 JAX_DTYPES[dtype])
        jp["b_down"] = jnp.asarray(rng.standard_normal(32) * 0.1,
                                   JAX_DTYPES[dtype])
    tp = convert.tree_from_jax(jax.tree.map(np.asarray, jp))
    jx, tx = _pair(np.random.default_rng(4).standard_normal((2, 7, 32))
                   .astype(np.float32), dtype)
    # bf16: up to two bf16 roundings of the hidden layer, then the
    # down-projection's output rounding
    _close(tlayers.mlp_apply(tcfg, tp, tx), jlayers.mlp_apply(jcfg, jp, jx),
           MATMUL_F32 if dtype == "f32" else dict(rtol=2 ** -5, atol=2 ** -6))


@pytest.mark.parametrize("tie", [True, False])
def test_embed_and_head_match_jax(tie):
    jcfg, tcfg = _cfgs(d_model=16, vocab_size=50, tie_embeddings=tie,
                       param_dtype="float32", dtype="float32")
    jp = jlayers.embedding_init(jcfg, jax.random.key(1))
    tp = convert.tree_from_jax(jax.tree.map(np.asarray, jp))
    toks = np.random.default_rng(6).integers(0, 50, (2, 5))
    jx = jlayers.embed_tokens(jcfg, jp, jnp.asarray(toks, jnp.int32))
    tx = tlayers.embed_tokens(tcfg, tp, torch.from_numpy(toks))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    _close(tlayers.lm_logits(tcfg, tp, tx), jlayers.lm_logits(jcfg, jp, jx),
           MATMUL_F32)


def test_dense_init_statistics():
    """Truncated at +-2 std with std fan_in**-0.5 (fan-in of one layer for
    a stacked weight); drawn on the generator's device, in its dtype; a
    2-D leaf drawn whole and each layer of a stacked one alike: mean about
    0, std about 0.8796 of std, inside +-2 std."""
    g = torch.Generator().manual_seed(0)
    std = 256 ** -0.5
    for shape in ((256, 512), (3, 256, 512)):
        w = tlayers.dense_init(g, shape, torch.bfloat16)
        assert w.dtype == torch.bfloat16 and w.shape == shape
        for part in w.float().reshape(-1, 256, 512):
            assert float(part.abs().max()) <= 2 * std * (1 + 2 ** -7)
            assert abs(float(part.mean())) / std < 0.01
            # the std of a standard normal truncated at +-2 is about 0.8796
            assert abs(float(part.std()) / std - 0.8796) < 0.01


def test_dense_init_draws_a_stacked_leaf_layer_by_layer(monkeypatch):
    """A stacked (L, ...) leaf is drawn one slice of its leading axis at a
    time into its output (each fp32 temporary one layer's), a 2-D leaf in
    one piece; the slices are independent draws with the statistics of a
    whole leaf, and the generator moves on by the same draws as for L
    separate layers."""
    drawn = []
    trunc = torch.nn.init.trunc_normal_

    def record(t, *a, **kw):
        drawn.append(tuple(t.shape))
        return trunc(t, *a, **kw)
    monkeypatch.setattr(torch.nn.init, "trunc_normal_", record)
    g = torch.Generator().manual_seed(1)
    w = tlayers.dense_init(g, (4, 2, 128, 256), torch.bfloat16)
    assert drawn == [(2, 128, 256)] * 4
    std = 128 ** -0.5
    parts = w.float().reshape(4, -1)
    for part in parts:
        assert float(part.abs().max()) <= 2 * std * (1 + 2 ** -7)
        assert abs(float(part.mean())) / std < 0.01
        assert abs(float(part.std()) / std - 0.8796) < 0.01
    assert not torch.equal(parts[0], parts[1])
    drawn.clear()
    tlayers.dense_init(g, (128, 256), torch.float32)
    assert drawn == [(128, 256)]
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    stacked = tlayers.dense_init(g1, (3, 64, 32), torch.float32)
    one_by_one = torch.stack([tlayers.dense_init(g2, (64, 32), torch.float32)
                              for _ in range(3)])
    assert torch.equal(stacked, one_by_one)
