"""phi-3-vision-4.2b (the VLM input merge of ``repro_torch/models/
model.py``: 576 patch embeddings projected by ``patch_proj`` and
prepended to the token embeddings, the head dropping their positions
again) reduced on the CPU against the JAX package, the JAX params carried
across by ``convert.tree_from_jax`` and tokens and patch embeddings made
from a numpy seed; the parameter counts; the serve launcher's refusal; and
#4's plain route at phi-3's head dim 96 against the Pallas kernel run in
interpret mode, as the JAX package's own kernel tests run it.

Tolerances: the merge fp32 1e-6 (one product and an embedding lookup);
the models fp32 1e-4 (``tests/test_torch_transformer.py``'s: two layers,
and the JAX prefill scans 32-key chunks where the port takes one dense
softmax); attention 2e-5 (``tests/test_kernels.py``'s for the Pallas
kernel against its oracle).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.kernels.flash_attention import flash_attention as pallas_attention
from repro.models import model as JM

from repro_torch import convert, tree
from repro_torch.configs import registry as tregistry
from repro_torch.kernels import ref
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as TM

ARCH = "phi-3-vision-4.2b"
MERGE = dict(rtol=1e-6, atol=1e-6)
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


def _model(**kw):
    jc = jregistry.get_reduced_config(ARCH).replace(**F32_CFG, **kw)
    tc = tregistry.get_reduced_config(ARCH).replace(**F32_CFG, **kw)
    jp = jax.jit(lambda k: JM.init_params(jc, k))(jax.random.key(1))
    return jc, tc, jp, convert.tree_from_jax(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def model():
    return _model()


def _batch(tc, B, S, seed, labels=False):
    """(the JAX batch, the port's): S tokens and the reduced 16 patch
    embeddings (fp32, cast by the model), with labels when asked."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, tc.vocab_size, (B, S)),
         "patch_embeds": rng.standard_normal(
             (B, tc.encoder.n_positions, tc.encoder.d_embed)).astype(
                 np.float32)}
    if labels:
        b["labels"] = rng.integers(0, tc.vocab_size, (B, S))
        b["labels"][0, :3] = -1
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


@pytest.mark.parametrize("pos_embed", ["rope", "learned"])
def test_merge_inputs_matches_jax(pos_embed):
    """``_merge_inputs``: the projected patches before the token
    embeddings, positions 0..P+S-1, P returned; with learned positions the
    tokens take positions P..P+S-1 of the table (the reference's offset
    branch, which phi-3's RoPE does not take)."""
    jc, tc, jp, tp = _model(pos_embed=pos_embed)
    jb, tb = _batch(tc, 2, 9, 3)
    jx, jpos, jn = JM._merge_inputs(jc, jp, jb)
    tx, tpos, tn = TM._merge_inputs(tc, tp, tb)
    assert tn == jn == tc.encoder.n_positions
    assert tx.shape == (2, 16 + 9, tc.d_model)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_allclose(_np(tx), np.asarray(jx), **MERGE)
    if pos_embed == "learned":
        tok = tp["embed"]["tok"][tb["tokens"]] + tp["embed"]["pos"][16:25]
        np.testing.assert_allclose(_np(tx[:, 16:]), _np(tok), **MERGE)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_tree_matches_jax(model, dtype):
    """The port's own init has JAX's leaves in JAX's order, ``patch_proj``
    (d_embed, d_model) among them, with their shapes and dtypes; the JAX
    params carried across keep theirs."""
    jc, tc, _, tp = model
    jc = jc.replace(dtype=dtype, param_dtype=dtype)
    tc = tc.replace(dtype=dtype, param_dtype=dtype)
    jshapes = jax.eval_shape(lambda: JM.init_params(jc, jax.random.key(0)))
    own = TM.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    jl = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    tl = tree.leaves_with_paths(own)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [
        "".join(f"['{k}']" if not k.isdigit() else f"[{k}]"
                for k in path.split("/")[1:]) for path, _ in tl]
    for (_, j), (_, t) in zip(jl, tl):
        assert j.shape == tuple(t.shape)
        assert str(j.dtype) == str(t.dtype).removeprefix("torch.")
    assert own["patch_proj"].shape == (tc.encoder.d_embed, tc.d_model)
    assert [j.shape for j in jax.tree_util.tree_leaves(jshapes)] == [
        tuple(t.shape) for t in tree.leaves(tp)]


@pytest.mark.parametrize("reduced,want", [(True, 1_508_608),
                                          (False, 3_824_225_280)])
def test_param_count_matches_jax(reduced, want):
    """The port's count on the meta device against the reference's
    ``eval_shape`` count: at full size the untied embedding and head, 32
    layers of 113,252,352 and ``patch_proj`` (1024 x 3072)."""
    jc = (jregistry.get_reduced_config if reduced
          else jregistry.get_config)(ARCH)
    tc = (tregistry.get_reduced_config if reduced
          else tregistry.get_config)(ARCH)
    assert JM.count_params_analytic(jc) == want
    assert TM.count_params_analytic(tc) == want
    if not reduced:
        assert tc.head_dim_ == 96
        assert want == (2 * 32064 * 3072 + 32 * 113_252_352 + 1024 * 3072
                        + 3072)


@pytest.mark.parametrize("head_dim", [0, 96])
def test_forward_loss_and_prefill_match_jax(head_dim):
    """Logits of 21 tokens behind 16 patches (the patches' positions
    dropped before the head), the loss with some labels masked, and the
    prefill step's last position; at the reduced head dim (64) and at
    phi-3's own 96, the width ``chip_smoke.py`` gives its reduced phi-3
    on the card."""
    jc, tc, jp, tp = _model(head_dim=head_dim)
    jb, tb = _batch(tc, 2, 21, 1, labels=True)
    jlogits, _ = jax.jit(lambda p, b: JM.forward(jc, p, b))(jp, jb)
    tlogits, _ = TM.forward(tc, tp, tb)
    assert tlogits.shape == (2, 21, tc.vocab_size)
    np.testing.assert_allclose(_np(tlogits), np.asarray(jlogits), **F32)
    jloss, _ = JM.loss_fn(jc, jp, jb)
    tloss, _ = TM.loss_fn(tc, tp, tb)
    np.testing.assert_allclose(tloss.item(), float(jloss), **F32)
    got = tsteps.make_prefill_step(tc, device="cpu")(
        tp, {k: tb[k] for k in ("tokens", "patch_embeds")})
    np.testing.assert_allclose(_np(got), np.asarray(jlogits[:, -1]), **F32)


def test_text_decode_matches_jax(model):
    """A VLM decodes text tokens from a fresh cache, as the reference's
    decode shape test does: eight steps of each package's decode step,
    the same logits at every step."""
    jc, tc, jp, tp = model
    B, n = 2, 8
    toks = np.random.default_rng(2).integers(0, tc.vocab_size, (B, n))
    jstep = jax.jit(lambda p, c, t, pos: JM.decode_step(jc, p, c, t, pos))
    jcache = JM.init_cache(jc, B, n)
    tcache = TM.init_cache(tc, B, n, device="cpu")
    tstep = tsteps.make_serve_step(tc, device="cpu")
    for t in range(n):
        jl, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                           jnp.full((B,), t, jnp.int32))
        tl, tcache = tstep(tp, tcache, torch.from_numpy(toks[:, t:t + 1]),
                           torch.full((B,), t, dtype=torch.int32))
        np.testing.assert_allclose(_np(tl), np.asarray(jl[:, -1]), **F32)


def test_serve_launcher_refuses_the_vlm():
    """The text decode launcher refuses phi-3-vision with the reference's
    message, reduced and at full size, before drawing any params."""
    for extra in ([], ["--full-config"]):
        with pytest.raises(SystemExit, match="VLM needs the image path"):
            tserve.main(["--arch", ARCH, "--device", "cpu", *extra])


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 33),
                                           (False, 0)])
def test_flash_attention_ref_at_d96_matches_pallas(causal, window):
    """#4's plain route (what ``ops.flash_attention`` runs on a CPU
    tensor) at phi-3-vision's head dim 96, GQA 4 over 2, S = 100 (ragged
    against the 32-row blocks), against the Pallas kernel in interpret
    mode."""
    rng = np.random.default_rng(96)
    B, S, H, KV, D = 1, 100, 4, 2, 96
    q, k, v = (rng.standard_normal((B, S, n, D)).astype(np.float32)
               for n in (H, KV, KV))
    want = pallas_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, window=window, block_q=32,
                            block_k=32, interpret=True)
    got = ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                  causal=causal, window=window)
    assert got.shape == (B, S, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
