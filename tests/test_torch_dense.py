"""The dense model zoo (yi-34b, command-r-35b, nemotron-4-340b: the
``decoder`` stack with GQA, untied heads, swiglu or squared-ReLU) reduced
on the CPU against the JAX package, the JAX params carried across by
``convert.tree_from_jax`` and tokens made from a numpy seed; the full
configs' parameter counts on the meta device; #4's plain route at
nemotron's head dims (192, 192) and at yi's GQA group of 7 against the
Pallas kernel run in interpret mode, as the JAX package's own kernel tests
run it; and the serve launcher's refusal of nemotron's full config.

The reduced configs keep what each model brings to the port: yi at its
group of 7 (7 heads over 1, rope_theta 5e6), command-r at its group of 8
(8 over 1, rope_theta 8e6), nemotron at its head dim 192 (2 heads over 1)
with the squared-ReLU MLP, computed in the activation dtype as the
reference computes it.

Tolerances: the models fp32 1e-4 (``tests/test_torch_transformer.py``'s:
two layers, the JAX prefill scans 32-key chunks where the port takes one
dense softmax); greedy decode against the port's own prefill 1e-3 in fp32
(``tests/test_arch_smoke.py``'s anchor); bf16 atol 0.15 / rtol 0.05 (the
bf16 tolerance of ``tests/test_arch_smoke.py``: bf16 activations round at
other places in the two frameworks); attention 2e-5
(``tests/test_kernels.py``'s for the Pallas kernel against its oracle).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.kernels.flash_attention import flash_attention as pallas_attention
from repro.launch import steps as jsteps
from repro.models import model as JM

from repro_torch import convert, tree
from repro_torch.configs import registry as tregistry
from repro_torch.kernels import ref
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as TM

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=0.05, atol=0.15)
DTYPES = {"float32": dict(dtype="float32", param_dtype="float32"),
          "bfloat16": dict(dtype="bfloat16", param_dtype="bfloat16")}
# the reduced configs: the model's GQA group or head dim kept
REDUCED = {"yi-34b": dict(d_model=224, n_heads=7, n_kv_heads=1),
           "command-r-35b": dict(d_model=256, n_heads=8, n_kv_heads=1),
           "nemotron-4-340b": dict(d_model=384, n_heads=2, n_kv_heads=1)}
FULL_PARAMS = {"yi-34b": 34_388_917_248, "command-r-35b": 32_380_690_432,
               "nemotron-4-340b": 341_025_638_400}


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


def _model(arch: str, dtype: str):
    """(JAX config, port config, JAX params, the port's copy of them)."""
    jc = jregistry.get_reduced_config(arch, **REDUCED[arch]).replace(
        **DTYPES[dtype])
    tc = tregistry.get_reduced_config(arch, **REDUCED[arch]).replace(
        **DTYPES[dtype])
    jp = jax.jit(lambda k: JM.init_params(jc, k))(jax.random.key(1))
    return jc, tc, jp, convert.tree_from_jax(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module", params=sorted(REDUCED))
def model(request):
    return (request.param, *_model(request.param, "float32"))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


@pytest.mark.parametrize("arch", sorted(FULL_PARAMS))
def test_full_config_param_count_on_meta(arch):
    """The full config field for field as the reference's, and its count
    on the meta device (nothing allocated) the reference's."""
    jc, tc = jregistry.get_config(arch), tregistry.get_config(arch)
    assert tc.source == jc.source and tc.name == jc.name
    assert TM.count_params_analytic(tc) == FULL_PARAMS[arch]
    assert JM.count_params_analytic(jc) == FULL_PARAMS[arch]
    assert tc.head_dim_ == (192 if arch == "nemotron-4-340b" else 128)


def test_reduced_configs_keep_the_models_attention(model):
    """The reduced configs keep each model's GQA group, head dim, RoPE
    base and MLP, and the tree matches the reference's leaf for leaf."""
    arch, jc, tc, jp, tp = model
    full = tregistry.get_config(arch)
    assert tc.rope_theta == full.rope_theta and tc.mlp_type == full.mlp_type
    assert tc.n_heads // tc.n_kv_heads == {"yi-34b": 7, "command-r-35b": 8,
                                           "nemotron-4-340b": 2}[arch]
    if arch == "nemotron-4-340b":
        assert tc.head_dim_ == 192 and tc.mlp_type == "squared_relu"
    jleaves = jax.tree_util.tree_leaves(jp)
    own = TM.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    for got in (tree.leaves(tp), tree.leaves(own)):
        assert [tuple(t.shape) for t in got] == [j.shape for j in jleaves]


def test_forward_loss_and_prefill_match_jax(model):
    """fp32 logits of 24 tokens, the loss with some labels masked, and the
    prefill step's last position."""
    arch, jc, tc, jp, tp = model
    toks, labels = _tokens(tc, 2, 24, 1), _tokens(tc, 2, 24, 2)
    labels[0, :5] = -1
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          "labels": jnp.asarray(labels, jnp.int32)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    jlogits, _ = jax.jit(lambda p, b: JM.forward(jc, p, b))(jp, jb)
    tlogits, _ = TM.forward(tc, tp, tb)
    np.testing.assert_allclose(_np(tlogits), np.asarray(jlogits), **F32)
    jloss, _ = JM.loss_fn(jc, jp, jb)
    tloss, _ = TM.loss_fn(tc, tp, tb)
    np.testing.assert_allclose(tloss.item(), float(jloss), **F32)
    want = jsteps.make_prefill_step(jc)(jp, {"tokens": jb["tokens"]})
    got = tsteps.make_prefill_step(tc, device="cpu")(
        tp, {"tokens": tb["tokens"]})
    assert got.shape == (2, tc.vocab_size)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


def test_greedy_decode_matches_prefill(model):
    """The serve launcher's greedy decode through the KV cache against the
    port's prefill over the prompt and the decoded tokens: each decoded
    token the argmax of the prefill's logits at its position, the last
    step's logits the prefill's last within 1e-3; the first step's
    logits the reference's prefill's."""
    arch, jc, tc, jp, tp = model
    prompts = _tokens(tc, 2, 9, 3)
    res = tserve.greedy_decode(tc, tp, prompts, 6, device="cpu")
    seq = np.concatenate([prompts, res["tokens"]], axis=1)
    full, _ = TM.forward(tc, tp, {"tokens": torch.from_numpy(seq)})
    want_tok = full[:, prompts.shape[1] - 1:-1].argmax(-1).numpy()
    np.testing.assert_array_equal(res["tokens"], want_tok)
    np.testing.assert_allclose(_np(res["logits"]), _np(full[:, -1]),
                               atol=1e-3, rtol=0.05)
    jfirst = jsteps.make_prefill_step(jc)(
        jp, {"tokens": jnp.asarray(prompts, jnp.int32)})
    np.testing.assert_array_equal(res["tokens"][:, 0],
                                  np.asarray(jfirst).argmax(-1))


@pytest.mark.parametrize("arch", sorted(REDUCED))
def test_bf16_forward_and_decode_match_jax(arch):
    """bf16 params and activations: the forward logits and four decode
    steps against the reference's at bf16's tolerance (nemotron's
    squared-ReLU in bf16, as the reference computes it)."""
    jc, tc, jp, tp = _model(arch, "bfloat16")
    assert tree.leaves(tp)[0].dtype == torch.bfloat16
    toks = _tokens(tc, 2, 16, 4)
    jlogits, _ = jax.jit(lambda p, b: JM.forward(jc, p, b))(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tlogits, _ = TM.forward(tc, tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(tlogits), np.asarray(jlogits, np.float32),
                               **BF16)
    B, n = 2, 4
    jstep = jax.jit(lambda p, c, t, pos: JM.decode_step(jc, p, c, t, pos))
    jcache = JM.init_cache(jc, B, n)
    tcache = TM.init_cache(tc, B, n, device="cpu")
    tstep = tsteps.make_serve_step(tc, device="cpu")
    for t in range(n):
        jl, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                           jnp.full((B,), t, jnp.int32))
        tl, tcache = tstep(tp, tcache, torch.from_numpy(toks[:, t:t + 1]),
                           torch.full((B,), t, dtype=torch.int32))
        np.testing.assert_allclose(_np(tl), np.asarray(jl[:, -1], np.float32),
                                   **BF16)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 33),
                                           (False, 0)])
@pytest.mark.parametrize("H,KV,D", [(4, 2, 192), (14, 2, 64)])
def test_flash_attention_ref_matches_pallas(H, KV, D, causal, window):
    """#4's plain route (what ``ops.flash_attention`` runs on a CPU
    tensor) at nemotron's head dims (192, 192) and at yi's GQA group of 7,
    S = 100 (ragged against the 32-row blocks), against the Pallas kernel
    in interpret mode."""
    rng = np.random.default_rng(D + H)
    B, S = 1, 100
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


def test_serve_launcher_refuses_nemotron_full_before_any_draw(monkeypatch):
    """``--full-config`` at nemotron-4-340b (682 GB of bf16 params) is
    refused by the launcher's reckoning before any param is drawn; yi-34b
    and command-r-35b are reckoned to fit one card."""
    shapes_only = TM.init_params

    def no_draw(cfg, gen, *, device=None):
        # the reckoning builds shapes on the meta device; nothing else
        if torch.device(device or "cuda").type != "meta":
            raise AssertionError("params drawn before the refusal")
        return shapes_only(cfg, gen, device=device)
    monkeypatch.setattr(TM, "init_params", no_draw)
    with pytest.raises(ValueError, match="one card"):
        tserve.main(["--arch", "nemotron-4-340b", "--full-config",
                     "--device", "cpu"])
    for arch in ("yi-34b", "command-r-35b"):
        need = tserve.check_fits_one_card(tregistry.get_config(arch),
                                          torch.device("cpu"), 8, 64)
        assert need["params"] == 2 * FULL_PARAMS[arch]
        assert need["total"] < tsteps.CARD_BYTES
