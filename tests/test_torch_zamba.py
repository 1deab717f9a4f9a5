"""zamba2-2.7b (the ``zamba_super`` hybrid of ``repro_torch/models/
transformer.py``: one weight-shared attention + MLP block before every
run of ``shared_every`` Mamba-2 blocks) reduced on the CPU against the JAX
package, the JAX params (made from ``jax.random.key``: the reference
reshapes its split keys, which raw ``PRNGKey`` arrays do not allow)
carried across by ``convert.tree_from_jax`` and tokens made from a numpy
seed; the parameter counts at full size and reduced; the serve launcher;
and #4's plain route at zamba2's head dim 80 against the Pallas kernel
run in interpret mode, as the JAX package's own kernel tests run it.

Tolerances: the models fp32 1e-4 (``tests/test_torch_mla.py``'s: two
super-blocks of 13 layers, the JAX prefill scans 32-key attention chunks
and the SSD carry where the port takes one dense softmax and the carry in
closed form); decode against the port's own prefill 1e-3 in fp32
(``tests/test_arch_smoke.py``'s anchor); attention 2e-5
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
from repro.models import model as JM

from repro_torch import convert, tree
from repro_torch.configs import registry as tregistry
from repro_torch.kernels import ref
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as TM

ARCH = "zamba2-2.7b"
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


def _paths(t, prefix=""):
    """The port tree's leaf paths in leaf order, as ``jax.tree_util.
    keystr`` writes them: dict keys, list indices, named-tuple fields."""
    if isinstance(t, dict):
        return [q for k in sorted(t) for q in _paths(t[k],
                                                      f"{prefix}['{k}']")]
    if hasattr(t, "_fields"):
        return [q for f in t._fields for q in _paths(getattr(t, f),
                                                     f"{prefix}.{f}")]
    if isinstance(t, (list, tuple)):
        return [q for i, x in enumerate(t) for q in _paths(x,
                                                           f"{prefix}[{i}]")]
    return [prefix]


def _same_tree(jtree, ttree):
    """JAX's and the port's trees: the same leaf paths (keys, cache
    fields) in the same leaf order, and leaf for leaf the same shapes and
    dtypes."""
    jleaves = jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jleaves] == _paths(ttree)
    for (_, j), t in zip(jleaves, tree.leaves(ttree)):
        assert j.shape == tuple(t.shape)
        assert str(j.dtype) == str(t.dtype).removeprefix("torch.")


@pytest.fixture(scope="module")
def model():
    jc = jregistry.get_reduced_config(ARCH).replace(**F32_CFG)
    tc = tregistry.get_reduced_config(ARCH).replace(**F32_CFG)
    jp = jax.jit(lambda k: JM.init_params(jc, k))(jax.random.key(1))
    return jc, tc, jp, convert.tree_from_jax(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_and_cache_trees_match_jax(model, dtype):
    """The params: {"segments": [the Mamba layers on (2, 6)],
    "shared_attn": the one decoder layer}; the cache: [{"mamba": {"mamba":
    MambaCache on (2, 6)}, "shared": {"attn": KVCache on (2,)}}].  The
    port's own init and cache have JAX's structure, shapes and dtypes."""
    jc, tc, _, tp = model
    jc = jc.replace(dtype=dtype, param_dtype=dtype)
    tc = tc.replace(dtype=dtype, param_dtype=dtype)
    jshapes = jax.eval_shape(lambda: JM.init_params(jc, jax.random.key(0)))
    own = TM.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    _same_tree(jshapes, own)
    assert sorted(own["stack"]) == ["segments", "shared_attn"]
    assert own["stack"]["segments"][0]["mamba"]["inner"]["w_in"].shape[:2] \
        == (2, 6)
    _same_tree(JM.init_cache(jc, 2, 9), TM.init_cache(tc, 2, 9,
                                                      device="cpu"))
    if dtype == "float32":
        _same_tree(jshapes, tp)


@pytest.mark.parametrize("reduced,want", [(True, 5_761_216),
                                          (False, 2_422_670_240)])
def test_param_count_matches_jax(reduced, want):
    """The port's count on the meta device against the reference's
    ``eval_shape`` count (nothing allocated at full size)."""
    jc = (jregistry.get_reduced_config if reduced
          else jregistry.get_config)(ARCH)
    tc = (tregistry.get_reduced_config if reduced
          else tregistry.get_config)(ARCH)
    assert JM.count_params_analytic(jc) == want
    assert TM.count_params_analytic(tc) == want
    assert TM.count_params_analytic(tc, active_only=True) == want


def test_forward_and_prefill_match_jax(model):
    """Logits of a ragged 37-token sequence (three reduced chunks of 16)
    and the prefill step's last position."""
    jc, tc, jp, tp = model
    toks = np.random.default_rng(1).integers(0, tc.vocab_size, (2, 37))
    jlogits, _ = jax.jit(lambda p, b: JM.forward(jc, p, b))(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tlogits, _ = TM.forward(tc, tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(tlogits), np.asarray(jlogits), **F32)
    got = tsteps.make_prefill_step(tc, device="cpu")(
        tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(got), np.asarray(jlogits[:, -1]), **F32)


def test_greedy_decode_matches_jax(model):
    """Six greedy steps after a 4-token prompt through each package's
    caches (each application of the shared block its own KV cache, each
    Mamba layer its own conv window and state): the same logits at every
    step and the same tokens."""
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
    for j, t in zip(jax.tree_util.tree_leaves(jcache), tree.leaves(tcache)):
        np.testing.assert_allclose(_np(t), np.asarray(j), **F32)


def test_decode_matches_prefill(model):
    """The port alone: token-by-token decode logits == forward logits at
    every position of the reduced zamba2, fp32."""
    _, tc, _, tp = model
    s = 20
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
                               atol=1e-3, rtol=0.0)


def test_bf16_decode_gap_is_the_reference_s():
    """bf16 decode against bf16 prefill of the reduced zamba2 (20 tokens,
    every position), the JAX params carried over, in each package: the
    port's gap is the reference's.  The per-seed max gaps scatter (the
    reference's 0.103-0.117, the port's 0.105-0.133 with these three
    seeds), so the mean |gap| over all positions and logits of the three
    is held, to 10% (the seed-to-seed spread of that mean): 0.0191 (the
    reference) against 0.0195 (the port) with these draws."""
    jc = jregistry.get_reduced_config(ARCH)
    tc = tregistry.get_reduced_config(ARCH)
    s = 20
    toks = np.random.default_rng(4).integers(0, tc.vocab_size, (1, s))
    jinit = jax.jit(lambda k: JM.init_params(jc, k))
    jfwd = jax.jit(lambda p, b: JM.forward(jc, p, b)[0])
    jstep = jax.jit(lambda p, c, t, pos: JM.decode_step(jc, p, c, t, pos))
    gaps = {"reference": [], "port": []}
    for seed in (1, 2, 3):
        jp = jinit(jax.random.key(seed))
        tp = convert.tree_from_jax(jax.tree.map(np.asarray, jp))
        full = np.asarray(jfwd(jp, {"tokens": jnp.asarray(toks, jnp.int32)}),
                          np.float32)
        cache, steps = JM.init_cache(jc, 1, s), []
        for t in range(s):
            lg, cache = jstep(jp, cache, jnp.asarray(toks[:, t:t + 1],
                                                     jnp.int32),
                              jnp.full((1,), t, jnp.int32))
            steps.append(np.asarray(lg[:, -1], np.float32))
        gaps["reference"].append(np.abs(np.stack(steps, 1) - full))
        with torch.no_grad():
            full = _np(TM.forward(tc, tp, {"tokens": torch.from_numpy(
                toks)})[0])
            cache, steps = TM.init_cache(tc, 1, s, device="cpu"), []
            for t in range(s):
                lg, cache = TM.decode_step(
                    tc, tp, cache, torch.from_numpy(toks[:, t:t + 1]),
                    torch.tensor([t], dtype=torch.int32))
                steps.append(_np(lg[:, 0]))
        gaps["port"].append(np.abs(np.stack(steps, 1) - full))
    ref, port = (float(np.mean(gaps[k])) for k in ("reference", "port"))
    assert 0 < port <= 1.1 * ref, (port, ref)


def test_serve_launcher_runs_zamba_reduced(capsys):
    """``launch.serve --arch zamba2-2.7b --device cpu`` runs the reduced
    hybrid and prints the JAX launcher's lines."""
    res = tserve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "3", "--gen", "2"])
    assert res["tokens"].shape == (2, 2)
    assert torch.isfinite(res["logits"]).all()
    out = capsys.readouterr().out
    assert f"[arch] {ARCH} (reduced) batch=2 cache=5" in out
    assert "[decode] 2 tok" in out


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 33),
                                           (False, 0)])
def test_flash_attention_ref_at_d80_matches_pallas(causal, window):
    """#4's plain route (what ``ops.flash_attention`` runs on a CPU
    tensor) at zamba2's head dim 80, GQA 4 over 2, S = 100 (ragged against
    the 32-row blocks), against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(80)
    B, S, H, KV, D = 1, 100, 4, 2, 80
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


def test_loss_gradients_match_jax(model):
    """``loss_fn``'s gradient through the hybrid stack (each Mamba layer
    and each application of the shared block recomputed under
    ``torch.utils.checkpoint``, the shared block's gradient summed over
    its applications) against ``jax.grad`` of the reference's, leaf by
    leaf, fp32."""
    jc, tc, jp, tp = model
    rng = np.random.default_rng(7)
    toks = rng.integers(0, tc.vocab_size, (2, 21))
    labels = rng.integers(0, tc.vocab_size, (2, 21))
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          "labels": jnp.asarray(labels, jnp.int32)}
    jgrads = jax.jit(jax.grad(lambda p: JM.loss_fn(jc, p, jb)[0]))(jp)
    leaves = [t.clone().requires_grad_() for t in tree.leaves(tp)]
    loss, _ = TM.loss_fn(tc, tree.unflatten(tp, leaves),
                         {"tokens": torch.from_numpy(toks),
                          "labels": torch.from_numpy(labels)})
    tgrads = torch.autograd.grad(loss, leaves)
    for j, t in zip(jax.tree_util.tree_leaves(jgrads), tgrads):
        j = np.asarray(j)
        np.testing.assert_allclose(_np(t), j, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(j).max(), 1e-6))
