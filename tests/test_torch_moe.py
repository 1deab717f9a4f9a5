"""The port's MoE layer (``repro_torch/models/moe.py``) on the CPU against
the JAX package's ``repro.models.moe``: the same params (carried across by
``convert.tree_from_jax``) and inputs made from a numpy seed, for the
capacity dispatch (with and without drops, on a token count that is and
one that is not a multiple of the group size) and the ragged dispatch, and
the full configs' parameter counts on the meta device.

Tolerance: fp32 1e-5 absolute / relative on the output and the aux loss
(SwiGLU products and top-k sums taken in another order; the routing, the
slots and the drops are the same).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import model as JM
from repro.models import moe as JMoE

from repro_torch import convert, tree
from repro_torch.configs import registry as tregistry
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE

F32 = dict(rtol=1e-5, atol=1e-5)
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


def _configs(arch: str, **moe):
    """The reduced config of ``arch`` in fp32 (4 experts, top 2, group 32,
    d_model 256) in both packages, with ``moe`` fields replaced."""
    jc = jregistry.get_reduced_config(arch).replace(**F32_CFG)
    tc = tregistry.get_reduced_config(arch).replace(**F32_CFG)
    return (jc.replace(moe=dataclasses.replace(jc.moe, **moe)),
            tc.replace(moe=dataclasses.replace(tc.moe, **moe)))


@pytest.fixture(scope="module")
def layer():
    jc, _ = _configs("deepseek-v2-lite-16b")
    jp = JMoE.moe_init(jc, jax.random.key(0))
    return jp, convert.tree_from_jax(jax.tree.map(np.asarray, jp))


# (dispatch_impl, capacity_factor, (B, S)): 50 tokens are one full group
# of 32 and one padded with 14 zero rows; 64 are two whole groups; a
# capacity factor of 0.5 gives C = 8 slots an expert a group for 64
# assignments, so most of them drop
CASES = [("einsum", 1.25, (2, 25)), ("einsum", 1.25, (2, 32)),
         ("einsum", 0.5, (2, 25)), ("ragged", 1.25, (2, 25)),
         ("ragged", 1.25, (2, 32))]


@pytest.mark.parametrize("impl,cf,shape", CASES,
                         ids=[f"{i}-cf{c}-{b}x{s}" for i, c, (b, s) in CASES])
def test_moe_apply_matches_jax(layer, impl, cf, shape):
    jp, tp = layer
    jc, tc = _configs("deepseek-v2-lite-16b", dispatch_impl=impl,
                      capacity_factor=cf)
    x = np.random.default_rng(sum(shape)).standard_normal(
        shape + (jc.d_model,)).astype(np.float32)
    want, want_aux = JMoE.moe_apply(jc, jp, jnp.asarray(x))
    got, aux = TMoE.moe_apply(tc, tp, torch.from_numpy(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(float(aux), float(want_aux), **F32)
    if cf < 1:
        # drops happened: the layer differs from the one without them
        _, full = _configs("deepseek-v2-lite-16b", capacity_factor=4.0)
        undropped, _ = TMoE.moe_apply(full, tp, torch.from_numpy(x))
        assert not torch.allclose(got, undropped, **F32)


def test_moe_params_match_jax_tree(layer):
    """The same leaves (router fp32, experts with their E axis, the shared
    experts) in JAX's leaf order; the port's own init draws the same
    shapes and dtypes, stacked behind a layer axis."""
    jp, tp = layer
    _, tc = _configs("deepseek-v2-lite-16b")
    own = TMoE.moe_init(tc, torch.Generator().manual_seed(0), lead=(3,))
    jleaves = jax.tree_util.tree_leaves(jp)
    assert jax.tree_util.tree_structure(jp) == jax.tree_util.tree_structure(
        tree.map_tree(lambda t: 0, own))
    for t, o, j in zip(tree.leaves(tp), tree.leaves(own), jleaves):
        assert tuple(t.shape) == j.shape and tuple(o.shape) == (3,) + j.shape
        assert str(o.dtype).removeprefix("torch.") == str(j.dtype)
    assert jp["router"].dtype == jnp.float32


@pytest.mark.parametrize("arch,total,active", [
    ("deepseek-v2-lite-16b", 16_210_311_168, 2_663_233_536),
    ("kimi-k2-1t-a32b", 1_044_860_859_392, 34_755_015_680)])
def test_full_config_param_counts_on_meta(arch, total, active):
    """Counted on the meta device (nothing allocated), equal to the
    reference's: every leaf, and with the routed experts scaled by top_k /
    n_experts."""
    cfg = tregistry.get_config(arch)
    assert TM.count_params_analytic(cfg) == total
    assert TM.count_params_analytic(cfg, active_only=True) == active
    jcfg = jregistry.get_config(arch)
    assert JM.count_params_analytic(jcfg) == total
    assert JM.count_params_analytic(jcfg, active_only=True) == active
