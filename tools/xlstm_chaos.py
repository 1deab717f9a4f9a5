"""How sensitive the reduced xlstm's training is at the tests' settings, on
the CPU: why ``tests/test_torch_train_whisper_xlstm.py`` holds each fp32
train step from the same state and xlstm's round at one local step.

1. Three chained train steps of the reduced xlstm (fp32, ``mlstm_chunk``
   16, ``HP_STEP``, the JAX package's params carried into the port) in
   both packages: after each step the largest |port - reference| of any
   param and the largest |momentum|.
2. The third step from the same state (the port's after two steps,
   carried into the reference): the largest |port - reference| of the
   params after it.
3. The reference's one-rank round (``HP_ROUND`` at the given LAR and
   local epochs) from its params and from its params plus 1e-6 x N(0, 1)
   noise: the largest change of the new cloud, beside the port's gap to
   the reference.

Run from the repository root:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/xlstm_chaos.py
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
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
from repro_torch.launch.h2fed_round import make_h2fed_round

KW = dict(dtype="float32", param_dtype="float32", mlstm_chunk=16)
HP_STEP = dict(mu1=0.05, mu2=0.01, lr=0.1)
HP_ROUND = dict(mu1=0.05, mu2=0.01, lr=0.1)
MASK = np.array([1.0, 0.0, 1.0], np.float32)


def _batch(cfg, lead, S, seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, lead + (S,)).astype(np.int32)
    labels.reshape(-1, S)[0, :3] = -1
    return {"tokens": rng.integers(0, cfg.vocab_size,
                                   lead + (S,)).astype(np.int32),
            "labels": labels}


def _max_gap(port_tree, jax_tree) -> float:
    return max(float(np.abs(convert.tensor_to_numpy(a)
                            - np.asarray(b, np.float32)).max())
               for a, b in zip(tree.leaves(port_tree),
                               jax.tree.leaves(jax_tree)))


def _to_jax(like, port_tree):
    return jax.tree.unflatten(jax.tree.structure(like), [
        jnp.asarray(convert.tensor_to_numpy(x))
        for x in tree.leaves(port_tree)])


def main() -> None:
    jc = jregistry.get_reduced_config("xlstm-125m").replace(**KW)
    tc = tregistry.get_reduced_config("xlstm-125m").replace(**KW)
    jp = jax.jit(lambda k: JM.init_params(jc, k))(jax.random.key(0))
    batches = [_batch(tc, (3, 2), 24, s) for s in range(3)]
    step = jax.jit(jsteps.make_train_step(jc, JHP(**HP_STEP)))
    jstate = jsteps.TrainState(
        params=jp, momentum=jax.tree.map(
            lambda l: jnp.zeros(l.shape, jnp.float32), jp),
        anchor_rsu=jp, anchor_cloud=jp)
    tstate = tsteps.train_state(
        convert.tree_from_jax(jax.tree.map(np.asarray, jp)))
    tstep = tsteps.make_train_step(tc, H2FedParams(**HP_STEP), device="cpu")
    states = []
    for i, b in enumerate(batches):
        states.append(tstate)
        jstate, _ = step(jstate, jax.tree.map(jnp.asarray, b),
                         jnp.asarray(MASK))
        tstate, _ = tstep(tstate, b, MASK)
        mom = max(float(t.abs().max()) for t in tree.leaves(tstate.momentum))
        print(f"chained step {i}: params max |port - reference| "
              f"{_max_gap(tstate.params, jstate.params):.3e}, momentum max "
              f"|m| {mom:.3f}")
    start = states[2]
    same = jsteps.TrainState(*(_to_jax(jp, t) for t in start))
    same, _ = step(same, jax.tree.map(jnp.asarray, batches[2]),
                   jnp.asarray(MASK))
    ported, _ = tstep(start, batches[2], MASK)
    print(f"step 2 from the same state: params max |port - reference| "
          f"{_max_gap(ported.params, same.params):.3e}")

    rng = np.random.default_rng(7)
    n_data = rng.uniform(1, 3, (1,)).astype(np.float32)
    noise = np.random.default_rng(1)
    noisy = jax.tree.map(lambda l: l + 1e-6 * jnp.asarray(
        noise.standard_normal(l.shape), l.dtype), jp)
    mesh = make_test_mesh((1, 1, 1))
    for lar, epochs in ((2, 2), (2, 1), (1, 2), (1, 1)):
        hp = dict(HP_ROUND, lar=lar, local_epochs=epochs)
        batch = _batch(tc, (lar, 1, 2), 16, 7)
        mask = np.ones((lar, 1), np.float32)
        fn = jax.jit(j_round(jc, JHP(**hp), mesh))
        args = (jax.tree.map(jnp.asarray, batch), jnp.asarray(mask),
                jnp.asarray(n_data))
        with mesh:
            jo, _ = fn(jp, *args)
            jn, _ = fn(noisy, *args)
        to, _ = make_h2fed_round(tc, H2FedParams(**hp), device="cpu")(
            convert.tree_from_jax(jax.tree.map(np.asarray, jp)), batch, mask,
            n_data)
        shift = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                    for a, b in zip(jax.tree.leaves(jo), jax.tree.leaves(jn)))
        print(f"round LAR {lar}, E {epochs}: the reference's cloud moves by "
              f"{shift:.3e} under 1e-6 noise in its params; port vs "
              f"reference {_max_gap(to, jo):.3e}")


if __name__ == "__main__":
    torch.set_num_threads(4)
    main()
