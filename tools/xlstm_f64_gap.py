"""How far each package's fp32 gradient of one xlstm train step lies from a
float64 evaluation of the same loss, on the CPU.

The reduced xlstm-125m (fp32, ``--mlstm-chunk`` 16 by default: the
chunkwise mLSTM) is drawn by the JAX package and carried into the port
(``convert.tree_from_jax``); one loss (3 agents x 2 sequences of 40
tokens, CSR mask [1, 0, 1], as the train step forms it) is differentiated
by the reference (``jax.grad``), by the port in fp32, and by the port in
float64: its plain functions with the params, the activations, the
recurrent states and ``Tensor.float`` widened to float64.  Prints the loss
of each and, per leaf and over all leaves, the 2-norm of each fp32
gradient's distance from the float64 one relative to its norm.  If the
port lay further from float64 than the reference, its fp32 path would
lose precision somewhere; if not, the two differ by the order of their
sums.  Run from the repository root:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/xlstm_f64_gap.py [--mlstm-chunk 16]
"""
from __future__ import annotations

import argparse
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as jregistry
from repro.models import model as JM
from repro_torch import convert, tree
from repro_torch.configs import registry as tregistry
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.models import config as tconfig
from repro_torch.models import model as TM
from repro_torch.models import xlstm

A, B, S = 3, 2, 40
MASK = np.array([1.0, 0.0, 1.0], np.float32)


def _loss(per_example, mask):
    return (per_example.reshape(A, B).mean(1) * mask).sum() / 2.0


def _port_grads(cfg, params, batch):
    leaves = [l.detach().requires_grad_() for l in tree.leaves(params)]
    nll, _ = TM.per_example_loss(cfg, tree.unflatten(params, leaves), batch)
    loss = _loss(nll, torch.as_tensor(MASK).to(nll.dtype))
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.double().numpy() for g in grads]


def _float64(cfg, params, batch):
    """The port's loss and gradient with everything widened to float64."""
    saved = (torch.Tensor.float, xlstm.init_mlstm_state,
             xlstm.init_slstm_state, ops.ref)
    im, is_ = xlstm.init_mlstm_state, xlstm.init_slstm_state
    src = inspect.getsource(ref.slstm_scan_ref).replace("torch.float32",
                                                        "torch.float64")
    ns = dict(ref.__dict__)
    exec(src, ns)
    tconfig._DTYPES["float64"] = torch.float64
    try:
        torch.Tensor.float = lambda self, *a, **k: self.double()
        xlstm.init_mlstm_state = lambda *a, **k: xlstm.MLSTMState(
            *(t.double() for t in im(*a, **k)))
        xlstm.init_slstm_state = lambda *a, **k: xlstm.SLSTMState(
            *(t.double() for t in is_(*a, **k)))
        ops.ref = type("plain64", (), {
            "slstm_scan_ref": staticmethod(ns["slstm_scan_ref"])})
        return _port_grads(cfg.replace(dtype="float64",
                                       param_dtype="float64"),
                           tree.map_tree(lambda t: t.double(), params), batch)
    finally:
        (torch.Tensor.float, xlstm.init_mlstm_state, xlstm.init_slstm_state,
         ops.ref) = saved
        del tconfig._DTYPES["float64"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mlstm-chunk", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    kw = dict(dtype="float32", param_dtype="float32",
              mlstm_chunk=args.mlstm_chunk)
    jc = jregistry.get_reduced_config("xlstm-125m").replace(**kw)
    tc = tregistry.get_reduced_config("xlstm-125m").replace(**kw)
    jp = jax.jit(lambda k: JM.init_params(jc, k))(jax.random.key(args.seed))
    tp = convert.tree_from_jax(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(args.seed)
    flat = {k: rng.integers(0, tc.vocab_size, (A * B, S)).astype(np.int32)
            for k in ("tokens", "labels")}

    def jloss(p):
        nll, _ = JM.per_example_loss(
            jc, p, {k: jnp.asarray(v) for k, v in flat.items()})
        return _loss(nll, MASK)

    j_loss, j_grads = jax.jit(jax.value_and_grad(jloss))(jp)
    j_grads = [np.asarray(g, np.float64) for g in jax.tree.leaves(j_grads)]
    batch = {k: torch.as_tensor(v) for k, v in flat.items()}
    t_loss, t_grads = _port_grads(tc, tp, batch)
    x_loss, x_grads = _float64(tc, tp, batch)
    print(f"loss: reference fp32 {float(j_loss):.9f}, port fp32 "
          f"{t_loss:.9f}, port float64 {x_loss:.9f}")
    print(f"{'leaf':48s} {'|g|':>9s} {'port-f64':>9s} {'ref-f64':>9s} "
          f"{'port-ref':>9s}")
    tot = np.zeros(4)
    for (path, _), t, j, x in zip(tree.leaves_with_paths(tp), t_grads,
                                  j_grads, x_grads):
        n = np.linalg.norm(x)
        gaps = [np.linalg.norm(t - x), np.linalg.norm(j - x),
                np.linalg.norm(t - j)]
        tot += np.array([n, *gaps]) ** 2
        print(f"{path:48s} {n:9.3e} " + " ".join(
            f"{g / n:9.2e}" for g in gaps))
    n, *gaps = np.sqrt(tot)
    print(f"{'all leaves':48s} {n:9.3e} " + " ".join(
        f"{g / n:9.2e}" for g in gaps))


if __name__ == "__main__":
    main()
