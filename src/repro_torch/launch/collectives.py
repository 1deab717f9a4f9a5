"""Every collective of the sharded engines, counted.

The JAX package's collectives are ``jax.lax`` primitives inside
``shard_map``; the port's map onto ``torch.distributed`` calls on a
``FleetMesh``'s groups:

  ``jax.lax.psum``                     -> ``all_reduce`` (sum)
  ``jax.lax.pmax``                     -> ``all_reduce(op="max")``
  ``jax.lax.all_gather(tiled=True)``   -> ``all_gather_cat`` (the list form
                                          of ``all_gather``, then a cat)
  psum, then ``dynamic_slice_in_dim``  -> ``all_reduce``, then a slice in
                                          the engine (as the reference)

A collective over axes that hold one rank is the identity and is neither
run nor counted.  Every other call is counted under ``(where, axes)``:
``where`` names the place in the round that makes it (``lar``: inside the
local-round or tick loop; ``cloud``: the cloud layer; ``round``: once a
round outside both; ``eval``, ``gather``: outside the rounds) and
``axes`` the mesh axes it spans, joined by ``+``.  ``counts()`` gives the
calls and the bytes this rank contributed; the tests and ``chip_smoke.py``
read them in place of the reference's ``hlo_analysis.collective_schedule``
(for example, the rsu-sharded round makes no ``pod`` collective under
``lar``).

On ``gloo`` a CUDA tensor is staged through host memory explicitly (a
copy down, the collective on the host tensor, a copy up), so the same
calls serve ranks that share one card; ``nccl`` takes CUDA tensors as
they are.

The tensor-parallel layers (a model split over the mesh's ``model``
group, ``launch/sharding.ModelAxis``) use four collectives that autograd
differentiates, all counted at ``where="tp"`` on ``model``:

  ``tp_copy``           identity forward, fp32 sum backward: the input
                        of products whose weight columns are split;
  ``tp_reduce``         sum forward, identity backward: the partial
                        outputs of products whose weight rows are split;
  ``tp_embed``          the vocab-split embedding: this rank's rows
                        looked up, the others' tokens zero, summed;
  ``tp_cross_entropy``  the vocab-split cross-entropy: the max, the sum
                        of exponentials and the label's logit, each
                        summed (the max: its maximum) over the group.
"""
from __future__ import annotations

import pickle
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

_COUNTS: Dict[Tuple[str, str], List[int]] = {}


def _axes(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _note(where: str, axes: Tuple[str, ...], nbytes: int) -> None:
    c = _COUNTS.setdefault((where, "+".join(axes)), [0, 0])
    c[0] += 1
    c[1] += int(nbytes)


def _staged(mesh, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.is_cuda


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(t: torch.Tensor, mesh, axes, *, where: str,
               op: str = "sum") -> torch.Tensor:
    """Sum (or, with ``op="max"``, maximum) of ``t`` over the ranks of
    ``axes``; returns a new tensor (``t`` itself is left as it is) in
    ``t``'s dtype and device."""
    axes = _axes(axes)
    group = mesh.group(axes)
    if group is None:
        return t
    buf = t.detach().contiguous().to("cpu" if _staged(mesh, t) else t.device,
                                     copy=True)
    dist.all_reduce(buf, op=_OPS[op], group=group)
    _note(where, axes, t.numel() * t.element_size())
    return buf.to(t.device)


def all_gather_cat(t: torch.Tensor, mesh, axes, *, where: str,
                   dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` over ``axes``, concatenated along ``dim`` in rank
    order along the axes (the reference's tiled ``all_gather``)."""
    axes = _axes(axes)
    group = mesh.group(axes)
    if group is None:
        return t
    src = t.detach().contiguous()
    if _staged(mesh, src):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.axis_size(axes))]
    dist.all_gather(parts, src, group=group)
    _note(where, axes, t.numel() * t.element_size())
    return torch.cat(parts, dim=dim).to(t.device)


def all_gather_objects(obj, mesh, axes, *, where: str) -> list:
    """Every rank's picklable ``obj`` over ``axes``, in rank order."""
    axes = _axes(axes)
    group = mesh.group(axes)
    if group is None:
        return [obj]
    out: list = [None] * mesh.axis_size(axes)
    dist.all_gather_object(out, obj, group=group)
    _note(where, axes, len(pickle.dumps(obj)))
    return out


# --------------------------------------------------------------------------
# tensor-parallel collectives (autograd)
# --------------------------------------------------------------------------

def _tp_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed over the model group in fp32, back in ``t``'s dtype."""
    return all_reduce(t.float(), mesh, "model", where="tp").to(t.dtype)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _tp_sum(g, ctx.mesh), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x, mesh, "model", where="tp")

    @staticmethod
    def backward(ctx, g):
        return g, None


def tp_copy(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` as it is; its gradient summed (in fp32) over the model group.
    Goes before products whose weights hold this rank's columns."""
    return _Copy.apply(x, mesh)


def tp_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over the model group in its own dtype (pass fp32
    partials: they are rounded once, after the sum); the gradient passes
    as it is."""
    return _Reduce.apply(x, mesh)


def _vocab_rows(mesh, rows: int) -> int:
    """The first vocab row that this rank holds of a table split in
    ``rows``-row blocks over the model group."""
    return mesh.coordinate("model") * rows


def tp_embed(table: torch.Tensor, tokens: torch.Tensor,
             mesh) -> torch.Tensor:
    """Rows of a vocab-split embedding ``table`` (this rank's rows) for
    ``tokens`` (int64 ids into the whole vocab): each rank looks up the
    tokens that fall in its rows, zero for the rest, and the group sums
    (exactly: one rank is nonzero a token) in the table's dtype."""
    rows = table.shape[0]
    local = tokens - _vocab_rows(mesh, rows)
    inside = (local >= 0) & (local < rows)
    x = table[torch.where(inside, local, 0)]
    return tp_reduce(torch.where(inside[..., None], x, 0), mesh)


class _CrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, mesh):
        rows = logits.shape[-1]
        top = all_reduce(logits.max(dim=-1).values, mesh, "model",
                         where="tp", op="max")
        e = torch.exp(logits - top[..., None])
        total = all_reduce(e.sum(dim=-1), mesh, "model", where="tp")
        local = labels - _vocab_rows(mesh, rows)
        inside = (local >= 0) & (local < rows)
        local = torch.where(inside, local, 0)
        picked = logits.gather(-1, local[..., None])[..., 0]
        picked = all_reduce(torch.where(inside, picked, 0.0), mesh,
                            "model", where="tp")
        ctx.save_for_backward(e, total, local, inside)
        return torch.log(total) + top - picked

    @staticmethod
    def backward(ctx, g):
        e, total, local, inside = ctx.saved_tensors
        grad = e / total[..., None]
        grad.scatter_add_(-1, local[..., None],
                          -inside[..., None].to(grad.dtype))
        return grad * g[..., None], None, None


def tp_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                     mesh) -> torch.Tensor:
    """Next-token NLL (labels' shape) from fp32 logits over this rank's
    vocab columns (``logits[..., j]`` is vocab id ``start + j``) and int64
    ``labels`` >= 0 into the whole vocab: ``log sum exp - logit[label]``
    with the max, the sum and the label's logit taken over the group.
    The backward needs no collective."""
    return _CrossEntropy.apply(logits, labels, mesh)


def counts() -> Dict[str, Dict[str, int]]:
    """``"where/axes"`` -> {"calls", "bytes"} since the last ``reset``."""
    return {f"{w}/{a}": {"calls": c, "bytes": b}
            for (w, a), (c, b) in sorted(_COUNTS.items())}


def calls(where: str, axis: str = "") -> int:
    """Calls made at ``where`` by collectives whose axes include ``axis``
    (any axes when empty)."""
    return sum(c for (w, a), (c, _) in _COUNTS.items()
               if w == where and (not axis or axis in a.split("+")))


def reset() -> None:
    _COUNTS.clear()

