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

