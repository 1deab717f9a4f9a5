"""Flat-buffer parameter representation.

The fleet is held as matrices, not dicts of tensors: every agent's
parameters are one contiguous fp32 row of an ``(A, N)`` buffer (RSUs
``(R, N)``, cloud ``(N,)``), so each aggregation layer is one ``(R, A) @
(A, N)`` kernel and the dual-proximal update one elementwise kernel.

Leaf order is the JAX package's: ``jax.tree_util`` flattens a dict in
sorted key order, so the MLP's flat vector is ``b0, b1, w0, w1``.  The
port sorts the keys the same way, so a vector raveled by either package
has the same columns.

``storage_dtype`` is the fleet buffers' dtype (fp32 or bf16); ``ravel`` /
``unravel`` are fp32 masters (the cloud buffer and every eval boundary),
and ``to_storage`` is the one cast point for writes into fleet buffers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]

BUFFER_DTYPE = torch.float32

# accepted fleet-dtype spellings -> storage dtype
STORAGE_DTYPES = {
    "float32": torch.float32, "f32": torch.float32, "fp32": torch.float32,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
}


def resolve_storage_dtype(name) -> torch.dtype:
    """Fleet-buffer storage dtype from a config spelling or a dtype; only
    fp32 and bf16 are admitted."""
    if name is None:
        return BUFFER_DTYPE
    if isinstance(name, str):
        if name not in STORAGE_DTYPES:
            raise ValueError(f"unknown fleet dtype {name!r} "
                             f"(want one of {sorted(STORAGE_DTYPES)})")
        return STORAGE_DTYPES[name]
    if name not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported fleet dtype {name} "
                         f"(the dtype policy covers float32 | bfloat16)")
    return name


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Static ravel plan for one parameter dict (no leading fleet axis)."""

    keys: Tuple[str, ...]                 # sorted: the JAX leaf order
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]
    n: int                                # total flat length
    storage_dtype: torch.dtype = BUFFER_DTYPE

    def to_storage(self, x: torch.Tensor) -> torch.Tensor:
        """Cast into the fleet storage dtype (no copy when it matches)."""
        return x.to(self.storage_dtype)

    # -- single model: (N,) ------------------------------------------------
    def ravel(self, params: Params) -> torch.Tensor:
        return torch.cat([params[k].to(BUFFER_DTYPE).reshape(-1)
                          for k in self.keys])

    def unravel(self, vec: torch.Tensor) -> Params:
        return {k: vec[off:off + size].reshape(shape).to(dtype)
                for k, off, size, shape, dtype in zip(
                    self.keys, self.offsets, self.sizes, self.shapes,
                    self.dtypes)}

    # -- stacked fleet: (A, N) ---------------------------------------------
    def ravel_stacked(self, stacked: Params) -> torch.Tensor:
        a = stacked[self.keys[0]].shape[0]
        return torch.cat([stacked[k].to(BUFFER_DTYPE).reshape(a, -1)
                          for k in self.keys], dim=1)

    def unravel_stacked(self, mat: torch.Tensor) -> Params:
        a = mat.shape[0]
        return {k: mat[:, off:off + size].reshape((a,) + shape).to(dtype)
                for k, off, size, shape, dtype in zip(
                    self.keys, self.offsets, self.sizes, self.shapes,
                    self.dtypes)}


def spec_of(params: Params, *, storage_dtype=BUFFER_DTYPE) -> FlatSpec:
    """Build the ravel plan from a parameter template."""
    keys = tuple(sorted(params))
    shapes = tuple(tuple(params[k].shape) for k in keys)
    dtypes = tuple(params[k].dtype for k in keys)
    sizes = tuple(math.prod(s) for s in shapes)
    offsets = tuple(sum(sizes[:i]) for i in range(len(sizes)))
    return FlatSpec(keys=keys, shapes=shapes, dtypes=dtypes, offsets=offsets,
                    sizes=sizes, n=sum(sizes),
                    storage_dtype=resolve_storage_dtype(storage_dtype))
