"""Carry weights across from the JAX package.

The JAX package's parameters and flat buffers cross as numpy arrays
(``np.asarray`` of a JAX array, or ``jax.tree.map(np.asarray, params)`` for
a nested params tree), so this module needs no JAX.  bf16 arrays (numpy's
``ml_dtypes`` bfloat16) keep their bits.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import tree


def tensor_from_numpy(arr, *, device="cpu") -> torch.Tensor:
    """A numpy array (fp32, int or ml_dtypes bf16) as a torch tensor with
    the same values and dtype."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A torch tensor as numpy; bf16 comes back as fp32 (exact)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_from_jax(np_params: Dict[str, np.ndarray], *,
                    device="cpu") -> Dict[str, torch.Tensor]:
    """The JAX package's MLP params (a dict of arrays) as the port's."""
    return {k: tensor_from_numpy(np_params[k], device=device)
            for k in sorted(np_params)}


def flat_from_jax(np_flat, *, device="cpu") -> torch.Tensor:
    """A JAX flat buffer ((N,), (A, N) or (R, N), fp32 or bf16) as the
    port's.  The leaf order of both packages' ravel is the sorted key
    order, so the columns line up."""
    return tensor_from_numpy(np_flat, device=device)


def tree_from_jax(np_tree, *, device="cpu"):
    """The JAX package's nested params tree (dicts and lists of numpy
    arrays, fp32 or bf16) as the port's tree of tensors, bits kept."""
    return tree.map_tree(lambda a: tensor_from_numpy(a, device=device),
                         np_tree)
