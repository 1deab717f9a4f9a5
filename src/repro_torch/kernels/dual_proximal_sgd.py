"""Dual-proximal SGD update on the card (paper Alg. 1 l.4, Eq. 6): the
wrapper around the CUDA kernel ``csrc/dual_proximal_sgd.cu``.

    out = w - (lr*scale[a]) * (g + mu1*(w - a1) + mu2*(w - a2))

The contract is the TPU kernel's (``repro.kernels.dual_proximal_sgd``)
plus two things the flat engine's inline step needs: a per-row step scale
and anchors that may be one ``(N,)`` row broadcast over the ``A`` rows of
``w`` (the cloud master).  The scale is either a float ``(A,)`` tensor or
the engine's integer ``active_steps`` with the step index, from which the
kernel forms ``live = (step < active_steps)`` itself.  With no scale and
full-shape anchors it is the TPU kernel.

The scenario axis: a multi-scenario sweep passes its S fleets of A agents
as S*A rows.  An anchor may then hold one row a scenario, (S, N) (row a
reads row a // A), and ``lr`` / ``mu1`` / ``mu2`` may each be an (S,)
float32 tensor on the card in place of a float, which the kernel reads by
the row's scenario.  One launch serves every row.

Takes CUDA tensors only and raises on anything else; ``kernels/ops``
routes CPU tensors to ``kernels/ref``.  ``launches`` counts launches.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels import _lib

ANCHOR_DTYPES = (torch.float32, torch.bfloat16)
STEP_DTYPES = {torch.int32: 2, torch.int64: 3}   # the kernel's scale kinds
MAX_ROWS = 65535        # row groups go on gridDim.y, at least one row each

launches: Dict[str, int] = {"dual_proximal_sgd": 0}

# flags of repro_dual_proximal_sgd: a1's bf16 bit; a2's is the same
# shifted left by one; w's (and g's and out's) bit; the scale's kind from
# bit 4
_A1_BF16 = 1
_W_BF16 = 4
_SCALE_SHIFT = 4
W_DTYPES = (torch.float32, torch.bfloat16)


def _anchor(a: torch.Tensor, name: str, rows: int, n: int,
            dev: int) -> Tuple[int, int]:
    """(bf16 flag, rows each anchor row serves) of a full (rows, n)
    anchor (1), one broadcast (n,) row (rows), or one row a group of
    consecutive rows, (G, n) with G dividing rows (rows // G)."""
    if a.get_device() != dev:
        raise ValueError(f"{name}: expected cuda:{dev}, got {a.device}")
    if a.dtype not in ANCHOR_DTYPES or not a.is_contiguous():
        raise ValueError(f"{name}: want a contiguous fp32|bf16 tensor, got "
                         f"{a.dtype} (contiguous={a.is_contiguous()})")
    flag = _A1_BF16 if a.dtype == torch.bfloat16 else 0
    if a.shape == (n,):
        return flag, rows
    if a.dim() == 2 and a.shape[1] == n and 1 <= a.shape[0] <= rows \
            and rows % a.shape[0] == 0:
        return flag, rows // a.shape[0]
    raise ValueError(f"{name}: shape {tuple(a.shape)} is neither "
                     f"{(rows, n)}, a broadcast ({n},) row, nor (G, {n}) "
                     f"with G dividing {rows}")


def _hyper(value, name: str, rows: int, dev: int):
    """(value, None, 0) for a float; (0.0, tensor, S) for an (S,) float32
    tensor on cuda:dev with S dividing rows."""
    if not isinstance(value, torch.Tensor):
        return float(value), None, 0
    S = value.shape[0] if value.dim() == 1 else 0
    if (not S or rows % S or value.dtype != torch.float32
            or value.get_device() != dev or not value.is_contiguous()):
        raise ValueError(f"{name}: want a float or a contiguous (S,) float32 "
                         f"tensor on cuda:{dev} with S dividing {rows}, got "
                         f"{value.dtype} {tuple(value.shape)} on "
                         f"{value.device}")
    return 0.0, value, S


Hyper = Union[float, torch.Tensor]


def dual_proximal_sgd(w: torch.Tensor, g: torch.Tensor, a1: torch.Tensor,
                      a2: torch.Tensor, *, lr: Hyper, mu1: Hyper, mu2: Hyper,
                      scale: Optional[torch.Tensor] = None,
                      active_steps: Optional[torch.Tensor] = None,
                      step: int = 0,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused update of ``w`` (any shape; rows are its first axis when
    2-D), fp32 or bf16 with ``g`` and ``out`` in the same dtype (a bf16 out
    is the fp32 result rounded to nearest even, as the TPU kernel writes
    its output in w's dtype).  The row scale is ``scale`` (float32 (A,)),
    or ``step < active_steps`` (int32 or int64 (A,)), or 1; not both.
    Anchors are full, one broadcast row, or one row a group of rows;
    ``lr`` / ``mu1`` / ``mu2`` floats or (S,) float32 tensors (the
    scenario axis, see the module docstring; all tensors of one call have
    the same S).  ``out`` may be ``w`` itself (in-place update); otherwise a new tensor is
    allocated.  One launch; each operand is checked once."""
    dev = w.get_device()
    if dev < 0:
        raise ValueError(f"dual_proximal_sgd: w must be on cuda, got "
                         f"{w.device}")
    if w.dtype not in W_DTYPES or g.dtype != w.dtype:
        raise ValueError(f"dual_proximal_sgd: w and g must both be float32 "
                         f"or both bfloat16, got {w.dtype} and {g.dtype}")
    if g.shape != w.shape or g.get_device() != dev:
        raise ValueError("dual_proximal_sgd: g must match w")
    if not (w.is_contiguous() and g.is_contiguous()):
        raise ValueError("dual_proximal_sgd: w and g must be contiguous")
    rows, n = (w.shape[0], w.shape[1]) if w.dim() == 2 else (1, w.numel())
    if not (1 <= rows <= MAX_ROWS and n >= 1):
        raise ValueError(f"dual_proximal_sgd: unsupported shape "
                         f"{tuple(w.shape)}")
    if w.dim() != 2:        # one row: anchors must match w's shape
        a1, a2 = a1.reshape(-1), a2.reshape(-1)
    bf1, group1 = _anchor(a1, "a1", rows, n, dev)
    bf2, group2 = _anchor(a2, "a2", rows, n, dev)
    flags = bf1 | bf2 << 1 | (_W_BF16 if w.dtype == torch.bfloat16 else 0)
    hyper = [_hyper(v, k, rows, dev)
             for k, v in (("lr", lr), ("mu1", mu1), ("mu2", mu2))]
    groups = {s for _, t, s in hyper if t is not None}
    if len(groups) > 1:
        raise ValueError(f"dual_proximal_sgd: lr, mu1 and mu2 tensors of "
                         f"different lengths {sorted(groups)}")
    hp_group = rows // groups.pop() if groups else rows
    if scale is not None and active_steps is not None:
        raise ValueError("dual_proximal_sgd: pass scale or active_steps, "
                         "not both")
    if scale is not None:
        row_scale, what = scale, "float32 scale"
        kind = 1 if scale.dtype == torch.float32 else 0
    elif active_steps is not None:
        row_scale, what = active_steps, "int32|int64 active_steps"
        kind = STEP_DTYPES.get(active_steps.dtype, 0)
    else:
        row_scale = None
    if row_scale is not None:
        if (not kind or row_scale.shape != (rows,)
                or row_scale.get_device() != dev
                or not row_scale.is_contiguous()):
            raise ValueError(
                f"dual_proximal_sgd: want a contiguous ({rows},) {what} on "
                f"cuda:{dev}, got {row_scale.dtype} "
                f"{tuple(row_scale.shape)} on {row_scale.device}")
        flags |= kind << _SCALE_SHIFT
    if out is None:
        out = torch.empty_like(w)
    elif (out.shape != w.shape or out.dtype != w.dtype
          or out.get_device() != dev or not out.is_contiguous()):
        raise ValueError("dual_proximal_sgd: out must match w")
    (lr_f, lr_t, _), (mu1_f, mu1_t, _), (mu2_f, mu2_t, _) = hyper
    rc = _lib.library().repro_dual_proximal_sgd(
        out.data_ptr(), w.data_ptr(), g.data_ptr(), a1.data_ptr(), group1,
        a2.data_ptr(), group2,
        None if row_scale is None else row_scale.data_ptr(),
        int(step), rows, n, lr_f, mu1_f, mu2_f,
        *(None if t is None else t.data_ptr() for t in (lr_t, mu1_t, mu2_t)),
        hp_group, flags, torch._C._cuda_getCurrentRawStream(dev))
    _lib.check(rc, "dual_proximal_sgd")
    launches["dual_proximal_sgd"] += 1
    return out
