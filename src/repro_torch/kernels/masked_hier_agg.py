"""Masked hierarchical aggregation on the card (paper Alg. 2 l.8 / Alg. 3
l.6): wrappers around the CUDA kernels of ``csrc/fused_agg_blend.cu``.

The ring kernel serves the entry points with a previous buffer: the fused
aggregate-and-blend of ``repro.kernels.masked_hier_agg._fused_agg_blend``,

    out[r, n] = guard[r] ? (retained[r]*buf[r, n] + sum_i W_i[r, :] @ X_i[:, n])
                             / safe[r]
                         : buf[r, n]

``agg_blend`` (RSU layer plus mass guard) and ``cloud_blend`` (R -> 1 plus
keep guard into the fp32 master) are one launch each: the kernel builds
the normalized weights, the masses and the guard on the device from the
engine's (weights, mask, rsu_assign) or RSU masses.  ``agg_absorb`` (the
async tick's two cohorts plus the retained buffer) hands it the weight
matrices and the ``coef`` rows ``[retained | safe | guard]`` from
``core.aggregation``.  The matmul kernels serve the plain ``(R, A) @ (A,
N)`` of ``weighted_agg_matmul`` (``masked_hier_agg`` and ``cloud_agg``,
the ``fused=False`` path) and, with an fp32 output, the unnormalized
``scatter_accumulate`` of the async tick, ``chunk_agg`` of the
cohort-streamed rounds and ``block_local_agg`` of the sharded rounds.
They take any A: past the shared memory of one weight chunk they stage W
in agent tiles.  W stays fp32 and the kernels
accumulate in fp32 whatever the fleet dtype.

Past the ring kernel's shared memory (``ring_fits``), ``agg_blend`` and
``agg_absorb`` take the matmul kernel's agent tiles instead, as the
streamed rounds do, so the resident engines take any fleet.

The scenario axis: every entry also takes a multi-scenario sweep's S
stacked fleets, a leading S axis on X (S, A, N), the buffers (S, R, N) and
the weights, and serves all of them in one launch (the kernels put the
scenario on the grid).  Per-agent inputs (weights, mask, rsu_assign) are
then (S, A) or one (A,) row every scenario shares; the matmul's W is (S,
R, A) or one shared (R, A).  The ring kernel's shared-memory limit is one
scenario's.

Every function takes CUDA tensors only and raises on anything else; the
CPU route is ``kernels/ops``' choice of ``kernels/ref``.  ``launches``
counts kernel launches per entry point.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.aggregation import (buffer_absorb, build_weight_matrix,
                                          cohort_mass, normalize_blend,
                                          normalized_weights,
                                          unnormalized_weight_matrix)
from repro_torch.kernels import _lib

FLEET_DTYPES = (torch.float32, torch.bfloat16)
_W_DTYPES = (torch.float32,)
SMEM_BYTES = 232_448    # shared memory a block may opt into on sm_90
RING_MIN_BYTES = 8192   # the ring kernel's copy ring at its fewest threads
_MASK_KINDS = {torch.float32: 1, torch.bool: 2}      # the kernel's codes
_ASSIGN_KINDS = {torch.int32: 1, torch.int64: 2}
_MASK_DTYPES, _ASSIGN_DTYPES = tuple(_MASK_KINDS), tuple(_ASSIGN_KINDS)
MAX_SCENARIOS = 65535   # scenarios go on gridDim.y
# repro_agg_blend's bits for a per-agent operand every scenario shares
_SHARED_BITS = {"weights": 64, "mask": 128, "rsu_assign": 256}

launches: Dict[str, int] = {"agg_blend": 0, "cloud_blend": 0,
                            "agg_absorb": 0, "weighted_agg_matmul": 0,
                            "scatter_accumulate": 0, "chunk_agg": 0,
                            "block_local_agg": 0, "agg_blend_tiled": 0,
                            "agg_absorb_tiled": 0}


def _require(t: torch.Tensor, name: str, shape: Tuple[int, ...],
             dtypes: Sequence[torch.dtype], index: int) -> None:
    """Raise unless ``t`` lies on CUDA device ``index`` with one of
    ``dtypes``, this shape, contiguous (get_device is -1 on the CPU)."""
    if t.get_device() != index:
        raise ValueError(f"{name}: expected a tensor on cuda:{index}, got "
                         f"{t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {tuple(dtypes)}")
    if t.shape != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _scenarios(entry: str, S: int) -> None:
    if not 1 <= S <= MAX_SCENARIOS:
        raise ValueError(f"{entry}: {S} scenarios, want 1 to {MAX_SCENARIOS}")


def _per_agent(t: torch.Tensor, name: str, S: int, A: int,
               dtypes: Sequence[torch.dtype], index: int) -> int:
    """Check a per-agent operand, (S, A) or one shared (A,) row; returns
    its repro_agg_blend bit when shared, else 0."""
    shared = t.dim() == 1
    _require(t, name, (A,) if shared else (S, A), dtypes, index)
    return _SHARED_BITS[name] if shared else 0


def _row_chunk(R: int, sizes) -> int:
    """The kernels' chunk of rows: the smallest of ``sizes`` that holds R,
    else the largest (R is then done in chunks)."""
    return next((c for c in sizes if R <= c), sizes[-1])


def ring_fits(R: int, n_agents: int, build: bool) -> bool:
    """Whether the ring kernel takes ``n_agents`` agents (of every cohort)
    at R rows.  It keeps a (row chunk x agents) weight tile, 4 floats a
    row, (``build``) 8 bytes an agent and its ring (at least
    RING_MIN_BYTES) in shared memory, the chunk the smallest of 1, 2, 4,
    8, 12, 16 that holds R.  This is the one place that chooses between the
    ring and the agent-tiled route of ``agg_blend`` and ``agg_absorb``."""
    row_chunk = _row_chunk(R, (1, 2, 4, 8, 12, 16))
    need = ((row_chunk + 2 * build) * n_agents + 4 * row_chunk) * 4
    return need + RING_MIN_BYTES <= SMEM_BYTES


def _check_ring_smem(entry: str, R: int, n_agents: int,
                     build: bool) -> None:
    if not ring_fits(R, n_agents, build):
        raise ValueError(f"{entry}: {n_agents} agents at {R} rows of "
                         f"weights and the copy ring exceed {SMEM_BYTES} "
                         f"bytes of shared memory")


def _launch(entry: str, coef: torch.Tensor,
            weight_mats: Sequence[torch.Tensor],
            stackeds: Sequence[torch.Tensor], buf: torch.Tensor,
            out: torch.Tensor) -> torch.Tensor:
    """Check every operand and launch ``repro_fused_agg_blend`` (the coef
    form) on the current stream: out (R, N) from coef (R, 3), W_i (R, a_i)
    and X_i (a_i, N), or every operand with a leading scenario axis S.
    The caller allocated ``out`` (contiguous, on X's device), so only its
    dtype is checked.  It makes each check once and nothing more, and reads
    the stream raw rather than through a Stream object."""
    n_pairs = len(weight_mats)
    if n_pairs not in (1, 2) or len(stackeds) != n_pairs:
        raise ValueError(f"{entry}: want 1 or 2 (W, X) pairs")
    dev = out.get_device()
    if dev < 0:
        raise ValueError(f"{entry}: expected CUDA tensors, got {out.device}")
    if out.dim() not in (2, 3):
        raise ValueError(f"{entry}: out must be (R, N) or (S, R, N), got "
                         f"{tuple(out.shape)}")
    lead = tuple(out.shape[:-2])
    S = lead[0] if lead else 1
    R, N = out.shape[-2:]
    x_dtype = stackeds[0].dtype
    if R < 1 or N < 1:
        raise ValueError(f"{entry}: empty output {tuple(out.shape)}")
    _scenarios(entry, S)
    if out.dtype not in FLEET_DTYPES:
        raise ValueError(f"{entry}: dtype {out.dtype} not in {FLEET_DTYPES}")
    n_agents = 0
    for i, (w, x) in enumerate(zip(weight_mats, stackeds)):
        a = w.shape[-1] if w.dim() == len(lead) + 2 else -1
        if a < 1:
            raise ValueError(f"{entry}: W_{i} must be {lead} + (R, A) with "
                             f"A >= 1")
        _require(w, f"W_{i}", lead + (R, a), _W_DTYPES, dev)
        _require(x, f"X_{i}", lead + (a, N), (x_dtype,), dev)
        n_agents += a
    _require(coef, "coef", lead + (R, 3), _W_DTYPES, dev)
    _require(buf, "buf", tuple(out.shape), (out.dtype,), dev)
    if out.dtype not in (x_dtype, torch.float32):
        raise ValueError(f"{entry}: out dtype {out.dtype} must be X's "
                         f"({x_dtype}) or float32")
    _check_ring_smem(entry, R, n_agents, build=False)
    w2, x2 = (weight_mats[1], stackeds[1]) if n_pairs == 2 else (None, None)
    rc = _lib.library().repro_fused_agg_blend(
        coef.data_ptr(), weight_mats[0].data_ptr(), stackeds[0].data_ptr(),
        weight_mats[0].shape[-1],
        None if w2 is None else w2.data_ptr(),
        None if x2 is None else x2.data_ptr(),
        0 if w2 is None else w2.shape[-1],
        buf.data_ptr(), out.data_ptr(), R, N,
        x_dtype == torch.bfloat16, out.dtype == torch.bfloat16, S,
        torch._C._cuda_getCurrentRawStream(dev))
    _lib.check(rc, "fused_agg_blend")
    launches[entry] += 1
    return out


def _fused_agg_blend(coef: torch.Tensor, weight_mats, stackeds,
                     buf: torch.Tensor, *, entry: str) -> torch.Tensor:
    """out = where(guard, (retained*buf + sum_i W_i @ X_i) / safe, buf) in
    one pass; out dtype == buf dtype."""
    return _launch(entry, coef.contiguous(),
                   [w.contiguous() for w in weight_mats], list(stackeds),
                   buf, torch.empty_like(buf))


def _agg_blend_launch(entry: str, x: torch.Tensor, weights: torch.Tensor,
                      mask: Optional[torch.Tensor],
                      assign: Optional[torch.Tensor], R: int,
                      prev: torch.Tensor, out: torch.Tensor,
                      mass: Optional[torch.Tensor]) -> None:
    """Check every operand once and launch ``repro_agg_blend``, which
    builds the normalized weights on the device: ``out = where(mass > 0,
    (wm / mass) @ X, prev)`` with ``wm[r, a] = [assign[a] == r] *
    weights[a] * mask[a]`` (``assign`` None: every row of X on row 0;
    ``mask`` None: ones), ``mass`` its row sums.  X is (A, N) and ``prev``
    (R, N), or (N,) when R is 1; or, for S scenarios at once, X (S, A, N)
    and ``prev`` (S, R, N) or (S, N), with weights, mask and assign each
    (S, A) or one shared (A,).  ``out`` was allocated like prev, ``mass``
    like prev's rows."""
    dev = x.get_device()
    if dev < 0:
        raise ValueError(f"{entry}: expected CUDA tensors, got {x.device}")
    if (x.dim() not in (2, 3) or x.dtype not in FLEET_DTYPES
            or not x.is_contiguous()):
        raise ValueError(f"{entry}: X must be a contiguous (A, N) or (S, A, "
                         f"N) {FLEET_DTYPES} tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    lead = tuple(x.shape[:-2])
    S = lead[0] if lead else 1
    A, N = x.shape[-2:]
    if A < 1 or N < 1 or R < 1:
        raise ValueError(f"{entry}: empty operand X {tuple(x.shape)}, "
                         f"{R} rows")
    _scenarios(entry, S)
    flags = int(x.dtype == torch.bfloat16) | (
        int(prev.dtype == torch.bfloat16) << 1)
    flags |= _per_agent(weights, "weights", S, A, _W_DTYPES, dev)
    if mask is not None:
        flags |= _per_agent(mask, "mask", S, A, _MASK_DTYPES, dev)
        flags |= _MASK_KINDS[mask.dtype] << 2
    if assign is not None:
        flags |= _per_agent(assign, "rsu_assign", S, A, _ASSIGN_DTYPES, dev)
        flags |= _ASSIGN_KINDS[assign.dtype] << 4
    one_row = prev.dim() == len(lead) + 1
    _require(prev, "prev", lead + ((N,) if one_row else (R, N)),
             FLEET_DTYPES, dev)
    if one_row and R != 1:
        raise ValueError(f"{entry}: a prev without rows needs one row, got "
                         f"{R}")
    if prev.dtype not in (x.dtype, torch.float32):
        raise ValueError(f"{entry}: prev dtype {prev.dtype} must be X's "
                         f"({x.dtype}) or float32")
    _check_ring_smem(entry, R, A, build=True)
    rc = _lib.library().repro_agg_blend(
        x.data_ptr(), weights.data_ptr(),
        None if mask is None else mask.data_ptr(),
        None if assign is None else assign.data_ptr(), A, R, N,
        prev.data_ptr(), out.data_ptr(),
        None if mass is None else mass.data_ptr(), flags, S,
        torch._C._cuda_getCurrentRawStream(dev))
    _lib.check(rc, "agg_blend")
    launches[entry] += 1


def _matmul(entry: str, w: torch.Tensor, x: torch.Tensor,
            out_f32: bool) -> torch.Tensor:
    """(R, A) @ (A, N) with fp32 accumulation, out in X's dtype or (with
    ``out_f32``) fp32; or S scenarios at once, (S, R, A) @ (S, A, N) (W may
    be one (R, A) every scenario shares) into (S, R, N), one launch.  The
    shortest launch path: each check once, inline, and the kernel's
    9-argument entry."""
    dev = x.get_device()
    if dev < 0:
        raise ValueError(f"{entry}: expected CUDA tensors, got {x.device}")
    if w.dtype != torch.float32 or not w.is_contiguous():
        w = w.float().contiguous()
    lead = tuple(x.shape[:-2])
    if (x.dim() not in (2, 3) or w.dim() not in (2, x.dim())
            or w.shape[-1] != x.shape[-2] or w.shape[:-2] not in ((), lead)):
        raise ValueError(f"{entry}: W {tuple(w.shape)} and X "
                         f"{tuple(x.shape)} must be (R, A) and (A, N), or "
                         f"(S, R, A) or (R, A) and (S, A, N)")
    (R, A), N = w.shape[-2:], x.shape[-1]
    S = lead[0] if lead else 1
    if R < 1 or A < 1 or N < 1:
        raise ValueError(f"{entry}: empty operand W {tuple(w.shape)}, X "
                         f"{tuple(x.shape)}")
    _scenarios(entry, S)
    if w.get_device() != dev:
        raise ValueError(f"{entry}: W on {w.device}, X on {x.device}")
    if x.dtype not in FLEET_DTYPES:
        raise ValueError(f"{entry}: X dtype {x.dtype} not in {FLEET_DTYPES}")
    if not x.is_contiguous():
        raise ValueError(f"{entry}: X must be contiguous")
    x_bf16 = x.dtype == torch.bfloat16
    out = x.new_empty(lead + (R, N),
                      dtype=torch.float32 if out_f32 else x.dtype)
    rc = _lib.library().repro_weighted_agg_matmul(
        w.data_ptr(), x.data_ptr(), out.data_ptr(), R, A, N,
        x_bf16 | ((x_bf16 and not out_f32) << 1) | (w.dim() == 2) << 2, S,
        torch._C._cuda_getCurrentRawStream(dev))
    _lib.check(rc, entry)
    launches[entry] += 1
    return out


def weighted_agg_matmul(weight_matrix: torch.Tensor,
                        stacked: torch.Tensor) -> torch.Tensor:
    """(R, A) @ (A, N) with fp32 accumulation, out in the stacked dtype."""
    return _matmul("weighted_agg_matmul", weight_matrix, stacked, False)


def scatter_accumulate(stacked_flat: torch.Tensor, weights: torch.Tensor,
                       rsu_assign: torch.Tensor, n_rsus: int, *,
                       entry: str = "scatter_accumulate",
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unnormalized per-RSU sums, ``num[r] = sum_{a in r} w_a x_a`` (R, N)
    in fp32 whatever X's dtype and ``mass[r] = sum_{a in r} w_a`` (R,):
    the matmul kernel on the (R, A) one-hot weight matrix (with a leading
    scenario axis: (S, R, N) and (S, R)).  ``weights`` carry mask x data
    volume x staleness decay.  ``entry`` names the launch count (the
    streamed rounds' ``ops.chunk_agg`` counts as ``chunk_agg``, the
    sharded rounds' ``ops.block_local_agg`` as ``block_local_agg``)."""
    W = unnormalized_weight_matrix(weights, torch.ones_like(weights),
                                   rsu_assign, n_rsus)
    return _matmul(entry, W, stacked_flat, True), W.sum(dim=-1)


def masked_hier_agg(stacked_flat, weights, mask, rsu_assign, n_rsus: int):
    """RSU aggregation without the blend: (rsu (R, N), mass (R,)), or
    (S, R, N) and (S, R) for S scenarios."""
    W = build_weight_matrix(weights, mask, rsu_assign, n_rsus)
    mass = cohort_mass(weights, mask, rsu_assign, n_rsus)
    return weighted_agg_matmul(W, stacked_flat), mass


def cloud_agg(rsu_flat, rsu_weights) -> torch.Tensor:
    """Cloud aggregation without the keep guard: (R, N) -> (N,), or (S, R,
    N) with (S, R) masses -> (S, N)."""
    wn, _ = normalized_weights(rsu_weights)
    return weighted_agg_matmul(wn.unsqueeze(-2), rsu_flat).squeeze(-2)


def agg_blend(stacked_flat, weights, mask, rsu_assign, n_rsus: int, prev):
    """Fused RSU aggregation + mass guard:
    ``out[r] = mass[r] > 0 ? W_norm[r] @ X : prev[r]``, one launch that
    builds W_norm and mass on the device.  ``weights`` (A,) float32,
    ``mask`` (A,) bool or float32, ``rsu_assign`` (A,) int64 or int32.
    Returns (rsu' (R, N) in prev's dtype, mass (R,)).  For S scenarios at
    once: X (S, A, N), prev (S, R, N), weights / mask / rsu_assign (S, A)
    or one shared (A,); returns (S, R, N) and (S, R).  Past what the
    ring's shared memory holds (``ring_fits``: 4,001 agents at R = 10) the
    same function takes the agent-tiled route of the streamed rounds: the
    matmul kernel's unnormalized sums into fp32 (one launch, counted as
    ``agg_blend_tiled``), then ``normalize_blend``."""
    if weights.dtype != torch.float32:
        weights = weights.float()
    if mask.dtype not in _MASK_KINDS:
        mask = mask.float()
    if not ring_fits(n_rsus, stacked_flat.shape[-2], build=True):
        num, mass = scatter_accumulate(stacked_flat, weights * mask.float(),
                                       rsu_assign, n_rsus,
                                       entry="agg_blend_tiled")
        return normalize_blend(num, mass, prev), mass
    out = torch.empty_like(prev)
    mass = prev.new_empty(prev.shape[:-1], dtype=torch.float32)
    _agg_blend_launch("agg_blend", stacked_flat, weights, mask, rsu_assign,
                      n_rsus, prev, out, mass)
    return out, mass


def agg_absorb(arrivals, rsu_assign, n_rsus: int, buf, buf_mass, *,
               keep=0.0):
    """Fused multi-cohort scatter-accumulate + staleness-buffer merge for
    ``arrivals`` = sequence of (x (A, N), w (A,)):
    ``out[r] = (keep*M[r]*buf[r] + sum w_a x_a) / (keep*M[r] + m_new[r])``
    (buf[r] on zero mass); ``keep`` a scalar or (R,).  Returns (buf',
    total mass, new mass).  With a leading scenario axis: x (S, A, N), w
    (S, A), buf (S, R, N), buf_mass (S, R), rsu_assign (A,) or (S, A).  The
    weights of every cohort share the ring's shared memory: at R = 10 the
    async tick's two cohorts take up to 2,334 agents each, one cohort
    4,668.  Past that (``ring_fits``) each cohort's unnormalized sums come
    from the matmul kernel's agent tiles into fp32 running sums (one launch
    a cohort, counted as ``agg_absorb_tiled``), merged by
    ``buffer_absorb``."""
    if not ring_fits(n_rsus, sum(x.shape[-2] for x, _ in arrivals),
                     build=False):
        num = torch.zeros(buf.shape, dtype=torch.float32, device=buf.device)
        new_mass = torch.zeros(buf.shape[:-1], dtype=torch.float32,
                               device=buf.device)
        for x, w in arrivals:
            n, m = scatter_accumulate(x, w, rsu_assign, n_rsus,
                                      entry="agg_absorb_tiled")
            num.add_(n)
            new_mass.add_(m)
        out, total = buffer_absorb(buf, buf_mass, num, new_mass, keep=keep)
        return out, total, new_mass
    mats, xs = [], []
    new_mass = torch.zeros(buf.shape[:-1], dtype=torch.float32,
                           device=buf.device)
    for x, w in arrivals:
        wm = unnormalized_weight_matrix(w, torch.ones_like(w), rsu_assign,
                                        n_rsus)
        mats.append(wm.expand(buf.shape[:-1] + wm.shape[-1:]))
        xs.append(x)
        new_mass = new_mass + wm.sum(dim=-1)
    retained = (torch.as_tensor(keep, dtype=torch.float32,
                                device=buf.device) * buf_mass.float())
    retained = retained.expand(new_mass.shape)
    total = retained + new_mass
    coef = torch.stack([retained,
                        torch.where(total > 0, total,
                                    torch.ones_like(total)),
                        (total > 0).float()], dim=-1)
    out = _fused_agg_blend(coef, mats, xs, buf, entry="agg_absorb")
    return out, total, new_mass


def cloud_blend(rsu_flat, rsu_weights, prev) -> torch.Tensor:
    """Fused cloud aggregation + keep guard:
    ``sum(mass) > 0 ? wn @ rsu_flat : prev``, one launch that normalizes
    the RSU masses on the device; out dtype follows ``prev`` (the fp32
    cloud master).  For S scenarios: (S, R, N), (S, R) and prev (S, N)."""
    if rsu_weights.dtype != torch.float32:
        rsu_weights = rsu_weights.float()
    out = torch.empty_like(prev)
    _agg_blend_launch("cloud_blend", rsu_flat, rsu_weights, None, None, 1,
                      prev, out, None)
    return out
