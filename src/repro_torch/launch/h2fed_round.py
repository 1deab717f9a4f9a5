"""The paper-faithful H2-Fed hierarchical round for an LLM
(``repro/launch/h2fed_round.py``), one rank an agent.

The reference runs the round as one SPMD program: ``shard_map`` manual over
``(pod, data)``, so every mesh position is an agent running Algorithm 1,
``psum`` over ``data`` is the RSU aggregation (Algorithm 2) and ``psum``
over ``pod`` the cloud aggregation (Algorithm 3).  Here every rank of a
``launch.mesh.FleetMesh`` is one process and one agent, and the same
collectives are ``launch.collectives.all_reduce`` calls over the mesh's
``data`` and ``pod`` groups (``pmax`` is ``op="max"``); a mesh of one rank
needs no process group and every collective is the identity.

Per global round:

    w_k := w                                   # Alg. 2 l.2
    for r in range(LAR):                       # Alg. 2 l.1
        w_ik := w_k                            # Alg. 1 l.1
        for e in range(E):                     # Alg. 1 l.3
            w_ik := Eq. 6 (kernel #3, a launch a leaf)
        w_k := sum_data m n w_ik / sum_data m n
    w := sum_pod mass_k w_k / sum_pod mass_k

The gradient of each local epoch goes through the model's forward and
backward, attention through kernel #4 and its backward kernel on the card.
Every rank is handed the same global host arrays (batch ``(LAR, A, b, S)``,
mask ``(LAR, A)``, n_data ``(A,)``, delays ``(LAR, A)``) and takes its own
agent's column (``HierarchyTopology.agent_rows``), as the reference's
``shard_map`` hands each shard its block.  ``round_input_specs`` builds
the round's arguments for the dry run on the meta device.  The
tensor-parallel model axis waits for ``launch/sharding`` (ROADMAP queue
1, item 11b).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import flatten
from repro_torch.core.aggregation import staleness_weights
from repro_torch.core.h2fed import H2FedParams
from repro_torch.core.topology import HierarchyTopology
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch import collectives
from repro_torch.launch.mesh import FleetMesh, model_axis_size
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig


def _one_rank_mesh() -> FleetMesh:
    """The reference's (1, 1, 1) mesh: one agent, no process group."""
    return FleetMesh((1, 1, 1), ("pod", "data", "model"))


def _ravel(leaves: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([l.float().reshape(-1) for l in leaves])


def _unravel(vec: torch.Tensor, like: List[torch.Tensor]) -> list:
    out, off = [], 0
    for l in like:
        n = l.numel()
        out.append(vec[off:off + n].reshape(l.shape).to(l.dtype))
        off += n
    return out


def _safe(mass: torch.Tensor) -> torch.Tensor:
    return torch.where(mass > 0, mass, torch.ones_like(mass))


def _wmean_over(mesh, axis, leaves, weight, old, where):
    """Masked weighted mean over a mesh axis, leaf by leaf; keeps ``old``
    where the surviving mass is zero.  weight: this rank's fp32 scalar."""
    mass = collectives.all_reduce(weight, mesh, axis, where=where)
    safe = _safe(mass)
    out = []
    for leaf, o in zip(leaves, old):
        s = collectives.all_reduce(leaf.float() * weight, mesh, axis,
                                   where=where)
        out.append(torch.where(mass > 0, s / safe, o.float()).to(leaf.dtype))
    return out, mass


def _wmean_over_flat(mesh, axis, leaves, weight, old, where, *,
                     storage=torch.float32):
    """``_wmean_over`` on the raveled (N,) buffer: one collective of one
    contiguous vector an aggregation layer.  The weighted contribution is
    cast to the fleet dtype ``storage`` before the reduction (bf16 halves
    its bytes) and normalized in fp32 after it."""
    vec = _ravel(leaves)
    mass = collectives.all_reduce(weight, mesh, axis, where=where)
    s = collectives.all_reduce((vec * weight).to(storage), mesh, axis,
                               where=where).float()
    out = torch.where(mass > 0, s / _safe(mass), _ravel(old))
    return _unravel(out, leaves), mass


def _quantized_pod_mean(mesh, leaves, anchor, weight, old, mass_ok):
    """int8-quantized cross-pod weighted mean of (leaf - anchor) + anchor:
    each leaf's delta is scaled to int8 by its absmax over the pods (a max
    reduction), then the dequantized, normalized deltas are summed."""
    w_norm = weight / _safe(mass_ok)
    out = []
    for leaf, a, o in zip(leaves, anchor, old):
        delta = leaf.float() - a.float()
        absmax = collectives.all_reduce(delta.abs().max(), mesh, "pod",
                                        where="cloud", op="max")
        scale = torch.where(absmax > 0, absmax / 127.0,
                            torch.ones_like(absmax))
        q = torch.clamp(torch.round(delta / scale), -127, 127).to(torch.int8)
        deq = q.float() * (scale * w_norm)
        s = collectives.all_reduce(deq, mesh, "pod", where="cloud")
        res = a.float() + s
        out.append(torch.where(mass_ok > 0, res, o.float()).to(leaf.dtype))
    return out


def make_h2fed_round(cfg: ArchConfig, hp: H2FedParams, mesh=None, *,
                     quantize_cloud: bool = False, flat_agg: bool = False,
                     async_rounds: int = 0, staleness_decay=0.5,
                     buffer_keep: float = 0.0, fleet_dtype: str = "float32",
                     device=None):
    """Build this rank's round function (the reference's options and
    checks).  ``mesh`` is a ``FleetMesh`` over (pod, data, model) with one
    agent a rank; None is the one-rank mesh.  Runs on ``device`` (``cuda``
    when None; raises without a GPU).

    ``round_fn(cloud_params, batch, mask, n_data[, delays])`` returns (new
    cloud params, {"surviving_mass": fp32 scalar, "lar_masses": (LAR,)}),
    the same on every rank.  ``flat_agg`` reduces the raveled buffer, one
    collective a layer; ``fleet_dtype="bfloat16"`` (flat only) reduces it
    in bf16; ``async_rounds=D`` runs the semi-async tick with a one-slot
    in-flight buffer (flat only; needs ``delays``)."""
    dev = resolve_device(device)
    mesh = _one_rank_mesh() if mesh is None else mesh
    if model_axis_size(mesh) > 1:
        raise NotImplementedError(
            "a model axis larger than 1 (tensor parallelism) waits for the "
            "port of launch/sharding (ROADMAP queue 1, item 11b)")
    topo = HierarchyTopology.from_mesh(mesh)
    pod = topo.pod_axis
    if isinstance(staleness_decay, (tuple, list)):
        if len(staleness_decay) != topo.n_pods:
            raise ValueError(
                f"per-RSU staleness_decay needs one entry per pod "
                f"({topo.n_pods}), got {len(staleness_decay)}")
        my_decay = float(staleness_decay[mesh.coordinate("pod")
                                         if "pod" in mesh.shape else 0])
    else:
        my_decay = float(staleness_decay)
    if flat_agg and quantize_cloud:
        raise ValueError(
            "flat_agg composes with the exact cloud reduction only")
    if async_rounds and not flat_agg:
        raise ValueError(
            "async_rounds requires flat_agg: the staleness-bounded in-flight "
            "buffer lives on the raveled (N,) vector")
    storage = flatten.resolve_storage_dtype(fleet_dtype)
    if storage != torch.float32 and not flat_agg:
        raise ValueError(
            "fleet_dtype != float32 requires flat_agg: the storage-dtype "
            "reduction runs on the raveled buffer")
    me = topo.agent_rows().start     # one agent a rank

    def wmean(axis, leaves, weight, old, where):
        if flat_agg:
            return _wmean_over_flat(mesh, axis, leaves, weight, old, where,
                                    storage=storage)
        return _wmean_over(mesh, axis, leaves, weight, old, where)

    def grads(leaves, like, local_batch):
        params = tree.unflatten(like, [l.detach().requires_grad_()
                                       for l in leaves])
        with torch.enable_grad():
            loss, _ = M.loss_fn(cfg, params, local_batch)
            return torch.autograd.grad(loss, tree.leaves(params))

    def local_epochs(w_k, w_cloud, like, local_batch):
        """Alg. 1: E proximal-SGD epochs from w_k on this agent's batch;
        leaves in, leaves out."""
        w = w_k
        for _ in range(hp.local_epochs):
            g = grads(w, like, local_batch)
            w = tree.leaves(ops.dual_proximal_sgd_tree(
                w, list(g), w_k, w_cloud, lr=hp.lr, mu1=hp.mu1, mu2=hp.mu2))
        return w

    def inputs(batch, mask, n_data, delays=None):
        """This rank's agent column of the global host arrays."""
        local = {k: torch.as_tensor(np.asarray(v)[:, me]).to(dev)
                 for k, v in batch.items()}
        my_mask = np.asarray(mask, np.float32)[:, me]
        my_n = np.float32(np.asarray(n_data, np.float32)[me])
        my_delay = (None if delays is None else np.clip(
            np.asarray(delays)[:, me], 0, async_rounds))
        return local, my_mask, my_n, my_delay

    def scalar(x) -> torch.Tensor:
        return torch.as_tensor(np.float32(x), device=dev)

    def round_fn(cloud_params, batch, mask, n_data):
        cloud = tree.leaves(cloud_params)
        local, my_mask, my_n, _ = inputs(batch, mask, n_data)
        w_k = cloud
        mass_total = scalar(0.0)
        masses = []
        for r in range(len(my_mask)):
            w_ik = local_epochs(w_k, cloud, cloud_params,
                                {k: v[r] for k, v in local.items()})
            weight = scalar(my_n * my_mask[r])
            w_k, mass = wmean("data", w_ik, weight, w_k, "lar")
            mass_total = mass_total + mass
            masses.append(mass)
        if pod is None:
            new_cloud, pod_mass = w_k, mass_total
        else:
            pod_mass = collectives.all_reduce(mass_total, mesh, pod,
                                              where="cloud")
            if quantize_cloud:
                new_cloud = _quantized_pod_mean(mesh, w_k, cloud, mass_total,
                                                cloud, pod_mass)
            else:
                new_cloud, _ = wmean(pod, w_k, mass_total, cloud, "cloud")
        return (tree.unflatten(cloud_params, new_cloud),
                {"surviving_mass": pod_mass,
                 "lar_masses": torch.stack(masses)})

    def async_round_fn(cloud_params, batch, mask, n_data, delays):
        """The semi-async tick on one agent: a one-slot staleness-bounded
        in-flight buffer of its raveled update; while it is in flight the
        agent is busy and contributes nothing new.  Each tick the RSU sum
        absorbs the zero-latency cohort plus due stragglers (decayed at
        enqueue) with running cohort-mass accounting."""
        cloud = tree.leaves(cloud_params)
        local, my_mask, my_n, my_delay = inputs(batch, mask, n_data, delays)
        cloud_vec = _ravel(cloud)
        w_k_vec = cloud_vec
        rsu_mass = mass_total = scalar(0.0)
        pend_x = torch.zeros_like(cloud_vec)
        pend_w, pend_t = scalar(0.0), 0
        masses = []
        for r in range(len(my_mask)):
            m, d = my_mask[r], int(my_delay[r])
            in_flight = pend_t > 0
            pend_t = max(pend_t - 1, 0)
            due = in_flight and pend_t == 0
            free = not (in_flight and not due)
            w_ik = local_epochs(_unravel(w_k_vec, cloud), cloud,
                                cloud_params,
                                {k: v[r] for k, v in local.items()})
            x_new = _ravel(w_ik)
            w_imm = scalar(my_n * m * np.float32(free) * np.float32(d == 0))
            w_due = pend_w if due else scalar(0.0)
            num = collectives.all_reduce(
                (w_imm * x_new + w_due * pend_x).to(storage), mesh, "data",
                where="lar").float()
            m_new = collectives.all_reduce(w_imm + w_due, mesh, "data",
                                           where="lar")
            retained = buffer_keep * rsu_mass
            total = retained + m_new
            w_k_vec = torch.where(total > 0,
                                  (retained * w_k_vec + num) / _safe(total),
                                  w_k_vec)
            # the leaf-dtype round trip of the sync flat path's unravel
            w_k_vec = _ravel(_unravel(w_k_vec, cloud))
            if m > 0 and free and d > 0:
                pend_x = x_new
                pend_w = scalar(my_n * m) * staleness_weights(
                    torch.tensor(d, device=dev), decay=my_decay)
                pend_t = d
            rsu_mass = total
            mass_total = mass_total + m_new
            masses.append(m_new)
        if pod is None:
            new_vec, pod_mass = w_k_vec, mass_total
        else:
            pod_mass = collectives.all_reduce(mass_total, mesh, pod,
                                              where="cloud")
            s = collectives.all_reduce(w_k_vec * mass_total, mesh, pod,
                                       where="cloud")
            new_vec = torch.where(pod_mass > 0, s / _safe(pod_mass),
                                  cloud_vec)
        return (tree.unflatten(cloud_params, _unravel(new_vec, cloud)),
                {"surviving_mass": pod_mass,
                 "lar_masses": torch.stack(masses)})

    return async_round_fn if async_rounds else round_fn


def comm_model(cfg: ArchConfig, hp: H2FedParams, mesh, *,
               quantize_cloud: bool = False, ici_bw: float = 50e9,
               dci_bw: float = 6.25e9) -> Dict[str, float]:
    """The reference's analytical communication model of one round:

      within-pod bytes a rank = LAR 2(A-1)/A P      (ring all-reduce, Alg. 2)
      cross-pod bytes a rank  = 2(K-1)/K P q        (cloud, Alg. 3)

    P the parameter bytes a rank (fp32 aggregation), A agents a pod, K
    pods, q = 0.25 with int8 quantization.  The link rates are the
    reference's defaults (a TPU pod's ICI and DCI); the byte counts do not
    depend on them."""
    n_par = M.count_params_analytic(cfg)
    p_dev = n_par * 4 / model_axis_size(mesh)
    A = mesh.shape.get("data", 1)
    K = mesh.shape.get("pod", 1)
    ici = hp.lar * 2 * (A - 1) / A * p_dev
    q = 0.25 if quantize_cloud else 1.0
    dci = (2 * (K - 1) / K * p_dev * q) if K > 1 else 0.0
    return {"ici_bytes_per_dev": ici, "dci_bytes_per_dev": dci,
            "ici_s": ici / ici_bw, "dci_s": dci / dci_bw,
            "per_local_round_s": (ici / ici_bw + dci / dci_bw) / hp.lar}


# --------------------------------------------------------------------------
# dry-run input specs
# --------------------------------------------------------------------------

def round_input_specs(cfg: ArchConfig, shape_name: str, mesh=None,
                      hp: Optional[H2FedParams] = None,
                      quantize_cloud: bool = False, flat_agg: bool = False,
                      *, device=None) -> Dict[str, Any]:
    """The round's cell of the dry run (the reference's
    ``round_input_specs``): dict(fn, args, cfg, desc, kind, batch, seq),
    the args (params, batch (LAR, A, b, S), mask (LAR, A), n_data (A,))
    on the meta device with the reference's shapes and dtypes.  Training
    shapes only.  ``fn`` is ``make_h2fed_round`` on ``mesh`` (None: the
    one-rank mesh) for ``device``; it raises at a model axis above 1.  No
    ``in_shardings`` until ``launch/sharding`` is ported (item 11b)."""
    from repro_torch.launch.steps import SHAPES, shape_adapted_config

    info = SHAPES[shape_name]
    assert info["kind"] == "train", "h2fed_round lowers training shapes only"
    cfg = shape_adapted_config(cfg, shape_name)
    hp = hp or H2FedParams(local_epochs=1, lar=4)
    mesh = _one_rank_mesh() if mesh is None else mesh
    fn = make_h2fed_round(cfg, hp, mesh, quantize_cloud=quantize_cloud,
                          flat_agg=flat_agg, device=device)

    A = HierarchyTopology.from_mesh(mesh).n_agents
    b = max(info["batch"] // A, 1)
    seq = info["seq"]

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    batch_tree = {"tokens": meta((hp.lar, A, b, seq), torch.int32),
                  "labels": meta((hp.lar, A, b, seq), torch.int32)}
    extra = (hp.lar, A, b, cfg.encoder.n_positions, cfg.encoder.d_embed)
    if cfg.encoder.kind == "vision":
        batch_tree["patch_embeds"] = meta(extra, torch.float32)
    if cfg.encoder.kind == "audio":
        batch_tree["memory"] = meta(extra, torch.float32)
    return dict(
        fn=fn,
        args=(M.meta_params(cfg), batch_tree,
              meta((hp.lar, A), torch.float32), meta((A,), torch.float32)),
        cfg=cfg, kind="h2fed_round", batch=info["batch"], seq=seq,
        desc=f"h2fed_round LAR={hp.lar} E={hp.local_epochs} A={A} b={b} "
             f"S={seq}" + (" q8" if quantize_cloud else ""))
