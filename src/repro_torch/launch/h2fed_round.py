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
the round's arguments and ``in_shardings`` for the dry run on the meta
device.

A mesh with a ``model`` axis above 1 splits each agent's model over the
ranks of its model group (``launch/sharding.ModelAxis``): the round takes
and returns this rank's blocks of the cloud params in the reference's
``param_shardings_model_only`` layout, re-lays them into the compute
layout at entry and back at exit (all-gathers over ``model`` at
``where="round"``), runs the local epochs tensor-parallel (the model's
functions with the local config and ``tp``, collectives at
``where="tp"``) and reduces each compute shard over ``data`` and ``pod``.
The decoder GQA family runs there; ``flat_agg`` raises, as in the
reference.
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
from repro_torch.launch import sharding as shard
from repro_torch.launch.mesh import FleetMesh, ShapeMesh, model_axis_size
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


def _quantized_pod_mean(mesh, leaves, anchor, weight, old, mass_ok,
                        split=None):
    """int8-quantized cross-pod weighted mean of (leaf - anchor) + anchor:
    each leaf's delta is scaled to int8 by its absmax over the whole leaf
    (a max over ``model`` where ``split[i]`` says the leaf is split there)
    and the pods (max reductions), then the dequantized, normalized deltas
    are summed."""
    w_norm = weight / _safe(mass_ok)
    split = split or [False] * len(leaves)
    out = []
    for leaf, a, o, sp in zip(leaves, anchor, old, split):
        delta = leaf.float() - a.float()
        absmax = delta.abs().max()
        if sp:
            absmax = collectives.all_reduce(absmax, mesh, "model",
                                            where="cloud", op="max")
        absmax = collectives.all_reduce(absmax, mesh, "pod", where="cloud",
                                        op="max")
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
    checks).  ``mesh`` is a ``FleetMesh`` over (pod, data, model), one
    agent a (pod, data) position; None is the one-rank mesh.  Runs on
    ``device`` (``cuda`` when None; raises without a GPU).

    ``round_fn(cloud_params, batch, mask, n_data[, delays])`` returns (new
    cloud params, {"surviving_mass": fp32 scalar, "lar_masses": (LAR,)}),
    the same on every rank; the params in and out are this rank's blocks
    in the ``param_shardings_model_only`` layout (whole at a model axis of
    1).  ``flat_agg`` reduces the raveled buffer, one collective a layer
    (model axis 1 only); ``fleet_dtype="bfloat16"`` (flat only) reduces
    it in bf16; ``async_rounds=D`` runs the semi-async tick with a
    one-slot in-flight buffer (flat only; needs ``delays``)."""
    dev = resolve_device(device)
    mesh = _one_rank_mesh() if mesh is None else mesh
    if flat_agg and quantize_cloud:
        raise ValueError(
            "flat_agg composes with the exact cloud reduction only")
    if flat_agg and model_axis_size(mesh) > 1:
        raise ValueError(
            "flat_agg requires model-axis size 1: raveling tensor-parallel-"
            "sharded params would all-gather over `model` before the psum "
            "(use the per-leaf path on TP meshes)")
    axis = shard.ModelAxis(cfg, mesh) if model_axis_size(mesh) > 1 else None
    tp = None if axis is None else mesh
    run_cfg = cfg if axis is None else axis.local_cfg
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
            loss, _ = M.loss_fn(run_cfg, params, local_batch, tp=tp)
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
        if axis is not None:
            cloud = axis.to_compute(cloud, where="round")
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
                new_cloud = _quantized_pod_mean(
                    mesh, w_k, cloud, mass_total, cloud, pod_mass,
                    None if axis is None else axis.split)
            else:
                new_cloud, _ = wmean(pod, w_k, mass_total, cloud, "cloud")
        if axis is not None:
            new_cloud = axis.to_storage(new_cloud, where="round")
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


def round_collectives(cfg: ArchConfig, hp: H2FedParams, mesh, b: int,
                      seq: int, *, quantize_cloud: bool = False
                      ) -> Dict[str, Dict[str, int]]:
    """The collectives that one synchronous per-leaf round makes on each
    rank, reckoned from shapes: ``"where/axes"`` -> {"calls", "bytes"}, as
    ``collectives.counts()`` reports them after the round (an axis of one
    rank makes none).  ``b`` sequences of ``seq`` tokens an agent a local
    round.

      lar/data     a mass and an fp32 sum a leaf, each local round;
      cloud/pod    the pod mass, then a mass and an fp32 sum a leaf (with
                   ``quantize_cloud`` a max and a sum a leaf);
      cloud/model  with ``quantize_cloud``, a max a leaf split over model;
      round/model  the re-lays' all-gathers (``ModelAxis``);
      tp/model     each local epoch: the embedding's sum (b S d in the
                   params' dtype), the vocab-split cross-entropy's three
                   (b S fp32 each), the head's input gradient, and five a
                   layer (b S d fp32 each): the sums after ``wo`` and
                   ``w_down``, ``wo``'s again when the backward recomputes
                   the layer (torch's checkpoint stops its recompute after
                   the last tensor the backward saved, before
                   ``w_down``'s sum), and the input gradients of the
                   column-split products of the attention and the MLP.

    Leaf sizes are the compute shards' (the whole leaf at a model axis of
    1).  The ``tp`` count assumes the ``decoder`` GQA layer's call sites
    (``tp_copy`` before ``_gqa_qkv`` and the MLP, ``tp_reduce`` after
    ``wo`` and ``w_down``) and ``transformer.stack_prefill``'s
    ``checkpoint(..., early_stop=True)``; ``collectives.counts()`` after a
    round is what holds it to the calls made."""
    m = model_axis_size(mesh)
    axis = shard.ModelAxis(cfg, mesh) if m > 1 else None
    if axis is None:
        numels = [l.numel() for l in tree.leaves(M.meta_params(cfg))]
    else:
        numels = axis.shard_numels()
    n_leaf, n = len(numels), sum(numels)
    out: Dict[str, Dict[str, int]] = {}

    def add(key, calls, nbytes):
        if calls:
            out[key] = {"calls": calls, "bytes": nbytes}
    if mesh.shape.get("data", 1) > 1:
        add("lar/data", hp.lar * (1 + n_leaf), hp.lar * 4 * (1 + n))
    if mesh.shape.get("pod", 1) > 1:
        if quantize_cloud:
            add("cloud/pod", 1 + 2 * n_leaf, 4 * (1 + n_leaf + n))
        else:
            add("cloud/pod", 2 + n_leaf, 4 * (2 + n))
    if axis is None:
        return dict(sorted(out.items()))
    if quantize_cloud and mesh.shape.get("pod", 1) > 1:
        k = sum(axis.split)
        add("cloud/model", k, 4 * k)
    relay = axis.relay_collectives()
    add("round/model", relay["calls"], relay["bytes"])
    tokens = b * seq
    act = tokens * cfg.d_model * 4
    w_bytes = torch.finfo(cfg.weight_dtype).bits // 8
    per_epoch_calls = 5 * cfg.n_layers + 5
    per_epoch_bytes = (tokens * cfg.d_model * w_bytes + 3 * tokens * 4
                       + act + 5 * cfg.n_layers * act)
    epochs = hp.lar * hp.local_epochs
    add("tp/model", epochs * per_epoch_calls, epochs * per_epoch_bytes)
    return dict(sorted(out.items()))


# --------------------------------------------------------------------------
# dry-run input specs
# --------------------------------------------------------------------------

def round_input_specs(cfg: ArchConfig, shape_name: str, mesh=None,
                      hp: Optional[H2FedParams] = None,
                      quantize_cloud: bool = False, flat_agg: bool = False,
                      *, device=None) -> Dict[str, Any]:
    """The round's cell of the dry run (the reference's
    ``round_input_specs``): dict(fn, args, in_shardings, cfg, desc, kind,
    batch, seq), the args (params, batch (LAR, A, b, S), mask (LAR, A),
    n_data (A,)) on the meta device with the reference's shapes and
    dtypes, and the reference's ``in_shardings`` on ``mesh``: the params
    in ``param_shardings_model_only``'s layout, the batch and the mask
    over the agent axes after LAR, n_data over the agent axes.  Training
    shapes only.  ``mesh`` is a ``FleetMesh`` (None: the one-rank mesh),
    and ``fn`` is ``make_h2fed_round`` on it for ``device``; or a
    ``ShapeMesh`` (``make_production_mesh``), which runs nothing, and
    ``fn`` is None."""
    from repro_torch.launch.steps import SHAPES, shape_adapted_config

    info = SHAPES[shape_name]
    assert info["kind"] == "train", "h2fed_round lowers training shapes only"
    cfg = shape_adapted_config(cfg, shape_name)
    hp = hp or H2FedParams(local_epochs=1, lar=4)
    mesh = _one_rank_mesh() if mesh is None else mesh
    fn = None if isinstance(mesh, ShapeMesh) else make_h2fed_round(
        cfg, hp, mesh, quantize_cloud=quantize_cloud, flat_agg=flat_agg,
        device=device)

    topo = HierarchyTopology.from_mesh(mesh)
    A = topo.n_agents
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
    params = M.meta_params(cfg)
    stacked = shard.NamedSharding(mesh, topo.stacked_spec())
    return dict(
        fn=fn,
        args=(params, batch_tree,
              meta((hp.lar, A), torch.float32), meta((A,), torch.float32)),
        in_shardings=(shard.param_shardings_model_only(params, mesh),
                      {k: stacked for k in batch_tree}, stacked,
                      shard.NamedSharding(mesh, topo.agent_spec)),
        cfg=cfg, kind="h2fed_round", batch=info["batch"], seq=seq,
        desc=f"h2fed_round LAR={hp.lar} E={hp.local_epochs} A={A} b={b} "
             f"S={seq}" + (" q8" if quantize_cloud else ""))
