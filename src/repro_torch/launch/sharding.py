"""Sharding rules (``repro/launch/sharding.py``): param / batch / cache
partition specs for a mesh, the port's ``NamedSharding``, and the model
axis of the hierarchical round.

The rules are the reference's, verbatim, as pure functions on shapes and
a mesh: any object with ``.shape`` (axis -> size) and ``.axis_names``, a
``launch.mesh.FleetMesh`` or a shape-only ``launch.mesh.ShapeMesh``.  A
spec is a tuple with one entry a dimension: None (whole), an axis name,
or a tuple of names (the dimension split over their product, the first
name major), as a JAX ``PartitionSpec``.  Params use a generic 2-D (FSDP
``data`` x TP ``model``) rule over the trailing matrix dims, with an
expert-parallel rule for MoE expert tensors (E over ``model``); params
are not sharded over ``pod``.

``NamedSharding(mesh, spec)`` is a spec on a mesh: ``shard_shape``, this
rank's ``block`` of a full tensor (the data that JAX's ``device_put``
puts on the device at the rank's mesh coordinate) and ``gather``, the
all-gather over the spec's axes through ``launch/collectives`` (counted).
``shard_tree`` / ``gather_tree`` / ``arg_bytes`` do the same over trees.

``ModelAxis`` is the hierarchical round's tensor parallelism.  The
reference keeps the round's params in ``param_shardings_model_only``'s
layout and lets GSPMD partition the model's products freely; PyTorch has
no such partitioner, so the round re-lays its blocks once at entry into
a compute layout of its own (Megatron's: q / k / v heads and the MLP's
columns split, ``wo`` and ``w_down`` by rows, the vocab rows of the
embedding and head; norm scales and ``b_down`` whole) and once back at
exit, and runs the model's own functions on the shards with a local
config and the model group (``tp``).
"""
from __future__ import annotations

from math import prod
from typing import List, Optional, Sequence

import torch

from repro_torch import tree
from repro_torch.launch import collectives

_EXPERT_NAMES = ("w_gate", "w_up", "w_down")

Spec = tuple


def _divisible_dims(shape, size, taken):
    return [i for i, d in enumerate(shape)
            if i not in taken and d % size == 0 and d >= size]


def _is_expert(path: str, ndim: int) -> bool:
    return (any(n in path for n in _EXPERT_NAMES) and "shared" not in path
            and ndim >= 3 and "router" not in path)


def param_spec(path: str, shape, mesh) -> Spec:
    """Generic FSDP('data') x TP('model') spec for one parameter leaf."""
    ndim = len(shape)
    data, model = mesh.shape.get("data", 1), mesh.shape.get("model", 1)
    spec = [None] * ndim

    # MoE routed-expert tensors: (..., E, a, b) -> E over `model` (expert
    # parallelism), larger of (a, b) over `data`.
    if _is_expert(path, ndim):
        e_dim = ndim - 3
        if shape[e_dim] % model == 0:
            spec[e_dim] = "model"
            a, b = ndim - 2, ndim - 1
            pick = a if shape[a] >= shape[b] else b
            other = b if pick == a else a
            if shape[pick] % data == 0:
                spec[pick] = "data"
            elif shape[other] % data == 0:
                spec[other] = "data"
            return tuple(spec)
        # fall through to generic rule if E not divisible (reduced configs)

    if ndim == 0:
        return ()
    # generic: consider only the trailing two dims (the matrix); leading
    # dims are layer stacks / expert axes handled above.
    cand = [ndim - 1] if ndim == 1 else [ndim - 2, ndim - 1]
    cand = sorted(cand, key=lambda i: -shape[i])
    taken: set = set()
    # largest divisible dim -> model
    for i in cand:
        if shape[i] % model == 0 and shape[i] >= model:
            spec[i] = "model"
            taken.add(i)
            break
    for i in cand:
        if i not in taken and shape[i] % data == 0 and shape[i] >= data:
            spec[i] = "data"
            taken.add(i)
            break
    return tuple(spec)


def _tree_shardings(params, mesh, rule):
    """A tree shaped like ``params`` holding ``NamedSharding(mesh,
    rule(path, shape, mesh))`` a leaf."""
    return tree.unflatten(params, [
        NamedSharding(mesh, rule(path, tuple(leaf.shape), mesh))
        for path, leaf in tree.leaves_with_paths(params)])


def param_shardings(params, mesh, strategy: str = "fsdp_tp"):
    """``NamedSharding`` tree matching a params (shape) tree."""
    if strategy == "dp":
        return tree.map_tree(lambda _: NamedSharding(mesh, ()), params)
    return _tree_shardings(params, mesh, param_spec)


def act_spec_dp(shape, mesh) -> Spec:
    """Pure-DP activation spec: leading agent dim over (pod, data), second
    (per-agent batch) dim over `model` — every chip holds distinct data."""
    ba = batch_axes(mesh)
    bsz = prod(mesh.shape[a] for a in ba)
    model = mesh.shape.get("model", 1)
    spec = [None] * len(shape)
    if shape and shape[0] % bsz == 0 and shape[0] >= bsz:
        spec[0] = ba if len(ba) > 1 else ba[0]
    if len(shape) > 1 and shape[1] % model == 0 and shape[1] >= model:
        spec[1] = "model"
    return tuple(spec)


def param_spec_model_only(path: str, shape, mesh) -> Spec:
    """TP('model')-only spec: the hierarchical round's layout, where (pod,
    data) are the agent axes and each agent holds its own replica."""
    ndim = len(shape)
    model = mesh.shape.get("model", 1)
    spec = [None] * ndim
    if ndim == 0:
        return ()
    if _is_expert(path, ndim) and shape[ndim - 3] % model == 0:
        spec[ndim - 3] = "model"                    # expert-parallel
        return tuple(spec)
    cand = [ndim - 1] if ndim == 1 else [ndim - 2, ndim - 1]
    for i in sorted(cand, key=lambda i: -shape[i]):
        if shape[i] % model == 0 and shape[i] >= model:
            spec[i] = "model"
            break
    return tuple(spec)


def param_shardings_model_only(params, mesh):
    return _tree_shardings(params, mesh, param_spec_model_only)


def batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def batch_spec(ndim: int, mesh) -> Spec:
    """Leading dim = agents/batch over (pod, data); rest replicated.  One
    axis is named alone (as ``PartitionSpec`` writes a one-name tuple)."""
    ba = batch_axes(mesh)
    return (ba if len(ba) > 1 else ba[0],) + (None,) * (ndim - 1)


def act_spec(shape, mesh) -> Spec:
    """Batch-sharded activation spec; replicates when dim0 isn't divisible
    (e.g. the batch=1 long-context decode)."""
    ba = batch_axes(mesh)
    bsz = prod(mesh.shape[a] for a in ba)
    if shape and shape[0] % bsz == 0 and shape[0] >= bsz:
        return (ba if len(ba) > 1 else ba[0],) + (None,) * (len(shape) - 1)
    return (None,) * len(shape)


def cache_spec(shape, mesh) -> Spec:
    """Decode-cache leaf: batch dim over (pod,data) when divisible; then the
    largest remaining dim over `model`; for batch=1 (long-context) also place
    `data` on the longest remaining dim."""
    ndim = len(shape)
    spec = [None] * ndim
    if ndim == 0:
        return ()
    ba = batch_axes(mesh)
    bsz = prod(mesh.shape[a] for a in ba)
    used_data = False
    if shape[0] % bsz == 0 and shape[0] >= bsz:
        spec[0] = ba if len(ba) > 1 else ba[0]
        used_data = True
    model = mesh.shape.get("model", 1)
    rest = sorted(range(1, ndim), key=lambda i: -shape[i])
    for i in rest:
        if shape[i] % model == 0 and shape[i] >= model:
            spec[i] = "model"
            rest = [j for j in rest if j != i]
            break
    if not used_data:
        data = mesh.shape.get("data", 1)
        for i in rest:
            if spec[i] is None and shape[i] % data == 0 and shape[i] >= data:
                spec[i] = "data"
                break
    return tuple(spec)


def cache_shardings(cache, mesh):
    return tree.map_tree(
        lambda l: NamedSharding(mesh, cache_spec(tuple(l.shape), mesh)),
        cache)


def replicated(mesh) -> "NamedSharding":
    return NamedSharding(mesh, ())


# --------------------------------------------------------------------------
# a spec on a mesh
# --------------------------------------------------------------------------

def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class NamedSharding:
    """``spec`` on ``mesh`` (the counterpart of JAX's ``NamedSharding``).
    Dimension i is split over the product of its entry's axes, in
    contiguous blocks; a mesh coordinate takes the block at its index
    along those axes, flattened row-major in the entry's order."""

    def __init__(self, mesh, spec: Sequence):
        self.mesh = mesh
        self.spec: Spec = tuple(spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec})"

    def _splits(self, shape):
        """(dim, axes, parts) of each split dimension of ``shape``."""
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than "
                             f"shape {tuple(shape)} has dims")
        out = []
        for i, entry in enumerate(self.spec):
            axes = _entry_axes(entry)
            if not axes:
                continue
            parts = prod(self.mesh.shape[a] for a in axes)
            if shape[i] % parts:
                raise ValueError(f"spec {self.spec} splits dim {i} of "
                                 f"{tuple(shape)} into {parts} parts")
            out.append((i, axes, parts))
        return out

    def shard_shape(self, shape) -> tuple:
        """The shape of each block of a full ``shape``."""
        out = list(shape)
        for i, _, parts in self._splits(shape):
            out[i] //= parts
        return tuple(out)

    def block(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the full tensor ``t`` (at ``mesh.coord``),
        as a view."""
        coord = self.mesh.coord
        for i, axes, parts in self._splits(t.shape):
            idx = 0
            for a in axes:
                idx = idx * self.mesh.shape[a] + coord[a]
            n = t.shape[i] // parts
            t = t.narrow(i, idx * n, n)
        return t

    def gather(self, block: torch.Tensor, *,
               where: str = "gather") -> torch.Tensor:
        """The full tensor from every rank's ``block``: an all-gather over
        each split dimension's axes (``collectives.all_gather_cat``,
        counted at ``where``).  Every rank of those axes must call it."""
        for i, entry in enumerate(self.spec):
            if _entry_axes(entry):
                block = collectives.all_gather_cat(
                    block, self.mesh, _entry_axes(entry), where=where, dim=i)
        return block

    def is_split(self) -> bool:
        return any(_entry_axes(e) for e in self.spec)


def shard_tree(full, shardings):
    """This rank's blocks of a full tree (copies where a leaf is split,
    so the full leaves can be freed)."""
    def one(t, s):
        b = s.block(t)
        return b.clone() if b.shape != t.shape else b
    return tree.unflatten(full, [one(t, s) for t, s in zip(
        tree.leaves(full), tree.leaves(shardings))])


def gather_tree(blocks, shardings, *, where: str = "gather"):
    """The full tree from every rank's blocks (``NamedSharding.gather`` a
    leaf, the inverse of ``shard_tree``); every rank must call it."""
    return tree.unflatten(blocks, [
        s.gather(b, where=where)
        for b, s in zip(tree.leaves(blocks), tree.leaves(shardings))])


def arg_bytes(args, shardings) -> int:
    """The bytes that one rank holds of a cell's arguments (tensors, meta
    ones included) laid out by ``shardings`` (a matching tree of
    ``NamedSharding``, None where the argument is None).  Every rank of a
    mesh holds blocks of the same shapes, so this is the largest rank's
    too."""
    leaves, shards = tree.leaves(args), tree.leaves(shardings)
    if len(leaves) != len(shards):
        raise ValueError(f"{len(leaves)} arguments, {len(shards)} "
                         f"shardings")
    return sum(prod(s.shard_shape(t.shape)) * t.element_size()
               for t, s in zip(leaves, shards))


# --------------------------------------------------------------------------
# the round's model axis (tensor parallelism)
# --------------------------------------------------------------------------

# leaf name -> the dim (from the end) that the compute layout splits
_COMPUTE_DIM = {"wq": -1, "wk": -1, "wv": -1, "bq": -1, "bk": -1, "bv": -1,
                "w_gate": -1, "w_up": -1, "b_up": -1, "wo": -2,
                "w_down": -2}


def local_config(cfg, m: int):
    """The config of one rank's shard of ``cfg`` over a model axis of
    ``m``: heads, kv heads and ``d_ff`` over ``m``, ``head_dim`` pinned.
    Raises ``NotImplementedError`` for a family the model axis does not
    split yet, ``ValueError`` where ``m`` does not divide a dim."""
    if m == 1:
        return cfg
    patterns = sorted({p for p, _ in cfg.layout_} - {"decoder"})
    no = [name for name, cond in (
        ("MoE (expert parallelism)", cfg.moe is not None),
        ("MLA", cfg.attn_impl == "mla"),
        (f"the {'/'.join(patterns)} layers", bool(patterns)),
        ("the VLM input merge", cfg.encoder.kind == "vision"),
        ("an encoder memory", cfg.encoder.kind == "audio"))
        if cond]
    if no:
        raise NotImplementedError(
            f"{cfg.name} at a model axis of {m}: {', '.join(no)} on the "
            f"model axis wait for ROADMAP queue 1, item 11b's remainder; "
            f"the decoder GQA family runs there")
    for name in ("n_heads", "n_kv_heads", "d_ff", "vocab_size"):
        if getattr(cfg, name) % m:
            raise ValueError(f"{cfg.name}: a model axis of {m} does not "
                             f"divide {name} = {getattr(cfg, name)}")
    return cfg.replace(n_heads=cfg.n_heads // m,
                       n_kv_heads=cfg.n_kv_heads // m, d_ff=cfg.d_ff // m,
                       head_dim=cfg.head_dim_)


def compute_spec(path: str, shape, mesh) -> Spec:
    """The round's compute layout of one leaf of a ``decoder`` GQA model:
    ``wq`` / ``wk`` / ``wv`` (and biases), ``w_gate`` / ``w_up`` /
    ``b_up`` by columns, ``wo`` / ``w_down`` by rows, the embedding
    table by vocab rows and an untied head by vocab columns; every other
    leaf (norm scales, ``b_down``) whole."""
    spec: List[Optional[str]] = [None] * len(shape)
    if mesh.shape.get("model", 1) == 1:
        return tuple(spec)
    name = path.rsplit("/", 1)[-1]
    if path.endswith("embed/tok"):
        spec[0] = "model"
    elif path.endswith("embed/head"):
        spec[-1] = "model"
    elif name in _COMPUTE_DIM:
        spec[_COMPUTE_DIM[name]] = "model"
    return tuple(spec)


class ModelAxis:
    """One rank's tensor-parallel view of ``cfg``'s params over ``mesh``'s
    ``model`` group: the storage layout (``param_spec_model_only``, the
    round's ``in_shardings``), the compute layout (``compute_spec``) and
    the local config (``local_config``)."""

    def __init__(self, cfg, mesh):
        from repro_torch.models import model as M
        self.mesh = mesh
        self.m = mesh.shape.get("model", 1)
        self.local_cfg = local_config(cfg, self.m)
        paths = tree.leaves_with_paths(M.meta_params(cfg))
        self.shapes = [(tuple(l.shape), l.element_size()) for _, l in paths]
        self.storage = [NamedSharding(mesh, param_spec_model_only(
            p, tuple(l.shape), mesh)) for p, l in paths]
        self.compute = [NamedSharding(mesh, compute_spec(
            p, tuple(l.shape), mesh)) for p, l in paths]
        self.split = [c.is_split() for c in self.compute]

    def _relay(self, leaves, src, dst, where: str) -> list:
        """Each leaf from layout ``src`` into ``dst``: as it is where they
        agree, else gathered whole and cut (a copy, so that the whole
        leaf is freed)."""
        out = []
        for t, a, b in zip(leaves, src, dst):
            if a.spec == b.spec:
                out.append(t)
            else:
                out.append(b.block(a.gather(t, where=where)).clone())
        return out

    def to_compute(self, blocks, *, where: str) -> list:
        """Storage blocks (leaves) -> compute shards: a leaf whose layouts
        differ is gathered over ``model`` (counted at ``where``), then
        cut."""
        return self._relay(blocks, self.storage, self.compute, where)

    def to_storage(self, shards, *, where: str) -> list:
        """Compute shards (leaves) -> storage blocks; a whole leaf is cut
        without a collective."""
        return self._relay(shards, self.compute, self.storage, where)

    def relay_collectives(self) -> dict:
        """The all-gathers of one ``to_compute`` and one ``to_storage``:
        {"calls", "bytes" this rank sends}."""
        calls = nbytes = 0
        for (shape, size), a, b in zip(self.shapes, self.storage,
                                       self.compute):
            if a.spec == b.spec:
                continue
            for src in (a, b):
                if src.is_split():
                    calls += 1
                    nbytes += prod(src.shard_shape(shape)) * size
        return {"calls": calls, "bytes": nbytes}

    def shard_numels(self) -> list:
        """Elements of each compute shard, in leaf order."""
        return [prod(c.shard_shape(shape))
                for (shape, _), c in zip(self.shapes, self.compute)]
