"""Step builders (``repro/launch/steps.py``): the federated train step
(``TrainState``, ``init_train_state``, ``make_train_step``) and the serving
steps (``make_prefill_step``, ``make_serve_step``).  The steps run on
``device`` (``cuda`` when None; building one raises without a GPU) and
move their inputs there; the serving steps run without autograd.

The reference's input shapes (``SHAPES``, ``LONG_CONTEXT_WINDOW``,
``SKIPS``, ``shape_adapted_config``) and its dry run's inputs:
``input_specs`` builds one (architecture x shape) cell's step and its
arguments on the meta device, ``materialize`` draws them on a device, and
``peak_bytes`` reckons the cell's device memory from those shapes before
anything is allocated (``launch/dryrun``, and the serve launcher's
``check_fits_one_card``)."""
from __future__ import annotations

import weakref
from math import prod
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tree
from repro_torch.core.h2fed import H2FedParams
from repro_torch.device import resolve_device
from repro_torch.launch import sharding as shard
from repro_torch.launch.mesh import ShapeMesh, n_agents
from repro_torch.models import model as M
from repro_torch.models import transformer as tf
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import lm_logits

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

# sliding window applied to full-attention archs for the long-context shape
LONG_CONTEXT_WINDOW = 8192

# whisper-tiny long_500k: documented skip (DESIGN.md §Shape-coverage)
SKIPS = {("whisper-tiny", "long_500k"): "enc-dec ASR with 448-token decoder "
         "context; 524k-token decode is not a meaningful configuration"}


def shape_adapted_config(cfg: ArchConfig, shape_name: str) -> ArchConfig:
    """Adapt the arch to the input shape: long_500k forces sub-quadratic
    attention (sliding window) on archs with full attention."""
    if shape_name == "long_500k" and cfg.attn_impl != "none" \
            and cfg.attn_window == 0:
        cfg = cfg.replace(attn_window=LONG_CONTEXT_WINDOW)
    return cfg


# --------------------------------------------------------------------------
# train step
# --------------------------------------------------------------------------

class TrainState(NamedTuple):
    params: Any
    momentum: Any        # fp32, one leaf a param leaf
    anchor_rsu: Any      # w_k  (layer-1 proximal anchor)
    anchor_cloud: Any    # w    (layer-2 proximal anchor)


def train_state(params) -> TrainState:
    """A fresh state around ``params``: zero momentum, and both anchors
    copies of the params (the reference aliases them, which is safe only
    for immutable arrays)."""
    def copy():
        return tree.map_tree(lambda l: l.detach().clone(), params)
    zeros = tree.map_tree(lambda l: torch.zeros(
        l.shape, dtype=torch.float32, device=l.device), params)
    return TrainState(params=params, momentum=zeros, anchor_rsu=copy(),
                      anchor_cloud=copy())


def init_train_state(cfg: ArchConfig, gen: torch.Generator, *,
                     device=None) -> TrainState:
    """Random params from ``gen`` on ``device`` (``cuda`` when None)."""
    return train_state(M.init_params(cfg, gen, device=device))


# values of a leaf that the train step's update takes at once: its fp32
# temporaries are a chunk's (256 MB each), not a stacked leaf's (3.2 GB
# each at phi-3-vision's 32 x 3072 x 8192 MLP leaves)
UPDATE_CHUNK = 1 << 26


def _update_leaf(w, m, g, a1, a2, hp: H2FedParams, beta: float):
    """(w', m') of one leaf: ``m' = beta m + g + mu1 (w - a1) + mu2 (w -
    a2)`` and ``w' = w - lr m'`` in fp32, w' cast to w's dtype, computed
    ``UPDATE_CHUNK`` values at a time into new tensors (elementwise, so
    the chunks change no value)."""
    new_w = torch.empty(w.shape, dtype=w.dtype, device=w.device)
    new_m = torch.empty(m.shape, dtype=torch.float32, device=m.device)
    flat = [t.detach().contiguous().view(-1)
            for t in (w, m, g, a1, a2)] + [new_w.view(-1), new_m.view(-1)]
    for i in range(0, w.numel(), UPDATE_CHUNK):
        wc, mc, gc, x1, x2, out_w, out_m = (t[i:i + UPDATE_CHUNK]
                                            for t in flat)
        wf = wc.float()
        gf = (gc.float() + hp.mu1 * (wf - x1.float())
              + hp.mu2 * (wf - x2.float()))
        m_new = beta * mc + gf
        out_m.copy_(m_new)
        out_w.copy_((wf - hp.lr * m_new).to(w.dtype))
    return new_w, new_m


def make_train_step(cfg: ArchConfig, hp: H2FedParams, beta: float = 0.9, *,
                    device=None):
    """The federated train step: the CSR-masked mean of the agents' losses,
    its gradient, and the dual-proximal momentum update of every leaf.

    The update is the reference's, outside any kernel: in fp32,
    ``m' = beta m + g + mu1 (w - a1) + mu2 (w - a2)`` and ``w' = w - lr m'``
    cast back to the leaf's dtype (round to nearest even).  It runs leaf by
    leaf, ``UPDATE_CHUNK`` values at a time, out of place, and lets each
    leaf's gradient go once it is used, so the peak holds the state, the
    new params and momentum and one chunk's fp32 temporaries; the state
    handed in is left as it is."""
    dev = resolve_device(device)
    aux_w = M.aux_weight(cfg)

    def train_step(state: TrainState, batch: Dict[str, Any], mask):
        """batch leaves: (A, b, ...); mask: (A,) float connectivity.
        Returns (new state, {"loss", "aux"})."""
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        mf = torch.as_tensor(mask).to(dev).float()
        A, b = batch["tokens"].shape[:2]
        leaves = [l.detach().requires_grad_() for l in
                  tree.leaves(state.params)]
        params = tree.unflatten(state.params, leaves)
        flat = {k: v.reshape((-1,) + tuple(v.shape[2:]))
                for k, v in batch.items()}
        with torch.enable_grad():
            nll, aux = M.per_example_loss(cfg, params, flat)
            per_agent = nll.reshape(A, b).mean(dim=1)
            loss = (per_agent * mf).sum() / mf.sum().clamp(min=1.0)
            grads = list(torch.autograd.grad(loss + aux_w * aux, leaves))
        del leaves, params
        new_p, new_m = [], []
        for i, (w, m, a1, a2) in enumerate(zip(
                tree.leaves(state.params), tree.leaves(state.momentum),
                tree.leaves(state.anchor_rsu),
                tree.leaves(state.anchor_cloud))):
            g, grads[i] = grads[i], None
            w_new, m_new = _update_leaf(w, m, g, a1, a2, hp, beta)
            del g
            new_p.append(w_new)
            new_m.append(m_new)
        new_state = TrainState(
            params=tree.unflatten(state.params, new_p),
            momentum=tree.unflatten(state.momentum, new_m),
            anchor_rsu=state.anchor_rsu, anchor_cloud=state.anchor_cloud)
        return new_state, {"loss": loss.detach(), "aux": aux.detach()}

    return train_step


# --------------------------------------------------------------------------
# prefill / serve steps
# --------------------------------------------------------------------------


def make_prefill_step(cfg: ArchConfig, *, device=None):
    dev = resolve_device(device)

    @torch.no_grad()
    def prefill_step(params, batch: Dict[str, Any]) -> torch.Tensor:
        """The next-token logits (B, V) fp32 after the prompt.  The head is
        applied to the last position only: the same values as the JAX
        step's ``logits[:, -1, :]``, without its (B, S, V) fp32 logits
        (about 20 GB at B=4, S=8192 for qwen3-0.6b).  ``batch`` holds
        ``tokens`` and, by the config's front end, ``patch_embeds`` (a
        VLM) or ``memory`` (an audio model's encoder frames)."""
        batch = {k: v.to(dev) for k, v in batch.items()}
        x, _ = M.hidden_states(cfg, params, batch)
        return lm_logits(cfg, params["embed"], x[:, -1:])[:, 0]
    return prefill_step


def make_serve_step(cfg: ArchConfig, *, device=None):
    dev = resolve_device(device)

    @torch.no_grad()
    def serve_step(params, cache, tokens, cur_pos, memory=None):
        """One decode step: (logits (B, V) fp32, cache updated in place);
        ``memory``: an audio model's encoder frames (B, M, d_embed)."""
        logits, cache = M.decode_step(
            cfg, params, cache, tokens.to(dev), cur_pos.to(dev),
            memory=None if memory is None else memory.to(dev))
        return logits[:, -1, :], cache
    return serve_step


# --------------------------------------------------------------------------
# the dry run's inputs: the reference's input specs, on the meta device
# --------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _extra_model_inputs(cfg: ArchConfig, lead: Tuple[int, ...]):
    """VLM patch embeddings / audio encoder memory, with leading dims."""
    extras = {}
    shape = tuple(lead) + (cfg.encoder.n_positions, cfg.encoder.d_embed)
    if cfg.encoder.kind == "vision":
        extras["patch_embeds"] = _meta(shape, torch.float32)
    if cfg.encoder.kind == "audio":
        extras["memory"] = _meta(shape, torch.float32)
    return extras


def decode_args(cfg: ArchConfig, batch: int, cache_len: int,
                params=None) -> tuple:
    """A decode step's arguments on the meta device: (params, cache of
    ``batch`` x ``cache_len``, tokens (B, 1), cur_pos (B,), memory (B, M,
    d_embed) for an audio model, else None).  A VLM decodes text tokens
    only: its image context lives in the prefilled cache.  ``params``:
    the meta params when already built."""
    cache = tf.stack_init_cache(cfg, batch, cache_len, device="meta")
    memory = _extra_model_inputs(cfg, (batch,)).get("memory")
    return (M.meta_params(cfg) if params is None else params, cache,
            _meta((batch, 1), torch.int32),
            _meta((batch,), torch.int32), memory)


def input_specs(cfg: ArchConfig, shape_name: str, mesh=None,
                hp: Optional[H2FedParams] = None, *, device=None):
    """One (arch x shape) cell of the dry run (the reference's
    ``input_specs``): dict(fn, args, in_shardings, cfg, desc) and the
    cell's ``kind``, ``batch`` and ``seq``.  ``args`` has the reference's
    tree, every leaf on the meta device with the reference's shape and
    dtype (nothing is allocated): (``TrainState``, batch, mask) for a
    train shape, (params, batch) for prefill, (params, cache, tokens,
    cur_pos, memory) for decode.  ``in_shardings`` is the reference's, a
    ``sharding.NamedSharding`` a leaf on ``mesh`` (a ``FleetMesh`` or a
    ``ShapeMesh``, e.g. ``make_production_mesh``; None is the one-rank
    (pod, data, model) mesh): the params by ``param_shardings`` (the
    config's ``shard_strategy``), a train batch by ``act_spec`` /
    ``act_spec_dp`` and its mask replicated, a prefill batch and the
    decode tokens, positions and memory by ``act_spec`` (None where the
    memory is None), the cache by ``cache_shardings``.  ``fn`` is the
    port's one-process step for those arguments, built for ``device``
    (``cuda`` when None); ``materialize`` draws the arguments.  The
    mesh's agents split a train batch."""
    cfg = shape_adapted_config(cfg, shape_name)
    info = SHAPES[shape_name]
    seq, batch = info["seq"], info["batch"]
    hp = hp or H2FedParams()
    mesh = ShapeMesh((1, 1, 1), ("pod", "data", "model")) if mesh is None \
        else mesh
    i32 = torch.int32
    cell = dict(cfg=cfg, kind=info["kind"], batch=batch, seq=seq)
    params = M.meta_params(cfg)
    p_shard = shard.param_shardings(params, mesh,
                                    strategy=cfg.shard_strategy)

    def on(spec_fn, t):
        return shard.NamedSharding(mesh, spec_fn(tuple(t.shape), mesh))

    if info["kind"] == "train":
        A = n_agents(mesh)
        b = batch // A
        assert b >= 1, f"{shape_name}: global batch {batch} < {A} agents"
        state = TrainState(
            params=params,
            momentum=tree.map_tree(lambda l: _meta(l.shape, torch.float32),
                                   params),
            anchor_rsu=params, anchor_cloud=params)
        batch_tree = {"tokens": _meta((A, b, seq), i32),
                      "labels": _meta((A, b, seq), i32)}
        batch_tree.update(_extra_model_inputs(cfg, (A, b)))
        act = shard.act_spec_dp if cfg.shard_strategy == "dp" \
            else shard.act_spec
        return dict(fn=make_train_step(cfg, hp, device=device),
                    args=(state, batch_tree, _meta((A,), torch.float32)),
                    in_shardings=(TrainState(p_shard, p_shard, p_shard,
                                             p_shard),
                                  {k: on(act, v)
                                   for k, v in batch_tree.items()},
                                  shard.replicated(mesh)),
                    desc=f"train A={A} b={b} S={seq}", **cell)

    if info["kind"] == "prefill":
        batch_tree = {"tokens": _meta((batch, seq), i32)}
        batch_tree.update(_extra_model_inputs(cfg, (batch,)))
        return dict(fn=make_prefill_step(cfg, device=device),
                    args=(params, batch_tree),
                    in_shardings=(p_shard, {
                        k: on(shard.act_spec, v)
                        for k, v in batch_tree.items()}),
                    desc=f"prefill B={batch} S={seq}", **cell)

    args = decode_args(cfg, batch, seq, params=params)
    _, cache, tokens, cur_pos, memory = args
    return dict(fn=make_serve_step(cfg, device=device), args=args,
                in_shardings=(p_shard, shard.cache_shardings(cache, mesh),
                              on(shard.act_spec, tokens),
                              on(shard.act_spec, cur_pos),
                              None if memory is None
                              else on(shard.act_spec, memory)),
                desc=f"decode B={batch} T={seq}"
                     + (f" win={cfg.attn_window}" if cfg.attn_window else ""),
                **cell)


def _caches(node):
    """The cache named tuples (KV, MLA, Mamba, mLSTM, sLSTM) in a cache
    tree."""
    if hasattr(node, "_fields"):
        yield node
    elif isinstance(node, dict):
        for k in sorted(node):
            yield from _caches(node[k])
    elif isinstance(node, (list, tuple)):
        for x in node:
            yield from _caches(x)


def fill_cache(cache, gen: torch.Generator, cur: int):
    """Fill a decode cache in place so that the next step decodes position
    ``cur`` over a full cache: every value drawn N(0, 1) from ``gen``, each
    ring slot j holding the latest position before ``cur`` that maps to it
    (``cur - 1 - ((cur - 1 - j) mod T)``, -1 where there is none), the
    write index ``idx`` at ``cur`` (so the step writes slot ``cur % T``)
    and a Mamba layer's step count at ``cur``.  For ``long_500k`` (T =
    8,192, cur = 524,287) all 8,192 slots are live when the step attends.
    Returns the cache."""
    from repro_torch.models.ssm import MambaCache
    for c in _caches(cache):
        for name, t in zip(c._fields, c):
            if name == "idx" or (name == "pos" and isinstance(c, MambaCache)):
                t.fill_(cur)
            elif name == "pos":
                T = t.shape[-1]
                j = torch.arange(T, device=t.device, dtype=torch.int64)
                p = cur - 1 - torch.remainder(cur - 1 - j, T)
                t.copy_(torch.where(p >= 0, p, -1).to(t.dtype).expand_as(t))
            else:
                t.normal_(generator=gen)
    return cache


def _draw_batch(batch_tree, cfg: ArchConfig, gen, dev) -> dict:
    """Tokens and labels in [0, vocab); patch embeddings and memory
    N(0, 1) in fp32."""
    out = {}
    for k, t in batch_tree.items():
        if t.dtype.is_floating_point:
            out[k] = torch.randn(tuple(t.shape), generator=gen, device=dev,
                                 dtype=t.dtype)
        else:
            out[k] = torch.randint(0, cfg.vocab_size, tuple(t.shape),
                                   generator=gen, device=dev, dtype=t.dtype)
    return out


def materialize(spec: dict, gen: torch.Generator, device=None,
                params=None) -> tuple:
    """A spec's meta arguments as tensors on ``device`` (``cuda`` when
    None), drawn from ``gen`` (which lies there): the params through
    ``M.init_params`` (one layer slice at a time; ``params`` passes ones
    already drawn for the same config), then the rest in the args' order;
    a train state's momentum zero and its anchors copies of the params;
    masks and data sizes ones.  A decode cache is filled by
    ``fill_cache`` for a step at the shape's last position, ``seq - 1``,
    which ``cur_pos`` holds.  This is how the port's dry run executes a
    cell; the reference's dry run only compiles, so it has no such
    function."""
    dev = resolve_device(device)
    cfg, kind, args = spec["cfg"], spec["kind"], spec["args"]
    if params is None:
        params = M.init_params(cfg, gen, device=dev)
    if kind == "train":
        _, batch_tree, mask = args
        return (train_state(params), _draw_batch(batch_tree, cfg, gen, dev),
                torch.ones(tuple(mask.shape), device=dev))
    if kind == "prefill":
        return params, _draw_batch(args[1], cfg, gen, dev)
    if kind == "h2fed_round":
        _, batch_tree, mask, n_data = args
        return (params, _draw_batch(batch_tree, cfg, gen, dev),
                torch.ones(tuple(mask.shape), device=dev),
                torch.ones(tuple(n_data.shape), device=dev))
    _, cache, tokens, cur_pos, memory = args
    B, cur = tokens.shape[0], spec["seq"] - 1
    cache = fill_cache(tf.stack_init_cache(cfg, B, spec["seq"], device=dev),
                       gen, cur)
    tok = torch.randint(0, cfg.vocab_size, tuple(tokens.shape),
                        generator=gen, device=dev, dtype=tokens.dtype)
    mem = (None if memory is None else torch.randn(
        tuple(memory.shape), generator=gen, device=dev))
    return (params, cache, tok,
            torch.full(tuple(cur_pos.shape), cur, dtype=cur_pos.dtype,
                       device=dev), mem)


# --------------------------------------------------------------------------
# the memory reckoning (shapes on the meta device; nothing allocated)
# --------------------------------------------------------------------------

# the runtime's own device memory beside a step's tensors: cuBLAS
# workspaces, the split-key kernel's counters and partials
RUNTIME_BYTES = 256 << 20
CARD_BYTES = 80e9         # one H100's device memory, where none is present


def card_bytes(dev: torch.device) -> float:
    """The device memory a cell must fit: the card's, or one H100's on
    the host."""
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).total_memory
    return CARD_BYTES
_SMALL, _ALIGN = 1 << 20, 512


def _block_bytes(n: int) -> int:
    """The most a block of the caching allocator holds for ``n`` bytes:
    rounded up to 512, and a large block (over 1 MiB) unsplit by up to 1
    MiB more."""
    n = -(-n // _ALIGN) * _ALIGN
    return n + _SMALL if n > _SMALL else n


class _LiveBytes(TorchDispatchMode):
    """The bytes of the storages that the ops run under it create, live
    and at their peak, each counted as the allocator's block
    (``_block_bytes``); storages that existed before (``known``: the
    params, inputs and cache) are not counted, nor ops that write into
    them or view them."""

    def __init__(self, known=()):
        super().__init__()
        self.live = self.peak = 0
        # storage id -> (bytes, a weak reference that frees them)
        self._held: Dict[int, tuple] = {}
        self._known = [t.untyped_storage() for t in known]
        for st in self._known:
            self._held[id(st)] = (0, None)

    def _note(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._held:
            return
        n = _block_bytes(st.nbytes())
        self._held[key] = (n, weakref.ref(st, lambda _, k=key: self._free(k)))
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, key: int) -> None:
        self.live -= self._held.pop(key, (0, None))[0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if isinstance(out, torch.Tensor):
            self._note(out)
        else:
            for t in torch.utils._pytree.tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self._note(t)
        return out


def _leaves(node) -> list:
    return [t for t in tree.leaves(node) if isinstance(t, torch.Tensor)]


def _bytes(node) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(node))


def step_transient(fn, args) -> int:
    """The peak bytes that ``fn(*args)`` (a step built for the meta
    device, on meta arguments) holds beside its arguments: every tensor
    it creates, counted while it lives, each as the caching allocator's
    block.  The kernels' wrappers return their outputs' shapes there
    (``kernels/ops``)."""
    with _LiveBytes(_leaves(args)) as live:
        fn(*args)
    return live.peak


def one_layer_each(cfg: ArchConfig) -> ArchConfig:
    """``cfg`` cut to one layer of each pattern of its stack (one Mamba
    layer a ``zamba_super`` run), after a first layer of its last
    pattern.  A no-grad step frees each layer's tensors before the next
    layer's, so its transient is that of its largest layer at any depth,
    with one more (B, S, d) tensor from the second layer on: the
    embedding output, which the caller holds while the stack runs.  The
    leading layer puts every pattern's layer there, and the cut reckons
    the transient L / 3 times faster or more."""
    seen, layout = set(), []
    for pattern, _ in cfg.layout_:
        if pattern not in seen:
            seen.add(pattern)
            layout.append((pattern, 1))
    layout = [layout[-1]] + layout
    return cfg.replace(layout=tuple(layout), n_layers=len(layout),
                       shared_every=min(cfg.shared_every, 1))


def _forward_transient(cfg: ArchConfig, batch_tree) -> int:
    """The no-grad prefill step's transient at ``batch_tree``'s tokens."""
    cut = one_layer_each(cfg)
    return step_transient(make_prefill_step(cut, device="meta"),
                          (M.meta_params(cut), batch_tree))


def _train_transient(cfg: ArchConfig, batch_tree) -> int:
    """A train step's (or a local epoch's) transient, reckoned from
    shapes: the gradients in the params' dtypes; the fp32 temporaries of
    the largest leaf's update; the fp32 (N, V) logits with their bf16
    product, log-softmax and gradient (16 bytes an entry); the input of
    every layer, which ``torch.utils.checkpoint`` keeps for the backward;
    and twice the no-grad forward's own transient at the same tokens (a
    layer's backward beside its recomputed forward).  Autograd through
    the kernels' backward has no meta route, so this is not simulated."""
    tokens = batch_tree["tokens"]
    n_seq, seq = prod(tokens.shape[:-1]), tokens.shape[-1]
    N = n_seq * seq
    leaves = [t for t in _leaves(M.meta_params(cfg))]
    grads = sum(t.numel() * t.element_size() for t in leaves)
    update = 4 * 4 * max(t.numel() for t in leaves)
    logits = 16 * N * cfg.vocab_size
    width = torch.finfo(cfg.activation_dtype).bits // 8
    apps = sum(r * (1 + cfg.shared_every if p == "zamba_super" else 1)
               for p, r in cfg.layout_)
    saved = apps * N * cfg.d_model * width
    flat = {k: _meta((n_seq,) + tuple(v.shape[len(tokens.shape) - 1:]),
                     v.dtype) for k, v in batch_tree.items()
            if k != "labels"}
    return grads + update + logits + saved + 2 * _forward_transient(cfg,
                                                                    flat)


def peak_bytes(spec: dict) -> dict:
    """A cell's device memory at its peak, reckoned from its meta
    arguments before anything is allocated: ``params``, ``inputs``,
    ``cache`` (decode), ``state`` (train: the fp32 momentum and both
    anchors; the h2fed round: the agent's two working copies of the
    params), ``transient`` and ``draw`` (the fp32 temporary of the largest
    slice ``M.init_params`` draws at once).  ``transient`` is the step's
    own: for prefill and decode every tensor the step creates, counted
    while it lives (``step_transient``; a decode step's inputs also hold
    the previous step's fp32 logits, as a decode loop keeps them); for
    train and the h2fed round ``_train_transient``.  ``total`` is the
    larger of the draw's peak and the step's, plus ``runtime``
    (``RUNTIME_BYTES``).  All in bytes."""
    cfg, kind, args = spec["cfg"], spec["kind"], spec["args"]
    params = M.param_bytes(cfg)
    parts = {"params": params, "inputs": 0, "cache": 0, "state": 0}
    if kind == "decode":
        _, cache, tokens, _, _ = args
        parts["cache"] = _bytes(cache)
        parts["inputs"] = (_bytes(args[2:])
                           + 4 * tokens.shape[0] * cfg.vocab_size)
        cut = one_layer_each(cfg)
        parts["transient"] = step_transient(
            make_serve_step(cut, device="meta"),
            decode_args(cut, tokens.shape[0], spec["seq"]))
    elif kind == "prefill":
        parts["inputs"] = _bytes(args[1])
        parts["transient"] = _forward_transient(cfg, args[1])
    elif kind == "train":
        state, batch_tree, mask = args
        parts["state"] = _bytes(state.momentum) + 2 * params
        parts["inputs"] = _bytes(batch_tree) + _bytes(mask)
        parts["transient"] = _train_transient(cfg, batch_tree)
    elif kind == "h2fed_round":
        _, batch_tree, mask, n_data = args
        parts["state"] = 2 * params
        parts["inputs"] = _bytes(batch_tree) + _bytes((mask, n_data))
        one = {k: v[0, 0] for k, v in batch_tree.items()}
        parts["transient"] = _train_transient(cfg, one)
    else:
        raise ValueError(f"peak_bytes: unknown step kind {kind!r}")
    parts["draw"] = 4 * M.largest_draw_slice(cfg)
    parts["runtime"] = RUNTIME_BYTES
    step = sum(parts[k] for k in ("params", "inputs", "cache", "state",
                                  "transient"))
    parts["total"] = max(params + parts["draw"], step) + RUNTIME_BYTES
    return parts
