"""Cohort-streamed rounds: fleets larger than the card's memory.

The resident engines (``fedsim/simulator``, ``fedsim/async_engine``) hold
the whole fleet as one device (A, N) buffer, so the card's memory bounds
A.  The paper's participation model has the opposite shape: a cohort of a
huge connected fleet works each round.  Here the device holds a chunk of
agents, not the fleet:

* agent rows live in a fleet store (``core/fleet_store``): ``"host"``
  keeps the (A, N) fleet in pinned host memory in the storage dtype (fp32
  or bf16), ``"device"`` keeps the resident buffer but still bounds each
  step's training working set to a chunk;
* each local round (async: tick) streams the fleet in chunks of a fixed
  size (the tail chunk zero-padded, its padded agents at weight 0, 0
  training steps and RSU 0): gather the chunk's RSU start rows, train them
  with the engines' own ``_local_train_flat`` (kernel #3 once a step), and
  add the chunk into running (R, N) fp32 numerator and (R,) mass sums with
  ``ops.chunk_agg`` (kernel #2), so the device working set is O(chunk x N
  + R x N) whatever A is.  On the host the sums run agent by agent in
  fleet order, as the resident engines' plain versions sum;
* the copies overlap the compute: on a card, chunk c+1's inputs go up on a
  copy stream, staged through reused pinned buffers, before chunk c's
  compute is enqueued; chunk c's trained rows go down on a second copy
  stream into a pinned staging buffer after an event that marks its
  compute done, and reach a host store only after their copy's own event,
  while chunk c+1 computes;
* the algebra is the resident engines': the chunks' summed numerators and
  masses close each local round with ``aggregation.normalize_blend`` (the
  synchronous round) or ``aggregation.buffer_absorb`` (the semi-async
  tick), and the round ends with ``ops.cloud_blend`` (kernel #1).

Three rounds stream: ``make_streamed_flat_round`` (the synchronous round),
``make_streamed_async_round`` (the tick loop, the in-flight pending rows in
a second store and only (A,)-sized bookkeeping on the device) and
``make_streamed_twoaxis_round`` (agents x parameters: every N-wide buffer
in host memory, aggregation and blends per lane-aligned column tile, so no
(R, N) buffer reaches the device).  At small A they match the resident
engines to fp32 tolerance.

Draws: a round draws its local rounds' (ticks') connectivity, FSR steps
and (async) latencies up front from the state's generator in the resident
engines' order, so a streamed round draws what the resident one would.
The seam ``draws`` takes the resident engines' format in their place:
(mask, active_steps) a local round (flat, two-axis), (mask, active_steps,
delays) a tick (async).

Faults: a round built with a ``FaultPlan`` takes ``fault_r``, its slice of
the lowered schedule as tensors.  Churn and outages fold into the weights
(a churned agent or one behind a dark RSU weighs 0; the benign schedule is
``w * 1.0``, a bitwise no-op); the async round also re-anchors a
recovering RSU and masks the cloud blend by outage.  The non-finite guard
screens each chunk.  Corrupted-update plans are refused, and ``norm_clip``
is not applied, as in the JAX package's streamed rounds.

``fedsim.run_scenario`` dispatches here when a spec sets
``fleet_store="host"`` or ``chunk_agents > 0``; ``run_streamed_simulation``
takes hand-built arrays.
"""
from __future__ import annotations

import math
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from repro_torch.core import faults as faults_mod
from repro_torch.core.aggregation import (buffer_absorb, normalize_blend,
                                          screen_updates)
from repro_torch.core.flatten import FlatSpec, Params, spec_of
from repro_torch.core.fleet_store import (DeviceFleetStore, HostFleetStore,
                                          make_fleet_store,
                                          resolve_fleet_store)
from repro_torch.core.h2fed import H2FedParams
from repro_torch.core.heterogeneity import (ConnState, HeterogeneityModel,
                                            init_conn_state, sample_latency)
from repro_torch.data.partition import FederatedData
from repro_torch.device import resolve_device
from repro_torch.fedsim.async_engine import AsyncConfig, async_config
from repro_torch.fedsim.simulator import (FleetData, Lanes, SimConfig,
                                          _local_train_flat, round_draws)
from repro_torch.kernels import ops
from repro_torch.models import mlp

# the chunk when a spec leaves chunk_agents at 0: big enough to feed the
# batched training, small enough that (chunk, N) is a sliver of any fleet
# worth streaming
DEFAULT_CHUNK = 1024
# the N-tile grid's alignment (the JAX package's lane width), so a tiled
# round's tiles are the reference's
LANE = 128


class ChunkPlan(NamedTuple):
    """The agent axis in ``n_chunks`` chunks of ``chunk`` rows; the last
    carries ``pad`` zero rows, so every chunk has one shape."""
    chunk: int
    n_chunks: int
    n_agents: int
    pad: int

    @property
    def n_padded(self) -> int:
        return self.n_chunks * self.chunk

    def bounds(self, c: int) -> Tuple[int, int]:
        """(row offset, valid rows) of chunk ``c``."""
        lo = c * self.chunk
        return lo, min(lo + self.chunk, self.n_agents) - lo


def make_chunk_plan(n_agents: int, chunk_agents: int = 0) -> ChunkPlan:
    chunk = chunk_agents if chunk_agents > 0 else DEFAULT_CHUNK
    chunk = max(1, min(chunk, n_agents))
    n_chunks = -(-n_agents // chunk)
    return ChunkPlan(chunk=chunk, n_chunks=n_chunks, n_agents=n_agents,
                     pad=n_chunks * chunk - n_agents)


class NTilePlan(NamedTuple):
    """The parameter axis in ``n_tiles`` lane-aligned tiles of ``tile``
    columns; the buffers carry ``pad`` trailing zero columns (algebra-
    neutral, like the agent axis' pad)."""
    tile: int
    n_tiles: int
    n: int
    pad: int

    @property
    def n_padded(self) -> int:
        return self.n_tiles * self.tile

    def bounds(self, t: int) -> Tuple[int, int]:
        """(col_lo, col_hi) of tile ``t`` on the padded grid."""
        lo = t * self.tile
        return lo, lo + self.tile


def make_ntile_plan(n: int, chunk_params: int = 0) -> NTilePlan:
    """Tiles of about ``chunk_params`` columns, rounded up to the lane grid
    (``chunk_params=0``: one tile)."""
    tile = chunk_params if chunk_params > 0 else n
    tile = max(LANE, min(tile, n))
    tile = -(-tile // LANE) * LANE
    n_tiles = max(-(-n // tile), 1)
    return NTilePlan(tile=tile, n_tiles=n_tiles, n=n, pad=n_tiles * tile - n)


def _data_chunks(fed: FederatedData, plan: ChunkPlan) -> List[tuple]:
    """Each chunk's (x, y, rsu_assign) as host arrays: views of the
    FederatedData (a broadcast fleet stays virtual) except the tail chunk,
    which is zero-padded."""
    xs, ys = np.asarray(fed.x), np.asarray(fed.y)
    asg = np.asarray(fed.rsu_assign, np.int32)
    out = []
    for c in range(plan.n_chunks):
        lo, valid = plan.bounds(c)
        x, y, a = xs[lo:lo + valid], ys[lo:lo + valid], asg[lo:lo + valid]
        if valid < plan.chunk:
            p = plan.chunk - valid
            x = np.concatenate([x, np.zeros((p,) + x.shape[1:], x.dtype)])
            y = np.concatenate([y, np.zeros((p,) + y.shape[1:], y.dtype)])
            a = np.concatenate([a, np.zeros((p,), a.dtype)])
        out.append((x, y, a))
    return out


def _pad_tail(rows: torch.Tensor, chunk: int) -> torch.Tensor:
    """Zero rows appended to a tail chunk up to ``chunk`` rows."""
    valid = rows.shape[0]
    if valid == chunk:
        return rows
    return torch.cat([rows, rows.new_zeros((chunk - valid,)
                                           + tuple(rows.shape[1:]))])


def streamed_transfer_bytes(plan: ChunkPlan, spec: FlatSpec, hp: H2FedParams,
                            fed: FederatedData, *, engine: str = "flat",
                            fleet_store: str = "host") -> Dict[str, float]:
    """Host <-> device bytes a global round, as the JAX package counts
    them: the device store pays none; the host store pays, each local
    round, the data chunks up (x, y, assign) and the trained rows down, and
    (async) the pending rows up and the enqueued rows down (an upper bound:
    every agent could enqueue).  Padded rows count."""
    if resolve_fleet_store(fleet_store) == "device":
        return {"h2d": 0.0, "d2h": 0.0, "total": 0.0}
    x, y = np.asarray(fed.x[:1]), np.asarray(fed.y[:1])
    per_agent_data = (x.dtype.itemsize * x[0].size
                      + y.dtype.itemsize * y[0].size + 4)   # + int32 assign
    itemsize = torch.empty((), dtype=spec.storage_dtype).element_size()
    rows = plan.n_padded * spec.n * itemsize
    h2d = hp.lar * plan.n_padded * per_agent_data
    d2h = hp.lar * rows
    if engine == "async":
        h2d += hp.lar * rows                                # pending gather
        d2h += hp.lar * rows                                # enqueue bound
    return {"h2d": float(h2d), "d2h": float(d2h), "total": float(h2d + d2h)}


# --------------------------------------------------------------------------
# the copies between host and device
# --------------------------------------------------------------------------

class _Link:
    """One streamed engine's copies between host memory and the device.

    On a card, uploads run on their own stream from pinned staging buffers
    into device buffers, two sets of each used in turns: a staging buffer
    is refilled only after the copy that last read it has landed, a device
    buffer only after the current stream's work enqueued before the upload
    (which holds the compute that last read it), and ``take`` makes the
    current stream wait for the copies.  So the uploads hold two chunks'
    inputs on the device however many chunks a fleet has.  Downloads run
    on a second stream, after the current stream's work so far, into
    pinned buffers.  ``bytes`` counts what crossed.  On the CPU every copy
    is a plain one."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.up = torch.cuda.Stream(device) if self.cuda else None
        self.down = torch.cuda.Stream(device) if self.cuda else None
        self._bufs: Dict[tuple, torch.Tensor] = {}
        self._device_bufs: Dict[tuple, torch.Tensor] = {}
        self._events: Dict[tuple, torch.cuda.Event] = {}
        self._turn = {"up": 0, "down": 0}
        self.bytes = {"h2d": 0, "d2h": 0}

    def _staging(self, kind: str, i: int, shape,
                 dtype) -> Tuple[tuple, torch.Tensor]:
        """Pinned buffer ``i`` of this turn's set, once its last copy has
        landed."""
        key = (kind, i, self._turn[kind])
        n = math.prod(shape)
        buf = self._bufs.get(key)
        if buf is None or buf.dtype != dtype or buf.numel() < n:
            buf = self._bufs[key] = torch.empty(n, dtype=dtype,
                                                pin_memory=True)
        ev = self._events.pop(key, None)
        if ev is not None:
            ev.synchronize()
        return key, buf[:n].view(shape)

    def upload(self, parts: Sequence, rows: int):
        """Each part (a numpy array or tensor of at most ``rows`` rows) on
        the device, zero-padded to ``rows``; a handle for ``take``.  A part
        already on the device (a device store's rows) is padded on the
        current stream, in order with the writes into its store."""
        if not self.cuda:
            return [_pad_tail(torch.as_tensor(np.array(p) if isinstance(
                p, np.ndarray) else p), rows) for p in parts], None
        self._turn["up"] ^= 1
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        self.up.wait_event(ready)
        out, keys = [], []
        for i, p in enumerate(parts):
            if torch.is_tensor(p) and p.is_cuda:
                out.append(_pad_tail(p, rows))
                continue
            numpy = isinstance(p, np.ndarray)
            dtype = torch.from_numpy(np.empty(0, p.dtype)).dtype if numpy \
                else p.dtype
            key, slot = self._staging("up", i, (rows,) + tuple(p.shape[1:]),
                                      dtype)
            valid = p.shape[0]
            if numpy:
                np.copyto(slot[:valid].numpy(), p)
            else:
                slot[:valid].copy_(p)
            slot[valid:].zero_()
            dev = self._device_bufs.get(key)
            if dev is None or dev.shape != slot.shape or dev.dtype != dtype:
                dev = self._device_bufs[key] = torch.empty(
                    slot.shape, dtype=dtype, device=self.device)
            with torch.cuda.stream(self.up):
                dev.copy_(slot, non_blocking=True)
            out.append(dev)
            keys.append(key)
            self.bytes["h2d"] += slot.nbytes
        ev = None
        if keys:
            ev = torch.cuda.Event()
            ev.record(self.up)
            self._events.update((k, ev) for k in keys)
        return out, ev

    def take(self, handle) -> List[torch.Tensor]:
        """An upload's tensors, ready for the current stream."""
        out, ev = handle
        if ev is not None:
            torch.cuda.current_stream(self.device).wait_event(ev)
        return out

    def download(self, rows: torch.Tensor,
                 into: Optional[torch.Tensor] = None):
        """Start copying device ``rows`` into a pinned staging buffer, or
        straight into ``into`` (pinned host rows of the same shape), once
        the current stream's work so far is done; a handle for
        ``landed``."""
        if not self.cuda:
            return (rows if into is None else into.copy_(rows)), None
        key = None
        if into is None:
            self._turn["down"] ^= 1
            key, into = self._staging("down", 0, tuple(rows.shape),
                                      rows.dtype)
        self.down.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.down):
            into.copy_(rows, non_blocking=True)
        rows.record_stream(self.down)
        ev = torch.cuda.Event()
        ev.record(self.down)
        if key is not None:
            self._events[key] = ev
        self.bytes["d2h"] += rows.nbytes
        return into, ev

    @staticmethod
    def landed(handle) -> torch.Tensor:
        """A download's host rows, once its copy has landed."""
        host, ev = handle
        if ev is not None:
            ev.synchronize()
        return host

    def to_device(self, t: torch.Tensor) -> torch.Tensor:
        """A host tensor on the device (a synchronous copy)."""
        if not self.cuda:
            return t
        self.bytes["h2d"] += t.nbytes
        return t.to(self.device)

    def to_host(self, t: torch.Tensor) -> torch.Tensor:
        """A device tensor on the host (waits for it)."""
        if not self.cuda:
            return t
        self.bytes["d2h"] += t.nbytes
        return t.cpu()


class _Writeback:
    """Deferred-by-one writeback of trained chunks: ``push`` starts chunk
    c's rows down (for host stores) and lands chunk c-1's in its stores,
    so the host's wait and copy overlap chunk c's compute.  Whole rows for
    one pinned store go straight into it; masked writes go through a
    staging buffer, which the store reads only after the copy's event."""

    def __init__(self, link: _Link):
        self.link = link
        self._pending = None

    def push(self, lo: int, rows: torch.Tensor, writes) -> None:
        """``writes``: (store, row mask or None) pairs for ``rows`` at
        ``lo``."""
        hosts = [store for store, _ in writes if store.kind == "host"]
        direct = (len(writes) == 1 and writes[0][1] is None and hosts
                  and hosts[0].pinned)
        handle = None
        if hosts:
            handle = self.link.download(rows, into=hosts[0].gather(
                lo, lo + rows.shape[0]) if direct else None)
        self.flush()
        self._pending = (lo, rows, handle, () if direct else writes)

    def flush(self) -> None:
        if self._pending is None:
            return
        lo, rows, handle, writes = self._pending
        self._pending = None
        host = None if handle is None else self.link.landed(handle)
        for store, where in writes:
            store.scatter(lo, host if store.kind == "host" else rows,
                          where=where)


# --------------------------------------------------------------------------
# shared pieces of the rounds
# --------------------------------------------------------------------------

class _Fleet(NamedTuple):
    """What every streamed round holds of the fleet: the chunk plan, the
    host data chunks and the (A,)-sized blocks on the device."""
    plan: ChunkPlan
    chunks: List[tuple]
    n_per_agent: torch.Tensor   # (A,) fp32
    rsu_assign: torch.Tensor    # (A,) int64
    spe: int
    n_steps: int


def _fleet(cfg: SimConfig, hp: H2FedParams, fed: FederatedData,
           chunk_agents: int, device) -> _Fleet:
    plan = make_chunk_plan(cfg.n_agents, chunk_agents)
    spe = max(int(fed.x.shape[1]) // cfg.batch, 1)
    return _Fleet(
        plan=plan, chunks=_data_chunks(fed, plan),
        n_per_agent=torch.tensor(np.asarray(fed.n_per_agent),
                                 dtype=torch.float32, device=device),
        rsu_assign=torch.tensor(np.asarray(fed.rsu_assign),
                                dtype=torch.long, device=device),
        spe=spe, n_steps=hp.local_epochs * spe)


def _pad(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Pad the last axis with ``pad`` zeros."""
    return torch.nn.functional.pad(t, (0, pad)) if pad else t


def _refuse_corrupts(faults) -> None:
    if faults is not None and faults.corrupts:
        raise ValueError("corrupted-update injection is not supported on the "
                         "cohort-streamed rounds (churn, outages and the "
                         "non-finite guard are)")


def _train_chunk(spec: FlatSpec, fl: _Fleet, lanes: Lanes, batch: int,
                 x_c, y_c, w_start, cloud, act_c) -> torch.Tensor:
    """One chunk's agents trained from their start rows: (chunk, N) in the
    storage dtype."""
    data = FleetData(x=x_c, y=y_c.long(), n_per_agent=None, rsu_assign=None,
                     spe=fl.spe)
    return spec.to_storage(_local_train_flat(
        spec, data, w_start[None], cloud[None], lanes, fl.n_steps,
        act_c[None], batch)[0])


def _flat_draws(state, het: HeterogeneityModel, hp: H2FedParams,
                fl: _Fleet, draws, fault_r):
    """One round's draws on the chunk grid: (conn', weights (lar, A_pad)
    fp32, steps (lar, A_pad)), the state's generator drawn in the flat
    engine's order or the injected (mask, active_steps) pairs (then conn
    is left as it was); churn and outages fold into the weights."""
    A, dev = fl.plan.n_agents, fl.n_per_agent.device
    if draws is not None and len(draws) != hp.lar:
        raise ValueError(f"want {hp.lar} injected draws, got {len(draws)}")
    conn, masks, acts = state.conn, [], []
    for i in range(hp.lar):
        if draws is None:
            conn, m, a = round_draws(state.gen, conn, het, hp, A, fl.spe)
        else:
            m, a = (t.to(dev) for t in draws[i])
        masks.append(m)
        acts.append(a)
    weights = fl.n_per_agent * torch.stack(masks).float()
    if fault_r is not None:
        weights = weights * (fault_r["agent_up"]
                             * fault_r["rsu_up"][:, fl.rsu_assign])
    return (conn, _pad(weights, fl.plan.pad),
            _pad(torch.stack(acts), fl.plan.pad))


# --------------------------------------------------------------------------
# the synchronous round
# --------------------------------------------------------------------------

class StreamSimState(NamedTuple):
    """A streamed synchronous round's state: the agent rows in a fleet
    store; the RSU rows, cloud master and connectivity on the device (the
    two-axis round keeps the RSU rows and cloud master in host memory,
    padded to its column tiles)."""
    store: Any                  # fleet store: (A, N) agent rows
    rsu_flat: torch.Tensor      # (R, N) storage dtype
    cloud_flat: torch.Tensor    # (N,)   fp32 master
    conn: ConnState
    gen: torch.Generator        # the round draws' generator


def _init_vec(spec: FlatSpec, init_params: Params, dev) -> torch.Tensor:
    return spec.ravel({k: v.to(dev) for k, v in init_params.items()})


def _generator(cfg: SimConfig, dev) -> torch.Generator:
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)
    return gen


def init_stream_state(cfg: SimConfig, spec: FlatSpec, init_params: Params,
                      device, *, fleet_store: str = "host") -> StreamSimState:
    dev = torch.device(device)
    vec = _init_vec(spec, init_params, dev)
    return StreamSimState(
        store=make_fleet_store(fleet_store, vec, cfg.n_agents,
                               spec.storage_dtype, device=dev),
        rsu_flat=spec.to_storage(vec).expand(cfg.n_rsus, spec.n).clone(),
        cloud_flat=vec, conn=init_conn_state(cfg.n_agents, dev),
        gen=_generator(cfg, dev))


def make_streamed_flat_round(cfg: SimConfig, hp: H2FedParams,
                             het: HeterogeneityModel, fed: FederatedData,
                             spec: FlatSpec, *, device,
                             chunk_agents: int = 0,
                             faults: Optional[faults_mod.FaultPlan] = None):
    """The streamed synchronous round: ``(state, draws=None) -> state``,
    or with ``faults`` ``(state, draws, fault_r) -> (state,
    {"quarantined"})``.  In this round agent rows are written only
    (training starts from the RSU rows), so the store is never read.
    ``.plan`` is the chunk plan and ``.link`` the copies' byte counts."""
    _refuse_corrupts(faults)
    dev = torch.device(device)
    R, N = cfg.n_rsus, spec.n
    fl = _fleet(cfg, hp, fed, chunk_agents, dev)
    plan, lanes = fl.plan, Lanes.of([hp], [het])
    guard = faults is not None and faults.guard_nonfinite
    link = _Link(dev)

    def global_round(state: StreamSimState, draws=None, fault_r=None):
        if (faults is None) != (fault_r is None):
            raise ValueError("fault_r is given exactly when the round was "
                             "built with a fault plan")
        store, cloud = state.store, state.cloud_flat
        conn, weights, steps = _flat_draws(state, het, hp, fl, draws,
                                           fault_r)
        # Alg. 2 l.2: RSUs re-anchor to the cloud model
        rsu = spec.to_storage(cloud).expand(R, N).clone()
        total_mass = torch.zeros(R, device=dev)
        n_quar = torch.zeros((), dtype=torch.long, device=dev)
        for i in range(hp.lar):
            num = torch.zeros((R, N), device=dev)
            mass = torch.zeros(R, device=dev)
            wb = _Writeback(link)
            nxt = link.upload(fl.chunks[0], plan.chunk)
            for c in range(plan.n_chunks):
                lo, valid = plan.bounds(c)
                x_c, y_c, a_c = link.take(nxt)
                if c + 1 < plan.n_chunks:
                    # chunk c+1's copy goes up while chunk c computes
                    nxt = link.upload(fl.chunks[c + 1], plan.chunk)
                a_c = a_c.long()
                sl = slice(c * plan.chunk, (c + 1) * plan.chunk)
                w_c = weights[i, sl]
                # Alg. 2 l.5 / Alg. 1 l.1: agents start from their RSU row
                w_start = rsu.index_select(0, a_c)
                stored = _train_chunk(spec, fl, lanes, cfg.batch, x_c, y_c,
                                      w_start, cloud, steps[i, sl])
                if guard:
                    # non-finite rows go back to their start at weight 0
                    stored, okf, nq = screen_updates(stored, w_start, w_c)
                    w_c = w_c * okf
                    n_quar = n_quar + nq
                # Alg. 2 l.8, the chunk added into the local round's sums
                ops.chunk_agg(stored, w_c, a_c, R, into=(num, mass))
                wb.push(lo, stored[:valid], [(store, None)])
            wb.flush()
            rsu = normalize_blend(num, mass, rsu)
            total_mass = total_mass + mass
        # Alg. 3 l.6: the cloud over the surviving mass
        cloud = ops.cloud_blend(rsu, total_mass, cloud)
        out = StreamSimState(store=store, rsu_flat=rsu, cloud_flat=cloud,
                             conn=conn, gen=state.gen)
        if faults is None:
            return out
        return out, {"quarantined": n_quar}

    global_round.plan = plan
    global_round.link = link
    return global_round


# --------------------------------------------------------------------------
# the semi-asynchronous round
# --------------------------------------------------------------------------

class AsyncStreamState(NamedTuple):
    """A streamed semi-async round's state: the latest local rows and the
    in-flight update rows in fleet stores; the (A,)-sized in-flight
    bookkeeping, the RSU buffers and the cloud on the device."""
    store: Any                  # fleet store: (A, N) latest local rows
    pending_store: Any          # fleet store: (A, N) in-flight update rows
    rsu_flat: torch.Tensor      # (R, N) storage dtype
    rsu_mass: torch.Tensor      # (R,)   running absorbed cohort mass
    cloud_flat: torch.Tensor    # (N,)   fp32 master
    pending_w: torch.Tensor     # (A,)   decayed delivery weight
    pending_t: torch.Tensor     # (A,)   ticks to delivery (0: none)
    conn: ConnState
    gen: torch.Generator
    cloud_macc: torch.Tensor    # (R,)   mass since the last cloud blend
    tick: int                   # global tick clock (the cloud cadence's)


def init_async_stream_state(cfg: SimConfig, spec: FlatSpec,
                            init_params: Params, device, *,
                            fleet_store: str = "host") -> AsyncStreamState:
    dev = torch.device(device)
    vec = _init_vec(spec, init_params, dev)
    a, r, n = cfg.n_agents, cfg.n_rsus, spec.n
    if resolve_fleet_store(fleet_store) == "host":
        pending = HostFleetStore.zeros(a, n, spec.storage_dtype,
                                       pin=dev.type == "cuda")
    else:
        pending = DeviceFleetStore.zeros(a, n, spec.storage_dtype,
                                         device=dev)
    return AsyncStreamState(
        store=make_fleet_store(fleet_store, vec, a, spec.storage_dtype,
                               device=dev),
        pending_store=pending,
        rsu_flat=spec.to_storage(vec).expand(r, n).clone(),
        rsu_mass=torch.zeros(r, device=dev), cloud_flat=vec,
        pending_w=torch.zeros(a, device=dev),
        pending_t=torch.zeros(a, dtype=torch.int32, device=dev),
        conn=init_conn_state(a, dev), gen=_generator(cfg, dev),
        cloud_macc=torch.zeros(r, device=dev), tick=0)


def make_streamed_async_round(cfg: SimConfig, hp: H2FedParams,
                              het: HeterogeneityModel, fed: FederatedData,
                              spec: FlatSpec,
                              acfg: Optional[AsyncConfig] = None, *, device,
                              chunk_agents: int = 0,
                              faults: Optional[faults_mod.FaultPlan] = None):
    """The streamed semi-async round: ``(state, draws=None, fault_r=None)
    -> (state, metrics)``, ``hp.lar`` ticks of the resident tick's algebra
    with the (A, N) work in chunks.  Each tick's (A,)-sized bookkeeping
    (busy, due, enqueue and their weights) runs first; each chunk trains
    its free agents and sums both arrival cohorts, the fresh rows and the
    due pending rows, with two ``ops.chunk_agg`` calls; the tick closes
    with ``buffer_absorb``.  Row-masked writebacks keep busy agents' rows
    and enqueue the new in-flight rows.  Metrics: ``absorbed_mass`` (lar,
    R) and ``pending_mass``, with a plan also ``quarantined``."""
    _refuse_corrupts(faults)
    acfg = (acfg or AsyncConfig()).validate()
    dev = torch.device(device)
    R, N = cfg.n_rsus, spec.n
    fl = _fleet(cfg, hp, fed, chunk_agents, dev)
    plan, lanes = fl.plan, Lanes.of([hp], [het])
    A = plan.n_agents
    guard = faults is not None and faults.guard_nonfinite
    decay = acfg.agent_decay(fl.rsu_assign, R)
    keep = acfg.rsu_keep(R, dev)
    ce = acfg.cloud_every
    link = _Link(dev)

    def draws_of(state, draws):
        """(conn', masks (lar, A) fp32, steps, delays): each tick's draws
        in the resident engine's order, or the injected triples."""
        if draws is not None and len(draws) != hp.lar:
            raise ValueError(f"want {hp.lar} injected draws, got "
                             f"{len(draws)}")
        conn, ticks = state.conn, []
        for i in range(hp.lar):
            if draws is None:
                conn, m, a = round_draws(state.gen, conn, het, hp, A, fl.spe)
                ticks.append((m, a, sample_latency(state.gen, A, het, dev)))
            else:
                ticks.append(tuple(t.to(dev) for t in draws[i]))
        masks, steps, delays = (torch.stack(t) for t in zip(*ticks))
        return conn, masks.float(), steps, delays

    def global_round(state: AsyncStreamState, draws=None, fault_r=None):
        if (faults is None) != (fault_r is None):
            raise ValueError("fault_r is given exactly when the round was "
                             "built with a fault plan")
        store, pstore = state.store, state.pending_store
        conn, masks, steps, delays = draws_of(state, draws)
        if faults is not None:
            # churn: gates training, immediate uploads and enqueues (due
            # deliveries left before the disconnect and still land)
            masks = masks * fault_r["agent_up"]
        cloud = state.cloud_flat
        if ce:
            # a decoupled cadence: buffers, masses and the accumulator
            # persist across rounds
            rsu, rsu_mass, macc = (state.rsu_flat, state.rsu_mass,
                                   state.cloud_macc)
        else:
            rsu = spec.to_storage(cloud).expand(R, N).clone()
            rsu_mass = torch.zeros(R, device=dev)
            macc = torch.zeros(R, device=dev)
        pend_w, pend_t, gtick = state.pending_w, state.pending_t, state.tick
        absorbed = []
        n_quar = torch.zeros((), dtype=torch.long, device=dev)
        for i in range(hp.lar):
            if faults is not None:
                # an RSU back from an outage rejoins at the cloud master
                ra = fault_r["reanchor"][i] > 0
                rsu = torch.where(ra[:, None], spec.to_storage(cloud), rsu)
                rsu_mass = torch.where(ra, 0.0, rsu_mass)
                macc = torch.where(ra, 0.0, macc)
            # the in-flight bookkeeping, in the resident tick's order: the
            # countdown, arrivals read the pre-enqueue weights, then the
            # enqueue overwrites them
            maskf = masks[i]
            in_flight = pend_t > 0
            pend_t = (pend_t - 1).clamp_min(0)
            due = in_flight & (pend_t == 0)
            free = ~(in_flight & ~due)
            act = torch.where(free, steps[i], torch.zeros_like(steps[i]))
            w_imm = (fl.n_per_agent * maskf * free
                     * (delays[i] == 0).float())
            w_due = torch.where(due, pend_w, 0.0)
            enq = (maskf > 0) & free & (delays[i] > 0)
            w_enq = fl.n_per_agent * maskf * acfg.weight(delays[i],
                                                         decay=decay)
            pend_w = torch.where(enq, w_enq, pend_w)
            pend_t = torch.where(enq, delays[i], pend_t)
            if faults is not None:
                # uploads to a dark RSU are dropped, both cohorts
                up_a = fault_r["rsu_up"][i][fl.rsu_assign]
                w_imm, w_due = w_imm * up_a, w_due * up_a
            act, w_imm, w_due = (_pad(t, plan.pad) for t in (act, w_imm,
                                                             w_due))
            # the writeback's row masks where the stores live
            free_m, enq_m = ((free.cpu(), enq.cpu()) if store.kind == "host"
                             else (free, enq))
            # each cohort's running sums (the resident tick sums the fresh
            # cohort, then the due one)
            sums = [(torch.zeros((R, N), device=dev),
                     torch.zeros(R, device=dev)) for _ in range(2)]
            wb = _Writeback(link)

            def parts(c):
                lo, valid = plan.bounds(c)
                return fl.chunks[c] + (pstore.gather(lo, lo + valid),)
            nxt = link.upload(parts(0), plan.chunk)
            for c in range(plan.n_chunks):
                lo, valid = plan.bounds(c)
                x_c, y_c, a_c, pend_rows = link.take(nxt)
                if c + 1 < plan.n_chunks:
                    nxt = link.upload(parts(c + 1), plan.chunk)
                a_c = a_c.long()
                sl = slice(c * plan.chunk, (c + 1) * plan.chunk)
                w_i, w_d = w_imm[sl], w_due[sl]
                w_start = rsu.index_select(0, a_c)
                trained = _train_chunk(spec, fl, lanes, cfg.batch, x_c, y_c,
                                       w_start, cloud, act[sl])
                if guard:
                    # both cohorts: fresh rows go back to their start, non-
                    # finite pending deliveries weigh nothing
                    trained, ok_t, nq_t = screen_updates(trained, w_start,
                                                         w_i)
                    _, ok_p, nq_p = screen_updates(pend_rows, pend_rows, w_d)
                    w_i, w_d = w_i * ok_t, w_d * ok_p
                    n_quar = n_quar + nq_t + nq_p
                ops.chunk_agg(trained, w_i, a_c, R, into=sums[0])
                ops.chunk_agg(pend_rows, w_d, a_c, R, into=sums[1])
                # free agents' rows update; enqueuing agents' rows go in
                # flight
                wb.push(lo, trained[:valid],
                        [(store, free_m[lo:lo + valid]),
                         (pstore, enq_m[lo:lo + valid])])
            wb.flush()
            (num_i, m_i), (num_d, m_d) = sums
            rsu, rsu_mass = buffer_absorb(rsu, rsu_mass, num_i + num_d,
                                          m_i + m_d, keep=keep)
            macc = macc + m_i + m_d
            absorbed.append(m_i + m_d)
            gtick += 1
            if ce and gtick % ce == 0:
                fire = macc if faults is None else macc * fault_r["rsu_up"][i]
                cloud = ops.cloud_blend(rsu, fire, cloud)
                macc = torch.zeros(R, device=dev)
        if not ce:
            end = (macc if faults is None
                   else macc * fault_r["rsu_up"][hp.lar - 1])
            cloud = ops.cloud_blend(rsu, end, cloud)
            macc = torch.zeros(R, device=dev)
        out = AsyncStreamState(
            store=store, pending_store=pstore, rsu_flat=rsu,
            rsu_mass=rsu_mass, cloud_flat=cloud, pending_w=pend_w,
            pending_t=pend_t, conn=conn, gen=state.gen, cloud_macc=macc,
            tick=gtick)
        metrics = {"absorbed_mass": torch.stack(absorbed),
                   "pending_mass": (pend_w * (pend_t > 0)).sum()}
        if faults is not None:
            metrics["quarantined"] = n_quar
        return out, metrics

    global_round.plan = plan
    global_round.link = link
    return global_round


# --------------------------------------------------------------------------
# the two-axis (agent x parameter) round
# --------------------------------------------------------------------------

def init_twoaxis_state(cfg: SimConfig, spec: FlatSpec, init_params: Params,
                       device, tiles: NTilePlan) -> StreamSimState:
    """Every N-wide buffer in host memory, padded to the column tiles: the
    agent rows in a host store (pinned on a card), the (R, N) RSU rows and
    the fp32 cloud master as host tensors."""
    dev = torch.device(device)
    vec = _pad(_init_vec(spec, init_params, "cpu"), tiles.pad)
    return StreamSimState(
        store=HostFleetStore.broadcast(vec, cfg.n_agents, spec.storage_dtype,
                                       pin=dev.type == "cuda"),
        rsu_flat=spec.to_storage(vec).expand(cfg.n_rsus, -1).clone(),
        cloud_flat=vec, conn=init_conn_state(cfg.n_agents, dev),
        gen=_generator(cfg, dev))


def make_streamed_twoaxis_round(cfg: SimConfig, hp: H2FedParams,
                                het: HeterogeneityModel, fed: FederatedData,
                                spec: FlatSpec, *, device,
                                chunk_agents: int = 0, chunk_params: int = 0,
                                faults: Optional[faults_mod.FaultPlan] = None):
    """The two-axis streamed synchronous round on an ``init_twoaxis_state``
    state, same signature as ``make_streamed_flat_round``.  The agent axis
    streams as in that round (same draws, chunk grid and writeback).
    Training needs a chunk's full rows (the gradient couples every
    parameter), so each chunk's RSU start rows are gathered on the host
    and go up whole; aggregation is independent column by column, so the
    chunk's numerator is summed tile by tile (``ops.chunk_agg`` on a
    (chunk, tile) slice) into a host (R, N) numerator, and the local-round
    close and the cloud blend run tile by tile ((R, tile) up, the blended
    tile down).  The device never holds an (R, N) buffer.  ``.tiles`` is
    the column plan."""
    _refuse_corrupts(faults)
    dev = torch.device(device)
    R = cfg.n_rsus
    fl = _fleet(cfg, hp, fed, chunk_agents, dev)
    plan, lanes = fl.plan, Lanes.of([hp], [het])
    tiles = make_ntile_plan(spec.n, chunk_params)
    guard = faults is not None and faults.guard_nonfinite
    link = _Link(dev)

    def global_round(state: StreamSimState, draws=None, fault_r=None):
        if (faults is None) != (fault_r is None):
            raise ValueError("fault_r is given exactly when the round was "
                             "built with a fault plan")
        store, cloud_host = state.store, state.cloud_flat
        conn, weights, steps = _flat_draws(state, het, hp, fl, draws,
                                           fault_r)
        # Alg. 2 l.2: the host RSU rows re-anchor to the cloud master
        rsu_host = torch.empty_like(state.rsu_flat)
        rsu_host.copy_(spec.to_storage(cloud_host).expand_as(rsu_host))
        cloud_dev = link.to_device(cloud_host)      # the training anchor
        total_mass = torch.zeros(R, device=dev)
        n_quar = torch.zeros((), dtype=torch.long, device=dev)
        for i in range(hp.lar):
            num_host = torch.zeros((R, tiles.n_padded))
            mass = torch.zeros(R, device=dev)
            wb = _Writeback(link)

            def parts(c):
                # the chunk's RSU start rows, gathered on the host (padded
                # agents read RSU 0 at weight 0)
                a = torch.from_numpy(fl.chunks[c][2]).long()
                return fl.chunks[c] + (rsu_host.index_select(0, a),)
            nxt = link.upload(parts(0), plan.chunk)
            for c in range(plan.n_chunks):
                lo, valid = plan.bounds(c)
                x_c, y_c, a_c, w_start = link.take(nxt)
                if c + 1 < plan.n_chunks:
                    nxt = link.upload(parts(c + 1), plan.chunk)
                a_c = a_c.long()
                sl = slice(c * plan.chunk, (c + 1) * plan.chunk)
                w_c = weights[i, sl]
                stored = _train_chunk(spec, fl, lanes, cfg.batch, x_c, y_c,
                                      w_start, cloud_dev, steps[i, sl])
                if guard:
                    stored, okf, nq = screen_updates(stored, w_start, w_c)
                    w_c = w_c * okf
                    n_quar = n_quar + nq
                # the (R, N) numerator is summed on the host, tile by tile
                # ((R, tile) down each); every tile's mass is the same
                # (tile 0's is kept)
                for t in range(tiles.n_tiles):
                    tlo, thi = tiles.bounds(t)
                    ops.chunk_agg(stored[:, tlo:thi].contiguous(), w_c, a_c,
                                  R, into=(num_host[:, tlo:thi],
                                           mass if t == 0 else
                                           torch.zeros_like(mass)))
                    link.bytes["d2h"] += link.cuda * R * (thi - tlo) * 4
                wb.push(lo, stored[:valid], [(store, None)])
            wb.flush()
            # the local round closes tile by tile
            for t in range(tiles.n_tiles):
                tlo, thi = tiles.bounds(t)
                rsu_host[:, tlo:thi] = link.to_host(normalize_blend(
                    link.to_device(num_host[:, tlo:thi]), mass,
                    link.to_device(rsu_host[:, tlo:thi])))
            total_mass = total_mass + mass
        # Alg. 3 l.6: the cloud blend, tile by tile
        cloud_host = cloud_host.clone()
        for t in range(tiles.n_tiles):
            tlo, thi = tiles.bounds(t)
            cloud_host[tlo:thi] = link.to_host(ops.cloud_blend(
                link.to_device(rsu_host[:, tlo:thi]), total_mass,
                link.to_device(cloud_host[tlo:thi])))
        out = StreamSimState(store=store, rsu_flat=rsu_host,
                             cloud_flat=cloud_host, conn=conn, gen=state.gen)
        if faults is None:
            return out
        return out, {"quarantined": n_quar}

    global_round.plan = plan
    global_round.tiles = tiles
    global_round.link = link
    return global_round


# --------------------------------------------------------------------------
# the entries
# --------------------------------------------------------------------------

def run_streamed_simulation(cfg: SimConfig, hp: H2FedParams,
                            het: HeterogeneityModel, fed: FederatedData,
                            init_params: Params, n_rounds: int, *,
                            device=None, engine: str = "flat",
                            acfg: Optional[AsyncConfig] = None,
                            fleet_store: str = "host",
                            chunk_agents: int = 0, chunk_params: int = 0,
                            x_test=None, y_test=None,
                            eval_fn: Optional[Callable[[Params],
                                                       float]] = None,
                            fleet_dtype=None,
                            faults: Optional[faults_mod.FaultPlan] = None,
                            draws: Optional[Sequence] = None,
                            ) -> Tuple[Any, Dict[str, np.ndarray]]:
    """The streamed rounds on hand-built arrays: ``n_rounds`` rounds with
    the fleet in a store, on ``device`` (``cuda`` when None).  History:
    ``round`` and ``acc``; async adds per-round ``absorbed_mass`` and
    ``pending_mass``; a plan adds ``quarantined``.  ``draws[r]`` injects
    round r's draws.  Returns the streamed state (``.store.snapshot()``
    is the whole fleet: an eval / test boundary for small A)."""
    hp.validate(), het.validate()
    dev = resolve_device(device)
    if engine not in ("flat", "async"):
        raise ValueError(f"engine {engine!r} does not stream (want 'flat' | "
                         f"'async')")
    if chunk_params and engine != "flat":
        raise ValueError(f"chunk_params={chunk_params} (two-axis streaming) "
                         f"runs the flat engine only, got {engine!r}")
    if draws is not None and len(draws) != n_rounds:
        raise ValueError(f"want draws for {n_rounds} rounds, got "
                         f"{len(draws)}")
    _refuse_corrupts(faults)
    spec = spec_of(init_params, storage_dtype=fleet_dtype)
    if eval_fn is None and x_test is not None:
        xt = torch.from_numpy(np.asarray(x_test)).to(dev)
        yt = torch.from_numpy(np.asarray(y_test)).to(dev, torch.long)
        eval_fn = lambda p: float(mlp.accuracy(p, xt, yt))  # noqa: E731

    if engine == "flat" and chunk_params > 0:
        tiles = make_ntile_plan(spec.n, chunk_params)
        state: Any = init_twoaxis_state(cfg, spec, init_params, dev, tiles)
        round_fn = make_streamed_twoaxis_round(
            cfg, hp, het, fed, spec, device=dev, chunk_agents=chunk_agents,
            chunk_params=chunk_params, faults=faults)
    elif engine == "flat":
        state = init_stream_state(cfg, spec, init_params, dev,
                                  fleet_store=fleet_store)
        round_fn = make_streamed_flat_round(cfg, hp, het, fed, spec,
                                            device=dev,
                                            chunk_agents=chunk_agents,
                                            faults=faults)
    else:
        state = init_async_stream_state(cfg, spec, init_params, dev,
                                        fleet_store=fleet_store)
        round_fn = make_streamed_async_round(cfg, hp, het, fed, spec, acfg,
                                             device=dev,
                                             chunk_agents=chunk_agents,
                                             faults=faults)
    sched = (None if faults is None else faults.validate(cfg.n_rsus).lower(
        cfg.n_agents, cfg.n_rsus, n_rounds * hp.lar))

    hist = {k: [] for k in ("round", "acc", "absorbed_mass", "pending_mass",
                            "quarantined")}
    for r in range(n_rounds):
        fr = (None if sched is None
              else faults_mod.round_tensors(sched, r, hp.lar, dev))
        out = round_fn(state, None if draws is None else draws[r], fr)
        if engine == "async":
            state, metrics = out
            hist["absorbed_mass"].append(float(metrics["absorbed_mass"].sum()))
            hist["pending_mass"].append(float(metrics["pending_mass"]))
        elif sched is not None:
            state, metrics = out
        else:
            state = out
        if sched is not None:
            hist["quarantined"].append(int(metrics["quarantined"]))
        if eval_fn is not None and (r % cfg.eval_every == 0
                                    or r == n_rounds - 1):
            cloud = state.cloud_flat[:spec.n].to(dev)
            hist["acc"].append(float(eval_fn(spec.unravel(cloud))))
            hist["round"].append(r + 1)
    if engine != "async":
        del hist["absorbed_mass"], hist["pending_mass"]
    if sched is None:
        del hist["quarantined"]
    return state, {k: np.asarray(v) for k, v in hist.items()}


def _run_streamed(res, init_params: Params, *, device,
                  eval_fn: Optional[Callable[[Params], float]] = None,
                  draws: Optional[Sequence] = None):
    """``run_scenario``'s streamed target: a ResolvedScenario in, the
    streamed state and ``run_scenario``'s history out."""
    s = res.spec
    test = res.test
    return run_streamed_simulation(
        res.cfg, s.hp, s.het, res.fed, init_params, s.rounds, device=device,
        engine=s.engine,
        acfg=async_config(s) if s.engine == "async" else None,
        fleet_store=s.fleet_store, chunk_agents=s.chunk_agents,
        chunk_params=s.chunk_params,
        x_test=None if test is None else test.x,
        y_test=None if test is None else test.y,
        eval_fn=eval_fn, fleet_dtype=s.fleet_dtype, faults=s.faults,
        draws=draws)
