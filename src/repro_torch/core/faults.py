"""Deterministic fault injection: the port's ``FaultPlan``.

A :class:`FaultPlan` is a declarative, seeded schedule of faults for one
scenario: per-agent churn windows (hard disconnects beyond the latency
model), whole-RSU outages, corrupted updates (NaN/Inf payloads, scaled
byzantine payloads, replayed stale rows) and event-queue perturbations
for the serve loop (duplicate admissions, clock skew).  Plans hash into
``ScenarioSpec.cache_key``.  :meth:`FaultPlan.lower` turns a plan into a
:class:`FaultSchedule` of per-tick numpy masks (numpy's ``default_rng``
with the JAX package's seeds, so both packages lower a plan to the same
arrays bit for bit); the engines take each round's slice as tensors.

The benign lowering is a no-op bit for bit: every fold the engines apply
is ``w * 1.0``, ``mask & True`` or ``where(False, x, y)``, so an empty plan
leaves each engine's result equal to ``faults=None``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "ChurnWindow", "RsuOutage", "CorruptSpec", "FaultPlan",
    "FaultSchedule", "FAULT_FIELDS", "apply_corruption",
    "skewed_time", "duplicate_count",
]

_CORRUPT_KINDS = ("nan", "inf", "scale", "stale")


@dataclasses.dataclass(frozen=True)
class ChurnWindow:
    """A seeded fraction of the fleet is hard-disconnected for ticks
    ``[start, stop)`` (``stop <= 0``: never reconnects); which agents is a
    seeded draw without replacement."""
    frac: float
    start: int = 0
    stop: int = 0
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class RsuOutage:
    """RSU ``rsu`` is unreachable for ticks ``[start, stop)``: uploads to
    it are dropped, its buffer ages under ``buffer_keep``, it is left out
    of cloud aggregation, and on the recovery tick it re-anchors to the
    cloud master (``stop <= 0``: dark for good, no re-anchor)."""
    rsu: int
    start: int = 0
    stop: int = 0


@dataclasses.dataclass(frozen=True)
class CorruptSpec:
    """Each tick of ``[start, stop)`` an independent seeded ``frac`` of the
    agents submits a corrupted payload: ``nan`` / ``inf`` fill it (caught
    by ``guard_nonfinite``), ``scale`` multiplies it by ``scale`` (caught
    by ``norm_clip``), ``stale`` replays the agent's previous row."""
    kind: str
    frac: float
    start: int = 0
    stop: int = 0
    scale: float = 10.0
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Fault schedules plus the quarantine gate's configuration.

    ``churn`` / ``outages`` / ``corrupt`` lower to per-tick masks;
    ``dup_frac`` / ``clock_skew`` perturb the serve loop's event queue;
    ``guard_nonfinite`` and ``norm_clip`` configure ``screen_updates``."""
    churn: Tuple[ChurnWindow, ...] = ()
    outages: Tuple[RsuOutage, ...] = ()
    corrupt: Tuple[CorruptSpec, ...] = ()
    dup_frac: float = 0.0
    clock_skew: float = 0.0
    guard_nonfinite: bool = True
    norm_clip: float = 0.0
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "churn", tuple(
            c if isinstance(c, ChurnWindow) else ChurnWindow(**dict(c))
            for c in self.churn))
        object.__setattr__(self, "outages", tuple(
            o if isinstance(o, RsuOutage) else RsuOutage(**dict(o))
            for o in self.outages))
        object.__setattr__(self, "corrupt", tuple(
            c if isinstance(c, CorruptSpec) else CorruptSpec(**dict(c))
            for c in self.corrupt))

    def validate(self, n_rsus: Optional[int] = None) -> "FaultPlan":
        for w in self.churn:
            _check(0.0 <= w.frac <= 1.0, f"churn frac {w.frac} not in [0,1]")
            _check(w.start >= 0, "churn start must be >= 0")
        for o in self.outages:
            _check(o.rsu >= 0, "outage rsu must be >= 0")
            if n_rsus is not None:
                _check(o.rsu < n_rsus,
                       f"outage rsu {o.rsu} outside fleet of {n_rsus} RSUs")
            _check(o.start >= 0, "outage start must be >= 0")
        for c in self.corrupt:
            _check(c.kind in _CORRUPT_KINDS,
                   f"corrupt kind {c.kind!r} not in {_CORRUPT_KINDS}")
            _check(0.0 <= c.frac <= 1.0, f"corrupt frac {c.frac} not in [0,1]")
        _check(0.0 <= self.dup_frac < 1.0, "dup_frac must be in [0, 1)")
        _check(self.clock_skew >= 0.0, "clock_skew must be >= 0")
        _check(self.norm_clip >= 0.0, "norm_clip must be >= 0")
        return self

    @property
    def static_fingerprint(self) -> tuple:
        """The guard's configuration, the only part of a plan that shapes
        the round's code; the schedules are data."""
        return (bool(self.guard_nonfinite), float(self.norm_clip))

    @property
    def injects(self) -> bool:
        return bool(self.churn or self.outages or self.corrupt)

    @property
    def corrupts(self) -> bool:
        return bool(self.corrupt)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        d = dict(d)
        d["churn"] = tuple(ChurnWindow(**dict(c)) for c in d.get("churn", ()))
        d["outages"] = tuple(RsuOutage(**dict(o))
                             for o in d.get("outages", ()))
        d["corrupt"] = tuple(CorruptSpec(**dict(c))
                             for c in d.get("corrupt", ()))
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown FaultPlan fields: {sorted(unknown)}")
        return cls(**d)

    def lower(self, n_agents: int, n_rsus: int,
              n_ticks: int) -> "FaultSchedule":
        """Per-tick masks over a global clock of ``n_ticks`` ticks (rounds
        x lar for the round engines); ticks past the end clip to the last
        row."""
        A, R, T = int(n_agents), int(n_rsus), max(1, int(n_ticks))
        agent_up = np.ones((T, A), np.float32)
        rsu_up = np.ones((T, R), np.float32)
        reanchor = np.zeros((T, R), np.float32)
        poison_mask = np.zeros((T, A), np.float32)
        poison_val = np.zeros((T, A), np.float32)
        scale = np.ones((T, A), np.float32)
        stale = np.zeros((T, A), np.float32)
        for wi, w in enumerate(self.churn):
            k = int(round(w.frac * A))
            rng = np.random.default_rng([self.seed, w.seed, wi, 0xC4])
            idx = rng.choice(A, size=min(k, A), replace=False)
            stop = w.stop if w.stop > 0 else T
            agent_up[w.start:stop, idx] = 0.0
        for o in self.outages:
            if o.rsu >= R:
                continue
            stop = o.stop if o.stop > 0 else T
            rsu_up[o.start:stop, o.rsu] = 0.0
            if o.start < stop < T:
                reanchor[stop, o.rsu] = 1.0
        for ci, c in enumerate(self.corrupt):
            stop = c.stop if c.stop > 0 else T
            fill = np.float32("nan") if c.kind == "nan" else np.float32("inf")
            for t in range(max(0, c.start), min(stop, T)):
                rng = np.random.default_rng([self.seed, c.seed, ci, t])
                hit = rng.random(A) < c.frac
                if c.kind in ("nan", "inf"):
                    poison_mask[t, hit] = 1.0
                    poison_val[t, hit] = fill
                elif c.kind == "scale":
                    scale[t, hit] = np.float32(c.scale)
                else:  # stale replay
                    stale[t, hit] = 1.0
        return FaultSchedule(agent_up, rsu_up, reanchor, poison_mask,
                             poison_val, scale, stale)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


# the schedule's fields in their canonical order
FAULT_FIELDS = ("agent_up", "rsu_up", "reanchor", "poison_mask",
                "poison_val", "scale", "stale")


class FaultSchedule(NamedTuple):
    """Lowered per-tick masks: (T, A) float32 agent-side and (T, R)
    float32 RSU-side arrays.  Benign: ones for up/scale, zeros for
    reanchor/poison/stale."""
    agent_up: np.ndarray     # (T, A)  1 = connected
    rsu_up: np.ndarray       # (T, R)  1 = reachable
    reanchor: np.ndarray     # (T, R)  1 = re-anchor to the cloud this tick
    poison_mask: np.ndarray  # (T, A)  1 = payload replaced by poison_val
    poison_val: np.ndarray   # (T, A)  NaN/Inf fill value
    scale: np.ndarray        # (T, A)  payload multiplier (1 = benign)
    stale: np.ndarray        # (T, A)  1 = replay the previous row

    @classmethod
    def benign(cls, n_agents: int, n_rsus: int,
               n_ticks: int) -> "FaultSchedule":
        return FaultPlan().lower(n_agents, n_rsus, n_ticks)

    @property
    def n_ticks(self) -> int:
        return self.agent_up.shape[0]

    def tick_slice(self, t: int) -> dict:
        """Per-tick (A,)/(R,) masks; ticks past the end clip."""
        t = min(int(t), self.n_ticks - 1)
        return {k: getattr(self, k)[t] for k in FAULT_FIELDS}

    def round_slice(self, r: int, lar: int) -> dict:
        """Round r's (lar, A)/(lar, R) stacks; rows past the end clip."""
        idx = np.minimum(np.arange(r * lar, (r + 1) * lar),
                         self.n_ticks - 1)
        return {k: getattr(self, k)[idx] for k in FAULT_FIELDS}

    def stacked_rounds(self, rounds: int, lar: int) -> dict:
        """Every round at once: (rounds, lar, .) arrays."""
        return {k: np.stack([self.round_slice(r, lar)[k]
                             for r in range(rounds)])
                for k in FAULT_FIELDS}


def round_tensors(sched: FaultSchedule, r: int, lar: int, device) -> dict:
    """Round r's slice of ``sched`` as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device)
            for k, v in sched.round_slice(r, lar).items()}


def apply_corruption(trained: torch.Tensor, prev_rows: torch.Tensor,
                     f: dict) -> torch.Tensor:
    """Corrupt freshly trained (A, N) rows by one tick's masks ``f``:
    scale, then poison fill, then stale replay of ``prev_rows``.  Benign
    masks leave ``trained`` bit for bit."""
    dt = trained.dtype
    out = trained * f["scale"][:, None].to(dt)
    out = torch.where(f["poison_mask"][:, None] > 0,
                      f["poison_val"][:, None].to(dt), out)
    return torch.where(f["stale"][:, None] > 0, prev_rows.to(dt), out)


# -- serve-loop queue perturbations (host side, seeded per event) ---------

def skewed_time(plan: FaultPlan, loop_seed: int, seq: int,
                t: float) -> float:
    """Clock-skewed admission time for event ``seq``, seeded per event so
    a resumed loop replays the same skew."""
    if plan.clock_skew <= 0.0:
        return t
    rng = np.random.default_rng([plan.seed, loop_seed, int(seq), 0x5E])
    return float(t + rng.normal(0.0, plan.clock_skew))


def duplicate_count(plan: FaultPlan, loop_seed: int, seq: int) -> int:
    """Duplicate admissions of event ``seq`` (0 or 1), seeded per event."""
    if plan.dup_frac <= 0.0:
        return 0
    rng = np.random.default_rng([plan.seed, loop_seed, int(seq), 0xD0])
    return int(rng.random() < plan.dup_frac)
