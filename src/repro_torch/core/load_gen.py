"""Seeded event-stream load generators for the serving loop: the port's
copy of the JAX package's ``core/load_gen``, numpy only.

The continuous-serving subsystem (``fedsim/serving``) is driven by *events*
— "agent ``a``'s update is ready at sim-time ``t``" — instead of a round
counter.  This module owns the event side:

  * ``Event``: one arrival — ``(t, agent, seq)`` with ``t`` on a MONOTONIC
    float64 simulation clock.  No wall-clock ever enters the schedule, so a
    seeded run is a pure function of ``(rates, seed, n_events)`` and a trace
    replay reproduces it bit-for-bit (the determinism seam, test-pinned in
    tests/test_torch_serving.py).
  * ``agent_rates``: per-agent Poisson rates derived from the
    ``HeterogeneityModel`` — the latency model that the semi-async engine
    spends on its in-flight buffers moves INTO the workload here: an
    agent's censored-geometric latency class ``d`` (the same draw shape as
    ``heterogeneity.sample_latency``) becomes a persistent speed factor
    ``1 / (1 + d)`` on its arrival rate, and CSR × FSR scale the rate of
    *useful* updates.
  * ``PoissonLoadGen``: merges per-agent exponential inter-arrival streams
    into one time-ordered event stream.  Each agent draws from its OWN
    ``numpy`` Generator (seeded ``[seed, agent]``), so an agent's arrival
    times are independent of how the merge interleaves them.
  * ``TraceLoadGen`` + ``write_trace`` / ``read_trace``: replayable JSONL
    traces.  Python's ``json`` serializes float64 via ``repr`` round-trip,
    so a dumped Poisson schedule reloads with every timestamp bit-equal.
  * ``parse_trigger``: the tick-trigger grammar of the serving loop —
    ``"batch:K"`` (fire on queue depth), ``"deadline:W"`` (fire before an
    event would leave the oldest queued entry waiting longer than ``W``
    sim-time units), ``"batch:K,deadline:W"`` (either), or ``"auto"``
    (``batch:n_agents`` — one tick per fleet's worth of arrivals, the
    batch↔serving anchor cadence).

Everything here is numpy only (no torch): the generator runs on the host
thread interleaved with device ticks and never touches device state.  The
seeds are the JAX package's (``[seed, 0x10AD]`` for the rates, ``[seed,
agent]`` for each stream), so both packages produce the same rates, event
streams and traces bit for bit (tests/test_torch_load_gen.py).
"""
from __future__ import annotations

import heapq
import json
from typing import Iterable, Iterator, List, NamedTuple, Optional, Sequence

import numpy as np

from repro_torch.core.heterogeneity import HeterogeneityModel


class Event(NamedTuple):
    """One arrival on the simulated clock."""
    t: float        # monotonic float64 sim-time of the arrival
    agent: int      # which agent's update is ready
    seq: int        # global emission index (identity + tie-break)


class TickTrigger(NamedTuple):
    """Parsed tick-trigger: fire when EITHER bound is hit (0 = disabled)."""
    batch: int       # queue depth >= batch  (0 = no depth trigger)
    deadline: float  # oldest queued event would wait > deadline sim-time

    def validate(self) -> "TickTrigger":
        if self.batch < 0 or self.deadline < 0:
            raise ValueError(f"negative trigger bound: {self}")
        if not self.batch and not self.deadline:
            raise ValueError("tick trigger needs batch>0 or deadline>0 "
                             "(else ticks never fire)")
        return self


def parse_trigger(s: str, n_agents: int) -> TickTrigger:
    """``"auto" | "batch:K" | "deadline:W" | "batch:K,deadline:W"``."""
    if s == "auto":
        return TickTrigger(batch=int(n_agents), deadline=0.0).validate()
    batch, deadline = 0, 0.0
    for part in s.split(","):
        kind, _, val = part.partition(":")
        try:
            if kind == "batch":
                batch = int(val)
            elif kind == "deadline":
                deadline = float(val)
            else:
                raise ValueError
        except ValueError:
            raise ValueError(
                f"bad tick_trigger {s!r} (want 'auto', 'batch:K', "
                f"'deadline:W' or 'batch:K,deadline:W')") from None
    return TickTrigger(batch=batch, deadline=deadline).validate()


def agent_rates(het: HeterogeneityModel, n_agents: int,
                base_rate: float = 1.0, seed: int = 0) -> np.ndarray:
    """Per-agent mean arrival rates (events per sim-time unit ==
    per tick window), derived from the heterogeneity model.

    ``rate_a = base · csr · fsr · 1/(1 + d_a)`` with ``d_a`` a per-agent
    censored-geometric latency-class draw (same distribution shape as
    ``sample_latency``, but drawn ONCE per agent: a persistent speed
    class, not a per-tick delay).  Rates are floored at 5% of ``base`` so
    every agent eventually reports even at csr→0 (the generator must stay
    live; a zero-rate agent would stall its stream forever).
    """
    het.validate()
    if base_rate <= 0:
        raise ValueError(f"base_rate must be > 0, got {base_rate}")
    rng = np.random.default_rng([int(seed), 0x10AD])
    if het.max_delay and het.delay_p > 0:
        if het.delay_p >= 1.0:
            d = np.full(n_agents, het.max_delay, np.float64)
        else:
            u = rng.uniform(1e-7, 1.0, n_agents)
            d = np.clip(np.floor(np.log(u) / np.log(het.delay_p)),
                        0, het.max_delay)
    else:
        d = np.zeros(n_agents, np.float64)
    rate = base_rate * het.csr * het.fsr / (1.0 + d)
    return np.maximum(rate, 0.05 * base_rate)


class PoissonLoadGen:
    """Merged per-agent Poisson arrival streams, time-ordered, seeded.

    Each agent owns an independent ``default_rng([seed, agent])`` stream of
    exponential inter-arrival gaps, merged through a heap — so the merged
    order can never perturb any agent's own draw sequence, and the whole
    schedule is a pure function of ``(rates, seed, n_events)``.
    """

    def __init__(self, rates: Sequence[float], seed: int = 0,
                 n_events: Optional[int] = None):
        self.rates = np.asarray(rates, np.float64)
        if (self.rates <= 0).any():
            raise ValueError("all arrival rates must be > 0 "
                             "(see agent_rates' floor)")
        self.seed = int(seed)
        self.n_events = n_events

    def events(self) -> Iterator[Event]:
        rngs = [np.random.default_rng([self.seed, a])
                for a in range(len(self.rates))]
        heap = [(rngs[a].exponential(1.0 / self.rates[a]), a)
                for a in range(len(self.rates))]
        heapq.heapify(heap)
        seq = 0
        while self.n_events is None or seq < self.n_events:
            t, a = heapq.heappop(heap)
            yield Event(t=float(t), agent=a, seq=seq)
            seq += 1
            heapq.heappush(
                heap, (t + rngs[a].exponential(1.0 / self.rates[a]), a))

    def take(self, n: int) -> List[Event]:
        out = []
        for ev in self.events():
            out.append(ev)
            if len(out) >= n:
                break
        return out


class TraceLoadGen:
    """Replay a fixed event schedule (a list or a JSONL trace file)."""

    def __init__(self, events: Iterable[Event]):
        self._events = [Event(float(t), int(a), i)
                        for i, (t, a, *_) in enumerate(events)]
        ts = [e.t for e in self._events]
        if any(b < a for a, b in zip(ts, ts[1:])):
            raise ValueError("trace timestamps must be non-decreasing "
                             "(the monotonic event clock)")

    @classmethod
    def from_jsonl(cls, path, limit: int = 0,
                   n_agents: Optional[int] = None) -> "TraceLoadGen":
        return cls(read_trace(path, limit=limit, n_agents=n_agents))

    def events(self) -> Iterator[Event]:
        return iter(self._events)

    def take(self, n: int) -> List[Event]:
        return self._events[:n]

    def __len__(self) -> int:
        return len(self._events)


def every_agent_once_trace(n_agents: int, n_windows: int) -> TraceLoadGen:
    """The batch↔serving anchor schedule: every agent arrives exactly once
    per unit tick window, in agent order — ``t = w + (a + 0.5) / A``.  With
    trigger ``batch:A`` this fires exactly one full-fleet tick per window,
    every absorption at age 0 (tests/test_torch_serving.py pins the
    equivalence to ``engine="async"``)."""
    return TraceLoadGen([
        Event(t=w + (a + 0.5) / n_agents, agent=a, seq=w * n_agents + a)
        for w in range(n_windows) for a in range(n_agents)])


def write_trace(events: Iterable[Event], path) -> None:
    """JSONL, one ``{"t": ..., "agent": ...}`` per line.  ``json`` emits
    float64 via ``repr`` — re-reading yields bit-equal timestamps, the
    replay-determinism seam."""
    with open(path, "w") as f:
        for ev in events:
            f.write(json.dumps({"t": ev.t, "agent": ev.agent}) + "\n")


def read_trace(path, limit: int = 0,
               n_agents: Optional[int] = None) -> List[Event]:
    """Read a JSONL trace, validating every record as it is parsed.

    A trace is external input (often hand-edited or produced by another
    tool), so malformed records fail loudly HERE with the 1-based line
    number — not ticks later as a NaN sim-clock or a device-side scatter
    out of bounds.  Rejected: unparseable JSON, missing ``t``/``agent``
    keys, non-finite timestamps, negative agent ids, and (when
    ``n_agents`` is given) agents outside the fleet.
    """
    out: List[Event] = []
    with open(path) as f:
        for i, line in enumerate(f):
            if not line.strip():
                continue
            where = f"{path}:{i + 1}"
            try:
                d = json.loads(line)
                t, agent = float(d["t"]), int(d["agent"])
            except (ValueError, KeyError, TypeError) as e:
                raise ValueError(f"bad trace record at {where}: {e}") from None
            if not np.isfinite(t):
                raise ValueError(
                    f"non-finite timestamp {t!r} at {where} — the event "
                    f"clock must stay finite and monotonic")
            if agent < 0 or (n_agents is not None and agent >= n_agents):
                bound = f"[0, {n_agents})" if n_agents is not None else ">= 0"
                raise ValueError(
                    f"agent id {agent} at {where} outside the fleet "
                    f"(want {bound}) — trace from a different scenario?")
            out.append(Event(t=t, agent=agent, seq=i))
            if limit and len(out) >= limit:
                break
    return out
