"""Heterogeneity model (paper Sec. III, Tab. I): CSR, SCD, FSR, LAR.

Connectivity is a per-round process: an agent that (re)connects stays
connected for SCD rounds, then re-draws with probability CSR.  FSR draws
how many of the requested E local epochs each agent completes (0 epochs
counts as disconnected).  The async engine also draws each update's
arrival latency in ticks (``sample_latency``).  Every draw takes a ``torch.Generator``; the
numbers differ from the JAX package's threefry draws, so the two packages
agree on these draws in distribution, not bitwise.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class HeterogeneityModel:
    csr: float = 1.0       # Connection Success Ratio  in [0, 1]
    scd: int = 1           # Stable Connection Duration (rounds)
    fsr: float = 1.0       # Full-task Success Ratio   in [0, 1]
    lar: int = 1           # Local Aggregation Rounds (per RSU, paper <= 50)
    max_delay: int = 0     # arrival-latency bound in ticks (async engine)
    delay_p: float = 0.0   # geometric tail of the latency draw in [0, 1]

    def validate(self) -> "HeterogeneityModel":
        if not (0.0 <= self.csr <= 1.0 and 0.0 <= self.fsr <= 1.0):
            raise ValueError(f"csr/fsr must lie in [0, 1], got "
                             f"{self.csr}/{self.fsr}")
        if self.scd < 1 or self.lar < 1:
            raise ValueError("scd and lar must be >= 1")
        if self.max_delay < 0 or not 0.0 <= self.delay_p <= 1.0:
            raise ValueError("max_delay must be >= 0, delay_p in [0, 1]")
        return self


@dataclasses.dataclass
class ConnState:
    """Per-agent connection countdown: >0 connected, 0 disconnected."""
    remaining: torch.Tensor    # (A,) int32


def init_conn_state(n_agents: int, device=None) -> ConnState:
    return ConnState(remaining=torch.zeros(n_agents, dtype=torch.int32,
                                           device=device))


def step_connectivity(gen: torch.Generator, state: ConnState,
                      het: HeterogeneityModel,
                      ) -> Tuple[ConnState, torch.Tensor]:
    """Advance one round.  Returns (new state, connected mask (A,) bool)."""
    rem = (state.remaining - 1).clamp_min(0)
    need_draw = rem == 0
    draw = torch.rand(rem.shape, generator=gen, device=rem.device) < het.csr
    rem = torch.where(need_draw & draw, torch.full_like(rem, het.scd), rem)
    return ConnState(remaining=rem), rem > 0


def sample_epochs(gen: torch.Generator, n_agents: int,
                  het: HeterogeneityModel, requested_e: int,
                  device=None) -> torch.Tensor:
    """FSR draw: epochs completed per agent (0 == counts as disconnected)."""
    full = torch.rand(n_agents, generator=gen, device=device) < het.fsr
    partial = torch.randint(0, max(requested_e, 1), (n_agents,),
                            generator=gen, device=device, dtype=torch.int32)
    return torch.where(full, torch.full_like(partial, requested_e), partial)


def sample_latency(gen: torch.Generator, n_agents: int,
                   het: HeterogeneityModel, device=None) -> torch.Tensor:
    """Arrival latency per agent in ticks, a censored geometric:
    P(d) = (1-p) p**d below ``max_delay``, the tail mass p**max_delay on
    ``max_delay`` (inverse CDF, then clip), so P(d = 0) == 1 - p.
    ``max_delay == 0`` or ``delay_p <= 0`` gives zeros and ``delay_p >= 1``
    gives ``max_delay`` everywhere; neither draws from ``gen``."""
    p = het.delay_p
    if het.max_delay == 0 or p <= 0.0:
        return torch.zeros(n_agents, dtype=torch.int32, device=device)
    if p >= 1.0:
        return torch.full((n_agents,), het.max_delay, dtype=torch.int32,
                          device=device)
    u = torch.rand(n_agents, generator=gen, device=device)
    u = u * (1.0 - 1e-7) + 1e-7                  # in [1e-7, 1)
    d = torch.floor(torch.log(u) / torch.log(torch.tensor(
        p, dtype=torch.float32, device=device)))
    return d.clamp(0, het.max_delay).to(torch.int32)
