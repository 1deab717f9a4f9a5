"""Dynamic parameter orchestration (``repro/core/orchestrator.py``): the
paper's stated future work, re-tuning the proximal weights each global
round from the observed connectivity (the surviving data mass the cloud
aggregation saw) instead of a CSR known in advance.

  * low observed CSR  -> raise mu2 (stability: few, noisy cohorts)
  * high observed CSR -> decay mu2 toward mu2_min (don't slow convergence)
  * mu1 follows the same signal.

Pure functions of Python floats, so every value is the reference's bit
for bit.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

from repro_torch.core.h2fed import H2FedParams


@dataclasses.dataclass(frozen=True)
class AdaptiveMuConfig:
    mu1_min: float = 0.0
    mu1_max: float = 0.004
    mu2_min: float = 0.0
    mu2_max: float = 0.02
    # EMA over the observed per-round CSR; 0.3 reacts within ~2 rounds
    ema: float = 0.3
    # CSR at/above which the mus decay to their minima
    csr_good: float = 0.8
    # CSR at/below which the mus saturate at their maxima
    csr_bad: float = 0.1


class AdaptiveMuState(NamedTuple):
    csr_est: float          # EMA of the observed connection success ratio


def init_state() -> AdaptiveMuState:
    return AdaptiveMuState(csr_est=1.0)


def observe_csr(state: AdaptiveMuState, cfg: AdaptiveMuConfig,
                connected: float, participants: float) -> AdaptiveMuState:
    """Update the estimate from one round's observation (agent counts or
    data masses: the ratio is what matters)."""
    csr = connected / max(participants, 1e-9)
    csr = min(max(csr, 0.0), 1.0)
    return AdaptiveMuState(csr_est=cfg.ema * state.csr_est
                           + (1.0 - cfg.ema) * csr)


def schedule(state: AdaptiveMuState, cfg: AdaptiveMuConfig,
             base: H2FedParams) -> Tuple[H2FedParams, float]:
    """(mu1, mu2) from the estimate: linear between csr_good (minima) and
    csr_bad (maxima), clamped outside.  Returns (params, badness)."""
    span = max(cfg.csr_good - cfg.csr_bad, 1e-9)
    badness = min(max((cfg.csr_good - state.csr_est) / span, 0.0), 1.0)
    mu1 = cfg.mu1_min + badness * (cfg.mu1_max - cfg.mu1_min)
    mu2 = cfg.mu2_min + badness * (cfg.mu2_max - cfg.mu2_min)
    return dataclasses.replace(base, mu1=mu1, mu2=mu2), badness
