"""H2-Fed framework parameters (paper Eq. 4/6): dual proximal terms, one
per aggregation layer,

    min_w  F(w) + (mu1/2)||w - w_rsu||^2 + (mu2/2)||w - w_cloud||^2

The penalty's gradient enters the SGD step in closed form (the
``dual_proximal_sgd`` kernel), so no penalty function is needed here.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class H2FedParams:
    """Framework parameter set M_k = {mu_{k,l}} plus cadence knobs."""
    mu1: float = 0.01      # agent->RSU proximal weight (layer l=1)
    mu2: float = 0.005     # agent->cloud proximal weight (layer l=2)
    lar: int = 5           # Local Aggregation Rounds per global round
    local_epochs: int = 1  # E: local training epochs per agent per LAR
    lr: float = 0.05       # agent SGD learning rate
    n_layers: int = 2      # L: aggregation layers (2 = RSU + cloud)

    def validate(self) -> "H2FedParams":
        if self.mu1 < 0 or self.mu2 < 0:
            raise ValueError(f"mu1/mu2 must be >= 0, got {self.mu1}/{self.mu2}")
        if self.lar < 1 or self.local_epochs < 1:
            raise ValueError("lar and local_epochs must be >= 1")
        if self.n_layers not in (1, 2):
            raise ValueError(f"n_layers must be 1 or 2, got {self.n_layers}")
        return self
