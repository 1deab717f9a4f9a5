"""Baselines as H2-Fed parameterizations (paper Sec. V):

  (i)   mu_{k,l}=0, L=1  -> FedAvg   [McMahan et al. 2017]
  (ii)  mu_{k,l}>0, L=1  -> FedProx  [Li et al. 2020]
  (iii) mu_{k,l}=0, L>1  -> HierFAVG [Liu et al. 2020]
"""
from __future__ import annotations

from repro_torch.core.h2fed import H2FedParams


def fedavg(lr: float = 0.05, local_epochs: int = 1) -> H2FedParams:
    """FedAvg: no proximal terms, single aggregation layer (LAR=1)."""
    return H2FedParams(mu1=0.0, mu2=0.0, lar=1, local_epochs=local_epochs,
                       lr=lr, n_layers=1).validate()


def fedprox(mu: float = 0.01, lr: float = 0.05,
            local_epochs: int = 1) -> H2FedParams:
    """FedProx: single proximal term toward the single-layer global model."""
    return H2FedParams(mu1=mu, mu2=0.0, lar=1, local_epochs=local_epochs,
                       lr=lr, n_layers=1).validate()


def hierfavg(lar: int = 5, lr: float = 0.05,
             local_epochs: int = 1) -> H2FedParams:
    """HierFAVG: hierarchical aggregation, no proximal stabilization."""
    return H2FedParams(mu1=0.0, mu2=0.0, lar=lar, local_epochs=local_epochs,
                       lr=lr, n_layers=2).validate()


def h2fed(mu1: float = 0.01, mu2: float = 0.005, lar: int = 5,
          lr: float = 0.05, local_epochs: int = 1) -> H2FedParams:
    """The paper's framework with both proximal layers active."""
    return H2FedParams(mu1=mu1, mu2=mu2, lar=lar, local_epochs=local_epochs,
                       lr=lr, n_layers=2).validate()


BASELINES = {"fedavg": fedavg, "fedprox": fedprox, "hierfavg": hierfavg,
             "h2fed": h2fed}
