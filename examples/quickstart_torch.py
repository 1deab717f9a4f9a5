"""Quickstart on the PyTorch port: enhance a biased pre-trained model with
H²-Fed on one NVIDIA GPU.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cuda]
                                                       [--rounds 10]

The same experiment as ``examples/quickstart.py``, through
``repro_torch``: ONE declarative ``ScenarioSpec`` (a synthetic 10-class
task, an OEM pre-training pool with labels {7,8,9} excluded, 20 traffic
agents under 4 RSUs in Non-IID Scenario II, the H²-Fed round with dual
proximal terms at CSR = 30%), pre-trained to the biased model, then
enhanced through ``fedsim.run_scenario``.  ``--device cpu`` runs the
kernels' plain PyTorch versions on the host.  The paper's "more than
90%" curve takes about 60 rounds (``--rounds 60``).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.mnist_mlp import CONFIG as MLP_CFG
from repro_torch.core.baselines import h2fed
from repro_torch.core.heterogeneity import HeterogeneityModel
from repro_torch.core.scenario import ScenarioSpec
from repro_torch.device import resolve_device
from repro_torch.fedsim import pretrain_to_target, run_scenario
from repro_torch.models import mlp


def main(argv=None) -> float:
    """Runs the quickstart; returns the final accuracy."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (plain versions)")
    ap.add_argument("--rounds", type=int, default=10,
                    help="global rounds of H²-Fed enhancement")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. the experiment cell: dataset + biased-pretrain recipe + partition
    #    + framework / heterogeneity knobs, in one spec
    hp = h2fed(mu1=0.001, mu2=0.005, lar=4, lr=0.1)
    spec = ScenarioSpec(
        n_agents=20, n_rsus=4, batch=32,
        n_train=6_000, n_test=1_000,
        excluded_labels=(7, 8, 9), pretrain_frac=0.25,
        pretrain_target=0.62,
        partition="scenario_two",
        hp=hp, het=HeterogeneityModel(csr=0.3, scd=1, lar=hp.lar),
        rounds=args.rounds)
    res = spec.resolve()

    # 2. OEM pre-training on the label-censored pool -> the biased model
    params = mlp.init_params(MLP_CFG, torch.Generator().manual_seed(spec.seed),
                             device=dev)
    pre_params, pre_acc = pretrain_to_target(
        params, res.pretrain_pool, res.test.x, res.test.y,
        target_acc=spec.pretrain_target, max_epochs=10, device=dev)
    print(f"pre-trained (biased) model accuracy: {pre_acc:.3f}")

    # 3. H²-Fed enhancement: dual proximal terms + hierarchical
    #    pre-aggregation, through the engine entry point
    _, hist = run_scenario(res, pre_params, device=dev)
    for r, a in zip(hist["round"], hist["acc"]):
        print(f"  global round {r:2d}: test acc {a:.3f}")
    final = float(hist["acc"][-1])
    print(f"enhanced: {pre_acc:.3f} -> {final:.3f} "
          f"with 70% of agents disconnected")
    return final


if __name__ == "__main__":
    main()
