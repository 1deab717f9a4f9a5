"""The straggler regime on the PyTorch port: the semi-async engine against
the synchronous flat engine with 90% of the agents timely disconnected.

    PYTHONPATH=src python examples/stragglers_torch.py [--device cuda]
                                                       [--rounds 30]
                                                       [--seeds 5]

The quickstart's fleet, data and biased pre-trained model
(``examples/quickstart_torch.py``) in the regime of
``benchmarks/async_round.py``: the async engine connects at CSR 0.25 and
delivers late with max_delay 2 and delay_p 0.6, so CSR x P(d=0) = 0.1 of
the agents arrive on time, with staleness decay 0.5 and buffer keep 0.5;
the flat engine runs at CSR 0.1 and discards the late work.  Prints the
mean final accuracy of both engines over ``--seeds`` draw realizations
beside the pre-trained model's.  ``--device cpu`` runs the kernels' plain
PyTorch versions on the host.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics

import torch

from repro_torch.configs.mnist_mlp import CONFIG as MLP_CFG
from repro_torch.core.baselines import h2fed
from repro_torch.core.heterogeneity import HeterogeneityModel
from repro_torch.core.scenario import ScenarioSpec
from repro_torch.device import resolve_device
from repro_torch.fedsim import pretrain_to_target, run_scenario
from repro_torch.models import mlp


def main(argv=None) -> dict:
    """Runs both engines; returns the mean final accuracies and the
    pre-trained model's."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (plain versions)")
    ap.add_argument("--rounds", type=int, default=30,
                    help="global rounds of each run")
    ap.add_argument("--seeds", type=int, default=5,
                    help="draw realizations (sim_seed 0 .. seeds-1)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    hp = h2fed(mu1=0.001, mu2=0.005, lar=4, lr=0.1)
    flat = ScenarioSpec(
        n_agents=20, n_rsus=4, batch=32, n_train=6_000, n_test=1_000,
        excluded_labels=(7, 8, 9), pretrain_frac=0.25, pretrain_target=0.62,
        partition="scenario_two", hp=hp,
        het=HeterogeneityModel(csr=0.1, scd=1, lar=hp.lar),
        rounds=args.rounds)
    stragglers = flat.replace(
        engine="async", staleness_decay=0.5, buffer_keep=0.5,
        het=dataclasses.replace(flat.het, csr=0.25, max_delay=2,
                                delay_p=0.6))
    res = flat.resolve()
    params = mlp.init_params(MLP_CFG, torch.Generator().manual_seed(flat.seed),
                             device=dev)
    pre, pre_acc = pretrain_to_target(
        params, res.pretrain_pool, res.test.x, res.test.y,
        target_acc=flat.pretrain_target, max_epochs=10, device=dev)
    print(f"pre-trained (biased) model accuracy: {pre_acc:.4f}")

    means = {"pre-trained": pre_acc}
    for name, spec in (("async", stragglers), ("flat", flat)):
        finals = []
        for sim_seed in range(args.seeds):
            _, hist = run_scenario(spec.replace(sim_seed=sim_seed), pre,
                                   device=dev)
            finals.append(float(hist["acc"][-1]))
        means[name] = statistics.mean(finals)
        print(f"{name}: final accuracy of sim_seed 0-{args.seeds - 1} after "
              f"{args.rounds} rounds: {[round(a, 4) for a in finals]}, mean "
              f"{means[name]:.4f}")
    print(f"90% disconnected: async {means['async']:.4f}, flat "
          f"{means['flat']:.4f}, pre-trained {pre_acc:.4f}")
    return means


if __name__ == "__main__":
    main()
