"""The engine entry point.  The port dispatches the synchronous flat
engine only; ``ScenarioSpec.validate`` refuses what is not ported."""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from repro_torch.core.scenario import ScenarioSpec
from repro_torch.device import resolve_device
from repro_torch.fedsim import simulator
from repro_torch.models import mlp
from repro_torch.models.mlp import Params


def run_scenario(res, init_params: Optional[Params] = None, *, device=None,
                 eval_fn: Optional[Callable[[Params], float]] = None,
                 draws: Optional[Sequence[simulator.Draws]] = None):
    """Run ONE scenario through its engine; returns ``(final state,
    history)`` with ``history = {"round": ..., "acc": ...}``.

    ``device`` is ``cuda`` when None (raises without a GPU); the tests pass
    ``device="cpu"``, which runs the kernels' plain versions.
    ``init_params`` defaults to the paper's MLP drawn from a generator
    seeded with the spec's data seed.  ``draws[r]`` injects round r's
    (mask, active_steps) pairs in place of the engine's own draws (the
    parity seam); ``eval_fn`` overrides the test-set accuracy eval."""
    dev = resolve_device(device)
    if isinstance(res, ScenarioSpec):
        res = res.resolve()
    s = res.spec.validate()
    if init_params is None:
        from repro_torch.configs.mnist_mlp import CONFIG
        cfg_model = (CONFIG if not s.hidden_dims else dataclasses.replace(
            CONFIG, hidden_dims=tuple(s.hidden_dims)))
        init_params = mlp.init_params(
            cfg_model, torch.Generator().manual_seed(s.seed), device=dev)
    return simulator._run_sync(res, init_params, device=dev, eval_fn=eval_fn,
                               draws=draws)
