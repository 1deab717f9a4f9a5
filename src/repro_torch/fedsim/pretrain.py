"""Centralized (pre-)training: the OEM phase (paper Sec. V) and the
centralized reference curve.

Batches come in the JAX package's order (``data.pipeline.epoch_orders``,
the permutations ``classification_batches`` draws), but the pool stays on
the device and each batch is gathered there.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.data.pipeline import epoch_orders
from repro_torch.data.synthetic import Dataset
from repro_torch.device import resolve_device
from repro_torch.models import mlp
from repro_torch.models.mlp import Params


def _sgd_step(params: Params, xb: torch.Tensor, yb: torch.Tensor,
              lr: float) -> Params:
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    grads = torch.autograd.grad(mlp.loss_fn(leaves, xb, yb),
                                list(leaves.values()))
    return {k: (v - lr * g).detach()
            for (k, v), g in zip(leaves.items(), grads)}


def _on_device(ds: Dataset, device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.from_numpy(ds.x).to(device),
            torch.from_numpy(ds.y).to(device=device, dtype=torch.long))


def _epoch(params: Params, x: torch.Tensor, y: torch.Tensor,
           order: np.ndarray, batch: int, lr: float) -> Params:
    order_t = torch.from_numpy(order).to(x.device)
    for i in range(0, len(order) - batch + 1, batch):
        take = order_t[i:i + batch]
        params = _sgd_step(params, x[take], y[take], lr)
    return params


def train_centralized(params: Params, ds: Dataset, *, lr: float = 0.05,
                      batch: int = 32, epochs: int = 1, seed: int = 0,
                      x_test=None, y_test=None, eval_every: int = 50,
                      device=None) -> Tuple[Params, Dict[str, np.ndarray]]:
    """Plain SGD over the pooled dataset; returns (params, history).
    Runs on ``device`` (``cuda`` when None; raises without a GPU)."""
    dev = resolve_device(device)
    params = {k: v.to(dev) for k, v in params.items()}
    x, y = _on_device(ds, dev)
    eval_fn = None
    if x_test is not None:
        xt, yt = _on_device(Dataset(x_test, y_test), dev)
        eval_fn = lambda p: float(mlp.accuracy(p, xt, yt))  # noqa: E731
    accs, steps, i = [], [], 0
    for order in epoch_orders(len(ds.y), seed=seed, epochs=epochs):
        order_t = torch.from_numpy(order).to(dev)
        for s in range(0, len(order) - batch + 1, batch):
            take = order_t[s:s + batch]
            params = _sgd_step(params, x[take], y[take], lr)
            if eval_fn is not None and i % eval_every == 0:
                accs.append(eval_fn(params))
                steps.append(i)
            i += 1
    return params, {"step": np.asarray(steps), "acc": np.asarray(accs)}


def pretrain_to_target(params: Params, pre_ds: Dataset, x_test, y_test, *,
                       target_acc: float = 0.68, lr: float = 0.05,
                       batch: int = 32, max_epochs: int = 30, seed: int = 0,
                       device=None) -> Tuple[Params, float]:
    """Train on the label-excluded OEM pool until test accuracy reaches the
    paper's pre-trained level (~68%), stopping at the first epoch boundary
    past the target.  Runs on ``device`` (``cuda`` when None; raises
    without a GPU)."""
    dev = resolve_device(device)
    params = {k: v.to(dev) for k, v in params.items()}
    x, y = _on_device(pre_ds, dev)
    xt, yt = _on_device(Dataset(np.asarray(x_test), np.asarray(y_test)), dev)
    acc = float(mlp.accuracy(params, xt, yt))
    for e in range(max_epochs):
        (order,) = epoch_orders(len(pre_ds.y), seed=seed + e)
        params = _epoch(params, x, y, order, batch, lr)
        acc = float(mlp.accuracy(params, xt, yt))
        if acc >= target_acc:
            break
    return params, acc
