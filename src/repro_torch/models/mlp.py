"""The paper's ~130 kB classification MLP (784-40-10) as plain functions
on a dict of tensors.

``forward`` / ``loss_fn`` / ``accuracy`` take one model.  The
``*_stacked`` forms take ``(A, ...)`` stacked parameters and ``(A, b, D)``
inputs and run every agent at once through ``torch.baddbmm``;
``grad_stacked`` is the per-agent gradient of the flat engine's local
training, the gradient of the sum of per-agent mean losses taken with
respect to ``(A, N)`` views of one flat buffer (a sweep's S fleets pass as
S*A rows); ``accuracy_stacked`` evaluates a sweep's S cloud models in one
call.  The small matmuls stay
``torch.bmm``, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.mnist_mlp import MLPTaskConfig
from repro_torch.core.flatten import FlatSpec

Params = Dict[str, torch.Tensor]


def init_params(cfg: MLPTaskConfig, gen: torch.Generator,
                device=None) -> Params:
    """He-normal weights and zero biases, drawn from ``gen`` (on the
    generator's device, then moved to ``device``)."""
    dims = (cfg.input_dim,) + tuple(cfg.hidden_dims) + (cfg.n_classes,)
    params = {}
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        w = torch.randn((d_in, d_out), generator=gen, device=gen.device)
        params[f"w{i}"] = (w * (2.0 / d_in) ** 0.5).to(device)
        params[f"b{i}"] = torch.zeros(d_out, device=device)
    return params


def n_layers(params: Params) -> int:
    return sum(1 for k in params if k.startswith("w"))


def forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (..., input_dim) -> logits (..., n_classes)."""
    L = n_layers(params)
    h = x
    for i in range(L):
        h = h @ params[f"w{i}"] + params[f"b{i}"]
        if i < L - 1:
            h = torch.relu(h)
    return h


def loss_fn(params: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy."""
    logp = F.log_softmax(forward(params, x), dim=-1)
    return -logp.gather(-1, y[..., None]).mean()


def accuracy(params: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (forward(params, x).argmax(dim=-1) == y).float().mean()


def accuracy_stacked(params: Params, x: torch.Tensor,
                     y: torch.Tensor) -> torch.Tensor:
    """S models at once (params stacked (S, ...)) on one shared test set x
    (n, D), y (n,), or one each, (S, n, D) and (S, n) -> (S,)."""
    L = n_layers(params)
    h = x
    for i in range(L):
        h = torch.matmul(h, params[f"w{i}"]) + params[f"b{i}"][:, None, :]
        if i < L - 1:
            h = torch.relu(h)
    return (h.argmax(dim=-1) == y).float().mean(dim=-1)


def forward_stacked(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Stacked params (w_i (A, d_in, d_out), b_i (A, d_out)) and x
    (A, b, input_dim) -> logits (A, b, n_classes)."""
    L = n_layers(params)
    h = x
    for i in range(L):
        h = torch.baddbmm(params[f"b{i}"][:, None, :], h, params[f"w{i}"])
        if i < L - 1:
            h = torch.relu(h)
    return h


def loss_stacked(params: Params, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
    """Per-agent mean cross-entropy -> (A,)."""
    logp = F.log_softmax(forward_stacked(params, x), dim=-1)
    return -logp.gather(-1, y[..., None]).squeeze(-1).mean(dim=-1)


def grad_stacked(spec: FlatSpec, w_flat: torch.Tensor, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
    """Per-agent gradient of the mean loss at the (A, N) fp32 rows
    ``w_flat``; row a depends only on agent a's loss, so one backward of
    the summed loss gives every row's gradient."""
    leaf = w_flat.detach().requires_grad_(True)
    loss = loss_stacked(spec.unravel_stacked(leaf), x, y).sum()
    (g,) = torch.autograd.grad(loss, leaf)
    return g
