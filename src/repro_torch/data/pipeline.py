"""Deterministic input pipelines.

``classification_batches``: epoch iterator over a Dataset in the JAX
package's order (one numpy permutation per epoch from ``default_rng(seed)``),
used for centralized pre-training.  ``epoch_orders`` yields those
permutations themselves, so a caller can keep the data on the device and
index it there.

``agent_minibatch``: the federated engine's cyclic minibatch for every
agent at once, a gather along the per-agent sample axis.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from repro_torch.data.synthetic import Dataset


def epoch_orders(n: int, *, seed: int = 0,
                 epochs: int = 1) -> Iterator[np.ndarray]:
    """One sample permutation per epoch, from one ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        yield rng.permutation(n)


def classification_batches(ds: Dataset, batch: int, *, seed: int = 0,
                           epochs: int = 1) -> Iterator[Tuple[np.ndarray,
                                                              np.ndarray]]:
    for order in epoch_orders(len(ds.y), seed=seed, epochs=epochs):
        for i in range(0, len(order) - batch + 1, batch):
            take = order[i:i + batch]
            yield ds.x[take], ds.y[take]


def agent_minibatch(x: torch.Tensor, y: torch.Tensor, step: int,
                    batch: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cyclic minibatch of every agent.  x: (A, n, D), y: (A, n) with n the
    PADDED per-agent length; returns (A, batch, D), (A, batch).  A leading
    scenario axis, x (S, A, n, D) and y (S, A, n), is kept.

    Index rule (the JAX package's): ``(step*batch + arange(batch)) % n``,
    the same rows for every agent."""
    n = y.shape[-1]
    idx = (step * batch + torch.arange(batch, device=x.device)) % n
    return x.index_select(-2, idx), y.index_select(-1, idx)


def lm_sequences(tokens: np.ndarray, batch: int, seq: int,
                 *, seed: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless (tokens, next tokens) int32 windows of (batch, seq) at
    random starts from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    n = len(tokens) - seq - 1
    while True:
        starts = rng.integers(0, n, size=batch)
        window = np.stack([tokens[s:s + seq + 1] for s in starts])
        yield window[:, :-1].astype(np.int32), window[:, 1:].astype(np.int32)
