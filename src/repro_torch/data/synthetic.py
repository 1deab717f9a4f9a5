"""Synthetic datasets, made from a seed with numpy (a copy of the JAX
package's generator, so both packages see the same arrays).

``mnist_class_task`` is a fixed-seed 10-class generative mixture with the
same dimensionality as MNIST (28x28 = 784).  It preserves every property the
paper's experiments depend on: label-partitionable (Non-IID shardable),
pre-trainable to a deliberately biased accuracy by label exclusion, and
learnable to >95% with the paper's ~130 kB MLP.

Each class c is a smooth prototype image (mixture of 2D Gaussian bumps at
class-keyed positions) plus per-sample elastic brightness jitter and pixel
noise — hard enough that a linear model underfits but a 784-40-10 MLP
reaches high accuracy, mirroring MNIST's role in the paper.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

IMG_SIDE = 28
INPUT_DIM = IMG_SIDE * IMG_SIDE
N_CLASSES = 10


@dataclasses.dataclass(frozen=True)
class Dataset:
    x: np.ndarray          # (N, 784) float32 in [0, 1]
    y: np.ndarray          # (N,)   int32 labels
    n_classes: int = N_CLASSES


def _class_prototypes(rng: np.random.Generator) -> np.ndarray:
    """(10, 28, 28) smooth prototype images, one per class."""
    yy, xx = np.mgrid[0:IMG_SIDE, 0:IMG_SIDE].astype(np.float32)
    protos = []
    for c in range(N_CLASSES):
        img = np.zeros((IMG_SIDE, IMG_SIDE), np.float32)
        n_bumps = 3 + c % 4
        for _ in range(n_bumps):
            cx, cy = rng.uniform(4, IMG_SIDE - 4, size=2)
            sx, sy = rng.uniform(2.0, 5.0, size=2)
            amp = rng.uniform(0.6, 1.0)
            img += amp * np.exp(-(((xx - cx) / sx) ** 2
                                  + ((yy - cy) / sy) ** 2))
        img /= max(img.max(), 1e-6)
        protos.append(img)
    return np.stack(protos)


def mnist_class_task(n_train: int = 22_000, n_test: int = 4_000,
                     noise: float = 0.45, seed: int = 0
                     ) -> Tuple[Dataset, Dataset]:
    """Fixed-seed train/test split of the 10-class mixture."""
    rng = np.random.default_rng(seed)
    protos = _class_prototypes(rng).reshape(N_CLASSES, INPUT_DIM)

    def draw(n, rng):
        y = rng.integers(0, N_CLASSES, size=n).astype(np.int32)
        base = protos[y]
        bright = rng.uniform(0.7, 1.3, size=(n, 1)).astype(np.float32)
        x = base * bright + rng.normal(0.0, noise, size=(n, INPUT_DIM)) \
            .astype(np.float32)
        return np.clip(x, 0.0, 1.5).astype(np.float32), y

    x_tr, y_tr = draw(n_train, rng)
    x_te, y_te = draw(n_test, np.random.default_rng(seed + 1))
    return Dataset(x_tr, y_tr), Dataset(x_te, y_te)


def lm_token_task(vocab: int = 512, n_tokens: int = 1 << 16,
                  seed: int = 0) -> np.ndarray:
    """Order-2 Markov token stream (N,) int32 with learnable structure:
    each of 4096 contexts prefers ~4 next tokens (the JAX package's stream,
    draw for draw)."""
    rng = np.random.default_rng(seed)
    n_ctx = 4096
    ctx_next = rng.integers(0, vocab, size=(n_ctx, 4)).astype(np.int32)
    toks = np.empty(n_tokens, np.int32)
    toks[0], toks[1] = rng.integers(0, vocab, 2)
    mix = rng.random(n_tokens)
    pick = rng.integers(0, 4, n_tokens)
    for t in range(2, n_tokens):
        ctx = (toks[t - 2] * 31 + toks[t - 1]) % n_ctx
        if mix[t] < 0.9:
            toks[t] = ctx_next[ctx, pick[t]]
        else:
            toks[t] = rng.integers(0, vocab)
    return toks
