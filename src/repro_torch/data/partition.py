"""Non-IID partitioning of a dataset across agents and RSUs.

The paper's two evaluation scenarios (Sec. VI):
  Scenario I  — Non-IID *across RSUs*: each RSU sees a label subset; agents
                under one RSU share that subset (IID within the RSU).
  Scenario II — Non-IID *across agents*: every RSU sees all labels, but each
                agent holds a label shard (LEAF-style).

``pretrain_split`` reproduces the paper's setup: the first ``n_pretrain``
agents exclude a few labels and form the OEM pre-training pool; the
remaining agents are the public federated fleet.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.data.synthetic import Dataset


@dataclasses.dataclass(frozen=True)
class FederatedData:
    """Fixed-size per-agent arrays (vmap-friendly)."""
    x: np.ndarray            # (A, n_per_agent, D)
    y: np.ndarray            # (A, n_per_agent)
    n_per_agent: np.ndarray  # (A,) actual data points (rows beyond are pad)
    rsu_assign: np.ndarray   # (A,) int RSU id

    @property
    def n_agents(self) -> int:
        return self.x.shape[0]


def pretrain_split(ds: Dataset, excluded_labels: Sequence[int],
                   frac: float = 0.1, seed: int = 0
                   ) -> Tuple[Dataset, Dataset]:
    """(pretrain pool with labels excluded, remaining federated pool)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(ds.y))
    n_pre = int(len(idx) * frac)
    pre, fed = idx[:n_pre], idx[n_pre:]
    keep = ~np.isin(ds.y[pre], np.asarray(excluded_labels))
    pre = pre[keep]
    return (Dataset(ds.x[pre], ds.y[pre], ds.n_classes),
            Dataset(ds.x[fed], ds.y[fed], ds.n_classes))


def _pack(parts_x: List[np.ndarray], parts_y: List[np.ndarray],
          rsu_assign: np.ndarray) -> FederatedData:
    """Pad per-agent shards to a common length (pad rows repeat data so the
    weighted objective is unchanged by construction: weights use true n)."""
    n_max = max(len(p) for p in parts_y)
    A, D = len(parts_y), parts_x[0].shape[1]
    x = np.zeros((A, n_max, D), np.float32)
    y = np.zeros((A, n_max), np.int32)
    n = np.zeros((A,), np.int32)
    for a, (px, py) in enumerate(zip(parts_x, parts_y)):
        reps = int(np.ceil(n_max / max(len(py), 1)))
        x[a] = np.tile(px, (reps, 1))[:n_max]
        y[a] = np.tile(py, reps)[:n_max]
        n[a] = len(py)
    return FederatedData(x=x, y=y, n_per_agent=n,
                         rsu_assign=rsu_assign.astype(np.int32))


def scenario_one(ds: Dataset, n_agents: int = 100, n_rsus: int = 10,
                 labels_per_rsu: int = 2, seed: int = 0) -> FederatedData:
    """Non-IID across RSUs; IID within an RSU cohort."""
    rng = np.random.default_rng(seed)
    rsu_assign = np.arange(n_agents) % n_rsus
    # contiguous label windows per RSU (wrap) -> distinct RSU distributions
    rsu_labels = [np.arange(r, r + labels_per_rsu) % ds.n_classes
                  for r in range(n_rsus)]
    parts_x, parts_y = [], []
    label_pools = {c: rng.permutation(np.where(ds.y == c)[0]).tolist()
                   for c in range(ds.n_classes)}
    for a in range(n_agents):
        labs = rsu_labels[rsu_assign[a]]
        take = []
        per_label = max(len(ds.y) // (n_agents * len(labs) * 2), 8)
        for c in labs:
            pool = label_pools[int(c)]
            take += pool[:per_label]
            label_pools[int(c)] = pool[per_label:] or pool  # recycle if dry
        take = np.asarray(take)
        parts_x.append(ds.x[take])
        parts_y.append(ds.y[take])
    return _pack(parts_x, parts_y, rsu_assign)


def scenario_two(ds: Dataset, n_agents: int = 100, n_rsus: int = 10,
                 labels_per_agent: int = 2, seed: int = 0) -> FederatedData:
    """Non-IID across agents (label shards); RSU cohorts cover all labels."""
    rng = np.random.default_rng(seed)
    rsu_assign = np.arange(n_agents) % n_rsus
    parts_x, parts_y = [], []
    label_pools = {c: rng.permutation(np.where(ds.y == c)[0]).tolist()
                   for c in range(ds.n_classes)}
    for a in range(n_agents):
        # agent label shard chosen so consecutive agents at one RSU differ
        start = (a * labels_per_agent + (a // n_rsus)) % ds.n_classes
        labs = np.arange(start, start + labels_per_agent) % ds.n_classes
        take = []
        per_label = max(len(ds.y) // (n_agents * labels_per_agent * 2), 8)
        for c in labs:
            pool = label_pools[int(c)]
            take += pool[:per_label]
            label_pools[int(c)] = pool[per_label:] or pool
        take = np.asarray(take)
        parts_x.append(ds.x[take])
        parts_y.append(ds.y[take])
    return _pack(parts_x, parts_y, rsu_assign)


def dirichlet_partition(ds: Dataset, n_agents: int = 100, n_rsus: int = 10,
                        alpha: float = 0.3, seed: int = 0) -> FederatedData:
    """Dirichlet(alpha) label-proportion Non-IID split (LEAF-style, the
    common FL benchmark recipe): per class, agent shares are drawn from
    Dirichlet(alpha) — small alpha concentrates each label on few agents
    (strongly Non-IID), large alpha approaches IID.  Declared via
    ``core.scenario.ScenarioSpec(partition="dirichlet", alpha=...)``."""
    rng = np.random.default_rng(seed)
    rsu_assign = np.arange(n_agents) % n_rsus
    props = rng.dirichlet([alpha] * n_agents, size=ds.n_classes)  # (C, A)
    parts: List[List[int]] = [[] for _ in range(n_agents)]
    for c in range(ds.n_classes):
        idx = rng.permutation(np.where(ds.y == c)[0])
        cuts = (np.cumsum(props[c]) * len(idx)).astype(int)[:-1]
        for a, chunk in enumerate(np.split(idx, cuts)):
            parts[a] += chunk.tolist()
    for a in range(n_agents):          # every agent holds >= 8 samples
        if len(parts[a]) < 8:
            parts[a] += rng.integers(0, len(ds.y), 8).tolist()
    parts_x = [ds.x[np.asarray(p)] for p in parts]
    parts_y = [ds.y[np.asarray(p)] for p in parts]
    return _pack(parts_x, parts_y, rsu_assign)


SCENARIOS = {"scenario_one": scenario_one, "scenario_two": scenario_two,
             "dirichlet": dirichlet_partition}
