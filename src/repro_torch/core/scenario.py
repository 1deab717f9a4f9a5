"""Declarative experiment scenarios: the port's ``ScenarioSpec`` /
``ResolvedScenario``, with the JAX package's fields and keys.

A ``ScenarioSpec`` bundles one grid cell of the paper's experiments: the
fleet shape, the synthetic dataset and OEM-pretrain recipe, the partition
recipe, the framework and heterogeneity parameters, the engine choice and
the run length with its two seeds (``seed`` fixes data / partition /
pretrain, ``sim_seed`` only the connectivity / FSR draws).  ``resolve()``
builds the datasets and the partition (numpy, array-equal to the JAX
package's); ``cache_key`` hashes every field.

The port runs the synchronous ``engine="flat"`` round and the semi-async
``engine="async"`` tick engine, both with or without a fault plan
(``faults=FaultPlan(...)``).  ``validate()`` raises ``NotImplementedError``
for what it has not ported: the ``tree`` and ``sharded`` engines, the host
fleet store, cohort / N-tile streaming, serving, ``model_shards > 1`` and
``rsu_sharded``.  The fields stay, so a spec round-trips between the
packages.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, Optional, Tuple, Union

from repro_torch.core.faults import FaultPlan
from repro_torch.core.h2fed import H2FedParams
from repro_torch.core.heterogeneity import HeterogeneityModel

PARTITIONS = ("scenario_one", "scenario_two", "dirichlet")
_PARTITION_ALIASES = {
    "scenario_one": "scenario_one", "1": "scenario_one", 1: "scenario_one",
    "scenario_two": "scenario_two", "2": "scenario_two", 2: "scenario_two",
    "dirichlet": "dirichlet",
}


def _norm_partition(p) -> str:
    if p not in _PARTITION_ALIASES:
        raise ValueError(f"unknown partition {p!r} "
                         f"(want one of {PARTITIONS} or 1|2)")
    return _PARTITION_ALIASES[p]


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _unported(cond: bool, what: str) -> None:
    if cond:
        raise NotImplementedError(
            f"{what} is not ported to repro_torch yet (see ROADMAP.md)")


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One declarative experiment cell.  Frozen + hashable; every field is
    part of ``cache_key``."""

    # -- fleet shape -------------------------------------------------------
    n_agents: int = 40
    n_rsus: int = 8
    batch: int = 32

    # -- dataset (synthetic MNIST-class task, Sec. VI) ---------------------
    n_train: int = 9_000
    n_test: int = 1_500
    noise: float = 0.8

    # -- OEM pretrain recipe (the biased "68%" model) ----------------------
    excluded_labels: Tuple[int, ...] = (7, 8, 9)
    pretrain_frac: float = 0.12
    pretrain_target: float = 0.68

    # -- partition recipe --------------------------------------------------
    partition: str = "scenario_two"   # scenario_one | scenario_two | dirichlet
    alpha: float = 0.3                # Dirichlet(alpha) concentration

    # -- framework + heterogeneity ----------------------------------------
    hp: H2FedParams = dataclasses.field(default_factory=H2FedParams)
    het: HeterogeneityModel = dataclasses.field(
        default_factory=HeterogeneityModel)

    # -- engine ------------------------------------------------------------
    engine: str = "flat"              # the port runs "flat" and "async"
    fleet_dtype: str = "float32"      # fleet-buffer storage: float32 | bf16
    fused: bool = True                # one-pass aggregate-and-blend rounds
    rsu_sharded: bool = False         # not ported
    model_shards: int = 1             # not ported beyond 1
    fleet_store: str = "device"       # not ported beyond "device"
    chunk_agents: int = 0             # not ported beyond 0
    chunk_params: int = 0             # not ported beyond 0
    # model-size knob: non-empty overrides the paper MLP's hidden widths
    hidden_dims: Tuple[int, ...] = ()
    # semi-async knobs (engine="async")
    staleness_decay: Union[float, Tuple[float, ...]] = 0.5
    schedule: str = "exp"
    buffer_keep: Union[float, Tuple[float, ...]] = 0.0
    cloud_every: int = 0
    # continuous serving (not ported)
    serve_events: int = 0
    arrival_rate: float = 1.0
    tick_trigger: str = "auto"
    queue_capacity: int = 0
    overload_policy: str = "drop_oldest"
    serve_trace: str = ""

    # -- fault injection (engines "flat" and "async") ----------------------
    faults: Optional[FaultPlan] = None

    # -- run ---------------------------------------------------------------
    rounds: int = 24
    eval_every: int = 1
    seed: int = 0        # data / partition / pretrain seed
    sim_seed: int = 0    # connectivity / FSR realization (seed-averaging)
    program_cache: bool = True

    # -- validation --------------------------------------------------------
    def validate(self) -> "ScenarioSpec":
        _check(self.n_agents >= 1 and self.n_rsus >= 1 and self.batch >= 1,
               "n_agents, n_rsus and batch must be >= 1")
        _check(self.n_train > 0 and self.n_test > 0,
               "n_train and n_test must be > 0")
        _check(0.0 < self.pretrain_frac < 1.0, "pretrain_frac must be in (0, 1)")
        _norm_partition(self.partition)
        _check(self.alpha > 0.0, "alpha must be > 0")
        self.hp.validate(), self.het.validate()
        _check(self.engine in ("flat", "tree", "sharded", "async"),
               f"unknown engine {self.engine!r}")
        _check(self.fleet_store in ("device", "host"),
               f"unknown fleet_store {self.fleet_store!r}")
        _check(self.chunk_agents >= 0 and self.chunk_params >= 0
               and self.model_shards >= 1, "negative chunk / shard counts")
        _check(all(int(h) > 0 for h in self.hidden_dims),
               "hidden_dims must be positive")
        _check(self.schedule in ("exp", "poly"),
               f"unknown schedule {self.schedule!r}")
        _check(self.cloud_every >= 0 and self.serve_events >= 0
               and self.queue_capacity >= 0 and self.arrival_rate > 0.0,
               "bad async / serving knobs")
        _check(self.overload_policy in ("drop_oldest", "backpressure"),
               f"unknown overload_policy {self.overload_policy!r}")
        _check(self.rounds >= 1 and self.eval_every >= 1,
               "rounds and eval_every must be >= 1")
        _unported(self.engine not in ("flat", "async"),
                  f"engine {self.engine!r}")
        if self.faults is not None:
            if not isinstance(self.faults, FaultPlan):
                raise TypeError(f"faults must be a FaultPlan, got "
                                f"{type(self.faults).__name__}")
            self.faults.validate(self.n_rsus)
        _unported(self.fleet_store != "device", "the host fleet store")
        _unported(bool(self.chunk_agents), "cohort streaming (chunk_agents)")
        _unported(bool(self.chunk_params), "N-tile streaming (chunk_params)")
        _unported(bool(self.serve_events), "serving (serve_events)")
        _unported(self.model_shards > 1, "parameter-axis sharding")
        _unported(self.rsu_sharded, "the rsu-sharded engine")
        return self

    def replace(self, **kw) -> "ScenarioSpec":
        return dataclasses.replace(self, **kw)

    # -- cache keys --------------------------------------------------------
    def _canonical(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["partition"] = _norm_partition(self.partition)
        return d

    @property
    def cache_key(self) -> str:
        """Stable content hash over every field."""
        return _digest(self._canonical())

    @property
    def dataset_key(self) -> str:
        """Sub-key over the dataset + pretrain recipe only."""
        d = self._canonical()
        return _digest({k: d[k] for k in (
            "n_train", "n_test", "noise", "excluded_labels",
            "pretrain_frac", "pretrain_target", "seed")})

    @property
    def partition_key(self) -> str:
        """Sub-key over dataset + partition recipe + fleet shape."""
        d = self._canonical()
        return _digest({k: d[k] for k in (
            "n_train", "n_test", "noise", "excluded_labels",
            "pretrain_frac", "partition", "alpha", "n_agents", "n_rsus",
            "seed")})

    # -- resolution --------------------------------------------------------
    def sim_config(self):
        """The engine's SimConfig (``sim_seed`` folds into the draw seed)."""
        from repro_torch.fedsim.simulator import SimConfig
        return SimConfig(n_agents=self.n_agents, n_rsus=self.n_rsus,
                         batch=self.batch,
                         seed=self.seed * 1000 + self.sim_seed,
                         eval_every=self.eval_every)

    def resolve(self) -> "ResolvedScenario":
        """Concrete datasets + partition + configs."""
        self.validate()
        from repro_torch.data.partition import SCENARIOS, pretrain_split
        from repro_torch.data.synthetic import mnist_class_task

        train, test = mnist_class_task(n_train=self.n_train,
                                       n_test=self.n_test, noise=self.noise,
                                       seed=self.seed)
        pre_ds, fed_pool = pretrain_split(train, self.excluded_labels,
                                          frac=self.pretrain_frac,
                                          seed=self.seed)
        part = _norm_partition(self.partition)
        kw = {"alpha": self.alpha} if part == "dirichlet" else {}
        fed = SCENARIOS[part](fed_pool, n_agents=self.n_agents,
                              n_rsus=self.n_rsus, seed=self.seed, **kw)
        return ResolvedScenario(spec=self, train=train, test=test,
                                pretrain_pool=pre_ds, fed_pool=fed_pool,
                                fed=fed)

    # -- serialization -----------------------------------------------------
    def to_json(self, **dump_kw) -> str:
        return json.dumps(self._canonical(), **({"indent": 1} | dump_kw))

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ScenarioSpec":
        d = dict(d)
        if isinstance(d.get("hp"), dict):
            d["hp"] = H2FedParams(**d["hp"])
        if isinstance(d.get("het"), dict):
            d["het"] = HeterogeneityModel(**d["het"])
        if isinstance(d.get("faults"), dict):
            d["faults"] = FaultPlan.from_dict(d["faults"])
        for k in ("excluded_labels", "staleness_decay", "buffer_keep",
                  "hidden_dims"):
            if isinstance(d.get(k), list):
                d[k] = tuple(d[k])
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown ScenarioSpec fields: {sorted(unknown)}")
        return cls(**d).validate()

    @classmethod
    def from_json(cls, text: str) -> "ScenarioSpec":
        return cls.from_dict(json.loads(text))


@dataclasses.dataclass
class ResolvedScenario:
    """A spec made concrete: the arrays + configs the engine consumes."""
    spec: ScenarioSpec
    train: Any           # data.synthetic.Dataset
    test: Any            # data.synthetic.Dataset (the eval boundary)
    pretrain_pool: Any   # OEM pretrain Dataset (labels excluded)
    fed_pool: Any        # public-fleet Dataset (pre-partition)
    fed: Any             # data.partition.FederatedData

    @property
    def cfg(self):
        return self.spec.sim_config()

    @property
    def hp(self) -> H2FedParams:
        return self.spec.hp

    @property
    def het(self) -> HeterogeneityModel:
        return self.spec.het


def _digest(obj: Any) -> str:
    return hashlib.sha256(
        json.dumps(obj, sort_keys=True, default=repr).encode()
    ).hexdigest()[:16]
