"""Declarative experiment scenarios: the port's ``ScenarioSpec`` /
``ResolvedScenario``, with the JAX package's fields and keys.

A ``ScenarioSpec`` bundles one grid cell of the paper's experiments: the
fleet shape, the synthetic dataset and OEM-pretrain recipe, the partition
recipe, the framework and heterogeneity parameters, the engine choice and
the run length with its two seeds (``seed`` fixes data / partition /
pretrain, ``sim_seed`` only the connectivity / FSR draws).  ``resolve()``
builds the datasets and the partition (numpy, array-equal to the JAX
package's), cached per ``dataset_key`` / ``partition_key`` so the
scenarios of a grid share one dataset and one ``FederatedData`` object
(``clear_caches`` drops them); ``cache_key`` hashes every field, and
``ResolvedScenario.static_key`` is what the scenarios of one batched sweep
program must share (``fedsim/sweep``).

The port runs the synchronous ``engine="flat"`` round and the semi-async
``engine="async"`` tick engine, both with or without a fault plan
(``faults=FaultPlan(...)``), resident or cohort-streamed
(``fleet_store="host"`` / ``chunk_agents``, and ``chunk_params`` for the
two-axis round), the continuous serving loop (``serve_events > 0`` on the
async engine, ``fedsim/serving``), and the sharded rounds over the ranks
of a mesh (``engine="sharded"``, replicated, ``rsu_sharded`` or with
``model_shards > 1``; ``engine="async"`` with ``rsu_sharded``).
``validate()`` keeps the reference's rules and raises
``NotImplementedError`` for the one engine it has not ported, ``tree``.
The fields stay, so a spec round-trips between the packages.
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
    engine: str = "flat"              # flat | sharded | async ("tree": no)
    fleet_dtype: str = "float32"      # fleet-buffer storage: float32 | bf16
    fused: bool = True                # one-pass aggregate-and-blend rounds
    rsu_sharded: bool = False         # the RSU axis over the pod axis
    model_shards: int = 1             # > 1: N-sharded (engine "sharded")
    fleet_store: str = "device"       # "device" | "host" (streamed)
    chunk_agents: int = 0             # agents a streamed chunk (0: auto)
    chunk_params: int = 0             # columns a two-axis tile (0: off)
    # model-size knob: non-empty overrides the paper MLP's hidden widths
    hidden_dims: Tuple[int, ...] = ()
    # semi-async knobs (engine="async")
    staleness_decay: Union[float, Tuple[float, ...]] = 0.5
    schedule: str = "exp"
    buffer_keep: Union[float, Tuple[float, ...]] = 0.0
    cloud_every: int = 0
    # continuous serving (engine="async", fedsim/serving)
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
        streamed = self.fleet_store != "device" or bool(self.chunk_agents)
        _check(not streamed or self.engine in ("flat", "async"),
               f"cohort streaming (fleet_store={self.fleet_store!r}, "
               f"chunk_agents={self.chunk_agents}) requires engine "
               f"'flat'|'async', got {self.engine!r}")
        _check(not self.chunk_params or (self.engine == "flat"
                                         and self.fleet_store == "host"),
               f"two-axis streaming (chunk_params={self.chunk_params}) "
               f"requires engine 'flat' with fleet_store 'host', got engine "
               f"{self.engine!r} / store {self.fleet_store!r}")
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
        if self.serve_events:
            _check(self.engine == "async",
                   "serving (serve_events > 0) runs the async tick engine")
            _check(not streamed, "serving needs the device-resident fleet")
            _check(not self.rsu_sharded, "serving is not rsu-sharded")
            from repro_torch.core.load_gen import parse_trigger
            parse_trigger(self.tick_trigger, self.n_agents)
        _unported(self.engine == "tree", f"engine {self.engine!r}")
        if self.model_shards > 1:
            _check(self.engine == "sharded",
                   f"model_shards={self.model_shards} is the N-sharded fleet "
                   f"mode — engine 'sharded', got {self.engine!r}")
            _check(not streamed, "N-sharding needs the device-resident fleet")
        if self.faults is not None:
            if not isinstance(self.faults, FaultPlan):
                raise TypeError(f"faults must be a FaultPlan, got "
                                f"{type(self.faults).__name__}")
            _check(self.engine in ("flat", "async"),
                   f"fault injection requires engine 'flat'|'async', got "
                   f"{self.engine!r}")
            _check(not self.rsu_sharded, "fault injection is not threaded "
                   "through the rsu-sharded path")
            self.faults.validate(self.n_rsus)
            _check(not streamed or not self.faults.corrupts,
                   "corrupted-update injection is not supported on the "
                   "cohort-streamed engines (churn/outage/guards are)")
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
        """Concrete datasets + partition + configs, cached per sub-key: the
        dataset is built once per ``dataset_key``, the partition once per
        ``partition_key``, shared by a grid's specs."""
        self.validate()
        from repro_torch.data.partition import SCENARIOS, pretrain_split
        from repro_torch.data.synthetic import mnist_class_task

        dk = self.dataset_key
        if dk not in _DATA_CACHE:
            train, test = mnist_class_task(
                n_train=self.n_train, n_test=self.n_test, noise=self.noise,
                seed=self.seed)
            pre_ds, fed_pool = pretrain_split(
                train, self.excluded_labels, frac=self.pretrain_frac,
                seed=self.seed)
            _DATA_CACHE[dk] = (train, test, pre_ds, fed_pool)
        train, test, pre_ds, fed_pool = _DATA_CACHE[dk]

        pk = self.partition_key
        if pk not in _PART_CACHE:
            part = _norm_partition(self.partition)
            kw = {"alpha": self.alpha} if part == "dirichlet" else {}
            _PART_CACHE[pk] = SCENARIOS[part](
                fed_pool, n_agents=self.n_agents, n_rsus=self.n_rsus,
                seed=self.seed, **kw)
        return ResolvedScenario(spec=self, train=train, test=test,
                                pretrain_pool=pre_ds, fed_pool=fed_pool,
                                fed=_PART_CACHE[pk])

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

    @property
    def static_key(self) -> Tuple:
        """Everything that must be equal for scenarios to share one batched
        sweep program (``fedsim/sweep`` groups on it): shapes and engine
        flavour, not the per-scenario scalars the sweep batches
        (csr/fsr/scd/delay_p, mu1/mu2/lr) nor the cadence knobs (lar,
        local_epochs, cloud_every), which the sweep pads to the group's
        bounds.  The reference's tuple, field for field."""
        s = self.spec
        return (s.n_agents, s.n_rsus, s.batch,
                tuple(self.fed.x.shape),
                tuple(self.test.x.shape) if self.test is not None else None,
                s.engine, s.fleet_dtype, s.fused, s.rsu_sharded,
                s.model_shards,
                s.fleet_store, s.chunk_agents, s.chunk_params,
                s.hidden_dims,
                s.hp.n_layers,
                s.het.max_delay,
                s.staleness_decay, s.schedule, s.buffer_keep,
                s.rounds, s.eval_every,
                s.serve_events, s.arrival_rate, s.tick_trigger,
                s.queue_capacity, s.overload_policy, s.serve_trace,
                # a fault plan is data (its lowered masks); only presence
                # and guard structure shape the program
                None if s.faults is None else s.faults.static_fingerprint)


def _digest(obj: Any) -> str:
    return hashlib.sha256(
        json.dumps(obj, sort_keys=True, default=repr).encode()
    ).hexdigest()[:16]


# resolve() caches, keyed by the content sub-keys, so a second seed or
# partition is never served the first one's arrays
_DATA_CACHE: Dict[str, Tuple] = {}
_PART_CACHE: Dict[str, Any] = {}


def clear_caches() -> None:
    """Drop the resolve() caches (tests, long-lived processes)."""
    _DATA_CACHE.clear()
    _PART_CACHE.clear()
