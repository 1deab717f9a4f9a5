"""The in-process registry of built sweep programs.

``get_or_build`` memoizes a built program bundle (a multi-scenario
sweep's batched round body and its batched eval) under an explicit
:class:`ProgramKey`.  The key carries everything that shapes the program
but is not an operand of its calls: the ``ResolvedScenario.static_key``,
the sweep width S and which scalars are batched, the baked (non-batched)
hp/het/cadence values, the cadence bounds, which data blocks the group
shares, the device and mesh fingerprints and the ``kernels.ops`` flags.
A registry hit skips the build; ``note_trace`` / ``trace_count`` count the
builds themselves (in this package a "trace" is one build of a batched
round program: PyTorch runs eagerly and traces nothing), the number a
mixed-cadence group pins to 1.

The JAX package's other layer, the persistent XLA compilation cache
across processes, has no counterpart here: nothing is compiled per
program, and the CUDA kernels' objects already persist across processes
in ``kernels/build/`` (``kernels/_lib``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

_REGISTRY: Dict[Any, Any] = {}
_TRACES: Dict[str, int] = {}
_stats = {"hits": 0, "misses": 0}


def device_fingerprint(device=None) -> Tuple:
    """Hashable identity of the device a program was built for: (type,
    name, index); the name is the card's for CUDA, "cpu" otherwise."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        index = torch.cuda.current_device() if dev.index is None \
            else dev.index
        return (dev.type, torch.cuda.get_device_name(index), index)
    return (dev.type, dev.type, dev.index)


def mesh_fingerprint(mesh) -> Optional[Tuple]:
    """Hashable identity of a mesh of ranks (``launch.mesh.FleetMesh``):
    its axes and sizes and the process group's backend; ``None`` (one
    rank, ``fedsim.sweep.sweep_mesh``'s single-card layout) passes
    through.  This rank's coordinate is left out: every rank of a mesh
    builds the same program for its own cells."""
    if mesh is None:
        return None
    return (tuple(mesh.shape.items()), mesh.backend)


def ops_flags(fused: bool) -> Tuple:
    """The ``kernels.ops`` routing a program bakes in: ``fused`` only (the
    route otherwise follows the tensors' device, which the device
    fingerprint carries; there is no interpret switch)."""
    return ("fused", bool(fused))


class ProgramKey(NamedTuple):
    """The full identity of a built program bundle."""
    kind: str                    # e.g. "sweep"
    static_key: Tuple            # ResolvedScenario.static_key
    n_scenarios: int             # sweep width S
    dyn_names: Tuple[str, ...]   # which scalars are batched (S,) data
    baked: Tuple                 # non-batched hp/het/cadence values
    cadence: Any                 # simulator.Cadence bounds or None
    data_axes: Tuple             # which data blocks are stacked or shared
    donation: Tuple[int, ...]    # the JAX key's donation signature
    devices: Tuple               # device_fingerprint()
    mesh: Optional[Tuple]        # mesh_fingerprint()
    flags: Tuple                 # ops_flags()


def get_or_build(key, builder: Callable[[], Any], *, enabled: bool = True):
    """The bundle registered under ``key``, built (and registered) on first
    use.  ``enabled=False`` (``ScenarioSpec.program_cache=False``) always
    builds afresh and never touches the registry."""
    if not enabled:
        return builder()
    try:
        bundle = _REGISTRY[key]
    except KeyError:
        _stats["misses"] += 1
        bundle = _REGISTRY[key] = builder()
        return bundle
    _stats["hits"] += 1
    return bundle


def note_trace(label: str) -> None:
    """Called by a program's builder: one call is one build of that
    program family."""
    _TRACES[label] = _TRACES.get(label, 0) + 1


def trace_count(label: str) -> int:
    return _TRACES.get(label, 0)


def stats() -> Dict[str, int]:
    return dict(_stats, entries=len(_REGISTRY), **{
        f"traces/{k}": v for k, v in _TRACES.items()})


def reset_stats() -> None:
    """Zero the hit/miss/trace counters (the registry itself survives)."""
    _stats["hits"] = _stats["misses"] = 0
    _TRACES.clear()


def clear() -> None:
    """Drop the registry and the counters."""
    _REGISTRY.clear()
    reset_stats()
