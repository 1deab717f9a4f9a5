"""The port's in-process program registry (``core/program_cache``): keys,
memoization, the opt-out and the counters."""
from __future__ import annotations

import pytest
import torch

from repro_torch.core import program_cache as pc


def _key(**over):
    kw = dict(kind="sweep", static_key=(8, 2, 16, (8, 40, 784)),
              n_scenarios=3, dyn_names=("hp.mu1",),
              baked=((("hp.lr", 0.1),),), cadence=None,
              data_axes=((("x", None),), None, None), donation=(),
              devices=pc.device_fingerprint("cpu"),
              mesh=pc.mesh_fingerprint(None), flags=pc.ops_flags(True))
    kw.update(over)
    return pc.ProgramKey(**kw)


@pytest.fixture(autouse=True)
def empty_registry():
    pc.clear()
    yield
    pc.clear()


def test_key_is_hashable_and_stable():
    a, b = _key(), _key()
    assert a == b and hash(a) == hash(b)
    assert {a: 1}[b] == 1


@pytest.mark.parametrize("over", [
    dict(flags=pc.ops_flags(False)),
    dict(devices=("cuda", "NVIDIA H100 80GB HBM3", 0)),
    dict(n_scenarios=4), dict(dyn_names=()), dict(cadence=(3, 2))])
def test_key_changes_with_what_shapes_the_program(over):
    assert _key(**over) != _key()


def test_fingerprints():
    assert pc.device_fingerprint("cpu") == ("cpu", "cpu", None)
    assert pc.device_fingerprint(torch.device("cpu")) == \
        pc.device_fingerprint("cpu")
    assert pc.mesh_fingerprint(None) is None
    assert pc.ops_flags(True) == ("fused", True)
    assert pc.ops_flags(1) == pc.ops_flags(True)


def test_get_or_build_memoizes():
    built = []

    def build():
        built.append(1)
        return object()

    first = pc.get_or_build(_key(), build)
    assert pc.get_or_build(_key(), build) is first
    assert len(built) == 1
    other = pc.get_or_build(_key(n_scenarios=5), build)
    assert other is not first and len(built) == 2
    assert pc.stats() == {"hits": 1, "misses": 2, "entries": 2}


def test_disabled_never_touches_the_registry():
    pc.get_or_build(_key(), object)
    before = pc.stats()
    a = pc.get_or_build(_key(), object, enabled=False)
    b = pc.get_or_build(_key(), object, enabled=False)
    assert a is not b
    assert pc.stats() == before


def test_trace_counters_and_reset():
    assert pc.trace_count("sweep_round") == 0
    pc.note_trace("sweep_round")
    pc.note_trace("sweep_round")
    pc.get_or_build(_key(), object)
    assert pc.trace_count("sweep_round") == 2
    assert pc.stats()["traces/sweep_round"] == 2
    pc.reset_stats()
    assert pc.trace_count("sweep_round") == 0
    assert pc.stats() == {"hits": 0, "misses": 0, "entries": 1}
    pc.clear()
    assert pc.stats()["entries"] == 0


def test_mesh_fingerprints_tell_meshes_apart():
    """A sweep's mesh over the ranks enters the key by its axes, sizes and
    backend; one rank's meshes of other axes differ, equal ones agree."""
    from repro_torch.launch.mesh import FleetMesh
    sweep = pc.mesh_fingerprint(FleetMesh((1,), ("sweep",)))
    assert sweep == ((("sweep", 1),), None)
    assert sweep == pc.mesh_fingerprint(FleetMesh((1,), ("sweep",)))
    assert sweep != pc.mesh_fingerprint(FleetMesh((1,), ("data",)))
    assert pc.mesh_fingerprint(None) is None
