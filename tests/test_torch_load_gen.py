"""The port's load generator against the JAX package's, on the CPU.

``core/load_gen`` is numpy only in both packages, with the same seeds, so
the port's per-agent rates, Poisson event streams and traces must equal
the reference's bit for bit on the same inputs; a trace written by either
package reads back in the other with every timestamp equal.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core import load_gen as jlg
from repro.core.heterogeneity import HeterogeneityModel as JHet

from repro_torch.core import load_gen as tlg
from repro_torch.core.heterogeneity import HeterogeneityModel


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread for this module, as every module that
    runs both packages (their thread pools compete under xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HETS = {
    "default": {},
    "stragglers": dict(max_delay=4, delay_p=0.8),
    "throttled": dict(csr=0.1, fsr=0.5, max_delay=4, delay_p=0.8),
    "always_late": dict(max_delay=3, delay_p=1.0),
    "partial": dict(csr=0.6, scd=2, fsr=0.7, max_delay=2, delay_p=0.3),
}


@pytest.mark.parametrize("het", list(HETS))
@pytest.mark.parametrize("n_agents,base,seed", [(8, 1.0, 0), (32, 2.0, 3),
                                                (100, 0.5, 17)])
def test_agent_rates_bit_equal(het, n_agents, base, seed):
    got = tlg.agent_rates(HeterogeneityModel(**HETS[het]), n_agents,
                          base_rate=base, seed=seed)
    want = jlg.agent_rates(JHet(**HETS[het]), n_agents, base_rate=base,
                           seed=seed)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_agents,seed,n", [(8, 7, 100), (100, 0, 2000)])
def test_poisson_take_bit_equal(n_agents, seed, n):
    het = dict(max_delay=4, delay_p=0.8)
    rates = tlg.agent_rates(HeterogeneityModel(**het), n_agents, 1.5, seed)
    got = tlg.PoissonLoadGen(rates, seed=seed, n_events=n).take(n)
    want = jlg.PoissonLoadGen(rates, seed=seed, n_events=n).take(n)
    assert [tuple(e) for e in got] == [tuple(e) for e in want]
    assert all(type(e.t) is float for e in got)


def test_every_agent_once_trace_equal():
    got = tlg.every_agent_once_trace(5, 4)
    want = jlg.every_agent_once_trace(5, 4)
    assert len(got) == len(want) == 20
    assert [tuple(e) for e in got.events()] == [tuple(e)
                                                for e in want.events()]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_trace_round_trip_across_packages(tmp_path, writer):
    """A trace written by either package reads back in both, every
    timestamp bit-equal; ``limit`` and ``n_agents`` act alike."""
    rates = tlg.agent_rates(HeterogeneityModel(), 6, 1.3, seed=1)
    evs = tlg.PoissonLoadGen(rates, seed=11, n_events=64).take(64)
    p = tmp_path / "trace.jsonl"
    (tlg if writer == "port" else jlg).write_trace(evs, p)
    for mod in (tlg, jlg):
        back = mod.read_trace(p, n_agents=6)
        assert [(e.t, e.agent, e.seq) for e in back] == \
               [(e.t, e.agent, e.seq) for e in evs]
        assert len(mod.TraceLoadGen.from_jsonl(p, limit=10)) == 10
    assert ([tuple(e) for e in tlg.TraceLoadGen.from_jsonl(p).events()]
            == [tuple(e) for e in jlg.TraceLoadGen.from_jsonl(p).events()])


BAD_TRACES = {
    "json": '{"t": 0.1, "agent": 0}\nnot json\n',
    "missing_key": '{"t": 0.1}\n',
    "nan_time": '{"t": NaN, "agent": 0}\n',
    "negative_agent": '{"t": 0.1, "agent": -1}\n',
    "foreign_agent": '{"t": 0.1, "agent": 0}\n{"t": 0.2, "agent": 9}\n',
}
BAD_TRIGGERS = ["", "batch:x", "every:3", "batch:0", "batch:-1",
                "deadline:-2", "batch:2,deadline:x"]


@pytest.mark.parametrize("case", ["trigger_ok"]
                         + [f"trigger:{t}" for t in BAD_TRIGGERS]
                         + [f"trace:{k}" for k in BAD_TRACES]
                         + ["time_travel"])
def test_parsers_agree(tmp_path, case):
    """``parse_trigger`` and ``read_trace`` accept and refuse what the
    reference does, with a ``ValueError`` naming the fault."""
    if case == "trigger_ok":
        for s in ("auto", "batch:6", "deadline:1.5", "batch:6,deadline:1.5"):
            got = tlg.parse_trigger(s, 24)
            assert tuple(got) == tuple(jlg.parse_trigger(s, 24))
        assert tlg.parse_trigger("auto", 24) == (24, 0.0)
        return
    kind, _, what = case.partition(":")
    if kind == "trigger":
        for mod in (tlg, jlg):
            with pytest.raises(ValueError):
                mod.parse_trigger(what, 24)
    elif kind == "trace":
        p = tmp_path / "bad.jsonl"
        p.write_text(BAD_TRACES[what])
        for mod in (tlg, jlg):
            with pytest.raises(ValueError, match=r"bad.jsonl:\d"):
                mod.read_trace(p, n_agents=8)
    else:
        for mod in (tlg, jlg):
            with pytest.raises(ValueError, match="non-decreasing"):
                mod.TraceLoadGen([mod.Event(1.0, 0, 0), mod.Event(0.5, 1, 1)])
