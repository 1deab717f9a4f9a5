"""``examples/quickstart_torch.py``, the port's quickstart, run on the CPU
for 2 rounds: it pre-trains the biased model, enhances it through
``run_scenario`` and prints ``enhanced: a -> b`` with the final accuracy
of the history it printed."""
from __future__ import annotations

import importlib.util
import re
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _quickstart():
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_quickstart_twin_runs_two_rounds_on_cpu(capsys):
    final = _quickstart().main(["--device", "cpu", "--rounds", "2"])
    out = capsys.readouterr().out
    rounds = re.findall(r"global round +(\d+): test acc ([0-9.]+)", out)
    assert [int(r) for r, _ in rounds] == [1, 2]
    m = re.search(r"enhanced: ([0-9.]+) -> ([0-9.]+)", out)
    assert m, out
    pre = float(re.search(r"accuracy: ([0-9.]+)", out).group(1))
    assert float(m.group(1)) == pre and 0.5 < pre < 0.75
    assert float(m.group(2)) == float(rounds[-1][1]) == round(final, 3)


def test_quickstart_twin_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _quickstart().main(["--rounds", "1"])


def test_stragglers_example_runs_on_cpu(capsys):
    """``examples/stragglers_torch.py`` for one round and one draw
    realization on the CPU: both engines from the same pre-trained model,
    the means it returns are the ones it printed."""
    spec = importlib.util.spec_from_file_location(
        "stragglers_torch", ROOT / "examples" / "stragglers_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    means = module.main(["--device", "cpu", "--rounds", "1", "--seeds", "1"])
    out = capsys.readouterr().out
    m = re.search(r"90% disconnected: async ([0-9.]+), flat ([0-9.]+), "
                  r"pre-trained ([0-9.]+)", out)
    assert m, out
    assert [float(g) for g in m.groups()] == [
        round(means[k], 4) for k in ("async", "flat", "pre-trained")]
    assert 0.5 < means["pre-trained"] < 0.75
