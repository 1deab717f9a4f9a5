"""``chip_smoke.py`` on the CPU: its report of the compiler's per-kernel
resources (each ``Used N registers`` line of ``nvcc -Xptxas -v`` printed
with the name of the kernel it belongs to, and with that kernel's stack and
spill line), and which phases each of its modes runs.  Only the parsing
and the phase selection are checked here, with the card and the phases
faked."""
from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

LOG = """== flash_attention.cu
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_16kernelEv' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_16kernelEv
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z5otherPf' for 'sm_90a'
ptxas info    : Function properties for _Z5otherPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 16 bytes smem
"""


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_ptxas_lines_name_their_kernel():
    lines = _chip_smoke().ptxas_by_kernel(LOG)
    assert len(lines) == 2
    first, second = lines
    # demangled where c++filt is installed, else the mangled name
    assert first.startswith(("(anonymous namespace)::kernel()",
                             "_ZN12_GLOBAL__N_16kernelEv"))
    assert "4 bytes spill stores" in first
    assert "Used 168 registers, used 16 barriers" in first
    assert second.startswith(("other(float*)", "_Z5otherPf"))
    assert "Used 40 registers" in second and "16 bytes smem" in second
    assert "168" not in second


# the functions that run each phase after the build, by name
PHASE_RUNNERS = ("aggregation_cases", "attention_cases", "slstm_cases",
                 "main_path", "serving_path", "xlstm_serving")


@pytest.mark.parametrize("flag,runs", [("--attention", ["attention_cases"]),
                                       ("--scan", ["slstm_cases"]),
                                       ("--agg", ["aggregation_cases"])])
def test_modes_run_their_phase_and_print_no_result(monkeypatch, capsys,
                                                   flag, runs):
    """A mode runs the build and its kernel's phase, nothing else, and
    exits 0 without the result line; checked with the card and the
    phases faked, so no card is needed."""
    cs = _chip_smoke()
    called = []
    monkeypatch.setattr(cs.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cs, "device_and_build",
                        lambda: ("cuda", "NVIDIA H100 80GB HBM3, 700.00 W"))
    for name in PHASE_RUNNERS:
        monkeypatch.setattr(cs, name,
                            lambda dev, name=name: called.append(name) or [])
    assert cs.main([flag]) == 0
    assert called == runs
    assert '"ok"' not in capsys.readouterr().out


def test_phase_selection():
    cs = _chip_smoke()
    assert cs.selected_phases([]) == cs.FULL_RUN
    assert "5" in cs.FULL_RUN
    assert cs.selected_phases(["--scan"]) == ("1", "2c")
    assert cs.selected_phases(["--attention"]) == ("1", "2b")
    with pytest.raises(SystemExit):
        cs.selected_phases(["--scan", "--attention"])
    with pytest.raises(SystemExit):
        cs.selected_phases(["--fast"])


def test_no_card_exits_nonzero_without_a_result(monkeypatch, capsys):
    cs = _chip_smoke()
    monkeypatch.setattr(cs.torch.cuda, "is_available", lambda: False)
    assert cs.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out
