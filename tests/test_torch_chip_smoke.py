"""``chip_smoke.py``'s report of the compiler's per-kernel resources: each
``Used N registers`` line of ``nvcc -Xptxas -v`` is printed with the name
of the kernel it belongs to, and with that kernel's stack and spill line.
Runs on the CPU: only the parsing is checked here."""
from __future__ import annotations

import importlib.util
from pathlib import Path

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
