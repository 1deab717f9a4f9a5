#!/usr/bin/env python3
"""Compile CUDA sources of the port one by one and say what ptxas made of
each kernel: spills, the highest register used, and whether its wgmma
products stay in flight.

    python3 tools/ptxas_variants.py [FILE.cu ...] [--variants V.py ...]

With no FILE, the two attention sources (``csrc/flash_attention.cu`` and
``csrc/flash_attention_bwd.cu``).  A ``--variants`` file is Python that
defines ``V = {name: source text}``, e.g. a kernel with one change made by
string replacement, so that several designs are compiled side by side
(about 10 s each, all at once) before one is built and timed.  Each
source is compiled with the build's own flags (``kernels/_lib.py``) into
``build/ptxas_variants/``; for each kernel the report prints ptxas's spill
line, the highest register in its SASS, its HGMMA (wgmma) count and its
``WARPGROUP.DEPBAR`` count: a batch of products kept in flight ends in
one wait, a serialized kernel waits after every HGMMA.  ptxas's own
"Potential Performance Loss" notes are printed as they come.  Needs the
CUDA toolkit (``nvcc``, ``cuobjdump``): run it on the machine with the
card.
"""
from __future__ import annotations

import argparse
import re
import runpy
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "ptxas_variants"
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    from repro_torch.kernels import _lib

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("files", nargs="*")
    ap.add_argument("--variants", nargs="*", default=[])
    args = ap.parse_args()
    files = args.files or [str(CSRC / "flash_attention.cu"),
                           str(CSRC / "flash_attention_bwd.cu")]
    sources = {Path(f).stem: Path(f).read_text() for f in files}
    for v in args.variants:
        sources.update(runpy.run_path(v)["V"])
    OUT.mkdir(parents=True, exist_ok=True)
    for header in CSRC.glob("*.cuh"):
        shutil.copy(header, OUT / header.name)
    nvcc = _lib._nvcc()
    procs = {}
    for name, text in sources.items():
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_lib.NVCC_FLAGS, "-c", str(OUT / f"{name}.cu"), "-o",
             str(OUT / f"{name}.o")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    failed = False
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: nvcc failed\n{log}")
            failed = True
            continue
        spills, entry = {}, None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "spill" in line and entry:
                spills[entry] = line.strip()
            elif "Performance Loss" in line:
                print(f"{name}: {line.strip()}")
        sass = subprocess.run([cuobjdump, "-sass", str(OUT / f"{name}.o")],
                              capture_output=True, text=True).stdout
        for block in sass.split("Function :")[1:]:
            fn = block.splitlines()[0].strip()
            regs = [int(r) for r in re.findall(r"\bR(\d+)\b", block)] or [0]
            print(f"{name}: {fn}: {spills.get(fn, '')}; max register "
                  f"R{max(regs)}; HGMMA {len(re.findall('HGMMA', block))}, "
                  f"WARPGROUP.DEPBAR "
                  f"{len(re.findall(r'WARPGROUP.DEPBAR', block))}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
