#!/usr/bin/env python3
"""Time #4's forward entry from several source trees in one process, in
turns, so that a difference of a few percent between two versions of the
kernel (a ring depth, an issue order) is not lost in the spread between
processes and calls.

    python3 tools/attn_ab.py SRC [SRC ...] [--cases REGEX] [--reps N]
        [--lse]

Each SRC holds a ``repro_torch`` package: the repository's ``src``, a
parent's tree unpacked under ``build/parent/src``, or a variant's copy
that ``tools/attn_times.py --variant`` made under
``build/attn_times/<name>/src``.  Each tree's kernel library is built by
its own ``kernels/_lib.py`` (one subprocess a tree, all at once) and
loaded with ctypes.  For each of ``tools/attn_times.py``'s forward cases
that ``--cases`` matches (``re.search``; default the whisper-tiny
prefill shapes), every library's ``repro_flash_attention`` entry runs on
the same bf16 tensors, the trees in an order that rotates from rep to rep
and turns round every other rep; the line a case gives each tree the
median over the reps of the CUDA-event mean of ``inner`` back-to-back
launches (the case's own count), that time over the first tree's, the
spread of the ratio to the first tree within a rep (lowest and highest
over the reps) and the number of reps in which the tree beat the first.
``--lse`` has every call store the rows' log-sum-exp too (the forward
that training runs).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from attn_times import FWD_CASES, inputs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels import _lib  # noqa: E402

BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
         "from repro_torch.kernels import _lib; print(_lib.build())")


def load(srcs):
    """Each tree's built library, loaded, with the forward entry typed."""
    procs = [subprocess.Popen([sys.executable, "-c", BUILD, str(s)],
                              stdout=subprocess.PIPE, text=True)
             for s in srcs]
    libs = []
    for src, proc in zip(srcs, procs):
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"attn_ab: the build of {src} failed")
        lib = ctypes.CDLL(out.strip().splitlines()[-1])
        lib.repro_flash_attention.argtypes = _lib._SIGNATURES[
            "repro_flash_attention"]
        lib.repro_flash_attention.restype = ctypes.c_int
        libs.append(lib)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("srcs", nargs="+")
    ap.add_argument("--cases", default="whisper_(self|cross)")
    ap.add_argument("--reps", type=int, default=24)
    ap.add_argument("--lse", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attn_ab: no CUDA device", file=sys.stderr)
        return 2
    libs = load(args.srcs)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"srcs": args.srcs, "card": card.strip(),
                      "lse": args.lse}))
    stream = torch.cuda.current_stream().cuda_stream
    for name, B, S, H, KV, D, Dv, causal, window, inner, *T in FWD_CASES:
        if not re.search(args.cases, name):
            continue
        T = T[0] if T else S
        q, k, v, _ = inputs(B, S, H, KV, D, S + H, Dv, T)
        out = torch.empty(B, S, H, Dv, dtype=q.dtype, device="cuda")
        lse = torch.empty(B, H, S, device="cuda") if args.lse else None
        call_args = (out.data_ptr(), lse.data_ptr() if args.lse else 0,
                     q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), B, S, T, H, KV, D, Dv, *q.stride()[:3],
                     *k.stride()[:3], *v.stride()[:3], int(causal),
                     int(window), 1, stream)

        def run(lib):
            for _ in range(inner):
                _lib.check(lib.repro_flash_attention(*call_args),
                           "flash_attention")
        for lib in libs:
            run(lib)
        torch.cuda.synchronize()
        times = [[] for _ in libs]
        for rep in range(args.reps):
            order = list(range(len(libs)))
            order = order[rep % len(libs):] + order[:rep % len(libs)]
            for i in (order if rep % 2 == 0 else order[::-1]):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run(libs[i])
                end.record()
                end.synchronize()
                times[i].append(start.elapsed_time(end) / inner)
        ms = [statistics.median(t) for t in times]
        ratios = [[a / b for a, b in zip(t, times[0])] for t in times]
        print(json.dumps({"case": name, "ms": dict(zip(args.srcs, ms)),
                          "vs_first": [m / ms[0] for m in ms],
                          "rep_ratio_range": [[min(r), max(r)]
                                              for r in ratios],
                          "reps_faster_than_first": [
                              sum(x < 1 for x in r) for r in ratios]}),
              flush=True)
        del q, k, v, out, lse
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
