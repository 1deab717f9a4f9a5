#!/usr/bin/env python3
"""Time the attention kernel (#4) and its backward from one source tree,
so that two versions can be compared on one card in one call.

    python3 tools/attn_times.py --src SRC [--check]

Builds the kernels of the ``repro_torch`` package under SRC and prints one
JSON line a case (CUDA-event medians, as ``chip_smoke.py``'s ``cuda_ms``):

- the forward at the qwen3-0.6b layer (B=1, S=4096, H=16, KV=8, D=128,
  causal; and with a 1024 window) and at the serving path's prefill shape
  (B=4, S=8192), and the same at MLA's head dims (q/k 192, v 128,
  deepseek-v2-lite's H = KV = 16; ``flash_attention_mla``), without the
  log-sum-exp output and, where the tree's forward has one, with it, the
  two timed in turns so that a drift of the card's clocks falls on both
  (a tree without it: the forward against itself, the same way);
- the backward at ``chip_smoke.py``'s three ``BWD_CASES``, given the
  forward's output (and its log-sum-exp, where the tree's backward takes
  one).

With ``--check`` it also holds dQ, dK and dV against autograd of the plain
version at those shapes and at ragged ones (S = 130, 300, 513, 1000; GQA
groups 1, 2, 4; windows of 100 and 200), within 2^-7 (max|want| +
|want|), and exits 1 on a miss.  Run the parent's tree and this one in
turns (parent, this, this, parent) to compare them.
"""
from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

LAYER = (1, 4096, 16, 8, 128)
# (name, B, S, H, KV, D, Dv, causal, window, launches a timed run)
FWD_CASES = (("layer", *LAYER, 128, True, 0, 10),
             ("layer_w1024", *LAYER, 128, True, 1024, 10),
             ("prefill", 4, 8192, 16, 8, 128, 128, True, 0, 2),
             ("mla_layer", 1, 4096, 16, 16, 192, 128, True, 0, 10),
             ("mla_layer_w1024", 1, 4096, 16, 16, 192, 128, True, 1024, 10),
             ("mla_prefill", 4, 8192, 16, 16, 192, 128, True, 0, 2))
BWD_CASES = (("layer", *LAYER, True, 0),
             ("layer_w1024", *LAYER, True, 1024),
             ("reduced_d64", 2, 1024, 4, 2, 64, True, 0))
CHECK_CASES = (("s130", 1, 130, 4, 2, 128, True, 0),
               ("nc1000", 1, 1000, 16, 8, 128, False, 0),
               ("g4_w200", 1, 513, 8, 2, 128, True, 200),
               ("d64_w100", 1, 300, 4, 2, 64, True, 100))
TOL = 2.0 ** -7


def cuda_ms(fn, reps: int = 11, inner: int = 10) -> float:
    """Median over ``reps`` of the mean of ``inner`` back-to-back calls,
    after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def pair_ms(fa, fb, inner: int, reps: int = 12) -> tuple:
    """Medians of two calls timed in turns, a before b in even reps and
    b before a in odd ones, so that neither a drift of the card's clocks
    under a long run nor the place in a pair favours one."""
    for _ in range(2):
        fa()
        fb()
    torch.cuda.synchronize()
    times = ([], [])
    for rep in range(reps):
        order = ((fa, times[0]), (fb, times[1]))
        for fn, out in (order if rep % 2 == 0 else order[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / inner)
    return statistics.median(times[0]), statistics.median(times[1])


def inputs(B, S, H, KV, D, seed, Dv=None):
    """q, k, v and an upstream gradient in bf16; v and the gradient are
    ``Dv`` wide (D by default)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(B, S, n, d, device="cuda", generator=gen).bfloat16()
            for n, d in ((H, D), (KV, D), (KV, Dv or D), (H, Dv or D))]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default="src")
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attn_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import _lib
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    _lib.library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"src": args.src, "card": card.strip()}))
    has_lse = "lse" in inspect.signature(fa.flash_attention_bwd).parameters

    for name, B, S, H, KV, D, Dv, causal, window, inner in FWD_CASES:
        q, k, v, _ = inputs(B, S, H, KV, D, S + H, Dv)
        kw = dict(causal=causal, window=window)
        plain = lambda: fa.flash_attention(q, k, v, **kw)  # noqa: E731
        row = {"case": name, "kernel": "flash_attention" if D == Dv
               else "flash_attention_mla"}
        if has_lse:
            with_lse = lambda: fa.flash_attention(  # noqa: E731
                q, k, v, return_lse=True, **kw)
            a, b = pair_ms(plain, with_lse, inner)
            row.update(ms=a, ms_with_lse=b)
        else:
            row.update(ms=pair_ms(plain, plain, inner)[0])
        print(json.dumps(row), flush=True)
        del q, k, v
        torch.cuda.empty_cache()

    failed = []
    cases = BWD_CASES + (CHECK_CASES if args.check else ())
    for name, B, S, H, KV, D, causal, window in cases:
        q, k, v, do = inputs(B, S, H, KV, D, S + D)
        kw = dict(causal=causal, window=window)
        if has_lse:
            out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
            bwd = lambda: fa.flash_attention_bwd(  # noqa: E731
                q, k, v, out, do, lse, **kw)
        else:
            out = fa.flash_attention(q, k, v, **kw)
            bwd = lambda: fa.flash_attention_bwd(  # noqa: E731
                q, k, v, out, do, **kw)
        row = {"case": name, "kernel": "flash_attention_bwd",
               "shape": [B, S, H, KV, D, causal, window]}
        if name in {c[0] for c in BWD_CASES}:
            row["ms"] = cuda_ms(bwd)
        if args.check:
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            want = torch.autograd.grad(
                ref.flash_attention_ref(*leaves, **kw), leaves, do)
            errs = {}
            for g_name, g, w in zip(("dq", "dk", "dv"), bwd(), want):
                g, w = g.float(), w.float()
                err = (g - w).abs()
                errs[g_name] = err.max().item()
                if not (bool(torch.isfinite(g).all()) and bool(
                        (err <= TOL * (w.abs().max() + w.abs())).all())):
                    failed.append(f"{name} {g_name}")
            row["max_abs_err"] = errs
        print(json.dumps(row), flush=True)
        del q, k, v, do, out
        torch.cuda.empty_cache()
    if failed:
        print(f"attn_times: outside 2^-7 (max|want| + |want|): {failed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
