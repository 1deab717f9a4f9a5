#!/usr/bin/env python3
"""Time the attention kernel (#4) and its backward from one source tree,
so that two versions can be compared on one card in one call.

    python3 tools/attn_times.py --src SRC [--variant V.py] [--check]
        [--split-cutoff] [--cases REGEX]

Builds the kernels of the ``repro_torch`` package under SRC and prints one
JSON line a case (CUDA-event medians, as ``chip_smoke.py``'s ``cuda_ms``,
and ``device_ms``, the kernels' device time a forward call under
``torch.profiler``: a call shorter than its host path, as a decode step's,
leaves the card idle between back-to-back calls, so there the event time
is the host's):

- the forward at the qwen3-0.6b layer (B=1, S=4096, H=16, KV=8, D=128,
  causal; and with a 1024 window) and at the serving path's prefill shape
  (B=4, S=8192), the same at MLA's head dims (q/k 192, v 128,
  deepseek-v2-lite's H = KV = 16; ``flash_attention_mla``) and at
  zamba2-2.7b's head dim 80 (H = KV = 32; ``flash_attention_d80``), with
  a GQA control at 80 (KV = 8, whose heads share K/V in any block order),
  and at whisper-tiny's head dim 64 (H = KV = 6): its decoder
  self-attention at the prefill shape (B=32, S=448, causal), its
  cross-attention there (448 queries over T = 1500 encoder frames) and a
  decode step's (B=8, one query over 1500 frames), and the other D = 64
  shapes the port runs (``chip_smoke.py``'s "small", B=2, S=200, GQA 4/2,
  and "d64_gqa", B=2, S=1000, GQA 8/2; a 100 window at S=300; the
  reduced qwen3's heads, B=2, S=1024, GQA 4/2, whose forward training
  runs with the lse), all causal, each row with the
  kernel the tree's wrapper runs (``route``, where it names one),
  without the log-sum-exp output and, where the tree's forward has one,
  with it, the two timed in turns so that a drift of the card's clocks
  falls on both (a tree without it: the forward against itself, the same
  way);
- the backward at ``chip_smoke.py``'s three ``BWD_CASES``, given the
  forward's output (and its log-sum-exp, where the tree's backward takes
  one).

With ``--split-cutoff`` (a tree with the split-key route) it also times
the split-key kernel against the TMA + wgmma kernel at whisper's decode
shape for S = 1, 2, 4, 8 and 16 queries (``SPLIT_MAX_QUERIES`` set for
the call; both times), which is how that cut-off was chosen; the kernel
takes 4 queries at most, the ``split16`` variant of
``tools/attn_variants.py`` 16 (``--variant``).

With ``--check`` it also holds each forward's output against the plain
version (one batch row at a time) within one bf16 ulp and 2e-5, and dQ,
dK and dV against autograd of the plain version at those shapes and at
ragged ones (S = 130, 300, 513, 1000; GQA groups 1, 2, 4; windows of 100
and 200), within 2^-7 (max|want| + |want|), and exits 1 on a miss.  Run
the parent's tree and this one in turns (parent, this, this, parent) to
compare them.

``--cases REGEX`` keeps the forward and backward cases whose names match
(``re.search``), e.g. ``whisper`` for the three whisper-tiny shapes.

``--variant V.py`` (a file that defines ``V = {name: source}`` with one
entry, as ``tools/ptxas_variants.py`` takes them) times SRC with that
source in place of ``csrc/flash_attention.cu``: SRC's package is copied
to ``build/attn_times/<name>/`` and built there.
"""
from __future__ import annotations

import argparse
import inspect
import json
import re
import runpy
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

LAYER = (1, 4096, 16, 8, 128)
# (name, B, S, H, KV, D, Dv, causal, window, launches a timed run[, T])
FWD_CASES = (("layer", *LAYER, 128, True, 0, 10),
             ("layer_w1024", *LAYER, 128, True, 1024, 10),
             ("prefill", 4, 8192, 16, 8, 128, 128, True, 0, 2),
             ("mla_layer", 1, 4096, 16, 16, 192, 128, True, 0, 10),
             ("mla_layer_w1024", 1, 4096, 16, 16, 192, 128, True, 1024, 10),
             ("mla_prefill", 4, 8192, 16, 16, 192, 128, True, 0, 2),
             ("d80_layer", 1, 4096, 32, 32, 80, 80, True, 0, 10),
             ("d80_layer_w1024", 1, 4096, 32, 32, 80, 80, True, 1024, 10),
             ("d80_prefill", 4, 8192, 32, 32, 80, 80, True, 0, 2),
             ("d80_prefill_kv8", 4, 8192, 32, 8, 80, 80, True, 0, 2),
             ("whisper_self", 32, 448, 6, 6, 64, 64, True, 0, 10),
             ("whisper_cross", 32, 448, 6, 6, 64, 64, False, 0, 10, 1500),
             ("whisper_decode", 8, 1, 6, 6, 64, 64, False, 0, 10, 1500),
             ("d64_small", 2, 200, 4, 2, 64, 64, True, 0, 10),
             ("d64_gqa", 2, 1000, 8, 2, 64, 64, True, 0, 10),
             ("d64_w100", 1, 300, 4, 2, 64, 64, True, 100, 10),
             ("d64_reduced", 2, 1024, 4, 2, 64, 64, True, 0, 10))
SPLIT_CUTOFF_S = (1, 2, 4, 8, 16)
BWD_CASES = (("layer", *LAYER, True, 0),
             ("layer_w1024", *LAYER, True, 1024),
             ("reduced_d64", 2, 1024, 4, 2, 64, True, 0))
CHECK_CASES = (("s130", 1, 130, 4, 2, 128, True, 0),
               ("nc1000", 1, 1000, 16, 8, 128, False, 0),
               ("g4_w200", 1, 513, 8, 2, 128, True, 200),
               ("d64_w100", 1, 300, 4, 2, 64, True, 100))
TOL = 2.0 ** -7
FWD_ATOL = 2e-5         # chip_smoke.py's bf16 tolerance: one ulp and 2e-5
ROOT = Path(__file__).resolve().parents[1]


def variant_tree(src: Path, variant: str) -> Path:
    """A copy of SRC's package under build/attn_times/<name>/ with the
    variant's source as csrc/flash_attention.cu."""
    (name, text), = runpy.run_path(variant)["V"].items()
    dst = ROOT / "build" / "attn_times" / name / "src"
    # over an earlier copy, whose kernel build (named by a hash of its
    # sources) is reused only where the sources are the same
    shutil.copytree(src / "repro_torch", dst / "repro_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"),
                    dirs_exist_ok=True)
    (dst / "repro_torch" / "kernels" / "csrc" /
     "flash_attention.cu").write_text(text)
    return dst


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


def device_ms(fn, n: int = 20) -> float:
    """The device time of ``fn``'s kernels a call, over ``n`` calls under
    ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / n / 1e3


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


def inputs(B, S, H, KV, D, seed, Dv=None, T=None):
    """q, k, v and an upstream gradient in bf16; v and the gradient are
    ``Dv`` wide (D by default), k and v ``T`` long (S by default)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    T, Dv = T or S, Dv or D
    return [torch.randn(B, n_s, n, d, device="cuda",
                        generator=gen).bfloat16()
            for n_s, n, d in ((S, H, D), (T, KV, D), (T, KV, Dv), (S, H, Dv))]


def split_cutoff(fa) -> None:
    """The split-key kernel against the TMA + wgmma kernel at whisper's
    decode shape (B=8, H=6, T=1500) for ``SPLIT_CUTOFF_S`` queries, each
    pair timed in turns; the route is chosen by ``SPLIT_MAX_QUERIES``,
    set for the call and put back."""
    keep = fa.SPLIT_MAX_QUERIES
    for S in SPLIT_CUTOFF_S:
        q, k, v, _ = inputs(8, S, 6, 6, 64, S, 64, 1500)
        fa.SPLIT_MAX_QUERIES = S
        try:
            fa.flash_attention(q, k, v, causal=False)
        except RuntimeError:   # past the tree's split-key instances
            fa.SPLIT_MAX_QUERIES = keep
            print(json.dumps({"case": f"split_cutoff_s{S}",
                              "split_ms": None}), flush=True)
            continue

        def run(cut):
            def call():
                fa.SPLIT_MAX_QUERIES = cut
                fa.flash_attention(q, k, v, causal=False)
            return call
        split_ms, tma_ms = pair_ms(run(max(SPLIT_CUTOFF_S)), run(0), 10)
        split_dev = device_ms(run(max(SPLIT_CUTOFF_S)))
        resident = fa.split_resident(q.device, S)
        splits = fa.split_plan(8, 6, S, 1500, resident)[0]
        tma_dev = device_ms(run(0))
        fa.SPLIT_MAX_QUERIES = keep
        print(json.dumps({"case": f"split_cutoff_s{S}", "shape": [8, S, 6,
                          1500], "resident": resident, "splits": splits,
                          "split_ms": split_ms, "tma_ms": tma_ms,
                          "split_device_ms": split_dev,
                          "tma_device_ms": tma_dev}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default="src")
    ap.add_argument("--variant")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--split-cutoff", action="store_true")
    ap.add_argument("--cases", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attn_times: no CUDA device", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    if args.variant:
        src = variant_tree(src, args.variant)
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _lib
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    _lib.library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"src": args.src, "variant": args.variant,
                      "card": card.strip()}))
    has_lse = "lse" in inspect.signature(fa.flash_attention_bwd).parameters
    failed = []

    for name, B, S, H, KV, D, Dv, causal, window, inner, *T in FWD_CASES:
        if not re.search(args.cases, name):
            continue
        T = T[0] if T else S
        q, k, v, _ = inputs(B, S, H, KV, D, S + H, Dv, T)
        kw = dict(causal=causal, window=window)
        plain = lambda: fa.flash_attention(q, k, v, **kw)  # noqa: E731
        row = {"case": name, "kernel": fa._launch_key(D, Dv, T != S)}
        if hasattr(fa, "forward_route"):
            row["route"] = fa.forward_route(q.dtype, D, Dv, S, causal,
                                            window)
        if has_lse:
            with_lse = lambda: fa.flash_attention(  # noqa: E731
                q, k, v, return_lse=True, **kw)
            a, b = pair_ms(plain, with_lse, inner)
            row.update(ms=a, ms_with_lse=b)
        else:
            row.update(ms=pair_ms(plain, plain, inner)[0])
        row["device_ms"] = device_ms(plain)
        if args.check:
            got, err = plain(), 0.0
            for b in range(B):   # the plain version one batch row at a time
                want = ref.flash_attention_ref(
                    q[b:b + 1], k[b:b + 1], v[b:b + 1], **kw).float()
                diff = (got[b:b + 1].float() - want).abs()
                err = max(err, diff.max().item())
                if not (bool(torch.isfinite(got[b]).all()) and bool(
                        (diff <= FWD_ATOL + TOL * want.abs()).all())):
                    failed.append(f"{name} out row {b}")
                del want, diff
            row["max_abs_err"] = err
            del got
        print(json.dumps(row), flush=True)
        del q, k, v
        torch.cuda.empty_cache()

    if args.split_cutoff:
        split_cutoff(fa)

    cases = BWD_CASES + (CHECK_CASES if args.check else ())
    for name, B, S, H, KV, D, causal, window in cases:
        if not re.search(args.cases, name):
            continue
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
