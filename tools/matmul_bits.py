#!/usr/bin/env python3
"""Hold two versions of the aggregation matmul kernel (#2) to bit equality
on one card.

    python3 tools/matmul_bits.py --src SRC --out FILE
    python3 tools/matmul_bits.py --src SRC --against FILE

Builds the kernels of the ``repro_torch`` package under SRC, runs #2 on
inputs drawn from a seeded CUDA generator at each shape ``chip_smoke.py``
ran it at before the kernel took agent tiles (``weighted_agg_matmul``
with the fleet's dtype out and ``scatter_accumulate`` with fp32 sums at
the main, paper and perception shapes in fp32 and bf16; the cloud layer's
one row; the sweep's 16 scenarios with a stacked and a shared W), and
writes a SHA-256 of each output's bytes to FILE (``--out``), or compares
them with a FILE another version wrote (``--against``): exit 1 on any
difference.  Run both versions on one card, in one call.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import torch

SHAPES = (("main", 20, 4, 31_810), ("paper", 100, 10, 31_810),
          ("perception", 100, 10, 9_540_010))
SWEEP = (16, 100, 10, 31_810)


def digest(t: torch.Tensor) -> str:
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()


def outputs(dev) -> dict:
    from repro_torch.kernels import masked_hier_agg as mha
    out = {}
    for name, A, R, N in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=dev).manual_seed(A * 7 + R)
            x = torch.randn(A, N, device=dev, generator=gen).to(dtype)
            W = torch.randn(R, A, device=dev, generator=gen)
            w = torch.rand(A, device=dev, generator=gen) + 0.5
            assign = torch.arange(A, device=dev) % R
            rsu = torch.randn(R, N, device=dev, generator=gen).to(dtype)
            wn = torch.rand(1, R, device=dev, generator=gen)
            key = f"{name} {str(dtype)[6:]}"
            out[f"{key} weighted_agg_matmul"] = digest(
                mha.weighted_agg_matmul(W, x))
            num, mass = mha.scatter_accumulate(x, w, assign, R)
            out[f"{key} scatter_accumulate"] = digest(num)
            out[f"{key} cloud"] = digest(mha.weighted_agg_matmul(wn, rsu))
            del x, rsu, num
            torch.cuda.empty_cache()
    S, A, R, N = SWEEP
    gen = torch.Generator(device=dev).manual_seed(S)
    x = torch.randn(S, A, N, device=dev, generator=gen)
    W = torch.randn(S, R, A, device=dev, generator=gen)
    out["sweep stacked W"] = digest(mha.weighted_agg_matmul(W, x))
    out["sweep shared W"] = digest(mha.weighted_agg_matmul(W[0], x))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="the tree's src directory")
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--out", help="write the digests here")
    mode.add_argument("--against", help="compare with these digests")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("matmul_bits: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    got = outputs(torch.device("cuda"))
    if args.out:
        Path(args.out).write_text(json.dumps(got, indent=1))
        print(f"matmul_bits: {len(got)} digests written to {args.out}")
        return 0
    want = json.loads(Path(args.against).read_text())
    differ = sorted(k for k in want if got.get(k) != want[k])
    print(f"matmul_bits: {len(want) - len(differ)} of {len(want)} outputs "
          f"bit-identical; differ: {differ}")
    return 1 if differ or set(got) != set(want) else 0


if __name__ == "__main__":
    sys.exit(main())
