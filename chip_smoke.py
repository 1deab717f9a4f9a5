#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. Device and build: the card's name and power limit (``nvidia-smi``), and
   the build of the CUDA kernels from ``src/repro_torch/kernels/csrc``.
2. The aggregation and update kernels against their plain PyTorch versions
   on the card, in fp32 and bf16 fleets, at the main path's shape (A=20,
   R=4, N=31,810), the paper fleet (A=100, R=10) and perception scale
   (A=100, R=10, N=9,540,010, the 784-12000-10 MLP): max error, the
   kernel's time (CUDA events, median of 11 timed runs of 10 launches after
   warm-up), its bound at the H100's 3.35 TB/s and 67 TFLOP/s fp32, the
   plain version's time and, for the aggregation kernels, one PyTorch
   call's time (``library_ms``).  ``agg_blend`` and ``cloud_blend`` are
   timed as the whole entry the engine calls (the weights built in the
   kernel) and in the coef form with their operands ready; ``agg_blend``'s
   bound counts prev only for its zero-mass rows, the only rows it reads.
   For the whole entries, ``dual_proximal_sgd`` in the engine's form,
   ``weighted_agg_matmul`` and the coef forms, the time split into device
   time a call (``device_ms``, ``torch.profiler``) and host time a call
   (``host_us``: 1,000 calls enqueued without a synchronise, on the host
   clock); at the main shape also the host time of the matmul's launch
   path's pieces.
2b. flash_attention against its plain version in bf16 and fp32: a small
   ragged case (B=2, S=200, H=4, KV=2, D=64), the qwen3-0.6b layer (B=1,
   S=4096, H=16, KV=8, D=128) causal and with a 1024 window, and two ragged
   cases at its heads (S=129 causal, S=1000 non-causal); bound at
   989 TFLOP/s bf16 / 67 TFLOP/s fp32 over the live (query, key) pairs;
   ``library_ms`` is one ``scaled_dot_product_attention`` call (timed only,
   the port never calls it).  Then the serving path's shape (B=4, S=8192)
   in bf16, the plain version run one batch row at a time.
2c. slstm_scan against its plain version with R in bf16 and fp32: the
   shapes of the JAX package's kernel tests, saturated gates (inputs x25)
   and the xlstm-125m layer (B=4, S=8192, H=4, P=192); bound at 67 TFLOP/s
   fp32 (a recurrence cannot reach it: beside it the same S steps at the
   smallest width, H=1, P=8, as the kernel's latency floor); no
   ``library_ms`` (PyTorch has no sLSTM call).
3. The flat-round main path: the ``examples/quickstart.py`` scenario
   through ``ScenarioSpec -> pretrain_to_target -> run_scenario`` on the
   card, with the launch counts set to 0 just before and read just after;
   the mean final accuracy of that run and four more draw realizations
   must beat the pre-trained model by 0.05.  Then 2 rounds with a bf16
   fleet, 1 round with ``fused=False`` (the ``weighted_agg_matmul`` path),
   and 2 rounds on the card against the same 2 rounds on the host (plain
   versions) with the same injected draws.  Last, three global rounds on
   the host clock and under ``torch.profiler`` (wall, launches and device
   busy share a round), and 20 calls each of ``agg_blend``,
   ``cloud_blend`` and ``dual_proximal_sgd`` under it: each call must be
   one launch of its kernel and nothing else.
3b. The semi-async path: the quickstart fleet in the 90%-disconnect
   regime of ``benchmarks/async_round.py`` (async at CSR 0.25 with
   max_delay 2, delay_p 0.6, so CSR x P(d=0) = 0.1; staleness decay 0.5,
   buffer keep 0.5, the per-round cloud cadence; 30 rounds) through
   ``run_scenario(engine="async")`` on the card, counted: exactly one
   ``agg_absorb`` launch a tick, one ``cloud_blend`` a round, the update
   kernel each step.  The mean final accuracy of five draw realizations
   must not fall below the pre-trained model's (printed beside the flat
   engine's at CSR 0.1), with every buffer finite.  Then 2 async rounds on
   the card against the same rounds on the host (plain versions), the
   card's own draws replayed on both: fp32 buffers within 1e-5, in-flight
   weights and tick counts equal; again with a bf16 fleet (rounds of one
   tick, each from the card's state; one bf16 ulp), with ``fused=False``
   (the scatter-accumulates on the matmul kernel, counted) and with
   ``cloud_every=3``.  Faults: an empty plan equals ``faults=None`` bit for
   bit on the card, on the flat and the async engine; under churn, an RSU
   outage with recovery, NaN poison, scale caught by ``norm_clip`` and
   stale replay, card and host agree (quarantine counts and blocked mass
   equal, buffers within 1e-5, the cloud finite) on both engines.  Last,
   wall, launches and device busy share a round of the async round beside
   the flat round's at the main and paper fleets, and 20 ``agg_absorb``
   calls under the profiler: one launch of kernel #1 a call, with the
   launches and time of the weight building around it.
4. The serving path: qwen3-0.6b at full width in bf16 with params drawn on
   the card.  ``make_prefill_step`` at B=4, S=8192 (exactly 28
   flash_attention launches a call; ms, tokens/s, peak memory); the serve
   launcher at its defaults with ``--full-config`` (batch 8, prompt 32, gen
   32; decode tok/s, finite logits); decode against prefill logits at every
   position of 1x64 tokens (atol 0.15, rtol 0.05); a reduced qwen3 on the
   card against the host's plain versions with the same params (fp32:
   logits within 1e-3 and equal greedy tokens; bf16: atol 0.15, rtol
   0.05); one prefill with a 1024 window at S=4096; ``torch.profiler``
   over one prefill call and 8 decode steps (kernel launches a call,
   device busy share of the wall, top kernels by device time).
4b. xlstm-125m serving at full width in bf16 with params drawn on the
   card: ``make_prefill_step`` at B=4, S=8192 (exactly 3 slstm_scan and no
   flash_attention launches a call; ms, tokens/s, peak memory); the serve
   launcher with ``--arch xlstm-125m --full-config`` (batch 8, 32 + 32
   tokens; decode tok/s, finite logits); at every position of 1x64
   tokens, fp32 decode against the per-step and the chunkwise mLSTM
   prefill (atol 1e-3), and the bf16 per-step prefill with the scan kernel
   against the same with the plain scan (atol 0.15, rtol 0.05); the bf16
   gaps between decode and the prefills are printed; a reduced xlstm
   on the card against the host's plain versions (fp32: logits within 1e-3
   and equal greedy tokens; bf16: atol 0.15, rtol 0.05); ``torch.profiler``
   over one prefill call and 8 decode steps.
5. The kernels' JSON line (each kernel's launches are those of the
   counted runs of the flat and the async path, also given by path), the
   card's line, and the result line.

``python3 chip_smoke.py --attention`` runs phase 1 and phase 2b only (the
flash-attention kernel's build report, checks and times), ``--scan`` phase
1 and phase 2c only (the sLSTM scan kernel's), and ``--agg`` phase 1 and
phase 2 only (the aggregation and update kernels'), and ``--round`` phase
1 and the quickstart scenario's global round alone (wall, launches and
device busy share a round, from the MLP's initial weights), and
``--async`` phase 1 and phase 3b; none of them prints a result line.

Exits 1 without printing a result when no CUDA device is present, and
fails at import when run outside a checkout of the repository.
"""
from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parent / "src"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12           # H100 SXM, fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12          # H100 SXM, dense bf16 tensor cores
SHAPES = (("main", 20, 4, 31_810), ("paper", 100, 10, 31_810),
          ("perception", 100, 10, 9_540_010))
TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-5, 2.0 ** -7)}
SOURCES = {"fused_agg_blend": "src/repro_torch/kernels/csrc/fused_agg_blend.cu",
           "weighted_agg_matmul":
               "src/repro_torch/kernels/csrc/fused_agg_blend.cu",
           "dual_proximal_sgd":
               "src/repro_torch/kernels/csrc/dual_proximal_sgd.cu",
           "flash_attention":
               "src/repro_torch/kernels/csrc/flash_attention.cu",
           "slstm_scan": "src/repro_torch/kernels/csrc/slstm_scan.cu"}
REPLACES = {"fused_agg_blend": "src/repro/kernels/masked_hier_agg.py:199",
            "weighted_agg_matmul": "src/repro/kernels/masked_hier_agg.py:86",
            "dual_proximal_sgd": "src/repro/kernels/dual_proximal_sgd.py:44",
            "flash_attention": "src/repro/kernels/flash_attention.py:93",
            "slstm_scan": "src/repro/kernels/slstm_scan.py:90"}
# (name, B, S, H, KV, D, causal, window); "layer" is qwen3-0.6b's; the
# two ragged D = 128 cases end one row past a 128-row tile and mid-tile
ATTN_CASES = (("small", 2, 200, 4, 2, 64, True, 0),
              ("layer", 1, 4096, 16, 8, 128, True, 0),
              ("layer_w1024", 1, 4096, 16, 8, 128, True, 1024),
              ("s129", 2, 129, 16, 8, 128, True, 0),
              ("s1000", 1, 1000, 16, 8, 128, False, 0))
PREFILL_B, PREFILL_S = 4, 8192
# (name, B, S, H, P, input scale): the JAX kernel tests' shapes, saturated
# gates, and "layer", xlstm-125m's (d = 768)
SLSTM_CASES = (("test_1", 1, 17, 2, 32, 1.0), ("test_2", 2, 100, 4, 64, 1.0),
               ("test_3", 3, 256, 4, 32, 1.0), ("test_4", 1, 64, 8, 16, 1.0),
               ("saturated", 2, 48, 4, 32, 25.0),
               ("layer", PREFILL_B, PREFILL_S, 4, 192, 1.0))
SLSTM_TOL = {1.0: (2e-5, 1e-5), 25.0: (5e-5, 1e-4)}    # (atol, rtol)


# phases a run goes through; a mode flag runs the build and one kernel's
# phase alone, with no result line (which only the full run prints)
FULL_RUN = ("1", "2", "2b", "2c", "3", "3b", "4", "4b", "5")
MODES = {"--attention": ("1", "2b"), "--scan": ("1", "2c"),
         "--agg": ("1", "2"), "--round": ("1", "3r"), "--async": ("1", "3b")}


def selected_phases(argv) -> tuple:
    """The phases that ``argv`` asks for: every phase, or one mode's."""
    unknown = [a for a in argv if a not in MODES]
    if unknown or len(argv) > 1:
        raise SystemExit(f"chip_smoke: usage: chip_smoke.py "
                         f"[{' | '.join(MODES)}], got {argv}")
    return MODES[argv[0]] if argv else FULL_RUN


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 11, inner: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back
    calls, bracketed by CUDA events, after a warm-up.  A call that takes
    over 100 ms is timed 3 times, one call each."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    if start.elapsed_time(end) > 100.0:
        reps, inner = 3, 1
    for _ in range(2):
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


def host_device_split(fn, n_host: int = 1000, n_prof: int = 20) -> dict:
    """Where a call's time goes: ``device_ms``, its kernels' device time a
    call over ``n_prof`` calls under ``torch.profiler`` (None when the
    profiler sees no device time), and ``host_us``, the host time a call of
    ``n_host`` calls enqueued without a synchronise, then one synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_host):
        fn()
    host_us = (time.perf_counter() - t0) / n_host * 1e6
    torch.cuda.synchronize()
    busy = device_profile(fn, n_prof)[2]
    return {"device_ms": busy / n_prof * 1e3 if busy else None,
            "host_us": host_us}


def host_us(fn, n: int = 1000) -> float:
    """Host time of one call of ``fn`` (no device work), mean of ``n``."""
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def bound(nbytes: float, flops: float,
          flops_per_s: float = FP32_FLOPS_PER_S):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def compare(got, want, dtype, what, tol=None):
    """Max |got - want|; raises unless |d| <= atol + rtol*|want| (``tol``
    (atol, rtol), else the dtype's)."""
    atol, rtol = tol or TOL[dtype]
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    excess = ((g - w).abs() - (atol + rtol * w.abs())).max().item()
    err = (g - w).abs().max().item()
    if excess > 0:
        raise AssertionError(f"{what}: kernel disagrees with the plain "
                             f"version (max abs err {err:.3e})")
    return err


def kernel_cases(dev, shape_name, A, R, N, dtype):
    """Every kernel entry at one shape and fleet dtype; returns result
    rows.  Launches made here are comparisons, not the main path's."""
    from repro_torch.core.aggregation import (build_weight_matrix,
                                              cohort_mass)
    from repro_torch.kernels import dual_proximal_sgd as dps
    from repro_torch.kernels import masked_hier_agg as mha
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(A * 7 + R)
    sx = torch.finfo(dtype).bits // 8
    x = torch.randn(A, N, device=dev, generator=gen).to(dtype)
    prev = torch.randn(R, N, device=dev, generator=gen).to(dtype)
    w = torch.rand(A, device=dev, generator=gen) + 0.5
    assign = torch.arange(A, device=dev) % R
    mask = torch.rand(A, device=dev, generator=gen) < 0.6   # the engine's
    mask[assign == 0] = False                     # RSU 0 keeps its row
    W = build_weight_matrix(w, mask, assign, R)
    mass = cohort_mass(w, mask, assign, R)
    coef = torch.stack([torch.zeros_like(mass), torch.ones_like(mass),
                        (mass > 0).float()], dim=1)
    dead = int((mass <= 0).sum())
    rows, small = [], A * 16 + R * A * 4

    def row(kernel, entry, err, ms, plain_ms, nbytes, flops, library_ms,
            **split):
        b_ms, b_by = bound(nbytes, flops)
        rows.append({"kernel": kernel, "entry": entry, "shape": shape_name,
                     "A": A, "R": R, "N": N, "dtype": str(dtype)[6:],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": library_ms, **split})

    def split(kernel_fn, library_fn, ms):
        n = 1000 if ms < 1.0 else 100
        k = host_device_split(kernel_fn, n)
        out = {"device_ms": k["device_ms"], "host_us": k["host_us"]}
        if library_fn is not None:
            lib = host_device_split(library_fn, n)
            out.update(library_device_ms=lib["device_ms"],
                       library_host_us=lib["host_us"])
        return out

    # fused_agg_blend, RSU layer: the whole agg_blend entry (one launch
    # that builds W, mass and the guard on the device), the same kernel
    # with its operands ready (the coef form), the plain two-pass version,
    # and one matmul + where.  Bytes: X, out, and prev's zero-mass rows
    # (a row with mass reads no prev)
    got, got_mass = mha.agg_blend(x, w, mask, assign, R, prev)
    want, _ = ref.agg_blend_ref(x, w, mask, assign, R, prev)
    err = compare(got, want, dtype, f"agg_blend {shape_name} {dtype}")
    if not torch.equal(got[0], prev[0]):
        raise AssertionError("agg_blend: a zero-mass row was not kept")
    mass_err = ((got_mass - mass).abs() / mass.abs().clamp_min(1e-30)).max()
    if mass_err > 1e-6:
        raise AssertionError(f"agg_blend: mass off by {mass_err:.3e} "
                             f"relative")

    def whole():
        return mha.agg_blend(x, w, mask, assign, R, prev)

    def blend():
        return mha._fused_agg_blend(coef, (W,), (x,), prev, entry="agg_blend")

    def blend_library():
        return torch.where((mass > 0)[:, None], torch.matmul(W, x.float()),
                           prev.float())
    agg_bytes = A * N * sx + (R + dead) * N * sx + A * 9 + R * 4
    plain_ms = cuda_ms(lambda: ref.agg_blend_ref(x, w, mask, assign, R, prev))
    library_ms = cuda_ms(blend_library)
    ms = cuda_ms(whole)
    row("fused_agg_blend", "agg_blend", err, ms, plain_ms, agg_bytes,
        2 * R * A * N, library_ms, **split(whole, blend_library, ms))
    err = compare(blend(), want, dtype, f"agg_blend coef {shape_name}")
    ms = cuda_ms(blend)
    row("fused_agg_blend", "agg_blend_coef", err, ms, plain_ms,
        agg_bytes + small, 2 * R * A * N, library_ms,
        **split(blend, None, ms))

    # fused_agg_blend, cloud layer: R -> 1 into fp32, the whole cloud_blend
    # entry and the coef form
    cloud = torch.randn(N, device=dev, generator=gen)
    rmass = torch.rand(R, device=dev, generator=gen)
    got = mha.cloud_blend(prev, rmass, cloud)
    want = ref.cloud_blend_ref(prev, rmass, cloud)
    # the plain version rounds the new cloud through the fleet dtype, as
    # the reference's does; the kernel writes the fp32 sum
    err = compare(got, want, dtype, f"cloud_blend {shape_name}")
    kept = mha.cloud_blend(prev, torch.zeros_like(rmass), cloud)
    if not torch.equal(kept, cloud):
        raise AssertionError("cloud_blend: zero total mass must keep prev")
    wn = (rmass / rmass.sum())[None, :]
    ccoef = torch.tensor([[0.0, 1.0, 1.0]], device=dev)

    def cloud_whole():
        return mha.cloud_blend(prev, rmass, cloud)

    def cloud_coef():
        return mha._fused_agg_blend(ccoef, (wn,), (prev,), cloud[None, :],
                                    entry="cloud_blend")

    def cloud_library():
        return torch.where(rmass.sum() > 0, torch.matmul(wn, prev.float())[0],
                           cloud)
    cloud_bytes = R * N * sx + N * 4 + R * 4
    plain_ms = cuda_ms(lambda: ref.cloud_blend_ref(prev, rmass, cloud))
    library_ms = cuda_ms(cloud_library)
    ms = cuda_ms(cloud_whole)
    row("fused_agg_blend", "cloud_blend", err, ms, plain_ms, cloud_bytes,
        2 * R * N, library_ms, **split(cloud_whole, cloud_library, ms))
    err = compare(cloud_coef()[0], want, dtype,
                  f"cloud_blend coef {shape_name}")
    ms = cuda_ms(cloud_coef)
    row("fused_agg_blend", "cloud_blend_coef", err, ms, plain_ms,
        cloud_bytes + 12, 2 * R * N, library_ms,
        **split(cloud_coef, None, ms))

    # fused_agg_blend, two pairs (agg_absorb): two cohorts + retained buf
    x2 = x.flip(0).contiguous()
    arrivals = [(x, w * mask), (x2, w)]
    bm = torch.rand(R, device=dev, generator=gen)
    got3 = mha.agg_absorb(arrivals, assign, R, prev, bm, keep=0.5)
    want3 = ref.agg_absorb_ref(arrivals, assign, R, prev, bm, keep=0.5)
    err = compare(got3[0], want3[0], dtype, f"agg_absorb {shape_name}")
    row("fused_agg_blend", "agg_absorb", err,
        cuda_ms(lambda: mha.agg_absorb(arrivals, assign, R, prev, bm,
                                       keep=0.5)),
        cuda_ms(lambda: ref.agg_absorb_ref(arrivals, assign, R, prev, bm,
                                           keep=0.5)),
        2 * A * N * sx + 2 * R * N * sx + 2 * small, 4 * R * A * N, None)
    del x2, arrivals, got3, want3

    # weighted_agg_matmul: the fused=False path's (R, A) @ (A, N)
    got = mha.weighted_agg_matmul(W, x)
    want = ref.weighted_agg_matmul_ref(W, x)
    err = compare(got, want, dtype, f"weighted_agg_matmul {shape_name}")
    def matmul():
        return mha.weighted_agg_matmul(W, x)

    def matmul_library():
        return torch.matmul(W, x.float())
    ms = cuda_ms(matmul)
    row("weighted_agg_matmul", "weighted_agg_matmul", err, ms,
        cuda_ms(lambda: ref.weighted_agg_matmul_ref(W, x)),
        A * N * sx + R * N * sx + R * A * 4, 2 * R * A * N,
        cuda_ms(matmul_library), **split(matmul, matmul_library, ms))
    if shape_name == "main":
        # the host time of the wrapper's pieces: the output's allocation,
        # the stream lookup (a Stream object or the raw handle) and, where
        # the kernel has its own matmul entry, the ctypes call and launch
        # with every operand ready
        from repro_torch.kernels import _lib
        out = torch.empty((R, N), dtype=dtype, device=dev)
        stream = torch._C._cuda_getCurrentRawStream(dev.index or 0)
        pieces = {
            "torch.empty": lambda: torch.empty((R, N), dtype=dtype,
                                               device=dev),
            "new_empty": lambda: x.new_empty((R, N)),
            "current_stream": lambda: torch.cuda.current_stream(
                dev).cuda_stream,
            "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(
                dev.index or 0),
        }
        if "repro_weighted_agg_matmul" in _lib._SIGNATURES:
            args = (W.data_ptr(), x.data_ptr(), out.data_ptr(), R, A, N,
                    3 if dtype == torch.bfloat16 else 0, stream)
            pieces["ctypes call and launch"] = (
                lambda: _lib.library().repro_weighted_agg_matmul(*args))
        print(f"host: {shape_name} {str(dtype)[6:]} launch-path pieces, us "
              f"a call: " + json.dumps({k: host_us(f)
                                        for k, f in pieces.items()}))
    del got, want, x, prev
    torch.cuda.empty_cache()

    # dual_proximal_sgd: fp32 w/g, anchors in the fleet dtype; the flat
    # engine's form (per-row live mask from active_steps and the step, the
    # broadcast cloud row, in place) and the TPU kernel's form (no scale,
    # full-shape anchors)
    wt = torch.randn(A, N, device=dev, generator=gen)
    g = torch.randn(A, N, device=dev, generator=gen) * 0.1
    a1 = torch.randn(A, N, device=dev, generator=gen).to(dtype)
    a2 = torch.randn(N, device=dev, generator=gen).to(dtype)
    active = torch.randint(0, 3, (A,), device=dev, generator=gen,
                           dtype=torch.int32)
    kw = dict(lr=0.1, mu1=0.01, mu2=0.005)
    got = dps.dual_proximal_sgd(wt, g, a1, a2, active_steps=active, step=1,
                                **kw)
    want = ref.dual_proximal_sgd_ref(wt, g, a1, a2, active_steps=active,
                                     step=1, **kw)
    err = compare(got, want, torch.float32, f"dual_proximal_sgd {shape_name}")
    if not torch.equal(got, dps.dual_proximal_sgd(
            wt, g, a1, a2, scale=(1 < active).float(), **kw)):
        raise AssertionError("dual_proximal_sgd: the active_steps form "
                             "differs from the scale form")
    del got, want

    def update():
        return dps.dual_proximal_sgd(wt, g, a1, a2, active_steps=active,
                                     step=1, out=wt, **kw)
    ms = cuda_ms(update)
    row("dual_proximal_sgd", "scaled_broadcast", err, ms,
        cuda_ms(lambda: ref.dual_proximal_sgd_ref(
            wt, g, a1, a2, active_steps=active, step=1, **kw)),
        A * N * (4 + 4 + sx + 4) + N * sx + A * 4, 8 * A * N, None,
        **split(update, None, ms))
    a2 = a2.expand(A, N).contiguous()
    got = dps.dual_proximal_sgd(wt, g, a1, a2, **kw)
    want = ref.dual_proximal_sgd_ref(wt, g, a1, a2, **kw)
    err = compare(got, want, torch.float32, f"dual_proximal_sgd full "
                  f"{shape_name}")
    del got, want
    row("dual_proximal_sgd", "tpu_form", err,
        cuda_ms(lambda: dps.dual_proximal_sgd(wt, g, a1, a2, out=wt, **kw)),
        cuda_ms(lambda: ref.dual_proximal_sgd_ref(wt, g, a1, a2, **kw)),
        A * N * (4 + 4 + 2 * sx + 4), 8 * A * N, None)
    del wt, g, a1, a2
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return rows


def quickstart_spec():
    from repro_torch.core.baselines import h2fed
    from repro_torch.core.heterogeneity import HeterogeneityModel
    from repro_torch.core.scenario import ScenarioSpec
    hp = h2fed(mu1=0.001, mu2=0.005, lar=4, lr=0.1)
    return ScenarioSpec(
        n_agents=20, n_rsus=4, batch=32, n_train=6_000, n_test=1_000,
        excluded_labels=(7, 8, 9), pretrain_frac=0.25, pretrain_target=0.62,
        partition="scenario_two", hp=hp,
        het=HeterogeneityModel(csr=0.3, scd=1, lar=hp.lar), rounds=10)


def timed_run(res, params, **kw):
    """run_scenario on the card with the launch counts set to 0 just
    before and read just after: (history, counts, seconds)."""
    from repro_torch.fedsim import run_scenario
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    final, hist = run_scenario(res, params, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    if hasattr(final, "cloud_params"):
        tensors = list(final.cloud_params.values())
    else:     # the async engine's buffers, in-flight ones included
        tensors = [final.cloud_flat, final.rsu_flat, final.agent_flat,
                   final.pending_x, final.rsu_mass, final.cloud_macc]
    for p in tensors:
        if not torch.isfinite(p.float()).all():
            raise AssertionError("non-finite model or buffer")
    if not all(0.0 <= a <= 1.0 for a in hist["acc"]):
        raise AssertionError(f"bad accuracy history {hist['acc']}")
    return final, hist, counts, seconds


def pretrained(dev, spec, what: str):
    """The biased OEM model of ``spec``'s recipe on the card: (resolved
    scenario, params, accuracy)."""
    from repro_torch.configs.mnist_mlp import CONFIG
    from repro_torch.fedsim import pretrain_to_target
    from repro_torch.models import mlp
    res = spec.resolve()
    params = mlp.init_params(CONFIG, torch.Generator().manual_seed(spec.seed),
                             device=dev)
    t0 = time.perf_counter()
    pre, pre_acc = pretrain_to_target(params, res.pretrain_pool, res.test.x,
                                      res.test.y,
                                      target_acc=spec.pretrain_target,
                                      max_epochs=10)
    print(f"{what}: pre-trained (biased) accuracy {pre_acc:.4f} "
          f"({time.perf_counter() - t0:.2f} s)")
    return res, pre, pre_acc


def main_path(dev):
    """Phase 3; returns the launch counts of each path's run."""
    from repro_torch.fedsim.simulator import round_draws
    from repro_torch.core.heterogeneity import init_conn_state

    spec = quickstart_spec()
    res, pre, pre_acc = pretrained(dev, spec, "main path")
    _, hist, counts, seconds = timed_run(res, pre)
    for r, a in zip(hist["round"], hist["acc"]):
        print(f"main path: global round {int(r):2d}: test acc {a:.4f}")
    n_steps = spec.hp.local_epochs * (res.fed.x.shape[1] // spec.batch)
    rounds, lar = spec.rounds, spec.hp.lar
    print(f"main path: {seconds / rounds * 1e3:.2f} ms per round "
          f"(wall, set-up and eval included); launches {counts} "
          f"(expect agg_blend {rounds * lar}, cloud_blend {rounds}, "
          f"dual_proximal_sgd {rounds * lar * n_steps})")
    want = {"agg_blend": rounds * lar, "cloud_blend": rounds,
            "dual_proximal_sgd": rounds * lar * n_steps}
    for k, v in want.items():
        if counts[k] != v:
            raise AssertionError(f"{k}: {counts[k]} launches, want {v}")
    paths = {"main": counts}

    # one 10-round realization at CSR 0.3 swings by +-0.1 from round to
    # round, so the gain is judged on the mean final accuracy of five
    # realizations (sim_seed 0-4, the first being the run above)
    finals = [float(hist["acc"][-1])]
    for sim_seed in range(1, 5):
        _, h, _, _ = timed_run(spec.replace(sim_seed=sim_seed).resolve(), pre)
        finals.append(float(h["acc"][-1]))
    mean_final = statistics.mean(finals)
    print(f"main path: final accuracy of sim_seed 0-4: {finals}, mean "
          f"{mean_final:.4f} vs pre-trained {pre_acc:.4f}")
    if mean_final < pre_acc + 0.05:
        raise AssertionError(f"mean final accuracy {mean_final:.4f} does not "
                             f"beat the pre-trained {pre_acc:.4f} by 0.05")

    res_bf16 = spec.replace(fleet_dtype="bfloat16", rounds=2).resolve()
    _, hist, c, seconds = timed_run(res_bf16, pre)
    print(f"bf16 fleet: acc {hist['acc'].tolist()} in {seconds:.2f} s, "
          f"launches {c}")
    if not (c["agg_blend"] and c["cloud_blend"] and c["dual_proximal_sgd"]):
        raise AssertionError(f"bf16 path missed a kernel: {c}")
    paths["bf16"] = c

    res_unfused = spec.replace(fused=False, rounds=1).resolve()
    _, hist, c, seconds = timed_run(res_unfused, pre)
    print(f"fused=False: acc {hist['acc'].tolist()} in {seconds:.2f} s, "
          f"launches {c}")
    if c["weighted_agg_matmul"] != lar + 1 or c["agg_blend"]:
        raise AssertionError(f"fused=False path launches: {c}")
    paths["unfused"] = c

    # the card against the host's plain versions, same injected draws
    res2 = spec.replace(rounds=2).resolve()
    spe = res2.fed.x.shape[1] // spec.batch
    gen, conn, draws = torch.Generator().manual_seed(5), init_conn_state(
        spec.n_agents), []
    for _ in range(2):
        rd = []
        for _ in range(lar):
            conn, mask, act = round_draws(gen, conn, spec.het, spec.hp,
                                          spec.n_agents, spe)
            rd.append((mask, act))
        draws.append(rd)
    fin_gpu, h_gpu, _, _ = timed_run(res2, pre, draws=draws)
    from repro_torch.fedsim import run_scenario
    fin_cpu, h_cpu = run_scenario(res2, {k: v.cpu() for k, v in pre.items()},
                                  device="cpu", draws=draws)
    err = max((fin_gpu.cloud_params[k].cpu() - fin_cpu.cloud_params[k])
              .abs().max().item() for k in fin_cpu.cloud_params)
    acc_err = float(abs(h_gpu["acc"] - h_cpu["acc"]).max())
    print(f"card vs host (plain versions), 2 rounds, same draws: cloud max "
          f"abs err {err:.3e} (limit 1e-4), accuracy diff {acc_err:.4f} "
          f"(limit 2e-3)")
    if err > 1e-4 or acc_err > 2e-3:
        raise AssertionError("the card's round disagrees with the host's")
    entry_launches(dev, res, round_profile(dev, res, pre))
    return paths


def round_profile(dev, res, params, n: int = 3,
                  what: str = "flat round (main path)"):
    """``n`` global rounds of the flat engine on ``res``'s scenario: wall a
    round on the host clock (synchronised, no profiler), then the same
    rounds under ``torch.profiler`` (launches and device busy share a
    round).  Returns the state after them."""
    from repro_torch.core.flatten import spec_of
    from repro_torch.fedsim.simulator import (_make_flat_round_body,
                                              init_flat_state)
    s = res.spec
    fspec = spec_of(params, storage_dtype=s.fleet_dtype)
    round_fn = _make_flat_round_body(res.cfg, s.hp, s.het, res.fed, fspec,
                                     device=dev, fused=s.fused)
    state = [round_fn(init_flat_state(res.cfg, fspec, params, dev))]

    def one_round():
        state[0] = round_fn(state[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        one_round()
    torch.cuda.synchronize()
    print(f"round: {(time.perf_counter() - t0) / n * 1e3:.2f} ms a global "
          f"round (host clock, synchronised, {n} rounds, eval excluded)")
    print_profile(what, n, *device_profile(one_round, n))
    return state[0]


def flat_round(dev) -> None:
    """``--round``: the quickstart scenario's global round alone, from
    the MLP's initial weights (no pre-training)."""
    from repro_torch.configs.mnist_mlp import CONFIG
    from repro_torch.models import mlp
    spec = quickstart_spec()
    params = mlp.init_params(CONFIG, torch.Generator().manual_seed(spec.seed),
                             device=dev)
    round_profile(dev, spec.resolve(), params, n=10)


def entry_launches(dev, res, st) -> None:
    """One launch a call: 20 calls each of ``agg_blend``, ``cloud_blend``
    and ``dual_proximal_sgd`` on the round's own buffers under
    ``torch.profiler``."""
    from repro_torch.kernels import ops
    s = res.spec
    A, R = res.cfg.n_agents, res.cfg.n_rsus
    assign = torch.from_numpy(res.fed.rsu_assign).to(dev, torch.long)
    weights = torch.from_numpy(np.asarray(res.fed.n_per_agent,
                                          np.float32)).to(dev)
    mask = torch.arange(A, device=dev) % 3 != 0
    active = torch.full((A,), 2, dtype=torch.int32, device=dev)
    rsu_mass = torch.rand(R, device=dev)
    w = st.agent_flat.float().clone()
    g = torch.randn_like(w)
    hp = s.hp
    # (entry, its kernel's symbol, the call)
    calls = (
        ("agg_blend", "agg_blend_ring_kernel",
         lambda: ops.agg_blend(st.agent_flat, weights, mask, assign, R,
                               st.rsu_flat)),
        ("cloud_blend", "agg_blend_ring_kernel",
         lambda: ops.cloud_blend(st.rsu_flat, rsu_mass, st.cloud_flat)),
        ("dual_proximal_sgd", "dual_proximal_sgd_kernel",
         lambda: ops.dual_proximal_sgd(
             w, g, st.agent_flat, st.cloud_flat, lr=hp.lr, mu1=hp.mu1,
             mu2=hp.mu2, active_steps=active, step=1, out=w)))
    n = 20
    for name, symbol, fn in calls:
        fn()
        before = ops.launch_counts()[name]
        _, launches, _, _, runs = device_profile(fn, n)
        counted = ops.launch_counts()[name] - before
        print(f"profile: {n} {name} calls: {counted} wrapper launches, "
              f"{launches} host-API launches, device activity {runs}")
        # one launch a call: the wrapper launched its kernel once a call,
        # the host API saw no other launch, and whatever device activity
        # the profiler recorded is that kernel (it does not always record
        # the device side of a kernel launched from the ctypes library)
        if (counted != n or launches != n
                or any(symbol not in k for k in runs)):
            raise AssertionError(f"{name}: want one launch of {symbol} a "
                                 f"call and no other device work")


ASYNC_ROUNDS = 30


def straggler_specs():
    """Phase 3b's scenarios: the quickstart fleet in the 90%-disconnect
    regime of ``benchmarks/async_round.py`` (its defaults: max_delay 2,
    delay_p 0.6, staleness decay 0.5, buffer keep 0.5).  Async connects at
    CSR 0.25, so CSR x P(d = 0) = 0.1 arrive on time, as the flat engine's
    CSR 0.1; 30 rounds (after 10 the plain route's async mean is still
    below the pre-trained model, after 30 it is above it, PERF.md)."""
    import dataclasses
    from repro_torch.core.heterogeneity import HeterogeneityModel
    spec = quickstart_spec().replace(rounds=ASYNC_ROUNDS)
    lar = spec.hp.lar
    het = HeterogeneityModel(csr=0.25, scd=1, lar=lar, max_delay=2,
                             delay_p=0.6)
    flat = spec.replace(het=dataclasses.replace(spec.het, csr=0.1))
    return spec.replace(engine="async", het=het, staleness_decay=0.5,
                        buffer_keep=0.5, cloud_every=0), flat


def fault_plan():
    """Every fault kind on 2 rounds of 4 ticks: churn, an outage of RSU 1
    over ticks 2-4 that recovers on tick 5, NaN poison, byzantine scale
    caught by the norm clip, and stale replay."""
    from repro_torch.core.faults import (ChurnWindow, CorruptSpec, FaultPlan,
                                         RsuOutage)
    return FaultPlan(
        churn=(ChurnWindow(frac=0.25, start=1, stop=6, seed=1),),
        outages=(RsuOutage(rsu=1, start=2, stop=5),),
        corrupt=(CorruptSpec(kind="nan", frac=0.2),
                 CorruptSpec(kind="scale", frac=0.2, scale=1e4, seed=2),
                 CorruptSpec(kind="stale", frac=0.2, seed=3)),
        norm_clip=50.0, seed=4)


def card_draws(dev, spec, res, n_rounds):
    """The card's own per-tick draws for ``n_rounds`` rounds of ``spec``
    (a CUDA generator): draws[round][tick] = (mask, active_steps,
    delays) on the card."""
    from repro_torch.core.heterogeneity import init_conn_state, sample_latency
    from repro_torch.fedsim.simulator import round_draws
    A = spec.n_agents
    spe = res.fed.x.shape[1] // spec.batch
    gen = torch.Generator(device=dev).manual_seed(5)
    conn, out = init_conn_state(A, dev), []
    for _ in range(n_rounds):
        rd = []
        for _ in range(spec.hp.lar):
            conn, mask, act = round_draws(gen, conn, spec.het, spec.hp, A, spe)
            rd.append((mask, act, sample_latency(gen, A, spec.het, dev)))
        out.append(rd)
    return out


def _state_diff(card, host, fields, what):
    """Max |card - host| over ``fields``; raises past (atol, rtol), or on
    any difference for an exact field (atol None)."""
    errs = {}
    for name, (atol, rtol) in fields.items():
        g = getattr(card, name).cpu().float()
        w = getattr(host, name).float()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{what}: non-finite {name} on the card")
        errs[name] = (g - w).abs().max().item()
        if atol is None:
            if not torch.equal(g, w):
                raise AssertionError(f"{what}: {name} differs ({errs[name]})")
        elif ((g - w).abs() > atol + rtol * w.abs()).any():
            raise AssertionError(f"{what}: {name} off by {errs[name]:.3e} "
                                 f"(atol {atol}, rtol {rtol})")
    return errs


def _to_host(state):
    """An async state's tensors moved to the host (for the next tick)."""
    from repro_torch.core.heterogeneity import ConnState
    return state._replace(
        conn=ConnState(state.conn.remaining.cpu()),
        gen=torch.Generator().manual_seed(0),
        **{k: getattr(state, k).cpu() for k in (
            "agent_flat", "rsu_flat", "rsu_mass", "cloud_flat", "pending_x",
            "pending_w", "pending_t", "cloud_macc")})


def async_card_vs_host(dev, spec, pre, what, faults=None):
    """2 rounds of ``spec`` on the card against the same rounds on the
    host (plain versions), the card's own draws replayed on both, every
    buffer compared after every round.  fp32: the two rounds run on,
    buffers within 1e-5.  bf16: rounds of one tick, each from the card's
    state (a one-ulp difference of a stored row may flip a hidden ReLU
    unit of an agent that trains from it), buffers within one bf16 ulp.
    In-flight weights and tick counts exactly equal; with ``faults`` also
    the quarantine counts and blocked masses.  Returns the card's launch
    counts."""
    import dataclasses
    from repro_torch.core import faults as faults_mod
    from repro_torch.core.flatten import spec_of
    from repro_torch.fedsim import async_engine as ae
    from repro_torch.kernels import ops
    bf16 = spec.fleet_dtype == "bfloat16"
    lar = 1 if bf16 else spec.hp.lar
    s = spec.replace(hp=dataclasses.replace(spec.hp, lar=lar),
                     het=dataclasses.replace(spec.het, lar=lar),
                     rounds=2 * spec.hp.lar // lar, faults=faults)
    res = s.resolve()
    acfg = ae.AsyncConfig(staleness_decay=s.staleness_decay,
                          schedule=s.schedule, buffer_keep=s.buffer_keep,
                          cloud_every=s.cloud_every).validate()
    fspec = spec_of(pre, storage_dtype=s.fleet_dtype)
    host_pre = {k: v.cpu() for k, v in pre.items()}
    body = {d: ae.make_async_global_round(
        res.cfg, s.hp, s.het, res.fed, fspec, acfg, device=d, fused=s.fused,
        faults=faults) for d in (dev, "cpu")}
    card = ae.init_async_state(res.cfg, fspec, pre, dev)
    host = ae.init_async_state(res.cfg, fspec, host_pre, "cpu")
    draws = card_draws(dev, s, res, s.rounds)
    sched = None if faults is None else faults.lower(
        s.n_agents, s.n_rsus, s.rounds * lar)
    fields = {k: ((2 ** -9, 2 ** -7) if bf16 else (1e-5, 1e-5)) for k in (
        "agent_flat", "rsu_flat", "pending_x", "cloud_flat")}
    fields.update(rsu_mass=(0.0, 1e-5), cloud_macc=(0.0, 1e-5),
                  pending_w=(None, None), pending_t=(None, None))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    q, blocked, errs = [], [], {}
    for r in range(s.rounds):
        if bf16 and r:
            host = _to_host(card)
        fr = [None, None] if sched is None else [
            faults_mod.round_tensors(sched, r, lar, d) for d in (dev, "cpu")]
        card, cm = body[dev](card, draws[r], fr[0])
        host, hm = body["cpu"](host, [tuple(t.cpu() for t in tick)
                                      for tick in draws[r]], fr[1])
        for k in cm:
            g, w = cm[k].cpu(), hm[k]
            if k == "quarantined" or k == "blocked_mass":
                if not torch.equal(g, w):
                    raise AssertionError(f"{what}: {k} {g} vs {w}")
            elif not torch.allclose(g.float(), w.float(), rtol=1e-5, atol=0):
                raise AssertionError(f"{what}: metric {k} {g} vs {w}")
        if faults is not None:
            q.append(int(cm["quarantined"].sum()))
            blocked.append(float(cm["blocked_mass"].sum()))
        for k, v in _state_diff(card, host, fields,
                                f"{what}, round {r + 1}").items():
            errs[k] = max(errs.get(k, 0.0), v)
        if card.tick != host.tick:
            raise AssertionError(f"{what}: tick {card.tick} vs {host.tick}")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    extra = "" if faults is None else (f"; quarantined a round {q}, blocked "
                                       f"mass {blocked} (card == host)")
    print(f"async card vs host ({what}): max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"{extra}; launches {counts}")
    return counts


def async_round_profile(dev, spec, params, what, n: int = 3):
    """``n`` async rounds of ``spec``: wall a round on the host clock,
    then under ``torch.profiler`` (launches, device busy share)."""
    from repro_torch.core.flatten import spec_of
    from repro_torch.fedsim import async_engine as ae
    res = spec.resolve()
    acfg = ae.AsyncConfig(staleness_decay=spec.staleness_decay,
                          buffer_keep=spec.buffer_keep,
                          cloud_every=spec.cloud_every).validate()
    fspec = spec_of(params, storage_dtype=spec.fleet_dtype)
    round_fn = ae.make_async_global_round(res.cfg, spec.hp, spec.het,
                                          res.fed, fspec, acfg, device=dev,
                                          fused=spec.fused)
    state = [round_fn(ae.init_async_state(res.cfg, fspec, params, dev))[0]]

    def one_round():
        state[0] = round_fn(state[0])[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        one_round()
    torch.cuda.synchronize()
    print(f"round: {what}: {(time.perf_counter() - t0) / n * 1e3:.2f} ms a "
          f"global round (host clock, synchronised, {n} rounds, eval "
          f"excluded)")
    print_profile(what, n, *device_profile(one_round, n))
    return state[0]


def absorb_launches(dev, st) -> None:
    """One launch of kernel #1 an ``agg_absorb`` call: 20 calls on an
    async round's own buffers under ``torch.profiler``; also what the
    weight building in small PyTorch ops around it costs a call."""
    from repro_torch.kernels import ops
    A, R = st.agent_flat.shape[0], st.rsu_flat.shape[0]
    assign = torch.arange(A, device=dev) % R
    w_imm = torch.rand(A, device=dev) * (torch.arange(A, device=dev) % 2)
    w_due = torch.rand(A, device=dev) * (torch.arange(A, device=dev) % 3 == 0)

    def call():
        return ops.agg_absorb(((st.agent_flat, w_imm), (st.pending_x, w_due)),
                              assign, R, st.rsu_flat, st.rsu_mass, keep=0.5)
    n = 20
    call()
    before = ops.launch_counts()["agg_absorb"]
    _, launches, busy, kernels, runs = device_profile(call, n)
    counted = ops.launch_counts()["agg_absorb"] - before
    ring = {k: v for k, v in runs.items() if "agg_blend_ring_kernel" in k}
    ring_s = sum(v for k, v in kernels.items() if "agg_blend_ring_kernel" in k)
    split = host_device_split(call, 1000)
    print(f"profile: {n} agg_absorb calls (A={A}, R={R}): {counted} wrapper "
          f"launches, ring kernel executions {sum(ring.values())}, "
          f"{launches / n:.0f} host-API launches a call (the weights, masses "
          f"and coef built in small PyTorch ops), device time a call: ring "
          f"{ring_s / n * 1e6:.2f} us, other {(busy - ring_s) / n * 1e6:.2f} "
          f"us; host time a call {split['host_us']:.1f} us")
    if counted != n or sum(ring.values()) != n:
        raise AssertionError("agg_absorb: want one launch of the ring kernel "
                             "a call")


def async_path(dev):
    """Phase 3b; returns the launch counts of the fused and the
    ``fused=False`` async runs."""
    from repro_torch.core.faults import FaultPlan
    from repro_torch.fedsim import run_scenario
    a_spec, f_spec = straggler_specs()
    res, pre, pre_acc = pretrained(dev, a_spec, "async path")
    _, hist, counts, seconds = timed_run(res, pre)
    rounds, lar = a_spec.rounds, a_spec.hp.lar
    n_steps = a_spec.hp.local_epochs * (res.fed.x.shape[1] // a_spec.batch)
    want = {"agg_absorb": rounds * lar, "cloud_blend": rounds,
            "dual_proximal_sgd": rounds * lar * n_steps, "agg_blend": 0,
            "weighted_agg_matmul": 0, "scatter_accumulate": 0}
    print(f"async path: {seconds / rounds * 1e3:.2f} ms per round (wall, "
          f"set-up and eval included); launches {counts} (expect {want}); "
          f"absorbed mass a round {hist['absorbed_mass'].tolist()}, pending "
          f"{hist['pending_mass'].tolist()}")
    for k, v in want.items():
        if counts[k] != v:
            raise AssertionError(f"async {k}: {counts[k]} launches, want {v}")
    paths = {"main": counts}
    finals = {"async": [float(hist["acc"][-1])], "flat": []}
    for sim_seed in range(5):
        if sim_seed:
            _, h, _, _ = timed_run(a_spec.replace(sim_seed=sim_seed).resolve(),
                                   pre)
            finals["async"].append(float(h["acc"][-1]))
        _, h, _, _ = timed_run(f_spec.replace(sim_seed=sim_seed).resolve(), pre)
        finals["flat"].append(float(h["acc"][-1]))
    means = {k: statistics.mean(v) for k, v in finals.items()}
    print(f"async path: 90% disconnected, {rounds} rounds, final accuracy of "
          f"sim_seed 0-4: async {finals['async']} mean {means['async']:.4f}; "
          f"flat at CSR 0.1 {finals['flat']} mean {means['flat']:.4f}; "
          f"pre-trained {pre_acc:.4f}")
    if means["async"] < pre_acc:
        raise AssertionError(f"async mean final accuracy {means['async']:.4f}"
                             f" below the pre-trained {pre_acc:.4f}")

    # the card against the host, the card's draws replayed on both
    async_card_vs_host(dev, a_spec, pre, "fp32")
    async_card_vs_host(dev, a_spec.replace(fleet_dtype="bfloat16"), pre,
                       "bf16, one tick a round")
    c = async_card_vs_host(dev, a_spec.replace(fused=False), pre,
                           "fused=False")
    want = {"agg_absorb": 0, "cloud_blend": 0,
            "scatter_accumulate": 4 * lar, "weighted_agg_matmul": 2}
    if any(c[k] != v for k, v in want.items()):
        raise AssertionError(f"fused=False async launches {c}, want {want}")
    paths["unfused"] = c
    c = async_card_vs_host(dev, a_spec.replace(cloud_every=3), pre,
                           "cloud_every=3")
    if c["cloud_blend"] != 2 * lar // 3:
        raise AssertionError(f"cloud_every=3: {c['cloud_blend']} cloud "
                             f"launches, want {2 * lar // 3}")

    # faults: an empty plan is faults=None bit for bit on both engines;
    # under every fault kind the card agrees with the host
    for engine, spec in (("flat", quickstart_spec()), ("async", a_spec)):
        spec = spec.replace(rounds=2)
        runs = [run_scenario(spec.replace(faults=f).resolve(), pre)
                for f in (None, FaultPlan())]
        if engine == "flat":
            pairs = [(runs[0][0].cloud_params[k], runs[1][0].cloud_params[k])
                     for k in runs[0][0].cloud_params]
        else:
            pairs = [(getattr(runs[0][0], k), getattr(runs[1][0], k))
                     for k in ("agent_flat", "rsu_flat", "cloud_flat",
                               "pending_x", "pending_w", "rsu_mass")]
        if not all(torch.equal(a, b) for a, b in pairs):
            raise AssertionError(f"{engine}: an empty plan differs from "
                                 f"faults=None")
        print(f"faults: {engine}, empty plan == faults=None bit for bit on "
              f"the card")
    async_card_vs_host(dev, a_spec, pre, "every fault kind",
                       faults=fault_plan())
    flat_faults_card_vs_host(dev, pre)

    # launches, device busy share and wall a round, async beside flat, at
    # the main (A=20, R=4) and paper (A=100, R=10) fleets
    for fleet, A, R in (("main", 20, 4), ("paper", 100, 10)):
        a = a_spec.replace(n_agents=A, n_rsus=R)
        round_profile(dev, f_spec.replace(n_agents=A, n_rsus=R).resolve(),
                      pre, what=f"flat round ({fleet} fleet, A={A}, R={R})")
        st = async_round_profile(dev, a, pre, f"async round ({fleet} fleet, "
                                 f"A={A}, R={R})")
        absorb_launches(dev, st)
    return paths


def flat_faults_card_vs_host(dev, pre) -> None:
    """2 flat rounds under every fault kind, card against host, the same
    draws: quarantine counts equal, buffers within 1e-5, cloud finite."""
    from repro_torch.fedsim import run_scenario
    spec = quickstart_spec().replace(rounds=2, faults=fault_plan())
    res = spec.resolve()
    draws = [[(m, a) for m, a, _ in rd]
             for rd in card_draws(dev, spec, res, 2)]
    fin, h = run_scenario(res, pre, draws=draws)
    host, hh = run_scenario(res, {k: v.cpu() for k, v in pre.items()},
                            device="cpu", draws=[[tuple(t.cpu() for t in x)
                                                  for x in rd]
                                                 for rd in draws])
    err = max((fin.cloud_params[k].cpu() - host.cloud_params[k]).abs().max()
              .item() for k in host.cloud_params)
    finite = all(torch.isfinite(v).all() for v in fin.cloud_params.values())
    print(f"faults: flat, every fault kind, card vs host: quarantined "
          f"{h['quarantined'].tolist()} vs {hh['quarantined'].tolist()}, "
          f"cloud max abs err {err:.3e} (limit 1e-5), finite {finite}")
    if (h["quarantined"].tolist() != hh["quarantined"].tolist() or err > 1e-5
            or not finite or not h["quarantined"].sum()):
        raise AssertionError("flat round under faults: card and host "
                             "disagree")


def live_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks keep: keys t < S, t <= s when causal,
    t > s - window when window > 0."""
    total = 0
    for s in range(S):
        hi = s if causal else S - 1
        lo = max(0, s - window + 1) if window else 0
        total += hi - lo + 1
    return total


def attention_bound(B, S, H, KV, D, causal, window, dtype):
    """(bound ms, bound_by): q, k, v read and out written once; 4*D flops
    per live pair and head (QK^T and PV), at the dtype's peak."""
    sx = torch.finfo(dtype).bits // 8
    nbytes = (2 * B * S * H * D + 2 * B * S * KV * D) * sx
    flops = 4 * B * H * D * live_pairs(S, causal, window)
    peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    return bound(nbytes, flops, peak)


def sdpa_call(q, k, v, causal, window):
    """One ``scaled_dot_product_attention`` call on the same inputs (the
    library yardstick, timed only); k/v repeated to H heads first."""
    import torch.nn.functional as F
    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2)
    if not window:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=causal)
    S = q.shape[1]
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] > pos[:, None] - window
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask)


def attention_cases(dev):
    """Phase 2b; returns result rows.  Launches made here are comparisons,
    not the serving path's."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    rows = []
    for name, B, S, H, KV, D, causal, window in ATTN_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device=dev).manual_seed(S + H)
            q, k, v = (torch.randn(B, S, n, D, device=dev,
                                   generator=gen).to(dtype)
                       for n in (H, KV, KV))
            kw = dict(causal=causal, window=window)
            got = fa.flash_attention(q, k, v, **kw)
            want = ref.flash_attention_ref(q, k, v, **kw)
            err = compare(got, want, dtype, f"flash_attention {name} {dtype}")
            del got, want
            b_ms, b_by = attention_bound(B, S, H, KV, D, causal, window,
                                         dtype)
            rows.append({
                "kernel": "flash_attention", "entry": name,
                "shape": {"B": B, "S": S, "H": H, "KV": KV, "D": D,
                          "causal": causal, "window": window},
                "dtype": str(dtype)[6:], "max_abs_err": err,
                "ms": cuda_ms(lambda: fa.flash_attention(q, k, v, **kw)),
                "plain_ms": cuda_ms(
                    lambda: ref.flash_attention_ref(q, k, v, **kw)),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": cuda_ms(sdpa_call(q, k, v, causal, window))})
            print("kernel " + json.dumps(rows[-1]))
            del q, k, v
            torch.cuda.empty_cache()
    # the serving path's shape (B=4, S=8192): the plain version runs one
    # batch row at a time (about 4.3 GB of fp32 scores a row, some 13-17 GB
    # with its intermediates), against the kernel's output at full B
    B, S, H, KV, D = PREFILL_B, PREFILL_S, 16, 8, 128
    gen = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(B, S, n, D, device=dev, generator=gen).to(
        torch.bfloat16) for n in (H, KV, KV))

    def plain_by_row():
        return torch.cat([ref.flash_attention_ref(q[b:b + 1], k[b:b + 1],
                                                  v[b:b + 1])
                          for b in range(B)])
    got = fa.flash_attention(q, k, v)
    err = max(compare(got[b:b + 1], ref.flash_attention_ref(
        q[b:b + 1], k[b:b + 1], v[b:b + 1]), torch.bfloat16,
        f"flash_attention prefill row {b}") for b in range(B))
    del got
    torch.cuda.empty_cache()
    b_ms, b_by = attention_bound(B, S, H, KV, D, True, 0, torch.bfloat16)
    rows.append({
        "kernel": "flash_attention", "entry": "prefill",
        "shape": {"B": B, "S": S, "H": H, "KV": KV, "D": D, "causal": True,
                  "window": 0},
        "dtype": "bfloat16", "max_abs_err": err,
        "ms": cuda_ms(lambda: fa.flash_attention(q, k, v), reps=5, inner=2),
        "plain_ms": cuda_ms(plain_by_row), "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": cuda_ms(sdpa_call(q, k, v, True, 0), reps=5, inner=2)})
    print("kernel " + json.dumps(rows[-1]))
    del q, k, v
    torch.cuda.empty_cache()
    return rows


def slstm_inputs(dev, B, S, H, P, r_dtype, scale=1.0, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = H * P
    wx = torch.randn(B, S, 4 * d, device=dev, generator=gen) * scale
    r = (torch.randn(H, P, 4 * P, device=dev, generator=gen)
         * P ** -0.5).to(r_dtype)
    b = torch.randn(4 * d, device=dev, generator=gen) * 0.1
    return wx, r, b


def slstm_cases(dev):
    """Phase 2c; returns result rows.  Launches made here are comparisons,
    not the serving path's."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import slstm_scan as ss

    rows = []
    for name, B, S, H, P, scale in SLSTM_CASES:
        for r_dtype in (torch.bfloat16, torch.float32):
            wx, r, b = slstm_inputs(dev, B, S, H, P, r_dtype, scale, seed=S)
            got = ss.slstm_scan(wx, r, b)
            want = ref.slstm_scan_ref(wx, r, b)
            err = compare(got, want, torch.float32,
                          f"slstm_scan {name} {r_dtype}", SLSTM_TOL[scale])
            del got, want
            d = H * P
            nbytes = (B * S * 4 * d + B * S * d + 4 * d) * 4 \
                + r.numel() * r.element_size()
            b_ms, b_by = bound(nbytes, 2 * B * S * d * 4 * P)
            row = {"kernel": "slstm_scan", "entry": name,
                   "shape": {"B": B, "S": S, "H": H, "P": P, "scale": scale},
                   "r_dtype": str(r_dtype)[6:], "plan": ss.plan(d, P, r_dtype),
                   "max_abs_err": err,
                   "ms": cuda_ms(lambda: ss.slstm_scan(wx, r, b)),
                   "plain_ms": cuda_ms(lambda: ref.slstm_scan_ref(wx, r, b),
                                       reps=3, inner=1),
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
            if name == "layer":
                # the same S steps at the smallest width the kernel runs
                fw, fr, fb = slstm_inputs(dev, 1, S, 1, 8, r_dtype)
                row["latency_floor_ms"] = cuda_ms(
                    lambda: ss.slstm_scan(fw, fr, fb))
                row["us_per_step"] = row["ms"] / S * 1e3
            rows.append(row)
            print("kernel " + json.dumps(row))
            del wx, r, b
    torch.cuda.empty_cache()
    return rows


def device_profile(fn, n: int):
    """``fn`` run ``n`` times under ``torch.profiler``: (wall s, kernel
    launches the host API saw, device busy s, {kernel: device s},
    {device activity: executions}).  Wall includes the profiler's own
    cost."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, runs, launches = {}, {}, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            kernels[e.key] = e.self_device_time_total / 1e6
            runs[e.key] = e.count
        elif e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            launches += e.count
    return wall, launches, sum(kernels.values()), kernels, runs


def print_profile(what: str, n: int, wall, launches, busy, kernels,
                  runs) -> None:
    if not busy:
        print(f"profile: {what}: the profiler saw no device time (not "
              f"measured)")
        return
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    print(f"profile: {what}: {wall / n * 1e3:.2f} ms wall a call, "
          f"{launches / n:.0f} kernel launches a call (host API), "
          f"{sum(runs.values()) / n:.0f} device executions a call, device "
          f"busy {busy / wall:.1%} of wall; top kernels by device time: "
          + "; ".join(f"{k[:60]} {v / busy:.1%}" for k, v in top))


def _logits_check(got, want, what, atol, rtol):
    """Max |got - want| of fp32 logits; raises unless finite and
    |d| <= atol + rtol*|want|."""
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{what}: non-finite logits")
    d = (g - w).abs()
    if (d > atol + rtol * w.abs()).any():
        raise AssertionError(f"{what}: max abs diff {d.max().item():.3e} "
                             f"exceeds atol {atol} + rtol {rtol}")
    return d.max().item()


def serving_path(dev):
    """Phase 4; returns the flash_attention launches of the counted
    prefill call."""
    from repro_torch.configs.registry import get_config, get_reduced_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import model as M
    from repro_torch import tree

    cfg = get_config("qwen3-0.6b")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree.leaves(params))
    print(f"serving: qwen3-0.6b full width, {n_params} params "
          f"({cfg.param_dtype}), drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s")

    # prefill at B=4, S=8192: one counted call, then timed calls
    prefill = make_prefill_step(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S),
                           device=dev, generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    logits = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    counts = prefill_counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    if counts["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"prefill: {counts['flash_attention']} "
                             f"flash_attention launches, want "
                             f"{cfg.n_layers}")
    if (tuple(logits.shape) != (PREFILL_B, cfg.vocab_size)
            or not torch.isfinite(logits).all()):
        raise AssertionError(f"prefill: bad logits {tuple(logits.shape)}")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = statistics.median(times) * 1e3
    print(f"serving: prefill B={PREFILL_B} S={PREFILL_S}: {ms:.1f} ms a call "
          f"(median of 3, host clock), "
          f"{PREFILL_B * PREFILL_S / ms * 1e3:.0f} tokens/s, peak memory "
          f"{peak / 2**30:.2f} GiB, launches {counts}")
    prof = device_profile(lambda: prefill(params, {"tokens": tokens}), 1)
    print_profile(f"prefill B={PREFILL_B} S={PREFILL_S}", 1, *prof)
    attn = sum(v for k, v in prof[3].items() if "flash_attention" in k)
    if prof[2]:
        print(f"profile: prefill: flash_attention kernels {attn * 1e3:.1f} "
              f"ms of {prof[2] * 1e3:.1f} ms device time "
              f"({attn / prof[2]:.1%})")
    del tokens, logits
    torch.cuda.empty_cache()

    # the serve launcher at its defaults, full width (decode path: no
    # flash_attention launch)
    ops.reset_launch_counts()
    res = serve.main(["--full-config"])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(f"serving: serve launcher --full-config: decode "
          f"{res['tok_per_s']:.1f} tok/s, launches {counts}")
    if not torch.isfinite(res["logits"]).all():
        raise AssertionError("serve: non-finite logits")

    # decode == prefill at every position, full width (1 x 64 tokens)
    s = 64
    toks = torch.randint(0, cfg.vocab_size, (1, s), device=dev,
                         generator=gen)
    with torch.no_grad():
        full, _ = M.forward(cfg, params, {"tokens": toks})
        cache = M.init_cache(cfg, 1, s, device=dev)
        outs = []
        for t in range(s):
            lg, cache = M.decode_step(cfg, params, cache, toks[:, t:t + 1],
                                      torch.tensor([t], dtype=torch.int32,
                                                   device=dev))
            outs.append(lg[:, 0])
    err = _logits_check(torch.stack(outs, 1), full, "decode vs prefill",
                        0.15, 0.05)
    print(f"serving: decode vs prefill logits, 1x{s} tokens, full width: "
          f"max abs diff {err:.4f} (limit 0.15 + 0.05|logit|)")
    del full, cache, outs

    # where a decode step's time goes: batch 8, as the serve launcher
    B, n = 8, 8
    step = make_serve_step(cfg, device=dev)
    cache = M.init_cache(cfg, B, 2 * n, device=dev)
    tok = torch.randint(0, cfg.vocab_size, (B, 1), device=dev, generator=gen)
    pos = [0]

    def decode_once():
        nonlocal cache
        _, cache = step(params, cache, tok, torch.full(
            (B,), pos[0], dtype=torch.int32, device=dev))
        pos[0] += 1
    decode_once()
    print_profile(f"decode step, batch {B}", n, *device_profile(decode_once,
                                                                 n))
    del cache

    # one prefill with a 1024 window at S=4096
    wcfg = cfg.replace(attn_window=1024)
    wtoks = torch.randint(0, cfg.vocab_size, (1, 4096), device=dev,
                          generator=gen)
    ops.reset_launch_counts()
    wlogits = make_prefill_step(wcfg, device=dev)(params, {"tokens": wtoks})
    torch.cuda.synchronize()
    if (ops.launch_counts()["flash_attention"] != cfg.n_layers
            or not torch.isfinite(wlogits).all()):
        raise AssertionError("window prefill: launches or logits wrong")
    print(f"serving: window 1024 prefill at S=4096: "
          f"{cfg.n_layers} launches, finite logits")
    del params
    torch.cuda.empty_cache()

    # a reduced qwen3 on the card against the host's plain versions
    for dtype, atol, rtol in (("float32", 1e-3, 0.0),
                              ("bfloat16", 0.15, 0.05)):
        rcfg = get_reduced_config("qwen3-0.6b").replace(dtype=dtype,
                                                        param_dtype=dtype)
        host = M.init_params(rcfg, torch.Generator().manual_seed(3),
                             device="cpu")
        card = tree.map_tree(lambda t: t.to(dev), host)
        ptoks = torch.from_numpy(np.random.default_rng(4).integers(
            0, rcfg.vocab_size, (2, 48)))
        lg_card = make_prefill_step(rcfg, device=dev)(card, {"tokens": ptoks})
        lg_host = make_prefill_step(rcfg, device="cpu")(host,
                                                        {"tokens": ptoks})
        err = _logits_check(lg_card.cpu(), lg_host, f"card vs host {dtype}",
                            atol, rtol)
        dec_card = serve.greedy_decode(rcfg, card, ptoks, 8, device=dev)
        dec_host = serve.greedy_decode(rcfg, host, ptoks, 8, device="cpu")
        same = bool(np.array_equal(dec_card["tokens"], dec_host["tokens"]))
        print(f"serving: reduced qwen3 {dtype}, card vs host: prefill "
              f"logits max abs diff {err:.3e}, greedy tokens equal: {same}")
        if dtype == "float32":
            if not same:
                raise AssertionError(f"fp32 greedy tokens differ: "
                                     f"{dec_card['tokens']} vs "
                                     f"{dec_host['tokens']}")
            err = _logits_check(dec_card["logits"].cpu(), dec_host["logits"],
                                "card vs host fp32 decode", atol, rtol)
            print(f"serving: reduced qwen3 float32, card vs host: last "
                  f"decode logits max abs diff {err:.3e}")
    return prefill_counts["flash_attention"]


def xlstm_serving(dev):
    """Phase 4b; returns the slstm_scan launches of the counted prefill
    call."""
    from repro_torch import tree
    from repro_torch.configs.registry import get_config, get_reduced_config
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import model as M

    cfg = get_config("xlstm-125m")
    n_slstm = sum(r for p, r in cfg.layout_ if p == "slstm")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree.leaves(params))
    print(f"xlstm: xlstm-125m full width, {n_params} params "
          f"({cfg.param_dtype}), drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s")

    # prefill at B=4, S=8192: one counted call, then timed calls
    prefill = make_prefill_step(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S),
                           device=dev, generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    logits = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    counts = prefill_counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    if counts["slstm_scan"] != n_slstm or counts["flash_attention"]:
        raise AssertionError(f"xlstm prefill launches {counts}, want "
                             f"{n_slstm} slstm_scan and no flash_attention")
    if (tuple(logits.shape) != (PREFILL_B, cfg.vocab_size)
            or not torch.isfinite(logits).all()):
        raise AssertionError(f"xlstm prefill: bad logits "
                             f"{tuple(logits.shape)}")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = statistics.median(times) * 1e3
    print(f"xlstm: prefill B={PREFILL_B} S={PREFILL_S}: {ms:.1f} ms a call "
          f"(median of 3, host clock), "
          f"{PREFILL_B * PREFILL_S / ms * 1e3:.0f} tokens/s, peak memory "
          f"{peak / 2**30:.2f} GiB, launches {counts}")
    prof = device_profile(lambda: prefill(params, {"tokens": tokens}), 1)
    print_profile(f"xlstm prefill B={PREFILL_B} S={PREFILL_S}", 1, *prof)
    scan = sum(v for k, v in prof[3].items() if "slstm_scan" in k)
    if prof[2]:
        print(f"profile: xlstm prefill: slstm_scan kernels {scan * 1e3:.1f} "
              f"ms of {prof[2] * 1e3:.1f} ms device time "
              f"({scan / prof[2]:.1%})")
    del tokens, logits
    torch.cuda.empty_cache()

    # the serve launcher, full width (decode path: no slstm_scan launch)
    ops.reset_launch_counts()
    res = serve.main(["--arch", "xlstm-125m", "--full-config"])
    torch.cuda.synchronize()
    print(f"xlstm: serve launcher --arch xlstm-125m --full-config: decode "
          f"{res['tok_per_s']:.1f} tok/s, launches {ops.launch_counts()}")
    if not torch.isfinite(res["logits"]).all():
        raise AssertionError("xlstm serve: non-finite logits")

    # decode == prefill at every position, full width (1 x 64 tokens).
    # Decode runs the per-step mLSTM and the reference's sLSTM step, which
    # rounds h and h @ R to bf16; the full config's prefill runs the
    # chunkwise mLSTM and the scan kernel, which keeps h in fp32 as its
    # plain version does.  The forms are equal in exact arithmetic, but in
    # bf16 their rounding differs by about the bf16 tolerance, the plain
    # scan's prefill as much as the kernel's.  So decode is held to both
    # prefills in fp32 (the same weights, widened), the kernel's bf16
    # prefill to the same prefill with the plain scan in its place, and
    # the bf16 gaps between decode and the prefills are printed.
    s = 64
    toks = torch.randint(0, cfg.vocab_size, (1, s), device=dev,
                         generator=gen)

    def decode_all(c, p):
        cache = M.init_cache(c, 1, s, device=dev)
        outs = []
        for t in range(s):
            lg, cache = M.decode_step(c, p, cache, toks[:, t:t + 1],
                                      torch.tensor([t], dtype=torch.int32,
                                                   device=dev))
            outs.append(lg[:, 0])
        return torch.stack(outs, 1)

    def prefill_logits(c, p):
        return M.forward(c, p, {"tokens": toks})[0]
    step_cfg = cfg.replace(mlstm_chunk=0)
    with torch.no_grad():
        dec = decode_all(cfg, params)
        step_pre = prefill_logits(step_cfg, params)
        kernel_scan = ops.slstm_scan
        ops.slstm_scan = ref.slstm_scan_ref
        try:
            plain_pre = prefill_logits(step_cfg, params)
        finally:
            ops.slstm_scan = kernel_scan
        err = _logits_check(step_pre, plain_pre,
                            "xlstm bf16 prefill, kernel vs plain scan", 0.15,
                            0.05)
        chunk_pre = prefill_logits(cfg, params)
        gaps = [(dec - x).abs().max().item()
                for x in (step_pre, plain_pre, chunk_pre)]
        cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
        p32 = tree.map_tree(lambda t: t.float(), params)
        dec32 = decode_all(cfg32, p32)
        err32 = [_logits_check(dec32, prefill_logits(c, p32),
                               f"xlstm fp32 decode vs {name} prefill", 1e-3,
                               0.0)
                 for name, c in (("per-step", cfg32.replace(mlstm_chunk=0)),
                                 ("chunkwise", cfg32))]
    print(f"xlstm: 1x{s} tokens, full width: bf16 prefill with the scan "
          f"kernel vs with the plain scan max abs diff {err:.4f} (limit 0.15 "
          f"+ 0.05|logit|); fp32 decode vs the per-step and the chunkwise "
          f"prefill {err32[0]:.3e}, {err32[1]:.3e} (limit 1e-3); bf16 decode "
          f"vs the per-step prefill with the kernel {gaps[0]:.4f}, with the "
          f"plain scan {gaps[1]:.4f}, vs the chunkwise prefill {gaps[2]:.4f} "
          f"(not checks)")
    del dec, step_pre, plain_pre, chunk_pre, p32, dec32

    # where a decode step's time goes: batch 8, as the serve launcher
    B, n = 8, 8
    step = make_serve_step(cfg, device=dev)
    cache = M.init_cache(cfg, B, 2 * n, device=dev)
    tok = torch.randint(0, cfg.vocab_size, (B, 1), device=dev, generator=gen)

    def decode_once():
        step(params, cache, tok, torch.zeros((B,), dtype=torch.int32,
                                             device=dev))
    decode_once()
    print_profile(f"xlstm decode step, batch {B}", n,
                  *device_profile(decode_once, n))
    del cache, params
    torch.cuda.empty_cache()

    # a reduced xlstm on the card (the kernel) against the host (the plain
    # per-step scan), same params
    for dtype, atol, rtol in (("float32", 1e-3, 0.0),
                              ("bfloat16", 0.15, 0.05)):
        rcfg = get_reduced_config("xlstm-125m").replace(dtype=dtype,
                                                        param_dtype=dtype)
        host = M.init_params(rcfg, torch.Generator().manual_seed(3),
                             device="cpu")
        card = tree.map_tree(lambda t: t.to(dev), host)
        ptoks = torch.from_numpy(np.random.default_rng(4).integers(
            0, rcfg.vocab_size, (2, 48)))
        ops.reset_launch_counts()
        lg_card = make_prefill_step(rcfg, device=dev)(card, {"tokens": ptoks})
        if ops.launch_counts()["slstm_scan"] != 3:
            raise AssertionError(f"reduced xlstm prefill launches "
                                 f"{ops.launch_counts()}")
        lg_host = make_prefill_step(rcfg, device="cpu")(host,
                                                        {"tokens": ptoks})
        err = _logits_check(lg_card.cpu(), lg_host,
                            f"xlstm card vs host {dtype}", atol, rtol)
        dec_card = serve.greedy_decode(rcfg, card, ptoks, 8, device=dev)
        dec_host = serve.greedy_decode(rcfg, host, ptoks, 8, device="cpu")
        same = bool(np.array_equal(dec_card["tokens"], dec_host["tokens"]))
        print(f"xlstm: reduced xlstm {dtype}, card vs host: prefill logits "
              f"max abs diff {err:.3e}, greedy tokens equal: {same}")
        if dtype == "float32":
            if not same:
                raise AssertionError(f"xlstm fp32 greedy tokens differ: "
                                     f"{dec_card['tokens']} vs "
                                     f"{dec_host['tokens']}")
            err = _logits_check(dec_card["logits"].cpu(), dec_host["logits"],
                                "xlstm card vs host fp32 decode", atol, rtol)
            print(f"xlstm: reduced xlstm float32, card vs host: last decode "
                  f"logits max abs diff {err:.3e}")
    return prefill_counts["slstm_scan"]


def ptxas_by_kernel(log: str) -> list:
    """One line per compiled kernel from ``nvcc -Xptxas -v``: its name
    (demangled where ``c++filt`` is present), then its stack and spill line
    and its register and shared-memory line."""
    entries = []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entries.append((line.split("'")[1], []))
        elif entries and ("spill" in line or "Used" in line):
            entries[-1][1].append(
                line.strip().removeprefix("ptxas info    : "))
    names = [e[0] for e in entries]
    cxxfilt = shutil.which("c++filt")
    if cxxfilt and names:
        out = subprocess.run([cxxfilt], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            names = out.stdout.splitlines()
    return [f"{n}: {'; '.join(e[1])}" for n, e in zip(names, entries)]


def device_and_build():
    """Phase 1: (device, the card's nvidia-smi line)."""
    sys.path.insert(0, str(SRC))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _lib

    dev = resolve_device()
    card = gpu_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _lib.library()
    report = _lib.build_report()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{report['build_seconds']} s)")
    for line in ptxas_by_kernel(report["ptxas_log"]):
        print(f"ptxas: {line}")
    return dev, card


def aggregation_cases(dev):
    """Phase 2 at every shape and fleet dtype; returns result rows."""
    rows = []
    for name, A, R, N in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for r in kernel_cases(dev, name, A, R, N, dtype):
                print("kernel " + json.dumps(r))
                rows.append(r)
    return rows


def main(argv=None) -> int:
    phases = selected_phases(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev, card = device_and_build()
    rows = aggregation_cases(dev) if "2" in phases else []
    attn_rows = attention_cases(dev) if "2b" in phases else []
    scan_rows = slstm_cases(dev) if "2c" in phases else []
    if "3r" in phases:
        flat_round(dev)
    if phases != FULL_RUN:
        if "3b" in phases:
            async_path(dev)
        return 0

    paths = main_path(dev)
    async_paths = async_path(dev)
    flash_launches = serving_path(dev)
    scan_launches = xlstm_serving(dev)

    def pick(kernel, entry):
        return next(r for r in rows if r["kernel"] == kernel and
                    r["entry"] == entry and r["shape"] == "main" and
                    r["dtype"] == "float32")

    # launches of each path's counted run: the flat round (fused and
    # fused=False) and the async round (fused, and fused=False with its
    # scatter-accumulates on the matmul kernel)
    by_path = {}
    for path, fused, unfused in (("flat", paths["main"], paths["unfused"]),
                                 ("async", async_paths["main"],
                                  async_paths["unfused"])):
        by_path[path] = {
            "fused_agg_blend": sum(fused[k] for k in (
                "agg_blend", "cloud_blend", "agg_absorb")),
            "weighted_agg_matmul": unfused["weighted_agg_matmul"]
            + unfused["scatter_accumulate"],
            "dual_proximal_sgd": fused["dual_proximal_sgd"]}
    kernels = []
    for kernel, entry in (("fused_agg_blend", "agg_blend"),
                          ("weighted_agg_matmul", "weighted_agg_matmul"),
                          ("dual_proximal_sgd", "scaled_broadcast")):
        r = pick(kernel, entry)
        kernels.append({
            "name": kernel, "route": "cuda", "source": SOURCES[kernel],
            "replaces": REPLACES[kernel],
            "launches": sum(c[kernel] for c in by_path.values()),
            "launches_by_path": {p: c[kernel] for p, c in by_path.items()},
            "max_abs_err": max(x["max_abs_err"] for x in rows
                               if x["kernel"] == kernel),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "entry": entry,
            "shape": {"A": r["A"], "R": r["R"], "N": r["N"]},
            **{k: r[k] for k in ("device_ms", "host_us", "library_device_ms",
                                 "library_host_us") if k in r}})
    # the serving path's shape: what each of its prefill launches computes
    r = next(x for x in attn_rows if x["entry"] == "prefill")
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": SOURCES["flash_attention"],
        "replaces": REPLACES["flash_attention"], "launches": flash_launches,
        "max_abs_err": max(x["max_abs_err"] for x in attn_rows),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "entry": "prefill", "shape": r["shape"], "dtype": r["dtype"]})
    # the xlstm-125m layer with bf16 R, as each of its prefill launches
    r = next(x for x in scan_rows
             if x["entry"] == "layer" and x["r_dtype"] == "bfloat16")
    kernels.append({
        "name": "slstm_scan", "route": "cuda", "source": SOURCES["slstm_scan"],
        "replaces": REPLACES["slstm_scan"], "launches": scan_launches,
        "max_abs_err": max(x["max_abs_err"] for x in scan_rows),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None, "entry": "layer",
        "shape": r["shape"], "r_dtype": r["r_dtype"],
        "latency_floor_ms": r["latency_floor_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
