#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. Device and build: the card's name and power limit (``nvidia-smi``), and
   the build of the CUDA kernels from ``src/repro_torch/kernels/csrc``.
2. Every kernel against its plain PyTorch version on the card, in fp32 and
   bf16 fleets, at the main path's shape (A=20, R=4, N=31,810), the paper
   fleet (A=100, R=10) and perception scale (A=100, R=10, N=9,540,010, the
   784-12000-10 MLP): max error, the kernel's time (CUDA events, median of
   11 timed runs of 10 launches after warm-up), its bound at the H100's
   3.35 TB/s and 67 TFLOP/s fp32, the plain version's time and, for the
   aggregation kernels, one PyTorch call's time (``library_ms``).
3. The main path: the ``examples/quickstart.py`` scenario through
   ``ScenarioSpec -> pretrain_to_target -> run_scenario`` on the card, with
   the launch counts set to 0 just before and read just after; the mean
   final accuracy of that run and four more draw realizations must beat
   the pre-trained model by 0.05.  Then 2 rounds with a
   bf16 fleet, 1 round with ``fused=False`` (the ``weighted_agg_matmul``
   path), and 2 rounds on the card against the same 2 rounds on the host
   (plain versions) with the same injected draws.
4. The kernels' JSON line, the card's line, and the result line.

Exits 1 without printing a result when no CUDA device is present, and
fails at import when run outside a checkout of the repository.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

SRC = Path(__file__).resolve().parent / "src"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12           # H100 SXM, fp32 outside the tensor cores
SHAPES = (("main", 20, 4, 31_810), ("paper", 100, 10, 31_810),
          ("perception", 100, 10, 9_540_010))
TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-5, 2.0 ** -7)}
SOURCES = {"fused_agg_blend": "src/repro_torch/kernels/csrc/fused_agg_blend.cu",
           "weighted_agg_matmul":
               "src/repro_torch/kernels/csrc/fused_agg_blend.cu",
           "dual_proximal_sgd":
               "src/repro_torch/kernels/csrc/dual_proximal_sgd.cu"}
REPLACES = {"fused_agg_blend": "src/repro/kernels/masked_hier_agg.py:199",
            "weighted_agg_matmul": "src/repro/kernels/masked_hier_agg.py:86",
            "dual_proximal_sgd": "src/repro/kernels/dual_proximal_sgd.py:44"}


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 11, inner: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back
    calls, bracketed by CUDA events, after a warm-up."""
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


def bound(nbytes: float, flops: float):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def compare(got, want, dtype, what):
    """Max |got - want|; raises unless |d| <= atol + rtol*|want|."""
    atol, rtol = TOL[dtype]
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
    mask = (torch.rand(A, device=dev, generator=gen) < 0.6).float()
    mask[assign == 0] = 0.0                       # RSU 0 keeps its row
    W = build_weight_matrix(w, mask, assign, R)
    mass = cohort_mass(w, mask, assign, R)
    coef = torch.stack([torch.zeros_like(mass), torch.ones_like(mass),
                        (mass > 0).float()], dim=1)
    rows, small = [], A * 16 + R * A * 4

    def row(kernel, entry, err, ms, plain_ms, nbytes, flops, library_ms):
        b_ms, b_by = bound(nbytes, flops)
        rows.append({"kernel": kernel, "entry": entry, "shape": shape_name,
                     "A": A, "R": R, "N": N, "dtype": str(dtype)[6:],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": library_ms})

    # fused_agg_blend, RSU layer (agg_blend): the kernel with its operands
    # ready, the plain two-pass version, and one matmul + where
    got, _ = mha.agg_blend(x, w, mask, assign, R, prev)
    want, _ = ref.agg_blend_ref(x, w, mask, assign, R, prev)
    err = compare(got, want, dtype, f"agg_blend {shape_name} {dtype}")
    if not torch.equal(got[0], prev[0]):
        raise AssertionError("agg_blend: a zero-mass row was not kept")
    row("fused_agg_blend", "agg_blend", err,
        cuda_ms(lambda: mha._fused_agg_blend(coef, (W,), (x,), prev,
                                             entry="agg_blend")),
        cuda_ms(lambda: ref.agg_blend_ref(x, w, mask, assign, R, prev)),
        A * N * sx + 2 * R * N * sx + small, 2 * R * A * N,
        cuda_ms(lambda: torch.where((mass > 0)[:, None],
                                    torch.matmul(W, x.float()),
                                    prev.float())))

    # fused_agg_blend, cloud layer (cloud_blend): R -> 1 into fp32
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
    row("fused_agg_blend", "cloud_blend", err,
        cuda_ms(lambda: mha._fused_agg_blend(ccoef, (wn,), (prev,),
                                             cloud[None, :],
                                             entry="cloud_blend")),
        cuda_ms(lambda: ref.cloud_blend_ref(prev, rmass, cloud)),
        R * N * sx + 2 * N * 4 + R * 4, 2 * R * N,
        cuda_ms(lambda: torch.where(rmass.sum() > 0,
                                    torch.matmul(wn, prev.float())[0],
                                    cloud)))

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
    row("weighted_agg_matmul", "weighted_agg_matmul", err,
        cuda_ms(lambda: mha.weighted_agg_matmul(W, x)),
        cuda_ms(lambda: ref.weighted_agg_matmul_ref(W, x)),
        A * N * sx + R * N * sx + R * A * 4, 2 * R * A * N,
        cuda_ms(lambda: torch.matmul(W, x.float())))
    del got, want, x, prev
    torch.cuda.empty_cache()

    # dual_proximal_sgd: fp32 w/g, anchors in the fleet dtype; the flat
    # engine's form (per-row scale, broadcast cloud row) and the TPU
    # kernel's form (no scale, full-shape anchors)
    wt = torch.randn(A, N, device=dev, generator=gen)
    g = torch.randn(A, N, device=dev, generator=gen) * 0.1
    a1 = torch.randn(A, N, device=dev, generator=gen).to(dtype)
    a2 = torch.randn(N, device=dev, generator=gen).to(dtype)
    live = (torch.rand(A, device=dev, generator=gen) < 0.5).float()
    kw = dict(lr=0.1, mu1=0.01, mu2=0.005)
    got = dps.dual_proximal_sgd(wt, g, a1, a2, scale=live, **kw)
    want = ref.dual_proximal_sgd_ref(wt, g, a1, a2, scale=live, **kw)
    err = compare(got, want, torch.float32, f"dual_proximal_sgd {shape_name}")
    del got, want
    row("dual_proximal_sgd", "scaled_broadcast", err,
        cuda_ms(lambda: dps.dual_proximal_sgd(wt, g, a1, a2, scale=live,
                                              out=wt, **kw)),
        cuda_ms(lambda: ref.dual_proximal_sgd_ref(wt, g, a1, a2, scale=live,
                                                  **kw)),
        A * N * (4 + 4 + sx + 4) + N * sx + A * 4, 8 * A * N, None)
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
    for p in final.cloud_params.values():
        if not torch.isfinite(p).all():
            raise AssertionError("non-finite cloud model")
    if not all(0.0 <= a <= 1.0 for a in hist["acc"]):
        raise AssertionError(f"bad accuracy history {hist['acc']}")
    return final, hist, counts, seconds


def main_path(dev):
    """Phase 3; returns the launch counts of each path's run."""
    from repro_torch.configs.mnist_mlp import CONFIG
    from repro_torch.fedsim import pretrain_to_target
    from repro_torch.fedsim.simulator import round_draws
    from repro_torch.core.heterogeneity import init_conn_state
    from repro_torch.models import mlp

    spec = quickstart_spec()
    res = spec.resolve()
    params = mlp.init_params(CONFIG, torch.Generator().manual_seed(spec.seed),
                             device=dev)
    t0 = time.perf_counter()
    pre, pre_acc = pretrain_to_target(params, res.pretrain_pool, res.test.x,
                                      res.test.y,
                                      target_acc=spec.pretrain_target,
                                      max_epochs=10)
    print(f"main path: pre-trained (biased) accuracy {pre_acc:.4f} "
          f"({time.perf_counter() - t0:.2f} s)")
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
    return paths


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
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
    for line in report["ptxas_log"].splitlines():
        if "Used" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")

    rows = []
    for name, A, R, N in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for r in kernel_cases(dev, name, A, R, N, dtype):
                print("kernel " + json.dumps(r))
                rows.append(r)

    paths = main_path(dev)

    def pick(kernel, entry):
        return next(r for r in rows if r["kernel"] == kernel and
                    r["entry"] == entry and r["shape"] == "main" and
                    r["dtype"] == "float32")

    main_c, unfused_c = paths["main"], paths["unfused"]
    kernels = []
    for kernel, entry, launches in (
            ("fused_agg_blend", "agg_blend",
             main_c["agg_blend"] + main_c["cloud_blend"]
             + main_c["agg_absorb"]),
            ("weighted_agg_matmul", "weighted_agg_matmul",
             unfused_c["weighted_agg_matmul"]),
            ("dual_proximal_sgd", "scaled_broadcast",
             main_c["dual_proximal_sgd"])):
        r = pick(kernel, entry)
        kernels.append({
            "name": kernel, "route": "cuda", "source": SOURCES[kernel],
            "replaces": REPLACES[kernel], "launches": launches,
            "max_abs_err": max(x["max_abs_err"] for x in rows
                               if x["kernel"] == kernel),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "entry": entry,
            "shape": {"A": r["A"], "R": r["R"], "N": r["N"]}})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
