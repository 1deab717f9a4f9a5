#!/usr/bin/env python3
"""How often ``torch.profiler`` loses device records: the trace of 20
``agg_absorb`` calls on an async round's buffers (``chip_smoke.py``'s
``absorb_launches``), taken many times at the main (A=20, R=4) and paper
(A=100, R=10) fleets, plainly and after one discarded warm-up cycle.

    python3 tools/profiler_drops.py [TRIALS] [--after-phases]   # on the card

TRIALS defaults to 100.  With ``--after-phases`` the traces are taken
after ``chip_smoke.py``'s phases 2, 2b, 2c and 3 have run, as phase 3b
takes them.  Prints, for each fleet and variant, how many traces gave
each (wrapper launches, ring-kernel executions, host-API launches,
device executions), in how many the ring count or the kernel executions
fell short, and the first few traces whose ring count was short.
"""
import collections
import pathlib
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def scheduled_profile(fn, n):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            prof.step()
    runs, launches = {}, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            runs[e.key] = e.count
        elif e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            launches += e.count
    return launches, runs


def main():
    dev, card = cs.device_and_build()
    from repro_torch.kernels import ops
    a_spec, f_spec = cs.straggler_specs()
    res, pre, _ = cs.pretrained(dev, a_spec, "profiler drops")
    args = [a for a in sys.argv[1:] if a != "--after-phases"]
    trials = int(args[0]) if args else 100
    sts = {}
    for fleet, A, R in (("main", 20, 4), ("paper", 100, 10)):
        a = a_spec.replace(n_agents=A, n_rsus=R)
        sts[fleet] = cs.async_round_profile(dev, a, pre, f"async {fleet}")
    if "--after-phases" in sys.argv[1:]:
        for phase in (cs.aggregation_cases, cs.attention_cases,
                      cs.slstm_cases, cs.main_path):
            phase(dev)
    for fleet, st in sts.items():
        A, R = st.agent_flat.shape[0], st.rsu_flat.shape[0]
        assign = torch.arange(A, device=dev) % R
        w_imm = torch.rand(A, device=dev) * (torch.arange(A, device=dev) % 2)
        w_due = (torch.rand(A, device=dev)
                 * (torch.arange(A, device=dev) % 3 == 0))

        def call():
            return ops.agg_absorb(((st.agent_flat, w_imm),
                                   (st.pending_x, w_due)), assign, R,
                                  st.rsu_flat, st.rsu_mass, keep=0.5)
        call()
        n = 20
        for variant in ("plain", "warmup"):
            hist = collections.Counter()
            bad, short = [], 0
            t0 = time.perf_counter()
            for t in range(trials):
                before = ops.launch_counts()["agg_absorb"]
                if variant == "plain":
                    _, launches, _, _, runs = cs.device_profile(call, n)
                    want_counted = n
                else:
                    launches, runs = scheduled_profile(call, n)
                    want_counted = 2 * n
                counted = ops.launch_counts()["agg_absorb"] - before
                ring = sum(v for k, v in runs.items()
                           if "agg_blend_ring_kernel" in k)
                total = sum(runs.values())
                executed = sum(v for k, v in runs.items()
                               if not k.startswith(("Memcpy", "Memset",
                                                    "ProfilerStep")))
                short += executed < launches
                hist[(counted, ring, launches, total)] += 1
                if counted != want_counted or ring != n:
                    bad.append((t, counted, ring, launches, total,
                                {k[:50]: v for k, v in runs.items()}))
            print(f"{fleet} {variant}: {trials} trials in "
                  f"{time.perf_counter() - t0:.1f} s; (counted, ring, "
                  f"host launches, device executions) -> trials: "
                  f"{dict(hist)}; ring short in {len(bad)}, kernel "
                  f"executions short of host launches in {short}")
            for b in bad[:5]:
                print(f"  bad {b}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
