"""Whether ``chip_smoke.py``'s phase 5e (card against host under the
update-gap rule) catches a wrong #5 backward in the reduced xlstm, on the
CPU.

The "card" run here is the host's bf16 run with the sLSTM's backward
replaced by a copy of the plain reverse scan (``ref.slstm_scan_bwd_ref``)
with one fault (``tools/slstm_bwd_mutations.FAULTS``), standing in for the
kernel; it is held, as phase 5e holds the card, to the host's fp32 run
from the same bf16 params: each leaf's update within ``ZOO_GAP`` x the
host bf16 update's 2-norm gap + 1e-3.  The reduced xlstm (``mlstm_chunk``
16), its params, batches and H2-Fed settings are phase 5e's; the round
runs at ``ZOO_ROUND``'s one local step and, for comparison, at LAR 2.
Then the fp32 train step's rule: the faulty fp32 run's update within
``ZOO_FP32_TOL`` of the host's fp32 update, each leaf.  Prints, a fault
and a run, whether the rule holds, the number of leaves where it fails,
the largest gap and the first such leaves (leaf, card gap, host gap).
The fault "none" (the plain reverse scan as it is, against autograd
through the plain scan) must hold everywhere; the card's own fp32 gap is
read by phase 5e.  Run from the repository root:

    PYTHONPATH=src python tools/zoo_gap_faults.py
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))
import chip_smoke as cs                                    # noqa: E402
from slstm_bwd_mutations import FAULTS, faulty             # noqa: E402

from repro_torch import tree                               # noqa: E402
from repro_torch.configs.registry import get_reduced_config  # noqa: E402
from repro_torch.core.h2fed import H2FedParams             # noqa: E402
from repro_torch.kernels import ops, ref                   # noqa: E402
from repro_torch.launch import steps                       # noqa: E402
from repro_torch.launch.h2fed_round import make_h2fed_round  # noqa: E402
from repro_torch.models import model as M                  # noqa: E402

ARCH = "xlstm-125m"
SHOWN = ("none", "half_dR", "no_forget_path", "no_softcap_derivative")


def scan_with(bwd):
    """``ops.slstm_scan`` whose backward is ``bwd`` (a reverse scan)."""
    class Scan(torch.autograd.Function):
        @staticmethod
        def forward(ctx, wx, r, b):
            out, state = ref.slstm_scan_ref(wx, r, b, return_state=True)
            ctx.save_for_backward(wx, r, b, out, state)
            return out

        @staticmethod
        def backward(ctx, dh):
            return bwd(dh.float(), *ctx.saved_tensors)
    return Scan.apply


def main() -> None:
    torch.set_num_threads(4)
    cfg = get_reduced_config(ARCH).replace(dtype="bfloat16",
                                           param_dtype="bfloat16",
                                           mlstm_chunk=16)
    c32 = cfg.replace(dtype="float32", param_dtype="float32")
    host = M.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    host32 = tree.map_tree(lambda t: t.float(), host)
    init = tree.leaves(host)
    paths = [path for path, _ in tree.leaves_with_paths(host)]
    hp = H2FedParams(mu1=0.05, mu2=0.01, lr=0.1)
    batch = cs._zoo_batch(cfg, (2, 1), 48, 5)
    mask = np.array([1.0, 1.0], np.float32)

    def step_on(c, params):
        state, _ = steps.make_train_step(c, hp, device="cpu")(
            steps.train_state(params), batch, mask)
        return tree.leaves(state.params)

    def round_on(lar, epochs):
        rhp = H2FedParams(mu1=0.05, mu2=0.01, lar=lar, local_epochs=epochs,
                          lr=0.1)
        rb = cs._zoo_batch(cfg, (lar, 1, 1), 32, 6)
        rmask, n_data = np.ones((lar, 1), np.float32), np.ones((1,),
                                                               np.float32)

        def run(c, params):
            cloud, _ = make_h2fed_round(c, rhp, device="cpu")(
                params, rb, rmask, n_data)
            return tree.leaves(cloud)
        return run

    lar, epochs = cs.ZOO_ROUND[ARCH]
    # (what, run, the card run's config and params, bf16 rule or fp32)
    runs = (("train_step", step_on, cfg, host, "bf16"),
            (f"round LAR {lar} E {epochs}", round_on(lar, epochs), cfg, host,
             "bf16"),
            ("round LAR 2 E 1", round_on(2, 1), cfg, host, "bf16"),
            ("train_step fp32", step_on, c32, host32, "fp32"))
    plain = ops.slstm_scan
    for what, run, card_cfg, card_params, rule in runs:
        truth = run(c32, host32)
        host_gap = cs._update_gaps(run(cfg, host), truth, init)
        for name in SHOWN:
            ops.slstm_scan = scan_with(faulty(FAULTS[name]))
            try:
                got = run(card_cfg, card_params)
            finally:
                ops.slstm_scan = plain
            card_gap = cs._update_gaps(got, truth, init)
            if rule == "fp32":
                worse = [(p, f"{g:.3g}") for p, g in zip(paths, card_gap)
                         if not g <= cs.ZOO_FP32_TOL]
            else:
                worse = [(p, round(g, 4), round(h, 4))
                         for p, g, h in zip(paths, card_gap, host_gap)
                         if not any(z in p for z in cs.ZERO_GRAD_LEAVES)
                         and not g <= cs.ZOO_GAP * h + 1e-3]
            print(f"{what}, fault {name}: {'fails' if worse else 'holds'} "
                  f"({len(worse)} of {len(paths)} leaves; largest gap "
                  f"{max(card_gap):.3g}) {worse[:6]}", flush=True)


if __name__ == "__main__":
    main()
