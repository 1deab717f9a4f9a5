"""Whether ``chip_smoke.py``'s check of #5's backward catches a wrong
backward, on the CPU.

Copies of the plain reverse scan (``kernels/ref.slstm_scan_bwd_ref``) with
one fault each are held, as phase 5a' holds the kernel, against autograd
of ``ref.slstm_scan_ref`` at ``chip_smoke.SLSTM_BWD_TOL`` (bf16 dR at
``SLSTM_BWD_BF16_TOL``) over ``chip_smoke.SLSTM_BWD_CASES`` but the layer
shape, bf16 and fp32 R.  Prints each copy's failing checks (of 18: 3
cases x 2 dtypes x dwx, dR, db).  The faults: halving dR, dropping the
forget gate's path (through exp(a - m')), dropping the soft cap's
derivative, and, on the stabiliser, dropping its path or giving all of
max(a, i)'s gradient to i.  The stabiliser's two are expected to pass:
m scales c and n alike, so h = o c / max(n, 1) does not depend on it
while n >= 1, which holds at every step (max(f', i') = 1), and the
gradient reaching m' sums to zero up to rounding.  Run from the
repository root:

    PYTHONPATH=src python tools/slstm_bwd_mutations.py
"""
from __future__ import annotations

import inspect
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs                                    # noqa: E402
from repro_torch.kernels import ref                        # noqa: E402

SRC = inspect.getsource(ref.slstm_scan_bwd_ref)
FAULTS = {
    "none": [],
    "half_dR": [("dr.to(r_gates.dtype)", "(0.5 * dr).to(r_gates.dtype)")],
    "no_forget_path": [("da = dfe + torch.where",
                        "da = 0.0 * dfe + torch.where")],
    "no_softcap_derivative": [("dgi * (1.0 - ti * ti)", "dgi")],
    "no_stabiliser_path": [("dmn = dm - dfe - die",
                            "dmn = 0.0 * (dm - dfe - die)")],
    "max_all_to_i": [
        ("da = dfe + torch.where(a > gi, dmn, torch.where(a == gi, half, "
         "0.0))", "da = dfe"),
        ("dgi = die + torch.where(gi > a, dmn, torch.where(a == gi, half, "
         "0.0))", "dgi = die + dmn")],
}


def faulty(edits):
    code = SRC
    for old, new in edits:
        assert old in code, old
        code = code.replace(old, new)
    ns = dict(ref.__dict__)
    exec(code, ns)
    return ns["slstm_scan_bwd_ref"]


def main() -> None:
    for name, edits in FAULTS.items():
        bwd, fails = faulty(edits), []
        for case, B, S, H, P, scale in cs.SLSTM_BWD_CASES[1:]:
            for r_dtype in (torch.bfloat16, torch.float32):
                wx, r, b = cs.slstm_inputs("cpu", B, S, H, P, r_dtype, scale,
                                           seed=S)
                dh = torch.randn(B, S, H * P,
                                 generator=torch.Generator().manual_seed(P))
                leaves = [t.clone().requires_grad_() for t in (wx, r, b)]
                want = torch.autograd.grad(ref.slstm_scan_ref(*leaves),
                                           leaves, dh)
                out, state = ref.slstm_scan_ref(wx, r, b, return_state=True)
                got = bwd(dh, wx, r, b, out, state)
                for g_name, g, w in zip(("dwx", "dR", "db"), got, want):
                    tol = (cs.SLSTM_BWD_BF16_TOL if g.dtype == torch.bfloat16
                           else cs.SLSTM_BWD_TOL)
                    try:
                        cs.compare(g, w, torch.float32,
                                   f"{case} {str(r_dtype)[6:]} {g_name}",
                                   tol=(tol * w.float().abs().max().item(),
                                        tol))
                    except AssertionError as e:
                        fails.append(str(e).split(":")[0])
        print(f"{name}: {len(fails)} of 18 checks fail {fails}")


if __name__ == "__main__":
    main()
