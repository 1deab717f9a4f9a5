"""Where deepseek-v2-lite-16b's decode and prefill logits part, on the card.

    python3 tools/moe_decode_gap.py

Draws the full config's params on the card (seed 0, as ``chip_smoke.py``
phase 4c), runs 64 random tokens (seed 2) through the prefill forward and
token by token through the decode cache with ``capacity_factor =
n_experts`` (no drops), and prints the largest logit gap, the gap at each
position, and how many (layer, token) top-k expert sets differ between
the two: in bf16 at full depth, then in fp32 at full width and 4 layers.
A differing set is a near-tie of gates that bf16 rounding reorders.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402

_seen = []
_top_k = moe._top_k


def _recording_top_k(gates, k):
    """moe._top_k, recording each call's sorted expert ids a token."""
    vals, ids = _top_k(gates, k)
    _seen.append(ids.reshape(-1, k).sort(-1).values.cpu())
    return vals, ids


def gap(cfg, params, s: int, what: str, dev) -> None:
    cfg = cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    gen = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (1, s), device=dev, generator=gen)
    L = cfg.n_layers
    with torch.no_grad():
        _seen.clear()
        full, _ = M.forward(cfg, params, {"tokens": toks})
        pre = list(_seen)                               # L x (s, k)
        _seen.clear()
        cache = M.init_cache(cfg, 1, s, device=dev)
        outs = []
        for t in range(s):
            lg, cache = M.decode_step(cfg, params, cache, toks[:, t:t + 1],
                                      torch.tensor([t], dtype=torch.int32,
                                                   device=dev))
            outs.append(lg[:, 0])
        dec = torch.stack(outs, 1)
    steps = [_seen[t * L:(t + 1) * L] for t in range(s)]
    differ = [(l, t) for l in range(L) for t in range(s)
              if not torch.equal(pre[l][t], steps[t][l][0])]
    d = (dec.float() - full.float()).abs()
    per_pos = d.amax(-1)[0]
    first = min((t for _, t in differ), default=None)
    before = per_pos[:first].max().item() if first else float("nan")
    print(f"{what}: max gap {d.max().item():.4f}; top-k sets that differ "
          f"{len(differ)} of {L * s} (layer, token); first at token {first}; "
          f"gap before it {before:.4f}; gap by position "
          f"{[round(x, 3) for x in per_pos.tolist()]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("moe_decode_gap: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    moe._top_k = _recording_top_k
    cfg = get_config("deepseek-v2-lite-16b")
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    gap(cfg, params, 64, "bf16, full width and depth", dev)
    del params
    torch.cuda.empty_cache()
    c32 = cfg.replace(n_layers=4, dtype="float32", param_dtype="float32")
    p32 = M.init_params(c32, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    gap(c32, p32, 64, "fp32, full width, 4 layers", dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
