"""Serving launcher: batched KV-cache greedy decode of a (possibly
federated) global model checkpoint, the default mode of
``repro/launch/serve.py``, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        [--ckpt-dir results/ckpt] [--batch 8] [--prompt-len 32] [--gen 32] \\
        [--window 0] [--full-config] [--device cuda]

The prompt goes through the cache one token at a time and the answer is
decoded greedily, as in JAX; the same flags and the same printed lines.
``--device cpu`` runs the plain PyTorch versions on the host.  A
checkpoint written by the JAX package's train launcher is restored.  The
continuous serving loop (``--serve-loop``) is not ported yet.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs.registry import get_config, get_reduced_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import model as M


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--serve-loop", action="store_true",
                    help="the continuous serving loop (not ported yet)")
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full-config", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--window", type=int, default=0,
                    help="sliding-window attention (0 = full causal)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch versions)")
    return ap


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def greedy_decode(cfg, params, prompts, n_gen: int, *, device=None) -> dict:
    """Feed ``prompts`` (B, Sp) through a fresh KV cache one token at a
    time, then decode ``n_gen`` tokens greedily, as the JAX launcher does.
    Returns {tokens (B, n_gen) int64 numpy, logits (B, V) fp32 of the last
    step, prefill_s, decode_s} (host clock, the device synchronised)."""
    dev = resolve_device(device)
    prompts = torch.as_tensor(prompts).to(dev)
    B, Sp = prompts.shape
    cache = M.init_cache(cfg, B, Sp + n_gen, device=dev)
    step = make_serve_step(cfg, device=dev)

    def at(t: int) -> torch.Tensor:
        return torch.full((B,), t, dtype=torch.int32, device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    logits = None
    for t in range(Sp):
        logits, cache = step(params, cache, prompts[:, t:t + 1], at(t))
    _sync(dev)
    t_pre = time.perf_counter() - t0

    tok = logits.argmax(dim=-1)[:, None]
    outs = []
    t0 = time.perf_counter()
    for t in range(Sp, Sp + n_gen):
        outs.append(tok[:, 0])
        logits, cache = step(params, cache, tok, at(t))
        tok = logits.argmax(dim=-1)[:, None]
    _sync(dev)
    t_dec = time.perf_counter() - t0
    return {"tokens": torch.stack(outs, dim=1).cpu().numpy(),
            "logits": logits, "prefill_s": t_pre, "decode_s": t_dec}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Parse ``argv``, serve, print the JAX launcher's lines and return
    ``greedy_decode``'s dict plus tok_per_s."""
    args = _parser().parse_args(argv)
    if args.serve_loop:
        raise SystemExit("--serve-loop: the continuous serving loop is not "
                         "ported to PyTorch yet (ROADMAP queue 1 item 11)")
    dev = resolve_device(args.device)
    cfg = (get_reduced_config if args.reduced else get_config)(args.arch)
    if args.window:
        cfg = cfg.replace(attn_window=args.window)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = M.init_params(cfg, gen, device=dev)
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        params = ckpt.restore(args.ckpt_dir, like=params)
        print(f"[ckpt] restored step {ckpt.latest_step(args.ckpt_dir)}")

    rng = np.random.default_rng(args.seed)
    B, Sp = args.batch, args.prompt_len
    prompts = rng.integers(0, cfg.vocab_size, (B, Sp))
    res = greedy_decode(cfg, params, prompts, args.gen, device=dev)
    t_pre, t_dec, gen_tokens = res["prefill_s"], res["decode_s"], res["tokens"]
    res["tok_per_s"] = tok_per_s = B * args.gen / max(t_dec, 1e-9)

    print(f"[arch] {args.arch}{' (reduced)' if args.reduced else ''} "
          f"batch={B} cache={Sp + args.gen}"
          + (f" window={args.window}" if args.window else ""))
    print(f"[prefill] {Sp} tok in {t_pre:.2f}s | "
          f"[decode] {args.gen} tok in {t_dec:.2f}s "
          f"({tok_per_s:.1f} tok/s)")
    for b in range(min(B, 2)):
        print(f"  req {b}: {prompts[b][:6]}... -> {gen_tokens[b][:10]}...")
    if not torch.isfinite(res["logits"]).all():
        raise RuntimeError("non-finite logits")
    return res


if __name__ == "__main__":
    main()
