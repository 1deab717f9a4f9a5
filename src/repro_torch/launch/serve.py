"""Serving launcher, the two modes of ``repro/launch/serve.py`` on the
card, with the same flags and the same printed lines.

``--serve-loop``: the continuous serving loop (``fedsim/serving``) on a
serve-mode ``ScenarioSpec`` (``--scenario-json``, or a built-in default),
updates arriving from the seeded Poisson generator (or a ``serve_trace``
JSONL replay) and the fp32 cloud master served to a 64-row inference
probe every tick.  Prints the ``ServeLoopStats`` summary; ``--dump-trace``
writes the event schedule for a bit-exact replay; ``--snapshot-dir`` /
``--snapshot-every`` checkpoint the whole loop state and ``--resume``
continues it bit for bit.

    PYTHONPATH=src python -m repro_torch.launch.serve --serve-loop \\
        [--scenario-json spec.json] [--events 480] [--dump-trace t.jsonl] \\
        [--stats-json s.json] [--snapshot-dir d --snapshot-every 64] \\
        [--resume d] [--device cuda]

Default: batched KV-cache greedy decode of a (possibly federated) global
model checkpoint.  The prompt goes through the cache one token at a time
and the answer is decoded greedily, as in JAX.  A checkpoint written by
the JAX package's train launcher is restored.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        [--ckpt-dir results/ckpt] [--batch 8] [--prompt-len 32] [--gen 32] \\
        [--window 0] [--full-config] [--device cuda]

``--arch`` takes qwen3-0.6b, xlstm-125m, zamba2-2.7b (Mamba-2 + a
weight-shared attention block; at full width 4.85 GB of bf16 params),
deepseek-v2-lite-16b (MLA + MoE; at full width 32.4 GB of bf16 params),
whisper-tiny (the decoder, cross-attending encoder frames drawn from the
seed, as the reference's launcher draws them), the dense yi-34b (GQA 56 /
8, 68.8 GB of bf16 params at full width) and command-r-35b (GQA 64 / 8,
64.8 GB), and kimi-k2-1t-a32b and nemotron-4-340b (reduced only: their
full configs, 2.09 TB and 682 GB of params, do not fit one card and are
refused before any allocation, by ``check_fits_one_card``).
phi-3-vision-4.2b is refused, as by the reference: this is a text decode
launcher, and a VLM needs the image path (``make_prefill_step`` with
``patch_embeds``).

``--device cpu`` runs the plain PyTorch versions on the host.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs.registry import get_config, get_reduced_config
from repro_torch.device import resolve_device
from repro_torch.launch import steps
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import model as M


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--serve-loop", action="store_true",
                    help="run the continuous event-driven serving loop "
                         "instead of KV-cache decode")
    ap.add_argument("--scenario-json", default="",
                    help="serve-mode ScenarioSpec JSON (serve_events > 0)")
    ap.add_argument("--events", type=int, default=480,
                    help="serve-loop event count when the spec has none")
    ap.add_argument("--dump-trace", default="",
                    help="write the realized Poisson schedule as JSONL "
                         "(replayable via the spec's serve_trace)")
    ap.add_argument("--stats-json", default="",
                    help="write the ServeLoopStats summary JSON here")
    ap.add_argument("--snapshot-dir", default="",
                    help="serve-loop crash-resume snapshot directory")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="snapshot the serve loop every N ticks "
                         "(0 = only the final/interrupt snapshot)")
    ap.add_argument("--resume", default="",
                    help="resume a serve loop from this snapshot dir "
                         "(bit-identical continuation of the trace)")
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


def peak_bytes(cfg, batch: int, cache_len: int) -> dict:
    """The device memory a launcher run is reckoned to need at its peak,
    from shapes alone (nothing is allocated): ``steps.peak_bytes`` of a
    decode step at ``batch`` over ``cache_len`` positions, the dry run's
    reckoning (the params, the cache, the step's inputs beside the
    previous step's logits, the larger of the params' draw and the step's
    own transient, and the runtime's workspaces).  The prompt goes through
    the cache one token at a time, so the launcher has no prefill of its
    own.  Returns the parts and their sum (``"total"``), in bytes."""
    return steps.peak_bytes(dict(cfg=cfg, kind="decode", batch=batch,
                                 seq=cache_len,
                                 args=steps.decode_args(cfg, batch,
                                                        cache_len)))


def check_fits_one_card(cfg, dev: torch.device, batch: int,
                        cache_len: int) -> dict:
    """Raise before allocating when a launcher run's reckoned peak
    (``peak_bytes``) outgrows one card (kimi-k2-1t-a32b's and
    nemotron-4-340b's params alone do); on the host, against one H100's
    80 GB.  Returns the reckoning."""
    need = peak_bytes(cfg, batch, cache_len)
    have = steps.card_bytes(dev)
    if need["total"] > have:
        n = M.count_params_analytic(cfg)
        raise ValueError(
            f"{cfg.name}: {n:,} params take {need['params'] / 1e9:.1f} GB, "
            f"a run at batch {batch} over {cache_len} positions "
            f"{need['total'] / 1e9:.1f} GB, more than one card's "
            f"{have / 1e9:.1f} GB; serve it reduced (without --full-config)")
    return need


def greedy_decode(cfg, params, prompts, n_gen: int, *, device=None,
                  memory=None) -> dict:
    """Feed ``prompts`` (B, Sp) through a fresh KV cache one token at a
    time, then decode ``n_gen`` tokens greedily, as the JAX launcher does;
    an audio model attends ``memory`` (B, M, d_embed) at every step.
    Returns {tokens (B, n_gen) int64 numpy, logits (B, V) fp32 of the last
    step, prefill_s, decode_s} (host clock, the device synchronised)."""
    dev = resolve_device(device)
    prompts = torch.as_tensor(prompts).to(dev)
    if memory is not None:
        memory = torch.as_tensor(memory).to(dev)
    B, Sp = prompts.shape
    cache = M.init_cache(cfg, B, Sp + n_gen, device=dev)
    step = make_serve_step(cfg, device=dev)

    def at(t: int) -> torch.Tensor:
        return torch.full((B,), t, dtype=torch.int32, device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    logits = None
    for t in range(Sp):
        logits, cache = step(params, cache, prompts[:, t:t + 1], at(t),
                             memory)
    _sync(dev)
    t_pre = time.perf_counter() - t0

    tok = logits.argmax(dim=-1)[:, None]
    outs = []
    t0 = time.perf_counter()
    for t in range(Sp, Sp + n_gen):
        outs.append(tok[:, 0])
        logits, cache = step(params, cache, tok, at(t), memory)
        tok = logits.argmax(dim=-1)[:, None]
    _sync(dev)
    t_dec = time.perf_counter() - t0
    return {"tokens": torch.stack(outs, dim=1).cpu().numpy(),
            "logits": logits, "prefill_s": t_pre, "decode_s": t_dec}


def serve_loop(args) -> dict:
    """``--serve-loop``: run the loop on ``args.device``, print the JAX
    launcher's lines and return the stats summary."""
    from repro_torch.core.load_gen import (PoissonLoadGen, agent_rates,
                                           write_trace)
    from repro_torch.core.scenario import ScenarioSpec
    from repro_torch.fedsim.serving import run_serve_loop

    dev = resolve_device(args.device)
    if args.scenario_json:
        with open(args.scenario_json) as f:
            spec = ScenarioSpec.from_json(f.read())
        if not spec.serve_events:
            spec = spec.replace(engine="async",
                                serve_events=args.events).validate()
    else:
        spec = ScenarioSpec(
            n_agents=24, n_rsus=4, batch=16, n_train=2400, n_test=400,
            engine="async", staleness_decay=1.0, rounds=2,
            serve_events=args.events, queue_capacity=96).validate()
    res = spec.resolve()

    if args.dump_trace:
        rates = agent_rates(spec.het, spec.n_agents, spec.arrival_rate,
                            seed=res.cfg.seed)
        write_trace(PoissonLoadGen(rates, seed=res.cfg.seed,
                                   n_events=spec.serve_events).events(),
                    args.dump_trace)
        print(f"[trace] {spec.serve_events} events -> {args.dump_trace}")

    _, hist, stats, _ = run_serve_loop(
        res, device=dev, probe_x=res.test.x[:64],
        snapshot_dir=args.snapshot_dir or None,
        snapshot_every=args.snapshot_every,
        resume_from=args.resume or None)
    s = stats.summary()
    print(f"[serve-loop] {spec.n_agents} agents / {spec.n_rsus} RSUs, "
          f"trigger={spec.tick_trigger!r} "
          f"capacity={spec.queue_capacity or 'inf'} "
          f"policy={spec.overload_policy}")
    print(f"[events] generated={s['events_generated']} "
          f"absorbed={s['events_absorbed']} "
          f"coalesced={s['events_coalesced']} "
          f"dropped={s['events_dropped']} "
          f"deferred={s['events_deferred']}")
    print(f"[ticks] {s['n_ticks']} ticks / {s['n_rounds']} rounds | "
          f"{s['updates_per_s']:.0f} upd/s "
          f"p50={s['tick_p50_ms']:.1f}ms p99={s['tick_p99_ms']:.1f}ms | "
          f"queue depth mean={s['queue_depth_mean']:.1f} "
          f"max={s['queue_depth_max']}")
    print(f"[staleness] event wait mean={s['event_wait_mean']:.2f} "
          f"(sim), model staleness mean={s['model_staleness_mean']:.1f} "
          f"ticks | probes={s['serve_requests']} "
          f"p50={s['serve_p50_ms']:.2f}ms")
    if len(hist["acc"]):
        print(f"[acc] cloud accuracy {hist['acc'][0]:.3f} -> "
              f"{hist['acc'][-1]:.3f} over {s['n_rounds']} virtual rounds")
    if args.stats_json:
        with open(args.stats_json, "w") as f:
            json.dump(s, f, indent=1)
        print(f"[json] {args.stats_json}")
    return s


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Parse ``argv``, serve, print the JAX launcher's lines and return
    ``greedy_decode``'s dict plus tok_per_s (``--serve-loop``: the loop's
    stats summary)."""
    args = _parser().parse_args(argv)
    if args.serve_loop:
        return serve_loop(args)
    dev = resolve_device(args.device)
    cfg = (get_reduced_config if args.reduced else get_config)(args.arch)
    if args.window:
        cfg = cfg.replace(attn_window=args.window)
    if cfg.encoder.kind == "vision":
        raise SystemExit("text decode launcher; VLM needs the image path")
    if not args.reduced:
        check_fits_one_card(cfg, dev, args.batch,
                            args.prompt_len + args.gen)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = M.init_params(cfg, gen, device=dev)
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        params = ckpt.restore(args.ckpt_dir, like=params)
        print(f"[ckpt] restored step {ckpt.latest_step(args.ckpt_dir)}")

    rng = np.random.default_rng(args.seed)
    B, Sp = args.batch, args.prompt_len
    prompts = rng.integers(0, cfg.vocab_size, (B, Sp))
    memory = None
    if cfg.encoder.kind == "audio":
        memory = rng.standard_normal(
            (B, cfg.encoder.n_positions, cfg.encoder.d_embed)).astype(
                np.float32)
    res = greedy_decode(cfg, params, prompts, args.gen, device=dev,
                        memory=memory)
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
