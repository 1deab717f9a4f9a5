"""Training launcher (``repro/launch/train.py``): H2-Fed hierarchical rounds
of an LLM over a mesh of ranks, one rank an agent.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        [--mesh 2,4,1] [--full-config] [--rounds 4] [--lar 4] [--epochs 1] \\
        [--csr 0.8] [--quantize-cloud | --flat-agg] [--async-rounds D] \\
        [--fleet-dtype bfloat16] [--adaptive-mu] [--ckpt-dir d] \\
        [--seq 128 --batch 4] [--device cuda]

Runs the paper's Algorithms 1-3 (``launch/h2fed_round``) over synthetic
Non-IID token streams, one per agent, with checkpointing and the optional
adaptive-mu orchestration (``core/orchestrator``), and prints the JAX
launcher's lines.  ``--mesh pod,data,model`` gives the rank count, pod x
data x model: one agent a (pod, data) position, its model split over the
``model`` ranks (tensor parallelism, the decoder GQA family; each rank
draws the params from the seed and keeps its blocks in the round's
layout, ``sharding.param_shardings_model_only``, which is the reference's
``in_shardings``).  The eval loss runs the same split forward;
checkpoints and the returned ``cloud`` are the gathered tree, written
and returned by rank 0.  ``run_ranks`` starts the ranks over ``nccl``
when every rank has a card of its own and over ``gloo`` when ranks share
one card or run on the CPU.
``--devices`` (the reference's host-device count) is only checked against
that product.  ``--device cpu`` runs the plain PyTorch versions on the
host.

``--scenario-json spec.json`` instead runs a declarative scenario
(``core/scenario.ScenarioSpec``) through the fedsim engines.
"""
from __future__ import annotations

import argparse
import time
from math import prod
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch


def _decay_arg(s: str):
    """float, or comma list -> tuple of per-pod/RSU decay rates."""
    vals = tuple(float(x) for x in s.split(","))
    return vals[0] if len(vals) == 1 else vals


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="reduced config (the default)")
    ap.add_argument("--full-config", dest="reduced", action="store_false")
    ap.add_argument("--devices", type=int, default=None,
                    help="checked against the mesh's rank count when given")
    ap.add_argument("--mesh", default="2,4,1",
                    help="pod,data,model mesh shape")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--lar", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--mu1", type=float, default=0.001)
    ap.add_argument("--mu2", type=float, default=0.005)
    ap.add_argument("--csr", type=float, default=0.8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--quantize-cloud", action="store_true")
    ap.add_argument("--flat-agg", action="store_true",
                    help="flat-buffer aggregation: one collective per "
                         "hierarchy layer instead of per-leaf reductions")
    ap.add_argument("--async-rounds", type=int, default=0, metavar="D",
                    help="semi-async rounds: agents deliver up to D local "
                         "ticks late with staleness-decayed weight "
                         "(implies --flat-agg; 0 = synchronous)")
    ap.add_argument("--staleness-decay", type=_decay_arg, default=0.5,
                    metavar="D[,D...]",
                    help="per-tick decay of late deliveries; a comma list "
                         "gives one rate per pod/RSU")
    ap.add_argument("--buffer-keep", type=float, default=0.0,
                    help="RSU cohort mass retained across ticks [0, 1]")
    ap.add_argument("--fleet-dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="aggregation-reduction dtype (implies --flat-agg "
                         "when bfloat16)")
    ap.add_argument("--adaptive-mu", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--scenario-json", default="", metavar="PATH",
                    help="run a declarative ScenarioSpec through the fedsim "
                         "engines instead of the LM path")
    ap.add_argument("--scenario-pretrain", action="store_true",
                    help="with --scenario-json: run the spec's OEM "
                         "pretrain stage first")
    ap.add_argument("--fleet-store", default="",
                    choices=("", "device", "host"),
                    help="with --scenario-json: override the spec's fleet "
                         "row storage")
    ap.add_argument("--chunk-agents", type=int, default=-1, metavar="C",
                    help="with --scenario-json: override the spec's "
                         "streamed chunk size (0 = auto)")
    return ap


def _run_scenario_json(args) -> dict:
    """One declarative scenario end to end through its engine."""
    from repro_torch.configs.mnist_mlp import CONFIG as MLP_CFG
    from repro_torch.core.scenario import ScenarioSpec
    from repro_torch.device import resolve_device
    from repro_torch.fedsim import pretrain_to_target, run_scenario
    from repro_torch.models import mlp

    dev = resolve_device(args.device)
    spec = ScenarioSpec.from_json(Path(args.scenario_json).read_text())
    if args.fleet_store:
        spec = spec.replace(fleet_store=args.fleet_store)
    if args.chunk_agents >= 0:
        spec = spec.replace(chunk_agents=args.chunk_agents)
    spec.validate()
    res = spec.resolve()
    print(f"[scenario] {args.scenario_json}  cache_key={spec.cache_key}")
    print(f"[scenario] engine={spec.engine} partition={spec.partition} "
          f"A={spec.n_agents} R={spec.n_rsus} rounds={spec.rounds} "
          f"fleet_store={spec.fleet_store} chunk_agents={spec.chunk_agents}")
    params = mlp.init_params(MLP_CFG, torch.Generator().manual_seed(
        spec.seed), device=dev)
    if args.scenario_pretrain:
        params, pre_acc = pretrain_to_target(
            params, res.pretrain_pool, res.test.x, res.test.y,
            target_acc=spec.pretrain_target, seed=spec.seed, device=dev)
        print(f"[pretrain] biased OEM model: test acc {pre_acc:.3f}")
    _, hist = run_scenario(res, params, device=dev)
    for r, a in zip(hist["round"], hist["acc"]):
        print(f"[round {r:3d}] acc {a:.4f}")
    print("[done]")
    return {"acc": [float(a) for a in hist["acc"]]}


def agent_streams(cfg, args, n_agents: int) -> list:
    """One Non-IID token stream an agent: an order-2 Markov chain with its
    own transition table (seed 100 + agent)."""
    from repro_torch.data.synthetic import lm_token_task
    return [lm_token_task(vocab=min(cfg.vocab_size, 512),
                          n_tokens=args.lar * args.batch * (args.seq + 1) * 4,
                          seed=100 + a) for a in range(n_agents)]


def round_inputs(streams, rng: np.random.Generator, r: int, args) -> dict:
    """Round ``r``'s global host arrays, as the reference builds them: the
    batch ``(LAR, A, b, S)`` (each agent's stream from its round offset),
    the CSR mask ``(LAR, A)`` and the data volumes ``(A,)`` and, with
    ``--async-rounds``, the delays ``(LAR, A)``, drawn from ``rng`` in the
    reference's order.  Every rank builds the same arrays."""
    A = len(streams)
    n = args.batch * (args.seq + 1)
    toks = np.zeros((args.lar, A, args.batch, args.seq), np.int32)
    labs = np.zeros_like(toks)
    for a in range(A):
        off = (r * args.lar * n) % max(len(streams[a]) - n * args.lar, 1)
        for l in range(args.lar):
            seg = np.resize(streams[a][off + l * n: off + (l + 1) * n], n)
            seg = seg.reshape(args.batch, args.seq + 1)
            toks[l, a], labs[l, a] = seg[:, :-1], seg[:, 1:]
    mask = (rng.random((args.lar, A)) < args.csr).astype(np.float32)
    out = {"batch": {"tokens": toks, "labels": labs}, "mask": mask,
           "n_data": np.full((A,), float(args.batch * args.seq), np.float32)}
    if args.async_rounds:
        out["delays"] = rng.integers(0, args.async_rounds + 1,
                                     (args.lar, A)).astype(np.int32)
    return out


def _train_rank(args) -> dict:
    """One rank's whole run (module level: ``run_ranks`` spawns it)."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs.registry import get_config, get_reduced_config
    from repro_torch.core import orchestrator as orch
    from repro_torch.core.h2fed import H2FedParams
    from repro_torch.core.topology import HierarchyTopology
    from repro_torch.kernels import ops
    from repro_torch.launch import collectives
    from repro_torch.launch import sharding as shard
    from repro_torch.launch.h2fed_round import comm_model, make_h2fed_round
    from repro_torch.launch.mesh import FleetMesh
    from repro_torch.models import model as M
    from repro_torch import tree

    dev = torch.device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh = FleetMesh(args.mesh_shape, ("pod", "data", "model"))
    topo = HierarchyTopology.from_mesh(mesh)
    A = topo.n_agents
    lead = mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    cfg = (get_reduced_config if args.reduced else get_config)(args.arch)
    if cfg.encoder.kind != "none":
        raise SystemExit("text-only archs for the LM training launcher")
    base_hp = H2FedParams(mu1=args.mu1, mu2=args.mu2, lar=args.lar,
                          local_epochs=args.epochs, lr=args.lr)
    axis = shard.ModelAxis(cfg, mesh) if mesh.shape["model"] > 1 else None
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), device=dev)
    n_par = sum(l.numel() for l in tree.leaves(params))
    layout = shard.param_shardings_model_only(params, mesh)
    cloud = shard.shard_tree(params, layout)     # this rank's blocks
    del params
    cm = comm_model(cfg, base_hp, mesh, quantize_cloud=args.quantize_cloud)
    say(f"[mesh] {mesh.shape}  agents={A}  backend={mesh.backend}")
    say(f"[model] {args.arch}{' (reduced)' if args.reduced else ''}: "
        f"{n_par/1e6:.1f}M params")
    say(f"[comm] ici={cm['ici_bytes_per_dev']/1e6:.1f}MB "
        f"dci={cm['dci_bytes_per_dev']/1e6:.1f}MB per rank a round "
        f"(analytical)")

    streams = agent_streams(cfg, args, A)
    rng = np.random.default_rng(args.seed)
    mu_state, mu_cfg = orch.init_state(), orch.AdaptiveMuConfig()
    hp = base_hp
    round_fns = {}
    n_ev = args.batch * args.seq
    ev = {"tokens": torch.as_tensor(streams[0][:n_ev].reshape(
              args.batch, args.seq)).to(dev),
          "labels": torch.as_tensor(streams[0][1:n_ev + 1].reshape(
              args.batch, args.seq)).to(dev)}

    def eval_loss(blocks) -> float:
        """The eval batch's loss, through the split forward on a model
        axis above 1."""
        with torch.no_grad():
            if axis is None:
                return float(M.loss_fn(cfg, blocks, ev)[0])
            shards = axis.to_compute(tree.leaves(blocks), where="eval")
            return float(M.loss_fn(axis.local_cfg, tree.unflatten(
                blocks, shards), ev, tp=mesh)[0])

    def gathered():
        """The whole cloud tree on every rank (a collective)."""
        return shard.gather_tree(cloud, layout)

    out = {"init_loss": eval_loss(cloud), "loss": [], "csr_obs": [],
           "mu": [], "mass": [], "round_ms": [], "launches": [],
           "collectives": []}
    say(f"[init] eval loss {out['init_loss']:.4f}")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for r in range(args.rounds):
        if args.adaptive_mu:
            hp, _ = orch.schedule(mu_state, mu_cfg, base_hp)
        key = (hp.mu1, hp.mu2)
        if key not in round_fns:
            round_fns[key] = make_h2fed_round(
                cfg, hp, mesh, quantize_cloud=args.quantize_cloud,
                flat_agg=args.flat_agg, async_rounds=args.async_rounds,
                staleness_decay=args.staleness_decay,
                buffer_keep=args.buffer_keep, fleet_dtype=args.fleet_dtype,
                device=dev)
        inp = round_inputs(streams, rng, r, args)
        ops.reset_launch_counts()
        collectives.reset()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        cloud, metrics = round_fns[key](
            cloud, inp["batch"], inp["mask"], inp["n_data"],
            *([inp["delays"]] if args.async_rounds else []))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out["round_ms"].append((time.perf_counter() - t0) * 1e3)
        out["launches"].append(ops.launch_counts())
        out["collectives"].append(collectives.counts())
        observed = float(inp["mask"].mean())
        mu_state = orch.observe_csr(mu_state, mu_cfg, observed, 1.0)
        loss = eval_loss(cloud)
        mass = float(metrics["surviving_mass"])
        for k, v in (("loss", loss), ("csr_obs", observed),
                     ("mu", (hp.mu1, hp.mu2)), ("mass", mass)):
            out[k].append(v)
        say(f"[round {r+1:3d}] loss {loss:.4f} csr_obs {observed:.2f} "
            f"mu=({hp.mu1:.4f},{hp.mu2:.4f}) mass {mass:.0f}")
        if args.ckpt_dir and (r + 1) % args.ckpt_every == 0:
            full = gathered()
            if lead:
                say(f"[ckpt] {ckpt.save(args.ckpt_dir, r + 1, full)}")
            del full
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    out["peak_bytes_by_rank"] = collectives.all_gather_objects(
        peak, mesh, mesh.axis_names, where="gather")
    out["cloud"] = tree.map_tree(lambda t: t.detach().cpu(), gathered())
    say("[done]")
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Parse ``argv``, run, print the JAX launcher's lines and return rank
    0's record (eval losses, masses, the mus, and each round's wall time,
    kernel launches and collectives; the final cloud params, gathered, on
    the host; each rank's peak device memory, in rank order)."""
    args = _parser().parse_args(argv)
    if args.scenario_json:
        return _run_scenario_json(args)
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import run_ranks

    dev = resolve_device(args.device)
    args.mesh_shape = tuple(int(x) for x in args.mesh.split(","))
    if len(args.mesh_shape) != 3:
        raise SystemExit(f"--mesh wants pod,data,model, got {args.mesh}")
    n = prod(args.mesh_shape)
    if args.devices is not None and args.devices != n:
        raise SystemExit(f"--devices {args.devices} does not match the mesh "
                         f"{args.mesh} ({n} ranks)")
    if args.async_rounds and not args.flat_agg:
        print("[async] --async-rounds implies --flat-agg (raveled pending "
              "buffer); enabling it")
        args.flat_agg = True
    if args.fleet_dtype != "float32" and not args.flat_agg:
        print("[dtype] --fleet-dtype implies --flat-agg (storage-dtype "
              "reduction on the raveled buffer); enabling it")
        args.flat_agg = True
    own_cards = dev.type == "cuda" and n <= torch.cuda.device_count()
    return run_ranks(n, _train_rank, args,
                     backend="nccl" if own_cards else "gloo",
                     device=dev.type)


if __name__ == "__main__":
    main()
