"""Federated LLM fine-tuning with the hierarchical round, on the card.

    PYTHONPATH=src python examples/federated_finetune_llm_torch.py \\
        [--arch qwen3-0.6b] [--rounds 8] [--quantize-cloud] \\
        [--full-config] [--device cpu]

The PyTorch twin of ``examples/federated_finetune_llm.py``: the paper's
Algorithms 1-3 over a (pod=2, data=4) mesh of ranks, 2 RSUs x 4 traffic
agents, one process an agent (``repro_torch.launch.train``).  Each agent
holds its own Markov token shard (Non-IID) and trains E local epochs with
the dual-proximal objective (kernel #3 on each leaf, attention through
kernel #4 and its backward); the RSUs reduce over the `data` ranks LAR
times, the cloud over the `pod` ranks once, optionally int8-quantized.

The model is the reduced variant of the arch unless ``--full-config`` (the
full qwen3-0.6b takes 8 ranks' share of one 80 GB card at a short
``--seq``).  ``--device cpu`` runs the plain PyTorch versions on the host.
"""
import argparse

from repro_torch.launch import train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--lar", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--csr", type=float, default=0.5)
    ap.add_argument("--mesh", default="2,4,1")
    ap.add_argument("--quantize-cloud", action="store_true",
                    help="int8 cross-pod aggregation (beyond-paper)")
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    res = train.main([
        "--arch", args.arch, "--rounds", str(args.rounds), "--lar",
        str(args.lar), "--epochs", str(args.epochs), "--seq", str(args.seq),
        "--batch", str(args.batch), "--csr", str(args.csr), "--mesh",
        args.mesh, "--device", args.device,
        *(["--quantize-cloud"] if args.quantize_cloud else []),
        *(["--full-config"] if args.full_config else [])])
    print(f"[done] loss {res['init_loss']:.4f} -> {res['loss'][-1]:.4f} "
          f"across {len(res['peak_bytes_by_rank'])} agents, "
          f"CSR={args.csr:.0%}"
          + (", int8 cloud aggregation" if args.quantize_cloud else ""))
    return res


if __name__ == "__main__":
    main()
