"""The dry run of every (architecture x input shape) cell on one card: the
counterpart of ``repro/launch/dryrun.py``, which compiles each cell for a
256- or 512-chip TPU mesh and records its memory, cost and roofline.  On
one H100 each cell goes through these steps, in order:

1. Its peak device memory is reckoned before anything is allocated, from
   its arguments' shapes on the meta device (``steps.peak_bytes``, the
   serve launcher's reckoning too).
2. A cell reckoned not to fit records ``fits: false``, its reckoned parts
   and the card's bytes, and nothing is allocated.  No smaller batch,
   sequence or depth takes its place: a cut variant runs only where the
   caller passes ``--override``, and its record says so.
3. A cell that fits runs on the card: its arguments drawn from ``--seed``
   (``steps.materialize``; each architecture's params are drawn once and
   freed before the next architecture's), one counted call (the kernels'
   launches, each attention call's kernel route, the shapes and dtypes of
   each distinct kernel call, the step's FLOPs),
   then CUDA-event times over a few calls (median and spread), the peak of
   ``torch.cuda.max_memory_allocated`` beside the reckoning (and, in the
   cell that drew the params, the draw's own peak), and a roofline
   against the H100's 989 TFLOP/s bf16 and 3.35 TB/s.
4. FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the counted
   call, plus the hand-written kernels' work, which it cannot see (they
   are called through ctypes): #4's 2 (D + Dv) flops a live (query, key)
   pair and head, #5's recurrent products.  Bytes: the least traffic of
   the step, a bound and not a measurement: the params (of the routed
   experts the share its tokens can reach), the cache and the inputs read
   once, the outputs and the written cache slots (a recurrent state
   whole) written once.
5. A cell reckoned to fit that runs out of memory or raises is a failure:
   its ``*.FAIL.txt`` is written, the run goes on to the next cell and
   exits non-zero at the end.
6. Every record (a skipped one too) names the reference's production
   mesh, ``16x16`` (256 chips) or under ``--multi-pod`` ``2x16x16``
   (512 chips, records suffixed ``__mp``), and a cell's
   ``per_rank_argument_bytes``: the bytes of its arguments that one chip
   of that mesh holds under the reference's ``in_shardings``
   (``sharding.arg_bytes`` on the shape-only ``make_production_mesh``).
   That is a reckoning from shapes; no cell runs on that mesh.

The reference's ``hlo_analysis`` parses XLA's HLO text, which PyTorch
never produces; the per-cell cost and footprint above are the part of it
that the dry run needs.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
      --shape long_500k [--step h2fed_round] [--out results/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # 40 cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod

``--device cpu`` runs a cell's plain PyTorch versions on the host (a
smoke run of a ``--reduced`` config: host-clock times, no peak, FLOPs as
counted there).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import statistics
import time
import traceback
from collections import Counter
from pathlib import Path
from typing import Optional, Sequence

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tree
from repro_torch.configs.registry import ARCH_IDS, get_config, \
    get_reduced_config
from repro_torch.core.h2fed import H2FedParams
from repro_torch.device import resolve_device
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ops
from repro_torch.launch import sharding as shard
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.ssm import MambaCache

# H100 SXM data sheet (as chip_smoke.py's attention_bound)
PEAK_FLOPS = 989e12       # dense bf16 FLOP/s
HBM_BW = 3.35e12          # bytes/s
OUT = "results/dryrun_torch"


def parse_overrides(items: Sequence[str]) -> dict:
    """``KEY=VALUE`` strings as a dict, each value an int, else a float,
    else the string."""
    out = {}
    for item in items:
        k, v = item.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                pass
        out[k] = v
    return out


def apply_overrides(cfg, overrides: dict):
    """``cfg`` with the ArchConfig overrides applied, ``a.b=v`` replacing a
    field of the nested config ``a``."""
    flat = {k: v for k, v in overrides.items() if "." not in k}
    nested: dict = {}
    for k, v in overrides.items():
        if "." in k:
            outer, inner = k.split(".", 1)
            nested.setdefault(outer, {})[inner] = v
    for outer, kv in nested.items():
        flat[outer] = dataclasses.replace(getattr(cfg, outer), **kv)
    return cfg.replace(**flat) if flat else cfg


def cell_spec(arch: str, shape: str, step: str = "default",
              overrides: Optional[dict] = None, *, reduced: bool = False,
              device=None, mesh=None) -> dict:
    """The cell's spec (``steps.input_specs``, or ``h2fed_round.
    round_input_specs`` for ``step="h2fed_round"``, whose ``lar`` and
    ``quantize_cloud`` overrides are the step's own) on ``mesh`` (None:
    one rank)."""
    cfg = (get_reduced_config if reduced else get_config)(arch)
    overrides = dict(overrides or {})
    qc = bool(overrides.pop("quantize_cloud", False))
    lar = int(overrides.pop("lar", 4))
    cfg = apply_overrides(cfg, overrides)
    if step == "h2fed_round":
        from repro_torch.launch.h2fed_round import round_input_specs
        return round_input_specs(cfg, shape, mesh,
                                 hp=H2FedParams(local_epochs=1, lar=lar),
                                 quantize_cloud=qc, device=device)
    return steps_mod.input_specs(cfg, shape, mesh, device=device)


def mesh_fields(multi_pod: bool) -> dict:
    """The reference's production mesh of a record: its name and chips."""
    return {"mesh": "2x16x16" if multi_pod else "16x16",
            "n_chips": 512 if multi_pod else 256}


def per_rank_argument_bytes(arch: str, shape: str, step: str = "default",
                            overrides: Optional[dict] = None, *,
                            reduced: bool = False,
                            multi_pod: bool = False) -> int:
    """The bytes of the cell's arguments that one chip of the reference's
    production mesh holds under its ``in_shardings`` (shapes on the meta
    device and a ``ShapeMesh``: a reckoning)."""
    spec = cell_spec(arch, shape, step, overrides, reduced=reduced,
                     device="meta",
                     mesh=make_production_mesh(multi_pod=multi_pod))
    return shard.arg_bytes(spec["args"], spec["in_shardings"])


def reckon_cells(cells, step: str = "default") -> list:
    """(arch, shape, desc, ``steps.peak_bytes`` parts) of each (arch,
    shape) cell in order, desc and parts None for a ``SKIPS`` cell: host
    work on the meta device, nothing allocated."""
    out = []
    for arch, shape in cells:
        if (arch, shape) in steps_mod.SKIPS:
            out.append((arch, shape, None, None))
            continue
        spec = cell_spec(arch, shape, step, device="cpu")
        out.append((arch, shape, spec["desc"], steps_mod.peak_bytes(spec)))
    return out


# --------------------------------------------------------------------------
# work and traffic
# --------------------------------------------------------------------------

def live_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """(query, key) pairs #4's masks keep: S x T for keys of their own
    length; else query s sees keys t <= s when causal (t < S otherwise)
    and t > s - window."""
    if T != S:
        return S * T
    if not window or window >= S:
        return S * (S + 1) // 2 if causal else S * S
    w = window
    if causal:
        return w * (w + 1) // 2 + (S - w) * w
    # key t in [max(0, s - w + 1), S - 1]
    return S * S - (S - w) * (S - w + 1) // 2


def kernel_flops(log) -> dict:
    """The hand-written kernels' FLOPs from ``ops.logged_calls``'s
    entries: #4 2 (D + Dv) a live pair and head, #5 the recurrent h @ R
    products (2 x 4P^2 a step, head and row)."""
    out = Counter()
    for entry in log:
        if entry[0] == "flash_attention":
            (B, S, H, D), (_, T, _, _), v, causal, window, _ = entry[1:]
            out["flash_attention"] += (2 * B * H * (D + v[-1])
                                       * live_pairs(S, T, causal, window))
        else:
            (B, S, _), (H, P, _) = entry[1:3]
            out["slstm_scan"] += 2 * B * S * H * P * 4 * P
    return dict(out)


def kernel_calls(log) -> list:
    """The distinct entries of ``ops.logged_calls``, in the order first
    made, as JSON lists (shapes as lists, dtypes by name): the shapes and
    dtypes at which a cell launched its hand-written kernels."""
    out = []
    for entry in log:
        row = [str(x).removeprefix("torch.") if isinstance(x, torch.dtype)
               else list(x) if isinstance(x, tuple) else x for x in entry]
        if row not in out:
            out.append(row)
    return out


def kernel_routes(log) -> dict:
    """Each attention call's kernel (``flash_attention.forward_route``:
    ``tma_wgmma``, ``split_keys``, ...) by its launch count's key."""
    out = Counter()
    for entry in log:
        if entry[0] == "flash_attention":
            (_, S, _, D), (_, T, _, _), v, causal, window, dtype = entry[1:]
            key = _fa._launch_key(D, v[-1], T != S)
            route = _fa.forward_route(dtype, D, v[-1], S, causal, window)
            out[f"{key}:{route}"] += 1
    return dict(out)


def _expert_bytes(cfg, params) -> int:
    """Bytes of the routed experts' leaves."""
    if cfg.moe is None:
        return 0
    return sum(t.numel() * t.element_size()
               for path, t in tree.leaves_with_paths(params)
               if any(w in path for w in ("w_gate", "w_up", "w_down"))
               and "shared" not in path and cfg.moe.n_experts in t.shape)


def least_bytes(spec: dict) -> int:
    """The least traffic of one step: params, cache and inputs read once
    (of the routed experts, the share that the step's tokens can reach:
    tokens x top_k of E, at most all), outputs and written cache slots
    written once: a ring cache's one slot a row and layer, a recurrent
    state whole.  A bound, not a measurement."""
    cfg, kind, args = spec["cfg"], spec["kind"], spec["args"]
    nb = steps_mod._bytes
    params = M.meta_params(cfg)
    if kind in ("decode", "prefill"):
        tokens = (args[2] if kind == "decode" else args[1]["tokens"]).numel()
        experts = _expert_bytes(cfg, params)
        reach = min(1.0, tokens * cfg.moe.top_k / cfg.moe.n_experts) \
            if cfg.moe is not None else 1.0
        p_read = nb(params) - experts + reach * experts
        B = args[2].shape[0] if kind == "decode" else \
            args[1]["tokens"].shape[0]
        logits = 4 * B * cfg.vocab_size
        if kind == "prefill":
            return int(p_read + nb(args[1]) + logits)
        written = 0
        for c in steps_mod._caches(args[1]):
            if isinstance(c, MambaCache) or "pos" not in c._fields:
                written += nb(c)
            else:
                written += nb(c) // c.pos.shape[-1]
        return int(p_read + nb(args[1]) + written + nb(args[2:]) + logits)
    if kind == "train":
        state, batch_tree, mask = args
        # read: params, momentum, both anchors; written: params, momentum
        return (3 * nb(params) + 2 * nb(state.momentum) + nb(params)
                + nb(batch_tree) + nb(mask))
    _, batch_tree, mask, n_data = args
    return 2 * nb(params) + nb(batch_tree) + nb((mask, n_data))


# --------------------------------------------------------------------------
# one cell
# --------------------------------------------------------------------------

def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _check_out(spec: dict, out) -> None:
    """The step's output: finite fp32 next-token logits (B, V) for prefill
    and decode, a finite loss for train, finite cloud params for the
    round."""
    cfg, kind = spec["cfg"], spec["kind"]
    if kind in ("prefill", "decode"):
        logits = out if kind == "prefill" else out[0]
        want = (spec["batch"], cfg.vocab_size)
        if tuple(logits.shape) != want or logits.dtype != torch.float32:
            raise AssertionError(f"{kind}: logits {tuple(logits.shape)} "
                                 f"{logits.dtype}, want {want} float32")
        if not torch.isfinite(logits).all():
            raise AssertionError(f"{kind}: non-finite logits")
        return
    vals = ([out[1]["loss"]] if kind == "train"
            else tree.leaves(out[0]))
    if not all(torch.isfinite(v).all() for v in vals):
        raise AssertionError(f"{kind}: non-finite output")


def _times_ms(fn, args, dev, reps: int) -> list:
    """Per-call wall times: CUDA events on the card, the host clock on
    the CPU."""
    out = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn(*args)
            out.append((time.perf_counter() - t0) * 1e3)
    return out


class ParamStore:
    """One architecture's params at a time, drawn from ``seed`` once for
    every cell of it whose config draws the same tree, and freed (with
    the allocator's cache) before another's are drawn.  ``base`` is the
    device memory allocated before they were drawn; ``draw_peak`` the
    peak above it while they were drawn, until a cell takes it."""

    def __init__(self, dev: torch.device, seed: int):
        self.dev, self.seed = dev, seed
        self.key = self.params = self.draw_peak = None
        self.base = 0

    def get(self, cfg):
        key = cfg.replace(attn_window=0)
        if key != self.key:
            self.free()
            cuda = self.dev.type == "cuda"
            if cuda:
                self.base = torch.cuda.memory_allocated(self.dev)
                torch.cuda.reset_peak_memory_stats(self.dev)
            gen = torch.Generator(device=self.dev).manual_seed(self.seed)
            self.params = M.init_params(cfg, gen, device=self.dev)
            self.draw_peak = (torch.cuda.max_memory_allocated(self.dev)
                              - self.base if cuda else None)
            self.key = key
        return self.params

    def take_draw_peak(self) -> Optional[int]:
        """The last draw's peak, once: None after a cell has taken it."""
        peak, self.draw_peak = self.draw_peak, None
        return peak

    def free(self) -> None:
        self.key = self.params = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def run_cell(arch: str, shape: str, *, step: str = "default",
             overrides: Optional[dict] = None, reduced: bool = False,
             device=None, seed: int = 0,
             store: Optional[ParamStore] = None,
             multi_pod: bool = False) -> dict:
    """Reckon one cell and, where it fits, run it; returns its record."""
    dev = resolve_device(device)
    spec = cell_spec(arch, shape, step, overrides, reduced=reduced,
                     device=dev)
    cfg = spec["cfg"]
    need = steps_mod.peak_bytes(spec)
    have = steps_mod.card_bytes(dev)
    rec = {"arch": arch, "shape": shape, "step": step, "desc": spec["desc"],
           **mesh_fields(multi_pod),
           "per_rank_argument_bytes": per_rank_argument_bytes(
               arch, shape, step, overrides, reduced=reduced,
               multi_pod=multi_pod),
           "per_rank_argument_bytes_is": "reckoned from shapes under the "
           "reference's in_shardings on its production mesh; the cell runs "
           "on one card, not there",
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
           "adapted_window": cfg.attn_window, "reduced": reduced,
           "seed": seed, "card_bytes": have, "reckoned": need,
           "fits": need["total"] <= have}
    if overrides:
        rec["overrides"] = overrides
    if not rec["fits"]:
        return rec

    store = store or ParamStore(dev, seed)
    params = store.get(cfg)
    draw_peak = store.take_draw_peak()
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    args = steps_mod.materialize(spec, gen, dev, params=params)
    fn = spec["fn"]

    # the counted call (also the warm call): launches, attention routes,
    # FLOPs; then the timed calls, more of them for a short step
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc, ops.logged_calls() as log:
        out = fn(*args)
        _sync(dev)
    first = (time.perf_counter() - t0) * 1e3
    _check_out(spec, out)
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    del out
    times = _times_ms(fn, args, dev, 3 if first > 2000.0 else
                      5 if first > 100.0 else 20)
    peak = (torch.cuda.max_memory_allocated(dev) - store.base
            if dev.type == "cuda" else None)
    del args
    counted = fc.get_total_flops()
    kernels = kernel_flops(log) if dev.type == "cuda" else {}
    flops = counted + sum(kernels.values())
    nbytes = least_bytes(spec)
    measured_s = statistics.median(times) / 1e3
    roof = {"compute_s": flops / PEAK_FLOPS, "memory_s": nbytes / HBM_BW}
    roof["dominant"] = max(("compute_s", "memory_s"), key=roof.get)
    roof["measured_s"] = measured_s
    roof["share"] = roof[roof["dominant"]] / measured_s
    rec.update({
        "measured": {"peak_bytes": peak, "draw_peak_bytes": draw_peak,
                     "ms_median": statistics.median(times),
                     "ms_min": min(times), "ms_max": max(times),
                     "reps": len(times), "first_ms": first},
        "launches": launches, "routes": kernel_routes(log),
        "calls": kernel_calls(log),
        "cost": {"flops": flops, "flops_counted": counted,
                 "flops_kernels": kernels, "bytes_bound": nbytes},
        "roofline": roof})
    return rec


def _cell_tag(arch: str, shape: str, step: str = "default",
              tag: str = "", multi_pod: bool = False) -> str:
    return (f"{arch}__{shape}" + ("__mp" if multi_pod else "")
            + ("" if step == "default" else f"__{step}")
            + (f"__{tag}" if tag else ""))


def summary(rec: dict) -> str:
    """One line: fits, reckoned and measured peak, ms, launches, roofline
    share."""
    need = rec["reckoned"]
    gb = 1e9
    if "skipped" in rec:
        return f"skipped: {rec['skipped']}"
    if not rec["fits"]:
        return (f"fits=False reckoned={need['total'] / gb:.2f} GB > card "
                f"{rec['card_bytes'] / gb:.2f} GB (params "
                f"{need['params'] / gb:.2f}, cache {need['cache'] / gb:.2f}, "
                f"state {need['state'] / gb:.2f}, transient "
                f"{need['transient'] / gb:.2f})")
    m, r = rec["measured"], rec["roofline"]
    peak = ("not measured" if m["peak_bytes"] is None
            else f"{m['peak_bytes'] / gb:.2f} GB")
    if m.get("draw_peak_bytes") is not None:
        peak += f" (params' draw {m['draw_peak_bytes'] / gb:.2f} GB)"
    return (f"fits=True reckoned={need['total'] / gb:.2f} GB peak={peak} "
            f"ms={m['ms_median']:.3f} ({m['ms_min']:.3f}-{m['ms_max']:.3f}, "
            f"{m['reps']} calls) launches={rec['launches']} "
            f"routes={rec['routes']} flops={rec['cost']['flops']:.3e} "
            f"bytes={rec['cost']['bytes_bound']:.3e} "
            f"dominant={r['dominant']} roofline_share={r['share']:.4f}")


def run_cells(cells, out_dir, *, step: str = "default",
              overrides: Optional[dict] = None, reduced: bool = False,
              device=None, seed: int = 0, tag: str = "",
              multi_pod: bool = False) -> tuple:
    """Each (arch, shape) cell in turn, arch by arch: one JSON record a
    cell in ``out_dir`` (``SKIPS`` cells as skipped; a cell whose record
    exists is not run again), a ``*.FAIL.txt`` for a cell that raised.
    Prints one line a cell; returns (records, failures)."""
    dev = resolve_device(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    store = ParamStore(dev, seed)
    records, failures = [], 0
    for arch, shape in cells:
        name = _cell_tag(arch, shape, step, tag, multi_pod)
        path = out_dir / f"{name}.json"
        if path.exists():
            print(f"[skip-cached] {name}")
            continue
        if (arch, shape) in steps_mod.SKIPS:
            rec = {"arch": arch, "shape": shape, **mesh_fields(multi_pod),
                   "skipped": steps_mod.SKIPS[(arch, shape)]}
            path.write_text(json.dumps(rec, indent=1))
            records.append(rec)
            print(f"[SKIP] {name}: {rec['skipped']}", flush=True)
            continue
        try:
            rec = run_cell(arch, shape, step=step, overrides=overrides,
                           reduced=reduced, device=dev, seed=seed,
                           store=store, multi_pod=multi_pod)
        except Exception:  # noqa: BLE001 — record and go on
            failures += 1
            text = traceback.format_exc()
            (out_dir / f"{name}.FAIL.txt").write_text(text)
            print(f"[FAIL] {name}: {text.strip().splitlines()[-1][:300]}",
                  flush=True)
            store.free()
            continue
        path.write_text(json.dumps(rec, indent=1))
        records.append(rec)
        print(f"[{'ok' if rec['fits'] else 'no-fit'}] {name}: "
              f"{summary(rec)}", flush=True)
    store.free()
    return records, failures


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(steps_mod.SHAPES))
    ap.add_argument("--multi-pod", action="store_true",
                    help="record the reference's 2x16x16 mesh (512 chips) "
                         "in place of its 16x16; files suffixed __mp")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--step", default="default",
                    choices=("default", "h2fed_round"))
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--override", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="ArchConfig override (a.b=v for a nested config), "
                         "e.g. --override mlstm_chunk=128 (repeatable); the "
                         "record says so")
    ap.add_argument("--tag", default="",
                    help="suffix for the result file (variants)")
    ap.add_argument("--reduced", action="store_true",
                    help="the family's reduced config (a smoke run)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def main(argv: Optional[Sequence[str]] = None) -> list:
    args = _parser().parse_args(argv)
    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in steps_mod.SHAPES]
    else:
        if not (args.arch and args.shape):
            raise SystemExit("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]
    records, failures = run_cells(
        cells, args.out, step=args.step,
        overrides=parse_overrides(args.override), reduced=args.reduced,
        device=args.device, seed=args.seed, tag=args.tag,
        multi_pod=args.multi_pod)
    if failures:
        raise SystemExit(f"{failures} dry-run cells failed")
    return records


if __name__ == "__main__":
    main()
