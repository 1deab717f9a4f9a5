"""``chip_smoke.py`` on the CPU: its report of the compiler's per-kernel
resources (each ``Used N registers`` line of ``nvcc -Xptxas -v`` printed
with the name of the kernel it belongs to, and with that kernel's stack and
spill line), and which phases each of its modes runs.  Only the parsing
and the phase selection are checked here, with the card and the phases
faked."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

LOG = """== flash_attention.cu
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_16kernelEv' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_16kernelEv
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z5otherPf' for 'sm_90a'
ptxas info    : Function properties for _Z5otherPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 16 bytes smem
"""


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_ptxas_lines_name_their_kernel():
    lines = _chip_smoke().ptxas_by_kernel(LOG)
    assert len(lines) == 2
    first, second = lines
    # demangled where c++filt is installed, else the mangled name
    assert first.startswith(("(anonymous namespace)::kernel()",
                             "_ZN12_GLOBAL__N_16kernelEv"))
    assert "4 bytes spill stores" in first
    assert "Used 168 registers, used 16 barriers" in first
    assert second.startswith(("other(float*)", "_Z5otherPf"))
    assert "Used 40 registers" in second and "16 bytes smem" in second
    assert "168" not in second


def test_ptxas_notes_keep_serialization_lines():
    log = LOG + ("ptxas info    : (C7512) Potential Performance Loss: "
                 "wgmma.mma_async instructions are serialized due to "
                 "insufficient register resources for the function 'k'\n")
    notes = _chip_smoke().ptxas_notes(log)
    assert notes == ["(C7512) Potential Performance Loss: wgmma.mma_async "
                     "instructions are serialized due to insufficient "
                     "register resources for the function 'k'"]
    assert _chip_smoke().ptxas_notes(LOG) == []


# the functions that run each phase after the build, by name
PHASE_RUNNERS = ("aggregation_cases", "attention_cases", "slstm_cases",
                 "flat_round", "main_path", "async_path", "sweep_path",
                 "stream_path", "serve_path", "sharded_path", "serving_path",
                 "xlstm_serving", "moe_serving", "hybrid_serving",
                 "audio_serving", "vision_serving", "dense_serving",
                 "dryrun_path", "dryrun_matrix", "train_path")


@pytest.mark.parametrize("flag,runs", [("--attention", ["attention_cases"]),
                                       ("--scan", ["slstm_cases"]),
                                       ("--agg", ["aggregation_cases"]),
                                       ("--round", ["flat_round"]),
                                       ("--async", ["async_path"]),
                                       ("--sweep", ["sweep_path"]),
                                       ("--stream", ["stream_path"]),
                                       ("--serve", ["serve_path"]),
                                       ("--sharded", ["sharded_path"]),
                                       ("--train", ["train_path"]),
                                       ("--moe", ["moe_serving"]),
                                       ("--hybrid", ["hybrid_serving"]),
                                       ("--audio", ["audio_serving"]),
                                       ("--vision", ["vision_serving"]),
                                       ("--dense", ["dense_serving"]),
                                       ("--cells", ["dryrun_path"]),
                                       ("--dryrun", ["dryrun_matrix"])])
def test_modes_run_their_phase_and_print_no_result(monkeypatch, capsys,
                                                   flag, runs):
    """A mode runs the build and its kernel's phase, nothing else, and
    exits 0 without the result line; checked with the card and the
    phases faked, so no card is needed."""
    cs = _chip_smoke()
    called = []
    monkeypatch.setattr(cs.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cs, "device_and_build",
                        lambda: ("cuda", "NVIDIA H100 80GB HBM3, 700.00 W"))
    for name in PHASE_RUNNERS:
        monkeypatch.setattr(cs, name,
                            lambda dev, name=name: called.append(name) or [])
    assert cs.main([flag]) == 0
    assert called == runs
    assert '"ok"' not in capsys.readouterr().out


def test_phase_selection():
    cs = _chip_smoke()
    assert cs.selected_phases([]) == cs.FULL_RUN
    assert "5" in cs.FULL_RUN
    assert cs.selected_phases(["--scan"]) == ("1", "2c")
    assert cs.selected_phases(["--attention"]) == ("1", "2b")
    assert cs.selected_phases(["--round"]) == ("1", "3r")
    assert cs.selected_phases(["--async"]) == ("1", "3b")
    assert cs.selected_phases(["--stream"]) == ("1", "3t")
    assert cs.selected_phases(["--serve"]) == ("1", "3v")
    assert cs.selected_phases(["--sharded"]) == ("1", "3h")
    assert cs.selected_phases(["--train"]) == ("1", "5")
    assert cs.selected_phases(["--moe"]) == ("1", "4c")
    assert cs.selected_phases(["--hybrid"]) == ("1", "4d")
    assert cs.selected_phases(["--audio"]) == ("1", "4e")
    assert cs.selected_phases(["--vision"]) == ("1", "4f")
    assert cs.selected_phases(["--dense"]) == ("1", "4g")
    assert cs.selected_phases(["--cells"]) == ("1", "4h")
    assert cs.selected_phases(["--dryrun"]) == ("1", "dryrun")
    assert "4g" in cs.FULL_RUN and "4h" in cs.FULL_RUN
    assert "dryrun" not in cs.FULL_RUN
    assert "4c" in cs.FULL_RUN and "4d" in cs.FULL_RUN
    assert "4e" in cs.FULL_RUN and "4f" in cs.FULL_RUN
    assert "3b" in cs.FULL_RUN and "3t" in cs.FULL_RUN
    assert "3v" in cs.FULL_RUN and "3h" in cs.FULL_RUN
    with pytest.raises(SystemExit):
        cs.selected_phases(["--scan", "--attention"])
    with pytest.raises(SystemExit):
        cs.selected_phases(["--fast"])


def test_no_card_exits_nonzero_without_a_result(monkeypatch, capsys):
    cs = _chip_smoke()
    monkeypatch.setattr(cs.torch.cuda, "is_available", lambda: False)
    assert cs.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


KERNEL_KEYS = {"name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms"}


def test_full_run_prints_every_kernel_with_every_key(monkeypatch, capsys):
    """The full run's kernels line has all five kernels with every key the
    contract names, the launches of the main path's run beside each, then
    the card's line and the result line; checked with the card and the
    phases faked."""
    cs = _chip_smoke()
    card = "NVIDIA H100 80GB HBM3, 700.00 W"

    def agg_row(kernel, entry, **extra):
        return {"kernel": kernel, "entry": entry, "shape": "main", "A": 20,
                "R": 4, "N": 31_810, "dtype": "float32", "max_abs_err": 1e-7,
                "ms": 0.02, "plain_ms": 0.1, "bound_ms": 0.001,
                "bound_by": "bytes", "library_ms": None, "device_ms": 0.003,
                "host_us": 12.0, **extra}
    rows = [agg_row("fused_agg_blend", "agg_blend", library_ms=0.06),
            agg_row("fused_agg_blend", "agg_blend_coef"),
            agg_row("weighted_agg_matmul", "weighted_agg_matmul",
                    library_ms=0.016),
            agg_row("dual_proximal_sgd", "scaled_broadcast")]
    attn = [{"kernel": "flash_attention", "entry": "prefill",
             "max_abs_err": 4e-3, "ms": 2.6,
             "plain_ms": 126.0, "bound_ms": 1.1, "bound_by": "operations",
             "library_ms": 1.7, "shape": {}, "dtype": "bfloat16"},
            {"kernel": "flash_attention", "entry": "layer",
             "max_abs_err": 4e-3, "ms": 0.7,
             "plain_ms": 30.0, "bound_ms": 0.07, "bound_by": "operations",
             "library_ms": 0.5, "shape": {}, "dtype": "bfloat16"},
            {"kernel": "flash_attention_mla", "entry": "prefill",
             "max_abs_err": 8e-3, "ms": 9.0, "plain_ms": 200.0,
             "bound_ms": 1.4, "bound_by": "operations", "library_ms": 3.0,
             "library_padded_v": True, "shape": {}, "dtype": "bfloat16"},
            {"kernel": "flash_attention_d80", "entry": "prefill",
             "max_abs_err": 8e-3, "ms": 6.0, "plain_ms": 250.0,
             "bound_ms": 1.4, "bound_by": "operations", "library_ms": 2.0,
             "shape": {}, "dtype": "bfloat16"},
            {"kernel": "flash_attention_d96", "entry": "prefill",
             "max_abs_err": 8e-3, "ms": 1.2, "plain_ms": 60.0,
             "bound_ms": 0.42, "bound_by": "operations", "library_ms": 1.0,
             "shape": {}, "dtype": "bfloat16"},
            {"kernel": "flash_attention_d80", "entry": "d80_layer",
             "max_abs_err": 7e-3, "ms": 0.29, "plain_ms": 12.5,
             "bound_ms": 0.087, "bound_by": "operations", "library_ms": 0.29,
             "shape": {"D": 80}, "dtype": "bfloat16"},
            {"kernel": "flash_attention_d96", "entry": "d96_layer",
             "max_abs_err": 6e-3, "ms": 0.31, "plain_ms": 12.8,
             "bound_ms": 0.104, "bound_by": "operations", "library_ms": 0.28,
             "shape": {"D": 96}, "dtype": "bfloat16"},
            {"kernel": "flash_attention", "entry": "yi_prefill",
             "kernel_route": "tma_wgmma", "max_abs_err": 8e-3, "ms": 9.8,
             "plain_ms": 430.0, "bound_ms": 3.9, "bound_by": "operations",
             "library_ms": 6.1, "shape": {}, "dtype": "bfloat16"},
            {"kernel": "flash_attention", "entry": "command_r_prefill",
             "kernel_route": "tma_wgmma", "max_abs_err": 8e-3, "ms": 11.1,
             "plain_ms": 490.0, "bound_ms": 4.4, "bound_by": "operations",
             "library_ms": 6.8, "shape": {}, "dtype": "bfloat16"},
            {"kernel": "flash_attention_d192", "entry": "prefill",
             "kernel_route": "tma_wgmma", "max_abs_err": 8e-3, "ms": 23.5,
             "plain_ms": 900.0, "bound_ms": 10.0, "bound_by": "operations",
             "library_ms": 15.3, "shape": {}, "dtype": "bfloat16"},
            {"kernel": "flash_attention", "entry": "whisper_self",
             "kernel_route": "tma_wgmma",
             "device_ms": 0.04, "host_us": 30.0, "library_device_ms": 0.03,
             "max_abs_err": 2e-3, "ms": 0.05, "plain_ms": 4.0,
             "bound_ms": 0.01, "bound_by": "operations", "library_ms": 0.04,
             "shape": {}, "dtype": "bfloat16"},
            {"kernel": "flash_attention", "entry": "whisper_self",
             "kernel_route": "fma",
             "max_abs_err": 1e-6, "ms": 0.9, "plain_ms": 4.0,
             "bound_ms": 0.2, "bound_by": "operations", "library_ms": 0.1,
             "shape": {}, "dtype": "float32"},
            {"kernel": "flash_attention_cross", "entry": "whisper_prefill",
             "kernel_route": "tma_wgmma",
             "device_ms": 0.09, "host_us": 30.0, "library_device_ms": 0.08,
             "max_abs_err": 4e-3, "ms": 0.1, "plain_ms": 5.0,
             "bound_ms": 0.03, "bound_by": "operations", "library_ms": 0.08,
             "shape": {}, "dtype": "bfloat16"},
            {"kernel": "flash_attention_cross", "entry": "whisper_prefill",
             "kernel_route": "fma",
             "max_abs_err": 1e-6, "ms": 2.0, "plain_ms": 5.0,
             "bound_ms": 0.5, "bound_by": "operations", "library_ms": 0.2,
             "shape": {}, "dtype": "float32"},
            {"kernel": "flash_attention_cross", "entry": "whisper_decode",
             "kernel_route": "split_keys",
             "device_ms": 0.009, "host_us": 35.0, "library_device_ms": 0.02,
             "max_abs_err": 1e-3, "ms": 0.01, "plain_ms": 0.5,
             "bound_ms": 0.0055, "bound_by": "bytes", "library_ms": 0.08,
             "shape": {}, "dtype": "bfloat16"},
            {"kernel": "flash_attention_cross", "entry": "whisper_decode",
             "kernel_route": "fma",
             "max_abs_err": 1e-6, "ms": 0.05, "plain_ms": 0.5,
             "bound_ms": 0.0055, "bound_by": "bytes", "library_ms": 0.08,
             "shape": {}, "dtype": "float32"}]
    train_rows = [
        {"kernel": "flash_attention_bwd", "entry": "layer",
         "max_abs_err": 0.03, "ms": 1.9, "plain_ms": 40.0, "bound_ms": 0.17,
         "bound_by": "operations", "library_ms": 1.2, "shape": {"D": 128},
         "dtype": "bfloat16", "tol": "2^-7"},
        {"kernel": "flash_attention_bwd", "entry": "zamba2_layer",
         "max_abs_err": 0.02, "ms": 1.5, "plain_ms": 160.0, "bound_ms": 0.43,
         "bound_by": "operations", "library_ms": 1.3, "shape": {"D": 80},
         "dtype": "bfloat16", "tol": "2^-7", "launches_per_step": 9},
        {"kernel": "flash_attention_bwd", "entry": "d80_gqa_w",
         "max_abs_err": 0.04, "ms": 0.1, "plain_ms": 5.0, "bound_ms": 0.01,
         "bound_by": "operations", "library_ms": 0.2, "shape": {"D": 80},
         "dtype": "bfloat16", "tol": "2^-7"},
        {"kernel": "flash_attention_bwd", "entry": "phi3_layer",
         "max_abs_err": 0.01, "ms": 1.7, "plain_ms": 170.0, "bound_ms": 0.52,
         "bound_by": "operations", "library_ms": 1.4, "shape": {"D": 96},
         "dtype": "bfloat16", "tol": "2^-7", "launches_per_step": 32},
        {"kernel": "dual_proximal_sgd", "entry": "bf16_embed",
         "max_abs_err": 4e-3, "ms": 0.7, "plain_ms": 5.0, "bound_ms": 0.46,
         "bound_by": "bytes", "library_ms": None, "shape": {"N": 1},
         "dtype": "bfloat16"}]
    train_counts = {"flash_attention": 300, "flash_attention_bwd": 150,
                    "dual_proximal_sgd": 176}
    zoo_counts = {80: {"flash_attention_d80": 130, "flash_attention_bwd": 65},
                  96: {"flash_attention_d96": 332, "flash_attention_bwd": 166}}
    scan = [{"entry": "layer", "r_dtype": "bfloat16", "max_abs_err": 4e-7,
             "ms": 8.7, "plain_ms": 3000.0, "bound_ms": 0.58,
             "bound_by": "operations", "shape": {}, "latency_floor_ms": 4.3}]
    counts = {"agg_blend": 40, "cloud_blend": 10, "agg_absorb": 0,
              "weighted_agg_matmul": 0, "scatter_accumulate": 0,
              "agg_blend_tiled": 0, "agg_absorb_tiled": 0,
              "dual_proximal_sgd": 120}
    async_counts = dict(counts, agg_blend=0, cloud_blend=30, agg_absorb=120,
                        dual_proximal_sgd=360)
    sweep_counts = dict(counts, agg_blend=25, cloud_blend=5,
                        dual_proximal_sgd=1350)
    sweep_rows = [dict(agg_row(k, e, library_ms=lib), shape="sweep", S=16,
                       A=100, R=10)
                  for k, e, lib in (
                      ("fused_agg_blend", "agg_blend_sweep", 0.09),
                      ("fused_agg_blend", "cloud_blend_sweep", 0.01),
                      ("weighted_agg_matmul", "weighted_agg_matmul_sweep",
                       0.1), ("dual_proximal_sgd", "sweep", None))]
    monkeypatch.setattr(cs.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cs.torch.cuda, "get_device_name", lambda i=0: card)
    monkeypatch.setattr(cs.torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(cs, "device_and_build", lambda: ("cuda", card))
    monkeypatch.setattr(cs, "aggregation_cases", lambda dev: rows)
    monkeypatch.setattr(cs, "attention_cases", lambda dev: attn)
    monkeypatch.setattr(cs, "slstm_cases", lambda dev: scan)
    monkeypatch.setattr(cs, "main_path", lambda dev: {
        "main": counts, "unfused": dict(counts, weighted_agg_matmul=5)})
    monkeypatch.setattr(cs, "async_path", lambda dev: {
        "main": async_counts, "unfused": dict(
            async_counts, weighted_agg_matmul=2, scatter_accumulate=16)})
    monkeypatch.setattr(cs, "sweep_path", lambda dev: (sweep_rows, {
        "sweep": sweep_counts,
        "unfused": dict(counts, weighted_agg_matmul=6)}))
    stream_rows = [dict(agg_row("weighted_agg_matmul", "chunk_agg",
                                library_ms=0.9), shape="chunk", A=16_384,
                        R=16, dtype=dt) for dt in ("float32", "bfloat16")]
    monkeypatch.setattr(cs, "stream_path", lambda dev: (stream_rows, {
        "flat": dict(counts, agg_blend=0, cloud_blend=2, chunk_agg=24,
                     dual_proximal_sgd=72),
        "async": dict(counts, agg_blend=0, cloud_blend=2, chunk_agg=48,
                      dual_proximal_sgd=72),
        "resident_flat": dict(counts, agg_blend=0, cloud_blend=1,
                              chunk_agg=0, agg_blend_tiled=4,
                              dual_proximal_sgd=8),
        "resident_async": dict(counts, agg_blend=0, cloud_blend=1,
                               chunk_agg=0, agg_absorb_tiled=8,
                               dual_proximal_sgd=8)}))
    serve_counts = dict(counts, agg_blend=0, cloud_blend=3, agg_absorb=6,
                        dual_proximal_sgd=36)
    monkeypatch.setattr(cs, "serve_path", lambda dev: {
        "main": serve_counts, "unfused": dict(
            serve_counts, cloud_blend=0, agg_absorb=0,
            weighted_agg_matmul=4, scatter_accumulate=9)})
    shard_rows = [dict(agg_row("weighted_agg_matmul", "block_local_agg",
                               library_ms=0.01), shape=shape, A=a, R=r)
                  for shape, a, r in (("paper_pod", 50, 5),
                                      ("nshard", 8, 128))]
    monkeypatch.setattr(cs, "sharded_path", lambda dev: (shard_rows, dict(
        counts, agg_blend=0, cloud_blend=0, block_local_agg=64,
        dual_proximal_sgd=512)))
    monkeypatch.setattr(cs, "serving_path", lambda dev: 28)
    monkeypatch.setattr(cs, "xlstm_serving", lambda dev: 3)
    monkeypatch.setattr(cs, "moe_serving", lambda dev: 27)
    monkeypatch.setattr(cs, "hybrid_serving", lambda dev: 9)
    monkeypatch.setattr(cs, "audio_serving", lambda dev: (
        {"flash_attention": 4, "flash_attention_cross": 4},
        {"flash_attention": 0, "flash_attention_cross": 4}))
    monkeypatch.setattr(cs, "vision_serving", lambda dev: {
        "flash_attention_d96": 32})
    monkeypatch.setattr(cs, "dense_serving", lambda dev: {
        "yi-34b": {"flash_attention": 60},
        "command-r-35b": {"flash_attention": 40},
        "nemotron-4-340b": {"flash_attention_d192": 2}})
    dry_row = {"kernel": "flash_attention_cross",
               "entry": "whisper_decode_32k", "kernel_route": "split_keys",
               "device_ms": 0.05, "host_us": 40.0, "library_device_ms": 0.04,
               "max_abs_err": 2e-3, "ms": 0.06, "plain_ms": 3.0,
               "bound_ms": 0.03, "bound_by": "bytes", "library_ms": 0.2,
               "shape": {"B": 128}, "dtype": "bfloat16"}
    monkeypatch.setattr(cs, "dryrun_path", lambda dev: (
        {"flash_attention_cross": 4}, dry_row))
    monkeypatch.setattr(cs, "dryrun_matrix", lambda dev: pytest.fail(
        "the full run does not run the whole dry-run matrix"))
    monkeypatch.setattr(cs, "train_path",
                        lambda dev: (train_rows, train_counts, zoo_counts))
    monkeypatch.setattr(cs, "flat_round", lambda dev: pytest.fail(
        "the full run profiles its round inside the main path"))
    assert cs.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    # each phase's wall time on a line of its own, before the result
    assert sum(line.startswith("time: ") for line in lines[:-3]) == 18
    assert lines[-2] == card
    assert json.loads(lines[-1])["device"] == {"platform": "gpu",
                                               "kind": card, "count": 1}
    kernels = json.loads(lines[-3])["kernels"]
    assert [k["name"] for k in kernels] == [
        "fused_agg_blend", "weighted_agg_matmul", "dual_proximal_sgd",
        "fused_agg_blend", "weighted_agg_matmul", "dual_proximal_sgd",
        "weighted_agg_matmul", "weighted_agg_matmul", "flash_attention",
        "flash_attention_mla", "flash_attention_d80", "flash_attention_d96",
        "flash_attention", "flash_attention", "flash_attention_d192",
        "flash_attention", "flash_attention_cross", "flash_attention_cross",
        "flash_attention_cross", "slstm_scan",
        "flash_attention",
        "flash_attention_bwd", "dual_proximal_sgd", "flash_attention_d80",
        "flash_attention_bwd", "flash_attention_d96", "flash_attention_bwd"]
    for k in kernels:
        assert KERNEL_KEYS <= set(k), k["name"]
    # the flat path's, the async path's, the sweep's, the serve loop's,
    # the streamed rounds' and the sharded rounds' counted runs: #1 its
    # agg_blend, cloud_blend and agg_absorb launches, #2 its matmul,
    # scatter-accumulate, chunk_agg and block_local_agg launches; then the
    # scenario-axis rows, with the sweep's launches, #2 at the streamed
    # chunk shape, with the streamed rounds' launches, and #2 at the
    # sharded pod shape, with the sharded rounds' launches
    assert [k["launches"] for k in kernels] == [
        50 + 150 + 30 + 9 + 6, 5 + 18 + 6 + 13 + 84 + 64,
        120 + 360 + 1350 + 36 + 160 + 512, 30, 6, 1350, 84, 64, 28,
        27, 9, 32, 60, 40, 2, 4, 4, 4, 4, 3, 300, 150, 176, 130, 65, 332,
        166]
    # the training path's rows: #4 forward and backward at the layer
    # shape, #3's bf16 mode at the embedding leaf; then zamba2's and
    # phi-3-vision's: #4's forward at 80 / 96 at its layer row, the
    # backward at the train step's layer row with its launches a step, and
    # the error the most of that width's backward rows
    assert [k["entry"] for k in kernels[-7:]] == [
        "train", "train", "bf16_embed", "train", "train_d80", "train",
        "train_d96"]
    assert kernels[-6]["source"].endswith("flash_attention_bwd.cu")
    assert kernels[-3]["source"] == kernels[-1]["source"] == kernels[-6][
        "source"]
    assert kernels[-4]["ms"] == 0.29 and kernels[-4]["shape"] == {"D": 80}
    assert kernels[-3]["ms"] == 1.5 and kernels[-3]["launches_per_step"] == 9
    assert kernels[-3]["max_abs_err"] == 0.04
    assert kernels[-1]["ms"] == 1.7 and kernels[-1]["launches_per_step"] == 32
    assert kernels[-1]["max_abs_err"] == 0.01
    assert kernels[-1]["products_per_pair"] == 5
    kernels = kernels[:-4]
    # #4 at MLA's head dims, with phase 4c's prefill launches
    assert kernels[9]["source"].endswith("flash_attention.cu")
    assert kernels[9]["replaces"] == kernels[8]["replaces"]
    assert kernels[9]["library_padded_v"] is True
    # #4 at zamba2's head dim 80, with phase 4d's prefill launches
    assert kernels[10]["source"] == kernels[8]["source"]
    assert kernels[10]["replaces"] == kernels[8]["replaces"]
    assert kernels[10]["entry"] == "prefill"
    # #4 at phi-3-vision's head dim 96, with phase 4f's prefill launches;
    # whisper's self-attention (D = 64) and its cross-attention (keys of
    # their own length) at its prefill shape, each a row of its own with
    # the bf16 row's numbers and phase 4e's launches of that kind, then
    # the cross-attention at a decode step's shape (the split-key kernel)
    # with the step's launches; each cross row's error is its kernel's
    assert kernels[11]["source"] == kernels[8]["source"]
    assert kernels[11]["replaces"] == kernels[8]["replaces"]
    # #4 at yi-34b's and command-r-35b's prefill shapes (D = 128) and at
    # (192, 192) at nemotron-4-340b's, with phase 4g's prefill launches
    assert [k["entry"] for k in kernels[12:15]] == [
        "yi_prefill", "command_r_prefill", "prefill"]
    assert kernels[14]["source"] == kernels[8]["source"]
    assert kernels[14]["replaces"] == kernels[8]["replaces"]
    assert kernels[14]["ms"] == 23.5 and kernels[14]["library_ms"] == 15.3
    kernels = kernels[:12] + kernels[15:]
    assert kernels[12]["entry"] == "whisper_self"
    assert kernels[12]["ms"] == 0.05 and kernels[12]["dtype"] == "bfloat16"
    assert kernels[12]["max_abs_err"] == 2e-3
    assert kernels[12]["kernel_route"] == "tma_wgmma"
    assert kernels[13]["entry"] == "whisper_prefill"
    assert kernels[13]["ms"] == 0.1 and kernels[13]["dtype"] == "bfloat16"
    assert kernels[13]["max_abs_err"] == 4e-3
    assert kernels[13]["kernel_route"] == "tma_wgmma"
    assert "self_attention_launches" not in kernels[13]
    assert kernels[14]["entry"] == "whisper_decode"
    assert kernels[14]["ms"] == 0.01 and kernels[14]["max_abs_err"] == 1e-3
    assert kernels[14]["kernel_route"] == "split_keys"
    assert kernels[14]["bound_by"] == "bytes"
    assert kernels[14]["device_ms"] == 0.009
    assert kernels[14]["host_us"] == 35.0
    assert kernels[14]["library_device_ms"] == 0.02
    # the same kernel at whisper decode_32k's step, with phase 4h's
    # counted step's launches
    assert kernels[15]["entry"] == "whisper_decode_32k"
    assert kernels[15]["kernel_route"] == "split_keys"
    assert kernels[15]["shape"] == {"B": 128}
    assert kernels[15]["ms"] == 0.06 and kernels[15]["device_ms"] == 0.05
    assert kernels[-2]["products_per_pair"] == 5
    assert kernels[0]["launches_by_path"] == {"flat": 50, "async": 150,
                                              "sweep": 30, "serve": 9,
                                              "stream": 6, "sharded": 0}
    assert kernels[1]["launches_by_path"] == {"flat": 5, "async": 18,
                                              "sweep": 6, "serve": 13,
                                              "stream": 84, "sharded": 64}
    assert kernels[2]["launches_by_path"]["serve"] == 36
    assert kernels[2]["launches_by_path"]["sharded"] == 512
    assert kernels[7]["entry"] == "block_local_agg"
    assert kernels[7]["shape"] == {"A": 50, "R": 5, "N": 31_810}
    assert kernels[7]["launches_by_path"] == {"sharded": 64}
    assert kernels[6]["entry"] == "chunk_agg"
    assert kernels[6]["shape"] == {"A": 16_384, "R": 16, "N": 31_810}
    assert kernels[6]["library_ms"] == 0.9
    assert [k["entry"] for k in kernels[3:6]] == [
        "agg_blend_sweep", "weighted_agg_matmul_sweep", "sweep"]
    assert kernels[3]["shape"] == {"S": 16, "A": 100, "R": 10, "N": 31_810}
    assert kernels[3]["library_ms"] == 0.09
    assert kernels[0]["entry"] == "agg_blend"
    assert kernels[2]["host_us"] == 12.0


def test_reduced_card_vs_host_callers_pass_counts_by_key():
    """Every phase hands ``reduced_card_vs_host`` the launches its reduced
    prefill must make as a {launch key: launches} dict (the card is
    needed to run the phases themselves)."""
    import ast
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "reduced_card_vs_host"]
    assert len(calls) == 9
    for call in calls:
        counted = call.args[4]
        assert isinstance(counted, ast.Dict), ast.unparse(call)
        assert all(isinstance(k, ast.Constant)
                   and k.value.startswith(("flash_attention", "slstm_scan"))
                   for k in counted.keys), ast.unparse(call)


def _cell(arch="qwen3-0.6b", shape="long_500k", peak=10, draw_peak=None,
          launches=None, routes=None):
    return {"arch": arch, "shape": shape,
            "reckoned": {"params": 4, "draw": 3, "runtime": 1, "total": 12},
            "measured": {"peak_bytes": peak, "draw_peak_bytes": draw_peak},
            "launches": launches or {}, "routes": routes or {}}


@pytest.mark.parametrize("peak,draw_peak,ok", [
    (12, None, True), (13, None, False), (10, 8, True), (10, 9, False)])
def test_held_to_reckoning_holds_the_step_and_the_draw(peak, draw_peak, ok):
    """A run cell's peak may reach its reckoned total and no further; the
    draw's peak, where the cell drew its params, the reckoning's draw term
    (params + draw + runtime: 8 here)."""
    cs = _chip_smoke()
    rec = _cell(peak=peak, draw_peak=draw_peak)
    if ok:
        cs._held_to_reckoning(rec)
    else:
        with pytest.raises(AssertionError):
            cs._held_to_reckoning(rec)


def test_held_to_launches_is_each_run_cell_s_own():
    """Each run cell's launches and #4's routes a call are held to
    ``DRYRUN_RUNS``: qwen3's prefill 28 tma_wgmma launches, its long_500k
    decode none."""
    cs = _chip_smoke()
    want = cs.DRYRUN_RUNS[("qwen3-0.6b", "prefill_32k")]
    assert want == ({"flash_attention": 28},
                    {"flash_attention:tma_wgmma": 28})
    cs._held_to_launches(_cell(shape="prefill_32k", launches=want[0],
                               routes=want[1]))
    cs._held_to_launches(_cell())
    with pytest.raises(AssertionError):
        cs._held_to_launches(_cell(launches={"flash_attention": 28}))
    with pytest.raises(AssertionError):
        cs._held_to_launches(_cell(shape="prefill_32k", launches=want[0],
                                   routes={"flash_attention:fma": 28}))
    assert cs.DRYRUN_RUNS[("whisper-tiny", "decode_32k")][0] == \
        cs.WHISPER_STEP


def test_cell_kernel_rows_check_each_distinct_call_once(monkeypatch):
    """``--dryrun`` holds each distinct kernel call of the run cells to
    its plain version once, at the call's own shapes and dtypes."""
    cs = _chip_smoke()
    seen = []
    monkeypatch.setattr(cs, "attention_call_row",
                        lambda dev, tag, *a: seen.append(("attn", tag, a)))
    monkeypatch.setattr(cs, "slstm_call_row",
                        lambda dev, tag, *a: seen.append(("scan", tag, a)))
    attn = ["flash_attention", [32, 32768, 16, 128], [32, 32768, 8, 128],
            [32, 32768, 8, 128], True, 0, "bfloat16"]
    scan = ["slstm_scan", [32, 32768, 3072], [4, 192, 768], "bfloat16"]
    recs = [dict(_cell(shape="prefill_32k"), calls=[attn]),
            dict(_cell(arch="xlstm-125m", shape="prefill_32k"),
                 calls=[scan]),
            dict(_cell(arch="xlstm-125m"), calls=[scan, attn]),
            dict(_cell(), calls=[])]
    assert len(cs.cell_kernel_rows("cuda", recs)) == 2
    assert seen == [("attn", "qwen3-0.6b_prefill_32k", tuple(attn[1:])),
                    ("scan", "xlstm-125m_prefill_32k", tuple(scan[1:]))]


@pytest.mark.parametrize("causal,T,max_heads", [(True, 40, 2),
                                                (False, 23, 1),
                                                (True, 40, 32)])
def test_plain_in_chunks_is_the_plain_version(causal, T, max_heads):
    """The plain version a batch row and a few heads at a time is the
    plain version over the whole batch, causal or across keys of their own
    length; ``compare_rows`` gives the largest row's error and raises on a
    row that disagrees."""
    import torch
    from repro_torch.kernels import ref
    cs = _chip_smoke()
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(3, 40, 4, 16, generator=gen)
    k, v = (torch.randn(3, T, 2, 16, generator=gen) for _ in range(2))
    got = cs.plain_in_chunks(q, k, v, max_heads=max_heads, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert cs.compare_rows(got, want, torch.float32, "rows") <= 1e-6
    bad = want.clone()
    bad[2, 5, 1, 3] += 1.0
    with pytest.raises(AssertionError, match="row 2"):
        cs.compare_rows(got, bad, torch.float32, "rows")
