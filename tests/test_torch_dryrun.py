"""The reference's four shapes and its dry run (``launch/steps``'s
``SHAPES`` .. ``input_specs``, ``h2fed_round.round_input_specs``,
``launch/dryrun``) on the CPU against the JAX package.

- ``SHAPES``, ``LONG_CONTEXT_WINDOW``, ``SKIPS`` and
  ``shape_adapted_config`` are the reference's, value for value and field
  for field at all ten architectures x four shapes.
- ``input_specs`` gives the reference's tree of shapes and dtypes (its
  ``ShapeDtypeStruct``s on a one-device ``make_test_mesh((1, 1, 1))``,
  ``eval_shape`` only) for every cell of the ten full configs, and its
  ``desc``; ``round_input_specs`` the same for ``train_4k``.  Their
  ``in_shardings`` are the reference's spec for spec on that mesh and on
  both production meshes (``AbstractMesh`` (16, 16) and (2, 16, 16),
  against the port's ``make_production_mesh``), and ``sharding.
  arg_bytes`` is the sum of the reference's ``shard_shape`` bytes.
- The two cells of the reference's ``TestDryRunMini``
  (``tests/test_launch.py:239-291``): the reduced deepseek's train cell
  (S=32, B=8) and the reduced zamba2's decode cell (S=64, B=4), in fp32,
  materialized once (the JAX params carried over by ``convert``, the rest
  drawn by ``steps.materialize`` and carried back), each step run in both
  packages and held at fp32 1e-4; ``launch/dryrun`` on such a cell with
  ``--device cpu`` writes its record.
- The reckoning: which of the 40 cells fit one card, the meta-device
  tracker, the decode cache fill, the kernels' meta route and work log.
"""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.launch import h2fed_round as jround
from repro.launch import steps as jsteps
from jax.sharding import AbstractMesh
from repro.launch.mesh import make_test_mesh
from repro.models import model as JM

from repro_torch import convert, tree
from repro_torch.configs import registry as tregistry
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch import h2fed_round as tround
from repro_torch.launch import serve as tserve
from repro_torch.launch import sharding as tshard
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as TM

F32 = dict(rtol=1e-4, atol=1e-4)
F32_CFG = dict(dtype="float32", param_dtype="float32")
ARCHS = tregistry.ARCH_IDS


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread: torch's and JAX's pools would otherwise
    fight over the cores when test files run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    return make_test_mesh((1, 1, 1))


def _paths(t, prefix=""):
    """The port tree's leaf paths in leaf order, as ``jax.tree_util.
    keystr`` writes them (dict keys, list and tuple indices, named-tuple
    fields); None holds no leaf."""
    if t is None:
        return []
    if isinstance(t, dict):
        return [q for k in sorted(t) for q in _paths(t[k],
                                                      f"{prefix}['{k}']")]
    if hasattr(t, "_fields"):
        return [q for f in t._fields for q in _paths(getattr(t, f),
                                                     f"{prefix}.{f}")]
    if isinstance(t, (list, tuple)):
        return [q for i, x in enumerate(t) for q in _paths(x,
                                                           f"{prefix}[{i}]")]
    return [prefix]


def _same_tree(jtree, ttree):
    """The same leaf paths in the same order, and leaf for leaf the same
    shapes and dtypes; the port's leaves on the meta device."""
    jleaves = jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jleaves] == _paths(ttree)
    for (path, j), t in zip(jleaves, tree.leaves(ttree)):
        where = jax.tree_util.keystr(path)
        assert tuple(j.shape) == tuple(t.shape), where
        assert str(j.dtype) == str(t.dtype).removeprefix("torch."), where
        assert t.device.type == "meta", where


# the reference's production meshes, as shapes (no device needed)
PROD = {False: AbstractMesh((16, 16), ("data", "model")),
        True: AbstractMesh((2, 16, 16), ("pod", "data", "model"))}


def _same_shardings(want, got):
    """The reference's ``in_shardings`` (a tree of ``NamedSharding``,
    None where an argument is None) and the port's, spec for spec in leaf
    order; returns the sum of the reference's ``shard_shape`` bytes over
    ``want["args"]``."""
    jsh = jax.tree.leaves(want["in_shardings"])
    tsh = tree.leaves(got["in_shardings"])
    assert [tuple(j.spec) for j in jsh] == [t.spec for t in tsh]
    return sum(int(np.prod(j.shard_shape(a.shape))) * a.dtype.itemsize
               for a, j in zip(jax.tree.leaves(want["args"]), jsh))


def _prod_specs(jc, tc, shape, multi_pod):
    """Both packages' cell on a production mesh: the same in_shardings,
    and the port's argument bytes a rank equal to the reference's."""
    mesh, tmesh = PROD[multi_pod], make_production_mesh(multi_pod=multi_pod)
    if shape == "round":
        want = jround.round_input_specs(jc, "train_4k", mesh)
        got = tround.round_input_specs(tc, "train_4k", tmesh, device="cpu")
        assert got["fn"] is None
    else:
        want = jsteps.input_specs(jc, shape, mesh)
        got = tsteps.input_specs(tc, shape, tmesh, device="cpu")
    assert got["desc"] == want["desc"]
    nbytes = _same_shardings(want, got)
    assert tshard.arg_bytes(got["args"], got["in_shardings"]) == nbytes
    return nbytes


def test_shapes_window_and_skips_are_the_reference_s():
    assert tsteps.SHAPES == jsteps.SHAPES
    assert tsteps.LONG_CONTEXT_WINDOW == jsteps.LONG_CONTEXT_WINDOW
    assert tsteps.SKIPS == jsteps.SKIPS


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_the_reference(arch, mesh):
    """For each shape: ``shape_adapted_config`` field for field, and
    ``input_specs``'s args tree, desc, config and in_shardings; for
    ``train_4k`` also ``round_input_specs``'s.  The in_shardings also on
    both production meshes, with the argument bytes a rank."""
    jc, tc = jregistry.get_config(arch), tregistry.get_config(arch)
    for shape in tsteps.SHAPES:
        ja = jsteps.shape_adapted_config(jc, shape)
        ta = tsteps.shape_adapted_config(tc, shape)
        assert dataclasses.asdict(ta) == dataclasses.asdict(ja), shape
        want = jsteps.input_specs(jc, shape, mesh)
        got = tsteps.input_specs(tc, shape, device="cpu")
        assert got["desc"] == want["desc"]
        assert dataclasses.asdict(got["cfg"]) == dataclasses.asdict(
            want["cfg"])
        _same_tree(want["args"], got["args"])
        _same_shardings(want, got)
        for multi_pod in PROD:
            _prod_specs(jc, tc, shape, multi_pod)
    want = jround.round_input_specs(jc, "train_4k", mesh)
    got = tround.round_input_specs(tc, "train_4k", device="cpu")
    assert got["desc"] == want["desc"]
    _same_tree(want["args"], got["args"])
    _same_shardings(want, got)
    for multi_pod in PROD:
        _prod_specs(jc, tc, "round", multi_pod)


def test_round_and_decode_argument_bytes():
    """qwen3-0.6b's arguments a chip on the 16x16 mesh are the reference's
    0.077 GB (the round) and 1.886 GB (decode_32k), and the dry run
    records the round's."""
    jc, tc = (r.get_config("qwen3-0.6b") for r in (jregistry, tregistry))
    assert round(_prod_specs(jc, tc, "round", False) / 1e9, 3) == 0.077
    assert round(_prod_specs(jc, tc, "decode_32k", False) / 1e9, 3) == 1.886
    assert dryrun.per_rank_argument_bytes(
        "qwen3-0.6b", "train_4k", "h2fed_round") == _prod_specs(
            jc, tc, "round", False)


def _to_jax(like, ours):
    """The port's tensors, leaf for leaf, as arrays of ``like``'s tree
    (copies: the port writes a decode cache in place)."""
    leaves, treedef = jax.tree_util.tree_flatten(like)
    mine = tree.leaves(ours)
    assert len(leaves) == len(mine)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.array(convert.tensor_to_numpy(t).copy()).astype(j.dtype)
        for t, j in zip(mine, leaves)])


@pytest.fixture
def mini_shapes(monkeypatch):
    """The reference test's miniature shapes, in both packages."""
    for shapes in (jsteps.SHAPES, tsteps.SHAPES):
        monkeypatch.setitem(shapes, "mini", dict(kind="train", seq=32,
                                                 batch=8))
        monkeypatch.setitem(shapes, "mini_dec", dict(kind="decode", seq=64,
                                                     batch=4))


def _mini(arch, shape, mesh):
    jc = jregistry.get_reduced_config(arch).replace(**F32_CFG)
    tc = tregistry.get_reduced_config(arch).replace(**F32_CFG)
    jspec = jsteps.input_specs(jc, shape, mesh)
    tspec = tsteps.input_specs(tc, shape, device="cpu")
    _same_tree(jspec["args"], tspec["args"])
    jp = jax.jit(lambda k: JM.init_params(jspec["cfg"], k))(
        jax.random.key(1))
    tp = convert.tree_from_jax(jax.tree.map(np.asarray, jp))
    targs = tsteps.materialize(tspec, torch.Generator().manual_seed(0),
                               "cpu", params=tp)
    return jspec, tspec, jp, targs


def test_mini_train_cell_matches_jax(mini_shapes, mesh):
    """The reduced deepseek (MLA + MoE) train cell: the new params and
    momentum, the loss and the aux loss."""
    jspec, tspec, jp, (state, batch, mask) = _mini(
        "deepseek-v2-lite-16b", "mini", mesh)
    assert tspec["desc"] == jspec["desc"] == "train A=1 b=8 S=32"
    jstate = jsteps.TrainState(
        params=jp, momentum=_to_jax(jspec["args"][0].momentum,
                                    state.momentum),
        anchor_rsu=jp, anchor_cloud=jp)
    jbatch = _to_jax(jspec["args"][1], batch)
    jnew, jout = jax.jit(jspec["fn"])(jstate, jbatch,
                                      jnp.asarray(mask.numpy()))
    tnew, tout = tspec["fn"](state, batch, mask)
    for k in ("loss", "aux"):
        np.testing.assert_allclose(float(tout[k]), float(jout[k]), **F32)
    for field in ("params", "momentum"):
        for j, t in zip(jax.tree_util.tree_leaves(getattr(jnew, field)),
                        tree.leaves(getattr(tnew, field))):
            np.testing.assert_allclose(convert.tensor_to_numpy(t),
                                       np.asarray(j), **F32)


def test_mini_decode_cell_matches_jax(mini_shapes, mesh):
    """The reduced zamba2 decode cell over a cache filled for its last
    position (63 of 64): the logits and every cache leaf after the
    step."""
    jspec, tspec, jp, (params, cache, tokens, cur_pos, memory) = _mini(
        "zamba2-2.7b", "mini_dec", mesh)
    assert tspec["desc"] == jspec["desc"] == "decode B=4 T=64"
    assert memory is None and int(cur_pos[0]) == 63
    jcache = _to_jax(jspec["args"][1], cache)
    jl, jcache = jax.jit(jspec["fn"])(jp, jcache,
                                      jnp.asarray(tokens.numpy()),
                                      jnp.asarray(cur_pos.numpy()))
    tl, cache = tspec["fn"](params, cache, tokens, cur_pos)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32)
    for j, t in zip(jax.tree_util.tree_leaves(jcache), tree.leaves(cache)):
        np.testing.assert_allclose(convert.tensor_to_numpy(t), np.asarray(j),
                                   **F32)


def test_dryrun_writes_a_mini_cell_record(mini_shapes, tmp_path, capsys):
    """``launch/dryrun`` on the CPU: the reduced zamba2's decode cell is
    reckoned, run and recorded; a ``SKIPS`` cell is recorded skipped."""
    dryrun.main(["--arch", "zamba2-2.7b", "--shape", "mini_dec",
                 "--reduced", "--device", "cpu", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "zamba2-2.7b__mini_dec.json").read_text())
    assert rec["fits"] and rec["reduced"] and rec["desc"] == \
        "decode B=4 T=64"
    assert (rec["mesh"], rec["n_chips"]) == ("16x16", 256)
    assert rec["per_rank_argument_bytes"] > 0
    assert rec["measured"]["peak_bytes"] is None
    assert rec["measured"]["reps"] >= 3 and rec["measured"]["ms_median"] > 0
    assert rec["launches"] == {}
    assert rec["roofline"]["dominant"] in ("compute_s", "memory_s")
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes_bound"] > 0
    assert set(rec["reckoned"]) == {"params", "inputs", "cache", "state",
                                    "transient", "draw", "runtime", "total"}
    dryrun.main(["--arch", "whisper-tiny", "--shape", "long_500k",
                 "--device", "cpu", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "whisper-tiny__long_500k.json").read_text())
    assert rec["skipped"] == tsteps.SKIPS[("whisper-tiny", "long_500k")]
    out = capsys.readouterr().out
    assert "[ok] zamba2-2.7b__mini_dec: fits=True" in out
    assert "[SKIP] whisper-tiny__long_500k" in out


def test_round_specs_and_multi_pod_refused(mini_shapes, tmp_path, capsys):
    """The round takes training shapes only.  ``--multi-pod`` is no longer
    refused: it records the reference's 2x16x16 mesh (512 chips) under
    files of their own (``__mp``), the one-card run as without it, and
    the argument bytes a chip of that mesh equal to the reference's
    ``shard_shape`` bytes of the same cell; a ``SKIPS`` cell names the
    mesh too."""
    cfg = tregistry.get_reduced_config("qwen3-0.6b")
    with pytest.raises(AssertionError, match="training shapes only"):
        tround.round_input_specs(cfg, "prefill_32k", device="cpu")
    dryrun.main(["--arch", "zamba2-2.7b", "--shape", "mini_dec",
                 "--reduced", "--multi-pod", "--device", "cpu", "--out",
                 str(tmp_path)])
    rec = json.loads((tmp_path / "zamba2-2.7b__mini_dec__mp.json")
                     .read_text())
    assert (rec["mesh"], rec["n_chips"]) == ("2x16x16", 512)
    assert rec["fits"] and rec["desc"] == "decode B=4 T=64"
    assert rec["per_rank_argument_bytes_is"].startswith("reckoned")
    jc = jregistry.get_reduced_config("zamba2-2.7b")
    want = jsteps.input_specs(jc, "mini_dec", PROD[True])
    got = tsteps.input_specs(tregistry.get_reduced_config("zamba2-2.7b"),
                             "mini_dec", make_production_mesh(
                                 multi_pod=True), device="cpu")
    assert rec["per_rank_argument_bytes"] == _same_shardings(want, got)
    dryrun.main(["--arch", "whisper-tiny", "--shape", "long_500k",
                 "--multi-pod", "--device", "cpu", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "whisper-tiny__long_500k__mp.json")
                     .read_text())
    assert rec["mesh"] == "2x16x16" and "skipped" in rec
    assert not (tmp_path / "whisper-tiny__long_500k.json").exists()
    assert "[ok] zamba2-2.7b__mini_dec__mp: fits=True" in \
        capsys.readouterr().out


# the cells that fit one 80 GB card by the reckoning: every long_500k cell
# but kimi-k2's and nemotron's (and whisper's documented skip), xlstm's
# and whisper's decode_32k, and the prefill_32k of the three small models
FITS = {(a, "long_500k") for a in ("qwen3-0.6b", "xlstm-125m", "zamba2-2.7b",
                                   "deepseek-v2-lite-16b",
                                   "phi-3-vision-4.2b", "yi-34b",
                                   "command-r-35b")} | {
    ("xlstm-125m", "decode_32k"), ("whisper-tiny", "decode_32k"),
    ("qwen3-0.6b", "prefill_32k"), ("xlstm-125m", "prefill_32k"),
    ("whisper-tiny", "prefill_32k")}


def test_reckoning_says_which_cells_fit_one_card(monkeypatch):
    """All 40 cells reckoned from shapes (no param drawn anywhere): the
    cells of ``FITS`` fit 80 GB, the rest do not; a decode step's
    transient holds one layer's K and V widened to fp32, a prefill's the
    fp32 silu of one MLP at B x S positions."""
    shapes_only = TM.init_params

    def no_draw(cfg, gen, *, device=None):
        assert torch.device(device).type == "meta", "a param was drawn"
        return shapes_only(cfg, gen, device=device)
    monkeypatch.setattr(TM, "init_params", no_draw)
    fits = set()
    for arch in ARCHS:
        for shape in tsteps.SHAPES:
            if (arch, shape) in tsteps.SKIPS:
                continue
            need = tsteps.peak_bytes(dryrun.cell_spec(arch, shape,
                                                      device="cpu"))
            if need["total"] <= tsteps.CARD_BYTES:
                fits.add((arch, shape))
    assert fits == FITS
    cfg = tregistry.get_config("qwen3-0.6b")
    need = tsteps.peak_bytes(tsteps.input_specs(cfg, "decode_32k",
                                                device="cpu"))
    assert need["transient"] >= 2 * need["cache"] // cfg.n_layers
    need = tsteps.peak_bytes(tsteps.input_specs(cfg, "prefill_32k",
                                                device="cpu"))
    assert need["transient"] >= 4 * 32 * 32768 * cfg.d_ff * 2
    # the serve launcher's reckoning is the dry run's decode reckoning
    got = tserve.peak_bytes(cfg, 8, 64)
    assert got == tsteps.peak_bytes(dict(
        cfg=cfg, kind="decode", batch=8, seq=64,
        args=tsteps.decode_args(cfg, 8, 64)))


def test_chip_smoke_runs_the_cells_that_fit():
    """``chip_smoke.py --dryrun`` holds the cells it runs on the card to
    ``FITS``."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert set(cs.DRYRUN_RUNS) == FITS
    assert set(cs.DRYRUN_CELLS) <= FITS


def test_live_bytes_follows_the_allocator():
    """The meta-device tracker: new storages counted as the allocator's
    blocks while they live, views and in-place writes of known tensors
    not at all."""
    known = torch.empty(1000, device="meta")

    def step(a):
        b = a * 2                        # 4,000 bytes: a 4,096-byte block
        a.add_(1)                        # in place: nothing new
        c = (b + 1).view(10, 100)        # another block beside b
        del b
        # 2 MiB: a large block, counted with the 1 MiB it may keep unsplit
        big = torch.empty(2 << 20, dtype=torch.uint8, device="meta")
        return c, big[:10]
    peak = tsteps.step_transient(step, (known,))
    assert peak == 4096 + (2 << 20) + (1 << 20)


def test_fill_cache_rings_for_the_last_position():
    """Slot j holds the latest position before ``cur`` that maps to it, -1
    where none does; the write index is ``cur``."""
    cfg = tregistry.get_reduced_config("qwen3-0.6b")
    gen = torch.Generator().manual_seed(0)
    ring = tsteps.fill_cache(TM.init_cache(cfg, 1, 4, device="cpu"), gen,
                             10)[0]["attn"]
    assert ring.pos[0, 0].tolist() == [8, 9, 6, 7]
    assert ring.idx[0].tolist() == [10]
    flat = tsteps.fill_cache(TM.init_cache(cfg, 1, 8, device="cpu"), gen,
                             5)[0]["attn"]
    assert flat.pos[0, 0].tolist() == [0, 1, 2, 3, 4, -1, -1, -1]
    assert torch.isfinite(flat.k).all() and flat.k.abs().sum() > 0


def test_kernel_meta_route_and_work_log():
    """On the meta device the kernels' wrappers return their outputs'
    shapes; ``logged_calls`` notes each call, and the dry run counts #4's
    live pairs as ``chip_smoke.py`` does."""
    q = torch.empty(2, 300, 8, 192, dtype=torch.bfloat16, device="meta")
    k = torch.empty(2, 300, 2, 192, dtype=torch.bfloat16, device="meta")
    v = torch.empty(2, 300, 2, 128, dtype=torch.bfloat16, device="meta")
    wx = torch.empty(3, 50, 4 * 64, device="meta")
    r = torch.empty(2, 32, 128, device="meta")
    with ops.logged_calls() as log:
        out = ops.flash_attention(q, k, v, causal=True, window=100)
        h = ops.slstm_scan(wx, r, torch.empty(256, device="meta"))
    assert out.shape == (2, 300, 8, 128) and out.is_meta
    assert h.shape == (3, 50, 64) and h.dtype == torch.float32
    assert [e[0] for e in log] == ["flash_attention", "slstm_scan"]
    for S, causal, window in ((300, True, 100), (300, False, 100),
                              (300, True, 0), (300, False, 0),
                              (50, True, 64)):
        brute = sum(len([t for t in range(S)
                         if (t <= s or not causal)
                         and (not window or t > s - window)])
                    for s in range(S))
        assert dryrun.live_pairs(S, S, causal, window) == brute
    flops = dryrun.kernel_flops(log)
    assert flops["flash_attention"] == 2 * 2 * 8 * (192 + 128) * \
        dryrun.live_pairs(300, 300, True, 100)
    assert flops["slstm_scan"] == 2 * 3 * 50 * 2 * 32 * 128
    assert dryrun.kernel_routes(log) == {
        "flash_attention_mla:tma_wgmma": 1}
    with ops.logged_calls() as twice:
        ops.slstm_scan(wx, r, torch.empty(256, device="meta"))
        ops.slstm_scan(wx, r, torch.empty(256, device="meta"))
    assert dryrun.kernel_calls(log + twice) == [
        ["flash_attention", [2, 300, 8, 192], [2, 300, 2, 192],
         [2, 300, 2, 128], True, 100, "bfloat16"],
        ["slstm_scan", [3, 50, 256], [2, 32, 128], "float32"]]


def test_reckon_cells_is_each_cell_s_reckoning():
    """``reckon_cells`` gives each cell's reckoning in the cells' order; a
    ``SKIPS`` cell has none."""
    cells = [("whisper-tiny", "long_500k"), ("qwen3-0.6b", "long_500k"),
             ("xlstm-125m", "decode_32k")]
    got = dryrun.reckon_cells(cells)
    assert got[0] == ("whisper-tiny", "long_500k", None, None)
    assert got[1][2] == "decode B=1 T=524288 win=8192"
    assert got[1][3] == tsteps.peak_bytes(dryrun.cell_spec(
        "qwen3-0.6b", "long_500k", device="cpu"))
    assert got[2][3] == tsteps.peak_bytes(dryrun.cell_spec(
        "xlstm-125m", "decode_32k", device="cpu"))


def test_meta_params_build_shapes_alone():
    """On the meta device the initialisers build each leaf's shape and
    dtype in about one operation a leaf, drawing nothing: the reckoning
    of 40 cells builds many such trees."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    cfg = tregistry.get_config("nemotron-4-340b")
    with Count():
        params = TM.meta_params(cfg)
    leaves = tree.leaves(params)
    assert all(t.is_meta for t in leaves)
    assert Count.n <= 3 * len(leaves)
    assert sum(t.numel() * t.element_size() for t in leaves) == \
        TM.param_bytes(cfg)
