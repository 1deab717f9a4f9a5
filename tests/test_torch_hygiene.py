"""The port stands alone: no file of ``src/repro_torch/`` or
``chip_smoke.py`` imports JAX or the JAX package, importing the port
leaves JAX unloaded, and the entry points refuse to run on the CPU unless
asked to."""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core.faults import FaultPlan

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch, repro_torch.fedsim, "
            "repro_torch.kernels.ops, repro_torch.convert; "
            "print(any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
            "for m in sys.modules))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "False"


def test_entry_points_default_to_cuda(monkeypatch):
    """Without ``device`` the entry points take cuda and raise when it is
    absent; nothing carries on quietly on the CPU."""
    from repro_torch.configs.mnist_mlp import CONFIG
    from repro_torch.core.scenario import ScenarioSpec
    from repro_torch.fedsim import (pretrain_to_target, run_scenario,
                                    run_serve_loop)
    from repro_torch.models import mlp
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = ScenarioSpec(n_agents=4, n_rsus=2, n_train=300, n_test=60,
                        rounds=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_scenario(spec)
    serve = spec.replace(engine="async", serve_events=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_scenario(serve)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_serve_loop(serve)
    params = mlp.init_params(CONFIG, torch.Generator().manual_seed(0))
    res = spec.resolve()
    with pytest.raises(RuntimeError, match="CUDA"):
        pretrain_to_target(params, res.pretrain_pool, res.test.x, res.test.y)


@pytest.mark.parametrize("fields,error", [
    (dict(engine="sharded", faults=FaultPlan()), ValueError),
    (dict(engine="tree"), NotImplementedError),
    (dict(fleet_store="host", engine="tree"), ValueError),
    (dict(chunk_agents=4, engine="sharded"), ValueError),
    (dict(chunk_params=128), ValueError),
    (dict(serve_events=10), ValueError),
    (dict(engine="async", rsu_sharded=True, faults=FaultPlan()), ValueError),
    (dict(model_shards=2), ValueError),
    (dict(faults=object()), TypeError),
    (dict(serve_events=10, engine="async", fleet_store="host"), ValueError),
    (dict(serve_events=10, engine="async", tick_trigger="nope"),
     ValueError)],
    ids=["engine-sharded", "engine-tree", "fleet_store-host", "chunk_agents-4",
         "chunk_params-128", "serve_events-10", "rsu_sharded-True",
         "model_shards-2", "faults-value8", "serve_events-host_store",
         "serve_events-bad_trigger"])
def test_unported_features_refuse(fields, error):
    """What is not ported (the tree engine) raises by name; a ``faults``
    value that is not a ``FaultPlan`` is refused.  The streaming, serving
    and sharded fields are ported: a host store or chunking on an engine
    that does not stream, a two-axis tile without the host store, serving
    on the flat engine, on a host store or with a bad tick trigger, a
    fault plan on the sharded engine or the rsu-sharded tick, and
    ``model_shards > 1`` off the sharded engine are refused as the
    reference refuses them."""
    from repro_torch.core.scenario import ScenarioSpec
    with pytest.raises(error):
        ScenarioSpec(**fields).validate()



def test_sharded_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch.core.topology, "
            "repro_torch.fedsim.sharded, repro_torch.launch.mesh, "
            "repro_torch.launch.collectives; "
            "print(any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
            "for m in sys.modules))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "False"


def test_sharded_entry_points_default_to_cuda(monkeypatch):
    """The sharded round and the rsu-sharded tick take cuda unless asked
    for the CPU, and raise when it is absent."""
    from repro_torch.core.scenario import ScenarioSpec
    from repro_torch.fedsim import run_scenario
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = ScenarioSpec(n_agents=4, n_rsus=2, n_train=300, n_test=60,
                        rounds=1, engine="sharded")
    for s in (spec, spec.replace(rsu_sharded=True),
              spec.replace(model_shards=2),
              spec.replace(engine="async", rsu_sharded=True)):
        with pytest.raises(RuntimeError, match="CUDA"):
            run_scenario(s)


def test_serve_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch.launch.serve, "
            "repro_torch.checkpoint.ckpt, repro_torch.core.load_gen, "
            "repro_torch.fedsim.serving; "
            "print(any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
            "for m in sys.modules))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "False"


def test_serving_entry_points_default_to_cuda(monkeypatch):
    """The serve launcher (decode and ``--serve-loop``), the step builders
    and ``init_params`` take cuda unless told otherwise, and raise when it
    is absent."""
    from repro_torch.configs.registry import get_reduced_config
    from repro_torch.launch import serve, steps
    from repro_torch.models import model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced_config("qwen3-0.6b")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--batch", "1", "--prompt-len", "2", "--gen", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        steps.make_prefill_step(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        steps.make_serve_step(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--serve-loop"])


def _jax_registry_ids():
    """The JAX registry's ids, read from its source (importing it would
    load JAX)."""
    path = ROOT / "src" / "repro" / "configs" / "registry.py"
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [t.id for t in node.targets] == ["_MODULES"]):
            return [ast.literal_eval(k) for k in node.value.keys]
    raise AssertionError(f"no _MODULES in {path}")


def test_registry_refuses_exactly_the_unported_ids():
    """No id of the JAX registry is refused any more: the port's ids are
    the JAX registry's, each served (the dense zoo since yi-34b,
    command-r-35b and nemotron-4-340b were ported), and an id outside
    them raises ``KeyError``, as the reference does."""
    from repro_torch.configs import registry
    assert sorted(registry.ARCH_IDS) == sorted(_jax_registry_ids())
    assert not hasattr(registry, "UNPORTED")
    for arch in ("deepseek-v2-lite-16b", "kimi-k2-1t-a32b"):
        assert registry.get_config(arch).moe is not None
    assert registry.get_config("zamba2-2.7b").layout == (("zamba_super",
                                                          9),)
    assert registry.get_config("whisper-tiny").layout == (("encdec", 4),)
    assert registry.get_config("phi-3-vision-4.2b").encoder.kind == "vision"
    for arch in ("yi-34b", "command-r-35b", "nemotron-4-340b"):
        assert registry.get_config(arch).arch_type == "dense"
        assert registry.get_reduced_config(arch).n_layers == 2
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_config("llama-2-7b")


def test_all_configs_returns_every_ported_id():
    """``all_configs`` gives every id of the JAX registry its config, in
    the port's id order."""
    from repro_torch.configs import registry
    configs = registry.all_configs()
    assert tuple(configs) == registry.ARCH_IDS
    assert set(configs) == set(_jax_registry_ids())
    assert len(configs) == 10
    for arch, cfg in configs.items():
        assert cfg == registry.get_config(arch)


def test_moe_mla_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch.models.moe, "
            "repro_torch.models.attention, "
            "repro_torch.configs.deepseek_v2_lite_16b, "
            "repro_torch.configs.kimi_k2_1t_a32b; "
            "print(any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
            "for m in sys.modules))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "False"


def test_ssm_zamba_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch.models.ssm, "
            "repro_torch.models.transformer, "
            "repro_torch.configs.zamba2_2_7b; "
            "print(any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
            "for m in sys.modules))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "False"


def test_encdec_vlm_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch.models.model, "
            "repro_torch.configs.whisper_tiny, "
            "repro_torch.configs.phi_3_vision_4_2b; "
            "print(any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
            "for m in sys.modules))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "False"


@pytest.mark.parametrize("what", ["kind", "pattern"])
def test_unknown_blocks_raise(what):
    """Every block kind and layer pattern of the reference is ported; a
    name outside them raises ``ValueError``, as the reference does."""
    from repro_torch.configs.registry import get_reduced_config
    from repro_torch.models import transformer
    cfg = get_reduced_config("qwen3-0.6b")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="unknown"):
        if what == "kind":
            transformer.sub_init(cfg, "conv", gen)
        else:
            transformer.stack_init(cfg.replace(layout=(("conv", 2),)), gen)
    assert set(transformer.KINDS) == {k for kinds in
                                      transformer.PATTERNS.values()
                                      for k in kinds}


def test_xlstm_entry_points_default_to_cuda(monkeypatch):
    """The xlstm serving path takes cuda unless asked for the CPU, raises
    when it is absent, and runs on the CPU when asked."""
    from repro_torch.configs.registry import get_reduced_config
    from repro_torch.launch import serve, steps
    from repro_torch.models import model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced_config("xlstm-125m")
    argv = ["--arch", "xlstm-125m", "--batch", "1", "--prompt-len", "2",
            "--gen", "1"]
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main([*argv, "--full-config"])
    with pytest.raises(RuntimeError, match="CUDA"):
        steps.make_prefill_step(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        steps.make_serve_step(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_cache(cfg, 1, 4)
    assert serve.main([*argv, "--device", "cpu"])["tokens"].shape == (1, 1)


def test_zamba_entry_points_default_to_cuda(monkeypatch):
    """The zamba2 serving path takes cuda unless asked for the CPU, raises
    when it is absent (the full config too, before any allocation), and
    runs on the CPU when asked."""
    from repro_torch.configs.registry import get_reduced_config
    from repro_torch.launch import serve, steps
    from repro_torch.models import model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced_config("zamba2-2.7b")
    argv = ["--arch", "zamba2-2.7b", "--batch", "1", "--prompt-len", "2",
            "--gen", "1"]
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main([*argv, "--full-config"])
    with pytest.raises(RuntimeError, match="CUDA"):
        steps.make_prefill_step(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        steps.make_serve_step(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_cache(cfg, 1, 4)
    params = model.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    assert params["stack"]["segments"][0]["mamba"]["inner"]["w_in"].device \
        == torch.device("cpu")


def test_encdec_vlm_entry_points_default_to_cuda(monkeypatch):
    """The whisper and phi-3-vision serving paths take cuda unless asked
    for the CPU and raise when it is absent (the full configs too, before
    any allocation); on the CPU the launcher serves whisper and refuses the
    VLM, as the reference's does."""
    from repro_torch.configs.registry import get_reduced_config
    from repro_torch.launch import serve, steps
    from repro_torch.models import model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("whisper-tiny", "phi-3-vision-4.2b"):
        cfg = get_reduced_config(arch)
        argv = ["--arch", arch, "--batch", "1", "--prompt-len", "2",
                "--gen", "1"]
        for extra in ([], ["--full-config"]):
            with pytest.raises(RuntimeError, match="CUDA"):
                serve.main([*argv, *extra])
        with pytest.raises(RuntimeError, match="CUDA"):
            steps.make_prefill_step(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            model.init_params(cfg, torch.Generator().manual_seed(0))
    assert serve.main(["--arch", "whisper-tiny", "--batch", "1",
                       "--prompt-len", "2", "--gen", "1", "--device",
                       "cpu"])["tokens"].shape == (1, 1)
    with pytest.raises(SystemExit, match="VLM needs the image path"):
        serve.main(["--arch", "phi-3-vision-4.2b", "--device", "cpu"])


def test_dense_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch.configs.yi_34b, "
            "repro_torch.configs.command_r_35b, "
            "repro_torch.configs.nemotron_4_340b, "
            "repro_torch.configs.registry, repro_torch.launch.serve; "
            "print(any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
            "for m in sys.modules))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "False"


def test_dense_entry_points_default_to_cuda(monkeypatch):
    """The dense models' serving path takes cuda unless asked for the CPU
    and raises when it is absent (the full configs too, before any
    allocation); on the CPU the launcher serves the reduced models."""
    from repro_torch.configs.registry import get_reduced_config
    from repro_torch.launch import serve, steps
    from repro_torch.models import model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("yi-34b", "command-r-35b", "nemotron-4-340b"):
        cfg = get_reduced_config(arch)
        argv = ["--arch", arch, "--batch", "1", "--prompt-len", "2",
                "--gen", "1"]
        for extra in ([], ["--full-config"]):
            with pytest.raises(RuntimeError, match="CUDA"):
                serve.main([*argv, *extra])
        with pytest.raises(RuntimeError, match="CUDA"):
            steps.make_prefill_step(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            steps.make_serve_step(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            model.init_params(cfg, torch.Generator().manual_seed(0))
        with pytest.raises(RuntimeError, match="CUDA"):
            model.init_cache(cfg, 1, 4)
        assert serve.main([*argv, "--device", "cpu"])["tokens"].shape == (
            1, 1)


def test_train_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch.launch.train, "
            "repro_torch.launch.h2fed_round, repro_torch.launch.steps, "
            "repro_torch.optim.sgd, repro_torch.optim.adam, "
            "repro_torch.core.orchestrator; "
            "print(any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
            "for m in sys.modules))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "False"


def test_training_entry_points_default_to_cuda(monkeypatch):
    """The train step, the hierarchical round and the training launcher
    take cuda unless asked for the CPU, and raise when it is absent."""
    from repro_torch.configs.registry import get_reduced_config
    from repro_torch.core.h2fed import H2FedParams
    from repro_torch.launch import h2fed_round, steps, train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, hp = get_reduced_config("qwen3-0.6b"), H2FedParams()
    with pytest.raises(RuntimeError, match="CUDA"):
        steps.make_train_step(cfg, hp)
    with pytest.raises(RuntimeError, match="CUDA"):
        h2fed_round.make_h2fed_round(cfg, hp)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--mesh", "1,1,1", "--rounds", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        steps.init_train_state(cfg, torch.Generator().manual_seed(0))


def test_dryrun_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch.launch.dryrun, "
            "repro_torch.launch.steps, repro_torch.launch.h2fed_round; "
            "print(any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
            "for m in sys.modules))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "False"


def test_dryrun_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """The dry run, its specs and ``materialize`` take cuda unless asked
    for the CPU and raise when it is absent; the reckoning alone needs no
    device (shapes on the meta device)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun, h2fed_round, steps
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen3-0.6b")
    with pytest.raises(RuntimeError, match="CUDA"):
        steps.input_specs(cfg, "long_500k")
    with pytest.raises(RuntimeError, match="CUDA"):
        h2fed_round.round_input_specs(cfg, "train_4k")
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.run_cell("qwen3-0.6b", "long_500k")
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.main(["--arch", "qwen3-0.6b", "--shape", "long_500k",
                     "--out", str(tmp_path)])
    spec = steps.input_specs(cfg, "long_500k", device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        steps.materialize(spec, torch.Generator().manual_seed(0))
    assert steps.peak_bytes(spec)["total"] < 3e9
