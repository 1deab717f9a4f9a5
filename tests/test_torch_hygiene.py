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
    from repro_torch.fedsim import pretrain_to_target, run_scenario
    from repro_torch.models import mlp
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = ScenarioSpec(n_agents=4, n_rsus=2, n_train=300, n_test=60,
                        rounds=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_scenario(spec)
    params = mlp.init_params(CONFIG, torch.Generator().manual_seed(0))
    res = spec.resolve()
    with pytest.raises(RuntimeError, match="CUDA"):
        pretrain_to_target(params, res.pretrain_pool, res.test.x, res.test.y)


@pytest.mark.parametrize("field,value,error", [
    ("engine", "sharded", NotImplementedError),
    ("engine", "tree", NotImplementedError),
    ("fleet_store", "host", NotImplementedError),
    ("chunk_agents", 4, NotImplementedError),
    ("chunk_params", 128, NotImplementedError),
    ("serve_events", 10, NotImplementedError),
    ("rsu_sharded", True, NotImplementedError),
    ("model_shards", 2, NotImplementedError),
    ("faults", object(), TypeError)],
    ids=["engine-sharded", "engine-tree", "fleet_store-host", "chunk_agents-4",
         "chunk_params-128", "serve_events-10", "rsu_sharded-True",
         "model_shards-2", "faults-value8"])
def test_unported_features_refuse(field, value, error):
    """What is not ported raises by name; a ``faults`` value that is not a
    ``FaultPlan`` is refused."""
    from repro_torch.core.scenario import ScenarioSpec
    with pytest.raises(error):
        ScenarioSpec(**{field: value}).validate()



def test_serve_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch.launch.serve, "
            "repro_torch.checkpoint.ckpt; "
            "print(any(m == 'jax' or m.startswith(('jax.', 'repro.')) "
            "for m in sys.modules))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "False"


def test_serving_entry_points_default_to_cuda(monkeypatch):
    """The serve launcher, the step builders and ``init_params`` take cuda
    unless told otherwise, and raise when it is absent."""
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
    with pytest.raises(SystemExit, match="not ported"):
        serve.main(["--serve-loop"])


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "zamba2-2.7b", "command-r-35b",
                                  "kimi-k2-1t-a32b", "yi-34b", "whisper-tiny",
                                  "deepseek-v2-lite-16b", "nemotron-4-340b"])
def test_unported_archs_refuse(arch):
    from repro_torch.configs.registry import get_config, get_reduced_config
    with pytest.raises(NotImplementedError, match="queue 1 item 15"):
        get_config(arch)
    with pytest.raises(NotImplementedError):
        get_reduced_config(arch)


def _unported_variants():
    from repro_torch.models.config import (EncoderStub, MLAConfig, MoEConfig,
                                           SSMConfig)
    return {"moe": dict(moe=MoEConfig(n_experts=4, top_k=2, expert_d_ff=64)),
            "mla": dict(attn_impl="mla", mla=MLAConfig()),
            "mamba": dict(layout=(("mamba", 2),), ssm=SSMConfig()),
            "xattn": dict(layout=(("encdec", 2),)),
            "zamba_super": dict(layout=(("zamba_super", 1),),
                                shared_every=2, ssm=SSMConfig()),
            "vision": dict(encoder=EncoderStub("vision", 16, 64))}


@pytest.mark.parametrize("kind", ["moe", "mla", "mamba", "xattn",
                                  "zamba_super", "vision"])
def test_unported_kinds_refuse(kind):
    from repro_torch.configs.registry import get_reduced_config
    from repro_torch.models import model
    cfg = get_reduced_config("qwen3-0.6b").replace(
        **_unported_variants()[kind])
    with pytest.raises(NotImplementedError):
        model.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")


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
