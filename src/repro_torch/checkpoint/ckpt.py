"""Read and write the JAX package's checkpoint format
(``repro/checkpoint/ckpt.py``) without JAX.

Layout per step: ``<dir>/step_<n>.npz`` holding ``leaf_<i>`` arrays in
JAX's leaf order plus a ``__manifest__`` JSON blob (step, leaf dtypes and
shapes, the tree's description); the legacy layout
``<dir>/step_<n>/manifest.json`` + ``arrays.npz`` is read too.  bf16
leaves are stored widened to fp32 (exact) with ``bfloat16`` in the
manifest; the names map to torch dtypes here, so no ``ml_dtypes`` is
needed.  ``restore`` needs ``like=``, a tree of the expected structure
(JAX's serialized treedef cannot be read without JAX).  ``save`` writes
the same format, committed with ``os.replace`` as in JAX.
"""
from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree

_MANIFEST_KEY = "__manifest__"


def _to_torch(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A stored leaf in its manifest dtype; bf16 is stored as fp32."""
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.asarray(arr, np.float32)).to(
            torch.bfloat16)
    return torch.from_numpy(np.asarray(arr).astype(np.dtype(dtype_name)))


def _to_storable(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = t.detach().cpu()
    name = str(t.dtype).removeprefix("torch.")
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy(), name


def _step_of(p: Path) -> Optional[int]:
    stem = p.name[:-len(".npz")] if p.name.endswith(".npz") else p.name
    if stem.startswith("."):
        return None
    try:
        return int(stem.split("_")[1])
    except (IndexError, ValueError):
        return None


def latest_step(directory) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [s for p in directory.glob("step_*")
             if (s := _step_of(p)) is not None]
    return max(steps) if steps else None


def _load_payload(directory: Path, step: int) -> Tuple[dict, List]:
    """(manifest, leaves as tensors on the host) for a step, either layout."""
    file_path = directory / f"step_{step:08d}.npz"
    legacy_dir = directory / f"step_{step:08d}"
    if file_path.exists():
        with np.load(file_path) as z:
            manifest = json.loads(bytes(z[_MANIFEST_KEY]).decode())
            leaves = [_to_torch(z[f"leaf_{i}"], dt)
                      for i, dt in enumerate(manifest["dtypes"])]
        return manifest, leaves
    if legacy_dir.is_dir():
        manifest = json.loads((legacy_dir / "manifest.json").read_text())
        with np.load(legacy_dir / "arrays.npz") as z:
            leaves = [_to_torch(z[f"leaf_{i}"], dt)
                      for i, dt in enumerate(manifest["dtypes"])]
        return manifest, leaves
    raise FileNotFoundError(f"no checkpoint for step {step} under {directory}")


def restore(directory, step: Optional[int] = None, *, like: Any,
            check_shapes: bool = True) -> Any:
    """The checkpoint as a tree shaped like ``like``; each leaf keeps the
    stored dtype and goes to the device of ``like``'s leaf in its place.
    ``check_shapes=False`` takes each leaf's stored shape (a tree whose
    leaves grow, as the serve loop's queue and histories do), as the JAX
    package's ``restore`` does."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    _, loaded = _load_payload(directory, step)
    template = tree.leaves(like)
    if len(loaded) != len(template):
        raise ValueError(f"checkpoint step {step} holds {len(loaded)} leaves,"
                         f" the template {len(template)}")
    out = []
    for i, (got, want) in enumerate(zip(loaded, template)):
        if check_shapes and tuple(got.shape) != tuple(want.shape):
            raise ValueError(f"leaf {i}: stored shape {tuple(got.shape)} != "
                             f"template {tuple(want.shape)}")
        out.append(got.to(want.device))
    return tree.unflatten(like, out)


def save(directory, step: int, params: Any) -> Path:
    """Write ``params`` (a tree of tensors) as ``step_<step>.npz``."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}.npz"
    stored = [_to_storable(t) for t in tree.leaves(params)]
    arrays = {f"leaf_{i}": a for i, (a, _) in enumerate(stored)}
    manifest = {"step": step, "n_leaves": len(stored),
                "treedef": "written by repro_torch.checkpoint.ckpt",
                "structure": None,
                "dtypes": [name for _, name in stored],
                "shapes": [list(a.shape) for a, _ in stored]}
    arrays[_MANIFEST_KEY] = np.frombuffer(json.dumps(manifest).encode(),
                                          dtype=np.uint8).copy()
    fd, tmp_name = tempfile.mkstemp(prefix=f".tmp_step_{step:08d}_",
                                    suffix=".npz", dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp_name, final)
    except BaseException:
        try:
            os.unlink(tmp_name)
        except OSError:
            pass
        raise
    return final
