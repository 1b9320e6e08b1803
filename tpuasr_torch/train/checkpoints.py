"""Checkpoints in the JAX package's format: the port's copy of
``tpuasr/train/checkpoints.py``.

A checkpoint is ``ckpt_{step:08d}.msgpack``, the bytes that
``flax.serialization.to_bytes`` writes for JAX's ``TrainState``, beside
``ckpt_{step:08d}.json``, its meta. The tree (``Trainer.state_tree``):

    {"step": int32 0-d array,
     "params": {...}, "batch_stats": {...},     Flax names and layouts
     "opt_state": {...}}                        optax's state dict

so JAX's ``load_for_inference`` and ``restore_checkpoint(path, template)``
read a checkpoint of the port, and the port reads one of JAX's. The codec
is ``tpuasr_torch.utils.msgpack`` (no ``msgpack`` package needed). Saving
keeps the newest ``keep`` checkpoints. JAX's ``OrbaxCheckpointer`` is not
ported (ROADMAP).
"""

from __future__ import annotations

import json
import re
from pathlib import Path

from tpuasr_torch.utils.msgpack import packb, unpackb

__all__ = ["checkpoint_step", "latest_checkpoint", "load_for_inference",
           "restore_checkpoint", "save_checkpoint"]


def save_checkpoint(ckpt_dir, state: dict, step: int, keep: int = 5,
                    meta: dict | None = None) -> Path:
    """state: a tree of dicts with numpy leaves (``Trainer.state_tree``).
    Returns the checkpoint's path."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = ckpt_dir / f"ckpt_{step:08d}.msgpack"
    path.write_bytes(packb(state))
    if meta is not None:
        (ckpt_dir / f"ckpt_{step:08d}.json").write_text(json.dumps(meta))
    ckpts = sorted(ckpt_dir.glob("ckpt_*.msgpack"))
    for old in ckpts[:-keep]:
        old.unlink(missing_ok=True)
        old.with_suffix(".json").unlink(missing_ok=True)
    return path


def latest_checkpoint(ckpt_dir) -> Path | None:
    ckpts = sorted(Path(ckpt_dir).glob("ckpt_*.msgpack"))
    return ckpts[-1] if ckpts else None


def _resolve(path) -> Path:
    path = Path(path)
    if path.is_dir():
        found = latest_checkpoint(path)
        if found is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
        path = found
    return path


def _read(path) -> tuple[dict, dict]:
    path = _resolve(path)
    tree = unpackb(path.read_bytes())
    meta_path = path.with_suffix(".json")
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    return tree, meta


def _check_keys(target, tree, where: str = "") -> None:
    """Raise ValueError where ``tree``'s maps lack a key of ``target``'s,
    as flax's ``from_state_dict`` does."""
    if not isinstance(target, dict):
        return
    if not isinstance(tree, dict):
        raise ValueError(f"expected a map at {where or '/'}")
    missing = set(target) - set(tree)
    if missing:
        raise ValueError(f"checkpoint lacks keys {sorted(missing)} at "
                         f"{where or '/'}")
    for k, v in target.items():
        _check_keys(v, tree[k], f"{where}/{k}")


def restore_checkpoint(path, target: dict | None = None):
    """-> (tree, meta). ``path``: a checkpoint file, or a directory (its
    newest). With ``target`` (a template tree) every map of the template
    must be in the checkpoint."""
    tree, meta = _read(path)
    if target is not None:
        _check_keys(target, tree)
    return tree, meta


def load_for_inference(path) -> tuple[dict, dict]:
    """-> ({'params', 'batch_stats'}, meta) of numpy arrays, without a
    template: what predict and test need."""
    raw, meta = _read(path)
    variables = {"params": raw["params"]}
    if raw.get("batch_stats"):
        variables["batch_stats"] = raw["batch_stats"]
    return variables, meta


def checkpoint_step(path) -> int:
    m = re.search(r"ckpt_(\d+)\.msgpack$", str(path))
    return int(m.group(1)) if m else -1
