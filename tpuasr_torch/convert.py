"""Carry JAX checkpoints across: Flax variable trees <-> torch state dicts.

A Flax model's variables are ``{"params": ..., "batch_stats": ...}`` nested
by module name. The port's modules use the same names, so a leaf at
``params/rnn0/fwd/wx`` becomes ``rnn0.fwd.wx``. A ``fused_bidir`` BiGRU
keeps JAX's six parameters on the layer itself (``fwd_wx``, ``fwd_wh``,
``fwd_b``, ``bwd_wx``, ``bwd_wh``, ``bwd_b``), so ``params/rnn0/fwd_wx``
becomes ``rnn0.fwd_wx`` by the same rule. Two layouts change:

* a conv ``kernel`` HWIO (Kt, Kf, Cin, Cout) becomes ``weight`` OIHW
  (Cout, Cin, Kt, Kf);
* a Dense ``kernel`` (in, out) becomes a Linear ``weight`` (out, in).

Every other leaf keeps its name and layout: a conv ``bias``, batch-norm
``scale``/``bias`` and ``mean``/``var``, the GRU ``wx``/``wh``/``b``,
CapsNet's ``W_route`` (N_in, Din, O*D) and its 0-d ``logit_scale``.
ResNet-CTC's blocks nest one level deeper (``params/stage1_block0/proj/
kernel`` becomes ``stage1_block0.proj.weight``) under the same rules.

The training step starts from a JAX ``init_state`` the same way
(``Trainer.init_state({"params": ..., "batch_stats": ...})``) and gives its
state back as a Flax tree through ``to_jax_variables``
(``TrainState.variables()``). To export a JAX checkpoint, DeepSpeech,
CapsNet or ResNet-CTC (in a process that has JAX):

    import jax, numpy as np
    from tpuasr.train.checkpoints import load_for_inference
    from tpuasr_torch.convert import save_npz
    variables, meta = load_for_inference("ckpt_dir")
    save_npz(jax.tree.map(np.asarray, variables), "weights.npz", meta=meta)

This module imports no jax.
"""

from __future__ import annotations

import json
from collections.abc import Mapping

import numpy as np
import torch

_STAT_NAMES = ("mean", "var")


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def from_jax_variables(tree) -> dict:
    """Flax variable tree (numpy leaves) -> torch state dict."""
    state = {}
    for col in ("params", "batch_stats"):
        for path, a in _flatten(tree.get(col, {})):
            if path[-1] == "kernel":
                if a.ndim == 4:          # HWIO -> OIHW
                    a = a.transpose(3, 2, 0, 1)
                elif a.ndim == 2:        # (in, out) -> (out, in)
                    a = a.T
                path = path[:-1] + ("weight",)
            state[".".join(path)] = torch.from_numpy(np.array(a, copy=True))
    return state


def to_jax_variables(state_dict) -> dict:
    """torch state dict -> Flax variable tree of numpy arrays."""
    tree = {"params": {}, "batch_stats": {}}
    for name, t in state_dict.items():
        a = t.detach().to("cpu").numpy()
        path = name.split(".")
        if path[-1] == "weight":
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
            path[-1] = "kernel"
        col = "batch_stats" if path[-1] in _STAT_NAMES else "params"
        node = tree[col]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        # ascontiguousarray alone would make a 0-d leaf (CapsNet's
        # logit_scale) 1-d.
        node[path[-1]] = np.ascontiguousarray(a).reshape(a.shape)
    return tree


def sorted_tree(tree):
    """``tree`` with every map's keys in sorted order, as JAX's tree
    functions rebuild dicts (and so as flax writes a parameter tree)."""
    if isinstance(tree, Mapping):
        return {k: sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def save_npz(tree, path, meta: dict | None = None) -> None:
    """Write a variable tree as .npz with flattened 'params/rnn0/fwd/wx'
    keys; ``meta`` (e.g. num_classes, model_kwargs, feature) rides along as
    JSON."""
    flat = {"/".join(p): a for col in ("params", "batch_stats")
            for p, a in _flatten({col: tree.get(col, {})})}
    if meta is not None:
        flat["__meta__"] = np.asarray(json.dumps(meta))
    np.savez(path, **flat)


def load_npz(path) -> dict:
    """Read ``save_npz`` output back into a nested tree; its metadata, if
    any, is under the "meta" key."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            if key == "__meta__":
                tree["meta"] = json.loads(str(data[key]))
                continue
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return tree
