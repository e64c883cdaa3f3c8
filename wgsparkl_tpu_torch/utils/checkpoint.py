"""Checkpoint and resume of a simulation state (port of
wgsparkl_tpu/utils/checkpoint.py).

One compressed npz a state, in the JAX package's format: `leaf_i` for the
i-th leaf in the pytree order of its state, `__names__` (a JSON list of the
leaves' names in `jax.tree_util.keystr` form, `.particles.pos`,
`.models.dp['h0']`) and `__extra__` (a JSON object).  The port's state is
dataclasses of tensors; their fields flatten in declaration order, dicts by
sorted key, and a field set to None has no leaf, as in the JAX package's
pytrees.  The affinity word is saved as its uint32 bit pattern (the JAX
package's dtype), so that the two packages read each other's files for
every leaf their states share.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

# Leaves the port holds as int32 and the JAX package as uint32.
UINT32_LEAVES = (".particles.cdf_affinity",)


def named_leaves(state, path: str = ""):
    """[(name, tensor)] of a state in the JAX package's pytree order."""
    if state is None:
        return []
    if isinstance(state, torch.Tensor):
        return [(path, state)]
    if isinstance(state, dict):
        return [leaf for k in sorted(state)
                for leaf in named_leaves(state[k], f"{path}[{k!r}]")]
    if dataclasses.is_dataclass(state):
        return [leaf for f in dataclasses.fields(state)
                for leaf in named_leaves(getattr(state, f.name), f"{path}.{f.name}")]
    raise TypeError(f"{path}: cannot checkpoint a {type(state).__name__}")


def _rebuild(template, leaves):
    """template with its tensor leaves replaced, in order, from `leaves`."""
    if template is None:
        return None
    if isinstance(template, torch.Tensor):
        return next(leaves)
    if isinstance(template, dict):
        return {k: _rebuild(template[k], leaves) for k in sorted(template)}
    return dataclasses.replace(template, **{
        f.name: _rebuild(getattr(template, f.name), leaves)
        for f in dataclasses.fields(template)})


def save(path: str, state, extra: dict | None = None) -> None:
    """Save a SimState (or any dataclass / dict tree of tensors) to one
    .npz file."""
    names, arrays = [], []
    for name, leaf in named_leaves(state):
        a = leaf.detach().cpu().numpy()
        names.append(name)
        arrays.append(a.view(np.uint32) if name in UINT32_LEAVES else a)
    payload = {f"leaf_{i}": a for i, a in enumerate(arrays)}
    payload["__names__"] = np.asarray(json.dumps(names))
    if extra:
        payload["__extra__"] = np.asarray(json.dumps(extra))
    np.savez_compressed(path, **payload)


def load(path: str, template):
    """Load into the structure of `template` (a state of the same shapes),
    each leaf on its template leaf's device.  Raises KeyError on a leaf the
    file lacks and ValueError on a shape mismatch.  Returns (state, extra)."""
    with np.load(path, allow_pickle=False) as data:
        names = json.loads(str(data["__names__"]))
        extra = json.loads(str(data["__extra__"])) if "__extra__" in data else {}
        by_name = {n: data[f"leaf_{i}"] for i, n in enumerate(names)}
    new = []
    for name, t_leaf in named_leaves(template):
        if name not in by_name:
            raise KeyError(f"checkpoint missing leaf {name}")
        arr = by_name[name]
        if arr.shape != tuple(t_leaf.shape):
            raise ValueError(f"shape mismatch for {name}: checkpoint {arr.shape} "
                             f"vs template {tuple(t_leaf.shape)}")
        if arr.dtype == np.uint32:
            arr = arr.view(np.int32)
        new.append(torch.as_tensor(arr).to(t_leaf.device))
    return _rebuild(template, iter(new)), extra
