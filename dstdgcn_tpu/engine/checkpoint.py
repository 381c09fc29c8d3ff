"""Checkpoint save/restore for engine state.

Deterministic-resume checkpointing of the full pytree (params, batch stats,
optimizer state, PRNG key) plus scalar metadata, replacing the reference's
``torch.save`` dict (engine/prediction.py:159-182).  A checkpoint is one
``.npz`` archive: one array per leaf, named by its tree path
(``params/conv_st_in/block/spatial/wf``, ``opt_state/inner_state/0/mu/...``),
plus a JSON member holding the caller's payload and the PRNG
implementation of every typed key.  No pickle is involved, and unlike the
reference the optimizer/schedule state fully round-trips (the reference
saves but never restores its scheduler, prediction.py:159-169).

Restoring checks the archive against the live state: a missing or extra
path, a shape or dtype change, or a dropout key of another PRNG
implementation raises ``ValueError`` naming the leaves at fault.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import jax
import numpy as np

__all__ = ["save_checkpoint", "restore_checkpoint"]

_META = "__meta__"


def _path_str(path) -> str:
    parts = []
    for k in path:
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                parts.append(str(getattr(k, attr)))
                break
        else:
            parts.append(str(k))
    return "/".join(parts)


def _is_key(x) -> bool:
    return hasattr(x, "dtype") and jax.dtypes.issubdtype(
        x.dtype, jax.dtypes.prng_key)


def save_checkpoint(path: str, state: Any, payload: Dict[str, Any]) -> None:
    arrays, impls = {}, {}
    for p, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        name = _path_str(p)
        if _is_key(leaf):
            impls[name] = str(jax.random.key_impl(leaf))
            leaf = jax.random.key_data(leaf)
        arrays[name] = np.asarray(jax.device_get(leaf))
    arrays[_META] = np.asarray(json.dumps(
        dict(payload=payload, prng_impls=impls)))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)  # atomic publish: no torn checkpoints on failure


def restore_checkpoint(path: str, target: Any) -> Tuple[Any, Dict[str, Any]]:
    """Load ``path`` into the structure of ``target`` (host arrays)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z[_META]))
        stored = {k: z[k] for k in z.files if k != _META}
    leaves, treedef = jax.tree_util.tree_flatten_with_path(target)
    names = [_path_str(p) for p, _ in leaves]
    missing = sorted(set(names) - set(stored))
    extra = sorted(set(stored) - set(names))
    if missing or extra:
        raise ValueError(
            f"checkpoint {path} does not match the model state: missing "
            f"{missing[:8]}{'...' if len(missing) > 8 else ''}, unexpected "
            f"{extra[:8]}{'...' if len(extra) > 8 else ''}")
    out = []
    for name, (_, live) in zip(names, leaves):
        arr = stored[name]
        if _is_key(live):
            impl = str(jax.random.key_impl(live))
            saved = meta["prng_impls"].get(name)
            if saved != impl:
                raise ValueError(
                    f"checkpoint {path}: {name} is a {saved} PRNG key but "
                    f"the engine uses {impl}; set engine.prng_impl to match")
            out.append(jax.random.wrap_key_data(arr, impl=impl))
            continue
        if arr.shape != np.shape(live) or arr.dtype != live.dtype:
            raise ValueError(
                f"checkpoint {path}: {name} is {arr.dtype}{list(arr.shape)}"
                f" but the model has {live.dtype}{list(np.shape(live))}")
        out.append(arr)
    return jax.tree_util.tree_unflatten(treedef, out), meta["payload"]
