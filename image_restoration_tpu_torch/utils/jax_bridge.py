"""JAX param tree -> the port's state_dict, without importing jax.

The inverse of image_restoration_tpu/utils/torch_import.py
``import_state_dict``. That importer maps a torch key onto the flax tree
mechanically: digit segments merge into their parent (``encoder_level1.0``
-> ``encoder_level1_0``), flax-only single-child wrapper levels are
descended (``Conv.conv``), torch-only wrapper levels are skipped
(``patch_embed.proj``), and ``weight`` lands on ``kernel`` transposed from
OIHW to HWIO (dense: (O, I) to (I, O)). A flax path alone cannot say which
``name_N`` segments were torch indices (``encoder_level1_0``) and which are
names (``down1_2``), so this walk starts from the target's torch keys and
follows the importer's own rule for each; the leaf it finds goes back to
torch layout. ``body`` levels stay: the reference torch modules have them
too (``norm1.body.weight``, ``down1_2.body.0.weight``). GroupNorm's flax
``scale`` lands on ``weight``.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch


def _merge_digit_segments(segs):
    out = []
    for s in segs:
        if out and re.fullmatch(r"\d+", s):
            out[-1] = f"{out[-1]}_{s}"
        else:
            out.append(s)
    return out


def _single_child(node):
    return (isinstance(node, dict) and len(node) == 1
            and isinstance(next(iter(node.values())), dict))


def _locate(tree: dict, key: str):
    """The flax path that ``import_state_dict`` fills from torch ``key``, or
    None. Mirrors its walk step for step."""
    segs = _merge_digit_segments(key.split("."))
    mods, leaf = segs[:-1], segs[-1]
    node, path = tree, []
    for s in mods:
        while isinstance(node, dict) and s not in node and _single_child(node):
            k = next(iter(node))
            node, path = node[k], path + [k]
        if isinstance(node, dict) and s in node:
            node, path = node[s], path + [s]
        # else: a torch-only wrapper level, skipped as the importer skips it
    if not isinstance(node, dict):
        return None
    candidates = [leaf] + (["kernel", "scale"] if leaf == "weight" else [])
    while True:
        for c in candidates:
            if c in node and not isinstance(node[c], dict):
                return tuple(path + [c])
        if not _single_child(node):
            return None
        k = next(iter(node))
        node, path = node[k], path + [k]


def _leaf_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def _plain(tree):
    if isinstance(tree, Mapping):
        return {k: _plain(v) for k, v in tree.items()}
    return tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _to_torch_layout(key: str, arr: np.ndarray, leaf: str, shape):
    if leaf == "kernel":
        if arr.ndim == 4:  # conv HWIO -> OIHW
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 2:  # dense (I, O) -> (O, I)
            arr = arr.T
    if tuple(arr.shape) != tuple(shape):
        if arr.size != int(np.prod(shape)):
            raise ValueError(f"shape mismatch for {key}: JAX {arr.shape} vs "
                             f"torch {tuple(shape)}")
        arr = arr.reshape(shape)  # squeezable, e.g. (C,) vs (C, 1, 1)
    return arr


_STATS = ("running_mean", "running_var")


def state_dict_from_jax(params: Mapping[str, Any],
                        like: Mapping[str, torch.Tensor],
                        key_map: Optional[Callable[[str],
                                                   Optional[str]]] = None,
                        batch_stats: Optional[Mapping[str, Any]] = None,
                        ) -> Dict[str, torch.Tensor]:
    """Build a state_dict for the model whose ``state_dict()`` is ``like``
    from a JAX param tree (nested dicts of arrays, loop layout).

    ``key_map`` rewrites each torch key before the walk, as the same
    argument of ``import_state_dict`` does (DRSformer's
    ``drsformer_key_map``); the state_dict keeps the torch keys. A key the
    map sends to None has no JAX leaf (LSNet's ``attention_bias_idxs``) and
    keeps the model's own buffer.

    BatchNorm models (LSNet) carry a second JAX collection: ``running_mean``
    and ``running_var`` come from ``batch_stats`` (``variables
    ["batch_stats"]``), walked like the params; ``num_batches_tracked`` has
    no JAX counterpart and stays the model's own. Without ``batch_stats``
    (a params-only ``.npz``, as the JAX ``cli/robust.py`` loads one) the
    running statistics stay at the model's init, as they do in JAX.

    Raises KeyError when a torch key finds no JAX leaf or a JAX leaf is not
    placed under any torch key, and ValueError on a shape that does not fit:
    a tree of another architecture does not load.
    """
    trees = {"params": _plain(params)}
    if batch_stats is not None:
        trees["batch_stats"] = _plain(batch_stats)
    out, placed, missing = {}, set(), []
    for key, ref in like.items():
        mapped = key if key_map is None else key_map(key)
        is_stat = key.endswith(_STATS)
        if (mapped is None or key.endswith("num_batches_tracked")
                or (is_stat and batch_stats is None)):
            out[key] = ref.detach().clone()
            continue
        coll = "batch_stats" if is_stat else "params"
        path = _locate(trees[coll], mapped)
        if path is None:
            missing.append(key)
            continue
        arr = np.asarray(_get(trees[coll], path))
        arr = _to_torch_layout(key, arr, path[-1], ref.shape)
        out[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(ref.dtype)
        placed.add((coll,) + path)
    if missing:
        raise KeyError(f"{len(missing)} torch keys have no JAX leaf, e.g. "
                       f"{missing[:8]}")
    unplaced = [(c,) + p for c, t in trees.items() for p in _leaf_paths(t)
                if (c,) + p not in placed]
    if unplaced:
        raise KeyError(f"{len(unplaced)} JAX leaves have no torch key, e.g. "
                       f"{['/'.join(p) for p in unplaced[:8]]}")
    return out
