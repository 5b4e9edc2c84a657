"""Flat `.npz` parameter checkpoints, numpy only.

The same format as `mydetection_tpu/checkpoint.py`: a nested-dict tree
is stored as flat `{path: array}` entries under a `params/` prefix, with
`SEP` joining the path segments, so a checkpoint written by either
package loads in the other. `convert.from_jax_params` maps the flat
tree onto the port's module state.
"""

from __future__ import annotations

from typing import Any

import numpy as np

SEP = "/"
# bumped whenever saved-tree semantics change (mirrors the JAX package)
FORMAT_VERSION = 2


def flatten_tree(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    """Tree → flat {path: array}. Tuples and lists keep their container
    type (`#t<i>` / `#l<i>` path segments) and None leaves survive as a
    marker entry, so the flat form round-trips.

    Dict keys starting with '#', equal to '__none__' or holding `SEP`
    are rejected: they would rebuild as the wrong structure.
    """
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        if not tree:
            raise ValueError(
                "flatten_tree: empty dict containers cannot round-trip "
                f"(at path {prefix!r})")
        for k, v in tree.items():
            if k.startswith("#") or k == "__none__":
                raise ValueError(
                    f"dict key {k!r} collides with flatten_tree's "
                    "reserved markers ('#…' container indices, "
                    "'__none__' None leaves) — rename the key")
            if SEP in k:
                raise ValueError(
                    f"dict key {k!r} contains the path separator {SEP!r} "
                    "— rename the key")
            out.update(flatten_tree(v, f"{prefix}{k}{SEP}"))
    elif isinstance(tree, (list, tuple)):
        if not tree:
            raise ValueError(
                "flatten_tree: empty list/tuple containers cannot "
                f"round-trip (at path {prefix!r})")
        tag = "#t" if isinstance(tree, tuple) else "#l"
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{tag}{i}{SEP}"))
    elif tree is None:
        out[prefix + "__none__"] = np.zeros(0, np.float32)
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def unflatten_tree(flat: dict[str, np.ndarray]) -> Any:
    """Inverse of `flatten_tree`; leaves stay numpy arrays."""
    root: dict = {}
    for key, val in flat.items():
        parts = key.split(SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def idx(key: str) -> int:
        return int(key.lstrip("#tl"))

    def rebuild(node):
        if not isinstance(node, dict):
            return np.asarray(node)
        if set(node) == {"__none__"}:
            return None
        if node and all(k.startswith("#") for k in node):
            items = sorted(node.items(), key=lambda kv: idx(kv[0]))
            seq = [rebuild(v) for _, v in items]
            # '#t' = tuple, '#l' or legacy bare '#<i>' = list
            if next(iter(node)).startswith("#t"):
                return tuple(seq)
            return seq
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(root)


def load_params(path: str) -> Any:
    """Weights-only load of an `.npz` checkpoint: the `params/` subtree."""
    with np.load(path, allow_pickle=False) as zf:
        flat = {k[len("params" + SEP):]: zf[k] for k in zf.files
                if k.startswith("params" + SEP)}
    if not flat:
        raise ValueError(f"checkpoint {path} has no params")
    return unflatten_tree(flat)
