"""Flat `.npz` checkpoints, numpy only.

The same format as `mydetection_tpu/checkpoint.py`: a nested-dict tree
is stored as flat `{path: array}` entries under a `params/` prefix (the
optimizer state under `opt/`, user values under `extra/`), with `SEP`
joining the path segments, beside `__step__` and `__format_version__`,
so a checkpoint written by either package loads in the other.
`convert.from_jax_params` maps the flat tree onto the port's module
state and `convert.to_jax_params` maps it back.
"""

from __future__ import annotations

import os
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


def save_checkpoint(path: str, params: Any, *, step: int | None = None,
                    opt_state: Any = None, extra: dict | None = None) -> None:
    """Write `params` (and the optimizer state, step and extra values
    when given) to `path` atomically: into `path + ".tmp"`, then
    `os.replace`, so a crash leaves the old file or the new one."""
    flat = {f"params{SEP}{k}": v for k, v in flatten_tree(params).items()}
    if opt_state is not None:
        flat.update({f"opt{SEP}{k}": v
                     for k, v in flatten_tree(opt_state).items()})
    if step is not None:
        flat["__step__"] = np.asarray(step)
    flat["__format_version__"] = np.asarray(FORMAT_VERSION)
    for k, v in (extra or {}).items():
        flat[f"extra{SEP}{k}"] = np.asarray(v)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:  # a file handle: numpy appends no .npz
        np.savez(fh, **flat)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> dict:
    """{"params": tree | None, "opt": tree | None, "step": int | None,
    "extra": {name: array}, "format_version": int}. A checkpoint written
    before the container markers (format_version < 2) rebuilds its
    bare '#<i>' sequence segments as lists."""
    with np.load(path, allow_pickle=False) as zf:
        flat = {k: zf[k] for k in zf.files}

    def under(prefix: str) -> dict:
        return {k[len(prefix + SEP):]: v for k, v in flat.items()
                if k.startswith(prefix + SEP)}

    params, opt = under("params"), under("opt")
    return {
        "params": unflatten_tree(params) if params else None,
        "opt": unflatten_tree(opt) if opt else None,
        "step": int(flat["__step__"]) if "__step__" in flat else None,
        "extra": under("extra"),
        "format_version": (int(flat["__format_version__"])
                           if "__format_version__" in flat else 1),
    }


def load_params(path: str) -> Any:
    """Weights-only load of an `.npz` checkpoint: the `params/` subtree."""
    params = load_checkpoint(path)["params"]
    if params is None:
        raise ValueError(f"checkpoint {path} has no params")
    return params


def check_params_compatible(expected: Any, loaded: Any, *,
                            context: str = "") -> None:
    """Raise a readable ValueError when a loaded parameter tree does not
    fit the model that will take it: paths missing from the checkpoint,
    paths the model lacks, and shape mismatches. Leaves may be arrays or
    anything with a `.shape`; only shapes are compared."""
    exp_flat = {k: np.shape(v) for k, v in _shape_paths(expected).items()}
    got_flat = {k: np.shape(v) for k, v in _shape_paths(loaded).items()}
    missing = sorted(set(exp_flat) - set(got_flat))
    unexpected = sorted(set(got_flat) - set(exp_flat))
    mismatched = sorted(k for k in set(exp_flat) & set(got_flat)
                        if exp_flat[k] != got_flat[k])
    if missing or unexpected or mismatched:
        lines = [f"checkpoint is incompatible with the model{context}:"]
        for k in mismatched[:8]:
            lines.append(f"  shape mismatch {k}: checkpoint {got_flat[k]} "
                         f"vs model {exp_flat[k]}")
        if missing:
            lines.append(f"  missing from checkpoint: {missing[:6]}")
        if unexpected:
            lines.append(f"  not in model: {unexpected[:6]}")
        lines.append(
            "  (likely a checkpoint saved before a model-geometry "
            "change — re-import the source weights or retrain; see "
            "load_checkpoint's format_version)")
        raise ValueError("\n".join(lines))


def _shape_paths(tree: Any, prefix: str = "") -> dict[str, Any]:
    """{path: leaf} over dict/list/tuple containers, None leaves left
    out."""
    out: dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_shape_paths(v, f"{prefix}{k}{SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_shape_paths(v, f"{prefix}{i}{SEP}"))
    elif tree is not None:
        out[prefix[:-1]] = tree
    return out
