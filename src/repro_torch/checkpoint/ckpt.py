"""Checkpointing: atomic, versioned, resumable save/restore of states.

Counterpart of ``repro.checkpoint.ckpt``, in the same layout, so a
checkpoint one package writes the other restores:

  * Atomic: writes go to ``<dir>/tmp.<step>`` then ``os.replace`` into
    ``step_<n>`` (``step_{step:010d}``) — a crash mid-save never corrupts
    the latest checkpoint.
  * Versioned: every save is a new ``step_<n>`` directory; the newest one
    sealed by the ``COMMIT`` marker file is the latest; ``keep`` are kept.
  * Self-describing: one ``leaf_<i>.npy`` per leaf and a ``manifest.json``
    with each leaf's shape and numpy dtype name (``"float64"``, never
    ``"torch.float64"``); restore validates both against the running
    program and fails loudly on drift (``allow_cast=True`` accepts a
    dtype cast explicitly).

Leaves follow the reference's flatten order: the fields of a NamedTuple
in order, tuple and list items in order, dict items by sorted key, and
None holds no leaf.  A tensor is written from the host; a Python ``int``
(the port's iteration counter ``t``, where the reference holds a 0-d
int32 array) is written as a 0-d ``int32`` leaf and restored as an int.
A bfloat16 tensor, which numpy cannot hold, is written as its ``uint16``
bit pattern with ``"bfloat16"`` in the manifest and viewed back.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

COMMIT = "COMMITTED"

__all__ = ["COMMIT", "all_steps", "latest_step", "restore", "save"]


def _children(node):
    """The child nodes of a container, in the reference's flatten order,
    or None for a leaf."""
    if node is None:
        return []
    if hasattr(node, "_fields"):                          # NamedTuple
        return list(node)
    if isinstance(node, (list, tuple)):
        return list(node)
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    return None


def flatten(tree) -> list:
    """The leaves of ``tree`` (tensors, ints, floats, arrays) in the
    reference's order."""
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in flatten(kid)]


def unflatten(like, leaves):
    """``like``'s structure with its leaves replaced, in order."""
    it = iter(leaves)

    def build(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        if node is None:
            return None
        new = [build(k) for k in kids]
        if hasattr(node, "_fields"):
            return type(node)(*new)
        if isinstance(node, (list, tuple)):
            return type(node)(new)
        return dict(zip(sorted(node), new))

    return build(like)


def dtype_name(leaf) -> str:
    """The numpy name of a leaf's dtype (a Python int is the reference's
    int32 counter)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return "bfloat16"
        return str(torch.empty((), dtype=leaf.dtype).numpy().dtype)
    if isinstance(leaf, bool):
        return "bool"
    if isinstance(leaf, int):
        return "int32"
    return str(np.asarray(leaf).dtype)


def to_numpy(leaf) -> np.ndarray:
    """The host array written for a leaf (bfloat16 as its bits)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16)
        return t.cpu().numpy()
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def file_dtype(name: str) -> str:
    """The dtype of the ``.npy`` file of a leaf whose manifest dtype is
    ``name`` (a bfloat16 leaf is stored as its bits)."""
    return "uint16" if name == "bfloat16" else name


def from_numpy(arr: np.ndarray, saved_dtype: str, device) -> torch.Tensor:
    """A tensor of a leaf as written (``saved_dtype`` its manifest name)."""
    if saved_dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(
            np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def write_leaves(tmp: str, leaves: list) -> list:
    """Write ``leaves`` as ``leaf_<i>.npy`` into ``tmp``; their manifest
    entries."""
    entries = []
    for i, leaf in enumerate(leaves):
        arr = to_numpy(leaf)
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
        entries.append({"shape": list(arr.shape), "dtype": dtype_name(leaf)})
    return entries


def seal(tmp: str, final: str, manifest: dict) -> None:
    """Write the manifest and the COMMIT marker into ``tmp`` and move it
    to ``final`` atomically."""
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, COMMIT), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)


def fresh_dir(path: str) -> str:
    """``path`` created empty (an earlier, unsealed one removed)."""
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    return path


def _treedef(node) -> str:
    kids = _children(node)
    if kids is None:
        return "*"
    if node is None:
        return "None"
    inner = ", ".join(_treedef(k) for k in kids)
    if hasattr(node, "_fields"):
        return f"{type(node).__name__}({inner})"
    if isinstance(node, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(node[k])}"
                               for k in sorted(node)) + "}"
    return f"[{inner}]" if isinstance(node, list) else f"({inner})"


def save(directory: str, step: int, tree: Any, *, keep: int = 3) -> str:
    """Atomically save ``tree`` as checkpoint ``step``.  Returns the
    path."""
    os.makedirs(directory, exist_ok=True)
    tmp = fresh_dir(os.path.join(directory, f"tmp.{step}"))
    final = os.path.join(directory, f"step_{step:010d}")
    leaves = flatten(tree)
    manifest = {"step": step, "n_leaves": len(leaves),
                "treedef": _treedef(tree),
                "leaves": write_leaves(tmp, leaves)}
    seal(tmp, final, manifest)
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int):
    steps = sorted(all_steps(directory))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:010d}"),
                      ignore_errors=True)


def all_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and os.path.exists(
                os.path.join(directory, name, COMMIT)):
            out.append(int(name[5:]))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, like: Any, *, step: Optional[int] = None,
            allow_cast: bool = False) -> Any:
    """Restore into the structure of ``like``, failing loudly on drift.

    Both the leaf SHAPES and the manifest DTYPES must match the running
    program — a dtype mismatch (a float64 run restored into a float32
    one, or the other way) raises instead of silently casting, because a
    silent cast makes a resumed solve diverge from the uninterrupted one.
    ``allow_cast=True`` accepts the cast to ``like``'s dtypes.  Tensors
    land on the device of ``like``'s; an int leaf of ``like`` comes back
    as an int.
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = flatten(like)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, expected "
            f"{len(leaves)} — config drift?")
    out = []
    for i, ref in enumerate(leaves):
        arr = np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
        want = tuple(ref.shape) if isinstance(ref, torch.Tensor) \
            else tuple(np.shape(ref))
        if tuple(arr.shape) != want:
            raise ValueError(f"leaf {i}: shape {arr.shape} != {want}")
        want_dtype = dtype_name(ref)
        saved_dtype = manifest["leaves"][i].get("dtype")
        if (saved_dtype is not None and saved_dtype != want_dtype
                and not allow_cast):
            raise ValueError(
                f"leaf {i}: checkpoint dtype {saved_dtype} != running "
                f"{want_dtype} — dtype drift (was the float width changed "
                f"between save and resume?); pass allow_cast=True to cast")
        if isinstance(ref, torch.Tensor):
            out.append(from_numpy(arr, saved_dtype or str(arr.dtype),
                                  ref.device).to(ref.dtype))
        elif isinstance(ref, int) and not isinstance(ref, bool):
            out.append(int(arr))
        else:
            out.append(np.asarray(arr, dtype=np.asarray(ref).dtype))
    return unflatten(like, out)
