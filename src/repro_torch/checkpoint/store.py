"""Tree checkpointing in the reference's format (port of
``repro/checkpoint/store.py``): ``arrays.npz`` holds the leaves by tree
path, ``manifest.json`` the step, keys, dtypes, shapes and ``extra``.

Tree paths are the reference's strings, so a checkpoint either package
writes is one the other restores: ``.x`` for a named-tuple field (the
solver states), ``x`` for a dict key, ``0`` for a sequence index, joined
by ``/`` (``.x/w1``).  A None leaf has no entry, and a Python int leaf
(the port's round counter) is stored as an int32 0-d array, as the
reference's counter is.

Writes are atomic: everything is staged into a temp sibling directory,
fsynced, and ``os.replace``d into place (an existing checkpoint is swapped
out through a doomed sibling), so a crash mid-save leaves the previous
checkpoint or none, never a truncated one.  Loads raise
``CheckpointCorruptError`` (naming the path) on a missing or truncated
``arrays.npz``/``manifest.json`` or a missing leaf.

    save_checkpoint("run/ck", state, step=state.k)
    state, manifest = load_checkpoint("run/ck", like_tree=solver.init(x0))
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import zipfile
from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.common.trees import is_namedtuple, tree_children


class CheckpointCorruptError(RuntimeError):
    """A checkpoint directory is missing, truncated, or inconsistent."""


def flatten_with_paths(tree) -> dict:
    """``{path: leaf}`` in flatten order; None leaves have no entry."""
    out = {}

    def walk(node, path):
        if node is None:
            return
        kids = tree_children(node)
        if kids is None:
            out["/".join(path)] = node
            return
        for name, child in kids:
            walk(child, path + (name,))

    walk(tree, ())
    return out


def to_numpy(leaf) -> np.ndarray:
    """A leaf as the array the reference stores: a tensor's values on the
    host (bf16 as ml_dtypes' bfloat16), a Python int as int32 (the round
    counter), a Python float as float32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes

            return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()
    if isinstance(leaf, bool):
        return np.asarray(leaf)
    if isinstance(leaf, int):
        return np.asarray(leaf, dtype=np.int32)
    if isinstance(leaf, float):
        return np.asarray(leaf, dtype=np.float32)
    return np.asarray(leaf)


def to_tensor(a, device) -> torch.Tensor:
    """A numpy array (bf16 ones as ml_dtypes' bfloat16) as a tensor on
    ``device``."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.as_tensor(a, device=device)


def _fsync_dir(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    except OSError:  # some filesystems reject a directory fsync
        pass
    finally:
        os.close(fd)


def save_checkpoint(path, tree, step=0, extra=None):
    """Write ``tree`` (tensors, numpy arrays, ints; nested named tuples,
    mappings and sequences) to the directory ``path``, atomically."""
    path = os.fspath(path)
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    arrays = {k: to_numpy(v) for k, v in flatten_with_paths(tree).items()}
    manifest = {
        "step": int(step),
        "keys": sorted(arrays.keys()),
        "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "extra": extra or {},
    }
    tmp = tempfile.mkdtemp(prefix=os.path.basename(path) + ".tmp.",
                           dir=parent)
    try:
        for name, writer in (
            ("arrays.npz", lambda f: np.savez(f, **arrays)),
            ("manifest.json", lambda f: json.dump(manifest, f, indent=1)),
        ):
            mode = "wb" if name.endswith(".npz") else "w"
            with open(os.path.join(tmp, name), mode) as f:
                writer(f)
                f.flush()
                os.fsync(f.fileno())
        _fsync_dir(tmp)
        if os.path.isdir(path):
            # os.replace cannot clobber a non-empty directory: swap through
            # a doomed sibling so the target's transition stays atomic
            doomed = tempfile.mkdtemp(prefix=os.path.basename(path)
                                      + ".old.", dir=parent)
            os.replace(path, os.path.join(doomed, "prev"))
            os.replace(tmp, path)
            shutil.rmtree(doomed, ignore_errors=True)
        else:
            os.replace(tmp, path)
        _fsync_dir(parent)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _read_manifest(path):
    mpath = os.path.join(path, "manifest.json")
    if not os.path.exists(mpath):
        raise CheckpointCorruptError(f"missing manifest: {mpath}")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        raise CheckpointCorruptError(
            f"unreadable/truncated manifest: {mpath} ({e})") from e
    if "keys" not in manifest:
        raise CheckpointCorruptError(f"manifest missing 'keys': {mpath}")
    return manifest


def _read_arrays(path, manifest):
    apath = os.path.join(path, "arrays.npz")
    if not os.path.exists(apath):
        raise CheckpointCorruptError(f"missing arrays: {apath}")
    try:
        with np.load(apath) as z:
            data = {k: z[k] for k in z.files}
    except (zipfile.BadZipFile, OSError, ValueError, EOFError) as e:
        raise CheckpointCorruptError(
            f"unreadable/truncated arrays: {apath} ({e})") from e
    missing = [k for k in manifest["keys"] if k not in data]
    if missing:
        raise CheckpointCorruptError(
            f"arrays.npz missing leaves {missing[:4]}"
            f"{'...' if len(missing) > 4 else ''}: {apath}")
    return data


def _restore(like, arrays, path, device, where):
    if like is None:
        return None
    kids = tree_children(like)
    if kids is None:
        key = "/".join(path)
        if key not in arrays:
            raise CheckpointCorruptError(
                f"checkpoint at {where} lacks leaf '{key}' of like_tree")
        a = arrays[key]
        if isinstance(like, bool):
            return bool(a)
        if isinstance(like, int):
            return int(a)
        if isinstance(like, float):
            return float(a)
        dev = device if device is not None else (
            like.device if isinstance(like, torch.Tensor) else "cpu")
        return to_tensor(a, dev)
    vals = [_restore(child, arrays, path + (name,), device, where)
            for name, child in kids]
    if is_namedtuple(like):
        return type(like)(*vals)
    if isinstance(like, Mapping):
        items = dict(zip(sorted(like), vals))
        return items if isinstance(like, dict) else type(like)(**items)
    return type(like)(vals)


def load_checkpoint(path, like_tree=None, device=None):
    """``(tree, manifest)``.  Without ``like_tree`` the tree is the
    ``{path: numpy array}`` dict; with it (a template of the same
    structure, e.g. a solver's ``init`` state) the template's structure
    with each array as a tensor on the template leaf's device (or
    ``device``), and each int leaf as an int."""
    path = os.fspath(path)
    manifest = _read_manifest(path)
    arrays = _read_arrays(path, manifest)
    if like_tree is None:
        return {k: arrays[k] for k in manifest["keys"]}, manifest
    return _restore(like_tree, arrays, (), device, path), manifest
