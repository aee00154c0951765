"""Sharded, atomic checkpointing, torch counterpart of ``repro.ckpt``.

The on-disk layout is the JAX package's, byte for byte (but for a bf16
leaf's ``.npy`` header: the port writes its words as ``<u2``, where the JAX
package may write ``<V2``; the manifest and the data are the same), so a
directory written by either package restores in the other:

  * every leaf is one ``.npy`` (chunked along dim 0 into ``<leaf>.c<i>.npy``
    files above ``chunk_bytes``) plus one JSON manifest (shapes, dtypes,
    chunk counts, keyed by the ``/``-joined leaf path);
  * atomicity: writes go to ``step_K.tmp/`` and are renamed to ``step_K``; a
    same-step overwrite demotes the old snapshot to ``step_K.old`` first,
    and a crash between the two renames is healed by the next manager;
  * async: ``save(..., blocking=False)`` copies the leaves to the host, then
    hands the write to a daemon thread; its failure surfaces at the next
    ``wait()`` or ``save()``;
  * retention: the newest ``keep`` checkpoints stay.

A tree is nested dicts (keys sorted, as ``jax.tree_util`` orders them),
lists, tuples and dataclasses (``IndexState``, ``LshParams``,
``WalkTable``: their init fields in order, less the static ones a class
names in ``_ckpt_static``, as the JAX package's ``tree_flatten`` lists
them), with ``None`` as an empty subtree; its leaves are torch tensors,
numpy arrays or scalars.  A Python scalar leaf restores as a Python scalar
of its type.  Leaves go to the host with
``.cpu().numpy()``; a dtype numpy cannot name (``bfloat16``) is stored as
raw unsigned words under its own name, as the JAX package stores it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["CheckpointManager", "save_pytree", "restore_pytree",
           "restore_flat"]

_SEP = "/"


def _children(node):
    """(name, child) pairs of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(str(i), getattr(node, name))
                for i, name in enumerate(_node_fields(node))]
    return None


def _node_fields(node) -> list:
    """A dataclass node's children, by field name, in tree order."""
    static = getattr(node, "_ckpt_static", ())
    return [f.name for f in dataclasses.fields(node)
            if f.init and f.name not in static]


def _flatten(tree: Any, prefix: str = "", out: Optional[dict] = None) -> dict:
    """{``/``-joined path: leaf} in the JAX package's leaf order."""
    out = {} if out is None else out
    if tree is None:
        return out
    kids = _children(tree)
    if kids is None:
        out[prefix] = tree
        return out
    for name, child in kids:
        _flatten(child, f"{prefix}{_SEP}{name}" if prefix else name, out)
    return out


def _rebuild(template: Any, leaf_fn, prefix: str = ""):
    """``template``'s structure with each leaf replaced by ``leaf_fn(path)``."""
    if template is None:
        return None
    path = lambda name: f"{prefix}{_SEP}{name}" if prefix else name
    if isinstance(template, dict):
        return {k: _rebuild(template[k], leaf_fn, path(str(k))) for k in template}
    if isinstance(template, (list, tuple)):
        vals = [_rebuild(c, leaf_fn, path(str(i))) for i, c in enumerate(template)]
        return type(template)(vals) if isinstance(template, list) else tuple(vals)
    if _children(template) is not None:                 # a dataclass node
        return dataclasses.replace(template, **{
            name: _rebuild(getattr(template, name), leaf_fn, path(str(i)))
            for i, name in enumerate(_node_fields(template))})
    return leaf_fn(prefix)


class _Raw:
    """Raw unsigned words of a leaf whose dtype numpy cannot name."""

    def __init__(self, words: np.ndarray, dtype: str):
        self.words, self.dtype = words, dtype


def _to_host(leaf):
    """A leaf as a host array, or as ``_Raw`` for a tensor whose dtype numpy
    cannot hold."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu().contiguous()
        try:
            return t.numpy()
        except TypeError:                  # bfloat16 and kin: raw words
            words = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
            raw = t.view(words[t.element_size()]).numpy()
            return _Raw(raw.view(f"u{t.element_size()}"), str(t.dtype).split(".")[-1])
    return np.asarray(leaf)


def _np_dtype(name: str):
    """A manifest dtype name as a numpy dtype, or None when numpy cannot
    name it (``bfloat16``: torch holds it instead)."""
    try:
        dt = np.dtype(name)
    except TypeError:
        return None
    return None if dt.kind == "V" else dt      # ml_dtypes' types are raw void


def save_pytree(tree: Any, directory: str, chunk_bytes: int = 1 << 30) -> None:
    """Write tree -> directory (must not exist; caller handles atomicity)."""
    os.makedirs(directory)
    manifest = {"leaves": {}, "treedef": None}
    for key, leaf in _flatten(tree).items():
        arr = leaf if isinstance(leaf, _Raw) else _to_host(leaf)
        if isinstance(arr, _Raw):
            true_dtype, arr = arr.dtype, arr.words
        else:
            true_dtype = arr.dtype.name
            if true_dtype not in np.sctypeDict:
                # ml_dtypes (bfloat16 etc.): raw words, the true dtype in
                # the manifest, re-viewed on restore
                arr = arr.view(f"u{arr.dtype.itemsize}")
        fname = key.replace(_SEP, ".")
        nchunks = 1
        if arr.nbytes > chunk_bytes and arr.ndim > 0 and arr.shape[0] > 1:
            nchunks = min(arr.shape[0], max(1, arr.nbytes // chunk_bytes))
        manifest["leaves"][key] = {
            "file": fname, "shape": list(arr.shape),
            "dtype": true_dtype, "chunks": nchunks,
        }
        if nchunks == 1:
            np.save(os.path.join(directory, fname + ".npy"), arr)
        else:
            for ci, part in enumerate(np.array_split(arr, nchunks, axis=0)):
                np.save(os.path.join(directory, f"{fname}.c{ci}.npy"), part)
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def _load_leaf(directory: str, meta: dict):
    """One manifest leaf -> host array (chunks joined, dtype re-viewed); a
    dtype numpy cannot name comes back as a CPU tensor of that dtype."""
    if meta["chunks"] == 1:
        arr = np.load(os.path.join(directory, meta["file"] + ".npy"))
    else:
        arr = np.concatenate([
            np.load(os.path.join(directory, f"{meta['file']}.c{ci}.npy"))
            for ci in range(meta["chunks"])], axis=0)
    want = _np_dtype(meta["dtype"])
    if want is None:
        signed = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}[arr.itemsize]
        return torch.from_numpy(arr.view(signed).copy()).view(getattr(torch, meta["dtype"]))
    if arr.dtype != want:
        arr = arr.view(want)
    return arr


def _as_tensor(arr, device) -> torch.Tensor:
    t = arr if torch.is_tensor(arr) else torch.from_numpy(np.array(arr))   # 0-d kept
    return t.to(device)


def restore_pytree(template: Any, directory: str, device=None) -> Any:
    """Restore into the structure of ``template`` (shapes verified); every
    leaf comes back as a tensor on ``device`` (``None``: the card, as
    ``resolve_device`` reads it; with no card that raises)."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    flat_t = _flatten(template)
    device = resolve_device(device)
    vals = {}
    for key, leaf in flat_t.items():
        arr = _load_leaf(directory, manifest["leaves"][key])
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
        if tuple(arr.shape) != shape:
            raise ValueError(f"{key}: ckpt shape {tuple(arr.shape)} != {shape}")
        if type(leaf) in (int, float, bool):
            vals[key] = type(leaf)(arr.item())
        else:
            vals[key] = _as_tensor(arr, device)
    return _rebuild(template, vals.__getitem__)


def restore_flat(directory: str) -> dict:
    """Template-free restore: ``{flat_key: np.ndarray}`` from the manifest.

    The cluster's recovery restores a replica snapshot before it has
    rebuilt any index, so shapes and dtypes come from the manifest alone.
    Keys are the ``/``-joined tree paths ``save_pytree`` wrote.
    """
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    return {key: _load_leaf(directory, meta)
            for key, meta in manifest["leaves"].items()}


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._async_error: Optional[BaseException] = None
        self._promote_orphaned_old()

    def _promote_orphaned_old(self) -> None:
        """Heal a crash between ``write()``'s two renames: a same-step
        overwrite demotes ``step_N`` to ``step_N.old`` before renaming the
        new one in; when only the ``.old`` survived, it is renamed back, so
        that step N (whose WAL prefix may be truncated already) is kept."""
        for name in os.listdir(self.root):
            if not name.endswith(".old"):
                continue
            base = os.path.join(self.root, name[:-len(".old")])
            if not os.path.exists(base):
                os.rename(os.path.join(self.root, name), base)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def all_steps(self):
        out = []
        for name in os.listdir(self.root):
            if not name.startswith("step_") or name.endswith(".tmp"):
                continue
            suffix = name[len("step_"):]
            if suffix.isdigit():  # tolerate stray entries (step_junk, notes...)
                out.append(int(suffix))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self):
        """Join the async writer; re-raise what it failed with."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._async_error is not None:
            err, self._async_error = self._async_error, None
            raise RuntimeError("async checkpoint save failed") from err

    def save(self, step: int, tree: Any, blocking: bool = True) -> None:
        self.wait()
        # to the host now, before the caller goes on to mutate the tensors
        flat = {k: _to_host(v) for k, v in _flatten(tree).items()}
        host_tree = _rebuild(tree, flat.__getitem__)

        def write():
            final = self._step_dir(step)
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            save_pytree(host_tree, tmp)
            if os.path.exists(final):
                # same-step overwrite: demote the old snapshot with a rename
                # (atomic); _promote_orphaned_old heals a crash in between
                old = final + ".old"
                if os.path.exists(old):
                    shutil.rmtree(old)
                os.rename(final, old)
            os.rename(tmp, final)
            self._gc()

        def write_captured():
            try:
                write()
            except BaseException as e:  # surfaces via wait()/next save()
                self._async_error = e

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write_captured, daemon=True)
            self._thread.start()

    def restore(self, step: int, template: Any, device=None) -> Any:
        return restore_pytree(template, self._step_dir(step), device)

    def restore_latest(self, template: Any, device=None):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, template, device)

    def restore_flat_step(self, step: int) -> dict:
        """Template-free dict restore of one step (see ``restore_flat``)."""
        return restore_flat(self._step_dir(step))

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        for name in os.listdir(self.root):
            # stray .tmp dirs are crashed saves and .old dirs demoted
            # same-step predecessors, never the one being written
            if name.endswith(".tmp") or name.endswith(".old"):
                shutil.rmtree(os.path.join(self.root, name),
                              ignore_errors=True)
