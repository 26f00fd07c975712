"""Topology-independent checkpoints (port of ``repro.checkpoint.store``),
in the reference's on-disk format, so a checkpoint written by either
package restores in the other.

* Every leaf is saved as one ``.npy`` per chunk of its leading axis, plus a
  JSON manifest keyed by the leaf's ``/``-joined path (dict keys sorted,
  sequence indices, named-tuple field names: the keys JAX's tree paths
  give the reference), with each leaf's file, chunk count, shape and dtype
  name.
* bfloat16, which numpy lacks, is stored as its raw ``uint16`` bits under
  the dtype name ``bfloat16``, as the reference stores ``ml_dtypes``
  arrays; it is rebuilt with ``torch.Tensor.view``, so no ``ml_dtypes`` is
  needed.
* Commits are atomic: everything is written into a uniquely named
  ``step_XXXX.tmp-*`` directory, renamed only after the manifest lands.  A
  crashed writer leaves a ``.tmp`` that :func:`latest_step` ignores.
* :class:`AsyncCheckpointer` copies the tree to the host on the caller
  (a copy even of host tensors, which the caller may then update in
  place) and writes it on a background thread, one save in flight.

Trees are nested dicts, lists, tuples and named tuples of tensors, numpy
arrays or Python scalars; ``None`` holds no leaf.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

_MANIFEST = "manifest.json"
_TMP_MARK = ".tmp"
_uid = itertools.count()
_TORCH_DTYPES = {
    "bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32,
    "float64": torch.float64, "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}


def _remove_dir_atomic(path: Path, *, attempts: int = 5) -> None:
    """Remove a directory another thread may still be writing into: rename
    it first (atomic: the writer keeps writing into the doomed directory),
    then remove it, retrying for files still arriving."""
    trash = path.with_name(f"{path.name}.trash-{os.getpid()}-{next(_uid)}")
    try:
        path.rename(trash)
    except FileNotFoundError:
        return
    for i in range(attempts):
        try:
            shutil.rmtree(trash)
            return
        except FileNotFoundError:
            return
        except OSError:
            if i == attempts - 1:
                raise
            time.sleep(0.05 * (i + 1))


def _items(tree: Any, path: tuple = ()) -> list[tuple[str, Any]]:
    """``(key, leaf)`` pairs in the reference's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _items(tree[k], path + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f in tree._fields for kv in _items(getattr(tree, f), path + (f,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, t in enumerate(tree) for kv in _items(t, path + (str(i),))]
    return [("/".join(path), tree)]


def _rebuild(tree: Any, fn: Callable[[Any], Any]) -> Any:
    """``tree`` with each leaf replaced by ``fn(leaf)``, in :func:`_items`
    order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], fn) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), fn) for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(t, fn) for t in tree)
    return fn(tree)


class _Host:
    """A leaf on the host: the array written to disk and its dtype name."""

    __slots__ = ("arr", "dtype")

    def __init__(self, leaf: Any, copy: bool = True):
        if isinstance(leaf, torch.Tensor):
            # a copy even from host memory unless the caller hands the leaf
            # over: it may update the leaf in place while a background
            # thread writes this one
            t = leaf.detach().to("cpu", copy=copy)
            if t.dtype == torch.bfloat16:
                self.arr, self.dtype = t.view(torch.uint16).numpy(), "bfloat16"
            else:
                self.arr = t.numpy()
                self.dtype = str(self.arr.dtype)
            return
        arr = np.asarray(leaf)
        self.dtype = str(arr.dtype)
        # an ml_dtypes array (the reference's bfloat16): its raw same-width uints
        self.arr = arr if arr.dtype.kind in "biufc" else arr.view(np.dtype(f"u{arr.dtype.itemsize}"))


def save(directory: str | Path, step: int, tree: Any, *, chunk_mb: int = 512) -> Path:
    """Write one checkpoint synchronously; returns the committed path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}{_TMP_MARK}-{os.getpid()}-{next(_uid)}"
    stale = directory / f"step_{step:08d}{_TMP_MARK}"
    if stale.exists():
        _remove_dir_atomic(stale)
    tmp.mkdir(parents=True)

    manifest: dict[str, Any] = {"step": step, "leaves": {}, "time": time.time()}
    for i, (key, leaf) in enumerate(_items(tree)):
        host = leaf if isinstance(leaf, _Host) else _Host(leaf)
        arr = host.arr
        n_chunks = 1
        if arr.ndim and arr.nbytes > chunk_mb << 20:
            n_chunks = min(arr.shape[0], -(-arr.nbytes // (chunk_mb << 20)))
            while arr.shape[0] % n_chunks:
                n_chunks -= 1
        fname = f"leaf_{i:05d}"
        for c in range(n_chunks):
            lo = arr.shape[0] * c // n_chunks if arr.ndim else 0
            hi = arr.shape[0] * (c + 1) // n_chunks if arr.ndim else 0
            np.save(tmp / f"{fname}.{c:03d}.npy", arr[lo:hi] if n_chunks > 1 else arr)
        manifest["leaves"][key] = {
            "file": fname, "chunks": n_chunks, "shape": list(arr.shape), "dtype": host.dtype,
        }
    (tmp / _MANIFEST).write_text(json.dumps(manifest))
    last_err: OSError | None = None
    try:
        for attempt in range(5):
            if final.exists():
                if attempt and (final / _MANIFEST).exists():
                    _remove_dir_atomic(tmp)  # a concurrent writer committed this step
                    return final
                _remove_dir_atomic(final)
            try:
                tmp.rename(final)  # atomic commit
                return final
            except OSError as e:
                last_err = e
        if (final / _MANIFEST).exists():
            _remove_dir_atomic(tmp)
            return final
    except BaseException:
        with contextlib.suppress(OSError):
            _remove_dir_atomic(tmp)
        raise
    with contextlib.suppress(OSError):
        _remove_dir_atomic(tmp)
    raise OSError(f"could not commit checkpoint {final}") from last_err


def latest_step(directory: str | Path) -> int | None:
    """The newest committed step in ``directory`` (staging and trash
    directories and steps without a manifest ignored), or ``None``."""
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = []
    for p in directory.iterdir():
        if not (p.is_dir() and p.name.startswith("step_")):
            continue
        suffix = p.name[len("step_"):]
        if suffix.isdigit() and (p / _MANIFEST).exists():
            steps.append(int(suffix))
    return max(steps) if steps else None


def _load(path: Path, meta: dict) -> torch.Tensor:
    """One leaf from its chunks, as a CPU tensor of its saved dtype."""
    parts = [np.load(path / f"{meta['file']}.{c:03d}.npy") for c in range(meta["chunks"])]
    arr = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
    if list(arr.shape) != meta["shape"]:
        raise ValueError(f"{path}: {meta['file']} holds {arr.shape}, the manifest says "
                         f"{meta['shape']}")
    t = torch.from_numpy(arr)
    want = _TORCH_DTYPES[meta["dtype"]]
    return t if t.dtype == want else t.view(want)


def restore(directory: str | Path, step: int, like: Any) -> Any:
    """A tree of the structure of ``like`` holding the checkpoint's leaves
    (looked up by key), each a tensor of its saved dtype on the device of
    ``like``'s leaf when that is a tensor, else on the CPU.  The checkpoint
    knows nothing of the devices it was written from."""
    path = Path(directory) / f"step_{step:08d}"
    leaves = json.loads((path / _MANIFEST).read_text())["leaves"]
    keys = iter(key for key, _ in _items(like))

    def load(leaf):
        t = _load(path, leaves[next(keys)])
        return t.to(leaf.device) if isinstance(leaf, torch.Tensor) else t

    return _rebuild(like, load)


@torch.no_grad()
def restore_into(directory: str | Path, step: int, tree: Any,
                 cut: Callable[[str, torch.Tensor], torch.Tensor] | None = None) -> Any:
    """:func:`restore` into ``tree``'s own tensors, one leaf at a time
    through host memory (no second copy of the tree on its device);
    returns ``tree``.  ``cut(key, t)``, where given, maps each saved leaf
    ``t`` (on the host) to the part of it that ``tree``'s leaf holds.
    Every leaf must be a tensor of its saved (or cut) shape and dtype."""
    path = Path(directory) / f"step_{step:08d}"
    leaves = json.loads((path / _MANIFEST).read_text())["leaves"]
    for key, leaf in _items(tree):
        t = _load(path, leaves[key])
        if cut is not None:
            t = cut(key, t)
        if t.shape != leaf.shape or t.dtype != leaf.dtype:
            raise ValueError(f"{key}: saved {tuple(t.shape)} {t.dtype}, "
                             f"live {tuple(leaf.shape)} {leaf.dtype}")
        leaf.copy_(t)
    return tree


class AsyncCheckpointer:
    """Background-thread checkpoint writer, one save in flight."""

    def __init__(self, directory: str | Path):
        self.directory = Path(directory)
        self._thread: threading.Thread | None = None
        self.saved_steps: list[int] = []

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree: Any, *, copy: bool = True) -> None:
        """Write ``tree`` in the background, its leaves copied to the host
        on the caller first; ``copy=False`` where the caller hands over
        host tensors it will not touch again, which are written as they
        are."""
        self.wait()  # bound to one in-flight write
        host_tree = _rebuild(tree, lambda leaf: _Host(leaf, copy))  # device to host on the caller

        def work():
            save(self.directory, step, host_tree)
            self.saved_steps.append(step)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
