"""Fault-tolerant checkpointing: async, atomic, elastic (the reference's
``ckpt/checkpoint.py``).

Layout (one directory per step)::

    <root>/step_00000100.tmp/...    while writing
    <root>/step_00000100/
        manifest.json               leaf names, shapes, dtypes, specs;
                                    committed last
        arr_<idx>.npy               one file per leaf (the full array)

Atomicity: everything is written into a ``.tmp`` dir, fsync'd, then renamed
by ``os.replace`` — a crash can never leave a half-checkpoint that restore
would accept, and ``latest_step`` only reports dirs with a committed
manifest.  Keep-k garbage collection runs after each commit.

The tree is a nested dict whose leaves are tensors (any device), numpy
arrays, Python scalars, or lists of tensors (saved as their stack along a
new leading axis: a stacked layer leaf, gathered from a model's layer
list while it is copied to the host).  The manifest names each leaf by
its path of keys (``"params/layers/wq"``) where the reference stores a
JAX treedef.  A ``bfloat16`` tensor is written as its ``int16`` view with
``"dtype": "bfloat16"`` in the manifest (numpy has no bfloat16 without
``ml_dtypes``), so every file loads with plain
``np.load(..., allow_pickle=False)``; restore views it back.

``save`` copies the tree to host memory before it returns (the async
write works on that snapshot, so the caller may update its tensors in
place at once).  ``restore`` returns host tensors, or, given a grid, each
rank's block by the leaf's spec (``core.dtensor``'s ``local_slices``),
read from a memory map so the full array is never loaded.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

_SEP = "/"


def _flatten(tree, prefix=""):
    for k in tree:
        if _SEP in str(k):
            raise ValueError(f"key {k!r} holds {_SEP!r}")
        v = tree[k]
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}{_SEP}")
        else:
            yield f"{prefix}{k}", v


def _unflatten(pairs) -> dict:
    tree: dict = {}
    for name, value in pairs:
        *path, leaf = name.split(_SEP)
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = value
    return tree


def _host(x) -> tuple[np.ndarray, str]:
    """(a host copy of leaf ``x`` as numpy, its dtype's name)."""
    if isinstance(x, (list, tuple)):
        t = torch.empty((len(x),) + tuple(x[0].shape), dtype=x[0].dtype)
        for i, layer in enumerate(x):
            t[i].copy_(layer.detach())
    elif isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
    else:
        a = np.array(x)
        return a, str(a.dtype)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    return t.numpy(), str(t.numpy().dtype)


def _spec_to_json(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _spec_from_json(lst) -> tuple:
    return tuple(tuple(e) if isinstance(e, list) else e for e in lst)


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = np.array(arr)
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3, async_write: bool = True):
        self.root = root
        self.keep = keep
        self.async_write = async_write
        os.makedirs(root, exist_ok=True)
        self._pending: threading.Thread | None = None
        self._error: BaseException | None = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree, specs=None, block: bool = False):
        """Snapshot ``tree`` to host memory and write it in the background
        (or now, with ``block``).  ``specs``: a tree of the same keys with
        a spec per leaf (default: every dim unsplit)."""
        self.wait()
        names, leaves = zip(*_flatten(tree)) if tree else ((), ())
        spec_of = dict(_flatten(specs)) if specs is not None else {}
        host = [_host(x) for x in leaves]
        meta = {
            "step": step,
            "time": time.time(),
            "leaves": [
                {"name": name, "file": f"arr_{i}.npy",
                 "shape": list(a.shape), "dtype": dt,
                 "spec": _spec_to_json(spec_of.get(name,
                                                   (None,) * a.ndim))}
                for i, (name, (a, dt)) in enumerate(zip(names, host))],
        }

        def write():
            tmp = os.path.join(self.root, f"step_{step:08d}.tmp")
            final = os.path.join(self.root, f"step_{step:08d}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            for i, (a, _) in enumerate(host):
                with open(os.path.join(tmp, f"arr_{i}.npy"), "wb") as f:
                    np.save(f, a, allow_pickle=False)
                    f.flush()
                    os.fsync(f.fileno())
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)        # atomic commit
            self._gc()

        if self.async_write and not block:
            def run():
                try:
                    write()
                except BaseException as exc:   # raised again by wait()
                    self._error = exc
            t = threading.Thread(target=run, daemon=True)
            t.start()
            self._pending = t
        else:
            write()

    def wait(self):
        """Join the pending write; raise what it raised."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.root):
            if d.startswith("step_") and not d.endswith(".tmp") and \
                    os.path.exists(os.path.join(self.root, d,
                                                "manifest.json")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, grid=None, specs_tree=None):
        """Restore step ``step`` (default: the latest).  Returns (step,
        tree).  With ``grid`` None the leaves are host tensors (CPU);
        with a grid, each is this rank's block by its spec (the
        manifest's, or ``specs_tree``'s), on the grid's device; a spec's
        axes that the grid lacks are dropped (elastic down-scale)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError("no checkpoint found")
        d = os.path.join(self.root, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            meta = json.load(f)
        spec_of = dict(_flatten(specs_tree)) if specs_tree is not None \
            else {}
        pairs = []
        for lm in meta["leaves"]:
            path = os.path.join(d, lm["file"])
            if grid is None:
                arr = np.load(path, allow_pickle=False)
                pairs.append((lm["name"], _to_tensor(arr, lm["dtype"])))
                continue
            spec = spec_of.get(lm["name"], _spec_from_json(lm["spec"]))
            arr = np.load(path, mmap_mode="r", allow_pickle=False)
            block = arr[_block(tuple(lm["shape"]), spec, grid)]
            pairs.append((lm["name"], _to_tensor(
                np.array(block), lm["dtype"]).to(grid.device)))
        return step, _unflatten(pairs)


def _block(shape: tuple, spec: tuple, grid) -> tuple:
    """This rank's slices of an array of ``shape`` split by ``spec`` on
    ``grid``, keeping only the spec's axes that the grid has."""
    from repro_torch.core.domain import Domain
    from repro_torch.core.dtensor import DistTensor
    ent = list(spec) + [None] * (len(shape) - len(spec))
    layout = {}
    for i, e in enumerate(ent):
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        kept = tuple(grid.axis_index(a) for a in axes if a in grid.axes)
        if kept:
            layout[f"d{i}"] = kept
    if not shape:
        return ()
    dims = tuple(f"d{i}" for i in range(len(shape)))
    dom = Domain((0,) * len(shape), tuple(n - 1 for n in shape))
    return DistTensor((dom,), dims, layout, grid).local_slices()
