"""Asynchronous, atomic checkpoints with retention and elastic re-shard
(counterpart of ``repro.train.checkpoint``).

Design, as the reference's:
  * one ``.npy`` file per leaf, named by the leaf's path in the tree
    (``params/blocks/0/mix/wq``, path separators as ``__``), plus a JSON
    manifest with each leaf's file, shape and dtype and the step;
  * :meth:`Checkpointer.save` copies every leaf to host memory before it
    returns (the trainer updates its tensors in place right after), then
    writes on a background thread, which overlaps the next steps;
  * atomicity by write-to-tmp + rename, the manifest written last: a
    partial checkpoint is never visible;
  * retention: the last ``keep`` checkpoints;
  * :meth:`Checkpointer.restore` raises ``KeyError`` for a leaf missing
    from the checkpoint and ``ValueError`` for a shape mismatch;
  * elastic re-shard: a checkpoint holds global arrays (a DTensor leaf is
    gathered before it is written, and only rank 0 writes), and
    ``restore(shardings=...)`` lays each one out onto the CURRENT mesh
    (``distribute_tensor``: each rank keeps the shard it owns there),
    whatever mesh wrote it.

A tree is nested dicts, lists, tuples and NamedTuples (``OptState``) of
tensors and Python numbers (the optimizer's count). Restore copies each
leaf into the tensor of ``tree_like`` in place (a full-width state on the
card has no room for a second copy) and returns the tree; a number leaf
comes back as its type.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.distributed import sharding as shd


def _walk(tree, path: str = ""):
    """(path, leaf) pairs of a tree, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{path}/{k}" if path else str(k))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _walk(v, f"{path}/{k}" if path else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}/{i}" if path else str(i))
    else:
        yield path, tree


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, leaves) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _to_host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` (a copy even of a CPU tensor, which the
    caller goes on to update); a DTensor's global value."""
    if isinstance(leaf, torch.Tensor):
        return shd.full(leaf.detach()).to("cpu", copy=True).numpy()
    return np.array(leaf)


def _writer() -> bool:
    """This process writes checkpoints: rank 0, or the only process."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ---- save --------------------------------------------------------------

    def save(self, step: int, tree, *, blocking: bool = False) -> None:
        """Wait for the previous write, snapshot every leaf to host memory,
        then write on a background thread (or here, with ``blocking``)."""
        self.wait()
        host = [(name, _to_host(leaf)) for name, leaf in _walk(tree)]
        if not _writer():
            return
        self._thread = threading.Thread(target=self._write, args=(step, host),
                                        daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host) -> None:
        tmp = os.path.join(self.dir, f".tmp_step_{step:09d}")
        final = os.path.join(self.dir, f"step_{step:09d}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "time": time.time(), "leaves": {}}
        for name, arr in host:
            fn = name.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"][name] = {"file": fn, "shape": list(arr.shape),
                                        "dtype": str(arr.dtype)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # ---- restore -----------------------------------------------------------

    def all_steps(self) -> list[int]:
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                      if d.startswith("step_"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like, step: int | None = None, shardings=None):
        """Restore the checkpoint of ``step`` (the latest by default) into
        ``tree_like``: each tensor leaf overwritten in place, each number
        leaf replaced. Returns (tree, step).

        ``shardings``: a matching tree of :class:`~repro_torch.distributed.
        sharding.NamedSharding` for the CURRENT mesh, the elastic-rescale
        path: each global array is laid out onto it (a new tensor, in the
        dtype of ``tree_like``'s leaf) instead of copied in place."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        out = []
        sflat = (None if shardings is None
                 else iter([s for _, s in _walk(shardings)]))
        for name, like in _walk(tree_like):
            sharding = None if sflat is None else next(sflat)
            info = manifest["leaves"].get(name)
            if info is None:
                raise KeyError(f"leaf {name!r} missing from checkpoint")
            shape = tuple(like.shape) if hasattr(like, "shape") else ()
            if tuple(info["shape"]) != shape:
                raise ValueError(f"{name}: checkpoint shape "
                                 f"{tuple(info['shape'])} != {shape}")
            arr = np.load(os.path.join(d, info["file"]))
            if isinstance(like, torch.Tensor) and sharding is not None:
                out.append(shd.lay_out(
                    torch.from_numpy(arr).to(like.dtype), sharding))
            elif isinstance(like, torch.Tensor):
                with torch.no_grad():
                    like.copy_(torch.from_numpy(arr))
                out.append(like)
            else:
                out.append(type(like)(arr.item()))
        return _rebuild(tree_like, iter(out)), manifest["step"]
