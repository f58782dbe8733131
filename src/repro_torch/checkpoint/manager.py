"""Checkpointing: atomic, versioned, async-capable — the port of the JAX
package's ``checkpoint/manager.py``, with its on-disk layout, so a
checkpoint either package writes restores into the other's state:

    <dir>/step_<N>/
        arrays.npz   every leaf keyed by its tree path ("params/embed",
                     "opt/count", ...), saved whole; bf16 bit for bit as
                     uint16
        meta.json    step, time, extra state, n_leaves, dtypes per key
    <dir>/LATEST     atomically updated pointer

* Atomicity: write into ``step_<N>.tmp``, then rename; a crash mid-save
  never corrupts the restore path.
* Async: :meth:`save_async` snapshots to the host synchronously, then
  writes in a thread, overlapping the I/O with the next step.
* Preemption: :meth:`install_sigterm_handler` flushes a final checkpoint
  on SIGTERM and exits with 143; the handler it replaced is put back then,
  or by :meth:`restore_sigterm_handler`.
* Meshes: a DTensor leaf is saved whole (every rank takes part in its
  gather; rank 0 writes), and :meth:`restore` with ``shardings`` lays each
  leaf out over any mesh's placements — the elastic path: a checkpoint of
  one mesh (or of one device) restores onto another.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

# npz cannot hold bf16: its bits go as uint16, as the JAX package stores
# ml_dtypes' bfloat16


def _items(tree, prefix: str = ""):
    """(path, leaf) pairs of a nested-dict tree, keys in sorted order, as
    JAX flattens a dict."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _writes() -> bool:
    """Whether this process writes checkpoints: rank 0 of a process group,
    or the one process without one."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_host(leaf) -> np.ndarray:
    """A tensor (or number) as a NumPy array; bf16 as its uint16 bits; a
    DTensor whole."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    if hasattr(leaf, "full_tensor"):
        leaf = leaf.full_tensor()
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _snapshot(state) -> tuple[dict, dict]:
    flat, dtypes = {}, {}
    for key, leaf in _items(state):
        flat[key] = _to_host(leaf)
        dtypes[key] = _dtype_name(leaf)
    return flat, dtypes


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3):
        self.dir = directory
        self.keep_n = keep_n
        self._thread: Optional[threading.Thread] = None
        self._prev_handler = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def save(self, step: int, state, extra: Optional[dict] = None) -> str:
        """Synchronous atomic save (under a process group every rank
        returns once rank 0 has written it)."""
        path = self._write(step, *_snapshot(state), extra or {})
        import torch.distributed as dist
        if dist.is_initialized():
            dist.barrier()
        return path

    def save_async(self, step: int, state,
                   extra: Optional[dict] = None) -> None:
        """Snapshot now, write in the background."""
        self.wait()
        flat, dtypes = _snapshot(state)
        self._thread = threading.Thread(
            target=self._write, args=(step, flat, dtypes, extra or {}),
            daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: dict, dtypes: dict, extra: dict) -> str:
        final = os.path.join(self.dir, f"step_{step:08d}")
        if not _writes():
            return final
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        meta = {"step": step, "time": time.time(), "extra": extra,
                "treedef": "repro_torch nested dict: " + ",".join(flat),
                "n_leaves": len(flat), "dtypes": dtypes}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):                   # same step already saved
            shutil.rmtree(tmp)
            return final
        os.replace(tmp, final)                      # atomic
        with open(os.path.join(self.dir, "LATEST.tmp"), "w") as f:
            f.write(os.path.basename(final))
        os.replace(os.path.join(self.dir, "LATEST.tmp"),
                   os.path.join(self.dir, "LATEST"))
        self._gc()
        return final

    def _gc(self) -> None:
        steps = sorted(d for d in os.listdir(self.dir) if d.startswith("step_")
                       and not d.endswith(".tmp"))
        for old in steps[:-self.keep_n]:
            shutil.rmtree(os.path.join(self.dir, old), ignore_errors=True)

    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        ptr = os.path.join(self.dir, "LATEST")
        if not os.path.exists(ptr):
            return None
        with open(ptr) as f:
            name = f.read().strip()
        if not os.path.exists(os.path.join(self.dir, name)):
            return None
        return int(name.split("_")[1])

    def restore(self, template, step: Optional[int] = None,
                shardings=None) -> tuple[Any, dict]:
        """Restore into the structure of ``template`` (a tree of tensors):
        each leaf comes back in the template leaf's type, on its device.
        With ``shardings`` (a tree of ``parallel.rules.NamedSharding``, for
        any mesh, whatever the save ran on) each leaf comes back as a
        DTensor laid out by its sharding: the elastic-rescale path."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        saved = meta.get("dtypes", {})

        def one(key, leaf):
            if key not in flat:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = np.array(flat[key])           # a copy; 0-d stays 0-d
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"checkpoint leaf {key} has shape "
                                 f"{arr.shape}, the template's "
                                 f"{tuple(leaf.shape)}")
            if saved.get(key) == "bfloat16":    # undo the serialization view
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            return t.to(device=leaf.device, dtype=leaf.dtype)

        def build(tree, sh, prefix=""):
            if isinstance(tree, dict):
                return {k: build(v, None if sh is None else sh[k],
                                 f"{prefix}{k}/") for k, v in tree.items()}
            t = one(prefix[:-1], tree)
            if sh is None:
                return t
            from torch.distributed.tensor import distribute_tensor
            # every rank read the same file: each keeps its block
            return distribute_tensor(t.to(sh.mesh.device_type), sh.mesh,
                                     sh.placements, src_data_rank=None)

        return build(template, shardings), meta

    # ------------------------------------------------------------------
    def install_sigterm_handler(self, get_state: Callable[[], tuple[int, Any]]):
        """On SIGTERM (preemption), flush one final checkpoint (``extra``
        ``{"preempted": True}``), put the replaced handler back and exit
        with 143.  Returns the replaced handler."""
        def handler(signum, frame):
            step, state = get_state()
            self.wait()
            self.save(step, state, extra={"preempted": True})
            self.restore_sigterm_handler()
            raise SystemExit(143)
        self.restore_sigterm_handler()
        prev = signal.signal(signal.SIGTERM, handler)
        # None: a handler not installed from Python; the default stands in
        self._prev_handler = signal.SIG_DFL if prev is None else prev
        return prev

    def restore_sigterm_handler(self) -> None:
        """Put back the handler :meth:`install_sigterm_handler` replaced
        (nothing when none is installed)."""
        if self._prev_handler is not None:
            signal.signal(signal.SIGTERM, self._prev_handler)
            self._prev_handler = None
