"""Atomic, async checkpoints in the JAX package's layout — the port of
``repro/checkpoint/checkpointer.py`` at one device.

Layout: ``<dir>/step_<N>/{meta.json, arrays/<file>.npy}``, the manifest
in ``meta.json`` mapping each leaf's key to its file, shape and dtype.
A state is a tree of plain nested dicts (a train state goes through
`repro_torch.train.train_step.state_tree` first); a key is the leaf's
path joined by ``##`` in the reference's pytree order (dict keys sorted
level by level), so ``params##groups##l0##attn##wq``,
``opt##m##embed##tok``, ``opt##step``. Writes go to a temporary
directory and are published by an atomic rename, so a crash mid-save
never corrupts the latest good checkpoint; the newest `keep` survive.

bfloat16 leaves: the reference writes them through ``ml_dtypes``, whose
``.npy`` header says ``'<V2'`` and whose manifest dtype says
``"bfloat16"``. Without ``ml_dtypes`` numpy reads such a file as 2-byte
void records; the port reinterprets those bytes as bfloat16, bit for bit,
and writes its own bfloat16 leaves the same way (2-byte void records,
manifest dtype ``"bfloat16"``). It never imports ``ml_dtypes``.

A save snapshots every leaf into a host copy before it returns, also on
the CPU where ``tensor.numpy()`` would alias the live tensor: the
optimizer updates in place, and an async write must not see a half-
updated state.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.models.common import flatten, unflatten

_SEP = "##"
BF16 = "bfloat16"


def _keys(tree) -> dict:
    """Nested dicts -> ``{key: leaf}`` in the reference's order."""
    return {name.replace(".", _SEP): leaf
            for name, leaf in flatten(tree).items()}


def to_host(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of `t` (never a view of it); bfloat16 as 2-byte void
    records holding its bits."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def from_host(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A manifest leaf as a CPU tensor; a ``"bfloat16"`` leaf from its raw
    2-byte records (or from any 2-byte dtype numpy gives it)."""
    if dtype_name == BF16:
        if arr.dtype.itemsize != 2:
            raise TypeError(f"bfloat16 leaf stored as {arr.dtype}")
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


class Checkpointer:
    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.save_count = 0

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state, extra: Optional[dict] = None,
             blocking: bool = True):
        """Snapshot to host copies, then write (on a thread if not
        `blocking`). A write still in flight finishes first: the trainer
        saves its last step twice (at its interval, async, and at its
        end), and two writers of one step share its temporary directory."""
        host = {k: (to_host(v), str(v.dtype).removeprefix("torch."))
                for k, v in _keys(state).items()}
        self.wait()
        if blocking:
            self._write(step, host, extra or {})
        else:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, extra or {}))
            self._thread.start()

    def _write(self, step: int, host: dict, extra: dict):
        tmp = self.dir / f".tmp_step_{step}_{os.getpid()}"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        (tmp / "arrays").mkdir(parents=True)
        manifest = {}
        for key, (arr, dtype) in host.items():
            fn = f"{abs(hash(key)) % 10 ** 12}_{len(manifest)}.npy"
            np.save(tmp / "arrays" / fn, arr)
            manifest[key] = {"file": fn, "shape": list(arr.shape),
                             "dtype": dtype}
        meta = {"step": step, "time": time.time(), "manifest": manifest,
                "extra": extra}
        (tmp / "meta.json").write_text(json.dumps(meta))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)               # atomic publish
        self.save_count += 1
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1])
                      for p in self.dir.glob("step_*") if p.is_dir()
                      and (p / "meta.json").exists())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None, device=None):
        """Restore into the structure of `template` (nested dicts of
        tensors): each leaf cast to its template leaf's dtype and shape, on
        `device` (default: the template leaf's). Returns (state, meta)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        ckpt = self.dir / f"step_{step}"
        meta = json.loads((ckpt / "meta.json").read_text())
        manifest = meta["manifest"]
        flat = flatten(template)
        missing = {n.replace(".", _SEP) for n in flat} - set(manifest)
        if missing:
            raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]}")
        values = {}
        for name, leaf in flat.items():
            entry = manifest[name.replace(".", _SEP)]
            arr = from_host(np.load(ckpt / "arrays" / entry["file"]),
                            entry["dtype"])
            values[name] = arr.to(leaf.dtype).reshape(leaf.shape).to(
                device if device is not None else leaf.device)
        return unflatten(values), meta
