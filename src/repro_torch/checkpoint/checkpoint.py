"""Fault-tolerant checkpointing (counterpart of ``repro.checkpoint``).

The reference's layout and policies:

  * **atomic**: writes go to ``step_N.tmp/`` then ``os.rename`` to
    ``step_N/``, so a crash mid-save never corrupts the latest checkpoint;
  * **async**: ``save_async`` snapshots the tensors to host memory before
    it returns, then writes in a background thread;
  * **per leaf**: one ``.npy`` per tensor leaf and a ``manifest.json`` keyed
    by the leaf's path (``params/layers/attn/wq``, ``opt/m/embed``): nested
    dicts by key, NamedTuples by field name; ``None`` leaves are left out;
  * **retention**: keep the newest ``keep`` checkpoints, delete older.

numpy has no bfloat16, so a bf16 leaf is stored as its bits (an int16
array) and the manifest's ``dtypes`` names its dtype; every file reads
back with numpy alone.  ``restore`` loads into the structure, dtypes and
devices of a template.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_paths(tree: Any, prefix: str = "") -> dict[str, Any]:
    """Leaves of nested dicts and NamedTuples by ``/``-joined path."""
    if isinstance(tree, dict) or _is_namedtuple(tree):
        items = tree.items() if isinstance(tree, dict) else zip(tree._fields, tree)
        flat = {}
        for key, child in items:
            flat.update(_flatten_with_paths(child, f"{prefix}{key}/"))
        return flat
    return {} if tree is None else {prefix[:-1]: tree}


def _unflatten(template: Any, values: dict[str, Any], prefix: str = "") -> Any:
    """``template`` with each leaf replaced by ``values[path]``."""
    if isinstance(template, dict):
        return {k: _unflatten(v, values, f"{prefix}{k}/") for k, v in template.items()}
    if _is_namedtuple(template):
        return type(template)(*(
            _unflatten(v, values, f"{prefix}{k}/") for k, v in zip(template._fields, template)
        ))
    return None if template is None else values[prefix[:-1]]


def _to_host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A numpy copy of ``t`` and the name of its dtype."""
    t = t.detach().cpu()
    dtype = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().copy(), dtype


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr))  # a writable copy; keeps 0-d arrays 0-d
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._pending: Optional[threading.Thread] = None

    # -- save -------------------------------------------------------------

    def save(self, step: int, tree: Any) -> str:
        return self._write(step, self._snapshot(tree))

    def save_async(self, step: int, tree: Any) -> None:
        host = self._snapshot(tree)  # snapshot BEFORE returning
        self.wait()
        self._pending = threading.Thread(target=self._write, args=(step, host), daemon=True)
        self._pending.start()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    @staticmethod
    def _snapshot(tree: Any) -> dict[str, tuple[np.ndarray, str]]:
        return {key: _to_host(leaf) for key, leaf in _flatten_with_paths(tree).items()}

    def _write(self, step: int, host: dict[str, tuple[np.ndarray, str]]) -> str:
        final = os.path.join(self.dir, f"step_{step:010d}")
        tmp = final + ".tmp"
        with self._lock:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            leaves, dtypes = {}, {}
            for i, (key, (arr, dtype)) in enumerate(sorted(host.items())):
                fname = f"leaf_{i:06d}.npy"
                np.save(os.path.join(tmp, fname), arr)
                leaves[key], dtypes[key] = fname, dtype
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump({"step": step, "leaves": leaves, "dtypes": dtypes}, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic publish
            self._gc()
        return final

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"), ignore_errors=True)

    # -- restore -----------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target: Any) -> Any:
        """Load into the structure of ``target``, each leaf in the dtype and
        on the device of the target's tensor at its path."""
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves, dtypes = manifest["leaves"], manifest["dtypes"]
        flat_target = _flatten_with_paths(target)
        missing = set(flat_target) - set(leaves)
        extra = set(leaves) - set(flat_target)
        if missing or extra:
            raise ValueError(f"checkpoint mismatch: missing={missing} extra={extra}")
        values = {}
        for key, tgt in flat_target.items():
            t = _from_host(np.load(os.path.join(path, leaves[key])), dtypes[key])
            if tuple(t.shape) != tuple(tgt.shape):
                raise ValueError(f"{key}: shape {tuple(t.shape)} != target {tuple(tgt.shape)}")
            values[key] = t.to(device=tgt.device, dtype=tgt.dtype)
        return _unflatten(target, values)
