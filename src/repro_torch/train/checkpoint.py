"""Fault-tolerant checkpointing (torch counterpart of
``repro/train/checkpoint.py``, same on-disk format).

  * atomic: written to ``step_N.tmp`` then renamed; a re-save of an
    existing step swaps through ``step_N.old``, which the recovery sweep
    (``_recover``) republishes or drops after a crash;
  * async: ``save`` copies every leaf to the host at call time, a
    background thread writes the files, and a writer's error surfaces at
    the next ``wait`` or ``save``;
  * self-describing: ``step_N/manifest.json`` lists every leaf of the
    nested state dict, keys joined by ``::`` (``params::emb/tok``,
    ``opt::count``, ``step``), with its ``.npy`` file, shape and dtype.  A
    bfloat16 leaf is written as its uint16 bits under dtype
    ``"bfloat16"``, which the JAX ``restore`` views back, and the JAX
    manager's checkpoints restore here;
  * retention: the last ``keep`` checkpoints are kept.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_SEP = "::"  # path separator for flattened nested-dict keys


def _flatten(tree, prefix=()) -> Dict[str, Any]:
    """Leaves of a nested dict keyed by their ``::``-joined paths, keys
    sorted at every level (the order JAX flattens a dict in)."""
    if isinstance(tree, dict):
        flat = {}
        for k in sorted(tree):
            flat.update(_flatten(tree[k], prefix + (str(k),)))
        return flat
    return {_SEP.join(prefix): tree}


def _unflatten_like(like, flat: Dict[str, Any], prefix=()):
    if isinstance(like, dict):
        return {k: _unflatten_like(v, flat, prefix + (str(k),))
                for k, v in like.items()}
    return flat[_SEP.join(prefix)]


def _to_host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(array, manifest dtype) of a leaf, copied to the host now."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        # np.load gives the JAX manager's bf16 leaves as raw '|V2' records
        # and this manager's as uint16: the same bits either way
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))   # a contiguous copy, any ndim


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._recover()

    def _recover(self):
        """Crash-recovery sweep for interrupted re-save swaps: a crash
        between the two renames in ``_write`` leaves the data only under
        ``step_N.old`` — republish it; if the swap completed, the leftover
        ``.old`` is garbage — drop it."""
        for old in self.dir.glob("step_*.old"):
            final = self.dir / old.name[:-len(".old")]
            if final.exists():
                shutil.rmtree(old, ignore_errors=True)
            else:
                os.rename(old, final)

    # ---- save -----------------------------------------------------------
    def save(self, step: int, state: Any, *, blocking: bool = False,
             extra: Optional[Dict] = None):
        """Snapshot ``state`` (device -> host copy now), serialize async.
        Raises any error the PREVIOUS async write died with before
        starting the new one."""
        host = {k: _to_host(v) for k, v in _flatten(state).items()}
        self.wait()
        self._thread = threading.Thread(
            target=self._write_guarded, args=(step, host, extra or {}),
            daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def _write_guarded(self, step: int, host: Dict[str, Tuple], extra: Dict):
        try:
            self._write(step, host, extra)
        except BaseException as e:  # surfaced by wait()/next save()
            self._error = e

    def _write(self, step: int, host: Dict[str, Tuple], extra: Dict):
        tmp = self.dir / f"step_{step}.tmp"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "time": time.time(), "extra": extra,
                    "leaves": {}}
        for i, (key, (arr, dtype)) in enumerate(host.items()):
            fname = f"leaf_{i}.npy"
            np.save(tmp / fname, arr)
            manifest["leaves"][key] = {
                "file": fname, "shape": list(arr.shape), "dtype": dtype}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            # re-saving an existing step: park the old dir under a name
            # all_steps() ignores, publish the new one, drop the old
            old = self.dir / f"step_{step}.old"
            if old.exists():
                shutil.rmtree(old)
            os.rename(final, old)
            os.rename(tmp, final)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.rename(tmp, final)  # atomic on POSIX
        self._gc()

    def wait(self):
        """Block until the in-flight write finishes; re-raise its error."""
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ---- restore ---------------------------------------------------------
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and not p.name.endswith(".tmp"):
                try:
                    out.append(int(p.name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None) -> Any:
        """A new nested dict shaped like ``like`` with every leaf read
        from the checkpoint at ``step`` (the latest by default) onto the
        device of ``like``'s leaf.  Raises on a missing key or a shape or
        dtype that differs from ``like``'s."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        out = {}
        for key, ref in _flatten(like).items():
            meta = manifest["leaves"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint at step {step} missing {key!r}")
            t = _from_host(np.load(d / meta["file"]), meta["dtype"])
            if tuple(t.shape) != tuple(ref.shape) or t.dtype != ref.dtype:
                raise ValueError(
                    f"{key}: checkpoint {tuple(t.shape)} {t.dtype} != "
                    f"{tuple(ref.shape)} {ref.dtype}")
            out[key] = t.to(ref.device)
        return _unflatten_like(like, out)

    def manifest(self, step: Optional[int] = None) -> Dict:
        step = step if step is not None else self.latest_step()
        return json.loads(
            (self.dir / f"step_{step}" / "manifest.json").read_text())
