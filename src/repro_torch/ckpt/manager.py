"""Checkpoint manager (port of ``repro/ckpt/manager.py``), in the
reference's on-disk layout so that either package restores the other's
checkpoints:

    <directory>/step_<n:010d>/<group>.npz   one array per leaf, keyed by
                                            the leaf's ``/``-joined key path
    <directory>/step_<n:010d>/manifest.json {"step": n, "groups": {group:
                                            {"names": [...], "treedef": null}}}

* **Atomic**: a step is written to ``tmp.<n>``, the manifest is fsynced,
  and the directory is renamed to ``step_<n:010d>``; a step directory
  without a manifest, or a ``tmp.<n>``, is never listed.
* **Snapshot, then write**: ``save`` copies every leaf to host memory
  before it returns — from the card by ``.cpu()``, on the CPU by a clone,
  because the port's optimizers update their tensors in place — and the
  file write may run on a background thread.
* **keep**: after each write only the ``keep`` newest steps remain.

Leaf names come from :func:`repro_torch.models.spec.named_leaves` (sorted
keys, and a tuple entry's index, joined by ``/``: ``layers/wq/w``,
``m/embed``, ``layers/2/wq/w``), the naming rule of the reference's
``_flatten_with_names``.  numpy has no
bfloat16, so a bf16 leaf is refused: training state is float32, and a
packed weight tree holds int8 codes and int32 betas.
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import re
import shutil
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.spec import named_leaves, unflatten


def _snapshot(tree) -> Dict[str, np.ndarray]:
    """Host copies of every leaf, by name; later in-place updates of the
    tensors do not reach them."""
    out = {}
    for name, x in named_leaves(tree):
        x = torch.as_tensor(x).detach()
        if x.dtype == torch.bfloat16:
            raise TypeError(f"leaf {name}: numpy has no bfloat16; checkpoint "
                            "float32 state or an int8-packed tree")
        x = x.cpu() if x.device.type != "cpu" else x.clone()
        out[name] = x.numpy()
    return out


class CheckpointManager:
    """Saves and restores dicts of trees, e.g. ``{"params": ...,
    "opt_state": ...}``.  ``timings`` records each save and restore
    (seconds and bytes), for callers that report checkpoint speed."""

    def __init__(self, directory: str, *, keep: int = 3, async_write: bool = True):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pool = (concurrent.futures.ThreadPoolExecutor(max_workers=1)
                      if async_write else None)
        self._pending: Optional[concurrent.futures.Future] = None
        self.timings: List[Dict[str, Any]] = []

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state: Dict[str, Any], *, blocking: bool = False):
        """Snapshot ``state`` to host memory, then write it as step ``step``
        (on the background thread unless ``blocking`` or synchronous)."""
        t0 = time.perf_counter()
        snap = {group: _snapshot(tree) for group, tree in state.items()}
        snapshot_s = time.perf_counter() - t0
        self.wait()
        if self._pool is None or blocking:
            self._write(step, snap, snapshot_s)
        else:
            self._pending = self._pool.submit(self._write, step, snap, snapshot_s)

    def wait(self):
        """Block until the pending background write (if any) is on disk."""
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _write(self, step: int, snap, snapshot_s: float = 0.0):
        t0 = time.perf_counter()
        tmp = os.path.join(self.directory, f"tmp.{step}")
        final = os.path.join(self.directory, f"step_{step:010d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "groups": {}}
        nbytes = 0
        for group, arrs in snap.items():
            np.savez(os.path.join(tmp, f"{group}.npz"), **arrs)
            nbytes += sum(a.nbytes for a in arrs.values())
            manifest["groups"][group] = {"names": sorted(arrs), "treedef": None}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        self.timings.append(dict(op="save", step=step, bytes=nbytes, snapshot_s=snapshot_s,
                                 write_s=time.perf_counter() - t0))

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"))

    # -- restore -------------------------------------------------------------

    def all_steps(self):
        out = []
        for d in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", d)
            if m and os.path.exists(os.path.join(self.directory, d, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template: Dict[str, Any], *, device=None):
        """Restore step ``step`` into the structure of ``template`` (a dict of
        trees of tensors).  Every leaf must match its template leaf's shape
        and dtype, and lands contiguous on ``device`` (default: the template
        leaf's device).  Leaves in the file that the template lacks are
        ignored, as the reference ignores them."""
        t0 = time.perf_counter()
        d = os.path.join(self.directory, f"step_{step:010d}")
        out, nbytes = {}, 0
        for group, tree in template.items():
            restored = []
            with np.load(os.path.join(d, f"{group}.npz")) as z:
                for name, like in named_leaves(tree):
                    if name not in z:
                        raise KeyError(f"checkpoint {d} missing leaf {group}/{name}")
                    x = torch.from_numpy(z[name])
                    if tuple(x.shape) != tuple(like.shape) or x.dtype != like.dtype:
                        raise ValueError(
                            f"checkpoint {d} leaf {group}/{name} is {x.dtype} "
                            f"{tuple(x.shape)}, the template's {like.dtype} "
                            f"{tuple(like.shape)}")
                    nbytes += x.numel() * x.element_size()
                    restored.append((name, x.to(like.device if device is None else device)))
            out[group] = unflatten(restored)
        self.timings.append(dict(op="restore", step=step, bytes=nbytes,
                                 seconds=time.perf_counter() - t0))
        return out

    def restore_latest(self, template, *, device=None):
        """``(step, state)`` of the newest complete checkpoint, or
        ``(None, None)`` when there is none."""
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, template, device=device)
