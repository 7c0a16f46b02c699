"""Checkpoint retention and degrade-to-previous.

Port of ``paddle_tpu/distributed/checkpoint/manager.py``.
``CheckpointManager`` owns a directory of per-step checkpoints
(``step_00000042/``), each written atomically by ``save_state_dict``
(manifest last: the commit record).  A restore walks newest to oldest,
verifies each candidate and degrades past a corrupt one to its
predecessor, so a torn or bit-rotted save costs replayed steps, never the
job.  ``restore_latest(dst_mesh, dst_specs)`` lays the restored state out
on a destination mesh through the reshard planner (reshard-on-load: each
rank reads only the byte ranges of its destination blocks).
"""

from __future__ import annotations

import logging
import os
import re
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

from .load_state_dict import (CheckpointCorruptError, read_manifest,
                              restore_arrays, restore_to_mesh)
from .save_state_dict import save_state_dict, wait_save

logger = logging.getLogger(__name__)

_STEP_RE = re.compile(r"^step_(\d{8})$")


def _rank0() -> bool:
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


class CheckpointManager:
    """Per-step checkpoint directories with retention and verified
    restore.  ``store``: the ``torch.distributed`` store that async saves
    over several ranks meet on."""

    def __init__(self, root: str, keep: int = 2, store=None):
        if keep < 1:
            raise ValueError("keep must be >= 1")
        self.root = os.path.abspath(root)
        self.keep = keep
        self.store = store
        os.makedirs(self.root, exist_ok=True)
        self.timings: Dict[int, Dict[str, float]] = {}
        self.last_restore_moved_bytes = 0   # the last restore plan's
        self.last_restore_s = 0.0           # the last restore's seconds

    def step_path(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def complete_steps(self) -> List[int]:
        """Steps with a committed (manifest-bearing) checkpoint, ascending;
        a directory without a readable manifest is a torn write."""
        out = []
        for name in os.listdir(self.root):
            m = _STEP_RE.match(name)
            if not m:
                continue
            try:
                if read_manifest(os.path.join(self.root, name)) is not None:
                    out.append(int(m.group(1)))
            except CheckpointCorruptError:
                continue
        return sorted(out)

    def latest_complete(self) -> Optional[int]:
        steps = self.complete_steps()
        return steps[-1] if steps else None

    def save(self, state: Dict[str, Any], step: int,
             async_save: bool = False) -> str:
        """Checkpoint ``state`` as ``step``; prunes past the retention
        window but always keeps ``keep`` complete checkpoints (the degrade
        target must outlive its successor's save)."""
        path = self.step_path(step)
        timings = self.timings.setdefault(step, {})
        save_state_dict(state, path, async_save=async_save, store=self.store,
                        timings=timings)
        if not async_save:
            self.prune()
        return path

    def prune(self) -> None:
        if not _rank0():
            return
        steps = self.complete_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self.step_path(s), ignore_errors=True)
        # torn directories of preempted writers are dead weight
        for name in os.listdir(self.root):
            m = _STEP_RE.match(name)
            if m and int(m.group(1)) not in steps \
                    and int(m.group(1)) < (steps[-1] if steps else 0):
                shutil.rmtree(os.path.join(self.root, name),
                              ignore_errors=True)

    def drain(self) -> None:
        """Join any in-flight async save (the drain stage of a recovery),
        then prune."""
        wait_save()
        self.prune()

    _UNSET = object()   # "caller said nothing" != None (None = unbounded)

    def restore_latest(self, dst_mesh=None, dst_specs=None, *,
                       max_transient_bytes=_UNSET, verify: bool = True,
                       rank: Optional[int] = None
                       ) -> Tuple[Optional[Dict[str, Any]], int, List[int]]:
        """(state, step, degraded): the newest checkpoint that restores and
        verifies, laid out on ``dst_mesh``/``dst_specs`` when given (host
        values otherwise).  ``max_transient_bytes``: omitted, the
        planner's default cap; an int, that cap; None, unbounded.
        ``degraded`` lists the corrupt steps skipped on the way down;
        (None, 0, degraded) when nothing restorable remains.  ``rank``:
        this process's rank on ``dst_mesh`` when the mesh is not live
        yet."""
        t0 = time.perf_counter()
        degraded: List[int] = []
        kw = {} if max_transient_bytes is self._UNSET \
            else {"max_transient_bytes": max_transient_bytes}
        for step in reversed(self.complete_steps()):
            path = self.step_path(step)
            values, err = None, None
            try:
                if dst_mesh is None:
                    values = restore_arrays(path, verify=verify)
                else:
                    values, plan = restore_to_mesh(
                        path, dst_mesh, dst_specs, verify=verify, rank=rank,
                        **kw)
                    self.last_restore_moved_bytes = plan.moved_bytes
            except CheckpointCorruptError as e:
                err = e
            # every rank verified the blocks it read: degrade together
            if not _all_ranks_ok(err is None):
                logger.warning(
                    "[checkpoint] step %d is corrupt (%s); degrading to "
                    "the previous complete checkpoint", step,
                    err or "on another rank")
                degraded.append(step)
                continue
            self.last_restore_s = time.perf_counter() - t0
            return values, step, degraded
        return None, 0, degraded


def _all_ranks_ok(ok: bool) -> bool:
    """``ok`` on every rank of the live group (a MIN all-reduce)."""
    import torch
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return ok
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    flag = torch.tensor([1 if ok else 0], dtype=torch.int32, device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item())
