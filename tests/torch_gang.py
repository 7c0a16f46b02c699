"""The gloo gangs of the port's multi-rank CPU tests.

``run_gang`` spawns ``world`` CPU processes once per test run with
``torch.multiprocessing`` and waits for them: rank r runs ``target(r,
world, root, *args)``, rendezvousing through a ``FileStore`` under
``root`` and writing its results there.  Under xdist every worker that
needs the gang takes a lock file keyed by the run: the first runs it, the
others read its results (or its failure).
"""

from __future__ import annotations

import fcntl
import json
import os
import time
import traceback

import torch


def run_gang(name, target, world, tmp_path_factory, args=(), prepare=None):
    """Run the gang ``name`` (``prepare(root)`` first, in this process) and
    return its results directory."""
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    base = tmp_path_factory.getbasetemp()
    root = (base.parent / f"{name}-{uid}") if uid else (base / name)
    root.mkdir(parents=True, exist_ok=True)
    with open(root / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (root / "failed").exists():
            raise RuntimeError("the gang failed in another worker:\n"
                               + (root / "failed").read_text())
        if not (root / "done").exists():
            try:
                if prepare is not None:
                    prepare(root)
                t0 = time.time()
                torch.multiprocessing.spawn(
                    target, args=(world, str(root)) + tuple(args),
                    nprocs=world, join=True)
                (root / "done").write_text(json.dumps(
                    {"seconds": time.time() - t0}))
            except BaseException:
                (root / "failed").write_text(traceback.format_exc())
                raise
    return root


def file_store(root, world):
    """The gang's rendezvous store."""
    import torch.distributed as dist

    return dist.FileStore(os.path.join(root, "store"), world)
