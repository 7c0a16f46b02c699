"""Rendezvous helpers over ``torch.distributed`` stores.

The part of ``paddle_tpu/distributed/store.py`` that the resilient train
loop takes: the one backoff formula (``jittered_backoff``), the store
timeout override (``resolve_store_timeout``) and the named barrier that
``resilience.StoreRendezvous`` gates a recovery generation on.  The JAX
module builds them on its own C++ TCPStore; the port builds them on a
``torch.distributed`` ``TCPStore`` or ``FileStore`` (that store is also
the one ``init_process_group`` takes), so nothing here compiles.
"""

from __future__ import annotations

import datetime
import os
import random
from typing import Optional

# retry shaping for the connect/barrier paths: bounded exponential backoff
# with jitter, so a whole gang retrying does not reconnect in lockstep
_BACKOFF_BASE_S = 0.05
_BACKOFF_MAX_S = 2.0
_BACKOFF_JITTER = 0.25


def resolve_store_timeout(default: float) -> float:
    """The effective rendezvous/barrier timeout: the
    ``FLAGS_store_barrier_timeout_s`` environment variable when it is set
    above 0, else the caller's default."""
    raw = os.environ.get("FLAGS_store_barrier_timeout_s", "")
    try:
        override = float(raw) if raw else 0.0
    except ValueError:
        override = 0.0
    return override if override > 0 else float(default)


def jittered_backoff(attempt: int, *, base: float = _BACKOFF_BASE_S,
                     max_s: float = _BACKOFF_MAX_S,
                     jitter: float = _BACKOFF_JITTER,
                     rand=None) -> float:
    """The backoff formula: ``min(base * 2**attempt, max_s)``, then
    scaled by 1 +- ``jitter`` (uniform from ``rand``)."""
    raw = min(base * (2.0 ** attempt), max_s)
    if jitter:
        raw *= 1.0 + jitter * (2.0 * (rand or random.random)() - 1.0)
    return max(0.0, raw)


def store_barrier(store, name: str, world_size: int,
                  timeout: float = 30.0) -> None:
    """Block until ``world_size`` members reached the barrier ``name`` on
    ``store`` (a ``torch.distributed.Store``).  Each name is one use: the
    members add 1 to ``<name>/count``, the last one sets ``<name>/done``,
    every member waits for it.  Raises ``TimeoutError`` when the gang does
    not assemble within ``timeout`` seconds (``resolve_store_timeout``
    applies)."""
    timeout = resolve_store_timeout(timeout)
    arrived = store.add(f"{name}/count", 1)
    if arrived >= world_size:
        store.set(f"{name}/done", b"1")
    try:
        store.wait([f"{name}/done"], datetime.timedelta(seconds=timeout))
    except Exception as e:  # the store's own timeout error type varies
        raise TimeoutError(f"barrier {name!r}: {arrived} of {world_size} "
                           f"members arrived within {timeout}s ({e})") from e


def store_get(store, key: str, timeout: float) -> Optional[bytes]:
    """``store.get(key)`` once ``key`` is set, or None when it is not set
    within ``timeout`` seconds."""
    try:
        store.wait([key], datetime.timedelta(seconds=timeout))
    except Exception:
        return None
    return store.get(key)
