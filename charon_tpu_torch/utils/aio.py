"""Asyncio helpers of the duty pipeline: the port's copy of
charon_tpu/utils/aio.py.

The event loop holds only weak references to tasks, so a fire-and-forget
`asyncio.create_task` result that nobody retains can be garbage-collected
mid-flight, silently dropping the work. `spawn` keeps a strong reference
until the task completes, mirroring how the reference's goroutines are
rooted until they return.
"""

from __future__ import annotations

import asyncio
from typing import Coroutine

from . import log

_log = log.with_topic("aio")

_tasks: set[asyncio.Task] = set()
_quiet_tasks: set[asyncio.Task] = set()


def spawn(coro: Coroutine, name: str | None = None,
          quiet: bool = False) -> asyncio.Task:
    """Run `coro` as a background task with a strong reference held until it
    finishes. Exceptions are logged, never silently dropped. `quiet=True`
    skips the error log for callers that retrieve and handle the task's
    exception themselves (e.g. a first-success-wins race over task results)
    while keeping the retention guarantee."""
    task = asyncio.get_running_loop().create_task(coro, name=name)
    _tasks.add(task)
    if quiet:
        _quiet_tasks.add(task)
    task.add_done_callback(_reap)
    return task


def _reap(task: asyncio.Task) -> None:
    _tasks.discard(task)
    quiet = task in _quiet_tasks
    _quiet_tasks.discard(task)
    if task.cancelled():
        return
    exc = task.exception()
    if exc is not None and not quiet:
        _log.error("background task failed", task=task.get_name(), err=exc)


def pending_count() -> int:
    return len(_tasks)
