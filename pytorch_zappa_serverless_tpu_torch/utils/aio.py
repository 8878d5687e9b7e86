"""asyncio helpers shared by the serving planes."""

from __future__ import annotations

import asyncio


async def cancel_and_wait(task: asyncio.Task | None) -> None:
    """Cancel ``task`` and wait for it to end.

    The task's own ``CancelledError`` is expected and swallowed.  A
    cancellation of the caller while it waits is not: it propagates, so a
    stop awaited inside a task that is itself being cancelled (a reaper
    stopped in the middle of a demotion that stops a model's lanes) never
    keeps that task running."""
    if task is None:
        return
    task.cancel()
    try:
        await task
    except asyncio.CancelledError:
        current = asyncio.current_task()
        if current is not None and current.cancelling():
            raise
