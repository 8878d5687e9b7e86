"""``utils/aio.cancel_and_wait``: a stop awaited inside a task that is
itself being cancelled must not keep that task running.

The lifecycle's reaper stops a model's lanes in the middle of a demotion
(``batcher.stop``, the generation lane's ``stop``); when the reaper itself
is cancelled then (``LifecycleManager.stop``), a stop that swallowed every
``CancelledError`` ate the reaper's own cancellation, the reaper ran on,
and ``LifecycleManager.stop`` waited for it forever."""

import asyncio

import pytest

from pytorch_zappa_serverless_tpu_torch.serving.batcher import DynamicBatcher
from pytorch_zappa_serverless_tpu_torch.serving.generation import (GenerationScheduler,
                                                                   PagedGenerationScheduler)
from pytorch_zappa_serverless_tpu_torch.serving.lifecycle import LifecycleManager
from pytorch_zappa_serverless_tpu_torch.utils.aio import cancel_and_wait


async def _slow_to_cancel():
    """A task whose cleanup on cancel takes a while (the window in which
    its stopper can itself be cancelled)."""
    try:
        await asyncio.sleep(60)
    finally:
        await asyncio.shield(asyncio.sleep(0.2))


def test_the_stopped_tasks_own_cancellation_is_swallowed():
    async def go():
        inner = asyncio.get_running_loop().create_task(_slow_to_cancel())
        await asyncio.sleep(0)
        await cancel_and_wait(inner)
        return inner.cancelled()

    assert asyncio.run(asyncio.wait_for(go(), 10)) is True
    assert asyncio.run(asyncio.wait_for(cancel_and_wait(None), 10)) is None


def _stopper(kind: str, inner):
    """An object of ``kind`` whose stop awaits ``inner``, built without its
    constructor (stop reads only its task and its queues)."""
    cls = {"batcher": DynamicBatcher, "lane": GenerationScheduler,
           "paged": PagedGenerationScheduler, "lifecycle": LifecycleManager}[kind]
    obj = object.__new__(cls)
    obj._task = inner
    obj._stopped = False
    obj._carry = None
    obj._queue = asyncio.Queue()
    obj._active, obj._pending = {}, []
    obj._prefilling, obj._swapped, obj._detached = [], [], []
    return obj


@pytest.mark.parametrize("kind", ["helper", "batcher", "lane", "paged", "lifecycle"])
def test_a_cancelled_stopper_ends_instead_of_running_on(kind):
    """The outer task (a reaper) is cancelled while its stop waits for the
    inner task's cleanup: it ends with CancelledError."""
    async def go():
        loop = asyncio.get_running_loop()
        inner = loop.create_task(_slow_to_cancel())
        await asyncio.sleep(0)
        stop = (cancel_and_wait(inner) if kind == "helper"
                else _stopper(kind, inner).stop())
        ran_on = []

        async def reaper():
            await stop
            ran_on.append(True)  # a swallowed cancellation lands here
            await asyncio.sleep(60)

        outer = loop.create_task(reaper())
        await asyncio.sleep(0.05)  # the stop is waiting for the cleanup
        outer.cancel()
        with pytest.raises(asyncio.CancelledError):
            await asyncio.wait_for(outer, 5)
        assert ran_on == [] and outer.cancelled()
        await asyncio.wait_for(asyncio.shield(inner), 5) if not inner.done() else None

    asyncio.run(asyncio.wait_for(go(), 20))
