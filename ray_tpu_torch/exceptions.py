"""Public exception types of the port's runtime (the counterpart of
``ray_tpu/exceptions.py``; ref: python/ray/exceptions.py)."""

from __future__ import annotations

import traceback
from typing import Optional


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A task raised an exception during execution; re-raised at `get`.

    Carries the remote traceback string (ref: RayTaskError) so the user
    sees where the task failed.
    """

    def __init__(self, cause: BaseException, task_repr: str = "", tb: str = ""):
        self.cause = cause
        self.task_repr = task_repr
        self.remote_traceback = tb or "".join(
            traceback.format_exception(type(cause), cause, cause.__traceback__)
        )
        super().__init__(f"{task_repr} failed: {cause!r}\nRemote traceback:\n{self.remote_traceback}")

    def __reduce__(self):
        # Rebuild from the fields, not from the formatted message.
        return (TaskError, (self.cause, self.task_repr, self.remote_traceback))


class WorkerCrashedError(RayTpuError):
    """The worker executing the task died unexpectedly."""


class ActorError(RayTpuError):
    pass


class ActorDiedError(ActorError):
    """The actor is dead: creation failed, it was killed, or it crashed past
    its restart budget (ref: ActorDiedError / gcs_actor_manager.h FSM)."""

    def __init__(self, msg: str = "The actor died", cause: Optional[BaseException] = None):
        self.cause = cause
        super().__init__(msg)


class ActorUnavailableError(ActorError):
    """The actor is temporarily unreachable (restarting)."""


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class ObjectLostError(RayTpuError):
    """Object value unrecoverable and lineage reconstruction failed."""


class ObjectFreedError(ObjectLostError):
    pass


class TaskCancelledError(RayTpuError):
    def __init__(self, task_id: str = ""):
        super().__init__(f"Task {task_id} was cancelled")
