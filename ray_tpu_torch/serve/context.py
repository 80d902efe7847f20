"""Per-replica / per-request context (the counterpart of
``ray_tpu/serve/context.py``; ref: python/ray/serve/context.py —
_get_internal_replica_context, serve.get_multiplexed_model_id).

Uses contextvars (not thread-locals): replica request handlers are asyncio
tasks interleaving on one loop thread, and the request-scoped model id must
not leak across concurrently-awaiting requests.
"""

from __future__ import annotations

import contextvars
from dataclasses import dataclass
from typing import Optional

_replica_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "serve_replica_ctx", default=None)
_model_id: contextvars.ContextVar = contextvars.ContextVar(
    "serve_multiplexed_model_id", default="")


@dataclass
class ReplicaContext:
    deployment: str
    replica_id: str
    #: the hosting ReplicaActor; not part of the public surface
    _replica: Optional[object] = None


def _set_internal_replica_context(deployment: str, replica_id: str,
                                  replica: Optional[object] = None) -> None:
    _replica_ctx.set(ReplicaContext(deployment, replica_id, replica))


def get_internal_replica_context() -> Optional[ReplicaContext]:
    return _replica_ctx.get()


def _set_request_model_id(model_id: str) -> None:
    _model_id.set(model_id)


def get_multiplexed_model_id() -> str:
    """(ref: serve/api.py get_multiplexed_model_id)"""
    return _model_id.get()
