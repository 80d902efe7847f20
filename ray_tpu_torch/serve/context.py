"""Per-replica context (the counterpart of ``ray_tpu/serve/context.py``;
ref: python/ray/serve/context.py — _get_internal_replica_context).

Uses contextvars (not thread-locals): replica request handlers are asyncio
tasks interleaving on one loop thread. The request-scoped multiplexed model
id comes with ``serve/multiplex.py`` (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import contextvars
from dataclasses import dataclass
from typing import Optional

_replica_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "serve_replica_ctx", default=None)


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
