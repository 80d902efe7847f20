"""ray_tpu_torch.dag — lazy DAGs (the counterpart of ``ray_tpu/dag/``; ref:
python/ray/dag/).

Build with ``.bind()`` and run interpreted with ``.execute()``. The
reference's compiled graphs (``.experimental_compile()``, its channels and
``allreduce`` collective nodes) are not ported yet (ROADMAP.md, Queue 1
item 11): ``experimental_compile()`` raises ``NotImplementedError``.
"""

from ray_tpu_torch.dag.dag_node import (
    ActorMethodNode,
    ClassMethodNode,
    ClassNode,
    DAGNode,
    FunctionNode,
    InputAttributeNode,
    InputNode,
    MultiOutputNode,
)

__all__ = [
    "DAGNode", "InputNode", "InputAttributeNode", "FunctionNode", "ClassNode",
    "ClassMethodNode", "ActorMethodNode", "MultiOutputNode",
]
