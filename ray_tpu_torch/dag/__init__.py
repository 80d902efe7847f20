"""ray_tpu_torch.dag — lazy DAGs and compiled graphs (the counterpart of
``ray_tpu/dag/``; ref: python/ray/dag/).

Build with ``.bind()``, run interpreted with ``.execute()``, or lower onto
fixed thread actors with typed channels via ``.experimental_compile()``
(ref: dag/compiled_dag_node.py, experimental/channel/): ``Channel`` edges,
``DeviceChannel`` edges that carry ``torch.Tensor``s to a device, and
``allreduce`` collective nodes.  Edges to or from process actors need the
reference's ``SharedMemoryChannel``, which is not ported yet (ROADMAP.md,
Queue 1 item 11b-2): compiling such a DAG raises.
"""

from ray_tpu_torch.dag.channel import (
    Channel,
    ChannelClosed,
    ChannelTimeout,
    DeviceChannel,
    IntraProcessChannel,
)
from ray_tpu_torch.dag.collective_node import allreduce
from ray_tpu_torch.dag.compiled_dag import CompiledDAG, CompiledDAGRef
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
    "CompiledDAG", "CompiledDAGRef", "allreduce",
    "Channel", "IntraProcessChannel", "DeviceChannel",
    "ChannelClosed", "ChannelTimeout",
]
