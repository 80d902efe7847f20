"""ray_tpu_torch.dag — lazy DAGs and compiled graphs (the counterpart of
``ray_tpu/dag/``; ref: python/ray/dag/).

Build with ``.bind()``, run interpreted with ``.execute()``, or lower onto
fixed actors with typed channels via ``.experimental_compile()`` (ref:
dag/compiled_dag_node.py, experimental/channel/): ``Channel`` edges between
thread actors, ``DeviceChannel`` edges that carry ``torch.Tensor``s to a
device, ``SharedMemoryChannel`` edges over the shared-memory arena wherever
a process actor is at either end, and ``allreduce`` collective nodes. The
reference's edges between worker nodes (``NodeLocalChannel``,
``RemoteChannel``) need real nodes (ROADMAP.md, Queue 1 item 13.8b).
"""

from ray_tpu_torch.dag.channel import (
    Channel,
    ChannelClosed,
    ChannelTimeout,
    DeviceChannel,
    IntraProcessChannel,
    SharedMemoryChannel,
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
    "Channel", "IntraProcessChannel", "DeviceChannel", "SharedMemoryChannel",
    "ChannelClosed", "ChannelTimeout",
]
