"""MultiRLModule — a container of per-policy RLModules.

The port of ``ray_tpu/rl/core/multi_rl_module.py`` (ref:
rllib/core/rl_module/multi_rl_module.py MultiRLModule — maps module ids to
RLModules; MultiRLModuleSpec builds the container so env runners and
learners construct identical per-policy networks). Here the container is an
``nn.ModuleDict``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from torch import nn

from ray_tpu_torch._private.device import DeviceLike
from ray_tpu_torch.rl.core.rl_module import RLModuleSpec


@dataclass(frozen=True)
class MultiRLModuleSpec:
    module_specs: Dict[str, RLModuleSpec] = field(default_factory=dict)

    def build(self, seed: int = 0, device: DeviceLike = None) -> "MultiRLModule":
        """Each module from its own seed (``seed`` + its index in sorted id
        order), on ``device``."""
        return MultiRLModule(
            {mid: spec.build(seed=seed + i, device=device)
             for i, (mid, spec) in enumerate(sorted(self.module_specs.items()))})


class MultiRLModule(nn.ModuleDict):
    """module_id → RLModule; its state dict nests each module's under its
    id (``{id}.pi.layers.0.w``)."""
