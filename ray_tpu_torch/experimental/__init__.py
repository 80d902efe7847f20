"""Experimental APIs (ref: python/ray/experimental/)."""

from ray_tpu_torch.experimental import internal_kv

__all__ = ["internal_kv"]
