"""Search-space primitives (ref: python/ray/tune/search/sample.py —
Domain/Float/Integer/Categorical; grid_search in tune/search/variant_generator.py).

A param_space is a (possibly nested) dict whose leaves may be Domains or
``grid_search(...)`` markers.  Grid leaves are expanded as a cross product;
Domain leaves are sampled per trial.

The counterpart of ``ray_tpu/tune/search_space.py``.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Sequence


class Domain:
    """Base class for samplable hyperparameter domains."""

    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Float(Domain):
    def __init__(self, lower: float, upper: float, log: bool = False, q: float = None):
        if log and lower <= 0:
            raise ValueError("loguniform requires lower > 0")
        self.lower, self.upper, self.log, self.q = lower, upper, log, q

    def sample(self, rng: random.Random) -> float:
        if self.log:
            import math

            v = math.exp(rng.uniform(math.log(self.lower), math.log(self.upper)))
        else:
            v = rng.uniform(self.lower, self.upper)
        if self.q:
            v = round(v / self.q) * self.q
        return min(max(v, self.lower), self.upper)


class Integer(Domain):
    def __init__(self, lower: int, upper: int, log: bool = False, q: int = 1):
        self.lower, self.upper, self.log, self.q = lower, upper, log, q

    def sample(self, rng: random.Random) -> int:
        # Upper bound is EXCLUSIVE on both paths (ref: tune randint/lograndint
        # contract), so e.g. lograndint(0, len(xs)) is a safe index.
        hi = self.upper - 1 if self.upper > self.lower else self.lower
        if self.log:
            import math

            v = int(round(math.exp(rng.uniform(math.log(max(self.lower, 1)),
                                               math.log(max(hi, 1))))))
        else:
            v = rng.randint(self.lower, hi)
        if self.q > 1:
            v = int(round(v / self.q) * self.q)
        return min(max(v, self.lower), hi)


class Categorical(Domain):
    def __init__(self, categories: Sequence[Any]):
        self.categories = list(categories)

    def sample(self, rng: random.Random) -> Any:
        return rng.choice(self.categories)


class Normal(Domain):
    def __init__(self, mean: float, sd: float):
        self.mean, self.sd = mean, sd

    def sample(self, rng: random.Random) -> float:
        return rng.gauss(self.mean, self.sd)


class Function(Domain):
    def __init__(self, fn: Callable[[], Any]):
        self.fn = fn

    def sample(self, rng: random.Random) -> Any:
        return self.fn()


# -------------------- public constructors (ref: tune.uniform & co) ----------

def uniform(lower: float, upper: float) -> Float:
    return Float(lower, upper)


def quniform(lower: float, upper: float, q: float) -> Float:
    return Float(lower, upper, q=q)


def loguniform(lower: float, upper: float) -> Float:
    return Float(lower, upper, log=True)


def qloguniform(lower: float, upper: float, q: float) -> Float:
    return Float(lower, upper, log=True, q=q)


def randn(mean: float = 0.0, sd: float = 1.0) -> Normal:
    return Normal(mean, sd)


def randint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper)


def qrandint(lower: int, upper: int, q: int) -> Integer:
    return Integer(lower, upper, q=q)


def lograndint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper, log=True)


def choice(categories: Sequence[Any]) -> Categorical:
    return Categorical(categories)


def sample_from(fn: Callable[[], Any]) -> Function:
    return Function(fn)


def grid_search(values: Sequence[Any]) -> Dict[str, List[Any]]:
    """(ref: tune/search/variant_generator.py grid_search)"""
    return {"grid_search": list(values)}


# -------------------- expansion helpers -------------------------------------

def _is_grid(v: Any) -> bool:
    return isinstance(v, dict) and set(v.keys()) == {"grid_search"}


def expand_grid(space: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Cross-product of every grid_search leaf; Domains left in place."""
    variants: List[Dict[str, Any]] = [{}]
    for key, value in space.items():
        if _is_grid(value):
            variants = [dict(v, **{key: g}) for v in variants for g in value["grid_search"]]
        elif isinstance(value, dict) and not _is_grid(value):
            subs = expand_grid(value)
            variants = [dict(v, **{key: s}) for v in variants for s in subs]
        else:
            variants = [dict(v, **{key: value}) for v in variants]
    return variants


def resolve(space: Dict[str, Any], rng: random.Random) -> Dict[str, Any]:
    """Sample every Domain leaf, returning a concrete config."""
    out: Dict[str, Any] = {}
    for key, value in space.items():
        if isinstance(value, Domain):
            out[key] = value.sample(rng)
        elif isinstance(value, dict) and not _is_grid(value):
            out[key] = resolve(value, rng)
        else:
            out[key] = value
    return out
