"""Aggregation specs (the counterpart of ``ray_tpu/data/aggregate.py``;
ref: python/ray/data/aggregate.py — AggregateFn and the named aggregations
Count/Sum/Min/Max/Mean/Std/Quantile/Unique used by ``Dataset.aggregate``
and ``GroupedData.aggregate``).

Each spec is declarative: a column + a function name the executor lowers
to numpy reductions, over the combined block (global aggregates) or per
group (grouped path).
"""

from __future__ import annotations

from typing import Optional


class AggregateFn:
    """Base spec: subclass instances name a (column, function) pair."""

    fn_name: str = ""

    def __init__(self, on: Optional[str] = None, alias_name: Optional[str] = None):
        self.on = on
        self.alias_name = alias_name

    @property
    def output_name(self) -> str:
        if self.alias_name:
            return self.alias_name
        if self.on is None:
            return f"{self.fn_name}()"
        return f"{self.fn_name}({self.on})"

    def __repr__(self) -> str:
        return f"{type(self).__name__}(on={self.on!r})"


class Count(AggregateFn):
    fn_name = "count"


class Sum(AggregateFn):
    fn_name = "sum"


class Min(AggregateFn):
    fn_name = "min"


class Max(AggregateFn):
    fn_name = "max"


class Mean(AggregateFn):
    fn_name = "mean"


class Std(AggregateFn):
    """Sample standard deviation, ddof=1 by default (ref: aggregate.py Std)."""

    fn_name = "std"

    def __init__(self, on: Optional[str] = None, ddof: int = 1,
                 alias_name: Optional[str] = None):
        super().__init__(on, alias_name)
        self.ddof = ddof


class Quantile(AggregateFn):
    """Exact quantile over the combined column (global aggregates only —
    the grouped path has no exact streaming quantile kernel, matching the
    reference's sort-based implementation cost)."""

    fn_name = "quantile"

    def __init__(self, on: Optional[str] = None, q: float = 0.5,
                 alias_name: Optional[str] = None):
        super().__init__(on, alias_name)
        self.q = q


class Unique(AggregateFn):
    fn_name = "unique"
