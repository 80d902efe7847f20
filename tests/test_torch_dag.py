"""The port's lazy DAGs (``ray_tpu_torch.dag``, ``.bind()`` on remote
functions, actor classes and actor methods) against the reference's: the
interpreted cases of tests/test_dag.py (:84, :98, :120) on both packages,
then more of the node kinds. The reference's compiled graphs are not
ported (ROADMAP.md, Queue 1 item 11): the port's ``experimental_compile()``
raises ``NotImplementedError`` where tests/test_dag.py:293 expects the
reference's refusal of function nodes.

Each case runs on the reference, then on the port, each in a runtime of its
own (tests/_torch_train_parity.py); the observations must be equal.
"""

import importlib

import pytest

import ray_tpu
import ray_tpu_torch
from _torch_runtimes import fresh_init
from _torch_train_parity import assert_same, both, raises

INIT = {"num_cpus": 8}


def _dag(pkg):
    return importlib.import_module(pkg.__name__ + ".dag")


def _parity(case):
    ref, port = both(case, init=INIT)
    assert_same(ref, port, atol=0)
    return port


# ---------------------------------------------------- tests/test_dag.py:84
def _function_dag(pkg):
    @pkg.remote
    def add(a, b):
        return a + b

    @pkg.remote
    def mul(a, b):
        return a * b

    with _dag(pkg).InputNode() as inp:
        dag = mul.bind(add.bind(inp, 1), 10)
    return pkg.get(dag.execute(4))


def test_function_dag_interpreted():
    assert _parity(_function_dag) == 50


# ---------------------------------------------------- tests/test_dag.py:98
def _diamond(pkg):
    calls = []

    @pkg.remote
    class Counter:
        def bump(self, x):
            calls.append(x)
            return x + 1

    c = Counter.remote()
    with _dag(pkg).InputNode() as inp:
        mid = c.bump.bind(inp)

        @pkg.remote
        def pair(a, b):
            return (a, b)

        dag = pair.bind(mid, mid)
    return pkg.get(dag.execute(1)), len(calls)


def test_diamond_dedup():
    assert _parity(_diamond) == [[2, 2], 1]  # diamond evaluated once


# --------------------------------------------------- tests/test_dag.py:120
def _class_node(pkg):
    made = []

    @pkg.remote
    class Adder:
        def __init__(self, base):
            made.append(base)
            self.base = base

        def add(self, x):
            return self.base + x

    node = Adder.bind(100)
    with _dag(pkg).InputNode() as inp:
        dag = node.add.bind(inp)
    return pkg.get(dag.execute(5)), pkg.get(dag.execute(7)), made


def test_class_node_lazy_actor():
    # the same actor reused: one constructor call
    assert _parity(_class_node) == [105, 107, [100]]


# ----------------------------------------------------- the other node kinds
def _inputs_and_outputs(pkg):
    dag_mod = _dag(pkg)

    @pkg.remote
    def sub(a, b):
        return a - b

    @pkg.remote
    def scale(x, k=1):
        return x * k

    @pkg.remote
    def ident(x):
        return x

    with dag_mod.InputNode() as inp:
        pos = sub.bind(inp[0], inp[1])
    with dag_mod.InputNode() as inp:
        kw = scale.bind(inp.x, k=inp.k)
    with dag_mod.InputNode() as inp:
        a = scale.bind(inp, k=2)
        many = dag_mod.MultiOutputNode([a, sub.bind(a, 1), 7])
    with dag_mod.InputNode() as inp:
        whole = ident.bind(inp)
    refs = many.execute(3)
    return {
        "positional": pkg.get(pos.execute(10, 4)),
        "keyword": pkg.get(kw.execute(x=3, k=5)),
        "multi": [pkg.get(refs[0]), pkg.get(refs[1]), refs[2]],
        "whole_kwargs": sorted(pkg.get(whole.execute(p=1, q=2)).items()),
        "whole_tuple": list(pkg.get(whole.execute(1, 2))),
        "private_attr": raises(lambda: inp._hidden),
        "node_types": [type(n).__name__ for n in many._topo()],
    }


def test_input_attributes_and_multi_output():
    obs = _parity(_inputs_and_outputs)
    assert obs["positional"] == 6 and obs["keyword"] == 15
    assert obs["multi"] == [6, 5, 7]


def _actor_nodes(pkg):
    dag_mod = _dag(pkg)

    @pkg.remote
    class Acc:
        def __init__(self, start):
            self.total = start

        def add(self, x):
            self.total += x
            return self.total

    live = Acc.remote(0)
    with dag_mod.InputNode() as inp:
        on_live = live.add.bind(inp)  # ActorMethodNode on a handle
    lazy = Acc.bind(1000)
    with dag_mod.InputNode() as inp:
        chained = lazy.add.bind(live.add.bind(inp))
    first = pkg.get(on_live.execute(5))
    second = pkg.get(chained.execute(2))
    return {
        "first": first, "second": second,
        "live_total": pkg.get(live.add.remote(0)),
        "lazy_total": pkg.get(lazy._get_or_create_handle().add.remote(0)),
        "types": [type(on_live).__name__, type(lazy).__name__,
                  type(lazy.add).__name__],
        "lazy_private": raises(lambda: lazy._nope),
    }


def test_actor_method_and_class_nodes():
    obs = _parity(_actor_nodes)
    assert obs["first"] == 5 and obs["second"] == 1007
    assert obs["types"] == ["ClassMethodNode", "ClassNode", "_UnboundMethod"]


# --------------------------------------------------- tests/test_dag.py:293
def test_experimental_compile_is_not_ported():
    """The reference compiles actor-method DAGs onto channels and refuses
    function nodes (tests/test_dag.py:293); the port has no compiled graphs
    yet and says so for every DAG."""
    fresh_init(ray_tpu_torch, **INIT)
    try:
        dag_mod = _dag(ray_tpu_torch)

        @ray_tpu_torch.remote
        def f(x):
            return x

        @ray_tpu_torch.remote
        class A:
            def m(self, x):
                return x

        with dag_mod.InputNode() as inp:
            fn_dag = f.bind(inp)
        with dag_mod.InputNode() as inp:
            actor_dag = A.bind().m.bind(inp)
        for node in (fn_dag, actor_dag):
            with pytest.raises(NotImplementedError, match="item 11"):
                node.experimental_compile()
        assert ray_tpu_torch.get(actor_dag.execute(3)) == 3
    finally:
        ray_tpu_torch.shutdown()
    fresh_init(ray_tpu, **INIT)
    try:
        @ray_tpu.remote
        def g(x):
            return x

        with ray_tpu.dag.InputNode() as inp:
            dag = g.bind(inp)
        with pytest.raises(ValueError, match="actor method"):
            dag.experimental_compile()
    finally:
        ray_tpu.shutdown()
