"""The port's durable workflows (``ray_tpu_torch.workflow``) against the
reference's: the seven cases of tests/test_workflow.py on both packages
(the crash of a driver process among them), the step ids, the on-disk
layout and the device rule; then the slice as a whole, a workflow of
tiny-GPT-2 training chunks on the port that fails, is resumed and matches
the reference's uninterrupted workflow in JAX.

Each case runs on the reference, then on the port, each in a runtime of its
own (tests/_torch_train_parity.py), with a storage root of its own; the
observations must be equal exactly. Step functions are bound from the same
Python function under each package's ``remote``, so that the step ids,
which hash the function's module, name and code, can be compared.
"""

import importlib
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from _torch_runtimes import bounded, fresh_init, gc_paused
from _torch_train_parity import assert_same, both, raises
from ray_tpu_torch.examples import train_gpt2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wf(pkg):
    return importlib.import_module(pkg.__name__ + ".workflow")


def _storage(pkg, tmp):
    wf = _wf(pkg)
    wf.init_storage(os.path.join(str(tmp), pkg.__name__))
    return wf


def _parity(case, tmp_path):
    ref, port = both(case, str(tmp_path))
    assert_same(ref, port, atol=0)
    return port


def _double(x):
    return 2 * x


def _add(a, b):
    return a + b


# ------------------------------------------------ tests/test_workflow.py:28
def _simple(pkg, tmp):
    wf = _storage(pkg, tmp)
    double, add = pkg.remote(_double), pkg.remote(_add)
    dag = add.bind(double.bind(3), double.bind(4))
    return (wf.run(dag, workflow_id="w1"), wf.get_status("w1"),
            wf.get_output("w1"))


def test_run_simple_dag(tmp_path):
    assert _parity(_simple, tmp_path) == [14, "SUCCESSFUL", 14]


# ------------------------------------------------ tests/test_workflow.py:35
def _input_node(pkg, tmp):
    wf = _storage(pkg, tmp)
    InputNode = importlib.import_module(pkg.__name__ + ".dag").InputNode
    double, add = pkg.remote(_double), pkg.remote(_add)
    with InputNode() as inp:
        dag = add.bind(double.bind(inp), 1)
    first = wf.run(dag, 10, workflow_id="w-inp")
    # Re-running the same workflow id replays checkpoints.
    return first, wf.run(dag, 10, workflow_id="w-inp")


def test_input_node(tmp_path):
    assert _parity(_input_node, tmp_path) == [21, 21]


# ------------------------------------------------ tests/test_workflow.py:45
def _replay(pkg, tmp):
    wf = _storage(pkg, tmp)
    counter = os.path.join(tmp, pkg.__name__ + "-count")

    @pkg.remote
    def expensive(x):
        n = int(open(counter).read()) if os.path.exists(counter) else 0
        open(counter, "w").write(str(n + 1))
        return x * 10

    dag = pkg.remote(_add).bind(expensive.bind(1), pkg.remote(_double).bind(2))
    out = [wf.run(dag, workflow_id="wck"), open(counter).read()]
    # Resume recomputes NOTHING: every step is checkpointed.
    return out + [wf.resume("wck"), open(counter).read()]


def test_steps_checkpoint_and_replay(tmp_path):
    assert _parity(_replay, tmp_path) == [14, "1", 14, "1"]


# ------------------------------------------------ tests/test_workflow.py:63
def _failed_then_resumed(pkg, tmp):
    wf = _storage(pkg, tmp)
    flag = os.path.join(tmp, pkg.__name__ + "-fail-once")
    counter = os.path.join(tmp, pkg.__name__ + "-count2")
    open(flag, "w").write("fail")

    @pkg.remote
    def counted(x):
        n = int(open(counter).read()) if os.path.exists(counter) else 0
        open(counter, "w").write(str(n + 1))
        return x + 100

    @pkg.remote
    def fragile(x):
        if os.path.exists(flag):
            raise RuntimeError("transient outage")
        return x * 2

    dag = fragile.bind(counted.bind(5))
    obs = [raises(lambda: wf.run(dag, workflow_id="wfail")) is not None,
           wf.get_status("wfail"), open(counter).read(),
           raises(lambda: wf.get_output("wfail"))]
    os.unlink(flag)
    return obs + [wf.resume("wfail"), open(counter).read(),
                  wf.get_status("wfail")]


def test_failed_workflow_resumes_without_recompute(tmp_path):
    assert _parity(_failed_then_resumed, tmp_path) == [
        True, "FAILED", "1", "ValueError", 210, "1", "SUCCESSFUL"]


# ------------------------------------------------ tests/test_workflow.py:94
_CRASH_SCRIPT = """
import os, sys
sys.path.insert(0, {repo!r})
import {pkg}
from {pkg} import workflow
workflow.init_storage({storage!r})
{pkg}.init(num_cpus=2)

@{pkg}.remote
def step_a():
    open(os.path.join({storage!r}, "a-ran"), "a").write("x")
    return 7

@{pkg}.remote
def kill_me(x):
    if os.environ.get("WF_CRASH"):
        os._exit(42)   # hard driver death mid-flow
    return x * 3

dag = kill_me.bind(step_a.bind())
print("RESULT", workflow.run(dag, workflow_id="wcrash"))
"""


def _crash(pkg, tmp):
    """Kill the driver between steps; a fresh process resumes from the
    checkpoints (the reference's headline durability property)."""
    storage = os.path.join(tmp, pkg.__name__ + "-wf2")
    os.makedirs(storage, exist_ok=True)
    script = _CRASH_SCRIPT.format(repo=REPO, pkg=pkg.__name__,
                                  storage=storage)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["WF_CRASH"] = "1"
    p1 = subprocess.run([sys.executable, "-c", script], env=env,
                        capture_output=True, text=True, timeout=120)
    env.pop("WF_CRASH")
    p2 = subprocess.run([sys.executable, "-c", script], env=env,
                        capture_output=True, text=True, timeout=120)
    assert p2.returncode == 0, p2.stderr[-2000:]
    # step_a ran exactly once across both processes: its checkpoint
    # survived the crash and the resume replayed it.
    return (p1.returncode, p2.returncode, "RESULT 21" in p2.stdout,
            open(os.path.join(storage, "a-ran")).read(),
            sorted(os.listdir(os.path.join(storage, "wcrash"))))


def test_crash_mid_flow_resumes_in_new_process(tmp_path):
    assert _parity(_crash, tmp_path) == [
        42, 0, True, "x", ["dag.pkl", "output.pkl", "steps",
                           "workflow.json"]]


# ----------------------------------------------- tests/test_workflow.py:140
def _cancel_and_list(pkg, tmp):
    wf = _storage(pkg, tmp)
    wf.run(pkg.remote(_double).bind(1), workflow_id="wlist")
    obs = [dict(wf.list_all()).get("wlist"),
           dict(wf.list_all(wf.WorkflowStatus.FAILED))]
    wf.delete("wlist")
    return obs + ["wlist" in dict(wf.list_all())]


def test_cancel_and_list(tmp_path):
    assert _parity(_cancel_and_list, tmp_path) == ["SUCCESSFUL", {}, False]


# ----------------------------------------------- tests/test_workflow.py:150
def _actor_nodes_rejected(pkg, tmp):
    wf = _storage(pkg, tmp)

    @pkg.remote
    class A:
        def m(self):
            return 1

    try:
        wf.run(A.bind(), workflow_id="wbad")
    except TypeError as e:
        return "not durable" in str(e), os.path.exists(
            os.path.join(tmp, pkg.__name__, "wbad"))
    return None


def test_actor_nodes_rejected(tmp_path):
    assert _parity(_actor_nodes_rejected, tmp_path) == [True, False]


# ------------------------------------------------------- step ids, layout
def _step_ids_and_layout(pkg, tmp):
    """Content-derived ids (identical binds get an occurrence suffix), the
    files a run leaves, cancel, run_async, and the API's refusals."""
    wf = _storage(pkg, tmp)
    api = importlib.import_module(pkg.__name__ + ".workflow.api")
    InputNode = importlib.import_module(pkg.__name__ + ".dag").InputNode
    double, add = pkg.remote(_double), pkg.remote(_add)
    with InputNode() as inp:
        dag = add.bind(add.bind(double.bind(inp[0]), double.bind(inp[0])),
                       add.bind(double.bind(2), b=1))
    ids = api._step_ids(dag)
    order = [ids[id(n)] for n in dag._topo()]
    fut = wf.run_async(dag, 5, workflow_id="wids")
    out = fut.result(timeout=60)
    root = os.path.join(tmp, pkg.__name__, "wids")
    steps = sorted(os.listdir(os.path.join(root, "steps")))
    wf.cancel("wids")
    cancelled = os.path.exists(os.path.join(root, "cancel"))
    resumed = wf.resume("wids")  # the marker is cleared
    return {
        "ids": order, "suffixed": sorted(i for i in order if "-" in i),
        "out": out, "async_id": fut.workflow_id,
        "steps": steps,
        "steps_are_functions": len(steps) == sum(
            type(n).__name__ == "FunctionNode" for n in dag._topo()),
        "cancel_marker": cancelled, "resumed": resumed,
        "marker_after": os.path.exists(os.path.join(root, "cancel")),
        "status": wf.get_status("wids"),
        "bad_id": raises(lambda: wf.get_status("../x")),
        "no_such": raises(lambda: wf.resume("nope")),
        "no_such_cancel": raises(lambda: wf.cancel("nope")),
        "meta_keys": sorted(api._read_meta(root)),
    }


def test_step_ids_layout_and_api_errors(tmp_path):
    obs = _parity(_step_ids_and_layout, tmp_path)
    # the second inp[0] and the second double(inp[0])
    assert obs["out"] == 25 and len(obs["suffixed"]) == 2
    assert obs["cancel_marker"] and not obs["marker_after"]


_SEEN = []


def _make_tensor():
    t = torch.arange(4.0)
    _SEEN.append(("made", t))  # held, so that no later tensor takes its id
    return t


def _use_tensor(t):
    _SEEN.append(("used", t, str(t.device), t.tolist()))
    if len(_SEEN) == 2:
        raise RuntimeError("fail the first run")
    return t * 2


def _device_rule(pkg, tmp):
    """A tensor a step returns reaches the next step as its checkpoint
    holds it: a copy, in a first run and on resume alike (on the card the
    copy is on the host: tests/test_torch_cuda.py)."""
    wf = _storage(pkg, tmp)
    del _SEEN[:]
    dag = pkg.remote(_use_tensor).bind(pkg.remote(_make_tensor).bind())
    failed = raises(lambda: wf.run(dag, workflow_id="wdev"))
    out = wf.resume("wdev")
    made, first, second = _SEEN
    return {"failed": failed is not None,
            "first_is_a_copy": first[1] is not made[1],
            "first": first[2:], "second": second[2:],
            "out": out.tolist()}


def test_step_values_cross_as_their_checkpoint_holds_them(tmp_path):
    ref, port = both(_device_rule, str(tmp_path))
    # The reference hands a thread-tier step's value on by reference; the
    # port, by the rule of its workflow/api.py, as a copy from the bytes
    # its checkpoint holds.
    assert ref["first_is_a_copy"] is False
    assert port == {"failed": True, "first_is_a_copy": True,
                    "first": ["cpu", [0.0, 1.0, 2.0, 3.0]],
                    "second": ["cpu", [0.0, 1.0, 2.0, 3.0]],
                    "out": [0.0, 2.0, 4.0, 6.0]}


# ------------------------------------------------------- the slice as a whole
TOL = 1e-4  # the Train parity tests' (tests/test_torch_train_fit.py)
B, CHUNK_STEPS, CHUNKS, LR = 4, 2, 3, 1e-3


def _jcfg():
    import dataclasses

    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as jgpt2

    return dataclasses.replace(
        jgpt2.GPTConfig.tiny(), dtype=jnp.float32, logits_dtype=jnp.float32,
        loss_impl="fused", remat_policy="attn_outside", **train_gpt2.TINY)


@pytest.fixture(scope="module")
def chunk_inputs():
    import jax

    from ray_tpu.models import gpt2 as jgpt2

    init = jax.tree.map(np.asarray, jgpt2.init_params(_jcfg(),
                                                      jax.random.key(0)))
    tokens = np.random.default_rng(0).integers(
        0, train_gpt2.TINY["vocab_size"],
        (B * CHUNK_STEPS * CHUNKS, train_gpt2.TINY["seq_len"] + 1),
        dtype=np.int64)
    return init, tokens


def _jax_init(init, out):
    import jax

    from ray_tpu.models import gpt2 as jgpt2

    state = {"params": init,
             "opt_state": jax.tree.map(np.asarray, jgpt2.make_optimizer(
                 LR).init(init)), "step": 0}
    with open(out, "wb") as f:
        pickle.dump(state, f)
    return out


def _jax_chunk(prev, index, tokens, out):
    """Two AdamW steps of the JAX model from the state at ``prev``."""
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.models import gpt2 as jgpt2

    path = prev if isinstance(prev, str) else prev[0]
    with open(path, "rb") as f:
        state = pickle.load(f)
    cfg, opt = _jcfg(), jgpt2.make_optimizer(LR)
    params = jax.tree.map(jnp.asarray, state["params"])
    opt_state = jax.tree.map(jnp.asarray, state["opt_state"])
    vg = jax.jit(jax.value_and_grad(
        lambda p, a, b: jgpt2.loss_fn(p, a, b, cfg)))
    losses = []
    for j in range(CHUNK_STEPS):
        i = index * CHUNK_STEPS + j
        tok = tokens[i * B:(i + 1) * B]
        loss, g = vg(params, tok[:, :cfg.seq_len], tok[:, 1:])
        updates, opt_state = opt.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    with open(out, "wb") as f:
        pickle.dump({"params": jax.tree.map(np.asarray, params),
                     "opt_state": jax.tree.map(np.asarray, opt_state),
                     "step": state["step"] + CHUNK_STEPS}, f)
    return out, losses


def _port_template(init):
    from ray_tpu_torch.models import convert, gpt2

    params = convert.params_from_numpy(init, device="cpu")
    return {"params": params,
            "opt_state": gpt2.make_optimizer(LR).init(params), "step": 0}


def _port_init(init, out):
    from ray_tpu_torch.train import save_pytree

    save_pytree(_port_template(init), out)
    return out


def _port_chunk(prev, index, tokens, out, init, fail_flag):
    """Two AdamW steps of the port's model (``examples/train_gpt2.py``'s
    config, tiny) from the state ``load_pytree`` reads at ``prev``."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.optim import tree_leaves, tree_map
    from ray_tpu_torch.train import load_pytree, save_pytree

    if os.path.exists(fail_flag):
        os.unlink(fail_flag)
        raise RuntimeError("failure injected in a chunk")
    path = prev if isinstance(prev, str) else prev[0]
    state = load_pytree(path, _port_template(init))
    cfg = train_gpt2.model_config(tiny=True)
    params, opt_state = state["params"], state["opt_state"]
    optimizer = gpt2.make_optimizer(LR)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    losses = []
    for j in range(CHUNK_STEPS):
        i = index * CHUNK_STEPS + j
        tok = torch.as_tensor(tokens[i * B:(i + 1) * B])
        loss = gpt2.loss_fn(params, tok[:, :cfg.seq_len], tok[:, 1:], cfg)
        it = iter(torch.autograd.grad(loss, leaves))
        opt_state = optimizer.update(tree_map(lambda _: next(it), params),
                                     opt_state, params)
        losses.append(float(loss.detach()))
    save_pytree({"params": params, "opt_state": opt_state,
                 "step": int(state["step"]) + CHUNK_STEPS}, out)
    return out, losses


def _port_chunk_logged(prev, index, tokens, out, init, fail_flag, log):
    """``_port_chunk``, noting each run in ``log``; only the second chunk
    reads the failure flag."""
    with open(log, "a") as f:
        f.write(f"{index}\n")
    return _port_chunk(prev, index, tokens, out, init,
                       fail_flag if index == 1 else "")


def _chunk_dag(pkg, init_fn, chunk_fn, init, tokens, store, *extra):
    node = pkg.remote(init_fn).bind(init, os.path.join(store, "state-0"))
    chunk = pkg.remote(chunk_fn)
    for index in range(CHUNKS):
        node = chunk.bind(node, index, tokens,
                          os.path.join(store, f"state-{index + 1}"), *extra)
    return node


def _chunk_losses(tmp_path, pkg, dag):
    """Each chunk's losses, in chunk order, read back from the workflow's
    step checkpoints."""
    ids = importlib.import_module(pkg.__name__ + ".workflow.api")._step_ids(
        dag)
    out = []
    for node in dag._topo():
        path = tmp_path / pkg.__name__ / "gpt2-chunks" / "steps" / \
            f"{ids[id(node)]}.pkl"
        with open(path, "rb") as f:
            value = pickle.load(f)
        if isinstance(value, tuple):
            out.extend(value[1])
    return out


def test_gpt2_chunks_fail_resume_and_match_jax(tmp_path, chunk_inputs):
    """The port's workflow of three two-step chunks fails in its second
    chunk, is resumed without rerunning the first, and its six losses and
    final parameters match the reference's uninterrupted workflow of the
    same chunks in JAX within TOL."""
    from ray_tpu_torch.models import convert
    from ray_tpu_torch.train import load_pytree

    init, tokens = chunk_inputs
    with gc_paused():
        fresh_init(ray_tpu, num_cpus=4)
        try:
            wf = _storage(ray_tpu, tmp_path)
            store = str(tmp_path / "jax-states")
            os.makedirs(store)
            ref_dag = _chunk_dag(ray_tpu, _jax_init, _jax_chunk, init,
                                 tokens, store)
            ref_path, ref_last = bounded(
                lambda: wf.run(ref_dag, workflow_id="gpt2-chunks"), 300)
        finally:
            ray_tpu.shutdown()
    with open(ref_path, "rb") as f:
        ref_final = pickle.load(f)["params"]

    fresh_init(ray_tpu_torch, num_cpus=4)
    try:
        wf = _storage(ray_tpu_torch, tmp_path)
        store = str(tmp_path / "port-states")
        os.makedirs(store)
        flag, log = str(tmp_path / "fail-chunk-1"), str(tmp_path / "ran")
        dag = _chunk_dag(ray_tpu_torch, _port_init, _port_chunk_logged, init,
                         tokens, store, init, flag, log)
        open(flag, "w").write("fail once")
        with pytest.raises(Exception, match="failure injected"):
            bounded(lambda: wf.run(dag, workflow_id="gpt2-chunks"), 300)
        assert wf.get_status("gpt2-chunks") == "FAILED"
        assert open(log).read().split() == ["0", "1"]
        path, last = bounded(lambda: wf.resume("gpt2-chunks"), 300)
        # The first chunk did not run again.
        assert open(log).read().split() == ["0", "1", "1", "2"]
        assert wf.get_status("gpt2-chunks") == "SUCCESSFUL"
    finally:
        ray_tpu_torch.shutdown()
    assert path == os.path.join(store, f"state-{CHUNKS}")

    port_losses = _chunk_losses(tmp_path, ray_tpu_torch, dag)
    ref_losses = _chunk_losses(tmp_path, ray_tpu, ref_dag)
    assert len(port_losses) == len(ref_losses) == CHUNKS * CHUNK_STEPS
    assert (last, ref_last) == (port_losses[-CHUNK_STEPS:],
                                ref_losses[-CHUNK_STEPS:])
    np.testing.assert_allclose(port_losses, ref_losses, rtol=0, atol=TOL)

    final = load_pytree(path, _port_template(init))
    assert int(final["step"]) == CHUNKS * CHUNK_STEPS
    got = convert.params_to_numpy(final["params"])

    def walk(want, have, name=""):
        if isinstance(want, dict):
            assert sorted(want) == sorted(have), name
            for k in want:
                walk(want[k], have[k], f"{name}.{k}")
        else:
            np.testing.assert_allclose(np.asarray(have), np.asarray(want),
                                       rtol=0, atol=TOL, err_msg=name)

    walk(ref_final, got)

