"""Package rules of the port (ray_tpu_torch) and chip_smoke.py.

- Importing any module of the port, or chip_smoke.py, loads no JAX, no
  Triton and nothing of ray_tpu, nor any of the reference's dependencies
  that the card's machine lacks (aiohttp, cloudpickle, psutil, grpc): the
  runtime and serve control plane use the standard library. Data's Arrow,
  pandas and TFRecord paths import pyarrow, pandas and google (protobuf,
  crc32c) inside the functions that need them, as Triton is imported. This runs in a
  subprocess: this test process already has JAX (tests/conftest.py), and
  the name ray_tpu_torch itself starts with "ray_tpu".
- Entry points run on the GPU unless given device="cpu", and raise without
  one (RL's algorithms and learners too; RL runs without gymnasium).
- The kernel build forms the sm_90a nvcc command and raises without nvcc.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ray_tpu_torch import bench
from ray_tpu_torch._private import device as device_mod
from ray_tpu_torch._private import kernel_build, peaks
from ray_tpu_torch.models import convert, gpt2
from ray_tpu_torch.rl import (DefaultActorCritic, MultiAgentCartPole,
                              MultiAgentEnvRunner, MultiRLModuleSpec,
                              RLModuleSpec, TorchLearner)
from ray_tpu_torch.rl.algorithms import (DQNConfig, DreamerV3Config, PPOConfig,
                                         SACConfig, SACLearner)
from ray_tpu_torch.rl.algorithms.sac import SACModule
from ray_tpu_torch.serve import GPT2Next, GPT2Stream

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "ray_tpu_torch"


#: Packages the port may not import: JAX, the reference package, and the
#: reference's dependencies that the card's machine does not have (RL's
#: gymnasium among them: the port has its own CartPole).
_FORBIDDEN_ROOTS = ("jax", "jaxlib", "ray_tpu", "aiohttp", "cloudpickle",
                    "psutil", "grpc", "gymnasium")


#: Packages the port imports only inside the function that needs them:
#: Triton in a kernel's launcher, Data's optional formats, which the card's
#: machine lacks, and joblib (util/joblib.py's backend; it loads psutil).
_LAZY_ROOTS = ("triton", "pyarrow", "pandas", "google", "joblib")


def _forbidden(name):
    # Not "google": an interpreter may start with its namespace package
    # loaded (a site .pth file of a google-* distribution), whatever the
    # port imports; the scan below still refuses it at module level.
    root = name.split(".")[0]
    return root in _FORBIDDEN_ROOTS or (root in _LAZY_ROOTS
                                        and root != "google")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_import_loads_no_jax_triton_or_ray_tpu():
    code = """
import importlib, json, pkgutil, sys
import ray_tpu_torch
mods = ["ray_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    ray_tpu_torch.__path__, "ray_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
chip_smoke.attention_bound(1, 1024, 12, 64, True, *chip_smoke.peaks_for(
    "NVIDIA H100 80GB HBM3"))
print(json.dumps({"modules": mods, "loaded": sorted(sys.modules)}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"ray_tpu_torch.models.gpt2", "ray_tpu_torch.ops.attention",
            "ray_tpu_torch.serve.gpt2", "ray_tpu_torch.ops.fused_ce",
            "ray_tpu_torch.optim", "ray_tpu_torch.bench",
            "ray_tpu_torch._private.peaks",
            "ray_tpu_torch._private.kernel_build",
            "ray_tpu_torch.ops.ring_attention", "ray_tpu_torch.parallel",
            "ray_tpu_torch.parallel.mesh",
            "ray_tpu_torch.parallel.train_state",
            "ray_tpu_torch._private.runtime",
            "ray_tpu_torch._private.object_store",
            "ray_tpu_torch._private.scheduling", "ray_tpu_torch.actor",
            "ray_tpu_torch.remote_function", "ray_tpu_torch.exceptions",
            "ray_tpu_torch.experimental.internal_kv",
            "ray_tpu_torch.util.tracing", "ray_tpu_torch.util.metrics",
            "ray_tpu_torch.serve.api", "ray_tpu_torch.serve.controller",
            "ray_tpu_torch.serve.proxy", "ray_tpu_torch.serve.router",
            "ray_tpu_torch.serve.replica",
            "ray_tpu_torch.serve.deployment_state",
            "ray_tpu_torch.examples.serve_gpt2",
            "ray_tpu_torch.data", "ray_tpu_torch.data.executor",
            "ray_tpu_torch.data.exchange", "ray_tpu_torch.data.tfrecords",
            "ray_tpu_torch.data.ingest.ingest",
            "ray_tpu_torch.data.ingest.prefetch",
            "ray_tpu_torch.train.elastic",
            "ray_tpu_torch.examples.batch_inference",
            "ray_tpu_torch.collective",
            "ray_tpu_torch.collective.thread_group",
            "ray_tpu_torch.collective.process_group",
            "ray_tpu_torch.collective.distributed",
            "ray_tpu_torch.train", "ray_tpu_torch.train.trainer",
            "ray_tpu_torch.train.torch_trainer",
            "ray_tpu_torch.train.checkpoint", "ray_tpu_torch.train.session",
            "ray_tpu_torch.train.profiler", "ray_tpu_torch.util.watchdog",
            "ray_tpu_torch.util.queue", "ray_tpu_torch.util.placement_group",
            "ray_tpu_torch.examples.train_gpt2",
            "ray_tpu_torch.util.actor_pool", "ray_tpu_torch.util.pubsub",
            "ray_tpu_torch.util.multiprocessing",
            "ray_tpu_torch.util.joblib", "ray_tpu_torch.util.forensics",
            "ray_tpu_torch.util.state", "ray_tpu_torch.dag",
            "ray_tpu_torch.dag.dag_node", "ray_tpu_torch.workflow",
            "ray_tpu_torch.workflow.api", "ray_tpu_torch.job",
            "ray_tpu_torch.job.job_manager", "ray_tpu_torch.cluster_utils",
            "ray_tpu_torch.autoscaler", "ray_tpu_torch.autoscaler.elastic",
            "ray_tpu_torch._private.accelerators", "ray_tpu_torch.rl",
            "ray_tpu_torch.rl.algorithm", "ray_tpu_torch.rl.config",
            "ray_tpu_torch.rl.connectors", "ray_tpu_torch.rl.core.learner",
            "ray_tpu_torch.rl.core.learner_group",
            "ray_tpu_torch.rl.core.rl_module",
            "ray_tpu_torch.rl.env.cartpole", "ray_tpu_torch.rl.env.env_runner",
            "ray_tpu_torch.rl.env.env_runner_group",
            "ray_tpu_torch.rl.algorithms.ppo",
            "ray_tpu_torch.examples.cartpole_ppo"} <= set(res["modules"])
    assert [m for m in res["loaded"] if _forbidden(m)] == []


def test_sources_import_no_jax_triton_or_ray_tpu_at_module_level():
    """AST scan: no jax, ray_tpu, aiohttp, cloudpickle, psutil or grpc
    import anywhere in the port or chip_smoke.py, and triton (where a later
    kernel needs it), pyarrow, pandas and google only inside a function."""
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        top = set(id(n) for n in tree.body)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in _FORBIDDEN_ROOTS, (path, name)
                if root in _LAZY_ROOTS:
                    assert id(node) not in top, (path, name)


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


_TINY = gpt2.GPTConfig(vocab_size=64, n_layer=1, n_head=1, d_model=64,
                       seq_len=16, dtype=torch.float32)
_RL_SPEC = RLModuleSpec(module_class=DefaultActorCritic, observation_dim=4,
                        action_dim=2, model_config={"hiddens": (8,)})
_SAC_SPEC = RLModuleSpec(module_class=SACModule, observation_dim=3,
                         action_dim=1, discrete=False,
                         model_config={"hiddens": (8,)})


@pytest.mark.parametrize("make", [
    lambda dev: bench.run(_TINY, batch=1, steps=1, windows=1, warmup=1,
                          device=dev) if dev else
    bench.run(_TINY, batch=1, steps=1, windows=1, warmup=1),
    lambda dev: device_mod.resolve_device(dev),
    lambda dev: gpt2.init_params(_TINY, 0, dev) if dev else
    gpt2.init_params(_TINY),
    lambda dev: GPT2Next(_TINY, device=dev) if dev else GPT2Next(_TINY),
    lambda dev: GPT2Stream(_TINY, device=dev) if dev else GPT2Stream(_TINY),
    lambda dev: convert.params_from_numpy({"w": np.zeros(3)}, device=dev)
    if dev else convert.params_from_numpy({"w": np.zeros(3)}),
    lambda dev: PPOConfig().environment("CartPole-v1").training(
        train_batch_size=8).resources(device=dev).build_algo() if dev else
    PPOConfig().environment("CartPole-v1").build_algo(),
    lambda dev: TorchLearner(config=PPOConfig().resources(device=dev),
                             module_spec=_RL_SPEC),
    lambda dev: DQNConfig().environment("CartPole-v1").resources(
        device=dev).build_algo(),
    lambda dev: SACLearner(config=SACConfig().resources(device=dev),
                           module_spec=_SAC_SPEC),
    lambda dev: DreamerV3Config().environment("CartPole-v1").training(
        deter_dim=8, hidden=8).resources(device=dev).build_algo(),
    lambda dev: MultiAgentEnvRunner(
        env=MultiAgentCartPole, module_spec=MultiRLModuleSpec({"p": _RL_SPEC}),
        policy_mapping_fn=lambda a: "p", device=dev)])
def test_entry_points_default_to_the_gpu(no_gpu, make):
    with pytest.raises(RuntimeError, match="CUDA"):
        make(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        make("cuda")
    assert make("cpu") is not None


def test_resolve_device():
    assert device_mod.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        device_mod.resolve_device("meta")


def test_nvcc_command_targets_sm90a():
    cmd = kernel_build.nvcc_command("/x/nvcc", Path("a.cu"), Path("liba.so"))
    assert cmd[0] == "/x/nvcc" and cmd[-1] == "a.cu"
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    for flag in ("-std=c++17", "-O3", "-shared", "-fPIC"):
        assert flag in cmd
    assert cmd[cmd.index("-o") + 1] == "liba.so"
    assert "splash_attention_fwd" in kernel_build.kernel_names()


def test_every_kernel_source_is_built():
    assert kernel_build.kernel_names() == [
        "fused_ce", "ring_attention_bwd", "ring_attention_fwd",
        "splash_attention_bwd", "splash_attention_fwd"]


def test_the_scan_covers_the_parallel_package():
    files = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    assert {"parallel/__init__.py", "parallel/mesh.py",
            "parallel/train_state.py", "ops/ring_attention.py"} <= files


def test_the_scan_covers_the_runtime_serve_util_and_examples():
    files = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    assert {"_private/runtime.py", "_private/object_store.py",
            "_private/object_ref.py", "_private/scheduling.py",
            "_private/kv_store.py", "actor.py", "remote_function.py",
            "experimental/internal_kv.py", "util/tracing.py",
            "util/metrics.py", "serve/api.py", "serve/controller.py",
            "serve/proxy.py", "serve/router.py", "serve/replica.py",
            "serve/handle.py", "serve/long_poll.py",
            "serve/deployment_state.py", "serve/autoscaling.py",
            "examples/serve_gpt2.py", "examples/batch_inference.py",
            "data/__init__.py", "data/block.py", "data/dataset.py",
            "data/executor.py", "data/exchange.py", "data/tfrecords.py",
            "data/ingest/ingest.py", "data/ingest/prefetch.py",
            "train/elastic.py"} <= files


def test_the_scan_covers_collective_train_and_util():
    files = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    assert {"collective/__init__.py", "collective/thread_group.py",
            "collective/process_group.py", "collective/distributed.py",
            "train/__init__.py", "train/config.py", "train/checkpoint.py",
            "train/session.py", "train/profiler.py", "train/metrics.py",
            "train/run_registry.py", "train/trainer.py",
            "train/torch_trainer.py", "util/watchdog.py", "util/queue.py",
            "util/placement_group.py", "util/scheduling_strategies.py",
            "examples/train_gpt2.py"} <= files


def test_the_scan_covers_tune_and_air():
    files = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    assert {"tune/__init__.py", "tune/search_space.py",
            "tune/search/__init__.py", "tune/search/bohb.py",
            "tune/search/optuna.py", "tune/schedulers.py", "tune/trial.py",
            "tune/trainable.py", "tune/tune_controller.py",
            "tune/result_grid.py", "tune/tuner.py", "air/__init__.py",
            "air/integrations/__init__.py", "air/integrations/_common.py",
            "air/integrations/tensorboard.py", "air/integrations/wandb.py",
            "air/integrations/mlflow.py"} <= files


def test_the_scan_covers_the_small_libraries():
    files = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    assert {"util/actor_pool.py", "util/pubsub.py", "util/multiprocessing.py",
            "util/joblib.py", "util/forensics.py", "util/state/__init__.py",
            "dag/__init__.py", "dag/dag_node.py", "workflow/__init__.py",
            "workflow/api.py", "job/__init__.py",
            "job/job_manager.py"} <= files


def test_the_scan_covers_rl():
    files = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    assert {"rl/__init__.py", "rl/algorithm.py", "rl/config.py",
            "rl/connectors.py", "rl/core/__init__.py", "rl/core/learner.py",
            "rl/core/learner_group.py", "rl/core/rl_module.py",
            "rl/core/multi_rl_module.py", "rl/env/__init__.py",
            "rl/env/cartpole.py", "rl/env/episode.py", "rl/env/env_runner.py",
            "rl/env/env_runner_group.py", "rl/utils/__init__.py",
            "rl/utils/metrics.py", "rl/utils/replay_buffers.py",
            "rl/algorithms/__init__.py", "rl/algorithms/ppo.py",
            "examples/cartpole_ppo.py"} <= files


def test_the_scan_covers_the_rest_of_rl():
    files = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    assert {"rl/offline.py", "rl/env/spaces.py", "rl/env/pendulum.py",
            "rl/env/pixel_gridworld.py", "rl/env/multi_agent_env.py",
            "rl/env/multi_agent_episode.py", "rl/env/multi_agent_env_runner.py",
            "rl/algorithms/dqn.py", "rl/algorithms/impala.py",
            "rl/algorithms/appo.py", "rl/algorithms/sac.py",
            "rl/algorithms/cql.py", "rl/algorithms/bc.py",
            "rl/algorithms/marwil.py"} <= files


def test_the_scan_covers_dreamerv3_and_device_telemetry():
    files = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    assert {"rl/algorithms/dreamerv3.py", "util/device_telemetry.py",
            "_private/torch_compat.py"} <= files


def test_rl_algorithms_run_without_gymnasium_pyarrow_or_pandas():
    """DQN, SAC, CQL and BC on the port's CartPole and Pendulum, offline
    data held in memory, with gymnasium, pyarrow and pandas blocked (the
    card's machine has none of them), starting no CUDA context."""
    code = """
import json, sys
for name in ("gymnasium", "pyarrow", "pandas"):
    sys.modules[name] = None
import numpy as np, torch
from ray_tpu_torch.rl.algorithms import BCConfig, CQLConfig, DQNConfig, SACConfig
from ray_tpu_torch.rl.connectors import episodes_to_transitions
from ray_tpu_torch.rl.env import cartpole
from ray_tpu_torch.rl.env.episode import SingleAgentEpisode
env = cartpole.make("Pendulum-v1")
obs, _ = env.reset(seed=0)
ep = SingleAgentEpisode()
ep.add_env_reset(obs)
for t in range(64):
    a = np.array([np.sin(t)], np.float32)
    obs, r, term, trunc, _ = env.step(a)
    ep.add_env_step(obs, a, r, terminated=term, truncated=trunc)
data = episodes_to_transitions([ep])
mod = {"hiddens": (8,), "action_scale": 2.0}
out = {}
for name, cfg in (
        ("dqn", DQNConfig().environment("CartPole-v1").training(
            train_batch_size=8, num_steps_sampled_before_learning_starts=8)),
        ("sac", SACConfig().environment("Pendulum-v1").rl_module(
            model_config=mod).training(
            train_batch_size=8, num_steps_sampled_before_learning_starts=16)),
        ("cql", CQLConfig().environment("Pendulum-v1").rl_module(
            model_config=mod).offline_data(input_=data, updates_per_iteration=2)
         .training(train_batch_size=8)),
        ("bc", BCConfig().environment("Pendulum-v1").offline_data(
            input_=data, updates_per_iteration=2).training(train_batch_size=8))):
    algo = cfg.resources(device="cpu").build_algo()
    for _ in range(3):
        res = algo.train()
    algo.stop()
    out[name] = res["learners"]["total_loss"]
print(json.dumps({"losses": out, "cuda": torch.cuda.is_initialized(),
                  "blocked": [sys.modules[n] is None for n in
                              ("gymnasium", "pyarrow", "pandas")]}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(res["losses"]) == {"dqn", "sac", "cql", "bc"}
    assert all(np.isfinite(v) for v in res["losses"].values())
    assert not res["cuda"] and all(res["blocked"])


def test_rl_runs_a_ppo_iteration_without_gymnasium():
    """RL imports and trains with gymnasium blocked (the card's machine has
    none), starting no CUDA context."""
    code = """
import json, sys
sys.modules["gymnasium"] = None
import torch
import ray_tpu_torch.rl
from ray_tpu_torch.rl.algorithms import PPOConfig
algo = (PPOConfig().environment("CartPole-v1")
        .env_runners(num_envs_per_env_runner=2, rollout_fragment_length=16)
        .training(train_batch_size=64, minibatch_size=32, num_epochs=1)
        .resources(device="cpu").build_algo())
res = algo.train()
algo.stop()
print(json.dumps({"steps": res["num_env_steps_sampled_lifetime"],
                  "loss": res["learners"]["total_loss"],
                  "cuda": torch.cuda.is_initialized(),
                  "gymnasium": sys.modules["gymnasium"] is not None}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["steps"] == 64 and np.isfinite(res["loss"])
    assert not res["cuda"] and not res["gymnasium"]


def test_the_small_libraries_import_without_initialising_cuda():
    """The multiprocessing Pool's remote chunk function is made at import:
    that, and the other small libraries, start no CUDA context, no runtime
    and no thread, and load neither joblib nor psutil."""
    code = """
import json, sys, threading, torch
before = threading.active_count()
import ray_tpu_torch.util.actor_pool, ray_tpu_torch.util.pubsub
import ray_tpu_torch.util.multiprocessing, ray_tpu_torch.util.joblib
import ray_tpu_torch.util.state, ray_tpu_torch.util.forensics
import ray_tpu_torch.dag, ray_tpu_torch.workflow, ray_tpu_torch.job
print(json.dumps({"cuda": torch.cuda.is_initialized(),
                  "runtime": ray_tpu_torch.is_initialized(),
                  "threads": threading.active_count() - before,
                  "libs": sorted(m for m in ("joblib", "psutil")
                                 if m in sys.modules)}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "cuda": False, "runtime": False, "threads": 0, "libs": []}


def test_tune_and_air_import_without_initialising_cuda():
    """Tune's trial actor class is made at import: that, and the logger
    integrations, start no CUDA context, no runtime and no thread, and
    import none of the tracking libraries (each is imported where a trial
    is logged)."""
    code = """
import json, sys, threading, torch
before = threading.active_count()
import ray_tpu_torch.tune, ray_tpu_torch.air, ray_tpu_torch.air.integrations
import ray_tpu_torch.tune.search.bohb, ray_tpu_torch.tune.search.optuna
print(json.dumps({"cuda": torch.cuda.is_initialized(),
                  "runtime": ray_tpu_torch.is_initialized(),
                  "threads": threading.active_count() - before,
                  "libs": sorted(m for m in ("tensorboardX", "wandb", "mlflow",
                                             "optuna", "ConfigSpace", "pandas")
                                 if m in sys.modules)}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "cuda": False, "runtime": False, "threads": 0, "libs": []}


#: Imported only inside the functions that use them in collective/ and
#: train/, so that importing either package sets up no process group.
_DISTRIBUTED = ("torch.distributed", "torch.nn.parallel")


def test_collective_and_train_import_torch_distributed_in_functions():
    for path in sorted((PORT / "collective").rglob("*.py")) + \
            sorted((PORT / "train").rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in tree.body:
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert not name.startswith(_DISTRIBUTED), (path, name)


def test_importing_collective_and_train_sets_up_no_process_group():
    code = """
import json, sys
import ray_tpu_torch.collective, ray_tpu_torch.train
import torch.distributed as dist
print(json.dumps({"initialized": dist.is_initialized()}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "initialized": False}


def test_runtime_and_serve_import_without_initialising_cuda():
    """``import ray_tpu_torch`` and its serve package stay light: no CUDA
    context, no runtime, no thread started at import."""
    code = """
import json, threading, torch
before = threading.active_count()
import ray_tpu_torch, ray_tpu_torch.serve
print(json.dumps({"cuda": torch.cuda.is_initialized(),
                  "runtime": ray_tpu_torch.is_initialized(),
                  "threads": threading.active_count() - before}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "cuda": False, "runtime": False, "threads": 0}


@pytest.mark.parametrize("header", ["attention_fwd.cuh", "attention_bwd.cuh",
                                    "mma_sm90.cuh", "wgmma_sm90.cuh"])
def test_build_digest_covers_the_shared_headers(tmp_path, monkeypatch, header):
    """The attention bodies live in headers that several sources include: an
    edited header must give a new build directory, so every library is
    rebuilt."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(kernel_build.CSRC_DIR, csrc)
    monkeypatch.setattr(kernel_build, "CSRC_DIR", csrc)
    before = kernel_build.build_dir()
    with open(csrc / header, "a") as f:
        f.write("\n// edited\n")
    assert kernel_build.build_dir() != before


def test_bench_raises_on_an_unknown_device_name(monkeypatch):
    """MFU is taken against a table of published peaks; a card that is not
    in it raises before anything runs, instead of being measured against a
    guessed peak."""
    assert peaks.peaks_for("NVIDIA H100 80GB HBM3") == (3.35e12, 989e12)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(KeyError, match="no published peaks"):
        bench.run(_TINY, batch=1, steps=1)


def test_chip_smoke_uses_the_packages_peak_table():
    import chip_smoke

    assert chip_smoke.PEAKS is peaks.PEAKS
    assert chip_smoke.peaks_for is peaks.peaks_for


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(shutil, "which", lambda *a, **k: None)
    monkeypatch.setattr(kernel_build, "BUILD_ROOT", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc"):
        kernel_build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc"):
        kernel_build.build()
    assert not any((tmp_path / "_build").rglob("*.so"))


def test_build_dir_follows_the_sources(monkeypatch, tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    monkeypatch.setattr(kernel_build, "CSRC_DIR", tmp_path)
    first = kernel_build.build_dir()
    assert first == kernel_build.build_dir()
    src.write_text("// v2\n")
    assert kernel_build.build_dir() != first
    assert first.parent == kernel_build.BUILD_ROOT


def test_built_libraries_are_not_committed():
    lines = (REPO / ".gitignore").read_text().splitlines()
    assert "ray_tpu_torch/_build/" in lines


def test_attention_bound_of_the_serving_shapes():
    import chip_smoke

    peaks = chip_smoke.peaks_for("NVIDIA H100 80GB HBM3")
    ms8, by8 = chip_smoke.attention_bound(8, 1024, 12, 64, True, *peaks)
    ms1, by1 = chip_smoke.attention_bound(1, 1024, 12, 64, True, *peaks)
    # q, k, v, o of 12.6 MB each at B=8, over 3.35 TB/s.
    assert by8 == by1 == "bytes"
    assert ms8 == pytest.approx(0.01514, rel=1e-3)
    assert ms1 == pytest.approx(0.001893, rel=1e-3)
    with pytest.raises(KeyError):
        chip_smoke.peaks_for("NVIDIA A100")


def test_training_kernel_bounds():
    """The bounds chip_smoke.py reports for the training shapes: the splash
    backward at (16, 1024, 12, 64) causal is set by its 10*hd flops per kept
    pair (6.45e10 flops against ~203 MB); each fused CE kernel by its
    2*N*V*D (fwd) or 4*N*V*D (dx, dW, which recompute the logits) flops."""
    import chip_smoke

    peaks = chip_smoke.peaks_for("NVIDIA H100 80GB HBM3")
    ms, by = chip_smoke.attention_bwd_bound(16, 1024, 12, 64, True, *peaks)
    assert by == "operations" and ms == pytest.approx(0.06520, rel=1e-3)
    for which, want in (("fwd", 1.2800), ("dx", 2.5600), ("dw", 2.5600)):
        ms, by = chip_smoke.ce_bound(which, 16384, 768, 50304, *peaks)
        assert by == "operations" and ms == pytest.approx(want, rel=1e-3)
    # The ragged 24 x 96 case moves more bytes than it computes.
    assert chip_smoke.ce_bound("dw", 24, 64, 96, *peaks)[1] == "bytes"


def test_ring_kernel_bounds():
    """The bounds chip_smoke.py reports for the ring at the training path's
    shapes (B=16, S_local=256, H=12, hd=64, W=4): the causal forward's 10
    rank-steps read q, k, v and read and write the fp32 o_acc and lse_acc
    once each, 444 MB (0.1326 ms); the backward's read q, k, v, do, lse,
    delta and read and write the fp32 dq, dk, dv, 1.01 GB; both bound by
    bytes. Per launch: step 0 (4 diagonal rank-steps) and step 1 (3 full)."""
    import chip_smoke

    peaks = chip_smoke.peaks_for("NVIDIA H100 80GB HBM3")
    ms, by = chip_smoke.ring_bound("fwd", 16, 256, 12, 64, 4, 6, *peaks)
    assert by == "bytes" and ms == pytest.approx(0.13264, rel=1e-3)
    ms, by = chip_smoke.ring_bound("bwd", 16, 256, 12, 64, 4, 6, *peaks)
    assert by == "bytes" and ms == pytest.approx(0.30166, rel=1e-3)
    assert chip_smoke.ring_bound("fwd", 16, 256, 12, 64, 4, 0, *peaks)[0] == \
        pytest.approx(0.053055, rel=1e-3)
    assert chip_smoke.ring_bound("fwd", 16, 256, 12, 64, 0, 3, *peaks)[0] == \
        pytest.approx(0.039791, rel=1e-3)


def test_ring_kernel_bounds_with_a_first_step_that_writes():
    """The ring's step 0 writes its accumulators and reads none: at the
    training path's shapes its 4 blocks move 126.6 MB forward (0.0378 ms)
    and 253.2 MB backward (0.0756 ms), and a layer's 10 blocks 393.2 MB
    (0.1174 ms) and 859.6 MB (0.2566 ms), all bound by bytes."""
    import chip_smoke

    peaks = chip_smoke.peaks_for("NVIDIA H100 80GB HBM3")
    for which, n_diag, n_full, want in (("fwd", 4, 6, 0.117378),
                                        ("bwd", 4, 6, 0.256588),
                                        ("fwd", 4, 0, 0.037796),
                                        ("bwd", 4, 0, 0.075591)):
        ms, by = chip_smoke.ring_bound(which, 16, 256, 12, 64, n_diag, n_full,
                                       *peaks, n_first=4)
        assert by == "bytes" and ms == pytest.approx(want, rel=1e-4)
    # Without first-step blocks the form is the one every step accumulates.
    assert chip_smoke.ring_bound("bwd", 16, 256, 12, 64, 0, 3, *peaks,
                                 n_first=0) == chip_smoke.ring_bound(
        "bwd", 16, 256, 12, 64, 0, 3, *peaks)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_gpu(tmp_path, alone):
    """No CUDA here: chip_smoke exits non-zero and prints no result, from
    the repo and from a directory that holds the script alone."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    cwd = REPO
    if alone:
        shutil.copy(REPO / "chip_smoke.py", tmp_path)
        cwd = tmp_path
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
