"""Trainable: class API + function-API wrapper.

(ref: python/ray/tune/trainable/trainable.py:58 Trainable — setup/step/
save_checkpoint/load_checkpoint with train() bookkeeping; function API wrapped
by tune/trainable/function_trainable.py FunctionTrainable — user fn runs in a
thread, reporting through the session queue.)

The counterpart of ``ray_tpu/tune/trainable.py``. One addition: the
function's thread runs under the trial actor's task context, so
``get_gpu_ids()`` and ``granted_cuda_device()`` there name the trial's
lease instead of nothing (the context is thread-local).
"""

from __future__ import annotations

import inspect
import os
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch._private import runtime
from ray_tpu_torch._private.ids import TaskID
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.session import TrainContext, TrainSession, clear_session, init_session

DONE = "done"
TRAINING_ITERATION = "training_iteration"


class Trainable:
    """Subclass API (ref: trainable.py:58)."""

    def __init__(self, config: Optional[Dict[str, Any]] = None,
                 trial_dir: Optional[str] = None, trial_id: str = "",
                 trial_name: str = ""):
        self.config = config or {}
        self.trial_id = trial_id
        self.trial_name = trial_name
        self._trial_dir = trial_dir or tempfile.mkdtemp(prefix="ray_tpu_trial_")
        os.makedirs(self._trial_dir, exist_ok=True)
        self.iteration = 0
        self._start_time = time.time()
        self.setup(self.config)

    # -------- subclass hooks
    def setup(self, config: Dict[str, Any]) -> None:
        pass

    def step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def save_checkpoint(self, checkpoint_dir: str) -> Optional[Dict]:
        return None

    def load_checkpoint(self, checkpoint: Optional[Dict], checkpoint_dir: str) -> None:
        pass

    def cleanup(self) -> None:
        pass

    # -------- controller-facing API
    def train(self) -> Dict[str, Any]:
        result = self.step() or {}
        self.iteration += 1
        result.setdefault(TRAINING_ITERATION, self.iteration)
        result.setdefault("trial_id", self.trial_id)
        result.setdefault("time_total_s", time.time() - self._start_time)
        result.setdefault("timestamp", time.time())
        result.setdefault("config", self.config)
        return result

    def save(self) -> str:
        ckpt_dir = os.path.join(self._trial_dir,
                                f"checkpoint_{self.iteration:06d}")
        os.makedirs(ckpt_dir, exist_ok=True)
        data = self.save_checkpoint(ckpt_dir)
        import pickle

        # Pickle (not JSON) so arbitrary checkpoint values round-trip
        # faithfully; iteration rides along so a restored trial resumes its
        # training_iteration clock (ref: Trainable persists _iteration).
        with open(os.path.join(ckpt_dir, "trainable_state.pkl"), "wb") as f:
            pickle.dump({"data": data, "iteration": self.iteration}, f)
        return ckpt_dir

    def restore(self, checkpoint_path: str) -> None:
        data = None
        state_file = os.path.join(checkpoint_path, "trainable_state.pkl")
        if os.path.exists(state_file):
            import pickle

            with open(state_file, "rb") as f:
                state = pickle.load(f)
            data = state["data"]
            self.iteration = state.get("iteration", self.iteration)
        self.load_checkpoint(data, checkpoint_path)

    def stop(self) -> None:
        self.cleanup()

    def logdir(self) -> str:
        return self._trial_dir


class FunctionTrainable(Trainable):
    """Wraps ``def train_fn(config)`` into the Trainable contract
    (ref: function_trainable.py — fn runs in a thread; each tune.report()
    produces one train() result)."""

    _fn: Callable = None  # bound by wrap_function's subclass

    def setup(self, config: Dict[str, Any]) -> None:
        ctx = TrainContext(world_rank=0, world_size=1, local_rank=0,
                           trial_name=self.trial_name or self.trial_id)
        self._session = TrainSession(ctx, checkpoint_to_restore=None)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._finished = threading.Event()
        self._last_checkpoint: Optional[Checkpoint] = None

    def _runner(self, task_ctx) -> None:
        runtime._task_ctx.ctx = task_ctx
        init_session(self._session)
        try:
            params = inspect.signature(type(self)._fn).parameters
            if len(params) >= 1:
                type(self)._fn(self.config)
            else:
                type(self)._fn()
        except StopIteration:
            pass
        except BaseException as e:  # surfaced on the next train() call
            self._error = e
            self._error_tb = traceback.format_exc()
        finally:
            clear_session()
            runtime._task_ctx.ctx = None
            self._finished.set()

    def train(self) -> Dict[str, Any]:
        if self._thread is None:
            # The actor's identity and cards, under a context of the
            # thread's own: the train() call's context ends with the call.
            ctx = runtime.current_task_context()
            task_ctx = None if ctx is None else runtime.TaskContext(
                TaskID.from_random(), ctx.actor_id,
                gpu_ids=ctx.gpu_ids)
            self._thread = threading.Thread(target=self._runner,
                                            args=(task_ctx,), daemon=True,
                                            name=f"trial-{self.trial_id}")
            self._thread.start()
        # Block until the fn reports, or finishes.
        while True:
            try:
                item = self._session.results.get(timeout=0.05)
                break
            except Exception:
                if self._finished.is_set() and self._session.results.empty():
                    if self._error is not None:
                        raise self._error
                    item = {"metrics": {DONE: True}, "checkpoint": None, "rank": 0}
                    break
        metrics = dict(item["metrics"])
        if item["checkpoint"] is not None:
            self._last_checkpoint = item["checkpoint"]
        self.iteration += 1
        metrics.setdefault(TRAINING_ITERATION, self.iteration)
        metrics.setdefault("trial_id", self.trial_id)
        metrics.setdefault("time_total_s", time.time() - self._start_time)
        metrics.setdefault("config", self.config)
        if self._finished.is_set() and self._session.results.empty():
            metrics.setdefault(DONE, True)
        return metrics

    def save_checkpoint(self, checkpoint_dir: str) -> Optional[Dict]:
        if self._last_checkpoint is not None:
            import shutil

            for name in os.listdir(self._last_checkpoint.path):
                src = os.path.join(self._last_checkpoint.path, name)
                dst = os.path.join(checkpoint_dir, name)
                if os.path.isdir(src):
                    shutil.copytree(src, dst, dirs_exist_ok=True)
                else:
                    shutil.copy2(src, dst)
        return None

    def load_checkpoint(self, data, checkpoint_dir: str) -> None:
        self._session.checkpoint_to_restore = Checkpoint(checkpoint_dir)

    def stop(self) -> None:
        self._session.stop_requested.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self.cleanup()


def wrap_function(fn: Callable) -> type:
    """Create a FunctionTrainable subclass bound to ``fn``."""

    class _Wrapped(FunctionTrainable):
        _fn = staticmethod(fn)

    _Wrapped.__name__ = getattr(fn, "__name__", "fn")
    return _Wrapped


def with_parameters(trainable: Callable, **params: Any) -> Callable:
    """Bind large objects to a trainable outside the config dict
    (ref: tune/trainable/util.py with_parameters)."""
    if inspect.isclass(trainable):
        class _WithParams(trainable):  # type: ignore[misc]
            def setup(self, config):
                merged = dict(config)
                merged.update(params)
                super().setup(merged)

        _WithParams.__name__ = trainable.__name__
        return _WithParams

    def _fn(config):
        sig = inspect.signature(trainable)
        if len(sig.parameters) > 1:
            return trainable(config, **params)
        merged = dict(config)
        merged.update(params)
        return trainable(merged)

    _fn.__name__ = getattr(trainable, "__name__", "fn")
    return _fn
