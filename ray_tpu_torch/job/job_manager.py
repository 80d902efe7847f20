"""Job submission: run driver scripts as supervised subprocesses (the
counterpart of ``ray_tpu/job/job_manager.py``).

Counterpart of the reference's job subsystem (ref: dashboard/modules/job/ —
JobManager:59 in job_manager.py, JobSupervisor:54 in job_supervisor.py, `ray
job` CLI in cli.py): submit an entrypoint, get a job id back immediately,
poll status, stream logs from the per-job log file, stop the job.  The
supervisor role (a detached actor in the reference) is a monitor thread per
job here; drivers are real OS processes so a crashing job can't take the
submitter down, and each job gets the runtime-env treatment (env_vars /
working_dir) via its process environment.  A job inherits the submitter's
environment (its ``CUDA_VISIBLE_DEVICES`` included) and working directory,
and runs in a session of its own: ``stop_job`` signals the whole process
group, so every process of the job ends and its cards' memory comes back.
"""

from __future__ import annotations

import os
import signal
import subprocess
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"

    TERMINAL = (SUCCEEDED, FAILED, STOPPED)


@dataclass
class JobInfo:
    job_id: str
    entrypoint: str
    status: str = JobStatus.PENDING
    message: str = ""
    start_time: float = 0.0
    end_time: Optional[float] = None
    log_path: str = ""
    metadata: Dict[str, str] = field(default_factory=dict)
    return_code: Optional[int] = None

    def to_dict(self) -> dict:
        return dict(self.__dict__)


class JobManager:
    def __init__(self, log_root: Optional[str] = None):
        self._jobs: Dict[str, JobInfo] = {}
        self._procs: Dict[str, subprocess.Popen] = {}
        self._lock = threading.Lock()
        self._log_root = log_root or default_log_root()
        os.makedirs(self._log_root, exist_ok=True)

    # ---------------------------------------------------------------- submit
    def submit_job(self, entrypoint: str,
                   runtime_env: Optional[dict] = None,
                   metadata: Optional[Dict[str, str]] = None,
                   submission_id: Optional[str] = None) -> str:
        """Start `entrypoint` (a shell command) as a supervised subprocess.

        Returns the job id immediately (ref: JobManager.submit_job)."""
        job_id = submission_id or f"raytpu-job-{uuid.uuid4().hex[:10]}"
        with self._lock:
            if job_id in self._jobs:
                raise ValueError(f"job {job_id} already exists")
            info = JobInfo(
                job_id=job_id, entrypoint=entrypoint,
                log_path=os.path.join(self._log_root, f"{job_id}.log"),
                metadata=dict(metadata or {}))
            self._jobs[job_id] = info

        env = dict(os.environ)
        cwd = None
        if runtime_env:
            from ray_tpu_torch._private.runtime_env import RuntimeEnv

            renv = RuntimeEnv.normalize(runtime_env)
            staged = renv.stage()
            env.update(staged.get("env_vars", {}))
            if staged.get("working_dir"):
                cwd = staged["working_dir"]
            if staged.get("py_modules"):
                extra = os.pathsep.join(staged["py_modules"])
                env["PYTHONPATH"] = extra + os.pathsep + env.get("PYTHONPATH", "")
        env["RAY_TPU_JOB_ID"] = job_id

        log_f = open(info.log_path, "wb")
        try:
            proc = subprocess.Popen(
                entrypoint, shell=True, stdout=log_f, stderr=subprocess.STDOUT,
                env=env, cwd=cwd, start_new_session=True)
        except OSError as e:
            log_f.close()
            with self._lock:
                info.status = JobStatus.FAILED
                info.message = f"failed to start: {e}"
                info.end_time = time.time()
            return job_id
        with self._lock:
            info.status = JobStatus.RUNNING
            info.start_time = time.time()
            self._procs[job_id] = proc
        threading.Thread(target=self._supervise, args=(job_id, proc, log_f),
                         name=f"job-supervisor-{job_id}", daemon=True).start()
        return job_id

    def _supervise(self, job_id: str, proc: subprocess.Popen, log_f) -> None:
        """The JobSupervisor role: wait for exit, record the outcome."""
        rc = proc.wait()
        log_f.close()
        with self._lock:
            info = self._jobs[job_id]
            self._procs.pop(job_id, None)
            info.end_time = time.time()
            info.return_code = rc
            if info.status == JobStatus.STOPPED:
                return
            if rc == 0:
                info.status = JobStatus.SUCCEEDED
            else:
                info.status = JobStatus.FAILED
                info.message = f"exit code {rc}"

    # ----------------------------------------------------------------- query
    def get_job_status(self, job_id: str) -> str:
        return self._get(job_id).status

    def get_job_info(self, job_id: str) -> JobInfo:
        return self._get(job_id)

    def list_jobs(self) -> List[JobInfo]:
        with self._lock:
            return list(self._jobs.values())

    def get_job_logs(self, job_id: str) -> str:
        info = self._get(job_id)
        try:
            with open(info.log_path, "r", errors="replace") as f:
                return f.read()
        except FileNotFoundError:
            return ""

    def tail_job_logs(self, job_id: str, poll_s: float = 0.2):
        """Generator of log chunks until the job reaches a terminal state
        (ref: `ray job logs -f`)."""
        info = self._get(job_id)
        pos = 0
        while True:
            try:
                with open(info.log_path, "r", errors="replace") as f:
                    f.seek(pos)
                    chunk = f.read()
                    pos = f.tell()
            except FileNotFoundError:
                chunk = ""
            if chunk:
                yield chunk
            if self.get_job_status(job_id) in JobStatus.TERMINAL and not chunk:
                return
            time.sleep(poll_s)

    def wait_job(self, job_id: str, timeout: Optional[float] = None) -> str:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            status = self.get_job_status(job_id)
            if status in JobStatus.TERMINAL:
                return status
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"job {job_id} still {status}")
            time.sleep(0.05)

    # ------------------------------------------------------------------ stop
    def stop_job(self, job_id: str, grace_s: float = 3.0) -> bool:
        """SIGTERM the job's process group, SIGKILL what is left of the
        group after grace (ref: JobSupervisor.stop)."""
        with self._lock:
            info = self._jobs.get(job_id)
            proc = self._procs.get(job_id)
            if info is None:
                raise ValueError(f"no such job {job_id}")
            if proc is None or proc.poll() is not None:
                # Already exited — let the supervisor record the real
                # outcome instead of overwriting it with STOPPED.
                return False
            info.status = JobStatus.STOPPED
            info.message = "stopped by user"
        try:
            os.killpg(proc.pid, signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            return True
        # Until the whole group is gone, not only its leader: a child that
        # outlives the shell would keep its card's memory (the reference
        # returns once the leader exits).
        deadline = time.monotonic() + grace_s
        while time.monotonic() < deadline:
            if proc.poll() is not None and not _group_alive(proc.pid):
                return True
            time.sleep(0.05)
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        return True

    def _get(self, job_id: str) -> JobInfo:
        with self._lock:
            info = self._jobs.get(job_id)
        if info is None:
            raise ValueError(f"no such job {job_id}")
        return info


def _group_alive(pgid: int) -> bool:
    """Whether a live process is left in the process group. A zombie holds
    no memory and may wait long for its reaper (an orphan's reaper may
    never come), so a group of zombies counts as gone."""
    try:
        os.killpg(pgid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    try:
        pids = [name for name in os.listdir("/proc") if name.isdigit()]
    except OSError:  # no procfs: the group is there, zombies or not
        return True
    for pid in pids:
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # state, ppid, pgrp follow the command name, which may hold ")"
        fields = stat[stat.rindex(")") + 2:].split()
        if int(fields[2]) == pgid and fields[0] not in ("Z", "X"):
            return True
    return False


_MANAGER: Optional[JobManager] = None
_MANAGER_LOCK = threading.Lock()


def job_manager() -> JobManager:
    global _MANAGER
    with _MANAGER_LOCK:
        if _MANAGER is None:
            _MANAGER = JobManager()
        return _MANAGER


def default_log_root() -> str:
    """The on-disk job-log directory, ``<session_dir>/job_logs``."""
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    return os.path.join(GLOBAL_CONFIG.session_dir, "job_logs")
