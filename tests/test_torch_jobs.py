"""The port's job submission (``ray_tpu_torch.job``) against the
reference's: the job cases of tests/test_ops_infra.py (:166, :179, :193) on
each package in turn, then the process group, the log root and a training
job of the port's example.

Jobs need no runtime: each case runs on the reference's ``JobManager`` and
then on the port's, and the observations must be equal.
"""

import importlib
import os
import re
import signal
import sys
import time

import ray_tpu
import ray_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _job(pkg):
    return importlib.import_module(pkg.__name__ + ".job")


def _each(case, tmp_path):
    out = []
    for pkg in (ray_tpu, ray_tpu_torch):
        d = tmp_path / pkg.__name__
        d.mkdir()
        out.append(case(pkg, str(d)))
    assert out[0] == out[1], out
    return out[1]


# ---------------------------------------------- tests/test_ops_infra.py:166
def _success_logs_metadata(pkg, tmp):
    jm = _job(pkg).JobManager(log_root=tmp)
    job_id = jm.submit_job(
        f"{sys.executable} -c \"print('hello from job')\"",
        metadata={"team": "ml"})
    info = jm.get_job_info(job_id)
    return (jm.wait_job(job_id, timeout=30),
            "hello from job" in jm.get_job_logs(job_id),
            jm.get_job_info(job_id).metadata, info.return_code,
            os.path.dirname(info.log_path) == tmp)


def test_job_submit_success_logs_and_metadata(tmp_path):
    assert _each(_success_logs_metadata, tmp_path) == (
        "SUCCEEDED", True, {"team": "ml"}, 0, True)


# ---------------------------------------------- tests/test_ops_infra.py:179
def _failure_and_stop(pkg, tmp):
    jm = _job(pkg).JobManager(log_root=tmp)
    bad = jm.submit_job(f"{sys.executable} -c 'raise SystemExit(3)'")
    obs = [jm.wait_job(bad, timeout=30), jm.get_job_info(bad).return_code,
           jm.get_job_info(bad).message]
    slow = jm.submit_job(f"{sys.executable} -c 'import time; time.sleep(60)'")
    time.sleep(0.3)
    obs += [jm.stop_job(slow), jm.wait_job(slow, timeout=10),
            jm.get_job_info(slow).message, jm.stop_job(slow)]
    return obs


def test_job_failure_and_stop(tmp_path):
    assert _each(_failure_and_stop, tmp_path) == [
        "FAILED", 3, "exit code 3", True, "STOPPED", "stopped by user",
        False]


# ---------------------------------------------- tests/test_ops_infra.py:193
def _runtime_env_and_tail(pkg, tmp):
    jm = _job(pkg).JobManager(log_root=tmp)
    job_id = jm.submit_job(
        f"{sys.executable} -c \"import os; print(os.environ['JOB_VAR']); "
        f"print(os.environ['RAY_TPU_JOB_ID'])\"",
        runtime_env={"env_vars": {"JOB_VAR": "xyz"}},
        submission_id="job-tail")
    chunks = "".join(jm.tail_job_logs(job_id, poll_s=0.05))
    return (chunks.split(), jm.get_job_status(job_id),
            [j.job_id for j in jm.list_jobs()])


def test_job_runtime_env_and_tail(tmp_path):
    assert _each(_runtime_env_and_tail, tmp_path) == (
        ["xyz", "job-tail"], "SUCCEEDED", ["job-tail"])


# ------------------------------------------------------------ more of the API
def _errors(pkg, tmp):
    jm = _job(pkg).JobManager(log_root=tmp)
    jm.submit_job("true", submission_id="dup")
    obs = []
    for fn in (lambda: jm.submit_job("true", submission_id="dup"),
               lambda: jm.get_job_status("nope"),
               lambda: jm.stop_job("nope")):
        try:
            fn()
            obs.append(None)
        except ValueError as e:
            obs.append(str(e))
    obs.append(jm.wait_job("dup", timeout=30))
    missing = jm.submit_job("true", submission_id="gone")
    jm.wait_job(missing, timeout=30)
    os.remove(jm.get_job_info(missing).log_path)
    obs += [jm.get_job_logs(missing), list(jm.tail_job_logs(missing))]
    slow = jm.submit_job("sleep 30")
    try:
        jm.wait_job(slow, timeout=0.2)
    except TimeoutError as e:
        obs.append(type(e).__name__)
    jm.stop_job(slow, grace_s=1.0)
    obs.append(jm.wait_job(slow, timeout=10))
    return obs


def test_job_errors_and_missing_logs(tmp_path):
    assert _each(_errors, tmp_path) == [
        "job dup already exists", "no such job nope", "no such job nope",
        "SUCCEEDED", "", [], "TimeoutError", "STOPPED"]


def _running(pid):
    """Alive and not a zombie (an orphan's reaper may be slow to reap)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def test_stop_job_ends_the_whole_process_group(tmp_path):
    """A job's children end with it: ``stop_job`` signals the process group
    (the job runs in a session of its own) and waits for the group, not
    only its leader. The child ignores SIGTERM, so the grace period runs out
    and SIGKILL ends it. (The reference returns once the shell, the group's
    leader, has exited, and leaves such a child running: the port differs
    here, so that a stopped job's card memory comes back.)"""
    from ray_tpu_torch.job import JobManager

    jm = JobManager(log_root=str(tmp_path))
    pid_file = str(tmp_path / "child.pid")
    ready = str(tmp_path / "child.ready")
    # The child says when its handler is set: a SIGTERM that came before
    # (a loaded host can take seconds to start Python) would end it at
    # once, and the grace period would never run.
    child = ("import signal, time; signal.signal(signal.SIGTERM, "
             f"signal.SIG_IGN); open('{ready}', 'w').close(); time.sleep(60)")
    job_id = jm.submit_job(
        f"{sys.executable} -c \"{child}\" & echo $! > {pid_file}; wait")
    deadline = time.monotonic() + 30
    while not os.path.exists(ready):
        assert time.monotonic() < deadline, "the job's child never started"
        time.sleep(0.05)
    pid = int(open(pid_file).read())
    assert os.getpgid(pid) != os.getpgid(0)
    t0 = time.monotonic()
    assert jm.stop_job(job_id, grace_s=1.0)
    waited = time.monotonic() - t0
    assert jm.wait_job(job_id, timeout=10) == "STOPPED"
    deadline = time.monotonic() + 5
    while _running(pid):
        assert time.monotonic() < deadline, \
            f"the job's child {pid} outlived stop_job"
        time.sleep(0.05)
    assert 1.0 <= waited < 5.0


_ZOMBIE_MAKER = """\
import os, sys, time
zombie = os.fork()
if zombie == 0:
    os._exit(0)
os.setpgid(0, 0)  # out of the job's group; its unreaped child stays there
with open(sys.argv[1] + ".tmp", "w") as f:
    f.write(f"{os.getpid()} {zombie}")
os.rename(sys.argv[1] + ".tmp", sys.argv[1])
time.sleep(60)
"""


def _stat(pid):
    """(state, pgrp) of ``pid`` from /proc."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return fields[0], int(fields[2])


def test_stop_job_does_not_wait_for_a_group_of_zombies(tmp_path):
    """A group that holds only zombies is gone: ``stop_job`` returns once
    its live processes have ended, not after the whole grace period. The
    job's zombie is the child of a process that left the group and never
    reaps it, as an orphan waits for a reaper that may never come."""
    from ray_tpu_torch.job import JobManager

    jm = JobManager(log_root=str(tmp_path))
    script = tmp_path / "zombie_maker.py"
    script.write_text(_ZOMBIE_MAKER)
    pid_file = str(tmp_path / "pids")
    job_id = jm.submit_job(f"{sys.executable} {script} {pid_file} & wait")
    deadline = time.monotonic() + 10
    while not os.path.exists(pid_file):
        assert time.monotonic() < deadline, jm.get_job_logs(job_id)
        time.sleep(0.05)
    parent, zombie = map(int, open(pid_file).read().split())
    try:
        pgid = jm._procs[job_id].pid
        while _stat(zombie)[0] != "Z":
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert _stat(zombie)[1] == pgid and _stat(parent)[1] != pgid
        t0 = time.monotonic()
        assert jm.stop_job(job_id, grace_s=5.0)
        waited = time.monotonic() - t0
        assert jm.wait_job(job_id, timeout=10) == "STOPPED"
        assert _stat(zombie)[0] == "Z"  # still unreaped when stop returned
        assert waited < 2.5, waited
    finally:
        os.kill(parent, signal.SIGKILL)


def test_group_alive_counts_only_live_processes():
    """``_group_alive``: a live group is alive; a group whose only member
    is an exited, unreaped leader (a zombie) is gone; so is a group that
    no longer exists."""
    import subprocess

    from ray_tpu_torch.job.job_manager import _group_alive

    proc = subprocess.Popen([sys.executable, "-c", "import sys; "
                             "sys.stdin.read()"], stdin=subprocess.PIPE,
                            start_new_session=True)
    try:
        assert _group_alive(proc.pid)
        proc.stdin.close()
        deadline = time.monotonic() + 10
        while _stat(proc.pid)[0] != "Z":
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert not _group_alive(proc.pid)
    finally:
        proc.kill()
        proc.wait()
    assert not _group_alive(proc.pid)


def test_default_log_root_is_the_sessions(tmp_path, monkeypatch):
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch.job import job_manager as make_manager
    from ray_tpu_torch.job.job_manager import default_log_root

    monkeypatch.setattr(GLOBAL_CONFIG, "session_dir", str(tmp_path))
    assert default_log_root() == str(tmp_path / "job_logs")
    mod = importlib.import_module("ray_tpu_torch.job.job_manager")
    monkeypatch.setattr(mod, "_MANAGER", None)
    jm = make_manager()
    assert jm is make_manager()
    job_id = jm.submit_job("echo hi")
    assert jm.wait_job(job_id, timeout=30) == "SUCCEEDED"
    assert jm.get_job_info(job_id).log_path == str(
        tmp_path / "job_logs" / f"{job_id}.log")


def test_training_job_of_the_example(tmp_path):
    """The port's training example as a job on the CPU: it succeeds and its
    log holds a line per step and the summary (chip_smoke.py's
    ``workflow_fit`` runs it on the card)."""
    from ray_tpu_torch.job import JobManager

    jm = JobManager(log_root=str(tmp_path))
    job_id = jm.submit_job(
        f"cd {REPO} && {sys.executable} -m ray_tpu_torch.examples.train_gpt2 "
        "--device cpu --tiny --workers 1 --steps 2")
    assert jm.wait_job(job_id, timeout=180) == "SUCCEEDED", \
        jm.get_job_logs(job_id)[-3000:]
    logs = jm.get_job_logs(job_id)
    steps = re.findall(r"^train_gpt2 step (\d+) loss ([0-9.]+)$", logs, re.M)
    assert [int(s) for s, _ in steps] == [1, 2]
    summary = re.search(r"losses=\[([^\]]*)\].* OK$", logs, re.M)
    assert summary is not None, logs[-2000:]
    assert [round(float(x), 4) for _, x in steps] == [
        float(x) for x in summary.group(1).split(",")]
