"""Runtime environments: per-task/actor execution environments (the
counterpart of ``ray_tpu/_private/runtime_env.py``; ref:
python/ray/_private/runtime_env/ — plugin.py, working_dir.py, py_modules.py, pip.py;
raylet AgentManager asks a Python agent to materialize envs, worker_pool.h
caches workers keyed by the env).  Single-host model: envs are materialized
into a session-local cache directory (the URI-cache role, uri_cache.py) and
applied inside *process-tier* workers — a task carrying a runtime_env is
automatically routed to the process pool, whose leases are keyed by the env
hash exactly like the reference's runtime-env-keyed worker caching.

Supported fields:
  env_vars:    {str: str} exported in the worker
  working_dir: local directory staged into the cache and chdir'd into
  py_modules:  list of local module/package paths prepended to sys.path
  pip / uv:    list of requirements, materialized OFFLINE into a real
               content-keyed virtualenv from a local wheel cache
               (``pip install --no-index --find-links``; ref: pip.py:122
               _install_pip_packages + uri_cache.py).  The wheel source is
               runtime_env["config"]["pip_find_links"] or
               $RAY_TPU_WHEEL_CACHE; TRUE network installs (no local
               wheel source) remain gated with a clear error.  Workers
               activate the venv by site-dir injection (packages shadow
               the host's), not interpreter re-exec — the process pool
               spawns via multiprocessing, whose executable is global.
  conda:       rejected (it needs a conda toolchain and the network)
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
import threading
from typing import Any, Dict, Optional

_CACHE_LOCK = threading.Lock()


def _cache_root() -> str:
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    root = os.path.join(GLOBAL_CONFIG.session_dir, "runtime_envs")
    os.makedirs(root, exist_ok=True)
    return root


class RuntimeEnv(dict):
    """Validated runtime-env dict (ref: ray.runtime_env.RuntimeEnv)."""

    _ALLOWED = {"env_vars", "working_dir", "py_modules", "pip", "conda",
                "uv", "config"}
    _GATED = ("conda",)

    def __init__(self, **kwargs):
        super().__init__()
        for k, v in kwargs.items():
            if v is not None:
                self[k] = v
        self.validate()

    @classmethod
    def normalize(cls, obj) -> Optional["RuntimeEnv"]:
        if obj is None:
            return None
        if isinstance(obj, RuntimeEnv):
            obj.validate()
            return obj
        if isinstance(obj, dict):
            return cls(**obj)
        raise TypeError(f"runtime_env must be a dict, got {type(obj)}")

    def validate(self) -> None:
        unknown = set(self) - self._ALLOWED
        if unknown:
            raise ValueError(f"unknown runtime_env fields: {sorted(unknown)}")
        for gated in self._GATED:
            if self.get(gated):
                raise RuntimeError(
                    f"runtime_env[{gated!r}] needs a conda install, which "
                    "the runtime does not do (it installs offline only); "
                    "pre-bake dependencies or use py_modules/working_dir")
        if self.get("pip") and self.get("uv"):
            raise ValueError("runtime_env: specify pip OR uv, not both")
        for field in ("pip", "uv"):
            spec = self.get(field)
            if spec is None:
                continue
            pkgs = spec.get("packages") if isinstance(spec, dict) else spec
            if not (isinstance(pkgs, list)
                    and all(isinstance(p, str) for p in pkgs)):
                raise ValueError(
                    f"runtime_env[{field!r}] must be a list of requirement "
                    "strings (or {'packages': [...]})")
        ev = self.get("env_vars", {})
        if not isinstance(ev, dict) or not all(
                isinstance(k, str) and isinstance(v, str)
                for k, v in ev.items()):
            raise ValueError("env_vars must be Dict[str, str]")
        wd = self.get("working_dir")
        if wd is not None and not os.path.isdir(wd):
            raise ValueError(f"working_dir {wd!r} is not a directory")
        for p in self.get("py_modules", ()):
            if not os.path.exists(p):
                raise ValueError(f"py_modules path {p!r} does not exist")

    def env_key(self) -> str:
        """Stable hash of the declared env (worker-pool lease key; prefer
        payload_key(stage()) which also captures working_dir content)."""
        return hashlib.sha1(
            json.dumps(self, sort_keys=True).encode()).hexdigest()[:16]

    # ------------------------------------------------------------- staging
    def stage(self) -> dict:
        """Materialize (driver side): copy working_dir into the session cache
        once per content key; return the payload shipped to workers.
        Memoized per instance with a 5 s TTL: stage() sits on the
        task-submission hot path (the pip/uv content key re-walks the wheel
        cache), while the TTL keeps the content-fingerprint freshness that
        lets an edited working_dir produce a new lease key mid-session."""
        import time as _time

        cached = getattr(self, "_staged", None)
        if cached is not None and _time.monotonic() < cached[0]:
            return cached[1]
        payload: Dict[str, Any] = {"env_vars": dict(self.get("env_vars", {}))}
        wd = self.get("working_dir")
        if wd:
            payload["working_dir"] = _stage_dir(os.path.abspath(wd))
        mods = [os.path.abspath(p) for p in self.get("py_modules", ())]
        if mods:
            payload["py_modules"] = mods
            # Content-fingerprint each module like working_dir, so editing a
            # module produces a new lease key instead of silently reusing a
            # cached worker that already imported the stale code.
            payload["py_modules_fingerprint"] = [
                _dir_fingerprint(p) if os.path.isdir(p) else _file_fingerprint(p)
                for p in mods
            ]
        for installer in ("pip", "uv"):
            if self.get(installer):
                payload.update(
                    _materialize_venv(self[installer], installer,
                                      self.get("config") or {}))
                break
        self._staged = (_time.monotonic() + 5.0, payload)
        return payload


def _find_links_dir(config: dict) -> Optional[str]:
    d = config.get("pip_find_links") or os.environ.get("RAY_TPU_WHEEL_CACHE")
    return os.path.abspath(d) if d else None


def _materialize_venv(spec, installer: str, config: dict) -> dict:
    """Build (once) a real virtualenv holding `spec`'s requirements from a
    LOCAL wheel cache, content-keyed by (installer, requirements, wheel-dir
    fingerprint) — the uri_cache.py role.  Returns payload fields; workers
    activate via site-dir injection (apply_in_worker)."""
    import subprocess
    import venv as venv_mod

    pkgs = sorted(spec.get("packages") if isinstance(spec, dict) else spec)
    find_links = _find_links_dir(config)
    if find_links is None or not os.path.isdir(find_links):
        raise RuntimeError(
            f"runtime_env[{installer!r}] would need a NETWORK package "
            "install, which the runtime does not do (it installs "
            "offline only). Provide a local wheel cache via runtime_env['config']"
            "['pip_find_links'] or $RAY_TPU_WHEEL_CACHE "
            f"(got {find_links!r}), or pre-bake dependencies.")
    key = hashlib.sha1(
        f"{installer}:{json.dumps(pkgs)}:{_dir_fingerprint(find_links)}"
        .encode()).hexdigest()[:16]
    venv_dir = os.path.join(_cache_root(), "venvs", key)
    py = os.path.join(venv_dir, "bin", "python")
    with _CACHE_LOCK:
        if not os.path.isdir(venv_dir):
            tmp = venv_dir + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(os.path.dirname(venv_dir), exist_ok=True)
            uv_bin = shutil.which("uv") if installer == "uv" else None
            try:
                if uv_bin:
                    # blocking_ok: build-once cache; the lock exists to serialize concurrent builders
                    subprocess.run([uv_bin, "venv", "--python",
                                    sys.executable,
                                    "--system-site-packages", tmp],
                                   check=True, capture_output=True,
                                   text=True, timeout=120)
                    cmd = [uv_bin, "pip", "install", "--offline",
                           "--no-index", "--find-links", find_links,
                           "--python", os.path.join(tmp, "bin", "python"),
                           *pkgs]
                else:
                    # venv without pip (ensurepip is slow); drive the HOST
                    # pip against the venv interpreter (pip >= 22.3).
                    venv_mod.create(tmp, system_site_packages=True,
                                    with_pip=False, symlinks=True)
                    cmd = [sys.executable, "-m", "pip", "--python",
                           os.path.join(tmp, "bin", "python"), "install",
                           "--no-index", "--find-links", find_links, *pkgs]
                subprocess.run(cmd, check=True, capture_output=True,  # blocking_ok: build-once cache, see above
                               text=True, timeout=300)
            except (subprocess.CalledProcessError,
                    subprocess.TimeoutExpired, OSError) as e:
                shutil.rmtree(tmp, ignore_errors=True)
                detail = (getattr(e, "stderr", "") or str(e))[-800:]
                raise RuntimeError(
                    f"runtime_env[{installer!r}] install failed for {pkgs} "
                    f"from {find_links}: {detail}") from e
            os.replace(tmp, venv_dir)
    site_dirs = [
        os.path.join(venv_dir, "lib", d, "site-packages")
        for d in os.listdir(os.path.join(venv_dir, "lib"))
        if d.startswith("python")
    ] if os.path.isdir(os.path.join(venv_dir, "lib")) else []
    return {"venv_dir": venv_dir, "venv_python": py,
            "venv_site": site_dirs[0] if site_dirs else None,
            "venv_key": key}


def _file_fingerprint(path: str) -> str:
    try:
        stat = os.stat(path)
        tail = f"{stat.st_mtime_ns}:{stat.st_size}"
    except OSError:
        tail = "missing"
    return hashlib.sha1(f"{path}:{tail}".encode()).hexdigest()[:16]


def _dir_fingerprint(src: str) -> str:
    """Content fingerprint: every file's relpath+mtime+size.  (Directory
    mtime alone misses in-place edits to contained files.)"""
    h = hashlib.sha1(src.encode())
    for root, dirs, files in os.walk(src):
        dirs[:] = sorted(d for d in dirs if d not in (".git", "__pycache__"))
        for name in sorted(files):
            p = os.path.join(root, name)
            try:
                stat = os.stat(p)
            except OSError:
                continue
            h.update(f"{os.path.relpath(p, src)}:{stat.st_mtime_ns}:"
                     f"{stat.st_size};".encode())
    return h.hexdigest()[:16]


def _stage_dir(src: str) -> str:
    """Copy `src` into the cache keyed by content (URI cache equivalent —
    repeated leases reuse the staged copy; edits re-stage)."""
    stamp = _dir_fingerprint(src)
    dst = os.path.join(_cache_root(), stamp)
    with _CACHE_LOCK:
        if not os.path.isdir(dst):
            tmp = dst + ".tmp"
            shutil.copytree(src, tmp,
                            ignore=shutil.ignore_patterns(".git", "__pycache__"))
            os.replace(tmp, dst)
    return dst


def payload_key(payload: dict) -> str:
    """Lease key from the *staged* payload: the working_dir path in it is
    content-stamped, so editing files yields a fresh key (and worker)."""
    return hashlib.sha1(
        json.dumps(payload, sort_keys=True).encode()).hexdigest()[:16]


def apply_in_worker(payload: dict) -> None:
    """Apply a staged env inside a (process-tier) worker."""
    for k, v in payload.get("env_vars", {}).items():
        os.environ[k] = v
    vs = payload.get("venv_site")
    if vs:
        import site

        prev = set(sys.path)
        site.addsitedir(vs)  # honors .pth files, unlike a bare insert
        fresh = [p for p in sys.path if p not in prev]
        # Venv packages must SHADOW same-named host packages.
        sys.path[:] = fresh + [p for p in sys.path if p not in fresh]
        os.environ["VIRTUAL_ENV"] = payload.get("venv_dir", "")
    for p in reversed(payload.get("py_modules", [])):
        if p not in sys.path:
            sys.path.insert(0, p)
    wd = payload.get("working_dir")
    if wd:
        if wd not in sys.path:
            sys.path.insert(0, wd)
        os.chdir(wd)
