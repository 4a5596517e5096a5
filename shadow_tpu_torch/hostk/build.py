"""Build/locate the native shim libraries (port of shadow_tpu/hostk/build.py).

The port builds the repo's `native/` sources, unchanged, into
`native/build-torch/` (`make -C native BUILD=build-torch`), a directory of
its own, so that its processes and the JAX package's never run one
`make` on the same outputs at once.
"""

from __future__ import annotations

import fcntl
import pathlib
import subprocess

_NATIVE = pathlib.Path(__file__).resolve().parent.parent.parent / "native"
_BUILD_NAME = "build-torch"
_BUILD = _NATIVE / _BUILD_NAME


def ensure_built() -> None:
    # one build at a time across processes (test workers, hybrid workers)
    _BUILD.mkdir(parents=True, exist_ok=True)
    with open(_BUILD / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        _build_if_stale()


def _build_if_stale() -> None:
    srcs = list((_NATIVE / "shim").glob("*.c")) + list((_NATIVE / "shim").glob("*.h"))
    shim = _BUILD / "libshadow_shim.so"
    host = _BUILD / "libshadow_host.so"
    if shim.exists() and host.exists():
        newest_src = max(p.stat().st_mtime for p in srcs)
        if shim.stat().st_mtime >= newest_src and host.stat().st_mtime >= newest_src:
            return
    r = subprocess.run(
        ["make", "-C", str(_NATIVE), f"BUILD={_BUILD_NAME}"], capture_output=True, text=True
    )
    if r.returncode != 0:
        raise RuntimeError(
            f"native shim build failed (make -C {_NATIVE} BUILD={_BUILD_NAME}):\n"
            f"{r.stdout}\n{r.stderr}"
        )


def shim_lib_path() -> str:
    ensure_built()
    return str(_BUILD / "libshadow_shim.so")


def host_lib_path() -> str:
    ensure_built()
    return str(_BUILD / "libshadow_host.so")
