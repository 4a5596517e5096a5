"""The PyTorch port imports no JAX: shadow_tpu_torch/ and chip_smoke.py
never import jax, flax or the JAX package (importing any shadow_tpu.*
module runs shadow_tpu/__init__.py, which imports jax). The host-side
observability modules (OBSERVABILITY: the tracker registry, the flight
recorder, the memory observatory), the run-loop guards and cpu-ref
oracles (GUARDS) and the managed-process modules (MANAGED: the host
kernel, the device plane's model, the hybrid schedulers and their
workers, pcap) and the services (SERVICES: sweep specs, the compile
cache, the sweep scheduler, the daemon, its HTTP front door) and the
multi-device planes (MULTI_DEVICE: the logical devices, the sharded
engine, the 2-D mesh and its runner) are named on their own: each is
imported alone in a fresh interpreter, and each is in the source scan."""

import ast
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "shadow_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "shadow_tpu")
OBSERVABILITY = (
    "shadow_tpu_torch.utils.tracker",
    "shadow_tpu_torch.runtime.flightrec",
    "shadow_tpu_torch.runtime.memtrack",
)
# the run-loop guards and the cpu-ref oracles
GUARDS = (
    "shadow_tpu_torch.runtime.chaos",
    "shadow_tpu_torch.runtime.autotune",
    "shadow_tpu_torch.runtime.scheduler",
    "shadow_tpu_torch.cpu_ref",
    "shadow_tpu_torch.cpu_ref.netstack_ref",
    "shadow_tpu_torch.cpu_ref.tcp_ref",
    "shadow_tpu_torch.cpu_ref.sim",
    "shadow_tpu_torch.cpu_ref.tgen_ref",
    "shadow_tpu_torch.cpu_ref.bulk_ref",
)
# managed processes: the host kernel, the hybrid's device plane and workers
MANAGED = (
    "shadow_tpu_torch.hostk",
    "shadow_tpu_torch.hostk.build",
    "shadow_tpu_torch.hostk.descriptor",
    "shadow_tpu_torch.hostk.dns",
    "shadow_tpu_torch.hostk.guestmem",
    "shadow_tpu_torch.hostk.ipc",
    "shadow_tpu_torch.hostk.kernel",
    "shadow_tpu_torch.hostk.shaping",
    "shadow_tpu_torch.hostk.strace",
    "shadow_tpu_torch.hostk.tcp",
    "shadow_tpu_torch.models.managed_net",
    "shadow_tpu_torch.runtime.hybrid",
    "shadow_tpu_torch.runtime.hybrid_worker",
    "shadow_tpu_torch.utils.pcap",
)
# the services: sweep specs, the compile cache, the sweep scheduler, the
# daemon and its HTTP front door
SERVICES = (
    "shadow_tpu_torch.config.sweep",
    "shadow_tpu_torch.runtime.compile_cache",
    "shadow_tpu_torch.runtime.sweep",
    "shadow_tpu_torch.runtime.daemon",
    "shadow_tpu_torch.runtime.httpapi",
)

# the multi-device planes: logical devices, the sharded engine, the mesh
MULTI_DEVICE = (
    "shadow_tpu_torch.device",
    "shadow_tpu_torch.engine.sharded",
    "shadow_tpu_torch.engine.mesh",
    "shadow_tpu_torch.runtime.mesh",
)


def _forbidden(module: str) -> bool:
    # exact package names: shadow_tpu_torch merely starts with "shadow_tpu"
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_import_pulls_in_no_jax():
    """A fresh interpreter (this one has jax loaded by conftest) imports
    the port and every submodule, plus chip_smoke: none of them loads a
    jax, flax or shadow_tpu module."""
    code = (
        "import importlib, pkgutil, sys\n"
        "before = set(sys.modules)\n"
        "import shadow_tpu_torch\n"
        "for m in pkgutil.walk_packages(shadow_tpu_torch.__path__, 'shadow_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in set(sys.modules) - before\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'shadow_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path}: imports {bad}"


@pytest.mark.parametrize("module", OBSERVABILITY + GUARDS + MANAGED + SERVICES + MULTI_DEVICE)
def test_observability_module_imports_no_jax(module):
    """A fresh interpreter imports the module alone (and through it what
    it needs of the port): no jax, flax or shadow_tpu module loads, and
    the module's file is one the source scan covers."""
    code = (
        "import importlib, sys\n"
        f"m = importlib.import_module({module!r})\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'shadow_tpu'))\n"
        "assert not bad, bad\n"
        "print(m.__file__)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert pathlib.Path(out.stdout.strip()).resolve() in {p.resolve() for p in PORT_FILES}


def test_forbidden_names_are_exact():
    assert _forbidden("shadow_tpu.engine") and _forbidden("jax.numpy")
    assert not _forbidden("shadow_tpu_torch.engine") and not _forbidden("jaxtyping")
