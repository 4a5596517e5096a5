"""The PyTorch port imports no JAX: shadow_tpu_torch/ and chip_smoke.py
never import jax, flax or the JAX package (importing any shadow_tpu.*
module runs shadow_tpu/__init__.py, which imports jax). The host-side
observability modules (OBSERVABILITY: the tracker registry, the flight
recorder, the memory observatory) are named on their own: each is
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


@pytest.mark.parametrize("module", OBSERVABILITY)
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
