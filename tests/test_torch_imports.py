"""The port stands alone: ``repro_torch``, ``chip_smoke.py`` and the
port's tools (``tools/*.py``) import neither JAX nor anything of the
reference package ``repro``."""
from __future__ import annotations

import ast
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
SOURCES = (sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
           + sorted((REPO / "tools").glob("*.py")))

_BLOCKED_IMPORT = r"""
import importlib, importlib.util, pkgutil, sys
sys.modules["jax"] = None        # any import of jax or repro now raises
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
loaded = [m for m, mod in sys.modules.items() if mod is not None and
          (m.split(".")[0] in ("jax", "jaxlib", "repro"))]
assert not loaded, loaded
print(len(names))
"""


def test_port_imports_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT, str(REPO / "chip_smoke.py")],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 20     # every module was walked


def _imported_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(REPO)) for p in SOURCES])
def test_no_source_of_the_port_imports_jax_or_repro(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


NETSIM_MODULES = ("repro_torch.netsim", "repro_torch.netsim.conditions",
                  "repro_torch.netsim.events", "repro_torch.netsim.gossip",
                  "repro_torch.netsim.timing",
                  "repro_torch.netsim.diagnostics",
                  "repro_torch.core.netwire")


def test_the_walk_covers_the_network_simulation():
    """The blocked-import walk above reaches the netsim modules."""
    import pkgutil

    import repro_torch
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert set(NETSIM_MODULES) <= names


OBS_MODULES = ("repro_torch.obs", "repro_torch.obs.frame",
               "repro_torch.obs.trace", "repro_torch.obs.health",
               "repro_torch.obs.report", "repro_torch.obs.evalframe",
               "repro_torch.obs.sink")


def test_the_walk_covers_the_telemetry():
    """The blocked-import walk above reaches the obs modules, and each of
    them is a source the per-file check reads."""
    import pkgutil

    import repro_torch
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert set(OBS_MODULES) <= names
    files = {str(p.relative_to(PORT)) for p in SOURCES if PORT in p.parents}
    assert {"obs/frame.py", "obs/trace.py", "obs/health.py",
            "obs/report.py", "obs/__init__.py"} <= files
