"""The port stands alone: ``src/repro_torch`` and ``chip_smoke.py``
import neither JAX nor anything of the JAX package ``repro``.

One check imports every port module in a fresh interpreter whose import
system refuses ``jax``, ``jaxlib`` and ``repro``; the other scans the
sources for such imports.
"""
import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
BANNED = ("jax", "jaxlib", "repro")

_BLOCKED_IMPORT = f"""
import importlib, pkgutil, sys

BANNED = {BANNED!r}

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("blocked import of " + name)
        return None

sys.meta_path.insert(0, Refuse())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import repro_torch.api as api
api.MatchSession, api.MatchOptions, api.QueueFull
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
assert not leaked, leaked
print(len(names))
"""


def test_every_port_module_imports_with_jax_and_repro_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT], capture_output=True,
        text=True, timeout=120, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 47


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_jax_or_repro_import_in_the_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 25
    for path in files:
        bad = _imported_roots(path) & set(BANNED)
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"
