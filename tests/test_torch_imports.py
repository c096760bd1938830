"""The port stands alone: ``src/repro_torch``, ``chip_smoke.py`` and
the port's examples (``examples/*_torch.py``) import neither JAX nor
anything of the JAX package ``repro``.

One check imports every port module, and another the examples, in a
fresh interpreter whose import system refuses ``jax``, ``jaxlib`` and
``repro``; the last scans the sources for such imports.
"""
import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
BANNED = ("jax", "jaxlib", "repro")
EXAMPLES = sorted((ROOT / "examples").glob("*_torch.py"))
# the training slice's modules, which the walk below must reach
TRAINING = ("repro_torch.data.lm_data", "repro_torch.training.optimizer",
            "repro_torch.training.checkpoint", "repro_torch.launch.train")
# the dry-run slice's modules, likewise
DRYRUN = ("repro_torch.launch.dryrun", "repro_torch.roofline.analysis",
          "repro_torch.roofline.hlo_cost")

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
assert set({TRAINING!r}) <= set(names), sorted(names)
assert set({DRYRUN!r}) <= set(names), sorted(names)
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
    assert int(out.stdout.strip()) >= 70


_BLOCKED_DRYRUN = f"""
import runpy, sys

BANNED = {BANNED!r}

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("blocked import of " + name)
        return None

sys.meta_path.insert(0, Refuse())
sys.argv = ["dryrun", "--arch", "qwen3-0.6b", "--shape", "decode_32k",
            "--mesh", "single", "--out", sys.argv[1]]
try:
    runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
except SystemExit as exc:
    assert exc.code == 0, exc.code
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
assert not leaked, leaked
"""


def test_the_dryrun_counts_a_cell_with_jax_and_repro_blocked(tmp_path):
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_DRYRUN, str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert (tmp_path / "qwen3-0.6b__decode_32k__pod16x16.json").exists()


_BLOCKED_EXAMPLES = f"""
import importlib.util, sys

BANNED = {BANNED!r}

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("blocked import of " + name)
        return None

sys.meta_path.insert(0, Refuse())
for path in {[str(p) for p in EXAMPLES]!r}:
    spec = importlib.util.spec_from_file_location("example", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
assert not leaked, leaked
print(len({[str(p) for p in EXAMPLES]!r}))
"""


def test_the_port_examples_import_with_jax_and_repro_blocked():
    assert [p.name for p in EXAMPLES] == ["motif_features_gnn_torch.py",
                                          "quickstart_torch.py",
                                          "serve_queries_torch.py",
                                          "train_lm_torch.py"]
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_EXAMPLES], capture_output=True,
        text=True, timeout=120, cwd=ROOT, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == 4


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_jax_or_repro_import_in_the_sources():
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + EXAMPLES)
    assert len(files) > 25
    for path in files:
        bad = _imported_roots(path) & set(BANNED)
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"
