"""What a run may load: never jax, jaxlib, flax or phys_autodiff_tpu (by
whole top-level name), and the reference nothing of the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from portbench.core.harness import FORBIDDEN
from portbench.tests.conftest import ROOT

PROGRAM = "phys_autodiff_tpu_torch"
#: What the reference's modules may import (of portbench: the reference).
REFERENCE_MAY_IMPORT = ("torch", "numpy", "portbench", "__future__", "dataclasses", "math", "importlib")

_DRIVE = """
import json, sys, time, torch
sys.path.insert(0, {root!r})
from portbench.core import harness
from portbench.tests.conftest import small_cell
import io
for name in ("mlp_train_256", "ngp_fit_256", "mlp_serve_256"):
    for trace in (False, True):
        harness.run_cell(small_cell(name), 1, 0.1, trace, torch.device("cpu"), time.perf_counter(),
                         out=io.StringIO(), err=io.StringIO())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_no_forbidden_module():
    proc = subprocess.run([sys.executable, "-c", _DRIVE.format(root=str(ROOT))], capture_output=True, text=True,
                          cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    tops = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert PROGRAM in tops  # the program ran
    assert not tops & set(FORBIDDEN)


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((ROOT / "portbench" / "reference").glob("*.py"))
    assert files
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top in REFERENCE_MAY_IMPORT, (f.name, name)
            if top == "portbench":
                assert name.startswith("portbench.reference"), (f.name, name)
    # reference/train.py finds a family's module by name: import every one.
    code = ("import sys, json, importlib; sys.path.insert(0, %r); "
            "[importlib.import_module('portbench.reference.' + n) for n in %r]; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
            % (str(ROOT), [f.stem for f in files if f.stem != "__init__"]))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    tops = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert PROGRAM not in tops and not tops & set(FORBIDDEN)


def test_a_family_imports_the_program_only_when_called():
    """Loading families/<name>.py loads nothing of the program: each of its
    functions that needs the port imports it itself."""
    names = sorted(f.stem for f in (ROOT / "portbench" / "families").glob("*.py"))
    assert names
    code = ("import sys, json; sys.path.insert(0, %r); from portbench.core import specs; "
            "[specs.family(n) for n in %r]; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))" % (str(ROOT), names))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    tops = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert PROGRAM not in tops and not tops & set(FORBIDDEN)
