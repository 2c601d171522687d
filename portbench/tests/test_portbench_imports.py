"""(b) Nothing the benchmark runs loads JAX or the JAX package; the reference loads nothing of the program.

Top-level module names are compared whole: ``valor_tpu_torch`` is not ``valor_tpu``.
"""

from __future__ import annotations

import ast
import json
import subprocess
import sys
import textwrap

from portbench import harness

JAX = {"jax", "jaxlib", "flax", "valor_tpu"}


def _imports(path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_sources_import_no_jax_and_the_reference_nothing_of_the_program():
    for path in harness.HERE.rglob("*.py"):
        if "tests" in path.relative_to(harness.HERE).parts:
            continue
        names = _imports(path)
        assert not names & JAX, (path, names & JAX)
        if "reference" in path.relative_to(harness.HERE).parts:
            assert not {n for n in names if n.startswith("valor")}, (path, names)


def test_reference_modules_import_nothing_of_the_program():
    code = textwrap.dedent("""
        import json, sys
        sys.path.insert(0, %r)
        import portbench.reference.model, portbench.reference.adamw, portbench.reference.fbank
        print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
    """ % str(harness.ROOT))
    names = set(json.loads(subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                                          check=True).stdout.splitlines()[-1]))
    assert not names & (JAX | {"valor_tpu_torch"}), names


def test_a_run_of_each_kind_loads_no_jax():
    code = textwrap.dedent("""
        import json, sys, time
        sys.path.insert(0, %r)
        import torch
        from portbench import harness
        from portbench.tests import tiny
        harness.require_cuda = lambda chips: torch
        harness.device = lambda t: t.device("cpu")
        from portbench.kinds import pretrain, serve
        pretrain.run(tiny.spec("base-pretrain", tiny.TINY, tiny.PRETRAIN), 3, 0.5, True, time.monotonic())
        serve.run(tiny.spec("base-serve", tiny.TINY, tiny.SERVE), 4, 0.5, True, time.monotonic())
        print(json.dumps(harness.forbidden_modules()))
    """ % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.splitlines()[-1]) == []
