"""Import purity of the port: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor anything of the JAX package ``repro``, nor ``msgpack``
(the card's machine has none; the checkpointer carries its own codec).

A fresh interpreter imports every module of the port and ``chip_smoke.py``
as a module, then reports what ended up in ``sys.modules``; an AST scan of
the sources rejects the import statements themselves (including ones a
function would only run later).
"""
import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _modules():
    out = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        out.append(".".join(parts))
    return out


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = (
        "import importlib, importlib.util, json, sys\n"
        f"sys.path.insert(0, {str(REPO / 'src')!r})\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "spec = importlib.util.spec_from_file_location(\n"
        f"    'chip_smoke', {str(REPO / 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "repro_torch.fed.simulation" in loaded
    assert not [m for m in loaded if m == "jax" or m.startswith("jax.")]
    assert not [m for m in loaded if m == "repro" or m.startswith("repro.")]
    assert not [m for m in loaded if m.split(".")[0] == "msgpack"]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_repro_import_statement(path):
    tree = ast.parse(path.read_text())
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            if root in ("jax", "jaxlib", "repro", "msgpack"):
                bad.append(f"{path.name}:{node.lineno}: {name}")
    assert not bad, bad
