"""The port stands alone: every module of luaradio_tpu_torch imports with
jax and luaradio_tpu blocked, and chip_smoke.py imports neither; without a
card the script exits non-zero and prints no result."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "luaradio_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).replace(
        ".__init__", "")
    for p in PKG.rglob("*.py"))

BLOCK = ("import sys\n"
         "for name in ('jax', 'jaxlib', 'luaradio_tpu'):\n"
         "    sys.modules[name] = None\n")


def _python(code, cwd=ROOT):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_every_module_imports_without_jax():
    code = BLOCK + "import importlib\n" + "".join(
        f"importlib.import_module({m!r})\n" for m in MODULES) + \
        "assert not any(k.split('.')[0] in ('jax', 'luaradio_tpu') and " \
        "sys.modules[k] is not None for k in sys.modules)\n"
    r = _python(code)
    assert r.returncode == 0, r.stderr
    assert len(MODULES) >= 25


@pytest.mark.parametrize("path", ["chip_smoke.py"] + [
    str(p.relative_to(ROOT)) for p in sorted(PKG.rglob("*.py"))])
def test_no_jax_import_statements(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "luaradio_tpu"), \
                f"{path}:{node.lineno} imports {n}"


def test_chip_smoke_without_a_card_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    code = BLOCK + ("sys.argv = ['chip_smoke.py']\n"
                    "import runpy\n"
                    "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    r = _python(code)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert '"ok"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120,
                       env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
