"""The C embedding API for the port: build ``native/src/embed.c`` (CPython
hosting a flow-graph script and driving its ``top``; nothing in it is
particular to either package) and the port's lifecycle program
``csrc/embed_lifecycle.c``, at first use, with the host's C compiler.

Both go into ``luaradio_tpu_torch/_build/``, keyed by a hash of the
sources, the flags and the Python they link, like the format conversions
(utils/native.py).  The Python include directory and library come from
``sysconfig`` (INCLUDEPY, LIBDIR, LDLIBRARY), not from ``python3-config``
alone, so a virtual environment links the interpreter it runs on.  The
embedded interpreter starts from that installation's own prefix, so
:func:`run_lifecycle` hands it the caller's ``sys.path`` through
PYTHONPATH: it then imports the same torch and numpy as the caller.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
ROOT = _PKG.parent
SOURCE = ROOT / "native" / "src" / "embed.c"
HEADER_DIR = ROOT / "native" / "include"
LIFECYCLE = _PKG / "csrc" / "embed_lifecycle.c"
BUILD_DIR = _PKG / "_build"
CFLAGS = ("-O2", "-fPIC", "-Wall", "-Wextra")


def _python_link() -> tuple[list[str], list[str]]:
    """(compile flags, link flags) for the running interpreter's
    libpython."""
    inc = sysconfig.get_config_var("INCLUDEPY") \
        or sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ldlib = sysconfig.get_config_var("LDLIBRARY") or ""
    name = ldlib[3:] if ldlib.startswith("lib") else ldlib
    for ext in (".so", ".dylib", ".a"):
        if name.endswith(ext):
            name = name[:-len(ext)]
    link = [f"-L{libdir}", f"-l{name}", f"-Wl,-rpath,{libdir}"]
    link += (sysconfig.get_config_var("LIBS") or "").split()
    link += (sysconfig.get_config_var("SYSLIBS") or "").split()
    return [f"-I{inc}"], link


def _key() -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    h.update(repr(_python_link()).encode())
    for src in (SOURCE, HEADER_DIR / "luaradio_tpu.h", LIFECYCLE):
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def paths() -> tuple[Path, Path]:
    """(the embed library, the lifecycle program) for these sources."""
    k = _key()
    return (BUILD_DIR / f"libluaradio_tpu_embed-{k}.so",
            BUILD_DIR / f"embed_lifecycle-{k}")


def _cc() -> str:
    cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        raise RuntimeError("no C compiler (cc) to build the embed library")
    return cc


def _compile(cmd: list[str], out: Path):
    """Run ``cmd`` writing ``out`` under a temporary name, renamed into
    place (concurrent builds need no lock); raises with the compiler's
    output if it fails."""
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    r = subprocess.run(cmd + ["-o", str(tmp)], capture_output=True,
                       text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {out.name} failed:\n{r.stderr}")
    os.replace(tmp, out)


def build() -> tuple[Path, Path]:
    """Build the embed library and the lifecycle program where they are
    not built yet; returns their paths."""
    lib, prog = paths()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cflags, link = _python_link()
    cc = _cc()
    if not lib.exists():
        _compile([cc, *CFLAGS, *cflags, "-shared", str(SOURCE), *link], lib)
    if not prog.exists():
        _compile([cc, "-O2", "-Wall", "-Wextra", f"-I{HEADER_DIR}",
                  str(LIFECYCLE), str(lib), "-Wl,-rpath,$ORIGIN", *link],
                 prog)
    return lib, prog


def run_lifecycle(device: str, out_path: str, timeout: float = 300.0):
    """Build if needed, then run the lifecycle program on ``device``
    ("cpu" or "cuda") writing ``out_path``; returns the CompletedProcess
    (the caller checks the return code and the output file)."""
    _, prog = build()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in sys.path if p])
    return subprocess.run([str(prog), device, str(ROOT), str(out_path)],
                          capture_output=True, text=True, timeout=timeout,
                          env=env)


__all__ = ["build", "paths", "run_lifecycle"]
