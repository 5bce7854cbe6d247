"""Build the package's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so
plain ``nvcc`` builds it in seconds into ``_build/lib<name>-<hash>.so``,
keyed by a hash of the sources and flags: a changed source builds anew, an
unchanged one loads the library already there.  A measurement build
(``PROBES``) compiles a source again with extra defines into a library of
its own; nothing on the receiver's path loads one.  The library is written
under a temporary name and renamed into place, so concurrent builds need
no lock and a build cut short leaves nothing that is loaded later.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("wbfm", "pll", "pll_overlap", "roofline", "window", "pll_ablate",
           "wbfm_proto")
#: measurement builds: name -> (source, extra nvcc flags).  wbfm_parts
#: holds K1's discriminator and FIR halves alone (chip_smoke.py,
#: scratch/wbfm_ab.py); roofline_sweep every instance of the copies' ring
#: that scratch/roofline_ab.py sweeps, pll_overlap_sweep every instance of
#: the scan's rings and its pipelined one-thread variant that
#: scratch/scan_ab.py sweeps, wbfm_proto_sweep every point of S4's ring
#: (and the Hopper atan2) that scratch/wbfm_proto_ab.py sweeps (none of
#: the three built by chip_smoke.py)
PROBES = {"wbfm_parts": ("wbfm", ("-DLR_WBFM_PARTS",)),
          "roofline_sweep": ("roofline", ("-DLR_ROOFLINE_SWEEP",)),
          "pll_overlap_sweep": ("pll_overlap", ("-DLR_SCAN_SWEEP",)),
          "wbfm_proto_sweep": ("wbfm_proto", ("-DLR_S4_SWEEP",))}

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME (default /usr/local/cuda,
    the toolkit's standard install location)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first "
                       "use and need the CUDA toolkit")


def _source(name: str) -> tuple[str, tuple[str, ...]]:
    """(source name, nvcc flags) of a library name."""
    src, extra = PROBES.get(name, (name, ()))
    return src, NVCC_FLAGS + extra


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(_source(name)[1]).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, tuple[float, str]]:
    """Compile every named library (a source, or a measurement build of
    ``PROBES``) that has no library yet, all nvcc processes started
    together.  Returns {name: (seconds, compiler
    output)} for the ones built; raises with the compiler's output if one
    fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        src, flags = _source(name)
        cmd = [nvcc(), *flags, "-o", str(tmp), str(CSRC / f"{src}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.monotonic())
    done = {}
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {name} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
        done[name] = (time.monotonic() - t0, log)
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (``csrc/<name>.cu`` or a measurement
    build), built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build((name,))
            lib = ctypes.CDLL(str(path))
            lib.lr_error_string.argtypes = [ctypes.c_int]
            lib.lr_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str):
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = lib.lr_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


__all__ = ["build", "load", "check", "library_path", "nvcc", "SOURCES",
           "PROBES"]
