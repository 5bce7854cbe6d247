"""Debug logging, gated by the LUARADIO_TPU_DEBUG environment variable
(the JAX package's core/debug.py; reference radio/core/debug.lua, a
stderr logger gated by LUARADIO_DEBUG)."""

from __future__ import annotations

import os
import sys

enabled = bool(os.environ.get("LUARADIO_TPU_DEBUG"))


def print_(*args):
    if enabled:
        print(*args, file=sys.stderr)


def printf(fmt: str, *args):
    if enabled:
        sys.stderr.write(fmt % args if args else fmt)


__all__ = ["enabled", "print_", "printf"]
