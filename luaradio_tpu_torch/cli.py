"""Command-line interface of the port (the JAX package's cli.py; reference:
the luaradio script, :29-123): run a flow-graph script, or a built-in
application with -a/--application, -i/--input, -o/--output.

    python -m luaradio_tpu_torch.cli -a rx_wbfm \\
        -i iqfile:capture.iq,rate=1102500 -o wavfile:out.wav 100e6

Applications run on the CUDA card; ``main(argv, device="cpu")`` runs them
on the CPU through the Python API.  The JAX package's ingest options
(--ingest, --ingest-stripes) have no counterpart: the port chooses its
ingest itself (core/ingest.py).
"""

from __future__ import annotations

import argparse
import runpy
import sys


class Args(dict):
    """Application argument bag: positional by integer index, options by
    name (mirrors the reference's parsed-args table)."""

    def __init__(self, positional, options):
        super().__init__(options)
        self._positional = list(positional)

    def __getitem__(self, key):
        if isinstance(key, int):
            return self._positional[key]
        return super().__getitem__(key)

    @property
    def positional(self):
        return list(self._positional)


def _platform_info() -> str:
    import luaradio_tpu_torch
    from luaradio_tpu_torch.core.platform import cuda_info
    info = cuda_info()
    return "\n".join([
        f"luaradio_tpu_torch {luaradio_tpu_torch.__version__}",
        f"torch {info['torch_version']}, CUDA {info['cuda_version']}",
        f"cuda available: {info['cuda_available']}",
        f"devices: {info['devices']}",
    ])


def _list_applications() -> str:
    from luaradio_tpu_torch.applications import APPLICATIONS
    return "\n".join(f"  {name:<14} {APPLICATIONS[name].description}"
                     for name in sorted(APPLICATIONS))


def _split_args(tokens):
    positional, options = [], {}
    rest = list(tokens)
    while rest:
        tok = rest.pop(0)
        if tok.startswith("--"):
            key = tok[2:]
            if "=" in key:
                key, _, val = key.partition("=")
                options[key] = val
            elif rest and not rest[0].startswith("--"):
                options[key] = rest.pop(0)
            else:
                options[key] = True
        else:
            positional.append(tok)
    return Args(positional, options)


def main(argv=None, device=None) -> int:
    parser = argparse.ArgumentParser(
        prog="luaradio-tpu-torch",
        description="software-defined-radio framework on a CUDA card "
                    "(PyTorch)",
        epilog="applications:\n" + _list_applications(),
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--version", action="store_true",
                        help="print version and exit")
    parser.add_argument("--platform", action="store_true",
                        help="dump platform info and exit")
    parser.add_argument("-a", "--application", metavar="NAME",
                        help="run a built-in application")
    parser.add_argument("-i", "--input", metavar="SPEC",
                        help="application input, e.g. "
                             "iqfile:capture.iq,format=f32le,rate=1e6")
    parser.add_argument("-o", "--output", metavar="SPEC",
                        help="application output, e.g. wavfile:out.wav")
    parser.add_argument("script_or_args", nargs="*",
                        help="flow-graph script to run, or application "
                             "arguments / --options")
    ns, extra = parser.parse_known_args(argv)
    ns.script_or_args = ns.script_or_args + extra

    if ns.version:
        import luaradio_tpu_torch
        print(f"luaradio_tpu_torch {luaradio_tpu_torch.__version__}")
        return 0
    if ns.platform:
        print(_platform_info())
        return 0

    if ns.application:
        if not ns.input or not ns.output:
            parser.error("-a requires both -i <input> and -o <output>")
        from luaradio_tpu_torch import applications
        applications.run(ns.application, ns.input, ns.output,
                         _split_args(ns.script_or_args), device=device)
        return 0

    if ns.script_or_args:
        script = ns.script_or_args[0]
        sys.argv = ns.script_or_args
        runpy.run_path(script, run_name="__main__")
        return 0

    parser.print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main())
