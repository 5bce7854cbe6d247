"""IQ file format converter between any of the 14 scalar wire formats (the
JAX package's examples/iqfile_converter.py; reference
examples/iqfile_converter.lua): IQFileSource -> IQFileSink.

    python -m luaradio_tpu_torch.examples.iqfile_converter \\
        <in file> <in format> <out file> <out format> [--cpu]

Formats: u8, s8, u16le, u16be, s16le, s16be, u32le, u32be, s32le, s32be,
f32le, f32be, f64le, f64be.
"""

from __future__ import annotations

import sys

import luaradio_tpu_torch as radio

USAGE = ("Usage: python -m luaradio_tpu_torch.examples.iqfile_converter "
         "<in> <in fmt> <out> <out fmt> [--cpu]\nFormats: u8, s8, u16le, "
         "u16be, s16le, s16be, u32le, u32be, s32le, s32be, f32le, f32be, "
         "f64le, f64be")


def build(in_path: str, in_format: str, out_path: str,
          out_format: str) -> radio.CompositeBlock:
    top = radio.CompositeBlock()
    top.connect(radio.IQFileSource(in_path, in_format, 1.0),
                radio.IQFileSink(out_path, out_format))
    return top


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else None
    args = [a for a in argv if a != "--cpu"]
    if len(args) < 4:
        print(USAGE, file=sys.stderr)
        return 1
    build(*args[:4]).run(device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
