"""Sample type system.

The reference framework (LuaRadio) models samples as C structs with arithmetic
metamethods and a serialize/deserialize contract (see
radio/types/cstruct.lua:21-148 and
radio/types/object.lua:25-220).  In the port the natural analog is
a *dtype descriptor*: samples live in tensors whose last axis is time, and
the type object carries the dtype, the per-type comparison tolerance used by
golden-vector tests, and host<->wire conversion helpers.

Concrete types mirror the reference's four basic types
(radio/types/{complexfloat32,float32,bit,byte}.lua) plus an
ObjectType for variable-size decoded samples (frames, packets), which flow
host-side as Python objects.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable

import numpy as np


class SampleType:
    """Descriptor for a fixed-size sample type backed by a numpy dtype."""

    def __init__(self, name: str, dtype, epsilon: float):
        self.name = name
        self.dtype = np.dtype(dtype)
        self.epsilon = epsilon

    # -- identity ---------------------------------------------------------
    def __repr__(self) -> str:
        return f"<SampleType {self.name}>"

    def __hash__(self) -> int:
        return hash(self.name)

    def __eq__(self, other) -> bool:
        return isinstance(other, SampleType) and other.name == self.name

    # -- comparison (the analog of approx_equal in the reference types,
    #    radio/types/complexfloat32.lua:195) ---------------
    def approx_equal(self, a, b, epsilon: float | None = None) -> bool:
        eps = self.epsilon if epsilon is None else epsilon
        a = np.asarray(a)
        b = np.asarray(b)
        if a.shape != b.shape:
            return False
        if np.issubdtype(self.dtype, np.integer):
            return bool(np.array_equal(a, b))
        return bool(np.allclose(a, b, rtol=0.0, atol=eps))

    # -- construction helpers --------------------------------------------
    def vector(self, n: int) -> np.ndarray:
        return np.zeros(n, dtype=self.dtype)

    def vector_from_array(self, arr) -> np.ndarray:
        return np.asarray(arr, dtype=self.dtype)


# The four basic sample types of the reference framework.
ComplexFloat32 = SampleType("ComplexFloat32", np.complex64, 1e-6)
Float32 = SampleType("Float32", np.float32, 1e-6)
Bit = SampleType("Bit", np.uint8, 0.0)
Byte = SampleType("Byte", np.uint8, 0.0)


def bits_to_number(bits: np.ndarray, offset: int = 0, length: int | None = None,
                   msb_first: bool = True) -> int:
    """Convert a bit vector (0/1 uint8) to an integer.

    Mirrors Bit.tonumber semantics (radio/types/bit.lua:132).
    """
    bits = np.asarray(bits).astype(np.int64)
    if length is None:
        length = len(bits) - offset
    sel = bits[offset:offset + length]
    if not msb_first:
        sel = sel[::-1]
    value = 0
    for b in sel:
        value = (value << 1) | int(b)
    return value


def bits_to_bytes(bits: np.ndarray, msb_first: bool = True) -> bytes:
    """Pack a bit vector into bytes (radio/types/bit.lua:162)."""
    bits = np.asarray(bits).astype(np.uint8)
    n = (len(bits) // 8) * 8
    bits = bits[:n].reshape(-1, 8)
    if not msb_first:
        bits = bits[:, ::-1]
    return bytes(np.packbits(bits, axis=1, bitorder="big").reshape(-1))


def number_to_bits(value: int, length: int, msb_first: bool = True) -> np.ndarray:
    out = np.zeros(length, dtype=np.uint8)
    for i in range(length):
        out[length - 1 - i] = (value >> i) & 1
    if not msb_first:
        out = out[::-1]
    return out


class ObjectSampleType(SampleType):
    """Type for variable-size host-side object samples.

    JSON form for line-oriented sinks (to_json/from_json,
    object.lua:70-94).  Object samples flow host-side (protocol
    framer/decoder outputs); their MessagePack wire form comes with the
    protocol blocks.
    """

    def __init__(self, name: str, factory: Callable[..., Any] | None = None):
        super().__init__(name, np.object_, 0.0)
        self.factory = factory

    def approx_equal(self, a, b, epsilon=None) -> bool:
        return a == b

    def to_json(self, obj) -> str:
        if dataclasses.is_dataclass(obj):
            return json.dumps(dataclasses.asdict(obj))
        if hasattr(obj, "to_json"):
            return obj.to_json()
        return json.dumps(obj)

    def from_json(self, s: str):
        d = json.loads(s)
        if self.factory is not None and isinstance(d, dict):
            return self.factory(**d)
        return d


def object_type(name: str) -> ObjectSampleType:
    return ObjectSampleType(name)


__all__ = [
    "SampleType",
    "ObjectSampleType",
    "object_type",
    "ComplexFloat32",
    "Float32",
    "Bit",
    "Byte",
    "bits_to_number",
    "bits_to_bytes",
    "number_to_bits",
]
