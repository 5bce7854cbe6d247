"""Elementwise math blocks (reference:
radio/blocks/signal/{add,subtract,multiply,multiplyconjugate,
multiplyconstant,addconstant,absolutevalue,complexconjugate,
complexmagnitude,complexphase,complextoreal,complextoimag,complextofloat,
realtocomplex,floattocomplex}.lua).  Each is one torch expression; the
dual blocks also run on numpy arrays when a variable-rate host stage feeds
them."""

from __future__ import annotations

import numpy as np
import torch

from luaradio_tpu_torch.core.block import Input, Output, SignalBlock
from luaradio_tpu_torch.types import Byte, ComplexFloat32, Float32


class _Binary(SignalBlock):
    types = (ComplexFloat32, Float32, Byte)

    def __init__(self):
        super().__init__()
        for t in self.types:
            self.add_type_signature([Input("in1", t), Input("in2", t)],
                                    [Output("out", t)])


class AddBlock(_Binary):
    def process(self, state, x, y):
        return state, x + y


class SubtractBlock(_Binary):
    def process(self, state, x, y):
        return state, x - y


class MultiplyBlock(_Binary):
    types = (ComplexFloat32, Float32)

    def process(self, state, x, y):
        return state, x * y


class MultiplyConjugateBlock(SignalBlock):
    """out = in1 * conj(in2) (reference multiplyconjugate.lua)."""

    def __init__(self):
        super().__init__()
        self.add_type_signature(
            [Input("in1", ComplexFloat32), Input("in2", ComplexFloat32)],
            [Output("out", ComplexFloat32)])

    def process(self, state, x, y):
        return state, x * y.conj()


class _ConstantBlock(SignalBlock):
    def __init__(self, constant):
        super().__init__()
        self.constant = constant
        self.add_type_signature([Input("in", ComplexFloat32)],
                                [Output("out", ComplexFloat32)])
        if not isinstance(constant, complex):
            self.add_type_signature([Input("in", Float32)],
                                    [Output("out", Float32)])

    def _value(self, x):
        if x.is_complex():
            return complex(np.complex64(self.constant))
        return float(np.float32(self.constant))


class MultiplyConstantBlock(_ConstantBlock):
    def process(self, state, x):
        return state, x * self._value(x)


class AddConstantBlock(_ConstantBlock):
    def process(self, state, x):
        return state, x + self._value(x)


class AbsoluteValueBlock(SignalBlock):
    def __init__(self):
        super().__init__()
        self.add_type_signature([Input("in", Float32)],
                                [Output("out", Float32)])

    def process(self, state, x):
        return state, x.abs()


class ComplexConjugateBlock(SignalBlock):
    def __init__(self):
        super().__init__()
        self.add_type_signature([Input("in", ComplexFloat32)],
                                [Output("out", ComplexFloat32)])

    def process(self, state, x):
        return state, torch.conj_physical(x)


class _ComplexToReal(SignalBlock):
    """Complex in, real out; ``dual``: also runs on the host."""

    dual = True

    def __init__(self):
        super().__init__()
        self.add_type_signature([Input("in", ComplexFloat32)],
                                [Output("out", Float32)])


class ComplexMagnitudeBlock(_ComplexToReal):
    def process(self, state, x):
        return state, x.abs()

    def process_host(self, x):
        return np.abs(np.asarray(x)).astype(np.float32)


class ComplexPhaseBlock(_ComplexToReal):
    def process(self, state, x):
        return state, torch.angle(x)

    def process_host(self, x):
        return np.angle(np.asarray(x)).astype(np.float32)


class ComplexToRealBlock(_ComplexToReal):
    def process(self, state, x):
        return state, x.real

    def process_host(self, x):
        return np.real(np.asarray(x))


class ComplexToImagBlock(_ComplexToReal):
    def process(self, state, x):
        return state, x.imag

    def process_host(self, x):
        return np.imag(np.asarray(x))


class ComplexToFloatBlock(SignalBlock):
    def __init__(self):
        super().__init__()
        self.add_type_signature([Input("in", ComplexFloat32)],
                                [Output("real", Float32),
                                 Output("imag", Float32)])

    def process(self, state, x):
        return state, (x.real, x.imag)


class RealToComplexBlock(SignalBlock):
    def __init__(self):
        super().__init__()
        self.add_type_signature([Input("in", Float32)],
                                [Output("out", ComplexFloat32)])

    def process(self, state, x):
        return state, x.to(torch.complex64)


class FloatToComplexBlock(SignalBlock):
    def __init__(self):
        super().__init__()
        self.add_type_signature([Input("real", Float32),
                                 Input("imag", Float32)],
                                [Output("out", ComplexFloat32)])

    def process(self, state, re, im):
        return state, torch.complex(re, im)


__all__ = [
    "AddBlock", "SubtractBlock", "MultiplyBlock", "MultiplyConjugateBlock",
    "MultiplyConstantBlock", "AddConstantBlock", "AbsoluteValueBlock",
    "ComplexConjugateBlock", "ComplexMagnitudeBlock", "ComplexPhaseBlock",
    "ComplexToRealBlock", "ComplexToImagBlock", "ComplexToFloatBlock",
    "RealToComplexBlock", "FloatToComplexBlock",
]
