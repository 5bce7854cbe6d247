"""luaradio_tpu_torch — the PyTorch + CUDA port of luaradio_tpu.

The same flow-graph model as the JAX package (typed blocks, composites,
exact-rational rate propagation, streaming state carried across chunks),
with device blocks running as torch tensor code on a CUDA card and the TPU
package's Pallas kernels rewritten as CUDA kernels (csrc/).  Entry points
run on the card unless the caller passes ``device="cpu"``.

The port holds the analog receivers end to end: rx_wbfm (mono and
stereo), rx_am (envelope and synchronous), rx_nbfm, rx_ssb, rx_raw and
iq_converter, and the digital ones: rx_rds, rx_pocsag, rx_ax25 and
rx_ert, through the application dispatcher and CLI (``python -m
luaradio_tpu_torch.cli``), with their blocks and composites (tuner,
resamplers, the WBFM, NBFM, AM and SSB demodulators, the RDS, POCSAG,
AX.25, ERT and BPSK31 receivers, the PLL and its three tiers, the AGC,
clock recovery, the masked Sampler, the designed and matched filters,
the protocol framers and decoders), the IQ file source with its
device-resident ring, the zero, signal and uniform random sources, the
WAV/IQ/print/JSON/benchmark sinks, the graph optimizer, the runtime and
the hand-fused flagship step.  Beyond the receivers it has the rest of the
signal blocks (IIR filters of any order, FFT overlap-save FIRs, the FM,
PAM and QAM modulators, the power squelch, interleave, deinterleave, nop
and throttle), the real, raw, WAV and JSON file sources, the real and raw
file sinks, eager mode and the runtime's span tracer.  It reaches the
outside world as the JAX package does: network sources and sinks over
TCP and UNIX sockets, the SDR sources (raw wire rings, converted on the
card) and transmit sinks over the vendor libraries, PulseAudio and
PortAudio, gnuplot plots, and the dispatcher's inputs and outputs for
all of them.
"""

__version__ = "0.1.0"

# the JAX package's version names (the reference's radio/init.lua:18-21):
# the strings, the xxyyzz decimal number and an info table
_VERSION = version = __version__
version_number = 100
version_info = {"major": 0, "minor": 1, "patch": 0}

from luaradio_tpu_torch import types  # noqa: F401
from luaradio_tpu_torch.blocks import *  # noqa: F401,F403
from luaradio_tpu_torch.blocks.protocol import *  # noqa: F401,F403
from luaradio_tpu_torch.composites import *  # noqa: F401,F403
from luaradio_tpu_torch.core import (Block, CompositeBlock,  # noqa: F401
                                     HostBlock, HostSourceBlock, Input,
                                     Output, SignalBlock, SignalSourceBlock,
                                     SinkBlock, SourceBlock)
from luaradio_tpu_torch.types import (Bit, Byte, ComplexFloat32,  # noqa: F401
                                      Float32)
