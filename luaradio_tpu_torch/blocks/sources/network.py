"""Network sources (the JAX package's blocks/sources/network.py; reference
radio/blocks/sources/{networkclient,networkserver}.lua): complex or real
samples in any of the 14 scalar wire formats, native ("raw") samples,
newline-delimited JSON objects or framed MessagePack objects, over TCP or
UNIX sockets.

Departure from the JAX package, on purpose: in raw and formatted mode
``read(n)`` returns exactly ``n`` samples, gathered across as many
``recv`` calls as it takes, and fewer only at end of stream (the peer
closed and ``reconnect`` is False).  The JAX source returns whatever one
``recv`` of at most 2^18 bytes brought, and the runtime reads a short
chunk as the end of the stream, so a network-fed run there stops after
its first chunk.  json and msgpack mode return the objects that arrived,
as a list, reading until at least one has (an empty chunk would read as
the end of the stream too).
"""

from __future__ import annotations

import json as _json

import numpy as np

from luaradio_tpu_torch.core.block import HostSourceBlock, Output
from luaradio_tpu_torch.types import ComplexFloat32, Float32, SampleType
from luaradio_tpu_torch.utils import format as format_utils
from luaradio_tpu_torch.utils.msgpack import deserialize_framed
from luaradio_tpu_torch.utils.network import NetworkClient, NetworkServer

#: the most bytes one recv asks for
RECV_BYTES = 1 << 18


class _NetworkSourceBase(HostSourceBlock):
    def __init__(self, data_type: SampleType, rate: float, transport: str,
                 address: str, format: str | None = "f32le",
                 reconnect: bool = True):
        super().__init__()
        self.data_type = data_type
        self.rate = rate
        self.transport = transport
        self.address = address
        self.reconnect = reconnect
        self._residue = b""
        if format in ("raw", "json", "msgpack", None):
            self.format = None
            self.mode = format or "raw"
        else:
            self.format = format_utils.get_format(format)
            self.mode = "format"
            if data_type not in (ComplexFloat32, Float32):
                raise ValueError("formatted network sources require "
                                 "ComplexFloat32 or Float32")
        self.add_type_signature([], [Output("out", data_type)])

    # -- endpoint management (client/server subclasses) --------------------
    def _ensure_connected(self):
        raise NotImplementedError

    def _endpoint(self):
        raise NotImplementedError

    def _reconnect(self):
        raise NotImplementedError

    def _item_bytes(self) -> int:
        if self.mode == "format":
            mult = 2 if self.data_type == ComplexFloat32 else 1
            return self.format.itemsize * mult
        if self.mode == "raw":
            return self.data_type.dtype.itemsize
        return 1  # json/msgpack: byte stream

    def _recv(self, nbytes: int) -> bytes | None:
        """Up to ``nbytes`` from the peer, reconnecting after a disconnect
        when ``reconnect`` is set; None once the peer has closed
        otherwise."""
        while True:
            data = self._endpoint().recv(nbytes)
            if data:
                return data
            if not self.reconnect:
                return None
            self._reconnect()

    def read(self, n: int):
        self._ensure_connected()
        if self.mode in ("json", "msgpack"):
            return self._read_objects()
        item = self._item_bytes()
        want = n * item
        buf = bytearray(self._residue)
        while len(buf) < want:
            data = self._recv(min(want - len(buf), RECV_BYTES))
            if data is None:
                break
            buf += data
        if not buf:
            return None
        count = min(len(buf), want) // item
        self._residue = bytes(buf[count * item:])
        chunk = bytes(buf[:count * item])
        if self.mode == "raw":
            return np.frombuffer(chunk, dtype=self.data_type.dtype)
        if self.data_type == ComplexFloat32:
            return format_utils.bytes_to_complex(chunk, self.format)
        return format_utils.bytes_to_real(chunk, self.format)

    def _read_objects(self):
        buf = self._residue
        while True:
            data = self._recv(RECV_BYTES)
            if data is None:
                return None
            buf += data
            if self.mode == "json":
                lines = buf.split(b"\n")
                buf = lines[-1]
                out = [_json.loads(ln) for ln in lines[:-1] if ln.strip()]
            else:
                # framed objects: u32-BE length + MessagePack payload
                # (reference object.lua:106-201 wire format)
                out, pos = [], 0
                while True:
                    obj, pos2 = deserialize_framed(buf, pos)
                    if pos2 == pos:
                        break
                    out.append(obj)
                    pos = pos2
                buf = buf[pos:]
            if out:
                self._residue = buf
                return out


class NetworkClientSource(_NetworkSourceBase):
    """Source samples from a remote server (reference: networkclient.lua)."""

    def initialize(self):
        self.client = NetworkClient(self.transport, self.address)

    def _ensure_connected(self):
        if not self.client.connected():
            self.client.connect_blocking()

    def _reconnect(self):
        self.client.close()
        self.client.connect_blocking()

    def _endpoint(self):
        return self.client

    def cleanup(self):
        if getattr(self, "client", None):
            self.client.close()


class NetworkServerSource(_NetworkSourceBase):
    """Source samples from an accepted client (reference: networkserver.lua)."""

    def initialize(self):
        self.server = NetworkServer(self.transport, self.address)
        self.server.listen()

    def _ensure_connected(self):
        if not self.server.connected():
            self.server.accept()

    def _reconnect(self):
        self.server.sock = None
        self.server.accept()

    def _endpoint(self):
        return self.server

    def cleanup(self):
        if getattr(self, "server", None):
            self.server.close()


__all__ = ["NetworkClientSource", "NetworkServerSource"]
