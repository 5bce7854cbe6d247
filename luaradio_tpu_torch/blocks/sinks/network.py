"""Network sinks (the JAX package's blocks/sinks/network.py; reference
radio/blocks/sinks/{networkclient,networkserver}.lua).  Host sinks: their
input arrives as host arrays (or lists of objects) through the runtime's
boundary, and goes out in a wire format, as raw samples, as JSON lines or
as framed MessagePack objects."""

from __future__ import annotations

import numpy as np

from luaradio_tpu_torch.blocks.sinks.misc import JSONSink
from luaradio_tpu_torch.core.block import Input, SinkBlock
from luaradio_tpu_torch.utils import format as format_utils
from luaradio_tpu_torch.utils.msgpack import serialize_framed
from luaradio_tpu_torch.utils.network import NetworkClient, NetworkServer


class _NetworkSinkBase(SinkBlock):
    def __init__(self, transport: str, address: str,
                 format: str | None = "f32le", reconnect: bool = True):
        super().__init__()
        self.transport = transport
        self.address = address
        self.reconnect = reconnect
        if format in ("raw", "json", "msgpack", None):
            self.format = None
            self.mode = format or "raw"
        else:
            self.format = format_utils.get_format(format)
            self.mode = "format"
        self.add_type_signature([Input("in", lambda t: True)], [])

    def _serialize(self, x) -> bytes:
        if self.mode in ("json", "msgpack"):
            vals = x if isinstance(x, (list, tuple)) \
                else np.asarray(x).reshape(-1)
            if self.mode == "json":
                return "".join(JSONSink._dump(v) + "\n" for v in vals).encode()
            # object samples in the reference's exact pipe framing: u32-BE
            # length + MessagePack payload (object.lua:106-201)
            return b"".join(serialize_framed(v) for v in vals)
        arr = np.asarray(x)
        if self.mode == "raw":
            return np.ascontiguousarray(arr).tobytes()
        if np.iscomplexobj(arr):
            return format_utils.complex_to_bytes(arr, self.format)
        return format_utils.real_to_bytes(arr, self.format)

    def _ensure_connected(self):
        raise NotImplementedError

    def _endpoint(self):
        raise NotImplementedError

    def _drop_connection(self):
        raise NotImplementedError

    def process(self, x):
        data = self._serialize(x)
        while True:
            self._ensure_connected()
            if self._endpoint().sendall(data):
                return
            if not self.reconnect:
                raise BrokenPipeError("network sink peer disconnected")
            self._drop_connection()


class NetworkClientSink(_NetworkSinkBase):
    """Send samples to a remote server (reference: networkclient.lua)."""

    def initialize(self):
        self.client = NetworkClient(self.transport, self.address)

    def _ensure_connected(self):
        if not self.client.connected():
            self.client.connect_blocking()

    def _drop_connection(self):
        self.client.close()

    def _endpoint(self):
        return self.client

    def cleanup(self):
        if getattr(self, "client", None):
            self.client.close()


class NetworkServerSink(_NetworkSinkBase):
    """Serve samples to an accepted client (reference: networkserver.lua)."""

    def initialize(self):
        self.server = NetworkServer(self.transport, self.address)
        self.server.listen()

    def _ensure_connected(self):
        if not self.server.connected():
            self.server.accept()

    def _drop_connection(self):
        self.server.sock = None

    def _endpoint(self):
        return self.server

    def cleanup(self):
        if getattr(self, "server", None):
            self.server.close()


__all__ = ["NetworkClientSink", "NetworkServerSink"]
