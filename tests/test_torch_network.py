"""The port's network sources and sinks, its msgpack codec and its socket
helpers against the JAX package's (tests/core/test_network.py's loopback
cases on the port, over TCP and UNIX sockets).

The port's sources depart from the JAX package's on purpose (module
docstring of luaradio_tpu_torch/blocks/sources/network.py): in raw and
formatted mode ``read(n)`` returns exactly ``n`` samples until the peer
closes.  The JAX source returns what one ``recv`` of at most 2^18 bytes
brought, and its Runner reads that short chunk as the end of the stream:
a network-fed run there writes one short chunk and stops.
``test_runner_over_a_network_source_outputs_every_sample`` holds the
port to every sample and states the JAX package's stop."""

import dataclasses
import socket
import threading

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import luaradio_tpu as jl  # noqa: E402
import luaradio_tpu_torch as tl  # noqa: E402
from luaradio_tpu.core.runtime import Runner as JRunner  # noqa: E402
from luaradio_tpu.utils import msgpack as jmsgpack  # noqa: E402
from luaradio_tpu_torch.core.runtime import Runner  # noqa: E402
from luaradio_tpu_torch.utils import msgpack  # noqa: E402
from luaradio_tpu_torch.utils.network import (NetworkClient,  # noqa: E402
                                              NetworkServer)

RNG = np.random.default_rng(31)
#: every socket wait and thread join has this limit
TIMEOUT = 20.0


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _address(transport, tmp_path, name="sock"):
    if transport == "tcp":
        return f"127.0.0.1:{_free_port()}"
    return str(tmp_path / name)


def _serve_bytes(transport, address, payload, ready):
    """A one-client server thread that sends ``payload`` and closes."""
    srv = NetworkServer(transport, address)
    srv.listen()
    srv.listener.settimeout(TIMEOUT)
    ready.set()

    def main():
        try:
            srv.accept()
            srv.sock.settimeout(TIMEOUT)
            srv.sendall(payload)
        finally:
            srv.close()
    t = threading.Thread(target=main, daemon=True)
    t.start()
    return t


def _prepare(block):
    block.differentiate([])
    block.initialize()
    return block


def _read_all(src, n):
    got = []
    while True:
        c = src.read(n)
        if c is None:
            break
        got.append(c)
    return got


# -- tests/core/test_network.py's loopback cases ------------------------------

@pytest.mark.parametrize("transport", ["tcp", "unix"])
@pytest.mark.parametrize("fmt", ["f32le", "s16be", "raw"])
def test_server_sink_client_source_roundtrip(transport, fmt, tmp_path):
    address = _address(transport, tmp_path)
    n = 5000
    x = (RNG.uniform(-0.9, 0.9, n) + 1j * RNG.uniform(-0.9, 0.9, n)
         ).astype(np.complex64)
    sink = tl.NetworkServerSink(transport, address, format=fmt)
    sink.differentiate([tl.ComplexFloat32])
    sink.input_rate = 1e6
    sink.initialize()
    sink.server.listener.settimeout(TIMEOUT)
    src = _prepare(tl.NetworkClientSource(tl.ComplexFloat32, 1e6, transport,
                                          address, format=fmt,
                                          reconnect=False))

    def serve():
        sink._ensure_connected()
        sink.process(x)
        sink.cleanup()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    try:
        got = _read_all(src, 4096)
    finally:
        t.join(TIMEOUT)
        src.cleanup()
    # exact chunks until the peer closes: the last one is what is left
    assert [len(c) for c in got] == [4096, n - 4096]
    got = np.concatenate(got)
    assert np.max(np.abs(got - x)) < 1e-4


def test_client_sink_server_source_json(tmp_path):
    address = str(tmp_path / "jsock")
    objs = [{"id": i, "value": f"msg{i}"} for i in range(20)]
    src = _prepare(tl.NetworkServerSource(tl.ComplexFloat32, 1e3, "unix",
                                          address, format="json",
                                          reconnect=False))
    src.server.listener.settimeout(TIMEOUT)
    sink = tl.NetworkClientSink("unix", address, format="json")
    sink.differentiate([tl.ComplexFloat32])
    sink.initialize()

    def send():
        sink._ensure_connected()
        sink.process(objs)
        sink.cleanup()

    t = threading.Thread(target=send, daemon=True)
    t.start()
    try:
        got = [o for c in _read_all(src, 100) for o in c]
    finally:
        t.join(TIMEOUT)
        src.cleanup()
    assert got == objs


# -- the same bytes through both packages' sources ----------------------------

def _source_stream(mod, transport, fmt, payload, tmp_path, n, data_type):
    address = _address(transport, tmp_path, f"{mod.__name__}.sock")
    ready = threading.Event()
    t = _serve_bytes(transport, address, payload, ready)
    ready.wait(TIMEOUT)
    src = mod.NetworkClientSource(getattr(mod, data_type), 1e6, transport,
                                  address, format=fmt, reconnect=False)
    src.differentiate([])
    src.initialize()
    try:
        got = _read_all(src, n)
    finally:
        t.join(TIMEOUT)
        src.cleanup()
    return got


@pytest.mark.parametrize("transport", ["tcp", "unix"])
@pytest.mark.parametrize("fmt,data_type", [("f32le", "ComplexFloat32"),
                                           ("u8", "ComplexFloat32"),
                                           ("s16be", "Float32"),
                                           ("raw", "ComplexFloat32")])
def test_read_stream_equals_jax(transport, fmt, data_type, tmp_path):
    """The same bytes served to each package's NetworkClientSource: the
    samples read() returns, joined, are equal bit for bit (the port's in
    chunks of exactly n, the JAX package's as recv brought them)."""
    k = 70001                      # odd: the last item ends mid-chunk
    if fmt == "u8":
        payload = RNG.integers(0, 256, 2 * k).astype(np.uint8).tobytes()
    elif fmt == "s16be":
        payload = RNG.integers(-32768, 32768, k).astype(">i2").tobytes()
    else:
        payload = RNG.standard_normal(2 * k).astype("<f4").tobytes()
    streams = {mod: _source_stream(mod, transport, fmt, payload, tmp_path,
                                   8192, data_type) for mod in (jl, tl)}
    port, jax_ = (np.concatenate(streams[m]) for m in (tl, jl))
    assert len(port) == k
    assert all(len(c) == 8192 for c in streams[tl][:-1])
    assert port.dtype == jax_.dtype
    np.testing.assert_array_equal(port, jax_)


@pytest.mark.parametrize("mode", ["json", "msgpack"])
def test_object_stream_equals_jax(mode, tmp_path):
    """Objects framed as JSON lines or u32-BE MessagePack frames: the
    port's source yields the JAX package's objects, a non-empty list per
    read()."""
    objs = [{"id": i, "text": "x" * (i % 50), "vals": [i, -i, 0.5 * i]}
            for i in range(300)]
    if mode == "json":
        payload = "".join(tl.JSONSink._dump(o) + "\n" for o in objs).encode()
    else:
        payload = b"".join(msgpack.serialize_framed(o) for o in objs)
    streams = {mod: _source_stream(mod, "tcp", mode, payload, tmp_path, 64,
                                   "ComplexFloat32") for mod in (jl, tl)}
    assert all(isinstance(c, list) and c for c in streams[tl])
    port = [o for c in streams[tl] for o in c]
    jax_ = [o for c in streams[jl] for o in c]
    assert port == jax_ == objs


# -- framing bytes ------------------------------------------------------------

@dataclasses.dataclass
class _Packet:
    address: int
    text: str
    ok: bool


MSGPACK_CASES = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1,
    2**32, 2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
    -2**31 - 1, -2**63, 0.0, -1.5, 1e300, float("inf"), "", "a" * 31,
    "b" * 32, "c" * 255, "d" * 256, "é" * 40000, b"", b"\x00" * 255,
    b"\x01" * 256, b"\x02" * 70000, [], list(range(15)), list(range(16)),
    list(range(70000)), {}, {str(i): i for i in range(15)},
    {str(i): i for i in range(16)}, {"nested": [{"a": [1, {"b": None}]}]},
    (1, 2, "three"), np.int16(-7), np.float32(0.25), np.arange(5),
    _Packet(0x1234, "HELLO", True),
]


@pytest.mark.parametrize("i", range(len(MSGPACK_CASES)))
def test_msgpack_bytes_equal_jax(i):
    obj = MSGPACK_CASES[i]
    assert msgpack.packb(obj) == jmsgpack.packb(obj)
    framed = msgpack.serialize_framed(obj)
    assert framed == jmsgpack.serialize_framed(obj)
    back, pos = msgpack.deserialize_framed(framed + b"\x00\x00")
    assert pos == len(framed)
    assert back == jmsgpack.deserialize_framed(framed)[0]
    assert msgpack.deserialize_framed(framed[:-1]) == (None, 0)


def test_msgpack_rejects_what_jax_rejects():
    for mod in (msgpack, jmsgpack):
        with pytest.raises(OverflowError):
            mod.packb(2**64)
        with pytest.raises(TypeError):
            mod.packb(object())
        with pytest.raises(ValueError, match="trailing"):
            mod.unpackb(b"\x01\x02")
        with pytest.raises(ValueError, match="unsupported"):
            mod.unpackb(b"\xc1")


def _framed(mod, mode, objs):
    sink = mod.NetworkClientSink("tcp", "127.0.0.1:1", format=mode)
    return sink._serialize(objs)


@pytest.mark.parametrize("mode", ["json", "msgpack", "f32le", "u8", "s16be",
                                  "raw"])
def test_sink_framing_bytes_equal_jax(mode):
    """What each package's network sink puts on the wire for the same
    input: JSON lines and MessagePack frames for objects (the decoders'
    dataclasses and plain values), the wire formats and raw bytes for
    samples."""
    if mode in ("json", "msgpack"):
        x = [_Packet(i, f"m{i}", i % 2 == 0) for i in range(10)] + \
            [{"k": [1, 2.5, None]}, "text", 7]
        if mode == "json":
            x = [v for v in x if not isinstance(v, _Packet)] + \
                [dataclasses.asdict(v) for v in x if isinstance(v, _Packet)]
    else:
        x = (RNG.uniform(-1, 1, 999) + 1j * RNG.uniform(-1, 1, 999)
             ).astype(np.complex64)
    assert _framed(tl, mode, x) == _framed(jl, mode, x)
    if mode not in ("json", "msgpack"):
        assert _framed(tl, mode, x.real.copy()) == \
            _framed(jl, mode, x.real.copy())


# -- the departure: a Runner over a network source ----------------------------

def _network_run(mod, transport, tmp_path, x):
    address = _address(transport, tmp_path, f"{mod.__name__}.run.sock")
    ready = threading.Event()
    t = _serve_bytes(transport, address, x.tobytes(), ready)
    ready.wait(TIMEOUT)
    out = str(tmp_path / f"{mod.__name__}.iq")
    top = mod.CompositeBlock()
    top.connect(mod.NetworkClientSource(mod.ComplexFloat32, 1e6, transport,
                                        address, format="f32le",
                                        reconnect=False),
                mod.MultiplyConstantBlock(1.0), mod.IQFileSink(out, "f32le"))
    if mod is tl:
        Runner(top, chunk_size=65536, device="cpu").run()
    else:
        JRunner(top, mode="fused", chunk_size=65536).run()
    t.join(TIMEOUT)
    return np.fromfile(out, dtype=np.complex64)


@pytest.mark.parametrize("transport", ["tcp", "unix"])
def test_runner_over_a_network_source_outputs_every_sample(transport,
                                                           tmp_path):
    """400 000 complex f32 samples sent at once through
    NetworkClientSource -> MultiplyConstant(1) -> IQFileSink at 65 536-
    sample chunks: the port writes all of them, equal to what was sent.
    The JAX package writes at most one recv's worth (2^18 bytes, 32 768
    samples) and stops: its first chunk comes short and reads as the end
    of the stream."""
    n = 400_000
    x = (RNG.standard_normal(n) + 1j * RNG.standard_normal(n)
         ).astype(np.complex64)
    got = _network_run(tl, transport, tmp_path, x)
    assert len(got) == n
    np.testing.assert_array_equal(got, x)
    assert len(_network_run(jl, transport, tmp_path, x)) <= 32768


def test_server_source_reconnects_until_peer_data(tmp_path):
    """reconnect=True on a server source: a client that connects and
    closes at once does not end the stream; the next client's samples
    arrive whole."""
    address = str(tmp_path / "rsock")
    src = _prepare(tl.NetworkServerSource(tl.Float32, 1e3, "unix", address,
                                          format="f32le", reconnect=True))
    src.server.listener.settimeout(TIMEOUT)
    x = RNG.standard_normal(3000).astype(np.float32)

    def clients():
        for payload in (b"", x.tobytes()):
            c = NetworkClient("unix", address)
            c.connect_blocking(retry_delay=0.01)
            c.sendall(payload)
            c.close()

    t = threading.Thread(target=clients, daemon=True)
    t.start()
    try:
        got = src.read(3000)
    finally:
        t.join(TIMEOUT)
        src.cleanup()
    np.testing.assert_array_equal(got, x)


def test_client_sink_without_reconnect_raises_on_a_closed_peer(tmp_path):
    address = str(tmp_path / "csock")
    srv = NetworkServer("unix", address)
    srv.listen()
    srv.listener.settimeout(TIMEOUT)
    sink = tl.NetworkClientSink("unix", address, format="f32le",
                                reconnect=False)
    sink.differentiate([tl.Float32])
    sink.initialize()
    sink._ensure_connected()
    srv.accept()
    srv.close()
    with pytest.raises(BrokenPipeError):
        for _ in range(100):     # the first sends may still be buffered
            sink.process(np.zeros(1 << 16, np.float32))
    sink.cleanup()
