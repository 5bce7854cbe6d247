"""TCP / UNIX-socket client and server helpers (the JAX package's
utils/network.py, copied; reference radio/utilities/network_utils.lua,
there raw POSIX sockets over FFI, here the Python socket module).  Used by
the network source and sink blocks.
"""

from __future__ import annotations

import os
import socket
import time


def _parse_tcp_address(address: str) -> tuple[str, int]:
    host, sep, port = address.rpartition(":")
    if not sep:
        raise ValueError(f"invalid address {address!r} (expected host:port)")
    host = host.strip("[]")  # IPv6 literals
    return host, int(port)


class NetworkClient:
    """Connect-with-retry client over TCP or UNIX sockets
    (reference: network_utils.lua NetworkClient)."""

    def __init__(self, transport: str, address: str):
        if transport not in ("tcp", "unix"):
            raise ValueError(f"unsupported transport {transport!r}")
        self.transport = transport
        self.address = address
        self.sock: socket.socket | None = None

    def connected(self) -> bool:
        return self.sock is not None

    def connect(self) -> bool:
        try:
            if self.transport == "tcp":
                self.sock = socket.create_connection(
                    _parse_tcp_address(self.address), timeout=None)
                self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            else:
                s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                s.connect(self.address)
                self.sock = s
            return True
        except OSError:
            self.sock = None
            return False

    def connect_blocking(self, retry_delay: float = 0.2):
        while not self.connect():
            time.sleep(retry_delay)

    def recv(self, n: int) -> bytes:
        try:
            return self.sock.recv(n)
        except OSError:
            return b""

    def sendall(self, data: bytes) -> bool:
        try:
            self.sock.sendall(data)
            return True
        except OSError:
            return False

    def close(self):
        if self.sock is not None:
            try:
                self.sock.close()
            finally:
                self.sock = None


class NetworkServer:
    """Single-client listening server over TCP or UNIX sockets
    (reference: network_utils.lua NetworkServer)."""

    def __init__(self, transport: str, address: str):
        if transport not in ("tcp", "unix"):
            raise ValueError(f"unsupported transport {transport!r}")
        self.transport = transport
        self.address = address
        self.listener: socket.socket | None = None
        self.sock: socket.socket | None = None

    def listen(self):
        if self.transport == "tcp":
            host, port = _parse_tcp_address(self.address)
            self.listener = socket.create_server((host, port),
                                                 reuse_port=False)
        else:
            if os.path.exists(self.address):
                os.unlink(self.address)
            self.listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self.listener.bind(self.address)
            self.listener.listen(1)

    def accept(self):
        self.sock, _ = self.listener.accept()
        if self.transport == "tcp":
            self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def connected(self) -> bool:
        return self.sock is not None

    def recv(self, n: int) -> bytes:
        try:
            return self.sock.recv(n)
        except OSError:
            return b""

    def sendall(self, data: bytes) -> bool:
        try:
            self.sock.sendall(data)
            return True
        except OSError:
            self.sock.close()
            self.sock = None
            return False

    def close(self):
        for s in (self.sock, self.listener):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
        self.sock = self.listener = None
        if self.transport == "unix" and os.path.exists(self.address):
            try:
                os.unlink(self.address)
            except OSError:
                pass


__all__ = ["NetworkClient", "NetworkServer"]
