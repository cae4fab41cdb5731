"""The part of the ZMQ wire protocol (ZMTP 3.x, https://rfc.zeromq.org/spec/23/
and /spec/37/) that one REQ/REP pair needs, on plain TCP sockets: the
remote matcher engine (``io/remote_matcher.py``) talks to pyzmq peers
with it, and the card's machine has no pyzmq.

  * greeting, 64 bytes: ``FF``, 8 pad bytes, ``7F``, version 3.0, the
    mechanism ``NULL`` padded to 20 bytes, as-server 0, 31 zero bytes.
    Peers of version 3.x (libzmq 4.x sends 3.0 or 3.1) are accepted;
  * the NULL handshake: each side sends a READY command carrying its
    ``Socket-Type``; the peer's ``Identity`` is kept and any other
    property is ignored.  A REQ talks to a REP or ROUTER, a REP to a REQ or
    DEALER;
  * frames: a flags byte (``MORE`` 0x01, ``LONG`` 0x02 for an 8-byte
    big-endian size instead of 1 byte, ``COMMAND`` 0x04), the size, the
    body.  A PING command (3.1 heartbeats) is answered with PONG, other
    commands after the handshake are skipped;
  * REQ puts an empty delimiter frame before the request and strips it
    from the reply; REP answers with the envelope it received, up to and
    including that frame, before the reply.

Timeouts raise ``TimeoutError`` (pyzmq raises ``zmq.Again`` after
``RCVTIMEO``/``SNDTIMEO``).  A REQ whose request timed out drops its
connection and reconnects at the next request.
"""
from __future__ import annotations

import selectors
import socket
import struct
import time

MORE, LONG, COMMAND = 0x01, 0x02, 0x04
GREETING = (b"\xff" + b"\x00" * 8 + b"\x7f" + bytes([3, 0])
            + b"NULL".ljust(20, b"\x00") + b"\x00" + b"\x00" * 31)
_PEERS = {b"REQ": (b"REP", b"ROUTER"), b"REP": (b"REQ", b"DEALER")}


class ProtocolError(ConnectionError):
    """The peer broke ZMTP 3.x or is of an incompatible socket type."""


def _frame(body: bytes, flags: int) -> bytes:
    if len(body) > 255:
        return bytes([flags | LONG]) + struct.pack(">Q", len(body)) + body
    return bytes([flags, len(body)]) + body


def _command(name: bytes, data: bytes = b"") -> bytes:
    return _frame(bytes([len(name)]) + name + data, COMMAND)


def _properties(props: dict[bytes, bytes]) -> bytes:
    return b"".join(bytes([len(k)]) + k + struct.pack(">I", len(v)) + v
                    for k, v in props.items())


def _parse_properties(data: bytes) -> dict[bytes, bytes]:
    props, i = {}, 0
    while i < len(data):
        n = data[i]
        name = data[i + 1:i + 1 + n]
        i += 1 + n
        (m,) = struct.unpack(">I", data[i:i + 4])
        props[name] = data[i + 4:i + 4 + m]
        i += 4 + m
    return props


class Connection:
    """One ZMTP 3.x peer on a connected TCP socket (blocking, with the
    socket's timeout)."""

    def __init__(self, sock: socket.socket, socket_type: bytes):
        self.sock = sock
        self.socket_type = socket_type
        self.peer_identity = b""
        self.peer_type = b""

    def _recv_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self.sock.recv(min(n - len(buf), 1 << 20))
            if not chunk:
                raise ConnectionError("ZMTP peer closed the connection")
            buf += chunk
        return bytes(buf)

    def handshake(self):
        self.sock.sendall(GREETING)
        g = self._recv_exact(64)
        if g[0] != 0xFF or g[9] != 0x7F:
            raise ProtocolError("not a ZMTP greeting")
        if g[10] != 3:
            raise ProtocolError(f"ZMTP version {g[10]}.{g[11]} (3.x needed)")
        if g[12:32].rstrip(b"\x00") != b"NULL":
            raise ProtocolError(f"mechanism {g[12:32].rstrip(bytes(1))!r} (NULL needed)")
        self.sock.sendall(_command(b"READY", _properties({b"Socket-Type": self.socket_type})))
        while True:
            flags, body = self._read_frame()
            if not flags & COMMAND:
                raise ProtocolError("a message frame before READY")
            name = body[1:1 + body[0]]
            if name == b"ERROR":
                raise ProtocolError(f"peer error: {body[1 + body[0] + 1:]!r}")
            if name == b"READY":
                props = _parse_properties(body[1 + body[0]:])
                break
        self.peer_type = props.get(b"Socket-Type", b"")
        self.peer_identity = props.get(b"Identity", b"")
        if self.peer_type not in _PEERS[self.socket_type]:
            raise ProtocolError(f"{self.socket_type.decode()} cannot talk to "
                                f"{self.peer_type.decode() or 'an untyped socket'}")

    def _read_frame(self) -> tuple[int, bytes]:
        flags = self._recv_exact(1)[0]
        if flags & LONG:
            (n,) = struct.unpack(">Q", self._recv_exact(8))
        else:
            n = self._recv_exact(1)[0]
        return flags, self._recv_exact(n)

    def send_multipart(self, frames: list[bytes]):
        last = len(frames) - 1
        self.sock.sendall(b"".join(_frame(bytes(f), 0 if i == last else MORE)
                                   for i, f in enumerate(frames)))

    def recv_multipart(self) -> list[bytes]:
        frames = []
        while True:
            flags, body = self._read_frame()
            if flags & COMMAND:
                name = body[1:1 + body[0]]
                if name == b"PING":  # context follows the 2-byte TTL
                    self.sock.sendall(_command(b"PONG", body[1 + body[0] + 2:]))
                continue
            frames.append(body)
            if not flags & MORE:
                return frames

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


class ReqSocket:
    """A REQ socket with one peer, connected at its first request and
    retried until ``timeout_ms`` (a ZMQ REQ ``connect`` never fails at
    once; the server need not be up when the socket is made)."""

    def __init__(self, host: str, port: int, timeout_ms: int = 30000):
        self.host, self.port = host, int(port)
        self.timeout = timeout_ms / 1000.0
        self._conn: Connection | None = None

    def _connect(self) -> Connection:
        deadline = time.monotonic() + self.timeout
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"no ZMQ REP peer at tcp://{self.host}:{self.port} within "
                    f"{self.timeout:g} s")
            try:
                sock = socket.create_connection((self.host, self.port), timeout=left)
            except OSError:
                time.sleep(min(0.05, max(left, 0)))
                continue
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(self.timeout)
            conn = Connection(sock, b"REQ")
            try:
                conn.handshake()
            except socket.timeout:
                conn.close()
                raise TimeoutError("ZMTP handshake timed out") from None
            return conn

    def request(self, frames: list[bytes]) -> list[bytes]:
        """Send one request and return the reply's frames."""
        if self._conn is None:
            self._conn = self._connect()
        try:
            self._conn.send_multipart([b""] + list(frames))
            rep = self._conn.recv_multipart()
        except socket.timeout:
            self.close()
            raise TimeoutError(
                f"no reply from tcp://{self.host}:{self.port} within "
                f"{self.timeout:g} s") from None
        except (ConnectionError, OSError):
            self.close()
            raise
        if not rep or rep[0] != b"":
            self.close()
            raise ProtocolError("reply without the REQ delimiter frame")
        return rep[1:]

    def close(self):
        if self._conn is not None:
            self._conn.close()
            self._conn = None


class RepSocket:
    """A REP socket bound to ``host:port`` (0 = a free port) serving any
    number of connected peers, one request at a time."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 timeout_ms: int = 30000):
        self.timeout = timeout_ms / 1000.0
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, int(port)))
        self._lsock.listen(16)
        self._lsock.setblocking(False)
        self.port = self._lsock.getsockname()[1]
        self._sel = selectors.DefaultSelector()
        self._sel.register(self._lsock, selectors.EVENT_READ, None)

    def serve_one(self, handler, timeout_ms: int = 200) -> bool:
        """Wait up to ``timeout_ms`` for a request, answer it with
        ``handler(frames) -> frames``; False when none came."""
        for key, _ in self._sel.select(timeout_ms / 1000.0):
            if key.data is None:
                self._accept()
                continue
            conn: Connection = key.data
            try:
                msg = conn.recv_multipart()
                n = next((i for i, f in enumerate(msg) if f == b""), None)
                if n is None:
                    raise ProtocolError("request without the REQ delimiter frame")
                conn.send_multipart(msg[:n + 1] + list(handler(msg[n + 1:])))
            except (ConnectionError, OSError):
                self._drop(conn)
                continue
            return True
        return False

    def _accept(self):
        try:
            sock, _ = self._lsock.accept()
        except BlockingIOError:
            return
        sock.setblocking(True)
        sock.settimeout(self.timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn = Connection(sock, b"REP")
        try:
            conn.handshake()
        except (ConnectionError, OSError):
            conn.close()
            return
        self._sel.register(sock, selectors.EVENT_READ, conn)

    def _drop(self, conn: Connection):
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        conn.close()

    def close(self):
        for key in list(self._sel.get_map().values()):
            if key.data is not None:
                self._drop(key.data)
        self._sel.close()
        self._lsock.close()
