"""The port's remote matcher engine (``bundlesdf_tpu_torch/io/
remote_matcher.py``) and its ZMTP sockets (``io/zmtp.py``) against pyzmq's
REQ/REP and the JAX package's ``MatchServer``/``RemoteMatcher``
(``bundlesdf_tpu/io/remote_matcher.py``), in both directions.  Every
server binds port 0, so that parallel test workers never collide."""
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch
import zmq

from bundlesdf_tpu.io import remote_matcher as jrm
from bundlesdf_tpu.models.matcher import SiftMatcher as JSiftMatcher
from bundlesdf_tpu_torch.io import remote_matcher as trm
from bundlesdf_tpu_torch.io import zmtp
from bundlesdf_tpu_torch.models.matcher import SiftMatcher

torch.set_num_threads(2)


class StubEngine:
    """A numpy engine whose output encodes its input: row k of pair i holds
    A's pixel (0, k), B's pixel (1, k), the pair index and the batch."""

    def __init__(self, compiled=False, K=8):
        self.compiled = compiled
        self.K = K
        self.batches = []

    def predict(self, a, b):
        a, b = np.asarray(a), np.asarray(b)
        self.batches.append(len(a))
        B = len(a)
        c = np.zeros((B, self.K, 5), np.float32)
        c[..., 0] = a[:, 0, :self.K]
        c[..., 1] = b[:, 1, :self.K]
        c[..., 2] = np.arange(B)[:, None]
        c[..., 3] = B
        v = (np.arange(self.K)[None] + np.arange(B)[:, None]) % 3 != 0
        return c, v


class SlowEngine(StubEngine):
    def predict(self, a, b):
        time.sleep(1.5)
        return super().predict(a, b)


def blob_pairs(size=96):
    """The image of tests/test_remote_matcher.py and its shifted copy."""
    import cv2

    rng = np.random.default_rng(0)
    img = np.zeros((size, size), np.uint8)
    for _ in range(30):
        y, x = rng.integers(8, size - 8, 2)
        img[y - 3:y + 3, x - 3:x + 3] = rng.integers(80, 255)
    img = cv2.GaussianBlur(img, (5, 5), 1.0)
    return np.stack([img, np.roll(img, 5, axis=1)]), np.stack([img, img])


def _images(B, H, W, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (B, H, W)).astype(np.uint8),
            rng.integers(0, 256, (B, H, W)).astype(np.uint8))


def test_port_client_against_jax_server():
    """The port's RemoteMatcher asks the JAX MatchServer serving the JAX
    SiftMatcher: the reply equals ``engine.predict``
    (tests/test_remote_matcher.py:24-29)."""
    a, b = blob_pairs()
    engine = JSiftMatcher(max_matches=64)
    server = jrm.MatchServer(engine, port=0).start()
    try:
        client = trm.RemoteMatcher(server.port)
        corres, valid = client.predict(a, b)
        ref_c, ref_v = engine.predict(a, b)
        np.testing.assert_array_equal(corres, ref_c)
        np.testing.assert_array_equal(valid, ref_v)
        assert valid[0].sum() >= 5
        client.close()
    finally:
        server.stop()


@pytest.mark.parametrize("engine", ["stub", "sift"])
def test_jax_client_against_port_server(engine):
    """The JAX RemoteMatcher (pyzmq REQ) asks the port's MatchServer serving
    a numpy stub or the port's SiftMatcher on the CPU."""
    a, b = blob_pairs()
    eng = StubEngine() if engine == "stub" else SiftMatcher(max_matches=64, device="cpu")
    server = trm.MatchServer(eng, port=0).start()
    try:
        client = jrm.RemoteMatcher(server.port)
        corres, valid = client.predict(a, b)
        ref_c, ref_v = eng.predict(a, b)
        np.testing.assert_array_equal(corres, ref_c)
        np.testing.assert_array_equal(valid, ref_v)
        assert valid[0].sum() >= 5 and server.served == 1
        client.close()
    finally:
        server.stop()


def test_port_client_against_port_server():
    """Port against port, with f32 [0, 1] input converted by the client as
    the JAX client converts it, and torch tensors accepted."""
    a, b = blob_pairs()
    eng = StubEngine()
    server = trm.MatchServer(eng, port=0).start()
    try:
        client = trm.RemoteMatcher(server.port)
        af, bf = a.astype(np.float32) / 255.0, b.astype(np.float32) / 255.0
        corres, valid = client.predict(torch.from_numpy(af), torch.from_numpy(bf))
        mx = float(af.max())
        ref_c, ref_v = eng.predict((af / mx * 255).astype(np.uint8),
                                   (bf / mx * 255).astype(np.uint8))
        np.testing.assert_array_equal(corres, ref_c)
        np.testing.assert_array_equal(valid, ref_v)
        client.close()
    finally:
        server.stop()


@pytest.mark.parametrize("n,n_pad", [(3, 16), (17, 32)])
def test_server_pads_compiled_engines(n, n_pad):
    """An engine with ``compiled = True`` sees the batch padded to {1,
    pair_batch, next power of two} (the JAX server's ``_serve_one``,
    :52-74); the reply is trimmed to the request's pairs.  A host engine
    runs unpadded.  The JAX client reads both."""
    a, b = _images(n, 8, 12, seed=n)
    for compiled, seen in ((True, n_pad), (False, n)):
        eng = StubEngine(compiled=compiled)
        server = trm.MatchServer(eng, port=0).start()
        try:
            client = jrm.RemoteMatcher(server.port)
            corres, valid = client.predict(a, b)
            assert eng.batches == [seen]
            assert corres.shape == (n, 8, 5) and valid.shape == (n, 8)
            ref_c, ref_v = StubEngine().predict(a, b)
            np.testing.assert_array_equal(corres[..., :3], ref_c[..., :3])
            np.testing.assert_array_equal(corres[..., 3], float(seen))
            np.testing.assert_array_equal(valid, ref_v)
            client.close()
        finally:
            server.stop()


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_long_frames_480x640(direction):
    """480 x 640 images (307200-byte frames, past the 255-byte short frame)
    both ways."""
    a, b = _images(2, 480, 640, seed=7)
    eng = StubEngine(K=600)
    if direction == "port_to_jax":
        server, client = jrm.MatchServer(eng, port=0).start(), None
        client = trm.RemoteMatcher(server.port)
    else:
        server = trm.MatchServer(eng, port=0).start()
        client = jrm.RemoteMatcher(server.port)
    try:
        corres, valid = client.predict(a, b)
        ref_c, ref_v = StubEngine(K=600).predict(a, b)
        np.testing.assert_array_equal(corres, ref_c)
        np.testing.assert_array_equal(valid, ref_v)
        client.close()
    finally:
        server.stop()


def test_client_made_before_server():
    """The client connects at its first predict, retrying: made before any
    server listens (as CorresStore makes it), it reaches a server that
    comes up afterwards, on the port and on the JAX server."""
    for server_cls in (trm.MatchServer, jrm.MatchServer):
        probe = socket.socket()
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
        probe.close()
        client = trm.RemoteMatcher(port, timeout_ms=10000)
        box = {}

        def late():
            time.sleep(0.5)
            box["server"] = server_cls(StubEngine(), port=port).start()

        t = threading.Thread(target=late)
        t.start()
        try:
            a, b = _images(2, 16, 16)
            corres, _ = client.predict(a, b)
            np.testing.assert_array_equal(corres, StubEngine().predict(a, b)[0])
        finally:
            t.join()
            client.close()
            box["server"].stop()


@pytest.mark.parametrize("case", ["no_server", "slow_engine"])
def test_timeout_raises(case):
    """A request that gets no reply within ``timeout_ms`` raises
    TimeoutError (pyzmq raises zmq.Again); the client reconnects and works
    afterwards."""
    a, b = _images(1, 16, 16)
    if case == "no_server":
        probe = socket.socket()
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
        probe.close()
        client = trm.RemoteMatcher(port, timeout_ms=300)
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            client.predict(a, b)
        assert time.monotonic() - t0 < 5
        return
    server = trm.MatchServer(SlowEngine(), port=0).start()
    try:
        client = trm.RemoteMatcher(server.port, timeout_ms=400)
        with pytest.raises(TimeoutError):
            client.predict(a, b)
        client2 = trm.RemoteMatcher(server.port, timeout_ms=10000)
        corres, _ = client2.predict(a, b)
        np.testing.assert_array_equal(corres, StubEngine().predict(a, b)[0])
        client.close()
        client2.close()
    finally:
        t0 = time.monotonic()
        server.stop()
        assert time.monotonic() - t0 < 5


def test_two_clients_in_turn():
    """The server takes a new client after one closes, and serves two
    clients that stay connected, one request at a time; stop() joins its
    thread within 5 s."""
    eng = StubEngine()
    server = trm.MatchServer(eng, port=0).start()
    a, b = _images(2, 16, 16)
    ref = StubEngine().predict(a, b)[0]
    try:
        for cls in (trm.RemoteMatcher, jrm.RemoteMatcher, trm.RemoteMatcher):
            c = cls(server.port)
            np.testing.assert_array_equal(c.predict(a, b)[0], ref)
            c.close()
        c1, c2 = trm.RemoteMatcher(server.port), jrm.RemoteMatcher(server.port)
        for _ in range(2):
            np.testing.assert_array_equal(c1.predict(a, b)[0], ref)
            np.testing.assert_array_equal(c2.predict(a, b)[0], ref)
        c1.close()
        c2.close()
        assert server.served == 7
    finally:
        t0 = time.monotonic()
        server.stop()
        assert time.monotonic() - t0 < 5
        assert not server._thread.is_alive()


def test_zmtp_greeting_and_frames():
    """The 64-byte greeting's layout and the short and long frame headers."""
    g = zmtp.GREETING
    assert len(g) == 64 and g[0] == 0xFF and g[9] == 0x7F and g[10:12] == bytes([3, 0])
    assert g[12:32] == b"NULL" + bytes(16) and g[32] == 0 and g[33:] == bytes(31)
    assert zmtp._frame(b"ab", zmtp.MORE) == b"\x01\x02ab"
    long = zmtp._frame(b"x" * 300, 0)
    assert long[0] == zmtp.LONG and struct.unpack(">Q", long[1:9])[0] == 300
    props = zmtp._properties({b"Socket-Type": b"REQ", b"Identity": b"", b"X-Other": b"1"})
    assert zmtp._parse_properties(props) == {b"Socket-Type": b"REQ", b"Identity": b"",
                                             b"X-Other": b"1"}


def _raw_peer(port, minor, socket_type=b"REQ", extra=None):
    """A hand-rolled ZMTP 3.<minor> REQ on a raw socket: greeting, READY
    with ``Identity`` and an unknown property, one request; returns the
    reply's frames or raises."""
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    conn = zmtp.Connection(s, socket_type)
    try:
        g = bytearray(zmtp.GREETING)
        g[11] = minor
        s.sendall(bytes(g))
        peer = conn._recv_exact(64)
        assert peer[10] == 3
        props = {b"Socket-Type": socket_type, b"Identity": b"me", b"X-Extra": b"?"}
        s.sendall(zmtp._command(b"READY", zmtp._properties(props)))
        flags, body = conn._read_frame()
        assert flags & zmtp.COMMAND and body[1:6] == b"READY"
        assert zmtp._parse_properties(body[6:])[b"Socket-Type"] == b"REP"
        conn.send_multipart([b"", *(extra or [])])
        return conn.recv_multipart()
    finally:
        conn.close()


@pytest.mark.parametrize("minor", [0, 1])
def test_port_server_accepts_zmtp_minor_versions(minor):
    """A REQ peer of ZMTP 3.0 or 3.1 that sends an Identity and an unknown
    property in its READY is served; the reply echoes the envelope (the
    empty delimiter) before the reply frames.  A peer of an incompatible
    socket type gets no reply."""
    server = trm.MatchServer(StubEngine(), port=0).start()
    a, b = _images(1, 4, 9)
    try:
        hdr = np.array([1, 4, 9], np.int32).tobytes()
        rep = _raw_peer(server.port, minor, extra=[hdr, a[0].tobytes(), b[0].tobytes()])
        assert rep[0] == b"" and len(rep) == 4
        np.testing.assert_array_equal(np.frombuffer(rep[2], np.float32).reshape(1, 8, 5),
                                      StubEngine().predict(a, b)[0])
        with pytest.raises((ConnectionError, OSError)):
            _raw_peer(server.port, minor, socket_type=b"PUB", extra=[hdr])
    finally:
        server.stop()


def test_port_req_against_pyzmq_rep():
    """The port's REQ socket against a bare pyzmq REP: the REP sees the
    request without the delimiter and the REQ gets the reply's frames."""
    ctx = zmq.Context.instance()
    rep = ctx.socket(zmq.REP)
    port = rep.bind_to_random_port("tcp://127.0.0.1")
    seen = {}

    def serve():
        seen["req"] = rep.recv_multipart()
        rep.send_multipart([b"ok", b"y" * 1000])

    t = threading.Thread(target=serve)
    t.start()
    req = zmtp.ReqSocket("127.0.0.1", port, timeout_ms=10000)
    try:
        assert req.request([b"a", b"b" * 400]) == [b"ok", b"y" * 1000]
        t.join(timeout=10)
        assert seen["req"] == [b"a", b"b" * 400]
    finally:
        req.close()
        rep.close(linger=0)
