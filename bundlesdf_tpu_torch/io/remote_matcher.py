"""Remote feature-matching service over ZMQ REQ/REP (port of
``bundlesdf_tpu/io/remote_matcher.py``): a matcher runs in another process
while the tracker stays lean, after the reference's out-of-process
feature servers (FeatureManager.cpp:2080-2430).  The wire protocol is
the JAX package's, so a port client talks to a JAX server and the other
way round:

  request:  frame 0 = int32 [B, H, W]; frames 1..2B = u8 grayscale images
            (pair i = frames 1+2i, 2+2i)
  reply:    frame 0 = int32 [B, K]; frame 1 = float32 (B, K, 5)
            [uA, vA, uB, vB, conf]; frame 2 = u8 (B, K) validity

The sockets are ``io/zmtp.py``'s REQ and REP (no pyzmq).  Any engine with
the ``predict(grayAs, grayBs) -> (corres, valid)`` contract can be served:
``models/matcher.py::SiftMatcher``, ``models/loftr.py::LoftrMatcher``.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from . import zmtp


class MatchServer:
    """Serves a matcher engine on a REP socket bound to ``host:port``
    (``port=0``: a free port, then in ``self.port``)."""

    def __init__(self, engine, port: int = 0, host: str = "127.0.0.1",
                 pair_batch: int = 16):
        self.engine = engine
        # Batch-size buckets for engines with compiled programs (the JAX
        # server's: every distinct batch would compile anew there); pad to
        # {1, pair_batch, next power of two}, then trim the reply.  Engines
        # with ``compiled = False`` run unpadded.
        self.pair_batch = int(pair_batch)
        self._sock = zmtp.RepSocket(host, port)
        self.port = self._sock.port
        self.served = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _reply(self, frames: list[bytes]) -> list[bytes]:
        B, H, W = np.frombuffer(frames[0], np.int32)
        imgs = [np.frombuffer(f, np.uint8).reshape(H, W) for f in frames[1:]]
        a = np.stack(imgs[0::2])
        b = np.stack(imgs[1::2])
        n = len(a)
        if getattr(self.engine, "compiled", True) and n > 1:
            if n <= self.pair_batch:
                n_pad = self.pair_batch
            else:
                n_pad = 1 << max(0, (n - 1).bit_length())
            if n_pad > n:
                a = np.concatenate([a, np.repeat(a[:1], n_pad - n, axis=0)])
                b = np.concatenate([b, np.repeat(b[:1], n_pad - n, axis=0)])
        corres, valid = self.engine.predict(a, b)
        corres = np.ascontiguousarray(np.asarray(corres)[:n], np.float32)
        valid = np.ascontiguousarray(np.asarray(valid)[:n], np.uint8)
        hdr = np.array([corres.shape[0], corres.shape[1]], np.int32)
        self.served += 1
        return [hdr.tobytes(), corres.tobytes(), valid.tobytes()]

    def _serve_one(self, timeout_ms: int = 200) -> bool:
        return self._sock.serve_one(self._reply, timeout_ms)

    def serve_forever(self):
        while not self._stop.is_set():
            self._serve_one()

    def start(self):
        self._thread = threading.Thread(target=self.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._sock.close()


class RemoteMatcher:
    """REQ-side client with the standard ``predict`` matcher contract.  It
    connects at its first ``predict``, retrying until ``timeout_ms``, so it
    can be made before its server is up, as a ZMQ REQ can."""

    # the server process owns any compile cost; the client never pads
    compiled = False

    def __init__(self, port: int, host: str = "127.0.0.1", timeout_ms: int = 30000):
        self._sock = zmtp.ReqSocket(host, port, timeout_ms)

    def predict(self, grayAs, grayBs):
        a = grayAs.cpu().numpy() if torch.is_tensor(grayAs) else np.asarray(grayAs)
        b = grayBs.cpu().numpy() if torch.is_tensor(grayBs) else np.asarray(grayBs)
        if a.dtype != np.uint8:
            mx = max(float(a.max()), 1e-6)
            a = (a / mx * 255 if mx <= 1.5 else a).astype(np.uint8)
            b = (b / mx * 255 if mx <= 1.5 else b).astype(np.uint8)
        B, H, W = a.shape
        hdr = np.array([B, H, W], np.int32)
        frames = [hdr.tobytes()]
        for i in range(B):
            frames.append(np.ascontiguousarray(a[i]).tobytes())
            frames.append(np.ascontiguousarray(b[i]).tobytes())
        rep = self._sock.request(frames)
        Bo, K = np.frombuffer(rep[0], np.int32)
        corres = np.frombuffer(rep[1], np.float32).reshape(Bo, K, 5)
        valid = np.frombuffer(rep[2], np.uint8).reshape(Bo, K).astype(bool)
        return corres, valid

    def close(self):
        self._sock.close()
