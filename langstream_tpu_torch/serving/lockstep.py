"""Lockstep execution of a multi-process engine (port of
``langstream_tpu/serving/lockstep.py``).

PyTorch runs one process per rank, so every mesh of the port is
multi-process, and this module is how any of them serves. Only rank 0
(the leader) consumes requests, admits them into slots and samples the
tokens it returns; ranks 1..N-1 know nothing of arrivals. Yet every rank
must run the same model calls in the same order, or the first collective
of the model code waits on a peer that never calls it.

The leader broadcasts a compact **step descriptor** over a TCP side
channel before every dispatch: the op kind (prefill, continuation, decode
chunk, speculative step), its static choices (window, steps per chunk,
sampler mode) and its host inputs (token ids, lengths, block tables, slot
masks, sampling settings, and the state of the engine's generator).
Followers replay each descriptor as the same call of the port's engine on
their shards (:meth:`LockstepFollower.run`). Ordering is TCP FIFO; the
device collectives ride ``torch.distributed``. Every rank samples from the
same gathered logits with the same generator state, so every rank ends a
chunk with the same tokens, and a ``decode_cont`` chunk chains each
process's own device-resident tokens and lengths.

Why a TCP channel and not a device broadcast: descriptor shapes vary by
op, which a device broadcast must know ahead of time on every rank; a byte
stream has no such constraint, keeps the control plane off the card, and
fails loudly (a socket error) instead of hanging a collective when a rank
dies.

Wire format (no pickle; the channel crosses pod boundaries), byte for
byte the JAX package's: ``u32 big-endian frame length | u32 header length
| JSON header | concatenated raw array bytes``; the header maps argument
names to dtype/shape/offset.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import struct
import threading
import time
from typing import Any

import numpy as np
import torch

log = logging.getLogger(__name__)

DEFAULT_PORT = 7077


class LockstepBroken(RuntimeError):
    """The lockstep group lost a member (or the channel failed): partial
    frame delivery is unrecoverable (survivors would run collectives the
    others never heard about), so the slice must restart as a unit. The
    engine fails in-flight work and stops serving when it sees this."""


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------


def encode_descriptor(desc: dict[str, Any]) -> bytes:
    """``desc``: flat dict of scalars (str/int/float/bool/None, lists of
    them) and numpy arrays. Arrays are shipped raw; everything else rides
    the JSON header."""
    scalars: dict[str, Any] = {}
    arrays: dict[str, dict[str, Any]] = {}
    blobs: list[bytes] = []
    offset = 0
    for key, value in desc.items():
        if isinstance(value, np.ndarray):
            raw = np.ascontiguousarray(value)
            blob = raw.tobytes()
            arrays[key] = {
                "dtype": str(raw.dtype),
                "shape": list(raw.shape),
                "offset": offset,
                "nbytes": len(blob),
            }
            blobs.append(blob)
            offset += len(blob)
        else:
            scalars[key] = value
    header = json.dumps({"scalars": scalars, "arrays": arrays}).encode()
    payload = struct.pack(">I", len(header)) + header + b"".join(blobs)
    return struct.pack(">I", len(payload)) + payload


def decode_descriptor(payload: bytes) -> dict[str, Any]:
    (header_len,) = struct.unpack(">I", payload[:4])
    header = json.loads(payload[4 : 4 + header_len])
    out: dict[str, Any] = dict(header["scalars"])
    base = 4 + header_len
    for key, meta in header["arrays"].items():
        start = base + meta["offset"]
        out[key] = np.frombuffer(
            payload[start : start + meta["nbytes"]], dtype=meta["dtype"]
        ).reshape(meta["shape"])
    return out


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("lockstep peer closed the channel")
        buf.extend(chunk)
    return bytes(buf)


def read_frame(sock: socket.socket) -> dict[str, Any]:
    (length,) = struct.unpack(">I", _read_exact(sock, 4))
    return decode_descriptor(_read_exact(sock, length))


# ---------------------------------------------------------------------------
# leader
# ---------------------------------------------------------------------------


class LockstepLeader:
    """Rank-0 side: accepts follower connections, handshakes the serving
    config, then fans every descriptor out in order. ``broadcast`` is called
    from the engine's single dispatch thread, so frames reach every follower
    in dispatch order.

    Membership is fixed at start: a follower that dies cannot rejoin (its
    process left the ``torch.distributed`` group; collectives with a fresh
    process would hang), so the slice restarts as a unit. Late or extra
    connectors get an explicit ``reject`` frame instead of a silent hang.
    Joins are authenticated with the shared ``token``
    (``LS_LOCKSTEP_TOKEN``), so an arbitrary connector can neither read
    prompt descriptors nor take a membership slot."""

    def __init__(self, serving_config_dict: dict[str, Any],
                 expected_followers: int, port: int | None = None,
                 token: str = ""):
        self.expected = expected_followers
        self.handshake = serving_config_dict
        self.token = token
        self._followers: list[socket.socket] = []
        self._lock = threading.Lock()
        self._broken = False
        self._closed = False
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind(("0.0.0.0", port if port is not None else DEFAULT_PORT))
        self._server.listen(max(expected_followers, 1))
        self.port = self._server.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="lockstep-accept", daemon=True
        )
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, addr = self._server.accept()
            except OSError:
                return  # closed
            try:
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                join = read_frame(conn)
                if join.get("op") != "join" or join.get("token", "") != self.token:
                    log.warning("lockstep: rejecting unauthenticated %s", addr)
                    conn.sendall(encode_descriptor(
                        {"op": "reject", "reason": "bad token"}
                    ))
                    conn.close()
                    continue
                with self._lock:
                    if (self._broken or self._closed
                            or len(self._followers) >= self.expected):
                        # a restarted follower is a fresh process the group
                        # cannot re-admit: tell it so, loudly
                        conn.sendall(encode_descriptor({
                            "op": "reject",
                            "reason": "slice membership is full or broken; "
                                      "the whole slice must restart together",
                        }))
                        conn.close()
                        continue
                    conn.sendall(
                        encode_descriptor({"op": "handshake", **self.handshake})
                    )
                    self._followers.append(conn)
                    joined = len(self._followers)
                log.info(
                    "lockstep follower %s joined (%d/%d)",
                    addr, joined, self.expected,
                )
            except (OSError, ConnectionError) as e:
                log.warning("lockstep accept of %s failed: %s", addr, e)
                try:
                    conn.close()
                except OSError:
                    pass

    def wait_ready(self, timeout: float = 600.0) -> None:
        """Block until every follower is connected: the first dispatch
        would otherwise broadcast into the void and wait in a collective
        for processes that never heard about the step."""
        deadline = time.monotonic() + timeout
        while len(self._followers) < self.expected:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"only {len(self._followers)}/{self.expected} lockstep "
                    f"followers joined within {timeout}s"
                )
            time.sleep(0.05)

    def broadcast(self, desc: dict[str, Any]) -> None:
        """Send to every follower. Any send failure poisons the group:
        surviving followers may have replayed frames a dead one never saw,
        so the only safe outcome is a loud LockstepBroken; the engine stops
        serving and the slice restarts together."""
        frame = encode_descriptor(desc)
        failed: list[str] = []
        with self._lock:
            if self._broken:
                raise LockstepBroken("lockstep group already failed")
            for conn in self._followers:
                try:
                    conn.sendall(frame)
                except OSError as e:
                    failed.append(str(e))
            if failed:
                self._broken = True
                for conn in self._followers:
                    try:
                        conn.close()
                    except OSError:
                        pass
                self._followers.clear()
        if failed:
            raise LockstepBroken(
                f"lost lockstep follower(s): {failed}; slice must restart"
            )

    def close(self) -> None:
        """Stop listening, then send ``stop``: a follower that reconnects
        at once (the next group on the same port) must not reach this
        leader's accept loop. ``shutdown`` wakes that loop, so the port is
        released."""
        with self._lock:
            self._closed = True
        for end in (lambda: self._server.shutdown(socket.SHUT_RDWR), self._server.close):
            try:
                end()
            except OSError:
                pass
        try:
            self.broadcast({"op": "stop"})
        except (OSError, LockstepBroken):
            pass
        with self._lock:
            for conn in self._followers:
                try:
                    conn.close()
                except OSError:
                    pass
            self._followers.clear()


# ---------------------------------------------------------------------------
# follower
# ---------------------------------------------------------------------------


def _mode(desc: dict[str, Any]) -> tuple:
    return tuple(bool(x) for x in desc["sampler_mode"])


class LockstepFollower:
    """Rank 1..N-1: connects to the leader, builds the *same* engine
    (params, caches: the identical construction path, so identical full
    trees, each rank keeping its shards), then replays descriptors until
    the leader says stop. Runs synchronously; call from the follower's main
    thread or one thread of its own. ``device`` is where the engine runs
    (``cuda``: card ``rank % cards``)."""

    def __init__(self, leader_host: str, port: int | None = None,
                 connect_timeout: float = 600.0, token: str = "",
                 device="cuda", record_tokens: bool = False):
        self.addr = (leader_host, port if port is not None else DEFAULT_PORT)
        self.connect_timeout = connect_timeout
        self.token = token
        self.device = device
        self.engine = None
        #: with ``record_tokens``, the tokens each replayed op sampled on
        #: this rank, in replay order (``(op, int32 array)``), to hold
        #: against the leader's (the demo and the tests ask for it)
        self.tokens_log: list[tuple[str, np.ndarray]] | None = (
            [] if record_tokens else None)
        # stop() is a cross-thread signal: the pod's event loop calls it
        # while run() blocks in recv on the replay thread
        self._sock_lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._stopping = threading.Event()

    def _record(self, op: str, tokens) -> None:
        if self.tokens_log is not None:
            self.tokens_log.append((op, np.asarray(tokens).copy()))

    def stop(self) -> None:
        """Unblock a blocked ``run`` (SIGTERM path): closing the socket
        makes the pending recv raise, and ``run`` returns cleanly. Safe to
        call from any thread."""
        self._stopping.set()
        with self._sock_lock:
            sock = self._sock
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _connect(self) -> socket.socket:
        deadline = time.monotonic() + self.connect_timeout
        while True:
            if self._stopping.is_set():
                raise ConnectionAbortedError("lockstep follower stopping")
            try:
                sock = socket.create_connection(self.addr, timeout=10.0)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                sock.settimeout(None)
                return sock
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)

    def run(self, die_after_steps: int | None = None) -> int:
        """Returns the number of descriptors replayed.

        ``die_after_steps`` is fault injection: after replaying N
        descriptors the process dies via ``os._exit``, no socket shutdown,
        no goodbye, which is what a follower killed mid-burst looks like to
        the leader."""
        from langstream_tpu_torch.serving.engine import ServingConfig, TorchServingEngine

        try:
            sock = self._connect()
        except ConnectionAbortedError:
            return 0  # stop() before any connection: nothing replayed
        with self._sock_lock:
            self._sock = sock
            stopping = self._stopping.is_set()
        if stopping:
            try:
                sock.close()
            except OSError:
                pass
            return 0
        sock.sendall(encode_descriptor({"op": "join", "token": self.token}))
        handshake = read_frame(sock)
        if handshake.get("op") == "reject":
            raise RuntimeError(
                f"lockstep join rejected: {handshake.get('reason')}"
            )
        if handshake.get("op") != "handshake":
            raise RuntimeError(f"expected handshake, got {handshake.get('op')}")
        config = ServingConfig.from_dict(json.loads(handshake["config_json"]))
        self.engine = engine = TorchServingEngine(
            config, device=self.device, lockstep_role="follower")
        steps = 0
        log.info("lockstep follower ready (model %s)", config.model)
        carry: tuple | None = None  # the last decode chunk's device tokens, lengths
        while True:
            try:
                desc = read_frame(sock)
            except (ConnectionError, OSError):
                if self._stopping.is_set():
                    break  # stop() closed the socket: clean local shutdown
                raise
            op = desc.get("op")
            if op == "stop":
                break
            # the engine takes writable arrays (frombuffer's are read-only)
            desc = {k: v.copy() if isinstance(v, np.ndarray) else v
                    for k, v in desc.items()}
            if "gen" in desc:
                engine._generator.set_state(torch.from_numpy(desc["gen"]))
            if op in ("decode", "decode_cont"):
                if op == "decode":
                    tokens, lengths = desc["tokens"], desc["lengths"]
                else:
                    if carry is None:
                        raise RuntimeError("decode_cont before any decode chunk")
                    tokens, lengths = carry
                K = int(desc["k"])
                pen = None
                if desc.get("pen"):
                    pen = (desc["pres"], desc["freq"], desc["counts"])
                handle, *carry = engine._dispatch_decode(
                    tokens, lengths,
                    (desc["active"], desc["temps"], desc["topks"], desc["topps"]),
                    desc.get("tables"), desc.get("window"), K, _mode(desc), pen,
                )
                self._record(op, engine._wait_chunk(handle, K)[0])
            elif op in ("prefill", "prefill_continue"):
                cont = None
                if op == "prefill_continue":
                    cont = (desc["starts"], int(desc["nrb"]))
                self._record(op, engine._run_prefill(
                    desc["tokens"], desc["lengths"], desc["slot_ids"],
                    desc.get("tables"), desc["temps"], desc["topks"],
                    desc["topps"], _mode(desc), cont=cont,
                )[0])
            elif op == "spec_step":
                self._record(op, engine._run_spec_step(
                    desc.get("ctx_rows"), desc.get("ctx_vals"), desc["current"],
                    desc["lengths"], desc["active"], desc["tables"], int(desc["nrb"]),
                    _mode(desc), desc["temps"], desc["topks"], desc["topps"],
                )[0][0])
            else:
                raise RuntimeError(f"unknown lockstep op {op!r}")
            engine._ls_seq += 1
            steps += 1
            if die_after_steps is not None and steps >= die_after_steps:
                log.error("fault injection: follower dying after %d steps", steps)
                os._exit(3)
        sock.close()
        return steps
