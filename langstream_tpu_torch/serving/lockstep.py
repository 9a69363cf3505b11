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
their shards (:meth:`LockstepFollower.run`). With an adapter store, the
prefill, decode and speculative frames also carry each row's adapter row
(``ad_rows``); an engine without one sends the JAX package's frames.

The tiers move rows on every rank too, in order with the model calls, on
the dispatch thread: ``kv_gather`` (a table row and the rows to fetch, none
for a demotion's whole blocks; a T0 demotion or an LSKV export),
``kv_scatter`` (a table row, the rows and their padded length; a T1
promotion, a T2 hydration's landing or an LSKV import) and ``adapter_row``
(an adapter loaded into a T0 row, evicting the row's last one). The frame
carries only the move; the rows themselves go through the mesh's
collectives (each rank's heads all-gathered to the leader, whole rows
broadcast from it), since a demotion wave is megabytes to gigabytes. Ordering is TCP FIFO; the
device collectives ride ``torch.distributed``. Every rank samples from the
same gathered logits with the same generator state, so every rank ends a
chunk with the same tokens, and a ``decode_cont`` chunk chains each
process's own device-resident tokens and lengths.

Why a TCP channel and not a device broadcast: descriptor shapes vary by
op, which a device broadcast must know ahead of time on every rank; a byte
stream has no such constraint, keeps the control plane off the card, and
fails loudly (a socket error) instead of hanging a collective when a rank
dies.

**One channel per rank.** A resource served by a completions agent and an
embeddings agent under one mesh has two engines in the leader's process;
both lead through the same :class:`LockstepLeader` (:func:`lead`, counted
by users, keyed by port), so each follower has one channel and replays one
ordered stream. The first engine opens the channel and its handshake; an
engine that joins an open channel announces itself with a frame the
followers build it from (``engine`` for a serving engine, the first
``embed`` for an embeddings engine). The last :func:`release` sends
``stop``.

**A failed build leaves the world up.** Each follower answers an ``engine``
frame with one ``built`` frame back on its channel (the frame's ``build``
number, its rank, and its error when the build raised); a follower whose
build failed drops that engine and goes on replaying. The leader reads
every answer (:meth:`LockstepLeader.await_builds`, bounded) once its own
build has ended; when the build failed on any rank, it sends
``drop_engine`` (every follower lets the engine go) and the serving
engine's constructor raises, naming each follower's error. So a serving
engine that fails to build never takes down the world an embeddings
engine leads, as in the JAX package, where both live in one process.

The serving engine's frames are byte for byte the JAX package's;
``engine``, ``built``, ``drop_engine``, ``embed`` and the three tier moves
are the port's own (the JAX engines run a one-host mesh in one process and
need no frame).

Wire format (no pickle; the channel crosses pod boundaries), byte for
byte the JAX package's: ``u32 big-endian frame length | u32 header length
| JSON header | concatenated raw array bytes``; the header maps argument
names to dtype/shape/offset.
"""

from __future__ import annotations

import json
import logging
import os
import select
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
    prompt descriptors nor take a membership slot. ``server`` is a socket
    the caller already bound and listens on (the launcher's, whose port
    its ranks were given before they started); otherwise the leader binds
    ``port``."""

    def __init__(self, serving_config_dict: dict[str, Any],
                 expected_followers: int, port: int | None = None,
                 token: str = "", server: socket.socket | None = None):
        self.expected = expected_followers
        self.handshake = serving_config_dict
        self.token = token
        self._followers: list[socket.socket] = []
        self._lock = threading.Lock()
        self._broken = False
        self._closed = False
        #: engines sharing this channel (:func:`lead`), and its key there
        self.users = 1
        self.key: int | None = None
        #: the config (JSON) of the serving engine leading this channel, if
        #: one does (a follower replays one serving engine); it clears this
        #: when it leaves
        self.serving: str | None = serving_config_dict.get("config_json")
        self._builds = 0  # the ``engine`` frames announced
        if server is None:
            server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            server.bind(("0.0.0.0", port if port is not None else DEFAULT_PORT))
            server.listen(max(expected_followers, 1))
        self._server = server
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

    def wait_ready(self, timeout: float = 600.0, check=None) -> None:
        """Block until every follower is connected: the first dispatch
        would otherwise broadcast into the void and wait in a collective
        for processes that never heard about the step. ``check()`` runs at
        every poll and raises to end the wait early (a follower process
        that already exited)."""
        deadline = time.monotonic() + timeout
        while len(self._followers) < self.expected:
            if check is not None:
                check()
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

    def announce(self, config_json: str) -> int:
        """Send the ``engine`` frame the followers build a serving engine
        from; its build number, which each follower's ``built`` answer
        carries."""
        self._builds += 1
        self.broadcast({"op": "engine", "config_json": config_json, "build": self._builds})
        return self._builds

    def await_builds(self, build: int, timeout: float) -> dict[int, str]:
        """Every follower's answer to ``engine`` frame ``build``, within
        ``timeout`` seconds: ``{rank: error}`` for the followers whose build
        raised (empty when every one built it). Raises ``TimeoutError``
        counting the followers that did not answer in time, and
        :class:`LockstepBroken` when a follower's channel closed."""
        deadline = time.monotonic() + timeout
        with self._lock:
            waiting = list(self._followers)
        failed: dict[int, str] = {}
        while waiting:
            ready, _, _ = select.select(waiting, [], [], max(0.0, deadline - time.monotonic()))
            if not ready:
                raise TimeoutError(
                    f"{len(waiting)} lockstep follower(s) did not answer the serving "
                    f"engine's build within {timeout:.0f}s")
            for conn in ready:
                try:
                    answer = read_frame(conn)
                except (ConnectionError, OSError) as e:
                    raise LockstepBroken(
                        f"a lockstep follower closed its channel during a build: {e}") from e
                if answer.get("op") != "built" or answer.get("build") != build:
                    continue  # a stale answer (an earlier build the leader gave up on)
                waiting.remove(conn)
                if answer.get("error"):
                    failed[int(answer["rank"])] = answer["error"]
        return failed

    @property
    def broken(self) -> bool:
        return self._broken

    def close(self) -> bool:
        """One user of the channel is done; the last one stops listening,
        then sends ``stop`` (a follower that reconnects at once, for the
        next group on the same port, must not reach this leader's accept
        loop; ``shutdown`` wakes that loop, so the port is released).
        Returns whether the channel closed."""
        with _LEADERS_LOCK:
            self.users -= 1
            if self.users > 0:
                return False
            if self.key is not None and _LEADERS.get(self.key) is self:
                del _LEADERS[self.key]
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
        return True


#: the process's open leaders by port
_LEADERS: dict[int, LockstepLeader] = {}
_LEADERS_LOCK = threading.Lock()


def lead(handshake: dict[str, Any], expected_followers: int, port: int | None = None,
         token: str = "", server: socket.socket | None = None
         ) -> tuple[LockstepLeader, bool]:
    """This process's leader on ``port`` (``DEFAULT_PORT`` when None) and
    whether this call opened it (with ``handshake``, on ``server`` when
    given: a socket already listening on ``port``): an engine that joins
    an open channel shares it. A serving engine (``handshake`` carries its
    ``config_json``) is refused where another serving engine leads the
    channel: the followers replay one serving engine, and the second's
    frames would replace the first's on every rank. Every call that
    returns is matched by one :meth:`LockstepLeader.close`."""
    key = port if port is not None else DEFAULT_PORT
    serving = handshake.get("config_json")
    with _LEADERS_LOCK:
        leader = _LEADERS.get(key)
        if leader is None:
            leader = LockstepLeader(handshake, expected_followers, port=key, token=token,
                                    server=server)
            leader.key = key
            _LEADERS[key] = leader
            return leader, True
        if serving is not None:
            if leader.serving is not None:
                raise ValueError(
                    f"a serving engine ({serving}) cannot join the lockstep channel "
                    f"on :{key}, which the serving engine of {leader.serving} leads: "
                    f"its ranks replay one serving engine (embeddings engines share "
                    f"the world; close the first serving engine first)")
            leader.serving = serving
        leader.users += 1
        return leader, False


def lead_world(handshake: dict[str, Any], expected_followers: int, launched=None
               ) -> tuple[LockstepLeader, bool]:
    """:func:`lead`, then wait for every follower: on the channel of the
    world this process's launcher started (``launched``, a
    :class:`~langstream_tpu_torch.parallel.launch.LocalWorld`: the port and
    token it gave its ranks, its listening socket, a wait bounded by the
    world's timeout that ends early when a rank exits), else on
    ``LS_LOCKSTEP_PORT`` with ``LS_LOCKSTEP_TOKEN``. A failed wait
    releases the channel."""
    from langstream_tpu_torch.parallel.mesh import collective_timeout_s

    if launched is not None:
        leader, opened = lead(handshake, expected_followers, port=launched.lockstep_port,
                              token=launched.token, server=launched.take_server())
    else:
        leader, opened = lead(handshake, expected_followers,
                              port=int(os.environ.get("LS_LOCKSTEP_PORT", "0")) or None,
                              token=os.environ.get("LS_LOCKSTEP_TOKEN", ""))
    log.info("lockstep leader on :%d awaiting %d followers", leader.port, expected_followers)
    try:
        if launched is not None:
            leader.wait_ready(collective_timeout_s(), check=launched.check)
        else:
            leader.wait_ready()
    except BaseException:
        leader.close()
        raise
    return leader, opened


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
        #: the embeddings engines built from ``embed`` frames, by identity
        self.embedders: dict[tuple, Any] = {}
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
        engine = None

        def build(config_json: str):
            config = ServingConfig.from_dict(json.loads(config_json))
            self.engine = TorchServingEngine(
                config, device=self.device, lockstep_role="follower")
            log.info("lockstep follower ready (model %s)", config.model)
            return self.engine

        def build_announced(desc: dict[str, Any]):
            """An ``engine`` frame: build it and answer the leader with a
            ``built`` frame; a failed build is dropped (this rank keeps
            replaying the other engines' frames) and its error answered."""
            import torch.distributed as dist

            answer = {"op": "built", "build": desc.get("build"),
                      "rank": dist.get_rank() if dist.is_initialized() else 0}
            self.engine = None
            try:
                built = build(desc["config_json"])
            except Exception as e:
                log.exception("lockstep follower: the announced serving engine failed "
                              "to build; dropped, the replay goes on")
                built, answer["error"] = None, f"{type(e).__name__}: {e}"
            sock.sendall(encode_descriptor(answer))
            return built

        if handshake.get("config_json"):
            engine = build(handshake["config_json"])
        steps = 0
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
            if op == "engine":
                engine = build_announced(desc)
                continue
            if op == "drop_engine":  # the build failed on some rank
                engine = self.engine = None
                continue
            if op == "embed":
                self._embed(desc)
                steps += 1
                continue
            if engine is None:
                raise RuntimeError(f"lockstep op {op!r} before any serving engine")
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
                    desc.get("ad_rows"),
                )
                self._record(op, engine._wait_chunk(handle, K)[0])
            elif op in ("prefill", "prefill_continue"):
                cont = None
                if op == "prefill_continue":
                    cont = (desc["starts"], int(desc["nrb"]))
                self._record(op, engine._run_prefill(
                    desc["tokens"], desc["lengths"], desc["slot_ids"],
                    desc.get("tables"), desc["temps"], desc["topks"],
                    desc["topps"], _mode(desc), cont=cont, ad_rows=desc.get("ad_rows"),
                )[0])
            elif op == "spec_step":
                self._record(op, engine._run_spec_step(
                    desc.get("ctx_rows"), desc.get("ctx_vals"), desc["current"],
                    desc["lengths"], desc["active"], desc["tables"], int(desc["nrb"]),
                    _mode(desc), desc["temps"], desc["topks"], desc["topps"],
                    desc.get("ad_rows"),
                )[0][0])
            # the tier moves: this rank's share of the leader's gather (its
            # rows go to the leader), scatter (the rows come from it) or
            # adapter row load (the factors come from it)
            elif op == "kv_gather":
                engine._run_gather(desc["table"], desc.get("rows"), int(desc.get("replica", 0)))
            elif op == "kv_scatter":
                engine._run_scatter(None, desc["table"], int(desc["rows"]), int(desc["padded"]))
            elif op == "adapter_row":
                engine._run_adapter_load(None, int(desc["row"]), desc.get("name"))
            else:
                raise RuntimeError(f"unknown lockstep op {op!r}")
            engine._ls_seq += 1
            steps += 1
            if die_after_steps is not None and steps >= die_after_steps:
                log.error("fault injection: follower dying after %d steps", steps)
                os._exit(3)
        sock.close()
        return steps

    def _embed(self, desc: dict[str, Any]) -> None:
        """Replay an ``embed`` frame: the encoder call of the leader's
        embeddings engine, on an engine of the same identity built at its
        first frame."""
        from langstream_tpu_torch.serving.embeddings import EmbeddingEngine

        key = (desc["model"], desc.get("tokenizer"), desc.get("checkpoint"),
               desc["mesh_json"])
        embedder = self.embedders.get(key)
        if embedder is None:
            embedder = self.embedders[key] = EmbeddingEngine(
                desc["model"], desc.get("tokenizer"), desc.get("checkpoint"),
                mesh=json.loads(desc["mesh_json"]), device=self.device,
                lockstep_role="follower")
        embedder._encode(desc["tokens"], desc["mask"])
