"""Read-only snapshot client (docs/serving.md).

``pull_snapshot`` fetches round-versioned, immutable snapshot cuts of
the server fleet's aggregates over the CMD_SNAP_PULL/RESP data-plane
command family — the consistent pull path for inference traffic.
Readers talk to read replicas (DMLC_ROLE=replica) by default, or to the
primaries directly; either way they never register with the scheduler,
never join fleet formation, and never touch the training data plane:
the server engine queues snap pulls on a dedicated low-weight DRR lane,
so a reader swarm cannot starve training pushes.

Consistency contract (the whole point):

- Every reply names the committed round version it was cut at (echoed
  in the reply header). The first key of a batch asks for ``latest``;
  the client pins the resolved version and demands it for every other
  key, so one ``pull_snapshot`` call observes exactly ONE committed
  round — never a torn mix of two rounds mid-update.
- A pinned version that falls off the retention ring mid-batch comes
  back as a clean EVICTED miss; the client restarts the batch at the
  new latest (bounded), preserving never-torn at the cost of a retry.
- Replies are BlockQuant-compressed by default (`quant=False` opts out
  per call; keys the server never quantized arrive as float32 either
  way — the flag in each reply header says which decode applies).

Failover: endpoints are tried in order; a dead replica costs the reader
one reconnect to the next endpoint and nothing else (reads are
stateless and idempotent). This file is pure Python stdlib + numpy on
purpose — an inference host needs no C core, no JAX, no registration.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

# --- wire constants (mirror csrc/common.h; keep in lockstep) ----------------

CMD_SNAP_PULL = 34
CMD_SNAP_RESP = 35

FLAG_WIRE_QUANT = 4
FLAG_WIRE_CRC = 16

# MsgHeader: cmd i16, tenant u16, sender i32, key i64, req_id i32,
# dtype i32, payload_len i64, flags i32, version i32, arg0 i64, arg1 i64,
# seq i64 — 64 bytes, little-endian (csrc/common.h MsgHeader).
_HEADER_FMT = "<hHiqiiqiiqqq"
_HEADER_LEN = struct.calcsize(_HEADER_FMT)
assert _HEADER_LEN == 64


def _crc32c_table() -> List[int]:
    # CRC32C (Castagnoli), reflected polynomial 0x82F63B78 — the same
    # table csrc/crc32c.cc builds. Stdlib-only on purpose: zlib.crc32 is
    # the WRONG polynomial (0xEDB88320) and an inference host carries no
    # C core to borrow the real one from.
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C_TABLE = _crc32c_table()


def crc32c(data: bytes, seed: int = 0) -> int:
    """CRC32C over ``data`` (mirror of csrc/crc32c.cc Crc32c, including
    its seed-chaining property: crc32c(a + b) == crc32c(b, crc32c(a)))."""
    c = (seed ^ 0xFFFFFFFF) & 0xFFFFFFFF
    for byte in data:
        c = _CRC32C_TABLE[(c ^ byte) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF

# Snapshot miss codes (csrc/snapshot.h SnapStore::Get).
SNAP_OK = 0
SNAP_EVICTED = 1
SNAP_NOT_COMMITTED = 2
SNAP_UNKNOWN_KEY = 3

_NP_DTYPES = {
    0: np.dtype(np.float32), 1: np.dtype(np.float64),
    2: np.dtype(np.float16), 4: np.dtype(np.int32),
    5: np.dtype(np.int64), 6: np.dtype(np.uint8), 7: np.dtype(np.int8),
}

Endpoint = Union[str, Tuple[str, int]]


class SnapshotError(RuntimeError):
    """Snapshot pull failed after exhausting retries / endpoints."""


def decode_block_quant(payload: bytes) -> np.ndarray:
    """Decode one BlockQuant wire buffer to float32 (mirror of
    csrc/compressor.cc BlockQuant::Decode):
    [u16 magic 0xB10C][u16 block][i32 nelem][nblocks f32 scales]
    [nelem i8 codes], value = code * scale-of-its-block."""
    if len(payload) < 8:
        raise SnapshotError("BlockQuant payload shorter than its header")
    magic, block, nelem = struct.unpack_from("<HHi", payload, 0)
    if magic != 0xB10C or block == 0 or nelem < 0:
        raise SnapshotError(
            f"bad BlockQuant header (magic=0x{magic:x} block={block} "
            f"nelem={nelem})")
    nblocks = (nelem + block - 1) // block
    want = 8 + 4 * nblocks + nelem
    if len(payload) != want:
        raise SnapshotError(
            f"BlockQuant size mismatch: got {len(payload)}, want {want}")
    scales = np.frombuffer(payload, dtype="<f4", count=nblocks, offset=8)
    codes = np.frombuffer(payload, dtype=np.int8, count=nelem,
                          offset=8 + 4 * nblocks)
    out = codes.astype(np.float32)
    out *= np.repeat(scales, block)[:nelem]
    return out


def _parse_endpoint(ep: Endpoint) -> Tuple[str, int]:
    if isinstance(ep, str):
        host, _, port = ep.rpartition(":")
        if not host:
            raise ValueError(f"endpoint {ep!r} is not host:port")
        return host, int(port)
    return ep[0], int(ep[1])


def _endpoints_from_env() -> List[Tuple[str, int]]:
    raw = os.environ.get("BYTEPS_SNAP_ENDPOINTS", "")
    eps = [_parse_endpoint(p) for p in raw.split(",") if p.strip()]
    if not eps:
        raise ValueError(
            "no snapshot endpoints: pass endpoints=[...] or set "
            "BYTEPS_SNAP_ENDPOINTS=host:port[,host:port...]")
    return eps


class SnapshotClient:
    """A reader connection with endpoint failover.

    Holds one TCP connection to the current endpoint; any socket error
    rotates to the next endpoint and retries the in-flight pull (reads
    are idempotent, so a retry can only cost duplicate work, never
    wrong data). Each endpoint gets several attempts per pull —
    transient faults clear on a fresh connection — and only a bounded
    retry budget exhausted across every endpoint raises SnapshotError.
    """

    def __init__(self, endpoints: Optional[Sequence[Endpoint]] = None,
                 tenant: int = 0, quant: bool = True,
                 timeout: float = 5.0,
                 wire_crc: Optional[bool] = None):
        eps = ([_parse_endpoint(e) for e in endpoints]
               if endpoints else _endpoints_from_env())
        self.endpoints = eps
        self.tenant = int(tenant)
        self.quant = bool(quant)
        self.timeout = float(timeout)
        # Wire integrity: stamp CRC32C trailers on requests
        # when the fleet runs CRC-on (default: follow BYTEPS_WIRE_CRC).
        # Replies are verified whenever THEY carry the flag, regardless
        # of this setting — the flag on the frame is the contract.
        if wire_crc is None:
            v = os.environ.get("BYTEPS_WIRE_CRC", "")
            wire_crc = bool(v) and v != "0"
        self.wire_crc = bool(wire_crc)
        self._sock: Optional[socket.socket] = None
        self._ep_idx = 0
        self._req_id = 0
        self.failovers = 0  # observability: endpoint rotations so far
        # Per-pull observability (docs/serving.md): the client
        # mirror of the server's bps_snap_pull_us histogram, so a reader
        # can tell "the fleet is slow" (server histogram up too) from
        # "my path to it is flaky" (failovers/retries up, server flat).
        self._stats = {
            "pulls": 0,            # completed pull() batches
            "keys": 0,             # arrays returned across all pulls
            "restarts": 0,         # evicted-mid-batch batch restarts
            "retries": 0,          # _pull_once attempts beyond the first
            "not_committed_waits": 0,
            "latency_us_sum": 0.0, "latency_us_min": float("inf"),
            "latency_us_max": 0.0, "latency_us_last": 0.0,
        }

    # -- connection management ------------------------------------------

    def _connect(self) -> socket.socket:
        if self._sock is not None:
            return self._sock
        host, port = self.endpoints[self._ep_idx]
        s = socket.create_connection((host, port), timeout=self.timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = s
        return s

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _rotate(self) -> None:
        self._drop()
        self._ep_idx = (self._ep_idx + 1) % len(self.endpoints)
        self.failovers += 1

    def close(self) -> None:
        self._drop()

    def __enter__(self) -> "SnapshotClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- wire ------------------------------------------------------------

    def _recv_exact(self, s: socket.socket, n: int) -> bytes:
        chunks = []
        got = 0
        while got < n:
            chunk = s.recv(n - got)
            if not chunk:
                raise ConnectionError("snapshot endpoint closed mid-frame")
            chunks.append(chunk)
            got += len(chunk)
        return b"".join(chunks)

    def _pull_once(self, key: int, version: int) -> Tuple[int, dict]:
        """One request/response on the current connection. Returns
        (miss_code, fields) where fields carries the resolved version
        and, on OK, the decoded array. Socket errors propagate for the
        failover wrapper."""
        s = self._connect()
        self._req_id += 1
        flags = FLAG_WIRE_QUANT if self.quant else 0
        if self.wire_crc:
            # The request's payload is just the 4-byte trailer: CRC over
            # the final header (flag set, payload_len counting the
            # trailer), exactly the van's stamping contract.
            flags |= FLAG_WIRE_CRC
            head = struct.pack(_HEADER_FMT, CMD_SNAP_PULL, self.tenant,
                               -1, int(key), self._req_id, 0, 4, flags,
                               int(version), 0, 0, 0)
            trailer = struct.pack("<I", crc32c(head))
            s.sendall(struct.pack("<Q", _HEADER_LEN + 4) + head + trailer)
        else:
            head = struct.pack(_HEADER_FMT, CMD_SNAP_PULL, self.tenant,
                               -1, int(key), self._req_id, 0, 0, flags,
                               int(version), 0, 0, 0)
            s.sendall(struct.pack("<Q", _HEADER_LEN) + head)
        total = struct.unpack("<Q", self._recv_exact(s, 8))[0]
        if not (_HEADER_LEN <= total <= (1 << 34)):
            raise ConnectionError(f"insane frame length {total}")
        frame = self._recv_exact(s, int(total))
        (cmd, _tenant, _sender, rkey, _req, dtype, payload_len, rflags,
         rversion, arg0, arg1, _seq) = struct.unpack_from(_HEADER_FMT,
                                                          frame, 0)
        if rflags & FLAG_WIRE_CRC:
            # Verify BEFORE trusting a single payload byte, then strip
            # the trailer — a mismatch is a transport error (the
            # failover wrapper burns retry budget on it), NEVER garbage
            # floats handed to the caller.
            if payload_len < 4 or _HEADER_LEN + payload_len > len(frame):
                raise ConnectionError(
                    f"snapshot reply CRC frame malformed (payload_len="
                    f"{payload_len}, frame={len(frame)})")
            end = _HEADER_LEN + payload_len
            (want,) = struct.unpack_from("<I", frame, end - 4)
            got = crc32c(frame[:end - 4])
            if got != want:
                raise ConnectionError(
                    f"snapshot reply for key {rkey} failed CRC32C "
                    f"verification (got {got:#010x}, want {want:#010x})")
            payload_len -= 4
            rflags &= ~FLAG_WIRE_CRC
        if cmd != CMD_SNAP_RESP or rkey != key:
            raise ConnectionError(
                f"unexpected reply cmd={cmd} key={rkey} (want "
                f"{CMD_SNAP_RESP}/{key})")
        code = int(arg0)
        if code != SNAP_OK:
            return code, {"version": int(rversion)}
        payload = frame[_HEADER_LEN:_HEADER_LEN + payload_len]
        if rflags & FLAG_WIRE_QUANT:
            arr = decode_block_quant(payload)
            if arg1 and arr.nbytes != arg1:
                raise SnapshotError(
                    f"quant decode of key {key} produced {arr.nbytes} "
                    f"bytes, reply header promised {arg1}")
        else:
            np_dt = _NP_DTYPES.get(int(dtype))
            if np_dt is None:
                raise SnapshotError(
                    f"key {key}: unsupported wire dtype {dtype}")
            arr = np.frombuffer(payload, dtype=np_dt).copy()
        return SNAP_OK, {"version": int(rversion), "array": arr}

    def _pull_failover(self, key: int, version: int) -> Tuple[int, dict]:
        # Reads are idempotent, so errors are cheap to retry — and a
        # transient fault (a dropped reply timing out, a dup-desynced
        # stream, a mid-frame reset) clears on a FRESH connection to the
        # same endpoint, not only on a different endpoint. One shot per
        # endpoint would turn two transient faults in a row into a hard
        # failure; instead each endpoint gets several attempts, with a
        # brief pause after each full rotation. Endpoints that are
        # genuinely down still fail fast (connect refused), so a dead
        # fleet costs ~attempts x connect-fail, not attempts x timeout.
        last: Optional[Exception] = None
        attempts = max(3 * len(self.endpoints), 6)
        for attempt in range(1, attempts + 1):
            try:
                return self._pull_once(key, version)
            except (OSError, ConnectionError) as e:
                last = e
                self._stats["retries"] += 1
                self._rotate()
                if attempt % len(self.endpoints) == 0 and attempt < attempts:
                    time.sleep(0.05)
        raise SnapshotError(
            f"snapshot pull of key {key} failed after {attempts} "
            f"attempt(s) across {len(self.endpoints)} endpoint(s) "
            f"(last: {last})")

    # -- public API -------------------------------------------------------

    def stats(self) -> dict:
        """Lifetime per-pull stats for this client: completed pulls,
        keys served, end-to-end batch latency (sum/mean/min/max/last,
        microseconds — the client-side view of the server's
        ``bps_snap_pull_us`` histogram), endpoint ``failovers``, wire
        ``retries``, evicted-mid-batch ``restarts`` and NOT_COMMITTED
        ``not_committed_waits``. Cheap snapshot; safe to poll."""
        st = dict(self._stats)
        st["failovers"] = self.failovers
        st["latency_us_mean"] = (st["latency_us_sum"] / st["pulls"]
                                 if st["pulls"] else 0.0)
        if st["pulls"] == 0:
            st["latency_us_min"] = 0.0
        return st

    def pull(self, keys: Iterable[int],
             version: Union[int, str] = "latest",
             max_restarts: int = 8,
             not_committed_wait: float = 0.05,
             ) -> Tuple[int, Dict[int, np.ndarray]]:
        """Pull one consistent cut of ``keys``.

        Returns ``(version, {key: array})`` where every array belongs to
        the same committed round ``version``. ``version`` may be an
        explicit committed round or "latest" (resolve-and-pin, see
        module docstring). Raises KeyError for a key the fleet never
        declared, SnapshotError when the cut cannot be completed.
        """
        keylist = [int(k) for k in keys]
        want = -1 if version == "latest" else int(version)
        pinned = want
        t0 = time.monotonic()
        for _restart in range(max_restarts + 1):
            out: Dict[int, np.ndarray] = {}
            restart = False
            for key in keylist:
                # Keys are sharded across primaries, and a replica holds
                # only its own primary's shard: UNKNOWN_KEY from one
                # endpoint means "not my shard" until EVERY endpoint has
                # disclaimed the key. A disclaim is conclusive only for
                # an endpoint whose watermark has reached the cut (the
                # server answers NOT_COMMITTED first otherwise), so any
                # NOT_COMMITTED reply voids the sweep: a still-catching-
                # up replica may well be the one that holds the shard.
                unknown = set()
                waits = 0
                while True:
                    code, fields = self._pull_failover(key, pinned)
                    if code == SNAP_OK:
                        # First resolved reply pins the cut for the rest
                        # of the batch.
                        if pinned < 0:
                            pinned = fields["version"]
                        out[key] = fields["array"]
                        break
                    if code == SNAP_UNKNOWN_KEY:
                        unknown.add(self._ep_idx)
                        if len(unknown) >= len(self.endpoints):
                            raise KeyError(
                                f"snapshot key {key} is on none of the "
                                f"{len(self.endpoints)} endpoint(s) — "
                                "never declared, or its shard's replica "
                                "is missing from the endpoint list")
                        self._rotate()
                        continue
                    if code == SNAP_EVICTED:
                        if want >= 0:
                            raise SnapshotError(
                                f"requested snapshot version {want} was "
                                "evicted from the retention ring "
                                "(BYTEPS_SNAPSHOT_RETAIN)")
                        # Our pinned cut aged out mid-batch: restart the
                        # whole batch at the new latest — never serve a
                        # torn mix.
                        restart = True
                        break
                    if code == SNAP_NOT_COMMITTED:
                        # Round not committed yet (or asked ahead of
                        # this endpoint's watermark): brief wait, then
                        # the same key — rotating every few waits in
                        # case only THIS endpoint is behind. Bounded so
                        # a fleet that never commits cannot hang us.
                        unknown.clear()  # the disclaim sweep is void
                        waits += 1
                        self._stats["not_committed_waits"] += 1
                        if waits * not_committed_wait > self.timeout * 4:
                            raise SnapshotError(
                                f"key {key}: no committed snapshot "
                                f"appeared within "
                                f"{self.timeout * 4:.1f}s (is "
                                "BYTEPS_SNAPSHOT_RETAIN=0, or the "
                                "fleet idle?)")
                        if waits % 4 == 0:
                            self._rotate()
                        time.sleep(not_committed_wait)
                        continue
                    raise SnapshotError(
                        f"key {key}: unknown snapshot miss code {code}")
                if restart:
                    break
            if not restart:
                st = self._stats
                us = (time.monotonic() - t0) * 1e6
                st["pulls"] += 1
                st["keys"] += len(out)
                st["latency_us_sum"] += us
                st["latency_us_min"] = min(st["latency_us_min"], us)
                st["latency_us_max"] = max(st["latency_us_max"], us)
                st["latency_us_last"] = us
                return pinned, out
            self._stats["restarts"] += 1
            pinned = -1
        raise SnapshotError(
            f"could not complete a consistent cut of {len(keylist)} "
            f"key(s) in {max_restarts + 1} attempts (retention churn "
            "outpaced the reader; raise BYTEPS_SNAPSHOT_RETAIN)")


def pull_snapshot(keys: Iterable[int],
                  version: Union[int, str] = "latest",
                  endpoints: Optional[Sequence[Endpoint]] = None,
                  tenant: int = 0, quant: bool = True,
                  timeout: float = 5.0,
                  ) -> Tuple[int, Dict[int, np.ndarray]]:
    """One-shot consistent snapshot pull (see SnapshotClient.pull).

    ``endpoints`` lists replica (or primary) data ports as "host:port"
    strings or (host, port) tuples; defaults to BYTEPS_SNAP_ENDPOINTS.
    ``quant=True`` (default) accepts BlockQuant-compressed replies;
    ``quant=False`` demands float32. Returns ``(version, {key: array})``.
    """
    with SnapshotClient(endpoints, tenant=tenant, quant=quant,
                        timeout=timeout) as c:
        return c.pull(keys, version=version)
