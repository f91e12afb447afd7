"""ctypes bindings to libbyteps_core.so.

Capability parity: the reference's BytePSBasics ctypes loader
(byteps/common/__init__.py, SURVEY.md §2.5) plus the per-framework C glue.
Role classes map onto the reference's process roles: Scheduler / Server
block until fleet shutdown; Worker exposes declare / push_pull / wait /
broadcast / barrier over host numpy buffers (zero-copy: the C side reads
and writes the array's memory in place).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from byteps_tpu_torch.config import Config

_DTYPE_MAP = {
    "float32": 0,
    "float64": 1,
    "float16": 2,
    "bfloat16": 3,
    "int32": 4,
    "int64": 5,
    "uint8": 6,
    "int8": 7,
}

# Barrier groups (mirror csrc/postoffice.h)
GROUP_SERVERS = 1
GROUP_WORKERS = 2
GROUP_ALL = 3

_lib: Optional[ctypes.CDLL] = None


def _dtype_code(dtype) -> int:
    """Wire dtype code of a numpy dtype or a dtype name. Names let a
    caller stage bfloat16, which numpy has no dtype for, as raw 16-bit
    words and still have the servers sum it as bfloat16."""
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    return _DTYPE_MAP[name]


def ensure_built(force: bool = False) -> str:
    from byteps_tpu_torch.core.build import build
    return build(force=force, verbose=False)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    # BPS_CORE_LIB overrides the library path (sanitizer builds, debugging).
    path = os.environ.get("BPS_CORE_LIB") or ensure_built()
    lib = ctypes.CDLL(path)
    lib.bps_init.argtypes = [ctypes.c_int]
    lib.bps_init.restype = ctypes.c_int
    lib.bps_finalize.argtypes = []
    lib.bps_my_id.restype = ctypes.c_int
    lib.bps_worker_rank.restype = ctypes.c_int
    lib.bps_num_workers.restype = ctypes.c_int
    lib.bps_num_servers.restype = ctypes.c_int
    lib.bps_barrier.argtypes = [ctypes.c_int]
    lib.bps_declare.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                                ctypes.c_int, ctypes.c_char_p]
    lib.bps_declare.restype = ctypes.c_longlong
    lib.bps_push_pull.argtypes = [ctypes.c_longlong, ctypes.c_void_p,
                                  ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int]
    lib.bps_push_pull.restype = ctypes.c_int
    lib.bps_broadcast.argtypes = [ctypes.c_longlong, ctypes.c_void_p,
                                  ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_int]
    lib.bps_broadcast.restype = ctypes.c_int
    lib.bps_wait.argtypes = [ctypes.c_int]
    lib.bps_wait.restype = ctypes.c_int
    lib.bps_last_error.restype = ctypes.c_char_p
    lib.bps_poll.argtypes = [ctypes.c_int]
    lib.bps_poll.restype = ctypes.c_int
    lib.bps_dump_trace.argtypes = [ctypes.c_char_p]
    lib.bps_dump_trace.restype = ctypes.c_int
    # Fleet tracing: flight-recorder dump, step-window report,
    # and app-level annotations — available on every role.
    lib.bps_dump_flight.argtypes = [ctypes.c_char_p]
    lib.bps_dump_flight.restype = ctypes.c_int
    lib.bps_trace_step.argtypes = [ctypes.c_int]
    lib.bps_trace_step.restype = None
    lib.bps_trace_note.argtypes = [ctypes.c_char_p, ctypes.c_longlong]
    lib.bps_trace_note.restype = None
    lib.bps_reducer_bench.argtypes = [ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_int]
    lib.bps_reducer_bench.restype = ctypes.c_double
    # Codec roundtrip probes (no topology): property tests for the
    # compressor plugins and the BlockQuant wire codec.
    lib.bps_compressor_roundtrip.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p]
    lib.bps_compressor_roundtrip.restype = ctypes.c_longlong
    lib.bps_quant_roundtrip.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.bps_quant_roundtrip.restype = ctypes.c_longlong
    # One telemetry surface (byteps_tpu.monitor): the snapshot absorbs
    # the former bps_net_bytes / bps_async_staleness / bps_dead_nodes
    # ad-hoc diagnostics — net_bytes()/async_staleness()/dead_nodes()
    # below are now views over it.
    lib.bps_metrics_snapshot.argtypes = [ctypes.c_char_p, ctypes.c_longlong]
    lib.bps_metrics_snapshot.restype = ctypes.c_longlong
    # Per-round introspection: summary snapshot + the raw
    # accumulation/ingest hooks (test harness + Python-side reporters).
    lib.bps_round_summary.argtypes = [ctypes.c_char_p, ctypes.c_longlong]
    lib.bps_round_summary.restype = ctypes.c_longlong
    lib.bps_round_track.argtypes = [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_longlong, ctypes.c_longlong]
    lib.bps_round_track.restype = None
    lib.bps_round_ingest.argtypes = [ctypes.c_char_p, ctypes.c_longlong]
    lib.bps_round_ingest.restype = ctypes.c_int
    lib.bps_metrics_observe.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                        ctypes.c_longlong]
    lib.bps_metrics_observe.restype = ctypes.c_int
    lib.bps_failure_shutdown.argtypes = []
    lib.bps_failure_shutdown.restype = ctypes.c_int
    # Elastic worker membership: live epoch, graceful leave,
    # and the no-topology epoch-roster/rollback probe.
    lib.bps_epoch.argtypes = []
    lib.bps_epoch.restype = ctypes.c_longlong
    lib.bps_leave.argtypes = []
    lib.bps_leave.restype = ctypes.c_int
    lib.bps_elastic_probe.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                      ctypes.c_longlong]
    lib.bps_elastic_probe.restype = ctypes.c_longlong
    # Multi-tenant PS: tenant identity, the per-tenant
    # accounting/roster snapshot, the no-topology DRR/namespacing
    # probe, and the wire-layout pin for the A/B byte-identity test.
    lib.bps_tenant_id.argtypes = []
    lib.bps_tenant_id.restype = ctypes.c_int
    lib.bps_tenant_summary.argtypes = [ctypes.c_char_p, ctypes.c_longlong]
    lib.bps_tenant_summary.restype = ctypes.c_longlong
    lib.bps_tenant_probe.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                     ctypes.c_longlong]
    lib.bps_tenant_probe.restype = ctypes.c_longlong
    lib.bps_wire_header_probe.argtypes = [ctypes.c_int, ctypes.c_int,
                                          ctypes.c_longlong, ctypes.c_int,
                                          ctypes.c_void_p]
    lib.bps_wire_header_probe.restype = ctypes.c_int
    # Scheduler fail-over: the no-fleet state-reconstruction
    # probe (quorum / epoch adoption / rank high-water / roster rebuild
    # / heartbeat seeding / window expiry).
    lib.bps_sched_probe.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                    ctypes.c_longlong]
    lib.bps_sched_probe.restype = ctypes.c_longlong
    # Versioned snapshot serving: the no-topology SnapStore /
    # stale-reply-tag probe (publish / commit gating / retention ring /
    # delta collection / CachedReplyValid).
    lib.bps_snap_probe.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                   ctypes.c_longlong]
    lib.bps_snap_probe.restype = ctypes.c_longlong
    # Durable checkpoints: the fleet-free spill / scan /
    # load / torn-rejection probe, plus the fleet-committed restore
    # epoch this node learned at formation.
    lib.bps_ckpt_probe.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                   ctypes.c_longlong]
    lib.bps_ckpt_probe.restype = ctypes.c_longlong
    lib.bps_restore_round.argtypes = []
    lib.bps_restore_round.restype = ctypes.c_longlong
    # Fleet event journal: the whole-journal JSON probe plus
    # the emit / wire-fill / wire-ingest test hooks that drive the
    # exact heartbeat piggyback path a live fleet uses.
    lib.bps_events_summary.argtypes = [ctypes.c_char_p, ctypes.c_longlong]
    lib.bps_events_summary.restype = ctypes.c_longlong
    lib.bps_events_emit.argtypes = [ctypes.c_int, ctypes.c_longlong,
                                    ctypes.c_longlong, ctypes.c_longlong]
    lib.bps_events_emit.restype = ctypes.c_int
    lib.bps_events_fill_wire.argtypes = [ctypes.c_char_p,
                                         ctypes.c_longlong]
    lib.bps_events_fill_wire.restype = ctypes.c_longlong
    lib.bps_events_ingest.argtypes = [ctypes.c_char_p, ctypes.c_longlong]
    lib.bps_events_ingest.restype = ctypes.c_int
    _lib = lib
    return lib


def metrics_snapshot() -> dict:
    """Parse the C core's one-call telemetry snapshot (counters, gauges,
    latency histograms, van wire bytes, async staleness, queue occupancy,
    scheduler heartbeat ages / dead nodes) into a dict. Works in any
    process state; pre-init sections come back empty."""
    import json

    lib = _load()
    size = 1 << 16
    while True:
        buf = ctypes.create_string_buffer(size)
        need = int(lib.bps_metrics_snapshot(buf, size))
        if need < size:
            return json.loads(buf.value.decode())
        size = need + 1


def round_summary() -> dict:
    """Parse the C core's per-round introspection snapshot:
    this rank's round ring plus, on the scheduler, the fleet's per-rank
    EWMA baselines and round table ingested from heartbeat summaries.
    Works in any process state (an idle rank reports an empty ring)."""
    import json

    lib = _load()
    size = 1 << 16
    while True:
        buf = ctypes.create_string_buffer(size)
        need = int(lib.bps_round_summary(buf, size))
        if need < size:
            return json.loads(buf.value.decode())
        size = need + 1


# RoundStage values (mirror csrc/roundstats.h).
ROUND_STAGES = {
    "enq": 0, "queue": 1, "comp": 2, "push": 3, "sum": 4, "pull": 5,
    "dec": 6, "retry": 7, "park": 8, "frame": 9, "done": 10,
}


def round_track(stage: str, round_no: int, us: int = 0,
                nbytes: int = 0) -> None:
    """Feed one accumulation event into the round-summary ring (the
    production Track path — used by tests and Python-side reporters)."""
    _load().bps_round_track(ROUND_STAGES[stage], int(round_no), int(us),
                            int(nbytes))


def round_ingest(payload: bytes) -> bool:
    """Ingest serialized heartbeat round-summary wire bytes; False when
    the payload is not a recognized summary (version interop)."""
    return bool(_load().bps_round_ingest(payload, len(payload)))


# Fleet lifecycle event types (mirror csrc/events.h EventType — the
# journal's versioned catalog; docs/monitoring.md "Event catalog").
EVENT_TYPES = {
    "epoch_pause": 1, "epoch_resume": 2, "fleet_pause": 3,
    "fleet_resume": 4, "join": 5, "leave": 6, "death": 7,
    "server_recover": 8, "reseed": 9, "sched_park": 10,
    "sched_reregister": 11, "sched_recovery_commit": 12,
    "ckpt_spill": 13, "ckpt_seal": 14, "ckpt_restore": 15,
    "snap_commit": 16, "snap_evict": 17, "replica_lag": 18,
    "crc_quarantine": 19, "crc_failstop": 20, "tenant_starved": 21,
    "chaos": 22, "insight": 23, "shutdown": 24,
}


def events_summary() -> dict:
    """Parse the fleet event journal snapshot: this rank's
    local ring plus, on the scheduler, the clock-aligned fleet timeline
    and the per-gauge metric history rings. Works in any process state
    (pre-init ranks report an empty ring under node_id -1)."""
    import json

    lib = _load()
    size = 1 << 16
    while True:
        buf = ctypes.create_string_buffer(size)
        need = int(lib.bps_events_summary(buf, size))
        if need < size:
            return json.loads(buf.value.decode())
        size = need + 1


def events_emit(event: "str | int", a0: int = 0, a1: int = 0,
                a2: int = 0) -> None:
    """Journal one lifecycle event through the production Emit path —
    the hook behind insight's classification journaling, the monitor
    endpoint's POST /events, and the catalog-reachability tests."""
    code = EVENT_TYPES[event] if isinstance(event, str) else int(event)
    if _load().bps_events_emit(code, int(a0), int(a1), int(a2)) != 0:
        raise ValueError(f"unknown event type {event!r}")


def events_fill_wire() -> bytes:
    """Drain the new-since-last-beat events into one heartbeat wire
    chunk, exactly as HeartbeatLoop would. b"" when there is nothing
    new or the journal is off (the heartbeat then carries no events
    sub-payload at all — the pre-journal wire)."""
    lib = _load()
    size = 1 << 16
    while True:
        buf = ctypes.create_string_buffer(size)
        n = int(lib.bps_events_fill_wire(buf, size))
        if n >= 0:
            return buf.raw[:n]
        size = -n


def events_ingest(payload: bytes) -> bool:
    """Ingest one events wire chunk as the scheduler's heartbeat
    handler would; False when the payload is not a recognized events
    chunk (foreign magic, version skew, short frame)."""
    return bool(_load().bps_events_ingest(payload, len(payload)))


def elastic_probe(script: str) -> dict:
    """Drive the C core's standalone epoch-roster + rollback bookkeeping through a `;`-separated op script (live:/join:/remove:/
    push:/pull:/seal/reset/round:) and return the final state — the
    no-fleet unit-test surface for the elastic membership arithmetic.
    Raises ValueError on a malformed script."""
    import json

    lib = _load()
    size = 1 << 16
    while True:
        buf = ctypes.create_string_buffer(size)
        need = int(lib.bps_elastic_probe(script.encode(), buf, size))
        if need < 0:
            raise ValueError(f"malformed elastic probe script {script!r}")
        if need < size:
            return json.loads(buf.value.decode())
        size = need + 1


def sched_probe(script: str) -> dict:
    """Drive the C core's standalone scheduler fail-over reconstruction
    arithmetic through a `;`-separated op script (servers:/
    book:/tenant:/report:/window:/seed:) and return the rebuilt state —
    quorum, adopted epoch, conflict verdict, rank high-water mark,
    tenant rosters, heartbeat seeds. The no-fleet unit-test surface for
    crash-restart recovery. Raises ValueError on a malformed script."""
    import json

    lib = _load()
    size = 1 << 16
    while True:
        buf = ctypes.create_string_buffer(size)
        need = int(lib.bps_sched_probe(script.encode(), buf, size))
        if need < 0:
            raise ValueError(f"malformed sched probe script {script!r}")
        if need < size:
            return json.loads(buf.value.decode())
        size = need + 1


def snap_probe(script: str) -> dict:
    """Drive the C core's standalone snapshot store through a
    `;`-separated op script (retain:/publish:/publishq:/force:/pull:/
    oldest:/collect:/tag:) and return the final state — committed latest,
    publish/eviction counters, per-pull miss codes and resolved cut
    versions, delta-collection watermarks, and CachedReplyValid verdicts
    for the stale-reply-tag fix. The no-fleet unit-test surface for the
    serving subsystem's consistency arithmetic. Raises ValueError on a
    malformed script."""
    import json

    lib = _load()
    size = 1 << 16
    while True:
        buf = ctypes.create_string_buffer(size)
        need = int(lib.bps_snap_probe(script.encode(), buf, size))
        if need < 0:
            raise ValueError(f"malformed snap probe script {script!r}")
        if need < size:
            return json.loads(buf.value.decode())
        size = need + 1


def ckpt_probe(script: str) -> dict:
    """Drive the C core's standalone durable-checkpoint subsystem through a `;`-separated op script (dir:/rank:/chaos:/
    spill:/retain:/scan:/list:/load:/tear:/crc:) and return the outcome
    of every op — spill verdicts, newest-valid scan results, full valid
    version lists, load fidelity, torn-write injections, CRC32C known
    vectors. The no-fleet unit-test surface for the checksummed
    spill / atomic-rename / manifest-sealed-last durability argument.
    Raises ValueError on a malformed script."""
    import json

    lib = _load()
    size = 1 << 16
    while True:
        buf = ctypes.create_string_buffer(size)
        need = int(lib.bps_ckpt_probe(script.encode(), buf, size))
        if need < 0:
            raise ValueError(f"malformed ckpt probe script {script!r}")
        if need < size:
            return json.loads(buf.value.decode())
        size = need + 1


def restore_round() -> int:
    """The fleet-committed durable-restore epoch this node learned from
    the address book; -1 = none (ordinary cold start)."""
    return int(_load().bps_restore_round())


def tenant_id() -> int:
    """This process's tenant id (BYTEPS_TENANT_ID; 0 = legacy)."""
    return int(_load().bps_tenant_id())


def tenant_summary() -> dict:
    """Multi-tenant snapshot: this process's tenant identity,
    the per-tenant accounting registry (servers: bytes / ops / engine
    queue depth / sum time / DRR dispatch + starvation age), and the
    address-book tenant roster. Served raw at the monitor endpoint's
    /tenants path."""
    import json

    lib = _load()
    size = 1 << 16
    while True:
        buf = ctypes.create_string_buffer(size)
        need = int(lib.bps_tenant_summary(buf, size))
        if need < size:
            return json.loads(buf.value.decode())
        size = need + 1


def tenant_probe(script: str) -> dict:
    """Drive the C core's standalone weighted-DRR dispatch + (tenant,
    key) namespacing arithmetic through a `;`-separated op
    script (quantum:/weight:/enq:/pop:/key:/route:) and return the
    dispatch order, per-tenant served cost, composed keys and engine
    routes — the no-fleet unit-test surface, modeled on elastic_probe.
    Raises ValueError on a malformed script."""
    import json

    lib = _load()
    size = 1 << 16
    while True:
        buf = ctypes.create_string_buffer(size)
        need = int(lib.bps_tenant_probe(script.encode(), buf, size))
        if need < 0:
            raise ValueError(f"malformed tenant probe script {script!r}")
        if need < size:
            return json.loads(buf.value.decode())
        size = need + 1


def wire_header_probe(cmd: int, tenant: int, key: int,
                      version: int) -> bytes:
    """Serialize a MsgHeader with the given fields exactly as the C
    core puts it on the wire (the A/B byte-identity pin: a
    tenant-0 header must equal the pre-tenant layout bit for bit)."""
    lib = _load()
    buf = ctypes.create_string_buffer(64)
    n = int(lib.bps_wire_header_probe(cmd, tenant, key, version, buf))
    return buf.raw[:n]


def leave_requested() -> bool:
    """True when this worker's supervisor asked it to retire (the
    launcher's elastic scale-down protocol: BYTEPS_RETIRE_FILE names a
    per-rank file whose existence is the retire signal). Training loops
    poll this at round boundaries and call Worker.leave()."""
    path = os.environ.get("BYTEPS_RETIRE_FILE", "")
    return bool(path) and os.path.exists(path)


def metrics_observe(kind: str, name: str, value: int) -> None:
    """Record into the core metric registry from Python ("counter" adds,
    "gauge" sets, "histo" observes microseconds)."""
    rc = _load().bps_metrics_observe(kind.encode(), name.encode(),
                                     int(value))
    if rc != 0:
        raise ValueError(f"unknown metric kind {kind!r}")


def reducer_bench(nbytes: int = 64 << 20, iters: int = 20,
                  dtype: str = "float32") -> float:
    """GB/s of the CPU summation hot loop (no topology needed): the
    server-side bottleneck check from SURVEY.md §7 — aggregate server
    summation bandwidth must exceed aggregate worker NIC bandwidth."""
    lib = _load()
    gbps = float(lib.bps_reducer_bench(
        nbytes, iters, _DTYPE_MAP[np.dtype(dtype).name]))
    if gbps < 0:
        raise ValueError(f"bad reducer_bench args: nbytes={nbytes} "
                         f"iters={iters} dtype={dtype}")
    return gbps


def compressor_roundtrip(config: str, src: np.ndarray):
    """Encode `src` (float32) with the C-core codec built from `config`
    and decode it back. Returns (encoded_bytes, decoded array). Raises
    ValueError on a bad config and FloatingPointError on NaN/Inf input
    — the C core refuses to encode garbage ("error loudly")."""
    src = np.ascontiguousarray(src, dtype=np.float32)
    dst = np.empty_like(src)
    rc = int(_load().bps_compressor_roundtrip(
        config.encode(), src.ctypes.data_as(ctypes.c_void_p), src.size,
        dst.ctypes.data_as(ctypes.c_void_p)))
    if rc == -2:
        raise FloatingPointError(
            "non-finite value in compressor input (refused to encode)")
    if rc < 0:
        raise ValueError(f"bad compressor config {config!r}")
    return rc, dst


def quant_roundtrip(src: np.ndarray, block: int = 64):
    """BlockQuant (wire codec) roundtrip: returns
    (encoded_bytes, decoded array). Raises ValueError on an invalid
    block and FloatingPointError on NaN/Inf input."""
    src = np.ascontiguousarray(src, dtype=np.float32)
    dst = np.empty_like(src)
    rc = int(_load().bps_quant_roundtrip(
        src.ctypes.data_as(ctypes.c_void_p), src.size, int(block),
        dst.ctypes.data_as(ctypes.c_void_p)))
    if rc == -2:
        raise FloatingPointError(
            "non-finite value in quantizer input (refused to encode)")
    if rc < 0:
        raise ValueError(
            f"invalid block {block} (power of two in [16, 32768]) or "
            "empty input")
    return rc, dst


def _apply_config_env(cfg: Optional[Config]) -> None:
    """Project a Config back into the env the C core reads (the C side is
    env-configured for parity with the reference)."""
    if cfg is None:
        return
    os.environ["DMLC_PS_ROOT_URI"] = cfg.root_uri
    os.environ["DMLC_PS_ROOT_PORT"] = str(cfg.root_port)
    os.environ["DMLC_NUM_WORKER"] = str(cfg.num_worker)
    os.environ["DMLC_NUM_SERVER"] = str(cfg.num_server)
    os.environ["BYTEPS_PARTITION_BYTES"] = str(cfg.partition_bytes)
    os.environ["BYTEPS_SCHEDULING_CREDIT"] = str(cfg.scheduling_credit)
    os.environ["BYTEPS_FUSION_BYTES"] = str(cfg.fusion_bytes)
    os.environ["BYTEPS_FUSION_KEYS"] = str(cfg.fusion_keys)
    os.environ["BYTEPS_FUSION_LINGER_US"] = str(cfg.fusion_linger_us)
    # Block-quantized wire: worker AND server read these, so
    # both ends compute identical per-key eligibility.
    os.environ["BYTEPS_WIRE_QUANT"] = "1" if cfg.wire_quant else "0"
    os.environ["BYTEPS_WIRE_QUANT_BLOCK"] = str(cfg.wire_quant_block)
    os.environ["BYTEPS_WIRE_QUANT_MIN_BYTES"] = str(
        cfg.wire_quant_min_bytes)
    os.environ["BYTEPS_SERVER_ENGINE_THREAD"] = str(cfg.server_engine_threads)
    os.environ["BYTEPS_ENABLE_ASYNC"] = "1" if cfg.enable_async else "0"
    if cfg.compressor:
        os.environ["BYTEPS_COMPRESSOR"] = cfg.compressor
    os.environ["BYTEPS_TRACE_ON"] = "1" if cfg.trace_on else "0"
    # Canonical trace directory: config accepts the legacy
    # BPS_TRACE_OUT alias; the C core reads BYTEPS_TRACE_DIR for its
    # flight-recorder auto-dumps, so project the resolved value.
    os.environ["BYTEPS_TRACE_DIR"] = cfg.trace_dir
    os.environ["BYTEPS_TRACE_START_STEP"] = str(cfg.trace_start_step)
    os.environ["BYTEPS_TRACE_END_STEP"] = str(cfg.trace_end_step)
    os.environ["BYTEPS_TRACE_RING_EVENTS"] = str(cfg.trace_ring_events)
    os.environ["BYTEPS_FLIGHT_RECORDER"] = (
        "1" if cfg.flight_recorder else "0")
    os.environ["BYTEPS_FLIGHT_RECORDER_EVENTS"] = str(
        cfg.flight_recorder_events)
    os.environ["BYTEPS_MONITOR_ON"] = "1" if cfg.monitor_on else "0"
    os.environ["BYTEPS_MONITOR_PORT"] = str(cfg.monitor_port)
    # Per-round introspection: every role reads these — the
    # workers/servers to accumulate and piggyback, the scheduler to
    # size nothing but still answer bps_round_summary consistently.
    os.environ["BYTEPS_ROUNDSTATS_ON"] = "1" if cfg.roundstats_on else "0"
    os.environ["BYTEPS_ROUNDSTATS_RING"] = str(cfg.roundstats_ring)
    os.environ["BYTEPS_ROUNDSTATS_HEARTBEAT_SUMMARY"] = (
        "1" if cfg.roundstats_heartbeat_summary else "0")
    # Transient-fault tolerance + chaos harness (the C core reads these
    # at init; docs/env.md "Fault tolerance and chaos injection").
    os.environ["BYTEPS_RETRY_MAX"] = str(cfg.retry_max)
    os.environ["BYTEPS_RETRY_TIMEOUT_MS"] = str(cfg.retry_timeout_ms)
    os.environ["BYTEPS_RECONNECT_MAX"] = str(cfg.reconnect_max)
    os.environ["BYTEPS_RECONNECT_BACKOFF_MS"] = str(cfg.reconnect_backoff_ms)
    # Hot server replacement. DMLC_RECOVER_RANK is deliberately
    # NOT projected: it is per-process identity owned by the supervisor,
    # never a fleet-wide setting.
    os.environ["BYTEPS_RECOVERY_TIMEOUT_MS"] = str(
        cfg.effective_recovery_timeout_ms)
    # Elastic worker membership. DMLC_JOIN is per-process
    # identity (the joiner's marker, like DMLC_RECOVER_RANK) and is NOT
    # projected.
    os.environ["BYTEPS_ELASTIC"] = "1" if cfg.elastic else "0"
    os.environ["BYTEPS_ELASTIC_TIMEOUT_MS"] = str(cfg.elastic_timeout_ms)
    # Scheduler fail-over. DMLC_SCHED_RECOVER is per-process
    # identity (the restarted scheduler's marker, set by the launcher
    # respawn) and is NOT projected.
    os.environ["BYTEPS_SCHED_RECOVERY_TIMEOUT_MS"] = str(
        cfg.effective_sched_recovery_timeout_ms)
    # Multi-tenant PS: projected only when the job opted in —
    # leaving BYTEPS_TENANT_ID unset is the contract that keeps the
    # wire format and engine dispatch byte-for-byte the single-tenant
    # ones, and writing "0" here would still enrol the weight stamp.
    if cfg.tenant_id is not None:
        os.environ["BYTEPS_TENANT_ID"] = str(cfg.tenant_id)
        if cfg.tenant_name:
            os.environ["BYTEPS_TENANT_NAME"] = cfg.tenant_name
        os.environ["BYTEPS_TENANT_WEIGHT"] = str(cfg.tenant_weight)
        os.environ["BYTEPS_TENANT_QUANTUM_BYTES"] = str(
            cfg.tenant_quantum_bytes)
        os.environ["BYTEPS_TENANT_STARVE_MS"] = str(cfg.tenant_starve_ms)
    if cfg.server_engine_pace_mbps > 0:
        os.environ["BYTEPS_SERVER_ENGINE_PACE_MBPS"] = str(
            cfg.server_engine_pace_mbps)
    # Versioned snapshot serving: the primary reads the
    # retention/weight knobs at engine start, replicas read the poll and
    # delta-batch knobs. BYTEPS_REPLICA_OF is deliberately NOT projected:
    # like DMLC_RECOVER_RANK it is per-process identity (which primary
    # this replica shadows), owned by the supervisor that spawned it.
    os.environ["BYTEPS_SNAPSHOT_RETAIN"] = str(cfg.snapshot_retain)
    os.environ["BYTEPS_SERVING_WEIGHT"] = str(cfg.serving_weight)
    os.environ["BYTEPS_SNAP_DELTA_MAX_BYTES"] = str(
        cfg.snap_delta_max_bytes)
    os.environ["BYTEPS_REPLICA_POLL_MS"] = str(cfg.replica_poll_ms)
    # Durable checkpoints: spill knobs project only when the
    # job armed a checkpoint dir — an unset BYTEPS_CKPT_DIR keeps the
    # server byte-for-byte the pre-checkpoint build.
    # BYTEPS_CKPT_RESTORE is deliberately NOT projected: like
    # DMLC_RECOVER_RANK it is per-process identity (this relaunch
    # resumes from disk), owned by the supervisor that spawned it.
    if cfg.ckpt_dir:
        os.environ["BYTEPS_CKPT_DIR"] = cfg.ckpt_dir
        os.environ["BYTEPS_CKPT_EVERY"] = str(cfg.ckpt_every)
        os.environ["BYTEPS_CKPT_RETAIN"] = str(cfg.ckpt_retain)
        os.environ["BYTEPS_CKPT_LAG_WARN"] = str(cfg.ckpt_lag_warn)
        if cfg.chaos_ckpt:
            os.environ["BYTEPS_CHAOS_CKPT"] = cfg.chaos_ckpt
    os.environ["BYTEPS_CHAOS_SEED"] = str(cfg.chaos_seed)
    os.environ["BYTEPS_CHAOS_DROP"] = str(cfg.chaos_drop)
    os.environ["BYTEPS_CHAOS_DUP"] = str(cfg.chaos_dup)
    os.environ["BYTEPS_CHAOS_CORRUPT"] = str(cfg.chaos_corrupt)
    os.environ["BYTEPS_CHAOS_DELAY_US"] = str(cfg.chaos_delay_us)
    os.environ["BYTEPS_CHAOS_RESET_EVERY"] = str(cfg.chaos_reset_every)
    os.environ["BYTEPS_CHAOS_CTRL"] = "1" if cfg.chaos_ctrl else "0"
    # Wire integrity: every role reads these — senders stamp
    # the CRC trailer, receivers verify and run the quarantine window.
    os.environ["BYTEPS_WIRE_CRC"] = "1" if cfg.wire_crc else "0"
    os.environ["BYTEPS_WIRE_CRC_QUARANTINE"] = str(cfg.wire_crc_quarantine)
    os.environ["BYTEPS_WIRE_CRC_WINDOW_MS"] = str(cfg.wire_crc_window_ms)


class _Node:
    ROLE = -1

    def __init__(self, cfg: Optional[Config] = None):
        _apply_config_env(cfg)
        self._lib = _load()
        self.node_id = self._lib.bps_init(self.ROLE)
        if self.node_id < 0:
            raise RuntimeError("bps_init failed")
        self._alive = True
        # Live observability endpoint (/metrics + /healthz) when
        # BYTEPS_MONITOR_ON — every role serves one, on the monitor base
        # port + this node's id (docs/monitoring.md).
        from byteps_tpu_torch.monitor import maybe_start_monitor
        self._monitor = maybe_start_monitor(self.node_id)

    @classmethod
    def start(cls, cfg: Optional[Config] = None):
        return cls(cfg)

    def shutdown(self) -> None:
        if self._alive:
            # Monitor stops AFTER finalize: for scheduler/server roles
            # shutdown() IS the serving loop (run = shutdown; Finalize
            # blocks for the fleet's whole life), and the endpoint must
            # be scrapable exactly then. Scrapes racing the finalize
            # tail are safe — the postoffice object outlives finalize
            # (it is only destroyed by a later re-init) and the snapshot
            # guards every section on the inited flag.
            self._lib.bps_finalize()
            self._alive = False
            self._maybe_autodump_trace()
            if self._monitor is not None:
                self._monitor.stop()
                self._monitor = None

    def _maybe_autodump_trace(self) -> None:
        """With BYTEPS_TRACE_ON, every role leaves its per-rank timeline
        in the trace dir at shutdown (trace_r<role>_n<id>.json) — the
        files `python -m byteps_tpu.monitor.timeline merge` gathers into
        one fleet view. After finalize so shutdown events are included;
        the ring (trace.h) outlives the topology."""
        v = os.environ.get("BYTEPS_TRACE_ON", "")
        if not v or v.strip().lower() in ("0", "false", "off", "no"):
            return
        try:
            d = (os.environ.get("BYTEPS_TRACE_DIR")
                 or os.environ.get("BPS_TRACE_OUT") or "./traces")
            os.makedirs(d, exist_ok=True)
            self.dump_trace(os.path.join(
                d, f"trace_r{self.ROLE}_n{self.node_id}.json"))
        except Exception:
            pass  # tracing must never fail a shutdown

    # --- fleet tracing (docs/timeline.md) — every role -------
    def dump_trace(self, path: str) -> int:
        """Drain the main trace ring into a Chrome-trace JSON (with a
        `meta` object carrying role/node id and the clock offset vs the
        scheduler). Returns the event count."""
        return int(self._lib.bps_dump_trace(path.encode()))

    def dump_flight(self, path: Optional[str] = None) -> int:
        """Snapshot the always-on flight recorder (non-draining); None
        writes the default <trace_dir>/flight_r<role>_n<id>.json."""
        return int(self._lib.bps_dump_flight(
            path.encode() if path else None))

    def trace_step(self, step: int) -> None:
        """Report the training step for the trace window enforcement."""
        self._lib.bps_trace_step(int(step))

    def trace_note(self, name: str, key: int = 0) -> None:
        """App-level instant into the trace + flight rings."""
        self._lib.bps_trace_note(name.encode(), int(key))

    # Scheduler/Server block here until the fleet shuts down.
    run = shutdown

    def failure_shutdown(self) -> bool:
        """True when this node's shutdown was FAILURE-triggered (the
        scheduler's dead-node broadcast, or a lost scheduler
        connection) rather than the clean all-goodbyes teardown.
        Valid after shutdown(); the server entry point exits nonzero
        on it so supervisors can tell crash from completion."""
        return bool(self._lib.bps_failure_shutdown())

    def metrics_snapshot(self) -> dict:
        """Full telemetry snapshot for this node (see metrics_snapshot)."""
        return metrics_snapshot()


class Scheduler(_Node):
    ROLE = 0

    def dead_nodes(self, max_nodes: int = 64) -> list:
        return metrics_snapshot()["dead_nodes"][:max_nodes]


class Server(_Node):
    ROLE = 1


class Replica(_Node):
    """Read-only snapshot replica: registers with the
    scheduler like any rostered node, shadows the server rank named by
    BYTEPS_REPLICA_OF via the snapshot delta protocol, and serves
    CMD_SNAP_PULL reads (byteps_tpu.client.pull_snapshot). Never joins
    the training data plane; its death costs readers one failover and
    trainers nothing."""
    ROLE = 3


class Worker(_Node):
    ROLE = 2

    def worker_rank(self) -> int:
        return self._lib.bps_worker_rank()

    def num_workers(self) -> int:
        """LIVE fleet size: elastic joins/leaves/shrinks move it."""
        return self._lib.bps_num_workers()

    def epoch(self) -> int:
        """Fleet membership epoch — bumped once per server recovery or
        worker join/leave/shrink. Poll it between rounds to observe a
        membership change commit."""
        return int(self._lib.bps_epoch())

    def leave(self) -> None:
        """Graceful leave: after the caller waited all its
        handles, drain and tell the scheduler; on return this rank is
        out of the fleet (call shutdown() and exit — no goodbye owed).
        Raises RuntimeError when the scheduler never acknowledged
        (elasticity off, or not a fleet worker)."""
        if self._lib.bps_leave() != 0:
            raise RuntimeError(
                "graceful leave failed: scheduler did not acknowledge "
                "(is BYTEPS_ELASTIC=1 set fleet-wide?)")

    def barrier(self, group: int = GROUP_WORKERS) -> None:
        """Block until every member of `group` arrives. Default is the
        worker group: a GROUP_ALL barrier requires servers to call Barrier
        too, which BytePS servers (request-driven) never do."""
        self._lib.bps_barrier(group)

    def declare(self, name: str, nelem: int, dtype,
                compression: Optional[str] = None) -> int:
        """Register a tensor (reference: byteps_declare_tensor).
        ``compression`` is a config string ("type=onebit;ef=vanilla"), ""
        to disable, or None to inherit the BYTEPS_COMPRESSOR default."""
        dt = _dtype_code(dtype)
        comp = None if compression is None else compression.encode()
        return int(self._lib.bps_declare(name.encode(), nelem, dt, comp))

    def push_pull(self, tensor_id: int, arr: np.ndarray,
                  average: bool = True, async_mode: bool = False,
                  dtype: Optional[str] = None) -> int:
        """Enqueue all partitions of `arr`; sums across workers IN PLACE.
        Returns a handle for wait/poll. The array must stay alive and
        unmodified until the handle completes. ``dtype`` names the wire
        dtype when it is not ``arr.dtype`` (bfloat16 staged as 16-bit
        words)."""
        assert arr.flags["C_CONTIGUOUS"], "push_pull needs a contiguous array"
        return int(self._lib.bps_push_pull(
            tensor_id, arr.ctypes.data_as(ctypes.c_void_p), arr.size,
            _dtype_code(dtype or arr.dtype), int(average), int(async_mode)))

    def broadcast(self, tensor_id: int, arr: np.ndarray,
                  root_rank: int = 0, dtype: Optional[str] = None) -> int:
        assert arr.flags["C_CONTIGUOUS"]
        return int(self._lib.bps_broadcast(
            tensor_id, arr.ctypes.data_as(ctypes.c_void_p), arr.size,
            _dtype_code(dtype or arr.dtype), root_rank))

    def wait(self, handle: int) -> None:
        """Block until the handle completes. Raises RuntimeError with the
        core's diagnostic if the operation failed fast (dead peer) —
        instead of hanging until the heartbeat detector fires."""
        if self._lib.bps_wait(handle) != 0:
            err = self._lib.bps_last_error()
            raise RuntimeError(
                "byteps push/pull failed: "
                + (err.decode() if err else "unknown error"))

    def poll(self, handle: int) -> bool:
        """Tri-state from the core: 1 complete (reaped), 0 pending, -1
        settled-but-failed. Failure surfaces here too: -1 delegates to
        wait(), which reaps the handle and raises RuntimeError with the
        core's diagnostic — a poll-only consumer neither leaks the
        handle entry nor silently treats a dead-peer failure as
        success."""
        rc = int(self._lib.bps_poll(handle))
        if rc < 0:
            self.wait(handle)  # reaps and raises with the error string
        return bool(rc)

    def net_bytes(self) -> tuple:
        """Cumulative (sent, received) DCN wire bytes through this
        worker's van — for bandwidth assertions and the timeline."""
        van = metrics_snapshot()["van"]
        return int(van["sent_bytes"]), int(van["recv_bytes"])

    def async_staleness(self) -> dict:
        """Cumulative async-pull staleness: per async pull, how many
        fleet-wide pushes the server applied between this worker's push
        and its pull (0 = the pull saw exactly the state this worker
        pushed into). {mean, max, samples}; samples==0 when no async
        pulls have completed."""
        st = metrics_snapshot()["staleness"]
        return {"mean": round(float(st["mean"]), 3),
                "max": int(st["max"]), "samples": int(st["samples"])}
