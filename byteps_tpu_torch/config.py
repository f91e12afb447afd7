"""Environment-variable configuration system.

Capability parity with the reference's config surface (SURVEY.md §5
"Config / flag system"): the reference is configured *entirely* through
environment variables, documented in its ``docs/env.md``. We keep the same
names for the ``DMLC_*`` (role / addressing, inherited from ps-lite) and
``BYTEPS_*`` (core tuning) families so operators can switch without
relearning, and add a typed, validated layer on top.

Reference symbols: ps-lite ``Postoffice`` env parsing (DMLC_NUM_WORKER,
DMLC_NUM_SERVER, DMLC_ROLE, DMLC_PS_ROOT_URI, DMLC_PS_ROOT_PORT) and
``BytePSGlobal::Init`` env parsing (byteps/common/global.cc).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

_TRUTHY = {"1", "true", "yes", "on"}


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def _env_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v in (None, ""):
        return default
    return v.strip().lower() in _TRUTHY


def _env_str(name: str, default: str) -> str:
    v = os.environ.get(name)
    return v if v not in (None, "") else default


VALID_ROLES = ("worker", "server", "scheduler", "replica", "joint")


@dataclasses.dataclass
class Config:
    """Typed snapshot of the byteps_tpu environment configuration."""

    # --- DMLC_* family: process roles and scheduler addressing -------------
    role: str = "worker"                  # DMLC_ROLE
    num_worker: int = 1                   # DMLC_NUM_WORKER
    num_server: int = 0                   # DMLC_NUM_SERVER
    root_uri: str = "127.0.0.1"           # DMLC_PS_ROOT_URI (scheduler host)
    root_port: int = 9000                 # DMLC_PS_ROOT_PORT
    worker_id: int = 0                    # DMLC_WORKER_ID (host index)

    # --- BYTEPS_* family: core tuning --------------------------------------
    partition_bytes: int = 4096000        # BYTEPS_PARTITION_BYTES (~4 MB)
    scheduling_credit: int = 0            # BYTEPS_SCHEDULING_CREDIT
    #   in-flight BYTE budget for the DCN push stage (reference semantics);
    #   0 = auto: 4 x partition_bytes
    fusion_bytes: int = 65536             # BYTEPS_FUSION_BYTES
    #   small-tensor fusion: partitions under this many raw bytes are
    #   coalesced into one multi-key wire frame per (server, flush);
    #   0 disables fusion (pre-fusion wire protocol, byte for byte)
    fusion_keys: int = 128                # BYTEPS_FUSION_KEYS
    #   max sub-operations per fused frame (flush-by-keys bound)
    fusion_linger_us: int = 200           # BYTEPS_FUSION_LINGER_US
    #   how long the collector waits for the next fusible task before
    #   flushing a partial batch (0 = flush immediately)

    # --- block-quantized wire (docs/performance.md) ---------------
    wire_quant: bool = False              # BYTEPS_WIRE_QUANT
    #   encode codec-less float32 partitions as per-block (scale, int8)
    #   on the wire — pushes worker-side with per-key error-feedback
    #   residuals, pull replies re-quantized server-side; the server
    #   dequantizes into its float32 accumulator, so summation order and
    #   precision match the dense wire. 0 (the default) is byte-for-byte
    #   today's wire
    wire_quant_block: int = 64            # BYTEPS_WIRE_QUANT_BLOCK
    #   quantization block: one f32 scale per this many elements; must
    #   be a power of two in [16, 32768]
    wire_quant_min_bytes: int = 1024      # BYTEPS_WIRE_QUANT_MIN_BYTES
    #   partitions under this many raw bytes ship raw float32 (the
    #   per-block scale overhead isn't worth it on tiny tensors)
    local_rank: int = 0                   # BYTEPS_LOCAL_RANK
    local_size: int = 1                   # BYTEPS_LOCAL_SIZE
    log_level: str = "WARNING"            # BYTEPS_LOG_LEVEL
    force_distributed: bool = False       # BYTEPS_FORCE_DISTRIBUTED
    enable_async: bool = False            # BYTEPS_ENABLE_ASYNC
    server_engine_threads: int = 4        # BYTEPS_SERVER_ENGINE_THREAD
    compressor: str = ""                  # BYTEPS_COMPRESSOR (default for all
    #   tensors; per-tensor override via declare_tensor(compression=...))
    compressor_k: int = 0                 # BYTEPS_COMPRESSOR_K
    error_feedback: str = ""              # BYTEPS_ERROR_FEEDBACK ("vanilla")
    momentum: str = ""                    # BYTEPS_MOMENTUM ("nesterov")
    momentum_mu: float = 0.9              # BYTEPS_MOMENTUM_MU

    # --- tracing (reference: BYTEPS_TRACE_*, SURVEY.md §5) --------
    trace_on: bool = False                # BYTEPS_TRACE_ON
    trace_dir: str = "./traces"           # BYTEPS_TRACE_DIR (canonical);
    #   the legacy BPS_TRACE_OUT alias is still accepted — BYTEPS_TRACE_DIR
    #   wins when both are set (with a warning on conflict)
    trace_start_step: int = 1             # BYTEPS_TRACE_START_STEP
    trace_end_step: int = 10              # BYTEPS_TRACE_END_STEP
    #   the step window is enforced in the C core too: once the Timeline
    #   helper reports steps, recording stops outside [start, end]
    trace_ring_events: int = 65536        # BYTEPS_TRACE_RING_EVENTS
    #   main trace ring capacity (drop-oldest; overwrites are counted in
    #   bps_trace_dropped_total and flagged TRACE-DROPPING by monitor.top)
    flight_recorder: bool = True          # BYTEPS_FLIGHT_RECORDER
    #   always-on bounded ring of significant events (epoch pause/resume,
    #   resends, keepalives, chaos, failures) on EVERY role, auto-dumped
    #   to the trace dir on fatal CHECK / failure SHUTDOWN / recovery
    flight_recorder_events: int = 256     # BYTEPS_FLIGHT_RECORDER_EVENTS

    # --- per-round introspection (docs/monitoring.md) -------------
    roundstats_on: bool = True            # BYTEPS_ROUNDSTATS_ON
    #   online per-round stage summaries on every role (queue / compress
    #   / push wire / server_sum / wire_ack / pull / decode, wire bytes,
    #   fused frames, retries, parked ops), accumulated into a bounded
    #   drop-oldest ring and classified live by monitor/insight.py.
    #   Default ON — overhead is within noise (BENCH_insight_r07.json);
    #   0 reduces every site to one relaxed atomic load
    roundstats_ring: int = 256            # BYTEPS_ROUNDSTATS_RING
    #   per-rank round-record ring capacity (drop-oldest; overwrites are
    #   reported as `dropped` in bps_round_summary)
    roundstats_heartbeat_summary: bool = True
    #   BYTEPS_ROUNDSTATS_HEARTBEAT_SUMMARY: piggyback completed-round
    #   summaries on CMD_HEARTBEAT (versioned sub-payload; old/new nodes
    #   interop) so the scheduler keeps the live fleet round table that
    #   `python -m byteps_tpu.monitor.insight --watch` reads. 0 keeps
    #   round summaries rank-local

    # --- fleet event journal (docs/monitoring.md) ----------------
    events_on: bool = True                # BYTEPS_EVENTS_ON
    #   always-on structured lifecycle journal on every role (joins,
    #   leaves, deaths, pause/resume epochs, scheduler fail-over,
    #   checkpoint spills/seals/restores, snapshot commits, CRC
    #   quarantines, ...). Non-scheduler ranks piggyback new events on
    #   CMD_HEARTBEAT; the scheduler ingests them into the clock-aligned
    #   fleet timeline served at /events and read by monitor.incident.
    #   Default ON — overhead is within noise (BENCH_events_r20.json);
    #   0 reduces every emit site to one relaxed atomic load
    events_ring: int = 512                # BYTEPS_EVENTS_RING
    #   per-rank journal ring capacity (drop-oldest; overwrites are
    #   reported as `dropped` in bps_events_summary and flagged by
    #   monitor.incident). The scheduler timeline holds 4x this
    events_history: int = 128             # BYTEPS_EVENTS_HISTORY
    #   scheduler-side per-gauge history ring length (1 Hz samples of
    #   every registered gauge, served in /events as `history` and
    #   summarised by monitor.incident)

    # --- live monitoring (byteps_tpu.monitor, docs/monitoring.md) ----------
    monitor_on: bool = False              # BYTEPS_MONITOR_ON
    monitor_port: int = 9100              # BYTEPS_MONITOR_PORT (BASE port:
    #   each node serves /metrics + /healthz on base + its node id, so one
    #   env var covers a whole co-located fleet)
    straggler_factor: float = 2.0         # BYTEPS_STRAGGLER_FACTOR
    #   monitor.top flags a worker whose mean push latency exceeds
    #   factor x the fleet's low-median (see docs/monitoring.md)

    # --- transient-fault tolerance (docs/troubleshooting.md) ------
    retry_max: int = 4                    # BYTEPS_RETRY_MAX
    #   max resends per request before the worker declares a persistent
    #   fault and fail-stops that handle; 0 disables the whole retry/
    #   reconnect layer (pre-retry fail-fast behavior)
    retry_timeout_ms: int = 1000          # BYTEPS_RETRY_TIMEOUT_MS
    #   response timeout before the first resend; doubles per attempt
    #   (capped at 8x). A server keepalive (duplicate seen, original
    #   still in progress) resets the attempt budget
    reconnect_max: int = 3                # BYTEPS_RECONNECT_MAX
    #   re-dial attempts after a lost worker->server connection before
    #   escalating to the peer-lost fail-fast path
    reconnect_backoff_ms: int = 100       # BYTEPS_RECONNECT_BACKOFF_MS
    #   base backoff between re-dials (doubles per attempt, capped 2 s)

    # --- hot server replacement (docs/troubleshooting.md) ---------
    recovery_timeout_ms: int = 60000      # BYTEPS_RECOVERY_TIMEOUT_MS
    #   how long the scheduler holds the fleet in RECOVERY waiting for a
    #   replacement server (DMLC_RECOVER_RANK) after a server's heartbeat
    #   death, before falling back to the fleet-wide failure SHUTDOWN.
    #   0 disables hot replacement (fail-stop behavior wholesale).
    #   BYTEPS_RETRY_MAX=0 also disables it implicitly: the re-seed
    #   protocol rides the resend queue, so "retry off" keeps its
    #   documented meaning of restoring pre-retry fail-fast wholesale
    #   (see effective_recovery_timeout_ms)
    recover_rank: Optional[int] = None    # DMLC_RECOVER_RANK
    #   server-process only: adopt this dead server rank's id and key
    #   shard instead of joining fleet formation (set by the supervisor
    #   when respawning a dead server role)

    # --- elastic worker membership (docs/elasticity.md) -----------
    elastic: bool = False                 # BYTEPS_ELASTIC
    #   arm join / graceful-leave / worker-death-shrink handling: the
    #   worker set becomes an epoch-versioned quantity — a new worker
    #   (DMLC_JOIN) enters at the next round boundary, a leaver drains
    #   and departs, and a dead worker (heartbeat timeout) shrinks the
    #   fleet to N-1 via server-side rollback instead of the fail-stop
    #   SHUTDOWN. 0 (default) keeps the fail-stop contract byte
    #   for byte. Requires the retry layer (BYTEPS_RETRY_MAX > 0).
    #   Memory while armed: servers retain each in-flight round's
    #   per-sender decoded contributions (freed at round completion)
    elastic_timeout_ms: int = 30000       # BYTEPS_ELASTIC_TIMEOUT_MS
    #   fail-stop fallback window: a membership change that cannot
    #   commit (a worker never acks the join gate) falls back to the
    #   failure SHUTDOWN after this long
    # --- scheduler fail-over (docs/troubleshooting.md) -----------
    sched_recovery_timeout_ms: int = 0    # BYTEPS_SCHED_RECOVERY_TIMEOUT_MS
    #   scheduler crash-restart window: a node losing its scheduler
    #   connection PARKS (data plane keeps draining against the last
    #   committed address book) and re-dials the scheduler endpoint for
    #   this long before escalating to the old fail-stop; a restarted
    #   scheduler (DMLC_SCHED_RECOVER) waits this long for the fleet's
    #   re-registration quorum. 0 (default) keeps the scheduler-lost
    #   fail-stop contract byte for byte. Requires the retry layer AND
    #   heartbeats (the failed beat is the loss detector; the rebuilt
    #   death table needs commit-time seeds)
    sched_recover: bool = False           # DMLC_SCHED_RECOVER
    #   scheduler-process only: this incarnation is a crash-restart —
    #   rebuild all control-plane state from re-registrations instead
    #   of forming a fleet (set by the supervisor when respawning a
    #   dead scheduler role)
    join_fleet: bool = False              # DMLC_JOIN
    #   worker-process only: join a RUNNING fleet instead of taking part
    #   in formation (set by the launcher's elastic scale-up / a
    #   supervisor respawning a dead worker as a fresh joiner)

    # --- multi-tenant PS (docs/multitenancy.md) -------------------
    tenant_id: Optional[int] = None       # BYTEPS_TENANT_ID
    #   this JOB's tenant id (u16; every process of one job shares it).
    #   Unset (None) = the legacy/default tenant: the wire format and
    #   server engine dispatch are byte-for-byte the pre-tenant ones.
    #   Set, it namespaces the job's keys server-side as (tenant, key)
    #   — two jobs with colliding tids can never alias — and enrols the
    #   job in the weighted-fair engine dispatch
    tenant_name: str = ""                 # BYTEPS_TENANT_NAME
    #   display name for /tenants and monitor.top rows (never on the
    #   wire); defaults to "tenant<ID>"
    tenant_weight: int = 1                # BYTEPS_TENANT_WEIGHT
    #   this tenant's fair-share weight: whenever two tenants' engine
    #   lanes are both backlogged, served bytes converge to the weight
    #   ratio (deficit round robin; docs/multitenancy.md)
    tenant_quantum_bytes: int = 65536     # BYTEPS_TENANT_QUANTUM_BYTES
    #   DRR base quantum: one scheduling visit grants weight x this
    #   many bytes of service to a tenant's lane
    tenant_starve_ms: int = 2000          # BYTEPS_TENANT_STARVE_MS
    #   monitoring threshold: a tenant with queued engine work unserved
    #   longer than this is flagged STARVED (/tenants + monitor.top)
    server_engine_pace_mbps: int = 0      # BYTEPS_SERVER_ENGINE_PACE_MBPS
    #   per-engine-thread service-rate cap (0 = off): ops knob for
    #   bounding a shared server's CPU burn, and the calibration lever
    #   the weighted-split QoS tests/bench use to create honest engine
    #   contention on loopback

    # --- versioned snapshot serving (docs/serving.md) ------------
    snapshot_retain: int = 4              # BYTEPS_SNAPSHOT_RETAIN
    #   how many committed round-versioned snapshot cuts each server
    #   retains per key (bounded ring; readers pinned to an evicted
    #   version get a clean EVICTED miss and restart at the new
    #   latest). 0 disables snapshot publication entirely — the
    #   serving path then answers every pull NOT_COMMITTED
    serving_weight: int = 1               # BYTEPS_SERVING_WEIGHT
    #   DRR weight of the reader lane in the server engine: snapshot
    #   pulls and replica delta requests share one low-weight lane, so
    #   a reader swarm can never starve training pushes — served bytes
    #   converge to serving_weight : sum(tenant weights)
    replica_of: Optional[int] = None      # BYTEPS_REPLICA_OF
    #   replica-process only: the server RANK (0-based) this read
    #   replica subscribes to for snapshot deltas. Like
    #   DMLC_RECOVER_RANK it is per-process identity owned by the
    #   supervisor and is never projected fleet-wide
    snap_delta_max_bytes: int = 16 << 20  # BYTEPS_SNAP_DELTA_MAX_BYTES
    #   cap on one replica delta batch's raw payload; a catch-up larger
    #   than this arrives as several whole-version batches
    replica_poll_ms: int = 200            # BYTEPS_REPLICA_POLL_MS
    #   replica -> primary delta poll period; also the re-dial backoff
    #   after a lost primary connection
    replica_lag_rounds: int = 8           # BYTEPS_REPLICA_LAG_ROUNDS
    #   monitoring threshold: monitor.top flags a replica
    #   REPLICA-LAGGING when its committed snapshot version trails its
    #   primary's by more than this many rounds

    # --- durable checkpoints (docs/checkpoint.md) ----------------
    ckpt_dir: str = ""                    # BYTEPS_CKPT_DIR
    #   server-side durable spill directory: each server persists every
    #   BYTEPS_CKPT_EVERY'th committed snapshot cut as CRC32C-checksummed
    #   chunk files plus a sealed MANIFEST (tmp -> fsync -> rename), off
    #   the engine critical path. Empty (default) keeps the server
    #   byte-for-byte pre-checkpoint — no writer thread, no metrics
    ckpt_every: int = 1                   # BYTEPS_CKPT_EVERY
    #   spill cadence: persist every Nth committed snapshot version
    ckpt_retain: int = 2                  # BYTEPS_CKPT_RETAIN
    #   durable retention: keep the newest N checkpoint versions per
    #   shard on disk (older directories are pruned after each spill)
    ckpt_restore: bool = False            # BYTEPS_CKPT_RESTORE
    #   server-process only: arm restore — scan BYTEPS_CKPT_DIR for the
    #   newest checksum-valid manifest at startup and report it at
    #   registration; the scheduler commits a fleet-wide restore epoch
    #   at the minimum common version (all servers must be armed, and
    #   every shard must hold a valid checkpoint — a missing/corrupt
    #   shard is a clean fail-stop, never a silent cold start)
    ckpt_lag_warn: int = 8                # BYTEPS_CKPT_LAG_WARN
    #   monitoring threshold: monitor.top flags a server CKPT-LAGGING
    #   when its latest committed snapshot version leads its last
    #   durably spilled version by more than this many rounds
    chaos_ckpt: str = ""                  # BYTEPS_CHAOS_CKPT
    #   torn-write injection ("truncate" | "bitflip" | "sealflip"):
    #   corrupt a seeded-random chunk (truncate/bitflip) or the sealed
    #   MANIFEST itself (sealflip) of every spill AFTER its CRC is
    #   recorded — the restore scan must reject the version by name

    # --- wire integrity (BYTEPS_WIRE_CRC*) -----------------------
    wire_crc: bool = False                # BYTEPS_WIRE_CRC
    #   stamp a CRC32C trailer over header + payload on every data-plane
    #   frame; receivers verify BEFORE the frame touches any dedup /
    #   engine / accumulator state and drop mismatches exactly like a
    #   chaos drop (the retry layer resends). Off (default) keeps every
    #   frame byte-for-byte the pre-CRC wire
    wire_crc_quarantine: int = 0          # BYTEPS_WIRE_CRC_QUARANTINE
    #   flaky-link quarantine: CRC failures tolerated per window per
    #   connection; exceeding it force-closes the connection so the
    #   reconnect ladder re-dials a fresh socket, and past the reconnect
    #   budget (BYTEPS_RECONNECT_MAX) the persistently corrupting link
    #   fail-stops BY NAME. 0 (default) = count/trace only
    wire_crc_window_ms: int = 10000       # BYTEPS_WIRE_CRC_WINDOW_MS
    #   the quarantine failure-counting window

    # --- chaos injection (deterministic fault harness; BYTEPS_CHAOS_*) -----
    chaos_seed: int = 0                   # BYTEPS_CHAOS_SEED
    chaos_drop: float = 0.0               # BYTEPS_CHAOS_DROP
    #   P(drop) per data-plane frame on the send path (0 disables)
    chaos_dup: float = 0.0                # BYTEPS_CHAOS_DUP
    #   P(duplicate delivery) per data-plane frame
    chaos_corrupt: float = 0.0            # BYTEPS_CHAOS_CORRUPT
    #   P(one on-wire payload byte flipped AFTER the CRC trailer is
    #   stamped) per data-plane frame; requires BYTEPS_WIRE_CRC=1 —
    #   undetected corruption would be silently summed into the model
    chaos_delay_us: int = 0               # BYTEPS_CHAOS_DELAY_US
    #   fixed extra latency per data-plane frame
    chaos_reset_every: int = 0            # BYTEPS_CHAOS_RESET_EVERY
    #   force a connection reset every N data-plane frames (0 disables)
    chaos_ctrl: bool = False              # BYTEPS_CHAOS_CTRL
    #   opt-in: let the drop/dup/delay/reset dice also hit CONTROL-plane
    #   frames (heartbeats, membership, scheduler traffic). Requires
    #   scheduler recovery armed — a control-plane drop with no recovery
    #   path is just a slow fail-stop, not a test of anything

    # --- TPU-specific (new scope; no reference equivalent) -----------------
    ici_axis: str = "ici"                 # mesh axis name for intra-slice
    dcn_axis: str = "dcn"                 # mesh axis name for inter-slice
    ps_mode: str = "auto"                 # BYTEPS_PS_MODE: auto|collective|ps
    #   collective: both levels via XLA collectives (single-controller SPMD)
    #   ps:         DCN level via C++ KV push/pull to CPU parameter servers
    #   auto:       ps iff a scheduler is configured (num_server > 0 or
    #               force_distributed), else collective
    heartbeat_interval_s: float = 5.0     # PS_HEARTBEAT_INTERVAL
    heartbeat_timeout_s: float = 30.0     # PS_HEARTBEAT_TIMEOUT

    @property
    def size(self) -> int:
        return self.num_worker * self.local_size

    @property
    def distributed(self) -> bool:
        """True when the DCN/PS leg is active (reference: BytePSGlobal's
        _is_distributed_job: num_server > 0 or BYTEPS_FORCE_DISTRIBUTED)."""
        return self.num_server > 0 or self.force_distributed

    @property
    def effective_recovery_timeout_ms(self) -> int:
        """Recovery window the fleet actually runs with. Hot server
        replacement rides the retry layer's resend queue, so
        BYTEPS_RETRY_MAX=0 (the documented restore-fail-fast-wholesale
        escape hatch) implies recovery off without needing
        BYTEPS_RECOVERY_TIMEOUT_MS=0 to be set separately. This value —
        not the raw knob — is what ffi projects to the C core."""
        return 0 if self.retry_max == 0 else self.recovery_timeout_ms

    @property
    def effective_sched_recovery_timeout_ms(self) -> int:
        """Scheduler fail-over window the fleet actually runs with. The
        park path rides the same retry/reconnect machinery as hot server
        replacement, so BYTEPS_RETRY_MAX=0 implies scheduler recovery
        off too. This value — not the raw knob — is what ffi projects
        to the C core."""
        return 0 if self.retry_max == 0 else self.sched_recovery_timeout_ms

    @property
    def use_ps(self) -> bool:
        if self.ps_mode == "ps":
            return True
        if self.ps_mode == "collective":
            return False
        return self.distributed

    def validate(self) -> "Config":
        if self.role not in VALID_ROLES:
            raise ValueError(
                f"DMLC_ROLE must be one of {VALID_ROLES}, got {self.role!r}")
        if self.partition_bytes <= 0:
            raise ValueError("BYTEPS_PARTITION_BYTES must be positive")
        if self.scheduling_credit < 0:
            raise ValueError(
                "BYTEPS_SCHEDULING_CREDIT is a byte budget; must be >= 0 "
                "(0 = auto: 4 x BYTEPS_PARTITION_BYTES)")
        if 0 < self.scheduling_credit < 1024:
            # A handful of BYTES can only be a legacy partition-count
            # value; honouring it as bytes would serialise every push.
            # Warn here but do NOT rewrite the value: the C core is the
            # single conversion point (worker.cc interprets any value
            # < 1024 as a partition count and multiplies by
            # partition_bytes). Converting in both layers would compose,
            # and would make validate() non-idempotent. Values >= 1024
            # are honoured as genuine byte budgets.
            import warnings
            warnings.warn(
                f"BYTEPS_SCHEDULING_CREDIT={self.scheduling_credit} looks "
                "like a legacy in-flight partition count; the core will "
                f"interpret it as {self.scheduling_credit} x "
                f"{self.partition_bytes} bytes (it is now a BYTE budget; "
                "set 0 for auto = 4 x BYTEPS_PARTITION_BYTES)",
                stacklevel=2)
        if self.fusion_bytes < 0:
            raise ValueError(
                "BYTEPS_FUSION_BYTES must be >= 0 (0 disables small-"
                "tensor fusion; partitions under the threshold are "
                "coalesced into multi-key frames)")
        if self.fusion_bytes > 0 and self.fusion_keys < 2:
            # Only meaningful while fusion is on: with BYTEPS_FUSION_BYTES=0
            # the collector never runs and fusion_keys is ignored, so an
            # explicitly-disabled config must not fail startup over it.
            raise ValueError(
                "BYTEPS_FUSION_KEYS must be >= 2 (a fused frame needs at "
                "least two sub-operations; use BYTEPS_FUSION_BYTES=0 to "
                "disable fusion)")
        if self.fusion_linger_us < 0:
            raise ValueError(
                "BYTEPS_FUSION_LINGER_US must be >= 0 (microseconds the "
                "fusion collector waits before flushing a partial batch)")
        if (self.wire_quant_block < 16 or self.wire_quant_block > 32768
                or self.wire_quant_block & (self.wire_quant_block - 1)):
            raise ValueError(
                f"BYTEPS_WIRE_QUANT_BLOCK ({self.wire_quant_block}) must "
                "be a power of two in [16, 32768]: one f32 scale is "
                "shipped per block, and the decode path rejects any "
                "other geometry as a malformed frame")
        if self.wire_quant_min_bytes < 0:
            raise ValueError(
                "BYTEPS_WIRE_QUANT_MIN_BYTES must be >= 0 (partitions "
                "under it ship raw float32)")
        if self.wire_quant and self.compressor:
            # The quantized wire operates on RAW float32 sub-payloads;
            # a fleet-wide codec means every key ships compressor bytes
            # instead, so quant would silently never engage — reject the
            # contradiction instead of shipping a no-op config. Per-key
            # overrides still compose: declare_tensor(compression=...)
            # keys ship codec bytes, codec-less float32 keys quantize.
            raise ValueError(
                "BYTEPS_WIRE_QUANT requires the fused wire's raw float32 "
                "payloads, but BYTEPS_COMPRESSOR "
                f"({self.compressor!r}) puts a codec on every key — "
                "quant would never apply. Drop one, or move the codec "
                "to per-tensor declare_tensor(compression=...) overrides")
        if self.wire_quant and self.enable_async:
            # Async keeps the authoritative accumulator server-side and
            # applies each push as it lands: the accumulator integrates
            # LOSSY deltas with no round boundary for error feedback to
            # true them up against, so the async parameter drifts by the
            # accumulated quantization error. Legal, but worth a loud
            # nudge.
            import warnings
            warnings.warn(
                "BYTEPS_WIRE_QUANT with BYTEPS_ENABLE_ASYNC: the async "
                "server accumulator integrates lossy int8 deltas "
                "directly (worker-side error feedback compensates "
                "ACROSS rounds, not within the server's running sum); "
                "expect parameter drift proportional to the per-push "
                "quantization error", stacklevel=2)
        if self.trace_start_step < 1:
            raise ValueError(
                "BYTEPS_TRACE_START_STEP must be >= 1 (steps are "
                "1-indexed; the window starts at this step)")
        if self.trace_end_step < self.trace_start_step:
            raise ValueError(
                f"BYTEPS_TRACE_END_STEP ({self.trace_end_step}) must be "
                f">= BYTEPS_TRACE_START_STEP ({self.trace_start_step}): "
                "an inverted window records nothing and dumps an empty "
                "timeline")
        if self.trace_ring_events < 16:
            raise ValueError(
                "BYTEPS_TRACE_RING_EVENTS must be >= 16 (main trace "
                "ring capacity, drop-oldest)")
        if self.flight_recorder_events < 8:
            raise ValueError(
                "BYTEPS_FLIGHT_RECORDER_EVENTS must be >= 8 (flight "
                "recorder ring capacity; set BYTEPS_FLIGHT_RECORDER=0 "
                "to disable the recorder instead)")
        if self.roundstats_ring < 8:
            raise ValueError(
                "BYTEPS_ROUNDSTATS_RING must be >= 8 (per-rank round-"
                "record ring capacity, drop-oldest; set "
                "BYTEPS_ROUNDSTATS_ON=0 to disable round summaries "
                "instead of shrinking the ring to nothing)")
        if self.events_ring < 16:
            raise ValueError(
                "BYTEPS_EVENTS_RING must be >= 16 (per-rank journal "
                "ring capacity, drop-oldest; set BYTEPS_EVENTS_ON=0 to "
                "disable the journal instead of shrinking the ring to "
                "nothing)")
        if self.events_history < 8:
            raise ValueError(
                "BYTEPS_EVENTS_HISTORY must be >= 8 (scheduler "
                "per-gauge history ring length)")
        if self.num_worker < 1:
            raise ValueError("DMLC_NUM_WORKER must be >= 1")
        if self.ps_mode not in ("auto", "collective", "ps"):
            raise ValueError("BYTEPS_PS_MODE must be auto|collective|ps")
        if not (0 < self.monitor_port < 65536):
            raise ValueError(
                "BYTEPS_MONITOR_PORT must be in (0, 65536); it is the BASE "
                "port — each node serves on base + its node id")
        if self.straggler_factor < 1.0:
            raise ValueError(
                "BYTEPS_STRAGGLER_FACTOR must be >= 1.0 (a worker is "
                "flagged when its mean push latency exceeds factor x the "
                "fleet low-median)")
        if self.retry_max < 0:
            raise ValueError(
                "BYTEPS_RETRY_MAX must be >= 0 (0 disables the transient-"
                "fault retry/reconnect layer)")
        if self.retry_timeout_ms < 10:
            raise ValueError(
                "BYTEPS_RETRY_TIMEOUT_MS must be >= 10 (response timeout "
                "before the first resend)")
        if self.reconnect_max < 1:
            raise ValueError(
                "BYTEPS_RECONNECT_MAX must be >= 1 (re-dial attempts "
                "after a lost server connection)")
        if self.reconnect_backoff_ms < 1:
            raise ValueError(
                "BYTEPS_RECONNECT_BACKOFF_MS must be >= 1")
        if self.tenant_id is not None and not (0 <= self.tenant_id
                                               <= 0xFFFF):
            raise ValueError(
                f"BYTEPS_TENANT_ID ({self.tenant_id}) must be in "
                "[0, 65535] — it rides a u16 wire field "
                "(docs/multitenancy.md)")
        if not (1 <= self.tenant_weight <= (1 << 20)):
            raise ValueError(
                f"BYTEPS_TENANT_WEIGHT ({self.tenant_weight}) must be "
                "in [1, 2^20]: it scales the engine's DRR quantum "
                "grant, and a zero weight would never be scheduled")
        if self.tenant_weight != 1 and self.tenant_id is None:
            import warnings
            warnings.warn(
                "BYTEPS_TENANT_WEIGHT is set but BYTEPS_TENANT_ID is "
                "not: an unregistered process rides the legacy tenant "
                "0 pool and its weight is never enrolled — set "
                "BYTEPS_TENANT_ID on every process of the job",
                stacklevel=2)
        if self.tenant_quantum_bytes < 1024:
            raise ValueError(
                "BYTEPS_TENANT_QUANTUM_BYTES must be >= 1024 (the DRR "
                "base quantum; far-below-task-size quanta only add "
                "scheduling laps, never change the fair share)")
        if self.tenant_starve_ms < 1:
            raise ValueError(
                "BYTEPS_TENANT_STARVE_MS must be >= 1 (the starvation "
                "flag threshold for /tenants and monitor.top)")
        if self.server_engine_pace_mbps < 0:
            raise ValueError(
                "BYTEPS_SERVER_ENGINE_PACE_MBPS must be >= 0 (0 "
                "disables the per-engine-thread service-rate cap)")
        if self.tenant_id is not None and self.tenant_id > 0 \
                and self.enable_async:
            import warnings
            warnings.warn(
                "BYTEPS_TENANT_ID with BYTEPS_ENABLE_ASYNC: async "
                "keys are (tenant, key)-namespaced and QoS-scheduled, "
                "but the async mean divisor stays the fleet-wide "
                "worker count — use sync mode for multi-job fleets",
                stacklevel=2)
        if not (0.0 <= self.chaos_drop < 1.0):
            raise ValueError(
                "BYTEPS_CHAOS_DROP is a probability in [0, 1): dropping "
                "every frame can never make progress")
        if not (0.0 <= self.chaos_dup < 1.0):
            raise ValueError("BYTEPS_CHAOS_DUP is a probability in [0, 1)")
        if not (0.0 <= self.chaos_corrupt <= 1.0):
            # 1.0 IS legal here (unlike drop): corrupting every frame is
            # the persistent-corruption test — the quarantine ladder must
            # escalate it to the named fail-stop, not hang.
            raise ValueError(
                "BYTEPS_CHAOS_CORRUPT is a probability in [0, 1]")
        if self.chaos_delay_us < 0:
            raise ValueError("BYTEPS_CHAOS_DELAY_US must be >= 0")
        if self.chaos_reset_every < 0:
            raise ValueError(
                "BYTEPS_CHAOS_RESET_EVERY must be >= 0 (reset the "
                "connection every N data frames; 0 disables)")
        chaos_on = (self.chaos_drop > 0 or self.chaos_dup > 0
                    or self.chaos_corrupt > 0
                    or self.chaos_reset_every > 0)
        if chaos_on and self.retry_max == 0:
            raise ValueError(
                "BYTEPS_CHAOS_DROP/_DUP/_CORRUPT/_RESET_EVERY inject "
                "faults that only the retry layer can absorb; they "
                "require BYTEPS_RETRY_MAX > 0 (the combination would "
                "just crash the fleet at the first injected fault)")
        if self.chaos_corrupt > 0 and not self.wire_crc:
            raise ValueError(
                "BYTEPS_CHAOS_CORRUPT flips on-wire payload bytes; it "
                "requires BYTEPS_WIRE_CRC=1 — without the CRC trailer "
                "the corruption goes undetected and is silently summed "
                "into the model instead of exercising the drop/resend "
                "path under test")
        if self.wire_crc_quarantine < 0:
            raise ValueError(
                "BYTEPS_WIRE_CRC_QUARANTINE must be >= 0 (CRC failures "
                "tolerated per window per connection; 0 disables "
                "quarantine and keeps count/trace-only behavior)")
        if self.wire_crc_window_ms < 100:
            raise ValueError(
                "BYTEPS_WIRE_CRC_WINDOW_MS must be >= 100 (the "
                "quarantine failure-counting window; sub-100ms windows "
                "reset faster than a retry round trip, so the threshold "
                "could never accumulate)")
        if self.wire_crc_quarantine > 0 and not self.wire_crc:
            import warnings
            warnings.warn(
                "BYTEPS_WIRE_CRC_QUARANTINE is set but BYTEPS_WIRE_CRC "
                "is off: no frame carries a CRC, so no failure can ever "
                "be counted and the quarantine never fires", stacklevel=2)
        if self.recovery_timeout_ms < 0:
            raise ValueError(
                "BYTEPS_RECOVERY_TIMEOUT_MS must be >= 0 (0 disables hot "
                "server replacement; a dead server then fail-stops the "
                "fleet as before)")
        if (self.effective_recovery_timeout_ms > 0
                and self.heartbeat_interval_s > 0
                and self.recovery_timeout_ms
                <= self.heartbeat_timeout_s * 1000.0):
            raise ValueError(
                f"BYTEPS_RECOVERY_TIMEOUT_MS ({self.recovery_timeout_ms}) "
                f"must exceed PS_HEARTBEAT_TIMEOUT "
                f"({self.heartbeat_timeout_s}s): the replacement's own "
                "startup + registration takes at least as long as a "
                "heartbeat round trip, so a shorter window can only ever "
                "time out into the fail-stop fallback")
        if self.recover_rank is not None:
            if self.effective_recovery_timeout_ms == 0:
                raise ValueError(
                    "DMLC_RECOVER_RANK is set but hot replacement is "
                    "disabled (BYTEPS_RECOVERY_TIMEOUT_MS=0, or "
                    "BYTEPS_RETRY_MAX=0 — re-seed rides the resend "
                    "queue, so retry off implies recovery off) — the "
                    "scheduler would reject the recovery registration")
            if self.role != "server":
                raise ValueError(
                    "DMLC_RECOVER_RANK is a server-process knob (the "
                    f"replacement adopts the dead rank); role is "
                    f"{self.role!r}")
            if not (0 <= self.recover_rank < max(self.num_server, 1)):
                raise ValueError(
                    f"DMLC_RECOVER_RANK={self.recover_rank} out of range: "
                    f"the fleet has {self.num_server} server rank(s) "
                    f"(valid: 0..{max(self.num_server - 1, 0)})")
        if self.sched_recovery_timeout_ms < 0:
            raise ValueError(
                "BYTEPS_SCHED_RECOVERY_TIMEOUT_MS must be >= 0 (0 "
                "disables scheduler fail-over; a dead scheduler then "
                "fail-stops the fleet as before)")
        if self.sched_recovery_timeout_ms > 0:
            if self.retry_max == 0:
                raise ValueError(
                    "BYTEPS_SCHED_RECOVERY_TIMEOUT_MS requires the retry "
                    "layer (BYTEPS_RETRY_MAX > 0): parked nodes keep the "
                    "data plane draining through the outage, and only the "
                    "retry/dedup machinery makes the in-flight rounds "
                    "exact across the scheduler restart")
            if self.heartbeat_interval_s <= 0:
                raise ValueError(
                    "BYTEPS_SCHED_RECOVERY_TIMEOUT_MS requires heartbeats "
                    "(PS_HEARTBEAT_INTERVAL > 0): the failed heartbeat is "
                    "how a node detects the scheduler is gone, and the "
                    "restarted scheduler seeds its death table from the "
                    "re-registration commit")
            if self.sched_recovery_timeout_ms \
                    <= self.heartbeat_timeout_s * 1000.0:
                raise ValueError(
                    f"BYTEPS_SCHED_RECOVERY_TIMEOUT_MS "
                    f"({self.sched_recovery_timeout_ms}) must exceed "
                    f"PS_HEARTBEAT_TIMEOUT ({self.heartbeat_timeout_s}s): "
                    "every surviving node needs at least one failed "
                    "heartbeat round trip just to NOTICE the crash, so a "
                    "shorter window can only ever expire into the "
                    "fail-stop fallback")
        if self.sched_recover:
            if self.effective_sched_recovery_timeout_ms == 0:
                raise ValueError(
                    "DMLC_SCHED_RECOVER is set but scheduler fail-over is "
                    "disabled (BYTEPS_SCHED_RECOVERY_TIMEOUT_MS=0, or "
                    "BYTEPS_RETRY_MAX=0 — the park path rides the resend "
                    "queue, so retry off implies recovery off) — the "
                    "fleet would never re-register with this incarnation")
            if self.role != "scheduler":
                raise ValueError(
                    "DMLC_SCHED_RECOVER is a scheduler-process knob (a "
                    "crash-restarted scheduler rebuilding state from the "
                    f"fleet); role is {self.role!r}")
        if self.chaos_ctrl:
            if not chaos_on:
                import warnings
                warnings.warn(
                    "BYTEPS_CHAOS_CTRL=1 with no chaos dice armed "
                    "(BYTEPS_CHAOS_DROP/_DUP/_RESET_EVERY all zero): the "
                    "control-plane opt-in has nothing to inject",
                    stacklevel=2)
            if self.effective_sched_recovery_timeout_ms == 0:
                raise ValueError(
                    "BYTEPS_CHAOS_CTRL extends fault injection to "
                    "control-plane frames (heartbeats, membership, "
                    "scheduler traffic); it requires scheduler fail-over "
                    "armed (BYTEPS_SCHED_RECOVERY_TIMEOUT_MS > 0 and "
                    "BYTEPS_RETRY_MAX > 0) — a control-plane drop with no "
                    "recovery path is just a slow fail-stop")
        if self.elastic and self.retry_max == 0:
            raise ValueError(
                "BYTEPS_ELASTIC requires the retry layer "
                "(BYTEPS_RETRY_MAX > 0): membership changes leave "
                "rounds mid-flight across the commit, and only the "
                "retry/dedup machinery makes their completion exact")
        if self.elastic_timeout_ms < 1000:
            raise ValueError(
                "BYTEPS_ELASTIC_TIMEOUT_MS must be >= 1000 (the "
                "fail-stop fallback window for a membership change "
                "that cannot commit)")
        if self.join_fleet:
            if not self.elastic:
                raise ValueError(
                    "DMLC_JOIN is set but BYTEPS_ELASTIC is off — the "
                    "scheduler would ignore the join request and this "
                    "process would time out at formation")
            if self.role != "worker":
                raise ValueError(
                    "DMLC_JOIN is a worker-process knob (a new worker "
                    f"joining a running fleet); role is {self.role!r}")
        if self.elastic and self.heartbeat_interval_s <= 0:
            import warnings
            warnings.warn(
                "BYTEPS_ELASTIC with heartbeats disabled "
                "(PS_HEARTBEAT_INTERVAL <= 0): planned joins/leaves "
                "work, but a worker DEATH can never be detected, so "
                "the death-shrink path is unreachable", stacklevel=2)
        if self.effective_recovery_timeout_ms > 0 and self.enable_async:
            # Async mode keeps the authoritative accumulator SERVER-side;
            # a dead server's param state is not reconstructible from
            # workers, so recovery re-seeds nothing for async keys.
            import warnings
            warnings.warn(
                "BYTEPS_ENABLE_ASYNC with hot server replacement: a "
                "replaced server loses its async accumulator state "
                "(workers hold no authoritative copy); async training "
                "semantics after a recovery are undefined — set "
                "BYTEPS_RECOVERY_TIMEOUT_MS=0 for async jobs",
                stacklevel=2)
        if self.snapshot_retain < 0:
            raise ValueError(
                "BYTEPS_SNAPSHOT_RETAIN must be >= 0 (0 disables "
                "snapshot publication; N keeps the last N committed "
                "round cuts per key)")
        if self.serving_weight < 1:
            raise ValueError(
                "BYTEPS_SERVING_WEIGHT must be >= 1: the reader lane "
                "needs a nonzero DRR weight or snapshot pulls would "
                "never be scheduled at all (use a small weight to "
                "deprioritize readers, not zero)")
        if self.snap_delta_max_bytes < 4096:
            raise ValueError(
                "BYTEPS_SNAP_DELTA_MAX_BYTES must be >= 4096: a delta "
                "batch always carries at least one whole version, so a "
                "cap below one small tensor just adds per-batch "
                "overhead without bounding anything")
        if self.replica_poll_ms < 10:
            raise ValueError(
                "BYTEPS_REPLICA_POLL_MS must be >= 10 (the replica "
                "delta poll period; sub-10ms polling busy-spins the "
                "primary's serving lane)")
        if self.replica_lag_rounds < 1:
            raise ValueError(
                "BYTEPS_REPLICA_LAG_ROUNDS must be >= 1 (the "
                "REPLICA-LAGGING monitor threshold; a replica is "
                "always legitimately one poll period behind)")
        if self.replica_of is not None:
            if self.role != "replica":
                raise ValueError(
                    "BYTEPS_REPLICA_OF is a replica-process knob (which "
                    "server rank this read replica subscribes to); role "
                    f"is {self.role!r}")
            if not (0 <= self.replica_of < max(self.num_server, 1)):
                raise ValueError(
                    f"BYTEPS_REPLICA_OF={self.replica_of} out of range: "
                    f"the fleet has {self.num_server} server rank(s) "
                    f"(valid: 0..{max(self.num_server - 1, 0)})")
        if self.role == "replica":
            if self.snapshot_retain == 0:
                raise ValueError(
                    "role=replica with BYTEPS_SNAPSHOT_RETAIN=0: the "
                    "primary publishes no snapshots, so the replica "
                    "would have nothing to subscribe to and every pull "
                    "would miss NOT_COMMITTED forever")
            if self.enable_async:
                raise ValueError(
                    "role=replica with BYTEPS_ENABLE_ASYNC: snapshots "
                    "are round-versioned consistent cuts, and async "
                    "mode has no round boundaries to cut at — snapshot "
                    "serving is a sync-mode feature")
        if self.ckpt_every < 1:
            raise ValueError(
                "BYTEPS_CKPT_EVERY must be >= 1 (spill every Nth "
                "committed snapshot version)")
        if self.ckpt_retain < 1:
            raise ValueError(
                "BYTEPS_CKPT_RETAIN must be >= 1 (durable retention "
                "below one version would prune the checkpoint being "
                "written; unset BYTEPS_CKPT_DIR to disable spilling)")
        if self.ckpt_lag_warn < 1:
            raise ValueError(
                "BYTEPS_CKPT_LAG_WARN must be >= 1 (the CKPT-LAGGING "
                "monitor threshold; a server is always legitimately "
                "mid-spill one version behind)")
        if self.ckpt_dir and self.snapshot_retain == 0:
            raise ValueError(
                "BYTEPS_CKPT_DIR with BYTEPS_SNAPSHOT_RETAIN=0: the "
                "durable spill persists committed snapshot cuts, and "
                "with snapshot publication disabled there is never a "
                "cut to spill — every checkpoint would be empty")
        if self.ckpt_restore and not self.ckpt_dir:
            raise ValueError(
                "BYTEPS_CKPT_RESTORE=1 requires BYTEPS_CKPT_DIR: "
                "restore scans the spill directory for the newest "
                "checksum-valid manifest, and there is no directory "
                "to scan")
        if self.chaos_ckpt:
            if self.chaos_ckpt not in ("truncate", "bitflip", "sealflip"):
                raise ValueError(
                    f"BYTEPS_CHAOS_CKPT ({self.chaos_ckpt!r}) must be "
                    "'truncate' or 'bitflip' (torn-write injection on a "
                    "seeded-random chunk of every spill) or 'sealflip' "
                    "(corrupt the sealed MANIFEST itself)")
            if not self.ckpt_dir:
                raise ValueError(
                    "BYTEPS_CHAOS_CKPT requires BYTEPS_CKPT_DIR: "
                    "torn-write injection corrupts checkpoint spills, "
                    "and there is nothing being spilled")
        if self.heartbeat_interval_s > 0 and \
                self.heartbeat_timeout_s <= self.heartbeat_interval_s:
            # A timeout at-or-below the interval declares healthy nodes
            # dead on the first missed tick: the scheduler checks ages
            # every interval, and a node's age legitimately reaches the
            # full interval between beats. Fail fast with the fix named.
            raise ValueError(
                f"PS_HEARTBEAT_TIMEOUT ({self.heartbeat_timeout_s}s) must "
                f"be greater than PS_HEARTBEAT_INTERVAL "
                f"({self.heartbeat_interval_s}s) — a timeout at or below "
                "the interval declares healthy nodes dead on their first "
                "missed tick; use a timeout of several intervals (default "
                "5s/30s)")
        return self


def _trace_dir_from_env() -> str:
    """Canonical trace directory: BYTEPS_TRACE_DIR, with the legacy
    BPS_TRACE_OUT accepted as an alias (docs/timeline.md used one name,
    the config read the other — now unified). On conflict the
    canonical name wins, with a warning naming both values."""
    new = os.environ.get("BYTEPS_TRACE_DIR")
    old = os.environ.get("BPS_TRACE_OUT")
    if new and old and new != old:
        import warnings
        warnings.warn(
            f"both BYTEPS_TRACE_DIR ({new!r}) and its legacy alias "
            f"BPS_TRACE_OUT ({old!r}) are set and disagree; using "
            "BYTEPS_TRACE_DIR (the canonical name — drop BPS_TRACE_OUT)",
            stacklevel=2)
    return new or old or "./traces"


def load_config() -> Config:
    """Read the full configuration from the environment (one snapshot)."""
    return Config(
        role=_env_str("DMLC_ROLE", "worker").lower(),
        num_worker=_env_int("DMLC_NUM_WORKER", 1),
        num_server=_env_int("DMLC_NUM_SERVER", 0),
        root_uri=_env_str("DMLC_PS_ROOT_URI", "127.0.0.1"),
        root_port=_env_int("DMLC_PS_ROOT_PORT", 9000),
        worker_id=_env_int("DMLC_WORKER_ID", 0),
        partition_bytes=_env_int("BYTEPS_PARTITION_BYTES", 4096000),
        scheduling_credit=_env_int("BYTEPS_SCHEDULING_CREDIT", 0),
        fusion_bytes=_env_int("BYTEPS_FUSION_BYTES", 65536),
        fusion_keys=_env_int("BYTEPS_FUSION_KEYS", 128),
        fusion_linger_us=_env_int("BYTEPS_FUSION_LINGER_US", 200),
        wire_quant=_env_bool("BYTEPS_WIRE_QUANT"),
        wire_quant_block=_env_int("BYTEPS_WIRE_QUANT_BLOCK", 64),
        wire_quant_min_bytes=_env_int("BYTEPS_WIRE_QUANT_MIN_BYTES", 1024),
        local_rank=_env_int("BYTEPS_LOCAL_RANK", 0),
        local_size=_env_int("BYTEPS_LOCAL_SIZE", 1),
        log_level=_env_str("BYTEPS_LOG_LEVEL", "WARNING").upper(),
        force_distributed=_env_bool("BYTEPS_FORCE_DISTRIBUTED"),
        enable_async=_env_bool("BYTEPS_ENABLE_ASYNC"),
        server_engine_threads=_env_int("BYTEPS_SERVER_ENGINE_THREAD", 4),
        compressor=_env_str("BYTEPS_COMPRESSOR", ""),
        compressor_k=_env_int("BYTEPS_COMPRESSOR_K", 0),
        error_feedback=_env_str("BYTEPS_ERROR_FEEDBACK", ""),
        momentum=_env_str("BYTEPS_MOMENTUM", ""),
        momentum_mu=float(os.environ.get("BYTEPS_MOMENTUM_MU", "0.9")),
        trace_on=_env_bool("BYTEPS_TRACE_ON"),
        trace_dir=_trace_dir_from_env(),
        trace_start_step=_env_int("BYTEPS_TRACE_START_STEP", 1),
        trace_end_step=_env_int("BYTEPS_TRACE_END_STEP", 10),
        trace_ring_events=_env_int("BYTEPS_TRACE_RING_EVENTS", 65536),
        flight_recorder=_env_bool("BYTEPS_FLIGHT_RECORDER", True),
        flight_recorder_events=_env_int("BYTEPS_FLIGHT_RECORDER_EVENTS",
                                        256),
        roundstats_on=_env_bool("BYTEPS_ROUNDSTATS_ON", True),
        roundstats_ring=_env_int("BYTEPS_ROUNDSTATS_RING", 256),
        roundstats_heartbeat_summary=_env_bool(
            "BYTEPS_ROUNDSTATS_HEARTBEAT_SUMMARY", True),
        events_on=_env_bool("BYTEPS_EVENTS_ON", True),
        events_ring=_env_int("BYTEPS_EVENTS_RING", 512),
        events_history=_env_int("BYTEPS_EVENTS_HISTORY", 128),
        monitor_on=_env_bool("BYTEPS_MONITOR_ON"),
        monitor_port=_env_int("BYTEPS_MONITOR_PORT", 9100),
        straggler_factor=float(
            os.environ.get("BYTEPS_STRAGGLER_FACTOR", "2.0")),
        retry_max=_env_int("BYTEPS_RETRY_MAX", 4),
        retry_timeout_ms=_env_int("BYTEPS_RETRY_TIMEOUT_MS", 1000),
        reconnect_max=_env_int("BYTEPS_RECONNECT_MAX", 3),
        reconnect_backoff_ms=_env_int("BYTEPS_RECONNECT_BACKOFF_MS", 100),
        recovery_timeout_ms=_env_int("BYTEPS_RECOVERY_TIMEOUT_MS", 60000),
        recover_rank=(int(os.environ["DMLC_RECOVER_RANK"])
                      if os.environ.get("DMLC_RECOVER_RANK") else None),
        sched_recovery_timeout_ms=_env_int(
            "BYTEPS_SCHED_RECOVERY_TIMEOUT_MS", 0),
        sched_recover=_env_bool("DMLC_SCHED_RECOVER"),
        elastic=_env_bool("BYTEPS_ELASTIC"),
        elastic_timeout_ms=_env_int("BYTEPS_ELASTIC_TIMEOUT_MS", 30000),
        join_fleet=_env_bool("DMLC_JOIN"),
        snapshot_retain=_env_int("BYTEPS_SNAPSHOT_RETAIN", 4),
        serving_weight=_env_int("BYTEPS_SERVING_WEIGHT", 1),
        replica_of=(int(os.environ["BYTEPS_REPLICA_OF"])
                    if os.environ.get("BYTEPS_REPLICA_OF") else None),
        snap_delta_max_bytes=_env_int("BYTEPS_SNAP_DELTA_MAX_BYTES",
                                      16 << 20),
        replica_poll_ms=_env_int("BYTEPS_REPLICA_POLL_MS", 200),
        replica_lag_rounds=_env_int("BYTEPS_REPLICA_LAG_ROUNDS", 8),
        tenant_id=(int(os.environ["BYTEPS_TENANT_ID"])
                   if os.environ.get("BYTEPS_TENANT_ID") else None),
        tenant_name=_env_str("BYTEPS_TENANT_NAME", ""),
        tenant_weight=_env_int("BYTEPS_TENANT_WEIGHT", 1),
        tenant_quantum_bytes=_env_int("BYTEPS_TENANT_QUANTUM_BYTES",
                                      65536),
        tenant_starve_ms=_env_int("BYTEPS_TENANT_STARVE_MS", 2000),
        server_engine_pace_mbps=_env_int("BYTEPS_SERVER_ENGINE_PACE_MBPS",
                                         0),
        ckpt_dir=_env_str("BYTEPS_CKPT_DIR", ""),
        ckpt_every=_env_int("BYTEPS_CKPT_EVERY", 1),
        ckpt_retain=_env_int("BYTEPS_CKPT_RETAIN", 2),
        ckpt_restore=_env_bool("BYTEPS_CKPT_RESTORE"),
        ckpt_lag_warn=_env_int("BYTEPS_CKPT_LAG_WARN", 8),
        chaos_ckpt=_env_str("BYTEPS_CHAOS_CKPT", ""),
        wire_crc=_env_bool("BYTEPS_WIRE_CRC"),
        wire_crc_quarantine=_env_int("BYTEPS_WIRE_CRC_QUARANTINE", 0),
        wire_crc_window_ms=_env_int("BYTEPS_WIRE_CRC_WINDOW_MS", 10000),
        chaos_seed=_env_int("BYTEPS_CHAOS_SEED", 0),
        chaos_drop=float(os.environ.get("BYTEPS_CHAOS_DROP", "0") or 0),
        chaos_dup=float(os.environ.get("BYTEPS_CHAOS_DUP", "0") or 0),
        chaos_corrupt=float(
            os.environ.get("BYTEPS_CHAOS_CORRUPT", "0") or 0),
        chaos_delay_us=_env_int("BYTEPS_CHAOS_DELAY_US", 0),
        chaos_reset_every=_env_int("BYTEPS_CHAOS_RESET_EVERY", 0),
        chaos_ctrl=_env_bool("BYTEPS_CHAOS_CTRL"),
        ici_axis=_env_str("BYTEPS_ICI_AXIS", "ici"),
        dcn_axis=_env_str("BYTEPS_DCN_AXIS", "dcn"),
        ps_mode=_env_str("BYTEPS_PS_MODE", "auto").lower(),
        heartbeat_interval_s=float(os.environ.get("PS_HEARTBEAT_INTERVAL", "5")),
        heartbeat_timeout_s=float(os.environ.get("PS_HEARTBEAT_TIMEOUT", "30")),
    ).validate()


_config: Optional[Config] = None


def get_config(reload: bool = False) -> Config:
    """Return the process-wide Config, loading from env on first use."""
    global _config
    if _config is None or reload:
        _config = load_config()
    return _config


def set_config(cfg: Config) -> None:
    """Install an explicit Config (used by tests and the launcher)."""
    global _config
    _config = cfg.validate()
