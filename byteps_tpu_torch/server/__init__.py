"""Parameter-server / scheduler process entry.

Capability parity: reference byteps/server/__init__.py (SURVEY.md §2.3) —
there, ``import byteps.server`` blocks in the server loop as an import
side-effect. We keep the same capability behind an explicit entry point
(``python -m byteps_tpu_torch.server``; role from DMLC_ROLE) — import
side-effects that block are hostile to tooling, so main() is a function.
"""

from __future__ import annotations

import os
import sys


def main() -> None:
    role = os.environ.get("DMLC_ROLE", "server").lower()
    recover_rank = os.environ.get("DMLC_RECOVER_RANK", "")
    if recover_rank and role == "server":
        # Hot replacement: this incarnation adopts a dead
        # server rank's id + key shard. Start() registers with the
        # recovery marker; the scheduler answers with a direct ADDRBOOK
        # and broadcasts the epoch RESUME, and the workers re-seed us.
        print(f"byteps_tpu_torch.server: starting as hot replacement for "
              f"server rank {recover_rank}", file=sys.stderr, flush=True)
    sched_recover = os.environ.get("DMLC_SCHED_RECOVER", "")
    if sched_recover and role == "scheduler":
        # Scheduler fail-over: this incarnation is a
        # crash-restart of the control plane. Start() listens on the
        # same pinned port and rebuilds the address book / rank
        # allocator / tenant rosters from the parked fleet's
        # CMD_REREGISTER quorum instead of running fleet formation; a
        # failed rebuild (conflict / window expiry) aborts nonzero so
        # the supervisor can attribute the death.
        print("byteps_tpu_torch.server: starting as scheduler crash-restart "
              "(DMLC_SCHED_RECOVER) — waiting for the fleet's "
              "re-registration quorum", file=sys.stderr, flush=True)
    if (os.environ.get("BYTEPS_CKPT_RESTORE", "")
            and role in ("scheduler", "server")):
        # Durable restore: this fleet resumes from disk. A
        # server scans its BYTEPS_CKPT_DIR shard for the newest
        # checksum-valid version and registers it; the scheduler commits
        # a restore epoch at the minimum version common to EVERY shard —
        # or refuses to start if any shard has nothing valid (a named
        # fail-stop, never a silent cold start).
        print(f"byteps_tpu_torch.server: {role} starting in checkpoint-restore "
              f"mode (BYTEPS_CKPT_RESTORE, dir "
              f"{os.environ.get('BYTEPS_CKPT_DIR', '?')})",
              file=sys.stderr, flush=True)
    replica_of = os.environ.get("BYTEPS_REPLICA_OF", "")
    if role == "replica":
        # Versioned snapshot serving: a read-only replica.
        # Registers with the scheduler for a fresh elastic rank, shadows
        # server rank BYTEPS_REPLICA_OF via the snapshot delta protocol,
        # and serves CMD_SNAP_PULL reads. Its death costs readers one
        # failover and the training fleet nothing.
        print(f"byteps_tpu_torch.server: starting as read replica of server "
              f"rank {replica_of or 0} (snapshot serving)",
              file=sys.stderr, flush=True)
    from byteps_tpu_torch.core import Replica, Scheduler, Server
    if role == "scheduler":
        node = Scheduler.start()
    elif role == "server":
        node = Server.start()
    elif role == "replica":
        node = Replica.start()
    else:
        raise SystemExit(
            f"DMLC_ROLE must be scheduler|server|replica, got {role!r}")
    # BYTEPS_MONITOR_ON=1 gave this node a /metrics + /healthz endpoint
    # (byteps_tpu_torch.monitor, started inside Node.start); announce it so
    # operators and monitor.top know where to scrape this role.
    if node._monitor is not None:
        print(f"byteps_tpu_torch.server: {role} monitor endpoint on "
              f":{node._monitor.port} (/metrics, /healthz)",
              file=sys.stderr, flush=True)
    # Start() returns once the topology is up; shutdown() blocks until the
    # scheduler broadcasts fleet shutdown (worker goodbyes all received).
    node.shutdown()
    if recover_rank and role == "server":
        # A replacement incarnation ran a recovery: none of the
        # automatic flight-dump triggers (EPOCH_PAUSE/RESUME land on the
        # OTHER ranks) fire here, so leave the re-seed trail — parked
        # ops, RESEEDs, grace events — at clean exit.
        try:
            node.dump_flight()
        except Exception:
            pass
    # A FAILURE-triggered shutdown (dead-node broadcast / lost scheduler
    # connection) exits nonzero so a supervisor can tell crash from
    # completion. The scheduler itself stays 0 — detecting and
    # broadcasting a failure IS its job done correctly (and the restart
    # loop keys off the workers' exit codes).
    if role == "server" and node.failure_shutdown():
        print("byteps_tpu_torch.server: failure shutdown (a node died); "
              "exiting nonzero", file=sys.stderr, flush=True)
        raise SystemExit(2)
