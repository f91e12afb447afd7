"""bpslaunch — multi-role process launcher.

Capability parity with the reference's ``launcher/launch.py`` (SURVEY.md
§2.6): one CLI, behavior switched on ``DMLC_ROLE``:

- ``scheduler`` / ``server`` → run the CPU parameter-server / scheduler
  loop (reference: exec ``python -c 'import byteps.server'``).
- ``worker`` → spawn worker process(es) running the user command with
  ``BYTEPS_LOCAL_RANK`` / ``BYTEPS_LOCAL_SIZE`` set, and reap them.

The code is the JAX package's launcher; the scheduler, server and
replica roles run ``byteps_tpu_torch.server``. Differences from the
reference:

- One worker process drives one GPU. The default is one worker process
  per host (``--workers-per-host 1``); ``--workers-per-host N`` spawns N
  with ``BYTEPS_LOCAL_RANK`` 0..N-1. In ``--local`` mode every worker is
  a host of its own (``BYTEPS_LOCAL_RANK=0``).
- ``--local N`` convenience mode brings up a full localhost fleet
  (scheduler + servers + N workers) in one command — the reference needs
  a shell script (tests/run_byteps_test.sh) for this.
- NUMA pinning: ``--numa`` prefixes workers with ``numactl --cpunodebind``
  round-robin, like the reference's numa wrapper.
"""

from __future__ import annotations

import argparse
import os
import shutil
import signal
import subprocess
import sys
from typing import Dict, List, Optional, Sequence


def _role_env(base: Dict[str, str], role: str, **extra: str) -> Dict[str, str]:
    env = dict(base)
    env["DMLC_ROLE"] = role
    env.update(extra)
    return env


def _numa_prefix(local_rank: int) -> List[str]:
    """Round-robin NUMA binding (reference: launch.py numactl wrapper)."""
    numactl = shutil.which("numactl")
    if not numactl:
        return []
    try:
        nodes = sorted(
            int(d[4:]) for d in os.listdir("/sys/devices/system/node")
            if d.startswith("node") and d[4:].isdigit())
    except OSError:
        return []
    if len(nodes) <= 1:
        return []
    node = nodes[local_rank % len(nodes)]
    return [numactl, f"--cpunodebind={node}", f"--membind={node}"]


def run_server_role(role: str) -> int:
    """Run the scheduler/server loop in-process; returns exit code."""
    os.environ["DMLC_ROLE"] = role
    from byteps_tpu_torch.server import main as server_main
    server_main()
    return 0


def spawn_workers(command: Sequence[str], workers_per_host: int,
                  env: Dict[str, str], numa: bool = False
                  ) -> List[subprocess.Popen]:
    procs = []
    for i in range(workers_per_host):
        e = _role_env(env, "worker",
                      BYTEPS_LOCAL_RANK=str(i),
                      BYTEPS_LOCAL_SIZE=str(workers_per_host))
        prefix = _numa_prefix(i) if numa else []
        procs.append(subprocess.Popen(prefix + list(command), env=e))
    return procs


_TERM_GRACE_S = 10.0


def _describe_exit(code: Optional[int]) -> str:
    """Human attribution for a child's exit: signal name when killed,
    plain code otherwise — post-mortems need to know WHICH role died and
    HOW, not just that 'the fleet failed'."""
    if code is not None and code < 0:
        try:
            signame = signal.Signals(-code).name
        except ValueError:
            signame = f"signal {-code}"
        return f"signal {-code} ({signame})"
    return f"exit code {code}"


def _reap(procs: List[subprocess.Popen], names: Optional[List[str]] = None,
          respawn=None, supervise: int = 0, poll_hook=None,
          worker_death=None) -> int:
    """Wait for all children; on first failure kill the rest.

    Mirrors the reference launcher's fail-fast behavior: a dead worker
    must take the job down, not hang it. Survivors get SIGTERM, then
    SIGKILL after a grace period, so a child that traps SIGTERM (e.g. a
    checkpoint-on-term training script) cannot wedge the launcher.

    --supervise mode: ``respawn(name)`` (when given) returns a fresh
    Popen for a dead SERVER or SCHEDULER role — hot replacement via
    DMLC_RECOVER_RANK, crash-restart via DMLC_SCHED_RECOVER — and up
    to ``supervise`` such respawns replace the fail-fast for those
    children. Deaths past the budget fail fast as before.

    --elastic mode hooks: ``poll_hook(remaining)`` runs every
    loop tick and returns newly spawned children to track (the SIGHUP
    scale protocol); ``worker_death(name, code)`` decides a dead
    WORKER's fate — ``"shrink"`` keeps the fleet running (the scheduler
    retires the rank via the elastic shrink path), ``(new_name, proc)``
    additionally respawns a fresh joiner, ``None`` falls through to the
    fail-fast. With both hooks absent the pre-elastic behavior is
    unchanged: any worker death takes the job down.
    """
    import time

    names = names or [f"proc{i}" for i in range(len(procs))]
    rc = 0
    budget = supervise
    term_deadline = None
    try:
        remaining = dict(zip(names, procs))
        while remaining:
            if term_deadline is not None and time.monotonic() > term_deadline:
                for q in remaining.values():
                    q.kill()
                term_deadline = None
            if poll_hook is not None and term_deadline is None:
                for nname, np_ in (poll_hook(remaining) or {}).items():
                    procs.append(np_)
                    remaining[nname] = np_
            for name in list(remaining):
                p = remaining[name]
                try:
                    code = p.wait(timeout=0.2)
                except subprocess.TimeoutExpired:
                    continue
                del remaining[name]
                if code != 0:
                    # Failure attribution BEFORE any restart decision:
                    # which role/rank died, its pid, and how.
                    print(f"bpslaunch: {name} (pid {p.pid}) died with "
                          f"{_describe_exit(code)}", file=sys.stderr,
                          flush=True)
                    if name.startswith("replica") and term_deadline is None:
                        # Read replicas are expendable by design
                        #: the scheduler scrubs the dead one
                        # from the roster, readers fail over to the next
                        # endpoint, and the training fleet never
                        # notices. Never fail-fast the job for one.
                        print(f"bpslaunch: {name} was a read replica — "
                              "readers fail over; fleet continues",
                              file=sys.stderr, flush=True)
                        continue
                    if (respawn is not None and term_deadline is None
                            and (name.startswith("server")
                                 or name == "scheduler") and budget > 0):
                        budget -= 1
                        fresh = respawn(name)
                        if fresh is not None:
                            kind = ("crash-restart"
                                    if name == "scheduler"
                                    else "hot replacement")
                            print(f"bpslaunch: respawning {name} as "
                                  f"{kind} (pid {fresh.pid}, "
                                  f"{budget} respawn(s) left)",
                                  file=sys.stderr, flush=True)
                            procs.append(fresh)
                            remaining[name] = fresh
                            continue
                    if (worker_death is not None and term_deadline is None
                            and name.startswith("worker")):
                        verdict = worker_death(name, code)
                        if verdict == "shrink":
                            print(f"bpslaunch: elastic shrink — fleet "
                                  f"continues without {name}",
                                  file=sys.stderr, flush=True)
                            continue
                        if verdict is not None:
                            new_name, fresh = verdict
                            print(f"bpslaunch: respawning a fresh "
                                  f"elastic joiner {new_name} "
                                  f"(pid {fresh.pid}) to replace {name}",
                                  file=sys.stderr, flush=True)
                            procs.append(fresh)
                            remaining[new_name] = fresh
                            continue
                    rc = rc or code
                    if remaining and term_deadline is None:
                        for q in remaining.values():
                            q.terminate()
                        term_deadline = time.monotonic() + _TERM_GRACE_S
    except KeyboardInterrupt:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
        deadline = time.monotonic() + _TERM_GRACE_S
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
        rc = 130
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rc


def _has_sealed_checkpoint(ckpt_dir: str) -> bool:
    """True when the spool holds at least one shard directory with a
    sealed MANIFEST. Presence is all the launcher checks — rejecting a
    torn or checksum-invalid spill is the restore scan's job, and a
    restore attempt over nothing-valid fail-stops with the shard named
    rather than cold-starting."""
    try:
        return any(n.startswith("ckpt_v")
                   and os.path.exists(os.path.join(ckpt_dir, n, "MANIFEST"))
                   for n in os.listdir(ckpt_dir))
    except OSError:
        return False


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch_local_fleet(command: Sequence[str], num_workers: int,
                       num_servers: int, port: int, env: Dict[str, str],
                       numa: bool = False, supervise: int = 0,
                       elastic: bool = False, scale_file: str = "",
                       num_replicas: int = 0) -> int:
    """Bring up scheduler + servers + workers on 127.0.0.1 in one call
    (the reference needs tests/run_byteps_test.sh for this topology).

    port=0 picks a free port; because another process can grab it between
    probe and bind, the scheduler launch is retried on fresh ports.
    """
    import time

    base = dict(env)
    base.update({
        "DMLC_PS_ROOT_URI": base.get("DMLC_PS_ROOT_URI", "127.0.0.1"),
        "DMLC_NUM_WORKER": str(num_workers),
        "DMLC_NUM_SERVER": str(num_servers),
        "BYTEPS_FORCE_DISTRIBUTED": "1",
    })
    if base.get("BYTEPS_MONITOR_ON", "").strip().lower() in (
            "1", "true", "yes", "on"):
        # Every role serves /metrics + /healthz on base_port + node_id
        # (byteps_tpu_torch.monitor); print the map so the operator can point
        # `python -m byteps_tpu_torch.monitor.top` (or curl) at the fleet.
        mport = int(base.get("BYTEPS_MONITOR_PORT", "9100") or 9100)
        from byteps_tpu_torch.monitor.top import fleet_endpoints
        eps = fleet_endpoints("127.0.0.1", mport, num_workers, num_servers)
        print("bpslaunch: monitor endpoints: "
              + " ".join(f"{n}=http://{e}" for n, e in sorted(eps.items())),
              file=sys.stderr)
    server_cmd = [sys.executable, "-m", "byteps_tpu_torch.server"]
    auto_port = port == 0
    for attempt in range(3):
        chosen = _free_port() if auto_port else port
        base["DMLC_PS_ROOT_PORT"] = str(chosen)
        sched = subprocess.Popen(server_cmd, env=_role_env(base, "scheduler"))
        # The scheduler binds immediately; if it lost the port race it dies
        # within this window and we retry on a fresh port.
        time.sleep(0.5)
        if sched.poll() is None or sched.returncode == 0:
            break
        if not auto_port or attempt == 2:
            print(f"bpslaunch: scheduler failed to start on port {chosen}",
                  file=sys.stderr)
            return sched.returncode or 1
    procs = [sched]
    names = ["scheduler"]
    for s in range(num_servers):
        # DMLC_WORKER_ID pins the server's RANK to its launch index
        # (the scheduler sorts registrations by preferred rank), so
        # --supervise can respawn "server s" with DMLC_RECOVER_RANK=s
        # and be certain it adopts the right shard.
        procs.append(
            subprocess.Popen(server_cmd,
                             env=_role_env(base, "server",
                                           DMLC_WORKER_ID=str(s))))
        names.append(f"server{s}")
    # Elastic scale protocol: SIGHUP makes the launcher read a
    # target worker count from the scale file — growth spawns fresh
    # JOINERS (DMLC_JOIN=1; the scheduler allocates never-reused ranks),
    # shrink touches the highest-index workers' retire files (each
    # worker's BYTEPS_RETIRE_FILE; training loops poll
    # ``byteps_tpu_torch.core.ffi.leave_requested()`` and leave gracefully).
    import tempfile

    state = {"hup": False, "next_idx": num_workers}
    retire_dir = ""
    if elastic:
        base["BYTEPS_ELASTIC"] = "1"
        retire_dir = tempfile.mkdtemp(prefix="bps_retire_")
        if not scale_file:
            scale_file = os.path.join(retire_dir, "bps_scale")
        signal.signal(signal.SIGHUP,
                      lambda signum, frame: state.update(hup=True))
        print(f"bpslaunch: elastic fleet — write a target worker count "
              f"to {scale_file} and send SIGHUP to pid {os.getpid()} to "
              f"grow/shrink", file=sys.stderr, flush=True)

    def _spawn_worker(idx: int, join: bool) -> subprocess.Popen:
        extra = {"DMLC_WORKER_ID": str(idx),
                 "BYTEPS_LOCAL_RANK": "0",
                 "BYTEPS_LOCAL_SIZE": "1"}
        if retire_dir:
            extra["BYTEPS_RETIRE_FILE"] = os.path.join(
                retire_dir, f"retire.worker{idx}")
        if join:
            extra["DMLC_JOIN"] = "1"
        e = _role_env(base, "worker", **extra)
        prefix = _numa_prefix(idx) if numa else []
        return subprocess.Popen(prefix + list(command), env=e)

    # Versioned snapshot serving: read replicas shadow the
    # servers round-robin. Each gets a PINNED listen port so inference
    # readers have stable endpoints to fail over across; the combined
    # list is printed (and exported as BYTEPS_SNAP_ENDPOINTS to the
    # worker command, spawned below) in byteps_tpu_torch.client.pull_snapshot
    # format. Spawn order doesn't matter for correctness — the scheduler
    # buffers replica registrations until fleet formation commits.
    if num_replicas > 0:
        snap_eps = []
        for r in range(num_replicas):
            rport = _free_port()
            procs.append(subprocess.Popen(
                server_cmd,
                env=_role_env(base, "replica",
                              BYTEPS_REPLICA_OF=str(r % max(num_servers, 1)),
                              BYTEPS_LISTEN_PORT=str(rport))))
            names.append(f"replica{r}")
            snap_eps.append(f"127.0.0.1:{rport}")
        base["BYTEPS_SNAP_ENDPOINTS"] = ",".join(snap_eps)
        print(f"bpslaunch: snapshot endpoints (read replicas): "
              f"{base['BYTEPS_SNAP_ENDPOINTS']}", file=sys.stderr,
              flush=True)
    for w in range(num_workers):
        procs.append(_spawn_worker(w, join=False))
        names.append(f"worker{w}")
    # Pid map for operators (and the recovery tests): supervision and
    # post-mortems need to know which pid is which role.
    for name, p in zip(names, procs):
        print(f"bpslaunch: spawned {name} pid={p.pid}", file=sys.stderr,
              flush=True)

    sched_respawns = {"count": 0}

    def _respawn_server(name: str) -> Optional[subprocess.Popen]:
        # Hot replacement: respawn ONLY the dead control-plane role.
        # A server comes back with DMLC_RECOVER_RANK so it adopts the
        # dead rank's id and key shard instead of joining formation; a
        # scheduler comes back with DMLC_SCHED_RECOVER so it rebuilds
        # its address book / rank allocator / tenant rosters from the
        # fleet's re-registrations (the port is pinned in base, so
        # parked nodes re-dial the same endpoint).
        if name == "scheduler":
            if (base.get("BYTEPS_SCHED_RECOVERY_TIMEOUT_MS", "0")
                    or "0").strip() in ("", "0"):
                print("bpslaunch: scheduler died but "
                      "BYTEPS_SCHED_RECOVERY_TIMEOUT_MS is unset/0 — "
                      "the fleet cannot re-register; failing fast",
                      file=sys.stderr, flush=True)
                return None
            # Capped backoff between scheduler respawns: the pinned
            # port may still be in TIME_WAIT, and a crash-looping
            # scheduler must not burn the whole budget in a second.
            delay = min(0.2 * (2 ** sched_respawns["count"]), 5.0)
            sched_respawns["count"] += 1
            time.sleep(delay)
            e = _role_env(base, "scheduler", DMLC_SCHED_RECOVER="1")
            return subprocess.Popen(server_cmd, env=e)
        rank = int(name[len("server"):])
        e = _role_env(base, "server", DMLC_RECOVER_RANK=str(rank))
        return subprocess.Popen(server_cmd, env=e)

    def _scale_hook(remaining):
        # Runs on every reap tick; acts only after a SIGHUP.
        if not state["hup"]:
            return {}
        state["hup"] = False
        try:
            with open(scale_file) as f:
                target = int(f.read().strip() or "0")
        except (OSError, ValueError) as exc:
            print(f"bpslaunch: SIGHUP but no usable scale file "
                  f"{scale_file}: {exc}", file=sys.stderr, flush=True)
            return {}
        live = sorted(n for n in remaining if n.startswith("worker"))
        new = {}
        if target > len(live):
            for _ in range(target - len(live)):
                idx = state["next_idx"]
                state["next_idx"] += 1
                p2 = _spawn_worker(idx, join=True)
                print(f"bpslaunch: elastic grow — spawned worker{idx} "
                      f"pid={p2.pid} as joiner", file=sys.stderr,
                      flush=True)
                new[f"worker{idx}"] = p2
        elif target < len(live) and target >= 1:
            for name in list(reversed(live))[:len(live) - target]:
                path = os.path.join(retire_dir, f"retire.{name}")
                with open(path, "w") as f:
                    f.write("retire\n")
                print(f"bpslaunch: elastic shrink — asked {name} to "
                      f"retire ({path})", file=sys.stderr, flush=True)
        return new

    worker_budget = {"left": supervise}

    def _worker_death(name: str, code: int):
        # The scheduler retires the dead rank via the elastic shrink
        # path either way; with --supervise budget left, additionally
        # replace the capacity with a fresh joiner (never the old rank —
        # worker ranks are allocated once and never reused).
        if worker_budget["left"] > 0:
            worker_budget["left"] -= 1
            idx = state["next_idx"]
            state["next_idx"] += 1
            return (f"worker{idx}", _spawn_worker(idx, join=True))
        return "shrink"

    return _reap(procs, names, respawn=_respawn_server if supervise else None,
                 supervise=supervise,
                 poll_hook=_scale_hook if elastic else None,
                 worker_death=_worker_death if elastic else None)


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="bpslaunch",
        description="byteps_tpu_torch multi-role launcher (role from DMLC_ROLE; "
                    "see docs/env.md)")
    p.add_argument("--local", type=int, metavar="N", default=0,
                   help="localhost fleet mode: launch scheduler + servers + "
                        "N workers on 127.0.0.1")
    p.add_argument("--num-servers", type=int, default=1,
                   help="servers for --local mode (default 1)")
    p.add_argument("--port", type=int, default=0,
                   help="scheduler port for --local mode (default: free port)")
    p.add_argument("--replicas", type=int, metavar="N", default=0,
                   help="--local mode: spawn N read-only snapshot "
                        "replicas (DMLC_ROLE=replica, docs/serving.md) "
                        "shadowing the servers round-robin; their pinned "
                        "reader endpoints are printed and exported to "
                        "workers as BYTEPS_SNAP_ENDPOINTS for "
                        "byteps_tpu_torch.client.pull_snapshot. A dead replica "
                        "costs readers one failover and the fleet "
                        "nothing (it never fail-fasts the job)")
    p.add_argument("--workers-per-host", type=int,
                   default=int(os.environ.get("BYTEPS_LOCAL_SIZE", "1") or 1),
                   help="worker processes to spawn on this host (TPU default "
                        "1: one controller drives all local chips)")
    p.add_argument("--numa", action="store_true",
                   help="bind worker processes round-robin across NUMA nodes")
    p.add_argument("--monitor-port", type=int, metavar="BASE", default=0,
                   help="enable live monitoring (BYTEPS_MONITOR_ON=1): "
                        "every role serves /metrics + /healthz on "
                        "BASE + its node id; scrape with "
                        "`python -m byteps_tpu_torch.monitor.top`")
    p.add_argument("--fusion-bytes", type=int, metavar="N", default=-1,
                   help="small-tensor fusion threshold for the whole "
                        "fleet (BYTEPS_FUSION_BYTES): partitions under N "
                        "raw bytes coalesce into multi-key wire frames; "
                        "0 disables fusion (default: inherit env, 65536)")
    p.add_argument("--wire-quant", action="store_true",
                   help="arm the block-quantized wire for the whole "
                        "fleet (BYTEPS_WIRE_QUANT=1): codec-less "
                        "float32 partitions ship as per-block int8 with "
                        "worker-side error feedback, ~3.8x fewer wire "
                        "bytes each way (docs/performance.md 'Quantized "
                        "wire'); tune with BYTEPS_WIRE_QUANT_BLOCK / "
                        "BYTEPS_WIRE_QUANT_MIN_BYTES")
    p.add_argument("--no-roundstats", action="store_true",
                   help="disable the default-on per-round introspection "
                        "layer (BYTEPS_ROUNDSTATS_ON=0): no per-round "
                        "stage summaries, no heartbeat-piggybacked fleet "
                        "round table, no live bottleneck attribution "
                        "(`python -m byteps_tpu_torch.monitor.insight`); each "
                        "instrumentation site reduces to one relaxed "
                        "atomic load (docs/monitoring.md 'Round insight')")
    p.add_argument("--trace-dir", metavar="DIR", default="",
                   help="arm fleet-wide distributed tracing "
                        "(BYTEPS_TRACE_ON=1, BYTEPS_TRACE_DIR=DIR): "
                        "every role — scheduler, servers, workers — "
                        "leaves a clock-aligned per-rank dump in DIR at "
                        "shutdown; merge with `python -m "
                        "byteps_tpu_torch.monitor.timeline merge --dir DIR` "
                        "(docs/timeline.md). Flight-recorder auto-dumps "
                        "land in the same directory")
    p.add_argument("--elastic", action="store_true",
                   help="arm elastic worker membership for the whole "
                        "fleet (BYTEPS_ELASTIC=1, docs/elasticity.md): "
                        "workers can join (DMLC_JOIN), leave "
                        "gracefully, and a dead worker shrinks the "
                        "fleet to N-1 (scheduler-coordinated rollback) "
                        "instead of fail-stopping. In --local mode, "
                        "SIGHUP + the scale file grow/shrink the fleet "
                        "at runtime, and a dead worker is retired via "
                        "the shrink path (with --supervise N, a fresh "
                        "joiner replaces the capacity)")
    p.add_argument("--tenant", type=int, metavar="ID", default=None,
                   help="register this job under tenant ID "
                        "(BYTEPS_TENANT_ID, docs/multitenancy.md): its "
                        "keys are (tenant, key)-namespaced server-side "
                        "and its traffic rides the weighted-fair engine "
                        "dispatch; unset keeps the single-tenant wire "
                        "byte for byte")
    p.add_argument("--tenant-weight", type=int, metavar="W", default=1,
                   help="this tenant's fair-share weight "
                        "(BYTEPS_TENANT_WEIGHT): backlogged tenants' "
                        "served bytes converge to the weight ratio")
    p.add_argument("--tenant-name", metavar="NAME", default="",
                   help="display name for /tenants and monitor.top "
                        "(BYTEPS_TENANT_NAME; never on the wire)")
    p.add_argument("--scale-file", metavar="PATH", default="",
                   help="--local --elastic mode: file holding the "
                        "target worker count, read on SIGHUP (default: "
                        "a temp path printed at startup)")
    p.add_argument("--supervise", type=int, metavar="N", default=0,
                   help="--local mode: per-child supervision — respawn a "
                        "dead SERVER role (up to N times total) as a hot "
                        "replacement with DMLC_RECOVER_RANK set, instead "
                        "of failing the whole fleet; the scheduler "
                        "coordinates the epoch pause + shard re-seed "
                        "(requires BYTEPS_RECOVERY_TIMEOUT_MS > 0, the "
                        "default). A dead SCHEDULER is respawned too "
                        "when BYTEPS_SCHED_RECOVERY_TIMEOUT_MS > 0: the "
                        "restart carries DMLC_SCHED_RECOVER=1 and "
                        "rebuilds control-plane state from the parked "
                        "fleet's re-registrations. Worker deaths still "
                        "fail fast (pair with --elastic or --restarts "
                        "for those)")
    p.add_argument("--ckpt-dir", metavar="DIR", default="",
                   help="arm durable checkpoints for the whole fleet "
                        "(BYTEPS_CKPT_DIR, docs/checkpoint.md): every "
                        "server spills each BYTEPS_CKPT_EVERY-th "
                        "committed snapshot version to DIR as CRC32C-"
                        "checksummed chunks sealed by a manifest, off "
                        "the training path. Pair with --restarts N for "
                        "full-fleet-loss recovery: a relaunch after a "
                        "failed run escalates to BYTEPS_CKPT_RESTORE=1 "
                        "automatically once DIR holds a sealed "
                        "checkpoint, so the fleet resumes from the last "
                        "durable cut instead of cold-starting")
    p.add_argument("--ckpt-every", type=int, metavar="N", default=0,
                   help="spill every Nth committed snapshot version "
                        "(BYTEPS_CKPT_EVERY; default inherit env, 1)")
    p.add_argument("--restore", action="store_true",
                   help="start the fleet in coordinated restore mode "
                        "(BYTEPS_CKPT_RESTORE=1): servers scan their "
                        "--ckpt-dir shards, the scheduler commits a "
                        "restore epoch at the minimum checksum-valid "
                        "version common to every shard, and workers "
                        "resume from the round after it — or the fleet "
                        "fail-stops with the missing shard named. "
                        "Requires --ckpt-dir (or BYTEPS_CKPT_DIR)")
    p.add_argument("--restarts", type=int, default=0,
                   help="--local mode: relaunch the whole fleet up to N "
                        "times after a failed run (elastic-ish recovery: "
                        "with --ckpt-dir the relaunch restores from the "
                        "last sealed checkpoint; otherwise pair the "
                        "training script with its own checkpoint/resume "
                        "so restarts continue from the last step)")
    p.add_argument("--restart-backoff", type=float, metavar="SECONDS",
                   default=1.0,
                   help="base delay before each --restarts relaunch, "
                        "doubled per consecutive failed attempt (capped "
                        "at 30 s): a crash-looping fleet must not hammer "
                        "ports/scheduler at full speed (default 1.0)")
    p.add_argument("--chaos", metavar="SPEC", default="",
                   help="arm the deterministic fault-injection layer for "
                        "the whole fleet: comma-separated knobs "
                        "drop=P,dup=P,delay-us=N,reset-every=N,seed=N,"
                        "ctrl=1 (sets BYTEPS_CHAOS_*; e.g. --chaos "
                        "drop=0.01,reset-every=1000,seed=42). ctrl=1 "
                        "extends injection to CONTROL-plane frames and "
                        "requires scheduler fail-over armed "
                        "(BYTEPS_SCHED_RECOVERY_TIMEOUT_MS > 0). "
                        "Requires the retry layer (BYTEPS_RETRY_MAX > "
                        "0, the default); see docs/troubleshooting.md")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="worker command, e.g. python train.py")
    args = p.parse_args(argv)
    command = list(args.command)
    if command and command[0] == "--":
        command = command[1:]
    if args.monitor_port:
        os.environ["BYTEPS_MONITOR_ON"] = "1"
        os.environ["BYTEPS_MONITOR_PORT"] = str(args.monitor_port)
    if args.trace_dir:
        os.environ["BYTEPS_TRACE_ON"] = "1"
        os.environ["BYTEPS_TRACE_DIR"] = args.trace_dir
        print(f"bpslaunch: fleet tracing on — per-rank dumps land in "
              f"{args.trace_dir}; merge with `python -m "
              f"byteps_tpu_torch.monitor.timeline merge --dir "
              f"{args.trace_dir}`", file=sys.stderr)
    if args.fusion_bytes >= 0:
        os.environ["BYTEPS_FUSION_BYTES"] = str(args.fusion_bytes)
    if args.wire_quant:
        os.environ["BYTEPS_WIRE_QUANT"] = "1"
    if args.no_roundstats:
        os.environ["BYTEPS_ROUNDSTATS_ON"] = "0"
    if args.elastic:
        os.environ["BYTEPS_ELASTIC"] = "1"
    if args.ckpt_dir:
        os.environ["BYTEPS_CKPT_DIR"] = args.ckpt_dir
    if args.ckpt_every > 0:
        os.environ["BYTEPS_CKPT_EVERY"] = str(args.ckpt_every)
    if args.restore:
        if not os.environ.get("BYTEPS_CKPT_DIR", ""):
            p.error("--restore requires --ckpt-dir (or BYTEPS_CKPT_DIR)")
        os.environ["BYTEPS_CKPT_RESTORE"] = "1"
    if args.tenant is not None:
        # Multi-tenant PS: one launcher invocation = one job
        # = one tenant; every role it spawns carries the id, and
        # workers register the weight with the scheduler. Leaving
        # --tenant off keeps the single-tenant wire byte for byte.
        os.environ["BYTEPS_TENANT_ID"] = str(args.tenant)
        os.environ["BYTEPS_TENANT_WEIGHT"] = str(args.tenant_weight)
        if args.tenant_name:
            os.environ["BYTEPS_TENANT_NAME"] = args.tenant_name
    if args.chaos:
        chaos_envs = {"drop": "BYTEPS_CHAOS_DROP",
                      "dup": "BYTEPS_CHAOS_DUP",
                      "delay-us": "BYTEPS_CHAOS_DELAY_US",
                      "reset-every": "BYTEPS_CHAOS_RESET_EVERY",
                      "seed": "BYTEPS_CHAOS_SEED",
                      "ctrl": "BYTEPS_CHAOS_CTRL"}
        for item in args.chaos.split(","):
            key, sep, val = item.partition("=")
            key = key.strip().lower()
            if not sep or key not in chaos_envs:
                p.error(f"--chaos: unknown knob {item!r} (expected "
                        f"{'/'.join(sorted(chaos_envs))}=value)")
            os.environ[chaos_envs[key]] = val.strip()

    if args.local:
        if not command:
            p.error("--local requires a worker command")
        import time

        rc = launch_local_fleet(command, args.local, args.num_servers,
                                args.port, dict(os.environ), numa=args.numa,
                                supervise=args.supervise,
                                elastic=args.elastic,
                                scale_file=args.scale_file,
                                num_replicas=args.replicas)
        for attempt in range(args.restarts):
            if rc == 0:
                break
            # Capped exponential backoff between relaunches: a
            # crash-looping fleet (bad config, dead dependency) must not
            # hammer the scheduler port / cluster manager at full speed,
            # and TIME_WAIT sockets from the failed fleet get a chance
            # to clear.
            delay = min(args.restart_backoff * (2 ** attempt), 30.0)
            print(f"bpslaunch: fleet failed (exit {rc}); restart "
                  f"{attempt + 1}/{args.restarts} in {delay:.1f}s",
                  file=sys.stderr)
            if delay > 0:
                time.sleep(delay)
            # Durable-checkpoint escalation: a dead fleet
            # that was spilling checkpoints relaunches in restore mode,
            # so the restart resumes from the last sealed cut instead of
            # cold-starting from step 0 over the same spool.
            ckpt_dir = os.environ.get("BYTEPS_CKPT_DIR", "")
            if (ckpt_dir and _has_sealed_checkpoint(ckpt_dir)
                    and not os.environ.get("BYTEPS_CKPT_RESTORE")):
                os.environ["BYTEPS_CKPT_RESTORE"] = "1"
                print(f"bpslaunch: sealed checkpoint(s) found in "
                      f"{ckpt_dir} — escalating the relaunch to "
                      f"BYTEPS_CKPT_RESTORE=1 (resume from the last "
                      f"durable cut)", file=sys.stderr, flush=True)
            rc = launch_local_fleet(command, args.local, args.num_servers,
                                    args.port, dict(os.environ),
                                    numa=args.numa,
                                    supervise=args.supervise,
                                    elastic=args.elastic,
                                    scale_file=args.scale_file,
                                    num_replicas=args.replicas)
        return rc

    role = os.environ.get("DMLC_ROLE", "worker").lower()
    if role in ("scheduler", "server", "replica"):
        return run_server_role(role)
    if role != "worker":
        p.error(f"DMLC_ROLE must be scheduler|server|replica|worker, "
                f"got {role!r}")
    if not command:
        p.error("worker role requires a command")
    procs = spawn_workers(command, args.workers_per_host, dict(os.environ),
                          numa=args.numa)
    return _reap(procs, [f"worker/{i}" for i in range(len(procs))])


if __name__ == "__main__":
    sys.exit(main())
