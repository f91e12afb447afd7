// Node registry, id assignment, barriers, heartbeats.
//
// Capability parity: reference ps-lite Postoffice (SURVEY.md §2.4):
// scheduler/server/worker role management, node registration handshake,
// group barriers, env-driven addressing (DMLC_PS_ROOT_URI/PORT,
// DMLC_NUM_WORKER, DMLC_NUM_SERVER), heartbeat-based failure detection
// (PS_HEARTBEAT_INTERVAL / PS_HEARTBEAT_TIMEOUT).
#pragma once

#include <atomic>
#include <condition_variable>
#include <deque>
#include <functional>
#include <map>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "common.h"
#include "schedrec.h"
#include "van.h"

namespace bps {

// Barrier groups (bitmask)
enum BarrierGroup : int {
  GROUP_SERVERS = 1,
  GROUP_WORKERS = 2,
  GROUP_ALL = 3,
};

class Postoffice {
 public:
  // App-level handler for data-plane messages (PUSH/PULL/...); control-plane
  // (register/barrier/heartbeat) is consumed internally.
  using AppHandler = std::function<void(Message&&, int fd)>;

  Postoffice() = default;
  ~Postoffice() { Finalize(); }

  // Start the node: scheduler binds the root port and waits for everyone;
  // servers/workers register with the scheduler and receive the address
  // book; workers additionally dial every server. Blocks until the topology
  // is fully connected. Returns this node's assigned id.
  int Start(Role role, const std::string& root_uri, int root_port,
            int num_workers, int num_servers, AppHandler app_handler);

  // Block until every member of `group` reached the barrier.
  void Barrier(int group);

  void Finalize();  // graceful: scheduler broadcasts SHUTDOWN

  // Invoked (on a van thread) when a fleet-wide SHUTDOWN arrives at a
  // non-scheduler node — lets the KV layer fail fast on in-flight work
  // instead of hanging when a peer died (failure detection, SURVEY.md §5).
  void SetShutdownCallback(std::function<void()> cb) {
    shutdown_cb_ = std::move(cb);
  }

  // Invoked (on a van thread) when the connection to a known peer node
  // drops while the fleet is running — the fast-fail signal for that
  // node's in-flight requests (heartbeat timeout is the slow fallback).
  // With the retry layer on (BYTEPS_RETRY_MAX > 0) this only fires after
  // reconnect-with-backoff exhausted its attempts: a transient reset is
  // absorbed in-band, only a persistent fault escalates.
  void SetPeerLostCallback(std::function<void(int node_id)> cb) {
    peer_lost_cb_ = std::move(cb);
  }

  // Invoked (on a van thread) after a lost worker->server connection was
  // re-established (transient fault absorbed): the KV layer resends that
  // node's in-flight requests over the fresh connection immediately
  // instead of waiting out their retry timeouts.
  void SetPeerReconnectedCallback(std::function<void(int node_id)> cb) {
    peer_reconnected_cb_ = std::move(cb);
  }

  // Hot server replacement. Paused: a server rank is presumed
  // dead and under scheduler-coordinated recovery — the KV layer freezes
  // that rank's retry clocks (requests park in the resend queue instead
  // of escalating). Recovered: a replacement adopted the rank and this
  // worker's connection was redialled — the worker re-seeds the shard
  // and drains the parked queue. Both run on van recv threads.
  void SetPeerPausedCallback(std::function<void(int node_id)> cb) {
    peer_paused_cb_ = std::move(cb);
  }
  void SetPeerRecoveredCallback(std::function<void(int node_id)> cb) {
    peer_recovered_cb_ = std::move(cb);
  }

  // Elastic worker membership. Pause: a JOIN-kind
  // CMD_FLEET_PAUSE arrived — the worker gates new rounds and answers
  // with its round counters (the KV layer's in-flight rounds complete
  // against the OLD roster, so no drain wait). Resume: the change is
  // committed — sync counters (join) and lift the gate. Resize (server
  // role): update the roster history; a removal additionally rolls the
  // in-flight rounds back. All run on van recv threads.
  void SetFleetPauseCallback(std::function<void(int kind)> cb) {
    fleet_pause_cb_ = std::move(cb);
  }
  void SetFleetResumeCallback(
      std::function<void(int kind, int affected, int64_t join_round,
                         int64_t join_bcast)> cb) {
    fleet_resume_cb_ = std::move(cb);
  }
  // Server-side resize additionally carries the affected node's TENANT
  //: rounds are per-tenant counters, so the roster epoch a
  // join/removal creates must land in that tenant's history only.
  void SetFleetResizeCallback(
      std::function<void(int kind, int affected, int64_t join_round,
                         int64_t join_bcast, int tenant)> cb) {
    fleet_resize_cb_ = std::move(cb);
  }

  // Scheduler fail-over. Invoked (on the heartbeat thread)
  // after a scheduler-lost park ended in a successful recovery — the
  // worker layer clears any stale round gate a pre-crash FLEET_PAUSE
  // left armed (its commit may have died with the old scheduler).
  void SetSchedRecoveredCallback(std::function<void()> cb) {
    sched_recovered_cb_ = std::move(cb);
  }
  // Provider for the rounds-completed watermark a CMD_REREGISTER
  // carries (workers: the KV layer's max issued round; others 0).
  void SetRoundWatermarkProvider(std::function<int64_t()> fn) {
    round_watermark_fn_ = std::move(fn);
  }
  // True while this node is parked on a lost scheduler connection
  // (fail-over armed): the KV retry layer defers its exhaustion
  // escalation — with the control plane down there is nobody to
  // coordinate a fail-stop, and the park owns the deadline.
  bool SchedLost() const { return sched_lost_.load(); }

  // Worker: gated-round counters -> scheduler (join drain-free ack).
  void SendFleetPauseAck(int64_t max_round, int64_t max_bcast);

  // Worker: graceful leave. Sends CMD_LEAVE_REQUEST (the caller must
  // have drained its handles first) and waits for the scheduler's
  // CMD_LEAVE_ACK. After a true return, Finalize skips the goodbye —
  // this rank no longer counts toward the fleet's shutdown quorum.
  bool RequestLeave();

  // Joiner: the round boundary this rank enters at (from the direct
  // ADDRBOOK's arg1; 0 on ordinary formation).
  int64_t join_round() const { return join_round_.load(); }
  int64_t join_bcast_round() const { return join_bcast_.load(); }

  // Durable checkpoints. A restore-armed server reports its
  // newest checksum-valid checkpoint version before Start (set by the
  // c_api glue from the server's scan; -1 = armed but nothing valid on
  // disk — the scheduler fail-stops on it by contract). The scheduler
  // commits a fleet-wide restore epoch at the minimum common version
  // across all server shards and broadcasts it in CMD_ADDRBOOK; every
  // node reads it back here (-1 = no restore this formation). Workers
  // jump their round counters to restore_round()+1; servers install
  // the checkpoint cut at exactly restore_round().
  void SetDurableCkpt(int64_t newest) {
    durable_armed_ = true;
    durable_ckpt_ = newest;
  }
  int64_t restore_round() const { return restore_round_.load(); }
  // Engine threads may race a fast worker's INIT_KEY against our own
  // ADDRBOOK receipt: block until the book (and with it the committed
  // restore epoch) arrived.
  int64_t WaitRestoreRound();

  // Current membership epoch (bumped by the scheduler per recovery) and
  // whether any rank is mid-recovery from this node's point of view.
  int64_t epoch() const { return epoch_.load(); }
  bool Recovering() const { return recovering_count_.load() > 0; }

  // True once this node received (or itself triggered) a FAILURE
  // shutdown — the scheduler's dead-node broadcast (CMD_SHUTDOWN
  // arg0=1) or a lost scheduler connection — as opposed to the clean
  // all-workers-said-goodbye teardown. Server/scheduler entry points
  // exit nonzero on it so a supervisor can tell crash from completion.
  bool FailureShutdown() const { return failure_shutdown_.load(); }

  // --- topology queries ---
  int my_id() const { return my_id_; }
  Role role() const { return role_; }
  // LIVE fleet size: elastic joins/leaves/shrinks update it mid-run
  // (CMD_FLEET_RESUME recounts it from the re-issued address book).
  int num_workers() const { return num_workers_.load(); }
  int num_servers() const { return num_servers_; }
  // node ids: scheduler 0, servers 1..S, workers S+1..S+W
  static int ServerId(int s) { return 1 + s; }
  int WorkerId(int w) const { return 1 + num_servers_ + w; }
  int my_worker_rank() const { return my_id_ - 1 - num_servers_; }
  // fd of the connection to a node (workers: scheduler + all servers).
  int FdOf(int node_id);
  // Striped variant (BYTEPS_VAN_STREAMS): the stream for `key`, chosen by
  // key hash so one key's traffic — and therefore its request ordering —
  // stays on one TCP connection. Falls back to the primary fd when no
  // extra stripes were dialed (control paths always use FdOf(node)).
  int FdOf(int node_id, int64_t key);

  Van& van() { return *van_; }
  bool ShuttingDown() const { return shutting_down_.load(); }
  // Clock alignment vs the scheduler (tracing): estimated from
  // the heartbeat echo (CMD_HEARTBEAT_ACK) with the minimum-RTT sample
  // kept — t_scheduler ~= t_local + ClockOffsetUs(). The scheduler's
  // own offset is 0; rtt -1 = no estimate yet (heartbeats disabled, or
  // none answered). Recorded in every trace dump's metadata so the
  // fleet merge (monitor.timeline) aligns per-rank clocks.
  int64_t ClockOffsetUs() const { return clock_offset_us_.load(); }
  int64_t ClockRttUs() const { return clock_rtt_us_.load(); }
  // --- multi-tenant roster, derived from the address book ---
  // Worker ids serving tenant `tenant`. Tenant registration rides
  // NodeInfo (CMD_REGISTER / CMD_JOIN_REQUEST payloads) and is
  // re-broadcast with every address book, so the roster is live across
  // elastic membership changes with no extra control traffic. Empty
  // when the book has not arrived yet (callers fall back to the
  // formation fleet size for tenant 0).
  std::set<int> TenantWorkers(uint16_t tenant);
  int TenantWorkerCount(uint16_t tenant);
  // The tenant's advertised BYTEPS_TENANT_WEIGHT share (max across its
  // workers; 0-weight legacy registrants read as 1).
  int TenantWeightOf(uint16_t tenant);
  // Tenant of a worker node id (-1 = unknown node).
  int TenantOfNode(int node_id);
  // Full roster: tenant -> (live worker count, weight).
  std::map<uint16_t, std::pair<int, int>> TenantRoster();

  // Address-book lookup by node id (a replica dials its
  // primary from the LIVE book, so a hot-replaced primary resolves to
  // the replacement's endpoint). False when the id is not in the book.
  bool NodeOf(int node_id, NodeInfo* out);

  // Worker/server ids the scheduler considers dead (missed heartbeats).
  std::vector<int> DeadNodes();
  // Scheduler-side heartbeat freshness: (node id, ms since last beat)
  // for every tracked node, sorted by id — the monitor snapshot's
  // health signal (a cleanly-departed node is not tracked).
  std::vector<std::pair<int, int64_t>> HeartbeatAges();

 private:
  void ControlHandler(Message&& msg, int fd);
  void HeartbeatLoop();
  // Elastic worker membership (scheduler; caller holds mu_). A queued
  // membership op starts when no other is active: bump the epoch,
  // broadcast CMD_FLEET_PAUSE, and — join only — wait for every
  // worker's gated-counter ack before committing. Leaves and death
  // shrinks commit immediately (no drain needed; the server rollback
  // owns in-flight rounds).
  struct MemberOp {
    int kind = 0;      // 0 join, 1 leave, 2 death shrink
    int fd = -1;       // joiner's scheduler connection
    NodeInfo info{};   // joiner's advertised address
    int node_id = -1;  // leaver / dead worker id
    // Tenant of the joining/departing worker: only THIS
    // tenant's workers gate (join) and only this tenant's rosters
    // move — another tenant's rounds are untouched by the change.
    int tenant = 0;
  };
  // Tenant of a node id from the current book; caller holds mu_.
  int TenantOfNodeLocked(int node_id) const;
  void StartMemberOpLocked(MemberOp&& op);
  void CompleteMemberOpLocked();
  void HandleJoinRequest(Message&& msg, int fd);
  void HandleLeaveRequest(const Message& msg, int fd);
  // Scheduler: enter RECOVERY for a dead server rank — bump the epoch,
  // broadcast CMD_EPOCH_PAUSE, and arm the replacement-wait deadline.
  // Caller holds mu_.
  void StartRecoveryLocked(int node_id);
  // Scheduler: a replacement registered for `rank` (CMD_REGISTER with
  // the recovery marker) — adopt it: assign the dead rank's id, update
  // the address book, reply ADDRBOOK, broadcast CMD_EPOCH_RESUME.
  void HandleRecoverRegister(int fd, const NodeInfo& info, int rank);
  // Scheduler: admit a read replica — fresh elastic rank,
  // roster + heartbeat row, direct ADDRBOOK reply. Never a formation
  // participant and never counted into num_workers_/num_servers_.
  // Caller holds mu_.
  void AdmitReplicaLocked(int fd, const NodeInfo& info, int primary_rank);
  // Scheduler: the fail-stop broadcast (failure SHUTDOWN, arg0=1) —
  // shared by the heartbeat monitor and the recovery-timeout fallback.
  // Caller holds mu_.
  void BroadcastFailureLocked(const std::string& why);
  // Worker: dial the replacement server (all stripes), re-identify, and
  // swap the rank's fds. Returns false when the replacement is already
  // unreachable (escalates to peer-lost).
  bool DialReplacement(int node_id, const NodeInfo& info);
  // Re-dial a lost worker->server connection (stripe `stripe`; 0 =
  // primary) with capped exponential backoff (BYTEPS_RECONNECT_MAX /
  // BYTEPS_RECONNECT_BACKOFF_MS). On success the fresh fd replaces the
  // dead one in node_fd_/node_extra_fds_ and the worker re-identifies
  // itself (CMD_REGISTER hello, as at stripe dial time). Runs on the
  // dead connection's recv thread, before its CloseConn.
  bool TryReconnect(int node_id, int stripe);
  // Scheduler fail-over, node side: the scheduler
  // connection died with fail-over armed. Park — keep the data plane
  // draining against the last committed book — and re-dial the
  // scheduler endpoint with the capped backoff ladder, sending a
  // state-carrying CMD_REREGISTER on every fresh connection. Returns
  // true once CMD_SCHED_RESUME committed the recovery (heartbeats
  // resume); false when BYTEPS_SCHED_RECOVERY_TIMEOUT_MS expired (the
  // caller escalates to the original fail-stop). Runs on the
  // heartbeat thread.
  bool ParkOnSchedulerLost();
  // Scheduler fail-over, scheduler side: one node's CMD_REREGISTER.
  // Recover mode ingests it into sched_rec_ and commits at quorum; an
  // already-committed (or never-crashed) scheduler answers with an
  // idempotent direct ADDRBOOK + SCHED_RESUME.
  void HandleReregister(Message&& msg, int fd);
  // Quorum reached: rebuild the book / epoch / rank high-water mark /
  // tenant rosters from the fleet's reports, SEED the heartbeat table
  // (an empty table would declare every rank dead on the first tick),
  // broadcast re-issued ADDRBOOK + CMD_SCHED_RESUME, and release any
  // joins queued across the outage. Caller holds mu_.
  void CommitSchedRecoveryLocked();

  std::unique_ptr<Van> van_;
  AppHandler app_handler_;
  Role role_ = ROLE_WORKER;
  int my_id_ = -1;
  std::atomic<int> num_workers_{0};  // live (elastic membership)
  int num_servers_ = 0;
  std::atomic<bool> shutting_down_{false};
  std::atomic<bool> failure_shutdown_{false};

  std::mutex mu_;
  std::condition_variable cv_;
  std::vector<NodeInfo> nodes_;            // address book (set by ADDRBOOK)
  std::unordered_map<int, int> node_fd_;   // node id -> primary conn fd
  // node id -> extra striped data connections (BYTEPS_VAN_STREAMS > 1);
  // worker->server only. Stripe s of key k: s = k % streams, stripe 0 =
  // primary fd, stripe s>0 = extra[s-1].
  std::unordered_map<int, std::vector<int>> node_extra_fds_;
  bool addrbook_ready_ = false;

  // scheduler state
  // durable = the registrant's reported newest checkpoint version
  //: -2 = not restore-armed, -1 = armed with nothing valid
  // on disk, >= 0 = a checksum-valid checkpoint at that version.
  struct PendingReg { int fd; NodeInfo info; int64_t durable = -2; };
  std::vector<PendingReg> pending_regs_;
  // Read replicas that registered before fleet formation completed
  //: parked until there is an address book to answer with.
  struct BufferedReplica { NodeInfo info{}; int fd = -1; int primary = 0; };
  std::vector<BufferedReplica> buffered_replicas_;
  int replica_count_ = 0;  // live admitted replicas (guarded by mu_)
  std::map<int, int> barrier_counts_;      // group -> count
  std::unordered_map<int, int64_t> last_heartbeat_ms_;  // node id -> ts
  std::unordered_set<int> departed_;       // clean goodbyes: never "dead"
  int barrier_acks_needed_ = 0;

  // client-side barrier wait state
  std::map<int, int> barrier_done_;        // group -> generation

  std::thread heartbeat_thread_;
  std::thread monitor_thread_;  // scheduler: dead-node detection
  std::function<void()> shutdown_cb_;
  std::function<void(int)> peer_lost_cb_;
  std::function<void(int)> peer_reconnected_cb_;
  std::function<void(int)> peer_paused_cb_;
  std::function<void(int)> peer_recovered_cb_;
  std::function<void(int)> fleet_pause_cb_;
  std::function<void(int, int, int64_t, int64_t)> fleet_resume_cb_;
  std::function<void(int, int, int64_t, int64_t, int)> fleet_resize_cb_;

  // Hot-server-replacement state (guarded by mu_ unless atomic).
  std::atomic<int64_t> epoch_{0};          // fleet membership epoch
  std::atomic<int> recovering_count_{0};   // ranks currently mid-recovery
  std::unordered_set<int> recovering_peers_;  // node ids under recovery
  // Worker only: ranks parked by a LOCAL disconnect whose death the
  // scheduler has NOT yet confirmed (no CMD_EPOCH_PAUSE seen). The peer
  // may well be alive with only our connection broken (asymmetric loss,
  // chaos resets exhausting the reconnect ladder under load), and the
  // scheduler will then never start a recovery — so HeartbeatLoop keeps
  // re-dialing these (resume on success) and escalates to the
  // pre-recovery fail-fast once the deadline passes: by then a genuine
  // death would have produced either an EPOCH_RESUME or the scheduler's
  // no-replacement failure SHUTDOWN. stripes = dead stripes to re-dial.
  struct DiscPark {
    std::set<int> stripes;
    int64_t deadline_ms = 0;
  };
  std::unordered_map<int, DiscPark> disc_parked_;
  // Wire-CRC flaky-link quarantine attribution (guarded by
  // mu_): per-peer count of quarantine trips (the van force-closed a
  // connection over windowed CRC failures, BYTEPS_WIRE_CRC_QUARANTINE).
  // A peer whose trip count exceeds the reconnect budget
  // (BYTEPS_RECONNECT_MAX) is a persistently corrupting link: it joins
  // corrupt_failed_, and the disconnect handler then escalates straight
  // to the named fail-stop instead of re-dialing a poisoned path (a
  // fresh socket has already been tried budget-many times; the
  // corruption followed it every time).
  std::unordered_map<int, int> corrupt_quarantines_;
  std::unordered_set<int> corrupt_failed_;
  // scheduler only: the rank being replaced (-1 = none) and the
  // fall-back-to-fail-stop deadline for the replacement to arrive.
  int recovering_node_ = -1;
  int64_t recovery_deadline_ms_ = 0;

  // Elastic worker membership (scheduler state, guarded by mu_).
  // Worker ranks are allocated monotonically and NEVER reused: a joined
  // worker's rank (and therefore node id, trace identity, and monitor
  // endpoint port) can never collide with a departed one's.
  int next_worker_rank_ = -1;
  std::deque<MemberOp> member_queue_;
  bool member_active_ = false;
  MemberOp member_op_{};
  std::set<int> pause_acks_pending_;   // worker ids still to ack (join)
  int64_t member_round_max_ = 0;       // fleet max round counter (join)
  int64_t member_bcast_max_ = 0;
  int64_t member_start_ms_ = 0;
  int64_t member_deadline_ms_ = 0;     // fail-stop fallback

  // Worker: joiner's activation rounds (direct ADDRBOOK arg1) and the
  // graceful-leave handshake state.
  std::atomic<int64_t> join_round_{0};
  std::atomic<int64_t> join_bcast_{0};

  // Durable checkpoints: this node's own report (server,
  // set before Start) and the fleet's committed restore epoch (every
  // node, parsed from CMD_ADDRBOOK's key; -1 = none).
  bool durable_armed_ = false;
  int64_t durable_ckpt_ = -2;
  std::atomic<int64_t> restore_round_{-1};
  bool leave_acked_ = false;           // guarded by mu_
  std::atomic<bool> left_{false};      // leave committed: no goodbye owed

  // Heartbeat-echo clock estimate (see ClockOffsetUs).
  std::atomic<int64_t> clock_offset_us_{0};
  std::atomic<int64_t> clock_rtt_us_{-1};

  // --- scheduler fail-over ---
  // Node side: the scheduler endpoint to re-dial (captured at Start —
  // the restarted scheduler binds the SAME root port, pinned by the
  // launcher), the park flag, and the per-park resume latch.
  std::string sched_host_;
  int sched_port_ = 0;
  std::atomic<bool> sched_lost_{false};
  bool sched_resumed_ = false;            // guarded by mu_
  std::function<void()> sched_recovered_cb_;
  std::function<int64_t()> round_watermark_fn_;
  // Scheduler side: recover mode (DMLC_SCHED_RECOVER), the fleet-state
  // reconstruction, a failure reason that turns Start's recovery wait
  // into the clean fail-stop (conflict / malformed quorum), and joins
  // that arrived mid-recovery (released at commit). All but the start
  // timestamp guarded by mu_.
  bool sched_recover_mode_ = false;
  SchedRecovery sched_rec_;
  std::string sched_rec_fail_;
  int64_t sched_rec_start_ms_ = 0;
  std::vector<std::pair<NodeInfo, int>> buffered_joins_;  // info, fd
};

int64_t NowMs();

// BYTEPS_RETRY_MAX > 0 (default 4): the transient-fault tolerance master
// switch shared by the van reconnect path (postoffice.cc) and the KV
// retry layer (kv.h). 0 = pre-retry fail-fast behavior.
bool RetryEnabled();

// Hot server replacement master switch: BYTEPS_RECOVERY_TIMEOUT_MS > 0
// (default 60000) AND the retry layer on (re-seed rides the resend
// queue). 0 restores the fail-stop behavior wholesale: a dead server is a
// fleet-wide failure SHUTDOWN.
bool RecoveryEnabled();
int64_t RecoveryTimeoutMs();

// Elastic worker membership master switch: BYTEPS_ELASTIC=1. Requires
// the retry layer (config.py validates; the C side reads the env
// directly). With it OFF, any worker death keeps the fail-stop
// contract byte for byte.
bool ElasticEnabled();
// Fail-stop fallback window for a membership change that cannot commit
// (a worker never acks the join gate): BYTEPS_ELASTIC_TIMEOUT_MS.
int64_t ElasticTimeoutMs();

// Scheduler fail-over master switch:
// BYTEPS_SCHED_RECOVERY_TIMEOUT_MS > 0 (default 0 = off) AND the retry
// layer on AND heartbeats on (the heartbeat send failure IS the
// scheduler-lost detector, and the restarted scheduler's death
// verdicts come from the re-seeded heartbeat table). With it off, a
// lost scheduler connection keeps the fail-stop contract byte for
// byte. The window bounds BOTH sides: a parked node's re-dial ladder
// and the restarted scheduler's quorum wait.
bool SchedRecoveryEnabled();
int64_t SchedRecoveryTimeoutMs();

}  // namespace bps
