#include "postoffice.h"

#include <unistd.h>

#include <algorithm>
#include <chrono>
#include <cstring>

#include "events.h"
#include "logging.h"
#include "metrics.h"
#include "roundstats.h"
#include "tenancy.h"
#include "trace.h"

namespace bps {

int64_t NowMs() {
  return std::chrono::duration_cast<std::chrono::milliseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

static double EnvSeconds(const char* name, double dflt) {
  const char* v = getenv(name);
  return v && *v ? atof(v) : dflt;
}

static long EnvLong(const char* name, long dflt) {
  const char* v = getenv(name);
  return v && *v ? atol(v) : dflt;
}

// Transient-fault tolerance master switch: BYTEPS_RETRY_MAX > 0 (default
// on). 0 restores the pre-retry fail-fast behavior everywhere — any lost
// connection immediately fails that peer's in-flight requests.
bool RetryEnabled() {
  static const bool on = EnvLong("BYTEPS_RETRY_MAX", 4) > 0;
  return on;
}

// Hot server replacement: how long the scheduler holds the
// fleet in RECOVERY waiting for a replacement server before falling back
// to the fail-stop broadcast. 0 disables recovery wholesale. Requires
// the retry layer: the re-seed protocol rides the resend queue, and a
// worker with retries off fails the dead rank's requests immediately.
int64_t RecoveryTimeoutMs() {
  static const int64_t ms = EnvLong("BYTEPS_RECOVERY_TIMEOUT_MS", 60000);
  return ms;
}

bool RecoveryEnabled() { return RecoveryTimeoutMs() > 0 && RetryEnabled(); }

// Elastic worker membership: BYTEPS_ELASTIC=1 arms join /
// graceful-leave / worker-death-shrink handling. The C side reads the
// env directly (config.py validates it needs the retry layer); with it
// off, a dead worker keeps the fail-stop broadcast byte for byte.
bool ElasticEnabled() {
  static const bool on = EnvLong("BYTEPS_ELASTIC", 0) > 0;
  return on;
}

int64_t ElasticTimeoutMs() {
  static const int64_t ms = EnvLong("BYTEPS_ELASTIC_TIMEOUT_MS", 30000);
  return ms;
}

// Scheduler fail-over: how long a node parks on a lost
// scheduler connection (re-dialing with capped backoff) and how long a
// restarted scheduler waits for the fleet's re-registration quorum,
// before either side falls back to the original fail-stop. Default 0:
// the fail-stop scheduler-lost contract is unchanged unless armed. Needs
// the retry layer (the park defers KV escalation) and heartbeats (the
// failed beat IS the detector; the rebuilt death table needs seeds).
int64_t SchedRecoveryTimeoutMs() {
  static const int64_t ms =
      EnvLong("BYTEPS_SCHED_RECOVERY_TIMEOUT_MS", 0);
  return ms;
}

bool SchedRecoveryEnabled() {
  static const bool on = SchedRecoveryTimeoutMs() > 0 && RetryEnabled() &&
                         EnvSeconds("PS_HEARTBEAT_INTERVAL", 5.0) > 0;
  return on;
}

// Human name for a node id under the fixed id layout (scheduler 0,
// servers 1..S, workers S+1..): failure messages must NAME the link
// ("persistently corrupting link worker3→server1"), not print raw ids.
static std::string NodeName(int node_id, int num_servers) {
  if (node_id == kSchedulerId) return "scheduler";
  if (node_id <= num_servers) return "server" + std::to_string(node_id - 1);
  return "worker" + std::to_string(node_id - 1 - num_servers);
}

int Postoffice::Start(Role role, const std::string& root_uri, int root_port,
                      int num_workers, int num_servers,
                      AppHandler app_handler) {
  role_ = role;
  num_workers_.store(num_workers);
  num_servers_ = num_servers;
  app_handler_ = std::move(app_handler);
  // Scheduler fail-over series exist from zero on EVERY
  // role: a node parks (bps_sched_lost) and recovers
  // (bps_sched_recoveries_total) on its own; the scheduler additionally
  // reports recovery progress (/healthz reads these gauges).
  Metrics::Get().Counter("bps_sched_recoveries_total");
  Metrics::Get().Gauge("bps_sched_lost");
  Metrics::Get().Gauge("bps_sched_park_ms");
  van_ = std::make_unique<Van>(
      [this](Message&& m, int fd) { ControlHandler(std::move(m), fd); });
  van_->SetDisconnectHandler([this](int fd) {
    if (shutting_down_.load()) return;
    int node_id = -1;
    int stripe = -1;
    {
      std::lock_guard<std::mutex> lk(mu_);
      for (const auto& kv : node_fd_) {
        if (kv.second == fd) { node_id = kv.first; stripe = 0; break; }
      }
      if (node_id < 0) {
        // A lost STRIPE maps back to its peer too (one process owns
        // every stripe of a connection pair).
        for (const auto& kv : node_extra_fds_) {
          for (size_t s = 0; s < kv.second.size(); ++s) {
            if (kv.second[s] == fd) {
              node_id = kv.first;
              stripe = static_cast<int>(s) + 1;
              break;
            }
          }
          if (node_id >= 0) break;
        }
      }
    }
    if (node_id < 0) return;
    // Persistently corrupting link: the corruption handler
    // below already burned the full reconnect budget on CRC-quarantine
    // re-dials and branded this peer — every fresh socket corrupted
    // again. Skip the reconnect ladder AND the recovery park (both
    // would just hide a deterministic fault) and fail the peer by name:
    // the KV layer errors its outstanding requests, the worker raises,
    // the process exits nonzero. A fail-stop, not a hang.
    {
      bool corrupt_failed;
      {
        std::lock_guard<std::mutex> lk(mu_);
        corrupt_failed = corrupt_failed_.count(node_id) > 0;
      }
      if (corrupt_failed) {
        Trace::Get().Note("PEER_LOST", 0, node_id);
        Events::Get().Emit(EV_DEATH, node_id, /*replica=*/0);
        if (peer_lost_cb_) peer_lost_cb_(node_id);
        return;
      }
    }
    // Scheduler fail-over: with it armed, a lost scheduler
    // connection is NOT escalated here — the heartbeat thread owns the
    // park (its next beat fails on the dead fd and enters
    // ParkOnSchedulerLost), and firing peer_lost here would fail the
    // KV layer's in-flight work the park is there to preserve.
    if (node_id == kSchedulerId && role_ != ROLE_SCHEDULER &&
        SchedRecoveryEnabled()) {
      Trace::Get().Note("SCHED_CONN_LOST", 0, node_id);
      return;
    }
    // Transient-vs-persistent fork (SURVEY.md §5): a worker's
    // lost server connection is first treated as TRANSIENT — re-dial
    // with capped backoff and let the KV retry layer drain its resend
    // queue over the fresh connection. Only when the re-dial exhausts
    // its attempts (peer process actually gone) does it escalate to
    // the pre-existing fail-fast path. Scheduler connections are never
    // reconnected: heartbeat state lives there, and losing it already
    // has its own failure-shutdown handling (HeartbeatLoop).
    if (role_ == ROLE_WORKER && node_id != kSchedulerId &&
        RetryEnabled() && TryReconnect(node_id, stripe)) {
      BPS_METRIC_COUNTER_ADD("bps_reconnects_total", 1);
      if (peer_reconnected_cb_) peer_reconnected_cb_(node_id);
      return;
    }
    // Persistent SERVER loss with hot replacement armed: do not fail the
    // rank's in-flight requests — park them (retry clocks frozen via the
    // paused callback) and wait for the scheduler's CMD_EPOCH_RESUME
    // with the replacement's address, or the failure-SHUTDOWN fallback
    // when no replacement arrives within BYTEPS_RECOVERY_TIMEOUT_MS.
    // Worker deaths and scheduler loss keep the fail-stop. The
    // park is PROVISIONAL until the scheduler confirms the death
    // (CMD_EPOCH_PAUSE): the server may be alive with only our
    // connection broken, in which case no recovery will ever start —
    // HeartbeatLoop keeps re-dialing and owns the escalation deadline
    // (which also means recovery needs heartbeats: with them disabled
    // nothing could ever detect the death or end the park).
    if (role_ == ROLE_WORKER && node_id != kSchedulerId &&
        node_id <= num_servers_ && RecoveryEnabled() &&
        EnvSeconds("PS_HEARTBEAT_INTERVAL", 5.0) > 0) {
      bool first;
      {
        std::lock_guard<std::mutex> lk(mu_);
        first = recovering_peers_.insert(node_id).second;
        recovering_count_.store(
            static_cast<int>(recovering_peers_.size()));
        auto& dp = disc_parked_[node_id];
        dp.stripes.insert(stripe);
        if (dp.deadline_ms == 0) {
          // Worst honest case: the death happened just after the last
          // heartbeat the scheduler saw, then the full replacement
          // window runs out — only past that can "no EPOCH_PAUSE" mean
          // the scheduler will never act.
          dp.deadline_ms =
              NowMs() +
              static_cast<int64_t>(
                  EnvSeconds("PS_HEARTBEAT_TIMEOUT", 30.0) * 1000) +
              RecoveryTimeoutMs() + 2000;
        }
      }
      BPS_METRIC_GAUGE_SET("bps_recovering", 1);
      if (first) {
        BPS_LOG(WARNING) << "node " << my_id_ << ": server " << node_id
                         << " unreachable — parking its in-flight "
                            "requests, awaiting hot replacement";
      }
      Trace::Get().Note("PEER_PARKED", 0, node_id);
      if (peer_paused_cb_) peer_paused_cb_(node_id);
      return;
    }
    Trace::Get().Note("PEER_LOST", 0, node_id);
    Events::Get().Emit(EV_DEATH, node_id, /*replica=*/0);
    if (peer_lost_cb_) peer_lost_cb_(node_id);
  });
  // Flaky-link quarantine attribution: the van tripped the
  // windowed CRC-failure threshold on a connection and is about to
  // force-close it (the disconnect handler above then re-dials through
  // the normal reconnect ladder — a fresh socket clears a genuinely
  // flaky path). Here we map the fd back to its peer, count the trip,
  // and past the reconnect budget brand the link persistently
  // corrupting so the imminent disconnect escalates to the named
  // fail-stop instead of burning another ladder on a poisoned path.
  van_->SetCorruptionHandler([this](int fd) {
    if (shutting_down_.load()) return;
    int node_id = -1;
    int count = 0;
    bool failed = false;
    const int budget = static_cast<int>(EnvLong("BYTEPS_RECONNECT_MAX", 3));
    {
      std::lock_guard<std::mutex> lk(mu_);
      for (const auto& kv : node_fd_) {
        if (kv.second == fd) { node_id = kv.first; break; }
      }
      if (node_id < 0) {
        for (const auto& kv : node_extra_fds_) {
          for (int efd : kv.second) {
            if (efd == fd) { node_id = kv.first; break; }
          }
          if (node_id >= 0) break;
        }
      }
      if (node_id < 0) return;
      count = ++corrupt_quarantines_[node_id];
      if (count > budget && corrupt_failed_.insert(node_id).second) {
        failed = true;
      }
    }
    const std::string link =
        NodeName(node_id, num_servers_) + "->" +
        NodeName(my_id_, num_servers_);
    BPS_METRIC_COUNTER_ADD("bps_crc_quarantine_links_total", 1);
    if (failed) {
      BPS_METRIC_GAUGE_SET("bps_link_corrupting", 1);
      BPS_LOG(WARNING) << "node " << my_id_
                     << ": persistently corrupting link " << link
                     << " — CRC quarantine tripped " << count
                     << "x, past the reconnect budget (" << budget
                     << "); failing the peer (fail-stop)";
      Trace::Get().Note("LINK_CORRUPTING", count, node_id);
      Events::Get().Emit(EV_CRC_FAILSTOP, node_id, count);
      Trace::Get().FlightDumpAuto("corrupting_link");
    } else {
      BPS_LOG(WARNING) << "node " << my_id_ << ": CRC quarantine #"
                       << count << " on link " << link
                       << " — forcing a re-dial through a fresh socket";
      Trace::Get().Note("LINK_QUARANTINED", count, node_id);
      Events::Get().Emit(EV_CRC_QUARANTINE, node_id, count);
    }
  });

  // Fleet-formation bound: until the topology completes no job can be
  // running, and the dead-node monitor has an empty heartbeat table
  // (nothing registered -> it can never fire). An indefinite wait here
  // would therefore leak the whole fleet — scheduler + servers + the
  // bound port — forever if one worker crashes before registering.
  // Fail loudly instead; post-formation lifetime is unbounded (the
  // heartbeat monitor is the failure exit from then on).
  // PS_TOPOLOGY_TIMEOUT <= 0 disables the bound (the file's <=0
  // convention, as with PS_HEARTBEAT_INTERVAL).
  double form_s = EnvSeconds("PS_TOPOLOGY_TIMEOUT", 600.0);
  auto wait_formed = [&](std::unique_lock<std::mutex>& lk,
                         const char* what) {
    if (form_s <= 0) {
      cv_.wait(lk, [this] { return addrbook_ready_; });
      return;
    }
    BPS_CHECK(cv_.wait_for(
        lk,
        std::chrono::milliseconds(static_cast<long>(form_s * 1000)),
        [this] { return addrbook_ready_; }))
        << what << " within PS_TOPOLOGY_TIMEOUT=" << form_s
        << "s (a node crashed before registering?)";
  };
  if (role == ROLE_SCHEDULER) {
    my_id_ = kSchedulerId;
    // Scheduler fail-over: DMLC_SCHED_RECOVER marks this
    // incarnation as a crash-restart — the launcher respawn sets it.
    // There is no fleet to form: every survivor re-dials this (same,
    // launcher-pinned) port and re-registers with its committed state;
    // the book, epoch, rank high-water mark, tenant rosters, and
    // heartbeat table are all rebuilt from that quorum. Mode must be
    // set BEFORE Listen: re-dialing nodes race the accept loop.
    const char* srv = getenv("DMLC_SCHED_RECOVER");
    if (srv && *srv && strcmp(srv, "0") != 0) {
      BPS_CHECK(SchedRecoveryEnabled())
          << "DMLC_SCHED_RECOVER set but scheduler fail-over is not "
             "armed (need BYTEPS_SCHED_RECOVERY_TIMEOUT_MS > 0, "
             "BYTEPS_RETRY_MAX > 0, PS_HEARTBEAT_INTERVAL > 0)";
      std::lock_guard<std::mutex> lk(mu_);
      sched_recover_mode_ = true;
      sched_rec_start_ms_ = NowMs();
    }
    if (sched_recover_mode_) {
      BPS_METRIC_GAUGE_SET("bps_sched_recovering", 1);
      BPS_LOG(WARNING) << "scheduler: restarting in RECOVERY mode — "
                          "rebuilding state from fleet "
                          "re-registrations (window "
                       << SchedRecoveryTimeoutMs() << " ms)";
      Trace::Get().Note("SCHED_RECOVER_START",
                        SchedRecoveryTimeoutMs());
    }
    van_->Listen(root_port);
    std::unique_lock<std::mutex> lk(mu_);
    if (sched_recover_mode_) {
      const int64_t window = SchedRecoveryTimeoutMs();
      bool done = cv_.wait_for(
          lk, std::chrono::milliseconds(window), [this] {
            return addrbook_ready_ || !sched_rec_fail_.empty() ||
                   shutting_down_.load();
          });
      if (!sched_rec_fail_.empty()) {
        BPS_CHECK(false) << "scheduler recovery failed: "
                         << sched_rec_fail_;
      }
      BPS_CHECK(done && addrbook_ready_)
          << "scheduler recovery did not reach quorum within "
             "BYTEPS_SCHED_RECOVERY_TIMEOUT_MS=" << window << " ms ("
          << sched_rec_.Reregistered() << " re-registered, "
          << sched_rec_.ExpectedIds().size()
          << " expected) — clean fail-stop";
    } else {
      // Wait for everyone to register; ControlHandler completes the
      // handshake.
      wait_formed(lk, "topology did not complete");
    }
  } else {
    // The endpoint a scheduler-lost park re-dials: the
    // respawned scheduler binds the SAME root port.
    sched_host_ = root_uri;
    sched_port_ = root_port;
    // Deployment port mapping (the DMLC_NODE_HOST analogue for ports):
    // BYTEPS_LISTEN_PORT pins the local bind (containers with published
    // ports), BYTEPS_ADVERTISED_PORT is what peers are told to dial
    // (NAT / port-forward / proxy in front of this node). Defaults:
    // ephemeral bind, advertise what we bound.
    int want_port = 0;
    if (const char* lp = getenv("BYTEPS_LISTEN_PORT")) want_port = atoi(lp);
    int listen_port = van_->Listen(want_port);
    int fd = van_->Connect(root_uri, root_port);
    BPS_CHECK_GE(fd, 0) << "cannot reach scheduler at " << root_uri << ":"
                        << root_port;
    {
      std::lock_guard<std::mutex> lk(mu_);
      node_fd_[kSchedulerId] = fd;
    }
    NodeInfo me{};
    me.id = -1;
    me.role = role;
    // Tenant registration: workers advertise their job's
    // tenant id + weight; the scheduler re-broadcasts them with every
    // address book. Servers/scheduler are shared infrastructure
    // (tenant 0, weight 0 — the zero-initialised legacy bytes).
    if (role == ROLE_WORKER && TenantId() > 0) {
      me.tenant = TenantId();
      me.weight = TenantWeight();
    }
    const char* host_env = getenv("DMLC_NODE_HOST");
    snprintf(me.host, sizeof(me.host), "%s",
             host_env && *host_env ? host_env : "127.0.0.1");
    me.port = listen_port;
    if (const char* ap = getenv("BYTEPS_ADVERTISED_PORT")) {
      me.port = atoi(ap);
    }
    MsgHeader h{};
    h.cmd = CMD_REGISTER;
    h.tenant = TenantId();
    h.sender = -1;
    const char* wid = getenv("DMLC_WORKER_ID");
    h.arg0 = wid && *wid ? atol(wid) : -1;  // preferred rank (deterministic)
    h.arg1 = role;
    // Replacement server: DMLC_RECOVER_RANK=<server index>
    // marks this registration as adopting a dead rank's id and shard —
    // the scheduler answers with a direct ADDRBOOK instead of waiting
    // for fleet formation (which already happened).
    const char* rr = getenv("DMLC_RECOVER_RANK");
    if (role == ROLE_SERVER && rr && *rr) {
      h.arg0 = atol(rr);
      h.version = 1;  // recovery-registration marker
      BPS_LOG(WARNING) << "server: registering as hot replacement for "
                          "server rank " << h.arg0;
    }
    // Durable-checkpoint restore: a restore-armed server
    // reports its newest checksum-valid checkpoint version so the
    // scheduler can commit a fleet-wide restore epoch at the minimum
    // common version across shards. key = 1 + version; 0 = armed with
    // NOTHING valid on disk (the scheduler fail-stops on it rather
    // than silently cold-starting one shard).
    if (role == ROLE_SERVER && durable_armed_) {
      h.flags |= FLAG_CKPT_DURABLE;
      h.key = 1 + durable_ckpt_;
      BPS_LOG(WARNING) << "server: registering restore-armed "
                          "(BYTEPS_CKPT_RESTORE) — newest durable "
                          "checkpoint version "
                       << durable_ckpt_;
    }
    // Elastic joiner: DMLC_JOIN marks a worker joining a
    // RUNNING fleet. The scheduler allocates a fresh never-reused rank,
    // gates the fleet's new rounds, and answers with a direct ADDRBOOK
    // (arg1 = the round boundary this rank enters at) — no fleet
    // re-formation.
    const char* jn = getenv("DMLC_JOIN");
    if (role == ROLE_WORKER && jn && *jn && strcmp(jn, "0") != 0) {
      h.cmd = CMD_JOIN_REQUEST;
      BPS_LOG(WARNING) << "worker: joining a running fleet "
                          "(DMLC_JOIN set) — awaiting the scheduler's "
                          "membership epoch";
    }
    // Read replica: rostered like any node — heartbeats,
    // address book, shutdown broadcast — but OUTSIDE the training
    // roster: never counted into num_workers_/num_servers_, never a
    // formation participant. h.arg0 carries the primary's server rank.
    if (role == ROLE_REPLICA) {
      const char* ro = getenv("BYTEPS_REPLICA_OF");
      h.arg0 = ro && *ro ? atol(ro) : 0;
      h.version = 2;  // replica-registration marker
      BPS_LOG(WARNING) << "replica: registering as read replica of "
                          "server rank " << h.arg0;
    }
    van_->Send(fd, h, &me, sizeof(me));
    // Wait for the address book (same formation bound as the scheduler).
    std::unique_lock<std::mutex> lk(mu_);
    wait_formed(lk, "no address book");
    lk.unlock();
    if (role == ROLE_WORKER) {
      // Dial every server; identify ourselves on each connection.
      // BYTEPS_VAN_STREAMS > 1 opens extra striped connections per server
      // (the RDMA-van role: one TCP stream's cwnd/ack clocking caps
      // per-peer goodput; partition-keyed striping multiplies it while
      // keeping each key's ordering on one stream).
      int streams = 1;
      if (const char* sv = getenv("BYTEPS_VAN_STREAMS")) {
        streams = atoi(sv);
        if (streams < 1) streams = 1;
      }
      for (const auto& n : nodes_) {
        if (n.role != ROLE_SERVER) continue;
        for (int s = 0; s < streams; ++s) {
          int sfd = van_->Connect(n.host, n.port);
          BPS_CHECK_GE(sfd, 0) << "cannot reach server " << n.id;
          MsgHeader hello{};
          hello.cmd = CMD_REGISTER;
          hello.sender = my_id_;
          hello.arg1 = ROLE_WORKER;
          van_->Send(sfd, hello);
          std::lock_guard<std::mutex> lk2(mu_);
          if (s == 0) {
            node_fd_[n.id] = sfd;
          } else {
            node_extra_fds_[n.id].push_back(sfd);
          }
        }
      }
    }
  }

  double interval = EnvSeconds("PS_HEARTBEAT_INTERVAL", 5.0);
  if (role != ROLE_SCHEDULER && interval > 0) {
    heartbeat_thread_ = std::thread([this] { HeartbeatLoop(); });
  }
  if (role == ROLE_SCHEDULER && interval > 0) {
    // Failure detection (reference: ps-lite heartbeat timeout, SURVEY.md
    // §5): a node missing heartbeats past PS_HEARTBEAT_TIMEOUT. A dead
    // SERVER with recovery armed enters scheduler-coordinated hot
    // replacement; anything else — a dead worker, multiple
    // simultaneous deaths, recovery disabled, or a replacement that
    // never arrives — takes the fleet down fail-stop as before, and the
    // cluster manager owns the restart.
    Metrics::Get().Counter("bps_recoveries_total");
    Metrics::Get().Gauge("bps_membership_epoch");
    Metrics::Get().Gauge("bps_recovering");
    // Scheduler fail-over progress: /healthz renders
    // RECOVERING with reregistered/expected from these.
    Metrics::Get().Gauge("bps_sched_recovering");
    Metrics::Get().Gauge("bps_sched_rereg");
    Metrics::Get().Gauge("bps_sched_rereg_expected");
    Metrics::Get().Gauge("bps_sched_recovery_ms");
    // Elastic worker membership: fleet-size series live on
    // the scheduler from zero — monitor.top's fleet header and the
    // elastic tests read them.
    Metrics::Get().Counter("bps_worker_joins_total");
    Metrics::Get().Counter("bps_worker_leaves_total");
    // Snapshot serving: replica roster size + death count,
    // from zero — monitor.top's fleet header reads the gauge.
    Metrics::Get().Gauge("bps_fleet_replicas");
    Metrics::Get().Counter("bps_replica_deaths_total");
    Metrics::Get().Gauge("bps_fleet_workers");
    Metrics::Get().Gauge("bps_fleet_tenants");
    Metrics::Get().Gauge("bps_fleet_resizing");
    Metrics::Get().Gauge("bps_epoch_change_ms");
    BPS_METRIC_GAUGE_SET("bps_fleet_workers", num_workers_.load());
    monitor_thread_ = std::thread([this, interval] {
      int64_t next_check_ms =
          NowMs() + static_cast<int64_t>(interval * 1000);
      while (!shutting_down_.load()) {
        usleep(100 * 1000);
        if (shutting_down_.load()) return;
        {
          // Recovery fallback deadline: checked every tick so the
          // fail-stop is prompt even with long heartbeat intervals.
          std::lock_guard<std::mutex> lk(mu_);
          if (recovering_node_ >= 0 && NowMs() > recovery_deadline_ms_) {
            BroadcastFailureLocked(
                "no replacement for server " +
                std::to_string(recovering_node_) + " within " +
                std::to_string(RecoveryTimeoutMs()) + " ms");
            return;
          }
          // Membership-change fallback: a join whose gate acks never
          // complete (a worker wedged or died mid-change) falls back to
          // the fail-stop broadcast, so elasticity strictly improves on
          // the fail-stop contract instead of trading it for a hang.
          if (member_active_ && NowMs() > member_deadline_ms_) {
            BroadcastFailureLocked(
                "worker membership change (kind " +
                std::to_string(member_op_.kind) + ") did not commit "
                "within BYTEPS_ELASTIC_TIMEOUT_MS=" +
                std::to_string(ElasticTimeoutMs()) + " ms");
            return;
          }
        }
        if (NowMs() < next_check_ms) continue;
        next_check_ms = NowMs() + static_cast<int64_t>(interval * 1000);
        auto dead = DeadNodes();
        // Replica deaths are free: a read replica carries no
        // training state, so its loss must never enter the
        // recoverable/shrinkable/fail-stop classification below — its
        // readers fail over to another endpoint, the fleet does not
        // even pause. Drop it from the roster and move on.
        {
          std::lock_guard<std::mutex> lk(mu_);
          for (auto it = dead.begin(); it != dead.end();) {
            int rid = *it;
            bool is_replica = false;
            for (const auto& n : nodes_) {
              if (n.id == rid && n.role == ROLE_REPLICA) {
                is_replica = true;
                break;
              }
            }
            if (!is_replica) {
              ++it;
              continue;
            }
            BPS_LOG(WARNING) << "scheduler: read replica " << rid
                             << " missed heartbeats — dropped from the "
                                "roster (readers fail over; the "
                                "training fleet is unaffected)";
            last_heartbeat_ms_.erase(rid);
            node_fd_.erase(rid);
            departed_.insert(rid);
            nodes_.erase(std::remove_if(nodes_.begin(), nodes_.end(),
                                        [rid](const NodeInfo& n) {
                                          return n.id == rid;
                                        }),
                         nodes_.end());
            replica_count_ -= 1;
            BPS_METRIC_GAUGE_SET("bps_fleet_replicas", replica_count_);
            BPS_METRIC_COUNTER_ADD("bps_replica_deaths_total", 1);
            Trace::Get().Note("REPLICA_LOST", 0, rid);
            Events::Get().Emit(EV_DEATH, rid, /*replica=*/1);
            it = dead.erase(it);
          }
        }
        if (dead.empty()) continue;
        // Recoverable: exactly one dead node, it is a server, and hot
        // replacement is armed. (Simultaneous multi-server death is out
        // of recovery scope — fail-stop, restart from checkpoint.)
        bool recoverable = RecoveryEnabled() && dead.size() == 1 &&
                           dead[0] >= ServerId(0) &&
                           dead[0] <= num_servers_;
        // Shrinkable: exactly one dead node, it is a WORKER,
        // elasticity is armed, and at least one worker survives. The
        // fleet shrinks to N-1 instead of fail-stopping — the server
        // rollback discards the dead rank's partial contributions and
        // every later round is an exact mean over the survivors.
        bool shrinkable = ElasticEnabled() && RetryEnabled() &&
                          dead.size() == 1 && dead[0] > num_servers_ &&
                          num_workers_.load() > 1;
        std::lock_guard<std::mutex> lk(mu_);
        if (recoverable) {
          if (recovering_node_ < 0) StartRecoveryLocked(dead[0]);
          continue;
        }
        if (shrinkable && recovering_node_ < 0) {
          BPS_LOG(WARNING) << "scheduler: worker " << dead[0]
                           << " missed heartbeats — elastic shrink to "
                           << num_workers_.load() - 1 << " worker(s) "
                              "instead of fail-stop (BYTEPS_ELASTIC)";
          last_heartbeat_ms_.erase(dead[0]);
          departed_.insert(dead[0]);
          MemberOp op;
          op.kind = 2;
          op.node_id = dead[0];
          op.tenant = TenantOfNodeLocked(dead[0]);
          member_queue_.push_back(std::move(op));
          if (!member_active_) {
            MemberOp next = std::move(member_queue_.front());
            member_queue_.pop_front();
            StartMemberOpLocked(std::move(next));
          } else if (member_op_.kind == 0 &&
                     pause_acks_pending_.erase(dead[0]) > 0 &&
                     pause_acks_pending_.empty()) {
            // Supervisor-respawn-ahead-of-detection: a joiner arrived
            // while the dead rank was still counted, and its gate ack
            // can never come. Commit the join without it — the queued
            // death op right behind removes it from every roster (and
            // rolls back its partial contributions).
            CompleteMemberOpLocked();
          }
          continue;
        }
        std::string ids;
        for (int id : dead) ids += std::to_string(id) + " ";
        BroadcastFailureLocked("node(s) " + ids + "missed heartbeats");
        return;
      }
    });
  }
  BPS_LOG(INFO) << "node started: role=" << role << " id=" << my_id_;
  return my_id_;
}

int64_t Postoffice::WaitRestoreRound() {
  // Blocks until the address book (and with it the scheduler's restore
  // decision) has arrived; -1 = no restore epoch, ordinary cold start.
  std::unique_lock<std::mutex> lk(mu_);
  cv_.wait(lk, [this] { return addrbook_ready_; });
  return restore_round_.load();
}

void Postoffice::ControlHandler(Message&& msg, int fd) {
  switch (msg.head.cmd) {
    case CMD_REGISTER: {
      if (role_ == ROLE_SCHEDULER && msg.head.version == 1) {
        // A replacement server adopting a dead rank (DMLC_RECOVER_RANK).
        BPS_CHECK_EQ(msg.payload.size(), sizeof(NodeInfo));
        NodeInfo info{};
        memcpy(&info, msg.payload.data(), sizeof(NodeInfo));
        HandleRecoverRegister(fd, info, static_cast<int>(msg.head.arg0));
        break;
      }
      if (role_ == ROLE_SCHEDULER && msg.head.version == 2) {
        // A read replica registering: rostered (heartbeats,
        // book entry, shutdown broadcast) but NOT a formation
        // participant — it never counts toward pending_regs_, and a
        // replica arriving before the training fleet has formed is
        // parked until the book exists to answer with.
        BPS_CHECK_EQ(msg.payload.size(), sizeof(NodeInfo));
        NodeInfo info{};
        memcpy(&info, msg.payload.data(), sizeof(NodeInfo));
        std::lock_guard<std::mutex> lk(mu_);
        if (!addrbook_ready_) {
          buffered_replicas_.push_back(
              {info, fd, static_cast<int>(msg.head.arg0)});
        } else {
          AdmitReplicaLocked(fd, info, static_cast<int>(msg.head.arg0));
        }
        break;
      }
      if (role_ == ROLE_SCHEDULER) {
        std::unique_lock<std::mutex> lk(mu_);
        BPS_CHECK_EQ(msg.payload.size(), sizeof(NodeInfo));
        PendingReg pr;
        pr.fd = fd;
        memcpy(&pr.info, msg.payload.data(), sizeof(NodeInfo));
        pr.info.id = static_cast<int32_t>(msg.head.arg0);  // preferred rank
        // Durable restore report: key = 1 + newest
        // checksum-valid checkpoint version; 0 = armed, nothing valid.
        if (msg.head.flags & FLAG_CKPT_DURABLE) {
          pr.durable = msg.head.key - 1;
        }
        pending_regs_.push_back(pr);
        if (static_cast<int>(pending_regs_.size()) ==
            num_workers_ + num_servers_) {
          // Assign ids: deterministic by (role, preferred rank, arrival).
          std::stable_sort(pending_regs_.begin(), pending_regs_.end(),
                           [](const PendingReg& a, const PendingReg& b) {
                             if (a.info.role != b.info.role)
                               return a.info.role < b.info.role;
                             return a.info.id < b.info.id;
                           });
          nodes_.clear();
          NodeInfo sched{};
          sched.id = kSchedulerId;
          sched.role = ROLE_SCHEDULER;
          nodes_.push_back(sched);
          int next_server = 0, next_worker = 0;
          for (auto& pr2 : pending_regs_) {
            int id = pr2.info.role == ROLE_SERVER
                         ? ServerId(next_server++)
                         : WorkerId(next_worker++);
            pr2.info.id = id;
            nodes_.push_back(pr2.info);
            node_fd_[id] = pr2.fd;
            last_heartbeat_ms_[id] = NowMs();
            // Membership event for the scheduler's timeline row.
            Trace::Get().Instant("register", id, id, -1, pr2.info.role);
          }
          // Durable restore epoch: if ANY server registered
          // restore-armed, ALL must have — a partial restore would
          // silently cold-start the unarmed shards and diverge the
          // model. The fleet resumes at the minimum version common to
          // every shard; a shard with nothing valid on disk makes the
          // whole restore impossible, so that is a clean fail-stop with
          // a named diagnostic, never a silent cold start.
          int64_t restore = -1;
          {
            int armed = 0, nsrv = 0;
            int64_t minv = -1;
            std::string missing;
            for (const auto& pr2 : pending_regs_) {
              if (pr2.info.role != ROLE_SERVER) continue;
              ++nsrv;
              if (pr2.durable == -2) continue;  // not restore-armed
              ++armed;
              if (pr2.durable < 0) {
                missing += " server id " + std::to_string(pr2.info.id) +
                           ";";
              } else if (minv < 0 || pr2.durable < minv) {
                minv = pr2.durable;
              }
            }
            if (armed > 0) {
              BPS_CHECK_EQ(armed, nsrv)
                  << "ckpt-restore: only " << armed << " of " << nsrv
                  << " server shard(s) registered restore-armed "
                     "(BYTEPS_CKPT_RESTORE=1) — restoring a subset "
                     "would silently cold-start the rest; arm every "
                     "server or none";
              BPS_CHECK(missing.empty())
                  << "ckpt-restore: no checksum-valid checkpoint found "
                     "on" << missing
                  << " — refusing a silent cold start (unset "
                     "BYTEPS_CKPT_RESTORE to start fresh)";
              restore = minv;
              restore_round_.store(restore);
              Events::Get().Emit(EV_CKPT_RESTORE, restore, nsrv);
              BPS_LOG(WARNING)
                  << "scheduler: restore epoch committed at checkpoint "
                     "version " << restore
                  << " (minimum common across " << nsrv << " shard(s))";
            }
          }
          for (auto& pr2 : pending_regs_) {
            MsgHeader h{};
            h.cmd = CMD_ADDRBOOK;
            h.sender = kSchedulerId;
            h.arg0 = pr2.info.id;  // your assigned id
            h.key = 1 + restore;   // restore epoch; 0 = none
            van_->Send(pr2.fd, h, nodes_.data(),
                       nodes_.size() * sizeof(NodeInfo));
          }
          addrbook_ready_ = true;
          // Elastic rank allocation starts past the formation ranks:
          // joined workers get fresh, never-reused ranks/ids.
          next_worker_rank_ = next_worker;
          // Replicas that raced formation parked here; admit them now
          // that there is a book to answer with.
          for (const auto& br : buffered_replicas_) {
            AdmitReplicaLocked(br.fd, br.info, br.primary);
          }
          buffered_replicas_.clear();
          cv_.notify_all();
          // Tenant roster: feed node->tenant into the
          // round-summary layer (insight tags rounds by tenant) and
          // log the per-tenant split when any registrant named one.
          std::map<int, int> by_tenant;
          for (const auto& n : nodes_) {
            if (n.role != ROLE_WORKER) continue;
            RoundStats::Get().SetNodeTenant(n.id, n.tenant);
            ++by_tenant[n.tenant];
          }
          BPS_METRIC_GAUGE_SET("bps_fleet_tenants",
                               static_cast<int64_t>(by_tenant.size()));
          if (by_tenant.size() > 1 || by_tenant.count(0) == 0) {
            std::string roster;
            for (const auto& kv : by_tenant) {
              roster += " tenant " + std::to_string(kv.first) + ": " +
                        std::to_string(kv.second) + " worker(s);";
            }
            BPS_LOG(WARNING) << "scheduler: multi-tenant fleet —"
                             << roster;
          }
          BPS_LOG(INFO) << "scheduler: topology complete ("
                        << num_workers_.load() << " workers, "
                        << num_servers_ << " servers)";
        }
      } else {
        // Server side: a worker identifying itself on a fresh connection.
        // With BYTEPS_VAN_STREAMS > 1 the same worker registers each
        // stripe; only the FIRST (primary) fd is recorded so a later
        // stripe can't overwrite it. Invariant: server RESPONSES always
        // go out on the fd the request arrived on (kv.h keeps per-fd
        // reply routing), so node_fd_ here is only a fallback for any
        // future server-initiated send keyed by node id — which must use
        // the primary connection.
        std::lock_guard<std::mutex> lk(mu_);
        node_fd_.emplace(msg.head.sender, fd);  // no-op if already known
      }
      break;
    }
    case CMD_ADDRBOOK: {
      std::lock_guard<std::mutex> lk(mu_);
      my_id_ = static_cast<int>(msg.head.arg0);
      size_t n = msg.payload.size() / sizeof(NodeInfo);
      nodes_.resize(n);
      memcpy(nodes_.data(), msg.payload.data(), n * sizeof(NodeInfo));
      // Fleet size from the book itself, not the env: a JOINER's
      // DMLC_NUM_WORKER describes the formation-time fleet, and an
      // elastic fleet's size is whatever the scheduler says it is.
      int nw = 0;
      for (const auto& node : nodes_) {
        if (node.role == ROLE_WORKER) ++nw;
      }
      if (nw > 0) num_workers_.store(nw);
      // Joiner activation boundary (CMD_JOIN_REQUEST answer): the round
      // counters this rank's tensors start at. 0 on ordinary formation.
      if (msg.head.arg1 != 0) {
        join_round_.store(msg.head.arg1 >> 32);
        join_bcast_.store(msg.head.arg1 & 0xffffffff);
      }
      // Durable restore epoch: 1 + checkpoint version the
      // fleet resumes from; 0 = ordinary cold start.
      if (msg.head.key > 0) restore_round_.store(msg.head.key - 1);
      addrbook_ready_ = true;
      cv_.notify_all();
      break;
    }
    case CMD_BARRIER: {
      BPS_CHECK_EQ(role_, ROLE_SCHEDULER);
      int group = static_cast<int>(msg.head.arg0);
      std::lock_guard<std::mutex> lk(mu_);
      int need = ((group & GROUP_SERVERS) ? num_servers_ : 0) +
                 ((group & GROUP_WORKERS) ? num_workers_.load() : 0);
      if (++barrier_counts_[group] == need) {
        barrier_counts_[group] = 0;
        MsgHeader h{};
        h.cmd = CMD_BARRIER_ACK;
        h.sender = kSchedulerId;
        h.arg0 = group;
        for (const auto& n : nodes_) {
          bool in_group =
              (n.role == ROLE_SERVER && (group & GROUP_SERVERS)) ||
              (n.role == ROLE_WORKER && (group & GROUP_WORKERS));
          if (in_group) van_->Send(node_fd_[n.id], h);
        }
      }
      break;
    }
    case CMD_BARRIER_ACK: {
      std::lock_guard<std::mutex> lk(mu_);
      barrier_done_[static_cast<int>(msg.head.arg0)]++;
      cv_.notify_all();
      break;
    }
    case CMD_HEARTBEAT: {
      {
        std::lock_guard<std::mutex> lk(mu_);
        // A cleanly-departed worker keeps heartbeating while it waits for
        // the fleet shutdown; re-inserting it would later read as a death.
        if (!departed_.count(msg.head.sender)) {
          last_heartbeat_ms_[msg.head.sender] = NowMs();
        }
      }
      // Piggybacked telemetry: the heartbeat payload multiplexes
      // versioned, magic-tagged sub-payloads — round summaries
      // (0xB57A) and journal events (0xE7B5), in either
      // order. Walk them chunk by chunk; unknown leading bytes end the
      // walk (old senders and future generations interop — each
      // ingester validates magic/version/length itself and the
      // heartbeat only needed the header above).
      if (role_ == ROLE_SCHEDULER && !msg.payload.empty()) {
        const char* p = msg.payload.data();
        size_t left = msg.payload.size();
        while (left > 0) {
          size_t used = RoundStats::WireSize(p, left);
          if (used) {
            RoundStats::Get().Ingest(p, left);
          } else if ((used = Events::PeekWireSize(p, left)) != 0) {
            Events::Get().Ingest(p, left);
          } else {
            break;
          }
          p += used;
          left -= used;
        }
        // Heartbeats are also the scheduler's history clock: sample
        // the gauge registry into the journal's per-metric rings
        // (rate-limited inside to one sample per second).
        Events::Get().SampleHistory(NowUs());
      }
      // Echo for clock alignment: arg0 = the sender's send
      // timestamp, arg1 = this (scheduler) clock now. The sender keeps
      // its min-RTT sample and derives its offset vs our clock — the
      // common timebase the fleet timeline merge aligns every rank to.
      if (msg.head.arg0 > 0) {
        MsgHeader ack{};
        ack.cmd = CMD_HEARTBEAT_ACK;
        ack.sender = kSchedulerId;
        ack.arg0 = msg.head.arg0;
        ack.arg1 = NowUs();
        van_->Send(fd, ack);
      }
      break;
    }
    case CMD_HEARTBEAT_ACK: {
      // Scheduler echo of our heartbeat: rtt = now - send_ts; the
      // scheduler stamped its clock at (approximately) the midpoint, so
      // offset = sched_ts - (send_ts + rtt/2). Keep the MINIMUM-rtt
      // sample — queuing delay only ever inflates rtt, so the smallest
      // sample bounds the offset error tightest (NTP's core trick).
      int64_t now = NowUs();
      int64_t rtt = now - msg.head.arg0;
      if (rtt >= 0) {
        int64_t best = clock_rtt_us_.load();
        if (best < 0 || rtt < best) {
          int64_t offset = msg.head.arg1 - (msg.head.arg0 + rtt / 2);
          clock_rtt_us_.store(rtt);
          clock_offset_us_.store(offset);
          Trace::Get().SetClock(offset, rtt);
          Events::Get().SetClock(offset);
        }
      }
      break;
    }
    case CMD_EPOCH_PAUSE: {
      // A server rank died; the fleet entered RECOVERY at a new
      // membership epoch. Workers freeze the rank's retry clocks (its
      // in-flight requests stay parked in the resend queue) and keep
      // training quiesced — the synchronous step is already blocked on
      // the dead shard's handles.
      int node = static_cast<int>(msg.head.arg1);
      {
        std::lock_guard<std::mutex> lk(mu_);
        epoch_.store(msg.head.arg0);
        recovering_peers_.insert(node);
        recovering_count_.store(
            static_cast<int>(recovering_peers_.size()));
        // Death confirmed: the scheduler owns escalation from here (its
        // recovery deadline falls back to the failure SHUTDOWN), so the
        // provisional disconnect-park probe/deadline stands down.
        disc_parked_.erase(node);
      }
      BPS_METRIC_GAUGE_SET("bps_membership_epoch", epoch_.load());
      BPS_METRIC_GAUGE_SET("bps_recovering", 1);
      BPS_LOG(WARNING) << "node " << my_id_ << ": epoch "
                       << msg.head.arg0 << " PAUSE — server " << node
                       << " is being replaced";
      // Flight-recorder trigger: a recovery in progress is
      // exactly when the last N events are worth keeping — dump now so
      // even a rank that dies mid-recovery leaves a record.
      Trace::Get().Note("EPOCH_PAUSE", msg.head.arg0, node);
      Events::Get().Emit(EV_EPOCH_PAUSE, msg.head.arg0, node);
      Trace::Get().FlightDumpAuto("epoch_pause");
      if (role_ == ROLE_WORKER && peer_paused_cb_) peer_paused_cb_(node);
      break;
    }
    case CMD_EPOCH_RESUME: {
      // A replacement adopted the dead rank. Update the address book,
      // redial (workers), then let the KV layer re-seed the shard and
      // drain the parked resend queue.
      int node = static_cast<int>(msg.head.arg1);
      BPS_CHECK_EQ(msg.payload.size(), sizeof(NodeInfo));
      NodeInfo info{};
      memcpy(&info, msg.payload.data(), sizeof(NodeInfo));
      {
        std::lock_guard<std::mutex> lk(mu_);
        epoch_.store(msg.head.arg0);
        for (auto& n : nodes_) {
          if (n.id == node) n = info;
        }
      }
      BPS_METRIC_GAUGE_SET("bps_membership_epoch", epoch_.load());
      bool dialed = true;
      if (role_ == ROLE_WORKER) dialed = DialReplacement(node, info);
      {
        std::lock_guard<std::mutex> lk(mu_);
        recovering_peers_.erase(node);
        recovering_count_.store(
            static_cast<int>(recovering_peers_.size()));
        disc_parked_.erase(node);
      }
      if (role_ != ROLE_WORKER) {
        // Workers clear the flag once the re-seed completes
        // (BytePSWorker::RecoverServer); other roles are done here.
        BPS_METRIC_GAUGE_SET("bps_recovering", 0);
      }
      BPS_LOG(WARNING) << "node " << my_id_ << ": epoch "
                       << msg.head.arg0 << " RESUME — server " << node
                       << " replaced at " << info.host << ":"
                       << info.port;
      Trace::Get().Note("EPOCH_RESUME", msg.head.arg0, node);
      Events::Get().Emit(EV_EPOCH_RESUME, msg.head.arg0, node);
      Trace::Get().FlightDumpAuto("epoch_resume");
      if (role_ == ROLE_WORKER) {
        if (dialed && peer_recovered_cb_) {
          peer_recovered_cb_(node);
        } else if (!dialed && peer_lost_cb_) {
          // The replacement died before we could reach it: escalate to
          // the pre-recovery fail-fast for this rank's requests.
          peer_lost_cb_(node);
        }
      }
      break;
    }
    case CMD_REREGISTER: {
      HandleReregister(std::move(msg), fd);
      break;
    }
    case CMD_SCHED_RESUME: {
      // The restarted scheduler committed its recovery: adopt the
      // epoch and release the park (ParkOnSchedulerLost is waiting on
      // sched_resumed_; the re-issued ADDRBOOK preceded this on the
      // same connection, so nodes_ is already the rebuilt book).
      {
        std::lock_guard<std::mutex> lk(mu_);
        epoch_.store(msg.head.arg0);
        sched_resumed_ = true;
      }
      BPS_METRIC_GAUGE_SET("bps_membership_epoch", epoch_.load());
      BPS_LOG(WARNING) << "node " << my_id_
                       << ": scheduler recovery committed — epoch "
                       << msg.head.arg0 << ", " << msg.head.arg1
                       << " node(s) re-registered";
      Trace::Get().Note("SCHED_RESUME", msg.head.arg0,
                        static_cast<int>(msg.head.arg1));
      cv_.notify_all();
      break;
    }
    case CMD_JOIN_REQUEST: {
      HandleJoinRequest(std::move(msg), fd);
      break;
    }
    case CMD_LEAVE_REQUEST: {
      HandleLeaveRequest(msg, fd);
      break;
    }
    case CMD_LEAVE_ACK: {
      // Scheduler recorded our departure: this rank is out of the
      // fleet's quorum and may exit without a goodbye.
      left_.store(true);
      {
        std::lock_guard<std::mutex> lk(mu_);
        leave_acked_ = true;
      }
      cv_.notify_all();
      break;
    }
    case CMD_FLEET_PAUSE: {
      // Worker membership is changing (arg0 = new epoch, version =
      // kind, key = affected node id). For a JOIN every worker gates
      // new rounds and answers with its round counters — in-flight
      // rounds keep completing against the OLD roster, so the ack is
      // drain-free. Leaves/shrinks carry no gate: the RESUME (and the
      // server rollback) follows immediately.
      int kind = msg.head.version;
      epoch_.store(msg.head.arg0);
      BPS_METRIC_GAUGE_SET("bps_membership_epoch", epoch_.load());
      Trace::Get().Note("FLEET_PAUSE", msg.head.arg0,
                        static_cast<int>(msg.head.key), -1, kind);
      Events::Get().Emit(EV_FLEET_PAUSE, msg.head.arg0,
                         static_cast<int64_t>(msg.head.key), kind);
      Trace::Get().FlightDumpAuto("fleet_pause");
      BPS_LOG(WARNING) << "node " << my_id_ << ": epoch "
                       << msg.head.arg0 << " FLEET_PAUSE — worker "
                       << (kind == 0 ? "joining" :
                           kind == 1 ? "leaving" : "death shrink")
                       << (msg.head.tenant
                               ? " (tenant " +
                                     std::to_string(msg.head.tenant) + ")"
                               : "");
      // Tenant-scoped gate: rounds are per-tenant counters,
      // so only the JOINING tenant's workers gate and ack — another
      // tenant's rounds proceed untouched through the epoch change
      // (the scheduler only waits for the affected tenant's acks).
      if (role_ == ROLE_WORKER && kind == 0 && fleet_pause_cb_ &&
          msg.head.tenant == TenantId()) {
        fleet_pause_cb_(kind);
      }
      break;
    }
    case CMD_FLEET_PAUSE_ACK: {
      // Scheduler: one worker's rounds are gated; its counters bound
      // the join activation round. Last ack commits the change.
      BPS_CHECK_EQ(role_, ROLE_SCHEDULER);
      std::lock_guard<std::mutex> lk(mu_);
      if (!member_active_ || member_op_.kind != 0) break;
      member_round_max_ = std::max(member_round_max_, msg.head.arg0);
      member_bcast_max_ = std::max(member_bcast_max_, msg.head.arg1);
      pause_acks_pending_.erase(msg.head.sender);
      if (pause_acks_pending_.empty()) CompleteMemberOpLocked();
      break;
    }
    case CMD_FLEET_RESUME: {
      // The membership change committed: refresh the address book,
      // recount the fleet, and hand the kind-specific work to the role
      // layer (worker: sync counters + lift the gate; server: re-roster
      // + roll back a removed rank's partial contributions).
      int kind = msg.head.version;
      int affected = static_cast<int>(msg.head.key);
      int64_t jr = msg.head.arg1 >> 32;
      int64_t jb = msg.head.arg1 & 0xffffffff;
      int nw = 0;
      {
        std::lock_guard<std::mutex> lk(mu_);
        epoch_.store(msg.head.arg0);
        size_t n = msg.payload.size() / sizeof(NodeInfo);
        if (n > 0) {
          nodes_.resize(n);
          memcpy(nodes_.data(), msg.payload.data(),
                 n * sizeof(NodeInfo));
        }
        for (const auto& node : nodes_) {
          if (node.role == ROLE_WORKER) ++nw;
        }
        if (nw > 0) num_workers_.store(nw);
      }
      BPS_METRIC_GAUGE_SET("bps_membership_epoch", epoch_.load());
      BPS_METRIC_GAUGE_SET("bps_fleet_workers", num_workers_.load());
      BPS_LOG(WARNING) << "node " << my_id_ << ": epoch "
                       << msg.head.arg0 << " FLEET_RESUME — fleet is "
                       << num_workers_.load() << " worker(s)"
                       << (kind == 0 ? " (joined: " : " (removed: ")
                       << affected << ")";
      Trace::Get().Note("FLEET_RESUME", msg.head.arg0, affected, -1,
                        kind);
      Events::Get().Emit(EV_FLEET_RESUME, msg.head.arg0, affected, kind);
      Trace::Get().FlightDumpAuto("fleet_resume");
      if (role_ == ROLE_SERVER && fleet_resize_cb_) {
        fleet_resize_cb_(kind, affected, jr, jb, msg.head.tenant);
      }
      // A join's counter sync is tenant-scoped: the packed
      // activation round is in the JOINING tenant's round space, and
      // other tenants' workers never gated — jumping their counters
      // would corrupt their (independent) round numbering.
      if (role_ == ROLE_WORKER && fleet_resume_cb_ &&
          (kind != 0 || msg.head.tenant == TenantId())) {
        fleet_resume_cb_(kind, affected, jr, jb);
      }
      break;
    }
    case CMD_SHUTDOWN: {
      if (role_ == ROLE_SCHEDULER) {
        // A worker says goodbye; when all workers are done, stop the fleet.
        std::lock_guard<std::mutex> lk(mu_);
        // A rank that already LEFT (or was shrunk away) owes no
        // goodbye; a stale one must not skew the quorum count.
        bool known = false;
        for (const auto& n : nodes_) {
          if (n.id == msg.head.sender) { known = true; break; }
        }
        if (!known) break;
        // A cleanly-departing node is not a failure: stop tracking it.
        last_heartbeat_ms_.erase(msg.head.sender);
        departed_.insert(msg.head.sender);
        BPS_LOG(DEBUG) << "scheduler: goodbye from node " << msg.head.sender
                       << " (" << barrier_counts_[-1] + 1 << "/"
                       << num_workers_ << ")";
        if (++barrier_counts_[-1] == num_workers_) {
          MsgHeader h{};
          h.cmd = CMD_SHUTDOWN;
          h.sender = kSchedulerId;
          for (const auto& n : nodes_) {
            if (n.id != kSchedulerId) {
              bool ok = van_->Send(node_fd_[n.id], h);
              BPS_LOG(DEBUG) << "scheduler: SHUTDOWN -> node " << n.id
                             << (ok ? " ok" : " FAILED");
            }
          }
          shutting_down_.store(true);
          cv_.notify_all();
        }
      } else {
        BPS_LOG(DEBUG) << "node " << my_id_ << ": received fleet SHUTDOWN";
        // arg0 == 1 marks a FAILURE shutdown (dead-node broadcast from
        // the scheduler's heartbeat monitor) vs the clean teardown;
        // server entry points exit nonzero on it.
        if (msg.head.arg0 == 1) {
          failure_shutdown_.store(true);
          Trace::Get().Note("FAILURE_SHUTDOWN", 0, msg.head.sender);
          Events::Get().Emit(EV_SHUTDOWN, /*failure=*/1, msg.head.sender);
          Trace::Get().FlightDumpAuto("failure_shutdown");
        }
        shutting_down_.store(true);
        {
          std::lock_guard<std::mutex> lk(mu_);
          cv_.notify_all();
        }
        if (shutdown_cb_) shutdown_cb_();
      }
      break;
    }
    default:
      if (app_handler_) app_handler_(std::move(msg), fd);
  }
}

void Postoffice::Barrier(int group) {
  int target;
  {
    std::lock_guard<std::mutex> lk(mu_);
    target = barrier_done_[group] + 1;
  }
  MsgHeader h{};
  h.cmd = CMD_BARRIER;
  h.sender = my_id_;
  h.arg0 = group;
  van_->Send(FdOf(kSchedulerId), h);
  std::unique_lock<std::mutex> lk(mu_);
  cv_.wait(lk, [this, group, target] {
    return barrier_done_[group] >= target || shutting_down_.load();
  });
}

int Postoffice::FdOf(int node_id) {
  std::lock_guard<std::mutex> lk(mu_);
  auto it = node_fd_.find(node_id);
  BPS_CHECK(it != node_fd_.end()) << "no connection to node " << node_id;
  return it->second;
}

int Postoffice::FdOf(int node_id, int64_t key) {
  std::lock_guard<std::mutex> lk(mu_);
  auto it = node_fd_.find(node_id);
  BPS_CHECK(it != node_fd_.end()) << "no connection to node " << node_id;
  auto ex = node_extra_fds_.find(node_id);
  if (ex == node_extra_fds_.end() || ex->second.empty()) return it->second;
  size_t streams = ex->second.size() + 1;
  // Mix the key bits before reducing: keys are (tensor_id<<16)|part, so
  // a bare key % streams maps EVERY single-partition tensor to stripe 0
  // (low 16 bits all zero) and striping silently never engages —
  // exposed by the delay-proxy BDP sweep, where N stripes measured the
  // same goodput as one. splitmix64 finalizer; still deterministic per
  // key, so per-key ordering stays on one connection.
  uint64_t h = static_cast<uint64_t>(key);
  h ^= h >> 33; h *= 0xff51afd7ed558ccdULL;
  h ^= h >> 33; h *= 0xc4ceb9fe1a85ec53ULL;
  h ^= h >> 33;
  size_t s = static_cast<size_t>(h % streams);
  return s == 0 ? it->second : ex->second[s - 1];
}

bool Postoffice::TryReconnect(int node_id, int stripe) {
  NodeInfo target{};
  bool found = false;
  {
    std::lock_guard<std::mutex> lk(mu_);
    for (const auto& n : nodes_) {
      if (n.id == node_id) { target = n; found = true; break; }
    }
  }
  if (!found) return false;
  const int max_attempts =
      static_cast<int>(EnvLong("BYTEPS_RECONNECT_MAX", 3));
  long backoff_ms = EnvLong("BYTEPS_RECONNECT_BACKOFF_MS", 100);
  if (backoff_ms < 1) backoff_ms = 1;
  for (int attempt = 0; attempt < max_attempts; ++attempt) {
    if (attempt > 0) {
      // Capped exponential backoff between re-dials: a restarting peer
      // gets breathing room, a dead one costs at most the full ladder.
      long wait = backoff_ms << std::min(attempt - 1, 6);
      if (wait > 2000) wait = 2000;
      for (long slept = 0; slept < wait && !shutting_down_.load();
           slept += 50) {
        usleep(50 * 1000);
      }
    }
    if (shutting_down_.load() || van_->stopped()) return false;
    int fd = van_->Connect(target.host, target.port, 1);
    if (fd < 0) continue;
    // Re-identify on the fresh connection, exactly like the original
    // stripe dial: the server records/keeps the worker's primary fd and
    // answers requests on whichever fd they arrive on.
    MsgHeader hello{};
    hello.cmd = CMD_REGISTER;
    hello.sender = my_id_;
    hello.arg1 = role_;
    if (!van_->Send(fd, hello)) continue;
    {
      std::lock_guard<std::mutex> lk(mu_);
      if (stripe == 0) {
        node_fd_[node_id] = fd;
      } else {
        auto& extra = node_extra_fds_[node_id];
        if (static_cast<size_t>(stripe - 1) < extra.size()) {
          extra[static_cast<size_t>(stripe - 1)] = fd;
        }
      }
    }
    BPS_LOG(WARNING) << "node " << my_id_ << ": reconnected to node "
                     << node_id << " (stripe " << stripe << ", attempt "
                     << attempt + 1 << ") — resuming in-flight requests";
    Trace::Get().Note("RECONNECT", stripe, node_id);
    return true;
  }
  BPS_LOG(WARNING) << "node " << my_id_ << ": reconnect to node "
                   << node_id << " failed after " << max_attempts
                   << " attempt(s) — treating peer as dead";
  return false;
}

void Postoffice::BroadcastFailureLocked(const std::string& why) {
  BPS_LOG(WARNING) << "scheduler: " << why
                   << " — broadcasting failure shutdown";
  Trace::Get().Note("FAILURE_SHUTDOWN");
  Events::Get().Emit(EV_SHUTDOWN, /*failure=*/1, my_id_);
  Trace::Get().FlightDumpAuto("failure_shutdown");
  MsgHeader h{};
  h.cmd = CMD_SHUTDOWN;
  h.sender = kSchedulerId;
  h.arg0 = 1;  // failure-triggered
  for (const auto& n : nodes_) {
    if (n.id == kSchedulerId) continue;
    auto it = node_fd_.find(n.id);
    if (it != node_fd_.end()) van_->Send(it->second, h);
  }
  shutting_down_.store(true);
  cv_.notify_all();
}

void Postoffice::StartRecoveryLocked(int node_id) {
  Trace::Get().Note("EPOCH_PAUSE", epoch_.load() + 1, node_id);
  Events::Get().Emit(EV_EPOCH_PAUSE, epoch_.load() + 1, node_id);
  Trace::Get().FlightDumpAuto("epoch_pause");
  epoch_.fetch_add(1);
  recovering_node_ = node_id;
  recovery_deadline_ms_ = NowMs() + RecoveryTimeoutMs();
  recovering_peers_.insert(node_id);
  recovering_count_.store(static_cast<int>(recovering_peers_.size()));
  // Stop re-detecting the dead rank: it is no longer "dead", it is
  // "being replaced". Heartbeat tracking resumes with the replacement.
  last_heartbeat_ms_.erase(node_id);
  BPS_METRIC_GAUGE_SET("bps_membership_epoch", epoch_.load());
  BPS_METRIC_GAUGE_SET("bps_recovering", 1);
  BPS_LOG(WARNING) << "scheduler: server " << node_id
                   << " missed heartbeats — epoch " << epoch_.load()
                   << " RECOVERY (waiting up to " << RecoveryTimeoutMs()
                   << " ms for a replacement with DMLC_RECOVER_RANK="
                   << node_id - ServerId(0) << ")";
  MsgHeader h{};
  h.cmd = CMD_EPOCH_PAUSE;
  h.sender = kSchedulerId;
  h.arg0 = epoch_.load();
  h.arg1 = node_id;
  for (const auto& n : nodes_) {
    if (n.id == kSchedulerId || n.id == node_id) continue;
    auto it = node_fd_.find(n.id);
    if (it != node_fd_.end()) van_->Send(it->second, h);
  }
}

void Postoffice::HandleRecoverRegister(int fd, const NodeInfo& info,
                                       int rank) {
  std::lock_guard<std::mutex> lk(mu_);
  if (!addrbook_ready_) {
    BPS_LOG(WARNING) << "scheduler: recovery registration for server "
                        "rank " << rank
                     << " before fleet formation — ignored";
    return;
  }
  if (rank < 0 || rank >= num_servers_) {
    BPS_LOG(WARNING) << "scheduler: recovery registration with "
                        "out-of-range DMLC_RECOVER_RANK=" << rank
                     << " (fleet has " << num_servers_
                     << " servers) — ignored";
    return;
  }
  int id = ServerId(rank);
  if (recovering_node_ >= 0 && recovering_node_ != id) {
    BPS_LOG(WARNING) << "scheduler: replacement registered for server "
                     << id << " but node " << recovering_node_
                     << " is the one under recovery — ignored";
    return;
  }
  if (recovering_node_ < 0) {
    // The supervisor respawned the server BEFORE the heartbeat monitor
    // declared it dead (the common fast path). Open the recovery window
    // now; the PAUSE and the RESUME below arrive back-to-back, in
    // order, on each node's scheduler connection.
    BPS_LOG(WARNING) << "scheduler: replacement for server " << id
                     << " registered ahead of dead-node detection — "
                        "starting recovery inline";
    StartRecoveryLocked(id);
  }
  Trace::Get().Note("RECOVER_REGISTER", rank, id);
  Events::Get().Emit(EV_SERVER_RECOVER, id, rank);
  NodeInfo adopted = info;
  adopted.id = id;
  adopted.role = ROLE_SERVER;
  for (auto& n : nodes_) {
    if (n.id == id) n = adopted;
  }
  node_fd_[id] = fd;
  last_heartbeat_ms_[id] = NowMs();
  recovering_node_ = -1;
  recovery_deadline_ms_ = 0;
  recovering_peers_.erase(id);
  recovering_count_.store(static_cast<int>(recovering_peers_.size()));
  BPS_METRIC_GAUGE_SET("bps_recovering", 0);
  BPS_METRIC_COUNTER_ADD("bps_recoveries_total", 1);
  // The replacement gets its id + the current address book directly
  // (fleet formation already happened; it must not wait for one).
  MsgHeader ab{};
  ab.cmd = CMD_ADDRBOOK;
  ab.sender = kSchedulerId;
  ab.arg0 = id;
  van_->Send(fd, ab, nodes_.data(), nodes_.size() * sizeof(NodeInfo));
  // Resume the fleet: every node updates its book and workers redial,
  // re-seed the shard, and drain their parked resend queues.
  MsgHeader rs{};
  rs.cmd = CMD_EPOCH_RESUME;
  rs.sender = kSchedulerId;
  rs.arg0 = epoch_.load();
  rs.arg1 = id;
  for (const auto& n : nodes_) {
    if (n.id == kSchedulerId || n.id == id) continue;
    auto it = node_fd_.find(n.id);
    if (it != node_fd_.end()) {
      van_->Send(it->second, rs, &adopted, sizeof(adopted));
    }
  }
  BPS_LOG(WARNING) << "scheduler: server " << id << " hot-replaced at "
                   << adopted.host << ":" << adopted.port << " (epoch "
                   << epoch_.load() << ")";
  Trace::Get().Note("EPOCH_RESUME", epoch_.load(), id);
  Events::Get().Emit(EV_EPOCH_RESUME, epoch_.load(), id);
  Trace::Get().FlightDumpAuto("epoch_resume");
}

// --- read-replica admission --------------------------------------

void Postoffice::AdmitReplicaLocked(int fd, const NodeInfo& info_in,
                                    int primary_rank) {
  // A replica rides the elastic rank allocator: a fresh, never-reused
  // id past every training rank, so nothing in the worker/server id
  // arithmetic can collide with it. It joins the roster (book entry,
  // heartbeat row, shutdown broadcast) but neither the formation count
  // nor num_workers_ — the CMD_ADDRBOOK handler counts ROLE_WORKER
  // entries only, so every node's divisor stays untouched.
  if (primary_rank < 0 || primary_rank >= num_servers_) {
    BPS_LOG(WARNING) << "scheduler: replica registered with "
                        "out-of-range BYTEPS_REPLICA_OF=" << primary_rank
                     << " (fleet has " << num_servers_
                     << " servers) — admitted anyway; it will idle "
                        "until a valid primary exists";
  }
  NodeInfo adopted = info_in;
  const int id = WorkerId(next_worker_rank_++);
  adopted.id = id;
  adopted.role = ROLE_REPLICA;
  nodes_.push_back(adopted);
  node_fd_[id] = fd;
  last_heartbeat_ms_[id] = NowMs();
  replica_count_ += 1;
  BPS_METRIC_GAUGE_SET("bps_fleet_replicas", replica_count_);
  Trace::Get().Instant("register", id, id, -1, ROLE_REPLICA);
  Trace::Get().Note("REPLICA_ADMIT", primary_rank, id);
  Events::Get().Emit(EV_JOIN, id, /*replica=*/1, primary_rank);
  // Direct book, recovery-registration style: formation (if any)
  // already happened and must not be re-opened for a read-only node.
  MsgHeader ab{};
  ab.cmd = CMD_ADDRBOOK;
  ab.sender = kSchedulerId;
  ab.arg0 = id;
  van_->Send(fd, ab, nodes_.data(), nodes_.size() * sizeof(NodeInfo));
  BPS_LOG(WARNING) << "scheduler: admitted read replica " << id
                   << " at " << adopted.host << ":" << adopted.port
                   << " (primary server rank " << primary_rank << ")";
}

bool Postoffice::NodeOf(int node_id, NodeInfo* out) {
  std::lock_guard<std::mutex> lk(mu_);
  for (const auto& n : nodes_) {
    if (n.id == node_id) {
      if (out) *out = n;
      return true;
    }
  }
  return false;
}

// --- scheduler fail-over -----------------------------------------

bool Postoffice::ParkOnSchedulerLost() {
  const int64_t window = SchedRecoveryTimeoutMs();
  const int64_t start = NowMs();
  sched_lost_.store(true);
  {
    std::lock_guard<std::mutex> lk(mu_);
    sched_resumed_ = false;
  }
  BPS_METRIC_GAUGE_SET("bps_sched_lost", 1);
  BPS_LOG(WARNING) << "node " << my_id_
                   << ": scheduler connection lost — parking "
                      "(fail-over armed, window " << window
                   << " ms); data plane keeps draining against the "
                      "last committed address book";
  Trace::Get().Note("SCHED_LOST_PARK", window);
  Events::Get().Emit(EV_SCHED_PARK, window);
  // Park dump: the pre-crash control-plane trail is exactly what a
  // post-mortem needs if the recovery then fails too.
  Trace::Get().FlightDumpAuto("scheduler_lost");
  long backoff_ms = EnvLong("BYTEPS_RECONNECT_BACKOFF_MS", 100);
  if (backoff_ms < 1) backoff_ms = 1;
  int attempt = 0;
  while (!shutting_down_.load() && !van_->stopped() &&
         !SchedRecovery::Expired(NowMs(), start, window)) {
    if (attempt > 0) {
      // The capped backoff ladder: a restarting scheduler gets
      // breathing room, and past the cap we probe every 2 s until the
      // window expires.
      long wait = backoff_ms << std::min(attempt - 1, 6);
      if (wait > 2000) wait = 2000;
      for (long slept = 0; slept < wait && !shutting_down_.load();
           slept += 50) {
        usleep(50 * 1000);
      }
    }
    ++attempt;
    int fd = van_->Connect(sched_host_, sched_port_, 1);
    if (fd < 0) continue;
    // Re-register with full committed state: own NodeInfo + the last
    // committed address book (the scheduler rebuilds everything from
    // the fleet's quorum of these).
    MsgHeader h{};
    h.cmd = CMD_REREGISTER;
    h.tenant = TenantId();
    h.sender = my_id_;
    h.arg0 = epoch_.load();
    h.key = round_watermark_fn_ ? round_watermark_fn_() : 0;
    std::vector<NodeInfo> payload;
    {
      std::lock_guard<std::mutex> lk(mu_);
      NodeInfo self{};
      self.id = my_id_;
      self.role = role_;
      int64_t max_worker = 0;
      for (const auto& n : nodes_) {
        if (n.id == my_id_) self = n;
        if (n.role == ROLE_WORKER) {
          max_worker = std::max<int64_t>(max_worker, n.id);
        }
      }
      h.arg1 = max_worker;  // rank-allocator high-water hint
      payload.reserve(nodes_.size() + 1);
      payload.push_back(self);
      payload.insert(payload.end(), nodes_.begin(), nodes_.end());
    }
    if (!van_->Send(fd, h, payload.data(),
                    payload.size() * sizeof(NodeInfo))) {
      continue;
    }
    {
      std::lock_guard<std::mutex> lk(mu_);
      node_fd_[kSchedulerId] = fd;
    }
    BPS_LOG(WARNING) << "node " << my_id_
                     << ": re-registered with the scheduler (attempt "
                     << attempt << ") — awaiting recovery commit";
    // Wait out the REMAINING window for the commit. No re-dial once a
    // REREGISTER was delivered: a scheduler that dies AGAIN
    // mid-recovery is out of scope (the window expiry below is the
    // clean fail-stop).
    std::unique_lock<std::mutex> lk(mu_);
    cv_.wait_for(lk,
                 std::chrono::milliseconds(std::max<int64_t>(
                     1, start + window - NowMs())),
                 [this] {
                   return sched_resumed_ || shutting_down_.load();
                 });
    if (!sched_resumed_) break;  // window expired (or shutting down)
    lk.unlock();
    sched_lost_.store(false);
    BPS_METRIC_GAUGE_SET("bps_sched_lost", 0);
    BPS_METRIC_COUNTER_ADD("bps_sched_recoveries_total", 1);
    // This node's park->resume pause, scraped by bench --sched-recovery.
    BPS_METRIC_GAUGE_SET("bps_sched_park_ms", NowMs() - start);
    BPS_LOG(WARNING) << "node " << my_id_
                     << ": scheduler recovered (epoch " << epoch_.load()
                     << ") after " << NowMs() - start << " ms parked";
    Trace::Get().Note("SCHED_RECOVERED", NowMs() - start);
    // Commit dump: bookends the park dump above (satellite).
    Trace::Get().FlightDumpAuto("sched_recovered");
    if (sched_recovered_cb_) sched_recovered_cb_();
    return true;
  }
  sched_lost_.store(false);
  BPS_METRIC_GAUGE_SET("bps_sched_lost", 0);
  BPS_LOG(WARNING) << "node " << my_id_
                   << ": scheduler did not recover within "
                   << window << " ms — escalating to the fail-stop";
  return false;
}

void Postoffice::HandleReregister(Message&& msg, int fd) {
  if (role_ != ROLE_SCHEDULER) {
    BPS_LOG(WARNING) << "node " << my_id_
                     << ": unexpected CMD_REREGISTER — ignored";
    return;
  }
  const size_t n = msg.payload.size() / sizeof(NodeInfo);
  if (n < 1 || msg.payload.size() % sizeof(NodeInfo) != 0) {
    BPS_LOG(WARNING) << "scheduler: malformed CMD_REREGISTER from node "
                     << msg.head.sender << " (" << msg.payload.size()
                     << " bytes) — ignored";
    return;
  }
  const int id = msg.head.sender;
  SchedRecovery::Report r;
  memcpy(&r.self, msg.payload.data(), sizeof(NodeInfo));
  r.epoch = msg.head.arg0;
  r.rank_hint = msg.head.arg1;
  r.rounds = msg.head.key;
  r.book.resize(n - 1);
  if (n > 1) {
    memcpy(r.book.data(), msg.payload.data() + sizeof(NodeInfo),
           (n - 1) * sizeof(NodeInfo));
  }
  std::lock_guard<std::mutex> lk(mu_);
  if (addrbook_ready_) {
    // Already committed (or this scheduler never crashed and a chaos
    // reset only broke the node's connection): answer idempotently
    // with a direct ADDRBOOK + SCHED_RESUME so the parked node
    // resumes against current state. Duplicate REREGISTERs across
    // chaos resets land here too.
    node_fd_[id] = fd;
    if (!departed_.count(id)) last_heartbeat_ms_[id] = NowMs();
    BPS_LOG(WARNING) << "scheduler: node " << id
                     << " re-registered against committed state — "
                        "direct resume (epoch " << epoch_.load() << ")";
    MsgHeader ab{};
    ab.cmd = CMD_ADDRBOOK;
    ab.sender = kSchedulerId;
    ab.arg0 = id;
    van_->Send(fd, ab, nodes_.data(), nodes_.size() * sizeof(NodeInfo));
    MsgHeader rs{};
    rs.cmd = CMD_SCHED_RESUME;
    rs.sender = kSchedulerId;
    rs.arg0 = epoch_.load();
    rs.arg1 = static_cast<int64_t>(nodes_.size()) - 1;
    van_->Send(fd, rs);
    return;
  }
  if (!sched_recover_mode_) {
    BPS_LOG(WARNING) << "scheduler: CMD_REREGISTER from node " << id
                     << " before fleet formation and not in recovery "
                        "mode — ignored";
    return;
  }
  sched_rec_.Ingest(id, std::move(r));
  node_fd_[id] = fd;
  const int rereg = sched_rec_.Reregistered();
  const int expected =
      static_cast<int>(sched_rec_.ExpectedIds().size());
  BPS_METRIC_GAUGE_SET("bps_sched_rereg", rereg);
  BPS_METRIC_GAUGE_SET("bps_sched_rereg_expected", expected);
  BPS_LOG(WARNING) << "scheduler: node " << id
                   << " re-registered (epoch " << msg.head.arg0 << ") — "
                   << rereg << "/" << expected << " toward quorum";
  Trace::Get().Note("SCHED_REREGISTER", msg.head.arg0, id);
  Events::Get().Emit(EV_SCHED_REREGISTER, id, msg.head.arg0);
  if (sched_rec_.Conflict()) {
    // Same-epoch books disagree: the old scheduler died mid-commit
    // and there is no single committed state to resume from.
    sched_rec_fail_ =
        "conflicting same-epoch address books across "
        "re-registrations (split-brain) — clean fail-stop";
    cv_.notify_all();
    return;
  }
  if (sched_rec_.QuorumMet()) CommitSchedRecoveryLocked();
}

void Postoffice::CommitSchedRecoveryLocked() {
  const int64_t commit_ms = NowMs();
  nodes_ = sched_rec_.RebuiltBook();
  epoch_.store(sched_rec_.AdoptedEpoch());
  // Worker ranks are never reused: the allocator restarts past every
  // id any survivor has seen or hinted at.
  next_worker_rank_ =
      sched_rec_.NextWorkerId(num_servers_) - 1 - num_servers_;
  int nw = 0;
  std::map<int, int> by_tenant;
  for (const auto& n : nodes_) {
    if (n.role != ROLE_WORKER) continue;
    ++nw;
    RoundStats::Get().SetNodeTenant(n.id, n.tenant);
    ++by_tenant[n.tenant];
  }
  if (nw > 0) num_workers_.store(nw);
  // The bugfix satellite: a restarted scheduler's heartbeat table is
  // EMPTY — checked raw, the first monitor tick would declare every
  // rank dead at once. Seed every rebuilt-book id at commit time, so
  // the earliest possible death verdict is commit + timeout.
  for (const auto& kv : sched_rec_.SeedHeartbeats(commit_ms)) {
    last_heartbeat_ms_[kv.first] = kv.second;
  }
  addrbook_ready_ = true;
  sched_recover_mode_ = false;
  BPS_METRIC_GAUGE_SET("bps_sched_recovering", 0);
  BPS_METRIC_COUNTER_ADD("bps_sched_recoveries_total", 1);
  BPS_METRIC_GAUGE_SET("bps_sched_recovery_ms",
                       commit_ms - sched_rec_start_ms_);
  BPS_METRIC_GAUGE_SET("bps_membership_epoch", epoch_.load());
  BPS_METRIC_GAUGE_SET("bps_fleet_workers", num_workers_.load());
  BPS_METRIC_GAUGE_SET("bps_fleet_tenants",
                       static_cast<int64_t>(by_tenant.size()));
  BPS_LOG(WARNING) << "scheduler: recovery committed in "
                   << commit_ms - sched_rec_start_ms_ << " ms — epoch "
                   << epoch_.load() << ", " << num_workers_.load()
                   << " worker(s), " << num_servers_
                   << " server(s), next worker rank "
                   << next_worker_rank_ << ", rounds watermark "
                   << sched_rec_.RoundsWatermark();
  Trace::Get().Note("SCHED_RECOVERY_COMMIT", epoch_.load(),
                    sched_rec_.Reregistered());
  Events::Get().Emit(EV_SCHED_RECOVERY_COMMIT, epoch_.load(),
                     sched_rec_.Reregistered());
  Trace::Get().FlightDumpAuto("sched_recovery_commit");
  // Broadcast exactly like an elastic commit: a re-issued ADDRBOOK
  // (arg0 = the receiver's own id) followed by the RESUME, in order,
  // on each node's re-registered connection.
  const int64_t rereg = sched_rec_.Reregistered();
  for (const auto& n : nodes_) {
    if (n.id == kSchedulerId) continue;
    auto it = node_fd_.find(n.id);
    if (it == node_fd_.end()) continue;
    MsgHeader ab{};
    ab.cmd = CMD_ADDRBOOK;
    ab.sender = kSchedulerId;
    ab.arg0 = n.id;
    van_->Send(it->second, ab, nodes_.data(),
               nodes_.size() * sizeof(NodeInfo));
    MsgHeader rs{};
    rs.cmd = CMD_SCHED_RESUME;
    rs.sender = kSchedulerId;
    rs.arg0 = epoch_.load();
    rs.arg1 = rereg;
    van_->Send(it->second, rs);
  }
  cv_.notify_all();
  // Release joins that arrived mid-recovery (an elastic join queued
  // across the outage): they enter the ordinary membership queue now
  // that there is a committed book to join.
  for (auto& bj : buffered_joins_) {
    MemberOp op;
    op.kind = 0;
    op.fd = bj.second;
    op.info = bj.first;
    op.tenant = bj.first.tenant;
    BPS_LOG(WARNING) << "scheduler: releasing worker join queued "
                        "across the outage (" << op.info.host << ":"
                     << op.info.port << ")";
    member_queue_.push_back(std::move(op));
  }
  buffered_joins_.clear();
  if (!member_queue_.empty() && !member_active_) {
    MemberOp next = std::move(member_queue_.front());
    member_queue_.pop_front();
    StartMemberOpLocked(std::move(next));
  }
}

// --- elastic worker membership ------------------------------------

void Postoffice::HandleJoinRequest(Message&& msg, int fd) {
  if (role_ != ROLE_SCHEDULER) {
    BPS_LOG(WARNING) << "node " << my_id_
                     << ": unexpected CMD_JOIN_REQUEST — ignored";
    return;
  }
  BPS_CHECK_EQ(msg.payload.size(), sizeof(NodeInfo));
  MemberOp op;
  op.kind = 0;
  op.fd = fd;
  memcpy(&op.info, msg.payload.data(), sizeof(NodeInfo));
  op.tenant = op.info.tenant;  // tenant-scoped gate + roster epoch
  std::lock_guard<std::mutex> lk(mu_);
  if (!addrbook_ready_) {
    if (sched_recover_mode_ && ElasticEnabled()) {
      // A joiner dialed into a scheduler that is itself recovering
      //: queue the join until the recovery commits — the
      // joiner's own formation bound (PS_TOPOLOGY_TIMEOUT) covers the
      // wait, and the commit releases the queue in arrival order.
      BPS_LOG(WARNING) << "scheduler: join request from "
                       << op.info.host << ":" << op.info.port
                       << " during scheduler recovery — queued until "
                          "the recovery commits";
      buffered_joins_.emplace_back(op.info, fd);
      return;
    }
    BPS_LOG(WARNING) << "scheduler: join request before fleet formation "
                        "— ignored (join a RUNNING fleet)";
    return;
  }
  if (!ElasticEnabled()) {
    // Ignored, not crashed: the joiner's own PS_TOPOLOGY_TIMEOUT fails
    // it loudly with the fix named in its log.
    BPS_LOG(WARNING) << "scheduler: join request but BYTEPS_ELASTIC is "
                        "off — ignored (set BYTEPS_ELASTIC=1 fleet-wide "
                        "to allow membership changes)";
    return;
  }
  BPS_LOG(WARNING) << "scheduler: worker join request from "
                   << op.info.host << ":" << op.info.port;
  member_queue_.push_back(std::move(op));
  if (!member_active_) {
    MemberOp next = std::move(member_queue_.front());
    member_queue_.pop_front();
    StartMemberOpLocked(std::move(next));
  }
}

void Postoffice::HandleLeaveRequest(const Message& msg, int fd) {
  if (role_ != ROLE_SCHEDULER) return;
  const int id = msg.head.sender;
  std::lock_guard<std::mutex> lk(mu_);
  bool known = false;
  for (const auto& n : nodes_) {
    if (n.id == id && n.role == ROLE_WORKER) { known = true; break; }
  }
  if (!known || !ElasticEnabled()) {
    BPS_LOG(WARNING) << "scheduler: leave request from node " << id
                     << (known ? " but BYTEPS_ELASTIC is off"
                               : " which is not a fleet worker")
                     << " — ignored";
    return;
  }
  // The leaver's heartbeats stop the moment it exits; stop failure
  // tracking NOW so its departure can never read as a death.
  last_heartbeat_ms_.erase(id);
  departed_.insert(id);
  // Unblock the leaver immediately: its drained state is all the fleet
  // needs from it, and the RESUME below never addresses it.
  MsgHeader ack{};
  ack.cmd = CMD_LEAVE_ACK;
  ack.sender = kSchedulerId;
  van_->Send(fd, ack);
  BPS_LOG(WARNING) << "scheduler: worker " << id << " leaving gracefully";
  MemberOp op;
  op.kind = 1;
  op.node_id = id;
  op.tenant = TenantOfNodeLocked(id);
  member_queue_.push_back(std::move(op));
  if (!member_active_) {
    MemberOp next = std::move(member_queue_.front());
    member_queue_.pop_front();
    StartMemberOpLocked(std::move(next));
  }
}

int Postoffice::TenantOfNodeLocked(int node_id) const {
  for (const auto& n : nodes_) {
    if (n.id == node_id) return n.tenant;
  }
  return 0;
}

std::set<int> Postoffice::TenantWorkers(uint16_t tenant) {
  std::lock_guard<std::mutex> lk(mu_);
  std::set<int> out;
  for (const auto& n : nodes_) {
    if (n.role == ROLE_WORKER &&
        static_cast<uint16_t>(n.tenant) == tenant) {
      out.insert(n.id);
    }
  }
  return out;
}

int Postoffice::TenantWorkerCount(uint16_t tenant) {
  std::lock_guard<std::mutex> lk(mu_);
  int count = 0;
  for (const auto& n : nodes_) {
    if (n.role == ROLE_WORKER &&
        static_cast<uint16_t>(n.tenant) == tenant) {
      ++count;
    }
  }
  return count;
}

int Postoffice::TenantWeightOf(uint16_t tenant) {
  std::lock_guard<std::mutex> lk(mu_);
  int w = 0;
  for (const auto& n : nodes_) {
    if (n.role == ROLE_WORKER &&
        static_cast<uint16_t>(n.tenant) == tenant) {
      w = std::max(w, n.weight);
    }
  }
  return w > 0 ? w : 1;
}

int Postoffice::TenantOfNode(int node_id) {
  std::lock_guard<std::mutex> lk(mu_);
  for (const auto& n : nodes_) {
    if (n.id == node_id) return n.tenant;
  }
  return -1;
}

std::map<uint16_t, std::pair<int, int>> Postoffice::TenantRoster() {
  std::lock_guard<std::mutex> lk(mu_);
  std::map<uint16_t, std::pair<int, int>> out;
  for (const auto& n : nodes_) {
    if (n.role != ROLE_WORKER) continue;
    auto& e = out[static_cast<uint16_t>(n.tenant)];
    ++e.first;
    e.second = std::max(e.second, n.weight > 0 ? n.weight : 1);
  }
  return out;
}

void Postoffice::StartMemberOpLocked(MemberOp&& op) {
  member_active_ = true;
  member_op_ = std::move(op);
  member_start_ms_ = NowMs();
  member_deadline_ms_ = member_start_ms_ + ElasticTimeoutMs();
  member_round_max_ = 0;
  member_bcast_max_ = 0;
  pause_acks_pending_.clear();
  epoch_.fetch_add(1);
  BPS_METRIC_GAUGE_SET("bps_membership_epoch", epoch_.load());
  BPS_METRIC_GAUGE_SET("bps_fleet_resizing", 1);
  Trace::Get().Note("FLEET_PAUSE", epoch_.load(), member_op_.node_id,
                    -1, member_op_.kind);
  Events::Get().Emit(EV_FLEET_PAUSE, epoch_.load(), member_op_.node_id,
                     member_op_.kind);
  Trace::Get().FlightDumpAuto("fleet_pause");
  BPS_LOG(WARNING) << "scheduler: epoch " << epoch_.load()
                   << " worker membership change — "
                   << (member_op_.kind == 0 ? "join" :
                       member_op_.kind == 1 ? "graceful leave" :
                       "death shrink")
                   << (member_op_.kind == 0 ? ""
                       : " of node " + std::to_string(member_op_.node_id));
  MsgHeader h{};
  h.cmd = CMD_FLEET_PAUSE;
  // Tenant-scoped change: every rank sees the epoch bump,
  // but only the affected tenant's workers gate rounds and ack — round
  // counters are per-tenant, so another tenant's training is untouched.
  h.tenant = static_cast<uint16_t>(member_op_.tenant);
  h.sender = kSchedulerId;
  h.arg0 = epoch_.load();
  h.version = member_op_.kind;
  h.key = member_op_.node_id;
  for (const auto& n : nodes_) {
    if (n.id == kSchedulerId || n.id == member_op_.node_id) continue;
    auto it = node_fd_.find(n.id);
    if (it != node_fd_.end()) van_->Send(it->second, h);
    if (member_op_.kind == 0 && n.role == ROLE_WORKER &&
        n.tenant == member_op_.tenant) {
      pause_acks_pending_.insert(n.id);
    }
  }
  // Joins wait for every worker's gated-counter ack (the activation
  // round is their max); removals commit immediately — the departed
  // rank is in no incomplete round once the server rollback runs.
  if (member_op_.kind != 0 || pause_acks_pending_.empty()) {
    CompleteMemberOpLocked();
  }
}

void Postoffice::CompleteMemberOpLocked() {
  MemberOp& op = member_op_;
  const int64_t packed =
      (member_round_max_ << 32) | (member_bcast_max_ & 0xffffffff);
  if (op.kind == 0) {
    // Fresh, never-reused rank: a joined worker's id (and therefore
    // its trace identity and monitor endpoint port) cannot collide
    // with any past member's.
    const int rank = next_worker_rank_++;
    const int id = WorkerId(rank);
    NodeInfo adopted = op.info;
    adopted.id = id;
    adopted.role = ROLE_WORKER;
    nodes_.push_back(adopted);
    node_fd_[id] = op.fd;
    last_heartbeat_ms_[id] = NowMs();
    num_workers_.fetch_add(1);
    op.node_id = id;
    RoundStats::Get().SetNodeTenant(id, adopted.tenant);
    BPS_METRIC_COUNTER_ADD("bps_worker_joins_total", 1);
    // The joiner's direct ADDRBOOK: assigned id + the round boundary
    // it enters at (every existing worker's counters were gated at or
    // below it, so the joiner's first push is the first round the new
    // roster expects it in).
    MsgHeader ab{};
    ab.cmd = CMD_ADDRBOOK;
    ab.sender = kSchedulerId;
    ab.arg0 = id;
    ab.arg1 = packed;
    van_->Send(op.fd, ab, nodes_.data(),
               nodes_.size() * sizeof(NodeInfo));
    BPS_LOG(WARNING) << "scheduler: worker joined as rank " << rank
                     << " (node " << id << ", round "
                     << member_round_max_ << ") — fleet is "
                     << num_workers_.load() << " worker(s)";
  } else {
    for (auto it = nodes_.begin(); it != nodes_.end(); ++it) {
      if (it->id == op.node_id) {
        nodes_.erase(it);
        break;
      }
    }
    // The fd is NOT force-closed here: a leaver closes its own side at
    // exit and a dead worker's socket is already gone — the van owns
    // reaping either way.
    node_fd_.erase(op.node_id);
    num_workers_.fetch_sub(1);
    BPS_METRIC_COUNTER_ADD("bps_worker_leaves_total", 1);
    BPS_LOG(WARNING) << "scheduler: worker " << op.node_id
                     << (op.kind == 1 ? " left" : " shrunk away")
                     << " — fleet is " << num_workers_.load()
                     << " worker(s)";
  }
  BPS_METRIC_GAUGE_SET("bps_fleet_workers", num_workers_.load());
  BPS_METRIC_GAUGE_SET("bps_fleet_resizing", 0);
  BPS_METRIC_GAUGE_SET("bps_epoch_change_ms",
                       NowMs() - member_start_ms_);
  Trace::Get().Note("FLEET_RESUME", epoch_.load(), op.node_id, -1,
                    op.kind);
  Events::Get().Emit(EV_FLEET_RESUME, epoch_.load(), op.node_id, op.kind);
  // The commit IS the join/leave moment fleet-wide — journal it as the
  // membership event post-mortems sort by, not the pause that opened it.
  Events::Get().Emit(op.kind == 0 ? EV_JOIN : EV_LEAVE, op.node_id,
                     /*replica=*/0);
  Trace::Get().FlightDumpAuto("fleet_resume");
  {
    // Live tenant-count gauge (a tenant appears with its first worker
    // and disappears with its last).
    std::map<int, int> by_tenant;
    for (const auto& n : nodes_) {
      if (n.role == ROLE_WORKER) ++by_tenant[n.tenant];
    }
    BPS_METRIC_GAUGE_SET("bps_fleet_tenants",
                         static_cast<int64_t>(by_tenant.size()));
  }
  MsgHeader rs{};
  rs.cmd = CMD_FLEET_RESUME;
  rs.tenant = static_cast<uint16_t>(op.tenant);
  rs.sender = kSchedulerId;
  rs.arg0 = epoch_.load();
  rs.version = op.kind;
  rs.key = op.node_id;
  rs.arg1 = packed;
  for (const auto& n : nodes_) {
    if (n.id == kSchedulerId) continue;
    auto it = node_fd_.find(n.id);
    if (it != node_fd_.end()) {
      van_->Send(it->second, rs, nodes_.data(),
                 nodes_.size() * sizeof(NodeInfo));
    }
  }
  member_active_ = false;
  member_deadline_ms_ = 0;
  if (num_workers_.load() == 0) {
    // The last worker left: nobody remains to say goodbye, so the
    // all-goodbyes quorum can never fire — tear down cleanly now.
    BPS_LOG(WARNING) << "scheduler: last worker left — clean fleet "
                        "shutdown";
    MsgHeader sh{};
    sh.cmd = CMD_SHUTDOWN;
    sh.sender = kSchedulerId;
    for (const auto& n : nodes_) {
      if (n.id == kSchedulerId) continue;
      auto it = node_fd_.find(n.id);
      if (it != node_fd_.end()) van_->Send(it->second, sh);
    }
    shutting_down_.store(true);
    cv_.notify_all();
    return;
  }
  if (!member_queue_.empty()) {
    MemberOp next = std::move(member_queue_.front());
    member_queue_.pop_front();
    StartMemberOpLocked(std::move(next));
  }
}

void Postoffice::SendFleetPauseAck(int64_t max_round, int64_t max_bcast) {
  MsgHeader h{};
  h.cmd = CMD_FLEET_PAUSE_ACK;
  h.sender = my_id_;
  h.arg0 = max_round;
  h.arg1 = max_bcast;
  van_->Send(FdOf(kSchedulerId), h);
}

bool Postoffice::RequestLeave() {
  if (role_ != ROLE_WORKER) return false;
  MsgHeader h{};
  h.cmd = CMD_LEAVE_REQUEST;
  h.sender = my_id_;
  if (!van_->Send(FdOf(kSchedulerId), h)) return false;
  std::unique_lock<std::mutex> lk(mu_);
  cv_.wait_for(lk, std::chrono::seconds(60), [this] {
    return leave_acked_ || shutting_down_.load();
  });
  if (leave_acked_) {
    BPS_LOG(WARNING) << "worker " << my_id_
                     << ": graceful leave acknowledged — departing";
  }
  return leave_acked_;
}

bool Postoffice::DialReplacement(int node_id, const NodeInfo& info) {
  int streams = 1;
  if (const char* sv = getenv("BYTEPS_VAN_STREAMS")) {
    streams = atoi(sv);
    if (streams < 1) streams = 1;
  }
  std::vector<int> fds;
  // On any stripe failing, close everything dialed so far — fds not yet
  // registered in node_fd_/node_extra_fds_ would otherwise leak (the
  // caller falls back to the fail-stop path, but that may be minutes of
  // retries away).
  auto abandon = [&](int extra_fd) {
    if (extra_fd >= 0) van_->CloseConn(extra_fd);
    for (int f : fds) van_->CloseConn(f);
    return false;
  };
  for (int s = 0; s < streams; ++s) {
    // The replacement is already registered with the scheduler, so its
    // listener is up: a handful of dial attempts is plenty.
    int fd = van_->Connect(info.host, info.port, 50);
    if (fd < 0) {
      BPS_LOG(WARNING) << "node " << my_id_
                       << ": cannot reach replacement server " << node_id
                       << " at " << info.host << ":" << info.port;
      return abandon(-1);
    }
    MsgHeader hello{};
    hello.cmd = CMD_REGISTER;
    hello.sender = my_id_;
    hello.arg1 = role_;
    if (!van_->Send(fd, hello)) return abandon(fd);
    fds.push_back(fd);
  }
  std::lock_guard<std::mutex> lk(mu_);
  node_fd_[node_id] = fds[0];
  if (fds.size() > 1) {
    node_extra_fds_[node_id].assign(fds.begin() + 1, fds.end());
  } else {
    node_extra_fds_.erase(node_id);
  }
  return true;
}

void Postoffice::HeartbeatLoop() {
  double interval = EnvSeconds("PS_HEARTBEAT_INTERVAL", 5.0);
  while (!shutting_down_.load() && !van_->stopped()) {
    MsgHeader h{};
    h.cmd = CMD_HEARTBEAT;
    h.sender = my_id_;
    h.arg0 = NowUs();  // echoed back for the clock-offset estimate
    int fd = -1;
    {
      std::lock_guard<std::mutex> lk(mu_);
      auto it = node_fd_.find(kSchedulerId);
      if (it == node_fd_.end()) break;
      fd = it->second;
    }
    // Piggyback the rounds completed since the last beat as
    // a versioned sub-payload. Heartbeats are control-plane — never
    // chaos-injected, never retried — so summaries ride a channel the
    // fault harness provably leaves alone (the fail-stop contract).
    std::string rs_payload;
    RoundStats::Get().FillWire(&rs_payload);
    // Journal events ride as a SECOND magic-tagged sub-payload
    // behind the round summaries: RoundStats::Ingest tolerates
    // trailing bytes, so old schedulers simply never see the chunk,
    // and with events off nothing is appended — the payload stays
    // byte-for-byte the pre-journal wire.
    Events::Get().FillWire(&rs_payload);
    if (!van_->Send(fd, h, rs_payload.data(),
                    static_cast<int64_t>(rs_payload.size()))) {
      // Scheduler fail-over: with it armed, park instead of
      // the fail-stop below — the data plane keeps draining against
      // the last committed book while we re-dial the scheduler
      // endpoint and re-register. Only a park that exhausts
      // BYTEPS_SCHED_RECOVERY_TIMEOUT_MS falls through to the
      // original failure shutdown, so behavior strictly improves.
      if (!shutting_down_.load() && SchedRecoveryEnabled() &&
          ParkOnSchedulerLost()) {
        continue;  // recovered — resume heartbeats to the new scheduler
      }
      // The scheduler connection is gone. For a server this is the ONLY
      // exit signal once Finalize's indefinite wait has begun (the
      // SHUTDOWN broadcast can never arrive over a dead connection), and
      // for a worker it means the fleet is over: treat it as a
      // failure-triggered shutdown rather than spinning silently.
      if (!shutting_down_.load()) {
        BPS_LOG(WARNING) << "node " << my_id_
                         << ": scheduler connection lost — failure shutdown";
        Trace::Get().Note("SCHED_CONN_LOST");
        Events::Get().Emit(EV_SHUTDOWN, /*failure=*/1, kSchedulerId);
        Trace::Get().FlightDumpAuto("scheduler_lost");
        failure_shutdown_.store(true);
        shutting_down_.store(true);
        {
          std::lock_guard<std::mutex> lk(mu_);
          cv_.notify_all();
        }
        if (shutdown_cb_) shutdown_cb_();
      }
      break;
    }
    // Disconnect-parked ranks (recovery armed, death NOT yet confirmed
    // by an EPOCH_PAUSE): keep probing — if the peer is alive and only
    // our connection broke, re-dial and resume (the scheduler would
    // never have started a recovery for it). Past the deadline the
    // scheduler has had the full detect+replace window and stayed
    // silent: escalate to the pre-recovery fail-fast so the fleet
    // cannot wedge on a park nobody owns.
    std::vector<std::pair<int, DiscPark>> parked;
    {
      std::lock_guard<std::mutex> lk(mu_);
      for (const auto& kv : disc_parked_) parked.push_back(kv);
    }
    for (auto& pk : parked) {
      const int node = pk.first;
      bool redialed = true;
      for (int s : pk.second.stripes) {
        if (!TryReconnect(node, s)) { redialed = false; break; }
      }
      if (redialed) {
        bool still_parked;
        {
          std::lock_guard<std::mutex> lk(mu_);
          // An EPOCH_PAUSE/RESUME may have raced the re-dial; the
          // scheduler owns the rank then — drop our claim quietly.
          still_parked = disc_parked_.erase(node) > 0;
          if (still_parked) {
            recovering_peers_.erase(node);
            recovering_count_.store(
                static_cast<int>(recovering_peers_.size()));
            if (recovering_peers_.empty()) {
              BPS_METRIC_GAUGE_SET("bps_recovering", 0);
            }
          }
        }
        if (still_parked) {
          BPS_METRIC_COUNTER_ADD("bps_reconnects_total", 1);
          BPS_LOG(WARNING)
              << "node " << my_id_ << ": parked server " << node
              << " was alive all along — reconnected, resuming";
          if (peer_reconnected_cb_) peer_reconnected_cb_(node);
        }
      } else if (NowMs() > pk.second.deadline_ms) {
        bool still_parked;
        {
          std::lock_guard<std::mutex> lk(mu_);
          still_parked = disc_parked_.erase(node) > 0;
          if (still_parked) {
            recovering_peers_.erase(node);
            recovering_count_.store(
                static_cast<int>(recovering_peers_.size()));
            if (recovering_peers_.empty()) {
              BPS_METRIC_GAUGE_SET("bps_recovering", 0);
            }
          }
        }
        if (still_parked) {
          BPS_LOG(WARNING)
              << "node " << my_id_ << ": server " << node
              << " unreachable and the scheduler never opened a "
                 "recovery for it — escalating to fail-fast";
          if (peer_lost_cb_) peer_lost_cb_(node);
        }
      }
    }
    for (int i = 0; i < static_cast<int>(interval * 10) &&
                    !shutting_down_.load();
         ++i) {
      usleep(100 * 1000);
    }
  }
}

std::vector<int> Postoffice::DeadNodes() {
  double timeout_ms = EnvSeconds("PS_HEARTBEAT_TIMEOUT", 30.0) * 1000.0;
  std::vector<int> dead;
  std::lock_guard<std::mutex> lk(mu_);
  int64_t now = NowMs();
  for (const auto& kv : last_heartbeat_ms_) {
    if (now - kv.second > timeout_ms) dead.push_back(kv.first);
  }
  std::sort(dead.begin(), dead.end());
  return dead;
}

std::vector<std::pair<int, int64_t>> Postoffice::HeartbeatAges() {
  std::vector<std::pair<int, int64_t>> ages;
  std::lock_guard<std::mutex> lk(mu_);
  int64_t now = NowMs();
  for (const auto& kv : last_heartbeat_ms_) {
    ages.emplace_back(kv.first, now - kv.second);
  }
  std::sort(ages.begin(), ages.end());
  return ages;
}

void Postoffice::Finalize() {
  if (!van_) return;
  if (shutting_down_.load() || left_.load()) {
    // A rank that gracefully LEFT is out of the fleet's shutdown
    // quorum: it owes no goodbye and waits on nothing.
    van_->Stop();
  } else if (role_ == ROLE_WORKER) {
    // Say goodbye, then wait for the scheduler's fleet-wide SHUTDOWN
    // (long grace period: other workers may still be training).
    MsgHeader h{};
    h.cmd = CMD_SHUTDOWN;
    h.sender = my_id_;
    bool ok = van_->Send(FdOf(kSchedulerId), h);
    BPS_LOG(DEBUG) << "worker " << my_id_ << ": goodbye sent ("
                   << (ok ? "ok" : "FAILED") << "), awaiting fleet SHUTDOWN";
    // If the goodbye could not be delivered the scheduler is already gone
    // and no SHUTDOWN reply can ever arrive — don't stall process exit for
    // the full grace period (other workers may still be training only in
    // the delivered case).
    std::unique_lock<std::mutex> lk(mu_);
    cv_.wait_for(lk, std::chrono::seconds(ok ? 300 : 2),
                 [this] { return shutting_down_.load(); });
    lk.unlock();
    van_->Stop();
  } else {
    // Scheduler: wait for all workers' goodbyes (handled in
    // ControlHandler) — for as long as the job runs. This wait IS the
    // scheduler's serving life (`python -m byteps_tpu.server` calls
    // shutdown() right after startup); a bounded wait here silently
    // killed any fleet whose job outlived the bound. The failure monitor
    // is the other exit: dead nodes trigger the fail-stop broadcast.
    // Server: same indefinite wait for the SHUTDOWN broadcast; if the
    // scheduler dies instead, the heartbeat loop notices the dead
    // connection and flips shutting_down_ (failure shutdown).
    // With heartbeats DISABLED (PS_HEARTBEAT_INTERVAL <= 0) neither
    // failure exit exists, so keep the old bounded grace as the only
    // defence against orphaned fleet processes.
    std::unique_lock<std::mutex> lk(mu_);
    if (EnvSeconds("PS_HEARTBEAT_INTERVAL", 5.0) > 0) {
      // Finalize is only reachable after Start() returned, i.e. after
      // the formation bound in Start (PS_TOPOLOGY_TIMEOUT) passed and
      // the topology completed — so from here the heartbeat monitor has
      // nodes to watch and IS the failure exit; the serving wait itself
      // is rightly unbounded (it is the fleet's lifetime).
      cv_.wait(lk, [this] { return shutting_down_.load(); });
    } else {
      cv_.wait_for(lk, std::chrono::seconds(30),
                   [this] { return shutting_down_.load(); });
    }
    lk.unlock();
    van_->Stop();
  }
  if (heartbeat_thread_.joinable()) heartbeat_thread_.join();
  if (monitor_thread_.joinable()) monitor_thread_.join();
  BPS_LOG(DEBUG) << "node " << my_id_ << ": finalize complete";
}

}  // namespace bps
