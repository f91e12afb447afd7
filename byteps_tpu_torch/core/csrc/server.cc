#include "server.h"

#include <sys/uio.h>
#include <unistd.h>

#include <algorithm>
#include <cstring>

#include "cpu_reducer.h"
#include "events.h"
#include "logging.h"
#include "metrics.h"
#include "roundstats.h"
#include "trace.h"
#include "worker.h"  // NowUs

namespace bps {

namespace {
// Internal engine-queue marker (never on the wire): a death-shrink
// rollback task, one per engine thread so each rolls back exactly the
// keys it owns — per-key total ordering holds through the rollback.
constexpr int32_t kCmdShrink = -100;
}  // namespace

void BytePSServer::Start(Postoffice* po, int engine_threads, bool async_mode,
                         int replica_of) {
  po_ = po;
  async_ = async_mode;
  replica_of_ = replica_of;
  // Snapshot serving: retention ring depth (0 = serving off
  // on this node), the reader lane's DRR weight, and the per-frame
  // delta bound for replica catch-up.
  if (const char* sr = getenv("BYTEPS_SNAPSHOT_RETAIN")) {
    snapshot_retain_ = atoi(sr);
    if (snapshot_retain_ < 0) snapshot_retain_ = 0;
  }
  if (snapshot_retain_ > 0) snaps_.SetRetain(snapshot_retain_);
  if (const char* sw = getenv("BYTEPS_SERVING_WEIGHT")) {
    serving_weight_ = atoll(sw);
    if (serving_weight_ < 1) serving_weight_ = 1;
  }
  if (const char* db = getenv("BYTEPS_SNAP_DELTA_MAX_BYTES")) {
    const int64_t v = atoll(db);
    if (v > 0) snap_delta_max_bytes_ = v;
  }
  if (replica_of_ >= 0) {
    // A replica is outside the training plane entirely: it must never
    // publish cuts of its own (its store mirrors the primary's) and
    // serving must be armed or the process would do nothing at all.
    BPS_CHECK_GT(snapshot_retain_, 0)
        << "replica started with BYTEPS_SNAPSHOT_RETAIN=0 — a replica "
           "with serving disabled cannot do anything";
    // The replica's `latest` advances ONLY via the primary's committed
    // watermark (ForceLatest after a whole delta batch lands) — per-key
    // self-commit counting on a partially installed batch would let a
    // reader resolve a cut whose keys are not all there yet.
    snaps_.SetSelfCommit(false);
    BPS_LOG(WARNING) << "server: starting as READ REPLICA of server rank "
                     << replica_of_ << " (retain " << snapshot_retain_
                     << " round(s))";
  }
  // Quantized wire: same env the worker reads, same backstop
  // clamp, so both ends compute identical per-key eligibility.
  if (const char* qv = getenv("BYTEPS_WIRE_QUANT")) {
    wire_quant_ = atoi(qv) != 0;
  }
  if (const char* qb = getenv("BYTEPS_WIRE_QUANT_BLOCK")) {
    quant_block_ = atoi(qb);
  }
  if (!BlockQuant::ValidBlock(quant_block_)) quant_block_ = 64;
  if (const char* qm = getenv("BYTEPS_WIRE_QUANT_MIN_BYTES")) {
    quant_min_bytes_ = atoll(qm);
    if (quant_min_bytes_ < 0) quant_min_bytes_ = 0;
  }
  // Elastic worker membership: arm the per-epoch contributor
  // rosters. Start runs before the postoffice forms the fleet, so the
  // initial TENANT-0 roster comes from the formation env (worker ids
  // 1+S..S+W — the postoffice id layout; byte-for-byte the pre-tenant
  // arming). Other tenants' histories initialise lazily from the
  // address book (RosterOf); membership changes arrive later through
  // OnFleetResize.
  if (const char* ev = getenv("BYTEPS_ELASTIC")) {
    elastic_ = atoi(ev) != 0;
  }
  if (elastic_) {
    int nw = 1, ns = 1;
    if (const char* v = getenv("DMLC_NUM_WORKER")) nw = atoi(v);
    if (const char* v = getenv("DMLC_NUM_SERVER")) ns = atoi(v);
    std::set<int> live;
    for (int w = 0; w < nw; ++w) live.insert(1 + ns + w);
    {
      std::lock_guard<std::mutex> lk(roster_mu_);
      auto& r = rosters_[0];
      r = std::make_unique<RosterHistory>();
      r->Init(live);
    }
    BPS_LOG(INFO) << "server: elastic worker membership armed ("
                  << nw << " initial worker(s))";
  }
  if (const char* pv = getenv("BYTEPS_SERVER_ENGINE_PACE_MBPS")) {
    const long mbps = atol(pv);
    if (mbps > 0) {
      engine_pace_bps_ = static_cast<int64_t>(mbps) * 1000 * 1000;
      BPS_LOG(WARNING) << "server: engine service pacing armed ("
                       << mbps << " MB/s per engine thread)";
    }
  }
  const char* rr = getenv("DMLC_RECOVER_RANK");
  recover_mode_.store(rr && *rr);
  if (recover_mode_.load()) {
    // Grace window: the workers' re-declares must land within the same
    // budget the scheduler gives the whole recovery. Past it, a data op
    // for an unknown key is a protocol violation again (EndReseedGrace)
    // — parking it would convert a real bug into an indefinite hang.
    recover_grace_end_us_ = NowUs() + RecoveryTimeoutMs() * 1000;
    BPS_LOG(WARNING) << "server: starting as hot replacement (rank "
                     << rr << ") — re-seed state: unknown-key data ops "
                        "park until their INIT_KEY re-declare arrives "
                        "(grace " << RecoveryTimeoutMs() << " ms)";
  }
  // Pre-register the server-side metric catalog so every /metrics page
  // serves the full series from zero — an idle server (no key routed to
  // it yet) must still expose bps_recv_bytes_total for the fleet-wide
  // parity sum (docs/monitoring.md), not omit the series.
  Metrics::Get().Counter("bps_recv_bytes_total");
  Metrics::Get().Counter("bps_server_push_total");
  Metrics::Get().Counter("bps_server_pull_total");
  Metrics::Get().Counter("bps_server_reply_bytes_total");
  Metrics::Get().Counter("bps_server_sum_bytes_total");
  Metrics::Get().Counter("bps_fused_msgs_total");
  // Quantized-wire accounting, reply leg (the push leg's encoded bytes
  // already land in bps_recv_bytes_total — the parity contract counts
  // what actually crossed the wire on BOTH sides).
  Metrics::Get().Counter("bps_quant_bytes_on_wire_total");
  Metrics::Get().Counter("bps_quant_bytes_saved_total");
  Metrics::Get().Histogram("bps_server_sum_us");
  Metrics::Get().Histogram("bps_fusion_batch_keys");
  // Per-round introspection series, server view: sum time,
  // parked ops, and recv bytes per round — published at round finalize
  // by RoundStats, present-from-zero here like every other series.
  Metrics::Get().Counter("bps_rounds_completed_total");
  for (const char* g :
       {"bps_round_last", "bps_round_sum_us", "bps_round_wire_bytes",
        "bps_round_parked"}) {
    Metrics::Get().Gauge(g);
  }
  // Snapshot-serving series, present from zero on every
  // server/replica (docs/monitoring.md): the committed cut version,
  // publication/read/eviction counters, and the replica's lag behind
  // its primary's committed version (always 0 on a primary).
  Metrics::Get().Counter("bps_snap_pulls_total");
  Metrics::Get().Histogram("bps_snap_pull_us");
  Metrics::Get().Counter("bps_snap_publish_total");
  Metrics::Get().Counter("bps_snap_evictions_total");
  Metrics::Get().Gauge("bps_snapshot_version");
  Metrics::Get().Gauge("bps_replica_lag_rounds");
  BPS_METRIC_GAUGE_SET("bps_snapshot_version", -1);
  // Durable checkpoints: spill/restore config. With
  // BYTEPS_CKPT_DIR unset this whole block is inert — no writer thread,
  // no metric series, no disk scan — keeping the server byte-for-byte
  // the pre-checkpoint build.
  if (const char* cd = getenv("BYTEPS_CKPT_DIR")) ckpt_dir_ = cd;
  if (!ckpt_dir_.empty() && replica_of_ < 0) {
    BPS_CHECK_GT(snapshot_retain_, 0)
        << "ckpt: BYTEPS_CKPT_DIR set with BYTEPS_SNAPSHOT_RETAIN=0 — "
           "checkpoints spill the snapshot store's committed cuts; arm "
           "snapshots or unset the checkpoint dir";
    if (const char* v = getenv("BYTEPS_CKPT_EVERY")) {
      ckpt_every_ = std::max(1, atoi(v));
    }
    if (const char* v = getenv("BYTEPS_CKPT_RETAIN")) {
      ckpt_retain_ = std::max(1, atoi(v));
    }
    if (const char* v = getenv("BYTEPS_CHAOS_CKPT")) ckpt_chaos_ = v;
    if (!ckpt_chaos_.empty()) {
      BPS_CHECK(ckpt_chaos_ == "truncate" || ckpt_chaos_ == "bitflip")
          << "BYTEPS_CHAOS_CKPT must be 'truncate' or 'bitflip', got '"
          << ckpt_chaos_ << "'";
      BPS_LOG(WARNING) << "server: CHAOS torn-write injection armed ("
                       << ckpt_chaos_
                       << ") — every spill is corrupted pre-manifest";
    }
    if (const char* v = getenv("BYTEPS_CKPT_RESTORE")) {
      restore_armed_ = atoi(v) != 0;
    }
    if (restore_armed_) {
      // The shard rank must be pinned: restore maps on-disk shard
      // directories to server ranks, and an unpinned formation could
      // hand this process a different rank than the one that spilled.
      const char* wid = getenv("DMLC_WORKER_ID");
      BPS_CHECK(wid && *wid)
          << "ckpt-restore: BYTEPS_CKPT_RESTORE=1 requires "
             "DMLC_WORKER_ID to pin this server's shard rank";
      std::string why;
      durable_version_ = CkptScan(ckpt_dir_, atoi(wid), &why);
      if (!why.empty()) {
        BPS_LOG(WARNING) << "ckpt-restore: skipped candidate(s):" << why;
      }
      BPS_LOG(WARNING) << "server: restore armed — newest durable "
                          "checkpoint version "
                       << durable_version_ << " (rank " << wid << ", dir "
                       << ckpt_dir_ << ")";
    }
    // Ckpt series registered ONLY when checkpointing is armed: an
    // unarmed server's /metrics page is byte-for-byte pre-checkpoint.
    Metrics::Get().Counter("bps_ckpt_spills_total");
    Metrics::Get().Counter("bps_ckpt_failures_total");
    Metrics::Get().Gauge("bps_ckpt_version");
    Metrics::Get().Gauge("bps_ckpt_lag_rounds");
    Metrics::Get().Gauge("bps_ckpt_spill_ms");
    BPS_METRIC_GAUGE_SET("bps_ckpt_version", -1);
  }
  queues_.clear();
  // DRR weights resolve through the address book at grant time:
  // a tenant's BYTEPS_TENANT_WEIGHT rides its workers' NodeInfo
  // registrations, so weights stay live across elastic membership
  // changes with no extra control traffic.
  for (int i = 0; i < engine_threads; ++i) {
    queues_.push_back(std::make_unique<EngineQueue>(
        TenantQuantum(),
        // The reserved serving lane resolves to BYTEPS_SERVING_WEIGHT
        // — reader traffic shares the engine at a fixed
        // capped ratio against every tenant lane; training tenants
        // resolve through the address book as before.
        [this](uint16_t t) {
          if (t == kServingLane) return static_cast<int>(serving_weight_);
          return po_ ? po_->TenantWeightOf(t) : 1;
        }));
  }
  for (int i = 0; i < engine_threads; ++i) {
    threads_.emplace_back([this, i] { EngineLoop(i); });
  }
  BPS_LOG(INFO) << "server started: engine_threads=" << engine_threads
                << " async=" << async_;
}

void BytePSServer::Handle(Message&& msg, int fd) {
  if (msg.head.cmd == CMD_MULTI_PUSH || msg.head.cmd == CMD_MULTI_PULL) {
    HandleMulti(std::move(msg), fd);
    return;
  }
  // Wire accounting here, NOT in Process(): parked pushes replay through
  // Process (ReplayParked), and counting a replay again would break the
  // push-bytes parity contract with the workers (docs/monitoring.md).
  if (msg.head.cmd == CMD_PUSH) {
    BPS_METRIC_COUNTER_ADD("bps_recv_bytes_total",
                           static_cast<int64_t>(msg.payload.size()));
    BPS_METRIC_COUNTER_ADD("bps_server_push_total", 1);
  } else if (msg.head.cmd == CMD_PULL) {
    BPS_METRIC_COUNTER_ADD("bps_server_pull_total", 1);
  }
  // Snapshot serving: reader/replica traffic rides the
  // reserved low-weight serving lane, NOT the frame's tenant lane —
  // QoS isolation is what makes a reader swarm provably unable to move
  // the training digest. Its ops land in the LANE's accounting too, so
  // the per-lane tables show reader load separately from any tenant.
  // The header's tenant is untouched (the store lookup and the reply
  // stamping still need it).
  if (msg.head.cmd == CMD_SNAP_PULL || msg.head.cmd == CMD_SNAP_SUB ||
      msg.head.cmd == CMD_SNAP_DELTA) {
    Tenancy::Get().Of(kServingLane)->ops.fetch_add(
        1, std::memory_order_relaxed);
    Trace::Get().Instant("s_recv", msg.head.key, msg.head.sender,
                         msg.head.req_id, msg.head.cmd);
    EnqueueTask(EngineTask{std::move(msg), fd, nullptr, -1}, kServingLane);
    return;
  }
  // Per-tenant accounting: ops and push payload bytes by the
  // frame's tenant stamp.
  {
    TenantStat* ts = Tenancy::Get().Of(msg.head.tenant);
    ts->ops.fetch_add(1, std::memory_order_relaxed);
    if (msg.head.cmd == CMD_PUSH) {
      ts->push_bytes.fetch_add(static_cast<int64_t>(msg.payload.size()),
                               std::memory_order_relaxed);
    }
  }
  // Per-op recv instant: the gap from here to the engine's
  // s_sum span is queueing delay inside this server — the signal that
  // separates "engine busy" from "summation slow" in the fleet view.
  Trace::Get().Instant("s_recv", msg.head.key, msg.head.sender,
                       msg.head.req_id, msg.head.cmd);
  EnqueueTask(EngineTask{std::move(msg), fd, nullptr, -1});
}

void BytePSServer::EnqueueTask(EngineTask&& task, int lane) {
  const uint16_t tenant = task.msg.head.tenant;
  // The DRR lane this task is accounted/dispatched under: the frame's
  // tenant, unless the caller overrides it (serving lane).
  const uint16_t drr_lane =
      lane < 0 ? tenant : static_cast<uint16_t>(lane);
  // Route by (tenant, key) so one tenant-key's operations are totally
  // ordered on one thread. Tenant 0 composes to the bare key — the
  // pre-tenant `key % threads` routing, bit for bit.
  const size_t tid =
      static_cast<size_t>(TenantKey(tenant, task.msg.head.key)) %
      queues_.size();
  const int64_t cost =
      DrrCost(static_cast<int64_t>(task.msg.payload.size()));
  TenantStat* ts = Tenancy::Get().Of(drr_lane);
  ts->queue_depth.fetch_add(1, std::memory_order_relaxed);
  auto& eq = *queues_[tid];
  {
    std::lock_guard<std::mutex> lk(eq.mu);
    eq.lanes[drr_lane].push_back(std::move(task));
    eq.drr.Enqueue(drr_lane, cost);
  }
  eq.cv.notify_one();
}

void BytePSServer::HandleMulti(Message&& msg, int fd) {
  const MsgHeader& h = msg.head;
  const bool is_push = h.cmd == CMD_MULTI_PUSH;
  int count = static_cast<int>(h.arg0);
  int64_t table_bytes =
      static_cast<int64_t>(count) * static_cast<int64_t>(sizeof(SubHeader));
  BPS_CHECK(count > 0 &&
            table_bytes <= static_cast<int64_t>(msg.payload.size()))
      << "malformed multi frame: count=" << count << " payload="
      << msg.payload.size();
  const SubHeader* table =
      reinterpret_cast<const SubHeader*>(msg.payload.data());
  const char* gathered = msg.payload.data() + table_bytes;
  int64_t gathered_len =
      static_cast<int64_t>(msg.payload.size()) - table_bytes;
  // Wire/parity accounting mirrors the single-frame path exactly: a
  // fused frame's CMD_PUSH payload bytes are its SUB-payload bytes (the
  // table is framing, like headers), so worker-side push totals and
  // server-side recv totals still sum to the same number fleet-wide.
  if (is_push) {
    int64_t pbytes = 0;
    for (int i = 0; i < count; ++i) pbytes += table[i].len;
    BPS_METRIC_COUNTER_ADD("bps_recv_bytes_total", pbytes);
    BPS_METRIC_COUNTER_ADD("bps_server_push_total", count);
    Tenancy::Get().Of(h.tenant)->push_bytes.fetch_add(
        pbytes, std::memory_order_relaxed);
  } else {
    BPS_METRIC_COUNTER_ADD("bps_server_pull_total", count);
  }
  Tenancy::Get().Of(h.tenant)->ops.fetch_add(count,
                                             std::memory_order_relaxed);
  BPS_METRIC_COUNTER_ADD("bps_fused_msgs_total", 1);
  BPS_METRIC_HISTO_OBSERVE("bps_fusion_batch_keys", count);
  Trace::Get().Instant("s_recv", h.key, h.sender, h.req_id, h.cmd);
  auto batch = std::make_shared<MultiReply>();
  batch->fd = fd;
  batch->req_id = h.req_id;
  batch->reply_cmd = is_push ? CMD_MULTI_ACK : CMD_MULTI_PULL_RESP;
  batch->tenant = h.tenant;
  batch->first_key = h.key;
  batch->subs.resize(count);
  batch->data.resize(count);
  batch->remaining.store(count);
  for (int i = 0; i < count; ++i) {
    const SubHeader& s = table[i];
    BPS_CHECK(s.offset >= 0 && s.len >= 0 &&
              s.offset + s.len <= gathered_len)
        << "multi sub-payload out of range: key " << s.key;
    BPS_CHECK_EQ(s.cmd, is_push ? CMD_PUSH : CMD_PULL)
        << "unexpected sub-cmd in multi frame";
    // Wire-dtype/flag consistency: the table field and the flag bit are
    // one contract (BPS_INT8 <-> FLAG_WIRE_QUANT); a frame where they
    // disagree was corrupted or built by a broken sender.
    BPS_CHECK((s.wire_dtype == BPS_INT8) ==
              ((s.flags & FLAG_WIRE_QUANT) != 0))
        << "sub-entry wire_dtype/quant-flag mismatch for key " << s.key;
    // Sub-entry tenant must be the frame's (one frame = one sender =
    // one tenant): a disagreeing table was corrupted or forged.
    BPS_CHECK_EQ(s.tenant, h.tenant)
        << "sub-entry tenant mismatch for key " << s.key;
    EngineTask t;
    t.msg.head.cmd = s.cmd;
    t.msg.head.tenant = s.tenant;
    t.msg.head.sender = h.sender;
    t.msg.head.key = s.key;
    t.msg.head.req_id = h.req_id;
    t.msg.head.dtype = s.dtype;
    t.msg.head.payload_len = s.len;
    t.msg.head.flags = s.flags;
    t.msg.head.version = s.version;
    t.msg.head.arg0 = s.arg0;
    if (s.len > 0) {
      // Own copy: a sub-push may be parked past the frame buffer's life.
      t.msg.payload.assign(gathered + s.offset, gathered + s.offset + s.len);
    }
    t.fd = fd;
    t.batch = batch;
    t.sub_idx = i;
    // Same (tenant, key) hash routing as single frames: all of a key's
    // operations — fused or not — stay totally ordered on one engine
    // thread, and the KeyStore keeps its single-writer invariant.
    EnqueueTask(std::move(t));
  }
}

void BytePSServer::SendReply(const EngineTask& t, MsgHeader& head,
                             const void* data, int64_t len) {
  // Replies carry the request's tenant (one stamping point for every
  // single-frame and fused sub-reply) and land in its reply-byte
  // accounting. Tenant-0 requests stamp 0 — the pre-tenant bytes.
  head.tenant = t.msg.head.tenant;
  if (len > 0) {
    Tenancy::Get().Of(head.tenant)->reply_bytes.fetch_add(
        len, std::memory_order_relaxed);
  }
  if (!t.batch) {
    po_->van().Send(t.fd, head, data, len);
    return;
  }
  MultiReply& b = *t.batch;
  SubHeader& s = b.subs[t.sub_idx];
  s.key = head.key;
  s.cmd = static_cast<int16_t>(head.cmd);
  s.wire_dtype = (head.flags & FLAG_WIRE_QUANT)
                     ? static_cast<int16_t>(BPS_INT8)
                     : static_cast<int16_t>(0);
  s.version = head.version;
  s.dtype = static_cast<int16_t>(head.dtype);
  s.tenant = head.tenant;
  s.flags = head.flags;
  s.arg0 = head.arg0;
  s.arg1 = head.arg1;
  s.len = len;
  if (len > 0) {
    // Copy: pull responses point into the slot buffer, which a parked
    // push replayed by THIS round's recycle may overwrite before the
    // batch's last sub-op settles and flushes.
    b.data[t.sub_idx].assign(static_cast<const char*>(data),
                             static_cast<const char*>(data) + len);
  }
  if (b.remaining.fetch_sub(1) == 1) FlushMulti(t.batch);
}

void BytePSServer::FlushMulti(const std::shared_ptr<MultiReply>& batch) {
  MultiReply& b = *batch;
  int count = static_cast<int>(b.subs.size());
  std::vector<iovec> segs;
  segs.reserve(static_cast<size_t>(count) + 1);
  segs.push_back({b.subs.data(), static_cast<size_t>(count) * sizeof(SubHeader)});
  int64_t off = 0;
  for (int i = 0; i < count; ++i) {
    b.subs[i].offset = off;
    off += b.subs[i].len;
    if (b.subs[i].len > 0) {
      segs.push_back({b.data[i].data(), b.data[i].size()});
    }
  }
  MsgHeader head{};
  head.cmd = static_cast<int16_t>(b.reply_cmd);
  head.tenant = b.tenant;
  head.sender = po_->my_id();
  head.key = b.first_key;
  head.req_id = b.req_id;
  head.arg0 = count;
  po_->van().SendV(b.fd, head, segs.data(), static_cast<int>(segs.size()));
}

void BytePSServer::EngineLoop(int tid) {
  auto& eq = *queues_[tid];
  while (true) {
    EngineTask task;
    uint16_t tenant;
    int64_t cost = 0;
    {
      std::unique_lock<std::mutex> lk(eq.mu);
      eq.cv.wait(lk, [&] { return stopped_.load() || !eq.drr.Empty(); });
      if (stopped_.load() && eq.drr.Empty()) return;
      // Weighted-DRR pick: which tenant's lane is served
      // next. Single-tenant fleets short-circuit to FIFO inside the
      // picker, so their dispatch order is byte-for-byte the pre-tenancy order.
      tenant = eq.drr.PickAndPop(&cost);
      auto& lane = eq.lanes[tenant];
      task = std::move(lane.front());
      lane.pop_front();
    }
    TenantStat* ts = Tenancy::Get().Of(tenant);
    ts->queue_depth.fetch_sub(1, std::memory_order_relaxed);
    ts->dispatched.fetch_add(cost, std::memory_order_relaxed);
    // Starvation episode close: this serve ends any gap the
    // tenant spent flagged STARVED (/tenants semantics: queued work,
    // no dispatch for > BYTEPS_TENANT_STARVE_MS). Journal the episode
    // exactly once — at its close, with the measured gap — instead of
    // polling the flag.
    {
      static const int64_t starve_us = [] {
        const char* v = getenv("BYTEPS_TENANT_STARVE_MS");
        long long ms = v && *v ? atoll(v) : 2000;
        return ms > 0 ? ms * 1000 : 2000 * 1000;
      }();
      const int64_t now = NowUs();
      const int64_t last =
          ts->last_serve_us.load(std::memory_order_relaxed);
      if (last > 0 && now - last > starve_us) {
        Events::Get().Emit(EV_TENANT_STARVED, tenant, now - last);
      }
      ts->last_serve_us.store(now, std::memory_order_relaxed);
    }
    if (task.msg.head.cmd == kCmdShrink) {
      ShrinkWorker(tid, static_cast<int>(task.msg.head.arg0), tenant);
      continue;
    }
    Process(std::move(task));
    if (engine_pace_bps_ > 0 && cost > 0) {
      // Service-rate cap: sleep off the dispatched cost so the engine
      // serves at most pace bytes/s — under offered load the lanes
      // stay backlogged and the DRR share is exactly the weight ratio.
      int64_t us = cost * 1000000 / engine_pace_bps_;
      while (us > 0 && !stopped_.load(std::memory_order_relaxed)) {
        const int64_t chunk = us > 20000 ? 20000 : us;
        usleep(static_cast<useconds_t>(chunk));
        us -= chunk;
      }
    }
  }
}

RosterHistory* BytePSServer::RosterOf(uint16_t tenant) {
  std::lock_guard<std::mutex> lk(roster_mu_);
  auto& r = rosters_[tenant];
  if (!r) {
    // Lazy per-tenant arming: the first reference seeds the
    // history from the address book's current tenant roster. Tenant 0
    // was pre-seeded from the formation env at Start (as before tenancy, byte for
    // byte); this path only runs for tenants the env cannot know.
    r = std::make_unique<RosterHistory>();
    r->Init(po_ ? po_->TenantWorkers(tenant) : std::set<int>());
  }
  return r.get();
}

void BytePSServer::OnFleetResize(int kind, int affected,
                                 int64_t join_round, int64_t join_bcast,
                                 int tenant) {
  if (!elastic_) return;
  const uint16_t t16 = static_cast<uint16_t>(tenant);
  if (kind == 0) {
    // Join: a fresh roster epoch for the JOINER'S TENANT activates at
    // that tenant's gated round boundary (rounds are per-tenant
    // counters — another tenant's history must not move). Rounds
    // already in flight keep completing against the old set — no store
    // surgery needed. A first-ever reference here must seed the
    // pre-join roster: the address book already contains the joiner,
    // so it is excluded from the epoch-0 set and enters only at its
    // activation epoch.
    {
      std::lock_guard<std::mutex> lk(roster_mu_);
      auto& r = rosters_[t16];
      if (!r) {
        std::set<int> pre = po_->TenantWorkers(t16);
        pre.erase(affected);
        r = std::make_unique<RosterHistory>();
        r->Init(pre);
      }
      r->Join(affected, join_round, join_bcast);
    }
    BPS_LOG(WARNING) << "server: roster epoch — worker " << affected
                     << " (tenant " << tenant << ") joins at round "
                     << join_round;
    for (auto& eq : queues_) {
      EngineTask t;
      t.msg.head.cmd = kCmdShrink;
      t.msg.head.tenant = t16;
      t.msg.head.arg0 = -1;
      EnqueueTaskTo(*eq, std::move(t));
    }
    return;
  }
  // Removal: erase the id from EVERY epoch of its tenant's roster (a
  // leaver drained before leaving, and a dead rank's partial
  // contributions are discarded by the rollback below — so no
  // incomplete round legitimately expects it), then re-evaluate each
  // engine thread's keys for that tenant: blocked rounds whose only
  // missing contributor was the departed rank become ready.
  RosterOf(t16)->Remove(affected);
  BPS_LOG(WARNING) << "server: roster epoch — worker " << affected
                   << " (tenant " << tenant << ")"
                   << (kind == 1 ? " left" : " died")
                   << "; rolling in-flight rounds onto the survivors";
  for (auto& eq : queues_) {
    EngineTask t;
    t.msg.head.cmd = kCmdShrink;
    t.msg.head.tenant = t16;
    t.msg.head.arg0 = affected;
    EnqueueTaskTo(*eq, std::move(t));
  }
}

void BytePSServer::EnqueueTaskTo(EngineQueue& eq, EngineTask&& task) {
  // Internal control marker: rides the affected tenant's lane so it
  // stays FIFO-ordered behind that tenant's already-received data ops
  // (the per-thread ordering, now per tenant). Zero DRR cost —
  // a rollback must not charge anyone's fair share.
  const uint16_t tenant = task.msg.head.tenant;
  Tenancy::Get().Of(tenant)->queue_depth.fetch_add(
      1, std::memory_order_relaxed);
  {
    std::lock_guard<std::mutex> lk(eq.mu);
    eq.lanes[tenant].push_back(std::move(task));
    eq.drr.Enqueue(tenant, 0);
  }
  eq.cv.notify_one();
}

int BytePSServer::TenantWorkerCount(uint16_t tenant) {
  const int n = po_ ? po_->TenantWorkerCount(tenant) : 0;
  // Legacy fallback: before the address book arrives (or in a fleet
  // with no tenant registrations at all) tenant 0 is everyone — the
  // pre-tenant fleet-size check, byte for byte.
  if (n == 0 && tenant == 0) return po_ ? po_->num_workers() : 0;
  return n;
}

int BytePSServer::ExpectedContributors(const KeyStore* ks,
                                       int64_t version) {
  if (!elastic_) return TenantWorkerCount(ks->tenant);
  return static_cast<int>(RosterOf(ks->tenant)->OfRound(version)->size());
}

bool BytePSServer::RoundComplete(KeyStore* ks, int slot, int64_t version) {
  if (!elastic_) {
    return ks->push_count[slot] == TenantWorkerCount(ks->tenant);
  }
  auto roster = RosterOf(ks->tenant)->OfRound(version);
  return !roster->empty() && ks->er[slot].PushersMatch(*roster);
}

bool BytePSServer::RoundServed(KeyStore* ks, int slot, int64_t version) {
  if (!elastic_) {
    return ks->pull_count[slot] == TenantWorkerCount(ks->tenant);
  }
  auto roster = RosterOf(ks->tenant)->OfRound(version);
  return !roster->empty() && ks->er[slot].PullersCover(*roster);
}

void BytePSServer::ShrinkWorker(int tid, int dead, uint16_t tenant) {
  std::vector<KeyStore*> mine;
  {
    std::lock_guard<std::mutex> lk(store_mu_);
    for (auto& kv : store_) {
      // This thread's keys, restricted to the affected TENANT: the
      // departed worker never contributed to another tenant's slots,
      // and their completion rosters did not move.
      if (static_cast<size_t>(kv.first) % queues_.size() ==
              static_cast<size_t>(tid) &&
          kv.second->tenant == tenant) {
        mine.push_back(kv.second.get());
      }
    }
  }
  auto drop_sender = [dead](std::vector<EngineTask>& v) {
    v.erase(std::remove_if(v.begin(), v.end(),
                           [dead](const EngineTask& t) {
                             return t.msg.head.sender == dead;
                           }),
            v.end());
  };
  int rolled = 0, completed = 0;
  for (KeyStore* ks : mine) {
    if (dead >= 0) {
      ks->seen.erase(dead);
      ks->pending_bcast_pulls.erase(
          std::remove_if(ks->pending_bcast_pulls.begin(),
                         ks->pending_bcast_pulls.end(),
                         [dead](const std::pair<int, MsgHeader>& p) {
                           return p.second.sender == dead;
                         }),
          ks->pending_bcast_pulls.end());
    }
    for (int slot = 0; slot < 2; ++slot) {
      if (dead >= 0) {
        drop_sender(ks->parked_pushes[slot]);
        drop_sender(ks->pending_pulls[slot]);
      }
      if (dead >= 0 && !ks->ready[slot] && ks->push_count[slot] > 0) {
        // In-flight round: discard the departed rank's partial
        // contribution and rebuild the sum from the survivors'
        // retained bytes — the aggregate is then exactly the sum over
        // the round's post-shrink roster, never a mix.
        if (ks->er[slot].Remove(dead)) {
          --ks->push_count[slot];
          ++rolled;
          if (ks->push_count[slot] == 0) {
            ks->round[slot] = -1;
          } else {
            BPS_CHECK(ks->er[slot].RebuildSum(
                ks->slot[slot].data(),
                static_cast<int64_t>(ks->slot[slot].size()), ks->dtype))
                << "elastic rollback lost the surviving contributions "
                   "for a slot with push_count > 0";
          }
        }
      }
      // Re-evaluate against the shrunk roster: a round whose only
      // missing contributor was the departed rank becomes ready (its
      // parked pulls get served), and a ready round every survivor
      // already pulled recycles.
      if (!ks->ready[slot] && ks->push_count[slot] > 0 &&
          RoundComplete(ks, slot, ks->round[slot])) {
        ++completed;
        RoundReady(ks, slot);
      } else if (ks->ready[slot] &&
                 RoundServed(ks, slot, ks->round[slot])) {
        ks->last_round[slot] = ks->round[slot];
        ks->last_contrib_n[slot] = ks->contrib_n[slot];
        ks->push_count[slot] = 0;
        ks->pull_count[slot] = 0;
        ks->ready[slot] = false;
        ks->round[slot] = -1;
        ks->er[slot].Reset();
        ReplayParked(ks, slot);
      }
    }
  }
  if (rolled || completed) {
    BPS_LOG(WARNING) << "server: rollback for departed worker " << dead
                     << " (engine " << tid << "): discarded " << rolled
                     << " partial contribution(s), completed "
                     << completed << " round(s) on the survivors";
  }
  if (dead >= 0) {
    Trace::Get().Note("WORKER_SHRINK", rolled, dead, -1, completed);
    Events::Get().Emit(EV_LEAVE, dead, /*replica=*/0, rolled);
  }
}

BytePSServer::KeyStore* BytePSServer::GetStore(uint16_t tenant,
                                               int64_t key) {
  std::lock_guard<std::mutex> lk(store_mu_);
  auto it = store_.find(TenantKey(tenant, key));
  return it == store_.end() ? nullptr : it->second.get();
}

void BytePSServer::MarkReplied(KeyStore* ks, int32_t sender,
                               int32_t req_id,
                               const MsgHeader& reply_head) {
  if (!RetryEnabled()) return;
  auto it = ks->seen.find(sender);
  if (it != ks->seen.end() && it->second.req_id == req_id) {
    it->second.replied = true;
    it->second.reply_head = reply_head;
  }
}

void BytePSServer::SendKeepalive(const EngineTask& t) {
  MsgHeader ka{};
  ka.cmd = CMD_KEEPALIVE;
  ka.tenant = t.msg.head.tenant;
  ka.sender = po_->my_id();
  ka.key = t.msg.head.key;
  ka.req_id = t.msg.head.req_id;
  // Direct van frame, NOT SendReply: a keepalive is per-request flow
  // control, not a reply slot — for a duplicated fused frame each
  // still-parked sub sends its own keepalive (same req_id; the worker
  // resets the frame's budget once per arrival) while the ORIGINAL
  // frame's MultiReply still owns the real batched reply. The
  // duplicate's MultiReply then never flushes; it is a small, bounded
  // leak (one per duplicate of a partially-parked frame) that dies
  // with the batch shared_ptr.
  po_->van().Send(t.fd, ka);
}

void BytePSServer::SendWireError(int fd, const MsgHeader& req,
                                 const std::string& why) {
  MsgHeader err{};
  err.cmd = CMD_ERROR;
  err.tenant = req.tenant;
  err.sender = po_->my_id();
  err.key = req.key;
  err.req_id = req.req_id;
  BPS_LOG(WARNING) << "server: failing req " << req.req_id << " (key "
                   << req.key << "): " << why;
  po_->van().Send(fd, err, why.data(), static_cast<int64_t>(why.size()));
}

// A (sender, req_id) match in the dedup window: the frame is a wire
// duplicate — a chaos dup, or a retry of a request whose reply was
// lost. Answer from recorded state; NEVER re-apply (a re-summed push or
// a double-counted pull_count would corrupt the round).
void BytePSServer::AnswerDuplicate(KeyStore* ks, KeyStore::SenderRec& rec,
                                   EngineTask& task) {
  const MsgHeader& h = task.msg.head;
  if (!rec.replied) {
    // Original still in flight (parked push/pull, or a round waiting on
    // peers): tell the worker we have it so its retry budget resets.
    SendKeepalive(task);
    return;
  }
  MsgHeader head = rec.reply_head;
  switch (head.cmd) {
    case CMD_PUSH_ACK:
      SendReply(task, head);
      return;
    case CMD_PULL_RESP: {
      if (h.cmd == CMD_BCAST_PULL) {
        auto it = ks->bcast_rounds.find(h.version);
        if (it != ks->bcast_rounds.end()) {
          SendReply(task, head, it->second.data.data(),
                    static_cast<int64_t>(it->second.data.size()));
        } else if (h.version == ks->last_bcast_round && ks->param_init) {
          SendReply(task, head, ks->param.data(),
                    static_cast<int64_t>(ks->param.size()));
        } else {
          SendWireError(task.fd, h,
                        "bcast round " + std::to_string(h.version) +
                            " no longer held for replay");
        }
        return;
      }
      if (async_ || (h.flags & FLAG_ASYNC)) {
        // Async reads are idempotent; re-serve the live value.
        SendReply(task, head, ks->param.data(),
                  static_cast<int64_t>(ks->param.size()));
        return;
      }
      int slot = h.version & 1;
      // Round-tag assertion on every cached-encode replay:
      // the slot's cache can already hold the NEXT round's
      // re-encode while last_round still names this one (new round
      // READY, not yet recycled). Replaying those bytes under this
      // h.version header would hand the worker a silently wrong round
      // — and since the new encode implies the new round also assigned
      // over the raw slot, falling back to slot bytes is no better.
      // Tag == h.version → replay the cache. Tag cleared (-1, a
      // re-seed) → the restored raw slot IS the round's truth; serve
      // it honestly declared. Tag naming another round → the replay
      // window is outrun; fail loud below, never serve torn bytes.
      const int64_t ctag = ks->comp_reply_round[slot];
      const int64_t qtag = ks->qreply_round[slot];
      const bool comp_outrun =
          (head.flags & FLAG_COMPRESSED) && ctag >= 0 && ctag != h.version;
      const bool quant_outrun =
          (head.flags & FLAG_WIRE_QUANT) && qtag >= 0 && qtag != h.version;
      if ((ks->round[slot] == h.version ||
           ks->last_round[slot] == h.version) &&
          !comp_outrun && !quant_outrun) {
        if ((head.flags & FLAG_COMPRESSED) &&
            CachedReplyValid(ctag, h.version,
                             !ks->comp_reply[slot].empty())) {
          SendReply(task, head, ks->comp_reply[slot].data(),
                    static_cast<int64_t>(ks->comp_reply[slot].size()));
        } else if (head.flags & FLAG_COMPRESSED) {
          // Encode re-seeded away: the restored raw aggregate is the
          // round's truth; declare it raw.
          head.flags &= ~FLAG_COMPRESSED;
          head.arg0 = 0;
          SendReply(task, head, ks->slot[slot].data(),
                    static_cast<int64_t>(ks->slot[slot].size()));
        } else if ((head.flags & FLAG_WIRE_QUANT) &&
                   CachedReplyValid(qtag, h.version,
                                    !ks->qreply[slot].empty())) {
          // Replay the round's cached quantized encode — the same
          // bytes the original reply carried.
          SendReply(task, head, ks->qreply[slot].data(),
                    static_cast<int64_t>(ks->qreply[slot].size()));
        } else if (head.flags & FLAG_WIRE_QUANT) {
          // Cache gone (a re-seed cleared it): re-serve the retained
          // raw aggregate instead, honestly declared as raw.
          head.flags &= ~FLAG_WIRE_QUANT;
          SendReply(task, head, ks->slot[slot].data(),
                    static_cast<int64_t>(ks->slot[slot].size()));
        } else {
          SendReply(task, head, ks->slot[slot].data(),
                    static_cast<int64_t>(ks->slot[slot].size()));
        }
        return;
      }
      // Replay window outrun: the slot was reassigned before this
      // worker's reply was delivered — only reachable when a caller
      // deep-pipelines 3+ rounds of one tensor through lossy chaos.
      // Serving the new round's bytes would be silent corruption; the
      // honest move is today's fail-stop, scoped to this handle.
      SendWireError(task.fd, h,
                    "round " + std::to_string(h.version) + " for key " +
                        std::to_string(h.key) +
                        " was recycled before its reply was delivered "
                        "(deep pipelining + loss); cannot replay");
      return;
    }
    default:
      SendWireError(task.fd, h, "unexpected recorded reply cmd " +
                                    std::to_string(head.cmd));
  }
}

void BytePSServer::Process(EngineTask&& task) {
  Message& msg = task.msg;
  const MsgHeader& h = msg.head;
  const int fd = task.fd;
  // Re-seed state (recovery incarnation): in-flight data ops redirected
  // from the dead predecessor may beat the worker's INIT_KEY
  // re-declares here. Park them (keepalive keeps the sender patient)
  // and replay them once the key exists — fresh normal servers keep the
  // unknown-key fatal, it is a protocol violation there. The grace is
  // bounded: past the deadline, exit recover mode (failing anything
  // still parked) and fall through to the fatal for this op. The lazy
  // check suffices — a parked original never gets a reply, so its
  // sender's retry timer keeps re-delivering it here until either its
  // re-declare lands or the deadline trips.
  if (recover_mode_.load(std::memory_order_relaxed) &&
      (h.cmd == CMD_PUSH || h.cmd == CMD_PULL || h.cmd == CMD_BCAST_PUSH ||
       h.cmd == CMD_BCAST_PULL || h.cmd == CMD_RESEED) &&
      GetStore(h.tenant, h.key) == nullptr) {
    if (NowUs() < recover_grace_end_us_) {
      if (ParkUndeclared(std::move(task))) return;
    } else {
      EndReseedGrace();
    }
  }
  // Dedup window (see KeyStore::SenderRec): applies to the per-key
  // stateful commands. INIT_KEY is naturally idempotent and skips it.
  if (RetryEnabled() && !task.from_park &&
      (h.cmd == CMD_PUSH || h.cmd == CMD_PULL || h.cmd == CMD_BCAST_PUSH ||
       h.cmd == CMD_BCAST_PULL || h.cmd == CMD_RESEED)) {
    KeyStore* ks = GetStore(h.tenant, h.key);
    if (ks) {
      auto& rec = ks->seen[h.sender];
      if (rec.req_id == h.req_id) {
        AnswerDuplicate(ks, rec, task);
        return;
      }
      // New request from this sender: open its window entry. The reply
      // sites below mark it replied (ack-on-park acks immediately;
      // parked singles/pulls stay unreplied until their replay).
      rec.req_id = h.req_id;
      rec.replied = false;
      rec.reply_head = MsgHeader{};
    }
  }
  switch (h.cmd) {
    case CMD_INIT_KEY: {
      {
        std::lock_guard<std::mutex> lk(store_mu_);
        auto& ks = store_[TenantKey(h.tenant, h.key)];
        if (!ks) {
          ks = std::make_unique<KeyStore>();
          ks->tenant = h.tenant;
          ks->key = h.key;
          ks->len = h.arg0;
          ks->dtype = h.dtype;
          ks->comp_config.assign(msg.payload.begin(), msg.payload.end());
          // Quantized-wire eligibility: the same predicate the worker
          // evaluates (QuantEligible + codec-less), so the two ends
          // agree without negotiation. scratch doubles as the dequant
          // target (codec keys and quant keys are disjoint).
          ks->quant_ok = wire_quant_ && ks->comp_config.empty() &&
                         ks->dtype == BPS_FLOAT32 &&
                         ks->len >= quant_min_bytes_;
          if (ks->quant_ok) {
            ks->scratch.resize(ks->len /
                               static_cast<int64_t>(sizeof(float)));
          }
          if (!ks->comp_config.empty()) {
            int64_t n = ks->len / static_cast<int64_t>(sizeof(float));
            ks->compressor = CreateCompressor(ks->comp_config, n);
            if (ks->compressor) {
              ks->scratch.resize(n);
              // Reply codec: same algorithm, momentum stripped (see
              // KeyStore::reply_comp).
              std::string reply_cfg;
              for (auto& kvp : ParseCompressorConfig(ks->comp_config)) {
                if (kvp.first == "momentum" || kvp.first == "mu") continue;
                if (!reply_cfg.empty()) reply_cfg += ";";
                reply_cfg += kvp.first + "=" + kvp.second;
              }
              ks->reply_comp = CreateCompressor(reply_cfg, n);
            }
          }
        } else {
          BPS_CHECK_EQ(ks->len, h.arg0) << "key re-declared with new length";
        }
      }
      // Durable restore: install this key's checkpointed
      // aggregate BEFORE the INIT_ACK releases the worker — by the time
      // the worker can pull, the restored state is in the slot and in
      // the snapshot store at the restore round.
      if (restore_armed_) MaybeInstallRestored(GetStore(h.tenant, h.key));
      MsgHeader ack{};
      ack.cmd = CMD_INIT_ACK;
      ack.sender = po_->my_id();
      ack.key = h.key;
      ack.req_id = h.req_id;
      po_->van().Send(fd, ack);
      // Recovery incarnation: data ops that arrived before this
      // re-declare were parked; the key exists now — replay them (on
      // this same engine thread, so per-key ordering holds; replays go
      // through the dedup window like first arrivals, which they are).
      std::vector<EngineTask> parked;
      {
        std::lock_guard<std::mutex> lk(store_mu_);
        auto it = pre_declare_parked_.find(TenantKey(h.tenant, h.key));
        if (it != pre_declare_parked_.end()) {
          parked = std::move(it->second);
          pre_declare_parked_.erase(it);
        }
      }
      for (auto& t : parked) Process(std::move(t));
      break;
    }

    case CMD_PUSH: {
      KeyStore* ks = GetStore(h.tenant, h.key);
      BPS_CHECK(ks) << "push for undeclared key " << h.key;
      const bool is_async = async_ || (h.flags & FLAG_ASYNC);
      if (!is_async) {
        int stale_slot = h.version & 1;
        if (RetryEnabled() && ks->last_round[stale_slot] >= h.version) {
          // A push for a round that already COMPLETED (every worker's
          // contribution summed, all pulls served or re-servable from
          // the retained slot). Unreachable in normal operation — a
          // wire duplicate is caught by the dedup window above — but a
          // recovery RE-PUSH (its contribution was inside a re-seeded
          // aggregate) arrives with a fresh req_id and lands here:
          // ack it, never re-apply.
          MsgHeader ack{};
          ack.cmd = CMD_PUSH_ACK;
          ack.sender = po_->my_id();
          ack.key = h.key;
          ack.req_id = h.req_id;
          MarkReplied(ks, h.sender, h.req_id, ack);
          SendReply(task, ack);
          break;
        }
        // A push for round r+2 can land while its slot still accumulates
        // or serves round r (3+ rounds of one tensor in flight). Park the
        // raw message; replayed — and only then acked, which is the
        // client-side backpressure — once the slot recycles.
        int slot = h.version & 1;
        bool busy = ks->ready[slot] ||
                    (ks->push_count[slot] > 0 && ks->round[slot] != h.version);
        if (busy) {
          if (task.batch && !task.replied) {
            // Ack-on-park: record this sub-push's ack into the batch
            // NOW instead of withholding the frame's CMD_MULTI_ACK
            // until the slot recycles. The batched ack gates the
            // worker's fused PULL for every key in the frame, and
            // pulls are exactly what recycle slots — gating acks on a
            // parked push lets two workers' frames each withhold the
            // pull the other's parked push needs, a cross-worker
            // ack -> slot-recycle -> pull -> ack deadlock cycle.
            // Backpressure survives: the worker's pull for this round
            // parks in pending_pulls until the replayed push applies
            // and the round becomes ready, so the caller's handle
            // completes no earlier than on the unfused wire.
            MsgHeader ack{};
            ack.cmd = CMD_PUSH_ACK;
            ack.sender = po_->my_id();
            ack.key = h.key;
            ack.req_id = h.req_id;
            task.replied = true;
            MarkReplied(ks, h.sender, h.req_id, ack);
            SendReply(task, ack);
          }
          Trace::Get().Instant("s_park", h.key, h.sender, h.req_id,
                               h.version);
          RoundStats::Get().Track(RS_PARK, h.version);
          ks->parked_pushes[slot].push_back(std::move(task));
          break;
        }
      }
      // Sum span: covers decompress + assign/sum for this
      // push, and carries the flow step that stitches the sending
      // worker's push span to this server's work in the merged view.
      const int64_t t_trace =
          Trace::Get().MainOn() ? NowUs() : 0;
      // Round-summary clock: the whole decode+assign/sum for
      // this push; reported back on the ack's arg0 so the SENDER can
      // split its push wall into server_sum vs wire_ack per round.
      const int64_t t_rs = RoundStats::Get().On() ? NowUs() : 0;
      const char* data = msg.payload.data();
      int64_t data_len = static_cast<int64_t>(msg.payload.size());
      // Decompress (compressed pushes are always float32 streams).
      if (h.flags & FLAG_COMPRESSED) {
        BPS_CHECK(ks->compressor) << "compressed push but no compressor for "
                                  << h.key;
        int64_t n = ks->len / static_cast<int64_t>(sizeof(float));
        ks->compressor->Decompress(data, data_len, ks->scratch.data(), n);
        data = reinterpret_cast<const char*>(ks->scratch.data());
        data_len = ks->len;
      } else if (h.flags & FLAG_WIRE_QUANT) {
        // Dequant-sum: decode the block-quantized push into
        // scratch; the accumulator below stays float32, so summation
        // order and precision are EXACTLY the dense path's — only the
        // per-worker payload is lossy (compensated by the worker's EF).
        BPS_CHECK(ks->quant_ok)
            << "quantized push for non-eligible key " << h.key
            << " (codec/dtype/min-bytes mismatch between worker and "
               "server config)";
        int64_t n = ks->len / static_cast<int64_t>(sizeof(float));
        BPS_CHECK(BlockQuant::Decode(data, data_len, ks->scratch.data(),
                                     n))
            << "malformed quantized push for key " << h.key;
        BPS_METRIC_COUNTER_ADD(
            "bps_quant_bytes_on_wire_total",
            static_cast<int64_t>(msg.payload.size()));
        BPS_METRIC_COUNTER_ADD(
            "bps_quant_bytes_saved_total",
            ks->len - static_cast<int64_t>(msg.payload.size()));
        data = reinterpret_cast<const char*>(ks->scratch.data());
        data_len = ks->len;
      }
      BPS_CHECK_EQ(data_len, ks->len) << "push length mismatch for " << h.key;

      if (is_async) {
        // Async: server-resident accumulator; apply now, reply now.
        if (!ks->param_init) {
          ks->param.assign(data, data + data_len);
          ks->param_init = true;
        } else {
          int64_t t_sum = NowUs();
          CpuReducer::Sum(ks->param.data(), data, data_len, ks->dtype);
          BPS_METRIC_HISTO_OBSERVE("bps_server_sum_us", NowUs() - t_sum);
          BPS_METRIC_COUNTER_ADD("bps_server_sum_bytes_total", data_len);
        }
        // Fleet-wide apply counter for this key: carried back on the ack
        // (and on async pull responses), so workers can measure the
        // STALENESS of each pull — how many pushes (anyone's) were
        // applied between their push and their pull. Per-key engine
        // threads make the increment race-free.
        ++ks->async_pushes;
      } else {
        int slot = h.version & 1;
        if (ks->push_count[slot] == 0) {
          ks->round[slot] = h.version;
          ks->slot[slot].assign(data, data + data_len);
        } else {
          int64_t t_sum = NowUs();
          CpuReducer::Sum(ks->slot[slot].data(), data, data_len, ks->dtype);
          BPS_METRIC_HISTO_OBSERVE("bps_server_sum_us", NowUs() - t_sum);
          BPS_METRIC_COUNTER_ADD("bps_server_sum_bytes_total", data_len);
        }
        ++ks->push_count[slot];
        // Elastic roster bookkeeping: who contributed, and a
        // retained copy of the DECODED bytes so a death shrink can
        // discard a departed rank's partial sum and rebuild exactly
        // from the survivors. Copies are freed at round ready.
        if (elastic_) ks->er[slot].Push(h.sender, data, data_len);
        // Completion: every contributor the round's roster expects has
        // pushed. Elastic compares the contributor SET against the
        // round's epoch roster (rounds in flight across a membership
        // change complete against the roster they started under);
        // non-elastic keeps the fixed-count check byte for byte.
        if (RoundComplete(ks, slot, h.version)) RoundReady(ks, slot);
      }
      if (t_trace) {
        Trace::Get().Span("s_sum", h.key, t_trace, NowUs(), h.sender,
                          h.req_id, h.version);
        Trace::Get().Flow(TRACE_FLOW_STEP, "req", h.key, t_trace,
                          TraceFlowId(h.sender, h.req_id));
      }
      const int64_t sum_us = t_rs ? NowUs() - t_rs : 0;
      if (t_rs) {
        // Server's own per-round table: sum time + encoded recv bytes.
        RoundStats::Get().Track(
            RS_SUM, h.version, sum_us,
            static_cast<int64_t>(msg.payload.size()));
        // Per-tenant engine time: rides the same clock, so
        // the off switch (BYTEPS_ROUNDSTATS_ON=0) keeps the hot path
        // one relaxed load, exactly as before.
        Tenancy::Get().Of(h.tenant)->sum_us.fetch_add(
            sum_us, std::memory_order_relaxed);
      }
      MsgHeader ack{};
      ack.cmd = CMD_PUSH_ACK;
      ack.sender = po_->my_id();
      ack.key = h.key;
      ack.req_id = h.req_id;
      // arg0 was never used on push acks: carry the server's
      // decode+sum time so the worker's round summary can attribute
      // server_sum vs wire_ack online. Old workers ignore it; old
      // servers send 0, which reads as "all wire" (degrades honestly).
      ack.arg0 = sum_us;
      if (is_async) ack.arg1 = ks->async_pushes;
      // A replayed parked sub-push already acked at park time
      // (ack-on-park above); parking never happens in async mode, so
      // the skipped ack never carried arg1.
      if (!task.replied) {
        MarkReplied(ks, h.sender, h.req_id, ack);
        SendReply(task, ack);
      }
      break;
    }

    case CMD_PULL: {
      KeyStore* ks = GetStore(h.tenant, h.key);
      BPS_CHECK(ks) << "pull for undeclared key " << h.key;
      if (async_ || (h.flags & FLAG_ASYNC)) {
        MsgHeader resp{};
        resp.cmd = CMD_PULL_RESP;
        resp.sender = po_->my_id();
        resp.key = h.key;
        resp.req_id = h.req_id;
        resp.dtype = ks->dtype;
        resp.arg1 = ks->async_pushes;
        BPS_CHECK(ks->param_init) << "async pull before any push " << h.key;
        BPS_METRIC_COUNTER_ADD("bps_server_reply_bytes_total",
                               static_cast<int64_t>(ks->param.size()));
        MarkReplied(ks, h.sender, h.req_id, resp);
        SendReply(task, resp, ks->param.data(), ks->param.size());
      } else {
        int slot = h.version & 1;
        if (ks->ready[slot] && ks->round[slot] == h.version) {
          if (ReplyPull(ks, slot, task)) ReplayParked(ks, slot);
        } else if (RetryEnabled() && ks->last_round[slot] == h.version) {
          // Pull for a COMPLETED round arriving with a fresh req_id:
          // only reachable post-recovery (a parked pull redirected to
          // the replacement after the round's aggregate was re-seeded,
          // or re-delivered while the retained replay window still
          // holds it). Serve the retained data; the round's pull
          // accounting is final, so do not advance pull_count.
          ServeRetainedPull(ks, slot, task);
        } else {
          Trace::Get().Instant("s_park", h.key, h.sender, h.req_id,
                               h.version);
          RoundStats::Get().Track(RS_PARK, h.version);
          ks->pending_pulls[slot].push_back(std::move(task));
        }
      }
      break;
    }

    case CMD_RESEED: {
      // Hot-replacement re-seed: a worker that COMPLETED
      // round `version` for this key re-pushes the round's unscaled
      // aggregate so pulls parked mid-round on the dead predecessor can
      // be served bit-identically. Highest round offered wins; all
      // offers for one round carry identical bytes (they are the same
      // completed sum), so replays and multi-worker offers are
      // idempotent.
      KeyStore* ks = GetStore(h.tenant, h.key);
      BPS_CHECK(ks) << "reseed for undeclared key " << h.key;
      Trace::Get().Note("RESEED", h.key, h.sender, h.req_id, h.version);
      Events::Get().Emit(EV_RESEED, h.key, h.sender, h.version);
      InstallAggregate(ks, h.version, msg.payload.data(),
                       msg.payload.size(), "reseed");
      MsgHeader ack{};
      ack.cmd = CMD_PUSH_ACK;
      ack.sender = po_->my_id();
      ack.key = h.key;
      ack.req_id = h.req_id;
      MarkReplied(ks, h.sender, h.req_id, ack);
      SendReply(task, ack);
      break;
    }

    case CMD_BCAST_PUSH: {
      KeyStore* ks = GetStore(h.tenant, h.key);
      BPS_CHECK(ks) << "bcast_push for undeclared key " << h.key;
      int round = h.version;
      // async pulls read ks->param; keep it tracking the latest round.
      ks->param.assign(msg.payload.begin(), msg.payload.end());
      ks->param_init = true;
      ks->last_bcast_round = round;  // bcast-pull replay fallback
      // Non-root pulls this round expects: the round's TENANT roster
      // size minus the root (a broadcast is a within-job
      // collective — only the pushing job's workers pull it).
      // Broadcasts count rounds in their own space, so a join's bcast
      // activation point picks the roster.
      int waiters =
          (elastic_
               ? static_cast<int>(
                     RosterOf(ks->tenant)->OfBcast(round)->size())
               : TenantWorkerCount(ks->tenant)) -
          1;
      if (waiters > 0) {
        auto& br = ks->bcast_rounds[round];
        br.data.assign(msg.payload.begin(), msg.payload.end());
        br.served = 0;
        br.waiters = waiters;
        // Bound stale-round growth: a worker this far behind the root
        // would already trip heartbeat failure detection, so dropping
        // the oldest unserved round only trades a hang for a hang —
        // while keeping server memory bounded.
        while (ks->bcast_rounds.size() > 16) {
          auto oldest = ks->bcast_rounds.begin();
          for (auto it = ks->bcast_rounds.begin();
               it != ks->bcast_rounds.end(); ++it) {
            if (it->first < oldest->first) oldest = it;
          }
          BPS_LOG(WARNING) << "server: dropping stale bcast round "
                           << oldest->first << " for key " << h.key;
          ks->bcast_rounds.erase(oldest);
        }
      }
      MsgHeader ack{};
      ack.cmd = CMD_PUSH_ACK;
      ack.tenant = h.tenant;
      ack.sender = po_->my_id();
      ack.key = h.key;
      ack.req_id = h.req_id;
      MarkReplied(ks, h.sender, h.req_id, ack);
      po_->van().Send(fd, ack);
      std::vector<std::pair<int, MsgHeader>> still_waiting;
      for (auto& p : ks->pending_bcast_pulls) {
        if (p.second.version == round) {
          ServeBcastRound(ks, round, p.first, p.second);
        } else {
          still_waiting.push_back(p);
        }
      }
      ks->pending_bcast_pulls.swap(still_waiting);
      break;
    }

    case CMD_BCAST_PULL: {
      KeyStore* ks = GetStore(h.tenant, h.key);
      BPS_CHECK(ks) << "bcast_pull for undeclared key " << h.key;
      if (ks->bcast_rounds.count(h.version)) {
        ServeBcastRound(ks, h.version, fd, h);
      } else {
        ks->pending_bcast_pulls.emplace_back(fd, h);
      }
      break;
    }

    // Snapshot serving. All three are read-only against the
    // immutable SnapStore and idempotent by construction — a chaos dup
    // or retry re-resolves to the same bytes — so they deliberately
    // skip the per-key dedup window above.
    case CMD_SNAP_PULL:
      ProcessSnapPull(task);
      break;
    case CMD_SNAP_SUB:
      ProcessSnapSub(task);
      break;
    case CMD_SNAP_DELTA:
      ProcessSnapDelta(task);
      break;

    default:
      BPS_LOG(WARNING) << "server: unexpected cmd " << h.cmd;
  }
}

void BytePSServer::ProcessSnapPull(EngineTask& task) {
  // Serve-side read latency (satellite): resolve + reply
  // enqueue, misses included — the replica-vs-primary serve cost the
  // client-side SnapshotClient.stats() latency cannot decompose.
  const int64_t serve_t0 = NowUs();
  const MsgHeader& h = task.msg.head;
  SnapEntry ent;
  int64_t resolved = -1;
  SnapStore::Code code =
      snapshot_retain_ > 0
          ? snaps_.Get(h.tenant, h.key, h.version, &ent, &resolved)
          : SnapStore::NOT_COMMITTED;
  MsgHeader resp{};
  resp.cmd = CMD_SNAP_RESP;
  resp.tenant = h.tenant;
  resp.sender = po_->my_id();
  resp.key = h.key;
  resp.req_id = h.req_id;
  // The CUT the reply answers for — echoed even on a miss, so a client
  // pinned to a version can assert every reply against it. On a
  // `latest` request this is the resolved committed version the client
  // then pins for the rest of its cut.
  resp.version = static_cast<int32_t>(resolved);
  resp.arg0 = code;
  BPS_METRIC_COUNTER_ADD("bps_snap_pulls_total", 1);
  if (code != SnapStore::OK) {
    po_->van().Send(task.fd, resp);
    BPS_METRIC_HISTO_OBSERVE("bps_snap_pull_us", NowUs() - serve_t0);
    return;
  }
  resp.dtype = ent.dtype;
  const bool want_quant = (h.flags & FLAG_WIRE_QUANT) != 0;
  const std::vector<char>* body;
  if (want_quant && ent.quant) {
    // Quantized serving default (EQuARX, PAPERS.md): the SAME cached
    // BlockQuant bytes the training pull leg ships — primary and
    // replica replies are byte-identical because the encode travels
    // with the delta instead of being redone per node.
    resp.flags = FLAG_WIRE_QUANT;
    resp.arg1 = static_cast<int64_t>(ent.raw->size());  // decoded size
    body = ent.quant.get();
  } else {
    // float32 opt-out (no FLAG_WIRE_QUANT in the request), or a
    // quant-ineligible key: the raw aggregate, declared as such.
    body = ent.raw.get();
  }
  // Reader reply accounting lands on the SERVING lane, not the tenant
  // stamp: tenant reply_bytes feed the training QoS split tables and a
  // reader swarm must not skew them.
  Tenancy::Get().Of(kServingLane)->reply_bytes.fetch_add(
      static_cast<int64_t>(body->size()), std::memory_order_relaxed);
  BPS_METRIC_COUNTER_ADD("bps_server_reply_bytes_total",
                         static_cast<int64_t>(body->size()));
  po_->van().Send(task.fd, resp, body->data(),
                  static_cast<int64_t>(body->size()));
  BPS_METRIC_HISTO_OBSERVE("bps_snap_pull_us", NowUs() - serve_t0);
}

void BytePSServer::ProcessSnapSub(EngineTask& task) {
  const MsgHeader& h = task.msg.head;
  int64_t through = h.arg0;
  std::vector<SnapDeltaEnt> delta =
      snaps_.CollectNewer(h.arg0, static_cast<size_t>(snap_delta_max_bytes_),
                          &through);
  // CMD_MULTI-style layout: SubHeader table + gathered payloads. Each
  // entry's payload is raw float32 followed by the cached quantized
  // encode (arg0 = the raw length, len = both), so the replica serves
  // byte-identical replies without re-encoding.
  const int count = static_cast<int>(delta.size());
  std::vector<SubHeader> table(static_cast<size_t>(count));
  std::vector<iovec> segs;
  segs.reserve(static_cast<size_t>(count) * 2 + 1);
  segs.push_back({table.data(),
                  static_cast<size_t>(count) * sizeof(SubHeader)});
  int64_t off = 0;
  for (int i = 0; i < count; ++i) {
    const SnapDeltaEnt& d = delta[static_cast<size_t>(i)];
    SubHeader& s = table[static_cast<size_t>(i)];
    s.key = d.key;
    s.cmd = CMD_SNAP_DELTA;
    s.version = static_cast<int32_t>(d.entry.version);
    s.dtype = static_cast<int16_t>(d.entry.dtype);
    s.tenant = d.tenant;
    s.arg0 = static_cast<int64_t>(d.entry.raw->size());
    const int64_t qlen =
        d.entry.quant ? static_cast<int64_t>(d.entry.quant->size()) : 0;
    s.len = s.arg0 + qlen;
    s.offset = off;
    off += s.len;
    segs.push_back({const_cast<char*>(d.entry.raw->data()),
                    d.entry.raw->size()});
    if (qlen > 0) {
      segs.push_back({const_cast<char*>(d.entry.quant->data()),
                      d.entry.quant->size()});
    }
  }
  MsgHeader resp{};
  resp.cmd = CMD_SNAP_DELTA;
  resp.tenant = h.tenant;
  resp.sender = po_->my_id();
  resp.key = h.key;
  resp.req_id = h.req_id;
  resp.arg0 = count;
  // version = the watermark this batch advances the replica to (the
  // last FULLY included version — a partial batch must not claim the
  // primary's latest); arg1 = the primary's committed latest, the
  // replica's lag gauge numerator.
  resp.version = static_cast<int32_t>(through);
  resp.arg1 = snaps_.latest();
  Tenancy::Get().Of(kServingLane)->reply_bytes.fetch_add(
      off, std::memory_order_relaxed);
  po_->van().SendV(task.fd, resp, segs.data(),
                   static_cast<int>(segs.size()));
}

void BytePSServer::ProcessSnapDelta(EngineTask& task) {
  Message& msg = task.msg;
  const MsgHeader& h = msg.head;
  const int count = static_cast<int>(h.arg0);
  if (count < 0 ||
      static_cast<int64_t>(count) * static_cast<int64_t>(sizeof(SubHeader)) >
          static_cast<int64_t>(msg.payload.size())) {
    BPS_LOG(WARNING) << "replica: malformed snapshot delta (count="
                     << count << ", payload=" << msg.payload.size()
                     << ") — dropped; the next poll repairs";
    return;
  }
  const SubHeader* table =
      reinterpret_cast<const SubHeader*>(msg.payload.data());
  const int64_t table_bytes =
      static_cast<int64_t>(count) * static_cast<int64_t>(sizeof(SubHeader));
  const char* gathered = msg.payload.data() + table_bytes;
  const int64_t gathered_len =
      static_cast<int64_t>(msg.payload.size()) - table_bytes;
  for (int i = 0; i < count; ++i) {
    const SubHeader& s = table[i];
    if (s.offset < 0 || s.len < 0 || s.arg0 < 0 || s.arg0 > s.len ||
        s.offset + s.len > gathered_len) {
      BPS_LOG(WARNING) << "replica: snapshot delta entry out of range "
                          "(key " << s.key << ") — frame dropped";
      return;
    }
    // Publish is idempotent and append-only, so a chaos-duplicated or
    // re-polled delta re-installs harmlessly.
    snaps_.Publish(s.tenant, s.key, s.version, s.dtype,
                   gathered + s.offset, static_cast<size_t>(s.arg0),
                   s.len > s.arg0 ? gathered + s.offset + s.arg0 : nullptr,
                   static_cast<size_t>(s.len - s.arg0));
  }
  // Adopt the primary's committed watermark for this batch: every entry
  // up to `version` is now held, so `latest` may advance even when this
  // replica joined mid-history and per-key commit counting would never
  // converge on the evicted prefix.
  snaps_.ForceLatest(h.version);
  const int64_t lag = h.arg1 >= 0 ? h.arg1 - snaps_.latest() : 0;
  BPS_METRIC_GAUGE_SET("bps_replica_lag_rounds", lag > 0 ? lag : 0);
  // Lag-warn journal entry: emitted on the CROSSING into
  // lagging (monitor.top's REPLICA-LAGGING threshold), not per batch —
  // a replica stuck behind would otherwise flood the ring.
  {
    static const int64_t lag_warn = [] {
      const char* v = getenv("BYTEPS_REPLICA_LAG_ROUNDS");
      long long r = v && *v ? atoll(v) : 8;
      return r > 0 ? r : 8;
    }();
    const bool lagging = lag > lag_warn;
    if (lagging && !replica_lagging_) {
      Events::Get().Emit(EV_REPLICA_LAG, lag, snaps_.latest());
    }
    replica_lagging_ = lagging;
  }
  BPS_METRIC_GAUGE_SET("bps_snapshot_version", snaps_.latest());
  if (count > 0) {
    Trace::Get().Note("SNAP_DELTA", count, static_cast<int>(h.version));
  }
}

void BytePSServer::StartReplicaPoll() {
  if (replica_of_ < 0) return;
  replica_thread_ = std::thread([this] { ReplicaPollLoop(); });
}

void BytePSServer::ReplicaPollLoop() {
  const int primary_id = Postoffice::ServerId(replica_of_);
  long poll_ms = 200;
  if (const char* pv = getenv("BYTEPS_REPLICA_POLL_MS")) {
    const long v = atol(pv);
    if (v > 0) poll_ms = v;
  }
  int fd = -1;
  while (!stopped_.load() && !po_->ShuttingDown()) {
    if (fd < 0) {
      // (Re-)dial the primary from the LIVE address book — a
      // hot-replaced primary re-enters here with its
      // replacement's address. The hello registers this fd on the
      // primary like any worker stripe.
      NodeInfo primary{};
      if (!po_->NodeOf(primary_id, &primary)) {
        BPS_LOG(WARNING) << "replica: primary server rank " << replica_of_
                         << " not in the address book yet";
        usleep(static_cast<useconds_t>(poll_ms) * 1000);
        continue;
      }
      fd = po_->van().Connect(primary.host, primary.port);
      if (fd < 0) {
        usleep(static_cast<useconds_t>(poll_ms) * 1000);
        continue;
      }
      MsgHeader hello{};
      hello.cmd = CMD_REGISTER;
      hello.sender = po_->my_id();
      hello.arg1 = ROLE_REPLICA;
      po_->van().Send(fd, hello);
    }
    MsgHeader sub{};
    sub.cmd = CMD_SNAP_SUB;
    sub.sender = po_->my_id();
    sub.req_id = 0;
    // Watermark: the highest version we hold; -1 on a fresh join means
    // "everything you have" — the full-state catch-up.
    sub.arg0 = snaps_.latest();
    if (!po_->van().Send(fd, sub)) {
      // Dead primary connection: drop the fd and re-dial next tick
      // (the book may meanwhile be updated with a hot replacement). A
      // replica never escalates — its readers fail over, the fleet
      // never notices.
      BPS_LOG(WARNING) << "replica: lost primary connection — "
                          "re-dialing from the address book";
      fd = -1;
      continue;
    }
    for (long slept = 0; slept < poll_ms && !stopped_.load();
         slept += 50) {
      usleep(50 * 1000);
    }
  }
}

void BytePSServer::EndReseedGrace() {
  // exchange: exactly one engine thread runs the teardown.
  if (!recover_mode_.exchange(false)) return;
  Trace::Get().Note("RESEED_GRACE_END");
  std::unordered_map<int64_t, std::vector<EngineTask>> parked;
  {
    std::lock_guard<std::mutex> lk(store_mu_);
    parked.swap(pre_declare_parked_);
  }
  size_t n = 0;
  for (auto& kv : parked) {
    for (auto& t : kv.second) {
      SendWireError(t.fd, t.msg.head,
                    "key " + std::to_string(kv.first) +
                        " was never re-declared within the re-seed grace "
                        "window (" + std::to_string(RecoveryTimeoutMs()) +
                        " ms) — protocol violation, not a re-seed race");
      ++n;
    }
  }
  BPS_LOG(WARNING) << "server: re-seed grace ended — unknown-key fatal "
                      "restored"
                   << (n ? ", failed " + std::to_string(n) +
                               " op(s) parked without a re-declare"
                         : "");
  // Note: the grace ending does NOT clear store_/dedup state — keys
  // re-declared in time keep serving normally; only the park-unknown
  // leniency is withdrawn.
}

bool BytePSServer::ParkUndeclared(EngineTask&& task) {
  Trace::Get().Note("PARK_UNDECLARED", task.msg.head.key,
                    task.msg.head.sender, task.msg.head.req_id);
  // Keepalive first (task is moved below): the sender's retry budget
  // stays fresh while its re-declare is still in flight.
  SendKeepalive(task);
  BPS_LOG(WARNING) << "server: parking " << task.msg.head.cmd
                   << " for not-yet-redeclared key " << task.msg.head.key
                   << " (re-seed in progress)";
  std::lock_guard<std::mutex> lk(store_mu_);
  pre_declare_parked_[TenantKey(task.msg.head.tenant,
                               task.msg.head.key)]
      .push_back(std::move(task));
  return true;
}

void BytePSServer::ServeRetainedPull(KeyStore* ks, int slot,
                                     const EngineTask& t) {
  const MsgHeader& req = t.msg.head;
  const int64_t t_trace = Trace::Get().MainOn() ? NowUs() : 0;
  MsgHeader resp{};
  resp.cmd = CMD_PULL_RESP;
  resp.sender = po_->my_id();
  resp.key = req.key;
  resp.req_id = req.req_id;
  resp.dtype = ks->dtype;
  resp.version = req.version;
  // Mean divisor of the RETAINED round (set at recycle / reseed).
  resp.arg1 = ks->last_contrib_n[slot] > 0 ? ks->last_contrib_n[slot]
                                           : ks->contrib_n[slot];
  if (ks->reply_comp &&
      CachedReplyValid(ks->comp_reply_round[slot], req.version,
                       !ks->comp_reply[slot].empty())) {
    // Normal-operation replay window: the cached encode is still valid
    // AND tagged with this exact round. (A re-seeded slot clears it —
    // and a tag minted for a different round must never replay here —
    // either way the authoritative raw bytes below serve instead.)
    resp.flags = FLAG_COMPRESSED;
    resp.arg0 = ks->len;
    BPS_METRIC_COUNTER_ADD(
        "bps_server_reply_bytes_total",
        static_cast<int64_t>(ks->comp_reply[slot].size()));
    MarkReplied(ks, req.sender, req.req_id, resp);
    SendReply(t, resp, ks->comp_reply[slot].data(),
              ks->comp_reply[slot].size());
  } else if ((req.flags & FLAG_WIRE_QUANT) &&
             CachedReplyValid(ks->qreply_round[slot], req.version,
                              !ks->qreply[slot].empty())) {
    // Quantized replay window (same rule as comp_reply above); a
    // re-seeded slot cleared the cache and serves the authoritative
    // float32 below — which is byte-identical to what the fault-free
    // run's workers DECODED, so recovery stays bit-identical.
    resp.flags = FLAG_WIRE_QUANT;
    resp.arg0 = ks->len;
    BPS_METRIC_COUNTER_ADD(
        "bps_server_reply_bytes_total",
        static_cast<int64_t>(ks->qreply[slot].size()));
    BPS_METRIC_COUNTER_ADD(
        "bps_quant_bytes_on_wire_total",
        static_cast<int64_t>(ks->qreply[slot].size()));
    BPS_METRIC_COUNTER_ADD(
        "bps_quant_bytes_saved_total",
        ks->len - static_cast<int64_t>(ks->qreply[slot].size()));
    MarkReplied(ks, req.sender, req.req_id, resp);
    SendReply(t, resp, ks->qreply[slot].data(),
              ks->qreply[slot].size());
  } else {
    BPS_METRIC_COUNTER_ADD("bps_server_reply_bytes_total",
                           static_cast<int64_t>(ks->slot[slot].size()));
    MarkReplied(ks, req.sender, req.req_id, resp);
    SendReply(t, resp, ks->slot[slot].data(), ks->slot[slot].size());
  }
  if (t_trace) {
    Trace::Get().Span("s_reply", req.key, t_trace, NowUs(), req.sender,
                      req.req_id, req.version);
    Trace::Get().Flow(TRACE_FLOW_STEP, "reply", req.key, t_trace,
                      TraceFlowId(req.sender, req.req_id));
  }
}

void BytePSServer::RoundReady(KeyStore* ks, int slot) {
  ks->ready[slot] = true;
  ks->pull_count[slot] = 0;
  // The round's contributor count is FINAL here: it rides every sync
  // PULL_RESP's arg1 as the worker-side mean divisor, so a pull issued
  // under an older fleet size still divides by this round's roster.
  ks->contrib_n[slot] = ks->push_count[slot];
  if (elastic_) ks->er[slot].SealPushes();
  if (ks->reply_comp) {
    // Encode once per round; every worker's reply ships the same
    // compressed aggregate (and EF state advances once).
    ks->reply_comp->Compress(
        reinterpret_cast<const float*>(ks->slot[slot].data()),
        ks->len / static_cast<int64_t>(sizeof(float)),
        &ks->comp_reply[slot]);
    ks->comp_reply_round[slot] = ks->round[slot];
  } else if (ks->quant_ok) {
    // Re-quantize the aggregate once per round; every flagged pull
    // (and every dedup replay) serves the same cached bytes, so
    // replies stay deterministic under chaos.
    EncodeQuantReply(ks, slot);
    ks->qreply_round[slot] = ks->round[slot];
  }
  // Snapshot publication: the finished aggregate becomes the
  // round's immutable serving cut. Copy-on-publish — readers share the
  // SnapStore's copy, never this slot, which the engine is about to
  // keep mutating. The cached quant encode travels along so a replica
  // serves byte-identical quantized replies. A replica never publishes
  // from its own rounds (it has none); deltas install directly.
  if (snapshot_retain_ > 0 && replica_of_ < 0) {
    const char* q = nullptr;
    size_t qlen = 0;
    if (ks->quant_ok &&
        CachedReplyValid(ks->qreply_round[slot], ks->round[slot],
                         !ks->qreply[slot].empty())) {
      q = ks->qreply[slot].data();
      qlen = ks->qreply[slot].size();
    }
    if (snaps_.Publish(ks->tenant, ks->key, ks->round[slot], ks->dtype,
                       ks->slot[slot].data(), ks->slot[slot].size(), q,
                       qlen)) {
      BPS_METRIC_COUNTER_ADD("bps_snap_publish_total", 1);
      BPS_METRIC_GAUGE_SET("bps_snapshot_version", snaps_.latest());
      // Durable spill: if the committed version just crossed
      // a spill boundary, hand the cut to the async writer. Engine-side
      // cost is pointer work only (shared_ptr cut + queue push).
      if (!ckpt_dir_.empty()) MaybeSpillCkpt();
    }
  }
  // Release pulls that arrived before the last push — but only this
  // round's; a later round's pulls stay parked. Move the list out
  // first: ReplyPull may recycle the slot, and its replay can append
  // fresh entries.
  const int ver = ks->round[slot];
  std::vector<EngineTask> waiting;
  waiting.swap(ks->pending_pulls[slot]);
  bool recycled = false;
  for (auto& p : waiting) {
    if (p.msg.head.version == ver) {
      recycled |= ReplyPull(ks, slot, p);
    } else {
      ks->pending_pulls[slot].push_back(std::move(p));
    }
  }
  if (recycled) ReplayParked(ks, slot);
}

bool BytePSServer::ReplyPull(KeyStore* ks, int slot, const EngineTask& t) {
  const MsgHeader& req = t.msg.head;
  const int64_t t_trace = Trace::Get().MainOn() ? NowUs() : 0;
  MsgHeader resp{};
  resp.cmd = CMD_PULL_RESP;
  resp.sender = po_->my_id();
  resp.key = req.key;
  resp.req_id = req.req_id;
  resp.dtype = ks->dtype;
  resp.version = req.version;
  // Sync mean divisor: the round's ACTUAL contributor count.
  // A pull issued before a membership change captured a stale fleet
  // size; the worker divides by this instead, so every aggregate is an
  // exact mean over the round's roster. (Async replies carry their
  // apply counter in arg1 through their own branch, untouched.)
  resp.arg1 = ks->contrib_n[slot];
  // Cached-encode guards: a cached re-encode is served only when its
  // round tag matches the round this reply answers for (stale-reply
  // hazard). Tag mismatch — a re-seeded slot, or a
  // replay racing a recycle — falls through to the raw slot bytes.
  if (ks->reply_comp &&
      CachedReplyValid(ks->comp_reply_round[slot], req.version,
                       !ks->comp_reply[slot].empty())) {
    resp.flags = FLAG_COMPRESSED;
    resp.arg0 = ks->len;  // decompressed size, for the worker's check
    BPS_METRIC_COUNTER_ADD(
        "bps_server_reply_bytes_total",
        static_cast<int64_t>(ks->comp_reply[slot].size()));
    MarkReplied(ks, req.sender, req.req_id, resp);
    SendReply(t, resp, ks->comp_reply[slot].data(),
              ks->comp_reply[slot].size());
  } else if ((req.flags & FLAG_WIRE_QUANT) &&
             CachedReplyValid(ks->qreply_round[slot], req.version,
                              !ks->qreply[slot].empty())) {
    // Quantized reply leg: the round's cached re-quantized aggregate.
    // Serve-by-request — a pull without the flag (or a slot whose
    // cache a re-seed cleared) falls through to the raw bytes below,
    // and the response header declares which encoding it carries.
    resp.flags = FLAG_WIRE_QUANT;
    resp.arg0 = ks->len;  // decoded size, for the worker's check
    BPS_METRIC_COUNTER_ADD(
        "bps_server_reply_bytes_total",
        static_cast<int64_t>(ks->qreply[slot].size()));
    BPS_METRIC_COUNTER_ADD(
        "bps_quant_bytes_on_wire_total",
        static_cast<int64_t>(ks->qreply[slot].size()));
    BPS_METRIC_COUNTER_ADD(
        "bps_quant_bytes_saved_total",
        ks->len - static_cast<int64_t>(ks->qreply[slot].size()));
    MarkReplied(ks, req.sender, req.req_id, resp);
    SendReply(t, resp, ks->qreply[slot].data(),
              ks->qreply[slot].size());
  } else {
    BPS_METRIC_COUNTER_ADD("bps_server_reply_bytes_total",
                           static_cast<int64_t>(ks->slot[slot].size()));
    MarkReplied(ks, req.sender, req.req_id, resp);
    SendReply(t, resp, ks->slot[slot].data(), ks->slot[slot].size());
  }
  if (t_trace) {
    Trace::Get().Span("s_reply", req.key, t_trace, NowUs(), req.sender,
                      req.req_id, req.version);
    Trace::Get().Flow(TRACE_FLOW_STEP, "reply", req.key, t_trace,
                      TraceFlowId(req.sender, req.req_id));
  }
  ++ks->pull_count[slot];
  if (elastic_) ks->er[slot].Pull(req.sender);
  if (RoundServed(ks, slot, req.version)) {
    // Round fully served; recycle the slot for round r+2. The slot's
    // DATA (and cached compressed encode) are deliberately retained:
    // they are the replay window for a pull whose response was lost in
    // flight (AnswerDuplicate serves them again until the next round
    // assigns over them — which per-key chaining delays until every
    // worker provably received this round).
    ks->last_round[slot] = ks->round[slot];
    ks->last_contrib_n[slot] = ks->contrib_n[slot];
    ks->push_count[slot] = 0;
    ks->pull_count[slot] = 0;
    ks->ready[slot] = false;
    ks->round[slot] = -1;
    if (elastic_) ks->er[slot].Reset();
    return true;
  }
  return false;
}

void BytePSServer::ReplayParked(KeyStore* ks, int slot) {
  // Re-run parked pushes through Process: those for the slot's next
  // round are accepted (and acked); any for a yet-later round re-park
  // themselves. Move the list out first — Process appends re-parks.
  auto parked = std::move(ks->parked_pushes[slot]);
  ks->parked_pushes[slot].clear();
  for (auto& t : parked) {
    // The replay is the ORIGINAL request completing, not a wire
    // duplicate — it must bypass the dedup window its first arrival
    // recorded (and keep bypassing it if it re-parks).
    t.from_park = true;
    Process(std::move(t));
  }
}

void BytePSServer::ReplyBcastPull(KeyStore* ks, int fd, const MsgHeader& req) {
  MsgHeader resp{};
  resp.cmd = CMD_PULL_RESP;
  resp.tenant = req.tenant;
  resp.sender = po_->my_id();
  resp.key = req.key;
  resp.req_id = req.req_id;
  resp.dtype = ks->dtype;
  po_->van().Send(fd, resp, ks->param.data(), ks->param.size());
}

void BytePSServer::ServeBcastRound(KeyStore* ks, int round, int fd,
                                   const MsgHeader& req) {
  auto it = ks->bcast_rounds.find(round);
  BPS_CHECK(it != ks->bcast_rounds.end());
  MsgHeader resp{};
  resp.cmd = CMD_PULL_RESP;
  resp.tenant = req.tenant;
  resp.sender = po_->my_id();
  resp.key = req.key;
  resp.req_id = req.req_id;
  resp.dtype = ks->dtype;
  resp.version = round;
  MarkReplied(ks, req.sender, req.req_id, resp);
  po_->van().Send(fd, resp, it->second.data.data(), it->second.data.size());
  // Waiter quota frozen at push time (see HandleBcastPush) — except
  // that a push racing ahead of this server's FLEET_RESUME can have
  // frozen a stale (smaller) roster; taking the max against the
  // round's CURRENT roster keeps the round alive for the joiner's
  // pull instead of erasing it one pull early.
  int waiters = it->second.waiters > 0
                    ? it->second.waiters
                    : TenantWorkerCount(ks->tenant) - 1;
  if (elastic_) {
    waiters = std::max(
        waiters,
        static_cast<int>(RosterOf(ks->tenant)->OfBcast(round)->size()) -
            1);
  }
  if (++it->second.served >= waiters) {
    ks->bcast_rounds.erase(it);
  }
}

void BytePSServer::EncodeQuantReply(KeyStore* ks, int slot) {
  // NO error feedback on this leg (see KeyStore::quant_ok): the encode
  // is a pure function of the aggregate, so a hot replacement's replies
  // match the dead predecessor's bit for bit.
  const int64_t n = ks->len / static_cast<int64_t>(sizeof(float));
  BPS_CHECK(BlockQuant::Encode(
      reinterpret_cast<const float*>(ks->slot[slot].data()), n,
      quant_block_, &ks->qreply[slot]))
      << "non-finite aggregate for key while re-quantizing pull reply "
         "(slot " << slot << ") — a worker shipped garbage that the "
         "dequant-sum accepted";
}

void BytePSServer::InstallAggregate(KeyStore* ks, int64_t version,
                                    const char* data, size_t len,
                                    const char* why) {
  const int ver = static_cast<int>(version);
  const int slot = ver & 1;
  // Install only when the slot is not owned by a LATER round. A
  // chaos-dropped reseed offer re-delivered by the retry timer can
  // land after the fleet advanced to round ver+2 on the same slot
  // parity (last_round[slot] is still -1 on a fresh replacement
  // because round ver completed on the dead predecessor); assigning
  // over that partial ver+2 sum would complete the round with a
  // silently corrupted aggregate. A stale offer carries nothing the
  // fleet still needs — per-key chaining means no worker can be
  // parked on round ver once ver+2 pushes exist — so skip it.
  const bool slot_owned_by_newer =
      ks->push_count[slot] > 0 && ks->round[slot] != ver;
  if (!(ver > ks->last_round[slot] && ks->round[slot] <= ver &&
        !slot_owned_by_newer)) {
    BPS_LOG(INFO) << "install (" << why << ") skipped for key " << ks->key
                  << " round " << ver << " — slot serves round "
                  << ks->last_round[slot] << "/accumulates "
                  << ks->round[slot];
    return;
  }
  ks->slot[slot].assign(data, data + len);
  ks->last_round[slot] = ver;
  // The installed bytes ARE a completed round's sum over the then-full
  // fleet: its mean divisor is the current worker count.
  ks->last_contrib_n[slot] = TenantWorkerCount(ks->tenant);
  // The slot may already be accumulating this round from recovery
  // re-pushes that arrived first; the install IS that round's final
  // sum — supersede the partial accumulation.
  if (ks->round[slot] == ver) {
    ks->round[slot] = -1;
    ks->push_count[slot] = 0;
    ks->pull_count[slot] = 0;
    ks->ready[slot] = false;
    if (elastic_) ks->er[slot].Reset();
  }
  ks->comp_reply[slot].clear();
  ks->comp_reply_round[slot] = -1;
  // The quantized-reply cache is stale too: an installed slot serves
  // the authoritative float32 bytes raw (exactly what the fault-free
  // workers decoded — see ServeRetainedPull). Tags go to -1 with the
  // bytes: "cleared by install" is the one mismatch the serve sites
  // answer with raw instead of a replay-window error.
  ks->qreply[slot].clear();
  ks->qreply_round[slot] = -1;
  // Pulls for this round parked before the install landed are
  // servable now.
  std::vector<EngineTask> waiting;
  waiting.swap(ks->pending_pulls[slot]);
  for (auto& p : waiting) {
    if (p.msg.head.version == ver) {
      ServeRetainedPull(ks, slot, p);
    } else {
      ks->pending_pulls[slot].push_back(std::move(p));
    }
  }
}

void BytePSServer::MaybeInstallRestored(KeyStore* ks) {
  // One-shot disk load, deferred to the FIRST declared key: the
  // fleet-committed restore epoch only exists once the address book
  // arrived, and an INIT_KEY is proof formation finished — so the
  // WaitRestoreRound below can never block formation itself.
  std::call_once(restore_once_, [this] {
    const int64_t epoch = po_->WaitRestoreRound();
    BPS_CHECK_GE(epoch, 0)
        << "ckpt-restore: this server is restore-armed but the "
           "scheduler committed no restore epoch — mixed arming "
           "fail-stops at formation, so this is a protocol bug";
    std::vector<CkptItem> items;
    int64_t round = -1;
    std::string why;
    const int rank = po_->my_id() - 1;
    BPS_CHECK(CkptLoad(ckpt_dir_, rank, epoch, &items, &round, &why))
        << "ckpt-restore: shard rank " << rank
        << " cannot load the fleet-committed restore epoch " << epoch
        << ": " << why
        << " — fail-stop (installing less would silently cold-start "
           "this shard and diverge the model)";
    std::lock_guard<std::mutex> lk(restore_mu_);
    ckpt_restore_round_ = epoch;
    for (auto& it : items) {
      restored_[{it.tenant, it.key}] = std::move(it);
    }
    BPS_LOG(WARNING) << "server: loaded " << restored_.size()
                     << " key(s) from checkpoint version " << epoch
                     << " — installing as keys re-declare";
  });
  CkptItem item;
  {
    std::lock_guard<std::mutex> lk(restore_mu_);
    auto it = restored_.find({ks->tenant, ks->key});
    if (it == restored_.end()) return;  // not in the checkpoint (new key)
    item = std::move(it->second);
    restored_.erase(it);
  }
  BPS_CHECK_EQ(static_cast<int64_t>(item.data.size()), ks->len)
      << "ckpt-restore: key " << ks->key << " declared with length "
      << ks->len << " but the checkpoint holds "
      << item.data.size() << " bytes — the model changed shape; "
         "fail-stop instead of installing garbage";
  // Install at the RESTORE round (not the entry's own version — an
  // idle key's entry may be older): the whole fleet resumes from one
  // round, and the worker's first post-resume pull is for it.
  InstallAggregate(ks, ckpt_restore_round_, item.data.data(),
                   item.data.size(), "ckpt-restore");
  // Publish into the snapshot store at the restore round: commit
  // gating makes version R `latest` once the last key installs, and
  // the workers' state pull (plus external readers) resume from R.
  if (snapshot_retain_ > 0) {
    if (snaps_.Publish(item.tenant, item.key, ckpt_restore_round_,
                       item.dtype, item.data.data(), item.data.size())) {
      BPS_METRIC_COUNTER_ADD("bps_snap_publish_total", 1);
      BPS_METRIC_GAUGE_SET("bps_snapshot_version", snaps_.latest());
    }
  }
}

void BytePSServer::MaybeSpillCkpt() {
  // Lazy writer start: the shard rank is only known post-formation,
  // and RoundReady proves the book arrived. Engine threads race this;
  // Start's CAS keeps exactly one winner.
  if (!ckpt_writer_.running()) {
    ckpt_writer_.Start(ckpt_dir_, po_->my_id() - 1, ckpt_every_,
                       ckpt_retain_, ckpt_chaos_, po_->num_workers(),
                       po_->num_servers());
  }
  const int64_t latest = snaps_.latest();
  if (latest < 0) return;
  if (ckpt_writer_.ShouldSpill(latest)) {
    bool complete = false;
    auto cut = snaps_.CollectCut(latest, &complete);
    // A committed version is complete by construction; an incomplete
    // cut here means the ring already evicted part of it (a spill
    // boundary far behind latest) — skip rather than persist a torn
    // checkpoint.
    if (complete) {
      ckpt_writer_.Enqueue(latest, std::move(cut));
    } else {
      BPS_LOG(WARNING) << "ckpt: skipping spill of version " << latest
                       << " — cut no longer complete in the ring";
    }
  }
  BPS_METRIC_GAUGE_SET(
      "bps_ckpt_lag_rounds",
      latest - std::max<int64_t>(0, ckpt_writer_.last_spilled()));
}

void BytePSServer::Stop() {
  if (queues_.empty()) return;
  stopped_.store(true);
  ckpt_writer_.Stop();
  if (replica_thread_.joinable()) replica_thread_.join();
  for (auto& eq : queues_) {
    std::lock_guard<std::mutex> lk(eq->mu);
    eq->cv.notify_all();
  }
  for (auto& t : threads_) {
    if (t.joinable()) t.join();
  }
  threads_.clear();
  queues_.clear();
}

}  // namespace bps
