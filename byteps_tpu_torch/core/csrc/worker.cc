#include "worker.h"

#include <sys/uio.h>

#include <algorithm>
#include <chrono>
#include <cstring>
#include <map>

#include "cpu_reducer.h"
#include "events.h"
#include "logging.h"
#include "metrics.h"
#include "roundstats.h"
#include "tenancy.h"

namespace bps {

thread_local std::vector<BytePSWorker::PushOp>* BytePSWorker::fusion_sink_ =
    nullptr;

void BytePSWorker::Start(Postoffice* po, KVWorker* kv, int64_t partition_bytes,
                         int64_t credit_bytes, int64_t fusion_bytes,
                         int fusion_keys, std::string default_comp,
                         bool trace_on) {
  po_ = po;
  kv_ = kv;
  partition_bytes_ = partition_bytes;
  fusion_bytes_ = fusion_bytes < 0 ? 0 : fusion_bytes;
  // Backstop for direct FFI users (the Python config layer rejects this
  // combination when fusion is on, and ignores fusion_keys when it is
  // off): clamp to the minimum batch of 2, loudly when it matters.
  if (fusion_keys < 2 && fusion_bytes_ > 0) {
    BPS_LOG(WARNING) << "fusion_keys=" << fusion_keys
                     << " below the minimum fused batch of 2; clamping to 2";
  }
  fusion_keys_ = fusion_keys < 2 ? 2 : fusion_keys;
  // Flush linger: how long the collector waits for the enqueuing thread
  // to deliver the next fusible task before flushing a partial batch.
  // Bounded per batch; small vs a framed round trip but long vs the
  // enqueuer's per-task cadence, so batches actually form.
  if (const char* lv = getenv("BYTEPS_FUSION_LINGER_US")) {
    fusion_linger_us_ = atoll(lv);
    if (fusion_linger_us_ < 0) fusion_linger_us_ = 0;
  }
  // Block-quantized wire: the Python config layer validates
  // these; the clamp here is a backstop for direct FFI users so a bad
  // block can never reach the codec (Encode refuses invalid blocks).
  if (const char* qv = getenv("BYTEPS_WIRE_QUANT")) {
    wire_quant_ = atoi(qv) != 0;
  }
  if (const char* qb = getenv("BYTEPS_WIRE_QUANT_BLOCK")) {
    quant_block_ = atoi(qb);
  }
  if (!BlockQuant::ValidBlock(quant_block_)) {
    if (wire_quant_) {
      BPS_LOG(WARNING) << "BYTEPS_WIRE_QUANT_BLOCK=" << quant_block_
                       << " is not a power of two in [16, 32768]; "
                          "using 64";
    }
    quant_block_ = 64;
  }
  if (const char* qm = getenv("BYTEPS_WIRE_QUANT_MIN_BYTES")) {
    quant_min_bytes_ = atoll(qm);
    if (quant_min_bytes_ < 0) quant_min_bytes_ = 0;
  }
  default_comp_ = std::move(default_comp);
  trace_on_ = trace_on;
  // Pre-register the worker-side metric catalog: every stage's series
  // exists from zero on the /metrics page (an idle or compression-less
  // worker omits nothing — scrapers sum and ratio these fleet-wide).
  Metrics::Get().Counter("bps_partitions_enqueued_total");
  Metrics::Get().Counter("bps_enqueued_bytes_total");
  Metrics::Get().Counter("bps_push_bytes_total");
  Metrics::Get().Counter("bps_push_partitions_total");
  Metrics::Get().Counter("bps_pull_bytes_total");
  Metrics::Get().Counter("bps_fused_msgs_total");
  Metrics::Get().Histogram("bps_fusion_batch_keys");
  // Quantized-wire accounting (docs/monitoring.md): encoded bytes that
  // actually crossed the wire and the raw-minus-encoded savings, both
  // legs (push encode here, pull decode below). Present-from-zero so
  // monitor.top's compression-ratio column reads 1.0x, not a hole.
  Metrics::Get().Counter("bps_quant_bytes_on_wire_total");
  Metrics::Get().Counter("bps_quant_bytes_saved_total");
  Metrics::Get().Histogram("bps_push_us");
  Metrics::Get().Histogram("bps_pull_us");
  // Transient-fault telemetry: present-from-zero so monitor.top and
  // /healthz can watch a climbing retry rate BEFORE a node goes dead
  // (docs/monitoring.md). bps_chaos_injected_total stays lazily
  // registered — nonzero only when fault injection is armed.
  Metrics::Get().Counter("bps_retries_total");
  Metrics::Get().Counter("bps_reconnects_total");
  Metrics::Get().Counter("bps_seq_gaps_total");
  Metrics::Get().Counter("bps_seq_dups_total");
  // Hot-replacement telemetry (docs/monitoring.md "Recovery"):
  // recoveries this worker completed, the fleet membership epoch, and
  // whether a rank is mid-recovery right now.
  Metrics::Get().Counter("bps_recoveries_total");
  Metrics::Get().Gauge("bps_membership_epoch");
  Metrics::Get().Gauge("bps_recovering");
  // Per-round introspection series: present-from-zero so
  // monitor.top's BOTTLENECK column reads zeros, not holes, on an idle
  // worker. The gauges hold the LAST completed round's stage breakdown
  // (published by RoundStats at round finalize).
  Metrics::Get().Counter("bps_rounds_completed_total");
  for (const char* g :
       {"bps_round_last", "bps_round_parts", "bps_round_queue_us",
        "bps_round_comp_us", "bps_round_push_us", "bps_round_sum_us",
        "bps_round_wire_ack_us", "bps_round_pull_us", "bps_round_dec_us",
        "bps_round_wire_bytes", "bps_round_wire_msgs",
        "bps_round_retries", "bps_round_parked"}) {
    Metrics::Get().Gauge(g);
  }
  Metrics::Get().Histogram("bps_round_wall_us");
  recovery_on_ = RecoveryEnabled();
  // Reference semantics: BYTEPS_SCHEDULING_CREDIT is an in-flight BYTE
  // budget. 0 = auto: four full partitions' worth. A value under 1024
  // can only be a legacy partition count (the reference default was 4;
  // no real byte budget is smaller than 1 KiB, and no in-flight count
  // reaches 1024) — honouring it as bytes would serialise every push,
  // so interpret it AS a partition count (credit × partition_bytes) so
  // legacy env users keep their intended overlap. Values >= 1024 are
  // honoured as bytes, so small genuine budgets stay expressible.
  // This is the SINGLE conversion point: the Python config layer warns
  // about sub-1024 values but passes them through unchanged.
  if (credit_bytes > 0 && credit_bytes < 1024) {
    BPS_LOG(WARNING) << "BYTEPS_SCHEDULING_CREDIT=" << credit_bytes
                     << " looks like a legacy in-flight partition count; "
                     << "interpreting as " << credit_bytes << " x "
                     << partition_bytes << " bytes";
    credit_bytes = credit_bytes * partition_bytes;
  }
  if (credit_bytes <= 0) credit_bytes = 4 * partition_bytes;
  queue_ = std::make_unique<ScheduledQueue>(credit_bytes);
  // Sender parallelism: the van's writev blocks once a connection's
  // SNDBUF fills, and with ONE push thread a full stripe head-of-line
  // blocks sends to every OTHER stripe/server (exposed by the BDP
  // sweep: N stripes measured one stripe's goodput). Concurrent pops
  // are order-safe under the synchronous step pattern every in-tree
  // caller uses (jax/training.py waits all handles each step): a key's
  // next-round push_pull is only issued after the previous round's
  // pull completed, so two tasks for one key never coexist in the
  // queue, and the van's per-fd lock serialises same-connection
  // writes. A caller that DEEP-PIPELINES one tensor (3+ push_pull
  // handles in flight — see the version comment in PushPull) can have
  // rounds r and r+2 of a key queued at once; per-key wire order then
  // requires a single push thread (set BYTEPS_PUSH_THREADS=1 when
  // striping is on), and the fusion collector's duplicate-key flush in
  // PushLoop handles exactly that case. Default: match the stripe
  // count (capped), 1 when unstriped (the single-thread wire order
  // PS_VERBOSE users expect).
  int push_threads = 0;
  if (const char* pt = getenv("BYTEPS_PUSH_THREADS")) {
    push_threads = atoi(pt);
  }
  if (push_threads <= 0) {
    int streams = 1;
    if (const char* sv = getenv("BYTEPS_VAN_STREAMS")) {
      streams = atoi(sv);
    }
    push_threads = streams > 1 ? std::min(streams, 8) : 1;
  }
  for (int i = 0; i < push_threads; ++i) {
    push_threads_.emplace_back([this] { PushLoop(); });
  }
}

void BytePSWorker::Stop() {
  if (queue_) queue_->Stop();
  for (auto& t : push_threads_) {
    if (t.joinable()) t.join();
  }
  push_threads_.clear();
  std::vector<std::thread> rec;
  {
    std::lock_guard<std::mutex> lk(rec_threads_mu_);
    rec.swap(rec_threads_);
  }
  for (auto& t : rec) {
    if (t.joinable()) t.join();
  }
}

// --- elastic worker membership ------------------------------------

void BytePSWorker::OnFleetPause(int kind) {
  if (kind != 0) return;  // only a JOIN gates new rounds
  int64_t rmax, bmax;
  {
    std::lock_guard<std::mutex> lk(mu_);
    fleet_paused_ = true;
    rmax = sync_round_;
    bmax = sync_bcast_round_;
    for (auto& ctx : tensors_) {
      rmax = std::max(rmax, ctx->round);
      bmax = std::max(bmax, ctx->bcast_round);
    }
  }
  // Drain-free ack: every round this worker has ISSUED is < the
  // counters reported here, and those rounds complete against the OLD
  // roster (the server's per-epoch contributor sets) — so the gate
  // alone makes the counters final; nothing has to settle first.
  BPS_LOG(WARNING) << "worker: fleet join in progress — new rounds "
                      "gated at round " << rmax;
  po_->SendFleetPauseAck(rmax, bmax);
}

void BytePSWorker::OnFleetResume(int kind, int64_t join_round,
                                 int64_t join_bcast) {
  {
    std::lock_guard<std::mutex> lk(mu_);
    if (kind == 0) {
      // Jump every tensor's counters to the join activation round:
      // each member's NEXT round is the first one the new roster —
      // joiner included — is expected in. Counters only move forward.
      sync_round_ = std::max(sync_round_, join_round);
      sync_bcast_round_ = std::max(sync_bcast_round_, join_bcast);
      for (auto& ctx : tensors_) {
        if (ctx->round < sync_round_) ctx->round = sync_round_;
        if (ctx->bcast_round < sync_bcast_round_) {
          ctx->bcast_round = sync_bcast_round_;
        }
      }
    }
    fleet_paused_ = false;
  }
  cv_.notify_all();
}

int64_t BytePSWorker::MaxIssuedRound() {
  std::lock_guard<std::mutex> lk(mu_);
  int64_t rmax = sync_round_;
  for (auto& ctx : tensors_) rmax = std::max(rmax, ctx->round);
  return rmax;
}

void BytePSWorker::OnSchedRecovered() {
  bool was_gated;
  {
    std::lock_guard<std::mutex> lk(mu_);
    was_gated = fleet_paused_;
    fleet_paused_ = false;
  }
  if (was_gated) {
    BPS_LOG(WARNING) << "worker: lifting a stale fleet-pause gate — "
                        "its membership change died with the old "
                        "scheduler (re-request the join)";
  }
  cv_.notify_all();
}

void BytePSWorker::SyncRounds(int64_t round, int64_t bcast_round) {
  std::lock_guard<std::mutex> lk(mu_);
  // Monotone: a later join's RESUME may already have advanced the
  // counters past this rank's own activation point (two joins racing a
  // joiner's startup) — counters only ever move forward.
  sync_round_ = std::max(sync_round_, round);
  sync_bcast_round_ = std::max(sync_bcast_round_, bcast_round);
  for (auto& ctx : tensors_) {
    if (ctx->round < sync_round_) ctx->round = sync_round_;
    if (ctx->bcast_round < sync_bcast_round_) {
      ctx->bcast_round = sync_bcast_round_;
    }
  }
}

// --- hot-replacement recovery bookkeeping -------------------------

void BytePSWorker::RecTrackPush(Part* p, const PushOp& op) {
  if (!recovery_on_) return;
  std::lock_guard<std::mutex> lk(rec_mu_);
  p->rec_op = op;
  p->rec_stage = 1;
  p->rec_push_rid = -1;
}

void BytePSWorker::RecTrackPushRid(Part* p, int rid) {
  if (!recovery_on_) return;
  std::lock_guard<std::mutex> lk(rec_mu_);
  // Only while still in push stage: a fast ack may have advanced (or a
  // fast chain completed) the state before Request returned.
  if (p->rec_stage == 1) p->rec_push_rid = rid;
}

void BytePSWorker::RecTrackAck(Part* p) {
  if (!recovery_on_) return;
  std::lock_guard<std::mutex> lk(rec_mu_);
  p->rec_stage = 2;
}

void BytePSWorker::RecTrackDone(Part* p, int version, const char* base,
                                int64_t raw_len) {
  if (!recovery_on_) return;
  std::lock_guard<std::mutex> lk(rec_mu_);
  // Retain the round's UNSCALED aggregate (exactly the server's slot
  // bytes): the authoritative re-seed payload should the owning server
  // die while a peer's pull for this round is still outstanding.
  p->reseed_data.assign(base, base + raw_len);
  p->reseed_round = version;
  p->rec_stage = 0;
  p->rec_push_rid = -1;
}

void BytePSWorker::RecClear(Part* p) {
  if (!recovery_on_) return;
  std::lock_guard<std::mutex> lk(rec_mu_);
  p->rec_stage = 0;
  p->rec_push_rid = -1;
}

void BytePSWorker::OnServerRecovered(int node_id) {
  // Off the van recv thread: the re-seed BLOCKS on INIT_KEY acks, and
  // the scheduler connection's recv thread must stay free to deliver a
  // failure SHUTDOWN should the replacement die mid-recovery.
  std::lock_guard<std::mutex> lk(rec_threads_mu_);
  rec_threads_.emplace_back([this, node_id] { RecoverServer(node_id); });
}

void BytePSWorker::RecoverServer(int node_id) {
  // Snapshot this rank's shard (tensors_ only grows and Part addresses
  // are stable after declare).
  std::vector<std::pair<TensorCtx*, Part*>> mine;
  {
    std::lock_guard<std::mutex> lk(mu_);
    for (auto& ctx : tensors_) {
      for (auto& part : ctx->parts) {
        if (part.server_id == node_id) {
          mine.emplace_back(ctx.get(), &part);
        }
      }
    }
  }
  BPS_LOG(WARNING) << "worker: re-seeding replacement server " << node_id
                   << " (" << mine.size() << " partition(s))";
  // 1. Decide each partition's recovery action BEFORE anything is
  //    resent. Once the parked resend queue drains (step 2), a resent
  //    push can settle against the replacement at any moment and
  //    advance rec_stage to 2 — deciding from the live state after
  //    that would RE-PUSH a contribution the replacement has already
  //    applied under a different req_id, which the dedup window cannot
  //    link: a double-applied push, silent corruption. The snapshot is
  //    stable: the rank's requests are still paused, and only the dead
  //    predecessor could settle them.
  struct Action {
    TensorCtx* ctx;
    Part* p;
    bool repush;  // false = reseed
  };
  std::vector<Action> actions;
  for (auto& it : mine) {
    Part* p = it.second;
    std::lock_guard<std::mutex> lk(rec_mu_);
    const bool push_settled =
        p->rec_stage == 2 ||
        (p->rec_stage == 1 && p->rec_push_rid >= 0 &&
         !kv_->HasPending(p->rec_push_rid));
    if (push_settled) {
      // The dead server's partial sum held this contribution; the
      // resend queue does not (the request settled). Re-push it.
      actions.push_back({it.first, p, true});
    } else if (p->rec_stage == 0 && p->reseed_round >= 0) {
      // Idle key with a completed round retained: offer the aggregate
      // so a peer's parked pull for that round can be served.
      actions.push_back({it.first, p, false});
    }
    // rec_stage 1 with the push still pending: the resend queue owns
    // re-delivery; nothing extra to do.
  }
  // 2. Lift the pause and drain the parked resend queue: the blocking
  //    INIT_KEY wait below relies on the retry clock to re-deliver
  //    declares the chaos layer (or a flaky link) eats, and a paused
  //    rank's clock is frozen. Draining before the declares is safe —
  //    the replacement PARKS data ops for not-yet-redeclared keys and
  //    keepalives their senders (re-seed state, server.cc).
  kv_->ResendNode(node_id);
  // 3. Re-declare the shard — the replacement's store is empty, and a
  //    payload for an undeclared key is a protocol violation once its
  //    re-seed grace ends. Blocking, but only on our own INIT_KEYs.
  std::vector<int> reqs;
  for (auto& it : mine) {
    TensorCtx* ctx = it.first;
    Part* p = it.second;
    MsgHeader h{};
    h.cmd = CMD_INIT_KEY;
    h.key = p->key;
    h.dtype = ctx->dtype;
    h.arg0 = p->len * DtypeSize(ctx->dtype);
    reqs.push_back(kv_->Request(
        node_id, h, ctx->comp_config.data(),
        static_cast<int64_t>(ctx->comp_config.size()), nullptr));
  }
  kv_->WaitRequests(reqs);
  // 4. Issue the snapshotted re-pushes and reseeds. Payload lifetimes
  //    hold: a re-pushed op's handle has not settled (its pull cannot
  //    complete before our contribution lands), so the caller buffer /
  //    comp_buf are alive; reseed_data is worker-owned and only
  //    overwritten after the key's NEXT round completes, which this
  //    recovery gates. Ordinary retried requests from here — the timer
  //    re-drives any the wire eats, the dedup window absorbs replays.
  int repushed = 0, reseeded = 0;
  for (const Action& a : actions) {
    std::lock_guard<std::mutex> lk(rec_mu_);
    MsgHeader h{};
    h.key = a.p->key;
    h.dtype = a.ctx->dtype;
    if (a.repush) {
      h.cmd = CMD_PUSH;
      h.version = a.p->rec_op.version;
      h.flags = a.p->rec_op.flags;
      h.arg0 = a.p->rec_op.raw_len;
      kv_->Request(node_id, h, a.p->rec_op.payload,
                   a.p->rec_op.payload_len, nullptr);
      Trace::Get().Note("REPUSH", a.p->key, node_id, -1, h.version);
      ++repushed;
    } else {
      h.cmd = CMD_RESEED;
      h.version = a.p->reseed_round;
      kv_->Request(node_id, h, a.p->reseed_data.data(),
                   static_cast<int64_t>(a.p->reseed_data.size()),
                   nullptr);
      Trace::Get().Note("RESEED_OFFER", a.p->key, node_id, -1,
                        a.p->reseed_round);
      Events::Get().Emit(EV_RESEED, a.p->key, node_id, a.p->reseed_round);
      ++reseeded;
    }
  }
  BPS_METRIC_COUNTER_ADD("bps_recoveries_total", 1);
  BPS_METRIC_GAUGE_SET("bps_recovering", 0);
  BPS_LOG(WARNING) << "worker: server " << node_id << " re-seeded ("
                   << repushed << " re-pushed, " << reseeded
                   << " re-seeded round(s)) — resuming";
  // The recovery's closing flight dump: the EPOCH_PAUSE dump predates
  // the re-seed, so refresh the file with the RESUME + reseed trail.
  Trace::Get().Note("RECOVER_DONE", repushed + reseeded, node_id);
  Events::Get().Emit(EV_SERVER_RECOVER, node_id, repushed + reseeded,
                     /*done=*/1);
  Trace::Get().FlightDumpAuto("recovery_complete");
}

void BytePSWorker::PushLoop() {
  Task t;
  while (queue_->Pop(&t)) {
    if (fusion_bytes_ <= 0 || !t.fusible) {
      t.run();
      continue;
    }
    // Fusion collector: this (priority-ordered) pop opens a collect
    // session. Fusible tasks keep popping — in priority order, for ANY
    // server (the byte-balanced assignment interleaves servers at the
    // queue head) — and accumulate into one batch per destination
    // (server, stripe). Batches are keyed by the striped connection fd,
    // NOT the server alone: a fused frame is routed by its lead key
    // (SendFusedPush sets h.key = table[0].key), so every key sharing a
    // frame must hash to the same BYTEPS_VAN_STREAMS connection.
    // Batching per server would let one key's pushes ride a different
    // stripe from round to round (fused under a varying lead key, or
    // singleton under its own stripe), breaking the one-connection-per-
    // key ordering invariant striping relies on — a later round could
    // overtake an earlier one on another stripe and wedge the server's
    // slot. A batch flushes the moment it reaches the byte threshold
    // (BYTEPS_FUSION_BYTES) or key cap (BYTEPS_FUSION_KEYS); the
    // session ends — flushing every partial batch — when a non-fusible
    // task reaches the queue head or the queue stays empty past the
    // linger deadline (the enqueuing thread pumps tasks in slower than
    // this thread drains them; without a short wait every batch
    // degenerates to a singleton).
    std::map<std::pair<int, int>,
             std::pair<std::vector<PushOp>, int64_t>> acc;
    const int64_t deadline_us = NowUs() + fusion_linger_us_;
    auto stage = [this, &acc](Task& task) {
      const std::pair<int, int> dst{
          task.server_id, po_->FdOf(task.server_id, task.key)};
      auto& a = acc[dst];
      // One operation per key per frame: a deep-pipelining caller
      // (single push thread — see the thread-count comment in Start)
      // can enqueue rounds r and r+2 of one tensor back-to-back, and
      // the server PARKS an r+2 sub-push until round r's pulls recycle
      // its slot. Two rounds of one key in one frame would also break
      // the worker-side ack/pull-resp table matching (one slot per
      // key); flush the batch and let the next frame carry the later
      // round, exactly like the unfused wire.
      for (const PushOp& prev : a.first) {
        if (prev.p->key == task.key) {
          FlushBatch(task.server_id, std::move(a.first));
          a = {};
          break;
        }
      }
      fusion_sink_ = &a.first;
      task.run();  // stages its PushOp via fusion_sink_
      fusion_sink_ = nullptr;
      a.second += task.bytes;
      if (a.second >= fusion_bytes_ ||
          static_cast<int>(a.first.size()) >= fusion_keys_) {
        FlushBatch(task.server_id, std::move(a.first));
        acc.erase(dst);
      }
    };
    stage(t);
    Task more;
    while (queue_->TryPopFusible(
        std::max<int64_t>(0, deadline_us - NowUs()), &more)) {
      stage(more);
    }
    for (auto& kv : acc) {
      FlushBatch(kv.first.first, std::move(kv.second.first));
    }
  }
}

void BytePSWorker::FlushBatch(int server_id, std::vector<PushOp> ops) {
  if (ops.empty()) return;
  if (ops.size() == 1) {
    // A batch of one gains nothing from the multi framing; keep the
    // single-frame wire format (and its lower parse cost).
    SendPush(std::move(ops[0]));
    return;
  }
  SendFusedPush(server_id, std::move(ops));
}

void BytePSWorker::Record(int64_t key, const char* stage, int64_t start_us,
                          int peer, int32_t req_id, int32_t round,
                          int64_t wire_bytes, int64_t raw_bytes) {
  if (!trace_on_) return;
  Trace::Get().Span(stage, key, start_us, NowUs(), peer, req_id, round,
                    wire_bytes, raw_bytes);
}

int64_t BytePSWorker::Declare(const std::string& name, int64_t nelem,
                              int dtype, const std::string& comp_config) {
  std::unique_lock<std::mutex> lk(mu_);
  auto it = by_name_.find(name);
  if (it != by_name_.end()) {
    auto& t = *tensors_[it->second];
    BPS_CHECK_EQ(t.nelem, nelem) << "tensor " << name << " re-declared";
    BPS_CHECK_EQ(t.dtype, dtype) << "tensor " << name << " re-declared";
    return t.id;
  }
  auto ctx = std::make_unique<TensorCtx>();
  ctx->id = static_cast<int64_t>(tensors_.size());
  ctx->name = name;
  ctx->nelem = nelem;
  ctx->dtype = dtype;
  ctx->priority = -static_cast<int>(ctx->id);  // declaration-order priority
  // Elastic join: a joiner's tensors start at the fleet's
  // activation round, not 0 — its first push lands exactly in the
  // first round the new roster expects it in. 0 on ordinary workers.
  ctx->round = sync_round_;
  ctx->bcast_round = sync_bcast_round_;

  const std::string& comp =
      comp_config == "__default__" ? default_comp_ : comp_config;
  if (!comp.empty()) {
    BPS_CHECK_EQ(dtype, BPS_FLOAT32)
        << "lossy compressors operate on float32 gradients";
  }
  // Retained for the hot-replacement re-declare (RecoverServer): the
  // replacement server must rebuild each key's codec exactly.
  ctx->comp_config = comp;

  int esz = DtypeSize(dtype);
  int64_t per_part = std::max<int64_t>(1, partition_bytes_ / esz);
  int64_t nparts = (nelem + per_part - 1) / per_part;
  int ns = po_->num_servers();
  // Byte-balanced server assignment: each partition goes to the server
  // with the least bytes assigned so far (ties -> lowest index, so the
  // choice is deterministic). Every worker declares the same tensors in
  // the same order, so all workers compute the same mapping without any
  // coordination. Round-robin by (tid + i) was measured 22% hot at 8
  // servers on the ResNet-50 leaf distribution (tools/bench_scaling.py)
  // — and the hottest server's links gate the whole sync round.
  if (server_bytes_.size() != static_cast<size_t>(ns)) {
    server_bytes_.assign(ns, 0);
  }
  for (int64_t i = 0; i < nparts; ++i) {
    Part p;
    p.key = (ctx->id << 16) | i;
    int best = 0;
    for (int s = 1; s < ns; ++s) {
      if (server_bytes_[s] < server_bytes_[best]) best = s;
    }
    p.server_id = Postoffice::ServerId(best);
    p.offset = i * per_part;
    p.len = std::min(per_part, nelem - p.offset);
    server_bytes_[best] += p.len * esz;
    if (!comp.empty()) {
      p.comp = CreateCompressor(comp, p.len);
    }
    ctx->parts.push_back(std::move(p));
  }

  // Register every partition with its owning server (blocking, but only
  // on our own INIT_KEY requests — not on unrelated in-flight traffic).
  std::vector<int> reqs;
  for (auto& p : ctx->parts) {
    MsgHeader h{};
    h.cmd = CMD_INIT_KEY;
    h.key = p.key;
    h.dtype = dtype;
    h.arg0 = p.len * esz;
    reqs.push_back(kv_->Request(p.server_id, h, comp.data(),
                                static_cast<int64_t>(comp.size()), nullptr));
  }
  int64_t id = ctx->id;
  by_name_[name] = id;
  tensors_.push_back(std::move(ctx));
  lk.unlock();
  for (int rid : reqs) {
    BPS_CHECK_GE(rid, 0) << "declare of '" << name
                         << "' failed: a server connection is dead";
  }
  kv_->WaitRequests(reqs);
  return id;
}

int BytePSWorker::PushPull(int64_t tensor_id, void* ptr, int64_t nelem,
                           int dtype, bool average, bool async_mode) {
  std::unique_lock<std::mutex> lk(mu_);
  // Elastic membership gate: while a JOIN commits, new
  // rounds wait here so the acked counters stay final. Rounds already
  // issued are unaffected (they complete against the old roster). The
  // periodic wake lets a fleet fail-stop (no RESUME will ever come)
  // fall through instead of wedging at the gate.
  while (fleet_paused_ && !po_->ShuttingDown()) {
    cv_.wait_for(lk, std::chrono::milliseconds(100));
  }
  BPS_CHECK_GE(tensor_id, 0);
  BPS_CHECK(tensor_id < static_cast<int64_t>(tensors_.size()))
      << "undeclared tensor id " << tensor_id;
  TensorCtx* ctx = tensors_[tensor_id].get();
  BPS_CHECK_EQ(ctx->nelem, nelem) << "shape changed for " << ctx->name;
  BPS_CHECK_EQ(ctx->dtype, dtype) << "dtype changed for " << ctx->name;
  // Full round number on the wire (server: slot = version & 1). Parity
  // alone cannot tell round r from r+2, which matters once users keep
  // 3+ push_pull handles of one tensor in flight (deep pipelining).
  int version = static_cast<int>(ctx->round++);
  int handle_id = next_handle_++;
  auto handle = std::make_shared<Handle>(static_cast<int>(ctx->parts.size()));
  handles_[handle_id] = handle;
  lk.unlock();

  int esz = DtypeSize(dtype);
  double scale = average ? 1.0 / po_->num_workers() : 1.0;
  for (auto& part : ctx->parts) {
    Part* p = &part;
    Task task;
    task.priority = ctx->priority;
    task.key = p->key;
    task.bytes = p->len * esz;  // raw bytes charged against the credit
    task.server_id = p->server_id;
    // Fusible iff under the fusion threshold: a conv net's hundreds of
    // sub-partition-size tensors coalesce; full partitions keep their
    // own frames.
    task.fusible = fusion_bytes_ > 0 && task.bytes < fusion_bytes_;
    const int64_t t_enq = NowUs();
    task.run = [this, ctx, p, ptr, esz, version, scale, average,
                async_mode, handle, t_enq] {
      // Scheduled-queue wait (credit admission + priority) — the first
      // stage of the per-round breakdown.
      RoundStats::Get().Track(RS_QUEUE, version, NowUs() - t_enq);
      char* base = static_cast<char*>(ptr) + p->offset * esz;
      int64_t raw_len = p->len * esz;
      PushOp op;
      op.p = p;
      op.ctx = ctx;
      op.base = base;
      op.raw_len = raw_len;
      op.payload = base;
      op.payload_len = raw_len;
      op.flags = async_mode ? FLAG_ASYNC : 0;
      op.version = version;
      op.scale = scale;
      op.average = average;
      op.handle = handle;
      int64_t t0 = NowUs();
      if (p->comp) {
        p->comp->Compress(reinterpret_cast<const float*>(base), p->len,
                          &p->comp_buf);
        op.payload = p->comp_buf.data();
        op.payload_len = static_cast<int64_t>(p->comp_buf.size());
        op.flags |= FLAG_COMPRESSED;
        Record(p->key, "compress", t0);
        RoundStats::Get().Track(RS_COMP, version, NowUs() - t0);
        BPS_METRIC_HISTO_OBSERVE("bps_compress_us", NowUs() - t0);
        BPS_METRIC_COUNTER_ADD("bps_compress_in_bytes_total", raw_len);
        BPS_METRIC_COUNTER_ADD("bps_compress_out_bytes_total",
                               op.payload_len);
      } else if (QuantEligible(ctx, raw_len)) {
        // Block-quantized wire: fold the gradient into the
        // per-key EF residual, encode the residual as per-block int8,
        // and carry the rounding error into the next round. The encoded
        // qbuf is the wire payload — fused frames gather it, resend
        // snapshots copy it, and a recovery RE-PUSH ships the identical
        // bytes, which is what keeps the residual stream (and therefore
        // every later round) bit-identical across fault and fault-free
        // runs.
        if (p->qresidual.empty()) p->qresidual.assign(p->len, 0.0f);
        const float* g = reinterpret_cast<const float*>(base);
        for (int64_t i = 0; i < p->len; ++i) p->qresidual[i] += g[i];
        BPS_CHECK(BlockQuant::EncodeEF(p->qresidual.data(), p->len,
                                       quant_block_, &p->qbuf))
            << "non-finite gradient for key " << p->key
            << " — refusing to quantize garbage onto the wire";
        op.payload = p->qbuf.data();
        op.payload_len = static_cast<int64_t>(p->qbuf.size());
        op.flags |= FLAG_WIRE_QUANT;
        // Distinct span (satellite): quant encode time was
        // invisible under the shared "compress" label — the critical-
        // path report now attributes it as its own stage.
        Record(p->key, "qencode", t0);
        RoundStats::Get().Track(RS_COMP, version, NowUs() - t0);
        BPS_METRIC_COUNTER_ADD("bps_quant_bytes_on_wire_total",
                               op.payload_len);
        BPS_METRIC_COUNTER_ADD("bps_quant_bytes_saved_total",
                               raw_len - op.payload_len);
      }
      if (fusion_sink_ != nullptr) {
        // PushLoop is assembling a fused frame: stage, don't send.
        fusion_sink_->push_back(std::move(op));
        return;
      }
      SendPush(std::move(op));
    };
    BPS_METRIC_COUNTER_ADD("bps_partitions_enqueued_total", 1);
    BPS_METRIC_COUNTER_ADD("bps_enqueued_bytes_total", task.bytes);
    // Enqueue instant: the gap to this key's push span is scheduled-
    // queue wait (credit/priority), the first stage of the merge tool's
    // critical-path breakdown.
    if (trace_on_) {
      Trace::Get().Instant("enqueue", p->key, p->server_id, -1, 0,
                           version);
    }
    RoundStats::Get().Track(RS_ENQ, version);
    queue_->Push(std::move(task));
  }
  return handle_id;
}

void BytePSWorker::SendPush(PushOp op) {
  Part* p = op.p;
  TensorCtx* ctx = op.ctx;
  char* base = op.base;
  int64_t raw_len = op.raw_len;
  int flags = op.flags;
  int version = op.version;
  double scale = op.scale;
  bool average = op.average;
  std::shared_ptr<Handle> handle = op.handle;
  MsgHeader h{};
  h.cmd = CMD_PUSH;
  h.key = p->key;
  h.dtype = ctx->dtype;
  h.version = version;
  h.flags = flags;
  h.arg0 = raw_len;
  int64_t t_push = NowUs();
  // Wire-byte parity contract with the server's bps_recv_bytes_total
  // (docs/monitoring.md): both sides count CMD_PUSH payload bytes —
  // compressed size when a codec is on — so worker-side push totals
  // and server-side recv totals sum to the same number fleet-wide.
  BPS_METRIC_COUNTER_ADD("bps_push_bytes_total", op.payload_len);
  BPS_METRIC_COUNTER_ADD("bps_push_partitions_total", 1);
  RoundStats::Get().Track(RS_FRAME, version);
  const int64_t plen = op.payload_len;
  RecTrackPush(p, op);
  int push_rid = kv_->Request(
      p->server_id, h, op.payload, op.payload_len,
      [this, ctx, p, base, raw_len, version, scale, average, flags,
       handle, t_push, plen](Message&& ack) {
        if (ack.head.cmd == CMD_ERROR) {
          // Dead server: fail the handle now with the diagnostic
          // instead of blocking Wait until the heartbeat detector.
          RecClear(p);
          RoundStats::Get().Track(RS_DONE, version);
          FailHandle(handle, p->key, std::move(ack));
          queue_->ReleaseCredit(raw_len);
          return;
        }
        if (QueueDebug())
          fprintf(stderr, "[QDEBUG] push_ack key=%lld\n",
                  (long long)p->key);
        if (trace_on_) {
          // Close the push flow at the ack, inside the push span (the
          // span's end is recorded just after, so ts stays inside it):
          // the merged view stitches push span -> server sum -> ack.
          Trace::Get().Flow(TRACE_FLOW_IN, "req", p->key, NowUs(),
                            TraceFlowId(po_->my_id(), ack.head.req_id));
        }
        Record(p->key, "push", t_push, p->server_id, ack.head.req_id,
               version, plen, raw_len);
        BPS_METRIC_HISTO_OBSERVE("bps_push_us", NowUs() - t_push);
        // Per-round breakdown: push wall, and the server's own
        // decode+sum time reported back on the ack (arg0 — a field
        // CMD_PUSH_ACK never used; old servers leave it 0, which
        // degrades gracefully to "all wire"). wire_ack = push - sum.
        RoundStats::Get().Track(RS_PUSH, version, NowUs() - t_push,
                                plen);
        RoundStats::Get().Track(RS_SUM, version, ack.head.arg0);
        RecTrackAck(p);
        // Async: the ack carries the server's fleet-wide apply count
        // for this key as of OUR push; the pull resp carries it as
        // of the pull. Their difference is this pull's staleness.
        int64_t at_push = ack.head.arg1;
        // Push acknowledged -> issue the pull for the aggregate.
        MsgHeader ph{};
        ph.cmd = CMD_PULL;
        ph.key = p->key;
        ph.dtype = ctx->dtype;
        ph.version = version;
        // FLAG_WIRE_QUANT on a pull REQUESTS the server's re-quantized
        // aggregate (the reply leg of the quantized wire); the response
        // declares its own encoding, so a raw reply (reseeded slot,
        // async param) is still handled below.
        ph.flags = flags & (FLAG_ASYNC | FLAG_WIRE_QUANT);
        int64_t t_pull = NowUs();
        RoundStats::Get().Track(RS_FRAME, version);
        int pull_rid = kv_->Request(
            p->server_id, ph, nullptr, 0,
            [this, ctx, p, base, raw_len, version, scale, average,
             handle, t_pull, flags, at_push](Message&& resp) {
              if (resp.head.cmd == CMD_ERROR) {
                RecClear(p);
                RoundStats::Get().Track(RS_DONE, version);
                FailHandle(handle, p->key, std::move(resp));
                queue_->ReleaseCredit(raw_len);
                return;
              }
              if (QueueDebug())
                fprintf(stderr, "[QDEBUG] pull_resp key=%lld\n",
                        (long long)p->key);
              if (trace_on_) {
                Trace::Get().Flow(
                    TRACE_FLOW_IN, "reply", p->key, NowUs(),
                    TraceFlowId(po_->my_id(), resp.head.req_id));
              }
              Record(p->key, "pull", t_pull, p->server_id,
                     resp.head.req_id, version);
              BPS_METRIC_HISTO_OBSERVE("bps_pull_us", NowUs() - t_pull);
              RoundStats::Get().Track(
                  RS_PULL, version, NowUs() - t_pull,
                  static_cast<int64_t>(resp.payload.size()));
              BPS_METRIC_COUNTER_ADD(
                  "bps_pull_bytes_total",
                  static_cast<int64_t>(resp.payload.size()));
              if (flags & FLAG_ASYNC) {
                int64_t stale = resp.head.arg1 - at_push;
                if (stale >= 0) {  // peers' pushes applied between
                  stale_sum_.fetch_add(stale,
                                       std::memory_order_relaxed);
                  stale_n_.fetch_add(1, std::memory_order_relaxed);
                  int64_t cur =
                      stale_max_.load(std::memory_order_relaxed);
                  while (stale > cur &&
                         !stale_max_.compare_exchange_weak(
                             cur, stale, std::memory_order_relaxed)) {
                  }
                }
              }
              if (resp.head.flags & FLAG_COMPRESSED) {
                // Pull-leg compression: the server re-encoded the
                // aggregate with this key's codec (SURVEY.md §2.2
                // server symmetry); decode straight into the
                // caller's buffer.
                BPS_CHECK(p->comp)
                    << "compressed pull but no codec, key " << p->key;
                BPS_CHECK_EQ(resp.head.arg0, raw_len)
                    << "pull length mismatch for key " << p->key;
                int64_t t_dec = NowUs();
                p->comp->Decompress(
                    resp.payload.data(),
                    static_cast<int64_t>(resp.payload.size()),
                    reinterpret_cast<float*>(base), p->len);
                BPS_METRIC_HISTO_OBSERVE("bps_decompress_us",
                                         NowUs() - t_dec);
                RoundStats::Get().Track(RS_DEC, version,
                                        NowUs() - t_dec);
              } else if (resp.head.flags & FLAG_WIRE_QUANT) {
                // Quantized reply: dequantize the aggregate straight
                // into the caller's buffer.
                BPS_CHECK_EQ(resp.head.arg0, raw_len)
                    << "quant pull length mismatch for key " << p->key;
                int64_t t_dec = NowUs();
                BPS_CHECK(BlockQuant::Decode(
                    resp.payload.data(),
                    static_cast<int64_t>(resp.payload.size()),
                    reinterpret_cast<float*>(base), p->len))
                    << "malformed quantized pull reply for key "
                    << p->key;
                // qdecode span (satellite): the reply-leg
                // dequant was invisible in critical paths before.
                Record(p->key, "qdecode", t_dec, p->server_id,
                       resp.head.req_id, version,
                       static_cast<int64_t>(resp.payload.size()),
                       raw_len);
                RoundStats::Get().Track(RS_DEC, version,
                                        NowUs() - t_dec);
                BPS_METRIC_COUNTER_ADD(
                    "bps_quant_bytes_on_wire_total",
                    static_cast<int64_t>(resp.payload.size()));
                BPS_METRIC_COUNTER_ADD(
                    "bps_quant_bytes_saved_total",
                    raw_len - static_cast<int64_t>(resp.payload.size()));
              } else {
                BPS_CHECK_EQ(
                    static_cast<int64_t>(resp.payload.size()), raw_len)
                    << "pull length mismatch for key " << p->key;
                memcpy(base, resp.payload.data(), raw_len);
              }
              // Before Scale: the retained re-seed payload must be the
              // server's slot bytes (the unscaled sum).
              RecTrackDone(p, version, base, raw_len);
              RoundStats::Get().Track(RS_DONE, version);
              // Mean divisor: the ROUND's contributor count reported by
              // the server (arg1) — an elastic membership change
              // between issue and completion makes the captured fleet
              // size stale. Same-N fleets produce the identical double
              // (1/arg1 == the captured 1/num_workers); old servers
              // send 0 and keep the captured scale.
              double eff = scale;
              if (average && !(flags & FLAG_ASYNC) &&
                  resp.head.arg1 > 0) {
                eff = 1.0 / static_cast<double>(resp.head.arg1);
              }
              if (eff != 1.0) {
                CpuReducer::Scale(base, eff, raw_len, ctx->dtype);
              }
              queue_->ReleaseCredit(raw_len);
              if (handle->remaining.fetch_sub(1) == 1) {
                std::lock_guard<std::mutex> lk2(mu_);
                cv_.notify_all();
              }
            });
        if (trace_on_ && pull_rid >= 0) {
          // Open the pull's flow at its issue time (inside the pull
          // span); the server's s_reply span carries the "t" step.
          Trace::Get().Flow(TRACE_FLOW_OUT, "reply", p->key, t_pull,
                            TraceFlowId(po_->my_id(), pull_rid));
        }
      });
  RecTrackPushRid(p, push_rid);
  if (trace_on_ && push_rid >= 0) {
    // Open the push's flow at its issue time, inside the push span.
    Trace::Get().Flow(TRACE_FLOW_OUT, "req", p->key, t_push,
                      TraceFlowId(po_->my_id(), push_rid));
  }
}

// Validate a CMD_MULTI_* reply frame and return its sub-header table;
// *gathered points at the payload region behind the table.
static const SubHeader* ParseMultiReply(const Message& m, int expect_cmd,
                                        int expect_n,
                                        const char** gathered) {
  BPS_CHECK_EQ(m.head.cmd, expect_cmd)
      << "unexpected reply cmd for fused frame";
  BPS_CHECK_EQ(static_cast<int>(m.head.arg0), expect_n)
      << "fused reply count mismatch";
  int64_t table_bytes =
      static_cast<int64_t>(expect_n) * static_cast<int64_t>(sizeof(SubHeader));
  BPS_CHECK_GE(static_cast<int64_t>(m.payload.size()), table_bytes)
      << "fused reply shorter than its table";
  *gathered = m.payload.data() + table_bytes;
  return reinterpret_cast<const SubHeader*>(m.payload.data());
}

void BytePSWorker::SendFusedPush(int server_id, std::vector<PushOp> ops) {
  const int n = static_cast<int>(ops.size());
  auto batch = std::make_shared<std::vector<PushOp>>(std::move(ops));
  // shared_ptr table: the retry layer may resend this frame after
  // SendFusedPush returned, so the sub-header table must live until the
  // request settles (passed to RequestV as the lifetime hold). The
  // sub-payload segments already do — they point into caller buffers /
  // comp_bufs pinned until the handles complete.
  auto table_hold = std::make_shared<std::vector<SubHeader>>(
      static_cast<size_t>(n));
  std::vector<SubHeader>& table = *table_hold;
  std::vector<iovec> segs;
  segs.reserve(static_cast<size_t>(n) + 1);
  segs.push_back({table.data(),
                  static_cast<size_t>(n) * sizeof(SubHeader)});
  int64_t off = 0, wire_bytes = 0;
  for (int i = 0; i < n; ++i) {
    PushOp& op = (*batch)[i];
    SubHeader& s = table[i];
    s.key = op.p->key;
    s.cmd = CMD_PUSH;
    s.tenant = TenantId();  // one frame = one tenant
    // Wire-dtype of the sub-payload: BPS_INT8 marks the block-quantized
    // encoding (FLAG_WIRE_QUANT rides in flags too — the engine-side
    // dequant keys on the flag, the table field is the wire contract
    // HandleMulti validates). Default 0 = raw float32/`dtype` bytes, so
    // a quant-off frame is byte-for-byte the pre-quant wire.
    s.wire_dtype = (op.flags & FLAG_WIRE_QUANT)
                       ? static_cast<int16_t>(BPS_INT8)
                       : static_cast<int16_t>(0);
    s.version = op.version;
    s.dtype = static_cast<int16_t>(op.ctx->dtype);
    s.flags = op.flags;
    s.arg0 = op.raw_len;
    s.offset = off;
    s.len = op.payload_len;
    off += op.payload_len;
    wire_bytes += op.payload_len;
    if (op.payload_len > 0) {
      segs.push_back({const_cast<void*>(op.payload),
                      static_cast<size_t>(op.payload_len)});
    }
  }
  MsgHeader h{};
  h.cmd = CMD_MULTI_PUSH;
  h.key = table[0].key;  // stripes/routes the batch like its lead key
  h.arg0 = n;
  // Parity contract unchanged under fusion: both sides count the SUB
  // payload bytes (the table is framing, like headers).
  BPS_METRIC_COUNTER_ADD("bps_push_bytes_total", wire_bytes);
  BPS_METRIC_COUNTER_ADD("bps_push_partitions_total", n);
  BPS_METRIC_COUNTER_ADD("bps_fused_msgs_total", 1);
  BPS_METRIC_HISTO_OBSERVE("bps_fusion_batch_keys", n);
  // One wire frame for the whole batch, charged to the lead sub-op's
  // round (frames may legally mix rounds across the duplicate-key
  // flush; the lead round is where the frame-count signal belongs).
  RoundStats::Get().Track(RS_FRAME, table[0].version, 0, /*fused=*/1);
  int64_t t_push = NowUs();
  if (recovery_on_) {
    std::lock_guard<std::mutex> lk(rec_mu_);
    for (PushOp& op : *batch) {
      op.p->rec_op = op;
      op.p->rec_stage = 1;
      op.p->rec_push_rid = -1;
    }
  }
  // The iovec list lives only until RequestV returns (it snapshots the
  // segments when retry is on); the table is pinned via the hold, the
  // payload segments via caller buffers / comp_bufs until the handles
  // settle.
  int push_rid = kv_->RequestV(
      server_id, h, segs.data(), static_cast<int>(segs.size()),
      [this, server_id, batch, t_push](Message&& ack) {
        OnFusedAck(server_id, batch, t_push, std::move(ack));
      },
      table_hold);
  if (trace_on_ && push_rid >= 0) {
    // One flow per fused frame, opened on the lead key's track; every
    // sub-key's s_sum span on the server steps the same flow (they all
    // share the frame's req_id).
    Trace::Get().Flow(TRACE_FLOW_OUT, "req", h.key, t_push,
                      TraceFlowId(po_->my_id(), push_rid));
  }
  if (recovery_on_) {
    // One req id covers the whole frame; each sub-op records it so the
    // recovery hook can tell "frame still in the resend queue" from
    // "frame settled, contributions live only in the dead server".
    std::lock_guard<std::mutex> lk(rec_mu_);
    for (PushOp& op : *batch) {
      if (op.p->rec_stage == 1) op.p->rec_push_rid = push_rid;
    }
  }
}

void BytePSWorker::OnFusedAck(
    int server_id, const std::shared_ptr<std::vector<PushOp>>& batch,
    int64_t t_push, Message&& ack) {
  if (ack.head.cmd == CMD_ERROR) {
    FailBatch(batch, std::move(ack));
    return;
  }
  const int n = static_cast<int>(batch->size());
  if (recovery_on_) {
    std::lock_guard<std::mutex> lk(rec_mu_);
    for (PushOp& op : *batch) op.p->rec_stage = 2;
  }
  const char* gathered = nullptr;
  const SubHeader* subs = ParseMultiReply(ack, CMD_MULTI_ACK, n, &gathered);
  if (trace_on_) {
    Trace::Get().Flow(TRACE_FLOW_IN, "req", (*batch)[0].p->key, NowUs(),
                      TraceFlowId(po_->my_id(), ack.head.req_id));
  }
  auto at_push = std::make_shared<std::vector<int64_t>>(
      static_cast<size_t>(n), 0);
  // shared_ptr table: pinned past this callback for the retry layer's
  // resends (same contract as SendFusedPush).
  auto table_hold = std::make_shared<std::vector<SubHeader>>(
      static_cast<size_t>(n));
  std::vector<SubHeader>& table = *table_hold;
  for (int i = 0; i < n; ++i) {
    PushOp& op = (*batch)[i];
    BPS_CHECK_EQ(subs[i].key, op.p->key) << "fused ack table out of order";
    if (QueueDebug())
      fprintf(stderr, "[QDEBUG] push_ack key=%lld\n",
              (long long)op.p->key);
    Record(op.p->key, "push", t_push, server_id, ack.head.req_id,
           op.version, op.payload_len, op.raw_len);
    BPS_METRIC_HISTO_OBSERVE("bps_push_us", NowUs() - t_push);
    // Per-round breakdown per sub-op: the batched ack carries each
    // sub-push's server decode+sum time in its sub-header arg0 (the
    // same contract as the single-frame ack).
    RoundStats::Get().Track(RS_PUSH, op.version, NowUs() - t_push,
                            op.payload_len);
    RoundStats::Get().Track(RS_SUM, op.version, subs[i].arg0);
    (*at_push)[i] = subs[i].arg1;  // async apply count as of our push
    SubHeader& s = table[i];
    s.key = op.p->key;
    s.cmd = CMD_PULL;
    s.tenant = TenantId();
    s.version = op.version;
    s.dtype = static_cast<int16_t>(op.ctx->dtype);
    // FLAG_WIRE_QUANT requests the re-quantized aggregate for keys this
    // worker pushed quantized (see the single-frame pull's comment);
    // wire_dtype mirrors it (the REQUESTED reply encoding — a pull has
    // no payload of its own).
    s.flags = op.flags & (FLAG_ASYNC | FLAG_WIRE_QUANT);
    s.wire_dtype = (s.flags & FLAG_WIRE_QUANT)
                       ? static_cast<int16_t>(BPS_INT8)
                       : static_cast<int16_t>(0);
  }
  // Whole batch acknowledged -> one fused pull for the aggregates.
  MsgHeader h{};
  h.cmd = CMD_MULTI_PULL;
  h.key = table[0].key;
  h.arg0 = n;
  iovec seg{table.data(), static_cast<size_t>(n) * sizeof(SubHeader)};
  int64_t t_pull = NowUs();
  RoundStats::Get().Track(RS_FRAME, table[0].version, 0, /*fused=*/1);
  int pull_rid = kv_->RequestV(
      server_id, h, &seg, 1,
      [this, batch, at_push, t_pull](Message&& resp) {
        OnFusedPullResp(batch, at_push, t_pull, std::move(resp));
      },
      table_hold);
  if (trace_on_ && pull_rid >= 0) {
    Trace::Get().Flow(TRACE_FLOW_OUT, "reply", h.key, t_pull,
                      TraceFlowId(po_->my_id(), pull_rid));
  }
}

void BytePSWorker::OnFusedPullResp(
    const std::shared_ptr<std::vector<PushOp>>& batch,
    const std::shared_ptr<std::vector<int64_t>>& at_push, int64_t t_pull,
    Message&& resp) {
  if (resp.head.cmd == CMD_ERROR) {
    FailBatch(batch, std::move(resp));
    return;
  }
  const int n = static_cast<int>(batch->size());
  const char* gathered = nullptr;
  const SubHeader* subs =
      ParseMultiReply(resp, CMD_MULTI_PULL_RESP, n, &gathered);
  if (trace_on_) {
    Trace::Get().Flow(TRACE_FLOW_IN, "reply", (*batch)[0].p->key,
                      NowUs(),
                      TraceFlowId(po_->my_id(), resp.head.req_id));
  }
  int64_t gathered_len = static_cast<int64_t>(resp.payload.size()) -
                         static_cast<int64_t>(n) *
                             static_cast<int64_t>(sizeof(SubHeader));
  for (int i = 0; i < n; ++i) {
    PushOp& op = (*batch)[i];
    const SubHeader& s = subs[i];
    BPS_CHECK_EQ(s.key, op.p->key) << "fused pull table out of order";
    BPS_CHECK(s.offset >= 0 && s.len >= 0 &&
              s.offset + s.len <= gathered_len)
        << "fused pull sub-payload out of range, key " << s.key;
    if (QueueDebug())
      fprintf(stderr, "[QDEBUG] pull_resp key=%lld\n",
              (long long)op.p->key);
    Record(op.p->key, "pull", t_pull, op.p->server_id,
           resp.head.req_id, op.version);
    BPS_METRIC_HISTO_OBSERVE("bps_pull_us", NowUs() - t_pull);
    RoundStats::Get().Track(RS_PULL, op.version, NowUs() - t_pull,
                            s.len);
    BPS_METRIC_COUNTER_ADD("bps_pull_bytes_total", s.len);
    if (op.flags & FLAG_ASYNC) {
      int64_t stale = s.arg1 - (*at_push)[i];
      if (stale >= 0) {  // peers' pushes applied between
        stale_sum_.fetch_add(stale, std::memory_order_relaxed);
        stale_n_.fetch_add(1, std::memory_order_relaxed);
        int64_t cur = stale_max_.load(std::memory_order_relaxed);
        while (stale > cur &&
               !stale_max_.compare_exchange_weak(
                   cur, stale, std::memory_order_relaxed)) {
        }
      }
    }
    const char* data = gathered + s.offset;
    if (s.flags & FLAG_COMPRESSED) {
      // Pull-leg compression, per sub-entry (server symmetry as in the
      // single-frame path).
      BPS_CHECK(op.p->comp)
          << "compressed pull but no codec, key " << op.p->key;
      BPS_CHECK_EQ(s.arg0, op.raw_len)
          << "pull length mismatch for key " << op.p->key;
      int64_t t_dec = NowUs();
      op.p->comp->Decompress(data, s.len,
                             reinterpret_cast<float*>(op.base), op.p->len);
      BPS_METRIC_HISTO_OBSERVE("bps_decompress_us", NowUs() - t_dec);
      RoundStats::Get().Track(RS_DEC, op.version, NowUs() - t_dec);
    } else if (s.flags & FLAG_WIRE_QUANT) {
      BPS_CHECK_EQ(s.arg0, op.raw_len)
          << "quant pull length mismatch for key " << op.p->key;
      int64_t t_dec = NowUs();
      BPS_CHECK(BlockQuant::Decode(data, s.len,
                                   reinterpret_cast<float*>(op.base),
                                   op.p->len))
          << "malformed quantized pull reply for key " << op.p->key;
      Record(op.p->key, "qdecode", t_dec, op.p->server_id,
             resp.head.req_id, op.version, s.len, op.raw_len);
      RoundStats::Get().Track(RS_DEC, op.version, NowUs() - t_dec);
      BPS_METRIC_COUNTER_ADD("bps_quant_bytes_on_wire_total", s.len);
      BPS_METRIC_COUNTER_ADD("bps_quant_bytes_saved_total",
                             op.raw_len - s.len);
    } else {
      BPS_CHECK_EQ(s.len, op.raw_len)
          << "pull length mismatch for key " << op.p->key;
      memcpy(op.base, data, static_cast<size_t>(op.raw_len));
    }
    RecTrackDone(op.p, op.version, op.base, op.raw_len);
    RoundStats::Get().Track(RS_DONE, op.version);
    // Same round-roster mean divisor as the single-frame path: the
    // batched reply carries each sub-entry's contributor count in its
    // sub-header arg1.
    double eff = op.scale;
    if (op.average && !(op.flags & FLAG_ASYNC) && s.arg1 > 0) {
      eff = 1.0 / static_cast<double>(s.arg1);
    }
    if (eff != 1.0) {
      CpuReducer::Scale(op.base, eff, op.raw_len, op.ctx->dtype);
    }
    queue_->ReleaseCredit(op.raw_len);
    if (op.handle->remaining.fetch_sub(1) == 1) {
      std::lock_guard<std::mutex> lk2(mu_);
      cv_.notify_all();
    }
  }
}

void BytePSWorker::FailBatch(
    const std::shared_ptr<std::vector<PushOp>>& batch, Message&& err) {
  for (PushOp& op : *batch) {
    Message e;
    e.head = err.head;
    e.payload.assign(err.payload.begin(), err.payload.end());
    RecClear(op.p);
    RoundStats::Get().Track(RS_DONE, op.version);
    FailHandle(op.handle, op.p->key, std::move(e));
    queue_->ReleaseCredit(op.raw_len);
  }
}

int BytePSWorker::Broadcast(int64_t tensor_id, void* ptr, int64_t nelem,
                            int dtype, int root_rank) {
  std::unique_lock<std::mutex> lk(mu_);
  // Same elastic membership gate as PushPull.
  while (fleet_paused_ && !po_->ShuttingDown()) {
    cv_.wait_for(lk, std::chrono::milliseconds(100));
  }
  BPS_CHECK(tensor_id >= 0 &&
            tensor_id < static_cast<int64_t>(tensors_.size()));
  TensorCtx* ctx = tensors_[tensor_id].get();
  BPS_CHECK_EQ(ctx->nelem, nelem);
  // All workers advance the round in lockstep (same call sequence), so a
  // non-root's pull for round r waits for the root's r-th push even when
  // the same tensor is re-broadcast later (weight re-sync).
  int bcast_version = static_cast<int>(ctx->bcast_round++);
  int handle_id = next_handle_++;
  auto handle = std::make_shared<Handle>(static_cast<int>(ctx->parts.size()));
  handles_[handle_id] = handle;
  lk.unlock();

  bool is_root = po_->my_worker_rank() == root_rank;
  int esz = DtypeSize(dtype);
  for (auto& part : ctx->parts) {
    Part* p = &part;
    char* base = static_cast<char*>(ptr) + p->offset * esz;
    int64_t raw_len = p->len * esz;
    MsgHeader h{};
    h.cmd = is_root ? CMD_BCAST_PUSH : CMD_BCAST_PULL;
    h.key = p->key;
    h.dtype = dtype;
    h.version = bcast_version;
    auto done = [this, p, base, raw_len, is_root, handle](Message&& resp) {
      if (resp.head.cmd == CMD_ERROR) {
        FailHandle(handle, p->key, std::move(resp));
        return;
      }
      if (!is_root) {
        BPS_CHECK_EQ(static_cast<int64_t>(resp.payload.size()), raw_len);
        memcpy(base, resp.payload.data(), raw_len);
      }
      if (handle->remaining.fetch_sub(1) == 1) {
        std::lock_guard<std::mutex> lk2(mu_);
        cv_.notify_all();
      }
    };
    if (is_root) {
      kv_->Request(p->server_id, h, base, raw_len, done);
    } else {
      kv_->Request(p->server_id, h, nullptr, 0, done);
    }
  }
  return handle_id;
}

void BytePSWorker::FailHandle(const std::shared_ptr<Handle>& handle,
                              int64_t key, Message&& err) {
  std::string why(err.payload.data(),
                  err.payload.data() + err.payload.size());
  {
    std::lock_guard<std::mutex> lk(mu_);
    if (!handle->failed.load()) {
      handle->error = "key " + std::to_string(key) + ": " + why;
      handle->failed.store(true);
    }
  }
  // Same order as the completion paths: decrement FIRST, then notify —
  // notifying before the decrement is a lost wakeup (the waiter's
  // predicate still sees the old count and sleeps forever).
  if (handle->remaining.fetch_sub(1) == 1) {
    std::lock_guard<std::mutex> lk(mu_);
    cv_.notify_all();
  }
  BPS_LOG(WARNING) << "request failed for key " << key << ": " << why;
}

int BytePSWorker::Wait(int handle_id) {
  std::shared_ptr<Handle> h;
  {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = handles_.find(handle_id);
    if (it == handles_.end()) return 0;  // already reaped
    h = it->second;
  }
  std::unique_lock<std::mutex> lk(mu_);
  // Even when the handle has FAILED, wait for every partition to settle
  // (complete or fail): returning early would let still-in-flight
  // callbacks memcpy into — and queued push tasks read from — the
  // caller's buffer after the caller saw the error and freed it. Every
  // partition settles promptly: live-server partitions complete, dead-
  // server partitions get CMD_ERROR from the peer-lost scan or their
  // send failure (each path decrements `remaining`).
  cv_.wait(lk, [&] { return h->remaining.load() == 0; });
  handles_.erase(handle_id);
  if (h->failed.load()) {
    last_error_ = h->error;
    return -1;
  }
  return 0;
}

std::string BytePSWorker::LastError() {
  std::lock_guard<std::mutex> lk(mu_);
  return last_error_;
}

int BytePSWorker::Poll(int handle_id) {
  std::lock_guard<std::mutex> lk(mu_);
  auto it = handles_.find(handle_id);
  if (it == handles_.end()) return 1;
  // Failed or not, a handle is complete only when every partition has
  // settled — reporting completion earlier would tell a poll-driven
  // caller the buffer is theirs while in-flight callbacks still write
  // into it (same invariant as Wait).
  if (it->second->remaining.load() != 0) return 0;
  if (it->second->failed.load()) {
    // Tri-state: -1 = settled but FAILED. NOT reaped — the follow-up
    // Wait must still find the handle to surface the error string; the
    // FFI poll wrapper maps -1 to that Wait so poll-only consumers
    // neither leak the entry nor mistake a dead-peer failure for
    // success.
    return -1;
  }
  // Reap on completion so poll-only consumers don't leak handle entries.
  handles_.erase(it);
  return 1;
}

}  // namespace bps
