// Worker-side partitioned push/pull pipeline.
//
// Capability parity: reference byteps/common/operations.cc (InitTensor /
// EnqueueTensor) + the PUSH→PULL stages of core_loops.cc (SURVEY.md §2.1,
// §3.3): tensors are split into BYTEPS_PARTITION_BYTES slices at declare
// time; each push_pull enqueues every partition into the priority-credit
// scheduled queue; a push thread drains it (compress → ZPush), push-acks
// chain into ZPulls, and pull responses land back in the caller's buffer.
// Completion is tracked per-handle (reference: handle_manager.cc).
//
// The D2H/H2D and NCCL stages of the reference pipeline do not exist here:
// on TPU those are XLA's job (ICI reduce-scatter inside jit); this class
// only runs the DCN leg, on host buffers handed over via dlpack/numpy.
#pragma once

#include <atomic>
#include <condition_variable>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "common.h"
#include "compressor.h"
#include "kv.h"
#include "postoffice.h"
#include "scheduled_queue.h"
#include "trace.h"

namespace bps {

// Trace spans (compress/push/pull + flow stitching) are recorded into
// the process-wide rings in trace.h — the worker is one of
// four instrumented roles, no longer the sole owner of the timeline.

class BytePSWorker {
 public:
  // fusion_bytes: partitions with raw size under this are eligible for
  // small-tensor fusion (coalesced CMD_MULTI_PUSH frames); 0 disables —
  // the wire protocol is then byte-for-byte the unfused one.
  // fusion_keys: max sub-operations per fused frame.
  void Start(Postoffice* po, KVWorker* kv, int64_t partition_bytes,
             int64_t credit_bytes, int64_t fusion_bytes, int fusion_keys,
             std::string default_comp, bool trace_on);
  void Stop();
  // Cumulative async-pull staleness stats (see stale_* members).
  void StalenessStats(long long* sum, long long* max_out,
                      long long* count) const {
    *sum = stale_sum_.load(std::memory_order_relaxed);
    *max_out = stale_max_.load(std::memory_order_relaxed);
    *count = stale_n_.load(std::memory_order_relaxed);
  }
  ~BytePSWorker() { Stop(); }

  // Partition + register a tensor with its owning servers (blocking).
  // Returns the tensor id. Priority = negative declaration order.
  int64_t Declare(const std::string& name, int64_t nelem, int dtype,
                  const std::string& comp_config);

  // Enqueue all partitions; returns a completion handle immediately.
  // The aggregate (sum over workers; divided by num_workers when `average`)
  // is written back into `ptr` in place.
  int PushPull(int64_t tensor_id, void* ptr, int64_t nelem, int dtype,
               bool average, bool async_mode);

  // Init-time weight sync: root's buffer becomes everyone's (in place).
  int Broadcast(int64_t tensor_id, void* ptr, int64_t nelem, int dtype,
                int root_rank);

  // Returns 0 on success, -1 if the handle failed (dead peer) — the
  // diagnostic is then available via LastError().
  int Wait(int handle);
  // 1 = complete (reaped), 0 = pending, -1 = settled-but-failed (not
  // reaped; a follow-up Wait surfaces the error and reaps).
  int Poll(int handle);

  // Diagnostic for the most recent failed Wait on this worker.
  std::string LastError();

  // Scheduled-queue occupancy for the monitor snapshot: pending tasks,
  // in-flight bytes, and the credit budget they are admitted against.
  void QueueStats(int64_t* pending, int64_t* inflight,
                  int64_t* budget) const {
    if (!queue_) {
      *pending = *inflight = *budget = 0;
      return;
    }
    *pending = static_cast<int64_t>(queue_->pending());
    *inflight = queue_->inflight_bytes();
    *budget = queue_->budget_bytes();
  }

 private:
  struct Part;
  struct TensorCtx;

  struct Handle {
    std::atomic<int> remaining;
    std::atomic<bool> failed{false};
    std::string error;  // guarded by the worker mutex
    explicit Handle(int n) : remaining(n) {}
  };

  // One wire-ready push staged by a scheduled-queue task: everything the
  // send path needs after compression ran. `payload` points into the
  // caller's buffer or the partition's comp_buf — both stay alive until
  // the handle settles, so fused sends may gather them without copies.
  struct PushOp {
    Part* p = nullptr;
    TensorCtx* ctx = nullptr;
    char* base = nullptr;  // caller buffer slice (pull destination)
    int64_t raw_len = 0;
    const void* payload = nullptr;
    int64_t payload_len = 0;
    int flags = 0;
    int version = 0;
    double scale = 1.0;
    // Mean requested: the divisor is the ROUND's contributor count
    // reported on the pull response (arg1), not the fleet size captured
    // at issue time — an elastic membership change between issue and
    // completion would otherwise divide by the wrong N.
    bool average = false;
    std::shared_ptr<Handle> handle;
  };

  struct Part {
    int64_t key;
    int server_id;  // postoffice node id
    int64_t offset;  // elements
    int64_t len;     // elements
    std::unique_ptr<Compressor> comp;
    std::vector<char> comp_buf;
    // Hot-replacement recovery state (guarded by rec_mu_,
    // maintained only when recovery is armed). The sync step keeps at
    // most ONE op per key in flight, so one slot is a complete record:
    //   rec_stage 0: idle — reseed_data holds round reseed_round's
    //     unscaled aggregate (the authoritative re-seed payload);
    //   rec_stage 1: push issued (rec_push_rid = its request id; while
    //     the request is pending, the resend queue re-delivers it);
    //   rec_stage 2: push ACKED, pull in flight — the dead server's
    //     partial sum held our contribution, so recovery must RE-PUSH
    //     it (rec_op's payload pointers stay valid: the handle has not
    //     settled, so the caller buffer / comp_buf are alive and the
    //     pull has not overwritten them).
    int rec_stage = 0;
    int rec_push_rid = -1;
    PushOp rec_op;
    // Quantized wire state (BYTEPS_WIRE_QUANT). qresidual is
    // the per-key push-leg error-feedback carry: residual += grad,
    // encode(residual), residual -= decode(encoded) — so the int8
    // rounding error of round r rides into round r+1's encode and the
    // EF trajectory tracks dense. It lives HERE (worker-resident, one
    // float per element whenever quant is armed — the same memory
    // class as reseed_data) precisely so it survives a server death:
    // recovery re-pushes ship the already-encoded snapshot and the
    // residual stream stays bit-identical to the fault-free run.
    // qbuf is the encoded payload; like comp_buf it is pinned until
    // the handle settles (fused frames gather from it zero-copy).
    std::vector<float> qresidual;
    std::vector<char> qbuf;
    // Last completed round's unscaled aggregate — the re-seed payload.
    // Costs ~one gradient-sized buffer per worker whenever recovery is
    // armed (documented under BYTEPS_RECOVERY_TIMEOUT_MS in
    // docs/env.md). EVERY worker retains it, not a designated rank:
    // the server can die after serving some ranks' round-r pulls but
    // not others', and only a rank whose pull COMPLETED holds round
    // r's bytes — which ranks those are is unknowable in advance.
    std::vector<char> reseed_data;
    int reseed_round = -1;
  };

  struct TensorCtx {
    int64_t id;
    std::string name;
    int64_t nelem;
    int dtype;
    int priority;
    int64_t round = 0;
    int64_t bcast_round = 0;  // broadcast round (head.version on BCAST_*)
    std::string comp_config;  // resolved codec config (recovery re-declare)
    std::vector<Part> parts;
  };

  void PushLoop();
  // True when a partition ships the block-quantized wire encoding:
  // quant armed, float32, and at least the minimum raw size (below it
  // the per-block scale overhead isn't worth the framing). Callers
  // additionally require the key to be codec-less (p->comp == nullptr)
  // — a compressed payload is already encoded freight.
  bool QuantEligible(const TensorCtx* ctx, int64_t raw_len) const {
    return wire_quant_ && ctx->dtype == BPS_FLOAT32 &&
           raw_len >= quant_min_bytes_;
  }
  // Span into the shared main trace ring (trace.h); `round`/`peer`/`req`
  // feed the merge tool's stage attribution and flow stitching.
  // `wire_bytes`/`raw_bytes` label data-carrying spans (push/qdecode)
  // with their on-wire vs decoded sizes, so the timeline report can
  // show quantized-vs-raw freight per span (satellite).
  void Record(int64_t key, const char* stage, int64_t start_us,
              int peer = -1, int32_t req_id = -1, int32_t round = -1,
              int64_t wire_bytes = 0, int64_t raw_bytes = 0);
  // Mark a handle failed with the CMD_ERROR diagnostic and complete it.
  void FailHandle(const std::shared_ptr<Handle>& handle, int64_t key,
                  Message&& err);
  // Single-frame send: CMD_PUSH, chained CMD_PULL from the ack callback
  // (the pre-fusion hot path, unchanged semantics).
  void SendPush(PushOp op);
  // Collector flush: singletons keep the single-frame wire format,
  // anything larger goes out as one fused frame.
  void FlushBatch(int server_id, std::vector<PushOp> ops);
  // Fused send: one CMD_MULTI_PUSH frame for the whole batch, one
  // batched ack, one CMD_MULTI_PULL, one batched response.
  void SendFusedPush(int server_id, std::vector<PushOp> ops);
  void OnFusedAck(int server_id,
                  const std::shared_ptr<std::vector<PushOp>>& batch,
                  int64_t t_push, Message&& ack);
  void OnFusedPullResp(const std::shared_ptr<std::vector<PushOp>>& batch,
                       const std::shared_ptr<std::vector<int64_t>>& at_push,
                       int64_t t_pull, Message&& resp);
  // Fail every handle in the batch with the CMD_ERROR diagnostic and
  // release its credits.
  void FailBatch(const std::shared_ptr<std::vector<PushOp>>& batch,
                 Message&& err);

 public:
  // Elastic worker membership (van recv threads). Pause (join
  // kind): gate new rounds and ack the scheduler with this worker's
  // round counters — DRAIN-FREE: rounds already issued complete
  // against the old roster, so the ack only has to freeze the
  // counters. Resume: sync counters up to the join activation round
  // (so every member's next round is the first the joiner is expected
  // in) and lift the gate.
  void OnFleetPause(int kind);
  void OnFleetResume(int kind, int64_t join_round, int64_t join_bcast);
  // Joiner: counters this rank's tensors start at (from the
  // scheduler's direct ADDRBOOK); applies to future Declares too.
  void SyncRounds(int64_t round, int64_t bcast_round);

  // Scheduler fail-over. MaxIssuedRound: the
  // rounds-completed watermark a CMD_REREGISTER carries (max round any
  // tensor has issued — same arithmetic as OnFleetPause's gated-counter
  // ack). OnSchedRecovered: a scheduler recovery committed — any round
  // gate a pre-crash FLEET_PAUSE armed is stale (its commit died with
  // the old scheduler; the rebuilt one has no such op in flight), so
  // lift it rather than deadlock the next round.
  int64_t MaxIssuedRound();
  void OnSchedRecovered();

  // Hot server replacement: the postoffice's peer-recovered
  // callback lands here (van recv thread). Spawns a background thread
  // that re-declares the dead rank's key shard on the replacement,
  // re-pushes settled in-flight contributions, RESEEDs completed rounds
  // from this worker's retained aggregates, then drains the parked
  // resend queue (KVWorker::ResendNode).
  void OnServerRecovered(int node_id);

 private:
  void RecoverServer(int node_id);
  // Recovery bookkeeping around a push send (stage 1 + request id).
  void RecTrackPush(Part* p, const PushOp& op);
  void RecTrackPushRid(Part* p, int rid);
  // Push acked: the dead-server recovery must re-push from rec_op.
  void RecTrackAck(Part* p);
  // Pull landed: retain the round's unscaled aggregate for RESEED.
  void RecTrackDone(Part* p, int version, const char* base,
                    int64_t raw_len);
  void RecClear(Part* p);

  Postoffice* po_ = nullptr;
  KVWorker* kv_ = nullptr;
  int64_t partition_bytes_ = 4096000;
  int64_t fusion_bytes_ = 0;  // 0 = fusion off
  int fusion_keys_ = 128;
  int64_t fusion_linger_us_ = 200;  // BYTEPS_FUSION_LINGER_US
  // Block-quantized wire: BYTEPS_WIRE_QUANT arms int8
  // encoding (+ worker-side EF residuals) for codec-less float32
  // partitions of at least quant_min_bytes_ raw bytes; the pull leg
  // requests the server's re-quantized aggregate for the same keys.
  bool wire_quant_ = false;          // BYTEPS_WIRE_QUANT
  int quant_block_ = 64;             // BYTEPS_WIRE_QUANT_BLOCK
  int64_t quant_min_bytes_ = 1024;   // BYTEPS_WIRE_QUANT_MIN_BYTES
  std::string default_comp_;
  bool trace_on_ = false;

  // Fusion collector: while a PushLoop thread assembles a batch, its
  // tasks stage PushOps here instead of sending (thread-local — each
  // push thread batches independently).
  static thread_local std::vector<PushOp>* fusion_sink_;

  std::mutex mu_;
  std::condition_variable cv_;
  // Elastic membership gate + counter sync (guarded by mu_): while a
  // JOIN commits, new PushPull/Broadcast rounds wait at the gate;
  // sync_round_/sync_bcast_round_ are the counters new declares (and,
  // on a join's RESUME, existing tensors) start from.
  bool fleet_paused_ = false;
  int64_t sync_round_ = 0;
  int64_t sync_bcast_round_ = 0;
  std::unordered_map<std::string, int64_t> by_name_;
  std::vector<std::unique_ptr<TensorCtx>> tensors_;
  // Cumulative bytes assigned per server (guarded by mu_): drives the
  // byte-balanced partition->server mapping in Declare.
  std::vector<int64_t> server_bytes_;
  // Async staleness accounting (SURVEY §2.7 DP-async): per async pull,
  // how many fleet-wide pushes the server applied between this worker's
  // push and its pull (from the ack/resp arg1 counters). Cumulative over
  // the worker's lifetime; read via byteps_async_staleness.
  std::atomic<int64_t> stale_sum_{0};
  std::atomic<int64_t> stale_max_{0};
  std::atomic<int64_t> stale_n_{0};
  std::unordered_map<int, std::shared_ptr<Handle>> handles_;
  int next_handle_ = 0;
  std::string last_error_;  // guarded by mu_

  std::unique_ptr<ScheduledQueue> queue_;
  std::vector<std::thread> push_threads_;

  // Recovery: armed when RecoveryEnabled(); rec_mu_ guards
  // every Part's rec_*/reseed_* fields (writers are the per-key
  // executor callbacks; the reader is a RecoverServer thread).
  bool recovery_on_ = false;
  std::mutex rec_mu_;
  std::mutex rec_threads_mu_;
  std::vector<std::thread> rec_threads_;
};

}  // namespace bps
