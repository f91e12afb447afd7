// The CPU-summation parameter server.
//
// Capability parity: reference byteps/server/server.{h,cc} (SURVEY.md
// §2.3): a KV request handler plus an engine thread pool
// (BYTEPS_SERVER_ENGINE_THREAD, default 4) so summation never blocks the
// network threads; per-key aggregation buffers; sync mode releases pulls
// once all num_worker pushes for a key arrived; async mode
// (BYTEPS_ENABLE_ASYNC) keeps server-resident parameters, applies pushes
// immediately and replies immediately. Summation via CpuReducer.
//
// Fresh design notes: keys are routed to engine threads by hash, which
// serialises all work for one key on one thread — per-key ordering without
// per-key locks. Sync-mode rounds are double-buffered by version parity
// (head.version), tolerating the legal one-round skew between workers.
//
// Small-tensor fusion (CMD_MULTI_PUSH / CMD_MULTI_PULL): a fused frame is
// unpacked on the van thread into one EngineTask per sub-operation, each
// routed to its key's engine thread exactly like a single frame — per-key
// total ordering and the KeyStore single-writer invariant hold unchanged.
// The sub-tasks share a MultiReply accumulator; each sub-op's reply (ack
// or pull response) lands in its slot, and the LAST one to settle sends a
// single batched CMD_MULTI_ACK / CMD_MULTI_PULL_RESP frame back. A
// sub-push that would PARK records its ack at park time instead of
// withholding the batch (ack-on-park, see Process): the batched ack gates
// the worker's fused pull for every key in the frame, and those pulls are
// what recycle the slot a parked push waits on — gating acks on slot
// recycling would let two workers' frames deadlock through each other
// (ack -> slot-recycle -> pull -> ack).
#pragma once

#include <atomic>
#include <condition_variable>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

#include "ckpt.h"
#include "common.h"
#include "compressor.h"
#include "elastic.h"
#include "postoffice.h"
#include "snapshot.h"
#include "tenancy.h"

namespace bps {

class BytePSServer {
 public:
  // replica_of >= 0 starts the engine in READ-REPLICA mode:
  // no training data plane — the process serves CMD_SNAP_PULL from a
  // snapshot store fed by per-round deltas polled off primary server
  // rank `replica_of` (StartReplicaPoll, called once the postoffice
  // joined the fleet and holds the address book).
  void Start(Postoffice* po, int engine_threads, bool async_mode,
             int replica_of = -1);
  // Replica only: spawn the delta-poll thread. Separate from Start
  // because Start runs BEFORE the postoffice forms (engine threads must
  // exist first) and the poll needs the primary's book entry.
  void StartReplicaPoll();
  void Handle(Message&& msg, int fd);  // van-thread entry; enqueues to engine
  void Stop();
  ~BytePSServer() { Stop(); }

  // Elastic worker membership (van thread, from the
  // postoffice's fleet-resize callback). A JOIN pushes a new roster
  // epoch activating at `join_round`/`join_bcast` — rounds already in
  // flight keep completing against the old contributor set. A removal
  // (graceful leave kind 1, death shrink kind 2) erases the id from
  // every roster and, for a death, enqueues a rollback task per engine
  // thread: the dead rank's partial contributions are discarded, the
  // survivors' retained bytes re-summed, and every slot's readiness /
  // recycle re-evaluated against the shrunk roster.
  // `tenant` scopes the change: rounds are per-tenant
  // counters, so the roster epoch lands in that tenant's history only
  // and the re-eval/rollback tasks visit only that tenant's keys.
  void OnFleetResize(int kind, int affected, int64_t join_round,
                     int64_t join_bcast, int tenant);

  // Durable restore: newest checksum-valid checkpoint
  // version found on disk at Start, -1 when armed but nothing valid,
  // -2 when BYTEPS_CKPT_RESTORE is not armed. The c_api glue forwards
  // this to the postoffice BEFORE registration so the report rides the
  // CMD_REGISTER frame.
  int64_t durable_ckpt_version() const { return durable_version_; }
  bool restore_armed() const { return restore_armed_; }

 private:
  // Accumulator for one fused frame's batched reply. subs/data are
  // indexed by the request table position, so the reply table preserves
  // the worker's sub-operation order; each slot is written by exactly one
  // engine thread (the key's owner) and `remaining`'s final decrement
  // publishes them to the flusher.
  struct MultiReply {
    int fd = -1;
    int32_t req_id = -1;
    int32_t reply_cmd = 0;  // CMD_MULTI_ACK or CMD_MULTI_PULL_RESP
    uint16_t tenant = 0;    // the frame's tenant (one frame, one tenant)
    int64_t first_key = 0;
    std::atomic<int> remaining{0};
    std::vector<SubHeader> subs;
    std::vector<std::vector<char>> data;  // owned reply payload copies
  };

  struct KeyStore;
  struct EngineQueue;

  // One unit of engine work: a single frame, or one sub-operation of a
  // fused frame (batch != nullptr; sub_idx = its reply slot).
  struct EngineTask {
    Message msg;
    int fd = -1;
    std::shared_ptr<MultiReply> batch;
    int sub_idx = -1;
    // Set when a fused sub-push records its ack at park time
    // (ack-on-park, see Process CMD_PUSH): the parked replay must not
    // reply a second time.
    bool replied = false;
    // Set by ReplayParked: a parked task re-entering Process is the
    // ORIGINAL request being completed, not a wire duplicate — it must
    // bypass the dedup window its own first arrival recorded.
    bool from_park = false;
  };

  struct KeyStore {
    // Owning tenant: set at INIT_KEY from the declaring
    // frame. The store map keys on TenantKey(tenant, key), so two
    // tenants' colliding tids can never alias; this field is the
    // back-reference for completion counts, rosters, and accounting.
    uint16_t tenant = 0;
    // Bare wire key, set at INIT_KEY: the snapshot publication hook
    // (RoundReady) needs the full (tenant, key) identity and only has
    // the KeyStore in hand.
    int64_t key = -1;
    // Idempotent-retry dedup window: per sender, the last
    // data-plane request seen for this key. Per key per sender at most
    // ONE request chain is outstanding (the worker's per-key ordering
    // invariant), so a single record per sender is a complete window:
    // a request whose req_id matches the record is a wire duplicate
    // (chaos dup, or a retry resend) — it is acked/served again from
    // recorded state but NEVER re-applied, which is what keeps chaos
    // runs bit-identical to fault-free runs. An unreplied match (the
    // original is parked) answers CMD_KEEPALIVE so the worker's retry
    // budget never expires on a legitimately slow round. Header-only
    // state: pull replays re-serve from the slot/param buffers (see
    // last_round below), so the window costs no payload copies.
    // Touched only by this key's engine thread (hash routing).
    struct SenderRec {
      int32_t req_id = -1;
      bool replied = false;
      MsgHeader reply_head{};
    };
    std::unordered_map<int, SenderRec> seen;
    // Round a recycled slot LAST served, and its data retained: a
    // replayed sync pull whose PULL_RESP was lost can be re-served
    // from slot[s]/comp_reply[s] until the slot is reassigned — which
    // per-key chaining guarantees cannot happen before every worker
    // completed that round's pull (round r+2's first push needs all
    // r+1 pushes, which need all r pulls delivered). The one corner
    // that CAN outrun this window — deep pipelining parking r+2's
    // push before our round-r reply was delivered — is detected and
    // fail-stopped with a wire CMD_ERROR instead of serving stale
    // bytes (see Process CMD_PULL).
    int last_round[2] = {-1, -1};
    // Latest broadcast round pushed (bcast replay fallback: param
    // still holds exactly that round's bytes).
    int last_bcast_round = -1;

    int64_t len = 0;  // decompressed payload bytes
    int32_t dtype = BPS_FLOAT32;
    std::string comp_config;
    std::unique_ptr<Compressor> compressor;  // for decompressing pushes
    std::vector<float> scratch;              // decompression target
    // Pull-leg compression (reference §2.2 server symmetry: decompress
    // pushes, sum, RE-COMPRESS pull responses so the DCN pays compressed
    // freight in both directions). Separate instance: momentum is a
    // push-direction decorator and must not be re-applied to aggregates;
    // error feedback is kept — the server accumulates its own re-encode
    // residual into the next round (DoubleSqueeze-style two-way EF).
    std::unique_ptr<Compressor> reply_comp;
    std::vector<char> comp_reply[2];  // cached encode, one per live round
    // Stale-reply guard (satellite): the ROUND each cached
    // re-encode was produced for, stamped at encode time and asserted
    // at every serve site (ReplyPull / ServeRetainedPull /
    // AnswerDuplicate via CachedReplyValid). Before the tag, the
    // cached bytes were guarded only by round checks on the SLOT — a
    // dedup-replayed pull racing a slot re-encode could ship a newer
    // round's bytes under an older round's header. -1 = no valid cache.
    int comp_reply_round[2] = {-1, -1};
    // Quantized wire: true when this key's pushes may arrive
    // block-quantized and its pull replies are re-quantized — quant
    // armed fleet-wide, codec-less, float32, at least the minimum raw
    // size (the worker computes the same predicate, so the two sides
    // agree without negotiation). qreply mirrors comp_reply: the
    // aggregate is encoded ONCE per round at round-ready and every
    // flagged pull (and replay) serves the same cached bytes.
    // Deliberately NO server-side EF residual on this leg: a hot
    // replacement starts residual-less, so any server-resident carry
    // would make post-recovery replies diverge from the fault-free
    // run — breaking the recovery bit-identity contract. The reply
    // rounding error is ~|aggregate|/254 per element, round-to-nearest
    // (near-unbiased); the convergence A/B (BENCH_compression_r06)
    // shows the worker-side push EF alone tracks dense (docs/rationale).
    bool quant_ok = false;
    std::vector<char> qreply[2];  // cached quantized encode per slot
    int qreply_round[2] = {-1, -1};  // round tag (see comp_reply_round)
    // sync mode: double-buffered rounds. round[s] is the full round
    // number (head.version) the slot currently accumulates/serves;
    // pushes/pulls for a LATER round that maps to a busy slot are parked
    // and replayed when the slot recycles — deep pipelining (3+ rounds
    // of one tensor in flight) backpressures instead of crashing.
    std::vector<char> slot[2];
    int push_count[2] = {0, 0};
    int pull_count[2] = {0, 0};
    bool ready[2] = {false, false};
    int round[2] = {-1, -1};
    // Elastic membership (maintained only when BYTEPS_ELASTIC):
    // per-slot contributor roster + retained decoded contributions (the
    // death-shrink rollback's rebuild source — freed at round ready).
    ElasticSlot er[2];
    // Contributor count of the round a slot serves / last served: the
    // worker-side mean divisor, carried on every sync PULL_RESP's arg1
    // so a pull issued before a membership change still divides by the
    // round's ACTUAL roster size. Mirrors round[]/last_round[].
    int contrib_n[2] = {0, 0};
    int last_contrib_n[2] = {0, 0};
    std::vector<EngineTask> pending_pulls[2];
    std::vector<EngineTask> parked_pushes[2];
    // async mode: server-resident value
    std::vector<char> param;
    bool param_init = false;
    // Total async pushes applied to this key (any worker). Returned on
    // async acks/pull responses (arg1) so workers can compute pull
    // staleness; single-writer per key via the hash-routed engine.
    int64_t async_pushes = 0;
    // Broadcast: per-round buffers keyed by the root's round counter
    // (head.version). A round-r BCAST_PULL is served exactly round r's
    // bytes — never a previous or FUTURE round's, even when the root
    // races ahead — and a round's buffer is freed once all num_workers-1
    // non-root pulls for it were served.
    struct BcastRound {
      std::vector<char> data;
      int served = 0;
      // Expected non-root pulls, FROZEN at push time from the round's
      // roster: a bcast pushed before a join must not wait for the
      // joiner, and one pushed after expects it.
      int waiters = 0;
    };
    std::unordered_map<int, BcastRound> bcast_rounds;
    std::vector<std::pair<int, MsgHeader>> pending_bcast_pulls;
  };

  void EngineLoop(int tid);
  void Process(EngineTask&& task);
  // Dedup-window hit: answer a wire duplicate from recorded state
  // (re-ack / re-serve / keepalive) without touching key state.
  void AnswerDuplicate(KeyStore* ks, KeyStore::SenderRec& rec,
                       EngineTask& task);
  // Server -> worker control frames outside the reply tables.
  void SendKeepalive(const EngineTask& t);
  void SendWireError(int fd, const MsgHeader& req, const std::string& why);
  // Close the dedup-window entry for (sender, req_id) with the reply
  // header just sent, so a later wire duplicate replays it.
  void MarkReplied(KeyStore* ks, int32_t sender, int32_t req_id,
                   const MsgHeader& reply_head);
  // Fused-frame entry (van thread): unpack, account, fan sub-operations
  // out to their keys' engine threads under a shared MultiReply.
  void HandleMulti(Message&& msg, int fd);
  // Reply path shared by single and fused tasks: direct van send when the
  // task is a lone frame, reply-slot capture (and batch flush when it was
  // the last outstanding sub-op) when it belongs to a fused frame.
  void SendReply(const EngineTask& t, MsgHeader& head,
                 const void* data = nullptr, int64_t len = 0);
  void FlushMulti(const std::shared_ptr<MultiReply>& batch);
  // Store lookup is (tenant, key)-namespaced; tenant 0
  // composes to the bare key, so a legacy fleet's store map — and its
  // `key % threads` engine routing — is bit-for-bit the pre-tenant one.
  KeyStore* GetStore(uint16_t tenant, int64_t key);
  // Route an engine task to its key's thread through the per-tenant
  // DRR lanes (the one enqueue point: depth/cost accounting lives
  // here). `lane` overrides the DRR lane the task is queued under
  // (default: the frame's tenant) — the serving path enqueues reader
  // traffic under kServingLane without touching the header's tenant,
  // which the snapshot lookup and the reply stamping still need.
  void EnqueueTask(EngineTask&& task, int lane = -1);
  // Zero-cost control marker into a specific queue's tenant lane
  // (roster re-eval / rollback tasks).
  void EnqueueTaskTo(EngineQueue& eq, EngineTask&& task);
  // Returns true when this pull completed the round and recycled the
  // slot (caller must then ReplayParked).
  bool ReplyPull(KeyStore* ks, int slot, const EngineTask& t);
  // Serve a pull for an already-COMPLETED round from the retained slot
  // data (the replay window / a re-seeded aggregate) without advancing
  // pull_count — the round's accounting is final; this is re-delivery.
  void ServeRetainedPull(KeyStore* ks, int slot, const EngineTask& t);
  // Recovery incarnation only: a data-plane op for a key that has not
  // been re-declared yet parks here (keepalive keeps the worker's retry
  // budget fresh) and replays when its INIT_KEY arrives. Returns true
  // when the task was parked.
  bool ParkUndeclared(EngineTask&& task);
  // End of the re-seed grace window: exit recover mode (restoring the
  // unknown-key fatal) and fail any ops still parked without their
  // re-declare — they would otherwise hang forever, their keepalives
  // keeping the sender's retry budget fresh. Idempotent; safe to race
  // from multiple engine threads.
  void EndReseedGrace();
  void ReplayParked(KeyStore* ks, int slot);
  void ReplyBcastPull(KeyStore* ks, int fd, const MsgHeader& req);
  void ServeBcastRound(KeyStore* ks, int round, int fd,
                       const MsgHeader& req);

  // Encode one round's aggregate into qreply[slot] (quant-eligible keys
  // only; called at round-ready, exactly like the comp_reply encode).
  void EncodeQuantReply(KeyStore* ks, int slot);

  // --- snapshot serving ---
  // CMD_SNAP_PULL: one reader's request for one key's snapshot —
  // resolve against the store, echo the served version, reply on the
  // arrival fd (readers are raw TCP clients, never registered nodes).
  void ProcessSnapPull(EngineTask& task);
  // CMD_SNAP_SUB (primary): a replica's delta poll — gather every
  // committed entry past its watermark (bounded per frame) into one
  // CMD_SNAP_DELTA (SubHeader table + payloads, the CMD_MULTI layout).
  void ProcessSnapSub(EngineTask& task);
  // CMD_SNAP_DELTA (replica): install the batch (idempotent) and adopt
  // the primary's committed watermark.
  void ProcessSnapDelta(EngineTask& task);
  // Replica delta-poll loop: dial the primary, send CMD_SNAP_SUB with
  // our highest held version every poll interval (a lost SUB or DELTA
  // is repaired by the next poll — retry semantics without a retry
  // layer), re-dial on failure from the live address book (so a
  // hot-replaced primary is picked up).
  void ReplicaPollLoop();

  // --- durable checkpoints ---
  // Install a finished aggregate for round `ver` into the KeyStore's
  // parity slot: the shared re-seed/restore machinery (slot bytes,
  // last_round / last_contrib_n, cached-encode invalidation, partial
  // supersede, parked-pull release). Factored from CMD_RESEED so the
  // checkpoint restore path installs through the identical invariants.
  // `why` names the installer in the skip diagnostics. Engine thread
  // (the key's owner) only.
  void InstallAggregate(KeyStore* ks, int64_t ver, const char* data,
                        size_t len, const char* why);
  // Restore hook (CMD_INIT_KEY): on the first declared key, load the
  // fleet-committed restore epoch's checkpoint from disk (fail-stop on
  // any mismatch — never a silent cold start); then install this key's
  // restored aggregate and publish it into the snapshot store at the
  // restore round.
  void MaybeInstallRestored(KeyStore* ks);
  // Spill trigger (RoundReady, after snapshot Publish): when the
  // committed snapshot version advanced to a spill boundary, collect
  // the cut (shared_ptr, no copy) and hand it to the async writer.
  void MaybeSpillCkpt();

  // The round is complete (every expected contributor summed): seal the
  // contribution roster, encode the cached replies, release this
  // round's pending pulls, and replay parked pushes when a pull
  // recycled the slot. Shared by the push path and the shrink rollback.
  void RoundReady(KeyStore* ks, int slot);
  // Expected contributor count for round `version` of a sync key: the
  // key's TENANT roster size when elastic, the tenant's live worker
  // count otherwise (tenant 0 falls back to the fleet size until the
  // address book arrives — the pre-tenant behavior).
  int ExpectedContributors(const KeyStore* ks, int64_t version);
  // The tenant's worker count from the address book, with the legacy
  // tenant-0 fallback above.
  int TenantWorkerCount(uint16_t tenant);
  // True when round `version`'s contributor set is complete. The
  // elastic check is EXACT set equality against the round's roster —
  // see ElasticSlot::PushersMatch for why superset would be unsound
  // during a shrink.
  bool RoundComplete(KeyStore* ks, int slot, int64_t version);
  // True when every roster member pulled round `version` (recycle).
  bool RoundServed(KeyStore* ks, int slot, int64_t version);
  // Death-shrink rollback for this engine thread's keys (tid-owned),
  // scoped to the departed worker's TENANT (other tenants' slots never
  // held its contributions): discard `dead`'s partial contributions,
  // rebuild sums from the survivors' retained bytes, drop its
  // parked/pending ops, and re-evaluate every slot against the shrunk
  // roster.
  void ShrinkWorker(int tid, int dead, uint16_t tenant);

  // Elastic state: armed flag + per-TENANT epoch roster histories
  // (activation-round keyed in that tenant's round space; see
  // elastic.h). Tenant 0 is pre-seeded from the formation env at
  // Start (the pre-tenancy behavior, byte for byte); other tenants
  // initialise lazily from the address book.
  bool elastic_ = false;
  RosterHistory* RosterOf(uint16_t tenant);
  std::mutex roster_mu_;  // guards the map shape, not the histories
  std::map<uint16_t, std::unique_ptr<RosterHistory>> rosters_;

  Postoffice* po_ = nullptr;
  bool async_ = false;
  // Engine service-rate cap per engine thread (
  // BYTEPS_SERVER_ENGINE_PACE_MBPS, 0 = off): after each dispatched
  // data task the engine sleeps cost/rate. Ops knob for capping a
  // shared server's CPU burn — and the calibration lever the
  // weighted-split QoS tests/bench use to create honest engine
  // contention on a loopback fleet (an unloaded engine never
  // backlogs, and fair-share is only observable under backlog).
  int64_t engine_pace_bps_ = 0;
  // Quantized wire knobs, read from the same env the worker
  // reads so both sides compute identical eligibility.
  bool wire_quant_ = false;          // BYTEPS_WIRE_QUANT
  int quant_block_ = 64;             // BYTEPS_WIRE_QUANT_BLOCK
  int64_t quant_min_bytes_ = 1024;   // BYTEPS_WIRE_QUANT_MIN_BYTES
  // Replacement incarnation (DMLC_RECOVER_RANK set): data-plane ops may
  // legally arrive before their keys are re-declared — park them
  // instead of treating an unknown key as a protocol violation. The
  // state is bounded: once the grace deadline passes, EndReseedGrace
  // clears the flag and the fatal is back — a genuinely undeclared key
  // (a real protocol bug, not a re-seed race) crashes loudly instead
  // of hanging silently. Atomic: engine threads race the lazy expiry.
  std::atomic<bool> recover_mode_{false};
  int64_t recover_grace_end_us_ = 0;  // written once in Start
  std::mutex store_mu_;  // guards store_ map shape + pre_declare_parked_
  std::unordered_map<int64_t, std::unique_ptr<KeyStore>> store_;
  std::unordered_map<int64_t, std::vector<EngineTask>> pre_declare_parked_;

  // Per-tenant FIFO lanes dispatched by weighted deficit round robin
  // (tenancy.h): whenever two tenants' lanes are both
  // backlogged, the engine serves their bytes in the ratio of their
  // BYTEPS_TENANT_WEIGHT shares — a heavy tenant cannot starve a light
  // one. `drr` mirrors the lanes cost-for-cost (enqueue/pop pairs run
  // under `mu`); with a single active tenant the picker short-circuits
  // to plain FIFO, keeping single-tenant dispatch byte-for-byte the pre-tenancy order.
  struct EngineQueue {
    EngineQueue(int64_t quantum, WeightedDrr::WeightFn wf)
        : drr(quantum, std::move(wf)) {}
    std::mutex mu;
    std::condition_variable cv;
    std::map<uint16_t, std::deque<EngineTask>> lanes;
    WeightedDrr drr;
  };
  std::vector<std::unique_ptr<EngineQueue>> queues_;
  std::vector<std::thread> threads_;
  std::atomic<bool> stopped_{false};

  // --- snapshot serving ---
  // The DRR lane reader traffic rides: a reserved lane id no tenant can
  // collide with (tenants are worker-advertised and the fleet never
  // registers 0xFFFF), weighted by BYTEPS_SERVING_WEIGHT — so a reader
  // swarm shares the engine at a capped ratio and provably cannot move
  // the training digest.
  static constexpr uint16_t kServingLane = 0xFFFF;
  SnapStore snaps_;
  // BYTEPS_SNAPSHOT_RETAIN: per-key retention ring depth; 0 disables
  // snapshot publication (and with it the whole serving path) on this
  // node.
  int snapshot_retain_ = 4;
  int64_t serving_weight_ = 1;  // BYTEPS_SERVING_WEIGHT
  // Bound one CMD_SNAP_DELTA frame's raw payload; a lagging replica
  // catches up over successive polls instead of one giant frame.
  int64_t snap_delta_max_bytes_ = 16 << 20;
  // Replica mode: the primary server RANK this process mirrors
  // (BYTEPS_REPLICA_OF); -1 = a normal training-plane server.
  int replica_of_ = -1;
  std::thread replica_thread_;
  // Replica poll thread only: edge-triggers the EV_REPLICA_LAG journal
  // entry on the crossing into REPLICA-LAGGING.
  bool replica_lagging_ = false;

  // --- durable checkpoints ---
  // BYTEPS_CKPT_DIR: spill root; empty = checkpointing off entirely
  // (the server is then byte-for-byte the pre-checkpoint build: no
  // writer thread, no metrics, no restore scan).
  std::string ckpt_dir_;
  int ckpt_every_ = 1;   // BYTEPS_CKPT_EVERY: spill every Nth version
  int ckpt_retain_ = 2;  // BYTEPS_CKPT_RETAIN: on-disk dirs kept
  std::string ckpt_chaos_;  // BYTEPS_CHAOS_CKPT: "" / truncate / bitflip
  bool restore_armed_ = false;        // BYTEPS_CKPT_RESTORE
  int64_t durable_version_ = -2;      // newest valid on disk (Start)
  CkptWriter ckpt_writer_;
  // Restore install state: the checkpoint is loaded from disk ONCE (on
  // the first CMD_INIT_KEY, after the restore epoch arrived with the
  // address book) into restored_, then drained key-by-key as the
  // worker re-declares; restore_round_ is the fleet-committed epoch.
  std::once_flag restore_once_;
  std::mutex restore_mu_;
  std::map<std::pair<uint16_t, int64_t>, CkptItem> restored_;
  int64_t ckpt_restore_round_ = -1;
};

}  // namespace bps
