// Online per-round performance introspection.
//
// The tracing subsystem (trace.h) can answer "which stage bound
// round 412" — but only OFFLINE: stop the fleet, gather per-rank dumps,
// merge. The live /metrics counters are cumulative totals that
// cannot attribute one round. This layer is the missing middle: a
// fixed-capacity drop-oldest ring of per-round stage summaries,
// accumulated at the SAME instrumentation sites the metrics and tracing subsystems already
// touch, cheap enough to stay on by default (BYTEPS_ROUNDSTATS_ON,
// armed = one relaxed atomic load per site; overhead gated like
// BENCH_trace_r06 — see BENCH_insight_r07.json).
//
// A "round" is the push_pull round number (MsgHeader.version): in the
// synchronous step pattern every tensor advances it in lockstep, so one
// round == one training step's DCN leg. Workers accumulate the
// worker-observed stages (queue wait, compress/qencode, push wire,
// server_sum — reported back on every CMD_PUSH_ACK's arg0 — pull wait,
// decode); servers accumulate their own view (sum spans, parked ops,
// recv bytes). A round finalizes into the ring when its operations all
// completed AND a later round has started (deep pipelining keeps up to
// ~4 rounds legally open at once; see TryFinalizeLocked).
//
// Fleet aggregation: every non-scheduler rank piggybacks its completed-
// since-last-beat summaries on CMD_HEARTBEAT (a versioned sub-payload —
// old schedulers ignore heartbeat payloads, new schedulers ignore
// unrecognized magic/version, so mixed fleets interop). The scheduler
// ingests them into per-rank EWMA baselines and a bounded fleet round
// table, which monitor/insight.py reads live through the new
// bps_round_summary probe (served at /rounds by the monitor endpoint).
//
// Concurrency: one mutex guards the open-round table + ring + fleet
// table (every emit site is per-partition or per-heartbeat — the same
// cost class as the trace ring's mutex, measured within noise). The
// singleton is intentionally leaked, like Metrics and Trace, so
// teardown paths can still record and dump.
#pragma once

#include <atomic>
#include <cstdint>
#include <map>
#include <mutex>
#include <string>
#include <vector>

namespace bps {

// Accumulation sites. One entry point (Track) serves every stage so the
// FFI test hook (bps_round_track) and any Python-side reporter can
// drive the exact production path.
enum RoundStage : int32_t {
  RS_ENQ = 0,    // a partition entered the scheduled queue (starts a round)
  RS_QUEUE = 1,  // us = scheduled-queue wait (enqueue -> pop)
  RS_COMP = 2,   // us = compress or qencode time
  RS_PUSH = 3,   // us = push issue -> server ack; bytes = wire payload
  RS_SUM = 4,    // us = server-side decode+sum (ack-reported on workers)
  RS_PULL = 5,   // us = pull issue -> response; bytes = reply payload
  RS_DEC = 6,    // us = decompress or qdecode time
  RS_RETRY = 7,  // a resend fired for this round
  RS_PARK = 8,   // an op parked (server slot busy / undeclared key)
  RS_FRAME = 9,  // one wire frame sent; bytes != 0 marks it fused
  RS_DONE = 10,  // a partition's pull landed (ends a round when balanced)
};

// One round's summary. Packed: this struct IS the heartbeat wire
// sub-payload element, so its layout is part of the versioned wire
// contract (bump kRoundSummaryVersion on any change).
#pragma pack(push, 1)
struct RoundRec {
  int32_t round = -1;
  int32_t parts = 0;         // operations completed (RS_DONE count)
  int64_t queue_us = 0;
  int64_t comp_us = 0;       // compress + qencode
  int64_t push_us = 0;       // wire + server, per sub-op
  int64_t sum_us = 0;        // server summation inside push_us
  int64_t pull_us = 0;       // includes waiting for peers' pushes
  int64_t dec_us = 0;        // decompress + qdecode
  int64_t wire_bytes = 0;    // payload bytes, both legs
  int32_t wire_msgs = 0;     // request frames sent (fused frame = 1)
  int32_t fused_frames = 0;
  int32_t retries = 0;
  int32_t parked = 0;
};

// Heartbeat sub-payload: header + `count` RoundRecs (the rounds
// completed since the last beat, oldest first, capped — see
// kMaxWireRecs). Versioned so old/new nodes interop: a reader accepts
// only its known magic+version and at least the advertised length;
// anything else is silently ignored (the heartbeat itself is already
// handled from the header alone).
struct RoundSummaryHdr {
  uint16_t magic = 0;
  uint16_t version = 0;
  int32_t node_id = -1;
  int32_t role = -1;
  int32_t count = 0;
  int64_t completed_total = 0;
  int64_t dropped = 0;
};
#pragma pack(pop)

constexpr uint16_t kRoundSummaryMagic = 0xB57A;
constexpr uint16_t kRoundSummaryVersion = 1;
constexpr int kMaxWireRecs = 64;  // per heartbeat; the rest ride the next

class RoundStats {
 public:
  // Leaked heap singleton (same rationale as Metrics/Trace): heartbeat
  // piggybacks and dump probes run during teardown paths.
  static RoundStats& Get();

  bool On() const { return armed_.load(std::memory_order_relaxed); }
  void SetNode(int role, int node_id);

  // Tenant tag for a fleet rank: the scheduler feeds its
  // address-book node->tenant mapping here so fleet round summaries —
  // and therefore insight's classifier — can name the noisy neighbor
  // by tenant. Local snapshots tag with the process's own TenantId().
  void SetNodeTenant(int node_id, int tenant);

  // The one accumulation entry point (no-op unless On()). `round` < 0
  // is ignored — broadcast traffic and pre-round ops carry no round.
  void Track(int32_t stage, int round, int64_t us = 0, int64_t bytes = 0);

  // Fill the heartbeat sub-payload with rounds completed since the
  // last call (at most kMaxWireRecs). Returns false when there is
  // nothing new to report (the heartbeat then ships headerless, as
  // before this layer existed).
  bool FillWire(std::string* out);

  // Scheduler side: ingest one heartbeat sub-payload. Returns false —
  // and changes nothing — when the payload is not a recognized
  // summary (old sender, foreign magic, short frame). Trailing bytes
  // past the advertised count are tolerated — that slack is what lets
  // the events journal append a second sub-payload behind
  // this one without breaking older receivers.
  bool Ingest(const void* data, size_t len);

  // Bytes a recognized round-summary sub-payload at `data` occupies
  // (0 when not ours) — the heartbeat payload multiplexes magic-tagged
  // chunks and the scheduler walks them with this.
  static size_t WireSize(const void* data, size_t len);

  // Most recent finalized round (false when none yet).
  bool LastCompleted(RoundRec* out);

  int64_t completed_total();
  int64_t dropped();

  // Whole-state JSON for bps_round_summary: {"on","role","node_id",
  // "completed_total","dropped","last","rounds":[...]} plus, on ranks
  // that ingested fleet summaries (the scheduler), "fleet" (per-rank
  // latest + EWMA baseline) and "fleet_rounds" (round -> node -> rec).
  std::string SnapshotJson();

 private:
  RoundStats();

  struct OpenRound {
    RoundRec rec;
    int32_t enqueued = 0;  // RS_ENQ count (0 on roles with no enqueue)
    int32_t done = 0;      // RS_DONE count
  };

  struct RankState {
    int32_t role = -1;
    RoundRec last{};
    int64_t completed_total = 0;
    int64_t updates = 0;
    // EWMA of the rank's round wall time (sum of worker-observed
    // stages) — the regression baseline insight.py compares against.
    double ewma_wall_us = 0.0;
  };

  void TryFinalizeLocked();
  void FinalizeLocked(int round);
  void PublishGaugesLocked(const RoundRec& r);

  std::atomic<bool> armed_{false};
  std::atomic<int> role_{-1};
  std::atomic<int> node_id_{-1};

  std::mutex mu_;
  std::map<int, OpenRound> open_;   // ordered: finalize oldest-first
  int max_round_ = -1;
  size_t ring_cap_;
  size_t ring_head_ = 0;
  int64_t ring_total_ = 0;          // rounds ever finalized
  int64_t forced_ = 0;              // rounds force-finalized (table cap)
  std::vector<RoundRec> ring_;
  int64_t wire_sent_total_ = 0;     // rounds already shipped via FillWire

  // Fleet aggregation (scheduler; populated by Ingest).
  bool heartbeat_summary_on_ = true;
  std::map<int, RankState> fleet_;
  std::map<int, std::map<int, RoundRec>> fleet_rounds_;
  // node id -> tenant (scheduler, fed from the address book). The
  // heartbeat wire stays byte-identical — tenant identity is control-
  // plane state the scheduler already holds.
  std::map<int, int> node_tenant_;

 public:
  bool HeartbeatSummaryOn() const { return heartbeat_summary_on_; }
};

// EWMA smoothing for the per-rank baselines (shared with insight.py's
// documentation; see docs/monitoring.md "Round insight").
constexpr double kRoundEwmaAlpha = 0.2;

// Sum of the worker-observed stage times — the round's "wall" cost on
// one rank (pull_us overlaps push_us across partitions, so this is an
// attribution weight, not literal wall-clock; shares of it are what
// insight.py classifies on).
inline int64_t RoundWallUs(const RoundRec& r) {
  return r.queue_us + r.comp_us + r.push_us + r.pull_us + r.dec_us;
}

}  // namespace bps
