// Structured fleet event journal.
//
// The stack already records WHAT the fleet is doing numerically (the
// metric registry), WHERE time goes (trace rings) and HOW
// each round broke down (roundstats) — but the lifecycle
// transitions themselves (epoch pause/resume, membership changes,
// scheduler fail-over, checkpoint spills, snapshot commits, CRC
// quarantines, chaos injections) only exist as log lines and trace-ring
// notes scattered across ranks. This layer is the missing journal: a
// bounded drop-oldest ring of TYPED, versioned FleetEvent records,
// emitted at the exact sites where those transitions already happen,
// cheap enough to stay on by default (BYTEPS_EVENTS_ON, armed = one
// relaxed atomic load per site; overhead gated like BENCH_insight_r07 —
// see BENCH_events_r20.json).
//
// Fleet aggregation mirrors the roundstats sensor path: every
// non-scheduler rank piggybacks its new-since-last-beat events on
// CMD_HEARTBEAT as a SECOND versioned sub-payload after the 0xB57A
// round-summary one. Each sub-payload is self-describing (magic +
// version + count), so the scheduler walks the heartbeat payload chunk
// by chunk and old receivers — whose RoundStats::Ingest tolerates
// trailing bytes — simply never see the new chunk. With events off the
// heartbeat payload is byte-for-byte the pre-journal wire.
//
// The scheduler ingests events into a fleet-ordered TIMELINE: each
// event's local CLOCK_MONOTONIC timestamp is shifted by the sender's
// heartbeat-derived clock offset (min-RTT estimate, carried in the
// sub-payload header) onto the scheduler's timebase. Alongside, the
// scheduler samples every registered gauge into bounded per-metric
// HISTORY rings (one sample per second), so an incident report can show
// the metric curves around any event window. Both are served by the
// bps_events_summary FFI probe, the /events monitor endpoint, and
// `python -m byteps_tpu.monitor.incident`.
//
// Concurrency: one mutex guards ring + timeline + history (emit sites
// are per-transition, far off any hot path; the armed check is a
// relaxed atomic load). The singleton is intentionally leaked, like
// Metrics/Trace/RoundStats, so teardown paths can still journal.
#pragma once

#include <atomic>
#include <cstdint>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <vector>

namespace bps {

// Event types. Values are part of the versioned wire contract (bump
// kEventWireVersion on any renumbering); names via EventTypeName.
// Argument meanings are catalogued in docs/monitoring.md.
enum EventType : int32_t {
  EV_NONE = 0,
  EV_EPOCH_PAUSE = 1,        // a0=epoch a1=node being replaced
  EV_EPOCH_RESUME = 2,       // a0=epoch a1=replacement node
  EV_FLEET_PAUSE = 3,        // a0=epoch a1=kind (0 join,1 leave,2 shrink)
  EV_FLEET_RESUME = 4,       // a0=epoch a1=kind — the membership commit
  EV_JOIN = 5,               // a0=node a1=role
  EV_LEAVE = 6,              // a0=node a1=1 when a death-shrink
  EV_DEATH = 7,              // a0=node a1=role (heartbeat-timeout death)
  EV_SERVER_RECOVER = 8,     // a0=node a1=epoch (replacement registered
                             //   on the scheduler; re-seed done on workers)
  EV_RESEED = 9,             // a0=key a1=node a2=round (worker offer /
                             //   server adoption)
  EV_SCHED_PARK = 10,        // a0=deadline_ms (node parked on lost sched)
  EV_SCHED_REREGISTER = 11,  // a0=node (re-registration accepted)
  EV_SCHED_RECOVERY_COMMIT = 12,  // a0=epoch a1=nodes re-registered
  EV_CKPT_SPILL = 13,        // a0=version a1=items (spill started)
  EV_CKPT_SEAL = 14,         // a0=version a1=spill_ms (manifest sealed;
                             //   a2=1 marks a FAILED spill)
  EV_CKPT_RESTORE = 15,      // a0=restore round (fleet restore epoch)
  EV_SNAP_COMMIT = 16,       // a0=committed version
  EV_SNAP_EVICT = 17,        // a0=newest evicted version
  EV_REPLICA_LAG = 18,       // a0=lag rounds a1=primary version
  EV_CRC_QUARANTINE = 19,    // a0=node a1=failures in window
  EV_CRC_FAILSTOP = 20,      // a0=node (persistently corrupting link)
  EV_TENANT_STARVED = 21,    // a0=tenant a1=starved_ms
  EV_CHAOS = 22,             // a0=kind (0 reset,1 drop,2 dup,3 corrupt)
                             //   a1=key
  EV_INSIGHT = 23,           // a0=state code a1=round (insight.py
                             //   classification change, journaled via
                             //   POST /events)
  EV_SHUTDOWN = 24,          // a0=1 failure-triggered, 0 clean
  EV_TYPE_COUNT = 25,
};

const char* EventTypeName(int32_t type);

#pragma pack(push, 1)
// One journal record. Packed: this struct IS the heartbeat wire
// sub-payload element (part of the versioned wire contract).
struct FleetEvent {
  int32_t type = EV_NONE;
  int32_t node_id = -1;
  int32_t role = -1;
  int32_t pad = 0;       // explicit, so the packed layout is stable
  int64_t ts_us = 0;     // local CLOCK_MONOTONIC at emit (us); the
                         // scheduler aligns via the sender's offset
  int64_t a0 = 0;
  int64_t a1 = 0;
  int64_t a2 = 0;
};

// Heartbeat sub-payload header: `count` FleetEvents follow, oldest
// first. clock_offset_us is the sender's CURRENT heartbeat-derived
// offset vs the scheduler clock (t_sched ~= t_local + offset), so the
// receiver can place even pre-outage backlog events on its timebase.
struct EventWireHdr {
  uint16_t magic = 0;
  uint16_t version = 0;
  int32_t node_id = -1;
  int32_t role = -1;
  int32_t count = 0;
  int64_t emitted_total = 0;
  int64_t dropped = 0;
  int64_t clock_offset_us = 0;
};
#pragma pack(pop)

constexpr uint16_t kEventWireMagic = 0xE7B5;  // != 0xB57A (roundstats)
constexpr uint16_t kEventWireVersion = 1;
constexpr int kMaxWireEvents = 64;  // per heartbeat; rest ride the next

class Events {
 public:
  // Leaked heap singleton (same rationale as Metrics/Trace/RoundStats):
  // shutdown and failure paths are exactly when journaling matters.
  static Events& Get();

  bool On() const { return armed_.load(std::memory_order_relaxed); }
  void SetNode(int role, int node_id);

  // Heartbeat-derived clock offset vs the scheduler (min-RTT
  // estimate); fed next to Trace::SetClock. The scheduler itself is
  // the timebase (offset 0).
  void SetClock(int64_t offset_us);
  int64_t clock_offset_us() const {
    return clock_offset_us_.load(std::memory_order_relaxed);
  }

  // The one emit entry point (no-op unless On()). Timestamps with
  // NowUs() and appends to the local drop-oldest ring; on the
  // scheduler the event also enters the fleet timeline directly.
  void Emit(int32_t type, int64_t a0 = 0, int64_t a1 = 0, int64_t a2 = 0);

  // APPEND the events newer than the last call to `out` as one
  // magic-tagged sub-payload (at most kMaxWireEvents; the backlog
  // rides later beats). Returns false — appending nothing — when off
  // or nothing is new, keeping the events-off heartbeat byte-for-byte
  // the pre-journal wire.
  bool FillWire(std::string* out);

  // Scheduler side: ingest one events sub-payload into the fleet
  // timeline, aligning each record's timestamp by the header's clock
  // offset. Returns false — and changes nothing — when the bytes are
  // not a recognized events chunk (old sender, foreign magic, short
  // frame).
  bool Ingest(const void* data, size_t len);

  // Bytes a recognized events sub-payload at `data` occupies (0 when
  // not ours) — heartbeat payloads multiplex magic-tagged chunks and
  // the scheduler walks them with this.
  static size_t PeekWireSize(const void* data, size_t len);

  // Scheduler side: sample every registered gauge into the bounded
  // per-metric history rings, rate-limited internally to one sample
  // per second — called from the heartbeat handler, so history
  // advances exactly while the fleet is alive.
  void SampleHistory(int64_t now_us);

  // Whole-state JSON for bps_events_summary: {"on","role","node_id",
  // "ring_capacity","emitted_total","dropped","clock_offset_us",
  // "events":[...]} plus, on ranks that ingested fleet events (the
  // scheduler), "timeline":[...] (clock-aligned, fleet-ordered) and
  // "history":{name:[[ts_us,value],...]}.
  std::string SnapshotJson();

  int64_t emitted_total();
  int64_t dropped();

 private:
  Events();

  struct TimelineEvent {
    FleetEvent ev;
    int64_t aligned_ts_us = 0;
  };

  void IngestOneLocked(const FleetEvent& ev, int64_t offset_us);

  std::atomic<bool> armed_{false};
  std::atomic<int> role_{-1};
  std::atomic<int> node_id_{-1};
  std::atomic<int64_t> clock_offset_us_{0};

  std::mutex mu_;
  size_t ring_cap_;
  size_t ring_head_ = 0;
  int64_t ring_total_ = 0;   // events ever emitted locally
  std::vector<FleetEvent> ring_;
  int64_t wire_sent_total_ = 0;  // events already shipped via FillWire

  // Fleet timeline (scheduler; bounded drop-oldest by arrival — reads
  // sort by aligned timestamp).
  std::deque<TimelineEvent> timeline_;
  size_t timeline_cap_;
  int64_t timeline_dropped_ = 0;
  int64_t ingested_total_ = 0;

  // Per-metric history rings (scheduler): name -> (ts, value) samples.
  struct History {
    std::deque<std::pair<int64_t, int64_t>> samples;
  };
  std::map<std::string, History> history_;
  size_t history_depth_;
  int64_t last_sample_us_ = 0;
};

}  // namespace bps
