// Fleet-wide distributed tracing.
//
// Two fixed-capacity, drop-oldest event rings shared by every role:
//
// - the MAIN ring (BYTEPS_TRACE_ON, capacity BYTEPS_TRACE_RING_EVENTS):
//   the Chrome-trace timeline — worker compress/push/pull spans, server
//   recv/park/sum/reply spans, van wire instants, scheduler membership
//   events, plus Chrome flow events ("s"/"t"/"f") whose ids are derived
//   from (sender node id, req_id) — both already cross the wire — so a
//   worker's push span visually stitches to its server's sum span and
//   back to the ack in the merged fleet view
//   (python -m byteps_tpu.monitor.timeline).
// - the FLIGHT RECORDER (BYTEPS_FLIGHT_RECORDER, default ON, capacity
//   BYTEPS_FLIGHT_RECORDER_EVENTS): a small always-on ring of
//   SIGNIFICANT events only (epoch pause/resume, reseeds, resends,
//   keepalives, chaos injections, reconnects, failures) that is
//   auto-dumped to BYTEPS_TRACE_DIR on fatal CHECK, failure SHUTDOWN,
//   and recovery EPOCH_PAUSE/RESUME — so every failure ships with the
//   last N events from every rank, with zero configuration.
//
// The replaced design was worker-only (TraceEvent lived in worker.h): a
// fat pull span could not distinguish "server summation slow" from "a
// peer worker is late" from "the wire is congested" — exactly the
// attribution the BytePS paper needed for its CPU-summation PS design.
//
// Concurrency: rings are mutex-guarded (emit sites are either cold-path
// or already serialised per connection/key); the armed checks are one
// relaxed atomic load, so a disabled ring costs one branch per site.
// Like the Metrics registry, the singleton is intentionally leaked so
// teardown paths (goodbye frames, fatal dumps) can always record.
#pragma once

#include <atomic>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

namespace bps {

int64_t NowUs();  // CLOCK_MONOTONIC microseconds (defined in trace.cc)

enum TracePhase : int32_t {
  TRACE_SPAN = 0,       // Chrome ph "X" (ts + dur)
  TRACE_INSTANT = 1,    // ph "i"
  TRACE_FLOW_OUT = 2,   // ph "s" — flow starts here
  TRACE_FLOW_STEP = 3,  // ph "t" — flow passes through here
  TRACE_FLOW_IN = 4,    // ph "f" bp "e" — flow ends here
};

struct TraceRec {
  char name[24] = {0};
  int64_t ts_us = 0;
  int64_t dur_us = 0;   // spans only
  int64_t key = 0;
  int64_t flow = 0;     // flow events: the stitch id; 0 = none
  int32_t phase = TRACE_INSTANT;
  int32_t peer = -1;    // peer node id (-1 = n/a)
  int32_t req_id = -1;
  int32_t round = -1;   // head.version where known
  int32_t aux = 0;      // cmd for wire instants; free-form otherwise
  // Byte labels for data-carrying spans (satellite): what
  // actually crossed the wire vs the decoded length — the quantized
  // wire's push/qdecode spans dump these so the timeline report can
  // show per-span quantized-vs-raw freight. 0/0 = unlabelled.
  int64_t wire_bytes = 0;
  int64_t raw_bytes = 0;
};

// Flow id for the (sender, req_id) pair: req ids are monotone per
// worker and the node id is fleet-unique, so the pair — which the wire
// already carries on every frame — names one request chain fleet-wide.
inline int64_t TraceFlowId(int node_id, int32_t req_id) {
  return (static_cast<int64_t>(node_id) << 40) |
         static_cast<int64_t>(static_cast<uint32_t>(req_id));
}

// Fixed-capacity drop-oldest ring. total()/dropped() are cumulative.
class TraceRing {
 public:
  explicit TraceRing(size_t cap) : cap_(cap < 8 ? 8 : cap) {
    buf_.resize(cap_);
  }
  void Emit(const TraceRec& r) {
    std::lock_guard<std::mutex> lk(mu_);
    buf_[head_] = r;
    head_ = (head_ + 1) % cap_;
    ++total_;
  }
  // Oldest -> newest. `drain` empties the ring (the main timeline is
  // dump-once; the flight recorder keeps recording across dumps).
  std::vector<TraceRec> Snapshot(bool drain) {
    std::lock_guard<std::mutex> lk(mu_);
    std::vector<TraceRec> out;
    size_t n = total_ < static_cast<int64_t>(cap_)
                   ? static_cast<size_t>(total_)
                   : cap_;
    out.reserve(n);
    size_t start = (head_ + cap_ - n) % cap_;
    for (size_t i = 0; i < n; ++i) {
      out.push_back(buf_[(start + i) % cap_]);
    }
    if (drain) {
      head_ = 0;
      total_ = 0;
      // dropped_ stays: it is the cumulative health counter.
    }
    return out;
  }
  int64_t total() const {
    std::lock_guard<std::mutex> lk(mu_);
    return total_;
  }
  int64_t dropped() const {
    std::lock_guard<std::mutex> lk(mu_);
    int64_t over = total_ - static_cast<int64_t>(cap_);
    return dropped_ + (over > 0 ? over : 0);
  }
  // Fold the current overflow into the cumulative count (drain time).
  void FoldDropped() {
    std::lock_guard<std::mutex> lk(mu_);
    int64_t over = total_ - static_cast<int64_t>(cap_);
    if (over > 0) dropped_ += over;
  }
  size_t capacity() const { return cap_; }

 private:
  mutable std::mutex mu_;
  size_t cap_;
  size_t head_ = 0;
  int64_t total_ = 0;    // events ever emitted (this fill)
  int64_t dropped_ = 0;  // folded from previous fills
  std::vector<TraceRec> buf_;
};

class Trace {
 public:
  // Leaked heap singleton (same rationale as Metrics::Get): fatal-path
  // dumps and goodbye-frame instants run during static teardown.
  static Trace& Get();

  // Node identity for dump metadata; re-invoked per bps_init.
  void SetNode(int role, int node_id, int worker_rank);
  // Per-rank clock alignment vs the scheduler, estimated from the
  // heartbeat RTT exchange (postoffice.cc): offset such that
  // t_scheduler ~= t_local + offset. rtt < 0 = no estimate yet.
  void SetClock(int64_t offset_us, int64_t rtt_us);
  // Step-window enforcement (BYTEPS_TRACE_START_STEP/_END_STEP): the
  // Python Timeline reports training steps; outside the window the main
  // ring stops recording so a core-only user tracing a long run no
  // longer accumulates events without bound. Steps never reported
  // (step < 0) leave the window open — raw FFI users keep the old
  // always-recording behavior.
  void SetStep(int step);
  // --- port only: runtime arming of the main ring, whatever
  // BYTEPS_TRACE_ON and its step window say: the step trace
  // (utils/timeline.py start_steps / stop_steps) turns it on for the
  // steps it records.
  void Arm(bool on);
  // --- end port only

  bool MainOn() const { return main_armed_.load(std::memory_order_relaxed); }
  bool FlightOn() const { return flight_on_; }

  // Main-ring emitters (no-ops unless MainOn()).
  void Span(const char* name, int64_t key, int64_t start_us, int64_t end_us,
            int peer = -1, int32_t req_id = -1, int32_t round = -1,
            int64_t wire_bytes = 0, int64_t raw_bytes = 0);
  void Instant(const char* name, int64_t key, int peer = -1,
               int32_t req_id = -1, int32_t aux = 0, int32_t round = -1);
  void Flow(TracePhase ph, const char* name, int64_t key, int64_t ts_us,
            int64_t flow_id);

  // Significant event: always into the flight recorder (when on), and
  // into the main ring when armed. The only emitter failure paths use.
  void Note(const char* name, int64_t key = 0, int peer = -1,
            int32_t req_id = -1, int32_t round = -1);

  // Chrome-trace JSON dumps; return event count, or -1 on I/O error.
  // DumpMain drains the ring (dump-once timeline semantics); DumpFlight
  // snapshots without draining (the recorder keeps recording).
  long long DumpMain(const char* path);
  long long DumpFlight(const char* path);
  // Flight dump to the default location:
  //   <BYTEPS_TRACE_DIR | BPS_TRACE_OUT | ./traces>/flight_r<role>_n<id>.json
  // `reason` lands in the dump metadata. Used by the auto-dump triggers
  // (fatal CHECK, failure SHUTDOWN, EPOCH_PAUSE/RESUME, recovery done).
  long long FlightDumpAuto(const char* reason);

  int64_t MainEventsTotal() const { return main_.total(); }
  int64_t MainDropped() const { return main_.dropped(); }

 private:
  Trace();
  void Emit(const TraceRec& r, bool significant);
  void RecomputeArmed();
  long long DumpRing(TraceRing* ring, const char* path, bool drain,
                     const char* ring_name, const char* reason);

  TraceRing main_;
  TraceRing flight_;
  bool trace_env_on_ = false;
  bool flight_on_ = true;
  int win_start_ = 1;
  int win_end_ = 1 << 30;
  std::atomic<bool> main_armed_{false};
  // --- port only: Arm's switch
  std::atomic<bool> runtime_on_{false};
  // --- end port only
  std::atomic<int> step_{-1};
  std::atomic<int> role_{-1};
  std::atomic<int> node_id_{-1};
  std::atomic<int> worker_rank_{-1};
  std::atomic<int64_t> clock_offset_us_{0};
  std::atomic<int64_t> clock_rtt_us_{-1};
  std::string last_reason_;  // guarded by reason_mu_
  // Pre-topology auto-dump path (flight_r<role>_pid<pid>.json): a dump
  // written before this rank learned its node id is unattributable to
  // humans and to timeline.py's role/node globs. SetNode renames it to
  // the canonical flight_r<role>_n<id>.json once topology is known
  // (satellite); a process that dies pre-topology keeps the
  // pid name — the merge tool tolerates both. Guarded by reason_mu_.
  std::string pid_dump_path_;
  // Incarnation-stable auto-dump path (satellite): a
  // relaunched process of the SAME role/node-id must not overwrite its
  // predecessor's dump — restart forensics need both sides of a crash.
  // The first auto dump probes flight_r<role>_n<id>.json, then
  // _i1/_i2/... for the first free name, and the choice is pinned here
  // so this process's own re-dumps still overwrite in place.
  // timeline.py labels the incarnations at merge. Guarded by reason_mu_.
  std::string auto_dump_path_;
  std::mutex reason_mu_;
};

// Fatal-CHECK hook (called from logging.h's LogMessage destructor just
// before abort): dump the flight recorder so every CHECK failure ships
// with the last N events. Reentrancy-guarded; never throws.
void FlightDumpOnFatal();

}  // namespace bps
