#include "trace.h"

#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

#include <chrono>
#include <cstdio>
#include <cstdlib>

#include "metrics.h"

namespace bps {

int64_t NowUs() {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

namespace {

int64_t EnvLL(const char* name, int64_t dflt) {
  const char* v = getenv(name);
  return v && *v ? atoll(v) : dflt;
}

bool EnvOn(const char* name, bool dflt) {
  const char* v = getenv(name);
  if (!v || !*v) return dflt;
  return strcmp(v, "0") != 0 && strcasecmp(v, "false") != 0 &&
         strcasecmp(v, "off") != 0 && strcasecmp(v, "no") != 0;
}

const char* PhaseStr(int32_t ph) {
  switch (ph) {
    case TRACE_SPAN: return "X";
    case TRACE_FLOW_OUT: return "s";
    case TRACE_FLOW_STEP: return "t";
    case TRACE_FLOW_IN: return "f";
    default: return "i";
  }
}

}  // namespace

Trace::Trace()
    : main_(static_cast<size_t>(EnvLL("BYTEPS_TRACE_RING_EVENTS", 65536))),
      flight_(static_cast<size_t>(
          EnvLL("BYTEPS_FLIGHT_RECORDER_EVENTS", 256))) {
  trace_env_on_ = EnvOn("BYTEPS_TRACE_ON", false);
  flight_on_ = EnvOn("BYTEPS_FLIGHT_RECORDER", true);
  if (const char* s = getenv("BYTEPS_TRACE_START_STEP")) {
    if (*s) win_start_ = atoi(s);
  }
  if (const char* s = getenv("BYTEPS_TRACE_END_STEP")) {
    if (*s) win_end_ = atoi(s);
  }
  RecomputeArmed();
}

Trace& Trace::Get() {
  static Trace* inst = new Trace();
  return *inst;
}

void Trace::SetNode(int role, int node_id, int worker_rank) {
  role_.store(role, std::memory_order_relaxed);
  node_id_.store(node_id, std::memory_order_relaxed);
  worker_rank_.store(worker_rank, std::memory_order_relaxed);
  if (node_id < 0) return;
  // A flight dump written before the topology completed carries a pid
  // name nobody can attribute; now that this rank knows who it is,
  // give the file its canonical role/node name (best-effort — the
  // dump content, with its meta, is the source of truth either way).
  std::string old_path;
  {
    std::lock_guard<std::mutex> lk(reason_mu_);
    old_path.swap(pid_dump_path_);
  }
  if (old_path.empty()) return;
  std::string dir = old_path.substr(0, old_path.find_last_of('/'));
  // Same incarnation probing as FlightDumpAuto: the canonical name may
  // already belong to a dead predecessor's dump — renaming over it
  // would destroy the pre-crash half of the forensics.
  char new_path[512];
  snprintf(new_path, sizeof(new_path), "%s/flight_r%d_n%d.json",
           dir.c_str(), role, node_id);
  struct stat st {};
  for (int k = 1; ::stat(new_path, &st) == 0 && k < 1000; ++k) {
    snprintf(new_path, sizeof(new_path), "%s/flight_r%d_n%d_i%d.json",
             dir.c_str(), role, node_id, k);
  }
  if (::rename(old_path.c_str(), new_path) == 0) {
    std::lock_guard<std::mutex> lk(reason_mu_);
    if (auto_dump_path_.empty()) auto_dump_path_ = new_path;
  }
}

void Trace::SetClock(int64_t offset_us, int64_t rtt_us) {
  clock_offset_us_.store(offset_us, std::memory_order_relaxed);
  clock_rtt_us_.store(rtt_us, std::memory_order_relaxed);
}

void Trace::RecomputeArmed() {
  int s = step_.load(std::memory_order_relaxed);
  bool in_window = s < 0 || (s >= win_start_ && s <= win_end_);
  main_armed_.store(trace_env_on_ && in_window,
                    std::memory_order_relaxed);
  // --- port only: armed at run time, in any window
  if (runtime_on_.load(std::memory_order_relaxed)) {
    main_armed_.store(true, std::memory_order_relaxed);
  }
  // --- end port only
}
// --- port only: Trace::Arm

void Trace::Arm(bool on) {
  runtime_on_.store(on, std::memory_order_relaxed);
  RecomputeArmed();
}
// --- end port only

void Trace::SetStep(int step) {
  step_.store(step, std::memory_order_relaxed);
  RecomputeArmed();
}

void Trace::Emit(const TraceRec& r, bool significant) {
  if (MainOn()) {
    main_.Emit(r);
    BPS_METRIC_COUNTER_ADD("bps_trace_events_total", 1);
    // Surface drop-oldest overwrites live: a climbing dropped counter
    // (TRACE-DROPPING in monitor.top) means the window outgrew the ring
    // — raise BYTEPS_TRACE_RING_EVENTS or narrow the step window.
    static int64_t last_dropped = 0;
    int64_t d = main_.dropped();
    if (d > last_dropped) {
      BPS_METRIC_COUNTER_ADD("bps_trace_dropped_total", d - last_dropped);
      last_dropped = d;
    }
  }
  if (significant && flight_on_) flight_.Emit(r);
}

void Trace::Span(const char* name, int64_t key, int64_t start_us,
                 int64_t end_us, int peer, int32_t req_id, int32_t round,
                 int64_t wire_bytes, int64_t raw_bytes) {
  if (!MainOn()) return;
  TraceRec r;
  snprintf(r.name, sizeof(r.name), "%s", name);
  r.phase = TRACE_SPAN;
  r.ts_us = start_us;
  r.dur_us = end_us - start_us;
  r.key = key;
  r.peer = peer;
  r.req_id = req_id;
  r.round = round;
  r.wire_bytes = wire_bytes;
  r.raw_bytes = raw_bytes;
  Emit(r, false);
}

void Trace::Instant(const char* name, int64_t key, int peer,
                    int32_t req_id, int32_t aux, int32_t round) {
  if (!MainOn()) return;
  TraceRec r;
  snprintf(r.name, sizeof(r.name), "%s", name);
  r.phase = TRACE_INSTANT;
  r.ts_us = NowUs();
  r.key = key;
  r.peer = peer;
  r.req_id = req_id;
  r.aux = aux;
  r.round = round;
  Emit(r, false);
}

void Trace::Flow(TracePhase ph, const char* name, int64_t key,
                 int64_t ts_us, int64_t flow_id) {
  if (!MainOn()) return;
  TraceRec r;
  snprintf(r.name, sizeof(r.name), "%s", name);
  r.phase = ph;
  r.ts_us = ts_us;
  r.key = key;
  r.flow = flow_id;
  Emit(r, false);
}

void Trace::Note(const char* name, int64_t key, int peer, int32_t req_id,
                 int32_t round) {
  if (!flight_on_ && !MainOn()) return;
  TraceRec r;
  snprintf(r.name, sizeof(r.name), "%s", name);
  r.phase = TRACE_INSTANT;
  r.ts_us = NowUs();
  r.key = key;
  r.peer = peer;
  r.req_id = req_id;
  r.round = round;
  Emit(r, true);
}

long long Trace::DumpRing(TraceRing* ring, const char* path, bool drain,
                          const char* ring_name, const char* reason) {
  int64_t dropped = ring->dropped();
  int64_t total = ring->total();
  if (drain) ring->FoldDropped();
  std::vector<TraceRec> evs = ring->Snapshot(drain);
  FILE* f = fopen(path, "w");
  if (!f) return -1;
  int nid = node_id_.load(std::memory_order_relaxed);
  int pid_field = nid >= 0 ? nid : 0;
  fprintf(f,
          "{\"meta\":{\"ring\":\"%s\",\"role\":%d,\"node_id\":%d,"
          "\"worker_rank\":%d,\"pid\":%d,\"clock_offset_us\":%lld,"
          "\"clock_rtt_us\":%lld,\"events_total\":%lld,"
          "\"dropped\":%lld,\"reason\":\"%s\"},\n",
          ring_name, role_.load(std::memory_order_relaxed), nid,
          worker_rank_.load(std::memory_order_relaxed),
          static_cast<int>(getpid()),
          static_cast<long long>(
              clock_offset_us_.load(std::memory_order_relaxed)),
          static_cast<long long>(
              clock_rtt_us_.load(std::memory_order_relaxed)),
          static_cast<long long>(total), static_cast<long long>(dropped),
          reason ? reason : "");
  fprintf(f, "\"traceEvents\":[\n");
  for (size_t i = 0; i < evs.size(); ++i) {
    const TraceRec& e = evs[i];
    const char* sep = i + 1 < evs.size() ? "," : "";
    if (e.phase == TRACE_SPAN) {
      // Byte labels only when present: unlabelled spans keep the
      // earlier args shape byte for byte.
      char bytes_args[96] = "";
      if (e.raw_bytes > 0) {
        snprintf(bytes_args, sizeof(bytes_args),
                 ",\"wire_bytes\":%lld,\"raw_bytes\":%lld",
                 static_cast<long long>(e.wire_bytes),
                 static_cast<long long>(e.raw_bytes));
      }
      fprintf(f,
              "{\"name\":\"%s\",\"ph\":\"X\",\"pid\":%d,\"tid\":%lld,"
              "\"ts\":%lld,\"dur\":%lld,\"args\":{\"key\":%lld,"
              "\"peer\":%d,\"req\":%d,\"round\":%d%s}}%s\n",
              e.name, pid_field, static_cast<long long>(e.key),
              static_cast<long long>(e.ts_us),
              static_cast<long long>(e.dur_us),
              static_cast<long long>(e.key), e.peer, e.req_id, e.round,
              bytes_args, sep);
    } else if (e.phase == TRACE_FLOW_OUT || e.phase == TRACE_FLOW_STEP ||
               e.phase == TRACE_FLOW_IN) {
      // Chrome flow-event triple: bound by (cat, name, id); "f" carries
      // bp:"e" so it binds to the enclosing slice like "s"/"t" do.
      fprintf(f,
              "{\"name\":\"%s\",\"cat\":\"bps\",\"ph\":\"%s\",%s"
              "\"id\":%lld,\"pid\":%d,\"tid\":%lld,\"ts\":%lld}%s\n",
              e.name, PhaseStr(e.phase),
              e.phase == TRACE_FLOW_IN ? "\"bp\":\"e\"," : "",
              static_cast<long long>(e.flow), pid_field,
              static_cast<long long>(e.key),
              static_cast<long long>(e.ts_us), sep);
    } else {
      fprintf(f,
              "{\"name\":\"%s\",\"ph\":\"i\",\"s\":\"t\",\"pid\":%d,"
              "\"tid\":%lld,\"ts\":%lld,\"args\":{\"key\":%lld,"
              "\"peer\":%d,\"req\":%d,\"round\":%d,\"aux\":%d}}%s\n",
              e.name, pid_field, static_cast<long long>(e.key),
              static_cast<long long>(e.ts_us),
              static_cast<long long>(e.key), e.peer, e.req_id, e.round,
              e.aux, sep);
    }
  }
  fprintf(f, "]}\n");
  fclose(f);
  return static_cast<long long>(evs.size());
}

long long Trace::DumpMain(const char* path) {
  return DumpRing(&main_, path, /*drain=*/true, "trace", "");
}

long long Trace::DumpFlight(const char* path) {
  std::string reason;
  {
    std::lock_guard<std::mutex> lk(reason_mu_);
    reason = last_reason_;
  }
  return DumpRing(&flight_, path, /*drain=*/false, "flight",
                  reason.c_str());
}

long long Trace::FlightDumpAuto(const char* reason) {
  if (!flight_on_) return 0;
  {
    std::lock_guard<std::mutex> lk(reason_mu_);
    last_reason_ = reason ? reason : "";
  }
  const char* dir = getenv("BYTEPS_TRACE_DIR");
  if (!dir || !*dir) dir = getenv("BPS_TRACE_OUT");
  if (!dir || !*dir) dir = "./traces";
  ::mkdir(dir, 0777);  // single level, best-effort (EEXIST is fine)
  char path[512];
  int nid = node_id_.load(std::memory_order_relaxed);
  if (nid >= 0) {
    // Probe for the first free incarnation name ONCE, then reuse it:
    // a relaunch of the same role/node must not overwrite its
    // predecessor's dump, but this process's own re-dumps should
    // overwrite in place (see auto_dump_path_ in trace.h).
    std::lock_guard<std::mutex> lk(reason_mu_);
    if (auto_dump_path_.empty()) {
      const int role = role_.load(std::memory_order_relaxed);
      snprintf(path, sizeof(path), "%s/flight_r%d_n%d.json", dir, role,
               nid);
      struct stat st {};
      for (int k = 1; ::stat(path, &st) == 0 && k < 1000; ++k) {
        snprintf(path, sizeof(path), "%s/flight_r%d_n%d_i%d.json", dir,
                 role, nid, k);
      }
      auto_dump_path_ = path;
    }
    snprintf(path, sizeof(path), "%s", auto_dump_path_.c_str());
  } else {
    // Pre-topology fatal: no node id yet; the pid keeps files distinct.
    // Remember the path — SetNode renames it to the role/node form if
    // this process survives long enough to learn its identity.
    snprintf(path, sizeof(path), "%s/flight_r%d_pid%d.json", dir,
             role_.load(std::memory_order_relaxed),
             static_cast<int>(getpid()));
    std::lock_guard<std::mutex> lk(reason_mu_);
    pid_dump_path_ = path;
  }
  long long n = DumpFlight(path);
  if (n >= 0) BPS_METRIC_COUNTER_ADD("bps_flight_dumps_total", 1);
  return n;
}

void FlightDumpOnFatal() {
  // One dump per process: a fatal inside the dump (or a second CHECK on
  // another thread racing the abort) must not recurse or interleave.
  static std::atomic<bool> dumped{false};
  bool expected = false;
  if (!dumped.compare_exchange_strong(expected, true)) return;
  Trace& t = Trace::Get();
  if (!t.FlightOn()) return;
  t.FlightDumpAuto("fatal_check");
}

}  // namespace bps
