#include "events.h"

#include <algorithm>
#include <cstdlib>
#include <cstring>

#include "metrics.h"
#include "trace.h"

namespace bps {

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

// Gauge sampling cadence for the scheduler-side history rings. Fixed
// (not a knob): one sample per second is plenty for incident curves
// and bounds the sampling cost at one registry walk per second.
constexpr int64_t kHistorySampleUs = 1000000;

// Cap on how many DISTINCT metric series the history tracks: the gauge
// registry grows with features, and an unbounded map would too.
constexpr size_t kHistoryMaxSeries = 128;

void AppendEvent(std::string* out, const FleetEvent& e, int64_t ts_us) {
  char buf[256];
  snprintf(buf, sizeof(buf),
           "{\"type\":%d,\"name\":\"%s\",\"node\":%d,\"role\":%d,"
           "\"ts_us\":%lld,\"a0\":%lld,\"a1\":%lld,\"a2\":%lld}",
           e.type, EventTypeName(e.type), e.node_id, e.role,
           static_cast<long long>(ts_us), static_cast<long long>(e.a0),
           static_cast<long long>(e.a1), static_cast<long long>(e.a2));
  *out += buf;
}

}  // namespace

const char* EventTypeName(int32_t type) {
  switch (type) {
    case EV_NONE: return "none";
    case EV_EPOCH_PAUSE: return "epoch_pause";
    case EV_EPOCH_RESUME: return "epoch_resume";
    case EV_FLEET_PAUSE: return "fleet_pause";
    case EV_FLEET_RESUME: return "fleet_resume";
    case EV_JOIN: return "join";
    case EV_LEAVE: return "leave";
    case EV_DEATH: return "death";
    case EV_SERVER_RECOVER: return "server_recover";
    case EV_RESEED: return "reseed";
    case EV_SCHED_PARK: return "sched_park";
    case EV_SCHED_REREGISTER: return "sched_reregister";
    case EV_SCHED_RECOVERY_COMMIT: return "sched_recovery_commit";
    case EV_CKPT_SPILL: return "ckpt_spill";
    case EV_CKPT_SEAL: return "ckpt_seal";
    case EV_CKPT_RESTORE: return "ckpt_restore";
    case EV_SNAP_COMMIT: return "snap_commit";
    case EV_SNAP_EVICT: return "snap_evict";
    case EV_REPLICA_LAG: return "replica_lag";
    case EV_CRC_QUARANTINE: return "crc_quarantine";
    case EV_CRC_FAILSTOP: return "crc_failstop";
    case EV_TENANT_STARVED: return "tenant_starved";
    case EV_CHAOS: return "chaos";
    case EV_INSIGHT: return "insight";
    case EV_SHUTDOWN: return "shutdown";
    default: return "unknown";
  }
}

Events::Events()
    : ring_cap_(static_cast<size_t>(EnvLL("BYTEPS_EVENTS_RING", 512))),
      timeline_cap_(0),
      history_depth_(
          static_cast<size_t>(EnvLL("BYTEPS_EVENTS_HISTORY", 128))) {
  if (ring_cap_ < 16) ring_cap_ = 16;
  if (history_depth_ < 8) history_depth_ = 8;
  // The scheduler's timeline holds the whole fleet's journal; size it
  // a few rings deep so one chatty rank cannot evict the others.
  timeline_cap_ = ring_cap_ * 4;
  ring_.resize(ring_cap_);
  armed_.store(EnvOn("BYTEPS_EVENTS_ON", true), std::memory_order_relaxed);
}

Events& Events::Get() {
  static Events* inst = new Events();
  return *inst;
}

void Events::SetNode(int role, int node_id) {
  role_.store(role, std::memory_order_relaxed);
  node_id_.store(node_id, std::memory_order_relaxed);
}

void Events::SetClock(int64_t offset_us) {
  clock_offset_us_.store(offset_us, std::memory_order_relaxed);
}

void Events::Emit(int32_t type, int64_t a0, int64_t a1, int64_t a2) {
  if (!On()) return;
  FleetEvent e;
  e.type = type;
  e.node_id = node_id_.load(std::memory_order_relaxed);
  e.role = role_.load(std::memory_order_relaxed);
  e.ts_us = NowUs();
  e.a0 = a0;
  e.a1 = a1;
  e.a2 = a2;
  std::lock_guard<std::mutex> lk(mu_);
  ring_[ring_head_] = e;
  ring_head_ = (ring_head_ + 1) % ring_cap_;
  ++ring_total_;
  BPS_METRIC_COUNTER_ADD("bps_events_emitted_total", 1);
  // The scheduler is its own ingest path: its clock IS the timebase,
  // so its events enter the timeline directly with offset 0.
  if (e.role == 0 /* ROLE_SCHEDULER */) {
    IngestOneLocked(e, 0);
  }
}

bool Events::FillWire(std::string* out) {
  if (!On()) return false;
  std::lock_guard<std::mutex> lk(mu_);
  if (ring_total_ <= wire_sent_total_) return false;
  int64_t backlog = ring_total_ - wire_sent_total_;
  // Events that rotated out of the ring before a heartbeat could ship
  // them are lost to the timeline (counted in `dropped`).
  if (backlog > static_cast<int64_t>(ring_cap_)) {
    wire_sent_total_ = ring_total_ - static_cast<int64_t>(ring_cap_);
    backlog = static_cast<int64_t>(ring_cap_);
  }
  int count = backlog > kMaxWireEvents ? kMaxWireEvents
                                       : static_cast<int>(backlog);
  EventWireHdr hdr;
  hdr.magic = kEventWireMagic;
  hdr.version = kEventWireVersion;
  hdr.node_id = node_id_.load(std::memory_order_relaxed);
  hdr.role = role_.load(std::memory_order_relaxed);
  hdr.count = count;
  hdr.emitted_total = ring_total_;
  int64_t over = ring_total_ - static_cast<int64_t>(ring_cap_);
  int64_t unsent_over = wire_sent_total_ < over ? over - wire_sent_total_ : 0;
  hdr.dropped = unsent_over;
  hdr.clock_offset_us = clock_offset_us_.load(std::memory_order_relaxed);
  out->append(reinterpret_cast<const char*>(&hdr), sizeof(hdr));
  for (int64_t i = wire_sent_total_; i < wire_sent_total_ + count; ++i) {
    const FleetEvent& e = ring_[static_cast<size_t>(i % ring_cap_)];
    out->append(reinterpret_cast<const char*>(&e), sizeof(e));
  }
  wire_sent_total_ += count;
  return true;
}

size_t Events::PeekWireSize(const void* data, size_t len) {
  if (!data || len < sizeof(EventWireHdr)) return 0;
  EventWireHdr hdr;
  memcpy(&hdr, data, sizeof(hdr));
  if (hdr.magic != kEventWireMagic || hdr.version != kEventWireVersion) {
    return 0;
  }
  if (hdr.count < 0 || hdr.count > kMaxWireEvents) return 0;
  size_t need = sizeof(hdr) +
                static_cast<size_t>(hdr.count) * sizeof(FleetEvent);
  return len >= need ? need : 0;
}

bool Events::Ingest(const void* data, size_t len) {
  size_t need = PeekWireSize(data, len);
  if (need == 0) return false;
  EventWireHdr hdr;
  memcpy(&hdr, data, sizeof(hdr));
  const char* p = static_cast<const char*>(data) + sizeof(hdr);
  std::lock_guard<std::mutex> lk(mu_);
  for (int i = 0; i < hdr.count; ++i) {
    FleetEvent e;
    memcpy(&e, p + static_cast<size_t>(i) * sizeof(FleetEvent),
           sizeof(e));
    // Trust the header's identity over the record's: a record emitted
    // before SetNode (pre-topology) carries -1/-1.
    if (e.node_id < 0) e.node_id = hdr.node_id;
    if (e.role < 0) e.role = hdr.role;
    IngestOneLocked(e, hdr.clock_offset_us);
  }
  BPS_METRIC_COUNTER_ADD("bps_events_ingested_total", hdr.count);
  return true;
}

void Events::IngestOneLocked(const FleetEvent& ev, int64_t offset_us) {
  TimelineEvent t;
  t.ev = ev;
  // Offset convention: t_scheduler ~= t_local + offset.
  t.aligned_ts_us = ev.ts_us + offset_us;
  timeline_.push_back(t);
  ++ingested_total_;
  while (timeline_.size() > timeline_cap_) {
    timeline_.pop_front();
    ++timeline_dropped_;
  }
}

void Events::SampleHistory(int64_t now_us) {
  if (!On()) return;
  {
    std::lock_guard<std::mutex> lk(mu_);
    if (now_us - last_sample_us_ < kHistorySampleUs) return;
    last_sample_us_ = now_us;
  }
  // Walk the gauge registry OUTSIDE our lock (Metrics has its own),
  // then fold the batch in under ours.
  std::vector<std::pair<std::string, int64_t>> batch;
  Metrics::Get().ForEachGauge([&batch](const std::string& name,
                                       int64_t v) {
    batch.emplace_back(name, v);
  });
  std::lock_guard<std::mutex> lk(mu_);
  for (const auto& kv : batch) {
    auto it = history_.find(kv.first);
    if (it == history_.end()) {
      if (history_.size() >= kHistoryMaxSeries) continue;
      it = history_.emplace(kv.first, History{}).first;
    }
    it->second.samples.emplace_back(now_us, kv.second);
    while (it->second.samples.size() > history_depth_) {
      it->second.samples.pop_front();
    }
  }
}

int64_t Events::emitted_total() {
  std::lock_guard<std::mutex> lk(mu_);
  return ring_total_;
}

int64_t Events::dropped() {
  std::lock_guard<std::mutex> lk(mu_);
  int64_t over = ring_total_ - static_cast<int64_t>(ring_cap_);
  return over > 0 ? over : 0;
}

std::string Events::SnapshotJson() {
  std::lock_guard<std::mutex> lk(mu_);
  std::string out = "{";
  out += "\"on\":" + std::string(On() ? "true" : "false");
  out += ",\"role\":" +
         std::to_string(role_.load(std::memory_order_relaxed));
  out += ",\"node_id\":" +
         std::to_string(node_id_.load(std::memory_order_relaxed));
  out += ",\"ring_capacity\":" + std::to_string(ring_cap_);
  out += ",\"emitted_total\":" + std::to_string(ring_total_);
  int64_t over = ring_total_ - static_cast<int64_t>(ring_cap_);
  out += ",\"dropped\":" + std::to_string(over > 0 ? over : 0);
  out += ",\"clock_offset_us\":" +
         std::to_string(clock_offset_us_.load(std::memory_order_relaxed));
  // Local ring, oldest -> newest (raw local timestamps).
  size_t n = ring_total_ < static_cast<int64_t>(ring_cap_)
                 ? static_cast<size_t>(ring_total_)
                 : ring_cap_;
  size_t start = (ring_head_ + ring_cap_ - n) % ring_cap_;
  out += ",\"events\":[";
  for (size_t i = 0; i < n; ++i) {
    if (i) out += ",";
    const FleetEvent& e = ring_[(start + i) % ring_cap_];
    AppendEvent(&out, e, e.ts_us);
  }
  out += "]";
  // Fleet timeline (scheduler), sorted by ALIGNED timestamp — the
  // clock-skew-corrected fleet order an incident report renders.
  std::vector<const TimelineEvent*> sorted;
  sorted.reserve(timeline_.size());
  for (const auto& t : timeline_) sorted.push_back(&t);
  std::stable_sort(sorted.begin(), sorted.end(),
                   [](const TimelineEvent* a, const TimelineEvent* b) {
                     return a->aligned_ts_us < b->aligned_ts_us;
                   });
  out += ",\"timeline_dropped\":" + std::to_string(timeline_dropped_);
  out += ",\"ingested_total\":" + std::to_string(ingested_total_);
  out += ",\"timeline\":[";
  for (size_t i = 0; i < sorted.size(); ++i) {
    if (i) out += ",";
    AppendEvent(&out, sorted[i]->ev, sorted[i]->aligned_ts_us);
  }
  out += "]";
  out += ",\"history\":{";
  bool first = true;
  for (const auto& kv : history_) {
    if (!first) out += ",";
    first = false;
    out += "\"" + kv.first + "\":[";
    bool f2 = true;
    for (const auto& s : kv.second.samples) {
      if (!f2) out += ",";
      f2 = false;
      out += "[" + std::to_string(s.first) + "," +
             std::to_string(s.second) + "]";
    }
    out += "]";
  }
  out += "}}";
  return out;
}

}  // namespace bps
