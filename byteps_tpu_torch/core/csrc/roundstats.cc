#include "roundstats.h"

#include <cstdlib>
#include <cstring>

#include "metrics.h"
#include "tenancy.h"

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

// Rounds legally overlap: double buffering keeps r and r+1 live, and a
// deep-pipelining caller keeps up to ~4 in flight. An open round this
// far behind the newest with its ENQ/DONE ledger still unbalanced is
// wedged or abandoned (a failed handle) — force-finalize so the table
// stays bounded and the ring keeps moving.
constexpr int kOpenRounds = 8;

void AppendRec(std::string* out, const RoundRec& r) {
  char buf[512];
  snprintf(buf, sizeof(buf),
           "{\"round\":%d,\"parts\":%d,\"queue_us\":%lld,"
           "\"comp_us\":%lld,\"push_us\":%lld,\"sum_us\":%lld,"
           "\"wire_ack_us\":%lld,\"pull_us\":%lld,\"dec_us\":%lld,"
           "\"wire_bytes\":%lld,\"wire_msgs\":%d,\"fused_frames\":%d,"
           "\"retries\":%d,\"parked\":%d,\"wall_us\":%lld}",
           r.round, r.parts, static_cast<long long>(r.queue_us),
           static_cast<long long>(r.comp_us),
           static_cast<long long>(r.push_us),
           static_cast<long long>(r.sum_us),
           static_cast<long long>(
               r.push_us > r.sum_us ? r.push_us - r.sum_us : 0),
           static_cast<long long>(r.pull_us),
           static_cast<long long>(r.dec_us),
           static_cast<long long>(r.wire_bytes), r.wire_msgs,
           r.fused_frames, r.retries, r.parked,
           static_cast<long long>(RoundWallUs(r)));
  *out += buf;
}

}  // namespace

RoundStats::RoundStats()
    : ring_cap_(static_cast<size_t>(EnvLL("BYTEPS_ROUNDSTATS_RING", 256))) {
  if (ring_cap_ < 8) ring_cap_ = 8;
  ring_.resize(ring_cap_);
  armed_.store(EnvOn("BYTEPS_ROUNDSTATS_ON", true),
               std::memory_order_relaxed);
  heartbeat_summary_on_ = EnvOn("BYTEPS_ROUNDSTATS_HEARTBEAT_SUMMARY", true);
}

RoundStats& RoundStats::Get() {
  static RoundStats* inst = new RoundStats();
  return *inst;
}

void RoundStats::SetNode(int role, int node_id) {
  role_.store(role, std::memory_order_relaxed);
  node_id_.store(node_id, std::memory_order_relaxed);
}

void RoundStats::SetNodeTenant(int node_id, int tenant) {
  std::lock_guard<std::mutex> lk(mu_);
  node_tenant_[node_id] = tenant;
}

void RoundStats::Track(int32_t stage, int round, int64_t us,
                       int64_t bytes) {
  if (!On() || round < 0) return;
  std::lock_guard<std::mutex> lk(mu_);
  OpenRound& o = open_[round];
  o.rec.round = round;
  switch (stage) {
    case RS_ENQ:   ++o.enqueued; break;
    case RS_QUEUE: o.rec.queue_us += us; break;
    case RS_COMP:  o.rec.comp_us += us; break;
    case RS_PUSH:
      o.rec.push_us += us;
      o.rec.wire_bytes += bytes;
      break;
    case RS_SUM:   o.rec.sum_us += us; break;
    case RS_PULL:
      o.rec.pull_us += us;
      o.rec.wire_bytes += bytes;
      break;
    case RS_DEC:   o.rec.dec_us += us; break;
    case RS_RETRY: ++o.rec.retries; break;
    case RS_PARK:  ++o.rec.parked; break;
    case RS_FRAME:
      ++o.rec.wire_msgs;
      if (bytes) ++o.rec.fused_frames;
      break;
    case RS_DONE:
      ++o.done;
      ++o.rec.parts;
      break;
    default: return;
  }
  if (round > max_round_) max_round_ = round;
  TryFinalizeLocked();
}

void RoundStats::TryFinalizeLocked() {
  // Oldest-first so the ring preserves round order. Two rules:
  //  - ledger-balanced rounds (workers: every enqueued partition's pull
  //    landed) finalize once a NEWER round exists — "done for now" can
  //    be mid-step (tensor A's round r completes before tensor B's
  //    round-r push is even enqueued), so a later round starting is the
  //    step boundary signal;
  //  - ledger-less rounds (servers never see RS_ENQ/RS_DONE) finalize
  //    two rounds behind the newest — one round of slack for the legal
  //    double-buffer skew between slot parities.
  for (auto it = open_.begin(); it != open_.end();) {
    const bool balanced =
        it->second.enqueued > 0 && it->second.done >= it->second.enqueued;
    const bool ledgerless = it->second.enqueued == 0;
    if ((balanced && it->first < max_round_) ||
        (ledgerless && it->first <= max_round_ - 2)) {
      FinalizeLocked(it->first);
      it = open_.erase(it);
    } else {
      ++it;
    }
  }
  // Bounded open table: force out the oldest wedged rounds.
  while (open_.size() > kOpenRounds) {
    auto it = open_.begin();
    FinalizeLocked(it->first);
    ++forced_;
    open_.erase(it);
  }
}

void RoundStats::FinalizeLocked(int round) {
  const RoundRec& r = open_[round].rec;
  ring_[ring_head_] = r;
  ring_head_ = (ring_head_ + 1) % ring_cap_;
  ++ring_total_;
  PublishGaugesLocked(r);
}

void RoundStats::PublishGaugesLocked(const RoundRec& r) {
  // Per-round series on /metrics: monitor.top reads these for its
  // BOTTLENECK column without needing the /rounds endpoint. Gauges hold
  // the LAST completed round; the histogram keeps the distribution.
  BPS_METRIC_COUNTER_ADD("bps_rounds_completed_total", 1);
  BPS_METRIC_GAUGE_SET("bps_round_last", r.round);
  BPS_METRIC_GAUGE_SET("bps_round_parts", r.parts);
  BPS_METRIC_GAUGE_SET("bps_round_queue_us", r.queue_us);
  BPS_METRIC_GAUGE_SET("bps_round_comp_us", r.comp_us);
  BPS_METRIC_GAUGE_SET("bps_round_push_us", r.push_us);
  BPS_METRIC_GAUGE_SET("bps_round_sum_us", r.sum_us);
  BPS_METRIC_GAUGE_SET("bps_round_wire_ack_us",
                       r.push_us > r.sum_us ? r.push_us - r.sum_us : 0);
  BPS_METRIC_GAUGE_SET("bps_round_pull_us", r.pull_us);
  BPS_METRIC_GAUGE_SET("bps_round_dec_us", r.dec_us);
  BPS_METRIC_GAUGE_SET("bps_round_wire_bytes", r.wire_bytes);
  BPS_METRIC_GAUGE_SET("bps_round_wire_msgs", r.wire_msgs);
  BPS_METRIC_GAUGE_SET("bps_round_retries", r.retries);
  BPS_METRIC_GAUGE_SET("bps_round_parked", r.parked);
  BPS_METRIC_HISTO_OBSERVE("bps_round_wall_us", RoundWallUs(r));
}

bool RoundStats::FillWire(std::string* out) {
  if (!On() || !heartbeat_summary_on_) return false;
  std::lock_guard<std::mutex> lk(mu_);
  if (ring_total_ <= wire_sent_total_) return false;
  int64_t backlog = ring_total_ - wire_sent_total_;
  // Rounds that rotated out of the ring before a heartbeat could ship
  // them are lost to the fleet table (counted in `dropped`).
  if (backlog > static_cast<int64_t>(ring_cap_)) {
    wire_sent_total_ = ring_total_ - static_cast<int64_t>(ring_cap_);
    backlog = static_cast<int64_t>(ring_cap_);
  }
  int count = backlog > kMaxWireRecs ? kMaxWireRecs
                                     : static_cast<int>(backlog);
  RoundSummaryHdr hdr;
  hdr.magic = kRoundSummaryMagic;
  hdr.version = kRoundSummaryVersion;
  hdr.node_id = node_id_.load(std::memory_order_relaxed);
  hdr.role = role_.load(std::memory_order_relaxed);
  hdr.count = count;
  hdr.completed_total = ring_total_;
  int64_t over = ring_total_ - static_cast<int64_t>(ring_cap_);
  hdr.dropped = forced_ + (over > 0 ? over : 0);
  out->assign(reinterpret_cast<const char*>(&hdr), sizeof(hdr));
  // Oldest unsent first. ring slot of the i-th record ever finalized:
  // i % cap (head_ advanced past it).
  for (int64_t i = wire_sent_total_; i < wire_sent_total_ + count; ++i) {
    const RoundRec& r = ring_[static_cast<size_t>(i % ring_cap_)];
    out->append(reinterpret_cast<const char*>(&r), sizeof(r));
  }
  wire_sent_total_ += count;
  return true;
}

size_t RoundStats::WireSize(const void* data, size_t len) {
  if (!data || len < sizeof(RoundSummaryHdr)) return 0;
  RoundSummaryHdr hdr;
  memcpy(&hdr, data, sizeof(hdr));
  if (hdr.magic != kRoundSummaryMagic ||
      hdr.version != kRoundSummaryVersion) {
    return 0;
  }
  if (hdr.count < 0 || hdr.count > kMaxWireRecs) return 0;
  size_t need =
      sizeof(hdr) + static_cast<size_t>(hdr.count) * sizeof(RoundRec);
  return len >= need ? need : 0;
}

bool RoundStats::Ingest(const void* data, size_t len) {
  if (len < sizeof(RoundSummaryHdr)) return false;
  RoundSummaryHdr hdr;
  memcpy(&hdr, data, sizeof(hdr));
  if (hdr.magic != kRoundSummaryMagic ||
      hdr.version != kRoundSummaryVersion) {
    return false;  // unknown sender generation — interop: ignore
  }
  if (hdr.count < 0 || hdr.count > kMaxWireRecs ||
      len < sizeof(hdr) + static_cast<size_t>(hdr.count) * sizeof(RoundRec)) {
    return false;
  }
  const char* p = static_cast<const char*>(data) + sizeof(hdr);
  std::lock_guard<std::mutex> lk(mu_);
  RankState& st = fleet_[hdr.node_id];
  st.role = hdr.role;
  st.completed_total = hdr.completed_total;
  for (int i = 0; i < hdr.count; ++i) {
    RoundRec r;
    memcpy(&r, p + static_cast<size_t>(i) * sizeof(RoundRec), sizeof(r));
    st.last = r;
    ++st.updates;
    double wall = static_cast<double>(RoundWallUs(r));
    st.ewma_wall_us = st.updates == 1
                          ? wall
                          : (1.0 - kRoundEwmaAlpha) * st.ewma_wall_us +
                                kRoundEwmaAlpha * wall;
    fleet_rounds_[r.round][hdr.node_id] = r;
  }
  // Bounded fleet table: keep the last 128 rounds.
  while (fleet_rounds_.size() > 128) {
    fleet_rounds_.erase(fleet_rounds_.begin());
  }
  BPS_METRIC_COUNTER_ADD("bps_round_summaries_ingested_total", hdr.count);
  return true;
}

bool RoundStats::LastCompleted(RoundRec* out) {
  std::lock_guard<std::mutex> lk(mu_);
  if (ring_total_ == 0) return false;
  *out = ring_[(ring_head_ + ring_cap_ - 1) % ring_cap_];
  return true;
}

int64_t RoundStats::completed_total() {
  std::lock_guard<std::mutex> lk(mu_);
  return ring_total_;
}

int64_t RoundStats::dropped() {
  std::lock_guard<std::mutex> lk(mu_);
  int64_t over = ring_total_ - static_cast<int64_t>(ring_cap_);
  return forced_ + (over > 0 ? over : 0);
}

std::string RoundStats::SnapshotJson() {
  std::lock_guard<std::mutex> lk(mu_);
  std::string out = "{";
  out += "\"on\":" + std::string(On() ? "true" : "false");
  out += ",\"role\":" +
         std::to_string(role_.load(std::memory_order_relaxed));
  out += ",\"node_id\":" +
         std::to_string(node_id_.load(std::memory_order_relaxed));
  out += ",\"tenant\":" + std::to_string(TenantId());
  out += ",\"ring_capacity\":" + std::to_string(ring_cap_);
  out += ",\"completed_total\":" + std::to_string(ring_total_);
  int64_t over = ring_total_ - static_cast<int64_t>(ring_cap_);
  out += ",\"dropped\":" +
         std::to_string(forced_ + (over > 0 ? over : 0));
  out += ",\"last\":";
  if (ring_total_ > 0) {
    AppendRec(&out, ring_[(ring_head_ + ring_cap_ - 1) % ring_cap_]);
  } else {
    out += "null";
  }
  size_t n = ring_total_ < static_cast<int64_t>(ring_cap_)
                 ? static_cast<size_t>(ring_total_)
                 : ring_cap_;
  size_t start = (ring_head_ + ring_cap_ - n) % ring_cap_;
  out += ",\"rounds\":[";
  for (size_t i = 0; i < n; ++i) {
    if (i) out += ",";
    AppendRec(&out, ring_[(start + i) % ring_cap_]);
  }
  out += "]";
  out += ",\"fleet\":{";
  bool first = true;
  for (const auto& kv : fleet_) {
    if (!first) out += ",";
    first = false;
    out += "\"" + std::to_string(kv.first) + "\":{";
    out += "\"role\":" + std::to_string(kv.second.role);
    auto tit = node_tenant_.find(kv.first);
    out += ",\"tenant\":" +
           std::to_string(tit == node_tenant_.end() ? 0 : tit->second);
    out += ",\"completed_total\":" +
           std::to_string(kv.second.completed_total);
    out += ",\"updates\":" + std::to_string(kv.second.updates);
    char e[48];
    snprintf(e, sizeof(e), ",\"ewma_wall_us\":%.1f",
             kv.second.ewma_wall_us);
    out += e;
    out += ",\"last\":";
    AppendRec(&out, kv.second.last);
    out += "}";
  }
  out += "},\"fleet_rounds\":{";
  first = true;
  for (const auto& rkv : fleet_rounds_) {
    if (!first) out += ",";
    first = false;
    out += "\"" + std::to_string(rkv.first) + "\":{";
    bool f2 = true;
    for (const auto& nkv : rkv.second) {
      if (!f2) out += ",";
      f2 = false;
      out += "\"" + std::to_string(nkv.first) + "\":";
      AppendRec(&out, nkv.second);
    }
    out += "}";
  }
  out += "}}";
  return out;
}

}  // namespace bps
