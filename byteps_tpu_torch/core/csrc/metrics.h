// Lock-free metric registry: counters, gauges, fixed-bucket latency
// histograms, exported through bps_metrics_snapshot (c_api.cc) and the
// byteps_tpu.monitor Python package.
//
// New scope (no reference equivalent): the reference's only runtime
// observability is the post-hoc Chrome-trace timeline (BYTEPS_TRACE_*);
// a production fleet needs live per-stage counters you can scrape while
// the job runs (ROADMAP north star; docs/monitoring.md).
//
// Concurrency model: every metric is a named set of std::atomic<int64_t>
// words. Registration (first lookup of a name) takes a mutex; hot paths
// cache the returned pointer in a function-local static, so the steady
// state is one relaxed atomic add per event. Entries are never removed,
// so cached pointers stay valid for the process lifetime — including
// across bps_finalize/bps_init cycles (metrics are cumulative per
// process, like the van byte counters they absorb).
#pragma once

#include <atomic>
#include <cstdint>
#include <map>
#include <memory>
#include <mutex>
#include <string>

namespace bps {

// Fixed bucket upper bounds in MICROSECONDS, spanning sub-RTT loopback
// sends (~50 us) to multi-second straggler pulls. Cumulative ("le")
// conversion for Prometheus exposition happens Python-side
// (monitor/metrics.py); the C side stores per-bucket counts.
constexpr int64_t kHistoBoundsUs[] = {
    50,     100,     250,     500,     1000,    2500,    5000,    10000,
    25000,  50000,   100000,  250000,  500000,  1000000, 2500000, 5000000,
};
constexpr int kHistoBuckets =
    static_cast<int>(sizeof(kHistoBoundsUs) / sizeof(kHistoBoundsUs[0])) + 1;

struct MetricHistogram {
  std::atomic<int64_t> buckets[kHistoBuckets] = {};
  std::atomic<int64_t> sum{0};
  std::atomic<int64_t> count{0};

  void Observe(int64_t v) {
    int i = 0;
    while (i < kHistoBuckets - 1 && v > kHistoBoundsUs[i]) ++i;
    buckets[i].fetch_add(1, std::memory_order_relaxed);
    sum.fetch_add(v, std::memory_order_relaxed);
    count.fetch_add(1, std::memory_order_relaxed);
  }
};

class Metrics {
 public:
  // Intentionally leaked: the registry is constructed AFTER the c_api
  // Global (first metric registration happens inside bps_init), so a
  // function-local static would be destroyed BEFORE ~Global — whose
  // goodbye protocol still sends frames through Van::Send, which counts
  // them here. A heap singleton outlives every teardown path, and the
  // pointers hot paths cache stay valid for the process lifetime.
  static Metrics& Get() {
    static Metrics* inst = new Metrics();
    return *inst;
  }

  std::atomic<int64_t>* Counter(const std::string& name) {
    return Slot(&counters_, name);
  }
  std::atomic<int64_t>* Gauge(const std::string& name) {
    return Slot(&gauges_, name);
  }
  MetricHistogram* Histogram(const std::string& name) {
    std::lock_guard<std::mutex> lk(mu_);
    auto& h = histos_[name];
    if (!h) h = std::make_unique<MetricHistogram>();
    return h.get();
  }

  // Registry contents as JSON object members ("counters":{...},
  // "gauges":{...},"histograms":{...}) WITHOUT the enclosing braces —
  // bps_metrics_snapshot appends topology/role state around it.
  std::string SnapshotJson() {
    std::lock_guard<std::mutex> lk(mu_);
    std::string out = "\"counters\":{";
    AppendScalars(&out, counters_);
    out += "},\"gauges\":{";
    AppendScalars(&out, gauges_);
    out += "},\"histograms\":{";
    bool first = true;
    for (const auto& kv : histos_) {
      if (!first) out += ",";
      first = false;
      out += "\"" + kv.first + "\":{\"bounds_us\":[";
      for (int i = 0; i < kHistoBuckets - 1; ++i) {
        if (i) out += ",";
        out += std::to_string(kHistoBoundsUs[i]);
      }
      out += "],\"buckets\":[";
      for (int i = 0; i < kHistoBuckets; ++i) {
        if (i) out += ",";
        out += std::to_string(
            kv.second->buckets[i].load(std::memory_order_relaxed));
      }
      out += "],\"sum\":" +
             std::to_string(kv.second->sum.load(std::memory_order_relaxed));
      out += ",\"count\":" +
             std::to_string(kv.second->count.load(std::memory_order_relaxed));
      out += "}";
    }
    out += "}";
    return out;
  }

  // Enumerate the registered gauges under the registry lock
  // (the scheduler samples every gauge into its event-journal history
  // rings). Registration-ordered; fn(name, current_value).
  template <typename Fn>
  void ForEachGauge(Fn fn) {
    std::lock_guard<std::mutex> lk(mu_);
    for (const auto& kv : gauges_) {
      fn(kv.first, kv.second->load(std::memory_order_relaxed));
    }
  }

 private:
  using ScalarMap =
      std::map<std::string, std::unique_ptr<std::atomic<int64_t>>>;

  std::atomic<int64_t>* Slot(ScalarMap* m, const std::string& name) {
    std::lock_guard<std::mutex> lk(mu_);
    auto& p = (*m)[name];
    if (!p) p = std::make_unique<std::atomic<int64_t>>(0);
    return p.get();
  }

  static void AppendScalars(std::string* out, const ScalarMap& m) {
    bool first = true;
    for (const auto& kv : m) {
      if (!first) *out += ",";
      first = false;
      *out += "\"" + kv.first +
              "\":" + std::to_string(kv.second->load(std::memory_order_relaxed));
    }
  }

  std::mutex mu_;  // registration + snapshot only; never on the add path
  ScalarMap counters_;
  ScalarMap gauges_;
  std::map<std::string, std::unique_ptr<MetricHistogram>> histos_;
};

// Hot-path helpers: resolve the name once per call site.
#define BPS_METRIC_COUNTER_ADD(name, delta)                                \
  do {                                                                     \
    static std::atomic<int64_t>* c = ::bps::Metrics::Get().Counter(name);  \
    c->fetch_add((delta), std::memory_order_relaxed);                      \
  } while (0)

#define BPS_METRIC_GAUGE_SET(name, value)                                  \
  do {                                                                     \
    static std::atomic<int64_t>* g = ::bps::Metrics::Get().Gauge(name);    \
    g->store((value), std::memory_order_relaxed);                          \
  } while (0)

#define BPS_METRIC_HISTO_OBSERVE(name, value)                              \
  do {                                                                     \
    static ::bps::MetricHistogram* h =                                     \
        ::bps::Metrics::Get().Histogram(name);                             \
    h->Observe(value);                                                     \
  } while (0)

}  // namespace bps
