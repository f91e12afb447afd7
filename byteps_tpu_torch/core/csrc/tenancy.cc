#include "tenancy.h"

#include <cstdlib>
#include <memory>

namespace bps {

namespace {

long EnvLongT(const char* name, long dflt) {
  const char* v = getenv(name);
  return v && *v ? atol(v) : dflt;
}

}  // namespace

uint16_t TenantId() {
  static const uint16_t id = [] {
    long v = EnvLongT("BYTEPS_TENANT_ID", 0);
    if (v < 0) v = 0;
    if (v > 0xffff) v = 0xffff;
    return static_cast<uint16_t>(v);
  }();
  return id;
}

const std::string& TenantName() {
  static const std::string name = [] {
    const char* v = getenv("BYTEPS_TENANT_NAME");
    if (v && *v) return std::string(v);
    if (TenantId() == 0) return std::string("default");
    return "tenant" + std::to_string(TenantId());
  }();
  return name;
}

int TenantWeight() {
  static const int w = [] {
    long v = EnvLongT("BYTEPS_TENANT_WEIGHT", 1);
    if (v < 1) v = 1;
    if (v > (1 << 20)) v = 1 << 20;
    return static_cast<int>(v);
  }();
  return w;
}

int64_t TenantQuantum() {
  static const int64_t q = [] {
    long v = EnvLongT("BYTEPS_TENANT_QUANTUM_BYTES", 64 * 1024);
    if (v < 1024) v = 1024;
    return static_cast<int64_t>(v);
  }();
  return q;
}

Tenancy& Tenancy::Get() {
  static Tenancy* inst = new Tenancy();
  return *inst;
}

TenantStat* Tenancy::OfSlow(uint16_t tenant) {
  std::lock_guard<std::mutex> lk(mu_);
  auto& p = stats_[tenant];
  if (!p) p = std::make_unique<TenantStat>();
  if (tenant < kFastTenants) {
    fast_[tenant].store(p.get(), std::memory_order_release);
  }
  return p.get();
}

std::vector<uint16_t> Tenancy::Known() {
  std::lock_guard<std::mutex> lk(mu_);
  std::vector<uint16_t> out;
  out.reserve(stats_.size());
  for (const auto& kv : stats_) out.push_back(kv.first);
  return out;
}

std::string Tenancy::SnapshotJson(int64_t now_us) {
  std::lock_guard<std::mutex> lk(mu_);
  std::string out = "{";
  bool first = true;
  for (const auto& kv : stats_) {
    const TenantStat& s = *kv.second;
    if (!first) out += ",";
    first = false;
    const int64_t depth = s.queue_depth.load(std::memory_order_relaxed);
    const int64_t last = s.last_serve_us.load(std::memory_order_relaxed);
    // Starvation age: how long the tenant has had work queued without
    // being served. 0 when its lanes are empty (nothing owed) or it
    // was never served but also never queued.
    int64_t starve_us = 0;
    if (depth > 0) {
      starve_us = last > 0 ? now_us - last : now_us;
      if (starve_us < 0) starve_us = 0;
    }
    out += "\"" + std::to_string(kv.first) + "\":{";
    out += "\"push_bytes\":" +
           std::to_string(s.push_bytes.load(std::memory_order_relaxed));
    out += ",\"reply_bytes\":" +
           std::to_string(s.reply_bytes.load(std::memory_order_relaxed));
    out += ",\"ops\":" +
           std::to_string(s.ops.load(std::memory_order_relaxed));
    out += ",\"sum_us\":" +
           std::to_string(s.sum_us.load(std::memory_order_relaxed));
    out += ",\"queue_depth\":" + std::to_string(depth);
    out += ",\"dispatched\":" +
           std::to_string(s.dispatched.load(std::memory_order_relaxed));
    out += ",\"starve_us\":" + std::to_string(starve_us);
    out += "}";
  }
  out += "}";
  return out;
}

}  // namespace bps
