// Multi-tenant parameter server: first-class tenant
// namespaces, per-tenant accounting, and weighted-fair QoS.
//
// A production PS fleet serves many concurrent training jobs. Before
// this layer, two jobs could only share a fleet by accident of the
// `{prefix}_{crc32}_{i}` tid hashing — colliding keys silently aliased
// one job's gradients into the other's, and a heavy job's pushes could
// starve a light job's engine queues. Now:
//
//  - every process carries a tenant id (BYTEPS_TENANT_ID, u16, 0 =
//    legacy/default) stamped into every MsgHeader/SubHeader it sends
//    (common.h carves the field out of bytes that were always zero, so
//    a tenant-0 frame is byte-for-byte the pre-tenant wire);
//  - the server's KeyStore map keys on TenantKey(tenant, key), so two
//    jobs with colliding tids can never alias;
//  - each server engine thread dispatches its queue through WeightedDrr
//    (classic deficit round robin, quantum scaled by the tenant's
//    BYTEPS_TENANT_WEIGHT) so a heavy tenant cannot starve a light one
//    — with a SINGLE active tenant the picker short-circuits to plain
//    FIFO, keeping single-tenant dispatch order byte-for-byte the pre-tenancy order;
//  - Tenancy (leaked singleton, like Metrics) accounts bytes / ops /
//    queue depth / sum time per tenant, surfaced as bps_tenant_*
//    series on /metrics, the /tenants monitor endpoint, and
//    monitor.top's tenant rows + starvation flag.
//
// WeightedDrr and TenantKey are deliberately standalone (no server /
// postoffice dependency) so the fair-share arithmetic and the (tenant,
// key) namespacing are unit-testable through the bps_tenant_probe FFI
// hook without standing up a fleet (modeled on bps_elastic_probe).
#pragma once

#include <atomic>
#include <cstdint>
#include <deque>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <vector>

namespace bps {

// --- process-wide tenant identity (env, static-cached) ----------------------

// BYTEPS_TENANT_ID, clamped to [0, 65535]. 0 = the legacy/default
// tenant: frames carry all-zero tenant bytes and every pre-tenant peer
// interops unchanged.
uint16_t TenantId();

// BYTEPS_TENANT_NAME; defaults to "default" for tenant 0 and
// "tenant<ID>" otherwise. Display-only — names never cross the wire.
const std::string& TenantName();

// BYTEPS_TENANT_WEIGHT, clamped to [1, 1 << 20]. The DRR quantum grant
// is weight x TenantQuantum(), so a weight-3 tenant drains 3x the bytes
// of a weight-1 tenant whenever both lanes are backlogged.
int TenantWeight();

// BYTEPS_TENANT_QUANTUM_BYTES (default 64 KiB): the base DRR quantum.
// Must comfortably exceed the largest single task cost divided by the
// smallest weight only for latency, not correctness — a lane's deficit
// accumulates across visits until its head fits.
int64_t TenantQuantum();

// --- (tenant, key) namespacing ----------------------------------------------

// Composite KeyStore key: the tenant id in bits 47..62 above the data
// key's 47 usable bits (worker keys are (tensor_id << 16) | part, far
// below 2^47; the sign bit stays clear). Tenant 0 composes to the key
// itself, so a legacy fleet's store keys — and therefore its engine
// thread routing `key % threads` — are bit-for-bit unchanged.
inline int64_t TenantKey(uint16_t tenant, int64_t key) {
  return key | (static_cast<int64_t>(tenant) << 47);
}

inline uint16_t TenantOfKey(int64_t tkey) {
  return static_cast<uint16_t>((tkey >> 47) & 0xffff);
}

inline int64_t BareKey(int64_t tkey) {
  return tkey & ((int64_t{1} << 47) - 1);
}

// --- weighted deficit-round-robin dispatch ----------------------------------

// Cost model: payload bytes plus a flat per-operation charge, so a
// tenant spamming byte-less pulls still pays its share of engine time.
constexpr int64_t kDrrOpCost = 1024;

inline int64_t DrrCost(int64_t payload_bytes) {
  return (payload_bytes > 0 ? payload_bytes : 0) + kDrrOpCost;
}

// Per-tenant FIFO lanes of item costs + the classic DRR picker. The
// server's EngineQueue mirrors it with a lane of EngineTasks per
// tenant: Enqueue/PickAndPop pairs run under the queue's mutex, so the
// two structures stay in lockstep by construction. Not internally
// locked (the caller owns the lock); the probe drives it single-
// threaded.
//
// Fairness: whenever two or more lanes stay backlogged, the bytes
// served per tenant converge to the ratio of their weights (each fresh
// visit grants weight x quantum deficit; serving costs the item's
// cost; an emptied lane forfeits its residue). FIFO within a lane, so
// per-(tenant, key) ordering is exactly the pre-tenant per-key
// ordering.
class WeightedDrr {
 public:
  using WeightFn = std::function<int(uint16_t)>;

  // weight_fn resolves a tenant's share at grant time (the server
  // passes an address-book lookup; the probe passes a local map).
  // Null = every tenant weight 1.
  explicit WeightedDrr(int64_t quantum = 0, WeightFn weight_fn = nullptr)
      : quantum_(quantum > 0 ? quantum : 64 * 1024),
        weight_fn_(std::move(weight_fn)) {}

  void Enqueue(uint16_t tenant, int64_t cost) {
    Lane& l = lanes_[tenant];
    if (l.costs.empty()) active_.push_back(tenant);
    l.costs.push_back(cost < 0 ? 0 : cost);
    ++total_;
  }

  bool Empty() const { return total_ == 0; }
  size_t Size() const { return total_; }
  size_t ActiveTenants() const { return active_.size(); }

  // The tenant whose head item is dispatched next; pops its cost.
  // Single active tenant = plain FIFO pop with no deficit bookkeeping:
  // a single-tenant fleet's dispatch order is byte-for-byte the
  // pre-tenant queue's.
  uint16_t PickAndPop(int64_t* cost_out = nullptr) {
    if (active_.size() == 1) {
      const uint16_t t = active_[0];
      Lane& l = lanes_[t];
      const int64_t c = l.costs.front();
      l.costs.pop_front();
      --total_;
      l.deficit = 0;
      if (l.costs.empty()) {
        active_.clear();
        rr_ = 0;
        grant_ = true;
      }
      if (cost_out) *cost_out = c;
      return t;
    }
    for (;;) {
      if (rr_ >= active_.size()) rr_ = 0;
      const uint16_t t = active_[rr_];
      Lane& l = lanes_[t];
      if (grant_) {
        l.deficit += quantum_ * WeightOf(t);
        grant_ = false;
      }
      const int64_t c = l.costs.front();
      if (c <= l.deficit) {
        l.deficit -= c;
        l.costs.pop_front();
        --total_;
        if (l.costs.empty()) {
          // Forfeit the residue (standard DRR: an idle lane must not
          // bank credit) and give the next lane a fresh grant.
          l.deficit = 0;
          active_.erase(active_.begin() + static_cast<long>(rr_));
          if (rr_ >= active_.size()) rr_ = 0;
          grant_ = true;
        }
        if (cost_out) *cost_out = c;
        return t;
      }
      // Head does not fit this visit: the deficit carries over and the
      // next lane gets its grant. Progress is guaranteed — each lap
      // adds weight x quantum >= quantum to this lane's deficit.
      rr_ = (rr_ + 1) % active_.size();
      grant_ = true;
    }
  }

 private:
  struct Lane {
    std::deque<int64_t> costs;
    int64_t deficit = 0;
  };

  int WeightOf(uint16_t t) const {
    if (!weight_fn_) return 1;
    const int w = weight_fn_(t);
    return w > 0 ? w : 1;
  }

  std::map<uint16_t, Lane> lanes_;
  std::vector<uint16_t> active_;  // round-robin order (arrival)
  size_t rr_ = 0;
  bool grant_ = true;  // the lane at rr_ is owed its visit grant
  int64_t quantum_;
  WeightFn weight_fn_;
  size_t total_ = 0;
};

// --- per-tenant accounting registry -----------------------------------------

// One tenant's cumulative accounting. Atomics: engine threads and van
// threads update concurrently; the snapshot reads relaxed.
struct TenantStat {
  std::atomic<int64_t> push_bytes{0};   // decoded-or-wire push payload in
  std::atomic<int64_t> reply_bytes{0};  // reply payload out
  std::atomic<int64_t> ops{0};          // data-plane operations seen
  std::atomic<int64_t> sum_us{0};       // engine decode+sum time
  std::atomic<int64_t> queue_depth{0};  // tasks waiting in engine lanes
  std::atomic<int64_t> dispatched{0};   // DRR cost served (bytes + op
                                        // charge — the fair-share meter)
  std::atomic<int64_t> last_serve_us{0};  // NowUs of the last dispatch
};

// Leaked singleton (the same lifetime rationale as Metrics): teardown
// paths still account, and snapshot pointers stay valid for the
// process lifetime.
class Tenancy {
 public:
  static Tenancy& Get();

  // Hot path (several calls per data frame, van + engine threads):
  // lock-free for tenants below 256 once registered — one relaxed
  // pointer load. Entries are never removed, so cached pointers stay
  // valid for the process lifetime (the Metrics registry contract).
  TenantStat* Of(uint16_t tenant) {
    if (tenant < kFastTenants) {
      TenantStat* s = fast_[tenant].load(std::memory_order_acquire);
      if (s) return s;
    }
    return OfSlow(tenant);
  }

  // Snapshot as a JSON object body: {"0":{...},"3":{...}} — the
  // /metrics tenants section and the /tenants endpoint both render it.
  // now_us timestamps the starvation age (now - last_serve_us while
  // queue_depth > 0; 0 otherwise).
  std::string SnapshotJson(int64_t now_us);

  // Tenants ever seen by this process (ids, ascending).
  std::vector<uint16_t> Known();

 private:
  static constexpr int kFastTenants = 256;

  TenantStat* OfSlow(uint16_t tenant);

  std::mutex mu_;  // registration + snapshot only
  std::map<uint16_t, std::unique_ptr<TenantStat>> stats_;
  std::atomic<TenantStat*> fast_[kFastTenants] = {};
};

}  // namespace bps
