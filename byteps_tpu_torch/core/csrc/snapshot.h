// Round-versioned immutable snapshot store (docs/serving.md).
//
// At each round boundary the server engine publishes a consistent cut of
// every (tenant, key) aggregate under a monotone snapshot version. The
// store is the single source of truth for the read-serving path:
//
//  - Publication is copy-on-publish: the engine hands in the finished
//    float32 aggregate (plus the eagerly re-encoded BlockQuant serving
//    bytes for quant-eligible keys) and the store takes an immutable,
//    shared_ptr-owned copy. Engine-side KeyStore buffers are never
//    exposed to readers, so serving can never observe a torn mid-round
//    mix no matter how the engine recycles its slots.
//  - Versions map 1:1 to committed rounds. A version becomes `latest`
//    (committed) only once EVERY known key has published it — readers
//    asking for `latest` therefore always get a complete cut.
//  - Retention is a bounded per-key ring (BYTEPS_SNAPSHOT_RETAIN):
//    readers pinned to an evicted version get a clean EVICTED miss and
//    restart at the new latest, never stale bytes.
//
// Standalone by design (no topology, no threads of its own) so the FFI
// probe (bps_snap_probe) can unit-test version monotonicity, commit
// gating, and ring eviction without a fleet.
#pragma once

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <utility>
#include <vector>

#include "events.h"

namespace bps {

// Stale-reply guard for the server's per-slot cached re-encodes
// (comp_reply / qreply). A cached encode may be
// served ONLY when it is non-empty and its round tag matches the round
// the request is being answered for — a dedup-replayed or
// replica-forwarded pull must never ship a newer round's bytes under an
// older round's header. Centralised (and probe-tested via
// bps_snap_probe) so every serve site asserts the identical predicate.
inline bool CachedReplyValid(int64_t cached_round, int64_t serve_round,
                             bool nonempty) {
  return nonempty && cached_round >= 0 && cached_round == serve_round;
}

// One immutable published value. `raw` is always the float32 aggregate;
// `quant` is the BlockQuant serving encoding, null for quant-ineligible
// keys (tiny / non-float32) — the serve path falls back to raw then.
struct SnapEntry {
  int64_t version = -1;
  int32_t dtype = 0;
  std::shared_ptr<const std::vector<char>> raw;
  std::shared_ptr<const std::vector<char>> quant;
};

// One (tenant, key, entry) item of a replica delta batch.
struct SnapDeltaEnt {
  uint16_t tenant = 0;
  int64_t key = 0;
  SnapEntry entry;
};

class SnapStore {
 public:
  // CMD_SNAP_RESP arg0 miss codes (wire contract, docs/serving.md).
  enum Code : int {
    OK = 0,
    EVICTED = 1,        // version older than the retention ring holds
    NOT_COMMITTED = 2,  // version newer than the latest committed cut
    UNKNOWN_KEY = 3,
  };

  explicit SnapStore(int retain = 4) : retain_(std::max(1, retain)) {}

  void SetRetain(int retain) {
    std::lock_guard<std::mutex> lk(mu_);
    retain_ = std::max(1, retain);
    for (auto& kv : keys_) Trim(&kv.second);
  }

  int retain() const {
    std::lock_guard<std::mutex> lk(mu_);
    return retain_;
  }

  // Replica stores never self-commit: `latest` must advance ONLY via
  // ForceLatest (the primary's committed watermark, adopted after a
  // whole delta batch is installed). With per-publish commit counting a
  // replica's first batch would commit `latest` after its first key and
  // a concurrent reader could resolve a cut whose remaining keys are
  // still uninstalled — a spurious UNKNOWN_KEY on a fully-committed cut.
  void SetSelfCommit(bool on) {
    std::lock_guard<std::mutex> lk(mu_);
    self_commit_ = on;
  }

  // Install one (tenant, key) value under `version`. Re-publishing a
  // version the key already holds (a replayed replica delta, a deduped
  // re-seed) is an idempotent no-op; an OLDER version than the newest
  // held is rejected outright — snapshot history is append-only.
  // Returns true when the entry was installed.
  bool Publish(uint16_t tenant, int64_t key, int64_t version,
               int32_t dtype, const char* raw, size_t raw_len,
               const char* quant = nullptr, size_t quant_len = 0) {
    if (version < 0 || raw == nullptr) return false;
    SnapEntry e;
    e.version = version;
    e.dtype = dtype;
    e.raw = std::make_shared<const std::vector<char>>(raw, raw + raw_len);
    if (quant != nullptr && quant_len > 0) {
      e.quant = std::make_shared<const std::vector<char>>(
          quant, quant + quant_len);
    }
    std::lock_guard<std::mutex> lk(mu_);
    auto& ring = keys_[{tenant, key}];
    if (!ring.empty() && version <= ring.back().version) return false;
    ring.push_back(std::move(e));
    Trim(&ring);
    publishes_++;
    if (!self_commit_) return true;  // replica: ForceLatest only
    // Commit gating: `latest` advances to v only once every known key
    // has published v — the cut is complete by construction. A key set
    // that grows mid-round can stall one version's count; the next
    // full round supersedes it (latest is a running max).
    const int64_t pre_commit = latest_;
    size_t n = ++pub_count_[version];
    if (n >= keys_.size() && version > latest_) latest_ = version;
    // Lockstep commit: the sync engine publishes a key's round v only
    // after the workers waited every key's round v-1 (push_pull handles
    // are all waited each step), so the arrival of ANY publish at
    // version v proves every older pending version is complete. Without
    // this, a key that goes permanently idle after one round (a one-shot
    // broadcast) would stall the all-keys count above forever.
    for (const auto& pc : pub_count_) {
      if (pc.first < version && pc.first > latest_) latest_ = pc.first;
    }
    for (auto it = pub_count_.begin(); it != pub_count_.end();) {
      it = (it->first <= latest_) ? pub_count_.erase(it) : ++it;
    }
    if (latest_ > pre_commit) {
      // Journal the version-commit edge, not the per-key publishes: one
      // EV_SNAP_COMMIT per serving-visible version advance.
      Events::Get().Emit(EV_SNAP_COMMIT, latest_,
                         static_cast<int64_t>(keys_.size()));
    }
    return true;
  }

  // Replica path: adopt the primary's committed watermark directly (the
  // delta batch carries everything up to it). Monotone.
  void ForceLatest(int64_t version) {
    std::lock_guard<std::mutex> lk(mu_);
    if (version > latest_) {
      latest_ = version;
      Events::Get().Emit(EV_SNAP_COMMIT, latest_,
                         static_cast<int64_t>(keys_.size()),
                         /*adopted=*/1);
    }
  }

  int64_t latest() const {
    std::lock_guard<std::mutex> lk(mu_);
    return latest_;
  }

  // Resolve one read. version < 0 means `latest`. On OK, *out holds
  // shared ownership of the immutable entry and *resolved names the
  // exact version served (echoed in every CMD_SNAP_RESP header).
  Code Get(uint16_t tenant, int64_t key, int64_t version,
           SnapEntry* out, int64_t* resolved) const {
    std::lock_guard<std::mutex> lk(mu_);
    int64_t want = version < 0 ? latest_ : version;
    if (resolved) *resolved = want;
    if (want < 0 || want > latest_) return NOT_COMMITTED;
    auto it = keys_.find({tenant, key});
    if (it == keys_.end()) return UNKNOWN_KEY;
    const auto& ring = it->second;
    // Newest entry at-or-below the cut: in lockstep training every key
    // publishes every version, but a key idle for round v is still
    // consistently represented by its last value before v.
    for (auto rit = ring.rbegin(); rit != ring.rend(); ++rit) {
      if (rit->version <= want) {
        if (out) *out = *rit;
        return OK;
      }
    }
    return EVICTED;
  }

  // Replica delta support: every entry newer than `since`, whole
  // versions at a time in ascending order, until max_bytes of raw
  // payload is exceeded (always at least one version when any is
  // pending). *through = the highest version fully included, so the
  // caller can hand the replica an exact new watermark; capped at the
  // committed latest — uncommitted (partially published) versions
  // never leave the primary.
  std::vector<SnapDeltaEnt> CollectNewer(int64_t since, size_t max_bytes,
                                         int64_t* through) const {
    std::lock_guard<std::mutex> lk(mu_);
    std::map<int64_t, std::vector<SnapDeltaEnt>> by_version;
    for (const auto& kv : keys_) {
      for (const auto& e : kv.second) {
        if (e.version > since && e.version <= latest_) {
          by_version[e.version].push_back(
              {kv.first.first, kv.first.second, e});
        }
      }
    }
    std::vector<SnapDeltaEnt> out;
    int64_t thru = since;
    size_t bytes = 0;
    for (auto& vv : by_version) {
      size_t vbytes = 0;
      for (const auto& d : vv.second) vbytes += d.entry.raw->size();
      if (!out.empty() && bytes + vbytes > max_bytes) break;
      for (auto& d : vv.second) out.push_back(std::move(d));
      bytes += vbytes;
      thru = vv.first;
    }
    if (through) *through = thru;
    return out;
  }

  // Durable-checkpoint spill support: materialize the cut
  // Get(version) serves — the newest entry at-or-below `version` for
  // every known key — as one list for the checkpoint writer. Entries
  // share the store's immutable payload (shared_ptr, no copy), so
  // collecting on an engine thread costs pointer work only. *complete
  // reports whether EVERY known key contributed an entry: a key whose
  // ring no longer reaches back to `version` would make the cut torn,
  // and the writer must skip the spill rather than persist a partial
  // checkpoint. Called with a COMMITTED version, completeness holds by
  // the commit-gating construction.
  std::vector<SnapDeltaEnt> CollectCut(int64_t version,
                                       bool* complete) const {
    std::lock_guard<std::mutex> lk(mu_);
    std::vector<SnapDeltaEnt> out;
    bool all = true;
    for (const auto& kv : keys_) {
      const auto& ring = kv.second;
      bool found = false;
      for (auto rit = ring.rbegin(); rit != ring.rend(); ++rit) {
        if (rit->version <= version) {
          out.push_back({kv.first.first, kv.first.second, *rit});
          found = true;
          break;
        }
      }
      if (!found) all = false;
    }
    if (complete) *complete = all;
    return out;
  }

  size_t key_count() const {
    std::lock_guard<std::mutex> lk(mu_);
    return keys_.size();
  }

  int64_t publishes() const {
    std::lock_guard<std::mutex> lk(mu_);
    return publishes_;
  }

  int64_t evictions() const {
    std::lock_guard<std::mutex> lk(mu_);
    return evictions_;
  }

  // Oldest version still held for (tenant, key); -1 when unknown.
  int64_t OldestOf(uint16_t tenant, int64_t key) const {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = keys_.find({tenant, key});
    if (it == keys_.end() || it->second.empty()) return -1;
    return it->second.front().version;
  }

  void Clear() {
    std::lock_guard<std::mutex> lk(mu_);
    keys_.clear();
    pub_count_.clear();
    latest_ = -1;
    publishes_ = evictions_ = 0;
  }

 private:
  void Trim(std::deque<SnapEntry>* ring) {
    while (ring->size() > static_cast<size_t>(retain_)) {
      const int64_t ev = ring->front().version;
      ring->pop_front();
      evictions_++;
      // One journal entry per version falling out of the retain window
      // — NOT per (key, version): with K keys a round boundary evicts K
      // entries of the same version and would flood the event ring.
      if (ev > evict_emit_ver_) {
        evict_emit_ver_ = ev;
        Events::Get().Emit(EV_SNAP_EVICT, ev, evictions_);
      }
    }
  }

  mutable std::mutex mu_;
  int retain_;
  bool self_commit_ = true;  // false on replicas: ForceLatest only
  int64_t latest_ = -1;  // highest committed (complete-cut) version
  int64_t publishes_ = 0;
  int64_t evictions_ = 0;
  int64_t evict_emit_ver_ = -1;  // highest version already journaled
  std::map<std::pair<uint16_t, int64_t>, std::deque<SnapEntry>> keys_;
  std::map<int64_t, size_t> pub_count_;  // uncommitted versions only
};

}  // namespace bps
