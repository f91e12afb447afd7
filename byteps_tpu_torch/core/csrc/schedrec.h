// Scheduler fail-over state reconstruction.
//
// A restarted scheduler owns NOTHING: the address book, membership
// epoch, rank-allocator high-water mark, tenant rosters, and heartbeat
// table all died with the old process. But every survivor holds the
// last COMMITTED copy of that state (its address book + its own
// NodeInfo + epoch), so the whole control plane is reconstructible from
// the fleet — the same insight hot server replacement applies
// to shard state, applied to the scheduler itself.
//
// SchedRecovery is the pure reconstruction arithmetic: it ingests one
// CMD_REREGISTER report per surviving node and answers
//
//  - quorum: has every non-scheduler id named by the HIGHEST-EPOCH book
//    reported? (The highest epoch's book is authoritative: a node that
//    missed the last elastic commit carries a stale, smaller book.)
//  - conflict: did two reporters claim the SAME epoch with DIFFERENT
//    books? That means the old scheduler died mid-commit and the fleet
//    is split-brained — the only safe answer is the clean fail-stop.
//  - adopted epoch / next worker rank / roster: the committed values a
//    successful recovery resumes the fleet with. Worker ranks are
//    allocated once and never reused, so the high-water mark must come
//    from the fleet too (max worker id seen across books and hints).
//  - heartbeat seeding: the restarted scheduler's heartbeat table is
//    EMPTY; checked raw on the first monitor tick it would declare every
//    rank dead at once. Seeding every roster id at commit time
//    guarantees no death can fire within one full timeout of RESUME.
//
// Deliberately standalone (no postoffice/van dependency) so the quorum
// / epoch-adoption / rank high-water / roster-rebuild / expiry
// arithmetic is unit-testable through the bps_sched_probe FFI hook
// without standing up (and killing) a fleet.
#pragma once

#include <cstdint>
#include <map>
#include <set>
#include <vector>

#include "common.h"

namespace bps {

class SchedRecovery {
 public:
  struct Report {
    NodeInfo self{};                // the reporter's own NodeInfo
    int64_t epoch = 0;              // its committed membership epoch
    int64_t rank_hint = 0;          // max worker id in its book
    int64_t rounds = 0;             // rounds-completed watermark
    std::vector<NodeInfo> book;     // its last committed address book
  };

  // Ingest one re-registration. Re-reports from the same id replace the
  // previous one (a parked node re-dials with backoff and may deliver
  // its REREGISTER more than once across chaos resets — idempotent).
  void Ingest(int id, Report r) { reports_[id] = std::move(r); }

  bool HasReport(int id) const { return reports_.count(id) > 0; }
  int Reregistered() const { return static_cast<int>(reports_.size()); }

  // Highest epoch any reporter committed (the epoch the recovery adopts).
  int64_t AdoptedEpoch() const {
    int64_t e = 0;
    for (const auto& kv : reports_) e = std::max(e, kv.second.epoch);
    return e;
  }

  // The authoritative roster: the non-scheduler ids named by the
  // highest-epoch book. Before any report arrives it is empty (expected
  // count 0 — the /healthz progress line reads 0/0 until the first
  // REREGISTER lands).
  std::set<int> ExpectedIds() const {
    std::set<int> out;
    const Report* best = Authoritative();
    if (!best) return out;
    for (const auto& n : best->book) {
      if (n.id != kSchedulerId) out.insert(n.id);
    }
    return out;
  }

  // Quorum = every expected id has reported. A sub-quorum window expiry
  // is the caller's clean fail-stop (Expired below).
  bool QuorumMet() const {
    const std::set<int> need = ExpectedIds();
    if (need.empty()) return false;
    for (int id : need) {
      if (!reports_.count(id)) return false;
    }
    return true;
  }

  // Split-brain detection: two reporters at the SAME epoch whose books
  // name different id sets. Differing epochs are fine (max-adoption
  // covers a node that missed the last commit); same-epoch disagreement
  // means the old scheduler died mid-broadcast and there is no single
  // committed state to resume from.
  bool Conflict() const {
    std::map<int64_t, std::set<int>> seen;  // epoch -> book id set
    for (const auto& kv : reports_) {
      std::set<int> ids;
      for (const auto& n : kv.second.book) ids.insert(n.id);
      auto it = seen.find(kv.second.epoch);
      if (it == seen.end()) {
        seen.emplace(kv.second.epoch, std::move(ids));
      } else if (it->second != ids) {
        return true;
      }
    }
    return false;
  }

  // Rank-allocator high-water mark: worker ranks are never reused, so
  // the next allocation must clear every worker id any survivor has
  // ever seen (its book) or hinted at (arg1 of its REREGISTER, which
  // carries the max even for ids that already left the book again).
  int NextWorkerId(int num_servers) const {
    int hw = num_servers;  // WorkerId(0) - 1 == num_servers
    for (const auto& kv : reports_) {
      hw = std::max(hw, static_cast<int>(kv.second.rank_hint));
      for (const auto& n : kv.second.book) {
        if (n.role == ROLE_WORKER) hw = std::max(hw, n.id);
      }
    }
    return hw + 1;
  }

  // The rebuilt address book: the highest-epoch reporter's book, with
  // each entry overridden by that node's OWN re-registration (a node is
  // authoritative about its own host/port/tenant/weight — it may have
  // respawned on a new port since the book was cut).
  std::vector<NodeInfo> RebuiltBook() const {
    std::vector<NodeInfo> out;
    const Report* best = Authoritative();
    if (!best) return out;
    for (NodeInfo n : best->book) {
      auto it = reports_.find(n.id);
      if (it != reports_.end()) n = it->second.self;
      out.push_back(n);
    }
    return out;
  }

  // Per-tenant rosters rebuilt from the book: tenant -> worker ids.
  std::map<int, std::set<int>> TenantRosters() const {
    std::map<int, std::set<int>> out;
    for (const auto& n : RebuiltBook()) {
      if (n.role == ROLE_WORKER) out[n.tenant].insert(n.id);
    }
    return out;
  }

  // Fleet-wide rounds-completed watermark (informational: logged at
  // commit and reported by the bench — the recovery itself never gates
  // on rounds, the data plane kept draining against the old book).
  int64_t RoundsWatermark() const {
    int64_t r = 0;
    for (const auto& kv : reports_) r = std::max(r, kv.second.rounds);
    return r;
  }

  // Heartbeat-table seed times (the bugfix satellite): every id the
  // rebuilt book names is seeded at `commit_ms`, so the earliest
  // possible death verdict is commit_ms + timeout — never the first
  // monitor tick after RESUME.
  std::map<int, int64_t> SeedHeartbeats(int64_t commit_ms) const {
    std::map<int, int64_t> out;
    for (const auto& n : RebuiltBook()) {
      if (n.id != kSchedulerId) out[n.id] = commit_ms;
    }
    return out;
  }

  // Earliest moment a seeded heartbeat table can declare any death.
  static int64_t EarliestDeathMs(int64_t commit_ms, int64_t timeout_ms) {
    return commit_ms + timeout_ms;
  }

  // Window expiry -> clean fail-stop (behavior strictly improves: the
  // old contract was an immediate fleet fail-stop; the new one only
  // defers it by at most the recovery window).
  static bool Expired(int64_t now_ms, int64_t start_ms,
                      int64_t window_ms) {
    return window_ms > 0 && now_ms - start_ms >= window_ms;
  }

 private:
  // Highest-epoch report; among equals the lowest id (deterministic —
  // Conflict() has already vouched their books agree).
  const Report* Authoritative() const {
    const Report* best = nullptr;
    for (const auto& kv : reports_) {
      if (!best || kv.second.epoch > best->epoch) best = &kv.second;
    }
    return best;
  }

  std::map<int, Report> reports_;  // reporter id -> latest report
};

}  // namespace bps
