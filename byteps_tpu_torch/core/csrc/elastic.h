// Elastic worker membership bookkeeping.
//
// Two small header-only pieces the server composes per key:
//
//  - RosterHistory: the fleet's per-epoch expected-contributor sets,
//    keyed by ACTIVATION ROUND. A join activates at `join_round` (the
//    max round counter any worker had issued when the fleet gated new
//    rounds), so rounds already in flight complete against the OLD
//    worker set while every round >= join_round expects the joiner too.
//    A removal (graceful leave or death shrink) applies to EVERY epoch:
//    a leaver drained before leaving (it is in no incomplete round) and
//    a dead worker's partial contributions are discarded by the rollback
//    — so after removal no incomplete round can legitimately expect the
//    departed id.
//
//  - ElasticSlot: one key-slot's contribution roster — which senders
//    pushed/pulled this round, and (until the round completes) a
//    retained copy of each sender's DECODED contribution so a death
//    shrink can discard the departed worker's partial sum and rebuild
//    the aggregate from the survivors' bytes exactly. Memory cost while
//    armed: up to (live workers) x key bytes per in-flight round per
//    key, freed the moment the round completes (SealPushes).
//
// Both are deliberately standalone (no server/postoffice dependency) so
// the epoch-roster and rollback arithmetic are unit-testable through
// the bps_elastic_probe FFI hook without standing up a fleet.
#pragma once

#include <algorithm>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <vector>

#include "cpu_reducer.h"

namespace bps {

// Per-epoch expected-contributor sets, looked up by round number.
// Thread-safe: the van thread mutates on membership changes, engine
// threads read per push/pull. Sets are shared_ptr-immutable so a read
// is one lock + one pointer copy.
class RosterHistory {
 public:
  using Roster = std::shared_ptr<const std::set<int>>;

  // Install the initial membership (activation round 0 for both the
  // push/pull round space and the broadcast round space).
  void Init(const std::set<int>& live) {
    std::lock_guard<std::mutex> lk(mu_);
    epochs_.clear();
    epochs_.push_back({0, 0, std::make_shared<const std::set<int>>(live)});
  }

  // A joiner enters at `join_round` / `bcast_round`: rounds at or past
  // the activation expect it, earlier in-flight rounds do not.
  void Join(int id, int64_t join_round, int64_t bcast_round) {
    std::lock_guard<std::mutex> lk(mu_);
    std::set<int> next(*Cur());
    next.insert(id);
    epochs_.push_back({join_round, bcast_round,
                       std::make_shared<const std::set<int>>(next)});
    // Bounded history: rounds older than the 8th-last activation are
    // long completed (the double-buffered slots retire rounds within
    // one parity cycle of the fleet's progress).
    while (epochs_.size() > 8) epochs_.erase(epochs_.begin());
  }

  // A removal applies to EVERY epoch (see the file comment): the
  // departed id is erased from all rosters, past and current.
  void Remove(int id) {
    std::lock_guard<std::mutex> lk(mu_);
    for (auto& e : epochs_) {
      if (!e.live->count(id)) continue;
      std::set<int> next(*e.live);
      next.erase(id);
      e.live = std::make_shared<const std::set<int>>(next);
    }
  }

  // Expected contributors for push/pull round `round`.
  Roster OfRound(int64_t round) const {
    std::lock_guard<std::mutex> lk(mu_);
    Roster out = epochs_.empty() ? EmptyRoster() : epochs_.front().live;
    for (const auto& e : epochs_) {
      if (e.act_round <= round) out = e.live;
    }
    return out;
  }

  // Expected participants for broadcast round `round` (broadcasts count
  // in their own round space; a join carries both activation points).
  Roster OfBcast(int64_t round) const {
    std::lock_guard<std::mutex> lk(mu_);
    Roster out = epochs_.empty() ? EmptyRoster() : epochs_.front().live;
    for (const auto& e : epochs_) {
      if (e.act_bcast <= round) out = e.live;
    }
    return out;
  }

  Roster Current() const {
    std::lock_guard<std::mutex> lk(mu_);
    return Cur();
  }

 private:
  struct Epoch {
    int64_t act_round;
    int64_t act_bcast;
    Roster live;
  };
  static Roster EmptyRoster() {
    static const Roster empty = std::make_shared<const std::set<int>>();
    return empty;
  }
  Roster Cur() const {
    return epochs_.empty() ? EmptyRoster() : epochs_.back().live;
  }
  mutable std::mutex mu_;
  std::vector<Epoch> epochs_;
};

// One key-slot's contribution roster. Touched only by the key's engine
// thread (the server's hash routing), so no internal locking.
class ElasticSlot {
 public:
  // Record an applied push: the sender joined the round's contributor
  // set, and its decoded bytes are retained until the round completes
  // (the rollback's rebuild source).
  void Push(int sender, const char* data, int64_t len) {
    pushers_.insert(sender);
    if (data) contribs_[sender].assign(data, data + len);
  }

  void Pull(int sender) { pullers_.insert(sender); }

  bool HasPusher(int sender) const { return pushers_.count(sender) > 0; }

  // The round is complete when its contributor set EQUALS the roster —
  // exact match, not superset: during a shrink the roster loses the
  // departed id before the rollback discards its contribution, and a
  // superset check would let a survivor's queued push complete the
  // round with the dead worker's bytes still in the sum.
  bool PushersMatch(const std::set<int>& roster) const {
    return pushers_ == roster;
  }

  // The round is fully served when every roster member pulled. COVER,
  // not match: a departed worker may legitimately have pulled before it
  // left, and its extra entry must not block the recycle.
  bool PullersCover(const std::set<int>& roster) const {
    return std::includes(pullers_.begin(), pullers_.end(),
                         roster.begin(), roster.end());
  }

  // Death shrink: discard the departed worker's partial contribution.
  // Returns true when it had one (the caller must then RebuildSum and
  // re-evaluate completion against the shrunk roster).
  bool Remove(int sender) {
    bool had = pushers_.erase(sender) > 0;
    contribs_.erase(sender);
    pullers_.erase(sender);
    return had;
  }

  // Re-sum the surviving contributions into `dst` (ascending sender id
  // — deterministic; exact for the integer-valued floats the elastic
  // acceptance pins, reorder-tolerant within float addition otherwise).
  // Returns false when there is nothing left (caller resets the slot).
  bool RebuildSum(char* dst, int64_t len, int32_t dtype) const {
    bool first = true;
    for (const auto& kv : contribs_) {
      if (static_cast<int64_t>(kv.second.size()) != len) continue;
      if (first) {
        memcpy(dst, kv.second.data(), len);
        first = false;
      } else {
        CpuReducer::Sum(dst, kv.second.data(), len, dtype);
      }
    }
    return !first;
  }

  // Round complete: drop the contribution copies (completed rounds are
  // never rolled back — they belong to the epoch they completed in).
  void SealPushes() { contribs_.clear(); }

  // Slot recycled for the next round of this parity.
  void Reset() {
    pushers_.clear();
    pullers_.clear();
    contribs_.clear();
  }

  int pusher_count() const { return static_cast<int>(pushers_.size()); }
  const std::set<int>& pushers() const { return pushers_; }
  const std::set<int>& pullers() const { return pullers_; }

 private:
  std::set<int> pushers_, pullers_;
  std::map<int, std::vector<char>> contribs_;  // sender -> decoded bytes
};

}  // namespace bps
