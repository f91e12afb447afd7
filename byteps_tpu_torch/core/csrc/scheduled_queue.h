// Priority queue with credit-based admission.
//
// Capability parity: reference byteps/common/scheduled_queue.{h,cc}
// (BytePSScheduledQueue): partitions are admitted to the DCN push stage
// highest-priority-first (priority = negative declaration order, so
// front-of-model gradients go first — the next forward pass needs them
// first), with a credit cap on in-flight BYTES
// (BYTEPS_SCHEDULING_CREDIT, the reference's in-flight byte budget) so
// one huge tensor cannot monopolise the fabric. With mixed partition
// sizes (the tail slice of every tensor) a partition-count cap would
// admit wildly different byte volumes; counting bytes keeps the
// admitted window constant. addTask/getTask/reportFinish →
// Push/Pop/ReleaseCredit.
#pragma once

#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <vector>

namespace bps {

inline bool QueueDebug() {
  static const bool on = [] {
    const char* v = getenv("BYTEPS_QUEUE_DEBUG");
    return v && *v && *v != '0';
  }();
  return on;
}

// BYTEPS_SCHEDULING=fifo disables the priority order (pure enqueue
// order). Exists for A/B measurement of the scheduler's benefit
// (tools/bench_priority.py) and as an escape hatch; "priority" (default)
// is the reference behavior.
inline bool FifoScheduling() {
  static const bool fifo = [] {
    const char* v = getenv("BYTEPS_SCHEDULING");
    return v && strcmp(v, "fifo") == 0;
  }();
  return fifo;
}

struct Task {
  int priority = 0;       // higher = sooner
  int64_t seq = 0;        // FIFO tie-break within a priority level
  int64_t key = 0;
  int64_t bytes = 0;      // raw partition bytes charged against the budget
  // Small-tensor fusion (BYTEPS_FUSION_BYTES): tasks under the threshold
  // are fusible; the worker's PushLoop coalesces consecutive fusible
  // pops bound for the same server into one CMD_MULTI_PUSH frame.
  int server_id = -1;
  bool fusible = false;
  std::function<void()> run;
};

struct TaskOrder {
  bool operator()(const Task& a, const Task& b) const {
    if (!FifoScheduling() && a.priority != b.priority)
      return a.priority < b.priority;  // max-heap
    return a.seq > b.seq;  // earlier enqueue first
  }
};

class ScheduledQueue {
 public:
  explicit ScheduledQueue(int64_t budget_bytes) : budget_(budget_bytes) {}

  void Push(Task t) {
    std::lock_guard<std::mutex> lk(mu_);
    t.seq = seq_++;
    if (QueueDebug()) {
      fprintf(stderr, "[QDEBUG] push key=%lld bytes=%lld inflight=%lld "
              "pending=%zu\n", (long long)t.key, (long long)t.bytes,
              (long long)inflight_bytes_, heap_.size() + 1);
    }
    heap_.push(std::move(t));
    // notify_all: with BYTEPS_PUSH_THREADS > 1 several poppers wait on
    // cv_; a single notify can land on a popper whose predicate stays
    // false (budget exhausted) and be consumed without admitting work,
    // serialising the drain to one thread. Wakeups here are rare relative
    // to send work, so the spurious-wake cost is noise.
    cv_.notify_all();
  }

  // Blocks until the top task fits the byte budget (or Stop()). A task
  // larger than the whole budget is admitted alone — always-admit-one
  // keeps oversized partitions live instead of deadlocking.
  bool Pop(Task* out) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_.wait(lk, [this] {
      return stopped_ ||
             (!heap_.empty() &&
              (inflight_bytes_ == 0 ||
               inflight_bytes_ + heap_.top().bytes <= budget_));
    });
    if (stopped_) return false;
    *out = heap_.top();
    heap_.pop();
    inflight_bytes_ += out->bytes;
    if (QueueDebug()) {
      fprintf(stderr, "[QDEBUG] pop key=%lld bytes=%lld inflight=%lld "
              "pending=%zu\n", (long long)out->key, (long long)out->bytes,
              (long long)inflight_bytes_, heap_.size());
    }
    return true;
  }

  // Bounded-wait companion to Pop for the fusion collector: pops the
  // top task when it is fusible (any server — the byte-balanced
  // partition->server assignment interleaves servers at the queue head,
  // so the collector accumulates one batch per server concurrently) and
  // fits the credit budget. When the queue is EMPTY it waits up to
  // `wait_us` microseconds for a matching task to arrive — the flush
  // linger that lets a batch form while the (slower) enqueuing thread
  // is still pumping tasks in; pass 0 for a pure non-blocking attempt.
  // A NON-fusible task at the top returns false immediately: the
  // collector must flush rather than delay a full partition, and
  // popping only the heap top keeps the priority order intact — fusion
  // changes how partitions share frames, never which goes first.
  bool TryPopFusible(int64_t wait_us, Task* out) {
    std::unique_lock<std::mutex> lk(mu_);
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::microseconds(wait_us);
    for (;;) {
      if (stopped_) return false;
      if (!heap_.empty()) {
        const Task& top = heap_.top();
        if (!top.fusible) return false;
        if (inflight_bytes_ > 0 && inflight_bytes_ + top.bytes > budget_)
          return false;
        *out = heap_.top();
        heap_.pop();
        inflight_bytes_ += out->bytes;
        if (QueueDebug()) {
          fprintf(stderr, "[QDEBUG] pop(fuse) key=%lld bytes=%lld "
                  "inflight=%lld pending=%zu\n", (long long)out->key,
                  (long long)out->bytes, (long long)inflight_bytes_,
                  heap_.size());
        }
        return true;
      }
      if (wait_us <= 0 ||
          cv_.wait_until(lk, deadline) == std::cv_status::timeout) {
        if (heap_.empty()) return false;
      }
    }
  }

  // Called when a partition completes its pull (reference: reportFinish).
  void ReleaseCredit(int64_t bytes) {
    std::lock_guard<std::mutex> lk(mu_);
    inflight_bytes_ -= bytes;
    if (QueueDebug()) {
      fprintf(stderr, "[QDEBUG] release bytes=%lld inflight=%lld "
              "pending=%zu\n", (long long)bytes,
              (long long)inflight_bytes_, heap_.size());
    }
    // One release can free budget for MANY queued tasks; wake every
    // popper so they drain in parallel (see Push).
    cv_.notify_all();
  }

  void Stop() {
    std::lock_guard<std::mutex> lk(mu_);
    stopped_ = true;
    cv_.notify_all();
  }

  size_t pending() {
    std::lock_guard<std::mutex> lk(mu_);
    return heap_.size();
  }

  // Live occupancy for the monitor snapshot (bps_metrics_snapshot):
  // queue depth + credit window let an operator see whether the push
  // stage is admission-bound (inflight pinned at budget, deep queue) or
  // starved (both near zero).
  int64_t inflight_bytes() {
    std::lock_guard<std::mutex> lk(mu_);
    return inflight_bytes_;
  }
  int64_t budget_bytes() const { return budget_; }

 private:
  std::mutex mu_;
  std::condition_variable cv_;
  std::priority_queue<Task, std::vector<Task>, TaskOrder> heap_;
  int64_t budget_;
  int64_t inflight_bytes_ = 0;
  int64_t seq_ = 0;
  bool stopped_ = false;
};

}  // namespace bps
