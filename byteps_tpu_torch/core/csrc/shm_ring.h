// Shared-memory byte-ring transport segment for the van's intra-host data
// path.
//
// Capability parity: this is byteps_tpu's second van transport, playing the
// role the reference's non-TCP vans play (ps-lite ZMQVan's ipc:// transport
// and rdma_van.h's zero-copy path — SURVEY.md §2.4): co-located
// worker/server pairs should not pay the kernel TCP stack for every
// gradient byte. Fresh design, no ZMQ/verbs: one POSIX shm segment per
// connection holding two single-producer/single-consumer byte rings (one
// per direction), lock-free indices, Linux futex wakeups shared across
// processes. The existing framed-message format flows through unchanged —
// a frame is simply written into the ring instead of a socket — so
// PS_VERBOSE tracing, wire counters, and every upper layer are transport
// agnostic.
//
// Concurrency contract: exactly one producer thread per direction (the
// van's per-fd send mutex already serialises senders) and one consumer
// (the connection's shm recv thread). Indices are free-running uint32
// byte counts (ring capacity < 4 GB); `tail - head` is the unread span,
// valid across wraparound by unsigned arithmetic.
#pragma once

#include <linux/futex.h>
#include <sys/syscall.h>
#include <unistd.h>

#include <atomic>
#include <cstdint>
#include <cstring>

namespace bps {

inline void FutexWait(std::atomic<uint32_t>* addr, uint32_t expected) {
  // Bounded: re-checks closed/progress on expiry. The Dekker waiter
  // flags make wakes reliable, so this is pure insurance — short enough
  // that even a pathological missed wake costs single-digit ms, long
  // enough that an idle connection burns ~200 wakeups/s of pure kernel
  // time at most.
  timespec ts{0, 5 * 1000 * 1000};
  syscall(SYS_futex, reinterpret_cast<uint32_t*>(addr), FUTEX_WAIT,
          expected, &ts, nullptr, 0);
}

inline void FutexWake(std::atomic<uint32_t>* addr) {
  syscall(SYS_futex, reinterpret_cast<uint32_t*>(addr), FUTEX_WAKE,
          INT32_MAX, nullptr, nullptr, 0);
}

// One direction of the duplex connection. Cache-line separation keeps the
// producer's tail store from false-sharing the consumer's head.
struct alignas(64) ShmDir {
  std::atomic<uint32_t> tail{0};    // bytes published by the producer
  std::atomic<uint32_t> c_wait{0};  // consumer is in (or entering) FutexWait
  char pad0[56];
  std::atomic<uint32_t> head{0};    // bytes consumed by the consumer
  std::atomic<uint32_t> p_wait{0};  // producer is in (or entering) FutexWait
  char pad1[56];
  std::atomic<uint32_t> closed{0};  // either side tearing the conn down
  char pad2[60];
};

constexpr uint32_t kShmMagic = 0x62707331;  // "bps1"

struct ShmHeader {
  uint32_t magic;
  uint32_t ring_bytes;  // per-direction data capacity
  ShmDir dir[2];        // [0] connector->acceptor, [1] acceptor->connector
  // Data follows: dir[0]'s ring, then dir[1]'s ring.
};

inline char* ShmRingData(ShmHeader* h, int dir) {
  return reinterpret_cast<char*>(h + 1) +
         static_cast<size_t>(dir) * h->ring_bytes;
}

// Blocking stream write: copies `len` bytes into the ring, chunking at the
// wrap point and whenever the ring fills (so messages larger than the ring
// stream through it, like a socket buffer). Returns false if the
// connection closed mid-write.
inline bool ShmStreamWrite(ShmDir* d, char* ring, uint32_t cap,
                           const void* src, size_t len) {
  const char* p = static_cast<const char*>(src);
  uint32_t tail = d->tail.load(std::memory_order_relaxed);
  while (len > 0) {
    uint32_t head = d->head.load(std::memory_order_acquire);
    uint32_t free_b = cap - (tail - head);
    if (free_b == 0) {
      if (d->closed.load(std::memory_order_relaxed)) return false;
      // Brief spin (common case: consumer is actively draining), then a
      // bounded futex sleep on head. The p_wait flag publishes the
      // sleep intent with seq_cst so the consumer's wake check cannot
      // reorder past its head store (Dekker pattern).
      for (int i = 0; i < 4096 && d->head.load(std::memory_order_acquire)
                                      == head; ++i) {
      }
      if (d->head.load(std::memory_order_acquire) == head) {
        d->p_wait.store(1, std::memory_order_seq_cst);
        if (d->head.load(std::memory_order_seq_cst) == head)
          FutexWait(&d->head, head);
        d->p_wait.store(0, std::memory_order_relaxed);
      }
      continue;
    }
    uint32_t off = tail % cap;
    uint32_t chunk = free_b;
    if (chunk > cap - off) chunk = cap - off;  // contiguous to wrap point
    if (chunk > len) chunk = static_cast<uint32_t>(len);
    memcpy(ring + off, p, chunk);
    p += chunk;
    len -= chunk;
    // Wake only when the consumer could be waiting (it saw an empty
    // ring, or its c_wait flag is up): an unconditional wake per chunk
    // would put syscalls back on the hot path this transport removes.
    // seq_cst on the tail store vs the c_wait load pairs with the
    // consumer's Dekker sequence; the bounded FutexWait backstops it.
    bool was_empty = (tail == head);
    tail += chunk;
    d->tail.store(tail, std::memory_order_seq_cst);
    if (was_empty || d->c_wait.load(std::memory_order_seq_cst))
      FutexWake(&d->tail);
  }
  return true;
}

// Blocking stream read: fills `dst` with exactly `len` bytes. Returns
// false once the connection is closed AND the requested bytes are not
// fully available (a torn trailing frame at teardown is dropped — the
// connection is dying and the upper layer fails outstanding requests via
// the disconnect handler, same as a mid-frame TCP EOF).
inline bool ShmStreamRead(ShmDir* d, char* ring, uint32_t cap, void* dst,
                          size_t len) {
  char* p = static_cast<char*>(dst);
  uint32_t head = d->head.load(std::memory_order_relaxed);
  while (len > 0) {
    uint32_t tail = d->tail.load(std::memory_order_acquire);
    uint32_t avail = tail - head;
    if (avail == 0) {
      if (d->closed.load(std::memory_order_relaxed)) return false;
      for (int i = 0; i < 4096 && d->tail.load(std::memory_order_acquire)
                                      == tail; ++i) {
      }
      if (d->tail.load(std::memory_order_acquire) == tail) {
        d->c_wait.store(1, std::memory_order_seq_cst);
        if (d->tail.load(std::memory_order_seq_cst) == tail)
          FutexWait(&d->tail, tail);
        d->c_wait.store(0, std::memory_order_relaxed);
      }
      continue;
    }
    uint32_t off = head % cap;
    uint32_t chunk = avail;
    if (chunk > cap - off) chunk = cap - off;
    if (chunk > len) chunk = static_cast<uint32_t>(len);
    memcpy(p, ring + off, chunk);
    p += chunk;
    len -= chunk;
    // Mirror of the producer's conditional wake: the producer can only
    // be waiting when it observed a FULL ring or has p_wait up.
    bool was_full = (tail - head == cap);
    head += chunk;
    d->head.store(head, std::memory_order_seq_cst);
    if (was_full || d->p_wait.load(std::memory_order_seq_cst))
      FutexWake(&d->head);
  }
  return true;
}

// Mark both directions closed and wake any waiter (producer blocked on a
// full ring, consumer on an empty one). Idempotent; callable from either
// process.
inline void ShmCloseBoth(ShmHeader* h) {
  for (int i = 0; i < 2; ++i) {
    h->dir[i].closed.store(1, std::memory_order_release);
    FutexWake(&h->dir[i].tail);
    FutexWake(&h->dir[i].head);
  }
}

}  // namespace bps
