// Durable checkpoints (docs/checkpoint.md).
//
// Every failure class recovered so far is recovered from other
// processes' RAM; a correlated failure (power loss, OOM sweep, whole-box
// reboot) still loses every round ever trained. This layer persists the
// one artifact worth keeping — the SnapStore's committed, consistent,
// all-keys cut — to BYTEPS_CKPT_DIR so a relaunched fleet can resume
// from the last durable round instead of round zero.
//
// Durability argument (the whole design, in one paragraph): every file
// is written to a dot-tmp name, fsync'd, then atomically renamed into
// place; the per-version MANIFEST — carrying the key list, tenant ids,
// fleet shape, round watermark, per-chunk CRC32C and a sealing CRC over
// its own bytes — is written LAST. A crash at ANY byte therefore leaves
// either (a) a complete prior checkpoint, or (b) a candidate whose
// manifest is absent, torn (seal CRC mismatch) or pointing at chunks
// whose CRC32C no longer matches — all of which CkptScan detects and
// skips. A torn cut can never be installed, only rejected by name.
//
// Standalone by design (no topology; the writer owns its one thread) so
// the FFI probe (bps_ckpt_probe) can unit-test the spill / scan / load /
// torn-rejection matrix without a fleet.
#pragma once

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "crc32c.h"  // Crc32c — hoisted to the shared utility
#include "snapshot.h"

namespace bps {

// One key's restored value (CkptLoad output).
struct CkptItem {
  uint16_t tenant = 0;
  int64_t key = 0;
  int64_t version = -1;  // the entry's own version (== the cut version
                         // in lockstep training; <= it for idle keys)
  int32_t dtype = 0;
  std::vector<char> data;
};

// --- synchronous core (shared by the writer thread and the probe) -----------

// Persist one complete cut as checkpoint `version` for server shard
// `rank` under `dir`. `chaos` ("" / "truncate" / "bitflip" /
// "sealflip") is the torn-write injection the rejection tests drive
// (BYTEPS_CHAOS_CKPT): truncate/bitflip corrupt a seeded-random chunk
// AFTER its CRC was recorded and BEFORE the manifest seals the
// checkpoint; sealflip corrupts the sealed MANIFEST itself (intact
// chunks, broken seal). Returns false with a diagnostic in *why.
bool CkptSpillSync(const std::string& dir, int rank, int64_t version,
                   const std::vector<SnapDeltaEnt>& cut, int num_workers,
                   int num_servers, const std::string& chaos,
                   std::string* why);

// Newest FULLY-valid checkpoint version for `rank` under `dir` — the
// manifest must parse, its seal CRC must match, and every chunk must
// exist with its recorded length and CRC32C. -1 when none survive;
// every skipped candidate appends a named line to *why.
int64_t CkptScan(const std::string& dir, int rank, std::string* why);

// All fully-valid versions for `rank`, ascending (probe/introspection).
std::vector<int64_t> CkptList(const std::string& dir, int rank);

// Load exactly `version` (full CRC re-validation — scan-then-load is
// TOCTOU-proof by re-checking). False + diagnostic when the version is
// missing or any byte fails validation; the caller must treat that as
// fail-stop, never a silent cold start. *round gets the manifest's
// round watermark (== version).
bool CkptLoad(const std::string& dir, int rank, int64_t version,
              std::vector<CkptItem>* items, int64_t* round,
              std::string* why);

// Bounded retention mirroring the snapshot ring: keep the newest
// `retain` checkpoint directories for `rank`, delete the rest (and any
// stale dot-tmp debris from crashed spills).
void CkptRetain(const std::string& dir, int rank, int retain);

// --- async writer (server engine integration) --------------------------------

// Owns the spill thread, OFF the engine critical path: RoundReady only
// claims a due version (ShouldSpill), collects the cut's shared_ptr
// entries (no payload copy), and enqueues; fsyncs happen here.
class CkptWriter {
 public:
  ~CkptWriter() { Stop(); }

  // Idempotent; the server starts the writer lazily at the first due
  // spill (the shard rank is only known post-formation).
  void Start(const std::string& dir, int rank, int every, int retain,
             const std::string& chaos, int num_workers, int num_servers);
  void Stop();
  bool running() const { return running_.load(); }

  // Atomically claim `version` for spilling: true once per due version
  // (version % every == 0, newer than any prior claim). Engine threads
  // race this at round boundaries; CAS keeps exactly one winner.
  bool ShouldSpill(int64_t version);

  void Enqueue(int64_t version, std::vector<SnapDeltaEnt>&& cut);

  // Observability (bps_ckpt_* metrics + probe).
  int64_t last_spilled() const { return last_spilled_.load(); }
  int64_t spills() const { return spills_.load(); }
  int64_t failures() const { return failures_.load(); }
  int64_t last_spill_ms() const { return last_spill_ms_.load(); }

 private:
  void Loop();

  std::string dir_;
  std::string chaos_;
  int rank_ = 0;
  int every_ = 1;
  int retain_ = 2;
  int num_workers_ = 0;
  int num_servers_ = 0;

  std::atomic<bool> running_{false};
  std::atomic<bool> stop_{false};
  std::atomic<int64_t> claimed_{-1};       // highest version claimed
  std::atomic<int64_t> last_spilled_{-1};  // highest version sealed
  std::atomic<int64_t> spills_{0};
  std::atomic<int64_t> failures_{0};
  std::atomic<int64_t> last_spill_ms_{0};

  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<std::pair<int64_t, std::vector<SnapDeltaEnt>>> queue_;
  std::thread thread_;
};

}  // namespace bps
