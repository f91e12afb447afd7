#include "ckpt.h"

#include <dirent.h>
#include <fcntl.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

#include <algorithm>
#include <cerrno>
#include <cstdio>
#include <cstring>

#include "events.h"
#include "logging.h"
#include "metrics.h"
#include "worker.h"  // NowUs

namespace bps {

// CRC32C lives in crc32c.cc (shared with the van's wire trailer and
// snapshot serving verification); ckpt.h re-exports it.

// --- filesystem helpers ------------------------------------------------------

namespace {

constexpr const char* kManifest = "MANIFEST";

std::string CkptDirName(int64_t version, int rank) {
  char buf[64];
  snprintf(buf, sizeof(buf), "ckpt_v%lld_s%d",
           static_cast<long long>(version), rank);
  return buf;
}

std::string ChunkName(size_t idx) {
  char buf[32];
  snprintf(buf, sizeof(buf), "chunk_%zu.bin", idx);
  return buf;
}

bool FsyncPath(const std::string& path, std::string* why) {
  int fd = open(path.c_str(), O_RDONLY);
  if (fd < 0) {
    if (why) *why += "fsync open(" + path + "): " + strerror(errno) + "; ";
    return false;
  }
  const bool ok = fsync(fd) == 0;
  if (!ok && why) *why += "fsync(" + path + "): " + strerror(errno) + "; ";
  close(fd);
  return ok;
}

// tmp -> write -> fsync -> atomic rename. The rename is the commit
// point: a crash before it leaves only a dot-tmp file that scan ignores
// and retention sweeps.
bool WriteFileAtomic(const std::string& dir, const std::string& name,
                     const char* data, size_t len, std::string* why) {
  const std::string tmp = dir + "/." + name + ".tmp";
  const std::string fin = dir + "/" + name;
  int fd = open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) {
    if (why) *why += "open(" + tmp + "): " + strerror(errno) + "; ";
    return false;
  }
  size_t off = 0;
  while (off < len) {
    ssize_t n = write(fd, data + off, len - off);
    if (n < 0) {
      if (errno == EINTR) continue;
      if (why) *why += "write(" + tmp + "): " + strerror(errno) + "; ";
      close(fd);
      unlink(tmp.c_str());
      return false;
    }
    off += static_cast<size_t>(n);
  }
  if (fsync(fd) != 0) {
    if (why) *why += "fsync(" + tmp + "): " + strerror(errno) + "; ";
    close(fd);
    unlink(tmp.c_str());
    return false;
  }
  close(fd);
  if (rename(tmp.c_str(), fin.c_str()) != 0) {
    if (why) *why += "rename(" + tmp + "): " + strerror(errno) + "; ";
    unlink(tmp.c_str());
    return false;
  }
  return true;
}

bool ReadFileAll(const std::string& path, std::vector<char>* out) {
  int fd = open(path.c_str(), O_RDONLY);
  if (fd < 0) return false;
  out->clear();
  char buf[1 << 16];
  ssize_t n;
  while ((n = read(fd, buf, sizeof(buf))) > 0) {
    out->insert(out->end(), buf, buf + n);
  }
  close(fd);
  return n == 0;
}

void RemoveDirRecursive(const std::string& path) {
  DIR* d = opendir(path.c_str());
  if (d) {
    struct dirent* e;
    while ((e = readdir(d)) != nullptr) {
      if (strcmp(e->d_name, ".") == 0 || strcmp(e->d_name, "..") == 0) {
        continue;
      }
      unlink((path + "/" + e->d_name).c_str());
    }
    closedir(d);
  }
  rmdir(path.c_str());
}

// Parsed manifest: header fields + per-chunk records.
struct ManifestItem {
  size_t idx = 0;
  long long tenant = 0, key = 0, version = -1;
  int dtype = 0;
  long long len = 0;
  uint32_t crc = 0;
};

struct Manifest {
  int64_t version = -1;
  int rank = -1;
  int num_workers = 0, num_servers = 0;
  size_t items = 0;
  std::vector<ManifestItem> entries;
  uint32_t digest = 0;
};

// Parse + verify the seal CRC. The seal line covers every byte that
// precedes it, so a truncated, appended-to, or bit-flipped manifest is
// detectably torn before any field is believed.
bool ParseManifest(const std::vector<char>& raw, Manifest* m,
                   std::string* why) {
  const std::string text(raw.begin(), raw.end());
  const size_t seal_pos = text.rfind("\nseal ");
  if (seal_pos == std::string::npos) {
    if (why) *why += "manifest has no seal line (torn write?); ";
    return false;
  }
  unsigned long long seal = 0;
  if (sscanf(text.c_str() + seal_pos + 1, "seal %llx", &seal) != 1) {
    if (why) *why += "manifest seal line unparseable; ";
    return false;
  }
  // The sealed region includes the newline before the seal line.
  const uint32_t got = Crc32c(text.data(), seal_pos + 1);
  if (got != static_cast<uint32_t>(seal)) {
    char b[96];
    snprintf(b, sizeof(b),
             "manifest seal CRC mismatch (recorded %08llx, computed "
             "%08x); ", seal, got);
    if (why) *why += b;
    return false;
  }
  // Line-by-line fields.
  size_t pos = 0;
  bool saw_magic = false;
  while (pos < seal_pos) {
    size_t end = text.find('\n', pos);
    if (end == std::string::npos || end > seal_pos) end = seal_pos;
    const std::string line = text.substr(pos, end - pos);
    pos = end + 1;
    if (line.empty()) continue;
    long long a = 0, b2 = 0, c = 0, d = 0;
    int e = 0;
    long long f = 0;
    unsigned long long g = 0;
    if (line.rfind("bpsckpt ", 0) == 0) {
      saw_magic = line == "bpsckpt 1";
    } else if (sscanf(line.c_str(), "version %lld", &a) == 1) {
      m->version = a;
    } else if (sscanf(line.c_str(), "rank %lld", &a) == 1) {
      m->rank = static_cast<int>(a);
    } else if (sscanf(line.c_str(), "fleet %lld %lld", &a, &b2) == 2) {
      m->num_workers = static_cast<int>(a);
      m->num_servers = static_cast<int>(b2);
    } else if (sscanf(line.c_str(), "items %lld", &a) == 1) {
      m->items = static_cast<size_t>(a);
    } else if (sscanf(line.c_str(),
                      "item %lld %lld %lld %lld %d %lld %llx", &a, &b2,
                      &c, &d, &e, &f, &g) == 7) {
      ManifestItem it;
      it.idx = static_cast<size_t>(a);
      it.tenant = b2;
      it.key = c;
      it.version = d;
      it.dtype = e;
      it.len = f;
      it.crc = static_cast<uint32_t>(g);
      m->entries.push_back(it);
    } else if (sscanf(line.c_str(), "digest %llx", &g) == 1) {
      m->digest = static_cast<uint32_t>(g);
    } else {
      if (why) *why += "manifest line unrecognized: '" + line + "'; ";
      return false;
    }
  }
  if (!saw_magic) {
    if (why) *why += "manifest magic missing/unknown; ";
    return false;
  }
  if (m->entries.size() != m->items) {
    if (why) *why += "manifest item count mismatch; ";
    return false;
  }
  return true;
}

// Full validation of one checkpoint directory: sealed manifest + every
// chunk present with its recorded length and CRC32C.
bool ValidateCkpt(const std::string& path, int rank, int64_t version,
                  Manifest* m, std::string* why) {
  std::vector<char> raw;
  if (!ReadFileAll(path + "/" + kManifest, &raw)) {
    if (why) *why += path + ": manifest missing/unreadable; ";
    return false;
  }
  if (!ParseManifest(raw, m, why)) {
    if (why) *why += path + ": manifest invalid; ";
    return false;
  }
  if (m->version != version || m->rank != rank) {
    if (why) {
      *why += path + ": manifest names version " +
              std::to_string(static_cast<long long>(m->version)) +
              " rank " + std::to_string(m->rank) +
              " (directory says otherwise); ";
    }
    return false;
  }
  uint32_t digest = 0;
  std::vector<char> data;
  for (const auto& it : m->entries) {
    const std::string cpath = path + "/" + ChunkName(it.idx);
    if (!ReadFileAll(cpath, &data)) {
      if (why) *why += cpath + ": chunk missing/unreadable; ";
      return false;
    }
    if (static_cast<long long>(data.size()) != it.len) {
      if (why) {
        *why += cpath + ": chunk length " +
                std::to_string(data.size()) + " != recorded " +
                std::to_string(it.len) + " (truncated?); ";
      }
      return false;
    }
    const uint32_t crc = Crc32c(data.data(), data.size());
    if (crc != it.crc) {
      char b[96];
      snprintf(b, sizeof(b),
               ": chunk CRC32C mismatch (recorded %08x, computed "
               "%08x); ", it.crc, crc);
      if (why) *why += cpath + b;
      return false;
    }
    digest = Crc32c(&crc, sizeof(crc), digest);
  }
  if (digest != m->digest) {
    if (why) *why += path + ": checkpoint digest mismatch; ";
    return false;
  }
  return true;
}

// All on-disk candidate versions for `rank` (no validation), ascending.
std::vector<int64_t> CandidateVersions(const std::string& dir, int rank) {
  std::vector<int64_t> out;
  DIR* d = opendir(dir.c_str());
  if (!d) return out;
  struct dirent* e;
  while ((e = readdir(d)) != nullptr) {
    long long v = -1;
    int r = -1;
    if (sscanf(e->d_name, "ckpt_v%lld_s%d", &v, &r) == 2 && r == rank &&
        v >= 0) {
      out.push_back(v);
    }
  }
  closedir(d);
  std::sort(out.begin(), out.end());
  return out;
}

}  // namespace

// --- synchronous core --------------------------------------------------------

bool CkptSpillSync(const std::string& dir, int rank, int64_t version,
                   const std::vector<SnapDeltaEnt>& cut, int num_workers,
                   int num_servers, const std::string& chaos,
                   std::string* why) {
  mkdir(dir.c_str(), 0755);  // single level; EEXIST is the common case
  const std::string path = dir + "/" + CkptDirName(version, rank);
  // A directory from a crashed prior attempt (no valid manifest) is
  // debris: wipe and rewrite. Overwriting a SEALED checkpoint is
  // idempotent (same cut, same bytes), so no special case.
  RemoveDirRecursive(path);
  if (mkdir(path.c_str(), 0755) != 0) {
    if (why) *why += "mkdir(" + path + "): " + strerror(errno) + "; ";
    return false;
  }
  std::string manifest = "bpsckpt 1\n";
  manifest += "version " + std::to_string(static_cast<long long>(version)) +
              "\n";
  manifest += "rank " + std::to_string(rank) + "\n";
  manifest += "fleet " + std::to_string(num_workers) + " " +
              std::to_string(num_servers) + "\n";
  manifest += "items " + std::to_string(cut.size()) + "\n";
  uint32_t digest = 0;
  for (size_t i = 0; i < cut.size(); ++i) {
    const auto& d = cut[i];
    const auto& raw = *d.entry.raw;
    if (!WriteFileAtomic(path, ChunkName(i), raw.data(), raw.size(),
                         why)) {
      return false;
    }
    const uint32_t crc = Crc32c(raw.data(), raw.size());
    digest = Crc32c(&crc, sizeof(crc), digest);
    char line[160];
    snprintf(line, sizeof(line), "item %zu %lld %lld %lld %d %lld %08x\n",
             i, static_cast<long long>(d.tenant),
             static_cast<long long>(d.key),
             static_cast<long long>(d.entry.version), d.entry.dtype,
             static_cast<long long>(raw.size()), crc);
    manifest += line;
  }
  char dl[32];
  snprintf(dl, sizeof(dl), "digest %08x\n", digest);
  manifest += dl;
  // Chaos injection (BYTEPS_CHAOS_CKPT): corrupt a seeded-random chunk
  // AFTER its CRC was recorded and BEFORE the manifest seals the
  // checkpoint — the exact torn-write window a crash mid-spill exposes
  // (chunk 0 alone, the earlier target, would never exercise the
  // scan's per-chunk verification past the first item). Deterministic
  // per (seed, version) so probe tests can name the victim. Scan/load
  // must reject this checkpoint by name, never install it.
  if (!chaos.empty() && !cut.empty() && chaos != "sealflip") {
    uint64_t z = static_cast<uint64_t>(version) * 0x9E3779B97F4A7C15ull;
    if (const char* sv = getenv("BYTEPS_CHAOS_SEED")) {
      z += static_cast<uint64_t>(atoll(sv));
    }
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    const size_t victim = static_cast<size_t>((z ^ (z >> 31)) % cut.size());
    const std::string cv = path + "/" + ChunkName(victim);
    if (chaos == "truncate") {
      const long long half =
          static_cast<long long>(cut[victim].entry.raw->size()) / 2;
      if (truncate(cv.c_str(), half) != 0 && why) {
        *why += "chaos truncate failed: " + std::string(strerror(errno)) +
                "; ";
      }
    } else if (chaos == "bitflip") {
      int fd = open(cv.c_str(), O_RDWR);
      if (fd >= 0) {
        char b = 0;
        if (pread(fd, &b, 1, 0) == 1) {
          b ^= 0x01;
          (void)!pwrite(fd, &b, 1, 0);
          fsync(fd);
        }
        close(fd);
      }
    }
    BPS_LOG(WARNING) << "ckpt: CHAOS corrupted chunk " << victim
                     << " of version " << version << " (" << chaos
                     << ") pre-seal";
  }
  // The seal covers every manifest byte BEFORE the seal line itself
  // (ParseManifest recomputes over exactly that region).
  char sl[24];
  snprintf(sl, sizeof(sl), "seal %08x\n",
           Crc32c(manifest.data(), manifest.size()));
  manifest += sl;
  if (!WriteFileAtomic(path, kManifest, manifest.data(), manifest.size(),
                       why)) {
    return false;
  }
  // Chaos "sealflip": corrupt the sealed MANIFEST itself —
  // every chunk is intact, but the manifest's own integrity line no
  // longer matches its body. The restore scan must reject the version
  // on the seal check alone, before it ever reads a chunk.
  if (chaos == "sealflip") {
    const std::string mf = path + "/" + std::string(kManifest);
    int fd = open(mf.c_str(), O_RDWR);
    if (fd >= 0) {
      char b = 0;
      if (pread(fd, &b, 1, 0) == 1) {
        b ^= 0x01;
        (void)!pwrite(fd, &b, 1, 0);
        fsync(fd);
      }
      close(fd);
    }
    BPS_LOG(WARNING) << "ckpt: CHAOS corrupted the MANIFEST seal of "
                        "version " << version << " (sealflip)";
  }
  // Durability of the renames themselves: fsync the checkpoint dir and
  // its parent so the directory entries survive power loss too.
  FsyncPath(path, why);
  FsyncPath(dir, why);
  return true;
}

int64_t CkptScan(const std::string& dir, int rank, std::string* why) {
  const auto versions = CandidateVersions(dir, rank);
  for (auto it = versions.rbegin(); it != versions.rend(); ++it) {
    Manifest m;
    if (ValidateCkpt(dir + "/" + CkptDirName(*it, rank), rank, *it, &m,
                     why)) {
      return *it;
    }
    // Invalid candidate: the diagnostic is in *why; fall back to the
    // next-older version — a torn NEWEST checkpoint must never shadow
    // a complete prior one.
  }
  return -1;
}

std::vector<int64_t> CkptList(const std::string& dir, int rank) {
  std::vector<int64_t> out;
  for (int64_t v : CandidateVersions(dir, rank)) {
    Manifest m;
    std::string why;
    if (ValidateCkpt(dir + "/" + CkptDirName(v, rank), rank, v, &m,
                     &why)) {
      out.push_back(v);
    }
  }
  return out;
}

bool CkptLoad(const std::string& dir, int rank, int64_t version,
              std::vector<CkptItem>* items, int64_t* round,
              std::string* why) {
  const std::string path = dir + "/" + CkptDirName(version, rank);
  Manifest m;
  if (!ValidateCkpt(path, rank, version, &m, why)) return false;
  items->clear();
  items->reserve(m.entries.size());
  for (const auto& it : m.entries) {
    CkptItem out;
    out.tenant = static_cast<uint16_t>(it.tenant);
    out.key = it.key;
    out.version = it.version;
    out.dtype = it.dtype;
    if (!ReadFileAll(path + "/" + ChunkName(it.idx), &out.data) ||
        static_cast<long long>(out.data.size()) != it.len ||
        Crc32c(out.data.data(), out.data.size()) != it.crc) {
      // Validate-then-read raced a concurrent mutation (or the disk is
      // actively failing): same verdict as a torn checkpoint.
      if (why) {
        *why += path + "/" + ChunkName(it.idx) +
                ": re-read failed validation; ";
      }
      return false;
    }
    items->push_back(std::move(out));
  }
  if (round) *round = m.version;
  return true;
}

void CkptRetain(const std::string& dir, int rank, int retain) {
  if (retain < 1) retain = 1;
  const auto versions = CandidateVersions(dir, rank);
  if (static_cast<int>(versions.size()) > retain) {
    for (size_t i = 0; i + retain < versions.size(); ++i) {
      RemoveDirRecursive(dir + "/" + CkptDirName(versions[i], rank));
    }
  }
  // Dot-tmp debris from crashed spills (never referenced by any sealed
  // manifest) is swept alongside.
  DIR* d = opendir(dir.c_str());
  if (!d) return;
  struct dirent* e;
  while ((e = readdir(d)) != nullptr) {
    if (e->d_name[0] == '.' && strstr(e->d_name, ".tmp") != nullptr) {
      unlink((dir + "/" + e->d_name).c_str());
    }
  }
  closedir(d);
}

// --- async writer ------------------------------------------------------------

void CkptWriter::Start(const std::string& dir, int rank, int every,
                       int retain, const std::string& chaos,
                       int num_workers, int num_servers) {
  bool expect = false;
  if (!running_.compare_exchange_strong(expect, true)) return;
  dir_ = dir;
  rank_ = rank;
  every_ = every < 1 ? 1 : every;
  retain_ = retain < 1 ? 1 : retain;
  chaos_ = chaos;
  num_workers_ = num_workers;
  num_servers_ = num_servers;
  stop_.store(false);
  thread_ = std::thread([this] { Loop(); });
  BPS_LOG(INFO) << "ckpt: durable spill armed (dir " << dir_ << ", rank "
                << rank_ << ", every " << every_ << " version(s), retain "
                << retain_ << ")";
}

void CkptWriter::Stop() {
  if (!running_.load()) return;
  {
    std::lock_guard<std::mutex> lk(mu_);
    stop_.store(true);
  }
  cv_.notify_all();
  if (thread_.joinable()) thread_.join();
  running_.store(false);
}

bool CkptWriter::ShouldSpill(int64_t version) {
  if (!running_.load() || version < 0 || version % every_ != 0) {
    return false;
  }
  int64_t prev = claimed_.load();
  while (version > prev) {
    if (claimed_.compare_exchange_weak(prev, version)) return true;
  }
  return false;
}

void CkptWriter::Enqueue(int64_t version,
                         std::vector<SnapDeltaEnt>&& cut) {
  {
    std::lock_guard<std::mutex> lk(mu_);
    queue_.emplace_back(version, std::move(cut));
  }
  cv_.notify_one();
}

void CkptWriter::Loop() {
  while (true) {
    std::pair<int64_t, std::vector<SnapDeltaEnt>> job;
    {
      std::unique_lock<std::mutex> lk(mu_);
      cv_.wait(lk, [this] { return stop_.load() || !queue_.empty(); });
      // Drain what was enqueued before stop: a clean shutdown mid-queue
      // must not abandon a claimed version.
      if (queue_.empty()) return;
      job = std::move(queue_.front());
      queue_.pop_front();
    }
    const int64_t t0 = NowUs();
    Events::Get().Emit(EV_CKPT_SPILL, job.first,
                       static_cast<int64_t>(job.second.size()));
    std::string why;
    if (CkptSpillSync(dir_, rank_, job.first, job.second, num_workers_,
                      num_servers_, chaos_, &why)) {
      last_spilled_.store(job.first);
      spills_.fetch_add(1);
      const int64_t ms = (NowUs() - t0) / 1000;
      last_spill_ms_.store(ms);
      BPS_METRIC_GAUGE_SET("bps_ckpt_version", job.first);
      BPS_METRIC_COUNTER_ADD("bps_ckpt_spills_total", 1);
      BPS_METRIC_GAUGE_SET("bps_ckpt_spill_ms", ms);
      Events::Get().Emit(EV_CKPT_SEAL, job.first, ms, /*ok=*/1);
      CkptRetain(dir_, rank_, retain_);
    } else {
      failures_.fetch_add(1);
      BPS_METRIC_COUNTER_ADD("bps_ckpt_failures_total", 1);
      Events::Get().Emit(EV_CKPT_SEAL, job.first, 0, /*ok=*/0);
      BPS_LOG(WARNING) << "ckpt: spill of version " << job.first
                     << " FAILED: " << why;
    }
  }
}

}  // namespace bps
