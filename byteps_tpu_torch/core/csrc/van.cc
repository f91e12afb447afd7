#include "van.h"

#include <arpa/inet.h>
#include <fcntl.h>
#include <ifaddrs.h>
#include <linux/errqueue.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/uio.h>
#include <unistd.h>

#ifndef IP_RECVERR
#define IP_RECVERR 11
#endif

#include <cerrno>
#include <chrono>
#include <climits>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

#ifndef IOV_MAX
#define IOV_MAX 1024
#endif

#include "crc32c.h"
#include "events.h"
#include "logging.h"
#include "metrics.h"
#include "shm_ring.h"
#include "trace.h"

namespace bps {

// ps-lite parity: PS_VERBOSE=2 logs every message on the wire (1 is
// reserved for connection-level events, matching the reference's split).
static int VerboseLevel() {
  static const int v = [] {
    const char* e = getenv("PS_VERBOSE");
    return e ? atoi(e) : 0;
  }();
  return v;
}

static void LogMsg(const char* dir, int fd, const MsgHeader& h,
                   int64_t payload_len) {
  if (VerboseLevel() >= 2) {
    // Direct stderr: PS_VERBOSE must work standalone, independent of the
    // BYTEPS_LOG_LEVEL gate (ps-lite behaves the same way).
    fprintf(stderr, "[PS_VERBOSE] van %s fd=%d cmd=%d key=%lld ver=%d "
            "req=%d len=%lld\n", dir, fd, h.cmd,
            static_cast<long long>(h.key), h.version, h.req_id,
            static_cast<long long>(payload_len));
  }
}

// --- chaos injection (BYTEPS_CHAOS_*) ---------------------------------------
// Deterministic transient-fault injection on the send path, for the
// fault-tolerance test harness (docs/troubleshooting.md "failure
// model"). Applies ONLY to data-plane frames (IsDataPlaneCmd) by
// default: dropping control traffic would fake node deaths instead of
// exercising the in-band retry/reconnect machinery. BYTEPS_CHAOS_CTRL=1
// opts control-plane frames in too — there "faking" a
// scheduler-link loss is the point, and the park/re-register fail-over
// machinery is the recovery path under test (config.py refuses the
// knob unless scheduler recovery is armed). Zero overhead when off: one
// branch on a cached flag per send. All faults are injected under the
// per-fd send lock from a seeded per-connection PRNG, so a fixed seed
// gives a reproducible fault pattern per connection.
struct ChaosCfg {
  bool on = false;
  bool ctrl = false;       // also inject into control-plane frames
  uint64_t seed = 0;
  double drop = 0.0;       // P(frame silently not written)
  double dup = 0.0;        // P(frame written twice back-to-back)
  double corrupt = 0.0;    // P(one on-wire payload byte flipped AFTER the
                           // wire CRC was stamped — the bitflip
                           // window; config.py requires BYTEPS_WIRE_CRC
                           // so the flip is detected, not summed in)
  int64_t delay_us = 0;    // fixed extra latency per data frame
  int64_t reset_every = 0; // force a connection reset every N data frames
};

static const ChaosCfg& Chaos() {
  static const ChaosCfg cfg = [] {
    ChaosCfg c;
    auto envf = [](const char* n) {
      const char* v = getenv(n);
      return v && *v ? atof(v) : 0.0;
    };
    auto envll = [](const char* n) {
      const char* v = getenv(n);
      return v && *v ? atoll(v) : 0ll;
    };
    c.drop = envf("BYTEPS_CHAOS_DROP");
    c.dup = envf("BYTEPS_CHAOS_DUP");
    c.corrupt = envf("BYTEPS_CHAOS_CORRUPT");
    c.delay_us = envll("BYTEPS_CHAOS_DELAY_US");
    c.reset_every = envll("BYTEPS_CHAOS_RESET_EVERY");
    c.seed = static_cast<uint64_t>(envll("BYTEPS_CHAOS_SEED"));
    c.ctrl = envll("BYTEPS_CHAOS_CTRL") != 0;
    c.on = c.drop > 0 || c.dup > 0 || c.corrupt > 0 || c.delay_us > 0 ||
           c.reset_every > 0;
    return c;
  }();
  return cfg;
}

// splitmix64 step: uniform in [0,1). Good enough for fault dice; cheap
// and dependency-free.
static double ChaosRand(uint64_t* state) {
  uint64_t z = (*state += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  z ^= z >> 31;
  return static_cast<double>(z >> 11) * (1.0 / 9007199254740992.0);
}

// --- wire-CRC frame integrity (BYTEPS_WIRE_CRC) -------------------
// When armed, every data-plane frame carries a 4-byte little-endian
// CRC32C trailer (see FLAG_WIRE_CRC in common.h for the exact layout
// contract). Off by default and byte-for-byte the pre-CRC wire when off:
// no trailer, no flag, zero per-send cost beyond one cached-bool branch.
static bool WireCrcEnabled() {
  static const bool on = [] {
    const char* v = getenv("BYTEPS_WIRE_CRC");
    return v && *v && *v != '0';
  }();
  return on;
}

// Quarantine threshold: CRC failures tolerated per window per connection
// before the van force-closes it so the reconnect ladder re-dials a
// fresh socket (flaky-link quarantine). 0 = count/trace only.
static int64_t WireCrcQuarantine() {
  static const int64_t n = [] {
    const char* v = getenv("BYTEPS_WIRE_CRC_QUARANTINE");
    return v && *v ? atoll(v) : 0ll;
  }();
  return n;
}

static int64_t WireCrcWindowUs() {
  static const int64_t us = [] {
    const char* v = getenv("BYTEPS_WIRE_CRC_WINDOW_MS");
    return (v && *v ? atoll(v) : 10000ll) * 1000;
  }();
  return us;
}

static int64_t RxNowUs() {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// Size data-connection socket buffers for high-bandwidth-delay links
// (DCN between TPU pods and PS racks): the kernel default (~200 KB) caps
// a 100 Gbit/s x 1 ms path at ~1.6 Gbit/s per connection. Tunable via
// BYTEPS_SOCKET_BUF bytes; 0 keeps the kernel default.
//
// BYTEPS_PACING_RATE (bytes/sec per connection, 0 = off) engages the
// kernel's TCP internal pacing (SO_MAX_PACING_RATE) on every data
// connection. Production use: keep a many-stripe van from bursting past
// a shared NIC's fair share. Benchmark use: emulate a DCN-shaped link on
// loopback with ZERO userspace relay cost — the scaling/overlap benches
// set it so fleet goodput is link-bound, not host-bound (verified: a
// 12.5 MB/s cap measures 12.6 MB/s on this kernel's loopback).
static void SizeSocketBuffers(int fd) {
  static const int kBuf = [] {
    const char* v = getenv("BYTEPS_SOCKET_BUF");
    return v ? atoi(v) : 8 << 20;
  }();
  if (kBuf > 0) {
    setsockopt(fd, SOL_SOCKET, SO_SNDBUF, &kBuf, sizeof(kBuf));
    setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &kBuf, sizeof(kBuf));
  }
  static const uint64_t kPace = [] {
    const char* v = getenv("BYTEPS_PACING_RATE");
    return v ? static_cast<uint64_t>(atoll(v)) : 0ull;
  }();
  if (kPace > 0) {
#ifdef SO_MAX_PACING_RATE
    // The kernel reads an unsigned 32-bit (or 64-bit on newer kernels)
    // rate; pass 32-bit for widest compatibility, saturating at 4 GB/s
    // (far above any rate worth pacing to).
    uint32_t rate = kPace > 0xFFFFFFFFull
                        ? 0xFFFFFFFFu
                        : static_cast<uint32_t>(kPace);
    setsockopt(fd, SOL_SOCKET, SO_MAX_PACING_RATE, &rate, sizeof(rate));
#endif
  }
}

// --- MSG_ZEROCOPY send path (BYTEPS_VAN_ZEROCOPY=1) -------------------------
// The RDMA-parity experiment (SURVEY §2.4 rdma_van.h: kernel-bypass
// zero-copy sends). Linux MSG_ZEROCOPY pins the payload pages instead of
// copying them into kernel memory; completion arrives asynchronously on
// the socket error queue. This implementation is SYNCHRONOUS: Send()
// reaps the completion before returning, so caller buffer-lifetime
// semantics are identical to the copying path (the payload may be reused
// the moment Send returns). That costs one errqueue round trip per large
// send — acceptable for an A/B experiment, and the per-fd send lock
// already serialises same-connection sends. Measured verdict lives in
// BENCH_zerocopy_r05.json / docs/best-practice.md: on loopback the
// kernel COPIES anyway (SO_EE_CODE_ZEROCOPY_COPIED) and the notification
// machinery is pure overhead; the path where it pays is a real NIC at
// >=10 Gbit/s with >=1 MB partitions.
#ifndef SO_ZEROCOPY
#define SO_ZEROCOPY 60
#endif
#ifndef SO_EE_ORIGIN_ZEROCOPY
#define SO_EE_ORIGIN_ZEROCOPY 5
#endif
#ifndef MSG_ZEROCOPY
#define MSG_ZEROCOPY 0x4000000
#endif

static bool ZerocopyEnabled() {
  static const bool on = [] {
    const char* v = getenv("BYTEPS_VAN_ZEROCOPY");
    return v && *v && *v != '0';
  }();
  return on;
}

// Minimum payload for the zerocopy path: page pinning has fixed cost, so
// small sends always copy (the kernel's own guidance is ~10 KB; we gate
// far above it since only partition payloads matter here).
static constexpr int64_t kZerocopyMin = 1 << 20;

// Reap errqueue notifications until the zerocopy send numbered `seq` on
// this fd is acknowledged. Sends are serialised per fd, so completions
// arrive in order; `reaped` tracks the highest acked sequence. TCP
// completions arrive only once the peer ACKs the pinned pages, so on a
// slow (e.g. paced) link a completion can legitimately take arbitrarily
// long: there is NO fixed deadline here — the loop polls in short ticks
// and exits on van stop or connection death (shutdown/close surfaces as
// POLLERR/POLLHUP -> recvmsg error below).
static bool ReapZerocopy(int fd, uint32_t seq, uint32_t* reaped,
                         const std::atomic<bool>& stop) {
  while (static_cast<int32_t>(*reaped - seq) < 0) {
    pollfd pfd{fd, 0, 0};  // errqueue events surface as POLLERR
    int pr = ::poll(&pfd, 1, 500);
    if (pr < 0 && errno != EINTR) return false;
    if (pr <= 0) {
      if (stop.load()) return false;
      continue;  // completion still in flight (slow link) — keep waiting
    }
    char ctrl[128];
    msghdr mh{};
    mh.msg_control = ctrl;
    mh.msg_controllen = sizeof(ctrl);
    ssize_t r = ::recvmsg(fd, &mh, MSG_ERRQUEUE);
    if (r < 0) {
      if (errno == EINTR) continue;
      if (errno == EAGAIN) {
        // POLLERR with an EMPTY errqueue: the error is on the socket
        // itself (peer reset), not a zerocopy completion. Without these
        // checks the loop spins at 100% CPU — poll returns instantly on
        // the standing POLLERR, recvmsg keeps yielding EAGAIN — while
        // holding the per-fd send lock, so even Van::Stop can't break in.
        if (stop.load()) return false;
        int soerr = 0;
        socklen_t slen = sizeof(soerr);
        if (getsockopt(fd, SOL_SOCKET, SO_ERROR, &soerr, &slen) == 0 &&
            soerr != 0) {
          return false;  // dead connection; completion will never come
        }
        continue;
      }
      return false;
    }
    for (cmsghdr* c = CMSG_FIRSTHDR(&mh); c; c = CMSG_NXTHDR(&mh, c)) {
      // The van dials AF_INET only, so completions arrive as
      // SOL_IP/IP_RECVERR; an IPv6 van would need SOL_IPV6/IPV6_RECVERR
      // (25) handling here.
      if (c->cmsg_level == SOL_IP && c->cmsg_type == IP_RECVERR) {
        auto* ee = reinterpret_cast<sock_extended_err*>(CMSG_DATA(c));
        if (ee->ee_origin == SO_EE_ORIGIN_ZEROCOPY) {
          *reaped = ee->ee_data;  // range [ee_info, ee_data] completed
        }
      }
    }
  }
  return true;
}

// --- shared-memory data path (BYTEPS_VAN_TYPE=shm) --------------------------

struct Van::ShmConn {
  ShmHeader* hdr = nullptr;
  size_t map_len = 0;
  ShmDir* out = nullptr;  // direction this process produces into
  ShmDir* in = nullptr;   // direction this process consumes from
  char* out_ring = nullptr;
  char* in_ring = nullptr;
  uint32_t cap = 0;
  // Connector side keeps the segment name: normally the acceptor
  // shm_unlinks right after mapping, but if it dies (or its attach
  // fails) before that, the named segment would outlive both processes
  // — tmpfs memory leaked host-wide. A second unlink is ENOENT, so the
  // connector unlinking again at teardown is always safe.
  std::string name;
  // The fd number has TWO standing user threads on an shm connection —
  // the idle TCP recv thread (EOF watch) and the shm recv thread (which
  // passes fd to handlers that may reply on it) — plus, on the connector
  // side only, a third transient user: the OfferShm thread while its
  // hello send is in flight (set at registration). ::close only when the
  // LAST user is done — closing while any user still touches the fd
  // would let the kernel reuse the number for a fresh accept and route
  // stale writes to an unrelated peer (the fd-reuse race CloseConn's
  // contract exists to prevent).
  std::atomic<int> fd_users{2};

  ~ShmConn() {
    if (hdr) munmap(hdr, map_len);
    if (!name.empty()) shm_unlink(name.c_str());
  }
};

static bool ShmEnabled() {
  static const bool on = [] {
    const char* v = getenv("BYTEPS_VAN_TYPE");
    return v && strcmp(v, "shm") == 0;
  }();
  return on;
}

static uint32_t ShmRingBytes() {
  static const uint32_t n = [] {
    const char* v = getenv("BYTEPS_SHM_RING_BYTES");
    long b = v ? atol(v) : 4 << 20;  // one 4 MB partition per direction;
                                     // larger frames stream through
    if (b < 1 << 16) b = 1 << 16;
    if (b > 1 << 30) b = 1 << 30;
    // Round up to a power of two: the ring's free-running uint32 indices
    // are correct across counter wraparound only when the capacity
    // divides 2^32 (offset = index mod cap must stay continuous as the
    // index wraps).
    uint32_t cap = 1u << 16;
    while (cap < static_cast<uint32_t>(b)) cap <<= 1;
    return cap;
  }();
  return n;
}

// The shm path only makes sense when the peer shares this host's memory.
// Decided on the RESOLVED dial address: anything in 127/8 plus any
// address bound to a local interface — so a co-located worker/server
// pair that advertises its reachable address (DMLC_NODE_HOST=10.0.0.5
// in a mixed fleet) still gets the ring, and remote peers keep TCP with
// no configuration.
static bool IsLocalAddr(const sockaddr* sa) {
  static const std::vector<uint32_t> locals = [] {
    std::vector<uint32_t> v;
    ifaddrs* ifa = nullptr;
    if (getifaddrs(&ifa) == 0) {
      for (ifaddrs* p = ifa; p; p = p->ifa_next) {
        if (p->ifa_addr && p->ifa_addr->sa_family == AF_INET)
          v.push_back(reinterpret_cast<sockaddr_in*>(p->ifa_addr)
                          ->sin_addr.s_addr);
      }
      freeifaddrs(ifa);
    }
    return v;
  }();
  if (sa->sa_family != AF_INET) return false;
  uint32_t a = reinterpret_cast<const sockaddr_in*>(sa)->sin_addr.s_addr;
  if ((ntohl(a) >> 24) == 127) return true;  // whole loopback block
  for (uint32_t l : locals) {
    if (l == a) return true;
  }
  return false;
}

static bool SendAll(int fd, const void* buf, size_t len) {
  const char* p = static_cast<const char*>(buf);
  while (len > 0) {
    ssize_t n = ::send(fd, p, len, MSG_NOSIGNAL);
    if (n < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    p += n;
    len -= n;
  }
  return true;
}

static bool RecvAll(int fd, void* buf, size_t len) {
  char* p = static_cast<char*>(buf);
  while (len > 0) {
    ssize_t n = ::recv(fd, p, len, 0);
    if (n == 0) return false;  // peer closed
    if (n < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    p += n;
    len -= n;
  }
  return true;
}

int Van::Listen(int port) {
  int lfd = ::socket(AF_INET, SOCK_STREAM, 0);
  BPS_CHECK_GE(lfd, 0) << "socket() failed: " << strerror(errno);
  int one = 1;
  setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = INADDR_ANY;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  BPS_CHECK_EQ(::bind(lfd, reinterpret_cast<sockaddr*>(&addr),
                      sizeof(addr)), 0)
      << "bind(" << port << ") failed: " << strerror(errno);
  BPS_CHECK_EQ(::listen(lfd, 128), 0)
      << "listen failed: " << strerror(errno);
  socklen_t alen = sizeof(addr);
  getsockname(lfd, reinterpret_cast<sockaddr*>(&addr), &alen);
  listen_fd_.store(lfd);
  int bound = ntohs(addr.sin_port);
  {
    std::lock_guard<std::mutex> lk(mu_);
    threads_.emplace_back([this] { AcceptLoop(); });
  }
  BPS_LOG(DEBUG) << "van listening on port " << bound;
  return bound;
}

int Van::Connect(const std::string& host, int port, int max_attempts) {
  addrinfo hints{}, *res = nullptr;
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  std::string port_s = std::to_string(port);
  // Retry: the peer may not have bound its listener yet (startup races are
  // normal — the reference's ps-lite retries its scheduler dial the same way).
  for (int attempt = 0; attempt < max_attempts; ++attempt) {
    if (attempt > 0) usleep(100 * 1000);
    if (stop_.load()) break;
    if (getaddrinfo(host.c_str(), port_s.c_str(), &hints, &res) != 0) {
      continue;
    }
    int fd = ::socket(res->ai_family, res->ai_socktype, res->ai_protocol);
    if (fd >= 0 && ::connect(fd, res->ai_addr, res->ai_addrlen) == 0) {
      bool same_host = ShmEnabled() && IsLocalAddr(res->ai_addr);
      freeaddrinfo(res);
      int one = 1;
      setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      SizeSocketBuffers(fd);
      // send_mu_ entry + TCP recv thread first: the shm recv loop may
      // dispatch a handler that replies on this fd immediately.
      auto smu = StartRecvThread(fd);
      if (same_host) OfferShm(fd, smu);
      return fd;
    }
    if (fd >= 0) ::close(fd);
    freeaddrinfo(res);
    res = nullptr;
  }
  BPS_LOG(WARNING) << "van connect to " << host << ":" << port
                   << " failed after " << max_attempts << " attempt(s)";
  return -1;
}

bool Van::Send(int fd, const MsgHeader& head, const void* payload,
               int64_t payload_len) {
  iovec one;
  one.iov_base = const_cast<void*>(payload);
  one.iov_len = static_cast<size_t>(payload_len > 0 ? payload_len : 0);
  return SendV(fd, head, &one, payload_len > 0 ? 1 : 0);
}

bool Van::SendV(int fd, const MsgHeader& head, const struct iovec* segs,
                int nsegs) {
  int64_t payload_len = 0;
  for (int i = 0; i < nsegs; ++i) {
    payload_len += static_cast<int64_t>(segs[i].iov_len);
  }
  MsgHeader h = head;
  h.payload_len = payload_len;
  uint64_t total = sizeof(MsgHeader) + static_cast<uint64_t>(payload_len);
  std::shared_ptr<std::mutex> smu;
  std::shared_ptr<ShmConn> shm;
  std::shared_ptr<ZcState> zcs;
  std::shared_ptr<TxState> tx;
  {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = send_mu_.find(fd);
    if (it == send_mu_.end()) return false;
    smu = it->second;
    auto sit = shm_conns_.find(fd);
    if (sit != shm_conns_.end()) shm = sit->second;
    auto zit = zc_.find(fd);
    if (zit != zc_.end()) zcs = zit->second;
    auto tit = tx_.find(fd);
    if (tit != tx_.end()) tx = tit->second;
  }
  std::lock_guard<std::mutex> lk(*smu);
  // Per-connection monotone frame sequence, stamped under the per-fd
  // send lock (so seq order == wire order). A chaos-duplicated frame
  // carries the SAME seq — it is the same frame delivered twice.
  if (tx) h.seq = ++tx->seq;
  // Wire-CRC trailer (data-plane frames only; control traffic keeps the
  // bare wire so CRC-on fleets interoperate frame-layout-wise with the
  // handshake path). Stamped AFTER the seq so the CRC covers the final
  // header exactly as it hits the wire. The trailer rides as one extra
  // iovec segment: payload bytes stay zero-copy.
  uint32_t crc_trailer = 0;
  std::vector<iovec> crc_segs;
  if (WireCrcEnabled() && IsDataPlaneCmd(h.cmd)) {
    h.flags |= FLAG_WIRE_CRC;
    h.payload_len = payload_len + 4;
    total += 4;
    uint32_t c = Crc32c(&h, sizeof(h));
    for (int i = 0; i < nsegs; ++i) {
      if (segs[i].iov_len) c = Crc32c(segs[i].iov_base, segs[i].iov_len, c);
    }
    crc_trailer = c;
    crc_segs.assign(segs, segs + nsegs);
    iovec t;
    t.iov_base = &crc_trailer;
    t.iov_len = sizeof(crc_trailer);
    crc_segs.push_back(t);
    segs = crc_segs.data();
    nsegs = static_cast<int>(crc_segs.size());
    payload_len += 4;
  }
  // Chaos injection point (data-plane frames, plus control-plane with
  // BYTEPS_CHAOS_CTRL=1; see Chaos()).
  int sends = 1;
  std::vector<char> corrupt_scratch;
  iovec corrupt_seg;
  if (tx && Chaos().on && (IsDataPlaneCmd(h.cmd) || Chaos().ctrl)) {
    const ChaosCfg& c = Chaos();
    ++tx->data_frames;
    if (c.reset_every > 0 && tx->data_frames % c.reset_every == 0) {
      // Forced connection reset: kill the socket mid-protocol. The
      // local recv thread wakes with EOF -> disconnect handler ->
      // reconnect-with-backoff; this send reports failure like any
      // send into a dead connection (the retry layer re-issues it).
      BPS_METRIC_COUNTER_ADD("bps_chaos_injected_total", 1);
      BPS_METRIC_COUNTER_ADD("bps_chaos_reset_total", 1);
      Trace::Get().Note("CHAOS_RESET", h.key, -1, h.req_id);
      Events::Get().Emit(EV_CHAOS, /*kind=*/0, h.key);
      if (VerboseLevel() >= 2) {
        fprintf(stderr, "[PS_VERBOSE] van CHAOS reset fd=%d\n", fd);
      }
      ::shutdown(fd, SHUT_RDWR);
      return false;
    }
    if (c.delay_us > 0) {
      BPS_METRIC_COUNTER_ADD("bps_chaos_injected_total", 1);
      BPS_METRIC_COUNTER_ADD("bps_chaos_delay_total", 1);
      usleep(static_cast<useconds_t>(c.delay_us));
    }
    if (c.drop > 0 && ChaosRand(&tx->rng) < c.drop) {
      // Silent loss: report success, write nothing. Only the retry
      // layer's timeout can recover the frame — exactly the contract
      // under test.
      BPS_METRIC_COUNTER_ADD("bps_chaos_injected_total", 1);
      BPS_METRIC_COUNTER_ADD("bps_chaos_drop_total", 1);
      Trace::Get().Note("CHAOS_DROP", h.key, -1, h.req_id);
      Events::Get().Emit(EV_CHAOS, /*kind=*/1, h.key);
      if (VerboseLevel() >= 2) {
        fprintf(stderr, "[PS_VERBOSE] van CHAOS drop fd=%d cmd=%d "
                "seq=%lld\n", fd, h.cmd, (long long)h.seq);
      }
      return true;
    }
    if (c.dup > 0 && ChaosRand(&tx->rng) < c.dup) {
      BPS_METRIC_COUNTER_ADD("bps_chaos_injected_total", 1);
      BPS_METRIC_COUNTER_ADD("bps_chaos_dup_total", 1);
      Trace::Get().Note("CHAOS_DUP", h.key, -1, h.req_id);
      Events::Get().Emit(EV_CHAOS, /*kind=*/2, h.key);
      sends = 2;  // duplicate delivery, back-to-back, same seq
    }
    if (c.corrupt > 0 && payload_len > 0 &&
        ChaosRand(&tx->rng) < c.corrupt) {
      // On-wire bit corruption: flip one payload byte AFTER the CRC was
      // stamped, so the receiver's verify catches it and the retry layer
      // must resend. The flip happens on a flattened scratch copy — the
      // caller's iovec buffers are zero-copy views of live engine/fusion
      // state and the eventual RETRY must ship the uncorrupted bytes.
      BPS_METRIC_COUNTER_ADD("bps_chaos_injected_total", 1);
      BPS_METRIC_COUNTER_ADD("bps_chaos_corrupt_total", 1);
      Trace::Get().Note("CHAOS_CORRUPT", h.key, -1, h.req_id);
      Events::Get().Emit(EV_CHAOS, /*kind=*/3, h.key);
      corrupt_scratch.resize(static_cast<size_t>(payload_len));
      size_t off = 0;
      for (int i = 0; i < nsegs; ++i) {
        if (segs[i].iov_len) {
          memcpy(corrupt_scratch.data() + off, segs[i].iov_base,
                 segs[i].iov_len);
          off += segs[i].iov_len;
        }
      }
      size_t idx = static_cast<size_t>(
          ChaosRand(&tx->rng) * static_cast<double>(payload_len));
      if (idx >= static_cast<size_t>(payload_len)) {
        idx = static_cast<size_t>(payload_len) - 1;
      }
      corrupt_scratch[idx] ^= 0x20;
      if (VerboseLevel() >= 2) {
        fprintf(stderr, "[PS_VERBOSE] van CHAOS corrupt fd=%d cmd=%d "
                "seq=%lld byte=%zu\n", fd, h.cmd, (long long)h.seq, idx);
      }
      corrupt_seg.iov_base = corrupt_scratch.data();
      corrupt_seg.iov_len = corrupt_scratch.size();
      segs = &corrupt_seg;
      nsegs = 1;
    }
  }
  // Wire instant (main ring only; one per logical send, not per chaos
  // duplicate — the receiver's wire_recv shows the double delivery).
  if (Trace::Get().MainOn()) {
    Trace::Get().Instant("wire_send", h.key, -1, h.req_id, h.cmd);
  }
  bool ok = true;
  for (int send_i = 0; send_i < sends && ok; ++send_i) {
    ok = WriteFrame(fd, h, segs, nsegs, total, payload_len, shm.get(),
                    zcs.get());
  }
  return ok;
}

// One framed write on the already-locked connection: transport selection
// (shm ring / zerocopy / gather writev) exactly as before the chaos
// layer; factored out so a chaos-duplicated frame can be written twice.
bool Van::WriteFrame(int fd, MsgHeader& h, const struct iovec* segs,
                     int nsegs, uint64_t total, int64_t payload_len,
                     ShmConn* shm, ZcState* zcs) {
  // Under the per-fd send lock so the PS_VERBOSE trace order matches the
  // actual wire order (the whole point of a message trace).
  LogMsg("send", fd, h, payload_len);
  BPS_METRIC_COUNTER_ADD("bps_van_sent_frames_total", 1);
  if (shm) {
    // Ring data path: same frame layout, memcpy instead of syscalls. The
    // per-fd send lock makes this the ring's single producer.
    bytes_sent_.fetch_add(
        static_cast<int64_t>(sizeof(total) + total),
        std::memory_order_relaxed);
    if (!ShmStreamWrite(shm->out, shm->out_ring, shm->cap, &total,
                        sizeof(total)) ||
        !ShmStreamWrite(shm->out, shm->out_ring, shm->cap, &h, sizeof(h)))
      return false;
    for (int i = 0; i < nsegs; ++i) {
      if (segs[i].iov_len == 0) continue;
      if (!ShmStreamWrite(shm->out, shm->out_ring, shm->cap,
                          segs[i].iov_base, segs[i].iov_len))
        return false;
    }
    return true;
  }
  if (zcs && nsegs == 1 && payload_len >= kZerocopyMin) {
    const void* payload = segs[0].iov_base;
    // Zerocopy experiment path: copy the tiny framing, pin the payload
    // pages. Completion is reaped before returning (synchronous — see
    // the block comment above ZerocopyEnabled).
    bytes_sent_.fetch_add(
        static_cast<int64_t>(sizeof(total) + sizeof(h) + payload_len),
        std::memory_order_relaxed);
    if (!SendAll(fd, &total, sizeof(total)) ||
        !SendAll(fd, &h, sizeof(h)))
      return false;
    const char* p = static_cast<const char*>(payload);
    size_t left = static_cast<size_t>(payload_len);
    while (left > 0) {
      ssize_t n = ::send(fd, p, left, MSG_NOSIGNAL | MSG_ZEROCOPY);
      if (n < 0) {
        if (errno == EINTR) continue;
        if (errno == ENOBUFS) {
          // Usually optmem_max exhausted by unreaped notifications:
          // drain, retry. If everything is already reaped (ENOBUFS from
          // general memory pressure instead), the reap is a no-op — back
          // off briefly so the retry is not a busy-spin holding the
          // per-fd send lock.
          bool nothing_pending =
              zcs->next == 0 ||
              static_cast<int32_t>(zcs->reaped - (zcs->next - 1)) >= 0;
          if (nothing_pending) {
            // Sustained ENOBUFS (general memory pressure) must not stall
            // Van::Stop: bail out of the backoff loop once stop is
            // requested instead of retrying forever under the per-fd
            // send lock.
            if (stop_.load()) return false;
            usleep(1000);
          } else if (!ReapZerocopy(fd, zcs->next - 1, &zcs->reaped,
                                   stop_)) {
            return false;
          }
          continue;
        }
        return false;
      }
      ++zcs->next;  // each MSG_ZEROCOPY send gets one completion number
      p += n;
      left -= static_cast<size_t>(n);
    }
    // left started >= kZerocopyMin, so at least one send incremented next.
    return ReapZerocopy(fd, zcs->next - 1, &zcs->reaped, stop_);
  }
  // Gather write: framing words + every payload segment in one writev.
  // Segments beyond IOV_MAX (or past a partial write) finish through the
  // SendAll fallback loop below.
  std::vector<iovec> iov(2 + static_cast<size_t>(nsegs));
  iov[0].iov_base = &total;
  iov[0].iov_len = sizeof(total);
  iov[1].iov_base = &h;
  iov[1].iov_len = sizeof(h);
  int iovcnt = 2;
  for (int i = 0; i < nsegs; ++i) {
    if (segs[i].iov_len == 0) continue;
    iov[iovcnt++] = segs[i];
  }
  size_t want = sizeof(total) + sizeof(h) + static_cast<size_t>(payload_len);
  bytes_sent_.fetch_add(static_cast<int64_t>(want),
                        std::memory_order_relaxed);
  int first_cnt = iovcnt > IOV_MAX ? IOV_MAX : iovcnt;
  ssize_t n = ::writev(fd, iov.data(), first_cnt);
  if (n == static_cast<ssize_t>(want)) return true;
  if (n < 0) return false;
  // Partial write (or clipped iov list): finish from where writev stopped.
  size_t done = static_cast<size_t>(n);
  for (int i = 0; i < iovcnt; ++i) {
    if (done >= iov[i].iov_len) {
      done -= iov[i].iov_len;
      continue;
    }
    if (!SendAll(fd, static_cast<const char*>(iov[i].iov_base) + done,
                 iov[i].iov_len - done))
      return false;
    done = 0;
  }
  return true;
}

std::shared_ptr<std::mutex> Van::StartRecvThread(int fd) {
  auto smu = std::make_shared<std::mutex>();
  std::shared_ptr<ZcState> zcs;
  if (ZerocopyEnabled()) {
    int one = 1;
    // Only arm the zerocopy path if the kernel accepts SO_ZEROCOPY —
    // otherwise MSG_ZEROCOPY sends would fail with EINVAL.
    if (setsockopt(fd, SOL_SOCKET, SO_ZEROCOPY, &one, sizeof(one)) == 0) {
      zcs = std::make_shared<ZcState>();
    } else {
      BPS_LOG(WARNING) << "BYTEPS_VAN_ZEROCOPY=1 but SO_ZEROCOPY "
                          "unsupported; staying on copying sends";
    }
  }
  auto tx = std::make_shared<TxState>();
  {
    // Seed the chaos PRNG per connection: deterministic for a fixed
    // BYTEPS_CHAOS_SEED, decorrelated across connections.
    static std::atomic<uint64_t> conn_idx{0};
    tx->rng = (Chaos().seed + 1) * 0x9E3779B97F4A7C15ull +
              conn_idx.fetch_add(1);
  }
  std::lock_guard<std::mutex> lk(mu_);
  send_mu_[fd] = smu;
  tx_[fd] = tx;
  if (zcs) zc_[fd] = zcs;
  threads_.emplace_back([this, fd] { RecvLoop(fd); });
  return smu;
}

void Van::AcceptLoop() {
  while (!stop_.load()) {
    sockaddr_in peer{};
    socklen_t plen = sizeof(peer);
    int lfd = listen_fd_.load();
    if (lfd < 0) return;
    int fd = ::accept(lfd, reinterpret_cast<sockaddr*>(&peer), &plen);
    if (fd < 0) {
      if (stop_.load()) break;
      if (errno == EINTR) continue;
      break;  // listener shut down
    }
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    SizeSocketBuffers(fd);
    StartRecvThread(fd);
  }
  // The accept thread owns the listening fd's close (Stop only shuts it
  // down, so no other thread can race this close with a blocked accept).
  int lfd = listen_fd_.exchange(-1);
  if (lfd >= 0) ::close(lfd);
}

// Parse one framed message through any blocking byte-stream reader
// (RecvAll over a socket, ShmStreamRead over a ring). Returns false on
// EOF / connection close.
template <typename ReadFn>
static bool ReadFrame(ReadFn&& rd, Message* msg) {
  uint64_t total = 0;
  if (!rd(&total, sizeof(total))) return false;
  BPS_CHECK_GE(total, sizeof(MsgHeader)) << "malformed frame";
  if (!rd(&msg->head, sizeof(MsgHeader))) return false;
  uint64_t plen = total - sizeof(MsgHeader);
  BPS_CHECK_EQ(plen, static_cast<uint64_t>(msg->head.payload_len))
      << "frame length mismatch";
  if (plen > 0) {
    msg->payload.resize_uninit(plen);  // reader overwrites every byte
    if (!rd(msg->payload.data(), plen)) return false;
  }
  return true;
}

void Van::DispatchFrame(Message&& msg, int fd, RxState* rx) {
  int64_t plen = msg.head.payload_len;
  bytes_recv_.fetch_add(
      static_cast<int64_t>(sizeof(uint64_t) + sizeof(MsgHeader) + plen),
      std::memory_order_relaxed);
  BPS_METRIC_COUNTER_ADD("bps_van_recv_frames_total", 1);
  // Wire-CRC verification (FLAG_WIRE_CRC) — BEFORE the seq
  // cursor and BEFORE any upper layer sees the frame, so a corrupted
  // frame cannot advance dedup/engine/accumulator state. The CRC covers
  // the header verbatim as received (the sender stamped it over the
  // final header, flag set, payload_len including the trailer) chained
  // over the payload minus the 4-byte trailer. A mismatch is dropped
  // exactly like a chaos drop: the retry layer's timeout resends.
  if (msg.head.flags & FLAG_WIRE_CRC) {
    uint32_t want = 0;
    bool ok = plen >= 4;
    if (ok) {
      memcpy(&want, msg.payload.data() + plen - 4, sizeof(want));
      uint32_t got = Crc32c(&msg.head, sizeof(MsgHeader));
      if (plen > 4) {
        got = Crc32c(msg.payload.data(), static_cast<size_t>(plen) - 4,
                     got);
      }
      ok = got == want;
    }
    if (!ok) {
      BPS_METRIC_COUNTER_ADD("bps_crc_fail_total", 1);
      Trace::Get().Note("CRC_FAIL", msg.head.key, msg.head.sender,
                        msg.head.req_id);
      if (VerboseLevel() >= 1) {
        fprintf(stderr, "[PS_VERBOSE] van CRC FAIL fd=%d cmd=%d "
                "sender=%d seq=%lld len=%lld (frame dropped)\n",
                fd, msg.head.cmd, msg.head.sender, (long long)msg.head.seq,
                (long long)plen);
      }
      // Flaky-link quarantine: too many failures inside one window and
      // the connection itself is suspect — force-close it so the
      // reconnect ladder re-dials a fresh socket (postoffice is told
      // first, via corrupt_cb_, so it can attribute the link to a peer
      // and escalate persistent corruption to a named fail-stop).
      if (rx && WireCrcQuarantine() > 0) {
        int64_t now = RxNowUs();
        if (rx->win_start_us == 0 ||
            now - rx->win_start_us > WireCrcWindowUs()) {
          rx->win_start_us = now;
          rx->win_fails = 0;
        }
        if (++rx->win_fails >= WireCrcQuarantine()) {
          rx->win_fails = 0;
          rx->win_start_us = 0;
          BPS_METRIC_COUNTER_ADD("bps_crc_quarantine_total", 1);
          Trace::Get().Note("CRC_QUARANTINE", msg.head.key,
                            msg.head.sender, msg.head.req_id);
          if (corrupt_cb_ && !stop_.load()) corrupt_cb_(fd);
          ::shutdown(fd, SHUT_RDWR);
        }
      }
      return;  // dropped: no cursor advance, no dispatch
    }
    // Verified: strip the trailer and the flag so upper layers (and the
    // dedup/fusion parsers) see exactly the pre-CRC frame.
    plen -= 4;
    msg.head.payload_len = plen;
    msg.head.flags &= ~FLAG_WIRE_CRC;
    msg.payload.resize_uninit(static_cast<size_t>(plen));
  }
  // Frame-loss observability from the per-connection seq: a jump means
  // frames vanished between sender stamping and this reader (chaos
  // drop); a repeat is a duplicate delivery. Cursor is the single recv
  // thread's local, so no locking.
  if (msg.head.seq > 0 && rx) {
    if (msg.head.seq == rx->last_seq) {
      BPS_METRIC_COUNTER_ADD("bps_seq_dups_total", 1);
    } else if (rx->last_seq > 0 && msg.head.seq > rx->last_seq + 1) {
      BPS_METRIC_COUNTER_ADD("bps_seq_gaps_total",
                             msg.head.seq - rx->last_seq - 1);
    }
    if (msg.head.seq > rx->last_seq) rx->last_seq = msg.head.seq;
  }
  LogMsg("recv", fd, msg.head, plen);
  if (Trace::Get().MainOn()) {
    Trace::Get().Instant("wire_recv", msg.head.key, msg.head.sender,
                         msg.head.req_id, msg.head.cmd);
  }
  if (msg.head.cmd == CMD_SHM_HELLO) {
    // Van-internal: the peer created a shm segment for this connection.
    // From here on the socket carries no frames; it stays open purely
    // as the peer-death signal (EOF in RecvLoop).
    AttachShm(fd, msg);
    return;
  }
  handler_(std::move(msg), fd);
}

void Van::RecvLoop(int fd) {
  RxState rx;
  while (!stop_.load()) {
    Message msg;
    if (!ReadFrame([fd](void* b, size_t n) { return RecvAll(fd, b, n); },
                   &msg))
      break;
    DispatchFrame(std::move(msg), fd, &rx);
  }
  // A live-van exit means the PEER went away (EOF / reset), not Stop():
  // let the upper layer fail that peer's outstanding requests now.
  if (!stop_.load() && disconnect_cb_) disconnect_cb_(fd);
  CloseConn(fd);
}

// Connector side: create the segment, announce it over the socket, start
// consuming the inbound ring. Any failure leaves the connection on plain
// TCP (no hello sent, peer never knows).
bool Van::OfferShm(int fd, const std::shared_ptr<std::mutex>& smu) {
  static std::atomic<uint32_t> seq{0};
  char name[64];
  snprintf(name, sizeof(name), "/bpsvan_%d_%d_%u", getpid(), fd,
           seq.fetch_add(1));
  uint32_t cap = ShmRingBytes();
  size_t map_len = sizeof(ShmHeader) + 2 * static_cast<size_t>(cap);
  int sfd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (sfd < 0) {
    BPS_LOG(WARNING) << "shm_open(" << name << ") failed: "
                     << strerror(errno) << "; staying on TCP";
    return false;
  }
  // posix_fallocate, not ftruncate: tmpfs enforces its size limit at
  // page-fault time, so a merely-truncated segment on a small /dev/shm
  // (Docker default: 64 MB) would SIGBUS mid-memcpy after the hello had
  // already committed the peer to the ring. Reserving the pages up
  // front turns overcommit into a clean stay-on-TCP fallback here.
  int ferr = posix_fallocate(sfd, 0, static_cast<off_t>(map_len));
  if (ferr != 0) {
    ::close(sfd);
    shm_unlink(name);
    BPS_LOG(WARNING) << "shm reserve (" << map_len << " B) failed: "
                     << strerror(ferr) << "; staying on TCP";
    return false;
  }
  void* mm = mmap(nullptr, map_len, PROT_READ | PROT_WRITE, MAP_SHARED,
                  sfd, 0);
  ::close(sfd);
  if (mm == MAP_FAILED) {
    shm_unlink(name);
    BPS_LOG(WARNING) << "mmap shm failed: " << strerror(errno)
                     << "; staying on TCP";
    return false;
  }
  auto conn = std::make_shared<ShmConn>();
  conn->name = name;
  conn->hdr = new (mm) ShmHeader{};
  conn->hdr->magic = kShmMagic;
  conn->hdr->ring_bytes = cap;
  conn->map_len = map_len;
  conn->cap = cap;
  conn->out = &conn->hdr->dir[0];  // connector produces dir 0
  conn->in = &conn->hdr->dir[1];
  conn->out_ring = ShmRingData(conn->hdr, 0);
  conn->in_ring = ShmRingData(conn->hdr, 1);

  // Register BEFORE sending the hello, under an identity check on the
  // send mutex: if the peer died during shm setup above, the TCP recv
  // thread's CloseConn already erased this fd and closed it — the number
  // may already belong to a NEW connection (whose StartRecvThread
  // re-inserted the same key with a FRESH mutex, which is why key
  // presence alone is not enough). Writing the hello, or registering the
  // ring, against a reused fd would corrupt an unrelated connection;
  // bail and let the conn dtor unmap + unlink instead. Once registered,
  // this thread holds a third fd_users reference, so the fd cannot be
  // closed (hence not reused) while the hello send below is in flight.
  {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = send_mu_.find(fd);
    if (stop_.load() || it == send_mu_.end() || it->second != smu)
      return false;  // conn dtor unmaps + unlinks
    conn->fd_users.store(3);  // TCP recv + shm recv + this hello send
    shm_conns_[fd] = conn;
    threads_.emplace_back([this, fd, conn] { ShmRecvLoop(fd, conn); });
  }
  MsgHeader h{};
  h.cmd = CMD_SHM_HELLO;
  int64_t plen = static_cast<int64_t>(strlen(name));
  h.payload_len = plen;
  h.arg0 = cap;
  uint64_t total = sizeof(MsgHeader) + static_cast<uint64_t>(plen);
  // Raw socket send: the ONLY frame this socket will ever carry —
  // Connect has not returned the fd to callers yet, and any concurrent
  // internal Send already routes through the just-registered ring, so
  // the TCP byte stream stays exclusively ours. A dead peer surfaces as
  // a send failure; the TCP recv thread's EOF handling then tears the
  // ring down through the normal path.
  bool sent = SendAll(fd, &total, sizeof(total)) &&
              SendAll(fd, &h, sizeof(h)) &&
              SendAll(fd, name, static_cast<size_t>(plen));
  if (conn->fd_users.fetch_sub(1) == 1) ::close(fd);
  if (!sent) {
    BPS_LOG(WARNING) << "shm hello send failed on fd=" << fd
                     << "; peer-loss teardown will reap the ring";
    return false;
  }
  BPS_LOG(DEBUG) << "van fd=" << fd << " data path -> shm ring " << name
                 << " (" << cap << " B/dir)";
  return true;
}

// Acceptor side, invoked from the connection's TCP recv thread.
void Van::AttachShm(int fd, const Message& hello) {
  std::string name(hello.payload.data(), hello.payload.size());
  uint32_t cap = static_cast<uint32_t>(hello.head.arg0);
  // Wrap-correctness invariant (power of two) plus the same 1<<30 upper
  // clamp the connector's ShmRingBytes enforces — a hello above it cannot
  // have come from a healthy peer.
  if (cap == 0 || (cap & (cap - 1)) != 0 || cap > (1u << 30)) {
    BPS_LOG(WARNING) << "shm hello with invalid ring capacity " << cap
                     << "; dropping connection";
    ::shutdown(fd, SHUT_RDWR);
    return;
  }
  size_t map_len = sizeof(ShmHeader) + 2 * static_cast<size_t>(cap);
  int sfd = shm_open(name.c_str(), O_RDWR, 0600);
  if (sfd < 0) {
    // Peer committed to the ring; without it this connection is dead.
    // Close the socket — the peer's EOF handling fails it fast.
    BPS_LOG(WARNING) << "shm_open(" << name << ") failed: "
                   << strerror(errno) << "; dropping connection";
    ::shutdown(fd, SHUT_RDWR);
    return;
  }
  // The connector fallocated map_len before sending the hello, so a
  // smaller object means truncation/mismatch — mapping it would SIGBUS on
  // first access past EOF instead of failing cleanly here.
  struct stat st {};
  if (fstat(sfd, &st) != 0 ||
      static_cast<size_t>(st.st_size) < map_len) {
    BPS_LOG(WARNING) << "shm segment " << name << " size " << st.st_size
                     << " < expected " << map_len
                     << "; dropping connection";
    ::close(sfd);
    ::shutdown(fd, SHUT_RDWR);
    return;
  }
  void* mm = mmap(nullptr, map_len, PROT_READ | PROT_WRITE, MAP_SHARED,
                  sfd, 0);
  ::close(sfd);
  shm_unlink(name.c_str());  // both sides mapped or dying; name done
  if (mm == MAP_FAILED ||
      reinterpret_cast<ShmHeader*>(mm)->magic != kShmMagic ||
      reinterpret_cast<ShmHeader*>(mm)->ring_bytes != cap) {
    BPS_LOG(WARNING) << "shm map/validate failed for " << name
                   << "; dropping connection";
    if (mm != MAP_FAILED) munmap(mm, map_len);
    ::shutdown(fd, SHUT_RDWR);
    return;
  }
  auto conn = std::make_shared<ShmConn>();
  conn->hdr = reinterpret_cast<ShmHeader*>(mm);
  conn->map_len = map_len;
  conn->cap = cap;
  conn->out = &conn->hdr->dir[1];  // acceptor produces dir 1
  conn->in = &conn->hdr->dir[0];
  conn->out_ring = ShmRingData(conn->hdr, 1);
  conn->in_ring = ShmRingData(conn->hdr, 0);
  {
    std::lock_guard<std::mutex> lk(mu_);
    if (stop_.load()) return;
    shm_conns_[fd] = conn;
    threads_.emplace_back([this, fd, conn] { ShmRecvLoop(fd, conn); });
  }
  BPS_LOG(DEBUG) << "van fd=" << fd << " accepted shm ring " << name;
}

// Frame consumer for one shm connection. Mirrors RecvLoop; the TCP recv
// thread (still blocked on the idle socket) owns disconnect
// notification, and the fd itself closes when its last user thread
// (this loop or the TCP recv thread via CloseConn) releases it.
void Van::ShmRecvLoop(int fd, std::shared_ptr<ShmConn> conn) {
  RxState rx;
  while (!stop_.load()) {
    Message msg;
    if (!ReadFrame(
            [&conn](void* b, size_t n) {
              return ShmStreamRead(conn->in, conn->in_ring, conn->cap, b,
                                   n);
            },
            &msg))
      break;
    DispatchFrame(std::move(msg), fd, &rx);
  }
  if (conn->fd_users.fetch_sub(1) == 1) ::close(fd);
}

// Connection fds are CLOSED only by their owning recv thread (via
// CloseConn at RecvLoop exit) — for shm connections, by whichever of
// the TCP and shm recv threads finishes LAST. Other threads may only
// shutdown() them. This avoids the close-vs-blocked-recv (and
// dispatch-after-close) fd-reuse races.
void Van::CloseConn(int fd) {
  std::shared_ptr<ShmConn> shm;
  {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = shm_conns_.find(fd);
    if (it != shm_conns_.end()) {
      shm = it->second;
      shm_conns_.erase(it);
    }
    zc_.erase(fd);
    tx_.erase(fd);
    if (send_mu_.erase(fd) && !shm) ::close(fd);
  }
  // Outside mu_: wakes the shm recv thread (and any blocked producer in
  // the peer process); the mapping lives until the last shared_ptr drops.
  if (shm) {
    ShmCloseBoth(shm->hdr);
    if (shm->fd_users.fetch_sub(1) == 1) ::close(fd);
  }
}

void Van::Stop() {
  bool expected = false;
  if (!stop_.compare_exchange_strong(expected, true)) return;
  int lfd = listen_fd_.load();
  if (lfd >= 0) ::shutdown(lfd, SHUT_RDWR);  // wakes accept; thread closes
  std::vector<std::thread> ts;
  {
    std::lock_guard<std::mutex> lk(mu_);
    for (auto& kv : send_mu_) ::shutdown(kv.first, SHUT_RDWR);
    for (auto& kv : shm_conns_) ShmCloseBoth(kv.second->hdr);
    ts.swap(threads_);
  }
  for (auto& t : ts) {
    if (t.get_id() == std::this_thread::get_id()) t.detach();
    else if (t.joinable()) t.join();
  }
}

}  // namespace bps
