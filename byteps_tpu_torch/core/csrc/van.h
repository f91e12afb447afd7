// Message transport over TCP sockets, with an optional shared-memory data
// path for co-located peers.
//
// Capability parity: reference ps-lite Van/ZMQVan (SURVEY.md §2.4) — node
// handshake, framed message send/recv, zero-copy sends. Fresh design: no
// ZMQ dependency; plain POSIX sockets with one receive thread per
// connection (TPU-host fleets are Linux; thread-per-conn is simple and at
// PS-scale [O(100) conns] well within epoll-free territory), writev-based
// gather sends so payload bytes are never copied into a staging buffer.
//
// Second transport (BYTEPS_VAN_TYPE=shm): the role the reference's non-TCP
// vans play (ZMQVan ipc:// and rdma_van.h — SURVEY.md §2.4) is "don't pay
// the network stack when you don't have to". For loopback peers the
// connector negotiates a per-connection POSIX shm segment over the freshly
// dialled TCP socket (CMD_SHM_HELLO) and both sides move all subsequent
// frames through lock-free SPSC byte rings (shm_ring.h). The TCP socket
// stays open but idle: peer death still surfaces as an EOF on it, so
// heartbeat-free fast-fail (SetDisconnectHandler) works identically on
// both transports. Remote peers keep TCP — mixed fleets need no config.
#pragma once

#include <sys/uio.h>

#include <atomic>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

#include "common.h"

namespace bps {

class Van {
 public:
  // Handler is invoked on the connection's receive thread. fd identifies the
  // connection so upper layers can reply on the same socket.
  using Handler = std::function<void(Message&&, int fd)>;

  explicit Van(Handler handler) : handler_(std::move(handler)) {}
  ~Van() { Stop(); }

  // Bind + listen on port (0 = ephemeral). Returns the bound port.
  int Listen(int port);

  // Connect to a remote listener. Returns the connection fd (or -1).
  // max_attempts bounds the dial loop (100 ms between tries): the
  // default rides out fleet-formation races like the reference; the
  // RECONNECT path (postoffice) passes 1 per try and owns its own
  // backoff, so a dead peer is detected in milliseconds, not 30 s.
  int Connect(const std::string& host, int port, int max_attempts = 300);

  // Send one framed message; thread-safe per connection. Payload bytes are
  // written straight from `payload` (zero-copy gather write).
  bool Send(int fd, const MsgHeader& head, const void* payload = nullptr,
            int64_t payload_len = 0);

  // Gather-send: one framed message whose payload is the concatenation of
  // `nsegs` discontiguous segments (the fusion layer's sub-header table +
  // sub-payloads), written via a single writev without staging copies.
  // head.payload_len is set to the segment total. Same per-fd locking and
  // transport selection as Send.
  bool SendV(int fd, const MsgHeader& head, const struct iovec* segs,
             int nsegs);

  void CloseConn(int fd);
  void Stop();
  bool stopped() const { return stop_.load(); }

  // Invoked (on the dying connection's receive thread) when a connection
  // closes while the van is still running — peer crash/EOF, not Stop().
  // Upper layers use it to fail outstanding requests to that peer fast
  // instead of waiting out the heartbeat detector.
  void SetDisconnectHandler(std::function<void(int fd)> cb) {
    disconnect_cb_ = std::move(cb);
  }

  // Invoked (on the connection's receive thread) when the wire-CRC
  // quarantine threshold trips on a connection (
  // BYTEPS_WIRE_CRC_QUARANTINE: too many CRC failures inside one
  // window) — immediately BEFORE the van force-closes the connection so
  // the reconnect ladder re-dials a fresh socket. Upper layers use it
  // to attribute the corrupting link to a peer node and escalate a
  // persistently-corrupting link to a named fail-stop.
  void SetCorruptionHandler(std::function<void(int fd)> cb) {
    corrupt_cb_ = std::move(cb);
  }

  // Cumulative wire bytes (frames + payloads), for bandwidth assertions
  // and the timeline. Monotonic over the van's lifetime.
  int64_t bytes_sent() const { return bytes_sent_.load(); }
  int64_t bytes_recv() const { return bytes_recv_.load(); }

 private:
  struct ShmConn;  // mapped segment + role (van.cc)
  // MSG_ZEROCOPY per-fd completion bookkeeping (BYTEPS_VAN_ZEROCOPY=1;
  // van.cc zerocopy block). Touched only under the per-fd send lock.
  struct ZcState {
    uint32_t next = 0;              // zerocopy sends issued on this fd
    uint32_t reaped = 0xFFFFFFFFu;  // highest completed (-1 = none yet)
  };
  // Per-connection transmit state, mutated only under the per-fd send
  // lock: the monotone frame sequence (MsgHeader::seq) plus the chaos
  // layer's deterministic PRNG and data-frame counter
  // (BYTEPS_CHAOS_SEED/_DROP/_DELAY_US/_DUP/_RESET_EVERY; van.cc).
  struct TxState {
    int64_t seq = 0;
    uint64_t rng = 0;
    int64_t data_frames = 0;
  };
  // Per-connection receive state, owned by the connection's single frame
  // consumer thread per transport (no locking): the seq gap/dup cursor
  // plus the wire-CRC quarantine window (BYTEPS_WIRE_CRC_QUARANTINE,
  // van.cc).
  struct RxState {
    int64_t last_seq = 0;
    int64_t win_fails = 0;     // CRC failures inside the current window
    int64_t win_start_us = 0;  // window open time (0 = none open yet)
  };

  // One framed write on an already-locked connection (transport
  // selection: shm ring / zerocopy / gather writev). Factored out of
  // SendV so the chaos layer can write a duplicated frame twice.
  bool WriteFrame(int fd, MsgHeader& h, const struct iovec* segs,
                  int nsegs, uint64_t total, int64_t payload_len,
                  ShmConn* shm, ZcState* zcs);
  void AcceptLoop();
  void RecvLoop(int fd);
  // Returns the per-fd send mutex it registered — an identity token for
  // THIS incarnation of the fd (a closed-and-reaccepted fd gets a fresh
  // mutex), which OfferShm uses to detect fd reuse.
  std::shared_ptr<std::mutex> StartRecvThread(int fd);
  void ShmRecvLoop(int fd, std::shared_ptr<ShmConn> conn);
  // Shared tail of both recv loops: wire accounting, PS_VERBOSE trace,
  // wire-CRC verification (BYTEPS_WIRE_CRC — a mismatching frame is
  // dropped here, before it can touch seq cursors or upper-layer
  // state), seq gap/dup detection, van-internal command handling,
  // handler dispatch — ONE copy so the transports cannot drift. `rx` is
  // the caller recv loop's per-connection state (each connection has
  // exactly one frame consumer thread per transport).
  void DispatchFrame(Message&& msg, int fd, RxState* rx);
  // Connector side; returns false -> stay on TCP. `smu` is the send-mutex
  // identity StartRecvThread returned for this connection.
  bool OfferShm(int fd, const std::shared_ptr<std::mutex>& smu);
  void AttachShm(int fd, const Message& hello);  // acceptor side

  Handler handler_;
  std::function<void(int fd)> disconnect_cb_;
  std::function<void(int fd)> corrupt_cb_;
  std::atomic<int> listen_fd_{-1};
  std::atomic<bool> stop_{false};
  std::atomic<int64_t> bytes_sent_{0};
  std::atomic<int64_t> bytes_recv_{0};
  std::mutex mu_;  // guards send_mu_ / threads_ / shm_conns_
  // shared_ptr: Send() keeps the per-fd mutex alive across its write even
  // if CloseConn erases the entry concurrently (connection teardown race).
  std::unordered_map<int, std::shared_ptr<std::mutex>> send_mu_;
  // Connections whose data path moved to a shm ring, keyed by the (still
  // open) TCP fd. Send() consults this under the per-fd send lock, so a
  // connection's frames never interleave across transports.
  std::unordered_map<int, std::shared_ptr<ShmConn>> shm_conns_;
  // fds armed for MSG_ZEROCOPY sends (SO_ZEROCOPY accepted at setup).
  std::unordered_map<int, std::shared_ptr<ZcState>> zc_;
  // Per-fd transmit state (seq stamping + chaos); created with the
  // connection, looked up in SendV under the same mu_ acquisition as
  // send_mu_, mutated only under the per-fd send lock.
  std::unordered_map<int, std::shared_ptr<TxState>> tx_;
  std::vector<std::thread> threads_;
};

}  // namespace bps
