// Shared types and wire format for the byteps_tpu C++ core.
//
// Capability parity: reference byteps/common/common.h (TensorTableEntry,
// QueueType, DataType) + ps-lite Meta/SArray wire conventions — see
// SURVEY.md §2.1/§2.4. The wire format here is a fresh design: one fixed
// packed header per message followed by an opaque payload, framed over TCP.
#pragma once

#include <cstdint>
#include <cstring>
#include <memory>
#include <string>
#include <utility>
#include <vector>

namespace bps {

// --- data types -------------------------------------------------------------

enum DataType : int32_t {
  BPS_FLOAT32 = 0,
  BPS_FLOAT64 = 1,
  BPS_FLOAT16 = 2,
  BPS_BFLOAT16 = 3,
  BPS_INT32 = 4,
  BPS_INT64 = 5,
  BPS_UINT8 = 6,
  BPS_INT8 = 7,
};

inline int DtypeSize(int32_t dt) {
  switch (dt) {
    case BPS_FLOAT32: case BPS_INT32: return 4;
    case BPS_FLOAT64: case BPS_INT64: return 8;
    case BPS_FLOAT16: case BPS_BFLOAT16: return 2;
    case BPS_UINT8: case BPS_INT8: return 1;
    default: return 0;
  }
}

// --- node roles & ids -------------------------------------------------------

enum Role : int32_t {
  ROLE_SCHEDULER = 0,
  ROLE_SERVER = 1,
  ROLE_WORKER = 2,
  // Snapshot serving: a read-only replica of one primary
  // server's published snapshots. Rostered and heartbeat-monitored like
  // any node, but outside the training data plane entirely: it never
  // owns a key shard, never counts toward fleet formation, and its
  // death costs readers a failover, never the fleet anything.
  ROLE_REPLICA = 3,
};

constexpr int32_t kSchedulerId = 0;  // scheduler is always node 0

// --- message commands -------------------------------------------------------

enum Command : int32_t {
  CMD_REGISTER = 1,      // node -> scheduler: role + listen addr
  CMD_ADDRBOOK = 2,      // scheduler -> all: assigned id + address book
  CMD_BARRIER = 3,       // node -> scheduler
  CMD_BARRIER_ACK = 4,   // scheduler -> node
  CMD_PUSH = 5,          // worker -> server: gradient partition payload
  CMD_PUSH_ACK = 6,      // server -> worker
  CMD_PULL = 7,          // worker -> server: request aggregate
  CMD_PULL_RESP = 8,     // server -> worker: aggregate payload
  CMD_INIT_KEY = 9,      // worker -> server: declare key (len, dtype)
  CMD_INIT_ACK = 10,     // server -> worker
  CMD_HEARTBEAT = 11,    // node -> scheduler
  CMD_SHUTDOWN = 12,     // scheduler -> all (graceful teardown)
  CMD_BCAST_PUSH = 13,   // worker -> server: root pushes initial value
  CMD_BCAST_PULL = 14,   // worker -> server: non-root pulls initial value
  CMD_ERROR = 15,        // local synthetic: request failed (dead peer);
                         // payload = human-readable diagnostic
  CMD_SHM_HELLO = 16,    // van-internal: connector offers a shared-memory
                         // data path; payload = shm segment name, arg0 =
                         // per-direction ring bytes. Never reaches upper
                         // layers.
  // Small-tensor fusion (BYTEPS_FUSION_BYTES): many sub-partition-size
  // operations for ONE server coalesced into a single frame. Payload =
  // arg0 x SubHeader table + gathered sub-payloads (offset/len per
  // entry). One req_id covers the whole batch; replies are batched the
  // same way, so a conv net's hundreds of tiny tensors pay one framed
  // round trip per flush instead of one per key.
  CMD_MULTI_PUSH = 17,       // worker -> server: batched CMD_PUSH ops
  CMD_MULTI_ACK = 18,        // server -> worker: batched push acks
  CMD_MULTI_PULL = 19,       // worker -> server: batched CMD_PULL ops
  CMD_MULTI_PULL_RESP = 20,  // server -> worker: batched pull responses
  CMD_KEEPALIVE = 21,        // server -> worker: "your duplicate request
                             // is known and still being worked on" — the
                             // retry layer resets the request's attempt
                             // budget instead of escalating to fail-stop
                             // (a parked pull can legitimately wait out
                             // many retry timeouts behind a slow peer).
  // Hot server replacement: scheduler-coordinated recovery of
  // a dead SERVER rank instead of the fleet-wide failure SHUTDOWN.
  CMD_EPOCH_PAUSE = 22,      // scheduler -> all: a server rank died;
                             // membership epoch bumped (arg0 = epoch,
                             // arg1 = dead node id). Workers park that
                             // rank's in-flight requests in the resend
                             // queue and freeze their retry clocks.
  CMD_EPOCH_RESUME = 23,     // scheduler -> all: a replacement adopted
                             // the dead rank (arg0 = epoch, arg1 = node
                             // id, payload = the replacement's
                             // NodeInfo). Workers redial, re-seed the
                             // shard, and drain the parked queue.
  CMD_RESEED = 24,           // worker -> replacement server: re-seed one
                             // key's latest COMPLETED round (version =
                             // round, payload = the unscaled aggregate)
                             // so pulls parked mid-round can be served
                             // from the authoritative worker replica.
  // Elastic worker membership: the worker set is an
  // epoch-versioned quantity — joins, graceful leaves, and (with
  // BYTEPS_ELASTIC=1) unplanned worker deaths change the fleet size
  // without a restart. All of these are CONTROL-PLANE: never
  // chaos-injected, never retried — losing one would strand a
  // membership change exactly like a lost heartbeat fakes a death.
  CMD_JOIN_REQUEST = 26,     // new worker -> scheduler: join the running
                             // fleet (payload = NodeInfo; the scheduler
                             // answers with a direct CMD_ADDRBOOK whose
                             // arg0 = the allocated never-reused id and
                             // arg1 = (join_round << 32) | bcast_round —
                             // the round boundary the joiner enters at).
  CMD_LEAVE_REQUEST = 27,    // departing worker -> scheduler: graceful
                             // leave, sent after the worker drained its
                             // in-flight rounds (all handles settled).
  CMD_LEAVE_ACK = 28,        // scheduler -> leaver: removal recorded;
                             // the leaver may exit (no goodbye owed).
  CMD_FLEET_PAUSE = 29,      // scheduler -> all: worker membership is
                             // changing (arg0 = new epoch, version =
                             // kind 0 join / 1 leave / 2 death, key =
                             // affected node id, -1 for a join). For a
                             // JOIN, workers gate new rounds and answer
                             // CMD_FLEET_PAUSE_ACK with their round
                             // counters; leaves/shrinks need no gate
                             // (the departed rank is in no incomplete
                             // round once the server rolls it back).
  CMD_FLEET_PAUSE_ACK = 30,  // worker -> scheduler: rounds gated;
                             // arg0 = max tensor round counter, arg1 =
                             // max broadcast round counter (the
                             // scheduler's join_round is the fleet max).
  CMD_FLEET_RESUME = 31,     // scheduler -> all: the membership change
                             // is committed (arg0 = epoch, version =
                             // kind, key = affected node id, arg1 =
                             // (join_round << 32) | bcast_round for a
                             // join, payload = the full new NodeInfo
                             // address book). Servers re-roster; workers
                             // sync counters (join) and lift the gate.
  CMD_HEARTBEAT_ACK = 25,    // scheduler -> node: echo of a heartbeat
                             // (arg0 = the sender's original send
                             // timestamp in steady-clock us, arg1 = the
                             // scheduler's clock at receipt). The sender
                             // keeps its minimum-RTT sample and derives
                             // its clock offset vs the scheduler —
                             // recorded in every trace dump's metadata
                             // so the fleet timeline merge
                             // (monitor.timeline) can align per-rank
                             // clocks without NTP assumptions.
  // Scheduler fail-over: a crashed-and-restarted scheduler
  // rebuilds its entire state — address book, membership epoch, rank
  // allocator high-water mark, tenant rosters, heartbeat table — from
  // the surviving fleet's re-registrations. Control-plane by contract
  // (only BYTEPS_CHAOS_CTRL=1 may inject faults into them, and then
  // the park/re-dial machinery is the recovery path under test).
  CMD_REREGISTER = 32,       // parked node -> restarted scheduler: a
                             // state-carrying re-registration (sender =
                             // my committed node id, arg0 = my membership
                             // epoch, arg1 = the highest WORKER id in my
                             // committed book (rank-allocator high-water
                             // hint), key = my rounds-completed
                             // watermark; payload = my own NodeInfo
                             // followed by my full last-committed
                             // address book). The scheduler commits once
                             // a quorum — every non-scheduler id named
                             // by the highest-epoch book — has reported.
  CMD_SCHED_RESUME = 33,     // restarted scheduler -> re-registered
                             // node: recovery committed (arg0 = adopted
                             // epoch, arg1 = reregistered count); sent
                             // right after a re-issued CMD_ADDRBOOK,
                             // exactly like an elastic commit. Unparks
                             // the node's heartbeat loop.
  // Versioned snapshot serving (docs/serving.md): read traffic
  // against round-versioned immutable snapshots published by the server
  // engine at each round boundary. All four are DATA-PLANE (retried,
  // deduped, chaos-injectable) — a reader or replica losing a frame must
  // ride the same absorption machinery as a training pull.
  CMD_SNAP_PULL = 34,        // reader -> server/replica: request one
                             // key's snapshot (version = requested
                             // snapshot version, -1 for `latest`;
                             // FLAG_WIRE_QUANT requests the quantized
                             // serving encoding).
  CMD_SNAP_RESP = 35,        // server/replica -> reader: version = the
                             // served snapshot version (echoed so the
                             // client can assert its cut), arg0 = miss
                             // code (0 ok, 1 evicted/too old, 2 not yet
                             // committed, 3 unknown key), arg1 = raw
                             // float32 byte length when quantized.
  CMD_SNAP_SUB = 36,         // replica -> primary: delta poll (arg0 =
                             // highest snapshot version the replica
                             // holds; -1 = empty, full catch-up).
  CMD_SNAP_DELTA = 37,       // primary -> replica: batched snapshot
                             // entries newer than the subscription
                             // watermark (arg0 = entry count, payload =
                             // SubHeader table + gathered float32
                             // payloads, CMD_MULTI_* layout; version =
                             // the primary's latest snapshot version).
};

// Transient-fault tolerance: commands eligible for chaos injection,
// idempotent retry, and server-side dedup. Control-plane traffic
// (register/addrbook/barrier/heartbeat/shutdown) is NEVER injected or
// retried — dropping a heartbeat would fake a node death, and the
// topology handshake has its own retry (Van::Connect).
inline bool IsDataPlaneCmd(int32_t cmd) {
  switch (cmd) {
    case CMD_PUSH: case CMD_PUSH_ACK: case CMD_PULL: case CMD_PULL_RESP:
    case CMD_INIT_KEY: case CMD_INIT_ACK:
    case CMD_BCAST_PUSH: case CMD_BCAST_PULL:
    case CMD_MULTI_PUSH: case CMD_MULTI_ACK:
    case CMD_MULTI_PULL: case CMD_MULTI_PULL_RESP:
    case CMD_KEEPALIVE:
    // RESEED rides the same retry/dedup machinery as a push (it is one):
    // chaos may drop it, the retry layer re-delivers it, and re-applying
    // it is idempotent (assignment of an already-final aggregate).
    // EPOCH_PAUSE/RESUME are control-plane: losing one would strand the
    // recovery, exactly like a lost heartbeat would fake a death.
    case CMD_RESEED:
    // Snapshot serving: reads and replica delta traffic are
    // data plane by the same argument — a dropped SNAP_PULL retries
    // like a training pull, a replayed SNAP_DELTA re-installs an
    // identical immutable snapshot entry (idempotent assignment).
    case CMD_SNAP_PULL: case CMD_SNAP_RESP:
    case CMD_SNAP_SUB: case CMD_SNAP_DELTA:
      return true;
    default:
      return false;
  }
}

// --- message flags ----------------------------------------------------------

enum MsgFlags : int32_t {
  FLAG_COMPRESSED = 1 << 0,  // payload is compressor output
  FLAG_ASYNC = 1 << 1,       // async-mode operation
  FLAG_WIRE_QUANT = 1 << 2,  // payload is the block-quantized int8 wire
                             // encoding (BlockQuant, compressor.h): on a
                             // PUSH the sender encoded the raw float32
                             // partition; on a PULL it REQUESTS the
                             // quantized aggregate; on a PULL_RESP the
                             // server re-quantized the reply (arg0 =
                             // decoded byte length). Mutually exclusive
                             // with FLAG_COMPRESSED — quantization only
                             // applies to codec-less float32 keys.
  FLAG_CKPT_DURABLE = 1 << 3,  // CMD_REGISTER from a server launched
                             // with BYTEPS_CKPT_RESTORE=1:
                             // the header's key field carries
                             // 1 + newest durable checkpoint version
                             // (0 = restore armed but no valid
                             // checkpoint on disk — the scheduler
                             // fail-stops rather than cold-start). The
                             // committed fleet restore epoch rides back
                             // the same way in CMD_ADDRBOOK's key.
  FLAG_WIRE_CRC = 1 << 4,    // BYTEPS_WIRE_CRC frame integrity:
                             // the payload carries a 4-byte
                             // little-endian CRC32C trailer computed
                             // over the MsgHeader (as stamped, flag set,
                             // payload_len INCLUDING the trailer, the
                             // trailer field itself excluded) followed
                             // by the payload bytes. payload_len counts
                             // the trailer, so framing is unchanged;
                             // receivers verify, then strip the trailer
                             // and clear this flag before dispatch. A
                             // CRC-off frame carries no trailer and no
                             // flag — byte-for-byte the pre-CRC wire.
};

// --- wire header ------------------------------------------------------------
// Every frame on the wire is: uint64 total_len | MsgHeader | payload bytes.
// total_len counts header + payload. Integers are host-endian (all nodes are
// little-endian x86/ARM Linux in scope).

#pragma pack(push, 1)
struct MsgHeader {
  // Carved out of the old i32 cmd (multi-tenant namespaces):
  // command values never exceeded 31, so the high two bytes were always
  // zero on the wire — they now carry the sender's tenant id. A frame
  // from a pre-tenant peer (or any BYTEPS_TENANT_ID-unset process)
  // reads back as tenant 0, and a tenant-0 frame is byte-for-byte the
  // pre-tenant header: cmd's little-endian bytes [lo, hi] followed by
  // tenant [0, 0] reproduce the old 4-byte cmd exactly.
  int16_t cmd = 0;
  uint16_t tenant = 0;     // sender's tenant id (0 = legacy/default)
  int32_t sender = -1;     // node id (-1 before registration)
  int64_t key = 0;         // partition key
  int32_t req_id = -1;     // request id for matching responses
  int32_t dtype = 0;
  int64_t payload_len = 0;  // bytes following the header
  int32_t flags = 0;
  int32_t version = 0;     // round parity slot (sync double-buffering)
  int64_t arg0 = 0;        // cmd-specific (e.g. decompressed len for PUSH,
                           // listen port for REGISTER, count for BARRIER)
  int64_t arg1 = 0;        // cmd-specific (e.g. role for REGISTER)
  int64_t seq = 0;         // per-connection monotone frame sequence,
                           // stamped by the van under the per-fd send
                           // lock. A receiver-side gap (seq jumps) means
                           // frames were lost on this connection (chaos
                           // drop, or a reset mid-stream); a repeat means
                           // duplicate delivery. Pure observability
                           // (bps_seq_gaps_total / bps_seq_dups_total);
                           // end-to-end retry dedup keys on (sender,
                           // req_id), which is worker-monotone.
};
#pragma pack(pop)

// Per-operation entry in a CMD_MULTI_* frame. The frame header's arg0
// holds the entry count; the payload is the packed table followed by the
// gathered sub-payload bytes, each entry's slice at [offset, offset+len).
// `cmd` names the sub-operation (CMD_PUSH / CMD_PULL on requests,
// CMD_PUSH_ACK / CMD_PULL_RESP on replies) so one table layout serves
// all four multi commands; arg0/arg1 mirror the cmd-specific fields of
// the equivalent single-frame MsgHeader (raw len, async apply count).
#pragma pack(push, 1)
struct SubHeader {
  int64_t key = 0;
  int16_t cmd = 0;        // sub-operation command (values are tiny)
  // Wire encoding of this entry's sub-payload (quantized fused
  // wire): BPS_FLOAT32 (0, the default — the payload is the raw `dtype`
  // bytes, exactly the pre-quant wire) or BPS_INT8 (the BlockQuant
  // int8 encoding; FLAG_WIRE_QUANT is set in `flags` alongside it).
  // Carved out of the old int32 `cmd` (whose values never exceeded 25),
  // so a quant-off frame is byte-for-byte identical to the pre-quant
  // table layout: cmd's little-endian bytes [lo, 0] followed by
  // wire_dtype [0, 0] reproduce the old 4-byte cmd exactly.
  int16_t wire_dtype = 0;
  int32_t version = 0;
  // Carved out of the old i32 dtype exactly like the frame header's cmd
  //: dtype values never exceed 7, so the high bytes were
  // always zero — they now carry the sub-operation's tenant id (every
  // sub-op of one frame shares the frame's tenant; the field makes each
  // table entry self-describing for the engine fan-out). Tenant-0
  // tables stay byte-for-byte the pre-tenant layout.
  int16_t dtype = 0;
  uint16_t tenant = 0;
  int32_t flags = 0;
  int64_t arg0 = 0;
  int64_t arg1 = 0;
  int64_t offset = 0;  // byte offset into the gathered payload region
  int64_t len = 0;     // sub-payload bytes (0 for pulls / bare acks)
};
#pragma pack(pop)

// Owned byte buffer whose resize does NOT zero-fill. The receive path
// resizes to the frame length and immediately overwrites every byte from
// the socket; std::vector's value-initialising resize would write each
// 4 MB partition twice (memset + recv), a measurable slice of DCN-leg
// bandwidth. Move-only, minimal surface.
class Bytes {
 public:
  Bytes() = default;
  // Explicit moves: a defaulted move would copy len_/cap_, leaving the
  // moved-from object claiming nonzero size with null data_ — a later
  // resize_uninit(n <= cap_) on it would hand out data()==nullptr with
  // size()>0. Messages move through parked_pushes and back; keep the
  // moved-from state honest (empty).
  Bytes(Bytes&& other) noexcept
      : data_(std::move(other.data_)),
        len_(std::exchange(other.len_, 0)),
        cap_(std::exchange(other.cap_, 0)) {}
  Bytes& operator=(Bytes&& other) noexcept {
    if (this != &other) {
      data_ = std::move(other.data_);
      len_ = std::exchange(other.len_, 0);
      cap_ = std::exchange(other.cap_, 0);
    }
    return *this;
  }

  void resize_uninit(size_t n) {
    if (n > cap_) {
      data_.reset(new char[n]);
      cap_ = n;
    }
    len_ = n;
  }
  void assign(const char* b, const char* e) {
    resize_uninit(static_cast<size_t>(e - b));
    if (len_) memcpy(data_.get(), b, len_);
  }
  char* data() { return data_.get(); }
  const char* data() const { return data_.get(); }
  size_t size() const { return len_; }
  bool empty() const { return len_ == 0; }
  const char* begin() const { return data_.get(); }
  const char* end() const { return data_.get() + len_; }

 private:
  std::unique_ptr<char[]> data_;
  size_t len_ = 0;
  size_t cap_ = 0;
};

struct Message {
  MsgHeader head;
  Bytes payload;  // owned receive buffer
};

// --- node descriptor (address book entry) -----------------------------------

#pragma pack(push, 1)
struct NodeInfo {
  int32_t id;
  int32_t role;
  char host[64];
  int32_t port;
  // Multi-tenant roster: the tenant this node serves traffic
  // for (workers; servers/scheduler are shared infrastructure, 0) and
  // its job's BYTEPS_TENANT_WEIGHT share, registered at CMD_REGISTER /
  // CMD_JOIN_REQUEST time and broadcast to every rank in the address
  // book — servers derive per-tenant expected-contributor counts and
  // DRR weights from the book alone, with no extra control messages.
  // Zero-initialised by every pre-existing construction site, so a
  // tenant-less fleet's book carries (0, 0) = the legacy pool.
  int32_t tenant = 0;
  int32_t weight = 0;  // 0 reads as weight 1 (legacy registrants)
};
#pragma pack(pop)

// Wire-layout pins (A/B contract): the tenant fields are carved
// from bytes that were provably always zero, so the header/sub-header
// sizes — and therefore every data-plane frame with tenant 0 — are
// byte-for-byte the pre-tenant wire. NodeInfo (control-plane address
// book, same-binary fleet) is the one struct that legitimately grew.
static_assert(sizeof(MsgHeader) == 64, "MsgHeader wire size changed");
static_assert(sizeof(SubHeader) == 56, "SubHeader wire size changed");
static_assert(sizeof(NodeInfo) == 84, "NodeInfo wire size changed");

}  // namespace bps
