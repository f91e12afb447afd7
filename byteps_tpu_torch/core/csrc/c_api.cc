// extern "C" surface loaded by byteps_tpu.core.ffi via ctypes.
//
// Capability parity: reference byteps/common/operations.{h,cc} public C
// entry points (byteps_init / byteps_declare_tensor / EnqueueTensor /
// byteps_rank / ...; SURVEY.md §2.1) — env-var configured exactly like the
// reference (DMLC_* / BYTEPS_* families, docs/ENV.md).
#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

#include <chrono>
#include <cmath>
#include <cstdio>
#include <cstring>
#include <limits>
#include <memory>
#include <string>
#include <vector>

#include "ckpt.h"
#include "common.h"
#include "compressor.h"
#include "cpu_reducer.h"
#include "debug.h"
#include "elastic.h"
#include "events.h"
#include "kv.h"
#include "logging.h"
#include "metrics.h"
#include "postoffice.h"
#include "roundstats.h"
#include "server.h"
#include "snapshot.h"
#include "tenancy.h"
#include "trace.h"
#include "worker.h"

namespace {

using namespace bps;

struct Global {
  std::unique_ptr<Postoffice> po;
  std::unique_ptr<KVWorker> kv;
  std::unique_ptr<BytePSServer> server;
  std::unique_ptr<BytePSWorker> worker;
  Role role = ROLE_WORKER;
  bool inited = false;

  // Scripts that skip bps_finalize (no explicit shutdown) reach this
  // destructor with everything still live. Members are destroyed in
  // reverse declaration order, which would free the KVWorker BEFORE
  // ~Postoffice runs the goodbye protocol — whose SHUTDOWN handling
  // fires shutdown_cb_ -> kv->FailAllPending() on a van recv thread,
  // a use-after-free that wedges that thread on a garbage mutex and
  // deadlocks the van join (observed as workers hanging at exit).
  // Finalize in dependency order here instead; ~Postoffice's own
  // Finalize call is then an idempotent no-op.
  ~Global() {
    if (!inited) return;
    // Drain the callback executor FIRST: queued completions touch the
    // BytePSWorker (credit release, handle counts), which is destroyed
    // before the KVWorker in reverse member order.
    if (kv) kv->StopExec();
    if (worker) worker->Stop();
    if (po) po->Finalize();
    if (server) server->Stop();
    inited = false;
  }
};

Global* g() {
  static Global inst;
  return &inst;
}

int EnvInt(const char* name, int dflt) {
  const char* v = getenv(name);
  return v && *v ? atoi(v) : dflt;
}

int64_t EnvInt64(const char* name, int64_t dflt) {
  const char* v = getenv(name);
  return v && *v ? atoll(v) : dflt;
}

std::string EnvStr(const char* name, const char* dflt) {
  const char* v = getenv(name);
  return v && *v ? v : dflt;
}

bool EnvBool(const char* name) {
  const char* v = getenv(name);
  if (!v || !*v) return false;
  return strcmp(v, "0") != 0 && strcasecmp(v, "false") != 0;
}

// Build the default compressor config string from env (reference:
// byteps_compressor_type / _k / ef_type / momentum_type params).
std::string DefaultCompConfig() {
  std::string type = EnvStr("BYTEPS_COMPRESSOR", "");
  if (type.empty()) return "";
  if (type.find('=') != std::string::npos) {
    // Full config-string form ("type=onebit;ef=vanilla") — pass through
    // verbatim; the simple form below composes from the companion envs.
    return type;
  }
  std::string cfg = "type=" + type;
  int64_t k = EnvInt64("BYTEPS_COMPRESSOR_K", 0);
  if (k > 0) cfg += ";k=" + std::to_string(k);
  std::string ef = EnvStr("BYTEPS_ERROR_FEEDBACK", "");
  if (!ef.empty()) cfg += ";ef=" + ef;
  std::string mom = EnvStr("BYTEPS_MOMENTUM", "");
  if (!mom.empty()) {
    cfg += ";momentum=" + mom;
    cfg += ";mu=" + EnvStr("BYTEPS_MOMENTUM_MU", "0.9");
  }
  return cfg;
}

}  // namespace

extern "C" {

// role: 0 scheduler, 1 server, 2 worker, 3 read replica (Role enum).
// Returns node id, <0 on error. All other configuration comes from the
// environment for parity with the reference (see byteps_tpu/config.py
// and docs/ENV.md).
int bps_init(int role) {
  InstallCrashHandler();
  Global* gl = g();
  BPS_CHECK(!gl->inited) << "bps_init called twice";
  // Fresh state per init so a process can re-init after finalize (tests).
  gl->worker.reset();
  gl->server.reset();
  gl->kv.reset();
  gl->po = std::make_unique<Postoffice>();
  gl->role = static_cast<Role>(role);
  std::string uri = EnvStr("DMLC_PS_ROOT_URI", "127.0.0.1");
  int port = EnvInt("DMLC_PS_ROOT_PORT", 9000);
  int nw = EnvInt("DMLC_NUM_WORKER", 1);
  int ns = EnvInt("DMLC_NUM_SERVER", 1);

  Postoffice::AppHandler handler;
  if (gl->role == ROLE_SERVER) {
    gl->server = std::make_unique<BytePSServer>();
    // Engine threads must exist BEFORE the postoffice starts accepting:
    // a fast worker can deliver INIT_KEY the moment the address book is
    // broadcast, racing a not-yet-started engine.
    gl->server->Start(gl->po.get(), EnvInt("BYTEPS_SERVER_ENGINE_THREAD", 4),
                      EnvBool("BYTEPS_ENABLE_ASYNC"));
    handler = [gl](Message&& m, int fd) {
      gl->server->Handle(std::move(m), fd);
    };
    // Durable restore: the server scanned its checkpoint dir
    // in Start; arm the postoffice BEFORE registration so the durable
    // version rides this shard's CMD_REGISTER and the scheduler can
    // commit the fleet-wide restore epoch.
    if (gl->server->restore_armed()) {
      gl->po->SetDurableCkpt(gl->server->durable_ckpt_version());
    }
    // Elastic worker membership: membership epochs land here
    // — a join pushes a new contributor roster, a removal rolls the
    // in-flight rounds back onto the survivors.
    gl->po->SetFleetResizeCallback(
        [gl](int kind, int affected, int64_t jr, int64_t jb, int tenant) {
          gl->server->OnFleetResize(kind, affected, jr, jb, tenant);
        });
  } else if (gl->role == ROLE_REPLICA) {
    // Read replica: a server engine in replica mode — it
    // owns a SnapStore fed by primary deltas and the CMD_SNAP_* serve
    // path, but never aggregates (no worker ever dials it for pushes).
    // Same ordering rule as the server branch: engine threads before
    // the postoffice accepts.
    gl->server = std::make_unique<BytePSServer>();
    gl->server->Start(gl->po.get(),
                      EnvInt("BYTEPS_SERVER_ENGINE_THREAD", 4),
                      /*async_mode=*/false,
                      EnvInt("BYTEPS_REPLICA_OF", 0));
    handler = [gl](Message&& m, int fd) {
      gl->server->Handle(std::move(m), fd);
    };
  } else if (gl->role == ROLE_WORKER) {
    gl->kv = std::make_unique<KVWorker>(
        gl->po.get(), EnvInt("BYTEPS_WORKER_CALLBACK_THREADS", 4));
    handler = [gl](Message&& m, int fd) {
      (void)fd;
      gl->kv->OnResponse(std::move(m));
    };
    gl->po->SetShutdownCallback([gl] { gl->kv->FailAllPending(); });
    gl->po->SetPeerLostCallback([gl](int node_id) {
      gl->kv->FailNode(node_id, "connection to node " +
                                    std::to_string(node_id) +
                                    " lost (peer died or was killed)");
    });
    // Transient path: a reset server connection that re-dialled
    // successfully drains this node's resend queue over the fresh
    // socket immediately (reconnect-with-backoff).
    gl->po->SetPeerReconnectedCallback([gl](int node_id) {
      gl->kv->ResendNode(node_id);
    });
    // Hot server replacement: a dead server rank under
    // scheduler-coordinated recovery freezes its retry clocks; the
    // RESUME (replacement redialled) re-seeds the shard and drains the
    // parked resend queue.
    gl->po->SetPeerPausedCallback([gl](int node_id) {
      gl->kv->PauseNode(node_id);
    });
    gl->po->SetPeerRecoveredCallback([gl](int node_id) {
      gl->worker->OnServerRecovered(node_id);
    });
    // Elastic worker membership: a JOIN gates new rounds and
    // acks the scheduler with this worker's counters; the RESUME syncs
    // counters to the activation round and lifts the gate.
    gl->po->SetFleetPauseCallback([gl](int kind) {
      gl->worker->OnFleetPause(kind);
    });
    gl->po->SetFleetResumeCallback(
        [gl](int kind, int affected, int64_t jr, int64_t jb) {
          (void)affected;
          gl->worker->OnFleetResume(kind, jr, jb);
        });
    // Scheduler fail-over: the CMD_REREGISTER a parked
    // worker sends carries its rounds-completed watermark, and a
    // committed recovery lifts any round gate a pre-crash FLEET_PAUSE
    // left armed (its membership op died with the old scheduler).
    gl->po->SetRoundWatermarkProvider(
        [gl]() -> int64_t { return gl->worker->MaxIssuedRound(); });
    gl->po->SetSchedRecoveredCallback(
        [gl] { gl->worker->OnSchedRecovered(); });
    // The worker pipeline exists BEFORE the postoffice starts (same
    // reasoning as the server's engine threads above): recovery
    // callbacks fire on van threads and must always find a live
    // BytePSWorker.
    gl->worker = std::make_unique<BytePSWorker>();
    gl->worker->Start(gl->po.get(), gl->kv.get(),
                      EnvInt64("BYTEPS_PARTITION_BYTES", 4096000),
                      EnvInt64("BYTEPS_SCHEDULING_CREDIT", 0),
                      // Small-tensor fusion: partitions under this many
                      // raw bytes coalesce into CMD_MULTI_PUSH frames
                      // (0 = off -> pre-fusion wire protocol verbatim).
                      EnvInt64("BYTEPS_FUSION_BYTES", 65536),
                      EnvInt("BYTEPS_FUSION_KEYS", 128),
                      DefaultCompConfig(), EnvBool("BYTEPS_TRACE_ON"));
  }

  // Event-journal identity must exist BEFORE the postoffice starts: on
  // a crash-restarted scheduler the whole re-register -> recovery-
  // commit window runs INSIDE Start(), and only role-0 emits enter the
  // fleet timeline directly. The scheduler's id is fixed (0); other
  // roles learn theirs when Start returns — their pre-topology records
  // carry node -1 and the scheduler backfills identity from the wire
  // chunk's header at ingest.
  Events::Get().SetNode(role, gl->role == ROLE_SCHEDULER ? 0 : -1);

  int id = gl->po->Start(gl->role, uri, port, nw, ns, std::move(handler));
  // Elastic joiner (DMLC_JOIN): the scheduler's direct ADDRBOOK carried
  // the round boundary this rank enters at — every tensor declared from
  // here starts its counters there, so the first push lands exactly in
  // the first round the new roster expects this rank in.
  if (gl->role == ROLE_WORKER && EnvBool("DMLC_JOIN")) {
    gl->worker->SyncRounds(gl->po->join_round(),
                           gl->po->join_bcast_round());
  }
  // Durable restore epoch: the ADDRBOOK carried the round
  // the fleet resumes from. Workers jump their counters past it so the
  // first post-restore push is round R+1 — the SyncRounds
  // machinery, driven by a disk-backed epoch instead of a join.
  if (gl->role == ROLE_WORKER && gl->po->restore_round() >= 0) {
    gl->worker->SyncRounds(gl->po->restore_round() + 1, 0);
    BPS_LOG(WARNING) << "worker: resuming from restored checkpoint "
                        "round " << gl->po->restore_round()
                     << " — counters jump to "
                     << gl->po->restore_round() + 1;
  }
  // Fleet tracing: identity for this rank's dump metadata,
  // plus the trace-health series pre-registered so every /metrics page
  // serves them from zero (monitor.top's TRACE-DROPPING flag).
  Trace::Get().SetNode(role, id,
                       gl->role == ROLE_WORKER ? gl->po->my_worker_rank()
                                               : -1);
  if (gl->role == ROLE_SCHEDULER) {
    Trace::Get().SetClock(0, 0);  // the scheduler IS the timebase
  }
  // Round-summary identity: stamps the heartbeat piggyback
  // so the scheduler's fleet table keys on real node ids.
  RoundStats::Get().SetNode(role, id);
  // Event-journal identity: same contract — wire chunks and
  // journal records carry the real node id from the first emit on.
  Events::Get().SetNode(role, id);
  Metrics::Get().Counter("bps_trace_events_total");
  Metrics::Get().Counter("bps_trace_dropped_total");
  Metrics::Get().Counter("bps_flight_dumps_total");
  Metrics::Get().Counter("bps_events_emitted_total");
  if (gl->role == ROLE_SCHEDULER) {
    Metrics::Get().Counter("bps_round_summaries_ingested_total");
    Metrics::Get().Counter("bps_events_ingested_total");
  }
  // Wire-CRC series pre-registration (satellite): where the
  // data-plane CRC is armed, its health counters must serve from zero
  // on every /metrics page — absent-until-first-corruption reads as
  // "CRC off" to dashboards, which is exactly backwards. Unarmed
  // builds keep the page byte-for-byte (same contract as the server
  // ctor's BYTEPS_CKPT_DIR-gated ckpt series).
  if (const char* crc = getenv("BYTEPS_WIRE_CRC");
      crc && *crc && *crc != '0') {
    Metrics::Get().Counter("bps_crc_fail_total");
    Metrics::Get().Counter("bps_crc_quarantine_total");
    Metrics::Get().Counter("bps_crc_quarantine_links_total");
    Metrics::Get().Gauge("bps_link_corrupting");
  }
  // Replica delta subscription starts only now: the poll loop dials the
  // primary out of the address book, which exists only after Start.
  if (gl->role == ROLE_REPLICA) {
    gl->server->StartReplicaPoll();
  }
  gl->inited = true;
  return id;
}

void bps_finalize() {
  Global* gl = g();
  if (!gl->inited) return;
  // Same drain-first order as ~Global (see its comment).
  if (gl->kv) gl->kv->StopExec();
  if (gl->worker) gl->worker->Stop();
  gl->po->Finalize();
  if (gl->server) gl->server->Stop();
  gl->inited = false;
}

// 1 when this node saw a FAILURE shutdown (scheduler dead-node
// broadcast, arg0=1, or a lost scheduler connection) rather than the
// clean all-goodbyes teardown. Valid after finalize — server/scheduler
// entry points use it to exit nonzero so supervisors can tell crash
// from completion.
int bps_failure_shutdown() {
  Global* gl = g();
  return gl->po && gl->po->FailureShutdown() ? 1 : 0;
}

int bps_my_id() { return g()->po->my_id(); }
int bps_worker_rank() { return g()->po->my_worker_rank(); }
int bps_num_workers() { return g()->po->num_workers(); }
int bps_num_servers() { return g()->po->num_servers(); }

// Fleet membership epoch (bumped per server recovery AND per worker
// join/leave/shrink). Live: num_workers above also
// tracks elastic membership changes.
long long bps_epoch() {
  Global* gl = g();
  return gl->po ? gl->po->epoch() : 0;
}

// Graceful leave: drain this worker's in-flight requests,
// tell the scheduler, and wait for the removal ack. After a 0 return
// the process should call bps_finalize and exit — it is out of the
// fleet's shutdown quorum and owes no goodbye. -1 = not a worker, the
// scheduler never acked (elasticity off?), or requests still pending.
int bps_leave() {
  Global* gl = g();
  if (!gl->inited || gl->role != ROLE_WORKER || !gl->kv) return -1;
  // The caller should have waited its handles; this drains whatever
  // bookkeeping is left so the LEAVE provably follows the last settle.
  gl->kv->WaitAll();
  return gl->po->RequestLeave() ? 0 : -1;
}

void bps_barrier(int group) { g()->po->Barrier(group); }

long long bps_declare(const char* name, long long nelem, int dtype,
                      const char* comp_config) {
  return g()->worker->Declare(name, nelem, dtype,
                              comp_config ? comp_config : "__default__");
}

int bps_push_pull(long long tensor_id, void* ptr, long long nelem, int dtype,
                  int average, int async_mode) {
  return g()->worker->PushPull(tensor_id, ptr, nelem, dtype, average != 0,
                               async_mode != 0);
}

int bps_broadcast(long long tensor_id, void* ptr, long long nelem, int dtype,
                  int root) {
  return g()->worker->Broadcast(tensor_id, ptr, nelem, dtype, root);
}

// 0 = success; -1 = the handle failed fast (dead peer) — fetch the
// diagnostic with bps_last_error().
int bps_wait(int handle) { return g()->worker->Wait(handle); }
int bps_poll(int handle) { return g()->worker->Poll(handle); }

const char* bps_last_error() {
  static thread_local std::string err;
  err = g()->worker ? g()->worker->LastError() : "";
  return err.c_str();
}

// Dump accumulated trace events as Chrome trace-event JSON (reference:
// BYTEPS_TRACE_ON timeline, SURVEY.md §5). Returns number of events.
// Works for EVERY role (the ring is process-wide, not
// worker-owned) and prepends a `meta` object — role, node id, and the
// heartbeat-derived clock offset vs the scheduler — that the fleet
// merge tool (python -m byteps_tpu.monitor.timeline) aligns ranks with.
// Drains the ring: dump-once timeline semantics, as before.
int bps_dump_trace(const char* path) {
  return static_cast<int>(Trace::Get().DumpMain(path));
}

// Snapshot the always-on flight recorder (BYTEPS_FLIGHT_RECORDER) to
// `path`, or to the default <BYTEPS_TRACE_DIR>/flight_r<role>_n<id>.json
// when path is NULL/empty. Non-draining: the recorder keeps recording.
// The same dump fires automatically on fatal CHECK, failure SHUTDOWN,
// and recovery EPOCH_PAUSE/RESUME.
int bps_dump_flight(const char* path) {
  if (path && *path) {
    return static_cast<int>(Trace::Get().DumpFlight(path));
  }
  return static_cast<int>(Trace::Get().FlightDumpAuto("manual"));
}

// Report the current training step for the BYTEPS_TRACE_START_STEP /
// _END_STEP window (utils.Timeline calls this once per step). Steps
// never reported leave the window open — raw-FFI users keep the old
// always-recording behavior; with steps reported, recording stops
// outside the window instead of accumulating without bound.
void bps_trace_step(int step) { Trace::Get().SetStep(step); }

// App-level annotation: record an instant into the main trace ring and
// the flight recorder (also the test hook for ring wraparound).
void bps_trace_note(const char* name, long long key) {
  if (name) Trace::Get().Note(name, key);
}

// Compressor roundtrip probe (no topology needed): encode `n` float32
// elements of `src` with the codec built from `config`, decode into
// `dst`, and return the encoded byte count. Errors are returned, not
// CHECK-crashed, so tests can assert on them: -1 = bad/empty config,
// -2 = non-finite input (the in-core push path CHECK-crashes on the
// same condition — "error loudly rather than encode garbage").
long long bps_compressor_roundtrip(const char* config, const void* src,
                                   long long n, void* dst) {
  if (!config || !src || !dst || n <= 0) return -1;
  const float* s = static_cast<const float*>(src);
  for (long long i = 0; i < n; ++i) {
    if (!(std::fabs(s[i]) <= std::numeric_limits<float>::max())) {
      return -2;
    }
  }
  // Pre-validate the type: CreateCompressor treats an unknown type as a
  // fatal misconfiguration (BPS_FATAL), which a probe must not be.
  auto kv = ParseCompressorConfig(config);
  auto type_it = kv.find("type");
  if (type_it == kv.end() ||
      (type_it->second != "onebit" && type_it->second != "topk" &&
       type_it->second != "randomk" && type_it->second != "dithering")) {
    return -1;
  }
  std::unique_ptr<Compressor> c = CreateCompressor(config, n);
  if (!c) return -1;
  std::vector<char> enc;
  c->Compress(s, n, &enc);
  c->Decompress(enc.data(), static_cast<int64_t>(enc.size()),
                static_cast<float*>(dst), n);
  return static_cast<long long>(enc.size());
}

// BlockQuant (wire codec) roundtrip probe: encode `src` with
// the given block, decode into `dst`, return encoded bytes. -1 = an
// invalid block (not a power of two in [16, 32768]) or bad args,
// -2 = non-finite input refused by the encoder.
long long bps_quant_roundtrip(const void* src, long long n, int block,
                              void* dst) {
  if (!src || !dst || n <= 0) return -1;
  if (!BlockQuant::ValidBlock(block)) return -1;
  std::vector<char> enc;
  if (!BlockQuant::Encode(static_cast<const float*>(src), n, block,
                          &enc)) {
    return -2;
  }
  if (!BlockQuant::Decode(enc.data(), static_cast<int64_t>(enc.size()),
                          static_cast<float*>(dst), n)) {
    return -1;
  }
  return static_cast<long long>(enc.size());
}

// Elastic epoch-roster / rollback probe (no topology needed):
// drives one RosterHistory + one key-slot contribution roster through a
// `;`-separated script and writes the final state as JSON into `buf`
// (same grow-the-buffer contract as bps_metrics_snapshot). Ops:
//   live:1,2,3   install the initial roster (ids)
//   join:5@8     id 5 joins, activating at round 8 (both round spaces)
//   remove:2     id 2 leaves/dies: erased from every roster AND its
//                retained slot contribution discarded (the rollback)
//   push:3       id 3 contributes 4 floats of value 3 to the slot
//   pull:3       id 3 pulled the slot's round
//   seal / reset round-ready / slot-recycle bookkeeping
//   round:8      the round number ready/served are evaluated against
// Output: {"roster":[...],"pushers":[...],"pullers":[...],
//          "ready":bool,"served":bool,"sum":[4 ints]} — `sum` is the
// slot rebuilt from the SURVIVING contributions (ascending sender id),
// i.e. exactly what the server's shrink rollback installs. Returns the
// JSON length, or -1 on a malformed script.
long long bps_elastic_probe(const char* script, char* buf,
                            long long maxlen) {
  if (!script) return -1;
  RosterHistory roster;
  ElasticSlot slot;
  long long round = 0;
  const std::string s(script);
  auto parse_ids = [](const std::string& v) {
    std::set<int> out;
    size_t p = 0;
    while (p < v.size()) {
      size_t c = v.find(',', p);
      if (c == std::string::npos) c = v.size();
      out.insert(atoi(v.substr(p, c - p).c_str()));
      p = c + 1;
    }
    return out;
  };
  size_t pos = 0;
  while (pos < s.size()) {
    size_t end = s.find(';', pos);
    if (end == std::string::npos) end = s.size();
    const std::string tok = s.substr(pos, end - pos);
    pos = end + 1;
    if (tok.empty()) continue;
    const size_t colon = tok.find(':');
    const std::string op = tok.substr(0, colon);
    const std::string val =
        colon == std::string::npos ? "" : tok.substr(colon + 1);
    if (op == "live") {
      roster.Init(parse_ids(val));
    } else if (op == "join") {
      const size_t at = val.find('@');
      const int id = atoi(val.substr(0, at).c_str());
      const long long r =
          at == std::string::npos ? 0 : atoll(val.substr(at + 1).c_str());
      roster.Join(id, r, r);
    } else if (op == "remove") {
      const int id = atoi(val.c_str());
      roster.Remove(id);
      slot.Remove(id);
    } else if (op == "push") {
      const int id = atoi(val.c_str());
      const float v[4] = {static_cast<float>(id), static_cast<float>(id),
                          static_cast<float>(id), static_cast<float>(id)};
      slot.Push(id, reinterpret_cast<const char*>(v), sizeof(v));
    } else if (op == "pull") {
      slot.Pull(atoi(val.c_str()));
    } else if (op == "seal") {
      slot.SealPushes();
    } else if (op == "reset") {
      slot.Reset();
    } else if (op == "round") {
      round = atoll(val.c_str());
    } else {
      return -1;
    }
  }
  auto ro = roster.OfRound(round);
  float sum[4] = {0, 0, 0, 0};
  const bool have_sum = slot.RebuildSum(reinterpret_cast<char*>(sum),
                                        sizeof(sum), BPS_FLOAT32);
  std::string out = "{";
  auto emit_set = [&out](const char* name, const std::set<int>& v) {
    out += std::string("\"") + name + "\":[";
    bool first = true;
    for (int id : v) {
      if (!first) out += ",";
      first = false;
      out += std::to_string(id);
    }
    out += "]";
  };
  emit_set("roster", *ro);
  out += ",";
  emit_set("pushers", slot.pushers());
  out += ",";
  emit_set("pullers", slot.pullers());
  out += ",\"ready\":";
  out += (!ro->empty() && slot.PushersMatch(*ro)) ? "true" : "false";
  out += ",\"served\":";
  out += (!ro->empty() && slot.PullersCover(*ro)) ? "true" : "false";
  out += ",\"sum\":[";
  if (have_sum) {
    for (int i = 0; i < 4; ++i) {
      if (i) out += ",";
      out += std::to_string(static_cast<long long>(sum[i]));
    }
  }
  out += "]}";
  const long long need = static_cast<long long>(out.size());
  if (buf && maxlen > 0) {
    long long n = need < maxlen - 1 ? need : maxlen - 1;
    memcpy(buf, out.data(), static_cast<size_t>(n));
    buf[n] = '\0';
  }
  return need;
}

// Scheduler fail-over reconstruction probe: drives the
// standalone SchedRecovery arithmetic — quorum counting, epoch
// max-adoption, split-brain conflict, rank high-water mark, tenant
// roster rebuild, heartbeat seeding, window expiry — with NO fleet.
// Script: `;`-separated ops:
//   servers:2         fleet has 2 server ranks (NextWorkerId base)
//   book:1,2,3,4      the TEMPLATE address book for later reports (ids;
//                     scheduler 0 auto-included; 1..servers = servers,
//                     the rest workers). Change it between reports to
//                     fabricate a same-epoch conflict.
//   tenant:5=2        template: worker id 5 belongs to tenant 2
//   report:3@7        node 3 re-registers at epoch 7 with the current
//                     template book. Optional `,hint,rounds` suffix:
//                     report:3@7,9,120
//   window:0,5000,4000  evaluate Expired(now=5000, start=0, win=4000)
//   seed:1000,2000    evaluate SeedHeartbeats(commit=1000) and
//                     EarliestDeathMs with timeout=2000
// Output: {"reregistered":N,"expected":[ids],"quorum":b,"conflict":b,
//          "epoch":E,"next_worker":id,"rosters":{"t":[ids],...},
//          "rounds":W,"book":[ids],"expired":b,"seeds":N,
//          "seed_min":ms,"earliest_death":ms}. Returns the JSON
// length (call again with a bigger buffer if it exceeds maxlen), or
// -1 on a malformed script.
long long bps_sched_probe(const char* script, char* buf,
                          long long maxlen) {
  if (!script) return -1;
  SchedRecovery rec;
  int num_servers = 1;
  std::vector<NodeInfo> tmpl;
  std::map<int, int> tenants;
  bool expired = false;
  int64_t seed_commit = -1, seed_timeout = 0;
  const std::string s(script);
  auto make_book = [&]() {
    std::vector<NodeInfo> out;
    NodeInfo sched{};
    sched.id = kSchedulerId;
    sched.role = ROLE_SCHEDULER;
    out.push_back(sched);
    for (const auto& n : tmpl) out.push_back(n);
    return out;
  };
  size_t pos = 0;
  while (pos < s.size()) {
    size_t end = s.find(';', pos);
    if (end == std::string::npos) end = s.size();
    const std::string tok = s.substr(pos, end - pos);
    pos = end + 1;
    if (tok.empty()) continue;
    const size_t colon = tok.find(':');
    const std::string op = tok.substr(0, colon);
    const std::string val =
        colon == std::string::npos ? "" : tok.substr(colon + 1);
    if (op == "servers") {
      num_servers = atoi(val.c_str());
    } else if (op == "book") {
      tmpl.clear();
      size_t p = 0;
      while (p < val.size()) {
        size_t c = val.find(',', p);
        if (c == std::string::npos) c = val.size();
        const int id = atoi(val.substr(p, c - p).c_str());
        p = c + 1;
        NodeInfo n{};
        n.id = id;
        n.role = (id >= 1 && id <= num_servers) ? ROLE_SERVER
                                                : ROLE_WORKER;
        n.tenant = static_cast<uint16_t>(tenants.count(id)
                                             ? tenants[id] : 0);
        snprintf(n.host, sizeof(n.host), "127.0.0.1");
        n.port = 9000 + id;
        tmpl.push_back(n);
      }
    } else if (op == "tenant") {
      const size_t eq = val.find('=');
      if (eq == std::string::npos) return -1;
      const int id = atoi(val.substr(0, eq).c_str());
      const int t = atoi(val.substr(eq + 1).c_str());
      tenants[id] = t;
      for (auto& n : tmpl) {
        if (n.id == id) n.tenant = static_cast<uint16_t>(t);
      }
    } else if (op == "report") {
      const size_t at = val.find('@');
      if (at == std::string::npos) return -1;
      const int id = atoi(val.substr(0, at).c_str());
      std::string rest = val.substr(at + 1);
      int64_t epoch = atoll(rest.c_str());
      int64_t hint = 0, rounds = 0;
      size_t c1 = rest.find(',');
      if (c1 != std::string::npos) {
        hint = atoll(rest.substr(c1 + 1).c_str());
        size_t c2 = rest.find(',', c1 + 1);
        if (c2 != std::string::npos) {
          rounds = atoll(rest.substr(c2 + 1).c_str());
        }
      }
      SchedRecovery::Report r;
      r.epoch = epoch;
      r.rank_hint = hint;
      r.rounds = rounds;
      r.book = make_book();
      r.self.id = id;
      for (const auto& n : r.book) {
        if (n.id == id) r.self = n;
      }
      rec.Ingest(id, std::move(r));
    } else if (op == "window") {
      long long a = 0, b = 0, w = 0;
      if (sscanf(val.c_str(), "%lld,%lld,%lld", &a, &b, &w) != 3) {
        return -1;
      }
      expired = SchedRecovery::Expired(b, a, w);
    } else if (op == "seed") {
      long long c = 0, t = 0;
      if (sscanf(val.c_str(), "%lld,%lld", &c, &t) != 2) return -1;
      seed_commit = c;
      seed_timeout = t;
    } else {
      return -1;
    }
  }
  std::string out = "{";
  out += "\"reregistered\":" + std::to_string(rec.Reregistered());
  out += ",\"expected\":[";
  {
    bool first = true;
    for (int id : rec.ExpectedIds()) {
      if (!first) out += ",";
      first = false;
      out += std::to_string(id);
    }
  }
  out += "],\"quorum\":";
  out += rec.QuorumMet() ? "true" : "false";
  out += ",\"conflict\":";
  out += rec.Conflict() ? "true" : "false";
  out += ",\"epoch\":" + std::to_string(rec.AdoptedEpoch());
  out += ",\"next_worker\":" +
         std::to_string(rec.NextWorkerId(num_servers));
  out += ",\"rosters\":{";
  {
    bool tfirst = true;
    for (const auto& kv : rec.TenantRosters()) {
      if (!tfirst) out += ",";
      tfirst = false;
      out += "\"" + std::to_string(kv.first) + "\":[";
      bool first = true;
      for (int id : kv.second) {
        if (!first) out += ",";
        first = false;
        out += std::to_string(id);
      }
      out += "]";
    }
  }
  out += "},\"rounds\":" + std::to_string(rec.RoundsWatermark());
  out += ",\"book\":[";
  {
    bool first = true;
    for (const auto& n : rec.RebuiltBook()) {
      if (!first) out += ",";
      first = false;
      out += std::to_string(n.id);
    }
  }
  out += "],\"expired\":";
  out += expired ? "true" : "false";
  {
    const auto seeds = rec.SeedHeartbeats(seed_commit < 0 ? 0
                                                          : seed_commit);
    int64_t seed_min = 0;
    for (const auto& kv : seeds) {
      if (seed_min == 0 || kv.second < seed_min) seed_min = kv.second;
    }
    out += ",\"seeds\":" + std::to_string(seeds.size());
    out += ",\"seed_min\":" + std::to_string(seed_min);
    out += ",\"earliest_death\":" +
           std::to_string(seed_commit < 0
                              ? 0
                              : SchedRecovery::EarliestDeathMs(
                                    seed_commit, seed_timeout));
  }
  out += "}";
  const long long need = static_cast<long long>(out.size());
  if (buf && maxlen > 0) {
    long long n = need < maxlen - 1 ? need : maxlen - 1;
    memcpy(buf, out.data(), static_cast<size_t>(n));
    buf[n] = '\0';
  }
  return need;
}

// Standalone CpuReducer throughput probe: repeatedly sum a src buffer
// into dst (the server's hot loop) and return GB/s of summed INPUT
// bytes. Callable without any topology (SURVEY.md §7 hard part #5:
// server summation must not be the bottleneck — measure it).
double bps_reducer_bench(long long nbytes, int iters, int dtype) {
  if (nbytes <= 0 || iters <= 0 || DtypeSize(dtype) == 0) return -1.0;
  // 0x3C byte fill: normal-range values in every float format (fp16
  // 0x3C3C ~= 1.06, f32 0x3C3C3C3C ~= 0.011) — a 0x01 fill would make
  // fp16 lanes subnormal and measure the worst-case conversion branch
  // instead of typical gradient values.
  std::vector<char> dst(nbytes, 0x3C), src(nbytes, 0x3D);
  CpuReducer::Sum(dst.data(), src.data(), nbytes, dtype);  // warm
  auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i) {
    CpuReducer::Sum(dst.data(), src.data(), nbytes, dtype);
  }
  double s = std::chrono::duration<double>(
                 std::chrono::steady_clock::now() - t0)
                 .count();
  return static_cast<double>(nbytes) * iters / s / 1e9;
}

// One-call telemetry snapshot for the byteps_tpu.monitor subsystem:
// the whole metric registry (counters / gauges / latency histograms
// instrumented at every pipeline stage) plus the live node state that
// used to be three ad-hoc C APIs — van wire bytes, async staleness,
// scheduler dead nodes — and the scheduled-queue occupancy. Writes a
// JSON document into `buf` (NUL-terminated, truncated if needed) and
// returns the FULL length required excluding the NUL; callers retry
// with a bigger buffer when the return value >= maxlen. Callable in any
// state (before init, after finalize): sections without a live owner
// are emptied, the registry (process-cumulative) is always present.
long long bps_metrics_snapshot(char* buf, long long maxlen) {
  Global* gl = g();
  std::string out = "{";
  out += Metrics::Get().SnapshotJson();

  Postoffice* po = gl->inited ? gl->po.get() : nullptr;
  out += ",\"node\":{";
  out += "\"inited\":" + std::string(gl->inited ? "true" : "false");
  if (po) {
    out += ",\"role\":" + std::to_string(gl->role);
    out += ",\"id\":" + std::to_string(po->my_id());
    out += ",\"num_workers\":" + std::to_string(po->num_workers());
    out += ",\"num_servers\":" + std::to_string(po->num_servers());
    if (gl->role == ROLE_WORKER) {
      out += ",\"worker_rank\":" + std::to_string(po->my_worker_rank());
    }
  }
  out += "}";

  out += ",\"van\":{\"sent_bytes\":";
  out += std::to_string(po ? po->van().bytes_sent() : 0);
  out += ",\"recv_bytes\":";
  out += std::to_string(po ? po->van().bytes_recv() : 0);
  out += "}";

  BytePSWorker* w = gl->inited ? gl->worker.get() : nullptr;
  long long ssum = 0, smax = 0, scnt = 0;
  if (w) w->StalenessStats(&ssum, &smax, &scnt);
  char stale[128];
  snprintf(stale, sizeof(stale),
           ",\"staleness\":{\"mean\":%.3f,\"max\":%lld,\"samples\":%lld}",
           scnt > 0 ? static_cast<double>(ssum) / scnt : 0.0, smax, scnt);
  out += stale;

  int64_t qp = 0, qi = 0, qb = 0;
  if (w) w->QueueStats(&qp, &qi, &qb);
  out += ",\"queue\":{\"pending\":" + std::to_string(qp);
  out += ",\"inflight_bytes\":" + std::to_string(qi);
  out += ",\"credit_budget_bytes\":" + std::to_string(qb) + "}";

  // Multi-tenant section: this process's tenant identity,
  // the per-tenant accounting registry (servers: bytes / ops / queue
  // depth / sum time / DRR dispatch + starvation age), and — when the
  // address book is known — the tenant -> (workers, weight) roster.
  // monitor/metrics.py renders these as bps_tenant_*{tenant="N"}
  // labeled series; monitor/http.py serves them raw at /tenants.
  out += ",\"tenants\":{\"local\":{\"id\":" +
         std::to_string(TenantId());
  out += ",\"name\":\"" + TenantName() + "\"";
  out += ",\"weight\":" + std::to_string(TenantWeight()) + "}";
  out += ",\"stats\":" + Tenancy::Get().SnapshotJson(NowUs());
  out += ",\"roster\":{";
  if (po) {
    bool first = true;
    for (const auto& kv : po->TenantRoster()) {
      if (!first) out += ",";
      first = false;
      out += "\"" + std::to_string(kv.first) + "\":{\"workers\":" +
             std::to_string(kv.second.first) +
             ",\"weight\":" + std::to_string(kv.second.second) + "}";
    }
  }
  out += "}}";

  out += ",\"heartbeat_age_ms\":{";
  if (po && gl->role == ROLE_SCHEDULER) {
    bool first = true;
    for (const auto& kv : po->HeartbeatAges()) {
      if (!first) out += ",";
      first = false;
      out += "\"" + std::to_string(kv.first) +
             "\":" + std::to_string(kv.second);
    }
  }
  out += "},\"dead_nodes\":[";
  if (po) {
    bool first = true;
    for (int id : po->DeadNodes()) {
      if (!first) out += ",";
      first = false;
      out += std::to_string(id);
    }
  }
  out += "]}";

  long long need = static_cast<long long>(out.size());
  if (buf && maxlen > 0) {
    long long n = need < maxlen - 1 ? need : maxlen - 1;
    memcpy(buf, out.data(), static_cast<size_t>(n));
    buf[n] = '\0';
  }
  return need;
}

// Per-round introspection snapshot: this rank's round ring
// (oldest -> newest), the most recent completed round, and — on a rank
// that ingested heartbeat summaries, i.e. the scheduler — the fleet's
// per-rank EWMA baselines and bounded round table. Same buffer contract
// as bps_metrics_snapshot: returns the full length required; callers
// retry with a bigger buffer when the return value >= maxlen. Served
// live at the monitor endpoint's /rounds path and consumed by
// python -m byteps_tpu.monitor.insight.
long long bps_round_summary(char* buf, long long maxlen) {
  std::string out = RoundStats::Get().SnapshotJson();
  long long need = static_cast<long long>(out.size());
  if (buf && maxlen > 0) {
    long long n = need < maxlen - 1 ? need : maxlen - 1;
    memcpy(buf, out.data(), static_cast<size_t>(n));
    buf[n] = '\0';
  }
  return need;
}

// Feed one accumulation event into the round-summary layer from outside
// the C core (stage = RoundStage). This IS the production path — the
// ring/finalize unit tests drive wraparound and drop counters through
// it without a topology, and a Python-side training loop can report
// host-level stages into the same per-round records.
void bps_round_track(int stage, int round, long long us,
                     long long bytes) {
  RoundStats::Get().Track(stage, round, us, bytes);
}

// Ingest a serialized heartbeat round-summary sub-payload (the exact
// wire bytes a worker piggybacks). Returns 1 if accepted, 0 if the
// payload was not a recognized summary — the version-interop contract
// the tests pin down.
int bps_round_ingest(const void* data, long long len) {
  if (!data || len <= 0) return 0;
  return RoundStats::Get().Ingest(data, static_cast<size_t>(len)) ? 1
                                                                  : 0;
}

// This process's tenant id (BYTEPS_TENANT_ID; 0 = legacy/default).
int bps_tenant_id() { return TenantId(); }

// Multi-tenant snapshot: the same "tenants" section
// bps_metrics_snapshot embeds — local identity, per-tenant accounting,
// and the address-book roster — as a standalone JSON document for the
// /tenants monitor endpoint. Same buffer contract as the other
// snapshot probes.
long long bps_tenant_summary(char* buf, long long maxlen) {
  Global* gl = g();
  Postoffice* po = gl->inited ? gl->po.get() : nullptr;
  std::string out = "{\"local\":{\"id\":" + std::to_string(TenantId());
  out += ",\"name\":\"" + TenantName() + "\"";
  out += ",\"weight\":" + std::to_string(TenantWeight()) + "}";
  out += ",\"quantum_bytes\":" + std::to_string(TenantQuantum());
  out += ",\"stats\":" + Tenancy::Get().SnapshotJson(NowUs());
  out += ",\"roster\":{";
  if (po) {
    bool first = true;
    for (const auto& kv : po->TenantRoster()) {
      if (!first) out += ",";
      first = false;
      out += "\"" + std::to_string(kv.first) + "\":{\"workers\":" +
             std::to_string(kv.second.first) +
             ",\"weight\":" + std::to_string(kv.second.second) + "}";
    }
  }
  out += "}}";
  long long need = static_cast<long long>(out.size());
  if (buf && maxlen > 0) {
    long long n = need < maxlen - 1 ? need : maxlen - 1;
    memcpy(buf, out.data(), static_cast<size_t>(n));
    buf[n] = '\0';
  }
  return need;
}

// Weighted-DRR / namespacing probe (no topology needed):
// drives one WeightedDrr instance plus the TenantKey arithmetic
// through a `;`-separated script and writes the final state as JSON
// (same grow-the-buffer contract as bps_metrics_snapshot). Ops:
//   quantum:N     set the DRR base quantum (before the first enq)
//   weight:T=W    set tenant T's weight
//   enq:T@C       enqueue an item of cost C for tenant T
//   pop:N         dispatch N items (clamped to what is queued)
//   key:T@K       append TenantKey(T, K) to "keys"
//   route:T@K@Q   append TenantKey(T, K) % Q to "routes"
// Output: {"order":[[tenant,cost],...],"served":{"T":cost_total},
//          "keys":[...],"routes":[...],"remaining":N} — `order` is the
// exact dispatch sequence, the contract the fair-share and FIFO unit
// tests pin down. Returns the JSON length, or -1 on a bad script.
long long bps_tenant_probe(const char* script, char* buf,
                           long long maxlen) {
  if (!script) return -1;
  int64_t quantum = 0;
  std::map<uint16_t, int> weights;
  std::unique_ptr<WeightedDrr> drr;
  auto ensure = [&]() {
    if (!drr) {
      drr = std::make_unique<WeightedDrr>(
          quantum, [&weights](uint16_t t) {
            auto it = weights.find(t);
            return it == weights.end() ? 1 : it->second;
          });
    }
  };
  std::vector<std::pair<uint16_t, int64_t>> order;
  std::map<uint16_t, int64_t> served;
  std::vector<long long> keys, routes;
  const std::string s(script);
  size_t pos = 0;
  while (pos < s.size()) {
    size_t end = s.find(';', pos);
    if (end == std::string::npos) end = s.size();
    const std::string tok = s.substr(pos, end - pos);
    pos = end + 1;
    if (tok.empty()) continue;
    const size_t colon = tok.find(':');
    if (colon == std::string::npos) return -1;
    const std::string op = tok.substr(0, colon);
    const std::string val = tok.substr(colon + 1);
    if (op == "quantum") {
      quantum = atoll(val.c_str());
    } else if (op == "weight") {
      const size_t eq = val.find('=');
      if (eq == std::string::npos) return -1;
      weights[static_cast<uint16_t>(atoi(val.substr(0, eq).c_str()))] =
          atoi(val.substr(eq + 1).c_str());
    } else if (op == "enq") {
      const size_t at = val.find('@');
      if (at == std::string::npos) return -1;
      ensure();
      drr->Enqueue(
          static_cast<uint16_t>(atoi(val.substr(0, at).c_str())),
          atoll(val.substr(at + 1).c_str()));
    } else if (op == "pop") {
      ensure();
      long long n = atoll(val.c_str());
      while (n-- > 0 && !drr->Empty()) {
        int64_t cost = 0;
        const uint16_t t = drr->PickAndPop(&cost);
        order.emplace_back(t, cost);
        served[t] += cost;
      }
    } else if (op == "key") {
      const size_t at = val.find('@');
      if (at == std::string::npos) return -1;
      keys.push_back(TenantKey(
          static_cast<uint16_t>(atoi(val.substr(0, at).c_str())),
          atoll(val.substr(at + 1).c_str())));
    } else if (op == "route") {
      const size_t a1 = val.find('@');
      const size_t a2 = a1 == std::string::npos
                            ? std::string::npos
                            : val.find('@', a1 + 1);
      if (a2 == std::string::npos) return -1;
      const uint16_t t =
          static_cast<uint16_t>(atoi(val.substr(0, a1).c_str()));
      const long long k = atoll(val.substr(a1 + 1, a2 - a1 - 1).c_str());
      const long long q = atoll(val.substr(a2 + 1).c_str());
      if (q <= 0) return -1;
      routes.push_back(static_cast<long long>(
          static_cast<size_t>(TenantKey(t, k)) %
          static_cast<size_t>(q)));
    } else {
      return -1;
    }
  }
  std::string out = "{\"order\":[";
  for (size_t i = 0; i < order.size(); ++i) {
    if (i) out += ",";
    out += "[" + std::to_string(order[i].first) + "," +
           std::to_string(order[i].second) + "]";
  }
  out += "],\"served\":{";
  bool first = true;
  for (const auto& kv : served) {
    if (!first) out += ",";
    first = false;
    out += "\"" + std::to_string(kv.first) +
           "\":" + std::to_string(kv.second);
  }
  out += "},\"keys\":[";
  for (size_t i = 0; i < keys.size(); ++i) {
    if (i) out += ",";
    out += std::to_string(keys[i]);
  }
  out += "],\"routes\":[";
  for (size_t i = 0; i < routes.size(); ++i) {
    if (i) out += ",";
    out += std::to_string(routes[i]);
  }
  out += "],\"remaining\":" +
         std::to_string(drr ? static_cast<long long>(drr->Size()) : 0);
  out += "}";
  const long long need = static_cast<long long>(out.size());
  if (buf && maxlen > 0) {
    long long n = need < maxlen - 1 ? need : maxlen - 1;
    memcpy(buf, out.data(), static_cast<size_t>(n));
    buf[n] = '\0';
  }
  return need;
}

// Wire-layout pin for the A/B byte-identity test: serialize
// a MsgHeader with the given cmd/tenant/key/version into `buf` (which
// must hold sizeof(MsgHeader) = 64 bytes) and return its size. A
// tenant-0 header must be byte-for-byte the pre-tenant layout — the
// Python test asserts it against a struct.pack reference.
int bps_wire_header_probe(int cmd, int tenant, long long key,
                          int version, void* buf) {
  MsgHeader h{};
  h.cmd = static_cast<int16_t>(cmd);
  h.tenant = static_cast<uint16_t>(tenant);
  h.key = key;
  h.version = version;
  if (buf) memcpy(buf, &h, sizeof(h));
  return static_cast<int>(sizeof(h));
}

// Snapshot-store probe (no topology needed): drives one
// SnapStore — version monotonicity, complete-cut commit gating,
// retention-ring eviction, replica watermark adoption, delta
// collection — plus the CachedReplyValid stale-reply predicate through
// a `;`-separated script and writes the final state as JSON (same
// grow-the-buffer contract as the other probes). Ops:
//   retain:N        set the retention ring depth
//   publish:T,K,V   publish (tenant T, key K) at version V: 4 float32
//                   elements all equal to V (+ a fake quant sidecar
//                   when the op is `publishq`). Appends the Publish
//                   return (accepted/rejected) to "published".
//   publishq:T,K,V  as publish, with a quant sidecar attached
//   force:V         ForceLatest(V) — the replica adoption path
//   pull:T,K,V      Get (V = -1 means `latest`); appends
//                   [code, resolved, first_float, has_quant] to "pulls"
//   oldest:T,K      appends OldestOf to "oldest"
//   collect:S,B     CollectNewer(since=S, max_bytes=B); appends
//                   [entry_count, through] to "collects"
//   tag:C,S,N       appends CachedReplyValid(cached=C, serve=S,
//                   nonempty=N!=0) to "tags"
// Output: {"latest":L,"keys":N,"publishes":P,"evictions":E,
//          "published":[...],"pulls":[...],"oldest":[...],
//          "collects":[...],"tags":[...]}. Returns the JSON length, or
// -1 on a malformed script.
long long bps_snap_probe(const char* script, char* buf,
                         long long maxlen) {
  if (!script) return -1;
  SnapStore store;
  std::vector<int> published;
  std::vector<std::string> pulls, collects;
  std::vector<long long> oldest;
  std::vector<bool> tags;
  const std::string s(script);
  size_t pos = 0;
  while (pos < s.size()) {
    size_t end = s.find(';', pos);
    if (end == std::string::npos) end = s.size();
    const std::string tok = s.substr(pos, end - pos);
    pos = end + 1;
    if (tok.empty()) continue;
    const size_t colon = tok.find(':');
    if (colon == std::string::npos) return -1;
    const std::string op = tok.substr(0, colon);
    const std::string val = tok.substr(colon + 1);
    if (op == "retain") {
      store.SetRetain(atoi(val.c_str()));
    } else if (op == "selfcommit") {
      // 0 = replica mode: publishes install but never advance `latest`
      // (only ForceLatest, the adopted primary watermark, commits).
      store.SetSelfCommit(atoi(val.c_str()) != 0);
    } else if (op == "publish" || op == "publishq") {
      long long t = 0, k = 0, v = 0;
      if (sscanf(val.c_str(), "%lld,%lld,%lld", &t, &k, &v) != 3) {
        return -1;
      }
      const float f = static_cast<float>(v);
      const float raw[4] = {f, f, f, f};
      // A recognizable fake quant sidecar: the version byte-repeated
      // (the probe only asserts presence + fidelity, not the codec).
      char quant[8];
      memset(quant, static_cast<int>(v & 0x7f), sizeof(quant));
      published.push_back(
          store.Publish(static_cast<uint16_t>(t), k, v, BPS_FLOAT32,
                        reinterpret_cast<const char*>(raw), sizeof(raw),
                        op == "publishq" ? quant : nullptr,
                        op == "publishq" ? sizeof(quant) : 0)
              ? 1
              : 0);
    } else if (op == "force") {
      store.ForceLatest(atoll(val.c_str()));
    } else if (op == "pull") {
      long long t = 0, k = 0, v = 0;
      if (sscanf(val.c_str(), "%lld,%lld,%lld", &t, &k, &v) != 3) {
        return -1;
      }
      SnapEntry e;
      int64_t resolved = -1;
      const int code =
          store.Get(static_cast<uint16_t>(t), k, v, &e, &resolved);
      float first = 0;
      if (code == SnapStore::OK && e.raw && e.raw->size() >= 4) {
        memcpy(&first, e.raw->data(), sizeof(first));
      }
      pulls.push_back("[" + std::to_string(code) + "," +
                      std::to_string(resolved) + "," +
                      std::to_string(static_cast<long long>(first)) +
                      "," + (e.quant ? "true" : "false") + "]");
    } else if (op == "oldest") {
      long long t = 0, k = 0;
      if (sscanf(val.c_str(), "%lld,%lld", &t, &k) != 2) return -1;
      oldest.push_back(store.OldestOf(static_cast<uint16_t>(t), k));
    } else if (op == "collect") {
      long long since = 0, maxb = 0;
      if (sscanf(val.c_str(), "%lld,%lld", &since, &maxb) != 2) {
        return -1;
      }
      int64_t through = since;
      const auto got = store.CollectNewer(
          since, static_cast<size_t>(maxb), &through);
      collects.push_back("[" + std::to_string(got.size()) + "," +
                         std::to_string(through) + "]");
    } else if (op == "tag") {
      long long c = 0, sv = 0, ne = 0;
      if (sscanf(val.c_str(), "%lld,%lld,%lld", &c, &sv, &ne) != 3) {
        return -1;
      }
      tags.push_back(CachedReplyValid(c, sv, ne != 0));
    } else {
      return -1;
    }
  }
  std::string out = "{\"latest\":" + std::to_string(store.latest());
  out += ",\"keys\":" + std::to_string(store.key_count());
  out += ",\"publishes\":" + std::to_string(store.publishes());
  out += ",\"evictions\":" + std::to_string(store.evictions());
  auto emit_list = [&out](const char* name,
                          const std::vector<std::string>& items) {
    out += std::string(",\"") + name + "\":[";
    for (size_t i = 0; i < items.size(); ++i) {
      if (i) out += ",";
      out += items[i];
    }
    out += "]";
  };
  out += ",\"published\":[";
  for (size_t i = 0; i < published.size(); ++i) {
    if (i) out += ",";
    out += std::to_string(published[i]);
  }
  out += "]";
  emit_list("pulls", pulls);
  out += ",\"oldest\":[";
  for (size_t i = 0; i < oldest.size(); ++i) {
    if (i) out += ",";
    out += std::to_string(oldest[i]);
  }
  out += "]";
  emit_list("collects", collects);
  out += ",\"tags\":[";
  for (size_t i = 0; i < tags.size(); ++i) {
    if (i) out += ",";
    out += tags[i] ? "true" : "false";
  }
  out += "]}";
  const long long need = static_cast<long long>(out.size());
  if (buf && maxlen > 0) {
    long long n = need < maxlen - 1 ? need : maxlen - 1;
    memcpy(buf, out.data(), static_cast<size_t>(n));
    buf[n] = '\0';
  }
  return need;
}

// Fleet-free durable-checkpoint probe (modeled on
// bps_snap_probe): drives the spill / scan / load / torn-rejection
// matrix against a real directory, no topology. Script DSL
// (semicolon-separated op:args):
//   dir:<path>      checkpoint root for all later ops
//   rank:<r>        shard rank for all later ops
//   chaos:<mode>    none | truncate | bitflip | sealflip (applied by
//                   later spills; truncate/bitflip corrupt a
//                   seeded-random chunk, sealflip the sealed MANIFEST)
//   spill:V,K       spill a synthetic K-key cut as version V; item i is
//                   16 float32s of value V*1000+i under tenant i%2 —
//                   deterministic, so load can assert fidelity
//   retain:N        CkptRetain(dir, rank, N)
//   scan:0          newest fully-valid version (-1 none)
//   list:0          all fully-valid versions, ascending
//   load:V          [ok, round, items, first] — first = item 0's first
//                   float (0 when the load failed)
//   tear:V,M        corrupt an EXISTING checkpoint: M=0 truncate the
//                   manifest to half, 1 truncate chunk_0, 2 bit-flip
//                   chunk_0 byte 0, 3 delete the manifest
//   crc:<text>      CRC32C of the literal text (known-vector check)
// Output: {"spills":[...],"scans":[...],"lists":[[...]],"loads":[...],
//          "tears":[...],"crcs":[...]}. Returns the JSON length, or -1
// on a malformed script.
long long bps_ckpt_probe(const char* script, char* buf, long long maxlen) {
  if (!script) return -1;
  std::string dir = ".";
  int rank = 0;
  std::string chaos;
  std::vector<int> spills, tears;
  std::vector<long long> scans;
  std::vector<std::string> lists, loads, crcs;
  const std::string s(script);
  size_t pos = 0;
  while (pos < s.size()) {
    size_t end = s.find(';', pos);
    if (end == std::string::npos) end = s.size();
    const std::string tok = s.substr(pos, end - pos);
    pos = end + 1;
    if (tok.empty()) continue;
    const size_t colon = tok.find(':');
    if (colon == std::string::npos) return -1;
    const std::string op = tok.substr(0, colon);
    const std::string val = tok.substr(colon + 1);
    if (op == "dir") {
      dir = val;
    } else if (op == "rank") {
      rank = atoi(val.c_str());
    } else if (op == "chaos") {
      chaos = val == "none" ? "" : val;
    } else if (op == "spill") {
      long long v = 0, k = 0;
      if (sscanf(val.c_str(), "%lld,%lld", &v, &k) != 2) return -1;
      std::vector<SnapDeltaEnt> cut;
      for (long long i = 0; i < k; ++i) {
        SnapDeltaEnt d;
        d.tenant = static_cast<uint16_t>(i % 2);
        d.key = i;
        d.entry.version = v;
        d.entry.dtype = BPS_FLOAT32;
        std::vector<char> raw(16 * sizeof(float));
        float f = static_cast<float>(v * 1000 + i);
        for (int j = 0; j < 16; ++j) {
          memcpy(raw.data() + j * sizeof(float), &f, sizeof(float));
        }
        d.entry.raw =
            std::make_shared<const std::vector<char>>(std::move(raw));
        cut.push_back(std::move(d));
      }
      std::string why;
      spills.push_back(
          CkptSpillSync(dir, rank, v, cut, 1, 1, chaos, &why) ? 1 : 0);
    } else if (op == "retain") {
      CkptRetain(dir, rank, atoi(val.c_str()));
    } else if (op == "scan") {
      std::string why;
      scans.push_back(CkptScan(dir, rank, &why));
    } else if (op == "list") {
      const auto got = CkptList(dir, rank);
      std::string l = "[";
      for (size_t i = 0; i < got.size(); ++i) {
        if (i) l += ",";
        l += std::to_string(static_cast<long long>(got[i]));
      }
      lists.push_back(l + "]");
    } else if (op == "load") {
      std::vector<CkptItem> items;
      int64_t round = -1;
      std::string why;
      const bool ok =
          CkptLoad(dir, rank, atoll(val.c_str()), &items, &round, &why);
      float first = 0;
      if (ok && !items.empty() &&
          items[0].data.size() >= sizeof(float)) {
        memcpy(&first, items[0].data.data(), sizeof(float));
      }
      loads.push_back("[" + std::to_string(ok ? 1 : 0) + "," +
                      std::to_string(static_cast<long long>(round)) +
                      "," + std::to_string(items.size()) + "," +
                      std::to_string(static_cast<long long>(first)) +
                      "]");
    } else if (op == "tear") {
      long long v = 0, mode = 0;
      if (sscanf(val.c_str(), "%lld,%lld", &v, &mode) != 2) return -1;
      const std::string base = dir + "/ckpt_v" + std::to_string(v) +
                               "_s" + std::to_string(rank);
      const std::string manifest = base + "/MANIFEST";
      const std::string chunk0 = base + "/chunk_0.bin";
      const std::string target = mode == 0 || mode == 3 ? manifest
                                                        : chunk0;
      int rc = -1;
      struct stat st{};
      if (stat(target.c_str(), &st) == 0) {
        if (mode == 0 || mode == 1) {
          rc = truncate(target.c_str(), st.st_size / 2);
        } else if (mode == 2) {
          int fd = open(target.c_str(), O_RDWR);
          if (fd >= 0) {
            char b = 0;
            if (pread(fd, &b, 1, 0) == 1) {
              b ^= 0x01;
              rc = pwrite(fd, &b, 1, 0) == 1 ? 0 : -1;
            }
            close(fd);
          }
        } else if (mode == 3) {
          rc = unlink(target.c_str());
        }
      }
      tears.push_back(rc == 0 ? 1 : 0);
    } else if (op == "crc") {
      char hex[16];
      snprintf(hex, sizeof(hex), "%u",
               Crc32c(val.data(), val.size()));
      crcs.push_back(hex);
    } else {
      return -1;
    }
  }
  auto emit_list = [](std::string* out, const char* name,
                      const std::vector<std::string>& items) {
    *out += std::string(",\"") + name + "\":[";
    for (size_t i = 0; i < items.size(); ++i) {
      if (i) *out += ",";
      *out += items[i];
    }
    *out += "]";
  };
  std::string out = "{\"spills\":[";
  for (size_t i = 0; i < spills.size(); ++i) {
    if (i) out += ",";
    out += std::to_string(spills[i]);
  }
  out += "]";
  out += ",\"scans\":[";
  for (size_t i = 0; i < scans.size(); ++i) {
    if (i) out += ",";
    out += std::to_string(scans[i]);
  }
  out += "]";
  emit_list(&out, "lists", lists);
  emit_list(&out, "loads", loads);
  out += ",\"tears\":[";
  for (size_t i = 0; i < tears.size(); ++i) {
    if (i) out += ",";
    out += std::to_string(tears[i]);
  }
  out += "]";
  emit_list(&out, "crcs", crcs);
  out += "}";
  const long long need = static_cast<long long>(out.size());
  if (buf && maxlen > 0) {
    long long n = need < maxlen - 1 ? need : maxlen - 1;
    memcpy(buf, out.data(), static_cast<size_t>(n));
    buf[n] = '\0';
  }
  return need;
}

// The fleet-committed restore epoch this node learned from the address
// book (-1 = none). Workers use it to label results; tests assert the
// whole fleet agreed on one epoch.
long long bps_restore_round() {
  Global* gl = g();
  if (!gl->inited || !gl->po) return -1;
  return gl->po->restore_round();
}

// Record into the registry from outside the C core: kind is "counter"
// (add v), "gauge" (set v) or "histo" (observe v, microseconds). Used
// by the Python monitor layer (step-level metrics live in the same
// registry as the C++ pipeline stages) and by the metrics unit tests
// to exercise bucketing without a topology. Returns 0, or -1 on an
// unknown kind.
int bps_metrics_observe(const char* kind, const char* name, long long v) {
  if (!kind || !name) return -1;
  if (strcmp(kind, "counter") == 0) {
    Metrics::Get().Counter(name)->fetch_add(v, std::memory_order_relaxed);
    return 0;
  }
  if (strcmp(kind, "gauge") == 0) {
    Metrics::Get().Gauge(name)->store(v, std::memory_order_relaxed);
    return 0;
  }
  if (strcmp(kind, "histo") == 0) {
    Metrics::Get().Histogram(name)->Observe(v);
    return 0;
  }
  return -1;
}

// --- fleet event journal -----------------------------------------

// Whole-journal JSON: local ring + (scheduler) fleet timeline + metric
// history rings. Same buffer contract as bps_metrics_snapshot: returns
// the byte length needed; copies + NUL-terminates only when it fits.
long long bps_events_summary(char* buf, long long maxlen) {
  std::string out = Events::Get().SnapshotJson();
  long long need = static_cast<long long>(out.size());
  if (buf && maxlen > need) {
    memcpy(buf, out.data(), static_cast<size_t>(need));
    buf[need] = '\0';
  }
  return need;
}

// Emit one event through the production path (ring, counters, and — on
// a scheduler — the fleet timeline). The FFI hook behind the Python
// monitor layer's journal writes (insight classifications, POST
// /events) and the reachability tests. Returns 0, or -1 on a type
// outside the catalog.
int bps_events_emit(int type, long long a0, long long a1, long long a2) {
  if (type <= EV_NONE || type >= EV_TYPE_COUNT) return -1;
  Events::Get().Emit(static_cast<EventType>(type), a0, a1, a2);
  return 0;
}

// Fill a heartbeat events sub-payload exactly as HeartbeatLoop would
// (new-since-last-beat, capped at kMaxWireEvents). Returns the bytes
// written, 0 when there is nothing new (or the journal is off), or
// the negated length needed when `maxlen` is too small — the chunk
// must ship whole or not at all (wire chunks are not resumable).
long long bps_events_fill_wire(char* buf, long long maxlen) {
  std::string out;
  if (!Events::Get().FillWire(&out)) return 0;
  long long need = static_cast<long long>(out.size());
  if (!buf || maxlen < need) return -need;
  memcpy(buf, out.data(), static_cast<size_t>(need));
  return need;
}

// Ingest one events wire chunk as the scheduler's heartbeat handler
// would. Returns 1 when ingested, 0 when rejected (foreign magic,
// version skew, short frame) — the interop contract the tests pin.
int bps_events_ingest(const void* data, long long len) {
  if (!data || len <= 0) return 0;
  return Events::Get().Ingest(data, static_cast<size_t>(len)) ? 1 : 0;
}

}  // extern "C"
