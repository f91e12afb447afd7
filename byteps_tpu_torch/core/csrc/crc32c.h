// CRC32C (Castagnoli, the iSCSI/ext4 polynomial) — the repo's single
// integrity primitive, shared by the checkpoint spill/scan path
// (ckpt.cc), the wire-frame trailer (van.cc, BYTEPS_WIRE_CRC), and the
// snapshot serving reply verification. Hoisted out of ckpt.cc
// so the table exists exactly once.
//
// Hardware-accelerated where the build allows it (the SSE4.2 crc32
// instruction IS reflected-Castagnoli), with a table-driven software
// fallback — both produce identical checksums (the probe's known-vector
// test pins them). The paced wire-overhead gate lives in
// BENCH_integrity_r19.json.
#pragma once

#include <cstddef>
#include <cstdint>

namespace bps {

// `seed` chains calls: Crc32c(b, nb, Crc32c(a, na)) == Crc32c(a||b) —
// the property the van uses to checksum a gather-send's discontiguous
// iovec segments without flattening them.
uint32_t Crc32c(const void* data, size_t len, uint32_t seed = 0);

}  // namespace bps
