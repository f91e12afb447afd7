// Gradient compression plugin framework.
//
// Capability parity: reference byteps/common/compressor/ (SURVEY.md §2.2):
// Compressor base + registry keyed by per-tensor param strings, algorithms
// onebit / topk / randomk / dithering, decorators error-feedback (residual
// accumulation) and momentum (nesterov), applied on host buffers at the
// push boundary; the server decompresses, sums, and serves raw aggregates.
//
// Config string grammar (passed through declare_tensor, parity with the
// reference's byteps_compressor_* params):
//   "type=onebit" | "type=topk;k=32" | "type=randomk;k=32;seed=7" |
//   "type=dithering;bits=8"  — optionally with ";ef=vanilla" and/or
//   ";momentum=nesterov;mu=0.9" decorators.
#pragma once

#include <cstdint>
#include <memory>
#include <string>
#include <unordered_map>
#include <vector>

namespace bps {

class Compressor {
 public:
  virtual ~Compressor() = default;
  // Encode `n` float32 elements of src into out (resized to compressed size).
  virtual void Compress(const float* src, int64_t n,
                        std::vector<char>* out) = 0;
  // Decode into dst (n float32 elements, overwritten).
  virtual void Decompress(const char* src, int64_t src_bytes, float* dst,
                          int64_t n) = 0;
};

// Parse a config string and build the (possibly decorated) compressor for a
// partition of `n` elements. Returns nullptr for empty/absent type.
std::unique_ptr<Compressor> CreateCompressor(const std::string& config,
                                             int64_t n);

// Parsed key=value view of a config string (exposed for tests).
std::unordered_map<std::string, std::string> ParseCompressorConfig(
    const std::string& config);

// --- block-quantized wire codec -----------------------------------
// EQuARX-style per-block int8 encoding for the fused data plane
// (BYTEPS_WIRE_QUANT): each block of `block` float32 values ships as one
// f32 absmax-derived scale plus `block` int8 codes. Unlike the Compressor
// plugins above — per-key stateful objects selected per tensor — this is
// a stateless, self-describing WIRE format: any rank can decode any
// frame from the payload alone, resends ship snapshot bytes untouched,
// and the server dequant-sums into its float32 accumulator.
//
// Wire layout: [u16 magic 0xB10C][u16 block][i32 nelem]
//              [ceil(n/block) f32 scales][n int8 codes]
// ~3.8x smaller than raw float32 at block=64. Error feedback is the
// CALLER's job (the worker keeps per-key residuals; EncodeEF folds the
// residual update into the encode pass).
struct BlockQuant {
  // Blocks must be a power of two in [16, 32768] (config.py validates
  // the env knob; this is the wire-level contract Decode enforces too).
  static bool ValidBlock(int block) {
    return block >= 16 && block <= 32768 && (block & (block - 1)) == 0;
  }
  static int64_t EncodedSize(int64_t n, int block) {
    int64_t nblocks = (n + block - 1) / block;
    return 8 + nblocks * static_cast<int64_t>(sizeof(float)) + n;
  }
  // Encode n floats. Returns false — without producing output — on a
  // NaN/Inf input or an invalid block: a non-finite gradient must error
  // loudly at the encode boundary, never ship as garbage codes.
  static bool Encode(const float* src, int64_t n, int block,
                     std::vector<char>* out);
  // Error-feedback variant: `residual` already holds gradient + carried
  // residual; encodes it and subtracts the decoded value in place, so
  // the quantization error of THIS round rides into the next one.
  static bool EncodeEF(float* residual, int64_t n, int block,
                       std::vector<char>* out);
  // Decode into dst (n floats). Returns false on a malformed payload
  // (bad magic/block/element count/length) instead of reading garbage.
  static bool Decode(const char* src, int64_t src_bytes, float* dst,
                     int64_t n);
};

}  // namespace bps
