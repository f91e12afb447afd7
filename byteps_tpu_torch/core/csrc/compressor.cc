#include "compressor.h"

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstring>
#include <random>

#include "logging.h"

namespace bps {

namespace {

// True iff every value is finite. `!(|v| <= FLT_MAX)` is NaN-proof:
// a NaN fails every comparison, while std::isfinite can be elided
// under -ffast-math and NaN never survives std::max.
bool AllFinite(const float* src, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    if (!(std::fabs(src[i]) <= FLT_MAX)) return false;
  }
  return true;
}

// A NaN/Inf gradient poisons every lossy encoding differently (onebit's
// mean scale goes NaN, sparse-k sorts it to the top, dithering divides
// by it) — all of them would silently encode garbage the server then
// sums into every worker's aggregate. Crash at the boundary with the
// key diagnosis instead; a non-finite gradient is a training bug, not
// a wire condition.
void CheckFiniteInput(const float* src, int64_t n, const char* who) {
  BPS_CHECK(AllFinite(src, n))
      << who << ": non-finite value in compressor input (" << n
      << " elements) — refusing to encode garbage";
}

}  // namespace

std::unordered_map<std::string, std::string> ParseCompressorConfig(
    const std::string& config) {
  std::unordered_map<std::string, std::string> kv;
  size_t pos = 0;
  while (pos < config.size()) {
    size_t end = config.find(';', pos);
    if (end == std::string::npos) end = config.size();
    std::string item = config.substr(pos, end - pos);
    size_t eq = item.find('=');
    if (eq != std::string::npos) {
      kv[item.substr(0, eq)] = item.substr(eq + 1);
    } else if (!item.empty()) {
      kv[item] = "";
    }
    pos = end + 1;
  }
  return kv;
}

namespace {

// --- onebit: sign bits + one mean-magnitude scale ---------------------------
// Wire: [f32 scale][ceil(n/8) sign bytes]; ~32x smaller than f32.
class OnebitCompressor : public Compressor {
 public:
  void Compress(const float* src, int64_t n, std::vector<char>* out) override {
    CheckFiniteInput(src, n, "onebit");
    int64_t nbytes = (n + 7) / 8;
    out->assign(sizeof(float) + nbytes, 0);
    double sum_abs = 0;
    for (int64_t i = 0; i < n; ++i) sum_abs += std::fabs(src[i]);
    float scale = n > 0 ? static_cast<float>(sum_abs / n) : 0.0f;
    memcpy(out->data(), &scale, sizeof(float));
    unsigned char* bits =
        reinterpret_cast<unsigned char*>(out->data() + sizeof(float));
    for (int64_t i = 0; i < n; ++i) {
      if (src[i] >= 0) bits[i >> 3] |= (1u << (i & 7));
    }
  }

  void Decompress(const char* src, int64_t src_bytes, float* dst,
                  int64_t n) override {
    BPS_CHECK_GE(src_bytes, static_cast<int64_t>(sizeof(float) + (n + 7) / 8));
    float scale;
    memcpy(&scale, src, sizeof(float));
    const unsigned char* bits =
        reinterpret_cast<const unsigned char*>(src + sizeof(float));
    for (int64_t i = 0; i < n; ++i) {
      dst[i] = (bits[i >> 3] >> (i & 7)) & 1 ? scale : -scale;
    }
  }
};

// --- topk / randomk: k (index, value) pairs ---------------------------------
// Wire: [i32 k][k * (i32 idx, f32 val)].
class SparseKCompressor : public Compressor {
 public:
  SparseKCompressor(int64_t k, bool random, uint64_t seed)
      : k_(k), random_(random), rng_(seed) {}

  void Compress(const float* src, int64_t n, std::vector<char>* out) override {
    CheckFiniteInput(src, n, random_ ? "randomk" : "topk");
    int64_t k = std::min<int64_t>(k_, n);
    std::vector<int64_t> idx;
    if (random_) {
      // sample k distinct indices
      idx.resize(n);
      for (int64_t i = 0; i < n; ++i) idx[i] = i;
      for (int64_t i = 0; i < k; ++i) {
        std::uniform_int_distribution<int64_t> d(i, n - 1);
        std::swap(idx[i], idx[d(rng_)]);
      }
      idx.resize(k);
    } else {
      idx.resize(n);
      for (int64_t i = 0; i < n; ++i) idx[i] = i;
      std::partial_sort(idx.begin(), idx.begin() + k, idx.end(),
                        [&](int64_t a, int64_t b) {
                          return std::fabs(src[a]) > std::fabs(src[b]);
                        });
      idx.resize(k);
    }
    out->resize(sizeof(int32_t) + k * (sizeof(int32_t) + sizeof(float)));
    char* p = out->data();
    int32_t k32 = static_cast<int32_t>(k);
    memcpy(p, &k32, sizeof(k32));
    p += sizeof(k32);
    for (int64_t i = 0; i < k; ++i) {
      int32_t j = static_cast<int32_t>(idx[i]);
      memcpy(p, &j, sizeof(j));
      p += sizeof(j);
      memcpy(p, &src[idx[i]], sizeof(float));
      p += sizeof(float);
    }
  }

  void Decompress(const char* src, int64_t src_bytes, float* dst,
                  int64_t n) override {
    memset(dst, 0, n * sizeof(float));
    BPS_CHECK_GE(src_bytes, static_cast<int64_t>(sizeof(int32_t)));
    int32_t k;
    memcpy(&k, src, sizeof(k));
    const char* p = src + sizeof(k);
    BPS_CHECK_GE(src_bytes,
                 static_cast<int64_t>(sizeof(int32_t)) +
                     k * static_cast<int64_t>(sizeof(int32_t) + sizeof(float)));
    for (int32_t i = 0; i < k; ++i) {
      int32_t j;
      float v;
      memcpy(&j, p, sizeof(j));
      p += sizeof(j);
      memcpy(&v, p, sizeof(v));
      p += sizeof(v);
      BPS_CHECK_GE(j, 0);
      BPS_CHECK(j < n) << "sparse index out of range";
      dst[j] = v;
    }
  }

 private:
  int64_t k_;
  bool random_;
  std::mt19937_64 rng_;
};

// --- dithering: stochastic uniform quantization -----------------------------
// Wire: [f32 max_abs][n int8]. Stochastic rounding keeps E[decode] == x
// (the reference's natural-dithering capability; uniform levels here).
class DitheringCompressor : public Compressor {
 public:
  explicit DitheringCompressor(uint64_t seed) : rng_(seed) {}

  void Compress(const float* src, int64_t n, std::vector<char>* out) override {
    CheckFiniteInput(src, n, "dithering");
    float maxabs = 0;
    for (int64_t i = 0; i < n; ++i)
      maxabs = std::max(maxabs, std::fabs(src[i]));
    out->resize(sizeof(float) + n);
    memcpy(out->data(), &maxabs, sizeof(float));
    int8_t* q = reinterpret_cast<int8_t*>(out->data() + sizeof(float));
    if (maxabs == 0) {
      memset(q, 0, n);
      return;
    }
    std::uniform_real_distribution<float> u(0.0f, 1.0f);
    for (int64_t i = 0; i < n; ++i) {
      float scaled = src[i] / maxabs * 127.0f;
      float low = std::floor(scaled);
      float frac = scaled - low;
      int v = static_cast<int>(low) + (u(rng_) < frac ? 1 : 0);
      q[i] = static_cast<int8_t>(std::max(-127, std::min(127, v)));
    }
  }

  void Decompress(const char* src, int64_t src_bytes, float* dst,
                  int64_t n) override {
    BPS_CHECK_GE(src_bytes, static_cast<int64_t>(sizeof(float)) + n);
    float maxabs;
    memcpy(&maxabs, src, sizeof(float));
    const int8_t* q = reinterpret_cast<const int8_t*>(src + sizeof(float));
    for (int64_t i = 0; i < n; ++i) dst[i] = q[i] / 127.0f * maxabs;
  }

 private:
  std::mt19937_64 rng_;
};

// --- error feedback decorator ----------------------------------------------
// e += g; send compress(e); e -= decompress(send)  — reference
// vanilla_error_feedback.cc capability.
class ErrorFeedback : public Compressor {
 public:
  ErrorFeedback(std::unique_ptr<Compressor> inner, int64_t n)
      : inner_(std::move(inner)), residual_(n, 0.0f), scratch_(n) {}

  void Compress(const float* src, int64_t n, std::vector<char>* out) override {
    BPS_CHECK_EQ(n, static_cast<int64_t>(residual_.size()));
    for (int64_t i = 0; i < n; ++i) residual_[i] += src[i];
    inner_->Compress(residual_.data(), n, out);
    inner_->Decompress(out->data(), out->size(), scratch_.data(), n);
    for (int64_t i = 0; i < n; ++i) residual_[i] -= scratch_[i];
  }

  void Decompress(const char* src, int64_t src_bytes, float* dst,
                  int64_t n) override {
    inner_->Decompress(src, src_bytes, dst, n);
  }

 private:
  std::unique_ptr<Compressor> inner_;
  std::vector<float> residual_;
  std::vector<float> scratch_;
};

// --- nesterov momentum decorator --------------------------------------------
// v = mu*v + g; send g + mu*v  — reference impl/nesterov_momentum.cc.
class NesterovMomentum : public Compressor {
 public:
  NesterovMomentum(std::unique_ptr<Compressor> inner, int64_t n, float mu)
      : inner_(std::move(inner)), vel_(n, 0.0f), send_(n), mu_(mu) {}

  void Compress(const float* src, int64_t n, std::vector<char>* out) override {
    BPS_CHECK_EQ(n, static_cast<int64_t>(vel_.size()));
    for (int64_t i = 0; i < n; ++i) {
      vel_[i] = mu_ * vel_[i] + src[i];
      send_[i] = src[i] + mu_ * vel_[i];
    }
    inner_->Compress(send_.data(), n, out);
  }

  void Decompress(const char* src, int64_t src_bytes, float* dst,
                  int64_t n) override {
    inner_->Decompress(src, src_bytes, dst, n);
  }

 private:
  std::unique_ptr<Compressor> inner_;
  std::vector<float> vel_;
  std::vector<float> send_;
  float mu_;
};

}  // namespace

std::unique_ptr<Compressor> CreateCompressor(const std::string& config,
                                             int64_t n) {
  auto kv = ParseCompressorConfig(config);
  auto type_it = kv.find("type");
  if (type_it == kv.end() || type_it->second.empty()) return nullptr;
  const std::string& type = type_it->second;

  auto get_i = [&](const char* key, int64_t dflt) {
    auto it = kv.find(key);
    return it != kv.end() ? atoll(it->second.c_str()) : dflt;
  };
  auto get_f = [&](const char* key, double dflt) {
    auto it = kv.find(key);
    return it != kv.end() ? atof(it->second.c_str()) : dflt;
  };

  std::unique_ptr<Compressor> c;
  if (type == "onebit") {
    c = std::make_unique<OnebitCompressor>();
  } else if (type == "topk") {
    c = std::make_unique<SparseKCompressor>(
        get_i("k", std::max<int64_t>(1, n / 100)), false, 0);
  } else if (type == "randomk") {
    c = std::make_unique<SparseKCompressor>(
        get_i("k", std::max<int64_t>(1, n / 100)), true,
        static_cast<uint64_t>(get_i("seed", 12345)));
  } else if (type == "dithering") {
    c = std::make_unique<DitheringCompressor>(
        static_cast<uint64_t>(get_i("seed", 12345)));
  } else {
    BPS_FATAL << "unknown compressor type: " << type;
  }

  // Decorators (order matches the reference: momentum inside error feedback
  // so the residual sees the momentum-folded gradient).
  auto mom = kv.find("momentum");
  if (mom != kv.end() && mom->second == "nesterov") {
    c = std::make_unique<NesterovMomentum>(
        std::move(c), n, static_cast<float>(get_f("mu", 0.9)));
  }
  auto ef = kv.find("ef");
  if (ef != kv.end() && ef->second == "vanilla") {
    c = std::make_unique<ErrorFeedback>(std::move(c), n);
  }
  return c;
}

// --- BlockQuant wire codec ----------------------------------------

namespace {

constexpr uint16_t kBlockQuantMagic = 0xB10C;

#pragma pack(push, 1)
struct BlockQuantHeader {
  uint16_t magic;
  uint16_t block;
  int32_t nelem;
};
#pragma pack(pop)

// Shared encode body: when `residual` is non-null it IS the source and
// receives the EF update (residual -= decode(encoded)) in the same pass.
bool BlockQuantEncodeImpl(const float* src, float* residual, int64_t n,
                          int block, std::vector<char>* out) {
  if (!BlockQuant::ValidBlock(block) || n < 0) return false;
  const int64_t nblocks = (n + block - 1) / block;
  out->resize(static_cast<size_t>(BlockQuant::EncodedSize(n, block)));
  auto* hdr = reinterpret_cast<BlockQuantHeader*>(out->data());
  hdr->magic = kBlockQuantMagic;
  hdr->block = static_cast<uint16_t>(block);
  hdr->nelem = static_cast<int32_t>(n);
  float* scales =
      reinterpret_cast<float*>(out->data() + sizeof(BlockQuantHeader));
  int8_t* q = reinterpret_cast<int8_t*>(
      out->data() + sizeof(BlockQuantHeader) + nblocks * sizeof(float));
  for (int64_t b = 0; b < nblocks; ++b) {
    const int64_t lo = b * block;
    const int64_t hi = std::min<int64_t>(lo + block, n);
    float absmax = 0.0f;
    for (int64_t i = lo; i < hi; ++i) {
      const float a = std::fabs(src[i]);
      // NaN-proof finiteness gate (a NaN fails every comparison, so it
      // can neither become absmax nor pass this check).
      if (!(a <= FLT_MAX)) return false;
      if (a > absmax) absmax = a;
    }
    // All-zero block: scale 0 encodes — and decodes — exact zeros.
    const float scale = absmax / 127.0f;
    scales[b] = scale;
    const float inv = scale > 0.0f ? 1.0f / scale : 0.0f;
    for (int64_t i = lo; i < hi; ++i) {
      int v = static_cast<int>(std::lrintf(src[i] * inv));
      if (v > 127) v = 127;
      if (v < -127) v = -127;
      q[i] = static_cast<int8_t>(v);
      if (residual) residual[i] -= static_cast<float>(v) * scale;
    }
  }
  return true;
}

}  // namespace

bool BlockQuant::Encode(const float* src, int64_t n, int block,
                        std::vector<char>* out) {
  return BlockQuantEncodeImpl(src, nullptr, n, block, out);
}

bool BlockQuant::EncodeEF(float* residual, int64_t n, int block,
                          std::vector<char>* out) {
  return BlockQuantEncodeImpl(residual, residual, n, block, out);
}

bool BlockQuant::Decode(const char* src, int64_t src_bytes, float* dst,
                        int64_t n) {
  if (src_bytes < static_cast<int64_t>(sizeof(BlockQuantHeader))) {
    return false;
  }
  BlockQuantHeader hdr;
  memcpy(&hdr, src, sizeof(hdr));
  const int block = hdr.block;
  if (hdr.magic != kBlockQuantMagic || !ValidBlock(block) ||
      hdr.nelem != n || src_bytes != EncodedSize(n, block)) {
    return false;
  }
  const int64_t nblocks = (n + block - 1) / block;
  const float* scales =
      reinterpret_cast<const float*>(src + sizeof(BlockQuantHeader));
  const int8_t* q = reinterpret_cast<const int8_t*>(
      src + sizeof(BlockQuantHeader) + nblocks * sizeof(float));
  for (int64_t b = 0; b < nblocks; ++b) {
    const int64_t lo = b * block;
    const int64_t hi = std::min<int64_t>(lo + block, n);
    const float scale = scales[b];
    for (int64_t i = lo; i < hi; ++i) {
      dst[i] = static_cast<float>(q[i]) * scale;
    }
  }
  return true;
}

}  // namespace bps
