// Byte-oriented rANS entropy coder (Duda 2013): the port's copy of
// gscodec_studio_tpu/csrc/rans.cpp, built apart from the CUDA kernels by
// gscodec_studio_tpu_torch/compression/native.py with g++ and the JAX
// package's flags, so that both libraries write the same bytes.
//
// Replaces the reference's `constriction` ANS dependency
// (gsplat/compression/entropy_coding_compression.py): encodes u8 symbol
// streams against a quantized 14-bit frequency table, with either one
// global table or per-element context ids selecting among several tables
// (the gaussian-conditional path).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t PROB_BITS = 14;
constexpr uint32_t PROB_SCALE = 1u << PROB_BITS;
constexpr uint32_t RANS_L = 1u << 23;  // renormalization lower bound

struct SymStats {
  uint32_t freq;
  uint32_t cum;
};

// Quantize raw counts to a PROB_SCALE-total table, every seen symbol >= 1.
void quantize_freqs(const uint64_t* counts, int nsym, std::vector<SymStats>& st) {
  uint64_t total = 0;
  for (int i = 0; i < nsym; i++) total += counts[i];
  if (total == 0) total = 1;
  std::vector<uint32_t> f(nsym, 0);
  uint32_t assigned = 0;
  int nonzero = 0;
  for (int i = 0; i < nsym; i++)
    if (counts[i]) nonzero++;
  for (int i = 0; i < nsym; i++) {
    if (!counts[i]) continue;
    uint64_t q = (counts[i] * (uint64_t)PROB_SCALE) / total;
    f[i] = q < 1 ? 1 : (uint32_t)q;
    assigned += f[i];
  }
  // Fix the total to PROB_SCALE by adjusting the largest entries.
  while (assigned != PROB_SCALE) {
    int best = -1;
    uint32_t best_f = 0;
    for (int i = 0; i < nsym; i++)
      if (f[i] > best_f) { best_f = f[i]; best = i; }
    if (best < 0) { f[0] = PROB_SCALE - (assigned - f[0]); break; }
    if (assigned > PROB_SCALE) {
      uint32_t d = assigned - PROB_SCALE;
      uint32_t take = f[best] > d + 1 ? d : f[best] - 1;
      f[best] -= take;
      assigned -= take;
      if (take == 0) break;
    } else {
      f[best] += PROB_SCALE - assigned;
      assigned = PROB_SCALE;
    }
  }
  st.resize(nsym);
  uint32_t cum = 0;
  for (int i = 0; i < nsym; i++) {
    st[i].freq = f[i];
    st[i].cum = cum;
    cum += f[i];
  }
}

}  // namespace

extern "C" {

// Build the quantized table from raw counts; out_freqs[nsym] sums to 2^14.
void rans_quantize_freqs(const uint64_t* counts, int nsym, uint32_t* out_freqs) {
  std::vector<SymStats> st;
  quantize_freqs(counts, nsym, st);
  for (int i = 0; i < nsym; i++) out_freqs[i] = st[i].freq;
}

// Encode n symbols with one table (freqs must sum to 2^14). Returns the
// number of bytes written, or -1 if out_cap is too small.
int64_t rans_encode_u8(const uint8_t* syms, int64_t n, const uint32_t* freqs,
                       int nsym, uint8_t* out, int64_t out_cap) {
  std::vector<SymStats> st(nsym);
  uint32_t cum = 0;
  for (int i = 0; i < nsym; i++) {
    st[i].freq = freqs[i];
    st[i].cum = cum;
    cum += freqs[i];
  }
  if (cum != PROB_SCALE) return -2;

  std::vector<uint8_t> rev;
  rev.reserve(n + 16);
  uint64_t x = RANS_L;
  // rANS encodes back-to-front so the decoder reads front-to-back.
  for (int64_t i = n - 1; i >= 0; i--) {
    const SymStats& s = st[syms[i]];
    if (s.freq == 0) return -3;  // symbol not in table
    // renormalize: keep x < (RANS_L >> PROB_BITS) << 8 * freq
    uint64_t x_max = ((RANS_L >> PROB_BITS) << 8) * s.freq;
    while (x >= x_max) {
      rev.push_back((uint8_t)(x & 0xff));
      x >>= 8;
    }
    x = ((x / s.freq) << PROB_BITS) + (x % s.freq) + s.cum;
  }
  // flush state (8 bytes, little-endian)
  for (int i = 0; i < 8; i++) {
    rev.push_back((uint8_t)(x & 0xff));
    x >>= 8;
  }
  int64_t sz = (int64_t)rev.size();
  if (sz > out_cap) return -1;
  // reverse into output
  for (int64_t i = 0; i < sz; i++) out[i] = rev[sz - 1 - i];
  return sz;
}

// Decode n symbols. Returns 0 on success.
int rans_decode_u8(const uint8_t* buf, int64_t buf_len, const uint32_t* freqs,
                   int nsym, uint8_t* out, int64_t n) {
  std::vector<SymStats> st(nsym);
  std::vector<uint8_t> slot2sym(PROB_SCALE);
  uint32_t cum = 0;
  for (int i = 0; i < nsym; i++) {
    st[i].freq = freqs[i];
    st[i].cum = cum;
    for (uint32_t j = cum; j < cum + freqs[i]; j++) slot2sym[j] = (uint8_t)i;
    cum += freqs[i];
  }
  if (cum != PROB_SCALE) return -2;

  int64_t pos = 0;
  uint64_t x = 0;
  for (int i = 0; i < 8; i++) {
    if (pos >= buf_len) return -4;
    x = (x << 8) | buf[pos++];
  }
  for (int64_t i = 0; i < n; i++) {
    uint32_t slot = (uint32_t)(x & (PROB_SCALE - 1));
    uint8_t s = slot2sym[slot];
    out[i] = s;
    x = st[s].freq * (x >> PROB_BITS) + slot - st[s].cum;
    while (x < RANS_L && pos < buf_len) x = (x << 8) | buf[pos++];
  }
  return 0;
}

// Context-coded variant: ctx[i] in [0, nctx) selects among nctx stacked
// tables (freqs laid out [nctx, nsym]). Used by the gaussian-conditional
// codec where each element has its own (binned) distribution.
int64_t rans_encode_u8_ctx(const uint8_t* syms, const uint16_t* ctx, int64_t n,
                           const uint32_t* freqs, int nctx, int nsym,
                           uint8_t* out, int64_t out_cap) {
  std::vector<SymStats> st((size_t)nctx * nsym);
  for (int c = 0; c < nctx; c++) {
    uint32_t cum = 0;
    for (int i = 0; i < nsym; i++) {
      SymStats& s = st[(size_t)c * nsym + i];
      s.freq = freqs[(size_t)c * nsym + i];
      s.cum = cum;
      cum += s.freq;
    }
    if (cum != PROB_SCALE) return -2;
  }
  std::vector<uint8_t> rev;
  rev.reserve(n + 16);
  uint64_t x = RANS_L;
  for (int64_t i = n - 1; i >= 0; i--) {
    const SymStats& s = st[(size_t)ctx[i] * nsym + syms[i]];
    if (s.freq == 0) return -3;
    uint64_t x_max = ((RANS_L >> PROB_BITS) << 8) * s.freq;
    while (x >= x_max) {
      rev.push_back((uint8_t)(x & 0xff));
      x >>= 8;
    }
    x = ((x / s.freq) << PROB_BITS) + (x % s.freq) + s.cum;
  }
  for (int i = 0; i < 8; i++) {
    rev.push_back((uint8_t)(x & 0xff));
    x >>= 8;
  }
  int64_t sz = (int64_t)rev.size();
  if (sz > out_cap) return -1;
  for (int64_t i = 0; i < sz; i++) out[i] = rev[sz - 1 - i];
  return sz;
}

int rans_decode_u8_ctx(const uint8_t* buf, int64_t buf_len, const uint16_t* ctx,
                       const uint32_t* freqs, int nctx, int nsym, uint8_t* out,
                       int64_t n) {
  std::vector<SymStats> st((size_t)nctx * nsym);
  std::vector<std::vector<uint8_t>> slot2sym(nctx,
                                             std::vector<uint8_t>(PROB_SCALE));
  for (int c = 0; c < nctx; c++) {
    uint32_t cum = 0;
    for (int i = 0; i < nsym; i++) {
      SymStats& s = st[(size_t)c * nsym + i];
      s.freq = freqs[(size_t)c * nsym + i];
      s.cum = cum;
      for (uint32_t j = cum; j < cum + s.freq; j++)
        slot2sym[c][j] = (uint8_t)i;
      cum += s.freq;
    }
    if (cum != PROB_SCALE) return -2;
  }
  int64_t pos = 0;
  uint64_t x = 0;
  for (int i = 0; i < 8; i++) {
    if (pos >= buf_len) return -4;
    x = (x << 8) | buf[pos++];
  }
  for (int64_t i = 0; i < n; i++) {
    int c = ctx[i];
    uint32_t slot = (uint32_t)(x & (PROB_SCALE - 1));
    uint8_t s = slot2sym[c][slot];
    out[i] = s;
    const SymStats& ss = st[(size_t)c * nsym + s];
    x = ss.freq * (x >> PROB_BITS) + slot - ss.cum;
    while (x < RANS_L && pos < buf_len) x = (x << 8) | buf[pos++];
  }
  return 0;
}

}  // extern "C"
