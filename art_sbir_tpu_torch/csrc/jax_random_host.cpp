// jax.random's normal and truncated normal on the host, element for
// element the arithmetic of art_sbir_tpu_torch/core/jax_random.py (its
// numpy form is the reference the tests hold this to, bit for bit):
// threefry2x32 in the partitionable layout (word i is the XOR of the hash
// of (0, i)), 23 random mantissa bits mapped to [a, b) by one rounding of
// the float64 form of the multiply-add, Giles' float32 erfinv polynomial
// over log1p taken in float64 with each Horner step rounded once to
// float32, then `scale` (sqrt(2), or sqrt(2) times a constant the draw is
// multiplied by) times it, clipped to [lo, hi].
//
// Built with g++ at first use (data/native_loader.py::build_library). The
// products that feed an add are exact in float64, so contracting them
// into fused multiply-adds cannot change a result.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

const int kRotations[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
const float kSmall[9] = {2.81022636e-08f,  3.43273939e-07f, -3.5233877e-06f,
                         -4.39150654e-06f, 0.00021858087f,  -0.00125372503f,
                         -0.00417768164f,  0.246640727f,    1.50140941f};
const float kLarge[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f,
                         -0.00367342844f,  0.00573950773f,  -0.0076224613f,
                         0.00943887047f,   1.00167406f,     2.83297682f};

inline uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

inline uint32_t random_word(uint32_t k0, uint32_t k1, uint32_t i) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  uint32_t x0 = ks[0];
  uint32_t x1 = i + ks[1];
  for (int g = 0; g < 5; ++g) {
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, kRotations[g % 2][j]);
      x1 ^= x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + static_cast<uint32_t>(g + 1);
  }
  return x0 ^ x1;
}

inline float to_range(uint32_t bits, float a, float b) {
  const uint32_t one = (bits >> 9) | 0x3F800000u;
  float f;
  std::memcpy(&f, &one, sizeof f);
  f -= 1.0f;
  const float width = b - a;
  const float s = static_cast<float>(static_cast<double>(f) * width + a);
  return s > a ? s : a;
}

}  // namespace

// Words start .. start + n - 1 of the draw under the key (k0, k1), into
// out[0 .. n - 1]. Each block runs its stages as loops of their own (the
// hash, the uniforms and log1p, the polynomial), which the compiler can
// vectorize.
extern "C" void jr_inverse_cdf(uint32_t k0, uint32_t k1, int64_t start,
                               int64_t n, float a, float b, float lo, float hi,
                               float scale, float* out) {
  constexpr int64_t kBlock = 512;
  uint32_t words[kBlock];
  float x[kBlock], w[kBlock];
  for (int64_t s0 = 0; s0 < n; s0 += kBlock) {
    const int64_t m = n - s0 < kBlock ? n - s0 : kBlock;
    const uint32_t first = static_cast<uint32_t>(start + s0);
    for (int64_t i = 0; i < m; ++i)
      words[i] = random_word(k0, k1, first + static_cast<uint32_t>(i));
    for (int64_t i = 0; i < m; ++i) {
      x[i] = to_range(words[i], a, b);
      const float xx = x[i] * x[i];
      w[i] = static_cast<float>(-std::log1p(-static_cast<double>(xx)));
    }
    for (int64_t i = 0; i < m; ++i) {
      const bool small = w[i] < 5.0f;
      const float t = small ? w[i] - 2.5f : std::sqrt(w[i]) - 3.0f;
      float p = small ? kSmall[0] : kLarge[0];
      for (int k = 1; k < 9; ++k)
        p = static_cast<float>(static_cast<double>(p) * t +
                               (small ? kSmall[k] : kLarge[k]));
      float v = std::fabs(x[i]) == 1.0f ? x[i] * INFINITY : p * x[i];
      v *= scale;
      out[s0 + i] = v < lo ? lo : (v > hi ? hi : v);
    }
  }
}
