// Device code shared by the port's kernels: jax's threefry2x32 and the bit
// transforms that turn its output words into uniforms and normals.
//
// The arithmetic is the one walnuts_tpu_torch/ops/prng.py restates in
// PyTorch (threefry2x32, uniform_from_bits, _log1p_xla, erf_inv,
// normal_from_bits), which in turn restates jax.random under the
// partitionable threefry lowering and XLA's erf_inv. A kernel that draws
// normals with this header must be compiled with -fmad=false: PyTorch rounds
// every product and sum of those polynomials on its own, and a contracted
// multiply-add would round once where the plain version rounds twice.
// logf/sqrtf/log1pf here are the IEEE ones (no fast-math intrinsics).

#pragma once

#include <cstdint>

namespace wt {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry2x32 (20 rounds) of counter (c0, c1) under key (k0, k1).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c0, uint32_t c1,
                                             uint32_t& o0, uint32_t& o1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rots[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = c0 + ks[0];
  uint32_t x1 = c1 + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rots[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  o0 = x0;
  o1 = x1;
}

// The deferred key-split replay of one chain (kernels 1 and 4): n
// sequential splits of (k0, k1), keeping subkey 0; at round `at` (1-based)
// subkey 1 is latched into (u0, u1). Each round hashes both subkeys of the
// current key, two independent chains the card runs side by side, and
// selects, as walnuts_tpu/ops/prng.py::_replay_kernel does: the latch is
// no branch, so the lanes of a warp that latch at different rounds do not
// run the latch hash one after the other.
__device__ __forceinline__ void replay_chain(uint32_t& k0, uint32_t& k1,
                                             uint32_t& u0, uint32_t& u1,
                                             int n, int at) {
  for (int j = 0; j < n; ++j) {
    uint32_t n0, n1, l0, l1;
    threefry2x32(k0, k1, 0u, 0u, n0, n1);
    threefry2x32(k0, k1, 0u, 1u, l0, l1);
    const bool hit = at == j + 1;
    u0 = hit ? l0 : u0;
    u1 = hit ? l1 : u1;
    k0 = n0;
    k1 = n1;
  }
}

// jax's uniform [0, 1) from the two threefry words: the mantissa is filled
// with random bits at exponent 0 and 1 is subtracted.
template <typename T>
__device__ __forceinline__ T uniform_from_bits(uint32_t x0, uint32_t x1);

template <>
__device__ __forceinline__ float uniform_from_bits<float>(uint32_t x0,
                                                          uint32_t x1) {
  return __uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u) - 1.0f;
}

template <>
__device__ __forceinline__ double uniform_from_bits<double>(uint32_t x0,
                                                            uint32_t x1) {
  const uint64_t bits = (static_cast<uint64_t>(x0) << 32) | x1;
  return __longlong_as_double(
             static_cast<long long>((bits >> 12) | 0x3FF0000000000000ull)) -
         1.0;
}

__device__ __forceinline__ float wt_log(float x) { return logf(x); }
__device__ __forceinline__ double wt_log(double x) { return log(x); }
__device__ __forceinline__ float wt_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double wt_sqrt(double x) { return sqrt(x); }

// XLA's log1p: a Cephes rational approximation for |x| < sqrt(2) - 1.
template <typename T>
__device__ __forceinline__ T log1p_xla(T x) {
  const T num[7] = {T(4.5270000862445199635215e-5), T(4.9854102823193375972212e-1),
                    T(6.5787325942061044846969e0),  T(2.9911919328553073277375e1),
                    T(6.0949667980987787057556e1),  T(5.7112963590585538103336e1),
                    T(2.0039553499201281259648e1)};
  const T den[7] = {T(1.0),
                    T(1.5062909083469192043167e1),
                    T(8.3047565967967209469434e1),
                    T(2.2176239823732856465394e2),
                    T(3.0909872225312059774938e2),
                    T(2.1642788614495947685003e2),
                    T(6.0118660497603843919306e1)};
  T pn = num[0], pd = den[0];
#pragma unroll
  for (int i = 1; i < 7; ++i) {
    pn = pn * x + num[i];
    pd = pd * x + den[i];
  }
  const T x2 = x * x;
  const T small = x + ((T(-0.5) * x2) + (x * x2) * (pn / pd));
  const T ax = x < T(0) ? -x : x;
  return ax < T(0.41421356237309504880) ? small : wt_log(x + T(1.0));
}

// XLA's erf_inv on (-1, 1) (Giles' polynomials).
__device__ __forceinline__ float erf_inv(float x) {
  const float lo_c[9] = {2.81022636e-08f,  3.43273939e-07f, -3.5233877e-06f,
                         -4.39150654e-06f, 0.00021858087f,  -0.00125372503f,
                         -0.00417768164f,  0.246640727f,    1.50140941f};
  const float hi_c[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f,
                         -0.00367342844f,  0.00573950773f,  -0.0076224613f,
                         0.00943887047f,   1.00167406f,     2.83297682f};
  float w = -log1p_xla<float>(-x * x);
  const bool lt = w < 5.0f;
  w = lt ? w - 2.5f : sqrtf(w) - 3.0f;
  float p = lt ? lo_c[0] : hi_c[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = (lt ? lo_c[i] : hi_c[i]) + p * w;
  return p * x;
}

__device__ __forceinline__ double erf_inv(double x) {
  const double lt_6_25[23] = {
      -3.6444120640178196996e-21, -1.685059138182016589e-19,
      1.2858480715256400167e-18,  1.115787767802518096e-17,
      -1.333171662854620906e-16,  2.0972767875968561637e-17,
      6.6376381343583238325e-15,  -4.0545662729752068639e-14,
      -8.1519341976054721522e-14, 2.6335093153082322977e-12,
      -1.2975133253453532498e-11, -5.4154120542946279317e-11,
      1.051212273321532285e-09,   -4.1126339803469836976e-09,
      -2.9070369957882005086e-08, 4.2347877827932403518e-07,
      -1.3654692000834678645e-06, -1.3882523362786468719e-05,
      0.0001867342080340571352,   -0.00074070253416626697512,
      -0.0060336708714301490533,  0.24015818242558961693,
      1.6536545626831027356};
  const double lt_16[19] = {
      2.2137376921775787049e-09,  9.0756561938885390979e-08,
      -2.7517406297064545428e-07, 1.8239629214389227755e-08,
      1.5027403968909827627e-06,  -4.013867526981545969e-06,
      2.9234449089955446044e-06,  1.2475304481671778723e-05,
      -4.7318229009055733981e-05, 6.8284851459573175448e-05,
      2.4031110387097893999e-05,  -0.0003550375203628474796,
      0.00095328937973738049703,  -0.0016882755560235047313,
      0.0024914420961078508066,   -0.0037512085075692412107,
      0.005370914553590063617,    1.0052589676941592334,
      3.0838856104922207635};
  const double ge_16[17] = {
      -2.7109920616438573243e-11, -2.5556418169965252055e-10,
      1.5076572693500548083e-09,  -3.7894654401267369937e-09,
      7.6157012080783393804e-09,  -1.4960026627149240478e-08,
      2.9147953450901080826e-08,  -6.7711997758452339498e-08,
      2.2900482228026654717e-07,  -9.9298272942317002539e-07,
      4.5260625972231537039e-06,  -1.9681778105531670567e-05,
      7.5995277030017761139e-05,  -0.00021503011930044477347,
      -0.00013871931833623122026, 1.0103004648645343977,
      4.8499064014085844221};
  double w = -log1p_xla<double>(-x * x);
  const bool lt_a = w < 6.25, lt_b = w < 16.0;
  // coefficient i of the range w falls in; the two wider ranges have
  // fewer terms and skip the trailing steps
  auto coeff = [&](int i) {
    double c = lt_6_25[i];
    if (i < 19 && !lt_a) c = lt_16[i];
    if (i < 17 && !lt_b) c = ge_16[i];
    return c;
  };
  w = lt_a ? w - 3.125 : sqrt(w) - (lt_b ? 3.25 : 5.0);
  double p = coeff(0);
  for (int i = 1; i < 17; ++i) p = coeff(i) + p * w;
  for (int i = 17; i < 19; ++i)
    if (lt_b) p = coeff(i) + p * w;
  for (int i = 19; i < 23; ++i)
    if (lt_a) p = coeff(i) + p * w;
  return p * x;
}

// jax's normal: sqrt(2) * erf_inv(u), u uniform on [nextafter(-1, 0), 1).
template <typename T>
__device__ __forceinline__ T normal_from_bits(uint32_t x0, uint32_t x1) {
  const T lo = sizeof(T) == 4 ? T(-0x1.fffffep-1) : T(-0x1.fffffffffffffp-1);
  T u = uniform_from_bits<T>(x0, x1) * (T(1) - lo) + lo;
  u = u < lo ? lo : u;
  return T(1.4142135623730951) * erf_inv(u);
}

}  // namespace wt
