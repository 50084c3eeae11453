// Family B: field inversion on limb-major int32[L, 16, B] tensors: the
// Montgomery-form inverse (a R)^-1 R^2 = a^-1 R, zero mapped to zero, the
// function of a^(p-2) in Montgomery arithmetic.
//
// Replaces halo2_lib_tpu/ops/pallas_field.py:_fermat_kernel (via
// fermat_inv), the inverse of the running total inside every batch
// inversion. The TPU kernel raises a to p - 2 by a 4-bit window (about 330
// dependent Montgomery products); this kernel computes the same (unique,
// canonical) inverse by another algorithm.
//
// Bound on the H100: one thread's serial chain. The prover inverts a handful
// of elements at a time (11 launches of one element each per proof), so the
// time is the latency of one element's dependent steps, not bytes or issue.
//
// Design: the variable-time safegcd of Bernstein and Yang ("Fast
// constant-time gcd computation and modular inversion", 2019), in the form
// of libsecp256k1's modinv32_var, one thread per element. (f, g) start at
// (p, x), (d, e) at (0, R^2 mod p), each held as nine signed 30-bit limbs in
// registers. A batch runs 30 divsteps on the low 32 bits of f and g alone
// (they decide every step), several at once where g has trailing zeros or
// where up to 6 of its low bits can be cancelled by one multiple of f,
// and returns their 2x2 transition matrix (entries below 2^30); the matrix
// is then applied to the full (f, g), exactly divided by 2^30, and to (d,
// e) modulo p (a multiple of p added to make the low 30 bits zero, then the
// shift). Batches repeat until g = 0: f is then +-1 and d = +-x^-1 R^2 mod
// p, normalised into [0, p). Starting e at R^2 mod p in place of 1 saves
// the Montgomery product that turns x^-1 into x^-1 R^2. Inputs below p <
// 2^254 need at most 741 divsteps (25 batches; Bernstein-Yang, theorem
// 11.2), random ones about 18 batches: a chain of about 18 x (the divsteps
// of one batch + two 9-limb matrix products), against the 330 products of
// the Fermat chain. tests/test_torch_inverse.py holds a Python model of
// this iteration, at these word sizes and this batch length, to
// pow(x, p - 2, p).
#include "fp256.cuh"

using namespace h2;

constexpr int32_t M30 = 0x3fffffff;
// divsteps per batch, and the loop's stop (the bound is 25 batches)
constexpr int BATCH = 30;
constexpr int MAX_BATCHES = 32;

struct S30 {
  int32_t v[9];  // value = sum v[i] 2^(30 i); v[0..7] in [0, 2^30), v[8] signed
};

struct Trans {
  int32_t u, v, q, r;
};

// p, p^-1 mod 2^30 and R^2 mod p of each field, in signed 30-bit limbs.
template <int F>
__device__ __forceinline__ constexpr int32_t mod30(int i) {
  constexpr int32_t P[2][9] = {
      {0x30000001, 0x0f87d64f, 0x1b970914, 0x0cfa121e, 0x01585d28, 0x0116da06, 0x1a029b85,
       0x139cb84c, 0x00003064},
      {0x187cfd47, 0x3082305b, 0x071ca8d3, 0x205aa45a, 0x01585d97, 0x0116da06, 0x1a029b85,
       0x139cb84c, 0x00003064}};
  return P[F][i];
}
template <int F>
__device__ __forceinline__ constexpr uint32_t mod_inv30() {
  return F == 0 ? 0x10000001u : 0x1b799c77u;
}
template <int F>
__device__ __forceinline__ constexpr int32_t r2_30(int i) {
  constexpr int32_t R2[2][9] = {
      {0x2e216da7, 0x2ee39916, 0x35c59e31, 0x3f8eac78, 0x3b808553, 0x260cf54e, 0x244a58c4,
       0x342c5fd3, 0x00000216},
      {0x138afa89, 0x0cb3f16d, 0x04501fbf, 0x39c64475, 0x017ff6b5, 0x2c7bfc29, 0x0351f47a,
       0x27dc72ae, 0x000006d8}};
  return R2[F][i];
}

// Canonical eight 32-bit words -> nine 30-bit limbs (limb i = bits 30 i ..
// 30 i + 29), and back for a normalised value in [0, p).
__device__ __forceinline__ S30 to_s30(const Fe& a) {
  S30 s;
#pragma unroll
  for (int i = 0; i < 9; i++) {
    const int k = (30 * i) >> 5, sh = (30 * i) & 31;
    uint32_t x = a.w[k] >> sh;
    if (sh > 2 && k + 1 < 8) x |= a.w[k + 1] << (32 - sh);
    s.v[i] = (int32_t)(x & M30);
  }
  return s;
}

__device__ __forceinline__ Fe from_s30(const S30& s) {
  Fe a;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    const int i = (32 * k) / 30, sh = (32 * k) % 30;  // sh <= 14: two limbs cover the word
    a.w[k] = ((uint32_t)s.v[i] >> sh) | ((uint32_t)s.v[i + 1] << (30 - sh));
  }
  return a;
}

// 30 divsteps on the low 32 bits f0, g0 of f and g (f odd), from eta = -delta:
// returns the new eta and the transition matrix t with t [f, g] = 2^30 [f',
// g']. Trailing zeros of g are divided out at once; where eta >= 0, g gets
// the multiple w f (w below 2^min(eta + 1, i, 6)) that clears its low bits,
// which is that many divsteps of adding f to an odd g and halving.
__device__ __forceinline__ int32_t divsteps(int32_t eta, uint32_t f0, uint32_t g0, Trans& t) {
  uint32_t u = 1, v = 0, q = 0, r = 1, f = f0, g = g0;
  int i = BATCH;
  for (;;) {
    const int zeros = __ffs(g | (0xffffffffu << i)) - 1;  // capped at i by the sentinel
    g >>= zeros;
    u <<= zeros;
    v <<= zeros;
    eta -= zeros;
    i -= zeros;
    if (i == 0) break;
    if (eta < 0) {  // (delta, f, g) -> (-delta, g, -f)
      uint32_t tmp;
      eta = -eta;
      tmp = f, f = g, g = 0u - tmp;
      tmp = u, u = q, q = 0u - tmp;
      tmp = v, v = r, r = 0u - tmp;
    }
    const int limit = min(eta + 1, i);
    const uint32_t m = (0xffffffffu >> (32 - limit)) & 63u;
    const uint32_t w = (f * g * (f * f - 2u)) & m;  // -g / f mod 2^6
    g += f * w;
    q += u * w;
    r += v * w;
  }
  t.u = (int32_t)u, t.v = (int32_t)v, t.q = (int32_t)q, t.r = (int32_t)r;
  return eta;
}

// [d, e] <- (t [d, e] + p [md, me]) / 2^30, md and me chosen to make the low
// 30 bits zero; d, e stay in (-2p, p).
template <int F>
__device__ __forceinline__ void update_de(S30& d, S30& e, const Trans& t) {
  const int32_t sd = d.v[8] >> 31, se = e.v[8] >> 31;
  int32_t md = (t.u & sd) + (t.v & se);
  int32_t me = (t.q & sd) + (t.r & se);
  int64_t cd = (int64_t)t.u * d.v[0] + (int64_t)t.v * e.v[0];
  int64_t ce = (int64_t)t.q * d.v[0] + (int64_t)t.r * e.v[0];
  md -= (int32_t)((mod_inv30<F>() * (uint32_t)cd + (uint32_t)md) & (uint32_t)M30);
  me -= (int32_t)((mod_inv30<F>() * (uint32_t)ce + (uint32_t)me) & (uint32_t)M30);
  cd += (int64_t)mod30<F>(0) * md;
  ce += (int64_t)mod30<F>(0) * me;
  cd >>= 30;
  ce >>= 30;
#pragma unroll
  for (int i = 1; i < 9; i++) {
    cd += (int64_t)t.u * d.v[i] + (int64_t)t.v * e.v[i] + (int64_t)mod30<F>(i) * md;
    ce += (int64_t)t.q * d.v[i] + (int64_t)t.r * e.v[i] + (int64_t)mod30<F>(i) * me;
    d.v[i - 1] = (int32_t)cd & M30;
    e.v[i - 1] = (int32_t)ce & M30;
    cd >>= 30;
    ce >>= 30;
  }
  d.v[8] = (int32_t)cd;
  e.v[8] = (int32_t)ce;
}

// [f, g] <- t [f, g] / 2^30 (exact).
__device__ __forceinline__ void update_fg(S30& f, S30& g, const Trans& t) {
  int64_t cf = (int64_t)t.u * f.v[0] + (int64_t)t.v * g.v[0];
  int64_t cg = (int64_t)t.q * f.v[0] + (int64_t)t.r * g.v[0];
  cf >>= 30;
  cg >>= 30;
#pragma unroll
  for (int i = 1; i < 9; i++) {
    cf += (int64_t)t.u * f.v[i] + (int64_t)t.v * g.v[i];
    cg += (int64_t)t.q * f.v[i] + (int64_t)t.r * g.v[i];
    f.v[i - 1] = (int32_t)cf & M30;
    g.v[i - 1] = (int32_t)cg & M30;
    cf >>= 30;
    cg >>= 30;
  }
  f.v[8] = (int32_t)cf;
  g.v[8] = (int32_t)cg;
}

// d in (-2p, p) -> d (sign >= 0) or -d (sign < 0), in [0, p).
template <int F>
__device__ __forceinline__ void normalize(S30& d, int32_t sign) {
  int32_t c = d.v[8] >> 31;
#pragma unroll
  for (int i = 0; i < 9; i++) d.v[i] += mod30<F>(i) & c;
  const int32_t neg = sign >> 31;
#pragma unroll
  for (int i = 0; i < 9; i++) d.v[i] = (d.v[i] ^ neg) - neg;
#pragma unroll
  for (int i = 0; i < 8; i++) d.v[i + 1] += d.v[i] >> 30, d.v[i] &= M30;
  c = d.v[8] >> 31;
#pragma unroll
  for (int i = 0; i < 9; i++) d.v[i] += mod30<F>(i) & c;
#pragma unroll
  for (int i = 0; i < 8; i++) d.v[i + 1] += d.v[i] >> 30, d.v[i] &= M30;
}

template <int F>
__global__ void inverse_k(const int32_t* __restrict__ a, int32_t* __restrict__ out, int64_t L,
                          int64_t B) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L * B) return;
  const int64_t row = i / B, lane = i % B;
  S30 f, g = to_s30(load(a, L, B, row, lane)), d, e;
#pragma unroll
  for (int j = 0; j < 9; j++) f.v[j] = mod30<F>(j), d.v[j] = 0, e.v[j] = r2_30<F>(j);
  int32_t eta = -1;
  for (int b = 0; b < MAX_BATCHES; b++) {
    Trans t;
    eta = divsteps(eta, (uint32_t)f.v[0], (uint32_t)g.v[0], t);
    update_de<F>(d, e, t);
    update_fg(f, g, t);
    int32_t any = 0;
#pragma unroll
    for (int j = 0; j < 9; j++) any |= g.v[j];
    if (any == 0) break;
  }
  normalize<F>(d, f.v[8]);
  store(out, 16, B, row, 0, lane, from_s30(d));
}

extern "C" int h2_fermat_inv(int field, const int32_t* a, int32_t* out, int64_t L, int64_t B,
                             void* stream) {
  const int64_t n = L * B;
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    if (field == 0)
      inverse_k<0><<<H2_BLOCKS(n), H2_THREADS, 0, s>>>(a, out, L, B);
    else
      inverse_k<1><<<H2_BLOCKS(n), H2_THREADS, 0, s>>>(a, out, L, B);
  }
  return (int)cudaGetLastError();
}
