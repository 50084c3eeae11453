// 256-bit prime-field arithmetic for the bn254 fields, shared by every kernel.
//
// Elements are Montgomery residues (R = 2^256) held by one thread as eight
// 32-bit words, little-endian. At the kernels' interface they are the port's
// limb-major int32[..., 16, B] tensors: sixteen 16-bit limbs, limb j of
// element e of row r at ((r * 16) + j) * B + e. Neighbouring threads take
// neighbouring elements, so each limb row is a coalesced load.
//
// Field 0 is Fr (the scalar field), field 1 is Fq (the base field of G1).
// Every template below takes the field as its parameter; an entry point
// picks the instantiation from its runtime `field` argument.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace h2 {

// p, -p^-1 mod 2^32 and R mod p (Montgomery one).
static __constant__ uint32_t kP[2][8] = {
    {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
     0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u},
    {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
     0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u}};
static __constant__ uint32_t kN0[2] = {0xefffffffu, 0xe4866389u};
static __constant__ uint32_t kOne[2][8] = {
    {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u,
     0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u},
    {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
     0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u}};

struct Fe {
  uint32_t w[8];
};

// Word j of field F's modulus and -p^-1 mod 2^32, as constants the compiler
// folds into the instructions that use them (the loops below are unrolled).
template <int F>
__device__ __forceinline__ constexpr uint32_t mod_word(int j) {
  constexpr uint32_t P[2][8] = {
      {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
       0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u},
      {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
       0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u}};
  return P[F][j];
}
template <int F>
__device__ __forceinline__ constexpr uint32_t mod_n0() {
  return F == 0 ? 0xefffffffu : 0xe4866389u;
}

// --- PTX carry-chain primitives ----------------------------------------------
// One instruction each; a chain is a run of them in program order, the carry
// flag passing from one to the next (asm volatile keeps that order).
__device__ __forceinline__ uint32_t mul_lo(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("mul.lo.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
// --- end of the primitives ---------------------------------------------------

// t < 2p (eight words)  ->  t mod p: t - p unless that borrows.
template <int F>
__device__ __forceinline__ Fe reduce_2p(const uint32_t t[8]) {
  uint32_t d[8];
  d[0] = sub_cc(t[0], mod_word<F>(0));
#pragma unroll
  for (int j = 1; j < 8; j++) d[j] = subc_cc(t[j], mod_word<F>(j));
  const uint32_t borrow = subc(0u, 0u);  // 0, or all ones when t < p
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; j++) r.w[j] = borrow ? t[j] : d[j];
  return r;
}

// Montgomery product a * b * 2^-256 mod p of canonical a, b (< p): CIOS on
// PTX carry chains. Each of the eight rounds adds a * b_i (a chain of low
// halves, then one of high halves, one word up) and m * p, m = t_0 * n0
// (the same two chains), then drops the zero low word. p < 2^254, so the
// running value stays below 2p and every round fits nine words; the result
// is the canonical residue, the same value as mul_c64's.
// (mul_w takes b as word(i) -> b_i, read as each round needs it: from
// registers through mul, from shared memory where a kernel keeps a table.)
template <int F, class Words>
__device__ __forceinline__ Fe mul_w(const Fe& a, Words word) {
  uint32_t t[9];
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const uint32_t bi = word(i);
    if (i == 0) {
#pragma unroll
      for (int j = 0; j < 8; j++) t[j] = mul_lo(a.w[j], bi);
      t[1] = mad_hi_cc(a.w[0], bi, t[1]);
#pragma unroll
      for (int j = 1; j < 7; j++) t[j + 1] = madc_hi_cc(a.w[j], bi, t[j + 1]);
      t[8] = madc_hi(a.w[7], bi, 0u);
    } else {
      t[0] = mad_lo_cc(a.w[0], bi, t[0]);
#pragma unroll
      for (int j = 1; j < 8; j++) t[j] = madc_lo_cc(a.w[j], bi, t[j]);
      t[8] = addc(0u, 0u);
      t[1] = mad_hi_cc(a.w[0], bi, t[1]);
#pragma unroll
      for (int j = 1; j < 7; j++) t[j + 1] = madc_hi_cc(a.w[j], bi, t[j + 1]);
      t[8] = madc_hi(a.w[7], bi, t[8]);
    }
    const uint32_t m = mul_lo(t[0], mod_n0<F>());
    t[0] = mad_lo_cc(m, mod_word<F>(0), t[0]);  // 0
#pragma unroll
    for (int j = 1; j < 8; j++) t[j] = madc_lo_cc(m, mod_word<F>(j), t[j]);
    t[8] = addc(t[8], 0u);
    t[1] = mad_hi_cc(m, mod_word<F>(0), t[1]);
#pragma unroll
    for (int j = 1; j < 7; j++) t[j + 1] = madc_hi_cc(m, mod_word<F>(j), t[j + 1]);
    t[8] = madc_hi(m, mod_word<F>(7), t[8]);
#pragma unroll
    for (int j = 0; j < 8; j++) t[j] = t[j + 1];
  }
  return reduce_2p<F>(t);
}

template <int F>
__device__ __forceinline__ Fe mul(const Fe& a, const Fe& b) {
  return mul_w<F>(a, [&](int i) { return b.w[i]; });
}

// The product the carry chains replaced, CIOS with 64-bit C accumulators,
// kept only for the micro-benchmark that holds the two against each other
// (field_kernels.cu, h2_mul_chain); t (with a ninth word `hi`) < 2p  ->
// t mod p.
template <int F>
__device__ __forceinline__ Fe reduce_once(const uint32_t t[8], uint32_t hi) {
  Fe d;
  int64_t br = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    int64_t v = (int64_t)t[j] - (int64_t)kP[F][j] + br;
    d.w[j] = (uint32_t)v;
    br = v >> 32;  // 0 or -1
  }
  const bool ge = (hi != 0) || (br == 0);
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; j++) r.w[j] = ge ? d.w[j] : t[j];
  return r;
}

template <int F>
__device__ __forceinline__ Fe mul_c64(const Fe& a, const Fe& b) {
  uint32_t t[10];
#pragma unroll
  for (int j = 0; j < 10; j++) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      c += (uint64_t)t[j] + (uint64_t)a.w[j] * b.w[i];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[8] = (uint32_t)c;
    t[9] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * kN0[F];
    c = ((uint64_t)t[0] + (uint64_t)m * kP[F][0]) >> 32;
#pragma unroll
    for (int j = 1; j < 8; j++) {
      c += (uint64_t)t[j] + (uint64_t)m * kP[F][j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[7] = (uint32_t)c;
    t[8] = t[9] + (uint32_t)(c >> 32);
  }
  return reduce_once<F>(t, t[8]);
}

// a + b < 2p on one carry chain, then the conditional subtract.
template <int F>
__device__ __forceinline__ Fe add(const Fe& a, const Fe& b) {
  uint32_t s[8];
  s[0] = add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int j = 1; j < 7; j++) s[j] = addc_cc(a.w[j], b.w[j]);
  s[7] = addc(a.w[7], b.w[7]);
  return reduce_2p<F>(s);
}

// a - b, then p added back under the borrow mask (no branch).
template <int F>
__device__ __forceinline__ Fe sub(const Fe& a, const Fe& b) {
  uint32_t d[8];
  d[0] = sub_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int j = 1; j < 8; j++) d[j] = subc_cc(a.w[j], b.w[j]);
  const uint32_t mask = subc(0u, 0u);
  Fe r;
  r.w[0] = add_cc(d[0], mod_word<F>(0) & mask);
#pragma unroll
  for (int j = 1; j < 7; j++) r.w[j] = addc_cc(d[j], mod_word<F>(j) & mask);
  r.w[7] = addc(d[7], mod_word<F>(7) & mask);
  return r;
}

template <int F>
__device__ __forceinline__ Fe dbl(const Fe& a) {
  return add<F>(a, a);
}

__device__ __forceinline__ bool is_zero(const Fe& a) {
  uint32_t o = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) o |= a.w[j];
  return o == 0;
}

__device__ __forceinline__ Fe zero() {
  Fe z;
#pragma unroll
  for (int j = 0; j < 8; j++) z.w[j] = 0;
  return z;
}

template <int F>
__device__ __forceinline__ Fe one() {
  Fe o;
#pragma unroll
  for (int j = 0; j < 8; j++) o.w[j] = kOne[F][j];
  return o;
}

__device__ __forceinline__ Fe sel(bool c, const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; j++) r.w[j] = c ? a.w[j] : b.w[j];
  return r;
}

// --- limb-major loads and stores -------------------------------------------
// An operand of shape [Lx, 16, Bx] is read at row r, lane e; Lx == 1 or
// Bx == 1 broadcasts that axis.
__device__ __forceinline__ Fe load(const int32_t* __restrict__ x, int64_t Lx, int64_t Bx,
                                   int64_t r, int64_t e) {
  const int32_t* base = x + (Lx == 1 ? 0 : r) * 16 * Bx + (Bx == 1 ? 0 : e);
  Fe v;
#pragma unroll
  for (int k = 0; k < 8; k++)
    v.w[k] = ((uint32_t)base[(2 * k) * Bx] & 0xffffu) |
             ((uint32_t)base[(2 * k + 1) * Bx] << 16);
  return v;
}

// Store at limb rows `row0 .. row0 + 15` of an [L, rows, B] tensor.
__device__ __forceinline__ void store(int32_t* __restrict__ out, int64_t rows, int64_t B,
                                      int64_t r, int64_t row0, int64_t e, const Fe& v) {
  int32_t* base = out + (r * rows + row0) * B + e;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    base[(2 * k) * B] = (int32_t)(v.w[k] & 0xffffu);
    base[(2 * k + 1) * B] = (int32_t)(v.w[k] >> 16);
  }
}

}  // namespace h2

#define H2_THREADS 256
#define H2_BLOCKS(n) ((unsigned)(((n) + H2_THREADS - 1) / H2_THREADS))
