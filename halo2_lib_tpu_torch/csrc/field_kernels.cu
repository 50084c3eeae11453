// Family A: elementwise field kernels on limb-major int32[L, 16, B] tensors.
//
// Replaces halo2_lib_tpu/ops/pallas_field.py:_mm_kernel (Montgomery product,
// via mont_mul) and _field_add_kernel / _field_sub_kernel (via field_addsub).
//
// Bound on the H100: mont_mul is bound by integer multiply issue (128 32x32
// partial products, each a lo and a hi IMAD, per element against 16 bytes of
// traffic per limb pair); add and sub are bound by bytes (32 + 32 bytes in,
// 32 out per element at 4 bytes a limb).
//
// Design: one thread owns one element, loads its sixteen 16-bit limbs as eight
// 32-bit words (coalesced across the warp, since neighbours read neighbouring
// lanes of the same limb row) and runs CIOS Montgomery on PTX carry chains
// (fp256.cuh). An operand may broadcast its row axis or its lane axis (a
// [16, 1] constant or a [16, B] table against [L, 16, B]) without being
// materialised. Left for later: packed 8x32-bit storage between kernels and
// fusing chains of field ops into one pass.
//
// h2_mul_chain is a measurement, not a port: each thread runs `iters`
// dependent Montgomery products over Fq, with the carry-chain product or the
// 64-bit C one it replaced (mul_c64), so the two can be timed against each
// other in one process.
#include "fp256.cuh"

using namespace h2;

template <int F, int OP>
__global__ void field_binary(const int32_t* __restrict__ a, int64_t La, int64_t Ba,
                             const int32_t* __restrict__ b, int64_t Lb, int64_t Bb,
                             int32_t* __restrict__ out, int64_t L, int64_t B) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L * B) return;
  const int64_t r = i / B, e = i % B;
  const Fe x = load(a, La, Ba, r, e);
  const Fe y = load(b, Lb, Bb, r, e);
  Fe z;
  if (OP == 0)
    z = mul<F>(x, y);
  else if (OP == 1)
    z = add<F>(x, y);
  else
    z = sub<F>(x, y);
  store(out, 16, B, r, 0, e, z);
}

template <int OP>
static int launch(int field, const int32_t* a, int64_t La, int64_t Ba, const int32_t* b,
                  int64_t Lb, int64_t Bb, int32_t* out, int64_t L, int64_t B,
                  cudaStream_t s) {
  const int64_t n = L * B;
  if (n > 0) {
    if (field == 0)
      field_binary<0, OP><<<H2_BLOCKS(n), H2_THREADS, 0, s>>>(a, La, Ba, b, Lb, Bb, out, L, B);
    else
      field_binary<1, OP><<<H2_BLOCKS(n), H2_THREADS, 0, s>>>(a, La, Ba, b, Lb, Bb, out, L, B);
  }
  return (int)cudaGetLastError();
}

extern "C" int h2_mont_mul(int field, const int32_t* a, int64_t La, int64_t Ba,
                           const int32_t* b, int64_t Lb, int64_t Bb, int32_t* out,
                           int64_t L, int64_t B, void* stream) {
  return launch<0>(field, a, La, Ba, b, Lb, Bb, out, L, B, (cudaStream_t)stream);
}

extern "C" int h2_field_add(int field, const int32_t* a, int64_t La, int64_t Ba,
                            const int32_t* b, int64_t Lb, int64_t Bb, int32_t* out,
                            int64_t L, int64_t B, void* stream) {
  return launch<1>(field, a, La, Ba, b, Lb, Bb, out, L, B, (cudaStream_t)stream);
}

extern "C" int h2_field_sub(int field, const int32_t* a, int64_t La, int64_t Ba,
                            const int32_t* b, int64_t Lb, int64_t Bb, int32_t* out,
                            int64_t L, int64_t B, void* stream) {
  return launch<2>(field, a, La, Ba, b, Lb, Bb, out, L, B, (cudaStream_t)stream);
}

template <bool CHAINS>
__global__ void mul_chain_k(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                            int32_t* __restrict__ out, int64_t B, int iters) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  Fe x = load(a, 1, B, 0, i);
  const Fe y = load(b, 1, B, 0, i);
#pragma unroll 1
  for (int k = 0; k < iters; k++) x = CHAINS ? mul<1>(x, y) : mul_c64<1>(x, y);
  store(out, 16, B, 0, 0, i, x);
}

// impl 1: the carry-chain product (mul), 0: the 64-bit C one (mul_c64).
extern "C" int h2_mul_chain(int impl, const int32_t* a, const int32_t* b, int32_t* out,
                            int64_t B, int iters, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B > 0) {
    if (impl)
      mul_chain_k<true><<<H2_BLOCKS(B), H2_THREADS, 0, s>>>(a, b, out, B, iters);
    else
      mul_chain_k<false><<<H2_BLOCKS(B), H2_THREADS, 0, s>>>(a, b, out, B, iters);
  }
  return (int)cudaGetLastError();
}
