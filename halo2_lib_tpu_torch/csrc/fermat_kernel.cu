// Family B: Fermat inversion a^(p-2) on limb-major int32[L, 16, B] tensors.
//
// Replaces halo2_lib_tpu/ops/pallas_field.py:_fermat_kernel (via fermat_inv),
// the inverse of the running total inside every batch inversion.
//
// Bound on the H100: integer multiply issue. The 4-bit fixed window costs
// 14 table products, 252 squarings and up to 63 window products per
// element, about 330 Montgomery products, and the kernel only ever sees a
// handful of elements, so it runs on a few threads: its time is the latency of
// one thread's chain.
//
// Design: one thread per element keeps the 16-entry window table in local
// memory and walks the exponent's 64 nibbles from the top, read from constant
// memory. Zero maps to zero, as every product with it is zero. Left for later:
// an addition chain for p - 2, and spreading one inversion's chain over a
// warp.
#include "fp256.cuh"

using namespace h2;

template <int F>
__global__ void fermat(const int32_t* __restrict__ a, int32_t* __restrict__ out, int64_t L,
                       int64_t B) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L * B) return;
  const int64_t r = i / B, e = i % B;
  Fe table[16];
  table[0] = one<F>();
  table[1] = load(a, L, B, r, e);
  for (int j = 2; j < 16; j++) table[j] = mul<F>(table[j - 1], table[1]);
  bool started = false;
  Fe acc = table[0];
  for (int q = 63; q >= 0; q--) {
    const uint32_t d = (kPm2[F][q >> 3] >> (4 * (q & 7))) & 15u;
    if (started) {
      for (int s = 0; s < 4; s++) acc = mul<F>(acc, acc);
      if (d) acc = mul<F>(acc, table[d]);
    } else if (d) {
      acc = table[d];
      started = true;
    }
  }
  store(out, 16, B, r, 0, e, acc);
}

extern "C" int h2_fermat_inv(int field, const int32_t* a, int32_t* out, int64_t L, int64_t B,
                             void* stream) {
  const int64_t n = L * B;
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    if (field == 0)
      fermat<0><<<H2_BLOCKS(n), H2_THREADS, 0, s>>>(a, out, L, B);
    else
      fermat<1><<<H2_BLOCKS(n), H2_THREADS, 0, s>>>(a, out, L, B);
  }
  return (int)cudaGetLastError();
}
