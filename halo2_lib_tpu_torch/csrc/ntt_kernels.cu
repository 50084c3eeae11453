// Family C: the NTT kernels over Fr, on limb-major int32 tensors.
//
// 1. butterfly: one radix-2 Stockham stage, (a + b, (a - b) * w), on the
//    [L, 16, B] halves of a transform. Replaces
//    halo2_lib_tpu/ops/pallas_field.py:_butterfly_kernel (via ntt_butterfly),
//    which ops/ntt.py runs once per stage of a small domain.
// 2. colntt: every stage of the length-A sub-transforms of the four-step NTT
//    (see below).
//
// butterfly -- bound on the H100: bytes. Each butterfly reads a, b and its
// twiddle and writes two results (5 x 64 bytes in the 16-bit-limb layout)
// around one Montgomery product, an add and a sub.
//
// Design: one thread per butterfly. The twiddle row [16, B] broadcasts over
// the batch rows, so it is read from L2 rather than copied per column. The
// block interleave between stages stays in the torch glue (a reshape), which
// costs one more pass over the data per stage. Left for later: fusing the
// interleave.
#include "fp256.cuh"

using namespace h2;

template <int F>
__global__ void butterfly(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                          const int32_t* __restrict__ w, int64_t Lw, int64_t Bw,
                          int32_t* __restrict__ top, int32_t* __restrict__ bot, int64_t L,
                          int64_t B) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L * B) return;
  const int64_t r = i / B, e = i % B;
  const Fe x = load(a, L, B, r, e);
  const Fe y = load(b, L, B, r, e);
  const Fe t = load(w, Lw, Bw, r, e);
  store(top, 16, B, r, 0, e, add<F>(x, y));
  store(bot, 16, B, r, 0, e, mul<F>(sub<F>(x, y), t));
}

extern "C" int h2_ntt_butterfly(int field, const int32_t* a, const int32_t* b, const int32_t* w,
                                int64_t Lw, int64_t Bw, int32_t* top, int32_t* bot, int64_t L,
                                int64_t B, void* stream) {
  const int64_t n = L * B;
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    if (field == 0)
      butterfly<0><<<H2_BLOCKS(n), H2_THREADS, 0, s>>>(a, b, w, Lw, Bw, top, bot, L, B);
    else
      butterfly<1><<<H2_BLOCKS(n), H2_THREADS, 0, s>>>(a, b, w, Lw, Bw, top, bot, L, B);
  }
  return (int)cudaGetLastError();
}

// --- four-step column transform ------------------------------------------------
// Replaces halo2_lib_tpu/ops/ntt4.py:_colntt_kernel (via _colntt_call), which
// FourStepNTT runs once per level of its factor plan.
//
// x: int32[L, A, 16, B]. Every column (l, b) is one length-A transform along
// the row axis a: all log2(A) radix-2 Stockham DIF stages (natural order in
// and out), then optionally the four-step diagonal twiddle mid[a, :, b]
// multiplied into the result. tw: [16, A/2] Montgomery powers of the A-th
// root of unity.
//
// Bound on the H100: bytes. At A = 128 with the mid, an element costs about
// 1400 32-bit operations (seven stages of butterflies, 3.5 Montgomery
// products, plus the mid product) against 192 bytes moved: 7 operations per
// byte, under the card's ratio of peak operations to memory rate (about 20).
//
// Design: one block holds COLNTT_ELEMS elements (A rows x COLNTT_ELEMS / A
// neighbouring columns) in shared memory as 8 word planes, so a warp's loads
// of one word are consecutive and conflict-free; one thread owns one
// butterfly per stage, reads its pair into registers, and writes both results
// back in place after a barrier. Lanes of one global limb row are read
// COLNTT_ELEMS / A at a time (16 at A = 128: half-coalesced). Left for later:
// wider column tiles, twiddles in shared memory, and registers-resident
// radix-4/8 stages.
#define COLNTT_ELEMS 1024

template <int F>
__global__ void __launch_bounds__(COLNTT_ELEMS / 2)
    colntt(const int32_t* __restrict__ x, const int32_t* __restrict__ tw,
           const int32_t* __restrict__ mid, int32_t* __restrict__ out, int64_t B, int A,
           int log_a, int64_t col_blocks) {
  __shared__ uint32_t sm[8 * COLNTT_ELEMS];  // word plane k: sm[k * COLNTT_ELEMS + a * cols + c]
  const int cols = COLNTT_ELEMS / A, half = A / 2;
  const int c = threadIdx.x % cols, i = threadIdx.x / cols;
  const int64_t l = blockIdx.x / col_blocks;
  const int64_t b = (blockIdx.x % col_blocks) * cols + c;
  const bool live = b < B;
  const int32_t* xl = x + l * A * 16 * B;
  int32_t* ol = out + l * A * 16 * B;

  auto get = [&](int a) {
    Fe v;
#pragma unroll
    for (int k = 0; k < 8; k++) v.w[k] = sm[k * COLNTT_ELEMS + a * cols + c];
    return v;
  };
  auto put = [&](int a, const Fe& v) {
#pragma unroll
    for (int k = 0; k < 8; k++) sm[k * COLNTT_ELEMS + a * cols + c] = v.w[k];
  };

  put(i, live ? load(xl, A, B, i, b) : zero());
  put(i + half, live ? load(xl, A, B, i + half, b) : zero());
  __syncthreads();
  for (int st = 0, s = 1; st < log_a; st++, s *= 2) {
    // stage (n, s), m = n / 2: row i = p * s + j pairs with i + A / 2, uses
    // w^(p * s), and writes rows 2 p s + j and 2 p s + s + j
    const Fe u = get(i), v = get(i + half);
    const int ps = i & ~(s - 1);
    const Fe w = load(tw, 1, half, 0, ps);
    __syncthreads();
    put(2 * ps + (i - ps), add<F>(u, v));
    put(2 * ps + s + (i - ps), mul<F>(sub<F>(u, v), w));
    __syncthreads();
  }
  if (!live) return;
#pragma unroll
  for (int h = 0; h < 2; h++) {
    const int a = i + h * half;
    Fe v = get(a);
    if (mid != nullptr) v = mul<F>(v, load(mid, A, B, a, b));
    store(ol, 16, B, a, 0, b, v);
  }
}

extern "C" int h2_colntt(int field, const int32_t* x, const int32_t* tw, const int32_t* mid,
                         int32_t* out, int64_t L, int64_t A, int64_t B, void* stream) {
  int log_a = 0;
  while ((1LL << log_a) < A) log_a++;
  if (A < 2 || A > COLNTT_ELEMS || (1LL << log_a) != A) return (int)cudaErrorInvalidValue;
  const int64_t cols = COLNTT_ELEMS / A;
  const int64_t col_blocks = (B + cols - 1) / cols;
  const int64_t blocks = L * col_blocks;
  cudaStream_t s = (cudaStream_t)stream;
  if (blocks > 0) {
    if (field == 0)
      colntt<0><<<(unsigned)blocks, COLNTT_ELEMS / 2, 0, s>>>(x, tw, mid, out, B, (int)A, log_a,
                                                               col_blocks);
    else
      colntt<1><<<(unsigned)blocks, COLNTT_ELEMS / 2, 0, s>>>(x, tw, mid, out, B, (int)A, log_a,
                                                               col_blocks);
  }
  return (int)cudaGetLastError();
}
