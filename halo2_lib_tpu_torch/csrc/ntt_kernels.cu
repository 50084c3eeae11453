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
// root of unity. Stage st (s = 2^st) takes rows i and i + A/2 (i = p s + j,
// j < s) to rows 2 p s + j (their sum) and 2 p s + s + j (their difference
// times tw[p s]).
//
// Bound on the H100: bytes, by the roofline count (at A = 128 with the mid,
// about 1400 32-bit operations an element against 192 bytes moved: 7 per
// byte, under the card's ratio of about 20). In practice the Montgomery
// products set the time: 3.5 an element at A = 128 (the butterflies' 448 a
// column less the 127 by tw[0], and the mid), which at the carry-chain
// product's rate alone (chip_smoke.py's micro-benchmark) take most of the
// kernel's time.
//
// Design: a block takes a tile of A rows x TB = 2048 / A columns (16 at
// A = 128: each limb row is read and written in 64-byte pieces) with 512
// threads of 4 elements each. The stages run in passes of up to two (radix
// 4): a thread holds the 2^K elements that K consecutive stages combine (the
// rows that differ in the top K bits of the first stage's index), runs the K
// stages in registers, and sends each element to the row where the stage
// sequence puts it. The first pass reads its elements from device memory and
// the last writes them there (with the mid product); in between, each pass
// exchanges the tile through shared memory (8 word planes; a warp's threads
// take neighbouring columns). At A = 128: 4 passes, 3 exchanges and 7
// barriers. The A/2 twiddles are staged into shared memory once per block and
// read word by word as the product's rounds need them (mul_w); tw[0] is read
// once, and where it is the Montgomery one the products by it (127 of a
// column's 448 at A = 128) are skipped, which leaves every value as it was.
// 64 registers and 64 KB of shared memory a block, no spills: two blocks an
// SM, so one tile's loads and stores overlap the other's products. On the
// H100, 8 elements a thread (radix 8: 128 registers, one block an SM) and
// 32-column tiles of 1024 threads (128-byte pieces, one block an SM) both
// ran slower than this layout: warps an SM matter more here than the width
// of a piece. Left for later: a cheaper product,
// cp.async or TMA prefetch, and folding the four-step transposes of
// ops/ntt.py into the loads.
#define COLNTT_TILE 2048
#define COLNTT_THREADS 512
#define COLNTT_MIN_BLOCKS 2
// elements a thread holds, and the most stages a pass runs (log2 of it)
constexpr int COLNTT_EPT = COLNTT_TILE / COLNTT_THREADS;
constexpr int COLNTT_KMAX = COLNTT_EPT >= 8 ? 3 : COLNTT_EPT >= 4 ? 2 : 1;

// The limbs of one element at p, limb rows B apart (offsets within one
// column set fit 32 bits: the wrapper checks A * 16 * B < 2^31).
__device__ __forceinline__ Fe ld_limbs(const int32_t* __restrict__ p, int B) {
  Fe v;
#pragma unroll
  for (int k = 0; k < 8; k++)
    v.w[k] = ((uint32_t)p[2 * k * B] & 0xffffu) | ((uint32_t)p[(2 * k + 1) * B] << 16);
  return v;
}

__device__ __forceinline__ void st_limbs(int32_t* __restrict__ p, int B, const Fe& v) {
#pragma unroll
  for (int k = 0; k < 8; k++) {
    p[2 * k * B] = (int32_t)(v.w[k] & 0xffffu);
    p[(2 * k + 1) * B] = (int32_t)(v.w[k] >> 16);
  }
}

// Shared memory: the twiddle planes [8, A/2], then the tile's data planes
// [8, COLNTT_TILE] (row a, column c at a * TB + c).
extern __shared__ uint32_t colntt_sm[];

template <int F, bool MUL>
__device__ __forceinline__ void colntt_bfly(Fe* v, int* idx, int a, int b, int s, int half) {
  const int i = idx[a], ps = i & ~(s - 1), j = i - ps;
  const Fe u = v[a], d = sub<F>(u, v[b]);
  v[a] = add<F>(u, v[b]);
  if (MUL)
    v[b] = mul_w<F>(d, [&](int k) { return colntt_sm[k * half + ps]; });
  else
    v[b] = d;
  idx[a] = 2 * ps + j;
  idx[b] = 2 * ps + s + j;
}

// One pass of K stages from stage st on; thread tid owns items tid, tid + NT,
// ... (COLNTT_EPT >> K of them), item = (column col, low bits o) with rows
// e << (m - K) | o, e < 2^K. A = 2^m; b0 is the tile's first column.
template <int F, int K>
__device__ __forceinline__ void colntt_pass(const int32_t* __restrict__ xl,
                                            const int32_t* __restrict__ mid,
                                            int32_t* __restrict__ ol, bool tw0_one, int B,
                                            int b0, int m, int st, bool first, bool last) {
  constexpr int N = COLNTT_EPT, E = 1 << K, G = N / E;
  const int tid = threadIdx.x, half = 1 << (m - 1), TB = COLNTT_TILE >> m;
  uint32_t* dat = colntt_sm + 8 * half;
  Fe v[N];
  int idx[N], col[G];
#pragma unroll
  for (int g = 0; g < G; g++) {
    const int it = g * COLNTT_THREADS + tid;
    col[g] = it % TB;
    const int o = it / TB;
    // a column past B reads column B - 1 and is never stored
    const int bl = b0 + col[g] < B ? b0 + col[g] : B - 1;
#pragma unroll
    for (int e = 0; e < E; e++) {
      const int row = (e << (m - K)) | o;
      idx[g * E + e] = row;
      if (first) {
        v[g * E + e] = ld_limbs(xl + row * 16 * B + bl, B);
      } else {
#pragma unroll
        for (int k = 0; k < 8; k++) v[g * E + e].w[k] = dat[k * COLNTT_TILE + row * TB + col[g]];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; k++) {
    const int bit = K - 1 - k, s = 1 << (st + k);
#pragma unroll
    for (int g = 0; g < G; g++)
#pragma unroll
      for (int a = 0; a < E; a++)
        if (!(a & (1 << bit))) {
          // tw[ps] == tw[0] == 1: no product (the branch splits the stage's
          // products into separate blocks, which keeps registers low)
          const int ps = idx[g * E + a] & ~(s - 1);
          if (tw0_one && ps == 0)
            colntt_bfly<F, false>(v, idx, g * E + a, g * E + (a | (1 << bit)), s, half);
          else
            colntt_bfly<F, true>(v, idx, g * E + a, g * E + (a | (1 << bit)), s, half);
        }
  }
  if (last) {
    if (mid != nullptr) {
#pragma unroll
      for (int g = 0; g < G; g++) {
        const int bl = b0 + col[g] < B ? b0 + col[g] : B - 1;
#pragma unroll
        for (int e = 0; e < E; e++)
          v[g * E + e] = mul<F>(v[g * E + e], ld_limbs(mid + idx[g * E + e] * 16 * B + bl, B));
      }
    }
#pragma unroll
    for (int g = 0; g < G; g++) {
      if (b0 + col[g] >= B) continue;
#pragma unroll
      for (int e = 0; e < E; e++)
        st_limbs(ol + idx[g * E + e] * 16 * B + b0 + col[g], B, v[g * E + e]);
    }
    return;
  }
  if (!first) __syncthreads();  // every thread has read the tile
#pragma unroll
  for (int g = 0; g < G; g++)
#pragma unroll
    for (int e = 0; e < E; e++)
#pragma unroll
      for (int k = 0; k < 8; k++)
        dat[k * COLNTT_TILE + idx[g * E + e] * TB + col[g]] = v[g * E + e].w[k];
  __syncthreads();
}

template <int F>
__global__ void __launch_bounds__(COLNTT_THREADS, COLNTT_MIN_BLOCKS)
    colntt(const int32_t* __restrict__ x, const int32_t* __restrict__ tw,
           const int32_t* __restrict__ mid, int32_t* __restrict__ out, int B, int m,
           int col_blocks) {
  const int half = 1 << (m - 1), TB = COLNTT_TILE >> m;
  const int64_t l = blockIdx.x / col_blocks;
  const int b0 = (blockIdx.x % col_blocks) * TB;
  const int64_t set = l * ((int64_t)16 << m) * B;  // one column set: A * 16 * B limbs
  for (int j = threadIdx.x; j < half; j += blockDim.x) {
    const Fe t = ld_limbs(tw + j, half);
#pragma unroll
    for (int k = 0; k < 8; k++) colntt_sm[k * half + j] = t.w[k];
  }
  __syncthreads();
  bool tw0_one = true;
#pragma unroll
  for (int k = 0; k < 8; k++) tw0_one &= colntt_sm[k * half] == one<F>().w[k];
  for (int st = 0; st < m;) {
    const int K = m - st < COLNTT_KMAX ? m - st : COLNTT_KMAX;
    const bool first = st == 0, last = st + K == m;
    // (a K above COLNTT_KMAX never occurs; its branch instantiates K = 1)
    if (K == 3)
      colntt_pass<F, (COLNTT_KMAX >= 3 ? 3 : 1)>(x + set, mid, out + set, tw0_one, B, b0, m, st,
                                                  first, last);
    else if (K == 2)
      colntt_pass<F, (COLNTT_KMAX >= 2 ? 2 : 1)>(x + set, mid, out + set, tw0_one, B, b0, m, st,
                                                  first, last);
    else
      colntt_pass<F, 1>(x + set, mid, out + set, tw0_one, B, b0, m, st, first, last);
    st += K;
  }
}

extern "C" int h2_colntt(int field, const int32_t* x, const int32_t* tw, const int32_t* mid,
                         int32_t* out, int64_t L, int64_t A, int64_t B, void* stream) {
  int m = 0;
  while ((1LL << m) < A) m++;
  if (A < 2 || A > 1024 || (1LL << m) != A || A * 16 * B >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int64_t TB = COLNTT_TILE / A;
  const int64_t col_blocks = (B + TB - 1) / TB;
  const int64_t blocks = L * col_blocks;
  // the data planes only where a pass hands the tile to the next
  const size_t smem = 4 * (8 * (A / 2) + (m > COLNTT_KMAX ? 8 * COLNTT_TILE : 0));
  cudaStream_t s = (cudaStream_t)stream;
  if (blocks > 0) {
    auto kernel = field == 0 ? colntt<0> : colntt<1>;
    const int rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
    if (rc) return rc;
    kernel<<<(unsigned)blocks, COLNTT_THREADS, smem, s>>>(x, tw, mid, out, (int)B, m,
                                                         (int)col_blocks);
  }
  return (int)cudaGetLastError();
}
