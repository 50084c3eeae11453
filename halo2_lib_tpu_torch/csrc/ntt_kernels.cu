// Family C: the NTT kernels over Fr, on limb-major int32 tensors.
//
// 1. butterfly: one radix-2 Stockham stage, (a + b, (a - b) * w), on the
//    [L, 16, B] halves of a transform. The literal port of
//    halo2_lib_tpu/ops/pallas_field.py:_butterfly_kernel; no path runs it
//    since ntt_small (3) took its place. Kept as a checked reference.
// 2. colntt: every stage of the length-A sub-transforms of the four-step NTT
//    (see below).
// 3. ntt_small: every stage of a whole transform of up to 2^11 points, with
//    its diagonal scalings, in one launch (see below).
//
// butterfly -- bound on the H100: bytes. Each butterfly reads a, b and its
// twiddle and writes two results (5 x 64 bytes in the 16-bit-limb layout)
// around one Montgomery product, an add and a sub. One thread per butterfly;
// the block interleave between stages was torch glue (a reshape).
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

// Shared memory of colntt and ntt_small: the twiddle planes [8, A/2], then
// the tile's data planes (colntt: [8, COLNTT_TILE], row a, column c at
// a * TB + c; ntt_small: [8, T], see there).
extern __shared__ uint32_t ntt_sm[];

// Stage the [16, half] twiddle row into shared memory as 8 word planes
// (word k of tw[j] at k * half + j); true when tw[0] is the Montgomery one,
// whose products the passes skip (that leaves every value as it was).
template <int F>
__device__ __forceinline__ bool stage_twiddles(const int32_t* __restrict__ tw, int half) {
  for (int j = threadIdx.x; j < half; j += blockDim.x) {
    const Fe t = ld_limbs(tw + j, half);
#pragma unroll
    for (int k = 0; k < 8; k++) ntt_sm[k * half + j] = t.w[k];
  }
  __syncthreads();
  bool tw0_one = true;
#pragma unroll
  for (int k = 0; k < 8; k++) tw0_one &= ntt_sm[k * half] == one<F>().w[k];
  return tw0_one;
}

template <int F, bool MUL>
__device__ __forceinline__ void ntt_bfly(Fe* v, int* idx, int a, int b, int s, int half) {
  const int i = idx[a], ps = i & ~(s - 1), j = i - ps;
  const Fe u = v[a], d = sub<F>(u, v[b]);
  v[a] = add<F>(u, v[b]);
  if (MUL)
    v[b] = mul_w<F>(d, [&](int k) { return ntt_sm[k * half + ps]; });
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
  uint32_t* dat = ntt_sm + 8 * half;
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
            ntt_bfly<F, false>(v, idx, g * E + a, g * E + (a | (1 << bit)), s, half);
          else
            ntt_bfly<F, true>(v, idx, g * E + a, g * E + (a | (1 << bit)), s, half);
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
  const bool tw0_one = stage_twiddles<F>(tw, half);
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

// --- a whole small transform per column, every stage in one launch ------------
// Replaces halo2_lib_tpu/ops/pallas_field.py:_butterfly_kernel as ops/ntt.py
// ran it on every domain below 2^12 points: one butterfly launch a stage,
// torch copies of both halves and an interleave around each (about four
// passes over the data a stage), and one more mont_mul launch for the
// inverse's 1/n or a coset's shift powers.
//
// x: int32[C, 16, n], n = 2^m in [2, 2^11]: each column is one transform
// along its lane axis, all m radix-2 Stockham DIF stages, natural order in
// and out, Montgomery form. tw: [16, n/2] Montgomery powers of the
// transform's root (w^-1 for the inverse). pre: [16, n] or null, multiplied
// into each element as it is loaded (the forward coset's shift powers).
// post: [16, n] or [16, 1] (post_n = n or 1) or null, multiplied into each
// result as it is stored (the inverse's 1/n, or the inverse coset's
// shift^-i / n). Field products are exact and every value canonical, so
// each output equals the unfused composition's bit for bit.
//
// Bound on the H100: bytes by the roofline count (128 bytes an element in
// and out against about 3 products an element at n = 2^11). In practice the
// products and the launch set the time: a block holds one column of 2^11
// points, so at the prover's 3-12 columns most SMs idle and each busy one
// runs 11 x 1024 butterflies; a thread's chain is 22 products at n = 2^11
// (less those by tw[0]) plus the pre and post products.
//
// Design: colntt's block program on the [C, 16, n] layout. A block takes
// T = max(n, NTS_MIN_TILE) elements, G = T / n whole columns (several
// columns a block below 256 points, so that small domains do not leave
// threads idle), with T / 4 threads of 4 elements each. The stages run in
// passes of up to two (radix 4; n = 2 is one pass of one stage): a thread
// holds the elements whose rows differ in the top K bits at the pass's
// start, runs the pass's stages in registers (ntt_bfly keeps each element's
// Stockham row in idx) and, between passes, hands them on through shared
// memory at their new rows (8 word planes of T words; element (column g, row
// r) at g * n + r). The first pass loads from device memory (with the pre
// product), the last stores (with the post product): each element is read
// once and written once. Item it of a pass is (column it >> (m - K), low
// row bits it & (2^(m-K) - 1)), so neighbouring threads take neighbouring
// rows and the loads are coalesced. At n = 2^11: 512 threads, 6 passes, 5
// exchanges, 96 KB of shared memory (dynamic: the entry point opts in above
// the 48 KB default). tests/test_torch_ntt.py models this schedule on the
// CPU, thread by thread.
#define NTS_EPT 4
#define NTS_MIN_TILE 256
#define NTS_MAX_N 2048
constexpr int NTS_KMAX = 2;  // the most stages a pass runs: log2(NTS_EPT)

template <int F, int K>
__device__ __forceinline__ void nts_pass(const int32_t* __restrict__ x,
                                         const int32_t* __restrict__ pre,
                                         const int32_t* __restrict__ post, int post_n,
                                         int32_t* __restrict__ out, bool tw0_one, int m, int T,
                                         int cols, int st, bool first, bool last) {
  constexpr int E = 1 << K, G = NTS_EPT / E;
  const int n = 1 << m, half = n >> 1, NT = T / NTS_EPT, tid = threadIdx.x;
  uint32_t* dat = ntt_sm + 8 * half;
  Fe v[NTS_EPT];
  int idx[NTS_EPT], col[G];
#pragma unroll
  for (int g = 0; g < G; g++) {
    const int it = g * NT + tid;
    col[g] = it >> (m - K);
    const int o = it & ((1 << (m - K)) - 1);
    // a column past the last reads the last one and is never stored
    const int64_t cl = col[g] < cols ? col[g] : cols - 1;
#pragma unroll
    for (int e = 0; e < E; e++) {
      const int row = (e << (m - K)) | o;
      idx[g * E + e] = row;
      if (first) {
        v[g * E + e] = ld_limbs(x + cl * 16 * n + row, n);
        if (pre != nullptr) v[g * E + e] = mul<F>(v[g * E + e], ld_limbs(pre + row, n));
      } else {
#pragma unroll
        for (int k = 0; k < 8; k++) v[g * E + e].w[k] = dat[k * T + col[g] * n + row];
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
          const int ps = idx[g * E + a] & ~(s - 1);
          if (tw0_one && ps == 0)
            ntt_bfly<F, false>(v, idx, g * E + a, g * E + (a | (1 << bit)), s, half);
          else
            ntt_bfly<F, true>(v, idx, g * E + a, g * E + (a | (1 << bit)), s, half);
        }
  }
  if (last) {
#pragma unroll
    for (int g = 0; g < G; g++) {
      if (col[g] >= cols) continue;
#pragma unroll
      for (int e = 0; e < E; e++) {
        Fe r = v[g * E + e];
        if (post != nullptr)
          r = mul<F>(r, ld_limbs(post + (post_n == 1 ? 0 : idx[g * E + e]), post_n));
        st_limbs(out + (int64_t)col[g] * 16 * n + idx[g * E + e], n, r);
      }
    }
    return;
  }
  if (!first) __syncthreads();  // every thread has read the tile
#pragma unroll
  for (int g = 0; g < G; g++)
#pragma unroll
    for (int e = 0; e < E; e++)
#pragma unroll
      for (int k = 0; k < 8; k++) dat[k * T + col[g] * n + idx[g * E + e]] = v[g * E + e].w[k];
  __syncthreads();
}

template <int F>
__global__ void __launch_bounds__(NTS_MAX_N / NTS_EPT, 2)
    ntt_small(const int32_t* __restrict__ x, const int32_t* __restrict__ tw,
              const int32_t* __restrict__ pre, const int32_t* __restrict__ post, int post_n,
              int32_t* __restrict__ out, int64_t C, int m, int T) {
  const int G = T >> m;
  const int64_t c0 = (int64_t)blockIdx.x * G;
  const int cols = C - c0 < G ? (int)(C - c0) : G;
  x += c0 * 16 << m;
  out += c0 * 16 << m;
  const bool tw0_one = stage_twiddles<F>(tw, 1 << (m - 1));
  for (int st = 0; st < m;) {
    const int K = m - st < NTS_KMAX ? m - st : NTS_KMAX;
    const bool first = st == 0, last = st + K == m;
    if (K == 2)
      nts_pass<F, 2>(x, pre, post, post_n, out, tw0_one, m, T, cols, st, first, last);
    else
      nts_pass<F, 1>(x, pre, post, post_n, out, tw0_one, m, T, cols, st, first, last);
    st += K;
  }
}

extern "C" int h2_ntt_small(int field, const int32_t* x, const int32_t* tw, const int32_t* pre,
                            const int32_t* post, int64_t post_n, int32_t* out, int64_t C,
                            int64_t n, void* stream) {
  int m = 0;
  while ((1LL << m) < n) m++;
  if (n < 2 || n > NTS_MAX_N || (1LL << m) != n ||
      (post != nullptr && post_n != 1 && post_n != n))
    return (int)cudaErrorInvalidValue;
  const int64_t T = n > NTS_MIN_TILE ? n : NTS_MIN_TILE;
  const int64_t blocks = (C + T / n - 1) / (T / n);
  // the data planes only where a pass hands the tile to the next
  const size_t smem = 4 * (8 * (n / 2) + (m > NTS_KMAX ? 8 * T : 0));
  cudaStream_t s = (cudaStream_t)stream;
  if (blocks > 0) {
    auto kernel = field == 0 ? ntt_small<0> : ntt_small<1>;
    const int rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
    if (rc) return rc;
    kernel<<<(unsigned)blocks, (unsigned)(T / NTS_EPT), smem, s>>>(x, tw, pre, post, (int)post_n,
                                                                  out, C, m, (int)T);
  }
  return (int)cudaGetLastError();
}
