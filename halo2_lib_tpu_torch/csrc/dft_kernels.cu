// Family E: the digit-plane DFT (the MXU NTT) on the integer tensor cores:
// dft_stage, one stage (any R, Ro up to 256: MxuNTT's base transforms above
// 2^11 points), and dft_ntt, a whole base transform of 2^6..2^11 points in
// one launch (see its section at the end).
//
// Replaces the XLA module halo2_lib_tpu/ops/ntt_mxu.py (not a pallas_call):
// its _stage_limbs (:341; 32 bf16 plane matmuls with f32 sums, the digit
// pairs shifted into 64 columns) and _fold_mod_p (:97; carry normalisation,
// an exact matmul by 2^(8t) mod p, three folds of 2^256 and a subtract
// ladder), which MxuNTT runs twice a transform.
//
// x: int32[L, 16, R, C], limb-major Montgomery values; planes: uint8[32, Ro,
// R], plane i the 8-bit digit i of the canonical DFT matrix W[k, r]. Every
// column (l, c) is transformed along r:
//     out[l, :, k, c] = post[k, c] * sum_r W[k, r] * (pre[r, c] * x[l, :, r, c])  mod p,
// canonical, limb-major int32[L, 16, Ro, C]; pre ([16, R, C]) and post
// ([16, Ro, C] or [16, 1]) are optional Montgomery products (the coset
// shift powers on the load, the four-step twiddle, 1/n or an inverse coset
// diagonal on the store). W is canonical and x Montgomery, so the sum is the
// Montgomery form of the product; each output equals the composition of
// _stage_limbs, _fold_mod_p and the separate products bit for bit.
//
// The product: with x's 32 digits d_j[r, c] and W's w_i[k, r], the value is
// sum_t 2^(8t) col_t with col_t = sum_{i+j=t} sum_r w_i[k, r] d_j[r, c], 63
// columns. Each (i, j) term is one u8 x u8 -> s32 matrix product on the
// tensor cores (mma.sync m16n8k32, 32 contraction steps an instruction), and
// the pair fold is the accumulation itself: the warp that owns t adds every
// pair of that t into one accumulator, so the 32 x 32 pair products never
// leave the registers. Worst case (every digit 255, R = 256, 32 pairs):
// col_t <= 32 * 256 * 255^2 < 2^29, exact in s32.
//
// The epilogue: a thread carries one element's 63 column sums into 17 words
// (V < 2^526), splits V = A0 + A1 2^256 + A2 2^512 and returns
// (A0 mod p) + mul(A1 mod p, R^2) + mul(A2, R^3) (mul is the Montgomery
// product: mul(a, R^k mod p) = a R^(k-1), which wants a < p), each A
// reduced by a 4p, 2p, p subtract ladder; then the post product and the
// store. Any exact reduction gives the one canonical value; the plain
// version (ops/cuda_field.py) runs _fold_mod_p's own method, so the card
// compares two methods.
//
// Bound on the H100: operations. At the k = 9 prover's [12, 16, 2^11]
// transform (R = 64 then 32) a stage is 1024 * R * Ro * L * C u8 MACs, about
// 1.6 G and 0.8 G, against 0.2 MB in and out: at the int8 peak (989 T MAC/s)
// 1.6 and 0.8 us, where 3.35 TB/s moves the bytes in 0.1 us; the epilogue,
// about 1100 32-bit operations an output (two products, the ladders, the
// carries), is 0.8 us at 67 T/s.
//
// Design: a block takes a 16 x 8 output tile (rows k, columns (l, c)) with 8
// warps and stages, once, the tile's weight rows of all 32 planes (16-byte
// loads) and its columns' 32 digit planes (one element a thread, its 32
// bytes stored where the fragments read them) into shared memory along the
// whole contraction (rows padded to 32 bytes and by 16 more, so that the
// fragment loads of a warp fall in 32 distinct banks; up to 204 KB at R =
// 256, 60 KB at R = 64). Warp w owns the columns t of one window (118-150
// of the 1024 pairs each) and keeps one accumulator tile per t; the windows
// are compile-time (dft_window), so the pair loops unroll to the pairs
// alone, each weight fragment loaded once per window. The column sums then
// pass through shared memory (the staged tiles' space) to the 128 threads
// that run the epilogue. 128 registers, two blocks an SM. Left for later:
// more work in flight per SM (a k = 9 stage is 192 blocks, so each phase's
// latency shows: staging, products and epilogue are each several us of a
// block's time) and wgmma with TMA-fed tiles. (dft_ntt takes the whole
// transform into one launch up to 2^11 points.)
#include <cooperative_groups.h>

#include <atomic>

#include "fp256.cuh"

using namespace h2;
namespace cg = cooperative_groups;

#define DFT_THREADS 256
#define DFT_TM 16  // output rows of a block (the mma's M)
#define DFT_TN 8   // output columns of a block (the mma's N)
#define DFT_D 32   // 8-bit digits of a 256-bit value
#define DFT_WMAX 16  // the widest window of columns t a warp owns
#define DFT_MAX_R 256

// The columns t of each warp's window, [kDftT0[w], kDftT1[w]]: 120, 133,
// 125, 150, 118, 125, 133 and 120 of the 1024 digit pairs (t has
// min(t, 62 - t) + 1 of them).
static __constant__ int kDftT0[8] = {0, 15, 22, 27, 32, 36, 41, 48};
static __constant__ int kDftT1[8] = {14, 21, 26, 31, 35, 40, 47, 62};

// 4p, 2p, R^2 mod p and R^3 mod p of each field (R = 2^256), eight words.
static __constant__ uint32_t kFourP[2][8] = {
    {0xc0000004u, 0x0f87d64fu, 0xe6e5c245u, 0xa0cfa121u,
     0x06056174u, 0xe14116dau, 0x84c680a6u, 0xc19139cbu},
    {0x61f3f51cu, 0xf082305bu, 0xa1c72a34u, 0x5e05aa45u,
     0x06056176u, 0xe14116dau, 0x84c680a6u, 0xc19139cbu}};
static __constant__ uint32_t kTwoP[2][8] = {
    {0xe0000002u, 0x87c3eb27u, 0xf372e122u, 0x5067d090u,
     0x0302b0bau, 0x70a08b6du, 0xc2634053u, 0x60c89ce5u},
    {0xb0f9fa8eu, 0x7841182du, 0xd0e3951au, 0x2f02d522u,
     0x0302b0bbu, 0x70a08b6du, 0xc2634053u, 0x60c89ce5u}};
static __constant__ uint32_t kR2[2][8] = {
    {0xae216da7u, 0x1bb8e645u, 0xe35c59e3u, 0x53fe3ab1u,
     0x53bb8085u, 0x8c49833du, 0x7f4e44a5u, 0x0216d0b1u},
    {0x538afa89u, 0xf32cfc5bu, 0xd44501fbu, 0xb5e71911u,
     0x0a417ff6u, 0x47ab1effu, 0xcab8351fu, 0x06d89f71u}};
static __constant__ uint32_t kR3[2][8] = {
    {0xb4bf0040u, 0x5e94d8e1u, 0x1cfbb6b8u, 0x2a489cbeu,
     0xa19fcfedu, 0x893cc664u, 0x7fcc657cu, 0x0cf8594bu},
    {0xda1530dfu, 0xb1cd6dafu, 0xa7283db6u, 0x62f210e6u,
     0x0ada0afbu, 0xef7f0b0cu, 0x2d592544u, 0x20fd6e90u}};

// d += A * B: one m16n8k32 product of unsigned bytes into s32 sums. A (16 x
// 32, row-major): a0 = row g, bytes 4 tg .. 4 tg + 3; a1 = row g + 8; a2,
// a3 the same rows 16 bytes on. B (32 x 8, column-major): b0 = column g,
// bytes 4 tg .. 4 tg + 3; b1 16 bytes on. d: (g, 2 tg), (g, 2 tg + 1),
// (g + 8, 2 tg), (g + 8, 2 tg + 1). g = lane / 4, tg = lane % 4.
__device__ __forceinline__ void mma_u8(uint32_t (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Every digit pair (i, j) with i + j in [T0, T1] of one warp, column t into
// acc[t - T0]: the window's bounds are compile-time, so the pair loops
// unroll into the pairs alone (a runtime window's guards cost more instruction
// slots than its products). wa, xb: the lane's first fragment word in the
// weight and digit tiles (row or column g, word tg).
template <int T0, int T1>
__device__ __forceinline__ void dft_window(const uint32_t* __restrict__ wa,
                                           const uint32_t* __restrict__ xb, int S, int KW,
                                           uint32_t (&acc)[DFT_WMAX][4]) {
  constexpr int ILO = T0 > DFT_D - 1 ? T0 - (DFT_D - 1) : 0;
  constexpr int IHI = T1 < DFT_D - 1 ? T1 : DFT_D - 1;
  for (int kk = 0; kk < KW; kk += 8) {
#pragma unroll
    for (int i = ILO; i <= IHI; i++) {
      const uint32_t* w = wa + i * DFT_TM * S + kk;
      const uint32_t a0 = w[0], a1 = w[8 * S], a2 = w[4], a3 = w[8 * S + 4];
#pragma unroll
      for (int dt = 0; dt <= T1 - T0; dt++) {
        const int j = T0 + dt - i;
        if (j >= 0 && j < DFT_D) {
          const uint32_t* x = xb + j * DFT_TN * S + kk;
          mma_u8(acc[dt], a0, a1, a2, a3, x[0], x[4]);
        }
      }
    }
  }
}

// a - m unless that borrows (a < m); m is eight constant words.
__device__ __forceinline__ Fe sub_if_ge(const Fe& a, const uint32_t* m) {
  uint32_t d[8];
  d[0] = sub_cc(a.w[0], m[0]);
#pragma unroll
  for (int j = 1; j < 8; j++) d[j] = subc_cc(a.w[j], m[j]);
  const uint32_t borrow = subc(0u, 0u);
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; j++) r.w[j] = borrow ? a.w[j] : d[j];
  return r;
}

// a < 2^256 (< 5.3 p) -> a mod p.
template <int F>
__device__ __forceinline__ Fe reduce_256(const Fe& a) {
  const Fe b = sub_if_ge(sub_if_ge(a, kFourP[F]), kTwoP[F]);
  return reduce_2p<F>(b.w);
}

// The limbs of one element at p, limb rows `stride` apart, and the store.
__device__ __forceinline__ Fe ld_strided(const int32_t* __restrict__ p, int64_t stride) {
  Fe v;
#pragma unroll
  for (int k = 0; k < 8; k++)
    v.w[k] = ((uint32_t)p[2 * k * stride] & 0xffffu) | ((uint32_t)p[(2 * k + 1) * stride] << 16);
  return v;
}

__device__ __forceinline__ void st_strided(int32_t* __restrict__ p, int64_t stride, const Fe& v) {
#pragma unroll
  for (int k = 0; k < 8; k++) {
    p[2 * k * stride] = (int32_t)(v.w[k] & 0xffffu);
    p[(2 * k + 1) * stride] = (int32_t)(v.w[k] >> 16);
  }
}

template <int F>
__device__ __forceinline__ Fe const_fe(const uint32_t (&c)[2][8]) {
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; j++) r.w[j] = c[F][j];
  return r;
}

// The column sums of one element (cs[t * stride], t < 63) -> the value
// sum_t 2^(8t) col_t mod p, canonical: V into 17 words (68 digits; V <
// 2^526, so the carry is spent by digit 66), V = A0 + A1 2^256 + A2 2^512,
// (A0 mod p) + mul(A1 mod p, R^2) + mul(A2, R^3).
template <int F>
__device__ __forceinline__ Fe dft_fold(const uint32_t* __restrict__ cs, int stride) {
  uint32_t vw[17];
#pragma unroll
  for (int q = 0; q < 17; q++) vw[q] = 0;
  uint32_t carry = 0;
#pragma unroll
  for (int t = 0; t < 68; t++) {
    const uint32_t v = (t < 2 * DFT_D - 1 ? cs[t * stride] : 0u) + carry;
    vw[t >> 2] |= (v & 0xffu) << (8 * (t & 3));
    carry = v >> 8;
  }
  Fe a0, a1, a2;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    a0.w[j] = vw[j];
    a1.w[j] = vw[8 + j];
    a2.w[j] = j == 0 ? vw[16] : 0u;
  }
  Fe res = add<F>(reduce_256<F>(a0), mul<F>(reduce_256<F>(a1), const_fe<F>(kR2)));
  return add<F>(res, mul<F>(a2, const_fe<F>(kR3)));
}

// Shared memory: the weight tile Ws [32 planes][16 rows][S words], then the
// digit tile Xs [32 digits][8 columns][S words], S = KW + 4 (KW words of the
// padded contraction); after the products, the column sums [64][128] over
// the same space.
extern __shared__ __align__(16) uint32_t dft_sm[];

template <int F>
__global__ void __launch_bounds__(DFT_THREADS, 2)
    dft_stage(const int32_t* __restrict__ x, const uint8_t* __restrict__ planes,
              const int32_t* __restrict__ pre, const int32_t* __restrict__ post, int64_t post_n,
              int32_t* __restrict__ out, int64_t N, int R, int Ro, int C, int KW) {
  const int S = KW + 4;
  uint32_t* Ws = dft_sm;
  uint32_t* Xs = dft_sm + DFT_D * DFT_TM * S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t n0 = (int64_t)blockIdx.x * DFT_TN;
  const int m0 = blockIdx.y * DFT_TM;
  const int64_t RC = (int64_t)R * C;

  // 1. the weight rows m0 .. m0 + 15 of every plane, zero past R and Ro
  // (16 bytes a load where rows are whole 16-byte pieces)
  if ((R & 15) == 0) {
    const int KQ = KW / 4;
#pragma unroll 4
    for (int it = tid; it < DFT_D * DFT_TM * KQ; it += DFT_THREADS) {
      const int kq = it % KQ, m = (it / KQ) % DFT_TM, i = it / (KQ * DFT_TM);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + m < Ro && 16 * kq < R)
        v = *reinterpret_cast<const uint4*>(planes + ((int64_t)i * Ro + m0 + m) * R + 16 * kq);
      *reinterpret_cast<uint4*>(Ws + (i * DFT_TM + m) * S + 4 * kq) = v;
    }
  } else {
    for (int it = tid; it < DFT_D * DFT_TM * KW; it += DFT_THREADS) {
      const int kw = it % KW, m = (it / KW) % DFT_TM, i = it / (KW * DFT_TM);
      uint32_t v = 0;
      if (m0 + m < Ro && 4 * kw < R) {
        const uint8_t* row = planes + ((int64_t)i * Ro + m0 + m) * R;
#pragma unroll
        for (int q = 0; q < 4; q++)
          if (4 * kw + q < R) v |= (uint32_t)row[4 * kw + q] << (8 * q);
      }
      Ws[(i * DFT_TM + m) * S + kw] = v;
    }
  }
  // 2. the digits of columns n0 .. n0 + 7, one element (times pre) a
  // thread: digit j of row r is byte r % 4 of word r / 4 of digit plane j
  uint8_t* xs8 = reinterpret_cast<uint8_t*>(Xs);
  for (int it = tid; it < DFT_TN * 4 * KW; it += DFT_THREADS) {
    const int n = it % DFT_TN, r = it / DFT_TN;
    const int64_t nn = n0 + n;
    Fe v;
#pragma unroll
    for (int k = 0; k < 8; k++) v.w[k] = 0;
    if (nn < N && r < R) {
      const int64_t l = nn / C, c = nn % C;
      v = ld_strided(x + l * 16 * RC + r * (int64_t)C + c, RC);
      if (pre != nullptr) v = mul<F>(v, ld_strided(pre + r * (int64_t)C + c, RC));
    }
    uint8_t* col = xs8 + 4 * (n * S + (r >> 2)) + (r & 3);
#pragma unroll
    for (int j = 0; j < DFT_D; j++) col[4 * j * DFT_TN * S] = (uint8_t)(v.w[j >> 2] >> (8 * (j & 3)));
  }
  __syncthreads();

  // 3. the products: warp w sums every pair (i, t - i) of its columns t
  const int g = lane >> 2, tg = lane & 3;
  const int t0 = kDftT0[warp], t1 = kDftT1[warp];
  uint32_t acc[DFT_WMAX][4];
#pragma unroll
  for (int dt = 0; dt < DFT_WMAX; dt++)
#pragma unroll
    for (int e = 0; e < 4; e++) acc[dt][e] = 0;
  const uint32_t* wa = Ws + g * S + tg;
  const uint32_t* xb = Xs + g * S + tg;
  switch (warp) {  // the windows of kDftT0 / kDftT1
    case 0: dft_window<0, 14>(wa, xb, S, KW, acc); break;
    case 1: dft_window<15, 21>(wa, xb, S, KW, acc); break;
    case 2: dft_window<22, 26>(wa, xb, S, KW, acc); break;
    case 3: dft_window<27, 31>(wa, xb, S, KW, acc); break;
    case 4: dft_window<32, 35>(wa, xb, S, KW, acc); break;
    case 5: dft_window<36, 40>(wa, xb, S, KW, acc); break;
    case 6: dft_window<41, 47>(wa, xb, S, KW, acc); break;
    default: dft_window<48, 62>(wa, xb, S, KW, acc); break;
  }
  __syncthreads();  // every warp has read the tiles: the column sums reuse them
  uint32_t* cs = dft_sm;  // [64][128]: column t of element m * 8 + n
#pragma unroll
  for (int dt = 0; dt < DFT_WMAX; dt++) {
    if (t0 + dt <= t1) {
      uint32_t* row = cs + (t0 + dt) * (DFT_TM * DFT_TN);
      row[g * DFT_TN + 2 * tg] = acc[dt][0];
      row[g * DFT_TN + 2 * tg + 1] = acc[dt][1];
      row[(g + 8) * DFT_TN + 2 * tg] = acc[dt][2];
      row[(g + 8) * DFT_TN + 2 * tg + 1] = acc[dt][3];
    }
  }
  __syncthreads();

  // 4. the epilogue: one thread an element of the tile
  if (tid >= DFT_TM * DFT_TN) return;
  const int m = tid / DFT_TN, n = tid % DFT_TN;
  const int k = m0 + m;
  const int64_t nn = n0 + n;
  if (k >= Ro || nn >= N) return;
  Fe res = dft_fold<F>(cs + tid, DFT_TM * DFT_TN);
  const int64_t l = nn / C, c = nn % C;
  if (post != nullptr)
    res = mul<F>(res, post_n == 1 ? ld_strided(post, 1)
                                  : ld_strided(post + k * (int64_t)C + c, post_n));
  const int64_t RoC = (int64_t)Ro * C;
  st_strided(out + l * 16 * RoC + k * (int64_t)C + c, RoC, res);
}

extern "C" int h2_dft_stage(int field, const int32_t* x, const uint8_t* planes, const int32_t* pre,
                            const int32_t* post, int64_t post_n, int32_t* out, int64_t L,
                            int64_t R, int64_t Ro, int64_t C, void* stream) {
  if (R < 1 || R > DFT_MAX_R || Ro < 1 || Ro > DFT_MAX_R || C < 1 || L < 0 ||
      (post != nullptr && post_n != 1 && post_n != Ro * C))
    return (int)cudaErrorInvalidValue;
  const int64_t N = L * C;
  const int KW = (int)((R + 31) / 32) * 8;
  const size_t smem = 4 * (size_t)DFT_D * (DFT_TM + DFT_TN) * (KW + 4);
  const int64_t col_blocks = (N + DFT_TN - 1) / DFT_TN;
  cudaStream_t s = (cudaStream_t)stream;
  if (col_blocks > 0) {
    if (col_blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    auto kernel = field == 0 ? dft_stage<0> : dft_stage<1>;
    const int rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
    if (rc) return rc;
    const dim3 grid((unsigned)col_blocks, (unsigned)((Ro + DFT_TM - 1) / DFT_TM));
    kernel<<<grid, DFT_THREADS, smem, s>>>(x, planes, pre, post, post_n, out, N, (int)R, (int)Ro,
                                           (int)C, KW);
  }
  return (int)cudaGetLastError();
}

// --- dft_ntt: a whole base transform of up to 2^11 points in one launch -----
// MxuNTT's two stages (ops/ntt_mxu.py; halo2_lib_tpu/ops/ntt_mxu.py:256-289,
// each stage _stage_limbs + _fold_mod_p) with the transpose between them, as
// one kernel: for n = N1 N2 (8 <= N2 <= 32, N2 <= N1 <= 64, n = 2^6..2^11), every
// column l of x int32[L, 16, n] (natural order, Montgomery),
//     A[k1, c] = sum_r W1[k1, r] (pre * x)[r N2 + c]     (stage 1)
//     B[k1, c] = A[k1, c] tw[k1, c]                       (the twiddle)
//     out[k1 + N1 k2] = post * sum_c W2[k2, c] B[k1, c]   (stage 2),
// canonical int32[L, 16, n] in natural order; w1, w2: uint8[32, N1, N1],
// [32, N2, N2] the digit planes of the canonical DFT matrices; tw: [16, N1,
// N2]; pre: [16, n] or null; post: [16, n], [16, 1] or null. Each output
// equals dft_stage, the transpose and dft_stage bit for bit (both fold to the
// canonical residue).
//
// Design: a block owns one column l and KT = 8 rows k1 for both stages.
// Stage 1 needs every r of its rows but no other row; stage 2 needs only
// B[k1, .] of the same rows; so the stages exchange nothing: no transpose,
// no round trip of A through device memory, no second launch. Both stages put k1 on the mma's N side (8 columns a tile) and c or
// k2 on its M side (16 rows a tile): stage 1 is D[c, k1] = sum_r X[r, c]
// W1[k1, r], stage 2 D[k2, k1] = sum_c W2[k2, c] B[k1, c]. Shared memory
// holds four operand panels, each 32 digit planes of rows x 32-byte chunks
// of the contraction (a row's eight words, word w at w ^ (row & 4), so the
// lanes of a fragment load hit 32 distinct banks with no padding): XA, the
// column's digits (rows c, contraction r; 64 KB at 2^11); WB1, the block's
// rows of W1 (rows k1, contraction r); WA2, all of W2 (rows k2, contraction
// c), both copied by cp.async under the staging; BB, B's digits (rows k1,
// contraction c), written by stage 1's epilogue; and the column sums of up
// to two tiles (64 KB), which 256 threads fold (one element a thread, the
// twiddle or post limbs loaded before the fold). Only the weight panels'
// padding is zeroed: it keeps the digits' unwritten padding out of every
// sum, and padding rows give outputs no one stores.
//
// Every block of a column needs all of XA, and each x element times pre is
// one product: the N1 / KT blocks of a column form a cluster, each stages
// only its own rows r = k0 .. k0 + KT - 1 (one element a thread) and writes
// their words into the column's panel in device memory (xs, L2-resident),
// and after the cluster barrier every block copies the whole panel back
// (cp.async). (Pushing the words into the other blocks' shared memory over
// the cluster took longer than this round trip through L2.) The warps own
// windows of the digit-sum columns t as in dft_stage (the same compile-time
// windows); a warp loads the fragments of each i before its products. At
// 2^11 and KT = 8: 184 KB, one block an SM; a k = 9 call of 12 columns is 96
// blocks in clusters of 8. 183 registers, no spills; with 16 warps a block
// (128 registers) it ran slower, and so did 16 rows a block (48 blocks in
// clusters of 4; PERF.md, dft_probe.py --variants builds it with
// -DDFT_NTT_KT=16). Stage 2's contraction (c < N2) is one 32-byte chunk, so
// N2 <= 32: 2^12 and above are two dft_stage launches.
//
// Bound on the H100: operations, as dft_stage: stage 1 1024 N1 n u8 MACs a
// column, stage 2 1024 N2 n, at [12, 16, 2^11] 2.4 G MACs, 2.4 us at the int8
// peak (mma.sync reaches about 57% of it on this card: dft_probe.py
// --mma-rate); the bytes (x, out, the diagonals, the planes) 0.2 us.

// Every digit pair of one warp's window for one 16 x 8 tile of dft_ntt's
// panels (dft_window's loops on swizzled panels): pa, pb the lane's row g in
// plane 0, chunk 0 of the A and B panels; o0 its first fragment word (tg,
// swizzled) and o0 ^ 4 the word 16 bytes on; A's rows g + 8 lie 64 words on.
template <int T0, int T1>
__device__ __forceinline__ void ntt_window(const uint32_t* __restrict__ pa,
                                           const uint32_t* __restrict__ pb, int o0, int a_plane,
                                           int b_plane, int a_chunk, int b_chunk, int NQ,
                                           uint32_t (&acc)[DFT_WMAX][4]) {
  constexpr int ILO = T0 > DFT_D - 1 ? T0 - (DFT_D - 1) : 0;
  constexpr int IHI = T1 < DFT_D - 1 ? T1 : DFT_D - 1;
  constexpr int W = T1 - T0 + 1;
  const int o2 = o0 ^ 4;
  for (int q = 0; q < NQ; q++) {
#pragma unroll
    for (int i = ILO; i <= IHI; i++) {
      // every fragment of this i first, then its products
      const uint32_t* a = pa + i * a_plane + q * a_chunk;
      const uint32_t a0 = a[o0], a1 = a[64 + o0], a2 = a[o2], a3 = a[64 + o2];
      uint32_t b0[W], b1[W];
#pragma unroll
      for (int dt = 0; dt < W; dt++) {
        const int j = T0 + dt - i;
        if (j >= 0 && j < DFT_D) {
          const uint32_t* b = pb + j * b_plane + q * b_chunk;
          b0[dt] = b[o0];
          b1[dt] = b[o2];
        }
      }
#pragma unroll
      for (int dt = 0; dt < W; dt++) {
        const int j = T0 + dt - i;
        if (j >= 0 && j < DFT_D) mma_u8(acc[dt], a0, a1, a2, a3, b0[dt], b1[dt]);
      }
    }
  }
}

// Copy `rows` rows of one digit plane after another (32 planes, rows of
// `len` bytes, `plane_rows` rows a plane in global memory, from src) into an
// operand panel (NQ chunks of 32 bytes a row, `panel_rows` rows a plane),
// each row's words swizzled, by cp.async of 16 bytes (8 where len is 8).
__device__ __forceinline__ void weights_async(uint32_t* panel, const uint8_t* __restrict__ src,
                                              int len, int rows, int NQ, int plane_len_rows,
                                              int panel_rows, int tid) {
  const int step = len < 16 ? 8 : 16, pieces = len / step;  // powers of two, as rows
  const int lp = __ffs(pieces) - 1, lr = __ffs(rows) - 1;
  for (int it = tid; it < 32 * rows * pieces; it += DFT_THREADS) {
    const int pc = it & (pieces - 1), m = (it >> lp) & (rows - 1), i = it >> (lp + lr);
    const int w = pc * step / 4;  // first word of the piece in the row
    uint32_t* dst = panel + ((i * NQ + w / 8) * panel_rows + m) * 8 + ((w % 8) ^ (m & 4));
    const uint8_t* s = src + ((int64_t)i * plane_len_rows + m) * len + pc * step;
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
    if (step == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(s));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(s));
  }
}

#ifndef DFT_NTT_KT
#define DFT_NTT_KT 8
#endif
constexpr int KT = DFT_NTT_KT;  // k1 rows a dft_ntt block owns

template <int F>
__global__ void __launch_bounds__(DFT_THREADS, 1)
    dft_ntt_k(const int32_t* __restrict__ x, const uint8_t* __restrict__ w1,
              const uint8_t* __restrict__ w2, const int32_t* __restrict__ tw,
              const int32_t* __restrict__ pre, const int32_t* __restrict__ post, int64_t post_n,
              int32_t* __restrict__ out, uint32_t* __restrict__ xs, int N1, int N2) {
  const int n = N1 * N2;
  const int NQ1 = (N1 + 31) / 32;      // 32-byte chunks of stage 1's contraction
  const int M = N2 < 16 ? 16 : N2;     // rows of XA (c) and of WA2 (k2)
  const int MT = M / 16;               // m-tiles a stage
  uint32_t* XA = dft_sm;               // [32][NQ1][M][8]
  uint32_t* WB1 = XA + 32 * NQ1 * M * 8;  // [32][NQ1][KT][8]
  uint32_t* WA2 = WB1 + 32 * NQ1 * KT * 8;  // [32][M][8]
  uint32_t* BB = WA2 + 32 * M * 8;     // [32][KT][8]
  uint32_t* CS = BB + 32 * KT * 8;     // [64][256]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int S = N1 / KT;               // the column's blocks, one cluster
  const int64_t l = blockIdx.x / S;
  const int rank = (int)(blockIdx.x % S);
  const int k0 = rank * KT;
  const int32_t* xl = x + l * 16 * (int64_t)n;
  const int ln2 = __ffs(N2) - 1;
  cg::cluster_group cluster = cg::this_cluster();
  uint32_t* xsl = xs + l * (int64_t)(WB1 - XA);  // the column's panel in device memory

  // 0. zero the weight panels where their contraction is padded (past N1,
  // N2 below 32 points: the zero bytes keep the digits' padding, which no one
  // writes, from counting; padding rows give outputs no one stores), then
  // start the weights' copies: WB1 <- W1's rows k0 .. k0 + KT - 1, WA2 <- W2,
  // in pieces of 16 bytes (8 where a row has 8), asynchronous (cp.async)
  // under the digit staging
  if (N1 < 32 || N2 < 32) {
    for (int i = tid; i < (int)(BB - WB1) / 4; i += DFT_THREADS)
      reinterpret_cast<uint4*>(WB1)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }
  weights_async(WB1, w1 + (int64_t)k0 * N1, N1, KT, NQ1, N1, KT, tid);
  weights_async(WA2, w2, N2, N2, 1, N2, M, tid);
  // 1. the column's digits, shared by the cluster: this block stages rows
  // r = k0 .. k0 + KT - 1 (pre times x, one element a thread, its 32 digit
  // bytes where the panel keeps them; a warp takes 8 rows by 4 columns, so
  // each byte store hits 8 distinct words) and writes their words into the
  // column's copy of the panel in device memory (xs); after the cluster
  // barrier every block copies the whole panel back (cp.async)
  uint8_t* xa8 = reinterpret_cast<uint8_t*>(XA);
#pragma unroll 2
  for (int it = tid; it < KT * N2; it += DFT_THREADS) {
    const int r = k0 + it % KT, c = it / KT;
    const int idx = (r << ln2) + c;
    Fe v = ld_strided(xl + idx, n);
    if (pre != nullptr) v = mul<F>(v, ld_strided(pre + idx, n));
    uint8_t* dst = xa8 + 4 * ((((r >> 5) * M + c) << 3) + (((r & 31) >> 2) ^ (c & 4))) + (r & 3);
#pragma unroll
    for (int j = 0; j < DFT_D; j++)
      dst[4 * j * NQ1 * M * 8] = (uint8_t)(v.w[j >> 2] >> (8 * (j & 3)));
  }
  __syncthreads();
  for (int it = tid; it < DFT_D * N2; it += DFT_THREADS) {
    const int c = it & (N2 - 1), j = it >> ln2;
    const int off = (((j * NQ1 + (k0 >> 5)) * M + c) << 3) + (((k0 & 31) >> 2) ^ (c & 4));
    if (KT == 8)
      *reinterpret_cast<uint2*>(xsl + off) = *reinterpret_cast<const uint2*>(XA + off);
    else
      *reinterpret_cast<uint4*>(xsl + off) = *reinterpret_cast<const uint4*>(XA + off);
  }
  cluster.sync();  // every block's rows are in device memory
  for (int i = tid; i < (int)(WB1 - XA) / 4; i += DFT_THREADS)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     (uint32_t)__cvta_generic_to_shared(XA + 4 * i)),
                 "l"(xsl + 4 * i));
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();  // the panels (and the weights) are in place

  // 2. the stages, each in rounds of up to two 16 x 8 tiles: the products
  // (warp w sums every pair of its window into its accumulators), the
  // column sums into CS, then one element a thread: the fold, and the
  // twiddle and B's digits into BB (stage 1) or the post product and the
  // store (stage 2); the twiddle or post limbs are loaded before the fold
  const int g = lane >> 2, tg = lane & 3;
  const int o0 = tg ^ (g & 4);  // the lane's first fragment word in a row
  const int t0 = kDftT0[warp], t1 = kDftT1[warp];
  const int tiles = MT * (KT / 8);
  uint8_t* bb8 = reinterpret_cast<uint8_t*>(BB);
  for (int stage = 0; stage < 2; stage++) {
    const uint32_t* A = stage == 0 ? XA : WA2;
    const uint32_t* B = stage == 0 ? WB1 : BB;
    const int NQ = stage == 0 ? NQ1 : 1;
    const int a_chunk = M * 8, b_chunk = KT * 8;
    const int a_plane = NQ * a_chunk, b_plane = NQ * b_chunk;
    for (int r0 = 0; r0 < tiles; r0 += 2) {
      const int in_round = tiles - r0 < 2 ? tiles - r0 : 2;
      for (int u = 0; u < in_round; u++) {
        const int mt = (r0 + u) % MT, nt = (r0 + u) / MT;
        const uint32_t* pa = A + (mt * 16 + g) * 8;
        const uint32_t* pb = B + (nt * 8 + g) * 8;
        uint32_t acc[DFT_WMAX][4];
#pragma unroll
        for (int dt = 0; dt < DFT_WMAX; dt++)
#pragma unroll
          for (int e = 0; e < 4; e++) acc[dt][e] = 0;
        switch (warp) {  // the windows of kDftT0 / kDftT1
          case 0: ntt_window<0, 14>(pa, pb, o0, a_plane, b_plane, a_chunk, b_chunk, NQ, acc); break;
          case 1: ntt_window<15, 21>(pa, pb, o0, a_plane, b_plane, a_chunk, b_chunk, NQ, acc); break;
          case 2: ntt_window<22, 26>(pa, pb, o0, a_plane, b_plane, a_chunk, b_chunk, NQ, acc); break;
          case 3: ntt_window<27, 31>(pa, pb, o0, a_plane, b_plane, a_chunk, b_chunk, NQ, acc); break;
          case 4: ntt_window<32, 35>(pa, pb, o0, a_plane, b_plane, a_chunk, b_chunk, NQ, acc); break;
          case 5: ntt_window<36, 40>(pa, pb, o0, a_plane, b_plane, a_chunk, b_chunk, NQ, acc); break;
          case 6: ntt_window<41, 47>(pa, pb, o0, a_plane, b_plane, a_chunk, b_chunk, NQ, acc); break;
          default: ntt_window<48, 62>(pa, pb, o0, a_plane, b_plane, a_chunk, b_chunk, NQ, acc); break;
        }
        uint32_t* cs = CS + u * (DFT_TM * DFT_TN);  // element u * 128 + m * 8 + n
#pragma unroll
        for (int dt = 0; dt < DFT_WMAX; dt++) {
          if (t0 + dt <= t1) {
            uint32_t* row = cs + (t0 + dt) * 256;
            row[g * DFT_TN + 2 * tg] = acc[dt][0];
            row[g * DFT_TN + 2 * tg + 1] = acc[dt][1];
            row[(g + 8) * DFT_TN + 2 * tg] = acc[dt][2];
            row[(g + 8) * DFT_TN + 2 * tg + 1] = acc[dt][3];
          }
        }
      }
      __syncthreads();
      if (tid < in_round * DFT_TM * DFT_TN) {
        const int u = tid >> 7, m = (tid >> 3) & 15, nn = tid & 7;
        const int mt = (r0 + u) % MT, nt = (r0 + u) / MT;
        const int row = mt * 16 + m, kl = nt * 8 + nn;  // row: c (stage 1) or k2
        if (row < N2) {
          const int idx = k0 + kl + N1 * row;  // stage 2's output index
          // the twiddle (stage 1) or post, loaded before the fold
          const bool aux_on = stage == 0 || post != nullptr;
          Fe aux;
          if (stage == 0)
            aux = ld_strided(tw + (k0 + kl) * N2 + row, n);
          else if (post != nullptr)
            aux = post_n == 1 ? ld_strided(post, 1) : ld_strided(post + idx, n);
          Fe v = dft_fold<F>(CS + tid, 256);
          if (aux_on) v = mul<F>(v, aux);
          if (stage == 0) {
            uint8_t* dst = bb8 + 4 * (kl * 8 + ((row >> 2) ^ (kl & 4))) + (row & 3);
#pragma unroll
            for (int j = 0; j < DFT_D; j++)
              dst[4 * j * KT * 8] = (uint8_t)(v.w[j >> 2] >> (8 * (j & 3)));
          } else {
            st_strided(out + l * 16 * (int64_t)n + idx, n, v);
          }
        }
      }
      __syncthreads();
    }
  }
}

// dft_ntt_k's dynamic shared memory: the four operand panels and the column
// sums of two tiles
static size_t dft_ntt_smem(int64_t N1, int64_t N2) {
  const int64_t NQ1 = (N1 + 31) / 32, M = N2 < 16 ? 16 : N2;
  return 4 * ((size_t)32 * 8 * (NQ1 * M + NQ1 * KT + M + KT) + 64 * 256);
}

// xs: scratch of L * 32 * ceil(N1 / 32) * max(N2, 16) * 8 words (dft_ntt_scratch_words), the
// columns' digit panels in device memory.
extern "C" int h2_dft_ntt(int field, const int32_t* x, const uint8_t* w1, const uint8_t* w2,
                          const int32_t* tw, const int32_t* pre, const int32_t* post,
                          int64_t post_n, int32_t* out, uint32_t* xs, int64_t L, int64_t N1,
                          int64_t N2, void* stream) {
  const int64_t n = N1 * N2;
  if (N2 < 8 || N2 > 32 || N2 > N1 || N1 > 64 || KT > N1 || (N1 & (N1 - 1)) ||
      (N2 & (N2 - 1)) || L < 0 || (post != nullptr && post_n != 1 && post_n != n))
    return (int)cudaErrorInvalidValue;
  if (L == 0) return (int)cudaGetLastError();
  const int64_t blocks = L * (N1 / KT);
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  auto kernel = field == 0 ? dft_ntt_k<0> : dft_ntt_k<1>;
  // the shared-memory limit (the largest shape's), set once a field and
  // device: a host call a launch saves
  static std::atomic<bool> attr_set[2][64];
  int dev = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc) return rc;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!attr_set[field != 0][dev]) {
    rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)dft_ntt_smem(64, 32));
    if (rc) return rc;
    attr_set[field != 0][dev] = true;
  }
  const size_t smem = dft_ntt_smem(N1, N2);
  // the N1 / KT blocks of a column form one cluster (at most 8)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(DFT_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)(N1 / KT);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = (int)cudaLaunchKernelEx(&cfg, kernel, x, w1, w2, tw, pre, post, post_n, out, xs, (int)N1,
                               (int)N2);
  if (rc) return rc;
  return (int)cudaGetLastError();
}
