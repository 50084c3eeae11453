// Family D: bn254 G1 point arithmetic in Jacobian coordinates over Fq, on
// limb-major int32[L, 16, B] coordinate tensors (identity: Z == 0).
//
// Replaces, in halo2_lib_tpu/ops/pallas_field.py:
//   _ec_add_kernel (via ec_add): complete add, add-2007-bl plus the doubling
//     branch and the identity and inverse cases;
//   _ec_double_kernel (via ec_double): dbl-2009-l with a = 0;
//   _ec_madd_kernel (via ec_madd; its body is _madd_core): the standalone
//     mixed add, Jacobian + affine (madd-2007-bl, (0, 0) = affine identity);
//     ec_add, ec_double and ec_madd stay as checked literal ports, off every
//     path;
//   _bucket_scan_kernel (via bucket_scan): the MSM bucket accumulation, an
//     inclusive segmented scan of mixed adds (madd-2007-bl, the arithmetic of
//     _madd_core) over bucket-sorted affine bases; kept as the literal port
//     (chip_smoke.py holds it to its plain version and times it), while the
//     MSM runs
//   bucket_sums (chain + carry launches): the same bucket accumulation with
//     its lane-carry scan, pick and fix (halo2_lib_tpu/ops/ec_device.py:463-
//     591, where the scan was one _bucket_scan_kernel call and the carries a
//     loop of _ec_add_kernel calls), writing only the bucket sums;
// and, as two fused kernels, the loops of _ec_add_kernel / _ec_double_kernel
// launches that end a Pippenger MSM (halo2_lib_tpu/ops/ec_device.py:624-688,
// lax.scan and fori_loop bodies there):
//   bucket_weight: the weighted bucket reduction (the (acc, tot) row scan, the
//     two within-block suffix scans, D = TT - TA, the log2(CL2) doublings and
//     + TS), one block per window;
//   msm_combine: the MSB-first window combine (c doublings and one add per
//     window), one thread per column;
// and, as one fused kernel in two launches, the small-column commit
// (m <= 1024, every commit at k <= 10; halo2_lib_tpu/backend/kzg.py:499-519,
// a lax.scan of _ec_double_kernel and _ec_madd_kernel steps, then the
// _ec_add_kernel lane tree of ops/ec_device.py:308):
//   commit_dbl_add: a chain launch, one thread per (column, lane) running its
//     scalar's double-and-add from the top bit with the accumulator in
//     registers and the mixed add only where the bit is 1, then a tree launch
//     of one block per column over the lanes' sums in shared memory;
// and the SRS setup's per-lane multiple of the generator
// (halo2_lib_tpu/backend/kzg.py:635-661, a lax.scan of _ec_double_kernel and
// _ec_add_kernel steps on every lane):
//   g1_batch_mul: a fixed-base comb (g1_fixed_mul_k), each lane summing
//     signed 7-bit digits' multiples of G from a table in shared memory, one
//     mixed add a nonzero digit and no doubling (see its section below).
//
// Bound on the H100: integer multiply issue. A complete add is 16 Montgomery
// products on its add path (the doubling branch, taken on no lane of an MSM
// in practice, runs dbl-2009-l's 7 instead), a double 7, a mixed add 11 (17
// with the doubling branch), against at most 288 bytes of coordinates per
// point. The fused kernels are bound by their serial chains and by how many
// of them an SM holds: a lane of bucket_weight runs 2 * R2 + 3 log2(CL2)
// complete adds in order, a column of msm_combine W * c doublings and W adds
// (about 2400 products at W = 26, c = 10), a bucket_sums chain R = n / CL
// mixed adds (128 at n = 2^15), a commit_dbl_add lane up to 254 doublings
// and a mixed add per set bit (a warp runs the mixed add wherever one of
// its lanes needs it: about 254 x 18 products), a g1_batch_mul lane at most
// 37 mixed adds, each product a dependent chain of 32-bit multiply-adds
// (fp256.cuh: PTX carry chains).
//
// Design: one thread per point (or chain), every coordinate in registers; the
// formulas are those of ops/ec_device.py, and the fused kernels run that
// file's loops in their order, so each kernel agrees bit for bit with its
// plain version. The complete add branches on its cases instead of selecting
// between computed branches, so the add path holds only its own temporaries
// (ec_add_k: no spills).
// ec_madd reads the affine operand with its own row and lane strides, so one
// [16, m] set of bases serves every column of a [C, 16, m] accumulator
// without being copied C times; the `distinct` flag is a template parameter,
// so the doubling branch (6 of its 17 products) is compiled out when the
// caller drops it. bucket_scan gives one thread to each (window, lane) chain,
// which walks the chain's R steps in order with its accumulator in
// registers: that loop replaces the TPU kernel's sequential grid axis and its
// VMEM accumulators. bucket_sums keeps those chains but reads each base
// straight from the point-major table by the sorted order (64 bytes, four
// 16-byte loads, L2-resident at n = 2^15), writes a sum only where a bucket's
// run ends (no per-step output), and runs the lane carries in a second launch
// of one block per window. bucket_weight reads each bucket sum once
// and keeps the row chain in registers and the suffix scans in shared memory;
// msm_combine replaces 286 launches of a few dozen threads each.
// commit_dbl_add replaces 254 x 5 launches and a lane tree per commit: one
// thread walks its lane's bits with the accumulator in registers, the mixed
// add a branch taken only where the bit is 1 (and the doubling branch only
// where it is met), then one block sums a column's lanes in shared memory;
// both launches call one out-of-line copy of the product (MulCalled), which
// keeps their loop bodies inside the instruction cache. Left for
// later: warp-cooperative bucket runs and shorter chains (they change the
// order of the adds, so the Jacobian sums, though not the affine points), a
// prefetch of the next base in the chains, and fewer idle threads in the last
// wave of chains (Wtot * CL threads of 134 registers, three 128-thread blocks
// an SM).
#include <atomic>

#include "fp256.cuh"

using namespace h2;

constexpr int FQ = 1;

struct Jac {
  Fe x, y, z;
};

__device__ __forceinline__ Jac identity() {
  Jac o;
  o.x = zero();
  o.y = zero();
  o.z = zero();
  return o;
}

// Point (r, e) of three [L, 16, B] coordinate tensors (see load).
__device__ __forceinline__ Jac load_jac(const int32_t* __restrict__ x,
                                        const int32_t* __restrict__ y,
                                        const int32_t* __restrict__ z, int64_t L, int64_t B,
                                        int64_t r, int64_t e) {
  Jac P;
  P.x = load(x, L, B, r, e);
  P.y = load(y, L, B, r, e);
  P.z = load(z, L, B, r, e);
  return P;
}

// The Fq Montgomery product as a policy of the point formulas: inlined at
// each site (the default), or one out-of-line copy that every site calls.
// A formula inlines about 300 instructions a product; a loop body of a
// doubling and a mixed add (25 products with the doubling branch) then
// outgrows the SM's instruction cache, and a chain run by a warp or two an
// SM waits on instruction fetch (commit_chain_k: 2.5x slower inlined, the
// same result).
struct MulInline {
  __device__ __forceinline__ Fe operator()(const Fe& a, const Fe& b) const {
    return mul<FQ>(a, b);
  }
};
__device__ __noinline__ Fe mul_called(Fe a, Fe b) { return mul<FQ>(a, b); }
struct MulCalled {
  __device__ __forceinline__ Fe operator()(const Fe& a, const Fe& b) const {
    return mul_called(a, b);
  }
};

template <class M = MulInline>
__device__ __forceinline__ Jac ec_double_jac(const Jac& P, M mm = M()) {
  const Fe A = mm(P.x, P.x), B = mm(P.y, P.y);
  const Fe E = add<FQ>(dbl<FQ>(A), A);
  const Fe tXB = add<FQ>(P.x, B);
  const Fe C = mm(B, B), tXB2 = mm(tXB, tXB), F_ = mm(E, E);
  const Fe D = dbl<FQ>(sub<FQ>(sub<FQ>(tXB2, A), C));
  Jac out;
  out.x = sub<FQ>(F_, dbl<FQ>(D));
  const Fe C4 = dbl<FQ>(dbl<FQ>(C));
  out.y = sub<FQ>(mm(E, sub<FQ>(D, out.x)), dbl<FQ>(C4));
  out.z = dbl<FQ>(mm(P.y, P.z));
  return out;
}

// Complete add: add-2007-bl and the cases of ops/ec_device.py. Either
// operand the identity returns the other (P when both are); P + P returns
// dbl-2009-l of P; P + (-P) takes the add path, whose Z3 = ZZ * H is then 0,
// as the plain version's is_ident select makes it. The add path computes its
// own 16 products only, and the doubling runs only on the lanes that take it
// (none, in practice, in an MSM). The order keeps few values live: P stays
// for the doubling until H and r are known; each of Q's coordinates and both
// squares die as soon as they are used (S1 = Y1 (Z2 Z2Z2) and S2 = Y2 (Z1
// Z1Z1), the same field elements as Y1 Z2 Z2Z2 and Y2 Z1 Z1Z1).
template <class M = MulInline>
__device__ __forceinline__ Jac ec_add_complete(const Jac& P, const Jac& Q, M mm = M()) {
  if (is_zero(Q.z)) return P;
  if (is_zero(P.z)) return Q;
  const Fe Z1Z1 = mm(P.z, P.z);
  const Fe Z2Z2 = mm(Q.z, Q.z);
  const Fe zz = add<FQ>(P.z, Q.z);
  const Fe ZZ = sub<FQ>(sub<FQ>(mm(zz, zz), Z1Z1), Z2Z2);  // 2 Z1 Z2
  const Fe S1 = mm(P.y, mm(Q.z, Z2Z2));
  const Fe U1 = mm(P.x, Z2Z2);
  const Fe H = sub<FQ>(mm(Q.x, Z1Z1), U1);
  const Fe r_ = sub<FQ>(mm(Q.y, mm(P.z, Z1Z1)), S1);
  if (is_zero(H) && is_zero(r_)) return ec_double_jac(P, mm);
  Jac out;
  out.z = mm(ZZ, H);
  const Fe HH = mm(H, H);
  const Fe I = dbl<FQ>(dbl<FQ>(HH));
  const Fe J = mm(H, I);
  const Fe V = mm(U1, I);
  const Fe rr = dbl<FQ>(r_);
  out.x = sub<FQ>(sub<FQ>(mm(rr, rr), J), dbl<FQ>(V));
  const Fe S1J = mm(S1, J);
  out.y = sub<FQ>(mm(rr, sub<FQ>(V, out.x)), dbl<FQ>(S1J));
  return out;
}

// The complete add out of line, for the fused kernels' cold call sites (the
// suffix scans, D and + TS): inlined at each of them, the add and its
// doubling branch multiplied bucket_weight_k's compile time for no gain.
__device__ __noinline__ Jac ec_add_cold(Jac P, Jac Q) { return ec_add_complete(P, Q); }

// Jacobian accumulator + affine base (x2, y2); (0, 0) is the affine identity.
// `distinct` drops the doubling branch (sound for SRS bases).
__device__ __forceinline__ Jac ec_madd(const Jac& P, const Fe& x2, const Fe& y2, bool distinct) {
  const Fe &X1 = P.x, &Y1 = P.y, &Z1 = P.z;
  const Fe Z1Z1 = mul<FQ>(Z1, Z1);
  const Fe U2 = mul<FQ>(x2, Z1Z1), t2 = mul<FQ>(y2, Z1);
  const Fe H = sub<FQ>(U2, X1);
  const Fe S2 = mul<FQ>(t2, Z1Z1), HH = mul<FQ>(H, H);
  const Fe rr = dbl<FQ>(sub<FQ>(S2, Y1));
  const Fe I = dbl<FQ>(dbl<FQ>(HH));
  const Fe ZH = add<FQ>(Z1, H);
  const Fe J = mul<FQ>(H, I), V = mul<FQ>(X1, I), rr2 = mul<FQ>(rr, rr), ZH2 = mul<FQ>(ZH, ZH);
  Fe X3 = sub<FQ>(sub<FQ>(rr2, J), dbl<FQ>(V));
  Fe Z3 = sub<FQ>(sub<FQ>(ZH2, Z1Z1), HH);
  const Fe Y1J = mul<FQ>(Y1, J);
  Fe Y3 = sub<FQ>(mul<FQ>(rr, sub<FQ>(V, X3)), dbl<FQ>(Y1J));

  const bool p1_inf = is_zero(Z1);
  const bool live = !(is_zero(x2) && is_zero(y2));
  if (!distinct) {
    const Fe A = mul<FQ>(x2, x2), B = mul<FQ>(y2, y2);
    const Fe xB = add<FQ>(x2, B);
    const Fe C = mul<FQ>(B, B), xB2 = mul<FQ>(xB, xB);
    const Fe E = add<FQ>(dbl<FQ>(A), A);
    const Fe F_ = mul<FQ>(E, E);
    const Fe D = dbl<FQ>(sub<FQ>(sub<FQ>(xB2, A), C));
    const Fe X3d = sub<FQ>(F_, dbl<FQ>(D));
    const Fe Ed = mul<FQ>(E, sub<FQ>(D, X3d));
    const Fe C4 = dbl<FQ>(dbl<FQ>(C));
    const Fe Y3d = sub<FQ>(Ed, dbl<FQ>(C4));
    const Fe Z3d = dbl<FQ>(y2);
    const bool is_double = live && !p1_inf && is_zero(H) && is_zero(rr);
    X3 = sel(is_double, X3d, X3);
    Y3 = sel(is_double, Y3d, Y3);
    Z3 = sel(is_double, Z3d, Z3);
  }
  Jac out;
  out.x = sel(p1_inf, x2, X3);
  out.y = sel(p1_inf, y2, Y3);
  out.z = sel(p1_inf, live ? one<FQ>() : zero(), Z3);
  out.x = sel(!live, X1, out.x);
  out.y = sel(!live, Y1, out.y);
  out.z = sel(!live, Z1, out.z);
  return out;
}

// 128 threads a block, at least two blocks an SM: ptxas may take up to 255
// registers (it takes about 150 and spills nothing); held to 128 (two
// 256-thread blocks) or to 168 (three 128-thread blocks) it spills.
constexpr int EC_ADD_THREADS = 128;

__global__ void __launch_bounds__(EC_ADD_THREADS, 2)
ec_add_k(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
         const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,
         const int32_t* __restrict__ y2, const int32_t* __restrict__ z2,
         int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz, int64_t L,
         int64_t B) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L * B) return;
  const int64_t r = i / B, e = i % B;
  const Jac R =
      ec_add_complete(load_jac(x1, y1, z1, L, B, r, e), load_jac(x2, y2, z2, L, B, r, e));
  store(ox, 16, B, r, 0, e, R.x);
  store(oy, 16, B, r, 0, e, R.y);
  store(oz, 16, B, r, 0, e, R.z);
}

__global__ void ec_double_k(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
                            const int32_t* __restrict__ z1, int32_t* __restrict__ ox,
                            int32_t* __restrict__ oy, int32_t* __restrict__ oz, int64_t L,
                            int64_t B) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L * B) return;
  const int64_t r = i / B, e = i % B;
  Jac P;
  P.x = load(x1, L, B, r, e);
  P.y = load(y1, L, B, r, e);
  P.z = load(z1, L, B, r, e);
  const Jac R = ec_double_jac(P);
  store(ox, 16, B, r, 0, e, R.x);
  store(oy, 16, B, r, 0, e, R.y);
  store(oz, 16, B, r, 0, e, R.z);
}

// P1 (x1, y1, z1): [L, 16, B]; the affine (x2, y2): [La, 16, Ba], La in {1, L},
// Ba in {1, B} (broadcast along that axis).
template <bool DISTINCT>
__global__ void ec_madd_k(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
                          const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,
                          const int32_t* __restrict__ y2, int64_t La, int64_t Ba,
                          int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                          int32_t* __restrict__ oz, int64_t L, int64_t B) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L * B) return;
  const int64_t r = i / B, e = i % B;
  Jac P;
  P.x = load(x1, L, B, r, e);
  P.y = load(y1, L, B, r, e);
  P.z = load(z1, L, B, r, e);
  const Fe ax = load(x2, La, Ba, r, e), ay = load(y2, La, Ba, r, e);
  const Jac R = ec_madd(P, ax, ay, DISTINCT);
  store(ox, 16, B, r, 0, e, R.x);
  store(oy, 16, B, r, 0, e, R.y);
  store(oz, 16, B, r, 0, e, R.z);
}

// axy: [Wb, R, 16, CL] packed bases (row j = limb j | limb j+8 << 16; x rows
// 0-7, y rows 8-15); start: [Wb, R, CL] nonzero at bucket-run starts;
// out: [Wb, R, 48, CL] inclusive scan values (x | y | z limb rows).
__global__ void bucket_scan_k(const int32_t* __restrict__ axy, const int32_t* __restrict__ start,
                              int32_t* __restrict__ out, int64_t Wb, int64_t R, int64_t CL,
                              int distinct) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Wb * CL) return;
  const int64_t w = i / CL, l = i % CL;
  Jac acc;
  acc.x = zero();
  acc.y = zero();
  acc.z = zero();
  for (int64_t r = 0; r < R; r++) {
    const int64_t row = w * R + r;
    const int32_t* base = axy + row * 16 * CL + l;
    uint32_t pk[16];
#pragma unroll
    for (int j = 0; j < 16; j++) pk[j] = (uint32_t)base[j * CL];
    Fe x2, y2;
#pragma unroll
    for (int k = 0; k < 8; k++) {
      // limbs 2k and 2k + 1 of each coordinate
      const int m0 = 2 * k, m1 = 2 * k + 1;
      const uint32_t xl = m0 < 8 ? (pk[m0] & 0xffffu) : (pk[m0 - 8] >> 16);
      const uint32_t xh = m1 < 8 ? (pk[m1] & 0xffffu) : (pk[m1 - 8] >> 16);
      const uint32_t yl = m0 < 8 ? (pk[8 + m0] & 0xffffu) : (pk[m0] >> 16);
      const uint32_t yh = m1 < 8 ? (pk[8 + m1] & 0xffffu) : (pk[m1] >> 16);
      x2.w[k] = xl | (xh << 16);
      y2.w[k] = yl | (yh << 16);
    }
    if (start[row * CL + l] != 0) {
      acc.x = zero();
      acc.y = zero();
      acc.z = zero();
    }
    acc = ec_madd(acc, x2, y2, distinct != 0);
    store(out, 48, CL, row, 0, l, acc.x);
    store(out, 48, CL, row, 16, l, acc.y);
    store(out, 48, CL, row, 32, l, acc.z);
  }
}

// --- bucket sums: the MSM's bucket accumulation in two launches --------------
// The function of bucket_scan + the lane-carry scan + the pick and fix of
// ops/ec_device.py before the fusion, with the same adds in the same order,
// so every bucket sum keeps its Jacobian coordinates. Window w's sorted
// slots are CL lanes of R = n / CL consecutive slots; lane l's chain walks
// slots l R .. l R + R - 1.
//
// bases: [npts, 16] words, point-major (x words 0-7, y words 8-15; word k =
// limb 2k | limb 2k + 1 << 16), so one point is four 16-byte loads.
// order, digits: [Wtot, n] int32, each window's digits sorted and the base
// index of each sorted slot. sx, sy, sz: [Wtot, 16, nbk] bucket sums, bucket
// b at slot b - 1; tail: [Wtot, 48, CL] scratch, each lane's trailing sum.
__device__ __forceinline__ void load_base(const int4* __restrict__ bases, int32_t k, Fe& x,
                                          Fe& y) {
  const int4* b = bases + (int64_t)k * 4;
  const int4 q0 = __ldg(b), q1 = __ldg(b + 1), q2 = __ldg(b + 2), q3 = __ldg(b + 3);
  x.w[0] = q0.x, x.w[1] = q0.y, x.w[2] = q0.z, x.w[3] = q0.w;
  x.w[4] = q1.x, x.w[5] = q1.y, x.w[6] = q1.z, x.w[7] = q1.w;
  y.w[0] = q2.x, y.w[1] = q2.y, y.w[2] = q2.z, y.w[3] = q2.w;
  y.w[4] = q3.x, y.w[5] = q3.y, y.w[6] = q3.z, y.w[7] = q3.w;
}

// Launch 1, the chains: one thread per (window, lane), the accumulator in
// registers, reset where a bucket run starts; a dead slot (digit 0) adds the
// affine identity (0, 0). Where a run ends inside the lane, the lane-local
// sum is written to its bucket (a run that began in an earlier lane gets its
// carry in launch 2); the lane's last sum goes to tail. Nothing else is
// written: no per-step output, no gathered copy of the bases.
constexpr int CHAIN_THREADS = 128;

template <bool DISTINCT>
__global__ void __launch_bounds__(CHAIN_THREADS, 3)
bucket_chain_k(const int4* __restrict__ bases, const int32_t* __restrict__ order,
               const int32_t* __restrict__ digits, int32_t* __restrict__ sx,
               int32_t* __restrict__ sy, int32_t* __restrict__ sz, int32_t* __restrict__ tail,
               int64_t Wtot, int n, int CL, int nbk) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Wtot * CL) return;
  const int64_t w = i / CL;
  const int l = (int)(i % CL), R = n / CL, p0 = l * R;
  const int32_t* dw = digits + w * n;
  const int32_t* ow = order + w * n;
  int prev = p0 > 0 ? dw[p0 - 1] : -1;
  int d = dw[p0];
  Jac acc = identity();
  for (int p = p0; p < p0 + R; p++) {
    const int next = p + 1 < n ? dw[p + 1] : -1;
    if (d != prev) acc = identity();
    Fe x2 = zero(), y2 = zero();
    if (d > 0) load_base(bases, ow[p], x2, y2);
    acc = ec_madd(acc, x2, y2, DISTINCT);
    if (d != next && d > 0) {
      store(sx, 16, nbk, w, 0, d - 1, acc.x);
      store(sy, 16, nbk, w, 0, d - 1, acc.y);
      store(sz, 16, nbk, w, 0, d - 1, acc.z);
    }
    prev = d;
    d = next;
  }
  store(tail, 48, CL, w, 0, l, acc.x);
  store(tail, 48, CL, w, 16, l, acc.y);
  store(tail, 48, CL, w, 32, l, acc.z);
}

// Launch 2, the carries: one block per window. (a) The inclusive segmented
// scan of the lanes' trailing sums across the window's CL lanes, flagged
// where a lane holds a run start: the Hillis-Steele levels of _seg_scan,
// add(self, neighbour l - 2^d) where a lane is not yet flagged, in shared
// memory (two buffers, so a thread may own several lanes). (b) Empty buckets
// get Z = 0 and the X, Y that the old pick gathered: the lane-local sum at
// the last slot below them (zeros for a dead run, the first slot's base when
// no slot lies below). (c) A bucket whose run began in an earlier lane, at
// most one per lane, becomes add(lane-local sum, scanned sum of the lane
// before). (b) reads the lane-local sums before (c) changes any.
constexpr int CARRY_THREADS = 256;

__global__ void __launch_bounds__(CARRY_THREADS)
bucket_carry_k(const int4* __restrict__ bases, const int32_t* __restrict__ order,
               const int32_t* __restrict__ digits, int32_t* __restrict__ sx,
               int32_t* __restrict__ sy, int32_t* __restrict__ sz,
               const int32_t* __restrict__ tail, int n, int CL, int nbk) {
  extern __shared__ Jac cbuf[];                        // [2, CL] points
  uint8_t* fbuf = reinterpret_cast<uint8_t*>(cbuf + 2 * CL);  // [2, CL] flags
  const int64_t w = blockIdx.x, Wtot = gridDim.x;
  const int R = n / CL, T = blockDim.x, tid = threadIdx.x;
  const int32_t* dw = digits + w * n;
  for (int l = tid; l < CL; l += T) {
    const int p0 = l * R;
    cbuf[l] = load_jac(tail + w * 48 * CL, tail + (w * 48 + 16) * CL, tail + (w * 48 + 32) * CL,
                       1, CL, 0, l);
    fbuf[l] = l == 0 || dw[p0] != dw[p0 - 1] || dw[p0] != dw[p0 + R - 1];
  }
  __syncthreads();
  int cur = 0;
  for (int sh = 1; sh < CL; sh <<= 1) {
    const Jac* src = cbuf + cur * CL;
    Jac* dst = cbuf + (1 - cur) * CL;
    const uint8_t* fs = fbuf + cur * CL;
    uint8_t* fd = fbuf + (1 - cur) * CL;
    for (int l = tid; l < CL; l += T) {
      const bool f = fs[l] != 0, use = !f && l >= sh;
      dst[l] = use ? ec_add_cold(src[l], src[l - sh]) : src[l];
      fd[l] = f || (use && fs[l - sh]) || l < sh;
    }
    __syncthreads();
    cur ^= 1;
  }
  const Jac* carry = cbuf + cur * CL;  // lane l's carry is carry[l - 1]
  for (int b = tid + 1; b <= nbk; b += T) {
    int lo = 0, hi = n;  // first slot with digit > b
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (dw[mid] <= b)
        lo = mid + 1;
      else
        hi = mid;
    }
    const int q = lo - 1;
    if (q >= 0 && dw[q] == b) continue;
    Fe X = zero(), Y = zero();
    if (q < 0)
      load_base(bases, order[w * n], X, Y);
    else if (dw[q] > 0) {
      X = load(sx, Wtot, nbk, w, dw[q] - 1);
      Y = load(sy, Wtot, nbk, w, dw[q] - 1);
    }
    store(sx, 16, nbk, w, 0, b - 1, X);
    store(sy, 16, nbk, w, 0, b - 1, Y);
    store(sz, 16, nbk, w, 0, b - 1, zero());
  }
  __syncthreads();
  for (int l = tid; l < CL; l += T) {
    const int p0 = l * R, b = dw[p0];
    if (l == 0 || b <= 0 || dw[p0 - 1] != b || (l < CL - 1 && dw[p0 + R] == b)) continue;
    const Jac S = ec_add_cold(load_jac(sx, sy, sz, Wtot, nbk, w, b - 1), carry[l - 1]);
    store(sx, 16, nbk, w, 0, b - 1, S.x);
    store(sy, 16, nbk, w, 0, b - 1, S.y);
    store(sz, 16, nbk, w, 0, b - 1, S.z);
  }
}

// Weighted bucket reduction T_w = sum_b b * S_{w,b} of one window per block,
// in the order of ops/ec_device.py's merged-lane loops (so bit-equal to
// them): slot b - 1 = r * CL2 + l; thread l walks its lane's R2 rows from the
// top with acc and tot in registers (acc += S, tot += acc); the block then
// runs the within-block inclusive suffix scans of acc and tot, and of the
// scanned acc again, in shared memory (Hillis-Steele; a lane past the end
// adds nothing); lane 0 forms D = TT + (-TA), doubles it log2(CL2) times and
// adds TS. sx, sy, sz: [Wtot, 16, nb]; out: [16, Wtot]. CL2 = blockDim.x, a
// power of two; dynamic shared memory 2 * CL2 points.
constexpr int WEIGHT_MAX_LANES = 256;

__global__ void __launch_bounds__(WEIGHT_MAX_LANES)
bucket_weight_k(const int32_t* __restrict__ sx, const int32_t* __restrict__ sy,
                const int32_t* __restrict__ sz, int32_t* __restrict__ ox,
                int32_t* __restrict__ oy, int32_t* __restrict__ oz, int64_t nb, int R2) {
  extern __shared__ Jac scan[];  // [2, CL2]: acc | tot
  const int CL2 = blockDim.x, l = threadIdx.x;
  const int64_t w = blockIdx.x, Wtot = gridDim.x;
  Jac acc = identity(), tot = identity();
  for (int r = R2 - 1; r >= 0; r--) {
    const int64_t s = (int64_t)r * CL2 + l;
    const Jac row = s < nb ? load_jac(sx, sy, sz, Wtot, nb, w, s) : identity();
    acc = ec_add_complete(acc, row);
    tot = ec_add_complete(tot, acc);
  }
  Jac* scanA = scan;
  Jac* scanT = scan + CL2;
  for (int sh = 1; sh < CL2; sh <<= 1) {
    scanA[l] = acc;
    scanT[l] = tot;
    __syncthreads();
    if (l + sh < CL2) {
      acc = ec_add_cold(acc, scanA[l + sh]);
      tot = ec_add_cold(tot, scanT[l + sh]);
    }
    __syncthreads();
  }
  Jac ts = acc;
  for (int sh = 1; sh < CL2; sh <<= 1) {
    scanA[l] = ts;
    __syncthreads();
    if (l + sh < CL2) ts = ec_add_cold(ts, scanA[l + sh]);
    __syncthreads();
  }
  if (l != 0) return;
  Jac neg_ta = acc;
  neg_ta.y = sub<FQ>(zero(), acc.y);
  Jac D = ec_add_cold(tot, neg_ta);
  for (int k = 1; k < CL2; k <<= 1) D = ec_double_jac(D);
  const Jac T = ec_add_cold(D, ts);
  store(ox, 16, Wtot, 0, 0, w, T.x);
  store(oy, 16, Wtot, 0, 0, w, T.y);
  store(oz, 16, Wtot, 0, 0, w, T.z);
}

// Window combine of a Pippenger MSM, one thread per column with res in
// registers: for w = W - 1 down to 0, c doublings, then res += T_w. tx, ty,
// tz: [16, C * W], lane = column * W + w; out: [16, C].
__global__ void __launch_bounds__(32)
msm_combine_k(const int32_t* __restrict__ tx, const int32_t* __restrict__ ty,
              const int32_t* __restrict__ tz, int32_t* __restrict__ ox,
              int32_t* __restrict__ oy, int32_t* __restrict__ oz, int64_t C, int W, int c) {
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= C) return;
  Jac res = identity();
  for (int w = W - 1; w >= 0; w--) {
    for (int k = 0; k < c; k++) res = ec_double_jac(res);
    res = ec_add_complete(res, load_jac(tx, ty, tz, 1, C * W, 0, col * W + w));
  }
  store(ox, 16, C, 0, 0, col, res.x);
  store(oy, 16, C, 0, 0, col, res.y);
  store(oz, 16, C, 0, 0, col, res.z);
}

// --- the small-column commit: double-and-add chains, then the lane tree ------
// The function of the per-bit composition it replaces (ec_double, then
// ec_madd with the doubling branch, selected by the bit, 254 times; then
// the halving tree of ec_add), with the same point ops in the same order, so
// the Jacobian sums are the same triples.
//
// The mixed add of ec_madd(P, x2, y2, false) with its cases taken by
// branches: (0, 0) returns P, an identity P returns (x2, y2, 1), P == (x2,
// y2) returns dbl-2009-l of (x2, y2, 1) (the doubling branch's formulas:
// its Z3 = 2 y2 * 1 is 2 y2), else the add path. The doubling runs only on
// the lanes that meet it.
template <class M>
__device__ __forceinline__ Jac ec_madd_branch(const Jac& P, const Fe& x2, const Fe& y2, M mm) {
  if (is_zero(x2) && is_zero(y2)) return P;
  if (is_zero(P.z)) {
    Jac o;
    o.x = x2;
    o.y = y2;
    o.z = one<FQ>();
    return o;
  }
  const Fe &X1 = P.x, &Y1 = P.y, &Z1 = P.z;
  const Fe Z1Z1 = mm(Z1, Z1);
  const Fe H = sub<FQ>(mm(x2, Z1Z1), X1);
  const Fe rr = dbl<FQ>(sub<FQ>(mm(mm(y2, Z1), Z1Z1), Y1));
  if (is_zero(H) && is_zero(rr)) {
    Jac A;
    A.x = x2;
    A.y = y2;
    A.z = one<FQ>();
    return ec_double_jac(A, mm);
  }
  const Fe HH = mm(H, H);
  const Fe I = dbl<FQ>(dbl<FQ>(HH));
  const Fe ZH = add<FQ>(Z1, H);
  const Fe J = mm(H, I), V = mm(X1, I);
  Jac out;
  out.x = sub<FQ>(sub<FQ>(mm(rr, rr), J), dbl<FQ>(V));
  out.z = sub<FQ>(sub<FQ>(mm(ZH, ZH), Z1Z1), HH);
  out.y = sub<FQ>(mm(rr, sub<FQ>(V, out.x)), dbl<FQ>(mm(Y1, J)));
  return out;
}

// Launch 1, the chains: one thread per (column, lane), the accumulator in
// registers from the identity. The thread reads its scalar's 254 bits (the
// canonical scalar's eight words, loaded once) from the top: doubling, then
// the mixed add where the bit is 1. Steps above the top set bit are skipped:
// there the accumulator is (0, 0, 0), which dbl-2009-l maps to itself, so
// the result is unchanged. Every product is a call of one out-of-line copy
// (MulCalled), so the step's code stays in the instruction cache. scal:
// [C, 16, m] canonical scalars; ax, ay: [16, ldb] affine bases, lane e of
// every column adding base e * bstep (bstep 0: every lane adds base 0, as
// g1_chain_bench runs it); sx, sy, sz: [C, 16, m] each lane's sum.
constexpr int COMMIT_THREADS = 64;

__global__ void __launch_bounds__(COMMIT_THREADS)
commit_chain_k(const int32_t* __restrict__ scal, const int32_t* __restrict__ ax,
               const int32_t* __restrict__ ay, int64_t ldb, int64_t bstep,
               int32_t* __restrict__ sx, int32_t* __restrict__ sy, int32_t* __restrict__ sz,
               int64_t C, int64_t m) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C * m) return;
  const int64_t col = i / m, e = i % m;
  Fe s = load(scal, C, m, col, e);
  s.w[7] &= (1u << 30) - 1;  // bits 0..253: the 254 one-bit windows
  int top = -1;
#pragma unroll
  for (int k = 0; k < 8; k++)
    if (s.w[k]) top = 32 * k + 31 - __clz(s.w[k]);
  Jac acc = identity();
  if (top >= 0) {
    const Fe x2 = load(ax, 1, ldb, 0, e * bstep), y2 = load(ay, 1, ldb, 0, e * bstep);
    for (int b = top; b >= 0; b--) {
      uint32_t word = 0;
#pragma unroll
      for (int k = 0; k < 8; k++)
        if ((b >> 5) == k) word = s.w[k];
      acc = ec_double_jac(acc, MulCalled());
      if ((word >> (b & 31)) & 1u) acc = ec_madd_branch(acc, x2, y2, MulCalled());
    }
  }
  store(sx, 16, m, col, 0, e, acc.x);
  store(sy, 16, m, col, 0, e, acc.y);
  store(sz, 16, m, col, 0, e, acc.z);
}

// Launch 2, the tree: one block per column, its m lane sums in shared
// memory. The halving tree of DeviceCurve.tree_reduce, level by level:
// point i of a level is the sum of points 2i and 2i + 1 of the level below,
// an odd last point carried unchanged. Point i of level d sits at slot i 2^d,
// so each add writes the slot of its left operand, which no other pair
// reads. The adds call the out-of-line product, as the chains do. out:
// [16, C].
constexpr int TREE_THREADS = 128;

__global__ void __launch_bounds__(TREE_THREADS)
commit_tree_k(const int32_t* __restrict__ sx, const int32_t* __restrict__ sy,
              const int32_t* __restrict__ sz, int32_t* __restrict__ ox,
              int32_t* __restrict__ oy, int32_t* __restrict__ oz, int m) {
  extern __shared__ Jac pts[];  // [m]
  const int64_t col = blockIdx.x, C = gridDim.x;
  const int tid = threadIdx.x, T = blockDim.x;
  for (int l = tid; l < m; l += T) pts[l] = load_jac(sx, sy, sz, C, m, col, l);
  __syncthreads();
  for (int n = m, s = 1; n > 1; s <<= 1) {
    const int half = n >> 1;
    for (int i = tid; i < half; i += T)
      pts[2 * i * s] = ec_add_complete(pts[2 * i * s], pts[(2 * i + 1) * s], MulCalled());
    __syncthreads();
    n = half + (n & 1);
  }
  if (tid != 0) return;
  store(ox, 16, C, 0, 0, col, pts[0].x);
  store(oy, 16, C, 0, 0, col, pts[0].y);
  store(oz, 16, C, 0, 0, col, pts[0].z);
}

extern "C" int h2_ec_add(const int32_t* x1, const int32_t* y1, const int32_t* z1,
                         const int32_t* x2, const int32_t* y2, const int32_t* z2, int32_t* ox,
                         int32_t* oy, int32_t* oz, int64_t L, int64_t B, void* stream) {
  const int64_t n = L * B;
  if (n > 0)
    ec_add_k<<<(unsigned)((n + EC_ADD_THREADS - 1) / EC_ADD_THREADS), EC_ADD_THREADS, 0,
               (cudaStream_t)stream>>>(x1, y1, z1, x2, y2, z2, ox, oy, oz, L, B);
  return (int)cudaGetLastError();
}

extern "C" int h2_ec_double(const int32_t* x1, const int32_t* y1, const int32_t* z1,
                            int32_t* ox, int32_t* oy, int32_t* oz, int64_t L, int64_t B,
                            void* stream) {
  const int64_t n = L * B;
  if (n > 0)
    ec_double_k<<<H2_BLOCKS(n), H2_THREADS, 0, (cudaStream_t)stream>>>(x1, y1, z1, ox, oy, oz,
                                                                       L, B);
  return (int)cudaGetLastError();
}

extern "C" int h2_ec_madd(const int32_t* x1, const int32_t* y1, const int32_t* z1,
                          const int32_t* x2, const int32_t* y2, int64_t La, int64_t Ba, int32_t* ox,
                          int32_t* oy, int32_t* oz, int64_t L, int64_t B, int distinct,
                          void* stream) {
  const int64_t n = L * B;
  if (n > 0) {
    if (distinct)
      ec_madd_k<true><<<H2_BLOCKS(n), H2_THREADS, 0, (cudaStream_t)stream>>>(
          x1, y1, z1, x2, y2, La, Ba, ox, oy, oz, L, B);
    else
      ec_madd_k<false><<<H2_BLOCKS(n), H2_THREADS, 0, (cudaStream_t)stream>>>(
          x1, y1, z1, x2, y2, La, Ba, ox, oy, oz, L, B);
  }
  return (int)cudaGetLastError();
}

extern "C" int h2_bucket_scan(const int32_t* axy, const int32_t* start, int32_t* out, int64_t Wb,
                              int64_t R, int64_t CL, int distinct, void* stream) {
  const int64_t n = Wb * CL;
  if (n > 0)
    bucket_scan_k<<<H2_BLOCKS(n), H2_THREADS, 0, (cudaStream_t)stream>>>(axy, start, out, Wb, R,
                                                                         CL, distinct);
  return (int)cudaGetLastError();
}

extern "C" int h2_bucket_weight(const int32_t* sx, const int32_t* sy, const int32_t* sz,
                                int32_t* ox, int32_t* oy, int32_t* oz, int64_t Wtot, int64_t nb,
                                int CL2, void* stream) {
  if (CL2 < 1 || CL2 > WEIGHT_MAX_LANES || (CL2 & (CL2 - 1))) return (int)cudaErrorInvalidValue;
  if (Wtot > 0) {
    const int R2 = (int)((nb + CL2 - 1) / CL2);
    bucket_weight_k<<<(unsigned)Wtot, CL2, 2 * CL2 * sizeof(Jac), (cudaStream_t)stream>>>(
        sx, sy, sz, ox, oy, oz, nb, R2);
  }
  return (int)cudaGetLastError();
}

extern "C" int h2_msm_combine(const int32_t* tx, const int32_t* ty, const int32_t* tz,
                              int32_t* ox, int32_t* oy, int32_t* oz, int64_t C, int W, int c,
                              void* stream) {
  if (C > 0)
    msm_combine_k<<<(unsigned)((C + 31) / 32), 32, 0, (cudaStream_t)stream>>>(tx, ty, tz, ox, oy,
                                                                             oz, C, W, c);
  return (int)cudaGetLastError();
}

// Largest CL: two [CL] point buffers and flags in one block's shared memory.
constexpr int BUCKET_MAX_LANES = 1024;

extern "C" int h2_bucket_sums(const int32_t* bases, const int32_t* order, const int32_t* digits,
                              int32_t* sx, int32_t* sy, int32_t* sz, int32_t* tail, int64_t Wtot,
                              int64_t n, int64_t CL, int64_t nbk, int distinct, void* stream) {
  if (CL < 1 || CL > BUCKET_MAX_LANES || n % CL || n > INT32_MAX || nbk > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (Wtot == 0 || n == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int4* b4 = reinterpret_cast<const int4*>(bases);
  const int64_t chains = Wtot * CL;
  const unsigned blocks = (unsigned)((chains + CHAIN_THREADS - 1) / CHAIN_THREADS);
  if (distinct)
    bucket_chain_k<true><<<blocks, CHAIN_THREADS, 0, s>>>(b4, order, digits, sx, sy, sz, tail,
                                                         Wtot, (int)n, (int)CL, (int)nbk);
  else
    bucket_chain_k<false><<<blocks, CHAIN_THREADS, 0, s>>>(b4, order, digits, sx, sy, sz, tail,
                                                          Wtot, (int)n, (int)CL, (int)nbk);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const size_t smem = 2 * CL * (sizeof(Jac) + 1);
  rc = (int)cudaFuncSetAttribute(bucket_carry_k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
  if (rc) return rc;
  const int threads = CL < CARRY_THREADS ? (int)CL : CARRY_THREADS;
  bucket_carry_k<<<(unsigned)Wtot, threads, smem, s>>>(b4, order, digits, sx, sy, sz, tail,
                                                       (int)n, (int)CL, (int)nbk);
  return (int)cudaGetLastError();
}

// Largest m: a column's m lane sums in one block's shared memory.
constexpr int COMMIT_MAX_LANES = 2048;

// scal: [C, 16, m] canonical scalars; ax, ay: [16, ldb] affine bases (ldb >=
// m); scratch: [3, C, 16, m]; ox, oy, oz: [16, C].
extern "C" int h2_commit_dbl_add(const int32_t* scal, const int32_t* ax, const int32_t* ay,
                                 int64_t ldb, int32_t* scratch, int32_t* ox, int32_t* oy,
                                 int32_t* oz, int64_t C, int64_t m, void* stream) {
  if (m < 1 || m > COMMIT_MAX_LANES || ldb < m) return (int)cudaErrorInvalidValue;
  if (C == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  int32_t *sx = scratch, *sy = scratch + C * 16 * m, *sz = scratch + 2 * C * 16 * m;
  const int64_t n = C * m;
  commit_chain_k<<<(unsigned)((n + COMMIT_THREADS - 1) / COMMIT_THREADS), COMMIT_THREADS, 0, s>>>(
      scal, ax, ay, ldb, 1, sx, sy, sz, C, m);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const size_t smem = (size_t)m * sizeof(Jac);
  rc = (int)cudaFuncSetAttribute(commit_tree_k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
  if (rc) return rc;
  commit_tree_k<<<(unsigned)C, TREE_THREADS, smem, s>>>(sx, sy, sz, ox, oy, oz, (int)m);
  return (int)cudaGetLastError();
}

// The double-and-add g1_batch_mul launched before the comb: commit_dbl_add's
// chain launch alone (one column, no tree), every lane adding the one base
// (a base stride of 0). Not on any path: chip_smoke.py times it beside the
// comb. scal [16, n] canonical; gx, gy [16, 1]; ox, oy, oz [16, n].
extern "C" int h2_g1_chain_bench(const int32_t* scal, const int32_t* gx, const int32_t* gy,
                                 int32_t* ox, int32_t* oy, int32_t* oz, int64_t n,
                                 void* stream) {
  if (n > 0)
    commit_chain_k<<<(unsigned)((n + COMMIT_THREADS - 1) / COMMIT_THREADS), COMMIT_THREADS, 0,
                     (cudaStream_t)stream>>>(scal, gx, gy, 1, 0, ox, oy, oz, 1, n);
  return (int)cudaGetLastError();
}

// --- g1_batch_mul: s_i G for every lane by a fixed-base comb -----------------
// The SRS setup multiplies one base, G, by 2n scalars. A per-lane
// double-and-add (commit_chain_k, which this launch ran until the comb) spends
// 254 doublings and a mixed add per set bit on every lane, about 3,175
// products, and a warp waits at each bit where any lane adds. The base is
// fixed, so its multiples are a table: T[j][d - 1] = d 2^(7j) G in Montgomery
// affine form, window j < COMB_WINDOWS, 1 <= d <= COMB_HALF (37 x 64 points,
// 151,552 bytes, staged once a block in shared memory). A lane recodes its
// canonical scalar into signed 7-bit digits d_j in (-64, 64] (low window
// first: d = window bits + carry, and d - 128 with a carry of one where d >
// 64; the top window, bits 252-253 and the carry, stays at most 4) and sums
// acc = sum_j sign(d_j) T[j][|d_j| - 1] with one mixed add per nonzero digit,
// no doubling: at most 37 mixed adds (11 products each, the first one free),
// about 400 products a lane, and every lane of a warp adds in every window
// but where its digit is 0 (one in 128). A negative digit takes the entry
// with y -> q - y (free in affine form).
//
// The mixed add keeps ec_madd_branch's cases. The accumulator before window j
// is P = (sum_{i<j} d_i 2^(7i)) G with |sum| <= 64 (2^(7j) - 1) / 127, and the
// entry is +-|d_j| 2^(7j) G. Below the top window (j <= 35) sum -+ d_j 2^(7j)
// is nonzero and below 2^252 < r in size, so P is never the entry or its
// negative. In the top window (2^252, digit at most 4) it can be: P == T
// exactly when sum = 3 * 2^252 - r, that is for the one scalar s = 6 * 2^252 -
// r (below r; its last digits are -3, 3), and ec_madd_branch then takes
// dbl-2009-l of the entry. An opposite entry (Z = 0) would need s = 0 mod r,
// whose digits are all 0. The tests hold that scalar among their edge cases.
//
// Bound on the H100: integer multiply issue (about 400 products of 272
// 32-bit operations a lane; the table and the 64 bytes of scalar and 192 of
// Jacobian sum a lane are a few percent of it). Design: one block of
// COMB_THREADS an SM, persistent over the lanes, so the table is staged once
// an SM; one thread a lane, the accumulator in registers, the scalar shifted
// down seven bits a window (funnel shifts: the digit read from word 0, no
// indexed registers); the products called out of line (MulCalled: 12.7-13.0
// ms at [16, 2^20] against 14.8-15.5 ms inlined, PERF.md; dft_probe.py
// --variants builds the inlined copy with -DG1_COMB_MUL=MulInline). Scal:
// [16, n] canonical scalars; table:
// [COMB_WINDOWS * COMB_HALF, 16] words, point-major (x words 0-7, y 8-15);
// ox, oy, oz: [16, n] each lane's Jacobian sum.
constexpr int COMB_W = 7;
constexpr int COMB_HALF = 1 << (COMB_W - 1);
constexpr int COMB_WINDOWS = (254 + COMB_W - 1) / COMB_W;
constexpr int COMB_THREADS = 384;
#ifndef G1_COMB_MUL
#define G1_COMB_MUL MulCalled
#endif
static_assert(254 - COMB_W * (COMB_WINDOWS - 1) <= COMB_W - 1,
              "the top window must absorb the last carry");

__device__ __forceinline__ void load_entry(const int4* e, Fe& x, Fe& y) {
  const int4 q0 = e[0], q1 = e[1], q2 = e[2], q3 = e[3];
  x.w[0] = q0.x, x.w[1] = q0.y, x.w[2] = q0.z, x.w[3] = q0.w;
  x.w[4] = q1.x, x.w[5] = q1.y, x.w[6] = q1.z, x.w[7] = q1.w;
  y.w[0] = q2.x, y.w[1] = q2.y, y.w[2] = q2.z, y.w[3] = q2.w;
  y.w[4] = q3.x, y.w[5] = q3.y, y.w[6] = q3.z, y.w[7] = q3.w;
}

__global__ void __launch_bounds__(COMB_THREADS, 1)
g1_fixed_mul_k(const int32_t* __restrict__ scal, const int4* __restrict__ table,
               int32_t* __restrict__ ox, int32_t* __restrict__ oy, int32_t* __restrict__ oz,
               int64_t n) {
  extern __shared__ int4 tab[];  // [COMB_WINDOWS * COMB_HALF * 4]
  for (int i = threadIdx.x; i < COMB_WINDOWS * COMB_HALF * 4; i += blockDim.x)
    tab[i] = __ldg(table + i);
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n; e += stride) {
    Fe s = load(scal, 1, n, 0, e);
    Jac acc = identity();
    uint32_t carry = 0;
    for (int j = 0; j < COMB_WINDOWS; j++) {
      const uint32_t d = (s.w[0] & ((1u << COMB_W) - 1)) + carry;
#pragma unroll
      for (int k = 0; k < 7; k++) s.w[k] = __funnelshift_r(s.w[k], s.w[k + 1], COMB_W);
      s.w[7] >>= COMB_W;
      carry = d > COMB_HALF;
      const uint32_t mag = carry ? (1u << COMB_W) - d : d;
      if (mag) {
        Fe x2, y2;
        load_entry(tab + (j * COMB_HALF + mag - 1) * 4, x2, y2);
        if (carry) y2 = sub<FQ>(zero(), y2);
        acc = ec_madd_branch(acc, x2, y2, G1_COMB_MUL());
      }
    }
    store(ox, 16, n, 0, 0, e, acc.x);
    store(oy, 16, n, 0, 0, e, acc.y);
    store(oz, 16, n, 0, 0, e, acc.z);
  }
}

// scal: [16, n] canonical scalars; table: [COMB_WINDOWS * COMB_HALF, 16]
// words of the base's comb table; ox, oy, oz: [16, n].
extern "C" int h2_g1_batch_mul(const int32_t* scal, const int32_t* table, int32_t* ox,
                               int32_t* oy, int32_t* oz, int64_t n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc) return rc;
  rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc) return rc;
  const size_t smem = (size_t)COMB_WINDOWS * COMB_HALF * 64;
  // the shared-memory limit, set once a device (a host call a launch saves)
  static std::atomic<bool> attr_set[64];
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    rc = (int)cudaFuncSetAttribute(g1_fixed_mul_k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
    if (rc) return rc;
    attr_set[dev] = true;
  }
  const int64_t need = (n + COMB_THREADS - 1) / COMB_THREADS;
  const unsigned blocks = (unsigned)(need < sms ? need : sms);
  g1_fixed_mul_k<<<blocks, COMB_THREADS, smem, (cudaStream_t)stream>>>(
      scal, reinterpret_cast<const int4*>(table), ox, oy, oz, n);
  return (int)cudaGetLastError();
}
