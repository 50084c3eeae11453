// Family D: bn254 G1 point arithmetic in Jacobian coordinates over Fq, on
// limb-major int32[L, 16, B] coordinate tensors (identity: Z == 0).
//
// Replaces, in halo2_lib_tpu/ops/pallas_field.py:
//   _ec_add_kernel (via ec_add): complete add, add-2007-bl plus the doubling
//     branch and the identity and inverse cases;
//   _ec_double_kernel (via ec_double): dbl-2009-l with a = 0;
//   _ec_madd_kernel (via ec_madd; its body is _madd_core): the standalone
//     mixed add, Jacobian + affine (madd-2007-bl, (0, 0) = affine identity),
//     which the small-column commit path (m <= 1024) runs once per scalar bit;
//   _bucket_scan_kernel (via bucket_scan): the MSM bucket accumulation, an
//     inclusive segmented scan of mixed adds (madd-2007-bl, the arithmetic of
//     _madd_core) over bucket-sorted affine bases.
//
// Bound on the H100: integer multiply issue. A complete add is 23 Montgomery
// products, a double 7, a mixed add 11 (17 with the doubling branch), against
// at most 288 bytes of coordinates per point.
//
// Design: one thread per point, every coordinate in registers; the formulas
// and case selects are those of ops/ec_device.py, so each kernel agrees bit
// for bit with its plain version. ec_madd reads the affine operand with its
// own row and lane strides, so one [16, m] set of bases serves every column
// of a [C, 16, m] accumulator without being copied C times; the `distinct`
// flag is a template parameter, so the doubling branch (6 of its 17
// products) is compiled out when the caller drops it. bucket_scan gives one
// thread to each (window, lane) chain, which walks the chain's R steps in
// order with its accumulator in registers: that loop replaces the TPU
// kernel's sequential grid axis and its VMEM accumulators. Left for later:
// warp-cooperative bucket runs, fewer threads idle at small Wb * CL, and
// keeping the scan's intermediate points out of device memory (only bucket
// ends are read).
#include "fp256.cuh"

using namespace h2;

constexpr int FQ = 1;

struct Jac {
  Fe x, y, z;
};

__device__ __forceinline__ Jac ec_add_complete(const Jac& P, const Jac& Q) {
  const Fe &X1 = P.x, &Y1 = P.y, &Z1 = P.z, &X2 = Q.x, &Y2 = Q.y, &Z2 = Q.z;
  const Fe Z1Z1 = mul<FQ>(Z1, Z1), Z2Z2 = mul<FQ>(Z2, Z2);
  const Fe A = mul<FQ>(X1, X1), B = mul<FQ>(Y1, Y1);
  const Fe U1 = mul<FQ>(X1, Z2Z2), U2 = mul<FQ>(X2, Z1Z1);
  const Fe t1 = mul<FQ>(Y1, Z2), t2 = mul<FQ>(Y2, Z1);
  const Fe C = mul<FQ>(B, B), YZ = mul<FQ>(Y1, Z1);
  const Fe tXB = add<FQ>(X1, B);
  const Fe S1 = mul<FQ>(t1, Z2Z2), S2 = mul<FQ>(t2, Z1Z1), tXB2 = mul<FQ>(tXB, tXB);
  const Fe H = sub<FQ>(U2, U1);
  const Fe r_ = sub<FQ>(S2, S1);
  const Fe rr = dbl<FQ>(r_);
  const Fe E = add<FQ>(dbl<FQ>(A), A);
  const Fe D = dbl<FQ>(sub<FQ>(sub<FQ>(tXB2, A), C));
  const Fe zz = add<FQ>(Z1, Z2);
  const Fe HH = mul<FQ>(H, H), F_ = mul<FQ>(E, E), rr2 = mul<FQ>(rr, rr), zz2 = mul<FQ>(zz, zz);
  const Fe I = dbl<FQ>(dbl<FQ>(HH));
  const Fe X3d = sub<FQ>(F_, dbl<FQ>(D));
  const Fe zzsub = sub<FQ>(sub<FQ>(zz2, Z1Z1), Z2Z2);
  const Fe J = mul<FQ>(H, I), V = mul<FQ>(U1, I);
  Fe Z3 = mul<FQ>(zzsub, H);
  const Fe Ed = mul<FQ>(E, sub<FQ>(D, X3d));
  Fe X3 = sub<FQ>(sub<FQ>(rr2, J), dbl<FQ>(V));
  const Fe S1J = mul<FQ>(S1, J);
  Fe Y3 = sub<FQ>(mul<FQ>(rr, sub<FQ>(V, X3)), dbl<FQ>(S1J));
  const Fe C4 = dbl<FQ>(dbl<FQ>(C));
  const Fe Y3d = sub<FQ>(Ed, dbl<FQ>(C4));
  const Fe Z3d = dbl<FQ>(YZ);

  const bool p1_inf = is_zero(Z1), p2_inf = is_zero(Z2);
  const bool h_zero = is_zero(H), r_zero = is_zero(r_);
  const bool is_double = h_zero && r_zero && !p1_inf && !p2_inf;
  const bool is_ident = h_zero && !r_zero && !p1_inf && !p2_inf;
  X3 = sel(is_double, X3d, X3);
  Y3 = sel(is_double, Y3d, Y3);
  Z3 = sel(is_double, Z3d, Z3);
  Z3 = sel(is_ident, zero(), Z3);
  Jac out;
  out.x = sel(p2_inf, X1, sel(p1_inf, X2, X3));
  out.y = sel(p2_inf, Y1, sel(p1_inf, Y2, Y3));
  out.z = sel(p2_inf, Z1, sel(p1_inf, Z2, Z3));
  return out;
}

__device__ __forceinline__ Jac ec_double_jac(const Jac& P) {
  const Fe A = mul<FQ>(P.x, P.x), B = mul<FQ>(P.y, P.y);
  const Fe E = add<FQ>(dbl<FQ>(A), A);
  const Fe tXB = add<FQ>(P.x, B);
  const Fe C = mul<FQ>(B, B), tXB2 = mul<FQ>(tXB, tXB), F_ = mul<FQ>(E, E);
  const Fe D = dbl<FQ>(sub<FQ>(sub<FQ>(tXB2, A), C));
  Jac out;
  out.x = sub<FQ>(F_, dbl<FQ>(D));
  const Fe C4 = dbl<FQ>(dbl<FQ>(C));
  out.y = sub<FQ>(mul<FQ>(E, sub<FQ>(D, out.x)), dbl<FQ>(C4));
  out.z = dbl<FQ>(mul<FQ>(P.y, P.z));
  return out;
}

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

__global__ void ec_add_k(const int32_t* __restrict__ x1, const int32_t* __restrict__ y1,
                         const int32_t* __restrict__ z1, const int32_t* __restrict__ x2,
                         const int32_t* __restrict__ y2, const int32_t* __restrict__ z2,
                         int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                         int32_t* __restrict__ oz, int64_t L, int64_t B) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L * B) return;
  const int64_t r = i / B, e = i % B;
  Jac P, Q;
  P.x = load(x1, L, B, r, e);
  P.y = load(y1, L, B, r, e);
  P.z = load(z1, L, B, r, e);
  Q.x = load(x2, L, B, r, e);
  Q.y = load(y2, L, B, r, e);
  Q.z = load(z2, L, B, r, e);
  const Jac R = ec_add_complete(P, Q);
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

extern "C" int h2_ec_add(const int32_t* x1, const int32_t* y1, const int32_t* z1,
                         const int32_t* x2, const int32_t* y2, const int32_t* z2, int32_t* ox,
                         int32_t* oy, int32_t* oz, int64_t L, int64_t B, void* stream) {
  const int64_t n = L * B;
  if (n > 0)
    ec_add_k<<<H2_BLOCKS(n), H2_THREADS, 0, (cudaStream_t)stream>>>(x1, y1, z1, x2, y2, z2, ox,
                                                                    oy, oz, L, B);
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
