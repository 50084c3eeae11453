"""KZG structured reference string (ParamsKZG) and polynomial commitments.

The port of ``halo2_lib_tpu/backend/kzg.py``. Like halo2, both bases are
kept: ``g`` (monomial, tau^i G) and ``g_lagrange`` (L_i(tau) G); columns in
Lagrange form commit against ``g_lagrange`` without an inverse NTT.

``setup`` generates the powers-of-tau SRS with the reference's tau (or a
seeded test tau): the host computes the scalars tau^i and L_i(tau) as exact
ints, and one ``g1_batch_mul`` launch on the card multiplies G by all 2n of
them (the JAX package's ``_batch_g1_mul`` scan), whose Jacobian sums become
affine on the card (one batch inversion). Files are read and written in
halo2-axiom's ``ParamsKZG::<Bn256>`` serialization (RawBytes, the format of
every committed ``params/kzg_bn254_{k}.srs``, and Processed, compressed
points); ``read`` also takes the repo's legacy ``H2TPUSR3`` container.
``gen_srs`` reads a file or creates it.

An SRS keeps its bases in one form, whatever made it: the Montgomery limbs
of RawBytes (R = 2^256, sixteen 16-bit limbs a coordinate, which is the
device layout too), so writing and packing them for the card never goes
through host ints. Processed and legacy reads convert their points to it
once; the host point lists ``g`` and ``g_lagrange`` are decoded on first
use.

Commitments on the card take the JAX package's two paths by column length
m: up to ``COMMIT_SIMPLE_MAX`` points an MSB-first double-and-add over the
254 scalar bits with the ``commit_dbl_add`` kernel (``commit_double_and_add``,
the small branch of the JAX ``_commit_chunk_jit``; every commit at k <= 10),
above it a Pippenger MSM (ops/ec_device.py, ``distinct=True`` as SRS bases
allow). Either way one call commits all the columns a transcript phase
writes. The JAX package's standalone commitments (``commit``,
``commit_lagrange``, ``commit_dev``, ``commit_many``,
``commit_many_inside``) are Pippenger MSMs on the cached device bases.
"""

from __future__ import annotations

import os
import random
import time

import numpy as np
import torch

from ..ops import cuda_field as cf
from ..ops.ec_device import DeviceCurve, msm_device, msm_many_device, msm_window_bits
from ..ops.limbs import N_LIMBS, DeviceField, ints_to_limbs, ints_to_limbs_T, limbs_to_ints, to_device
from ..utils.curves import BN254_G1, BN254_G2, BN254_G2_B, FQ2_BN254
from ..utils.device import resolve_device, stage_end
from ..utils.fields import FQ_BN254, FR_BN254


# Columns of at most this many points commit by double-and-add on the card:
# HALO2_COMMIT_SIMPLE_MAX, read at import with the JAX package's default,
# up to the longest column commit_dbl_add's lane tree holds.
COMMIT_SIMPLE_MAX = int(os.environ.get("HALO2_COMMIT_SIMPLE_MAX", "1024"))
if COMMIT_SIMPLE_MAX > cf.COMMIT_MAX_LANES:
    raise ValueError(f"HALO2_COMMIT_SIMPLE_MAX={COMMIT_SIMPLE_MAX}: commit_dbl_add takes columns "
                     f"of at most {cf.COMMIT_MAX_LANES} points")

_SRS_MAGIC_V1 = b"H2TPUSRS"
_SRS_MAGIC_V2 = b"H2TPUSR2"  # v2: adds the Lagrange basis
_SRS_MAGIC = b"H2TPUSR3"  # v3: tau drawn from ChaCha20Rng(seed 0), like the reference


def _params_dir() -> str:
    return os.environ.get("PARAMS_DIR", os.path.join(os.getcwd(), "params"))


# --- halo2curves point encodings (Processed format) -------------------------
# Compressed G1: 32 bytes canonical x LE, y-parity in bit 255; identity =
# all-zero. Compressed G2: 64 bytes x.c0 || x.c1 LE, y.c0-parity in bit 511.
# (halo2curves-axiom new_curve_impl to_bytes/from_bytes.)


def _g1_compress(pt) -> bytes:
    if pt is None:
        return b"\x00" * 32
    raw = bytearray(pt[0].to_bytes(32, "little"))
    if pt[1] & 1:
        raw[31] |= 0x80
    return bytes(raw)


def _g1_decompress(raw: bytes):
    if raw == b"\x00" * 32:
        return None
    q = FQ_BN254.p
    sign = (raw[31] >> 7) & 1
    x = int.from_bytes(raw[:31] + bytes([raw[31] & 0x7F]), "little")
    if x >= q:
        raise ValueError("SRS: non-canonical G1 x")
    rhs = (x * x * x + BN254_G1.b) % q
    y = pow(rhs, (q + 1) // 4, q)
    if y * y % q != rhs:
        raise ValueError("SRS: G1 point not on curve")
    if (y & 1) != sign:
        y = q - y
    return (x, y)


def _g2_compress(pt) -> bytes:
    if pt is None:
        return b"\x00" * 64
    (x, y) = pt
    raw = bytearray(x[0].to_bytes(32, "little") + x[1].to_bytes(32, "little"))
    if y[0] & 1:
        raw[63] |= 0x80
    return bytes(raw)


def _fq2_sqrt(a):
    """sqrt in Fq[u]/(u^2+1), q = 3 mod 4 (complex method); None if non-residue."""
    F = FQ_BN254
    q = F.p
    a0, a1 = a
    if a1 == 0:
        r = F.sqrt(a0)
        if r is not None:
            return (r, 0)
        r = F.sqrt((-a0) % q)  # a0 = -r^2 -> sqrt = r * u
        return None if r is None else (0, r)
    alpha = (a0 * a0 + a1 * a1) % q  # norm (u^2 = -1)
    delta = F.sqrt(alpha)
    if delta is None:
        return None
    inv2 = pow(2, -1, q)
    x0sq = (a0 + delta) * inv2 % q
    x0 = F.sqrt(x0sq)
    if x0 is None:
        x0sq = (a0 - delta) * inv2 % q
        x0 = F.sqrt(x0sq)
        if x0 is None:
            return None
    x1 = a1 * pow(2 * x0 % q, -1, q) % q
    return (x0, x1)


def _g2_decompress(raw: bytes):
    if raw == b"\x00" * 64:
        return None
    q = FQ_BN254.p
    sign = (raw[63] >> 7) & 1
    x0 = int.from_bytes(raw[:32], "little")
    x1 = int.from_bytes(raw[32:63] + bytes([raw[63] & 0x7F]), "little")
    if x0 >= q or x1 >= q:
        raise ValueError("SRS: non-canonical G2 x")
    f = FQ2_BN254
    x = (x0, x1)
    rhs = f.add(f.mul(f.square(x), x), BN254_G2_B)
    y = _fq2_sqrt(rhs)
    if y is None:
        raise ValueError("SRS: G2 point not on curve")
    if (y[0] & 1) != sign:
        y = f.neg(y)
    return (x, y)


def _raw_from_points(bases: list) -> np.ndarray:
    """Two lists of n host affine points (None = identity) -> the RawBytes
    layout uint16[2, n, 2, 16]: Montgomery limbs (c * 2^256 mod q), the
    identity as (0, 0)."""
    q = FQ_BN254.p
    coords = [(c << 256) % q for basis in bases for pt in basis for c in (pt or (0, 0))]
    return ints_to_limbs(coords).astype("<u2").reshape(2, -1, 2, N_LIMBS)


def _check_canonical(xy: np.ndarray) -> None:
    """Raise unless every 16-limb coordinate of `xy` (uint16[..., 16]) is
    below q, as a RawBytes reader that reduces them would otherwise hand the
    card other points than the host decodes."""
    w = np.ascontiguousarray(xy).view("<u8")  # [..., 4] 64-bit words, low first
    q = FQ_BN254.p
    below = np.zeros(w.shape[:-1], dtype=bool)
    equal = np.ones(w.shape[:-1], dtype=bool)
    for i in range(3, -1, -1):
        qw = np.uint64((q >> (64 * i)) & ((1 << 64) - 1))
        below |= equal & (w[..., i] < qw)
        equal &= w[..., i] == qw
    if not below.all():
        raise ValueError("SRS: G1 coordinate not below q")


def _batch_inv_host(vals: list[int], p: int) -> list[int]:
    """Montgomery-trick batch inversion with exact host ints."""
    n = len(vals)
    pref = [1] * (n + 1)
    for i, v in enumerate(vals):
        pref[i + 1] = pref[i] * v % p
    inv_all = pow(pref[n], -1, p)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = pref[i] * inv_all % p
        inv_all = inv_all * vals[i] % p
    return out


def _lagrange_scalars(tau: int, k: int) -> list[int]:
    """L_i(tau) = omega^i (tau^n - 1) / (n (tau - omega^i)) for i < n."""
    p = FR_BN254.p
    n = 1 << k
    w = FR_BN254.nth_root_of_unity(k)
    wi = [1] * n
    for i in range(1, n):
        wi[i] = wi[i - 1] * w % p
    zh = (pow(tau, n, p) - 1) % p
    n_inv = pow(n, -1, p)
    denoms = [(tau - x) % p for x in wi]
    invs = _batch_inv_host(denoms, p)
    scale = zh * n_inv % p
    return [wi[i] * scale % p * invs[i] % p for i in range(n)]


def _tau_powers(tau: int, n: int) -> list[int]:
    p = FR_BN254.p
    taus = [1] * n
    for i in range(1, n):
        taus[i] = taus[i - 1] * tau % p
    return taus


def _batch_g1_mul(scalars: list[int], device, timings: dict | None = None):
    """[s * G1 for s in scalars] as Montgomery affine limbs (Ax, Ay), each
    int32[16, len] on `device`; (0, 0) where s = 0. The scalars go to the
    card as canonical 16-bit limbs (bytes, then numpy: no per-bit host
    loop), G's comb table is built (once per process and device), one
    g1_batch_mul launch sums every lane's digits' table entries, and one batch
    inversion of the Z's makes the sums affine."""
    t0 = time.time()
    dc = DeviceCurve(DeviceField(BN254_G1.base), BN254_G1)
    canon = to_device(ints_to_limbs_T([int(s) % FR_BN254.p for s in scalars]), device)
    Gx, Gy = dc.pack_points_affine([BN254_G1.g], device)
    t0 = stage_end("scalars to the card", t0, device, timings)
    cf.g1_comb_table(Gx, Gy)
    t0 = stage_end("comb table", t0, device, timings)
    X, Y, Z = cf.g1_batch_mul(canon, Gx, Gy)
    t0 = stage_end("g1_batch_mul", t0, device, timings)
    out = _affine_mont(dc.df, X, Y, Z)
    stage_end("affine", t0, device, timings)
    return out


class ParamsKZG:
    """Powers-of-tau SRS: g[i] = tau^i G1, g_lagrange[i] = L_i(tau) G1,
    g2, s_g2 = tau G2. The bases are `raw_xy`, uint16[2, n, 2, 16]: (g,
    g_lagrange) x point x (x, y) x Montgomery limb, the RawBytes bytes of the
    two bases; host points are decoded from them on first use, packed device
    bases live on `device`."""

    def __init__(self, k: int, raw_xy: np.ndarray, g2, s_g2, device=None):
        self.k = k
        self.n = 1 << k
        self._raw_xy = raw_xy
        self._g = None
        self._g_lagrange = None
        self.g2 = g2
        self.s_g2 = s_g2
        self.device = device
        self._dc: DeviceCurve | None = None
        self._bases: dict = {}

    @property
    def g(self) -> list:
        if self._g is None:
            self._g = self._host_points(0)
        return self._g

    @property
    def g_lagrange(self) -> list:
        if self._g_lagrange is None:
            self._g_lagrange = self._host_points(1)
        return self._g_lagrange

    def _host_points(self, basis: int) -> list:
        q = FQ_BN254.p
        rinv = pow(1 << 256, -1, q)
        c = [v * rinv % q for v in limbs_to_ints(self._raw_xy[basis].reshape(-1, N_LIMBS))]
        return [None if pt == (0, 0) else pt for pt in zip(c[0::2], c[1::2])]

    # --- setup ------------------------------------------------------------------------
    @staticmethod
    def setup(k: int, seed: int | None = None, device=None, timings: dict | None = None) -> "ParamsKZG":
        """Generate the powers-of-tau SRS on `device` (the CUDA card unless
        the caller asks for another).

        With the default seed, tau is drawn exactly as the reference's
        ``ParamsKZG::<Bn256>::setup(k, ChaCha20Rng::from_seed(Default))``
        draws it (one ``Fr::random`` from the zero seed), so g[i] = tau^i G
        matches a Rust-generated SRS point for point, and every committed
        ``params/kzg_bn254_{k}.srs`` byte for byte. Pass an int seed for a
        throwaway test SRS. Both bases' 2n points are one g1_batch_mul
        launch. With `timings`, its stages' seconds (the card synchronized
        at each end)."""
        device = resolve_device(device)
        t0 = time.time()
        if seed is None:
            from ..utils.chacha import reference_srs_tau

            tau = reference_srs_tau()
        else:
            rng = random.Random(("kzg-srs", seed, k).__repr__())
            tau = rng.randrange(1, FR_BN254.p)
        n = 1 << k
        scalars = _tau_powers(tau, n) + _lagrange_scalars(tau, k)
        stage_end("host scalars", t0, device, timings)
        ax, ay = _batch_g1_mul(scalars, device, timings)
        t0 = time.time()
        g2 = BN254_G2.g
        s_g2 = BN254_G2.mul(g2, tau)
        xy = torch.stack([ax, ay]).cpu().numpy()  # [2, 16, 2n]
        raw_xy = np.ascontiguousarray(xy.reshape(2, N_LIMBS, 2, n).transpose(2, 3, 0, 1))
        params = ParamsKZG(k, raw_xy.astype("<u2"), g2, s_g2, device)
        for basis in (0, 1):
            sl = slice(basis * n, (basis + 1) * n)
            params._bases[(bool(basis), str(device))] = (ax[:, sl].contiguous(), ay[:, sl].contiguous())
        stage_end("g2, host copy", t0, device, timings)
        return params

    # --- disk formats -------------------------------------------------------------
    # halo2-axiom's `ParamsKZG::<Bn256>::write` (RawBytes), byte for byte: k
    # as u32 LE, then g and g_lagrange as 64-byte raw points (x, y, 32 bytes
    # LE each, in Montgomery form, R = 2^256), then g2 and s_g2 as 128-byte
    # raw G2 points (x.c0, x.c1, y.c0, y.c1). Processed: compressed canonical
    # points (halo2curves to_bytes).

    def write(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            f.write(self.to_halo2_bytes())

    def to_halo2_bytes(self, raw: bool = True) -> bytes:
        q = FQ_BN254.p
        out = bytearray(self.k.to_bytes(4, "little"))
        if raw:
            enc = lambda c: ((c << 256) % q).to_bytes(32, "little")
            out += self._raw_xy.astype("<u2").tobytes()
            for (x, y) in (self.g2, self.s_g2):
                out += enc(x[0]) + enc(x[1]) + enc(y[0]) + enc(y[1])
        else:
            for basis in (self.g, self.g_lagrange):
                for pt in basis:
                    out += _g1_compress(pt)
            for pt in (self.g2, self.s_g2):
                out += _g2_compress(pt)
        return bytes(out)

    @staticmethod
    def from_halo2_bytes(data: bytes, device=None) -> "ParamsKZG":
        """An SRS from RawBytes or Processed bytes; its device bases go on
        `device` (the CUDA card unless the caller asks for another)."""
        device = resolve_device(device)
        q = FQ_BN254.p
        k = int.from_bytes(data[:4], "little")
        if not (1 <= k <= 28):
            raise ValueError(f"SRS header: implausible k={k}")
        n = 1 << k
        raw_size = 4 + 2 * n * 64 + 2 * 128
        proc_size = 4 + 2 * n * 32 + 2 * 64
        if len(data) == raw_size:
            rinv = pow(1 << 256, -1, q)
            xy = np.frombuffer(data, dtype="<u2", count=2 * n * 32, offset=4).reshape(2, n, 2, N_LIMBS)
            _check_canonical(xy)
            off = 4 + 2 * n * 64
            g2s = []
            for _ in range(2):
                cs = [int.from_bytes(data[off + 32 * i : off + 32 * (i + 1)], "little") * rinv % q
                      for i in range(4)]
                g2s.append(((cs[0], cs[1]), (cs[2], cs[3])))
                off += 128
            return ParamsKZG(k, xy.copy(), g2s[0], g2s[1], device)
        if len(data) == proc_size:
            off = 4
            bases = []
            for _ in range(2):
                bases.append([_g1_decompress(data[off + 32 * i : off + 32 * (i + 1)]) for i in range(n)])
                off += 32 * n
            g2s = [_g2_decompress(data[off : off + 64]), _g2_decompress(data[off + 64 : off + 128])]
            return ParamsKZG(k, _raw_from_points(bases), g2s[0], g2s[1], device)
        raise ValueError("SRS file size matches neither RawBytes nor Processed")

    @staticmethod
    def read(path: str, device=None) -> "ParamsKZG":
        """Read an SRS file: RawBytes or Processed, or the repo's legacy
        H2TPUSR3 container (canonical x, y); older containers raise. Its
        device bases go on `device` (the CUDA card unless the caller asks
        for another)."""
        device = resolve_device(device)
        with open(path, "rb") as f:
            data = f.read()
        if data[:8] in (_SRS_MAGIC_V1, _SRS_MAGIC_V2):
            raise ValueError("stale SRS file format; regenerate")
        if data[:8] != _SRS_MAGIC:
            return ParamsKZG.from_halo2_bytes(data, device)
        k = int.from_bytes(data[8:12], "little")
        n = 1 << k
        coord = lambda off: int.from_bytes(data[off : off + 32], "little")
        off = 12
        bases = []
        for _ in range(2):
            bases.append([(coord(off + 64 * i), coord(off + 64 * i + 32)) for i in range(n)])
            off += 64 * n
        g2s = []
        for _ in range(2):
            cs = [coord(off + 32 * i) for i in range(4)]
            g2s.append(((cs[0], cs[1]), (cs[2], cs[3])))
            off += 128
        return ParamsKZG(k, _raw_from_points(bases), g2s[0], g2s[1], device)

    # --- device bases ---------------------------------------------------------------
    def device_curve(self) -> DeviceCurve:
        if self._dc is None:
            self._dc = DeviceCurve(DeviceField(BN254_G1.base), BN254_G1)
        return self._dc

    def _affine(self, lagrange: bool, device) -> tuple:
        device = resolve_device(device if device is not None else self.device)
        key = (lagrange, str(device))
        b = self._bases.get(key)
        if b is None:
            b = self.affine_slice(lagrange, 0, self.n, device)
            self._bases[key] = b
        return b

    def affine_bases(self, device=None):
        """(Ax, Ay) monomial bases for msm_many_device."""
        return self._affine(False, device)

    def affine_lagrange_bases(self, device=None):
        """(Ax, Ay) Lagrange bases for msm_many_device."""
        return self._affine(True, device)

    def _packed(self, lagrange: bool, device) -> tuple:
        """(X, Y, Z) Jacobian affine lift of a basis for msm_device: the
        cached affine bases with Z = R, or Z = 0 at a (0, 0) sentinel."""
        device = resolve_device(device if device is not None else self.device)
        key = ("jacobian", lagrange, str(device))
        b = self._bases.get(key)
        if b is None:
            Ax, Ay = self._affine(lagrange, device)
            dc = self.device_curve()
            inf = (dc.df.is_zero(Ax) & dc.df.is_zero(Ay))[None, :]
            one = dc.df.one_mont_like(Ax)
            b = self._bases[key] = (Ax, Ay, torch.where(inf, 0, one))
        return b

    def packed_bases(self, device=None):
        """(X, Y, Z) monomial bases for msm_device (Z in {0, R})."""
        return self._packed(False, device)

    def affine_slice(self, lagrange: bool, start: int, stop: int, device) -> tuple:
        """(Ax, Ay) of bases [start, stop), uploaded to `device` (not cached:
        a mesh shard's slice)."""
        xy = self._raw_xy[int(lagrange), start:stop]  # [m, 2, 16] Montgomery limbs
        return tuple(to_device(xy[:, c, :].T, device) for c in (0, 1))

    # --- commitments -------------------------------------------------------------------
    def commit_columns(self, fr_df: DeviceField, vals_mont, bases, window_bits: int | None = None):
        """[C, 16, m] Montgomery columns -> int32[C, 33] canonical affine
        commitments (x limbs | y limbs | identity flag), all C columns in
        one double-and-add (m <= COMMIT_SIMPLE_MAX on the card) or one
        Pippenger MSM."""
        C, _, m = vals_mont.shape
        if C == 0:
            return torch.zeros((0, 33), dtype=torch.int32, device=vals_mont.device)
        dc = self.device_curve()
        # The path is chosen by the tensor's device, not as a fallback: on the
        # card, short columns take the double-and-add, as the JAX package's
        # device path does (kzg.py:499). CPU tensors keep Pippenger at every
        # m, as the JAX package never runs that branch on its CPU backend
        # (it commits there through its native engine), and with the
        # kernels' plain versions 254 doublings and mixed adds per column
        # cost far more than a Pippenger MSM on one core.
        if vals_mont.device.type != "cpu" and m <= COMMIT_SIMPLE_MAX:
            X, Y, Z = commit_double_and_add(dc, fr_df, vals_mont, bases)
        else:
            window_bits = window_bits or msm_window_bits(m, vals_mont.device)
            digits = window_digits(fr_df, vals_mont, window_bits)
            if m < self.n:
                digits = torch.nn.functional.pad(digits, (0, self.n - m))
            X, Y, Z = msm_many_device(dc, bases, digits, window_bits, True)
        return _pack_affine(dc.df, X, Y, Z)

    def commit_many_inside(self, fr_df: DeviceField, vals_mont, lagrange: bool,
                           window_bits: int | None = None, bases=None):
        """[C, 16, m] Montgomery column values (evaluations on H if
        `lagrange`, else coefficients), m <= n -> Jacobian [16, C]
        commitments: one Pippenger MSM on the tensor's device with the
        no-doubling mixed add (SRS bases are distinct); `bases` (Ax, Ay)
        overrides the cached ones."""
        device = vals_mont.device
        window_bits = window_bits or msm_window_bits(self.n, device)
        digits = window_digits(fr_df, vals_mont, window_bits)  # [C, W, m]
        if digits.shape[-1] < self.n:
            digits = torch.nn.functional.pad(digits, (0, self.n - digits.shape[-1]))
        A = bases if bases is not None else self._affine(lagrange, device)
        return msm_many_device(self.device_curve(), A, digits, window_bits, True)

    def _commit_host(self, values: list[int], lagrange: bool, window_bits, device):
        if len(values) > self.n:
            raise ValueError(f"{len(values)} values for an SRS of {self.n} points")
        device = resolve_device(device if device is not None else self.device)
        window_bits = window_bits or msm_window_bits(self.n, device)
        dc = self.device_curve()
        values = list(values) + [0] * (self.n - len(values))
        digits = dc.pack_scalars(values, window_bits, device)
        out = msm_device(dc, self._packed(lagrange, device), digits, window_bits)
        return dc.unpack_points(out)[0]

    def commit(self, coeffs: list[int], window_bits: int | None = None, device=None):
        """Commit to a polynomial in coefficient form: MSM(g, coeffs) -> host
        affine point (None for the identity), through msm_device on `device`
        (the params' device unless the caller asks for another)."""
        return self._commit_host(coeffs, False, window_bits, device)

    def commit_lagrange(self, evals: list[int], window_bits: int | None = None, device=None):
        """Commit to a polynomial given by its values on H (no inverse NTT):
        MSM(g_lagrange, evals) -> host affine point."""
        return self._commit_host(evals, True, window_bits, device)

    def commit_dev(self, coeffs_dev, fr_df: DeviceField, window_bits: int | None = None):
        """Commit to a Montgomery coefficient tensor [16, m], m <= n, on its
        device -> host affine point."""
        out = self.commit_many_inside(fr_df, coeffs_dev[None], False, window_bits)
        return self.device_curve().unpack_points(out)[0]

    def commit_many(self, polys: list[list[int]], window_bits: int = 8, device=None) -> list:
        return [self.commit(p, window_bits, device) for p in polys]


@torch.inference_mode()
def commit_double_and_add(dc: DeviceCurve, fr_df: DeviceField, vals_mont, bases):
    """[C, 16, m] Montgomery columns against the first m of the affine bases
    (Ax, Ay) of dc's curve -> Jacobian [16, C] commitments: every lane runs
    an MSB-first double-and-add over its scalar's 254 bits, then the lanes of
    each column are summed by a halving tree. The small branch of the JAX
    package's ``ParamsKZG._commit_chunk_jit`` (its kzg.py:499-519), as one
    ``commit_dbl_add`` call on the canonical scalars (its plain version on
    CPU tensors)."""
    return cf.commit_dbl_add(fr_df._from_mont(vals_mont), *bases)


def _affine_mont(df: DeviceField, X, Y, Z):
    """Jacobian [16, N] -> Montgomery affine (x, y), (0, 0) for the
    identity: one batch inversion of the Z's, then X / Z^2 and Y / Z^3."""
    zinv = df._batch_inv(Z)
    zi2 = df._mont_mul(zinv, zinv)
    return df._mont_mul(X, zi2), df._mont_mul(Y, df._mont_mul(zi2, zinv))


def _pack_affine(df: DeviceField, X, Y, Z):
    """Jacobian [16, C] -> int32[C, 33]: canonical x | y limbs | identity
    flag."""
    ax, ay = _affine_mont(df, X, Y, Z)
    return torch.cat(
        [df._from_mont(ax), df._from_mont(ay), df.is_zero(Z).to(torch.int32)[None, :]], dim=0
    ).transpose(0, 1)


def window_digits(fr_df: DeviceField, vals_mont, window_bits: int = 8):
    """[..., 16, m] Montgomery scalars -> int32[..., W, m] window digits:
    one from_mont, then shift/mask (stitching limbs where a window
    straddles two)."""
    mask = (1 << window_bits) - 1
    num_windows = -(-254 // window_bits)
    canon = fr_df._from_mont(vals_mont)
    outs = []
    for w in range(num_windows):
        lo_bit = w * window_bits
        k, s = divmod(lo_bit, 16)
        d = canon[..., k, :] >> s
        if s + window_bits > 16 and k + 1 < N_LIMBS:
            d = d | (canon[..., k + 1, :] << (16 - s))
        outs.append(d & mask)
    return torch.stack(outs, dim=-2)


def host_points(packed) -> list:
    """int32[C, 33] packed commitments -> host affine points (None = identity)."""
    from ..ops.limbs import limbs_to_ints

    arr = np.asarray(packed.detach().cpu().numpy() if torch.is_tensor(packed) else packed)
    arr = arr.reshape(-1, 33)
    xs = limbs_to_ints(arr[:, :N_LIMBS])
    ys = limbs_to_ints(arr[:, N_LIMBS : 2 * N_LIMBS])
    return [None if i else (x, y) for x, y, i in zip(xs, ys, arr[:, 32])]


def gen_srs(k: int, device=None, timings: dict | None = None) -> ParamsKZG:
    """Read-or-create ``kzg_bn254_{k}.srs`` in ``params/`` (env PARAMS_DIR
    respected; utils/mod.rs:437-443), on `device` (the CUDA card unless the
    caller asks for another). A missing or stale file is made by ``setup``
    with the reference tau and written in RawBytes; a legacy H2TPUSR3 file
    is rewritten in RawBytes where the directory allows. With `timings`,
    ``setup``'s stages and the write's seconds."""
    device = resolve_device(device)
    path = os.path.join(_params_dir(), f"kzg_bn254_{k}.srs")
    if os.path.exists(path):
        try:
            params = ParamsKZG.read(path, device)
            with open(path, "rb") as f:
                legacy = f.read(8) == _SRS_MAGIC
            if legacy:
                try:
                    params.write(path)
                except OSError:
                    pass  # read-only params dir: the rewrite is optional
            return params
        except ValueError:
            pass  # stale file: regenerate below
    params = ParamsKZG.setup(k, device=device, timings=timings)
    t0 = time.time()
    params.write(path)
    stage_end("write", t0, device, timings)
    return params
