"""KZG structured reference string (ParamsKZG) and polynomial commitments.

The port of ``halo2_lib_tpu/backend/kzg.py``. ``ParamsKZG.read`` takes
halo2-axiom's ``ParamsKZG::<Bn256>`` RawBytes serialization, the format of
every committed ``params/kzg_bn254_{k}.srs``, so the port and the JAX package
read the same files. Like halo2, both bases are kept: ``g``
(monomial, tau^i G) and ``g_lagrange`` (L_i(tau) G); columns in Lagrange
form commit against ``g_lagrange`` without an inverse NTT.

Commitments on the card take the JAX package's two paths by column length
m: up to ``COMMIT_SIMPLE_MAX`` points an MSB-first double-and-add over the
254 scalar bits with the ``commit_dbl_add`` kernel (``commit_double_and_add``,
the small branch of the JAX ``_commit_chunk_jit``; every commit at k <= 10),
above it a Pippenger MSM (ops/ec_device.py, ``distinct=True`` as SRS bases
allow). Either way one call commits all the columns a transcript phase
writes. SRS generation (``setup``) and ``write`` are not part of this port;
``gen_srs`` reads the committed file.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops import cuda_field as cf
from ..ops.ec_device import DeviceCurve, msm_many_device, msm_window_bits
from ..ops.limbs import N_LIMBS, DeviceField
from ..utils.curves import BN254_G1
from ..utils.device import resolve_device
from ..utils.fields import FQ_BN254


# Columns of at most this many points commit by double-and-add on the card
# (the JAX package's COMMIT_SIMPLE_MAX default).
COMMIT_SIMPLE_MAX = 1024


def _params_dir() -> str:
    return os.environ.get("PARAMS_DIR", os.path.join(os.getcwd(), "params"))


class ParamsKZG:
    """Powers-of-tau SRS: g[i] = tau^i G1, g_lagrange[i] = L_i(tau) G1,
    g2, s_g2 = tau G2. Host points; packed device bases live on `device`."""

    def __init__(self, k: int, g: list, g_lagrange: list, g2, s_g2, device=None):
        self.k = k
        self.n = 1 << k
        self.g = g
        self.g_lagrange = g_lagrange
        self.g2 = g2
        self.s_g2 = s_g2
        self.device = device
        self._dc: DeviceCurve | None = None
        self._bases: dict = {}

    # --- disk format ---------------------------------------------------------------
    @staticmethod
    def read(path: str, device=None) -> "ParamsKZG":
        """Read an SRS file in halo2-axiom's ``ParamsKZG::write`` RawBytes
        format: k as u32 LE, then g and g_lagrange as 64-byte raw points (x,
        y, 32 bytes LE each, in Montgomery form), then g2 and s_g2 as 128-byte
        raw G2 points. Its device bases go on `device` (the CUDA card unless
        the caller asks for another)."""
        device = resolve_device(device)
        with open(path, "rb") as f:
            data = f.read()
        q = FQ_BN254.p
        k = int.from_bytes(data[:4], "little")
        if not (1 <= k <= 28) or len(data) != 4 + 2 * (1 << k) * 64 + 2 * 128:
            raise ValueError(f"{path}: not a RawBytes SRS file")
        n = 1 << k
        rinv = pow(1 << 256, -1, q)
        dec = lambda off: int.from_bytes(data[off : off + 32], "little") * rinv % q
        bases = []
        off = 4
        for _ in range(2):
            bases.append([(dec(off + 64 * i), dec(off + 64 * i + 32)) for i in range(n)])
            off += 64 * n
        g2s = []
        for _ in range(2):
            cs = [dec(off + 32 * i) for i in range(4)]
            g2s.append(((cs[0], cs[1]), (cs[2], cs[3])))
            off += 128
        return ParamsKZG(k, bases[0], bases[1], g2s[0], g2s[1], device)

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
            pts = self.g_lagrange if lagrange else self.g
            b = self._bases[key] = self.device_curve().pack_points_affine(pts, device)
        return b

    def affine_bases(self, device=None):
        """(Ax, Ay) monomial bases for msm_many_device."""
        return self._affine(False, device)

    def affine_lagrange_bases(self, device=None):
        """(Ax, Ay) Lagrange bases for msm_many_device."""
        return self._affine(True, device)

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


def _pack_affine(df: DeviceField, X, Y, Z):
    """Jacobian [16, C] -> int32[C, 33]: canonical x | y limbs | identity
    flag (one batch inversion of the Z's)."""
    inf = df.is_zero(Z)
    zinv = df._batch_inv(Z)
    zi2 = df._mont_mul(zinv, zinv)
    ax = df._mont_mul(X, zi2)
    ay = df._mont_mul(Y, df._mont_mul(zi2, zinv))
    return torch.cat(
        [df._from_mont(ax), df._from_mont(ay), inf.to(torch.int32)[None, :]], dim=0
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


def gen_srs(k: int, device=None) -> ParamsKZG:
    """Read ``params/kzg_bn254_{k}.srs`` (env PARAMS_DIR respected)."""
    path = os.path.join(_params_dir(), f"kzg_bn254_{k}.srs")
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path}: the port reads SRS files; it does not generate them")
    return ParamsKZG.read(path, device)
