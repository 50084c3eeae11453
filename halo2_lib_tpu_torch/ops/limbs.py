"""Device field arithmetic: 256-bit modular math on 16 x 16-bit limb tensors.

The port of ``halo2_lib_tpu/ops/limbs.py``. Elements are limb-major
``int32[..., 16, B]`` tensors: sixteen little-endian 16-bit limbs on axis -2,
the element (lane) axis last, Montgomery form x * 2^256 mod p unless stated
otherwise. A scalar is ``[16, 1]``; K scalars are ``[16, K]``. The layout is
the JAX package's, so tensors pass between the two packages unchanged
(convert.py); int32 holds every 16-bit limb without touching the sign bit.

Every ring operation goes through one kernel of ops/cuda_field.py: on a CUDA
tensor it launches the kernel, on a CPU tensor it runs the kernel's plain
version. Scans that JAX wrote with ``lax.associative_scan`` are log-depth
Hillis-Steele loops of ``mont_mul`` launches; the products are exact, so the
values are identical.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.fields import FQ_BN254, FR_BN254, PrimeField
from . import cuda_field as cf

LIMB_BITS = 16
N_LIMBS = 16  # 256 bits
MASK = (1 << LIMB_BITS) - 1


def _int_to_limbs(x: int, n: int = N_LIMBS) -> np.ndarray:
    """Host helper: int -> uint32[n] little-endian 16-bit limbs."""
    return np.array([(x >> (LIMB_BITS * i)) & MASK for i in range(n)], dtype=np.uint32)


def ints_to_limbs(values: list[int], n: int = N_LIMBS) -> np.ndarray:
    """Ints (< 2^(16n)) -> uint32[len, n] limbs, row per value (host layout)."""
    N = len(values)
    if N == 0:
        return np.zeros((0, n), dtype=np.uint32)
    try:
        a = np.array(values, dtype=np.int64)
        if a.min() >= 0:
            out = np.zeros((N, n), dtype=np.uint32)
            u16 = a.astype(np.uint64).view(np.uint16).reshape(N, 4)
            out[:, : min(4, n)] = u16[:, : min(4, n)]
            return out
    except (OverflowError, TypeError):
        pass
    nbytes = 2 * n
    buf = b"".join(int(v).to_bytes(nbytes, "little") for v in values)
    return np.frombuffer(buf, dtype="<u2").reshape(N, n).astype(np.uint32)


def ints_to_limbs_T(values: list[int], n: int = N_LIMBS) -> np.ndarray:
    """List of ints -> uint32[n, len] limb-major layout."""
    return np.ascontiguousarray(ints_to_limbs(values, n).T)


def limbs_to_ints(arr) -> list[int]:
    """uint32[..., n] 16-bit limbs (limbs MINOR) -> list of ints."""
    a = np.asarray(arr).astype(np.uint32)
    a = a.reshape(-1, a.shape[-1])
    buf = a.astype("<u2").tobytes()
    nbytes = 2 * a.shape[-1]
    return [int.from_bytes(buf[i * nbytes : (i + 1) * nbytes], "little") for i in range(a.shape[0])]


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    """Host uint32/uint16 limbs -> int32 tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(arr).astype(np.int32)).to(device)


def _field_id(field: PrimeField) -> int:
    if field.p == FR_BN254.p:
        return cf.FR
    if field.p == FQ_BN254.p:
        return cf.FQ
    raise ValueError("the port's kernels cover bn254 Fr and Fq only")


class DeviceField:
    """Batched modular arithmetic for one prime field (bn254 Fr or Fq).

    Inputs and outputs are limb-major ``int32[..., 16, B]`` tensors in
    Montgomery form; shapes broadcast like torch's.
    """

    def __init__(self, field: PrimeField):
        self.field = field
        self.fid = _field_id(field)
        p = field.p
        self.p_int = p
        self.R = (1 << 256) % p
        self.R2 = _int_to_limbs((self.R * self.R) % p)
        self.ONE_MONT = _int_to_limbs(self.R)
        self._pow_cache: dict[int, list[bool]] = {}

    # --- host <-> device packing ------------------------------------------------
    def pack(self, values, mont: bool = True, device=None) -> torch.Tensor:
        """Canonical ints -> limb-major [16, K] (an int -> [16, 1]) on
        `device` (the CUDA card unless the caller asks for another)."""
        if isinstance(values, int):
            values = [values]
        p = self.p_int
        vals = [(int(v) << 256) % p if mont else int(v) % p for v in values]
        return to_device(ints_to_limbs_T(vals), resolve_device(device))

    def unpack(self, arr: torch.Tensor, mont: bool = True) -> list[int]:
        """Limb-major [..., 16, B] -> canonical ints in element order."""
        a = arr.detach().cpu().numpy()
        a = np.moveaxis(a.reshape(-1, N_LIMBS, a.shape[-1]), 1, 2).reshape(-1, N_LIMBS)
        rinv = pow(1 << 256, -1, self.p_int) if mont else 1
        return [(v * rinv) % self.p_int for v in limbs_to_ints(a)]

    def _const(self, limbs: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        return to_device(limbs[:, None], like.device)

    # --- ring ops ------------------------------------------------------------------
    def _add(self, a, b):
        return cf.field_add(self.fid, a, b)

    def _sub(self, a, b):
        return cf.field_sub(self.fid, a, b)

    def _neg(self, a):
        return self._sub(torch.zeros_like(a), a)

    def _double(self, a):
        return self._add(a, a)

    def _mont_mul(self, a, b):
        return cf.mont_mul(self.fid, a, b)

    def _square(self, a):
        return self._mont_mul(a, a)

    def _to_mont(self, x):
        return self._mont_mul(x, self._const(self.R2, x))

    def _from_mont(self, x):
        one = torch.zeros((N_LIMBS, 1), dtype=torch.int32, device=x.device)
        one[0] = 1
        return self._mont_mul(x, one)

    # --- scalar-exponent ops ----------------------------------------------------
    def pow(self, a, e: int):
        """a^e for an int exponent e >= 0: MSB-first square-and-multiply, one
        mont_mul launch per square and per set bit after the leading one (a
        254-bit exponent is about 380 launches). The exponent's bits are
        cached by e, as the JAX package caches its jitted function."""
        if e < 0:
            raise ValueError(f"pow: negative exponent {e}")
        bits = self._pow_cache.get(e)
        if bits is None:
            bits = self._pow_cache[e] = [b == "1" for b in bin(e)[2:]]
        if e == 0:
            return self.one_mont_like(a).contiguous()
        acc = a
        for bit in bits[1:]:
            acc = self._mont_mul(acc, acc)
            if bit:
                acc = self._mont_mul(acc, a)
        return acc.clone() if acc is a else acc

    def _inv(self, a):
        """Fermat inverse a^(p-2); zero yields zero."""
        return cf.fermat_inv(self.fid, a)

    def prefix_prod(self, x):
        """Inclusive Montgomery prefix product along the lane axis: a
        Hillis-Steele loop of log2(B) mont_mul launches."""
        B = x.shape[-1]
        d = 1
        while d < B:
            prod = self._mont_mul(x[..., d:], x[..., :-d])
            x = torch.cat([x[..., :d], prod], dim=-1)
            d *= 2
        return x

    def _batch_inv(self, a):
        """Montgomery batch inversion along the lane axis: one Fermat inverse
        plus prefix and suffix product scans. inv(a_i) = prefix_{i-1} *
        suffix_{i+1} * inv(total); zero entries stay zero."""
        is_zero = self.is_zero(a)
        one = self.one_mont_like(a)
        safe = torch.where(is_zero[..., None, :], one, a)
        prefix_inc = self.prefix_prod(safe)
        suffix_inc = self.prefix_prod(safe.flip(-1)).flip(-1)
        inv_total = self._inv(prefix_inc[..., -1:])
        prefix_exc = torch.cat([one[..., :1], prefix_inc[..., :-1]], dim=-1)
        suffix_exc = torch.cat([suffix_inc[..., 1:], one[..., :1]], dim=-1)
        invs = self._mont_mul(self._mont_mul(prefix_exc, suffix_exc), inv_total)
        return torch.where(is_zero[..., None, :], torch.zeros_like(invs), invs)

    # the JAX package's jitted aliases; here the same eager functions (on the
    # class: bound methods kept on the instance would be a reference cycle)
    add, sub, neg, double = _add, _sub, _neg, _double
    mont_mul, square, to_mont, from_mont = _mont_mul, _square, _to_mont, _from_mont
    inv, batch_inv = _inv, _batch_inv

    # --- predicates ------------------------------------------------------------------
    @staticmethod
    def is_zero(a) -> torch.Tensor:
        """[..., 16, B] -> bool [..., B]."""
        return (a == 0).all(dim=-2)

    @staticmethod
    def eq(a, b) -> torch.Tensor:
        """Element-wise equality: [..., 16, B] x2 -> bool [..., B]."""
        return (a == b).all(dim=-2)

    @staticmethod
    def select(cond, a, b):
        """cond ? a : b, cond shaped like the element dims [..., B]."""
        return torch.where(cond[..., None, :], a, b)

    # --- constants (on `device`: the CUDA card unless the caller asks for another) --
    def zero(self, shape=(), device=None) -> torch.Tensor:
        """Zero tensor for element shape `shape` (an int B or a tuple whose
        last axis is the lane axis); () -> a [16, 1] scalar."""
        return torch.zeros(_limb_shape(shape), dtype=torch.int32, device=resolve_device(device))

    def one_mont(self, shape=(), device=None) -> torch.Tensor:
        return to_device(self.ONE_MONT[:, None], resolve_device(device)).expand(_limb_shape(shape))

    def const(self, value: int, shape=(), device=None) -> torch.Tensor:
        """The field element `value` (Montgomery form) broadcast over element
        shape `shape`."""
        return self.pack(value, device=device).expand(_limb_shape(shape))

    def one_mont_like(self, a) -> torch.Tensor:
        return self._const(self.ONE_MONT, a).expand(a.shape)


def _limb_shape(shape) -> tuple:
    """Element shape -> limb-major tensor shape (insert 16 before lanes)."""
    if isinstance(shape, int):
        shape = (shape,)
    if not shape:
        return (N_LIMBS, 1)
    return tuple(shape[:-1]) + (N_LIMBS, shape[-1])
