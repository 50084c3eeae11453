"""CUDA kernels of the port, their loader, wrappers and plain versions.

The counterpart of ``halo2_lib_tpu/ops/pallas_field.py``. Every kernel takes
and returns the JAX package's layout: limb-major ``int32[..., 16, B]``
tensors, sixteen 16-bit limbs per element, Montgomery form with R = 2^256
(see ops/limbs.py). Field 0 is bn254 Fr, field 1 is bn254 Fq.

Kernel sources live in ``../csrc`` (one header and four source families):

=================  =============================================  ==========================
wrapper            replaces (halo2_lib_tpu/ops/pallas_field.py)    source
=================  =============================================  ==========================
``mont_mul``       ``_mm_kernel``                                  ``field_kernels.cu``
``field_add``      ``_field_add_kernel``                           ``field_kernels.cu``
``field_sub``      ``_field_sub_kernel``                           ``field_kernels.cu``
``fermat_inv``     ``_fermat_kernel``                              ``fermat_kernel.cu``
``ntt_butterfly``  ``_butterfly_kernel``                           ``ntt_kernels.cu``
``ntt_small``      ``_butterfly_kernel``, every stage of a transform  ``ntt_kernels.cu``
                   and its diagonal scalings
``colntt``         ``ntt4.py:_colntt_kernel``                      ``ntt_kernels.cu``
``ec_add``         ``_ec_add_kernel``                              ``ec_kernels.cu``
``ec_double``      ``_ec_double_kernel``                           ``ec_kernels.cu``
``ec_madd``        ``_ec_madd_kernel``                             ``ec_kernels.cu``
``bucket_scan``    ``_bucket_scan_kernel``                         ``ec_kernels.cu``
``bucket_sums_fused`` ``_bucket_scan_kernel`` + lane carry and pick   ``ec_kernels.cu``
``bucket_weight``  ``_ec_add_kernel`` + ``_ec_double_kernel`` loops ``ec_kernels.cu``
``msm_combine``    ``_ec_double_kernel`` + ``_ec_add_kernel`` loops ``ec_kernels.cu``
``commit_dbl_add`` ``_ec_double_kernel`` + ``_ec_madd_kernel`` scan,   ``ec_kernels.cu``
                   then the ``_ec_add_kernel`` lane tree
=================  =============================================  ==========================

``bucket_sums_fused``, ``bucket_weight`` and ``msm_combine`` fuse what a
Pippenger MSM ran as loops of single point ops
(``halo2_lib_tpu/ops/ec_device.py:463-688``): the bucket accumulation with
its lane-carry scan and pick (two launches, chains then carries;
``bucket_scan``, the literal port of the TPU kernel, stays as a checked
reference off the MSM's path), the weighted bucket reduction and the window
combine, each in the loops' order. ``commit_dbl_add`` fuses the small-column
commit (``halo2_lib_tpu/backend/kzg.py:499-519``: 254 scan steps of a
doubling and a selected mixed add, then ``tree_reduce``) into two launches;
``ec_double``, ``ec_madd`` and ``ec_add`` stay as the checked literal ports,
off every path. ``fermat_inv`` computes the Fermat kernel's function (the
Montgomery-form inverse) by a binary-GCD inversion (safegcd divsteps).

They are compiled with ``nvcc`` for ``sm_90a`` into one shared library with
a plain C interface, at first use, under ``halo2_lib_tpu_torch/_build/``
(rebuilt when the sources change), and called through ``ctypes`` on
PyTorch's current stream.

Each wrapper runs its kernel on CUDA tensors and counts the launch in
``LAUNCHES``. On CPU tensors, and only there, it runs the kernel's plain
version: the same function written with torch ops over int64 (CPU torch has
no uint32 add, sub or shift, and 16 x 16-bit products overflow int32). The
plain versions keep the limb axis first, ``[16, N]``, so that every limb row
they touch is one contiguous vector.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from ..utils.fields import FQ_BN254, FR_BN254

N_LIMBS = 16
MASK = 0xFFFF
FR, FQ = 0, 1
_MODULI = {FR: FR_BN254.p, FQ: FQ_BN254.p}

KERNELS = (
    "mont_mul",
    "field_add",
    "field_sub",
    "fermat_inv",
    "ntt_butterfly",
    "ntt_small",
    "colntt",
    "ec_add",
    "ec_double",
    "ec_madd",
    "bucket_scan",
    "bucket_sums_fused",
    "bucket_weight",
    "msm_combine",
    "commit_dbl_add",
)
# launches of each kernel since the last reset_launches(), and the operand
# shapes of each kernel's largest launch in that time (chip_smoke.py times
# every kernel at the shapes the main path gave it)
LAUNCHES: dict[str, int] = {k: 0 for k in KERNELS}
LARGEST: dict[str, tuple] = {}


def reset_launches() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0
    LARGEST.clear()


def _count(name: str, work: int, shapes: tuple) -> None:
    LAUNCHES[name] += 1
    if work > LARGEST.get(name, (0,))[0]:
        LARGEST[name] = (work, shapes)


# --- build and load -------------------------------------------------------------

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("field_kernels.cu", "fermat_kernel.cu", "ntt_kernels.cu", "ec_kernels.cu")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_LIB = None


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC_DIR)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC_DIR, name), "rb") as f:
                h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> str:
    """Compile csrc/ into ``_build/libh2_<hash>.so`` unless it exists; one
    ``nvcc`` per source, all started together, then one link. Returns the
    library's path."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"libh2_{_source_hash()}.so")
    if os.path.exists(so):
        return so
    nvcc = _nvcc()
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    extra = ["-Xptxas", "-v"] if verbose else []

    def compile_one(src):
        obj = os.path.join(tmp, src.replace(".cu", ".o"))
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", os.path.join(CSRC_DIR, src), "-o", obj]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}\n{res.stderr}")
        if verbose:
            print(res.stderr, flush=True)
        return obj

    with ThreadPoolExecutor(len(SOURCES)) as ex:
        objs = list(ex.map(compile_one, SOURCES))
    tmp_so = os.path.join(tmp, "lib.so")
    res = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", tmp_so], capture_output=True, text=True
    )
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}\n{res.stderr}")
    os.replace(tmp_so, so)
    shutil.rmtree(tmp, ignore_errors=True)
    return so


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        binary = [I, P, I64, I64, P, I64, I64, P, I64, I64, P]
        for fn in ("h2_mont_mul", "h2_field_add", "h2_field_sub"):
            getattr(lib, fn).argtypes = binary
        lib.h2_fermat_inv.argtypes = [I, P, P, I64, I64, P]
        lib.h2_ntt_butterfly.argtypes = [I, P, P, P, I64, I64, P, P, I64, I64, P]
        lib.h2_colntt.argtypes = [I, P, P, P, P, I64, I64, I64, P]
        lib.h2_ntt_small.argtypes = [I, P, P, P, P, I64, P, I64, I64, P]
        lib.h2_ec_add.argtypes = [P] * 9 + [I64, I64, P]
        lib.h2_ec_double.argtypes = [P] * 6 + [I64, I64, P]
        lib.h2_ec_madd.argtypes = [P] * 5 + [I64, I64] + [P] * 3 + [I64, I64, I, P]
        lib.h2_bucket_scan.argtypes = [P, P, P, I64, I64, I64, I, P]
        lib.h2_bucket_sums.argtypes = [P] * 7 + [I64] * 4 + [I, P]
        lib.h2_mul_chain.argtypes = [I, P, P, P, I64, I, P]
        lib.h2_bucket_weight.argtypes = [P] * 6 + [I64, I64, I, P]
        lib.h2_msm_combine.argtypes = [P] * 6 + [I64, I, I, P]
        lib.h2_commit_dbl_add.argtypes = [P] * 3 + [I64] + [P] * 4 + [I64, I64, P]
        for fn in (
            "h2_mont_mul", "h2_field_add", "h2_field_sub", "h2_fermat_inv",
            "h2_ntt_butterfly", "h2_ntt_small", "h2_colntt", "h2_ec_add", "h2_ec_double", "h2_ec_madd",
            "h2_bucket_scan", "h2_bucket_sums", "h2_bucket_weight", "h2_msm_combine",
            "h2_commit_dbl_add", "h2_mul_chain",
        ):
            getattr(lib, fn).restype = I
        _LIB = lib
    return _LIB


def load() -> float:
    """Build (if needed) and load the kernels; returns the seconds it took."""
    t = time.time()
    _lib()
    return time.time() - t


# --- wrapper plumbing --------------------------------------------------------------


def _prod(shape) -> int:
    out = 1
    for d in shape:
        out *= int(d)
    return out


def _on_cpu(*ts) -> bool:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devs))}")
    dev = next(iter(devs))
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for t in ts:
        if t.dtype != torch.int32:
            raise TypeError(f"kernel operands must be int32, got {t.dtype}")
    return False


def _broadcast(*shapes):
    try:
        return torch.broadcast_shapes(*shapes)
    except RuntimeError as e:
        raise ValueError(f"operand shapes do not broadcast: {e}") from None


def _check_limbs(t: torch.Tensor) -> None:
    if t.dim() < 2 or t.shape[-2] != N_LIMBS:
        raise ValueError(f"expected a limb-major [..., 16, B] tensor, got {tuple(t.shape)}")


def _operand(x: torch.Tensor, shape) -> tuple[torch.Tensor, int, int]:
    """View of `x` as the kernels' [Lx, 16, Bx] operand of an output of
    `shape`: Lx == 1 broadcasts the rows, Bx == 1 the lanes. Any other
    broadcast is materialised."""
    _check_limbs(x)
    B = shape[-1]
    Bx = x.shape[-1]
    if Bx not in (1, B):
        raise ValueError(f"lane axis {Bx} does not broadcast to {B}")
    lead = tuple(shape[:-2])
    xl = tuple(x.shape[:-2])
    if _prod(xl) == 1:
        return x.reshape(N_LIMBS, Bx).contiguous(), 1, Bx
    xl = (1,) * (len(lead) - len(xl)) + xl
    if xl != lead:
        x = x.expand(lead + (N_LIMBS, Bx))
    return x.contiguous(), _prod(lead), Bx


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_rc(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


# --- plain versions: int64 limbs, limb axis first ----------------------------------

_CONSTS: dict = {}


class _Consts:
    def __init__(self, fid: int, device):
        p = _MODULI[fid]
        self.p = p
        self.P = _col(p, device)  # [16, 1]
        self.one = _col((1 << 256) % p, device)
        # Toeplitz matrices of the Montgomery reduction's two constant
        # products, in float64 (every entry and column sum < 2^53 is exact):
        # m = (t mod R) * n' mod R, and m * p
        nprime = (-pow(p, -1, 1 << 256)) % (1 << 256)
        npl = [(nprime >> (16 * i)) & MASK for i in range(N_LIMBS)]
        pl = [(p >> (16 * i)) & MASK for i in range(N_LIMBS)]
        self.NP = torch.tensor(
            [[npl[k - i] if k >= i else 0 for i in range(N_LIMBS)] for k in range(N_LIMBS)],
            dtype=torch.float64, device=device,
        )
        self.PP = torch.tensor(
            [[pl[k - i] if 0 <= k - i < N_LIMBS else 0 for i in range(N_LIMBS)]
             for k in range(2 * N_LIMBS)],
            dtype=torch.float64, device=device,
        )
        # 2^(16k - 256): the carry out of T's low half as one float64 product
        self.W_LO = torch.tensor(
            [[2.0 ** (16 * k - 256) for k in range(N_LIMBS)]], dtype=torch.float64, device=device
        )


def _col(v: int, device) -> torch.Tensor:
    return torch.tensor(
        [(v >> (16 * i)) & MASK for i in range(N_LIMBS)], dtype=torch.int64, device=device
    )[:, None]


def _consts(fid: int, device) -> _Consts:
    key = (fid, str(device))
    c = _CONSTS.get(key)
    if c is None:
        c = _CONSTS[key] = _Consts(fid, device)
    return c


def to_rows(x: torch.Tensor, shape) -> torch.Tensor:
    """[..., 16, B] (broadcast to `shape`) -> int64 [16, N]."""
    x = x.expand(shape).to(torch.int64)
    return x.movedim(-2, 0).reshape(N_LIMBS, -1).contiguous()


def from_rows(y: torch.Tensor, shape) -> torch.Tensor:
    """int64 [16, N] -> int32 [..., 16, B] of `shape`."""
    lead = tuple(shape[:-2])
    return y.reshape((N_LIMBS,) + lead + (shape[-1],)).movedim(0, -2).to(torch.int32).contiguous()


def _carry(t: torch.Tensor, rounds: int = 1) -> None:
    """Propagate carries (or borrows) up the limb rows of [k, N] in place
    until every row but the last is in [0, 2^16):
    `rounds` whole-array rounds unchecked (each cuts a row's excess by 16
    bits, so rows below 2^(16 r + 16) need r), then rounds until no carry is
    left (a chain of 0xffff rows moves one row per round)."""
    while True:
        c = t[:-1] >> 16
        if rounds <= 0 and not bool(c.any()):
            return
        t[:-1] &= MASK
        t[1:] += c
        rounds -= 1


def _select_reduced(v: torch.Tensor, w: torch.Tensor):
    """Carry the [16, N] candidates v and w together (side by side on the
    lane axis, so each limb row stays one contiguous vector); return w where
    w >= 0 (its top row after carrying), else v, with w's top row masked to
    16 bits."""
    N = v.shape[1]
    both = torch.cat([v, w], dim=1)
    _carry(both)
    keep_w = both[N_LIMBS - 1, N:] >= 0
    both[N_LIMBS - 1] &= MASK
    return torch.where(keep_w, both[:, N:], both[:, :N])


def _reduce_once(t: torch.Tensor, c: _Consts) -> torch.Tensor:
    """Normalised [16, N] value t < 2p -> t mod p (t - p where that is
    non-negative)."""
    return _select_reduced(t, t - c.P)


# Up to this many elements the 256 partial products are formed at once
# (16 KB of int64 per element); above it, 16 row multiply-adds.
_SKEW_MAX = 1024


def mm64(a: torch.Tensor, b: torch.Tensor, c: _Consts) -> torch.Tensor:
    """Montgomery product of [16, N] int64 limb rows (SOS): T = a * b by
    16 row multiply-adds (column sums < 2^36), then m = (T mod R) * n' mod R
    and m * p as two float64 products with constant Toeplitz matrices
    (every sum stays below 2^53, so they are exact), and (T + m * p) / R."""
    N = max(a.shape[1], b.shape[1])
    a, b = a.expand(N_LIMBS, N), b.expand(N_LIMBS, N)
    if N <= _SKEW_MAX:
        # all 256 partial products at once; row i shifted by i and summed
        prod = torch.nn.functional.pad(a[:, None, :] * b[None, :, :], (0, 0, 0, 17))
        T = prod.reshape(N_LIMBS * 33, N)[: N_LIMBS * 32].reshape(N_LIMBS, 32, N).sum(0)
        T = torch.nn.functional.pad(T, (0, 0, 0, 1))
    else:
        T = torch.zeros((2 * N_LIMBS + 1, N), dtype=torch.int64, device=a.device)
        for i in range(N_LIMBS):
            T[i : i + N_LIMBS].addcmul_(a[i : i + 1], b)
    # T mod R with rows below 2^21: split each low row at bit 16
    lo = T[:N_LIMBS]
    t = lo & MASK
    t[1:] += lo[:-1] >> 16
    m = torch.mm(c.NP, t.to(torch.float64)).to(torch.int64)
    _carry(m, 3)  # rows < 2^41
    m[N_LIMBS - 1] &= MASK  # mod R
    T[: 2 * N_LIMBS] += torch.mm(c.PP, m.to(torch.float64)).to(torch.int64)
    # T is now a multiple of R, so its low half is cy * R exactly, with
    # cy < 2^39: the float64 sum of the low rows scaled by 2^(16k - 256) is
    # within 2^-10 of cy (whole-array carry rounds would walk that chain
    # one row per round)
    cy = torch.round(torch.mm(c.W_LO, T[:N_LIMBS].to(torch.float64))).to(torch.int64)[0]
    hi = T[N_LIMBS:]
    hi[0] += cy
    _carry(hi, 3)  # rows < 2^40
    return _reduce_once(hi[:N_LIMBS], c)


def add64(a, b, c: _Consts) -> torch.Tensor:
    s = a + b
    return _select_reduced(s, s - c.P)


def sub64(a, b, c: _Consts) -> torch.Tensor:
    d = a - b
    # d + p where d < 0: carry both, keep d where its top row is >= 0
    N = d.shape[1]
    both = torch.cat([d, d + c.P], dim=1)
    _carry(both)
    neg = both[N_LIMBS - 1, :N] < 0
    both[N_LIMBS - 1] &= MASK
    return torch.where(neg, both[:, N:], both[:, :N])


def is_zero64(a) -> torch.Tensor:
    return (a == 0).all(dim=0)


def _binary_plain(fn, fid, a, b):
    _check_limbs(a)
    _check_limbs(b)
    shape = _broadcast(a.shape, b.shape)
    c = _consts(fid, a.device)
    return from_rows(fn(to_rows(a, shape), to_rows(b, shape), c), shape)


def mont_mul_plain(fid: int, a, b):
    return _binary_plain(mm64, fid, a, b)


def field_add_plain(fid: int, a, b):
    return _binary_plain(add64, fid, a, b)


def field_sub_plain(fid: int, a, b):
    return _binary_plain(sub64, fid, a, b)


def fermat_inv_plain(fid: int, a):
    """a^(p-2) by the kernel's 4-bit fixed window (0 -> 0)."""
    _check_limbs(a)
    c = _consts(fid, a.device)
    x = to_rows(a, a.shape)
    table = [c.one.expand_as(x), x]
    for _ in range(2, 16):
        table.append(mm64(table[-1], x, c))
    e = c.p - 2
    digits = [(e >> (4 * q)) & 15 for q in range(63, -1, -1)]
    acc = None
    for d in digits:
        if acc is not None:
            for _ in range(4):
                acc = mm64(acc, acc, c)
            if d:
                acc = mm64(acc, table[d], c)
        elif d:
            acc = table[d]
    return from_rows(acc, a.shape)


def ntt_butterfly_plain(fid: int, a, b, w):
    _check_limbs(a)
    shape = _broadcast(a.shape, b.shape, w.shape)
    c = _consts(fid, a.device)
    x, y, t = (to_rows(v, shape) for v in (a, b, w))
    return from_rows(add64(x, y, c), shape), from_rows(mm64(sub64(x, y, c), t, c), shape)


def ntt_small_plain(fid: int, x, tw, pre=None, post=None):
    """ntt_small's function as ops/ntt.py composed it before the fusion: the
    pre product, then per stage one butterfly over the two halves and the
    block interleave, then the post product."""
    C, _, N = x.shape
    if pre is not None:
        x = mont_mul_plain(fid, x, pre)
    n, s = N, 1
    while n > 1:
        m = n // 2
        # lane p * s + j of the halves uses w^(p * s), repeated s times
        wp = tw[:, ::s][:, :m, None].expand(N_LIMBS, m, s).reshape(N_LIMBS, N // 2)
        top, bot = ntt_butterfly_plain(fid, x[..., : N // 2], x[..., N // 2 :], wp)
        x = torch.stack(
            [top.reshape(C, N_LIMBS, m, s), bot.reshape(C, N_LIMBS, m, s)], dim=-2
        ).reshape(C, N_LIMBS, N)
        n, s = m, 2 * s
    return x if post is None else mont_mul_plain(fid, x, post)


def colntt_plain(fid: int, x, tw, mid=None):
    """Every radix-2 Stockham DIF stage of the length-A transforms along
    axis 1 of x [L, A, 16, B], then the optional diagonal twiddle mid
    [A, 16, B]; the stage loop of ntt4.py:_colntt_kernel on [16, L, A, B]
    int64 limbs."""
    L, A, _, B = x.shape
    c = _consts(fid, x.device)
    half = A // 2
    X = x.permute(2, 0, 1, 3).to(torch.int64)  # [16, L, A, B]
    w_all = tw.to(torch.int64)  # [16, A/2]
    n, s = A, 1
    while n > 1:
        m = n // 2
        # row i = p * s + j uses w^(p * s), repeated s times along rows
        wp = w_all[:, ::s][:, :m, None].expand(N_LIMBS, m, s).reshape(N_LIMBS, 1, half, 1)
        wp = wp.expand(N_LIMBS, L, half, B).reshape(N_LIMBS, -1)
        a = X[:, :, :half].reshape(N_LIMBS, -1)
        b = X[:, :, half:].reshape(N_LIMBS, -1)
        top = add64(a, b, c).reshape(N_LIMBS, L, m, 1, s, B)
        bot = mm64(sub64(a, b, c), wp, c).reshape(N_LIMBS, L, m, 1, s, B)
        X = torch.cat([top, bot], dim=3).reshape(N_LIMBS, L, A, B)
        n, s = m, 2 * s
    if mid is not None:
        md = mid.to(torch.int64).permute(1, 0, 2)[:, None].expand(N_LIMBS, L, A, B)
        X = mm64(X.reshape(N_LIMBS, -1), md.reshape(N_LIMBS, -1), c).reshape(N_LIMBS, L, A, B)
    return X.permute(1, 2, 0, 3).to(torch.int32).contiguous()


# EC formulas over Fq on [16, N] int64 rows; independent products are
# stacked into one mm64 call, as ops/ec_device.py stacks them.


def _mmk(c, *pairs):
    """Stacked Montgomery products of (a, b) pairs of [16, N] rows."""
    N = pairs[0][0].shape[1]
    a = torch.cat([p[0] for p in pairs], dim=1)
    b = torch.cat([p[1] for p in pairs], dim=1)
    out = mm64(a, b, c)
    return [out[:, i * N : (i + 1) * N] for i in range(len(pairs))]


def _sel(cond, a, b):
    return torch.where(cond, a, b)


def ec_add64(P1, P2, c: _Consts):
    X1, Y1, Z1 = P1
    X2, Y2, Z2 = P2
    ad, sb = (lambda x, y: add64(x, y, c)), (lambda x, y: sub64(x, y, c))
    Z1Z1, Z2Z2, A, B = _mmk(c, (Z1, Z1), (Z2, Z2), (X1, X1), (Y1, Y1))
    U1, U2, t1, t2, C, YZ = _mmk(c, (X1, Z2Z2), (X2, Z1Z1), (Y1, Z2), (Y2, Z1), (B, B), (Y1, Z1))
    tXB = ad(X1, B)
    S1, S2, tXB2 = _mmk(c, (t1, Z2Z2), (t2, Z1Z1), (tXB, tXB))
    H = sb(U2, U1)
    r_ = sb(S2, S1)
    rr = ad(r_, r_)
    E = ad(ad(A, A), A)
    D = sb(sb(tXB2, A), C)
    D = ad(D, D)
    zz = ad(Z1, Z2)
    HH, F_, rr2, zz2 = _mmk(c, (H, H), (E, E), (rr, rr), (zz, zz))
    I = ad(ad(HH, HH), ad(HH, HH))
    X3d = sb(F_, ad(D, D))
    zzsub = sb(sb(zz2, Z1Z1), Z2Z2)
    J, V, Z3, Ed = _mmk(c, (H, I), (U1, I), (zzsub, H), (E, sb(D, X3d)))
    X3 = sb(sb(rr2, J), ad(V, V))
    rV, S1J = _mmk(c, (rr, sb(V, X3)), (S1, J))
    Y3 = sb(rV, ad(S1J, S1J))
    C4 = ad(ad(C, C), ad(C, C))
    Y3d = sb(Ed, ad(C4, C4))
    Z3d = ad(YZ, YZ)
    p1_inf, p2_inf = is_zero64(Z1), is_zero64(Z2)
    h_zero, r_zero = is_zero64(H), is_zero64(r_)
    is_double = h_zero & r_zero & ~p1_inf & ~p2_inf
    is_ident = h_zero & ~r_zero & ~p1_inf & ~p2_inf
    X3 = _sel(is_double, X3d, X3)
    Y3 = _sel(is_double, Y3d, Y3)
    Z3 = _sel(is_double, Z3d, Z3)
    Z3 = _sel(is_ident, torch.zeros_like(Z3), Z3)
    return (
        _sel(p2_inf, X1, _sel(p1_inf, X2, X3)),
        _sel(p2_inf, Y1, _sel(p1_inf, Y2, Y3)),
        _sel(p2_inf, Z1, _sel(p1_inf, Z2, Z3)),
    )


def ec_double64(P, c: _Consts):
    X, Y, Z = P
    ad, sb = (lambda x, y: add64(x, y, c)), (lambda x, y: sub64(x, y, c))
    A, B = _mmk(c, (X, X), (Y, Y))
    E = ad(ad(A, A), A)
    tXB = ad(X, B)
    C, tXB2, F_ = _mmk(c, (B, B), (tXB, tXB), (E, E))
    D = sb(sb(tXB2, A), C)
    D = ad(D, D)
    X3 = sb(F_, ad(D, D))
    r0, r1 = _mmk(c, (E, sb(D, X3)), (Y, Z))
    C4 = ad(ad(C, C), ad(C, C))
    return X3, sb(r0, ad(C4, C4)), ad(r1, r1)


def ec_madd64(P1, x2, y2, distinct: bool, c: _Consts):
    """Jacobian + affine ((0, 0) = identity) -> Jacobian (madd-2007-bl)."""
    X1, Y1, Z1 = P1
    ad, sb = (lambda x, y: add64(x, y, c)), (lambda x, y: sub64(x, y, c))
    if distinct:
        (Z1Z1,) = _mmk(c, (Z1, Z1))
        U2, t2 = _mmk(c, (x2, Z1Z1), (y2, Z1))
        H = sb(U2, X1)
        S2, HH = _mmk(c, (t2, Z1Z1), (H, H))
    else:
        Z1Z1, A, B = _mmk(c, (Z1, Z1), (x2, x2), (y2, y2))
        xB = ad(x2, B)
        U2, t2, C, xB2 = _mmk(c, (x2, Z1Z1), (y2, Z1), (B, B), (xB, xB))
        H = sb(U2, X1)
        E = ad(ad(A, A), A)
        S2, HH, F_ = _mmk(c, (t2, Z1Z1), (H, H), (E, E))
    rr = sb(S2, Y1)
    rr = ad(rr, rr)
    I = ad(HH, HH)
    I = ad(I, I)
    ZH = ad(Z1, H)
    if distinct:
        J, V, rr2, ZH2 = _mmk(c, (H, I), (X1, I), (rr, rr), (ZH, ZH))
    else:
        D = sb(sb(xB2, A), C)
        D = ad(D, D)
        X3d = sb(F_, ad(D, D))
        J, V, rr2, ZH2, Ed = _mmk(c, (H, I), (X1, I), (rr, rr), (ZH, ZH), (E, sb(D, X3d)))
    X3 = sb(sb(rr2, J), ad(V, V))
    Z3 = sb(sb(ZH2, Z1Z1), HH)
    rV, Y1J = _mmk(c, (rr, sb(V, X3)), (Y1, J))
    Y3 = sb(rV, ad(Y1J, Y1J))
    p1_inf = is_zero64(Z1)
    live = ~(is_zero64(x2) & is_zero64(y2))
    if not distinct:
        C4 = ad(ad(C, C), ad(C, C))
        Y3d = sb(Ed, ad(C4, C4))
        Z3d = ad(y2, y2)
        is_double = live & ~p1_inf & is_zero64(H) & is_zero64(rr)
        X3 = _sel(is_double, X3d, X3)
        Y3 = _sel(is_double, Y3d, Y3)
        Z3 = _sel(is_double, Z3d, Z3)
    one = c.one.expand_as(Z1)
    X3 = _sel(p1_inf, x2, X3)
    Y3 = _sel(p1_inf, y2, Y3)
    Z3 = _sel(p1_inf, _sel(live, one, torch.zeros_like(Z1)), Z3)
    return _sel(~live, X1, X3), _sel(~live, Y1, Y3), _sel(~live, Z1, Z3)


def ec_add_plain(P1, P2):
    shape = _broadcast(*(t.shape for t in (*P1, *P2)))
    c = _consts(FQ, P1[0].device)
    out = ec_add64(
        tuple(to_rows(t, shape) for t in P1), tuple(to_rows(t, shape) for t in P2), c
    )
    return tuple(from_rows(t, shape) for t in out)


def ec_double_plain(P):
    shape = P[0].shape
    c = _consts(FQ, P[0].device)
    out = ec_double64(tuple(to_rows(t, shape) for t in P), c)
    return tuple(from_rows(t, shape) for t in out)


def ec_madd_plain(P1, A2, distinct: bool):
    shape = _broadcast(*(t.shape for t in (*P1, *A2)))
    c = _consts(FQ, P1[0].device)
    x2, y2 = (to_rows(t, shape) for t in A2)
    out = ec_madd64(tuple(to_rows(t, shape) for t in P1), x2, y2, distinct, c)
    return tuple(from_rows(t, shape) for t in out)


def unpack_bases(axy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., 16, CL] packed rows (row j = limb j | limb j+8 << 16; x rows 0-7,
    y rows 8-15) -> (x, y) int64 [..., 16, CL] limbs. The packed rows use the
    sign bit of int32, so every value is masked to 32 bits before a shift."""
    u = axy.to(torch.int64) & 0xFFFFFFFF
    px, py = u[..., :8, :], u[..., 8:, :]
    x = torch.cat([px & MASK, px >> 16], dim=-2)
    y = torch.cat([py & MASK, py >> 16], dim=-2)
    return x, y


def bucket_scan_plain(axy, seg_start, distinct: bool):
    """Inclusive segmented mixed-add scan (see bucket_scan): a Python loop
    over the R steps, all (window, lane) chains at once."""
    Wb, R, _, CL = axy.shape
    c = _consts(FQ, axy.device)
    x2, y2 = unpack_bases(axy)  # [Wb, R, 16, CL]
    zero = torch.zeros((N_LIMBS, Wb * CL), dtype=torch.int64, device=axy.device)
    acc = (zero, zero, zero)
    outs = []
    for r in range(R):
        start = (seg_start[:, r] != 0).reshape(-1)
        acc = tuple(torch.where(start, zero, t) for t in acc)
        xr = x2[:, r].movedim(-2, 0).reshape(N_LIMBS, -1)
        yr = y2[:, r].movedim(-2, 0).reshape(N_LIMBS, -1)
        acc = ec_madd64(acc, xr, yr, distinct, c)
        outs.append(torch.cat(acc, dim=0))  # [48, Wb * CL]
    out = torch.stack(outs, dim=0).reshape(R, 3 * N_LIMBS, Wb, CL)
    return out.permute(2, 0, 1, 3).to(torch.int32).contiguous()


def pack_bases(Ax: torch.Tensor, Ay: torch.Tensor) -> torch.Tensor:
    """Affine bases (x, y), limb-major [16, npts] -> the point-major int32
    [npts, 16] words that bucket_sums_fused reads: x words 0-7, y words 8-15,
    word k = limb 2k | limb 2k + 1 << 16 (built in int64, wrapped to int32)."""
    v = torch.cat([Ax, Ay], dim=0).to(torch.int64).reshape(N_LIMBS, 2, -1)
    w = v[:, 0] | (v[:, 1] << 16)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32).T.contiguous()


def unpack_point_words(bases: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[npts, 16] words (pack_bases) -> (x, y) int64 [16, npts] limbs."""
    u = bases.to(torch.int64).T & 0xFFFFFFFF  # [16, npts]
    limbs = torch.stack([u & MASK, u >> 16], dim=1).reshape(2 * N_LIMBS, -1)
    return limbs[:N_LIMBS], limbs[N_LIMBS:]


def _seg_scan64(P, flag, lanes: int, c: _Consts):
    """Inclusive segmented sums across lanes of [16, N] point rows, every
    `lanes`-lane block independent (Hillis-Steele: level d adds the point
    2^d lanes below where the lane is not yet flagged; a lane is flagged at
    a segment start and once it has absorbed one)."""
    N = P[0].shape[1]
    idx = torch.arange(N, device=P[0].device) % lanes
    f = flag
    for d in range((lanes - 1).bit_length()):
        sh = 1 << d
        s = ec_add64(P, tuple(torch.roll(t, sh, dims=-1) for t in P), c)
        use = ~f & (idx >= sh)
        P = tuple(torch.where(use, a, b) for a, b in zip(s, P))
        f = f | (use & torch.roll(f, sh)) | (idx < sh)
    return P


def bucket_sums_fused_plain(bases, order, digits, lanes: int, nbuckets: int, distinct: bool):
    """The bucket sums of bucket_sums_fused on int64 rows, in the kernel's
    order: every (window, lane) chain at once, one R-step loop (a lane-local
    sum goes to its bucket where its run ends), the segmented scan of the
    lanes' trailing sums, the empty buckets' (X, Y) from the slot below
    them, then each carried bucket's add."""
    Wtot, n = digits.shape
    CL, dev = lanes, digits.device
    R = n // CL
    c = _consts(FQ, dev)
    bx, by = unpack_point_words(bases)
    d = digits.to(torch.int64)
    o = order.to(torch.int64)
    edge = torch.full((Wtot, 1), -1, dtype=torch.int64, device=dev)
    prev = torch.cat([edge, d[:, :-1]], dim=1).reshape(Wtot, CL, R)
    nxt = torch.cat([d[:, 1:], edge], dim=1).reshape(Wtot, CL, R)
    dl, ol = d.reshape(Wtot, CL, R), o.reshape(Wtot, CL, R)
    S = [torch.zeros((Wtot, N_LIMBS, nbuckets), dtype=torch.int64, device=dev) for _ in range(3)]
    zero = torch.zeros((N_LIMBS, Wtot * CL), dtype=torch.int64, device=dev)
    win = torch.arange(Wtot, device=dev).repeat_interleave(CL)
    acc = (zero, zero, zero)
    for r in range(R):
        dr = dl[:, :, r].reshape(-1)
        start = (dr != prev[:, :, r].reshape(-1))
        acc = tuple(torch.where(start, zero, t) for t in acc)
        live = dr > 0
        ix = ol[:, :, r].reshape(-1)
        x2 = torch.where(live, bx[:, ix], 0)
        y2 = torch.where(live, by[:, ix], 0)
        acc = ec_madd64(acc, x2, y2, distinct, c)
        (ends,) = torch.nonzero(live & (dr != nxt[:, :, r].reshape(-1)), as_tuple=True)
        for t, a in zip(S, acc):
            t[win[ends], :, dr[ends] - 1] = a[:, ends].T
    # the carries: lane l's is the scanned trailing sum of lane l - 1
    first = dl[:, :, 0]
    has_start = (first != prev[:, :, 0]) | (first != dl[:, :, R - 1])
    scan = _seg_scan64(acc, has_start.reshape(-1), CL, c)
    # empty buckets: (X, Y) of the slot below (its run's lane-local sum), Z 0
    targets = torch.arange(1, nbuckets + 1, device=dev).expand(Wtot, nbuckets).contiguous()
    q = torch.searchsorted(d, targets, right=True) - 1
    dq = torch.gather(d, 1, q.clamp(min=0))
    empty = (q < 0) | (dq != targets)
    wi, bi = torch.nonzero(empty, as_tuple=True)
    qe, de = q[wi, bi], dq[wi, bi]
    o0 = o[wi, 0]
    for t, base in ((S[0], bx), (S[1], by)):
        below = t[wi, :, (de - 1).clamp(min=0)]
        below = torch.where((de > 0)[:, None], below, 0)
        t[wi, :, bi] = torch.where((qe < 0)[:, None], base[:, o0].T, below)
    S[2][wi, :, bi] = 0
    # carried buckets: the run holding lane l's first slot began in an earlier
    # lane and ends in lane l
    lane = torch.arange(CL, device=dev)
    nxt_first = torch.cat([dl[:, 1:, 0], edge], dim=1)
    fix = (lane >= 1) & (first > 0) & (prev[:, :, 0] == first) & (
        (lane == CL - 1) | (nxt_first != first)
    )
    wi, li = torch.nonzero(fix, as_tuple=True)
    if wi.numel():
        bi = first[wi, li] - 1
        carry = tuple(t[:, wi * CL + li - 1] for t in scan)
        fixed = ec_add64(tuple(t[wi, :, bi].T for t in S), carry, c)
        for t, f in zip(S, fixed):
            t[wi, :, bi] = f.T
    return tuple(t.to(torch.int32) for t in S)


def _suffix64(P, lanes: int, c: _Consts):
    """Within-block inclusive suffix sums of [16, N] point rows, every
    `lanes`-lane block independent (Hillis-Steele; lane l absorbs lanes
    l..lanes-1 of its block, a lane past the end adds the identity)."""
    N = P[0].shape[1]
    l_loc = torch.arange(N, device=P[0].device) % lanes
    for d in range(max(lanes.bit_length() - 1, 1)):
        sh = 1 << d
        ok = l_loc + sh < lanes
        Q = tuple(torch.where(ok, torch.roll(t, -sh, dims=-1), torch.zeros_like(t)) for t in P)
        P = ec_add64(P, Q, c)
    return P


def bucket_weight_plain(S, lanes: int):
    """The weighted bucket reduction (see bucket_weight) on merged lanes: slot
    b - 1 = r * lanes + l, all windows' lane blocks side by side. A
    descending (acc, tot) pass over the R2 slot rows gives per lane
      A_l = sum_r S'_{r,l},  tot_l = sum_r (r + 1) * S'_{r,l}
    and with the within-block suffix scan: T = lanes * (TT - TA) + TS, where
    TA = suf(A)[0], TS = suf(suf(A))[0], TT = suf(tot)[0]."""
    Wtot, _, nb = S[0].shape
    c = _consts(FQ, S[0].device)
    R2 = -(-nb // lanes)
    M = Wtot * lanes
    # rows[r] = [16, M], lane = w * lanes + l; rows descending
    rows = tuple(
        torch.nn.functional.pad(t.to(torch.int64), (0, R2 * lanes - nb))
        .reshape(Wtot, N_LIMBS, R2, lanes).permute(2, 1, 0, 3).reshape(R2, N_LIMBS, M).flip(0)
        for t in S
    )
    zero = torch.zeros((N_LIMBS, M), dtype=torch.int64, device=S[0].device)
    acc = tot = (zero, zero, zero)
    for r in range(R2):
        acc = ec_add64(acc, tuple(t[r] for t in rows), c)
        tot = ec_add64(tot, acc, c)
    suf1 = _suffix64(tuple(torch.cat([a, t], dim=1) for a, t in zip(acc, tot)), lanes, c)
    sufA = tuple(t[:, :M] for t in suf1)
    TT = tuple(t[:, M::lanes] for t in suf1)
    TS = tuple(t[:, 0::lanes] for t in _suffix64(sufA, lanes, c))
    TA = tuple(t[:, 0::lanes] for t in sufA)
    negTA = (TA[0], sub64(torch.zeros_like(TA[1]), TA[1], c), TA[2])
    D = ec_add64(TT, negTA, c)
    for _ in range(lanes.bit_length() - 1):  # * lanes (a power of two)
        D = ec_double64(D, c)
    return tuple(t.to(torch.int32) for t in ec_add64(D, TS, c))


def msm_combine_plain(T, windows: int, window_bits: int):
    """The MSB-first window combine (see msm_combine): res = 2^c * res + T_w
    for w = W - 1 down to 0, all columns at once."""
    C = T[0].shape[1] // windows
    c = _consts(FQ, T[0].device)
    Tw = tuple(t.to(torch.int64).reshape(N_LIMBS, C, windows) for t in T)
    zero = torch.zeros((N_LIMBS, C), dtype=torch.int64, device=T[0].device)
    res = (zero, zero, zero)
    for w in range(windows - 1, -1, -1):
        for _ in range(window_bits):
            res = ec_double64(res, c)
        res = ec_add64(res, tuple(t[..., w] for t in Tw), c)
    return tuple(t.to(torch.int32) for t in res)


def _tree64(P, lanes: int, c: _Consts):
    """Halving tree of [16, K * lanes] point rows, every `lanes`-lane block
    summed on its own in DeviceCurve.tree_reduce's order (level by level,
    lanes 2i and 2i + 1, an odd last lane carried) -> [16, K]."""
    P = tuple(t.reshape(N_LIMBS, -1, lanes) for t in P)
    n = lanes
    while n > 1:
        half = n // 2
        even = tuple(t[..., 0 : 2 * half : 2].reshape(N_LIMBS, -1) for t in P)
        odd = tuple(t[..., 1 : 2 * half : 2].reshape(N_LIMBS, -1) for t in P)
        s = tuple(t.reshape(N_LIMBS, -1, half) for t in ec_add64(even, odd, c))
        P = tuple(torch.cat([a, t[..., -1:]], -1) for a, t in zip(s, P)) if n % 2 else s
        n = P[0].shape[-1]
    return tuple(t[..., 0] for t in P)


def commit_dbl_add_plain(scalars, Ax, Ay):
    """The small-column commit of commit_dbl_add on int64 rows: every
    (column, lane) at once, for the 254 scalar bits from the top, ec_double64
    and then ec_madd64 (with its doubling branch) kept where the bit is 1;
    then each column's halving tree of ec_add64."""
    C, _, m = scalars.shape
    c = _consts(FQ, scalars.device)
    s = scalars.to(torch.int64).permute(1, 0, 2).reshape(N_LIMBS, C * m)  # lane = col * m + e
    x2, y2 = (t[:, :m].to(torch.int64).repeat(1, C) for t in (Ax, Ay))
    zero = torch.zeros((N_LIMBS, C * m), dtype=torch.int64, device=scalars.device)
    acc = (zero, zero, zero)
    for b in range(253, -1, -1):
        bit = ((s[b // 16] >> (b % 16)) & 1) != 0
        acc = ec_double64(acc, c)
        acc = tuple(torch.where(bit, a, d) for a, d in zip(ec_madd64(acc, x2, y2, False, c), acc))
    return tuple(t.to(torch.int32) for t in _tree64(acc, m, c))


# --- wrappers ------------------------------------------------------------------------


def _binary(name: str, fid: int, a, b, plain):
    if _on_cpu(a, b):
        return plain(fid, a, b)
    _check_limbs(a)
    _check_limbs(b)
    shape = _broadcast(a.shape, b.shape)
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    L, B = _prod(shape[:-2]), shape[-1]
    if L * B == 0:
        return out
    av, La, Ba = _operand(a, shape)
    bv, Lb, Bb = _operand(b, shape)
    fn = getattr(_lib(), f"h2_{name}")
    rc = fn(fid, _ptr(av), La, Ba, _ptr(bv), Lb, Bb, _ptr(out), L, B, _stream(out))
    _check_rc(rc, name)
    _count(name, L * B, (tuple(av.shape), tuple(bv.shape)))
    return out


def mont_mul(fid: int, a, b):
    """Montgomery product a * b * 2^-256 mod p of broadcastable [..., 16, B]."""
    return _binary("mont_mul", fid, a, b, mont_mul_plain)


def field_add(fid: int, a, b):
    return _binary("field_add", fid, a, b, field_add_plain)


def field_sub(fid: int, a, b):
    return _binary("field_sub", fid, a, b, field_sub_plain)


def fermat_inv(fid: int, a):
    """a^(p-2) (the Montgomery-form inverse; 0 -> 0) of [..., 16, B]."""
    if _on_cpu(a):
        return fermat_inv_plain(fid, a)
    _check_limbs(a)
    x = a.contiguous()
    out = torch.empty_like(x)
    L, B = _prod(x.shape[:-2]), x.shape[-1]
    if L * B == 0:
        return out
    rc = _lib().h2_fermat_inv(fid, _ptr(x), _ptr(out), L, B, _stream(x))
    _check_rc(rc, "fermat_inv")
    _count("fermat_inv", L * B, (tuple(x.shape),))
    return out


def ntt_butterfly(fid: int, a, b, w):
    """(a + b, (a - b) * w): one Stockham stage. a, b: [..., 16, B]; the
    twiddles w broadcast to them."""
    if _on_cpu(a, b, w):
        return ntt_butterfly_plain(fid, a, b, w)
    _check_limbs(a)
    if a.shape != b.shape:
        raise ValueError(f"butterfly halves differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    shape = a.shape
    x, y = a.contiguous(), b.contiguous()
    top = torch.empty(shape, dtype=torch.int32, device=a.device)
    bot = torch.empty_like(top)
    L, B = _prod(shape[:-2]), shape[-1]
    if L * B == 0:
        return top, bot
    wv, Lw, Bw = _operand(w, shape)
    rc = _lib().h2_ntt_butterfly(
        fid, _ptr(x), _ptr(y), _ptr(wv), Lw, Bw, _ptr(top), _ptr(bot), L, B, _stream(top)
    )
    _check_rc(rc, "ntt_butterfly")
    _count("ntt_butterfly", L * B, (tuple(x.shape), tuple(wv.shape)))
    return top, bot


# longest transform ntt_small holds in one block's shared memory
NTT_SMALL_MAX = 1 << 11


def ntt_small(fid: int, x, tw, pre=None, post=None):
    """Every radix-2 Stockham DIF stage of the length-n transform of each
    column of x int32[C, 16, n] (natural order in and out), in one launch.
    tw: [16, n/2] Montgomery powers 1, w, ..., w^(n/2-1) of the transform's
    root (w^-1 for an inverse). pre [16, n], when given, is multiplied into
    x before the first stage (a forward coset's shift powers); post [16, n]
    or [16, 1] into the result after the last (an inverse's 1/n, or an
    inverse coset's shift^-i / n). n is a power of two in [2, 2^11]."""
    ts = tuple(t for t in (x, tw, pre, post) if t is not None)
    if x.dim() != 3 or x.shape[1] != N_LIMBS:
        raise ValueError(f"expected columns [C, 16, n], got {tuple(x.shape)}")
    C, _, n = x.shape
    if n < 2 or n > NTT_SMALL_MAX or n & (n - 1):
        raise ValueError(f"transform length {n} is not a power of two in [2, {NTT_SMALL_MAX}]")
    if tuple(tw.shape) != (N_LIMBS, n // 2):
        raise ValueError(f"twiddles {tuple(tw.shape)} != {(N_LIMBS, n // 2)}")
    if pre is not None and tuple(pre.shape) != (N_LIMBS, n):
        raise ValueError(f"pre diagonal {tuple(pre.shape)} != {(N_LIMBS, n)}")
    if post is not None and tuple(post.shape) not in ((N_LIMBS, n), (N_LIMBS, 1)):
        raise ValueError(f"post diagonal {tuple(post.shape)} is neither [16, {n}] nor [16, 1]")
    if _on_cpu(*ts):
        return ntt_small_plain(fid, x, tw, pre, post)
    xc, twc = x.contiguous(), tw.contiguous()
    prc = None if pre is None else pre.contiguous()
    poc = None if post is None else post.contiguous()
    out = torch.empty_like(xc)
    if C == 0:
        return out
    rc = _lib().h2_ntt_small(
        fid, _ptr(xc), _ptr(twc), None if prc is None else _ptr(prc),
        None if poc is None else _ptr(poc), 0 if poc is None else poc.shape[1], _ptr(out), C, n,
        _stream(out),
    )
    _check_rc(rc, "ntt_small")
    _count("ntt_small", C * n * (n.bit_length() - 1),
           (tuple(xc.shape), pre is not None, 0 if post is None else post.shape[1]))
    return out


# largest sub-transform the kernel holds in one block's shared memory
COLNTT_MAX_A = 1024


def colntt(fid: int, x, tw, mid=None):
    """All log2(A) radix-2 Stockham DIF stages of the length-A transforms
    along axis 1 of x int32[L, A, 16, B] (natural order in and out), with the
    four-step diagonal twiddle mid [A, 16, B] multiplied into the result when
    given. tw: [16, A/2] Montgomery powers 1, w, ..., w^(A/2-1) of the A-th
    root of unity. A is a power of two in [2, 1024]."""
    ts = (x, tw) if mid is None else (x, tw, mid)
    if x.dim() != 4 or x.shape[2] != N_LIMBS:
        raise ValueError(f"expected columns [L, A, 16, B], got {tuple(x.shape)}")
    L, A, _, B = x.shape
    if A < 2 or A > COLNTT_MAX_A or A & (A - 1):
        raise ValueError(f"sub-transform length {A} is not a power of two in [2, {COLNTT_MAX_A}]")
    if tuple(tw.shape) != (N_LIMBS, A // 2):
        raise ValueError(f"stage twiddles {tuple(tw.shape)} != {(N_LIMBS, A // 2)}")
    if mid is not None and tuple(mid.shape) != (A, N_LIMBS, B):
        raise ValueError(f"mid twiddles {tuple(mid.shape)} != {(A, N_LIMBS, B)}")
    if A * N_LIMBS * B >= 1 << 31:
        raise ValueError(f"one column set [{A}, 16, {B}] exceeds the kernel's 32-bit offsets")
    if _on_cpu(*ts):
        return colntt_plain(fid, x, tw, mid)
    xc, twc = x.contiguous(), tw.contiguous()
    mc = None if mid is None else mid.contiguous()
    out = torch.empty_like(xc)
    if L * B == 0:
        return out
    rc = _lib().h2_colntt(
        fid, _ptr(xc), _ptr(twc), None if mc is None else _ptr(mc), _ptr(out), L, A, B,
        _stream(out),
    )
    _check_rc(rc, "colntt")
    _count("colntt", L * B * A * (A.bit_length() - 1), (tuple(xc.shape), mid is not None))
    return out


def _points(ts, shape):
    for t in ts:
        _check_limbs(t)
    return [t.expand(shape).contiguous() for t in ts]


def ec_add(P1, P2):
    """Complete Jacobian add over Fq of coordinate triples [..., 16, B]."""
    if _on_cpu(*P1, *P2):
        return ec_add_plain(P1, P2)
    shape = _broadcast(*(t.shape for t in (*P1, *P2)))
    ins = _points((*P1, *P2), shape)
    outs = [torch.empty(shape, dtype=torch.int32, device=ins[0].device) for _ in range(3)]
    L, B = _prod(shape[:-2]), shape[-1]
    if L * B == 0:
        return tuple(outs)
    rc = _lib().h2_ec_add(*map(_ptr, ins), *map(_ptr, outs), L, B, _stream(outs[0]))
    _check_rc(rc, "ec_add")
    _count("ec_add", L * B, (tuple(shape),))
    return tuple(outs)


def ec_double(P):
    """Jacobian doubling (dbl-2009-l, a = 0) over Fq."""
    if _on_cpu(*P):
        return ec_double_plain(P)
    shape = _broadcast(*(t.shape for t in P))
    ins = _points(P, shape)
    outs = [torch.empty(shape, dtype=torch.int32, device=ins[0].device) for _ in range(3)]
    L, B = _prod(shape[:-2]), shape[-1]
    if L * B == 0:
        return tuple(outs)
    rc = _lib().h2_ec_double(*map(_ptr, ins), *map(_ptr, outs), L, B, _stream(outs[0]))
    _check_rc(rc, "ec_double")
    _count("ec_double", L * B, (tuple(shape),))
    return tuple(outs)


def ec_madd(P1, A2, distinct: bool):
    """Mixed add over Fq: Jacobian P1 (X, Y, Z) + affine A2 (x, y), (0, 0)
    the affine identity, all [..., 16, B] and broadcastable; the affine pair
    may be one [16, B] row set shared by every row of P1. `distinct=True`
    drops the doubling branch: sound only when no accumulator can equal its
    base (SRS bases)."""
    if _on_cpu(*P1, *A2):
        return ec_madd_plain(P1, A2, distinct)
    if A2[0].shape != A2[1].shape:
        raise ValueError(f"affine x {tuple(A2[0].shape)} and y {tuple(A2[1].shape)} differ")
    shape = _broadcast(*(t.shape for t in (*P1, *A2)))
    ins = _points(P1, shape)
    (ax, La, Ba), (ay, _, _) = (_operand(t, shape) for t in A2)
    outs = [torch.empty(shape, dtype=torch.int32, device=ins[0].device) for _ in range(3)]
    L, B = _prod(shape[:-2]), shape[-1]
    if L * B == 0:
        return tuple(outs)
    rc = _lib().h2_ec_madd(
        *map(_ptr, ins), _ptr(ax), _ptr(ay), La, Ba, *map(_ptr, outs), L, B, int(distinct),
        _stream(outs[0]),
    )
    _check_rc(rc, "ec_madd")
    _count("ec_madd", L * B, (tuple(shape), tuple(ax.shape), bool(distinct)))
    return tuple(outs)


def bucket_scan(axy, seg_start, distinct: bool):
    """Inclusive segmented mixed-add scan for the MSM bucket accumulation.

    axy: int32[Wb, R, 16, CL] bucket-sorted affine bases, Montgomery, packed
    two 16-bit limbs per int32 (row j = limbs j | j+8 << 16; x rows 0-7, y
    rows 8-15; (0, 0) = dead slot); chain (w, lane) visits [w, r, :, lane] for
    r = 0..R-1. seg_start: int32[Wb, R, CL], nonzero where a bucket run
    starts. Returns int32[Wb, R, 48, CL]: the chain's running sum (x | y | z
    limb rows) after each step."""
    if axy.dim() != 4 or axy.shape[2] != N_LIMBS:
        raise ValueError(f"expected packed bases [Wb, R, 16, CL], got {tuple(axy.shape)}")
    Wb, R, _, CL = axy.shape
    if tuple(seg_start.shape) != (Wb, R, CL):
        raise ValueError(f"seg_start {tuple(seg_start.shape)} != {(Wb, R, CL)}")
    if _on_cpu(axy, seg_start):
        return bucket_scan_plain(axy, seg_start, distinct)
    a, s = axy.contiguous(), seg_start.contiguous()
    out = torch.empty((Wb, R, 3 * N_LIMBS, CL), dtype=torch.int32, device=a.device)
    if Wb * R * CL == 0:
        return out
    rc = _lib().h2_bucket_scan(_ptr(a), _ptr(s), _ptr(out), Wb, R, CL, int(distinct), _stream(a))
    _check_rc(rc, "bucket_scan")
    _count("bucket_scan", Wb * R * CL, (tuple(a.shape), bool(distinct)))
    return out


# largest lane count bucket_sums_fused takes on the card (its carry scan
# holds two [lanes] point buffers in one block's shared memory)
BUCKET_MAX_LANES = 1024


def bucket_sums_fused(bases, order, digits, lanes: int, nbuckets: int, distinct: bool):
    """Pippenger bucket sums of Wtot windows straight from the sorted digits.

    bases: int32[npts, 16] affine bases, point-major words (pack_bases);
    digits: int32[Wtot, n], each window's digits sorted ascending; order:
    int32[Wtot, n], the base index of each sorted slot. Window w's slots are
    `lanes` lanes of R = n / lanes consecutive slots; the mixed-add chains,
    the segmented scan of the lanes' carries and the carried buckets' adds run
    in the order of the bucket_scan composition they replace (see
    ops/ec_device.py), so the sums are the same Jacobian triples. Returns
    (X, Y, Z), each int32[Wtot, 16, nbuckets], bucket b at slot b - 1, Z = 0
    where a window has no digit b. `distinct=True` drops the mixed add's
    doubling branch (sound for SRS bases). Two launches on the card: the
    chains (one thread per (window, lane)), then the carries (one block per
    window)."""
    if digits.dim() != 2 or tuple(order.shape) != tuple(digits.shape):
        raise ValueError(f"order {tuple(order.shape)} and digits {tuple(digits.shape)} differ")
    if bases.dim() != 2 or bases.shape[1] != N_LIMBS:
        raise ValueError(f"expected point-major bases [npts, 16], got {tuple(bases.shape)}")
    Wtot, n = digits.shape
    if lanes < 1 or lanes & (lanes - 1) or n % lanes:
        raise ValueError(f"lanes {lanes} is not a power of two dividing n = {n}")
    if _on_cpu(bases, order, digits):
        return bucket_sums_fused_plain(bases, order, digits, lanes, nbuckets, distinct)
    if lanes > BUCKET_MAX_LANES:
        raise ValueError(f"lanes {lanes} > {BUCKET_MAX_LANES}")
    b, o, d = bases.contiguous(), order.contiguous(), digits.contiguous()
    outs = [torch.empty((Wtot, N_LIMBS, nbuckets), dtype=torch.int32, device=d.device)
            for _ in range(3)]
    if Wtot * n * nbuckets == 0:
        return tuple(outs)
    tail = torch.empty((Wtot, 3 * N_LIMBS, lanes), dtype=torch.int32, device=d.device)
    rc = _lib().h2_bucket_sums(
        _ptr(b), _ptr(o), _ptr(d), *map(_ptr, outs), _ptr(tail), Wtot, n, lanes, nbuckets,
        int(distinct), _stream(d),
    )
    _check_rc(rc, "bucket_sums_fused")
    _count("bucket_sums_fused", Wtot * n, ((Wtot, n), tuple(b.shape), lanes, nbuckets, bool(distinct)))
    return tuple(outs)


def mul_chain_bench(a, b, iters: int, chains: bool):
    """Measurement only (not a kernel of the port's path): `iters` dependent
    Fq Montgomery products a <- a * b per lane of [16, B] CUDA tensors, with
    the carry-chain product (chains=True) or the 64-bit C one it replaced."""
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    rc = _lib().h2_mul_chain(int(chains), _ptr(a), _ptr(b), _ptr(out), a.shape[-1], iters,
                             _stream(a))
    _check_rc(rc, "mul_chain")
    return out


# largest lane block bucket_weight takes on the card (one thread per lane)
BUCKET_WEIGHT_MAX_LANES = 256


def bucket_weight(S, lanes: int):
    """Weighted bucket reduction of Pippenger windows, T_w = sum_b b * S_{w,b}.

    S: bucket sums (X, Y, Z), each int32[Wtot, 16, nbuckets], bucket b at slot
    b - 1 (identity Z == 0). lanes: CL2, a power of two, the width of the
    merged-lane blocks (one thread each on the card, at most
    BUCKET_WEIGHT_MAX_LANES). Returns (X, Y, Z), each int32[16, Wtot]:
    the point ops of bucket_weight_plain in its order, so the same Jacobian
    coordinates.

    One launch replaces the lax.scan of _ec_add_kernel calls and the
    suffix-scan, D and doubling steps of halo2_lib_tpu/ops/ec_device.py:624-674
    (46 ec_add and 6 ec_double launches per MSM at CL2 = 64): one block per
    window, the row chain in registers, the scans in shared memory. Bound by
    each lane's serial chain of 2 * R2 + 3 log2(CL2) complete adds."""
    if len({tuple(t.shape) for t in S}) != 1 or S[0].dim() != 3 or S[0].shape[1] != N_LIMBS:
        raise ValueError(f"expected three [Wtot, 16, nb] tensors, got {[t.shape for t in S]}")
    if lanes < 1 or lanes & (lanes - 1):
        raise ValueError(f"lanes {lanes} is not a power of two")
    if _on_cpu(*S):
        return bucket_weight_plain(S, lanes)
    if lanes > BUCKET_WEIGHT_MAX_LANES:
        raise ValueError(f"lanes {lanes} > {BUCKET_WEIGHT_MAX_LANES}")
    Wtot, _, nb = S[0].shape
    ins = [t.contiguous() for t in S]
    outs = [torch.empty((N_LIMBS, Wtot), dtype=torch.int32, device=ins[0].device) for _ in range(3)]
    if Wtot == 0:
        return tuple(outs)
    rc = _lib().h2_bucket_weight(
        *map(_ptr, ins), *map(_ptr, outs), Wtot, nb, lanes, _stream(outs[0])
    )
    _check_rc(rc, "bucket_weight")
    _count("bucket_weight", Wtot * nb, ((Wtot, N_LIMBS, nb), lanes))
    return tuple(outs)


def msm_combine(T, windows: int, window_bits: int):
    """Window combine of a Pippenger MSM: res = 2^c * res + T_w for w = W - 1
    down to 0 (c = window_bits, W = windows), res starting at the identity.

    T: window sums (X, Y, Z), each int32[16, C * W], lane = column * W + w.
    Returns (X, Y, Z), each int32[16, C].

    One launch replaces the window_step scan of _ec_double_kernel and
    _ec_add_kernel calls at halo2_lib_tpu/ops/ec_device.py:676-688 (W * c
    doublings and W adds, 286 launches at W = 26, c = 10): one thread per
    column with res in registers. Bound by that serial chain (about 2400
    dependent Montgomery products), not by bytes or total operations."""
    if len({tuple(t.shape) for t in T}) != 1 or T[0].dim() != 2 or T[0].shape[0] != N_LIMBS:
        raise ValueError(f"expected three [16, C * W] tensors, got {[t.shape for t in T]}")
    if windows < 1 or T[0].shape[1] % windows:
        raise ValueError(f"{T[0].shape[1]} lanes are not C x {windows} windows")
    if _on_cpu(*T):
        return msm_combine_plain(T, windows, window_bits)
    C = T[0].shape[1] // windows
    ins = [t.contiguous() for t in T]
    outs = [torch.empty((N_LIMBS, C), dtype=torch.int32, device=ins[0].device) for _ in range(3)]
    if C == 0:
        return tuple(outs)
    rc = _lib().h2_msm_combine(
        *map(_ptr, ins), *map(_ptr, outs), C, windows, window_bits, _stream(outs[0])
    )
    _check_rc(rc, "msm_combine")
    _count("msm_combine", C * windows * window_bits, ((N_LIMBS, C * windows), windows, window_bits))
    return tuple(outs)


# longest column commit_dbl_add takes on the card (its lane tree holds a
# column's points in one block's shared memory)
COMMIT_MAX_LANES = 2048


def commit_dbl_add(scalars, Ax, Ay):
    """Small-column MSM by double-and-add: sum_e scalars[i, e] * A_e for each
    column i.

    scalars: int32[C, 16, m] canonical (not Montgomery) Fr scalars; (Ax, Ay):
    int32[16, n] Montgomery affine bases (n >= m, the first m used, shared by
    the C columns; (0, 0) = identity). Returns Jacobian (X, Y, Z), each
    int32[16, C]: the point ops of halo2_lib_tpu/backend/kzg.py:499-519 in
    their order (per lane, for bit 253 down to 0, a doubling and, where the
    bit is 1, the mixed add with its doubling branch; then the lanes'
    halving tree), so the same Jacobian triples as the per-bit composition
    of ec_double, ec_madd and ec_add launches it replaces.

    On the card, two launches: the chains (one thread per (column, lane), the
    accumulator in registers, the mixed add only where the bit is 1), then
    the tree (one block per column, its m lane sums in shared memory; m <=
    COMMIT_MAX_LANES). Bound by one thread's chain: 254 doublings of 7
    Montgomery products and a mixed add of 11 per set bit."""
    if scalars.dim() != 3 or scalars.shape[1] != N_LIMBS or scalars.shape[2] < 1:
        raise ValueError(f"expected scalars [C, 16, m >= 1], got {tuple(scalars.shape)}")
    C, _, m = scalars.shape
    if Ax.shape != Ay.shape or Ax.dim() != 2 or Ax.shape[0] != N_LIMBS or Ax.shape[1] < m:
        raise ValueError(f"bases {tuple(Ax.shape)}, {tuple(Ay.shape)} are not [16, n >= {m}]")
    if _on_cpu(scalars, Ax, Ay):
        return commit_dbl_add_plain(scalars, Ax, Ay)
    if m > COMMIT_MAX_LANES:
        raise ValueError(f"column length {m} > {COMMIT_MAX_LANES}")
    sc, ax, ay = scalars.contiguous(), Ax.contiguous(), Ay.contiguous()
    outs = [torch.empty((N_LIMBS, C), dtype=torch.int32, device=sc.device) for _ in range(3)]
    if C == 0:
        return tuple(outs)
    scratch = torch.empty((3, C, N_LIMBS, m), dtype=torch.int32, device=sc.device)
    rc = _lib().h2_commit_dbl_add(
        _ptr(sc), _ptr(ax), _ptr(ay), ax.shape[1], _ptr(scratch), *map(_ptr, outs), C, m,
        _stream(sc),
    )
    _check_rc(rc, "commit_dbl_add")
    _count("commit_dbl_add", C * m, (tuple(sc.shape), tuple(ax.shape)))
    return tuple(outs)
