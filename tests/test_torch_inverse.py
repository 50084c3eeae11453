"""A model of the card's field inversion (halo2_lib_tpu_torch/csrc/
fermat_kernel.cu), which the CPU cannot run, held to Fermat's inverse.

The kernel computes fermat_inv's function, the Montgomery-form inverse of a
stored value x (x^(p-2) in Montgomery arithmetic, that is x^-1 R^2 mod p, 0
for 0), by the variable-time safegcd of Bernstein and Yang: batches of 30
divsteps on the low 32 bits of (f, g), then the batch's 2x2 matrix applied
to the nine signed 30-bit limbs of (f, g) and, modulo p, of (d, e). The
model below is that iteration step for step, at the kernel's word sizes:
uint32 for the divsteps' f, g and matrix entries (wrapped as the kernel's
arithmetic wraps them), int32 limbs and int64 accumulators, each range
asserted where the kernel would overflow. It is held, on both bn254 fields,
to pow(x, p - 2, p) R^2 and to fermat_inv_plain (the kernel's plain version,
which chip_smoke.py and tests/test_torch_cuda.py hold the kernel to on the
card), on 0, 1, p - 1, R mod p, 2^-1, powers of two, random values and the
inputs that took the most divsteps in a search of 300,000 random inputs and
a bit-flip hill climb from the worst of them (559 divsteps on Fr, 565 on
Fq: 19 batches; theory bounds them at 741, 25 batches).
"""

import numpy as np
import pytest
import torch

from halo2_lib_tpu_torch.ops import cuda_field as cf
from halo2_lib_tpu_torch.ops.limbs import ints_to_limbs_T, limbs_to_ints
from halo2_lib_tpu_torch.utils.fields import FQ_BN254, FR_BN254

# One core per test process: the suite runs in parallel workers, and a
# thread pool per worker would oversubscribe the host.
torch.set_num_threads(1)

U32 = (1 << 32) - 1
M30 = (1 << 30) - 1
BATCH = 30
MAX_BATCHES = 25
PRIMES = {cf.FR: FR_BN254.p, cf.FQ: FQ_BN254.p}
# (input, divsteps) that needed the most divsteps in the search above
WORST = {
    cf.FR: (0x2F97723DFD1D61AAFC3A9797DC62BB9A853591C7AE8F3C092D5B1D5348917FBC, 559),
    cf.FQ: (0x2CC594C9275B6067BD6F54ED6B541F8E5D0FB01457653FD2974635A4FC2D8423, 565),
}


def _s32(x: int) -> int:
    x &= U32
    return x - (1 << 32) if x >> 31 else x


def _fits(x: int, bits: int) -> int:
    assert -(1 << (bits - 1)) <= x < 1 << (bits - 1), (x, bits)
    return x


def limbs30(x: int) -> list[int]:
    return [(x >> (30 * i)) & M30 for i in range(8)] + [x >> 240]


def value30(v: list[int]) -> int:
    return sum(limb << (30 * i) for i, limb in enumerate(v))


def divsteps(eta: int, f0: int, g0: int):
    """The kernel's divsteps(): 30 divsteps on the low 32 bits of f, g."""
    u, v, q, r = 1, 0, 0, 1
    f, g = f0 & U32, g0 & U32
    i = BATCH
    while True:
        sentinel = g | ((U32 << i) & U32)
        zeros = (sentinel & -sentinel).bit_length() - 1
        g >>= zeros
        u, v = (u << zeros) & U32, (v << zeros) & U32
        eta -= zeros
        i -= zeros
        if i == 0:
            break
        if eta < 0:
            eta = -eta
            f, g = g, -f & U32
            u, q = q, -u & U32
            v, r = r, -v & U32
        limit = min(eta + 1, i)
        m = (U32 >> (32 - limit)) & 63
        w = (f * g * ((f * f - 2) & U32)) & m
        g = (g + f * w) & U32
        q = (q + u * w) & U32
        r = (r + v * w) & U32
    return _fits(eta, 32), (_s32(u), _s32(v), _s32(q), _s32(r))


def update_de(d, e, t, P, inv30):
    """The kernel's update_de(): (t [d, e] + p [md, me]) / 2^30."""
    u, v, q, r = t
    sd, se = -(d[8] < 0), -(e[8] < 0)
    md, me = (u & sd) + (v & se), (q & sd) + (r & se)
    cd, ce = _fits(u * d[0] + v * e[0], 64), _fits(q * d[0] + r * e[0], 64)
    md = _fits(md - ((inv30 * (cd & U32) + md) & M30), 32)
    me = _fits(me - ((inv30 * (ce & U32) + me) & M30), 32)
    cd, ce = _fits(cd + P[0] * md, 64), _fits(ce + P[0] * me, 64)
    assert cd & M30 == 0 and ce & M30 == 0
    cd, ce = cd >> 30, ce >> 30
    nd, ne = [0] * 9, [0] * 9
    for i in range(1, 9):
        cd = _fits(cd + u * d[i] + v * e[i] + P[i] * md, 64)
        ce = _fits(ce + q * d[i] + r * e[i] + P[i] * me, 64)
        nd[i - 1], ne[i - 1] = cd & M30, ce & M30
        cd, ce = cd >> 30, ce >> 30
    nd[8], ne[8] = _fits(cd, 32), _fits(ce, 32)
    return nd, ne


def update_fg(f, g, t):
    """The kernel's update_fg(): t [f, g] / 2^30, exact."""
    u, v, q, r = t
    cf_, cg = _fits(u * f[0] + v * g[0], 64), _fits(q * f[0] + r * g[0], 64)
    assert cf_ & M30 == 0 and cg & M30 == 0
    cf_, cg = cf_ >> 30, cg >> 30
    nf, ng = [0] * 9, [0] * 9
    for i in range(1, 9):
        cf_ = _fits(cf_ + u * f[i] + v * g[i], 64)
        cg = _fits(cg + q * f[i] + r * g[i], 64)
        nf[i - 1], ng[i - 1] = cf_ & M30, cg & M30
        cf_, cg = cf_ >> 30, cg >> 30
    nf[8], ng[8] = _fits(cf_, 32), _fits(cg, 32)
    return nf, ng


def normalize(d, sign, P):
    """The kernel's normalize(): d in (-2p, p) -> sign(f) d in [0, p)."""
    c = -(d[8] < 0)
    d = [x + (p & c) for x, p in zip(d, P)]
    neg = -(sign < 0)
    d = [(x ^ neg) - neg for x in d]
    for i in range(8):
        d[i + 1] += d[i] >> 30
        d[i] &= M30
    c = -(d[8] < 0)
    d = [x + (p & c) for x, p in zip(d, P)]
    for i in range(8):
        d[i + 1] += d[i] >> 30
        d[i] &= M30
    return d


def inverse_model(x: int, p: int):
    """The kernel's inverse_k on one stored value x < p: (x^-1 R^2 mod p, 0
    for 0; the number of batches it ran)."""
    P = limbs30(p)
    inv30 = pow(p, -1, 1 << 30)
    f, g, d, e = P, limbs30(x), [0] * 9, limbs30((1 << 512) % p)
    eta = -1
    for batches in range(1, MAX_BATCHES + 1):
        eta, t = divsteps(eta, f[0], g[0])
        d, e = update_de(d, e, t, P, inv30)
        f, g = update_fg(f, g, t)
        if not any(g):
            break
    else:
        raise AssertionError(f"g != 0 after {MAX_BATCHES} batches")
    assert x == 0 or value30(f) in (1, -1)
    d = normalize(d, f[8], P)
    assert all(0 <= limb <= M30 for limb in d)
    return value30(d), batches


def count_divsteps(x: int, p: int) -> int:
    """Divsteps until g = 0, one at a time on whole integers (eta = -delta
    from -1, as the kernel starts)."""
    eta, f, g, n = -1, p, x, 0
    while g:
        if g & 1:
            if eta < 0:
                eta, f, g = -eta, g, -f
            g += f
        g >>= 1
        eta -= 1
        n += 1
    return n


def _inputs(fid: int) -> list[int]:
    p = PRIMES[fid]
    rng = np.random.default_rng(50 + fid)
    words = rng.integers(0, 1 << 62, size=(24, 5), dtype=np.int64)
    rand = [sum(int(w) << (62 * i) for i, w in enumerate(row)) % p for row in words]
    special = [0, 1, p - 1, (1 << 256) % p, pow(2, -1, p), WORST[fid][0]]
    return special + [1 << k for k in range(0, 254, 11)] + rand


@pytest.mark.parametrize("fid", [cf.FR, cf.FQ])
def test_inverse_model_is_fermat(fid):
    p = PRIMES[fid]
    r2 = (1 << 512) % p
    for x in _inputs(fid):
        got, batches = inverse_model(x, p)
        assert got == (0 if x == 0 else pow(x, p - 2, p) * r2 % p), hex(x)
        assert batches == (1 if x == 0 else -(-count_divsteps(x, p) // BATCH))


@pytest.mark.parametrize("fid", [cf.FR, cf.FQ])
def test_inverse_model_worst_input(fid):
    x, steps = WORST[fid]
    assert count_divsteps(x, PRIMES[fid]) == steps
    assert inverse_model(x, PRIMES[fid])[1] == 19


@pytest.mark.parametrize("fid", [cf.FR, cf.FQ])
def test_inverse_model_equals_fermat_inv_plain(fid):
    """The model against the plain version the kernel is held to on the
    card, limb for limb."""
    p = PRIMES[fid]
    xs = _inputs(fid)
    plain = cf.fermat_inv_plain(fid, torch.from_numpy(ints_to_limbs_T(xs)).to(torch.int32))
    assert limbs_to_ints(plain.T.numpy()) == [inverse_model(x, p)[0] for x in xs]
