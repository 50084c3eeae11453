"""bn254 Fr vectors in plain PyTorch: Montgomery form (R = 2^256) on sixteen
16-bit limbs, low first, held in int64 tensors [N, 16].

Word-serial Montgomery multiplication with 16-bit words: the 32 limbs of the
product are summed in int64 (at most 16 products below 2^32 a limb), then
each of 16 steps adds m p, m chosen so that the lowest live limb becomes 0
mod 2^16, and carries it up; the 17 limbs left are normalised and p is
subtracted once if they reach it. Every entry stays below 2^38. Vectors
of powers and batch inverses are built by doubling and by a product tree,
a few tensor operations a level, so a vector of 2^22 elements takes well
under a second on the card. On the CPU the same code checks itself against
Python ints.
"""

from __future__ import annotations

import numpy as np
import torch

from .halo2.fields import FR_BN254

LIMBS = 16
MASK = 0xFFFF


def _limbs(v: int) -> list[int]:
    return [(v >> (16 * i)) & MASK for i in range(LIMBS)]


class FrTorch:
    def __init__(self, device):
        self.device = torch.device(device)
        self.p_int = FR_BN254.p
        self.r_int = (1 << 256) % self.p_int
        self.p = torch.tensor(_limbs(self.p_int), dtype=torch.int64, device=self.device)
        self.pinv = (-pow(self.p_int, -1, 1 << 16)) % (1 << 16)

    # --- conversions ------------------------------------------------------------------
    def from_ints(self, values) -> torch.Tensor:
        """Python ints -> [N, 16] limbs in Montgomery form."""
        p = self.p_int
        vals = [(int(v) % p) * self.r_int % p for v in values]
        raw = b"".join(v.to_bytes(32, "little") for v in vals)
        arr = np.frombuffer(raw, dtype="<u2").reshape(-1, LIMBS).astype(np.int64)
        return torch.from_numpy(arr).to(self.device)

    def to_ints(self, a: torch.Tensor) -> list[int]:
        """[N, 16] Montgomery limbs -> Python ints."""
        raw = np.ascontiguousarray(a.cpu().numpy().astype("<u2")).tobytes()
        vals = [int.from_bytes(raw[i : i + 32], "little") for i in range(0, len(raw), 32)]
        rinv = pow(self.r_int, -1, self.p_int)
        return [v * rinv % self.p_int for v in vals]

    def const(self, v: int, n: int = 1) -> torch.Tensor:
        return self.from_ints([v])[0].expand(n, LIMBS).contiguous()

    # --- arithmetic -------------------------------------------------------------------
    def _reduce_once(self, r: torch.Tensor) -> torch.Tensor:
        """[N, 17] normalised limbs of a value below 2p -> [N, 16] below p."""
        s = r.clone()
        s[:, :LIMBS] -= self.p
        for i in range(LIMBS):
            borrow = (s[:, i] < 0).to(torch.int64)
            s[:, i] += borrow << 16
            s[:, i + 1] -= borrow
        keep = (s[:, LIMBS] < 0)[:, None]
        return torch.where(keep, r[:, :LIMBS], s[:, :LIMBS])

    def _normalise(self, t: torch.Tensor) -> torch.Tensor:
        for i in range(t.shape[1] - 1):
            t[:, i + 1] += t[:, i] >> 16
            t[:, i] &= MASK
        return t

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a b / R mod p, elementwise ([N, 16] or a [1, 16] broadcast)."""
        N = max(a.shape[0], b.shape[0])
        t = torch.zeros((N, 2 * LIMBS + 2), dtype=torch.int64, device=self.device)
        for i in range(LIMBS):
            t[:, i : i + LIMBS] += a[:, i : i + 1] * b
        for i in range(LIMBS):
            m = ((t[:, i] & MASK) * self.pinv) & MASK
            t[:, i : i + LIMBS] += m[:, None] * self.p
            t[:, i + 1] += t[:, i] >> 16
        r = self._normalise(t[:, LIMBS:].contiguous())
        return self._reduce_once(r[:, : LIMBS + 1])

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        N = max(a.shape[0], b.shape[0])
        t = torch.zeros((N, LIMBS + 1), dtype=torch.int64, device=self.device)
        t[:, :LIMBS] = a + b
        return self._reduce_once(self._normalise(t))

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a - b mod p: a + (p - b)."""
        N = max(a.shape[0], b.shape[0])
        neg = torch.zeros((N, LIMBS + 1), dtype=torch.int64, device=self.device)
        neg[:, :LIMBS] = self.p - b
        for i in range(LIMBS):
            borrow = (neg[:, i] < 0).to(torch.int64)
            neg[:, i] += borrow << 16
            neg[:, i + 1] -= borrow
        return self.add(a, self._reduce_once(neg))

    def powers(self, base: int, n: int) -> torch.Tensor:
        """[n, 16]: 1, base, ..., base^(n-1) in Montgomery form."""
        out = self.const(1)
        step = base % self.p_int
        while out.shape[0] < n:
            out = torch.cat([out, self.mul(out, self.const(step))])
            step = step * step % self.p_int
        return out[:n].contiguous()

    def batch_inverse(self, a: torch.Tensor) -> torch.Tensor:
        """Elementwise inverses (no element 0) by a product tree."""
        levels = [a]
        cur = a
        one = self.const(1)
        while cur.shape[0] > 1:
            if cur.shape[0] % 2:
                cur = torch.cat([cur, one])
            cur = self.mul(cur[0::2], cur[1::2])
            levels.append(cur)
        inv = self.from_ints([pow(self.to_ints(cur)[0], -1, self.p_int)])
        for lev in reversed(levels[:-1]):
            L = lev.shape[0]
            pairs = L // 2
            out = torch.empty_like(lev)
            out[0 : 2 * pairs : 2] = self.mul(inv[:pairs], lev[1 : 2 * pairs : 2])
            out[1 : 2 * pairs : 2] = self.mul(inv[:pairs], lev[0 : 2 * pairs : 2])
            if L % 2:
                out[L - 1] = inv[pairs]
            inv = out
        return inv

    def canonical_limbs(self, a: torch.Tensor) -> np.ndarray:
        """Montgomery [N, 16] -> float64 [N, 16] limbs of the plain values,
        on the host (weights for ``fr_vec.limb_dot``)."""
        plain = self.mul(a, torch.tensor([[1] + [0] * (LIMBS - 1)], dtype=torch.int64, device=self.device))
        return plain.cpu().numpy().astype(np.float64)
