"""Row-sharded column tensors: the layout of the prover over a mesh.

The prover's columns are limb-major ``int32[..., 16, N]`` tensors
(ops/limbs.py) whose last axis is the row. Over a mesh of S shards a column
tensor is a ``Rows``: S parts of equal length, part s holding rows
[s N/S, (s+1) N/S) on the mesh's device s. It is the counterpart of the JAX
prover's row sharding (``halo2_lib_tpu/backend/prover.py`` ``_row_sharder``:
a ``PartitionSpec`` with the mesh axis on the row axis), where XLA inserts
the collectives. Here they are written out:

* work that is element-wise in the rows runs per shard on the shard's
  device (``RowsField``; the batch inversion too, whose result is
  element-wise);
* a rotation takes a halo of rows from the neighbouring shards (``roll``);
* the prefix product scans each shard and carries across shards
  (``RowsField.prefix_prod``);
* a lane sum adds per-shard partial sums (``sum_lanes``);
* row slices, padding and the quotient's pieces move rows between shards
  as device-to-device copies (``take``, ``put``, ``pad``, ``pieces``).

``RowLayout`` is one interface over both kinds: with no mesh it runs the
plain torch calls on one device (the single-device prover); over a mesh it
takes and returns ``Rows``. Every value is a canonical field element, so the
order in which shards compute changes no byte of a proof.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.limbs import N_LIMBS, to_device


class Rows:
    """A limb-major tensor [..., 16, N] split on its row axis into equal
    contiguous parts, one per mesh shard (see the module docstring). Leading
    (column) axes index, reshape and transpose like a tensor's."""

    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = list(parts)

    @property
    def shape(self) -> torch.Size:
        p = self.parts[0]
        return torch.Size(tuple(p.shape[:-1]) + (p.shape[-1] * len(self.parts),))

    def dim(self) -> int:
        return self.parts[0].dim()

    def __getitem__(self, key):
        keys = key if isinstance(key, tuple) else (key,)
        if any(k is Ellipsis for k in keys) or sum(k is not None for k in keys) > self.dim() - 2:
            raise IndexError("Rows index their leading (column) axes only; rows move by RowLayout")
        return Rows([p[key] for p in self.parts])

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list, torch.Size)):
            shape = tuple(shape[0])
        if tuple(shape[-2:]) != (N_LIMBS, self.shape[-1]):
            raise ValueError(f"a Rows reshape keeps the [16, {self.shape[-1]}] tail, got {shape}")
        m = self.parts[0].shape[-1]
        return Rows([p.reshape(tuple(shape[:-1]) + (m,)) for p in self.parts])

    def transpose(self, a: int, b: int):
        nd = self.dim()
        if max(a % nd, b % nd) >= nd - 2:
            raise ValueError("a Rows transpose swaps leading (column) axes only")
        return Rows([p.transpose(a, b) for p in self.parts])


def _local(a, s: int, dev):
    """Shard s's operand: its part of a Rows; a plain tensor, which must not
    hold rows (a scalar, [..., 16, 1], or a mask of one row), on its device."""
    if isinstance(a, Rows):
        return a.parts[s]
    if isinstance(a, torch.Tensor):
        if a.dim() >= 1 and a.shape[-1] != 1:
            raise ValueError(f"a plain tensor {tuple(a.shape)} beside Rows: shard it first")
        return a.to(dev)
    return a


def per_shard(fn, *args):
    """fn on each shard's operands (see _local); a result (or each member of
    a tuple result) comes back as Rows. Without a Rows operand, fn(*args)."""
    rows = next((a for a in args if isinstance(a, Rows)), None)
    if rows is None:
        return fn(*args)
    outs = [fn(*(_local(a, s, p.device) for a in args)) for s, p in enumerate(rows.parts)]
    if isinstance(outs[0], tuple):
        return tuple(Rows(o) for o in zip(*outs))
    return Rows(outs)


class RowsField:
    """A DeviceField whose ring operations also take Rows: per shard on each
    shard's device, with scalar operands copied there. ``prefix_prod`` is the
    cross-shard scan; every other attribute is the DeviceField's."""

    _PER_SHARD = frozenset({"_add", "_sub", "_mont_mul", "_from_mont", "_batch_inv"})

    def __init__(self, df):
        self.df = df

    def __getattr__(self, name):
        attr = getattr(self.df, name)
        if name in self._PER_SHARD:
            return lambda *args: per_shard(attr, *args)
        return attr

    def prefix_prod(self, x):
        """Inclusive prefix product along the rows: each shard scans its own
        rows (DeviceField.prefix_prod), then shard s > 0 multiplies in the
        product of every row before it, carried across the shards on the
        first shard's device."""
        df = self.df
        if not isinstance(x, Rows):
            return df.prefix_prod(x)
        local = [df.prefix_prod(p) for p in x.parts]
        dev0 = local[0].device
        out = [local[0]]
        carry = local[0][..., -1:]
        for s in range(1, len(local)):
            out.append(df._mont_mul(local[s], carry.to(local[s].device)))
            if s + 1 < len(local):
                carry = df._mont_mul(carry, local[s][..., -1:].to(dev0))
        return Rows(out)


def tree_sum_lanes(df, t):
    """Field sum along the lane axis of [..., 16, B] -> [..., 16, 1]
    (log-depth halving)."""
    s = t
    while s.shape[-1] > 1:
        half = s.shape[-1] // 2
        red = df._add(s[..., :half], s[..., half : 2 * half])
        if s.shape[-1] % 2:
            red = torch.cat([df._add(red[..., :1], s[..., -1:]), red[..., 1:]], dim=-1)
        s = red
    return s


def lag_from_u16(df, cols_u16: np.ndarray, device) -> torch.Tensor:
    """uint16[C, n, 16] host columns -> int32[C, 16, n] Montgomery-Lagrange
    on `device` (one upload, one to_mont launch)."""
    C, n, _ = cols_u16.shape
    if C == 0:
        return torch.zeros((0, N_LIMBS, n), dtype=torch.int32, device=device)
    return df._to_mont(to_device(cols_u16, device).transpose(1, 2))


def powers(df, x: int, m: int, device, start: int = 0) -> torch.Tensor:
    """[16, m] Montgomery powers x^start, ..., x^(start + m - 1) on
    `device`: a prefix product of [x^start, x, ..., x] (log2 m mont_mul
    launches)."""
    first = df.pack([pow(x, start, df.p_int)], device=device)
    step = df.pack([x], device=device)
    return df.prefix_prod(torch.cat([first, step.expand(N_LIMBS, m - 1)], dim=1))


class RowLayout:
    """Where the prover's row tensors live: plain tensors on `device`, or
    Rows over `devices` (the mesh's shards, in order). Each method takes and
    returns the layout's kind; the single-device methods are the torch calls
    the prover makes without a mesh."""

    def __init__(self, device, devices=None):
        self.sharded = devices is not None
        self.devices = [torch.device(d) for d in (devices if self.sharded else [device])]
        self.device = self.devices[0]

    @property
    def nshards(self) -> int:
        return len(self.devices)

    def field(self, df):
        return RowsField(df) if self.sharded else df

    # --- placing rows ---------------------------------------------------------------
    def shard(self, t: torch.Tensor):
        """A whole [..., 16, N] tensor (any device) in this layout: shard s
        gets rows [s N/S, (s+1) N/S), copied to its device."""
        if not self.sharded:
            return t.to(self.device)
        m = self._part_len(t.shape[-1])
        return Rows([t[..., s * m : (s + 1) * m].to(d).contiguous() for s, d in enumerate(self.devices)])

    def gather(self, t) -> torch.Tensor:
        """The whole tensor on the first device."""
        if not isinstance(t, Rows):
            return t
        return torch.cat([p.to(self.device) for p in t.parts], dim=-1)

    def upload(self, df, cols_u16: np.ndarray):
        """uint16[C, n, 16] host columns -> Montgomery-Lagrange [C, 16, n],
        each shard's rows uploaded to its device (one to_mont launch each)."""
        if not self.sharded:
            return lag_from_u16(df, cols_u16, self.device)
        m = self._part_len(cols_u16.shape[1])
        return Rows([lag_from_u16(df, cols_u16[:, s * m : (s + 1) * m], d)
                     for s, d in enumerate(self.devices)])

    def zeros(self, C: int, n: int):
        if not self.sharded:
            return torch.zeros((C, N_LIMBS, n), dtype=torch.int32, device=self.device)
        m = self._part_len(n)
        return Rows([torch.zeros((C, N_LIMBS, m), dtype=torch.int32, device=d) for d in self.devices])

    def ones(self, df, C: int, n: int):
        """C columns of the Montgomery one, [C, 16, n]."""
        if not self.sharded:
            return df.one_mont((C, n), self.device)
        m = self._part_len(n)
        return Rows([df.one_mont((C, m), d) for d in self.devices])

    def rows_below(self, n: int, r: int):
        """bool [n]: row index < r."""
        if not self.sharded:
            return torch.arange(n, device=self.device) < r
        m = self._part_len(n)
        return Rows([torch.arange(s * m, (s + 1) * m, device=d) < r for s, d in enumerate(self.devices)])

    def powers(self, df, x: int, n: int):
        """[16, n] Montgomery powers 1, x, ..., x^(n-1); shard s computes its
        own run from x^(s n/S)."""
        if not self.sharded:
            return powers(df, x, n, self.device)
        m = self._part_len(n)
        return Rows([powers(df, x, m, d, start=s * m) for s, d in enumerate(self.devices)])

    # --- column (leading-axis) assembly ---------------------------------------------
    def cat(self, ts, dim: int = 0):
        ts = list(ts)
        if not self.sharded:
            return torch.cat(ts, dim=dim)
        self._check_lead(ts, dim)
        return Rows([torch.cat([t.parts[s] for t in ts], dim=dim) for s in range(self.nshards)])

    def stack(self, ts, dim: int = 0):
        ts = list(ts)
        if not self.sharded:
            return torch.stack(ts, dim=dim)
        self._check_lead(ts, dim)
        return Rows([torch.stack([t.parts[s] for t in ts], dim=dim) for s in range(self.nshards)])

    def where(self, mask, a, b):
        return per_shard(torch.where, mask, a, b)

    # --- where rows mix ---------------------------------------------------------------
    def roll(self, t, shift: int):
        """torch.roll along the rows: out[i] = t[(i - shift) mod N]; each
        shard takes its halo from the shards that hold it."""
        if not isinstance(t, Rows):
            return torch.roll(t, shift, dims=-1)
        N = t.shape[-1]
        m = t.parts[0].shape[-1]
        out = []
        for s, d in enumerate(self.devices):
            a = (s * m - shift) % N
            if a + m <= N:
                out.append(self._range(t, a, a + m, d))
            else:
                out.append(torch.cat([self._range(t, a, N, d), self._range(t, 0, a + m - N, d)], -1))
        return Rows(out)

    def shift(self, t, fill):
        """Exclusive shift by one row: out[0] = fill ([..., 16, 1]), out[i] =
        t[i - 1]."""
        if not isinstance(t, Rows):
            return torch.cat([fill.expand(tuple(t.shape[:-1]) + (1,)), t[..., :-1]], dim=-1)
        return self.put(self.roll(t, 1), 0, fill)

    def take(self, t, a: int, b: int) -> torch.Tensor:
        """Rows [a, b) as one tensor on the first device."""
        if not isinstance(t, Rows):
            return t[..., a:b]
        return self._range(t, a, b, self.device)

    def put(self, t, a: int, vals):
        """A copy of t whose rows [a, a + L) are vals [..., 16, L] (vals
        broadcast over t's leading axes); only the shards holding those rows
        are copied."""
        L = vals.shape[-1]
        if not isinstance(t, Rows):
            t = t.clone()
            t[..., a : a + L] = vals
            return t
        m = t.parts[0].shape[-1]
        parts = list(t.parts)
        for s in range(a // m, (a + L - 1) // m + 1):
            lo, hi = max(a, s * m), min(a + L, (s + 1) * m)
            part = parts[s].clone()
            part[..., lo - s * m : hi - s * m] = vals[..., lo - a : hi - a].to(part.device)
            parts[s] = part
        return Rows(parts)

    def pad(self, t, n_to: int):
        """Zero-pad the rows to n_to (coefficients into a larger domain): the
        rows per shard grow, so rows move to lower shards."""
        N = t.shape[-1]
        if not isinstance(t, Rows):
            return torch.nn.functional.pad(t, (0, n_to - N))
        m2 = self._part_len(n_to)
        lead = tuple(t.shape[:-1])
        out = []
        for s, d in enumerate(self.devices):
            rows = self._range(t, min(s * m2, N), min((s + 1) * m2, N), d)  # those below N
            zeros = torch.zeros(lead + (m2 - rows.shape[-1],), dtype=torch.int32, device=d)
            out.append(torch.cat([rows, zeros], dim=-1))
        return Rows(out)

    def pieces(self, t, npieces: int, n: int):
        """[16, N] rows -> [npieces, 16, n]: piece p is rows [p n, (p + 1) n)
        (the quotient's split), sharded on its own rows."""
        if not isinstance(t, Rows):
            return t[:, : npieces * n].reshape(N_LIMBS, npieces, n).permute(1, 0, 2).contiguous()
        m = self._part_len(n)
        return Rows([
            torch.stack([self._range(t, p * n + s * m, p * n + (s + 1) * m, d) for p in range(npieces)])
            for s, d in enumerate(self.devices)
        ])

    def sum_lanes(self, df, t) -> torch.Tensor:
        """Field sum over the rows, [..., 16, N] -> [..., 16, 1] on the first
        device: per-shard partial sums, then their sum."""
        if not isinstance(t, Rows):
            return tree_sum_lanes(df, t)
        partial = [tree_sum_lanes(df, p).to(self.device) for p in t.parts]
        return tree_sum_lanes(df, torch.cat(partial, dim=-1))

    # --- helpers ----------------------------------------------------------------------
    def _part_len(self, n: int) -> int:
        if n % self.nshards:
            raise ValueError(f"{n} rows do not split over {self.nshards} shards")
        return n // self.nshards

    def _check_lead(self, ts, dim: int) -> None:
        if not all(isinstance(t, Rows) and len(t.parts) == self.nshards for t in ts):
            raise TypeError("every operand of a sharded cat or stack must be Rows of this mesh")
        if dim < 0:
            raise ValueError("a sharded cat or stack names its (leading) axis from the front")

    @staticmethod
    def _range(t: Rows, a: int, b: int, dev) -> torch.Tensor:
        """Global rows [a, b) of t (0 <= a <= b <= N) as one tensor on dev."""
        m = t.parts[0].shape[-1]
        if a == b:
            return torch.zeros(tuple(t.shape[:-1]) + (0,), dtype=t.parts[0].dtype, device=dev)
        pieces = [t.parts[s][..., max(a, s * m) - s * m : min(b, (s + 1) * m) - s * m].to(dev)
                  for s in range(a // m, (b - 1) // m + 1)]
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=-1)
