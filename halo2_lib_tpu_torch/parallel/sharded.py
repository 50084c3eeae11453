"""Mesh-sharded prover work: the mesh, the sharded MSM and the four-step NTT.

The port of ``halo2_lib_tpu/parallel/sharded.py``. The JAX module shards
over a ``jax.sharding.Mesh`` with ``shard_map`` and XLA collectives; here one
process drives every shard of a ``Mesh`` (one controller, as JAX): each
shard's tensors live on its device, its kernels launch on that device's
current stream (ops/cuda_field.py puts every launch under a guard of the
operands' device), and the collectives are device-to-device copies (peer
copies over NVLink between cards).

* ``make_mesh``: the first cards, one shard each, or a virtual mesh of
  several shards on one device when the caller names it (the counterpart of
  the JAX tests' 8-device virtual CPU mesh).
* ``sharded_msm`` / ``sharded_commit``: each shard runs the port's
  single-device MSM kernels on its slice of points and scalars: on the card
  up to 1024 points a shard the whole commit (``commit_dbl_add``), else the
  Pippenger bucket accumulation (``bucket_sums_fused``). The Jacobian
  partials (or bucket sums) meet on the first device and fold by ``ec_add``
  launches (a halving tree over the shards); the bucket sums then take the
  MSM's tail once (``bucket_weight``, ``msm_combine``).
* ``ShardedNTT``: the four-step transform over [n1, n2], k1 = k // 2, on
  row-sharded input (parallel/rows.py), in natural order in and out: an
  exchange to column shards, the size-n1 transforms (``new_ntt``), the
  twiddle scale (one ``mont_mul``), the all-to-all to row shards of the
  transposed matrix, the size-n2 transforms, and the exchange back to
  natural row order. The coset forms fold the shift's powers into the first
  transform's diagonal and the twiddles; the inverse's 1/n is the two local
  transforms' 1/n1 and 1/n2.

Tensors are limb-major int32[..., 16, B] (ops/limbs.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend.kzg import COMMIT_SIMPLE_MAX, _pack_affine, commit_double_and_add, window_digits
from ..ops import cuda_field as cf
from ..ops.ec_device import DeviceCurve, bucket_sums, msm_window_bits, weight_lanes
from ..ops.limbs import N_LIMBS, DeviceField
from ..ops.ntt import NTT_CHUNK, new_ntt, pows_device, pows_host
from ..utils.device import resolve_device
from .rows import RowLayout, Rows


class Mesh:
    """A set of devices one process drives, with named axes: the attributes
    of ``jax.sharding.Mesh`` the callers use (``devices``, a numpy object
    array, and ``axis_names``)."""

    def __init__(self, devices, axis_names):
        """devices: a numpy object array with one axis per name, or a list
        of devices for a one-axis mesh."""
        if not isinstance(devices, np.ndarray):
            arr = np.empty(len(devices), dtype=object)
            for i, d in enumerate(devices):
                arr[i] = d
            devices = arr
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {devices.shape} for axes {self.axis_names}")

    @property
    def size(self) -> int:
        return self.devices.size

    def __eq__(self, other):
        if not isinstance(other, Mesh):
            return NotImplemented
        return (self.axis_names == other.axis_names and self.devices.shape == other.devices.shape
                and list(self.devices.flat) == list(other.devices.flat))

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices.flat]}, axis_names={self.axis_names})"


def make_mesh(n_devices: int | None = None, axis: str = "dp", device=None) -> Mesh:
    """A one-axis mesh. Without `device`: the first `n_devices` visible
    cards (all of them when None), one shard each; raises without enough
    cards, and without any (no CPU fallback). With `device`: a virtual mesh
    of `n_devices` shards (1 when None), all on that one device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device= for a virtual mesh on one device")
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if n > count:
            raise ValueError(f"a mesh of {n} cards asked for, {count} visible")
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        n = 1 if n_devices is None else n_devices
        devs = [resolve_device(device)] * n
    if n < 1:
        raise ValueError("a mesh needs at least one shard")
    return Mesh(devs, (axis,))


def shard_devices(mesh: Mesh) -> list[torch.device]:
    """The shard devices of a one-axis mesh of this process, in order. A mesh
    that spans processes (make_global_mesh over several) is not driven by the
    sharded work yet (ROADMAP Queue 3)."""
    devs = list(mesh.devices.flat)
    if len(mesh.axis_names) != 1 or not all(isinstance(d, torch.device) for d in devs):
        raise NotImplementedError(
            f"a mesh over axes {mesh.axis_names} that spans processes is not driven by the "
            "port's sharded prover (ROADMAP Queue 3: the process-spanning prover mesh)"
        )
    return [resolve_device(d) for d in devs]


# ---------------------------------------------------------------------------
# sharded MSM
# ---------------------------------------------------------------------------


def fold_partials(dc: DeviceCurve, partials, device):
    """Sum S Jacobian triples (X, Y, Z), each [..., 16, B], on `device`: a
    halving tree of ec_add launches, each level's pairs side by side on the
    lane axis in one launch."""
    parts = [tuple(t.to(device) for t in P) for P in partials]
    while len(parts) > 1:
        half = len(parts) // 2
        B = parts[0][0].shape[-1]
        lhs = tuple(torch.cat([P[j] for P in parts[:half]], dim=-1) for j in range(3))
        rhs = tuple(torch.cat([P[j] for P in parts[half : 2 * half]], dim=-1) for j in range(3))
        summed = dc._add(lhs, rhs)
        parts = [tuple(t[..., i * B : (i + 1) * B] for t in summed) for i in range(half)] + parts[2 * half :]
    return parts[0]


def _sharded_jacobian(dc: DeviceCurve, fr_df: DeviceField, parts, bases, distinct: bool, device):
    """Jacobian [16, C] MSMs of the columns whose rows the shards hold
    (parts[s] [C, 16, m] Montgomery, against bases[s] = (Ax, Ay) of m
    points), on `device`. The path is kzg.commit_columns': on the card, up
    to COMMIT_SIMPLE_MAX rows a shard, each shard's commit_dbl_add, the
    partials folded by ec_add. Else Pippenger: each shard's bucket sums
    (bucket_sums_fused on its rows) fold by ec_add, bucket by bucket, and
    one weighted reduction and window combine (bucket_weight, msm_combine)
    end the mesh's MSM: the tail, whose cost does not shrink with the rows,
    runs once, not once a shard."""
    m = parts[0].shape[-1]
    if parts[0].device.type != "cpu" and m <= COMMIT_SIMPLE_MAX:
        partials = [commit_double_and_add(dc, fr_df, p, b) for p, b in zip(parts, bases)]
        return fold_partials(dc, partials, device)
    wb = msm_window_bits(m, parts[0].device)
    digits = [window_digits(fr_df, p, wb) for p in parts]
    sums = fold_partials(dc, [bucket_sums(b, d, wb, distinct) for b, d in zip(bases, digits)], device)
    T = cf.bucket_weight(sums, weight_lanes(sums[0].shape[-1], m, device))
    return cf.msm_combine(T, digits[0].shape[-2], wb)


def sharded_commit(dc: DeviceCurve, fr_df: DeviceField, cols: Rows, bases, distinct: bool = True):
    """Row-sharded [C, 16, n] Montgomery columns against per-shard affine
    bases [(Ax, Ay) of each shard's rows] -> int32[C, 33] canonical affine
    commitments on the first shard's device (kzg.commit_columns' packing)."""
    C = cols.shape[0]
    dev0 = cols.parts[0].device
    if C == 0:
        return torch.zeros((0, 33), dtype=torch.int32, device=dev0)
    X, Y, Z = _sharded_jacobian(dc, fr_df, cols.parts, bases, distinct, dev0)
    return _pack_affine(dc.df, X, Y, Z)


def sharded_msm(dc: DeviceCurve, points, scalars: list[int], mesh: Mesh):
    """MSM with points and scalars split in contiguous slices over the mesh's
    shards (padded with identity points and zero scalars to a multiple of
    the mesh size, as the JAX module pads), each shard's slice on its device
    (see _sharded_jacobian; any points, so the MSM keeps its doubling
    branch). Returns the affine host point (None for the identity)."""
    devs = shard_devices(mesh)
    S = len(devs)
    points = list(points) + [None] * ((-len(points)) % S)
    scalars = list(scalars) + [0] * (len(points) - len(scalars))
    m = len(points) // S
    fr_df = DeviceField(dc.curve.scalar)
    sl = [slice(s * m, (s + 1) * m) for s in range(S)]
    bases = [dc.pack_points_affine(points[sl[s]], dev) for s, dev in enumerate(devs)]
    parts = [fr_df.pack(scalars[sl[s]], device=dev)[None] for s, dev in enumerate(devs)]
    return dc.unpack_points(_sharded_jacobian(dc, fr_df, parts, bases, False, devs[0]))[0]


# ---------------------------------------------------------------------------
# sharded NTT (four-step decomposition)
# ---------------------------------------------------------------------------


class ShardedNTT:
    """Size-2^k NTT over Fr as the [n1, n2] four-step transform, n1 = 2^(k//2),
    on row-sharded tensors (parallel/rows.py), natural order in and out,
    equal to ``new_ntt(df, k, device)`` (and with `shift`, to
    ``CosetNTT(df, k, shift, device)``).

    Input index i = i1 n2 + i2 and output index j = j2 n1 + j1. Per call and
    shard: exchange A brings the shard its n2/S columns i2 (every i1); the
    size-n1 transforms over i1 (the coset's shift^(i1 n2) as their `pre`
    diagonal); the twiddle w^(i2 j1) (times shift^i2 forward, shift^-j1
    inverse) in one mont_mul; exchange B brings the shard its n1/S rows j1
    (every i2); the size-n2 transforms over i2 (the inverse coset's
    shift^(-j2 n1) as their `post` diagonal); exchange C brings the shard
    its output rows j2 (every j1). Each exchange is an all-to-all of blocks,
    every shard's block copied to its target's device."""

    def __init__(self, df: DeviceField, k: int, mesh: Mesh, shift: int | None = None):
        self.df = df
        self.devices = shard_devices(mesh)
        self.layout = RowLayout(self.devices[0], self.devices)
        self.k = k
        self.n = 1 << k
        k1 = k // 2
        self.n1 = 1 << k1
        self.n2 = 1 << (k - k1)
        self.k1, self.k2 = k1, k - k1
        self.shift = shift
        S = len(self.devices)
        if S > self.n1 or self.n1 % S:
            raise ValueError(f"a mesh of {S} shards does not divide the {self.n1} rows of "
                             f"2^{k}'s four-step")
        self.S = S
        self._dev: dict = {}  # per device: the local transforms and diagonals
        self._tw: dict = {}  # per direction: the twiddle block of each shard

    # --- tables -----------------------------------------------------------------------
    def _local(self, dev) -> dict:
        key = str(dev)
        t = self._dev.get(key)
        if t is None:
            df, p = self.df, self.df.p_int
            t = {"ntt1": new_ntt(df, self.k1, dev), "ntt2": new_ntt(df, self.k2, dev)}
            if self.shift is not None:
                g, gi = self.shift % p, pow(self.shift, p - 2, p)
                t["pre"] = pows_host(df, pow(g, self.n2, p), self.n1, dev)  # g^(i1 n2)
                t["post"] = t["ntt2"].inverse_post(pow(gi, self.n1, p))  # g^(-j2 n1) / n2
            self._dev[key] = t
        return t

    def _twiddles(self, forward: bool) -> list[torch.Tensor]:
        """Shard t's [n2/S, 16, n1] block of w^(i2 j1) (w^-1 inverse) for its
        columns i2, with the coset's shift^i2 (forward) or shift^-j1
        (inverse) folded in."""
        tws = self._tw.get(forward)
        if tws is not None:
            return tws
        df, p, n, n1, n2, S = self.df, self.df.p_int, self.n, self.n1, self.n2, self.S
        dev0 = self.devices[0]
        w = df.field.nth_root_of_unity(self.k)
        root = w if forward else pow(w, p - 2, p)
        pw = pows_device(df, root, n, dev0)
        c2 = n2 // S
        tws = []
        for t, dev in enumerate(self.devices):
            i2 = torch.arange(t * c2, (t + 1) * c2, device=dev0)[:, None]
            j1 = torch.arange(n1, device=dev0)[None, :]
            tw = pw[:, (i2 * j1 % n).reshape(-1)].reshape(N_LIMBS, c2, n1).permute(1, 0, 2)
            if self.shift is not None and forward:
                g = pows_device(df, self.shift % p, n2, dev0)[:, t * c2 : (t + 1) * c2]
                tw = df._mont_mul(tw, g.transpose(0, 1)[:, :, None])
            elif self.shift is not None:
                tw = df._mont_mul(tw, pows_device(df, pow(self.shift, p - 2, p), n1, dev0)[None])
            tws.append(tw.contiguous().to(dev))
        self._tw[forward] = tws
        return tws

    # --- the transform -----------------------------------------------------------------
    def _cols(self, x: Rows, forward: bool) -> Rows:
        """[C, 16, n] Rows -> its transform, [C, 16, n] Rows."""
        S, n1, n2 = self.S, self.n1, self.n2
        C = x.shape[0]
        r1, c2 = n1 // S, n2 // S
        devs = self.devices
        tws = self._twiddles(forward)
        # exchange A: shard t gets columns i2 of block t from every shard s
        # (its rows i1 of block s) -> [C, c2, 16, n1]
        src = [p.reshape(C, N_LIMBS, r1, n2) for p in x.parts]
        cols = [
            torch.cat([a[..., t * c2 : (t + 1) * c2].to(dev).permute(0, 3, 1, 2) for a in src], dim=-1)
            for t, dev in enumerate(devs)
        ]
        # step 1 and the twiddle: size-n1 transforms over i1 -> B[j1] per column
        mid = []
        for t, dev in enumerate(devs):
            loc = self._local(dev)
            y = cols[t].reshape(C * c2, N_LIMBS, n1)
            if forward:
                y = loc["ntt1"].forward(y, pre=loc.get("pre"))
            else:
                y = loc["ntt1"].inverse(y)
            mid.append(self.df._mont_mul(y.reshape(C, c2, N_LIMBS, n1), tws[t]))
        # exchange B: shard u gets rows j1 of block u from every shard t (its
        # columns i2 of block t) -> [C, r1, 16, n2]
        rows = [
            torch.cat([b[..., u * r1 : (u + 1) * r1].to(dev).permute(0, 3, 2, 1) for b in mid], dim=-1)
            for u, dev in enumerate(devs)
        ]
        # step 3: size-n2 transforms over i2 -> X[j2 n1 + j1] for its j1
        out = []
        for u, dev in enumerate(devs):
            loc = self._local(dev)
            z = rows[u].reshape(C * r1, N_LIMBS, n2)
            if forward:
                z = loc["ntt2"].forward(z)
            else:
                z = loc["ntt2"].inverse(z, post=loc.get("post"))
            out.append(z.reshape(C, r1, N_LIMBS, n2))
        # exchange C: shard v gets output rows j2 of block v (every j1) ->
        # [C, 16, c2, n1] = rows [v n/S, (v + 1) n/S) in natural order
        nat = [
            torch.cat([z[..., v * c2 : (v + 1) * c2].to(dev).permute(0, 2, 3, 1) for z in out], dim=-1)
            for v, dev in enumerate(devs)
        ]
        return Rows([t.reshape(C, N_LIMBS, c2 * n1) for t in nat])

    def _apply(self, x, forward: bool):
        """Any [..., 16, n]: Rows stay Rows; a plain tensor is sharded and
        the result gathered back to its device."""
        plain = not isinstance(x, Rows)
        rows = self.layout.shard(x) if plain else x
        lead = tuple(rows.shape[:-2])
        flat = rows.reshape(-1, N_LIMBS, self.n)
        C = flat.shape[0]
        chunks = [self._cols(flat[i : i + NTT_CHUNK], forward) for i in range(0, C, NTT_CHUNK)]
        out = chunks[0] if len(chunks) == 1 else self.layout.cat(chunks)
        out = out.reshape(lead + (N_LIMBS, self.n))
        return self.layout.gather(out).to(x.device) if plain else out

    def forward(self, coeffs):
        """Evaluations at shift * w^i (natural order) from coefficients."""
        return self._apply(coeffs, True)

    def inverse(self, evals):
        """Coefficients from evaluations at shift * w^i."""
        return self._apply(evals, False)

    forward_cols = forward
    inverse_cols = inverse


def sharded_ntt_step(df: DeviceField, k: int, mesh: Mesh, coeffs):
    """One sharded forward NTT; returns evals [16, n] (natural order)."""
    return ShardedNTT(df, k, mesh).forward(coeffs)
