"""create_proof: the PlonKish KZG prover (SHPLONK multiopen, Blake2b FS).

The port of ``halo2_lib_tpu/backend/prover.py`` (halo2-axiom's
`create_proof::<KZGCommitmentScheme, ProverSHPLONK, Challenge255, _,
Blake2bWrite, _>`). The stages between two transcript squeezes run as plain
torch code on the device: batched column math over the field kernels of
ops/cuda_field.py, batched NTTs, and one batched MSM per commitment phase.
Columns in evaluation form commit directly against the Lagrange-basis SRS;
coefficient-form polynomials (quotient pieces, SHPLONK openings) against the
monomial basis. Witness columns upload once as 16-bit limbs.

Per-proving-key device state (fixed/sigma/selector/table columns in
Lagrange, coefficient and extended-coset form) is computed once and cached
on the ProvingKey (`_runtime`).

Over a mesh (``create_proof(mesh=...)``, parallel/sharded.py ``make_mesh``)
every column tensor is sharded on its row axis, as the JAX prover's
``_row_sharder`` shards it, and each stage runs per shard on the shard's
device; where rows mix it takes the explicit cross-shard forms of
parallel/rows.py (``RowLayout``): the sharded MSM per commit, the sharded
four-step NTT, the grand products' scan with a carry across shards, the
rotations' halos, the evaluations' partial sums. The proof is the
single-device proof's bytes.

Protocol phases (mirrored by verifier.py):
  vk hash + instances -> advice commitments -> theta -> lookup permuted
  commitments -> beta, gamma -> permutation + lookup Z commitments -> random
  poly -> y -> quotient pieces -> x -> evals -> SHPLONK(v, w; H; u; Q).
"""

from __future__ import annotations

import os
import random as _random
import sys
import time as _time

import numpy as np
import torch

from ..gates.circuit import BaseCircuitBuilder, PhysicalCircuit
from ..native import get_native
from ..ops.limbs import N_LIMBS, ints_to_limbs, limbs_to_ints
from ..ops.ntt import NTT_CHUNK
from ..parallel.rows import RowLayout, Rows, lag_from_u16 as _lag_from_u16
from ..parallel.sharded import ShardedNTT, sharded_commit, shard_devices
from ..utils.device import resolve_device, stage_end
from ..utils.fields import FR_BN254
from .keygen import BLINDING_FACTORS, DELTA, ProvingKey
from .kzg import ParamsKZG, host_points
from .poly import COSET_SHIFT, domain as get_domain
from .protocol import (
    P,
    compress_host,
    group_queries,
    lagrange_interpolate,
    lookup_instances,
    perm_chunks,
    point_values,
    poly_eval,
    query_plan,
    quotient_pieces,
    usable_row_count,
    vanishing_poly,
)
from .transcript import Blake2bWrite


def _pad(col: list[int], n: int) -> list[int]:
    return list(col) + [0] * (n - len(col))


def _blind(col: list[int], n: int, rng) -> list[int]:
    """Fill the last BLINDING_FACTORS rows with random values (zk blinding)."""
    out = _pad(col, n)
    for r in range(n - BLINDING_FACTORS, n):
        out[r] = rng.randrange(P)
    return out


def _permute_pair_np(a_vals, s_vals, u: int, n: int, rng):
    """Vectorized permute_expression_pair for u64-range values. Output is
    identical to the exact-int path below, including halo2's leftover order
    (each distinct table value's remaining copies in first-occurrence order)."""
    a, s = a_vals, s_vals
    a_sorted = np.sort(a)
    new_mask = np.ones(u, dtype=bool)
    new_mask[1:] = a_sorted[1:] != a_sorted[:-1]
    a_uniq = a_sorted[new_mask]
    vals, first_idx, counts = np.unique(s, return_index=True, return_counts=True)
    order = np.argsort(first_idx, kind="stable")
    vals, counts = vals[order], counts[order]
    consumed = np.isin(vals, a_uniq)
    if not np.isin(a_uniq, vals).all():
        missing = a_uniq[~np.isin(a_uniq, vals)][0]
        raise ValueError(f"lookup failure: value {missing} not in table")
    leftovers = np.repeat(vals, counts - consumed.astype(np.int64))
    s_out = np.where(new_mask, a_sorted, 0)
    s_out[~new_mask] = leftovers[: (~new_mask).sum()]
    a_p = _blind([int(v) for v in a_sorted], n, rng)
    s_p = _blind([int(v) for v in s_out], n, rng)
    return a_p, s_p


def _permute_pair(a_vals: list[int], s_vals: list[int], u: int, n: int, rng):
    """halo2 permute_expression_pair: sort input; align table (lookup/prover.rs)."""
    try:
        a64 = np.asarray(a_vals[:u], dtype=np.int64)
        s64 = np.asarray(s_vals[:u], dtype=np.int64)
    except OverflowError:
        a64 = s64 = None
    if a64 is not None and len(a64) == u and (a64 >= 0).all() and (s64 >= 0).all():
        return _permute_pair_np(a64, s64, u, n, rng)
    a_sorted = sorted(a_vals[:u])
    s_multiset: dict[int, int] = {}
    for v in s_vals[:u]:
        s_multiset[v] = s_multiset.get(v, 0) + 1
    s_out: list[int | None] = [None] * u
    for i, v in enumerate(a_sorted):
        if i == 0 or v != a_sorted[i - 1]:
            cnt = s_multiset.get(v, 0)
            if cnt == 0:
                raise ValueError(f"lookup failure: value {v} not in table")
            s_multiset[v] = cnt - 1
            s_out[i] = v
    leftovers = []
    for v, c in s_multiset.items():
        leftovers.extend([v] * c)
    it = iter(leftovers)
    for i in range(u):
        if s_out[i] is None:
            s_out[i] = next(it)
    a_p = _blind(a_sorted, n, rng)
    s_p = _blind([int(v) for v in s_out], n, rng)
    return a_p, s_p


def _u16_cols(cols: list[list[int]], n: int) -> np.ndarray:
    """Host int columns -> uint16[C, n, 16] canonical limbs (the upload
    format). Packed by the host engine's pack_limbs16 (native.py; one C call
    where ints_to_limbs takes an int.to_bytes per full-width value), by
    ints_to_limbs on the Python path."""
    if not cols:
        return np.zeros((0, n, N_LIMBS), dtype=np.uint16)
    flat: list[int] = []
    for c in cols:
        assert len(c) == n
        flat.extend(c)
    nat = get_native()
    if nat is not None:
        buf = nat.pack_limbs16(flat)
        return np.frombuffer(buf, dtype="<u2").reshape(len(cols), n, N_LIMBS)
    return ints_to_limbs(flat).astype(np.uint16).reshape(len(cols), n, N_LIMBS)


class ProverRuntime:
    """Per-(params, pk) device state: the pk's tables in Lagrange,
    coefficient and extended-coset form, and the domain constants, on
    `device`, or sharded on their rows over `mesh` (its first shard's device
    is then `device`), with the NTTs and the commit of that layout."""

    def __init__(self, params: ParamsKZG, pk: ProvingKey, device, mesh=None):
        self.params = params
        self.mesh = mesh
        if mesh is None:
            self.layout = RowLayout(device)
        else:
            devs = shard_devices(mesh)
            self.layout = RowLayout(devs[0], devs)
        self.device = device = self.layout.device
        L = self.layout
        vk = pk.vk
        self.vk = vk
        self.k = vk.k
        self.n = 1 << vk.k
        self.u = usable_row_count(self.n)
        self.dom = get_domain(vk.k)
        self.df = self.dom.df
        # the field's ring operations over this layout's tensors
        self.fd = L.field(self.df)
        n, u, dom, df = self.n, self.u, self.dom, self.df
        if mesh is None:
            self.ntt, self.coset = dom.ntt(device), dom.coset_ntt(device)
        else:
            self.ntt = ShardedNTT(df, vk.k, mesh)
            self.coset = ShardedNTT(df, dom.k_ext, mesh, shift=COSET_SHIFT)
        ncols = len(vk.perm_columns)
        self.nchunks = len(perm_chunks(ncols))

        fixed_host = {
            "sel": pk.selectors,
            "fix": pk.fixed_cols,
            "dynen": pk.dynen_cols,
            "qlookup": [pk.q_lookup_col] if pk.q_lookup_col is not None else [],
            "table": [pk.table_col] if pk.table_col is not None else [],
        }
        # domain constants ride the table pipeline as extra columns: l0, llast,
        # lact (Lagrange selectors) and X (whose Lagrange form on H is w^i)
        from ..ops.ntt import pows_host_ints

        l0 = [0] * n
        l0[0] = 1
        llast = [0] * n
        llast[u] = 1
        lact = [1 if r < u else 0 for r in range(n)]
        xlag = pows_host_ints(FR_BN254.p, dom.omega, n)
        fixed_host["const"] = [l0, llast, lact, xlag]
        const_names = {"const0": "l0", "const1": "llast", "const2": "lact", "const3": "xpoly"}
        # challenge-pin selectors L_row: derived one-hot Lagrange columns,
        # never committed (the verifier computes L_row(x) in closed form)
        for i, (_c, _fc, row) in enumerate(vk.challenge_pins):
            pin = [0] * n
            pin[row] = 1
            const_names[f"const{len(fixed_host['const'])}"] = f"pinrow{i}"
            fixed_host["const"].append(pin)

        stacked = []
        self._tbl_index: dict[str, int] = {}
        for fam, cols in fixed_host.items():
            for i, c in enumerate(cols):
                name = f"{fam}{i}" if fam != "table" else "table"
                self._tbl_index[const_names.get(name, name)] = len(stacked)
                stacked.append(_pad(c, n))
        for ci in range(ncols):
            self._tbl_index[f"sigma{ci}"] = len(stacked) + ci
        lag_cols = L.upload(df, _u16_cols(stacked, n))
        self.tbl_lag = L.cat([lag_cols, L.shard(pk.perm_values)])
        self.tbl_coeff = self.ntt.inverse_cols(self.tbl_lag)
        self.tbl_ext = self.coset.forward_cols(L.pad(self.tbl_coeff, dom.n_ext))

        tix = self._tbl_index
        self.tables = {
            "lag": self.tbl_lag,
            "coeff": self.tbl_coeff,
            "ext": self.tbl_ext,
            "l0_e": self.tbl_ext[tix["l0"]],
            "llast_e": self.tbl_ext[tix["llast"]],
            "lact_e": self.tbl_ext[tix["lact"]],
            "x_poly_e": self.tbl_ext[tix["xpoly"]],
            "omega": L.shard(dom.omega_pows_dev(device)),
            "zh_inv": L.shard(dom.zh_inv_ext(device)),
            "lagA": self._bases(True),
            "monoA": self._bases(False),
        }

    def _bases(self, lagrange: bool):
        """The SRS's affine bases (Lagrange or monomial) on the device, or
        each shard's slice of them on its device."""
        L, params = self.layout, self.params
        if not L.sharded:
            return (params.affine_lagrange_bases if lagrange else params.affine_bases)(self.device)
        m = self.n // L.nshards
        return [params.affine_slice(lagrange, s * m, (s + 1) * m, d) for s, d in enumerate(L.devices)]

    def commit(self, cols, basis: str):
        """[C, 16, m] columns of the layout -> int32[C, 33] commitments on
        the device, against the Lagrange ("lagA") or monomial ("monoA")
        bases: one commit_columns call, or the sharded MSM over the mesh."""
        if isinstance(cols, Rows):
            return sharded_commit(self.params.device_curve(), self.df, cols, self.tables[basis])
        return self.params.commit_columns(self.df, cols, self.tables[basis])


def runtime_for(params: ParamsKZG, pk: ProvingKey, device, mesh=None) -> ProverRuntime:
    """The pk's cached ProverRuntime for (params, device) or (params, mesh),
    built if needed."""
    rt: ProverRuntime = getattr(pk, "_runtime", None)
    if rt is None or rt.params is not params or rt.mesh != mesh or rt.device != device:
        rt = ProverRuntime(params, pk, device, mesh)
        pk._runtime = rt
    return rt


def _tree_sum(df, stack, cat=torch.cat):
    """Field sum along axis 0 of [m, ..., 16, B] (log-depth); `cat` joins
    along axis 0 (RowLayout.cat for Rows)."""
    s = stack
    while s.shape[0] > 1:
        half = s.shape[0] // 2
        red = df._add(s[:half], s[half : 2 * half])
        if s.shape[0] % 2:
            red = cat([df._add(red[:1], s[-1:]), red[1:]], dim=0)
        s = red
    return s[0]


def _tree_prod(df, stack, cat=torch.cat):
    """Field product along axis 0 of [m, ..., 16, B] (log-depth)."""
    s = stack
    while s.shape[0] > 1:
        half = s.shape[0] // 2
        red = df._mont_mul(s[:half], s[half : 2 * half])
        if s.shape[0] % 2:
            red = cat([df._mont_mul(red[:1], s[-1:]), red[1:]], dim=0)
        s = red
    return s[0]


def _map_labels(label, leaf):
    """leaf(column label) at every leaf of a ("prod", e1, e2) lookup
    expression. Module-level, so that create_proof's resolvers are not
    recursive closures: a closure that refers to itself is a reference cycle,
    and would keep the proof's columns, the key and its runtime on the
    device until the collector runs."""
    if isinstance(label, tuple):
        return (label[0], _map_labels(label[1], leaf), _map_labels(label[2], leaf))
    return leaf(label)


def _flatten_lookup_cols(builder, t: int, nlookup: int) -> list[list[int]]:
    """The lookup-advice columns of phase t."""
    lm = builder.lookup_manager[t]
    lk: list[list[int]] = [[] for _ in range(nlookup)]
    if lm.total_rows() > 0 and nlookup > 0:
        from ..core.cells import assigned_to_int

        for i, cell_tuple in enumerate(lm.iter_rows()):
            lk[i % nlookup].append(assigned_to_int(cell_tuple[0].value, builder.field))
        lm.assigned = True
    return lk


def _flatten_prover_phase(builder, t: int, ncols: int, nlookup: int, usable_rows: int):
    """Flatten phase t of a builder for proving: (advice columns, lookup
    columns). Later-phase witnesses exist only after the earlier phases'
    challenges were squeezed (halo2 challenge phases)."""
    builder.core.touch(t)
    pm = builder.core.phase_manager[t]
    if builder.witness_gen_only():
        assert pm.break_points is not None, "break points not set for prover"
        fp = pm.flatten_witnesses(ncols, pm.break_points)
    else:
        fp = pm.flatten_with_constraints(ncols, usable_rows)
    adv = [fp.columns[i] if i < len(fp.columns) else [] for i in range(ncols)]
    return adv, _flatten_lookup_cols(builder, t, nlookup)


def _selfcheck_h(
    vk, pk, dom, u, advice_vals, lookup_vals, dyn_vals, instance_vals,
    permuted_host, allz_lag, insts, host_col, theta, beta, gamma,
):
    """HALO2_PROVER_SELFCHECK=1 (the JAX package's ``_selfcheck_h``):
    re-check every argument family pointwise on H with exact host ints,
    from the host witness and the device's grand products, and print the
    failures, each family's first failing row, or "all argument families
    hold on H" (fault localization for "quotient degree overflow"). The
    JAX families' messages come first; the last permutation z and the gates
    follow (the JAX check has neither)."""
    n = 1 << vk.k
    ncols = len(vk.perm_columns)
    chunks = perm_chunks(ncols)
    nchunks = len(chunks)
    ninst = len(insts)
    z_all = dom.unpack(allz_lag)
    zs = [z_all[j * n : (j + 1) * n] for j in range(nchunks + ninst + 1)]
    sigma = dom.unpack(pk.perm_values)
    sig = [sigma[c * n : (c + 1) * n] for c in range(ncols)]
    # the JAX check's pow(DELTA, ci) and pow(omega, r) per row, as tables
    bdelta = [beta * pow(DELTA, ci, P) % P for ci in range(ncols)]
    omega_r = [1] * u
    for r in range(1, u):
        omega_r[r] = omega_r[r - 1] * dom.omega % P

    def col_vals(cr):
        if cr.kind == "advice":
            return _pad(advice_vals[cr.index], n)
        if cr.kind == "lookup":
            return _pad(lookup_vals[cr.index], n)
        if cr.kind == "fixed":
            return pk.fixed_cols[cr.index]
        if cr.kind == "instance":
            return instance_vals[cr.index]
        if cr.kind == "dynadv":
            return dyn_vals[cr.index]
        raise ValueError(cr.kind)

    vals = [col_vals(cr) for cr in vk.perm_columns]
    fails = []
    # permutation chunks
    for j, (s, e) in enumerate(chunks):
        z = zs[j]
        if z[0] != (1 if j == 0 else zs[j - 1][u]):
            fails.append(f"permz{j} start row0")
        for r in range(u):
            left = z[(r + 1) % n]
            right = z[r]
            for ci in range(s, min(e, ncols)):
                left = left * ((vals[ci][r] + beta * sig[ci][r] + gamma) % P) % P
                right = right * ((vals[ci][r] + bdelta[ci] * omega_r[r] + gamma) % P) % P
            if left != right:
                fails.append(f"permz{j} row {r}")
                break
    # lookups
    for li, (inp, tbl) in enumerate(insts):
        a_in = compress_host([host_col(lb) for lb in inp], theta, u)
        t_in = compress_host([host_col(lb) for lb in tbl], theta, u)
        a_p = permuted_host[2 * li]
        s_p = permuted_host[2 * li + 1]
        zl = zs[nchunks + li]
        if zl[0] != 1:
            fails.append(f"lk{li} z row0 != 1")
        if zl[u] * zl[u] % P != zl[u]:
            fails.append(f"lk{li} z last not bool")
        if (a_p[0] - s_p[0]) % P != 0:
            fails.append(f"lk{li} e4 row0")
        for r in range(u):
            left = zl[(r + 1) % n] * ((a_p[r] + beta) % P) % P * ((s_p[r] + gamma) % P) % P
            right = zl[r] * ((a_in[r] + beta) % P) % P * ((t_in[r] + gamma) % P) % P
            if left != right:
                fails.append(f"lk{li} e3 row {r}")
                break
            d = (a_p[r] - s_p[r]) % P
            prev = a_p[r - 1] if r else a_p[n - 1]
            if d and (a_p[r] - prev) % P != 0:
                fails.append(f"lk{li} e5 row {r}")
                break
    # two families the JAX check leaves to the quotient, so that a witness
    # that breaks the circuit (not only a faulty device stage) is named:
    # the last permutation z at row u (l_last (z^2 - z)) and the gates
    # q * (a + b c - d), which a tampered cell breaks while every grand
    # product above still holds
    if nchunks and zs[nchunks - 1][u] * zs[nchunks - 1][u] % P != zs[nchunks - 1][u]:
        fails.append(f"permz{nchunks - 1} last not bool")
    for c, sel in enumerate(pk.selectors):
        a = advice_vals[c]
        for r in range(n):
            if sel[r] and (a[r] + a[(r + 1) % n] * a[(r + 2) % n] - a[(r + 3) % n]) % P:
                fails.append(f"gate col {c} row {r}")
                break
    msg = "; ".join(fails) if fails else "all argument families hold on H"
    print(f"[prover selfcheck] {msg}", file=sys.stderr, flush=True)


def _selfcheck_roundtrip(L, ntt, coset, n: int, columns) -> None:
    """HALO2_PROVER_SELFCHECK=2 (the JAX package's check before the
    quotient): every (name, Lagrange, extended-coset) column stack must
    round-trip ext -> coefficients (degree < n) -> Lagrange exactly. Prints
    each failing column, then a count of the columns checked."""
    checked = 0
    for name, lag_t, ext_t in columns:
        for c0 in range(0, lag_t.shape[0], NTT_CHUNK):
            c1 = min(c0 + NTT_CHUNK, lag_t.shape[0])
            back = coset.inverse_cols(ext_t[c0:c1])
            top = L.take(back, n, back.shape[-1])
            lag_back = L.gather(ntt.forward_cols(L.shard(L.take(back, 0, n))))
            lag = L.gather(lag_t[c0:c1])
            for i in range(c1 - c0):
                msgs = []
                if bool(top[i].any()):
                    msgs.append("degree >= n")
                bad = (lag_back[i] != lag[i]).any(0).nonzero()
                if bad.numel():
                    msgs.append(f"lag roundtrip mismatch at row {int(bad[0, 0])}")
                if msgs:
                    print(f"[prover selfcheck2] {name} col {c0 + i}: {'; '.join(msgs)}",
                          file=sys.stderr, flush=True)
            checked += c1 - c0
    print(f"[prover selfcheck2] {checked} columns checked", file=sys.stderr, flush=True)


@torch.inference_mode()
def create_proof(
    params: ParamsKZG,
    pk: ProvingKey,
    builder_or_circuit,
    instances: list[list[int]] | None = None,
    seed: int = 0,
    phase_fns: dict | None = None,
    device=None,
    timings: dict | None = None,
    phase0=None,
    mesh=None,
) -> bytes:
    """Generate a proof on `device` (the CUDA card unless the caller asks for
    another). A `timings` dict receives the seconds of each stage.

    `phase_fns`: optional {phase t >= 1: fn(builder, challenges)} witness
    closures for halo2-style challenge phases, called after the phase-(t-1)
    advice commitments with the challenges squeezed so far; they append the
    phase-t witnesses to the builder (requires a builder, not a circuit).

    `phase0`: a finished backend/pipeline.py Phase0Pipeline, whose phase-0
    advice columns were blinded, uploaded and committed while the witness
    was generated (requires the builder it ran on).

    `mesh`: a one-process parallel/sharded.py Mesh (``make_mesh``): the
    columns are sharded on their rows over its shards and every stage runs
    per shard (see the module docstring); the same proof bytes. Not with
    `phase0`; `device`, if given, must be the mesh's first shard's.
    """
    if mesh is None:
        device = resolve_device(device)
        sync = (device,)  # the devices a stage's end waits for
    else:
        if phase0 is not None:
            raise ValueError("phase0 pipelines one device's commits: it does not run over a mesh")
        devs = shard_devices(mesh)
        if device is not None and resolve_device(device) != devs[0]:
            raise ValueError(f"device {device} is not the mesh's first shard {devs[0]}")
        device = devs[0]
        sync = tuple(dict.fromkeys(devs))
    vk = pk.vk
    k = vk.k
    n = 1 << k
    u = usable_row_count(n)
    rng = _random.Random(("create-proof-blinding", seed).__repr__())
    _t = _time.time()

    builder = None
    if phase_fns or phase0 is not None:
        assert isinstance(builder_or_circuit, BaseCircuitBuilder), (
            "phase_fns/phase0 require a builder"
        )
        builder = builder_or_circuit
        circuit = None
        if phase0 is not None:
            # the pipeline's columns and pre-drawn blinding are this proof's
            # only if it ran on this builder with this seed and device
            assert phase0.builder is builder, "phase0 ran on another builder"
            assert phase0.seed == seed, f"phase0 drew its blinding for seed {phase0.seed}, not {seed}"
            assert phase0.device == device, f"phase0 ran on device {phase0.device}, not {device}"
            assert phase0.params is params, "phase0 committed with other params"
        if instances is None:
            instances = []
    elif isinstance(builder_or_circuit, BaseCircuitBuilder):
        circuit: PhysicalCircuit = builder_or_circuit.synthesize()
    else:
        circuit = builder_or_circuit
    if instances is None:
        instances = circuit.instances
    _t = stage_end("synthesize", _t, sync, timings, "prover")

    rt = runtime_for(params, pk, device, mesh)
    _t = stage_end("runtime", _t, sync, timings, "prover")
    L = rt.layout
    dom, df = rt.dom, rt.fd
    ntt, coset = rt.ntt, rt.coset
    na, nl, ncols = vk.num_advice, vk.num_lookup, len(vk.perm_columns)
    nchunks = rt.nchunks
    na_p = vk.num_advice_per_phase or [na]
    nl_p = vk.num_lookup_per_phase or [nl]
    nphases = max(len(na_p), 1)
    insts = lookup_instances(vk)
    ninst = len(insts)
    nd = 2 * sum(vk.dyn_key_cols)

    # label -> (source, index) for the runtime column stacks (runtime order:
    # advice, lookup, dyn advice, instance, permuted pairs, permutation z,
    # lookup z, random)
    o_adv, o_lk = 0, na
    o_dyn = na + nl
    o_inst = o_dyn + nd
    o_perm = o_inst + vk.num_instance
    o_permz = o_perm + 2 * ninst
    o_lkz = o_permz + nchunks
    o_rand = o_lkz + ninst

    def _src_leaf(label):
        if label.startswith("adv"):
            return ("rt", o_adv + int(label[3:]))
        if label.startswith("lkcol"):
            return ("rt", o_lk + int(label[5:]))
        if label.startswith("dynen"):
            return ("tbl", rt._tbl_index[label])
        if label.startswith("dyn"):
            return ("rt", o_dyn + int(label[3:]))
        if label.startswith("permz"):
            return ("rt", o_permz + int(label[5:]))
        if label.startswith("lk") and label.endswith("_zl"):
            return ("rt", o_lkz + int(label[2:-3]))
        if label.startswith("lk") and label.endswith("_a"):
            return ("rt", o_perm + 2 * int(label[2:-2]))
        if label.startswith("lk") and label.endswith("_s"):
            return ("rt", o_perm + 2 * int(label[2:-2]) + 1)
        if label == "random":
            return ("rt", o_rand)
        if label == "h":
            return ("h", 0)
        return ("tbl", rt._tbl_index[label])

    def _src(label):
        return _map_labels(label, _src_leaf)

    inst_srcs = [([_src(lb) for lb in inp], [_src(lb) for lb in tbl]) for inp, tbl in insts]

    instance_vals = [_pad(col, n) for col in instances]
    while len(instance_vals) < vk.num_instance:
        instance_vals.append([0] * n)

    # transcript init: the vk absorbed as a scalar (halo2's vk.hash_into)
    tr = Blake2bWrite()
    tr.common_scalar(vk.transcript_repr())
    for col in instances:
        for v in col:
            tr.common_scalar(v)

    # === advice commitments, one batched MSM per challenge phase ===========
    T = rt.tables
    challenges: list[int] = []
    advice_vals: list[list[int]] = []
    lookup_vals: list[list[int]] = []
    phase_lags = []
    inst_lag = None

    def _phase_cols(t: int):
        ncols_t = na_p[t] if t < len(na_p) else 0
        nlk_t = nl_p[t] if t < len(nl_p) else 0
        if circuit is not None:
            fp = circuit.phases[t] if t < len(circuit.phases) else None
            adv = [fp.columns[i] if fp and i < len(fp.columns) else [] for i in range(ncols_t)]
            lkc = circuit.lookup_cols[t] if t < len(circuit.lookup_cols) else []
            lk = [lkc[j] if j < len(lkc) else [] for j in range(nlk_t)]
            return adv, lk
        return _flatten_prover_phase(builder, t, ncols_t, nlk_t, u)

    for t in range(nphases):
        if t > 0 and phase_fns and phase_fns.get(t) is not None:
            phase_fns[t](builder, list(challenges))
        if t == 0 and phase0 is not None:
            # the phase-0 advice was blinded, uploaded and committed during
            # witness generation (backend/pipeline.py): skip its blinding
            # draws so the rng stream stays the plain prover's, then handle
            # the lookup-advice and instance columns here
            adv_t = phase0.advice_cols
            for _ in range(len(adv_t) * BLINDING_FACTORS):
                rng.randrange(P)
            lk_t = [_blind(col, n, rng) for col in _flatten_lookup_cols(builder, 0, nl_p[0])]
            rest = L.upload(df, _u16_cols(lk_t + instance_vals, n))
            lag_t = torch.cat([phase0.advice_lag(), rest], dim=0)
            com1 = torch.cat([phase0.commits(), rt.commit(rest[: len(lk_t)], "lagA")])
        else:
            adv_t, lk_t = _phase_cols(t)
            adv_t = [_blind(col, n, rng) for col in adv_t]
            lk_t = [_blind(col, n, rng) for col in lk_t]
            cols = adv_t + lk_t + (instance_vals if t == 0 else [])
            lag_t = L.upload(df, _u16_cols(cols, n))
            com1 = rt.commit(lag_t[: len(adv_t) + len(lk_t)], "lagA")
        advice_vals.extend(adv_t)
        lookup_vals.extend(lk_t)
        ncommit = len(adv_t) + len(lk_t)
        for pt in host_points(com1):
            tr.write_point(pt)
        if t == 0:
            inst_lag = lag_t[ncommit:]
        phase_lags.append((lag_t[: len(adv_t)], lag_t[len(adv_t) : ncommit]))
        if t < nphases - 1:
            challenges.append(tr.squeeze_challenge())

    empty = L.zeros(0, n)
    adv_lag = L.cat([a for a, _ in phase_lags]) if phase_lags else empty
    lk_lag = L.cat([lb for _, lb in phase_lags]) if phase_lags else empty

    # dynamic-lookup dedicated advice columns (committed after phase advice)
    dyn_vals: list[list[int]] = []
    if circuit is not None:
        for s in circuit.dyn_sets:
            for col in s["key_cols"] + s["table_cols"]:
                dyn_vals.append(_blind(col, n, rng))
    elif builder is not None and builder.dyn_lookup_manager is not None:
        for s in builder.dyn_lookup_manager.resolve_columns(builder.field, True):
            for col in s["key_cols"] + s["table_cols"]:
                dyn_vals.append(_blind(col, n, rng))
    assert len(dyn_vals) == nd, "dyn lookup columns don't match the proving key"
    if nd:
        dyn_lag = L.upload(df, _u16_cols(dyn_vals, n))
        for pt in host_points(rt.commit(dyn_lag, "lagA")):
            tr.write_point(pt)
    else:
        dyn_lag = empty
    _t = stage_end("advice commits", _t, sync, timings, "prover")

    theta = tr.squeeze_challenge()  # lookup input/table compression

    # === lookup permuted columns ===========================================
    def _host_leaf(label):
        if label.startswith("lkcol"):
            return lookup_vals[int(label[5:])]
        if label.startswith("dynen"):
            return pk.dynen_cols[int(label[5:])]
        if label.startswith("dyn"):
            return dyn_vals[int(label[3:])]
        if label.startswith("adv"):
            return advice_vals[int(label[3:])]
        if label == "qlookup0":
            return pk.q_lookup_col
        if label == "table":
            return pk.table_col
        raise ValueError(label)

    def _host_col(label):
        return _map_labels(label, _host_leaf)

    permuted_host = []
    for inp_labels, tbl_labels in insts:
        a_comp = compress_host([_host_col(lb) for lb in inp_labels], theta, u)
        s_comp = compress_host([_host_col(lb) for lb in tbl_labels], theta, u)
        a_p, s_p = _permute_pair(a_comp, s_comp, u, n, rng)
        permuted_host.extend([a_p, s_p])
    permuted_lag = L.upload(df, _u16_cols(permuted_host, n))
    for pt in host_points(rt.commit(permuted_lag, "lagA")):
        tr.write_point(pt)
    _t = stage_end("lookup permuted", _t, sync, timings, "prover")

    beta = tr.squeeze_challenge()
    gamma = tr.squeeze_challenge()

    # === permutation + lookup grand products + random poly =================
    beta_deltas = [beta * pow(DELTA, ci, P) % P for ci in range(ncols)]
    zblind = [[rng.randrange(P) for _ in range(n - u - 1)] for _ in range(nchunks + ninst)]
    random_lag_vals = [rng.randrange(P) for _ in range(n)]
    # scal layout: [theta, beta, gamma, beta*delta^0, ...]
    scal = dom.pack([theta, beta, gamma] + beta_deltas, device)
    zb = _lag_from_u16(df, _u16_cols(zblind, n - u - 1), device)
    rand_lag = L.upload(df, _u16_cols([random_lag_vals], n))
    row_lt_u = L.rows_below(n, u)
    one = df.one_mont((1,), device)  # [16, 1], broadcast over the rows
    tix = rt._tbl_index
    beta_c = scal[:, 1:2]
    gamma_c = scal[:, 2:3]

    def _perm_value_stack(adv_lag, lk_lag, dyn_lag, inst_lag):
        # column order of keygen._perm_columns (halo2's enable_equality
        # order: fixed, advice, lookup, instance, dyn)
        parts = []
        if vk.num_fixed:
            parts.append(L.stack([T["lag"][tix[f"fix{i}"]] for i in range(vk.num_fixed)]))
        if na:
            parts.append(adv_lag)
        if nl:
            parts.append(lk_lag)
        if vk.num_instance:
            parts.append(inst_lag)
        if nd:
            parts.append(dyn_lag)
        return L.cat(parts) if parts else empty

    def _compressed_stacks(get_tensor, theta_t, shape_tail):
        """Per-instance theta-compressed (input, table) tensors [ninst, ...]."""
        a_list, s_list = [], []
        for srcs_in, srcs_tbl in inst_srcs:

            def resolve(src):
                if src[0] == "prod":
                    return df._mont_mul(resolve(src[1]), resolve(src[2]))
                return get_tensor(src)

            def fold(srcs):
                acc = None
                for src in srcs:
                    tsr = resolve(src)
                    acc = tsr if acc is None else df._add(df._mont_mul(acc, theta_t), tsr)
                return acc

            a_list.append(fold(srcs_in))
            s_list.append(fold(srcs_tbl))
        if not a_list:
            z = L.zeros(0, shape_tail[-1])
            return z, z
        return L.stack(a_list), L.stack(s_list)

    def _grand_products(ratio):
        """ratio [C, 16, n] (rows >= u already 1) -> (z exclusive, inclusive)."""
        incl = df.prefix_prod(ratio)
        return L.shift(incl, one), incl

    zcols = []
    if ncols:
        sigma_lag = L.stack([T["lag"][tix[f"sigma{ci}"]] for ci in range(ncols)])
        vals = _perm_value_stack(adv_lag, lk_lag, dyn_lag, inst_lag)
        bd = scal[:, 3:].transpose(0, 1)[:, :, None]  # [ncols, 16, 1]
        id_side = df._add(df._add(vals, df._mont_mul(T["omega"][None], bd)), gamma_c)
        sig_side = df._add(df._add(vals, df._mont_mul(sigma_lag, beta_c)), gamma_c)
        width = perm_chunks(ncols)[0][1] - perm_chunks(ncols)[0][0]
        total = nchunks * width
        onepad = L.ones(df, total - ncols, n)
        id_p = L.cat([id_side, onepad]).reshape(nchunks, width, N_LIMBS, n)
        sig_p = L.cat([sig_side, onepad]).reshape(nchunks, width, N_LIMBS, n)
        numer = _tree_prod(df, id_p.transpose(0, 1), L.cat)
        denom = _tree_prod(df, sig_p.transpose(0, 1), L.cat)
        ratio = df._mont_mul(numer, df._batch_inv(denom))
        ratio = L.where(row_lt_u, ratio, one)
        z, incl = _grand_products(ratio)
        # chain chunks: scale_j = prod_{j' < j} z_{j'}[u]
        ends = L.take(incl, u - 1, u)
        scale_incl = _tree_scan_rows(df, ends)
        scale = torch.cat([df.one_mont((1, 1), device), scale_incl[:-1]], dim=0)
        z = L.where(L.rows_below(n, u + 1), df._mont_mul(z, scale), z)
        z = L.put(z, u + 1, zb[:nchunks])
        zcols.append(z)
    if ninst:
        runtime_pre = L.cat([adv_lag, lk_lag, dyn_lag, inst_lag])

        def get_lag(src):
            kind, idx = src
            assert kind in ("rt", "tbl")
            return runtime_pre[idx] if kind == "rt" else T["lag"][idx]

        a_in, t_in = _compressed_stacks(get_lag, scal[:, 0:1], (n,))
        a_p = permuted_lag[0::2]
        s_p = permuted_lag[1::2]
        numer = df._mont_mul(df._add(a_in, beta_c), df._add(t_in, gamma_c))
        denom = df._mont_mul(df._add(a_p, beta_c), df._add(s_p, gamma_c))
        ratio = df._mont_mul(numer, df._batch_inv(denom))
        ratio = L.where(row_lt_u, ratio, one)
        zl, _ = _grand_products(ratio)
        zl = L.put(zl, u + 1, zb[nchunks:])
        zcols.append(zl)
    allz_lag = L.cat(zcols + [rand_lag])
    selfcheck = os.environ.get("HALO2_PROVER_SELFCHECK")
    if selfcheck == "1":
        _selfcheck_h(
            vk, pk, dom, u, advice_vals, lookup_vals, dyn_vals, instance_vals,
            permuted_host, L.gather(allz_lag), insts, _host_col, theta, beta, gamma,
        )
    com3 = rt.commit(allz_lag, "lagA")
    runtime_lag = L.cat([adv_lag, lk_lag, dyn_lag, inst_lag, permuted_lag, allz_lag])
    runtime_coeffs = ntt.inverse_cols(runtime_lag)
    runtime_ext = coset.forward_cols(L.pad(runtime_coeffs, dom.n_ext))
    for pt in host_points(com3):
        tr.write_point(pt)
    _t = stage_end("grand products", _t, sync, timings, "prover")

    y = tr.squeeze_challenge()

    # === quotient on the extended coset ===================================
    K_gates = na
    K_chal = len(vk.challenge_pins)
    K_perm = (2 + (nchunks - 1) + nchunks) if nchunks else 0
    K_lk = 5 * ninst
    K = K_gates + K_chal + K_perm + K_lk
    chal_dev = dom.pack([challenges[c] for c, _, _ in vk.challenge_pins] or [0], device)

    def quotient(ext, ych):
        """sum_i expr_i y^(K-1-i) / Z_H on the extended coset. Each family's
        expressions fold into the sum as soon as they are made and its
        temporaries go (the same field sum as stacking all K at once, so the
        same bytes, with one family's working set on the card at a time)."""
        ne = dom.n_ext
        o = 0
        adv_e, o = ext[o : o + na], o + na
        lk_e, o = ext[o : o + nl], o + nl
        dyn_e, o = ext[o : o + nd], o + nd
        inst_e, o = ext[o : o + vk.num_instance], o + vk.num_instance
        perm_e, o = ext[o : o + 2 * ninst], o + 2 * ninst
        permz_e, o = ext[o : o + nchunks], o + nchunks
        lkz_e, o = ext[o : o + ninst], o + ninst
        beta_e, gamma_e = beta_c, gamma_c
        ypows = dom.pows_of(ych, K).flip(-1)  # y^(K-1) ... y^0, [16, K]
        ycol = ypows.transpose(0, 1)[:, :, None]  # [K, 16, 1]
        acc, done = None, 0

        def fold(exprs):
            """Add the next expressions [m, 16, ne], in order, times their
            powers of y."""
            nonlocal acc, done
            m = exprs.shape[0]
            part = _tree_sum(df, df._mont_mul(exprs, ycol[done : done + m]), L.cat)
            acc = part if acc is None else df._add(acc, part)
            done += m

        def rot(t, r):
            return L.roll(t, -4 * r)

        # 1. gates
        if na:
            sel_e = L.stack([T["ext"][tix[f"sel{i}"]] for i in range(na)])
            g = df._sub(df._add(adv_e, df._mont_mul(rot(adv_e, 1), rot(adv_e, 2))), rot(adv_e, 3))
            fold(df._mont_mul(sel_e, g))
            del sel_e, g

        # 1b. challenge pins: L_row_i * (advice_col - challenge)
        pins = []
        for i, (_c, flat_col, _row) in enumerate(vk.challenge_pins):
            q_e = T["ext"][tix[f"pinrow{i}"]]
            diff = df._sub(adv_e[flat_col], chal_dev[:, i : i + 1])
            pins.append(df._mont_mul(q_e, diff))
        if pins:
            fold(L.stack(pins))
        del pins

        # 2. permutation
        if nchunks:
            ends = [df._mont_mul(T["l0_e"], df._sub(one, permz_e[0]))]
            zl = permz_e[-1]
            ends.append(df._mont_mul(T["llast_e"], df._sub(df._mont_mul(zl, zl), zl)))
            for j in range(1, nchunks):
                ends.append(df._mont_mul(T["l0_e"], df._sub(permz_e[j], rot(permz_e[j - 1], u))))
            fold(L.stack(ends))
            del ends, zl
            parts = []
            if vk.num_fixed:
                parts.append(L.stack([T["ext"][tix[f"fix{i}"]] for i in range(vk.num_fixed)]))
            if na:
                parts.append(adv_e)
            if nl:
                parts.append(lk_e)
            if vk.num_instance:
                parts.append(inst_e)
            if nd:
                parts.append(dyn_e)
            vals_e = L.cat(parts)
            del parts
            sigma_e = L.stack([T["ext"][tix[f"sigma{ci}"]] for ci in range(ncols)])
            bd = scal[:, 3:].transpose(0, 1)[:, :, None]
            width = perm_chunks(ncols)[0][1] - perm_chunks(ncols)[0][0]
            onep = L.ones(df, nchunks * width - ncols, ne)
            lf = df._add(df._add(vals_e, df._mont_mul(sigma_e, beta_e)), gamma_e)
            del sigma_e
            lf = L.cat([lf, onep]).reshape(nchunks, width, N_LIMBS, ne)
            left = df._mont_mul(rot(permz_e, 1), _tree_prod(df, lf.transpose(0, 1), L.cat))
            del lf
            rf = df._add(df._add(vals_e, df._mont_mul(T["x_poly_e"][None], bd)), gamma_e)
            del vals_e
            rf = L.cat([rf, onep]).reshape(nchunks, width, N_LIMBS, ne)
            right = df._mont_mul(permz_e, _tree_prod(df, rf.transpose(0, 1), L.cat))
            del rf, onep
            fold(df._mont_mul(T["lact_e"][None], df._sub(left, right)))
            del left, right

        # 3. lookups (theta-compressed input/table expressions per instance)
        if ninst:
            runtime_pre_e = L.cat([adv_e, lk_e, dyn_e, inst_e])

            def get_ext(src):
                kind, idx = src
                return runtime_pre_e[idx] if kind == "rt" else T["ext"][idx]

            a_in_e, t_in_e = _compressed_stacks(get_ext, scal[:, 0:1], (ne,))
            del runtime_pre_e
            a_p_e = perm_e[0::2]
            s_p_e = perm_e[1::2]
            l0b = T["l0_e"][None]
            llb = T["llast_e"][None]
            lab = T["lact_e"][None]
            e1 = df._mont_mul(l0b, df._sub(one, lkz_e))
            e2 = df._mont_mul(llb, df._sub(df._mont_mul(lkz_e, lkz_e), lkz_e))
            left = df._mont_mul(
                df._mont_mul(rot(lkz_e, 1), df._add(a_p_e, beta_e)), df._add(s_p_e, gamma_e)
            )
            right = df._mont_mul(
                df._mont_mul(lkz_e, df._add(a_in_e, beta_e)), df._add(t_in_e, gamma_e)
            )
            e3 = df._mont_mul(lab, df._sub(left, right))
            del left, right, a_in_e, t_in_e
            diff = df._sub(a_p_e, s_p_e)
            e4 = df._mont_mul(l0b, diff)
            e5 = df._mont_mul(df._mont_mul(lab, diff), df._sub(a_p_e, rot(a_p_e, -1)))
            # instance-major: e1..e5 of instance 0, then of instance 1, ...
            fold(L.stack([e1, e2, e3, e4, e5], dim=1).reshape(5 * ninst, N_LIMBS, ne))

        assert done == K
        return df._mont_mul(acc, T["zh_inv"])

    if selfcheck == "2":
        _selfcheck_roundtrip(L, ntt, coset, n, (
            ("runtime", runtime_lag, runtime_ext), ("tables", rt.tbl_lag, rt.tbl_ext)))
    h_ext = quotient(runtime_ext, dom.pack([y], device))
    h_coeffs = coset.inverse_cols(h_ext[None])[0]
    # quotient pieces: j = cs_degree - 1 (halo2 quotient_poly_degree); the top
    # (cs_degree - 1) coefficients of the pieces must vanish too
    npieces = quotient_pieces(vk)
    top_zero = bool((L.take(h_coeffs, npieces * n - npieces, dom.n_ext) == 0).all())
    h_pieces = L.pieces(h_coeffs, npieces, n)
    # degree guard BEFORE the commitments enter the transcript
    assert top_zero, "quotient degree overflow"
    com4 = rt.commit(h_pieces, "monoA")
    for pt in host_points(com4):
        tr.write_point(pt)
    _t = stage_end("quotient", _t, sync, timings, "prover")

    x = tr.squeeze_challenge()
    pts = point_values(x, k)
    plan = query_plan(vk)

    # === evals =============================================================
    point_list = sorted({pl for _, pls in plan for pl in pls})
    by_point = {pl: [lb for lb, pls in plan if pl in pls] for pl in point_list}
    xc = pow(x, n, P)
    h_scal = dom.pack([pow(xc, i, P) for i in range(npieces)], device)  # [16, npieces]
    h_comb = _tree_sum(df, df._mont_mul(h_pieces, h_scal.transpose(0, 1)[:, :, None]), L.cat)

    evals: dict[str, dict[str, int]] = {lb: {} for lb, _ in plan}
    for pi, pl in enumerate(point_list):
        stack = []
        for lb in by_point[pl]:
            src, idx = _src(lb)
            if src == "rt":
                stack.append(runtime_coeffs[idx])
            elif src == "h":
                stack.append(h_comb)
            else:
                stack.append(T["coeff"][idx])
        stack = L.stack(stack)  # [labels, 16, n]
        xp = L.powers(rt.df, pts[pl], n)  # [16, n]
        vals = df._from_mont(L.sum_lanes(rt.df, df._mont_mul(stack, xp[None])))  # [labels, 16, 1]
        host = limbs_to_ints(vals[:, :, 0].cpu().numpy())
        for lb, v in zip(by_point[pl], host):
            evals[lb][pl] = v
    for label, pts_labels in plan:
        for pl in pts_labels:
            tr.write_scalar(evals[label][pl])
    _t = stage_end("evals", _t, sync, timings, "prover")

    # === SHPLONK h_open ====================================================
    v = tr.squeeze_challenge()
    w_ch = tr.squeeze_challenge()
    groups = group_queries(plan)

    # host: per-group v-RLC'd evals and low-degree interpolants r_j
    r_coeffs_per_group = []
    for pts_labels, labels in groups:
        ge = {pl: 0 for pl in pts_labels}
        vpow = 1
        for label in labels:
            for pl in pts_labels:
                ge[pl] = (ge[pl] + vpow * evals[label][pl]) % P
            vpow = vpow * v % P
        pvals = [pts[pl] for pl in pts_labels]
        r_coeffs_per_group.append(lagrange_interpolate(pvals, [ge[pl] for pl in pts_labels]))

    W = T["omega"]  # [16, n]
    h_lag = ntt.forward_cols(h_comb[None])[0]
    g_forms, nums, zs_on_h = [], [], []
    for gi, (pts_labels, labels) in enumerate(groups):
        stack = []
        for lb in labels:
            src, idx = _src(lb)
            if src == "rt":
                stack.append(runtime_lag[idx])
            elif src == "h":
                stack.append(h_lag)
            else:
                stack.append(T["lag"][idx])
        stack = L.stack(stack)  # [labels, 16, n]
        vcol = dom.pack([pow(v, i, P) for i in range(len(labels))], device)
        g_forms.append(_tree_sum(df, df._mont_mul(stack, vcol.transpose(0, 1)[:, :, None]), L.cat))
        # g_j - r_j on H (r_j by Horner) and Z_{S_j} on H
        r = dom.pack(r_coeffs_per_group[gi], device)  # [16, deg + 1]
        acc = r[:, -1:]
        for d in range(r.shape[1] - 2, -1, -1):
            acc = df._add(df._mont_mul(acc, W), r[:, d : d + 1])
        nums.append(df._sub(g_forms[-1], acc))
        s = dom.pack([pts[pl] for pl in pts_labels], device)
        zs = df._sub(W, s[:, 0:1])
        for d in range(1, s.shape[1]):
            zs = df._mont_mul(zs, df._sub(W, s[:, d : d + 1]))
        zs_on_h.append(zs)
    gstack = L.stack(g_forms)  # [ngroups, 16, n]
    inv_zs = df._batch_inv(L.stack(zs_on_h))
    num = L.stack(nums)
    wpows = []
    wp = 1
    for _ in groups:
        wpows.append(wp)
        wp = wp * w_ch % P
    wcol = dom.pack(wpows, device).transpose(0, 1)[:, :, None]  # [ngroups, 16, 1]
    h_open_lag = _tree_sum(df, df._mont_mul(df._mont_mul(num, inv_zs), wcol), L.cat)
    h_open_coeffs = ntt.inverse_cols(h_open_lag[None])[0]
    com6 = rt.commit(h_open_coeffs[None], "monoA")
    tr.write_point(host_points(com6)[0])

    u_ch = tr.squeeze_challenge()

    # === SHPLONK q ==========================================================
    all_points = sorted({pts[pl] for plan_pts, _ in groups for pl in plan_pts})
    zt_u = poly_eval(vanishing_poly(all_points), u_ch)
    scale_list = []
    ru_list = []
    wp = 1
    for gi, (pts_labels, _) in enumerate(groups):
        pvals = [pts[pl] for pl in pts_labels]
        others = [pt for pt in all_points if pt not in pvals]
        scale_list.append(wp * poly_eval(vanishing_poly(others), u_ch) % P)
        ru_list.append(poly_eval(r_coeffs_per_group[gi], u_ch))
        wp = wp * w_ch % P
    rucol = dom.pack(ru_list, device).transpose(0, 1)[:, :, None]
    sccol = dom.pack(scale_list, device).transpose(0, 1)[:, :, None]
    L_acc = _tree_sum(df, df._mont_mul(df._sub(gstack, rucol), sccol), L.cat)
    L_acc = df._sub(L_acc, df._mont_mul(h_open_lag, dom.pack([zt_u], device)))
    inv_xu = df._batch_inv(df._sub(W, dom.pack([u_ch], device)))
    q_evals = df._mont_mul(L_acc, inv_xu)
    q_coeffs = ntt.inverse_cols(q_evals[None])[0]
    com7 = rt.commit(q_coeffs[None], "monoA")
    tr.write_point(host_points(com7)[0])
    _t = stage_end("shplonk", _t, sync, timings, "prover")
    return tr.finalize()


def _tree_scan_rows(df, ends):
    """Inclusive product scan along axis 0 of [C, 16, 1] (the JAX package's
    associative_scan over the chunk axis; log-depth)."""
    x = ends
    C = x.shape[0]
    d = 1
    while d < C:
        x = torch.cat([x[:d], df._mont_mul(x[d:], x[:-d])], dim=0)
        d *= 2
    return x
