"""Key generation: VerifyingKey / ProvingKey for the PlonKish KZG prover.

The port of ``halo2_lib_tpu/backend/keygen.py`` (halo2-axiom's `keygen_vk` /
`keygen_pk`). From a synthesized `PhysicalCircuit` we derive:
  * the fixed polynomials: one selector poly per gate-advice column, the
    constant (fixed) columns, and the range-lookup table column;
  * the permutation argument: equality-enabled columns (gate advice, lookup
    advice, fixed, instance), cycle-closed sigma polynomials over delta-coset
    labels (halo2's permutation keygen);
  * commitments to all of the above (the verifying key), one batched MSM on
    the device.

Constraint-system shape (BaseConfig, gates/circuit.py):
  gate per advice column i:  q_i * (a_i + a_i(w) * a_i(w2) - a_i(w3))
  lookup per lookup column j: L_j in table T   (plus optional q_lookup * a_0)
  permutation over all equality-enabled columns.
Degree 4 (lookup active-row constraint) -> extended domain 4n, permutation
chunk length 2, blinding factors B = 8 (usable rows n - 9, matching the
builder's DEFAULT_MINIMUM_ROWS, circuit.py:24).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field as dc_field

import torch

from ..gates.circuit import BaseCircuitBuilder, PhysicalCircuit
from ..utils.device import resolve_device, stage_end
from ..utils.fields import FR_BN254
from .kzg import ParamsKZG, host_points
from .poly import domain as get_domain

BLINDING_FACTORS = 8
CS_DEGREE = 4
PERM_CHUNK = CS_DEGREE - 2  # halo2: chunk = degree - 2

# delta: generator of the "extended" coset labels (halo2curves Fr::DELTA = g^{2^S})
DELTA = pow(FR_BN254.generator, 1 << FR_BN254.s, FR_BN254.p)


@dataclass
class ColumnRef:
    """A permutation-participating column: kind in {advice, lookup, fixed, instance}.

    `index` is the flat PHASE-MAJOR index within the kind (all phase-0 advice
    columns, then phase-1, ...); `phase` is kept for physical-cell resolution.
    """

    kind: str
    index: int
    phase: int = 0

    def key(self):
        return (self.kind, self.index)


@dataclass
class VerifyingKey:
    k: int
    params_n: int
    num_advice: int  # total gate-advice columns over all phases
    num_lookup: int  # total lookup-advice columns over all phases
    num_fixed: int
    num_instance: int
    lookup_bits: int | None
    uses_q_lookup: bool
    selector_commitments: list
    fixed_commitments: list
    table_commitment: object | None
    q_lookup_commitment: object | None
    permutation_commitments: list
    perm_columns: list[ColumnRef] = dc_field(default_factory=list)
    # per-phase column counts; advice of phase t commits before the phase-t
    # challenge squeeze (halo2 challenge phases, flex_gate/mod.rs:63-67)
    num_advice_per_phase: list[int] = dc_field(default_factory=list)
    num_lookup_per_phase: list[int] = dc_field(default_factory=list)
    # challenge pins: (challenge index, flat advice col, row). The constraint
    # L_row(X) * (a_col(X) - challenge) = 0 is STRUCTURAL — like halo2's
    # Challenge API, the challenge is a symbol in the constraint system and
    # no extra fixed column or commitment exists for it; the verifier
    # computes L_row(x) in closed form (flex_gate/mod.rs:63-67 challenge
    # usage; virtual_region/tests/lookups/memory.rs).
    challenge_pins: list = dc_field(default_factory=list)
    # dynamic lookups: KEY_COL per set; per set two fixed is_enabled columns
    # (key_en, table_en) committed in dynen order [set0 key, set0 table, ...]
    dyn_key_cols: list = dc_field(default_factory=list)
    dynen_commitments: list = dc_field(default_factory=list)

    def num_phases(self) -> int:
        return max(len(self.num_advice_per_phase), 1)

    def to_bytes(self) -> bytes:
        """Canonical byte serialization (role of halo2's vk.write: shape
        header + every commitment point; no Python repr anywhere)."""

        def pt(b, p):
            if p is None:
                b += b"\x00" * 64
            else:
                b += p[0].to_bytes(32, "little") + p[1].to_bytes(32, "little")
            return b

        out = bytearray(b"halo2_lib_tpu_vk_v3")
        for v in (
            self.k, self.params_n, self.num_advice, self.num_lookup,
            self.num_fixed, self.num_instance,
            -1 if self.lookup_bits is None else self.lookup_bits,
            1 if self.uses_q_lookup else 0,
            len(self.perm_columns),
        ):
            out += int(v).to_bytes(8, "little", signed=True)
        for counts in (self.num_advice_per_phase, self.num_lookup_per_phase):
            out += len(counts).to_bytes(4, "little")
            for v in counts:
                out += int(v).to_bytes(4, "little")
        for c in self.perm_columns:
            out += c.kind.encode() + b"\x00"
            out += int(c.index).to_bytes(4, "little") + int(c.phase).to_bytes(4, "little")
        out += len(self.challenge_pins).to_bytes(4, "little")
        for c, col, row in self.challenge_pins:
            out += (
                int(c).to_bytes(4, "little")
                + int(col).to_bytes(4, "little")
                + int(row).to_bytes(4, "little")
            )
        out += len(self.dyn_key_cols).to_bytes(4, "little")
        for kc in self.dyn_key_cols:
            out += int(kc).to_bytes(4, "little")
        for group in (
            self.selector_commitments,
            self.fixed_commitments,
            [self.table_commitment, self.q_lookup_commitment],
            self.permutation_commitments,
            self.dynen_commitments,
        ):
            out += len(group).to_bytes(4, "little")
            for p in group:
                out = pt(out, p)
        return bytes(out)

    @staticmethod
    def from_bytes(data: bytes) -> "VerifyingKey":
        """Inverse of to_bytes (carries a JAX-made key across, convert.py)."""
        magic = b"halo2_lib_tpu_vk_v3"
        assert data[: len(magic)] == magic, "not a vk byte string"
        off = len(magic)

        def take(nb, signed=False):
            nonlocal off
            v = int.from_bytes(data[off : off + nb], "little", signed=signed)
            off += nb
            return v

        k, params_n, na, nl, nf, ni, lb, uq, ncols = (take(8, True) for _ in range(9))
        na_p = [take(4) for _ in range(take(4))]
        nl_p = [take(4) for _ in range(take(4))]
        cols = []
        for _ in range(ncols):
            end = data.index(b"\x00", off)
            kind = data[off:end].decode()
            off = end + 1
            cols.append(ColumnRef(kind, take(4), take(4)))
        pins = [(take(4), take(4), take(4)) for _ in range(take(4))]
        dyn_key_cols = [take(4) for _ in range(take(4))]

        def pt():
            x, y = take(32), take(32)
            return None if x == 0 and y == 0 else (x, y)

        groups = [[pt() for _ in range(take(4))] for _ in range(5)]
        assert off == len(data), "trailing bytes after the vk"
        return VerifyingKey(
            k=k,
            params_n=params_n,
            num_advice=na,
            num_lookup=nl,
            num_fixed=nf,
            num_instance=ni,
            lookup_bits=None if lb == -1 else lb,
            uses_q_lookup=bool(uq),
            selector_commitments=groups[0],
            fixed_commitments=groups[1],
            table_commitment=groups[2][0],
            q_lookup_commitment=groups[2][1],
            permutation_commitments=groups[3],
            perm_columns=cols,
            num_advice_per_phase=na_p,
            num_lookup_per_phase=nl_p,
            challenge_pins=pins,
            dyn_key_cols=dyn_key_cols,
            dynen_commitments=groups[4],
        )

    def hash(self) -> bytes:
        h = hashlib.blake2b(person=b"Halo2-VKey-Hash")
        h.update(self.to_bytes())
        return h.digest()

    def pinned_debug(self) -> str:
        """`format!("{:?}", vk.pinned())` — the Rust Debug rendering of the
        pinned verification key (backend/pinned.py), rebuilt from this vk."""
        from .pinned import pinned_debug_string
        from .protocol import quotient_pieces

        omega = FR_BN254.nth_root_of_unity(self.k)
        j = quotient_pieces(self)
        extended_k = self.k + max((j - 1).bit_length(), 1)
        return pinned_debug_string(self, omega, extended_k)

    def transcript_repr(self) -> int:
        """The vk as an Fr scalar, absorbed at transcript init — halo2's
        `VerifyingKey::transcript_repr` exactly: blake2b-512 with
        personalization "Halo2-Verify-Key" over the u64-LE length-prefixed
        Rust-Debug string of the pinned verification key, reduced via
        from_uniform_bytes (keygen.rs). The Debug string reconstruction
        lives in backend/pinned.py; PARITY.md lists its conventions."""
        s = self.pinned_debug().encode()
        h = hashlib.blake2b(person=b"Halo2-Verify-Key")
        h.update(len(s).to_bytes(8, "little"))
        h.update(s)
        return int.from_bytes(h.digest(), "little") % FR_BN254.p


@dataclass
class ProvingKey:
    vk: VerifyingKey
    # host int column values, length n each
    selectors: list[list[int]]
    fixed_cols: list[list[int]]
    table_col: list[int] | None
    q_lookup_col: list[int] | None
    perm_values: object  # sigma columns, int32[ncols, 16, n] device Montgomery tensor
    break_points: list[list[int]]
    config_params: object
    dynen_cols: list[list[int]] = dc_field(default_factory=list)
    # dyn advice column values are witness data, re-derived per proof


def _col_counts_per_phase(circuit: PhysicalCircuit) -> tuple[list[int], list[int]]:
    """(advice, lookup) column counts per phase, trailing zero phases trimmed.

    In the single-advice-column q_lookup case no dedicated lookup-advice
    columns exist (the q_lookup selector gates the main column instead,
    reference range/mod.rs:88-108), whatever the config says."""
    na_p = list(circuit.params.num_advice_per_phase)
    nl_p = list(circuit.params.num_lookup_advice_per_phase)
    if any(circuit.q_lookup_rows):
        nl_p = [0] * len(nl_p)
    nphases = max(len(na_p), len(nl_p), 1)
    na_p += [0] * (nphases - len(na_p))
    nl_p += [0] * (nphases - len(nl_p))
    while nphases > 1 and na_p[-1] == 0 and nl_p[-1] == 0:
        na_p.pop(), nl_p.pop()
        nphases -= 1
    return na_p, nl_p


def _perm_columns(circuit: PhysicalCircuit) -> list[ColumnRef]:
    """Permutation argument columns in halo2's enable_equality call order:
    constant FIXED columns first (FlexGateConfig::configure creates and
    equality-enables them before any gate column, flex_gate/mod.rs:124-131),
    then gate advice per phase, lookup advice, instance, dyn advice. The
    position in this list fixes each column's delta^i labeling, so matching
    halo2's order is required for sigma/proof byte parity."""
    cols: list[ColumnRef] = []
    na_p, nl_p = _col_counts_per_phase(circuit)
    for i in range(circuit.params.num_fixed):
        cols.append(ColumnRef("fixed", i))
    flat = 0
    for phase, n in enumerate(na_p):
        for _ in range(n):
            cols.append(ColumnRef("advice", flat, phase))
            flat += 1
    flat = 0
    for phase, n in enumerate(nl_p):
        for _ in range(n):
            cols.append(ColumnRef("lookup", flat, phase))
            flat += 1
    for i in range(circuit.params.num_instance_columns):
        cols.append(ColumnRef("instance", i))
    flat = 0
    for s in circuit.dyn_sets:
        for _ in range(2 * s["key_col"]):
            cols.append(ColumnRef("dynadv", flat))
            flat += 1
    return cols


def _build_permutation(circuit: PhysicalCircuit, n: int, cols: list[ColumnRef]):
    """halo2 permutation keygen: label cell (c, r) with delta^c * omega^r, close
    copy cycles, sigma_c(row) = label of the next cell in the cycle.

    Returns int32 index arrays (nc, nr) of shape [ncols, n]: the (column, row)
    of the NEXT cell in each cycle (identity where uncopied). The sigma VALUES
    delta^nc * omega^nr are then one gather + Montgomery multiply on device —
    no O(ncols * n) host bigint loop."""
    import numpy as np
    # physical (kind, phase, col-in-phase) -> position in the flat column list
    na_p, nl_p = _col_counts_per_phase(circuit)
    col_pos: dict = {}
    pos = 0
    for i in range(circuit.params.num_fixed):
        col_pos[("fixed", 0, i)] = pos
        pos += 1
    for phase, cnt in enumerate(na_p):
        for c in range(cnt):
            col_pos[("advice", phase, c)] = pos
            pos += 1
    for phase, cnt in enumerate(nl_p):
        for c in range(cnt):
            col_pos[("lookup", phase, c)] = pos
            pos += 1
    for i in range(circuit.params.num_instance_columns):
        col_pos[("instance", 0, i)] = pos
        pos += 1
    flat = 0
    for s in circuit.dyn_sets:
        for _ in range(2 * s["key_col"]):
            col_pos[("dynadv", 0, flat)] = pos
            flat += 1
            pos += 1
    assert pos == len(cols)

    # union-find over (col_idx, row)
    parent: dict = {}

    def find(x):
        root = x
        while parent.get(root, root) != root:
            root = parent[root]
        while parent.get(x, x) != x:
            parent[x], x = root, parent[x]
        return root

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    def to_cell(phys):
        kind, phase, col, row = phys
        return (col_pos[(kind, phase, col)], row)

    for left, right in circuit.copies:
        union(to_cell(left), to_cell(right))

    # group cycle members
    groups: dict = {}
    for cell in list(parent.keys()):
        groups.setdefault(find(cell), []).append(cell)

    # identity mapping by default: next(c, r) = (c, r)
    ncols = len(cols)
    nc = np.tile(np.arange(ncols, dtype=np.int32)[:, None], (1, n))
    nr = np.tile(np.arange(n, dtype=np.int32)[None, :], (ncols, 1))
    for root, members in groups.items():
        if root not in members:
            members.append(root)
        members = sorted(set(members))
        # cyclic shift: sigma(cell_i) = label(cell_{i+1})
        for i, (c, r) in enumerate(members):
            c2, r2 = members[(i + 1) % len(members)]
            nc[c, r], nr[c, r] = c2, r2
    return nc, nr


def sigma_mont_device(df, dom, nc, nr, device):
    """[ncols, 16, n] Montgomery sigma values delta^nc * omega^nr: two lane
    gathers and one mont_mul launch on `device`."""
    from ..ops.ntt import pows_host

    delta_pows = pows_host(df, DELTA, max(nc.shape[0], 1), device)  # [16, ncols]
    omega_pows = dom.omega_pows_dev(device)  # [16, n]
    ncd = torch.from_numpy(nc).to(device=device, dtype=torch.int64)
    nrd = torch.from_numpy(nr).to(device=device, dtype=torch.int64)
    d = delta_pows[:, ncd].transpose(0, 1)
    o = omega_pows[:, nrd].transpose(0, 1)
    return df._mont_mul(d, o)


def _pad(col: list[int], n: int) -> list[int]:
    assert len(col) <= n
    return list(col) + [0] * (n - len(col))


@torch.inference_mode()
def keygen(
    params: ParamsKZG,
    builder: BaseCircuitBuilder,
    circuit: PhysicalCircuit | None = None,
    device=None,
    timings: dict | None = None,
) -> ProvingKey:
    """keygen_pk2-equivalent: synthesize once, derive vk+pk (utils/halo2.rs:135).
    Device work (sigma values, every commitment) runs on `device`, the CUDA
    card unless the caller asks for another. A `timings` dict receives the
    seconds of each stage (device work included)."""
    import time as _time

    device = resolve_device(device)
    _t = _time.time()

    def _kstage(label):
        nonlocal _t
        _t = stage_end(label, _t, device, timings, "keygen")

    if circuit is None:
        circuit = builder.synthesize()
        _kstage("synthesize")
    k = circuit.params.k
    n = 1 << k
    assert params.k >= k, "SRS too small for circuit"
    dom = get_domain(k)

    na_p, nl_p = _col_counts_per_phase(circuit)
    na, nl = sum(na_p), sum(nl_p)

    # selectors per gate column, phase-major over all phases
    selectors = []
    for phase, ncols in enumerate(na_p):
        fp = circuit.phases[phase] if phase < len(circuit.phases) else None
        for i in range(ncols):
            sel = [0] * n
            if fp and i < len(fp.selectors):
                for r, q in enumerate(fp.selectors[i]):
                    sel[r] = 1 if q else 0
            selectors.append(sel)

    fixed_cols = [_pad(c, n) for c in circuit.fixed_cols]

    lookup_bits = circuit.params.lookup_bits
    uses_q_lookup = any(circuit.q_lookup_rows)
    table_col = None
    q_lookup_col = None
    if lookup_bits is not None and (nl > 0 or uses_q_lookup):
        table_col = _pad(list(range(1 << lookup_bits)), n)
        assert (1 << lookup_bits) <= n - BLINDING_FACTORS - 1, "lookup table too big for k"
    if uses_q_lookup:
        q_lookup_col = [0] * n
        for r in circuit.q_lookup_rows[0]:
            q_lookup_col[r] = 1

    _kstage("selectors+fixed")
    perm_cols = _perm_columns(circuit)
    nc_arr, nr_arr = _build_permutation(circuit, n, perm_cols)
    _kstage("permutation cycles")

    # challenge pins: the structural constraint L_row * (a_col - challenge)
    # (gates/circuit.py constrain_challenge). No fixed column, no commitment:
    # (c, flat col, row) in the vk bytes IS the constraint — the challenge is
    # a queryable symbol of the constraint system, matching halo2's Challenge
    # API shape, and the vk column inventory equals the single-phase one.
    adv_phase_offsets = [0]
    for cnt in na_p:
        adv_phase_offsets.append(adv_phase_offsets[-1] + cnt)
    challenge_pins: list[tuple[int, int, int]] = []
    for c, phase, col, row in circuit.challenge_pins:
        challenge_pins.append((c, adv_phase_offsets[phase] + col, row))

    # dynamic-lookup fixed is_enabled columns ([set0 key_en, set0 table_en, ...])
    dyn_key_cols = [s["key_col"] for s in circuit.dyn_sets]
    dynen_cols: list[list[int]] = []
    for s in circuit.dyn_sets:
        assert len(s["key_en"]) <= n - BLINDING_FACTORS - 1, "dyn lookups exceed usable rows"
        assert len(s["table_en"]) <= n - BLINDING_FACTORS - 1, "dyn table exceeds usable rows"
        dynen_cols.append(_pad(s["key_en"], n))
        dynen_cols.append(_pad(s["table_en"], n))

    # commitments: ALL pk columns in ONE batched Lagrange-basis MSM
    from .prover import _lag_from_u16, _u16_cols

    all_cols = list(selectors) + list(fixed_cols)
    if table_col is not None:
        all_cols.append(table_col)
    if q_lookup_col is not None:
        all_cols.append(q_lookup_col)
    all_cols.extend(dynen_cols)
    df = dom.df

    sigma_mont = sigma_mont_device(df, dom, nc_arr, nr_arr, device)
    _kstage("sigma device build")
    cols_u16 = _u16_cols(all_cols, n)
    _kstage("u16 packing")
    bases = params.affine_lagrange_bases(device)
    _kstage("lagrange base packing")
    all_lag = torch.cat([_lag_from_u16(df, cols_u16, device), sigma_mont], dim=0)
    pts = host_points(params.commit_columns(df, all_lag, bases))
    _kstage("commit dispatch")
    nsigma = len(perm_cols)
    o = 0
    selector_commitments = pts[o : o + len(selectors)]
    o += len(selectors)
    fixed_commitments = pts[o : o + len(fixed_cols)]
    o += len(fixed_cols)
    table_commitment = None
    if table_col is not None:
        table_commitment = pts[o]
        o += 1
    q_lookup_commitment = None
    if q_lookup_col is not None:
        q_lookup_commitment = pts[o]
        o += 1
    dynen_commitments = pts[o : o + len(dynen_cols)]
    o += len(dynen_cols)
    permutation_commitments = pts[o : o + nsigma]

    vk = VerifyingKey(
        k=k,
        params_n=params.n,
        num_advice=na,
        num_lookup=nl,
        num_advice_per_phase=na_p,
        num_lookup_per_phase=nl_p,
        num_fixed=circuit.params.num_fixed,
        num_instance=circuit.params.num_instance_columns,
        lookup_bits=lookup_bits,
        uses_q_lookup=uses_q_lookup,
        selector_commitments=selector_commitments,
        fixed_commitments=fixed_commitments,
        table_commitment=table_commitment,
        q_lookup_commitment=q_lookup_commitment,
        permutation_commitments=permutation_commitments,
        perm_columns=perm_cols,
        challenge_pins=challenge_pins,
        dyn_key_cols=dyn_key_cols,
        dynen_commitments=dynen_commitments,
    )
    break_points = []
    try:
        break_points = builder.break_points()
    except AssertionError:
        pass
    return ProvingKey(
        vk=vk,
        selectors=selectors,
        fixed_cols=fixed_cols,
        table_col=table_col,
        q_lookup_col=q_lookup_col,
        perm_values=sigma_mont,
        break_points=break_points,
        config_params=circuit.params,
        dynen_cols=dynen_cols,
    )
