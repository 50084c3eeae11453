"""halo2 `PinnedVerificationKey` Rust-Debug string reconstruction.

halo2's `VerifyingKey::transcript_repr` hashes `format!("{:?}", vk.pinned())`
— the compact Rust Debug rendering of the pinned verification key — with
blake2b-512 (personalization "Halo2-Verify-Key", u64-LE length prefix).
This module rebuilds that string from our VerifyingKey's own data so the
transcript seed matches what halo2-axiom would produce for the same circuit
shape (SURVEY.md §2.9; the external halo2-axiom crate is not vendored with
the reference sources, so the Debug shapes follow the PSE-halo2 lineage the
fork derives from).

Reconstruction notes (kept byte-stable; pinned as a golden in
tests/test_parity_golden.py):

* Columns, queries and gates are regenerated by replaying
  `BaseConfig::configure` exactly (gates/circuit/mod.rs:74-95 —
  RangeConfig::configure creates the table column, FlexGateConfig creates
  constants then per-column gates, then lookup-advice columns, then
  instance columns; flex_gate/mod.rs:62-92, range/mod.rs:71-150).
* Selectors are rendered in their directly-converted-to-fixed form (one
  fixed column per selector, gate `Selector` expressions replaced by
  `Fixed` queries appended after configure) — matching our vk model, where
  every selector is a committed fixed column. halo2's optional selector
  COMPRESSION would pack selectors into shared fixed columns with
  interpolated expressions; no Rust toolchain exists in this image to diff
  against, so the uncompressed form is the pinned convention (PARITY.md).
* `lookup::Argument`'s Debug skips the argument name (halo2 excludes it so
  vk hashes don't depend on labels).
* Field elements print as 0x-prefixed 64-nibble big-endian hex; curve
  points as `(x, y)` with `Infinity` for the identity — halo2curves Debug.
"""

from __future__ import annotations

from .fields import FQ_BN254, FR_BN254


def _fe(v: int) -> str:
    return f"0x{v % FR_BN254.p:064x}"


def _pt(p) -> str:
    if p is None:
        return "Infinity"
    return f"(0x{p[0]:064x}, 0x{p[1]:064x})"


def _col(index: int, kind: str, phase: int = 0) -> str:
    if kind == "Advice" and phase:
        kind = f"Advice {{ phase: Phase({phase}) }}"
    return f"Column {{ index: {index}, column_type: {kind} }}"


def _advice_q(qi: int, ci: int, rot: int, phase: int = 0) -> str:
    s = f"Advice {{ query_index: {qi}, column_index: {ci}, rotation: Rotation({rot})"
    if phase:
        s += f", phase: Phase({phase})"
    return s + " }"


def _fixed_q(qi: int, ci: int, rot: int = 0) -> str:
    return f"Fixed {{ query_index: {qi}, column_index: {ci}, rotation: Rotation({rot}) }}"


def _instance_q(qi: int, ci: int, rot: int = 0) -> str:
    return f"Instance {{ query_index: {qi}, column_index: {ci}, rotation: Rotation({rot}) }}"


def pinned_debug_string(vk, omega: int, extended_k: int) -> str:
    """The `format!("{:?}", vk.pinned())` string for this verifying key."""
    na_p = list(vk.num_advice_per_phase or [vk.num_advice])
    nl_p = list(vk.num_lookup_per_phase or ([vk.num_lookup] if vk.num_lookup else []))
    while len(nl_p) < len(na_p):
        nl_p.append(0)
    n_gate = sum(na_p)
    n_lk = sum(nl_p)
    has_table = vk.table_commitment is not None
    uses_q = bool(getattr(vk, "uses_q_lookup", False))
    nd = 2 * sum(vk.dyn_key_cols)
    n_dynen = len(vk.dynen_commitments)

    # --- column index spaces (creation order) ------------------------------
    # fixed: [table?] [constants...] [converted gate selectors...] [q_lookup?]
    #        [dynen...]
    table_ci = 0 if has_table else None
    const_ci = [(1 if has_table else 0) + i for i in range(vk.num_fixed)]
    sel_base = (1 if has_table else 0) + vk.num_fixed
    sel_ci = [sel_base + i for i in range(n_gate)]
    qlk_ci = sel_base + n_gate if uses_q else None
    dynen_ci = [
        sel_base + n_gate + (1 if uses_q else 0) + i for i in range(n_dynen)
    ]
    num_fixed_columns = sel_base + n_gate + (1 if uses_q else 0) + n_dynen
    # advice: gate columns per phase, then lookup-advice per phase, then dyn
    adv_phase: list[int] = []
    for ph, c in enumerate(na_p):
        adv_phase.extend([ph] * c)
    lk_base = n_gate
    for ph, c in enumerate(nl_p):
        adv_phase.extend([ph] * c)
    dyn_base = n_gate + n_lk
    adv_phase.extend([0] * nd)
    num_advice_columns = n_gate + n_lk + nd

    # --- queries (registration order) --------------------------------------
    advice_queries: list[tuple[int, int]] = []  # (column_index, rotation)
    adv_q_index: dict[tuple[int, int], int] = {}

    def q_advice(ci: int, rot: int) -> int:
        key = (ci, rot)
        if key not in adv_q_index:
            adv_q_index[key] = len(advice_queries)
            advice_queries.append(key)
        return adv_q_index[key]

    fixed_queries: list[tuple[int, int]] = []
    fix_q_index: dict[tuple[int, int], int] = {}

    def q_fixed(ci: int, rot: int = 0) -> int:
        key = (ci, rot)
        if key not in fix_q_index:
            fix_q_index[key] = len(fixed_queries)
            fixed_queries.append(key)
        return fix_q_index[key]

    # FlexGateConfig::configure: constants (enable_equality -> cur query),
    # then per gate column: enable_equality (cur) + gate rotations 0..=3
    for ci in const_ci:
        q_fixed(ci)
    for i in range(n_gate):
        for rot in (0, 1, 2, 3):
            q_advice(i, rot)
    # RangeConfig: lookup-advice enable_equality queries
    for j in range(n_lk):
        q_advice(lk_base + j, 0)
    # lookups register the table fixed query at first use
    if has_table:
        q_fixed(table_ci)
    # dyn lookup columns (raw circuits): advice cur queries + enabled fixed
    for j in range(nd):
        q_advice(dyn_base + j, 0)
    for ci in dynen_ci:
        q_fixed(ci)
    # instance equality queries
    instance_queries = [(i, 0) for i in range(vk.num_instance)]
    # converted selectors query their fixed column (appended at conversion)
    sel_q = {i: q_fixed(sel_ci[i]) for i in range(n_gate)}
    qlk_q = q_fixed(qlk_ci) if uses_q else None

    # --- gates --------------------------------------------------------------
    gates = []
    for i in range(n_gate):
        ph = adv_phase[i]
        a = _advice_q(adv_q_index[(i, 0)], i, 0, ph)
        b = _advice_q(adv_q_index[(i, 1)], i, 1, ph)
        c = _advice_q(adv_q_index[(i, 2)], i, 2, ph)
        out = _advice_q(adv_q_index[(i, 3)], i, 3, ph)
        q = _fixed_q(sel_q[i], sel_ci[i])
        gates.append(f"Product({q}, Sum(Sum({a}, Product({b}, {c})), Negated({out})))")

    # --- lookups ------------------------------------------------------------
    lookups = []
    if has_table:
        tbl = _fixed_q(fix_q_index[(table_ci, 0)], table_ci)
        if uses_q:
            a0 = _advice_q(adv_q_index[(0, 0)], 0, 0, adv_phase[0])
            qe = _fixed_q(qlk_q, qlk_ci)
            lookups.append(
                "Argument { input_expressions: "
                f"[Product({qe}, {a0})], table_expressions: [{tbl}] }}"
            )
        for j in range(n_lk):
            la = _advice_q(adv_q_index[(lk_base + j, 0)], lk_base + j, 0)
            lookups.append(
                f"Argument {{ input_expressions: [{la}], table_expressions: [{tbl}] }}"
            )
    # dyn lookup sets: (enable * key_i) looked up against (enable * table_i)
    off = 0
    for si, kc in enumerate(vk.dyn_key_cols):
        en_in = _fixed_q(fix_q_index[(dynen_ci[2 * si], 0)], dynen_ci[2 * si])
        en_tb = _fixed_q(fix_q_index[(dynen_ci[2 * si + 1], 0)], dynen_ci[2 * si + 1])
        ins = []
        tbs = []
        for c in range(kc):
            ki = _advice_q(adv_q_index[(dyn_base + off + c, 0)], dyn_base + off + c, 0)
            ti = _advice_q(
                adv_q_index[(dyn_base + off + kc + c, 0)], dyn_base + off + kc + c, 0
            )
            ins.append(f"Product({en_in}, {ki})")
            tbs.append(f"Product({en_tb}, {ti})")
        off += 2 * kc
        lookups.append(
            "Argument { input_expressions: ["
            + ", ".join(ins)
            + "], table_expressions: ["
            + ", ".join(tbs)
            + "] }"
        )

    # --- permutation (enable_equality order) --------------------------------
    perm_cols = []
    for ci in const_ci:
        perm_cols.append(_col(ci, "Fixed"))
    for i in range(n_gate):
        perm_cols.append(_col(i, "Advice", adv_phase[i]))
    for j in range(n_lk):
        perm_cols.append(_col(lk_base + j, "Advice", adv_phase[lk_base + j]))
    for i in range(vk.num_instance):
        perm_cols.append(_col(i, "Instance"))
    for j in range(nd):
        perm_cols.append(_col(dyn_base + j, "Advice"))

    # --- assemble -----------------------------------------------------------
    num_challenges = len({c for c, _fc, _r in vk.challenge_pins})
    cs_fields = [
        f"num_fixed_columns: {num_fixed_columns}",
        f"num_advice_columns: {num_advice_columns}",
        f"num_instance_columns: {vk.num_instance}",
        f"num_selectors: {n_gate + (1 if uses_q else 0)}",
    ]
    if num_challenges > 0:
        phases = ", ".join(f"Phase({p})" for p in adv_phase)
        chal_phases = ", ".join(
            f"Phase({c})" for c, _fc, _r in sorted(set(vk.challenge_pins))
        )
        cs_fields += [
            f"num_challenges: {num_challenges}",
            f"advice_column_phase: [{phases}]",
            f"challenge_phase: [{chal_phases}]",
        ]
    cs_fields += [
        "gates: [" + ", ".join(gates) + "]",
        "advice_queries: ["
        + ", ".join(
            f"({_col(ci, 'Advice', adv_phase[ci])}, Rotation({r}))"
            for ci, r in advice_queries
        )
        + "]",
        "instance_queries: ["
        + ", ".join(f"({_col(ci, 'Instance')}, Rotation({r}))" for ci, r in instance_queries)
        + "]",
        "fixed_queries: ["
        + ", ".join(f"({_col(ci, 'Fixed')}, Rotation({r}))" for ci, r in fixed_queries)
        + "]",
        "permutation: Argument { columns: [" + ", ".join(perm_cols) + "] }",
        "lookups: [" + ", ".join(lookups) + "]",
        "constants: [" + ", ".join(_col(ci, "Fixed") for ci in const_ci) + "]",
        "minimum_degree: None",
    ]
    cs = "PinnedConstraintSystem { " + ", ".join(cs_fields) + " }"

    # fixed commitments in fixed-column INDEX order
    fixed_commits: list = []
    if has_table:
        fixed_commits.append(vk.table_commitment)
    fixed_commits.extend(vk.fixed_commitments)
    fixed_commits.extend(vk.selector_commitments)
    if uses_q:
        fixed_commits.append(vk.q_lookup_commitment)
    fixed_commits.extend(vk.dynen_commitments)

    domain = (
        f"PinnedEvaluationDomain {{ k: {vk.k}, extended_k: {extended_k}, "
        f"omega: {_fe(omega)} }}"
    )
    return (
        "PinnedVerificationKey { "
        f"base_modulus: \"0x{FQ_BN254.p:064x}\", "
        f"scalar_modulus: \"0x{FR_BN254.p:064x}\", "
        f"domain: {domain}, "
        f"cs: {cs}, "
        "fixed_commitments: [" + ", ".join(_pt(p) for p in fixed_commits) + "], "
        "permutation: VerifyingKey { commitments: ["
        + ", ".join(_pt(p) for p in vk.permutation_commitments)
        + "] } }"
    )
