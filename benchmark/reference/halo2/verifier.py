"""verify_proof: KZG/SHPLONK verifier (host, exact ints + one pairing check).

Role of halo2-axiom's `verify_proof::<KZG, VerifierSHPLONK, SingleStrategy>`
(SURVEY.md §2.9). Mirrors prover.py's transcript phase-for-phase, recomputes
the expected quotient eval from the opened values, reassembles the SHPLONK
combined commitment with host G1 arithmetic, and checks one pairing equation
with the host BN254 pairing (utils/bn254_pairing.py).
"""

from __future__ import annotations

from .bn254_pairing import pairing_check
from .curves import BN254_G1, BN254_G2
from .domain import HostDomain
from .vk import VerifyingKey
from .protocol import (
    P,
    expected_quotient_eval,
    group_queries,
    lagrange_interpolate,
    lookup_instances,
    perm_chunks,
    point_values,
    poly_eval,
    query_plan,
    quotient_pieces,
    vanishing_poly,
)
from .transcript import Blake2bRead


class VerificationError(Exception):
    pass


def verify_proof(
    params,
    vk: VerifyingKey,
    proof: bytes,
    instances: list[list[int]] | None = None,
) -> bool:
    """True iff `proof` verifies. Malformed proofs (undecodable points,
    truncated transcripts) fail CLOSED: they return False, same as any
    other invalid proof."""
    try:
        return _verify_proof_inner(params, vk, proof, instances)
    except (VerificationError, ValueError, IndexError, AssertionError):
        return False


def _verify_proof_inner(
    params,
    vk: VerifyingKey,
    proof: bytes,
    instances: list[list[int]] | None = None,
) -> bool:
    instances = instances or []
    k = vk.k
    n = 1 << k
    dom = HostDomain(k)
    tr = Blake2bRead(proof)
    tr.common_scalar(vk.transcript_repr())
    for col in instances:
        for v in col:
            tr.common_scalar(v)

    commitments: dict[str, object] = {}

    # --- 1. advice commitments, phase by phase (phase challenges squeezed
    # between phases, mirroring the prover) ---
    na_p = vk.num_advice_per_phase or [vk.num_advice]
    nl_p = vk.num_lookup_per_phase or [vk.num_lookup]
    nphases = max(len(na_p), 1)
    adv_flat = lk_flat = 0
    phase_challenges: list[int] = []
    for t in range(nphases):
        for _ in range(na_p[t] if t < len(na_p) else 0):
            commitments[f"adv{adv_flat}"] = tr.read_point()
            adv_flat += 1
        for _ in range(nl_p[t] if t < len(nl_p) else 0):
            commitments[f"lkcol{lk_flat}"] = tr.read_point()
            lk_flat += 1
        if t < nphases - 1:
            phase_challenges.append(tr.squeeze_challenge())
    assert adv_flat == vk.num_advice and lk_flat == vk.num_lookup

    # --- 1b. dynamic-lookup dedicated advice columns ---
    nd = 2 * sum(vk.dyn_key_cols)
    for i in range(nd):
        commitments[f"dyn{i}"] = tr.read_point()

    theta = tr.squeeze_challenge()
    ninst = len(lookup_instances(vk))

    # --- 2. lookup permuted commitments (one pair per lookup instance) ---
    for j in range(ninst):
        commitments[f"lk{j}_a"] = tr.read_point()
        commitments[f"lk{j}_s"] = tr.read_point()

    beta = tr.squeeze_challenge()
    gamma = tr.squeeze_challenge()

    # --- 3. permutation + lookup product commitments ---
    chunks = perm_chunks(len(vk.perm_columns))
    for j in range(len(chunks)):
        commitments[f"permz{j}"] = tr.read_point()
    for j in range(ninst):
        commitments[f"lk{j}_zl"] = tr.read_point()

    # --- 4. random poly ---
    commitments["random"] = tr.read_point()

    y = tr.squeeze_challenge()

    # --- 5. quotient piece commitments (j = cs_degree - 1 pieces) ---
    h_pieces = [tr.read_point() for _ in range(quotient_pieces(vk))]

    x = tr.squeeze_challenge()
    pts = point_values(x, k)

    # --- 6. read evals ---
    plan = query_plan(vk)
    evals: dict[str, dict[str, int]] = {}
    for label, pts_labels in plan:
        evals[label] = {}
        for pl in pts_labels:
            evals[label][pl] = tr.read_scalar()

    # fixed-column commitments from vk
    for i in range(vk.num_fixed):
        commitments[f"fix{i}"] = vk.fixed_commitments[i]
    for i in range(vk.num_advice):
        commitments[f"sel{i}"] = vk.selector_commitments[i]
    if vk.table_commitment is not None:
        commitments["table"] = vk.table_commitment
    for i in range(len(vk.perm_columns)):
        commitments[f"sigma{i}"] = vk.permutation_commitments[i]
    for i in range(2 * len(vk.dyn_key_cols)):
        commitments[f"dynen{i}"] = vk.dynen_commitments[i]
    if vk.uses_q_lookup:
        commitments["qlookup0"] = vk.q_lookup_commitment
    # combined h commitment: sum x^{n i} C_i
    xn = pow(x, n, P)
    h_comb = None
    scale = 1
    for c in h_pieces:
        h_comb = BN254_G1.add(h_comb, BN254_G1.mul(c, scale))
        scale = scale * xn % P
    commitments["h"] = h_comb

    # instance poly evals at x (barycentric over the provided values)
    instance_evals = []
    for col in instances:
        lag = dom.lagrange_evals_host(list(range(len(col))), x)
        instance_evals.append(sum(v * lag[i] % P for i, v in enumerate(col)) % P)
    while len(instance_evals) < vk.num_instance:
        instance_evals.append(0)

    # --- expected quotient eval must match the opened h eval ---
    challenges = {
        "beta": beta,
        "gamma": gamma,
        "y": y,
        "theta": theta,
        "phase_challenges": phase_challenges,
    }
    expected_h = expected_quotient_eval(vk, evals, instance_evals, challenges, x)
    if evals["h"]["x"] != expected_h:
        raise VerificationError("quotient evaluation mismatch")

    # --- 7. SHPLONK check ---
    v = tr.squeeze_challenge()
    w_ch = tr.squeeze_challenge()
    groups = group_queries(plan)

    # combined group commitments and evals
    g_commits = []
    g_evals = []
    for pts_labels, labels in groups:
        acc = None
        ge = {pl: 0 for pl in pts_labels}
        vpow = 1
        for label in labels:
            acc = BN254_G1.add(acc, BN254_G1.mul(commitments[label], vpow))
            for pl in pts_labels:
                ge[pl] = (ge[pl] + vpow * evals[label][pl]) % P
            vpow = vpow * v % P
        g_commits.append(acc)
        g_evals.append(ge)

    h_open_commit = tr.read_point()
    u_ch = tr.squeeze_challenge()
    q_commit = tr.read_point()
    if not tr.at_end():
        raise VerificationError("trailing proof bytes")

    all_points = sorted({pts[pl] for plan_pts, _ in groups for pl in plan_pts})
    zt_u = poly_eval(vanishing_poly(all_points), u_ch)

    # C_L = sum_j w^j Z_{T\S_j}(u) (C_gj - [r_j(u)] G) - Z_T(u) C_H
    c_l = None
    wpow = 1
    for (pts_labels, _), cg, ge in zip(groups, g_commits, g_evals):
        pvals = [pts[pl] for pl in pts_labels]
        others = [pt for pt in all_points if pt not in pvals]
        z_other_u = poly_eval(vanishing_poly(others), u_ch)
        r = lagrange_interpolate(pvals, [ge[pl] for pl in pts_labels])
        r_u = poly_eval(r, u_ch)
        scale = wpow * z_other_u % P
        term = BN254_G1.add(cg, BN254_G1.neg(BN254_G1.mul(BN254_G1.g, r_u)))
        c_l = BN254_G1.add(c_l, BN254_G1.mul(term, scale))
        wpow = wpow * w_ch % P
    c_l = BN254_G1.add(c_l, BN254_G1.neg(BN254_G1.mul(h_open_commit, zt_u)))

    # e(C_L, g2) * e(-C_Q, s_g2 - u g2) == 1
    g2_term = BN254_G2.add(params.s_g2, BN254_G2.neg(BN254_G2.mul(params.g2, u_ch)))
    ok = pairing_check([(c_l, params.g2), (BN254_G1.neg(q_commit), g2_term)])
    if not ok:
        raise VerificationError("pairing check failed")
    return True
