"""Shared protocol definitions between prover and verifier.

The PlonKish constraint system of BaseConfig (see keygen.py docstring), the
y-RLC ordering of constraint expressions, the opening-query plan, and the
SHPLONK helpers. Keeping this in one module guarantees the prover and the
verifier agree on every ordering (constraint order, query order, point-set
grouping) — the transcript is only sound if both sides match exactly.
"""

from __future__ import annotations

from .fields import FR_BN254
from .domain import HostDomain
from .vk import BLINDING_FACTORS, PERM_CHUNK, DELTA, VerifyingKey

P = FR_BN254.p


def usable_row_count(n: int) -> int:
    """u = n - B - 1: first u rows active, row u is l_last, rest blinding."""
    return n - BLINDING_FACTORS - 1


def perm_chunks(num_cols: int) -> list[tuple[int, int]]:
    """[(start, end)) column ranges of each permutation chunk."""
    return [(i, min(i + PERM_CHUNK, num_cols)) for i in range(0, num_cols, PERM_CHUNK)]


# ---------------------------------------------------------------------------
# Opening-point bookkeeping. Points are labeled with string tags; the actual
# field values depend on the challenge x.
# ---------------------------------------------------------------------------

ROT_LABELS = {0: "x", 1: "x_w", 2: "x_w2", 3: "x_w3", -1: "x_winv", "last": "x_last"}


def cs_degree(vk) -> int:
    """Constraint-system degree (halo2 cs.degree()). 4 for the standard
    vertical gate / lookup / permutation shapes; 5 when q_lookup multiplies
    the advice column inside the lookup input (reference range/mod.rs:88-108
    — a degree-2 input expression raises the lookup constraint degree)."""
    return 5 if getattr(vk, "uses_q_lookup", False) else 4


def quotient_pieces(vk) -> int:
    """Number of size-n quotient pieces: j = cs_degree - 1 (halo2's
    quotient_poly_degree); deg h <= (cs_degree - 1) n - cs_degree."""
    return cs_degree(vk) - 1


def lookup_instances(vk) -> list[tuple[list, list]]:
    """All lookup-argument instances as (input_exprs, table_exprs).

    Each side is theta-compressed by Horner over the expressions in order
    (halo2's multi-expression lookup compression). An expression is a column
    label (str) or ("prod", e1, e2) for a product — used by the q_lookup
    single-advice-column case `q_lookup * a_0` (reference range/mod.rs:88-108,
    circuit/builder.rs:337-357). Range lookups are the single-column case;
    dynamic lookups (BasicDynLookupConfig, reference
    virtual_region/lookups/basic.rs:70-82) look up (key..., key_is_enabled)
    against (table..., table_is_enabled).
    """
    inst: list[tuple[list, list]] = []
    for j in range(vk.num_lookup):
        inst.append(([f"lkcol{j}"], ["table"]))
    if vk.uses_q_lookup:
        inst.append(([("prod", "qlookup0", "adv0")], ["table"]))
    flat = 0
    for si, kc in enumerate(getattr(vk, "dyn_key_cols", [])):
        inp = [f"dyn{flat + c}" for c in range(kc)] + [f"dynen{2 * si}"]
        tbl = [f"dyn{flat + kc + c}" for c in range(kc)] + [f"dynen{2 * si + 1}"]
        inst.append((inp, tbl))
        flat += 2 * kc
    return inst


def compress_host(cols: list, theta: int, u: int) -> list[int]:
    """Theta-Horner compression of parallel column expressions, rows 0..u-1.

    Each entry is a column (list of ints) or ("prod", col1, col2)."""

    def at(col, r):
        if isinstance(col, tuple):
            return at(col[1], r) * at(col[2], r) % P
        return col[r] if r < len(col) else 0

    if len(cols) == 1 and not isinstance(cols[0], tuple):
        c = cols[0]
        return [c[r] if r < len(c) else 0 for r in range(u)]
    out = []
    for r in range(u):
        acc = 0
        for col in cols:
            acc = (acc * theta + at(col, r)) % P
        out.append(acc)
    return out


def point_values(x: int, k: int) -> dict[str, int]:
    dom = HostDomain(k)
    n = 1 << k
    u = usable_row_count(n)
    w = dom.omega
    return {
        "x": x,
        "x_w": x * w % P,
        "x_w2": x * pow(w, 2, P) % P,
        "x_w3": x * pow(w, 3, P) % P,
        "x_winv": x * pow(w, P - 2, P) % P,
        "x_last": x * pow(w, u, P) % P,
    }


def query_plan(vk: VerifyingKey) -> list[tuple[str, tuple[str, ...]]]:
    """Ordered list of (poly_label, point_labels) opened by the multiopen.

    Labels: adv{i}, lkcol{j}, fix{i}, sel{i}, table, sigma{i}, permz{j},
    lk{j}_zl / lk{j}_a / lk{j}_s, random, h.
    """
    plan: list[tuple[str, tuple[str, ...]]] = []
    for i in range(vk.num_advice):
        plan.append((f"adv{i}", ("x", "x_w", "x_w2", "x_w3")))
    for j in range(vk.num_lookup):
        plan.append((f"lkcol{j}", ("x",)))
    for i in range(vk.num_fixed):
        plan.append((f"fix{i}", ("x",)))
    for i in range(vk.num_advice):
        plan.append((f"sel{i}", ("x",)))
    nd = 2 * sum(getattr(vk, "dyn_key_cols", []))
    for i in range(nd):
        plan.append((f"dyn{i}", ("x",)))
    for i in range(2 * len(getattr(vk, "dyn_key_cols", []))):
        plan.append((f"dynen{i}", ("x",)))
    if vk.uses_q_lookup:
        plan.append(("qlookup0", ("x",)))
    if vk.table_commitment is not None:
        plan.append(("table", ("x",)))
    plan.append(("random", ("x",)))
    for i in range(len(vk.perm_columns)):
        plan.append((f"sigma{i}", ("x",)))
    chunks = perm_chunks(len(vk.perm_columns))
    for j in range(len(chunks)):
        if j + 1 < len(chunks):
            plan.append((f"permz{j}", ("x", "x_w", "x_last")))
        else:
            plan.append((f"permz{j}", ("x", "x_w")))
    for j in range(len(lookup_instances(vk))):
        plan.append((f"lk{j}_zl", ("x", "x_w")))
        plan.append((f"lk{j}_a", ("x", "x_winv")))
        plan.append((f"lk{j}_s", ("x",)))
    plan.append(("h", ("x",)))
    return plan


def group_queries(plan):
    """Group by point set, canonical order: sorted by point tuple."""
    groups: dict[tuple[str, ...], list[str]] = {}
    for label, pts in plan:
        groups.setdefault(tuple(pts), []).append(label)
    return sorted(groups.items(), key=lambda kv: kv[0])


# ---------------------------------------------------------------------------
# Verifier-side expression evaluation (host scalars). The prover evaluates the
# same expressions vectorized on the extended domain (prover.py); the ORDER of
# the y-RLC here is the single source of truth.
# ---------------------------------------------------------------------------

def expected_quotient_eval(
    vk: VerifyingKey,
    evals: dict[str, dict[str, int]],
    instance_evals: list[int],
    challenges: dict[str, int],
    x: int,
) -> int:
    """Compute sum_i y^i expr_i(x) / Z_H(x) from the opened evals."""
    k = vk.k
    n = 1 << k
    dom = HostDomain(k)
    u = usable_row_count(n)
    beta, gamma, y = challenges["beta"], challenges["gamma"], challenges["y"]
    theta = challenges.get("theta", 0)

    # Lagrange helpers at x
    lag = dom.lagrange_evals_host([0, u] + list(range(u + 1, n)), x)
    l_0 = lag[0]
    l_last = lag[u]
    l_blind = sum(lag[i] for i in range(u + 1, n)) % P
    l_active = (1 - l_last - l_blind) % P

    exprs: list[int] = []
    # 1. gates
    for i in range(vk.num_advice):
        q = evals[f"sel{i}"]["x"]
        a = evals[f"adv{i}"]["x"]
        aw = evals[f"adv{i}"]["x_w"]
        aw2 = evals[f"adv{i}"]["x_w2"]
        aw3 = evals[f"adv{i}"]["x_w3"]
        exprs.append(q * ((a + aw * aw2 - aw3) % P) % P)

    # 1b. challenge pins: L_row * (advice_col - challenge_c); L_row(x) is
    # computed in closed form — the pin is structural, not a committed column
    phase_chals = challenges.get("phase_challenges", [])
    if vk.challenge_pins:
        pin_rows = [row for _c, _fc, row in vk.challenge_pins]
        pin_lag = dom.lagrange_evals_host(sorted(set(pin_rows)), x)
        for i, (c, flat_col, row) in enumerate(vk.challenge_pins):
            a = evals[f"adv{flat_col}"]["x"]
            exprs.append(pin_lag[row] * ((a - phase_chals[c]) % P) % P)

    # 2. permutation
    perm_cols = vk.perm_columns
    chunks = perm_chunks(len(perm_cols))
    if chunks:
        z0 = evals["permz0"]["x"]
        exprs.append(l_0 * (1 - z0) % P)
        zl = evals[f"permz{len(chunks)-1}"]["x"]
        exprs.append(l_last * ((zl * zl - zl) % P) % P)
        for j in range(1, len(chunks)):
            zj = evals[f"permz{j}"]["x"]
            zprev_last = evals[f"permz{j-1}"]["x_last"]
            exprs.append(l_0 * ((zj - zprev_last) % P) % P)

        def col_eval(col_ref) -> int:
            kind, idx = col_ref.kind, col_ref.index
            if kind == "advice":
                return evals[f"adv{idx}"]["x"]
            if kind == "lookup":
                return evals[f"lkcol{idx}"]["x"]
            if kind == "fixed":
                return evals[f"fix{idx}"]["x"]
            if kind == "instance":
                return instance_evals[idx]
            if kind == "dynadv":
                return evals[f"dyn{idx}"]["x"]
            raise ValueError(kind)

        for j, (s, e) in enumerate(chunks):
            z_x = evals[f"permz{j}"]["x"]
            z_wx = evals[f"permz{j}"]["x_w"]
            left = z_wx
            right = z_x
            for ci in range(s, e):
                v = col_eval(perm_cols[ci])
                sigma = evals[f"sigma{ci}"]["x"]
                left = left * ((v + beta * sigma + gamma) % P) % P
                right = right * ((v + beta * pow(DELTA, ci, P) % P * x + gamma) % P) % P
            exprs.append(l_active * ((left - right) % P) % P)

    # 3. lookups (theta-compressed input/table expressions per instance)
    for j, (inp_labels, tbl_labels) in enumerate(lookup_instances(vk)):
        z = evals[f"lk{j}_zl"]["x"]
        z_w = evals[f"lk{j}_zl"]["x_w"]
        a_p = evals[f"lk{j}_a"]["x"]
        a_p_prev = evals[f"lk{j}_a"]["x_winv"]
        s_p = evals[f"lk{j}_s"]["x"]
        def expr_eval(lb):
            if isinstance(lb, tuple):
                return expr_eval(lb[1]) * expr_eval(lb[2]) % P
            return evals[lb]["x"]

        a_in = 0
        for lb in inp_labels:
            a_in = (a_in * theta + expr_eval(lb)) % P
        t_in = 0
        for lb in tbl_labels:
            t_in = (t_in * theta + expr_eval(lb)) % P
        exprs.append(l_0 * (1 - z) % P)
        exprs.append(l_last * ((z * z - z) % P) % P)
        prod_left = z_w * ((a_p + beta) % P) % P * ((s_p + gamma) % P) % P
        prod_right = z * ((a_in + beta) % P) % P * ((t_in + gamma) % P) % P
        exprs.append(l_active * ((prod_left - prod_right) % P) % P)
        exprs.append(l_0 * ((a_p - s_p) % P) % P)
        exprs.append(l_active * ((a_p - s_p) % P) % P * ((a_p - a_p_prev) % P) % P)

    acc = 0
    for e in exprs:
        acc = (acc * y + e) % P
    zh = (pow(x, n, P) - 1) % P
    return acc * pow(zh, -1, P) % P


# ---------------------------------------------------------------------------
# small-poly host helpers for SHPLONK
# ---------------------------------------------------------------------------

def lagrange_interpolate(points: list[int], values: list[int]) -> list[int]:
    """Coefficients of the unique poly of deg < len(points) through the points."""
    m = len(points)
    coeffs = [0] * m
    for i in range(m):
        # basis poly prod_{j!=i} (X - x_j) / (x_i - x_j)
        denom = 1
        basis = [1]
        for j in range(m):
            if j == i:
                continue
            denom = denom * ((points[i] - points[j]) % P) % P
            # basis *= (X - x_j)
            new = [0] * (len(basis) + 1)
            for d, c in enumerate(basis):
                new[d + 1] = (new[d + 1] + c) % P
                new[d] = (new[d] - c * points[j]) % P
            basis = new
        scale = values[i] * pow(denom, -1, P) % P
        for d, c in enumerate(basis):
            coeffs[d] = (coeffs[d] + c * scale) % P
    return coeffs


def poly_eval(coeffs: list[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % P
    return acc


def divide_by_linear(coeffs: list[int], root: int) -> list[int]:
    """Exact synthetic division by (X - root); remainder is discarded."""
    d = len(coeffs) - 1
    out = [0] * d
    out[d - 1] = coeffs[d] % P
    for i in range(d - 1, 0, -1):
        out[i - 1] = (coeffs[i] + root * out[i]) % P
    return out


def vanishing_poly(points: list[int]) -> list[int]:
    z = [1]
    for s in points:
        new = [0] * (len(z) + 1)
        for d, c in enumerate(z):
            new[d + 1] = (new[d + 1] + c) % P
            new[d] = (new[d] - c * s) % P
        z = new
    return z
