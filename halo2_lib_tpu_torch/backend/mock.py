"""MockProver: evaluate every constraint of a PhysicalCircuit directly.

Host reference implementation (exact big-int) of the halo2 `MockProver`:
- the vertical gate stencil q[i] * (A[i] + A[i+1]*A[i+2] - A[i+3]) == 0
- permutation (copy) constraints by value
- range-lookup membership in [0, 2^lookup_bits)
- instance column consistency

The port of ``halo2_lib_tpu/backend/mock.py``, without its opt-in native
column checker (``HALO2_NATIVE_MOCK``): the gate scan is the Python loop
``gate_failures``. The host engine's check (native.py
``NativeField.check_gate_column``) gives the same first failing row, but
packing a column of Python ints for it costs more than the scan
(chip_smoke.py phase 8 times both; PERF.md).
"""

from __future__ import annotations

from ..gates.circuit import BaseCircuitBuilder, PhysicalCircuit


class VerifyFailure(Exception):
    pass


def gate_failures(vals: list[int], sels, p: int):
    """(row, a, b, c, d) for each row r of one advice column where the
    selector is on and a + b*c - d != 0 mod p (a..d the values at r..r+3;
    rows past the column read 0)."""
    L = len(vals)
    for r, q in enumerate(sels):
        if not q:
            continue
        a = vals[r]
        b = vals[r + 1] if r + 1 < L else 0
        cc = vals[r + 2] if r + 2 < L else 0
        d = vals[r + 3] if r + 3 < L else 0
        if (a + b * cc - d) % p != 0:
            yield r, a, b, cc, d


class MockProver:
    def __init__(
        self,
        circuit: PhysicalCircuit,
        instances: list[list[int]] | None,
        phase_challenges: list[int] | None = None,
    ):
        self.circuit = circuit
        self.provided_instances = instances
        # values the challenge-pinned cells must equal; defaults to the
        # deterministic mock challenges (backend/challenges.py) that
        # mock-stage witness gen is expected to use
        self.phase_challenges = phase_challenges

    @staticmethod
    def run(
        k: int,
        builder: BaseCircuitBuilder,
        instances: list[list[int]] | None = None,
        phase_challenges: list[int] | None = None,
    ) -> "MockProver":
        assert builder.config_params.k == k, "k mismatch"
        circuit = builder.synthesize()
        return MockProver(circuit, instances, phase_challenges)

    # --- checks -----------------------------------------------------------
    def verify(self) -> list[str]:
        c = self.circuit
        F = c.field
        p = F.p
        errors: list[str] = []
        n = c.num_rows()

        # 1. vertical gate: q * (a + b*c - d) == 0
        for phase_idx, fp in enumerate(c.phases):
            for col_idx, (vals, sels) in enumerate(zip(fp.columns, fp.selectors)):
                for r, a, b, cc, d in gate_failures(vals, sels, p):
                    errors.append(
                        f"gate failure at phase {phase_idx} column {col_idx} row {r}: "
                        f"{a} + {b}*{cc} != {d}"
                    )
                    if len(errors) > 16:
                        return errors

        # 2. copy constraints by value
        def cell_value(cell) -> int:
            kind, phase, col, row = cell
            if kind == "advice":
                colvals = c.phases[phase].columns[col]
                return colvals[row] if row < len(colvals) else 0
            if kind == "lookup":
                colvals = c.lookup_cols[phase][col]
                return colvals[row] if row < len(colvals) else 0
            if kind == "fixed":
                colvals = c.fixed_cols[col]
                return colvals[row] if row < len(colvals) else 0
            if kind == "dynadv":
                flat = 0
                for s in c.dyn_sets:
                    w = 2 * s["key_col"]
                    if col < flat + w:
                        local = col - flat
                        cols2 = s["key_cols"] + s["table_cols"]
                        colvals = cols2[local]
                        return colvals[row] if row < len(colvals) else 0
                    flat += w
                raise ValueError(f"dynadv column {col} out of range")
            if kind == "instance":
                inst = (
                    self.provided_instances[col]
                    if self.provided_instances is not None
                    else c.instances[col]
                )
                return inst[row] if row < len(inst) else 0
            raise ValueError(kind)

        for left, right in c.copies:
            lv, rv = cell_value(left), cell_value(right)
            if lv % p != rv % p:
                errors.append(f"copy constraint failure: {left}={lv} != {right}={rv}")
                if len(errors) > 16:
                    return errors

        # 3. range lookups
        lb = c.params.lookup_bits
        if lb is not None:
            bound = 1 << lb
            for phase_idx, cols in enumerate(c.lookup_cols):
                for col_idx, vals in enumerate(cols):
                    for r, v in enumerate(vals):
                        if not (0 <= v < bound):
                            errors.append(
                                f"lookup failure phase {phase_idx} lookup col {col_idx} "
                                f"row {r}: {v} not in [0, 2^{lb})"
                            )
                            if len(errors) > 16:
                                return errors
            for phase_idx, rows in enumerate(c.q_lookup_rows):
                if not rows:
                    continue
                col0 = c.phases[phase_idx].columns[0]
                for r in rows:
                    v = col0[r] if r < len(col0) else 0
                    if not (0 <= v < bound):
                        errors.append(
                            f"q_lookup failure phase {phase_idx} row {r}: {v} not in [0, 2^{lb})"
                        )

        # 3b. dynamic lookups (RAM gadget; core/dyn_lookup.py)
        if c.dyn_lookups:
            from ..core.dyn_lookup import check_dyn_lookups

            errors.extend(check_dyn_lookups(c.dyn_lookups))
            if len(errors) > 16:
                return errors

        # 3c. challenge pins: pinned cell must equal the phase challenge
        if c.challenge_pins:
            from .challenges import mock_challenge

            for ci, phase, col, row in c.challenge_pins:
                colvals = c.phases[phase].columns[col]
                v = colvals[row] if row < len(colvals) else 0
                expect = (
                    self.phase_challenges[ci]
                    if self.phase_challenges is not None
                    else mock_challenge(ci)
                )
                if v % p != expect % p:
                    errors.append(
                        f"challenge pin failure: phase {phase} col {col} row {row} "
                        f"= {v} != challenge {ci}"
                    )

        # 4. instance values match provided
        if self.provided_instances is not None:
            for i, (exp, got) in enumerate(zip(c.instances, self.provided_instances)):
                if [v % p for v in exp] != [v % p for v in got]:
                    errors.append(f"instance column {i} mismatch")

        # 5. usable-rows bound
        for phase_idx, fp in enumerate(c.phases):
            for col_idx, vals in enumerate(fp.columns):
                if len(vals) > n:
                    errors.append(
                        f"column overflow: phase {phase_idx} col {col_idx} has {len(vals)} > {n} rows"
                    )
        return errors

    def assert_satisfied(self) -> None:
        errors = self.verify()
        if errors:
            raise VerifyFailure("\n".join(errors[:16]))
