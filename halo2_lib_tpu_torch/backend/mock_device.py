"""Device MockProver: constraint evaluation as batched tensor programs.

The port of ``halo2_lib_tpu/backend/mock_device.py``. The single vertical
gate makes constraint checking a 4-tap stencil,
``q[i] * (A[i] + A[i+1]*A[i+2] - A[i+3]) == 0``, which runs over every
phase's columns at once through the field kernels (mont_mul, field_add,
field_sub). Copy constraints become a gather and compare on index tensors;
range lookups stay a host scan of the values against the bound. The host
``backend.mock.MockProver`` remains the exact oracle; this one is the fast
path for big circuits (the same verdicts, coarser error reporting).

Columns are packed on the host as 16-bit limbs and converted to Montgomery
form on the device (one to_mont product per column set), as the prover
uploads its witness.
"""

from __future__ import annotations

import numpy as np
import torch

from ..gates.circuit import PhysicalCircuit
from ..ops.limbs import DeviceField
from ..utils.device import resolve_device
from ..utils.fields import FR_BN254
from .prover import _lag_from_u16, _u16_cols

# gate failures named in the errors, as the JAX package's device mock does
GATE_ERRORS = 8


def gate_residual(df: DeviceField, A: torch.Tensor) -> torch.Tensor:
    """A[i] + A[i+1] * A[i+2] - A[i+3] of Montgomery columns [C, 16, n], the
    rotations wrapping within each column as jnp.roll's do."""
    b, c, d = (torch.roll(A, -s, dims=-1) for s in (1, 2, 3))
    return df._sub(df._add(A, df._mont_mul(b, c)), d)


class DeviceMockProver:
    """Evaluates all constraints of a PhysicalCircuit on `device` (the CUDA
    card unless the caller asks for another)."""

    def __init__(self, circuit: PhysicalCircuit, device=None):
        self.circuit = circuit
        self.device = resolve_device(device)
        self.df = DeviceField(FR_BN254)

    def _columns(self):
        """(Montgomery int32[C, 16, n] of every column the checks read, the
        gate columns first; {(kind, phase, col) or (kind, col): index}; the
        number of gate columns; their (phase, col) labels)."""
        c = self.circuit
        n = c.num_rows()
        p = self.df.p_int
        cols: list[list[int]] = []
        index: dict = {}
        labels: list[tuple[int, int]] = []
        for t, phase in enumerate(c.phases):
            for i, (vals, _) in enumerate(zip(phase.columns, phase.selectors)):
                index[("advice", t, i)] = len(cols)
                labels.append((t, i))
                cols.append(vals)
        ngate = len(cols)
        for t, phase in enumerate(c.phases):
            for i in range(len(phase.selectors), len(phase.columns)):
                index[("advice", t, i)] = len(cols)
                cols.append(phase.columns[i])
        for t, lk in enumerate(c.lookup_cols):
            for i, vals in enumerate(lk):
                index[("lookup", t, i)] = len(cols)
                cols.append(vals)
        for i, vals in enumerate(c.fixed_cols):
            index[("fixed", i)] = len(cols)
            cols.append(vals)
        for i, vals in enumerate(c.instances):
            index[("instance", i)] = len(cols)
            cols.append(vals)
        flat = 0
        for s in c.dyn_sets:
            for i, vals in enumerate((s["key_cols"] + s["table_cols"])[: 2 * s["key_col"]]):
                index[("dynadv", flat + i)] = len(cols)
                cols.append(vals)
            flat += 2 * s["key_col"]
        index["zero"] = len(cols)  # cells of columns that do not exist read 0
        cols.append([])
        padded = [[v % p for v in vals] + [0] * (n - len(vals)) for vals in cols]
        table = _lag_from_u16(self.df, _u16_cols(padded, n), self.device)
        return table, index, ngate, labels

    def verify(self) -> list[str]:
        c = self.circuit
        df = self.df
        n = c.num_rows()
        dev = self.device
        errors: list[str] = []
        table, index, ngate, labels = self._columns()

        # --- 1. vertical gate stencil, every phase's columns at once ---------
        if ngate:
            Q = np.zeros((ngate, n), dtype=bool)
            for i, (t, col) in enumerate(labels):
                sel = c.phases[t].selectors[col]
                Q[i, : len(sel)] = np.asarray(sel, dtype=bool)
            Q = torch.from_numpy(Q).to(dev)
            bad = Q & ~df.is_zero(gate_residual(df, table[:ngate]))
            for col, row in torch.nonzero(bad)[:GATE_ERRORS].tolist():
                t, i = labels[col]
                errors.append(f"gate failure at phase {t} column {i} row {row}")

        # --- 2. copy constraints: gather and compare --------------------------
        if c.copies:

            def column_of(cell) -> int:
                kind = cell[0]
                key = (kind, cell[1], cell[2]) if kind in ("advice", "lookup") else (kind, cell[2])
                if kind not in ("advice", "lookup", "fixed", "instance", "dynadv"):
                    raise ValueError(kind)
                return index.get(key, index["zero"])

            cells = [cell for pair in c.copies for cell in pair]
            of_key: dict = {}
            col_idx = np.empty(len(cells), dtype=np.int64)
            for j, cell in enumerate(cells):
                key = cell[:3]
                ci = of_key.get(key)
                if ci is None:
                    ci = of_key[key] = column_of(cell)
                col_idx[j] = ci
            rows = np.fromiter((cell[3] for cell in cells), dtype=np.int64, count=len(cells))
            zero = index["zero"]
            col_idx[rows >= n] = zero  # rows past the column read 0
            rows[rows >= n] = 0
            cols_t = torch.from_numpy(col_idx).to(dev).view(-1, 2)
            rows_t = torch.from_numpy(rows).to(dev).view(-1, 2)
            left = table[cols_t[:, 0], :, rows_t[:, 0]]  # [m, 16]
            right = table[cols_t[:, 1], :, rows_t[:, 1]]
            n_bad = int((left != right).any(dim=-1).sum())
            if n_bad:
                errors.append(f"{n_bad} copy constraint failures")

        # --- 3. range lookups: value < 2^lookup_bits (host scan) ---------------
        lb = c.params.lookup_bits
        if lb is not None:
            bound = 1 << lb
            all_vals: list[int] = []
            for cols in c.lookup_cols:
                for vals in cols:
                    all_vals.extend(vals)
            for ph_idx, rows_q in enumerate(c.q_lookup_rows):
                if not rows_q or ph_idx >= len(c.phases) or not c.phases[ph_idx].columns:
                    continue
                col0 = c.phases[ph_idx].columns[0]
                for r in rows_q:
                    all_vals.append(col0[r] if r < len(col0) else 0)
            if all_vals:
                bad_lk = sum(1 for v in all_vals if not (0 <= v < bound))
                if bad_lk:
                    errors.append(f"{bad_lk} lookup failures")
        return errors

    def assert_satisfied(self) -> None:
        errors = self.verify()
        assert not errors, "\n".join(errors)
