"""In-circuit Poseidon permutation state.

Re-implements halo2-base/src/poseidon/hasher/state.rs: full-round x^5 sboxes,
MDS apply as T inner products, partial rounds on s[0] + sparse MDS apply,
fixed-length absorb with 1||0* padding, and variable-length absorb using
idx_to_indicator + partial_sums masks.
"""

from __future__ import annotations

from ..core.cells import AssignedValue, Constant, Existing
from ..core.context import Context
from ..gates.flex_gate import GateChip
from .spec import OptimizedPoseidonSpec, SparseMDSMatrix


class PoseidonState:
    def __init__(self, s: list[AssignedValue]):
        self.s = list(s)

    @staticmethod
    def default(ctx: Context, t: int) -> "PoseidonState":
        """Capacity element 2^64 (variable-len hashing, o=1) (state.rs:20-27)."""
        vals = [1 << 64] + [0] * (t - 1)
        return PoseidonState([ctx.load_constant(v) for v in vals])

    def clone(self) -> "PoseidonState":
        return PoseidonState(self.s)

    def permutation(
        self,
        ctx: Context,
        gate: GateChip,
        inputs: list[AssignedValue],
        length: AssignedValue | None,
        spec: OptimizedPoseidonSpec,
    ) -> None:
        """(state.rs:35-82)"""
        r_f = spec.r_f // 2
        mds = spec.mds
        rate = spec.rate

        constants = spec.constants_start
        if length is not None:
            padded = [
                inputs[i] if i < len(inputs) else ctx.load_zero() for i in range(rate)
            ]
            self._absorb_var_len_with_pre_constants(ctx, gate, padded, length, constants[0])
        else:
            self._absorb_with_pre_constants(ctx, gate, inputs, constants[0])
        for consts in constants[1:r_f]:
            self._sbox_full(ctx, gate, consts)
            self._apply_mds(ctx, gate, mds)
        self._sbox_full(ctx, gate, constants[-1])
        self._apply_mds(ctx, gate, spec.pre_sparse_mds)

        for constant, sparse in zip(spec.constants_partial, spec.sparse_matrices):
            self._sbox_part(ctx, gate, constant)
            self._apply_sparse_mds(ctx, gate, sparse)

        for consts in spec.constants_end:
            self._sbox_full(ctx, gate, consts)
            self._apply_mds(ctx, gate, mds)
        self._sbox_full(ctx, gate, [0] * spec.t)
        self._apply_mds(ctx, gate, mds)

    def select(self, ctx: Context, gate: GateChip, selector: AssignedValue, set_to: "PoseidonState") -> None:
        """(state.rs:85-95)"""
        self.s = [
            gate.select(ctx, Existing(a), Existing(b), Existing(selector))
            for a, b in zip(set_to.s, self.s)
        ]

    @staticmethod
    def _x5_with_constant(ctx, gate: GateChip, x: AssignedValue, constant: int) -> AssignedValue:
        x2 = gate.mul(ctx, Existing(x), Existing(x))
        x4 = gate.mul(ctx, Existing(x2), Existing(x2))
        return gate.mul_add(ctx, Existing(x), Existing(x4), Constant(constant))

    def _sbox_full(self, ctx, gate, constants: list[int]) -> None:
        self.s = [
            self._x5_with_constant(ctx, gate, x, c) for x, c in zip(self.s, constants)
        ]

    def _sbox_part(self, ctx, gate, constant: int) -> None:
        self.s[0] = self._x5_with_constant(ctx, gate, self.s[0], constant)

    def _absorb_with_pre_constants(self, ctx, gate: GateChip, inputs, pre_constants) -> None:
        """(state.rs:124-161)"""
        t = len(self.s)
        assert len(inputs) < t
        self.s[0] = gate.add(ctx, Existing(self.s[0]), Constant(pre_constants[0]))
        for i, inp in enumerate(inputs):
            self.s[i + 1] = gate.sum(
                ctx,
                [Existing(self.s[i + 1]), Existing(inp), Constant(pre_constants[i + 1])],
            )
        offset = len(inputs) + 1
        for i in range(offset, t):
            extra = 1 if i == offset else 0
            self.s[i] = gate.add(
                ctx,
                Existing(self.s[i]),
                Constant((pre_constants[i] + extra) % gate.F.p),
            )

    def _absorb_var_len_with_pre_constants(self, ctx, gate: GateChip, inputs, length, pre_constants) -> None:
        """(state.rs:166-212)"""
        t = len(self.s)
        rate = len(inputs)
        for i, c in enumerate(pre_constants):
            self.s[i] = gate.add(ctx, Existing(self.s[i]), Constant(c))
        idx = gate.dec(ctx, Existing(length))
        len_indicator = gate.idx_to_indicator(ctx, Existing(idx), rate)
        inputs_mask = gate.partial_sums(ctx, [Existing(b) for b in reversed(len_indicator)])
        inputs_mask.reverse()
        padded = [
            gate.mul(ctx, Existing(inp), Existing(mask))
            for inp, mask in zip(inputs, inputs_mask)
        ]
        for i in range(rate):
            self.s[i + 1] = gate.add(ctx, Existing(self.s[i + 1]), Existing(padded[i]))
            if i + 2 < t:
                self.s[i + 2] = gate.add(
                    ctx, Existing(self.s[i + 2]), Existing(len_indicator[i])
                )
        empty_extra_one = gate.not_(ctx, Existing(inputs_mask[0]))
        self.s[1] = gate.add(ctx, Existing(self.s[1]), Existing(empty_extra_one))

    def _apply_mds(self, ctx, gate: GateChip, mds: list[list[int]]) -> None:
        self.s = [
            gate.inner_product(
                ctx, [Existing(x) for x in self.s], [Constant(c) for c in row]
            )
            for row in mds
        ]

    def _apply_sparse_mds(self, ctx, gate: GateChip, mds: SparseMDSMatrix) -> None:
        """(state.rs:230-250)"""
        new_s = [
            gate.inner_product(
                ctx, [Existing(x) for x in self.s], [Constant(c) for c in mds.row]
            )
        ]
        for coeff, state in zip(mds.col_hat, self.s[1:]):
            new_s.append(
                gate.mul_add(ctx, Existing(self.s[0]), Constant(coeff), Existing(state))
            )
        self.s = new_s
