"""PoseidonHasher / PoseidonSponge: stateless and stateful hashing gadgets.

Re-implements halo2-base/src/poseidon/hasher/mod.rs: cached init state and
empty hash, `hash_fix_len_array`, `hash_var_len_array` (div_mod over RATE +
per-chunk select), compact input formats for batched hashing, and the stateful
sponge.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core.cells import AssignedValue, Constant, Existing
from ..core.context import Context
from ..gates.flex_gate import GateChip
from ..gates.range import RangeChip
from ..utils.misc import bit_length
from .spec import OptimizedPoseidonSpec
from .state import PoseidonState


def fix_len_array_squeeze(ctx, gate, input_elements, state: PoseidonState, spec) -> AssignedValue:
    """(hasher/mod.rs:344-361)"""
    rate = spec.rate
    exact = len(input_elements) % rate == 0
    for i in range(0, len(input_elements), rate):
        state.permutation(ctx, gate, input_elements[i : i + rate], None, spec)
    if exact:
        state.permutation(ctx, gate, [], None, spec)
    return state.s[1]


@dataclass
class PoseidonCompactInput:
    """(hasher/mod.rs:56-95)"""

    inputs: list[AssignedValue]  # right-padded, length RATE
    is_final: AssignedValue  # 0/1
    length: AssignedValue

    def add_validation_constraints(self, ctx, range_chip: RangeChip) -> None:
        rate = len(self.inputs)
        range_chip.check_less_than_safe(ctx, self.length, rate + 1)
        gate = range_chip.gate
        is_full = gate.is_equal(ctx, Existing(self.length), Constant(rate))
        valid = gate.or_(ctx, Existing(self.is_final), Existing(is_full))
        gate.assert_is_const(ctx, valid, 1)


@dataclass
class PoseidonCompactChunkInput:
    """(hasher/mod.rs:98-114)"""

    inputs: list[list[AssignedValue]]  # each of length RATE
    is_final: AssignedValue


@dataclass
class PoseidonCompactOutput:
    hash: AssignedValue
    is_final: AssignedValue


class PoseidonHasher:
    """Stateless hasher with cached consts (hasher/mod.rs:123-288)."""

    def __init__(self, spec: OptimizedPoseidonSpec):
        self.spec = spec
        self._init_state: PoseidonState | None = None
        self._empty_hash: AssignedValue | None = None

    def initialize_consts(self, ctx: Context, gate: GateChip) -> None:
        self._init_state = PoseidonState.default(ctx, self.spec.t)
        state = self._init_state.clone()
        self._empty_hash = fix_len_array_squeeze(ctx, gate, [], state, self.spec)

    def clear(self) -> None:
        self._init_state = None
        self._empty_hash = None

    def hash_fix_len_array(self, ctx, gate, inputs: list[AssignedValue]) -> AssignedValue:
        assert self._init_state is not None, "initialize_consts first"
        state = self._init_state.clone()
        return fix_len_array_squeeze(ctx, gate, inputs, state, self.spec)

    def hash_var_len_array(self, ctx, range_chip: RangeChip, inputs, length: AssignedValue) -> AssignedValue:
        """(hasher/mod.rs:152-210)"""
        assert self._init_state is not None, "initialize_consts first"
        gate = range_chip.gate
        rate = self.spec.rate
        max_len = len(inputs)
        if max_len == 0:
            return self._empty_hash
        num_bits = bit_length(max_len)
        num_perm, len_last_chunk = range_chip.div_mod(ctx, Existing(length), rate, num_bits)
        num_perm = gate.inc(ctx, Existing(num_perm))

        state = self._init_state.clone()
        result_state = state.clone()
        n_chunks = (max_len + rate - 1) // rate
        for i in range(n_chunks):
            chunk = inputs[i * rate : (i + 1) * rate]
            is_last_perm = gate.is_equal(ctx, Existing(num_perm), Constant(i + 1))
            len_chunk = gate.select(
                ctx, Existing(len_last_chunk), Constant(rate), Existing(is_last_perm)
            )
            state.permutation(ctx, gate, chunk, len_chunk, self.spec)
            result_state.select(ctx, gate, is_last_perm, state)
        if max_len % rate == 0:
            is_last_perm = gate.is_equal(
                ctx, Existing(num_perm), Constant(max_len // rate + 1)
            )
            len_chunk = ctx.load_zero()
            state.permutation(ctx, gate, [], len_chunk, self.spec)
            result_state.select(ctx, gate, is_last_perm, state)
        return result_state.s[1]

    def hash_compact_input(self, ctx, gate, compact_inputs: list[PoseidonCompactInput]) -> list[PoseidonCompactOutput]:
        """(hasher/mod.rs:233-263)"""
        assert self._init_state is not None
        rate = self.spec.rate
        outputs = []
        state = self._init_state.clone()
        for inp in compact_inputs:
            is_full = gate.is_equal(ctx, Existing(inp.length), Constant(rate))
            state.permutation(ctx, gate, inp.inputs, inp.length, self.spec)
            state2 = state.clone()
            state2.permutation(ctx, gate, [], None, self.spec)
            h = gate.select(ctx, Existing(state2.s[1]), Existing(state.s[1]), Existing(is_full))
            outputs.append(PoseidonCompactOutput(hash=h, is_final=inp.is_final))
            state.select(ctx, gate, inp.is_final, self._init_state)
        return outputs

    def hash_compact_chunk_inputs(self, ctx, gate, chunk_inputs: list[PoseidonCompactChunkInput]) -> list[PoseidonCompactOutput]:
        """(hasher/mod.rs:266-288)"""
        assert self._init_state is not None
        zero = ctx.load_zero()
        outputs = []
        state = self._init_state.clone()
        for chunk in chunk_inputs:
            for absorb in chunk.inputs:
                state.permutation(ctx, gate, absorb, None, self.spec)
            out_state = state.clone()
            out_state.permutation(ctx, gate, [], None, self.spec)
            h = gate.select(ctx, Existing(out_state.s[1]), Existing(zero), Existing(chunk.is_final))
            outputs.append(PoseidonCompactOutput(hash=h, is_final=chunk.is_final))
            state.select(ctx, gate, chunk.is_final, self._init_state)
        return outputs


class PoseidonSponge:
    """Stateful sponge (hasher/mod.rs:292-341)."""

    def __init__(self, ctx: Context, spec: OptimizedPoseidonSpec):
        self.spec = spec
        self.init_state = PoseidonState.default(ctx, spec.t)
        self.state = self.init_state.clone()
        self.absorbing: list[AssignedValue] = []

    def clear(self) -> None:
        self.state = self.init_state.clone()
        self.absorbing = []

    def update(self, elements: list[AssignedValue]) -> None:
        self.absorbing.extend(elements)

    def squeeze(self, ctx, gate) -> AssignedValue:
        inputs = self.absorbing
        self.absorbing = []
        return fix_len_array_squeeze(ctx, gate, inputs, self.state, self.spec)
