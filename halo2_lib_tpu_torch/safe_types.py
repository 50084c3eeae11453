"""SafeType system: range-guaranteed wrappers over raw assigned values.

Re-implements halo2-base/src/safe_types/: `SafeType` (packed byte elements),
`SafeBool`/`SafeByte` newtypes, `VarLenBytes(Vec)`/`FixLenBytes(Vec)` with
`left_pad_to_fixed` (barrel shifter) and `ensure_0_padding`, and the
`SafeTypeChip` with checked and unsafe constructors.

Python note: const generics become constructor arguments; `SafeType` carries
(bytes_per_ele, total_bits) on the instance.
"""

from __future__ import annotations

from dataclasses import dataclass

from .core.cells import AssignedValue, Constant, Existing
from .core.context import Context
from .gates.flex_gate import GateChip
from .gates.range import RangeChip
from .utils.misc import bit_length

BITS_PER_BYTE = 8


@dataclass
class SafeBool:
    """(safe_types/primitives.rs:12)"""

    value: AssignedValue


@dataclass
class SafeByte:
    """(safe_types/primitives.rs:20)"""

    value: AssignedValue


class SafeType:
    """Little-endian packed elements, each bits_per_ele bits (mod.rs:43-99)."""

    def __init__(self, values: list[AssignedValue], bytes_per_ele: int, total_bits: int):
        self.bytes_per_ele = bytes_per_ele
        self.total_bits = total_bits
        expected = -(-total_bits // (bytes_per_ele * BITS_PER_BYTE))
        assert len(values) == expected, "invalid raw values length"
        self.values = values

    @property
    def value_length(self) -> int:
        return len(self.values)

    def bits_per_ele(self) -> int:
        return min(self.total_bits, self.bytes_per_ele * BITS_PER_BYTE)


def SafeAddress(values):  # noqa: N802 - type alias constructor
    return SafeType(values, 1, 160)


def SafeBytes32(values):  # noqa: N802
    return SafeType(values, 1, 256)


class VarLenBytes:
    """Right-padded variable-length byte array (bytes.rs:20-70)."""

    def __init__(self, bytes_: list[SafeByte], length: AssignedValue, max_len: int):
        assert length.val() <= max_len, f"length exceeds MAX_LEN {max_len}"
        assert len(bytes_) == max_len, "bytes not padded correctly"
        self.bytes = bytes_
        self.length = length

    def max_len(self) -> int:
        return len(self.bytes)

    def left_pad_to_fixed(self, ctx: Context, gate: GateChip) -> "FixLenBytes":
        padded = left_pad_var_array_to_fixed(
            ctx, gate, [b.value for b in self.bytes], self.length, self.max_len()
        )
        return FixLenBytes([SafeByte(b) for b in padded])

    def ensure_0_padding(self, ctx: Context, gate: GateChip) -> "VarLenBytes":
        bytes_ = _ensure_0_padding(ctx, gate, self.bytes, self.length)
        return VarLenBytes(bytes_, self.length, self.max_len())


# VarLenBytesVec is the same runtime shape in Python
VarLenBytesVec = VarLenBytes


class FixLenBytes:
    """(bytes.rs:124-146)"""

    def __init__(self, bytes_: list[SafeByte]):
        self.bytes = bytes_

    def __len__(self) -> int:
        return len(self.bytes)

    def into_bytes(self) -> list[SafeByte]:
        return self.bytes


FixLenBytesVec = FixLenBytes


def left_pad_var_array_to_fixed(
    ctx: Context, gate: GateChip, arr: list[AssignedValue], length: AssignedValue, out_len: int
) -> list[AssignedValue]:
    """Barrel shifter: [[0; out_len-len], arr[..len]] (bytes.rs:180-213)."""
    assert len(arr) <= out_len
    assert bit_length(out_len) < gate.F.capacity
    padded = list(arr)
    while len(padded) < out_len:
        padded.append(padded[0])
    shift = gate.sub(ctx, Constant(out_len), Existing(length))
    shift_bits = gate.num_to_bits(ctx, shift, bit_length(out_len))
    for i, shift_bit in enumerate(shift_bits):
        shifted = [
            Existing(padded[j - (1 << i)]) if j >= (1 << i) else Constant(0)
            for j in range(out_len)
        ]
        padded = [
            gate.select(ctx, sh, Existing(noshift), Existing(shift_bit))
            for noshift, sh in zip(padded, shifted)
        ]
    return padded


def _ensure_0_padding(ctx, gate: GateChip, bytes_: list[SafeByte], length: AssignedValue) -> list[SafeByte]:
    """(bytes.rs:215-227)"""
    max_len = len(bytes_)
    idx = gate.dec(ctx, Existing(length))
    len_indicator = gate.idx_to_indicator(ctx, Existing(idx), max_len)
    mask = gate.partial_sums(ctx, [Existing(b) for b in reversed(len_indicator)])
    mask.reverse()
    return [
        SafeByte(gate.mul(ctx, Existing(b.value), Existing(m)))
        for b, m in zip(bytes_, mask)
    ]


class SafeTypeChip:
    """(mod.rs:103-310)"""

    def __init__(self, range_chip: RangeChip):
        self.range_chip = range_chip
        self.gate = range_chip.gate

    def raw_bytes_to(self, ctx: Context, inputs: list[AssignedValue], bytes_per_ele: int, total_bits: int) -> SafeType:
        """Range check bytes + pack into elements (mod.rs:115-150)."""
        element_bits = min(total_bits, bytes_per_ele * BITS_PER_BYTE)
        assert len(inputs) * BITS_PER_BYTE == max(total_bits, BITS_PER_BYTE), "bit count mismatch"
        self._add_bytes_constraints(ctx, inputs, total_bits)
        if total_bits == 1 or element_bits == BITS_PER_BYTE:
            return SafeType(list(inputs), bytes_per_ele, total_bits)
        assert element_bits <= self.gate.F.capacity
        byte_base = [Constant(self.gate.pow_of_two[i * BITS_PER_BYTE]) for i in range(bytes_per_ele)]
        values = []
        for i in range(0, len(inputs), bytes_per_ele):
            chunk = inputs[i : i + bytes_per_ele]
            values.append(
                self.gate.inner_product(
                    ctx, [Existing(c) for c in chunk], byte_base[: len(chunk)]
                )
            )
        return SafeType(values, bytes_per_ele, total_bits)

    def _add_bytes_constraints(self, ctx, inputs, total_bits: int) -> None:
        bits = min(total_bits, BITS_PER_BYTE)
        for i, inp in enumerate(inputs):
            self.range_chip.range_check(ctx, inp, bits if i == 0 or total_bits >= BITS_PER_BYTE else bits)

    @staticmethod
    def unsafe_to_safe_type(inputs, bytes_per_ele: int, total_bits: int) -> SafeType:
        return SafeType(list(inputs), bytes_per_ele, total_bits)

    def assert_bool(self, ctx: Context, input_: AssignedValue) -> SafeBool:
        self.gate.assert_bit(ctx, input_)
        return SafeBool(input_)

    def load_bool(self, ctx: Context, value: bool) -> SafeBool:
        cell = ctx.load_witness(int(value))
        return self.assert_bool(ctx, cell)

    @staticmethod
    def unsafe_to_bool(input_: AssignedValue) -> SafeBool:
        return SafeBool(input_)

    def assert_byte(self, ctx: Context, input_: AssignedValue) -> SafeByte:
        self.range_chip.range_check(ctx, input_, BITS_PER_BYTE)
        return SafeByte(input_)

    def load_byte(self, ctx: Context, value: int) -> SafeByte:
        cell = ctx.load_witness(value & 0xFF)
        return self.assert_byte(ctx, cell)

    @staticmethod
    def unsafe_to_byte(input_: AssignedValue) -> SafeByte:
        return SafeByte(input_)

    @staticmethod
    def unsafe_to_var_len_bytes(inputs, length: AssignedValue) -> VarLenBytes:
        return VarLenBytes([SafeByte(i) for i in inputs], length, len(inputs))

    @staticmethod
    def unsafe_to_var_len_bytes_vec(inputs, length: AssignedValue, max_len: int) -> VarLenBytes:
        return VarLenBytes([SafeByte(i) for i in inputs], length, max_len)

    @staticmethod
    def unsafe_to_fix_len_bytes(inputs) -> FixLenBytes:
        return FixLenBytes([SafeByte(i) for i in inputs])

    @staticmethod
    def unsafe_to_fix_len_bytes_vec(inputs, length: int) -> FixLenBytes:
        assert len(inputs) == length
        return FixLenBytes([SafeByte(i) for i in inputs])

    def raw_to_var_len_bytes(self, ctx: Context, inputs: list[AssignedValue], length: AssignedValue) -> VarLenBytes:
        max_len = len(inputs)
        self.range_chip.check_less_than_safe(ctx, length, max_len + 1)
        return VarLenBytes([self.assert_byte(ctx, i) for i in inputs], length, max_len)

    def raw_to_var_len_bytes_vec(self, ctx, inputs, length, max_len: int) -> VarLenBytes:
        self.range_chip.check_less_than_safe(ctx, length, max_len + 1)
        return VarLenBytes([self.assert_byte(ctx, i) for i in inputs], length, max_len)

    def raw_to_fix_len_bytes(self, ctx: Context, inputs: list[AssignedValue]) -> FixLenBytes:
        return FixLenBytes([self.assert_byte(ctx, i) for i in inputs])

    def raw_to_fix_len_bytes_vec(self, ctx, inputs, length: int) -> FixLenBytes:
        assert len(inputs) == length
        return FixLenBytes([self.assert_byte(ctx, i) for i in inputs])
