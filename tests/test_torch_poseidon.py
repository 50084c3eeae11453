"""The port's Poseidon (poseidon/) and SafeTypes (safe_types.py) on the CPU:
the cases of tests/test_poseidon.py, test_poseidon_chip.py,
test_poseidon_kat.py (in-repo vectors) and test_safe_types.py, with every
in-circuit hash held to the JAX package's host Poseidon (live) and the
port's own, and the k=9 Poseidon + SafeTypes circuit of
base_test().bench_builder held to make_goldens.py --poseidon's JAX golden.

That circuit has 105 advice columns at k=9, so its keygen commits 108
columns: minutes of the kernels' plain versions on one core. Here its
synthesized circuit, selectors, fixed columns and sigma tensor (the keygen
stages before the commitments) are held to the golden; its vk and proof
bytes are held on the card (chip_smoke.py phase 9).
"""

import hashlib
import os
import random

import numpy as np
import pytest
import torch

from halo2_lib_tpu.poseidon.primitives import PoseidonNative as JaxPoseidonNative
from halo2_lib_tpu_torch.backend.keygen import _build_permutation, _perm_columns, sigma_mont_device
from halo2_lib_tpu_torch.backend.mock import MockProver
from halo2_lib_tpu_torch.backend.poly import domain
from halo2_lib_tpu_torch.convert import limbs_to_numpy
from halo2_lib_tpu_torch.core.cells import AssignedValue
from halo2_lib_tpu_torch.gates.circuit import BaseCircuitBuilder, CircuitBuilderStage
from halo2_lib_tpu_torch.gates.flex_gate import GateChip
from halo2_lib_tpu_torch.poseidon import PoseidonChip
from halo2_lib_tpu_torch.poseidon.hasher import PoseidonHasher, PoseidonSponge
from halo2_lib_tpu_torch.poseidon.primitives import PoseidonNative, generate_constants
from halo2_lib_tpu_torch.poseidon.spec import OptimizedPoseidonSpec, default_spec
from halo2_lib_tpu_torch.poseidon.state import PoseidonState
from halo2_lib_tpu_torch.safe_types import SafeTypeChip
from halo2_lib_tpu_torch.utils.fields import FR_BN254
from halo2_lib_tpu_torch.utils.testing import (
    POSEIDON_K, POSEIDON_LOOKUP_BITS, base_test, poseidon_inputs, poseidon_logic,
)

# One core per test process: the suite runs in parallel workers, and a
# thread pool per worker would oversubscribe the host.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tests", "data", "torch_goldens")


def native(inputs) -> int:
    """The host Poseidon of `inputs`, equal in the port and the JAX package."""
    h = PoseidonNative().hash_fixed(list(inputs))
    assert h == JaxPoseidonNative().hash_fixed(list(inputs))
    return h


def mock(f, k=12, lookup_bits=None, expect_ok=True):
    """f(ctx, chip) on a MOCK builder (chip: the range chip with lookup
    bits, else a GateChip), checked by the port's MockProver."""
    builder = BaseCircuitBuilder.from_stage(CircuitBuilderStage.MOCK).use_k(k)
    if lookup_bits is not None:
        builder.set_lookup_bits(lookup_bits)
        chip = builder.range_chip()
    else:
        chip = GateChip(FR_BN254)
    res = f(builder.main(0), chip)
    builder.calculate_params(minimum_rows=9)
    errors = MockProver.run(k, builder).verify()
    assert bool(errors) != expect_ok, "\n".join(errors[:5])
    return res


# --- tests/test_poseidon.py -----------------------------------------------------------


@pytest.mark.parametrize("n_inputs", [0, 1, 2, 3, 4, 5])
def test_fix_len_hash_matches_native(n_inputs):
    rng = random.Random(100 + n_inputs)
    inputs = [rng.randrange(FR_BN254.p) for _ in range(n_inputs)]

    def f(ctx, gate):
        hasher = PoseidonHasher(default_spec())
        hasher.initialize_consts(ctx, gate)
        return hasher.hash_fix_len_array(ctx, gate, [ctx.load_witness(v) for v in inputs]).val()

    assert mock(f) == native(inputs)


def test_sponge_multiple_squeeze():
    rng = random.Random(200)
    a = [rng.randrange(FR_BN254.p) for _ in range(3)]
    b = [rng.randrange(FR_BN254.p) for _ in range(2)]

    def f(ctx, gate):
        sponge = PoseidonSponge(ctx, default_spec())
        sponge.update([ctx.load_witness(v) for v in a])
        h1 = sponge.squeeze(ctx, gate)
        sponge.update([ctx.load_witness(v) for v in b])
        h2 = sponge.squeeze(ctx, gate)
        return h1.val(), h2.val()

    h1, h2 = mock(f)
    assert h1 == native(a)
    assert h2 != h1


@pytest.mark.parametrize("max_len,length", [(5, 3), (4, 4), (6, 0), (2, 2)])
def test_var_len_hash_matches_native(max_len, length):
    rng = random.Random(300 + max_len * 10 + length)
    inputs = [rng.randrange(FR_BN254.p) for _ in range(max_len)]

    def f(ctx, range_chip):
        hasher = PoseidonHasher(default_spec())
        hasher.initialize_consts(ctx, range_chip.gate)
        cells = [ctx.load_witness(v) for v in inputs]
        return hasher.hash_var_len_array(ctx, range_chip, cells, ctx.load_witness(length)).val()

    assert mock(f, k=13, lookup_bits=12) == native(inputs[:length])


def test_empty_hash_cached():
    def f(ctx, gate):
        hasher = PoseidonHasher(default_spec())
        hasher.initialize_consts(ctx, gate)
        return hasher._empty_hash.val()

    assert mock(f) == native([])


# --- tests/test_poseidon_chip.py ------------------------------------------------------


@pytest.mark.parametrize("n_bytes", [0, 1, 5, 31])
def test_hash_fix_len_bytes_matches_native(n_bytes):
    rng = random.Random(7 + n_bytes)
    data = [rng.randrange(256) for _ in range(n_bytes)]

    def f(ctx, range_chip):
        chip = PoseidonChip(ctx, default_spec(), range_chip)
        fx = SafeTypeChip(range_chip).raw_to_fix_len_bytes(ctx, [ctx.load_witness(b) for b in data])
        return chip.hash_fix_len_bytes(ctx, fx).val()

    assert mock(f, lookup_bits=8) == native(data)


@pytest.mark.parametrize("max_len,length", [(8, 0), (8, 3), (8, 8), (17, 5)])
def test_hash_var_len_bytes_matches_native(max_len, length):
    rng = random.Random(11 + max_len + length)
    data = [rng.randrange(256) for _ in range(length)] + [0] * (max_len - length)

    def f(ctx, range_chip):
        chip = PoseidonChip(ctx, default_spec(), range_chip)
        safe = SafeTypeChip(range_chip)
        cells = [ctx.load_witness(b) for b in data]
        len_cell = ctx.load_witness(length)
        h = chip.hash_var_len_bytes(ctx, safe.raw_to_var_len_bytes(ctx, cells, len_cell))
        vbv = safe.raw_to_var_len_bytes_vec(ctx, cells, len_cell, max_len)
        return h.val(), chip.hash_var_len_bytes_vec(ctx, vbv).val()

    h, h_vec = mock(f, lookup_bits=8)
    assert h == h_vec == native(data[:length])


def test_hash_fix_len_bytes_bad_byte_rejected():
    """A value >= 256 fails the SafeByte range check in the mock."""

    def f(ctx, range_chip):
        chip = PoseidonChip(ctx, default_spec(), range_chip)
        fx = SafeTypeChip(range_chip).raw_to_fix_len_bytes(ctx, [ctx.load_witness(300)])
        chip.hash_fix_len_bytes(ctx, fx)

    mock(f, lookup_bits=8, expect_ok=False)


# --- tests/test_poseidon_kat.py (the reference's literals, in that file) ----------------


def _kat():
    """test_poseidon_kat.py's external vectors, read from that file."""
    import test_poseidon_kat as kat

    return kat


def test_mds_matches_reference_literal():
    _, mds, _ = generate_constants(FR_BN254, 3, 8, 57)
    assert mds == _kat().MDS_X5_254_3


@pytest.mark.parametrize("t,r_p,name", [(3, 57, "PERM_X5_254_3"), (5, 60, "PERM_X5_254_5")])
@pytest.mark.parametrize("var_len", [None, False, True], ids=["native", "fix", "var"])
def test_permutation_matches_hadeshash(t, r_p, name, var_len):
    """The native permutation and the in-circuit optimized (sparse-MDS) one,
    fixed- and variable-length, from state [0..t) with `rate` zeros
    absorbed, equal the hadeshash vectors."""
    expected = getattr(_kat(), name)
    if var_len is None:
        assert PoseidonNative(FR_BN254, t, t - 1, 8, r_p).permutation(list(range(t))) == expected
        return
    rate = t - 1
    ctx = BaseCircuitBuilder.from_stage(CircuitBuilderStage.MOCK).use_k(11).main(0)
    spec = OptimizedPoseidonSpec(FR_BN254, t, rate, 8, r_p)
    state = PoseidonState([ctx.load_constant(v) for v in range(t)])
    inputs = [ctx.load_constant(0) for _ in range(rate)]
    length = ctx.load_constant(rate) if var_len else None
    state.permutation(ctx, GateChip(FR_BN254), inputs, length, spec)
    assert [s.val() for s in state.s] == expected
    assert all(isinstance(s, AssignedValue) for s in state.s)


# --- tests/test_safe_types.py -------------------------------------------------------------


def safe_run(f, expect_ok=True):
    def g(ctx, rc):
        return f(ctx, SafeTypeChip(rc), rc.gate)

    return mock(g, k=11, lookup_bits=10, expect_ok=expect_ok)


def test_safe_bool_byte():
    def f(ctx, chip, gate):
        return chip.load_bool(ctx, True).value.val(), chip.load_byte(ctx, 200).value.val()

    assert safe_run(f) == (1, 200)


@pytest.mark.parametrize("kind,value", [("byte", 300), ("bool", 2)])
def test_bad_safe_value_fails(kind, value):
    def f(ctx, chip, gate):
        getattr(chip, f"assert_{kind}")(ctx, ctx.load_witness(value))

    safe_run(f, expect_ok=False)


@pytest.mark.parametrize("bytes_per_ele,total_bits,n", [(1, 256, 32), (8, 128, 16)])
def test_raw_bytes_packing(bytes_per_ele, total_bits, n):
    """raw_bytes_to packs bytes_per_ele bytes an element, little-endian."""
    rng = random.Random(51 if bytes_per_ele == 1 else 52)
    raw = [rng.randrange(256) for _ in range(n)]

    def f(ctx, chip, gate):
        st = chip.raw_bytes_to(ctx, [ctx.load_witness(v) for v in raw], bytes_per_ele, total_bits)
        return [c.val() for c in st.values]

    want = [sum(raw[i + j] << (8 * j) for j in range(bytes_per_ele))
            for i in range(0, n, bytes_per_ele)]
    assert safe_run(f) == want


@pytest.mark.parametrize("method,data,want", [
    ("left_pad_to_fixed", [5, 6, 7, 0, 0], [0, 0, 5, 6, 7]),
    ("ensure_0_padding", [5, 6, 7, 99, 88], [5, 6, 7, 0, 0]),
])
def test_var_len_bytes(method, data, want):
    def f(ctx, chip, gate):
        vb = chip.raw_to_var_len_bytes(ctx, [ctx.load_witness(v) for v in data],
                                       ctx.load_witness(3))
        return [b.value.val() for b in getattr(vb, method)(ctx, gate).bytes]

    assert safe_run(f) == want


# --- the k=9 Poseidon + SafeTypes circuit against the JAX golden --------------------------


def circuit_digest(circuit) -> str:
    """make_goldens.py's digest of a synthesized circuit."""
    h = hashlib.sha256()
    for part in ([fp.columns for fp in circuit.phases], [fp.selectors for fp in circuit.phases],
                 circuit.lookup_cols, circuit.fixed_cols, circuit.copies, circuit.instances):
        h.update(repr(part).encode())
    return h.hexdigest()


def test_poseidon_circuit_matches_jax_golden():
    """The keygen builder of the bench_builder circuit synthesizes to the JAX
    builder's circuit; its selectors, fixed columns and sigma tensor equal
    the JAX key's; its two hashes equal the host Poseidon."""
    gold = np.load(os.path.join(GOLDENS, "poseidon_k9.npz"))
    inputs = poseidon_inputs(1)
    builder = BaseCircuitBuilder.from_stage(CircuitBuilderStage.MOCK).use_k(POSEIDON_K)
    builder.set_lookup_bits(POSEIDON_LOOKUP_BITS)
    h_fix, h_var = poseidon_logic(builder.pool(0), builder.range_chip(), inputs)
    builder.calculate_params(minimum_rows=9)
    p = builder.config_params
    p.num_advice_per_phase[0] = max(p.num_advice_per_phase[0], 2)
    p.num_lookup_advice_per_phase[0] = max(p.num_lookup_advice_per_phase[0], 1)
    circuit = builder.synthesize()
    assert circuit_digest(circuit) == bytes(gold["circuit_sha256"]).hex()
    fixed, var, length, _, _ = inputs
    assert (h_fix.val(), h_var.val()) == (native(fixed), native(var[:length]))

    n = 1 << POSEIDON_K
    sel = np.zeros((len(circuit.phases[0].selectors), n), dtype=np.uint8)
    for i, s in enumerate(circuit.phases[0].selectors):
        sel[i, : len(s)] = s
    assert np.array_equal(sel, np.asarray(gold["selectors"]).reshape(-1, n))
    fixed_cols = np.asarray(gold["fixed_cols"], dtype="<u2")
    for col, want in zip(circuit.fixed_cols, fixed_cols):
        buf = want.tobytes()
        assert list(col) + [0] * (n - len(col)) == [
            int.from_bytes(buf[32 * i : 32 * (i + 1)], "little") for i in range(n)
        ]
    nc, nr = _build_permutation(circuit, n, _perm_columns(circuit))
    sigma = sigma_mont_device(domain(POSEIDON_K).df, domain(POSEIDON_K), nc, nr, "cpu")
    assert np.array_equal(limbs_to_numpy(sigma), np.asarray(gold["perm_values"]).astype(np.uint32))


def test_bench_builder_needs_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        base_test().use_k(POSEIDON_K).use_lookup_bits(POSEIDON_LOOKUP_BITS).bench_builder(
            poseidon_inputs(1), poseidon_inputs(2), poseidon_logic)
