"""The port's device MockProver (backend/mock_device.py) on the CPU, where
its field kernels run their plain versions: the same verdict as the port's
host MockProver and the same errors as the JAX package's DeviceMockProver
(live), on tests/test_mock_device.py's positive and pranked circuits, a
broken copy and an out-of-range lookup value."""

import random

import pytest
import torch

from halo2_lib_tpu.backend.mock_device import DeviceMockProver as JaxDeviceMockProver
from halo2_lib_tpu.core import cells as jcells
from halo2_lib_tpu.gates import circuit as jcircuit
from halo2_lib_tpu_torch.backend.mock import MockProver
from halo2_lib_tpu_torch.backend.mock_device import DeviceMockProver
from halo2_lib_tpu_torch.core import cells
from halo2_lib_tpu_torch.gates import circuit

# One core per test process: the suite runs in parallel workers, and a
# thread pool per worker would oversubscribe the host.
torch.set_num_threads(1)

PACKAGES = {"port": (circuit, cells), "jax": (jcircuit, jcells)}


def build(pkg: str, k=10, prank=False, lookup_col=False):
    """tests/test_mock_device.py's circuit with `pkg`'s eDSL, synthesized;
    with `lookup_col`, at >= 2 advice and 1 lookup-advice column (the range
    checks' limbs then sit in a lookup column, not on q_lookup rows)."""
    C, cl = PACKAGES[pkg]
    builder = C.BaseCircuitBuilder.from_stage(C.CircuitBuilderStage.MOCK).use_k(k)
    builder.set_lookup_bits(8)
    rc = builder.range_chip()
    gate = rc.gate
    ctx = builder.main(0)
    rng = random.Random(61)
    xs = [ctx.load_witness(rng.randrange(1 << 32)) for _ in range(50)]
    acc = xs[0]
    for x in xs[1:]:
        acc = gate.mul_add(ctx, cl.Existing(acc), cl.Existing(x), cl.Constant(5))
        rc.range_check(ctx, x, 40)
    gate.select(ctx, cl.Existing(xs[0]), cl.Existing(xs[1]), cl.Existing(gate.is_zero(ctx, xs[2])))
    if prank:
        acc.debug_prank(ctx, 12345)
    builder.calculate_params(minimum_rows=9)
    if lookup_col:
        p = builder.config_params
        p.num_advice_per_phase[0] = max(p.num_advice_per_phase[0], 2)
        p.num_lookup_advice_per_phase[0] = max(p.num_lookup_advice_per_phase[0], 1)
    return builder.synthesize()


def _break_copy(c):
    """A copy between two advice cells of different values."""
    a, b = ("advice", 0, 0, 0), ("advice", 0, 0, 1)
    assert c.phases[0].columns[0][0] != c.phases[0].columns[0][1]
    c.copies.append((a, b))
    return c


def _bad_lookup(c):
    """Lookup-advice row 3 set to 2^lookup_bits: out of range, and its copy
    to the advice cell it range-checks broken."""
    c.lookup_cols[0][0][3] = 1 << c.params.lookup_bits
    return c


CASES = {
    "positive": (dict(), None),
    "pranked": (dict(prank=True), None),
    "broken_copy": (dict(), _break_copy),
    "bad_lookup": (dict(lookup_col=True), _bad_lookup),
}
WANT = {
    "positive": [],
    "pranked": None,  # gate failures, named as the JAX package names them
    "broken_copy": ["1 copy constraint failures"],
    "bad_lookup": ["1 copy constraint failures", "1 lookup failures"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_device_mock_agrees_with_host_and_jax(case):
    kw, edit = CASES[case]
    port_c, jax_c = (build(pkg, **kw) for pkg in ("port", "jax"))
    if edit is not None:
        edit(port_c), edit(jax_c)
    got = DeviceMockProver(port_c, "cpu").verify()
    host = MockProver(port_c, None).verify()
    assert got == JaxDeviceMockProver(jax_c).verify()
    assert bool(got) == bool(host)
    if WANT[case] is not None:
        assert got == WANT[case]
    else:
        assert got and all(e.startswith("gate failure at phase 0 column 0 row ") for e in got)
        assert host[0].startswith(got[0] + ":")


def test_device_mock_needs_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        DeviceMockProver(build("port"))
