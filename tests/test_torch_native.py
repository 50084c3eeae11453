"""The port's host witness engine (halo2_lib_tpu_torch/native.py,
csrc/host_engine.c) against its own Python path and the JAX package's engine.

The engine emits the cells of the hot gadget layouts (assign_region,
inner_product, range_check), packs columns into u16 limbs (_u16_cols) and
checks gate columns for the mock. Each must give what the Python path gives,
bit for bit, and what the JAX package gives with its own engine. Both
engines register their cell classes in C statics; the port's build is a
module of its own, so in one process each package gets its own classes.
"""

import os
import random
import time

import numpy as np
import pytest
import torch

from halo2_lib_tpu_torch import native
from halo2_lib_tpu_torch.ops.limbs import ints_to_limbs
from halo2_lib_tpu_torch.utils.fields import FR_BN254
from torch_jaxfree import jaxfree_instance_run

# One core per test process: the suite runs in parallel workers.
torch.set_num_threads(1)

P = FR_BN254.p


def _jax_engine():
    """The JAX package's engine. Its loader builds native/halo2_native*.so in
    place, so a parallel worker may meet a half-written build and be told
    None: ask again."""
    import halo2_lib_tpu.native as jn

    for _ in range(20):
        if jn.get_native() is not None:
            return jn.get_native()
        jn._TRIED = False
        time.sleep(0.5)
    raise AssertionError("the JAX package's native engine does not load")


def _port():
    from halo2_lib_tpu_torch.core import cells
    from halo2_lib_tpu_torch.gates import circuit, flex_gate

    return cells, circuit, flex_gate, FR_BN254


def _jax():
    _jax_engine()
    from halo2_lib_tpu.core import cells
    from halo2_lib_tpu.gates import circuit, flex_gate
    from halo2_lib_tpu.utils.fields import FR_BN254 as jax_fr

    return cells, circuit, flex_gate, jax_fr


def _mixed_trace(mods, wg: bool, g=None):
    """tests/test_native.py's trace: every QCell kind, a b[0] == 1 and a
    general inner product, fractions, negative gate offsets and external
    equalities (assign_region_smart); through the gate chip `g` if given."""
    cells, circuit, flex_gate, field = mods
    Constant, Existing, Witness = cells.Constant, cells.Existing, cells.Witness
    if wg:
        params = circuit.BaseCircuitParams(
            k=9, num_advice_per_phase=[1], num_fixed=1, num_lookup_advice_per_phase=[0],
            lookup_bits=None, num_instance_columns=0,
        )
        b = circuit.BaseCircuitBuilder.prover(params, [[]])
    else:
        b = circuit.BaseCircuitBuilder.from_stage(circuit.CircuitBuilderStage.MOCK).use_k(9)
    g = g or flex_gate.GateChip(field)
    ctx = b.main(0)
    rng = random.Random(99)
    w = [ctx.load_witness(rng.randrange(P)) for _ in range(6)]
    g.inner_product(
        ctx,
        [Existing(w[0]), Witness(123), Constant(5), Existing(w[1])],
        [Constant(1), Existing(w[2]), Witness(77), Constant(9)],
    )
    g.inner_product(
        ctx,
        [Witness(rng.randrange(P)) for _ in range(5)],
        [Existing(w[3])] + [Constant(rng.randrange(P)) for _ in range(4)],
    )
    g.mul(ctx, w[4], w[5])
    # fractions flow through untouched
    ctx.assign_region([cells.WitnessFraction(3, 7), Constant(0), Constant(0), Witness(0)], [])
    # negative gate offsets via assign_region_smart
    ctx.assign_region_smart(
        [Witness(1), Witness(2)], [-2], [(0, -3)], [(w[0].cell, -1)] if not wg else []
    )
    return b, ctx, g


def _values(ctx, b, wg: bool):
    """The trace as plain values: advice (fractions as (num, den)),
    selectors, and the copy tuples as nested tuples."""
    advice = [v if type(v) is int else (v.num, v.den) for v in ctx.advice]
    if wg:
        return advice, list(ctx.selector), None, None
    cm = b.core.copy_manager
    adv = [(tuple(l), tuple(r)) for l, r in cm.advice_equalities]
    const = [(v, tuple(c)) for v, c in cm.constant_equalities]
    return advice, list(ctx.selector), adv, const


def test_engine_is_loaded_on_the_default_path():
    """Without HALO2_NO_NATIVE the port builds and loads its own engine from
    _build/, and every hook asks native.py for it: no silent Python path."""
    from halo2_lib_tpu_torch.core import context
    from halo2_lib_tpu_torch.gates import flex_gate

    mod = native.get_native()
    assert mod is not None and mod.__name__ == "h2t_host_engine"
    assert os.path.dirname(mod.__file__) == native.BUILD_DIR
    assert not hasattr(mod, "msm_commit") and hasattr(mod, "pack_limbs16")
    assert native.get_region_mod() is mod and native.get_emitter(P).mod is mod
    assert context.get_region_mod is native.get_region_mod
    assert flex_gate.get_emitter is native.get_emitter
    # one build in _build/: the loader removes the builds of other hashes
    builds = [f for f in os.listdir(native.BUILD_DIR)
              if f.startswith(native.MODULE + "_") and not f.endswith(".tmp")]
    assert builds == [os.path.basename(mod.__file__)]


@pytest.mark.parametrize("wg", [False, True])
def test_mixed_trace_engine_equals_python_path(wg):
    from halo2_lib_tpu_torch.core.cells import ContextCell

    from halo2_lib_tpu_torch.gates.flex_gate import GateChip

    mod = native.get_native()
    calls = {"emit_region": 0, "emit_inner_product": 0}

    def counted(name, fn):
        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call

    early = GateChip(FR_BN254)  # made before python_path: it takes it too
    saved = {name: getattr(mod, name) for name in calls}
    try:
        for name in calls:
            setattr(mod, name, counted(name, saved[name]))
        with native.python_path():
            assert native.get_emitter(P) is None and native.get_region_mod() is None
            bp, cp, gp = _mixed_trace(_port(), wg, early)
        assert calls == {"emit_region": 0, "emit_inner_product": 0}
        bn, cn, gn = _mixed_trace(_port(), wg, early)
        assert calls["emit_region"] > 0 and calls["emit_inner_product"] > 0
    finally:
        for name, fn in saved.items():
            setattr(mod, name, fn)
    got, want = _values(cn, bn, wg), _values(cp, bp, wg)
    assert got == want
    assert cn.advice == cp.advice and cn.selector == cp.selector
    if not wg:
        cmn, cmp_ = bn.core.copy_manager, bp.core.copy_manager
        assert cmn.advice_equalities == cmp_.advice_equalities
        assert cmn.constant_equalities == cmp_.constant_equalities
        for l, r in cmn.advice_equalities:
            assert type(l) is ContextCell and type(r) is ContextCell
        for _, c in cmn.constant_equalities:
            assert type(c) is ContextCell


@pytest.mark.parametrize("wg", [False, True])
def test_mixed_trace_equals_the_jax_engine(wg):
    """The port's engine against the JAX package's engine, as values."""
    bj, cj, _ = _mixed_trace(_jax(), wg)
    bt, ct, _ = _mixed_trace(_port(), wg)
    assert _values(ct, bt, wg) == _values(cj, bj, wg)


def test_each_engine_builds_its_own_packages_cells():
    """JAX-package cells and port cells built in one process, in turns, each
    through its own engine: every cell, copy and lookup row is of its own
    package's classes."""
    import halo2_lib_tpu.core.cells as jcells
    import halo2_lib_tpu.gates.circuit as jcircuit
    from halo2_lib_tpu_torch.core import cells as tcells
    from halo2_lib_tpu_torch.gates import circuit as tcircuit

    jax_engine = _jax_engine()
    assert jax_engine is not native.get_native()

    def build(cells, circuit):
        b = circuit.BaseCircuitBuilder.from_stage(circuit.CircuitBuilderStage.MOCK).use_k(10)
        b.set_lookup_bits(8)
        rc = b.range_chip()
        ctx = b.main(0)
        x = ctx.load_witness(0xDEADBEEF12345)
        rc.range_check(ctx, x, 64)
        y = rc.gate.mul(ctx, cells.Existing(x), cells.Constant(3))
        rows = [t for t in b.lookup_manager[0].iter_rows()]
        cm = b.core.copy_manager
        return ctx, y, rows, cm

    runs = [(jcells, build(jcells, jcircuit)), (tcells, build(tcells, tcircuit)),
            (jcells, build(jcells, jcircuit))]
    for cells, (ctx, y, rows, cm) in runs:
        assert type(y) is cells.AssignedValue and type(y.cell) is cells.ContextCell
        assert rows and all(type(av) is cells.AssignedValue and type(av.cell) is cells.ContextCell
                            for row in rows for av in row)
        assert cm.advice_equalities and cm.constant_equalities
        assert all(type(c) is cells.ContextCell for pair in cm.advice_equalities for c in pair)
        assert all(type(c) is cells.ContextCell for _, c in cm.constant_equalities)
    # the same circuit in both packages: the same values
    (_, (cj, _, rj, _)), (_, (ct, _, rt, _)) = runs[0], runs[1]
    assert ct.advice == cj.advice and ct.selector == cj.selector
    assert [[av.value for av in r] for r in rt] == [[av.value for av in r] for r in rj]


def _range_build():
    """tests/test_native_range.py's circuit: range checks of 16..130 bits at
    lookup_bits 8, then is_less_than; the flattened columns, selectors,
    lookup rows and the number of copies."""
    from halo2_lib_tpu_torch.backend.mock import MockProver
    from halo2_lib_tpu_torch.core.cells import Constant, Existing
    from halo2_lib_tpu_torch.gates.circuit import BaseCircuitBuilder, CircuitBuilderStage

    K = 10
    rng = random.Random(7)
    builder = BaseCircuitBuilder.from_stage(CircuitBuilderStage.MOCK).use_k(K)
    builder.set_lookup_bits(8)
    rc = builder.range_chip()
    ctx = builder.main(0)
    for bits in (16, 24, 33, 64, 88, 130, 17):
        x = ctx.load_witness(rng.randrange(1 << bits))
        rc.range_check(ctx, x, bits)
    a = ctx.load_witness(1234)
    assert rc.is_less_than(ctx, Existing(a), Constant(2000), 16).val() == 1
    builder.calculate_params(minimum_rows=9)
    assert not MockProver.run(K, builder).verify()
    fp = builder.core.phase_manager[0].flatten_with_constraints(4, (1 << K) - 9)
    rows = [tuple(c.value for c in t) for t in builder.lookup_manager[0].iter_rows()]
    ncopies = len(builder.core.copy_manager.advice_equalities)
    return fp.columns, [list(map(bool, s)) for s in fp.selectors], rows, ncopies


def test_range_check_bit_identical():
    engine = _range_build()
    with native.python_path():
        python = _range_build()
    assert engine == python


def test_pack_limbs16_equals_ints_to_limbs():
    from halo2_lib_tpu_torch.backend.prover import _u16_cols

    rng = np.random.default_rng(14)
    full = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(3000)]
    small = [int(v) for v in rng.integers(0, 1 << 20, 1000)]
    vals = [0, 1, P - 1, 2**64 - 1, 2**64, 2**256 - 1] + small + full
    mod = native.get_native()
    got = np.frombuffer(mod.pack_limbs16(vals), dtype="<u2").reshape(-1, 16)
    assert np.array_equal(got, ints_to_limbs(vals).astype(np.uint16))
    cols = [full[:1024], small[:512] + full[:512], [0] * 1024]
    engine = _u16_cols(cols, 1024)
    with native.python_path():
        python = _u16_cols(cols, 1024)
    assert engine.dtype == python.dtype == np.uint16
    assert np.array_equal(engine, python)
    with pytest.raises(ValueError):
        mod.pack_limbs16([1, -1])


def test_native_field_ops_and_gate_column():
    """The engine's modmul_vec / modadd_vec / modsub_vec (kept in the C
    source as in the JAX package's, with no wrapper) and NativeField's gate
    column check, against the host ints."""
    nf = native.NativeField(P)
    assert nf.available
    rng = random.Random(1)
    a = [rng.randrange(P) for _ in range(257)] + [0, P - 1]
    b = [rng.randrange(P) for _ in range(257)] + [P - 1, P - 1]
    mod = native.get_native()
    pb, r2 = P.to_bytes(32, "little"), pow(2, 512, P).to_bytes(32, "little")
    ab, bb = mod.pack_limbs16(a), mod.pack_limbs16(b)
    for op, want in (("modmul_vec", lambda x, y: x * y % P),
                     ("modadd_vec", lambda x, y: (x + y) % P),
                     ("modsub_vec", lambda x, y: (x - y) % P)):
        out = getattr(mod, op)(pb, r2, ab, bb)
        got = [int.from_bytes(out[i : i + 32], "little") for i in range(0, len(out), 32)]
        assert got == [want(x, y) for x, y in zip(a, b)], op
    with pytest.raises(ValueError):
        mod.modmul_vec(pb, r2, ab, bb[:-32])
    rng = random.Random(2)
    n = 500
    vals = [rng.randrange(P) for _ in range(n)]
    sels = [False] * n
    for r in (3, 100, 400):
        vals[r + 3] = (vals[r] + vals[r + 1] * vals[r + 2]) % P
        sels[r] = True
    assert nf.check_gate_column(vals, sels) == -1
    # a selector list shorter than the column gates no row past its end
    assert nf.check_gate_column(vals, sels[:200]) == -1
    vals[103] = (vals[103] + 1) % P
    assert nf.check_gate_column(vals, sels) == 100
    with native.python_path():
        assert native.NativeField(P).check_gate_column(vals, sels) is None


def test_native_mock_catches_a_tampered_cell():
    """The host MockProver's Python gate scan (gate_failures) passes a good
    circuit and names a tampered cell, with the engine loaded and on the
    Python path alike; the engine's check_gate_column names the same first
    row of every column."""
    from halo2_lib_tpu_torch.backend.mock import MockProver, gate_failures
    from halo2_lib_tpu_torch.core.cells import Existing
    from halo2_lib_tpu_torch.gates.circuit import BaseCircuitBuilder, CircuitBuilderStage
    from halo2_lib_tpu_torch.gates.flex_gate import GateChip

    def build(prank):
        b = BaseCircuitBuilder.from_stage(CircuitBuilderStage.MOCK).use_k(8)
        gate = GateChip(FR_BN254)
        ctx = b.main(0)
        x = ctx.load_witness(7)
        y = gate.mul(ctx, Existing(x), Existing(x))
        z = gate.add(ctx, Existing(y), Existing(x))
        if prank:
            z.debug_prank(ctx, 5)
        b.calculate_params(minimum_rows=9)
        return b

    errors = MockProver.run(8, build(True)).verify()
    assert errors and "gate failure" in errors[0]
    assert MockProver.run(8, build(False)).verify() == []
    with native.python_path():
        assert MockProver.run(8, build(True)).verify() == errors
    nf = native.NativeField(P)
    for prank in (False, True):
        circuit = build(prank).synthesize()
        firsts = [(nf.check_gate_column(v, s), next(gate_failures(v, s, P), (-1,))[0])
                  for fp in circuit.phases for v, s in zip(fp.columns, fp.selectors)]
        assert all(c == py for c, py in firsts)
        assert any(c >= 0 for c, _ in firsts) == prank


def test_prove_leaves_nothing_to_the_collector(tmp_path_factory):
    """keygen -> create_proof -> verify_proof (torch_jaxfree.py's k=9 run,
    the collector off) leave no reference cycle behind: the key, its cached
    runtime and the proof's tensors go when their last reference does, not
    when the collector next runs (which the engine, making fewer Python
    objects, puts off; at k=17 the card would hold them)."""
    run = jaxfree_instance_run(tmp_path_factory)
    assert "error" not in run, run.get("error")
    assert run["verifies"] and run["left_to_collector"] == []


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """No hidden fallback: a source that does not compile, or no compiler,
    raises with the reason; HALO2_NO_NATIVE=1 alone gives the Python path."""
    bad = tmp_path / "host_engine.c"
    bad.write_text('#error "broken host engine"\n')
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_NATIVE", None)
    with pytest.raises(RuntimeError, match="broken host engine"):
        native.get_native()
    assert not native._TRIED
    monkeypatch.setenv("CC", "no-such-c-compiler")
    with pytest.raises(RuntimeError, match="no C compiler"):
        native.get_native()
    monkeypatch.setenv("HALO2_NO_NATIVE", "1")
    assert native.get_native() is None
    assert not os.listdir(tmp_path / "_build")
