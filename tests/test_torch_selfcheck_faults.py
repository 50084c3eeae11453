"""What the prover's level-1 self-check (HALO2_PROVER_SELFCHECK=1,
backend/prover.py ``_selfcheck_h``) names, at k=9 on the CPU: a witness cell
changed after the builder, and a faulty device stage. Each proof stops just
after the check has printed (the rest of the proof is the degree guard's).
Also HALO2_NO_FOURSTEP_NTT=1's radix-2 route from 2^12 points.
"""

import pytest
import torch

from halo2_lib_tpu_torch.backend.prover import create_proof
from halo2_lib_tpu_torch.ops.limbs import DeviceField
from halo2_lib_tpu_torch.ops.ntt import NTT, CosetNTT, FourStepNTT, new_ntt
from halo2_lib_tpu_torch.utils.fields import FR_BN254
from halo2_lib_tpu_torch.utils.testing import golden_circuit
from torch_golden9 import golden, params, pk  # noqa: F401 (module-scoped fixtures)

# One core per test process: the suite runs in parallel workers.
torch.set_num_threads(1)


class _Stop(Exception):
    pass


@pytest.fixture
def checked(monkeypatch, capsys):
    """Run a proof under HALO2_PROVER_SELFCHECK=1 up to the check; return
    its failures (the ``[prover selfcheck]`` line's parts)."""
    from halo2_lib_tpu_torch.backend import prover

    real = prover._selfcheck_h

    def check_then_stop(*args):
        real(*args)
        raise _Stop

    monkeypatch.setattr(prover, "_selfcheck_h", check_then_stop)
    monkeypatch.setenv("HALO2_PROVER_SELFCHECK", "1")

    def run(*args, **kwargs):
        with pytest.raises(_Stop):
            create_proof(*args, **kwargs)
        err = capsys.readouterr().err.splitlines()
        line = next(ln for ln in err if ln.startswith("[prover selfcheck] "))
        return line[len("[prover selfcheck] "):].split("; ")

    return run


def test_selfcheck_names_a_tampered_witness_cell(checked, params, pk):
    """One advice cell that a copy constraint ties to a lookup cell, changed
    in the synthesized columns: level 1 names the last permutation z and the
    broken gate with its row. The JAX check's families (the grand products'
    recurrences, the lookups) still hold, since the z columns are computed
    from the tampered values: the JAX _selfcheck_h prints "all argument
    families hold on H" for this circuit and cell."""
    circuit = golden_circuit().synthesize()
    phase, col, row = next(left[1:] for left, _ in circuit.copies if left[0] == "advice")
    circuit.phases[phase].columns[col][row] += 1
    fails = checked(params, pk, circuit, seed=0, device="cpu")
    assert fails[0].startswith("permz") and fails[0].endswith(" last not bool"), fails
    gate = [f for f in fails if f.startswith("gate ")]
    assert len(fails) == 2 and gate and gate[0].startswith(f"gate col {col} row "), fails
    # the first failing gate row reads the tampered cell (rotations 0..3)
    assert row - 3 <= int(gate[0].rsplit(" ", 1)[1]) <= row, fails


def test_selfcheck_names_a_faulty_grand_product_row(monkeypatch, checked, params, pk):
    """A device fault in the grand products (row 5 of every prefix product
    over the rows off by one): level 1 names the JAX families and the row."""
    from halo2_lib_tpu_torch.ops import limbs

    real = limbs.DeviceField.prefix_prod

    def faulty(self, x):
        out = real(self, x)
        if x.shape[-1] == 1 << pk.vk.k:  # the z columns, not a power table
            out = out.clone()
            out[..., 0, 5] += 1
        return out

    monkeypatch.setattr(limbs.DeviceField, "prefix_prod", faulty)
    fails = checked(params, pk, golden_circuit(), seed=0, device="cpu")
    assert fails[0] == "permz0 row 5", fails
    assert "lk0 e3 row 5" in fails, fails


@pytest.mark.parametrize("log_n", [12, 13])
def test_no_fourstep_ntt_takes_the_radix2_stage_loop(monkeypatch, log_n):
    """HALO2_NO_FOURSTEP_NTT=1: new_ntt gives the radix-2 NTT from 2^12
    points (on the CPU; on the card the digit-plane DFT, or the radix-2 one
    with HALO2_NO_MXU_NTT=1), whose stage loop equals the four-step
    transform, plain and on the coset."""
    df = DeviceField(FR_BN254)
    n = 1 << log_n
    gen = torch.Generator().manual_seed(log_n)
    x = torch.randint(0, 1 << 16, (3, 16, n), generator=gen, dtype=torch.int32)
    x[:, 15] %= FR_BN254.p >> 240
    assert isinstance(new_ntt(df, log_n, "cpu"), FourStepNTT)
    want = FourStepNTT(df, log_n, "cpu")
    want_c = CosetNTT(df, log_n, 7, "cpu")
    monkeypatch.setenv("HALO2_NO_FOURSTEP_NTT", "1")
    got = new_ntt(df, log_n, "cpu")
    got_c = CosetNTT(df, log_n, 7, "cpu")
    assert type(got) is NTT and type(got_c.ntt) is NTT and got.CHUNK is not None
    assert torch.equal(got.forward_cols(x), want.forward_cols(x))
    assert torch.equal(got.inverse_cols(x), want.inverse_cols(x))
    assert torch.equal(got_c.forward_cols(x), want_c.forward_cols(x))
    assert torch.equal(got_c.inverse_cols(x), want_c.inverse_cols(x))
