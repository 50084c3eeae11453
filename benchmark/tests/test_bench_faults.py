"""The comparison that decides `correct`, shown to fail: the control (each
input handed to the program at a lower precision, or a witness cell
tampered) and the timed path broken underneath (an answer altered where
it is made, the first answer returned again, half of a batch left out).
Each runs a whole tiny cell on the CPU; the sound run of each cell must
come out correct. A prover asked to prove a tampered witness raises, and
a request that never answers is counted as failed."""

import pytest

from benchmark.tests import tiny


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny.make_checkout(str(tmp_path_factory.mktemp("faults")))


BROKEN = [
    ("tiny.commit", "--control", "truncate"),
    ("tiny.commit", "--fault", "altered"),
    ("tiny.commit", "--fault", "unchanged"),
    ("tiny.commit", "--fault", "half"),
    ("tiny.ntt", "--control", "truncate"),
    ("tiny.ntt", "--fault", "altered"),
    ("tiny.ntt", "--fault", "unchanged"),
]


@pytest.mark.parametrize("cell, kind, name", BROKEN)
def test_a_broken_kzg_cell_is_not_correct(checkout, cell, kind, name):
    out = tiny.last_json(tiny.run(checkout, cell, kind, name))
    assert out["correct"] is False
    assert out["failed"] == 0  # the answers came, and said the wrong thing
    wrong = out["checks"]["commitments_wrong" if "commit" in cell else "transforms_wrong"]["value"]
    assert wrong >= 1


def test_the_sound_prover_cell_is_correct(checkout):
    out = tiny.last_json(tiny.run(checkout, "tiny.prove"))
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 2


@pytest.mark.parametrize("kind, name, check", [
    ("--control", "other_srs", "proofs_rejected"),
    ("--control", "prank", "failed_requests"),
    ("--fault", "altered", "proofs_rejected"),
    ("--fault", "unchanged", "proofs_repeated"),
])
def test_a_broken_prover_cell_is_not_correct(checkout, kind, name, check):
    out = tiny.last_json(tiny.run(checkout, "tiny.prove", kind, name))
    assert out["correct"] is False
    assert out["checks"][check]["value"] >= 1
