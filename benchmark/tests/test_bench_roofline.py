"""The roofline's work counts against hand-worked values, and its constants."""

import pytest

from benchmark.roofline import peaks, work


def test_constants_and_their_derivations():
    assert peaks.INT_MULS_PER_FIELD_PRODUCT == 2 * 8 * 8 + 8 == 136
    assert peaks.INT_MULS_PER_S == pytest.approx(132 * 64 * 1.983e9, rel=1e-3)
    assert peaks.INT_MULS_PER_S == 16.75e12
    assert peaks.HBM_BYTES_PER_S == 3.35e12


def test_ntt_work_by_hand():
    # 8 points: 4 butterflies a stage, 3 stages; 8 elements in and out at 32 bytes
    assert work.ntt_work(1, 3) == work.Work(products=12, bytes=512)
    # 2^22 points, two columns: 2 * 2^21 * 22 products, 2 * 2 * 2^22 * 32 bytes
    assert work.ntt_work(2, 22) == work.Work(92_274_688, 536_870_912)


@pytest.mark.parametrize("m, c", [(1 << 20, 16), (1 << 17, 13), (1 << 15, 11), (1024, 7)])
def test_pippenger_window_by_hand(m, c):
    # 2^20: c=15 gives 17 * (2^20 + 2^16) = 18,939,904 additions, c=16 16 *
    # (2^20 + 2^17) = 18,874,368, c=17 15 * (2^20 + 2^18) = 19,660,800;
    # 2^17: c=12 22 * 139,264 = 3,063,808, c=13 20 * 147,456 = 2,949,120,
    # c=14 19 * 163,840 = 3,112,960
    cost = lambda c_: -(-254 // c_) * (m + (1 << (c_ + 1)))
    assert work.pippenger_window(m) == c
    assert cost(c) < cost(c - 1) and cost(c) <= cost(c + 1)


def test_msm_work_by_hand():
    # one column of 2^20: 16 windows x (2^20 mixed adds x 11 + 2^17 full adds
    # x 16), 254 doublings x 7 and 16 window adds x 16
    w = work.msm_work(1, 1 << 20)
    assert w.products == 16 * ((1 << 20) * 11 + (1 << 17) * 16) + 254 * 7 + 16 * 16 == 218_105_842
    assert w.bytes == (1 << 20) * 64 + (1 << 20) * 32 + 64 == 100_663_360
    # 98 columns of 2^17: the bases once, every column's scalars and result
    w98 = work.msm_work(98, 1 << 17)
    per_col = 20 * ((1 << 17) * 11 + (1 << 14) * 16) + 254 * 7 + 20 * 16
    assert w98.products == 98 * per_col
    assert w98.bytes == (1 << 17) * 64 + 98 * (1 << 17) * 32 + 98 * 64


def test_roofline_seconds_take_the_larger_bound():
    w = work.Work(products=1_000_000, bytes=10)
    assert work.roofline_s(w) == pytest.approx(1_000_000 * 136 / 16.75e12)
    assert work.bound_by(w) == "products"
    w = work.Work(products=1, bytes=3_350_000_000)
    assert work.roofline_s(w) == pytest.approx(1e-3)
    assert work.bound_by(w) == "bytes"
    # the north star's shapes are bound by their products
    assert work.bound_by(work.msm_work(1, 1 << 20)) == work.bound_by(work.ntt_work(1, 22)) == "products"
