"""The yardstick's counting against hand-worked values."""

import pytest

from benchmark import roofline as rl


def test_bound_picks_the_longer_side():
    assert rl.bound(3.35e12, 0) == (pytest.approx(1.0), "bytes")
    t, by = rl.bound(1, rl.INT32_OPS_S * 2)
    assert t == pytest.approx(2.0) and by == "operations"
    assert rl.INT32_OPS_S == 132 * 64 * 1.98e9


def test_dp_cells_clamp_each_tile_to_T():
    # 320x320 + 100x50 + 320x10 (ref clamped) + 0 (negative length)
    assert rl.dp_cells([320, 100, 400, -1], [320, 50, 10, 5], 320) == \
        102400 + 5000 + 3200


def test_dp_bound_of_a_small_call():
    # B = 2 tiles of T = 4: bytes in (2x4 ref, 2x4 query, 2+2 int32
    # lengths = 32) and out (2x4x5 dir bytes = 40, four int32 stats a
    # tile = 32): 104 bytes; cells 4x4 + 2x3 = 22, ops 15 a cell.
    t, by = rl.dp_bound(104, rl.dp_cells([4, 2], [4, 3], 4))
    assert by == "bytes"
    assert t == pytest.approx(104 / 3.35e12)
    assert rl.dp_bound(0, 22)[0] == pytest.approx(22 * 15 / rl.INT32_OPS_S)


def test_busy_is_the_union_of_overlapping_intervals():
    ev = [("a", 0, 10), ("b", 5, 15), ("a", 20, 30)]
    s = rl.device_summary(ev, 7, 0, 40)
    assert s["busy_s"] == pytest.approx(25e-9)   # not 30 (the sum)
    assert s["window_s"] == pytest.approx(40e-9)
    assert s["kernels"] == {"a": pytest.approx(20e-9),
                            "b": pytest.approx(10e-9)}
    assert s["launches"] == 7


def test_busy_is_clipped_to_the_window():
    s = rl.device_summary([("a", -10, 10), ("b", 35, 50)], 0, 0, 40)
    assert s["busy_s"] == pytest.approx(15e-9)


def test_idle_gaps_longest_first():
    assert rl.idle_gaps([(0, 10), (5, 15), (20, 30)], 0, 40) == [
        (30, 40), (15, 20)]
    assert rl.idle_gaps([], 0, 5) == [(0, 5)]


def test_dp_bytes_count_what_the_lengths_need():
    # Two tiles of T = 4, lengths (4, 4) and (2, 3), one direction byte a
    # cell, 24 fixed bytes a tile: bases 4+4+2+3, cells 16+6.
    assert rl.dp_bytes([4, 2], [4, 3], 4, 1.0, 48) == 13 + 22 + 48
    # An empty slot costs only its fixed bytes.
    assert rl.dp_bytes([0], [0], 4, 1.0, 24) == 24
