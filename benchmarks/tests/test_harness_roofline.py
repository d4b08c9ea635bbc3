"""The yardstick reproduces the hand numbers of the port's kernel table."""

from __future__ import annotations

import pytest

from benchmarks import roofline as r


def test_hand_numbers():
    assert r.conv_macs(180, 240) == pytest.approx(13.098e9, rel=1e-4)
    assert r.forward_flops(180, 240, 64) == pytest.approx(26.2e9, rel=2e-3)
    assert r.k2_bound_s(64, 66_048, 32_768, 5) * 1e3 == pytest.approx(2.587, abs=5e-4)
    assert r.k3_bound_s(50, 32_768) * 1e3 == pytest.approx(0.00196, abs=5e-6)
    assert r.k1_forward_bound_s(50, 165, 64, 512) * 1e3 == pytest.approx(0.0081, abs=5e-5)
    assert r.k1_backward_bound_s(50, 165, 64, 512) * 1e3 == pytest.approx(0.0161, abs=5e-5)
    # one search of the 250k index: its 32.8 GB at HBM's rate
    assert r.k2_bound_s(1, 250_000, 32_768, 5) == pytest.approx(250_000 * 32_768 * 4 / 3.35e12,
                                                                rel=1e-4)
    assert [hw for hw in r.conv_maps(180, 240)] == [(180, 240), (90, 120), (45, 60), (22, 30),
                                                   (11, 15)]
