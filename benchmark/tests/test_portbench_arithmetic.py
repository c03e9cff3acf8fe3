"""The benchmark's FLOP counter against hand counts, and the copied
roofline arithmetic against the bounds PERF.md's kernel table gives."""
import json
import os

import pytest

import flops
import roofline
from conftest import BENCH
from reference.config import Cfg
from reference.sinkhorn import epsilon_schedule


def conv(B, C, O, H, k, stride=1):
    Ho = (H + 2 * (k // 2) - k) // stride + 1
    return 2 * B * O * Ho * Ho * C * k * k


def test_one_conv():
    assert flops.conv_flops(2, 3, 8, 256, 256, 3, 3) == 2 * 2 * 8 * 256 * 256 * 3 * 9
    assert conv(2, 3, 8, 256, 3) == flops.conv_flops(2, 3, 8, 256, 256, 3, 3)


def test_darknet_tiny_h_forward_at_256():
    raw = json.load(open(os.path.join(BENCH, "configs", "kd_tiny_h_from_darknet53.json")))
    m = Cfg(raw).model
    backbone = (conv(1, 3, 8, 256, 3) + conv(1, 8, 16, 128, 3)
                + conv(1, 16, 8, 64, 1) + conv(1, 8, 64, 64, 3)
                + conv(1, 64, 8, 64, 1) + conv(1, 8, 64, 64, 3)
                + conv(1, 64, 16, 32, 1) + conv(1, 16, 128, 32, 3)
                + conv(1, 128, 16, 32, 1) + conv(1, 16, 128, 32, 3)
                + conv(1, 128, 32, 16, 1) + conv(1, 32, 256, 16, 3)
                + conv(1, 256, 32, 16, 1) + conv(1, 32, 256, 16, 3)
                + conv(1, 256, 64, 16, 1))
    fpn = (conv(1, 64, 128, 32, 1) + conv(1, 64, 128, 16, 1)
           + conv(1, 128, 128, 32, 3) + conv(1, 128, 128, 16, 3)
           + conv(1, 64, 128, 16, 3, 2) + conv(1, 128, 128, 8, 3, 2))
    head = sum(8 * conv(1, 128, 128, s, 3) + conv(1, 128, 15, s, 3) + conv(1, 128, 240, s, 3)
               for s in (32, 16, 8, 4))
    assert flops.forward_flops(m, 15, 1) == backbone + fpn + head
    assert flops.forward_flops(m, 15, 16) == 16 * (backbone + fpn + head)


def test_k1_bound_is_perf_md_s():
    # N = 128 problems (B = 16 x 8 keypoints), P = T = 64, 12 eps: 0.00611 ms
    n_eps = len(epsilon_schedule(2.0, 2.0, 0.001, 0.5))
    assert n_eps == 12
    assert roofline.k1_bound(128, 64, 64, n_eps) * 1e3 == pytest.approx(0.00611, abs=5e-6)


def test_k2_bounds_are_perf_md_s():
    # the eval stem 3 -> 8 at 256² and s2 8 -> 16 at 128², B = 8, fp32
    assert roofline.k2_bound(8, 3, 8, 256, 256) * 1e3 == pytest.approx(0.00696, abs=5e-6)
    assert roofline.k2_bound(8, 8, 16, 128, 128) * 1e3 == pytest.approx(0.00384, abs=5e-6)
