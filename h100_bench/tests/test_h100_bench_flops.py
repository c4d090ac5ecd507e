"""The benchmark's own work counts against hand counts and against the
bounds the kernels have been measured by (PERF.md, the TPU kernels'
table: a tower pass's grouped sites at mini-batch 100)."""

import json

import pytest

import bench_toy
from bench_toy import BENCH
from h100_bench import flops
from h100_bench.reference import nf


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_gconv_call_by_hand():
    # 2 images of 4x4, 16 channels in 2 groups of 8
    f, b = flops.gconv_call(2, 4, 16, 2, "bfloat16")
    assert f == 2 * 2 * 4 * 4 * 16 * 9 * 8
    assert b == (2 * 2 * 4 * 4 * 16 + 9 * 8 * 16) * 2
    assert flops.bound_s(f, b, "bfloat16") == max(f / 989e12, b / 3.35e12)
    f32, b32 = flops.gconv_call(2, 4, 16, 2, "float32")
    assert (f32, b32) == (f, 2 * b)
    assert flops.bound_s(f32, b32, "float32") == max(3 * f / 495e12, 2 * b / 3.35e12)


@pytest.mark.parametrize("name,dtype,ms", [
    ("nfnet_l0", "bfloat16", 0.148), ("nfnet_l0", "float32", 0.854),
    ("nf_regnet_b1", "bfloat16", 0.1613), ("nf_regnet_b1", "float32", 0.3226)])
def test_tower_pass_bounds_are_the_kernels_yardstick(name, dtype, ms):
    cfg = config(name)
    got = 1e3 * flops.tower_pass_bound_s(cfg["tower"], 224, 100, dtype)
    assert got == pytest.approx(ms, rel=2e-3)


def test_sites():
    assert flops.gconv_sites(config("nfnet_l0")["tower"], 224) == {
        (28, 128, 2): 3, (14, 384, 6): 11, (7, 384, 6): 5}
    assert flops.gconv_sites(config("nf_regnet_b1")["tower"], 224) == {
        (56, 88, 11): 1, (28, 184, 23): 3, (14, 360, 45): 6, (7, 736, 92): 6}


def test_image_flops_by_hand():
    # a one-block 3x3-stem tower, no SE, no head: every conv by hand
    t = {**bench_toy.TOY_TOWER, "depths": [1], "channels": [16], "stem_type": "3x3",
         "stem_chs": 8, "group_size": 0, "bottle_ratio": 1.0, "extra_conv": False,
         "num_features": 0, "attn_rd_ratio": 0.0, "skipinit": False}
    # stem 3->8 3x3/2 at 8x8 out; block: stride 2 -> 4x4; downsample 1x1
    # 8->16 at 4x4, conv1 1x1 8->16 at 8x8, conv2 3x3/2 16->16 at 4x4,
    # conv3 1x1 16->16 at 4x4
    want = 2 * (64 * 8 * 3 * 9 + 16 * 16 * 8 + 64 * 16 * 8 + 16 * 16 * 16 * 9
                + 16 * 16 * 16)
    assert flops.image_flops(t, 16) == want


def test_step_rules():
    cfg = config("nfnet_l0")
    f100 = flops.pass_flops(cfg, 100)
    d = nf.feature_width(cfg["tower"])
    assert f100 == 100 * (flops.image_flops(cfg["tower"], 224)
                          + 2 * (768 * d + d * d)) + 2 * 100 * 100 * d
    assert flops.distill_step_flops(cfg) == 8 * 9 * f100
    assert flops.expert_step_flops(cfg) == 3 * flops.pass_flops(cfg, 128)
    # timm: ~4.4 GMACs an NFNet-L0 image at 224^2
    assert 8.0e9 < flops.image_flops(cfg["tower"], 224) < 9.5e9
    # the distill step runs in float32: PERF's TF32 x3 pass bound
    assert flops.gconv_step_bound_s(cfg, "distill") == pytest.approx(
        8 * 12 * 0.854e-3, rel=2e-3)
