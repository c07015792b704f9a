"""The yardstick's counts against counts made by hand at a small shape."""

import pytest

from benchmark.harness import flops
from benchmark.reference import percepnet_ref as R


def test_weight_count_is_the_published_networks():
    hand = (70 * 128 + 5 * 128 * 512 + 3 * 512 * 512
            + 4 * (512 * 1536 + 512 * 1536) + 1024 * 384 + 128 * 384
            + 2560 * 34 + 128 * 34)
    assert flops.weight_count() == hand == 7_948_288


def test_call_flops_by_hand():
    b, t = 2, 3
    got = flops.call_flops(b, t)
    assert got["model"] == 2 * 7_948_288 * 6
    assert got["analysis"] == 2 * 960 * 962 * 2 * (3 + 5)
    assert got["comb_dft"] == 2 * 960 * 962 * 6
    assert got["inverse"] == 2 * 962 * 960 * 6
    assert got["pitch"] == 2 * (385 * 480 + 147 * 240) * 6


def test_ideal_seconds_take_each_parts_peak():
    f32 = {"dft": "float32", "model": "float32", "pitch": "float32"}
    bf16 = {"dft": "bfloat16", "model": "bfloat16", "pitch": "float32"}
    c = flops.call_flops(512, 200)
    assert flops.ideal_seconds(512, 200, f32) == pytest.approx(
        sum(c.values()) / 67e12)
    assert flops.ideal_seconds(512, 200, bf16) == pytest.approx(
        (c["model"] + c["analysis"] + c["comb_dft"] + c["inverse"]) / 989e12
        + c["pitch"] / 67e12)


def test_comb_bytes_by_hand():
    # padded span f32 read once, periods int32 once, windows written once
    assert flops.comb_bytes(2, 3, "float32") == \
        4 * 2 * (3 * 480 + 5280) + 4 * 6 + 4 * 6 * 960
    assert flops.comb_bytes(2, 3, "bfloat16") == \
        4 * 2 * (3 * 480 + 5280) + 4 * 6 + 2 * 6 * 960
    # 512 x 200: the kernel's documented bounds, 0.179 / 0.121 ms
    assert flops.comb_bytes(512, 200, "float32") / 3.35e12 * 1e3 == \
        pytest.approx(0.1794, abs=5e-4)
    assert flops.comb_bytes(512, 200, "bfloat16") / 3.35e12 * 1e3 == \
        pytest.approx(0.1207, abs=5e-4)


def test_layers_match_the_configuration_files():
    import json
    for name in ("percepnet-f32", "percepnet-bf16-log1p"):
        with open(flops.__file__.replace("harness/flops.py",
                                         f"configs/{name}.json")) as f:
            cfg = json.load(f)
        assert cfg["architecture"]["weights"] == flops.weight_count()
    assert len(R.LAYERS) == 30
