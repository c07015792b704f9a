"""A configuration is refused unless the harness runs exactly what it
states: a file with other widths, another framing, a precision tier the
program does not have, another wire, table activations or other feature
scaling fails when it is loaded, instead of running the fixed network."""

import copy
import json

import pytest

from benchmark.harness import program
from benchmark.tests import bench_tiny


def _load(name: str) -> dict:
    return json.loads((bench_tiny.BENCH / "configs" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("name", ["percepnet-f32", "percepnet-bf16-log1p"])
def test_the_benchmark_configurations_pass(name):
    program.check_config(_load(name))


CHANGES = {
    "gru1_hidden": lambda c: c["architecture"].__setitem__("gru1",
                                                           [512, 256]),
    "conv1_kernel": lambda c: c["architecture"]["conv1"].__setitem__(
        "kernel", 3),
    "fc_rb_bands": lambda c: c["architecture"].__setitem__("fc_rb",
                                                           [128, 22]),
    "weights": lambda c: c["architecture"].__setitem__("weights", 7962564),
    "frame": lambda c: c["architecture"].__setitem__("frame_samples", 256),
    "mixed_tier": lambda c: c["precision"].__setitem__("dft", "bfloat16"),
    "wire": lambda c: c.__setitem__("wire", "int8"),
    "tables": lambda c: c.__setitem__("activations", "tansig tables"),
    "scaled": lambda c: c["features"].__setitem__("raw_scale", False),
}


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_a_configuration_the_harness_cannot_honour_is_refused(change):
    cfg = copy.deepcopy(_load("percepnet-f32"))
    CHANGES[change](cfg)
    with pytest.raises(ValueError, match="does not run"):
        program.check_config(cfg)
