"""The verdict: every held number read and at or under its limit, and
no failed answer.  A held number the run could not read fails `correct`
unless the cell's limits file lists it under "not_captured"."""

import pytest

from benchmark.harness import judge

SPEC = {"limits": {"gr_gap": 0.01, "pcm_gap": 0.1}}
READ = {"gr_gap": 0.005, "pcm_gap": 0.05}


@pytest.mark.parametrize("nums, spec, failed, ok", [
    (READ, SPEC, 0, True),
    (READ, SPEC, 1, False),
    (dict(READ, pcm_gap=0.2), SPEC, 0, False),
    ({"pcm_gap": 0.05}, SPEC, 0, False),
    ({"gr_gap": 0.005}, SPEC, 0, False),
    ({"pcm_gap": 0.05}, dict(SPEC, not_captured=["gr_gap"]), 0, True),
    ({"pcm_gap": 0.5}, dict(SPEC, not_captured=["gr_gap"]), 0, False),
], ids=["sound", "failed", "over", "gr_not_read", "pcm_not_read",
        "gr_excused", "excused_but_over"])
def test_verdict(nums, spec, failed, ok):
    got, compared = judge.verdict(nums, spec, failed)
    assert got is ok
    assert set(compared) == {"gr_gap", "pcm_gap", "failed"}
    assert compared["gr_gap"]["value"] == nums.get("gr_gap")


def test_a_program_whose_layers_are_not_captured_is_not_correct():
    """numbers() leaves the intermediate numbers out when the loop did
    not capture them; the cells' limits hold them, so that fails."""
    import torch
    n, t = 2, 3
    ref = {"period": torch.full((n, t), 100), "features": torch.ones(n, t, 70),
           "ep": torch.ones(n, t, 34), "g": torch.zeros(n, t, 34),
           "r": torch.zeros(n, t, 34), "pcm": torch.ones(n, t, 480)}
    valid = torch.ones(n, t, dtype=torch.bool)
    nums = judge.numbers({"pcm": ref["pcm"].clone()}, ref, valid)
    assert "gr_gap" not in nums and nums["pcm_gap"] == 0.0
    spec = judge.load_limits(judge.pathlib.Path(__file__).parents[1],
                             "f32-batch")
    assert judge.verdict(nums, spec, 0)[0] is False
    full = judge.numbers({k: v.clone() for k, v in ref.items()}, ref, valid)
    assert judge.verdict(full, spec, 0)[0] is True
