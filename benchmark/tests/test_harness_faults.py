"""A whole run, the card's look aside, with the timed path broken
underneath, must come out not correct; the sound program, correct. On the
CPU at the tiny cells' sizes (the program and the reference agree to the
bit there, so the tiny limits are near 0). The faults: a step that returns
its state unchanged (from step 0, and from the first step after set-up,
which only the window's check sees), half of the batch left out with the
means over the rest, and frames altered where they are produced."""
import pytest

from helpers import cpu_run, tiny_mix


@pytest.mark.parametrize("workload", ["sgv_tiny.train", "mocogan_tiny.train",
                                      "sgv_tiny.synth16f"])
def test_the_sound_program_is_correct(workload):
    r = cpu_run(workload)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("workload,fault", [("sgv_tiny.train", "unchanged"),
                                            ("sgv_tiny.train", "half_batch"),
                                            ("mocogan_tiny.train", "unchanged"),
                                            ("mocogan_tiny.train", "half_batch"),
                                            ("sgv_tiny.synth16f", "altered")])
def test_a_broken_timed_path_is_not_correct(workload, fault):
    r = cpu_run(workload, program=tiny_mix(workload).FAULTS[fault])
    assert not r["correct"], r["checks"]


def test_a_late_fault_fails_only_the_window_check():
    from benchmark.lib.train_cell import FAULTS
    r = cpu_run("sgv_tiny.train", program=FAULTS["late_unchanged"])
    failed = {k for k, c in r["checks"].items() if not c["value"] <= c["limit"]}
    assert failed and all(k.startswith("w_") for k in failed), r["checks"]
