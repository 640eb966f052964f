"""The port's detector gate, `python -m stylegan_v_tpu_torch.validate_detectors`,
on the CPU.

  * Its copies of fixture_inputs, CASE_TORCH_KWARGS and _md5 equal
    scripts/validate_detectors.py's (loaded by path, as
    tests/test_detector_fixtures.py loads it).
  * On stand-in TorchScript files for the three canonical names
    (stylegan_v_tpu_torch/tools/standin_detectors.py: the port's modules
    with seeded weights, traced, behind a scripted forward that takes raw
    uint8 and the reference kwargs), with fixture_inputs patched to small
    cases, the validator passes (exit 0) and writes a fixtures file in the
    JAX script's schema, which test_torch_detector_fixtures.check_recorded
    reads back against the port's modules.
  * A stand-in whose state_dict names one conv's weight wrongly (the I3D's
    Mixed_4d b0 and b1a exchanged in its forward) fails the gate: exit 2.
  * No detector file: exit 1.
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from stylegan_v_tpu_torch import validate_detectors as tvd
from stylegan_v_tpu_torch.metrics.metric_utils import DETECTOR_FILES
from stylegan_v_tpu_torch.tools import standin_detectors
from test_torch_detector_fixtures import check_recorded
from test_torch_train import one_torch_thread

__all__ = ["one_torch_thread"]        # the fixture, from test_torch_train.py

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASE_KEYS = {"torch_features_md5", "want_sample", "want_mean_abs", "max_rel", "mean_rel", "ok"}


def jax_validator():
    spec = importlib.util.spec_from_file_location(
        "validate_detectors", os.path.join(REPO, "scripts", "validate_detectors.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def small_cases():
    """Cheap cases of each detector's path: the I3D at 32^2 without its resize
    (two cases), the C3D from 64^2 through its 112^2 resize, the Inception
    from 64^2 and 48^2 through its 299^2 resize (features, then probabilities)."""
    rng = np.random.RandomState(22)

    def u8(*shape):
        return rng.randint(0, 255, shape).astype(np.uint8)
    inputs = {"i3d": [("32^2 a", u8(1, 16, 32, 32, 3)), ("32^2 b", u8(1, 16, 32, 32, 3))],
              "c3d_ucf101": [("64^2", u8(1, 16, 64, 64, 3))],
              "inception": [("64^2 feats", u8(1, 64, 64, 3)), ("48^2 probs", u8(1, 48, 48, 3))]}
    kwargs = {"i3d": [dict(rescale=True, resize=False, return_features=True)] * 2,
              "c3d_ucf101": [{}],
              "inception": [dict(return_features=True), dict(no_output_bias=True)]}
    return inputs, kwargs


@pytest.fixture(scope="module")
def small(one_torch_thread):
    """fixture_inputs and CASE_TORCH_KWARGS patched to small_cases() for the
    module, and the TorchScript executor without its optimisation passes
    (the same ops; their compile takes seconds at each first call)."""
    inputs, kwargs = small_cases()
    with pytest.MonkeyPatch.context() as mp, torch.jit.optimized_execution(False):
        mp.setattr(tvd, "fixture_inputs", lambda name: inputs[name])
        mp.setattr(tvd, "CASE_TORCH_KWARGS", kwargs)
        yield inputs, kwargs


def write_standins(directory, inputs, kwargs, miswired=()):
    os.makedirs(directory, exist_ok=True)
    for name in standin_detectors.NAMES:
        standin_detectors.write_standin(name, os.path.join(directory, DETECTOR_FILES[name]),
                                        inputs[name][0][1], kwargs[name][0], seed=3,
                                        miswired=name in miswired)
    return str(directory)


@pytest.fixture(scope="module")
def standin_run(small, tmp_path_factory):
    root = tmp_path_factory.mktemp("gate")
    directory = write_standins(root / "detectors", *small)
    out = str(root / "detector_fixtures.json")
    rc = tvd.main(["--detector-dir", directory, "--out", out, "--device", "cpu"])
    return rc, directory, out


@pytest.mark.parametrize("name", ["i3d", "c3d_ucf101", "inception"])
def test_copies_equal_the_jax_script(name):
    jv = jax_validator()
    got, want = tvd.fixture_inputs(name), jv.fixture_inputs(name)
    assert [label for label, _ in got] == [label for label, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    assert tvd.CASE_TORCH_KWARGS[name] == jv.CASE_TORCH_KWARGS[name]
    a = np.random.RandomState(1).randn(3, 5)
    assert tvd._md5(a) == jv._md5(a) and tvd._md5(a.astype(np.float32)) == jv._md5(a)


def test_validator_passes_on_standins_and_writes_the_schema(standin_run, capsys):
    rc, _, out = standin_run
    assert rc == 0
    with open(out) as f:
        fixtures = json.load(f)
    inputs, _ = small_cases()
    assert set(fixtures) == set(standin_detectors.NAMES)
    for name, rec in fixtures.items():
        assert set(rec) == {"file", "input_seed", "cases", "ok"} and rec["ok"] is True
        assert rec["file"] == DETECTOR_FILES[name] and rec["input_seed"] == 0
        assert list(rec["cases"]) == [label for label, _ in inputs[name]]
        for case in rec["cases"].values():
            assert set(case) == CASE_KEYS and case["ok"] is True
            assert case["max_rel"] <= tvd.MAX_REL and case["mean_rel"] <= tvd.MEAN_REL
            assert len(case["want_sample"]) == 16 and case["want_mean_abs"] > 0
            assert len(case["torch_features_md5"]) == 32


def test_the_fixtures_file_reads_back_against_the_port(standin_run):
    _, directory, out = standin_run
    checked = check_recorded(out, directory, "cpu")
    assert sorted((n, label) for n, label, _ in checked) == sorted(
        (n, label) for n, cases in small_cases()[0].items() for label, _ in cases)


def test_a_miswired_standin_fails_the_gate(small, tmp_path):
    inputs, kwargs = small
    directory = str(tmp_path / "detectors")
    os.makedirs(directory)
    standin_detectors.write_standin("i3d", os.path.join(directory, DETECTOR_FILES["i3d"]),
                                    inputs["i3d"][0][1], kwargs["i3d"][0], seed=3,
                                    miswired=True)
    out = str(tmp_path / "fixtures.json")
    assert tvd.main(["--detector-dir", directory, "--out", out, "--device", "cpu"]) == 2
    with open(out) as f:
        rec = json.load(f)
    assert set(rec) == {"i3d"} and rec["i3d"]["ok"] is False
    assert all(c["max_rel"] > tvd.MAX_REL for c in rec["i3d"]["cases"].values())


def test_no_detector_file_exits_1(tmp_path, capsys):
    out = str(tmp_path / "fixtures.json")
    assert tvd.main(["--detector-dir", str(tmp_path), "--out", out, "--device", "cpu"]) == 1
    assert not os.path.exists(out)
    assert "No detector files found; nothing validated." in capsys.readouterr().out


def test_the_mean_cube_rule_follows_the_loader():
    cube = torch.zeros(3, 16, 112, 112)
    assert tvd.has_mean_cube({"mean": cube, "conv1a.weight": torch.zeros(64, 3, 3, 3, 3)})
    assert tvd.has_mean_cube({"model.data_mean": cube[None]})
    assert not tvd.has_mean_cube({"conv1a.weight": torch.zeros(64, 3, 3, 3, 3),
                                  "fc8.bias": torch.zeros(101)})
