"""Re-validate the port's detector modules against RECORDED reference features.

`python -m stylegan_v_tpu_torch.validate_detectors` writes
detector_fixtures.json after running the real TorchScript files (the same
schema as scripts/validate_detectors.py, the TorchScript's own features, so
one file serves both packages). When that file AND the detector files are
present, the standing test here loads each file into the port's module
through the metrics' own loader and asserts that it still reproduces the
recorded TorchScript features on the fixture inputs, on the CPU. Skipped
otherwise. `check_recorded` is the same check, which
tests/test_torch_detector_gate.py runs on a fixtures file that the
validator wrote from stand-in files.
"""
import json
import os

import numpy as np
import pytest

from stylegan_v_tpu_torch import validate_detectors as tvd
from stylegan_v_tpu_torch.metrics.metric_utils import DETECTOR_FILES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.environ.get("SGV_DETECTOR_FIXTURES",
                          os.path.join(REPO, "detector_fixtures.json"))
DETECTOR_DIR = os.environ.get("SGV_DETECTOR_DIR",
                              os.path.join(os.getcwd(), "detectors"))
SAMPLE_TOL = 2e-3      # scripts' fixtures test: of the recorded mean absolute feature


def check_recorded(fixtures_path: str, detector_dir: str, device="cpu"):
    """For every detector in the fixtures file whose file is in `detector_dir`:
    the port's features on each fixture input against the recorded sample,
    max_rel within SAMPLE_TOL of the recorded mean absolute feature. Returns
    the (name, label, max_rel) checked."""
    with open(fixtures_path) as f:
        fixtures = json.load(f)
    checked = []
    for name, rec in fixtures.items():
        path = os.path.join(detector_dir, DETECTOR_FILES.get(name, name))
        if not os.path.isfile(path):
            continue
        fns = tvd.port_case_fns(name, path, device)
        for label, inp in tvd.fixture_inputs(name):
            case = rec["cases"][label]
            got = np.asarray(fns[label](inp), np.float64)
            want_sample = np.asarray(case["want_sample"], np.float64)
            scale = case["want_mean_abs"] + 1e-8
            max_rel = np.abs(got.ravel()[:len(want_sample)] - want_sample).max() / scale
            assert max_rel <= SAMPLE_TOL, (name, label, max_rel)
            checked.append((name, label, float(max_rel)))
    return checked


@pytest.mark.skipif(not os.path.isfile(FIXTURES),
                    reason="no detector_fixtures.json recorded yet "
                           "(run python -m stylegan_v_tpu_torch.validate_detectors)")
def test_port_detectors_match_recorded_reference_features():
    if not check_recorded(FIXTURES, DETECTOR_DIR):
        pytest.skip("fixtures recorded but no detector files present")
