"""The control on the card: the reference in the program's place with TF32
allowed in its float32 convolutions and matmuls (the precision just below
the configuration's: float32 with TF32 off) must fail the cell's limits,
and the program must pass them, at the cell's own size, on one seed a cell
(benchmark/calibrate.py reads more). Needs an NVIDIA GPU; skips elsewhere.

    python -m pytest --noconftest -m cuda benchmark/tests/test_harness_control.py
"""
import pytest

from helpers import ROOT  # noqa: F401  (puts the repository on sys.path)

CELLS = ["sgv_ffs256.train", "mocogan_ffs256.train", "sgv_ffs256.synth16f"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_passes(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from benchmark.calibrate import readings
    from benchmark.lib import spec
    from benchmark.lib.checks import judge
    limits = spec.load_cell(workload)["limits"]
    row = readings(workload, [2718281828], 0, log=lambda s: None)[0]
    assert judge(row["program"], limits)[0], row["program"]
    assert not judge(row["control"], limits)[0], row["control"]
