"""Shared pieces of the benchmark's own tests: the tiny cells of
tests/tiny/BENCHMARK.json, run on the CPU through the harness."""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_SPEC = os.path.join(HERE, "tiny", "BENCHMARK.json")


def cpu_run(workload, seed=123, seconds=0.5, trace=False, program=None):
    import torch
    from benchmark import run
    return run.run(workload, seed, seconds, trace, device=torch.device("cpu"),
                   spec_path=TINY_SPEC, program=program)


def tiny_plain(config_name):
    from benchmark.lib import spec
    cell = {"sgv_tiny": "sgv_tiny.train", "mocogan_tiny": "mocogan_tiny.train"}[config_name]
    c = spec.load_cell(cell, TINY_SPEC)
    setup = spec.compose_setup(c["config"])
    return c, setup, spec.plain_setup(setup)


def tiny_mix(workload):
    """The mix module that drives a tiny cell."""
    from benchmark.lib import spec
    return spec.load_mix(spec.load_cell(workload, TINY_SPEC)["traffic"]["kind"])
