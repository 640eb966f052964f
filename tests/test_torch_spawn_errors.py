"""parallel.distributed.launch when rank 1 raises while rank 0 waits in a
collective with it: rank 0's collective then fails too, and when the parent
looks only after both ranks have ended, torch's spawn reports rank 0's
failure, not the cause. The launch's error names every rank that raised, so
rank 1's exception is in it however late the parent looks.

Each case runs this file as a script in a process of its own (spawned ranks
import their function from the main module), on the CPU with gloo. In
`late` mode the parent waits for every rank to end before it joins them.
"""
import os
import subprocess
import sys
import time

import pytest
import torch

WORKER = __name__ in ("__main__", "__mp_main__")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if WORKER:
    sys.path.insert(0, REPO)

from stylegan_v_tpu_torch.parallel import distributed as tdist  # noqa: E402

TIMEOUT_S = 120


def _raise_on_rank_1(rank, world_size, init_method):
    world = tdist.init_distributed("gloo", rank, world_size, init_method,
                                   torch.device("cpu"), timeout_s=TIMEOUT_S)
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    tdist.all_reduce_mean_([torch.ones(3)], world)       # rank 0 waits here


def _join_after_every_rank_ended():
    """Make the parent's wait on the ranks return only once all of them have
    ended, as a parent that is slow to look sees them."""
    import multiprocessing.connection as connection
    wait = connection.wait

    def late(objects, timeout=None):
        while len(wait(objects, 0.05)) < len(objects):
            pass
        return wait(objects, timeout)
    connection.wait = late


def worker(mode):
    if mode == "late":
        _join_after_every_rank_ended()
    try:
        tdist.launch(_raise_on_rank_1, 2)
    except Exception as e:
        print(f"LAUNCH RAISED: {e}", flush=True)
        return 3
    return 0


@pytest.mark.parametrize("mode", ["prompt", "late"])
def test_a_launch_names_the_rank_that_raised(mode):
    t0 = time.time()
    p = subprocess.run([sys.executable, os.path.abspath(__file__), mode], cwd=REPO,
                       capture_output=True, text=True, timeout=TIMEOUT_S)
    log = p.stdout + p.stderr
    assert p.returncode == 3, log[-3000:]
    assert "LAUNCH RAISED" in log and "RuntimeError: rank 1 fails" in log, log[-3000:]
    assert time.time() - t0 < TIMEOUT_S
    if mode == "late":       # both ranks raised, and the error names both
        assert "-- rank 0 raised:" in log and "-- rank 1 raised:" in log, log[-3000:]


if WORKER and __name__ == "__main__":
    sys.exit(worker(sys.argv[1]))
