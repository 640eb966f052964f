"""`python -m stylegan_v_tpu_torch.generate --frame-shards 2` over two gloo
ranks on the CPU (parallel/sharded_eval.py).

  * Under torchrun (the ranks run this file as a script, `--worker`, and
    import no jax) the two ranks' frames equal the one-process
    sharded_generate_frames on the same draws within 1e-5 of scale (float32;
    each rank synthesises its frames alone, so only the batch differs), and
    the JAX package's sharded_generate_frames on the 8-device CPU mesh within
    FP32_TOL of scale.
  * Spawned by the CLI itself (no torchrun), rank 0 writes the frame folders
    that the torchrun run's frames give, byte for byte, and prints the
    gather's time.
  * A grid that does not divide the videos or frames raises.
"""
import os
import subprocess
import sys

import numpy as np
import torch

WORKER = __name__ == "__main__"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if WORKER:
    sys.path.insert(0, REPO)

from stylegan_v_tpu_torch import generate as tgen  # noqa: E402

if WORKER:
    videos = tgen.main(sys.argv[3:])
    if os.environ["RANK"] == "0":
        np.save(sys.argv[2], videos)
    sys.exit(0)


# ============================================================ the test process

import pytest  # noqa: E402

from stylegan_v_tpu.io.legacy import (convert_generator_state, flatten_module_state,  # noqa: E402
                                      infer_generator_config, load_network_pkl)
from stylegan_v_tpu.models import Generator as JGenerator  # noqa: E402
from stylegan_v_tpu.parallel import create_mesh, sharded_generate_frames  # noqa: E402
from stylegan_v_tpu_torch.models import Discriminator, Generator  # noqa: E402
from stylegan_v_tpu_torch.parallel import sharded_eval as tse  # noqa: E402
from stylegan_v_tpu_torch.parallel.distributed import World, free_port  # noqa: E402
from stylegan_v_tpu_torch.tools.ref_pickle import write_reference_pickle  # noqa: E402

from test_torch_models import FP32_TOL, assert_close, port_cfg, small_disc_cfg, small_gen_cfg  # noqa: E402,E501
from test_torch_train import one_torch_thread  # noqa: E402

__all__ = ["one_torch_thread"]        # the fixture, from test_torch_train.py

PORT_TOL = 1e-5          # two ranks against one process: float32, other batch sizes
ARGV = ["--num-videos", "4", "--video-len", "8", "--frame-shards", "2", "--device", "cpu",
        "--save-as-frames", "--noise-mode", "const"]
TIMEOUT_S = 300


def run(cmd, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(cmd, env=env, cwd=str(tmp_path), capture_output=True, text=True,
                          timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return proc


@pytest.fixture(scope="module")
def pkl(tmp_path_factory):
    gen = torch.Generator().manual_seed(31)
    G = Generator(port_cfg(small_gen_cfg(use_noise=True)), generator=gen)
    with torch.no_grad():
        for name, p in G.named_parameters():
            if name.endswith("noise_strength"):
                p.fill_(0.5)
    D = Discriminator(port_cfg(small_disc_cfg()), generator=gen)
    path = tmp_path_factory.mktemp("shards") / "network-snapshot-000000.pkl"
    return write_reference_pickle(str(path), G=G, D=D, G_ema=G)


@pytest.fixture(scope="module")
def torchrun_frames(pkl, tmp_path_factory):
    """The CLI's frames from two gloo ranks under torchrun, and their output dir."""
    tmp = tmp_path_factory.mktemp("torchrun")
    out = str(tmp / "videos.npy")
    run([sys.executable, "-m", "torch.distributed.run", "--nnodes=1", "--nproc_per_node=2",
         "--master_addr=localhost", f"--master_port={free_port()}", os.path.abspath(__file__),
         "--worker", out, "--network", pkl, "-o", str(tmp / "out")] + ARGV, tmp)
    return np.load(out), tmp / "out"


def test_two_ranks_equal_one_process_and_the_jax_mesh(pkl, torchrun_frames):
    got, _ = torchrun_frames
    args = tgen.parse_args(["--network", pkl, "-o", "unused"] + ARGV)
    G = tgen.load_any_checkpoint(pkl, torch.device("cpu"))
    z, c, ts, mz = tgen.draw_inputs(args, G.cfg)
    one = tse.sharded_generate_frames(G, z, c, ts, mz, frame_shards=1, noise_mode="const",
                                      truncation_psi=args.truncation_psi)
    want = np.clip(one.numpy() * 0.5 + 0.5, 0.0, 1.0)
    assert got.shape == want.shape == (4, 8, 32, 32, 3) and got.std() > 0
    assert_close(torch.from_numpy(got), want, PORT_TOL)

    # the JAX package's frame-sharded synthesis on a (4 data x 2 frame) mesh
    stub = load_network_pkl(pkl)["G_ema"]
    JG = JGenerator(infer_generator_config(stub))
    frames = sharded_generate_frames(JG, convert_generator_state(flatten_module_state(stub)),
                                     z, c, ts, mz, create_mesh(frame=2), noise_mode="const",
                                     truncation_psi=args.truncation_psi)
    assert_close(torch.from_numpy(got), np.clip(np.asarray(frames) * 0.5 + 0.5, 0.0, 1.0),
                 FP32_TOL)


def test_the_cli_spawns_the_ranks(pkl, torchrun_frames, tmp_path):
    got, torchrun_out = torchrun_frames
    proc = run([sys.executable, "-m", "stylegan_v_tpu_torch.generate", "--network", pkl,
                "-o", str(tmp_path / "out")] + ARGV, tmp_path)
    assert "Gathered 4 x 8 frames from 2 ranks in " in proc.stdout
    for i in range(4):
        names = sorted(os.listdir(tmp_path / "out" / f"video{i:04d}"))
        assert names == [f"{t:06d}.jpg" for t in range(8)]
        for name in names:
            a = (tmp_path / "out" / f"video{i:04d}" / name).read_bytes()
            assert a == (torchrun_out / f"video{i:04d}" / name).read_bytes()


@pytest.mark.parametrize("size,shards,V,T", [(2, 3, 4, 6), (4, 2, 3, 8), (2, 2, 4, 7)])
def test_a_grid_that_does_not_divide_raises(size, shards, V, T):
    with pytest.raises(ValueError, match="divide"):
        tse.frame_grid(V, T, shards, World(rank=0, size=size))
    assert tse.frame_grid(4, 8, 2, World(rank=3, size=4)) == (2, 2, 4, 1, 1)
