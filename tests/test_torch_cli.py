"""The port's CLIs (`python -m stylegan_v_tpu_torch.{generate,calc_metrics,
calc_metrics_for_dataset}`) against the JAX package's scripts on the CPU.

  * generate --device cpu on a reference .pkl written from seeded weights
    writes the frames scripts/generate.py writes from the same .pkl: per-video
    frame folders, the --moco-decomposition grid and the --as-grids grid, as
    the uint8 arrays each CLI hands its writer, equal to within one level (the
    two float32 syntheses round alike but at a quantisation edge). Without
    --moco-decomposition generate_videos draws the motion trajectories, so
    the port replays the JAX draw there (`replaying_motion`), as the metric
    tests replay theirs.
  * The pick by metric, the refusal of a non-square --moco-decomposition,
    and a port snapshot (.pt) next to the .pkl (tests/test_generate_cli.py).
  * calc_metrics and calc_metrics_for_dataset with SGV_STUB_DETECTORS=1 and
    tests/test_calc_metrics_cli.py's tiny metrics write the JAX CLIs' jsonl
    rows within 1e-4 of scale (the generator side replays JAX's draws).
"""
import json
import os
import sys

import numpy as np
import pytest
import jax
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

from stylegan_v_tpu.metrics import frechet_inception_distance as jfid  # noqa: E402
from stylegan_v_tpu.metrics import frechet_video_distance as jfvd  # noqa: E402
from stylegan_v_tpu.metrics import metric_main as jmm  # noqa: E402
from stylegan_v_tpu.models.motion import MotionMappingNetwork as JMotion  # noqa: E402
from stylegan_v_tpu.training import video_io as jvio  # noqa: E402
from stylegan_v_tpu_torch import calc_metrics as tcm  # noqa: E402
from stylegan_v_tpu_torch import calc_metrics_for_dataset as tcmd  # noqa: E402
from stylegan_v_tpu_torch import generate as tgen  # noqa: E402
from stylegan_v_tpu_torch.io.checkpoint import save_snapshot  # noqa: E402
from stylegan_v_tpu_torch.metrics import frechet_inception_distance as tfid  # noqa: E402
from stylegan_v_tpu_torch.metrics import frechet_video_distance as tfvd  # noqa: E402
from stylegan_v_tpu_torch.metrics import metric_main as tmm  # noqa: E402
from stylegan_v_tpu_torch.models import Discriminator, Generator  # noqa: E402
from stylegan_v_tpu_torch.tools.ref_pickle import write_reference_pickle  # noqa: E402
from stylegan_v_tpu_torch.training import train_step as tts  # noqa: E402
from stylegan_v_tpu_torch.training import video_io as tvio  # noqa: E402

from test_data import build_video_dataset_dir  # noqa: E402
from test_torch_metrics import replaying  # noqa: E402
from test_torch_models import port_cfg, small_disc_cfg, small_gen_cfg  # noqa: E402
from test_torch_train import one_torch_thread  # noqa: E402

__all__ = ["one_torch_thread"]        # the fixture, from test_torch_train.py

CLIP_TOL = 1e-4          # the metrics' rows: float64 moments of one-level-apart frames


@pytest.fixture
def tiny_metrics(monkeypatch):
    """tests/test_calc_metrics_cli.py's tiny metrics, under names of their own,
    in both packages' registries while a test runs."""
    for mm, fvd_lib, fid_lib in ((jmm, jfvd, jfid), (tmm, tfvd, tfid)):
        def fvd_cli_tiny(opts, fvd_lib=fvd_lib):
            return {"fvd_cli_tiny": fvd_lib.compute_fvd(opts, max_real=8, num_gen=8,
                                                        num_frames=4)}

        def fid_cli_tiny(opts, fid_lib=fid_lib):
            return {"fid_cli_tiny": fid_lib.compute_fid(opts, max_real=16, num_gen=16)}

        for fn in (fvd_cli_tiny, fid_cli_tiny):
            monkeypatch.setitem(mm._metric_dict, fn.__name__, fn)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A reference .pkl of seeded G (G_ema: other weights) and D, and a run
    dir with two port snapshots whose G_ema is the pickle's."""
    root = tmp_path_factory.mktemp("cli")
    gcfg, dcfg = port_cfg(small_gen_cfg()), port_cfg(small_disc_cfg())
    gen = torch.Generator().manual_seed(21)
    G, D = Generator(gcfg, generator=gen), Discriminator(dcfg, generator=gen)
    G_ema = Generator(gcfg, generator=gen)
    with torch.no_grad():
        G_ema.mapping.w_avg.normal_(generator=gen)       # truncation moves toward it
    pkl = write_reference_pickle(str(root / "network-snapshot-000000.pkl"), G=G, D=D,
                                 G_ema=G_ema)
    run = root / "run"
    state = tts.init_train_state(G, D, tts.OptimizerConfig(), tts.OptimizerConfig(),
                                 tts.TrainingConfig(batch_size=4))
    state.G_ema.load_state_dict(G_ema.state_dict())
    for nimg in (0, 2000):
        save_snapshot(str(run), state, cur_nimg=nimg, configs={"G": gcfg, "D": dcfg})
    return pkl, str(run)


def recording(monkeypatch, module, record):
    """Record the frames a video_io module's writers get, as uint8, and write
    them as they would be."""
    for name in ("save_video_frames_as_mp4", "save_video_frames_as_frames_parallel"):
        orig = getattr(module, name)

        def writer(frames, *args, _orig=orig, _name=name, **kw):
            record.append((_name, (np.clip(frames, 0, 1) * 255).astype(np.uint8)))
            return _orig(frames, *args, **kw)
        monkeypatch.setattr(module, name, writer)


def replaying_motion(monkeypatch):
    """The port's generate_videos draws JAX's motion trajectories
    (jax.random.normal(PRNGKey(seed)), stylegan_v_tpu/training/video_io.py)
    where the CLI passes none."""
    orig = tvio.generate_videos

    def run(G, z, c, ts, motion_z=None, seed=0, **kw):
        if motion_z is None and G.cfg.has_motion:
            L = JMotion.required_traj_len(G.cfg, float(np.max(ts)))
            motion_z = np.array(jax.random.normal(jax.random.PRNGKey(seed),
                                                  (len(ts), L, G.cfg.motion.z_dim)))
        return orig(G, z, c, ts, motion_z=motion_z, seed=seed, **kw)
    monkeypatch.setattr(tvio, "generate_videos", run)


def jax_cli(monkeypatch, script, argv):
    monkeypatch.setattr(sys, "argv", [script + ".py"] + argv)
    module = __import__(script)
    module.main()


@pytest.mark.parametrize("mode", ["frames", "moco", "grids"])
def test_generate_writes_the_jax_cli_frames(checkpoints, tmp_path, monkeypatch, mode):
    pkl, _ = checkpoints
    argv = ["--network", pkl, "--num-videos", "4", "--video-len", "5", "--save-as-frames",
            "--slowmo", "2.0"] + {"frames": [], "moco": ["--moco-decomposition"],
                                  "grids": ["--as-grids"]}[mode]
    want, got = [], []
    recording(monkeypatch, jvio, want)
    recording(monkeypatch, tvio, got)
    replaying_motion(monkeypatch)
    jax_cli(monkeypatch, "generate", argv + ["-o", str(tmp_path / "jax")])
    videos = tgen.main(argv + ["-o", str(tmp_path / "port"), "--device", "cpu"])
    assert [n for n, _ in got] == [n for n, _ in want] and len(got) == (4 if mode == "frames"
                                                                        else 1)
    for (_, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and g.std() > 0
        diff = np.abs(g.astype(int) - w.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, (diff.max(), (diff > 0).mean())
    assert videos.shape == (4, 5, 32, 32, 3)
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax"))
    if mode == "frames":
        assert sorted(os.listdir(tmp_path / "port" / "video0000")) == \
            [f"{i:06d}.jpg" for i in range(5)]


def test_generate_picks_the_best_snapshot_by_metric(checkpoints, tmp_path, capsys):
    _, run = checkpoints
    argv = ["--networks-dir", run, "--num-videos", "1", "--video-len", "2", "--device", "cpu"]
    tgen.main(argv + ["-o", str(tmp_path / "latest")])
    assert "network-snapshot-000002.pt" in capsys.readouterr().out      # no jsonl: the latest
    jsonl = os.path.join(run, "metric-fvd2048_16f.jsonl")
    with open(jsonl, "w") as f:
        f.write(json.dumps({"results": {"fvd2048_16f": 10.0},
                            "snapshot": "network-snapshot-000000"}) + "\n")
        f.write(json.dumps({"results": {"fvd2048_16f": 50.0},
                            "snapshot": "network-snapshot-000002"}) + "\n")
    try:
        videos = tgen.main(argv + ["-o", str(tmp_path / "best")])
    finally:
        os.remove(jsonl)
    assert "network-snapshot-000000.pt" in capsys.readouterr().out
    assert os.listdir(tmp_path / "best") == ["video0000.mp4"] and videos.shape[:2] == (1, 2)


def test_generate_rejects_a_nonsquare_moco_decomposition(checkpoints, tmp_path):
    pkl, _ = checkpoints
    with pytest.raises(ValueError, match="square num-videos"):
        tgen.main(["--network", pkl, "-o", str(tmp_path), "--num-videos", "3",
                   "--moco-decomposition", "--device", "cpu"])


def test_generate_from_a_snapshot_equals_the_pkl(checkpoints, tmp_path):
    pkl, run = checkpoints
    argv = ["--num-videos", "4", "--video-len", "3", "--device", "cpu",
            "--moco-decomposition"]
    a = tgen.main(argv + ["--network", pkl, "-o", str(tmp_path / "a")])
    b = tgen.main(argv + ["--network", os.path.join(run, "network-snapshot-000000.pt"),
                          "-o", str(tmp_path / "b")])
    np.testing.assert_array_equal(a, b)


def read_rows(run_dir):
    rows = {}
    for name in sorted(os.listdir(run_dir)):
        if name.startswith("metric-"):
            rec = json.loads(open(os.path.join(run_dir, name)).read().splitlines()[-1])
            rows.update(rec["results"])
    return rows


def assert_rows_close(got, want):
    assert got.keys() == want.keys() and got
    for k, w in want.items():
        assert np.isfinite(got[k]) and abs(got[k] - w) <= CLIP_TOL * max(abs(w), 1e-3), \
            (k, got[k], w)


def test_calc_metrics_writes_the_jax_cli_rows(checkpoints, tmp_path, monkeypatch, tiny_metrics):
    pkl, run = checkpoints
    data = build_video_dataset_dir(str(tmp_path), num_videos=6, frames_per_video=12, res=32)
    monkeypatch.setenv("SGV_STUB_DETECTORS", "1")
    monkeypatch.setenv("HOME", str(tmp_path))            # the stats caches
    replaying(monkeypatch)
    argv = ["--data", data, "--metrics", "fvd_cli_tiny,fid_cli_tiny"]
    jax_cli(monkeypatch, "calc_metrics", argv + ["--network", pkl,
                                                 "--run-dir", str(tmp_path / "jax")])
    tcm.main(argv + ["--network", pkl, "--run-dir", str(tmp_path / "port"), "--device", "cpu"])
    want = read_rows(tmp_path / "jax")
    assert_rows_close(read_rows(tmp_path / "port"), want)
    # the port's snapshot of the same G_ema, into the run dir by default
    snap = os.path.join(run, "network-snapshot-000000.pt")
    tcm.main(argv + ["--network", snap, "--device", "cpu"])
    assert read_rows(run) == read_rows(tmp_path / "port")
    rec = json.loads(open(os.path.join(run, "metric-fvd_cli_tiny.jsonl")).readlines()[-1])
    assert rec["snapshot"] == "network-snapshot-000000.pt"
    for name in os.listdir(run):
        if name.startswith("metric-"):
            os.remove(os.path.join(run, name))
    with pytest.raises(SystemExit, match="unknown metric"):
        tcm.main(argv[:2] + ["--metrics", "not_a_metric", "--network", pkl, "--device", "cpu"])


def test_calc_metrics_for_dataset_writes_the_jax_cli_rows(tmp_path, monkeypatch, tiny_metrics):
    import PIL.Image
    real = build_video_dataset_dir(str(tmp_path / "a"), num_videos=6, frames_per_video=8,
                                   res=32)
    fake = build_video_dataset_dir(str(tmp_path / "b"), num_videos=6, frames_per_video=8,
                                   res=32)
    for dirpath, _dirs, files in os.walk(fake):           # really other frames
        for fn in files:
            p = os.path.join(dirpath, fn)
            img = np.asarray(PIL.Image.open(p))
            PIL.Image.fromarray(255 - img).save(p)
    monkeypatch.setenv("SGV_STUB_DETECTORS", "1")
    monkeypatch.setenv("HOME", str(tmp_path))
    for fake_data, tag in ((real, "same"), (fake, "other")):
        argv = ["--real-data", real, "--fake-data", fake_data, "--metrics",
                "fvd_cli_tiny,fid_cli_tiny", "--resolution", "32", "--max-num-frames", "8"]
        jax_cli(monkeypatch, "calc_metrics_for_dataset",
                argv + ["--run-dir", str(tmp_path / f"jax-{tag}")])
        tcmd.main(argv + ["--run-dir", str(tmp_path / f"port-{tag}"), "--device", "cpu"])
        got, want = read_rows(tmp_path / f"port-{tag}"), read_rows(tmp_path / f"jax-{tag}")
        if tag == "same":
            assert all(abs(v) < 1e-6 for v in (*got.values(), *want.values())), (got, want)
        else:
            assert_rows_close(got, want)
            assert min(got.values()) > 0
