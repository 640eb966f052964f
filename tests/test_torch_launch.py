"""The port's launchers and media CLI (`python -m stylegan_v_tpu_torch.{launch,
batch_launch,frames_to_video_grid}`) against scripts/ (the JAX package's), on
the CPU, and every new CLI's device rule.

  * launch --print-only: the release dir (code snapshot of the port and
    configs/, frozen config with absolute paths, training_cmd.sh), the job
    lines (`python -m stylegan_v_tpu_torch.train --cfg-path ...`, jobs 2..N
    resuming from latest), the refusal of a dirty checkout.
  * A real job sequence of two tiny CPU jobs (narrow widths at 32^2): job 2
    resumes job 1's snapshot.
  * batch_launch: the sweep's expansion equal to the JAX
    construct_experiment_args over configs/experiments.yaml, and the printed
    launch lines carrying the JAX script's overrides.
  * frames_to_video_grid: the grid equal to the JAX package's videos_as_grids
    and the mp4 read back frame for frame as the JAX script writes it.
  * Without a card, project, clip_edit, export_model, launch and batch_launch
    raise on their default --device (cuda).
"""
import json
import os
import sys

import numpy as np
import PIL.Image
import pytest
import torch
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import batch_launch as jbatch  # noqa: E402
import frames_to_video_grid as jgrid  # noqa: E402
from stylegan_v_tpu.training import video_io as jvio  # noqa: E402
from stylegan_v_tpu_torch import batch_launch as tbatch  # noqa: E402
from stylegan_v_tpu_torch import clip_edit as tclip  # noqa: E402
from stylegan_v_tpu_torch import export_model as texport  # noqa: E402
from stylegan_v_tpu_torch import frames_to_video_grid as tgrid  # noqa: E402
from stylegan_v_tpu_torch import launch as tlaunch  # noqa: E402
from stylegan_v_tpu_torch import project as tproject  # noqa: E402
from stylegan_v_tpu_torch.utils import config as tcfglib  # noqa: E402

from test_data import build_video_dataset_zip  # noqa: E402

SWEEP = os.path.join(REPO, "configs", "experiments.yaml")
# stylegan-v at 32^2 and narrow widths without augment: job 1 trains its
# kimg (the least, 1: 21 steps of 16 videos x 3 frames), job 2 resumes at its
# end and takes one step (the loop checks its end after a step)
TINY = ["model.generator.fmaps=0.03125", "model.generator.channel_max=16",
        "model.discriminator.fmaps=0.03125", "model.discriminator.channel_max=16",
        "model.generator.w_dim=32", "model.generator.z_dim=32",
        "model.generator.motion.z_dim=16", "model.generator.motion.v_dim=16",
        "model.generator.time_enc.dim=16", "training.batch_size=16", "training.kimg=1",
        "training.aug=noaug", "training.metrics=[]", "training.num_workers=1"]


def test_launch_print_only(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    run = "runs/seq"                                   # relative: frozen as absolute
    argv = ["dataset.path=data/x.zip", f"project_release_dir={run}", "--jobs", "3",
            "--print-only", "--device", "cpu"]
    monkeypatch.setattr(tlaunch, "git_is_clean", lambda: False)
    with pytest.raises(SystemExit, match="dirty git checkout"):
        tlaunch.main(argv)
    assert not os.path.exists(run)
    assert tlaunch.main(argv + ["--allow-dirty"]) == []

    run_abs = str(tmp_path / run)
    code = os.path.join(run_abs, "code")
    lines = capsys.readouterr().out.strip().splitlines()
    cfg_path = os.path.join(run_abs, "experiment_config.yaml")
    job = (f"cd {code} && {sys.executable} -m stylegan_v_tpu_torch.train --cfg-path "
           f"{cfg_path} --device cpu")
    assert lines == [job, job + " training.resume=latest", job + " training.resume=latest"]
    sh = open(os.path.join(run_abs, "training_cmd.sh")).read().splitlines()
    assert sh[:2] == ["#!/bin/sh", f"cd {code} || exit 1"]
    assert sh[2:] == [line.split(" && ", 1)[1] for line in lines]
    assert sorted(os.listdir(code)) == ["configs", "stylegan_v_tpu_torch"]
    for dirpath, dirs, _ in os.walk(code):
        assert not {"__pycache__", "_build"} & set(dirs), dirpath
    frozen = tcfglib.load_frozen(cfg_path)
    assert frozen.project_release_dir == run_abs
    assert frozen.dataset.path == frozen.training.data == str(tmp_path / "data" / "x.zip")
    assert frozen.training.outdir == run_abs


def test_launch_runs_a_resumable_job_sequence(tmp_path, monkeypatch):
    zip_path = build_video_dataset_zip(str(tmp_path), num_videos=4, frames_per_video=8, res=32)
    run = str(tmp_path / "run")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rets = tlaunch.main([f"dataset.path={zip_path}", f"project_release_dir={run}"] + TINY
                        + ["--jobs", "2", "--allow-dirty", "--device", "cpu"])
    assert rets == [0, 0]
    log = open(os.path.join(run, "log.txt")).read()
    snap = os.path.join(run, "network-snapshot-000001.pt")
    assert log.count("Resuming from") == 1 and f"Resuming from {snap}" in log
    rows = [json.loads(line) for line in open(os.path.join(run, "stats.jsonl"))]
    assert len(rows) == 2                            # one tick a job
    meta = json.load(open(os.path.join(run, "network-snapshot-000001.meta.json")))
    assert meta["cur_nimg"] == 22 * 16 * 3           # 21 steps, then one more


def test_batch_launch_expands_as_jax(tmp_path, monkeypatch, capsys):
    sweep = yaml.safe_load(open(SWEEP))
    for group in sweep.values():
        names = list(group["experiments"])
        for subset, suffix in ((None, ""), (names[-1:], "_r2")):
            assert (tbatch.construct_experiment_args(group, subset, suffix)
                    == jbatch.construct_experiment_args(group, subset, suffix))

    argv = ["--group", "motion_period_ablation", "--datasets", "ffs,sky_timelapse",
            "--print-only", "--allow-dirty"]
    monkeypatch.setattr(sys, "argv", ["batch_launch.py"] + argv)
    jbatch.main()
    want = capsys.readouterr().out.strip().splitlines()
    cmds = tbatch.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()
    assert got == [" ".join(c) for c in cmds] and len(got) == len(want) == 6
    launcher = os.path.join(REPO, "scripts", "launch.py")
    for g, w in zip(cmds, want):
        assert g[:3] == [sys.executable, "-m", "stylegan_v_tpu_torch.launch"]
        assert g[-3:] == ["--device", "cpu", "--allow-dirty"]
        assert " ".join(g[3:-3]) == w.split(f"{launcher} ", 1)[1].rsplit(" --allow-dirty", 1)[0]


def test_frames_to_video_grid(tmp_path, monkeypatch):
    import cv2
    src = tmp_path / "frames"
    rng = np.random.RandomState(5)
    for v in range(3):
        d = src / f"video{v:04d}"
        d.mkdir(parents=True)
        for f in range(6):
            PIL.Image.fromarray(rng.randint(0, 255, (16, 16, 3)).astype(np.uint8)).save(
                d / f"{f:06d}.png")
    grid = tgrid.main(["-s", str(src), "-o", str(tmp_path / "port.mp4"), "--num_videos", "2",
                       "--num_frames", "5"])
    videos = np.stack([np.stack([np.array(PIL.Image.open(src / f"video{v:04d}" / f"{f:06d}.png"))
                                 for f in range(5)]) for v in range(2)])
    assert np.array_equal(grid, jvio.videos_as_grids(videos.astype(np.float32) / 255.0))
    monkeypatch.setattr(sys, "argv", ["frames_to_video_grid.py", "-s", str(src), "-o",
                                      str(tmp_path / "jax.mp4"), "--num_videos", "2",
                                      "--num_frames", "5"])
    jgrid.main()

    def read(path):
        cap = cv2.VideoCapture(str(path))
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame)
        cap.release()
        return np.stack(frames)
    got, want = read(tmp_path / "port.mp4"), read(tmp_path / "jax.mp4")
    assert got.shape == want.shape and got.shape[0] == 5 and np.array_equal(got, want)


@pytest.mark.parametrize("cli,argv", [
    (tproject, ["--network", "x.pt", "--target-dir", "t", "-o", "o"]),
    (tclip, ["--network", "x.pt", "--text", "a", "--clip-path", "c", "-o", "o"]),
    (texport, ["--ckpt", "x.pt", "--out", "m.pt2"]),
    (tlaunch, ["--print-only"]),
    (tbatch, ["--group", "batch_ablation", "--datasets", "ffs", "--print-only"]),
], ids=["project", "clip_edit", "export_model", "launch", "batch_launch"])
def test_cli_raises_without_cuda(tmp_path, monkeypatch, cli, argv):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
    assert os.listdir(tmp_path) == []
