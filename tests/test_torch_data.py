"""Parity of the port's data path and host utilities with the JAX package, on
the CPU: frame sampling, the datasets (JPEG zip, PNG directory, PPM zip,
labels, xflip), the numpy PPM reader against Pillow, the native JPEG
decoder, the loader's batches and the device wrapper, the device stats
accumulator and the config system. Every comparison is exact.
"""
import io
import json
import os
import zipfile

import numpy as np
import PIL.Image
import pytest
import torch

from stylegan_v_tpu.data import dataset as jdataset
from stylegan_v_tpu.data import loader as jloader
from stylegan_v_tpu.data import sampling as jsampling
from stylegan_v_tpu.models import config as jconfig
from stylegan_v_tpu.native import fastjpeg as jfastjpeg
from stylegan_v_tpu.utils import config as jcfglib
from stylegan_v_tpu.utils import training_stats as jstats
from stylegan_v_tpu_torch.data import dataset as tdataset
from stylegan_v_tpu_torch.data import loader as tloader
from stylegan_v_tpu_torch.data import sampling as tsampling
from stylegan_v_tpu_torch.models import config as tconfig
from stylegan_v_tpu_torch.native import fastjpeg as tfastjpeg
from stylegan_v_tpu_torch.utils import config as tcfglib
from stylegan_v_tpu_torch.utils import training_stats as tstats
from stylegan_v_tpu_torch.utils.misc import format_time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLING = dict(num_frames_per_video=3, max_num_frames=16, total_dists=(1, 2, 4, 8), max_dist=8)


def both_samplings(**kw):
    return jconfig.SamplingConfig(**kw), tconfig.SamplingConfig(**kw)


def assert_items_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


# ----------------------------------------------------------------- sampling

@pytest.mark.parametrize("kind,fractional", [("random", False), ("random", True),
                                             ("uniform", False), ("uniform", True),
                                             ("uniform_dists", False)])
def test_sample_frames_equals_the_jax_package(kind, fractional):
    kw = dict(num_frames_per_video=4, max_num_frames=64)
    if kind == "random":
        kw.update(type="random", total_dists=(1, 2, 4, 8, 16, 32), max_dist=32)
    elif kind == "uniform":
        kw.update(type="uniform", total_dists=None, max_dist=8)
    else:
        kw.update(type="uniform", dists_between_frames=(1, 2, 3, 5), max_dist_between_frames=3)
    jcfg, tcfg = both_samplings(**kw)
    for seed in range(12):
        for length in (12, 20, 64):
            jr, tr = np.random.RandomState(seed), np.random.RandomState(seed)
            for _ in range(3):
                want = jsampling.sample_frames(jcfg, length, fractional, jr)
                got = tsampling.sample_frames(tcfg, length, fractional, tr)
                np.testing.assert_array_equal(got, want)
                assert got.dtype == want.dtype


# ----------------------------------------------------------------- datasets

def frame(v, f, res=16):
    """A frame with structure in both axes, so xflip and JPEG both show."""
    r = np.random.RandomState(v * 1000 + f)
    base = r.randint(0, 256, size=(4, 4, 3)).astype(np.uint8)
    return np.kron(base, np.ones((res // 4, res // 4, 1), np.uint8))


def write_frames(root, fmt, num_videos=4, frames=12, labels=None, as_zip=False):
    """A depth-2 video dataset of `fmt` frames, in a directory or a zip."""
    entries, files = [], {}
    for v in range(num_videos):
        for f in range(frames):
            name = f"video{v:04d}/{f:06d}.{fmt}"
            b = io.BytesIO()
            PIL.Image.fromarray(frame(v, f)).save(b, format={"jpg": "JPEG", "png": "PNG",
                                                             "ppm": "PPM"}[fmt], quality=95)
            files[name] = b.getvalue()
            if labels is not None:
                entries.append([name, labels[v]])
    if labels is not None:
        files["dataset.json"] = json.dumps({"labels": entries}).encode()
    if as_zip:
        path = os.path.join(root, f"ds_{fmt}.zip")
        with zipfile.ZipFile(path, "w") as z:
            for name, data in files.items():
                z.writestr(name, data)
        return path
    path = os.path.join(root, f"ds_{fmt}")
    for name, data in files.items():
        os.makedirs(os.path.dirname(os.path.join(path, name)), exist_ok=True)
        with open(os.path.join(path, name), "wb") as fh:
            fh.write(data)
    return path


@pytest.mark.parametrize("fmt,as_zip,labels,xflip", [
    ("jpg", True, [0, 2, 1, 2], True),      # JPEG zip: the native decoder on a multi-core host
    ("png", False, [[0.5, 1.0], [1.5, -1.0], [0.0, 0.0], [2.0, 3.0]], False),
    ("ppm", True, None, True),
])
def test_video_dataset_items_equal_the_jax_package(tmp_path, fmt, as_zip, labels, xflip):
    path = write_frames(str(tmp_path), fmt, labels=labels, as_zip=as_zip)
    jcfg, tcfg = both_samplings(**SAMPLING)
    kw = dict(max_num_frames=8, use_labels=labels is not None, xflip=xflip, seed=3)
    jds = jdataset.VideoFramesFolderDataset(path, sampling=jcfg, **kw)
    tds = tdataset.VideoFramesFolderDataset(path, sampling=tcfg, **kw)
    assert (len(tds), tds.resolution, tds.label_shape, tds.has_labels) == \
        (len(jds), jds.resolution, jds.label_shape, jds.has_labels)
    for i in list(range(len(jds))) * 2:       # twice: the window offsets draw anew
        assert_items_equal(tds[i], jds[i])
    # consecutive loading with a per-item offset, as the metrics read videos
    kw.update(load_n_consecutive=5)
    jds = jdataset.VideoFramesFolderDataset(path, sampling=jcfg, **kw)
    tds = tdataset.VideoFramesFolderDataset(path, sampling=tcfg, **kw)
    for i in range(len(jds)):
        assert_items_equal(tds[i], jds[i])
    jds.close()
    tds.close()


def test_image_folder_dataset_equals_the_jax_package(tmp_path):
    path = str(tmp_path / "images")
    os.makedirs(path)
    for i in range(5):
        PIL.Image.fromarray(frame(i, 0)).save(os.path.join(path, f"{i:03d}.png"))
    with open(os.path.join(path, "dataset.json"), "w") as fh:
        json.dump({"labels": [[f"{i:03d}.png", i % 3] for i in range(5)]}, fh)
    kw = dict(use_labels=True, xflip=True, max_size=4, random_seed=1)
    jds, tds = jdataset.ImageFolderDataset(path, **kw), tdataset.ImageFolderDataset(path, **kw)
    assert len(tds) == len(jds) == 8
    for i in range(len(jds)):
        assert_items_equal(tds[i], jds[i])


@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_numpy_ppm_read_equals_pillow(mode):
    img = PIL.Image.fromarray(frame(1, 2, res=12)[..., 0] if mode == "L" else frame(1, 2, res=12))
    b = io.BytesIO()
    img.save(b, format="PPM")
    data = b.getvalue()
    want = np.array(PIL.Image.open(io.BytesIO(data)))
    want = want[..., None] if want.ndim == 2 else want
    got = tdataset.read_binary_pnm(data)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint8 and got.flags.writeable
    # a header comment, as other writers put one
    magic, rest = data.split(b"\n", 1)
    np.testing.assert_array_equal(tdataset.read_binary_pnm(magic + b"\n# made here\n" + rest),
                                  want)
    np.testing.assert_array_equal(tdataset.load_image_from_buffer(io.BytesIO(data)), want)


def test_pnm_reader_leaves_other_formats_to_pillow():
    b = io.BytesIO()
    PIL.Image.fromarray(frame(0, 0)).save(b, format="PNG")
    assert tdataset.read_binary_pnm(b.getvalue()) is None
    assert tdataset.read_binary_pnm(b"P6\n2 2\n65535\n" + bytes(24)) is None   # 16-bit
    with pytest.raises(ValueError, match="truncated"):
        tdataset.read_binary_pnm(b"P6\n2 2\n255\n" + bytes(5))


def test_fastjpeg_decode_equals_the_jax_package():
    if not (jfastjpeg.is_available() and tfastjpeg.is_available()):
        pytest.fail("the native JPEG decoder did not build (g++ and libjpeg are needed)")
    bufs = []
    for i in range(6):
        b = io.BytesIO()
        PIL.Image.fromarray(frame(i, 1, res=32)).save(b, format="JPEG", quality=90)
        bufs.append(b.getvalue())
    np.testing.assert_array_equal(tfastjpeg.decode_jpeg_batch(bufs, 32, 32, 3),
                                  jfastjpeg.decode_jpeg_batch(bufs, 32, 32, 3))
    assert tfastjpeg.probe_jpeg(bufs[0]) == jfastjpeg.probe_jpeg(bufs[0]) == (32, 32, 3)
    assert tfastjpeg._BUILD_DIR.endswith(os.path.join("stylegan_v_tpu_torch", "_build"))


# ------------------------------------------------------------------- loader

def test_infinite_indices_equal_the_jax_package():
    for kw in (dict(seed=0), dict(seed=5, rank=1, num_replicas=3), dict(shuffle=False)):
        j, t = jloader.infinite_indices(7, **kw), tloader.infinite_indices(7, **kw)
        assert [next(t) for _ in range(50)] == [next(j) for _ in range(50)]


def test_loader_batches_equal_the_jax_package(tmp_path):
    """num_workers=1: the dataset's RNG is shared with the worker pool, so
    more workers would draw in a racy order (ROADMAP §3)."""
    path = write_frames(str(tmp_path), "png", num_videos=5, frames=20,
                        labels=[0, 1, 1, 0, 2])
    jcfg, tcfg = both_samplings(**SAMPLING)
    kw = dict(max_num_frames=16, use_labels=True, xflip=True, seed=2)
    jds = jdataset.VideoFramesFolderDataset(path, sampling=jcfg, **kw)
    tds = tdataset.VideoFramesFolderDataset(path, sampling=tcfg, **kw)
    lkw = dict(batch_size=3, use_fractional_t=True, seed=4, num_workers=1)
    jl = jloader.TrainingDataLoader(jds, gen_sampling=jcfg, **lkw)
    tl = tloader.TrainingDataLoader(tds, gen_sampling=tcfg, **lkw)
    try:
        for _ in range(4):
            want = next(jl)
            got = next(tl)
            assert_items_equal(got, want)
    finally:
        jl.close()
        tl.close()
    # the device wrapper, here on the CPU: the same batches, real_img as [B, F, C, H, W]
    tds = tdataset.VideoFramesFolderDataset(path, sampling=tcfg, **kw)
    host = tloader.TrainingDataLoader(tds, gen_sampling=tcfg, **lkw)
    dev = tloader.DeviceLoader(tloader.TrainingDataLoader(
        tdataset.VideoFramesFolderDataset(path, sampling=tcfg, **kw), gen_sampling=tcfg, **lkw),
        torch.device("cpu"))
    try:
        for _ in range(3):
            want, got = next(host), next(dev)
            assert set(got) == set(want)
            assert got["real_img"].dtype == torch.uint8 and got["real_img"].is_contiguous()
            np.testing.assert_array_equal(got["real_img"].numpy(),
                                          want["real_img"].transpose(0, 1, 4, 2, 3))
            for k in ("real_c", "real_t", "gen_c", "gen_t"):
                np.testing.assert_array_equal(got[k].numpy(), want[k])
    finally:
        host.close()
        dev.close()


@pytest.mark.parametrize("rank", [0, 1])
def test_loader_batches_of_each_rank_equal_the_jax_package(tmp_path, rank):
    """Over two ranks each loader reads its rank-strided share of the index
    stream with its own worker seeds, as the JAX package's does per process;
    the training loop takes those rows as the rank's rows of the global batch."""
    path = write_frames(str(tmp_path), "png", num_videos=5, frames=20)
    jcfg, tcfg = both_samplings(**SAMPLING)
    kw = dict(max_num_frames=16, seed=2)
    lkw = dict(batch_size=2, use_fractional_t=True, seed=4, num_workers=1, rank=rank,
               num_replicas=2)
    jl = jloader.TrainingDataLoader(jdataset.VideoFramesFolderDataset(path, sampling=jcfg, **kw),
                                    gen_sampling=jcfg, **lkw)
    tl = tloader.TrainingDataLoader(tdataset.VideoFramesFolderDataset(path, sampling=tcfg, **kw),
                                    gen_sampling=tcfg, **lkw)
    try:
        for _ in range(3):
            assert_items_equal(next(tl), next(jl))
    finally:
        jl.close()
        tl.close()


# -------------------------------------------------------------------- stats

def test_device_stats_accumulator_equals_the_jax_package():
    """One stat stream with NaN and Inf in it, and a second key set (a
    variant with an extra stat), drained twice."""
    import jax.numpy as jnp
    r = np.random.RandomState(0)
    ja, ta = jstats.DeviceStatsAccumulator(), tstats.DeviceStatsAccumulator()
    jc, tc = jstats.Collector(), tstats.Collector()
    specials = {3: np.nan, 5: np.inf, 8: -np.inf}
    for tick in range(2):
        for step in range(10):
            stats = {"Loss/G/loss": np.float32(r.randn() * 3),
                     "Loss/scores/real": np.float32(specials.get(step, r.randn())),
                     "Progress/augment_p": np.float32(r.rand())}
            if step % 4 == 0:
                stats["Loss/r1_penalty"] = np.float32(r.rand() * 10)
            ja.update({k: jnp.asarray(v) for k, v in stats.items()})
            ta.update({k: torch.tensor(v) for k, v in stats.items()})
        ja.drain_into(jc)
        ta.drain_into(tc)
        assert tc.as_dict() == jc.as_dict()
        for name in jc.names():
            np.testing.assert_array_equal(tc._get(name), jc._get(name))
        assert tc.num("Loss/scores/real") == 7 * (tick + 1)


def test_collector_and_jsonl_equal_the_jax_package(tmp_path):
    jc, tc = jstats.Collector(), tstats.Collector()
    for v in ([1.0, 2.0, np.nan], 3.5, [[-1.0, 4.0]]):
        jc.report("a", v)
        tc.report("a", v)
    assert tc.as_dict() == jc.as_dict()
    jw, tw = jstats.StatsJsonlWriter(str(tmp_path / "j")), tstats.StatsJsonlWriter(str(tmp_path / "t"))
    jw.write(jc.as_dict(), timestamp=1.0)
    tw.write(tc.as_dict(), timestamp=1.0)
    jw.close()
    tw.close()
    assert (tmp_path / "t" / "stats.jsonl").read_text() == (tmp_path / "j" / "stats.jsonl").read_text()


def test_format_time_equals_the_jax_package():
    from stylegan_v_tpu.utils.misc import format_time as jformat_time
    for s in (0, 0.4, 59.6, 61, 3599, 3600, 86399, 86400 * 3 + 3661):
        assert format_time(s) == jformat_time(s)


# ------------------------------------------------------------------- config

@pytest.mark.parametrize("overrides", [
    [],
    ["dataset=sky_timelapse", "sampling=uniform", "training.batch_size=16",
     "training.metrics=[]", "model.generator.motion.z_dim=64", "exp_suffix=x"],
])
def test_load_config_equals_the_jax_package(tmp_path, overrides):
    config_dir = os.path.join(REPO, "configs")
    want = jcfglib.load_config(config_dir, overrides)
    got = tcfglib.load_config(config_dir, overrides)
    assert got == want
    assert got.training.cfg == "auto"             # attribute access, as EasyDict
    tcfglib.save(got, str(tmp_path / "t.yaml"))
    jcfglib.save(want, str(tmp_path / "j.yaml"))
    assert (tmp_path / "t.yaml").read_text() == (tmp_path / "j.yaml").read_text()
    assert tcfglib.load_frozen(str(tmp_path / "t.yaml")) == jcfglib.load_frozen(str(tmp_path / "j.yaml"))
    assert tcfglib._parse_value("[1, 2]") == jcfglib._parse_value("[1, 2]") == [1, 2]
