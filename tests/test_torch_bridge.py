"""The PyTorch port's weight bridge, its config copy, and its import boundary.

  * JAX-init variables -> stylegan_v_tpu_torch.io.bridge -> the port's modules
    (strict load) -> state_dict -> stylegan_v_tpu/io/legacy.py:convert_*
    gives the flax tree back exactly.
  * The port's config dataclasses equal the JAX package's field for field.
  * Importing every module of the port loads neither jax, flax nor
    stylegan_v_tpu (in a subprocess: this process has jax from conftest.py).
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import jax

from stylegan_v_tpu.io.legacy import convert_discriminator_state, convert_generator_state
from stylegan_v_tpu.models import Discriminator as JDiscriminator
from stylegan_v_tpu.models import Generator as JGenerator
from stylegan_v_tpu.models import MotionMappingNetwork as JMotion
from stylegan_v_tpu.models import config as jconfig
from stylegan_v_tpu_torch.io import jax_to_torch_discriminator, jax_to_torch_generator
from stylegan_v_tpu_torch.models import config as tconfig
from stylegan_v_tpu_torch.models.discriminator import Discriminator
from stylegan_v_tpu_torch.models.generator import Generator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLING = jconfig.SamplingConfig(num_frames_per_video=3, max_num_frames=128)


def port_cfg(cfg):
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields = {k: port_cfg(v) if dataclasses.is_dataclass(v) else v for k, v in fields.items()}
    return getattr(tconfig, type(cfg).__name__)(**fields)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def assert_trees_equal(got, want):
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def state_numpy(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


@pytest.mark.parametrize("kw", [
    dict(),
    dict(architecture="resnet", **{"motion.fourier": False}),
])
def test_generator_round_trip(kw):
    cfg = jconfig.replace(jconfig.GeneratorConfig(
        w_dim=32, z_dim=32, img_resolution=16, channel_base=256, channel_max=32,
        num_bf16_res=0, mapping_layers=2,
        motion=jconfig.MotionConfig(z_dim=16, v_dim=16, kernel_size=5),
        time_enc=jconfig.TimeEncConfig(dim=8), sampling=SAMPLING), **kw)
    z = np.zeros((1, cfg.z_dim), np.float32)
    t = np.asarray([[0.0, 1.0, 5.0]], np.float32)
    mz = np.zeros((1, JMotion.required_traj_len(cfg), cfg.motion.z_dim), np.float32)
    variables = to_np(JGenerator(cfg).init(jax.random.PRNGKey(0), z, None, t, motion_z=mz))
    variables["moving"]["mapping"]["w_avg"] = np.arange(cfg.w_dim, dtype=np.float32)

    G = Generator(port_cfg(cfg))
    G.load_state_dict(jax_to_torch_generator(variables))          # strict
    assert G.synthesis.b4.input.const.shape == (cfg.channel_max, 4, 4)
    assert_trees_equal(convert_generator_state(state_numpy(G)), variables)


def test_discriminator_round_trip():
    cfg = jconfig.DiscriminatorConfig(
        img_resolution=16, channel_base=256, channel_max=32, num_bf16_res=0,
        concat_res=8, mbstd_group_size=2, mapping_layers=2, sampling=SAMPLING)
    img = np.zeros((3, 16, 16, 3), np.float32)
    t = np.asarray([[0.0, 1.0, 5.0]], np.float32)
    variables = to_np(JDiscriminator(cfg).init(jax.random.PRNGKey(0), img, None, t))

    D = Discriminator(port_cfg(cfg))
    sd = jax_to_torch_discriminator(variables)
    D.load_state_dict(sd)                                           # strict
    # the fc rows follow the port's C*H*W flatten: row c*16 + h*4 + w
    C = D.b4.in_channels
    jw = variables["params"]["b4"]["fc"]["weight"]                  # [(h*4+w)*C + c, out]
    np.testing.assert_array_equal(sd["b4.fc.weight"][:, 2 * 16 + 1 * 4 + 3].numpy(),
                                  jw[(1 * 4 + 3) * C + 2])
    back = convert_discriminator_state(state_numpy(D), epilogue_channels=C)
    assert_trees_equal(back, variables)


@pytest.mark.parametrize("name", ["SamplingConfig", "MotionConfig", "TimeEncConfig",
                                  "GeneratorConfig", "DiscriminatorConfig"])
def test_config_copy_equals_the_jax_package(name):
    jcls, tcls = getattr(jconfig, name), getattr(tconfig, name)
    jf, tf = dataclasses.fields(jcls), dataclasses.fields(tcls)
    assert [(f.name, f.type) for f in jf] == [(f.name, f.type) for f in tf]
    assert jcls.__dataclass_params__.frozen and tcls.__dataclass_params__.frozen
    jd, td = jcls(), tcls()
    for f in jf:
        jv, tv = getattr(jd, f.name), getattr(td, f.name)
        assert (dataclasses.asdict(jv) == dataclasses.asdict(tv)
                if dataclasses.is_dataclass(jv) else jv == tv), f.name
    if name == "GeneratorConfig":
        assert (tconfig.replace(td, **{"motion.z_dim": 8}).motion.z_dim
                == jconfig.replace(jd, **{"motion.z_dim": 8}).motion.z_dim == 8)


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import stylegan_v_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax',"
        " 'stylegan_v_tpu')]\n"
        "new = {'stylegan_v_tpu_torch.training.loss', 'stylegan_v_tpu_torch.training.train_step',"
        " 'stylegan_v_tpu_torch.data.dataset', 'stylegan_v_tpu_torch.data.loader',"
        " 'stylegan_v_tpu_torch.data.sampling', 'stylegan_v_tpu_torch.native.fastjpeg',"
        " 'stylegan_v_tpu_torch.utils.config', 'stylegan_v_tpu_torch.utils.logger',"
        " 'stylegan_v_tpu_torch.utils.summary', 'stylegan_v_tpu_torch.utils.training_stats',"
        " 'stylegan_v_tpu_torch.training.video_io', 'stylegan_v_tpu_torch.training.loop',"
        " 'stylegan_v_tpu_torch.io.checkpoint', 'stylegan_v_tpu_torch.train_setup',"
        " 'stylegan_v_tpu_torch.train', 'stylegan_v_tpu_torch.metrics.metric_main',"
        " 'stylegan_v_tpu_torch.metrics.metric_utils',"
        " 'stylegan_v_tpu_torch.metrics.frechet_inception_distance',"
        " 'stylegan_v_tpu_torch.metrics.frechet_video_distance',"
        " 'stylegan_v_tpu_torch.metrics.kernel_inception_distance',"
        " 'stylegan_v_tpu_torch.metrics.inception_score',"
        " 'stylegan_v_tpu_torch.metrics.detectors.resize',"
        " 'stylegan_v_tpu_torch.metrics.detectors.common',"
        " 'stylegan_v_tpu_torch.metrics.detectors.i3d',"
        " 'stylegan_v_tpu_torch.metrics.detectors.inception_v3',"
        " 'stylegan_v_tpu_torch.metrics.detectors.c3d',"
        " 'stylegan_v_tpu_torch.parallel', 'stylegan_v_tpu_torch.parallel.distributed',"
        " 'stylegan_v_tpu_torch.parallel.zero', 'stylegan_v_tpu_torch.parallel.sharded_eval',"
        " 'stylegan_v_tpu_torch.io.legacy', 'stylegan_v_tpu_torch.io.legacy_tf',"
        " 'stylegan_v_tpu_torch.generate', 'stylegan_v_tpu_torch.calc_metrics',"
        " 'stylegan_v_tpu_torch.calc_metrics_for_dataset',"
        " 'stylegan_v_tpu_torch.tools.ref_pickle'}\n"
        "assert new <= set(names) and len(names) >= 26, names\n"
        "assert not bad, bad\n"
        "lazy = [m for m in ('yaml', 'PIL', 'cv2', 'tensorboardX') if m in sys.modules]\n"
        "assert not lazy, lazy\n"
        "print('ok', len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
