"""Writers of reference-format snapshot pickles, for tests and smoke runs.

    write_reference_pickle(path, G=G, D=D, G_ema=G_ema, cur_nimg=0)
    write_tf_pickle(path, np.random.RandomState(0), resolution=256, ...)

The reference's `network-snapshot-XXXXXX.pkl` pickles live modules through
torch_utils/persistence.py: each module reduces to
`torch_utils.persistence._reconstruct_persistent_obj(meta)`, where
meta['state'] is the module's __dict__ (`_parameters`, `_buffers`,
`_modules`, `_init_args`, `_init_kwargs`). `write_reference_pickle` writes
that structure from the port's modules: every module a persistent object,
its parameters, its buffers (the constants the port recomputes included, as
the reference stores them) and, for G, the init kwargs from which
io/legacy.py:infer_generator_config rebuilds the config. TF-era pickles are
a 3-tuple (G, D, Gs) of `dnnlib.tflib.network.Network` objects;
`write_tf_pickle` writes one with seeded random variables at any StyleGAN2
widths (skip G, resnet D).

The class paths the pickles name are registered in sys.modules while a
pickle is written and removed after. Nothing here is a user feature: no CLI
exposes it.
"""
from __future__ import annotations

import contextlib
import pickle
import sys
import types
from typing import Any, Dict, Optional

import numpy as np
import torch


def _reconstruct_persistent_obj(meta):          # stands in for the reference's by name
    raise RuntimeError("a writer's stand-in: load reference pickles with io/legacy.py")


class Network:                                   # stands in for dnnlib.tflib.network.Network
    pass


_reconstruct_persistent_obj.__module__ = "torch_utils.persistence"
Network.__module__, Network.__qualname__ = "dnnlib.tflib.network", "Network"
_STAND_INS = {"torch_utils.persistence": ("_reconstruct_persistent_obj",
                                          _reconstruct_persistent_obj),
              "dnnlib.tflib.network": ("Network", Network)}


@contextlib.contextmanager
def _reference_names():
    """The reference's module paths in sys.modules, holding the stand-ins, so
    that pickle records them under those names."""
    added, replaced = [], []
    try:
        for path, (name, obj) in _STAND_INS.items():
            parts = path.split(".")
            for i in range(1, len(parts) + 1):
                sub = ".".join(parts[:i])
                if sub not in sys.modules:
                    sys.modules[sub] = types.ModuleType(sub)
                    added.append(sub)
            replaced.append((sys.modules[path], name, getattr(sys.modules[path], name, None)))
            setattr(sys.modules[path], name, obj)
        yield
    finally:
        for module, name, old in replaced:
            if old is not None:
                setattr(module, name, old)
        for sub in added:
            sys.modules.pop(sub, None)


class _Persistent:
    """One persistent object: pickles as _reconstruct_persistent_obj(meta)."""

    def __init__(self, meta: Dict[str, Any]):
        self.meta = meta

    def __reduce__(self):
        return _reconstruct_persistent_obj, (self.meta,)


def _persistent(module: torch.nn.Module, init_kwargs: Optional[Dict] = None) -> _Persistent:
    params = {k: torch.nn.Parameter(v.detach().cpu().clone(), requires_grad=v.requires_grad)
              for k, v in module._parameters.items() if v is not None}
    buffers = {k: v.detach().cpu().clone() for k, v in module._buffers.items() if v is not None}
    f = getattr(module, "resample_filter", None)
    if isinstance(f, torch.Tensor):               # a buffer in the reference
        buffers["resample_filter"] = f.detach().cpu().clone()
    state = {"training": False, "_parameters": params, "_buffers": buffers,
             "_modules": {k: _persistent(m) for k, m in module._modules.items()
                          if m is not None},
             "_init_args": (), "_init_kwargs": dict(init_kwargs or {})}
    return _Persistent({"type": "class", "version": 6, "module_src": "",
                        "class_name": type(module).__name__, "state": state})


def generator_init_kwargs(cfg) -> Dict[str, Any]:
    """The reference Generator's init kwargs for a port GeneratorConfig; raises
    for a config that io/legacy.py:infer_generator_config cannot rebuild from
    them (a field the reference's kwargs do not carry, set off its default)."""
    from ..io.legacy import StubModule, infer_generator_config
    s = cfg.sampling
    kw = dict(
        c_dim=cfg.c_dim, w_dim=cfg.w_dim, img_resolution=cfg.img_resolution,
        img_channels=cfg.img_channels,
        cfg=dict(z_dim=cfg.z_dim, use_noise=cfg.use_noise, input=dict(type=cfg.input_type),
                 motion=dict(vars(cfg.motion)),
                 time_enc=dict(cond_type=cfg.time_enc.cond_type, dim=cfg.time_enc.dim,
                               min_period_len=cfg.time_enc.min_period_len,
                               max_period_len=cfg.time_enc.max_period_len),
                 sampling=dict(type=s.type, num_frames_per_video=s.num_frames_per_video,
                               max_num_frames=s.max_num_frames, fps=s.fps,
                               total_dists=None if s.total_dists is None
                               else list(s.total_dists), max_dist=s.max_dist)),
        mapping_kwargs=dict(num_layers=cfg.mapping_layers),
        synthesis_kwargs=dict(channel_base=cfg.channel_base, channel_max=cfg.channel_max,
                              num_fp16_res=cfg.num_bf16_res, conv_clamp=cfg.conv_clamp))
    back = infer_generator_config(StubModule({"state": {"_init_kwargs": kw}}))
    if back != cfg:
        raise ValueError(f"the reference's init kwargs cannot carry this config: {cfg} "
                         f"comes back as {back}")
    return kw


def write_reference_pickle(path: str, G=None, D=None, G_ema=None, cur_nimg: int = 0,
                           **extra) -> str:
    """A reference snapshot dict (G, D, G_ema, augment_pipe=None,
    training_set_kwargs=None, cur_nimg, `extra`) of the port's modules, G's
    and G_ema's with their init kwargs, written to `path`; returns `path`."""
    data: Dict[str, Any] = {"training_set_kwargs": None, "augment_pipe": None,
                            "cur_nimg": int(cur_nimg), **extra}
    for key, module in (("G", G), ("D", D), ("G_ema", G_ema)):
        if module is not None:
            data[key] = _persistent(module, None if key == "D"
                                    else generator_init_kwargs(module.cfg))
    with _reference_names(), open(path, "wb") as f:
        pickle.dump(data, f, protocol=pickle.HIGHEST_PROTOCOL)
    return path


# ------------------------------------------------------------ TF-era pickles

def _tf_net(name: str, static_kwargs: Dict, variables, components=None,
            version: int = 4) -> Network:
    n = Network()
    n.__dict__.update(dict(version=version, name=name, static_kwargs=dict(static_kwargs),
                           components=dict(components or {}), variables=list(variables)))
    return n


def _normal(rnd: np.random.RandomState, *shape) -> np.ndarray:
    return rnd.standard_normal(shape).astype(np.float32)


def tf_generator(rnd: np.random.RandomState, resolution: int, latent: int, fmap_base: int,
                 fmap_max: int, mapping_layers: int = 8, version: int = 4) -> Network:
    """A StyleGAN2 G_main Network (skip architecture) with random variables,
    in the tflib layout (tests/test_legacy_tf.py:make_tf_generator, at any
    widths): channels min(2 * fmap_base // r, fmap_max) at resolution r."""
    def ch(r):
        return min(2 * fmap_base // r, fmap_max)

    g_kwargs = dict(latent_size=latent, dlatent_size=latent, resolution=resolution,
                    num_channels=3, mapping_layers=mapping_layers, fmap_base=fmap_base,
                    fmap_max=fmap_max, nonlinearity="lrelu", resample_kernel=[1, 3, 3, 1],
                    use_noise=True, truncation_psi=0.5)
    mapping_vars = []
    for i in range(mapping_layers):
        mapping_vars += [(f"Dense{i}/weight", _normal(rnd, latent, latent)),
                         (f"Dense{i}/bias", _normal(rnd, latent))]
    syn_vars = [("4x4/Const/const", _normal(rnd, 1, ch(4), 4, 4)),
                ("noise0", _normal(rnd, 1, 1, 4, 4))]

    def conv(prefix, kin, kout, k=3, noise=False):
        v = [(f"{prefix}/weight", _normal(rnd, k, k, kin, kout)),
             (f"{prefix}/bias", _normal(rnd, kout)),
             (f"{prefix}/mod_weight", _normal(rnd, latent, kin)),
             (f"{prefix}/mod_bias", _normal(rnd, kin))]
        if noise:
            v += [(f"{prefix}/noise_strength", np.asarray(rnd.standard_normal(), np.float32))]
        return v

    syn_vars += conv("4x4/Conv", ch(4), ch(4), noise=True)
    syn_vars += conv("4x4/ToRGB", ch(4), 3, k=1)
    r = 8
    while r <= resolution:
        lg = int(np.log2(r))
        syn_vars += conv(f"{r}x{r}/Conv0_up", ch(r // 2), ch(r), noise=True)
        syn_vars += [(f"noise{2 * lg - 5}", _normal(rnd, 1, 1, r, r))]
        syn_vars += conv(f"{r}x{r}/Conv1", ch(r), ch(r), noise=True)
        syn_vars += [(f"noise{2 * lg - 4}", _normal(rnd, 1, 1, r, r))]
        syn_vars += conv(f"{r}x{r}/ToRGB", ch(r), 3, k=1)
        r *= 2
    return _tf_net("G", g_kwargs, [("dlatent_avg", _normal(rnd, latent))],
                   components=dict(mapping=_tf_net("G_mapping", {}, mapping_vars),
                                   synthesis=_tf_net("G_synthesis", {}, syn_vars)),
                   version=version)


def tf_discriminator(rnd: np.random.RandomState, resolution: int, fmap_base: int,
                     fmap_max: int) -> Network:
    """A StyleGAN2 D_main Network (resnet) with random variables
    (tests/test_legacy_tf.py:make_tf_discriminator, at any widths)."""
    def ch(r):
        return min(2 * fmap_base // r, fmap_max)

    d_kwargs = dict(label_size=0, resolution=resolution, num_channels=3, fmap_base=fmap_base,
                    fmap_max=fmap_max, architecture="resnet", nonlinearity="lrelu",
                    mbstd_group_size=2, mbstd_num_features=1)
    R = resolution
    v = [(f"{R}x{R}/FromRGB/weight", _normal(rnd, 1, 1, 3, ch(R))),
         (f"{R}x{R}/FromRGB/bias", _normal(rnd, ch(R)))]
    r = R
    while r > 4:
        v += [(f"{r}x{r}/Conv0/weight", _normal(rnd, 3, 3, ch(r), ch(r))),
              (f"{r}x{r}/Conv0/bias", _normal(rnd, ch(r))),
              (f"{r}x{r}/Conv1_down/weight", _normal(rnd, 3, 3, ch(r), ch(r // 2))),
              (f"{r}x{r}/Conv1_down/bias", _normal(rnd, ch(r // 2))),
              (f"{r}x{r}/Skip/weight", _normal(rnd, 1, 1, ch(r), ch(r // 2)))]
        r //= 2
    v += [("4x4/Conv/weight", _normal(rnd, 3, 3, ch(4) + 1, ch(4))),
          ("4x4/Conv/bias", _normal(rnd, ch(4))),
          ("4x4/Dense0/weight", _normal(rnd, ch(4) * 16, ch(4))),
          ("4x4/Dense0/bias", _normal(rnd, ch(4))),
          ("Output/weight", _normal(rnd, ch(4), 1)),
          ("Output/bias", _normal(rnd, 1))]
    return _tf_net("D", d_kwargs, v)


def write_tf_pickle(path: str, rnd: np.random.RandomState, resolution: int, latent: int,
                    fmap_base: int, fmap_max: int, mapping_layers: int = 8) -> str:
    """A TF-era snapshot (G, D, Gs) with random variables, written to `path`;
    returns `path`."""
    nets = (tf_generator(rnd, resolution, latent, fmap_base, fmap_max, mapping_layers),
            tf_discriminator(rnd, resolution, fmap_base, fmap_max),
            tf_generator(rnd, resolution, latent, fmap_base, fmap_max, mapping_layers))
    with _reference_names(), open(path, "wb") as f:
        pickle.dump(nets, f, protocol=pickle.HIGHEST_PROTOCOL)
    return path
