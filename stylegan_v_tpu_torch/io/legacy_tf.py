"""TF-era (TensorFlow StyleGAN2) pickles.

The port's counterpart of stylegan_v_tpu/io/legacy_tf.py (reference
src/legacy.py:109-286). Legacy TensorFlow pickles are a 3-tuple ``(G, D,
Gs)`` of ``dnnlib.tflib.network.Network`` objects whose pickled state carries
``{version, name, static_kwargs, components, variables}``; io/legacy.py's
SafeRefUnpickler maps that class to `TFNetworkStub`. The TF variable dict
(collected over ``components``) is renamed into the reference's TORCH
state_dict names with the TF->torch layout fixups applied to the values
(reference legacy.py:171-202 for G, 227-283 for D): spatial flip for the
up-sampling convs of G, ``transpose`` to OIHW / [out, in], ``mod_bias + 1``
for the style affines, and the per-resolution noise-buffer indexing. Those
are the port's names already, so the JAX package's second stage (the
lowering to flax trees) has no counterpart here.

Every function is a copy of the JAX package's (which cannot be imported
without jax and orbax); tests/test_torch_legacy.py holds each equal to its
original. Progressive-era pickles (``ToRGB_lod*`` / ``FromRGB_lod*``
variables, the 'orig' architecture) are rejected.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import numpy as np


class TFNetworkStub:
    """Inert stand-in for ``dnnlib.tflib.network.Network`` (TF era).

    tflib pickles the network state as a plain dict (version>=2 protocol);
    default unpickling lands it in ``__dict__``, exposing ``version``,
    ``static_kwargs``, ``components`` and ``variables`` as attributes.
    """

    version: int = 0

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:  # pragma: no cover - malformed pickle
            self.__dict__["state"] = state

    def __repr__(self):
        return f"TFNetworkStub({self.__dict__.get('name')})"


def collect_tf_params(tf_net: TFNetworkStub) -> Dict[str, np.ndarray]:
    """Flatten ``variables`` over the component tree (reference
    legacy.py:75-84): component names prefix their variables with '/'."""
    out: Dict[str, np.ndarray] = {}

    def recurse(prefix: str, net) -> None:
        for name, value in getattr(net, "variables", []) or []:
            out[prefix + name] = np.asarray(value)
        comps = getattr(net, "components", None) or {}
        for name, comp in dict(comps).items():
            recurse(prefix + name + "/", comp)

    recurse("", tf_net)
    return out


def _check_version(tf_net: TFNetworkStub) -> None:
    version = int(getattr(tf_net, "version", 0))
    if version < 4:
        raise ValueError(
            f"TensorFlow pickle version too low ({version} < 4); "
            "pre-StyleGAN2 pickles are not convertible "
            "(reference legacy.py:110-111)")


def _take_kwargs(static_kwargs: Dict[str, Any], spec: Dict[str, Any],
                 ignored: Tuple[str, ...]) -> Dict[str, Any]:
    """Extract kwargs by TF name with defaults; reject unknowns the same way
    the reference does (legacy.py:148-155)."""
    known = set(spec) | set(ignored)
    unknown = sorted(set(static_kwargs) - known)
    if unknown:
        raise ValueError(f"Unknown TensorFlow kwarg: {unknown[0]!r}")
    out = {}
    for tf_name, default in spec.items():
        val = static_kwargs.get(tf_name, default)
        out[tf_name] = default if val is None else val
    return out


def generator_kwargs_from_tf(static_kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """TF static_kwargs -> our GeneratorConfig field values (reference
    legacy.py:114-146; channel_base doubles fmap_base)."""
    kw = _take_kwargs(
        dict(static_kwargs),
        spec={
            "latent_size": 512, "label_size": 0, "dlatent_size": 512,
            "resolution": 1024, "num_channels": 3, "mapping_layers": 8,
            "label_fmaps": None, "mapping_fmaps": None,
            "mapping_nonlinearity": "lrelu", "mapping_lrmul": 0.01,
            "w_avg_beta": 0.995, "fmap_base": 16384, "fmap_max": 512,
            "num_fp16_res": 0, "conv_clamp": None, "architecture": "skip",
            "resample_kernel": [1, 3, 3, 1], "use_noise": True,
            "nonlinearity": "lrelu",
        },
        ignored=("truncation_psi", "truncation_cutoff", "style_mixing_prob",
                 "structure", "randomize_noise", "fused_modconv"))
    if kw["architecture"] != "skip":
        raise NotImplementedError(
            f"TF generator architecture {kw['architecture']!r} not supported "
            "(only 'skip', the StyleGAN2 default)")
    return dict(
        z_dim=int(kw["latent_size"]), c_dim=int(kw["label_size"]),
        w_dim=int(kw["dlatent_size"]), img_resolution=int(kw["resolution"]),
        img_channels=int(kw["num_channels"]),
        mapping_layers=int(kw["mapping_layers"]),
        channel_base=int(kw["fmap_base"]) * 2,
        channel_max=int(kw["fmap_max"]),
        num_bf16_res=int(kw["num_fp16_res"]),
        conv_clamp=kw["conv_clamp"], use_noise=bool(kw["use_noise"]))


def discriminator_kwargs_from_tf(static_kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """TF static_kwargs -> our DiscriminatorConfig field values (reference
    legacy.py:227-257)."""
    kw = _take_kwargs(
        dict(static_kwargs),
        spec={
            "label_size": 0, "resolution": 1024, "num_channels": 3,
            "architecture": "resnet", "fmap_base": 16384, "fmap_max": 512,
            "num_fp16_res": 0, "conv_clamp": None, "mapping_fmaps": None,
            "mapping_layers": 0, "mapping_lrmul": 0.1,
            "resample_kernel": [1, 3, 3, 1], "nonlinearity": "lrelu",
            "mbstd_group_size": None, "mbstd_num_features": 1,
            "freeze_layers": 0,
        },
        ignored=("structure",))
    if kw["architecture"] != "resnet":
        raise NotImplementedError(
            f"TF discriminator architecture {kw['architecture']!r} not "
            "supported (only 'resnet', the StyleGAN2 default)")
    return dict(
        c_dim=int(kw["label_size"]), img_resolution=int(kw["resolution"]),
        img_channels=int(kw["num_channels"]),
        channel_base=int(kw["fmap_base"]) * 2,
        channel_max=int(kw["fmap_max"]),
        num_bf16_res=int(kw["num_fp16_res"]), conv_clamp=kw["conv_clamp"],
        mbstd_num_channels=int(kw["mbstd_num_features"]))


def _noise_idx(r: int, conv: int) -> int:
    """Noise buffer index for resolution r (reference legacy.py:186,192):
    conv0 at r uses noise{2*log2(r)-5}, conv1 uses noise{2*log2(r)-4}."""
    return int(np.log2(r)) * 2 - (5 if conv == 0 else 4)


def tf_to_torch_generator_state(tf_params: Dict[str, np.ndarray]
                                ) -> Dict[str, np.ndarray]:
    """TF generator variables -> the reference's torch state_dict names and
    layouts (reference legacy.py:171-202)."""
    if any(re.fullmatch(r"(synthesis/)?ToRGB_lod\d+/.*", n) for n in tf_params):
        raise NotImplementedError(
            "progressive-era pickle (ToRGB_lod* variables imply the 'orig' "
            "architecture, reference legacy.py:160-166) — not supported")
    flat: Dict[str, np.ndarray] = {}
    noise = {name: arr for name, arr in tf_params.items()
             if re.fullmatch(r"synthesis/noise\d+", name)}

    def conv_w(arr, flip: bool) -> np.ndarray:
        if flip:
            arr = arr[::-1, ::-1]
        return np.ascontiguousarray(arr.transpose(3, 2, 0, 1))  # HWIO->OIHW

    for name, arr in tf_params.items():
        if name == "dlatent_avg":
            flat["mapping.w_avg"] = arr
            continue
        m = re.fullmatch(r"mapping/LabelEmbed/(weight|bias)", name)
        if m:
            flat[f"mapping.embed.{m.group(1)}"] = (
                arr.transpose() if m.group(1) == "weight" else arr)
            continue
        m = re.fullmatch(r"mapping/Dense(\d+)/(weight|bias)", name)
        if m:
            flat[f"mapping.fc{m.group(1)}.{m.group(2)}"] = (
                arr.transpose() if m.group(2) == "weight" else arr)
            continue
        m = re.fullmatch(r"synthesis/4x4/Const/const", name)
        if m:
            # [1, C, 4, 4]; convert_generator_state's input.const path strips
            # the leading axis itself
            flat["synthesis.b4.input.const"] = arr
            continue
        m = re.fullmatch(r"synthesis/(\d+)x\1/(Conv|Conv0_up|Conv1|ToRGB|Skip)"
                         r"/(weight|bias|noise_strength|mod_weight|mod_bias)",
                         name)
        if m:
            r, tf_layer, kind = int(m.group(1)), m.group(2), m.group(3)
            layer = {"Conv": "conv1", "Conv0_up": "conv0", "Conv1": "conv1",
                     "ToRGB": "torgb", "Skip": "skip"}[tf_layer]
            dst = f"synthesis.b{r}.{layer}"
            if kind == "weight":
                flat[f"{dst}.weight"] = conv_w(
                    arr, flip=tf_layer in ("Conv0_up", "Skip"))
            elif kind == "bias":
                flat[f"{dst}.bias"] = arr
            elif kind == "noise_strength":
                flat[f"{dst}.noise_strength"] = arr
                idx = _noise_idx(r, 0 if layer == "conv0" else 1)
                nbuf = noise.get(f"synthesis/noise{idx}")
                if nbuf is not None:
                    flat[f"{dst}.noise_const"] = nbuf[0, 0]
            elif kind == "mod_weight":
                flat[f"{dst}.affine.weight"] = arr.transpose()
            elif kind == "mod_bias":
                flat[f"{dst}.affine.bias"] = arr + 1
            continue
        # noise buffers handled via their conv's noise_strength; everything
        # else (lod counters, rnd state) is not a parameter
    return flat


def tf_to_torch_discriminator_state(tf_params: Dict[str, np.ndarray]
                                    ) -> Dict[str, np.ndarray]:
    """TF discriminator variables -> torch state_dict names/layouts
    (reference legacy.py:273-283). No spatial flips: D's strided
    down-convs keep TF tap order."""
    if any(re.fullmatch(r"FromRGB_lod\d+/.*", n) for n in tf_params):
        raise NotImplementedError(
            "progressive-era pickle (FromRGB_lod* variables imply the 'orig' "
            "architecture, reference legacy.py:256-262) — not supported")
    flat: Dict[str, np.ndarray] = {}

    def conv_w(arr):
        return np.ascontiguousarray(arr.transpose(3, 2, 0, 1))

    for name, arr in tf_params.items():
        m = re.fullmatch(r"LabelEmbed/(weight|bias)", name)
        if m:
            flat[f"mapping.embed.{m.group(1)}"] = (
                arr.transpose() if m.group(1) == "weight" else arr)
            continue
        m = re.fullmatch(r"Mapping(\d+)/(weight|bias)", name)
        if m:
            flat[f"mapping.fc{m.group(1)}.{m.group(2)}"] = (
                arr.transpose() if m.group(2) == "weight" else arr)
            continue
        m = re.fullmatch(r"4x4/Conv/(weight|bias)", name)
        if m:
            flat[f"b4.conv.{m.group(1)}"] = (
                conv_w(arr) if m.group(1) == "weight" else arr)
            continue
        m = re.fullmatch(r"4x4/Dense0/(weight|bias)", name)
        if m:
            flat[f"b4.fc.{m.group(1)}"] = (
                arr.transpose() if m.group(1) == "weight" else arr)
            continue
        m = re.fullmatch(r"Output/(weight|bias)", name)
        if m:
            flat[f"b4.out.{m.group(1)}"] = (
                arr.transpose() if m.group(1) == "weight" else arr)
            continue
        m = re.fullmatch(r"(\d+)x\1/FromRGB/(weight|bias)", name)
        if m:
            flat[f"b{m.group(1)}.fromrgb.{m.group(2)}"] = (
                conv_w(arr) if m.group(2) == "weight" else arr)
            continue
        m = re.fullmatch(r"(\d+)x\1/(Conv0|Conv1_down|Skip)/(weight|bias)",
                         name)
        if m:
            r, tf_layer, kind = m.group(1), m.group(2), m.group(3)
            layer = {"Conv0": "conv0", "Conv1_down": "conv1",
                     "Skip": "skip"}[tf_layer]
            flat[f"b{r}.{layer}.{kind}"] = (
                conv_w(arr) if kind == "weight" else arr)
            continue
    return flat


def is_tf_pickle(data: Any) -> bool:
    """Reference detection rule (legacy.py:25): a 3-tuple of TF networks."""
    return (isinstance(data, tuple) and len(data) == 3
            and all(isinstance(net, TFNetworkStub) for net in data))
