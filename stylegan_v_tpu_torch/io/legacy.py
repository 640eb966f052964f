"""Importer for reference `network-snapshot-XXXXXX.pkl` checkpoints.

The port's counterpart of stylegan_v_tpu/io/legacy.py (reference
src/legacy.py:load_network_pkl). The reference pickles LIVE torch modules
whose classes carry their own source code (torch_utils/persistence.py:
35-130). That source is never executed: a restricted Unpickler rebuilds
every persistent object as an inert `StubModule` holding its pickled state,
torch (CPU) decodes the raw tensors, and the module tree is flattened into
a state_dict. TF-era pickles (a 3-tuple of tflib Networks) are recognised
and renamed by io/legacy_tf.py. As with the reference's `pickle.load`, a
`.pkl` must be trusted: the unpickler stubs the reference's classes but
resolves any other global the file names.

The port uses the reference's state_dict names and layouts (NCHW, OIHW,
[out, in], D's epilogue flattened C*H*W), so the flat state loads as it is,
once the keys of the constants the port recomputes (`resample_filter`,
`freqs`, `phase_scales`, `fourier_coefs`) are dropped: no layout conversion
as in the JAX package's `convert_*_state`.

`StubModule`, `_reconstruct_stub`, `_stub_type`, `_EasyDict`,
`SafeRefUnpickler`, `load_network_pkl`, `_to_np`, `flatten_module_state` and
`infer_generator_config` are copies of the JAX package's (which cannot be
imported without jax and orbax); tests/test_torch_legacy.py holds each equal
to its original.
"""
from __future__ import annotations

import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch

# constants the port computes at construction instead of storing them
RECOMPUTED = ("resample_filter", "freqs", "phase_scales", "fourier_coefs")


class StubModule:
    """Inert stand-in for a persistence-embedded torch module."""

    def __init__(self, meta: Optional[Dict[str, Any]] = None):
        meta = meta or {}
        self.class_name = meta.get("class_name")
        self.state = meta.get("state") or {}

    def __setstate__(self, state):
        # plain-pickled (non-persistence) reference objects land here
        self.state = state if isinstance(state, dict) else {"state": state}

    def __repr__(self):
        return f"StubModule({self.class_name})"


def _reconstruct_stub(meta):
    return StubModule(meta)


_stub_types: Dict[tuple, type] = {}


def _stub_type(module: str, name: str) -> type:
    """A real CLASS (NEWOBJ-compatible) standing in for a reference symbol."""
    key = (module, name)
    if key not in _stub_types:
        cls = type(name, (StubModule,), {"_stub_origin": f"{module}.{name}"})
        _stub_types[key] = cls
    return _stub_types[key]


class _EasyDict(dict):
    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k)

    def __setattr__(self, k, v):
        self[k] = v


class SafeRefUnpickler(pickle.Unpickler):
    """Decodes reference snapshots without executing embedded source.

    torch tensor reconstruction is delegated to the real torch module (CPU);
    reference-repo classes are replaced by stubs. It is not a sandbox: any
    other global a pickle names (`os.system`, `builtins.eval`) resolves as
    in `pickle.load`, the reference's own loader, so load only trusted files.
    """

    _STUBBED_CALLABLES = {
        ("torch_utils.persistence", "_reconstruct_persistent_obj"): _reconstruct_stub,
        ("src.torch_utils.persistence", "_reconstruct_persistent_obj"): _reconstruct_stub,
    }
    _EASYDICT_MODULES = {"dnnlib", "src.dnnlib", "dnnlib.util", "src.dnnlib.util"}

    def find_class(self, module: str, name: str):
        if (module, name) in self._STUBBED_CALLABLES:
            return self._STUBBED_CALLABLES[(module, name)]
        if module in self._EASYDICT_MODULES and name == "EasyDict":
            return _EasyDict
        if (module in ("dnnlib.tflib.network", "src.dnnlib.tflib.network")
                and name == "Network"):
            from .legacy_tf import TFNetworkStub   # TF-era pickle
            return TFNetworkStub
        if module.startswith(("torch.", "torch_utils.", "src.torch_utils.",
                              "collections", "numpy", "builtins")) or module == "torch":
            if module.startswith(("torch_utils", "src.torch_utils")):
                # any other reference-internal symbol -> inert stub type
                return _stub_type(module, name)
            return super().find_class(module, name)
        if module.startswith(("training.", "src.training.", "metrics.", "src.metrics.")):
            return _stub_type(module, name)
        return super().find_class(module, name)


def load_network_pkl(path: str) -> Dict[str, Any]:
    """Load a reference snapshot -> dict with StubModule values for
    G / D / G_ema / augment_pipe plus plain entries (reference legacy.py:20-28).
    Legacy TensorFlow pickles (a 3-tuple of tflib Networks) are normalized to
    the same dict shape with TFNetworkStub values (reference legacy.py:24-29)."""
    with open(path, "rb") as f:
        data = SafeRefUnpickler(f).load()
    from .legacy_tf import is_tf_pickle
    if is_tf_pickle(data):
        tf_G, tf_D, tf_Gs = data
        data = {"G": tf_G, "D": tf_D, "G_ema": tf_Gs,
                "training_set_kwargs": None, "augment_pipe": None}
    return data


def _to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, np.ndarray):
        return x
    return None


def flatten_module_state(obj, prefix: str = "") -> Dict[str, np.ndarray]:
    """Walk a module tree (the pickled nn.Module __dict__ structure:
    _parameters / _buffers / _modules) into a flat state_dict.

    Handles StubModule nodes (whose state carries the pickled __dict__) and
    plain torch modules (e.g. nn.Sequential wrappers whose CHILDREN may again
    be stubs — so torch's own state_dict() cannot be used)."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(obj, StubModule):
        state = obj.state
    elif isinstance(obj, dict):
        state = obj
    else:
        state = getattr(obj, "__dict__", None)   # plain torch module
    if not isinstance(state, dict):
        return out
    for coll in ("_parameters", "_buffers"):
        for name, val in (state.get(coll) or {}).items():
            arr = _to_np(val)
            if arr is not None:
                out[prefix + name] = arr
    for name, child in (state.get("_modules") or {}).items():
        if child is not None:
            out.update(flatten_module_state(child, prefix + name + "."))
    return out


def port_state(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A flat reference state_dict (flatten_module_state, or a TF pickle's
    renamed variables) as the port's: float32 CPU tensors without the
    recomputed constants, with the first block's input constant under the
    port's name `synthesis.b4.input.const` as [C, 4, 4]. The LSTM motion
    encoder's `rnn.*` keys are nn.LSTM's, in the port as in the reference."""
    out: Dict[str, torch.Tensor] = {}
    for name, arr in flat.items():
        parts = name.split(".")
        if parts[-1] in RECOMPUTED:
            continue
        if parts[0] == "synthesis" and len(parts) > 3 and parts[2] == "input" \
                and parts[-1] == "const":
            name = ".".join(parts[:3] + ["const"])     # GenInput: input.const or input.input.const
            if arr.ndim == 4:                          # [1, C, 4, 4]
                arr = arr[0]
        out[name] = torch.tensor(np.asarray(arr), dtype=torch.float32)
    return out


def load_port_state(module: torch.nn.Module, state: Dict[str, torch.Tensor],
                    require_all: bool = False) -> Dict[str, torch.Tensor]:
    """The name-matched partial copy of `state` into `module`'s state_dict
    (io/checkpoint.py:copy_params), loaded into `module`; returns what was
    loaded. A name in both with another shape raises, and so does a name
    only in the module with `require_all`; names only in `state` are left."""
    from .checkpoint import copy_params
    dst = module.state_dict()
    for name, d in dst.items():
        s = state.get(name)
        if s is not None and tuple(s.shape) != tuple(d.shape):
            raise ValueError(f"{name}: the checkpoint holds {tuple(s.shape)}, the module "
                             f"{tuple(d.shape)}")
    merged = copy_params(state, dst, require_all=require_all)
    module.load_state_dict(merged)
    return merged


def import_reference_snapshot(path: str, G: Optional[torch.nn.Module] = None,
                              D: Optional[torch.nn.Module] = None,
                              G_ema: Optional[torch.nn.Module] = None
                              ) -> Dict[str, Optional[Dict[str, torch.Tensor]]]:
    """Weights-only import of a reference network-snapshot pickle, torch-era
    or TF-era, for transfer learning (reference resume_pkl semantics,
    train.py:283-317 + training_loop.py:167-177: partial copy,
    require_all=False); the port's counterpart of the JAX package's
    import_reference_snapshot.

    Returns {'G', 'G_ema', 'D'} state_dicts of float32 CPU tensors, None for a
    network the pickle does not hold. A template module given for a network
    receives the name-matched partial copy (its parameters that the pickle
    lacks keep their values), and its entry is the module's state_dict after
    it; a shape that differs from the template's raises."""
    from .legacy_tf import (TFNetworkStub, _check_version, collect_tf_params,
                            tf_to_torch_discriminator_state, tf_to_torch_generator_state)

    data = load_network_pkl(path)
    templates = {"G": G, "G_ema": G_ema, "D": D}
    out: Dict[str, Optional[Dict[str, torch.Tensor]]] = {}
    for key in ("G", "G_ema", "D"):
        stub = data.get(key)
        if isinstance(stub, TFNetworkStub):
            _check_version(stub)
            rename = tf_to_torch_discriminator_state if key == "D" \
                else tf_to_torch_generator_state
            state = port_state(rename(collect_tf_params(stub)))
        elif isinstance(stub, StubModule):
            state = port_state(flatten_module_state(stub))
        else:
            out[key] = None
            continue
        if templates[key] is not None:
            state = load_port_state(templates[key], state)
        out[key] = state
    return out


def infer_generator_config(stub: StubModule):
    """Reconstruct a models.GeneratorConfig from the init-args capture that
    persistence embeds in every snapshot (reference persistence.py:103-116 —
    the part of source-embedding worth keeping)."""
    from ..models.config import (GeneratorConfig, MotionConfig,
                                 SamplingConfig, TimeEncConfig)

    kw = dict(stub.state.get("_init_kwargs") or {})
    cfg = dict(kw.get("cfg") or {})
    syn = dict(kw.get("synthesis_kwargs") or {})
    mapping_kwargs = dict(kw.get("mapping_kwargs") or {})
    motion = dict(cfg.get("motion") or {})
    time_enc = dict(cfg.get("time_enc") or {})
    samp = dict(cfg.get("sampling") or {})

    sampling = SamplingConfig(
        type=samp.get("type", "random"),
        num_frames_per_video=int(samp.get("num_frames_per_video", 3)),
        max_num_frames=int(samp.get("max_num_frames", 1024)),
        fps=float(samp.get("fps", 25)),
        total_dists=tuple(samp["total_dists"]) if samp.get("total_dists") else None,
        max_dist=samp.get("max_dist", 32))
    num_fp16_res = int(syn.get("num_fp16_res", 0))
    return GeneratorConfig(
        w_dim=int(kw.get("w_dim", 512)),
        z_dim=int(cfg.get("z_dim", kw.get("w_dim", 512))),
        c_dim=int(kw.get("c_dim", 0)),
        img_resolution=int(kw.get("img_resolution", 256)),
        img_channels=int(kw.get("img_channels", 3)),
        channel_base=int(syn.get("channel_base", 32768)),
        channel_max=int(syn.get("channel_max", 512)),
        num_bf16_res=num_fp16_res,
        conv_clamp=syn.get("conv_clamp"),
        use_noise=bool(cfg.get("use_noise", False)),
        input_type=(cfg.get("input") or {}).get("type", "temporal"),
        mapping_layers=int(mapping_kwargs.get("num_layers", 8)),
        motion=MotionConfig(
            z_dim=int(motion.get("z_dim", 512)),
            v_dim=int(motion.get("v_dim", 512)),
            motion_z_distance=int(motion.get("motion_z_distance", 16)),
            gen_strategy=motion.get("gen_strategy", "conv"),
            kernel_size=int(motion.get("kernel_size", 11)),
            use_fractional_t=bool(motion.get("use_fractional_t", True)),
            fourier=bool(motion.get("fourier", True))),
        time_enc=TimeEncConfig(
            cond_type=time_enc.get("cond_type", "concat_const"),
            dim=int(time_enc.get("dim", 256)),
            min_period_len=int(time_enc.get("min_period_len", 16)),
            max_period_len=int(time_enc.get("max_period_len", 1024))),
        sampling=sampling)
