"""The plain reference: a frozen copy of the benchmarked package's plain
models, augment pipe, loss and step, in plain PyTorch. It imports nothing of
that package; `build_models` makes its G and D from the resolved
configuration's plain values."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple, get_type_hints

from . import config as _config


def _from_dict(cls, values: Dict[str, Any]):
    hints = get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in values:
            continue
        v = values[f.name]
        if dataclasses.is_dataclass(hints[f.name]) and isinstance(v, dict):
            v = _from_dict(hints[f.name], v)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def generator_config(values: Dict[str, Any]) -> _config.GeneratorConfig:
    return _from_dict(_config.GeneratorConfig, values)


def discriminator_config(values: Dict[str, Any]) -> _config.DiscriminatorConfig:
    return _from_dict(_config.DiscriminatorConfig, values)


def build_models(setup: Dict[str, Any], device) -> Tuple[Any, Any]:
    """The reference's G and D for a resolved setup (plain dicts: gen_cfg,
    disc_cfg, disc_source, video_discr_lr_multiplier,
    video_discr_num_t_paddings), uninitialised, on `device`."""
    from .discriminator import Discriminator
    from .generator import Generator
    from .mocogan import MoCoGANDiscriminator
    G = Generator(generator_config(setup["gen_cfg"]))
    dcfg = discriminator_config(setup["disc_cfg"])
    if setup["disc_source"] == "mocogan":
        D = MoCoGANDiscriminator(dcfg, setup["video_discr_lr_multiplier"],
                                 setup["video_discr_num_t_paddings"])
    else:
        D = Discriminator(dcfg)
    return G.to(device), D.to(device)
