#!/usr/bin/env python
"""Convert a JAX package snapshot (Orbax) into the PyTorch port's snapshot.

    python scripts/convert_jax_snapshot_to_torch.py \\
        runs/exp/network-snapshot-000100 runs/exp_torch

reads <snapshot> (the Orbax directory) and <snapshot>.meta.json with
stylegan_v_tpu/io/checkpoint.py:load_snapshot, converts the whole training
state with stylegan_v_tpu_torch/io/bridge.py (G, D, G_ema, w_avg, both
Adams' moments, pl_mean, augment_p, ada_sign_acc, step, cur_nimg), and
writes network-snapshot-<kimg>.pt and its .meta.json into <out_dir>, where
the port's loop resumes it (training.resume=latest, or the .pt path). The
meta names the ADA warp executor the JAX run ran (`jax_warp_mode`), which
the port's loop keeps on resume where its warp_mode is "auto".

It lives outside the port because Orbax imports jax. Adam's learning rate
and betas are not in an Orbax snapshot (optax keeps them in the optimizer's
definition); the port's loop takes them from the run's config on resume.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def jax_warp_mode(resolution: int) -> str:
    """The executor the JAX package's warp_mode="auto", which its train_setup
    leaves in place, runs on an accelerator at this image size
    (stylegan_v_tpu/training/augment.py:_warp_antialiased): "shear" on the
    sizes validated on the TPU, "gather" elsewhere."""
    from stylegan_v_tpu.training.augment import SHEAR_TPU_VALIDATED_RES
    return "shear" if resolution in SHEAR_TPU_VALIDATED_RES else "gather"


def convert(snapshot: str, out_dir: str) -> str:
    """Convert one Orbax snapshot; returns the written .pt path."""
    import jax
    import numpy as np

    from stylegan_v_tpu.io import checkpoint as jckpt
    from stylegan_v_tpu.models import Discriminator as JDiscriminator
    from stylegan_v_tpu.models import Generator as JGenerator
    from stylegan_v_tpu.models import config as jconfig
    from stylegan_v_tpu.training import train_step as jts
    from stylegan_v_tpu_torch.io import checkpoint as tckpt
    from stylegan_v_tpu_torch.io.bridge import jax_to_torch_train_state
    from stylegan_v_tpu_torch.models import Discriminator, Generator
    from stylegan_v_tpu_torch.training import train_step as tts

    snapshot = os.path.abspath(snapshot.rstrip("/"))
    with open(snapshot + ".meta.json") as f:
        meta = json.load(f)
    registry = {cls.__name__: cls for cls in (
        jconfig.GeneratorConfig, jconfig.DiscriminatorConfig, jconfig.MotionConfig,
        jconfig.TimeEncConfig, jconfig.SamplingConfig)}
    jcfg = jckpt.meta_decode(meta["configs"], registry)
    # the restore target: the state's structure, shapes and dtypes, traced
    # without computing an initialization
    shapes = jax.eval_shape(lambda: jts.init_train_state(
        jax.random.PRNGKey(0), JGenerator(jcfg["G"]), JDiscriminator(jcfg["D"]),
        jts.OptimizerConfig(), jts.OptimizerConfig(), jts.TrainingConfig()))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    jstate, meta = jckpt.load_snapshot(snapshot, target=template)

    tcfg = tckpt.meta_decode(meta["configs"])
    G, D = Generator(tcfg["G"]), Discriminator(tcfg["D"])
    pieces = jax_to_torch_train_state(jstate, G, D)
    G.load_state_dict(pieces["params_G"])
    D.load_state_dict(pieces["params_D"])
    state = tts.init_train_state(G, D, tts.OptimizerConfig(), tts.OptimizerConfig(),
                                 tts.TrainingConfig(), augment_p=pieces["augment_p"])
    state.G_ema.load_state_dict(pieces["params_Gema"])
    tckpt.load_adam_state(state.opt_G, pieces["opt_G"])
    tckpt.load_adam_state(state.opt_D, pieces["opt_D"])
    state.pl_mean.fill_(pieces["pl_mean"])
    state.ada_sign_acc.fill_(pieces["ada_sign_acc"])
    state.step, state.cur_nimg = pieces["step"], pieces["cur_nimg"]
    cur_nimg = int(meta.get("cur_nimg", state.cur_nimg))
    return tckpt.save_snapshot(out_dir, state, cur_nimg, configs={"G": tcfg["G"], "D": tcfg["D"]},
                               extra_meta={"warp_mode": jax_warp_mode(tcfg["G"].img_resolution)})


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("snapshot", help="the JAX package's network-snapshot-<kimg> directory")
    ap.add_argument("out_dir", help="the port's run directory to write into")
    args = ap.parse_args()
    print(convert(args.snapshot, args.out_dir))


if __name__ == "__main__":
    main()
