"""CLIP-guided latent editing (reference src/scripts/clip_edit.py).

    python -m stylegan_v_tpu_torch.clip_edit --network x.pkl --text "a smiling face" \\
        --clip-path clip-vit-base-patch32/ -o out/ [--arcface-path ir_se50.pt] [--device cpu]

The counterpart of scripts/clip_edit.py (the JAX package's), with its flags
plus `--device` (default cuda; no card raises, `--device cpu` runs on the
CPU). Gradient-based, as the reference and StyleCLIP: the full w+ latent of
one video (z and motion_z drawn from --seed) is optimised with Adam under a
cosine-ramp lr schedule against

    loss = sum over frames of (1 - CLIP cosine similarity to the prompt)
         + l2_lambda * ||w - w_orig||^2
         + id_lambda * (1 - ArcFace identity cosine)        [--arcface-path]

(reference clip_edit.py:44-110,161-205); without --arcface-path the identity
term is the mean squared pixel distance to the unedited frames. CLIP comes
through `transformers` (CLIPModel.from_pretrained on a local --clip-path
checkout) and runs on G's device in the same autograd graph: frames are
area-resized to 224 and CLIP-normalised. ArcFace is a TorchScript ir_se50
export, fed the StyleCLIP crop (256-pool, [35:223, 32:220], 112-pool).
Writes edited.mp4 and edited_latents.npz (ws, ws_orig).
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .utils.latent_opt import get_lr, make_adam, set_lr

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def make_clip_embed(clip_path: str, device):
    """The CLIP image-embedding fn of a local transformers checkpoint on
    `device` ([N, C, H, W] in [-1, 1] -> [N, D], differentiable in its input)
    and text_embed(prompt) -> the normalised text embedding [D] there."""
    from transformers import CLIPModel, CLIPProcessor
    clip = CLIPModel.from_pretrained(clip_path).to(device).eval().requires_grad_(False)
    proc = CLIPProcessor.from_pretrained(clip_path)
    mean = torch.tensor(CLIP_MEAN, device=device).view(1, 3, 1, 1)
    std = torch.tensor(CLIP_STD, device=device).view(1, 3, 1, 1)

    # Each tower's pooled output through its projection, as transformers 4's
    # get_image_features and get_text_features return them (transformers 5
    # returns the towers' output objects from those methods instead).
    def image_embed(x: torch.Tensor) -> torch.Tensor:
        img = F.interpolate(x * 0.5 + 0.5, size=(224, 224), mode="area")
        pooled = clip.vision_model(pixel_values=(img - mean) / std).pooler_output
        return clip.visual_projection(pooled)

    def text_embed(text: str) -> torch.Tensor:
        tokens = proc(text=[text], return_tensors="pt", padding=True)
        with torch.no_grad():
            pooled = clip.text_model(**{k: v.to(device) for k, v in tokens.items()}).pooler_output
            emb = clip.text_projection(pooled)
        return F.normalize(emb, dim=-1)[0]
    return image_embed, text_embed


def make_arcface_embed(arcface_path: str, device) -> Callable[[torch.Tensor], torch.Tensor]:
    """The ArcFace identity-embedding fn of a TorchScript ir_se50 export on
    `device`, with the StyleCLIP face crop (reference clip_edit.py:89-95):
    [N, C, H, W] in [-1, 1] -> [N, D], differentiable in its input."""
    model = torch.jit.load(arcface_path, map_location=device).eval()
    for p in model.parameters():
        p.requires_grad_(False)

    def embed(x: torch.Tensor) -> torch.Tensor:
        if x.shape[2] != 256:
            x = F.adaptive_avg_pool2d(x, (256, 256))
        x = x[:, :, 35:223, 32:220]                  # the face region
        return model(F.adaptive_avg_pool2d(x, (112, 112)))
    return embed


def edit_loss(synth, ws: torch.Tensor, ws0: torch.Tensor, clip_embed, text_emb: torch.Tensor,
              base: torch.Tensor, base_id: Optional[torch.Tensor] = None, arc_embed=None,
              l2_weight: float = 0.008, id_weight: float = 0.005):
    """The objective of scripts/clip_edit.py:138-151 at ws: synth(ws) -> frames
    [F, C, H, W] in [-1, 1]; `base` the unedited frames, `base_id` their
    ArcFace embedding (with arc_embed). Returns (loss, (c_loss, l2_loss,
    i_loss))."""
    frames = synth(ws)
    emb = clip_embed(frames)
    emb = emb / emb.norm(dim=-1, keepdim=True)
    c_loss = torch.sum(1.0 - emb @ text_emb)           # reference: c_loss.sum()
    l2_loss = torch.sum(torch.square(ws - ws0))
    if arc_embed is not None:
        gid = arc_embed(frames)
        gid = gid / gid.norm(dim=-1, keepdim=True)
        bid = base_id / base_id.norm(dim=-1, keepdim=True)
        i_loss = torch.mean(1.0 - torch.sum(gid * bid, dim=-1))
    else:
        i_loss = torch.mean(torch.square(frames - base))
    return c_loss + l2_weight * l2_loss + id_weight * i_loss, (c_loss, l2_loss, i_loss)


def edit(G, clip_embed, text_emb: torch.Tensor, arc_embed=None, num_steps: int = 300,
         lr: float = 0.1, id_weight: float = 0.005, l2_weight: float = 0.008,
         num_frames: int = 8, draws=None, seed: int = 0,
         log: Callable[[str], None] = print) -> Dict:
    """Edit one video of G toward the text embedding `text_emb` (normalised,
    on G's device). z [1, z_dim] and motion_z [1, L, z_dim] come from `draws`
    (randn(shape) on that device; default a torch.Generator seeded from
    `seed`); ws_orig is z's first w tiled over the layers.

    Returns ws, ws_orig, the edited frames [F, C, H, W] in [-1, 1], each step's
    (loss, clip, l2, id) (`history`) and the loop's host seconds, which end
    on a synchronising read of the history."""
    from .models.motion import MotionMappingNetwork
    from .training.augment import GeneratorDraws

    device = text_emb.device
    cfg = G.cfg
    if draws is None:
        draws = GeneratorDraws(torch.Generator(device=device).manual_seed(seed))
    G.train()   # only cuDNN's LSTM backward reads the mode: no layer of G acts on it
    z = draws.randn((1, cfg.z_dim))
    t = torch.arange(num_frames, dtype=torch.float32, device=device)[None]
    L = MotionMappingNetwork.required_traj_len(cfg, float(num_frames))
    mz = draws.randn((1, L, cfg.motion.z_dim))

    def synth(ws):
        return G.synthesis(ws, t=t, motion_z=mz, noise_mode="none")

    with torch.no_grad():
        ws0 = G.mapping(z, None)[:, :1].repeat(1, G.num_ws, 1)
        base = synth(ws0)
        base_id = arc_embed(base) if arc_embed is not None else None

    ws = ws0.clone().requires_grad_(True)
    opt = make_adam([ws])
    history = []
    t0 = time.perf_counter()
    for step in range(num_steps):
        step_lr = get_lr(step / num_steps, lr)
        set_lr(opt, step_lr)
        loss, (c_l, l2_l, i_l) = edit_loss(synth, ws, ws0, clip_embed, text_emb, base,
                                           base_id, arc_embed, l2_weight, id_weight)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        history.append(torch.stack([loss, c_l, l2_l, i_l]).detach())
        if step % 25 == 0 or step == num_steps - 1:
            row = history[-1].tolist()
            log(f"step {step:4d}  loss {row[0]:.4f}  clip {row[1]:.4f}  "
                f"l2 {row[2]:.4f}  id {row[3]:.4f}  lr {step_lr:.4f}")
    history = torch.stack(history).tolist() if history else []
    seconds = time.perf_counter() - t0
    with torch.no_grad():
        frames = synth(ws)
    return dict(ws=ws.detach(), ws_orig=ws0, frames=frames, history=history, seconds=seconds)


def main(argv: Optional[List[str]] = None) -> Dict:
    """The CLI; returns `edit`'s result."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--network", required=True, help="a snapshot (.pt) or a reference .pkl")
    ap.add_argument("--text", required=True, help="edit prompt, e.g. 'a smiling face'")
    ap.add_argument("--clip-path", required=True,
                    help="local dir with a transformers CLIP checkpoint")
    ap.add_argument("--arcface-path", default=None,
                    help="TorchScript ir_se50 ArcFace for the identity loss; "
                         "omit to fall back to a pixel-space identity term")
    ap.add_argument("--output-dir", "-o", required=True)
    ap.add_argument("--num-steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--id-weight", type=float, default=0.005)
    ap.add_argument("--l2-weight", type=float, default=0.008)
    ap.add_argument("--num-frames", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (the default), cuda:N or cpu")
    args = ap.parse_args(argv)

    from .generate import load_any_checkpoint
    from .training.loop import resolve_device
    from .training.video_io import save_video_frames_as_mp4
    from .utils.misc import float32_precision

    device = resolve_device(args.device)
    clip_embed, text_embed = make_clip_embed(args.clip_path, device)
    text_emb = text_embed(args.text)
    arc_embed = make_arcface_embed(args.arcface_path, device) if args.arcface_path else None
    G = load_any_checkpoint(args.network, device)
    with float32_precision(False):          # float32 convolutions and matmuls, as in JAX
        result = edit(G, clip_embed, text_emb, arc_embed, num_steps=args.num_steps,
                      lr=args.lr, id_weight=args.id_weight, l2_weight=args.l2_weight,
                      num_frames=args.num_frames, seed=args.seed)

    os.makedirs(args.output_dir, exist_ok=True)
    final = (result["frames"] * 0.5 + 0.5).clamp(0, 1).permute(0, 2, 3, 1).cpu().numpy()
    save_video_frames_as_mp4(final, 25.0, os.path.join(args.output_dir, "edited.mp4"))
    np.savez(os.path.join(args.output_dir, "edited_latents.npz"),
             ws=result["ws"].cpu().numpy(), ws_orig=result["ws_orig"].cpu().numpy())
    print(f"Wrote edited.mp4 + edited_latents.npz to {args.output_dir}")
    return result


if __name__ == "__main__":
    main()
