"""Assemble several frame-folder videos into one grid mp4
(reference src/scripts/frames_to_video_grid.py).

    python -m stylegan_v_tpu_torch.frames_to_video_grid -s /data/frames -o grid.mp4 \\
        --num_videos 9 --fps 25

The counterpart of scripts/frames_to_video_grid.py (the JAX package's): the
first --num_videos sub-directories of --source_dir in name order, each a
video of frames in name order, cut to --num_frames (default: the first
video's frame count), tiled into one grid a frame by the port's
training/video_io.py. It runs on the host only, so it has no --device.
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np


def main(argv: Optional[List[str]] = None) -> np.ndarray:
    """The CLI; returns the grid's frames [T, H, W, C] in [0, 1]."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-s", "--source_dir", required=True)
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--num_videos", type=int, default=9)
    ap.add_argument("--num_frames", type=int, default=None)
    ap.add_argument("--fps", type=float, default=25.0)
    args = ap.parse_args(argv)

    import PIL.Image

    from .training.video_io import save_video_frames_as_mp4, videos_as_grids

    vdirs = sorted(d for d in os.listdir(args.source_dir)
                   if os.path.isdir(os.path.join(args.source_dir, d)))[:args.num_videos]
    videos = []
    n_frames = args.num_frames
    for d in vdirs:
        frames = sorted(os.listdir(os.path.join(args.source_dir, d)))
        if n_frames is None:
            n_frames = len(frames)
        videos.append(np.stack([np.array(PIL.Image.open(os.path.join(args.source_dir, d, f)))
                                for f in frames[:n_frames]]))
    grid = videos_as_grids(np.stack(videos).astype(np.float32) / 255.0)
    save_video_frames_as_mp4(grid, args.fps, args.output)
    print(f"Wrote {args.output}")
    return grid


if __name__ == "__main__":
    main()
