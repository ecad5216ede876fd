"""Frames -> video: ``python -m gs_deformable_tpu_torch.video <frame_dir> <out>``.

The port's own copy of ``gs_deformable_tpu/video.py``.  Writes the PNG or
JPEG frames of a directory, in name order, through imageio when it is
installed and has a codec for the file; otherwise, or for a ``.gif``
target, an animated GIF through Pillow (the path then ends in ``.gif``).
"""

from __future__ import annotations

import argparse
import os
from typing import List


def _frame_files(frame_dir: str) -> List[str]:
    files = sorted(f for f in os.listdir(frame_dir) if f.endswith((".png", ".jpg")))
    if not files:
        raise FileNotFoundError(f"no frames in {frame_dir}")
    return [os.path.join(frame_dir, f) for f in files]


def _write_gif(paths: List[str], out_path: str, fps: int) -> str:
    from PIL import Image

    frames = [Image.open(p).convert("RGB") for p in paths]
    frames[0].save(out_path, save_all=True, append_images=frames[1:],
                   duration=max(int(1000 / fps), 1), loop=0)
    return out_path


def frames_to_video(frame_dir: str, out_path: str, fps: int = 30) -> str:
    """The frames of ``frame_dir`` as a video at ``fps``; returns the path written."""
    paths = _frame_files(frame_dir)
    if out_path.endswith(".gif"):
        return _write_gif(paths, out_path, fps)
    try:
        import imageio.v2 as imageio

        writer = imageio.get_writer(out_path, fps=fps)
        try:
            for p in paths:
                writer.append_data(imageio.imread(p))
        finally:
            writer.close()
        return out_path
    except Exception as e:
        gif_path = os.path.splitext(out_path)[0] + ".gif"
        print(f"[video] no video codec available ({type(e).__name__}); "
              f"writing {gif_path} instead")
        return _write_gif(paths, gif_path, fps)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("frame_dir")
    p.add_argument("out_path")
    p.add_argument("--fps", type=int, default=30)
    a = p.parse_args(argv)
    print(frames_to_video(a.frame_dir, a.out_path, a.fps))


if __name__ == "__main__":
    main()
