"""Offline dataset preparation: resize raw frames to the network resolution
(port of ``cilrs_tpu/data/prepare.py``).

Capability parity with the reference's prepare_dataset.py (a cv2 resize of
every 800x600 JPEG to 200x88 at quality 95, per session folder, copying
measurements.csv and summary.txt, with a size report). The collectors render
at network resolution already, so this serves external or high-resolution
sessions; the resize runs batched on the device.

    python -m cilrs_tpu_torch.data.prepare IN_DIR OUT_DIR [--height 88 --width 200] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np
import torch

from cilrs_tpu_torch.cli.common import require_cuda
from cilrs_tpu_torch.ops.image import TARGET_H, TARGET_W, resize_frame


def _to_u8(resized01: torch.Tensor) -> np.ndarray:
    """[0, 1] floats -> uint8 on the host, truncated as numpy's astype does."""
    return (resized01 * 255.0).cpu().numpy().astype(np.uint8)


def process_session(input_dir: str, output_dir: str, height: int = TARGET_H, width: int = TARGET_W,
                    batch: int = 256, verbose: bool = True, device="cuda") -> dict:
    """Resize every frame of a session directory into ``output_dir``:
    ``.npz`` shards (``frames`` [N, H, W, 3] u8) in batches of ``batch``,
    JPEG and PNG files one by one; measurements.csv and summary.txt copied.
    Returns {frames_in, frames_out, size_mb}."""
    dev = require_cuda(device)
    os.makedirs(output_dir, exist_ok=True)
    n_in = n_out = 0
    for name in sorted(os.listdir(input_dir)):
        path = os.path.join(input_dir, name)
        if name.endswith(".npz"):
            frames = np.load(path)["frames"]
            n_in += len(frames)
            out = [_to_u8(resize_frame(torch.from_numpy(frames[i:i + batch]).to(dev).float() / 255.0,
                                       height, width))
                   for i in range(0, len(frames), batch)]
            resized = np.concatenate(out)
            np.savez_compressed(os.path.join(output_dir, name), frames=resized)
            n_out += len(resized)
        elif name.endswith((".jpg", ".jpeg", ".png")):
            from PIL import Image

            img = np.array(Image.open(path))
            n_in += 1
            small = resize_frame(torch.from_numpy(img).to(dev).float() / 255.0, height, width)
            Image.fromarray(_to_u8(small)).save(os.path.join(output_dir, name), quality=95)
            n_out += 1
        elif name in ("measurements.csv", "summary.txt"):
            shutil.copy(path, os.path.join(output_dir, name))
    report = {"frames_in": n_in, "frames_out": n_out, "size_mb": _dir_size_mb(output_dir)}
    if verbose:
        print(f"  prepared {n_out} frames -> {output_dir} ({report['size_mb']:.1f} MB)")
    return report


def _dir_size_mb(d: str) -> float:
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)) / 1e6


def main(argv=None):
    p = argparse.ArgumentParser(description="Resize a session's frames to the network resolution")
    p.add_argument("input_dir")
    p.add_argument("output_dir")
    p.add_argument("--height", type=int, default=TARGET_H)
    p.add_argument("--width", type=int, default=TARGET_W)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    return process_session(args.input_dir, args.output_dir, args.height, args.width,
                           device=args.device)


if __name__ == "__main__":
    main()
