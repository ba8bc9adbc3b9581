"""The port's nlmeans against the JAX package's on a rendered frame (CPU).

    JAX_PLATFORMS=cpu python tests/torch_nlmeans_gap.py

Renders the demo scene with the port's plain megakernel on the CPU (4
batches of 640x480/8spp/d4, each in bands of 32 rows), tone-maps the mean
at the app's exposure, and runs both nlmeans at their defaults (7, 21) on
it at 640x480 and at its 2x2 mean, 320x240 (the GUI's grid_scale=2 tile).
Both sum their integral images in f32, in their own cumsum orders, so the
corner sums (1e8 and more at 640x480) round apart; this prints the gap.
Not collected by pytest: it takes a few minutes.
"""

import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax.numpy as jnp  # noqa: E402
from tpu_rt.ops import post as jpost

import tpu_rt_torch
from tpu_rt_torch.app.run import EXPOSURE
from tpu_rt_torch.ops import post
from tpu_rt_torch.ops.megakernel import render_megakernel
from tpu_rt_torch.render.frame import tone_map

W, H, SPP, DEPTH, BAND = 640, 480, 8, 4, 32


def frame() -> torch.Tensor:
    scene = tpu_rt_torch.demo_scene(device="cpu")
    cam = tpu_rt_torch.make_camera(aspect=W / H, device="cpu")
    acc = torch.zeros((H, W, 3))
    for b in range(4):
        acc += torch.cat([render_megakernel(
            scene, cam, 100 + b, width=W, height=H, spp=SPP,
            max_depth=DEPTH, n_active=12, rows=BAND, row_offset=r)
            for r in range(0, H, BAND)])
    return tone_map(acc / 4, EXPOSURE)


def main():
    torch.set_num_threads(4)
    t0 = time.perf_counter()
    img = frame()
    print(f"frame rendered in {time.perf_counter() - t0:.1f} s")
    small = img.reshape(H // 2, 2, W // 2, 2, 3).mean(dim=(1, 3))
    for label, x in (("320x240", small), ("640x480", img)):
        t0 = time.perf_counter()
        ours = post.nlmeans(x).numpy()
        ref = np.asarray(jpost.nlmeans(jnp.asarray(x.numpy())))
        d = np.abs(ours - ref)
        # quantized as display_stack(as_uint8=True) does
        u8 = np.abs(np.round(ours * 255.0) - np.round(ref * 255.0))
        print(f"nlmeans {label}: max {d.max():.3g}, beyond 1e-5 "
              f"{(d > 1e-5).mean():.6f}; uint8 equal {(u8 == 0).mean():.6f},"
              f" max apart {u8.max():.0f} ({time.perf_counter() - t0:.1f} s)")


if __name__ == "__main__":
    main()
