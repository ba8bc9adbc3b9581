"""Headless launcher: progressive render of the demo scene to a PNG.

Counterpart of ``tpu_rt/app/run.py:run_headless`` as a plain loop over
``RayTracer.render_device`` -> ``accumulate`` -> ``display_stack``; the
threaded interaction runtime and the GUI are not ported yet. ``--obj``
loads a Wavefront OBJ mesh beside the demo scene; ``--aperture`` and
``--focus-dist`` give the camera a thin lens.

    python -m tpu_rt_torch.app.run --headless --samples 32 --output x.png
    python -m tpu_rt_torch.app.run --headless --obj model.obj --obj-scale 2
    python -m tpu_rt_torch.app.run --headless --aperture 0.1 --focus-dist 3
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..api.compat import Material, RayTracer, Scene, Sphere, Vector3
from ..core.types import DEMO_BACKGROUND, DEMO_ROWS, DEMO_SPHERE_NAMES
from ..render.display import ENHANCED, display_stack
from ..render.frame import accumulate
from ..utils.objio import load_obj

EXPOSURE = 1.5  # the reference GUI's default


def demo_api_scene() -> Scene:
    """The 9-sphere demo scene as an api ``Scene`` (object ids 0..8)."""
    scene = Scene()
    scene.background_color = Vector3(*DEMO_BACKGROUND)
    for i, (row, name) in enumerate(zip(DEMO_ROWS, DEMO_SPHERE_NAMES)):
        center, radius, albedo, metallic, roughness, emission = row
        s = Sphere()
        s.center = Vector3(*center)
        s.radius = radius
        m = Material()
        m.albedo = Vector3(*albedo)
        m.metallic = metallic
        m.roughness = roughness
        m.emission = Vector3(*emission)
        s.material = m
        s.object_id = i
        s.name = name
        scene.add_sphere(s)
    return scene


def render_progressive(rt: RayTracer, width: int, height: int,
                       samples: int, batch: int, depth: int,
                       on_batch=None):
    """Render ``samples`` spp in batches; returns the uint8 (2, H, W, 3)
    display stack of the final accumulator."""
    acc, total, stack = None, 0, None
    while total < samples:
        n = min(batch, samples - total)
        img = rt.render_device(width, height, n, depth)
        acc, total = accumulate(acc, total, img, n)
        stack = display_stack(acc, EXPOSURE, as_uint8=True)
        if on_batch is not None:
            on_batch(total)
    return stack


def run_headless(args) -> int:
    rt = RayTracer(device=args.device)
    rt.set_scene(demo_api_scene())
    if args.obj:
        mesh = load_obj(args.obj, scale=args.obj_scale, device=rt.device)
        rt.set_mesh(mesh)
        print(f"  loaded {int(mesh.valid.sum())} triangles from {args.obj}")
    if args.aperture > 0.0:
        cam = rt.get_camera()
        cam.aperture = args.aperture
        cam.focus_dist = args.focus_dist
        rt.set_camera(cam)
    t0 = time.perf_counter()
    stack = render_progressive(
        rt, args.width, args.height, args.samples, args.batch, args.depth,
        on_batch=lambda total: print(f"  {total}/{args.samples} spp"))
    image = stack[ENHANCED].cpu().numpy()
    dt = time.perf_counter() - t0
    out = args.output
    try:
        from PIL import Image

        Image.fromarray(image).save(out)
    except ImportError:
        out += ".npy"
        np.save(out, image)
    print(f"wrote {out} ({dt:.2f} s on {rt.device})")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="tpu_rt_torch headless progressive path tracer")
    parser.add_argument("--headless", action="store_true",
                        help="render without a GUI and write a PNG")
    parser.add_argument("--width", type=int, default=640)
    parser.add_argument("--height", type=int, default=480)
    parser.add_argument("--samples", type=int, default=32)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--depth", type=int, default=4)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--output", default="render.png")
    parser.add_argument("--obj", default=None, metavar="PATH",
                        help="load a Wavefront OBJ mesh into the scene")
    parser.add_argument("--obj-scale", type=float, default=1.0)
    parser.add_argument("--aperture", type=float, default=0.0,
                        help="thin-lens radius for depth of field (0 = off)")
    parser.add_argument("--focus-dist", type=float, default=0.0,
                        help="focal-plane distance (0 = look-at target)")
    args = parser.parse_args(argv)
    if not args.headless:
        print("the GUI is not ported to tpu_rt_torch yet (ROADMAP.md: "
              "Queue 1, app); run with --headless")
        return 2
    return run_headless(args)


if __name__ == "__main__":
    sys.exit(main())
