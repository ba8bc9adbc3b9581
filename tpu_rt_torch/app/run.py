"""Launcher of the interactive path tracer (counterpart of
``tpu_rt/app/run.py``; there is no extension to compile, the CUDA kernels
build on first use).

Two modes:
  * GUI (default): start the PyQt5 window. Requires PyQt5.
  * --headless: run the interactive runtime (``RayTracerInteraction``)
    without a display: render the demo scene progressively and write the
    enhanced view of the last frame to a PNG.

Both render on ``--device`` (default ``cuda``; ``cpu`` runs each kernel's
plain version). ``--obj`` loads a Wavefront OBJ mesh beside the demo
scene; ``--aperture`` and ``--focus-dist`` give the camera a thin lens.

    python -m tpu_rt_torch.app.run
    python -m tpu_rt_torch.app.run --headless --samples 32 --output x.png
    python -m tpu_rt_torch.app.run --headless --obj model.obj --obj-scale 2
    python -m tpu_rt_torch.app.run --headless --aperture 0.1 --focus-dist 3
"""

from __future__ import annotations

import argparse
import platform
import shutil
import subprocess
import sys
import time

from ..api.compat import Scene
from ..utils.profiling import FrameStats
from .interaction import RayTracerInteraction, SceneManager

EXPOSURE = 1.5  # the reference GUI's default


def demo_api_scene() -> Scene:
    """The 9-sphere demo scene as an api ``Scene`` (object ids 0..8): the
    app's interactive scene."""
    return SceneManager.create_interactive_scene()


def check_environment() -> bool:
    """Import smoke test of the core API (the reference's
    check_cpp_extension, against the port's module)."""
    try:
        from ..api import (  # noqa: F401
            Camera, Material, RayTracer, Scene, Sphere, Vector3,
        )
        return True
    except Exception as e:  # pragma: no cover
        print(f"✗ tpu_rt_torch API import failed: {e}")
        return False


def card_report() -> str:
    """The card's name and power limit as nvidia-smi gives them, or what
    stands in their way."""
    import torch

    if not torch.cuda.is_available():
        return "no CUDA device"
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return f"{torch.cuda.get_device_name(0)} (no nvidia-smi)"
    out = subprocess.run([smi, "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True)
    return out.stdout.strip() or torch.cuda.get_device_name(0)


def print_platform_report():
    import torch

    print(f"Python {platform.python_version()} on {platform.platform()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"card: {card_report()}")


def run_headless(args) -> int:
    import numpy as np

    rti = RayTracerInteraction(args.width, args.height, device=args.device)
    rti.settings["max_samples"] = args.samples
    rti.settings["samples_per_batch"] = args.batch
    rti.settings["max_depth"] = args.depth
    if getattr(args, "obj", None):
        n = rti.load_mesh_from_obj(args.obj, scale=args.obj_scale)
        print(f"  loaded {n} triangles from {args.obj}")
    if getattr(args, "aperture", 0.0) > 0.0:
        rti.camera.aperture = args.aperture
        rti.camera.focus_dist = args.focus_dist
        rti.ray_tracer.set_camera(rti.camera)
    stats = FrameStats()
    rti.start_rendering()

    final = None
    deadline = time.time() + args.timeout
    while time.time() < deadline:
        frame = rti.get_frame()
        if frame is None:
            time.sleep(0.02)
            continue
        if frame.get("done"):
            break
        final = frame
        if frame.get("is_raytracing"):
            stats.record(max(frame["render_time"], 1e-9),
                         args.width * args.height * args.batch)
            print(f"  {frame['samples']}/{args.samples} spp "
                  f"({frame['render_time'] * 1e3:.0f} ms/batch)")
    rti.stop_rendering()

    if final is None:
        print("✗ no frames rendered before timeout")
        return 1
    out = args.output
    image = (np.clip(final["enhanced"], 0, 1) * 255).astype(np.uint8)
    try:
        from PIL import Image

        Image.fromarray(image).save(out)
    except ImportError:
        np.save(out + ".npy", image)
        out += ".npy"
    print(f"✓ wrote {out}  ({stats.summary()} on {rti.device})")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="tpu-rt interactive path tracer on PyTorch and CUDA")
    parser.add_argument("--headless", action="store_true",
                        help="render without a GUI and write a PNG")
    parser.add_argument("--width", type=int, default=640)
    parser.add_argument("--height", type=int, default=480)
    parser.add_argument("--samples", type=int, default=32)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--depth", type=int, default=4)
    parser.add_argument("--timeout", type=float, default=600.0)
    parser.add_argument("--device", default="cuda",
                        help="torch device to render on (cpu: the kernels' "
                        "plain versions)")
    parser.add_argument("--output", default="render.png")
    parser.add_argument("--obj", default=None, metavar="PATH",
                        help="load a Wavefront OBJ mesh into the scene")
    parser.add_argument("--obj-scale", type=float, default=1.0)
    parser.add_argument("--aperture", type=float, default=0.0,
                        help="thin-lens radius for depth of field (0 = off)")
    parser.add_argument("--focus-dist", type=float, default=0.0,
                        help="focal-plane distance (0 = look-at target)")
    args = parser.parse_args(argv)

    print_platform_report()
    if not check_environment():
        return 1

    if args.headless:
        return run_headless(args)

    from .gui import HAVE_QT, main as gui_main

    if not HAVE_QT:
        print("✗ PyQt5 is not installed — run with --headless, or install "
              "PyQt5 for the GUI.")
        return 1
    print("Controls: WASD+Space/Ctrl move · right-drag rotate · "
          "IJKL/UO move object · X/Y/Z axis locks + left-drag · ESC cancel")
    return gui_main(args.width, args.height, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
