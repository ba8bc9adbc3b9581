"""tpu_rt_torch: the tpu-rt path tracer on PyTorch and CUDA (NVIDIA Hopper).

A port of ``tpu_rt`` that imports torch and never jax. It mirrors the JAX
package's layout, module for module:

  core/     SoA scene/camera tensors, vector math, pinhole camera, JAX's
            threefry streams, the random-spheres, terrain and Cornell-box
            scenes
  ops/      the attribute table, triangle meshes, the LBVH, the wavefront
            integrator (the lax engine, plain torch), and the wrappers of
            the path-trace megakernel and the cluster engine
  csrc/     the hand-written CUDA kernels (built on first use)
  kernels/  the nvcc build and ctypes loader
  native/   a copy of the g++ median-split BVH (an oracle for the LBVH)
  render/   engine choice, batch render, accumulation, display stack
  api/      the drop-in object surface (Vector3 ... RayTracer)
  app/      the interactive runtime (RayTracerInteraction), its previews,
            panel logic, denoiser bank, Qt GUI and launcher
  utils/    numpy converters, OBJ import/export, settings, session
            checkpoints, CUDA-event timing and frame counters, the
            port's own profiler spans and upload counter

Every function takes an explicit ``device``; tensors on the CPU run the
plain PyTorch version of each kernel, tensors on a CUDA device run the
kernel itself.
"""

from .core.types import (  # noqa: F401
    CameraP,
    SphereScene,
    demo_scene,
    make_camera,
    make_scene,
)
from .core.scenes import cornell_box, terrain_mesh  # noqa: F401
from .ops.triangle import TriangleMesh, make_mesh  # noqa: F401
from .render.frame import (  # noqa: F401
    accumulate,
    enhance_contrast,
    render,
    tone_map,
)
from .utils.objio import load_obj  # noqa: F401
