"""Drop-in object surface (Vector3 ... RayTracer) of tpu_rt_torch."""

from .compat import (  # noqa: F401
    Camera,
    DebugInfo,
    HitRecord,
    Material,
    Ray,
    RayTracer,
    Scene,
    Sphere,
    Vector3,
)
