"""Drop-in object surface of the reference's pybind11 module, on PyTorch.

Counterpart of ``tpu_rt/api/compat.py`` for the slice the port carries:
``Vector3``, ``Material``, ``Sphere``, ``Camera`` (with ``to_params``),
``Scene`` (with ``to_arrays``) and ``RayTracer`` with ``set_scene``,
``set_mesh``, ``set_stratify``, ``set_nee``, ``get_camera``, ``set_camera``,
``move_camera``, ``render`` and ``render_device``. Scene edits mutate
plain Python objects; ``set_scene`` snapshots them into tensors on the
tracer's device, and ``render_device`` drives the megakernel there, or the
cluster engine past 64 spheres or 256 triangles.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import types as _T
from ..core.types import CameraP
from ..ops import cluster as _C
from ..ops import megakernel as _MK
from ..render import frame as _F


class Vector3:
    """Mutable 3-vector with the reference's operator set."""

    __slots__ = ("x", "y", "z")

    def __init__(self, x: float = 0.0, y: float = 0.0, z: float = 0.0):
        self.x = float(x)
        self.y = float(y)
        self.z = float(z)

    def __add__(self, o):
        return Vector3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o):
        return Vector3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, o):
        if isinstance(o, Vector3):
            return Vector3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vector3(self.x * o, self.y * o, self.z * o)

    def __rmul__(self, s):
        return Vector3(self.x * s, self.y * s, self.z * s)

    def __truediv__(self, s):
        inv = 1.0 / s
        return Vector3(self.x * inv, self.y * inv, self.z * inv)

    def __neg__(self):
        return Vector3(-self.x, -self.y, -self.z)

    def __iadd__(self, o):
        self.x += o.x
        self.y += o.y
        self.z += o.z
        return self

    def __imul__(self, s):
        self.x *= s
        self.y *= s
        self.z *= s
        return self

    def dot(self, o) -> float:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o) -> "Vector3":
        return Vector3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def length_squared(self) -> float:
        return self.x * self.x + self.y * self.y + self.z * self.z

    def length(self) -> float:
        return math.sqrt(self.length_squared())

    def normalize(self) -> "Vector3":
        n = self.length()
        if n > 0.0:
            inv = 1.0 / n
            return Vector3(self.x * inv, self.y * inv, self.z * inv)
        # v1 normalize returns zero vectors unchanged
        return Vector3(self.x, self.y, self.z)

    def __repr__(self):
        return f"Vector3({self.x:.6f}, {self.y:.6f}, {self.z:.6f})"

    def to_array(self) -> np.ndarray:
        return np.array([self.x, self.y, self.z], np.float32)

    def copy(self) -> "Vector3":
        return Vector3(self.x, self.y, self.z)


class Material:
    """Albedo/metallic/roughness/emission/ior with the reference defaults."""

    def __init__(self):
        self.albedo = Vector3(0.8, 0.8, 0.8)
        self.metallic = 0.0
        self.roughness = 0.5
        self.emission = Vector3(0.0, 0.0, 0.0)
        self.ior = 1.5


class Sphere:
    """Sphere with a name and object id."""

    def __init__(self):
        self.center = Vector3(0.0, 0.0, 0.0)
        self.radius = 1.0
        self.material = Material()
        self.object_id = 0
        self.name = ""


class Camera:
    """v1 camera: position/target/up/fov/aspect; ``aperture`` > 0 renders
    with a thin lens of that radius, focused at ``focus_dist`` (<= 0: the
    look-at distance)."""

    def __init__(self):
        self.position = Vector3(0.0, 2.0, 3.0)
        self.target = Vector3(0.0, 0.0, -3.0)
        self.up = Vector3(0.0, 1.0, 0.0)
        self.fov = 45.0
        self.aspect_ratio = 1.333
        self.aperture = 0.0
        self.focus_dist = 0.0

    def move(self, delta: Vector3):
        self.position = self.position + delta

    def copy(self) -> "Camera":
        c = Camera()
        c.position = self.position.copy()
        c.target = self.target.copy()
        c.up = self.up.copy()
        c.fov = self.fov
        c.aspect_ratio = self.aspect_ratio
        c.aperture = self.aperture
        c.focus_dist = self.focus_dist
        return c

    def to_params(self, device) -> CameraP:
        return _T.make_camera(
            position=(self.position.x, self.position.y, self.position.z),
            target=(self.target.x, self.target.y, self.target.z),
            up=(self.up.x, self.up.y, self.up.z),
            fov=self.fov,
            aspect=self.aspect_ratio,
            aperture=self.aperture,
            focus_dist=self.focus_dist,
            device=device,
        )


class Scene:
    """Python-side scene container."""

    def __init__(self):
        self.spheres: list[Sphere] = []
        self.background_color = Vector3(0.1, 0.1, 0.1)
        self.use_bvh = True
        self.debug_mode = False

    def add_sphere(self, sphere: Sphere):
        self.spheres.append(sphere)

    def remove_sphere(self, object_id: int):
        self.spheres = [s for s in self.spheres if s.object_id != object_id]

    def to_arrays(self, device, capacity: int | None = None) -> _T.SphereScene:
        """Snapshot to a bucketed SphereScene on ``device``."""
        s = self.spheres
        return _T.make_scene(
            centers=np.array([x.center.to_array() for x in s],
                             np.float32).reshape(-1, 3),
            radii=[x.radius for x in s],
            albedos=np.array([x.material.albedo.to_array() for x in s],
                             np.float32).reshape(-1, 3),
            metallics=[x.material.metallic for x in s],
            roughnesses=[x.material.roughness for x in s],
            emissions=np.array([x.material.emission.to_array() for x in s],
                               np.float32).reshape(-1, 3),
            iors=[x.material.ior for x in s],
            object_ids=[x.object_id for x in s],
            background=self.background_color.to_array(),
            capacity=capacity,
            device=device,
        )


def batch_seed(seed_base: int, frame: int) -> int:
    """The stream seed of progressive batch ``frame``: the JAX package's
    host-side arithmetic, unchanged (``seed_base`` is the tracer's seed
    + 1)."""
    return (seed_base * 1000003 + frame) & 0x7FFFFFFF


class RayTracer:
    """Drop-in RayTracer service on one torch device.

    ``set_scene`` snapshots the scene (later Python-side edits are
    invisible until the next ``set_scene``). Successive renders advance a
    frame counter folded into the seed, so progressive batches draw fresh
    samples. ``device`` must be usable: a CUDA device without CUDA raises
    here rather than rendering somewhere else.

    A scene that resolves to the cluster engine has its tables (and its
    mesh's) built once at ``set_scene``/``set_mesh`` and ordered once per
    camera position (keyed by the position's Python floats), so no frame
    rebuilds or reorders them.

    ``enable_refraction`` makes materials with metallic <= 0, roughness <= 0
    and ior > 1 glass; ``set_stratify`` switches R2 stratified pixel
    sampling; a camera ``aperture`` > 0 switches the thin lens on; ``nee``
    (or ``set_nee``) next-event estimation, whose light cdf or table is
    built with the cluster tables. Only ``mode="v2"`` is ported;
    ``linear=True`` (the JAX package's lax engine always) raises.
    """

    def __init__(self, seed: int = 0, mode: str = "v2",
                 enable_refraction: bool = False, linear: bool = False,
                 nee: bool = False, *, device="cuda"):
        if mode != "v2":
            raise _F._not_ported(f"mode={mode!r}", "Queue 1, lax integrator")
        if linear:
            raise _F._not_ported("RayTracer(linear=True) (the JAX package "
                                 "renders it with its lax engine)",
                                 "Queue 1, lax integrator")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"RayTracer(device={device!r}): CUDA is not "
                               "available")
        self._enable_refraction = bool(enable_refraction)
        self._stratify = False
        self._nee = bool(nee)
        self.camera = Camera()
        self.camera.position = Vector3(0, 2, 5)
        self.camera.target = Vector3(0, 0, -1)
        self.camera.fov = 45.0
        self._scene_snapshot = Scene()
        self._scene_arrays: _T.SphereScene | None = None
        self._seed_base = int(seed) + 1
        self._frame = 0
        # set at set_scene time on the host, so a render pulls nothing back
        self._n_active: int | None = None
        self._last_engine: str | None = None
        # whether the last batch rendered with its tile mask (megakernel)
        self._last_adaptive: bool = False
        # cluster engine tables: built per snapshot, ordered per position
        self._clustered: _C.ClusteredScene | None = None
        self._ordered: _C.ClusteredScene | None = None
        self._ordered_at: tuple | None = None
        # an optional TriangleMesh rendered beside the spheres, its quantized
        # active count, and its cluster tables (built, ordered)
        self._mesh = None
        self._n_tri_active: int | None = None
        self._tri_clustered: _C.ClusteredScene | None = None
        self._tri_ordered: _C.ClusteredScene | None = None
        # the engine's NEE light cdf (megakernel) or table (cluster)
        self._lights: torch.Tensor | None = None

    def set_scene(self, scene: Scene):
        snap = Scene()
        snap.background_color = scene.background_color.copy()
        snap.use_bvh = scene.use_bvh
        snap.debug_mode = scene.debug_mode
        for s in scene.spheres:
            c = Sphere()
            c.center = s.center.copy()
            c.radius = s.radius
            m = Material()
            m.albedo = s.material.albedo.copy()
            m.metallic = s.material.metallic
            m.roughness = s.material.roughness
            m.emission = s.material.emission.copy()
            m.ior = s.material.ior
            c.material = m
            c.object_id = s.object_id
            c.name = s.name
            snap.spheres.append(c)
        self._scene_snapshot = snap
        self._scene_arrays = snap.to_arrays(self.device)
        self._n_active = _F.quantize_count(len(snap.spheres),
                                           self._scene_arrays.capacity)
        self._build_tables()

    def set_mesh(self, mesh) -> None:
        """Attach (or clear, with None) a TriangleMesh, rendered beside the
        sphere scene; it moves to the tracer's device. Engine selection
        accounts for it: meshes past 256 triangles go to the cluster
        engine."""
        if mesh is not None:
            mesh = mesh._replace(**{k: v.to(self.device)
                                    for k, v in mesh._asdict().items()})
            self._n_tri_active = _F.quantize_count(int(mesh.valid.sum()),
                                                   mesh.capacity)
        else:
            self._n_tri_active = None
        self._mesh = mesh
        self._build_tables()

    def _build_tables(self):
        """Build the cluster tables of the scene (and mesh) once, when they
        resolve to the cluster engine (they are ordered at the next
        render), and with NEE on the engine's light cdf or table."""
        self._clustered = self._ordered = self._ordered_at = None
        self._tri_clustered = self._tri_ordered = None
        self._build_lights()
        if (self._scene_arrays is None or not self._scene_snapshot.spheres
                or self._engine() != "cluster"):
            return
        self._clustered = _C.build_clusters(self._scene_arrays,
                                            n_active=self._n_active)
        if self._mesh is not None:
            self._tri_clustered = _C.build_tri_clusters(
                self._mesh, n_active=self._n_tri_active)

    def _engine(self) -> str:
        return _F.select_engine(self._scene_arrays,
                                enable_refraction=self._enable_refraction,
                                mesh=self._mesh)

    def set_stratify(self, enable: bool):
        """Switch stratified (R2 low-discrepancy) pixel sampling."""
        self._stratify = bool(enable)

    def _build_lights(self):
        """With NEE on, build the engine's light cdf (megakernel) or light
        table (cluster) of the scene once."""
        self._lights = None
        if (self._nee and self._scene_arrays is not None
                and self._scene_snapshot.spheres):
            self._lights = (_C.light_table(self._scene_arrays)
                            if self._engine() == "cluster"
                            else _MK.light_cdf(self._scene_arrays))

    def set_nee(self, enable: bool):
        """Switch next-event estimation (direct light by shadow rays to the
        emissive spheres); switching it on builds the light cdf or table."""
        self._nee = bool(enable)
        self._build_lights()

    def get_camera(self) -> Camera:
        return self.camera.copy()

    def set_camera(self, cam: Camera):
        self.camera = cam

    def move_camera(self, delta: Vector3):
        self.camera.move(delta)

    def render(self, width: int, height: int, samples_per_pixel: int,
               max_depth: int) -> np.ndarray:
        """One progressive batch as a flat (h*w*3,) float32 host array."""
        img = self.render_device(width, height, samples_per_pixel, max_depth)
        if img is None:
            return np.zeros((width * height * 3,), np.float32)
        return img.cpu().numpy().reshape(-1)

    def render_device(self, width: int, height: int, samples_per_pixel: int,
                      max_depth: int, tile_mask=None):
        """One progressive batch as an (h, w, 3) tensor on the tracer's
        device, or None for a scene without spheres (mesh or not).

        ``tile_mask`` (adaptive sampling, megakernel engine only): int32
        (n_tiles,) over the 4096-pixel tiles; a tile with 0 is skipped and
        returns zeros; merge with ``render/frame.py:accumulate_tiled``. As
        in the JAX package, a batch that resolves to the cluster engine
        drops the mask and renders every tile, and ``_last_adaptive`` says
        whether the mask was applied."""
        self.camera.aspect_ratio = width / height
        if self._scene_arrays is None or not self._scene_snapshot.spheres:
            return None
        seed = batch_seed(self._seed_base, self._frame)
        self._frame += 1
        self._last_engine = self._engine()
        self._last_adaptive = (tile_mask is not None
                               and self._last_engine == "pallas")
        if not self._last_adaptive:
            tile_mask = None
        cam = self.camera.to_params(self.device)
        kw = {}
        if self._last_engine == "cluster":
            pos = self.camera.position
            at = (pos.x, pos.y, pos.z)
            if at != self._ordered_at:
                self._ordered = _C.order_clusters(self._clustered,
                                                  cam.position)
                if self._tri_clustered is not None:
                    self._tri_ordered = _C.order_clusters(
                        self._tri_clustered, cam.position)
                self._ordered_at = at
            kw = dict(prebuilt=self._ordered, tri_prebuilt=self._tri_ordered,
                      pre_ordered=True)
        return _F.render(
            self._scene_arrays, cam, seed, width=width, height=height,
            spp=samples_per_pixel, max_depth=max_depth,
            n_active=self._n_active, mesh=self._mesh,
            n_tri_active=self._n_tri_active,
            enable_refraction=self._enable_refraction,
            stratify=self._stratify, nee=self._nee, lights=self._lights,
            enable_dof=float(self.camera.aperture) > 0.0,
            tile_mask=tile_mask, **kw)
