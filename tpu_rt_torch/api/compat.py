"""Drop-in object surface of the reference's pybind11 module, on PyTorch.

Counterpart of ``tpu_rt/api/compat.py``, class for class: ``Vector3``,
``Ray``, ``Material``, ``HitRecord``, ``Sphere`` (with ``.hit``),
``Camera`` (with ``get_ray``, ``rotate``, ``move`` and ``to_params``),
``DebugInfo``, ``Scene`` (CRUD, ``build_bvh``, ``hit``,
``cast_ray_for_selection`` and ``to_arrays``) and ``RayTracer`` (scene,
mesh, camera, flags, ``render``/``render_device``, ``select_object`` and
``trace_ray`` and the debug counters). Scene edits mutate plain Python
objects; the scalar hit tests run on the host in Python floats, as in the
JAX package; ``set_scene`` snapshots the spheres into tensors on the
tracer's device, and ``render_device`` drives the megakernel there, the
cluster engine past 64 spheres or 256 triangles, or the lax engine for
``mode="v1"`` and ``linear=True``.

``Camera.to_params`` and ``Scene.to_arrays`` take the JAX package's
signatures; with no ``device`` they land on the device of the RayTracer
that holds the camera or the scene snapshot, and else on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import rng
from ..core import types as _T
from ..core.types import CameraP
from ..ops import cluster as _C
from ..ops import megakernel as _MK
from ..ops.integrator import trace
from ..render import frame as _F
from ..utils import profiling


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

    @staticmethod
    def from_array(a) -> "Vector3":
        a = np.asarray(a, float)
        return Vector3(float(a[0]), float(a[1]), float(a[2]))

    def copy(self) -> "Vector3":
        return Vector3(self.x, self.y, self.z)


def _device_of(obj, device) -> torch.device:
    """``device`` when given, else the device of the RayTracer that holds
    ``obj`` (a camera or scene snapshot), else the card."""
    if device is not None:
        return torch.device(device)
    held = getattr(obj, "_device", None)
    return held if held is not None else torch.device("cuda")


def _lens(cam) -> tuple[float, float]:
    """A camera's (aperture, focus_dist), 0.0 where it has none or None."""
    return (float(getattr(cam, "aperture", 0.0) or 0.0),
            float(getattr(cam, "focus_dist", 0.0) or 0.0))


class Ray:
    """Origin + normalized direction."""

    def __init__(self, origin: Vector3, direction: Vector3):
        self.origin = Vector3(origin.x, origin.y, origin.z)
        self.direction = direction.normalize()

    def at(self, t: float) -> Vector3:
        return self.origin + self.direction * t


class Material:
    """Albedo/metallic/roughness/emission/ior with the reference defaults."""

    def __init__(self):
        self.albedo = Vector3(0.8, 0.8, 0.8)
        self.metallic = 0.0
        self.roughness = 0.5
        self.emission = Vector3(0.0, 0.0, 0.0)
        self.ior = 1.5


class HitRecord:
    """Scalar hit record."""

    def __init__(self):
        self.t = 0.0
        self.point = Vector3()
        self.normal = Vector3()
        self.material = Material()
        self.front_face = True
        self.object_id = 0

    def set_face_normal(self, ray: Ray, outward_normal: Vector3):
        self.front_face = ray.direction.dot(outward_normal) < 0
        self.normal = outward_normal if self.front_face else outward_normal * -1.0


class Sphere:
    """Sphere with a name, an object id and a scalar ``hit``."""

    def __init__(self):
        self.center = Vector3(0.0, 0.0, 0.0)
        self.radius = 1.0
        self.material = Material()
        self.object_id = 0
        self.name = ""

    def hit(self, ray: Ray, t_min: float, t_max: float, rec: HitRecord) -> bool:
        """Two-root quadratic test with the face-normal flip."""
        oc = ray.origin - self.center
        a = ray.direction.dot(ray.direction)
        half_b = oc.dot(ray.direction)
        c = oc.dot(oc) - self.radius * self.radius
        disc = half_b * half_b - a * c
        if disc < 0:
            return False
        sqrtd = math.sqrt(disc)
        root = (-half_b - sqrtd) / a
        if root < t_min or root > t_max:
            root = (-half_b + sqrtd) / a
            if root < t_min or root > t_max:
                return False
        rec.t = root
        rec.point = ray.at(root)
        outward = (rec.point - self.center) * (1.0 / self.radius)
        rec.set_face_normal(ray, outward)
        rec.material = self.material
        rec.object_id = self.object_id
        return True


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

    def get_ray(self, u: float, v: float) -> Ray:
        """The ray through normalized screen point (u, v), v downwards."""
        ndc_x = (u - 0.5) * 2.0
        ndc_y = (0.5 - v) * 2.0
        tan_fov = math.tan(self.fov * 3.14159 / 360.0)
        forward = (self.target - self.position).normalize()
        right = forward.cross(Vector3(0, 1, 0)).normalize()
        if right.length() < 0.001:
            right = Vector3(1, 0, 0)
        up = right.cross(forward).normalize()
        direction = (
            forward
            + right * (ndc_x * self.aspect_ratio * tan_fov)
            + up * (ndc_y * tan_fov)
        )
        return Ray(self.position, direction)

    def move(self, delta: Vector3):
        self.position = self.position + delta

    def rotate(self, dx: float, dy: float):
        # a no-op, as in the v1 core; the interaction layer's
        # CameraController rotates
        pass

    def copy(self) -> "Camera":
        c = Camera()
        c.position = self.position.copy()
        c.target = self.target.copy()
        c.up = self.up.copy()
        c.fov = self.fov
        c.aspect_ratio = self.aspect_ratio
        c.aperture, c.focus_dist = _lens(self)
        return c

    def to_params(self, device=None) -> CameraP:
        """The camera as CameraP tensors on ``device`` (None: the holding
        RayTracer's device, else the card)."""
        aperture, focus_dist = _lens(self)
        return _T.make_camera(
            position=(self.position.x, self.position.y, self.position.z),
            target=(self.target.x, self.target.y, self.target.z),
            up=(self.up.x, self.up.y, self.up.z),
            fov=self.fov,
            aspect=self.aspect_ratio,
            aperture=aperture,
            focus_dist=focus_dist,
            device=_device_of(self, device),
        )


class DebugInfo:
    """Build/render counters."""

    def __init__(self):
        self.enable_debug = False
        self.build_count = 0
        self.render_count = 0

    def reset(self):
        self.build_count = 0
        self.render_count = 0

    def get_stats(self) -> str:
        return f"Builds: {self.build_count}, Renders: {self.render_count}"


class Scene:
    """Python-side scene container. ``build_bvh`` only marks the snapshot
    dirty: the device tables are rebuilt at the next ``set_scene``."""

    def __init__(self):
        self.spheres: list[Sphere] = []
        self.background_color = Vector3(0.1, 0.1, 0.1)
        self.use_bvh = True
        self.debug_mode = False
        self._dirty = True
        self._build_count = 0

    def add_sphere(self, sphere: Sphere):
        self.spheres.append(sphere)
        self._dirty = True

    def remove_sphere(self, object_id: int):
        self.spheres = [s for s in self.spheres if s.object_id != object_id]
        self._dirty = True

    def build_bvh(self):
        self._dirty = True
        self._build_count += 1

    def hit(self, ray: Ray, t_min: float, t_max: float, rec: HitRecord) -> bool:
        """Sequential closest-so-far scan."""
        temp = HitRecord()
        found = False
        closest = t_max
        for s in self.spheres:
            if s.hit(ray, t_min, closest, temp):
                found = True
                closest = temp.t
                rec.t = temp.t
                rec.point = temp.point
                rec.normal = temp.normal
                rec.material = temp.material
                rec.front_face = temp.front_face
                rec.object_id = temp.object_id
        return found

    def cast_ray_for_selection(self, ray: Ray, t_min: float, t_max: float) -> int:
        """Closest object id, -1 on a miss."""
        rec = HitRecord()
        selected = -1
        closest = t_max
        for s in self.spheres:
            if s.hit(ray, t_min, closest, rec):
                closest = rec.t
                selected = s.object_id
        return selected

    def to_arrays(self, capacity: int | None = None, *,
                  device=None) -> _T.SphereScene:
        """Snapshot to a bucketed SphereScene on ``device`` (None: the
        holding RayTracer's device, else the card)."""
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
            device=_device_of(self, device),
        )


def _pose_key(cam: Camera) -> bytes:
    """The values ``Camera.to_params`` reads, as the f32 bytes it uploads."""
    return np.array([cam.position.x, cam.position.y, cam.position.z,
                     cam.target.x, cam.target.y, cam.target.z,
                     cam.up.x, cam.up.y, cam.up.z, cam.fov, cam.aspect_ratio,
                     *_lens(cam)], np.float32).tobytes()


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
    mesh's) built once at ``set_scene``/``set_mesh`` and ordered and
    checked once per camera position (keyed by the position's Python
    floats), so no frame rebuilds or reorders them. The megakernel's
    scene tables are built once per scene, mesh and NEE flag, and the
    camera is uploaded and packed once per pose (keyed by the f32 values
    that ``Camera.to_params`` reads, since the app moves ``camera`` in
    place); each build counts one ``input_builds``
    (``utils/profiling.py``), and a batch of a repeated pose uploads
    nothing.

    ``enable_refraction`` makes materials with metallic <= 0, roughness <= 0
    and ior > 1 glass; ``set_stratify`` switches R2 stratified pixel
    sampling; a camera ``aperture`` > 0 switches the thin lens on; ``nee``
    (or ``set_nee``) next-event estimation, whose light cdf or table is
    built with the cluster tables. ``mode="v1"`` and ``linear=True``
    (pre-gamma batches) render with the lax engine, as in the JAX package;
    so does ``trace_ray``. The lax engine honours the scene's ``use_bvh``
    flag (intersection through the LBVH).
    """

    def __init__(self, seed: int = 0, mode: str = "v2",
                 enable_refraction: bool = False, linear: bool = False,
                 nee: bool = False, *, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"RayTracer(device={device!r}): CUDA is not "
                               "available")
        self._mode = mode
        self._linear = bool(linear)
        self._key = rng.key(seed, device=self.device)
        self._enable_refraction = bool(enable_refraction)
        self._stratify = False
        self._nee = bool(nee)
        self.camera = Camera()
        self.camera.position = Vector3(0, 2, 5)
        self.camera.target = Vector3(0, 0, -1)
        self.camera.fov = 45.0
        self.camera._device = self.device
        self._scene_snapshot = Scene()
        self._scene_arrays: _T.SphereScene | None = None
        self._seed_base = int(seed) + 1
        self._frame = 0
        self._debug = DebugInfo()
        # set at set_scene time on the host, so a render pulls nothing back
        self._n_active: int | None = None
        self._last_engine: str | None = None
        # the JAX package's LBVH flag: only its lax engine traverses one
        self._last_use_bvh: bool | None = None
        # whether the last batch rendered with its tile mask (megakernel)
        self._last_adaptive: bool = False
        # cluster engine tables: built per snapshot, ordered per position
        # (the position they were ordered at)
        self._clustered: _C.ClusteredScene | None = None
        self._ordered_at: tuple | None = None
        # an optional TriangleMesh rendered beside the spheres, its quantized
        # active count, and its cluster tables
        self._mesh = None
        self._n_tri_active: int | None = None
        self._tri_clustered: _C.ClusteredScene | None = None
        # the engine's NEE light cdf (megakernel) or table (cluster)
        self._lights: torch.Tensor | None = None
        # the kernel's inputs: the engine's tables (megakernel: per scene,
        # mesh and NEE flag; cluster: ordered and checked per camera
        # position), and the pose's CameraP and packed camera under their key
        self._tables = None
        self._pose_key: bytes | None = None
        self._pose: tuple | None = None

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
        snap._device = self.device
        self._scene_snapshot = snap
        self._scene_arrays = snap.to_arrays(device=self.device)
        self._n_active = _F.quantize_count(len(snap.spheres),
                                           self._scene_arrays.capacity)
        self._build_tables()
        self._debug.build_count += 1

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
        self._clustered = self._tri_clustered = self._ordered_at = None
        if self._has_spheres() and self._engine() == "cluster":
            self._clustered = _C.build_clusters(self._scene_arrays,
                                                n_active=self._n_active)
            if self._mesh is not None:
                self._tri_clustered = _C.build_tri_clusters(
                    self._mesh, n_active=self._n_tri_active)
        self._build_lights()

    def _has_spheres(self) -> bool:
        return (self._scene_arrays is not None
                and bool(self._scene_snapshot.spheres))

    def _engine(self) -> str:
        return _F.select_engine(self._scene_arrays, self._mode,
                                self._enable_refraction, not self._linear,
                                self._mesh)

    def set_stratify(self, enable: bool):
        """Switch stratified (R2 low-discrepancy) pixel sampling."""
        self._stratify = bool(enable)

    def _build_lights(self):
        """With NEE on, build the engine's light cdf (megakernel) or light
        table (cluster) of the scene once; then the kernel's tables."""
        self._lights = None
        if self._nee and self._has_spheres():
            self._lights = (_C.light_table(self._scene_arrays)
                            if self._engine() == "cluster"
                            else _MK.light_cdf(self._scene_arrays))
        self._build_inputs()

    def _build_inputs(self):
        """The kernel's tables of the scene, mesh and NEE flag, counted as
        one ``input_builds``: the megakernel's :func:`scene_tables`; the
        cluster engine's tables, built at ``_build_tables``, are checked
        with the light table where they are ordered, and here again if
        they already are (a switch of NEE)."""
        tables, self._tables = self._tables, None
        if not self._has_spheres():
            return
        engine = self._engine()
        if engine == "pallas":
            self._tables = _MK.scene_tables(
                self._scene_arrays, self._n_active, nee=self._nee,
                lights=self._lights, mesh=self._mesh,
                n_tri_active=self._n_tri_active)
        elif engine == "cluster":
            if self._ordered_at is not None:
                self._tables = _C.check_tables(tables.spheres, tables.tris,
                                               self._lights)
        else:
            return
        profiling.count("input_builds")

    def set_nee(self, enable: bool):
        """Switch next-event estimation (direct light by shadow rays to the
        emissive spheres); switching it on builds the light cdf or table."""
        self._nee = bool(enable)
        self._build_lights()

    def get_camera(self) -> Camera:
        """A copy of the camera; its ``to_params()`` lands on this
        tracer's device."""
        c = self.camera.copy()
        c._device = self.device
        return c

    def set_camera(self, cam: Camera):
        cam._device = self.device
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
        batch = self._frame
        seed = batch_seed(self._seed_base, batch)
        self._frame += 1
        self._last_engine = self._engine()
        self._last_use_bvh = (bool(self._scene_snapshot.use_bvh)
                              and self._last_engine == "lax")
        self._last_adaptive = (tile_mask is not None
                               and self._last_engine == "pallas")
        if not self._last_adaptive:
            tile_mask = None
        with profiling.span("camera", batch):
            cam, packed = self._camera_inputs()
        if self._last_engine == "cluster":
            pos = self.camera.position
            at = (pos.x, pos.y, pos.z)
            if at != self._ordered_at:
                with profiling.span("order"):
                    tri = self._tri_clustered
                    self._tables = _C.check_tables(
                        _C.order_clusters(self._clustered, cam.position),
                        None if tri is None
                        else _C.order_clusters(tri, cam.position),
                        self._lights)
                self._ordered_at = at
        img = _F.render(
            self._scene_arrays, cam, seed, width=width, height=height,
            spp=samples_per_pixel, max_depth=max_depth, mode=self._mode,
            gamma=not self._linear, engine=self._last_engine,
            use_bvh=bool(self._scene_snapshot.use_bvh),
            n_active=self._n_active, mesh=self._mesh,
            n_tri_active=self._n_tri_active,
            enable_refraction=self._enable_refraction,
            stratify=self._stratify, nee=self._nee,
            enable_dof=_lens(self.camera)[0] > 0.0,
            tile_mask=tile_mask, tables=self._tables, packed_camera=packed)
        self._debug.render_count += 1
        return img

    def _camera_inputs(self):
        """The pose's CameraP and packed camera. They are built (one
        ``input_builds``) when a value that ``Camera.to_params`` reads
        differs, as f32, from the last batch's; a repeated pose reuses
        them and uploads nothing (``uploads`` counts 0, so a traced window
        of such batches still reads the counter)."""
        if _pose_key(self.camera) == self._pose_key:
            profiling.count("uploads", 0)
            return self._pose
        # one snapshot gives the key and the tensors, so a camera moved
        # by another thread meanwhile cannot pair them wrongly
        snap = self.camera.copy()
        cam = snap.to_params(self.device)
        self._pose = cam, _MK.pack_camera(cam, self.device)
        self._pose_key = _pose_key(snap)
        profiling.count("input_builds")
        return self._pose

    def trace_ray(self, ray: Ray, depth: int, max_depth: int) -> Vector3:
        """Single-ray radiance estimate by the lax integrator's ``trace``,
        from the key ``fold_in(key(seed), frame)`` (the frame counter
        advances)."""
        if self._scene_arrays is None:
            return Vector3(0, 0, 0)

        def row(v):
            return torch.tensor([[v.x, v.y, v.z]], dtype=torch.float32,
                                device=self.device)

        key = rng.fold_in(self._key, self._frame)
        self._frame += 1
        c = trace(self._scene_arrays, row(ray.origin), row(ray.direction),
                  key, max_depth=max_depth, mode=self._mode,
                  enable_refraction=self._enable_refraction)[0].cpu()
        return Vector3(float(c[0]), float(c[1]), float(c[2]))

    def select_object(self, x: float, y: float, width: int, height: int) -> int:
        """The object id under normalized screen point (x, y) through the
        camera, -1 on a miss."""
        ray = self.camera.get_ray(x, y)
        return self._scene_snapshot.cast_ray_for_selection(ray, 0.001, 1000.0)

    def set_debug_mode(self, enable: bool):
        self._debug.enable_debug = enable

    def get_debug_info(self) -> DebugInfo:
        return self._debug
