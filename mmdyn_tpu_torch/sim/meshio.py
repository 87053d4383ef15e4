"""First-party Wavefront OBJ / MTL parsing (the port's copy of
``mmdyn_tpu/sim/meshio.py``).

The reference leans on trimesh + pywavefront for mesh statistics and material
probing (mmdyn/tact_sim/utils/dataset.py:143-198). Neither is a reasonable
dependency for a standalone framework whose mesh needs are tiny: vertex
statistics (centroid, extents) for COM/height estimation, face data for
surface sampling, and MTL colour/texture probing. This module implements
exactly that surface in plain numpy, so the asset pipeline runs in any
environment; trimesh remains an optional accelerator elsewhere.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Material:
    """One MTL material. ``ambient``/``diffuse``/``specular`` are RGBA (MTL
    stores RGB; alpha from ``d``, default 1). ``texture`` is the map_Kd path
    string or None — the two fields parse_shapenet_sem probes
    (dataset.py:155-161)."""
    name: str
    ambient: Tuple[float, float, float, float] = (0.2, 0.2, 0.2, 1.0)
    diffuse: Tuple[float, float, float, float] = (0.8, 0.8, 0.8, 1.0)
    specular: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    texture: Optional[str] = None


def parse_mtl(path) -> Dict[str, Material]:
    """Parse an MTL file into {name: Material}. Unknown directives are
    ignored; missing file raises FileNotFoundError like pywavefront."""
    materials: Dict[str, Material] = {}
    current: Optional[Material] = None
    alpha = 1.0
    with open(path, "r", errors="replace") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            key, vals = parts[0], parts[1:]
            if key == "newmtl":
                name = vals[0] if vals else f"material_{len(materials)}"
                current = Material(name=name)
                materials[name] = current
                alpha = 1.0
            elif current is None:
                continue
            elif key in ("Ka", "Kd", "Ks"):
                rgb = tuple(float(v) for v in vals[:3])
                rgba = rgb + (alpha,)
                if key == "Ka":
                    current.ambient = rgba
                elif key == "Kd":
                    current.diffuse = rgba
                else:
                    current.specular = rgba
            elif key in ("d", "Tr"):
                alpha = float(vals[0]) if key == "d" else 1.0 - float(vals[0])
                current.ambient = current.ambient[:3] + (alpha,)
                current.diffuse = current.diffuse[:3] + (alpha,)
                current.specular = current.specular[:3] + (alpha,)
            elif key in ("map_Kd", "map_Ka"):
                current.texture = vals[-1] if vals else None
    return materials


@dataclasses.dataclass
class Mesh:
    """Vertex/face soup with the trimesh-compatible statistics the asset
    pipeline uses."""
    vertices: np.ndarray                 # (V, 3) float64
    faces: np.ndarray                    # (F, 3) int64 (triangulated)

    @property
    def centroid(self) -> np.ndarray:
        """Vertex mean — matches trimesh.points.PointCloud.centroid, the
        quantity the reference uses as center-of-mass (dataset.py:164-166)."""
        return self.vertices.mean(axis=0)

    @property
    def extents(self) -> np.ndarray:
        """Axis-aligned bounding-box extents (max - min per axis)."""
        return self.vertices.max(axis=0) - self.vertices.min(axis=0)

    @property
    def bounds(self) -> np.ndarray:
        return np.stack([self.vertices.min(axis=0), self.vertices.max(axis=0)])

    def face_normals(self) -> np.ndarray:
        """(F, 3) unit normals from the right-hand winding (cached — the
        geometry is immutable and pose sampling calls this per contact
        point)."""
        cached = getattr(self, "_face_normals", None)
        if cached is not None:
            return cached
        v = self.vertices
        a, b, c = (v[self.faces[:, i]] for i in range(3))
        n = np.cross(b - a, c - a)
        norm = np.linalg.norm(n, axis=1, keepdims=True)
        self._face_normals = n / np.where(norm > 0, norm, 1.0)
        return self._face_normals

    def face_areas(self) -> np.ndarray:
        cached = getattr(self, "_face_areas", None)
        if cached is not None:
            return cached
        v = self.vertices
        a, b, c = (v[self.faces[:, i]] for i in range(3))
        self._face_areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
        return self._face_areas

    def sample_surface(self, count: int, rng=None):
        """Area-weighted surface sampling -> (points (count,3), face indices).
        Mirrors trimesh.sample.sample_surface for the pose-sampling path
        (utils/sample.py:34-43)."""
        rng = rng or np.random.default_rng()
        areas = self.face_areas()
        total = areas.sum()
        if total <= 0 or len(self.faces) == 0:
            raise ValueError("mesh has no area to sample")
        face_idx = rng.choice(len(self.faces), size=count, p=areas / total)
        # uniform barycentric coordinates
        r1 = np.sqrt(rng.uniform(size=count))
        r2 = rng.uniform(size=count)
        a = self.vertices[self.faces[face_idx, 0]]
        b = self.vertices[self.faces[face_idx, 1]]
        c = self.vertices[self.faces[face_idx, 2]]
        pts = (1 - r1)[:, None] * a + (r1 * (1 - r2))[:, None] * b \
            + (r1 * r2)[:, None] * c
        return pts, face_idx


def load_obj(path) -> Mesh:
    """Parse OBJ geometry: ``v`` lines -> vertices, ``f`` lines -> triangle
    fan. Ignores normals/texcoords/groups/materials (statistics only need
    geometry). Negative indices are resolved OBJ-style."""
    vertices: List[Tuple[float, float, float]] = []
    faces: List[Tuple[int, int, int]] = []
    with open(path, "r", errors="replace") as f:
        for raw in f:
            line = raw.strip()
            if line.startswith("v "):
                parts = line.split()
                vertices.append((float(parts[1]), float(parts[2]),
                                 float(parts[3])))
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(vertices) + i)
                for k in range(1, len(idx) - 1):      # triangle fan
                    faces.append((idx[0], idx[k], idx[k + 1]))
    return Mesh(vertices=np.asarray(vertices, dtype=np.float64).reshape(-1, 3),
                faces=np.asarray(faces, dtype=np.int64).reshape(-1, 3))


def obj_bounds(path):
    """(min_xyz, max_xyz) of an OBJ's vertices — cheap support query for
    engines that approximate meshes by primitives."""
    mesh = load_obj(path)
    if mesh.vertices.size == 0:
        raise ValueError(f"no vertices in {path}")
    return mesh.vertices.min(axis=0), mesh.vertices.max(axis=0)
