"""Asset loaders (the port's copy of ``mmdyn_tpu/sim/assets.py``; port of
mmdyn/tact_sim/utils/dataset.py).

Mesh assets (graphics/objects, ShapeNetCore, ShapeNetSem) are located under a
configurable graphics root (``MMDYN_GRAPHICS_ROOT`` env var or the
``graphics_root`` argument; default ``./graphics``). trimesh / pywavefront are
imported lazily — they are only needed for the mesh-parsing paths.

``synthetic_object_catalog`` provides primitive stand-ins with the same record
schema for engines without mesh support (the analytic backend).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from mmdyn_tpu_torch.sim import config


def graphics_root(path=None) -> Path:
    """Asset root resolution: explicit arg > MMDYN_GRAPHICS_ROOT env var >
    ./graphics (cwd) > the repo-bundled graphics/ (procedurally generated
    winebottle/bowl meshes, mirroring the reference's graphics/objects/)."""
    if path is not None:
        return Path(path)
    env = os.environ.get("MMDYN_GRAPHICS_ROOT")
    if env:
        return Path(env)
    cwd_root = Path("graphics")
    if cwd_root.is_dir():
        return cwd_root
    bundled = Path(__file__).resolve().parents[2] / "graphics"
    if bundled.is_dir():
        return bundled
    return cwd_root


def preload_object(name="winebottle", n_objects=1, graphics_root_path=None):
    """Bundled demo objects (dataset.py:14-45): winebottle (scale .05) or bowl."""
    assert name in config.OBJECTS, (
        f"The specified object is not valid. Available objects are {config.OBJECTS}")
    path = graphics_root(graphics_root_path).joinpath(
        "objects", name, "models", "model_normalized.obj")
    mesh_scale = [0.05] * 3 if name == "winebottle" else [1.0] * 3
    shift = [[0, 0.0, 0.0]]
    if n_objects > 1:
        return {"obj": [path] * n_objects, "texture": [[]] * n_objects,
                "scale": [mesh_scale] * n_objects, "shift": [shift] * n_objects}
    return {"obj": path, "texture": [], "scale": mesh_scale, "shift": shift}


def preload_shapenet_core(path=None, category=""):
    """ShapeNetCore object list, dropping texture-less meshes
    (dataset.py:48-91)."""
    root = graphics_root().joinpath("shapenet_core") if path is None else Path(path)
    obj_list = []
    if category:
        assert category in config.SHAPENET_CORE, (
            f"The specified category is not valid. Available categories are "
            f"{config.SHAPENET_CORE}")
        obj_list = sorted(root.glob(config.SHAPENET_CORE[category] + "/**/*.obj"))
    else:
        for _, v in config.SHAPENET_CORE.items():
            obj_list += sorted(root.glob(v + "/**/*.obj"))

    obj_list = [obj for obj in obj_list
                if sorted(obj.parents[1].joinpath("images").glob("*.*"))]
    assert len(obj_list) > 0, "Cannot load the ShapeNet_Core dataset."
    return {"obj": obj_list,
            "scale": [[1, 1, 1]] * len(obj_list),
            "shift": [[0, 0, -0.1]] * len(obj_list)}


def preload_shapenet_sem(path=None, category=("FoodItem",)):
    """ShapeNetSem metadata join: category -> synset -> object rows, with NaN
    defaults filled (dataset.py:94-140). Returns (DataFrame, models_root)."""
    import pandas as pd

    root = graphics_root().joinpath("ShapeNetSem") if path is None else Path(path)
    # synset ids are zero-padded strings ("02880940"); force str so pandas
    # doesn't coerce them to int (breaking joins and dump-path construction)
    meta_df = pd.read_csv(root.joinpath("metadata.csv"),
                          dtype={"fullId": str, "wnsynset": str})
    synset_df = pd.read_csv(root.joinpath("categories.synset.csv"),
                            dtype={"synset": str, "category": str})

    category = list(category)
    if category and category[0] != "":
        assert set(category).issubset(set(config.SHAPENET_SEM)), (
            f"The specified category is not valid. Available categories are "
            f"{list(config.SHAPENET_SEM)}")
        categories = [[c] + config.SHAPENET_SEM[c] for c in category]
    else:
        categories = [[k] + v for k, v in config.SHAPENET_SEM.items()]
    categories = [item for sublist in categories for item in sublist]

    synset_df = synset_df.loc[synset_df["category"].isin(categories)]
    synset = synset_df["synset"].tolist()

    meta_df = meta_df.loc[meta_df["wnsynset"].isin(synset)]
    meta_df = meta_df.copy()
    meta_df["fullId"] = meta_df["fullId"].str.replace("wss.", "", regex=False)
    meta_df = meta_df.fillna(value={
        "weight": config.DEFAULT_WEIGHT,
        "unit": config.DEFAULT_UNIT,
        "up": config.DEFAULT_UP,
        "front": config.DEFAULT_FRONT,
    })
    return meta_df, root.joinpath("models-OBJ", "models")


def parse_shapenet_sem(row, root):
    """One metadata row -> object record with colors/texture probe + mesh
    centroid/extents (dataset.py:143-198).

    Uses the first-party OBJ/MTL parsers (sim/meshio.py) in place of the
    reference's pywavefront MaterialParser + trimesh PointCloud — identical
    quantities (ambient RGBA per material, texture presence, vertex-mean
    centroid, bbox z-extent), zero native deps."""
    from mmdyn_tpu_torch.sim.meshio import load_obj, parse_mtl

    obj_name = row["fullId"]
    scale = row["unit"]
    obj = Path(root).joinpath(obj_name + ".obj")
    mtl = Path(root).joinpath(obj_name + ".mtl")

    colors = []
    textured_material = False
    for v in parse_mtl(mtl).values():
        # chromatic ambient = usable colour (dataset.py:155-158)
        if len(set(v.ambient[:-1])) > 1:
            colors.append(list(v.ambient))
        if v.texture is not None:
            textured_material = True

    mesh = load_obj(obj)
    center_mass = np.array(mesh.centroid) * scale
    mesh_height = np.array(mesh.extents[-1]) * scale

    return {
        "obj_name": obj_name,
        "obj": obj,
        "mtl": mtl,
        "weight": row["weight"],
        "scale": scale,
        "category": row["category"],
        "synset": row["wnsynset"],
        "colors": colors,
        "textured_material": textured_material,
        "center_mass": center_mass,
        "mesh_height": mesh_height,
    }


def synthetic_object_catalog(n_objects=8, seed=0):
    """Primitive object records (sphere/box) with the parse_shapenet_sem
    schema, for engines without mesh loading (analytic backend)."""
    rng = np.random.default_rng(seed)
    records = []
    for i in range(n_objects):
        shape = "sphere" if rng.uniform() < 0.5 else "box"
        size = (float(rng.uniform(0.08, 0.22)) if shape == "sphere"
                else rng.uniform(0.06, 0.2, size=3).tolist())
        records.append({
            "obj_name": f"synthetic_{shape}_{i:03d}",
            "obj": None,
            "mtl": None,
            "weight": float(rng.uniform(0.3, 2.0)),
            "scale": 1.0,
            "category": "Synthetic",
            "synset": "synth00000000",
            "colors": [rng.uniform(0.2, 1.0, size=3).tolist() + [1.0]],
            "textured_material": False,
            "center_mass": np.zeros(3),
            "mesh_height": float(size if shape == "sphere" else size[2]) * 2,
            "shape": shape,
            "size": size,
        })
    return records


def spawn_object(backend, info, position, orientation=(0, 0, 0, 1), mass=1.0,
                 color=(), mesh_scale=None, COM_shift=(0, 0, 0)):
    """Backend-dispatching object spawn: meshes on PyBullet, primitives on the
    analytic engine."""
    from mmdyn_tpu_torch.sim.physics import PyBulletBackend

    if isinstance(backend, PyBulletBackend):
        from mmdyn_tpu_torch.sim.pybullet_utils import add_object
        return add_object(backend, graphic_file=info["obj"],
                          collision_file=info["obj"], mass=mass,
                          base_position=position,
                          base_orientation=orientation,
                          mesh_scale=mesh_scale or [info["scale"]] * 3,
                          COM_shift=COM_shift, color=color)
    rgb = (color[:3] if color else
           (info["colors"][0][:3] if info.get("colors") else (1, 0, 0)))
    shape = info.get("shape", "sphere")
    if shape == "sphere":
        return backend.add_sphere(info.get("size", 0.15), position, mass=mass,
                                  color=rgb)
    half = np.asarray(info.get("size", [0.1, 0.1, 0.1]), np.float64)
    return backend.add_box(half, position, orientation=orientation, mass=mass,
                           color=rgb)
