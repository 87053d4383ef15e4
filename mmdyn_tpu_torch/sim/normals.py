"""Surface-normal estimation without Open3D (the port's copy of
``mmdyn_tpu/sim/normals.py``).

The reference's only non-trivial geometry kernel is Open3D's kNN-PCA normal
estimation + camera orientation (mmdyn/tact_sim/tactile/utils.py:77-88), run
on pointclouds that are in fact *regular camera grids* (unprojected canvases).
For grid clouds the normals are exactly the cross product of the central
differences along the grid axes — O(N) vectorised instead of a kNN graph, and
batchable on a device (``sim/tactile_torch.py``).

An unstructured-cloud fallback (kNN + PCA via scipy cKDTree) is provided for
API completeness.
"""

from __future__ import annotations

import numpy as np


def grid_normals(points, grid_shape, camera_location=(0, 0, 0)):
    """Normals of a grid-ordered pointcloud via central differences.

    Args:
        points: (3, H*W) world points in canvas scan order.
        grid_shape: (H, W).
        camera_location: orientation target (normals flipped towards it).

    Returns:
        (3, H*W) unit normals.
    """
    h, w = grid_shape
    p = np.asarray(points).reshape(3, h, w)

    # central differences with edge replication
    dx = np.empty_like(p)
    dx[:, :, 1:-1] = p[:, :, 2:] - p[:, :, :-2]
    dx[:, :, 0] = p[:, :, 1] - p[:, :, 0]
    dx[:, :, -1] = p[:, :, -1] - p[:, :, -2]
    dy = np.empty_like(p)
    dy[:, 1:-1, :] = p[:, 2:, :] - p[:, :-2, :]
    dy[:, 0, :] = p[:, 1, :] - p[:, 0, :]
    dy[:, -1, :] = p[:, -1, :] - p[:, -2, :]

    n = np.cross(dx.reshape(3, -1), dy.reshape(3, -1), axis=0)
    norm = np.linalg.norm(n, axis=0)
    n = np.where(norm > 0, n / np.maximum(norm, 1e-12), 0.0)

    # orient towards the camera (open3d orient_normals_towards_camera_location)
    to_cam = np.reshape(camera_location, (3, 1)) - np.asarray(points).reshape(3, -1)
    flip = np.sum(n * to_cam, axis=0) < 0
    n[:, flip] = -n[:, flip]
    return n


def knn_pca_normals(points, camera_location=(0, 0, 0), k=16):
    """kNN-PCA normals for unstructured clouds (open3d-equivalent fallback)."""
    from scipy.spatial import cKDTree

    pts = np.asarray(points).T  # (N, 3)
    n_pts = pts.shape[0]
    k = min(k, n_pts)
    tree = cKDTree(pts)
    _, idx = tree.query(pts, k=k)
    neigh = pts[idx]                            # (N, k, 3)
    centered = neigh - neigh.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", centered, centered) / k
    # smallest-eigenvalue eigenvector = normal
    _, vecs = np.linalg.eigh(cov)
    n = vecs[:, :, 0].T                          # (3, N)
    norm = np.linalg.norm(n, axis=0)
    n = np.where(norm > 0, n / np.maximum(norm, 1e-12), 0.0)
    to_cam = np.reshape(camera_location, (3, 1)) - np.asarray(points)
    flip = np.sum(n * to_cam, axis=0) < 0
    n[:, flip] = -n[:, flip]
    return n
