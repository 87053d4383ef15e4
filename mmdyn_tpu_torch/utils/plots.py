"""Pose triad figures (the port's copy of ``mmdyn_tpu/utils/plots.py``;
reference mmdyn/pytorch/utils/plots.py): the TensorBoard grids of
``--vis-pose`` and ``plot_pose``'s per-sequence figure files.

3-D RGB-axes renders of predicted against target poses. The reference reads
the stored xyzw quaternion as wxyz (pyquaternion's argument order); that is
kept, so the figures look the same. scipy and matplotlib are imported when a
figure is drawn.
"""

from __future__ import annotations

import os

import numpy as np


def _rotate(quaternion, vectors):
    """Rotate (N, 3) vectors by a quaternion interpreted as wxyz
    (pyquaternion argument order, plots.py:92)."""
    from scipy.spatial.transform import Rotation
    w, x, y, z = quaternion[0], quaternion[1], quaternion[2], quaternion[3]
    norm = np.sqrt(w * w + x * x + y * y + z * z)
    if norm == 0:
        return np.asarray(vectors)
    r = Rotation.from_quat([x / norm, y / norm, z / norm, w / norm])
    return r.apply(np.asarray(vectors))


def plot_lines(position, quaternion, lines):
    """Draw the rotated RGB axis triad into 3 line artists (plots.py:88-99)."""
    startpoints = np.array([position, position, position])
    endpoints = np.array([position + np.array([2, 0, 0]),
                          position + np.array([0, 2, 0]),
                          position + np.array([0, 0, 2])])
    starts = _rotate(quaternion, startpoints)
    ends = _rotate(quaternion, endpoints)
    for line, start, end in zip(lines, starts, ends):
        line.set_data([start[0], end[0]], [start[1], end[1]])
        line.set_3d_properties([start[2], end[2]])


def _triad_axes(fig, n_rows, n_cols, index, axis_lim):
    ax = fig.add_subplot(n_rows, n_cols, index, projection="3d")
    ax.set_xlabel("X")
    ax.set_ylabel("Y")
    ax.set_zlabel("Z")
    ax.set_xlim((-axis_lim, axis_lim))
    ax.set_ylim((-axis_lim, axis_lim))
    ax.set_zlim((-axis_lim, axis_lim))
    return ax


def plot_pose_tensorboard(pose_1=np.array([[0, 0, 0, 1, 0, 0, 0]]),
                          pose_2=np.array([[0, 0, 0, 1, 0, 0, 0]]),
                          axis_lim=2, normalized_quaternions=True, show=False,
                          seq_length=30):
    """Grid of predicted (solid) vs target (dashed) triads (plots.py:9-48)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pose_1, pose_2 = np.array(pose_1), np.array(pose_2)
    positions_1, quaternions_1 = pose_1[:, :3], pose_1[:, 3:]
    positions_2, quaternions_2 = pose_2[:, :3], pose_2[:, 3:]
    if normalized_quaternions:
        quaternions_1 = 2 * quaternions_1 - 1
        quaternions_2 = 2 * quaternions_2 - 1

    n_rows = max(1, -(-len(positions_1) // seq_length))  # ceil: a
    # non-multiple pose count must not overflow the subplot grid
    fig = plt.figure(figsize=(3 * seq_length, 3 * n_rows))
    for i in range(len(positions_1)):
        ax = _triad_axes(fig, n_rows, seq_length, i + 1, axis_lim)
        colors = ["r", "g", "b"]
        lines_1 = sum([ax.plot([], [], [], c=c, linestyle="-", linewidth=2)
                       for c in colors], [])
        lines_2 = sum([ax.plot([], [], [], c=c, linestyle="--", linewidth=2)
                       for c in colors], [])
        plot_lines(positions_1[i], quaternions_1[i], lines_1)
        plot_lines(positions_2[i], quaternions_2[i], lines_2)
    fig.canvas.draw()
    if show:
        plt.show()
    return fig


def plot_single_pose_tensorboard(pose=np.array([[0, 0, 0, 1, 0, 0, 0]]),
                                 axis_lim=2, normalized_quaternions=True,
                                 show=False, seq_length=20):
    """Grid of single-pose triads (plots.py:51-85)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pose = np.array(pose)
    positions, quaternions = pose[:, :3], pose[:, 3:]
    if normalized_quaternions:
        quaternions = 2 * quaternions - 1

    n_rows = max(1, -(-len(positions) // seq_length))  # ceil (see above)
    fig = plt.figure(figsize=(3 * seq_length, 3 * n_rows))
    for i in range(len(positions)):
        ax = _triad_axes(fig, n_rows, seq_length, i + 1, axis_lim)
        colors = ["r", "g", "b"]
        lines = sum([ax.plot([], [], [], c=c, linestyle="-", linewidth=2)
                     for c in colors], [])
        plot_lines(positions[i], quaternions[i], lines)
    fig.canvas.draw()
    if show:
        plt.show()
    return fig


def plot_pose(output, target, plot_dir, title, show=False, seq_length=30,
              axis_lim=2, normalized_quaternions=True, sv=False):
    """Per-sequence figure files of output-vs-target triads
    (plots.py:102-184): ``plot_dir/<title>_<i>.png`` for each whole sequence
    of ``seq_length`` rows. ``output`` / ``target`` are (N, 7) arrays."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pose_1 = np.asarray(output)
    pose_2 = np.asarray(target)
    positions_1, quaternions_1 = pose_1[:, :3], pose_1[:, 3:]
    positions_2, quaternions_2 = pose_2[:, :3], pose_2[:, 3:]
    if normalized_quaternions:
        quaternions_1 = 2 * quaternions_1 - 1
        quaternions_2 = 2 * quaternions_2 - 1

    for i in range(len(positions_1) // seq_length):
        fig = plt.figure(figsize=(seq_length, 1))
        plt.subplots_adjust(top=0.98, right=0.98, left=0.02, bottom=0.1,
                            wspace=0.1, hspace=0.01)
        for j in range(seq_length):
            ax = fig.add_subplot(1, seq_length, j + 1, projection="3d")
            ax.set_xlim((-axis_lim, axis_lim))
            ax.set_ylim((-axis_lim, axis_lim))
            ax.set_zlim((-axis_lim, axis_lim))
            ax.tick_params(axis="both", labelbottom=False, labelleft=False,
                           labelright=False, labeltop=False)
            colors = ["r", "g", "b"]
            lines_1 = sum([ax.plot([], [], [], c=c, linestyle="-", linewidth=2)
                           for c in colors], [])
            lines_2 = sum([ax.plot([], [], [], c=c, linestyle="--", linewidth=2)
                           for c in colors], [])
            idx = i * seq_length + j
            plot_lines(positions_1[idx, :], quaternions_1[idx, :], lines_1)
            plot_lines(positions_2[idx, :], quaternions_2[idx, :], lines_2)
        fig.canvas.draw()
        if show:
            plt.show()
        fig.savefig(os.path.join(plot_dir, title + "_" + str(i)), dpi=300)
        plt.close(fig)
