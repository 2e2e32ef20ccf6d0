"""Camera-trajectory utilities (DROID-SLAM post-processing).

The port's own copy of ``mikudance_tpu/toolbox/camera.py`` (numpy only).
Rebuilds the math of the reference's SLAM wrapper
(``DROID-SLAM/get_camera_from_video.py``): keyframe poses (tx ty tz qx qy qz
qw-style quaternion layout as produced by the tracker) are interpolated to
every frame (linear positions, SLERP quaternions, ``:273-331``), converted to
4x4 w2c matrices + inverses (``:437-446``), and exported as npy plus a
camera-frustum OBJ visualization (``cam_pose_vis:25``). The SLAM tracker
itself stays external, as it does in the reference.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np


def slerp_quat(t: float, q0: np.ndarray, q1: np.ndarray) -> np.ndarray:
    """SLERP between two quaternions with antipodal correction (`:238-270`)."""
    q0 = q0 / np.linalg.norm(q0)
    q1 = q1 / np.linalg.norm(q1)
    dot = float(np.dot(q0, q1))
    if dot < 0.0:
        q1, dot = -q1, -dot
    if dot > 0.9995:
        out = q0 + t * (q1 - q0)
        return out / np.linalg.norm(out)
    theta = np.arccos(dot) * t
    q2 = q1 - q0 * dot
    q2 = q2 / np.linalg.norm(q2)
    return q0 * np.cos(theta) + q2 * np.sin(theta)


def interpolate_camera_poses(
    steps: np.ndarray,  # (K,) keyframe timestamps
    poses: np.ndarray,  # (K, 7) [tx ty tz, quaternion(4)]
    total_length: int,
) -> np.ndarray:
    """Per-frame poses: linear positions + SLERP quaternions (`:273-331`)."""
    steps = np.asarray(steps, np.float64)
    positions = poses[:, :3]
    quats = poses[:, 3:]
    new_steps = np.arange(total_length)

    interp_pos = np.stack(
        [
            np.interp(new_steps, steps, positions[:, i],
                      left=positions[0, i], right=positions[-1, i])
            for i in range(3)
        ],
        axis=-1,
    )

    out_q = []
    for t in new_steps:
        idx = int(np.searchsorted(steps, t, side="right"))
        if idx == 0:
            out_q.append(quats[0])
        elif idx == len(steps):
            out_q.append(quats[-1])
        else:
            t0, t1 = steps[idx - 1], steps[idx]
            out_q.append(slerp_quat((t - t0) / (t1 - t0), quats[idx - 1], quats[idx]))
    return np.hstack([interp_pos, np.asarray(out_q)])


def quat_to_rotation(q: np.ndarray) -> np.ndarray:
    """Unit quaternion (w, x, y, z) -> 3x3 rotation matrix."""
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def poses_to_matrices(poses: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(T, 7) pose vectors -> (w2c (T,4,4), c2w (T,4,4)) (`:437-446`).

    DROID stores quaternions (x, y, z, w); reorder for quat_to_rotation.
    """
    w2cs, c2ws = [], []
    for p in poses:
        m = np.eye(4)
        qx, qy, qz, qw = p[3:7]
        m[:3, :3] = quat_to_rotation(np.array([qw, qx, qy, qz]))
        m[:3, 3] = p[:3]
        w2cs.append(m)
        c2ws.append(np.linalg.inv(m))
    return np.stack(w2cs), np.stack(c2ws)


def camera_frustum_obj(path: str, w2cs: Sequence[np.ndarray], scale: float = 0.1) -> None:
    """Write a wireframe-frustum OBJ of the trajectory (`cam_pose_vis:25`)."""
    verts, lines = [], []
    corners = np.array(
        [[0, 0, 0], [-1, -1, 2], [1, -1, 2], [1, 1, 2], [-1, 1, 2]], np.float64
    ) * scale
    edges = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
    for w2c in w2cs:
        c2w = np.linalg.inv(w2c)
        base = len(verts)
        pts = (c2w[:3, :3] @ corners.T).T + c2w[:3, 3]
        verts.extend(pts.tolist())
        lines.extend([(base + a + 1, base + b + 1) for a, b in edges])
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for a, b in lines:
            f.write(f"l {a} {b}\n")


def export_camera_files(
    out_dir: str, name: str, keyframe_steps, keyframe_poses, num_frames: int
) -> Tuple[str, str]:
    """Full post-processing: interpolate, convert, save npys + OBJ."""
    poses = interpolate_camera_poses(keyframe_steps, keyframe_poses, num_frames)
    w2c, c2w = poses_to_matrices(poses)
    os.makedirs(os.path.join(out_dir, name), exist_ok=True)
    w2c_path = os.path.join(out_dir, name, f"w2c-{name}.npy")
    c2w_path = os.path.join(out_dir, name, f"c2w-{name}.npy")
    np.save(w2c_path, w2c)
    np.save(c2w_path, c2w)
    np.save(os.path.join(out_dir, name, f"cps-{name}.npy"), poses)
    camera_frustum_obj(os.path.join(out_dir, name, f"cam-{name}.obj"), w2c)
    return w2c_path, c2w_path
