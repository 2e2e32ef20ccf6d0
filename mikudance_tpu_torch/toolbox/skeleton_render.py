"""Skeleton-map renderers (pose / face / hand conditioning images).

The port's own copy of ``mikudance_tpu/toolbox/skeleton_render.py``, with
cv2 imported inside the drawing functions (importing this module needs no
cv2). Rebuilds the reference XPose's matplotlib renderers
(``inference_xpose_on_video.py:48-145`` pose, ``:146-302`` face,
``:303-423`` hand) with cv2 drawing on a black canvas (the video driver
renders on black, ``:1106``). The COLOR maps and topology are the visual
contract (the reference's README) and come from toolbox.keypoints; widths
replicate the reference's point sizes converted to pixels:

- pose links: matplotlib linewidth (13/1344)*min(W,H) pt at default 100 dpi
  -> px = pt * 100/72, round caps; pose keypoint markers are size 0 (unused).
- face/hand: white 2 pt lines and 4 pt colored dot markers at 108 dpi.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from . import keypoints as kp


def _px(points: np.ndarray, W: int, H: int) -> np.ndarray:
    """normalized (N, 2) [0,1] keypoints -> pixel coords."""
    return np.stack([points[:, 0] * W, points[:, 1] * H], axis=-1)


def _draw_line(canvas, p0, p1, color_rgb, width):
    import cv2

    cv2.line(
        canvas,
        (int(round(p0[0])), int(round(p0[1]))),
        (int(round(p1[0])), int(round(p1[1]))),
        tuple(int(c) for c in color_rgb),
        max(1, int(round(width))),
        lineType=cv2.LINE_AA,
    )


def render_pose(
    keypoints: np.ndarray,  # (17, 2) normalized, or (N_persons, 17, 2)
    width: int,
    height: int,
    canvas: Optional[np.ndarray] = None,
    visibility: Optional[np.ndarray] = None,
) -> np.ndarray:
    """17-keypoint body skeleton with the reference's per-link colormap."""
    if canvas is None:
        canvas = np.zeros((height, width, 3), np.uint8)
    persons = keypoints if keypoints.ndim == 3 else keypoints[None]
    lw = (13.0 / 1344.0) * min(width, height) * (100.0 / 72.0)
    for person in persons:
        pts = _px(person, width, height)
        for i, (a, b) in enumerate(kp.PERSON_SKELETON):
            if visibility is not None and not (visibility[a - 1] and visibility[b - 1]):
                continue
            _draw_line(canvas, pts[a - 1], pts[b - 1], kp.POSE_LINK_COLORS[i], lw)
    return canvas


def _draw_dots(canvas, pts, colors, r):
    import cv2

    for i, p in enumerate(pts):
        c = tuple(int(255 * v) for v in colors[i])
        cv2.circle(
            canvas, (int(round(p[0])), int(round(p[1]))), max(1, int(round(r))),
            c, -1, lineType=cv2.LINE_AA,
        )


def _render_dotted(
    keypoints, width, height, skeleton, colors, canvas, dot_pt=4.0, line_pt=2.0, dpi=108.0
):
    if canvas is None:
        canvas = np.zeros((height, width, 3), np.uint8)
    persons = keypoints if keypoints.ndim == 3 else keypoints[None]
    lw = line_pt * dpi / 72.0
    r = 0.5 * dot_pt * dpi / 72.0
    for person in persons:
        pts = _px(person, width, height)
        for a, b in skeleton:
            _draw_line(canvas, pts[a], pts[b], (255, 255, 255), lw)
        _draw_dots(canvas, pts, colors, r)
    return canvas


def render_face(
    keypoints: np.ndarray, width: int, height: int, canvas: Optional[np.ndarray] = None
) -> np.ndarray:
    """68-keypoint face: white contour lines + name-rule colored dots."""
    colors = [kp.face_kpt_color(n) for n in kp.FACE_KEYPOINTS]
    return _render_dotted(keypoints, width, height, kp.FACE_SKELETON, colors, canvas)


def render_hand(
    keypoints: np.ndarray, width: int, height: int, canvas: Optional[np.ndarray] = None
) -> np.ndarray:
    """21-keypoint hand(s): white bone lines + finger-rule colored dots."""
    colors = [kp.hand_kpt_color(n) for n in kp.HAND_KEYPOINTS]
    return _render_dotted(keypoints, width, height, kp.HAND_SKELETON, colors, canvas)


def render_generic(
    keypoints: np.ndarray,  # (K, 2) or (N, K, 2) normalized
    width: int,
    height: int,
    skeleton: Sequence[Sequence[int]],
    canvas: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Any open-vocabulary category (animal, car, clothing, ...): white
    skeleton lines + per-index rainbow dots. The reference has NO renderer for
    these categories — its image driver detects them but crashes at the render
    dispatch (`inference_xpose_on_image.py:670-685` leaves ``image_result``
    unbound for instances other than person/face/hand); this is the
    deliberate improvement that makes the full 28-category vocabulary usable.
    Skeletons use the category's edge list; the reference catalog mixes
    index conventions (person/animal/fly/locust are 1-indexed, face/hand/car
    are 0-indexed), detected here by whether the max index equals K. The
    clothing/furniture sets ship empty edge lists and render as dot clouds."""
    K = keypoints.shape[-2]
    if skeleton and max(max(e) for e in skeleton) >= K:
        skeleton = [[a - 1, b - 1] for a, b in skeleton]
    hues = np.linspace(0.0, 1.0, K, endpoint=False)
    colors = []
    for hch in hues:  # simple HSV->RGB ring, full saturation/value
        i = int(hch * 6.0) % 6
        f = hch * 6.0 - int(hch * 6.0)
        q, t = 1.0 - f, f
        colors.append(
            [(1, t, 0), (q, 1, 0), (0, 1, t), (0, q, 1), (t, 0, 1), (1, 0, q)][i]
        )
    return _render_dotted(keypoints, width, height, skeleton, colors, canvas)


# ---------------------------------------------------------------------------
# real-human variants: drive a 2D character from a real-human video
# (`inference_xpose_on_video.py:405-421` pose head widening,
# `:424-528` human pose, `:531-587` eye reshaping, `:590-755` human face)
# ---------------------------------------------------------------------------


def adjust_human_pose(x: np.ndarray, y: np.ndarray):
    """Anthropometric correction for anime proportions: widen ears/eyes x1.3
    about their centers, push the nose 1.2x from the eye line (`:405-421`).
    Operates in place on pixel coords of the 17 COCO keypoints."""
    for a, b, s in ((3, 4, 1.3), (1, 2, 1.3)):  # (left, right, scale) x only
        center = (x[a] + x[b]) / 2
        x[a] = (x[a] - center) * s + center
        x[b] = (x[b] - center) * s + center
    eye_cy = (y[1] + y[2]) / 2
    y[0] = (y[0] - eye_cy) * 1.2 + eye_cy
    return x, y


def render_human_pose(
    keypoints: np.ndarray, width: int, height: int,
    canvas: Optional[np.ndarray] = None,
) -> np.ndarray:
    """17-keypoint body skeleton from a real-human video, with the head-scale
    fix so anime characters track human proportions (`get_human_pose_image`)."""
    if canvas is None:
        canvas = np.zeros((height, width, 3), np.uint8)
    persons = keypoints if keypoints.ndim == 3 else keypoints[None]
    lw = (13.0 / 1344.0) * min(width, height) * (100.0 / 72.0)
    for person in persons:
        pts = _px(person, width, height)
        x, y = adjust_human_pose(pts[:, 0].copy(), pts[:, 1].copy())
        pts = np.stack([x, y], axis=-1)
        for i, (a, b) in enumerate(kp.PERSON_SKELETON):
            _draw_line(canvas, pts[a - 1], pts[b - 1], kp.POSE_LINK_COLORS[i], lw)
    return canvas


def adjust_human_eyes(x: np.ndarray, y: np.ndarray):
    """Reshape both eyes in the eye-axis frame: x1.2 along the eye line,
    x2.2 perpendicular (real-human eyes are much flatter than anime eyes,
    `adjust_human_eyes:531-587`). In place on the 68-pt face arrays."""

    def adjust(sl):
        ex, ey = x[sl], y[sl]
        ax_x = np.array([ex[3] - ex[0], ey[3] - ey[0]])
        n = np.linalg.norm(ax_x)
        if n < 1e-9:
            return
        ax_x = ax_x / n
        ax_y = np.array([-ax_x[1], ax_x[0]])
        m = np.stack([ax_x, ax_y]).T  # world <- eye basis
        pts = np.stack([ex, ey])  # (2, 6)
        local = m @ pts
        center = local.mean(axis=1, keepdims=True)
        local = center + (local - center) * np.array([[1.2], [2.2]])
        world = np.linalg.inv(m) @ local
        x[sl], y[sl] = world[0], world[1]

    adjust(slice(36, 42))
    adjust(slice(42, 48))
    return x, y


def render_human_face(
    keypoints: np.ndarray, width: int, height: int,
    canvas: Optional[np.ndarray] = None,
) -> np.ndarray:
    """68-keypoint face from a real-human video: whole-face 1.6x/1.2y scale
    about the centroid + eye reshaping (`get_human_face_image:590-755`).
    Mirrors the reference's multi-face bail-out (blank canvas if >1 face)."""
    if canvas is None:
        canvas = np.zeros((height, width, 3), np.uint8)
    persons = keypoints if keypoints.ndim == 3 else keypoints[None]
    if len(persons) > 1:  # reference refuses ambiguous multi-face frames
        return canvas
    colors = [kp.face_kpt_color(n) for n in kp.FACE_KEYPOINTS]
    lw = 2.0 * 108.0 / 72.0
    r = 0.5 * 4.0 * 108.0 / 72.0
    for person in persons:
        pts = _px(person, width, height)
        x, y = pts[:, 0].copy(), pts[:, 1].copy()
        cx, cy = x.mean(), y.mean()
        x = x * 1.6
        y = y * 1.2
        x += cx - x.mean()
        y += cy - y.mean()
        adjust_human_eyes(x, y)
        pts = np.stack([x, y], axis=-1)
        for a, b in kp.FACE_SKELETON:
            _draw_line(canvas, pts[a], pts[b], (255, 255, 255), lw)
        _draw_dots(canvas, pts, colors, r)
    return canvas
