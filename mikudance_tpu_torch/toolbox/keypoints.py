"""Keypoint vocabularies and skeleton edge lists (pose conditioning contract).

The port's own copy of ``mikudance_tpu/toolbox/keypoints.py``. These are the
data constants shared with the reference XPose (``predefined_keypoints.py:1,
45,179``): the 17-point COCO person, the 68-point face, and the 21-point hand,
with their edge lists. The skeleton-map renderers must use the same topology
and colors as the reference or the conditioning distribution shifts (the
reference's README warns the identical colormap must be used at inference).
"""

PERSON_KEYPOINTS = [
    "nose", "left eye", "right eye", "left ear", "right ear",
    "left shoulder", "right shoulder", "left elbow", "right elbow",
    "left wrist", "right wrist", "left hip", "right hip",
    "left knee", "right knee", "left ankle", "right ankle",
]

# 1-indexed (COCO convention, as in the reference)
PERSON_SKELETON = [
    [16, 14], [14, 12], [17, 15], [15, 13], [12, 13], [6, 12], [7, 13],
    [6, 7], [6, 8], [7, 9], [8, 10], [9, 11], [2, 3], [1, 2], [1, 3],
    [2, 4], [3, 5], [4, 6], [5, 7],
]

FACE_KEYPOINTS = (
    ["right cheekbone 1", "right cheekbone 2"]
    + [f"right cheek {i}" for i in range(1, 6)]
    + ["right chin", "chin center", "left chin"]
    + [f"left cheek {i}" for i in range(5, 0, -1)]
    + ["left cheekbone 2", "left cheekbone 1"]
    + [f"right eyebrow {i}" for i in range(1, 6)]
    + [f"left eyebrow {i}" for i in range(1, 6)]
    + [f"nasal bridge {i}" for i in range(1, 5)]
    + ["right nasal wing 1", "right nasal wing 2", "nasal wing center",
       "left nasal wing 1", "left nasal wing 2"]
    + ["right eye eye corner 1", "right eye upper eyelid 1",
       "right eye upper eyelid 2", "right eye eye corner 2",
       "right eye lower eyelid 2", "right eye lower eyelid 1"]
    + ["left eye eye corner 1", "left eye upper eyelid 1",
       "left eye upper eyelid 2", "left eye eye corner 2",
       "left eye lower eyelid 2", "left eye lower eyelid 1"]
    + ["right mouth corner"]
    + [f"upper lip outer edge {i}" for i in range(1, 6)]
    + ["left mouth corner"]
    + [f"lower lip outer edge {i}" for i in range(5, 0, -1)]
    + [f"upper lip inter edge {i}" for i in range(1, 6)]
    + [f"lower lip inter edge {i}" for i in range(3, 0, -1)]
)

FACE_SKELETON = [
    [0, 1], [2, 3], [3, 4], [4, 5], [5, 6], [7, 8], [8, 9], [10, 11],
    [11, 12], [12, 13], [13, 14], [15, 16], [17, 18], [18, 19], [19, 20],
    [20, 21], [22, 23], [23, 24], [24, 25], [25, 26], [27, 28], [28, 29],
    [29, 30], [30, 31], [30, 35], [36, 37], [37, 38], [38, 39], [39, 40],
    [40, 41], [36, 41], [42, 43], [43, 44], [44, 45], [45, 46], [46, 47],
    [42, 47], [48, 49], [49, 50], [50, 51], [51, 52], [52, 53], [53, 54],
    [54, 55], [55, 56], [56, 57], [57, 58], [58, 59], [59, 48], [48, 60],
    [60, 61], [61, 62], [62, 63], [63, 54], [54, 64], [64, 65], [65, 66],
    [66, 67], [67, 48],
]

HAND_KEYPOINTS = [
    "wrist",
    "thumb root", "thumb's third knuckle", "thumb's second knuckle",
    "thumb’s first knuckle",
    "forefinger's root", "forefinger's third knuckle",
    "forefinger's second knuckle", "forefinger's first knuckle",
    "middle finger's root", "middle finger's third knuckle",
    "middle finger's second knuckle", "middle finger's first knuckle",
    "ring finger's root", "ring finger's third knuckle",
    "ring finger's second knuckle", "ring finger's first knuckle",
    "pinky finger's root", "pinky finger's third knuckle",
    "pinky finger's second knuckle", "pinky finger's first knuckle",
]

HAND_SKELETON = [
    [0, 1], [1, 2], [2, 3], [3, 4], [0, 5], [5, 6], [6, 7], [7, 8],
    [0, 9], [9, 10], [10, 11], [11, 12], [0, 13], [13, 14], [14, 15],
    [15, 16], [0, 17], [17, 18], [18, 19], [19, 20],
]

# ---- render colormaps (the exact visual contract; inference_xpose_on_video.py:61-102)
POSE_KPT_COLORS = [
    [255, 255, 100]] * 5 + [
    [255, 0, 0], [160, 32, 240], [255, 0, 0], [160, 32, 240],
    [255, 0, 0], [160, 32, 240], [0, 255, 0], [51, 153, 255],
    [0, 255, 0], [51, 153, 255], [0, 255, 0], [51, 153, 255],
]

POSE_LINK_COLORS = [
    [0, 255, 0], [0, 255, 0], [51, 153, 255], [51, 153, 255],
    [255, 128, 0], [255, 128, 0], [255, 128, 0], [255, 128, 0],
    [255, 0, 0], [160, 32, 240], [255, 0, 0], [160, 32, 240],
    [255, 255, 100], [255, 255, 100], [255, 255, 100], [255, 255, 100],
    [255, 255, 100], [255, 255, 100], [255, 255, 100],
]


def face_kpt_color(name: str):
    """Name-rule colormap (inference_xpose_on_video.py:232-249), RGB in [0,1]."""
    if "cheekbone" in name:
        return (1.0, 1.0, 1.0)
    if "cheek" in name:
        return (0.0, 1.0, 1.0)
    if "chin" in name:
        return (1.0, 0.0, 1.0)
    if "eyebrow" in name:
        return (1.0, 1.0, 0.0)
    if "nasal" in name:
        return (1.0, 0.0, 0.0)
    if "eye" in name:
        return (0.0, 1.0, 0.0)
    if "lip" in name:
        return (0.0, 0.0, 1.0)
    return (1.0, 1.0, 1.0)


def hand_kpt_color(name: str):
    """Name-rule colormap (inference_xpose_on_video.py:342-358), RGB in [0,1]."""
    if "thumb" in name:
        return (0.0, 0.0, 1.0)
    if "forefinger" in name:
        return (0.0, 1.0, 0.0)
    if "middle" in name:
        return (1.0, 0.0, 0.0)
    if "ring" in name:
        return (1.0, 1.0, 0.0)
    if "pinky" in name:
        return (1.0, 0.0, 1.0)
    if "wrist" in name:
        return (0.0, 1.0, 1.0)
    return (1.0, 1.0, 1.0)
