"""Host-side video decode and CLIP preprocessing; a copy of
``univtg_tpu/extract/video.py``.

Decoding stays on the host CPU: one ffmpeg subprocess per video emits
rawvideo frames already resized so that the short side is 224 and
center-croppable, at one frame per feature clip; without an ffmpeg binary
OpenCV decodes instead. cv2 and shutil are imported where they are used, so
importing this module needs neither.
"""
from __future__ import annotations

import json
import subprocess
from typing import Optional, Tuple

import numpy as np

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def probe_video(path: str) -> dict:
    """Stream metadata via ffprobe (duration, fps, width, height)."""
    cmd = [
        "ffprobe",
        "-v",
        "error",
        "-select_streams",
        "v:0",
        "-show_entries",
        "stream=width,height,avg_frame_rate,duration",
        "-show_entries",
        "format=duration",
        "-of",
        "json",
        path,
    ]
    info = json.loads(subprocess.run(cmd, capture_output=True, check=True).stdout)
    stream = info["streams"][0]
    dur = stream.get("duration") or info.get("format", {}).get("duration")
    num, den = stream["avg_frame_rate"].split("/")
    fps = float(num) / float(den) if float(den) else 0.0
    return {
        "width": int(stream["width"]),
        "height": int(stream["height"]),
        "fps": fps,
        "duration": float(dur) if dur else None,
    }


def _have_ffmpeg() -> bool:
    import shutil

    return shutil.which("ffmpeg") is not None and shutil.which("ffprobe") is not None


def decode_frames(
    path: str,
    clip_len: float = 2.0,
    size: int = 224,
    center_crop: bool = True,
    max_frames: Optional[int] = None,
    backend: str = "auto",
) -> Tuple[np.ndarray, dict]:
    """Decode one frame per clip_len seconds, short side scaled to `size`,
    center-cropped to (size, size). Returns ((T, size, size, 3) uint8, meta).

    backend: "ffmpeg" (subprocess pipe, the reference's approach), "cv2"
    (OpenCV, used when no ffmpeg binary is installed), or "auto".
    """
    if backend == "auto":
        backend = "ffmpeg" if _have_ffmpeg() else "cv2"
    if backend == "cv2":
        return _decode_frames_cv2(path, clip_len, size, center_crop, max_frames)
    meta = probe_video(path)
    fps_filter = 1.0 / clip_len
    if meta["duration"] is not None and meta["duration"] < clip_len:
        fps_filter = 1.0 / max(meta["duration"], 1e-3)  # short-video fallback
    vf = (
        f"fps={fps_filter},"
        f"scale='if(gt(iw,ih),-2,{size})':'if(gt(iw,ih),{size},-2)':flags=bilinear"
    )
    if center_crop:
        vf += f",crop={size}:{size}"
    cmd = [
        "ffmpeg",
        "-nostdin",
        "-i",
        path,
        "-vf",
        vf,
        "-f",
        "rawvideo",
        "-pix_fmt",
        "rgb24",
        "-v",
        "error",
        "pipe:1",
    ]
    raw = subprocess.run(cmd, capture_output=True, check=True).stdout
    n = len(raw) // (size * size * 3)
    frames = np.frombuffer(raw[: n * size * size * 3], np.uint8).reshape(
        n, size, size, 3
    )
    if max_frames is not None:
        frames = frames[:max_frames]
    return frames, meta


def _resize_crop(frame: np.ndarray, size: int, center_crop: bool) -> np.ndarray:
    import cv2

    h, w = frame.shape[:2]
    if w > h:
        new_w, new_h = max(size, int(round(w * size / h))), size
    else:
        new_w, new_h = size, max(size, int(round(h * size / w)))
    frame = cv2.resize(frame, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
    if center_crop:
        y0 = (new_h - size) // 2
        x0 = (new_w - size) // 2
        frame = frame[y0 : y0 + size, x0 : x0 + size]
    return frame


def _decode_frames_cv2(path, clip_len, size, center_crop, max_frames):
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise OSError(f"cannot open video {path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    n_frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    duration = n_frames / fps if fps else None
    step = clip_len
    if duration is not None and duration < clip_len:
        step = max(duration, 1e-3)  # short-video fallback (video_loader.py:93-97)

    # frame indices at t = 0, step, 2*step, ... (ffmpeg fps-filter sampling)
    want = []
    t = 0.0
    while duration is None or t < duration:
        idx = int(round(t * fps))
        if idx >= n_frames:
            break
        want.append(idx)
        t += step
        if max_frames is not None and len(want) >= max_frames:
            break

    frames = []
    want_set = set(want)
    idx = 0
    ok, frame = cap.read()
    while ok and (not want or idx <= want[-1]):
        if idx in want_set:
            rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            frames.append(_resize_crop(rgb, size, center_crop))
        idx += 1
        ok, frame = cap.read()
    cap.release()
    meta = {"fps": fps, "duration": duration, "width": None, "height": None}
    return np.stack(frames) if frames else np.zeros((0, size, size, 3), np.uint8), meta


def preprocess_frames(frames: np.ndarray) -> np.ndarray:
    """uint8 (T, H, W, 3) -> float32 normalized with CLIP mean/std
    (preprocessing.py:15-25)."""
    x = frames.astype(np.float32) / 255.0
    return (x - CLIP_MEAN) / CLIP_STD
