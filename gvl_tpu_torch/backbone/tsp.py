"""TSP clip-feature extraction from raw video, one `.npy` per video.

Port of gvl_tpu/backbone/tsp.py (reference video_backbone/TSP/
extract_features): each video is decoded with cv2 to 15 fps 112 x 112
centre crops, normalised by the Kinetics mean and std, cut into 16-frame
clips (the last one padded with its final frame), and its clips' features
(n_clips, 512) are written to `<out_dir>/<video name>.npy`; the video list
is split across jobs by num_shards / shard_id, and a video whose file
exists is skipped. `extract_clip_features` is the forward of one video's
clips, which a caller with decoded frames drives directly.

The weights come from `checkpoint`: a released TSP / TAC or torchvision
`.pth` (its fc heads stripped, a wrong architecture refused), or the
`backbone.pth` that `python -m gvl_tpu_torch.import_cli --backbone` writes.
Without one, extraction runs from a random init and says so. cv2 is read
only when a video is decoded: where it is not installed,
`decode_video_frames` raises an ImportError naming it. The model runs on
the card unless `device="cpu"` is given.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from gvl_tpu_torch.backbone.r2plus1d import TSPModel, init_backbone_params

CLIP_MEAN = np.array([0.43216, 0.394666, 0.37645], np.float32)
CLIP_STD = np.array([0.22803, 0.22145, 0.216989], np.float32)
BACKBONE_FILE = "backbone.pth"


def import_cv2():
    """cv2, or an ImportError that names it and says what to do instead."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "decoding video needs OpenCV (the cv2 module), which is not "
            "installed here: decode the frames where it is and call "
            "extract_clip_features on them") from e
    return cv2


def decode_video_frames(path: str, fps: float = 15.0, size: int = 112,
                        max_frames: int = 100000) -> np.ndarray:
    """Decode to (T, size, size, 3) float32 RGB in [0, 1] at `fps`: each
    taken frame resized so its short side is 1.15 x size, then centre
    cropped (tsp.py:27-56)."""
    cv2 = import_cv2()
    cap = cv2.VideoCapture(path)
    src_fps = cap.get(cv2.CAP_PROP_FPS) or fps
    step = max(src_fps / fps, 1e-6)
    frames = []
    idx, next_take = 0, 0.0
    while len(frames) < max_frames:
        ok, frame = cap.read()
        if not ok:
            break
        if idx >= next_take:
            h, w = frame.shape[:2]
            scale = size * 1.15 / min(h, w)
            frame = cv2.resize(frame, (int(w * scale), int(h * scale)))
            h, w = frame.shape[:2]
            y0, x0 = (h - size) // 2, (w - size) // 2
            crop = frame[y0:y0 + size, x0:x0 + size, ::-1]  # BGR -> RGB
            frames.append(crop.astype(np.float32) / 255.0)
            next_take += step
        idx += 1
    cap.release()
    if not frames:
        return np.zeros((0, size, size, 3), np.float32)
    return np.stack(frames)


def make_clips(frames: np.ndarray, clip_len: int = 16,
               stride: int = 16) -> np.ndarray:
    """(T, H, W, C) -> (n_clips, clip_len, H, W, C), a clip starting every
    `stride` frames, the last padded by repeating its final frame."""
    T = len(frames)
    if T == 0:
        return np.zeros((0, clip_len) + frames.shape[1:], np.float32)
    clips = []
    for s in range(0, T, stride):
        c = frames[s:s + clip_len]
        if len(c) < clip_len:
            c = np.concatenate([c, np.repeat(c[-1:], clip_len - len(c), 0)])
        clips.append(c)
    return np.stack(clips)


def resolve_device(device) -> torch.device:
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("TSP backbone: no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    return torch.device(device or "cuda")


def load_backbone_checkpoint(checkpoint: str, model: TSPModel) -> None:
    """Load extraction weights into `model.features`, in place: a raw
    `.pth` (fc heads stripped) or import_cli's backbone.pth. A checkpoint
    of another architecture, or one that leaves any backbone tensor
    unfilled or unused, is refused (tsp.py:59-98)."""
    from gvl_tpu_torch.backbone.import_torch import load_tsp_checkpoint
    backbone = model.features.arch
    sd, unused, unfilled = load_tsp_checkpoint(checkpoint, backbone)
    if unused or unfilled:
        raise ValueError(
            f"checkpoint {checkpoint!r} does not match backbone={backbone!r}:"
            f" {len(unused)} torch tensors unmapped {unused[:5]}, backbone "
            f"tensors left at init {unfilled[:5]}")
    model.features.load_state_dict(sd, strict=True)


def build_extractor(backbone: str = "r2plus1d_34",
                    checkpoint: Optional[str] = None,
                    device=None) -> TSPModel:
    """The extraction model (one 200-way head, unused), in eval mode on
    `device` (the card by default), with the checkpoint's weights, else a
    random init from seed 0 and a warning."""
    dev = resolve_device(device)
    model = TSPModel((200,), backbone, device=dev)
    if checkpoint:
        load_backbone_checkpoint(checkpoint, model)
    else:
        init_backbone_params(model, torch.Generator(device=dev).manual_seed(0))
        print("WARNING: extracting features from RANDOM-INIT backbone "
              "(pass checkpoint= a converted TSP/TAC backbone.pth or .pth)")
    return model.eval()


@torch.no_grad()
def extract_clip_features(model: TSPModel, clips: np.ndarray,
                          batch_size: int = 8) -> np.ndarray:
    """The backbone's features (n_clips, 512) of normalised clips
    (n_clips, T, H, W, 3), `batch_size` at a time on the model's device,
    in eval mode. A last short chunk runs as it is: in eval mode a clip's
    feature does not depend on the others in its chunk."""
    dev = next(model.parameters()).device
    was_training = model.training
    model.eval()
    try:
        feats = [model.features(torch.from_numpy(
            np.ascontiguousarray(clips[i:i + batch_size])).to(dev)).cpu()
            for i in range(0, len(clips), batch_size)]
    finally:
        model.train(was_training)
    return torch.cat(feats).numpy()


def extract_features(video_paths: Sequence[str], out_dir: str,
                     model: Optional[TSPModel] = None, batch_size: int = 8,
                     clip_len: int = 16, stride: int = 16, fps: float = 15.0,
                     num_shards: int = 1, shard_id: int = 0,
                     backbone: str = "r2plus1d_34",
                     checkpoint: Optional[str] = None,
                     device=None) -> List[str]:
    """Sharded sliding-window extraction (tsp.py:101-175): the videos of
    shard `shard_id` of `num_shards` (of the sorted list), each decoded,
    normalised, cut into clips and written as `<out_dir>/<name>.npy`
    (n_clips, 512); a video whose file exists, or that decodes to no
    frame, is skipped. `model` (a TSPModel) or one built by
    build_extractor(backbone, checkpoint, device). Returns the paths
    written."""
    if model is None:
        model = build_extractor(backbone, checkpoint, device)
    os.makedirs(out_dir, exist_ok=True)
    shard = [p for i, p in enumerate(sorted(video_paths))
             if i % num_shards == shard_id]
    written = []
    for path in shard:
        key = os.path.splitext(os.path.basename(path))[0]
        out_path = os.path.join(out_dir, key + ".npy")
        if os.path.exists(out_path):
            continue
        frames = (decode_video_frames(path, fps=fps) - CLIP_MEAN) / CLIP_STD
        clips = make_clips(frames, clip_len, stride)
        if len(clips) == 0:
            continue
        np.save(out_path, extract_clip_features(model, clips, batch_size))
        written.append(out_path)
    return written
