"""Untrimmed-video clip sampler for TSP / TAC pretraining: the data
behind gvl_tpu_torch.backbone.train_tsp.

A copy of gvl_tpu/backbone/untrimmed_dataset.py (framework-free numpy and
cv2; the port imports nothing of the JAX package), with its seeds and
RandomState streams unchanged, so that the batches are bit-equal
(reference video_backbone/TSP/train/untrimmed_video_dataset.py): a metadata
CSV of temporal segments [filename, fps, t-start, t-end, video-duration,
<label columns>]; segments too short for one clip are dropped; each
segment yields `clips_per_segment` fixed-length clips, placed by temporal
jittering (train) or uniform ratios (eval); missing labels map to -1
(masked in the loss); optional global video features (GVF) come from an h5
file (h5py) or a directory of .npy keyed by video basename. Clips are
decoded on the host with cv2 (the DataLoader workers' role): resize so the
short side is ~1.15 x the crop, random crop + horizontal flip (train) or
centre crop (eval), Kinetics mean / std normalisation. cv2 and h5py are
imported when first needed; where either is missing that raises an
ImportError naming it.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from gvl_tpu_torch.backbone.tsp import CLIP_MEAN, CLIP_STD, import_cv2


def read_metadata_csv(csv_filename: str, label_columns: Sequence[str]
                      ) -> List[Dict]:
    """Rows as dicts with float fps/t-start/t-end/video-duration."""
    rows = []
    with open(csv_filename, newline="") as f:
        for row in csv.DictReader(f):
            # generate_metadata_csv leaves fps/duration empty for videos
            # cv2 could not probe — skip those rows (the reference's
            # NaN rows fall out of its short-segment filter the same way)
            if not row.get("fps") or not row.get("video-duration"):
                print(f"skipping unprobeable video row: {row['filename']}")
                continue
            out = dict(filename=row["filename"], fps=float(row["fps"]),
                       t_start=float(row["t-start"]),
                       t_end=float(row["t-end"]),
                       duration=float(row["video-duration"]))
            for col in label_columns:
                out[col] = row.get(col, "")
            rows.append(out)
    return rows


def _decode_window(path: str, t_start: float, clip_length: int,
                   frame_rate: float, size: int) -> np.ndarray:
    """Decode `clip_length` frames at `frame_rate` starting at t_start (s),
    resized so min side = ceil(1.15*size) — crop happens in the transform.
    Returns (clip_length, h, w, 3) float32 RGB in [0, 1]."""
    cv2 = import_cv2()
    cap = cv2.VideoCapture(path)
    cap.set(cv2.CAP_PROP_POS_MSEC, max(t_start, 0.0) * 1000.0)
    src_fps = cap.get(cv2.CAP_PROP_FPS) or frame_rate
    # target source indices floor(t * src_fps / frame_rate): duplicates
    # frames when upsampling (src_fps < frame_rate), matching the
    # reference's _resample_video_idx index arithmetic
    step = src_fps / frame_rate
    targets = np.floor(np.arange(clip_length) * step).astype(int)
    want_set = set(targets.tolist())
    frames: List[np.ndarray] = []
    decoded: List[Optional[np.ndarray]] = []  # None for skipped frames
    while len(frames) < clip_length:
        want = int(targets[len(frames)])
        if want < len(decoded):
            if decoded[want] is None:
                break
            frames.append(decoded[want])
            continue
        ok, frame = cap.read()
        if not ok:
            break
        if len(decoded) in want_set:
            h, w = frame.shape[:2]
            scale = size * 1.15 / min(h, w)
            frame = cv2.resize(frame, (max(int(w * scale), size),
                                       max(int(h * scale), size)))
            decoded.append(frame[:, :, ::-1].astype(np.float32) / 255.0)
        else:
            decoded.append(None)
    cap.release()
    if not frames:
        s = int(size * 1.15)
        return np.zeros((clip_length, s, s, 3), np.float32)
    while len(frames) < clip_length:   # tail padding by repeat
        frames.append(frames[-1])
    return np.stack(frames)


class UntrimmedClipDataset:
    """CSV-driven clip sampler (see module docstring)."""

    def __init__(self, csv_filename: str, root_dir: str, clip_length: int,
                 frame_rate: float, clips_per_segment: int,
                 temporal_jittering: bool,
                 label_columns: Sequence[str],
                 label_mappings: Sequence[Dict[str, int]],
                 seed: int = 42, size: int = 112, train: bool = True,
                 global_video_features: Optional[str] = None,
                 check_files: bool = True):
        rows = read_metadata_csv(csv_filename, label_columns)
        # clamp segments into [0, duration]; drop those too short for a clip
        # (reference _clean_df_and_remove_short_segments)
        kept = []
        for r in rows:
            r["t_end"] = min(r["t_end"], r["duration"])
            r["t_start"] = max(r["t_start"], 0.0)
            if (r["t_end"] - r["t_start"]) * frame_rate >= clip_length:
                r["filename"] = os.path.join(root_dir, r["filename"])
                kept.append(r)
        if check_files:
            for r in kept:
                if not os.path.exists(r["filename"]):
                    raise ValueError(f"missing video file: {r['filename']}")
        self.rows = kept
        self.clip_length = clip_length
        self.frame_rate = frame_rate
        self.clips_per_segment = clips_per_segment
        self.temporal_jittering = temporal_jittering
        self.rng = np.random.RandomState(seed)
        self.uniform = np.linspace(0.0, 1.0, max(clips_per_segment, 1))
        self.label_columns = list(label_columns)
        self.label_mappings = list(label_mappings)
        self.size = size
        self.train = train
        self.gvf_source = global_video_features

    def __len__(self):
        return len(self.rows) * self.clips_per_segment

    def _gvf(self, filename: str) -> np.ndarray:
        key = os.path.basename(filename).split(".")[0]
        src = self.gvf_source
        if src.endswith(".h5") or src.endswith(".hdf5"):
            import h5py
            with h5py.File(src, "r") as f:
                return np.asarray(f[key][()], np.float32)
        return np.load(os.path.join(src, key + ".npy")).astype(np.float32)

    def example(self, idx: int,
                rng: Optional[np.random.RandomState] = None) -> Dict:
        rng = rng if rng is not None else self.rng
        row = self.rows[idx % len(self.rows)]
        clip_sec = self.clip_length / self.frame_rate
        ratio = rng.uniform() if self.temporal_jittering else \
            self.uniform[idx // len(self.rows)]
        t0 = row["t_start"] + ratio * max(
            row["t_end"] - row["t_start"] - clip_sec, 0.0)

        frames = _decode_window(row["filename"], t0, self.clip_length,
                                self.frame_rate, self.size)
        # transform: random/center crop + train-time hflip + normalize
        h, w = frames.shape[1:3]
        if self.train:
            y0 = rng.randint(0, h - self.size + 1)
            x0 = rng.randint(0, w - self.size + 1)
            if rng.rand() < 0.5:
                frames = frames[:, :, ::-1]
        else:
            y0, x0 = (h - self.size) // 2, (w - self.size) // 2
        clip = frames[:, y0:y0 + self.size, x0:x0 + self.size, :]
        clip = (clip - CLIP_MEAN) / CLIP_STD

        out = dict(clip=np.ascontiguousarray(clip, np.float32))
        for col, mapping in zip(self.label_columns, self.label_mappings):
            raw = row.get(col, "")
            out[col] = np.int32(mapping.get(raw, -1) if raw != "" else -1)
        if self.gvf_source:
            out["gvf"] = self._gvf(row["filename"])
        return out


def tsp_batches(dataset: UntrimmedClipDataset, batch_size: int,
                shuffle: bool = True, seed: int = 0,
                epochs: int = 1) -> Iterator[Dict]:
    """Fixed-shape batches for gvl_tpu_torch.backbone.train_tsp:
    {'clips' (B,T,H,W,3), 'labels' [per label column (B,)], 'gvf' (B,D)?}."""
    order_rng = np.random.RandomState(seed)
    n = len(dataset)
    for ep in range(epochs):
        order = np.arange(n)
        if shuffle:
            order_rng.shuffle(order)
        for i in range(0, n - batch_size + 1, batch_size):
            idxs = order[i:i + batch_size]
            exs = [dataset.example(
                int(j), np.random.RandomState((seed * 1000003 + ep * 8191
                                               + int(j)) % (2**31 - 1)))
                   for j in idxs]
            batch = dict(
                clips=np.stack([e["clip"] for e in exs]),
                labels=[np.stack([e[c] for e in exs])
                        for c in dataset.label_columns])
            if dataset.gvf_source:
                batch["gvf"] = np.stack([e["gvf"] for e in exs])
            yield batch
