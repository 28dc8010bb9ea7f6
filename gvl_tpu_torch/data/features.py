"""Per-video feature loading: 12 feature-type conventions, normalization
constants, temporal rescaling, and zero-padding for missing files.

Behavioral spec: reference video_dataset.py:305-397 (read_file / get_feats /
resizeFeature). Filename conventions and normalization constants are data
contracts and preserved verbatim; the interpolation matches scipy interp1d
with nearest/linear kinds over x_new = i*(T0-1)/(T1-1).

The port's copy of gvl_tpu/data/features.py, on the numpy path only. Where
the JAX package reads a fixed-length .npy feature with its C++ loader
(gvl_tpu/native/feature_loader.cpp), the port reads it with numpy and
computes what that loader computes: normalisation and the linear blend in
float32, the blend's weight rounded to float32 (`_resize_rows_f32`), so the
arrays are the same.
"""

from __future__ import annotations

import os
import pickle
from typing import Tuple

import numpy as np

# feature type -> (dim, mean, var, filename builder)
_FEAT_SPECS = {
    "c3d":      (500, -0.001915027447565527, 1.9239444588254049,
                 lambda k: k[0:13] + ".npy"),
    "c3d4096":  (4096, 0.0, 1.0, lambda k: k + ".npy"),
    "resnet":   (2048, 0.41634243404998694, 0.2569392081183313,
                 lambda k: k[2:13] + "_resnet.npy"),
    "bn":       (1024, 0.8945046635916155, 3.6579982046018844,
                 lambda k: k[2:13] + "_bn.npy"),
    "tsn_100":  (400, 0.0, 1.0, lambda k: k[0:13] + ".csv"),
    "i3d_rgb":  (1024, 0.0, 1.0, lambda k: k[:13] + "_rgb.npy"),
    "i3d_flow": (1024, 0.0, 1.0, lambda k: k[:13] + "_flow.npy"),
    "tsp":      (512, 0.0, 1.0, lambda k: k[0:13] + ".npy"),
    "swin":     (1024, 0.0, 1.0, lambda k: k[0:13] + ".npy"),
    "vggish":   (128, 0.0, 1.0, lambda k: k[0:13] + ".npy"),
    "clip_pkl": (768, 0.0, 1.0, lambda k: k[0:11] + ".pkl"),
    "clip":     (768, 0.0, 1.0, lambda k: k[0:13] + ".npy"),
}


def read_feature_file(path: str, feat_dim: int, mean: float = 0.0,
                      var: float = 1.0, data_norm: bool = False
                      ) -> Tuple[np.ndarray, bool]:
    """Load one feature file; missing files become (100, dim) zeros with a
    padding flag (reference: video_dataset.py:305-325)."""
    if os.path.exists(path):
        ext = path.split(".")[-1]
        if ext == "npy":
            feats = np.load(path)
        elif ext == "csv":
            import pandas as pd
            feats = pd.read_csv(path).values
        elif ext == "pkl":
            with open(path, "rb") as f:
                feats = pickle.load(f)
        else:
            raise NotImplementedError(ext)
        padding = False
    else:
        feats = np.zeros((100, feat_dim))
        padding = True
    if data_norm:
        feats = (feats - mean) / np.sqrt(var)
    return np.asarray(feats, dtype=np.float32), padding


def get_feats(key: str, vf_type: str, vf_folder: str, data_norm: bool = False
              ) -> Tuple[np.ndarray, bool]:
    if vf_type == "npy":
        # generic convention (tests/synthetic data): <key>.npy, any dim
        path = os.path.join(vf_folder, key + ".npy")
        feats, padding = read_feature_file(path, 1, data_norm=data_norm)
        return feats, padding
    if vf_type not in _FEAT_SPECS:
        raise AssertionError(f"feature type error: {vf_type}")
    dim, mean, var, namer = _FEAT_SPECS[vf_type]
    path = os.path.join(vf_folder, namer(key))
    feats, padding = read_feature_file(path, dim, mean, var, data_norm)
    assert feats.ndim == 2 and feats.shape[1] == dim, \
        f"load {path} error, got shape {feats.shape}"
    return feats, padding


def resize_feature(x: np.ndarray, new_size: int,
                   method: str = "nearest") -> np.ndarray:
    """Temporal rescale to new_size frames via 1-D interpolation over
    x_new[i] = i*(T0-1)/(T1-1) (reference: resizeFeature,
    video_dataset.py:386-397). Length-1 inputs are tiled."""
    t0 = len(x)
    if t0 == 1:
        return np.repeat(np.reshape(x, (1, -1)), new_size, axis=0)
    x = np.asarray(x)
    pos = np.arange(new_size, dtype=np.float64) * (t0 - 1) / (new_size - 1)
    if method == "nearest":
        # scipy interp1d 'nearest' rounds half-integers DOWN (left neighbor):
        # searchsorted over midpoints with side='left'
        idx = np.searchsorted(np.arange(t0 - 1) + 0.5, pos, side="left")
        return x[idx]
    if method == "linear":
        lo = np.floor(pos).astype(np.int64)
        hi = np.minimum(lo + 1, t0 - 1)
        w = (pos - lo)[:, None]
        return (x[lo] * (1 - w) + x[hi] * w).astype(x.dtype)
    raise ValueError(method)


def feature_path(key: str, vf_type: str, vf_folder: str) -> Tuple[str, int, float, float]:
    """(path, dim, mean, var) for a feature type; dim<0 = unchecked ('npy')."""
    if vf_type == "npy":
        return os.path.join(vf_folder, key + ".npy"), -1, 0.0, 1.0
    dim, mean, var, namer = _FEAT_SPECS[vf_type]
    return os.path.join(vf_folder, namer(key)), dim, mean, var


def _resize_rows_f32(x: np.ndarray, new_size: int,
                     method: str = "nearest") -> np.ndarray:
    """resize_feature as the JAX package's C++ loader computes it
    (feature_loader.cpp resize_rows): positions in float64, the linear
    blend's weight rounded to float32 and the blend in float32."""
    t0 = len(x)
    if t0 == 1:
        return np.repeat(x, new_size, axis=0)
    pos = np.arange(new_size, dtype=np.float64) * (t0 - 1) / (new_size - 1)
    if method == "nearest":
        return x[np.clip(np.ceil(pos - 0.5).astype(np.int64), 0, t0 - 1)]
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, t0 - 1)
    w = (pos - lo).astype(np.float32)[:, None]
    return x[lo] * (np.float32(1) - w) + x[hi] * w


def _read_npy_rows(path: str, dim: int):
    """A .npy file as the C++ loader reads it (feature_loader.cpp
    load_npy_f32): little-endian f4 or f8 in C order, a 1-D array as one
    row; float32 (rows, dim) with rows >= 1, or None for any other file."""
    raw = np.load(path)
    if raw.dtype not in (np.dtype("<f4"), np.dtype("<f8")) or \
            not raw.flags.c_contiguous or raw.ndim not in (1, 2):
        return None
    raw = raw if raw.ndim == 2 else raw[None]
    if raw.shape[1] != dim or raw.shape[0] < 1:
        return None
    return raw.astype(np.float32)


def _load_single_rescaled(key: str, vf_type: str, vf_folder: str,
                          expect_dim: int, rescale_len: int,
                          sample_method: str, data_norm: bool
                          ) -> Tuple[np.ndarray, bool]:
    """One feature file at a fixed output length. A .npy file is read and
    resized as the JAX package's C++ loader does it; a missing one is
    zeros; other files go through get_feats and resize_feature."""
    path, dim, mean, var = feature_path(key, vf_type, vf_folder)
    dim = expect_dim if dim < 0 else dim
    if path.endswith(".npy"):
        if not os.path.exists(path):
            return np.zeros((rescale_len, dim), np.float32), True
        feats = _read_npy_rows(path, dim)
        if feats is not None:
            if data_norm:
                inv = np.float32(1) / np.sqrt(np.float32(var))
                feats = (feats - np.float32(mean)) * inv
            if feats.shape[0] != rescale_len:
                feats = _resize_rows_f32(feats, rescale_len, sample_method)
            return feats, False
        # unusual layout (f-order, other dtypes): the python path
    feats, padding = get_feats(key, vf_type, vf_folder, data_norm)
    if feats.shape[0] != rescale_len:
        feats = resize_feature(feats, rescale_len, sample_method)
    return feats.astype(np.float32), padding


def load_video_features(key: str, vf_types, vf_folders, feature_dim: int,
                        data_rescale: bool, frame_embedding_num: int,
                        feature_sample_rate: int = 1, data_norm: bool = False,
                        sample_method: str = "nearest") -> Tuple[np.ndarray, bool]:
    """Assemble the (possibly multi-type concatenated) feature tensor for one
    video (reference: PropSeqDataset.load_feats, video_dataset.py:218-251)."""
    if data_rescale:
        # fixed-length path (all shipped configs): per-type load
        types = vf_types if isinstance(vf_types, (list, tuple)) else [vf_types]
        folders = vf_folders if isinstance(vf_folders, (list, tuple)) \
            else [vf_folders]
        parts, all_padding = [], True
        for vf_type, folder in zip(types, folders):
            dim = feature_dim if len(types) == 1 else -1
            if dim < 0:
                dim = _FEAT_SPECS[vf_type][0] if vf_type in _FEAT_SPECS else \
                    feature_dim
            feats, padding = _load_single_rescaled(
                key, vf_type, folder, dim, frame_embedding_num,
                sample_method, data_norm)
            all_padding &= padding
            parts.append(feats)
        out = parts[0] if len(parts) == 1 else np.concatenate(parts, -1)
        assert out.shape[1] == feature_dim, \
            f"wrong feature_dim: got {out.shape[1]}, cfg says {feature_dim}"
        return out, all_padding

    if isinstance(vf_types, (list, tuple)):
        assert isinstance(vf_folders, (list, tuple)) and \
            len(vf_types) == len(vf_folders)
        parts = []
        all_padding = True
        for vf_type, folder in zip(vf_types, vf_folders):
            feats, is_padding = get_feats(key, vf_type, folder, data_norm)
            all_padding &= is_padding
            if data_rescale:
                if feats.shape[0] != frame_embedding_num:
                    feats = resize_feature(feats, frame_embedding_num,
                                           sample_method)
            else:
                feats = feats[::feature_sample_rate]
            parts.append(feats)
        out = np.concatenate(parts, axis=-1)
        missing = all_padding
    else:
        out, missing = get_feats(key, vf_types, vf_folders, data_norm)
        if data_rescale:
            out = resize_feature(out, frame_embedding_num, sample_method)
        else:
            out = out[::feature_sample_rate]
    assert out.shape[1] == feature_dim, \
        f"wrong feature_dim: got {out.shape[1]}, cfg says {feature_dim}"
    return out.astype(np.float32), missing
