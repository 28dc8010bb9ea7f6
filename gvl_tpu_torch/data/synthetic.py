"""Synthetic miniature dataset for tests and smoke runs.

Generates on disk the same artifacts a real dataset prep produces (reference:
data/* converters): per-video .npy features, a caption/timestamps annotation
JSON, and a Translator-compatible vocabulary JSON. Features carry a planted
signal inside each GT segment so a working model can actually fit them.

The port's copy of gvl_tpu/data/synthetic.py.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

from gvl_tpu_torch.data.vocabulary import build_vocabulary

_WORDS = ["a", "man", "woman", "dog", "runs", "jumps", "eats", "red", "ball",
          "slides", "opens", "door", "fast", "slow", "table", "kitchen"]


def make_synthetic_dataset(root: str, num_videos: int = 8, feat_dim: int = 32,
                           min_events: int = 1, max_events: int = 4,
                           seed: int = 0) -> Tuple[str, str, str, int]:
    """Returns (anno_json, feature_folder, vocab_json, vocab_size)."""
    rng = np.random.RandomState(seed)
    feat_dir = os.path.join(root, "features")
    os.makedirs(feat_dir, exist_ok=True)

    anno = {}
    all_sents = []
    for i in range(num_videos):
        key = f"v_{i:011d}"[:13].ljust(13, "0")
        duration = float(rng.uniform(20, 120))
        T = int(rng.randint(40, 180))
        feats = rng.randn(T, feat_dim).astype(np.float32) * 0.1
        n_ev = int(rng.randint(min_events, max_events + 1))
        stamps, sents = [], []
        for e in range(n_ev):
            s = float(rng.uniform(0, duration * 0.8))
            ln = float(rng.uniform(duration * 0.05, duration * 0.3))
            t0, t1 = s, min(s + ln, duration)
            stamps.append([t0, t1])
            # plant a channel-coded signal in the segment
            f0, f1 = int(t0 / duration * T), max(int(t1 / duration * T), 1)
            feats[f0:f1, e % feat_dim] += 2.0
            sent = " ".join(rng.choice(_WORDS, size=rng.randint(3, 8)))
            sents.append(sent)
            all_sents.append(sent)
        np.save(os.path.join(feat_dir, key + ".npy"), feats)
        anno[key] = {"duration": duration, "timestamps": stamps,
                     "sentences": sents}

    anno_path = os.path.join(root, "anno.json")
    with open(anno_path, "w") as f:
        json.dump(anno, f)

    # grounding GT uses 'v_'-stripped video ids (the reference's contract:
    # data/anet/captiondata/grounding/process_grounding_gt.py)
    grounding = {vid[2:]: {"timestamps": v["timestamps"],
                           "duration": v["duration"]}
                 for vid, v in anno.items()}
    grounding_path = os.path.join(root, "grounding.json")
    with open(grounding_path, "w") as f:
        json.dump(grounding, f)

    vocab = build_vocabulary(all_sents)
    vocab_path = os.path.join(root, "vocab.json")
    with open(vocab_path, "w") as f:
        json.dump(vocab, f)
    return anno_path, feat_dir, vocab_path, len(vocab["word_to_ix"])
