"""Diagnostic plots: per-query proposal distribution.

Behavioral spec: reference misc/plot_proposal_distribution.py — for each
query slot, the temporal coverage histogram of its predicted segments across
videos plus score/center/length box plots, written as a PNG next to the
result JSON and hooked into every eval (reference eval_utils.py:258-261,
wrapped in try/except).
The port's copy of gvl_tpu/eval/plots.py (:17-278), which has no framework
in it, over the port's metric harness. matplotlib is imported inside each
plot: it is absent on some machines (the H100 one among them), where the
eval's plot hook (eval/evaluate.py) writes nothing and goes on."""

from __future__ import annotations

import json
from typing import Optional

import numpy as np


def plot_score_vs_video_length(result_json: str, gt_json: str,
                               out_png: Optional[str] = None) -> str:
    """Qualitative diagnostic: per-video detection recall (tIoU 0.5) and mean
    proposal score against video duration (reference: misc/plot/* result-vs-
    video-length plots)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from gvl_tpu_torch.eval.metrics.dvc_eval import _iou

    out_png = out_png or (result_json[:-5] if result_json.endswith(".json")
                          else result_json) + "_vs_length.png"
    with open(result_json) as f:
        preds = json.load(f)["results"]
    with open(gt_json) as f:
        gt = json.load(f)

    durations, recalls, scores = [], [], []
    for vid, g in gt.items():
        if vid not in preds or not preds[vid]:
            continue
        p = preds[vid]
        hit = sum(any(_iou(item["timestamp"], ts) >= 0.5 for item in p)
                  for ts in g["timestamps"])
        durations.append(g["duration"])
        recalls.append(hit / max(len(g["timestamps"]), 1))
        scores.append(float(np.mean([item["proposal_score"] for item in p])))

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4), dpi=100)
    ax1.scatter(durations, recalls, s=8)
    ax1.set_xlabel("video duration (s)")
    ax1.set_ylabel("recall@0.5")
    ax2.scatter(durations, scores, s=8, color="tab:orange")
    ax2.set_xlabel("video duration (s)")
    ax2.set_ylabel("mean proposal score")
    fig.tight_layout()
    fig.savefig(out_png)
    plt.close(fig)
    return out_png


def plot_proposal_distribution(result_json: str,
                               out_png: Optional[str] = None) -> str:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out_png = out_png or (result_json[:-5] if result_json.endswith(".json")
                          else result_json) + ".png"
    with open(result_json) as f:
        d = json.load(f)["results"]
    vids = list(d.keys())
    if not vids:
        return out_png
    n_query = max((p["query_id"] for p in d[vids[0]]), default=0) + 1

    L = 100
    coverage = np.zeros((n_query, L))
    stats = [[] for _ in range(n_query)]   # (score, center, length)
    for vid, items in d.items():
        for p in sorted(items, key=lambda x: x["query_id"]):
            q = p["query_id"]
            if q >= n_query:
                continue
            dur = max(p["vid_duration"], 1e-6)
            s = min(max(p["timestamp"][0] / dur, 0), 1)
            e = min(max(p["timestamp"][1] / dur, 0), 1)
            coverage[q, int(s * (L - 1)): int(e * (L - 1)) + 1] += 1
            stats[q].append((p["proposal_score"] * L, 0.5 * (s + e) * L,
                             (e - s) * L))
    coverage /= max(len(vids), 1)

    n_row = int(np.ceil(np.sqrt(n_query)))
    n_col = int(2 * np.ceil(n_query / n_row))
    fig = plt.figure(figsize=(4 * n_col, 3 * n_row), dpi=100)
    for q in range(n_query):
        ax = fig.add_subplot(n_row, n_col, 2 * q + 1)
        ax.plot(np.arange(L), coverage[q])
        ax.set_xlim([0, L])
        ax.set_title(f"query {q} coverage", fontsize=8)
        ax2 = fig.add_subplot(n_row, n_col, 2 * q + 2)
        if stats[q]:
            arr = np.array(stats[q])
            ax2.boxplot([arr[:, 0], arr[:, 1], arr[:, 2]],
                        positions=[1, 2, 3], orientation="horizontal",
                        showmeans=True,
                        flierprops=dict(marker=".", markersize=1))
        ax2.set_xlim([0, L])
        ax2.set_title("score/center/len", fontsize=8)
    fig.savefig(out_png, bbox_inches="tight", pad_inches=0.3)
    plt.close(fig)
    return out_png


def split_results_by_duration(result_json: str, gt_json: str,
                              out_dir: Optional[str] = None,
                              clip_len: float = 10.0,
                              max_clip_num: int = 30):
    """Bucket result videos by GT duration into `duration_<sec>.json` splits
    plus a summary PNG of per-bucket recall@0.5 (reference:
    misc/plot/results_vs_vid_length.py — which only writes the splits; the
    per-bucket scoring curve is our addition).

    Returns {bucket_seconds: path}.
    """
    import os

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from gvl_tpu_torch.eval.metrics.dvc_eval import _iou

    out_dir = out_dir or (result_json + "_by_duration")
    os.makedirs(out_dir, exist_ok=True)
    with open(result_json) as f:
        res = json.load(f)
    with open(gt_json) as f:
        gt = json.load(f)

    buckets = {i * clip_len: {"results": {}, "version": "VERSION 1.0",
                              "external_data": {"used:": True,
                                                "details": None}}
               for i in range(1, max_clip_num + 1)}
    recall = {k: [] for k in buckets}
    overflow = 0
    for vid, info in gt.items():
        if vid not in res["results"]:
            continue
        if info["duration"] > max_clip_num * clip_len:
            overflow += 1  # beyond the last bucket (reference drops these
            continue       # silently; we at least count them)
        for i in range(1, max_clip_num + 1):
            if (i - 1) * clip_len < info["duration"] <= i * clip_len:
                key = i * clip_len
                p = res["results"][vid]
                buckets[key]["results"][vid] = p
                hit = sum(any(_iou(item["timestamp"], ts) >= 0.5
                              for item in p) for ts in info["timestamps"])
                recall[key].append(hit / max(len(info["timestamps"]), 1))
                break
    if overflow:
        print(f"split_results_by_duration: {overflow} videos exceed "
              f"{max_clip_num * clip_len:g}s and were not bucketed "
              f"(raise max_clip_num to include them)")

    paths = {}
    for key, blob in buckets.items():
        if not blob["results"]:
            continue
        path = os.path.join(out_dir, f"duration_{key:g}.json")
        with open(path, "w") as f:
            json.dump(blob, f)
        paths[key] = path

    xs = sorted(k for k in recall if recall[k])
    if xs:
        fig, ax = plt.subplots(figsize=(6, 4), dpi=100)
        ax.plot(xs, [float(np.mean(recall[k])) for k in xs], marker="o")
        ax.set_xlabel("video duration bucket (s)")
        ax.set_ylabel("recall@0.5")
        ax.set_title(f"{len(paths)} buckets, clip_len={clip_len:g}s")
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, "recall_vs_duration.png"))
        plt.close(fig)
    return paths


def visualize_video_results(model_jsons, gt_json: str,
                            out_dir: Optional[str] = None,
                            vids=None, max_videos: int = 8):
    """Per-video event-timeline renders: GT segments and each model's
    predicted segments with captions (reference:
    misc/plot/visualize_results.py). model_jsons: {name: result_json_path}.
    Returns the list of written PNGs."""
    import os

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out_dir = out_dir or "qualitative"
    os.makedirs(out_dir, exist_ok=True)
    models = {}
    for name, path in model_jsons.items():
        with open(path) as f:
            models[name] = json.load(f)["results"]
    with open(gt_json) as f:
        gt = json.load(f)

    if vids is None:
        vids = [v for v in gt if all(v in m for m in models.values())]
    vids = list(vids)[:max_videos]

    written = []
    for vid in vids:
        info = gt[vid]
        rows = [("GT", [(ts, s) for ts, s in zip(info["timestamps"],
                                                 info["sentences"])])]
        for name, res in models.items():
            rows.append((name, [(p["timestamp"], p.get("sentence", ""))
                                for p in res.get(vid, [])]))
        fig, ax = plt.subplots(figsize=(10, 1.2 * len(rows) + 1), dpi=100)
        colors = plt.cm.tab10.colors
        for r, (name, segs) in enumerate(rows):
            y = len(rows) - 1 - r
            for j, (ts, sent) in enumerate(segs):
                ax.barh(y, ts[1] - ts[0], left=ts[0], height=0.6,
                        color=colors[j % len(colors)], alpha=0.6)
                ax.text(ts[0], y + 0.33, str(sent)[:60], fontsize=6)
        ax.set_yticks(range(len(rows)))
        ax.set_yticklabels([name for name, _ in reversed(rows)], fontsize=8)
        ax.set_xlim(0, info["duration"])
        ax.set_xlabel("time (s)")
        ax.set_title(vid, fontsize=9)
        fig.tight_layout()
        path = os.path.join(out_dir, f"{vid}.png")
        fig.savefig(path)
        plt.close(fig)
        written.append(path)
    return written


def find_good_samples(gt_json: str, model_jsons, ours: str,
                      margin: float = 0.05, min_score: float = 0.1):
    """Videos where model `ours` beats every other model's per-video mean
    METEOR by `margin` with mean >= min_score (reference:
    misc/plot/visualize_results.py find_good_sample). model_jsons:
    {name: result_json_path} including `ours`. Returns the video list."""
    from gvl_tpu_torch.eval.metrics.scorers import Meteor, ptb_tokenize

    meteor = Meteor()
    models = {}
    for name, path in model_jsons.items():
        with open(path) as f:
            models[name] = json.load(f)["results"]
    with open(gt_json) as f:
        gt = json.load(f)

    good = []
    for vid, info in gt.items():
        if any(vid not in m or not m[vid] for m in models.values()):
            continue
        gts = ptb_tokenize({i: [{"caption": s}]
                            for i, s in enumerate(info["sentences"])})
        means = {}
        for name, res in models.items():
            sents = [p.get("sentence", "") for p in res[vid]]
            toks = ptb_tokenize({i: [{"caption": s}]
                                 for i, s in enumerate(sents)})
            n = min(len(gts), len(toks))
            if n == 0:
                means[name] = 0.0
                continue
            scores = [meteor.score_segment(toks[i][0], gts[i])[0]
                      for i in range(n)]
            means[name] = float(np.mean(scores))
        if means[ours] >= min_score and all(
                means[ours] > means[n] + margin
                for n in models if n != ours):
            good.append(vid)
    return good
