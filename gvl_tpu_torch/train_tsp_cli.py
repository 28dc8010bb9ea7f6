"""Pretrain a TSP / TAC video backbone:

    python -m gvl_tpu_torch.train_tsp_cli --root-dir VIDEOS \\
        --train-csv train.csv --valid-csv valid.csv \\
        --label-columns action-label temporal-region-label \\
        --label-mapping-jsons actions.json regions.json \\
        --backbone r2plus1d_34 --output-dir runs/tsp [--device cpu]

The port's counterpart of tools/train_tsp.py, with its flags and defaults
(the reference video_backbone/TSP/train/opts.py: batch 32, r2plus1d_34,
16-frame clips of 112 x 112, 8 epochs): metadata CSVs and label-mapping
JSONs in (TAC: one 'action-label' column), per-epoch checkpoints
(`epoch_<N>.pth`, `checkpoint.pth`) and `metrics.jsonl` out; each epoch's
history entry is printed as a JSON line. `--resume` continues from
`<output-dir>/checkpoint.pth`; `--debug` runs 2 batches an epoch.
`--device cuda` (the default) trains on the card and raises where there is
none. Videos are decoded with cv2, which must be installed.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="TSP / TAC backbone "
                                "pretraining")
    p.add_argument("--root-dir", required=True)
    p.add_argument("--train-subdir", default="train")
    p.add_argument("--valid-subdir", default="valid")
    p.add_argument("--train-csv", required=True)
    p.add_argument("--valid-csv", required=True)
    p.add_argument("--label-columns", nargs="+", required=True)
    p.add_argument("--label-mapping-jsons", nargs="+", required=True)
    p.add_argument("--loss-alphas", nargs="+", default=[1.0, 1.0],
                   type=float)
    p.add_argument("--global-video-features", default=None)
    p.add_argument("--backbone", default="r2plus1d_34",
                   choices=["r2plus1d_34", "r2plus1d_18", "r3d_18"])
    p.add_argument("--clip-len", default=16, type=int)
    p.add_argument("--clip-size", default=112, type=int,
                   help="crop size (the reference fixes 112)")
    p.add_argument("--frame-rate", default=15, type=int)
    p.add_argument("--clips-per-segment", default=5, type=int)
    p.add_argument("--batch-size", default=32, type=int)
    p.add_argument("--epochs", default=8, type=int)
    p.add_argument("--backbone-lr", default=0.0001, type=float)
    p.add_argument("--fc-lr", default=0.002, type=float)
    p.add_argument("--lr-warmup-epochs", default=2, type=int)
    p.add_argument("--lr-milestones", nargs="+", default=[4, 6], type=int)
    p.add_argument("--lr-gamma", default=0.01, type=float)
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--weight-decay", default=0.005, type=float)
    p.add_argument("--output-dir", default="")
    p.add_argument("--resume", action="store_true",
                   help="resume from <output-dir>/checkpoint.pth")
    p.add_argument("--valid-only", action="store_true")
    p.add_argument("--train-only-one-epoch", action="store_true")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--debug", action="store_true",
                   help="the first 2 batches of each epoch")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[Dict[str, float]]:
    """Train on `argv` (sys.argv[1:] when None); returns the history."""
    from gvl_tpu_torch.backbone.train_tsp import TSPTrainConfig, TSPTrainer
    from gvl_tpu_torch.backbone.tsp import resolve_device
    from gvl_tpu_torch.backbone.untrimmed_dataset import (
        UntrimmedClipDataset, tsp_batches)
    args = parse_args(argv)
    device = resolve_device(args.device)      # raises before any work
    label_mappings = []
    for path in args.label_mapping_jsons:
        with open(path) as f:
            names = json.load(f)
        label_mappings.append(dict(zip(names, range(len(names)))))
    common = dict(clip_length=args.clip_len, frame_rate=args.frame_rate,
                  clips_per_segment=args.clips_per_segment,
                  label_columns=args.label_columns,
                  label_mappings=label_mappings, size=args.clip_size,
                  global_video_features=args.global_video_features)
    ds_train = UntrimmedClipDataset(
        args.train_csv, os.path.join(args.root_dir, args.train_subdir),
        temporal_jittering=True, train=True, seed=args.seed, **common)
    ds_valid = UntrimmedClipDataset(
        args.valid_csv, os.path.join(args.root_dir, args.valid_subdir),
        temporal_jittering=False, train=False, seed=args.seed, **common)
    steps_per_epoch = max(len(ds_train) // args.batch_size, 1)
    if args.debug:
        steps_per_epoch = min(steps_per_epoch, 2)
    cfg = TSPTrainConfig(
        backbone=args.backbone,
        num_classes_list=tuple(len(m) for m in label_mappings),
        use_gvf=args.global_video_features is not None,
        backbone_lr=args.backbone_lr, fc_lr=args.fc_lr,
        lr_warmup_epochs=args.lr_warmup_epochs,
        lr_milestones=tuple(args.lr_milestones), lr_gamma=args.lr_gamma,
        epochs=args.epochs, loss_alphas=tuple(args.loss_alphas),
        momentum=args.momentum, weight_decay=args.weight_decay)
    trainer = TSPTrainer(
        cfg,
        make_train_batches=lambda ep: tsp_batches(
            ds_train, args.batch_size, shuffle=True, seed=args.seed + ep),
        make_valid_batches=lambda: tsp_batches(
            ds_valid, args.batch_size, shuffle=False, seed=args.seed),
        steps_per_epoch=steps_per_epoch, output_dir=args.output_dir,
        seed=args.seed, device=device)
    if args.resume and trainer.resume():
        print(f"resumed at epoch {trainer.start_epoch}")
    history = trainer.fit(valid_only=args.valid_only,
                          train_only_one_epoch=args.train_only_one_epoch)
    for h in history:
        print(json.dumps(h))
    return history


if __name__ == "__main__":
    main()
