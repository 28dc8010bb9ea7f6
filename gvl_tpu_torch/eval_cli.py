"""Evaluate a saved model of the port, end to end:

    python -m gvl_tpu_torch.eval_cli --eval_save_dir save --eval_folder RUN \\
        [--eval_checkpoint model-best] [--eval_device cuda|cpu] [...]

The port's counterpart of the root eval.py (the JAX package's CLI), with
every flag of its `eval_parser`. It restores the training-time options from
the run directory's info.json or opts.json (every key but the `eval_*`
ones), applies the eval flags as eval.py does, reads the data through
DenseVideoDataset and Batcher, builds the model and the text encoder on the
device, loads `<run dir>/<eval_checkpoint>.pth` (gvl_tpu_torch.train
.checkpoint), evaluates with EvalRunner.run and scores the result JSONs
with the metric harness; the scores go to
`<run dir>/eval_<eval_checkpoint>_scores.json`. With `--eval_mode test` the
caption file is fabricated from a metadata CSV and nothing is scored.

`--eval_device cuda` (the default) raises where there is no CUDA device; it
never falls back to the CPU. On the card TF32 is turned off, so that
matmuls and convolutions run in f32 as in the JAX package.

Refused by name (NotImplementedError) before any data is read:
`--eval_data_parallel` (several GPUs, ROADMAP Queue 1 item 10) and every
option of the restored config that the model, the text encoder or
EvalRunner does not run yet (`check_config`; the pretrained text and GPT-2
weights among them). `--eval_use_amp` sets eval_decode_bf16 besides the
bf16 text pass, as the JAX CLI does (eval.py:134-135).
`--eval_enable_zeroshot_tal` embeds the names of the classes in
action_classes_path, each after `--eval_prompt` (default "a video of"), so
that every prediction carries its class scores (eval.py:195-202); a run
trained with only_ft_class_head (the TAL linear probe) also gets its TAL
JSON beside the DVC JSON. A gpt2 run's captions are "w<id>" for each
token before the stop, as eval.py gives no decoder.
`--eval_not_strict_load` is accepted and changes nothing, as in the JAX
CLI. EvalRunner's plot hook writes the proposal-distribution figure beside
the DVC JSON where matplotlib is installed (eval_disable_plot_hook is an
`eval_*` option, which the CLI does not restore: it is off, as in eval.py).

The wall time of each stage is logged (and returned by `main`): config and
data, model build, checkpoint load, the eval run with the batcher's share of
it, and metrics.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import json
import os
import time
from collections import OrderedDict
from typing import Dict, List, Optional

import torch

from gvl_tpu_torch.config import Config


def create_fake_test_caption_file(metadata_csv_path: str) -> str:
    """Fabricate GT-shaped annotations for unlabeled test videos
    (reference: eval.py:30-37), from the CSV's video-name and
    video-duration columns."""
    out = {}
    with open(metadata_csv_path, newline="") as f:
        for row in csv.DictReader(f):
            dur = float(row["video-duration"])
            out[row["video-name"]] = {"duration": dur,
                                      "timestamps": [[0, 0.5 * dur]],
                                      "sentences": ["placeholder"]}
    path = ".tmp/fake_test_anno.json"
    os.makedirs(".tmp", exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f)
    return path


def eval_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Evaluate a saved gvl_tpu_torch model")
    p.add_argument("--eval_save_dir", type=str, default="save")
    p.add_argument("--eval_folder", type=str, required=True)
    p.add_argument("--eval_model_path", type=str, default="")
    p.add_argument("--eval_checkpoint", type=str, default="model-best")
    p.add_argument("--eval_batch_size", type=int, default=16)
    p.add_argument("--eval_caption_file", type=str, default="")
    p.add_argument("--eval_mode", type=str, default="eval",
                   choices=["eval", "test"])
    p.add_argument("--test_video_feature_folder", type=str, nargs="+",
                   default=None)
    p.add_argument("--test_video_meta_data_csv_path", type=str, default=None)
    p.add_argument("--eval_gt_file_for_caption", type=str, nargs="+",
                   default=None)
    p.add_argument("--eval_gt_file_for_grounding", type=str, default=None)
    p.add_argument("--eval_transformer_input_type", type=str, default=None)
    p.add_argument("--eval_disable_captioning", action="store_true")
    p.add_argument("--eval_enable_maximum_matching_for_grounding",
                   action="store_true", default=None)
    p.add_argument("--gpu_id", type=str, nargs="+", default=[])
    p.add_argument("--eval_tool_version", type=str, default=None,
                   choices=["2018", "2021", "2018_cider"])
    p.add_argument("--eval_proposal_type", type=str, default=None)
    p.add_argument("--eval_device", type=str, default="cuda",
                   choices=["cpu", "cuda"])
    p.add_argument("--eval_nthreads", type=int, default=None)
    p.add_argument("--show_all_results", default=None)
    p.add_argument("--eval_enable_matching_score", action="store_true",
                   default=None)
    p.add_argument("--eval_matching_score_weight", type=float, default=None)
    p.add_argument("--eval_ec_alpha", type=float, default=-1.0,
                   help="-1 keeps the trained ec_alpha")
    p.add_argument("--eval_calculate_query_counts", action="store_true",
                   default=None)
    p.add_argument("--eval_enable_grounding", type=int, default=None)
    p.add_argument("--eval_set_cost_class", type=float, default=None)
    p.add_argument("--eval_grounding_cost_alpha", type=float, default=None)
    p.add_argument("--eval_grounding_cost_gamma", type=float, default=None)
    p.add_argument("--eval_set_cost_cl", type=float, default=None)
    p.add_argument("--eval_disable_contrastive", action="store_true",
                   default=None)
    p.add_argument("--eval_for_multi_anno", action="store_true", default=None)
    p.add_argument("--eval_enable_zeroshot_tal", action="store_true",
                   default=None, help="per-class scores of every prediction "
                   "against the prompted names of action_classes_path")
    p.add_argument("--eval_prompt", type=str, default=None)
    p.add_argument("--eval_use_amp", action="store_true", default=None,
                   help="the bf16 text pass and the bf16 decode "
                   "(eval_decode_bf16)")
    p.add_argument("--eval_debug", action="store_true", default=None)
    p.add_argument("--eval_num_queries", type=int, default=0)
    p.add_argument("--eval_not_strict_load", action="store_true",
                   default=None)
    p.add_argument("--eval_data_parallel", action="store_true", default=None,
                   help="not ported yet (one card): refused")
    return p


def restore_config(args: argparse.Namespace) -> Config:
    """The run's Config: the saved non-`eval_*` options, then every flag
    given, with the flag semantics of eval.py (reference eval.py:54-85)."""
    folder = os.path.join(args.eval_save_dir, args.eval_folder)
    info_path = os.path.join(folder, "info.json")
    src = info_path if os.path.exists(info_path) else \
        os.path.join(folder, "opts.json")
    with open(src) as f:
        saved = json.load(f)
    cfg = Config()
    for k, v in saved.get("opt", saved).items():
        if not k.startswith("eval_"):
            cfg.set(k, v)
    for k, v in vars(args).items():
        if v is not None and v != "":
            cfg.set(k, v)
    cfg.batch_size = cfg.eval_batch_size
    if args.eval_nthreads is not None:
        cfg.num_workers = args.eval_nthreads
    if args.eval_ec_alpha != -1.0:
        cfg.ec_alpha = args.eval_ec_alpha
    if args.eval_disable_contrastive:
        cfg.enable_contrastive = False
    if args.eval_use_amp:
        cfg.eval_decode_bf16 = True
    if args.eval_debug:
        cfg.debug = True
    if args.eval_num_queries > 0:
        cfg.num_queries = args.eval_num_queries
    if args.eval_transformer_input_type is not None:
        cfg.transformer_input_type = args.eval_transformer_input_type
    if args.eval_for_multi_anno:
        # MSVG annotations key videos '<group:03d><vid>': the feature lookup
        # strips the 3-char prefix
        cfg.train_with_split_anno = True
    if args.eval_mode == "test":
        if not args.test_video_meta_data_csv_path:
            raise ValueError("--eval_mode test needs "
                             "--test_video_meta_data_csv_path")
        cfg.val_caption_file = create_fake_test_caption_file(
            args.test_video_meta_data_csv_path)
        if args.test_video_feature_folder:
            cfg.visual_feature_folder = args.test_video_feature_folder
    elif args.eval_caption_file:
        cfg.val_caption_file = args.eval_caption_file
    return cfg


# (option, what it asks for, the ROADMAP item that ports it)
_REFUSED = (
    ("eval_data_parallel", "--eval_data_parallel (eval over several GPUs)",
     "ROADMAP Queue 1 item 10; the port evaluates on one card"),
)


def check_config(cfg: Config) -> None:
    """Raise NotImplementedError naming the first option of `cfg` that the
    port's eval does not run yet: the options of `_REFUSED`, then those
    the model and the text encoder refuse. Builds nothing."""
    from gvl_tpu_torch.models import gvl, text_encoder
    for name, what, where in _REFUSED:
        if cfg.get(name, False):
            raise NotImplementedError(
                f"eval_cli: {what} is not ported yet ({where})")
    gvl._check_ported(gvl.GVLArch.from_config(cfg))
    if cfg.enable_contrastive:
        text_encoder._check_ported(cfg)


def _device(name: str, who: str = "eval_cli",
            flag: str = "--eval_device") -> torch.device:
    """The device `name` ('cpu' or 'cuda', the current card); 'cuda'
    raises where there is none, naming `flag`. The train CLI shares it."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"{who}: {flag} cuda, but no CUDA device is "
                           f"available; pass {flag} cpu to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


class TimedBatches:
    """A batcher whose consumer's waits for the next batch are summed in
    `seconds`; `batch_size` is the batcher's, which EvalRunner.run pads a
    partial last batch to."""

    def __init__(self, batcher):
        self.batcher = batcher
        self.ds = batcher.ds
        self.batch_size = batcher.batch_size
        self.seconds = 0.0
        self.batches = 0

    def __iter__(self):
        it = iter(self.batcher)
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            self.seconds += time.perf_counter() - t0
            if batch is None:
                return
            self.batches += 1
            yield batch


def main(argv: Optional[List[str]] = None) -> Dict:
    """Run the CLI on `argv` (sys.argv[1:] when None). Returns {"scores",
    "times" (seconds per stage), "dvc_json" (the final DVC JSON's path),
    "videos", "batches"}."""
    from gvl_tpu_torch.data.dataset import Batcher, DenseVideoDataset
    from gvl_tpu_torch.data.vocabulary import ClassMap
    from gvl_tpu_torch.eval.evaluate import EvalRunner
    from gvl_tpu_torch.eval.metrics import (eval_metrics,
                                            eval_metrics_grounding)
    from gvl_tpu_torch.models.gvl import build_model
    from gvl_tpu_torch.models.text_encoder import load_text_encoder
    from gvl_tpu_torch.train.checkpoint import CheckpointManager
    from gvl_tpu_torch.utils.logging import create_logger

    args = eval_parser().parse_args(argv)
    dev = _device(args.eval_device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    folder = os.path.join(args.eval_save_dir, args.eval_folder)
    times: "OrderedDict[str, float]" = OrderedDict()

    @contextlib.contextmanager
    def stage(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            times[name] = time.perf_counter() - t0

    with stage("config_and_data"):
        cfg = restore_config(args)
        check_config(cfg)
        logger = create_logger(folder, "eval.log")
        ds = DenseVideoDataset(cfg.val_caption_file, cfg.visual_feature_folder,
                               cfg.dict_file, False, cfg)
        batcher = TimedBatches(Batcher(ds, cfg, cfg.eval_batch_size,
                                       shuffle=False))
    with stage("model_build"):
        text = load_text_encoder(cfg, device=dev)
        model = build_model(cfg, text.hidden_size if text else 768,
                            device=dev)
    with stage("checkpoint_load"):
        payload = CheckpointManager(folder).restore_raw(args.eval_checkpoint)
        if payload is None:
            raise FileNotFoundError(
                f"eval_cli: no checkpoint {args.eval_checkpoint}.pth in "
                f"{folder}")
        state = payload["model"]
        q = state["query_embed.weight"]
        if args.eval_num_queries > 0 and q.shape[0] >= args.eval_num_queries:
            # evaluate with a prefix of the trained query slots
            # (reference: eval_num_queries, eval.py:192)
            state = dict(state)
            state["query_embed.weight"] = q[: args.eval_num_queries]
        model.load_state_dict(state, strict=True)
        if text is not None and payload["text_encoder"] is not None:
            text.load_state_dict(payload["text_encoder"], strict=True)
    logger.info(f"loaded {args.eval_checkpoint} (epoch {payload['epoch']}) "
                f"on {dev}")

    runner = EvalRunner(cfg, model, ds.translator, text)
    if args.eval_enable_zeroshot_tal:
        cmap = ClassMap(cfg.action_classes_path)
        prompt = args.eval_prompt or "a video of"
        runner.enable_zeroshot_tal([f"{prompt} {cmap.idx2name[i]}"
                                    for i in range(len(cmap))])
    dvc_path = os.path.join(folder, f"eval_{args.eval_checkpoint}.json")
    with stage("eval_run"):
        out_path, out_json, *_ = runner.run(batcher, dvc_path, logger=logger,
                                            debug=bool(cfg.debug))
    times["batcher"] = batcher.seconds

    scores: Dict = {}
    with stage("metrics"):
        if args.eval_mode == "eval":
            if cfg.caption_loss_coef > 0 and not cfg.eval_disable_captioning:
                # the full scorer set unless --show_all_results says no
                # (reference eval.py:125-131)
                verbose = True if args.show_all_results is None \
                    else str(args.show_all_results).lower() not in ("0",
                                                                    "false")
                scores.update(eval_metrics(
                    out_path, gt_filenames=cfg.gt_file_for_eval,
                    para_gt_filenames=cfg.gt_file_for_para_eval,
                    dvc_eval_version=cfg.eval_tool_version, verbose=verbose))
            if cfg.enable_contrastive and cfg.eval_enable_grounding:
                if os.path.exists(cfg.eval_gt_file_for_grounding):
                    scores.update(eval_metrics_grounding(
                        out_path + ".grounding.json",
                        cfg.eval_gt_file_for_grounding))
                else:
                    logger.info(f"grounding GT not found, skipping: "
                                f"{cfg.eval_gt_file_for_grounding}")
    n_videos = len(out_json["results"])
    print(json.dumps({k: (round(float(v), 4) if isinstance(v, (int, float))
                          else v) for k, v in scores.items()}, indent=1))
    with open(os.path.join(folder, f"eval_{args.eval_checkpoint}_scores.json"),
              "w") as f:
        json.dump(scores, f, indent=1)
    logger.info(f"stage times (s): {dict(times)}; {n_videos} videos in "
                f"{batcher.batches} batches of {cfg.eval_batch_size}")
    return {"scores": scores, "times": dict(times), "dvc_json": out_path,
            "videos": n_videos, "batches": batcher.batches}


if __name__ == "__main__":
    main()
