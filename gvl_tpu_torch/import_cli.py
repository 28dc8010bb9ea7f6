"""Import a reference GVL / PDVC checkpoint (`.pth`) into a run directory
of the port:

    python -m gvl_tpu_torch.import_cli --pth model-best.pth \\
        --cfg_path cfgs/anet_tsp_msvg_dvc.yml --out save/imported_run \\
        [--device cuda|cpu]

The port's counterpart of the GVL mode of tools/import_checkpoint.py
(:74-118). It builds the model of the config (the port's seeded init),
maps the `.pth` onto it with gvl_tpu_torch.train.import_reference (the
JAX importer's rules), prints a WARNING line for the reference keys left
unused and one for the model's parameters left at their init, and writes
`<out>/model-best.pth` in the CheckpointManager format with the config's
`opts.json` beside it, so that

    python -m gvl_tpu_torch.eval_cli --eval_save_dir save \\
        --eval_folder imported_run

evaluates it and `--pretrain full --pretrain_path save/imported_run` trains
from it. As in the JAX tool, the text encoder's weights are
`load_text_encoder`'s (the pretrained files of the config), not the
`.pth`'s `text_encoder.*`. `--device cuda` (the default) builds on the card
and raises where there is none. The config is checked as the eval CLI
checks it: an option the port does not run is refused by name before
anything is read.

Backbone mode imports a released TSP / TAC (or torchvision VideoResNet)
checkpoint, the counterpart of tools/import_checkpoint.py --backbone
(:61-90):

    python -m gvl_tpu_torch.import_cli --backbone r2plus1d_34 \
        --pth r2plus1d_34-tsp_on_activitynet.pth --out save/tsp_backbone

It strips the fc heads (the reference extractor does, extract_features.py
:123), maps the rest onto the port's R(2+1)D (its torchvision names;
gvl_tpu_torch.backbone.import_torch), prints a WARNING line for the keys
left unused, refuses a checkpoint that leaves a backbone tensor unfilled,
loads the result strictly into the backbone built on `--device`, and
writes `<out>/backbone.pth`: {"backbone": the R2Plus1D state_dict, on the
CPU, "arch": the backbone's name}, which
gvl_tpu_torch.backbone.tsp.extract_features(checkpoint=...) reads. The fc
heads are not kept: they depend on the labels of the extraction model,
which does not use them.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional

import torch


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="import a reference GVL checkpoint into the port")
    p.add_argument("--pth", required=True)
    p.add_argument("--cfg_path")
    p.add_argument("--out", required=True)
    p.add_argument("--backbone", default=None,
                   choices=["r2plus1d_34", "r2plus1d_18", "r3d_18"],
                   help="import a TSP / torchvision video backbone into "
                        "<out>/backbone.pth instead of a GVL model")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def main(argv: Optional[List[str]] = None) -> Dict:
    """Run the import on `argv` (sys.argv[1:] when None). Returns {"path"
    (the checkpoint written), "unused", "unfilled", "seconds"}."""
    args = parser().parse_args(argv)
    if args.backbone:
        return import_backbone(args)
    if not args.cfg_path:
        raise SystemExit("import_cli: --cfg_path is required for a GVL "
                         "model import")
    from gvl_tpu_torch import eval_cli
    from gvl_tpu_torch.config import load_config
    from gvl_tpu_torch.models.gvl import GVLArch, build_model
    from gvl_tpu_torch.models.layers import init_params
    from gvl_tpu_torch.models.text_encoder import load_text_encoder
    from gvl_tpu_torch.train.checkpoint import CheckpointManager
    from gvl_tpu_torch.train.import_reference import \
        import_reference_checkpoint

    t0 = time.perf_counter()
    cfg = load_config(args.cfg_path)
    eval_cli.check_config(cfg)
    dev = eval_cli._device(args.device, "import_cli", "--device")
    text = load_text_encoder(cfg, device=dev)
    hidden = text.hidden_size if text else 768
    model = build_model(cfg, hidden, device=dev)
    init_params(model, torch.Generator(device=dev).manual_seed(cfg.seed))
    sd, unused, unfilled = import_reference_checkpoint(
        args.pth, GVLArch.from_config(cfg, hidden),
        share_caption_head=bool(cfg.share_caption_head))
    if unused:
        print(f"WARNING: {len(unused)} torch tensors unmapped:",
              unused[:10], "...")
    if unfilled:
        print(f"WARNING: {len(unfilled)} port params left at init:",
              unfilled[:10], "...")
    model.load_state_dict(sd, strict=False)
    path = CheckpointManager(args.out).save("model-best", model, text,
                                            epoch=0)
    cfg.dump_json(os.path.join(args.out, "opts.json"))
    n = len({id(p) for p in model.state_dict(keep_vars=True).values()})
    print(f"wrote {path} ({n} tensors)")
    return {"path": path, "unused": unused, "unfilled": unfilled,
            "seconds": time.perf_counter() - t0}


def import_backbone(args: argparse.Namespace) -> Dict:
    """The backbone mode (module docstring). Returns {"path", "unused",
    "unfilled", "seconds"}."""
    from gvl_tpu_torch import eval_cli
    from gvl_tpu_torch.backbone.import_torch import load_tsp_checkpoint
    from gvl_tpu_torch.backbone.r2plus1d import R2Plus1D
    from gvl_tpu_torch.backbone.tsp import BACKBONE_FILE

    t0 = time.perf_counter()
    dev = eval_cli._device(args.device, "import_cli", "--device")
    sd, unused, unfilled = load_tsp_checkpoint(args.pth, args.backbone)
    if unused:
        print(f"WARNING: {len(unused)} torch tensors unmapped:",
              unused[:10], "...")
    if unfilled:
        raise SystemExit(f"backbone tensors left at init: {unfilled[:10]}")
    model = R2Plus1D(args.backbone, device=dev)
    model.load_state_dict(sd, strict=True)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, BACKBONE_FILE)
    tmp = path + ".tmp"
    torch.save({"backbone": {k: v.detach().cpu() for k, v in
                             model.state_dict().items()},
                "arch": args.backbone}, tmp)
    os.replace(tmp, path)
    print(f"wrote {path} (backbone={args.backbone}; backbone only, the fc "
          "heads are rebuilt by the reader)")
    return {"path": path, "unused": unused, "unfilled": unfilled,
            "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    main()
