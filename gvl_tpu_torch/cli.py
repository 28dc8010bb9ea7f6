"""CLI argument parsing.

Mirrors the reference CLI surface (reference opts.py:7-290): every Config
field becomes a flag with the same name/default, YAML configs overlay with
base_cfg_path inheritance, and a full snapshot lands in .tmp/opts.json for
eval-time recovery (reference opts.py:330-336, consumed by eval.py:63-70).

The port's copy of gvl_tpu/cli.py, over the port's Config.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any, List, Optional, get_args, get_origin

from gvl_tpu_torch.config import Config, _read_yaml_chain


def _add_field(parser: argparse.ArgumentParser, f: dataclasses.Field):
    name = "--" + f.name
    default = (f.default_factory() if f.default_factory
               is not dataclasses.MISSING else f.default)
    ftype = f.type
    origin = get_origin(ftype)
    if ftype in (bool, "bool") or isinstance(default, bool):
        parser.add_argument(name, type=lambda s: s.lower() in
                            ("1", "true", "yes"), default=default)
    elif origin in (list, List) or isinstance(default, list):
        elem = str
        if default and isinstance(default[0], (int, float)):
            elem = type(default[0])
        args = get_args(ftype)
        if args and args[0] in (int, float, str):
            elem = args[0]
        parser.add_argument(name, nargs="+", type=elem, default=default)
    elif isinstance(default, int) and not isinstance(default, bool):
        parser.add_argument(name, type=int, default=default)
    elif isinstance(default, float):
        parser.add_argument(name, type=float, default=default)
    else:
        parser.add_argument(name, type=str, default=default)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="GVL-TPU: TPU-native untrimmed-video understanding")
    for f in dataclasses.fields(Config):
        _add_field(parser, f)
    # reference opts.py:166 — store_false alias onto aux_loss
    parser.add_argument("--no_aux_loss", dest="aux_loss",
                        action="store_false")
    return parser


def parse_opts(argv: Optional[List[str]] = None) -> Config:
    args = build_parser().parse_args(argv)
    cfg = Config()
    cfg.update(vars(args))
    if args.cfg_path:
        # YAML overrides CLI, matching the reference ordering
        cfg.update(_read_yaml_chain(args.cfg_path))
    if cfg.random_seed:
        import random
        seed = int(random.random() * 1000)
        cfg.id = f"{cfg.id}_seed{seed}"
        cfg.seed = seed
    if cfg.debug:
        cfg.id = "debug_" + time.strftime("%Y-%m-%d_%H-%M-%S",
                                          time.localtime())
        cfg.save_checkpoint_every = 1
    if not cfg.id:
        cfg.id = os.path.splitext(os.path.basename(cfg.cfg_path))[0] \
            if cfg.cfg_path else "run"
    if cfg.caption_decoder_type == "none":
        assert cfg.caption_loss_coef == 0 and cfg.set_cost_caption == 0
    if int(os.environ.get("RANK", 0)) == 0:
        # one writer under a launcher (gvl_tpu_torch.parallel)
        os.makedirs(".tmp", exist_ok=True)
        with open(".tmp/opts.json", "w") as fh:
            json.dump(cfg.to_dict(), fh, default=str)
    return cfg
