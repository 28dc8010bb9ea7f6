"""Train a model of the port, end to end:

    python -m gvl_tpu_torch.train_cli --cfg_path cfgs/<x>.yml [--flag v ...]

The port's counterpart of the root train.py (the JAX package's CLI), with
its flags: every Config field (gvl_tpu_torch.cli.parse_opts; the yml wins
over a flag, as in the reference). It prints the run id and calls
gvl_tpu_torch.train.loop.train. `--device cuda` (the default) trains on
the card and raises where there is none; `--device cpu` trains on the CPU.
Resume with `--start_from <id>` (the saved opts win over the flags), start
from a trained run with `--pretrain full|encoder|decoder --pretrain_path
<run dir or .pth>`; the SCST configs (cfgs/*_rl.yml) name their
pretrain_path in the yml (PRETRAINED_CHECKPOINT: point it at a trained
run's directory).

Data parallel over N ranks (gvl_tpu_torch.parallel; the JAX CLI's mesh
over every visible device):

    python -m torch.distributed.run --nproc_per_node N \
        -m gvl_tpu_torch.train_cli --cfg_path X.yml [--device cpu]

`batch_size` stays the global batch and must divide over the ranks.
"""

from __future__ import annotations

from typing import List, Optional

from gvl_tpu_torch.cli import parse_opts


def main(argv: Optional[List[str]] = None) -> str:
    """Run the CLI on `argv` (sys.argv[1:] when None); returns the run
    directory."""
    cfg = parse_opts(argv)
    print(f"run id: {cfg.id}", flush=True)
    from gvl_tpu_torch.train.loop import train
    return train(cfg)


if __name__ == "__main__":
    from gvl_tpu_torch import parallel
    try:
        main()
    finally:
        parallel.shutdown()
