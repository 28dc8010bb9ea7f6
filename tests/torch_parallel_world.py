"""The cases of tests/test_torch_parallel.py, run by each rank of a gloo
world of 2 processes (`start_world`) and by the test process itself as a
world of one (the one-process reference); and those of
tests/test_torch_sp.py, run by each rank of a gloo world of 4 processes
split 2 dp x 2 sp (`start_world(root, sp=True)`, `run_sp_rank`). This
module imports no JAX: the ranks are started with torch.multiprocessing's
spawn and import it.

`start_world(root)` starts the ranks, each with a process group whose
collectives fail after RANK_TIMEOUT_S seconds; `join_world` joins them
within JOIN_TIMEOUT_S: a rank that raises ends the world at once and the
error carries its traceback; a world that outlives the join is killed.
Each rank writes `rank<r>.pt` into `root`: {case: its results}.
"""

from __future__ import annotations

import builtins
import contextlib
import logging
import os
import pathlib
import shutil
import socket
import sys
import time

import numpy as np
import torch

RANKS = 2
SP_RANKS = 4                # 2 dp x 2 sp
# the sp step cases' halo: at 0.5 a halo is its neighbour's whole chunk, so
# no tap is clamped and the sp step is the one-process step
SP_HALO = 0.5
# the trunk case's halo fractions: the whole neighbour chunk, and the
# default, whose halos on the 24-frame levels (3, 2, 2 rows) clamp the
# initial offsets' taps
SP_TRUNK_HALOS = (0.5, 0.125)
RANK_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 300
N_STEPS = 5


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_world(root: pathlib.Path, sp: bool = False):
    """`run_rank` in RANKS spawned processes (with sp, `run_sp_rank` in
    SP_RANKS); returns their context."""
    import torch.multiprocessing as mp
    return mp.start_processes(run_sp_rank if sp else run_rank,
                              args=(str(root), free_port()),
                              nprocs=SP_RANKS if sp else RANKS, join=False,
                              start_method="spawn")


def join_world(ctx) -> None:
    """Wait for the ranks of `ctx`; raise with a rank's traceback if one
    fails, or after JOIN_TIMEOUT_S seconds, and kill what still runs."""
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the gloo world did not end within "
                                   f"{JOIN_TIMEOUT_S} s")
    finally:
        kill_world(ctx)


def kill_world(ctx) -> None:
    for p in ctx.processes:
        if p.is_alive():
            p.kill()
            p.join(5)


def _join(rank: int, size: int, port: int) -> None:
    from gvl_tpu_torch import parallel as dp
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(size), LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    dp.init_distributed("cpu", timeout_s=RANK_TIMEOUT_S)


def run_sp_rank(rank: int, root: str, port: int) -> None:
    """Rank `rank` of the 2 dp x 2 sp world: the mesh, train_cli with
    mesh_shape 'dp,sp' (and its validation), then, once the test process
    has written them (sp_step_inputs.pt), the trunk under an sp context
    and the contrastive steps with and without remat, and without a
    context; its results go to `sp_rank<r>.pt`."""
    from gvl_tpu_torch import parallel as dp
    torch.set_num_threads(1)
    _join(rank, SP_RANKS, port)
    root = pathlib.Path(root)
    try:
        inputs = torch.load(root / "sp_inputs.pt", weights_only=False)
        out = dict(mesh=sp_mesh_case())
        with no_tensorboard():
            out["train"] = train_run(inputs["train"], root / f"sp{rank}")
        steps = wait_for(root / "sp_step_inputs.pt")
        out["trunk"] = sp_trunk_case(steps["contrastive"])
        out["contrastive"] = contrastive_steps(steps["contrastive"],
                                               sp_halo=SP_HALO)
        out["remat"] = contrastive_steps(steps["contrastive"], n_steps=1,
                                         sp_halo=SP_HALO, remat=True)
        # the split world without a context (sp_msda off): both sp ranks
        # run the whole step on their rows
        out["no_context"] = contrastive_steps(steps["contrastive"],
                                              n_steps=1)
        torch.save(out, root / f"sp_rank{rank}.pt")
    finally:
        dp.shutdown()


def sp_mesh_case() -> dict:
    """The world of 4 asked for 'dp' (plain dp), then for 'dp,sp' (2 x 2):
    each rank's indices, its rows of 8, and its rank through each
    collective: gather_rows (the dp group), gather_sp and sum_sp (the sp
    group), global_sum of 1 (rows counted once)."""
    from gvl_tpu_torch import parallel as dp
    plain = dp.make_mesh_for_batch(4)
    out = dict(plain=(plain.dp_size, plain.sp_size))
    w = dp.make_mesh_for_batch(4, "dp,sp")
    x = torch.tensor([float(w.rank)])
    out.update(indices=(w.dp_rank, w.dp_size, w.sp_rank, w.sp_size),
               rows=dp.row_block(8), dp_gather=dp.gather_rows(x),
               sp_gather=dp.gather_sp(x), sp_sum=dp.sum_sp(x),
               count=dp.global_sum(1), again=dp.make_mesh_for_batch(
                   8, "dp,sp") is w, repr=repr(w))
    return out


def sp_trunk_case(inp: dict) -> dict:
    """The contrastive world's initial trunk on this rank's dp rows under
    an sp context with its clamp monitor on: (logits, boxes, memory) and
    the taps the halo clamp moved (summed over the world) at halo
    fractions 0.5 and the default 0.125 (tests/test_msda_sp.py:129-165,
    206-241)."""
    from gvl_tpu_torch import parallel as dp
    from gvl_tpu_torch.config import Config
    from gvl_tpu_torch.models.gvl import build_model
    from gvl_tpu_torch.parallel.sp import halo_clamped, sp_context
    from gvl_tpu_torch.models.text_encoder import load_text_encoder
    cfg = Config().update(inp["cfg"])
    port = build_model(cfg, text_hidden_dim=load_text_encoder(
        cfg, device="cpu").hidden_size, device="cpu")
    port.load_state_dict(inp["port0"], strict=True)
    b = dp.shard_batch(dict(inp["batch"]))
    args = [torch.as_tensor(b[k]) for k in ("video_feats", "video_mask",
                                            "duration")]
    out = {}
    with torch.no_grad():
        for h in SP_TRUNK_HALOS:
            with sp_context(dp.world(), halo_frac=h, clamp_monitor=True):
                o = port(*args)
                out[h] = (o["pred_logits"], o["pred_boxes"], o["memory"],
                          halo_clamped(port))
    return out


def run_rank(rank: int, root: str, port: int) -> None:
    from gvl_tpu_torch import parallel as dp
    torch.set_num_threads(2)
    _join(rank, RANKS, port)
    root = pathlib.Path(root)
    try:
        inputs = torch.load(root / "inputs.pt", weights_only=False)
        out = dict(gather=gather_case(), sum_gradients=sum_gradients_case(),
                   blocks=blocks_case(), refusals=refusal_case(inputs),
                   seeds=seeds_case())
        out.update(cli_cases(inputs, root / f"rank{rank}"))
        # the step cases' inputs come once the test process has them
        steps = wait_for(root / "step_inputs.pt")
        out["contrastive"] = contrastive_steps(steps["contrastive"])
        out.update(step_cases(steps))
        torch.save(out, root / f"rank{rank}.pt")
    finally:
        dp.shutdown()


def wait_for(path: pathlib.Path) -> dict:
    """torch.load of `path` once it exists (written whole: saved under
    another name, then renamed), within JOIN_TIMEOUT_S."""
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear")
        time.sleep(0.2)
    return torch.load(path, weights_only=False)


@contextlib.contextmanager
def no_tensorboard():
    """The train loop's metrics stream writes no tensorboard file inside
    the block: importing that writer pulls in TensorFlow where it is
    installed (~15 s, which every rank would wait for on rank 0)."""
    blocked = "torch.utils.tensorboard" not in sys.modules
    if blocked:
        sys.modules["torch.utils.tensorboard"] = None     # ImportError
    try:
        yield
    finally:
        if blocked:
            del sys.modules["torch.utils.tensorboard"]


def cli_cases(inputs: dict, work: pathlib.Path) -> dict:
    """train_cli and eval_cli, which a world of one runs too (the
    reference)."""
    with no_tensorboard():
        return dict(train=train_run(inputs["train"], work),
                    eval=eval_run(inputs["eval"], work))


def step_cases(steps: dict) -> dict:
    """The step cases that a world of one computes too (the reference; the
    contrastive step's reference is JAX's)."""
    return dict(no_gt=contrastive_steps(steps["no_gt"], n_steps=2,
                                        caption_cost=True),
                scst=scst_step(steps["scst"]))


# --------------------------------------------------------------- collectives

def gather_case() -> dict:
    """Rank r's rows x_r of a seeded global X through gather_rows, and the
    gradient of sum(w_r * gathered) on each rank."""
    from gvl_tpu_torch import parallel as dp
    g = torch.Generator().manual_seed(0)
    X = torch.randn(RANKS * 3, 4, dtype=torch.float64, generator=g)
    Wt = torch.randn(RANKS, RANKS * 3, 4, dtype=torch.float64, generator=g)
    x = X[dp.row_block(len(X))].clone().requires_grad_()
    y = dp.gather_rows(x)
    (Wt[dp.rank()] * y).sum().backward()
    mask = torch.tensor([[True, False], [False, True], [True, True]])
    return dict(X=X, W=Wt, y=y.detach(), grad=x.grad,
                bools=dp.gather_rows(mask ^ bool(dp.rank())))


def sum_gradients_case() -> dict:
    """Three parameters: `a` with a gradient on every rank, `b` on rank 0
    only, `c` on none."""
    from gvl_tpu_torch import parallel as dp
    a, b, c = (torch.nn.Parameter(torch.ones(n)) for n in (3, 2, 4))
    loss = (a * (dp.rank() + 1.0)).sum()
    if dp.rank() == 0:
        loss = loss + (b * 5.0).sum()
    loss.backward()
    dp.sum_gradients([a, b, c], bucket_bytes=8)    # a bucket per tensor
    return dict(a=a.grad, b=b.grad, c=c.grad)


def seeds_case() -> dict:
    """This rank's seed of a step seeded 7 and the dropout mask drawn from
    it."""
    from gvl_tpu_torch.train.state import rank_seed
    torch.manual_seed(rank_seed(7))
    return dict(seed=rank_seed(7),
                mask=torch.nn.functional.dropout(torch.ones(64), 0.5) > 0)


def blocks_case() -> dict:
    """shard_batch of a batch of 6 rows: arrays, a tensor and lists."""
    from gvl_tpu_torch import parallel as dp
    batch = dict(feats=np.arange(6 * 4).reshape(6, 4),
                 mask=np.arange(6) % 2 == 0, t=torch.arange(12).reshape(6, 2),
                 keys=[f"v{i}" for i in range(6)],
                 raw=[[str(i)] * i for i in range(6)])
    return dp.shard_batch(batch)


def refusal_case(inputs: dict) -> dict:
    """The messages of what a world of 2 refuses (a batch of 3, directly
    and through the train loop, before any run dir), and what it makes of
    the sequence-parallel mesh, which JAX runs as plain dp below 4
    devices: the world's (dp size, sp size) and the train loop's run dir
    (its base name; 0 epochs: the loop sets up and returns)."""
    from gvl_tpu_torch import parallel as dp
    from gvl_tpu_torch.config import Config
    from gvl_tpu_torch.train import loop
    out = {}
    save_dir = inputs["train"]["cfg"]["save_dir"]

    def sizes(w):
        return (w.dp_size, w.sp_size)
    for name, call in (
            ("batch_3", lambda: dp.make_mesh_for_batch(3)),
            ("dp_sp", lambda: sizes(dp.make_mesh_for_batch(4, "dp,sp"))),
            ("train_batch_3", lambda: loop.train(Config().update(dict(
                inputs["train"]["cfg"], batch_size=3, device="cpu",
                save_dir=save_dir + "_b3")))),
            ("train_dp_sp", lambda: os.path.basename(loop.train(
                Config().update(dict(inputs["train"]["cfg"], epoch=0,
                                     mesh_shape="dp,sp", device="cpu",
                                     save_dir=save_dir + "_sp")))))):
        try:
            out[name] = call()
        except Exception as e:                  # noqa: BLE001 (recorded)
            out[name] = (type(e).__name__, str(e))
    out["run_dirs"] = [os.path.exists(save_dir + s) for s in ("_b3", "_sp")]
    return out


# ----------------------------------------------------------------- the step

def _statics(cfg, **kw):
    from gvl_tpu_torch.train.criterion import LossSpec
    from gvl_tpu_torch.train.state import StepStatics
    base = dict(enable_contrastive=bool(cfg.enable_contrastive),
                caption_loss=True, two_stage=False, train_text_encoder=False,
                disable_mid_caption_heads=False,
                enable_pos_emb_for_captioner=False,
                temporal_shapes=tuple(cfg.temporal_shapes()))
    return StepStatics(spec=LossSpec.from_config(cfg), **dict(base, **kw))


def _weights(cfg):
    """The loss weights at the contrastive schedule's epoch 2 (0.1)."""
    from gvl_tpu_torch.train.criterion import (cl_weight_at_epoch,
                                               make_weight_dict)
    w = make_weight_dict(cfg)
    for k in w:
        if k.startswith("contrastive_loss"):
            w[k] = cl_weight_at_epoch(cfg, 2)
    return w


def contrastive_steps(inp: dict, n_steps: int = N_STEPS,
                      caption_cost: bool = False, sp_halo: float = None,
                      remat: bool = False) -> dict:
    """`n_steps` train steps of the contrastive world's model from its
    initial weights on this rank's rows of `inp`'s batch: the logged
    (global) losses of each step, the first step's gradients and the
    weights after the steps. With `sp_halo`, under an sp context of that
    halo fraction with its clamp monitor on: also the taps the halo clamp
    moved in each step (summed over the world). With `remat`, every trunk
    layer checkpointed (remat_trunk)."""
    import contextlib

    from gvl_tpu_torch import parallel as dp
    from gvl_tpu_torch.config import Config
    from gvl_tpu_torch.models.gvl import build_model
    from gvl_tpu_torch.models.text import BertSelfAttention
    from gvl_tpu_torch.models.text_encoder import load_text_encoder
    from gvl_tpu_torch.parallel.sp import halo_clamped, sp_context
    from gvl_tpu_torch.train import state as pstate
    cfg = Config().update(dict(inp["cfg"], remat_trunk=remat))
    text = load_text_encoder(cfg, device="cpu")
    text.load_state_dict(inp["text"], strict=True)
    port = build_model(cfg, text_hidden_dim=text.hidden_size, device="cpu")
    port.load_state_dict(inp["port0"], strict=True)
    for m in port.modules():
        if isinstance(m, BertSelfAttention):
            m.dropout = 0.0
    st = _statics(cfg, caption_cost=caption_cost)
    state = pstate.create_train_state(cfg, port, 100, st, text)
    step = pstate.make_train_step(port, cfg, st, text)
    batch = pstate.add_text_inputs(dict(inp["batch"]), text, cfg)
    batch = dp.shard_batch(batch)
    losses, grads, clamped = [], None, []
    within = contextlib.nullcontext() if sp_halo is None else sp_context(
        dp.world(), halo_frac=sp_halo, clamp_monitor=True)
    with within:
        for i in range(n_steps):
            losses.append({k: float(v) for k, v in
                           step(state, batch, _weights(cfg)).items()})
            if sp_halo is not None:
                clamped.append(halo_clamped(port))
            if i == 0:
                grads = {n: None if p.grad is None else p.grad.clone()
                         for n, p in port.named_parameters()}
    return dict(losses=losses, grads=grads, rows=len(batch["video_feats"]),
                clamped=clamped, weights={k: v.clone() for k, v in
                                          port.state_dict().items()})


def _second_best(z, temperature, generator=None):
    """A forced draw: each event's second most likely token."""
    return z.float().topk(2, dim=-1).indices[..., 1]


def scst_step(inp: dict) -> dict:
    """One SCST step (CIDEr-D and METEOR rewards) from seeded weights on
    this rank's rows, the sampled rollout forced to each event's second
    most likely token: the rewards of this rank's pairs and the global
    losses."""
    from gvl_tpu_torch import parallel as dp
    from gvl_tpu_torch.config import Config
    from gvl_tpu_torch.models import captioner
    from gvl_tpu_torch.models.gvl import build_model
    from gvl_tpu_torch.models.layers import init_params
    from gvl_tpu_torch.train import rl
    from gvl_tpu_torch.train import state as pstate
    cfg = Config().update(inp["cfg"])
    port = build_model(cfg, text_hidden_dim=64, device="cpu")
    init_params(port, torch.Generator().manual_seed(0))
    rewards = []
    make = rl.rl_reward_callback

    def recording(*a, **k):
        fn = make(*a, **k)

        def host_fn(*arrays):
            r = fn(*arrays)
            rewards.append(r.copy())
            return r
        return host_fn
    st = _statics(cfg, caption_rl=True)
    with _patched((rl, "rl_reward_callback", recording),
                  (captioner, "draw_tokens", _second_best)):
        state = pstate.create_train_state(cfg, port, 100, st)
        step = pstate.make_train_step(port, cfg, st)
        losses = step(state, dp.shard_batch(dict(inp["batch"])),
                      _weights(cfg), seed=7)
    return dict(rewards=rewards,
                losses={k: float(v) for k, v in losses.items()},
                grads={n: p.grad.clone() for n, p in port.named_parameters()
                       if n.startswith("caption_head") and
                       p.grad is not None})


# ------------------------------------------------------- the CLIs, the files

@contextlib.contextmanager
def _patched(*triples):
    saved = [(o, n, getattr(o, n)) for o, n, _ in triples]
    try:
        for o, n, v in triples:
            setattr(o, n, v)
        yield
    finally:
        for o, n, v in saved:
            setattr(o, n, v)


@contextlib.contextmanager
def recorded_writes(paths: list, roots):
    """Append to `paths` every file or directory under `roots` (the run's
    directories; torch's own caches elsewhere are not the run's) that the
    block opens for writing, makes, moves, copies or saves with torch."""
    roots = tuple(os.path.abspath(r) for r in roots)

    def record(which, path):
        if os.path.abspath(str(path)).startswith(roots):
            paths.append((which, str(path)))

    def wrap(fn, which, *, arg=0, mode_arg=None):
        def inner(*a, **k):
            mode = k.get("mode", a[mode_arg] if mode_arg is not None
                         and len(a) > mode_arg else "r")
            if which != "open" or any(c in str(mode) for c in "wax+"):
                record(which, a[arg] if len(a) > arg
                       else k.get("f", k.get("name")))
            return fn(*a, **k)
        return inner
    fh_init = logging.FileHandler.__init__

    def file_handler(self, filename, *a, **k):
        record("log", filename)
        fh_init(self, filename, *a, **k)
    with _patched((builtins, "open", wrap(builtins.open, "open", mode_arg=1)),
                  (os, "makedirs", wrap(os.makedirs, "makedirs")),
                  (os, "replace", wrap(os.replace, "replace", arg=1)),
                  (shutil, "move", wrap(shutil.move, "move", arg=1)),
                  (shutil, "copy", wrap(shutil.copy, "copy", arg=1)),
                  (shutil, "copytree", wrap(shutil.copytree, "copytree",
                                            arg=1)),
                  (torch, "save", wrap(torch.save, "torch.save", arg=1)),
                  (logging.FileHandler, "__init__", file_handler)):
        yield


def train_run(inp: dict, work: pathlib.Path) -> dict:
    """train_cli on the tiny loop config from `work` (its cwd): the run's
    info.json and model-last weights (read after every rank is done), and
    what this rank wrote."""
    from gvl_tpu_torch import parallel as dp
    from gvl_tpu_torch import train_cli
    work.mkdir(parents=True, exist_ok=True)
    cwd = os.getcwd()
    writes: list = []
    try:
        os.chdir(work)
        with recorded_writes(writes, (work, inp["cfg"]["save_dir"])):
            folder = train_cli.main(["--cfg_path", inp["yml"], "--device",
                                     "cpu"])
    finally:
        os.chdir(cwd)
    dp.barrier()
    info = (pathlib.Path(folder) / "info.json").read_text()
    ckpt = torch.load(pathlib.Path(folder) / "model-last.pth",
                      weights_only=True)
    return dict(folder=folder, info=info, model=ckpt["model"],
                writes=writes, cwd_files=sorted(os.listdir(work)))


def eval_run(inp: dict, work: pathlib.Path) -> dict:
    """eval_cli --eval_data_parallel on the prepared run dir: the DVC and
    grounding JSONs rank 0 wrote, each batch's eval losses (unrounded) and
    what this rank wrote."""
    from gvl_tpu_torch import eval_cli
    from gvl_tpu_torch import parallel as dp
    from gvl_tpu_torch.eval.evaluate import EvalRunner
    losses: list = []
    step = EvalRunner._eval_step

    def recording(self, arrs):
        res, aux = step(self, arrs)
        losses.append({k: float(v) for k, v in res["losses"].items()})
        return res, aux
    writes: list = []
    work.mkdir(parents=True, exist_ok=True)
    cwd = os.getcwd()
    try:
        os.chdir(work)
        with _patched((EvalRunner, "_eval_step", recording)), \
                recorded_writes(writes, (work, inp["argv"][1])):
            res = eval_cli.main(inp["argv"] + ["--eval_data_parallel"])
    finally:
        os.chdir(cwd)
    dp.barrier()
    files = {}
    for suffix in ("", ".grounding.json", "_aux.grounding.json"):
        path = res["dvc_json"] + suffix
        files[suffix or "dvc"] = pathlib.Path(path).read_text()
    return dict(losses=losses, files=files, scores=res["scores"],
                videos=res["videos"], writes=writes)
