"""TSP / TAC backbone pretraining: clips labelled with an action class and
a temporal region (inside / outside an action) train R(2+1)D with one fc
head per label kind (TAC: the action head alone).

Port of gvl_tpu/backbone/train_tsp.py (reference video_backbone/TSP/train/
train.py and opts.py):
- three SGD parameter groups (train.py:208-221): the stem frozen at lr 0,
  the residual stages at `backbone_lr` (1e-4 in the reference), the fc
  heads at `fc_lr` (2e-3); weight decay and momentum as optax's
  add_decayed_weights + sgd(momentum), which torch.optim.SGD computes;
- WarmupMultiStepLR per iteration (train.py:227-233): a linear warm-up
  from warmup_factor x lr over lr_warmup_epochs of steps, then x gamma at
  each milestone epoch; without backbone_lr, the legacy single group with
  a linear warm-up and a cosine decay (`lr`, `warmup_steps`,
  `total_steps`), which only the step-driven `train_tsp` loop reaches: no
  entry point calls that loop, TSPTrainer sets backbone_lr when it is
  None and train_tsp_cli always passes one;
- per-head cross-entropy with the -1 labels masked, mixed by loss_alphas
  (train.py:60-66, 206);
- an epoch loop with validation, checkpoints `epoch_<N>` and a rolling
  `checkpoint` (the port's gvl_tpu_torch.train.checkpoint format: the model,
  the optimizer and the update count), resume (start_epoch = saved + 1),
  valid_only, train_only_one_epoch and `metrics.jsonl` (train.py:84-288).

Batches are {'clips' (B, T, H, W, 3), 'labels' [per head (B,)], 'gvf'
(B, D)?} numpy arrays (untrimmed_dataset.tsp_batches). The model lives on
the card unless `device="cpu"` is given; dropout draws from the device's
default generator, seeded per step from (seed, epoch, step).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple)

import numpy as np
import torch
import torch.nn.functional as F

from gvl_tpu_torch.backbone.r2plus1d import TSPModel, init_backbone_params
from gvl_tpu_torch.backbone.tsp import resolve_device

Schedule = Callable[[int], float]


@dataclasses.dataclass
class TSPTrainConfig:
    backbone: str = "r2plus1d_34"
    num_classes_list: Tuple[int, ...] = (200, 2)   # (actions, inside/outside)
    use_gvf: bool = False
    # the legacy single-group schedule, used only when backbone_lr is None
    lr: float = 0.0001
    warmup_steps: int = 1000
    total_steps: int = 100000
    # the reference's parameter groups (train/opts.py defaults)
    backbone_lr: Optional[float] = None            # 1e-4 in the reference
    fc_lr: float = 0.002
    lr_warmup_epochs: int = 2
    lr_milestones: Tuple[int, ...] = (4, 6)        # epochs
    lr_gamma: float = 0.01
    warmup_factor: float = 1e-5
    epochs: int = 8
    loss_alphas: Tuple[float, ...] = (1.0, 1.0)
    momentum: float = 0.9
    weight_decay: float = 0.005


def warmup_multistep_schedule(base_lr: float, warmup_iters: int,
                              milestone_iters: Sequence[int], gamma: float,
                              warmup_factor: float = 1e-5) -> Schedule:
    """The learning rate of update `step` (from 0) under WarmupMultiStepLR:
    a linear warm-up from warmup_factor x base_lr to base_lr over
    warmup_iters, times gamma ** (milestones passed); in float32, as the
    JAX schedule computes it (train_tsp.py:63-82)."""
    f32 = np.float32
    milestones = sorted(int(m) for m in milestone_iters)

    def schedule(step: int) -> float:
        s = f32(step)
        warm = f32(1.0)
        if warmup_iters > 0:
            alpha = min(max(s / f32(warmup_iters), f32(0)), f32(1))
            warm = f32(warmup_factor) * (f32(1) - alpha) + alpha
        decay = f32(gamma) ** f32(sum(s >= m for m in milestones))
        return float(f32(base_lr) * warm * decay)

    return schedule


def legacy_schedule(lr: float, warmup_steps: int, total_steps: int
                    ) -> Schedule:
    """The legacy single-group schedule (train_tsp.py:124-131): linear
    from 0 to lr over warmup_steps, then a cosine decay to 0 over the rest
    of total_steps."""
    warm = max(warmup_steps, 1)
    decay = max(total_steps - warmup_steps, 1)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return lr * min(step / warm, 1.0)
        c = min(step - warmup_steps, decay)
        return lr * 0.5 * (1.0 + math.cos(math.pi * c / decay))

    return schedule


def param_group(name: str) -> str:
    """The group of a TSPModel parameter (train.py:208-221): 'stem' (the
    initial convs and norms), 'backbone' (the residual stages) or 'fc'."""
    if name.startswith("features."):
        return "backbone" if name.startswith("features.layer") else "stem"
    return "fc"


@dataclasses.dataclass
class TSPTrainState:
    """The model, its optimizer, each group's schedule and the number of
    updates taken (what the port's CheckpointManager saves and restores)."""
    model: TSPModel
    optimizer: torch.optim.SGD
    schedules: List[Schedule]
    step: int = 0


def create_tsp_train_state(cfg: TSPTrainConfig, seed: int = 0,
                           steps_per_epoch: Optional[int] = None,
                           device=None) -> TSPTrainState:
    """The TSPModel of `cfg` on `device` (the card by default), initialised
    from `seed` with flax's defaults, and its SGD (train_tsp.py:111-149):
    one group per param_group with its schedule, or the legacy single
    group when backbone_lr is None."""
    dev = resolve_device(device)
    model = TSPModel(cfg.num_classes_list, cfg.backbone, cfg.use_gvf,
                     device=dev)
    init_backbone_params(model, torch.Generator(device=dev).manual_seed(seed))
    named = list(model.named_parameters())
    if cfg.backbone_lr is None:
        groups = [([p for _, p in named],
                   legacy_schedule(cfg.lr, cfg.warmup_steps,
                                   cfg.total_steps))]
    else:
        spe = steps_per_epoch or 1
        lrs = {"stem": 0.0, "backbone": cfg.backbone_lr, "fc": cfg.fc_lr}
        groups = []
        for label in ("stem", "backbone", "fc"):
            sched = warmup_multistep_schedule(
                lrs[label], cfg.lr_warmup_epochs * spe,
                [m * spe for m in cfg.lr_milestones], cfg.lr_gamma,
                cfg.warmup_factor)
            groups.append(([p for n, p in named if param_group(n) == label],
                           sched))
    opt = torch.optim.SGD([dict(params=p) for p, _ in groups], lr=0.0,
                          momentum=cfg.momentum,
                          weight_decay=cfg.weight_decay)
    return TSPTrainState(model, opt, [s for _, s in groups])


def _alphas(cfg: TSPTrainConfig) -> Tuple[float, ...]:
    return tuple(cfg.loss_alphas) + (1.0,) * (
        len(cfg.num_classes_list) - len(cfg.loss_alphas))


def _head_terms(logits, labels):
    """Per-head masked cross-entropy terms: (loss sum, correct, valid)."""
    valid = labels >= 0
    lab = labels.clamp(min=0)
    ce = F.cross_entropy(logits.float(), lab, reduction="none")
    correct = ((logits.argmax(-1) == lab) & valid).sum()
    return (ce * valid).sum(), correct, valid.sum()


def _to(dev, batch, use_gvf):
    clips = torch.as_tensor(np.asarray(batch["clips"])).to(dev)
    labels = [torch.as_tensor(np.asarray(l)).long().to(dev)
              for l in batch["labels"]]
    gvf = torch.as_tensor(np.asarray(batch["gvf"])).to(dev) \
        if use_gvf else None
    return clips, labels, gvf


def make_tsp_train_step(state: TSPTrainState, cfg: TSPTrainConfig):
    """step(batch, seed=None) -> metrics (loss_head{i}, acc_head{i},
    total_loss; detached 0-d tensors): the model in train mode (batch
    statistics, dropout drawn after torch.manual_seed(seed) when given),
    the alpha-mixed loss, its backward and one SGD update at each group's
    scheduled rate (train_tsp.py:152-187)."""
    alphas = _alphas(cfg)
    model, opt = state.model, state.optimizer

    def step(batch: Dict, seed: Optional[int] = None
             ) -> Dict[str, torch.Tensor]:
        dev = next(model.parameters()).device
        clips, labels, gvf = _to(dev, batch, cfg.use_gvf)
        for group, sched in zip(opt.param_groups, state.schedules):
            group["lr"] = sched(state.step)
        if seed is not None:
            torch.manual_seed(seed)
        model.train()
        _, logits = model(clips, gvf)
        total = 0.0
        metrics = {}
        for i, (lg, lab) in enumerate(zip(logits, labels)):
            loss_sum, correct, n = _head_terms(lg, lab)
            n = n.clamp(min=1)
            metrics[f"loss_head{i}"] = loss_sum / n
            metrics[f"acc_head{i}"] = correct / n
            total = total + alphas[i] * metrics[f"loss_head{i}"]
        opt.zero_grad(set_to_none=True)
        total.backward()
        opt.step()
        state.step += 1
        metrics["total_loss"] = total
        return {k: v.detach() for k, v in metrics.items()}

    return step


def make_tsp_eval_step(model: TSPModel, cfg: TSPTrainConfig):
    """step(batch) -> per-head loss sums, correct and valid counts and the
    alpha-mixed mean loss, with running statistics and no dropout
    (train_tsp.py:190-217)."""
    alphas = _alphas(cfg)

    @torch.no_grad()
    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        dev = next(model.parameters()).device
        clips, labels, gvf = _to(dev, batch, cfg.use_gvf)
        was_training = model.training
        model.eval()
        try:
            _, logits = model(clips, gvf)
        finally:
            model.train(was_training)
        out, total = {}, 0.0
        for i, (lg, lab) in enumerate(zip(logits, labels)):
            loss_sum, correct, n = _head_terms(lg, lab)
            out[f"loss_sum{i}"], out[f"correct{i}"] = loss_sum, correct
            out[f"valid{i}"] = n
            total = total + alphas[i] * loss_sum / n.clamp(min=1)
        out["total_loss"] = total
        return out

    return step


def evaluate_tsp(eval_step, batches: Iterable[Dict]) -> Dict[str, float]:
    """Validation over `batches`: each head's mean loss and accuracy over
    its valid labels and the mean of the batches' alpha-mixed loss
    (train_tsp.py:220-247; the reference MetricLogger's weighting)."""
    sums: Dict[str, float] = {}
    n_batches = 0
    for batch in batches:
        for k, v in eval_step(batch).items():
            sums[k] = sums.get(k, 0.0) + float(v)
        n_batches += 1
    results: Dict[str, float] = {}
    if not n_batches:
        return results
    i = 0
    while f"valid{i}" in sums:
        denom = max(sums[f"valid{i}"], 1.0)
        results[f"loss_head{i}"] = sums[f"loss_sum{i}"] / denom
        results[f"acc_head{i}"] = sums[f"correct{i}"] / denom
        i += 1
    results["avg_loss"] = sums.get("total_loss", 0.0) / n_batches
    return results


def train_tsp(cfg: TSPTrainConfig, batches: Iterator[Dict], num_steps: int,
              log_every: int = 50, checkpoint_dir: Optional[str] = None,
              device=None) -> Tuple[TSPModel, List[Dict[str, float]]]:
    """The step-driven loop (train_tsp.py:250-275): num_steps updates
    from seed 0, the metrics of every log_every-th step, and the model
    saved as `tsp-backbone` under checkpoint_dir. Returns (model,
    history)."""
    state = create_tsp_train_state(cfg, device=device)
    step = make_tsp_train_step(state, cfg)
    history = []
    for i, batch in enumerate(batches):
        if i >= num_steps:
            break
        metrics = step(batch, seed=i)
        if i % log_every == 0:
            history.append({k: float(v) for k, v in metrics.items()})
    if checkpoint_dir:
        from gvl_tpu_torch.train.checkpoint import CheckpointManager
        CheckpointManager(checkpoint_dir).save("tsp-backbone", state.model,
                                               None, 0)
    return state.model, history


class TSPTrainer:
    """The reference main()'s epoch loop (train.py:123-288): per-epoch
    training and validation, checkpoints `epoch_<N>` and `checkpoint`,
    resume, valid_only, train_only_one_epoch, metrics appended to
    `metrics.jsonl`. make_train_batches(epoch) and make_valid_batches()
    return fresh batch iterators (the sampler owns the shuffling)."""

    def __init__(self, cfg: TSPTrainConfig, make_train_batches,
                 make_valid_batches, steps_per_epoch: int,
                 output_dir: str = "", seed: int = 0, device=None):
        if cfg.backbone_lr is None:
            cfg = dataclasses.replace(cfg, backbone_lr=0.0001)
        self.cfg = cfg
        self.make_train_batches = make_train_batches
        self.make_valid_batches = make_valid_batches
        self.steps_per_epoch = steps_per_epoch
        self.output_dir = output_dir
        self.seed = seed
        self.state = create_tsp_train_state(cfg, seed, steps_per_epoch,
                                            device)
        self.model = self.state.model
        self._step = make_tsp_train_step(self.state, cfg)
        self._eval_step = make_tsp_eval_step(self.model, cfg)
        self.start_epoch = 0
        self._ckpt = None
        if output_dir:
            from gvl_tpu_torch.train.checkpoint import CheckpointManager
            self._ckpt = CheckpointManager(output_dir)

    def save_checkpoint(self, epoch: int) -> None:
        if self._ckpt is None:
            return
        for name in (f"epoch_{epoch}", "checkpoint"):
            self._ckpt.save(name, self.model, None, epoch, state=self.state)

    def resume(self, name: str = "checkpoint") -> bool:
        """Restore the model, the optimizer and the update count; the next
        epoch is the saved one + 1 (train.py:239-245)."""
        if self._ckpt is None:
            return False
        payload = self._ckpt.restore(name, self.state)
        if payload is None:
            return False
        self.start_epoch = int(payload["epoch"]) + 1
        return True

    def train_one_epoch(self, epoch: int) -> Dict[str, float]:
        last: Dict[str, float] = {}
        for i, batch in enumerate(self.make_train_batches(epoch)):
            if i >= self.steps_per_epoch:
                break
            metrics = self._step(batch, seed=(self.seed * 1_000_003
                                              + epoch * 1_000_003 + i))
            last = {k: float(v) for k, v in metrics.items()}
        return last

    def validate(self, epoch: int) -> Dict[str, float]:
        results = evaluate_tsp(self._eval_step, self.make_valid_batches())
        results["epoch"] = epoch
        if self.output_dir:
            with open(os.path.join(self.output_dir, "metrics.jsonl"),
                      "a") as f:
                f.write(json.dumps(results) + "\n")
        return results

    def fit(self, valid_only: bool = False,
            train_only_one_epoch: bool = False) -> List[Dict[str, float]]:
        if valid_only:
            return [self.validate(max(self.start_epoch - 1, 0))]
        history = []
        for epoch in range(self.start_epoch, self.cfg.epochs):
            train_metrics = self.train_one_epoch(epoch)
            self.save_checkpoint(epoch)
            train = {f"train_{k}": v for k, v in train_metrics.items()}
            if train_only_one_epoch:
                history.append({"epoch": epoch, **train})
                break
            val = self.validate(epoch)
            val.update(train)
            history.append(val)
        return history
