"""Smoke run of the PyTorch port on one NVIDIA GPU (built for an H100, sm_90a).

    python3 chip_smoke.py [--profile DIR] [--kernels-only] [--old-forms DIR]

Phases, one printed line or more each; any failure raises and the script
exits non-zero:
  1. device: name, `nvidia-smi` name and power limit, torch/CUDA versions;
     TF32 off for matmuls and cuDNN.
  2. build: nvcc builds the deformable-attention kernels from
     gvl_tpu_torch/csrc into build/kernels/ and logs ptxas's registers,
     spills and shared memory; with --old-forms DIR also the dense kernels
     of an earlier commit's package in DIR (see OldDense).
  3. kernel vs plain: the forward CUDA kernel against its plain PyTorch
     version at the flagship encoder (Lq=188) and decoder (Lq=30) shapes and
     at the long-video decoder shape (B=8 and B=4, S=1500, Lq=100), with
     taps in [0, 1], "wild" taps in [-0.4, 1.4], taps on level borders and
     "pile" taps (every tap of a (b, h) on three rows of each level); then
     normal and pile taps at the short pyramid 300+150+75 with K=6 and rows
     of 32, 64 and 128 floats and at a dense encoder over the long-video
     pyramid (B=1, Lq=S=1500); max abs error <= 1e-5. Times at the main
     shapes beside the library call that computes the same sum
     (F.embedding_bag on prepared taps) and, with --old-forms, the earlier
     kernel.
  4. main path: the flagship ActivityNet model as cfgs/anet_tsp_msvg_dvc.yml
     publishes it (hidden 512, 8 heads, 2+2 layers, 4 levels, 30 queries,
     vocab 8517; the contrastive text side on: attention word pool,
     layer-dependent text features, one sentence layer with the cosine
     position table, projections to 128; a frozen offline RoBERTa at
     roberta-base's widths and depth, hidden 768, 12 layers; grounding eval
     on; random weights from a seed) evaluated by
     gvl_tpu_torch.eval.evaluate.EvalRunner.run over 3 batches of 16
     synthetic videos with ActivityNet event counts, 5-20 word sentences
     and one video of 37 sentences (G = 30 slots, so its last 7 are
     grounded in a second text pass); checks the kernel launch count,
     finite outputs, the DVC JSON, both grounding JSONs (one key per GT
     sentence) and the eval losses.
  5. kernel path vs plain path: one batch through the model with the kernel
     and with the plain op; trunk outputs (event embeddings included) to
     1e-4, greedy tokens >= 99%; through the eval step, the grounding boxes
     (in lengths of their video) and cl_scores of both decoder layers to
     1e-4 and each eval loss to 1e-4 relative.
 5a. (flagship) matching scores: one batch through EvalRunner.run with
     eval_enable_matching_score and eval_matching_score_weight 1.0 on both
     paths: every prediction's cl_score finite, non-zero and a cosine, the
     reranked JSON written, the paths' cl_scores within 1e-4.
 5b. (flagship) the bf16-weight text pass (train_use_amp, eval_use_amp) on
     an eval step's tokens equals an f32 pass over weights rounded by hand
     (<= 1e-6); its difference from the f32 pass and both times logged.
  6. time: eval clips/s at B=16 for both paths: windows of back-to-back
     eval steps (tokenization, text pass, losses and grounding included),
     each window timed whole by CUDA events, the paths taken in turns; the
     per-round difference of the two paths.
  7. (with --profile DIR only) where one eval step's time goes: host time
     until the step returns vs device finish, trunk, text pass and caption
     decode, torch.profiler's device time and op count per step and its top
     device ops, the split of the step into its parts (device timeline and
     host clock, the matchers' waits included); the text encoder alone on the step's 480 x 32 tokens (CUDA
     events and torch.profiler) beside its FLOP bound and as a share of the
     step's device time and ops; writes the op tables and a Chrome trace
     into DIR.
  8. backward kernel vs plain: the backward CUDA kernels against their
     plain PyTorch version at the same shapes and classes (the long-video
     decoder at B=4, as the train step runs it) with a seeded output
     gradient; bounds per gradient in BWD_ABS_TOL and BWD_REL_TOL;
     grad_value bit-identical over N_REPEATS calls; without grad_value
     nothing is scattered. Times beside the kernels without grad_value,
     zeros_like alone, embedding_bag's autograd backward and, with
     --old-forms, the earlier kernel; the time of each of its two CUDA
     kernels (torch.profiler) beside that kernel's own bound. Runs right
     after phase 3.
  9. train main path: build_model on the card, the frozen text encoder,
     create_train_state, make_train_step, 5 steps on 2 alternating
     synthetic batches (B=16, 30 GT slots with ActivityNet event counts and
     their sentences, caption length 30, the contrastive weight 0.1 of
     epoch 2, so its loss and the matcher's contrastive cost are live, Adam
     at 5e-5, clip 100, dropout on); checks the loss keys, finite losses, 4
     forward + 4 backward kernel launches per step, a finite gradient on
     every parameter, that the parameters moved and the frozen text
     encoder did not (a text encoder that trains, phase 15: a finite
     gradient on each of its parameters, the pooler's exactly 0, and that
     it moved).
 10. kernel path vs plain path, gradients: one batch's loss and gradients
     with dropout off, through the kernels and through the plain op; total
     loss and the contrastive losses to 1e-4 relative, each named gradient
     (the text side's included, and a trained text encoder's) to 1e-3 x
     its max abs (+ 1e-8 for gradients that are zero but for rounding).
     Runs before
     phase 9, on the seeded weights: the gradient of a sampling location
     jumps where a tap crosses a value row, the 3e-6 between the paths'
     activations moves a few taps of a step across one, and a single such
     tap moves a small tensor's gradient by 1e-3 to 5e-2 of its max abs. On
     seeded weights and a seeded batch the same taps cross in every run, so
     the verdict is the same in every run; after train steps, whose float
     atomics land in a different order every time, it is not.
 11. train time: median of 10 CUDA-event-timed steps after 3 warm-up steps,
     steps/s and clips/s; the split into trunk forward, text pass,
     criterion (with the matcher's copy to the host and its solve, host
     clock), teacher forcing, backward, optimizer (with a text encoder that
     trains also its backward and its optimizer); peak device memory. With
     --profile DIR also torch.profiler's device time and op count per train
     step and its top device ops, and the text encoder alone as in phase 7
     (forward and backward when it trains, beside three times the forward's
     FLOP bound); the op tables go into DIR.
 12. banded kernel vs plain: the banded forward CUDA kernel against its
     plain PyTorch version at the long-video encoder shape of the eval step
     (YouMakeup widths: B=8, levels 800+400+200+100 = S 1500, H=8, Dh=64,
     K=16) over five tap classes: local (encoder reference points, offsets
     within +-4 rows; the band clamp inactive, also held to the dense plain
     op), wide (offsets of up to +-96 rows, the clamp engages), border (taps
     on rows 0 and T_l - 1 and beyond), pile (half of a tile's taps clamped
     onto the one last row of its band), top (the band start of the last
     level at its upper limit, the band reaching past the level); then
     local, wide and pile at the tiny long-video geometry of the CPU tests
     (levels 300+150+75, short tiles and levels, K=12) with H=8, Dh=64 and
     with rows of 32 and of 128 floats; each at margin 32 and at a margin
     that makes every band full; max abs error <= 1e-5. Medians at B=8 and
     B=4 beside the dense kernel and embedding_bag on the band-clamped taps
     on the same local inputs.
 13. banded backward kernel vs plain: same classes, geometries and margins
     at the train step's batch (B=4), bounds of phase 8; without grad_value
     nothing is scattered. Medians at B=4 and B=8, with and without
     grad_value, beside the dense kernel and embedding_bag's backward.
     A kernel's time (phases 3, 8, 12, 13) is the device's: each timed call
     is enqueued behind a kernel that spins while the host prepares it; the
     time per call from an idle device, the host's share included, is
     logged beside it.
 14. long-video eval main path: first, the YouMakeup-shaped model built with
     msda_impl='ref' launches the dense kernel 4 times and the banded one
     never in one forward (the JAX package's 'ref' is the exact dense op at
     every S); then the model as cfgs/ym_i3d_msvg_dvc.yml publishes it
     (hidden 512, 8 heads, 2+2 layers, 100 queries, vocab 1247, 1024-d
     features, 800 frames; the contrastive text side with
     layer-independent text features, the offline RoBERTa at 768 x 12,
     G = 64 sentence slots, grounding eval on) through EvalRunner.run over
     3 batches of 8 synthetic videos with 3-10 events and one video of 70
     sentences (its last 6 grounded in a second text pass): 2 banded + 2
     dense forward launches per batch, both grounding JSONs; then phases 5
     and 6 on this model (6 with fewer rounds).
 15. long-video train main path: 5 steps at B=4 (64 GT slots, 3-10 events
     per video with their sentences, captions of 30 tokens, Adam at 1e-4
     with L2 1e-4; the text encoder trained by its own Adam at 1e-5 with L2
     1e-4 on its multi_step schedule, its gradients clipped by their own
     norm): 2 launches per step of each of the four kernels, the text
     encoder's checks of phase 9; then phases 10 and 11 on it.
With --kernels-only the script stops after phases 1-3, 8, 12 and 13. With
--profile DIR phases 7 and 11 also profile the long-video steps. The last
two lines are the kernels' JSON summary (four kernels, each with the
library call's time, library_ms, the dense ones with the earlier kernel's,
old_ms, null without --old-forms, and the backward's with each of its two
CUDA kernels' time and bound, split) and {"ok": true, "device": {...}}. The run uses one card, the first visible.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time
import types

# one card, the first visible; set before torch initialises CUDA
os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get(
    "CUDA_VISIBLE_DEVICES", "0").split(",")[0]

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

SEED = 0
H, DH, P = 8, 64, 4
KERNEL_TOL = 1e-5
# grad_loc = attn * T_l * (d1 - d0) carries the factor T_l: its values reach
# several hundred (T_l <= 100) or thousand (T_l = 800), where one f32 ulp is
# 6.1e-5 to 4.9e-4, so its absolute bound is ten times the others' and every
# gradient is also held to BWD_REL_TOL x the plain result's max abs
BWD_ABS_TOL = {"grad_value": 1e-4, "grad_loc": 1e-3, "grad_attn": 1e-4}
BWD_REL_TOL = 1e-5
TRUNK_TOL = 1e-4
TOKEN_AGREEMENT = 0.99
N_BATCHES = 3
N_WINDOW = 10                   # phase 6: steps per window and path
N_PROFILED = 5
N_TRAIN_STEPS, N_TRAIN_TIMED, N_TRAIN_WARMUP, N_TRAIN_SPLIT = 5, 10, 3, 5
STEPS_PER_EPOCH = 100
# a gradient that is zero in exact arithmetic (the bias under a softmax) is
# rounding noise of ~1e-10 on either path: GRAD_FLOOR lets it pass
LOSS_TOL, GRAD_TOL, GRAD_FLOOR = 1e-4, 1e-3, 1e-8
TRAIN_LOSS_KEYS = {f"{k}{sfx}" for k in (
    "loss_ce", "loss_counter", "loss_bbox", "loss_giou", "loss_self_iou",
    "cardinality_error", "loss_caption") for sfx in ("", "_0")} | {"total_loss"}
CL_LOSS_KEYS = {"contrastive_loss", "contrastive_loss_0"}
GROUNDING_KEYS = {"timestamp", "score", "cl_score", "sentence"}
GROUNDING_TOL = 1e-4    # phase 5: boxes (in video lengths) and cl_scores
# NVIDIA H100 SXM data sheet: device memory rate, f32 rate outside the
# tensor cores
HBM_BYTES_PER_S, F32_FLOP_PER_S = 3.35e12, 67e12
SPIN_HZ = 2e9   # device_median_ms: no slower than the card's clock (1.98 GHz)
DVC_KEYS = {"timestamp", "raw_box", "label", "proposal_score", "sentence",
            "sentence_score", "cl_score", "query_id", "vid_duration",
            "pred_event_count"}

# __graft_entry__._flagship_cfg(tiny=False), contrastive off
FLAGSHIP_DVC = dict(
    hidden_dim=512, nheads=8, enc_layers=2, dec_layers=2,
    transformer_ff_dim=512, num_feature_levels=4, num_queries=30,
    feature_dim=512, frame_embedding_num=100, vocab_size=8517,
    input_encoding_size=512, rnn_size=512, att_hid_size=512,
    max_caption_len=30, cap_nheads=1, cap_num_feature_levels=4,
    max_eseq_length=10, with_box_refine=1, enable_contrastive=False,
    caption_decoder_type="standard", caption_loss_coef=2.0,
    count_loss_coef=0.5, eval_disable_captioning=False, ec_alpha=0.3,
    eval_matching_score_weight=0.0,
    # the loss and optimizer side of the same config, for the train step
    set_cost_class=2.0, set_cost_giou=4.0, set_cost_bbox=0.0,
    cls_loss_coef=2.0, giou_loss_coef=4.0, bbox_loss_coef=0.0, aux_loss=True,
    share_caption_head=1, fuse_caption_layers=True,
    transformer_dropout_prob=0.1, drop_prob=0.5, optimizer_type="adam",
    weight_decay=0.0, lr=5e-5, grad_clip=100.0, epoch=30,
    learning_strategy="multi_step")
# cfgs/anet_tsp_msvg_dvc.yml as published: the contrastive text side on, a
# frozen text encoder, grounding eval on; the offline RoBERTa at roberta-base's
# widths and depth (hidden 768, 12 layers, 12 heads, FFN 3072; its embedding
# table has the hash tokenizer's 5000 rows, not 50265)
FLAGSHIP = dict(
    FLAGSHIP_DVC, enable_contrastive=True, enable_cross_video_cl=True,
    enable_layer_diff_text_feature=True, enable_word_context_modeling=True,
    word_context_modeling_type="attention_pool",
    enable_sentence_context_modeling=True, enable_sentence_pos_embedding=True,
    sentence_pos_embedding_type="cosine", sentence_modeling_layer_num=1,
    contrastive_hidden_size=128, contrastive_loss_temperature=0.1,
    set_cost_cl=2.0, cl_schedule_time=[0, 2], cl_schedule_val=[0, 0.1],
    eval_enable_grounding=True, eval_set_cost_cl=1.0, eval_set_cost_class=0.0,
    text_encoder_learning_strategy="frozen", max_text_input_len=32,
    gt_proposal_sample_num=30, eval_batch_size=16,
    load_pretrained_language_model_from_config="offline",
    offline_text_encoder_hidden=768, offline_text_encoder_layers=12, seed=777,
    ec_alpha=1.0)
CL_EPOCH = 2        # the contrastive weight's schedule value from this epoch
# cfgs/ym_i3d_msvg_dvc.yml as published, at the trunk widths it shares with
# the flagship (YouMakeup: 800 frames of 1024-d i3d features, 100 queries,
# vocab 1247): the contrastive text side with layer-independent text
# features, grounding eval, G = min(gt_proposal_sample_num 300, 64) = 64
# sentence slots, Adam with L2 1e-4, and the text encoder trained by an Adam
# of its own on a multi_step schedule (1e-5, halved every 3 epochs from 8)
LONGVIDEO = dict(
    FLAGSHIP, num_queries=100, feature_dim=1024, frame_embedding_num=800,
    vocab_size=1247, lr=1e-4, weight_decay=1e-4, epoch=25, ec_alpha=0.3,
    enable_layer_diff_text_feature=False, gt_proposal_sample_num=300,
    eval_batch_size=8, text_encoder_learning_strategy="multi_step",
    text_encoder_lr=1e-5, text_encoder_lr_decay_start=8,
    text_encoder_lr_decay_every=3, text_encoder_lr_decay_rate=0.5)


@dataclasses.dataclass(frozen=True)
class Workload:
    """One model configuration and the batches both of its paths run."""
    name: str
    tag: str                 # prefix of the phases' log tags
    cfg: dict
    shapes: tuple            # the pyramid's level lengths
    eval_B: int
    train_B: int
    max_gt: int              # GT slots of a train batch
    gt_counts: tuple         # (lo, hi) events per video; None: ActivityNet's
    duration: tuple          # seconds, (lo, hi)
    n_rounds: int            # phase 6: paired rounds of N_WINDOW steps
    long_sentences: int = 0  # phases 4, 14: one eval video has this many
                             # sentences, more than max_gt

    @property
    def trains_text(self) -> bool:
        """The text encoder trains (text_encoder_learning_strategy)."""
        return self.contrastive and self.cfg.get(
            "text_encoder_learning_strategy", "frozen") != "frozen"

    @property
    def contrastive(self) -> bool:
        """The text side runs: text encoder, grounding, contrastive loss."""
        return bool(self.cfg.get("enable_contrastive", False))

    @property
    def banded(self) -> bool:
        """Encoder self-attention goes to the banded kernels (S >= 512)."""
        return sum(self.shapes) >= 512

    def launches_per_step(self) -> dict:
        """Forward launches of the dense and the banded kernel in one trunk
        forward; the backward kernels launch as often in a train step."""
        enc, dec = self.cfg["enc_layers"], self.cfg["dec_layers"]
        return ({"dense": dec, "banded": enc} if self.banded
                else {"dense": enc + dec, "banded": 0})


ANET = Workload("anet", "", FLAGSHIP, (100, 50, 25, 13), eval_B=16,
                train_B=16, max_gt=30, gt_counts=None, duration=(30, 200),
                n_rounds=10, long_sentences=37)
LONG = Workload("longvideo", "lv", LONGVIDEO, (800, 400, 200, 100), eval_B=8,
                train_B=4, max_gt=64, gt_counts=(3, 10), duration=(100, 300),
                n_rounds=5, long_sentences=70)
LV_MARGIN = 32               # msda_band_margin's default, as the model runs it


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def _median_event_ms(fn, n: int, spin_cycles: int = 0) -> float:
    """Median over n calls of fn, each between its own pair of CUDA events;
    with spin_cycles each call is enqueued behind a kernel that spins so
    long."""
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if spin_cycles:
            torch.cuda._sleep(spin_cycles)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_median_ms(fn, n: int, warmup: int = 3) -> float:
    """Median over n calls of fn of the time the device takes for one call:
    each call waits on the device behind a kernel that spins for longer than
    the host takes to enqueue it, so the host's share of a call (checks,
    ctypes, the launch) stays out of the measurement."""
    host_s = 0.0
    for _ in range(warmup):
        t0 = time.perf_counter()
        fn()
        host_s = max(host_s, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return _median_event_ms(fn, n, int((2 * host_s + 2e-4) * SPIN_HZ))


def kernel_split_ms(fn, n: int = 20) -> dict:
    """Device time per CUDA kernel of one call of fn, by torch.profiler
    over n calls: kernel name -> ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / 1e3 / n
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation}


def cuda_median_ms(fn, n: int, warmup: int = 3) -> float:
    """Median over n calls of fn on an idle device, each between its own
    pair of CUDA events: the host's share of the call included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return _median_event_ms(fn, n)


def kernel_fns():
    from gvl_tpu_torch.ops import ms_deform_attn_1d, ms_deform_attn_1d_banded
    return ms_deform_attn_1d, ms_deform_attn_1d_banded


def reset_counts() -> None:
    for fn in kernel_fns():
        fn.launches = fn.bwd_launches = 0


def read_counts() -> dict:
    dense, banded = kernel_fns()
    return {"fwd": dense.launches, "bwd": dense.bwd_launches,
            "banded_fwd": banded.launches, "banded_bwd": banded.bwd_launches}


def want_counts(w: Workload, steps: int, train: bool) -> dict:
    per = w.launches_per_step()
    return {"fwd": per["dense"] * steps,
            "bwd": per["dense"] * steps * train,
            "banded_fwd": per["banded"] * steps,
            "banded_bwd": per["banded"] * steps * train}


# ---------------------------------------------------------------- phase 1
def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU only")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", f"{name}; torch {torch.__version__}, CUDA "
                  f"{torch.version.cuda}, python {sys.version.split()[0]}; "
                  f"devices {torch.cuda.device_count()}; TF32 off")
    check(torch.cuda.device_count() == 1, "one visible card")
    print(smi, flush=True)
    return name


# ---------------------------------------------------------------- phase 2
def phase_build() -> None:
    from gvl_tpu_torch.ops import _build
    t0 = time.perf_counter()
    built = _build.build()
    _build.library()
    log("build", f"{built.path.relative_to(_build._ROOT)}: nvcc "
                 f"{built.seconds:.3f} s ({'built' if built.seconds else 'cached'}), "
                 f"load {time.perf_counter() - t0:.3f} s total")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            log("build", "ptxas: " + line.strip())


def _swap_package(modules: dict) -> dict:
    """Puts `modules`, a gvl_tpu_torch package's entries of sys.modules, in
    place of the ones there, and returns those."""
    out = {k: sys.modules.pop(k) for k in list(sys.modules)
           if k.split(".")[0] == "gvl_tpu_torch"}
    sys.modules.update(modules)
    return out


class OldDense:
    """The dense kernels of an earlier commit, called through that commit's
    own wrappers (`ms_deform_attn_1d_cuda`, `ms_deform_attn_1d_bwd_cuda`),
    whatever arguments its C entries take. DIR holds the commit's
    gvl_tpu_torch package (`git archive COMMIT gvl_tpu_torch | tar -x -C
    DIR`); it is imported beside this one, not in its place, builds its
    kernels into DIR/build/kernels, and is put in sys.modules for the length
    of each call, since its wrappers import their library there."""

    def __init__(self, root: pathlib.Path):
        import importlib
        mine = _swap_package({})
        sys.path.insert(0, str(root.resolve()))
        try:
            self.ops = importlib.import_module("gvl_tpu_torch.ops")
            build = importlib.import_module("gvl_tpu_torch.ops._build")
            built = build.build()
            build.library()
        finally:
            sys.path.pop(0)
            self.modules = _swap_package(mine)
        log("build", f"old dense forms from {root}: nvcc "
                     f"{built.seconds:.3f} s")

    def _call(self, fn, *args):
        mine = _swap_package(self.modules)
        try:
            return fn(*args)
        finally:
            self.modules = _swap_package(mine)

    def fwd(self, value, shapes, loc, attn):
        return self._call(self.ops.ms_deform_attn_1d_cuda, value, shapes, loc,
                          attn)

    def bwd(self, grad_out, value, shapes, loc, attn):
        return self._call(self.ops.ms_deform_attn_1d_bwd_cuda, grad_out,
                          value, shapes, loc, attn)


# ---------------------------------------------------------------- phase 3
# label -> (level lengths, batch of the forward, batch of the backward, Lq):
# every shape a main path gives the dense kernels. The forward runs in the
# eval step and in the train step, so where the two batches differ the train
# batch gets a forward case of its own (no backward: None).
DENSE_CASES = {
    "encoder": (ANET.shapes, ANET.eval_B, ANET.train_B, sum(ANET.shapes)),
    "decoder": (ANET.shapes, ANET.eval_B, ANET.train_B, 30),
    "longvideo_decoder": (LONG.shapes, LONG.eval_B, LONG.train_B, 100),
    "longvideo_decoder_train": (LONG.shapes, LONG.train_B, None, 100),
}
assert ANET.eval_B == ANET.train_B
DENSE_KINDS = ("normal", "wild", "border", "pile")
# phase 8: the backward kernel's grad_value is held bit-identical over this
# many calls
N_REPEATS = 20
# the tiny long-video model of the CPU tests: 300 frames, three levels, none
# a multiple of 128 and two not of 8
TINY_SHAPES = (300, 150, 75)
# (level lengths, batch, queries, heads, head width, points) that phases 3
# and 8 check beside the main paths' shapes: the short pyramid with K=6 and
# rows of 32, 64 and 128 floats, and a dense encoder over the long-video
# pyramid (Lq = S = 1500), whose taps the backward's value kernel walks in
# several chunks and row ranges
DENSE_GEOMETRIES = ((TINY_SHAPES, 2, 70, 4, 32, 2),
                    (TINY_SHAPES, 2, 70, H, DH, 2),
                    (TINY_SHAPES, 2, 70, 2, 128, 2),
                    (LONG.shapes, 1, sum(LONG.shapes), H, DH, P))


def msda_inputs(kind: str, shapes, B: int, Lq: int, gen: torch.Generator, dev,
                heads: int = H, dh: int = DH, points: int = P):
    """value, loc, attn for Lq queries over the pyramid `shapes`. normal:
    taps in [0, 1]; wild: in [-0.4, 1.4]; border: on rows 0 and T_l - 1, one
    row inside them, and beyond them; pile: every tap of a (b, h) on three
    rows of each level, rows T_l // 2 and T_l // 2 + 1 (three taps in four)
    and the clamped last row T_l - 1 (one in four)."""
    L = len(shapes)
    S = sum(shapes)
    value = torch.randn(B, S, heads, dh, generator=gen, device=dev)
    size = (B, Lq, heads, L, points)
    attn = torch.rand(size, generator=gen, device=dev) + 1e-3
    attn = attn / attn.sum(dim=(3, 4), keepdim=True)
    t = torch.tensor(shapes, dtype=torch.float32, device=dev)[:, None]
    if kind == "border":
        loc = torch.empty(size, device=dev)
        for l, T in enumerate(shapes):
            special = torch.tensor([0.5 / T, (T - 0.5) / T, 1.5 / T,
                                    (T - 1.5) / T, 0.0, 1.0, -0.3, 1.3],
                                   device=dev)
            pick = torch.randint(0, len(special), (B, Lq, heads, points),
                                 generator=gen, device=dev)
            loc[..., l, :] = special[pick]
    elif kind == "pile":
        mid = (torch.div(t, 2, rounding_mode="floor") + 0.5
               + 0.99 * torch.rand(size, generator=gen, device=dev)) / t
        last = torch.rand(size, generator=gen, device=dev) < 0.25
        loc = torch.where(last, torch.full_like(mid, 1.3), mid)
    else:
        lo, hi = (-0.4, 1.4) if kind == "wild" else (0.0, 1.0)
        loc = lo + (hi - lo) * torch.rand(size, generator=gen, device=dev)
    return value, loc, attn


def check_forward(tag: str, got, want) -> float:
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    log(tag.split()[0], f"{tag}: max abs err {err!r}")
    check(math.isfinite(err) and err <= KERNEL_TOL,
          f"kernel vs plain at {tag}: {err} > {KERNEL_TOL}")
    return err


def check_backward(tag: str, got, want) -> float:
    """Bounds per gradient: max abs error <= BWD_ABS_TOL[name] x max(1, the
    plain result's max abs / 1000) and <= BWD_REL_TOL x that max abs. No tap
    is excluded: on a clamp bound both give 0."""
    torch.cuda.synchronize()
    worst = 0.0
    for name, g, w in zip(("grad_value", "grad_loc", "grad_attn"), got, want):
        err = (g - w).abs().max().item()
        scale = w.abs().max().item()
        worst = max(worst, err)
        log(tag.split()[0], f"{tag} {name}: max abs err {err!r}, plain max "
                            f"abs {scale!r}")
        check(math.isfinite(err)
              and err <= BWD_ABS_TOL[name] * max(1.0, scale / 1e3)
              and err <= BWD_REL_TOL * scale,
              f"backward kernel vs plain at {tag}/{name}: {err} (max abs "
              f"{scale})")
    return worst


def dense_cases(gen: torch.Generator, dev, backward: bool):
    """Every (tag, shapes, inputs) phases 3 and 8 check: all tap classes at
    the main paths' shapes (the backward at its train batches), normal and
    pile taps at DENSE_GEOMETRIES."""
    for label, (shapes, fwd_B, bwd_B, Lq) in DENSE_CASES.items():
        B = bwd_B if backward else fwd_B
        if B is None:
            continue
        for kind in DENSE_KINDS:
            yield (f"{label} B={B} Lq={Lq} {kind}", shapes,
                   msda_inputs(kind, shapes, B, Lq, gen, dev))
    for shapes, B, Lq, heads, dh, points in DENSE_GEOMETRIES:
        for kind in ("normal", "pile"):
            yield (f"B={B} S={sum(shapes)} Lq={Lq} H={heads} Dh={dh} "
                   f"K={len(shapes) * points} {kind}", shapes,
                   msda_inputs(kind, shapes, B, Lq, gen, dev, heads, dh,
                               points))


def library_fwd(value, rows0, rows1, w0, w1):
    """The yardstick of the forward kernels: one F.embedding_bag over the
    taps' rows, its inputs prepared here, outside the timed call."""
    from gvl_tpu_torch.ops.ms_deform_attn import embedding_bag_inputs
    table, idx, w = embedding_bag_inputs(value, rows0, rows1, w0, w1)
    return lambda: F.embedding_bag(idx, table, mode="sum",
                                   per_sample_weights=w)


def library_bwd(value, rows0, rows1, w0, w1, grad_out):
    """The yardstick of the backward kernels: the autograd backward of that
    call, the gradients of the table (grad_value) and of the weights (the
    per-tap dot products), its graph kept between calls."""
    from gvl_tpu_torch.ops.ms_deform_attn import embedding_bag_inputs
    table, idx, w = embedding_bag_inputs(value, rows0, rows1, w0, w1)
    table, w = table.detach().requires_grad_(), w.detach().requires_grad_()
    out = F.embedding_bag(idx, table, mode="sum", per_sample_weights=w)
    go = grad_out.reshape(out.shape)
    return lambda: torch.autograd.grad(out, (table, w), go, retain_graph=True)


def phase_kernel_vs_plain(dev, old) -> dict:
    from gvl_tpu_torch.ops import (ms_deform_attn_1d_cuda,
                                   ms_deform_attn_1d_ref, prep_taps)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = 0.0
    for tag, shapes, (value, loc, attn) in dense_cases(gen, dev, False):
        worst = max(worst, check_forward(
            f"kernel {tag}", ms_deform_attn_1d_cuda(value, shapes, loc, attn),
            ms_deform_attn_1d_ref(value, shapes, loc, attn)))
    times = {}
    for label, (shapes, B, _, Lq) in DENSE_CASES.items():
        value, loc, attn = msda_inputs("normal", shapes, B, Lq, gen, dev)
        want = ms_deform_attn_1d_ref(value, shapes, loc, attn)

        def kernel():
            return ms_deform_attn_1d_cuda(value, shapes, loc, attn)
        library = library_fwd(value, *prep_taps(shapes, loc, attn))
        lib_err = (library().view(want.shape) - want).abs().max().item()
        tm = dict(ms=device_median_ms(kernel, 50),
                  call_ms=cuda_median_ms(kernel, 50),
                  plain_ms=device_median_ms(lambda: ms_deform_attn_1d_ref(
                      value, shapes, loc, attn), 50),
                  library_ms=device_median_ms(library, 50), old_ms=None)
        msg = ""
        if old is not None:
            old_err = (old.fwd(value, shapes, loc, attn) - want).abs().max()
            tm["old_ms"] = device_median_ms(
                lambda: old.fwd(value, shapes, loc, attn), 50)
            msg = (f", the old form {tm['old_ms']!r} ms (max abs err "
                   f"{old_err.item()!r})")
        times[label] = tm
        log("kernel", f"{label} B={B} S={sum(shapes)} Lq={Lq} H={H} "
                      f"Dh={DH} K={len(shapes) * P}: kernel {tm['ms']!r} ms "
                      f"on the device ({tm['call_ms']!r} ms per call from an "
                      f"idle device, the host's share included), plain "
                      f"{tm['plain_ms']!r} ms, embedding_bag "
                      f"{tm['library_ms']!r} ms (max abs err {lib_err!r})"
                      f"{msg} (medians of 50)")
    return dict(max_abs_err=worst, times=times)


# ---------------------------------------------------------------- phase 8
def phase_bwd_kernel_vs_plain(dev, old) -> dict:
    """The backward kernel against its plain version, same inputs."""
    from gvl_tpu_torch.ops import (ms_deform_attn_1d_bwd_cuda,
                                   ms_deform_attn_1d_bwd_ref, prep_taps)
    from gvl_tpu_torch.ops.ms_deform_attn import bwd_plan
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    worst = 0.0
    for tag, shapes, (value, loc, attn) in dense_cases(gen, dev, True):
        B, Lq = loc.shape[:2]
        grad_out = torch.randn(B, Lq, value.shape[2] * value.shape[3],
                               generator=gen, device=dev)
        got = ms_deform_attn_1d_bwd_cuda(grad_out, value, shapes, loc, attn)
        want = ms_deform_attn_1d_bwd_ref(grad_out, value, shapes, loc, attn)
        worst = max(worst, check_backward(f"bwd {tag}", got, want))
        no_value = ms_deform_attn_1d_bwd_cuda(
            grad_out, value, shapes, loc, attn, need_value=False)
        check(no_value[0] is None and torch.equal(no_value[1], got[1])
              and torch.equal(no_value[2], got[2]),
              "backward kernel without grad_value")
        # grad_value the same, bit for bit, in every run
        check(all(torch.equal(ms_deform_attn_1d_bwd_cuda(
            grad_out, value, shapes, loc, attn)[0], got[0])
            for _ in range(N_REPEATS)),
            f"grad_value differs between runs at {tag}")
        plan = bwd_plan(B, sum(shapes), value.shape[2], value.shape[3], Lq,
                        loc.shape[3] * loc.shape[4])
        log("bwd", f"{tag}: {plan}; grad_value bit-identical over "
                   f"{N_REPEATS} repeats")
    times = {}
    for label, (shapes, _, B, Lq) in DENSE_CASES.items():
        if B is None:
            continue
        value, loc, attn = msda_inputs("normal", shapes, B, Lq, gen, dev)
        grad_out = torch.randn(B, Lq, H * DH, generator=gen, device=dev)
        want = ms_deform_attn_1d_bwd_ref(grad_out, value, shapes, loc, attn)

        def kernel(need_value=True):
            return ms_deform_attn_1d_bwd_cuda(grad_out, value, shapes, loc,
                                              attn, need_value=need_value)
        library = library_bwd(value, *prep_taps(shapes, loc, attn), grad_out)
        lib_err = (library()[0].view(value.shape) - want[0]).abs().max()
        tm = dict(ms=device_median_ms(kernel, 50),
                  call_ms=cuda_median_ms(kernel, 50),
                  no_value_ms=device_median_ms(lambda: kernel(False), 50),
                  zeros_ms=device_median_ms(
                      lambda: torch.zeros_like(value), 50),
                  plain_ms=device_median_ms(lambda: ms_deform_attn_1d_bwd_ref(
                      grad_out, value, shapes, loc, attn), 50),
                  library_ms=device_median_ms(library, 50), old_ms=None,
                  split_ms=kernel_split_ms(kernel))
        msg = ""
        if old is not None:
            old_err = (old.bwd(grad_out, value, shapes, loc, attn)[0]
                       - want[0]).abs().max()
            tm["old_ms"] = device_median_ms(
                lambda: old.bwd(grad_out, value, shapes, loc, attn), 50)
            msg = (f", the old form {tm['old_ms']!r} ms (grad_value max abs "
                   f"err {old_err.item()!r})")
        times[label] = tm
        log("bwd", f"{label} B={B} S={sum(shapes)} Lq={Lq} H={H} "
                   f"Dh={DH} K={len(shapes) * P}: kernel {tm['ms']!r} ms on "
                   f"the device ({tm['call_ms']!r} ms per call from an idle "
                   f"device, the host's share included; "
                   f"{tm['no_value_ms']!r} ms without grad_value; "
                   f"zeros_like(value) alone {tm['zeros_ms']!r} ms), plain "
                   f"{tm['plain_ms']!r} ms, embedding_bag's backward "
                   f"{tm['library_ms']!r} ms (grad_value max abs err "
                   f"{lib_err.item()!r}){msg} (medians of 50); by "
                   f"torch.profiler, ms a call: {tm['split_ms']!r}")
    return dict(max_abs_err=worst, times=times)


# --------------------------------------------------------- phases 12, 13
# tap class -> does the band clamp engage at the model's margin (the plain
# banded result then differs from the plain dense one)
BANDED_KINDS = {"local": False, "wide": True, "border": True, "pile": True,
                "top": False}
FULL_MARGIN = max(LONG.shapes)       # every band is its whole padded level
# TINY_SHAPES: K = 12 taps does not divide a block
# (level lengths, batch, heads, head width): the long-video encoder, then
# short tiles and short levels, then rows of half and of twice the width
BANDED_GEOMETRIES = ((LONG.shapes, None, H, DH), (TINY_SHAPES, 2, H, DH),
                     (TINY_SHAPES, 2, 4, 32), (TINY_SHAPES, 2, 2, 128))


def banded_inputs(kind: str, B: int, gen: torch.Generator, dev,
                  shapes=LONG.shapes, heads: int = H, dh: int = DH):
    """One query per token of the pyramid `shapes`. local: the encoder's
    reference points (the query's own normalised position in every level)
    with offsets within +-4 rows; wide: offsets of up to +-96 rows, three
    times the margin; border: the special taps of `msda_inputs`; pile: the
    even points of every query at 0.1 and the odd ones at 0.9 of each level
    (+-1 row), so that in most tiles half of the taps are clamped onto the
    one last row of the band, lower and upper row alike; top: local, but
    every tap into the last level at or above the highest band start any
    tile may have there (T_pad - BS of the finest query level) and up to two
    rows past the level, so that the band start is at its upper limit T_pad
    - BS and the band reaches past T_l."""
    L, S = len(shapes), sum(shapes)
    value = torch.randn(B, S, heads, dh, generator=gen, device=dev)
    attn = torch.rand(B, S, heads, L, P, generator=gen, device=dev) + 1e-3
    attn = attn / attn.sum(dim=(3, 4), keepdim=True)
    t = torch.tensor(shapes, dtype=torch.float32, device=dev)[:, None]
    if kind == "border":
        _, loc, _ = msda_inputs("border", shapes, B, S, gen, dev)
        return value, loc[:, :, :heads].contiguous(), attn
    noise = 2 * torch.rand(attn.shape, generator=gen, device=dev) - 1
    if kind == "pile":
        centre = torch.tensor([0.1, 0.9] * P, device=dev)[:P]
        return value, (centre + noise / t).contiguous(), attn
    ref = torch.cat([(torch.arange(T, device=dev) + 0.5) / T for T in shapes])
    spread = 3.0 * LV_MARGIN if kind == "wide" else 4.0
    loc = ref[None, :, None, None, None] + noise * spread / t
    if kind == "top":
        from gvl_tpu_torch.ops.ms_deform_attn_banded import (band_table,
                                                             padded_shapes)
        last = shapes[-1]
        limit = padded_shapes(shapes)[-1] - min(
            row[-1] for row in band_table(shapes, LV_MARGIN))
        loc[..., -1, :] = (limit + 0.5 + (last + 2 - limit) * torch.rand(
            loc[..., -1, :].shape, generator=gen, device=dev)) / last
    return value, loc.contiguous(), attn


def banded_cases(gen: torch.Generator, dev, main_B: int):
    """Every (tag, shapes, margin, clamp engages, inputs) phases 12 and 13
    check: all tap classes at the long-video encoder shape, three at the
    other geometries; each at the model's margin and with full bands."""
    for shapes, B, heads, dh in BANDED_GEOMETRIES:
        main = shapes == LONG.shapes
        for kind, engages in BANDED_KINDS.items():
            if not main and kind in ("border", "top"):
                continue
            inputs = banded_inputs(kind, main_B if main else B, gen, dev,
                                   shapes, heads, dh)
            for margin in (LV_MARGIN, max(shapes)):
                tag = (f"B={inputs[0].shape[0]} S={sum(shapes)} H={heads} "
                       f"Dh={dh} {kind} margin={margin}")
                yield (tag, shapes, margin, engages and margin == LV_MARGIN,
                       inputs)


def phase_banded_kernel_vs_plain(dev) -> dict:
    from gvl_tpu_torch.ops import (ms_deform_attn_1d_banded_cuda,
                                   ms_deform_attn_1d_banded_ref,
                                   ms_deform_attn_1d_cuda,
                                   ms_deform_attn_1d_ref, prep_taps)
    from gvl_tpu_torch.ops.ms_deform_attn_banded import banded_rows
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    shapes = LONG.shapes
    worst = 0.0
    for tag, shp, margin, engages, (value, loc, attn) in banded_cases(
            gen, dev, LONG.eval_B):
        want = ms_deform_attn_1d_banded_ref(value, shp, loc, attn, margin)
        worst = max(worst, check_forward(
            f"banded {tag}",
            ms_deform_attn_1d_banded_cuda(value, shp, loc, attn, margin), want))
        clamped = (want - ms_deform_attn_1d_ref(value, shp, loc, attn)
                   ).abs().max().item()
        log("banded", f"{tag}: plain banded vs plain dense max abs diff "
                      f"{clamped!r}")
        # the clamp is inactive on local and top taps and in full bands, and
        # engages on wide, border and pile taps at the model's margin
        check((clamped > KERNEL_TOL) == engages,
              f"band clamp at {tag}: diff {clamped}")
    times = {}
    for b in (LONG.eval_B, LONG.train_B):    # the eval and the train batch
        value, loc, attn = banded_inputs("local", b, gen, dev)
        worst = max(worst, check_forward(
            f"banded B={b} local margin={LV_MARGIN}, timed inputs",
            ms_deform_attn_1d_banded_cuda(value, shapes, loc, attn, LV_MARGIN),
            ms_deform_attn_1d_banded_ref(value, shapes, loc, attn, LV_MARGIN)))

        def kernel():
            return ms_deform_attn_1d_banded_cuda(value, shapes, loc, attn,
                                                 LV_MARGIN)
        g0, g1, w0, w1 = prep_taps(shapes, loc, attn)
        library = library_fwd(
            value, *banded_rows(shapes, g0, g1, LV_MARGIN), w0, w1)
        times[b] = dict(
            ms=device_median_ms(kernel, 50), call_ms=cuda_median_ms(kernel, 50),
            plain_ms=device_median_ms(lambda: ms_deform_attn_1d_banded_ref(
                value, shapes, loc, attn, LV_MARGIN), 20),
            dense_kernel_ms=device_median_ms(lambda: ms_deform_attn_1d_cuda(
                value, shapes, loc, attn), 50),
            library_ms=device_median_ms(library, 50))
        log("banded", f"B={b} S=Lq={sum(shapes)} H={H} Dh={DH} "
                      f"K={len(shapes) * P} margin={LV_MARGIN}, local taps: "
                      f"kernel {times[b]['ms']!r} ms on the device "
                      f"({times[b]['call_ms']!r} ms per call from an idle "
                      f"device, the host's share included), plain "
                      f"{times[b]['plain_ms']!r} ms, the dense kernel on the "
                      f"same inputs {times[b]['dense_kernel_ms']!r} ms, "
                      f"embedding_bag on the band-clamped taps "
                      f"{times[b]['library_ms']!r} ms (medians of 50 / 50 / "
                      f"20 / 50 / 50)")
    return dict(max_abs_err=worst, times=times)


def phase_banded_bwd_kernel_vs_plain(dev) -> dict:
    from gvl_tpu_torch.ops import (ms_deform_attn_1d_banded_bwd_cuda,
                                   ms_deform_attn_1d_banded_bwd_ref,
                                   ms_deform_attn_1d_bwd_cuda, prep_taps)
    from gvl_tpu_torch.ops.ms_deform_attn_banded import banded_rows
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    shapes = LONG.shapes
    worst = 0.0
    for tag, shp, margin, _, (value, loc, attn) in banded_cases(
            gen, dev, LONG.train_B):
        grad_out = torch.randn(value.shape[0], sum(shp),
                               value.shape[2] * value.shape[3], generator=gen,
                               device=dev)
        got = ms_deform_attn_1d_banded_bwd_cuda(
            grad_out, value, shp, loc, attn, margin)
        want = ms_deform_attn_1d_banded_bwd_ref(
            grad_out, value, shp, loc, attn, margin)
        worst = max(worst, check_backward(f"bbwd {tag}", got, want))
        no_value = ms_deform_attn_1d_banded_bwd_cuda(
            grad_out, value, shp, loc, attn, margin, need_value=False)
        check(no_value[0] is None and torch.equal(no_value[1], got[1])
              and torch.equal(no_value[2], got[2]),
              "banded backward kernel without grad_value")
    times = {}
    for b in (LONG.train_B, LONG.eval_B):
        value, loc, attn = banded_inputs("local", b, gen, dev)
        grad_out = torch.randn(b, sum(shapes), H * DH, generator=gen,
                               device=dev)

        def kernel(need_value=True):
            return ms_deform_attn_1d_banded_bwd_cuda(
                grad_out, value, shapes, loc, attn, LV_MARGIN,
                need_value=need_value)
        g0, g1, w0, w1 = prep_taps(shapes, loc, attn)
        library = library_bwd(
            value, *banded_rows(shapes, g0, g1, LV_MARGIN), w0, w1, grad_out)
        times[b] = dict(
            ms=device_median_ms(kernel, 50), call_ms=cuda_median_ms(kernel, 50),
            no_value_ms=device_median_ms(lambda: kernel(False), 50),
            plain_ms=device_median_ms(lambda: ms_deform_attn_1d_banded_bwd_ref(
                grad_out, value, shapes, loc, attn, LV_MARGIN), 20),
            dense_kernel_ms=device_median_ms(lambda: ms_deform_attn_1d_bwd_cuda(
                grad_out, value, shapes, loc, attn), 50),
            library_ms=device_median_ms(library, 50))
        log("bbwd", f"B={b} S=Lq={sum(shapes)} H={H} Dh={DH} "
                    f"K={len(shapes) * P} margin={LV_MARGIN}, local taps: "
                    f"kernel {times[b]['ms']!r} ms on the device, zeroing "
                    f"grad_value included ({times[b]['call_ms']!r} ms per "
                    f"call from an idle device, the host's share included; "
                    f"{times[b]['no_value_ms']!r} ms without grad_value), "
                    f"plain {times[b]['plain_ms']!r} ms, the dense backward "
                    f"kernel on the same inputs "
                    f"{times[b]['dense_kernel_ms']!r} ms, embedding_bag's "
                    f"backward on the band-clamped taps "
                    f"{times[b]['library_ms']!r} ms (medians of 50 / 50 / 50 "
                    f"/ 20 / 50 / 50)")
    return dict(max_abs_err=worst, times=times)


# ---------------------------------------------------------------- phase 4
class WordTranslator:
    """Token id i -> word 'w<i>', cut at the first 0, as Translator does."""

    def rtranslate(self, ids) -> str:
        out = []
        for i in ids:
            if int(i) == 0:
                break
            out.append(f"w{int(i)}")
        return " ".join(out) + "." if out else ""


WORDS = ("a man woman person group people ball dog horse car the on in of "
         "with and then is are runs walks jumps talks plays throws catches "
         "holds shows camera table water field street stage front back "
         "slowly quickly again together while after before").split()


def sentences(rs, n: int):
    """n seeded sentences of 5-20 words."""
    return [" ".join(rs.choice(WORDS, rs.randint(5, 21))) for _ in range(n)]


def event_counts(w: Workload, rs, B: int):
    """Events per video: uniform in w.gt_counts, or drawn from the
    ActivityNet count frequencies."""
    from gvl_tpu_torch.train.criterion import COUNTER_CLASS_RATE
    if w.gt_counts is None:
        probs = np.asarray(COUNTER_CLASS_RATE[:w.max_gt + 1], np.float64)
        return np.maximum(rs.choice(len(probs), size=B,
                                    p=probs / probs.sum()), 1)
    return rs.randint(w.gt_counts[0], w.gt_counts[1] + 1, B)


def gt_fields(w: Workload, rs, counts) -> dict:
    """GT boxes, labels and mask in G = w.max_gt slots (the first
    min(count, G) valid) and the videos' sentences (all of them, also past
    G)."""
    B, G = len(counts), w.max_gt
    centre = rs.uniform(0.2, 0.8, (B, G))
    length = rs.uniform(0.05, 0.4, (B, G))
    return dict(
        gt_boxes=np.stack([centre, length], -1).astype(np.float32),
        gt_labels=np.zeros((B, G), np.int32),
        gt_mask=np.arange(G)[None, :] < np.minimum(counts, G)[:, None],
        captions_raw=[sentences(rs, int(c)) for c in counts])


def synthetic_batches(w: Workload, n: int, seed: int, long_video: bool = True):
    """Eval batches of w.eval_B videos, one padded video in eight; with the
    contrastive side on also GT events and sentences (event counts as
    `event_counts`), and, with long_video, one video of the first batch
    with w.long_sentences sentences (more than the G slots)."""
    rs = np.random.RandomState(seed)
    B, T = w.eval_B, w.cfg["frame_embedding_num"]
    for i in range(n):
        mask = np.ones((B, T), bool)
        for b in range(0, B, 8):          # one padded video in eight
            mask[b, rs.randint(T // 2, T):] = False
        batch = dict(keys=[f"v_{i:02d}{b:02d}" for b in range(B)],
                     video_feats=rs.randn(B, T, w.cfg["feature_dim"]).astype(
                         np.float32),
                     video_mask=mask,
                     duration=rs.uniform(*w.duration, B).astype(np.float32))
        if w.contrastive:
            counts = event_counts(w, rs, B)
            if long_video and i == 0:
                counts[3] = w.long_sentences
            batch.update(gt_fields(w, rs, counts))
        yield batch


def load_text(w: Workload, dev):
    """The offline RoBERTa of a contrastive workload, seeded, frozen; None
    without the text side."""
    from gvl_tpu_torch.models.text_encoder import load_text_encoder
    if not w.contrastive:
        return None
    cfg = types.SimpleNamespace(**w.cfg)
    return load_text_encoder(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(cfg.seed))


def check_grounding(tag, batches, g_json, aux_json) -> int:
    """One key per GT sentence, also past G, in both grounding JSONs, with
    its sentence and a finite box inside the video."""
    n = 0
    for batch in batches:
        for b, vid in enumerate(batch["keys"]):
            dur = float(batch["duration"][b])
            for i, sent in enumerate(batch["captions_raw"][b]):
                n += 1
                for res in (g_json, aux_json):
                    key = f"{vid[2:] if len(vid) > 11 else vid}-{i}"
                    check(key in res["results"], f"{tag}: no grounding {key}")
                    it = res["results"][key][0]
                    check(set(it) == GROUNDING_KEYS and it["sentence"] == sent,
                          f"{tag}: grounding item {key}")
                    nums = it["timestamp"] + [it["score"], it["cl_score"]]
                    check(all(math.isfinite(x) for x in nums)
                          and 0.0 <= it["timestamp"][0] <= it["timestamp"][1]
                          <= dur + 1e-3, f"{tag}: grounding {key} {it}")
    check(len(g_json["results"]) == len(aux_json["results"]) == n,
          f"{tag}: {len(g_json['results'])} grounding keys for {n} sentences")
    return n


def phase_main_path(w: Workload, dev):
    from gvl_tpu_torch.eval.evaluate import EvalRunner
    from gvl_tpu_torch.models.gvl import build_model
    tag = w.tag + "main"
    cfg = types.SimpleNamespace(**w.cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    text = load_text(w, dev)
    model = build_model(cfg, text_hidden_dim=text.hidden_size if text else 768,
                        device=dev, generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    n_text = sum(p.numel() for p in text.parameters()) if text else 0
    runner = EvalRunner(cfg, model, WordTranslator(), text)
    B = w.eval_B
    batches = list(synthetic_batches(w, N_BATCHES, SEED))
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        t0 = time.perf_counter()
        path, out_json, g_json, aux_json, losses = runner.run(
            batches, f"{tmp}/dvc.json")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        with open(path) as f:
            reranked = json.load(f)
        with open(path + ".grounding.json") as f:
            check(json.load(f) == g_json, "grounding JSON on disk")
    want = want_counts(w, N_BATCHES, train=False)
    log(tag, f"{w.name} model {n_params} params, text encoder {n_text}; "
             f"EvalRunner.run over {N_BATCHES} batches of {B}: {wall:.3f} s "
             f"wall (first batch included); kernel launches {launches} (want "
             f"{want})")
    check(launches == want, f"kernel launches {launches} != {want}")
    res = out_json["results"]
    check(len(res) == B * N_BATCHES, f"{len(res)} videos in the DVC JSON")
    n_items = 0
    for vid, items in res.items():
        check(len(items) > 0, f"{vid} has no predictions")
        for it in items:
            n_items += 1
            check(set(it) == DVC_KEYS, f"{vid} item keys {sorted(it)}")
            nums = it["timestamp"] + it["raw_box"] + [
                it["proposal_score"], it["sentence_score"], it["vid_duration"]]
            check(all(math.isfinite(x) for x in nums), f"{vid} non-finite")
            check(0.0 <= it["timestamp"][0] <= it["timestamp"][1]
                  <= it["vid_duration"] + 1e-3, f"{vid} timestamp out of range")
    n_sent = sum(bool(it["sentence"]) for v in res.values() for it in v)
    check(len(reranked["results"]) == B * N_BATCHES, "reranked JSON videos")
    log(tag, f"DVC JSON: {len(res)} videos, {n_items} events, {n_sent} "
             f"with a sentence; reranked JSON: "
             f"{sum(len(v) for v in reranked['results'].values())} events")
    if w.contrastive:
        n = check_grounding(tag, batches, g_json, aux_json)
        check(CL_LOSS_KEYS <= set(losses)
              and all(math.isfinite(v) for v in losses.values()),
              f"eval losses {losses}")
        log(tag, f"grounding and aux grounding JSONs: {n} keys, one per GT "
                 f"sentence ({w.long_sentences} in one video, G = "
                 f"{w.max_gt}); eval losses {dict(losses)!r}")
    return cfg, model, runner, launches


# ---------------------------------------------------------------- phase 5
def phase_paths_agree(w: Workload, cfg, model, runner):
    from gvl_tpu_torch.models.layers import set_msda_impl
    from gvl_tpu_torch.models.transformer import pyramid_shapes
    tag = w.tag + "paths"
    batch = next(synthetic_batches(w, 1, SEED + 1))
    dev = runner.device
    feats = torch.from_numpy(batch["video_feats"]).to(dev)
    mask = torch.from_numpy(batch["video_mask"]).to(dev)
    dur = torch.from_numpy(batch["duration"]).to(dev)
    shapes = pyramid_shapes(cfg.frame_embedding_num, cfg.num_feature_levels)
    check(tuple(shapes) == w.shapes, f"pyramid {shapes} != {w.shapes}")
    _, _, arrs = runner._prepare(batch)
    outs = {}
    with torch.inference_mode():
        for impl in ("kernel", "ref"):
            set_msda_impl(model, impl)
            out = model(feats, mask, dur)
            seq, lps = model.caption_sample(
                cfg.dec_layers - 1, out["hs"][-1], out["layer_refs"][-1],
                out["memory"], out["mask_flat"], shapes, out["valid_ratios"])
            step = runner._to_host(runner._eval_step(arrs)[0]) \
                if w.contrastive else None
            outs[impl] = (out, seq, step)
    set_msda_impl(model, "kernel")
    torch.cuda.synchronize()
    (ko, kseq, kstep), (po, pseq, pstep) = outs["kernel"], outs["ref"]
    keys = ("pred_logits", "pred_boxes", "memory", "hs") + (
        ("event_embed",) if w.contrastive else ())
    for key in keys:
        check(bool(torch.isfinite(ko[key]).all()), f"{key} not finite")
        err = (ko[key] - po[key]).abs().max().item()
        log(tag, f"{key} {tuple(ko[key].shape)}: max abs diff {err!r}")
        check(err <= TRUNK_TOL, f"{key} kernel vs plain path {err} > {TRUNK_TOL}")
    share = (kseq == pseq).float().mean().item()
    log(tag, f"greedy tokens {tuple(kseq.shape)}: {share!r} of positions "
             f"equal")
    check(share >= TOKEN_AGREEMENT, f"token agreement {share}")
    if not w.contrastive:
        return
    # grounding through the eval step: boxes in lengths of their video
    for which in ("grounding", "grounding_aux"):
        kg, pg = kstep[which], pstep[which]
        box = float(np.abs((kg["boxes"] - pg["boxes"])
                           / batch["duration"][:, None, None]).max())
        cls = float(np.abs(kg["cl_scores"] - pg["cl_scores"]).max())
        log(tag, f"{which} {kg['boxes'].shape}: boxes max abs diff {box!r} "
                 f"of the video's length, cl_scores {cls!r}")
        check(box <= GROUNDING_TOL and cls <= GROUNDING_TOL,
              f"{which} kernel vs plain path: boxes {box}, cl_scores {cls}")
    worst, worst_k = 0.0, ""
    for k, v in pstep["losses"].items():
        rel = abs(float(kstep["losses"][k]) - float(v)) / max(abs(float(v)),
                                                              1e-6)
        check(math.isfinite(rel) and rel <= LOSS_TOL,
              f"eval loss {k}: kernel {kstep['losses'][k]} vs plain {v}")
        if rel > worst:
            worst, worst_k = rel, k
    log(tag, f"{len(pstep['losses'])} eval losses: worst relative diff "
             f"{worst!r} ({worst_k}); contrastive_loss kernel "
             f"{float(kstep['losses']['contrastive_loss'])!r}, plain "
             f"{float(pstep['losses']['contrastive_loss'])!r}")


# ------------------------------------------------------- phases 5a, 5b
def phase_matching_scores(w: Workload, model, runner) -> None:
    """One eval batch through EvalRunner.run with eval_enable_matching_score
    and eval_matching_score_weight 1.0, kernel path and plain path: every
    prediction's cl_score (its generated caption encoded again, against its
    query's event embedding) finite, non-zero and a cosine; the reranked
    JSON written; the paths' cl_scores within GROUNDING_TOL wherever their
    captions agree, which they must in TOKEN_AGREEMENT of the predictions."""
    from gvl_tpu_torch.eval.evaluate import EvalRunner
    from gvl_tpu_torch.models.layers import set_msda_impl
    tag = w.tag + "match"
    cfg = types.SimpleNamespace(**dict(w.cfg, eval_enable_matching_score=True,
                                       eval_matching_score_weight=1.0))
    match = EvalRunner(cfg, model, runner.translator, runner.text_encoder)
    batch = next(synthetic_batches(w, 1, SEED + 4, long_video=False))
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for impl in ("kernel", "ref"):
            set_msda_impl(model, impl)
            t0 = time.perf_counter()
            path, out_json, *_ = match.run([batch], f"{tmp}/{impl}.json")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check(path.endswith("_rerank_alpha%s_temp2.0.json" % cfg.ec_alpha)
                  and os.path.exists(path), f"reranked JSON {path}")
            with open(path) as f:
                reranked = json.load(f)
            res[impl] = out_json["results"]
            scores = [p["cl_score"] for v in res[impl].values() for p in v]
            check(len(scores) > 0 and all(
                math.isfinite(x) and x != 0.0 and abs(x) <= 1.0 + 1e-5
                for x in scores), f"{impl} path cl_scores {scores[:8]}")
            n_kept = sum(map(len, reranked["results"].values()))
            log(tag, f"{impl} path: EvalRunner.run with matching scores, "
                     f"{w.eval_B} videos, {wall:.3f} s wall; {len(scores)} "
                     f"cl_scores in [{min(scores)!r}, {max(scores)!r}]; "
                     f"reranked JSON {n_kept} events")
    set_msda_impl(model, "kernel")
    n, same, worst = 0, 0, 0.0
    for vid, items in res["kernel"].items():
        plain = res["ref"][vid]
        check(len(items) == len(plain), f"{vid}: {len(items)} vs "
                                        f"{len(plain)} predictions")
        for k, p in zip(items, plain):
            n += 1
            if (k["query_id"], k["sentence"]) == (p["query_id"],
                                                   p["sentence"]):
                same += 1
                worst = max(worst, abs(k["cl_score"] - p["cl_score"]))
    log(tag, f"kernel vs plain path: {same} of {n} predictions with the same "
             f"query and caption, their cl_scores within {worst!r}")
    check(same >= TOKEN_AGREEMENT * n and worst <= GROUNDING_TOL,
          f"matching scores: {same} of {n} agree, worst {worst}")


def phase_bf16_text(w: Workload, runner) -> None:
    """The bf16-weight text pass (train_use_amp, eval_use_amp) on one eval
    step's tokens equals an f32 pass over weights rounded to bfloat16 by
    hand (max abs <= 1e-6); its difference from the f32 pass and the times
    of both passes are logged."""
    from gvl_tpu_torch.models.text_encoder import load_text_encoder
    tag = w.tag + "bf16text"
    text, dev = runner.text_encoder, runner.device
    batch = next(synthetic_batches(w, 1, SEED + 3, long_video=False))
    _, _, arrs = runner._prepare(batch)
    B, G, L = arrs["text_ids"].shape
    ids = torch.from_numpy(arrs["text_ids"]).to(dev).reshape(B * G, L).long()
    tmask = torch.from_numpy(arrs["text_mask"]).to(dev).reshape(B * G, L)
    rounded = load_text_encoder(types.SimpleNamespace(**w.cfg), device=dev)
    rounded.load_state_dict({k: v.to(torch.bfloat16).float()
                             for k, v in text.state_dict().items()})
    with torch.inference_mode():
        got = text(ids, tmask, bf16_weights=True)
        f32 = text(ids, tmask)
        by_hand = rounded(ids, tmask)
        ms = {name: cuda_median_ms(fn, 3, warmup=1) for name, fn in (
            ("bf16 weights", lambda: text(ids, tmask, bf16_weights=True)),
            ("f32", lambda: text(ids, tmask)))}
    err = (got - by_hand).abs().max().item()
    diff = (got - f32).abs().max().item()
    del rounded
    log(tag, f"text encoder on {B * G} x {L} tokens over bf16-rounded "
             f"weights: max abs diff {err!r} from an f32 pass over weights "
             f"rounded by hand, {diff!r} from the f32 pass; "
             f"{ms['bf16 weights']!r} ms a call, f32 {ms['f32']!r} ms")
    check(bool(torch.isfinite(got).all()) and err <= 1e-6 and diff > 0,
          f"bf16-weight text pass: {err} from the rounded weights, {diff} "
          f"from f32")


# ---------------------------------------------------------------- phase 6
def phase_time(w: Workload, model, runner):
    """Eval step time of both paths. A step is what EvalRunner.run does for
    a batch, less the JSON assembly: tokenization, the eval step and the
    copy of its results to the host (with the text side: the text encoder,
    the eval losses and the grounding of the batch's G sentence slots; the
    batch has no video with more sentences than G). Each window of
    N_WINDOW back-to-back steps is timed
    whole by one pair of CUDA events; each round times one window per path,
    in alternating order."""
    from gvl_tpu_torch.models.layers import set_msda_impl
    tag = w.tag + "time"
    B, n_rounds = w.eval_B, w.n_rounds
    batch = next(synthetic_batches(w, 1, SEED + 2, long_video=False))
    win = {"kernel": [], "ref": []}

    def window():
        for _ in range(N_WINDOW):
            runner._to_host(runner._eval_step(runner._prepare(batch)[2])[0])

    with torch.inference_mode():
        for impl in ("kernel", "ref"):
            set_msda_impl(model, impl)
            cuda_median_ms(window, 1, warmup=1)
        for i in range(n_rounds):
            order = ("ref", "kernel") if i % 2 else ("kernel", "ref")
            for impl in order:
                set_msda_impl(model, impl)
                win[impl].append(cuda_median_ms(window, 1, warmup=0) / N_WINDOW)
    set_msda_impl(model, "kernel")
    mean = {k: statistics.fmean(v) for k, v in win.items()}
    quart = {k: statistics.quantiles(v, n=4) for k, v in win.items()}
    for impl, name in (("kernel", "kernel path"), ("ref", "plain path")):
        q1, q2, q3 = quart[impl]
        log(tag, f"{w.name} eval step B={B} ({name}): {mean[impl]!r} ms per "
                 f"step over {n_rounds * N_WINDOW} steps; window means: median "
                 f"{q2!r}, quartiles {q1!r} / {q3!r}, min "
                 f"{min(win[impl])!r}, max {max(win[impl])!r} ms; "
                 f"{B / mean[impl] * 1e3!r} clips/s")
    diffs = [p - k for p, k in zip(win["ref"], win["kernel"])]
    wins = sum(d > 0 for d in diffs)
    gap = quart["ref"][1] - quart["kernel"][1]
    spread = max(q[2] - q[0] for q in quart.values())
    resolved = (max(wins, n_rounds - wins) >= 0.9 * n_rounds
                and abs(gap) > spread)
    log(tag, f"plain minus kernel path per round: {diffs!r} ms per step; "
             f"kernel path faster in {wins} of {n_rounds} rounds; medians "
             f"differ by {gap!r} ms, widest quartile spread {spread!r} ms: "
             f"{'resolved' if resolved else 'not resolved'}")
    return mean


# ---------------------------------------------------------------- phase 7
def summarise_profile(tag: str, prof, what: str, path: pathlib.Path,
                      top_n: int = 8) -> tuple:
    """Device busy time, device op count and the top device ops of a
    torch.profiler run over N_PROFILED steps; the op table goes to `path`.
    Annotation spans that the profiler mirrors onto the device track (the
    optimizer's step) are no device work and are left out. Returns (busy
    ms, ops) per step."""
    from torch.autograd import DeviceType
    avgs = prof.key_averages()
    device_ops = [e for e in avgs if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in device_ops) / 1e3
    n_ops = sum(e.count for e in device_ops)
    check(busy_ms > 0 and n_ops > 0, "torch.profiler saw no device time")
    path.write_text(avgs.table(sort_by="self_cuda_time_total", row_limit=40))
    log(tag, f"torch.profiler over {N_PROFILED} {what}: device busy "
             f"{busy_ms / N_PROFILED!r} ms per step, "
             f"{n_ops / N_PROFILED!r} device ops per step")
    top = sorted(device_ops, key=lambda e: -e.self_device_time_total)
    for e in top[:top_n] + [e for e in top[top_n:] if "msda_" in e.key]:
        ms = e.self_device_time_total / 1e3
        log(tag, f"  {ms / N_PROFILED!r} ms/step ({ms / busy_ms:.1%}), "
                 f"{e.count / N_PROFILED!r} calls/step: {e.key[:90]}")
    log(tag, f"op table in {path}")
    return busy_ms / N_PROFILED, n_ops / N_PROFILED


def text_bound(text, N: int, L: int, backward: bool = False) -> dict:
    """The least time of one text-encoder call on N sequences of L tokens:
    its weights, token ids and mask read once and its output written once
    at the memory rate, against its multiply-adds (Q, K, V and output
    projections, the FFN, the attention's two products) at the f32 rate.
    With backward, the call and its backward: three times the multiply-adds
    (each product's two gradients), the output's gradient read and the
    weights' gradients written once more."""
    s = text.text_encoder.spec
    H, F, n_layers = s.hidden_size, s.intermediate_size, s.num_layers
    macs = n_layers * N * L * (4 * H * H + 2 * H * F + 2 * L * H)
    flops = 2 * macs * (3 if backward else 1)
    n_weights = sum(p.numel() for p in text.parameters())
    nbytes = 4 * (n_weights + 2 * N * L + N * L * H)
    if backward:
        nbytes += 4 * (n_weights + N * L * H)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / F32_FLOP_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_flops), flops=flops, bytes=nbytes,
                bound_by="bytes" if t_bytes >= t_flops else "operations")


def profile_text_encoder(tag: str, text, ids, tmask, step_busy: float,
                         step_ops: float, out_dir: pathlib.Path,
                         backward: bool = False) -> dict:
    """The text encoder alone on one step's (B x G, L) tokens (with
    backward: its forward and backward against a seeded output gradient, as
    a train step that trains it runs them): CUDA-event median of N_PROFILED
    calls on an idle device, and torch.profiler's device time and op count
    per call, beside its FLOP bound and as a share of the step's device busy
    time and op count."""
    from torch.profiler import ProfilerActivity, profile
    N, L = ids.shape
    what = "forward + backward" if backward else "forward"
    if backward:
        gout = torch.randn(N, L, text.hidden_size, device=ids.device,
                           generator=torch.Generator(
                               device=ids.device).manual_seed(SEED))

        def call():
            text(ids, tmask).backward(gout)
    else:
        def call():
            return text(ids, tmask)

    with torch.inference_mode(not backward):
        ms = cuda_median_ms(call, N_PROFILED)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(N_PROFILED):
                call()
            torch.cuda.synchronize()
    if backward:
        text.zero_grad(set_to_none=True)
    busy, ops = summarise_profile(
        tag, prof, f"text encoder {what} calls",
        out_dir / f"text_encoder_{'train' if backward else 'eval'}_ops.txt",
        top_n=4)
    bd = text_bound(text, N, L, backward)
    log(tag, f"text encoder {what} on {N} x {L} tokens: {ms!r} ms a call "
             f"(CUDA events), device busy {busy!r} ms in {ops!r} ops; bound "
             f"{bd['bound_ms']!r} ms ({bd['flops']:.4g} flop at "
             f"{F32_FLOP_PER_S:.3g}/s, {bd['bytes']:.4g} bytes; bound by "
             f"{bd['bound_by']}): {bd['bound_ms'] / busy:.1%} of the bound "
             f"rate; {busy / step_busy:.1%} of the step's device busy time, "
             f"{ops / step_ops:.1%} of its device ops")
    return dict(ms=ms, busy_ms=busy, ops=ops, **bd)


def phase_profile(w: Workload, cfg, model, runner,
                  out_dir: pathlib.Path) -> None:
    """Where one eval step's time goes, kernel path. Host: seconds until the
    eval step returns (with the text side this includes the matchers'
    waits for the device), then to wait for the device. CUDA events: trunk,
    text pass and caption decode. torch.profiler over N_PROFILED steps:
    device busy time, device op count, top device ops; the table goes to
    out_dir, and for the flagship the trace too. The split of the step into
    its parts (`eval_split`). With the text side, the text encoder alone
    (`profile_text_encoder`)."""
    from torch.profiler import ProfilerActivity, profile
    from gvl_tpu_torch.models.transformer import pyramid_shapes
    tag = w.tag + "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    batch = next(synthetic_batches(w, 1, SEED + 3, long_video=False))
    _, _, arrs = runner._prepare(batch)
    dev = runner.device
    feats, mask, dur = (torch.from_numpy(batch[k]).to(dev) for k in
                        ("video_feats", "video_mask", "duration"))
    shapes = pyramid_shapes(cfg.frame_embedding_num, cfg.num_feature_levels)
    enqueue, wait = [], []
    text_ms = None
    with torch.inference_mode():
        out = model(feats, mask, dur)

        def decode():
            model.caption_sample(
                cfg.dec_layers - 1, out["hs"][-1], out["layer_refs"][-1],
                out["memory"], out["mask_flat"], shapes, out["valid_ratios"])

        trunk_ms = cuda_median_ms(lambda: model(feats, mask, dur), N_PROFILED)
        decode_ms = cuda_median_ms(decode, N_PROFILED)
        if w.contrastive:
            ids, tmask, gmask = (torch.from_numpy(arrs[k]).to(dev) for k in
                                 ("text_ids", "text_mask", "gt_mask"))
            text_ms = cuda_median_ms(lambda: runner._text(
                ids, tmask, gmask, out["memory"], out["mask_flat"]),
                N_PROFILED)
        for _ in range(N_PROFILED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner._eval_step(arrs)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            enqueue.append((t1 - t0) * 1e3)
            wait.append((time.perf_counter() - t1) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(N_PROFILED):
                runner._eval_step(arrs)
            torch.cuda.synchronize()
    log(tag, f"{w.name} eval step B={w.eval_B}: trunk {trunk_ms!r} ms, "
             f"text pass (text encoder, encode_text) {text_ms!r} ms, "
             f"caption decode {decode_ms!r} ms (CUDA-event medians of "
             f"{N_PROFILED})")
    log(tag, f"host enqueue per step {statistics.median(enqueue)!r} ms "
             f"(min {min(enqueue)!r}, max {max(enqueue)!r}), then device "
             f"done {statistics.median(wait)!r} ms later (medians of "
             f"{N_PROFILED})")
    if w is ANET:
        prof.export_chrome_trace(str(out_dir / "anet_eval_step_trace.json"))
    busy, ops = summarise_profile(tag, prof, f"{w.name} eval steps",
                                  out_dir / f"{w.name}_eval_step_ops.txt")
    eval_split(tag, runner, arrs)
    if w.contrastive:
        B, G, L = arrs["text_ids"].shape
        profile_text_encoder(tag, runner.text_encoder,
                             ids.reshape(B * G, L).long(),
                             tmask.reshape(B * G, L), busy, ops, out_dir)


def eval_split(tag: str, runner, arrs) -> None:
    """Where the eval step's time goes, part by part: one CUDA event and one
    host time at the end of each part, taken where the step calls it (the
    trunk, the text pass, the decode, detection, the eval losses with their
    matcher, grounding, then the copy of the results to the host); medians
    of N_PROFILED steps. A part's host time includes its waits for the
    device (the matchers' copies)."""
    import gvl_tpu_torch.eval.evaluate as evaluate
    model = runner.model
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev, time.perf_counter()))

    def marked(fn, name):
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            mark(name)
            return out
        return wrapper

    orig = {k: getattr(evaluate, k) for k in (
        "detection_outputs", "compute_criterion", "grounding_outputs")}
    names = {"detection_outputs": "detection", "compute_criterion": "losses",
             "grounding_outputs": "grounding"}
    for k, fn in orig.items():
        setattr(evaluate, k, marked(fn, names[k]))
    model.forward = marked(model.forward, "trunk")
    model.caption_sample = marked(model.caption_sample, "decode")
    runner._text = marked(runner._text, "text")
    dev_ms, host_ms = {}, {}
    try:
        with torch.inference_mode():
            for _ in range(N_PROFILED):
                del marks[:]
                torch.cuda.synchronize()
                mark("start")
                runner._to_host(runner._eval_step(arrs)[0])
                mark("to_host")
                torch.cuda.synchronize()
                step_dev, step_host = {}, {}
                for (_, e0, h0), (name, e1, h1) in zip(marks, marks[1:]):
                    step_dev[name] = step_dev.get(name, 0.0) + \
                        e0.elapsed_time(e1)
                    step_host[name] = step_host.get(name, 0.0) + \
                        (h1 - h0) * 1e3
                for name in step_dev:
                    dev_ms.setdefault(name, []).append(step_dev[name])
                    host_ms.setdefault(name, []).append(step_host[name])
    finally:
        del model.forward, model.caption_sample, runner._text
        for k, fn in orig.items():
            setattr(evaluate, k, fn)
    med = statistics.median
    log(tag, f"eval step split, medians of {N_PROFILED} steps, device "
             "timeline (CUDA events) / host (host clock), ms: "
             + "; ".join(f"{k} {med(dev_ms[k])!r} / {med(host_ms[k])!r}"
                         for k in dev_ms))


# ---------------------------------------------------------------- phase 9
def train_batch(w: Workload, seed: int, text=None) -> dict:
    """A synthetic train batch in the form of the JAX package's train-step
    bench (bench.py build_train_bench): every GT box (0.5, 0.3). Event
    counts: uniform in w.gt_counts, or drawn from the ActivityNet count
    frequencies. With the text encoder, the videos' sentences (5-20 words
    each) and their tokens."""
    from gvl_tpu_torch.train.state import add_text_inputs
    rs = np.random.RandomState(seed)
    B, G, Lc = w.train_B, w.max_gt, w.cfg["max_caption_len"]
    T, D = w.cfg["frame_embedding_num"], w.cfg["feature_dim"]
    counts = event_counts(w, rs, B)
    captions = rs.randint(1, w.cfg["vocab_size"], (B, G, Lc)).astype(np.int32)
    captions[..., 0] = 0
    batch = dict(
        video_feats=rs.randn(B, T, D).astype(np.float32),
        video_mask=np.ones((B, T), bool),
        duration=rs.uniform(*w.duration, (B,)).astype(np.float32),
        gt_boxes=np.stack([np.full((B, G), 0.5), np.full((B, G), 0.3)],
                          -1).astype(np.float32),
        gt_labels=np.zeros((B, G), np.int32),
        gt_mask=np.arange(G)[None, :] < counts[:, None],
        captions=captions, caption_mask=np.ones((B, G, Lc), bool))
    if text is not None:
        batch["captions_raw"] = [sentences(rs, int(c)) for c in counts]
        add_text_inputs(batch, text, types.SimpleNamespace(**w.cfg))
    return batch


def build_train(w: Workload, dev):
    """The model on the card with seeded weights, its train state and step
    (with the text side on: the text encoder, frozen or trained as the
    config's text_encoder_learning_strategy says), the loss weights (the
    contrastive weight the schedule gives at CL_EPOCH) and two seeded
    batches."""
    from gvl_tpu_torch.models.gvl import build_model
    from gvl_tpu_torch.train.criterion import (LossSpec, cl_weight_at_epoch,
                                               make_weight_dict)
    from gvl_tpu_torch.train.state import (StepStatics, create_train_state,
                                           make_train_step)
    cfg = types.SimpleNamespace(**w.cfg)
    torch.manual_seed(SEED)               # the dropout draws
    gen = torch.Generator(device=dev).manual_seed(SEED)
    text = load_text(w, dev)
    model = build_model(cfg, text_hidden_dim=text.hidden_size if text
                        else 768, generator=gen)  # no device: the card
    check(next(model.parameters()).device == dev, "build_model's default "
          f"device is {next(model.parameters()).device}, not {dev}")
    statics = StepStatics(
        spec=LossSpec.from_config(cfg), enable_contrastive=w.contrastive,
        caption_loss=True, two_stage=False, train_text_encoder=w.trains_text,
        disable_mid_caption_heads=False, enable_pos_emb_for_captioner=False,
        temporal_shapes=w.shapes,
        text_bf16=bool(getattr(cfg, "train_use_amp", False)))
    state = create_train_state(cfg, model, STEPS_PER_EPOCH, statics, text)
    step = make_train_step(model, cfg, statics, text)
    check((state.text_optimizer is not None) == w.trains_text,
          "the text encoder's optimizer")
    weights = make_weight_dict(cfg)
    if w.contrastive:
        for k in weights:
            if k.startswith("contrastive_loss"):
                weights[k] = cl_weight_at_epoch(cfg, CL_EPOCH)
        check(weights["contrastive_loss"] > 0, "contrastive weight")
    batches = [train_batch(w, SEED, text), train_batch(w, SEED + 1, text)]
    return model, state, step, weights, batches


def phase_train_main_path(w: Workload, model, state, step, weights,
                          batches) -> dict:
    tag = w.tag + "train"
    loss_keys = TRAIN_LOSS_KEYS | (CL_LOSS_KEYS if w.contrastive else set())
    text0 = ({k: v.clone() for k, v in state.text_encoder.state_dict().items()}
             if w.contrastive else {})
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    reset_counts()
    t0 = time.perf_counter()
    for i in range(N_TRAIN_STEPS):
        losses = {k: float(v) for k, v in
                  step(state, batches[i % 2], weights).items()}
        check(set(losses) == loss_keys,
              f"loss keys {sorted(set(losses) ^ loss_keys)} differ")
        check(all(math.isfinite(v) for v in losses.values()),
              f"step {i}: non-finite loss in {losses}")
        want = want_counts(w, i + 1, train=True)
        check(read_counts() == want,
              f"step {i}: launches {read_counts()}, want {want}")
        log(tag, f"step {i}: total {losses['total_loss']!r}, caption "
                 f"{losses['loss_caption']!r}, giou {losses['loss_giou']!r}"
                 f", ce {losses['loss_ce']!r}, contrastive "
                 f"{losses.get('contrastive_loss')!r}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    n_params = 0
    for n, p in model.named_parameters():
        n_params += 1
        check(p.grad is not None and bool(torch.isfinite(p.grad).all()),
              f"{n} has no finite gradient")
    moved = sum(not torch.equal(p.detach(), before[n])
                for n, p in model.named_parameters())
    check(moved > 0.9 * n_params, f"only {moved} of {n_params} tensors moved")
    check(state.step == N_TRAIN_STEPS, f"state.step {state.step}")
    if w.trains_text:
        text_moved = text_grads(tag, state.text_encoder, text0)
    else:
        for k, v in text0.items():
            check(torch.equal(state.text_encoder.state_dict()[k], v),
                  f"the frozen text encoder's {k} moved")
    log(tag, f"{w.name}: {N_TRAIN_STEPS} steps at B={w.train_B}, "
             f"G={w.max_gt}: {wall:.3f} s wall (first step included); "
             f"launches {launches} (per step "
             f"{want_counts(w, 1, train=True)}); {n_params} parameter "
             f"tensors with a finite gradient, {moved} moved; lr "
             f"{state.optimizer.param_groups[0]['lr']!r}"
        + (f"; text encoder: {text_moved} parameter tensors moved, lr "
           f"{state.text_optimizer.param_groups[0]['lr']!r}"
           if w.trains_text else ""))
    return launches


def text_grads(tag: str, text, text0: dict) -> int:
    """A trained text encoder after its steps: a finite gradient on every
    parameter, the pooler's exactly 0 (no loss reaches it; the step gives
    it zeros, which Adam's L2 term turns into a move), every parameter
    moved but the pooler's bias (0 at the start, no L2 term) and the
    attention's key biases (their gradient is 0 in exact arithmetic: they
    shift every logit of a softmax alike). Returns the number of parameter
    tensors that moved."""
    n_moved = 0
    for n, p in text.named_parameters():
        check(p.grad is not None and bool(torch.isfinite(p.grad).all()),
              f"text encoder {n} has no finite gradient")
        if ".pooler." in n:
            check(not bool(p.grad.any()), f"pooler gradient {n} is not 0")
        moved = not torch.equal(p.detach(), text0[n])
        n_moved += moved
        check(moved or n.endswith(("pooler.dense.bias",
                                   "attention.self.key.bias")),
              f"text encoder {n} did not move")
    log(tag, f"text encoder: {n_moved} of "
             f"{len(list(text.parameters()))} parameter tensors moved, every "
             f"gradient finite, the pooler's exactly 0")
    return n_moved


# --------------------------------------------------------------- phase 10
def phase_train_paths_agree(w: Workload, model, step, weights, batch,
                            text=None) -> None:
    """With a text encoder that trains (text), its named gradients too."""
    from gvl_tpu_torch.models.layers import set_msda_impl
    tag = w.tag + "tpaths"
    model.eval()                          # dropout off, gradients on
    res = {}
    for impl in ("kernel", "ref"):
        set_msda_impl(model, impl)
        model.zero_grad(set_to_none=True)
        if text is not None:
            text.zero_grad(set_to_none=True)
        losses = step.forward_losses(batch)
        total = sum(losses[k] * weights[k] for k in losses if k in weights)
        total.backward()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        tgrads = {n: p.grad.clone() if p.grad is not None
                  else torch.zeros_like(p)
                  for n, p in (text.named_parameters() if text is not None
                               else ())}
        res[impl] = ({k: v.detach().item() for k, v in losses.items()},
                     total.detach().item(), grads, tgrads)
    set_msda_impl(model, "kernel")
    model.zero_grad(set_to_none=True)
    if text is not None:
        text.zero_grad(set_to_none=True)
    (kl, kt, kg, ktg), (pl, pt, pg, ptg) = res["kernel"], res["ref"]
    rel = abs(kt - pt) / abs(pt)
    log(tag, f"total loss kernel path {kt!r}, plain path {pt!r}: "
             f"relative difference {rel!r}")
    check(rel <= LOSS_TOL, f"total loss differs by {rel} > {LOSS_TOL}")
    for k in sorted(CL_LOSS_KEYS & set(pl)):
        rel = abs(kl[k] - pl[k]) / abs(pl[k])
        log(tag, f"{k} kernel path {kl[k]!r}, plain path {pl[k]!r}: "
                 f"relative difference {rel!r}")
        check(rel <= LOSS_TOL, f"{k} differs by {rel} > {LOSS_TOL}")
    text_side = ("contrastive_projection", "word_context_model",
                 "sentence_context_model")
    worst_text, worst_text_name = 0.0, ""
    worst, worst_name = 0.0, ""
    for n, g in pg.items():
        if n.startswith(text_side) and g.abs().max().item() > GRAD_FLOOR:
            err = (kg[n] - g).abs().max().item() / g.abs().max().item()
            if err >= worst_text:
                worst_text, worst_text_name = err, n
        scale = g.abs().max().item()
        err = (kg[n] - g).abs().max().item()
        check(math.isfinite(err), f"{n}: gradient not finite")
        if scale > GRAD_FLOOR and err / scale > worst:
            worst, worst_name = err / scale, n
        check(err <= GRAD_TOL * scale + GRAD_FLOOR,
              f"{n}: kernel vs plain path gradient {err} > {GRAD_TOL} x "
              f"{scale} + {GRAD_FLOOR}")
    log(tag, f"{len(pg)} named gradients: worst max abs diff / own max "
             f"abs {worst!r} ({worst_name})")
    if w.contrastive:
        n_text = sum(n.startswith(text_side) for n in pg)
        check(n_text > 0 and worst_text_name, "text-side gradients")
        log(tag, f"{n_text} of them on the text side: worst {worst_text!r} "
                 f"({worst_text_name})")
    if text is None:
        return
    worst, worst_name, n_zero = 0.0, "", 0
    for n, g in ptg.items():
        scale = g.abs().max().item()
        err = (ktg[n] - g).abs().max().item()
        check(math.isfinite(err) and bool(torch.isfinite(ktg[n]).all()),
              f"text encoder {n}: gradient not finite")
        check(err <= GRAD_TOL * scale + GRAD_FLOOR,
              f"text encoder {n}: kernel vs plain path gradient {err} > "
              f"{GRAD_TOL} x {scale} + {GRAD_FLOOR}")
        n_zero += scale == 0.0
        if scale > GRAD_FLOOR and err / scale > worst:
            worst, worst_name = err / scale, n
    check(n_zero <= 2, f"{n_zero} text-encoder gradients are 0")
    log(tag, f"{len(ptg)} text-encoder gradients: worst max abs diff / own "
             f"max abs {worst!r} ({worst_name}); {n_zero} exactly 0 (the "
             f"pooler, which no loss reaches)")


# --------------------------------------------------------------- phase 11
def phase_train_time(w: Workload, state, step, weights, batches) -> dict:
    import gvl_tpu_torch.train.criterion as criterion
    tag = w.tag + "ttime"
    B = w.train_B
    for i in range(N_TRAIN_WARMUP):
        step(state, batches[i % 2], weights)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    it = iter(range(10 ** 6))
    step_ms = cuda_median_ms(
        lambda: step(state, batches[next(it) % 2], weights), N_TRAIN_TIMED,
        warmup=0)
    peak = torch.cuda.max_memory_allocated()
    log(tag, f"{w.name} train step B={B}: {step_ms!r} ms (median of "
             f"{N_TRAIN_TIMED} CUDA-event-timed steps after "
             f"{N_TRAIN_WARMUP} warm-up steps), {1e3 / step_ms!r} steps/s,"
             f" {B * 1e3 / step_ms!r} clips/s; peak device memory "
             f"{peak / 2 ** 30!r} GiB")

    # the split: one CUDA event and one host time at the end of each part,
    # taken where the step calls the part: the trunk (model.forward), with
    # the text side the text encoder and encode_text, the criterion, teacher
    # forcing (up to the last caption_train_nll), backward (up to the
    # gradient clip), optimizer (the rest: clip, Adam, schedule). With a text
    # encoder that trains, backward ends where the gradient of the text
    # encoder's output is complete, text_backward where its embeddings'
    # gradient is accumulated (autograd runs the nodes made last first, so
    # the trunk's backward mostly follows), trunk_backward at the first
    # clip, optimizer (the model's clip and Adam) at the second, and
    # text_optimizer (the text encoder's clip and Adam, both schedules) at
    # the end. The matcher is timed on the host after a synchronise, so that
    # its copy does not count the wait for the trunk
    import gvl_tpu_torch.train.state as train_state
    model, text = state.model, state.text_encoder
    trains = w.trains_text
    parts = (("trunk",) + (("text_encoder", "text") if w.contrastive else ())
             + ("criterion", "captions", "backward")
             + (("text_backward", "trunk_backward") if trains else ())
             + ("optimizer",) + (("text_optimizer",) if trains else ()))
    clip_names = ["trunk_backward", "optimizer"] if trains else ["backward"]
    n_clips = []
    dev_ms = {k: [] for k in parts}
    host_ms = {k: [] for k in parts}
    lap_ms = {"copy": [], "solve": []}
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev, time.perf_counter()))

    def marked(fn, name, before=False):
        def wrapper(*args, **kwargs):
            if before:
                mark(name)
            out = fn(*args, **kwargs)
            if not before:
                mark(name)
            return out
        return wrapper

    def text_forward(fn):
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            mark("text_encoder")
            if out.requires_grad:
                out.register_hook(lambda g: mark("backward"))
            return out
        return wrapper

    def clip_marked(fn):
        def wrapper(*args, **kwargs):
            mark(clip_names[len(n_clips)])
            n_clips.append(1)
            return fn(*args, **kwargs)
        return wrapper

    orig_lap = criterion.batched_lap

    def timed_lap(cost, col_valid=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cost_h, valid_h = cost.cpu(), col_valid.cpu()
        t1 = time.perf_counter()
        out = orig_lap(cost_h, valid_h)
        t2 = time.perf_counter()
        out = out.to(cost.device)
        lap_ms["copy"].append((t1 - t0 + time.perf_counter() - t2) * 1e3)
        lap_ms["solve"].append((t2 - t1) * 1e3)
        return out

    orig = (train_state.compute_criterion, train_state.clip_global_norm)
    criterion.batched_lap = timed_lap
    train_state.compute_criterion = marked(orig[0], "criterion")
    train_state.clip_global_norm = clip_marked(orig[1])
    model.forward = marked(model.forward, "trunk")
    model.caption_train_nll = marked(model.caption_train_nll, "captions")
    hook = None
    if w.contrastive:
        model.encode_text = marked(model.encode_text, "text")
        text.forward = text_forward(text.forward)
    if trains:
        hook = text.text_encoder.embeddings.word_embeddings.weight \
            .register_post_accumulate_grad_hook(
                lambda p: mark("text_backward"))
    try:
        for i in range(N_TRAIN_SPLIT):
            del marks[:], n_clips[:]
            torch.cuda.synchronize()
            mark("start")
            step(state, batches[i % 2], weights)
            mark(parts[-1])
            torch.cuda.synchronize()
            check([m[0] for m in marks[1:]] == list(parts),
                  f"split marks {[m[0] for m in marks]}")
            for (_, e0, h0), (name, e1, h1) in zip(marks, marks[1:]):
                dev_ms[name].append(e0.elapsed_time(e1))
                host_ms[name].append((h1 - h0) * 1e3)
    finally:
        del model.forward, model.caption_train_nll
        if w.contrastive:
            del model.encode_text, text.forward
        if hook is not None:
            hook.remove()
        criterion.batched_lap = orig_lap
        train_state.compute_criterion, train_state.clip_global_norm = orig
    med = statistics.median
    log(tag, "split, medians of %d steps, device timeline (CUDA events) "
             "/ host enqueue (host clock), ms: " % N_TRAIN_SPLIT
        + "; ".join(f"{k} {med(dev_ms[k])!r} / {med(host_ms[k])!r}"
                    for k in parts))
    log(tag, f"matcher inside 'criterion' (host clock after a "
             f"synchronise): copies {med(lap_ms['copy'])!r} ms, scipy "
             f"solve of {w.cfg['dec_layers'] * B} problems "
             f"{med(lap_ms['solve'])!r} ms")
    return dict(step_ms=step_ms, peak=peak)


def phase_train_profile(w: Workload, state, step, weights, batches,
                        out_dir: pathlib.Path) -> None:
    """torch.profiler over N_PROFILED train steps, summarised as the eval
    steps' profile."""
    from torch.profiler import ProfilerActivity, profile
    tag = w.tag + "tprofile"
    out_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(N_PROFILED):
            step(state, batches[i % 2], weights)
        torch.cuda.synchronize()
    busy, ops = summarise_profile(tag, prof, f"{w.name} train steps",
                                  out_dir / f"{w.name}_train_step_ops.txt")
    if w.contrastive:
        dev = next(state.model.parameters()).device
        B, G, L = batches[0]["text_ids"].shape
        profile_text_encoder(
            tag, state.text_encoder,
            torch.from_numpy(batches[0]["text_ids"]).to(dev).reshape(
                B * G, L).long(),
            torch.from_numpy(batches[0]["text_mask"]).to(dev).reshape(
                B * G, L), busy, ops, out_dir, backward=w.trains_text)


def phase_msda_ref_route(dev) -> None:
    """The long-video model built with msda_impl='ref' (the JAX package's
    exact dense op at every S) runs the dense kernel in its encoder, not
    the banded one: launch counts of one forward at B=1."""
    from gvl_tpu_torch.models.gvl import build_model
    cfg = types.SimpleNamespace(**dict(LONG.cfg, msda_impl="ref"))
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED))
    rs = np.random.RandomState(SEED)
    T = cfg.frame_embedding_num
    feats = torch.from_numpy(rs.randn(1, T, cfg.feature_dim).astype(
        np.float32)).to(dev)
    reset_counts()
    with torch.inference_mode():
        out = model(feats, torch.ones(1, T, dtype=torch.bool, device=dev),
                    torch.full((1,), 150.0, device=dev))
    torch.cuda.synchronize()
    got = read_counts()
    want = {"fwd": cfg.enc_layers + cfg.dec_layers, "bwd": 0,
            "banded_fwd": 0, "banded_bwd": 0}
    log("lvref", f"long-video model, msda_impl='ref', S={sum(LONG.shapes)}: "
                 f"one forward launched {got} (want {want}); memory finite "
                 f"{bool(torch.isfinite(out['memory']).all())}")
    check(got == want and bool(torch.isfinite(out["memory"]).all()),
          f"msda_impl='ref' route: launches {got}")
    reset_counts()


# work -> (floats moved as multiples of value, out and the taps; FMAs per
# tap and channel). fwd: value, loc, attn in, out out. bwd: value, grad_out,
# loc, attn in, grad_value, grad_loc, grad_attn out; two dot products and
# two scatter-adds. Its value kernel: grad_out, loc, attn in, grad_value out,
# the scatter-adds; its dot kernel: value, grad_out, loc, attn in, grad_loc,
# grad_attn out, the dot products.
BOUND_WORK = {"fwd": ((1, 1, 2), 2), "bwd": ((2, 1, 4), 4),
              "bwd_value": ((1, 1, 2), 2), "bwd_dot": ((1, 1, 4), 2)}


def msda_bound(B: int, S: int, Lq: int, work: str) -> dict:
    """The least time the card could take for one call (or one of the
    backward's two CUDA kernels, BOUND_WORK) at these sizes with H, Dh and
    K=16: each input read once and each output written once at the memory
    rate, against the FMAs at the f32 rate. The banded kernels move the same
    bytes and do the same FMAs as the dense ones at Lq == S."""
    (n_value, n_out, n_taps), fmas = BOUND_WORK[work]
    K = 4 * P
    value, out, taps = B * S * H * DH, B * Lq * H * DH, B * Lq * H * K
    floats = n_value * value + n_out * out + n_taps * taps
    flops = 2 * fmas * taps * DH
    t_bytes = 4 * floats / HBM_BYTES_PER_S * 1e3
    t_flops = flops / F32_FLOP_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_flops),
                bound_by="bytes" if t_bytes >= t_flops else "operations",
                bytes=4 * floats, flops=flops)


def split_row(B: int, S: int, Lq: int, split_ms: dict) -> dict:
    """The backward's two CUDA kernels, value and dot, each with its time
    by torch.profiler (split_ms: kernel name -> ms) and its own bound."""
    out = {}
    for part in ("value", "dot"):
        bd = msda_bound(B, S, Lq, f"bwd_{part}")
        ms = [v for k, v in split_ms.items() if f"_{part}_kernel" in k]
        out[part] = dict(ms=ms[0] if len(ms) == 1 else None,
                         bound_ms=bd["bound_ms"], bound_by=bd["bound_by"])
    return out


def dense_row(name, source, replaces, launches, kv, backward) -> dict:
    """A dense kernel's entry of the kernels line: the required keys at the
    flagship encoder shape, its other shapes beside them, each with the
    library call's time (embedding_bag, forward or backward) and, with
    --old-forms, the earlier commit's kernel's (old_ms); the backward's with
    each of its two CUDA kernels' time and bound (split)."""
    by_shape = {}
    for label, (shapes, fwd_B, bwd_B, Lq) in DENSE_CASES.items():
        B = bwd_B if backward else fwd_B
        if B is None:
            continue
        bd = msda_bound(B, sum(shapes), Lq, "bwd" if backward else "fwd")
        tm = kv["times"][label]
        by_shape[label] = dict(tm, B=B, S=sum(shapes), Lq=Lq,
                               bound_ms=bd["bound_ms"],
                               bound_by=bd["bound_by"], bytes=bd["bytes"],
                               flops=bd["flops"])
        if backward:
            by_shape[label]["split"] = split_row(B, sum(shapes), Lq,
                                                 tm["split_ms"])
            log("bound", f"{name} {label} by CUDA kernel: "
                         f"{by_shape[label]['split']!r}")
        log("bound", f"{name} {label}: {bd['bytes']} bytes, {bd['flops']} "
                     f"flop -> {bd['bound_ms']!r} ms, bound by "
                     f"{bd['bound_by']}; kernel {tm['ms']!r} ms, "
                     f"embedding_bag {tm['library_ms']!r} ms, old form "
                     f"{tm['old_ms']!r} ms")
    enc = by_shape["encoder"]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": sum(launches.values()), "max_abs_err": kv["max_abs_err"],
        "ms": enc["ms"], "plain_ms": enc["plain_ms"],
        "bound_ms": enc["bound_ms"], "bound_by": enc["bound_by"],
        "library_ms": enc["library_ms"], "old_ms": enc["old_ms"],
        "shape": "flagship encoder B=16 S=188 Lq=188 H=8 Dh=64 K=16",
        "launches_by_path": launches, "by_shape": by_shape}


def banded_row(name, source, replaces, launches, kv, backward) -> dict:
    """A banded kernel's entry: the required keys at the shape its main path
    gives it (forward: the eval step's B=8; backward: the train step's B=4),
    the other batch beside them; library_ms is embedding_bag's on the
    band-clamped taps."""
    S = sum(LONG.shapes)
    by_batch = {}
    for b, tm in kv["times"].items():
        bd = msda_bound(b, S, S, "bwd" if backward else "fwd")
        by_batch[b] = dict(tm, bound_ms=bd["bound_ms"],
                           bound_by=bd["bound_by"], bytes=bd["bytes"],
                           flops=bd["flops"])
        log("bound", f"{name} B={b}: {bd['bytes']} bytes, {bd['flops']} flop "
                     f"-> {bd['bound_ms']!r} ms, bound by {bd['bound_by']}; "
                     f"kernel {tm['ms']!r} ms")
    B = LONG.train_B if backward else LONG.eval_B
    main = by_batch[B]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": sum(launches.values()), "max_abs_err": kv["max_abs_err"],
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "shape": f"long-video encoder B={B} S={S} Lq={S} H=8 Dh=64 K=16 "
                 f"margin={LV_MARGIN}",
        "dense_kernel_ms": main["dense_kernel_ms"],
        "launches_by_path": launches,
        "by_batch": {str(b): v for b, v in by_batch.items()}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", type=pathlib.Path, metavar="DIR",
                    help="also profile the eval steps (phase 7) and the train "
                         "steps and write the op tables and a trace here")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (phases 1-3, 8, 12, "
                         "13); prints no result line")
    ap.add_argument("--old-forms", type=pathlib.Path, metavar="DIR",
                    help="also time the dense kernels of an earlier commit, "
                         "whose gvl_tpu_torch package DIR holds (phases 3, "
                         "8)")
    args = ap.parse_args()
    name = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    old = OldDense(args.old_forms) if args.old_forms else None
    kv = {"fwd": phase_kernel_vs_plain(dev, old),
          "bwd": phase_bwd_kernel_vs_plain(dev, old),
          "banded_fwd": phase_banded_kernel_vs_plain(dev),
          "banded_bwd": phase_banded_bwd_kernel_vs_plain(dev)}
    if args.kernels_only:
        return
    launches = {}
    for w in (ANET, LONG):
        if w is LONG:
            phase_msda_ref_route(dev)
        cfg, model, runner, launches[f"{w.name}_eval"] = phase_main_path(w, dev)
        phase_paths_agree(w, cfg, model, runner)
        if w is ANET:
            phase_matching_scores(w, model, runner)
            phase_bf16_text(w, runner)
        med = phase_time(w, model, runner)
        log("time", f"{w.name} eval clips/s: kernel path "
                    f"{w.eval_B / med['kernel'] * 1e3!r}, plain path "
                    f"{w.eval_B / med['ref'] * 1e3!r}")
        if args.profile:
            phase_profile(w, cfg, model, runner, args.profile)
        del model, runner
        tmodel, state, step, weights, batches = build_train(w, dev)
        # phase 10 before phase 9: see the docstring
        phase_train_paths_agree(w, tmodel, step, weights, batches[0],
                                state.text_encoder if w.trains_text else None)
        launches[f"{w.name}_train"] = phase_train_main_path(
            w, tmodel, state, step, weights, batches)
        phase_train_time(w, state, step, weights, batches)
        if args.profile:
            phase_train_profile(w, state, step, weights, batches, args.profile)
        del tmodel, state, step
        torch.cuda.empty_cache()
    rows = []
    for key, row, rname, source, replaces in (
            ("fwd", dense_row, "ms_deform_attn_fwd",
             "gvl_tpu_torch/csrc/ms_deform_attn_fwd.cu",
             "gvl_tpu/ops/ms_deform_attn.py:217"),
            ("bwd", dense_row, "ms_deform_attn_bwd",
             "gvl_tpu_torch/csrc/ms_deform_attn_bwd.cu",
             "gvl_tpu/ops/ms_deform_attn.py:236"),
            ("banded_fwd", banded_row, "ms_deform_attn_banded_fwd",
             "gvl_tpu_torch/csrc/ms_deform_attn_banded_fwd.cu",
             "gvl_tpu/ops/ms_deform_attn_banded.py:65"),
            ("banded_bwd", banded_row, "ms_deform_attn_banded_bwd",
             "gvl_tpu_torch/csrc/ms_deform_attn_banded_bwd.cu",
             "gvl_tpu/ops/ms_deform_attn_banded.py:92")):
        by_path = {path: counts[key] for path, counts in launches.items()}
        rows.append(row(rname, source, replaces, by_path, kv[key],
                        key.endswith("bwd")))
    # each kernel of a path was launched on that path
    for w in (ANET, LONG):
        for train in (False, True):
            path = f"{w.name}_{'train' if train else 'eval'}"
            for key, n in want_counts(w, 1, train).items():
                check((launches[path][key] > 0) == (n > 0),
                      f"{path}: {key} launched {launches[path][key]} times")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
