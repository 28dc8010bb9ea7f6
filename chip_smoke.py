"""Smoke run of the PyTorch port on one NVIDIA GPU (built for an H100, sm_90a).

    python3 chip_smoke.py [--profile DIR]

Phases, one printed line or more each; any failure raises and the script
exits non-zero:
  1. device: name, `nvidia-smi` name and power limit, torch/CUDA versions;
     TF32 off for matmuls and cuDNN.
  2. build: nvcc builds the deformable-attention kernel from
     gvl_tpu_torch/csrc into build/kernels/.
  3. kernel vs plain: the CUDA kernel against its plain PyTorch version at
     the flagship encoder (Lq=188) and decoder (Lq=30) shapes and at the
     long-video decoder shape (B=8, S=1500, Lq=100), with taps in
     [0, 1], "wild" taps in [-0.4, 1.4] and taps on level borders; max abs
     error <= 1e-5; median times over CUDA events.
  4. main path: the flagship ActivityNet dense-captioning model (widths of
     cfgs/anet_tsp_msvg_dvc.yml: hidden 512, 8 heads, 2+2 layers, 4 levels,
     30 queries, vocab 8517; random weights from a seed) evaluated by
     gvl_tpu_torch.eval.evaluate.EvalRunner.run over 3 batches of 16
     synthetic videos; checks the kernel launch count, finite outputs and the
     DVC JSON.
  5. kernel path vs plain path: one batch through the model with the kernel
     and with the plain op; trunk outputs to 1e-4, greedy tokens >= 99%.
  6. time: eval clips/s at B=16 for both paths: windows of back-to-back
     eval steps, each window timed whole by CUDA events, the paths taken in
     turns; the per-round difference of the two paths.
  7. (with --profile DIR only) where one eval step's time goes: host
     enqueue vs device finish, trunk vs caption decode, torch.profiler's
     device time and op count per step and its top device ops; writes the
     op table and a Chrome trace into DIR.
  8. backward kernel vs plain: the backward CUDA kernel against its plain
     PyTorch version at the same shapes (the long-video decoder at B=4, as
     the train step runs it) and three tap kinds with a seeded output
     gradient; bounds per gradient in BWD_ABS_TOL and
     BWD_REL_TOL; per-call median times. Runs right after phase 3.
  9. train main path: build_model on the card, create_train_state,
     make_train_step, 5 steps on 2 alternating synthetic batches (B=16, 30
     GT slots with ActivityNet event counts, caption length 30, Adam at
     5e-5, clip 100, dropout on); checks the loss keys, finite losses, 4
     forward + 4 backward kernel launches per step, a finite gradient on
     every parameter, and that the parameters moved.
 10. kernel path vs plain path, gradients: one batch's loss and gradients
     with dropout off, through the kernels and through the plain op; total
     loss to 1e-4 relative, each named gradient to 1e-3 x its max abs
     (+ 1e-8 for gradients that are zero but for rounding). Runs before
     phase 9, on the seeded weights: the gradient of a sampling location
     jumps where a tap crosses a value row, the 3e-6 between the paths'
     activations moves a few taps of a step across one, and a single such
     tap moves a small tensor's gradient by 1e-3 to 5e-2 of its max abs. On
     seeded weights and a seeded batch the same taps cross in every run, so
     the verdict is the same in every run; after train steps, whose float
     atomics land in a different order every time, it is not.
 11. train time: median of 10 CUDA-event-timed steps after 3 warm-up steps,
     steps/s and clips/s; the split into trunk forward, criterion (with the
     matcher's copy to the host and its solve, host clock), teacher forcing,
     backward, optimizer; peak device memory. With --profile DIR also
     torch.profiler's device time and op count per train step and its top
     device ops; the op table goes into DIR.
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
     B=4 beside the dense kernel on the same local inputs.
 13. banded backward kernel vs plain: same classes, geometries and margins
     at the train step's batch (B=4), bounds of phase 8; without grad_value
     nothing is scattered. Medians at B=4 and B=8, with and without
     grad_value.
     A kernel's time (phases 3, 8, 12, 13) is the device's: each timed call
     is enqueued behind a kernel that spins while the host prepares it; the
     time per call from an idle device, the host's share included, is
     logged beside it.
 14. long-video eval main path: the YouMakeup-shaped model (widths of
     cfgs/ym_i3d_msvg_dvc.yml as tools/bench_longvideo.py builds them:
     hidden 512, 8 heads, 2+2 layers, 100 queries, vocab 1247, 1024-d
     features, 800 frames; contrastive off) through EvalRunner.run over 3
     batches of 8 synthetic videos: 2 banded + 2 dense forward launches per
     batch; then phases 5 and 6 on this model (6 with fewer rounds).
 15. long-video train main path: 5 steps at B=4 (10 GT slots, 3-10 events
     per video, captions of 30 tokens, Adam at 1e-4 with L2 1e-4): 2 launches
     per step of each of the four kernels; then phases 10 and 11 on it.
With --kernels-only the script stops after phases 1-3, 8, 12 and 13. With
--profile DIR phases 7 and 11 also profile the long-video steps. The last
two lines are the kernels' JSON summary (four kernels) and {"ok": true,
"device": {...}}. The run uses one card, the first visible.
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
# NVIDIA H100 SXM data sheet: device memory rate, f32 rate outside the
# tensor cores
HBM_BYTES_PER_S, F32_FLOP_PER_S = 3.35e12, 67e12
SPIN_HZ = 2e9   # device_median_ms: no slower than the card's clock (1.98 GHz)
DVC_KEYS = {"timestamp", "raw_box", "label", "proposal_score", "sentence",
            "sentence_score", "cl_score", "query_id", "vid_duration",
            "pred_event_count"}

# __graft_entry__._flagship_cfg(tiny=False), contrastive off
FLAGSHIP = dict(
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
# cfgs/ym_i3d_msvg_dvc.yml at the shapes of tools/bench_longvideo.py
# (YouMakeup: 800 frames of 1024-d i3d features, 100 queries, vocab 1247),
# contrastive off; its loss coefficients are the flagship's
LONGVIDEO = dict(
    FLAGSHIP, num_queries=100, feature_dim=1024, frame_embedding_num=800,
    vocab_size=1247, lr=1e-4, weight_decay=1e-4, epoch=25)


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
                n_rounds=10)
LONG = Workload("longvideo", "lv", LONGVIDEO, (800, 400, 200, 100), eval_B=8,
                train_B=4, max_gt=10, gt_counts=(3, 10), duration=(100, 300),
                n_rounds=5)
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


def msda_inputs(kind: str, shapes, B: int, Lq: int, gen: torch.Generator, dev):
    L = len(shapes)
    S = sum(shapes)
    value = torch.randn(B, S, H, DH, generator=gen, device=dev)
    attn = torch.rand(B, Lq, H, L, P, generator=gen, device=dev) + 1e-3
    attn = attn / attn.sum(dim=(3, 4), keepdim=True)
    if kind == "border":
        loc = torch.empty(B, Lq, H, L, P, device=dev)
        for l, T in enumerate(shapes):
            special = torch.tensor([0.5 / T, (T - 0.5) / T, 1.5 / T,
                                    (T - 1.5) / T, 0.0, 1.0, -0.3, 1.3],
                                   device=dev)
            pick = torch.randint(0, len(special), (B, Lq, H, P),
                                 generator=gen, device=dev)
            loc[..., l, :] = special[pick]
    else:
        lo, hi = (-0.4, 1.4) if kind == "wild" else (0.0, 1.0)
        loc = lo + (hi - lo) * torch.rand(B, Lq, H, L, P, generator=gen,
                                          device=dev)
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


def phase_kernel_vs_plain(dev) -> dict:
    from gvl_tpu_torch.ops import ms_deform_attn_1d_cuda, ms_deform_attn_1d_ref
    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = 0.0
    times = {}
    for label, (shapes, B, _, Lq) in DENSE_CASES.items():
        for kind in ("normal", "wild", "border"):
            value, loc, attn = msda_inputs(kind, shapes, B, Lq, gen, dev)
            worst = max(worst, check_forward(
                f"kernel {label} B={B} Lq={Lq} {kind}",
                ms_deform_attn_1d_cuda(value, shapes, loc, attn),
                ms_deform_attn_1d_ref(value, shapes, loc, attn)))
        value, loc, attn = msda_inputs("normal", shapes, B, Lq, gen, dev)
        def kernel():
            return ms_deform_attn_1d_cuda(value, shapes, loc, attn)
        k_ms, c_ms = device_median_ms(kernel, 50), cuda_median_ms(kernel, 50)
        p_ms = device_median_ms(
            lambda: ms_deform_attn_1d_ref(value, shapes, loc, attn), 50)
        times[label] = (k_ms, p_ms, c_ms)
        log("kernel", f"{label} B={B} S={sum(shapes)} Lq={Lq} H={H} "
                      f"Dh={DH} K={len(shapes) * P}: kernel {k_ms!r} ms on "
                      f"the device ({c_ms!r} ms per call from an idle "
                      f"device, the host's share included), plain {p_ms!r} "
                      f"ms (medians of 50)")
    return dict(max_abs_err=worst, times=times)


# ---------------------------------------------------------------- phase 8
def phase_bwd_kernel_vs_plain(dev) -> dict:
    """The backward kernel against its plain version, same inputs."""
    from gvl_tpu_torch.ops import (ms_deform_attn_1d_bwd_cuda,
                                   ms_deform_attn_1d_bwd_ref)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    worst = 0.0
    times = {}
    for label, (shapes, _, B, Lq) in DENSE_CASES.items():
        if B is None:
            continue
        for kind in ("normal", "wild", "border"):
            value, loc, attn = msda_inputs(kind, shapes, B, Lq, gen, dev)
            grad_out = torch.randn(B, Lq, H * DH, generator=gen, device=dev)
            got = ms_deform_attn_1d_bwd_cuda(grad_out, value, shapes, loc, attn)
            want = ms_deform_attn_1d_bwd_ref(grad_out, value, shapes, loc, attn)
            worst = max(worst, check_backward(
                f"bwd {label} B={B} Lq={Lq} {kind}", got, want))
            no_value = ms_deform_attn_1d_bwd_cuda(
                grad_out, value, shapes, loc, attn, need_value=False)
            check(no_value[0] is None and torch.equal(no_value[1], got[1])
                  and torch.equal(no_value[2], got[2]),
                  "backward kernel without grad_value")
        value, loc, attn = msda_inputs("normal", shapes, B, Lq, gen, dev)
        grad_out = torch.randn(B, Lq, H * DH, generator=gen, device=dev)
        def kernel():
            return ms_deform_attn_1d_bwd_cuda(grad_out, value, shapes, loc,
                                              attn)
        k_ms, c_ms = device_median_ms(kernel, 50), cuda_median_ms(kernel, 50)
        p_ms = device_median_ms(lambda: ms_deform_attn_1d_bwd_ref(
            grad_out, value, shapes, loc, attn), 50)
        times[label] = (k_ms, p_ms, c_ms)
        log("bwd", f"{label} B={B} S={sum(shapes)} Lq={Lq} H={H} "
                   f"Dh={DH} K={len(shapes) * P}: kernel {k_ms!r} ms on the "
                   f"device, zeroing grad_value included ({c_ms!r} ms per "
                   f"call from an idle device, the host's share included), "
                   f"plain {p_ms!r} ms (medians of 50)")
    return dict(max_abs_err=worst, times=times)


# --------------------------------------------------------- phases 12, 13
# tap class -> does the band clamp engage at the model's margin (the plain
# banded result then differs from the plain dense one)
BANDED_KINDS = {"local": False, "wide": True, "border": True, "pile": True,
                "top": False}
FULL_MARGIN = max(LONG.shapes)       # every band is its whole padded level
# the tiny long-video model of the CPU tests: 300 frames, three levels, none
# a multiple of 128 and two not of 8; K = 12 taps does not divide a block
TINY_SHAPES = (300, 150, 75)
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
                                   ms_deform_attn_1d_ref)
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
        times[b] = dict(
            ms=device_median_ms(kernel, 50), call_ms=cuda_median_ms(kernel, 50),
            plain_ms=device_median_ms(lambda: ms_deform_attn_1d_banded_ref(
                value, shapes, loc, attn, LV_MARGIN), 20),
            dense_kernel_ms=device_median_ms(lambda: ms_deform_attn_1d_cuda(
                value, shapes, loc, attn), 50))
        log("banded", f"B={b} S=Lq={sum(shapes)} H={H} Dh={DH} "
                      f"K={len(shapes) * P} margin={LV_MARGIN}, local taps: "
                      f"kernel {times[b]['ms']!r} ms on the device "
                      f"({times[b]['call_ms']!r} ms per call from an idle "
                      f"device, the host's share included), plain "
                      f"{times[b]['plain_ms']!r} ms, the dense kernel on the "
                      f"same inputs {times[b]['dense_kernel_ms']!r} ms "
                      f"(medians of 50 / 50 / 20 / 50)")
    return dict(max_abs_err=worst, times=times)


def phase_banded_bwd_kernel_vs_plain(dev) -> dict:
    from gvl_tpu_torch.ops import (ms_deform_attn_1d_banded_bwd_cuda,
                                   ms_deform_attn_1d_banded_bwd_ref,
                                   ms_deform_attn_1d_bwd_cuda)
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
        times[b] = dict(
            ms=device_median_ms(kernel, 50), call_ms=cuda_median_ms(kernel, 50),
            no_value_ms=device_median_ms(lambda: kernel(False), 50),
            plain_ms=device_median_ms(lambda: ms_deform_attn_1d_banded_bwd_ref(
                grad_out, value, shapes, loc, attn, LV_MARGIN), 20),
            dense_kernel_ms=device_median_ms(lambda: ms_deform_attn_1d_bwd_cuda(
                grad_out, value, shapes, loc, attn), 50))
        log("bbwd", f"B={b} S=Lq={sum(shapes)} H={H} Dh={DH} "
                    f"K={len(shapes) * P} margin={LV_MARGIN}, local taps: "
                    f"kernel {times[b]['ms']!r} ms on the device, zeroing "
                    f"grad_value included ({times[b]['call_ms']!r} ms per "
                    f"call from an idle device, the host's share included; "
                    f"{times[b]['no_value_ms']!r} ms without grad_value), "
                    f"plain {times[b]['plain_ms']!r} ms, the dense backward "
                    f"kernel on the same inputs "
                    f"{times[b]['dense_kernel_ms']!r} ms (medians of 50 / 50 "
                    f"/ 50 / 20 / 50)")
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


def synthetic_batches(w: Workload, n: int, seed: int):
    rs = np.random.RandomState(seed)
    B, T = w.eval_B, w.cfg["frame_embedding_num"]
    for i in range(n):
        mask = np.ones((B, T), bool)
        for b in range(0, B, 8):          # one padded video in eight
            mask[b, rs.randint(T // 2, T):] = False
        yield dict(keys=[f"v_{i:02d}{b:02d}" for b in range(B)],
                   video_feats=rs.randn(B, T, w.cfg["feature_dim"]).astype(
                       np.float32),
                   video_mask=mask,
                   duration=rs.uniform(*w.duration, B).astype(np.float32))


def phase_main_path(w: Workload, dev):
    from gvl_tpu_torch.eval.evaluate import EvalRunner
    from gvl_tpu_torch.models.gvl import build_model
    tag = w.tag + "main"
    cfg = types.SimpleNamespace(**w.cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = build_model(cfg, device=dev, generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    runner = EvalRunner(cfg, model, WordTranslator())
    B = w.eval_B
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        t0 = time.perf_counter()
        path, out_json = runner.run(synthetic_batches(w, N_BATCHES, SEED),
                                    f"{tmp}/dvc.json")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        with open(path) as f:
            reranked = json.load(f)
    want = want_counts(w, N_BATCHES, train=False)
    log(tag, f"{w.name} model {n_params} params; EvalRunner.run over "
             f"{N_BATCHES} batches of {B}: {wall:.3f} s wall (first batch "
             f"included); kernel launches {launches} (want {want})")
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
    outs = {}
    with torch.inference_mode():
        for impl in ("kernel", "ref"):
            set_msda_impl(model, impl)
            out = model(feats, mask, dur)
            seq, lps = model.caption_sample(
                cfg.dec_layers - 1, out["hs"][-1], out["layer_refs"][-1],
                out["memory"], out["mask_flat"], shapes, out["valid_ratios"])
            outs[impl] = (out, seq)
    set_msda_impl(model, "kernel")
    torch.cuda.synchronize()
    (ko, kseq), (po, pseq) = outs["kernel"], outs["ref"]
    for key in ("pred_logits", "pred_boxes", "memory", "hs"):
        check(bool(torch.isfinite(ko[key]).all()), f"{key} not finite")
        err = (ko[key] - po[key]).abs().max().item()
        log(tag, f"{key} {tuple(ko[key].shape)}: max abs diff {err!r}")
        check(err <= TRUNK_TOL, f"{key} kernel vs plain path {err} > {TRUNK_TOL}")
    share = (kseq == pseq).float().mean().item()
    log(tag, f"greedy tokens {tuple(kseq.shape)}: {share!r} of positions "
             f"equal")
    check(share >= TOKEN_AGREEMENT, f"token agreement {share}")


# ---------------------------------------------------------------- phase 6
def phase_time(w: Workload, model, runner):
    """Eval step time of both paths. A step is what EvalRunner.run does for
    a batch, less the JSON assembly: the eval step and the copy of its
    results to the host. Each window of N_WINDOW back-to-back steps is timed
    whole by one pair of CUDA events; each round times one window per path,
    in alternating order."""
    from gvl_tpu_torch.models.layers import set_msda_impl
    tag = w.tag + "time"
    B, n_rounds = w.eval_B, w.n_rounds
    batch = next(synthetic_batches(w, 1, SEED + 2))
    win = {"kernel": [], "ref": []}

    def window():
        for _ in range(N_WINDOW):
            runner._to_host(runner._eval_step(batch))

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
def summarise_profile(tag: str, prof, what: str, path: pathlib.Path) -> None:
    """Device busy time, device op count and the top device ops of a
    torch.profiler run over N_PROFILED steps; the op table goes to `path`.
    Annotation spans that the profiler mirrors onto the device track (the
    optimizer's step) are no device work and are left out."""
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
    for e in top[:8] + [e for e in top[8:] if "msda_" in e.key]:
        ms = e.self_device_time_total / 1e3
        log(tag, f"  {ms / N_PROFILED!r} ms/step ({ms / busy_ms:.1%}), "
                 f"{e.count / N_PROFILED!r} calls/step: {e.key[:90]}")
    log(tag, f"op table in {path}")


def phase_profile(w: Workload, cfg, model, runner,
                  out_dir: pathlib.Path) -> None:
    """Where one eval step's time goes, kernel path. Host: seconds to
    enqueue a step, then to wait for the device. CUDA events: trunk and
    caption decode. torch.profiler over N_PROFILED steps: device busy time,
    device op count, top device ops; the table goes to out_dir, and for the
    flagship the trace too."""
    from torch.profiler import ProfilerActivity, profile
    from gvl_tpu_torch.models.transformer import pyramid_shapes
    tag = w.tag + "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    batch = next(synthetic_batches(w, 1, SEED + 3))
    dev = runner.device
    feats, mask, dur = (torch.from_numpy(batch[k]).to(dev) for k in
                        ("video_feats", "video_mask", "duration"))
    shapes = pyramid_shapes(cfg.frame_embedding_num, cfg.num_feature_levels)
    enqueue, wait = [], []
    with torch.inference_mode():
        out = model(feats, mask, dur)

        def decode():
            model.caption_sample(
                cfg.dec_layers - 1, out["hs"][-1], out["layer_refs"][-1],
                out["memory"], out["mask_flat"], shapes, out["valid_ratios"])

        trunk_ms = cuda_median_ms(lambda: model(feats, mask, dur), N_PROFILED)
        decode_ms = cuda_median_ms(decode, N_PROFILED)
        for _ in range(N_PROFILED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner._eval_step(batch)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            enqueue.append((t1 - t0) * 1e3)
            wait.append((time.perf_counter() - t1) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(N_PROFILED):
                runner._eval_step(batch)
            torch.cuda.synchronize()
    log(tag, f"{w.name} eval step B={w.eval_B}: trunk {trunk_ms!r} ms, "
             f"caption decode {decode_ms!r} ms (CUDA-event medians of "
             f"{N_PROFILED})")
    log(tag, f"host enqueue per step {statistics.median(enqueue)!r} ms "
             f"(min {min(enqueue)!r}, max {max(enqueue)!r}), then device "
             f"done {statistics.median(wait)!r} ms later (medians of "
             f"{N_PROFILED})")
    if w is ANET:
        prof.export_chrome_trace(str(out_dir / "anet_eval_step_trace.json"))
    summarise_profile(tag, prof, f"{w.name} eval steps",
                      out_dir / f"{w.name}_eval_step_ops.txt")


# ---------------------------------------------------------------- phase 9
def train_batch(w: Workload, seed: int) -> dict:
    """A synthetic train batch in the form of the JAX package's train-step
    bench (bench.py build_train_bench): every GT box (0.5, 0.3). Event
    counts: uniform in w.gt_counts, or drawn from the ActivityNet count
    frequencies."""
    from gvl_tpu_torch.train.criterion import COUNTER_CLASS_RATE
    rs = np.random.RandomState(seed)
    B, G, Lc = w.train_B, w.max_gt, w.cfg["max_caption_len"]
    T, D = w.cfg["frame_embedding_num"], w.cfg["feature_dim"]
    if w.gt_counts is None:
        probs = np.asarray(COUNTER_CLASS_RATE[:G + 1], np.float64)
        counts = np.maximum(
            rs.choice(len(probs), size=B, p=probs / probs.sum()), 1)
    else:
        counts = rs.randint(w.gt_counts[0], w.gt_counts[1] + 1, B)
    captions = rs.randint(1, w.cfg["vocab_size"], (B, G, Lc)).astype(np.int32)
    captions[..., 0] = 0
    return dict(
        video_feats=rs.randn(B, T, D).astype(np.float32),
        video_mask=np.ones((B, T), bool),
        duration=rs.uniform(*w.duration, (B,)).astype(np.float32),
        gt_boxes=np.stack([np.full((B, G), 0.5), np.full((B, G), 0.3)],
                          -1).astype(np.float32),
        gt_labels=np.zeros((B, G), np.int32),
        gt_mask=np.arange(G)[None, :] < counts[:, None],
        captions=captions, caption_mask=np.ones((B, G, Lc), bool))


def build_train(w: Workload, dev):
    """The model on the card with seeded weights, its train state and step,
    the loss weights and two seeded batches."""
    from gvl_tpu_torch.models.gvl import build_model
    from gvl_tpu_torch.train.criterion import LossSpec, make_weight_dict
    from gvl_tpu_torch.train.state import (StepStatics, create_train_state,
                                           make_train_step)
    cfg = types.SimpleNamespace(**w.cfg)
    torch.manual_seed(SEED)               # the dropout draws
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = build_model(cfg, generator=gen)          # no device: the card
    check(next(model.parameters()).device == dev, "build_model's default "
          f"device is {next(model.parameters()).device}, not {dev}")
    statics = StepStatics(
        spec=LossSpec.from_config(cfg), enable_contrastive=False,
        caption_loss=True, two_stage=False, train_text_encoder=False,
        disable_mid_caption_heads=False, enable_pos_emb_for_captioner=False,
        temporal_shapes=w.shapes)
    state = create_train_state(cfg, model, STEPS_PER_EPOCH, statics)
    step = make_train_step(model, cfg, statics)
    weights = make_weight_dict(cfg)
    batches = [train_batch(w, SEED), train_batch(w, SEED + 1)]
    return model, state, step, weights, batches


def phase_train_main_path(w: Workload, model, state, step, weights,
                          batches) -> dict:
    tag = w.tag + "train"
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    reset_counts()
    t0 = time.perf_counter()
    for i in range(N_TRAIN_STEPS):
        losses = {k: float(v) for k, v in
                  step(state, batches[i % 2], weights).items()}
        check(set(losses) == TRAIN_LOSS_KEYS,
              f"loss keys {sorted(set(losses) ^ TRAIN_LOSS_KEYS)} differ")
        check(all(math.isfinite(v) for v in losses.values()),
              f"step {i}: non-finite loss in {losses}")
        want = want_counts(w, i + 1, train=True)
        check(read_counts() == want,
              f"step {i}: launches {read_counts()}, want {want}")
        log(tag, f"step {i}: total {losses['total_loss']!r}, caption "
                 f"{losses['loss_caption']!r}, giou {losses['loss_giou']!r}"
                 f", ce {losses['loss_ce']!r}")
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
    log(tag, f"{w.name}: {N_TRAIN_STEPS} steps at B={w.train_B}, "
             f"G={w.max_gt}: {wall:.3f} s wall (first step included); "
             f"launches {launches} (per step "
             f"{want_counts(w, 1, train=True)}); {n_params} parameter "
             f"tensors with a finite gradient, {moved} moved; lr "
             f"{state.optimizer.param_groups[0]['lr']!r}")
    return launches


# --------------------------------------------------------------- phase 10
def phase_train_paths_agree(w: Workload, model, step, weights, batch) -> None:
    from gvl_tpu_torch.models.layers import set_msda_impl
    tag = w.tag + "tpaths"
    model.eval()                          # dropout off, gradients on
    res = {}
    for impl in ("kernel", "ref"):
        set_msda_impl(model, impl)
        model.zero_grad(set_to_none=True)
        losses = step.forward_losses(batch)
        total = sum(losses[k] * weights[k] for k in losses if k in weights)
        total.backward()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        res[impl] = (total.detach().item(), grads)
    set_msda_impl(model, "kernel")
    model.zero_grad(set_to_none=True)
    (kt, kg), (pt, pg) = res["kernel"], res["ref"]
    rel = abs(kt - pt) / abs(pt)
    log(tag, f"total loss kernel path {kt!r}, plain path {pt!r}: "
             f"relative difference {rel!r}")
    check(rel <= LOSS_TOL, f"total loss differs by {rel} > {LOSS_TOL}")
    worst, worst_name = 0.0, ""
    for n, g in pg.items():
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
    # taken where the step calls the part: the trunk (model.forward), the
    # criterion, teacher forcing (up to the last caption_train_nll), backward
    # (up to the gradient clip), optimizer (the rest: clip, Adam, schedule).
    # The matcher is timed on the host after a synchronise, so that its copy
    # does not count the wait for the trunk
    import gvl_tpu_torch.train.state as train_state
    model = state.model
    parts = ("trunk", "criterion", "captions", "backward", "optimizer")
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
    train_state.clip_global_norm = marked(orig[1], "backward", before=True)
    model.forward = marked(model.forward, "trunk")
    model.caption_train_nll = marked(model.caption_train_nll, "captions")
    try:
        for i in range(N_TRAIN_SPLIT):
            del marks[:]
            torch.cuda.synchronize()
            mark("start")
            step(state, batches[i % 2], weights)
            mark("optimizer")
            torch.cuda.synchronize()
            check([m[0] for m in marks[1:]] == list(parts),
                  f"split marks {[m[0] for m in marks]}")
            for (_, e0, h0), (name, e1, h1) in zip(marks, marks[1:]):
                dev_ms[name].append(e0.elapsed_time(e1))
                host_ms[name].append((h1 - h0) * 1e3)
    finally:
        del model.forward, model.caption_train_nll
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
    summarise_profile(tag, prof, f"{w.name} train steps",
                      out_dir / f"{w.name}_train_step_ops.txt")


def msda_bound(B: int, S: int, Lq: int, backward: bool) -> dict:
    """The least time the card could take for one call at these sizes with
    H, Dh and K=16: each input read once and each output written once at the
    memory rate, against 2 FMAs per tap and channel (forward) or 4 (backward:
    two dot products, two scatter-adds) at the f32 rate. The banded kernels
    move the same bytes and do the same FMAs as the dense ones at Lq == S."""
    K = 4 * P
    value, out, taps = B * S * H * DH, B * Lq * H * DH, B * Lq * H * K
    floats = value + out + 2 * taps       # value, loc, attn in; out out
    if backward:
        # value, grad_out, loc, attn in; grad_value, grad_loc, grad_attn out
        floats = 2 * value + out + 4 * taps
    flops = taps * DH * (8 if backward else 4)
    t_bytes = 4 * floats / HBM_BYTES_PER_S * 1e3
    t_flops = flops / F32_FLOP_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_flops),
                bound_by="bytes" if t_bytes >= t_flops else "operations",
                bytes=4 * floats, flops=flops)


def dense_row(name, source, replaces, launches, kv, backward) -> dict:
    """A dense kernel's entry of the kernels line: the required keys at the
    flagship encoder shape, its other shapes beside them. library_ms is
    null: no single PyTorch call computes either function (F.grid_sample
    would take one call per level and a weighted sum after them)."""
    by_shape = {}
    for label, (shapes, fwd_B, bwd_B, Lq) in DENSE_CASES.items():
        B = bwd_B if backward else fwd_B
        if B is None:
            continue
        bd = msda_bound(B, sum(shapes), Lq, backward)
        k_ms, p_ms, c_ms = kv["times"][label]
        by_shape[label] = {"B": B, "S": sum(shapes), "Lq": Lq, "ms": k_ms,
                           "plain_ms": p_ms, "call_ms": c_ms,
                           "bound_ms": bd["bound_ms"],
                           "bound_by": bd["bound_by"], "bytes": bd["bytes"],
                           "flops": bd["flops"]}
        log("bound", f"{name} {label}: {bd['bytes']} bytes, {bd['flops']} "
                     f"flop -> {bd['bound_ms']!r} ms, bound by "
                     f"{bd['bound_by']}; kernel {k_ms!r} ms")
    enc = by_shape["encoder"]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": sum(launches.values()), "max_abs_err": kv["max_abs_err"],
        "ms": enc["ms"], "plain_ms": enc["plain_ms"],
        "bound_ms": enc["bound_ms"], "bound_by": enc["bound_by"],
        "library_ms": None,
        "shape": "flagship encoder B=16 S=188 Lq=188 H=8 Dh=64 K=16",
        "launches_by_path": launches, "by_shape": by_shape}


def banded_row(name, source, replaces, launches, kv, backward) -> dict:
    """A banded kernel's entry: the required keys at the shape its main path
    gives it (forward: the eval step's B=8; backward: the train step's B=4),
    the other batch beside them. library_ms is null, as for the dense
    kernels."""
    S = sum(LONG.shapes)
    by_batch = {}
    for b, tm in kv["times"].items():
        bd = msda_bound(b, S, S, backward)
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
        "library_ms": None,
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
    args = ap.parse_args()
    name = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    kv = {"fwd": phase_kernel_vs_plain(dev),
          "bwd": phase_bwd_kernel_vs_plain(dev),
          "banded_fwd": phase_banded_kernel_vs_plain(dev),
          "banded_bwd": phase_banded_bwd_kernel_vs_plain(dev)}
    if args.kernels_only:
        return
    launches = {}
    for w in (ANET, LONG):
        cfg, model, runner, launches[f"{w.name}_eval"] = phase_main_path(w, dev)
        phase_paths_agree(w, cfg, model, runner)
        med = phase_time(w, model, runner)
        log("time", f"{w.name} eval clips/s: kernel path "
                    f"{w.eval_B / med['kernel'] * 1e3!r}, plain path "
                    f"{w.eval_B / med['ref'] * 1e3!r}")
        if args.profile:
            phase_profile(w, cfg, model, runner, args.profile)
        del model, runner
        tmodel, state, step, weights, batches = build_train(w, dev)
        # phase 10 before phase 9: see the docstring
        phase_train_paths_agree(w, tmodel, step, weights, batches[0])
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
