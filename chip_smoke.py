"""Smoke run of the PyTorch port on one NVIDIA GPU (built for an H100, sm_90a).

    python3 chip_smoke.py [--profile DIR]

Phases, one printed line or more each; any failure raises and the script
exits non-zero:
  1. device: name, `nvidia-smi` name and power limit, torch/CUDA versions;
     TF32 off for matmuls and cuDNN.
  2. build: nvcc builds the deformable-attention kernel from
     gvl_tpu_torch/csrc into build/kernels/.
  3. kernel vs plain: the CUDA kernel against its plain PyTorch version at
     the flagship encoder (Lq=188) and decoder (Lq=30) shapes, with taps in
     [0, 1], "wild" taps in [-0.4, 1.4] and taps on level borders; max abs
     error <= 1e-5; per-call median times over CUDA events.
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
     PyTorch version at the same two shapes and three tap kinds with a
     seeded output gradient; bounds per gradient in BWD_ABS_TOL and
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
     (+ 1e-8 for gradients that are zero but for rounding).
 11. train time: median of 10 CUDA-event-timed steps after 3 warm-up steps,
     steps/s and clips/s; the split into trunk forward, criterion (with the
     matcher's copy to the host and its solve, host clock), teacher forcing,
     backward, optimizer; peak device memory. With --profile DIR also
     torch.profiler's device time and op count per train step and its top
     device ops; the op table goes into DIR.
With --kernels-only the script stops after phases 1-3 and 8. The last two
lines are the kernels' JSON summary and {"ok": true, "device": {...}}. The
run uses one card, the first visible.
"""

from __future__ import annotations

import argparse
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
B, T_FEAT, D_FEAT = 16, 100, 512
ENC_SHAPES = (100, 50, 25, 13)
H, DH, P = 8, 64, 4
KERNEL_TOL = 1e-5
# grad_loc = attn * T_l * (d1 - d0) carries the factor T_l <= 100: its values
# reach several hundred, where one f32 ulp is 6.1e-5, so its absolute bound
# is ten times the others'
BWD_ABS_TOL = {"grad_value": 1e-4, "grad_loc": 1e-3, "grad_attn": 1e-4}
BWD_REL_TOL = 1e-5
TRUNK_TOL = 1e-4
TOKEN_AGREEMENT = 0.99
N_BATCHES = 3
N_ROUNDS, N_WINDOW = 10, 10     # phase 6: rounds x steps per window and path
N_PROFILED = 5

# __graft_entry__._flagship_cfg(tiny=False), contrastive off
FLAGSHIP = dict(
    hidden_dim=512, nheads=8, enc_layers=2, dec_layers=2,
    transformer_ff_dim=512, num_feature_levels=4, num_queries=30,
    feature_dim=D_FEAT, frame_embedding_num=T_FEAT, vocab_size=8517,
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
MAX_GT, STEPS_PER_EPOCH = 30, 100
N_TRAIN_STEPS, N_TRAIN_TIMED, N_TRAIN_WARMUP, N_TRAIN_SPLIT = 5, 10, 3, 5
# a gradient that is zero in exact arithmetic (the bias under a softmax) is
# rounding noise of ~1e-10 on either path: GRAD_FLOOR lets it pass
LOSS_TOL, GRAD_TOL, GRAD_FLOOR = 1e-4, 1e-3, 1e-8
TRAIN_LOSS_KEYS = {f"{k}{sfx}" for k in (
    "loss_ce", "loss_counter", "loss_bbox", "loss_giou", "loss_self_iou",
    "cardinality_error", "loss_caption") for sfx in ("", "_0")} | {"total_loss"}
# NVIDIA H100 SXM data sheet: device memory rate, f32 rate outside the
# tensor cores
HBM_BYTES_PER_S, F32_FLOP_PER_S = 3.35e12, 67e12
DVC_KEYS = {"timestamp", "raw_box", "label", "proposal_score", "sentence",
            "sentence_score", "cl_score", "query_id", "vid_duration",
            "pred_event_count"}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_median_ms(fn, n: int, warmup: int = 3) -> float:
    """Median over n calls of fn, each timed by its own pair of CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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
    try:
        import yaml  # noqa: F401
        has_yaml = True
    except ImportError:
        has_yaml = False
    log("device", f"{name}; torch {torch.__version__}, CUDA "
                  f"{torch.version.cuda}, python {sys.version.split()[0]}; "
                  f"devices {torch.cuda.device_count()}; "
                  f"TF32 off; yaml importable: {has_yaml}")
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
def msda_inputs(kind: str, Lq: int, gen: torch.Generator, dev):
    L = len(ENC_SHAPES)
    S = sum(ENC_SHAPES)
    value = torch.randn(B, S, H, DH, generator=gen, device=dev)
    attn = torch.rand(B, Lq, H, L, P, generator=gen, device=dev) + 1e-3
    attn = attn / attn.sum(dim=(3, 4), keepdim=True)
    if kind == "border":
        loc = torch.empty(B, Lq, H, L, P, device=dev)
        for l, T in enumerate(ENC_SHAPES):
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


def phase_kernel_vs_plain(dev) -> dict:
    from gvl_tpu_torch.ops import ms_deform_attn_1d_cuda, ms_deform_attn_1d_ref
    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = 0.0
    times = {}
    for label, Lq in (("encoder", sum(ENC_SHAPES)), ("decoder", 30)):
        for kind in ("normal", "wild", "border"):
            value, loc, attn = msda_inputs(kind, Lq, gen, dev)
            got = ms_deform_attn_1d_cuda(value, ENC_SHAPES, loc, attn)
            want = ms_deform_attn_1d_ref(value, ENC_SHAPES, loc, attn)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            worst = max(worst, err)
            log("kernel", f"{label} Lq={Lq} {kind}: max abs err {err!r}")
            check(math.isfinite(err) and err <= KERNEL_TOL,
                  f"kernel vs plain at {label}/{kind}: {err} > {KERNEL_TOL}")
        value, loc, attn = msda_inputs("normal", Lq, gen, dev)
        k_ms = cuda_median_ms(
            lambda: ms_deform_attn_1d_cuda(value, ENC_SHAPES, loc, attn), 50)
        p_ms = cuda_median_ms(
            lambda: ms_deform_attn_1d_ref(value, ENC_SHAPES, loc, attn), 50)
        times[label] = (k_ms, p_ms)
        log("kernel", f"{label} B={B} S={sum(ENC_SHAPES)} Lq={Lq} H={H} "
                      f"Dh={DH} K={len(ENC_SHAPES) * P}: kernel {k_ms!r} ms, "
                      f"plain {p_ms!r} ms per call (median of 50)")
    return dict(max_abs_err=worst, times=times)


# ---------------------------------------------------------------- phase 8
def phase_bwd_kernel_vs_plain(dev) -> dict:
    """The backward kernel against its plain version, same inputs. Bounds per
    gradient: max abs error <= BWD_ABS_TOL[name] and <= BWD_REL_TOL x the plain
    result's max abs. No tap is excluded: on a clamp bound both give 0."""
    from gvl_tpu_torch.ops import (ms_deform_attn_1d_bwd_cuda,
                                   ms_deform_attn_1d_bwd_ref)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    worst = 0.0
    times = {}
    for label, Lq in (("encoder", sum(ENC_SHAPES)), ("decoder", 30)):
        for kind in ("normal", "wild", "border"):
            value, loc, attn = msda_inputs(kind, Lq, gen, dev)
            grad_out = torch.randn(B, Lq, H * DH, generator=gen, device=dev)
            got = ms_deform_attn_1d_bwd_cuda(grad_out, value, ENC_SHAPES, loc,
                                             attn)
            want = ms_deform_attn_1d_bwd_ref(grad_out, value, ENC_SHAPES, loc,
                                             attn)
            torch.cuda.synchronize()
            for name, g, w in zip(("grad_value", "grad_loc", "grad_attn"),
                                  got, want):
                err = (g - w).abs().max().item()
                scale = w.abs().max().item()
                worst = max(worst, err)
                log("bwd", f"{label} Lq={Lq} {kind} {name}: max abs err "
                           f"{err!r}, plain max abs {scale!r}")
                check(math.isfinite(err) and err <= BWD_ABS_TOL[name]
                      and err <= BWD_REL_TOL * scale,
                      f"backward kernel vs plain at {label}/{kind}/{name}: "
                      f"{err} (max abs {scale})")
            no_value = ms_deform_attn_1d_bwd_cuda(
                grad_out, value, ENC_SHAPES, loc, attn, need_value=False)
            check(no_value[0] is None and torch.equal(no_value[1], got[1])
                  and torch.equal(no_value[2], got[2]),
                  "backward kernel without grad_value")
        value, loc, attn = msda_inputs("normal", Lq, gen, dev)
        grad_out = torch.randn(B, Lq, H * DH, generator=gen, device=dev)
        k_ms = cuda_median_ms(lambda: ms_deform_attn_1d_bwd_cuda(
            grad_out, value, ENC_SHAPES, loc, attn), 50)
        p_ms = cuda_median_ms(lambda: ms_deform_attn_1d_bwd_ref(
            grad_out, value, ENC_SHAPES, loc, attn), 50)
        times[label] = (k_ms, p_ms)
        log("bwd", f"{label} B={B} S={sum(ENC_SHAPES)} Lq={Lq} H={H} "
                   f"Dh={DH} K={len(ENC_SHAPES) * P}: kernel {k_ms!r} ms "
                   f"(zeroing grad_value included), plain {p_ms!r} ms per "
                   f"call (median of 50)")
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


def synthetic_batches(n: int, seed: int):
    rs = np.random.RandomState(seed)
    for i in range(n):
        mask = np.ones((B, T_FEAT), bool)
        for b in range(0, B, 8):          # two padded videos per batch
            mask[b, rs.randint(T_FEAT // 2, T_FEAT):] = False
        yield dict(keys=[f"v_{i:02d}{b:02d}" for b in range(B)],
                   video_feats=rs.randn(B, T_FEAT, D_FEAT).astype(np.float32),
                   video_mask=mask,
                   duration=rs.uniform(30, 200, B).astype(np.float32))


def phase_main_path(dev, kernel_fn):
    from gvl_tpu_torch.eval.evaluate import EvalRunner
    from gvl_tpu_torch.models.gvl import build_model
    cfg = types.SimpleNamespace(**FLAGSHIP)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = build_model(cfg, device=dev, generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    runner = EvalRunner(cfg, model, WordTranslator())
    with tempfile.TemporaryDirectory() as tmp:
        kernel_fn.launches = kernel_fn.bwd_launches = 0
        t0 = time.perf_counter()
        path, out_json = runner.run(synthetic_batches(N_BATCHES, SEED),
                                    f"{tmp}/dvc.json")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = (kernel_fn.launches, kernel_fn.bwd_launches)
        with open(path) as f:
            reranked = json.load(f)
    per_batch = cfg.enc_layers + cfg.dec_layers
    log("main", f"model {n_params} params; EvalRunner.run over {N_BATCHES} "
                f"batches of {B}: {wall:.3f} s wall (first batch included); "
                f"kernel launches {launches[0]} forward (want "
                f"{per_batch}/batch), {launches[1]} backward (want 0)")
    check(launches == (per_batch * N_BATCHES, 0),
          f"kernel launches {launches} != ({per_batch * N_BATCHES}, 0)")
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
    log("main", f"DVC JSON: {len(res)} videos, {n_items} events, {n_sent} "
                f"with a sentence; reranked JSON: "
                f"{sum(len(v) for v in reranked['results'].values())} events")
    return cfg, model, runner, launches


# ---------------------------------------------------------------- phase 5
def phase_paths_agree(cfg, model, runner):
    from gvl_tpu_torch.models.layers import set_msda_impl
    from gvl_tpu_torch.models.transformer import pyramid_shapes
    batch = next(synthetic_batches(1, SEED + 1))
    dev = runner.device
    feats = torch.from_numpy(batch["video_feats"]).to(dev)
    mask = torch.from_numpy(batch["video_mask"]).to(dev)
    dur = torch.from_numpy(batch["duration"]).to(dev)
    shapes = pyramid_shapes(T_FEAT, cfg.num_feature_levels)
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
        log("paths", f"{key} {tuple(ko[key].shape)}: max abs diff {err!r}")
        check(err <= TRUNK_TOL, f"{key} kernel vs plain path {err} > {TRUNK_TOL}")
    share = (kseq == pseq).float().mean().item()
    log("paths", f"greedy tokens {tuple(kseq.shape)}: {share!r} of positions "
                 f"equal")
    check(share >= TOKEN_AGREEMENT, f"token agreement {share}")


# ---------------------------------------------------------------- phase 6
def phase_time(model, runner):
    """Eval step time of both paths. A step is what EvalRunner.run does for
    a batch, less the JSON assembly: the eval step and the copy of its
    results to the host. Each window of N_WINDOW back-to-back steps is timed
    whole by one pair of CUDA events; each round times one window per path,
    in alternating order."""
    from gvl_tpu_torch.models.layers import set_msda_impl
    batch = next(synthetic_batches(1, SEED + 2))
    win = {"kernel": [], "ref": []}

    def window():
        for _ in range(N_WINDOW):
            runner._to_host(runner._eval_step(batch))

    with torch.inference_mode():
        for impl in ("kernel", "ref"):
            set_msda_impl(model, impl)
            cuda_median_ms(window, 1, warmup=1)
        for i in range(N_ROUNDS):
            order = ("ref", "kernel") if i % 2 else ("kernel", "ref")
            for impl in order:
                set_msda_impl(model, impl)
                win[impl].append(cuda_median_ms(window, 1, warmup=0) / N_WINDOW)
    set_msda_impl(model, "kernel")
    mean = {k: statistics.fmean(v) for k, v in win.items()}
    quart = {k: statistics.quantiles(v, n=4) for k, v in win.items()}
    for impl, name in (("kernel", "kernel path"), ("ref", "plain path")):
        q1, q2, q3 = quart[impl]
        log("time", f"eval step B={B} ({name}): {mean[impl]!r} ms per step "
                    f"over {N_ROUNDS * N_WINDOW} steps; window means: median "
                    f"{q2!r}, quartiles {q1!r} / {q3!r}, min "
                    f"{min(win[impl])!r}, max {max(win[impl])!r} ms; "
                    f"{B / mean[impl] * 1e3!r} clips/s")
    diffs = [p - k for p, k in zip(win["ref"], win["kernel"])]
    wins = sum(d > 0 for d in diffs)
    gap = quart["ref"][1] - quart["kernel"][1]
    spread = max(q[2] - q[0] for q in quart.values())
    resolved = (max(wins, N_ROUNDS - wins) >= 0.9 * N_ROUNDS
                and abs(gap) > spread)
    log("time", f"plain minus kernel path per round: {diffs!r} ms per step; "
                f"kernel path faster in {wins} of {N_ROUNDS} rounds; medians "
                f"differ by {gap!r} ms, widest quartile spread {spread!r} ms: "
                f"{'resolved' if resolved else 'not resolved'}")
    return mean


# ---------------------------------------------------------------- phase 7
def phase_profile(cfg, model, runner, out_dir: pathlib.Path) -> None:
    """Where one eval step's time goes, kernel path. Host: seconds to
    enqueue a step, then to wait for the device. CUDA events: trunk and
    caption decode. torch.profiler over N_PROFILED steps: device busy time,
    device op count, top device ops; the table and trace go to out_dir."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from gvl_tpu_torch.models.transformer import pyramid_shapes
    out_dir.mkdir(parents=True, exist_ok=True)
    batch = next(synthetic_batches(1, SEED + 3))
    dev = runner.device
    feats, mask, dur = (torch.from_numpy(batch[k]).to(dev) for k in
                        ("video_feats", "video_mask", "duration"))
    shapes = pyramid_shapes(T_FEAT, cfg.num_feature_levels)
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
    avgs = prof.key_averages()
    device_ops = [e for e in avgs if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device_ops) / 1e3
    n_ops = sum(e.count for e in device_ops)
    check(busy_ms > 0 and n_ops > 0, "torch.profiler saw no device time")
    (out_dir / "eval_step_ops.txt").write_text(
        avgs.table(sort_by="self_cuda_time_total", row_limit=40))
    prof.export_chrome_trace(str(out_dir / "eval_step_trace.json"))
    log("profile", f"trunk {trunk_ms!r} ms, caption decode {decode_ms!r} ms "
                   f"(CUDA-event medians of {N_PROFILED})")
    log("profile", f"host enqueue per step {statistics.median(enqueue)!r} ms "
                   f"(min {min(enqueue)!r}, max {max(enqueue)!r}), then device "
                   f"done {statistics.median(wait)!r} ms later (medians of "
                   f"{N_PROFILED})")
    log("profile", f"torch.profiler over {N_PROFILED} steps: device busy "
                   f"{busy_ms / N_PROFILED!r} ms per step, "
                   f"{n_ops / N_PROFILED!r} device ops per step")
    top = sorted(device_ops, key=lambda e: -e.self_device_time_total)
    for e in top[:8] + [e for e in top[8:] if "msda_fwd_kernel" in e.key]:
        ms = e.self_device_time_total / 1e3
        log("profile", f"  {ms / N_PROFILED!r} ms/step "
                       f"({ms / busy_ms:.1%}), {e.count // N_PROFILED} calls/"
                       f"step: {e.key[:90]}")
    log("profile", f"op table and trace in {out_dir}")


# ---------------------------------------------------------------- phase 9
def train_batch(seed: int) -> dict:
    """The synthetic train batch of the JAX package's train-step bench
    (bench.py build_train_bench, gt_counts='anet'): every GT box (0.5, 0.3),
    event counts drawn from the ActivityNet count frequencies."""
    from gvl_tpu_torch.train.criterion import COUNTER_CLASS_RATE
    rs = np.random.RandomState(seed)
    G, Lc = MAX_GT, FLAGSHIP["max_caption_len"]
    probs = np.asarray(COUNTER_CLASS_RATE[:G + 1], np.float64)
    counts = np.maximum(rs.choice(len(probs), size=B, p=probs / probs.sum()), 1)
    captions = rs.randint(1, FLAGSHIP["vocab_size"], (B, G, Lc)).astype(np.int32)
    captions[..., 0] = 0
    return dict(
        video_feats=rs.randn(B, T_FEAT, D_FEAT).astype(np.float32),
        video_mask=np.ones((B, T_FEAT), bool),
        duration=rs.uniform(30, 90, (B,)).astype(np.float32),
        gt_boxes=np.stack([np.full((B, G), 0.5), np.full((B, G), 0.3)],
                          -1).astype(np.float32),
        gt_labels=np.zeros((B, G), np.int32),
        gt_mask=np.arange(G)[None, :] < counts[:, None],
        captions=captions, caption_mask=np.ones((B, G, Lc), bool))


def phase_train_main_path(dev, kernel_fn):
    from gvl_tpu_torch.models.gvl import build_model
    from gvl_tpu_torch.train.criterion import LossSpec, make_weight_dict
    from gvl_tpu_torch.train.state import (StepStatics, create_train_state,
                                           make_train_step)
    cfg = types.SimpleNamespace(**FLAGSHIP)
    torch.manual_seed(SEED)               # the dropout draws
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = build_model(cfg, generator=gen)          # no device: the card
    check(next(model.parameters()).device == dev, "build_model's default "
          f"device is {next(model.parameters()).device}, not {dev}")
    statics = StepStatics(
        spec=LossSpec.from_config(cfg), enable_contrastive=False,
        caption_loss=True, two_stage=False, train_text_encoder=False,
        disable_mid_caption_heads=False, enable_pos_emb_for_captioner=False,
        temporal_shapes=ENC_SHAPES)
    state = create_train_state(cfg, model, STEPS_PER_EPOCH, statics)
    step = make_train_step(model, cfg, statics)
    weights = make_weight_dict(cfg)
    batches = [train_batch(SEED), train_batch(SEED + 1)]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    per_step = cfg.enc_layers + cfg.dec_layers
    kernel_fn.launches = kernel_fn.bwd_launches = 0
    t0 = time.perf_counter()
    for i in range(N_TRAIN_STEPS):
        losses = {k: float(v) for k, v in
                  step(state, batches[i % 2], weights).items()}
        check(set(losses) == TRAIN_LOSS_KEYS,
              f"loss keys {sorted(set(losses) ^ TRAIN_LOSS_KEYS)} differ")
        check(all(math.isfinite(v) for v in losses.values()),
              f"step {i}: non-finite loss in {losses}")
        check(kernel_fn.launches == per_step * (i + 1)
              and kernel_fn.bwd_launches == per_step * (i + 1),
              f"step {i}: launches {kernel_fn.launches} forward, "
              f"{kernel_fn.bwd_launches} backward, want {per_step * (i + 1)}")
        log("train", f"step {i}: total {losses['total_loss']!r}, caption "
                     f"{losses['loss_caption']!r}, giou {losses['loss_giou']!r}"
                     f", ce {losses['loss_ce']!r}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (kernel_fn.launches, kernel_fn.bwd_launches)
    n_params = 0
    for n, p in model.named_parameters():
        n_params += 1
        check(p.grad is not None and bool(torch.isfinite(p.grad).all()),
              f"{n} has no finite gradient")
    moved = sum(not torch.equal(p.detach(), before[n])
                for n, p in model.named_parameters())
    check(moved > 0.9 * n_params, f"only {moved} of {n_params} tensors moved")
    check(state.step == N_TRAIN_STEPS, f"state.step {state.step}")
    log("train", f"{N_TRAIN_STEPS} steps at B={B}, G={MAX_GT}: {wall:.3f} s "
                 f"wall (first step included); launches {launches[0]} forward"
                 f", {launches[1]} backward (want {per_step}/step each); "
                 f"{n_params} parameter tensors with a finite gradient, "
                 f"{moved} moved; lr {state.optimizer.param_groups[0]['lr']!r}")
    return model, state, step, weights, batches, launches


# --------------------------------------------------------------- phase 10
def phase_train_paths_agree(model, step, weights, batch) -> None:
    from gvl_tpu_torch.models.layers import set_msda_impl
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
    log("tpaths", f"total loss kernel path {kt!r}, plain path {pt!r}: "
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
    log("tpaths", f"{len(pg)} named gradients: worst max abs diff / own max "
                  f"abs {worst!r} ({worst_name})")


# --------------------------------------------------------------- phase 11
def phase_train_time(state, step, weights, batches) -> dict:
    import gvl_tpu_torch.train.criterion as criterion
    for i in range(N_TRAIN_WARMUP):
        step(state, batches[i % 2], weights)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    it = iter(range(10 ** 6))
    step_ms = cuda_median_ms(
        lambda: step(state, batches[next(it) % 2], weights), N_TRAIN_TIMED,
        warmup=0)
    peak = torch.cuda.max_memory_allocated()
    log("ttime", f"train step B={B}: {step_ms!r} ms (median of "
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
    log("ttime", "split, medians of %d steps, device timeline (CUDA events) "
                 "/ host enqueue (host clock), ms: " % N_TRAIN_SPLIT
        + "; ".join(f"{k} {med(dev_ms[k])!r} / {med(host_ms[k])!r}"
                    for k in parts))
    log("ttime", f"matcher inside 'criterion' (host clock after a "
                 f"synchronise): copies {med(lap_ms['copy'])!r} ms, scipy "
                 f"solve of {FLAGSHIP['dec_layers'] * B} problems "
                 f"{med(lap_ms['solve'])!r} ms")
    return dict(step_ms=step_ms, peak=peak)


def phase_train_profile(state, step, weights, batches,
                        out_dir: pathlib.Path) -> None:
    """torch.profiler over N_PROFILED train steps: device busy time and
    device op count per step, the top device ops and the two kernels; the
    op table goes to out_dir."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(N_PROFILED):
            step(state, batches[i % 2], weights)
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    device_ops = [e for e in avgs if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device_ops) / 1e3
    n_ops = sum(e.count for e in device_ops)
    check(busy_ms > 0 and n_ops > 0, "torch.profiler saw no device time")
    (out_dir / "train_step_ops.txt").write_text(
        avgs.table(sort_by="self_cuda_time_total", row_limit=40))
    log("tprofile", f"torch.profiler over {N_PROFILED} train steps: device "
                    f"busy {busy_ms / N_PROFILED!r} ms per step, "
                    f"{n_ops / N_PROFILED!r} device ops per step")
    top = sorted(device_ops, key=lambda e: -e.self_device_time_total)
    for e in top[:8] + [e for e in top[8:] if "msda_" in e.key]:
        ms = e.self_device_time_total / 1e3
        log("tprofile", f"  {ms / N_PROFILED!r} ms/step ({ms / busy_ms:.1%}), "
                        f"{e.count / N_PROFILED!r} calls/step: {e.key[:90]}")


def msda_bound(Lq: int, backward: bool) -> dict:
    """The least time the card could take for one call at B, S=188, H, Dh,
    K=16 and this Lq: each input read once and each output written once at
    the memory rate, against 2 FMAs per tap and channel (forward) or 4
    (backward: two dot products, two scatter-adds) at the f32 rate."""
    S, K = sum(ENC_SHAPES), len(ENC_SHAPES) * P
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


def kernel_row(name, source, replaces, launches, kv, backward) -> dict:
    """One entry of the kernels line: the required keys at the encoder
    shape, the decoder shape's beside them. library_ms is null: no single
    PyTorch call computes either function (F.grid_sample would take one call
    per level and a weighted sum after them)."""
    enc, dec = msda_bound(sum(ENC_SHAPES), backward), msda_bound(30, backward)
    (k_ms, p_ms), (dk_ms, dp_ms) = kv["times"]["encoder"], kv["times"]["decoder"]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": sum(launches.values()), "max_abs_err": kv["max_abs_err"],
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": enc["bound_ms"],
        "bound_by": enc["bound_by"], "library_ms": None,
        "shape": "encoder B=16 S=188 Lq=188 H=8 Dh=64 K=16",
        "launches_by_path": launches,
        "decoder_shape": {"Lq": 30, "ms": dk_ms, "plain_ms": dp_ms,
                          "bound_ms": dec["bound_ms"],
                          "bound_by": dec["bound_by"]}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", type=pathlib.Path, metavar="DIR",
                    help="also profile the eval step (phase 7) and the train "
                         "step and write the op tables and a trace here")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (phases 1-3 and 8); "
                         "prints no result line")
    args = ap.parse_args()
    name = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    from gvl_tpu_torch.ops import ms_deform_attn_1d
    kv = phase_kernel_vs_plain(dev)
    bkv = phase_bwd_kernel_vs_plain(dev)
    if args.kernels_only:
        return
    cfg, model, runner, launches = phase_main_path(dev, ms_deform_attn_1d)
    phase_paths_agree(cfg, model, runner)
    med = phase_time(model, runner)
    if args.profile:
        phase_profile(cfg, model, runner, args.profile)
    del model, runner
    (tmodel, state, step, weights, batches,
     train_launches) = phase_train_main_path(dev, ms_deform_attn_1d)
    phase_train_paths_agree(tmodel, step, weights, batches[0])
    phase_train_time(state, step, weights, batches)
    if args.profile:
        phase_train_profile(state, step, weights, batches, args.profile)
    k_ms, p_ms = kv["times"]["encoder"]
    log("time", f"per call at the encoder shape: kernel {k_ms!r} ms, plain "
                f"{p_ms!r} ms; decoder shape: kernel "
                f"{kv['times']['decoder'][0]!r} ms, plain "
                f"{kv['times']['decoder'][1]!r} ms; eval clips/s kernel path "
                f"{B / med['kernel'] * 1e3!r}, plain path "
                f"{B / med['ref'] * 1e3!r}")
    for row in ("fwd", kv, False), ("bwd", bkv, True):
        for label, Lq in (("encoder", sum(ENC_SHAPES)), ("decoder", 30)):
            bd = msda_bound(Lq, row[2])
            log("bound", f"{row[0]} {label}: {bd['bytes']} bytes, "
                         f"{bd['flops']} flop -> {bd['bound_ms']!r} ms, bound "
                         f"by {bd['bound_by']}; kernel "
                         f"{row[1]['times'][label][0]!r} ms")
    print(json.dumps({"kernels": [
        kernel_row("ms_deform_attn_fwd",
                   "gvl_tpu_torch/csrc/ms_deform_attn_fwd.cu",
                   "gvl_tpu/ops/ms_deform_attn.py:217",
                   {"eval": launches[0], "train": train_launches[0]}, kv,
                   False),
        kernel_row("ms_deform_attn_bwd",
                   "gvl_tpu_torch/csrc/ms_deform_attn_bwd.cu",
                   "gvl_tpu/ops/ms_deform_attn.py:236",
                   {"eval": launches[1], "train": train_launches[1]}, bkv,
                   True),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
