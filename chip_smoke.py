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
The last two lines are the kernels' JSON summary and
{"ok": true, "device": {...}}. The run uses one card, the first visible.
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
    eval_matching_score_weight=0.0)
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
        kernel_fn.launches = 0
        t0 = time.perf_counter()
        path, out_json = runner.run(synthetic_batches(N_BATCHES, SEED),
                                    f"{tmp}/dvc.json")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_fn.launches
        with open(path) as f:
            reranked = json.load(f)
    per_batch = cfg.enc_layers + cfg.dec_layers
    log("main", f"model {n_params} params; EvalRunner.run over {N_BATCHES} "
                f"batches of {B}: {wall:.3f} s wall (first batch included); "
                f"kernel launches {launches} (want {per_batch}/batch)")
    check(launches == per_batch * N_BATCHES,
          f"kernel launches {launches} != {per_batch * N_BATCHES}")
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", type=pathlib.Path, metavar="DIR",
                    help="also run phase 7 and write its table and trace here")
    args = ap.parse_args()
    name = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    from gvl_tpu_torch.ops import ms_deform_attn_1d
    kv = phase_kernel_vs_plain(dev)
    cfg, model, runner, launches = phase_main_path(dev, ms_deform_attn_1d)
    phase_paths_agree(cfg, model, runner)
    med = phase_time(model, runner)
    if args.profile:
        phase_profile(cfg, model, runner, args.profile)
    k_ms, p_ms = kv["times"]["encoder"]
    log("time", f"per call at the encoder shape: kernel {k_ms!r} ms, plain "
                f"{p_ms!r} ms; decoder shape: kernel "
                f"{kv['times']['decoder'][0]!r} ms, plain "
                f"{kv['times']['decoder'][1]!r} ms; eval clips/s kernel path "
                f"{B / med['kernel'] * 1e3!r}, plain path "
                f"{B / med['ref'] * 1e3!r}")
    print(json.dumps({"kernels": [{
        "name": "ms_deform_attn_fwd",
        "route": "cuda",
        "source": "gvl_tpu_torch/csrc/ms_deform_attn_fwd.cu",
        "replaces": "gvl_tpu/ops/ms_deform_attn.py:217",
        "launches": launches,
        "max_abs_err": kv["max_abs_err"],
        "ms": k_ms,
        "plain_ms": p_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
