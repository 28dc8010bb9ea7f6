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
     of 32, 64, 128 and 192 floats, at a dense encoder over the long-video
     pyramid (B=1, Lq=S=1500) and at the transformer caption head's one
     head of 512 floats (B=16, Lq=900 and Lq=30); max abs error <= 1e-5.
     Times at the main
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
     sentence) and the eval losses. Each workload's cfg is the port's
     load_config of its yml with the changes CUTS names, and nothing else.
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
     at 5e-5 with L2 1e-4 as published, clip 100, dropout on); checks the loss keys, finite losses, 4
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
 16. (flagship, after phase 7) the eval CLI on the card: a run directory
     in the on-disk form the JAX package reads (40 videos of 60-180 frames
     of 512-d .npy features resized to 100, ActivityNet event counts with
     5-20-word sentences and one video of 37, two reference annotation
     files and their paragraph files, the grounding GT, a vocabulary of
     exactly 8517 words, an opts.json of the port's load_config of the yml
     with only the data paths changed, model-best.pth of the seeded model
     and text encoder) evaluated by gvl_tpu_torch.eval_cli.main in this
     process: kernel 1 launched 4 times per batch over 2 full batches of 16
     and a padded one of 8, the banded kernels never; the DVC, reranked
     and both grounding JSONs written (one grounding key per GT sentence,
     every DVC number finite); the scores JSON with METEOR, CIDEr, Bleu_4,
     soda_c, MetaScore, grounding_mIOU and the METEOR approximations in
     `approx`; the CLI's four JSONs equal, bit for bit, to those of
     EvalRunner.run called directly on the same checkpoint and the port's
     Batcher. Logs the CLI's stage times, whole-CLI videos/s with and
     without the metrics and the batcher's time per batch.
 17. (flagship, after phase 16, in phase 16's world written again) the
     train CLI on the card: a yml of the port's load_config of
     cfgs/anet_tsp_msvg_dvc.yml with the world's data paths, save_dir and
     CUTS['anet_train_cli'] (2 epochs, validation from epoch 0, B=16, the
     run's id), run by gvl_tpu_torch.train_cli.main in this process: 2
     epochs of 2 steps (Adam at 5e-5, L2 1e-4, clip 100), each validated:
     kernel 1 launched 4 times per step and per validation batch, kernel 2
     4 times per step, the banded kernels never; finite train losses;
     info.json with two val_scores entries holding METEOR, soda_c,
     grounding_R@1IOU0.5 and val_loss_total; model-last, model-best and
     model-best-{dvc,pc,grounding}.pth. model-last restored into a fresh
     train state equals the run's state at its end bit for bit (model, text
     encoder, Adam state, schedule, step). Then --start_from the run with
     --epoch 3 and a contrary --lr: the same run directory, info.json at
     epoch 2, the saved lr kept, the first update the saved one. Then the
     eval CLI on the trained model-best.pth. Logs the step time median,
     the steps' time per epoch, each validation's time, the checkpoint
     saves' time and size. The checkpoints go to a temporary directory,
     deleted at the end of phase 18.
 18. SCST on the card: a yml of the port's load_config of
     cfgs/anet_tsp_dvc_rl.yml with the data paths, save_dir, pretrain_path
     (phase 17's run directory) and CUTS['anet_scst'] (debug: 5 steps and
     one validation batch; one epoch; B=16), by train_cli.main:
     load_pretrained('full') filled every model entry; kernels 1 and 2
     launched 4 times per step (kernel 1 also per validation batch); the
     caption losses finite and the host rewards not all zero; only
     caption_head.* moved, the trunk, the other heads and the text encoder
     are the pretrained run's bit for bit. One batch's sampled rollout
     (the fused two-layer path, its generator and dropout seeded alike) on
     the kernel path and the plain path: >= 99% equal tokens, logprobs
     within 1e-4 where the rollouts agree. Logs the step split (trunk,
     sampled chain, greedy chain, host reward, backward, optimizer; the
     device synchronised at each mark), the host reward's time, the valid
     rollout slots per step and the peak device memory.
 19. (after phase 13) kernels 1 and 3 in their bf16-tap form against their
     plain version on the same bf16 inputs (the JAX rule for bf16 loc
     and/or attn in both: ops/ms_deform_attn.py): kernel 1 at the flagship
     encoder and decoder shapes and the long-video decoder, every tap
     class, each (loc, attn) dtype pair the levels allow; kernel 3 at the
     long-video encoder (B=8; f32 loc, bf16 attn) and at levels
     256+128+64+32 (every pair); max abs error <= 1e-5; a bf16 loc over the
     long-video levels is refused. Device medians of the form the path runs
     (f32 loc, bf16 attn) beside the f32 form on the same weights widened,
     the plain version and embedding_bag.
 20. (flagship, after phase 6) the eval under each decode option:
     eval_decode_bf16, eval_full_bf16, eval_beam_size 3 and
     eval_decode_early_exit. For each, EvalRunner.run over 3 batches (the
     launches: under eval_full_bf16 the encoder's taps are f32, the
     decoder's attn bf16, so kernel 1 runs its f32 form twice and its
     bf16-tap form twice a batch; finite JSONs; the decode's steps); one
     batch on both paths under the option (trunk outputs to 1e-4, under
     eval_full_bf16 to 5e-2 x their max abs; tokens >= 99%, under the bf16
     options >= 95%: the paths' last-bit differences move bf16 roundings,
     which flips near-tied tokens of the random model); the step's time
     beside the f32 greedy step's (early exit's also with the stop read
     every 5 steps),
     in turns. In phase 14's place for the long video: one batch under
     eval_full_bf16 (kernel 3's f32 form and kernel 1's bf16-tap form). In
     phase 16: the eval CLI with --eval_use_amp, its JSONs equal to
     EvalRunner.run's under eval_use_amp and eval_decode_bf16.
 21. (after phase 11) the light, transformer and none caption heads at
     the flagship's widths: EvalRunner.run over 3 batches (the transformer
     head's decode launches kernel 1 once a layer and step, at Lq = 30);
     phase 10's kernel vs plain path check; 3 train steps with their
     launches (the transformer head's teacher forcing launches kernels 1
     and 2 once a decoder layer at Lq = 30 x 30 = 900), times and peak
     device memory.
 22. MLP class heads and the heads shared across decoder layers
     (with_box_refine=0): phase 10's check and one train step each.
 23. train_caption_bf16 on the flagship train step: phase 9's checks, then
     phase 11's time, split and peak memory beside phase 11's f32 ones; in
     phase 18, SCST again under train_caption_bf16 (the bf16 rollouts), its
     step split and peak memory beside the f32 run's.
 24. (after phase 23) the gpt2 (ClipCap) caption head on the flagship
     (CUTS['anet_gpt2']: the offline GPT-2 spec, vocab 1000, 128 wide, 2
     layers of 4 heads, prefix_length 10, prefix_size = hidden 512; random
     weights from the seed): EvalRunner.run over 3 batches of 16 in f32,
     under eval_decode_early_exit and under eval_decode_bf16 (kernel 1 four
     times a batch, finite JSONs, both grounding JSONs, captions of 'w<id>'
     words); early exit's DVC JSON equal to the fixed loop's; one batch on
     the kernel and the plain path (trunk to 1e-4, the head's tokens >= 99%
     equal, cap_scores to 1e-4 where the captions agree); the bf16 decode's
     step beside the f32 one, in turns; phase 10's check of losses and
     named gradients (a gradient past 1e-3 of its max abs held to twice the
     plain path's own difference between the card and the CPU: the gpt2
     loss reaches trunk gradients whose sums cancel, plain_spread) and 3
     train steps with their launches, times and peak memory. Then the head at GPT-2 small's published widths (vocab 50257,
     768 wide, 12 layers of 12 heads, 1024 positions; random weights) on
     the same trunk: one eval step over 16 x 30 events x 30 tokens and two
     train steps, their times and peak device memory.
 25. (after phase 24) TAL on the flagship (CUTS['anet_tal']: the linear
     probe, only_ft_class_head, with ActivityNet 1.3's 200 classes; the
     class file and a TAL ground truth of the batches' GT events written
     here): EvalRunner.run over 3 batches writes the TAL JSON (kernel 1 four
     times a batch; its labels class names), eval_tal gives a finite mAP;
     zero-shot TAL: the 200 names, prompted "a video of", embedded
     (enable_zeroshot_tal, its time logged), EvalRunner.run gives every
     prediction 200 tal_cl_scores and aux_tal_cl_scores in [-1, 1], the
     kernel and plain paths' class scores agree to 1e-4 on one batch,
     convert_dvc_to_zeroshot_tal writes a submission labelled with class
     names; two probe train steps: kernels 1 and 2 four times a step (every
     parameter gets its gradient), only the class heads move.
 26. (after phase 25) the flagship as published, with published files
     (CUTS['anet_published']: only huggingface_cache_dir, set to the
     hub cache that this phase writes in its temporary directory and
     removes with it): a hub cache of roberta-base
     (models--roberta-base/refs/main, snapshots/<rev>/: config.json with
     its published values, 768 x 12, 12 heads, FFN 3072, vocab 50265, 514
     positions, eps 1e-5; random weights from the seed in
     model.safetensors, an MLM checkpoint's names, by the port's own
     writer; a byte-level BPE vocabulary of 50265 ids: <s> <pad> </s> <unk>
     at 0-3, the 256 byte symbols, merges counted from the world's
     captions, numbered fillers, <mask> at 50264) read by load_text_encoder
     through gvl_tpu_torch.utils.hf_files and models.bpe, the host time of
     tokenizing one eval batch (16 videos x G sentences) and the text
     encoder's device time at vocab 50265; a GPT-2 directory at GPT-2
     small's widths (vocab 50257, 768 x 12, 1024 positions, its own BPE,
     eos as the pad token) through load_gpt2_spec / make_gpt_tokenize: the
     spec, the stop id encode(".")[0], one train step and one eval step of
     the gpt2 head on its BPE tokens (kernels 1 and 2 counted); a
     reference-layout .pth of the seeded flagship (its state_dict, the bbox
     heads again under transformer.decoder.bbox_head, the caption DSA's dead
     output_proj / attention_weights, text_encoder.*, all under "model")
     imported by gvl_tpu_torch.import_cli.main (unused and unfilled empty,
     as the importer's rules predict; the imported weights the seeded ones
     bit for bit; its seconds); eval_cli.main on the imported run (kernel 1
     counted, videos/s); the train CLI from it with --pretrain_path (one
     epoch of 2 steps, kernels 1 and 2 counted); the kernel path against
     the plain path on the imported weights at phase 5's tolerances, and
     cap_scores to 1e-4 on the events whose tokens agree.
 27. (after phase 25) the trainer's last options on the flagship, each on
     its own seeded model, the frozen text encoder shared: the caption cost
     (CUTS['anet_caption_cost'], set_cost_caption 1.0: every decoder
     layer's teacher-forced NLL of all 30 x 30 (query, GT) pairs, without
     gradient, joins the matcher; the caption loss is the matched pairs'
     own teacher-forced pass, at the flagship's B = 16), scheduled
     sampling at the yml's scheduled_sampling_max_prob (0.25; the
     LSTM-DSA head's serial chain) and two-stage queries
     (CUTS['anet_gt_proposals']: the GT segments as queries, the class and
     box weights 0; first EvalRunner.run over 3 batches of 16 with the GT
     boxes as proposals, launches, finite JSONs, both grounding JSONs).
     For each: phase 10's kernel vs plain path check in train mode, dropout
     seeded alike and, for scheduled sampling, the kernel path's draws
     forced into the plain path's chain (ForcedDraws); then 5 steps, their
     CUDA-event median, peak device memory and launches per step (kernels 1
     and 2 four times each).
 28. (after phase 26) the TSP backbone at full width (r2plus1d_34, BatchNorm
     eps 1e-3, 16 x 112 x 112 clips, f32, TF32 off): extract_clip_features
     at batch 8 on the seeded frames of three synthetic videos (7, 4 and 3
     clips), one (n_clips, 512) array each, the card's features of 2 clips
     within TSP_FEATURE_TOL x their max abs of the same weights' on the
     CPU, clips/s (CUDA events); where cv2 imports, extract_features on a
     video it writes, else a line saying so and decode_video_frames'
     ImportError checked. Then the train step on the card against the
     CPU from the same weights, batch TSP_CHECK_B, fc dropout off
     (tsp_step_card_vs_cpu): in float64, two steps (the first at lr 0),
     every parameter's change, BatchNorm running statistic's change and
     SGD momentum buffer within TSP_F64_TOL x its CPU max abs; in float32,
     the first step's momentum buffers of each against float64's, the
     card's median error within TSP_F32_RATIO x the CPU's. Then
     TSPTrainer with the TSP recipe's two heads (200 actions, 2 temporal
     regions) and a 512-d GVF at batch 32: 3 steps (CUDA events each) and
     one validation batch, finite history,
     the frozen stem unchanged, layer4 moved, peak device memory; the
     trained model written as a torchvision-named .pth, imported by
     import_cli --backbone, and read back by extract_features' model:
     its features equal the trainer's.
 15r. (after phase 11 of each workload) remat_trunk (CUTS['anet_remat'],
     CUTS['longvideo_remat']): the seeded train step with and without it,
     dropout on and seeded alike: every named gradient within 1e-6 (the
     flagship) or phase 10's 1e-3 (the long video, kernel 4's atomics) of
     its max abs; the forward kernels launched twice per layer with it (the
     backward recomputes each layer); 3 timed steps of each, with their
     peak device memory, which must not be higher with remat_trunk.
With --kernels-only the script stops after phases 1-3, 8, 12, 13 and 19.
With --profile DIR phases 7 and 11 also profile the long-video steps. The
last two lines are the kernels' JSON summary (kernels 1-4 and the bf16-tap
forms of 1 and 3, each with its launches on every path, phases 24, 25,
26 and 15r included, with the library call's time, library_ms, the dense
ones with the earlier kernel's, old_ms, null without --old-forms, the
backward's with each of its two CUDA kernels' time and bound, split, the
bf16-tap forms with their f32 form's time, f32_form_ms) and {"ok": true,
"device": {...}}. The run uses one card, the first visible.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
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

TRAIN_CLI_EPOCHS = 2            # phase 17: epochs of the first run
TRAIN_CLI_B = 16                # phases 17, 18: train batch
CFGS = pathlib.Path(__file__).resolve().parent / "cfgs"
# The pretrained roberta-base weights and its tokenizer are not in the repo:
# the offline RoBERTa at roberta-base's widths and depth (hidden 768, 12
# layers, 12 heads, FFN 3072; its embedding table has the hash tokenizer's
# 5000 rows, not 50265), with random weights from the seed
OFFLINE_ROBERTA = dict(load_pretrained_language_model_from_config="offline",
                       offline_text_encoder_hidden=768,
                       offline_text_encoder_layers=12)
# Each workload's changes to its published config, every one named here:
# the keys of CUTS[name] are the only ones in which the workload's cfg
# differs from the port's load_config of its yml.
CUTS = {
    # cfgs/anet_tsp_msvg_dvc.yml as published: hidden 512, 8 heads, 2+2
    # layers, 4 levels, 30 queries, vocab 8517, the contrastive text side on
    # (attention word pool, layer-dependent text features, one sentence
    # layer with the cosine position table, projections to 128), a frozen
    # text encoder, grounding eval on, Adam at 5e-5 with L2 1e-4, 25 epochs
    "anet": dict(OFFLINE_ROBERTA),
    # the flagship with the contrastive side off (no text encoder)
    "anet_dvc": dict(OFFLINE_ROBERTA, enable_contrastive=False),
    # cfgs/ym_i3d_msvg_dvc.yml as published (YouMakeup: 800 frames of
    # 1024-d i3d features, 100 queries, vocab 1247, layer-independent text
    # features, G = min(300, 64) = 64 sentence slots, Adam at 1e-4 with L2
    # 1e-4, the text encoder trained by an Adam of its own on a multi_step
    # schedule); eval batches of 8 videos, not 16: the run's three eval
    # batches of 800 frames stay inside the phase's time
    "longvideo": dict(OFFLINE_ROBERTA, eval_batch_size=8),
    # phase 17, the train CLI on the flagship: 2 epochs, not 25; validation
    # from epoch 0, not 2 (the published min_epoch_when_save would validate
    # no epoch of a 2-epoch run); batches of 16 videos, not the Config
    # default of 1 that the yml keeps (phases 9-11's train batch: 2 steps
    # an epoch in the 40-video world); the run's id. The world's data paths
    # and the save_dir are set at run time (train_cli_cfg)
    "anet_train_cli": dict(OFFLINE_ROBERTA, id="anet_train_cli",
                           epoch=TRAIN_CLI_EPOCHS, min_epoch_when_save=0,
                           batch_size=TRAIN_CLI_B),
    # phase 18, SCST as cfgs/anet_tsp_dvc_rl.yml publishes it (the flagship
    # fine-tuned: only_ft_captioner, AdamW at 5e-5, crops of 256 with a
    # minimum ratio of 0.5, Meteor 0.95 + CiderD 0.05, rl_m2o_rate 4, the
    # fused two-layer rollouts): debug (5 steps, then one validation batch),
    # one epoch, not 25, and batches of 16 crops, not 1 (as phase 17). Data paths, save_dir and pretrain_path (phase
    # 17's run directory) are set at run time (scst_cfg); the CiderD
    # document-frequency file it names is not in the repo, so CiderD takes
    # the document frequencies of each call, as in the JAX package
    "anet_scst": dict(OFFLINE_ROBERTA, debug=True, epoch=1,
                      batch_size=TRAIN_CLI_B),
    # phase 24: the flagship with the gpt2 (ClipCap) caption head, the
    # offline GPT-2 spec (vocab 1000, 128 wide, 2 layers of 4 heads; the
    # published prefix_size 512 is the hidden width, prefix_length 10)
    "anet_gpt2": dict(OFFLINE_ROBERTA, caption_decoder_type="gpt2"),
    # phase 25: the flagship as the TAL linear probe, with ActivityNet 1.3's
    # 200 action classes; the class file and the TAL ground truth are
    # written at run time
    "anet_tal": dict(OFFLINE_ROBERTA, only_ft_class_head=True,
                     num_classes=200),
    # phase 15's remat check: the flagship and the long video with each
    # encoder and decoder layer checkpointed
    "anet_remat": dict(OFFLINE_ROBERTA, remat_trunk=True),
    "longvideo_remat": dict(OFFLINE_ROBERTA, eval_batch_size=8,
                            remat_trunk=True),
    # phase 26: the flagship as published, its pretrained roberta-base read
    # from the hub cache that the phase writes in its temporary directory
    # and sets here (random weights at its published widths: the real files
    # are not in the repo)
    "anet_published": dict(huggingface_cache_dir=None),
    # phase 27, the trainer's last options on the flagship: the caption cost
    # at 1.0 (every yml publishes set_cost_caption 0) and two-stage queries
    # (transformer_input_type gt_proposals). Scheduled sampling is the
    # train step's ss_prob, run at the yml's scheduled_sampling_max_prob
    "anet_caption_cost": dict(OFFLINE_ROBERTA, set_cost_caption=1.0),
    "anet_gt_proposals": dict(OFFLINE_ROBERTA,
                              transformer_input_type="gt_proposals"),
}
YMLS = {"anet": "anet_tsp_msvg_dvc.yml", "anet_dvc": "anet_tsp_msvg_dvc.yml",
        "longvideo": "ym_i3d_msvg_dvc.yml",
        "anet_train_cli": "anet_tsp_msvg_dvc.yml",
        "anet_scst": "anet_tsp_dvc_rl.yml",
        "anet_gpt2": "anet_tsp_msvg_dvc.yml",
        "anet_tal": "anet_tsp_msvg_dvc.yml",
        "anet_remat": "anet_tsp_msvg_dvc.yml",
        "longvideo_remat": "ym_i3d_msvg_dvc.yml",
        "anet_published": "anet_tsp_msvg_dvc.yml",
        "anet_caption_cost": "anet_tsp_msvg_dvc.yml",
        "anet_gt_proposals": "anet_tsp_msvg_dvc.yml"}


def workload_cfg(name: str) -> dict:
    """The port's load_config of the workload's yml, as a dict, with the
    workload's CUTS over it."""
    from gvl_tpu_torch.config import load_config
    return dict(load_config(str(CFGS / YMLS[name])).to_dict(), **CUTS[name])


FLAGSHIP = workload_cfg("anet")
FLAGSHIP_DVC = workload_cfg("anet_dvc")
CL_EPOCH = 2        # the contrastive weight's schedule value from this epoch
LONGVIDEO = workload_cfg("longvideo")
TRAIN_CLI = workload_cfg("anet_train_cli")
SCST = workload_cfg("anet_scst")


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
GPT2 = dataclasses.replace(ANET, name="anet_gpt2", tag="gpt2",
                           cfg=workload_cfg("anet_gpt2"))
TAL = dataclasses.replace(ANET, name="anet_tal", tag="tal",
                          cfg=workload_cfg("anet_tal"))
PUBLISHED = dataclasses.replace(ANET, name="anet_published", tag="pub",
                                cfg=workload_cfg("anet_published"))
OPTIONS = {name: dataclasses.replace(ANET, name=f"anet_{name}", tag=tag,
                                     cfg=workload_cfg(f"anet_{name}"))
           for name, tag in (("caption_cost", "ccost"),
                             ("gt_proposals", "gtp"))}
REMAT = {"anet": workload_cfg("anet_remat"),
         "longvideo": workload_cfg("longvideo_remat")}


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
        fn.launches = fn.bwd_launches = fn.bf16_launches = 0


def read_counts() -> dict:
    """Launches per kernel: kernels 1-4 and the bf16-tap forms of 1 and 3."""
    dense, banded = kernel_fns()
    return {"fwd": dense.launches, "bwd": dense.bwd_launches,
            "banded_fwd": banded.launches, "banded_bwd": banded.bwd_launches,
            "fwd_bf16": dense.bf16_launches,
            "banded_fwd_bf16": banded.bf16_launches}


def want_counts(w: Workload, steps: int, train: bool) -> dict:
    """The launches of `steps` eval batches or train steps of an f32 path."""
    per = w.launches_per_step()
    return {"fwd": per["dense"] * steps,
            "bwd": per["dense"] * steps * train,
            "banded_fwd": per["banded"] * steps,
            "banded_bwd": per["banded"] * steps * train,
            "fwd_bf16": 0, "banded_fwd_bf16": 0}


# ---------------------------------------------------------------- phase 1
def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU only")
    name = torch.cuda.get_device_name(0)
    smi = card()
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
# rows of 32, 64 and 128 floats, a dense encoder over the long-video
# pyramid (Lq = S = 1500), whose taps the backward's value kernel walks in
# several chunks and row ranges, and the flagship's transformer caption head
# (one head of 512 floats: its teacher forcing over 30 x 30 tokens a video,
# its decode step over 30) and a row of 192 floats
DENSE_GEOMETRIES = ((TINY_SHAPES, 2, 70, 4, 32, 2),
                    (TINY_SHAPES, 2, 70, H, DH, 2),
                    (TINY_SHAPES, 2, 70, 2, 128, 2),
                    (LONG.shapes, 1, sum(LONG.shapes), H, DH, P),
                    (ANET.shapes, ANET.train_B, 900, 1, 512, P),
                    (ANET.shapes, ANET.eval_B, 30, 1, 512, P),
                    (TINY_SHAPES, 2, 70, 1, 192, 2))


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


# --------------------------------------------------------------- phase 16
CLI_VIDEOS = 40                 # 2 full eval batches of 16 and one of 8
CLI_FRAMES = (60, 181)          # frames per video, resized to T
CLI_STAGES = ("config_and_data", "model_build", "checkpoint_load",
              "eval_run", "metrics")
CLI_SCORE_KEYS = {"METEOR", "CIDEr", "Bleu_4", "soda_c", "MetaScore",
                  "grounding_mIOU"}


def write_cli_data(w: Workload, root: pathlib.Path) -> tuple:
    """The data of a run in the on-disk form the JAX package reads, for the
    workload's published config: CLI_VIDEOS videos of CLI_FRAMES frames of
    feature_dim-d features (.npy, named by the config's feature type),
    ActivityNet event counts with 5-20-word sentences and one video of
    w.long_sentences, two reference annotation files and their paragraph
    files, the grounding GT and a vocabulary of exactly vocab_size words.
    Returns (the data paths as config keys, the grounding GT path, the
    annotations); the first annotation file is also the train file."""
    from gvl_tpu_torch.data.features import feature_path
    from gvl_tpu_torch.data.vocabulary import build_vocabulary
    cfg = w.cfg
    rs = np.random.RandomState(SEED + 16)
    vf_types = cfg["visual_feature_type"]
    vf_type = vf_types[0] if isinstance(vf_types, list) else vf_types
    feat_dir = root / "features" / vf_type
    feat_dir.mkdir(parents=True)
    counts = event_counts(w, rs, CLI_VIDEOS)
    counts[3] = w.long_sentences
    annos = ({}, {})
    for i, n in enumerate(counts):
        key = f"v_{i:011d}"
        T = rs.randint(*CLI_FRAMES)
        np.save(feature_path(key, vf_type, str(feat_dir))[0],
                rs.randn(T, cfg["feature_dim"]).astype(np.float32))
        duration = float(rs.uniform(*w.duration))
        for anno in annos:                # two annotators, as val_1 / val_2
            start = rs.uniform(0, 0.9 * duration, n)
            end = np.minimum(start + rs.uniform(0.05, 0.4, n) * duration,
                             duration)
            anno[key] = {"duration": duration,
                         "timestamps": [[float(s), float(e)]
                                        for s, e in zip(start, end)],
                         "sentences": sentences(rs, int(n))}
    paths = {}
    for j, anno in enumerate(annos):
        paths[f"val_{j + 1}"] = root / f"val_{j + 1}.json"
        paths[f"para_{j + 1}"] = root / f"para_{j + 1}.json"
        paths[f"val_{j + 1}"].write_text(json.dumps(anno))
        paths[f"para_{j + 1}"].write_text(json.dumps(
            {k: " ".join(v["sentences"]) for k, v in anno.items()}))
    grounding = root / "grounding.json"
    grounding.write_text(json.dumps(
        {k[2:]: {"timestamps": v["timestamps"], "duration": v["duration"]}
         for k, v in annos[0].items()}))
    vocab = build_vocabulary(s for anno in annos for v in anno.values()
                             for s in v["sentences"])
    words = list(vocab["word_to_ix"])
    words += [f"word{i}" for i in range(cfg["vocab_size"] - len(words))]
    (root / "vocab.json").write_text(json.dumps(
        {"word_to_ix": {x: i + 1 for i, x in enumerate(words)},
         "ix_to_word": {str(i + 1): x for i, x in enumerate(words)}}))
    data = dict(
        train_caption_file=str(paths["val_1"]),
        val_caption_file=str(paths["val_1"]),
        gt_file_for_eval=[str(paths["val_1"]), str(paths["val_2"])],
        gt_file_for_auc=str(paths["val_1"]),
        gt_file_for_para_eval=[str(paths["para_1"]), str(paths["para_2"])],
        eval_gt_file_for_grounding=str(grounding),
        dict_file=str(root / "vocab.json"),
        visual_feature_folder=([str(feat_dir)] if isinstance(vf_types, list)
                               else str(feat_dir)))
    return data, grounding, annos[0]


def write_cli_world(w: Workload, root: pathlib.Path, dev) -> tuple:
    """A run directory and its data (write_cli_data): an opts.json of the
    workload's cfg with only the data paths changed, and model-best.pth of
    the seeded model and text encoder. Returns (the run directory, the
    grounding GT path, the annotations)."""
    from gvl_tpu_torch.models.gvl import build_model
    from gvl_tpu_torch.train.checkpoint import CheckpointManager
    data, grounding, anno = write_cli_data(w, root)
    cfg = dict(w.cfg, **data)
    run = root / "save" / "run"
    run.mkdir(parents=True)
    (run / "opts.json").write_text(json.dumps(cfg))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    text = load_text(w, dev)
    model = build_model(types.SimpleNamespace(**cfg),
                        text_hidden_dim=text.hidden_size, device=dev,
                        generator=gen)
    CheckpointManager(str(run)).save("model-best", model, text, 1)
    return run, grounding, anno


def check_finite_json(what: str, node) -> int:
    """Every number in a JSON tree finite; returns how many there are."""
    if isinstance(node, dict):
        return sum(check_finite_json(what, v) for v in node.values())
    if isinstance(node, list):
        return sum(check_finite_json(what, v) for v in node)
    if isinstance(node, (int, float)) and not isinstance(node, bool):
        check(math.isfinite(node), f"{what}: non-finite number {node}")
        return 1
    return 0


def phase_eval_cli(w: Workload, dev) -> dict:
    """The eval CLI on the card: write the world (write_cli_world), run
    `gvl_tpu_torch.eval_cli.main` on it in this process, and check its
    launches, JSONs and scores; then EvalRunner.run directly on the same
    checkpoint and the port's Batcher, whose JSONs must equal the CLI's bit
    for bit. Returns the CLI run's launch counts."""
    from gvl_tpu_torch import eval_cli
    from gvl_tpu_torch.config import Config
    from gvl_tpu_torch.data.dataset import Batcher, DenseVideoDataset
    from gvl_tpu_torch.eval.evaluate import EvalRunner
    from gvl_tpu_torch.eval.metrics import meteor
    from gvl_tpu_torch.models.gvl import build_model
    from gvl_tpu_torch.train.checkpoint import CheckpointManager
    tag = w.tag + "evalcli"
    B = w.cfg["eval_batch_size"]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        run, grounding, anno = write_cli_world(w, pathlib.Path(tmp), dev)
        log(tag, f"world: {CLI_VIDEOS} videos, "
                 f"{sum(len(v['sentences']) for v in anno.values())} GT "
                 f"sentences, checkpoint "
                 f"{(run / 'model-best.pth').stat().st_size / 2**20:.1f} "
                 f"MiB; written in {time.perf_counter() - t0:.3f} s")
        argv = ["--eval_save_dir", str(run.parent), "--eval_folder", run.name,
                "--eval_batch_size", str(B),
                "--eval_gt_file_for_grounding", str(grounding)]
        reset_counts()
        t0 = time.perf_counter()
        res = eval_cli.main(argv)
        wall = time.perf_counter() - t0
        launches = read_counts()
        times, n_batches = res["times"], res["batches"]
        want = want_counts(w, n_batches, train=False)
        log(tag, f"eval_cli.main over {res['videos']} videos in {n_batches} "
                 f"batches of {B}: {wall:.3f} s; kernel launches {launches} "
                 f"(want {want})")
        check(n_batches == -(-CLI_VIDEOS // B) and launches == want,
              f"eval CLI launches {launches} in {n_batches} batches")
        dvc = run / "eval_model-best.json"
        outs = {"dvc": dvc, "reranked": pathlib.Path(res["dvc_json"]),
                "grounding": pathlib.Path(res["dvc_json"] + ".grounding.json"),
                "aux_grounding": pathlib.Path(
                    res["dvc_json"] + "_aux.grounding.json")}
        got = {k: json.loads(p.read_text()) for k, p in outs.items()}
        check(outs["reranked"] != dvc and len(got["dvc"]["results"])
              == len(got["reranked"]["results"]) == CLI_VIDEOS,
              "the DVC and reranked JSONs hold every video")
        n_num = check_finite_json("DVC JSON", got["dvc"])
        batches = [dict(keys=list(anno), captions_raw=[
            v["sentences"] for v in anno.values()],
            duration=np.array([v["duration"] for v in anno.values()]))]
        n_keys = check_grounding(tag, batches, got["grounding"],
                                 got["aux_grounding"])
        scores = json.loads((run / "eval_model-best_scores.json").read_text())
        approx = meteor.approximations()
        check(CLI_SCORE_KEYS <= set(scores)
              and scores.get("approx", []) == approx
              and all(math.isfinite(v) for k, v in scores.items()
                      if k != "approx"),
              f"scores JSON keys {sorted(scores)}")
        log(tag, f"DVC JSON: {n_num} numbers, all finite; grounding JSONs: "
                 f"{n_keys} keys, one per GT sentence; scores: "
                 + ", ".join(f"{k} {scores[k]!r}" for k in sorted(
                     CLI_SCORE_KEYS)) + f"; approx {approx}")
        # EvalRunner.run directly, on the same checkpoint and data
        cfg = Config().update(json.loads((run / "opts.json").read_text()))
        cfg.eval_batch_size = B
        cfg.eval_gt_file_for_grounding = str(grounding)
        payload = CheckpointManager(str(run)).restore_raw("model-best")
        text = load_text(w, dev)
        text.load_state_dict(payload["text_encoder"], strict=True)
        model = build_model(cfg, text_hidden_dim=text.hidden_size, device=dev)
        model.load_state_dict(payload["model"], strict=True)
        ds = DenseVideoDataset(cfg.val_caption_file, cfg.visual_feature_folder,
                               cfg.dict_file, False, cfg)
        direct = str(run / "direct.json")
        path, *_ = EvalRunner(cfg, model, ds.translator, text).run(
            Batcher(ds, cfg, B, shuffle=False), direct)
        for k, p in {"dvc": direct, "reranked": path,
                     "grounding": path + ".grounding.json",
                     "aux_grounding": path + "_aux.grounding.json"}.items():
            with open(p) as f:
                check(json.load(f) == got[k], f"the CLI's {k} JSON differs "
                                              "from EvalRunner.run's")
        # --eval_use_amp: the bf16 text pass and eval_decode_bf16, as the
        # JAX CLI maps it (eval.py:134-135)
        reset_counts()
        res_amp = eval_cli.main(argv + ["--eval_use_amp"])
        amp_launches = read_counts()
        amp = {"dvc": dvc, "reranked": pathlib.Path(res_amp["dvc_json"]),
               "grounding": pathlib.Path(res_amp["dvc_json"]
                                         + ".grounding.json")}
        amp = {k: json.loads(p.read_text()) for k, p in amp.items()}
        cfg.eval_use_amp = cfg.eval_decode_bf16 = True
        direct = str(run / "direct_amp.json")
        path, *_ = EvalRunner(cfg, model, ds.translator, text).run(
            Batcher(ds, cfg, B, shuffle=False), direct)
        n_diff = sum(a["sentence"] != b["sentence"] for v in got["dvc"][
            "results"] for a, b in zip(got["dvc"]["results"][v],
                                       amp["dvc"]["results"][v]))
        for k, p in {"dvc": direct, "reranked": path,
                     "grounding": path + ".grounding.json"}.items():
            with open(p) as f:
                check(json.load(f) == amp[k], f"--eval_use_amp: the CLI's {k}"
                                              " JSON differs from "
                                              "EvalRunner.run's")
        check(amp_launches == want, f"--eval_use_amp launches {amp_launches}")
        log(tag, f"--eval_use_amp: launches {amp_launches}; its DVC, "
                 f"reranked and grounding JSONs equal EvalRunner.run's under "
                 f"eval_use_amp + eval_decode_bf16 bit for bit; {n_diff} "
                 f"sentences differ from the f32 run's")
        del model, text
    evalled = sum(times[k] for k in CLI_STAGES if k != "metrics")
    log(tag, f"stage times, s ({card()}): "
             + ", ".join(f"{k} {times[k]!r}" for k in CLI_STAGES)
             + f"; the batcher {times['batcher']!r} of eval_run, "
               f"{times['batcher'] / n_batches * 1e3!r} ms a batch; "
               f"whole CLI {CLI_VIDEOS / sum(times[k] for k in CLI_STAGES)!r} "
               f"videos/s, {CLI_VIDEOS / evalled!r} without the metrics; its "
               "DVC, reranked and grounding JSONs equal EvalRunner.run's bit "
               "for bit")
    return launches


# --------------------------------------------------------- phases 17, 18
RESUME_EPOCHS = 3               # phase 17: the resumed run's --epoch
SCST_STEPS = 5                  # phase 18: debug's cap of one epoch
SCST_TOKEN_AGREEMENT = 0.99     # phase 18: sampled rollouts, both paths
SCST_LOGPROB_TOL = 1e-4
CLI_VAL_KEYS = {"METEOR", "soda_c", "grounding_R@1IOU0.5", "val_loss_total"}
BEST_CKPTS = ("model-last", "model-best", "model-best-dvc", "model-best-pc",
              "model-best-grounding")


class CallLog:
    """Wraps the train loop's parts for the phases' logs and checks: each
    train step (host clock from call to return, the device synchronised;
    its parts by the step's `tick` when `split`), each validation, each
    checkpoint save (time and file size), each eval batch, and under SCST
    each host reward (its inputs' valid slots, its rewards, its time) and
    load_pretrained's result. Nothing in the port is changed: the wrappers
    call through and are taken off again on exit."""

    def __init__(self, split: bool = False):
        self.split = split
        self.steps, self.splits, self.vals, self.saves = [], [], [], []
        self.rewards, self.pretrained, self.states = [], [], []
        self.step_at = []       # the state's update count as each step began
        self.eval_batches = 0
        self._undo = []

    def _patch(self, owner, name, make):
        orig = getattr(owner, name)
        setattr(owner, name, make(orig))
        self._undo.append((owner, name, orig))

    def __enter__(self):
        from gvl_tpu_torch.eval.evaluate import EvalRunner
        from gvl_tpu_torch.train import checkpoint, loop, rl, state
        log_ = self

        def make_step(orig):
            def make_train_step(*a, **k):
                step = orig(*a, **k)

                def timed(st, *sa, **sk):
                    log_.states.append(st)
                    log_.step_at.append(st.step)
                    marks = [("start", time.perf_counter())]
                    if log_.split:
                        def tick(name):
                            torch.cuda.synchronize()
                            marks.append((name, time.perf_counter()))
                        step.tick = tick
                    out = step(st, *sa, **sk)
                    torch.cuda.synchronize()
                    marks.append(("end", time.perf_counter()))
                    log_.steps.append(marks[-1][1] - marks[0][1])
                    log_.splits.append({n: t - marks[i][1] for i, (n, t) in
                                        enumerate(marks[1:])})
                    return out
                timed.forward_losses = step.forward_losses
                return timed
            return make_train_step

        def make_val(orig):
            def run_validation(*a, **k):
                t0 = time.perf_counter()
                out = orig(*a, **k)
                log_.vals.append(time.perf_counter() - t0)
                return out
            return run_validation

        def make_save(orig):
            def save(mgr, name, *a, **k):
                t0 = time.perf_counter()
                path = orig(mgr, name, *a, **k)
                log_.saves.append((name, time.perf_counter() - t0,
                                   os.path.getsize(path)))
                return path
            return save

        def make_eval_step(orig):
            def _eval_step(runner, *a, **k):
                log_.eval_batches += 1
                return orig(runner, *a, **k)
            return _eval_step

        def make_reward(orig):
            def rl_reward_callback(*a, **k):
                host_fn = orig(*a, **k)

                def timed(gen, greedy, gt, valid):
                    t0 = time.perf_counter()
                    r = host_fn(gen, greedy, gt, valid)
                    log_.rewards.append(dict(
                        seconds=time.perf_counter() - t0,
                        valid=int(valid.sum()), rewards=r[valid.astype(bool)],
                        slots=valid.size))
                    return r
                return timed
            return rl_reward_callback

        def make_pretrained(orig):
            def load_pretrained(model, *a, **k):
                keys = orig(model, *a, **k)
                log_.pretrained.append((keys, sorted(model.state_dict())))
                return keys
            return load_pretrained

        self._patch(state, "make_train_step", make_step)
        self._patch(loop, "run_validation", make_val)
        self._patch(checkpoint.CheckpointManager, "save", make_save)
        self._patch(EvalRunner, "_eval_step", make_eval_step)
        self._patch(rl, "rl_reward_callback", make_reward)
        self._patch(checkpoint, "load_pretrained", make_pretrained)
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)

    def summary(self) -> str:
        saves = [t for _, t, _ in self.saves]
        sizes = sorted({b for _, _, b in self.saves})
        return (f"step median {statistics.median(self.steps) * 1e3!r} ms "
                f"over {len(self.steps)} steps (first "
                f"{self.steps[0] * 1e3!r} ms); validations "
                f"{[round(v, 3) for v in self.vals]} s; {len(saves)} "
                f"checkpoint saves, median {statistics.median(saves)!r} s, "
                f"sizes {[round(b / 2**20, 1) for b in sizes]} MiB")


def write_run_yml(path: pathlib.Path, cfg: dict) -> pathlib.Path:
    """cfg as a yml for --cfg_path; base_cfg_path dropped, the chain is
    already merged."""
    import yaml
    path.write_text(yaml.safe_dump({k: v for k, v in cfg.items()
                                    if k != "base_cfg_path"}))
    return path


def train_cli_cfg(root: pathlib.Path, data: dict) -> dict:
    """Phase 17's cfg: the port's load_config of the flagship yml with the
    world's data paths, save_dir and CUTS['anet_train_cli']."""
    return dict(TRAIN_CLI, **data, save_dir=str(root / "save"))


def phase_train_cli(w: Workload, dev, root: pathlib.Path, data: dict,
                    grounding: pathlib.Path) -> tuple:
    """Phase 17, the train CLI on the card (see the docstring). Returns
    (the launch counts of the first run, the run directory)."""
    from gvl_tpu_torch import eval_cli, train_cli
    from gvl_tpu_torch.models.gvl import build_model
    from gvl_tpu_torch.models.text_encoder import load_text_encoder
    from gvl_tpu_torch.train.checkpoint import CheckpointManager
    from gvl_tpu_torch.train.state import StepStatics, create_train_state
    from gvl_tpu_torch.train.criterion import LossSpec
    tag = "traincli"
    cfg = train_cli_cfg(root, data)
    yml = write_run_yml(root / "anet_train_cli.yml", cfg)
    steps_per_epoch = CLI_VIDEOS // TRAIN_CLI_B
    val_batches = -(-CLI_VIDEOS // cfg["eval_batch_size"])
    reset_counts()
    t0 = time.perf_counter()
    with CallLog() as calls:
        run = pathlib.Path(train_cli.main(["--cfg_path", str(yml)]))
    wall = time.perf_counter() - t0
    launches = read_counts()
    n_steps = TRAIN_CLI_EPOCHS * steps_per_epoch
    want = {"fwd": 4 * (n_steps + TRAIN_CLI_EPOCHS * val_batches),
            "bwd": 4 * n_steps, "banded_fwd": 0, "banded_bwd": 0,
            "fwd_bf16": 0, "banded_fwd_bf16": 0}
    log(tag, f"train_cli.main: {TRAIN_CLI_EPOCHS} epochs of "
             f"{steps_per_epoch} steps at B={TRAIN_CLI_B}, "
             f"{calls.eval_batches} validation batches, {wall:.3f} s; "
             f"launches {launches} (want {want})")
    check(len(calls.steps) == n_steps and calls.eval_batches ==
          TRAIN_CLI_EPOCHS * val_batches and launches == want,
          f"train CLI: {len(calls.steps)} steps, {calls.eval_batches} val "
          f"batches, launches {launches}")
    info = json.loads((run / "info.json").read_text())
    check(info["epoch"] == TRAIN_CLI_EPOCHS - 1 and sorted(
        info["history"]["val_scores"]) == [str(e) for e in
                                           range(TRAIN_CLI_EPOCHS)],
          f"info.json epoch {info['epoch']}, val_scores "
          f"{sorted(info['history']['val_scores'])}")
    for e, scores in info["history"]["val_scores"].items():
        check(CLI_VAL_KEYS <= set(scores), f"epoch {e} scores "
                                           f"{sorted(scores)}")
    for e, losses in info["history"]["train_loss"].items():
        check(losses and all(math.isfinite(v) for v in losses.values()),
              f"epoch {e}: train losses {losses}")
    for name in BEST_CKPTS:
        check((run / f"{name}.pth").exists(), f"{name}.pth missing")
    epoch_s = [sum(calls.steps[e * steps_per_epoch:(e + 1) * steps_per_epoch])
               for e in range(TRAIN_CLI_EPOCHS)]
    log(tag, f"({card()}) {calls.summary()}; steps per epoch "
             f"{[round(s, 3) for s in epoch_s]} s; train losses by epoch "
             + json.dumps({e: round(v["total_loss"], 4) for e, v in
                           info["history"]["train_loss"].items()})
             + "; val scores by epoch " + json.dumps(
                 {e: {k: v[k] for k in sorted(CLI_VAL_KEYS)} for e, v in
                  info["history"]["val_scores"].items()}))

    # model-last back into a fresh train state: equal, bit for bit, to the
    # run's own state at its end and to the file
    live = calls.states[-1]
    mcfg = types.SimpleNamespace(**info["opt"])
    text = load_text_encoder(mcfg, device=dev)
    model = build_model(mcfg, text.hidden_size, device=dev)
    statics = StepStatics(
        spec=LossSpec.from_config(mcfg), enable_contrastive=True,
        caption_loss=True, two_stage=False, train_text_encoder=False,
        disable_mid_caption_heads=False, enable_pos_emb_for_captioner=False,
        temporal_shapes=w.shapes)
    fresh = create_train_state(mcfg, model, steps_per_epoch, statics, text)
    payload = CheckpointManager(str(run)).restore("model-last", fresh)

    def same(a, b) -> bool:
        if isinstance(a, torch.Tensor):
            return torch.equal(a.cpu(), b.cpu())
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(map(same, a, b))
        return a == b
    for what, a, b in (
            ("model", fresh.model.state_dict(), live.model.state_dict()),
            ("text encoder", fresh.text_encoder.state_dict(),
             live.text_encoder.state_dict()),
            ("optimizer", fresh.optimizer.state_dict(),
             live.optimizer.state_dict()),
            ("scheduler", fresh.scheduler.state_dict(),
             live.scheduler.state_dict()),
            ("file's optimizer", fresh.optimizer.state_dict(),
             payload["optimizer"])):
        check(same(a, b), f"restored {what} differs from the run's")
    check(fresh.step == live.step == n_steps and
          fresh.scheduler.last_epoch == n_steps and
          fresh.text_optimizer is None and payload["text_optimizer"] is None,
          f"restored step {fresh.step}, run's {live.step}")
    log(tag, f"model-last restored into a fresh train state: model, text "
             f"encoder, Adam state and schedule equal to the run's bit for "
             f"bit; step {fresh.step}, epoch {payload['epoch']}")
    del fresh, model, text, live, calls

    # resume: --epoch RESUME_EPOCHS, and a contrary --lr that the saved
    # opts override
    with CallLog() as calls:
        run2 = pathlib.Path(train_cli.main(
            ["--start_from", run.name, "--save_dir", str(run.parent),
             "--id", run.name, "--epoch", str(RESUME_EPOCHS), "--lr", "0.5"]))
    info2 = json.loads((run2 / "info.json").read_text())
    check(run2 == run and info2["epoch"] == RESUME_EPOCHS - 1
          and info2["opt"]["lr"] == cfg["lr"] and str(RESUME_EPOCHS - 1)
          in info2["history"]["val_scores"],
          f"resume: run dir {run2}, epoch {info2['epoch']}, lr "
          f"{info2['opt']['lr']}")
    check(calls.step_at[0] == n_steps, "the resumed run's first update "
                                       f"{calls.step_at[0]}")
    log(tag, f"resumed {run.name} to --epoch {RESUME_EPOCHS}: same run dir, "
             f"info.json at epoch {info2['epoch']}, lr {info2['opt']['lr']!r}"
             f" kept over --lr 0.5; {len(calls.steps)} more steps from "
             f"update {n_steps}; {calls.summary()}")
    del calls

    # the eval CLI on the trained model-best.pth
    res = eval_cli.main(["--eval_save_dir", str(run.parent), "--eval_folder",
                         run.name, "--eval_batch_size", str(w.eval_B),
                         "--eval_gt_file_for_grounding", str(grounding)])
    check(res["videos"] == CLI_VIDEOS and all(
        math.isfinite(v) for k, v in res["scores"].items() if k != "approx"),
          f"eval of the trained model: {res['videos']} videos")
    log(tag, f"eval_cli on the trained model-best: "
             + ", ".join(f"{k} {res['scores'][k]!r}" for k in sorted(
                 CLI_SCORE_KEYS)) + f"; stage times {res['times']!r}")
    return launches, run


def scst_cfg(root: pathlib.Path, data: dict, pretrained: pathlib.Path
             ) -> dict:
    """Phase 18's cfg: the port's load_config of the SCST yml with the
    world's data paths, save_dir, pretrain_path and CUTS['anet_scst']."""
    return dict(SCST, **data, save_dir=str(root / "save_rl"),
                pretrain_path=str(pretrained))


def scst_rollout(model, batch: dict, rate: int, seed: int, impl: str):
    """The sampled rollout of the fused SCST path on one batch (the trunk
    without dropout, the caption head in train mode), its generator and the
    dropout seeded with `seed`, with the dense op `impl`; the many-to-one
    matches of the kernel path are passed back in through batch['_rl']."""
    from gvl_tpu_torch.models.captioner import prepare_dsa_reference
    from gvl_tpu_torch.models.layers import set_msda_impl
    from gvl_tpu_torch.models.transformer import pyramid_shapes
    from gvl_tpu_torch.train.criterion import LossSpec, compute_criterion
    from gvl_tpu_torch.train.state import gather_matched
    a = model.arch
    dev = next(model.parameters()).device
    db = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()
          if isinstance(v, np.ndarray)}
    shapes = pyramid_shapes(db["video_feats"].shape[1], a.num_feature_levels)
    set_msda_impl(model, impl)
    try:
        model.eval()
        with torch.no_grad():
            out = model(db["video_feats"], db["video_mask"], db["duration"])
            if "_rl" not in batch:
                rl = []
                compute_criterion(out, db["gt_boxes"], db["gt_labels"],
                                  db["gt_mask"], None, LossSpec(),
                                  rl_m2o_rate=rate, rl_matches=rl)
                batch["_rl"] = rl
            rl = batch["_rl"]
            layers = range(a.dec_layers)
            query = torch.cat([gather_matched(out["hs"][l], rl[l][0])
                               for l in layers], 1)
            ref = torch.cat([prepare_dsa_reference(
                gather_matched(out["layer_refs"][l], rl[l][0]),
                out["valid_ratios"], shapes, a.cap_num_feature_levels,
                a.cap_dec_n_points) for l in layers], 1)
            valid = torch.cat([rl[l][1] for l in layers], 1)
            head = model.caption_head[a.dec_layers - 1]
            head.train()
            torch.manual_seed(seed)
            seq, lps = model.caption_sample(
                a.dec_layers - 1, query, ref, out["memory"],
                out["mask_flat"], shapes, out["valid_ratios"], greedy=False,
                generator=torch.Generator(device=dev).manual_seed(seed),
                ref_prepared=True)
    finally:
        set_msda_impl(model, "kernel")
        model.eval()
    return seq, lps, valid


def phase_scst(w: Workload, dev, root: pathlib.Path, data: dict,
               pretrained: pathlib.Path, caption_bf16: bool = False) -> dict:
    """Phase 18, SCST on the card (see the docstring); with caption_bf16
    the same run under train_caption_bf16 (the bf16 rollouts), without the
    paths' rollout comparison. Returns its launch counts and its step split
    and peak device memory."""
    from gvl_tpu_torch import train_cli
    from gvl_tpu_torch.models.gvl import build_model
    from gvl_tpu_torch.train.checkpoint import CheckpointManager
    tag = "scst_bf16" if caption_bf16 else "scst"
    cfg = scst_cfg(root, data, pretrained)
    if caption_bf16:
        cfg.update(train_caption_bf16=True, save_dir=str(root / "save_rl16"))
    yml = write_run_yml(root / f"{tag}.yml", cfg)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with CallLog(split=True) as calls:
        run = pathlib.Path(train_cli.main(["--cfg_path", str(yml)]))
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {"fwd": 4 * (SCST_STEPS + calls.eval_batches),
            "bwd": 4 * SCST_STEPS, "banded_fwd": 0, "banded_bwd": 0,
            "fwd_bf16": 0, "banded_fwd_bf16": 0}
    log(tag, f"train_cli.main on {yml.name}: {len(calls.steps)} steps, "
             f"{calls.eval_batches} validation batch(es), {wall:.3f} s; "
             f"launches {launches} (want {want})")
    check(len(calls.steps) == SCST_STEPS and launches == want,
          f"SCST: {len(calls.steps)} steps, launches {launches}")
    (keys, model_keys), = calls.pretrained
    check(keys == model_keys, f"load_pretrained('full') filled {len(keys)} "
                              f"of {len(model_keys)} model entries")
    info = json.loads((run / "info.json").read_text())
    losses = info["history"]["train_loss"]["0"]
    check(math.isfinite(losses["loss_caption"]) and
          math.isfinite(losses["loss_caption_0"]),
          f"SCST caption losses {losses}")
    rewards = np.concatenate([r["rewards"] for r in calls.rewards])
    check(len(calls.rewards) == SCST_STEPS and np.isfinite(rewards).all()
          and bool((rewards != 0).any()),
          f"{len(calls.rewards)} host rewards, all zero or non-finite")
    # only the caption head moved; the trunk, the other heads and the text
    # encoder are the pretrained run's, bit for bit
    src = CheckpointManager(str(pretrained)).restore_raw("model-best")
    out = CheckpointManager(str(run)).restore_raw("model-last")
    moved = {k for k in src["model"]
             if not torch.equal(src["model"][k], out["model"][k])}
    check(moved and all(k.startswith("caption_head.") for k in moved),
          f"moved outside the caption head: "
          f"{sorted(k for k in moved if not k.startswith('caption_head.'))}")
    check(all(torch.equal(v, out["text_encoder"][k])
              for k, v in src["text_encoder"].items()),
          "the frozen text encoder moved")
    split = {k: statistics.median(s[k] for s in calls.splits) * 1e3
             for k in calls.splits[0]}
    split_ms = json.dumps({k: round(v, 3) for k, v in split.items()})
    log(tag, f"({card()}) {calls.summary()}; step split, median ms "
             f"(device synchronised at each mark, the reward on the host "
             f"clock): {split_ms}"
             f"; host reward {[round(r['seconds'], 3) for r in calls.rewards]}"
             f" s over {[r['valid'] for r in calls.rewards]} valid of "
             f"{calls.rewards[0]['slots']} rollout slots per step; rewards "
             f"mean {float(rewards.mean())!r}, non-zero "
             f"{float((rewards != 0).mean())!r}; loss_caption "
             f"{losses['loss_caption']!r} (epoch mean); {len(moved)} "
             f"caption-head entries moved, nothing else; peak device memory "
             f"{peak / 2**30:.2f} GiB")
    if caption_bf16:
        return launches, dict(split=split, peak=peak)

    # one batch's sampled rollout on the kernel path and the plain path
    mcfg = types.SimpleNamespace(**info["opt"])
    text = load_text(w, dev)
    model = build_model(mcfg, text.hidden_size, device=dev)
    model.load_state_dict(out["model"], strict=True)
    batch = train_batch(w, SEED + 18)
    rate = int(cfg.get("rl_m2o_rate", 4))
    kseq, klps, valid = scst_rollout(model, batch, rate, SEED, "kernel")
    pseq, plps, _ = scst_rollout(model, batch, rate, SEED, "ref")
    v = valid.bool()
    agree = float((kseq == pseq)[v].float().mean())
    # the logprobs the policy loss reads (up to the first 0) where both
    # rollouts drew the same tokens so far
    read = torch.cat([torch.ones_like(kseq[..., :1]), (kseq > 0)[..., :-1]],
                     dim=-1).bool()
    shared = torch.cumprod((kseq == pseq).int(), dim=-1).bool()
    lp_err = float((klps - plps).abs()[shared & read & v[..., None]].max())
    log(tag, f"sampled rollout, kernel vs plain path, one batch (B="
             f"{w.train_B}, {int(v.sum())} valid slots of {v.numel()}): "
             f"tokens equal {agree!r}, logprobs on the shared prefixes max "
             f"abs diff {lp_err!r}")
    check(agree >= SCST_TOKEN_AGREEMENT, f"rollout tokens agree {agree}")
    check(lp_err <= SCST_LOGPROB_TOL, f"rollout logprobs differ {lp_err}")
    del model, text
    return launches, dict(split=split, peak=peak)


def phase_train_cli_and_scst(w: Workload, dev) -> dict:
    """Phases 17 and 18 in one world (phase 16's, written again), deleted
    at the end. Returns the launch counts of each path."""
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        t0 = time.perf_counter()
        data, grounding, _ = write_cli_data(w, root)
        log("traincli", f"world: {CLI_VIDEOS} videos in "
                        f"{time.perf_counter() - t0:.3f} s")
        launches = {}
        launches["anet_train_cli"], run = phase_train_cli(
            w, dev, root, data, grounding)
        torch.cuda.empty_cache()
        launches["anet_scst"], f32 = phase_scst(w, dev, root, data, run)
        torch.cuda.empty_cache()
        launches["anet_scst_bf16"], bf16 = phase_scst(w, dev, root, data,
                                                      run, caption_bf16=True)
        torch.cuda.empty_cache()
    log("scst_bf16", f"({card()}) step split, median ms, train_caption_bf16"
                     f" / f32: " + ", ".join(
                         f"{k} {bf16['split'][k]!r} / {f32['split'][k]!r}"
                         for k in f32["split"])
        + f"; peak device memory {bf16['peak'] / 2**30:.2f} / "
          f"{f32['peak'] / 2**30:.2f} GiB")
    return launches


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


def build_train(w: Workload, dev, text=None, gpt_spec=None):
    """The model on the card with seeded weights, its train state and step
    (with the text side on: the text encoder, frozen or trained as the
    config's text_encoder_learning_strategy says; `text`, when given, is a
    seeded one already built), the loss weights (the contrastive weight the
    schedule gives at CL_EPOCH) and two seeded batches. The caption loss,
    train_caption_bf16 and the gpt2 head follow the config; the gpt2 head's
    spec is `gpt_spec`, by default the offline one, and its batches carry
    the captions hashed into its vocabulary (gpt_tokens, gpt_mask)."""
    from gvl_tpu_torch.models.gvl import build_model
    from gvl_tpu_torch.train.criterion import (LossSpec, cl_weight_at_epoch,
                                               make_weight_dict)
    from gvl_tpu_torch.train.state import (StepStatics, create_train_state,
                                           make_train_step)
    cfg = types.SimpleNamespace(**w.cfg)
    torch.manual_seed(SEED)               # the dropout draws
    gen = torch.Generator(device=dev).manual_seed(SEED)
    text = text if text is not None else load_text(w, dev)
    model = build_model(cfg, text_hidden_dim=text.hidden_size if text
                        else 768, generator=gen,
                        gpt_spec=gpt_spec)        # no device: the card
    check(next(model.parameters()).device == dev, "build_model's default "
          f"device is {next(model.parameters()).device}, not {dev}")
    two_stage = cfg.transformer_input_type == "gt_proposals"
    statics = StepStatics(
        spec=LossSpec.from_config(cfg), enable_contrastive=w.contrastive,
        caption_loss=cfg.caption_loss_coef > 0, two_stage=two_stage,
        caption_cost=cfg.set_cost_caption > 0 and not two_stage,
        train_text_encoder=w.trains_text, disable_mid_caption_heads=False,
        enable_pos_emb_for_captioner=False, temporal_shapes=w.shapes,
        text_bf16=bool(getattr(cfg, "train_use_amp", False)),
        caption_bf16=bool(getattr(cfg, "train_caption_bf16", False)),
        caption_gpt=cfg.caption_decoder_type == "gpt2")
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
    if two_stage:
        # the GT segments are the queries: no class or box loss (the train
        # loop's rule, gvl_tpu_torch/train/loop.py)
        for k in weights:
            if k.startswith(("loss_ce", "loss_bbox", "loss_giou")):
                weights[k] = 0.0
    batches = [train_batch(w, SEED, text), train_batch(w, SEED + 1, text)]
    if statics.caption_gpt:
        vocab = model.caption_head[0].spec.vocab_size
        for b in batches:
            add_gpt_tokens(b, w, vocab)
    return model, state, step, weights, batches


def add_gpt_tokens(batch: dict, w: Workload, vocab: int) -> dict:
    """The gpt2 head's gpt_tokens and gpt_mask (B, G, max_caption_len): the
    batch's sentences hashed into `vocab` ids, as the train loop's
    make_gpt_tokenize does for the offline spec's 1000."""
    from gvl_tpu_torch.models.text_encoder import (HashTokenizer,
                                                   _batch_tokenize)
    batch["gpt_tokens"], batch["gpt_mask"] = _batch_tokenize(
        HashTokenizer(vocab), batch["captions_raw"], w.max_gt,
        w.cfg["max_caption_len"])
    return batch


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
                            text=None, spread: dict = None) -> None:
    """With a text encoder that trains (text), its named gradients too.
    With `spread` (name -> the plain path's own difference between the card
    and the CPU, over the tensor's max abs; `plain_spread`), a gradient is
    held to SPREAD_FACTOR times that where it exceeds GRAD_TOL."""
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
    by_spread = {}
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
        tol = GRAD_TOL
        if spread and err > GRAD_TOL * scale + GRAD_FLOOR:
            tol = max(tol, SPREAD_FACTOR * spread[n])
            by_spread[n] = (err / scale, spread[n])
        check(err <= tol * scale + GRAD_FLOOR,
              f"{n}: kernel vs plain path gradient {err} > {tol} x "
              f"{scale} + {GRAD_FLOOR}")
    log(tag, f"{len(pg)} named gradients: worst max abs diff / own max "
             f"abs {worst!r} ({worst_name})")
    if by_spread:
        log(tag, f"held to {SPREAD_FACTOR} x the plain path's own card vs "
                 f"CPU difference (kernel vs plain, plain card vs CPU, over "
                 f"max abs): {by_spread!r}")
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
            "banded_fwd": 0, "banded_bwd": 0, "fwd_bf16": 0,
            "banded_fwd_bf16": 0}
    log("lvref", f"long-video model, msda_impl='ref', S={sum(LONG.shapes)}: "
                 f"one forward launched {got} (want {want}); memory finite "
                 f"{bool(torch.isfinite(out['memory']).all())}")
    check(got == want and bool(torch.isfinite(out["memory"]).all()),
          f"msda_impl='ref' route: launches {got}")
    reset_counts()


# ---------------------------------------------------------------- phase 19
# (loc, attn) dtypes of the bf16-tap forms; the first is what the path gives
# them (eval_full_bf16: the decoder's attn is bf16, its loc f32)
TAP_DTYPES = (("float32", "bfloat16"), ("bfloat16", "bfloat16"),
              ("bfloat16", "float32"))
# a token pyramid whose every T and T - 1 is a bf16 value, for a bf16 loc
# into kernel 3 (the long-video levels, 800 and 400, are not: refused)
BF16_LOC_SHAPES = (256, 128, 64, 32)


def cast_taps(loc, attn, dts):
    return (loc.to(getattr(torch, dts[0])).contiguous(),
            attn.to(getattr(torch, dts[1])).contiguous())


def phase_bf16_taps_vs_plain(dev) -> dict:
    """Kernels 1 and 3 in their bf16-tap form against their plain version
    on the same bf16 inputs (the JAX rule in both, ops/ms_deform_attn.py):
    kernel 1 at the flagship encoder and decoder shapes and the long-video
    decoder, every tap class, every (loc, attn) dtype pair whose levels a
    bf16 loc allows; kernel 3 at the long-video encoder (B=8, f32 loc, bf16
    attn) and at BF16_LOC_SHAPES (every pair); max abs error <= 1e-5. A bf16
    loc over the long-video levels is refused. Device medians of the path's
    form (f32 loc, bf16 attn) beside the f32 form on the same weights
    widened, the plain version and embedding_bag."""
    from gvl_tpu_torch.ops import (ms_deform_attn_1d_banded_cuda,
                                   ms_deform_attn_1d_banded_ref,
                                   ms_deform_attn_1d_cuda,
                                   ms_deform_attn_1d_ref, prep_taps)
    from gvl_tpu_torch.ops.ms_deform_attn_banded import banded_rows
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    worst = {"fwd_bf16": 0.0, "banded_fwd_bf16": 0.0}
    for label in ("encoder", "decoder", "longvideo_decoder"):
        shapes, B, _, Lq = DENSE_CASES[label]
        for kind in DENSE_KINDS:
            value, loc, attn = msda_inputs(kind, shapes, B, Lq, gen, dev)
            for dts in TAP_DTYPES:
                if dts[0] == "bfloat16" and shapes == LONG.shapes:
                    continue
                lc, at = cast_taps(loc, attn, dts)
                worst["fwd_bf16"] = max(worst["fwd_bf16"], check_forward(
                    f"bf16taps {label} B={B} Lq={Lq} {kind} loc {dts[0]} "
                    f"attn {dts[1]}",
                    ms_deform_attn_1d_cuda(value, shapes, lc, at),
                    ms_deform_attn_1d_ref(value, shapes, lc, at)))
    value, loc, attn = msda_inputs("normal", LONG.shapes, 1, 100, gen, dev)
    try:
        ms_deform_attn_1d_cuda(value, LONG.shapes, loc.bfloat16(), attn)
        refused = ""
    except ValueError as e:
        refused = str(e)
    log("bf16taps", f"bf16 loc over the levels {LONG.shapes}: {refused!r}")
    check("bfloat16" in refused, "a bf16 loc over levels that round")
    for shapes, pairs in ((LONG.shapes, TAP_DTYPES[:1]),
                          (BF16_LOC_SHAPES, TAP_DTYPES)):
        for kind in ("local", "wide", "border", "pile"):
            value, loc, attn = banded_inputs(kind, LONG.eval_B, gen, dev,
                                             shapes)
            for dts in pairs:
                lc, at = cast_taps(loc, attn, dts)
                worst["banded_fwd_bf16"] = max(
                    worst["banded_fwd_bf16"], check_forward(
                        f"bf16taps banded B={LONG.eval_B} S={sum(shapes)} "
                        f"{kind} loc {dts[0]} attn {dts[1]}",
                        ms_deform_attn_1d_banded_cuda(value, shapes, lc, at,
                                                      LV_MARGIN),
                        ms_deform_attn_1d_banded_ref(value, shapes, lc, at,
                                                     LV_MARGIN)))
    times = {"fwd_bf16": {}, "banded_fwd_bf16": {}}
    for label in ("decoder", "encoder"):
        shapes, B, _, Lq = DENSE_CASES[label]
        value, loc, attn = msda_inputs("normal", shapes, B, Lq, gen, dev)
        a16 = attn.bfloat16()
        a32 = a16.float()
        tm = dict(
            B=B, S=sum(shapes), Lq=Lq,
            ms=device_median_ms(lambda: ms_deform_attn_1d_cuda(
                value, shapes, loc, a16), 50),
            f32_form_ms=device_median_ms(lambda: ms_deform_attn_1d_cuda(
                value, shapes, loc, a32), 50),
            plain_ms=device_median_ms(lambda: ms_deform_attn_1d_ref(
                value, shapes, loc, a16), 50),
            library_ms=device_median_ms(library_fwd(
                value, *prep_taps(shapes, loc, a16)), 50))
        times["fwd_bf16"][label] = tm
        log("bf16taps", f"kernel 1, bf16 attn, {label} B={B} Lq={Lq}: "
                        f"{tm['ms']!r} ms on the device, its f32 form "
                        f"{tm['f32_form_ms']!r}, plain {tm['plain_ms']!r}, "
                        f"embedding_bag {tm['library_ms']!r} (medians of 50)")
    shapes = LONG.shapes
    value, loc, attn = banded_inputs("local", LONG.eval_B, gen, dev)
    a16 = attn.bfloat16()
    a32 = a16.float()
    g0, g1, w0, w1 = prep_taps(shapes, loc, a16)
    tm = dict(
        B=LONG.eval_B, S=sum(shapes), Lq=sum(shapes),
        ms=device_median_ms(lambda: ms_deform_attn_1d_banded_cuda(
            value, shapes, loc, a16, LV_MARGIN), 50),
        f32_form_ms=device_median_ms(lambda: ms_deform_attn_1d_banded_cuda(
            value, shapes, loc, a32, LV_MARGIN), 50),
        plain_ms=device_median_ms(lambda: ms_deform_attn_1d_banded_ref(
            value, shapes, loc, a16, LV_MARGIN), 20),
        library_ms=device_median_ms(library_fwd(
            value, *banded_rows(shapes, g0, g1, LV_MARGIN), w0, w1), 50))
    times["banded_fwd_bf16"]["longvideo"] = tm
    log("bf16taps", f"kernel 3, bf16 attn, long video B={LONG.eval_B}: "
                    f"{tm['ms']!r} ms on the device, its f32 form "
                    f"{tm['f32_form_ms']!r}, plain {tm['plain_ms']!r}, "
                    f"embedding_bag {tm['library_ms']!r} (medians of 50 / 50"
                    f" / 20 / 50)")
    return {k: dict(max_abs_err=worst[k], times=times[k]) for k in worst}


def bf16_row(name, source, replaces, launches, kv, banded) -> dict:
    """A bf16-tap form's entry: the required keys at the shape its path
    gives it (kernel 1: the flagship decoder under eval_full_bf16), the
    bound with a 2-byte attn, the f32 form's time on the same weights
    (f32_form_ms)."""
    by_shape = {}
    for label, tm in kv["times"].items():
        bd = msda_bound(tm["B"], tm["S"], tm["Lq"], "fwd", attn_bytes=2)
        by_shape[label] = dict(tm, bound_ms=bd["bound_ms"],
                               bound_by=bd["bound_by"], bytes=bd["bytes"],
                               flops=bd["flops"])
        log("bound", f"{name} {label}: {bd['bytes']} bytes, {bd['flops']} "
                     f"flop -> {bd['bound_ms']!r} ms, bound by "
                     f"{bd['bound_by']}; kernel {tm['ms']!r} ms")
    main = by_shape["longvideo" if banded else "decoder"]
    row = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": sum(launches.values()), "max_abs_err": kv["max_abs_err"],
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"], "f32_form_ms": main["f32_form_ms"],
        "taps": "f32 loc, bf16 attn", "launches_by_path": launches,
        "by_shape": by_shape,
        "shape": (f"long-video encoder B={LONG.eval_B} S=1500 Lq=1500 "
                  f"margin={LV_MARGIN}" if banded else
                  "flagship decoder B=16 S=188 Lq=30") + " H=8 Dh=64 K=16"}
    if banded:
        row["on_a_path"] = ("none: under eval_full_bf16 the encoder's "
                            "queries add the f32 position encodings, so "
                            "JAX's rule gives kernel 3 f32 loc and attn")
    return row


# ---------------------------------------------------------------- phase 20
EVAL_OPTIONS = {"decode_bf16": dict(eval_decode_bf16=True),
                "full_bf16": dict(eval_full_bf16=True),
                "beam3": dict(eval_beam_size=3),
                "early_exit": dict(eval_decode_early_exit=True)}
# kernel path vs plain path under a bf16 option: the paths' f32 sums differ
# in their last bits, which moves a few bf16 roundings by an ulp (2^-8
# relative): the bf16 trunk's outputs by that much, and the tokens of the
# random model where two logits nearly tie (decode_bf16: 98.98% equal on an
# NVIDIA H100 80GB HBM3 at 700 W)
FULL_BF16_TOL, BF16_TOKENS = 5e-2, 0.95
N_OPT_ROUNDS, N_OPT_WINDOW = 3, 5


def counting_decode(steps: list):
    """Context: every decode_loop call appends its number of steps."""
    from gvl_tpu_torch.models import captioner
    real = captioner.decode_loop

    def counting(step, *args, **kwargs):
        n = [0]

        def counted(it, t):
            n[0] += 1
            return step(it, t)
        out = real(counted, *args, **kwargs)
        steps.append(n[0])
        return out

    class Ctx:
        def __enter__(self):
            captioner.decode_loop = counting

        def __exit__(self, *exc):
            captioner.decode_loop = real
    return Ctx()


def option_launches(w: Workload, name: str, n: int) -> dict:
    """The launches of n eval batches under a decode option: the f32 path's,
    but under eval_full_bf16 the decoder's attn is bf16 (kernel 1's bf16-tap
    form) and the encoder's taps f32."""
    want = want_counts(w, n, train=False)
    if name == "full_bf16":
        want["fwd_bf16"] = w.cfg["dec_layers"] * n
        want["fwd"] -= want["fwd_bf16"]
    return want


def phase_eval_options(w: Workload, model, text) -> dict:
    """The flagship eval under each of EVAL_OPTIONS (see the docstring).
    Returns the launch counts of each option's run."""
    from gvl_tpu_torch.eval.evaluate import EvalRunner
    from gvl_tpu_torch.models.layers import set_msda_impl
    tag = w.tag + "opts"
    batches = list(synthetic_batches(w, N_BATCHES, SEED))
    one = next(synthetic_batches(w, 1, SEED + 2, long_video=False))
    base = EvalRunner(types.SimpleNamespace(**w.cfg), model, WordTranslator(),
                      text)
    launches = {}
    for name, opt in EVAL_OPTIONS.items():
        runner = EvalRunner(types.SimpleNamespace(**dict(w.cfg, **opt)),
                            model, WordTranslator(), text)
        steps = []
        with tempfile.TemporaryDirectory() as tmp, counting_decode(steps):
            reset_counts()
            _, out_json, g_json, aux_json, losses = runner.run(
                batches, f"{tmp}/dvc.json")
            torch.cuda.synchronize()
            got = read_counts()
        launches[f"{w.name}_{name}"] = got
        want = option_launches(w, name, N_BATCHES)
        n_num = check_finite_json(f"{name} DVC JSON", out_json)
        n_keys = check_grounding(tag, batches, g_json, aux_json)
        check(got == want and len(out_json["results"]) ==
              N_BATCHES * w.eval_B, f"{name}: launches {got}, want {want}")
        log(tag, f"{name}: EvalRunner.run over {N_BATCHES} batches: "
                 f"launches {got}; decode steps per batch {steps}; DVC JSON "
                 f"{n_num} numbers, all finite; {n_keys} grounding keys")
        # kernel path vs plain path, one batch, both under the option
        _, _, arrs = runner._prepare(one)
        res = {}
        with torch.inference_mode():
            for impl in ("kernel", "ref"):
                set_msda_impl(model, impl)
                r, aux = runner._eval_step(arrs)
                res[impl] = runner._to_host((r, aux))
        set_msda_impl(model, "kernel")
        (kr, ka), (pr, pa) = res["kernel"], res["ref"]
        tokens = float((kr["seq"] == pr["seq"]).mean())
        full = name == "full_bf16"
        errs = {}
        for key in ("pred_logits", "pred_boxes", "memory", "event_embed"):
            scale = float(np.abs(pa[key]).max())
            errs[key] = float(np.abs(ka[key] - pa[key]).max())
            check(np.isfinite(ka[key]).all() and errs[key] <= (
                FULL_BF16_TOL * scale if full else TRUNK_TOL),
                f"{name}: {key} kernel vs plain path {errs[key]} (max abs "
                f"{scale})")
        check(tokens >= (BF16_TOKENS if "bf16" in name else TOKEN_AGREEMENT),
              f"{name}: tokens agree {tokens}")
        log(tag, f"{name}: kernel vs plain path, one batch: trunk max abs "
                 f"diffs {json.dumps(errs)}; tokens equal {tokens!r}")
        time_against_f32(tag, w, name, runner, base, one)
        if name == "early_exit":
            # the stop read every 5 steps instead of every step
            from gvl_tpu_torch.models import captioner
            every = captioner.EXIT_CHECK_EVERY
            captioner.EXIT_CHECK_EVERY = 5
            try:
                time_against_f32(tag, w, "early_exit, the stop read every 5 "
                                 "steps", runner, base, one)
            finally:
                captioner.EXIT_CHECK_EVERY = every
    return launches


def time_against_f32(tag, w, name, runner, base, one) -> None:
    """The eval step of `runner` against the f32 greedy step of `base`, in
    turns: N_OPT_ROUNDS windows of N_OPT_WINDOW steps each."""
    win = {name: [], "f32": []}

    def window(r):
        for _ in range(N_OPT_WINDOW):
            r._to_host(r._eval_step(r._prepare(one)[2])[0])

    with torch.inference_mode():
        for r in (runner, base):
            cuda_median_ms(lambda: window(r), 1, warmup=1)
        for i in range(N_OPT_ROUNDS):
            pair = ((name, runner), ("f32", base))
            for key, r in (pair[::-1] if i % 2 else pair):
                win[key].append(cuda_median_ms(lambda: window(r), 1,
                                               warmup=0) / N_OPT_WINDOW)
    med = {k: statistics.median(v) for k, v in win.items()}
    log(tag, f"({card()}) {name}: eval step B={w.eval_B} {med[name]!r} "
             f"ms, the f32 greedy step {med['f32']!r} ms (medians of "
             f"{N_OPT_ROUNDS} windows of {N_OPT_WINDOW} steps each, in "
             f"turns; windows {win[name]!r} / {win['f32']!r})")


def phase_longvideo_full_bf16(w: Workload, model, text) -> dict:
    """The long-video eval once under eval_full_bf16: the encoder's taps are
    f32 (kernel 3's f32 form), the decoder's attn bf16 (kernel 1's bf16-tap
    form); finite JSONs."""
    from gvl_tpu_torch.eval.evaluate import EvalRunner
    tag = w.tag + "fullbf16"
    runner = EvalRunner(types.SimpleNamespace(**dict(w.cfg,
                                                     eval_full_bf16=True)),
                        model, WordTranslator(), text)
    batches = list(synthetic_batches(w, 1, SEED))
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        _, out_json, g_json, aux_json, _ = runner.run(batches,
                                                      f"{tmp}/dvc.json")
        torch.cuda.synchronize()
        got = read_counts()
    want = want_counts(w, 1, train=False)
    want["fwd_bf16"], want["fwd"] = want["fwd"], 0
    n_num = check_finite_json("long-video full-bf16 DVC JSON", out_json)
    check_grounding(tag, batches, g_json, aux_json)
    log(tag, f"EvalRunner.run under eval_full_bf16, one batch of "
             f"{w.eval_B}: launches {got} (want {want}: the banded kernel's "
             f"f32 form, kernel 1's bf16-tap form); DVC JSON {n_num} "
             f"numbers, all finite")
    check(got == want, f"long-video full bf16 launches {got}")
    return got


# ---------------------------------------------------------------- phase 21
HEADS = ("light", "transformer", "none")
N_HEAD_STEPS = 3


def head_workload(name: str, **kw) -> Workload:
    """The flagship with `kw` over its cfg (the caption head, a head
    layout, train_caption_bf16)."""
    return dataclasses.replace(ANET, name=f"anet_{name}", tag=name,
                               cfg=dict(FLAGSHIP, **kw))


def head_cfg(head: str) -> dict:
    kw = dict(caption_decoder_type=head)
    if head == "none":          # config.py:440-442: localization only
        kw.update(caption_loss_coef=0.0, set_cost_caption=0.0)
    return kw


def record_lq() -> tuple:
    """Wrap the dense kernels' wrappers to record the Lq of every launch;
    returns (lists of forward and backward Lq, a function that unwraps)."""
    import gvl_tpu_torch.ops.ms_deform_attn as msda
    fwd_lq, bwd_lq = [], []
    real_f, real_b = msda.ms_deform_attn_1d_cuda, msda.ms_deform_attn_1d_bwd_cuda

    def f(value, shapes, loc, attn):
        fwd_lq.append(loc.shape[1])
        return real_f(value, shapes, loc, attn)

    def b(grad_out, value, shapes, loc, attn, **kw):
        bwd_lq.append(loc.shape[1])
        return real_b(grad_out, value, shapes, loc, attn, **kw)

    msda.ms_deform_attn_1d_cuda, msda.ms_deform_attn_1d_bwd_cuda = f, b

    def undo():
        msda.ms_deform_attn_1d_cuda = real_f
        msda.ms_deform_attn_1d_bwd_cuda = real_b
    return fwd_lq, bwd_lq, undo


def train_steps_timed(tag, w, state, step, weights, batches, n) -> dict:
    """n train steps, each between CUDA events after the launches of the
    first; their times, the peak device memory and the launches of one
    step."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, per_step = [], None
    for i in range(n):
        reset_counts()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        losses = {k: float(v) for k, v in
                  step(state, batches[i % 2], weights).items()}
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
        check(all(math.isfinite(v) for v in losses.values()),
              f"{tag}: step {i} losses {losses}")
        per_step = per_step or read_counts()
    peak = torch.cuda.max_memory_allocated()
    return dict(times=times, peak=peak, per_step=per_step, losses=losses)


def phase_heads(dev, text) -> dict:
    """The light, transformer and none heads at the flagship's widths (see
    the docstring). Returns the launch counts of each eval run and of one
    train step."""
    from gvl_tpu_torch.eval.evaluate import EvalRunner
    from gvl_tpu_torch.models.gvl import build_model
    launches = {}
    for head in HEADS:
        w = head_workload(head, **head_cfg(head))
        tag = w.tag + "head"
        cfg = types.SimpleNamespace(**w.cfg)
        model = build_model(cfg, text.hidden_size, device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(SEED))
        runner = EvalRunner(cfg, model, WordTranslator(), text)
        batches = list(synthetic_batches(w, N_BATCHES, SEED))
        Lc, cap_layers = cfg.max_caption_len, int(cfg.num_layers)
        fwd_lq, bwd_lq, undo = record_lq()
        try:
            with tempfile.TemporaryDirectory() as tmp:
                reset_counts()
                t0 = time.perf_counter()
                _, out_json, g_json, aux_json, _ = runner.run(
                    batches, f"{tmp}/dvc.json")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                got = read_counts()
        finally:
            undo()
        want = want_counts(w, N_BATCHES, train=False)
        if head == "transformer":       # one cross-attention a layer a step
            want["fwd"] += N_BATCHES * Lc * cap_layers
        launches[f"{w.name}_eval"] = got
        n_num = check_finite_json(f"{head} DVC JSON", out_json)
        check_grounding(tag, batches, g_json, aux_json)
        n_sent = sum(bool(it["sentence"]) for v in out_json["results"].values()
                     for it in v)
        check(got == want and (n_sent > 0) == (head != "none"),
              f"{head} eval: launches {got} (want {want}), {n_sent} "
              f"sentences")
        log(tag, f"{head} head, EvalRunner.run over {N_BATCHES} batches: "
                 f"{wall:.3f} s; launches {got}, decode Lq "
                 f"{sorted(set(fwd_lq))}; {n_num} finite numbers, {n_sent} "
                 f"predictions with a sentence")
        del runner, model
        tmodel, state, step, weights, tb = build_train(w, dev, text)
        phase_train_paths_agree(w, tmodel, step, weights, tb[0], None)
        fwd_lq, bwd_lq, undo = record_lq()
        try:
            res = train_steps_timed(tag, w, state, step, weights, tb,
                                    N_HEAD_STEPS)
        finally:
            undo()
        want = want_counts(w, 1, train=True)
        G = w.max_gt
        if head == "transformer":      # teacher forcing over G*Lc tokens
            extra = cfg.dec_layers * cap_layers
            want["fwd"] += extra
            want["bwd"] += extra
            check(G * Lc in fwd_lq and G * Lc in bwd_lq,
                  f"transformer teacher forcing Lq {sorted(set(fwd_lq))} / "
                  f"{sorted(set(bwd_lq))}, want {G * Lc}")
        launches[f"{w.name}_train"] = res["per_step"]
        check(res["per_step"] == want,
              f"{head} train step launches {res['per_step']}, want {want}")
        log(tag, f"({card()}) {head} head, {N_HEAD_STEPS} train steps at "
                 f"B={w.train_B}: {res['times']!r} ms (CUDA events), "
                 f"median {statistics.median(res['times'])!r}; peak device "
                 f"memory {res['peak'] / 2**30:.3f} GiB; launches per step "
                 f"{res['per_step']}, forward Lq {sorted(set(fwd_lq))}, "
                 f"backward Lq {sorted(set(bwd_lq))}; last losses: total "
                 f"{res['losses']['total_loss']!r}, caption "
                 f"{res['losses'].get('loss_caption')!r}")
        del tmodel, state, step
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 22
LAYOUTS = {"mlp": dict(support_mlp_class_head=1),
           "shared": dict(with_box_refine=0)}


def phase_head_layouts(dev, text) -> dict:
    """MLP class heads and the heads shared across decoder layers
    (with_box_refine=0): phase 10's kernel vs plain path check and one
    train step with its launches. Returns the step's launch counts."""
    launches = {}
    for name, kw in LAYOUTS.items():
        w = head_workload(name, **kw)
        model, state, step, weights, batches = build_train(w, dev, text)
        if name == "shared":
            check(model.class_head[0] is model.class_head[1]
                  and model.bbox_head[0] is model.bbox_head[1],
                  "with_box_refine=0: one head module for every layer")
        else:
            check(len(model.class_head[0].layers) == 3, "3-layer MLP heads")
        phase_train_paths_agree(w, model, step, weights, batches[0], None)
        res = train_steps_timed(w.tag + "layout", w, state, step, weights,
                                batches, 1)
        want = want_counts(w, 1, train=True)
        check(res["per_step"] == want,
              f"{name}: launches {res['per_step']}, want {want}")
        launches[f"{w.name}_train"] = res["per_step"]
        log(w.tag + "layout", f"{name}: one train step {res['times']!r} ms,"
                              f" launches {res['per_step']}, total loss "
                              f"{res['losses']['total_loss']!r}")
        del model, state, step
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 23
def phase_caption_bf16_train(dev, text, f32: dict) -> dict:
    """train_caption_bf16 on the flagship train step: phase 9's checks over
    its 5 steps, then phase 11's time, split and peak memory, beside phase
    11's f32 numbers (`f32`). Returns the launch counts."""
    w = head_workload("cap_bf16", train_caption_bf16=True)
    model, state, step, weights, batches = build_train(w, dev, text)
    launches = phase_train_main_path(w, model, state, step, weights, batches)
    res = phase_train_time(w, state, step, weights, batches)
    log(w.tag + "ttime", f"({card()}) train_caption_bf16: step "
                         f"{res['step_ms']!r} ms, peak "
                         f"{res['peak'] / 2**30!r} GiB; f32 (phase 11): "
                         f"{f32['step_ms']!r} ms, {f32['peak'] / 2**30!r} "
                         f"GiB")
    del model, state, step
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 24
def free_device_memory() -> None:
    """Collect the reference cycles that keep a deleted model alive (a
    train step's closures refer to one another) and return the cached
    blocks, so that the next peak counts only what is live then."""
    gc.collect()
    torch.cuda.empty_cache()


N_GPT_STEPS = 3                 # train steps of the offline gpt2 head
N_GPT_ROUNDS, N_GPT_WINDOW = 2, 3
SPREAD_FACTOR = 2.0             # phase 24's gradients, see plain_spread
GPT_SCORE_TOL = 1e-4            # cap_scores, kernel vs plain path


def json_diff(a, b, path="$") -> float:
    """The largest difference between two JSON trees' numbers; raises where
    their structure or any string differs."""
    if isinstance(a, dict):
        check(isinstance(b, dict) and a.keys() == b.keys(), f"{path} keys")
        return max([json_diff(a[k], b[k], f"{path}.{k}") for k in a] or [0.0])
    if isinstance(a, list):
        check(isinstance(b, list) and len(a) == len(b), f"{path} length")
        return max([json_diff(x, y, f"{path}[{i}]")
                    for i, (x, y) in enumerate(zip(a, b))] or [0.0])
    if isinstance(a, float) or isinstance(b, float):
        return abs(float(a) - float(b))
    check(a == b, f"{path}: {a!r} != {b!r}")
    return 0.0


def plain_spread(w: Workload, model, batch, weights, text) -> dict:
    """The plain path's gradients on the card against the same computation
    on the CPU (the same weights and batch, dropout off): name -> max abs
    difference over the card's max abs. A trunk gradient the gpt2 head's
    loss reaches differs so by up to 5.9e-3 (NVIDIA H100 80GB HBM3, 700 W):
    a sum of terms that cancel, summed in another order."""
    import copy
    from gvl_tpu_torch.models.layers import set_msda_impl
    from gvl_tpu_torch.train.criterion import LossSpec
    from gvl_tpu_torch.train.state import StepStatics, make_train_step
    cfg = types.SimpleNamespace(**w.cfg)
    grads = {}
    for where, m, t in (("card", model, text),
                        ("cpu", copy.deepcopy(model).cpu(),
                         copy.deepcopy(text).cpu())):
        statics = StepStatics(
            spec=LossSpec.from_config(cfg), enable_contrastive=True,
            caption_loss=True, two_stage=False, train_text_encoder=False,
            disable_mid_caption_heads=False,
            enable_pos_emb_for_captioner=False, temporal_shapes=w.shapes,
            caption_gpt=cfg.caption_decoder_type == "gpt2")
        step = make_train_step(m, cfg, statics, t)
        m.eval()
        set_msda_impl(m, "ref")
        m.zero_grad(set_to_none=True)
        losses = step.forward_losses(batch)
        sum(losses[k] * weights[k] for k in losses if k in weights).backward()
        grads[where] = {n: p.grad.detach().cpu()
                        for n, p in m.named_parameters()}
        set_msda_impl(m, "kernel")
        m.zero_grad(set_to_none=True)
    return {n: ((g - grads["cpu"][n]).abs().max()
                / g.abs().max().clamp(min=GRAD_FLOOR)).item()
            for n, g in grads["card"].items()}


def gpt_paths_agree(tag, model, runner, one) -> None:
    """One batch through the eval step on the kernel path and the plain
    path: the trunk to TRUNK_TOL, the gpt2 head's tokens >= TOKEN_AGREEMENT
    equal, cap_scores to GPT_SCORE_TOL on the events whose tokens agree."""
    from gvl_tpu_torch.models.layers import set_msda_impl
    _, _, arrs = runner._prepare(one)
    res = {}
    with torch.inference_mode():
        for impl in ("kernel", "ref"):
            set_msda_impl(model, impl)
            res[impl] = runner._to_host(runner._eval_step(arrs))
    set_msda_impl(model, "kernel")
    (kr, ka), (pr, pa) = res["kernel"], res["ref"]
    errs = {}
    for key in ("pred_logits", "pred_boxes", "memory", "event_embed"):
        errs[key] = float(np.abs(ka[key] - pa[key]).max())
        check(np.isfinite(ka[key]).all() and errs[key] <= TRUNK_TOL,
              f"{tag}: {key} kernel vs plain path {errs[key]}")
    tokens = float((kr["gpt_tokens"] == pr["gpt_tokens"]).mean())
    same = ((kr["gpt_tokens"] == pr["gpt_tokens"]).all(-1)
            & (kr["gpt_genmask"] == pr["gpt_genmask"]).all(-1))
    score = float(np.abs(kr["cap_scores"] - pr["cap_scores"])[same].max())
    check(tokens >= TOKEN_AGREEMENT and score <= GPT_SCORE_TOL,
          f"{tag}: tokens agree {tokens}, cap_scores differ by {score}")
    log(tag, f"kernel vs plain path, one batch: trunk max abs diffs "
             f"{json.dumps(errs)}; gpt2 tokens {kr['gpt_tokens'].shape} "
             f"{tokens!r} equal; cap_scores max abs diff {score!r} over the "
             f"{int(same.sum())} of {same.size} events whose captions agree")


def gpt_eval_run(tag, w, runner, batches, name) -> tuple:
    """EvalRunner.run over the batches: (the DVC JSON, the launches). Checks
    the launches (kernel 1 four times a batch), finite numbers, the
    grounding JSONs, and captions of 'w<id>' words before the stop."""
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        t0 = time.perf_counter()
        _, out_json, g_json, aux_json, _ = runner.run(batches,
                                                      f"{tmp}/dvc.json")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_counts()
    want = want_counts(w, len(batches), train=False)
    n_num = check_finite_json(f"{tag} {name} DVC JSON", out_json)
    check_grounding(tag, batches, g_json, aux_json)
    sents = [it["sentence"] for v in out_json["results"].values() for it in v]
    lengths = [len(x.split()) for x in sents]
    check(got == want and max(lengths) <= w.cfg["max_caption_len"]
          and all(t.startswith("w") for x in sents for t in x.split()),
          f"{tag} {name}: launches {got} (want {want}), caption lengths "
          f"{min(lengths)}-{max(lengths)}")
    log(tag, f"{name}: EvalRunner.run over {len(batches)} batches of "
             f"{w.eval_B}: {wall:.3f} s; launches {got}; {n_num} finite "
             f"numbers; {len(sents)} predictions, caption words "
             f"{min(lengths)}-{max(lengths)}")
    return out_json, got


def phase_gpt2(dev, text) -> dict:
    """Phase 24, the gpt2 (ClipCap) head on the flagship (see the
    docstring). Returns the launch counts of its eval runs and train
    steps."""
    free_device_memory()
    from gvl_tpu_torch.eval.evaluate import EvalRunner
    from gvl_tpu_torch.models.gpt_captioner import GPT2Spec
    from gvl_tpu_torch.models.gvl import build_model
    w, tag = GPT2, "gpt2"
    cfg = types.SimpleNamespace(**w.cfg)
    launches, jsons = {}, {}
    model = build_model(cfg, text.hidden_size, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(SEED))
    spec = model.caption_head[0].spec
    check(spec.prefix_size == cfg.hidden_dim == 512 and spec.n_embd == 128,
          f"offline spec {spec}")
    batches = list(synthetic_batches(w, N_BATCHES, SEED))
    one = next(synthetic_batches(w, 1, SEED + 2, long_video=False))
    runners = {}
    for name, opt in (("f32", {}),
                      ("early_exit", dict(eval_decode_early_exit=True)),
                      ("decode_bf16", dict(eval_decode_bf16=True))):
        runners[name] = EvalRunner(types.SimpleNamespace(**dict(w.cfg, **opt)),
                                   model, WordTranslator(), text)
        jsons[name], launches[f"{w.name}_{name}_eval"] = gpt_eval_run(
            tag, w, runners[name], batches, name)
    diff = json_diff(jsons["early_exit"], jsons["f32"])
    check(diff <= 1e-6, f"early exit's DVC JSON differs by {diff}")
    log(tag, f"eval_decode_early_exit: the same DVC JSON as the fixed loop "
             f"(sentences equal, numbers within {diff!r})")
    gpt_paths_agree(tag, model, runners["f32"], one)
    win = {"decode_bf16": [], "f32": []}

    def window(r):
        for _ in range(N_GPT_WINDOW):
            r._to_host(r._eval_step(r._prepare(one)[2])[0])

    with torch.inference_mode():
        for name in win:
            cuda_median_ms(lambda: window(runners[name]), 1, warmup=1)
        for i in range(N_GPT_ROUNDS):
            for name in (("f32", "decode_bf16") if i % 2 else
                         ("decode_bf16", "f32")):
                win[name].append(cuda_median_ms(
                    lambda: window(runners[name]), 1, warmup=0)
                    / N_GPT_WINDOW)
    log(tag, f"({card()}) eval step B={w.eval_B}: decode_bf16 "
             f"{statistics.median(win['decode_bf16'])!r} ms, f32 "
             f"{statistics.median(win['f32'])!r} ms (medians of "
             f"{N_GPT_ROUNDS} windows of {N_GPT_WINDOW} steps, in turns; "
             f"windows {win!r})")
    del runners, model
    free_device_memory()

    tmodel, state, step, weights, tb = build_train(w, dev, text)
    t0 = time.perf_counter()
    spread = plain_spread(w, tmodel, tb[0], weights, text)
    log(tag, f"the plain path's gradients, card vs CPU: worst "
             f"{max(spread.values())!r} of the tensor's max abs "
             f"({max(spread, key=spread.get)}); {time.perf_counter() - t0:.1f}"
             f" s")
    phase_train_paths_agree(w, tmodel, step, weights, tb[0], None, spread)
    res = train_steps_timed(tag, w, state, step, weights, tb, N_GPT_STEPS)
    want = want_counts(w, 1, train=True)
    check(res["per_step"] == want and res["losses"]["loss_caption"] > 0,
          f"gpt2 train step launches {res['per_step']}, want {want}")
    launches[f"{w.name}_train"] = res["per_step"]
    log(tag, f"({card()}) {N_GPT_STEPS} train steps at B={w.train_B}: "
             f"{res['times']!r} ms (CUDA events), median "
             f"{statistics.median(res['times'])!r}; peak device memory "
             f"{res['peak'] / 2**30!r} GiB; launches per step "
             f"{res['per_step']}; last losses: total "
             f"{res['losses']['total_loss']!r}, caption "
             f"{res['losses']['loss_caption']!r}")
    del tmodel, state, step
    free_device_memory()

    # GPT-2 small's published widths on random weights, the same trunk
    small = GPT2Spec(prefix_length=cfg.prefix_length,
                     prefix_size=cfg.hidden_dim)
    model = build_model(cfg, text.hidden_size, device=dev, gpt_spec=small,
                        generator=torch.Generator(device=dev).manual_seed(SEED))
    n_head = sum(p.numel() for p in model.caption_head[0].parameters())
    runner = EvalRunner(cfg, model, WordTranslator(), text)
    arrs = runner._prepare(batches[0])[2]
    with torch.inference_mode():
        runner._to_host(runner._eval_step(arrs)[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        ms = cuda_median_ms(lambda: runner._to_host(runner._eval_step(arrs)[0]),
                            1, warmup=0)
        peak = torch.cuda.max_memory_allocated()
        out = runner._to_host(runner._eval_step(arrs)[0])
    events = out["gpt_tokens"].shape
    check(np.isfinite(out["cap_scores"]).all()
          and int(out["gpt_tokens"].max()) < small.vocab_size,
          "GPT-2 small eval outputs")
    log(tag, f"({card()}) GPT-2 small widths (vocab {small.vocab_size}, "
             f"{small.n_embd} wide, {small.n_layer} layers of {small.n_head} "
             f"heads; head {n_head} parameters, random): one eval step over "
             f"{events[0]} x {events[1]} events x {events[2]} tokens: "
             f"{ms!r} ms (CUDA events), peak device memory "
             f"{peak / 2**30!r} GiB")
    del runner, model
    free_device_memory()
    tmodel, state, step, weights, tb = build_train(w, dev, text,
                                                   gpt_spec=small)
    res = train_steps_timed(tag, w, state, step, weights, tb, 2)
    log(tag, f"({card()}) GPT-2 small widths: train steps at B={w.train_B} "
             f"(G={w.max_gt} captions of {w.cfg['max_caption_len']} tokens, "
             f"both decoder layers' heads): {res['times']!r} ms (CUDA "
             f"events), peak device memory {res['peak'] / 2**30!r} GiB; "
             f"caption loss {res['losses']['loss_caption']!r}")
    check(res["per_step"] == want, f"GPT-2 small launches {res['per_step']}")
    launches[f"{w.name}_small_train"] = res["per_step"]
    del tmodel, state, step
    free_device_memory()
    return launches


# ---------------------------------------------------------------- phase 25
N_TAL_STEPS = 2


class ClassBatches(list):
    """Batches whose dataset holds the class map (`ds.name_map`), as the
    TAL probe's EvalRunner.run reads it from a Batcher."""

    def __init__(self, batches, name_map):
        super().__init__(batches)
        self.ds = types.SimpleNamespace(name_map=name_map)


def write_tal_gt(path: pathlib.Path, batches, names, rs) -> int:
    """A TAL ground truth of the batches' GT events, each with a random
    class name; returns the number of events."""
    db = {}
    for batch in batches:
        for b, vid in enumerate(batch["keys"]):
            dur = float(batch["duration"][b])
            anns = []
            for (c, l), ok in zip(batch["gt_boxes"][b].tolist(),
                                  batch["gt_mask"][b]):
                if ok:
                    anns.append({"segment": [max(c - l / 2, 0.0) * dur,
                                             min(c + l / 2, 1.0) * dur],
                                 "label": names[rs.randint(len(names))]})
            db[vid[2:]] = {"subset": "validation", "annotations": anns}
    path.write_text(json.dumps({"database": db, "version": "1.3"}))
    return sum(len(v["annotations"]) for v in db.values())


def phase_tal(dev, text) -> dict:
    """Phase 25, TAL on the flagship (see the docstring). Returns the
    launch counts of its eval runs and probe train steps."""
    free_device_memory()
    from gvl_tpu_torch.data.vocabulary import ClassMap
    from gvl_tpu_torch.eval.evaluate import EvalRunner
    from gvl_tpu_torch.eval.metrics import eval_tal
    from gvl_tpu_torch.eval.zeroshot_tal import convert_dvc_to_zeroshot_tal
    from gvl_tpu_torch.models.gvl import build_model
    from gvl_tpu_torch.models.layers import set_msda_impl
    w, tag = TAL, "tal"
    n_class = w.cfg["num_classes"]
    rs = np.random.RandomState(SEED)
    names = [f"{WORDS[i % len(WORDS)]} {WORDS[(7 * i + 3) % len(WORDS)]} "
             f"{i}" for i in range(n_class)]
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        (root / "classes.txt").write_text("\n".join(names))
        batches = ClassBatches(synthetic_batches(w, N_BATCHES, SEED),
                               ClassMap(str(root / "classes.txt")))
        n_gt = write_tal_gt(root / "tal_gt.json", batches, names, rs)
        cfg = types.SimpleNamespace(**dict(
            w.cfg, action_classes_path=str(root / "classes.txt"),
            tal_gt_file=str(root / "tal_gt.json")))
        model = build_model(cfg, text.hidden_size, device=dev, generator=(
            torch.Generator(device=dev).manual_seed(SEED)))
        check(model.class_head[0].out_features == n_class, "200 classes")
        want = want_counts(w, N_BATCHES, train=False)
        # the linear probe's TAL JSON and its mAP
        runner = EvalRunner(cfg, model, WordTranslator(), text)
        reset_counts()
        runner.run(batches, str(root / "probe.json"))
        torch.cuda.synchronize()
        launches[f"{w.name}_probe_eval"] = got = read_counts()
        with open(runner.last_tal_json) as f:
            sub = json.load(f)
        labels = {p["label"] for v in sub["results"].values() for p in v}
        maps = eval_tal(cfg.tal_gt_file, runner.last_tal_json)
        check(got == want and labels <= set(names) and len(sub["results"])
              == N_BATCHES * w.eval_B
              and math.isfinite(maps["TAL_Average_mAP"]),
              f"TAL probe: launches {got}, {len(labels)} labels, {maps}")
        log(tag, f"probe: EvalRunner.run over {N_BATCHES} batches: launches "
                 f"{got}; TAL JSON {runner.last_tal_json.rsplit('/', 1)[-1]}"
                 f" with {sum(len(v) for v in sub['results'].values())} "
                 f"segments of {len(labels)} of the {n_class} classes; "
                 f"eval_tal against {n_gt} GT segments: {maps!r}")
        # zero-shot: the prompted class names embedded once
        zr = EvalRunner(cfg, model, WordTranslator(), text)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        zr.enable_zeroshot_tal([f"a video of {n}" for n in names])
        torch.cuda.synchronize()
        embed_ms = (time.perf_counter() - t0) * 1e3
        reset_counts()
        _, out_json, *_ = zr.run(batches, str(root / "zs.json"))
        torch.cuda.synchronize()
        launches[f"{w.name}_zeroshot_eval"] = got = read_counts()
        n_pred = 0
        for v in out_json["results"].values():
            for p in v:
                n_pred += 1
                for k in ("tal_cl_scores", "aux_tal_cl_scores"):
                    check(len(p[k]) == n_class and all(
                        math.isfinite(x) and abs(x) <= 1 + 1e-6
                        for x in p[k]), f"{k} of a prediction")
        check(got == want, f"zero-shot launches {got}")
        sub = json.load(open(convert_dvc_to_zeroshot_tal(
            str(root / "zs.json"), names)))
        zs_labels = {p["label"] for v in sub["results"].values() for p in v}
        check(zs_labels and zs_labels <= set(names), "zero-shot labels")
        log(tag, f"({card()}) zero-shot: {n_class} prompted class names "
                 f"embedded in {embed_ms!r} ms (host clock, synchronised); "
                 f"EvalRunner.run: launches {got}; {n_pred} predictions, each "
                 f"with {n_class} tal_cl_scores and aux_tal_cl_scores in "
                 f"[-1, 1]; the zero-shot submission names {len(zs_labels)} "
                 f"classes")
        _, _, arrs = zr._prepare(batches[1])
        res = {}
        with torch.inference_mode():
            for impl in ("kernel", "ref"):
                set_msda_impl(model, impl)
                res[impl] = zr._to_host(zr._eval_step(arrs)[0])
        set_msda_impl(model, "kernel")
        errs = {k: float(np.abs(res["kernel"][k] - res["ref"][k]).max())
                for k in ("tal_cl_scores", "aux_tal_cl_scores")}
        check(max(errs.values()) <= TRUNK_TOL,
              f"class scores kernel vs plain path {errs}")
        log(tag, f"class scores {res['kernel']['tal_cl_scores'].shape}, "
                 f"kernel vs plain path: max abs diffs {json.dumps(errs)}")
        del runner, zr, model
        free_device_memory()
        # probe train steps: only the class heads are stepped, and autograd
        # still runs through the trunk
        tmodel, state, step, weights, tb = build_train(w, dev, text)
        before = {n: p.detach().clone() for n, p in tmodel.named_parameters()}
        res = train_steps_timed(tag, w, state, step, weights, tb, N_TAL_STEPS)
        moved = {n.split(".")[0] for n, p in tmodel.named_parameters()
                 if not torch.equal(p.detach(), before[n])}
        check(res["per_step"] == want_counts(w, 1, train=True)
              and moved == {"class_head"},
              f"probe step launches {res['per_step']}, moved {moved}")
        launches[f"{w.name}_probe_train"] = res["per_step"]
        log(tag, f"({card()}) probe: {N_TAL_STEPS} train steps at "
                 f"B={w.train_B}: {res['times']!r} ms, peak "
                 f"{res['peak'] / 2**30!r} GiB; launches per step "
                 f"{res['per_step']} (the backward kernel runs: every "
                 f"parameter gets its gradient, only the class heads step); "
                 f"moved: {sorted(moved)}")
        del tmodel, state, step
        free_device_memory()
    return launches


# ------------------------------------------------- phase 15: remat_trunk
N_REMAT_STEPS = 3
REMAT_TOL = {"anet": 1e-6, "longvideo": GRAD_TOL}


def rel_grad_diff(a: dict, b: dict) -> tuple:
    """The largest max abs difference of two gradient dicts' tensors over
    the tensor's own max abs (ties of zero tensors left out): (it, name)."""
    worst, worst_name = 0.0, ""
    for n, g in a.items():
        scale = g.abs().max().item()
        err = (b[n] - g).abs().max().item()
        rel = err / scale if scale > 0 else (0.0 if err == 0 else math.inf)
        if rel > worst:
            worst, worst_name = rel, n
    return worst, worst_name


@contextlib.contextmanager
def deterministic_algorithms():
    """torch's and cuDNN's deterministic algorithms inside the block (ops
    that have none warn), then the modes as they were."""
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        torch.backends.cudnn.deterministic = was[2]


def phase_remat(w: Workload, dev, text=None) -> dict:
    """The train step with and without remat_trunk (see the docstring).
    Each model's gradients are taken twice, under deterministic
    algorithms: without them two plain runs' base-encoder convolution
    weight gradients differed by 9.8e-7 of its max abs, with them the
    flagship's are equal bit for bit (NVIDIA H100 80GB HBM3, 700 W; the
    long video's kernel 4 still adds with float atomics). The second
    gradients are compared, within REMAT_TOL of each tensor's max abs
    beyond what the two plain runs differ by. Returns the launch counts of
    a remat step."""
    free_device_memory()
    tag = w.tag + "remat"
    res = {}
    for remat in (False, True):
        wr = dataclasses.replace(w, cfg=REMAT[w.name] if remat else w.cfg)
        model, state, step, weights, batches = build_train(wr, dev, text)
        model.train()
        grads = []
        with deterministic_algorithms():
            for _ in range(2):
                torch.manual_seed(SEED)           # the same dropout masks
                losses = step.forward_losses(batches[0])
                sum(losses[k] * weights[k] for k in losses
                    if k in weights).backward()
                grads.append({n: p.grad.detach().cpu()
                              for n, p in model.named_parameters()})
                model.zero_grad(set_to_none=True)
        res[remat] = (grads, train_steps_timed(
            tag, wr, state, step, weights, batches, N_REMAT_STEPS))
        del model, state, step, losses
        free_device_memory()
    (g0, t0), (g1, t1) = res[False], res[True]
    floor, floor_name = rel_grad_diff(g0[0], g0[1])
    worst, worst_name = rel_grad_diff(g0[1], g1[1])
    check(worst <= REMAT_TOL[w.name] + floor,
          f"{tag}: {worst_name} gradient with remat differs by {worst} of "
          f"its max abs (the two plain runs: {floor}, {floor_name})")
    g0 = g0[1]
    want = want_counts(w, 1, train=True)
    recomputed = dict(want, fwd=2 * want["fwd"],
                      banded_fwd=2 * want["banded_fwd"])
    check(t0["per_step"] == want and t1["per_step"] == recomputed,
          f"{tag}: launches {t0['per_step']} / {t1['per_step']}")
    check(t1["peak"] <= t0["peak"], f"{tag}: remat peak {t1['peak']} > "
                                    f"{t0['peak']}")
    med = statistics.median
    log(tag, f"({card()}) {w.name} train step B={w.train_B} with "
             f"remat_trunk: {len(g0)} named gradients, worst max abs diff / "
             f"own max abs {worst!r} ({worst_name}; bound "
             f"{REMAT_TOL[w.name]} beyond the two plain runs' "
             f"{floor!r}, {floor_name}); step "
             f"{med(t1['times'])!r} ms against "
             f"{med(t0['times'])!r} ms without (medians of {N_REMAT_STEPS}, "
             f"CUDA events); peak device memory {t1['peak'] / 2**30!r} GiB "
             f"against {t0['peak'] / 2**30!r} GiB "
             f"({(t0['peak'] - t1['peak']) / 2**20!r} MiB lower); launches "
             f"per step {t1['per_step']} against {t0['per_step']} (each "
             f"layer's forward runs again in the backward)")
    return {f"{w.name}_remat_train": t1["per_step"]}


# ---------------------------------------------------------------- phase 26
ROBERTA_BASE = dict(        # roberta-base's published config.json
    architectures=["RobertaForMaskedLM"], model_type="roberta",
    vocab_size=50265, hidden_size=768, num_hidden_layers=12,
    num_attention_heads=12, intermediate_size=3072, hidden_act="gelu",
    hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
    max_position_embeddings=514, type_vocab_size=1, initializer_range=0.02,
    layer_norm_eps=1e-5, pad_token_id=1, bos_token_id=0, eos_token_id=2)
GPT2_SMALL = dict(          # GPT-2 small's published config.json
    architectures=["GPT2LMHeadModel"], model_type="gpt2", vocab_size=50257,
    n_embd=768, n_layer=12, n_head=12, n_positions=1024, n_ctx=1024,
    layer_norm_epsilon=1e-5, activation_function="gelu_new",
    bos_token_id=50256, eos_token_id=50256)
HUB_REVISION = "0" * 40
N_TOKENIZE = 5              # phase 26: timed tokenizations of one batch


def write_bpe(folder: pathlib.Path, texts, size: int, front, back) -> dict:
    """vocab.json and merges.txt of a byte-level BPE of `size` ids: the
    tokens `front`, the 256 byte symbols, merges counted from `texts`
    (the most frequent pair first, while one occurs twice), numbered
    fillers, then the tokens `back` (the last ids). Returns the vocab."""
    from collections import Counter
    from gvl_tpu_torch.models.bpe import bytes_to_unicode, pre_tokenize
    table = bytes_to_unicode()
    vocab = {t: i for i, t in enumerate(front)}
    for b in range(256):
        vocab[table[b]] = len(vocab)
    words = Counter(tuple(table[b] for b in piece.encode("utf-8"))
                    for t in texts for piece in pre_tokenize(t))
    merges = []
    while len(vocab) + len(back) < size:
        pairs = Counter()
        for word, n in words.items():
            for pair in zip(word, word[1:]):
                pairs[pair] += n
        if not pairs:
            break
        (a, b), n = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        if n < 2:
            break
        merges.append((a, b))
        vocab.setdefault(a + b, len(vocab))
        merged = Counter()
        for word, n in words.items():
            out, i = [], 0
            while i < len(word):
                if word[i:i + 2] == (a, b):
                    out.append(a + b)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            merged[tuple(out)] += n
        words = merged
    n_merges = len(merges)
    i = 0
    while len(vocab) + len(back) < size:
        vocab[f"<filler{i}>"] = len(vocab)
        i += 1
    for t in back:
        vocab[t] = len(vocab)
    folder.mkdir(parents=True, exist_ok=True)
    (folder / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False))
    (folder / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges),
        encoding="utf-8")
    return dict(vocab=len(vocab), merges=n_merges)


def write_roberta_base(cache: pathlib.Path, texts, dev) -> tuple:
    """roberta-base's hub cache under `cache` (see the docstring):
    the published config.json, random weights from the seed in an MLM
    checkpoint's names (roberta.*, lm_head.*, no pooler) in
    model.safetensors, and the BPE files. Returns (the snapshot directory,
    write_bpe's counts)."""
    from gvl_tpu_torch.models.text_encoder import RobertaSpec, TextEncoder
    from gvl_tpu_torch.utils.hf_files import write_safetensors
    repo = cache / "models--roberta-base"
    snap = repo / "snapshots" / HUB_REVISION
    snap.mkdir(parents=True)
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text(HUB_REVISION)
    (snap / "config.json").write_text(json.dumps(ROBERTA_BASE))
    counts = write_bpe(snap, texts, ROBERTA_BASE["vocab_size"],
                       ("<s>", "<pad>", "</s>", "<unk>"), ("<mask>",))
    spec = RobertaSpec.from_hf_config(ROBERTA_BASE)
    with torch.device("meta"):
        enc = TextEncoder(spec, device="meta")
    enc = enc.to_empty(device=dev)
    enc.text_encoder.flax_init_(torch.Generator(device=dev).manual_seed(
        SEED + 26))
    sd = {"roberta." + k: v for k, v in enc.text_encoder.state_dict().items()
          if not k.startswith("pooler.")}
    H, V = spec.hidden_size, spec.vocab_size
    gen = torch.Generator(device=dev).manual_seed(SEED + 27)
    sd.update({"lm_head.dense.weight": torch.randn(H, H, generator=gen,
                                                   device=dev) * 0.02,
               "lm_head.dense.bias": torch.zeros(H, device=dev),
               "lm_head.layer_norm.weight": torch.ones(H, device=dev),
               "lm_head.layer_norm.bias": torch.zeros(H, device=dev),
               "lm_head.bias": torch.zeros(V, device=dev)})
    write_safetensors(sd, str(snap / "model.safetensors"))
    return snap, counts


def write_gpt2_small(folder: pathlib.Path, texts) -> dict:
    """A GPT-2 directory at GPT-2 small's published widths: config.json,
    its own BPE (the 256 byte symbols, merges of `texts`, fillers,
    <|endoftext|> at 50256) and a tokenizer_config.json that names the
    tokenizer and takes <|endoftext|> as the pad token (GPT-2's own files
    name none, and padding then raises, as in HF)."""
    counts = write_bpe(folder, texts, GPT2_SMALL["vocab_size"], (),
                       ("<|endoftext|>",))
    (folder / "config.json").write_text(json.dumps(GPT2_SMALL))
    (folder / "tokenizer_config.json").write_text(json.dumps(dict(
        tokenizer_class="GPT2Tokenizer", pad_token="<|endoftext|>",
        add_prefix_space=False, clean_up_tokenization_spaces=False)))
    return counts


def reference_pth(model, path: pathlib.Path, text) -> int:
    """The model's state_dict as a reference .pth holds it (see the
    docstring); returns the number of tensors."""
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    for k in list(sd):
        if k.startswith("bbox_head."):
            sd["transformer.decoder." + k] = sd[k].clone()
    gen = torch.Generator().manual_seed(SEED + 28)
    for k in range(model.arch.dec_layers):
        p = f"caption_head.{k}.core.deformable_att"
        w = sd[f"{p}.value_proj.weight"]
        for sub in ("output_proj", "attention_weights"):
            sd[f"{p}.{sub}.weight"] = torch.randn(w.shape, generator=gen)
            sd[f"{p}.{sub}.bias"] = torch.zeros(w.shape[0])
    sd.update({"text_encoder." + k: v.detach().cpu()
               for k, v in text.text_encoder.state_dict().items()})
    torch.save({"model": sd, "epoch": 25}, path)
    return len(sd)


def caption_paths_agree(tag, model, runner, one) -> None:
    """cap_scores of the LSTM-DSA head on the kernel and the plain path,
    on the events whose tokens agree, to GPT_SCORE_TOL."""
    from gvl_tpu_torch.models.layers import set_msda_impl
    _, _, arrs = runner._prepare(one)
    res = {}
    with torch.inference_mode():
        for impl in ("kernel", "ref"):
            set_msda_impl(model, impl)
            res[impl] = runner._to_host(runner._eval_step(arrs))[0]
    set_msda_impl(model, "kernel")
    k, p = res["kernel"], res["ref"]
    tokens = float((k["seq"] == p["seq"]).mean())
    same = (k["seq"] == p["seq"]).all(-1)
    score = float(np.abs(k["cap_scores"] - p["cap_scores"])[same].max())
    check(tokens >= TOKEN_AGREEMENT and score <= GPT_SCORE_TOL
          and np.isfinite(k["cap_scores"]).all(),
          f"{tag}: tokens agree {tokens}, cap_scores differ by {score}")
    log(tag, f"kernel vs plain path, imported weights: tokens "
             f"{k['seq'].shape} {tokens!r} equal; cap_scores max abs diff "
             f"{score!r} over the {int(same.sum())} of {same.size} events "
             f"whose captions agree")


def phase_published(dev) -> dict:
    """Phase 26, the flagship as published with published files (see the
    docstring). Returns the launch counts of its gpt2 train step, eval CLI
    and train CLI runs."""
    free_device_memory()
    from gvl_tpu_torch import eval_cli, import_cli, train_cli
    from gvl_tpu_torch.config import Config
    from gvl_tpu_torch.eval.evaluate import EvalRunner
    from gvl_tpu_torch.models.bpe import ByteLevelBPE
    from gvl_tpu_torch.models.gpt_captioner import GPT2Spec
    from gvl_tpu_torch.models.gvl import build_model
    from gvl_tpu_torch.models.text_encoder import RobertaSpec
    from gvl_tpu_torch.train.checkpoint import CheckpointManager
    from gvl_tpu_torch.train.loop import make_gpt_tokenize
    w, tag = PUBLISHED, PUBLISHED.tag
    launches = {}
    t_phase = time.perf_counter()
    check(not w.cfg["load_pretrained_language_model_from_config"]
          and w.cfg["pretrained_language_model"] == "roberta-base",
          "the published workload reads roberta-base")
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        w = dataclasses.replace(w, cfg=dict(
            w.cfg, huggingface_cache_dir=str(root / "hf_cache")))
        t0 = time.perf_counter()
        data, grounding, anno = write_cli_data(w, root)
        texts = [s for v in anno.values() for s in v["sentences"]]
        snap, rcounts = write_roberta_base(root / "hf_cache", texts, dev)
        gcounts = write_gpt2_small(root / "gpt2", texts)
        log(tag, f"wrote the roberta-base hub cache ({snap}; "
                 f"{(snap / 'model.safetensors').stat().st_size / 2**20:.1f}"
                 f" MiB of weights; BPE {rcounts}), the GPT-2 small "
                 f"directory (BPE {gcounts}) and the world in "
                 f"{time.perf_counter() - t0:.3f} s")

        # ---- the text encoder from the hub cache
        text = load_text(w, dev)
        check(text.text_encoder.spec == RobertaSpec.from_hf_config(
            ROBERTA_BASE) and text.text_encoder.spec.layer_norm_eps == 1e-5,
            "roberta-base's spec")
        G, L = w.max_gt, w.cfg["max_text_input_len"]
        raw = [list(v["sentences"]) for v in anno.values()][:w.eval_B]
        host = []
        for i in range(N_TOKENIZE):
            if i == 0:
                text._tok._cache.clear()
            t1 = time.perf_counter()
            ids, mask = text.tokenize(raw, G, L)
            host.append((time.perf_counter() - t1) * 1e3)
        check(ids.shape == (w.eval_B, G, L) and int(ids[:, :, 0].min()) == 0
              and int(ids.max()) < 50265, f"BPE ids {ids.shape}")
        ids_t = torch.from_numpy(ids.reshape(-1, L)).long().to(dev)
        mask_t = torch.from_numpy(mask.reshape(-1, L)).to(dev)
        with torch.inference_mode():
            out = text(ids_t, mask_t)
            check(bool(torch.isfinite(out).all()), "text encoder output")
            enc_ms = device_median_ms(lambda: text(ids_t, mask_t), 10)
        log(tag, f"({card()}) BPE tokenization of one eval batch "
                 f"({w.eval_B} videos x G={G} sentences of {L} tokens, "
                 f"{int(mask.sum())} real tokens): {host[0]!r} ms cold "
                 f"cache, then {statistics.median(host[1:])!r} ms (median "
                 f"of {N_TOKENIZE - 1}, host clock); the text encoder at "
                 f"vocab 50265 on its {ids_t.shape[0]} rows: {enc_ms!r} ms "
                 "(device median of 10)")

        # ---- GPT-2 small's files through load_gpt2_spec / make_gpt_tokenize
        gcfg = Config().update(dict(w.cfg, caption_decoder_type="gpt2",
                                    gpt_model=str(root / "gpt2")))
        spec, add_gpt_inputs, gpt_decode = make_gpt_tokenize(gcfg)
        bpe = ByteLevelBPE.from_dir(str(root / "gpt2"))
        want = GPT2Spec(
            vocab_size=GPT2_SMALL["vocab_size"], n_embd=GPT2_SMALL["n_embd"],
            n_layer=GPT2_SMALL["n_layer"], n_head=GPT2_SMALL["n_head"],
            n_positions=GPT2_SMALL["n_positions"],
            prefix_length=gcfg.prefix_length, prefix_size=gcfg.prefix_size,
            prefix_num_mapping_layer=gcfg.prefix_num_mapping_layer,
            stop_token_id=bpe.encode(".")[0])
        check(spec == want, f"GPT-2 small spec {spec}")
        gw = dataclasses.replace(w, name="anet_published_gpt2",
                                 cfg=gcfg.to_dict())
        tmodel, state, step, weights, tb = build_train(gw, dev, text,
                                                       gpt_spec=spec)
        for b in tb:
            add_gpt_inputs(b)
            check(int(b["gpt_tokens"].max()) < spec.vocab_size
                  and b["gpt_mask"].sum() > 0, "GPT-2 BPE tokens")
        res = train_steps_timed(tag, gw, state, step, weights, tb, 1)
        launches["anet_published_gpt2_train"] = res["per_step"]
        check(res["per_step"] == want_counts(w, 1, train=True),
              f"{tag}: gpt2 train launches {res['per_step']}")
        runner = EvalRunner(gcfg, tmodel, WordTranslator(), text,
                            gpt_decode=gpt_decode)
        with torch.inference_mode():
            one = runner._to_host(runner._eval_step(
                runner._prepare(next(synthetic_batches(w, 1, SEED)))[2])[0])
        caps = [gpt_decode(one["gpt_tokens"][0, q][:int(
            one["gpt_genmask"][0, q].sum())]) for q in range(3)]
        check(np.isfinite(one["cap_scores"]).all()
              and all(isinstance(c, str) for c in caps),
              "gpt2 eval step on BPE-decoded captions")
        log(tag, f"({card()}) gpt_model's files: spec {spec}; stop id "
                 f"{spec.stop_token_id} = encode('.')[0]; a train step on "
                 f"its BPE tokens {res['times']!r} ms (CUDA events), peak "
                 f"{res['peak'] / 2**30!r} GiB, launches {res['per_step']}; "
                 f"an eval step's first captions decoded: {caps!r}")
        del tmodel, state, step, runner
        free_device_memory()

        # ---- a reference .pth of the seeded flagship, imported
        cfg = dict(w.cfg, **data)
        yml = write_run_yml(root / "anet_published.yml", cfg)
        model = build_model(types.SimpleNamespace(**cfg), text.hidden_size,
                            device=dev, generator=torch.Generator(
                                device=dev).manual_seed(SEED))
        n_ref = reference_pth(model, root / "ref.pth", text)
        seeded = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        del model
        free_device_memory()
        run = root / "save" / "imported"
        t1 = time.perf_counter()
        imp = import_cli.main(["--pth", str(root / "ref.pth"), "--cfg_path",
                               str(yml), "--out", str(run)])
        import_s = time.perf_counter() - t1
        check(imp["unused"] == [] and imp["unfilled"] == [],
              f"import: unused {imp['unused'][:5]}, unfilled "
              f"{imp['unfilled'][:5]}")
        payload = CheckpointManager(str(run)).restore_raw("model-best")
        check(all(torch.equal(payload["model"][k], v)
                  for k, v in seeded.items())
              and payload["text_encoder"] is not None,
              "the imported weights are the seeded ones")
        log(tag, f"({card()}) import_cli.main of a reference .pth of "
                 f"{n_ref} tensors: {import_s!r} s; unused [] and unfilled "
                 "[], as the importer's rules predict; the checkpoint holds "
                 "the seeded weights bit for bit")

        # ---- the eval CLI on the imported run
        argv = ["--eval_save_dir", str(run.parent), "--eval_folder",
                run.name, "--eval_batch_size", str(w.eval_B),
                "--eval_gt_file_for_grounding", str(grounding)]
        reset_counts()
        t1 = time.perf_counter()
        res = eval_cli.main(argv)
        wall = time.perf_counter() - t1
        launches["anet_published_eval_cli"] = got = read_counts()
        check(got == want_counts(w, res["batches"], train=False)
              and res["videos"] == CLI_VIDEOS,
              f"{tag}: eval CLI launches {got}")
        n_num = check_finite_json("DVC JSON", json.loads(pathlib.Path(
            res["dvc_json"]).read_text()))
        log(tag, f"({card()}) eval_cli.main on the imported run: "
                 f"{res['videos']} videos in {wall!r} s, "
                 f"{res['videos'] / wall!r} videos/s; stage times "
                 f"{res['times']}; launches {got}; {n_num} numbers, finite")

        # ---- kernel path vs plain path on the imported weights
        ecfg = Config().update(json.loads((run / "opts.json").read_text()))
        model = build_model(ecfg, text.hidden_size, device=dev)
        model.load_state_dict(payload["model"], strict=True)
        runner = EvalRunner(ecfg, model, WordTranslator(), text)
        phase_paths_agree(w, ecfg, model, runner)
        caption_paths_agree(tag, model, runner,
                            next(synthetic_batches(w, 1, SEED + 2)))
        del model, runner
        free_device_memory()

        # ---- the train CLI from the imported run (--pretrain_path)
        tcfg = dict(cfg, save_dir=str(root / "save"), id="published_ft",
                    epoch=1, min_epoch_when_save=0, batch_size=TRAIN_CLI_B,
                    pretrain="full", pretrain_path=str(run))
        reset_counts()
        t1 = time.perf_counter()
        folder = pathlib.Path(train_cli.main(
            ["--cfg_path", str(write_run_yml(root / "ft.yml", tcfg))]))
        wall = time.perf_counter() - t1
        launches["anet_published_train_cli"] = got = read_counts()
        info = json.loads((folder / "info.json").read_text())
        losses = info["history"]["train_loss"]["0"]
        check(got["bwd"] == want_counts(w, CLI_VIDEOS // TRAIN_CLI_B,
                                        True)["bwd"]
              and math.isfinite(losses["total_loss"]),
              f"{tag}: train CLI launches {got}, losses {losses}")
        log(tag, f"({card()}) train_cli.main from the imported run (--pretrain "
                 f"full): one epoch of {CLI_VIDEOS // TRAIN_CLI_B} steps and "
                 f"its validation in {wall!r} s; launches {got}; total loss "
                 f"{losses['total_loss']!r}")
        del text
    free_device_memory()
    log(tag, f"phase 26 took {time.perf_counter() - t_phase!r} s (host "
             "clock, the files' writing included)")
    return launches


# ---------------------------------------------------------------- phase 27
N_OPTION_STEPS = 5


class ForcedDraws:
    """The scheduled-sampling draws of one forward, recorded from the
    port's ss_draws on the first path and handed back in the same order on
    the second, so that both paths sample the same tokens."""

    def __init__(self, real):
        self.real, self.draws, self.replay = real, [], None

    def __call__(self, prev_lp, generator=None):
        if self.replay is None:
            self.draws.append(self.real(prev_lp, generator))
            return self.draws[-1]
        self.replay += 1
        return self.draws[self.replay - 1]


def option_paths_agree(tag, model, step, weights, batch, ss_prob) -> None:
    """Phase 10's check of one option's step in train mode (scheduled
    sampling needs it), dropout seeded alike on both paths and, at
    ss_prob > 0, the kernel path's draws forced into the plain path's
    chain: total loss to LOSS_TOL relative, each named gradient to GRAD_TOL
    x its max abs (a parameter no loss reaches, the learnt queries under
    gt_proposals, has no gradient on either path)."""
    import gvl_tpu_torch.models.captioner as captioner
    from gvl_tpu_torch.models.layers import set_msda_impl
    forced = ForcedDraws(captioner.ss_draws)
    res = {}
    try:
        captioner.ss_draws = forced
        for impl in ("kernel", "ref"):
            set_msda_impl(model, impl)
            model.train()
            model.zero_grad(set_to_none=True)
            torch.manual_seed(SEED)
            forced.replay = None if impl == "kernel" else 0
            # the draws from a generator of their own (seed), so that the
            # dropout masks' default generator is drawn alike on both paths
            losses = step.forward_losses(batch, seed=SEED, ss_prob=ss_prob)
            total = sum(losses[k] * weights[k] for k in losses
                        if k in weights)
            total.backward()
            res[impl] = (total.item(), {
                n: None if p.grad is None else p.grad.clone()
                for n, p in model.named_parameters()})
    finally:
        captioner.ss_draws = forced.real
        set_msda_impl(model, "kernel")
        model.zero_grad(set_to_none=True)
        model.eval()
    check(forced.replay == len(forced.draws) and (
        len(forced.draws) > 0) == (ss_prob > 0),
        f"{tag}: {len(forced.draws)} draws recorded, {forced.replay} forced")
    (kt, kg), (pt, pg) = res["kernel"], res["ref"]
    rel = abs(kt - pt) / abs(pt)
    check(rel <= LOSS_TOL, f"{tag}: total loss differs by {rel}")
    worst, worst_name, n_none = 0.0, "", 0
    for n, g in pg.items():
        if g is None:
            check(kg[n] is None, f"{tag}: {n} has a gradient on one path")
            n_none += 1
            continue
        scale = g.abs().max().item()
        err = (kg[n] - g).abs().max().item()
        check(math.isfinite(err) and err <= GRAD_TOL * scale + GRAD_FLOOR,
              f"{tag}: {n} kernel vs plain path gradient {err} > "
              f"{GRAD_TOL} x {scale}")
        if scale > GRAD_FLOOR and err / scale > worst:
            worst, worst_name = err / scale, n
    log(tag, f"kernel vs plain path, train mode, dropout seeded alike"
             f"{', the same forced draws' if ss_prob > 0 else ''}: total loss "
             f"{kt!r} / {pt!r} (relative {rel!r}); {len(pg) - n_none} named "
             f"gradients, worst max abs diff / own max abs {worst!r} "
             f"({worst_name}); {n_none} without a gradient on both paths")


def phase_train_options(dev, text) -> dict:
    """Phase 27: the caption cost, scheduled sampling and gt_proposals on
    the flagship (see the docstring)."""
    from gvl_tpu_torch.eval.evaluate import EvalRunner
    out = {}
    ss_prob = float(ANET.cfg["scheduled_sampling_max_prob"])
    for name, w, ss in (("caption_cost", OPTIONS["caption_cost"], 0.0),
                        ("ss", ANET, ss_prob),
                        ("gt_proposals", OPTIONS["gt_proposals"], 0.0)):
        tag = {"ss": "ss"}.get(name, w.tag)
        free_device_memory()
        model, state, step, weights, batches = build_train(w, dev, text)
        if name == "gt_proposals":
            rs = np.random.RandomState(SEED)
            for b in batches:         # proposals of different segments
                b["gt_boxes"] = gt_fields(w, rs, np.full(w.train_B, 1))[
                    "gt_boxes"]
            check(not hasattr(model.transformer, "reference_points")
                  and model.transformer.pos_trans.in_features == 512,
                  "a two-stage model: pos_trans, no reference_points")
            runner = EvalRunner(types.SimpleNamespace(**w.cfg), model,
                                WordTranslator(), text)
            eval_batches = list(synthetic_batches(w, N_BATCHES, SEED))
            with tempfile.TemporaryDirectory() as tmp:
                runner.run(eval_batches[:1], f"{tmp}/warm.json")
                torch.cuda.synchronize()
                reset_counts()
                t0 = time.perf_counter()
                _, dvc, g_json, aux_json, losses = runner.run(
                    eval_batches, f"{tmp}/dvc.json")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            out[f"{w.name}_eval"] = read_counts()
            want = want_counts(w, N_BATCHES, train=False)
            check(out[f"{w.name}_eval"] == want,
                  f"{tag}: eval launches {out[w.name + '_eval']} != {want}")
            check(len(dvc["results"]) == w.eval_B * N_BATCHES and
                  check_finite_json(f"{tag} DVC JSON", dvc) > 0,
                  f"{tag}: DVC JSON")
            n = check_grounding(tag, eval_batches, g_json, aux_json)
            log(tag, f"({card()}) gt_proposals eval: EvalRunner.run over "
                     f"{N_BATCHES} batches of {w.eval_B} in {wall!r} s "
                     f"({w.eval_B * N_BATCHES / wall!r} videos/s, host "
                     f"clock, the queries the {w.max_gt} GT slots); "
                     f"launches {out[w.name + '_eval']}; {n} grounding keys; "
                     f"eval losses finite: "
                     f"{all(math.isfinite(v) for v in losses.values())}")
            del runner
        option_paths_agree(tag, model, step, weights, batches[0], ss)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, per_step = [], None
        for i in range(N_OPTION_STEPS):
            reset_counts()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            losses = step(state, batches[i % 2], weights, ss, seed=i)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
            per_step = per_step or read_counts()
            check(all(math.isfinite(float(v)) for v in losses.values()),
                  f"{tag}: step {i} losses {losses}")
        peak = torch.cuda.max_memory_allocated()
        key = f"anet_{name}_train"
        out[key] = per_step
        want = want_counts(w, 1, train=True)
        check(per_step == want, f"{tag}: launches {per_step} != {want}")
        log(tag, f"({card()}) {name} train step (B={w.train_B}"
                 f"{f', ss_prob {ss}' if ss else ''}): median "
                 f"{statistics.median(times)!r} ms over {N_OPTION_STEPS} "
                 f"steps {[round(t, 3) for t in times]}; peak device memory "
                 f"{peak / 2**30!r} GiB; launches per step {per_step}; "
                 f"loss_caption {float(losses['loss_caption'])!r}")
        del model, state, step
    free_device_memory()
    return out


# ---------------------------------------------------------------- phase 28
TSP_BACKBONE = "r2plus1d_34"
TSP_CLIP = (16, 112, 112)          # frames, height, width
TSP_EXTRACT_B, TSP_TRAIN_B = 8, 32
TSP_HEADS = (200, 2)               # ActivityNet actions; inside / outside
TSP_VIDEO_FRAMES = (112, 64, 40)   # three synthetic videos: 7 + 4 + 3 clips
TSP_STEPS = 3
# card vs CPU, features of 2 clips through the 34-layer net, f32 with TF32
# off: cuDNN's and the CPU's conv3d sum in other orders
TSP_FEATURE_TOL = 1e-4             # x the features' max abs
# The train step, card against CPU (tsp_step_card_vs_cpu), at batch
# TSP_CHECK_B, fc dropout off, two steps from the same weights: the first at
# lr 0 (a warm-up from 0 over the two steps), which sets the momentum
# buffers and moves the running statistics but no weight, the second at
# half TSP_CHECK_LR in every group, which reads the momentum and moves the
# weights. The net's train-mode gradients at this init amplify rounding: in
# float32 the CPU's own are ~5-7% (median over tensors) off float64's, the
# card's alike, and a second step from weights that differ by rounding
# differs by up to 1e-4 of its max abs even in float64 (on an NVIDIA H100
# 80GB HBM3 at 700 W; PERF.md), hence the first step at lr 0. In float64:
# each parameter's change, each BatchNorm running statistic's change and
# each SGD momentum buffer within TSP_F64_TOL x its CPU max abs (the port's
# code on the card, cuDNN's conv3d and its backward included, against the
# CPU's; ~1e-7 at worst on that card). In float32, the first step's
# momentum buffers (the gradient + weight decay) of the card and of the CPU
# are each held to float64's, and the card's median error must stay within
# TSP_F32_RATIO x the CPU's.
TSP_CHECK_B, TSP_CHECK_LR = 4, 1e-4
TSP_F64_TOL = 1e-5
TSP_F32_RATIO = 2.0


def tsp_step_card_vs_cpu(tag, cfg, dev, batches) -> None:
    """The TSP train step (make_tsp_train_step) on the card against the
    CPU from the card's init: the hand-written BatchNorm rule (momentum
    0.01, biased variance), the SGD groups with weight decay and momentum
    and cuDNN's conv3d backward, in float64 and in float32 (see above)."""
    from gvl_tpu_torch.backbone import train_tsp
    cfg = dataclasses.replace(cfg, lr_warmup_epochs=1, warmup_factor=0.0,
                              backbone_lr=TSP_CHECK_LR, fc_lr=TSP_CHECK_LR)
    init = None

    def run(where, dtype, n_steps):
        nonlocal init
        st = train_tsp.create_tsp_train_state(cfg, SEED, 2, device=where)
        if init is None:
            init = {k: v.cpu().clone()
                    for k, v in st.model.state_dict().items()}
        st.model.to(dtype).load_state_dict(init)
        st.model.dropout.p = 0.0
        step = train_tsp.make_tsp_train_step(st, cfg)
        bufs = []
        for b in batches[:n_steps]:
            step({k: v.astype(np.float64) if dtype == torch.float64
                  and k != "labels" else v for k, v in b.items()})
            bufs.append({n: st.optimizer.state[p]["momentum_buffer"]
                         .detach().cpu().double().clone()
                         for n, p in st.model.named_parameters()})
        sd = {k: v.detach().cpu().clone()
              for k, v in st.model.state_dict().items()}
        del st, step
        free_device_memory()
        return sd, bufs

    def rel(got, want):
        return ((got - want).abs().max()
                / want.abs().max().clamp(min=1e-300)).item()

    card64, card64_bufs = run(dev, torch.float64, 2)
    cpu64, cpu64_bufs = run("cpu", torch.float64, 2)
    worst = {}
    for k, want in cpu64.items():
        if k.endswith("num_batches_tracked"):
            check(int(card64[k]) == int(want) == 2,
                  f"{tag}: {k} {int(card64[k])}")
            continue
        kind = "bn_stat" if "running" in k else "param"
        d0 = init[k].double()
        err = rel(card64[k] - d0, want - d0) if (want - d0).any() else \
            (card64[k] - d0).abs().max().item()
        check(err <= TSP_F64_TOL, f"{tag}: float64 card vs CPU {kind} "
                                  f"change {k}: {err} > {TSP_F64_TOL}")
        worst[kind] = max(worst.get(kind, (0.0, "")), (err, k))
    for n, want in cpu64_bufs[-1].items():
        err = rel(card64_bufs[-1][n], want)
        check(err <= TSP_F64_TOL, f"{tag}: float64 card vs CPU momentum "
                                  f"{n}: {err} > {TSP_F64_TOL}")
        worst["momentum"] = max(worst.get("momentum", (0.0, "")), (err, n))
    stem = [k for k in cpu64 if k.startswith("features.stem.")
            and k.endswith(("weight", "bias"))]
    check(all(torch.equal(card64[k], init[k].double()) for k in stem),
          f"{tag}: the frozen stem moved on the card")
    log(tag, f"({card()}) train step card vs CPU in float64, 2 steps of "
             f"{TSP_CHECK_B} clips from the same weights, dropout off, lr 0 "
             f"then {TSP_CHECK_LR / 2}: {len(cpu64_bufs[-1])} "
             f"parameters' changes and momentum buffers and "
             f"{sum('running' in k for k in cpu64)} BatchNorm statistics' "
             f"changes within {TSP_F64_TOL} x their max abs; worst "
             + "; ".join(f"{k} {v[0]!r} ({v[1]})"
                         for k, v in sorted(worst.items())))

    stats = []
    for where in (dev, "cpu"):
        _, bufs = run(where, torch.float32, 1)
        e = sorted(rel(bufs[0][n], want)
                   for n, want in card64_bufs[0].items())
        stats.append((float(np.median(e)), float(np.percentile(e, 90)),
                      e[-1]))
    on_card, on_cpu = stats
    check(on_card[0] <= TSP_F32_RATIO * on_cpu[0],
          f"{tag}: float32 gradients, card {on_card} against the CPU's "
          f"{on_cpu} (median, 90th percentile, worst vs float64)")
    log(tag, f"({card()}) one float32 step's momentum buffers against "
             f"float64's (median / 90th percentile / worst over "
             f"{len(card64_bufs[0])} tensors of max abs diff / max abs): "
             f"card {on_card!r}, CPU {on_cpu!r}; the card's median within "
             f"{TSP_F32_RATIO} x the CPU's")


def phase_tsp(dev) -> None:
    """Phase 28: the TSP backbone at full width (see the docstring)."""
    import copy as copy_module

    from gvl_tpu_torch import import_cli
    from gvl_tpu_torch.backbone import train_tsp, tsp
    tag = "tsp"
    try:
        import cv2  # noqa: F401
        has_cv2 = True
    except ImportError:
        has_cv2 = False
        log(tag, "cv2 is not installed on this machine: extraction runs "
                 "from decoded frames (extract_clip_features); "
                 "decode_video_frames raises ImportError naming cv2")
        try:
            tsp.decode_video_frames("missing.mp4")
            check(False, "decode_video_frames without cv2")
        except ImportError as e:
            check("cv2" in str(e), f"the ImportError names cv2: {e}")
    rs = np.random.RandomState(SEED)
    T, Hc, Wc = TSP_CLIP
    videos = []
    for n in TSP_VIDEO_FRAMES:
        frames = rs.rand(n, Hc, Wc, 3).astype(np.float32)
        videos.append(tsp.make_clips((frames - tsp.CLIP_MEAN) / tsp.CLIP_STD,
                                     T, T))
    model = tsp.build_extractor(TSP_BACKBONE, device=dev)
    check(model.features.stem[1].eps == 1e-3, "r2plus1d_34's BatchNorm eps")
    feats = [tsp.extract_clip_features(model, c, TSP_EXTRACT_B)
             for c in videos]
    check([f.shape for f in feats] == [(len(c), 512) for c in videos]
          and all(np.isfinite(f).all() for f in feats), "feature shapes")
    cpu = copy_module.deepcopy(model).cpu()
    ref = tsp.extract_clip_features(cpu, videos[0][:2], 2)
    err = np.abs(feats[0][:2] - ref).max() / np.abs(ref).max()
    check(err <= TSP_FEATURE_TOL, f"{tag}: card vs CPU features {err}")
    del cpu
    clips = np.concatenate(videos)
    ms = cuda_median_ms(
        lambda: tsp.extract_clip_features(model, clips, TSP_EXTRACT_B), 3, 1)
    log(tag, f"({card()}) extraction {TSP_BACKBONE}, {T}x{Hc}x{Wc} clips, "
             f"batch {TSP_EXTRACT_B}: {len(videos)} videos -> "
             f"{[f.shape for f in feats]}; card vs CPU on 2 clips, max abs "
             f"diff / max abs {err!r} (<= {TSP_FEATURE_TOL}); {len(clips)} "
             f"clips in {ms!r} ms (median of 3, CUDA events, copies "
             f"included): {len(clips) / ms * 1e3!r} clips/s")
    if has_cv2:
        with tempfile.TemporaryDirectory() as tmp:
            import cv2
            path = f"{tmp}/v0.avi"
            vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 15,
                                 (160, 120))
            for _ in range(40):
                vw.write(rs.randint(0, 255, (120, 160, 3), np.uint8))
            vw.release()
            written = tsp.extract_features([path], f"{tmp}/feats",
                                           model=model)
            check(np.load(written[0]).shape == (3, 512), "extract_features")
            log(tag, "cv2 present: extract_features on a written video, "
                     f"{np.load(written[0]).shape}")
    del model
    free_device_memory()

    cfg = train_tsp.TSPTrainConfig(backbone=TSP_BACKBONE,
                                   num_classes_list=TSP_HEADS, use_gvf=True,
                                   backbone_lr=1e-4, epochs=1)

    def batches(n, seed, B=TSP_TRAIN_B):
        r = np.random.RandomState(seed)
        for _ in range(n):
            yield {"clips": r.randn(B, T, Hc, Wc, 3).astype(np.float32),
                   "labels": [r.randint(0, TSP_HEADS[0], B),
                              r.randint(-1, TSP_HEADS[1], B)],
                   "gvf": r.randn(B, 512).astype(np.float32)}

    tsp_step_card_vs_cpu(tag, cfg, dev, list(batches(
        2, SEED + 2, TSP_CHECK_B)))
    torch.cuda.reset_peak_memory_stats()
    trainer = train_tsp.TSPTrainer(cfg, lambda ep: batches(TSP_STEPS, SEED),
                                   lambda: batches(1, SEED + 1),
                                   steps_per_epoch=TSP_STEPS, device=dev)
    stem0 = {k: v.clone() for k, v in trainer.model.state_dict().items()
             if k.startswith("features.stem.") and k.endswith(("weight",
                                                                 "bias"))}
    body0 = trainer.model.features.layer4[0].conv1[0][0].weight.clone()
    times, real_step = [], trainer._step

    def timed_step(batch, seed=None):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        metrics = real_step(batch, seed)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
        return metrics

    trainer._step = timed_step
    history = trainer.fit()
    peak = torch.cuda.max_memory_allocated()
    h = history[0]
    check(len(times) == TSP_STEPS and all(
        math.isfinite(v) for v in h.values()), f"{tag}: history {h}")
    check(all(torch.equal(trainer.model.state_dict()[k], v)
              for k, v in stem0.items()), f"{tag}: the frozen stem moved")
    check(not torch.equal(trainer.model.features.layer4[0].conv1[0][0].weight,
                          body0), f"{tag}: the residual stages did not move")
    log(tag, f"({card()}) TSPTrainer {TSP_BACKBONE}, heads {TSP_HEADS} + "
             f"GVF 512, batch {TSP_TRAIN_B} of {T}x{Hc}x{Wc}: "
             f"{TSP_STEPS} steps {[round(t, 2) for t in times]} ms (median "
             f"{statistics.median(times)!r} ms, the first with cuDNN's "
             f"set-up), one validation batch; peak device memory "
             f"{peak / 2**30!r} GiB; history {json.dumps(h)}; the stem "
             "unchanged, layer4 moved")

    with tempfile.TemporaryDirectory() as tmp:
        sd = trainer.model.state_dict()
        torch.save({"model": {k: v.cpu() for k, v in sd.items()}},
                   f"{tmp}/tsp.pth")
        res = import_cli.main(["--backbone", TSP_BACKBONE, "--pth",
                               f"{tmp}/tsp.pth", "--out", f"{tmp}/bb"])
        check(res["unused"] == res["unfilled"] == [], f"{tag}: import {res}")
        model = tsp.build_extractor(TSP_BACKBONE, res["path"], dev)
        got = tsp.extract_clip_features(model, videos[1], TSP_EXTRACT_B)
        want = tsp.extract_clip_features(trainer.model, videos[1],
                                         TSP_EXTRACT_B)
        check(np.array_equal(got, want), f"{tag}: imported features")
        log(tag, f"the trained model as a torchvision-named .pth "
                 f"(features.*, fc1, fc2) -> import_cli --backbone in "
                 f"{res['seconds']!r} s -> extract_features' model: its "
                 f"features on {len(videos[1])} clips equal the trainer's")
    del trainer, model
    free_device_memory()


# work -> (floats moved as multiples of value, out and the taps; FMAs per
# tap and channel). fwd: value, loc, attn in, out out. bwd: value, grad_out,
# loc, attn in, grad_value, grad_loc, grad_attn out; two dot products and
# two scatter-adds. Its value kernel: grad_out, loc, attn in, grad_value out,
# the scatter-adds; its dot kernel: value, grad_out, loc, attn in, grad_loc,
# grad_attn out, the dot products.
BOUND_WORK = {"fwd": ((1, 1, 2), 2), "bwd": ((2, 1, 4), 4),
              "bwd_value": ((1, 1, 2), 2), "bwd_dot": ((1, 1, 4), 2)}


def msda_bound(B: int, S: int, Lq: int, work: str,
               attn_bytes: int = 4) -> dict:
    """The least time the card could take for one call (or one of the
    backward's two CUDA kernels, BOUND_WORK) at these sizes with H, Dh and
    K=16: each input read once and each output written once at the memory
    rate, against the FMAs at the f32 rate. The banded kernels move the same
    bytes and do the same FMAs as the dense ones at Lq == S. attn_bytes: 2
    for the bf16 attn of the bf16-tap forms."""
    (n_value, n_out, n_taps), fmas = BOUND_WORK[work]
    K = 4 * P
    value, out, taps = B * S * H * DH, B * Lq * H * DH, B * Lq * H * K
    n_bytes = 4 * (n_value * value + n_out * out + n_taps * taps) \
        - (4 - attn_bytes) * taps
    flops = 2 * fmas * taps * DH
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / F32_FLOP_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_flops),
                bound_by="bytes" if t_bytes >= t_flops else "operations",
                bytes=n_bytes, flops=flops)


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
                         "13, 19); prints no result line")
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
    kv.update(phase_bf16_taps_vs_plain(dev))
    if args.kernels_only:
        return
    launches = {}
    f32_train = None
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
        if w is ANET:
            launches.update(phase_eval_options(w, model,
                                               runner.text_encoder))
            launches["anet_eval_cli"] = phase_eval_cli(w, dev)
        else:
            launches["longvideo_full_bf16"] = phase_longvideo_full_bf16(
                w, model, runner.text_encoder)
        del model, runner
        if w is ANET:
            torch.cuda.empty_cache()
            launches.update(phase_train_cli_and_scst(w, dev))
        tmodel, state, step, weights, batches = build_train(w, dev)
        # phase 10 before phase 9: see the docstring
        phase_train_paths_agree(w, tmodel, step, weights, batches[0],
                                state.text_encoder if w.trains_text else None)
        launches[f"{w.name}_train"] = phase_train_main_path(
            w, tmodel, state, step, weights, batches)
        f32_train = phase_train_time(w, state, step, weights, batches)
        if args.profile:
            phase_train_profile(w, state, step, weights, batches, args.profile)
        del tmodel, state, step
        torch.cuda.empty_cache()
        if w is LONG:
            launches.update(phase_remat(w, dev))
        if w is ANET:
            text = load_text(ANET, dev)
            launches.update(phase_remat(w, dev, text))
            launches.update(phase_heads(dev, text))
            launches.update(phase_head_layouts(dev, text))
            launches["anet_cap_bf16_train"] = phase_caption_bf16_train(
                dev, text, f32_train)
            launches.update(phase_gpt2(dev, text))
            launches.update(phase_tal(dev, text))
            launches.update(phase_train_options(dev, text))
            del text
            launches.update(phase_published(dev))
            phase_tsp(dev)
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
             "gvl_tpu/ops/ms_deform_attn_banded.py:92"),
            ("fwd_bf16", bf16_row, "ms_deform_attn_fwd_bf16taps",
             "gvl_tpu_torch/csrc/ms_deform_attn_fwd.cu",
             "gvl_tpu/ops/ms_deform_attn.py:217"),
            ("banded_fwd_bf16", bf16_row, "ms_deform_attn_banded_fwd_bf16taps",
             "gvl_tpu_torch/csrc/ms_deform_attn_banded_fwd.cu",
             "gvl_tpu/ops/ms_deform_attn_banded.py:65")):
        by_path = {path: counts[key] for path, counts in launches.items()}
        rows.append(row(rname, source, replaces, by_path, kv[key],
                        key.startswith("banded") if row is bf16_row
                        else key.endswith("bwd")))
    # each kernel of a path was launched on that path
    paths = {f"{w.name}_{'train' if train else 'eval'}": (w, train)
             for w in (ANET, LONG) for train in (False, True)}
    paths["anet_eval_cli"] = (ANET, False)
    paths["anet_train_cli"] = paths["anet_scst"] = (ANET, True)
    for path in ("anet_gpt2_f32_eval", "anet_gpt2_early_exit_eval",
                 "anet_gpt2_decode_bf16_eval", "anet_tal_probe_eval",
                 "anet_tal_zeroshot_eval"):
        paths[path] = (ANET, False)
    paths["anet_published_eval_cli"] = (ANET, False)
    paths["anet_gt_proposals_eval"] = (ANET, False)
    for path in ("anet_gpt2_train", "anet_gpt2_small_train",
                 "anet_tal_probe_train", "anet_remat_train",
                 "anet_published_gpt2_train", "anet_published_train_cli",
                 "anet_caption_cost_train", "anet_ss_train",
                 "anet_gt_proposals_train"):
        paths[path] = (ANET, True)
    paths["longvideo_remat_train"] = (LONG, True)
    for path, (w, train) in paths.items():
        for key, n in want_counts(w, 1, train).items():
            check((launches[path][key] > 0) == (n > 0),
                  f"{path}: {key} launched {launches[path][key]} times")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
