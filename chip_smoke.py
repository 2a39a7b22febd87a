#!/usr/bin/env python3
"""Drive the PyTorch port (adaptive_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--profile DIR]

Builds the port's CUDA kernels from adaptive_tpu_torch/ops/cuda/csrc, then:

1. prints the card (nvidia-smi name and power limit), torch/CUDA versions
   and the kernel build time;
2. holds the greedy kernels (the cell, the argmax head) against their plain
   PyTorch twins at the greedy path's shapes (batch 1024, H 512, 2E 512,
   K = D = 49, vocab 10123 padded to 10240), in fp32 and bf16, and times
   kernel, twin and library call; the cell names its instance and plan
   (ops/fused_step.py::cell_instance, cell_plan) and, for the bf16
   tensor-core instance, times each of its two stages alone; the head and
   its library call twice:
   launches back to back (the 10.5 MB weight warm in the 50 MB L2) and
   each launch after a 256 MB write (L2 cold, as after the cell kernel);
2b. does the same for the beam kernels (the beam-major cell, the top-W
   head) at the beam path's shapes: 1024 images x beam 3 = 3072 rows, V/pv
   one copy per image; plus a correctness-only pass at beam 5;
2c. holds the int8 encoder's kernels (the fused identity bottleneck block,
   the fused tail + next conv1) against their twins and against the int8
   carry's own unfused code at batch 1024 (seeded s8 inputs): kernel 5 at
   ResNet-152's four bottleneck layer shapes, kernel 6 at the seven shapes
   a decode launches it at (within a layer, and into the next layer's
   block 0 with twice the width); times kernel, twin and unfused segment
   beside the bound, with each kernel's launch plan (rows or images a
   block, chunks, shared bytes, blocks an SM); plus a correctness-only pass
   of each at 3 images of 13 x 13;
2d. holds kernel 7, the float encoder's conv epilogue (bias, residual and
   relu in one pass), at each shape of one ResNet-152 encode at batch 1024
   against its twin in bf16 and fp32 (equal) and, in fp32, against the
   separate PyTorch passes it replaces (equal); times kernel, twin and those
   passes, summed over the encode's 151 launches, beside the bound of the
   kernel's bytes;
2e. holds kernel 8, the hybrid LM's Mamba-2 decode step, at batch 1024 and
   granite-4.0-h-micro's widths in bf16 (xbc and dt strided slices of an
   in_proj output) against its twin: one launch a call, y and the state
   within one bf16 rounding, the conv state equal; times kernel and twin
   beside the bound of the kernel's bytes;
3. runs the greedy path end to end in bf16 at full width: build_model ->
   make_greedy_decoder -> greedy captions for 1024 seeded uint8 256x256
   images with a seeded random ResNet-152 / H 512 model; checks that each
   kernel launched exactly once per decode step (kernel 7 151 times a
   decode, once an encode's conv but the downsamples) and that the outputs are
   well formed, and times the decode and the encoder alone (mean of
   E2E_REPEATS runs); --profile adds a torch.profiler kernel table;
3b. runs beam search (beam 3) end to end on the same model and images:
   make_beam_decoder; checks that the beam kernels launched once per step
   and the greedy ones not at all, that ids, scores, attention and beta are
   well formed, and times it as phase 3 does (--profile: a second table);
3c. runs the granite_h_micro variant (a hybrid Mamba-2/attention language
   model over the trunk's 49 image tokens, published widths, vocab
   100,352, seeded random weights) greedily end to end on the same images:
   kernel 8 launched 36 times a step (1,080 a decode), kernel 7 151 times,
   no other kernel; ids in the vocab, attention and beta of zero width;
   times it as phase 3 does (--profile: a table);
5. runs the int8 encoder end to end in bf16 on the same model and images:
   build_model(encoder_quant="int8") -> calibrate_model (32 images) ->
   make_greedy_decoder, in mode (a) per-channel scales, s2d stem, no fused
   kernels (the bench's default); (b) per-tensor scales with every
   layer's identity blocks through the fused block kernel (45 launches a
   decode); (c) per-tensor scales with every layer's tails through the
   fused tail kernel (45 launches); and (t) per-tensor scales without
   kernels, the control against which (b)'s and (c)'s features are held;
   each timed as phase 3 (--profile: a table for mode (a));
4. decodes 8 images greedily in fp32 (TF32 off) on the card and on the CPU
   (plain twins) and requires equal ids, except where the first differing
   step's fp32 top-2 logit gap is below 1e-3, and attention and beta within
   PARITY_ATOL up to that step;
4b. beam-decodes the same 8 images (beam 3) on both and requires equal
   beams, except for an image whose CPU decode had two adjacent flat
   candidates (of the top W+1) within PARITY_GAP_EPS at some step; scores
   within 1e-3 and attention and beta within PARITY_ATOL where equal;
6. runs the int8 encoder in fp32 on 8 seeded images at the crop size on
   the card and on the CPU, in modes (a) and (c) with the card's scales
   handed to both: trunk features within phase 5's bound (0 elements should
   differ), greedy ids under phase 4's rule.

7. runs the eval driver (evalcap/coco_eval.py::coco_eval) in bf16 on phase
   3's model over a 5,000-image synthetic split (5 reference captions an
   image; the images seeded_images at 256 px, served from memory through
   coco_eval's dataset=) at eval batch 400: greedy, beam 3 and int8 (a)
   calibrated inside the driver. Checks the launches (13 batches x 30
   steps of kernels 1 and 2, or 3 and 4) and the results (one an image),
   and prints images/s with the wall time split into decode, results JSON,
   annotation loads and each scorer;
7b. runs coco_eval in fp32 (TF32 off) on a 16-image split at batch 12 on
   the card and on the CPU (phase 4's models), greedy and beam 3: equal
   results, CIDEr and per-image scores, a differing caption only under the
   gap rules of phases 4 and 4b; then valid mode on the card from a
   model.npz of the same weights ("auto"), equal to the in-memory run.

8. trains (training/): 8a make_train_step at full width in bf16, batch
   256, captions in bucket 24, with the encoder off and on (fine-tuning
   layers 2-4): images/s (mean of 10 steps after 2), peak allocated
   memory, the step's convolution and matmul TFLOP (FlopCounterMode) and
   their share of the bf16 peak, finite losses (--profile: a table each);
   8b main_train end to end in bf16 on a 1,024-image split in memory, 2
   epochs (encoder on in the second), a step checkpoint every 2 steps, the
   per-epoch eval on 400-image train_eval and val splits in memory:
   launches of kernels 1 and 2 (2 epochs x 2 evals x 30 steps), the epoch
   checkpoints (the step ones pruned), valid mode "auto" restoring the best
   one and writing its epoch's captions; 8c one fp32 step (TF32 off), encoder
   off and on, card vs CPU from phase 4's weights at batch 4: loss, LSTM
   grad norm, BN statistics and weights within their bounds.

9. trains with L-BFGS groups (training/lbfgs.py) and runs the CLI: 9a
   make_lbfgs_train_step at full width in bf16, batch 256, the reference's
   settings (lr 0.5 / 0.01, max_iter 20, history 50), (i) decoder L-BFGS
   with the encoder off, (ii) with encoder Adam on, (iv) both L-BFGS: ms a
   step, images/s, loss evaluations and inner iterations a step, peak
   allocated memory, the curvature pairs' GiB, finite losses (--profile: a
   table each); 9b two decoder L-BFGS steps in fp32 (max_iter 4, history 3)
   card vs CPU at batch 4 from phase 4's weights and from weights whose BN
   was calibrated on 32 other images, beside the CPU against itself at
   another thread count and a float64 run on the CPU; 9c adaptive_tpu_torch.main on a config
   file: Karpathy split, vocab, 1 epoch of decoder L-BFGS with the eval,
   valid and test "auto", at full width on a 2,000-image origin served from
   memory (image_source=): the experiment dir, the split files, the
   vocabulary, the checkpoint's L-BFGS memory, the launches of kernels 1
   and 2, the results and each stage's seconds.

10. serves and exports (serving.py, export.py) and runs the int8 gate:
   10a CaptionService at batch 32 (max wait 20 ms) on a seeded full-width
   bf16 model, greedy on the exact encoder, int8 (a) and beam 3: 64 seeded
   images served in waves of 32 from client threads give the captions of a
   direct decode of the same images; the service's worker launched kernels
   1 and 2 (3 and 4) 30 times a batch while the caller launched nothing;
   requests == completed + errors + shed + invalid + timeouts; the weights
   prepared once; device_decode_ms (a batch on the card, utils/profiling.py::
   Timer) and an open-loop sweep of 3 rates (tools/torch_serving_bench.py::
   run_level: p50/p90/p99, shed share, goodput); 10b the greedy decoder
   exported at batch 8 (torch.export through the kernels' torch.library
   operators), saved, loaded and run: ids equal the in-process decoder's,
   beta within 1e-6, and a torch.profiler trace of one call (read by
   utils/trace_report.py) shows 30 launches of each of kernels 1 and 2;
   10c tools/torch_int8_gate.py at 128 images and 2 epochs: all six modes
   scored, (b) and (c) captioning every image as per-tensor (t) does.

11. runs the multi-device path (parallel/, decoding/spmd.py) at the widths
   of configs/coco_adaptive_v5e8.py, loaded through load_config, with
   seeded weights as phase 3 makes them: kernel 4 on each 5,120-column
   vocab shard against its twin at the greedy (W = 1) and beam-3 shapes,
   timed beside the bound and the library call; then 2 ranks, child
   processes of this script on cuda:0 over gloo (a file store under
   TMPDIR): 11a tensor-parallel decodes at mesh (1, 2), batch 256, greedy
   and beam 3 (each rank's kernel 4 on its shard 30 times a decode, kernel
   2 never), equal to one process's decode on the card under phases 4's
   and 4b's rules; 11b coco_eval in fp32 at mesh (2, 1) over 512 seeded
   images (the ids gathered, rank 1's .proc1 file), equal to one
   process's; 11c one fp32 step at mesh (2, 1), batch 8, encoder on,
   Adam/Adam, against one process's step on the card (a gloo world of 1),
   again with ZeRO-1 (each rank half of each sharded moment's bytes) and
   once with a decoder L-BFGS group (loss, n_iter, t); 11d bf16 steps at
   batch 256 (2 x 128, the config's 2 microbatches): ms a step, the
   collectives' share of a profiled step and the BN all-reduces counted,
   which is not a scaling figure (both ranks share one card); 11e
   adaptive_tpu_torch.main with distributed_init (a world of 1 over nccl)
   on 256 images for 1 epoch, equal to the run without a process group in
   its loss history and CIDEr.

12. runs the other two decoder variants, baseline_attention (spatial
   attention) and rnn_attention (sigmoid gates and a bidirectional LSTM
   over the slots, hr 256), at the published widths with seeded weights and
   BN calibrated as in phase 3; their cells run op by op, their vocab
   heads through kernels 2 and 4: 12a greedy and beam 3 in bf16 at batch
   1024 on phase 3's images (captions/s, encoder and decode-loop ms;
   kernel 2 or 4 launched STEPS times a decode, kernels 1 and 3 never;
   ids, scores and maps well formed, beta zero), and a decode step's host
   time against the card's busy time (torch.profiler); 12b 8 fp32 captions
   and beams card vs CPU under phases 4's and 4b's rules; 12c one fp32
   train step card vs CPU, encoder off and on, under phase 8c's bounds, and
   phase 8a's bf16 step at batch 256 with the encoder off; 12d
   save_checkpoint, restore_model into a fresh net, and coco_eval greedy
   on a 400-image split served from memory (kernel 2's launches), and the
   baseline's greedy decoder exported at batch 8 (ids equal).

13. runs the conv-backward experiment (ops/quant_conv.py) and the COCO
   detection API, none of the eight kernels (their counts set to 0 before
   and read after): 13a each stride-1 conv shape of ResNet-152's layers
   2-4 in bf16, the int8 backward against its CPU twin at 8 images
   (operands, scales and int32 counts equal, dx and dw within 1 ulp),
   "manual" against cuDNN's backward at batch 256 within QC_MANUAL_REL,
   the three backwards timed at batch 256 and the largest |count| as a
   share of 2^31; 13b phase 8a's step in modes "manual" and "int8" beside
   8a's "none" (images/s, peak memory, busy
   share from a profile of one step; per layer group the gradients' cosine
   and relative error against "none"'s, printed), and one fp32 "manual"
   step against "none" at batch 4 under phase 8c's bounds; 13c the native
   mask and JSON libraries built with g++ on the card's host and loaded,
   fast_json's columns against the stdlib parse, COCOeval bbox (500
   images) and segm (the first 100) on a seeded set of COCO val's shape
   (80 categories, ~7 ground truths an image, up to 100 detections): load,
   evaluate and accumulate seconds and the stats.

14. runs the JAX package's configurations that phases 1-13 never set,
   each launch count set to 0 just before a run and read just after: 14a
   decode_early_exit on phase 3's weights (rebuilt from its seed), greedy
   and beam 3 at batch 1024: ids and beams equal to the fixed loop's and
   captions/s of both, then with the <end> logit's bias raised by 3 and by
   1e4 (every row ends at once): the cell and head kernels launched once a
   step actually run, attention and beta 0 after the exit; 14b beam widths
   5 and 8 end to end in bf16 (kernels 3 and 4 once a step), and fp32 card
   vs CPU at W = 5 and at W = 3 with length_alpha 0.7 under phase 4b's
   rule; 14c the int8 encoder under baseline_attention and rnn_attention:
   phase 6's check on each, the baseline in bf16 in modes (a) and (b)
   (kernel 5 45 times a decode) and rnn in mode (a), then
   encoder_quant_bias_correct in mode (a), fp32 card vs CPU, its
   corrections held to calibrate_int8_bias's invariant; 14d
   tools/torch_layer_bench.py's per-conv-shape int8 table at batch 512
   (24 shapes, 155 convs) after each shape's int32 accumulator on the card
   equals the CPU's at batch 2; 14e remat_encoder in bf16 at batch 256 and
   in fp32 against the plain step, a bf16 step at batch 512, and SGD in
   both groups, fp32 card vs CPU under phase 8c's bounds and bf16 timed.

Phases run in the order 1, 2, 2b, 3, 3b, 2c, 2d, 2e, 3c, 5, 4, 4b, 6, 7, 7b, 8a,
8b, 8c, 9a, 9b, 9c, 10a, 10b, 10c, 11, 12, 13a, 13b, 13c, 14a, 14b, 14c, 14d, 14e.

Prints at the end of phase 14 one JSON line of each of its sub-phases
({"phase14a_early_exit": ...} to {"phase14e_train": ...}), then one JSON
line of per-kernel numbers (kernel 4's entry with its shard
numbers), one of the eval driver's numbers ({"eval_driver": ...}), one of
training's ({"train": ...}), one of the L-BFGS step's ({"lbfgs": ...}), one
of the CLI's ({"cli": ...}), one of serving's, the export's and the gate's
({"serving": ...}), one of phase 11's ({"multi_device": ...}), one of phase
12's ({"variants": ...}), one of phase 13a's and 13b's ({"conv_bwd_quant":
...}) and one of 13c's ({"detection": ...}), then as its last line
{"ok": true, "device": {...}}. Any failed check raises: the exit code is
then non-zero and no result line is printed. Exits 2 without a result where
there is no CUDA card or the package is not beside this script.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# main-path shapes: adaptive_attention, ResNet-152 at 224 px, embed 256,
# hidden 512, vocab 10123 (head padded to 10240), 30 steps, batch 1024
B, H, E2, K, D, VOCAB, VP, STEPS = 1024, 512, 512, 49, 49, 10123, 10240, 30
BEAM = 3  # beam path: B images x BEAM rows (bench.py --beam 3)
SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
# Tolerances, kernel vs plain twin on the same inputs. fp32: sums in another
# order, |err| <= 1e-5 + 1e-5 |ref|. bf16 outputs (h, c, c_hat): one bf16
# rounding step, |err| <= 1e-5 + 2^-7 |ref|. alpha/beta are fp32 in both.
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-5, 2.0 ** -7)}
# head ids may differ only where the row's fp32 top-2 logit gap is below this
HEAD_GAP_EPS = 1e-3
PARITY_GAP_EPS = 1e-3  # phases 4 and 4b: CPU vs card ids
BEAM_SCORE_ATOL = 1e-3  # phase 4b: summed fp32 log-probs over 30 steps
LSE_RTOL = 1e-5  # top-W head's logsumexp, kernel vs twin
# phase 4: attention and beta, card vs CPU in fp32 (the repo's bound for the
# greedy path against the JAX package: sums in another order through the
# 152-layer encoder and 30 steps)
PARITY_ATOL = 2e-4
E2E_REPEATS = 3  # phase 3: timed end-to-end runs after the warm-up
# int8 encoder (phases 2c, 5, 6): ResNet-152's bottleneck layers as (H = W,
# C, M, identity blocks that are not the last block = launches of kernel 5,
# and of kernel 6, in one decode: 2 + 7 + 35 + 1 = 45)
INT8_LAYERS = ((56, 256, 64, 2), (28, 512, 128, 7), (14, 1024, 256, 35), (7, 2048, 512, 1))
# kernel 6's launches by shape (H = W, C, M, M2, launches a decode): within a
# layer (M2 = M) and, from a layer's last identity block, into the next
# layer's block 0 (M2 = 2M; models/infer.py): 1 + 1, 6 + 1, 34 + 1, 1
INT8_TAILS = ((56, 256, 64, 64, 1), (56, 256, 64, 128, 1), (28, 512, 128, 128, 6),
              (28, 512, 128, 256, 1), (14, 1024, 256, 256, 34), (14, 1024, 256, 512, 1),
              (7, 2048, 512, 512, 1))
INT8_FUSED = ("layer1", "layer2", "layer3", "layer4")
INT8_LAUNCHES = sum(n for *_, n in INT8_LAYERS)
# kernel 7 (ops/conv_epilogue.py::folded_epilogue): its launches in one
# encode of the float ResNet-152 (the stem and 3 convs a block, 50 blocks),
# and its timed launches at each of the encode's shapes (phase 2d)
ENCODE_EPILOGUES = 1 + 3 * 50
EPILOGUE_ITERS = 10
# kernel 8 (ops/ssm_step.py): its timed launches (phase 2e); phase 3c's
# granite_h_micro vocabulary (granite-4.0-h-micro's config.json)
SSM_ITERS = 20
HYBRID_VOCAB = 100352
INT8_ITERS = 5  # timed launches of each int8 kernel and its twin (ms each)
INT8_CALIB = 32  # images that calibrate_model sees
# kernels 5 and 6 against their twins: +/-1 quantum on under 0.2% of
# elements, the JAX package's bound for its Pallas kernels against XLA
# (tests/test_pallas.py); the port's epilogues are uncontracted, so 0 is
# expected
QUANTUM_SHARE = 2e-3
# phase 7: the eval driver over a split of the Karpathy val/test size, with
# COCO's 5 reference captions an image, at the reference's eval batch
# (cfg_wzn.py:84); phase 7b: a small fp32 split whose last batch is short
EVAL_IMAGES, EVAL_REFS, EVAL_BATCH, EVAL_CHUNK = 5000, 5, 400, 500
EVAL_PARITY_IMAGES, EVAL_PARITY_BATCH = 16, 12
# phase 8: training at the flagship config's batch (configs/coco_adaptive.py:33)
# with captions in bucket 24; main_train on 1,024 images (4 steps an epoch)
# with the eval on 400-image splits (one eval batch each)
TRAIN_B, TRAIN_T, TRAIN_WARMUP, TRAIN_STEPS = 256, 24, 2, 10
TRAIN_IMAGES, TRAIN_EVAL_IMAGES, TRAIN_EPOCHS, TRAIN_PARITY_B = 1024, 400, 2, 4
# phase 8c, card vs CPU in fp32 after one step: loss and LSTM grad norm
# (relative); BN running statistics (relative to max(1, |value|): calibrated
# running variances reach the hundreds); gradients (atol + rtol, the bound
# of tests/test_torch_train_step.py); weights (absolute), except that Adam's
# first update lr * g / (|g| + eps) takes the sign of a gradient that is 0
# within the gradient bound: there up to 2 lr. The gradient bound scales
# with the tensor's largest gradient: a weight gradient sums B*T or B*H*W
# products, so its rounding follows the tensor's scale, not each element's.
# Weights: two fp32 ulps of a value below 8 (the N(0, 1) embedding's reach)
TRAIN_RTOL, TRAIN_BN_TOL, TRAIN_GRAD_ATOL, TRAIN_GRAD_RTOL, TRAIN_PARAM_ATOL = (
    1e-4, 1e-5, 1e-5, 1e-4, 2e-6)
# the encoder group's gradients with the encoder on, relative to their norm:
# twice the larger of the two gaps measured on the card's machine (H100 80GB
# HBM3 at 700 W): card vs CPU 0.76%, the CPU against itself at half the
# threads 0.79% (train_parity prints both)
TRAIN_ENC_GRAD_REL = 0.0158
# phase 9: the L-BFGS groups (training/lbfgs.py) at the reference's settings
# (cfg_wzn.py:57-59,73-75: lr 0.5 / 0.01, max_iter 20, history 50); 9a at
# 8a's batch, 1 warm-up step and LBFGS_STEPS timed (each step's ms
# printed); 9b card vs CPU in fp32 at batch TRAIN_PARITY_B, two steps of
# max_iter 4 and history 3 (a pair across the batch boundary, the ring
# wraps), each step from the CPU's state before it, on two weight sets,
# beside a float64 run (lbfgs_parity says what each step is held by). Step
# 2's bounds, the decoder group's weights relative to each tensor's largest
# element and its pairs s, y relative to each row's largest, are twice the
# largest gap measured by this script on an H100 80GB HBM3 at 700 W, card vs
# CPU or the CPU against itself (PERF.md §6): weights 5.86e-4 (phase 4's
# weights, the CPU against itself), pairs 1.72e-4 (other weights, card vs
# CPU and the CPU against itself). Step 1's weights and pairs: the card's
# distance to the float64 run within LBFGS_WITNESS_RATIO times the CPU's
# plus those bounds, where no ReLU unit is across 0 from float64's at the
# first pair's points. 9c the CLI on a 2,000-image origin, 5 captions an
# image, 400-image val, test and train_eval splits, max_iter 10 (the
# reference's 20 in 9a) so that phase 9 takes ~80 s
LBFGS_STEPS = 3
LBFGS_PARITY_ITER, LBFGS_PARITY_HISTORY = 4, 3
LBFGS_PARAM_REL, LBFGS_MEMORY_REL, LBFGS_WITNESS_RATIO = 1.17e-3, 3.44e-4, 2.0
CLI_IMAGES, CLI_REFS, CLI_SPLIT, CLI_MAX_ITER = 2000, 5, 400, 10
# the Karpathy split's hyperparameter subsets (train, train_eval, val): the
# reference's 5,000 / 1,000 / 1,000 cut to the origin's size
CLI_HYPER = (1000, 200, 200)
# phase 10: serving at tools/torch_serving_bench.py's batch and window; 10a
# serves SERVE_IMAGES seeded images in waves of SERVE_B and an open-loop
# sweep of SERVE_QPS for SERVE_LEVEL_S each; 10b exports greedy at EXPORT_B;
# 10c the int8 gate (tools/torch_int8_gate.py) cut from 512 images and 7
# epochs to GATE_IMAGES and GATE_EPOCHS, fine-tuning from epoch 2 (3) so
# that the encoder group steps
SERVE_B, SERVE_WAIT_MS, SERVE_IMAGES = 32, 20.0, 64
SERVE_QPS, SERVE_LEVEL_S = (32, 256, 1024), 4.0
EXPORT_B, EXPORT_BETA_ATOL = 8, 1e-6
GATE_IMAGES, GATE_EPOCHS, GATE_FINETUNE_EPOCH = 128, 2, 2
# phase 12: the other two decoder variants at the Config defaults of their
# knobs (base_*, rnn_attention_*: the published embed 256, hidden 512; rnn
# bidirectional, 1 layer); 12a's step timing over STEP_RUNS steps; 12d's
# eval split at one eval batch
VARIANTS = ("baseline_attention", "rnn_attention")
STEP_RUNS, VARIANT_EVAL_IMAGES = 3, 400
# phase 13: the conv-backward experiment (ops/quant_conv.py). 13a: each
# stride-1 conv shape of ResNet-152's layers 2-4 as (k, Ci, Co, H = W, convs
# of that shape in a step's trunk: layer2's 8 blocks, layer3's 36, layer4's
# 3), the int8 backward held against its CPU twin at QC_TWIN_B images,
# "manual" against cuDNN's backward; both timed at TRAIN_B, QC_ITERS each
QC_SHAPES = ((1, 256, 128, 56, 1), (1, 128, 512, 28, 8), (1, 512, 128, 28, 7),
             (3, 128, 128, 28, 7), (1, 512, 256, 28, 1), (1, 256, 1024, 14, 36),
             (1, 1024, 256, 14, 35), (3, 256, 256, 14, 35), (1, 1024, 512, 14, 1),
             (1, 512, 2048, 7, 3), (1, 2048, 512, 7, 2), (3, 512, 512, 7, 2))
QC_TWIN_B, QC_ITERS, QC_STEPS = 8, 5, 4
MODES_QC = ("none", "manual", "int8")
# "manual" (fp32 contractions on the fp32 kernel, dx rounded to bf16)
# against autograd's bf16 backward (cuDNN on the kernel cast to bf16, dx
# and dw rounded to bf16): two bf16 roundings of the operands and one of
# the output, each 2^-9 of a value; held to 2^-6 of each tensor's largest
QC_MANUAL_REL = 2.0 ** -6
# 13c: COCOeval on a seeded set of COCO val's shape (80 categories, ~7
# ground truths an image, up to 100 detections), cut from 5,000 images
DET_IMAGES, DET_CATS, DET_GT, DET_MAX_DETS = 500, 80, 7, 100
# segm on the set's first DET_SEGM_IMAGES images: the mask library
# rasterises a polygon on a 5x upsampled image (masklib.cpp::rleFrPoly,
# ~12 ms at 640x480), and every ground truth's polygon is rasterised in
# COCOeval's prepare
DET_SEGM_IMAGES = 100
# phase 14: the JAX package's configurations that phases 1-13 never set.
# 14a decode_early_exit, and the <end> logit's bias raised by each of
# EXIT_BOOSTS (tests/test_torch_greedy.py::_eos_biased; 1e4 ends every row
# at once, 3.0 mid-decode at the tests' width); 14b beam widths end to end, and length_alpha
# LENGTH_ALPHA in fp32; 14d tools/torch_layer_bench.py at its default
# batch, its gate at LAYER_GATE_B; 14e a train step at TRAIN_B_LARGE, and
# remat_encoder held to the bound of tests/test_torch_train_step.py::
# test_remat_encoder_equals_plain
EXIT_BOOSTS = (3.0, 1e4)
# 3.0 ends no row on the full-width random model: mid_exit_boost looks for
# a boost at which every row of the fixed greedy loop ends after the first
# step and before the last (a mid-decode exit) up this ladder, then by
# bisection between its last boost without an exit and its first with one
MID_EXIT_LADDER, MID_EXIT_BISECTIONS = tuple(3.0 * 2 ** k for k in range(1, 12)), 16
BEAM_WIDTHS = (5, 8)
LENGTH_ALPHA = 0.7
LAYER_B, LAYER_INNER, LAYER_GATE_B = 512, 24, 2
TRAIN_B_LARGE = 512
REMAT_TOL = 1e-6


def log(msg):
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


FLUSH_BYTES = 256 << 20  # five times the 50 MB L2
_flush = []


def flush_l2():
    """Write FLUSH_BYTES on the card: evicts the L2, and keeps the card busy
    for about 0.1 ms while the host queues what follows."""
    import torch

    if not _flush:
        _flush.append(torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda"))
    _flush[0].zero_()


def warm_card(seconds=0.5):
    """Keep the card under load for a while, so that the first kernels are
    timed at its load clocks and not while they ramp up from idle."""
    import torch

    a = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            a @ a
        torch.cuda.synchronize()


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() over iters launches back to back, by CUDA
    events. About 0.3 ms of writes a launch go first, so that the host has
    queued every launch before the card reaches the first: a wrapper's host
    time (up to 0.1 ms on a busy host) would else be measured where its
    kernel is shorter."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3 * iters):
        flush_l2()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_cold_ms(fn, iters=10):
    """Mean device time of one fn() that finds the L2 cold: each launch
    follows a 256 MB write and has its own pair of events."""
    import torch

    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        for _ in range(3):  # one evicts; three keep the card busy while the host queues fn
            flush_l2()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(bytes_moved: int, flops: float, dtype: str):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and
    operations over the peak rate of the inputs' type."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, got, ref, atol, rtol) -> float:
    import torch

    g, r = got.float(), ref.float()
    err = (g - r).abs()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    bad = err > atol + rtol * r.abs()
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements past atol={atol} rtol={rtol}, "
            f"max abs err {float(err.max()):.3e}")
    return float(err.max())


def cell_stages(cell_args, W: int, cell_t):
    """The cell's instance and plan at these operands and, for the mma
    instance, each stage's ms alone (stage 1 the tensor-core gates, stage 2
    the attention), launched through decode_cell_run on the buffers of one
    run; None for the SIMT instance's one kernel."""
    import torch

    from adaptive_tpu_torch.ops import fused_step as fs

    R, Hh = cell_args[1].shape
    inst = fs.cell_instance(cell_args[1].dtype, Hh, cell_args[3].shape[1])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = fs.cell_plan(inst, R, W, sms=sms)
    if inst != "mma":
        return inst, plan, None
    out = fs.decode_cell_run(*cell_args, beam_w=W, cell_t=cell_t)
    return inst, plan, [cuda_ms(lambda st=st: fs.decode_cell_run(
        *cell_args, beam_w=W, cell_t=cell_t, stages=st, out=out)) for st in (1, 2)]


def stages_text(inst, plan, stage_ms) -> str:
    from adaptive_tpu_torch.ops import fused_step as fs

    if inst != "mma":
        return f"{inst}, {fs.CELL_SIMT_ROWS} rows a block"
    text = (f"{inst}, stage 1 {fs.CELL_BAND_ROWS} rows x {fs.CELL_UNITS} units a block, "
            f"stage 2 {plan.images} images a block")
    if stage_ms:
        text += f", stage 1 {stage_ms[0]:.4f} ms, stage 2 {stage_ms[1]:.4f} ms alone"
    return text


# ----------------------------------------------------------------- phase 2
def kernel_checks(dtype_name: str):
    import torch

    from adaptive_tpu_torch.ops import fused_step as fs

    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype_name]
    g = torch.Generator(device="cuda").manual_seed(SEED)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    # cell operands at the decode step's scales: LSTM state ~N(0,1), V >= 0
    gx = r(B, 4 * H)
    cell_args = [gx] + [t.to(dt).contiguous() for t in (
        r(B, H, scale=0.5), r(B, H), r(B, E2, scale=0.5), torch.zeros(B, H, device="cuda"),
        r(B, K, D), r(B, K, H).abs(), r(H, 4 * H, scale=H ** -0.5), r(4 * H, scale=0.1),
        r(E2, H, scale=E2 ** -0.5), r(H, H, scale=H ** -0.5), r(H, D, scale=H ** -0.5),
        r(H, D, scale=H ** -0.5), r(D, scale=D ** -0.5))]
    # the reordered weights that prepare_inference hands the mma instance
    ct = (fs.cell_kernel_tiles(*(cell_args[i] for i in (7, 9, 10, 11, 12)))
          if fs.cell_instance(dt, H, E2) == "mma" else None)
    got = fs.decode_cell(*cell_args, cell_t=ct)
    torch.cuda.synchronize()
    ref = fs.decode_cell_plain(*cell_args)
    atol, rtol = TOL[dtype_name]
    cell_err = 0.0
    for name, a, b in zip(("h", "c", "c_hat", "alpha", "beta"), got, ref):
        tol = TOL["float32"] if a.dtype == torch.float32 else (atol, rtol)
        cell_err = max(cell_err, check_close(f"cell {dtype_name} {name}", a, b, *tol))
    cell_ms = cuda_ms(lambda: fs.decode_cell(*cell_args, cell_t=ct))
    cell_plain_ms = cuda_ms(lambda: fs.decode_cell_plain(*cell_args))
    stages = cell_stages(cell_args, 1, ct)
    outs = nbytes(*got)
    cell_flops = 2.0 * B * (H * 4 * H + E2 * H + H * H + 2 * H * D + K * D + K * H)
    cell_bound = bound(nbytes(*cell_args) + outs, cell_flops, dtype_name)

    # head operands: c_hat, h ~N(0,1); W at the kaiming scale; padded bias -1e30
    W = r(H, VP, scale=(2.0 / H) ** 0.5).to(dt)
    bias = r(VP, scale=0.1)
    bias[VOCAB:] = fs.NEG
    bias = bias.to(dt)
    chat, h = r(B, H).to(dt), r(B, H).to(dt)
    # the tiled weight that prepare_greedy_head hands the bf16 instance
    Wt = fs.head_kernel_tiles(W) if fs.head_instance(dt, H) == "mma" else None

    def head():
        return fs.greedy_head_argmax(W, bias, chat, h, VOCAB, head_kernel_t=Wt)

    ids = head()
    torch.cuda.synchronize()
    ref_ids = fs.greedy_head_argmax_plain(W, bias, chat, h, VOCAB)
    logits = (chat + h).to(dt).float() @ W.float() + bias.float()
    logits[:, VOCAB:] = fs.NEG
    top2 = logits.topk(2, dim=1).values
    gap = top2[:, 0] - top2[:, 1]
    diff = ids != ref_ids
    # the twin's logit shortfall of the kernel's pick: 0 where the ids agree
    head_err = float((logits.gather(1, ref_ids[:, None].long())
                      - logits.gather(1, ids[:, None].long())).abs().max())
    if (diff & (gap >= HEAD_GAP_EPS)).any():
        raise AssertionError(
            f"head {dtype_name}: {int(diff.sum())} ids differ, some at top-2 gap >= {HEAD_GAP_EPS}")
    head_ms, head_cold_ms = cuda_ms(head), cuda_cold_ms(head)
    head_plain_ms = cuda_ms(lambda: fs.greedy_head_argmax_plain(W, bias, chat, h, VOCAB))
    z = (chat + h).to(dt)

    def library():
        return torch.addmm(bias, z, W).argmax(dim=1)

    head_lib_ms, head_lib_cold_ms = cuda_ms(library), cuda_cold_ms(library)
    head_bound = bound(nbytes(W, bias, chat, h) + B * 4, 2.0 * B * H * VP, dtype_name)
    log(f"[kernels {dtype_name}] cell ({stages_text(*stages)}): max_abs_err {cell_err:.3e} "
        f"kernel {cell_ms:.4f} ms plain {cell_plain_ms:.4f} ms bound {cell_bound[0]:.4f} ms "
        f"({cell_bound[1]}) | "
        f"head ({fs.head_instance(dt, H)}): {int(diff.sum())}/{B} ids differ (all at top-2 gap "
        f"< {HEAD_GAP_EPS}), kernel {head_ms:.4f} ms (L2 cold {head_cold_ms:.4f}) plain "
        f"{head_plain_ms:.4f} ms addmm+argmax {head_lib_ms:.4f} ms (L2 cold "
        f"{head_lib_cold_ms:.4f}) bound {head_bound[0]:.4f} ms ({head_bound[1]})")
    return {
        "adaptive_decode_cell_fused": {
            "max_abs_err": cell_err, "ms": cell_ms, "plain_ms": cell_plain_ms,
            "bound_ms": cell_bound[0], "bound_by": cell_bound[1], "library_ms": None,
            "instance": stages[0], "plan": stages[1]._asdict(), "stage_ms": stages[2]},
        "greedy_head_argmax": {
            "max_abs_err": head_err,
            "ids_differ": int(diff.sum()), "ms": head_ms, "cold_ms": head_cold_ms,
            "plain_ms": head_plain_ms, "bound_ms": head_bound[0], "bound_by": head_bound[1],
            "library_ms": head_lib_ms, "library_cold_ms": head_lib_cold_ms},
    }


# ---------------------------------------------------------------- phase 2b
def topk_checks(name, got, ref, logits, W):
    """Top-W head, kernel against twin: ids may differ only where two
    adjacent fp32 logits of the twin's sorted row (top W+1) lie within
    HEAD_GAP_EPS; values on agreeing rows within the fp32 TOL, lse within
    LSE_RTOL. Returns (max abs err of values and lse, rows that differ)."""
    import torch

    tv, ti, lse = got
    rv, ri, rlse = ref
    top = logits.sort(dim=1, descending=True).values[:, :W + 1]
    gaps = top[:, :-1] - top[:, 1:]
    near = gaps < HEAD_GAP_EPS
    near[:, 1:] |= gaps[:, :-1] < HEAD_GAP_EPS
    diff = ti != ri
    if (diff & ~near).any():
        raise AssertionError(f"{name}: top-W ids differ at adjacent logit gaps >= {HEAD_GAP_EPS}")
    same = ~diff.any(1)
    err = check_close(f"{name} topv", tv[same], rv[same], *TOL["float32"])
    return max(err, check_close(f"{name} lse", lse, rlse, 0.0, LSE_RTOL)), int((~same).sum())


def beam_kernel_checks(dtype_name: str, W: int, timed: bool = True):
    """Kernels 3 and 4 against their twins at the beam path's shapes: B
    images x W beam rows, V/pv one copy per image."""
    import torch

    from adaptive_tpu_torch.ops import fused_step as fs

    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype_name]
    g = torch.Generator(device="cuda").manual_seed(SEED + W)
    R = B * W

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    cell_args = [r(R, 4 * H)] + [t.to(dt).contiguous() for t in (
        r(R, H, scale=0.5), r(R, H), r(R, E2, scale=0.5), torch.zeros(R, H, device="cuda"),
        r(B, K, D), r(B, K, H).abs(), r(H, 4 * H, scale=H ** -0.5), r(4 * H, scale=0.1),
        r(E2, H, scale=E2 ** -0.5), r(H, H, scale=H ** -0.5), r(H, D, scale=H ** -0.5),
        r(H, D, scale=H ** -0.5), r(D, scale=D ** -0.5))]
    ct = (fs.cell_kernel_tiles(*(cell_args[i] for i in (7, 9, 10, 11, 12)))
          if fs.cell_instance(dt, H, E2) == "mma" else None)
    got = fs.decode_cell(*cell_args, beam_w=W, cell_t=ct)
    torch.cuda.synchronize()
    ref = fs.decode_cell_plain(*cell_args, beam_w=W)
    cell_err = 0.0
    for name, a, b in zip(("h", "c", "c_hat", "alpha", "beta"), got, ref):
        tol = TOL["float32"] if a.dtype == torch.float32 else TOL[dtype_name]
        cell_err = max(cell_err, check_close(f"beam cell W={W} {dtype_name} {name}", a, b, *tol))

    Wt = r(H, VP, scale=(2.0 / H) ** 0.5).to(dt)
    bias = r(VP, scale=0.1)
    bias[VOCAB:] = fs.NEG
    bias = bias.to(dt)
    chat, h = r(R, H).to(dt), r(R, H).to(dt)
    Wtt = fs.head_kernel_tiles(Wt) if fs.head_instance(dt, H) == "mma" else None

    def head():
        return fs.beam_head_topk(Wt, bias, chat, h, VOCAB, W, head_kernel_t=Wtt)

    top = head()
    torch.cuda.synchronize()
    ref_top = fs.beam_head_topk_plain(Wt, bias, chat, h, VOCAB, W)
    logits = (chat + h).to(dt).float() @ Wt.float() + bias.float()
    logits[:, VOCAB:] = fs.NEG
    head_err, rows_differ = topk_checks(f"topk head W={W} {dtype_name}", top, ref_top, logits, W)
    inst = fs.cell_instance(dt, H, E2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = fs.cell_plan(inst, R, W, sms=sms)
    log(f"[beam kernels {dtype_name} W={W}] cell ({stages_text(inst, plan, None)}): "
        f"max_abs_err {cell_err:.3e} | top-W head: "
        f"max_abs_err {head_err:.3e}, {rows_differ}/{R} rows' ids differ (all at adjacent "
        f"gaps < {HEAD_GAP_EPS})")
    if not timed:
        return None

    cell_ms = cuda_ms(lambda: fs.decode_cell(*cell_args, beam_w=W, cell_t=ct))
    cell_plain_ms = cuda_ms(lambda: fs.decode_cell_plain(*cell_args, beam_w=W))
    stages = cell_stages(cell_args, W, ct)
    # the tiled layout on the same inputs: kernel 1 over V/pv repeated per
    # beam row does the same arithmetic and reads the slots W times
    tiled_args = list(cell_args)
    tiled_args[5] = cell_args[5].repeat_interleave(W, 0)
    tiled_args[6] = cell_args[6].repeat_interleave(W, 0)
    tiled_err = 0.0
    for name, a, b in zip(("h", "c", "c_hat", "alpha", "beta"),
                          fs.decode_cell(*tiled_args, cell_t=ct), got):
        tol = TOL["float32"] if a.dtype == torch.float32 else TOL[dtype_name]
        tiled_err = max(tiled_err, check_close(f"tiled vs beam-major W={W} {dtype_name} {name}",
                                               a, b, *tol))
    tiled_ms = cuda_ms(lambda: fs.decode_cell(*tiled_args, cell_t=ct))
    cell_flops = 2.0 * R * (H * 4 * H + E2 * H + H * H + 2 * H * D + K * D + K * H)
    cell_bound = bound(nbytes(*cell_args) + nbytes(*got), cell_flops, dtype_name)
    head_ms, head_cold_ms = cuda_ms(head), cuda_cold_ms(head)
    head_plain_ms = cuda_ms(lambda: fs.beam_head_topk_plain(Wt, bias, chat, h, VOCAB, W))
    z = (chat + h).to(dt)

    def library():
        lg = torch.addmm(bias, z, Wt)
        return lg.topk(W, dim=1), torch.logsumexp(lg, dim=1)

    head_lib_ms, head_lib_cold_ms = cuda_ms(library), cuda_cold_ms(library)
    head_bound = bound(nbytes(Wt, bias, chat, h, *top), 2.0 * R * H * VP, dtype_name)
    log(f"[beam kernels {dtype_name} W={W}] cell ({stages_text(*stages)}): kernel {cell_ms:.4f} "
        f"ms plain {cell_plain_ms:.4f} ms bound {cell_bound[0]:.4f} ms ({cell_bound[1]}), tiled "
        f"layout (kernel 1, V/pv repeated; max abs diff {tiled_err:.3e}) {tiled_ms:.4f} ms | "
        f"top-W head ({fs.head_instance(dt, H)}): kernel {head_ms:.4f} ms (L2 cold "
        f"{head_cold_ms:.4f}) plain {head_plain_ms:.4f} ms addmm+topk+logsumexp "
        f"{head_lib_ms:.4f} ms (L2 cold {head_lib_cold_ms:.4f}) bound {head_bound[0]:.4f} ms "
        f"({head_bound[1]})")
    return {
        "adaptive_decode_cell_fused_beam": {
            "max_abs_err": cell_err, "ms": cell_ms, "plain_ms": cell_plain_ms,
            "bound_ms": cell_bound[0], "bound_by": cell_bound[1], "library_ms": None,
            "tiled_ms": tiled_ms, "instance": stages[0], "plan": stages[1]._asdict(),
            "stage_ms": stages[2]},
        "beam_head_topk": {
            "max_abs_err": head_err, "rows_differ": rows_differ, "ms": head_ms,
            "cold_ms": head_cold_ms, "plain_ms": head_plain_ms, "bound_ms": head_bound[0],
            "bound_by": head_bound[1], "library_ms": head_lib_ms,
            "library_cold_ms": head_lib_cold_ms},
    }


# ---------------------------------------------------------------- phase 2c
def quanta(name, got, want):
    """Elements of two s8 outputs that differ: at most 1 quantum, on under
    QUANTUM_SHARE of them. Returns (count, max |d|)."""
    d = (got.int() - want.int()).abs()
    n, worst = int((d > 0).sum()), int(d.max())
    if worst > 1 or n >= QUANTUM_SHARE * d.numel():
        raise AssertionError(f"{name}: {n}/{d.numel()} elements differ, max |d| {worst}")
    return n, worst


def int8_kernel_checks():
    """Kernels 5 and 6 against their twins and against the carry's own
    unfused code (_acc_i8 + epilogue, the path that runs with the kernel
    off) at batch B with seeded s8 activations and weights and epilogue rows
    that keep the outputs inside the s8 range: kernel 5 at the four
    bottleneck layers' shapes, kernel 6 at the seven shapes a decode
    launches it at (INT8_TAILS). Times kernel, twin and unfused segment
    beside the bound, with each kernel's launch plan; then one
    correctness-only pass of each at an odd shape (3 images of 13 x 13, M2
    = 2M)."""
    import torch

    from adaptive_tpu_torch.models import infer as I
    from adaptive_tpu_torch.ops import fused_block as fb
    from adaptive_tpu_torch.ops import fused_tail as ft

    g = torch.Generator(device="cuda").manual_seed(SEED + 100)
    relu = torch.relu

    def s8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device="cuda", dtype=torch.int8)

    def rows(n, k):  # acc * sc + b at O(1): an int8 product of depth k spreads ~127^2 sqrt(k) / 3
        sc = (torch.rand(n, generator=g, device="cuda") + 0.5) * (3.0 / (127 ** 2 * k ** 0.5))
        return sc, torch.randn(n, generator=g, device="cuda") * 0.3

    def conv(w, kh, sc, b):  # a prepared conv dict of the carry, w [O, kh*kh*I] (ky, kx, i)
        O = w.shape[0]
        return {"wq": w.reshape(O, kh, kh, -1).permute(0, 3, 1, 2), "scale": sc, "bias": b}

    def carry_block(x4, c1, c2, c3, s2, s3, s_in, s_out):  # _resnet_int8_carry's ops
        acc, sc = I._acc_i8(x4, c1, None)
        z = I._requant(relu(acc.float() * sc + c1["bias"]), s2)
        acc, sc = I._acc_i8(z, c2, None)
        z = I._requant(relu(acc.float() * sc + c2["bias"]), s3)
        acc, sc = I._acc_i8(z, c3, None)
        tail = acc.float() * sc + c3["bias"]
        return I._requant(relu(tail + x4.float() * I.f32(s_in, tail)), s_out)

    def carry_tail(x4, z2, c3, c1, s_in, s_out, s_next):
        acc, sc = I._acc_i8(z2, c3, None)
        out = I._requant(relu(acc.float() * sc + c3["bias"] + x4.float() * I.f32(s_in, acc)), s_out)
        acc, sc = I._acc_i8(out, c1, None)
        return out, I._requant(relu(acc.float() * sc + c1["bias"]), s_next)

    def layer_of(H):
        return f"layer{[l[0] for l in INT8_LAYERS].index(H) + 1}"

    S5, S6 = (0.034, 0.057, 0.021, 0.026), (0.024, 0.027, 0.042)
    res = {"bottleneck_identity_int8": [], "tail_conv1_int8": []}

    def record(name, where, nb, H, C, M, n, nd, dmax, ms, pl, un, bd, **extra):
        res[name].append({"layer": where, "B": nb, "H": H, "C": C, "M": M, **extra,
                          "launches": n, "elements_differ": nd, "max_abs_err": dmax, "ms": ms,
                          "plain_ms": pl, "unfused_ms": un, "bound_ms": bd[0],
                          "bound_by": bd[1]})

    # kernel 5
    for nb, H, C, M, n in [(B, H, C, M, n) for H, C, M, n in INT8_LAYERS] + [(3, 13, 256, 64, 0)]:
        N = nb * H * H
        where = layer_of(H) if n else "odd"
        x = s8(N, C)
        w1, w2, w3 = s8(M, C), s8(M, 9 * M), s8(C, M)
        r1, r2, r3 = rows(M, C), rows(M, 9 * M), rows(C, M)
        a5 = (x, H, H, w1, w2, w3, *r1, *r2, *r3, *S5)
        got = fb.bottleneck_identity_int8(*a5)
        torch.cuda.synchronize()
        n5, d5 = quanta(f"block {where}", got, fb.bottleneck_identity_int8_plain(*a5))
        x4 = x.reshape(nb, H, H, C)
        c5 = (conv(w1, 1, *r1), conv(w2, 3, *r2), conv(w3, 1, *r3))
        u5 = quanta(f"block {where} vs the carry", got.reshape(nb, H, H, C),
                    carry_block(x4, *c5, *S5))[0]
        line = (f"[int8 kernels {where}] block B {nb} H=W {H} C {C} M {M}: {n5}/{got.numel()} "
                f"elements differ from the twin (max |d| {d5}), {u5} from the carry")
        if n:
            k5 = cuda_ms(lambda: fb.bottleneck_identity_int8(*a5), INT8_ITERS, 1)
            p5 = cuda_ms(lambda: fb.bottleneck_identity_int8_plain(*a5), INT8_ITERS, 1)
            f5 = cuda_ms(lambda: carry_block(x4, *c5, *S5), INT8_ITERS, 1)
            b5 = bound(2 * nbytes(x) + nbytes(w1, w2, w3, *r1, *r2, *r3),
                       2.0 * N * (C * M + 9 * M * M + M * C), "int8")
            plan = fb.block_plan(nb, H, H, C, M)
            line += (f" | kernel {k5:.4f} ms plain {p5:.4f} ms unfused {f5:.4f} ms bound "
                     f"{b5[0]:.4f} ms ({b5[1]}); plan {plan.rows} rows x {plan.images} images a "
                     f"block, nt {plan.nt} kt {plan.kt}, {plan.smem} shared bytes, {plan.sms} "
                     f"blocks an SM; launches a decode {n}")
            record("bottleneck_identity_int8", where, nb, H, C, M, n, n5, d5, k5, p5, f5, b5,
                   plan={"rows_a_block": plan.rows, "images_a_block": plan.images,
                         "smem_bytes": plan.smem, "blocks_an_sm": plan.sms, "nt": plan.nt,
                         "kt": plan.kt})
        log(line)
        del a5, x, x4, c5, got
        torch.cuda.empty_cache()

    # kernel 6
    for nb, H, C, M, M2, n in ([(B, *t) for t in INT8_TAILS] + [(3, 13, 256, 64, 128, 0)]):
        N = nb * H * H
        where = layer_of(H) if n else "odd"
        x, z2 = s8(N, C), s8(N, M)
        w3, w1n = s8(C, M), s8(M2, C)
        r3, r1n = rows(C, M), rows(M2, C)
        a6 = (x, z2, w3, *r3, w1n, *r1n, *S6)
        out, z1 = ft.tail_conv1_int8(*a6)
        torch.cuda.synchronize()
        p_out, p_z1 = ft.tail_conv1_int8_plain(*a6)
        n6, d6 = quanta(f"tail {where} M2 {M2} carry", out, p_out)
        n6b, d6b = quanta(f"tail {where} M2 {M2} conv1", z1, p_z1)
        c6 = (conv(w3, 1, *r3), conv(w1n, 1, *r1n))
        x4, z24 = x.reshape(nb, H, H, C), z2.reshape(nb, H, H, M)
        u_out, u_z1 = carry_tail(x4, z24, *c6, *S6)
        u6 = (quanta(f"tail {where} M2 {M2} carry vs the carry", out.reshape(nb, H, H, C), u_out)[0]
              + quanta(f"tail {where} M2 {M2} conv1 vs the carry", z1.reshape(nb, H, H, M2),
                       u_z1)[0])
        line = (f"[int8 kernels {where}] tail B {nb} H=W {H} C {C} M {M} M2 {M2}: "
                f"{n6 + n6b}/{out.numel() + z1.numel()} elements differ from the twin (max |d| "
                f"{max(d6, d6b)}), {u6} from the carry")
        if n:
            k6 = cuda_ms(lambda: ft.tail_conv1_int8(*a6), INT8_ITERS, 1)
            p6 = cuda_ms(lambda: ft.tail_conv1_int8_plain(*a6), INT8_ITERS, 1)
            f6 = cuda_ms(lambda: carry_tail(x4, z24, *c6, *S6), INT8_ITERS, 1)
            b6 = bound(nbytes(x, z2, out, z1, w3, w1n, *r3, *r1n), 2.0 * N * (M * C + C * M2),
                       "int8")
            plan = ft.tail_plan(N, C, M, M2)
            line += (f" | kernel {k6:.4f} ms plain {p6:.4f} ms unfused {f6:.4f} ms bound "
                     f"{b6[0]:.4f} ms ({b6[1]}); plan {plan.rows} rows a block, nt {plan.nt} kt "
                     f"{plan.kt}, {plan.smem} shared bytes, {plan.sms} blocks an SM; launches a "
                     f"decode {n}")
            record("tail_conv1_int8", where, nb, H, C, M, n, n6 + n6b, max(d6, d6b), k6, p6, f6,
                   b6, M2=M2, plan={"rows_a_block": plan.rows, "smem_bytes": plan.smem,
                                    "blocks_an_sm": plan.sms, "nt": plan.nt, "kt": plan.kt})
        log(line)
        del a6, x, z2, x4, z24, c6, out, z1, p_out, p_z1, u_out, u_z1
        torch.cuda.empty_cache()
    return res


def int8_summary(per_layer):
    """One decode's launch-weighted sums over the layers of a kernel's rows."""
    tot = {k: sum(r["launches"] * r[k] for r in per_layer)
           for k in ("ms", "plain_ms", "unfused_ms", "bound_ms")}
    by = {}
    for r in per_layer:
        by[r["bound_by"]] = by.get(r["bound_by"], 0.0) + r["launches"] * r["bound_ms"]
    return {**tot, "bound_by": max(by, key=by.get),
            "max_abs_err": max(r["max_abs_err"] for r in per_layer)}


# ----------------------------------------------------------------- phase 2d
def epilogue_shapes(size=224):
    """(rows an image, C, mode) of each kernel 7 launch of one ResNet-152
    encode at size px, in models/infer.py::_folded_forward's order: the stem
    and every conv1 and conv2 "mid" (bias + relu), every conv3 "downsample"
    (a layer's block 0: + the downsample's raw output and its bias) or
    "identity" (+ the block input)."""
    from adaptive_tpu_torch.models.resnet import RESNET_SPECS

    out = [((size // 2) ** 2, 64, "mid")]
    hw = size // 4
    for li, n in enumerate(RESNET_SPECS["resnet152"][1]):
        width = 64 << li
        for bi in range(n):
            out.append((hw * hw, width, "mid"))
            hw //= 2 if li > 0 and bi == 0 else 1
            out += [(hw * hw, width, "mid"),
                    (hw * hw, 4 * width, "identity" if bi else "downsample")]
    return out


def separate_passes(acc, bias, res, rb, side):
    """The float encoder's epilogue before kernel 7, on [rows, C] operands
    of side x side images: F.conv2d's bias add_ on the conv output's NCHW
    (channels_last) view as cuDNN's route adds it, the downsample's, then
    relu(z + sc)."""
    import torch.nn.functional as F

    def nchw(t):
        return t.view(-1, side, side, t.shape[-1]).permute(0, 3, 1, 2)

    z = nchw(acc).add_(bias[:, None, None])
    if res is not None:
        sc = nchw(res)
        if rb is not None:
            sc.add_(rb[:, None, None])
        z = z + sc
    return F.relu(z)


def epilogue_checks(smi):
    """Phase 2d: kernel 7 at each distinct (rows, C, mode) of one ResNet-152
    encode at batch B (epilogue_shapes), seeded N(0, 1) operands: in bf16
    and fp32 equal to its twin (the same adds, one rounding), in fp32 equal
    to separate_passes; then in bf16 the kernel, the twin and
    separate_passes (library_ms) timed back to back, in place, and summed
    over the encode's launches, beside the bound of the bytes the kernel
    moves (conv output read and written, residual read)."""
    import collections

    import torch

    from adaptive_tpu_torch.ops import conv_epilogue as CE

    shapes = collections.Counter(epilogue_shapes())
    if sum(shapes.values()) != ENCODE_EPILOGUES:
        raise AssertionError(f"epilogue_shapes gives {sum(shapes.values())} launches an encode, "
                             f"expected {ENCODE_EPILOGUES}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    per_shape, tot = [], collections.Counter()
    for (hw, C, mode), n in shapes.items():
        N, side = B * hw, int(round(hw ** 0.5))
        for dt in (torch.float32, torch.bfloat16):
            def r(*shape):
                return torch.randn(*shape, device="cuda", generator=gen).to(dt)

            acc, bias = r(N, C), r(C)
            res = None if mode == "mid" else r(N, C)
            rb = r(C) if mode == "downsample" else None
            CE.folded_epilogue.launches = 0
            got = CE.folded_epilogue(acc.clone(), bias, res, rb)
            torch.cuda.synchronize()
            if CE.folded_epilogue.launches != 1:
                raise AssertionError(f"kernel 7 launched {CE.folded_epilogue.launches} times")
            if not torch.equal(got, CE.folded_epilogue_plain(acc, bias, res, rb)):
                raise AssertionError(f"kernel 7 {mode} {dt} [{N}, {C}]: differs from its twin")
            if dt == torch.float32:
                want = separate_passes(acc.clone(), bias, None if res is None else res.clone(),
                                       rb, side)
                if not torch.equal(got, want.permute(0, 2, 3, 1).reshape(N, C)):
                    raise AssertionError(f"kernel 7 {mode} fp32 [{N}, {C}]: differs from the "
                                         "separate passes")
                del got, want, acc, res
                continue
            del got
            ms = cuda_ms(lambda: CE.folded_epilogue(acc, bias, res, rb), EPILOGUE_ITERS)
            plain = cuda_ms(lambda: CE.folded_epilogue_plain(acc, bias, res, rb), EPILOGUE_ITERS)
            lib = cuda_ms(lambda: separate_passes(acc, bias, res, rb, side), EPILOGUE_ITERS)
            moved = nbytes(*(t for t in (acc, acc, res, bias, rb) if t is not None))
            per_shape.append({"rows": N, "C": C, "mode": mode, "launches": n, "ms": ms,
                              "plain_ms": plain, "library_ms": lib,
                              "bound_ms": bound(moved, 0, "bfloat16")[0]})
            tot.update({"ms": n * ms, "plain_ms": n * plain, "library_ms": n * lib,
                        "bytes": n * moved})
            del acc, res
        torch.cuda.empty_cache()
    bound_ms = bound(tot["bytes"], 0, "bfloat16")[0]
    out = {"ms": tot["ms"], "bound_ms": bound_ms, "bound_by": "bytes",
           "plain_ms": tot["plain_ms"], "library_ms": tot["library_ms"],
           "max_abs_err": 0.0, "dtype": "bfloat16", "per_shape": per_shape}
    worst = sorted(per_shape, key=lambda e: e["launches"] * (e["ms"] - e["bound_ms"]))[-3:]
    log(f"[kernel 7 conv epilogue bf16] {smi}: one encode at batch {B}, {ENCODE_EPILOGUES} "
        f"launches at {len(per_shape)} shapes, each equal to its twin (bf16, fp32) and to the "
        f"separate passes (fp32): kernel {tot['ms']:.3f} ms, bound {bound_ms:.3f} ms "
        f"({tot['bytes'] / 1e9:.1f} GB; {tot['bytes'] / tot['ms'] / 1e9:.3f} TB/s), twin "
        f"{tot['plain_ms']:.3f} ms, separate passes {tot['library_ms']:.3f} ms; most lost "
        + ", ".join(f"[{e['rows']}, {e['C']}] {e['mode']} x{e['launches']} {e['ms']:.3f} ms "
                    f"(bound {e['bound_ms']:.3f})" for e in reversed(worst)))
    return out



# ----------------------------------------------------------------- phase 2e
def ssm_widths():
    """(H, P, N, G, K, Mamba layers) of granite-4.0-h-micro's Mamba-2 layers
    (models/hybrid_lm.py::PUBLISHED)."""
    from adaptive_tpu_torch.models.hybrid_lm import PUBLISHED as c

    return (c["mamba_n_heads"], c["mamba_d_head"], c["mamba_d_state"], c["mamba_n_groups"],
            c["mamba_d_conv"], c["layer_types"].count("mamba"))


def ssm_step_checks(smi):
    """Phase 2e: kernel 8, a Mamba-2 layer's decode step, at batch B and
    granite-4.0-h-micro's widths in bf16, xbc and dt the row-strided slices
    of a seeded in_proj output as the decode hands them over: one launch a
    call, y and the updated state within one bf16 rounding of the twin
    (TOL), the shifted conv state equal; then kernel and twin timed beside
    the bound of the bytes the kernel moves (state and conv state read and
    written, xbc, dt and the weights read, y written)."""
    import torch

    from adaptive_tpu_torch.ops import ssm_step as SS

    H, P, N, G, Kc, _ = ssm_widths()
    inner, dt = H * P, torch.bfloat16
    C = inner + 2 * G * N
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def u(*shape, lo=-0.5, hi=0.5):
        return torch.rand(*shape, device="cuda", generator=gen) * (hi - lo) + lo

    proj = torch.randn(B, inner + C + H, device="cuda", generator=gen).to(dt)  # [z, xBC, dt]
    xbc, dt_raw = proj[:, inner:inner + C], proj[:, inner + C:]
    conv = torch.randn(B, Kc - 1, C, device="cuda", generator=gen).to(dt)
    w, b = u(C, Kc).to(dt), u(C).to(dt)
    dt_bias, A, D = u(H, lo=-7.0, hi=-3.0), -u(H, lo=1.0, hi=16.0), torch.ones(H, device="cuda")
    state = (0.1 * torch.randn(B, H, P, N, device="cuda", generator=gen)).to(dt)
    args = (xbc, dt_raw, conv, w, b, dt_bias, A, D, state)
    want_y, want_conv, want_state = SS.ssm_step_plain(*args)
    SS.ssm_step.launches = 0
    y = SS.ssm_step(*args)
    torch.cuda.synchronize()
    if SS.ssm_step.launches != 1:
        raise AssertionError(f"kernel 8 launched {SS.ssm_step.launches} times in a call")
    if not torch.equal(conv, want_conv):
        raise AssertionError("kernel 8: the shifted conv state differs from its twin's")
    err = max(check_close("kernel 8 y", y, want_y, *TOL["bfloat16"]),
              check_close("kernel 8 state", state, want_state, *TOL["bfloat16"]))
    del want_y, want_conv, want_state
    ms = cuda_ms(lambda: SS.ssm_step(*args), SSM_ITERS)
    plain = cuda_ms(lambda: SS.ssm_step_plain(*args), 3, warmup=1)
    torch.cuda.empty_cache()
    moved = nbytes(state, state, conv, conv, xbc, dt_raw, y, w, b, dt_bias, A, D)
    flops = 4.0 * B * inner * N + 2.0 * B * Kc * C
    bound_ms, by = bound(moved, flops, "bfloat16")
    log(f"[kernel 8 ssm_step bf16] {smi}: batch {B}, H {H} P {P} N {N} G {G} d_conv {Kc}, one "
        f"launch a call, within one bf16 rounding of its twin (max abs err {err:.3e}), conv "
        f"state equal: kernel {ms:.4f} ms, bound {bound_ms:.4f} ms ({moved / 1e9:.3f} GB, "
        f"{100 * bound_ms / ms:.1f}% of the roofline; {moved / ms / 1e9:.3f} TB/s), twin "
        f"{plain:.3f} ms")
    return {"ms": ms, "bound_ms": bound_ms, "bound_by": by, "plain_ms": plain,
            "library_ms": None, "max_abs_err": err, "dtype": "bfloat16"}


# ----------------------------------------------------------------- phase 3
def seeded_images(n, seed, size=256, cells=4):
    """n uint8 NHWC images from a numpy seed: a random cells x cells grid of
    colours, blown up to size, plus pixel noise of +-24. Images of i.i.d.
    noise all look alike to a network; coarse structure sets them apart."""
    import numpy as np

    rng = np.random.default_rng(seed)
    grid = rng.integers(0, 256, (n, cells, cells, 3), dtype=np.int16)
    up = grid.repeat(size // cells, axis=1).repeat(size // cells, axis=2)
    up += rng.integers(-24, 25, up.shape, dtype=np.int16)
    return np.clip(up, 0, 255).astype(np.uint8)


def random_model(cf, device, calib_images):
    """Seeded random weights; BN statistics calibrated on a batch so the
    random ResNet-152's activations keep a trained network's scale, with
    residual branches scaled down so that it is not chaotic
    (resnet.calibrate_bn_)."""
    import torch

    from adaptive_tpu_torch.models import build_model
    from adaptive_tpu_torch.models.resnet import calibrate_bn_
    from adaptive_tpu_torch.ops.preprocess import eval_preprocess

    model = build_model(cf, device=device)
    net = model.init(SEED)
    x = eval_preprocess(torch.as_tensor(calib_images, device=model.device), cf.train_crop_size)
    calibrate_bn_(net.encoder.resnet_conv, x)
    return model, net


def launch_counts():
    from adaptive_tpu_torch.ops import conv_epilogue as ce
    from adaptive_tpu_torch.ops import fused_block as fb
    from adaptive_tpu_torch.ops import fused_step as fs
    from adaptive_tpu_torch.ops import fused_tail as ft
    from adaptive_tpu_torch.ops import ssm_step as ss

    return {"adaptive_decode_cell_fused": fs.decode_cell.launches,
            "greedy_head_argmax": fs.greedy_head_argmax.launches,
            "adaptive_decode_cell_fused_beam": fs.decode_cell.launches_beam,
            "beam_head_topk": fs.beam_head_topk.launches,
            "bottleneck_identity_int8": fb.bottleneck_identity_int8.launches,
            "tail_conv1_int8": ft.tail_conv1_int8.launches,
            "folded_epilogue": ce.folded_epilogue.launches,
            "ssm_step": ss.ssm_step.launches}


def reset_launch_counts():
    from adaptive_tpu_torch.ops import conv_epilogue as ce
    from adaptive_tpu_torch.ops import fused_block as fb
    from adaptive_tpu_torch.ops import fused_step as fs
    from adaptive_tpu_torch.ops import fused_tail as ft
    from adaptive_tpu_torch.ops import ssm_step as ss

    fs.reset_launch_counts()
    fb.bottleneck_identity_int8.launches = ft.tail_conv1_int8.launches = 0
    ce.folded_epilogue.launches = ss.ssm_step.launches = 0


def encode_epilogues(cf, encodes=1):
    """folded_epilogue's launches in `encodes` encodes of cf's ResNet-152:
    ENCODE_EPILOGUES each on the float encoder, none on the int8 one."""
    return 0 if cf.encoder_quant == "int8" else encodes * ENCODE_EPILOGUES


def timed_decodes(decode, net, model, cf, images, expect):
    """Warm-up at the full batch (cuDNN plans, allocator), then E2E_REPEATS
    timed decodes, the first with every launch count set to 0 just before
    and read just after; expect: {kernel: launches}. Then E2E_REPEATS timed
    encoder runs. Returns (first output, launches, total ms, encoder ms)."""
    import torch

    from adaptive_tpu_torch.ops.preprocess import eval_preprocess

    prepared = decode.prepare(net)
    decode(net, images)
    torch.cuda.synchronize()

    def timed(fn):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    reset_launch_counts()
    out, first_ms = timed(lambda: decode(net, images))
    launches = launch_counts()
    for name, n in expect.items():
        if launches[name] != n:
            raise AssertionError(f"{name} launched {launches[name]} times in the decode, "
                                 f"expected {n}")
    total_ms = [first_ms] + [timed(lambda: decode(net, images))[1] for _ in range(E2E_REPEATS - 1)]
    with torch.no_grad():
        enc_ms = [timed(lambda: model.encode_inference(prepared, eval_preprocess(
            images, cf.train_crop_size, model.compute_dtype)))[1] for _ in range(E2E_REPEATS)]
    return out, {k: launches[k] for k in expect if expect[k]}, total_ms, enc_ms


def check_maps(out, lead):
    """Attention maps [*lead, STEPS, K] finite and summing to 1, beta in [0, 1]."""
    import torch

    att = out.attention.float()
    if tuple(att.shape) != (*lead, STEPS, K) or not torch.isfinite(att).all():
        raise AssertionError("attention maps malformed")
    if not torch.allclose(att.sum(-1), torch.ones(*lead, STEPS, device=att.device), atol=1e-3):
        raise AssertionError("attention maps do not sum to 1")
    if not ((out.beta >= 0) & (out.beta <= 1)).all():
        raise AssertionError("beta outside [0, 1]")


def end_to_end(model, net, cf, images_u8, smi, profile_dir=None):
    import torch

    from adaptive_tpu_torch.decoding import make_greedy_decoder

    decode = make_greedy_decoder(model, cf)
    images = torch.as_tensor(images_u8, device="cuda")
    expect = {"adaptive_decode_cell_fused": STEPS, "greedy_head_argmax": STEPS,
              "adaptive_decode_cell_fused_beam": 0, "beam_head_topk": 0,
              "bottleneck_identity_int8": 0, "tail_conv1_int8": 0,
              "folded_epilogue": ENCODE_EPILOGUES, "ssm_step": 0}
    out, launches, total_ms, enc_ms = timed_decodes(decode, net, model, cf, images, expect)

    ids = out.ids.cpu().numpy()
    if ids.shape != (B, STEPS) or ids.min() < 0 or ids.max() >= VOCAB:
        raise AssertionError(f"ids of shape {ids.shape} in [{ids.min()}, {ids.max()}]")
    check_maps(out, (B,))

    distinct = len({tuple(r) for r in ids.tolist()})
    total, enc = sum(total_ms) / len(total_ms), sum(enc_ms) / len(enc_ms)
    log(f"[end-to-end bf16] {smi}: batch {B}, {STEPS} steps, mean of {E2E_REPEATS} runs: "
        f"total {total:.3f} ms {total_ms}, encoder (preprocess + ResNet-152 + heads) "
        f"{enc:.3f} ms {enc_ms}, decode loop {total - enc:.3f} ms, {B / total * 1e3:.1f} "
        f"captions/s; launches {launches}; {distinct} distinct captions, first: "
        f"{ids[0, :12].tolist()}")
    if profile_dir:
        profile_decode(lambda: decode(net, images), profile_dir, smi, "greedy")
    return launches, {"total_ms": total, "encoder_ms": enc, "captions_per_s": B / total * 1e3}


# ---------------------------------------------------------------- phase 3b
def check_beams(out, W):
    """A beam decode of B images at width W well formed: every beam's ids in
    the vocab, the maps as check_maps has them, finite scores sorted best
    first, ids and score the best beam's. Returns the best ids (numpy)."""
    import torch

    all_ids = out.all_ids.cpu().numpy()
    ids = out.ids.cpu().numpy()
    if all_ids.shape != (B, W, STEPS) or all_ids.min() < 0 or all_ids.max() >= VOCAB:
        raise AssertionError(f"all_ids of shape {all_ids.shape} in [{all_ids.min()}, "
                             f"{all_ids.max()}]")
    if ids.shape != (B, STEPS) or ids.min() < 0 or ids.max() >= VOCAB:
        raise AssertionError(f"ids of shape {ids.shape} in [{ids.min()}, {ids.max()}]")
    check_maps(out, (B,))
    scores = out.all_scores
    if tuple(scores.shape) != (B, W) or not torch.isfinite(scores).all():
        raise AssertionError("all_scores malformed")
    best = scores.argmax(1)
    img = torch.arange(B, device=scores.device)
    if not torch.equal(out.score, scores[img, best]):
        raise AssertionError("score is not all_scores at the best beam")
    if not torch.equal(out.ids, out.all_ids[img, best]):
        raise AssertionError("ids are not all_ids at the best beam")
    if not (scores[:, :-1] >= scores[:, 1:]).all():
        raise AssertionError("beams are not sorted by score")
    return ids


def beam_end_to_end(model, net, cf, images_u8, smi, profile_dir=None):
    import torch

    from adaptive_tpu_torch.decoding import make_beam_decoder

    decode = make_beam_decoder(model, cf, beam_size=BEAM)
    images = torch.as_tensor(images_u8, device="cuda")
    expect = {"adaptive_decode_cell_fused": 0, "greedy_head_argmax": 0,
              "adaptive_decode_cell_fused_beam": STEPS, "beam_head_topk": STEPS,
              "bottleneck_identity_int8": 0, "tail_conv1_int8": 0,
              "folded_epilogue": ENCODE_EPILOGUES, "ssm_step": 0}
    out, launches, total_ms, enc_ms = timed_decodes(decode, net, model, cf, images, expect)
    ids = check_beams(out, BEAM)

    distinct = len({tuple(r) for r in ids.tolist()})
    total, enc = sum(total_ms) / len(total_ms), sum(enc_ms) / len(enc_ms)
    log(f"[end-to-end beam {BEAM} bf16] {smi}: batch {B}, {STEPS} steps, mean of {E2E_REPEATS} "
        f"runs: total {total:.3f} ms {total_ms}, encoder {enc:.3f} ms {enc_ms}, decode loop "
        f"{total - enc:.3f} ms, {B / total * 1e3:.1f} captions/s; launches {launches}; "
        f"{distinct} distinct best captions, first: {ids[0, :12].tolist()} score "
        f"{float(out.score[0]):.4f}")
    if profile_dir:
        profile_decode(lambda: decode(net, images), profile_dir, smi, f"beam{BEAM}")
    return launches, {"total_ms": total, "encoder_ms": enc, "captions_per_s": B / total * 1e3}



# ---------------------------------------------------------------- phase 3c
def hybrid_end_to_end(images_u8, smi, profile_dir=None):
    """Phase 3c: the granite_h_micro variant's greedy path in bf16 at its
    published widths (40 layers, vocab 100,352): a seeded random model,
    the trunk calibrated as phase 3's, make_greedy_decoder on the same
    images; kernel 8 launched once a Mamba layer a step, kernel 7 151 times
    a decode, no other kernel; ids in the vocab, attention [B, STEPS, 0]
    and beta [B, 0]. Returns (launches, {total_ms, encoder_ms,
    captions_per_s, cache_bytes})."""
    import torch

    from adaptive_tpu_torch import Config
    from adaptive_tpu_torch.decoding import make_greedy_decoder
    from adaptive_tpu_torch.models.hybrid_lm import HybridCache

    torch.cuda.reset_peak_memory_stats()
    cf = Config(atten_model_name="granite_h_micro", compute_dtype="bfloat16",
                vocab_length=HYBRID_VOCAB)
    model, net = random_model(cf, "cuda", images_u8[:32])
    decode = make_greedy_decoder(model, cf)
    images = torch.as_tensor(images_u8, device="cuda")
    mamba = ssm_widths()[-1]
    expect = {**{k: 0 for k in launch_counts()}, "folded_epilogue": ENCODE_EPILOGUES,
              "ssm_step": mamba * STEPS}
    out, launches, total_ms, enc_ms = timed_decodes(decode, net, model, cf, images, expect)
    ids = out.ids.cpu().numpy()
    if ids.shape != (B, STEPS) or ids.min() < 0 or ids.max() >= HYBRID_VOCAB:
        raise AssertionError(f"ids of shape {ids.shape} in [{ids.min()}, {ids.max()}]")
    if tuple(out.attention.shape) != (B, STEPS, 0) or tuple(out.beta.shape) != (B, 0):
        raise AssertionError(f"attention {tuple(out.attention.shape)} and beta "
                             f"{tuple(out.beta.shape)}, expected ({B}, {STEPS}, 0) and ({B}, 0)")
    cache = HybridCache(model.lm, B, K + STEPS, model.compute_dtype, "meta").nbytes()
    distinct = len({tuple(r) for r in ids.tolist()})
    total, enc = sum(total_ms) / len(total_ms), sum(enc_ms) / len(enc_ms)
    log(f"[end-to-end granite_h_micro bf16] {smi}: batch {B}, {STEPS} steps, mean of "
        f"{E2E_REPEATS} runs: total {total:.3f} ms {total_ms}, encoder {enc:.3f} ms {enc_ms}, "
        f"prefill and steps {total - enc:.3f} ms, {B / total * 1e3:.1f} captions/s; launches "
        f"{launches}; cache bytes {cache}; peak {torch.cuda.max_memory_allocated() / 1e9:.2f} "
        f"GB; {distinct} distinct captions, first: {ids[0, :12].tolist()}")
    if profile_dir:
        profile_decode(lambda: decode(net, images), profile_dir, smi, "granite_h_micro")
    return launches, {"total_ms": total, "encoder_ms": enc, "captions_per_s": B / total * 1e3,
                      "cache_bytes": cache}


# ----------------------------------------------------------------- phase 5
def feature_check(name, got, ref):
    """Encoder features against a reference run: the bound of the JAX
    package's fused-kernel integration tests (tests/test_pallas.py:522-526),
    max |d| < 0.05 max |ref| and cosine > 0.9999. Returns the count of
    elements that differ."""
    import torch

    g, r = got.double(), ref.double()
    if g.shape != r.shape or not torch.isfinite(g).all():
        raise AssertionError(f"{name}: features of shape {tuple(g.shape)}, or not finite")
    err, scale = float((g - r).abs().max()), float(r.abs().max())
    cos = float((g * r).sum() / (g.norm() * r.norm()))
    if not (err < 0.05 * scale and cos > 0.9999):
        raise AssertionError(f"{name}: max |d| {err:.3e} against max |ref| {scale:.3e}, cos {cos}")
    return int((g != r).sum())


def int8_modes(cf, net, images_u8):
    """The int8 models of phase 5's modes on net's weights, calibrated on the
    first INT8_CALIB images: {tag: (model, its config, the launches of
    kernels 5 and 6 a decode)}, and the two calibrations' seconds."""
    import torch

    from adaptive_tpu_torch.models import build_model
    from adaptive_tpu_torch.models.infer import calibrate_model

    cf_a = cf.replace(encoder_quant="int8")
    cf_t = cf_a.replace(encoder_quant_granularity="tensor")
    t0 = time.perf_counter()
    model_a = calibrate_model(build_model(cf_a), cf_a, net, images_u8[:INT8_CALIB])
    model_t = calibrate_model(build_model(cf_t), cf_t, net, images_u8[:INT8_CALIB])
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    none = {"bottleneck_identity_int8": 0, "tail_conv1_int8": 0, "ssm_step": 0}
    return {
        "a": (model_a, cf_a, none),
        "t": (model_t, cf_t, none),  # the control of (b) and (c): no kernels
        "b": (model_t._replace(int8_fused_layers=INT8_FUSED), cf_t,
              {"bottleneck_identity_int8": INT8_LAUNCHES, "tail_conv1_int8": 0}),
        "c": (model_t._replace(int8_fused_tails=INT8_FUSED), cf_t,
              {"bottleneck_identity_int8": 0, "tail_conv1_int8": INT8_LAUNCHES}),
    }, calib_s


def int8_end_to_end(net, cf, images_u8, smi, profile_dir=None):
    """The int8 encoder end to end in bf16 at batch B on phase 3's model and
    images: build_model(encoder_quant="int8") -> calibrate_model (INT8_CALIB
    images) -> make_greedy_decoder, in three modes: (a) the bench's default
    (per-channel scales, s2d stem, no fused kernels), (b) per-tensor scales
    with every layer's identity blocks through kernel 5, (c) per-tensor
    scales with every layer's tails through kernel 6; and (t), per-tensor
    scales without kernels, the control of (b) and (c), whose features are
    held against its."""
    import torch

    from adaptive_tpu_torch.decoding import make_greedy_decoder
    from adaptive_tpu_torch.ops.preprocess import eval_preprocess

    images = torch.as_tensor(images_u8, device="cuda")
    modes, calib_s = int8_modes(cf, net, images_u8)
    model_t = modes["t"][0]
    base = {"adaptive_decode_cell_fused": STEPS, "greedy_head_argmax": STEPS,
            "adaptive_decode_cell_fused_beam": 0, "beam_head_topk": 0, "folded_epilogue": 0,
            "ssm_step": 0}
    with torch.no_grad():
        x = eval_preprocess(images, cf.train_crop_size, model_t.compute_dtype)
        ref = model_t.encode_inference(model_t.prepare_inference(net), x)[0]
    results, launches = {}, {}
    for tag, (model, mcf, extra) in modes.items():
        decode = make_greedy_decoder(model, mcf)
        out, got, total_ms, enc_ms = timed_decodes(decode, net, model, mcf, images,
                                                   {**base, **extra})
        launches[tag] = got
        ids = out.ids.cpu().numpy()
        if ids.shape != (B, STEPS) or ids.min() < 0 or ids.max() >= VOCAB:
            raise AssertionError(f"int8 {tag}: ids of shape {ids.shape} in [{ids.min()}, {ids.max()}]")
        check_maps(out, (B,))
        differ = ""
        if tag in "bc":
            with torch.no_grad():
                V = model.encode_inference(decode.prepare(net), x)[0]
            differ = (f"; V against per-tensor scales without kernels: "
                      f"{feature_check(f'int8 {tag}', V, ref)}/{V.numel()} elements differ")
        distinct = len({tuple(r) for r in ids.tolist()})
        total, enc = sum(total_ms) / len(total_ms), sum(enc_ms) / len(enc_ms)
        log(f"[end-to-end int8 {tag} bf16] {smi}: {mcf.encoder_quant_granularity} scales, fused "
            f"layers {model.int8_fused_layers}, tails {model.int8_fused_tails}, s2d stem "
            f"{model._resolved_fusion()[2]}; batch {B}, mean of {E2E_REPEATS} runs: total "
            f"{total:.3f} ms {total_ms}, encoder {enc:.3f} ms {enc_ms}, decode loop "
            f"{total - enc:.3f} ms, {B / total * 1e3:.1f} captions/s; launches {got}; "
            f"{distinct} distinct captions, first: {ids[0, :12].tolist()}{differ}")
        results[tag] = {"total_ms": total, "encoder_ms": enc, "captions_per_s": B / total * 1e3}
        if profile_dir and tag == "a":
            profile_decode(lambda: decode(net, images), profile_dir, smi, "int8_a")
        del decode, out
        torch.cuda.empty_cache()
    log(f"[int8 calibration] two calibrate_model calls on {INT8_CALIB} images: {calib_s:.2f} s")
    return launches, results


# ----------------------------------------------------------------- phase 6
INT8_PARITY_MODES = (("a", "channel", {}), ("c", "tensor", {"int8_fused_tails": INT8_FUSED}))


def int8_parity(cf, net_g, net_c, modes=INT8_PARITY_MODES, label="int8 parity fp32"):
    """int8 in fp32 on 8 images, card against CPU, in modes (a) and (c)
    (modes: (tag, granularity, model fields)): scales, and the bias
    corrections where cf.encoder_quant_bias_correct, calibrated once on the
    card and handed to both. The images are
    at the crop size (224 px, no resize: the card's antialiased resize rounds
    otherwise than the CPU's). The trunk features (the int8 ResNet's output)
    are held to phase 5's bound, 0 differing elements expected (exact
    products, the same IEEE epilogues, a device-exact BN fold); greedy ids
    under phase 4's top-2 gap rule. The card's bias corrections are held to
    calibrate_int8_bias's defining invariant (bias_corr_invariant). Returns
    {tag: numbers}."""
    import torch

    from adaptive_tpu_torch.models import build_model
    from adaptive_tpu_torch.models import infer as I
    from adaptive_tpu_torch.models.infer import calibrate_model
    from adaptive_tpu_torch.ops.preprocess import eval_preprocess

    imgs = seeded_images(8, SEED + 1, size=cf.train_crop_size)

    def trunk(model, net, dev):
        fused, tails, s2d = model._resolved_fusion()
        x = eval_preprocess(torch.as_tensor(imgs, device=dev), cf.train_crop_size)
        with torch.no_grad():
            return I.resnet_apply_folded_int8(model.prepare_inference(net)["encoder"]["resnet"], x,
                                              model.arch, model.int8_scales, fused, tails,
                                              stem_s2d=s2d, bias_corr=model.int8_bias_corr)

    out = {}
    for tag, gran, kw in modes:
        cf_i = cf.replace(encoder_quant="int8", encoder_quant_granularity=gran)
        mg = calibrate_model(build_model(cf_i), cf_i, net_g, imgs)._replace(**kw)
        mc = build_model(cf_i, device="cpu")._replace(int8_scales=mg.int8_scales,
                                                      int8_bias_corr=mg.int8_bias_corr, **kw)
        line = {}
        if mg.int8_bias_corr is not None:
            line["bias_corr_residual_of_bound"] = bias_corr_invariant(mg, cf_i, net_g, imgs)
        reset_launch_counts()
        Ag = trunk(mg, net_g, "cuda").cpu()
        n6 = launch_counts()["tail_conv1_int8"]
        if n6 != (INT8_LAUNCHES if kw else 0):
            raise AssertionError(f"{label} {tag}: kernel 6 launched {n6} times")
        Ac = trunk(mc, net_c, "cpu")
        differ = feature_check(f"{label} {tag}", Ag, Ac)
        corr = (f", bias corrections on {len(mg.int8_bias_corr)} convs (their second pass's "
                f"largest mean error {line['bias_corr_residual_of_bound']:.3e} of its bound)"
                if line else "")
        log(f"[{label} {tag}] {gran} scales, fused tails {mg.int8_fused_tails}{corr}: trunk "
            f"features card vs CPU: {differ}/{Ac.numel()} elements differ, max abs diff "
            f"{float((Ag - Ac).abs().max()):.3e}")
        line.update(features_differ=differ, greedy=cross_device_parity(
            cf_i, mg, net_g, mc, net_c, imgs, tag=f"{label} {tag}"))
        out[tag] = line
    return out


def bias_corr_invariant(model, cf, net, imgs):
    """calibrate_int8_bias's defining invariant (tests/test_torch_int8.py::
    test_calibrate_int8_bias_matches_jax) on the card, on the calibration
    images: with the model's corrections folded in, a second pass of the
    int8 carry finds every conv's per-channel mean error below 0.05 of the
    fp32 forward's mean magnitude + 1e-3. Returns the largest error as a
    share of its bound."""
    import torch

    from adaptive_tpu_torch.models import infer as I
    from adaptive_tpu_torch.ops.preprocess import eval_preprocess

    x = eval_preprocess(torch.as_tensor(imgs, device=model.device), cf.train_crop_size,
                        torch.float32)
    folded = I.fold_resnet(net.encoder.resnet_conv)
    means, residual = {}, {}

    def conv(name, xx, p, stride, pad):
        y = I._plain_conv(name, xx, p, stride, pad)
        means[name] = y.float().mean(dim=(0, 1, 2))
        return y

    with torch.no_grad(), I._tf32_off():
        I._folded_forward(folded, x, cf.encoder_backbone, conv)
        I._resnet_int8_carry(folded, x, cf.encoder_backbone, model.int8_scales,
                             bias_corr=model.int8_bias_corr, fp_means=means,
                             collect_into=residual)
    if set(residual) != set(model.int8_bias_corr):
        raise AssertionError("bias corrections and the carry's convs differ")
    share = {k: float(v.abs().max()) / (0.05 * float(means[k].abs().mean()) + 1e-3)
             for k, v in residual.items()}
    worst = max(share, key=share.get)
    if share[worst] >= 1:
        raise AssertionError(f"bias correction of {worst}: a second pass's mean error "
                             f"{share[worst]:.3f} of its bound")
    return share[worst]


def profile_decode(run, out_dir, smi, tag):
    """torch.profiler over one end-to-end run (utils/profiling.py::
    profile_trace, its Chrome trace in a temporary dir), read through
    utils/trace_report.py: device time by kernel name (all of it to
    out_dir/profile_e2e_<tag>.txt where out_dir is given, the largest
    printed) and the device's busy share of the window (union of kernel
    intervals over the wall time). Returns (the kernel table [(name, ms,
    launches)], busy us, wall us)."""
    import tempfile

    import torch

    from adaptive_tpu_torch.utils import trace_report
    from adaptive_tpu_torch.utils.profiling import profile_trace

    with tempfile.TemporaryDirectory() as trace_dir:
        with profile_trace(trace_dir):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = trace_report.load_trace_events(trace_dir)
    rows = trace_report.device_op_summary(events)
    busy = trace_report.stage_split(events)["busy_ms"] * 1e3
    total = sum(ms for _, ms, _ in rows) * 1e3
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"profile_e2e_{tag}.txt"), "w") as f:
            f.write(f"{smi}; wall {wall_us:.1f} us, busy {busy:.1f} us\n")
            f.writelines(f"{ms * 1e3:12.1f} us {n:6d}x  {name}\n" for name, ms, n in rows)
    log(f"[profile {tag} bf16] {smi}: wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
        f"({busy / wall_us:.4f} of the window), kernel time {total / 1e3:.3f} ms; top: "
        + "; ".join(f"{name[:70]} {ms:.3f} ms x{n}" for name, ms, n in rows[:10]))
    return rows, busy, wall_us


# ----------------------------------------------------------------- phase 4
def greedy_gaps(model, prepared, images_u8, cf):
    """Top-2 logit gap of every row at every step of the model's greedy
    decode on its device (the CPU's in phase 4), with the head twin's
    arithmetic (the cell's a, c_hat for the adaptive variant, + h rounded to
    the weight's type, fp32 logits); also returns its ids."""
    import torch

    from adaptive_tpu_torch.models import decoders as Dm
    from adaptive_tpu_torch.ops.preprocess import eval_preprocess

    dev = model.device
    with torch.no_grad():
        V, v_g, h0, c0 = model.encode_inference(prepared, eval_preprocess(
            torch.as_tensor(images_u8, device=dev), cf.train_crop_size, model.compute_dtype))
        dec, (w, b) = prepared["decoder"], prepared["head"]
        pv = model.precompute_slots(dec, V)
        st = model.init_decode_state(h0, c0)
        tok = torch.full((V.shape[0],), cf.decode_start_token, dtype=torch.int32, device=dev)
        ids, gaps = [], []
        for _ in range(STEPS):
            x = torch.cat([dec["embed"][tok], v_g], dim=-1)
            h_new, c_new, chat, _, _ = Dm._cell(dec, model.spec, x, st, False, V, pv,
                                                model.fused)
            logits = (chat + h_new).to(w.dtype).float() @ w.float() + b.float()
            logits[:, VOCAB:] = -1e30
            top2 = logits.topk(2, dim=1)
            gaps.append(top2.values[:, 0] - top2.values[:, 1])
            tok = top2.indices[:, 0].to(torch.int32)
            ids.append(tok)
            st = Dm.DecodeState(h_new, c_new, h_new)
    return torch.stack(ids, 1), torch.stack(gaps, 1)


def fp32_models(images_u8, **cf_kw):
    """The fp32 model on the card and the same weights on the CPU (cf_kw:
    other Config knobs, the decoder variant's)."""
    import torch

    from adaptive_tpu_torch import Config
    from adaptive_tpu_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cf = Config(compute_dtype="float32", **cf_kw)
    model_g, net_g = random_model(cf, "cuda", images_u8[:32])
    model_c = build_model(cf, device="cpu")
    net_c = model_c.init(SEED)
    net_c.load_state_dict({k: v.cpu() for k, v in net_g.state_dict().items()})
    return cf, model_g, net_g, model_c, net_c


def cross_device_parity(cf, model_g, net_g, model_c, net_c, images_u8, tag="parity fp32"):
    from adaptive_tpu_torch.decoding import make_greedy_decoder

    imgs = images_u8[:8]
    out_g = make_greedy_decoder(model_g, cf)(net_g, imgs)
    out_c = make_greedy_decoder(model_c, cf)(net_c, imgs)
    ids_g, ids_c = out_g.ids.cpu(), out_c.ids
    ref_ids, gaps = greedy_gaps(model_c, model_c.prepare_inference(net_c), imgs, cf)
    att_err = 0.0
    for row in range(imgs.shape[0]):
        diff = (ids_g[row] != ids_c[row]).nonzero()
        t = int(diff[0]) if len(diff) else STEPS
        if t < STEPS:
            gap = float(gaps[row, t])
            log(f"[{tag}] row {row} differs from step {t}: CPU top-2 gap there {gap:.3e}")
            if gap >= PARITY_GAP_EPS or int(ref_ids[row, t]) != int(ids_c[row, t]):
                raise AssertionError(f"row {row}: ids differ at step {t} with top-2 gap {gap:.3e}")
        # up to the first differing id both devices decode the same tokens
        for name, a, b in (("attention", out_g.attention, out_c.attention),
                           ("beta", out_g.beta, out_c.beta)):
            att_err = max(att_err, check_close(
                f"parity {name} row {row}", a[row, :t + 1].cpu(), b[row, :t + 1], PARITY_ATOL, 0.0))
    n_same = int((ids_g == ids_c).all(1).sum())
    distinct = len({tuple(r) for r in ids_c.tolist()})
    log(f"[{tag}, TF32 off] card vs CPU: {n_same}/{imgs.shape[0]} captions identical "
        f"({distinct} distinct); attention/beta max abs err {att_err:.3e} (atol {PARITY_ATOL}); "
        f"min top-2 gap over all steps {float(gaps.min()):.3e}; first: {ids_g[0, :12].tolist()}")
    return {"identical": n_same, "images": imgs.shape[0], "max_abs_err": att_err,
            "min_gap": float(gaps.min())}


# ---------------------------------------------------------------- phase 4b
def beam_gaps(model, prepared, images_u8, cf, W):
    """The model's beam decode (fused path) step by step on its device (the
    CPU's, with the plain twins, in phase 4b), with each row's top W+1
    tokens: the flat top W+1 of the beam x token candidates holds every
    candidate that could take one of the W slots, and the smallest gap
    between two adjacent ones says how near a swap was. Returns (all_ids
    [n, W, STEPS], per-step min gap [n, STEPS])."""
    import torch

    from adaptive_tpu_torch.models.decoders import DecodeState
    from adaptive_tpu_torch.ops.fused_step import topk_lower_index_first
    from adaptive_tpu_torch.ops.preprocess import eval_preprocess

    dev = model.device
    with torch.no_grad():
        V, v_g, h0, c0 = model.encode_inference(prepared, eval_preprocess(
            torch.as_tensor(images_u8, device=dev), cf.train_crop_size, model.compute_dtype))
        dec, head = prepared["decoder"], prepared["head"]
        pv = model.precompute_slots(dec, V)
        n, k = V.shape[0], W + 1
        st = model.init_decode_state(h0.repeat_interleave(W, 0), c0.repeat_interleave(W, 0))
        vg = v_g.repeat_interleave(W, 0)
        dead = torch.tensor([0.0] + [-1e9] * W, device=dev)
        scores = dead[:W].expand(n, W)
        tok = torch.full((n, W), cf.decode_start_token, dtype=torch.int32, device=dev)
        finished = torch.zeros((n, W), dtype=torch.bool, device=dev)
        img = torch.arange(n, device=dev)[:, None]
        toks, parents, gaps = [], [], []
        for _ in range(STEPS):
            lp, tk, _, _, st = model.beam_decode_step(dec, tok.reshape(-1), vg, st, V, k,
                                                      pv=pv, head=head, beam_w=W)
            lp = torch.where(finished[..., None], dead, lp.reshape(n, W, k))
            tk = tk.reshape(n, W, k).masked_fill(finished[..., None], cf.decode_eos_token)
            top, idx = topk_lower_index_first((scores[..., None] + lp).reshape(n, W * k), k)
            gaps.append((top[:, :-1] - top[:, 1:]).min(1).values)
            scores, idx = top[:, :W], idx[:, :W]
            src = idx // k
            tok = tk.reshape(n, W * k).gather(1, idx)
            st = DecodeState(*(x.reshape(n, W, -1)[img, src].reshape(n * W, -1) for x in st))
            finished = finished.gather(1, src) | (tok == cf.decode_eos_token)
            toks.append(tok)
            parents.append(src)
        ptr, ids = torch.arange(W, device=dev).expand(n, W), []
        for tok_t, par_t in zip(reversed(toks), reversed(parents)):
            ids.append(tok_t.gather(1, ptr))
            ptr = par_t.gather(1, ptr)
    return torch.stack(ids[::-1], 2), torch.stack(gaps, 1)


def beam_parity(cf, model_g, net_g, model_c, net_c, images_u8, tag="beam parity fp32", W=BEAM,
                length_alpha=0.0):
    """Phase 4b: 8 images beam-decoded at width W (length_alpha: the
    decoder's length normalisation of the final scores, which picks the best
    beam and leaves the beams as they are) on the card and on the CPU."""
    import torch

    from adaptive_tpu_torch.decoding import make_beam_decoder

    imgs = images_u8[:8]
    out_g = make_beam_decoder(model_g, cf, beam_size=W, length_alpha=length_alpha)(net_g, imgs)
    out_c = make_beam_decoder(model_c, cf, beam_size=W, length_alpha=length_alpha)(net_c, imgs)
    ref_ids, gaps = beam_gaps(model_c, model_c.prepare_inference(net_c), imgs, cf, W)
    if not torch.equal(ref_ids, out_c.all_ids):
        raise AssertionError("the step-by-step CPU beam decode disagrees with make_beam_decoder")
    err = 0.0
    n_same = 0
    for row in range(imgs.shape[0]):
        gap = float(gaps[row].min())
        if not torch.equal(out_g.all_ids[row].cpu(), out_c.all_ids[row]):
            log(f"[{tag}] image {row}: beams differ; CPU min adjacent flat-candidate "
                f"gap over the steps {gap:.3e}")
            if gap >= PARITY_GAP_EPS:
                raise AssertionError(f"image {row}: beams differ with candidate gaps >= {gap:.3e}")
            continue
        n_same += 1
        err = max(err, check_close(f"beam parity all_scores image {row}",
                                   out_g.all_scores[row].cpu(), out_c.all_scores[row],
                                   BEAM_SCORE_ATOL, 0.0))
        if not torch.equal(out_g.ids[row].cpu(), out_c.ids[row]):
            log(f"[{tag}] image {row}: another best beam (scores "
                f"{out_c.all_scores[row].tolist()})")
            continue
        for name, a, b in (("attention", out_g.attention, out_c.attention),
                           ("beta", out_g.beta, out_c.beta)):
            err = max(err, check_close(f"beam parity {name} image {row}", a[row].cpu(), b[row],
                                       PARITY_ATOL, 0.0))
    distinct = len({tuple(r) for r in out_c.ids.tolist()})
    log(f"[{tag}, TF32 off] beam {W}, length_alpha {length_alpha}, card vs CPU: "
        f"{n_same}/{imgs.shape[0]} images' "
        f"beams identical ({distinct} distinct best captions); scores/attention/beta max abs "
        f"err {err:.3e} (atol {BEAM_SCORE_ATOL}/{PARITY_ATOL}); min adjacent candidate gap "
        f"{float(gaps.min()):.3e}; first: {out_g.ids[0, :12].tolist()}")
    return {"identical": n_same, "images": imgs.shape[0], "max_abs_err": err,
            "min_gap": float(gaps.min())}


# ----------------------------------------------------------------- phase 7
def eval_split(root, n, seed):
    """A synthetic caption split of n images under root: a COCO annotation
    JSON with EVAL_REFS captions an image (data/synthetic.py, no image
    files), its images phase 3's seeded_images at 256 px made EVAL_CHUNK at a
    time and held in memory, and a vocabulary of the captions' words, then
    filler words up to VOCAB. Returns (annotation path, images, dataset,
    Vocabulary): the dataset, for coco_eval(dataset=), lists (image, image
    id), so the phase needs no JPEG codec (Pillow), which a card's machine
    need not have."""
    import numpy as np

    from adaptive_tpu_torch.data.coco_api import COCO
    from adaptive_tpu_torch.data.synthetic import make_synthetic_dataset
    from adaptive_tpu_torch.data.vocab import build_vocab

    ann, _ = make_synthetic_dataset(root, num_images=n, captions_per_image=EVAL_REFS,
                                    seed=seed, write_images=False)
    images = np.concatenate([seeded_images(min(EVAL_CHUNK, n - s), seed + 1 + s // EVAL_CHUNK)
                             for s in range(0, n, EVAL_CHUNK)])
    vocab = build_vocab((a["caption"] for a in COCO(ann).anns.values()), threshold=1)
    for i in range(len(vocab), VOCAB):
        vocab.add_word(f"filler{i}")
    return ann, images, list(zip(images, range(1, n + 1))), vocab


@contextlib.contextmanager
def timed_spans(spans):
    """Wrap each (owner, attribute, label) so that its calls add their host
    seconds to times[label]; restores the originals on exit."""
    times = {label: 0.0 for _, _, label in spans}
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in spans]

    def wrap(fn, label):
        @functools.wraps(fn)
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                times[label] += time.perf_counter() - t0
        return timed

    for (owner, attr, label), (_, _, fn) in zip(spans, saved):
        setattr(owner, attr, wrap(fn, label))
    try:
        yield times
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def eval_spans():
    """The driver's stages and the scorers, as timed_spans takes them."""
    from adaptive_tpu_torch.data.coco_api import COCO
    from adaptive_tpu_torch.evalcap import bleu, cider, coco_eval, eval as ev, meteor, ptbtokenizer, rouge
    from adaptive_tpu_torch.models import infer

    return [(infer, "calibrate_model", "calibrate"), (coco_eval, "decode_split", "decode"),
            (json, "dump", "write"), (COCO, "__init__", "load"), (COCO, "loadRes", "load"),
            (ev.COCOEvalCap, "evaluate", "score"), (ptbtokenizer.PTBTokenizer, "tokenize", "ptb"),
            (bleu.Bleu, "compute_score", "bleu"), (meteor.Meteor, "compute_score", "meteor"),
            (rouge.Rouge, "compute_score", "rouge"), (cider.Cider, "compute_score", "cider")]


def text_backends():
    """Which caption tokenizer and METEOR stemmer run: nltk's, or the
    packages' fallbacks where nltk is not installed."""
    from adaptive_tpu_torch.data import tokenizer
    from adaptive_tpu_torch.evalcap import meteor

    return ("nltk" if tokenizer._TREEBANK is not None else "fallback",
            "fallback" if meteor._STEM is meteor._fallback_stem else "nltk")


def read_results(path, n):
    """The results JSON: one caption for each of the split's n images."""
    with open(path) as f:
        results = json.load(f)
    if sorted(r["image_id"] for r in results) != list(range(1, n + 1)):
        raise AssertionError(f"{path}: {len(results)} results, not one for each of {n} images")
    if not all(isinstance(r["caption"], str) for r in results):
        raise AssertionError(f"{path}: a caption is not a string")
    return results


def eval_driver(net, cf, smi):
    """Phase 7a: coco_eval at full width in bf16 over a 5,000-image split
    with 5 captions an image at the reference's eval batch (400; 13 batches,
    the last padded), greedy, beam 3 and int8 (a) (per-channel scales that
    coco_eval calibrates on the split's first 32 images), each with the
    launch counts set to 0 before and read after; the wall time and its
    split into decode, results JSON, annotation loads and scoring."""
    import tempfile

    import numpy as np
    import torch

    from adaptive_tpu_torch.evalcap.coco_eval import coco_eval
    from adaptive_tpu_torch.models import build_model

    n_batches = -(-EVAL_IMAGES // EVAL_BATCH)
    loop = n_batches * STEPS
    greedy = {"adaptive_decode_cell_fused": loop, "greedy_head_argmax": loop,
              "adaptive_decode_cell_fused_beam": 0, "beam_head_topk": 0}
    beam = {"adaptive_decode_cell_fused": 0, "greedy_head_argmax": 0,
            "adaptive_decode_cell_fused_beam": loop, "beam_head_topk": loop}
    none = {"bottleneck_identity_int8": 0, "tail_conv1_int8": 0, "ssm_step": 0}
    exact = {**none, "folded_epilogue": n_batches * ENCODE_EPILOGUES}
    modes = (("greedy", {}, {**greedy, **exact}), (f"beam{BEAM}", {"beam_size": BEAM}, {**beam, **exact}),
             ("int8_a", {"encoder_quant": "int8"}, {**greedy, **none, "folded_epilogue": 0}))
    tok, stem = text_backends()
    out = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        ann, images, split, vocab = eval_split(root, EVAL_IMAGES, SEED + 100)
        log(f"[eval split] {EVAL_IMAGES} images at 256 px ({images.nbytes / 2**20:.1f} MiB in "
            f"host memory), {EVAL_REFS} captions an image, vocabulary {len(vocab)}: made in "
            f"{time.perf_counter() - t0:.2f} s")
        jpeg_decode(images[:EVAL_BATCH])
        for epoch, (tag, kw, expect) in enumerate(modes, 1):
            ecf = cf.replace(val_anno_path=ann, eval_batch_size=EVAL_BATCH, exp_dir=root, **kw)
            model = build_model(ecf)
            per_image = {}
            torch.cuda.synchronize()
            with timed_spans(eval_spans()) as t:
                reset_launch_counts()
                t0 = time.perf_counter()
                cider = coco_eval(ecf, model, net, epoch=epoch, vocab=vocab, per_image_out=per_image,
                                  dataset=split)
                wall = time.perf_counter() - t0
                launches = launch_counts()
            for name, n in expect.items():
                if launches[name] != n:
                    raise AssertionError(f"eval {tag}: {name} launched {launches[name]} times, "
                                         f"expected {n}")
            results = read_results(os.path.join(root, "val_results", f"validation-{epoch}.json"),
                                   EVAL_IMAGES)
            if len(per_image) != EVAL_IMAGES or not np.isfinite(cider):
                raise AssertionError(f"eval {tag}: {len(per_image)} per-image scores, CIDEr {cider}")
            distinct = len({r["caption"] for r in results})
            rest = wall - t["decode"] - t["write"] - t["load"] - t["score"] - t["calibrate"]
            log(f"[eval driver {tag} bf16] {smi}: {EVAL_IMAGES} images, batch {EVAL_BATCH} "
                f"({n_batches} batches): coco_eval {wall:.3f} s, {EVAL_IMAGES / wall:.1f} images/s; "
                f"decode_split {t['decode']:.3f} s ({EVAL_IMAGES / t['decode']:.1f} images/s), "
                f"calibration {t['calibrate']:.3f} s, results JSON {t['write']:.3f} s, annotation "
                f"loads {t['load']:.3f} s, COCOEvalCap.evaluate {t['score']:.3f} s (PTB tokenizer "
                f"{t['ptb']:.3f}, BLEU {t['bleu']:.3f}, METEOR {t['meteor']:.3f}, ROUGE-L "
                f"{t['rouge']:.3f}, CIDEr {t['cider']:.3f}), the rest {rest:.3f} s; launches "
                f"{ {k: v for k, v in launches.items() if v} }; {len(results)} results "
                f"({distinct} distinct captions), CIDEr {cider:.6g}; tokenizer {tok}, stemmer {stem}")
            out[tag] = {"wall_s": wall, "images_per_s": EVAL_IMAGES / wall,
                        **{f"{k}_s": v for k, v in t.items()}, "launches": launches,
                        "results": len(results), "cider": cider}
            del model
            torch.cuda.empty_cache()
    return {"card": smi, "images": EVAL_IMAGES, "batch": EVAL_BATCH, "tokenizer": tok,
            "stemmer": stem, "modes": out}


def jpeg_decode(images):
    """An extra line, where PIL is installed: the host time of decoding the
    split's images as 256 px JPEGs, one thread (the JPEG split's loader,
    data/loader.py, runs such decodes on dataloader_num_workers threads)."""
    import io

    from adaptive_tpu_torch.data.loader import _load_image_uint8

    try:
        from PIL import Image
    except ImportError:
        log("[eval jpeg] PIL is not installed here: JPEG decode not timed")
        return
    blobs = []
    for img in images:
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG")
        blobs.append(buf.getvalue())
    t0 = time.perf_counter()
    for b in blobs:
        _load_image_uint8(io.BytesIO(b))
    s = time.perf_counter() - t0
    log(f"[eval jpeg] {len(blobs)} images of 256 px, {sum(map(len, blobs)) / len(blobs) / 1024:.1f} "
        f"KiB each: {s / len(blobs) * 1e3:.3f} ms an image on one thread")


def explain_by_gaps(tag, model_c, net_c, cf, batches_g, batches_c, index):
    """An image whose caption differs card vs CPU: its ids must differ where
    the CPU's decode was within PARITY_GAP_EPS of another choice (phase 4's
    top-2 gap rule, greedy; phase 4b's adjacent-candidate rule, beam)."""
    b, row = divmod(index, len(batches_c[0][0]))
    imgs = batches_c[b][0]
    prepared = model_c.prepare_inference(net_c)
    if cf.beam_size > 1:
        _, gaps = beam_gaps(model_c, prepared, imgs, cf, cf.beam_size)
        gap = float(gaps[row].min())
    else:
        ids_g, ids_c = batches_g[b][1].ids[row].cpu(), batches_c[b][1].ids[row]
        t = int((ids_g != ids_c).nonzero()[0])
        ref_ids, gaps = greedy_gaps(model_c, prepared, imgs, cf)
        gap = float(gaps[row, t])
        if int(ref_ids[row, t]) != int(ids_c[t]):
            raise AssertionError(f"[eval parity {tag}] the step-by-step CPU decode disagrees")
    log(f"[eval parity {tag}] image {index + 1}: captions differ; CPU gap {gap:.3e}")
    if gap >= PARITY_GAP_EPS:
        raise AssertionError(f"eval parity {tag}: image {index + 1} differs with gap {gap:.3e}")


def eval_parity(cf, model_g, net_g, model_c, net_c, smi):
    """Phase 7b: coco_eval in fp32 (TF32 off) on a 16-image split at batch 12
    (the second batch short), greedy and beam 3, on the card and on the CPU
    with the same weights: equal results JSON, CIDEr and per-image scores,
    or each differing caption explained by the gap rules of phases 4 and 4b.
    Then valid mode on the card with "auto" over a model.npz of the same
    weights written with the key codec: equal to the in-memory greedy run."""
    import tempfile

    import numpy as np

    from adaptive_tpu_torch.decoding import make_beam_decoder, make_greedy_decoder
    from adaptive_tpu_torch.evalcap.coco_eval import _results_name, coco_eval
    from adaptive_tpu_torch.models.jax_params import to_jax
    from adaptive_tpu_torch.training.checkpoint import checkpoint_name, flatten_tree

    n = EVAL_PARITY_IMAGES
    with tempfile.TemporaryDirectory() as root:
        ann, _, split, vocab = eval_split(root, n, SEED + 200)
        base = cf.replace(val_anno_path=ann, eval_batch_size=EVAL_PARITY_BATCH, exp_dir=root)
        runs = {}
        for tag, kw in (("greedy", {}), (f"beam {BEAM}", {"beam_size": BEAM})):
            ecf = base.replace(**kw)
            got = {}
            for dev, model, net in (("card", model_g, net_g), ("CPU", model_c, net_c)):
                make = make_beam_decoder if ecf.beam_size > 1 else make_greedy_decoder
                decode, batches = make(model, ecf), []

                def recorded(net_, imgs, decode=decode, batches=batches):
                    res = decode(net_, imgs)
                    batches.append((imgs, res))
                    return res

                per_image = {}
                d = os.path.join(root, tag.replace(" ", ""), dev)
                c = coco_eval(ecf.replace(exp_dir=d), model, net, epoch=1, vocab=vocab,
                              decoder=recorded, per_image_out=per_image, dataset=split)
                res = read_results(os.path.join(d, "val_results", "validation-1.json"), n)
                got[dev] = (res, c, per_image, batches)
            (rg, cg, pg, bg), (rc, cc, pc, bc) = got["card"], got["CPU"]
            same = [i for i in range(n) if rg[i] == rc[i]]
            for i in sorted(set(range(n)) - set(same)):
                explain_by_gaps(tag, model_c, net_c, ecf, bg, bc, i)
            if len(same) == n and cg != cc:
                raise AssertionError(f"eval parity {tag}: CIDEr {cg} on the card, {cc} on the CPU")
            for i in same:
                if pg[rg[i]["image_id"]] != pc[rc[i]["image_id"]]:
                    raise AssertionError(f"eval parity {tag}: image {i + 1}'s scores differ")
            log(f"[eval parity fp32 {tag}, TF32 off] {smi}: card vs CPU through coco_eval, {n} "
                f"images at batch {EVAL_PARITY_BATCH}: {len(same)}/{n} captions identical, their "
                f"per-image scores equal; CIDEr {cg!r} vs {cc!r}; first: {rg[0]['caption'][:60]!r}")
            runs[tag] = {"identical": len(same), "cider_card": cg, "cider_cpu": cc}
            if tag == "greedy":
                in_memory = (rg, cg, pg)

        exp = os.path.join(root, "valid")
        ckpt = os.path.join(exp, "trained_models", checkpoint_name(0.5, 1))
        os.makedirs(ckpt)
        params, state = to_jax(net_g.state_dict(), model_g.arch)
        np.savez(os.path.join(ckpt, "model.npz"), **flatten_tree({"params": params, "state": state}))
        per_image = {}
        reset_launch_counts()
        c = coco_eval(base.replace(valid_pretrained_model="auto", exp_dir=exp), valid_mode=True,
                      vocab=vocab, per_image_out=per_image, dataset=split)
        launches = launch_counts()
        loop = -(-n // EVAL_PARITY_BATCH) * STEPS
        if (launches["adaptive_decode_cell_fused"], launches["greedy_head_argmax"]) != (loop, loop):
            raise AssertionError(f"eval valid mode: launches {launches}")
        res = read_results(os.path.join(exp, "val_results", _results_name(ckpt)), n)
        if (res, c, per_image) != in_memory:
            raise AssertionError("eval valid mode: the restored model.npz scores otherwise than "
                                 "the in-memory weights")
        log(f"[eval valid fp32] {smi}: valid_pretrained_model='auto' picked {os.path.basename(ckpt)}, "
            f"a model.npz written with the key codec, restored on the card: results, CIDEr "
            f"{c!r} and per-image scores equal to the in-memory greedy run; launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        runs["valid_auto_equal"] = True
    return runs


# ----------------------------------------------------------------- phase 8
def train_batch(n, seed, device):
    """n seeded 256 px images with captions in bucket 24 (lengths 17..24:
    <start>, random words, <end>, padding), on device."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    lengths = rng.integers(TRAIN_T - 7, TRAIN_T + 1, n)
    caps = rng.integers(4, VOCAB, (n, TRAIN_T))
    caps[:, 0] = 1
    caps[np.arange(n), lengths - 1] = 2
    caps[np.arange(TRAIN_T)[None, :] >= lengths[:, None]] = 0
    return {"images": torch.as_tensor(seeded_images(n, seed + 1), device=device),
            "captions": torch.as_tensor(caps.astype(np.int32), device=device),
            "lengths": torch.as_tensor(lengths.astype(np.int32), device=device)}


def train_throughput(smi, profile_dir=None, modes=(("encoder_off", False), ("encoder_on", True)),
                     label=None, warmup=TRAIN_WARMUP, steps=TRAIN_STEPS, batch_size=TRAIN_B,
                     **cf_kw):
    """Phase 8a: make_train_step at full width in bf16, batch 256 (batch_size),
    encoder off and on (fine-tuning layers 2-4; modes: (tag, on) pairs;
    cf_kw: other Config knobs, phase 12c's variants and phase 14e's
    configurations; label: the printed lines' tag):
    warmup steps, then steps timed (host clock around synchronised steps), the peak of
    allocated memory over them, and one step under
    torch.utils.flop_counter.FlopCounterMode (the operations of every
    convolution and matmul, forward and backward, from their shapes)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from adaptive_tpu_torch import Config
    from adaptive_tpu_torch.models import build_model
    from adaptive_tpu_torch.training.optim import make_dual_optimizer
    from adaptive_tpu_torch.training.step import make_train_step

    cf = Config(compute_dtype="bfloat16", vocab_pad_multiple=128, train_batch_size=batch_size,
                **cf_kw)
    model = build_model(cf)
    net = model.init(SEED)
    dual = make_dual_optimizer(net, cf)
    step = make_train_step(model, dual, cf)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    batch = train_batch(batch_size, SEED + 300, "cuda")
    out = {}
    label = label or ("train step" if not cf_kw else f"train step {cf.atten_model_name}")
    for tag, on in modes:
        for _ in range(warmup):
            step(net, batch, gen, on)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = [step(net, batch, gen, on).loss for _ in range(steps)]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / steps * 1e3
        peak = torch.cuda.max_memory_allocated()
        losses = torch.stack(losses).float().cpu()
        if not torch.isfinite(losses).all():
            raise AssertionError(f"train {tag}: losses {losses.tolist()}")
        with FlopCounterMode(display=False) as fc:
            step(net, batch, gen, on)
        flops = fc.get_total_flops()
        share = flops / (ms * 1e-3) / PEAK_FLOPS["bfloat16"]
        log(f"[{label} {tag} bf16] {smi}: batch {batch_size}, captions {TRAIN_T}, mean of "
            f"{steps} steps after {warmup}: {ms:.3f} ms a step, "
            f"{batch_size / ms * 1e3:.1f} images/s; peak allocated {peak / 2**30:.2f} GiB; "
            f"{flops / 1e12:.3f} TFLOP a step (convolutions and matmuls), "
            f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s, {share:.4f} of the bf16 peak; losses "
            f"{[round(v, 4) for v in losses.tolist()]}")
        if profile_dir:
            profile_decode(lambda: step(net, batch, gen, on), profile_dir, smi,
                           f"train_{tag}" if not cf_kw else f"train_{cf.atten_model_name}_{tag}")
        out[tag] = {"ms": ms, "images_per_s": batch_size / ms * 1e3, "peak_bytes": peak,
                    "tflop": flops / 1e12,
                    "bf16_peak_share": share, "losses": losses.tolist()}
    del net, dual, step
    torch.cuda.empty_cache()
    return out


def train_split(root, vocab):
    """Phase 8b's train split: TRAIN_IMAGES seeded 256 px images held in
    memory, one synthetic caption each, served through CocoCaptionDataset's
    interface (TrainBatches reads its ids, coco.anns and vocab)."""
    from adaptive_tpu_torch.data.loader import CocoCaptionDataset
    from adaptive_tpu_torch.data.synthetic import make_synthetic_dataset

    ann, _ = make_synthetic_dataset(os.path.join(root, "train"), num_images=TRAIN_IMAGES,
                                    seed=SEED + 400, write_images=False)
    images = seeded_images(TRAIN_IMAGES, SEED + 401)

    class Memory(CocoCaptionDataset):
        def __getitem__(self, index):
            a = self.coco.anns[self.ids[index]]
            return images[a["image_id"] - 1], self.vocab.encode_caption(a["caption"]), a["image_id"]

    return ann, Memory(root, ann, vocab)


def train_loop(smi):
    """Phase 8b: main_train at full width in bf16 on a 1,024-image train
    split in memory (batch 256, 4 steps an epoch), 2 epochs, fine-tuning
    from epoch 2, a step checkpoint every 2 steps, the per-epoch eval
    (greedy, one shared decoder) on 400-image train_eval and val splits in
    memory. Checks the launches (2 epochs x 2 coco_eval x 1 batch x 30
    steps of kernels 1 and 2, none of 3-6), the two epoch checkpoints, no
    step checkpoint left, and that valid mode "auto" restores the best one
    and writes the captions its epoch's val eval wrote."""
    import tempfile

    import numpy as np
    import torch

    from adaptive_tpu_torch import Config
    from adaptive_tpu_torch.evalcap import coco_eval as ce
    from adaptive_tpu_torch.evalcap.coco_eval import _results_name
    from adaptive_tpu_torch.training import checkpoint as ckpt
    from adaptive_tpu_torch.training.train_loop import main_train

    with tempfile.TemporaryDirectory() as root:
        val_ann, _, val_split, vocab = eval_split(os.path.join(root, "val"), TRAIN_EVAL_IMAGES,
                                                  SEED + 500)
        te_ann, _, te_split, _ = eval_split(os.path.join(root, "train_eval"),
                                            TRAIN_EVAL_IMAGES, SEED + 600)
        vocab_path = os.path.join(root, "vocab.json")
        vocab.save(vocab_path)
        ann, train_ds = train_split(root, vocab)
        cf = Config(compute_dtype="bfloat16", vocab_pad_multiple=128, vocab_path=vocab_path,
                    train_anno_path=ann, val_anno_path=val_ann, train_eval_anno_path=te_ann,
                    exp_dir=root, train_batch_size=TRAIN_B, train_num_epochs=TRAIN_EPOCHS,
                    opt_fine_tune_cnn_start_epoch=1, train_evalOrnot=True,
                    train_checkpoint_every_steps=2, eval_batch_size=EVAL_BATCH)
        spans = [(ce, "coco_eval", "eval"), (ckpt, "_model_flat", "copy_model"),
                 (ckpt, "_opt_flat", "copy_opt"), (ckpt.AsyncCheckpointer, "wait", "ckpt_wait")]
        torch.cuda.synchronize()
        with timed_spans(spans) as t:
            reset_launch_counts()
            t0 = time.perf_counter()
            net, best, best_epoch = main_train(
                cf, dataset=train_ds, eval_datasets={"val": val_split, "train_eval": te_split})
            wall = time.perf_counter() - t0
            launches = launch_counts()
        loop = TRAIN_EPOCHS * 2 * STEPS
        expect = {"adaptive_decode_cell_fused": loop, "greedy_head_argmax": loop,
                  "adaptive_decode_cell_fused_beam": 0, "beam_head_topk": 0,
                  "bottleneck_identity_int8": 0, "tail_conv1_int8": 0,
                  "folded_epilogue": TRAIN_EPOCHS * 2 * ENCODE_EPILOGUES, "ssm_step": 0}
        if launches != expect:
            raise AssertionError(f"main_train launches {launches}, expected {expect}")
        d = os.path.join(root, "trained_models")
        names = sorted(os.listdir(d))
        want = [n for n in names if n.startswith("cider-") and n.endswith(("_model-1", "_model-2"))]
        if len(want) != 2 or len(names) != 2:
            raise AssertionError(f"trained_models holds {names}")
        with open(os.path.join(d, names[-1], "manifest.json")) as f:
            meta = json.load(f)
        losses = meta["train_epoch_losses"]
        if len(losses) != TRAIN_EPOCHS or not np.all(np.isfinite(losses)):
            raise AssertionError(f"epoch losses {losses}")
        sizes = {n: sum(os.path.getsize(os.path.join(d, n, f)) for f in os.listdir(
            os.path.join(d, n))) for n in names}

        # valid mode "auto": the best checkpoint, restored, writes its epoch's captions
        vcf = cf.replace(valid_pretrained_model="auto", vocab_length=len(vocab))
        t1 = time.perf_counter()
        cider = ce.coco_eval(vcf, valid_mode=True, vocab=vocab, dataset=val_split)
        valid_s = time.perf_counter() - t1
        path = ckpt.find_best_checkpoint(d)
        with open(os.path.join(root, "val_results", _results_name(path))) as f:
            restored = json.load(f)
        epoch = ckpt.epoch_from_filename(path)
        with open(os.path.join(root, "val_results", f"validation-{epoch}.json")) as f:
            in_memory = json.load(f)
        if restored != in_memory or cider != meta["cider_scores"][epoch - 1]:
            raise AssertionError(f"valid 'auto' from {path}: captions or CIDEr {cider} differ "
                                 f"from epoch {epoch}'s val eval")
    steps = TRAIN_EPOCHS * TRAIN_IMAGES // TRAIN_B
    copy_s = t["copy_model"] + t["copy_opt"]
    train_s = wall - t["eval"] - copy_s - t["ckpt_wait"]
    log(f"[train loop bf16] {smi}: main_train, {TRAIN_IMAGES} images, batch {TRAIN_B}, "
        f"{TRAIN_EPOCHS} epochs ({steps} steps, encoder on in epoch 2), eval on 2 x "
        f"{TRAIN_EVAL_IMAGES} images an epoch: {wall:.3f} s ({wall / TRAIN_EPOCHS:.3f} s an epoch "
        f"with its eval); the per-epoch coco_eval {t['eval']:.3f} s, checkpoints' host copies "
        f"{copy_s:.3f} s (weights {t['copy_model']:.3f}, moments {t['copy_opt']:.3f}), waits "
        f"for the writer thread {t['ckpt_wait']:.3f} s, the rest (loader, steps, "
        f"logging) {train_s:.3f} s; launches { {k: v for k, v in launches.items() if v} }; "
        f"epoch losses {losses}, CIDEr {meta['cider_scores']} (best epoch {best_epoch}); "
        f"checkpoints {names} ({[round(v / 2**30, 3) for v in sizes.values()]} GiB), step "
        f"checkpoints pruned; valid 'auto' restored {os.path.basename(path)} in {valid_s:.3f} s: "
        f"captions and CIDEr equal to epoch {epoch}'s val eval")
    torch.cuda.empty_cache()
    return {"wall_s": wall, "epoch_s": wall / TRAIN_EPOCHS, "eval_s": t["eval"],
            "ckpt_copy_s": copy_s, "ckpt_wait_s": t["ckpt_wait"], "rest_s": train_s,
            "launches": launches, "epoch_losses": losses, "cider": meta["cider_scores"],
            "checkpoint_bytes": sizes, "valid_auto_equal": True}


def train_parity(cf, net_g, net_c, smi, label="train parity fp32"):
    """Phase 8c: one train step in fp32 (TF32 off) from the same full-width
    weights (phase 4's) and batch of TRAIN_PARITY_B on the card and on the
    CPU, with the encoder off and then on (each from the original weights),
    the crops and flips drawn once on the CPU for both. Held: loss and LSTM
    grad norm within TRAIN_RTOL (relative); BN running statistics within
    TRAIN_BN_TOL; the decoder group's gradients within TRAIN_GRAD_ATOL +
    TRAIN_GRAD_RTOL max|g| (the tensor's) and its weights within
    TRAIN_PARAM_ATOL where the gradient is past that bound (elsewhere Adam may
    take either sign: up to 2 lr). The encoder group's gradients
    (encoder on) are ill-conditioned at these weights: train-mode BN's
    backward subtracts each channel's mean gradient over 4 images, and the
    cancellation grows rounding through ResNet-152's blocks, so the CPU run
    again with another thread count (another summation order) moves them by
    about 1% of their norm. They are held to TRAIN_ENC_GRAD_REL of their
    norm, and the encoder's weights to Adam's bound on a first update, lr
    each way. With the encoder off its weights do not move on either."""
    import torch

    from adaptive_tpu_torch.models import build_model
    from adaptive_tpu_torch.training import optim
    from adaptive_tpu_torch.training.optim import make_dual_optimizer
    from adaptive_tpu_torch.training.step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    start = {k: v.detach().cpu().clone() for k, v in net_c.state_dict().items()}
    batch = train_batch(TRAIN_PARITY_B, SEED + 700, "cpu")
    threads = torch.get_num_threads()

    def run(net, on):
        device = next(net.parameters()).device
        net.load_state_dict(start)
        model = build_model(cf, device=device)
        dual = make_dual_optimizer(net, cf)
        # the gradients as the step hands them to the first group's update:
        # torch's foreach SGD (the card's default) adds its Nesterov term
        # into .grad in place, the CPU's single-tensor SGD does not
        grads = {}
        update = optim.DualOptimizer.step

        def recorded(self, *a, **kw):
            if not grads:
                grads.update({n: p.grad.detach().cpu().clone() for n, p in net.named_parameters()
                              if p.grad is not None})
            return update(self, *a, **kw)

        optim.DualOptimizer.step = recorded
        try:
            res = make_train_step(model, dual, cf)(
                net, {k: v.to(device) for k, v in batch.items()},
                torch.Generator().manual_seed(SEED), on)
        finally:
            optim.DualOptimizer.step = update
        return (float(res.loss), float(res.lstm_grad_norm), grads,
                {k: v.detach().cpu() for k, v in net.state_dict().items()}, dual)

    def group_rel(ga, gb, names):
        num = sum(float((ga[k] - gb[k]).double().pow(2).sum()) for k in names)
        den = sum(float(gb[k].double().pow(2).sum()) for k in names)
        return (num / den) ** 0.5

    out = {}
    for tag, on in (("encoder_off", False), ("encoder_on", True)):
        lg, ng, gg, sg, _ = run(net_g, on)
        lc, nc, gc, sc, dual = run(net_c, on)
        d_loss, d_norm = abs(lg - lc) / abs(lc), abs(ng - nc) / abs(nc)
        bn = [k for k in sc if k.endswith(("running_mean", "running_var"))]
        d_bn = max(float(((sg[k] - sc[k]).abs() / sc[k].abs().clamp(min=1)).max()) for k in bn)
        d_bn_abs = max(float((sg[k] - sc[k]).abs().max()) for k in bn)
        if d_loss > TRAIN_RTOL or d_norm > TRAIN_RTOL or d_bn > TRAIN_BN_TOL:
            raise AssertionError(f"train parity {tag}: loss {lg} vs {lc}, LSTM norm {ng} vs {nc}, "
                                 f"BN statistics {d_bn:.3e}")
        dec, enc = dual.names("decoder"), dual.names("encoder")
        g_tol = {k: TRAIN_GRAD_ATOL + TRAIN_GRAD_RTOL * float(gc[k].abs().max()) for k in dec}
        d_grad = max(float((gg[k] - gc[k]).abs().max()) / g_tol[k] for k in dec)
        if d_grad > 1:
            worst = max(dec, key=lambda k: float((gg[k] - gc[k]).abs().max()) / g_tol[k])
            raise AssertionError(f"train parity {tag}: the gradient of {worst} differs by "
                                 f"{float((gg[worst] - gc[worst]).abs().max()):.3e}, max |g| "
                                 f"{float(gc[worst].abs().max()):.3e}")
        # weights whose gradient's sign the bound determines, and the rest
        d_param, flips, d_flip = 0.0, 0, 0.0
        for k in dec:
            d = (sg[k] - sc[k]).abs()
            floor = gc[k].abs() <= g_tol[k]
            if (~floor).any():
                d_param = max(d_param, float(d[~floor].max()))
            if floor.any():
                d_flip = max(d_flip, float(d[floor].max()))
                flips += int((d[floor] > TRAIN_PARAM_ATOL).sum())
        if d_param > TRAIN_PARAM_ATOL or d_flip > 2 * cf.opt_rnn_adam_learning_rate \
                + TRAIN_PARAM_ATOL:
            raise AssertionError(f"train parity {tag}: decoder weights differ by {d_param:.3e} "
                                 f"where the gradient's sign is determined, {d_flip:.3e} where "
                                 f"it is not")
        d_enc = max(float((sg[k] - sc[k]).abs().max()) for k in enc)
        line = {"loss_rel": d_loss, "norm_rel": d_norm, "bn_rel": d_bn, "bn_abs": d_bn_abs,
                "dec_grad_of_bound": d_grad, "dec_param_abs": d_param, "dec_sign_flips": flips,
                "dec_sign_flip_abs": d_flip, "enc_param_abs": d_enc}
        text = ""
        if on:
            torch.set_num_threads(max(1, threads // 2))
            try:
                gc2 = run(net_c, on)[2]
            finally:
                torch.set_num_threads(threads)
            line["enc_grad_rel"] = group_rel(gg, gc, enc)
            line["enc_grad_rel_cpu_vs_cpu"] = group_rel(gc2, gc, enc)
            enc_bound = 2 * cf.opt_cnn_adam_learning_rate + TRAIN_PARAM_ATOL
            if line["enc_grad_rel"] > TRAIN_ENC_GRAD_REL or d_enc > enc_bound:
                raise AssertionError(f"train parity {tag}: encoder gradients "
                                     f"{line['enc_grad_rel']:.3e} of their norm, weights {d_enc:.3e}")
            text = (f"; encoder group: gradients |d| {line['enc_grad_rel']:.2e} of their norm (the "
                    f"CPU against itself at {max(1, threads // 2)} threads, not {threads}: "
                    f"{line['enc_grad_rel_cpu_vs_cpu']:.2e}), weights max |d| {d_enc:.2e}")
        elif d_enc != 0.0:
            raise AssertionError(f"train parity {tag}: the frozen encoder moved by {d_enc:.3e}")
        log(f"[{label} {tag}, TF32 off] {smi}: batch {TRAIN_PARITY_B}, card vs CPU: "
            f"loss {lg:.7f} vs {lc:.7f} (rel {d_loss:.2e}), LSTM grad norm rel {d_norm:.2e}, BN "
            f"running statistics max |d| {d_bn_abs:.2e} (relative to max(1, |v|) {d_bn:.2e}); "
            f"decoder group: gradients max |d| {d_grad:.2e} of their bound, weights max |d| "
            f"{d_param:.2e} where the gradient is past its bound ({flips} elements of gradients "
            f"0 within it moved past {TRAIN_PARAM_ATOL}, max |d| {d_flip:.2e}){text}")
        out[tag] = line
    return out


# ----------------------------------------------------------------- phase 9
@contextlib.contextmanager
def lbfgs_counts():
    """Counts the L-BFGS step's loss evaluations (every forward of a batch:
    the closures' and the extra backward's) and the decoder closure's
    evaluations (each clips the LSTM gradients once); restores on exit."""
    from adaptive_tpu_torch.training import lbfgs

    counts = {"evals": 0, "decoder_evals": 0}
    saved = (lbfgs.masked_ce_sum, lbfgs.clip_lstm_grads)

    def loss(*a, **kw):
        counts["evals"] += 1
        return saved[0](*a, **kw)

    def clip(*a, **kw):
        counts["decoder_evals"] += 1
        return saved[1](*a, **kw)

    lbfgs.masked_ce_sum, lbfgs.clip_lstm_grads = loss, clip
    try:
        yield counts
    finally:
        lbfgs.masked_ce_sum, lbfgs.clip_lstm_grads = saved


def lbfgs_state(dual, group):
    """(inner iterations so far, bytes of the curvature pairs, the last
    iteration's largest move max |t d|) of an L-BFGS group's torch state:
    a move at or below torch's tolerance_change (1e-9) ends the step."""
    opt = dual.group(group)
    st = opt.state.get(opt._params[0], {})
    pairs = st.get("old_dirs", []) + st.get("old_stps", [])
    move = float((st["d"] * st["t"]).abs().max()) if "d" in st else 0.0
    return st.get("n_iter", 0), sum(t.numel() * t.element_size() for t in pairs), move


def lbfgs_throughput(smi, profile_dir=None):
    """Phase 9a: make_lbfgs_train_step at full width in bf16, batch 256,
    captions in bucket 24 (phase 8a's batch), the reference's L-BFGS
    settings (lr 0.5 decoder / 0.01 encoder, max_iter 20, history 50): (i)
    decoder L-BFGS, encoder off; (ii) decoder L-BFGS, encoder Adam on
    (layers 2-4); (iv) both L-BFGS, encoder on. Each from seeded weights:
    1 warm-up step, then LBFGS_STEPS timed (host clock around each
    synchronised step): ms a step (the mean and each step's), images/s, loss evaluations and inner iterations a
    step, peak allocated memory, the curvature pairs' GiB, finite losses."""
    import torch

    from adaptive_tpu_torch import Config
    from adaptive_tpu_torch.models import build_model
    from adaptive_tpu_torch.training.lbfgs import make_lbfgs_train_step
    from adaptive_tpu_torch.training.optim import make_dual_optimizer

    batch = train_batch(TRAIN_B, SEED + 300, "cuda")
    out = {}
    for tag, cnn, on in (("i_dec_lbfgs_enc_off", "adam", False),
                         ("ii_dec_lbfgs_enc_adam", "adam", True),
                         ("iv_both_lbfgs", "lbfgs", True)):
        cf = Config(compute_dtype="bfloat16", vocab_pad_multiple=128, train_batch_size=TRAIN_B,
                    opt_rnn_optimization="lbfgs", opt_cnn_optimization=cnn)
        model = build_model(cf)
        net = model.init(SEED)
        dual = make_dual_optimizer(net, cf)
        step = make_lbfgs_train_step(model, dual, cf)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        groups = [g for g in ("decoder", "encoder") if isinstance(
            dual.group(g), torch.optim.LBFGS) and (g == "decoder" or on)]
        warm = float(step(net, batch, gen, on).loss)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = {g: lbfgs_state(dual, g)[0] for g in groups}
        losses, step_ms = [], []
        with lbfgs_counts() as counts:
            for _ in range(LBFGS_STEPS):
                t0 = time.perf_counter()
                losses.append(step(net, batch, gen, on).loss)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
        ms = sum(step_ms) / LBFGS_STEPS
        peak = torch.cuda.max_memory_allocated()
        losses = [warm] + torch.stack(losses).float().cpu().tolist()
        if not all(map(lambda v: v == v and abs(v) != float("inf"), losses)):
            raise AssertionError(f"lbfgs {tag}: losses {losses} (lr {cf.opt_rnn_lbfgs_lr} / "
                                 f"{cf.opt_cnn_lbfgs_lr})")
        iters = {g: (lbfgs_state(dual, g)[0] - before[g]) / LBFGS_STEPS for g in groups}
        memory = {g: lbfgs_state(dual, g)[1] / 2**30 for g in groups}
        moves = {g: lbfgs_state(dual, g)[2] for g in groups}
        line = {"ms": ms, "step_ms": step_ms, "images_per_s": TRAIN_B / ms * 1e3,
                "peak_bytes": peak,
                "evals_per_step": counts["evals"] / LBFGS_STEPS,
                "decoder_evals_per_step": counts["decoder_evals"] / LBFGS_STEPS,
                "iterations_per_step": iters, "memory_gib": memory, "last_move": moves,
                "losses": losses,
                "params": {g: sum(p.numel() for n, p in net.named_parameters()
                                  if n in dual.names(g)) for g in groups}}
        log(f"[lbfgs step {tag} bf16] {smi}: batch {TRAIN_B}, captions {TRAIN_T}, lr "
            f"{cf.opt_rnn_lbfgs_lr} / {cf.opt_cnn_lbfgs_lr}, max_iter {cf.opt_rnn_lbfgs_max_iter}, "
            f"history {cf.opt_rnn_lbfgs_history}; mean of {LBFGS_STEPS} steps after 1: {ms:.3f} ms "
            f"a step (each {[round(v, 3) for v in step_ms]}), {line['images_per_s']:.1f} "
            f"images/s; loss evaluations a step "
            f"{line['evals_per_step']:.2f} (decoder closure {line['decoder_evals_per_step']:.2f}), "
            f"inner iterations a step {iters}, the last iteration's max |t d| "
            f"{ {g: f'{v:.3e}' for g, v in moves.items()} }; peak allocated "
            f"{peak / 2**30:.2f} GiB, curvature "
            f"pairs { {g: round(v, 3) for g, v in memory.items()} } GiB over "
            f"{line['params']} parameters; losses {[round(v, 4) for v in losses]}")
        if profile_dir:
            profile_decode(lambda: step(net, batch, gen, on), profile_dir, smi, f"lbfgs_{tag}")
        out[tag] = line
        del net, dual, step
        torch.cuda.empty_cache()
    return out


def lbfgs_parity(weight_sets, smi):
    """Phase 9b: two decoder L-BFGS steps in fp32 (TF32 off) at batch
    TRAIN_PARITY_B at the reference's lr 0.5, max_iter LBFGS_PARITY_ITER,
    history LBFGS_PARITY_HISTORY (the second batch's first pair is formed
    against the first batch's last gradient, and the ring wraps), on each
    weight set of weight_sets ({tag: (cf, net_g, net_c)}): on the CPU, on the
    card, on the CPU again at half the threads, and on the CPU in float64
    (the witness), the crops and flips drawn on the CPU for all. Each step
    starts from the first CPU run's state before it (the weights, BN
    statistics and the memory through the checkpoint codec): the steps' own
    gaps, not their sum.

    Step 1 forms its first pair over torch's first move, min(1, 1/|g|_1) lr
    along -g: over ~12M parameters a few fp32 ulps a weight, across which
    the gradient changes by ~1% of its largest element. An encoder head's
    ReLU unit whose pre-activation lies within fp32 rounding of 0 (the
    rounding of a pre-activation reaches ~6e-5) may sit on the other side
    of 0 from the float64 run at one of the step's points; its gradient
    jumps there by the unit's whole term, that jump dominates the pair,
    and every later iteration follows it. The exact function is not smooth
    there, so no fp32 run can be held to float64 across it. (A unit across
    at a later point, after a move of lr, shifts a pair of the gradient's
    own order by one unit's term: the runs part by no more than without
    it.) Step 1 is held by what is conditioned: count and n_iter equal,
    the first loss and t within TRAIN_RTOL (relative), the first
    evaluation's gradient (after the LSTM clip) within phase 8c's decoder
    bound TRAIN_GRAD_ATOL + TRAIN_GRAD_RTOL max|g|; and where neither point
    of the first pair (the step's first two evaluations) has a head's ReLU
    unit on the other side of 0 from the float64 run on the card, its
    weights and pairs are within LBFGS_WITNESS_RATIO times the CPU's
    distance to the float64 run (the farther of its two runs) plus
    LBFGS_PARAM_REL / LBFGS_MEMORY_REL. Step 2 starts from a memory of
    conditioned pairs (its first across the batch boundary, a gradient
    change of the gradient's own order) and is held as step 1 plus the
    decoder group's weights within LBFGS_PARAM_REL of each tensor's
    largest element and the pairs s, y within LBFGS_MEMORY_REL of each
    row's largest element."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for tag, (cf, net_g, net_c) in weight_sets.items():
        out[tag] = lbfgs_parity_weights(tag, cf, net_g, net_c, smi)
    return out


def lbfgs_parity_weights(tag, cf, net_g, net_c, smi):
    """Phase 9b on one weight set (lbfgs_parity)."""
    import numpy as np
    import torch

    from adaptive_tpu_torch.models import build_model
    from adaptive_tpu_torch.models import encoder as E
    from adaptive_tpu_torch.training import lbfgs
    from adaptive_tpu_torch.training.optim import make_dual_optimizer

    lcf = cf.replace(opt_rnn_optimization="lbfgs", opt_rnn_lbfgs_max_iter=LBFGS_PARITY_ITER,
                     opt_rnn_lbfgs_history=LBFGS_PARITY_HISTORY)
    start = {k: v.detach().cpu().clone() for k, v in net_c.state_dict().items()}
    batches = [train_batch(TRAIN_PARITY_B, SEED + 800 + i, "cpu") for i in range(2)]
    threads = torch.get_num_threads()

    def run(net, before=None, dtype=None):
        """Per step: its first loss, the first evaluation's gradient (the
        decoder group's, after the clip), n_iter, count, t, the ring's pairs
        oldest first, the weights, and the state to start the next step
        from. before: another run's states to start each step from; dtype:
        torch.float64 for the witness (net a float64 copy)."""
        device = next(net.parameters()).device
        net.load_state_dict(start)
        model = build_model(lcf, device=device)
        if dtype is not None:
            model = model._replace(compute_dtype=dtype)
        dual = make_dual_optimizer(net, lcf)
        step = lbfgs.make_lbfgs_train_step(model, dual, lcf)
        gen = torch.Generator().manual_seed(SEED)
        names = dual.names("decoder")
        segs = lbfgs.group_segments(net, names)
        params = dict(net.named_parameters())
        first, pres = {}, []
        real_clip, real_heads = lbfgs.clip_lstm_grads, E.encoder_heads

        def clip(*a, **kw):
            norm = real_clip(*a, **kw)
            if not first:
                first.update({n: params[n].grad.to("cpu", torch.float64, copy=True).numpy()
                              for n in names})
            return norm

        def heads(p, A_flat, a_g, drop=None):  # each evaluation's ReLU pre-activations
            with torch.no_grad():
                pres.append(np.concatenate([
                    E._linear(p[h], x).to("cpu", torch.float64).numpy().ravel()
                    for h, x in (("affine_a", A_flat), ("affine_b", a_g))]))
            return real_heads(p, A_flat, a_g, drop)

        def host(t):
            return t.detach().to("cpu", copy=True)

        out = []
        lbfgs.clip_lstm_grads, E.encoder_heads = clip, heads
        try:
            for i, b in enumerate(batches):
                if before is not None and i:
                    net.load_state_dict(before[i - 1]["state"])
                    lbfgs.memory_from_jax(dual.decoder, before[i - 1]["mem"], segs)
                    if dtype is not None:
                        st = dual.decoder.state[dual.decoder._params[0]]
                        for k, v in st.items():
                            st[k] = ([x.to(dtype) for x in v] if isinstance(v, list)
                                     else v.to(dtype) if torch.is_tensor(v) else v)
                first.clear()
                pres.clear()
                loss = float(step(net, {k: v.to(device) for k, v in b.items()}, gen,
                                  False).loss)
                mem = lbfgs.memory_to_jax(dual.decoder, segs)
                h, count, head = mem["s"].shape[0], int(mem["count"]), int(mem["head"])
                rows = [(head - count + j) % h for j in range(count)]
                out.append({"loss": loss, "grad": dict(first), "pres": list(pres),
                            "n_iter": int(mem["n_iter"]),
                            "count": count, "t": float(mem["t"]),
                            "s": mem["s"][rows], "y": mem["y"][rows], "mem": mem,
                            "weights": {n: host(params[n]).double().numpy() for n in names},
                            "state": {k: host(v).float() if v.is_floating_point() else host(v)
                                      for k, v in net.state_dict().items()}})
        finally:
            lbfgs.clip_lstm_grads, E.encoder_heads = real_clip, real_heads
        return out

    def gaps(a, b):
        """Per step: the first loss and t (relative), the first gradient (of
        its bound, per tensor), the weights (of each tensor's largest
        element), the pairs s, y (of each row's largest element), and at
        each evaluation the encoder heads' ReLU units on the other side of 0
        (relu_flips) and the least |pre-activation| of b's among them."""
        def rel(x, y):
            return float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-30))

        return [{"loss_rel": abs(x["loss"] - y["loss"]) / abs(y["loss"]),
                 "t_rel": abs(x["t"] - y["t"]) / abs(y["t"]),
                 "grad_of_bound": max(float(np.abs(x["grad"][n] - g).max()
                                            / (TRAIN_GRAD_ATOL + TRAIN_GRAD_RTOL * np.abs(g).max()))
                                      for n, g in y["grad"].items()),
                 "weights_rel": max(rel(x["weights"][n], y["weights"][n]) for n in y["weights"]),
                 "pairs_rel": max(rel(x[f][j], y[f][j])
                                  for f in ("s", "y") for j in range(len(y[f]))),
                 "relu_flips": [int(((p > 0) != (q > 0)).sum()) for p, q in zip(x["pres"], y["pres"])],
                 "flip_min_pre": min((float(np.abs(q[(p > 0) != (q > 0)]).min())
                                      for p, q in zip(x["pres"], y["pres"])
                                      if ((p > 0) != (q > 0)).any()), default=None)}
                for x, y in zip(a, b)]

    c = run(net_c)
    g = run(net_g, c)
    torch.set_num_threads(max(1, threads // 2))
    try:
        c2 = run(net_c, c)
    finally:
        torch.set_num_threads(threads)
    net_w = build_model(lcf, device="cpu").init(SEED).double()
    w = run(net_w, c, torch.float64)
    del net_w
    card, cpu = gaps(g, c), gaps(c2, c)
    witness = {"card": gaps(g, w), "cpu": gaps(c, w), "cpu_half_threads": gaps(c2, w)}
    same = all((x["n_iter"], x["count"]) == (y["n_iter"], y["count"])
               for r in (g, w) for x, y in zip(r, c))
    line = {"card_vs_cpu": card, "cpu_vs_cpu": cpu, "vs_float64": witness,
            "n_iter": [[x["n_iter"] for x in r] for r in (g, c, w)],
            "count": [[x["count"] for x in r] for r in (g, c, w)],
            "losses": [[x["loss"] for x in r] for r in (g, c, w)],
            "bounds": {"loss_rel": TRAIN_RTOL, "t_rel": TRAIN_RTOL, "grad_of_bound": 1.0,
                       "weights_rel": LBFGS_PARAM_REL, "pairs_rel": LBFGS_MEMORY_REL,
                       "witness_ratio": LBFGS_WITNESS_RATIO}}

    def text(gs):
        return "; ".join(f"step {i + 1}: first loss {x['loss_rel']:.2e}, t {x['t_rel']:.2e}, "
                         f"first gradient {x['grad_of_bound']:.2e} of its bound, weights "
                         f"{x['weights_rel']:.2e}, pairs {x['pairs_rel']:.2e}, ReLU units "
                         f"flipped at each evaluation {x['relu_flips']}"
                         + (f" (least |pre-activation| {x['flip_min_pre']:.2e})"
                            if x["flip_min_pre"] is not None else "")
                         for i, x in enumerate(gs))

    log(f"[lbfgs parity fp32 {tag}, TF32 off] {smi}: batch {TRAIN_PARITY_B}, 2 steps, max_iter "
        f"{LBFGS_PARITY_ITER}, history {LBFGS_PARITY_HISTORY}, each from the CPU's state: n_iter "
        f"{line['n_iter']}, pairs {line['count']} (card, CPU, CPU float64); card vs CPU (losses "
        f"and t relative, the first gradient of its bound, weights of each tensor's largest "
        f"element, pairs s and y of each row's largest): {text(card)}; the CPU against itself "
        f"at {max(1, threads // 2)} threads, not {threads}: {text(cpu)}; against the float64 "
        f"run: the card {text(witness['card'])}; the CPU {text(witness['cpu'])}; the CPU at "
        f"{max(1, threads // 2)} threads {text(witness['cpu_half_threads'])}")
    for i, x in enumerate(card):
        wit = [w[i] for w in witness.values()]
        cpu_far = {k: max(wit[1][k], wit[2][k]) for k in ("weights_rel", "pairs_rel")}
        smooth = not any(wit[0]["relu_flips"][:2])  # the first pair's points
        bad = (not same or x["loss_rel"] > TRAIN_RTOL or x["t_rel"] > TRAIN_RTOL
               or x["grad_of_bound"] > 1.0
               or smooth and (wit[0]["weights_rel"] > LBFGS_WITNESS_RATIO
                              * cpu_far["weights_rel"] + LBFGS_PARAM_REL
                              or wit[0]["pairs_rel"] > LBFGS_WITNESS_RATIO
                              * cpu_far["pairs_rel"] + LBFGS_MEMORY_REL)
               or i and (x["weights_rel"] > LBFGS_PARAM_REL or x["pairs_rel"] > LBFGS_MEMORY_REL))
        if bad:
            raise AssertionError(f"lbfgs parity {tag}: step {i + 1}: {line}")
    return line


def decoder_group_size():
    """Parameters of the decoder group at full width (vocab VOCAB padded to a
    multiple of 128), counted on the meta device."""
    import torch

    from adaptive_tpu_torch import Config
    from adaptive_tpu_torch.models import build_model
    from adaptive_tpu_torch.models.factory import Encoder2Decoder
    from adaptive_tpu_torch.training.optim import param_group_names

    cf = Config(vocab_pad_multiple=128)
    model = build_model(cf, device="cpu")
    with torch.device("meta"):
        net = Encoder2Decoder(model.spec, model.arch)
    params = dict(net.named_parameters())
    return sum(params[n].numel() for n in param_group_names(net, cf)["decoder"])


def cli_origin(root, images):
    """A COCO-style origin of CLI_IMAGES images (half train2014, half
    val2014 by file name), CLI_REFS captions an image from the synthetic
    grammar, each caption with 2 filler words: the fillers are dealt round
    the captions of the images that the seeded Karpathy split
    (data/karpathy_split.py, cfg.train_random_seed) puts in train, so that
    the vocabulary stage finds the grammar's words and every filler, VOCAB
    words in all. Returns (train origin path, val origin path, an
    image_source that serves images[id - 1] by file name)."""
    import random

    import numpy as np

    from adaptive_tpu_torch.data.synthetic import synthetic_caption
    from adaptive_tpu_torch.data.tokenizer import caption_tokenize

    rng = np.random.default_rng(SEED + 900)
    half = CLI_IMAGES // 2
    imgs = {split: [{"id": i + 1, "file_name": "COCO_%s_%012d.jpg" % (split, i + 1),
                     "height": 256, "width": 256} for i in range(lo, hi)]
            for split, lo, hi in (("train2014", 0, half), ("val2014", half, CLI_IMAGES))}
    order = imgs["val2014"] + imgs["train2014"]  # main_KarpathySplit's order, then its shuffle
    random.Random(SEED + 123).shuffle(order)
    train_ids = {im["id"] for im in order[2 * CLI_SPLIT:]}
    caps = {i: [synthetic_caption(rng) for _ in range(CLI_REFS)] for i in range(1, CLI_IMAGES + 1)}
    grammar = {w for cs in caps.values() for c in cs for w in caption_tokenize(c)}
    fillers = [f"filler{i}" for i in range(VOCAB - 4 - len(grammar))]
    slots = [(i, r) for i in sorted(train_ids) for r in range(CLI_REFS)]
    if 2 * len(slots) < len(fillers):
        raise AssertionError(f"{len(slots)} train captions cannot hold {len(fillers)} fillers")
    for k, (i, r) in enumerate(slots):
        caps[i][r] += " " + " ".join(fillers[(2 * k + j) % len(fillers)] for j in range(2))
    paths = []
    ann_id = 1
    for split in ("train2014", "val2014"):
        anns = []
        for im in imgs[split]:
            for c in caps[im["id"]]:
                anns.append({"id": ann_id, "image_id": im["id"], "caption": c})
                ann_id += 1
        path = os.path.join(root, f"captions_{split}.json")
        with open(path, "w") as f:
            json.dump({"info": {}, "licenses": [], "images": imgs[split], "annotations": anns}, f)
        paths.append(path)

    def image_source(path):
        return images[int(os.path.basename(path).split("_")[-1].split(".")[0]) - 1]

    return paths[0], paths[1], image_source


def cli_end_to_end(smi):
    """Phase 9c: python -m adaptive_tpu_torch.main -c <config.py>, run
    in-process as main(["-c", path], image_source=...) on the card: a config
    file for ResNet-152 at full width in bf16 with the stages Karpathy split
    -> vocab -> train (1 epoch, decoder L-BFGS at the reference's settings
    but max_iter CLI_MAX_ITER, the per-epoch eval on) -> valid "auto" ->
    test "auto" (resize off: host file IO that needs Pillow, which the CPU
    tests hold), over a synthetic origin of CLI_IMAGES images in memory
    (seeded_images, served by file name). Checks the experiment dir
    (logfile.log with each stage's banner, config.json), the 8 split files
    at the configured sizes, the VOCAB-word vocabulary, the epoch
    checkpoint's opt.npz holding decoder_lbfgs|s of shape [50, n], the
    launches of kernels 1 and 2 ((2 per-epoch evals + valid + test) x 1
    batch x 30), the valid and test results (one caption an image) and a
    finite CIDEr for each of the 4 evals; prints each stage's seconds."""
    import tempfile
    import zipfile

    import numpy as np
    import torch

    from adaptive_tpu_torch import main as cli
    from adaptive_tpu_torch.data import karpathy_split, vocab as vocab_mod
    from adaptive_tpu_torch.evalcap import coco_eval as ce
    from adaptive_tpu_torch.training import train_loop

    images = seeded_images(CLI_IMAGES, SEED + 901)
    with tempfile.TemporaryDirectory() as root:
        train_o, val_o, image_source = cli_origin(root, images)
        cfg = os.path.join(root, "cfg.py")
        with open(cfg, "w") as f:
            f.write(f"""root = {root!r}
experiment_path = root + "/Experiments"
vocab_path = root + "/vocab.json"
captions_train_origin = {train_o!r}
captions_val_origin = {val_o!r}
splited_anno_path_prefix = root + "/annotations/karpathy_split_"
train_anno_path = splited_anno_path_prefix + "train.json"
val_anno_path = splited_anno_path_prefix + "val.json"
test_anno_path = splited_anno_path_prefix + "test.json"
train_eval_anno_path = splited_anno_path_prefix + "train_eval.json"
KarpathySplitOrnot = vacab_build_Ornot = trainOrnot = validOrnot = testOrnot = True
valid_pretrained_model = test_pretrained_model = "auto"
num_val = num_test = num_train_eval = {CLI_SPLIT}
num_train_hyperparameter, num_train_eval_hyperparameter, num_val_hyperparameter = {CLI_HYPER}
train_random_seed = {SEED + 123}
vocab_threshold = 1
compute_dtype = "bfloat16"
vocab_pad_multiple = 128
train_num_epochs = 1
train_batch_size = {TRAIN_B}
train_evalOrnot = True
train_log_step = 8
eval_batch_size = {CLI_SPLIT}
opt_rnn_optimization = "lbfgs"
opt_rnn_lbfgs_max_iter = {CLI_MAX_ITER}
""")
        evals = []
        real_eval = ce.coco_eval

        def timed_eval(*a, **kw):
            t0 = time.perf_counter()
            out = real_eval(*a, **kw)
            evals.append(("test" if kw.get("test_mode") else "valid" if kw.get("valid_mode")
                          else "train_eval" if kw.get("train_mode") else "val",
                          time.perf_counter() - t0, out))
            return out

        spans = [(karpathy_split, "main_KarpathySplit", "split"),
                 (vocab_mod, "main_build_vocab", "vocab"), (train_loop, "main_train", "train")]
        torch.cuda.synchronize()
        ce.coco_eval = timed_eval
        try:
            with timed_spans(spans) as t:
                reset_launch_counts()
                t0 = time.perf_counter()
                cli.main(["-c", cfg], image_source=image_source)
                wall = time.perf_counter() - t0
                launches = launch_counts()
        finally:
            ce.coco_eval = real_eval

        exps = os.listdir(os.path.join(root, "Experiments"))
        if len(exps) != 1:
            raise AssertionError(f"experiment dirs {exps}")
        exp = os.path.join(root, "Experiments", exps[0])
        with open(os.path.join(exp, "logfile.log")) as f:
            logtext = f.read()
        for banner in ("KarpathySplit", "vocal build", "start train", "start valid",
                       "start test", "Save Path"):
            if banner not in logtext:
                raise AssertionError(f"logfile.log lacks the banner {banner!r}")
        with open(os.path.join(exp, "config.json")) as f:
            if json.load(f)["exp_dir"] != exp:
                raise AssertionError("config.json's exp_dir is not the experiment dir")
        want = {"val": CLI_SPLIT, "test": CLI_SPLIT, "train": CLI_IMAGES - 2 * CLI_SPLIT,
                "train_eval": CLI_SPLIT, "val_hyperparameter": CLI_HYPER[2],
                "train_hyperparameter": CLI_HYPER[0],
                "train_eval_hyperparameter": CLI_HYPER[1], "train_overfit": 20}
        sizes = {}
        for subset in want:
            with open(os.path.join(root, "annotations", f"karpathy_split_{subset}.json")) as f:
                sizes[subset] = len(json.load(f)["images"])
        if sizes != want:
            raise AssertionError(f"split sizes {sizes}, expected {want}")
        with open(os.path.join(root, "vocab.json")) as f:
            n_words = len(json.load(f)["words"])
        if n_words != VOCAB:
            raise AssertionError(f"vocabulary of {n_words} words, expected {VOCAB}")
        d = os.path.join(exp, "trained_models")
        names = os.listdir(d)
        if len(names) != 1 or not names[0].endswith("_model-1"):
            raise AssertionError(f"trained_models holds {names}")
        ckpt_dir = os.path.join(d, names[0])
        with zipfile.ZipFile(os.path.join(ckpt_dir, "opt.npz")) as z, \
                z.open("decoder_lbfgs|s.npy") as f:
            fmt = np.lib.format
            header = (fmt.read_array_header_1_0 if fmt.read_magic(f) == (1, 0)
                      else fmt.read_array_header_2_0)
            s_shape = header(f)[0]
        ckpt_gib = sum(os.path.getsize(os.path.join(ckpt_dir, f))
                       for f in os.listdir(ckpt_dir)) / 2**30
        n_dec = decoder_group_size()
        if tuple(s_shape) != (50, n_dec):
            raise AssertionError(f"decoder_lbfgs|s has shape {s_shape}, expected (50, {n_dec})")
        loop = 4 * STEPS  # (2 per-epoch evals + valid + test) x 1 batch x 30 steps
        expect = {"adaptive_decode_cell_fused": loop, "greedy_head_argmax": loop,
                  "adaptive_decode_cell_fused_beam": 0, "beam_head_topk": 0,
                  "bottleneck_identity_int8": 0, "tail_conv1_int8": 0,
                  "folded_epilogue": 4 * ENCODE_EPILOGUES, "ssm_step": 0}
        if launches != expect:
            raise AssertionError(f"CLI launches {launches}, expected {expect}")
        results = [os.path.join(exp, n) for n in os.listdir(exp) if n.endswith(".json")
                   and n != "config.json"]
        results += [os.path.join(exp, "val_results", n)
                    for n in os.listdir(os.path.join(exp, "val_results"))
                    if not n.startswith("validation-")]
        if len(results) != 2:
            raise AssertionError(f"valid and test results: {results}")
        for path in results:
            with open(path) as f:
                if len(json.load(f)) != CLI_SPLIT:
                    raise AssertionError(f"{path}: not one caption for each of {CLI_SPLIT} images")
        ciders = [float(e[2]) for e in evals]
        if [e[0] for e in evals] != ["train_eval", "val", "valid", "test"] \
                or not all(np.isfinite(ciders)):
            raise AssertionError(f"evals {[e[:2] for e in evals]}, CIDEr {ciders}")
    stage_s = {"split": t["split"], "vocab": t["vocab"], "train": t["train"],
               **{e[0] if e[0] in ("valid", "test") else f"train:{e[0]}": e[1] for e in evals}}
    log(f"[cli bf16] {smi}: main -c <config.py>, {CLI_IMAGES} images ({CLI_REFS} captions an "
        f"image) split -> vocab ({n_words} words) -> train (1 epoch, batch {TRAIN_B}, decoder "
        f"L-BFGS lr 0.5, max_iter {CLI_MAX_ITER}, history 50, eval on {CLI_SPLIT} + {CLI_SPLIT}) "
        f"-> valid auto -> test auto: {wall:.3f} s; stages "
        f"{ {k: round(v, 3) for k, v in stage_s.items()} } s; split sizes {sizes}; checkpoint "
        f"{names[0]} {ckpt_gib:.3f} GiB, decoder_lbfgs|s {list(s_shape)}; launches "
        f"{ {k: v for k, v in launches.items() if v} }; CIDEr {ciders} (train_eval, val, valid, "
        f"test)")
    del images
    torch.cuda.empty_cache()
    return {"wall_s": wall, "stage_s": stage_s, "split_sizes": sizes, "vocab_words": n_words,
            "checkpoint": names[0], "checkpoint_gib": ckpt_gib, "lbfgs_s_shape": list(s_shape),
            "launches": launches, "cider": ciders}


# ---------------------------------------------------------------- phase 10
def filler_vocab():
    """VOCAB words: the four specials and filler words (the serving bench's)."""
    from adaptive_tpu_torch.data.vocab import Vocabulary

    return Vocabulary(["<pad>", "<start>", "<end>", "<unk>"] + [f"w{i}" for i in range(VOCAB - 4)])


def tools_module(name):
    """A module of tools/ (the serving bench, the int8 gate)."""
    import importlib

    tools = os.path.join(HERE, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    return importlib.import_module(name)


def serve_waves(svc, images):
    """Each image through svc.caption from its own thread, in waves of
    SERVE_B started together; returns the replies in image order."""
    import threading

    replies = [None] * len(images)

    def ask(i):
        replies[i] = svc.caption(images[i], timeout=120)

    for w in range(0, len(images), SERVE_B):
        threads = [threading.Thread(target=ask, args=(i,))
                   for i in range(w, min(w + SERVE_B, len(images)))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
            if t.is_alive():
                raise AssertionError("a served request never returned")
    bad = [r for r in replies if r is None or "error" in r]
    if bad:
        raise AssertionError(f"{len(bad)} requests failed, first: {bad[0]}")
    return replies


def serving_mode(tag, cf, net, vocab, images, calib, smi, profile_dir=None):
    """Phase 10a, one mode: CaptionService at batch SERVE_B on net, the
    SERVE_IMAGES images served against a direct decode of the same images
    by a decoder of this thread (equal captions), the launches of the
    service's worker (the caller launches nothing in that window), the
    counter identity, one weight preparation, device_decode_ms (the direct
    decoder on a batch on the card, utils/profiling.py::Timer, mean of 5;
    --profile: that decode's kernel table and busy share) and an open-loop
    sweep (tools/torch_serving_bench.py::run_level)."""
    import torch

    from adaptive_tpu_torch.decoding import make_beam_decoder, make_greedy_decoder
    from adaptive_tpu_torch.serving import CaptionService
    from adaptive_tpu_torch.utils.profiling import Timer

    bench = tools_module("torch_serving_bench")
    t0 = time.perf_counter()
    svc = CaptionService(cf, vocab, net=net, batch_size=SERVE_B, max_wait_ms=SERVE_WAIT_MS,
                         calibration_images=calib)
    try:
        svc.warmup()
        warm_s = time.perf_counter() - t0
        direct = (make_beam_decoder(svc.model, svc.cf) if cf.beam_size > 1
                  else make_greedy_decoder(svc.model, svc.cf))
        want = [vocab.decode_ids(r) for w in range(0, len(images), SERVE_B)
                for r in direct(net, images[w:w + SERVE_B]).ids.cpu().numpy()]
        batch = torch.as_tensor(images[:SERVE_B], device="cuda")
        timer = Timer()
        for _ in range(5):
            with timer.measure():
                direct(net, batch)
        device_ms = timer.mean() * 1e3
        if profile_dir:
            profile_decode(lambda: direct(net, batch), profile_dir, smi, f"serve_{tag}")

        before = svc.stats()["batches"]
        reset_launch_counts()
        replies = serve_waves(svc, images)
        launches = launch_counts()
        batches = svc.stats()["batches"] - before
        cell, head = (("adaptive_decode_cell_fused_beam", "beam_head_topk") if cf.beam_size > 1
                      else ("adaptive_decode_cell_fused", "greedy_head_argmax"))
        for name, n in launches.items():
            want_n = STEPS * batches if name in (cell, head) else 0
            if name == "folded_epilogue":
                want_n = encode_epilogues(cf, batches)
            if n != want_n:
                raise AssertionError(f"[serve {tag}] {name} launched {n} times by the service's "
                                     f"worker over {batches} batches, expected {want_n}")
        differ = [i for i, (r, w) in enumerate(zip(replies, want)) if r["caption"] != w]
        if differ:
            raise AssertionError(f"[serve {tag}] {len(differ)} of {len(images)} served captions "
                                 f"differ from the direct decode, first image {differ[0]}: "
                                 f"{replies[differ[0]]['caption']!r} vs {want[differ[0]]!r}")
        levels = [bench.run_level(svc, cf.resized_image_size, qps, SERVE_LEVEL_S, seed=i)
                  for i, qps in enumerate(SERVE_QPS)]
        st = svc.stats()
    finally:
        svc.close()
    counted = st["completed"] + st["errors"] + st["shed"] + st["invalid"] + st["timeouts"]
    if st["requests"] != counted:
        raise AssertionError(f"[serve {tag}] requests {st['requests']} != {counted} counted")
    if st["prepare_cache_misses"] != 1 or st["prepare_cache_hits"] != st["batches"] - 1:
        raise AssertionError(f"[serve {tag}] weights prepared {st['prepare_cache_misses']} times, "
                             f"{st['prepare_cache_hits']} hits over {st['batches']} batches")
    for lv in levels:
        lv["shed_share"] = lv["shed"] / max(1, lv["sent"])
    log(f"[serve {tag} bf16] {smi}: batch {SERVE_B}, max wait {SERVE_WAIT_MS} ms; warm-up "
        f"{warm_s:.2f} s; device_decode_ms {device_ms:.3f} ({timer.samples}) = "
        f"{SERVE_B / device_ms * 1e3:.1f} captions/s ceiling; {len(images)} served captions equal "
        f"the direct decode's; worker launches {launches[cell]} / {launches[head]} over "
        f"{batches} batches; counters {({k: st[k] for k in ('requests', 'completed', 'errors', 'shed', 'invalid', 'timeouts', 'batches')})}, "
        f"prepared once ({st['prepare_cache_hits']} hits); levels "
        + "; ".join(f"{lv['offered_qps']} qps: p50/p90/p99 {lv['p50_ms']}/{lv['p90_ms']}/"
                    f"{lv['p99_ms']} ms, shed {lv['shed_share']:.4f}, goodput {lv['goodput_qps']}"
                    for lv in levels))
    return {"device_decode_ms": device_ms, "device_decode_samples_s": timer.samples,
            "warmup_s": warm_s, "batches": batches, "launches": {cell: launches[cell],
                                                                 head: launches[head]},
            "levels": levels, "batch_fill_hist": st["batch_fill_hist"],
            "latency_ms_hist": st["latency_ms_hist"], "counters": {
                k: st[k] for k in ("requests", "completed", "errors", "shed", "invalid",
                                   "timeouts", "batches", "prepare_cache_hits",
                                   "prepare_cache_misses")}}


def serving(smi, profile_dir=None):
    """Phase 10a: CaptionService on a seeded full-width model (phase 3's
    recipe) in bf16 at batch SERVE_B: greedy on the exact encoder, int8 (a)
    (calibrated on 32 images) and beam 3."""
    from adaptive_tpu_torch import Config

    images = seeded_images(SERVE_IMAGES, SEED + 1001)
    calib = seeded_images(INT8_CALIB, SEED)
    cf = Config(compute_dtype="bfloat16", eval_batch_size=SERVE_B)
    model, net = random_model(cf, "cuda", calib)
    vocab = filler_vocab()
    out = {}
    for tag, c, cal in (("greedy", cf, None), ("int8_a", cf.replace(encoder_quant="int8"), calib),
                        (f"beam{BEAM}", cf.replace(beam_size=BEAM), None)):
        out[tag] = serving_mode(tag, c, net, vocab, images, cal, smi, profile_dir)
    return model, net, cf, out


def export_check(model, net, cf, smi, out_dir):
    """Phase 10b: export_decoder of the greedy decoder at batch EXPORT_B on
    the card, saved, loaded (load_decoder) and run: ids equal to the
    in-process decoder's, beta within EXPORT_BETA_ATOL; a torch.profiler
    trace of one exported call (read by utils/trace_report.py) shows
    kernels 1 and 2 STEPS times each (the bf16 cell's two kernels and the
    head's product and reduction each STEPS times), as do the launch
    counts of that call; the exported and in-process calls timed (Timer,
    mean of 5)."""
    import tempfile

    from adaptive_tpu_torch.decoding import make_greedy_decoder
    from adaptive_tpu_torch.export import export_decoder, load_decoder
    from adaptive_tpu_torch.utils.profiling import Timer

    images = seeded_images(EXPORT_B, SEED + 1002)
    c = cf.replace(eval_batch_size=EXPORT_B)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = export_decoder(model, c, net, os.path.join(tmp, "decoder.pt2"))
        t1 = time.perf_counter()
        size_mb = os.path.getsize(path) / 2 ** 20
        decode = load_decoder(path)
        t2 = time.perf_counter()
        got = decode(images)
        direct = make_greedy_decoder(model, c)
        want = direct(net, images)
        if not (got["ids"] == want.ids).all():
            raise AssertionError("exported decoder's ids differ from the in-process decoder's")
        beta_err = float((got["beta"].float() - want.beta.float()).abs().max())
        att_err = float((got["attention"].float() - want.attention.float()).abs().max())
        if beta_err > EXPORT_BETA_ATOL:
            raise AssertionError(f"exported beta {beta_err:.3e} from the in-process decoder's")
        reset_launch_counts()
        rows = profile_decode(lambda: decode(images), out_dir, smi, "export_greedy")[0]
        launches = launch_counts()
    per_kernel = {k: sum(n for name, _, n in rows if k in name)
                  for k in ("cell_gates_kernel", "cell_attend_kernel", "head_argmax_mma_kernel",
                            "head_argmax_reduce")}
    if any(n != STEPS for n in per_kernel.values()) or \
            launches["adaptive_decode_cell_fused"] != STEPS or launches["greedy_head_argmax"] != STEPS \
            or launches["folded_epilogue"] != ENCODE_EPILOGUES:
        raise AssertionError(f"exported call launched {per_kernel} (trace), {launches} (counts); "
                             f"expected {STEPS} of each of kernels 1 and 2 and "
                             f"{ENCODE_EPILOGUES} of kernel 7")
    timers = {"exported": Timer(), "in_process": Timer()}
    for _ in range(5):
        for name, fn in (("exported", lambda: decode(images)),
                         ("in_process", lambda: direct(net, images))):
            with timers[name].measure():
                fn()
    ms = {k: t.mean() * 1e3 for k, t in timers.items()}
    log(f"[export greedy bf16] {smi}: batch {EXPORT_B}: export {t1 - t0:.2f} s, artifact "
        f"{size_mb:.1f} MiB, load {t2 - t1:.2f} s; ids equal the in-process decoder's, beta "
        f"{beta_err:.3e}, attention {att_err:.3e} apart; one call's trace {per_kernel}, counts "
        f"{launches['adaptive_decode_cell_fused']} / {launches['greedy_head_argmax']}; ms a call "
        f"exported {ms['exported']:.3f}, in-process {ms['in_process']:.3f} (mean of 5)")
    return {"export_s": t1 - t0, "load_s": t2 - t1, "artifact_mib": size_mb,
            "beta_max_abs_err": beta_err, "attention_max_abs_err": att_err,
            "trace_launches": per_kernel, "ms": ms}


def gate_check(smi):
    """Phase 10c: tools/torch_int8_gate.py::run_gate on the card at
    GATE_IMAGES images and GATE_EPOCHS epochs (the rest the JAX gate's
    settings): all six modes scored, finite, (b) and (c) captioning every
    image as per-tensor does, gate_results.json well formed."""
    import math
    import tempfile

    gate = tools_module("torch_int8_gate")
    reset_launch_counts()
    with tempfile.TemporaryDirectory() as work:
        out = gate.run_gate(work, {"train_num_epochs": GATE_EPOCHS,
                                   "opt_fine_tune_cnn_start_epoch": GATE_FINETUNE_EPOCH},
                            images=GATE_IMAGES)
        with open(os.path.join(work, "gate_results.json")) as f:
            written = json.load(f)
    launches = launch_counts()
    names = [name for name, _, _ in gate.LADDER]
    batches = len(names) * -(-GATE_IMAGES // gate.DEFAULTS["eval_batch_size"])
    if launches["adaptive_decode_cell_fused"] != STEPS * batches or \
            min(launches["bottleneck_identity_int8"], launches["tail_conv1_int8"]) < 1:
        raise AssertionError(f"gate launches {launches}: expected {STEPS * batches} of kernels "
                             "1 and 2, and kernels 5 and 6 in modes (b) and (c)")
    if list(written["modes"]) != names or written["n_images"] != GATE_IMAGES:
        raise AssertionError(f"gate_results.json malformed: {list(written['modes'])}, "
                             f"{written['n_images']} images")
    for name in names[1:]:
        m = written["modes"][name]
        lo, hi = m["paired_ci95"]
        if not (math.isfinite(m["cider"]) and lo <= hi):
            raise AssertionError(f"gate mode {name}: {m}")
    if any(out["captions_differ_from_control"].values()):
        raise AssertionError(f"gate: (b), (c) differ from {gate.CONTROL!r} on "
                             f"{out['captions_differ_from_control']} images")
    log(f"[gate reduced] {smi}: {GATE_IMAGES} images, {GATE_EPOCHS} epochs: "
        + "; ".join(f"{n} CIDEr {written['modes'][n]['cider']:.4f}" for n in names)
        + f"; captions differing from per-tensor {out['captions_differ_from_control']}; "
        f"launches {launches}")
    return {**{k: v for k, v in written.items() if k != "per_image"}, "launches": launches}


# ---------------------------------------------------------------- phase 11
# the multi-device path (parallel/, decoding/spmd.py) at the widths of
# configs/coco_adaptive_v5e8.py: MD_WORLD ranks, child processes of this
# script, share cuda:0 over gloo (NCCL refuses two ranks on one card), a
# file store under TMPDIR; 11a TP decodes at mesh (1, 2) and batch
# MD_DECODE_B, 11b coco_eval in fp32 at mesh (2, 1) over MD_EVAL_IMAGES
# images at batch MD_EVAL_BATCH, 11c one fp32 step at batch MD_TRAIN_B (replicated,
# ZeRO-1, decoder L-BFGS at 9b's max_iter and history), 11d timed bf16
# steps at MD_TIMED_B (the v5e-8 config's 2 microbatches), 11e the CLI on
# a world of 1 over nccl, MD_CLI_IMAGES images at batch MD_CLI_BATCH
V5E8_CONFIG = os.path.join(HERE, "configs", "coco_adaptive_v5e8.py")
MD_WORLD, MD_RANK_TIMEOUT = 2, 600
MD_DECODE_B = 256
MD_EVAL_IMAGES, MD_EVAL_BATCH = 512, 256
MD_TRAIN_B = 8
MD_LBFGS = {"opt_rnn_optimization": "lbfgs", "opt_rnn_lbfgs_max_iter": 4,
            "opt_rnn_lbfgs_history": 3}
MD_TIMED_B, MD_TIMED_WARMUP, MD_TIMED_STEPS = 256, 1, 3
MD_CLI_IMAGES, MD_CLI_BATCH = 256, 64
# 11c, two ranks against one process on the card: the loss (relative) and
# the weights after the step (absolute), JAX's bounds (tests/
# test_sharding.py:87-91), held by phase 8c's rules (md_hold_step)
MD_LOSS_RTOL, MD_PARAM_ATOL = 1e-5, 1e-5


def md_config(**kw):
    """configs/coco_adaptive_v5e8.py through load_config (ResNet-152 at 224,
    embed 256, hidden 512, vocab 10,123 padded to 10,240, bf16, mesh (-1, 2),
    ZeRO-1, batch 512 in 2 microbatches), with kw over it."""
    from adaptive_tpu_torch.config import load_config

    return load_config(V5E8_CONFIG).replace(train_auto_resume_dir="", **kw)


def md_net(model, job):
    """The model's Encoder2Decoder holding the parent's weights."""
    import torch

    from adaptive_tpu_torch.models.factory import Encoder2Decoder

    with torch.device("meta"):
        net = Encoder2Decoder(model.spec, model.arch)
    net = net.to_empty(device=model.device).eval()
    net.load_state_dict(torch.load(os.path.join(job, "weights.pt"), map_location=model.device))
    return net


def md_train_config(cf, **kw):
    """11c's config: fp32, batch MD_TRAIN_B in one microbatch, mesh (2, 1),
    moments replicated, unless kw says otherwise."""
    return cf.replace(**{"compute_dtype": "float32", "train_batch_size": MD_TRAIN_B,
                         "train_grad_accum_steps": 1, "opt_state_sharding": "replicated",
                         "mesh_shape": (MD_WORLD, 1), **kw})


def md_step(cf, job, mesh, kind):
    """One 11c step from the parent's weights on MD_TRAIN_B seeded images:
    on this rank's rows over `mesh`, or on the whole batch without one.
    Returns (net, dual, StepOutput)."""
    import torch

    from adaptive_tpu_torch.models import build_model
    from adaptive_tpu_torch.parallel import place_batch
    from adaptive_tpu_torch.training.lbfgs import make_lbfgs_train_step
    from adaptive_tpu_torch.training.optim import make_dual_optimizer, shard_opt_state
    from adaptive_tpu_torch.training.step import make_train_step

    kw = {"replicated": {}, "zero": {"opt_state_sharding": "data"}, "lbfgs": MD_LBFGS}[kind]
    tcf = md_train_config(cf, **kw)
    model = build_model(tcf)
    net = md_net(model, job)
    dual = make_dual_optimizer(net, tcf)
    if mesh is not None and kind == "zero":
        dual = shard_opt_state(dual, net, mesh)
    make = make_lbfgs_train_step if kind == "lbfgs" else make_train_step
    step = make(model, dual, tcf, mesh)
    batch = train_batch(MD_TRAIN_B, SEED + 1200, "cpu")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1201)
    out = step(net, place_batch(mesh, batch, "cuda"), gen, kind != "lbfgs")
    torch.cuda.synchronize()
    return net, dual, out


def md_train_refs(cf, job):
    """11c's one-process steps on the card, saved for the ranks: the
    replicated step's loss, weights, BN statistics and gradients; the
    L-BFGS step's loss, n_iter and t. The process is a gloo world of 1 and
    the step takes it as its data group, so that its train-mode BN runs the
    ranks' arithmetic (models/resnet.py::_SyncBatchNorm, an all-reduce over
    one rank) and the ranks differ from it only by the split of the batch:
    phase 8c holds F.batch_norm's path card against CPU."""
    import torch
    import torch.distributed as dist

    from adaptive_tpu_torch.parallel import Mesh

    dist.init_process_group("gloo", init_method="file://" + os.path.join(job, "store_one"),
                            world_size=1, rank=0)
    try:
        one = Mesh((1, 1), ("data", "model"), 0, (0, 0), dist.group.WORLD)
        net, _, out = md_step(cf, job, one, "replicated")
        refs = {"loss": float(out.loss), "sd": net.state_dict(),
                "grads": {n: p.grad for n, p in net.named_parameters() if p.grad is not None}}
        _, dual, out = md_step(cf, job, one, "lbfgs")
    finally:
        dist.destroy_process_group()
    st = dual.decoder.state[dual.decoder._params[0]]
    refs["lbfgs"] = {"loss": float(out.loss), "n_iter": st["n_iter"], "t": float(st["t"])}
    torch.save(refs, os.path.join(job, "train_refs.pt"))
    return refs["loss"], refs["lbfgs"]


def md_hold_step(tag, net, dual, out, refs, lr):
    """A rank's step against the one-process step, by phase 8c's rules at
    the MD_* bounds: the loss; every BN statistic relative to max(1, |v|);
    the decoder group's gradients within TRAIN_GRAD_ATOL + TRAIN_GRAD_RTOL
    max|g| and its weights within MD_PARAM_ATOL where the gradient is past
    that bound (elsewhere Adam's first update may take either sign: 2 lr);
    the encoder group's gradients, ill-conditioned through ResNet-152's
    train-mode BN (phase 8c), within TRAIN_ENC_GRAD_REL of their norm and
    its weights within 2 lr; the affine heads that read the trunk's
    features (affine_a, affine_b, in the decoder group) as the encoder
    group, with their group's lr (the ranks run the trunk at half the
    batch, where cuDNN takes other algorithms, and ResNet-152 carries that
    rounding to layer4's features at ~1e-5 of their scale, across ReLU
    kinks of the heads); every other weight within MD_PARAM_ATOL. Returns
    the measured gaps."""
    loss_err = abs(float(out.loss) - refs["loss"]) / abs(refs["loss"])
    if loss_err > MD_LOSS_RTOL:
        raise AssertionError(f"11c {tag}: loss {float(out.loss)} vs {refs['loss']}")
    dec, enc = set(dual.names("decoder")), set(dual.names("encoder"))
    heads = {n for n in dec if n.startswith(("encoder.affine_a.", "encoder.affine_b."))}
    grads = {n: p.grad for n, p in net.named_parameters() if p.grad is not None}

    def rel(names):
        num = sum(float((grads[n] - refs["grads"][n]).double().pow(2).sum()) for n in names)
        den = sum(float(refs["grads"][n].double().pow(2).sum()) for n in names)
        return (num / den) ** 0.5

    enc_rel, heads_rel = rel(enc), rel(heads)
    if enc_rel > TRAIN_ENC_GRAD_REL or heads_rel > TRAIN_ENC_GRAD_REL:
        raise AssertionError(f"11c {tag}: encoder gradients {enc_rel:.3e}, heads' "
                             f"{heads_rel:.3e} of their norm")
    gaps = {"loss_rel": loss_err, "bn_rel": 0.0, "dec_grad_of_bound": 0.0, "dec_grad_worst": "",
            "dec_param_abs": 0.0, "dec_sign_flips": 0, "heads_grad_rel": heads_rel,
            "heads_param_abs": 0.0, "enc_grad_rel": enc_rel, "enc_param_abs": 0.0,
            "other_param_abs": 0.0}
    for k, v in net.state_dict().items():
        if not v.is_floating_point():
            continue
        ref = refs["sd"][k]
        d = (v - ref).abs()
        if k.endswith(("running_mean", "running_var")):
            gaps["bn_rel"] = max(gaps["bn_rel"], float((d / ref.abs().clamp(min=1.0)).max()))
        elif k in enc:
            gaps["enc_param_abs"] = max(gaps["enc_param_abs"], float(d.max()))
        elif k in heads:
            gaps["heads_param_abs"] = max(gaps["heads_param_abs"], float(d.max()))
        elif k in dec:
            g = refs["grads"][k]
            g_tol = TRAIN_GRAD_ATOL + TRAIN_GRAD_RTOL * float(g.abs().max())
            of_bound = float((grads[k] - g).abs().max()) / g_tol
            if of_bound > gaps["dec_grad_of_bound"]:
                gaps["dec_grad_of_bound"], gaps["dec_grad_worst"] = of_bound, k
            floor = g.abs() <= g_tol
            if (~floor).any():
                gaps["dec_param_abs"] = max(gaps["dec_param_abs"], float(d[~floor].max()))
            if floor.any():
                if float(d[floor].max()) > 2 * lr["decoder"] + MD_PARAM_ATOL:
                    raise AssertionError(f"11c {tag}: {k} moved {float(d[floor].max()):.3e} "
                                         f"where its gradient is 0 within the bound")
                gaps["dec_sign_flips"] += int((d[floor] > MD_PARAM_ATOL).sum())
        else:
            gaps["other_param_abs"] = max(gaps["other_param_abs"], float(d.max()))
    if (gaps["bn_rel"] > MD_PARAM_ATOL or gaps["dec_grad_of_bound"] > 1
            or gaps["dec_param_abs"] > MD_PARAM_ATOL or gaps["other_param_abs"] > MD_PARAM_ATOL
            or gaps["enc_param_abs"] > 2 * lr["encoder"] + MD_PARAM_ATOL
            or gaps["heads_param_abs"] > 2 * lr["decoder"] + MD_PARAM_ATOL):
        raise AssertionError(f"11c {tag}: {gaps}")
    return gaps


def md_tp_decode(model, net, cf):
    """11a on this rank: greedy and beam-3 decodes at mesh (1, MD_WORLD) of
    MD_DECODE_B seeded images, the second of each with the launch counts set
    to 0 just before and read just after; kernel 4 must have run on the
    shard 30 times a decode, kernel 2 never."""
    import torch

    from adaptive_tpu_torch.decoding import make_beam_decoder, make_greedy_decoder

    tcf = cf.replace(mesh_shape=(1, MD_WORLD))
    images = torch.as_tensor(seeded_images(MD_DECODE_B, SEED + 1100), device="cuda")
    res = {}
    for tag, make, cell in (("greedy", make_greedy_decoder, "adaptive_decode_cell_fused"),
                            (f"beam{BEAM}", functools.partial(make_beam_decoder, beam_size=BEAM),
                             "adaptive_decode_cell_fused_beam")):
        decode = make(model, tcf)
        decode(net, images)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = decode(net, images)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = launch_counts()
        expect = {cell: STEPS, "beam_head_topk": STEPS, "folded_epilogue": ENCODE_EPILOGUES}
        if {k: v for k, v in launches.items() if v} != expect:
            raise AssertionError(f"11a {tag}: launches {launches}, expected {expect}")
        prepared = decode.prepare(net)
        tp, head = prepared["tp"], prepared["head"]
        if not (tp and tp[1] and head[0].shape[1] == VP // MD_WORLD
                and prepared["decoder"]["embed"].shape[0] == VP // MD_WORLD
                and head.kernel_t is not None):
            raise AssertionError(f"11a {tag}: the prepared weights are not this rank's shard")
        res[tag] = {"out": {k: v.cpu() for k, v in out._asdict().items()},
                    "launches": {k: v for k, v in launches.items() if v}, "ms": ms}
    return res


def md_eval_model(cf, job):
    """11b's model: the parent's weights in fp32 (TF32 off), as phase 7b
    runs: a rank decodes half a batch, where cuDNN may take other
    convolution algorithms, and in bf16 that rounding alone parts captions
    at logit gaps far above PARITY_GAP_EPS."""
    from adaptive_tpu_torch.models import build_model

    model = build_model(cf.replace(compute_dtype="float32"))
    return model, md_net(model, job)


def md_dp_eval(cf, job, rank):
    """11b on this rank: coco_eval at mesh (MD_WORLD, 1) over the seeded
    split, served from memory; every rank reads each batch whole."""
    import torch

    from adaptive_tpu_torch.evalcap.coco_eval import coco_eval

    model, net = md_eval_model(cf, job)
    ann, _, split, vocab = eval_split(os.path.join(job, f"split{rank}"), MD_EVAL_IMAGES,
                                      SEED + 1300)
    ecf = cf.replace(compute_dtype="float32", mesh_shape=(MD_WORLD, 1), val_anno_path=ann,
                     eval_batch_size=MD_EVAL_BATCH, exp_dir=os.path.join(job, "eval_md"))
    per_image = {}
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    cider = coco_eval(ecf, model, net, epoch=1, vocab=vocab, per_image_out=per_image,
                      dataset=split)
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in launch_counts().items() if v}
    loop = MD_EVAL_IMAGES // MD_EVAL_BATCH * STEPS
    if launches != {"adaptive_decode_cell_fused": loop, "greedy_head_argmax": loop,
                    "folded_epilogue": loop // STEPS * ENCODE_EPILOGUES}:
        raise AssertionError(f"11b: launches {launches}")
    return {"cider": cider, "per_image": per_image, "wall_s": wall, "launches": launches}


def md_dp_train(cf, job, mesh_of):
    """11c on this rank: the replicated step, the ZeRO-1 step and the
    L-BFGS step over mesh (MD_WORLD, 1), each held against the parent's
    one-process step (md_hold_step: the card's convolution backward is not
    deterministic, so two runs of one step differ at the encoder's rounding
    level; ZeRO-1's are held as the replicated step's, each sharded moment
    half of its parameter's bytes)."""
    import torch

    refs = torch.load(os.path.join(job, "train_refs.pt"), map_location="cuda")
    mesh = mesh_of(md_train_config(cf))
    lr = {"decoder": cf.opt_rnn_adam_learning_rate, "encoder": cf.opt_cnn_adam_learning_rate}
    res = {}
    net, dual, out = md_step(cf, job, mesh, "replicated")
    res["replicated"] = md_hold_step("replicated", net, dual, out, refs, lr)
    rep = {k: v.clone() for k, v in net.state_dict().items()}
    del net, dual
    net, dual, out = md_step(cf, job, mesh, "zero")
    zero_gaps = md_hold_step("zero", net, dual, out, refs, lr)
    sd = net.state_dict()
    shard_abs = max(float((sd[n] - rep[n]).abs().max()) for n in dual.zero.shards)
    held = full = 0
    for name, z in dual.zero.shards.items():
        opt = dual.decoder if name in dual.decoder_names else dual.encoder
        st = opt.state[z.shard]
        mine = sum(st[f].numel() * st[f].element_size() for f in ("exp_avg", "exp_avg_sq"))
        whole = 2 * z.param.numel() * z.param.element_size()
        if 2 * mine != whole:
            raise AssertionError(f"11c zero: {name} holds {mine} of {whole} moment bytes")
        held, full = held + mine, full + whole
    res["zero"] = {"sharded_params": len(dual.zero.shards), "moment_bytes": held,
                   "moment_bytes_whole": full, "loss": float(out.loss),
                   "sharded_params_vs_replicated_abs": shard_abs, **zero_gaps}
    del net, dual, rep
    _, dual, out = md_step(cf, job, mesh, "lbfgs")
    st = dual.decoder.state[dual.decoder._params[0]]
    want = refs["lbfgs"]
    if (abs(float(out.loss) - want["loss"]) > MD_LOSS_RTOL * abs(want["loss"])
            or st["n_iter"] != want["n_iter"]
            or abs(float(st["t"]) - want["t"]) > MD_LOSS_RTOL * abs(want["t"])):
        raise AssertionError(f"11c lbfgs: loss {float(out.loss)}, n_iter {st['n_iter']}, t "
                             f"{float(st['t'])}; one process: {want}")
    res["lbfgs"] = {"loss": float(out.loss), "n_iter": st["n_iter"], "t": float(st["t"])}
    torch.cuda.empty_cache()
    return res


def md_timed(cf, mesh_of):
    """11d on this rank: bf16 steps at MD_TIMED_B over mesh (MD_WORLD, 1)
    (this rank's MD_TIMED_B / MD_WORLD rows in the config's microbatches),
    encoder off: ms a step by the host clock around synchronised steps,
    then one step under torch.profiler with each collective in a span: its
    share of the step, and the BN all-reduces counted."""
    import torch
    import torch.distributed as dist

    from adaptive_tpu_torch.models import build_model, resnet
    from adaptive_tpu_torch.parallel import place_batch
    from adaptive_tpu_torch.training.optim import make_dual_optimizer
    from adaptive_tpu_torch.training.step import make_train_step

    tcf = cf.replace(train_batch_size=MD_TIMED_B, mesh_shape=(MD_WORLD, 1))
    mesh = mesh_of(tcf)
    model = build_model(tcf)
    net = model.init(SEED)
    step = make_train_step(model, make_dual_optimizer(net, tcf), tcf, mesh)
    batch = place_batch(mesh, {k: v.cpu() for k, v in
                               train_batch(MD_TIMED_B, SEED + 300, "cpu").items()}, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for _ in range(MD_TIMED_WARMUP):
        step(net, batch, gen, False)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    losses = [step(net, batch, gen, False).loss for _ in range(MD_TIMED_STEPS)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / MD_TIMED_STEPS * 1e3
    if not torch.isfinite(torch.stack(losses)).all():
        raise AssertionError(f"11d: losses {[float(v) for v in losses]}")
    calls = {"all_reduce": 0, "all_gather": 0, "bn": 0}
    real = {n: getattr(dist, n) for n in ("all_reduce", "all_gather")}
    real_bn = resnet._sync_bn

    def spanned(name):
        def call(*a, **kw):
            calls[name] += 1
            with torch.profiler.record_function(f"md.collective.{name}"):
                return real[name](*a, **kw)
        return call

    def counted_bn(*a, **kw):
        calls["bn"] += 1
        return real_bn(*a, **kw)

    import tempfile

    from adaptive_tpu_torch.utils import trace_report
    from adaptive_tpu_torch.utils.profiling import profile_trace

    for n in real:
        setattr(dist, n, spanned(n))
    resnet._sync_bn = counted_bn
    try:
        dist.barrier()
        with tempfile.TemporaryDirectory() as trace_dir:
            with profile_trace(trace_dir):
                t1 = time.perf_counter()
                step(net, batch, gen, False)
                torch.cuda.synchronize()
                prof_ms = (time.perf_counter() - t1) * 1e3
            events = trace_report.load_trace_events(trace_dir)
    finally:
        for n, fn in real.items():
            setattr(dist, n, fn)
        resnet._sync_bn = real_bn
    # the collectives' spans on this rank's host thread: the call, its wait,
    # and gloo's copies of the CUDA tensors through the host
    coll_ms = sum(e["dur"] for e in events if e.get("ph") == "X"
                  and str(e.get("name", "")).startswith("md.collective.")) / 1e3
    busy_ms = trace_report.stage_split(events)["busy_ms"]
    return {"ms": ms, "images_per_s": MD_TIMED_B / ms * 1e3, "profiled_step_ms": prof_ms,
            "collective_ms": coll_ms, "collective_share": coll_ms / prof_ms,
            "device_busy_ms": busy_ms, "all_reduce_calls": calls["all_reduce"],
            "all_gather_calls": calls["all_gather"], "bn_all_reduces": calls["bn"],
            "bn_all_reduces_per_microbatch": calls["bn"] / tcf.train_grad_accum_steps,
            "losses": [float(v) for v in losses]}


def md_rank(rank, job):
    """One rank of phase 11, a child process of this script: joins the
    gloo group on cuda:0 and runs 11a-11d, writing its results to job."""
    import pickle

    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method="file://" + os.path.join(job, "store"),
                            world_size=MD_WORLD, rank=rank)
    from adaptive_tpu_torch.models import build_model
    from adaptive_tpu_torch.ops.cuda import build
    from adaptive_tpu_torch.parallel import make_mesh

    build.load()
    cf = md_config()
    model = build_model(cf)
    net = md_net(model, job)
    out = {"11a": md_tp_decode(model, net, cf)}
    del net
    out["11b"] = md_dp_eval(cf, job, rank)
    torch.cuda.empty_cache()
    out["11c"] = md_dp_train(cf, job, make_mesh)
    out["11d"] = md_timed(cf, make_mesh)
    with open(os.path.join(job, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()
    return 0


def md_spawn(job):
    """Start the MD_WORLD ranks (md_rank) and wait for them; a rank that
    fails or outlives MD_RANK_TIMEOUT makes the phase raise, and every rank
    is stopped either way. Returns each rank's results."""
    import pickle

    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--md-rank", str(r),
                               "--md-job", job]) for r in range(MD_WORLD)]
    try:
        deadline = time.monotonic() + MD_RANK_TIMEOUT
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    if any(rcs):
        raise AssertionError(f"phase 11: ranks exited {rcs}")
    out = []
    for r in range(MD_WORLD):
        with open(os.path.join(job, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def md_shard_checks(model, net):
    """Kernel 4 on a vocab shard, as 11a's ranks run it: each rank's
    columns of the prepared head (VP / MD_WORLD, with the -1e30 bias pad),
    every column live, at the greedy shape (MD_DECODE_B rows, W = 1) and
    the beam-3 one (x BEAM rows, W = BEAM), against its twin (phase 2b's
    rule); the greedy shard timed against the twin, the library call and
    the bound."""
    import torch

    from adaptive_tpu_torch.ops import fused_step as fs

    w_all, b_all = model.prepare_inference(net)["head"][:2]
    vloc = w_all.shape[1] // MD_WORLD
    dt = w_all.dtype
    g = torch.Generator(device="cuda").manual_seed(SEED + 1400)
    res = {}
    for tag, W, R in (("greedy", 1, MD_DECODE_B), (f"beam{BEAM}", BEAM, MD_DECODE_B * BEAM)):
        chat = torch.randn(R, H, generator=g, device="cuda").to(dt)
        h = torch.randn(R, H, generator=g, device="cuda").to(dt)
        err, differ = 0.0, 0
        for r in range(MD_WORLD):
            w = w_all[:, r * vloc:(r + 1) * vloc].contiguous()
            b = b_all[r * vloc:(r + 1) * vloc].contiguous()
            wt = fs.head_kernel_tiles(w)
            top = fs.beam_head_topk(w, b, chat, h, vloc, W, head_kernel_t=wt)
            torch.cuda.synchronize()
            ref = fs.beam_head_topk_plain(w, b, chat, h, vloc, W)
            logits = (chat + h).to(dt).float() @ w.float() + b.float()
            e, n = topk_checks(f"shard {r} head W={W}", top, ref, logits, W)
            err, differ = max(err, e), differ + n
            if r == 0:
                shard = (w, b, wt, top)
        w, b, wt, top = shard
        ms = cuda_ms(lambda: fs.beam_head_topk(w, b, chat, h, vloc, W, head_kernel_t=wt))
        plain_ms = cuda_ms(lambda: fs.beam_head_topk_plain(w, b, chat, h, vloc, W))
        z = (chat + h).to(dt)

        def library():
            lg = torch.addmm(b, z, w)
            return lg.topk(W, dim=1), torch.logsumexp(lg, dim=1)

        lib_ms = cuda_ms(library)
        bnd = bound(nbytes(w, b, chat, h, *top), 2.0 * R * H * vloc, "bfloat16")
        log(f"[md kernels bf16 shard W={W}] kernel 4 on a {vloc}-column shard of {VP} "
            f"({fs.head_instance(dt, H)}), {R} rows: {MD_WORLD} shards against the twin, max_abs_err "
            f"{err:.3e}, {differ} rows' ids differ (all at adjacent gaps < {HEAD_GAP_EPS}); "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms addmm+topk+logsumexp {lib_ms:.4f} ms "
            f"bound {bnd[0]:.4f} ms ({bnd[1]})")
        res[tag] = {"max_abs_err": err, "rows_differ": differ, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "bound_ms": bnd[0], "bound_by": bnd[1], "rows": R,
                    "columns": vloc, "W": W}
    return res


def md_hold_decode(ranks, model, net, cf, images):
    """11a against the one-process decode on the card (kernel 2 greedy,
    kernel 4 whole for beam): the ranks' outputs equal each other; greedy
    ids equal or parted at a step where the one-process decode's top-2
    logit gap is below PARITY_GAP_EPS (phase 4's rule); beams equal, their
    scores within BEAM_SCORE_ATOL, or parted where the adjacent-candidate
    gap is below it (phase 4b's). Returns the counts of equal rows."""
    import torch

    from adaptive_tpu_torch.decoding import make_beam_decoder, make_greedy_decoder

    for tag in ranks[0]["11a"]:
        for k, v in ranks[0]["11a"][tag]["out"].items():
            if not torch.equal(v, ranks[1]["11a"][tag]["out"][k]):
                raise AssertionError(f"11a {tag}: {k} differs between the ranks")
    imgs = torch.as_tensor(images, device="cuda")
    prepared = model.prepare_inference(net)
    ref = make_greedy_decoder(model, cf)(net, imgs)
    got = ranks[0]["11a"]["greedy"]["out"]
    same_g = 0
    for row in range(MD_DECODE_B):
        diff = (got["ids"][row] != ref.ids[row].cpu()).nonzero()
        if not len(diff):
            same_g += 1
            continue
        t = int(diff[0])
        ref_ids, gaps = greedy_gaps(model, prepared, images[row:row + 1], cf)
        gap = float(gaps[0, t])
        log(f"[md tp greedy] row {row} differs from step {t}: top-2 gap {gap:.3e}")
        if gap >= PARITY_GAP_EPS:
            raise AssertionError(f"11a greedy row {row}: ids differ at step {t}, gap {gap:.3e}")
    refb = make_beam_decoder(model, cf, beam_size=BEAM)(net, imgs)
    gotb = ranks[0]["11a"][f"beam{BEAM}"]["out"]
    same_b, err = 0, 0.0
    for row in range(MD_DECODE_B):
        if not torch.equal(gotb["all_ids"][row], refb.all_ids[row].cpu()):
            _, gaps = beam_gaps(model, prepared, images[row:row + 1], cf, BEAM)
            gap = float(gaps[0].min())
            log(f"[md tp beam] image {row}: beams differ; min adjacent candidate gap {gap:.3e}")
            if gap >= PARITY_GAP_EPS:
                raise AssertionError(f"11a beam image {row}: beams differ, gaps >= {gap:.3e}")
            continue
        same_b += 1
        err = max(err, check_close(f"11a beam scores image {row}", gotb["all_scores"][row],
                                   refb.all_scores[row].cpu(), BEAM_SCORE_ATOL, 0.0))
    return same_g, same_b, err


def md_hold_eval(ranks, cf, job):
    """11b against the one-process coco_eval on the card: the results files
    of rank 0 and rank 1 (.proc1) and each rank's CIDEr and per-image scores
    equal (==) the one-process call's, or each differing caption is parted
    where the one-process decode was within PARITY_GAP_EPS of another
    choice (phase 7b's rule)."""
    from adaptive_tpu_torch.evalcap.coco_eval import coco_eval

    model, net = md_eval_model(cf, job)
    ann, images, split, vocab = eval_split(os.path.join(job, "split_ref"), MD_EVAL_IMAGES,
                                           SEED + 1300)
    ecf = cf.replace(compute_dtype="float32", val_anno_path=ann, eval_batch_size=MD_EVAL_BATCH,
                     exp_dir=os.path.join(job, "eval_one"))
    per_image = {}
    t0 = time.perf_counter()
    cider = coco_eval(ecf, model, net, epoch=1, vocab=vocab, per_image_out=per_image,
                      dataset=split)
    one_s = time.perf_counter() - t0
    ref = read_results(os.path.join(job, "eval_one", "val_results", "validation-1.json"),
                       MD_EVAL_IMAGES)
    d = os.path.join(job, "eval_md", "val_results")
    files = [read_results(os.path.join(d, n), MD_EVAL_IMAGES)
             for n in ("validation-1.json", "validation-1.proc1.json")]
    if files[0] != files[1]:
        raise AssertionError("11b: rank 1's results differ from rank 0's")
    differ = [i for i in range(MD_EVAL_IMAGES) if files[0][i] != ref[i]]
    prepared = model.prepare_inference(net)
    for i in differ:
        b = i // MD_EVAL_BATCH * MD_EVAL_BATCH
        ref_ids, gaps = greedy_gaps(model, prepared, images[b:b + MD_EVAL_BATCH], cf)
        gap = float(gaps[i - b].min())
        log(f"[md dp eval] image {i + 1}: captions differ; smallest top-2 gap of its decode "
            f"{gap:.3e}")
        if gap >= PARITY_GAP_EPS:
            raise AssertionError(f"11b: image {i + 1}'s caption differs with gaps >= {gap:.3e}")
    for r in ranks:
        if not differ and (r["11b"]["cider"] != cider or r["11b"]["per_image"] != per_image):
            raise AssertionError(f"11b: CIDEr {r['11b']['cider']!r} vs one process {cider!r}")
    return {"identical": MD_EVAL_IMAGES - len(differ), "cider": ranks[0]["11b"]["cider"],
            "cider_one_process": cider, "one_process_s": one_s}


def md_cli(smi):
    """11e: adaptive_tpu_torch.main -c <config.py> in-process, train (1
    epoch at MD_CLI_BATCH, the per-epoch eval on) over MD_CLI_IMAGES seeded
    images served from memory at the v5e-8 widths, without a process group
    and with distributed_init, which starts a world of 1 over nccl and ends
    it: the runs' loss histories and CIDEr equal (==)."""
    import tempfile

    import torch
    import torch.distributed as dist

    from adaptive_tpu_torch import main as cli
    from adaptive_tpu_torch.training import checkpoint as ckpt

    started = []
    real_init = dist.init_process_group

    def recorded_init(backend, *a, **kw):
        started.append((backend, kw.get("world_size")))
        return real_init(backend, *a, **kw)

    with tempfile.TemporaryDirectory() as root:
        ann, images, _, vocab = eval_split(os.path.join(root, "data"), MD_CLI_IMAGES, SEED + 1500)
        vocab.save(os.path.join(root, "vocab.json"))

        def image_source(path):
            return images[int(os.path.basename(path).split("_")[-1].split(".")[0]) - 1]

        runs = {}
        for tag, on in (("plain", False), ("nccl", True)):
            cfg = os.path.join(root, f"{tag}.py")
            with open(cfg, "w") as f:
                f.write(f"""experiment_path = {os.path.join(root, tag)!r}
vocab_path = {os.path.join(root, "vocab.json")!r}
resized_image_dir = {os.path.join(root, "resized")!r}
train_anno_path = val_anno_path = train_eval_anno_path = {ann!r}
trainOrnot = True
train_evalOrnot = True
compute_dtype = "bfloat16"
vocab_pad_multiple = 128
train_num_epochs = 1
train_batch_size = {MD_CLI_BATCH}
eval_batch_size = {MD_CLI_BATCH * 2}
train_log_step = 1
distributed_init = {on}
""")
            dist.init_process_group = recorded_init
            try:
                reset_launch_counts()
                t0 = time.perf_counter()
                cli.main(["-c", cfg], image_source=image_source)
                wall = time.perf_counter() - t0
                launches = {k: v for k, v in launch_counts().items() if v}
            finally:
                dist.init_process_group = real_init
            d = os.path.join(root, tag)
            (exp,) = os.listdir(d)
            (name,) = [n for n in os.listdir(os.path.join(d, exp, "trained_models"))
                       if n.endswith("_model-1")]
            meta = ckpt.load_metadata(os.path.join(d, exp, "trained_models", name))
            runs[tag] = {"wall_s": wall, "launches": launches,
                         **{k: meta[k] for k in ("train_epoch_losses", "cider_scores",
                                                 "cider_scores_train_eval")}}
    loop = 2 * (MD_CLI_IMAGES // (2 * MD_CLI_BATCH)) * STEPS
    for tag, run in runs.items():
        if run["launches"] != {"adaptive_decode_cell_fused": loop, "greedy_head_argmax": loop,
                               "folded_epilogue": loop // STEPS * ENCODE_EPILOGUES}:
            raise AssertionError(f"11e {tag}: launches {run['launches']}")
    if started != [("nccl", 1)] or dist.is_initialized():
        raise AssertionError(f"11e: process groups started {started}, "
                             f"one still up: {dist.is_initialized()}")
    for k in ("train_epoch_losses", "cider_scores", "cider_scores_train_eval"):
        if runs["nccl"][k] != runs["plain"][k]:
            raise AssertionError(f"11e: {k} {runs['nccl'][k]} with the process group, "
                                 f"{runs['plain'][k]} without")
    log(f"[md cli nccl world 1] {smi}: main -c <config.py> with distributed_init (nccl, world "
        f"1, started and ended) equals the run without a group: train losses "
        f"{runs['plain']['train_epoch_losses']}, CIDEr val {runs['plain']['cider_scores']} "
        f"train_eval {runs['plain']['cider_scores_train_eval']}; {runs['nccl']['wall_s']:.3f} s "
        f"vs {runs['plain']['wall_s']:.3f} s; launches {runs['nccl']['launches']}")
    torch.cuda.empty_cache()
    return {k: {kk: v for kk, v in run.items()} for k, run in runs.items()}


def multi_device(smi):
    """Phase 11 (module docstring): the parent's seeded v5e-8 model, the
    shard's kernel checks, the one-process references, the MD_WORLD ranks,
    then 11e. Returns (the {"multi_device": ...} payload, kernel 4's shard
    numbers)."""
    import shutil
    import tempfile

    import torch

    t0 = time.perf_counter()
    job = tempfile.mkdtemp(prefix="md_")
    try:
        cf = md_config()
        model, net = random_model(cf, "cuda", seeded_images(32, SEED))
        torch.save(net.state_dict(), os.path.join(job, "weights.pt"))
        shard = md_shard_checks(model, net)
        loss, lbfgs = md_train_refs(cf, job)
        t1 = time.perf_counter()
        ranks = md_spawn(job)
        t2 = time.perf_counter()
        images = seeded_images(MD_DECODE_B, SEED + 1100)
        same_g, same_b, score_err = md_hold_decode(ranks, model, net, cf, images)
        ev = md_hold_eval(ranks, cf, job)
        del net
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(job, ignore_errors=True)
    t3 = time.perf_counter()
    cli = md_cli(smi)
    t4 = time.perf_counter()
    r0 = ranks[0]
    a = {tag: {"ms": v["ms"], "launches": v["launches"]} for tag, v in r0["11a"].items()}
    log(f"[md tp decode bf16] {smi}: mesh (1, {MD_WORLD}) on one card over gloo, batch "
        f"{MD_DECODE_B}, each rank's embedding and head a {VP // MD_WORLD}-column shard: greedy "
        f"{a['greedy']['ms']:.3f} ms, launches {a['greedy']['launches']}; beam {BEAM} "
        f"{a[f'beam{BEAM}']['ms']:.3f} ms, launches {a[f'beam{BEAM}']['launches']}; against "
        f"one process (kernel 2, kernel 4 whole): {same_g}/{MD_DECODE_B} greedy captions and "
        f"{same_b}/{MD_DECODE_B} beams identical, beam scores max abs err {score_err:.3e} "
        f"(atol {BEAM_SCORE_ATOL}); the ranks' outputs equal")
    b = r0["11b"]
    log(f"[md dp eval fp32, TF32 off] {smi}: coco_eval at mesh ({MD_WORLD}, 1), "
        f"{MD_EVAL_IMAGES} images at "
        f"batch {MD_EVAL_BATCH}: {b['wall_s']:.3f} s a rank (one process {ev['one_process_s']:.3f}"
        f" s), {ev['identical']}/{MD_EVAL_IMAGES} captions as one process's, CIDEr "
        f"{ev['cider']!r} vs {ev['cider_one_process']!r}; launches a rank {b['launches']}; "
        f"rank 1 wrote validation-1.proc1.json")
    c = r0["11c"]
    g = c["replicated"]
    log(f"[md dp train fp32, TF32 off] {smi}: one step at mesh ({MD_WORLD}, 1), batch "
        f"{MD_TRAIN_B}, encoder on, Adam/Adam, against one process on the card: loss rel err "
        f"{g['loss_rel']:.3e}, BN statistics {g['bn_rel']:.3e}; decoder group: gradients "
        f"{g['dec_grad_of_bound']:.3e} of their bound, weights {g['dec_param_abs']:.3e} where "
        f"the gradient is past it ({g['dec_sign_flips']} elements of gradients 0 within it "
        f"moved past {MD_PARAM_ATOL}); affine_a/b: gradients {g['heads_grad_rel']:.3e} of "
        f"their norm, weights {g['heads_param_abs']:.3e}; encoder group: gradients "
        f"{g['enc_grad_rel']:.3e} of "
        f"their norm, weights {g['enc_param_abs']:.3e}; other weights "
        f"{g['other_param_abs']:.3e}; ZeRO-1: held by the same rules, its sharded "
        f"parameters {c['zero']['sharded_params_vs_replicated_abs']:.3e} from the replicated "
        f"step's, {c['zero']['sharded_params']} parameters' moments sharded, "
        f"{c['zero']['moment_bytes'] / 2**20:.2f} of {c['zero']['moment_bytes_whole'] / 2**20:.2f}"
        f" MiB a rank; decoder L-BFGS: loss {c['lbfgs']['loss']:.6f} n_iter "
        f"{c['lbfgs']['n_iter']} t {c['lbfgs']['t']:.6f} (one process: loss {lbfgs['loss']:.6f} "
        f"n_iter {lbfgs['n_iter']} t {lbfgs['t']:.6f}); Adam step loss {loss:.6f}")
    d = [r["11d"] for r in ranks]
    log(f"[md dp train bf16 timed] {smi}: {MD_WORLD} ranks share ONE card, so this is not a "
        f"scaling figure: batch {MD_TIMED_B} ({MD_WORLD} x {MD_TIMED_B // MD_WORLD}, "
        f"{md_config().train_grad_accum_steps} microbatches), encoder off, mean of "
        f"{MD_TIMED_STEPS} steps after {MD_TIMED_WARMUP}: "
        + "; ".join(f"rank {i} {x['ms']:.3f} ms a step ({x['images_per_s']:.1f} images/s), "
                    f"profiled step {x['profiled_step_ms']:.3f} ms of which collectives "
                    f"{x['collective_ms']:.3f} ms ({x['collective_share']:.4f}), device busy "
                    f"{x['device_busy_ms']:.3f} ms, all-reduces {x['all_reduce_calls']} (BN "
                    f"{x['bn_all_reduces']}, {x['bn_all_reduces_per_microbatch']:.0f} a "
                    f"microbatch), all-gathers {x['all_gather_calls']}" for i, x in enumerate(d)))
    phase_s = {"11abcd": t3 - t0, "ranks": t2 - t1, "11e": t4 - t3}
    log(f"[md phases] " + ", ".join(f"{k} {v:.1f} s" for k, v in phase_s.items()))
    line = {"card": smi, "world": MD_WORLD, "backend": "gloo", "devices": "one card, cuda:0",
            "tp_decode": {**a, "greedy_identical": same_g, "beam_identical": same_b,
                          "beam_score_max_abs_err": score_err},
            "dp_eval": {**ev, "wall_s": b["wall_s"], "launches": b["launches"]},
            "dp_train_fp32": {**c["replicated"], "zero": c["zero"], "lbfgs": c["lbfgs"],
                              "lbfgs_one_process": lbfgs},
            "dp_train_bf16_timed_shared_card": d, "cli_nccl_world1": cli, "phase_s": phase_s}
    return line, shard


# ---------------------------------------------------------------- phase 12
def variant_decode(model, net, cf, images_u8, smi, beam, profile_dir=None, tag=None,
                   extra=None):
    """Phase 12a: a variant's greedy or beam-3 decode end to end in bf16 at
    batch B, timed as phase 3 times it: kernel 2 (greedy) or kernel 4 (beam)
    launched STEPS times a decode and no other kernel (the variants' cells
    run op by op; extra: other kernels' launches a decode, phase 14c's int8
    encoder's); ids in the vocab; the maps [B, STEPS, K] finite in [0, 1],
    the baseline's softmax summing to 1 (rnn's are sigmoid gates); beta all
    zero; beams sorted, ids and score the best beam's."""
    import torch

    from adaptive_tpu_torch.decoding import make_beam_decoder, make_greedy_decoder

    variant = cf.atten_model_name
    tag = tag or (f"beam{BEAM}" if beam else "greedy")
    decode = (make_beam_decoder(model, cf, beam_size=BEAM) if beam
              else make_greedy_decoder(model, cf))
    images = torch.as_tensor(images_u8, device="cuda")
    expect = {k: 0 for k in launch_counts()}
    expect["beam_head_topk" if beam else "greedy_head_argmax"] = STEPS
    expect["folded_epilogue"] = encode_epilogues(cf)
    expect.update(extra or {})
    out, launches, total_ms, enc_ms = timed_decodes(decode, net, model, cf, images, expect)
    ids = out.ids.cpu().numpy()
    if ids.shape != (B, STEPS) or ids.min() < 0 or ids.max() >= VOCAB:
        raise AssertionError(f"{variant} {tag}: ids of shape {ids.shape} in [{ids.min()}, "
                             f"{ids.max()}]")
    att = out.attention.float()
    if tuple(att.shape) != (B, STEPS, K) or not torch.isfinite(att).all() or \
            not ((att >= 0) & (att <= 1)).all():
        raise AssertionError(f"{variant} {tag}: attention maps malformed")
    # the plain cell's softmax rounds each weight to the compute dtype once:
    # the sum is within 2^-9 of 1 in bf16
    sum_tol = 1e-3 if model.compute_dtype == torch.float32 else 2.0 ** -8
    if variant == "baseline_attention" and not torch.allclose(
            att.sum(-1), torch.ones(B, STEPS, device=att.device), atol=sum_tol):
        raise AssertionError(f"{variant} {tag}: attention maps do not sum to 1")
    if out.beta.any():
        raise AssertionError(f"{variant} {tag}: beta is not zero")
    if beam:
        scores, img = out.all_scores, torch.arange(B, device="cuda")
        best = scores.argmax(1)
        if tuple(out.all_ids.shape) != (B, BEAM, STEPS) or not torch.isfinite(scores).all() or \
                not (scores[:, :-1] >= scores[:, 1:]).all() or \
                not torch.equal(out.ids, out.all_ids[img, best]):
            raise AssertionError(f"{variant} {tag}: beams malformed")
    distinct = len({tuple(r) for r in ids.tolist()})
    total, enc = sum(total_ms) / len(total_ms), sum(enc_ms) / len(enc_ms)
    log(f"[variant {variant} {tag} bf16] {smi}: batch {B}, {STEPS} steps, mean of {E2E_REPEATS} "
        f"runs: total {total:.3f} ms {total_ms}, encoder {enc:.3f} ms {enc_ms}, decode loop "
        f"{total - enc:.3f} ms, {B / total * 1e3:.1f} captions/s; launches {launches} (kernels "
        f"1 and 3 none); {distinct} distinct captions, first: {ids[0, :12].tolist()}")
    if profile_dir:
        profile_decode(lambda: decode(net, images), profile_dir, smi, f"{variant}_{tag}")
    return launches, {"total_ms": total, "encoder_ms": enc, "decode_loop_ms": total - enc,
                      "captions_per_s": B / total * 1e3, "distinct": distinct}


def variant_step(model, net, cf, images_u8, smi, beam, profile_dir=None):
    """Phase 12a: the host and device time of one decode step of a variant
    at batch B (beam: B x BEAM rows, V and pv tiled once, as
    make_beam_decoder has them): STEP_RUNS steps after a warm-up one on the
    host clock up to torch.cuda.synchronize() (a step's wall: its host
    time, where the host binds), then the same steps under torch.profiler:
    the card's busy time and the kernels launched a step (profile_decode's
    table; to profile_dir where given). A rnn step launches 2 x K LSTM cell
    steps of the aggregator."""
    import torch

    from adaptive_tpu_torch.ops.preprocess import eval_preprocess

    variant = cf.atten_model_name
    tag = f"beam{BEAM}" if beam else "greedy"
    W = BEAM if beam else 1
    prepared = model.prepare_inference(net)
    with torch.no_grad():
        V, v_g, h0, c0 = model.encode_inference(prepared, eval_preprocess(
            torch.as_tensor(images_u8, device="cuda"), cf.train_crop_size, model.compute_dtype))
        dec, head = prepared["decoder"], prepared["head"]
        rows = [t.repeat_interleave(W, 0) for t in (V, model.precompute_slots(dec, V), v_g)]
        st = model.init_decode_state(h0.repeat_interleave(W, 0), c0.repeat_interleave(W, 0))
        tok = torch.full((B * W,), cf.decode_start_token, dtype=torch.int32, device="cuda")

        def step():
            V_t, pv_t, vg_t = rows
            if beam:
                return model.beam_decode_step(dec, tok, vg_t, st, V_t, BEAM, pv=pv_t, head=head)
            return model.greedy_decode_step(dec, tok, vg_t, st, V_t, pv=pv_t, head=head)

        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEP_RUNS):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / STEP_RUNS * 1e3
        table, busy_us, _ = profile_decode(lambda: [step() for _ in range(STEP_RUNS)],
                                           profile_dir, smi, f"{variant}_step_{tag}")
    busy = busy_us / 1e3 / STEP_RUNS
    n = sum(k for _, _, k in table) / STEP_RUNS
    log(f"[variant step {variant} {tag} bf16] {smi}: {B * W} rows, mean of {STEP_RUNS} steps: "
        f"host (wall, synchronised) {wall:.3f} ms a step, device busy {busy:.3f} ms a step "
        f"({busy / wall:.4f} of it), {n:.0f} kernels a step")
    return {"host_ms": wall, "device_ms": busy, "kernels": n}


def variant_checkpoint_eval(model, net, cf, smi):
    """Phase 12d: save_checkpoint of the bf16 net, restore_model into a net
    drawn from another seed (every tensor equal to the saved net's after),
    then coco_eval greedy at batch EVAL_BATCH on a VARIANT_EVAL_IMAGES-image
    synthetic split served from memory (phase 7's eval_split): one result
    an image, a finite CIDEr, kernel 2 launched STEPS times a batch and no
    other kernel."""
    import tempfile

    import numpy as np
    import torch

    from adaptive_tpu_torch.evalcap.coco_eval import coco_eval
    from adaptive_tpu_torch.training.checkpoint import restore_model, save_checkpoint

    variant = cf.atten_model_name
    n = VARIANT_EVAL_IMAGES
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        path = os.path.join(root, "cider-0.0000_model-1")
        save_checkpoint(path, net)
        fresh = model.init(SEED + 1)
        restore_model(path, fresh, model.arch)
        t1 = time.perf_counter()
        got, want = fresh.state_dict(), net.state_dict()
        if set(got) != set(want) or any(not torch.equal(got[k], want[k]) for k in want):
            raise AssertionError(f"{variant}: restore_model did not give the saved weights")
        ann, _, split, vocab = eval_split(root, n, SEED + 1200)
        ecf = cf.replace(val_anno_path=ann, eval_batch_size=EVAL_BATCH, exp_dir=root)
        per_image = {}
        reset_launch_counts()
        t2 = time.perf_counter()
        cider = coco_eval(ecf, model, fresh, epoch=1, vocab=vocab, per_image_out=per_image,
                          dataset=split)
        wall = time.perf_counter() - t2
        launches = launch_counts()
        results = read_results(os.path.join(root, "val_results", "validation-1.json"), n)
    expect = {k: 0 for k in launches}
    expect["greedy_head_argmax"] = -(-n // EVAL_BATCH) * STEPS
    expect["folded_epilogue"] = -(-n // EVAL_BATCH) * ENCODE_EPILOGUES
    if launches != expect or len(per_image) != n or not np.isfinite(cider):
        raise AssertionError(f"{variant} eval: launches {launches}, {len(per_image)} per-image "
                             f"scores, CIDEr {cider}")
    log(f"[variant checkpoint eval {variant} bf16] {smi}: checkpoint saved and restored into a "
        f"fresh net in {t1 - t0:.2f} s, every tensor equal; coco_eval greedy on {n} images "
        f"{wall:.3f} s, {len(results)} results "
        f"({len({r['caption'] for r in results})} distinct captions), CIDEr {cider:.6g}, "
        f"kernel 2 launched {launches['greedy_head_argmax']} times")
    return {"checkpoint_s": t1 - t0, "eval_s": wall, "results": len(results), "cider": cider,
            "launches": {k: v for k, v in launches.items() if v}}


def variant_export(model, net, cf, smi):
    """Phase 12d (baseline only: a rnn step's 2 x K aggregator steps would
    unroll 2,940 LSTM cells into the graph): the greedy decoder exported at
    batch EXPORT_B, saved, loaded and run: ids equal the in-process
    decoder's, attention within EXPORT_BETA_ATOL; kernel 2 launched STEPS
    times in the exported call."""
    import tempfile

    from adaptive_tpu_torch.decoding import make_greedy_decoder
    from adaptive_tpu_torch.export import export_decoder, load_decoder

    images = seeded_images(EXPORT_B, SEED + 1002)
    c = cf.replace(eval_batch_size=EXPORT_B)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        decode = load_decoder(export_decoder(model, c, net, os.path.join(tmp, "decoder.pt2")))
        t1 = time.perf_counter()
        reset_launch_counts()
        got = decode(images)
        launches = launch_counts()
    want = make_greedy_decoder(model, c)(net, images)
    att_err = float((got["attention"].float() - want.attention.float()).abs().max())
    expect = {k: 0 for k in launches}
    expect["greedy_head_argmax"] = STEPS
    expect["folded_epilogue"] = ENCODE_EPILOGUES
    if not (got["ids"] == want.ids).all() or att_err > EXPORT_BETA_ATOL or launches != expect:
        raise AssertionError(f"{cf.atten_model_name} export: ids equal "
                             f"{bool((got['ids'] == want.ids).all())}, attention {att_err:.3e}, "
                             f"launches {launches}")
    log(f"[variant export {cf.atten_model_name} greedy bf16] {smi}: batch {EXPORT_B}: export and "
        f"load {t1 - t0:.2f} s; ids equal the in-process decoder's, attention {att_err:.3e} "
        f"apart; kernel 2 launched {launches['greedy_head_argmax']} times in the call")
    return {"export_load_s": t1 - t0, "attention_max_abs_err": att_err}


def variants(smi, profile_dir=None):
    """Phase 12: the baseline_attention and rnn_attention decoders at the
    published widths (ResNet-152 at 224, embed 256, hidden 512, vocab 10,123
    padded to 10,240; rnn bidirectional, hr 256, 1 layer), seeded weights
    with BN calibrated as in phase 3: 12a bf16 greedy and beam 3 at batch B
    on phase 3's images, and the decode step's host and device ms; 12b fp32
    greedy and beam 3 on 8 images, card vs CPU (the plain twins), under
    phases 4's and 4b's rules; 12c one fp32 train step at batch
    TRAIN_PARITY_B card vs CPU, encoder off and on, under phase 8c's
    bounds, and phase 8a's bf16 step at batch TRAIN_B, encoder off; 12d the
    checkpoint round trip and coco_eval (and the baseline's export).
    Returns {variant: its numbers} and {variant: {path: launches}}."""
    import torch

    from adaptive_tpu_torch import Config

    images_u8 = seeded_images(B, SEED)
    out, launches = {}, {}
    for variant in VARIANTS:
        t0 = time.perf_counter()
        line = {}
        cf = Config(compute_dtype="bfloat16", atten_model_name=variant)
        model, net = random_model(cf, "cuda", images_u8[:32])
        launches[variant] = {}
        for beam in (False, True):
            tag = f"beam{BEAM}" if beam else "greedy"
            launches[variant][tag], line[tag] = variant_decode(model, net, cf, images_u8, smi, beam,
                                                               profile_dir)
            line[f"step_{tag}"] = variant_step(model, net, cf, images_u8, smi, beam, profile_dir)
        t1 = time.perf_counter()
        line["checkpoint_eval"] = variant_checkpoint_eval(model, net, cf, smi)
        if variant == "baseline_attention":
            line["export"] = variant_export(model, net, cf, smi)
        del model, net
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        fp32 = fp32_models(images_u8, atten_model_name=variant)
        line["parity_fp32"] = {
            "greedy": cross_device_parity(*fp32, images_u8, tag=f"variant parity {variant} fp32"),
            f"beam{BEAM}": beam_parity(*fp32, images_u8, tag=f"variant beam parity {variant} fp32")}
        t3 = time.perf_counter()
        line["train_parity_fp32"] = train_parity(fp32[0], fp32[2], fp32[4], smi,
                                                 label=f"variant train parity {variant} fp32")
        del fp32
        torch.cuda.empty_cache()
        line["train_step"] = train_throughput(smi, profile_dir, (("encoder_off", False),),
                                              atten_model_name=variant)["encoder_off"]
        line["phase_s"] = {"12a_12d": t2 - t0, "12b": t3 - t2, "12c": time.perf_counter() - t3}
        log(f"[variant phases {variant}] " + ", ".join(f"{k} {v:.1f} s"
                                                       for k, v in line["phase_s"].items()))
        out[variant] = line
    return out, launches


# ---------------------------------------------------------------- phase 13
def ulps(got, want) -> int:
    """The largest distance in units in the last place between two float
    tensors of one dtype (bit patterns as integers; 0 where equal)."""
    import torch

    idt = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[want.dtype]
    a, b = got.contiguous().view(idt).long(), want.contiguous().view(idt).long()
    # map the sign-magnitude patterns onto one ordered line
    a = torch.where(a < 0, -(a & (2 ** (8 * want.element_size() - 1) - 1)), a)
    b = torch.where(b < 0, -(b & (2 ** (8 * want.element_size() - 1) - 1)), b)
    return int((a - b).abs().max())


def qc_parts(x, w, g):
    """The int8 backward's pieces on x's device: the quantised operands and
    scales, the counts, dx and dw (ops/quant_conv.py::_int8_bwd's steps)."""
    from adaptive_tpu_torch.ops import quant_conv as qc

    gq, sg = qc._q8(g)
    wq, sw = qc._q8(w)
    xq, sx = qc._q8(x)
    dxc, dwc = qc.dx_counts(gq, wq), qc.dw_counts(xq, gq, w.shape[2])
    dx, dw = qc._int8_bwd(x, w, g, None, True)
    return {"gq": gq, "wq": wq, "xq": xq, "sg": sg, "sw": sw, "sx": sx, "dx_counts": dxc,
            "dw_counts": dwc, "dx": dx.to(x.dtype), "dw": dw.to(w.dtype)}


def qc_backward(mode, x, w, g):
    """autograd.grad of the conv at x, w in mode, cotangent g: returns a
    closure that runs the backward again (the graph retained)."""
    import torch

    from adaptive_tpu_torch.ops import quant_conv as qc

    qc.set_conv_bwd_quant(mode)
    try:
        xr, wr = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
        y = qc.conv_nchw(xr, wr, 1)
    finally:
        qc.set_conv_bwd_quant("none")
    return lambda: torch.autograd.grad(y, (xr, wr), g, retain_graph=True)


def qc_shape_checks(smi):
    """Phase 13a: each stride-1 conv shape of ResNet-152's layers 2-4 in
    bf16 (fp32 kernel, as the bf16 train step's trunk; x post-ReLU, g
    Gaussian). The int8 backward on the card against its CPU twin at
    QC_TWIN_B images: operands, scales and counts equal, dx and dw within
    1 ulp. At TRAIN_B: "manual" against autograd's cuDNN backward within
    QC_MANUAL_REL of each tensor's largest value, the three backwards timed
    (CUDA events, mean of QC_ITERS), and the largest |count| of dx and dw as
    a share of 2^31."""
    import torch

    from adaptive_tpu_torch.ops import quant_conv as qc

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1300)
    cl = torch.channels_last

    def inputs(b, k, ci, co, h):
        x = torch.relu(torch.randn(b, ci, h, h, device="cuda", generator=gen))
        g = torch.randn(b, co, h, h, device="cuda", generator=gen)
        return x.bfloat16().contiguous(memory_format=cl), g.bfloat16().contiguous(memory_format=cl)

    rows, totals = [], {"int8": 0.0, "manual": 0.0, "none": 0.0}
    for k, ci, co, h, n in QC_SHAPES:
        w = torch.randn(co, ci, k, k, device="cuda", generator=gen) * (2.0 / (k * k * co)) ** 0.5
        w = w.contiguous(memory_format=cl)
        x, g = inputs(QC_TWIN_B, k, ci, co, h)
        card = qc_parts(x, w, g)
        cpu = qc_parts(x.cpu(), w.cpu(), g.cpu())
        for key in ("gq", "wq", "xq", "dx_counts", "dw_counts"):
            if not torch.equal(card[key].cpu(), cpu[key]):
                raise AssertionError(f"13a {(k, ci, co, h)}: {key} differs from the CPU twin's")
        for key in ("sg", "sw", "sx"):
            if card[key].item() != cpu[key].item():
                raise AssertionError(f"13a {(k, ci, co, h)}: scale {key} {card[key].item()} vs "
                                     f"{cpu[key].item()}")
        twin_ulps = {key: ulps(card[key].cpu(), cpu[key]) for key in ("dx", "dw")}
        if max(twin_ulps.values()) > 1:
            raise AssertionError(f"13a {(k, ci, co, h)}: dx, dw {twin_ulps} ulps from the twin")
        del card, cpu
        x, g = inputs(TRAIN_B, k, ci, co, h)
        runs = {m: qc_backward(m, x, w, g) for m in ("none", "manual", "int8")}
        ref, man = runs["none"](), runs["manual"]()
        rel = [float((a.float() - b.float()).abs().max() / b.float().abs().max())
               for a, b in zip(man, ref)]
        if max(rel) > QC_MANUAL_REL:
            raise AssertionError(f"13a {(k, ci, co, h)}: manual vs cuDNN dx, dw {rel}")
        del ref, man
        ms = {m: cuda_ms(fn, QC_ITERS, 1) for m, fn in runs.items()}
        xq, _ = qc._q8(x)
        gq, _ = qc._q8(g)
        wq, _ = qc._q8(w)
        peak = max(int(qc.dw_counts(xq, gq, k).abs().max()),
                   int(qc.dx_counts(gq, wq).abs().max()))
        del runs, xq, gq, wq, x, g
        torch.cuda.empty_cache()
        row = {"k": k, "ci": ci, "co": co, "h": h, "convs": n, "twin_ulps": twin_ulps,
               "manual_rel": rel, **{f"{m}_ms": v for m, v in ms.items()},
               "count_share": peak / 2 ** 31}
        for m in totals:
            totals[m] += n * ms[m]
        log(f"[qc shape k{k} {ci}->{co} @{h} bf16] {smi}: batch {TRAIN_B}, {n} convs a step; "
            f"backward int8 {ms['int8']:.3f} ms, manual {ms['manual']:.3f} ms, cuDNN "
            f"{ms['none']:.3f} ms; int8 vs twin (batch {QC_TWIN_B}): operands, scales, counts "
            f"equal, dx/dw {twin_ulps['dx']}/{twin_ulps['dw']} ulp; manual vs cuDNN dx/dw "
            f"{rel[0]:.2e}/{rel[1]:.2e} of max; largest |count| {peak / 2 ** 31:.5f} of 2^31")
        rows.append(row)
    share = max(r["count_share"] for r in rows)
    log(f"[qc shapes bf16] {smi}: {sum(s[-1] for s in QC_SHAPES)} stride-1 convs a step; their "
        f"backwards summed over a step: int8 {totals['int8']:.1f} ms, manual "
        f"{totals['manual']:.1f} ms, cuDNN {totals['none']:.1f} ms; largest |count| "
        f"{share:.5f} of 2^31")
    return {"shapes": rows, "step_sum_ms": totals, "max_count_share": share}


def qc_layout(smi):
    """Phase 13a: dw's int8 product on one chunk of DW_CHUNK rows at layer2's
    first 3x3 shape (Co 128, 9 x 128 columns) on the transposed rows as a
    strided view and copied contiguous (ops/quant_conv.py::dw_counts takes
    the copy); both results equal the CPU's product."""
    import torch

    from adaptive_tpu_torch.ops.int8 import int_mm
    from adaptive_tpu_torch.ops.quant_conv import DW_CHUNK

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1350)
    rows = torch.randint(-127, 128, (DW_CHUNK, 128), dtype=torch.int8, device="cuda",
                         generator=gen)
    cols = torch.randint(-127, 128, (DW_CHUNK, 1152), dtype=torch.int8, device="cuda",
                         generator=gen)
    # fp64 sums of these products are exact: |sum| < 2^31 < 2^53
    want = rows.t().cpu().double() @ cols.cpu().double()
    out = {}
    for tag, fn in (("strided", lambda: int_mm(rows.t(), cols)),
                    ("contiguous", lambda: int_mm(rows.t().contiguous(), cols))):
        if not torch.equal(fn().cpu().double(), want):
            raise AssertionError(f"13a layout {tag}: the int8 product differs from the CPU's")
        out[f"{tag}_ms"] = cuda_ms(fn, QC_ITERS, 1)
    log(f"[qc layout int8] {smi}: dw's product over {DW_CHUNK} rows, [128 x K] x [K x 1152]: "
        f"on the strided transposed view {out['strided_ms']:.3f} ms, copied contiguous "
        f"(the copy included) {out['contiguous_ms']:.3f} ms")
    return out


def grad_groups(net):
    """{layer2|layer3|layer4: [(name, grad)]} of the trunk's fine-tuned part."""
    out = {}
    for name, p in net.encoder.resnet_conv.named_parameters():
        li = int(name.split(".")[0])
        if li >= 5 and p.grad is not None:
            out.setdefault(f"layer{li - 3}", []).append((name, p.grad.detach().float().clone()))
    return out


def qc_train(smi, none_step=None):
    """Phase 13b: phase 8a's step (bf16, batch TRAIN_B, encoder on) in modes
    "manual" and "int8" through train_throughput (1 warm-up step, QC_STEPS
    timed), beside "none" (8a's from the same run, or run here); each mode's
    device busy ms a step from a profile of STEP_RUNS steps, over the timed
    step's ms, and per layer group the int8 and manual gradients' cosine and
    relative error against "none"'s on the same weights, batch and draws
    (printed, not bounded)."""
    import torch

    from adaptive_tpu_torch import Config
    from adaptive_tpu_torch.models import build_model
    from adaptive_tpu_torch.ops import quant_conv as qc
    from adaptive_tpu_torch.training.optim import make_dual_optimizer
    from adaptive_tpu_torch.training.step import make_train_step

    steps = {"none": dict(none_step)} if none_step is not None else {}
    for mode in MODES_QC[1:] if none_step is not None else MODES_QC:
        qc.set_conv_bwd_quant(mode)
        try:
            steps[mode] = train_throughput(smi, modes=(("encoder_on", True),), warmup=1,
                                           steps=QC_STEPS,
                                           label=f"train step conv_bwd_quant={mode}")["encoder_on"]
        finally:
            qc.set_conv_bwd_quant("none")
    cf = Config(compute_dtype="bfloat16", vocab_pad_multiple=128, train_batch_size=TRAIN_B)
    model = build_model(cf)
    net = model.init(SEED)
    start = {k: v.clone() for k, v in net.state_dict().items()}
    batch = train_batch(TRAIN_B, SEED + 300, "cuda")
    grads, busy = {}, {}
    for mode in MODES_QC:
        qc.set_conv_bwd_quant(mode)
        try:
            net.load_state_dict(start)
            step = make_train_step(model, make_dual_optimizer(net, cf), cf)
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            loss = float(step(net, batch, gen, True).loss)
            if not torch.isfinite(torch.tensor(loss)):
                raise AssertionError(f"13b {mode}: loss {loss}")
            grads[mode] = grad_groups(net)
            _, b_us, _ = profile_decode(lambda: [step(net, batch, gen, True)
                                                 for _ in range(STEP_RUNS)], None, smi,
                                        f"train_encoder_on_qc_{mode}")
            busy[mode] = b_us / 1e3 / STEP_RUNS  # device busy ms a step
        finally:
            qc.set_conv_bwd_quant("none")
    quality = {}
    for mode in ("manual", "int8"):
        quality[mode] = {}
        for group, pairs in grads["none"].items():
            ref = torch.cat([g.flatten() for _, g in pairs])
            got = torch.cat([g.flatten() for _, g in grads[mode][group]])
            quality[mode][group] = {
                "cos": float(got @ ref / (got.norm() * ref.norm())),
                "rel": float((got - ref).norm() / ref.norm())}
    del net, model, grads
    torch.cuda.empty_cache()
    for mode in MODES_QC:
        s = steps[mode]
        s["busy_ms"] = busy[mode]
        s["busy_share"] = busy[mode] / s["ms"]  # of the timed, unprofiled step
        q = "; ".join(f"{gname} cos {v['cos']:.5f} rel {v['rel']:.4f}"
                      for gname, v in quality.get(mode, {}).items())
        log(f"[qc train {mode} bf16] {smi}: batch {TRAIN_B}, encoder on: {s['ms']:.3f} ms a step, "
            f"{s['images_per_s']:.1f} images/s ({s['images_per_s'] / steps['none']['images_per_s']:.3f}"
            f" of none), peak allocated {s['peak_bytes'] / 2 ** 30:.2f} GiB, device "
            f"busy {busy[mode]:.3f} ms a step ({s['busy_share']:.4f} of the step)"
            + (f"; gradients against none: {q}" if q else ""))
    return {"steps": steps, "grad_quality": quality}


def qc_manual_parity(cf, net_g, smi):
    """Phase 13b's check: one fp32 step (TF32 off) at batch TRAIN_PARITY_B,
    encoder on, in mode "manual" against mode "none" on the card from the
    same weights (phase 4's), batch and draws, by phase 8c's bounds: loss,
    LSTM norm, BN statistics, the decoder group's gradients, and the encoder
    group's within TRAIN_ENC_GRAD_REL of their norm."""
    import torch

    from adaptive_tpu_torch.models import build_model
    from adaptive_tpu_torch.ops import quant_conv as qc
    from adaptive_tpu_torch.training.optim import make_dual_optimizer
    from adaptive_tpu_torch.training.step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    start = {k: v.clone() for k, v in net_g.state_dict().items()}
    batch = train_batch(TRAIN_PARITY_B, SEED + 700, "cuda")
    model = build_model(cf, device="cuda")
    runs = {}
    for mode in ("none", "manual"):
        qc.set_conv_bwd_quant(mode)
        try:
            net_g.load_state_dict(start)
            dual = make_dual_optimizer(net_g, cf)
            res = make_train_step(model, dual, cf)(
                net_g, batch, torch.Generator(device="cuda").manual_seed(SEED), True)
        finally:
            qc.set_conv_bwd_quant("none")
        runs[mode] = (float(res.loss), float(res.lstm_grad_norm),
                      {n: p.grad.detach().clone() for n, p in net_g.named_parameters()
                       if p.grad is not None},
                      {k: v.detach().clone() for k, v in net_g.state_dict().items()}, dual)
    net_g.load_state_dict(start)
    (lr, nr, gr, sr, dual), (lm, nm, gm, sm, _) = runs["none"], runs["manual"]
    d_loss, d_norm = abs(lm - lr) / abs(lr), abs(nm - nr) / abs(nr)
    bn = [k for k in sr if k.endswith(("running_mean", "running_var"))]
    d_bn = max(float(((sm[k] - sr[k]).abs() / sr[k].abs().clamp(min=1)).max()) for k in bn)
    dec, enc = dual.names("decoder"), dual.names("encoder")
    d_grad = max(float((gm[k] - gr[k]).abs().max())
                 / (TRAIN_GRAD_ATOL + TRAIN_GRAD_RTOL * float(gr[k].abs().max())) for k in dec)
    num = sum(float((gm[k] - gr[k]).double().pow(2).sum()) for k in enc)
    den = sum(float(gr[k].double().pow(2).sum()) for k in enc)
    d_enc = (num / den) ** 0.5
    line = {"loss_rel": d_loss, "norm_rel": d_norm, "bn_rel": d_bn, "dec_grad_of_bound": d_grad,
            "enc_grad_rel": d_enc}
    if (d_loss > TRAIN_RTOL or d_norm > TRAIN_RTOL or d_bn > TRAIN_BN_TOL or d_grad > 1
            or d_enc > TRAIN_ENC_GRAD_REL):
        raise AssertionError(f"13b manual vs none fp32: {line}")
    log(f"[qc manual parity fp32, TF32 off] {smi}: batch {TRAIN_PARITY_B}, encoder on, manual vs "
        f"none: loss rel {d_loss:.2e}, LSTM norm rel {d_norm:.2e}, BN statistics {d_bn:.2e}, "
        f"decoder gradients {d_grad:.2e} of their bound, encoder gradients {d_enc:.2e} of their "
        f"norm (bound {TRAIN_ENC_GRAD_REL})")
    return line


def det_polygon(rng, x, y, w, h):
    """An octagon inside the box, its corners jittered: a COCO-like
    polygon segmentation, and its area (the shoelace formula)."""
    import numpy as np

    t = np.arange(8) * np.pi / 4 + rng.uniform(0, np.pi / 4)
    r = rng.uniform(0.7, 1.0, 8)
    px = x + w / 2 + np.cos(t) * r * w / 2
    py = y + h / 2 + np.sin(t) * r * h / 2
    area = 0.5 * abs(float(np.dot(px, np.roll(py, -1)) - np.dot(py, np.roll(px, -1))))
    return [float(v) for xy in zip(px, py) for v in xy], area


def det_dataset(root, seed):
    """Phase 13c's seeded set of COCO val's shape: DET_IMAGES images of
    640x480 or 480x640, DET_CATS categories, Poisson(DET_GT) ground truths
    an image (octagon polygons; 1% crowds, a box's compressed RLE), and up
    to DET_MAX_DETS detections an image (jittered copies of the ground
    truths, a fifth in another category, and background boxes; scores
    uniform); the first DET_SEGM_IMAGES images' detections also as box RLEs
    for segm. Returns (gt path, bbox results, segm results)."""
    import numpy as np

    from adaptive_tpu_torch.native import mask

    rng = np.random.default_rng(seed)
    images, anns, dts_bbox, dts_segm = [], [], [], []
    cats = [{"id": c + 1, "name": f"cat{c + 1}", "supercategory": "x"} for c in range(DET_CATS)]

    def box_rle(box, ht, wd):
        rle = mask.frPyObjects([box], ht, wd)[0]
        return {"size": rle["size"], "counts": rle["counts"].decode()}

    for i in range(DET_IMAGES):
        wd, ht = (640, 480) if rng.random() < 0.7 else (480, 640)
        images.append({"id": i + 1, "width": wd, "height": ht, "file_name": f"{i + 1:012d}.jpg"})
        mine = []
        for _ in range(max(1, rng.poisson(DET_GT))):
            w, h = rng.uniform(8, wd / 2), rng.uniform(8, ht / 2)
            x, y = rng.uniform(0, wd - w), rng.uniform(0, ht - h)
            crowd = rng.random() < 0.01
            poly, area = det_polygon(rng, x, y, w, h)
            seg = box_rle([x, y, w, h], ht, wd) if crowd else [poly]
            mine.append({"id": len(anns) + len(mine) + 1, "image_id": i + 1,
                         "iscrowd": int(crowd), "category_id": int(rng.integers(1, DET_CATS + 1)),
                         "bbox": [x, y, w, h], "area": w * h if crowd else area,
                         "segmentation": seg})
        anns += mine
        for d in range(int(rng.integers(len(mine), DET_MAX_DETS + 1))):
            if d < 2 * len(mine):
                a = mine[d % len(mine)]
                x, y, w, h = a["bbox"]
                x, y = x + rng.normal(0, 0.08 * w), y + rng.normal(0, 0.08 * h)
                w, h = w * rng.uniform(0.85, 1.15), h * rng.uniform(0.85, 1.15)
                cat = a["category_id"] if rng.random() < 0.8 else int(rng.integers(1, DET_CATS + 1))
            else:
                w, h = rng.uniform(8, wd / 3), rng.uniform(8, ht / 3)
                x, y = rng.uniform(0, wd - w), rng.uniform(0, ht - h)
                cat = int(rng.integers(1, DET_CATS + 1))
            x, y = max(0.0, x), max(0.0, y)
            box = [x, y, min(w, wd - x), min(h, ht - y)]
            det = {"image_id": i + 1, "category_id": cat, "score": float(rng.random())}
            dts_bbox.append({**det, "bbox": box})
            if i < DET_SEGM_IMAGES:
                dts_segm.append({**det, "segmentation": box_rle(box, ht, wd)})
    path = os.path.join(root, "instances_synthetic.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": cats}, f)
    return path, dts_bbox, dts_segm


def detection(smi):
    """Phase 13c: the detection stack on the card's host. Both native
    libraries built there with g++ (forced, into adaptive_tpu_torch/native/
    build/) and loaded; fast_json's columns of the synthetic ground truth
    against the stdlib json parse of the file; COCOeval bbox and segm over
    det_dataset: evaluate and accumulate seconds, the 12 stats (finite, in
    [0, 1] or -1), and the same on a one-image set whose detections are its
    ground truths (AP 1)."""
    import tempfile

    import numpy as np

    from adaptive_tpu_torch.data import fast_json
    from adaptive_tpu_torch.data.coco_api import COCO
    from adaptive_tpu_torch.evalcap.detection import COCOeval
    from adaptive_tpu_torch.native import build, mask

    t0 = time.perf_counter()
    libs = [build._build(build.SRC, True), build._build(build.JSON_SRC, True)]
    build_s = time.perf_counter() - t0
    if fast_json._load_lib() is None or mask._lib() is None:
        raise AssertionError(f"13c: a native library did not load ({fast_json._lib_err})")
    out = {"card": smi, "build_s": build_s, "libraries": [os.path.relpath(p, HERE) for p in libs]}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        gt_path, dts_bbox, dts_segm = det_dataset(root, SEED + 1400)
        out["make_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cols = fast_json.load_columns(gt_path)
        out["fast_json_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with open(gt_path) as f:
            ref = json.load(f)
        out["stdlib_json_s"] = time.perf_counter() - t0
        out["json_bytes"] = os.path.getsize(gt_path)
        want = {"img_ids": [i["id"] for i in ref["images"]],
                "img_heights": [i["height"] for i in ref["images"]],
                "img_widths": [i["width"] for i in ref["images"]],
                "file_names": [i["file_name"] for i in ref["images"]],
                "ann_ids": [a["id"] for a in ref["annotations"]],
                "ann_img_ids": [a["image_id"] for a in ref["annotations"]],
                "captions": [""] * len(ref["annotations"]),
                "cat_ids": [c["id"] for c in ref["categories"]],
                "cat_names": [c["name"] for c in ref["categories"]]}
        for key, v in want.items():
            got = getattr(cols, key)
            if list(got.tolist() if isinstance(got, np.ndarray) else got) != v:
                raise AssertionError(f"13c: fast_json's {key} differs from json's")
        gt = COCO(gt_path)
        out["images"], out["ground_truths"] = len(gt.imgs), len(gt.anns)
        out["crowds"] = sum(a["iscrowd"] for a in gt.anns.values())
        for iou_type, dts in (("bbox", dts_bbox), ("segm", dts_segm)):
            t0 = time.perf_counter()
            ev = COCOeval(gt, gt.loadRes(dts), iou_type)
            ev.params.imgIds = sorted({d["image_id"] for d in dts})
            t1 = time.perf_counter()
            ev.evaluate()
            t2 = time.perf_counter()
            ev.accumulate()
            t3 = time.perf_counter()
            stats = ev.summarize()
            ok = np.isfinite(stats).all() and all(s == -1 or 0 <= s <= 1 for s in stats)
            if not ok or stats[0] <= 0:
                raise AssertionError(f"13c {iou_type}: stats {stats.tolist()}")
            out[iou_type] = {"images": len(ev.params.imgIds), "detections": len(dts),
                             "load_res_s": t1 - t0,
                             "evaluate_s": t2 - t1, "accumulate_s": t3 - t2,
                             "stats": stats.tolist()}
        one = COCO()
        img = gt.imgs[1]
        mine = [a for a in gt.anns.values() if a["image_id"] == 1 and not a["iscrowd"]]
        one.dataset = {"images": [img], "annotations": mine, "categories": ref["categories"]}
        one.createIndex()
        for iou_type in ("bbox", "segm"):
            res = [{"image_id": 1, "category_id": a["category_id"], "score": 1.0,
                    **({"bbox": a["bbox"]} if iou_type == "bbox" else
                       {"segmentation": one.annToRLE(a)})} for a in mine]
            ev = COCOeval(one, one.loadRes(res), iou_type)
            ev.evaluate()
            ev.accumulate()
            stats = ev.summarize()
            if abs(stats[0] - 1.0) > 1e-12:  # the mean of 1.0s over the IoU thresholds
                raise AssertionError(f"13c {iou_type}: detections equal to the ground truths "
                                     f"give AP {stats[0]}")
    for iou_type in ("bbox", "segm"):
        v = out[iou_type]
        log(f"[detection {iou_type}] {smi} (host): {v['images']} of {out['images']} images, "
            f"{DET_CATS} categories, {out['ground_truths']} ground truths in all ({out['crowds']} "
            f"crowds), {v['detections']} "
            f"detections: loadRes {v['load_res_s']:.2f} s, evaluate {v['evaluate_s']:.2f} s, "
            f"accumulate {v['accumulate_s']:.2f} s; stats "
            f"{[round(s, 4) for s in v['stats']]}")
    log(f"[detection native] {smi} (host): g++ built both libraries in {build_s:.2f} s "
        f"({', '.join(out['libraries'])}); fast_json columns == json on a "
        f"{out['json_bytes']} byte file: "
        f"{out['fast_json_s']:.3f} s against {out['stdlib_json_s']:.3f} s; one image with its "
        f"ground truths as detections: AP 1 (bbox, segm)")
    return out


def conv_bwd_quant(smi, none_step=None, fp32=None):
    """Phase 13a and 13b: the conv-backward experiment. fp32: phase 4's
    (cf, net on the card) for 13b's fp32 check, else built here."""
    import torch

    t0 = time.perf_counter()
    line = {"card": smi, "shapes": qc_shape_checks(smi), "dw_layout": qc_layout(smi)}
    t1 = time.perf_counter()
    line["train"] = qc_train(smi, none_step)
    if fp32 is None:
        from adaptive_tpu_torch import Config

        torch.backends.cudnn.allow_tf32 = False
        cf = Config(compute_dtype="float32")
        fp32 = (cf, random_model(cf, "cuda", seeded_images(32, SEED))[1])
    line["manual_parity_fp32"] = qc_manual_parity(*fp32, smi)
    line["phase_s"] = {"13a": t1 - t0, "13b": time.perf_counter() - t1}
    return line


# ---------------------------------------------------------------- phase 14
def counted(decode, net, images):
    """One decode with every launch count set to 0 just before and read
    just after: (output, counts)."""
    import torch

    reset_launch_counts()
    out = decode(net, images)
    torch.cuda.synchronize()
    return out, launch_counts()


def steps_to_end(ids, eos) -> int:
    """The steps an early-exit decode runs: until every sequence of ids
    [..., STEPS] has emitted eos (STEPS where one never does). A beam
    decode's final beams are the slots of its exit step, so their ids say
    it as the greedy ids do."""
    hit = ids == eos
    first = hit.int().argmax(-1).masked_fill(~hit.any(-1), STEPS - 1)
    return int(first.max()) + 1


def mid_exit_boost(model, net, cf, images, bias, orig):
    """A boost of the <end> bias at which the fixed greedy loop ends every
    row after its first step and before its last: the first of
    MID_EXIT_LADDER, or one found by MID_EXIT_BISECTIONS bisections where
    the ladder jumps from no exit to an exit at step 1; None where neither
    finds one. Leaves the bias as it found it."""
    import torch

    from adaptive_tpu_torch.decoding import make_greedy_decoder

    eos = cf.decode_eos_token
    decode = make_greedy_decoder(model, cf)

    def steps(boost):
        with torch.no_grad():
            bias[eos] = orig + boost
        return steps_to_end(decode(net, images).ids, eos)

    try:
        lo = EXIT_BOOSTS[0]
        for hi in MID_EXIT_LADDER:
            n = steps(hi)
            if 1 < n < STEPS:
                return hi
            if n == 1:
                break
            lo = hi
        else:
            return None
        for _ in range(MID_EXIT_BISECTIONS):
            mid = (lo + hi) / 2
            n = steps(mid)
            if 1 < n < STEPS:
                return mid
            lo, hi = (mid, hi) if n == STEPS else (lo, mid)
        return None
    finally:
        with torch.no_grad():
            bias[eos] = orig


def early_exit(model, net, cf, images, smi, e2e, e2e_beam, p14):
    """Phase 14a: decode_early_exit=True, greedy and beam 3, on phase 3's
    weights and images, against the fixed loop: first on the weights as
    they are (ids, beams and scores torch.equal; captions/s of both, in
    turns: the early loop reads a flag to the host after every step), then
    with the head's <end> bias raised by each of EXIT_BOOSTS and by
    mid_exit_boost's. In every run the cell and head kernels launched once
    a step actually run, the steps steps_to_end counts on the fixed loop's
    ids (fewer than STEPS at 1e4), attention rows summing to 1 up to the
    exit and attention and beta 0 after it."""
    import torch

    from adaptive_tpu_torch.decoding import make_beam_decoder, make_greedy_decoder

    eos = cf.decode_eos_token
    bias = net.decoder.adaptive.mlp.bias
    orig = bias.detach()[eos].clone()
    mid = mid_exit_boost(model, net, cf, images, bias, orig)
    boosts = tuple(sorted(EXIT_BOOSTS + ((mid,) if mid else ())))
    line = {"mid_exit_boost": mid}
    for beam in (False, True):
        path = f"beam{BEAM}" if beam else "greedy"
        kernels = (("adaptive_decode_cell_fused_beam", "beam_head_topk") if beam
                   else ("adaptive_decode_cell_fused", "greedy_head_argmax"))

        def make(c):
            if beam:
                return make_beam_decoder(model, c, beam_size=BEAM)
            return make_greedy_decoder(model, c)

        fixed, early = make(cf), make(cf.replace(decode_early_exit=True))
        fixed(net, images)
        early(net, images)
        ms = {"fixed": [], "early": []}
        for name in ("fixed", "early", "early", "fixed", "fixed", "early")[:2 * E2E_REPEATS]:
            t0 = time.perf_counter()
            (fixed if name == "fixed" else early)(net, images)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
        mean = {k: sum(v) / len(v) for k, v in ms.items()}
        res = {"fixed_ms": mean["fixed"], "early_ms": mean["early"],
               "captions_per_s": B / mean["early"] * 1e3,
               "fixed_captions_per_s": B / mean["fixed"] * 1e3}
        try:
            for boost in (0.0,) + boosts:
                with torch.no_grad():
                    bias[eos] = orig + boost
                want = fixed(net, images)
                got, counts = counted(early, net, images)
                same = torch.equal(got.ids, want.ids)
                if beam:
                    same = same and torch.equal(got.all_ids, want.all_ids) and torch.equal(
                        got.all_scores, want.all_scores)
                need = steps_to_end(want.all_ids if beam else want.ids, eos)
                expect = {k: 0 for k in counts}
                expect.update({k: need for k in kernels}, folded_epilogue=ENCODE_EPILOGUES)
                att, beta = got.attention.float(), got.beta
                ran = att[:, :need].sum(-1)
                if not same or counts != expect or (boost == 1e4 and need >= STEPS) or \
                        att[:, need:].any() or beta[:, need:].any() or \
                        not torch.allclose(ran, torch.ones_like(ran), atol=1e-3):
                    raise AssertionError(f"early exit {path} at boost {boost:g}: equal to the fixed "
                                         f"loop {same}, launches {counts} for {need} steps, maps "
                                         f"after the exit zero {not att[:, need:].any()}")
                p14[f"14a {path} early exit, <end> bias +{boost:g}"] = counts
                res[f"steps_boost_{boost:g}"] = need
        finally:
            with torch.no_grad():
                bias[eos] = orig
        ref = e2e_beam if beam else e2e
        log(f"[early exit {path} bf16] {smi}: batch {B}, mean of {E2E_REPEATS} runs each in turns: "
            f"fixed loop {mean['fixed']:.3f} ms {ms['fixed']}, early exit {mean['early']:.3f} ms "
            f"{ms['early']} ({res['captions_per_s']:.1f} captions/s against the fixed loop's "
            f"{res['fixed_captions_per_s']:.1f} here and {ref['captions_per_s']:.1f} in phase "
            f"{'3b' if beam else '3'}); ids{' and beams' if beam else ''} equal the fixed loop's; "
            f"steps run (each kernel launched once a step) with the <end> bias as it is "
            f"{res['steps_boost_0']}, "
            + ", ".join(f"+{b:g}: {res[f'steps_boost_{b:g}']}" for b in boosts)
            + (f" (+{mid:g}: the ladder's first mid-decode exit of the greedy loop)" if mid
               else " (no boost of the ladder ends the greedy loop mid-decode)")
            + "; attention and beta 0 after the exit")
        line[path] = res
    return line


def beam_widths(model, net, cf, images_u8, smi, fp32, p14):
    """Phase 14b: make_beam_decoder at each of BEAM_WIDTHS in bf16 on phase
    3's weights and images, timed as phase 3b (kernels 3 and 4 once a step,
    kernels 1 and 2 never; beams well formed), then fp32 card vs CPU on
    phase 4's 8 images under phase 4b's rule at W = 5, and at W = BEAM with
    length_alpha LENGTH_ALPHA."""
    import torch

    from adaptive_tpu_torch.decoding import make_beam_decoder

    images = torch.as_tensor(images_u8, device="cuda")
    expect = {"adaptive_decode_cell_fused": 0, "greedy_head_argmax": 0,
              "adaptive_decode_cell_fused_beam": STEPS, "beam_head_topk": STEPS,
              "bottleneck_identity_int8": 0, "tail_conv1_int8": 0,
              "folded_epilogue": ENCODE_EPILOGUES, "ssm_step": 0}
    line = {}
    for W in BEAM_WIDTHS:
        decode = make_beam_decoder(model, cf, beam_size=W)
        out, launches, total_ms, enc_ms = timed_decodes(decode, net, model, cf, images, expect)
        ids = check_beams(out, W)
        total, enc = sum(total_ms) / len(total_ms), sum(enc_ms) / len(enc_ms)
        p14[f"14b beam{W}"] = launches
        line[f"beam{W}"] = {"total_ms": total, "encoder_ms": enc, "decode_loop_ms": total - enc,
                            "captions_per_s": B / total * 1e3}
        log(f"[end-to-end beam {W} bf16] {smi}: batch {B} ({B * W} rows), {STEPS} steps, mean of "
            f"{E2E_REPEATS} runs: total {total:.3f} ms {total_ms}, encoder {enc:.3f} ms "
            f"{enc_ms}, decode loop {total - enc:.3f} ms, {B / total * 1e3:.1f} captions/s; "
            f"launches {launches}; {len({tuple(r) for r in ids.tolist()})} distinct best "
            f"captions, first: {ids[0, :12].tolist()} score {float(out.score[0]):.4f}")
        del decode, out
        torch.cuda.empty_cache()
    line["parity_fp32_beam5"] = beam_parity(*fp32, images_u8, tag="beam parity fp32 W=5", W=5)
    line[f"parity_fp32_beam{BEAM}_alpha"] = beam_parity(
        *fp32, images_u8, tag=f"beam parity fp32 length_alpha={LENGTH_ALPHA}",
        length_alpha=LENGTH_ALPHA)
    return line


def int8_beyond_adaptive(smi, images_u8, fp32, p14):
    """Phase 14c: the int8 encoder under baseline_attention and
    rnn_attention: phase 6 (int8_parity, modes (a) and (c), fp32 card vs
    CPU) on each variant's phase 12b weights; in bf16 at batch B on phase
    12's weights, the baseline in modes (a) and (b) and rnn in mode (a),
    timed as phase 12a (kernel 2 STEPS times a decode, kernel 5 45 times in
    (b), kernels 1 and 3 never); then encoder_quant_bias_correct on the
    adaptive variant in mode (a), fp32 on phase 4's weights."""
    import torch

    from adaptive_tpu_torch import Config

    line = {}
    for variant, modes in zip(VARIANTS, ("ab", "a")):
        fp = fp32_models(images_u8, atten_model_name=variant)
        out = {"parity_fp32": int8_parity(fp[0], fp[2], fp[4], label=f"int8 parity {variant} fp32")}
        del fp
        cf = Config(compute_dtype="bfloat16", atten_model_name=variant)
        model, net = random_model(cf, "cuda", images_u8[:32])
        int8 = int8_modes(cf, net, images_u8)[0]
        for tag in modes:
            m, mcf, extra = int8[tag]
            launches, out[f"int8_{tag}"] = variant_decode(m, net, mcf, images_u8, smi, False,
                                                          tag=f"int8 {tag} greedy", extra=extra)
            p14[f"14c {variant} int8 {tag} greedy"] = launches
        line[variant] = out
        del model, net, int8
        torch.cuda.empty_cache()
    line["bias_correct_fp32"] = int8_parity(
        fp32[0].replace(encoder_quant_bias_correct=True), fp32[2], fp32[4],
        modes=INT8_PARITY_MODES[:1], label="int8 bias-corrected parity fp32")
    return line


def layer_table(smi, e2e_int8):
    """Phase 14d: tools/torch_layer_bench.py's table at batch LAYER_B over
    ResNet-152's 24 conv shapes (155 convs), after its gate: each shape's
    int32 accumulator on the card equal to the CPU's at batch LAYER_GATE_B
    on the same inputs."""
    import torch

    lb = tools_module("torch_layer_bench")
    convs = sum(c[-1] for c in lb.RESNET152_CONVS)
    if convs != 155 or len(lb.RESNET152_CONVS) != 24:
        raise AssertionError(f"RESNET152_CONVS: {len(lb.RESNET152_CONVS)} shapes, {convs} convs")
    for i, (name, _, _, _, k, stride, _) in enumerate(lb.RESNET152_CONVS):
        x, kernel, bias = lb.shape_inputs(i, LAYER_GATE_B)
        got = lb.accumulator(*lb.to_device(x, kernel, bias, "cuda"), stride, k).cpu()
        want = lb.accumulator(*lb.to_device(x, kernel, bias, "cpu"), stride, k)
        if not torch.equal(got, want):
            raise AssertionError(f"layer bench {name}: {int((got != want).sum())} accumulator "
                                 f"elements differ between the card and the CPU")
    table = lb.bench(LAYER_B, LAYER_INNER, device="cuda", log=lambda m: log(f"[layer bench] {m}"))
    enc = e2e_int8["a"]["encoder_ms"]
    log(f"[layer table int8 bf16] {smi}: _conv_i8 at batch {LAYER_B}, {len(table['rows'])} shapes, "
        f"{convs} convs: weighted total {table['total_ms']} ms; int_mm peak "
        f"{table['peak_tops']} TOPS; accumulators at batch {LAYER_GATE_B} equal the CPU's at "
        f"every shape. Phase 5's int8 (a) encoder: {enc:.3f} ms at batch {B}; it runs the carry "
        f"(_acc_i8: weights quantised once, s8 activations between convs), not _conv_i8, so the "
        f"two are not the same quantity")
    return {**table, "gate_batch": LAYER_GATE_B, "accumulators_equal": True,
            "int8_a_encoder_ms_batch_1024": enc}


def remat_parity(cf, net, smi):
    """Phase 14e: one fp32 train step (TF32 off, encoder on) with
    remat_encoder against one without, on the card from phase 4's weights
    at batch TRAIN_PARITY_B, the same batch and draws, cuDNN deterministic
    (so that two plain steps agree too): the loss within REMAT_TOL
    (relative) and every weight and BN statistic within REMAT_TOL, the bound
    of tests/test_torch_train_step.py::test_remat_encoder_equals_plain.
    Leaves net at its weights."""
    import torch

    from adaptive_tpu_torch.models import build_model
    from adaptive_tpu_torch.training.optim import make_dual_optimizer
    from adaptive_tpu_torch.training.step import make_train_step

    start = {k: v.detach().clone() for k, v in net.state_dict().items()}
    batch = train_batch(TRAIN_PARITY_B, SEED + 700, "cuda")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for remat in (False, True):
            c = cf.replace(remat_encoder=remat)
            net.load_state_dict(start)
            dual = make_dual_optimizer(net, c)
            res = make_train_step(build_model(c), dual, c)(
                net, batch, torch.Generator().manual_seed(SEED), True)
            runs[remat] = (float(res.loss), {k: v.detach().double() for k, v in
                                             net.state_dict().items()})
    finally:
        torch.backends.cudnn.deterministic = deterministic
        net.load_state_dict(start)
    (lp, sp), (lr, sr) = runs[False], runs[True]
    loss_rel = abs(lr - lp) / abs(lp)
    d = max(float((sr[k] - sp[k]).abs().max()) for k in sp)
    moved = max(float((sp[k] - start[k].double()).abs().max()) for k in sp)
    if loss_rel > REMAT_TOL or d > REMAT_TOL or moved == 0:
        raise AssertionError(f"remat step: loss rel {loss_rel:.3e}, weights and BN {d:.3e}, "
                             f"the plain step moved them by {moved:.3e}")
    log(f"[remat parity fp32, TF32 off] {smi}: batch {TRAIN_PARITY_B}, encoder on, one step with "
        f"remat_encoder against one without: loss {lr:.7f} vs {lp:.7f} (rel {loss_rel:.2e}), "
        f"weights and BN statistics max |d| {d:.2e} (bound {REMAT_TOL}; the step moved them by up "
        f"to {moved:.2e})")
    return {"loss_rel": loss_rel, "state_abs": d}


def train_configs(smi, fp32, step_8a):
    """Phase 14e: the train step (adaptive_attention, encoder on, layers
    2-4) with remat_encoder in bf16 at batch TRAIN_B beside phase 8a's, and
    in fp32 against the plain step (remat_parity); at batch TRAIN_B_LARGE
    in bf16; with SGD in both groups (the config's momenta), fp32 card vs
    CPU under phase 8c's bounds (train_parity) and bf16 at TRAIN_B."""
    sgd = {"opt_rnn_optimization": "sgd", "opt_cnn_optimization": "sgd"}
    on = (("encoder_on", True),)
    line = {"remat_bf16": train_throughput(smi, None, on, label="train step remat_encoder",
                                           remat_encoder=True)["encoder_on"],
            "remat_parity_fp32": remat_parity(fp32[0], fp32[2], smi)}
    line[f"batch{TRAIN_B_LARGE}_bf16"] = train_throughput(
        smi, None, on, label=f"train step batch {TRAIN_B_LARGE}",
        batch_size=TRAIN_B_LARGE)["encoder_on"]
    line["sgd_parity_fp32"] = train_parity(fp32[0].replace(**sgd), fp32[2], fp32[4], smi,
                                           label="train parity sgd fp32")
    line["sgd_bf16"] = train_throughput(smi, None, on, label="train step sgd", **sgd)["encoder_on"]
    r, big, s = line["remat_bf16"], line[f"batch{TRAIN_B_LARGE}_bf16"], line["sgd_bf16"]
    log(f"[train configs bf16] {smi}: encoder on; 8a's Adam step at batch {TRAIN_B} "
        f"{step_8a['ms']:.3f} ms, {step_8a['peak_bytes'] / 2**30:.2f} GiB; remat_encoder "
        f"{r['ms']:.3f} ms, {r['peak_bytes'] / 2**30:.2f} GiB; batch {TRAIN_B_LARGE} "
        f"{big['images_per_s']:.1f} images/s ({big['ms']:.3f} ms, "
        f"{big['peak_bytes'] / 2**30:.2f} GiB); SGD {s['images_per_s']:.1f} images/s against "
        f"8a's {step_8a['images_per_s']:.1f}")
    return line


def phase14_launches(p14, name):
    """{run of phase 14: the kernel's launches in it} where it launched."""
    return {run: counts[name] for run, counts in p14.items() if counts.get(name)}


def phase_14(smi, e2e, e2e_beam, e2e_int8, step_8a):
    """Phase 14: 14a-14e in turn, each printing its JSON line. Its fp32
    checks run on phase 4's weights rebuilt from their seed on both
    devices (phases 8c-13 have stepped phase 4's nets, the card's and the
    CPU's each by its own rounding). Returns {sub-phase: its numbers} and
    {run: the launch counts of that run's main path, set to 0 just before
    it and read just after}."""
    import torch

    from adaptive_tpu_torch import Config

    p14, line, spans = {}, {"card": smi}, {}
    images_u8 = seeded_images(B, SEED)
    images = torch.as_tensor(images_u8, device="cuda")
    t0 = time.perf_counter()
    fp32 = fp32_models(images_u8)
    cf = Config(compute_dtype="bfloat16")
    model, net = random_model(cf, "cuda", images_u8[:32])  # phase 3's weights, from its seed
    line["14a_early_exit"] = early_exit(model, net, cf, images, smi, e2e, e2e_beam, p14)
    spans["14a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    line["14b_beam_widths"] = beam_widths(model, net, cf, images_u8, smi, fp32, p14)
    del model, net, images
    torch.cuda.empty_cache()
    spans["14b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    line["14c_int8"] = int8_beyond_adaptive(smi, images_u8, fp32, p14)
    spans["14c"] = time.perf_counter() - t0
    del images_u8
    reset_launch_counts()  # 14d and 14e run none of the eight kernels
    t0 = time.perf_counter()
    line["14d_layer_table"] = layer_table(smi, e2e_int8)
    spans["14d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    line["14e_train"] = train_configs(smi, fp32, step_8a)
    spans["14e"] = time.perf_counter() - t0
    after = launch_counts()
    if any(after.values()):
        raise AssertionError(f"phases 14d and 14e launched a kernel: {after}")
    line["phase_s"] = spans
    for key in ("14a_early_exit", "14b_beam_widths", "14c_int8", "14d_layer_table", "14e_train"):
        log(json.dumps({f"phase{key}": {"card": smi, **line[key]}}))
    log("[phase 14] " + ", ".join(f"{k} {v:.1f} s" for k, v in spans.items())
        + f"; phase 14 {sum(spans.values()):.1f} s")
    return line, p14


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile one end-to-end decode of each path with "
                         "torch.profiler; the kernel tables go to DIR/profile_e2e_<path>.txt")
    # phase 11 starts its ranks as this script with these (md_rank)
    ap.add_argument("--md-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--md-job", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(HERE, "adaptive_tpu_torch", "ops", "cuda", "csrc")):
        print("chip_smoke.py: adaptive_tpu_torch is not beside this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if args.md_rank is not None:
        return md_rank(args.md_rank, args.md_job)
    import numpy as np

    from adaptive_tpu_torch.ops.cuda import build

    # phase 1: the card, versions, the kernels' build
    smi = smi_line()
    log(smi)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib = build.build()
    build.load()
    log(f"[build] {os.path.basename(lib)} built/loaded in {time.perf_counter() - t0:.2f} s")

    # phase 2: each kernel against its plain twin at the main path's shapes
    warm_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checks = {dt: kernel_checks(dt) for dt in ("float32", "bfloat16")}

    # phase 2b: the beam kernels against their twins, beam 3 timed, beam 5 checked
    for dt in ("float32", "bfloat16"):
        checks[dt].update(beam_kernel_checks(dt, BEAM))
        beam_kernel_checks(dt, 5, timed=False)

    # phase 3: the greedy path end to end, bf16, full width
    from adaptive_tpu_torch import Config

    images_u8 = seeded_images(B, SEED)
    cf = Config(compute_dtype="bfloat16")
    model, net = random_model(cf, "cuda", images_u8[:32])
    launches, e2e = end_to_end(model, net, cf, images_u8, smi, args.profile)

    # phase 3b: beam search end to end on the same model and images
    beam_launches, e2e_beam = beam_end_to_end(model, net, cf, images_u8, smi, args.profile)
    launches.update(beam_launches)

    # phase 2c, run after the exact paths so that phases 3 and 3b meet the
    # card fresh from the decode kernels' checks: the int8 kernels against
    # their twins
    del model
    torch.cuda.empty_cache()
    int8_checks = int8_kernel_checks()

    # phase 2d: kernel 7, the float encoder's conv epilogue, at one encode's
    # shapes
    epilogue = epilogue_checks(smi)

    # phase 2e: kernel 8, the hybrid LM's Mamba-2 decode step; phase 3c: the
    # granite_h_micro variant's greedy path end to end on phase 3's images
    ssm = ssm_step_checks(smi)
    torch.cuda.empty_cache()
    hybrid_launches, e2e_hybrid = hybrid_end_to_end(images_u8, smi, args.profile)
    launches["ssm_step"] = hybrid_launches["ssm_step"]
    torch.cuda.empty_cache()

    # phase 5: the int8 encoder end to end, modes (a), (t), (b), (c)
    int8_launches, e2e_int8 = int8_end_to_end(net, cf, images_u8, smi, args.profile)
    launches["bottleneck_identity_int8"] = int8_launches["b"]["bottleneck_identity_int8"]
    launches["tail_conv1_int8"] = int8_launches["c"]["tail_conv1_int8"]

    # phases 4 and 4b: fp32 greedy ids and beams on the card equal the CPU's
    fp32 = fp32_models(images_u8)
    cross_device_parity(*fp32, images_u8)
    beam_parity(*fp32, images_u8)

    # phase 6: int8 in fp32, card vs CPU, modes (a) and (c)
    int8_parity(fp32[0], fp32[2], fp32[4])

    # phase 7a: the eval driver over a 5,000-image split, bf16, on phase 3's
    # weights
    del images_u8
    t0 = time.perf_counter()
    eval_line = eval_driver(net, cf, smi)
    del net
    torch.cuda.empty_cache()

    # phase 7b: the eval driver in fp32, card vs CPU, and valid mode from a
    # model.npz
    t1 = time.perf_counter()
    eval_line["parity_fp32"] = eval_parity(*fp32, smi)
    eval_line["phase_s"] = {"7a": t1 - t0, "7b": time.perf_counter() - t1}
    log(f"[eval phases] 7a {eval_line['phase_s']['7a']:.1f} s, 7b {eval_line['phase_s']['7b']:.1f} s")

    # phase 8: training; 8a the step's throughput at batch 256, 8b main_train
    # end to end, 8c one fp32 step card vs CPU on phase 4's weights
    t2 = time.perf_counter()
    train_line = {"card": smi, "step": train_throughput(smi, args.profile)}
    t3 = time.perf_counter()
    train_line["main_train"] = train_loop(smi)
    t4 = time.perf_counter()
    train_line["parity_fp32"] = train_parity(fp32[0], fp32[2], fp32[4], smi)
    train_line["phase_s"] = {"8a": t3 - t2, "8b": t4 - t3, "8c": time.perf_counter() - t4}
    log(f"[train phases] " + ", ".join(f"{k} {v:.1f} s" for k, v in train_line["phase_s"].items()))

    # phase 9: the L-BFGS groups, 9a the step at batch 256, 9b two fp32 steps
    # card vs CPU on phase 4's weights; 9c the CLI end to end
    t5 = time.perf_counter()
    lbfgs_line = {"card": smi, "step": lbfgs_throughput(smi, args.profile)}
    t6 = time.perf_counter()
    other = fp32_models(seeded_images(32, SEED))
    lbfgs_line["parity_fp32"] = lbfgs_parity(
        {"phase4_weights": (fp32[0], fp32[2], fp32[4]),
         "other_weights": (other[0], other[2], other[4])}, smi)
    del other
    t7 = time.perf_counter()
    cli_line = {"card": smi, **cli_end_to_end(smi)}
    lbfgs_line["phase_s"] = {"9a": t6 - t5, "9b": t7 - t6, "9c": time.perf_counter() - t7}
    log(f"[lbfgs phases] " + ", ".join(f"{k} {v:.1f} s" for k, v in lbfgs_line["phase_s"].items()))

    # phase 10: 10a the CaptionService at batch 32, 10b the exported greedy
    # decoder, 10c the int8 gate at a reduced size
    t8 = time.perf_counter()
    serve_model, serve_net, serve_cf, serve_modes = serving(smi, args.profile)
    t9 = time.perf_counter()
    export_line = export_check(serve_model, serve_net, serve_cf, smi, args.profile)
    del serve_model, serve_net
    torch.cuda.empty_cache()
    t10 = time.perf_counter()
    gate_line = gate_check(smi)
    serve_line = {"card": smi, "modes": serve_modes, "export": export_line, "gate": gate_line,
                  "phase_s": {"10a": t9 - t8, "10b": t10 - t9, "10c": time.perf_counter() - t10}}
    log(f"[serving phases] " + ", ".join(f"{k} {v:.1f} s" for k, v in serve_line["phase_s"].items()))

    # phase 11: the multi-device path at the v5e-8 config's widths, two
    # ranks on this card over gloo (11a-11d), then a world of 1 over nccl
    md_line, md_shard = multi_device(smi)

    # phase 12: the baseline_attention and rnn_attention decoders: 12a bf16
    # decodes at batch 1,024 and the step's host and device ms, 12b fp32
    # card vs CPU, 12c training, 12d checkpoint, eval (and the baseline's
    # export)
    t11 = time.perf_counter()
    variant_line, variant_launches = variants(smi, args.profile)
    variant_line["phase_s"] = time.perf_counter() - t11
    log(f"[variant phases] 12 {variant_line['phase_s']:.1f} s")

    # phase 13: the conv-backward experiment, 13a its conv shapes, 13b the
    # step in modes manual and int8 beside 8a's none; 13c the detection
    # stack on the host. None of the eight kernels runs here: their counts are
    # set to 0 just before and read just after
    reset_launch_counts()
    t12 = time.perf_counter()
    qc_line = conv_bwd_quant(smi, train_line["step"]["encoder_on"], (fp32[0], fp32[2]))
    t13 = time.perf_counter()
    det_line = detection(smi)
    det_line["phase_s"] = {"13c": time.perf_counter() - t13}
    phase13_launches = launch_counts()
    if any(phase13_launches.values()):
        raise AssertionError(f"phase 13 launched a kernel: {phase13_launches}")
    log(f"[qc phases] " + ", ".join(f"{k} {v:.1f} s" for k, v in qc_line["phase_s"].items())
        + f", 13c {det_line['phase_s']['13c']:.1f} s; phase 13 {time.perf_counter() - t12:.1f} s")

    # phase 14: the configurations phases 1-13 never set: 14a early exit,
    # 14b beam widths and the length penalty, 14c the int8 encoder under the
    # other variants and with bias correction, 14d the per-conv-shape int8
    # table, 14e remat, batch 512 and SGD training
    _, p14 = phase_14(smi, e2e, e2e_beam, e2e_int8, train_line["step"]["encoder_on"])

    csrc = "adaptive_tpu_torch/ops/cuda/csrc/"
    sources = {
        "adaptive_decode_cell_fused": ("adaptive_tpu/ops/pallas/fused_step.py:221",
                                       csrc + "cell_mma.cuh"),
        "greedy_head_argmax": ("adaptive_tpu/ops/pallas/fused_step.py:354",
                               csrc + "fused_step.cu"),
        "adaptive_decode_cell_fused_beam": ("adaptive_tpu/ops/pallas/fused_step.py:221",
                                            csrc + "cell_mma.cuh"),
        "beam_head_topk": ("adaptive_tpu/ops/pallas/fused_step.py:448", csrc + "head_topk.cu"),
    }
    kernels = []
    # kernel 4 on a vocab shard (phase 11a's route: W = 1 for greedy)
    shard_launches = {tag: v["launches"]["beam_head_topk"]
                      for tag, v in md_line["tp_decode"].items() if isinstance(v, dict)}
    shard = {"shard_ms": md_shard["greedy"]["ms"], "shard_bound_ms": md_shard["greedy"]["bound_ms"],
             "shard_bound_by": md_shard["greedy"]["bound_by"],
             "shard_max_abs_err": max(v["max_abs_err"] for v in md_shard.values()),
             "shard_plain_ms": md_shard["greedy"]["plain_ms"],
             "shard_library_ms": md_shard["greedy"]["library_ms"],
             "shard_launches": shard_launches, "shard_shapes": md_shard}
    for name, (replaces, source) in sources.items():
        bf, fp = checks["bfloat16"][name], checks["float32"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "launches_phase13": phase13_launches[name],
            "launches_phase14": phase14_launches(p14, name),
            "max_abs_err": bf["max_abs_err"], "ms": bf["ms"], "plain_ms": bf["plain_ms"],
            "bound_ms": bf["bound_ms"], "bound_by": bf["bound_by"],
            "library_ms": bf["library_ms"], "dtype": "bfloat16",
            # the heads: each launch after a 256 MB write (L2 cold); the
            # cells: the instance, its plan and each stage alone
            **{k: bf[k] for k in ("cold_ms", "library_cold_ms", "instance", "plan", "stage_ms")
               if k in bf},
            "fp32": {k: fp[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
            **(shard if name == "beam_head_topk" else {}),
            # phase 12a: a decode of each other variant, its counts set to 0
            # just before and read just after
            **({"variant_launches": {v: {p: n.get(name, 0) for p, n in paths.items()}
                                     for v, paths in variant_launches.items()}}
               if name in ("greedy_head_argmax", "beam_head_topk") else {}),
        })
    int8_sources = {
        "bottleneck_identity_int8": ("adaptive_tpu/ops/pallas/fused_block.py:137",
                                     csrc + "fused_block.cu"),
        "tail_conv1_int8": ("adaptive_tpu/ops/pallas/fused_tail.py:91", csrc + "fused_tail.cu"),
    }
    for name, (replaces, source) in int8_sources.items():
        # per decode: the launch-weighted sums over the four layers' shapes
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "launches_phase13": phase13_launches[name],
            "launches_phase14": phase14_launches(p14, name),
            **int8_summary(int8_checks[name]), "library_ms": None,
            "dtype": "int8", "per_layer": int8_checks[name]})
    kernels.append({
        "name": "folded_epilogue", "route": "cuda", "source": csrc + "conv_epilogue.cu",
        "replaces": None,  # no TPU kernel: XLA fused these epilogues into the convs
        "launches": launches["folded_epilogue"],
        "launches_phase13": phase13_launches["folded_epilogue"],
        "launches_phase14": phase14_launches(p14, "folded_epilogue"), **epilogue})
    kernels.append({
        "name": "ssm_step", "route": "cuda", "source": csrc + "ssm_step.cu",
        "replaces": None,  # no TPU kernel: the JAX package has no state-space model
        "launches": launches["ssm_step"], "launches_phase13": phase13_launches["ssm_step"],
        "launches_phase14": phase14_launches(p14, "ssm_step"), **ssm})
    log(json.dumps({"kernels": kernels, "end_to_end_bf16": e2e,
                    f"end_to_end_beam{BEAM}_bf16": e2e_beam,
                    **{f"end_to_end_int8_{t}_bf16": v for t, v in e2e_int8.items()},
                    "end_to_end_granite_h_micro_bf16": e2e_hybrid,
                    "card": smi}))
    log(json.dumps({"eval_driver": eval_line}))
    log(json.dumps({"train": train_line}))
    log(json.dumps({"lbfgs": lbfgs_line}))
    log(json.dumps({"cli": cli_line}))
    log(json.dumps({"serving": serve_line}))
    log(json.dumps({"multi_device": md_line}))
    log(json.dumps({"variants": {"card": smi, **variant_line}}))
    log(json.dumps({"conv_bwd_quant": qc_line}))
    log(json.dumps({"detection": det_line}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
