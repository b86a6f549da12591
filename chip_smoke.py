#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port (``ct_tpu_torch``) on one H100.

    python3 chip_smoke.py [--seed N]

Runs in phases, each printing one JSON line with its wall-clock seconds:

1. env     the card's name and power limit (nvidia-smi), CUDA and nvcc.
2. build   every CUDA source of the port, built with nvcc from csrc/,
           one nvcc each, all started together; ptxas's registers and
           spill bytes of every kernel instantiation, under its name, and
           the spill bytes of each source in all, which must be 0; the
           serving head's bf16 kernel's registers at each width.
3. kernel  each kernel on the card against its plain PyTorch version, f32
           with TF32 off: ``ct_attention_cm`` (eval forward) at the eval
           path's shapes (B=8, C=15), at the transfer width (C=60) and at
           ragged P and K; ``ct_attention_cm_stats`` (training forward)
           and ``ct_attention_cm_bwd_flash`` (flash backward, also against
           torch autograd of the plain forward) at B=8 with C=15 and 60
           and at ragged shapes; ``pool2x2_relu`` forward and backward bit
           for bit against torch autograd on tie-heavy inputs. Each is
           timed at its path's batch (8 for eval, 64 for training): kernel,
           plain, bound and the one PyTorch call that computes the same
           function (``scaled_dot_product_attention`` forward or backward,
           ``relu(max_pool2d)`` and its autograd backward).
           ``ct_attention_serving`` (the fused serving CT head) at B=8 with
           C=15/N=5 and C=60/N=20 and at ragged P and K, two launches bit
           for bit, timed at B=8 beside the unfused head in library calls,
           with both bounds (its θ, score and P·V products run on the
           tensor cores in 3xTF32); ``nms_mask`` (the NMS kernel) with
           keep masks equal to the plain fixpoint loop's on seeded and
           tie-heavy boxes at N=160 rows of K=200, timed beside the loop
           (whose sweeps it counts), by CUDA events around the wrapper's
           calls and, the kernel alone, by torch.profiler.
           ``ct_attention_cm_bwd`` (the
           blockwise backward of CT_ATTENTION_FLASH=0) at B=8 with C=15
           and 60 and at ragged shapes, also through autograd, timed at
           B=64 beside the SDPA backward; the flash and blockwise
           backwards also timed at B=64 and C=60, the transfer width, each
           backward with two bounds (its flops on the FP32 pipes, and
           three times its flops on the tensor cores in TF32, the 3xTF32
           products its dq and dk/dv kernels run) and held to give the
           same bits on a second launch; the row-major ``ct_attention``
           and ``ct_attention_bwd`` at the same shapes, timed at the
           benches' batches (128 forward, 64 backward) at C=60, the
           backward also at C=15;
           ``ct_attention_variant`` (the bfloat16 exponential) at the
           same shapes within half of the bfloat16 rounding's own effect
           and further than that from ``ct_attention``, timed at B=128;
           every forward held to give the same bits on a second launch
           and reported with both bounds (the FP32 pipes' and the tensor
           cores' for its 3xTF32 products, 2xTF32 for the bfloat16
           variant's P·V); one profiled blockwise backward at B=64 and
           C=15 and 60 (and one row-major one at each timed width)
           splits its time into ``bwd_stats_kernel``,
           ``dwz_reduce_kernel``, ``bwd_dq_kernel`` and
           ``bwd_dkdv_kernel``;
           ``bias_relu_bwd`` (mask bit for bit) at [8, 64, 300, 300] and a
           ragged shape, timed at [64, 64, 300, 300] beside
           ``threshold_backward`` and the channel sum, in float32 and (row
           9's bf16 kernel, the type the JAX bench feeds it) in bfloat16.
           bf16 (the forwards of ``csrc/ct_attention_cm.cu`` and the
           serving head of ``csrc/ct_attention_serving.cu``, all on
           ``wgmma`` tiles; the prep of k and v that they and the
           backwards share, ``ct_attention_prep_kv_bf16``, bit for bit
           against its plain version at the train step's shapes, with and
           without v's ones column):
           ``ct_attention_cm_bf16`` (row 1) at B=8 with C=15 and 60 and
           ragged, ``ct_attention_serving_bf16`` (row 6) at B=8 with
           C=15/N=5 and C=60/N=20 and ragged, and at the JAX bench's
           B=128 (C=60/N=20, timed; its first 8 images equal bit for bit
           to the kernel on those 8 alone, which are held to the plain
           version, whose scores would take 11 GB at B=128);
           ``ct_attention_bf16`` and
           ``ct_attention_variant_bf16`` (rows 5 and 10) and
           ``ct_attention_variant_unfused_bf16`` (row 10's unfused
           float32-exponent body, which must differ from the fused
           kernel) on the attention
           bench's inputs: each within one bf16 step of the largest output
           of its plain bf16 version (``bf16_step``), the same bits twice,
           timed beside the bf16 SDPA call (row 6: the unfused head in
           bf16 library calls) with its bounds: the products at the bf16
           tensor-core rate and the B·P·K exponentials on the
           special-function units (16 a clock on each SM, at the card's
           maximum SM clock from nvidia-smi).
           bf16 training: ``ct_attention_cm_stats_bf16`` and
           ``ct_attention_cm_bwd_flash_bf16`` (rows 2 and 3),
           ``ct_attention_cm_bwd_bf16`` (row 4, also through autograd,
           the same bits), ``ct_attention_bwd_bf16`` (row 5's backward, on
           the bwd bench's inputs) and ``pool2x2_relu`` on bf16 (row 7, bit
           for bit), at B=8 with C=15 and 60 and ragged, timed at the train
           step's batch (the bench's for row 5, at both widths) beside the
           bf16 SDPA forward and backward and ``relu(max_pool2d)``, with
           their bounds and the backwards split by kernel; each output within
           BF16_SUM_MEAN_TOL in the mean and one bf16 step (the forward's
           out and delta) or BF16_SUM_MAX_TOL (the backward's sums) in the
           max.
4. model   the phase-2 incre split-1 RFBNet300 with ``ref_model.pth`` on
           the card: 1 warm-up and 3 timed eval steps on 8 seeded images
           (images/s from the median step), the kernels' launch counts
           over those steps, one profiled step (with the device time of
           the port's kernels in it), and the same model on the CPU on one
           image, whose detections must match.
   serving the same model on the int8 serving path (``test.py --int8``):
           BN folded, calibrated on 8 seeded images, quantized with
           ``SKIP_DEFAULT`` and int8 chained across the trunk's pools; 1
           warm-up and 3 timed eval steps at batch 8 (images/s, peak
           memory), the launch counts of the serving head and NMS kernels,
           one profiled step, the same quantized model (same scales) on
           the CPU on one image, whose detections must match, and the
           calibration on the card against the CPU's from two images.
   bf16    ``test.py --bf16`` on the card: the bf16 model's eval step
           and the JAX bench's full serving config (``--int8 --int8-heads
           --bf16``, approximate top-k 128 in a pool of 512) at batch 8, 1
           warm-up and 3 timed steps each (images/s, the launches of the
           bf16 kernels and NMS, a profiled step), each against the same
           model (the same scales) on the CPU on the same 8 images: at
           least 95% of the detections matched at IoU 0.98, scores within
           2^-8 (BF16_MATCH_SHARE says why); then
           the eval CLI on the 500 fixture images with ``--bf16`` (a
           reading beside f32's) and with the full config, whose mAP and
           novel mAP must lie within 0.003 of the JAX package's own CPU
           run of that command and its mAP within 0.003 of the JAX
           package's TPU record (0.73870; the record's novel mAP, 0.61636,
           is a reading), with its detections against both
           (``tools/diff_detections``).
5. train   the same model in train mode on the card: ``init_reweight``
           over 2 batches, then 1 warm-up and 3 timed steps of
           ``make_train_step`` at batch 64 with the CLI's solver defaults
           on seeded images and targets (images/s from the median step,
           finite losses, peak memory), the launch counts of the four
           training kernels over those steps, one profiled step, and one
           loss-and-gradients call at batch 2 on the card and on the CPU
           from the same state, whose losses and gradients must agree.
           Then CT_ATTENTION_FLASH=0 (``ct_flash=False``): one
           loss-and-gradients call with each backward from the same
           state and batch, which must agree, and 1 warm-up and 3 timed
           steps with the blockwise backward and its launch counts.
6. transfer phase-2 transfer (C=60) from seeded weights: 1 warm-up and 3
           timed steps at batch 64 with each backward (images/s, peak
           memory, launches, finite losses).
7. train_bf16 ``train.py --bf16`` on the card: the same model in bf16
           (float32 parameters, bf16 convs, BN outputs, CT projections and
           the bf16 kernels of rows 2, 3, 4 and 7), ``init_reweight`` over
           2 batches, 1 warm-up and 3 timed steps at batch 64 with the flash
           backward (images/s, the bf16 kernels' launches and none of the
           f32 ones, a profile), card vs CPU at batch 2 by the bf16 effect
           (BF16_F32_SPAN, BF16_CARD_CPU_SPAN, with a reading of the plain
           bf16 CT versions on the card), blockwise vs flash by the bf16
           effect and 1 + 3 blockwise steps; then transfer (C=60) from
           seeded weights in bf16, flash and blockwise.
8. train_cli phase-2 training through the train CLI on the VOC fixture
           (``.parity_p2/voc``, real JPEGs), as ``train.py`` trains: first
           the device augmentation and mixup on the card against the same
           apply functions on the CPU with the same parameters, at batch
           64 (384² canvases → 300), with their ms per batch; then
           ``python -m ct_tpu_torch.train`` in process from
           ``ref_model.pth``: incre, split 1, 5 shots, --device-augment
           --mixup, batch 64, 2 OBJ_Target init batches, 26 iterations
           (mixup off for the last 6), with the launches of the training
           kernels; finite losses and ``metrics.json`` rows at the write
           points after iterations 20 and 25 (iteration time and loader
           wait: the rows' medians); then the eval CLI scores
           ``model_final.pth`` on the 500 test images (mAP above 0.5, a
           sanity floor, with the eval kernels' launches); then
           ``scripts/bench_pipeline.py``'s three rates at a few
           iterations; then the augmentation with bf16 images on the card
           against the CPU and the train CLI with ``--bf16
           --device-augment --mixup`` for 8 iterations (the bf16 kernels'
           launches, finite losses, a metrics row). The CLIs' output goes to
           build/chip_smoke/train_cli_*.txt and bench_pipeline.txt.
9. bench   the port's kernel benches (``ct_tpu_torch/scripts``): the
           attention forward bench at B=128 on bf16 inputs (as the JAX
           bench's) and on the same values in float32, the backward bench
           at 300 (B=64) and 512 (B=16), each on bf16 inputs (as the JAX
           bench's) and in float32, the bias+ReLU backward bench on bf16
           (as the JAX bench's) and in float32, few
           iterations each, with the launches of their kernels; their
           lines go to build/chip_smoke/bench_*.txt.
10. coco   COCO data and the host native layer: the COCO-60 fixture
           (1,800 train and 128 minival images, seed 0) built with
           ``tools/coco_fixture.py`` into a fresh build/chip_smoke/coco;
           the port's COCO evaluator on the JAX package's tracked
           detections of that minival (.parity_tr/ours_eval_coco), every
           number of its record within 1e-12; then phase-1 COCO-60
           pretraining through the train CLI (``-d COCO -p 1 --setting
           transfer``, batch 64, from the seeded init): 20 iterations in
           f32 with the host augmentation in 6 worker processes
           (``--worker-type process``), and 8 in bf16 with
           ``--device-augment``, each with conv1's pool kernels launched
           once an iteration (and no other training kernel), finite losses,
           a metrics row, images/s and the loader's wait; then the eval CLI
           with ``-d COCO`` on the f32 model over the minival (the NMS
           kernel launched, AP and AP50 in [0, 1] or -1: a smoke of the
           path, the model is not trained); then ``ref_model.pth`` on the
           500 VOC images with the card's NMS and with ``--host-nms``
           (the native C++ NMS on the host, the NMS kernel not launched):
           mAP and novel mAP within 0.003 of the JAX package's record
           (0.74351 / 0.61613, beside the reference stack's 0.74418 /
           0.61773), its detections against the card's by the JAX
           package's band (match rate > 0.95 at IoU 0.75, p99 box error 0
           px). The CLIs' output goes to build/chip_smoke/coco_*.txt and
           voc500_*_nms.txt.
11. size512 RFBNet512 (P=32,756, K=4,964) as bench.py's 512 configs run
           it, each part with its seconds: rows 1, 2, 3 and 6 in f32 and
           bf16 against their plain versions at B=2, C=15 and 60 (the
           ragged last key tile: 4,964 = 77·64 + 36), under the kernel
           phase's bands and timed there, row 7 bit for bit at
           [16, 64, 512, 512] (f32 and bf16); one 512 image of the
           phase-2 incre model on seeded weights on the card and the CPU
           (the model phase's bands); accumulation on the card (accum 2 of
           a duplicated batch against accum 1, the fused optimizer against
           the per-leaf one over 3 updates, JAX's bands); phase-2 transfer
           at batch 64 in 4 micro-batches (``--accum-steps 4``), flash, in
           f32 and bf16 (1 + 3 steps, images/s, peak memory, 4 launches a
           step of rows 2, 3 and 7's two, a profiled step); serving at
           batch 32 in bf16 with top-k 128 in a pool of 512, then the
           int8 full config (images/s, launches, NMS candidates within
           the kernel's cap); the train CLI at ``-s 512 --accum-steps 4
           --fused-opt on --device-augment --canvas 640 --bf16`` for 8
           iterations on the VOC fixture and the eval CLI at ``-s 512``
           on its checkpoint over 64 test images (a smoke). Their output
           goes to build/chip_smoke/train_cli_512*.txt and the profiles
           to profile_{train,serve}512_*.txt.
12. dp      data parallel on the one card, about a minute: (a) the
           phase-2 incre RFBNet300 from ``ref_model.pth``, flash, in f32
           and in bf16: one train step of two gloo ranks sharing the card
           (``parallel/card_check.py``, started by ``parallel.distributed.
           launch``; batch 32, 16 a rank, the gradients, loss sums and N
           summed in one all-reduce) against one process's accum-2 step on
           the same 32 images and the anchors it mined (handed to the
           ranks through ``mask``), cuDNN deterministic: losses to rtol
           1e-6, each gradient, updated parameter and BatchNorm statistic
           within 1e-5 of its norm (the statistics against the mean of the
           two micro-batches' updates from the same start), whether they
           agree bit for bit, both ranks' state bit for bit, one launch a
           step of rows 2, 3 and 7's two kernels on each rank; the ranks'
           step time beside one process's and the all-reduce's; (b) the
           two ranks' eval of 32 fixture images (16 a rank) against one
           process's at batch 16: the same detections (scores rtol 1e-4,
           boxes rtol 1e-3 / 0.5 px, JAX's mesh bands), rows 1 and 8
           launched; (c) the train CLI under a launcher's environment at
           NCCL world size 1 with ``--ndev 1 --orbax`` (phase 1 on the VOC
           fixture, 3 iterations, then ``--resume`` to 5), and the eval
           CLI on its asynchronous checkpoint over 32 test images; (d)
           ``--ndev 2`` on the one card raises, naming both counts. The
           CLIs' output goes to build/chip_smoke/train_cli_dp_*.txt.
13. real_parity the transfer chain of ``ct_tpu_torch/scripts/
           real_parity.py``: ``build3``'s trees at full size (1,800 COCO-60
           and 2×600 VOC images, 128 test images) into
           build/chip_smoke/real_parity; the VOC half's XML and lists byte
           for byte against ``.parity_p2/voc`` (``test.txt`` its first 128
           lines), its JPEGs byte for byte or, decoded, within 8 levels;
           the VOC evaluator on JAX's transfer detections
           (``.parity_tr/ours_eval``) to every number of its record
           within 1e-12; then the chain at full width in bf16, batch 64:
           phase 1 (COCO-60) for 30 iterations, its COCO eval, phase 2
           (transfer, 5-shot, ``--init-iter 5 --no-mixup-iter 5``) for 20,
           its VOC eval, each with its losses, images/s and its kernels'
           launches a step (rows 7 bf16 in phase 1; 2, 3 and 7 bf16 in
           phase 2; 1 and 8 in the evals), none of the f32 training
           kernels; and ``eval-ours`` + ``diff`` on ``ref_model.pth``,
           which must PASS against ``.parity_p2/ref_eval.json``. The
           output goes to build/chip_smoke/real_parity_*.txt.
14. kernels one line listing every kernel of the port with its launches
           on its path's phase, error and times (rows 1, 2, 3, 6, 7 and 8
           also at 512).

Any failure raises and exits non-zero with no "ok" line. The last line is
{"ok": true, "device": {...}}. Without a CUDA device, or outside the
repository, it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time

REF_MODEL = os.path.join(".parity_p2", "ref_model.pth")
# the profiler's tables of one eval step and one train step
PROFILE_DIR = os.path.join("build", "chip_smoke")

# H100 SXM peaks (NVIDIA data sheet, 700 W): f32 outside the tensor cores,
# TF32 on the tensor cores (dense) and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# exponentials (ex2) on the special-function units: 16 a clock on each SM
# of compute capability 9.0 (CUDA programming guide, arithmetic
# instructions); the SM count and the maximum SM clock are read from the
# card in the env phase
SFU_PER_CLOCK_SM = 16
CARD = {"sms": 132, "clock_hz": 1.98e9}

KERNEL_TOL = 1e-4      # max |kernel - plain|, f32, K up to 1858 terms
# the serving head: max |kernel - plain| over the largest score (the same
# f32 formula, its sums over K and C in another order)
SERVING_TOL = 1e-4
# flash backward: max |kernel - plain| over max |plain|, per output; each
# entry sums up to 11,620 anchors (dk, dv) or 1,858 keys (dq)
BWD_TOL = 1e-4
MATCH_IOU = 0.999      # card vs CPU detections, per box
MATCH_SCORE = 1e-4
# bf16: card vs CPU, the 8 images of the eval batch: at least 95% of the
# detections matched at IoU 0.98 with scores within one bf16 step of the
# largest (2^-8 below 1). cuDNN's and the CPU's bf16 convolutions sum in
# other orders, and through the trunk a bf16 rounding that goes the other
# way reaches most loc outputs: one bf16 step of a regression of 1 to 2
# moves a box by 0.08% of its size in x and y and 0.16% in w and h, an IoU
# of about 0.997, so the f32 phases' IoU 0.999 holds almost no bf16 box;
# and a score that rounds the other way can swap two near-equal
# candidates in NMS or at the score threshold (measured on an H100: of
# 1,099 detections 2.4% matched at IoU 0.999, 95.7% at 0.99, 96.4% at 0.98
# and at 0.95, every matched score within 0.0039). The shares at 0.999,
# 0.99 and 0.95 are recorded beside it.
BF16_MATCH_SHARE = 0.95
# the bf16 training kernels against their plain versions. The kernel's f32
# scores (and sums) run in another order, so a weight or a ds that lies at
# a bf16 rounding boundary rounds the other way and moves one term of a sum
# by a bf16 step of itself: where the softmax is peaked (C=60, unit
# inputs) one term can be as large as the sum, and such a flip moves an
# entry by up to 2e-3 of the largest (PERF.md §2), but the flips are few,
# so the mean moves by a few 1e-6 of the mean |entry|; a wrong rounding
# point (g·wz, ds or attn rounded where JAX does not, or not where it
# does) moves every entry, the mean by 1.4e-3 to 5e-3 of the mean |entry|
# (tests/test_torch_bf16_train.py,
# test_bf16_bands_separate_flips_from_wrong_rounding: 3.5e-6 against
# 1.4e-3 at the least, K=1,858, C=60). So each output is held in the mean to BF16_SUM_MEAN_TOL of its mean
# |entry|, and in the max to one bf16 step of its largest entry (the
# forward's bf16 out and delta, sums of weights at most 1 over z ≥ 1) or
# BF16_SUM_MAX_TOL of it (the sums over keys or anchors: dq, bf16 or row
# 5's float32, whose rounding to bf16 is at most 2^-7 of it, and the f32
# sums dk and dv before their cast and dwz; dq's flips reached 4.2e-3 of
# its largest entry on the card at C=60).
BF16_SUM_MEAN_TOL = 1e-4
BF16_SUM_MAX_TOL = 1e-2
# bf16 training, the blockwise backward against the flash one on the card:
# the band of the bf16 eval checks, half of what bf16 moves the result
# (tests/test_torch_bf16.py), here of the
# gradient taken as one vector (the update the optimizer applies), from the
# same state on the same anchors, whole and the CT head's alone; each
# tensor within its own bf16 effect or 1% of the whole vector's (the
# gradients that vanish in exact arithmetic, φ's bias and the biases of BNs
# that feed BNs, are rounding noise on both sides, as in f32). Measured at
# size 64 on the CPU (tests/test_torch_bf16_train.py): the port against
# JAX 0.25 of the effect for the whole vector and 0.6 of a tensor's band
# at the most; on the card flash against blockwise 0.16 for the CT
# head's vector.
BF16_EFFECT_SHARE = 0.5
BF16_TENSOR_SHARE = 1.0
BF16_TENSOR_FLOOR = 1e-2
# bf16 training, the card against the CPU at 300 (batch 2): two bf16
# computations whose convolutions sum in other orders part, through the
# trunk, by nearly the whole bf16 effect at full width (the bf16 eval
# found most loc outputs a bf16 step apart; measured here 0.94 of the effect
# for the gradient vector, and the same with the plain CT versions on the
# card, a reading beside it). So the card is held to what bf16 alone
# allows: its bf16 gradient within BF16_F32_SPAN of the f32 one's distance
# to the CPU's bf16 one (measured 1.01: as far from f32 as the CPU's bf16
# result, and not f32), and within twice the effect of the CPU's bf16 one
# (two results each within the effect of the f32 one); the same for the
# CT head's vector; each loss within twice its effect or TRAIN_LOSS_RTOL.
BF16_F32_SPAN = (0.5, 1.5)
BF16_CARD_CPU_SPAN = 2.0
# the bf16 training forward's m (the row max of f32 scores) relative to the
# largest, and z, the sum of the bf16-rounded weights (each at most 1): a
# weight that rounds the other way moves z by one bf16 step of itself,
# at most 2^-8; 2^-5 holds eight such
BF16_M_TOL = 1e-5
BF16_Z_TOL = 2.0 ** -5
BF16_MATCH_IOU = 0.98
BF16_MATCH_SCORE = 2.0 ** -8
# the JAX package's records of its bench's full serving config on the 500
# images: its TPU run (.parity_p2/ours_eval_int8h_bf16_approx_pool.json,
# docs/PARITY.md) and its own run of the same command on the CPU
# (ours_eval_int8h_bf16_approx_pool_cpu.json, made with test.py as
# tests/test_torch_eval.py records). The card is held to the CPU record
# in mAP and novel mAP and to the TPU record in mAP; the TPU record's
# novel mAP is a reading (PERF.md §6: the TPU's arithmetic moves
# it by more than the band, as it moved the int8 eval's, ROADMAP Queue 3
# item 3)
BF16_FULL_FLAGS = ["--int8", "--int8-heads", "--calib-images", "8", "--bf16",
                   "--approx-topk", "on", "--top-k", "128", "--pool-size",
                   "512"]
BF16_FULL_REF = ("ours_eval_int8h_bf16_approx_pool", 0.73870, 0.61636)
BF16_FULL_CPU_REF = "ours_eval_int8h_bf16_approx_pool_cpu"
MAP_TOL = 0.003
# card vs CPU calibration: each conv's input absmax, relative, after a
# float forward through up to ~30 convs summed in another order
CALIB_TOL = 1e-4
# the int8 scales a quantized conv holds as buffers
QUANT_BUFFERS = ("act_scale", "kernel_int8", "kernel_scale", "out_scale")
# card vs CPU, one train loss-and-gradients call at batch 2: the losses to
# rtol 1e-4; each gradient tensor, over the anchors the CPU mined, taken as
# the vector the optimizer applies, to ‖Δ‖₂ ≤ 1e-2 · ‖CPU gradient‖₂. At
# batch 2 in train mode a discrete choice made on near-equal f32 values
# (the max-pool of the CT keys, a ReLU, BatchNorm over as few as 2·10·10
# values per channel) can go the other way on the card: in the RFB blocks
# such runs measured up to 2.4e-3 norm-relative error (extras.1, with cuDNN
# on or off, from one run to the next) where the rest stayed below 5e-4,
# and 1.4e-2 of a tensor's largest entry, which is why the norm and not the
# largest entry is held. A gradient that vanishes in exact arithmetic (φ's
# bias, the bias of a BN that feeds another train-mode BN) is rounding
# noise on both sides, so the norm is floored at 1e-2.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_TOL = 1e-2
TRAIN_GRAD_FLOOR = 1e-2
TRAIN_BATCH, TRAIN_STEPS = 64, 3
# the blockwise train step against the flash one, same state and batch on
# the card: the losses (the same forward kernel) to rtol 1e-5; the CT
# head's gradients, which the two backward kernels compute in other f32
# orders, to ‖Δ‖₂ ≤ 1e-4·‖g‖₂; the rest, behind cuDNN's backward, at the
# card-vs-CPU band above
BLOCKWISE_LOSS_RTOL = 1e-5
BLOCKWISE_CT_GRAD_TOL = 1e-4
CT_PARAMS = ("theta.", "phi.", "g.", "Wz", "OBJ_Target.")
# the bias+ReLU backward's dbias: |Δ| ≤ 1e-5 of the channel's Σ|masked|
# (f32 sums over up to 5.8 million values in another order)
DBIAS_TOL = 1e-5
# the attention benches' batches: the forward bench's and the backward's
BENCH_FWD_BATCH, BENCH_BWD_BATCH = 128, 64
# the device augmentation on the card against the CPU from the same
# parameters: the bands the CPU tests hold it to against JAX (images on
# the 0-255 scale, after a resample whose f32 sums run in another order;
# boxes; mixup relative to 255)
AUGMENT_IMG_TOL = 2e-3
# with bf16 images: the share of pixels that may round a step the other
# way (an f32 difference of 2e-3 against bf16 steps of 1/8 to 1 on the
# 0-255 scale: about 2e-3/0.25 of them at most)
AUGMENT_BF16_SHARE = 1e-2
AUGMENT_BOX_TOL = 1e-6
MIXUP_TOL = 1e-6
VOC_ROOT = os.path.join(".parity_p2", "voc", "VOCdevkit")
# the train CLI phase: 26 iterations from ref_model.pth, then its 500-image
# eval must score above this (a sanity floor, not a parity gate)
TRAIN_CLI_ITERS = 26
TRAIN_CLI_MAP_FLOOR = 0.5
# the bf16 train CLI run: its first write point comes after 5 iterations,
# then at the last
TRAIN_CLI_BF16_ITERS = 8
# the coco phase: the COCO-60 fixture at the size of the JAX package's
# tracked record (1,800 train and 128 minival images, seed 0), built into
# a fresh directory; that record's detections and scores, which the port's
# evaluator must reproduce to COCO_EVAL_TOL; phase-1 COCO-60 training for
# COCO_TRAIN_ITERS iterations (f32, host augmentation in COCO_WORKERS
# processes) and COCO_BF16_ITERS (bf16, device augmentation), each with one
# metrics row at its last iteration
COCO_DIR = os.path.join("build", "chip_smoke", "coco")
COCO_FIXTURE = (1800, 128, 0)
COCO_RECORD = os.path.join(".parity_tr", "ours_eval_coco")
COCO_EVAL_TOL = 1e-12
COCO_TRAIN_ITERS = 20
COCO_BF16_ITERS = 8
COCO_WORKERS = 6
# --host-nms on the 500 VOC images: the JAX package's f32 record
# (.parity_p2/ours_eval.json) within MAP_TOL, the reference stack's
# (docs/PARITY.md) as a reading, and against the card's NMS the JAX
# package's own band (tests/test_cli_e2e.py): the card path ranks the top
# candidates of each class before NMS, the host every score above 0.01
HOST_NMS_REF = (0.74351, 0.61613)
HOST_NMS_REFERENCE_STACK = (0.74418, 0.61773)
HOST_NMS_IOU = 0.75
HOST_NMS_MATCH = 0.95


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms, from CUDA events around
    ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_env() -> dict:
    import torch

    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    clock = run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                 "--format=csv,noheader,nounits"]).splitlines()[0]
    CARD["clock_hz"] = float(clock) * 1e6
    CARD["sms"] = torch.cuda.get_device_properties(0).multi_processor_count
    from ct_tpu_torch.kernels import nvcc
    nvcc_ver = run([nvcc(), "--version"]).splitlines()[-1]
    return {"nvidia_smi": smi, "clocks_max_sm_mhz": float(clock),
            "sms": CARD["sms"], "torch": torch.__version__,
            "torch_cuda": torch.version.cuda, "nvcc": nvcc_ver,
            "device": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> dict:
    from ct_tpu_torch import kernels

    out = {}
    for name, res in kernels.build_all().items():
        # each kernel's (mangled) name, then its registers and spill bytes
        ptxas = [ln.strip() for ln in res["log"].splitlines()
                 if "Function properties for" in ln or "registers" in ln
                 or "spill" in ln]
        spills = re.findall(r"(\d+) bytes spill (?:stores|loads)",
                            res["log"])
        out[name] = {"seconds": res["seconds"], "built": res["built"],
                     "spill_bytes": sum(map(int, spills)), "ptxas": ptxas}
    spilled = {name: r["spill_bytes"] for name, r in out.items()
               if r["spill_bytes"]}
    if spilled:
        raise AssertionError(f"kernels spill registers: {spilled}")
    serving = out["ct_attention_serving"]
    if serving["built"]:   # a library reused from an earlier build has no log
        name = "ct_attention_serving_bf16_kernel"
        out["registers"] = {name: kernel_registers(serving["ptxas"], name)}
    return out


def kernel_registers(ptxas, kernel: str) -> dict:
    """ptxas's registers of each instantiation ``kernel<CP>`` in a
    source's build lines: {"CP": registers}."""
    out, cp = {}, None
    for ln in ptxas:
        m = re.search(r"Function properties for \S*?" + kernel
                      + r"ILi(\d+)E", ln)
        if "Function properties for" in ln:
            cp = m.group(1) if m else None
        m = re.search(r"Used (\d+) registers", ln)
        if m and cp is not None:
            out[cp] = int(m.group(1))
            cp = None
    if not out:
        raise AssertionError(f"no registers of {kernel} in the build log")
    return out


def attention_case(rng, b, c, p, kk, time_it: bool) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ct_tpu_torch.ops.ct_attention import (
        ct_attention_cm, ct_attention_reference_cm,
    )

    dev = torch.device("cuda")
    q = torch.from_numpy(rng.standard_normal((b, c, p), np.float32)).to(dev)
    k = torch.from_numpy(rng.standard_normal((b, kk, c), np.float32)).to(dev)
    v = torch.from_numpy(rng.standard_normal((b, kk, c), np.float32)).to(dev)
    base = torch.from_numpy(
        rng.standard_normal((b, c, p), np.float32)).to(dev)
    wz = torch.from_numpy(
        rng.standard_normal((c,), np.float32) * 0.1).to(dev)

    with torch.inference_mode():
        out = ct_attention_cm(q, k, v, base, wz)
        ref = ct_attention_reference_cm(q, k, v, base, wz)
        deterministic = same_bits(lambda: (ct_attention_cm(q, k, v, base,
                                                           wz),))
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        res = {"B": b, "C": c, "P": p, "K": kk, "max_abs_err": err,
               "tol": KERNEL_TOL, "deterministic": deterministic}
        if not (err <= KERNEL_TOL and deterministic):
            raise AssertionError(f"ct_attention_cm disagrees with its plain "
                                 f"version: {res}")
        if not time_it:
            return res
        # yardstick: one library call of the same attention on the
        # row-major layout ([B, 1, P, C] queries), scores unscaled
        q_rm = q.transpose(1, 2).contiguous()[:, None]
        k4, v4 = k[:, None], v[:, None]
        lib = F.scaled_dot_product_attention(q_rm, k4, v4, scale=1.0)
        lib_out = base + lib[:, 0].transpose(1, 2) * wz[None, :, None]
        res.update(
            ms=cuda_ms(lambda: ct_attention_cm(q, k, v, base, wz), 20),
            plain_ms=cuda_ms(
                lambda: ct_attention_reference_cm(q, k, v, base, wz), 5),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                q_rm, k4, v4, scale=1.0), 20),
            library_max_abs_err=(lib_out - ref).abs().max().item(),
            **tc_bound(4 * b * p * kk * c,
                       4 * (3 * b * c * p + 2 * b * kk * c + c),
                       exps=b * p * kk))
    return res


def serving_case(rng, b, c, p, kk, n, time_it: bool) -> dict:
    """``ct_attention_serving`` against its plain version: max |Δ| over the
    largest score."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ct_tpu_torch.ops.ct_attention import (
        ct_attention_serving, ct_attention_serving_reference,
    )

    dev = torch.device("cuda")
    t = lambda *shape, scale=1.0: torch.from_numpy(
        rng.standard_normal(shape, np.float32) * scale).to(dev)
    conf, k, v = t(b, c, p, scale=3.0), t(b, kk, c, scale=0.3), t(b, kk, c)
    wt, bt, wz = t(c, c, scale=0.2), t(c, scale=0.1), t(c, scale=0.3)
    obj = t(n, c)
    args = (conf, k, v, wt, bt, wz, obj)
    with torch.inference_mode():
        out = ct_attention_serving(*args)
        ref = ct_attention_serving_reference(*args)
        deterministic = same_bits(lambda: (ct_attention_serving(*args),))
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        res = {"B": b, "C": c, "P": p, "K": kk, "N": n, "max_abs_err": err,
               "rel_err": err / ref.abs().max().item(),
               "tol": SERVING_TOL, "deterministic": deterministic}
        if not (res["rel_err"] <= SERVING_TOL and deterministic):
            raise AssertionError(f"ct_attention_serving disagrees with its "
                                 f"plain version: {res}")
        if not time_it:
            return res
        del ref

        def library():
            # the unfused head in library calls on the row-major layout:
            # θ by matmul, the attention by scaled_dot_product_attention
            # (unscaled scores), normalisation, the classifier by matmul
            x = conf.transpose(1, 2)                       # [B, P, C]
            q = torch.matmul(x, wt) + bt + x
            a = F.scaled_dot_product_attention(q[:, None], k[:, None],
                                               v[:, None], scale=1.0)[:, 0]
            nv = x + a * wz
            nv = nv * torch.rsqrt((nv * nv).sum(-1, keepdim=True))
            return torch.matmul(nv, obj.t()) * 5.0

        res.update(
            ms=cuda_ms(lambda: ct_attention_serving(*args), 20),
            plain_ms=cuda_ms(lambda: ct_attention_serving_reference(*args),
                             5),
            library_ms=cuda_ms(library, 20),
            library_max_abs_err=(library().transpose(1, 2) - out)
            .abs().max().item(),
            # θ, the scores and P·V: three products, each three TF32 ones
            # on the tensor cores; the classifier's 2·B·P·C·N flops, which
            # run on the FP32 pipes, are counted with them (1% at C=60,
            # N=20)
            **tc_bound(2 * b * p * c * (2 * kk + c + n),
                       4 * (b * c * p + b * n * p + 2 * b * kk * c + c * c
                            + 3 * c + n * c), exps=b * p * kk))
    return res


def nms_boxes(rng, n, k, ties: bool):
    """n rows of k score-sorted candidate boxes in pixels, as NMS sees them:
    jittered copies of a few objects per row (long suppression chains),
    with integer corners (tied IoUs) if ``ties``; 90% valid."""
    import numpy as np
    import torch

    objs = rng.uniform(0, 400, (n, 6, 2))
    size = rng.uniform(30, 200, (n, 6, 2))
    pick = rng.integers(0, 6, (n, k))
    rows = np.arange(n)[:, None]
    lo = objs[rows, pick] + rng.normal(0, 8, (n, k, 2))
    hi = lo + size[rows, pick] * rng.uniform(0.8, 1.2, (n, k, 2))
    boxes = np.concatenate([lo, hi], -1)
    if ties:
        boxes = np.round(boxes)
    valid = rng.uniform(size=(n, k)) < 0.9
    return (torch.from_numpy(boxes.astype(np.float32)).cuda(),
            torch.from_numpy(valid).cuda())


def nms_case(rng, n, k, ties: bool, time_it: bool) -> dict:
    """``nms_mask``'s keep mask against the plain fixpoint loop's, bit for
    bit, on the card and on the CPU."""
    import torch

    from ct_tpu_torch.ops.nms import nms_mask, nms_mask_reference

    boxes, valid = nms_boxes(rng, n, k, ties)
    keep = nms_mask(boxes, valid, 0.45, 1.0)
    plain = nms_mask_reference(boxes, valid, 0.45, 1.0)
    torch.cuda.synchronize()
    res = {"N": n, "K": k, "ties": ties,
           "equal": bool(torch.equal(keep, plain)),
           "equal_cpu": bool(torch.equal(keep.cpu(), nms_mask_reference(
               boxes.cpu(), valid.cpu(), 0.45, 1.0))),
           "kept": int(keep.sum().item()), "valid": int(valid.sum().item()),
           "sweeps": nms_mask_reference.sweeps,
           "max_abs_err": float((keep != plain).sum().item())}
    if not (res["equal"] and res["equal_cpu"]):
        raise AssertionError(f"nms_mask differs from the plain loop: {res}")
    if time_it:
        # K(K-1)/2 IoUs per row of ~20 flops; boxes and valid read once,
        # keep written once
        res.update(ms=cuda_ms(lambda: nms_mask(boxes, valid, 0.45, 1.0), 50),
                   device_ms=profiled_ms(
                       lambda: nms_mask(boxes, valid, 0.45, 1.0),
                       "nms_kernel", 50),
                   plain_ms=cuda_ms(lambda: nms_mask_reference(
                       boxes, valid, 0.45, 1.0), 10),
                   library_ms=None,
                   **bound(20 * n * k * (k - 1) / 2, n * k * (16 + 1 + 1)))
    return res


def profiled_ms(fn, name: str, iters: int) -> float:
    """Mean device time in ms of the kernel ``name`` over ``iters`` calls
    of ``fn()`` under torch.profiler: the kernel alone, without the host
    work of its wrapper that CUDA events around back-to-back calls also
    see when the kernel is shorter than it."""
    hits = [e for e in profiled_events(fn, iters) if name in e.key]
    count = sum(e.count for e in hits)
    if count != iters:
        raise AssertionError(f"the profiler saw {count} launches of {name} "
                             f"in {iters} calls")
    return sum(e.device_time_total for e in hits) / 1e3 / count


def exp_ms(exps: float) -> float:
    """The least time of ``exps`` exponentials on the special-function
    units of the card (SFU_PER_CLOCK_SM a clock on each SM)."""
    return exps / (SFU_PER_CLOCK_SM * CARD["sms"] * CARD["clock_hz"]) * 1e3


def bound(flops: float, nbytes: float, exps: float = 0) -> dict:
    """The least time the card could take: the larger of the operations
    (the flops over the f32 peak, and the ``exps`` exponentials over the
    special-function units' rate) and the bytes over the memory rate."""
    ops_ms = max(flops / PEAK_F32_FLOPS * 1e3, exp_ms(exps))
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def tc_bound(flops: float, nbytes: float, tc_factor: float = 3,
             exps: float = 0) -> dict:
    """The bounds of a kernel whose products run on the tensor cores in
    3xTF32: on the FP32 pipes (``flops`` over the f32 peak) and on the
    tensor cores (``tc_factor`` × ``flops``, 3 for three TF32 products
    each, over the TF32 peak), each against the bytes over the memory
    rate and the ``exps`` exponentials over the special-function units'.
    ``bound_ms`` is the lesser, ``bound_pipe`` names it."""
    fp32 = bound(flops, nbytes, exps)
    ops_ms = max(tc_factor * flops / PEAK_TF32_FLOPS * 1e3, exp_ms(exps))
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    tc_ms = max(ops_ms, bytes_ms)
    if tc_ms <= fp32["bound_ms"]:
        best = {"bound_ms": tc_ms, "bound_pipe": "3xTF32 tensor cores",
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
    else:
        best = {**fp32, "bound_pipe": "FP32"}
    return {**best, "bound_fp32_ms": fp32["bound_ms"], "bound_tc_ms": tc_ms,
            "bound_exp_ms": exp_ms(exps)}


def bf16_bound(flops: float, exps: float, nbytes: float) -> dict:
    """The bounds of a bf16 kernel: its products on the tensor cores at
    the bf16 peak (one product a tile), its exponentials on the
    special-function units, its bytes over the memory rate; ``bound_ms``
    the largest, ``bound_pipe`` naming which of the first two is the
    larger."""
    tc_ms = flops / PEAK_BF16_FLOPS * 1e3
    ex_ms = exp_ms(exps)
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    ops_ms = max(tc_ms, ex_ms)
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_pipe": ("exponentials (SFU)" if ex_ms >= tc_ms
                           else "bf16 tensor cores"),
            "bound_tc_ms": tc_ms, "bound_exp_ms": ex_ms,
            "bound_bytes_ms": bytes_ms}


def same_bits(run) -> bool:
    """Whether two calls of ``run()`` give the same tensors bit for bit."""
    import torch

    first, second = run(), run()
    return all(torch.equal(a, b) for a, b in zip(first, second))


def device_normal(rng, shape, scale: float = 1.0):
    """Seeded normal float32 values made on the card by a generator seeded
    from ``rng``: large inputs cost no host time."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    return torch.randn(tuple(shape), generator=gen, device=dev) * scale


def grads_rel_err(grads, plain) -> dict:
    """max |kernel - plain| over max |plain|, per gradient."""
    return {name: (a - r).abs().max().item() / r.abs().max().item()
            for name, a, r in zip(("dq", "dk", "dv", "dwz"), grads, plain)}


def sdpa_backward_ms(q_rm, k, v, g_rm, iters: int) -> float:
    """The yardstick of a backward: one library call, the autograd
    backward of ``scaled_dot_product_attention`` on [B, 1, P, C] queries
    with unscaled scores."""
    import torch
    import torch.nn.functional as F

    q4, k4, v4 = (x[:, None].contiguous().detach().requires_grad_()
                  for x in (q_rm, k, v))
    out = F.scaled_dot_product_attention(q4, k4, v4, scale=1.0)
    g4 = g_rm[:, None].contiguous()
    return cuda_ms(lambda: torch.autograd.grad(out, (q4, k4, v4), g4,
                                               retain_graph=True), iters)


def training_attention_case(rng, b, c, p, kk, time_it: bool) -> dict:
    """``ct_attention_cm_stats`` and ``ct_attention_cm_bwd_flash`` against
    their plain versions (and the flash backward against torch autograd
    of the plain forward) on the same inputs."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ct_tpu_torch.ops.ct_attention import (
        ct_attention_cm_bwd_flash, ct_attention_cm_bwd_flash_reference,
        ct_attention_cm_stats, ct_attention_cm_stats_reference,
        ct_attention_reference_cm,
    )

    dev = torch.device("cuda")
    t = lambda *shape, scale=1.0: torch.from_numpy(
        rng.standard_normal(shape, np.float32) * scale).to(dev)
    q, base, g = t(b, c, p), t(b, c, p), t(b, c, p)
    k, v = t(b, kk, c), t(b, kk, c)
    wz = t(c, scale=0.1)

    # plain versions one at a time: at batch 64 each [B, K, P] tensor of
    # them is 5.5 GB
    with torch.no_grad():
        out, delta, m, z = ct_attention_cm_stats(q, k, v, base, wz)
        stats_deterministic = same_bits(lambda: ct_attention_cm_stats(
            q, k, v, base, wz))
        ref = ct_attention_cm_stats_reference(q, k, v, base, wz)
        fwd_err = {name: (a - r).abs().max().item() for name, a, r in
                   zip(("out", "delta", "m"), (out, delta, m), ref)}
        fwd_err["z_rel"] = ((z - ref[3]).abs() / ref[3]).max().item()
        del ref
        gd = g * delta
        colsum = (gd * wz[None, :, None]).sum(dim=1, keepdim=True)
        grads = ct_attention_cm_bwd_flash(q, k, v, wz, g, m, z, colsum)
        deterministic = same_bits(lambda: ct_attention_cm_bwd_flash(
            q, k, v, wz, g, m, z, colsum))
        plain = ct_attention_cm_bwd_flash_reference(q, k, v, wz, g, m, z,
                                                    colsum)
        scales = [r.abs().max().item() for r in plain]
        errs = [(a - r).abs().max().item() for a, r in zip(grads, plain)]
        del plain
    args = [x.clone().requires_grad_() for x in (q, k, v)]
    auto = torch.autograd.grad(ct_attention_reference_cm(*args, base, wz),
                               args, g)
    bwd_rel = {}
    for name, a, r, scale, err in zip(("dq", "dk", "dv"), grads, auto,
                                      scales, errs):
        bwd_rel[name] = err / scale
        bwd_rel[name + "_vs_autograd"] = (a - r).abs().max().item() / scale
    del args, auto
    torch.cuda.synchronize()
    res = {"B": b, "C": c, "P": p, "K": kk,
           "stats_max_abs_err": max(fwd_err.values()), "stats_err": fwd_err,
           "stats_tol": KERNEL_TOL, "stats_deterministic": stats_deterministic,
           "bwd_max_abs_err": max(errs),
           "bwd_rel_err": bwd_rel, "bwd_tol": BWD_TOL,
           "bwd_deterministic": deterministic}
    if not (max(fwd_err.values()) <= KERNEL_TOL
            and max(bwd_rel.values()) <= BWD_TOL and deterministic
            and stats_deterministic):
        raise AssertionError(f"training attention kernels disagree with "
                             f"their plain versions: {res}")
    if not time_it:
        return res

    torch.cuda.empty_cache()
    # yardsticks: one library call of the same attention on the row-major
    # layout ([B, 1, P, C] queries, unscaled scores), forward and backward
    q_rm = q.transpose(1, 2).contiguous()[:, None]
    k4, v4 = k[:, None], v[:, None]
    with torch.no_grad():
        res["stats"] = dict(
            ms=cuda_ms(lambda: ct_attention_cm_stats(q, k, v, base, wz), 10),
            plain_ms=cuda_ms(lambda: ct_attention_cm_stats_reference(
                q, k, v, base, wz), 3, warmup=1),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                q_rm, k4, v4, scale=1.0), 10),
            **tc_bound(4 * b * p * kk * c,
                       4 * (4 * b * c * p + 2 * b * kk * c + c + 2 * b * p),
                       exps=b * p * kk))
        res["bwd"] = dict(
            ms=cuda_ms(lambda: ct_attention_cm_bwd_flash(
                q, k, v, wz, g, m, z, colsum), 5),
            plain_ms=cuda_ms(lambda: ct_attention_cm_bwd_flash_reference(
                q, k, v, wz, g, m, z, colsum), 3, warmup=1),
            **tc_bound(10 * b * p * kk * c,
                       4 * (3 * b * c * p + 4 * b * kk * c + c + 3 * b * p),
                       exps=b * p * kk))
    res["bwd"]["library_ms"] = sdpa_backward_ms(
        q.transpose(1, 2), k, v, (g * wz[None, :, None]).transpose(1, 2), 5)
    return res


def blockwise_case(rng, b, c, p, kk, time_it: bool) -> dict:
    """``ct_attention_cm_bwd`` (the blockwise backward, row 4) against its
    plain version, and the autograd of ``ct_attention_cm(flash=False)``
    against torch autograd of the plain forward."""
    import torch

    from ct_tpu_torch.ops.ct_attention import (
        ct_attention_cm, ct_attention_cm_bwd, ct_attention_cm_bwd_reference,
        ct_attention_reference_cm,
    )

    t = lambda *shape, scale=1.0: device_normal(rng, shape, scale)
    q, base, g = t(b, c, p), t(b, c, p), t(b, c, p)
    k, v = t(b, kk, c), t(b, kk, c)
    wz = t(c, scale=0.1)
    with torch.no_grad():
        grads = ct_attention_cm_bwd(q, k, v, wz, g)
        deterministic = same_bits(lambda: ct_attention_cm_bwd(q, k, v, wz, g))
        plain = ct_attention_cm_bwd_reference(q, k, v, wz, g)
        rel = grads_rel_err(grads, plain)
        err = max((a - r).abs().max().item() for a, r in zip(grads, plain))
        del grads, plain
    args = [x.clone().requires_grad_() for x in (q, k, v, base, wz)]
    auto = torch.autograd.grad(ct_attention_cm(*args, flash=False), args, g)
    plain = torch.autograd.grad(ct_attention_reference_cm(*args), args, g)
    for name, a, r in zip(("dq", "dk", "dv", "dbase", "dwz"), auto, plain):
        rel[name + "_autograd"] = ((a - r).abs().max().item()
                                   / r.abs().max().item())
    del args, auto, plain
    torch.cuda.synchronize()
    res = {"B": b, "C": c, "P": p, "K": kk, "max_abs_err": err,
           "rel_err": rel, "tol": BWD_TOL, "deterministic": deterministic}
    if not (max(rel.values()) <= BWD_TOL and deterministic):
        raise AssertionError(f"ct_attention_cm_bwd disagrees with its plain "
                             f"version: {res}")
    if time_it:
        torch.cuda.empty_cache()
        with torch.no_grad():
            res.update(
                ms=cuda_ms(lambda: ct_attention_cm_bwd(q, k, v, wz, g), 5),
                plain_ms=cuda_ms(lambda: ct_attention_cm_bwd_reference(
                    q, k, v, wz, g), 3, warmup=1),
                **tc_bound(12 * b * p * kk * c,
                           4 * (3 * b * c * p + 4 * b * kk * c + 2 * c),
                           exps=b * p * kk))
        res["library_ms"] = sdpa_backward_ms(
            q.transpose(1, 2), k, v, (g * wz[None, :, None]).transpose(1, 2),
            5)
        with torch.no_grad():
            res["kernels_ms"] = kernel_split_ms(
                lambda: ct_attention_cm_bwd(q, k, v, wz, g), BLOCKWISE_KERNELS)
    return res


# the blockwise backward's kernels, by the names the profiler gives them
BLOCKWISE_KERNELS = ("bwd_stats_kernel", "dwz_reduce_kernel", "bwd_dq_kernel",
                     "bwd_dkdv_kernel")


# a profiled window: a pause on the host before it opens, LEAD_MARKERS
# marker kernels of MARKER_CYCLES (~6 ms each at the card's 1,980 MHz)
# before the calls and one after them
PROFILE_PAUSE_S = 1.0
MARKER_CYCLES = 12_500_000
LEAD_MARKERS = 32


def profiled_events(fn, iters: int = 1) -> list:
    """The device kernels of ``iters`` calls of ``fn()`` under
    torch.profiler (averaged by name), after one warm-up call. On the card
    a window opened shortly after an earlier one loses the first kernel
    records it holds, more the longer the process has run, whatever their
    length (a probe that logged each window's records lost the leading
    markers, then the bf16 flash backward's first three kernels in
    turn). With a pause of PROFILE_PAUSE_S on the host before the window
    opens and LEAD_MARKERS short markers
    (``torch.cuda._sleep``'s ``spin_kernel``, left out of the result)
    ahead of the calls, the probe's windows lost none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    time.sleep(PROFILE_PAUSE_S)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_MARKERS):
            torch.cuda._sleep(MARKER_CYCLES)
        for _ in range(iters):
            fn()
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and "spin_kernel" not in e.key]


def kernel_split_ms(fn, names) -> dict:
    """Device ms of each kernel of one call ``fn()`` under torch.profiler,
    by the first of ``names`` that its name holds; what matches none goes
    under "other". One warm-up call first."""
    out = dict.fromkeys((*names, "other"), 0.0)
    for e in profiled_events(fn):
        key = next((n for n in names if n in e.key), "other")
        out[key] += e.device_time_total / 1e3
    if not all(out[n] > 0 for n in names):
        raise AssertionError(f"the profiler saw no time for a kernel: {out}")
    return out


def rowmajor_case(rng, b, c, p, kk, time_fwd: int = 0,
                  time_bwd: int = 0) -> dict:
    """The row-major ``ct_attention`` (forward) and ``ct_attention_bwd``
    (row 5) against their plain versions; timed at batch ``time_fwd`` and
    ``time_bwd`` (0: not timed) on inputs of that batch."""
    import torch
    import torch.nn.functional as F

    from ct_tpu_torch.ops.ct_attention import (
        ct_attention, ct_attention_bwd, ct_attention_bwd_reference,
        ct_attention_reference,
    )

    def inputs(n):
        t = lambda *shape, scale=1.0: device_normal(rng, shape, scale)
        return (t(n, p, c), t(n, kk, c), t(n, kk, c), t(n, p, c),
                t(c, scale=0.1), t(n, p, c))

    q, k, v, base, wz, g = inputs(b)
    with torch.no_grad():
        err = (ct_attention(q, k, v, base, wz)
               - ct_attention_reference(q, k, v, base, wz)).abs().max().item()
        fwd_deterministic = same_bits(lambda: (ct_attention(q, k, v, base,
                                                            wz),))
        grads = ct_attention_bwd(q, k, v, wz, g)
        deterministic = same_bits(lambda: ct_attention_bwd(q, k, v, wz, g))
        plain = ct_attention_bwd_reference(q, k, v, wz, g)
        rel = grads_rel_err(grads, plain)
        bwd_err = max((a - r).abs().max().item() for a, r in zip(grads,
                                                                 plain))
        del grads, plain
    torch.cuda.synchronize()
    res = {"B": b, "C": c, "P": p, "K": kk, "fwd_max_abs_err": err,
           "fwd_tol": KERNEL_TOL, "bwd_rel_err": rel, "bwd_tol": BWD_TOL,
           "bwd_max_abs_err": bwd_err, "bwd_deterministic": deterministic,
           "fwd_deterministic": fwd_deterministic}
    if not (err <= KERNEL_TOL and max(rel.values()) <= BWD_TOL
            and deterministic and fwd_deterministic):
        raise AssertionError(f"the row-major kernels disagree with their "
                             f"plain versions: {res}")
    with torch.no_grad():
        if time_fwd:
            torch.cuda.empty_cache()
            q, k, v, base, wz, _ = inputs(time_fwd)
            n = time_fwd
            res["fwd"] = dict(
                batch=n,
                ms=cuda_ms(lambda: ct_attention(q, k, v, base, wz), 10),
                plain_ms=cuda_ms(lambda: ct_attention_reference(
                    q, k, v, base, wz), 3, warmup=1),
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    q[:, None], k[:, None], v[:, None], scale=1.0), 10),
                **tc_bound(4 * n * p * kk * c,
                           4 * (3 * n * p * c + 2 * n * kk * c + c),
                           exps=n * p * kk))
        if time_bwd:
            torch.cuda.empty_cache()
            q, k, v, base, wz, g = inputs(time_bwd)
            n = time_bwd
            res["bwd"] = dict(
                batch=n,
                ms=cuda_ms(lambda: ct_attention_bwd(q, k, v, wz, g), 5),
                plain_ms=cuda_ms(lambda: ct_attention_bwd_reference(
                    q, k, v, wz, g), 3, warmup=1),
                **tc_bound(12 * n * p * kk * c,
                           4 * (3 * n * p * c + 4 * n * kk * c + 2 * c),
                           exps=n * p * kk))
    if time_bwd:
        res["bwd"]["library_ms"] = sdpa_backward_ms(q, k, v, g * wz, 5)
        with torch.no_grad():
            res["bwd"]["kernels_ms"] = kernel_split_ms(
                lambda: ct_attention_bwd(q, k, v, wz, g), BLOCKWISE_KERNELS)
    return res


def variant_case(rng, b, c, p, kk, time_it: bool) -> dict:
    """``ct_attention_variant`` (row 10, the bfloat16 exponential) against
    its plain version on the attention bench's inputs (normal × 0.3). The
    band is half of what the bfloat16 rounding itself moves the output by,
    max |plain bf16 - plain f32| on the same inputs: a weight rounded a
    bfloat16 step the other way, where the kernel's f32 score lands on the
    other side of a rounding boundary, moves the output by a few percent of
    that (PERF.md §6, row 10), while a kernel that kept its exponential in
    float32 would be off by all of it. The kernel's output must also differ
    from the float32 kernel's (``ct_attention``) by more than the band."""
    import torch
    import torch.nn.functional as F

    from ct_tpu_torch.ops.ct_attention import (
        ct_attention, ct_attention_reference, ct_attention_variant,
        ct_attention_variant_reference,
    )

    t = lambda *shape: device_normal(rng, shape, 0.3)
    q, k, v, base, wz = t(b, p, c), t(b, kk, c), t(b, kk, c), t(b, p, c), t(c)
    with torch.no_grad():
        out = ct_attention_variant(q, k, v, base, wz)
        plain = ct_attention_variant_reference(q, k, v, base, wz)
        tol = 0.5 * (plain - ct_attention_reference(q, k, v, base, wz)
                     ).abs().max().item()
        err = (out - plain).abs().max().item()
        from_f32 = (out - ct_attention(q, k, v, base, wz)).abs().max().item()
        deterministic = same_bits(lambda: (ct_attention_variant(
            q, k, v, base, wz),))
        del plain
        torch.cuda.synchronize()
        res = {"B": b, "C": c, "P": p, "K": kk, "max_abs_err": err,
               "tol": tol, "max_abs_from_f32_kernel": from_f32,
               "deterministic": deterministic}
        if not (err <= tol < from_f32 and deterministic):
            raise AssertionError(f"ct_attention_variant disagrees with its "
                                 f"plain version or ignores its bfloat16 "
                                 f"exponential: {res}")
        if time_it:
            torch.cuda.empty_cache()
            res.update(
                ms=cuda_ms(lambda: ct_attention_variant(q, k, v, base, wz),
                           10),
                plain_ms=cuda_ms(lambda: ct_attention_variant_reference(
                    q, k, v, base, wz), 3, warmup=1),
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    q[:, None], k[:, None], v[:, None], scale=1.0), 10),
                # the function's 4·BPKC flops; on the tensor cores one
                # score product in 3xTF32 and its P·V in 2xTF32 (the bf16
                # weights are exact in TF32): 3·2 + 2·2 = 10·BPKC, 2.5 ×
                # the flops. The kernel's second walk recomputes the
                # scores; that is its own cost, not the function's.
                **tc_bound(4 * b * p * kk * c,
                           4 * (3 * b * p * c + 2 * b * kk * c + c),
                           tc_factor=2.5, exps=b * p * kk))
    return res


def bias_relu_case(rng, shape, time_it: bool, bf16: bool = False) -> dict:
    """``bias_relu_bwd`` (row 9), on float32 or (``bf16``, the type the
    JAX bench feeds it) bfloat16 g and y: the mask bit for bit the plain
    version's (the sign of zero too), dbias float32 within DBIAS_TOL of
    each channel's Σ|masked|; timed beside ``threshold_backward`` and the
    channel sum in float32, its bound the bytes of g, y and masked (12 an
    element in float32, 6 in bf16) and dbias."""
    import torch

    from ct_tpu_torch.ops.bias_relu import (
        bias_relu_bwd, bias_relu_bwd_bf16, bias_relu_bwd_reference,
    )
    from ct_tpu_torch.scripts.bench_bias_relu_bwd import library

    dtype, bits = ((torch.bfloat16, torch.int16) if bf16
                   else (torch.float32, torch.int32))
    kernel = bias_relu_bwd_bf16 if bf16 else bias_relu_bwd
    g = device_normal(rng, shape).to(dtype)
    y = torch.relu(device_normal(rng, shape)).to(dtype)
    masked, dbias = bias_relu_bwd(g, y)
    ref, ref_dbias = bias_relu_bwd_reference(g, y)
    scale = ref.float().abs().sum(dim=(0, 2, 3))
    torch.cuda.synchronize()
    res = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
           "mask_bitexact": bool(torch.equal(masked.view(bits),
                                             ref.view(bits))),
           "max_abs_err": (dbias - ref_dbias).abs().max().item(),
           "dbias_rel_err": ((dbias - ref_dbias).abs() / scale).max().item(),
           "tol": DBIAS_TOL}
    if not (res["mask_bitexact"] and res["dbias_rel_err"] <= DBIAS_TOL
            and masked.dtype == dtype and dbias.dtype == torch.float32):
        raise AssertionError(f"{kernel.__name__} disagrees with its plain "
                             f"version: {res}")
    del masked, ref
    if time_it:
        n = g.numel()
        res.update(ms=cuda_ms(lambda: kernel(g, y), 10),
                   plain_ms=cuda_ms(lambda: bias_relu_bwd_reference(g, y),
                                    10),
                   library_ms=cuda_ms(lambda: library(g, y), 10),
                   **bound(2 * n, 3 * g.element_size() * n + 4 * shape[1]))
    return res


def pool_case(rng, shape, time_it: bool) -> dict:
    """``pool2x2_relu`` forward and backward against torch autograd of
    ``F.relu`` then ``F.max_pool2d``, bit for bit, on tie-heavy inputs."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ct_tpu_torch.ops.pool_relu import (
        pool2x2_relu_bwd, pool2x2_relu_bwd_reference, pool2x2_relu_fwd,
        pool2x2_relu_reference,
    )

    dev = torch.device("cuda")
    x = torch.from_numpy((np.round(rng.standard_normal(shape) * 2) / 2)
                         .astype(np.float32)).to(dev)
    y = pool2x2_relu_fwd(x)
    g = torch.from_numpy(rng.standard_normal(tuple(y.shape)).astype(
        np.float32)).to(dev)
    dx = pool2x2_relu_bwd(x, y, g)
    xr = x.clone().requires_grad_()
    yr = F.max_pool2d(F.relu(xr), 2, 2)
    yr.backward(g)
    torch.cuda.synchronize()
    res = {"shape": list(shape),
           "fwd_bitexact": bool(torch.equal(y, yr.detach())),
           "bwd_bitexact": bool(torch.equal(dx, xr.grad)),
           "fwd_max_abs_err": (y - yr.detach()).abs().max().item(),
           "bwd_max_abs_err": (dx - xr.grad).abs().max().item(),
           "bwd_routed": int((dx != 0).sum().item())}
    if not (res["fwd_bitexact"] and res["bwd_bitexact"]):
        raise AssertionError(f"pool2x2_relu disagrees with torch autograd: "
                             f"{res}")
    if not time_it:
        return res
    del xr, yr
    n = x.numel()
    xl = x.clone().requires_grad_()
    yl = torch.relu(F.max_pool2d(xl, 2, 2))
    res["fwd"] = dict(
        ms=cuda_ms(lambda: pool2x2_relu_fwd(x), 10),
        plain_ms=cuda_ms(lambda: pool2x2_relu_reference(x), 10),
        library_ms=cuda_ms(lambda: torch.relu(F.max_pool2d(x, 2, 2)), 10),
        **bound(n, 4 * (n + n // 4)))
    res["bwd"] = dict(
        ms=cuda_ms(lambda: pool2x2_relu_bwd(x, y, g), 10),
        plain_ms=cuda_ms(lambda: pool2x2_relu_bwd_reference(x, y, g), 5),
        library_ms=cuda_ms(lambda: torch.autograd.grad(
            yl, xl, g, retain_graph=True), 10),
        **bound(2 * n, 4 * (2 * n + 2 * (n // 4))))
    return res


def bf16_check(name, out, ref, deterministic, **info) -> dict:
    """A bf16 kernel's output against its plain version: max |Δ| within
    one bf16 step of the largest output (``bf16_step``: the two sum in
    another f32 order, and a value that close to a rounding boundary
    rounds a step the other way), the share of outputs that differ, and
    the same bits on a second launch."""
    from ct_tpu_torch.ops.ct_attention import bf16_step

    a, r = out.float(), ref.float()
    err = (a - r).abs().max().item()
    res = {**info, "max_abs_err": err,
           "tol": bf16_step(r.abs().max().item()),
           "differing_share": (a != r).float().mean().item(),
           "deterministic": deterministic}
    if not (err <= res["tol"] and deterministic):
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{res}")
    return res


def bf16_attention_case(rng, b, c, p, kk, time_it: bool) -> dict:
    """``ct_attention_cm_bf16`` (row 1 in bf16, the ``--bf16`` eval path)
    against its plain bf16 version; timed beside
    ``scaled_dot_product_attention`` on the same bf16 inputs, with its
    bounds: the products on the tensor cores at the bf16 rate, and its
    B·P·K exponentials on the special-function units."""
    import torch
    import torch.nn.functional as F

    from ct_tpu_torch.ops.ct_attention import (
        ct_attention_cm, ct_attention_cm_bf16, ct_attention_reference_cm_bf16,
    )

    bf = torch.bfloat16
    t = lambda *shape, scale=1.0: device_normal(rng, shape, scale).to(bf)
    q, k, v, base = t(b, c, p), t(b, kk, c), t(b, kk, c), t(b, c, p)
    wz = device_normal(rng, (c,), 0.1)
    args = (q, k, v, base, wz)
    with torch.inference_mode():
        res = bf16_check(
            "ct_attention_cm_bf16", ct_attention_cm(*args),
            ct_attention_reference_cm_bf16(*args),
            same_bits(lambda: (ct_attention_cm_bf16(*args),)),
            B=b, C=c, P=p, K=kk)
        if not time_it:
            return res
        q_rm = q.transpose(1, 2).contiguous()[:, None]
        k4, v4 = k[:, None], v[:, None]
        res.update(
            ms=cuda_ms(lambda: ct_attention_cm_bf16(*args), 20),
            plain_ms=cuda_ms(lambda: ct_attention_reference_cm_bf16(*args),
                             5),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                q_rm, k4, v4, scale=1.0), 20),
            **bf16_bound(4 * b * p * kk * c, b * p * kk,
                         2 * (3 * b * c * p + 2 * b * kk * c) + 4 * c))
    return res


def bf16_prep_case(rng, b, c, kk) -> dict:
    """``ct_attention_prep_kv_bf16``, the bf16 kernels' shared prep of k and
    v into the tile layout, with and without v's ones column: equal, bit
    for bit, to its plain version (a torch rearrangement of the
    zero-padded tensors)."""
    import torch

    from ct_tpu_torch.ops.ct_attention import (
        ct_attention_prep_kv_bf16, prep_kv_reference_bf16,
    )

    k, v = (device_normal(rng, (b, kk, c)).to(torch.bfloat16)
            for _ in range(2))
    res = {"B": b, "C": c, "K": kk}
    for ones in (True, False):
        equal = all(torch.equal(a, r) for a, r in zip(
            ct_attention_prep_kv_bf16(k, v, ones),
            prep_kv_reference_bf16(k, v, ones)))
        res[f"equal_ones_{ones}"] = equal
        if not equal:
            raise AssertionError(f"ct_attention_prep_kv_bf16 (ones={ones}) "
                                 f"differs from its plain version: {res}")
    res["max_abs_err"] = 0.0
    return res


def bf16_serving_inputs(rng, b, c, p, kk, n) -> tuple:
    """Seeded bf16 conf, k, v, Wθ, f32 bθ and wz, and bf16 OBJ_Target of
    the serving head on the card."""
    import torch

    bf = torch.bfloat16
    t = lambda *shape, scale=1.0: device_normal(rng, shape, scale)
    conf, k, v = t(b, c, p, scale=3.0), t(b, kk, c, scale=0.3), t(b, kk, c)
    wt, bt, wz = t(c, c, scale=0.2), t(c, scale=0.1), t(c, scale=0.3)
    return (conf.to(bf), k.to(bf), v.to(bf), wt.to(bf), bt, wz,
            t(n, c).to(bf))


def serving_bf16_bound(b, c, p, kk, n) -> dict:
    """Row 6's bounds in bf16: 2·B·P·C·(2K+C+N) products, B·P·K
    exponentials, conf, k, v, Wθ, OBJ and out in bf16, bθ and wz f32."""
    return bf16_bound(2 * b * p * c * (2 * kk + c + n), b * p * kk,
                      2 * (b * c * p + b * n * p + 2 * b * kk * c + c * c
                           + n * c) + 8 * c)


def bf16_serving_case(rng, b, c, p, kk, n, time_it: bool) -> dict:
    """``ct_attention_serving_bf16`` (row 6 in bf16, the ``--int8 --bf16``
    serving path) against its plain bf16 version; timed beside the
    unfused head in library calls on the same bf16 inputs."""
    import torch

    from ct_tpu_torch.ops.ct_attention import (
        ct_attention_serving, ct_attention_serving_bf16,
        ct_attention_serving_reference_bf16,
    )
    from ct_tpu_torch.scripts.bench_fwd_bf16 import serving_library

    args = bf16_serving_inputs(rng, b, c, p, kk, n)
    with torch.inference_mode():
        res = bf16_check(
            "ct_attention_serving_bf16", ct_attention_serving(*args),
            ct_attention_serving_reference_bf16(*args),
            same_bits(lambda: (ct_attention_serving_bf16(*args),)),
            B=b, C=c, P=p, K=kk, N=n)
        if not time_it:
            return res
        res.update(
            ms=cuda_ms(lambda: ct_attention_serving_bf16(*args), 20),
            plain_ms=cuda_ms(
                lambda: ct_attention_serving_reference_bf16(*args), 5),
            library_ms=cuda_ms(serving_library(*args), 20),
            **serving_bf16_bound(b, c, p, kk, n))
    return res


def bf16_serving_batch_case(rng, b, c, p, kk, n, first: int) -> dict:
    """``ct_attention_serving_bf16`` at the JAX bench's batch, where its
    plain version would hold [B, K, P] f32 scores (11 GB at B=128): the
    first ``first`` images of the batch's scores equal, bit for bit, the
    kernel's on those images alone (a block owns 64 anchors of one image,
    so no image sees another), and those are held to the plain version as
    the B=8 cases are; timed beside the unfused head in library calls,
    with its bound."""
    import torch

    from ct_tpu_torch.ops.ct_attention import (
        ct_attention_serving_bf16, ct_attention_serving_reference_bf16,
    )
    from ct_tpu_torch.scripts.bench_fwd_bf16 import serving_library

    args = bf16_serving_inputs(rng, b, c, p, kk, n)
    head = tuple(a[:first] if a.dim() == 3 else a for a in args)
    with torch.inference_mode():
        out = ct_attention_serving_bf16(*args)
        alone = ct_attention_serving_bf16(*head)
        res = bf16_check(
            "ct_attention_serving_bf16", alone,
            ct_attention_serving_reference_bf16(*head),
            same_bits(lambda: (ct_attention_serving_bf16(*args),)),
            B=b, C=c, P=p, K=kk, N=n, held_images=first)
        res["batch_equals_alone"] = torch.equal(out[:first], alone)
        if not res["batch_equals_alone"]:
            raise AssertionError(f"ct_attention_serving_bf16 at B={b}: its "
                                 f"first {first} images differ from the "
                                 f"kernel on them alone: {res}")
        del out, alone
        res.update(
            ms=cuda_ms(lambda: ct_attention_serving_bf16(*args), 10),
            library_ms=cuda_ms(serving_library(*args), 10),
            **serving_bf16_bound(b, c, p, kk, n))
    return res


def bf16_rowmajor_case(rng, b, c, p, kk, time_batch: int = 0) -> dict:
    """``ct_attention_bf16`` (row 5's forward), ``ct_attention_variant_bf16``
    (row 10) and ``ct_attention_variant_unfused_bf16`` (row 10's unfused
    float32-exponent body) on the attention bench's bf16 inputs (normal ×
    0.3, wz float32) against their plain bf16 versions; the variant must
    differ from the row-major kernel somewhere (its rounded argument), and
    so must the unfused one (its denominator, the f32 sum of the weights
    before their rounding). Timed at batch ``time_batch`` (0: not
    timed)."""
    import torch
    import torch.nn.functional as F

    from ct_tpu_torch.ops.ct_attention import (
        ct_attention_bf16, ct_attention_reference_bf16,
        ct_attention_variant_bf16, ct_attention_variant_unfused_bf16,
    )

    def inputs(n):
        t = lambda *shape: device_normal(rng, shape, 0.3).to(torch.bfloat16)
        return (t(n, p, c), t(n, kk, c), t(n, kk, c), t(n, p, c),
                device_normal(rng, (c,)))

    kernels = (
        ("fwd", ct_attention_bf16, ct_attention_reference_bf16),
        ("variant", ct_attention_variant_bf16,
         lambda *a: ct_attention_reference_bf16(*a, exp_bf16=True)),
        ("unfused", ct_attention_variant_unfused_bf16,
         lambda *a: ct_attention_reference_bf16(*a, unfused=True)))
    args = inputs(b)
    res = {}
    with torch.no_grad():
        for name, fn, plain in kernels:
            res[name] = bf16_check(fn.__name__, fn(*args), plain(*args),
                                   same_bits(lambda: (fn(*args),)),
                                   B=b, C=c, P=p, K=kk)
        fused = ct_attention_bf16(*args)
        res["variant"]["differs_from_fwd"] = bool(not torch.equal(
            fused, ct_attention_variant_bf16(*args)))
        if not res["variant"]["differs_from_fwd"]:
            raise AssertionError("ct_attention_variant_bf16 ignores its "
                                 "bfloat16 argument")
        res["unfused"]["differs_from_fused"] = bool(not torch.equal(
            fused, ct_attention_variant_unfused_bf16(*args)))
        if not res["unfused"]["differs_from_fused"]:
            raise AssertionError("ct_attention_variant_unfused_bf16 divides "
                                 "by the rounded weights' sum")
        if not time_batch:
            return res
        del args
        torch.cuda.empty_cache()
        n = time_batch
        args = inputs(n)
        q, k, v = args[:3]
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q[:, None], k[:, None], v[:, None], scale=1.0), 10)
        for name, fn, plain in kernels:
            res[name].update(
                batch=n, ms=cuda_ms(lambda: fn(*args), 10),
                plain_ms=cuda_ms(lambda: plain(*args), 2, warmup=1),
                library_ms=library_ms,
                **bf16_bound(4 * n * p * kk * c, n * p * kk,
                             2 * (3 * n * p * c + 2 * n * kk * c) + 4 * c))
            torch.cuda.empty_cache()
    return res


def bf16_sum_check(name, outs, plains, names, deterministic, **info):
    """bf16 training kernels against their plain versions: each output's
    mean |Δ| within BF16_SUM_MEAN_TOL of its mean |entry|, and its max |Δ|
    within one bf16 step of its largest entry (out, delta) or
    BF16_SUM_MAX_TOL of it (dq, dk, dv, dwz); the same bits on a second
    launch."""
    from ct_tpu_torch.ops.ct_attention import bf16_step

    res = {**info, "deterministic": deterministic,
           "mean_tol": BF16_SUM_MEAN_TOL, "max_tol": BF16_SUM_MAX_TOL}
    ok = deterministic
    for n, a, r in zip(names, outs, plains):
        a, r = a.float(), r.float()
        d = (a - r).abs()
        scale = r.abs().max().item()
        tol = (bf16_step(scale) if n in ("out", "delta")
               else BF16_SUM_MAX_TOL * scale)
        mean_rel = d.mean().item() / max(r.abs().mean().item(), 1e-30)
        res[n] = {"max_abs_err": d.max().item(), "tol": tol,
                  "max_abs": scale, "mean_rel_err": mean_rel,
                  "differing_share": (a != r).float().mean().item()}
        ok = ok and res[n]["max_abs_err"] <= tol and (
            mean_rel <= BF16_SUM_MEAN_TOL)
    res["max_abs_err"] = max(res[n]["max_abs_err"] for n in names)
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{res}")
    return res


def bf16_training_case(rng, b, c, p, kk, time_it: bool) -> dict:
    """Rows 2 and 3 in bf16 (the ``--bf16`` train step's flash path):
    ``ct_attention_cm_stats_bf16`` and ``ct_attention_cm_bwd_flash_bf16``
    against their plain bf16 versions on the same inputs (the backward from
    the kernel's own m, z and delta); timed beside the bf16 SDPA forward
    and backward with their bounds (``bf16_bound``)."""
    import torch
    import torch.nn.functional as F

    from ct_tpu_torch.ops.ct_attention import (
        ct_attention_cm_bwd_flash_bf16,
        ct_attention_cm_bwd_flash_reference_bf16, ct_attention_cm_stats_bf16,
        ct_attention_cm_stats_reference_bf16,
    )

    bf = torch.bfloat16
    t = lambda *shape, scale=1.0: device_normal(rng, shape, scale).to(bf)
    q, base, g = t(b, c, p), t(b, c, p), t(b, c, p)
    k, v = t(b, kk, c), t(b, kk, c)
    wz = device_normal(rng, (c,), 0.1)
    fwd = (q, k, v, base, wz)
    with torch.no_grad():
        out, delta, m, z = ct_attention_cm_stats_bf16(*fwd)
        ref = ct_attention_cm_stats_reference_bf16(*fwd)
        stats = bf16_sum_check(
            "ct_attention_cm_stats_bf16", (out, delta), ref[:2],
            ("out", "delta"),
            same_bits(lambda: ct_attention_cm_stats_bf16(*fwd)),
            B=b, C=c, P=p, K=kk)
        stats["m_rel_err"] = ((m - ref[2]).abs().max().item()
                              / ref[2].abs().max().item())
        stats["z_max_abs_err"] = (z - ref[3]).abs().max().item()
        del ref
        if not (stats["m_rel_err"] <= BF16_M_TOL
                and stats["z_max_abs_err"] <= BF16_Z_TOL):
            raise AssertionError(f"ct_attention_cm_stats_bf16's m or z: "
                                 f"{stats}")
        gd = g.float() * delta.float()
        colsum = (gd * wz[None, :, None]).sum(dim=1, keepdim=True)
        bwd_args = (q, k, v, wz, g, m, z, colsum)
        bwd = bf16_sum_check(
            "ct_attention_cm_bwd_flash_bf16",
            ct_attention_cm_bwd_flash_bf16(*bwd_args),
            ct_attention_cm_bwd_flash_reference_bf16(*bwd_args),
            ("dq", "dk", "dv"),
            same_bits(lambda: ct_attention_cm_bwd_flash_bf16(*bwd_args)),
            B=b, C=c, P=p, K=kk)
    torch.cuda.synchronize()
    res = {"stats": stats, "bwd": bwd}
    if not time_it:
        return res
    torch.cuda.empty_cache()
    q_rm = q.transpose(1, 2).contiguous()[:, None]
    with torch.no_grad():
        stats.update(
            ms=cuda_ms(lambda: ct_attention_cm_stats_bf16(*fwd), 10),
            plain_ms=cuda_ms(lambda: ct_attention_cm_stats_reference_bf16(
                *fwd), 3, warmup=1),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                q_rm, k[:, None], v[:, None], scale=1.0), 10),
            **bf16_bound(4 * b * p * kk * c, b * p * kk,
                         2 * (4 * b * c * p + 2 * b * kk * c)
                         + 4 * (2 * b * p + c)))
        torch.cuda.empty_cache()
        bwd.update(
            ms=cuda_ms(lambda: ct_attention_cm_bwd_flash_bf16(*bwd_args), 5),
            plain_ms=cuda_ms(
                lambda: ct_attention_cm_bwd_flash_reference_bf16(*bwd_args),
                2, warmup=1),
            **bf16_bound(10 * b * p * kk * c, b * p * kk,
                         2 * (3 * b * c * p + 2 * b * kk * c)
                         + 4 * (2 * b * kk * c + 3 * b * p + c)))
        bwd["kernels_ms"] = kernel_split_ms(
            lambda: ct_attention_cm_bwd_flash_bf16(*bwd_args),
            BF16_BWD_KERNELS[:2] + BF16_BWD_KERNELS[4:])
    torch.cuda.empty_cache()
    bwd["library_ms"] = sdpa_backward_ms(
        q.transpose(1, 2), k, v,
        (g.float() * wz[None, :, None]).to(bf).transpose(1, 2), 5)
    return res


# the bf16 backwards' kernels, by the names the profiler gives them: the
# tile layouts of k and v and of q and g·wz (and g), the blockwise stats
# pass and its dwz reduction, dq, dk/dv
BF16_BWD_KERNELS = ("prep_kv", "prep_q", "stats_kernel",
                    "dwz_reduce_kernel", "dq_kernel", "dkdv_kernel")


def bf16_blockwise_case(rng, b, c, p, kk, time_it: bool) -> dict:
    """Row 4 in bf16 (``CT_ATTENTION_FLASH=0`` under ``--bf16``):
    ``ct_attention_cm_bwd_bf16`` against its plain bf16 version, and the
    autograd of ``ct_attention_cm(flash=False)`` on bf16 against the
    kernels it must run (the eval forward, this backward, dk and dv cast
    to bf16): the same bits. Timed beside the bf16 SDPA backward."""
    import torch

    from ct_tpu_torch.ops.ct_attention import (
        ct_attention_cm, ct_attention_cm_bf16, ct_attention_cm_bwd_bf16,
        ct_attention_cm_bwd_reference_bf16,
    )

    bf = torch.bfloat16
    t = lambda *shape: device_normal(rng, shape).to(bf)
    q, base, g = t(b, c, p), t(b, c, p), t(b, c, p)
    k, v = t(b, kk, c), t(b, kk, c)
    wz = device_normal(rng, (c,), 0.1)
    args = (q, k, v, wz, g)
    with torch.no_grad():
        grads = ct_attention_cm_bwd_bf16(*args)
        res = bf16_sum_check(
            "ct_attention_cm_bwd_bf16", grads,
            ct_attention_cm_bwd_reference_bf16(*args),
            ("dq", "dk", "dv", "dwz"),
            same_bits(lambda: ct_attention_cm_bwd_bf16(*args)),
            B=b, C=c, P=p, K=kk)
        out = ct_attention_cm_bf16(q, k, v, base, wz)
    leaves = [x.clone().requires_grad_() for x in (q, k, v, base, wz)]
    y = ct_attention_cm(*leaves, flash=False)
    auto = torch.autograd.grad(y, leaves, g)
    want = (grads[0], grads[1].to(bf), grads[2].to(bf), g, grads[3])
    res["autograd_same_bits"] = bool(
        torch.equal(y, out)
        and all(torch.equal(a, w) for a, w in zip(auto, want)))
    del leaves, y, auto, want
    if not res["autograd_same_bits"]:
        raise AssertionError("the bf16 blockwise autograd does not run its "
                             "kernels")
    if time_it:
        torch.cuda.empty_cache()
        with torch.no_grad():
            res.update(
                ms=cuda_ms(lambda: ct_attention_cm_bwd_bf16(*args), 5),
                plain_ms=cuda_ms(lambda: ct_attention_cm_bwd_reference_bf16(
                    *args), 2, warmup=1),
                **bf16_bound(12 * b * p * kk * c, b * p * kk,
                             2 * (3 * b * c * p + 2 * b * kk * c)
                             + 4 * (2 * b * kk * c + 2 * c)))
            res["kernels_ms"] = kernel_split_ms(
                lambda: ct_attention_cm_bwd_bf16(*args), BF16_BWD_KERNELS)
        torch.cuda.empty_cache()
        res["library_ms"] = sdpa_backward_ms(
            q.transpose(1, 2), k, v,
            (g.float() * wz[None, :, None]).to(bf).transpose(1, 2), 5)
    return res


def bf16_rowmajor_bwd_case(rng, b, c, p, kk, time_it: bool) -> dict:
    """Row 5's backward in bf16 (``ct_attention_bwd_bf16``, the JAX bwd
    bench's row-major kernel on its bf16 inputs, normal × 0.3) against its
    plain bf16 version; dq, dk, dv and dwz all float32 as that bench's
    wrapper emits them. Timed beside the bf16 SDPA backward, and split by
    kernel (``kernels_ms``) as rows 3 and 4 are."""
    import torch

    from ct_tpu_torch.ops.ct_attention import (
        ct_attention_bwd_bf16, ct_attention_bwd_reference_bf16,
    )

    t = lambda *shape: device_normal(rng, shape, 0.3).to(torch.bfloat16)
    args = (t(b, p, c), t(b, kk, c), t(b, kk, c), device_normal(rng, (c,)),
            t(b, p, c))
    with torch.no_grad():
        res = bf16_sum_check(
            "ct_attention_bwd_bf16", ct_attention_bwd_bf16(*args),
            ct_attention_bwd_reference_bf16(*args),
            ("dq", "dk", "dv", "dwz"),
            same_bits(lambda: ct_attention_bwd_bf16(*args)),
            B=b, C=c, P=p, K=kk)
        if time_it:
            torch.cuda.empty_cache()
            q, k, v, wz, g = args
            res.update(
                ms=cuda_ms(lambda: ct_attention_bwd_bf16(*args), 5),
                plain_ms=cuda_ms(lambda: ct_attention_bwd_reference_bf16(
                    *args), 2, warmup=1),
                **bf16_bound(12 * b * p * kk * c, b * p * kk,
                             2 * (2 * b * c * p + 2 * b * kk * c)
                             + 4 * (b * c * p + 2 * b * kk * c + 2 * c)))
            res["kernels_ms"] = kernel_split_ms(
                lambda: ct_attention_bwd_bf16(*args), BF16_BWD_KERNELS)
    if time_it:
        torch.cuda.empty_cache()
        res["library_ms"] = sdpa_backward_ms(
            q, k, v, (g.float() * wz).to(torch.bfloat16), 5)
    return res


def bf16_pool_case(rng, shape, time_it: bool) -> dict:
    """Row 7 in bf16: ``pool2x2_relu`` forward and backward on bf16 against
    torch autograd of ``F.relu`` then ``F.max_pool2d`` on the same bf16
    tensors, bit for bit, on tie-heavy inputs; timed beside that library
    composition, its bound half the f32 kernel's bytes."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ct_tpu_torch.ops.pool_relu import (
        pool2x2_relu_bwd, pool2x2_relu_bwd_bf16, pool2x2_relu_bwd_reference,
        pool2x2_relu_fwd, pool2x2_relu_fwd_bf16, pool2x2_relu_reference,
    )

    bf = torch.bfloat16
    dev = torch.device("cuda")
    x = torch.from_numpy((np.round(rng.standard_normal(shape) * 2) / 2)
                         .astype(np.float32)).to(dev, bf)
    y = pool2x2_relu_fwd(x)
    g = device_normal(rng, tuple(y.shape)).to(bf)
    dx = pool2x2_relu_bwd(x, y, g)
    xr = x.clone().requires_grad_()
    yr = F.max_pool2d(F.relu(xr), 2, 2)
    yr.backward(g)
    torch.cuda.synchronize()
    res = {"shape": list(shape), "dtype": "bfloat16",
           "fwd_bitexact": bool(torch.equal(y, yr.detach())),
           "bwd_bitexact": bool(torch.equal(dx, xr.grad)),
           "fwd_max_abs_err": (y.float() - yr.detach().float()).abs()
           .max().item(),
           "bwd_max_abs_err": (dx.float() - xr.grad.float()).abs()
           .max().item(),
           "bwd_routed": int((dx != 0).sum().item())}
    if not (res["fwd_bitexact"] and res["bwd_bitexact"] and y.dtype == bf
            and dx.dtype == bf):
        raise AssertionError(f"pool2x2_relu on bf16 disagrees with torch "
                             f"autograd: {res}")
    if not time_it:
        return res
    del xr, yr
    n = x.numel()
    xl = x.clone().requires_grad_()
    yl = torch.relu(F.max_pool2d(xl, 2, 2))
    res["fwd"] = dict(
        ms=cuda_ms(lambda: pool2x2_relu_fwd_bf16(x), 10),
        plain_ms=cuda_ms(lambda: pool2x2_relu_reference(x), 10),
        library_ms=cuda_ms(lambda: torch.relu(F.max_pool2d(x, 2, 2)), 10),
        **bound(n, 2 * (n + n // 4)))
    res["bwd"] = dict(
        ms=cuda_ms(lambda: pool2x2_relu_bwd_bf16(x, y, g), 10),
        plain_ms=cuda_ms(lambda: pool2x2_relu_bwd_reference(x, y, g), 5),
        library_ms=cuda_ms(lambda: torch.autograd.grad(
            yl, xl, g, retain_graph=True), 10),
        **bound(2 * n, 2 * (2 * n + 2 * (n // 4))))
    return res


def phase_kernel(seed: int) -> dict:
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    res = {
        # the eval path's shapes: batch 8, incre (C=15), P=11620, K=1858
        "incre": attention_case(rng, 8, 15, 11620, 1858, True),
        "transfer": attention_case(rng, 8, 60, 11620, 1858, True),
        # P not a multiple of the 64-anchor block, K not of the 32-key tile
        "ragged": attention_case(rng, 3, 60, 1001, 97, False),
        "ragged_narrow": attention_case(rng, 2, 7, 130, 65, False),
        # the training kernels: checked at batch 8, timed at batch 64
        "train_incre": training_attention_case(rng, 8, 15, 11620, 1858,
                                               False),
        "train_transfer": training_attention_case(rng, 8, 60, 11620, 1858,
                                                  False),
        "train_ragged": training_attention_case(rng, 3, 60, 1001, 97, False),
        "train_ragged_narrow": training_attention_case(rng, 2, 7, 130, 65,
                                                       False),
        "train_timed": training_attention_case(rng, TRAIN_BATCH, 15, 11620,
                                               1858, True),
        # the transfer width, where the backward kernels take the most time
        "train_timed_transfer": training_attention_case(
            rng, TRAIN_BATCH, 60, 11620, 1858, True),
        # the serving head at the serving path's shapes (B=8; incre C=15 and
        # N=5, transfer C=60 and N=20), ragged P and K
        "serving_incre": serving_case(rng, 8, 15, 11620, 1858, 5, True),
        "serving_transfer": serving_case(rng, 8, 60, 11620, 1858, 20, True),
        "serving_ragged": serving_case(rng, 3, 60, 1001, 97, 20, False),
        "serving_ragged_narrow": serving_case(rng, 2, 7, 130, 65, 3, False),
        # NMS at the eval path's rows: 8 images x 20 classes of 200
        "nms": nms_case(rng, 160, 200, False, True),
        "nms_ties": nms_case(rng, 160, 200, True, False),
        "nms_ragged": nms_case(rng, 7, 33, True, False),
        # conv1's pool at 300: [B, 64, 300, 300] → [B, 64, 150, 150]
        "pool": pool_case(rng, (8, 64, 300, 300), False),
        "pool_ragged": pool_case(rng, (3, 5, 6, 10), False),
        "pool_timed": pool_case(rng, (TRAIN_BATCH, 64, 300, 300), True),
        # the blockwise backward (CT_ATTENTION_FLASH=0): checked at batch 8,
        # timed at the train step's batch
        "blockwise_incre": blockwise_case(rng, 8, 15, 11620, 1858, False),
        "blockwise_transfer": blockwise_case(rng, 8, 60, 11620, 1858, False),
        "blockwise_ragged": blockwise_case(rng, 3, 60, 1001, 97, False),
        "blockwise_ragged_narrow": blockwise_case(rng, 2, 7, 130, 65, False),
        "blockwise_timed": blockwise_case(rng, TRAIN_BATCH, 15, 11620, 1858,
                                          True),
        "blockwise_timed_transfer": blockwise_case(rng, TRAIN_BATCH, 60,
                                                   11620, 1858, True),
        # the row-major attention of the kernel benches: checked at batch
        # 8, timed at the benches' batches at the transfer width
        "rowmajor_incre": rowmajor_case(rng, 8, 15, 11620, 1858,
                                        time_bwd=BENCH_BWD_BATCH),
        "rowmajor_transfer": rowmajor_case(
            rng, 8, 60, 11620, 1858, BENCH_FWD_BATCH, BENCH_BWD_BATCH),
        "rowmajor_ragged": rowmajor_case(rng, 3, 60, 1001, 97),
        "rowmajor_ragged_narrow": rowmajor_case(rng, 2, 7, 130, 65),
        # the attention bench's bfloat16 variant (its float32 one is the
        # row-major forward above), timed at the bench's batch
        "variant_incre": variant_case(rng, 8, 15, 11620, 1858, False),
        "variant_transfer": variant_case(rng, 8, 60, 11620, 1858, False),
        "variant_ragged": variant_case(rng, 3, 60, 1001, 97, False),
        "variant_timed": variant_case(rng, BENCH_FWD_BATCH, 60, 11620, 1858,
                                      True),
        # the bias+ReLU backward at the bench's first shape, NCHW
        "bias_relu": bias_relu_case(rng, (8, 64, 300, 300), False),
        "bias_relu_ragged": bias_relu_case(rng, (3, 5, 7, 9), False),
        "bias_relu_timed": bias_relu_case(rng, (64, 64, 300, 300), True),
        # and on bf16, the type the JAX bench feeds its kernel
        "bf16_bias_relu": bias_relu_case(rng, (8, 64, 300, 300), False,
                                         bf16=True),
        "bf16_bias_relu_ragged": bias_relu_case(rng, (3, 5, 7, 9), False,
                                                bf16=True),
        "bf16_bias_relu_timed": bias_relu_case(rng, (64, 64, 300, 300), True,
                                               bf16=True),
        # bf16 (``--bf16``): row 1 at the eval path's shapes and the
        # transfer width, row 6 at the serving path's, ragged P and K;
        # rows 5 (forward) and 10 on the attention bench's inputs, timed at
        # its batch
        "bf16_prep_incre": bf16_prep_case(rng, TRAIN_BATCH, 15, 1858),
        "bf16_prep_transfer": bf16_prep_case(rng, TRAIN_BATCH, 60, 1858),
        "bf16_incre": bf16_attention_case(rng, 8, 15, 11620, 1858, True),
        "bf16_transfer": bf16_attention_case(rng, 8, 60, 11620, 1858, True),
        "bf16_ragged": bf16_attention_case(rng, 3, 60, 1001, 97, False),
        "bf16_ragged_narrow": bf16_attention_case(rng, 2, 7, 130, 65, False),
        "bf16_serving_incre": bf16_serving_case(rng, 8, 15, 11620, 1858, 5,
                                                True),
        "bf16_serving_transfer": bf16_serving_case(rng, 8, 60, 11620, 1858,
                                                   20, True),
        "bf16_serving_ragged": bf16_serving_case(rng, 3, 60, 1001, 97, 20,
                                                 False),
        "bf16_serving_ragged_narrow": bf16_serving_case(rng, 2, 7, 130, 65,
                                                        3, False),
        # the JAX bench's serving shape (bench.py: transfer, batch 128)
        "bf16_serving_bench": bf16_serving_batch_case(
            rng, BENCH_FWD_BATCH, 60, 11620, 1858, 20, 8),
        "bf16_rowmajor": bf16_rowmajor_case(rng, 8, 60, 11620, 1858,
                                            BENCH_FWD_BATCH),
        "bf16_rowmajor_ragged": bf16_rowmajor_case(rng, 3, 15, 1001, 97),
        # bf16 training (``train.py --bf16``): rows 2 and 3 (the flash
        # path), row 4 (the blockwise backward), row 5's backward on the
        # bwd bench's inputs and row 7, checked at batch 8 and ragged,
        # timed at the train step's batch (the bench's for row 5)
        "bf16_train_incre": bf16_training_case(rng, 8, 15, 11620, 1858,
                                               False),
        "bf16_train_transfer": bf16_training_case(rng, 8, 60, 11620, 1858,
                                                  False),
        "bf16_train_ragged": bf16_training_case(rng, 3, 60, 1001, 97, False),
        "bf16_train_ragged_narrow": bf16_training_case(rng, 2, 7, 130, 65,
                                                       False),
        "bf16_train_timed": bf16_training_case(rng, TRAIN_BATCH, 15, 11620,
                                               1858, True),
        "bf16_train_timed_transfer": bf16_training_case(
            rng, TRAIN_BATCH, 60, 11620, 1858, True),
        "bf16_blockwise_incre": bf16_blockwise_case(rng, 8, 15, 11620, 1858,
                                                    False),
        "bf16_blockwise_transfer": bf16_blockwise_case(rng, 8, 60, 11620,
                                                       1858, False),
        "bf16_blockwise_ragged": bf16_blockwise_case(rng, 3, 60, 1001, 97,
                                                     False),
        "bf16_blockwise_ragged_narrow": bf16_blockwise_case(rng, 2, 7, 130,
                                                            65, False),
        "bf16_blockwise_timed": bf16_blockwise_case(rng, TRAIN_BATCH, 15,
                                                    11620, 1858, True),
        "bf16_blockwise_timed_transfer": bf16_blockwise_case(
            rng, TRAIN_BATCH, 60, 11620, 1858, True),
        "bf16_rowmajor_bwd": bf16_rowmajor_bwd_case(rng, 8, 60, 11620, 1858,
                                                    False),
        "bf16_rowmajor_bwd_ragged": bf16_rowmajor_bwd_case(rng, 3, 15, 1001,
                                                           97, False),
        "bf16_rowmajor_bwd_timed": bf16_rowmajor_bwd_case(
            rng, BENCH_BWD_BATCH, 60, 11620, 1858, True),
        "bf16_rowmajor_bwd_timed_incre": bf16_rowmajor_bwd_case(
            rng, BENCH_BWD_BATCH, 15, 11620, 1858, True),
        "bf16_pool": bf16_pool_case(rng, (8, 64, 300, 300), False),
        "bf16_pool_ragged": bf16_pool_case(rng, (3, 5, 6, 10), False),
        "bf16_pool_timed": bf16_pool_case(rng, (TRAIN_BATCH, 64, 300, 300),
                                          True),
    }
    torch.cuda.empty_cache()
    return res


def seeded_images(seed: int, n: int, size: int):
    """n smooth random BGR images, mean-subtracted, NCHW float32: uniform
    noise on a 12x12 grid, bilinearly upsampled, so that the detector sees
    blobs rather than pixel noise."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ct_tpu_torch.config import RGB_MEANS

    rng = np.random.default_rng(seed)
    low = torch.from_numpy(rng.uniform(0, 255, (n, 3, 12, 12)).astype(
        np.float32))
    img = F.interpolate(low, size=(size, size), mode="bilinear",
                        align_corners=False)
    return img - torch.tensor(RGB_MEANS)[None, :, None, None]


# the hand-written kernels of the eval and serving steps, by the names the
# profiler gives them: their device time in one profiled step
PROFILED_KERNELS = ("ct_attention_kernel", "ct_attention_serving_kernel",
                    "nms_kernel", "ct_attention_bf16_kernel",
                    "ct_attention_serving_bf16_kernel", "prep_kv")


def eval_steps(step, x, hw, counts: dict, expected: dict, steps: int,
               out_dir: str, table: str) -> dict:
    """1 warm-up and ``steps`` timed calls of an eval step on the card
    (images/s from the median step, peak memory since the caller's reset),
    the launches of the ``counts`` kernels over them, which must equal
    ``expected``, and one profiled step."""
    import torch

    for fn in counts.values():
        fn.launches = 0
    times = []
    for _ in range(1 + steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dets = step(x, hw)
        dets = type(dets)(*(t.cpu() for t in dets))
        times.append(time.perf_counter() - t0)
    launches = {name: fn.launches for name, fn in counts.items()}
    if launches != expected:
        raise AssertionError(f"launches over {1 + steps} eval steps: "
                             f"{launches}, expected {expected}")
    median_s = sorted(times[1:])[steps // 2]
    res = {"batch": x.shape[0], "warmup_s": times[0], "step_s": times[1:],
           "images_per_s": x.shape[0] / median_s, "launches": launches,
           "detections_per_image": dets.valid.sum(1).tolist(),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    res["profile"] = profile_step(lambda: step(x, hw), out_dir, table,
                                  PROFILED_KERNELS)
    return res


def card_vs_cpu_detections(step, cpu_net, images, sizes) -> dict:
    """The card's eval step and ``cpu_net``'s on the first image: the
    detections must match (``compare_detections`` at MATCH_IOU and
    MATCH_SCORE)."""
    from ct_tpu_torch.config import get_config
    from ct_tpu_torch.eval import compare_detections, make_eval_step
    from ct_tpu_torch.ops.priors import prior_boxes

    cpu_step = make_eval_step(cpu_net, prior_boxes(
        get_config("VOC", cpu_net.size), "cpu"))
    cpu_dets = cpu_step(images[:1], sizes[:1])
    gpu_dets = step(images[:1].cuda(), sizes[:1].cuda())
    agree = compare_detections(type(gpu_dets)(*(t.cpu() for t in gpu_dets)),
                               cpu_dets, iou_tol=MATCH_IOU,
                               score_tol=MATCH_SCORE)
    if not agree["ok"]:
        raise AssertionError(f"card and CPU detections differ: {agree}")
    return agree


def phase_model(seed: int, out_dir: str) -> dict:
    import torch

    from ct_tpu_torch.config import VOC_300, resolve_task
    from ct_tpu_torch.eval import make_eval_step
    from ct_tpu_torch.models.convert import load_reference_pth
    from ct_tpu_torch.models.rfbnet import build_net
    from ct_tpu_torch.ops.ct_attention import ct_attention_cm
    from ct_tpu_torch.ops.nms import nms_mask
    from ct_tpu_torch.ops.priors import prior_boxes

    batch, steps = 8, 3
    task = resolve_task(2, "incre", "ours", "VOC")
    state = load_reference_pth(REF_MODEL)
    images = seeded_images(seed, batch, 300)
    sizes = torch.tensor([[375, 500]] * batch)      # a typical VOC image

    torch.cuda.reset_peak_memory_stats()   # the kernel phase's is not ours
    net = build_net(task, 300, device="cuda")
    net.load_state_dict(state)
    step = make_eval_step(net, prior_boxes(VOC_300, "cuda"))
    counts = {"ct_attention_cm": ct_attention_cm, "nms_mask": nms_mask}
    res = eval_steps(step, images.cuda(), sizes.cuda(), counts,
                     dict.fromkeys(counts, 1 + steps), steps, out_dir,
                     "profile_model.txt")
    cpu_net = build_net(task, 300, device="cpu")
    cpu_net.load_state_dict(state)
    res["card_vs_cpu"] = card_vs_cpu_detections(step, cpu_net, images, sizes)
    return res


def phase_serving(seed: int, out_dir: str) -> dict:
    """The int8 serving path of ``test.py --int8`` on the card, then the
    same quantized model (the same scales) on the CPU on one image, and
    the calibration of the card against the CPU's on the same images."""
    import torch

    from ct_tpu_torch.config import VOC_300, resolve_task
    from ct_tpu_torch.eval import make_eval_step
    from ct_tpu_torch.models.convert import load_reference_pth
    from ct_tpu_torch.models.fold_bn import fold_bn
    from ct_tpu_torch.models.quantize import attach, calibrate
    from ct_tpu_torch.models.rfbnet import build_net
    from ct_tpu_torch.ops.ct_attention import (
        ct_attention_cm, ct_attention_serving,
    )
    from ct_tpu_torch.ops.nms import nms_mask
    from ct_tpu_torch.ops.priors import prior_boxes
    from ct_tpu_torch.test import serving_model

    batch, steps = 8, 3
    task = resolve_task(2, "incre", "ours", "VOC")
    state = load_reference_pth(REF_MODEL)
    images = seeded_images(seed + 100, batch, 300)
    sizes = torch.tensor([[375, 500]] * batch)

    torch.cuda.reset_peak_memory_stats()
    net = build_net(task, 300, device="cuda")
    net.load_state_dict(state)
    t0 = time.perf_counter()
    served, quant = serving_model(net, seeded_images(seed + 200, 8, 300))
    torch.cuda.synchronize()
    # preparing includes a float forward at batch 8 (the calibration):
    # its peak memory is kept apart from the serving steps'
    prep = {"quantized_convs": len(quant),
            "chained": sum("out_scale" in q for q in quant.values()),
            "prepare_s": time.perf_counter() - t0,
            "prepare_peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    torch.cuda.reset_peak_memory_stats()
    step = make_eval_step(served, prior_boxes(VOC_300, "cuda"))
    counts = {"ct_attention_serving": ct_attention_serving,
              "nms_mask": nms_mask, "ct_attention_cm": ct_attention_cm}
    expected = dict.fromkeys(counts, 1 + steps)
    expected["ct_attention_cm"] = 0       # the folded model: serving head
    res = dict(prep, **eval_steps(step, images.cuda(), sizes.cuda(), counts,
                                  expected, steps, out_dir,
                                  "profile_serving.txt"))
    cpu_net = build_net(task, 300, device="cpu", fold_bn=True)
    cpu_net.load_state_dict({k: v.cpu() for k, v in
                             served.state_dict().items()
                             if not k.endswith(QUANT_BUFFERS)})
    attach(cpu_net, quant)
    res["card_vs_cpu"] = card_vs_cpu_detections(step, cpu_net, images, sizes)

    # the same calibration on the card and on the CPU (two images): the
    # float forwards round differently, so an act_scale moves by ulps, and
    # every int8 rounding it governs may move with it
    few = seeded_images(seed + 200, 2, 300)
    card = calibrate(fold_bn(net), [few.cuda()])
    cpu_float = build_net(task, 300, device="cpu")
    cpu_float.load_state_dict(state)
    host = calibrate(fold_bn(cpu_float), [few])
    rel = [abs(card[n].item() - v.item()) / v.item() for n, v in host.items()]
    res["calibration_card_vs_cpu"] = {
        "convs": len(rel), "differ": sum(r > 0 for r in rel),
        "max_rel": max(rel), "tol": CALIB_TOL}
    if not max(rel) <= CALIB_TOL:
        raise AssertionError(f"card and CPU calibrations differ: "
                             f"{res['calibration_card_vs_cpu']}")
    return res


def bf16_card_vs_cpu(step, cpu_net, images, sizes, **step_options) -> dict:
    """The card's bf16 eval step and ``cpu_net``'s on ``images``: at least
    BF16_MATCH_SHARE of the detections, over all images, matched at
    BF16_MATCH_IOU with scores within BF16_MATCH_SCORE; the shares at other
    IoUs are recorded."""
    from ct_tpu_torch.config import VOC_300
    from ct_tpu_torch.eval import compare_detections, make_eval_step
    from ct_tpu_torch.ops.priors import prior_boxes

    cpu_step = make_eval_step(cpu_net, prior_boxes(VOC_300, "cpu"),
                              **step_options)
    cpu_dets = cpu_step(images, sizes)
    gpu_dets = step(images.cuda(), sizes.cuda())
    gpu_dets = type(gpu_dets)(*(t.cpu() for t in gpu_dets))
    shares, worst_ds = {}, 0.0
    for iou in (0.999, 0.99, BF16_MATCH_IOU, 0.95):
        matched = total = 0
        for i in range(len(images)):
            agree = compare_detections(gpu_dets, cpu_dets, image=i,
                                       iou_tol=iou,
                                       score_tol=BF16_MATCH_SCORE)
            matched += agree["matched"]
            total += max(agree["count_a"], agree["count_b"])
            worst_ds = max(worst_ds, agree["max_abs_dscore"])
        shares[str(iou)] = matched / max(total, 1)
    res = {"images": len(images), "detections": total,
           "matched_share": shares[str(BF16_MATCH_IOU)],
           "matched_share_at_iou": shares, "iou_tol": BF16_MATCH_IOU,
           "score_tol": BF16_MATCH_SCORE, "max_abs_dscore": worst_ds,
           "matched_share_floor": BF16_MATCH_SHARE}
    if not res["matched_share"] >= BF16_MATCH_SHARE:
        raise AssertionError(f"card and CPU bf16 detections differ: {res}")
    return res


def phase_bf16(seed: int, out_dir: str) -> dict:
    """``test.py --bf16`` on the card: the bf16 eval step at batch 8 on
    ``ref_model.pth`` (images/s, launches, a profile, card vs CPU on one
    image), the JAX bench's full serving config (int8 with the heads,
    bf16, approximate top-k 128 in a pool of 512) the same way, then the
    eval CLI on the 500 fixture images with ``--bf16`` (a reading) and with
    the full config (within MAP_TOL of the JAX package's record, and its
    detections against JAX's)."""
    import torch

    from ct_tpu_torch import test as eval_cli
    from ct_tpu_torch.config import VOC_300, resolve_task
    from ct_tpu_torch.eval import make_eval_step
    from ct_tpu_torch.models.convert import load_reference_pth
    from ct_tpu_torch.models.quantize import attach
    from ct_tpu_torch.models.rfbnet import build_net
    from ct_tpu_torch.ops.ct_attention import (
        ct_attention_cm, ct_attention_cm_bf16, ct_attention_serving,
        ct_attention_serving_bf16,
    )
    from ct_tpu_torch.ops.nms import nms_mask
    from ct_tpu_torch.ops.priors import prior_boxes
    from ct_tpu_torch.tools.diff_detections import diff

    bf = torch.bfloat16
    batch, steps = 8, 3
    task = resolve_task(2, "incre", "ours", "VOC")
    state = load_reference_pth(REF_MODEL)
    images = seeded_images(seed, batch, 300)
    sizes = torch.tensor([[375, 500]] * batch)
    priors = prior_boxes(VOC_300, "cuda")
    res = {}

    torch.cuda.reset_peak_memory_stats()
    net = build_net(task, 300, device="cuda", dtype=bf)
    net.load_state_dict(state)
    step = make_eval_step(net, priors)
    counts = {"ct_attention_cm_bf16": ct_attention_cm_bf16,
              "nms_mask": nms_mask, "ct_attention_cm": ct_attention_cm}
    expected = dict.fromkeys(counts, 1 + steps)
    expected["ct_attention_cm"] = 0       # bf16: the bf16 kernel only
    res["eval"] = eval_steps(step, images.cuda(), sizes.cuda(), counts,
                             expected, steps, out_dir, "profile_bf16.txt")
    cpu_net = build_net(task, 300, device="cpu", dtype=bf)
    cpu_net.load_state_dict(state)
    res["eval"]["card_vs_cpu"] = bf16_card_vs_cpu(step, cpu_net, images,
                                                  sizes)

    full = dict(top_k=128, approx_top_k=True, pool_size=512)
    torch.cuda.reset_peak_memory_stats()
    served, quant = eval_cli.serving_model(
        net, seeded_images(seed + 200, 8, 300), int8_heads=True)
    step = make_eval_step(served, priors, **full)
    counts = {"ct_attention_serving_bf16": ct_attention_serving_bf16,
              "nms_mask": nms_mask,
              "ct_attention_serving": ct_attention_serving}
    expected = dict.fromkeys(counts, 1 + steps)
    expected["ct_attention_serving"] = 0
    res["serving"] = eval_steps(step, images.cuda(), sizes.cuda(), counts,
                                expected, steps, out_dir,
                                "profile_bf16_serving.txt")
    res["serving"]["quantized_convs"] = len(quant)
    cpu_served = build_net(task, 300, device="cpu", fold_bn=True, dtype=bf)
    cpu_served.load_state_dict({k: v.cpu() for k, v in
                                served.state_dict().items()
                                if not k.endswith(QUANT_BUFFERS)})
    attach(cpu_served, quant)
    res["serving"]["card_vs_cpu"] = bf16_card_vs_cpu(
        step, cpu_served, images, sizes, **full)
    del net, served, cpu_net, cpu_served
    torch.cuda.empty_cache()

    os.environ["VOC_ROOT"] = VOC_ROOT
    kernels = {"ct_attention_cm_bf16": ct_attention_cm_bf16,
               "ct_attention_serving_bf16": ct_attention_serving_bf16,
               "nms_mask": nms_mask}
    for name, flags in (("voc500_bf16", ["--bf16"]),
                        ("voc500_full", BF16_FULL_FLAGS)):
        save = os.path.join(out_dir, name)
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with Captured(os.path.join(out_dir, name + ".txt")):
            scores = eval_cli.main([
                "-p", "2", "--setting", "incre", "--split", "1",
                "--load-file", REF_MODEL, "--save-folder", save] + flags)
        res[name] = {"seconds": time.perf_counter() - t0,
                     "mAP": scores["mAP"], "novel_mAP": scores["novel_mAP"],
                     "launches": {n: fn.launches
                                  for n, fn in kernels.items()}}
    ref_dir, ref_map, ref_novel = BF16_FULL_REF
    with open(os.path.join(".parity_p2", BF16_FULL_CPU_REF + ".json")) as f:
        cpu_ref = json.load(f)
    full_res = res["voc500_full"]
    dets = os.path.join(out_dir, "voc500_full", "inference",
                        "detections.pkl")
    full_res.update(
        tol=MAP_TOL, jax_tpu_mAP=ref_map, jax_tpu_novel_mAP=ref_novel,
        jax_cpu_mAP=cpu_ref["mAP"], jax_cpu_novel_mAP=cpu_ref["novel_mAP"],
        delta_tpu_mAP=full_res["mAP"] - ref_map,
        delta_tpu_novel_mAP=full_res["novel_mAP"] - ref_novel,
        delta_cpu_mAP=full_res["mAP"] - cpu_ref["mAP"],
        delta_cpu_novel_mAP=full_res["novel_mAP"] - cpu_ref["novel_mAP"],
        diff_tpu=diff(dets, os.path.join(".parity_p2", ref_dir, "inference",
                                         "detections.pkl")),
        diff_cpu=diff(dets, os.path.join(".parity_p2", BF16_FULL_CPU_REF,
                                         "inference", "detections.pkl")))
    if not (abs(full_res["delta_tpu_mAP"]) <= MAP_TOL
            and abs(full_res["delta_cpu_mAP"]) <= MAP_TOL
            and abs(full_res["delta_cpu_novel_mAP"]) <= MAP_TOL
            and full_res["launches"]["ct_attention_serving_bf16"] > 0
            and res["voc500_bf16"]["launches"]["ct_attention_cm_bf16"] > 0):
        raise AssertionError(f"the bf16 500-image evals: {res}")
    return res


def seeded_targets(seed: int, n: int, max_objs: int = 4) -> dict:
    """Padded targets of n images as the incre training set gives them:
    1-4 boxes per image in percent coordinates, labels 1..20, every object
    after the first ignored (-1), weight 1."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    boxes = np.tile(np.asarray([0, 0, 1, 1], np.float32), (n, max_objs, 1))
    labels = np.zeros((n, max_objs), np.int32)
    valid = np.zeros((n, max_objs), bool)
    for i in range(n):
        k = int(rng.integers(1, 5))
        mins = rng.uniform(0.0, 0.6, (k, 2))
        sizes = rng.uniform(0.1, 0.4, (k, 2))
        boxes[i, :k] = np.concatenate([mins, np.minimum(mins + sizes, 1.0)],
                                      1)
        labels[i, 0] = rng.integers(1, 21)
        labels[i, 1:k] = -1
        valid[i, :k] = True
    return {"boxes": torch.from_numpy(boxes),
            "labels": torch.from_numpy(labels),
            "weights": torch.from_numpy(valid.astype(np.float32)),
            "valid": torch.from_numpy(valid)}


def training_counts() -> dict:
    """The kernels a train step may launch, by name: float32, and the
    bf16 ones of the ``--bf16`` model."""
    from ct_tpu_torch.ops.ct_attention import (
        ct_attention_cm, ct_attention_cm_bf16, ct_attention_cm_bwd,
        ct_attention_cm_bwd_bf16, ct_attention_cm_bwd_flash,
        ct_attention_cm_bwd_flash_bf16, ct_attention_cm_stats,
        ct_attention_cm_stats_bf16,
    )
    from ct_tpu_torch.ops.pool_relu import (
        pool2x2_relu_bwd, pool2x2_relu_bwd_bf16, pool2x2_relu_fwd,
        pool2x2_relu_fwd_bf16,
    )

    return {fn.__name__: fn for fn in (
        ct_attention_cm, ct_attention_cm_stats, ct_attention_cm_bwd_flash,
        ct_attention_cm_bwd, pool2x2_relu_fwd, pool2x2_relu_bwd,
        ct_attention_cm_bf16, ct_attention_cm_stats_bf16,
        ct_attention_cm_bwd_flash_bf16, ct_attention_cm_bwd_bf16,
        pool2x2_relu_fwd_bf16, pool2x2_relu_bwd_bf16)}


def step_kernels(flash: bool, bf16: bool = False) -> tuple:
    """The kernels one train step launches once each: the CT attention's
    forward and backward (flash or blockwise) and conv1's pool, in the
    model's type."""
    used = (("ct_attention_cm_stats", "ct_attention_cm_bwd_flash") if flash
            else ("ct_attention_cm", "ct_attention_cm_bwd"))
    used += ("pool2x2_relu_fwd", "pool2x2_relu_bwd")
    return tuple(n + "_bf16" for n in used) if bf16 else used


def train_steps(step, train_state, batch, flash: bool, steps: int,
                accum: int = 1) -> dict:
    """1 warm-up and ``steps`` timed train steps on the card with the CT
    attention's flash or blockwise backward: images/s from the median
    step, finite losses, peak memory, and the launches of the training
    kernels over them, which must be those of the chosen backward in the
    model's type, ``accum`` a step (one a micro-batch)."""
    import torch

    train_state.model.ct_flash = flash
    counts = training_counts()
    torch.cuda.reset_peak_memory_stats()
    for fn in counts.values():
        fn.launches = 0
    times, losses = [], []
    for _ in range(1 + steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(train_state, batch)
        losses.append({k: float(v) for k, v in out.items()})
        times.append(time.perf_counter() - t0)
    launches = {name: fn.launches for name, fn in counts.items()}
    used = step_kernels(flash, train_state.model.dtype == torch.bfloat16)
    expected = {name: accum * (1 + steps) if name in used else 0
                for name in counts}
    if launches != expected:
        raise AssertionError(f"launches over {1 + steps} train steps: "
                             f"{launches}, expected {expected}")
    if not all(math.isfinite(v) for row in losses for v in row.values()):
        raise AssertionError(f"non-finite train losses: {losses}")
    median_s = sorted(times[1:])[steps // 2]
    n = batch["image"].shape[0]
    return {"backward": "flash" if flash else "blockwise", "batch": n,
            "accum_steps": accum,
            "dtype": str(train_state.model.dtype).replace("torch.", ""),
            "warmup_s": times[0], "step_s": times[1:],
            "images_per_s": n / median_s, "launches": launches,
            "losses": losses,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def phase_train(seed: int, out_dir: str) -> dict:
    import torch

    from ct_tpu_torch.config import VOC_300, resolve_task
    from ct_tpu_torch.models.convert import load_reference_pth
    from ct_tpu_torch.models.rfbnet import build_net
    from ct_tpu_torch.ops.priors import prior_boxes
    from ct_tpu_torch.train.reweight import init_reweight
    from ct_tpu_torch.train.solver import SolverConfig, build_optimizer
    from ct_tpu_torch.train.step import (
        TrainState, make_train_step,
    )

    batch, steps = TRAIN_BATCH, TRAIN_STEPS
    task = resolve_task(2, "incre", "ours", "VOC")
    state = load_reference_pth(REF_MODEL)
    dev = torch.device("cuda")
    batches = [dict(seeded_targets(seed + i, batch),
                    image=seeded_images(seed + i, batch, 300))
               for i in range(3)]
    on_card = [{k: v.to(dev) for k, v in b.items()} for b in batches]
    priors = prior_boxes(VOC_300, dev)

    net = build_net(task, 300, device=dev)
    net.load_state_dict(state)

    class Batches:   # init_reweight's loader: the first two batches
        def __init__(self):
            self.left = list(on_card[:2])

        def next(self):
            return self.left.pop(0)

    t0 = time.perf_counter()
    init_reweight(net, Batches(), priors, task, init_iter=2)
    torch.cuda.synchronize()
    res = {"init_reweight_s": time.perf_counter() - t0}

    # the CLI's solver defaults
    optimizer, scheduler = build_optimizer(net, task, SolverConfig())
    train_state = TrainState(net, optimizer, scheduler)
    step = make_train_step(priors)
    res.update(train_steps(step, train_state, on_card[2], True, steps))
    res["profile"] = profile_step(lambda: step(train_state, on_card[2]),
                                  out_dir, "profile_train.txt")
    res["card_vs_cpu"] = card_vs_cpu(task, net, batches[2], priors)

    # CT_ATTENTION_FLASH=0: the blockwise backward against the flash one
    # from the same state on the same batch, then its own timed steps
    res["blockwise_vs_flash"] = blockwise_vs_flash(net, on_card[2], priors)
    res["blockwise"] = train_steps(step, train_state, on_card[2], False,
                                   steps)
    net.ct_flash = True
    return res


def blockwise_vs_flash(net, batch, priors) -> dict:
    """One loss-and-gradients call with each backward from the same state
    and batch on the card (the blockwise one on the anchors the flash one
    mined): losses to BLOCKWISE_LOSS_RTOL, the CT head's gradients to
    ‖Δ‖₂ ≤ BLOCKWISE_CT_GRAD_TOL·‖g‖₂, the rest to TRAIN_GRAD_TOL."""
    from ct_tpu_torch.train.step import LOSS_KEYS, loss_and_grads

    net.ct_flash = True
    flash, mask = loss_and_grads(net, batch, priors)
    flash_grads = {n: p.grad.clone() for n, p in net.named_parameters()}
    net.ct_flash = False
    blockwise, _ = loss_and_grads(net, batch, priors, mask=mask)
    rows = []
    for name, p in net.named_parameters():
        ref = flash_grads[name]
        norm = ref.norm().item()
        rel = (p.grad - ref).norm().item() / max(norm, TRAIN_GRAD_FLOOR)
        ct = name.startswith(CT_PARAMS)
        rows.append((rel, name, ct,
                     BLOCKWISE_CT_GRAD_TOL if ct else TRAIN_GRAD_TOL))
    rows.sort(reverse=True)
    loss_rel = {k: abs(blockwise[k].item() - flash[k].item())
                / abs(flash[k].item()) for k in LOSS_KEYS}
    ct_rows = [r for r in rows if r[2]]
    res = {"loss_rel_err": loss_rel, "loss_rtol": BLOCKWISE_LOSS_RTOL,
           "ct_grads": {r[1]: r[0] for r in ct_rows},
           "ct_grad_tol": BLOCKWISE_CT_GRAD_TOL,
           "worst_other_grad": next((r[:2] for r in rows if not r[2]), None),
           "other_grad_tol": TRAIN_GRAD_TOL}
    if not (max(loss_rel.values()) <= BLOCKWISE_LOSS_RTOL
            and all(r[0] <= r[3] for r in rows) and len(ct_rows) == 8):
        raise AssertionError(f"the blockwise train step disagrees with the "
                             f"flash one: {res}")
    return res


def phase_transfer(seed: int) -> dict:
    """Phase-2 transfer (C=60 source classes) train steps at batch 64 from
    seeded weights, with the flash and with the blockwise backward."""
    import torch

    from ct_tpu_torch.config import VOC_300, resolve_task
    from ct_tpu_torch.models.rfbnet import build_net
    from ct_tpu_torch.ops.priors import prior_boxes
    from ct_tpu_torch.train.solver import SolverConfig, build_optimizer
    from ct_tpu_torch.train.step import TrainState, make_train_step

    task = resolve_task(2, "transfer", "ours", "VOC")
    dev = torch.device("cuda")
    batch = dict(seeded_targets(seed + 50, TRAIN_BATCH),
                 image=seeded_images(seed + 50, TRAIN_BATCH, 300))
    batch = {k: v.to(dev) for k, v in batch.items()}
    torch.manual_seed(seed)
    net = build_net(task, 300, device=dev)
    optimizer, scheduler = build_optimizer(net, task, SolverConfig())
    train_state = TrainState(net, optimizer, scheduler)
    step = make_train_step(prior_boxes(VOC_300, dev))
    res = {"classes": task.src_cls_dim}
    for flash in (True, False):
        res["flash" if flash else "blockwise"] = train_steps(
            step, train_state, batch, flash, TRAIN_STEPS)
    return res


def grads_of(net) -> dict:
    return {n: p.grad.detach().float().cpu().clone()
            for n, p in net.named_parameters()}


def bf16_effect_check(label, grads, ref16, ref32, names=None) -> dict:
    """bf16 gradients ``grads`` against ``ref16`` (the same function in
    bf16 elsewhere) by the bf16 effect ‖ref16 − ref32‖ (ref32 the float32
    gradients from the same state and anchors), each taken as one vector
    (the update the optimizer applies; ``bf16_span``): ‖grads − ref16‖
    within BF16_EFFECT_SHARE of it; each tensor within BF16_TENSOR_SHARE of
    its own effect or BF16_TENSOR_FLOOR of the whole vector's. ``names``
    restricts it to those parameters."""
    res = bf16_span(grads, ref16, ref32, names)
    effect = res["effect_norm"]
    rows = []
    for n in ref32:
        if names is not None and not n.startswith(names):
            continue
        eff = (ref16[n] - ref32[n]).norm().item()
        d = (grads[n] - ref16[n]).norm().item()
        band = max(BF16_TENSOR_SHARE * eff, BF16_TENSOR_FLOOR * effect)
        rows.append((d / band, n, d, eff))
    rows.sort(reverse=True)
    res.update(worst_tensors=[(n, r, d, e) for r, n, d, e in rows[:6]],
               share=BF16_EFFECT_SHARE, tensor_share=BF16_TENSOR_SHARE,
               tensor_floor=BF16_TENSOR_FLOOR)
    res["ok"] = bool(res["to_bf16_over_effect"] <= BF16_EFFECT_SHARE
                     and rows[0][0] <= 1.0)
    if not res["ok"]:
        raise AssertionError(f"{label}: bf16 gradients beyond their band: "
                             f"{res}")
    return res


def grad_distance(a, b, names=None) -> float:
    """‖a − b‖ over the parameters (or those of ``names``) as one vector."""
    import torch

    keys = [n for n in b if names is None or n.startswith(names)]
    return torch.cat([(a[n] - b[n]).reshape(-1) for n in keys]).norm().item()


def bf16_span(grads, ref16, ref32, names=None) -> dict:
    """The distances of ``grads`` to ``ref16`` and to ``ref32``, each
    parameter vector (or those of ``names``) taken as one, over the bf16
    effect ‖ref16 − ref32‖."""
    effect = grad_distance(ref16, ref32, names)
    return {"effect_norm": effect,
            "to_bf16_over_effect": grad_distance(grads, ref16, names) / effect,
            "to_f32_over_effect": grad_distance(grads, ref32, names) / effect}


def bf16_card_vs_cpu_train(task, net, batch, priors) -> dict:
    """The bf16 model's loss and gradients at batch 2 on the card against
    the same bf16 model on the CPU, on the anchors the CPU mined, by what
    bf16 moves the CPU's result (its float32 model on the same anchors):
    the bands of BF16_F32_SPAN and BF16_CARD_CPU_SPAN for the whole
    gradient and the CT head's; each loss within BF16_CARD_CPU_SPAN of its
    effect or TRAIN_LOSS_RTOL of L. A reading beside it: the same on the
    card with the CT attention's plain bf16 versions in place of its
    kernels."""
    import torch

    from ct_tpu_torch.config import VOC_300
    from ct_tpu_torch.models.rfbnet import build_net
    from ct_tpu_torch.ops import ct_attention as cta
    from ct_tpu_torch.ops.priors import prior_boxes
    from ct_tpu_torch.train.step import LOSS_KEYS, loss_and_grads

    state = {k: v.cpu() for k, v in net.state_dict().items()}
    mini = {k: v[:2].cpu() for k, v in batch.items()}
    cpu_priors = prior_boxes(VOC_300, "cpu")
    out = {}
    mask = None
    for key, dt in (("cpu16", torch.bfloat16), ("cpu32", torch.float32)):
        cpu_net = build_net(task, 300, device="cpu", dtype=dt)
        cpu_net.load_state_dict(state)
        losses, m = loss_and_grads(cpu_net, mini, cpu_priors, mask=mask)
        mask = m if mask is None else mask
        out[key] = ({k: losses[k].item() for k in LOSS_KEYS},
                    grads_of(cpu_net))
        del cpu_net
    mini_card = {k: v.to(priors.device) for k, v in mini.items()}
    card_losses, _ = loss_and_grads(net, mini_card, priors,
                                    mask=mask.to(priors.device))
    card_losses = {k: card_losses[k].item() for k in LOSS_KEYS}
    card = grads_of(net)
    # the reading: the plain bf16 CT versions on the card's tensors
    device_of = cta._device
    cta._device = lambda name, t: "cpu"
    try:
        loss_and_grads(net, mini_card, priors, mask=mask.to(priors.device))
    finally:
        cta._device = device_of
    plain_ct = grads_of(net)
    ref16, ref32 = out["cpu16"][1], out["cpu32"][1]
    loss_rows = {k: (abs(card_losses[k] - out["cpu16"][0][k]),
                     max(BF16_CARD_CPU_SPAN * abs(out["cpu16"][0][k]
                                                  - out["cpu32"][0][k]),
                         TRAIN_LOSS_RTOL * abs(out["cpu16"][0][k])))
                 for k in LOSS_KEYS}
    res = {"batch": 2, "anchors_counted": int(mask.sum().item()),
           "losses": {"card16": card_losses, "cpu16": out["cpu16"][0],
                      "cpu32": out["cpu32"][0]},
           "loss_err_and_band": loss_rows,
           "all": bf16_span(card, ref16, ref32),
           "ct": bf16_span(card, ref16, ref32, CT_PARAMS),
           "plain_ct_reading": {
               "all": bf16_span(plain_ct, ref16, ref32),
               "ct": bf16_span(plain_ct, ref16, ref32, CT_PARAMS),
               # the card's kernels against their plain versions on the
               # card, over the same effect
               "kernels_to_plain_over_effect": {
                   v: grad_distance(card, plain_ct, names)
                   / grad_distance(ref16, ref32, names)
                   for v, names in (("all", None), ("ct", CT_PARAMS))}},
           "f32_span": BF16_F32_SPAN, "card_cpu_span": BF16_CARD_CPU_SPAN}
    lo, hi = BF16_F32_SPAN
    if not (all(e <= b for e, b in loss_rows.values())
            and all(lo <= res[v]["to_f32_over_effect"] <= hi
                    and res[v]["to_bf16_over_effect"] <= BF16_CARD_CPU_SPAN
                    for v in ("all", "ct"))):
        raise AssertionError(f"bf16 card and CPU train losses or gradients "
                             f"differ beyond their bands: {res}")
    return res


def bf16_blockwise_vs_flash(net, net32, batch, priors) -> dict:
    """The bf16 model's loss and gradients on the card with the blockwise
    backward against the flash one, from the same state on the anchors the
    flash one mined (the float32 model ``net32`` on them gives the bf16
    effect): losses to BLOCKWISE_LOSS_RTOL (the same forward walk), the CT
    head's gradients and all of them each as one vector within
    BF16_EFFECT_SHARE of the bf16 effect: the two backwards round at other
    points (JAX's flash and blockwise kernels do), a difference of the
    order of bf16 rounding itself."""
    from ct_tpu_torch.train.step import LOSS_KEYS, loss_and_grads

    net.ct_flash = True
    flash, mask = loss_and_grads(net, batch, priors)
    flash_grads = grads_of(net)
    net.ct_flash = False
    blockwise, _ = loss_and_grads(net, batch, priors, mask=mask)
    blockwise_grads = grads_of(net)
    net.ct_flash = True
    loss_and_grads(net32, dict(batch, image=batch["image"].float()), priors,
                   mask=mask)
    ref32 = grads_of(net32)
    net32.zero_grad(set_to_none=True)
    loss_rel = {k: abs(blockwise[k].item() - flash[k].item())
                / abs(flash[k].item()) for k in LOSS_KEYS}
    res = {"loss_rel_err": loss_rel, "loss_rtol": BLOCKWISE_LOSS_RTOL,
           "ct": bf16_effect_check("bf16 blockwise vs flash, CT head",
                                   blockwise_grads, flash_grads, ref32,
                                   CT_PARAMS),
           "all": bf16_effect_check("bf16 blockwise vs flash",
                                    blockwise_grads, flash_grads, ref32)}
    if not max(loss_rel.values()) <= BLOCKWISE_LOSS_RTOL:
        raise AssertionError(f"the bf16 blockwise train step's losses "
                             f"disagree with the flash one's: {res}")
    return res


def phase_train_bf16(seed: int, out_dir: str) -> dict:
    """``train.py --bf16`` on the card: the phase-2 incre model
    (``ref_model.pth``) in bf16, ``init_reweight`` over 2 batches, 1
    warm-up and 3 timed steps at batch 64 with the flash backward (the bf16
    kernels' launches, a profile), card vs CPU at batch 2 by the bf16
    effect, blockwise vs flash, 1 + 3 blockwise steps; then phase-2
    transfer (C=60) from seeded weights in bf16, flash and blockwise."""
    import torch

    from ct_tpu_torch.config import VOC_300, resolve_task
    from ct_tpu_torch.models.convert import load_reference_pth
    from ct_tpu_torch.models.rfbnet import build_net
    from ct_tpu_torch.ops.priors import prior_boxes
    from ct_tpu_torch.train.reweight import init_reweight
    from ct_tpu_torch.train.solver import SolverConfig, build_optimizer
    from ct_tpu_torch.train.step import TrainState, make_train_step

    bf = torch.bfloat16
    task = resolve_task(2, "incre", "ours", "VOC")
    dev = torch.device("cuda")
    batches = [dict(seeded_targets(seed + 30 + i, TRAIN_BATCH),
                    image=seeded_images(seed + 30 + i, TRAIN_BATCH, 300))
               for i in range(3)]
    on_card = [{k: v.to(dev) for k, v in b.items()} for b in batches]
    priors = prior_boxes(VOC_300, dev)
    net = build_net(task, 300, device=dev, dtype=bf)
    net.load_state_dict(load_reference_pth(REF_MODEL))

    class Batches:   # init_reweight's loader, images in bf16 as on the
        def __init__(self):   # device-augment route
            self.left = [dict(b, image=b["image"].to(bf))
                         for b in on_card[:2]]

        def next(self):
            return self.left.pop(0)

    t0 = time.perf_counter()
    init_reweight(net, Batches(), priors, task, init_iter=2)
    torch.cuda.synchronize()
    res = {"init_reweight_s": time.perf_counter() - t0}
    optimizer, scheduler = build_optimizer(net, task, SolverConfig())
    train_state = TrainState(net, optimizer, scheduler)
    step = make_train_step(priors)
    batch = dict(on_card[2], image=on_card[2]["image"].to(bf))
    res.update(train_steps(step, train_state, batch, True, TRAIN_STEPS))
    res["profile"] = profile_step(lambda: step(train_state, batch), out_dir,
                                  "profile_train_bf16.txt",
                                  names=BF16_BWD_KERNELS[:2]
                                  + BF16_BWD_KERNELS[4:]
                                  + ("ct_attention_bf16_kernel",
                                     "pool2x2_relu"))
    res["card_vs_cpu"] = bf16_card_vs_cpu_train(task, net, batches[2],
                                                priors)
    net32 = build_net(task, 300, device=dev).train()
    net32.load_state_dict(net.state_dict())
    res["blockwise_vs_flash"] = bf16_blockwise_vs_flash(net, net32, batch,
                                                        priors)
    del net32
    res["blockwise"] = train_steps(step, train_state, batch, False,
                                   TRAIN_STEPS)
    net.ct_flash = True
    del net, train_state, optimizer
    torch.cuda.empty_cache()

    # transfer (C=60, padded to 64 in the kernels) from seeded weights
    task = resolve_task(2, "transfer", "ours", "VOC")
    tbatch = dict(seeded_targets(seed + 50, TRAIN_BATCH),
                  image=seeded_images(seed + 50, TRAIN_BATCH, 300).to(bf))
    tbatch = {k: v.to(dev) for k, v in tbatch.items()}
    torch.manual_seed(seed)
    net = build_net(task, 300, device=dev, dtype=bf)
    optimizer, scheduler = build_optimizer(net, task, SolverConfig())
    train_state = TrainState(net, optimizer, scheduler)
    res["transfer"] = {"classes": task.src_cls_dim}
    for flash in (True, False):
        res["transfer"]["flash" if flash else "blockwise"] = train_steps(
            step, train_state, tbatch, flash, TRAIN_STEPS)
    return res


def to_cpu(params):
    """A parameter record of ``data/augment_device.py`` with its tensors on
    the CPU."""
    import dataclasses

    return dataclasses.replace(params, **{
        f.name: getattr(params, f.name).cpu()
        for f in dataclasses.fields(params)})


def augment_card_vs_cpu(seed: int, bf16: bool = False) -> dict:
    """The device augmentation and mixup at batch 64 on the card against
    the same apply functions on the CPU, from the parameters drawn on the
    card; and their ms per batch on the card (CUDA events). With ``bf16``
    the images come out in bf16 (``--bf16``), held to one bf16 step of
    the largest |value| (the f32 images' band, 2e-3, then one rounding
    that may go the other way) with at most AUGMENT_BF16_SHARE of them a
    step apart; mixup blends them in float32 and emits bf16."""
    import numpy as np
    import torch

    from ct_tpu_torch.data import augment_device as D

    b, canvas = TRAIN_BATCH, 384
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.integers(0, 256, (b, 3, canvas, canvas),
                                           dtype=np.uint8))
    cpu = seeded_targets(seed + 70, b)
    card = {k: v.cuda() for k, v in cpu.items()}
    card_images = images.cuda()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out_dtype = torch.bfloat16 if bf16 else None
    photo, geom = D.sample_augment(gen, card["boxes"], card["valid"])
    out = D.apply_augment(card_images, card["boxes"], card["labels"],
                          card["valid"], photo, geom, out_dtype=out_dtype)
    ref = D.apply_augment(images, cpu["boxes"], cpu["labels"], cpu["valid"],
                          to_cpu(photo), to_cpu(geom), out_dtype=out_dtype)
    img_diff = (out["image"].cpu().float() - ref["image"].float()).abs()
    res = {"batch": b, "canvas": canvas, "dtype": str(out["image"].dtype),
           "image_max_abs_err": img_diff.max().item(),
           "image_differing_share": (img_diff > 0).float().mean().item(),
           "box_max_abs_err": (out["boxes"].cpu() - ref["boxes"]).abs()
           .max().item(),
           "valid_equal": torch.equal(out["valid"].cpu(), ref["valid"]),
           "boxes_kept": int(ref["valid"].sum()),
           "boxes_in": int(cpu["valid"].sum())}
    lam, offset = D.sample_mixup(np.random.default_rng(seed), b)
    mixed = D.apply_mixup(dict({k: v.cuda() for k, v in ref.items()},
                               weights=card["weights"]),
                          torch.from_numpy(lam).cuda(), offset, True)
    mixed_ref = D.apply_mixup(dict(ref, weights=cpu["weights"]),
                              torch.from_numpy(lam), offset, True)
    res["mixup_max_abs_err"] = max(
        (mixed[k].cpu().float() - mixed_ref[k].float()).abs().max().item()
        / (255.0 if k == "image" else 1.0) for k in mixed)
    res["augment_ms"] = cuda_ms(lambda: D.augment_batch(
        gen, card_images, card["boxes"], card["labels"], card["valid"],
        out_dtype=out_dtype), 5)
    batch = dict(out, weights=card["weights"])
    res["mixup_ms"] = cuda_ms(lambda: D.mixup_batch(
        np.random.default_rng(seed), batch, zero_ignored=True), 5)
    img_tol = AUGMENT_IMG_TOL
    if bf16:
        from ct_tpu_torch.ops.ct_attention import bf16_step

        img_tol = bf16_step(ref["image"].float().abs().max().item())
        res["image_tol"] = img_tol
        if not (res["image_differing_share"] <= AUGMENT_BF16_SHARE
                and mixed["image"].dtype == torch.bfloat16):
            raise AssertionError(f"the bf16 device augmentation on the card "
                                 f"disagrees with the CPU: {res}")
    if not (res["image_max_abs_err"] <= img_tol
            and res["box_max_abs_err"] <= AUGMENT_BOX_TOL
            and res["valid_equal"] and res["mixup_max_abs_err"] <= MIXUP_TOL
            and torch.equal(out["labels"].cpu(), ref["labels"])):
        raise AssertionError(f"the device augmentation on the card "
                             f"disagrees with the CPU: {res}")
    return res


class Captured:
    """Standard output, and the logging the port's CLIs set up on it, into
    ``path`` for the enclosed block; the CLIs' log handlers are closed
    after it."""

    def __init__(self, path: str):
        self.path = path

    def __enter__(self):
        import contextlib

        self.file = open(self.path, "w")
        self.redirect = contextlib.redirect_stdout(self.file)
        self.redirect.__enter__()
        return self

    def __exit__(self, *exc):
        import logging

        self.redirect.__exit__(*exc)
        for handler in logging.root.handlers[:]:
            logging.root.removeHandler(handler)
            handler.close()
        self.file.close()


def phase_train_cli(seed: int, out_dir: str) -> dict:
    """Phase-2 training through the train CLI on the VOC fixture with the
    device augmentation and mixup, its 500-image eval through the eval
    CLI, and the pipeline bench; the augmentation on the card against the
    CPU first."""
    import json

    from ct_tpu_torch import test as eval_cli
    from ct_tpu_torch.ops.ct_attention import ct_attention_cm
    from ct_tpu_torch.ops.nms import nms_mask
    from ct_tpu_torch.scripts import bench_pipeline
    from ct_tpu_torch.train import cli as train_cli

    res = {"augment_card_vs_cpu": augment_card_vs_cpu(seed),
           "augment_card_vs_cpu_bf16": augment_card_vs_cpu(seed + 1,
                                                           bf16=True)}
    save = os.path.join(out_dir, "train_cli")
    if os.path.exists(save):
        import shutil

        shutil.rmtree(save)
    os.makedirs(save)
    os.environ["VOC_ROOT"] = VOC_ROOT
    counts = training_counts()
    for fn in counts.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with Captured(os.path.join(out_dir, "train_cli_train.txt")):
        last = train_cli.main([
            "-p", "2", "--setting", "incre", "--split", "1", "--shot", "5",
            "--device-augment", "--mixup", "-b", str(TRAIN_BATCH),
            "--init-iter", "2", "--max-iter", str(TRAIN_CLI_ITERS),
            "--no-mixup-iter", "6", "--warmup-iter", "0", "--steps", "20",
            "--load-file", REF_MODEL,
            "--save-folder", save])
    res["train_s"] = time.perf_counter() - t0
    res["train_launches"] = {n: fn.launches for n, fn in counts.items()}
    used = step_kernels(True)
    with open(os.path.join(save, "metrics.json")) as f:
        rows = [json.loads(line) for line in f]
    res["last"] = last
    res["metrics_rows"] = rows
    if not (all(res["train_launches"][n] > 0 for n in used)
            and [r["iteration"] for r in rows] == [21, TRAIN_CLI_ITERS]
            and all(math.isfinite(v) for r in rows + [last]
                    for v in r.values())):
        raise AssertionError(f"the train CLI run is wrong: {res}")
    res["iteration_s_median"] = rows[-1]["time"]
    res["loader_wait_s_median"] = rows[-1]["data_time"]
    res["images_per_s"] = TRAIN_BATCH / rows[-1]["time"]

    eval_counts = {"ct_attention_cm": ct_attention_cm, "nms_mask": nms_mask}
    for fn in eval_counts.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with Captured(os.path.join(out_dir, "train_cli_eval.txt")):
        scores = eval_cli.main([
            "-p", "2", "--setting", "incre", "--split", "1",
            "--load-file", os.path.join(save, "model_final.pth"),
            "--save-folder", save])
    res["eval_s"] = time.perf_counter() - t0
    res["eval_launches"] = {n: fn.launches for n, fn in eval_counts.items()}
    res["mAP"], res["novel_mAP"] = scores["mAP"], scores["novel_mAP"]
    if not (scores["mAP"] > TRAIN_CLI_MAP_FLOOR
            and all(res["eval_launches"].values())):
        raise AssertionError(f"the trained model's eval is wrong: {res}")

    with Captured(os.path.join(out_dir, "bench_pipeline.txt")):
        res["bench_pipeline"] = bench_pipeline.main(["--iters", "5",
                                                     "--mixup"])

    # train.py --bf16 through the CLI: the bf16 model and kernels, the
    # augmentation's bf16 images, mixup on them
    res["bf16"] = train_cli_bf16(out_dir)
    return res


def train_cli_bf16(out_dir: str) -> dict:
    """``python -m ct_tpu_torch.train --bf16 --device-augment --mixup`` for
    TRAIN_CLI_BF16_ITERS iterations at batch 64 from ``ref_model.pth``
    (mixup off for the last 2): finite losses, a ``metrics.json`` row at
    the last iteration, the launches of the bf16 training kernels (and
    none of the float32 ones), its iteration time."""
    import json

    from ct_tpu_torch.train import cli as train_cli

    save = os.path.join(out_dir, "train_cli_bf16")
    if os.path.exists(save):
        import shutil

        shutil.rmtree(save)
    os.makedirs(save)
    counts = training_counts()
    for fn in counts.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with Captured(os.path.join(out_dir, "train_cli_bf16.txt")):
        last = train_cli.main([
            "-p", "2", "--setting", "incre", "--split", "1", "--shot", "5",
            "--bf16", "--device-augment", "--mixup", "-b", str(TRAIN_BATCH),
            "--init-iter", "2", "--max-iter", str(TRAIN_CLI_BF16_ITERS),
            "--no-mixup-iter", "2", "--warmup-iter", "0", "--steps", "20",
            "--load-file", REF_MODEL, "--save-folder", save])
    res = {"train_s": time.perf_counter() - t0, "last": last,
           "launches": {n: fn.launches for n, fn in counts.items()}}
    with open(os.path.join(save, "metrics.json")) as f:
        res["metrics_rows"] = [json.loads(line) for line in f]
    # each iteration's step; the 2 OBJ_Target init batches run the train-
    # mode forward without a gradient (conv1's pool, the eval attention)
    init = {"pool2x2_relu_fwd_bf16": 2, "ct_attention_cm_bf16": 2}
    expected = {n: TRAIN_CLI_BF16_ITERS + init.get(n, 0)
                if n in step_kernels(True, bf16=True) else init.get(n, 0)
                for n in counts}
    if not (res["launches"] == expected
            and [r["iteration"] for r in res["metrics_rows"]]
            == [TRAIN_CLI_BF16_ITERS]
            and all(math.isfinite(v) for r in res["metrics_rows"] + [last]
                    for v in r.values())):
        raise AssertionError(f"the bf16 train CLI run is wrong: {res}")
    res["images_per_s"] = TRAIN_BATCH / res["metrics_rows"][-1]["time"]
    return res


def coco_train_cli(save: str, flags, iters: int, used) -> dict:
    """``python -m ct_tpu_torch.train -d COCO -p 1 --setting transfer`` for
    ``iters`` iterations at batch 64 from the seeded init (no basenet), in
    the first iterations of the CLI's warm-up, with ``flags``: finite losses, one ``metrics.json`` row at the last
    iteration, each kernel of ``used`` (conv1's pool) launched once an
    iteration and the other training kernels never, the iteration time
    and loader wait of that row."""
    import json
    import shutil

    from ct_tpu_torch.train import cli as train_cli

    if os.path.exists(save):
        shutil.rmtree(save)
    os.makedirs(save)
    counts = training_counts()
    for fn in counts.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with Captured(save + ".txt"):
        last = train_cli.main([
            "-d", "COCO", "-p", "1", "--setting", "transfer",
            "-b", str(TRAIN_BATCH), "--max-iter", str(iters),
            "--save-folder", save] + flags)
    res = {"flags": flags, "train_s": time.perf_counter() - t0,
           "last": last,
           "launches": {n: fn.launches for n, fn in counts.items()}}
    with open(os.path.join(save, "metrics.json")) as f:
        res["metrics_rows"] = [json.loads(line) for line in f]
    expected = {n: iters if n in used else 0 for n in counts}
    if not (res["launches"] == expected
            and [r["iteration"] for r in res["metrics_rows"]] == [iters]
            and all(math.isfinite(v) for r in res["metrics_rows"] + [last]
                    for v in r.values())):
        raise AssertionError(f"the COCO train CLI run is wrong: {res}")
    row = res["metrics_rows"][-1]
    res.update(iteration_s_median=row["time"],
               loader_wait_s_median=row["data_time"],
               images_per_s=TRAIN_BATCH / row["time"])
    return res


def phase_coco(out_dir: str) -> dict:
    """COCO data and the host native layer on the card: the COCO-60 fixture
    built afresh, the evaluator against the JAX package's record,
    phase-1 COCO-60 training through the train CLI (f32 with the host
    augmentation in worker processes, then bf16 with the device
    augmentation), the COCO eval of the f32 model, and ``--host-nms``
    against the card's NMS on the 500 VOC fixture images."""
    import json
    import pickle
    import shutil

    from ct_tpu_torch import test as eval_cli
    from ct_tpu_torch.data.coco import COCODetection
    from ct_tpu_torch.ops.ct_attention import ct_attention_cm
    from ct_tpu_torch.ops.nms import nms_mask
    from ct_tpu_torch.tools.coco_fixture import make_coco60
    from ct_tpu_torch.tools.diff_detections import diff

    # a fresh tree: the roidb cache is keyed by the split's name only
    if os.path.exists(COCO_DIR):
        shutil.rmtree(COCO_DIR)
    t0 = time.perf_counter()
    make_coco60(COCO_DIR, *COCO_FIXTURE)
    res = {"fixture_s": time.perf_counter() - t0}

    t0 = time.perf_counter()
    with open(os.path.join(COCO_RECORD, "inference", "detections.pkl"),
              "rb") as f:
        all_boxes = pickle.load(f)
    with open(COCO_RECORD + ".json") as f:
        record = json.load(f)
    scored = COCODetection(COCO_DIR, [("2014", "split_nonvoc_minival")]
                           ).evaluate_detections(
        all_boxes, os.path.join(out_dir, "coco_record"))
    deltas = {k: 0.0 if math.isnan(v) and math.isnan(scored[k])
              else abs(scored[k] - v) for k, v in record.items()}
    res["evaluator"] = {"seconds": time.perf_counter() - t0,
                        "AP": scored["AP"], "AP50": scored["AP50"],
                        "keys": len(record), "max_abs_delta":
                        max(deltas.values())}
    if set(scored) != set(record) or max(deltas.values()) > COCO_EVAL_TOL:
        raise AssertionError(f"the COCO evaluator misses the JAX record: "
                             f"{deltas}")

    os.environ["COCO_ROOT"] = COCO_DIR
    save = os.path.join(out_dir, "coco_train")
    res["train"] = coco_train_cli(
        save, ["--worker-type", "process", "--num-workers",
               str(COCO_WORKERS)], COCO_TRAIN_ITERS,
        ("pool2x2_relu_fwd", "pool2x2_relu_bwd"))
    res["train_bf16"] = coco_train_cli(
        os.path.join(out_dir, "coco_train_bf16"),
        ["--bf16", "--device-augment"], COCO_BF16_ITERS,
        ("pool2x2_relu_fwd_bf16", "pool2x2_relu_bwd_bf16"))

    nms_mask.launches = 0
    t0 = time.perf_counter()
    with Captured(os.path.join(out_dir, "coco_eval.txt")):
        scores = eval_cli.main([
            "-d", "COCO", "-p", "1", "--setting", "transfer",
            "--load-file", os.path.join(save, "model_final.pth"),
            "--save-folder", save])
    res["eval"] = {"seconds": time.perf_counter() - t0,
                   "nms_mask_launches": nms_mask.launches,
                   **{k: v for k, v in scores.items()
                      if not k.startswith("AP-")}}
    if not (nms_mask.launches > 0 and all(
            0 <= scores[k] <= 1 or scores[k] == -1 for k in ("AP", "AP50"))):
        raise AssertionError(f"the COCO eval is wrong: {res['eval']}")

    # --host-nms against the card's NMS: ref_model.pth, 500 VOC images
    os.environ["VOC_ROOT"] = VOC_ROOT
    kernels = {"ct_attention_cm": ct_attention_cm, "nms_mask": nms_mask}
    for name, flags in (("voc500_card_nms", []),
                        ("voc500_host_nms", ["--host-nms"])):
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with Captured(os.path.join(out_dir, name + ".txt")):
            scores = eval_cli.main([
                "-p", "2", "--setting", "incre", "--split", "1",
                "--load-file", REF_MODEL,
                "--save-folder", os.path.join(out_dir, name)] + flags)
        res[name] = {"seconds": time.perf_counter() - t0,
                     "mAP": scores["mAP"], "novel_mAP": scores["novel_mAP"],
                     "launches": {n: fn.launches
                                  for n, fn in kernels.items()}}
    host = res["voc500_host_nms"]
    ref_map, ref_novel = HOST_NMS_REF
    host.update(
        tol=MAP_TOL, jax_mAP=ref_map, jax_novel_mAP=ref_novel,
        reference_stack_mAP=HOST_NMS_REFERENCE_STACK[0],
        reference_stack_novel_mAP=HOST_NMS_REFERENCE_STACK[1],
        delta_mAP=host["mAP"] - ref_map,
        delta_novel_mAP=host["novel_mAP"] - ref_novel,
        vs_card_nms=diff(
            os.path.join(out_dir, "voc500_card_nms", "inference",
                         "detections.pkl"),
            os.path.join(out_dir, "voc500_host_nms", "inference",
                         "detections.pkl"), iou_thr=HOST_NMS_IOU))
    band = host["vs_card_nms"]
    if not (abs(host["delta_mAP"]) <= MAP_TOL
            and abs(host["delta_novel_mAP"]) <= MAP_TOL
            and band["match_rate"] > HOST_NMS_MATCH
            and band["p99_box_err_px"] == 0.0
            and host["launches"]["ct_attention_cm"] > 0
            and host["launches"]["nms_mask"] == 0
            and res["voc500_card_nms"]["launches"]["nms_mask"] > 0):
        raise AssertionError(f"the --host-nms eval is wrong: {res}")
    return res


def phase_bench(out_dir: str) -> dict:
    """The port's three kernel benches at 300 (and the backward bench at
    512), few iterations each, their printed lines to ``out_dir``; the
    launches of the benches' kernels over them. The backward bench's checks
    (each backward against its plain version, the two layouts and the two
    backwards against each other) must hold within BWD_TOL of the largest
    gradient: at 512 they are the only card run of rows 3, 4 and 5 at
    K=4,964 and P=32,756."""
    import contextlib

    import torch

    from ct_tpu_torch.ops.bias_relu import bias_relu_bwd, bias_relu_bwd_bf16
    from ct_tpu_torch.ops.ct_attention import (
        ct_attention, ct_attention_bf16, ct_attention_bwd,
        ct_attention_bwd_bf16, ct_attention_cm_bwd, ct_attention_cm_bwd_bf16,
        ct_attention_variant, ct_attention_variant_bf16,
        ct_attention_variant_unfused_bf16,
    )
    from ct_tpu_torch.scripts import (
        bench_bias_relu_bwd, bench_ct_attention, bench_ct_bwd,
    )

    counts = {"ct_attention": ct_attention,
              "ct_attention_bwd": ct_attention_bwd,
              "ct_attention_variant": ct_attention_variant,
              "ct_attention_cm_bwd": ct_attention_cm_bwd,
              "bias_relu_bwd": bias_relu_bwd,
              "ct_attention_bf16": ct_attention_bf16,
              "ct_attention_variant_bf16": ct_attention_variant_bf16,
              "ct_attention_variant_unfused_bf16":
                  ct_attention_variant_unfused_bf16,
              "ct_attention_bwd_bf16": ct_attention_bwd_bf16,
              "ct_attention_cm_bwd_bf16": ct_attention_cm_bwd_bf16,
              "bias_relu_bwd_bf16": bias_relu_bwd_bf16}
    for fn in counts.values():
        fn.launches = 0
    # the attention and bias+ReLU benches on bf16 inputs, as the JAX
    # benches feed them, then on the same values in float32 (the port's
    # float32 kernels)
    benches = (("bench_ct_attention", bench_ct_attention, ["--iters", "3"]),
               ("bench_ct_attention_f32", bench_ct_attention,
                ["--iters", "3", "--dtype", "float32"]),
               ("bench_ct_bwd", bench_ct_bwd, ["--iters", "2"]),
               ("bench_ct_bwd_f32", bench_ct_bwd,
                ["--iters", "2", "--dtype", "float32"]),
               ("bench_ct_bwd_512", bench_ct_bwd, ["--size", "512",
                                                   "--iters", "2"]),
               ("bench_ct_bwd_512_f32", bench_ct_bwd,
                ["--size", "512", "--iters", "2", "--dtype", "float32"]),
               ("bench_bias_relu_bwd", bench_bias_relu_bwd,
                ["--iters", "3"]),
               ("bench_bias_relu_bwd_f32", bench_bias_relu_bwd,
                ["--iters", "3", "--dtype", "float32"]))
    res = {}
    os.makedirs(out_dir, exist_ok=True)
    for name, module, argv in benches:
        t0 = time.perf_counter()
        with open(os.path.join(out_dir, name + ".txt"), "w") as f, \
                contextlib.redirect_stdout(f):
            res[name] = module.main(argv)
        res[name]["seconds"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    res["launches"] = {name: fn.launches for name, fn in counts.items()}
    if not all(res["launches"].values()):
        raise AssertionError(f"a bench kernel did not run: "
                             f"{res['launches']}")
    for name in ("bench_ct_bwd_f32", "bench_ct_bwd_512_f32"):
        rel = {f"{check}.{grad}": e["rel"]
               for check in ("rowmajor_vs_plain", "classmajor_vs_plain",
                             "flash_vs_plain", "rowmajor_vs_classmajor",
                             "blockwise_vs_flash")
               for grad, e in res[name][check].items()}
        res[name]["worst_rel"] = max(rel.values())
        if not res[name]["worst_rel"] <= BWD_TOL:
            raise AssertionError(f"{name}: a backward disagrees: {rel}")
    # bf16: each backward against its plain bf16 version, in the max of
    # bf16_sum_check's band (the bench prints no means); the two layouts'
    # and the two backwards' cross-errors are readings (they round at
    # other points, as JAX's do)
    for name in ("bench_ct_bwd", "bench_ct_bwd_512"):
        rows = {}
        for check in ("rowmajor_vs_plain", "classmajor_vs_plain",
                      "flash_vs_plain"):
            for grad, e in res[name][check].items():
                rows[f"{check}.{grad}"] = e["max_abs_err"] / (
                    BF16_SUM_MAX_TOL * e["max_abs"])
        res[name]["worst_over_band"] = max(rows.values())
        if not res[name]["worst_over_band"] <= 1.0:
            raise AssertionError(f"{name}: a bf16 backward disagrees with "
                                 f"its plain version: {rows}")
    return res


# the size512 phase: RFBNet512 (P = 32,756 priors, K = 4,964 CT keys) as
# bench.py's 512 configs run it: training at batch 64 in 4 micro-batches
# of 16 (--accum-steps 4), serving at batch 32; the 512 eval CLI over the
# first SIZE512_EVAL_IMAGES fixture test images
SIZE512, P512, K512 = 512, 32756, 4964
ACCUM512, SERVE512_BATCH = 4, 32
SIZE512_CLI_ITERS, SIZE512_EVAL_IMAGES = 8, 64
# the device augmentation's canvas at 512 (scripts/real_parity.py)
CANVAS512 = (5 * SIZE512 + 3) // 4
# accumulation on the card: JAX's own bands for accum 2 of a duplicated
# batch against accum 1 (tests/test_train_opt.py), and for its fused
# optimizer against its per-leaf one
ACCUM_LOSS_RTOL = 2e-5
ACCUM_PARAM_RTOL, ACCUM_PARAM_ATOL = 1e-4, 1e-6
FUSED_RTOL, FUSED_ATOL = 1e-6, 1e-7
# the solver of those checks: warmup over two of the three updates, a
# decay at the third
SOLVER512 = dict(lr=2e-3, steps=(3,), warmup_iters=2)
# the training kernels, by the names the profiler gives them
TRAIN_PROFILED = ("ct_attention_kernel", "ct_attention_bf16_kernel",
                  "bwd_dq_kernel", "bwd_dkdv_kernel", "dq_kernel",
                  "dkdv_kernel", "prep_kv", "prep_q", "pool2x2_relu")


def seeded_state512(task, seed: int) -> dict:
    """The port's seeded init of a 512 model, its BN statistics and CT
    parameters randomized (their inits are zeros or ones), as the CPU
    tests seed it (tests/test_torch_train_accum.py ``seeded_state``)."""
    import torch

    from ct_tpu_torch.models.rfbnet import build_net

    torch.manual_seed(seed)
    gen = torch.Generator().manual_seed(seed)
    state = {}
    for key, val in build_net(task, SIZE512,
                              device="cpu").state_dict().items():
        if key.endswith("running_mean"):
            val = torch.randn(val.shape, generator=gen) * 0.1
        elif key.endswith("running_var"):
            val = torch.rand(val.shape, generator=gen) + 0.5
        elif key.startswith(("Wz", "OBJ_Target", "fc_base")):
            val = torch.randn(val.shape, generator=gen) * 0.3
        state[key] = val
    return state


def size512_kernels(seed: int) -> dict:
    """Rows 1, 2, 3 and 6, f32 and bf16, against their plain versions at
    the 512 shapes (B=2, C=15 with N=5 and C=60 with N=20), under the
    kernel phase's bands, timed there; row 7 bit for bit at conv1's 512 map
    at the micro-batch ([16, 64, 512, 512]), f32 and bf16."""
    import numpy as np

    rng = np.random.default_rng(seed + SIZE512)
    res = {}
    for c, n in ((15, 5), (60, 20)):
        res[f"fwd_c{c}"] = attention_case(rng, 2, c, P512, K512, True)
        res[f"train_c{c}"] = training_attention_case(rng, 2, c, P512, K512,
                                                     True)
        res[f"serving_c{c}"] = serving_case(rng, 2, c, P512, K512, n, True)
        res[f"bf16_fwd_c{c}"] = bf16_attention_case(rng, 2, c, P512, K512,
                                                    True)
        res[f"bf16_train_c{c}"] = bf16_training_case(rng, 2, c, P512, K512,
                                                     True)
        res[f"bf16_serving_c{c}"] = bf16_serving_case(rng, 2, c, P512, K512,
                                                      n, True)
    shape = (TRAIN_BATCH // ACCUM512, 64, SIZE512, SIZE512)
    res["pool"] = pool_case(rng, shape, True)
    res["bf16_pool"] = bf16_pool_case(rng, shape, True)
    return res


def size512_card_vs_cpu(seed: int) -> dict:
    """One 512 image through the phase-2 incre model on seeded weights, on
    the card and on the CPU. The image is of unit scale, as the CPU tests
    feed seeded weights (at image scale they saturate the CT softmax).
    Untrained heads regress boxes at random, so hundreds of boxes of one
    class overlap with scores a few 1e-6 apart, and a score difference of
    ~2e-5 (two f32 trunks summed in other orders) reorders them before
    NMS: which of two such boxes survives is not the port's to decide
    (measured on the card: 192 of 195 detections above the cap's
    near-ties matched). So the check is split where the 300 model's
    detections need not be: the forward's outputs, card against CPU, by
    the CPU tests' bands (logits atol 2e-3, softmaxed scores 1e-4,
    rtol 1e-3), and the card's post-processing (the NMS kernel) against the
    CPU's on the card's own outputs, by the model phase's bands (the same
    count, IoU ≥ 0.999, |Δscore| ≤ 1e-4); the detections of the two
    whole runs are compared as a reading."""
    import numpy as np
    import torch

    from ct_tpu_torch.config import VOC_512, resolve_task
    from ct_tpu_torch.eval import compare_detections
    from ct_tpu_torch.models.rfbnet import build_net, eval_scores
    from ct_tpu_torch.ops.detection import postprocess
    from ct_tpu_torch.ops.nms import nms_mask
    from ct_tpu_torch.ops.priors import prior_boxes

    task = resolve_task(2, "incre", "ours", "VOC")
    state = seeded_state512(task, seed)
    image = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (1, 3, SIZE512, SIZE512)).astype(np.float32))
    sizes = torch.tensor([[375, 500]])
    outs = {}
    for dev in ("cuda", "cpu"):
        net = build_net(task, SIZE512, device=dev)
        net.load_state_dict(state)
        with torch.inference_mode():
            preds = net(image.to(dev))
            conf, obj = eval_scores(preds)
        outs[dev] = {"loc": preds.loc, "conf_logits": preds.conf,
                     "obj_logits": preds.obj, "conf": conf, "obj": obj}
        del net
    res = {"forward": {}}
    for name, atol in (("loc", 2e-3), ("conf_logits", 2e-3),
                       ("obj_logits", 2e-3), ("conf", MATCH_SCORE),
                       ("obj", MATCH_SCORE)):
        a, b = outs["cuda"][name].cpu(), outs["cpu"][name]
        excess = ((a - b).abs() - atol - 1e-3 * b.abs()).max().item()
        res["forward"][name] = {"max_abs_err": (a - b).abs().max().item(),
                                "atol": atol, "ok": excess <= 0}

    def detections(o):
        dev = o["loc"].device
        with torch.inference_mode():
            d = postprocess(o["loc"], o["conf"], o["obj"],
                            prior_boxes(VOC_512, dev),
                            image_sizes=sizes.to(dev))
        return type(d)(*(t.cpu() for t in d))

    before = nms_mask.launches
    card = detections(outs["cuda"])
    res["nms_launches"] = nms_mask.launches - before
    res["postprocess"] = compare_detections(
        card, detections({k: v.cpu() for k, v in outs["cuda"].items()}),
        iou_tol=MATCH_IOU, score_tol=MATCH_SCORE)
    res["whole_runs_reading"] = compare_detections(
        card, detections(outs["cpu"]), iou_tol=MATCH_IOU,
        score_tol=MATCH_SCORE)
    res["ok"] = bool(all(v["ok"] for v in res["forward"].values())
                     and res["postprocess"]["ok"]
                     and res["postprocess"]["count_a"] > 0
                     and res["nms_launches"] == 1)
    if not res["ok"]:
        raise AssertionError(f"the 512 model on the card differs from the "
                             f"CPU: {res}")
    return res


def size512_accum(seed: int) -> dict:
    """Accumulation on the card (phase-2 incre at 512, seeded weights):
    accum 2 of a duplicated batch [v, v] against accum 1, within JAX's
    own bands (BatchNorm sees the same statistics in either); the fused
    flavour (torch's fused SGD step) against the per-leaf one over 3
    updates of seeded gradients, within JAX's band between its two
    flavours, each update timed with CUDA events."""
    import torch

    from ct_tpu_torch.config import VOC_512, resolve_task
    from ct_tpu_torch.models.rfbnet import build_net
    from ct_tpu_torch.ops.priors import prior_boxes
    from ct_tpu_torch.train.solver import SolverConfig, build_optimizer
    from ct_tpu_torch.train.step import (
        LOSS_KEYS, TrainState, make_train_step,
    )

    dev = torch.device("cuda")
    task = resolve_task(2, "incre", "ours", "VOC")
    state = seeded_state512(task, seed + 1)
    half = dict(seeded_targets(seed + 70, 2),
                image=seeded_images(seed + 70, 2, SIZE512))
    batch = {k: torch.cat([v, v]).to(dev) for k, v in half.items()}
    priors = prior_boxes(VOC_512, dev)

    def fresh(fused=False):
        net = build_net(task, SIZE512, device=dev)
        net.load_state_dict(state)
        return TrainState(net, *build_optimizer(
            net, task, SolverConfig(**SOLVER512), fused=fused))

    runs = {}
    for accum in (1, 2):
        train_state = fresh()
        losses = make_train_step(priors, accum_steps=accum)(train_state,
                                                            batch)
        runs[accum] = ({k: v.item() for k, v in losses.items()},
                       {n: p.detach().clone() for n, p in
                        train_state.model.named_parameters()})
        del train_state
    (l1, p1), (l2, p2) = runs[1], runs[2]
    loss_rel = {k: abs(l2[k] - l1[k]) / abs(l1[k])
                for k in LOSS_KEYS + ("total_loss",)}
    param_excess = max(((p2[n] - p1[n]).abs() - ACCUM_PARAM_ATOL
                        - ACCUM_PARAM_RTOL * p1[n].abs()).max().item()
                       for n in p1)
    res = {"batch": 4, "accum_steps": 2, "losses_accum1": l1,
           "loss_rel_err": loss_rel, "loss_rtol": ACCUM_LOSS_RTOL,
           "num_pos": [l1["num_pos"], l2["num_pos"]],
           "param_rtol": ACCUM_PARAM_RTOL, "param_atol": ACCUM_PARAM_ATOL,
           "param_worst_excess": param_excess}
    if not (max(loss_rel.values()) <= ACCUM_LOSS_RTOL
            and l1["num_pos"] == l2["num_pos"] and param_excess <= 0):
        raise AssertionError(f"accum 2 of a duplicated batch differs from "
                             f"accum 1 on the card: {res}")
    del runs, p1, p2

    after, step_ms = {}, {}
    for fused in (False, True):
        train_state = fresh(fused)
        if any(bool(g["fused"]) != fused
               for g in train_state.optimizer.param_groups):
            raise AssertionError("the optimizer flavour is wrong")
        params = dict(train_state.model.named_parameters())
        times = []
        for i in range(3):
            gen = torch.Generator(device=dev).manual_seed(seed + i)
            for name in sorted(params):
                params[name].grad = torch.randn(
                    params[name].shape, generator=gen, device=dev) * 0.01
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            train_state.optimizer.step()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
            train_state.scheduler.step()
            train_state.optimizer.zero_grad()
        after[fused] = {n: p.detach().clone() for n, p in params.items()}
        # each update's ms; the first allocates the momentum buffers
        step_ms["fused" if fused else "per_leaf"] = times
        del train_state, params
    excess = max(((after[True][n] - after[False][n]).abs() - FUSED_ATOL
                  - FUSED_RTOL * after[False][n].abs()).max().item()
                 for n in after[False])
    res["fused_vs_per_leaf"] = {
        "updates": 3, "rtol": FUSED_RTOL, "atol": FUSED_ATOL,
        "worst_excess": excess, "optimizer_step_ms": step_ms,
        "parameters": sum(p.numel() for p in after[False].values()),
        "max_abs_diff": max((after[True][n] - after[False][n]).abs().max()
                            .item() for n in after[False])}
    if excess > 0:
        raise AssertionError(f"the fused optimizer differs from the "
                             f"per-leaf one on the card: {res}")
    return res


def size512_train(seed: int, out_dir: str) -> dict:
    """bench.py's 512 train config: phase-2 transfer at 512 from seeded
    weights, batch 64 in 4 micro-batches (--accum-steps 4), the flash
    backward; f32 with TF32 off, then bf16. 1 warm-up and 3 timed steps
    each (images/s, peak memory, the training kernels' launches: 4 a step
    of rows 2, 3 and 7's two), and one profiled step with the device time
    of the port's kernels in it."""
    import torch

    from ct_tpu_torch.config import VOC_512, resolve_task
    from ct_tpu_torch.models.rfbnet import build_net
    from ct_tpu_torch.ops.priors import prior_boxes
    from ct_tpu_torch.train.solver import SolverConfig, build_optimizer
    from ct_tpu_torch.train.step import TrainState, make_train_step

    dev = torch.device("cuda")
    task = resolve_task(2, "transfer", "ours", "VOC")
    batch = dict(seeded_targets(seed + 80, TRAIN_BATCH),
                 image=seeded_images(seed + 80, TRAIN_BATCH, SIZE512))
    batch = {k: v.to(dev) for k, v in batch.items()}
    step = make_train_step(prior_boxes(VOC_512, dev), accum_steps=ACCUM512)
    res = {"classes": task.src_cls_dim}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        torch.manual_seed(seed)
        net = build_net(task, SIZE512, device=dev, dtype=dtype)
        train_state = TrainState(net, *build_optimizer(net, task,
                                                       SolverConfig()))
        res[name] = train_steps(step, train_state, batch, True, TRAIN_STEPS,
                                accum=ACCUM512)
        res[name]["profile"] = profile_step(
            lambda: step(train_state, batch), out_dir,
            f"profile_train512_{name}.txt", TRAIN_PROFILED)
        del net, train_state
        torch.cuda.empty_cache()
    return res


def size512_serving(seed: int, out_dir: str) -> dict:
    """bench.py's 512 serving configs on the phase-2 transfer model from
    seeded weights at batch 32: bf16 with approximate top-k 128 in a pool
    of 512, then the int8 full config (BN folded, calibrated on 8 images,
    int8 convs and heads, ``SKIP_CT_ONLY``, ``vgg_pool_chains(512)``, bf16,
    the same NMS options). 1 warm-up and 3 timed steps each (images/s, the
    launches of the bf16 CT kernel or serving head and of NMS, a profiled
    step). NMS is handed ``top_k`` candidates a row (``batched_nms`` pads
    the pool's to it), within the kernel's MAX_NMS_K at the default 200
    and at the serving 128; its wrapper refuses more."""
    import torch

    from ct_tpu_torch.config import VOC_512, resolve_task
    from ct_tpu_torch.eval import make_eval_step
    from ct_tpu_torch.models.rfbnet import build_net
    from ct_tpu_torch.ops.ct_attention import (
        ct_attention_cm_bf16, ct_attention_serving_bf16,
    )
    from ct_tpu_torch.ops.nms import MAX_NMS_K, nms_mask
    from ct_tpu_torch.ops.priors import prior_boxes
    from ct_tpu_torch.test import serving_model

    steps = 3
    task = resolve_task(2, "transfer", "ours", "VOC")
    options = {"approx_top_k": True, "top_k": 128, "pool_size": 512}
    images = seeded_images(seed + 90, SERVE512_BATCH, SIZE512).cuda()
    sizes = torch.tensor([[375, 500]] * SERVE512_BATCH).cuda()
    priors = prior_boxes(VOC_512, "cuda")
    torch.manual_seed(seed)
    net = build_net(task, SIZE512, device="cuda", dtype=torch.bfloat16)
    counts = {"ct_attention_cm_bf16": ct_attention_cm_bf16,
              "ct_attention_serving_bf16": ct_attention_serving_bf16,
              "nms_mask": nms_mask}
    if not max(200, options["top_k"]) <= MAX_NMS_K:
        raise AssertionError(f"NMS candidates per row above the kernel's "
                             f"{MAX_NMS_K}")
    torch.cuda.reset_peak_memory_stats()
    expected = dict.fromkeys(counts, 1 + steps)
    expected["ct_attention_serving_bf16"] = 0
    res = {"bf16": eval_steps(make_eval_step(net, priors, **options),
                              images, sizes, counts, expected, steps,
                              out_dir, "profile_serve512_bf16.txt")}
    t0 = time.perf_counter()
    served, quant = serving_model(
        net, seeded_images(seed + 91, 8, SIZE512), int8_heads=True)
    torch.cuda.synchronize()
    prep = {"quantized_convs": len(quant),
            "chained": sum("out_scale" in q for q in quant.values()),
            "prepare_s": time.perf_counter() - t0}
    del net
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    expected = dict.fromkeys(counts, 1 + steps)
    expected["ct_attention_cm_bf16"] = 0
    res["int8_full"] = dict(prep, **eval_steps(
        make_eval_step(served, priors, **options), images, sizes,
        counts, expected, steps, out_dir, "profile_serve512_full.txt"))
    res["nms_k"], res["nms_k_cap"] = options["top_k"], MAX_NMS_K
    return res


def mini_voc_root(n: int, root: str) -> str:
    """A VOC root with the first ``n`` test images of the fixture
    (symlinks), for the 512 eval CLI."""
    import shutil

    src = os.path.abspath(os.path.join(VOC_ROOT, "VOC2007"))
    if os.path.exists(root):
        shutil.rmtree(root)
    dst = os.path.join(root, "VOC2007")
    for sub in ("Annotations", "JPEGImages", os.path.join("ImageSets",
                                                          "Main")):
        os.makedirs(os.path.join(dst, sub))
    with open(os.path.join(src, "ImageSets", "Main", "test.txt")) as f:
        ids = [line.strip() for line in f][:n]
    for i in ids:
        for sub, ext in (("Annotations", ".xml"), ("JPEGImages", ".jpg")):
            os.symlink(os.path.join(src, sub, i + ext),
                       os.path.join(dst, sub, i + ext))
    with open(os.path.join(dst, "ImageSets", "Main", "test.txt"), "w") as f:
        f.write("".join(i + "\n" for i in ids))
    return root


def size512_train_cli(out_dir: str) -> dict:
    """``python -m ct_tpu_torch.train -s 512 --accum-steps 4 --fused-opt on
    --device-augment --canvas 640 --bf16`` for SIZE512_CLI_ITERS
    iterations at batch 64 on the VOC fixture (the incre split-1 5-shot
    protocol of the train_cli phase, from ``ref_model.pth``: its 300
    weights load where the shapes match), with the bf16 training kernels'
    launches (4 a step, and 2 OBJ_Target init batches, not accumulated);
    then the eval CLI at ``-s 512`` on its checkpoint over the first
    SIZE512_EVAL_IMAGES test images: detections written, the eval kernels
    launched, mAP a reading (a smoke: 8 iterations)."""
    import json
    import shutil

    from ct_tpu_torch import test as eval_cli
    from ct_tpu_torch.ops.ct_attention import ct_attention_cm
    from ct_tpu_torch.ops.nms import nms_mask
    from ct_tpu_torch.train import cli as train_cli

    save = os.path.join(out_dir, "train_cli_512")
    if os.path.exists(save):
        shutil.rmtree(save)
    os.makedirs(save)
    os.environ["VOC_ROOT"] = VOC_ROOT
    counts = training_counts()
    for fn in counts.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with Captured(os.path.join(out_dir, "train_cli_512.txt")):
        last = train_cli.main([
            "-s", str(SIZE512), "-p", "2", "--setting", "incre", "--split",
            "1", "--shot", "5", "--accum-steps", str(ACCUM512),
            "--fused-opt", "on", "--device-augment", "--canvas",
            str(CANVAS512), "--bf16", "-b", str(TRAIN_BATCH),
            "--init-iter", "2", "--max-iter", str(SIZE512_CLI_ITERS),
            "--warmup-iter", "0", "--steps", "20", "--load-file", REF_MODEL,
            "--save-folder", save])
    res = {"train_s": time.perf_counter() - t0, "last": last,
           "launches": {n: fn.launches for n, fn in counts.items()}}
    with open(os.path.join(save, "metrics.json")) as f:
        res["metrics_rows"] = [json.loads(line) for line in f]
    init = {"pool2x2_relu_fwd_bf16": 2, "ct_attention_cm_bf16": 2}
    expected = {n: ACCUM512 * SIZE512_CLI_ITERS + init.get(n, 0)
                if n in step_kernels(True, bf16=True) else init.get(n, 0)
                for n in counts}
    if not (res["launches"] == expected
            and [r["iteration"] for r in res["metrics_rows"]]
            == [SIZE512_CLI_ITERS]
            and all(math.isfinite(v) for r in res["metrics_rows"] + [last]
                    for v in r.values())):
        raise AssertionError(f"the 512 train CLI run is wrong: {res} "
                             f"(expected launches {expected})")
    row = res["metrics_rows"][-1]
    res.update(iteration_s=row["time"], loader_wait_s=row["data_time"],
               images_per_s=TRAIN_BATCH / row["time"])

    eval_counts = {"ct_attention_cm": ct_attention_cm, "nms_mask": nms_mask}
    for fn in eval_counts.values():
        fn.launches = 0
    os.environ["VOC_ROOT"] = mini_voc_root(
        SIZE512_EVAL_IMAGES, os.path.join(out_dir, "voc512"))
    t0 = time.perf_counter()
    try:
        with Captured(os.path.join(out_dir, "train_cli_512_eval.txt")):
            scores = eval_cli.main([
                "-s", str(SIZE512), "-p", "2", "--setting", "incre",
                "--split", "1", "--load-file",
                os.path.join(save, "model_final.pth"), "--save-folder",
                save])
    finally:
        os.environ["VOC_ROOT"] = VOC_ROOT
    res["eval_s"] = time.perf_counter() - t0
    res["eval_launches"] = {n: fn.launches for n, fn in eval_counts.items()}
    res["eval_mAP"] = scores["mAP"]
    detections = os.path.join(save, "inference", "detections.pkl")
    if not (os.path.exists(detections) and all(res["eval_launches"].values())
            and 0 <= scores["mAP"] <= 1):
        raise AssertionError(f"the 512 eval CLI run is wrong: {res}")
    return res


def phase_size512(seed: int, out_dir: str) -> dict:
    """RFBNet512 on the card, each part with its seconds: the kernels at
    the 512 shapes against their plain versions, card against CPU,
    accumulation and the fused optimizer, bench.py's 512 train and serving
    configs, and the 512 train and eval CLIs."""
    import torch

    res = {}
    for name, fn in (("kernel", lambda: size512_kernels(seed)),
                     ("card_vs_cpu", lambda: size512_card_vs_cpu(seed)),
                     ("accum", lambda: size512_accum(seed)),
                     ("train", lambda: size512_train(seed, out_dir)),
                     ("serving", lambda: size512_serving(seed, out_dir)),
                     ("train_cli", lambda: size512_train_cli(out_dir))):
        t0 = time.perf_counter()
        res[name] = fn()
        res[name + "_s"] = time.perf_counter() - t0
        emit({"part": "size512." + name, "seconds": res[name + "_s"],
              **res[name]})
        torch.cuda.empty_cache()
    return res


# the dp phase: the global batch of the two ranks' train step (16 a rank),
# its timed steps, and the fixture images of its eval
DP_BATCH, DP_TIMED_STEPS, DP_EVAL_IMAGES = 32, 3, 32
# the two ranks' step against one process's accum-2 step on the same
# images and anchors: the losses to rtol DP_LOSS_RTOL, each gradient,
# updated parameter and averaged BatchNorm statistic within DP_REL of its
# norm (with cuDNN deterministic both may agree bit for bit; the phase
# line records whether they did)
DP_LOSS_RTOL, DP_REL = 1e-6, 1e-5
# the train CLI at NCCL world size 1: iterations before and after --resume
DP_CLI_ITERS = (3, 5)


def dp_one_process(batch, dtype) -> dict:
    """One process's step on the card as the two ranks take it: the
    phase-2 incre model from ``ref_model.pth``, ``accum_steps=2`` on the
    global batch (a micro-batch each rank's block), then SGD, schedule
    and renorm; the mean of the two micro-batches' BatchNorm updates,
    each taken from the start alone; and DP_TIMED_STEPS more steps."""
    import torch

    from ct_tpu_torch.config import VOC_300, resolve_task
    from ct_tpu_torch.models.convert import load_reference_pth
    from ct_tpu_torch.models.rfbnet import build_net
    from ct_tpu_torch.ops.priors import prior_boxes
    from ct_tpu_torch.parallel.card_check import flat_state
    from ct_tpu_torch.parallel.mesh import bn_running_stats
    from ct_tpu_torch.train.solver import SolverConfig, build_optimizer
    from ct_tpu_torch.train.step import loss_and_grads, normalize_obj_target

    dev = torch.device("cuda")
    task = resolve_task(2, "incre", "ours", "VOC")
    state = load_reference_pth(REF_MODEL)
    priors = prior_boxes(VOC_300, dev)

    def fresh():
        net = build_net(task, 300, device=dev, dtype=dtype)
        net.load_state_dict(state)
        return net

    stats = []
    for half in (slice(0, DP_BATCH // 2), slice(DP_BATCH // 2, DP_BATCH)):
        net = fresh().train()
        with torch.no_grad():
            net(batch["image"][half])
        stats.append(torch.cat([t.reshape(-1).float()
                                for t in bn_running_stats(net)]))
    net = fresh()
    opt, sched = build_optimizer(net, task, SolverConfig(**DP_SOLVER))
    times, out = [], {}
    for i in range(1 + DP_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses, mask = loss_and_grads(net, batch, priors, 0.5,
                                      mask=out.get("mask_t"), accum_steps=2)
        if i == 0:
            out.update(flat_state(net), losses={k: float(v) for k, v in
                                                losses.items()},
                       mask_t=mask)
        opt.step()
        sched.step()
        normalize_obj_target(net)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i == 0:
            out["params"] = flat_state(net)["params"]
    out.update(stats=((stats[0] + stats[1]) / 2).cpu().numpy(),
               mask=out.pop("mask_t").cpu().numpy(), step_s=times,
               sizes=[p.numel() for p in net.parameters()
                      if p.grad is not None],
               stat_sizes=[t.numel() for t in bn_running_stats(net)])
    return out


DP_SOLVER = dict(lr=4e-3, steps=(100,), warmup_iters=0)


def split_rel(a, b, sizes) -> float:
    """The largest ‖a − b‖₂ / ‖b‖₂ over the tensors of two flat vectors."""
    import numpy as np

    worst, off = 0.0, 0
    for n in sizes:
        x, y = a[off:off + n], b[off:off + n]
        ref = float(np.linalg.norm(y))
        diff = float(np.linalg.norm(x.astype(np.float64) - y))
        worst = max(worst, diff / ref if ref else diff)
        off += n
    return worst


def dp_train_check(name, rank0, ref) -> dict:
    """The two ranks' first step against one process's (``dp_one_process``)
    and against each other."""
    import numpy as np

    out = rank0[name]
    res = {"losses": out["losses"], "one_process_losses": ref["losses"],
           "ranks_equal": out["ranks_equal"], "launches": out["launches"],
           "bit_equal": {k: bool(np.array_equal(out[k], ref[k]))
                         for k in ("grads", "params", "stats")},
           "grads_rel": split_rel(out["grads"], ref["grads"], ref["sizes"]),
           "params_rel": split_rel(out["params"], ref["params"],
                                   ref["sizes"]),
           "stats_rel": split_rel(out["stats"], ref["stats"],
                                  ref["stat_sizes"]),
           "rank_step_s": out["step_s"], "first_rank_step_s":
           out["first_step_s"], "one_process_step_s": ref["step_s"][1:],
           "all_reduce_s": out["all_reduce_s"],
           "all_reduce_calls": out["all_reduce_calls"],
           "all_reduce_mb": out["all_reduce_mb"]}
    bf16 = name == "bfloat16"
    used = step_kernels(True, bf16)
    losses_ok = all(math.isclose(out["losses"][k], ref["losses"][k],
                                 rel_tol=DP_LOSS_RTOL)
                    for k in ref["losses"])
    res["ok"] = (losses_ok and all(out["ranks_equal"].values())
                 and max(res["grads_rel"], res["params_rel"],
                         res["stats_rel"]) <= DP_REL
                 and out["launches"] == {n: 1 for n in used}
                 and out["all_reduce_calls"] == 1)
    if not res["ok"]:
        raise AssertionError(f"the two-rank {name} step is wrong: {res}")
    return res


def dp_cli(out_dir: str) -> dict:
    """(c) the train CLI under a launcher's environment at NCCL world size
    1 with ``--ndev 1 --orbax``, phase 1 on the VOC fixture from
    ``ref_model.pth``'s matching weights, then ``--resume`` from the
    asynchronous checkpoint, then the eval CLI on it; (d) ``--ndev 2`` on
    one card raises."""
    import shutil

    import torch

    from ct_tpu_torch import test as eval_cli
    from ct_tpu_torch.parallel.distributed import free_port
    from ct_tpu_torch.train import cli as train_cli

    save = os.path.join(out_dir, "train_cli_dp")
    if os.path.exists(save):
        shutil.rmtree(save)
    flags = ["-p", "1", "--setting", "incre", "--split", "1", "--basenet",
             REF_MODEL, "-b", "8", "--warmup-iter", "0", "--orbax",
             "--checkpoint-period", "2", "--save-folder", save]
    os.environ["VOC_ROOT"] = VOC_ROOT
    res, rows = {}, []
    launcher = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")
    t0 = time.perf_counter()
    try:
        for iters, extra in zip(DP_CLI_ITERS, ([], ["--resume"])):
            os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                              MASTER_ADDR="localhost",
                              MASTER_PORT=str(free_port()))
            with Captured(os.path.join(out_dir, f"train_cli_dp_{iters}.txt")):
                rows.append(train_cli.main(flags + extra + [
                    "--ndev", "1", "--max-iter", str(iters)]))
            if torch.distributed.is_initialized():
                raise AssertionError("the train CLI did not leave its group")
    finally:
        for key in launcher:
            os.environ.pop(key, None)
    res["train_s"] = time.perf_counter() - t0
    orbax = os.path.join(save, "orbax")
    res["steps"] = sorted(os.listdir(orbax))
    with open(os.path.join(save, "log.txt")) as f:
        log = f.read()
    res["iterations"] = [r["iteration"] for r in rows]
    res["nccl"] = "Mesh: 1 rank(s) (nccl)" in log
    res["resumed"] = (f"Starting training from iteration {DP_CLI_ITERS[0]}"
                      in log)
    os.environ["VOC_ROOT"] = mini_voc_root(
        DP_EVAL_IMAGES, os.path.join(out_dir, "voc_dp"))
    t0 = time.perf_counter()
    try:
        with Captured(os.path.join(out_dir, "train_cli_dp_eval.txt")):
            scores = eval_cli.main(["-p", "1", "--setting", "incre",
                                    "--split", "1", "--resume",
                                    "--save-folder", orbax, "-b", "16"])
    finally:
        os.environ["VOC_ROOT"] = VOC_ROOT
    res["eval_s"] = time.perf_counter() - t0
    res["eval_mAP"] = scores["mAP"]
    try:
        train_cli.main(flags + ["--ndev", "2", "--max-iter", "1"])
        res["ndev2"] = "did not raise"
    except RuntimeError as e:
        res["ndev2"] = str(e)
    want_raise = (f"--ndev 2 needs 2 CUDA devices, but "
                  f"{torch.cuda.device_count()} are visible")
    res["ok"] = (res["iterations"] == [DP_CLI_ITERS[0] - 1,
                                       DP_CLI_ITERS[1] - 1]
                 and res["nccl"] and res["resumed"]
                 and str(DP_CLI_ITERS[1]) in res["steps"]
                 and all(math.isfinite(v) for r in rows for v in r.values())
                 and 0 <= res["eval_mAP"] <= 1
                 and (want_raise in res["ndev2"]
                      or torch.cuda.device_count() >= 2))
    if not res["ok"]:
        raise AssertionError(f"the world-size-1 CLI run is wrong: {res}")
    return res


def phase_dp(seed: int, out_dir: str) -> dict:
    """Data parallel on the one card, each part printing its own line:
    (a) the train step of two gloo ranks against one process's accum-2
    step, in f32 and bf16, (b) their eval against one process's, (c) the
    CLIs at NCCL world size 1 with asynchronous checkpoints, (d) ``--ndev
    2`` raising."""
    import torch

    os.makedirs(out_dir, exist_ok=True)
    res = {}
    for name, fn in (("ranks", lambda: dp_ranks(seed)),
                     ("cli", lambda: dp_cli(out_dir))):
        t0 = time.perf_counter()
        res[name] = fn()
        res[name + "_s"] = time.perf_counter() - t0
        emit({"part": "dp." + name, "seconds": res[name + "_s"],
              **res[name]})
        torch.cuda.empty_cache()
    return res


REAL_PARITY_DIR = os.path.join("build", "chip_smoke", "real_parity")
REAL_PARITY_P2_DIR = os.path.join("build", "chip_smoke", "real_parity_p2")
REAL_PARITY_FIXTURE = (1800, 128)    # build3's: COCO images, test images
REAL_PARITY_ITERS = (30, 20)         # phase 1, phase 2 (a smoke)
REAL_PARITY_INIT_ITER, REAL_PARITY_NO_MIXUP = 5, 5
TRACKED_VOC = os.path.join(".parity_p2", "voc", "VOCdevkit")
TRANSFER_RECORD = os.path.join(".parity_tr", "ours_eval")
TRANSFER_EVAL_TOL = 1e-12
# a JPEG that another libjpeg encodes differently: decoded, one pixel may
# move by a few levels of 255 (none did on the machines tried)
JPEG_LEVELS = 8


def fixture_against_tracked(devkit: str) -> dict:
    """The VOC half of build3's tree against ``.parity_p2/voc`` (built at
    500 test images, this one at 128): every XML and list byte for byte,
    ``test.txt`` its first 128 lines; the JPEGs byte for byte, or else
    decoded within ``JPEG_LEVELS``."""
    import filecmp

    import numpy as np

    from ct_tpu_torch.data.voc import read_image

    res = {"files": 0, "jpeg_bytes_differ": 0, "jpeg_max_level_delta": 0}
    for year in ("2007", "2012"):
        ours_root = os.path.join(devkit, "VOC" + year)
        ref_root = os.path.join(TRACKED_VOC, "VOC" + year)
        for d, _, files in os.walk(ref_root):
            for name in files:
                ref = os.path.join(d, name)
                ours = os.path.join(ours_root, os.path.relpath(ref,
                                                               ref_root))
                res["files"] += 1
                if name == "test.txt":
                    with open(ref) as f:
                        want = "".join(f.readlines()[:REAL_PARITY_FIXTURE[1]])
                    with open(ours) as f:
                        if f.read() != want:
                            raise AssertionError(f"{ours} is not the first "
                                                 f"lines of {ref}")
                elif not filecmp.cmp(ours, ref, shallow=False):
                    if not name.endswith(".jpg"):
                        raise AssertionError(f"{ours} differs from {ref}")
                    res["jpeg_bytes_differ"] += 1
                    delta = int(np.abs(read_image(ours).astype(np.int16)
                                       - read_image(ref)).max())
                    res["jpeg_max_level_delta"] = max(
                        res["jpeg_max_level_delta"], delta)
        if len(os.listdir(os.path.join(ours_root, "JPEGImages"))) != len(
                os.listdir(os.path.join(ref_root, "JPEGImages"))):
            raise AssertionError(f"{ours_root}: another image count")
    res["jpeg_band_levels"] = JPEG_LEVELS
    if res["jpeg_max_level_delta"] > JPEG_LEVELS:
        raise AssertionError(f"the fixture's JPEGs decode apart from the "
                             f"tracked ones: {res}")
    return res


def real_parity_step(args, counts: dict, log_name: str, out_dir: str):
    """One sub-command of ``scripts/real_parity.py`` with ``counts``' kernels
    counted from 0 (the CLIs' output to ``log_name``): (its result, its
    seconds, the launches)."""
    from ct_tpu_torch.scripts import real_parity

    for fn in counts.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with Captured(os.path.join(out_dir, log_name)):
        out = real_parity.main(args)
    return (out, time.perf_counter() - t0,
            {n: fn.launches for n, fn in counts.items()})


def phase_real_parity(out_dir: str) -> dict:
    """The transfer chain of ``scripts/real_parity.py`` on the card:
    build3's trees at full size, the VOC half against the tracked fixture,
    the evaluator against JAX's transfer record, phase 1 (COCO-60) and
    phase 2 (transfer, 5-shot) at full width in bf16 for a few iterations
    with their kernels' launches, both evals, and ``eval-ours`` + ``diff``
    on ``ref_model.pth`` against the reference stack's record."""
    import json
    import pickle
    import shutil

    from ct_tpu_torch.data.voc import VOCTestSet
    from ct_tpu_torch.ops.ct_attention import ct_attention_cm
    from ct_tpu_torch.ops.nms import nms_mask

    for d in (REAL_PARITY_DIR, REAL_PARITY_P2_DIR):
        if os.path.exists(d):
            shutil.rmtree(d)
    out = REAL_PARITY_DIR
    images, test_images = REAL_PARITY_FIXTURE
    counts = training_counts()
    eval_counts = {"ct_attention_cm": ct_attention_cm, "nms_mask": nms_mask}
    res = {}
    _, res["build3_s"], _ = real_parity_step(
        ["build3", "--out", out, "--images", str(images), "--test-images",
         str(test_images)], {}, "real_parity_build3.txt", out_dir)
    devkit = os.path.join(out, "voc", "VOCdevkit")
    res["fixture"] = fixture_against_tracked(devkit)

    with open(os.path.join(TRANSFER_RECORD, "inference", "detections.pkl"),
              "rb") as f:
        all_boxes = pickle.load(f)
    with open(TRANSFER_RECORD + ".json") as f:
        record = json.load(f)
    scored = VOCTestSet(devkit, "2007", "test", phase=2, setting="transfer",
                        split=1).evaluate_detections(
        all_boxes, os.path.join(out_dir, "transfer_record"))
    deltas = [abs(scored["mAP"] - record["mAP"])] + [
        abs(scored["APs"][c] - ap) for c, ap in record["APs"].items()]
    res["evaluator"] = {"mAP": scored["mAP"], "max_abs_delta": max(deltas)}
    if max(deltas) > TRANSFER_EVAL_TOL:
        raise AssertionError(f"the VOC evaluator misses JAX's transfer "
                             f"record: {res['evaluator']}")

    it1, it2 = REAL_PARITY_ITERS
    run = ["--batch", str(TRAIN_BATCH), "--out", out]
    steps = (
        ("train", ["train", "--dataset", "COCO", "--iters", str(it1),
                   "--export-name", "phase1.pth"] + run, counts, it1,
         ("pool2x2_relu_fwd_bf16", "pool2x2_relu_bwd_bf16")),
        ("eval_coco", ["eval-ours", "--dataset", "COCO", "--phase", "1",
                       "--setting", "transfer", "--load-name",
                       "phase1.pth", "--out", out], eval_counts, 1,
         ("nms_mask",)),
        ("train2", ["train2", "--setting", "transfer", "--shot", "5",
                    "--iters", str(it2), "--init-iter",
                    str(REAL_PARITY_INIT_ITER), "--no-mixup-iter",
                    str(REAL_PARITY_NO_MIXUP)] + run, counts, it2,
         ("ct_attention_cm_stats_bf16", "ct_attention_cm_bwd_flash_bf16",
          "pool2x2_relu_fwd_bf16", "pool2x2_relu_bwd_bf16")),
        ("eval", ["eval-ours", "--phase", "2", "--setting", "transfer",
                  "--out", out], eval_counts, 1,
         ("ct_attention_cm", "nms_mask")))
    for name, args, kernels, n, used in steps:
        result, seconds, launches = real_parity_step(
            args, kernels, f"real_parity_{name}.txt", out_dir)
        res[name] = {"seconds": seconds, "launches": launches,
                     "per_step": {k: launches[k] / n for k in used}}
        if name.startswith("train"):
            res[name].update(images_per_s=result["images_per_s"],
                             dtype=result["dtype"], last=result["last"])
            fine = all(math.isfinite(v) for v in result["last"].values())
        else:
            res[name].update({k: result[k] for k in ("mAP", "AP", "AP50")
                              if k in result})
            fine = all(0 <= result.get(k, 0) <= 1 or result[k] == -1
                       for k in ("mAP", "AP50"))
        # the chain runs the card's kernels: every one of its step's, at
        # least once a step, and nothing of the f32 training kernels
        unused_f32 = [k for k in launches if k.startswith(
            ("ct_attention_cm_stats", "ct_attention_cm_bwd",
             "pool2x2_relu")) and not k.endswith("_bf16")]
        if not (fine and all(launches[k] >= n for k in used)
                and not any(launches[k] for k in unused_f32
                            if name.startswith("train"))):
            raise AssertionError(f"real_parity {name} is wrong: "
                                 f"{res[name]}")

    # ref_model.pth through eval-ours and diff: the reference stack's
    # record (.parity_p2/ref_eval.json) and detections, in a folder of
    # their own
    p2 = REAL_PARITY_P2_DIR
    os.makedirs(p2)
    os.symlink(os.path.abspath(os.path.join(".parity_p2", "voc")),
               os.path.join(p2, "voc"))
    for name in ("ref_eval.json", "detections_ref.pkl"):
        shutil.copy(os.path.join(".parity_p2", name), os.path.join(p2, name))
    scores, seconds, launches = real_parity_step(
        ["eval-ours", "--out", p2, "--phase", "2", "--load-name",
         os.path.abspath(REF_MODEL)], eval_counts,
        "real_parity_ref_eval.txt", out_dir)
    verdict, _, _ = real_parity_step(["diff", "--out", p2, "--phase", "2"],
                                     {}, "real_parity_diff.txt", out_dir)
    res["ref_model"] = {"seconds": seconds, "launches": launches,
                        "mAP": scores["mAP"],
                        "novel_mAP": scores["novel_mAP"],
                        "diff": {k: verdict[k] for k in
                                 ("ref_mAP", "delta", "novel_mAP", "ok")},
                        "detections": verdict.get("detections")}
    if not (verdict["ok"] and all(launches.values())):
        raise AssertionError(f"eval-ours + diff on ref_model.pth fail: "
                             f"{res['ref_model']}")
    return res


def dp_ranks(seed: int) -> dict:
    """(a) and (b) of the dp phase: one launch of two ranks."""
    import numpy as np
    import torch

    from ct_tpu_torch.config import VOC_300, resolve_task
    from ct_tpu_torch.eval import run_inference
    from ct_tpu_torch.data.voc import VOCTestSet
    from ct_tpu_torch.models.convert import load_reference_pth
    from ct_tpu_torch.models.rfbnet import build_net
    from ct_tpu_torch.ops.priors import prior_boxes
    from ct_tpu_torch.parallel.card_check import Subset
    from ct_tpu_torch.parallel.distributed import launch

    dev = torch.device("cuda")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    res = {}
    try:
        batch = dict(seeded_targets(seed, DP_BATCH),
                     image=seeded_images(seed, DP_BATCH, 300))
        on_card = {k: v.to(dev) for k, v in batch.items()}
        t0 = time.perf_counter()
        refs = {str(dt).replace("torch.", ""): dp_one_process(on_card, dt)
                for dt in (torch.float32, torch.bfloat16)}
        res["one_process_s"] = time.perf_counter() - t0
        spec = {"ref_model": REF_MODEL, "solver": DP_SOLVER,
                "batch": {k: v.numpy() for k, v in batch.items()},
                "masks": {k: r["mask"] for k, r in refs.items()},
                "dtypes": [torch.float32, torch.bfloat16],
                "timed_steps": DP_TIMED_STEPS, "voc_root": VOC_ROOT,
                "eval_images": DP_EVAL_IMAGES, "eval_batch": DP_BATCH}
        t0 = time.perf_counter()
        rank0 = launch("ct_tpu_torch.parallel.card_check:rank_check", 2,
                       (spec,), device="cuda", share_device=True,
                       timeout=600)
        res["ranks_s"] = time.perf_counter() - t0
        res["backend"] = rank0["backend"]
        for name in refs:
            res["train_" + name] = dp_train_check(name, rank0, refs[name])

        task = resolve_task(2, "incre", "ours", "VOC")
        net = build_net(task, 300, device=dev)
        net.load_state_dict(load_reference_pth(REF_MODEL))
        net.eval()
        dataset = Subset(VOCTestSet(os.path.abspath(VOC_ROOT), "2007",
                                    "test", phase=2, setting="incre",
                                    split=1), DP_EVAL_IMAGES)
        # one process at the ranks' per-forward batch: the same shapes
        one = run_inference(net, dataset, task, prior_boxes(VOC_300, dev),
                            300, batch_size=DP_BATCH // 2)
        two = rank0["eval"]["all_boxes"]
        counts_equal = all(len(a) == len(b) for ca, cb in zip(one, two)
                           for a, b in zip(ca, cb))
        ev = {"counts_equal": counts_equal,
              "detections": sum(len(a) for c in one for a in c),
              "bit_equal": counts_equal and all(
                  np.array_equal(a, b) for ca, cb in zip(one, two)
                  for a, b in zip(ca, cb)),
              "launches": rank0["eval"]["launches"],
              "rank_s": rank0["eval"]["seconds"]}
        within = counts_equal and all(
            np.allclose(a[:, 4], b[:, 4], rtol=1e-4, atol=1e-5)
            and np.allclose(a[:, :4], b[:, :4], rtol=1e-3, atol=0.5)
            for ca, cb in zip(one, two) for a, b in zip(ca, cb) if len(a))
        ev["ok"] = (within and ev["detections"] > 0
                    and ev["launches"].get("ct_attention_cm", 0) > 0
                    and ev["launches"].get("nms_mask", 0) > 0)
        if not ev["ok"]:
            raise AssertionError(f"the two-rank eval differs: {ev}")
        res["eval"] = ev
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return res


def card_vs_cpu(task, net, batch, priors) -> dict:
    """One loss-and-gradients call at batch 2 from the same state on the
    card and on the CPU. The card's gradients are taken over the anchors
    the CPU mined, so that near-tied negatives ranked the other way round
    cannot move them; the card's own mining is compared apart."""
    from ct_tpu_torch.config import VOC_300
    from ct_tpu_torch.models.rfbnet import build_net
    from ct_tpu_torch.ops.priors import prior_boxes
    from ct_tpu_torch.train.step import LOSS_KEYS, loss_and_grads

    cpu_net = build_net(task, 300, device="cpu")
    cpu_net.load_state_dict({k: v.cpu() for k, v in
                             net.state_dict().items()})
    mini = {k: v[:2].cpu() for k, v in batch.items()}
    mini_card = {k: v.to(priors.device) for k, v in mini.items()}
    cpu_losses, cpu_mask = loss_and_grads(cpu_net, mini,
                                          prior_boxes(VOC_300, "cpu"))
    _, own_mask = loss_and_grads(net, mini_card, priors)
    losses, _ = loss_and_grads(net, mini_card, priors,
                               mask=cpu_mask.to(priors.device))
    rows = []
    for (name, p), q in zip(net.named_parameters(), cpu_net.parameters()):
        d = p.grad.cpu() - q.grad
        norm = q.grad.norm().item()
        rows.append((d.norm().item() / max(norm, TRAIN_GRAD_FLOOR), name,
                     norm, d.norm().item(), q.grad.abs().max().item(),
                     d.abs().max().item()))
    rows.sort(reverse=True)
    loss_rel = {k: abs(losses[k].item() - cpu_losses[k].item())
                / abs(cpu_losses[k].item()) for k in LOSS_KEYS}
    res = {"batch": 2, "num_pos": cpu_losses["num_pos"].item(),
           "anchors_counted": int(cpu_mask.sum().item()),
           "mined_differently": int((own_mask.cpu() != cpu_mask).sum().item()),
           "loss_rel_err": loss_rel, "loss_rtol": TRAIN_LOSS_RTOL,
           "worst_grad_rel_err": rows[0][0], "worst_grad": rows[0][1],
           "grad_tol": TRAIN_GRAD_TOL,
           # (‖Δ‖/‖g‖, name, ‖g‖, ‖Δ‖, max|g|, max|Δ|) of the worst tensors
           "worst_grads": rows[:8]}
    res["ok"] = bool(max(loss_rel.values()) <= TRAIN_LOSS_RTOL
                     and rows[0][0] <= TRAIN_GRAD_TOL)
    return res


def profile_step(fn, out_dir: str, table: str, names=()) -> dict:
    """One step ``fn()`` under torch.profiler: device time by kernel, and
    under ``kernels_ms`` that of each kernel whose name holds one of
    ``names``. The table goes to ``out_dir/table``. The host pauses first,
    as before a kernel window (``profiled_events``): a profile opened
    right after another loses its first kernel records."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    time.sleep(PROFILE_PAUSE_S)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # a labelled span (``record_function``) also shows as a CUDA row over
    # its kernels: kernels alone are counted
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    events.sort(key=lambda e: -e.device_time_total)
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, table), "w") as f:
        f.write(prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=80))
    top = [{"name": e.key[:80], "ms": e.device_time_total / 1e3,
            "calls": e.count} for e in events[:12]]
    named = {n: sum(e.device_time_total for e in events if n in e.key) / 1e3
             for n in names}
    return {"wall_ms": wall * 1e3, "device_kernel_ms": busy_ms,
            "device_busy_share": busy_ms / (wall * 1e3) if wall else None,
            "kernels_ms": named, "top": top}


def kernels_line(results: dict) -> list:
    """Every kernel of the port: its launches on its path's phase (the
    eval, serving and train steps; the blockwise train steps; the benches),
    its error against its plain version (for NMS the number of keep
    entries that differ) over every case checked, and its times at that
    path's batch (8 for eval and serving, 64 for training and the backward
    bench, 128 for the forward bench)."""
    kern = results["kernel"]

    def worst(prefix, key="max_abs_err"):
        return max(kern[c][key] for c in kern if c.startswith(prefix))

    incre, timed, pool = kern["incre"], kern["train_timed"], kern["pool_timed"]
    b16, pool16 = kern["bf16_train_timed"], kern["bf16_pool_timed"]
    train16 = results["train_bf16"]["launches"]
    blockwise16 = results["train_bf16"]["blockwise"]["launches"]
    attn_err = max(max(v for n, v in kern[c]["stats_err"].items()
                       if n != "z_rel")
                   for c in kern if c.startswith("train_"))
    pool_err = {d: max(kern[c][d + "_max_abs_err"]
                       for c in ("pool", "pool_ragged", "pool_timed"))
                for d in ("fwd", "bwd")}
    train = results["train"]["launches"]
    blockwise = results["train"]["blockwise"]["launches"]
    bench = results["bench"]["launches"]
    serving = results["serving"]["launches"]
    rowmajor = kern["rowmajor_transfer"]
    att = "ct_tpu/ops/ct_attention.py:"

    def pipes(t):
        return {k: t[k] for k in ("bound_pipe", "bound_fp32_ms",
                                  "bound_tc_ms", "bound_exp_ms")}

    def bf16_pipes(t):
        return {k: t[k] for k in ("bound_pipe", "bound_tc_ms",
                                  "bound_exp_ms", "bound_bytes_ms")}

    def at_width(t, c):
        return {f"{k}_c{c}": t[k]
                for k in ("ms", "plain_ms", "library_ms", "bound_ms")}

    # the attention kernels run on the tensor cores: both bounds, and each
    # at the other width too (rows 1-4 are timed at the eval or train
    # step's C=15, rows 5 and 10 at the benches' C=60; row 5's backward also
    # at C=15)
    extra = {
        "ct_attention_cm": {
            **pipes(incre), **at_width(kern["transfer"], 60)},
        "ct_attention_cm_stats": {
            **pipes(timed["stats"]),
            **at_width(kern["train_timed_transfer"]["stats"], 60)},
        "ct_attention": pipes(rowmajor["fwd"]),
        "ct_attention_variant": pipes(kern["variant_timed"]),
        "ct_attention_cm_bwd_flash": {
            **pipes(timed["bwd"]),
            **at_width(kern["train_timed_transfer"]["bwd"], 60)},
        "ct_attention_cm_bwd": {
            **pipes(kern["blockwise_timed"]),
            **at_width(kern["blockwise_timed_transfer"], 60)},
        "ct_attention_bwd": {
            **pipes(rowmajor["bwd"]),
            **at_width(kern["rowmajor_incre"]["bwd"], 15)},
        "ct_attention_serving": {
            **pipes(kern["serving_incre"]),
            **at_width(kern["serving_transfer"], 60)},
        # the NMS kernel alone on the card (profiler), beside ``ms``, the
        # CUDA events around its wrapper's calls
        "nms_mask": {"device_ms": kern["nms"]["device_ms"]},
        # bf16: the bounds of the tensor cores at the bf16 rate and of the
        # exponentials; rows 1 and 6 also at the transfer width
        "ct_attention_cm_bf16": {
            **bf16_pipes(kern["bf16_incre"]),
            **at_width(kern["bf16_transfer"], 60)},
        "ct_attention_serving_bf16": {
            **bf16_pipes(kern["bf16_serving_incre"]),
            **at_width(kern["bf16_serving_transfer"], 60),
            **{f"{k}_b128_c60": kern["bf16_serving_bench"][k]
               for k in ("ms", "library_ms", "bound_ms")},
            "registers": results["build"].get("registers", {}).get(
                "ct_attention_serving_bf16_kernel")},
        "ct_attention_bf16": bf16_pipes(kern["bf16_rowmajor"]["fwd"]),
        "ct_attention_variant_bf16": bf16_pipes(
            kern["bf16_rowmajor"]["variant"]),
        "ct_attention_variant_unfused_bf16": bf16_pipes(
            kern["bf16_rowmajor"]["unfused"]),
        # bf16 training: rows 2, 3 and 4 at both widths, the backwards
        # split by kernel
        "ct_attention_cm_stats_bf16": {
            **bf16_pipes(b16["stats"]),
            **at_width(kern["bf16_train_timed_transfer"]["stats"], 60)},
        "ct_attention_cm_bwd_flash_bf16": {
            **bf16_pipes(b16["bwd"]), "kernels_ms": b16["bwd"]["kernels_ms"],
            **at_width(kern["bf16_train_timed_transfer"]["bwd"], 60),
            "kernels_ms_c60":
                kern["bf16_train_timed_transfer"]["bwd"]["kernels_ms"]},
        "ct_attention_cm_bwd_bf16": {
            **bf16_pipes(kern["bf16_blockwise_timed"]),
            "kernels_ms": kern["bf16_blockwise_timed"]["kernels_ms"],
            **at_width(kern["bf16_blockwise_timed_transfer"], 60),
            "kernels_ms_c60":
                kern["bf16_blockwise_timed_transfer"]["kernels_ms"]},
        "ct_attention_bwd_bf16": {
            **bf16_pipes(kern["bf16_rowmajor_bwd_timed"]),
            "kernels_ms": kern["bf16_rowmajor_bwd_timed"]["kernels_ms"],
            **at_width(kern["bf16_rowmajor_bwd_timed_incre"], 15),
            "kernels_ms_c15":
                kern["bf16_rowmajor_bwd_timed_incre"]["kernels_ms"]},
    }
    # the size512 phase: rows 1, 2, 3, 6 and 7 at the 512 shapes (B=2,
    # both widths; row 7 at the micro-batch's conv1 map), their errors
    # there, and their launches in its steps: 1 + 3 train steps of 4
    # micro-batches, 1 + 3 serving steps in each config
    s512, k512 = results["size512"], results["size512"]["kernel"]

    def at512(key, sub=None, err="max_abs_err"):
        out = {}
        for c in (15, 60):
            case = k512[f"{key}_c{c}"]
            t = case[sub] if sub else case
            out.update({f"{k}_512_c{c}": t[k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms")})
            out[f"max_abs_err_512_c{c}"] = t.get(err, case.get(err))
        return out

    def pool512(key, d):
        t = k512[key]
        return {**{f"{k}_512": t[d][k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms")},
            "max_abs_err_512": t[f"{d}_max_abs_err"]}

    train512 = {d: s512["train"][d]["launches"] for d in ("f32", "bf16")}
    serve512 = {d: s512["serving"][d]["launches"]
                for d in ("bf16", "int8_full")}
    for name, more in (
            ("ct_attention_cm", at512("fwd")),
            ("ct_attention_cm_stats", dict(
                at512("train", "stats", "stats_max_abs_err"),
                launches_512=train512["f32"]["ct_attention_cm_stats"])),
            ("ct_attention_cm_bwd_flash", dict(
                at512("train", "bwd", "bwd_max_abs_err"),
                launches_512=train512["f32"]["ct_attention_cm_bwd_flash"])),
            ("ct_attention_serving", at512("serving")),
            ("ct_attention_cm_bf16", dict(
                at512("bf16_fwd"),
                launches_512=serve512["bf16"]["ct_attention_cm_bf16"])),
            ("ct_attention_serving_bf16", dict(
                at512("bf16_serving"), launches_512=serve512["int8_full"][
                    "ct_attention_serving_bf16"])),
            ("ct_attention_cm_stats_bf16", dict(
                at512("bf16_train", "stats"),
                launches_512=train512["bf16"]["ct_attention_cm_stats_bf16"])),
            ("ct_attention_cm_bwd_flash_bf16", dict(
                at512("bf16_train", "bwd"), launches_512=train512["bf16"][
                    "ct_attention_cm_bwd_flash_bf16"])),
            ("pool2x2_relu_fwd", dict(
                pool512("pool", "fwd"),
                launches_512=train512["f32"]["pool2x2_relu_fwd"])),
            ("pool2x2_relu_bwd", dict(
                pool512("pool", "bwd"),
                launches_512=train512["f32"]["pool2x2_relu_bwd"])),
            ("pool2x2_relu_fwd_bf16", dict(
                pool512("bf16_pool", "fwd"),
                launches_512=train512["bf16"]["pool2x2_relu_fwd_bf16"])),
            ("pool2x2_relu_bwd_bf16", dict(
                pool512("bf16_pool", "bwd"),
                launches_512=train512["bf16"]["pool2x2_relu_bwd_bf16"])),
            ("nms_mask", {"launches_512": serve512["bf16"]["nms_mask"]
                          + serve512["int8_full"]["nms_mask"]})):
        extra[name] = {**extra.get(name, {}), **more}
    bf16 = results["bf16"]
    rows = [
        ("ct_attention_cm", "ct_attention_cm.cu", att + "146",
         results["model"]["launches"], incre["max_abs_err"], incre),
        ("ct_attention_cm_stats", "ct_attention_cm.cu", att + "209", train,
         attn_err, timed["stats"]),
        ("ct_attention_cm_bwd_flash", "ct_attention_cm_bwd.cu", att + "520",
         train, worst("train_", "bwd_max_abs_err"), timed["bwd"]),
        ("ct_attention_cm_bwd", "ct_attention_cm_bwd.cu", att + "364",
         blockwise, worst("blockwise_"), kern["blockwise_timed"]),
        ("ct_attention", "ct_attention_cm.cu", att + "67", bench,
         worst("rowmajor_", "fwd_max_abs_err"), rowmajor["fwd"]),
        ("ct_attention_bwd", "ct_attention_cm_bwd.cu", att + "283", bench,
         worst("rowmajor_", "bwd_max_abs_err"), rowmajor["bwd"]),
        ("pool2x2_relu_fwd", "pool2x2_relu.cu",
         "ct_tpu/ops/pool_packed_pallas.py:56", train, pool_err["fwd"],
         pool["fwd"]),
        ("pool2x2_relu_bwd", "pool2x2_relu.cu",
         "ct_tpu/ops/pool_packed_pallas.py:66", train, pool_err["bwd"],
         pool["bwd"]),
        ("ct_attention_serving", "ct_attention_serving.cu", att + "720",
         serving, worst("serving_"), kern["serving_incre"]),
        ("nms_mask", "nms.cu", "ct_tpu/ops/nms_pallas.py:35", serving,
         worst("nms"), kern["nms"]),
        ("bias_relu_bwd", "bias_relu_bwd.cu",
         "scripts/bench_bias_relu_bwd.py:32", bench, worst("bias_relu"),
         kern["bias_relu_timed"]),
        ("ct_attention_variant", "ct_attention_cm.cu",
         "scripts/bench_ct_attention.py:36", bench, worst("variant_"),
         kern["variant_timed"]),
        ("ct_attention_cm_bf16", "ct_attention_cm.cu", att + "146",
         bf16["eval"]["launches"],
         max(kern[c]["max_abs_err"] for c in
             ("bf16_incre", "bf16_transfer", "bf16_ragged",
              "bf16_ragged_narrow")), kern["bf16_incre"]),
        ("ct_attention_serving_bf16", "ct_attention_serving.cu",
         att + "720", bf16["serving"]["launches"],
         max(kern[c]["max_abs_err"] for c in kern
             if c.startswith("bf16_serving_")), kern["bf16_serving_incre"]),
        ("ct_attention_bf16", "ct_attention_cm.cu", att + "67", bench,
         max(kern[c]["fwd"]["max_abs_err"] for c in
             ("bf16_rowmajor", "bf16_rowmajor_ragged")),
         kern["bf16_rowmajor"]["fwd"]),
        ("ct_attention_variant_bf16", "ct_attention_cm.cu",
         "scripts/bench_ct_attention.py:36", bench,
         max(kern[c]["variant"]["max_abs_err"] for c in
             ("bf16_rowmajor", "bf16_rowmajor_ragged")),
         kern["bf16_rowmajor"]["variant"]),
        ("ct_attention_cm_stats_bf16", "ct_attention_cm.cu", att + "209",
         train16, max(kern[c]["stats"]["max_abs_err"] for c in kern
                      if c.startswith("bf16_train_")), b16["stats"]),
        ("ct_attention_cm_bwd_flash_bf16", "ct_attention_bwd_bf16.cu",
         att + "520", train16, max(kern[c]["bwd"]["max_abs_err"] for c in kern
                                   if c.startswith("bf16_train_")),
         b16["bwd"]),
        ("ct_attention_cm_bwd_bf16", "ct_attention_bwd_bf16.cu",
         att + "364", blockwise16, worst("bf16_blockwise_"),
         kern["bf16_blockwise_timed"]),
        ("ct_attention_bwd_bf16", "ct_attention_bwd_bf16.cu", att + "283",
         bench, worst("bf16_rowmajor_bwd"), kern["bf16_rowmajor_bwd_timed"]),
        ("pool2x2_relu_fwd_bf16", "pool2x2_relu.cu",
         "ct_tpu/ops/pool_packed_pallas.py:56", train16,
         max(kern[c]["fwd_max_abs_err"] for c in kern
             if c.startswith("bf16_pool")), pool16["fwd"]),
        ("pool2x2_relu_bwd_bf16", "pool2x2_relu.cu",
         "ct_tpu/ops/pool_packed_pallas.py:66", train16,
         max(kern[c]["bwd_max_abs_err"] for c in kern
             if c.startswith("bf16_pool")), pool16["bwd"]),
        ("bias_relu_bwd_bf16", "bias_relu_bwd.cu",
         "scripts/bench_bias_relu_bwd.py:32", bench,
         worst("bf16_bias_relu"), kern["bf16_bias_relu_timed"]),
        ("ct_attention_variant_unfused_bf16", "ct_attention_cm.cu",
         "scripts/bench_ct_attention.py:36", bench,
         max(kern[c]["unfused"]["max_abs_err"] for c in
             ("bf16_rowmajor", "bf16_rowmajor_ragged")),
         kern["bf16_rowmajor"]["unfused"]),
    ]
    return [{"name": name, "route": "cuda",
             "source": "ct_tpu_torch/csrc/" + src, "replaces": replaces,
             "launches": launches[name], "max_abs_err": err,
             "ms": t["ms"], "plain_ms": t["plain_ms"],
             "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
             "library_ms": t["library_ms"], **extra.get(name, {})}
            for name, src, replaces, launches, err, t in rows]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import ct_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the ct_tpu_torch package is missing ({e}); run "
              "from the repository root", file=sys.stderr)
        return 2
    if not os.path.exists(REF_MODEL):
        print(f"chip_smoke: {REF_MODEL} is missing", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    t_start = time.perf_counter()
    results = {}
    for name, fn in (("env", phase_env), ("build", phase_build),
                     ("kernel", lambda: phase_kernel(args.seed)),
                     ("model", lambda: phase_model(args.seed, PROFILE_DIR)),
                     ("serving", lambda: phase_serving(args.seed,
                                                       PROFILE_DIR)),
                     ("bf16", lambda: phase_bf16(args.seed, PROFILE_DIR)),
                     ("train", lambda: phase_train(args.seed, PROFILE_DIR)),
                     ("transfer", lambda: phase_transfer(args.seed)),
                     ("train_bf16", lambda: phase_train_bf16(args.seed,
                                                             PROFILE_DIR)),
                     ("train_cli", lambda: phase_train_cli(args.seed,
                                                           PROFILE_DIR)),
                     ("coco", lambda: phase_coco(PROFILE_DIR)),
                     ("bench", lambda: phase_bench(PROFILE_DIR)),
                     ("size512", lambda: phase_size512(args.seed,
                                                       PROFILE_DIR)),
                     ("dp", lambda: phase_dp(args.seed, PROFILE_DIR)),
                     ("real_parity", lambda: phase_real_parity(
                         PROFILE_DIR))):
        t0 = time.perf_counter()
        results[name] = fn()
        emit({"phase": name, "seconds": time.perf_counter() - t0,
              **results[name]})
    if not results["train"]["card_vs_cpu"]["ok"]:
        raise AssertionError("card and CPU train losses or gradients "
                             "differ beyond their bands (train phase line)")
    emit({"kernels": kernels_line(results)})
    print(results["env"]["nvidia_smi"])
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
