#!/usr/bin/env python3
"""Drive the torch port on one CUDA card, end to end, and check it.

Run from the repository root:

    python3 chip_smoke.py                  # needs one card
    python3 chip_smoke.py --profile DIR    # also profile one eval chunk and
                                           # one training step into DIR

Phases (each prints its own lines; any failure exits non-zero):
  1. the card: nvidia-smi name and power limit, torch and CUDA versions
  2. build every kernel from csrc/, one nvcc per source, all at once
  3. the segment-sum kernel against its plain version at the memory
     write's shapes, with out-of-range ids, on random ids, coherent ids
     (16 x 16-pixel squares share a cell, so runs of rows and the rows of
     neighbouring image rows share cells) and a one-cell worst case
  4. the memory-read kernel against its plain version at the read's
     shapes, on random and coherent ids
  4a. the NMS kernels against the plain fixpoint: proposal NMS (1024
     candidates, class-agnostic, t = 0.9, and t = 0 with the ml_nms
     bypass) and the multiclass NMS (2048 candidates of 20 classes,
     t = 0.5), with tied scores, duplicated boxes and a suppression chain
     deeper than 64; then the class partition's cases: classes of 0, 1,
     63, 64, 65 and 130 members (segments starting mid-word) at t = 0.5,
     0.9 and 0, the chain among other classes, every candidate in one
     class, and class ids beyond the partition's bins; keep sets must be
     equal
  4b. the ROIAlign kernel against the plain tap form (v1, f32) and the
     plain separable form (v4, bf16) at the box pooler's (R = 256, 7 x 7)
     and the mask pooler's (R = 100, 14 x 14) shapes over p3-p5, then
     ROIs under one level pixel, a whole level, and ROIs whose staged tap
     grid is taken in bands; the staged grid sizes (min, median, max) and
     the banded ROIs, as the kernel reports them
  4c. the mask-paste kernel against its plain version at 100 masks into
     480 x 640, flips at the 0.5 threshold counted and bounded; then 1 and
     130 masks, thresholds 0 and -1, boxes wholly outside the image and
     one covering it, pixel-major and mask-major (x_stride 8)
  4d. the exact write's selection: the mask paste with its observed-flag
     epilogue and the selection on its flags (the frame's path) against
     the plain paste, its flags and the plain selection, on 100 masks at
     0.5 with an empty and a full image row and invalid detections, 99
     masks (N % 4 != 0), 130 masks (two passes) and threshold 0: masks
     within the paste's flip bound, and flags, counts, ids and rows equal
     in every element; then the two-pass selection (masks only) against
     its plain version on pasted masks with an empty and a full row
  4e. the batched memory-read kernel (B = 4) against four single reads:
     equal in every element
  4f. the ROIAlign backward kernel (R = 512, 7 x 7 x 256, then ROIs under
     one level pixel, a whole level, beyond the image and wide ahead of 64
     random ROIs) in f32 within contributions x 2^-24 x sum|contribution|
     per element of the exact (f64) sum of the plain tap form's f32
     contributions, which any summation order keeps (at R = 512 also of
     torch autograd of the plain tap form on the CPU), and in bf16 within
     2^-8 |ref| + (1 + 2^-8) contributions x 2^-24 x sum|contribution| of
     the exact sum of the bf16 gradient's contributions and within
     (contributions + 1) x 2^-8 x sum|contribution| of the card's plain
     v1 autograd in bf16; the vector atomics its flush issues (each
     distinct position a ROI touches, once per 4 channels) beside the
     scalar atomics of a kernel that adds every tap
  5. the eval path: the default config (480x640, ResNet-50, 8192 x 512
     memory, 300 detections, write top-100, bf16) with seeded weights,
     one chunk of frames through `make_episode_runner` with the memory
     carried; the warm-up chunk runs under the sync debug mode "warn" and
     lists any synchronising call, the counted chunk under "error" (the
     frame must not synchronise with the host); kernel launch counts are
     zeroed just before the counted run and read just after it, and each
     kernel must have launched its expected count per frame
  5b. the episode modes at the same config: the longterm protocol, the
     pipelined runner, the batched runner (B = 2 streams, one starting
     from a carried memory) and the semantic_gt baseline on a class
     table; each once under the sync debug mode "warn" and once under
     "error" with its launches counted (semantic_gt: no write kernel, the
     table unchanged bit for bit)
  6. the card against the plain CPU path on a small config; 6b the same
     under the longterm protocol over 3 frames
  10. the evaluation engine (`engine.eval.evaluate_dataset`) at the
     default config over 8 in-memory chunks of 20 synthetic frames (2
     scenes x 4 chunks, a 110 x 57-cell map, every 5th frame scored):
     32 images, overall and quartile AP (random weights), the data /
     compute / eval seconds a chunk and frames/s, which evaluator ran
     (the native C++ core or numpy), each kernel's launches a frame
     (counts zeroed just before the run, read just after; equal to phase
     5's), and the host syncs of the run under the sync debug mode "warn"
     (the chunk end and the scored detections' copy, none in a frame);
     then the runner alone over the engine's timed chunks, their inputs
     on the card, beside the engine's compute a frame
  10b. the same protocol at the 64x96 f32 miniature (2 scenes x 2
     chunks x 10 frames) on the card and on the CPU, for the image-only
     preset "pretrained" and for "implicit_object_memory" under the exact
     and the strided write, with the mask logits shifted by +2 on both
     (so that few pasted pixels sit at 0.5) and each CPU chunk started
     from the card's memory: equal images and quartiles; each scored
     image's detections unless a mask-paste flip (within 1e-5 of 0.5, or
     between the two devices' inputs) precedes it in its chunk (a
     chunk's first frame within phase 6's tolerances, a later one within
     the frame tests' episode tolerance, rtol 1e-3); the memories of each
     chunk without a flip within 1e-3 of each cell's norm (write rows
     that two proposals tied in score put in another order compared row
     by row); a held image's classes and boxes; where every image was
     held, overall AP within 0.1 points, of the card's detections ranked
     by the CPU's scores always and of the card's own where no detection
     changes its rank among all images' (counted); images that read a
     memory their scene wrote among those held; and `semmap_classes` of
     the last chunk's first memory equal on both devices but for
     near-tied logits
  7. each kernel's device time beside its plain version, the PyTorch
     library call where one exists (the memory reads: one
     F.embedding_bag(mean) on a table prepared beforehand), and its bound;
     the segment-sum and the memory read also on coherent ids;
     the ROIAlign forward also at the training shape (R = 512, 7 x 7); the
     mask paste with its flag epilogue (the JSON entry) and without it,
     the selection on the paste's flags (the JSON entry) and the two-pass
     selection on masks alone
  8. the training path: the default config with seeded weights, 3 AdamW
     steps at B = 4 frames (2 chunks x 2 frames) of synthetic batches
     through `engine.train.train`; every loss finite, ms per step, peak
     device memory, each kernel's launches a step (counts zeroed just
     before the run, read just after), then one more step under the sync
     debug mode "warn" listing any synchronising call; then the same for
     each training knob: `centernet.more_pos`; `backbone.train_remat` with
     `roi.train_stage_remat` (the recompute launches each stage's ROIAlign
     forward again, and its wrapper counts it: 6 a frame); and
     `roi.use_fed_loss` with `roi.ignore_zero_cats` at Detic's LVIS
     setting (1203 classes, the copied LVIS v1 frequency table, the
     vendored lvis_v1_clip_a+cname.npy); the CLI's training branch over a
     synthetic h5 root runs only where the machine has h5py, else a line
     says so
  9. one training step at the 64x96 f32 miniature on the card against
     the same step on the CPU: losses, gradients and updated parameters
  11. the robot demo's path: the default config with the robot demo's
     changes (a 200 x 200-cell map, 40 000 cells; one class per proposal)
     with seeded weights, a 20-frame synthetic RGB-D trajectory in a box
     room (depth in mm with 0-mm holes, poses that move and turn, noise
     RGB) through `robot_demo.compute_proj_indices` on the card and
     `EmbodiedPredictor`: the card's projector equal to the plain CPU
     projector but at pixels within 1e-4 cells of a rounding boundary
     (counted), the segment-sum and the read at 40 000 cells against their
     plain versions (phases 3-4's checks), launches a request as phase 5,
     the host syncs of a request (the guard's copy of the ids and the
     detections' copy), ms a request and of the projector, frames/s, the
     semantic map
  11b. `EmbodiedPredictor` at the 64x96 f32 miniature on the card against
     the CPU over 5 frames with a reset (mask logits +2 on both; a frame
     after a fresh memory within phase 6's tolerances, a later one within
     the episode tolerance unless a paste flip precedes it); then
     `make_server` around a full-width predictor: /healthz, 5 /predict at
     480x640 with cell ids (one resetting), each reply matched one to one
     by class, box and score (phase 6's tolerances) with the predictor's
     own detections, called directly on the same frame and the memory the
     server held before it, and the server's memory after it within the
     segment-sum's bound of the direct call's (the write's atomics leave
     the memory's low bits run-dependent, so a direct run from a fresh
     memory parts from the server's), /set_vocabulary, a malformed body
     (400); each request's encode, round trip and decode ms
  11c. the image-only demo at 480x640: `predict_api.Predictor.detect`
     with the LVIS (1203 classes) and COCO vocabularies, launches a frame
     (NMS 2, ROIAlign 3, nothing else), `VisualizationDemo(parallel=True)`
     over 6 frames in order, and the multiclass NMS's kept set on one
     frame's LVIS cascade scores at score threshold 0 (the full 2048
     candidates, class ids past the partition's 256 bins) equal to the
     plain fixpoint's
  11d. the full-width frame step exported with `torch.export` to
     build/frame_step.pt2, loaded in a fresh process that imports only the
     port's `ops` and `serve` packages: detections equal to eager
     `frame_step`'s, the memory within the segment-sum's bound; export and
     load seconds

  12. the deformable attention kernels (forward and backward) against
     their plain version at the encoder's full-width shape (Q = S = 6380
     tokens of 60x80 + 30x40 + 15x20 + 8x10, M = 8, D = 32, L = 4, P = 4)
     and the decoder's (Q = 100), locations in [-0.1, 1.1] with pixel
     centres, borders and the -1 row; then at D = 6 (rows without 16-byte
     alignment), at both shapes on the model's locations (each query's
     reference plus normal(0, 2) level pixels) and on the first 3 levels
     (an odd L): the forward equal to the plain version bit for bit,
     grad_loc and grad_attn within 1e-5 of the plain autograd's largest,
     grad_value and the plain autograd's within
     contributions x 2^-24 x sum|contribution| of the exact sum of its
     f32 contributions
  12b. Deformable-DETR inference at 480x640 with seeded weights at the
     JAX defaults (ResNet-50, hidden 256, 8 heads, 6 + 6 layers, FFN
     2048, 4 levels x 4 points, 100 queries): the single-stage linear
     detector (20 classes) and the two-stage, box-refine, zero-shot one
     on the vendored mp3d table, `detr_inference` to 100 detections over
     24 frames each under the sync debug mode "error" (a warm-up frame
     under "warn" first), 12 deformable-attention launches a frame, ms a
     frame, the busy share (device busy ms a frame of 2 profiled frames
     over the timed ms a frame), peak memory; from the same 2 profiled
     frames the device ms a frame by op group (kernel 8, convolutions,
     matmuls, norms, elementwise, the rest) with the top ops, and kernel
     8's device time a call in the encoder and in the decoder
  12c. Deformable-DETR training at 480x640: 3 `detr_train_step_host_matched`
     steps of the two-stage, box-refine detector on 5 GT boxes, each with
     a `GroupedOptimizer` step: finite losses, gradients on enc_output,
     sampling_offsets and value_proj, 12 forward and 12 backward launches
     a step, ms a step, peak memory, and the host syncs of one more step
     (8 by design: the GT validity and 7 cost matrices)
  12d. the same detector at 64x96 with ResNet depths (1, 1, 1, 1) on the
     card and on the CPU from the same seeded weights: DETROutputs of both
     variants within 1e-4 of each output's largest, one two-stage train
     step's losses within 1e-4 and gradients within 1e-3 of each tensor's
     largest (plus 1e-6 of the step's largest for gradients that are 0 in
     exact arithmetic)
  13. the modulated deformable convolution (kernels 9, 9b): seeded
     `DeformConvBlock(256, 3)` blocks with bias, modulated and not, whose
     offset convs give offsets of std ~2 (samples cross every border),
     forward and `torch.autograd.grad` backward on each of the five
     CenterNet levels of a 480x640 frame (60x80 to 4x5, 256 channels),
     launches counted (10 forward, 10 backward); then at every level the
     im2col kernel's columns equal to the plain version's bit for bit, the
     op within 1e-6 of the plain version's largest, grad_offset,
     grad_mask, grad_weight and grad_bias within 1e-5 of the plain
     autograd's largest, grad_x and the plain autograd's within
     contributions x 2^-24 x sum|contribution| of the exact (f64) sum;
     each level's im2col and backward kernel times (CUDA graphs), and the
     backward's float4 REDs and loaded bytes from its counting build,
     equal to its design's count (one RED a valid corner and 4 channels)
  13b. the memory read's transpose (kernel 2b): `torch.autograd.grad` of
     `memory_read` in features at 8192 x 512 with 480x640 random and
     coherent ids, and of `memory_read_batched` at B = 4, launches counted
     (3); the kernel equal bit for bit to the window-order sum
     (`memory_read_grad_window_order`) and to a second call; against the
     exact (f64) sum s of the n bf16(g / 16) contributions c: the kernel
     (an f32 sum rounded once to bf16) within ((2^-8 + 2^-23)|s| +
     (1 + 2^-7) n 2^-24 sum|c|) / denominator, the plain autograd (bf16
     accumulation, as JAX's) within n 2^-8 sum|c| / denominator
  14. the single-frame evaluation (`engine/coco.py:evaluate_coco`) at the
     default config with memory_type image_only over 16 in-memory images
     of 480x640, 480x500, 400x640 and 360x640 (letterboxed into 480x640
     with no resize) with 1-20 GT boxes each: a warm-up run under the sync
     debug mode "warn" (host syncs listed; none inside a frame), a timed
     run with launches counted (2 NMS and 3 ROIAlign an image, nothing
     else), ms an image and images/s, the device busy share (a profiled
     run), peak memory, finite AP under the COCO protocol (raw ids) and
     the LVIS-federated one (a 1-based json with neg_category_ids,
     remapped); then, where PIL is present, `python -m
     embodied_object_detection_tpu_torch.run --coco-json J
     --coco-json-test J2 --max-iter 3` on PNGs in a temporary directory
     (a printed line says it was skipped where PIL is absent)
  14b. Detic's co-training at the default config (image_only, the wsddn
     prop heads, lr 1e-4 from the first step), B = 4: box batches through
     `make_train_step` and image-label (max_size, wsddn), caption and
     captiontag batches (a caption-less row and a padding row) through
     their loss steps, 3 AdamW steps each, all drawn from one
     `multi_source_train_batches` stream over four in-memory sources, the
     captions embedded by the CLIP text tower of phase 15c on the card:
     finite losses, parameters moved, ms a
     step (steps 2-3), peak memory, launches a step (box, image and
     captiontag 4 NMS, 12 ROIAlign and 12 backward; caption 4 and 4 at
     R = 1), the host syncs of one more step
  14c. the 64x96 f32 miniature on the card and on the CPU from the same
     weights: `evaluate_coco`'s detections and AP under both protocols,
     held as phase 10b holds image_only; the max_size and wsddn weak
     losses, the caption and the captiontag losses within rtol 1e-4 and
     their gradients within 1e-3 of each tensor's largest
  15. the Res5 single-frame detector (`roi.head_type=res5`: ResNet-50
     (3, 4, 6, 3) to C4, a one-level CenterNet, 14 x 14 pools on C4
     through the trunk's own stage 4) at 480x640 bf16: `evaluate_coco`
     over phase 14's 16 images under the COCO and the federated protocol
     (a warm-up under the sync debug mode "warn", no synchronising call
     inside a frame; a timed run with launches counted, 2 NMS and 1
     ROIAlign an image; ms an image, the busy share of a profiled run,
     peak memory); then 3 `frame_train` + AdamW steps, one image a step
     (1 NMS, 1 ROIAlign and 1 backward a step at R = 512; finite losses;
     a nonzero gradient in layer4_0.conv1, which only the ROI path
     reaches); then the 64x96 f32 miniature on the card against the CPU:
     detections held as phase 14c holds them, losses within rtol 1e-5,
     gradients within 1e-4 of each tensor's largest
  15b. the Swin-B trunk (`backbone.name=swin_b`, full width) at 480x640
     bf16: the recurrent eval chunk of phase 5 with the default memory
     (no host sync under the sync debug mode "error", launches a frame as
     phase 5's, ms a frame, busy share and the device time by op group of
     a profiled chunk, peak memory); 3 flagship steps at B = 4 through
     `engine/train.py:train` with drop_path_rate 0.2, train_remat off and
     on (as phase 8); one flagship batch loss in f32 with train_remat off
     and on from one coin seed: losses within rtol 1e-6, gradients within
     1e-4 of each tensor's largest; one caption and one max_size
     image-label step; the 64x96 f32 miniature at rate 0 on the card
     against the CPU (detections as 14c, losses rtol 1e-4, gradients 1e-4)
  15c. the CLIP text tower at full width (512 wide, 12 layers, 8 heads) on
     a seeded synthesised state dict and a merges table learned from the
     LVIS names: the 1203 LVIS names with prompt "a " through
     `get_clip_embeddings` on the card and on the CPU (within 1e-5, unit
     norms), ms for the vocabulary; their `build_zs_weight` into one Res5
     image (1203 classes, 2 NMS and 1 ROIAlign)
  16. the parallel paths on a one-rank NCCL group (`parallel/mesh.py:
     init_distributed` on a free local port): (a) the sharded runner, 2
     lanes x 4 frames at 480x640 bf16, launches a lane-frame as phase 5's
     and no host sync; every lane-frame bit-equal to the frame run alone
     on the lane's trunk rows and carried memory, the memory it wrote
     within 1e-5 of that run's (row-wise), the lanes' trunk rows (one
     trunk over the 8 frames) within 2e-2 of a trunk a lane; the two
     designs timed ABBA; (b) `evaluate_dataset_sharded` over 2 streams of
     phase 10's chunks (2 scenes x 2 chunks x 8 frames), implicit and
     semantic_gt, beside `evaluate_dataset`: the same images, every
     lane-frame held as in (a) and chained across chunks, each image its
     lane's frame, frames/s of both; (c) the data-parallel flagship
     (twice, B = 4) and caption steps at world size 1 bit-equal to the
     plain steps, ms a step of both; (d) the build tools' world xyz and
     cell ids of 20 frames at 480x640 within 1e-5 m of the CPU
  17. the RL stack (`rl/`) under a caller's TF32 switched on: each RL
     call must switch it off for its own convolutions and products
     (checked op by op, backward included, on an env step, an update,
     the ResNet policy, MonoDepth and the mapper) and give the caller's
     setting back; (a) `PPOTrainer` at the
     RL CLI's defaults (4 envs x 64 steps, ppo_epoch 2, num_mini_batch 2)
     on the RGB `PointNavPolicy` at hidden 512 and 64x64 frames for 3
     updates: ms an env step and an update, the host syncs of an env step
     (one, the packed copy) and of an update (none, under the sync debug
     mode "error"), peak memory, no port kernel launched; then one update
     on the last rollout, card against CPU on the same minibatch indices:
     metrics within rtol 1e-4, parameters within 1e-5 of each tensor's
     largest, the update p_new - p_old within 1e-4 of its largest; (b) `PointNavResNetPolicy` (resnet50, baseplanes 32, hidden
     512): act and evaluate_actions card against CPU within 1e-4, then a
     `PPOAgent` through `Benchmark` for 2 episodes; (c) `MonoDepthNet`
     (3, 4, 6, 3) at 228x304, seeded (its last conv scaled to depths near
     2 m), card against CPU within 1e-4 of the net's part (the depth
     less that conv's bias), ms a frame, its FLOPs counted
     (`torch.utils.flop_counter`) by part (encoder, D, MFF, R);
     then a `DepthMapperAndPlannerAgent` on that estimator over one
     episode of a 228x304 RGB grid sim (at least 20 steps): kernel 1's
     launches counted, one a map update, each held bit-equal to
     `segment_sum_plain` on the same rows and ids; the map rebuilt from
     the episode's depths and poses on the card and on the CPU (cells
     that differ counted; at most 1e-3 of the points may move); ms a plan
     and its iterations; (d) DD-PPO on a one-rank NCCL group: the update
     bit-equal to the plain update (cuDNN's deterministic algorithms for
     both)
  18. the closing slice: (a) `tools/dataset_prep.py clip-features`
     through its CLI on the card, phase 15c's seeded tower saved as a
     checkpoint and its merges table (CLIP_BPE_PATH), on the 1203 LVIS
     names: the .npy within 1e-5 of the largest element of the same
     command with `--device cpu` (run in a child process beside (b) and
     (c)), ms a vocabulary; (b) the default frame at 480x640 with
     `roi.align_impl` v2 and v3 over a 4-frame chunk (launches counted
     as in phase 5: kernel 4 four times a frame; frame 0's detections of
     the two impls equal, as the card runs one kernel for both), and the
     64x96 miniature of each against the CPU's form of the same impl
     (`hold_detections`); (c) `class_aware_nms` at 2048 candidates of 20
     classes on the card equal to the CPU's plain fixpoint (every kept
     candidate: top-k 2048), one kernel 3 launch a call, its time a call
     eager and in a CUDA graph
  7 also holds kernels 4 and 4b at the co-training pools, R = 129 (128
  random ROIs and the whole-image box) and R = 1 (the whole-image box),
  to the plain tap form as phases 4b and 4f do, and times them beside it
  and their bounds; and at the Res5 shapes, one C4 level of 30 x 40 x
  1024 (stride 16), 14 x 14, s = 2: the forward at R = 256 on random and
  on whole-image boxes (banded) and at R = 512, as phase 4b holds it
  (with the share of outputs bit-equal to the plain tap form), the
  backward at R = 512 as phase 4f holds it (its exact sums taken on the
  card in f64), each beside the plain tap form and its bound;
  7 also times both deformable attention kernels (the encoder's shape in
  the JSON line, the decoder's printed, both also on the model's
  locations; the bytes gathered and the backward's float4 REDs, counted
  by the kernels' lanes in their counting build and held to what the
  inputs give the design, and their rates) beside the plain version and
  the reference's grid_sample
  composition (its autograd for the backward),
  the deformable convolution's kernels at 60x80x256 (the JSON entries:
  the im2col kernel, and the backward kernel on the columns' gradient,
  beside the plain columns and a grid_sample composition, their autograd
  for 9b; each entry's `op`: the op with its f32 matmuls beside the plain
  version and the composition with the same matmul), and the read's
  transpose beside the plain autograd and the autograd of row 2's
  F.embedding_bag(mean) yardstick; and kernel 1 at the SLAM mapper's
  shape (K = 1, 127^2 cells, the 69 312 rows of a 228x304 depth), on
  phase 17c's last map update, beside the plain version, `index_add_`
  and its bound.

With --profile, phases 5, 8 and 10 also print each port kernel's device
time a call in the profiled chunk, step and engine run (10: the engine
over its first 2 chunks), the mask paste + write selection a frame, and
the device's busy time a frame; phase 12b writes each DETR variant's
device ops a frame into DIR.

It then prints one JSON line of kernels, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Without a card, or without the rest of
the repository beside it, it exits non-zero before printing a result.
"""

import argparse
import collections
import copy
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
T_FRAMES = 4
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# the proposals on the canvas, wherever autograd records none of the head:
# one pack, one GroupNorm a tower layer, one decode
PACKED_PROPOSALS = {"centernet_pack": 1, "group_norm_relu": 4,
                    "centernet_decode": 1}
# launches of each kernel in one frame of the eval path: proposal, final
# and write NMS; three cascade stages and the mask pooler; the proposals
LAUNCHES_PER_FRAME = {"segment_sum": 1, "memory_read": 1, "nms": 3,
                      "roi_align": 4, "mask_paste": 1, "write_select": 1,
                      **PACKED_PROPOSALS}
TRAIN_FRAMES = 4        # B: ims_per_batch 2 x 2 frames a chunk
TRAIN_STEPS = 3
# launches of each kernel in one training step: one batched read, then per
# frame the proposals' decode (the head runs level by level: autograd
# records it) and NMS, and three cascade stages' pooling and its backward
LAUNCHES_PER_STEP = {"memory_read_batched": 1, "nms": TRAIN_FRAMES,
                     "roi_align": 3 * TRAIN_FRAMES,
                     "roi_align_backward": 3 * TRAIN_FRAMES,
                     "centernet_decode": TRAIN_FRAMES}
STRIDES = (8, 16, 32)
LEVEL_SHAPES = ((60, 80), (30, 40), (15, 20))     # p3-p5 at 480x640
COHERENT_BLOCK = 16     # pixels a side of the squares that share a cell
# launches a frame with an external GT memory: no write, so no write NMS,
# mask pooler, paste, selection or segment-sum; the proposals
LAUNCHES_PER_FRAME_EXTERNAL = {"segment_sum": 0, "memory_read": 1, "nms": 2,
                               "roi_align": 3, "mask_paste": 0,
                               "write_select": 0, **PACKED_PROPOSALS}


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def graph_ms(fn, reps: int = 20, replays: int = 10) -> float:
    """Device time of one fn() call: `reps` calls captured in a CUDA graph
    (no host launch overhead in the timing), replayed `replays` times
    between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def event_ms(fn, reps: int = 20) -> float:
    """Time of one fn() call from CUDA events around `reps` eager calls,
    host waits included: for a plain version that synchronises with the
    host and so cannot be captured in a graph."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_counters():
    """Kernel name -> the wrapper whose `launches` counts its launches."""
    from embodied_object_detection_tpu_torch.ops import (
        centernet, deform_conv, mask_paste, memory_ops, ms_deform_attn, nms,
        roi_align, segment_sum)
    return {"segment_sum": segment_sum.segment_sum,
            "memory_read": memory_ops.memory_read,
            "nms": nms.nms_keep,
            "roi_align": roi_align.roi_align_cuda,
            "roi_align_backward": roi_align.roi_align_backward_cuda,
            "mask_paste": mask_paste.paste_masks,
            "memory_read_batched": memory_ops.memory_read_batched,
            "write_select": memory_ops.write_select,
            "ms_deform_attn": ms_deform_attn.ms_deform_attn_cuda,
            "ms_deform_attn_backward":
                ms_deform_attn.ms_deform_attn_backward_cuda,
            "deform_im2col": deform_conv.deform_im2col_cuda,
            "deform_im2col_backward": deform_conv.deform_im2col_backward_cuda,
            "memory_read_backward": memory_ops.memory_read_backward_cuda,
            "centernet_pack": centernet.pack_levels,
            "group_norm_relu": centernet.group_norm_relu,
            "centernet_decode": centernet.centernet_decode}


def zero_counters():
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counters():
    return {name: fn.launches for name, fn in kernel_counters().items()}


def bound_ms(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase(n: int, text: str) -> None:
    print(f"[phase {n}] {text}", flush=True)


# ------------------------------------------------------------------ phases

def build_kernels():
    from embodied_object_detection_tpu_torch.kernels import build
    t0 = time.perf_counter()
    # and the counting builds of kernel 8 (phase 7 reads its gathers from
    # it) and of 9b (phase 13 reads its REDs from it)
    report = build.build(counting=("ms_deform_attn", "deform_conv"))
    for name, (secs, log) in report.items():
        print(f"  built {name} in {secs:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"    {line.strip()}")
    counting = sum(name.endswith("(counting)") for name in report)
    phase(2, f"kernels ready in {time.perf_counter() - t0:.1f} s "
             f"({len(report) - counting} of "
             f"{len(set(map(build.source, build.ENTRY_POINTS)))} sources "
             f"and {counting} counting build"
             f"{'' if counting == 1 else 's'} compiled, "
             f"{len(build.ENTRY_POINTS)} entry points)")


def coherent_proj(rng, h=480, w=640, cells=8192, block=COHERENT_BLOCK):
    """Cell ids where each block x block square of pixels shares a cell
    (the blocks' cells drawn without repeats), as a real projection's
    neighbouring pixels share their floor cell."""
    by, bx = -(-h // block), -(-w // block)
    cell = rng.permutation(cells)[:by * bx].reshape(by, bx)
    return np.ascontiguousarray(np.repeat(np.repeat(cell, block, 0), block,
                                          1)[:h, :w]).astype(np.int32)


def segment_sum_inputs(rng, ids="random", cells=8192):
    """Weights-plus-count rows like the memory write's: each selected pixel
    is covered by 1-3 of the 100 masks (weight 1/c each) and carries a
    count of 1; unselected slots carry id -1. `ids`: "random" cells,
    "coherent" (slot j of image row y is pixel (y, 8j) of a
    `coherent_proj`, so runs of slots and the slots of neighbouring image
    rows share cells) or "one_cell"."""
    rows, n = 480 * 80, 100
    w = np.zeros((rows, n + 1), np.float32)
    cover = rng.randint(1, 4, rows)
    lanes = np.argsort(rng.rand(rows, n), axis=1)[:, :3]   # distinct masks
    for c in (1, 2, 3):
        r = np.flatnonzero(cover == c)
        w[r[:, None], lanes[r, :c]] = 1.0 / c
    w[:, n] = 1.0
    if ids == "one_cell":
        idx = np.full(rows, 5, np.int32)
    elif ids == "coherent":
        idx = coherent_proj(rng, cells=cells)[:, ::8].reshape(-1).copy()
    else:
        idx = rng.randint(0, cells, rows).astype(np.int32)
    idx[rng.rand(rows) < 0.1] = -1
    idx[rng.rand(rows) < 0.02] = cells + 7
    return (torch.from_numpy(w).cuda(), torch.from_numpy(idx).cuda(), cells)


def check_segment_sum(rng, cells=8192, tag=3):
    """Phase 3 (and phase 11's check at the robot map's cells, `tag`
    None: no phase line)."""
    from embodied_object_detection_tpu_torch.ops import segment_sum as ss
    worst = 0.0
    for ids in ("random", "coherent", "one_cell"):
        w, idx, cells = segment_sum_inputs(rng, ids, cells)
        got = ss.segment_sum(w, idx, cells)
        want = ss.segment_sum_plain(w, idx, cells)
        torch.cuda.synchronize()
        keep = (idx >= 0) & (idx < cells)
        rows_in_cell = torch.bincount(idx[keep].long(), minlength=cells)
        abs_sum = ss.segment_sum_plain(w.abs(), idx, cells)
        bound = rows_in_cell[:, None] * 2.0 ** -24 * abs_sum + 1e-7
        err = (got - want).abs()
        if got.shape != want.shape or not bool((err <= bound).all()):
            raise AssertionError(f"segment_sum disagrees: max err "
                                 f"{float(err.max())} ({ids} ids)")
        if not torch.equal(got[:, -1], rows_in_cell.float()):
            raise AssertionError(f"segment_sum count lane is not exact "
                                 f"({ids} ids)")
        worst = max(worst, float(err.max()))
        runs = int((idx[1:] != idx[:-1]).sum()) + 1
        print(f"  {ids} ids ({runs} runs of equal ids in {idx.numel()} "
              f"rows): max |kernel - plain| = {float(err.max()):.3e}, "
              f"count lane exact")
    if tag is not None:
        phase(tag, "segment_sum agrees with its plain version on random, "
                   "coherent and one-cell ids (tolerance: rows in the cell * "
                   "2^-24 * sum|w| per entry; count lane exact)")
    return worst


def memory_read_inputs(rng, cells=8192):
    feats = torch.from_numpy(
        (rng.randn(cells, 512) * 4).astype(np.float32)).cuda()
    obs = torch.from_numpy(
        rng.choice([0.0, 1.0, 2.0, 5.0], cells).astype(np.float32)).cuda()
    proj = torch.from_numpy(
        rng.randint(0, cells, (480, 640)).astype(np.int32)).cuda()
    return feats, obs, proj


def check_memory_read(rng, cells=8192, tag=4):
    """Phase 4 (and phase 11's check at the robot map's cells, `tag`
    None: no phase line)."""
    from embodied_object_detection_tpu_torch.ops import memory_ops
    feats, obs, proj = memory_read_inputs(rng, cells)
    errs = []
    for p in (proj, torch.from_numpy(coherent_proj(rng,
                                                   cells=cells)).cuda()):
        got = memory_ops.memory_read(feats, obs, p)
        want = memory_ops.memory_read_plain(feats, obs, p)
        torch.cuda.synchronize()
        errs.append(float((got - want).abs().max()))
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    if tag is not None:
        phase(tag, f"memory_read agrees with its plain version on random "
                   f"and coherent ids: max err {errs[0]:.3e} and "
                   f"{errs[1]:.3e} (tolerance rtol 1e-6, atol 1e-6)")
    return max(errs)


NMS_CASES = (
    # (name, candidates, classes, threshold, ml_nms bypass, chain shift);
    # a 100-px box shifted by `shift` overlaps its chain neighbour above
    # the threshold and the one after that below it
    ("proposal NMS, t = 0.9", 1024, 1, 0.9, True, 4.0),
    ("proposal NMS, t = 0 (ml_nms bypass)", 1024, 1, 0.0, True, 4.0),
    ("training proposal NMS, t = 0.9", 2000, 1, 0.9, True, 4.0),
    ("multiclass NMS, 20 classes, t = 0.5", 2048, 20, 0.5, False, 25.0),
)
MULTICLASS_CASE = NMS_CASES[3][0]     # the kernels line's NMS entry
CLASS_SIZES = (0, 1, 63, 64, 65, 130)
# the class partition's cases, from a generator of their own so that the
# cases above draw the same inputs as before them; `classes` is a count of
# classes drawn at random, member counts per class (no chain), or "wide"
# (class ids -5, 0 and 1000: more than the partition's 256 bins)
PARTITION_CASES = (
    ("classes of 0/1/63/64/65/130 members, t = 0.5", 323, CLASS_SIZES, 0.5,
     False, 25.0),
    ("classes of 0/1/63/64/65/130 members, t = 0.9", 323, CLASS_SIZES, 0.9,
     False, 25.0),
    ("classes of 0/1/63/64/65/130 members, t = 0 (no bypass)", 323,
     CLASS_SIZES, 0.0, False, 25.0),
    ("the chain among 4 classes, t = 0.5", 1024, 4, 0.5, False, 25.0),
    ("one class of 2048, t = 0.5", 2048, 1, 0.5, False, 25.0),
    ("class ids beyond 256 bins, t = 0.5", 2048, "wide", 0.5, False, 25.0),
    ("one class of 5000 (more than 32 words), t = 0.5", 5000, 1, 0.5, False,
     25.0),
    ("3 classes over 3000 candidates, t = 0.5", 3000, 3, 0.5, False, 25.0),
)
CHAIN = 150


def nms_inputs(rng, n, classes, shift):
    """Score-sorted candidates like the frame's (random boxes over the
    image; a third of the scores rounded to sixteenths, so many tie
    exactly; a tenth of the boxes duplicated; 5 % invalid), led by a
    suppression chain of CHAIN boxes of class 0 with descending scores
    unless `classes` gives member counts, sorted as `_nms_core` sorts
    them."""
    from embodied_object_detection_tpu_torch.ops import nms
    xy = rng.uniform(-20, 600, (n, 2)) * np.array([1.0, 0.75])
    boxes = np.concatenate([xy, xy + rng.uniform(8, 200, (n, 2))], 1)
    scores = rng.rand(n)
    scores[::3] = np.round(scores[::3] * 16) / 16
    dup = rng.choice(n - 1, n // 10, replace=False)
    boxes[dup] = boxes[dup + 1]
    if isinstance(classes, tuple):
        cls = np.concatenate([np.full(k, c) for c, k in enumerate(classes)])
        rng.shuffle(cls)
    else:
        cls = (rng.choice([-5, 1000], n) if classes == "wide"
               else rng.randint(0, classes, n))
    valid = rng.rand(n) > 0.05
    if not isinstance(classes, tuple):
        c = np.arange(CHAIN)
        boxes[:CHAIN] = np.stack([10 + c * shift, np.full(CHAIN, 100.0),
                                  110 + c * shift, np.full(CHAIN, 180.0)], 1)
        scores[:CHAIN] = 2.0 - c / CHAIN
        cls[:CHAIN], valid[:CHAIN] = 0, True
    b = torch.from_numpy(boxes.astype(np.float32)).cuda()
    sc = torch.from_numpy(scores.astype(np.float32)).cuda()
    cl = torch.from_numpy(cls.astype(np.int32)).cuda()
    v = torch.from_numpy(valid).cuda()
    _, order = nms.sort_desc(torch.where(v, sc, sc.new_full((), nms.NEG_INF)))
    return b[order].contiguous(), cl[order].contiguous(), v[order].contiguous()


def check_nms(rng):
    from embodied_object_detection_tpu_torch.ops import nms
    part_rng = np.random.RandomState(4)
    for cases, r in ((NMS_CASES, rng), (PARTITION_CASES, part_rng)):
        for name, n, classes, t, ml, shift in cases:
            b, c, v = nms_inputs(r, n, classes, shift)
            disabled = ml and not t > 0
            got = nms.nms_keep(b, c, v, t, disabled)
            want = nms.nms_keep_plain(b, c, v, t, disabled)
            torch.cuda.synchronize()
            differ = int((got != want).sum())
            if differ:
                raise AssertionError(f"nms {name}: {differ} keep flags differ "
                                     "from the plain fixpoint")
            chained = not isinstance(classes, tuple)
            if chained:
                chain = got[:CHAIN].cpu().numpy()
                expect = v[:CHAIN].cpu().numpy() if disabled \
                    else np.arange(CHAIN) % 2 == 0
                if not (chain == expect).all():
                    raise AssertionError(f"nms {name}: the {CHAIN}-deep chain "
                                         "is not resolved greedily")
            print(f"  {name}: N = {n}, {int(v.sum())} valid, "
                  f"{int(got.sum())} kept, keep set equal to the plain "
                  f"fixpoint" + (f", the {CHAIN}-deep chain greedy"
                                 if chained else ""))
    phase("4a", "nms keep sets equal the plain fixpoint in every case "
                "(ties, duplicated boxes, chain deeper than 64; 2000 "
                "candidates at training; classes of 0-130 members, one "
                "class, class ids beyond the bins, 3000 and 5000 "
                "candidates)")
    return 0.0


def roi_inputs(rng, r, dtype):
    """p3-p5 [H, W, 256] levels of `dtype` and [r, 4] boxes whose sides
    span all three levels' assignment and cross the image border."""
    levels = [torch.from_numpy(rng.randn(h, w, 256).astype(np.float32))
              .cuda().to(dtype) for h, w in LEVEL_SHAPES]
    side = np.exp(rng.uniform(np.log(16), np.log(900), r))
    aspect = np.exp(rng.uniform(-0.7, 0.7, r))
    bw, bh = side * np.sqrt(aspect), side / np.sqrt(aspect)
    cx, cy = rng.uniform(-40, 680, r), rng.uniform(-40, 520, r)
    boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], 1)
    return levels, torch.from_numpy(boxes.astype(np.float32)).cuda()


def roi_levels(boxes):
    from embodied_object_detection_tpu_torch.ops import roi_align
    return (roi_align.assign_levels(boxes, 3, 5) - 3).contiguous()


# (name, boxes in image pixels, whether their grids exceed the budget) of
# phase 4b's edge cases: a whole level has 300 positions, the wide box 392
# (7 x 7) and 784 (14 x 14), the budget is 288
ROI_EDGE_CASES = (
    ("under one level pixel", [[100.3, 60.2, 104.1, 63.9],
                               [300.0, 200.0, 300.4, 200.3],
                               [636.0, 476.0, 639.5, 479.9]], False),
    ("a whole level (p5)", [[0.0, 0.0, 640.0, 480.0]], True),
    ("beyond the image (p5)", [[-300.0, -200.0, 940.0, 680.0]], False),
    ("wide on p3 (480 x 100)", [[40.0, 160.0, 520.0, 260.0]], True),
)


def staged_grids(stats):
    """(min, median, max) of each ROI's largest staged grid and the count
    of ROIs taken in bands, from the kernel's stats."""
    st = stats.cpu().numpy()
    grid = st[:, 0]
    return (int(grid.min()), float(np.median(grid)), int(grid.max()),
            int((st[:, 2] > 0).sum()))


def plain_taps_cpu(levels, boxes, strides, size, lvl, chunk=64):
    """The plain tap form on the CPU, `chunk` ROIs at a time (each ROI's
    output is its own, so the chunks change nothing but the memory)."""
    from embodied_object_detection_tpu_torch.ops import roi_align as ra
    levels = [f.cpu() for f in levels]
    boxes, lvl = boxes.cpu(), lvl.cpu()
    return torch.cat([ra._roi_align_taps(levels, boxes[i:i + chunk], strides,
                                         size, 2, lvl[i:i + chunk])
                      for i in range(0, boxes.shape[0], chunk)])


def check_roi_case(levels, boxes, size, strides=STRIDES, lvl=None,
                   report=None):
    """The kernel in f32 against the plain tap form on the CPU, in bf16
    against it and the plain v4; returns (f32 error, bf16 errors, stats).
    `lvl` defaults to the FPN assignment over p3-p5; `report`, a dict,
    receives the share of f32 outputs equal to the plain form's bit for
    bit."""
    from embodied_object_detection_tpu_torch.ops import roi_align as ra
    lvl = roi_levels(boxes) if lvl is None else lvl
    r = boxes.shape[0]
    # the tap form is held on the CPU: there `/ output_size` is a true
    # division, as in the kernel and the JAX package, while PyTorch's
    # CUDA division by a Python scalar multiplies by its reciprocal,
    # which moves bin_w, and so the sample coordinates, by an ulp
    stats = torch.zeros((r, 3), dtype=torch.int32, device="cuda")
    got = ra.roi_align_cuda(levels, boxes, lvl, strides, size, 2,
                            stats=stats).cpu()
    want = plain_taps_cpu(levels, boxes, strides, size, lvl)
    err32 = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if report is not None:
        report["bit_equal"] = float((got == want).float().mean())

    levels16 = [f.to(torch.bfloat16) for f in levels]
    got16 = ra.roi_align_cuda(levels16, boxes, lvl, strides, size, 2)
    v1 = plain_taps_cpu(levels16, boxes, strides, size, lvl)
    v4 = ra._roi_align_matmul(levels16, boxes, strides, size, 2, lvl)
    torch.cuda.synchronize()
    fmax = max(float(f.float().abs().max()) for f in levels16)
    err_v1 = (got16.float().cpu() - v1).abs()
    if not bool((err_v1 <= 2.0 ** -8 * v1.abs() + 1e-6).all()):
        raise AssertionError(f"roi_align bf16 differs from v1 by "
                             f"{float(err_v1.max())}")
    err_v4 = float((got16.float() - v4.float()).abs().max())
    tol_v4 = 2.0 ** -7 * fmax
    if not err_v4 <= tol_v4:
        raise AssertionError(f"roi_align bf16 differs from v4 by "
                             f"{err_v4} > {tol_v4}")
    return err32, float(err_v1.max()), err_v4, err_v4 / fmax, tol_v4, stats


def check_roi_align(rng):
    worst = 0.0
    for r, size in ((256, 7), (100, 14)):
        levels, boxes = roi_inputs(rng, r, torch.float32)
        lvl = roi_levels(boxes)
        hits = torch.bincount(lvl.long(), minlength=3).tolist()
        b = boxes.cpu().numpy()
        outside = int(((b[:, 0] < 0) | (b[:, 1] < 0) | (b[:, 2] > 640) |
                       (b[:, 3] > 480)).sum())
        if min(hits) == 0 or outside == 0:
            raise AssertionError(f"roi_align inputs reach levels {hits} and "
                                 f"cross the border {outside} times")
        err32, err_v1, err_v4, rel_v4, tol_v4, stats = check_roi_case(
            levels, boxes, size)
        worst = max(worst, err32)
        lo, med, hi, banded = staged_grids(stats)
        print(f"  R = {r}, {size}x{size}: rois per level {hits}, {outside} "
              f"cross the border; f32 vs v1 (CPU) max err {err32:.3e} "
              f"(tolerance rtol/atol 1e-5); bf16 vs v1 (CPU) max err "
              f"{err_v1:.3e} (one bf16 output rounding, <= 2^-8 |v1|); bf16 "
              f"vs v4 max err {err_v4:.3e} = {rel_v4:.2e} max|f| (tolerance "
              f"2^-7 max|f| = {tol_v4:.3e}); staged grid positions min "
              f"{lo}, median {med:g}, max {hi}; {banded} of {r} ROIs in "
              f"bands")
    # the edge cases, from a generator of their own, each ahead of 256
    # random ROIs: with that many the kernel takes all of a ROI's output
    # rows in one block (it splits them only when its blocks are too few
    # to fill the card, as for the mask pooler's R = 100)
    edge_rng = np.random.RandomState(7)
    levels, others = roi_inputs(edge_rng, 256, torch.float32)
    for name, edge, must_band in ROI_EDGE_CASES:
        k = len(edge)
        boxes = torch.cat([torch.tensor(edge, dtype=torch.float32).cuda(),
                           others])
        for size in (7, 14):
            err32, err_v1, err_v4, _, _, stats = check_roi_case(
                levels, boxes, size)
            worst = max(worst, err32)
            lo, _, hi, banded = staged_grids(stats[:k])
            print(f"  {name}, {size}x{size}: levels "
                  f"{(roi_levels(boxes[:k]) + 3).tolist()}, staged grid "
                  f"positions {lo}-{hi}, {banded} of {k} in bands; f32 vs "
                  f"v1 max err {err32:.3e}, bf16 vs v1 {err_v1:.3e}, vs v4 "
                  f"{err_v4:.3e} (with 256 random ROIs)")
            if name.startswith("under") and hi > 4:
                raise AssertionError(f"a ROI under one level pixel staged "
                                     f"{hi} positions")
            if must_band and banded == 0:
                raise AssertionError(f"roi_align {name}: not taken in bands")
    phase("4b", "roi_align agrees with the plain tap form (on the CPU, "
                "f32, rtol/atol 1e-5) and with the plain v4 (bf16, 2^-7 "
                "max|features|: v4 rounds its weights, its intermediate and "
                "its output to bf16, the kernel its output, each at most "
                "2^-9 of the pooled magnitude), random ROIs and ROIs under "
                "one level pixel, over a whole level, beyond the image and "
                "wide (the whole level and the wide ROI in bands)")
    return worst


def paste_inputs(rng, n=100, m=28, edges=False):
    """n random masks and boxes over 480 x 640; with `edges`, the first
    box covers the image and the next three lie wholly outside it."""
    probs = rng.rand(n, m, m).astype(np.float32)
    x0 = rng.uniform(-60, 600, n)
    y0 = rng.uniform(-60, 440, n)
    boxes = np.stack([x0, y0, x0 + rng.uniform(4, 400, n),
                      y0 + rng.uniform(4, 300, n)], 1).astype(np.float32)
    if edges:
        boxes[:4] = [[-3, -1, 645, 482], [650, 10, 700, 90],
                     [20, -90, 80, -5], [-70, 490, -10, 560]][:n]
    return torch.from_numpy(probs).cuda(), torch.from_numpy(boxes).cuda()


# (masks, threshold, pixel_major, x_stride) of phase 4c's edge cases
PASTE_CASES = ((1, 0.5, True, 1), (130, 0.5, True, 1), (100, 0.0, True, 1),
               (130, -1.0, True, 1), (100, -1.0, False, 8),
               (130, 0.0, False, 8), (1, -1.0, False, 1))


def check_paste(masks, boxes, threshold, pixel_major, x_stride):
    """The kernel against the plain version: values within atol 1e-6, and
    at a threshold at most one flip in 10^4 pixels, each within 1e-5 of
    it. Returns (max value error, flips, pixels)."""
    from embodied_object_detection_tpu_torch.ops import mask_paste as mp
    kw = dict(x_stride=x_stride, pixel_major=pixel_major)
    vals = mp.paste_masks(masks, boxes, 480, 640, -1.0, **kw)
    want_vals = mp.paste_masks_plain(masks, boxes, 480, 640, -1.0, **kw)
    torch.cuda.synchronize()
    err = float((vals - want_vals).abs().max())
    torch.testing.assert_close(vals, want_vals, rtol=0, atol=1e-6)
    if threshold < 0:
        return err, 0, vals.numel()
    got = mp.paste_masks(masks, boxes, 480, 640, threshold, **kw)
    want = mp.paste_masks_plain(masks, boxes, 480, 640, threshold, **kw)
    torch.cuda.synchronize()
    flipped = got != want
    flips = int(flipped.sum())
    near = bool(((want_vals[flipped] - threshold).abs() < 1e-5).all())
    if flips > max(1, got.numel() // 10000) or not near:
        raise AssertionError(f"mask paste: {flips} flips at {threshold} "
                             f"(near it: {near})")
    return err, flips, got.numel()


def check_mask_paste(rng):
    masks, boxes = paste_inputs(rng)
    worst = 0.0
    for pixel_major, x_stride in ((True, 1), (False, 8)):
        err, flips, pixels = check_paste(masks, boxes, 0.5, pixel_major,
                                         x_stride)
        worst = max(worst, err)
        print(f"  pixel_major={pixel_major}, x_stride={x_stride}: values max "
              f"err {err:.3e} (atol 1e-6); {flips} of {pixels} pixels "
              f"flipped at 0.5, all within 1e-5 of it")
    # the edge cases, from a generator of their own
    edge_rng = np.random.RandomState(5)
    for n, threshold, pixel_major, x_stride in PASTE_CASES:
        masks, boxes = paste_inputs(edge_rng, n, edges=True)
        err, flips, pixels = check_paste(masks, boxes, threshold,
                                         pixel_major, x_stride)
        worst = max(worst, err)
        print(f"  N = {n}, threshold {threshold}, pixel_major={pixel_major}, "
              f"x_stride={x_stride}, a covering box and boxes outside: "
              f"values max err {err:.3e}; {flips} of {pixels} flipped")
    phase("4c", "mask_paste agrees with its plain version (values within "
                "atol 1e-6; at most one flip in 10^4 pixels, and only where "
                "|plain - threshold| < 1e-5), 1-130 masks, thresholds 0.5, "
                "0 and -1, both layouts")
    return worst


def select_inputs(rng):
    """The two-pass selection's inputs: 100 masks pasted into 480 x 640
    (pixel-major, by the paste kernel), with one image row no mask covers
    and one every mask covers; a fifth of the detections invalid; random
    cell ids."""
    from embodied_object_detection_tpu_torch.ops import mask_paste as mp
    probs, boxes = paste_inputs(rng)
    masks = mp.paste_masks(probs, boxes, 480, 640, 0.5, pixel_major=True)
    masks[100] = False
    masks[101] = True
    valid = torch.from_numpy(rng.rand(100) > 0.2).cuda()
    proj = torch.from_numpy(
        rng.randint(0, 8192, (480, 640)).astype(np.int32)).cuda()
    return masks.contiguous(), valid, proj


# (masks, threshold) of phase 4d's fused cases: the frame's, N % 4 != 0,
# two passes of the paste's 128 masks, and every value >= 0
SELECT_CASES = ((100, 0.5), (99, 0.5), (130, 0.5), (100, 0.0))
FULL_ROWS = (114, 126)          # rows mask 0 (all ones) covers
EMPTY_ROWS = (300, 312)         # rows no valid mask reaches


def fused_select_inputs(rng, n):
    """The exact write's paste inputs: n random masks and boxes, mask 0
    all ones over a band of full image rows, a fifth of the detections
    invalid and every detection whose box comes near EMPTY_ROWS too;
    random cell ids."""
    probs, boxes = paste_inputs(rng, n)
    probs[0] = 1.0
    boxes[0] = torch.tensor([-3.0, 110.0, 645.0, 130.0], device="cuda")
    b = boxes.cpu().numpy()
    near = (b[:, 1] < EMPTY_ROWS[1] + 20) & (b[:, 3] > EMPTY_ROWS[0] - 20)
    valid = (rng.rand(n) > 0.2) & ~near
    valid[0] = True
    proj = torch.from_numpy(
        rng.randint(0, 8192, (480, 640)).astype(np.int32)).cuda()
    return probs, boxes, torch.from_numpy(valid).cuda(), proj


def check_fused_select(probs, boxes, valid, proj, threshold):
    """The paste with its flag epilogue, then the selection on its flags,
    against the plain paste, its flags and the plain selection. Returns
    (flips, filled slots)."""
    from embodied_object_detection_tpu_torch.ops import mask_paste as mp
    from embodied_object_detection_tpu_torch.ops import memory_ops
    h, w = 480, 640
    masks, observed, counts = mp.paste_masks_observed(probs, boxes, valid, h,
                                                      w, threshold)
    seg, aug = memory_ops.write_select(masks, valid, proj, 8, observed,
                                       counts)
    plain = mp.paste_masks_plain(probs, boxes, h, w, threshold,
                                 pixel_major=True)
    torch.cuda.synchronize()
    flipped = masks != plain
    flips = int(flipped.sum())
    if flips:
        vals = mp.paste_masks_plain(probs, boxes, h, w, -1.0,
                                    pixel_major=True)
        near = bool(((vals[flipped] - threshold).abs() < 1e-5).all())
        if flips > max(1, plain.numel() // 10000) or not near:
            raise AssertionError(f"fused paste: {flips} flips (near the "
                                 f"threshold: {near})")
    # the flags, counts, ids and rows of the kernel's masks, and when no
    # value flipped, of the plain paste's: equal in every element
    for ref in (masks,) if flips else (masks, plain):
        want_obs = (ref & valid).any(dim=-1)
        tiles = counts.shape[1]
        pad = tiles * mp.TILE_COLS - w
        want_counts = torch.nn.functional.pad(want_obs.int(), (0, pad)) \
            .reshape(h, tiles, mp.TILE_COLS).sum(-1, dtype=torch.int32)
        seg_p, aug_p = memory_ops.write_select_plain(ref, valid, proj, 8)
        if not (torch.equal(observed, want_obs) and
                torch.equal(counts, want_counts) and
                torch.equal(seg, seg_p) and torch.equal(aug, aug_p)):
            raise AssertionError(
                f"fused select at threshold {threshold}, N = {len(valid)}: "
                f"{int((observed != want_obs).sum())} flags, "
                f"{int((counts != want_counts).sum())} counts, "
                f"{int((seg != seg_p).sum())} ids, "
                f"{int((aug != aug_p).sum())} weights differ")
    if threshold > 0:
        rows = observed[FULL_ROWS[0]:FULL_ROWS[1]]
        if not (bool(rows.all()) and
                not bool(observed[EMPTY_ROWS[0]:EMPTY_ROWS[1]].any())):
            raise AssertionError("fused select: the full rows are not full "
                                 "or the empty rows not empty")
    return flips, int((seg >= 0).sum())


def check_write_select(rng):
    from embodied_object_detection_tpu_torch.ops import memory_ops
    fused_rng = np.random.RandomState(11)
    for n, threshold in SELECT_CASES:
        probs, boxes, valid, proj = fused_select_inputs(fused_rng, n)
        flips, filled = check_fused_select(probs, boxes, valid, proj,
                                           threshold)
        print(f"  fused paste + select, N = {n}, threshold {threshold}: "
              f"{flips} pasted values flip against the plain paste; flags, "
              f"counts, ids and rows equal to the plain chain; {filled} "
              f"slots filled" + (f"; rows {FULL_ROWS[0]}-{FULL_ROWS[1] - 1} "
                                 f"full, rows {EMPTY_ROWS[0]}-"
                                 f"{EMPTY_ROWS[1] - 1} empty"
                                 if threshold > 0 else ""))
    masks, valid, proj = select_inputs(rng)
    seg, aug = memory_ops.write_select(masks, valid, proj, 8)
    seg_p, aug_p = memory_ops.write_select_plain(masks, valid, proj, 8)
    torch.cuda.synchronize()
    if not (torch.equal(seg, seg_p) and torch.equal(aug, aug_p)):
        raise AssertionError(
            f"write_select differs from its plain version: "
            f"{int((seg != seg_p).sum())} ids, "
            f"{int((aug != aug_p).sum())} weights")
    filled = int((seg >= 0).sum())
    print(f"  two-pass selection on masks alone: {filled} of {seg.numel()} "
          f"slots filled; row 100 empty, row 101 full; ids and "
          f"[{aug.shape[0]}, {aug.shape[1]}] rows equal to the plain version")
    phase("4d", "the mask paste's flags and the selection on them equal the "
                "plain chain in every element (masks within the paste's "
                "flip bound), 99-130 masks, thresholds 0.5 and 0, full and "
                "empty rows; the two-pass selection equals its plain "
                "version")
    return 0.0


def check_memory_read_batched(rng, b=TRAIN_FRAMES):
    from embodied_object_detection_tpu_torch.ops import memory_ops
    feats = torch.from_numpy(
        (rng.randn(b, 8192, 512) * 4).astype(np.float32)).cuda()
    obs = torch.from_numpy(rng.choice([0.0, 1.0, 2.0, 5.0], (b, 8192))
                           .astype(np.float32)).cuda()
    proj = torch.from_numpy(
        rng.randint(0, 8192, (b, 480, 640)).astype(np.int32)).cuda()
    got = memory_ops.memory_read_batched(feats, obs, proj)
    singles = torch.stack([memory_ops.memory_read(feats[i], obs[i], proj[i])
                           for i in range(b)])
    plain = memory_ops.memory_read_batched_plain(feats, obs, proj)
    torch.cuda.synchronize()
    if not torch.equal(got, singles):
        raise AssertionError(f"memory_read_batched differs from {b} single "
                             f"reads in {int((got != singles).sum())} values")
    err = float((got - plain).abs().max())
    torch.testing.assert_close(got, plain, rtol=1e-6, atol=1e-6)
    phase("4e", f"memory_read_batched (B = {b}) equals {b} memory_read "
                f"calls in every element; max err against its plain "
                f"version {err:.3e} (rtol/atol 1e-6)")
    return err


def flat_levels(grads):
    return torch.cat([g.float().cpu().reshape(-1, g.shape[-1])
                      for g in grads])


def backward_atomics(levels, boxes, lvl, c, size=7, strides=STRIDES):
    """(scalar, vector): the atomic adds a kernel that adds every nonzero
    tap's contribution issues (taps x C), and those the staged-grid
    kernel's flush issues (each distinct position a ROI touches with a
    nonzero weight, once per 4 channels), from the plain tap form."""
    from embodied_object_detection_tpu_torch.ops import roi_align as ra
    rows, wgt = ra.roi_align_taps([f.shape[:2] for f in levels], boxes.cpu(),
                                  strides, size, 2, lvl.cpu())
    total = sum(f.shape[0] * f.shape[1] for f in levels)
    r = boxes.shape[0]
    key = rows.reshape(r, -1) + total * torch.arange(r)[:, None]
    live = wgt.reshape(r, -1) != 0
    return (int(live.sum()) * c,
            int(torch.unique(key[live]).numel()) * (c // 4))


def forward_read_bytes(levels, boxes, lvl, size=7, strides=STRIDES):
    """The bytes of the level positions the ROIs' taps read with a
    nonzero weight, each once (the least a forward must read: a box on
    p5 reads nothing of p3 or p4), from the plain tap form."""
    from embodied_object_detection_tpu_torch.ops import roi_align as ra
    rows, wgt = ra.roi_align_taps([f.shape[:2] for f in levels], boxes.cpu(),
                                  strides, size, 2, lvl.cpu())
    row_bytes = levels[0].shape[-1] * levels[0].element_size()
    return int(torch.unique(rows[wgt != 0]).numel()) * row_bytes


def exact_contributions(levels, boxes, lvl, grad, size, strides=STRIDES,
                        device="cpu"):
    """(count [P], exact [P, C], magnitude [P, C]) over the flattened
    levels: the nonzero tap contributions (grad / s^2) * w of the plain
    tap form on each position, each the f32 product the kernel forms, and
    their sum and the sum of their magnitudes taken exactly (f64), on
    `device`; the taps come from the CPU, whose divisions are the
    kernel's. Summed in any order in f32, n contributions stay within
    (n - 1) 2^-24 sum|c| of the exact sum, so within the n 2^-24 sum|c|
    bound; two f32 orders may differ from each other by up to twice
    that."""
    from embodied_object_detection_tpu_torch.ops import roi_align as ra
    rows, wgt = ra.roi_align_taps([f.shape[:2] for f in levels], boxes.cpu(),
                                  strides, size, 2, lvl.cpu())
    rows, wgt = rows.to(device), wgt.to(device)
    total = sum(f.shape[0] * f.shape[1] for f in levels)
    c = grad.shape[-1]
    g = grad.float().to(device) / 4.0   # s^2 = 4: exact, as __fdiv_rn
    count = torch.zeros(total, device=device).index_add_(
        0, rows.reshape(-1), (wgt.reshape(-1) != 0).float())
    exact = torch.zeros((total, c), dtype=torch.float64, device=device)
    mag = torch.zeros_like(exact)
    for i in range(0, boxes.shape[0], 32):
        prod = (g[i:i + 32, :, None, :, None, None, :] *
                wgt[i:i + 32, ..., None]).reshape(-1, c).double()
        idx = rows[i:i + 32].reshape(-1)
        exact.index_add_(0, idx, prod)
        mag.index_add_(0, idx, prod.abs())
    return count, exact, mag


def check_backward_case(levels, boxes, grad, strict_plain):
    """The backward kernel in f32 and bf16 against the exact sums of the
    plain tap form's contributions, and against torch autograd of the
    plain tap form (in f32 on the CPU, in bf16 on the card); returns (f32
    error from the exact sum, its share of the bound, the share of the
    bound of its difference from the CPU's f32 autograd, the bf16
    shares, the most contributions on one position). With
    `strict_plain`, the f32 autograd is also held within the bound."""
    from embodied_object_detection_tpu_torch.ops import roi_align as ra
    lvl = roi_levels(boxes)
    shapes = [f.shape[:2] for f in levels]
    size = grad.shape[1]
    count, exact, mag = exact_contributions(levels, boxes, lvl, grad, size)
    bound = count[:, None].double() * 2.0 ** -24 * mag
    got = flat_levels(ra.roi_align_backward_cuda(grad, shapes, boxes, lvl,
                                                 STRIDES, 2, torch.float32))
    err = (got.double() - exact).abs()
    if not bool((err <= bound).all()):
        raise AssertionError(f"roi_align backward f32: max err "
                             f"{float(err.max())} from the exact sum beyond "
                             f"n 2^-24 sum|c|")
    # the plain tap form on the CPU, whose divisions are the kernel's
    leaves = [f.cpu().requires_grad_(True) for f in levels]
    plain = flat_levels(torch.autograd.grad(
        ra._roi_align_taps(leaves, boxes.cpu(), STRIDES, size, 2, lvl.cpu()),
        leaves, grad.cpu()))
    err_plain = (got - plain).abs().double()
    if strict_plain and not bool((err_plain <= bound).all()):
        raise AssertionError(f"roi_align backward f32: max err "
                             f"{float(err_plain.max())} from the plain v1 "
                             f"autograd beyond n 2^-24 sum|c|")

    levels16 = [f.to(torch.bfloat16).requires_grad_(True) for f in levels]
    g16 = grad.to(torch.bfloat16)
    got16 = flat_levels(ra.roi_align_backward_cuda(
        g16, shapes, boxes, lvl, STRIDES, 2, torch.bfloat16)).double()
    want16 = flat_levels(torch.autograd.grad(
        ra._roi_align_taps(levels16, boxes, STRIDES, size, 2, lvl), levels16,
        g16.float())).double()
    torch.cuda.synchronize()
    # the exact sum of the bf16-rounded gradient's f32 contributions: the
    # kernel sums the same f32 products and rounds once to bf16
    _, exact16, mag16 = exact_contributions(levels, boxes, lvl, g16, size)
    err_ref = (got16 - exact16).abs()
    tight = 2.0 ** -8 * exact16.abs() + \
        (1 + 2.0 ** -8) * count[:, None].double() * 2.0 ** -24 * mag16
    if not bool((err_ref <= tight).all()):
        raise AssertionError(f"roi_align backward bf16: max err "
                             f"{float(err_ref.max())} from the exact sum "
                             f"beyond 2^-8 |ref| + n 2^-24 sum|c|")
    err16 = (got16 - want16).abs()
    tol16 = (count[:, None].double() + 1) * 2.0 ** -8 * mag16
    if not bool((err16 <= tol16).all()):
        raise AssertionError(f"roi_align backward bf16: max err "
                             f"{float(err16.max())} beyond (n + 1) 2^-8 "
                             f"sum|c|")

    def share(e, b):
        return float((e / b.clamp(min=1e-30)).max())

    return (float(err.max()), share(err, bound), share(err_plain, bound),
            share(err_ref, tight), share(err16, tol16), int(count.max()))


def check_roi_align_backward(rng, r=512):
    levels, boxes = roi_inputs(rng, r, torch.float32)
    grad = torch.from_numpy(rng.randn(r, 7, 7, 256).astype(np.float32)
                            ).cuda()
    worst, s32, s_plain, s_ref, s16, most = check_backward_case(
        levels, boxes, grad, strict_plain=True)
    scalar, vector = backward_atomics(levels, boxes, roi_levels(boxes), 256)
    print(f"  R = {r}, 7x7x256: up to {most} contributions on one position; "
          f"f32 vs the exact sum max err {worst:.3e}, max err / bound "
          f"{s32:.3f}; vs the plain v1 autograd (CPU) {s_plain:.3f}; bf16 "
          f"vs the exact sum of the bf16 gradient's contributions max err "
          f"/ bound {s_ref:.3f}; bf16 vs the card's plain v1 autograd max "
          f"err / bound {s16:.3f}; the flush's float4 "
          f"atomics {vector} (the staged grid's distinct positions x C/4) "
          f"against {scalar:.3e} scalar atomics of a kernel adding every "
          f"tap")
    # the edge cases, from a generator of their own, each ahead of 64
    # random ROIs
    edge_rng = np.random.RandomState(9)
    levels, others = roi_inputs(edge_rng, 64, torch.float32)
    for name, edge, _ in ROI_EDGE_CASES:
        boxes = torch.cat([torch.tensor(edge, dtype=torch.float32).cuda(),
                           others])
        grad = torch.from_numpy(edge_rng.randn(len(boxes), 7, 7, 256)
                                .astype(np.float32)).cuda()
        err, s32, s_plain, s_ref, s16, most = check_backward_case(
            levels, boxes, grad, strict_plain=False)
        worst = max(worst, err)
        k = len(edge)
        _, vector = backward_atomics(levels, boxes[:k], roi_levels(boxes[:k]),
                                     256)
        print(f"  {name}: levels {(roi_levels(boxes[:k]) + 3).tolist()}, "
              f"{vector // 64} distinct positions flushed; f32 max err / "
              f"bound {s32:.3f} from the exact sum ({s_plain:.3f} from the "
              f"plain v1 autograd's own f32 order), bf16 {s_ref:.3f} and "
              f"{s16:.3f} (with 64 random ROIs; up to {most} contributions "
              f"on one position)")
    phase("4f", "roi_align backward within contributions x 2^-24 x "
                "sum|contribution| of the exact sum of the plain v1's f32 "
                "contributions (f32; at R = 512 also of the CPU's plain v1 "
                "autograd); in bf16 within 2^-8 |ref| + (1 + 2^-8) "
                "contributions x 2^-24 x sum|contribution| of the exact sum "
                "of the bf16-rounded gradient's contributions (one final "
                "rounding), and within (contributions + 1) x 2^-8 x "
                "sum|contribution| of the card's plain v1 in bf16 (which "
                "rounds every partial sum); R = 512 and ROIs under one level "
                "pixel, a whole level, beyond the image and wide")
    return worst


def sync_sites(fn) -> collections.Counter:
    """Run fn() under the sync debug mode "warn" and count the call stacks
    (the innermost frames of this repository, and the frame that called
    into torch) of every synchronising CUDA call it makes."""
    import traceback
    sites = collections.Counter()

    inside = []     # only count what fn() does, not the mode switches

    def record(message, category, filename, lineno, file=None, line=None):
        if not inside or "synchroniz" not in str(message):
            return
        frames = traceback.extract_stack()[:-2]
        ours = [f"{Path(f.filename).name}:{f.lineno} {f.name}" for f in frames
                if str(REPO) in f.filename][-4:]
        sites[" <- ".join(reversed(ours)) +
              f" -> {Path(filename).name}:{lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            inside.append(True)
            fn()
        finally:
            inside.clear()
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sites


def run_main_path(profile_dir):
    from embodied_object_detection_tpu_torch.config import DetectorConfig
    from embodied_object_detection_tpu_torch.models.detector import (
        build_detector, frame_inputs, make_episode_runner)
    from embodied_object_detection_tpu_torch.ops import memory_ops
    from embodied_object_detection_tpu_torch.structures import MemoryState

    cfg = DetectorConfig()
    t0 = time.perf_counter()
    model = build_detector(cfg, seed=0, device="cuda")
    print(f"  built the default-config model in "
          f"{time.perf_counter() - t0:.1f} s "
          f"({sum(p.numel() for p in model.parameters())} parameters)")
    h, w = cfg.input.height, cfg.input.width
    cells, dim = cfg.memory.max_cells, cfg.memory.memory_dim
    rng = np.random.RandomState(0)
    images = rng.randint(0, 255, (T_FRAMES, h, w, 3)).astype(np.float32)
    projs = rng.randint(0, cells, (T_FRAMES, h, w)).astype(np.int32)
    resets = np.array([True] + [False] * (T_FRAMES - 1))
    frames = frame_inputs(images, projs, resets, cells, "cuda")
    zs = torch.from_numpy(rng.randn(cfg.roi.zs_weight_dim,
                                    cfg.roi.num_classes + 1)
                          .astype(np.float32)).cuda()
    init = MemoryState.zeros(cells, dim, "cuda")
    run = make_episode_runner(model, cfg)

    out, counted_s, launches = counted_run(
        "default", lambda: run(frames, zs, init), LAUNCHES_PER_FRAME,
        T_FRAMES)
    chunk_s = [counted_s]
    for _ in range(3):
        t0 = time.perf_counter()
        run(frames, zs, out.memory)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
    per_frame = [s / T_FRAMES * 1e3 for s in chunk_s]
    print("  per-frame ms over chunks of %d frames: %s" % (
        T_FRAMES, ", ".join(f"{x:.2f}" for x in per_frame)))

    t0 = time.perf_counter()
    model.backbone_raw(frames.image)
    torch.cuda.synchronize()
    print(f"  batched trunk alone: "
          f"{(time.perf_counter() - t0) / T_FRAMES * 1e3:.2f} ms/frame")

    check_episode("default", out, (T_FRAMES,), cfg)
    det = out.detections
    any_det = out.any_detection.tolist()
    n_det = det.valid.sum(dim=1).tolist()
    print(f"  detections per frame: {n_det}; frames that wrote: {any_det}")
    if not any_det[0]:
        raise AssertionError("frame 0 wrote nothing to the memory")
    first = out.first_memory
    ego1 = memory_ops.memory_read_plain(first.features, first.obs_count,
                                        frames.proj_indices[1])
    if not float(ego1.abs().max()) > 0:
        raise AssertionError("frame 1 read an all-zero memory")
    print(f"  memory after the chunk: {int((out.memory.obs_count > 0).sum())}"
          f" cells observed, max |feature| "
          f"{float(out.memory.features.abs().max()):.3f}; frame 1 read "
          f"max |ego| {float(ego1.abs().max()):.3f}")

    if profile_dir:
        profile_run(lambda: run(frames, zs, init), Path(profile_dir),
                    "chunk", T_FRAMES, "frame")
    phase(5, f"eval path ran {T_FRAMES} frames at 480x640 with no host "
             f"sync: {min(per_frame):.2f} ms/frame (best chunk), launches a "
             f"frame {LAUNCHES_PER_FRAME}, frame 0 wrote, frame 1 read it")
    return launches, per_frame


def counted_run(name, fn, per_frame, frames):
    """Run fn() once under the sync debug mode "warn" (any synchronising
    call fails), then once under "error" with the launch counts zeroed
    just before and read just after; each kernel must have launched its
    count a frame. Returns the counted run's result, its seconds and its
    launches."""
    t0 = time.perf_counter()
    syncs = sync_sites(fn)
    print(f"  {name}: warm-up run {time.perf_counter() - t0:.2f} s, "
          f"{sum(syncs.values())} synchronising calls (sync debug mode "
          f"'warn')")
    if syncs:
        for site, n in syncs.items():
            print(f"    {n} x {site}")
        raise AssertionError(f"{name}: the frames synchronise with the host")
    zero_counters()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counters()
    expected = {k: per_frame.get(k, 0) * frames for k in launches}
    if launches != expected:
        raise AssertionError(f"{name}: launches {launches}, expected "
                             f"{expected}")
    print(f"  {name}: {frames} frames, no host sync (sync debug mode "
          f"'error'), launches {launches}, {secs / frames * 1e3:.2f} "
          f"ms/frame")
    return out, secs, launches


def check_episode(name, out, lead, cfg):
    """An episode's shapes ([*lead, detections, ...] and the memory's, one
    a stream) and finite values."""
    det = out.detections
    n = cfg.roi.detections_per_image
    shapes = {"boxes": lead + (n, 4), "scores": lead + (n,),
              "features": lead[:-1] + (cfg.memory.max_cells,
                                       cfg.memory.memory_dim)}
    got = {"boxes": tuple(det.boxes.shape),
           "scores": tuple(det.scores.shape),
           "features": tuple(out.memory.features.shape)}
    if got != shapes:
        raise AssertionError(f"{name}: shapes {got} != {shapes}")
    for part, t in (("boxes", det.boxes), ("scores", det.scores),
                    ("memory", out.memory.features),
                    ("obs", out.memory.obs_count)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: non-finite {part}")


def run_episode_modes():
    """Phase 5b: the longterm protocol, an external GT memory, the batched
    and the pipelined runners at the default config (480x640, bf16), each
    under the sync debug mode "error" with its launches counted."""
    from embodied_object_detection_tpu_torch.config import DetectorConfig
    from embodied_object_detection_tpu_torch.engine.eval import (
        external_memory_state)
    from embodied_object_detection_tpu_torch.models.detector import (
        EmbodiedDetector, build_detector, frame_inputs,
        make_batched_episode_runner, make_episode_runner,
        make_pipelined_episode_runner)
    from embodied_object_detection_tpu_torch.structures import MemoryState

    base = DetectorConfig()
    cfg = base.replace(memory=dataclasses.replace(base.memory,
                                                  test_type="longterm"))
    model = build_detector(cfg, seed=0, device="cuda")
    h, w = cfg.input.height, cfg.input.width
    cells, dim = cfg.memory.max_cells, cfg.memory.memory_dim
    rng = np.random.RandomState(5)
    b, t_max = 2, T_FRAMES
    images = rng.randint(0, 255, (b, t_max, h, w, 3)).astype(np.float32)
    projs = np.stack([np.stack([coherent_proj(rng) for _ in range(t_max)])
                      for _ in range(b)])
    # stream 0 starts from a reset, stream 1 from the memory it is given;
    # frames 1 and 3 read the snapshot of frames 0 and 2
    resets = np.zeros((b, t_max), bool)
    resets[0, 0] = True
    starts = np.zeros((b, t_max), bool)
    starts[:, ::2] = True
    batch = frame_inputs(images, projs, resets, cells, "cuda",
                         episode_start=starts)
    frames = batch._replace(**{k: None if v is None else v[0]
                               for k, v in batch._asdict().items()})
    zs = torch.from_numpy(rng.randn(cfg.roi.zs_weight_dim,
                                    cfg.roi.num_classes + 1)
                          .astype(np.float32)).cuda()
    init = MemoryState.zeros(cells, dim, "cuda")

    run = make_episode_runner(model, cfg)
    single, _, _ = counted_run("longterm", lambda: run(frames, zs, init),
                            LAUNCHES_PER_FRAME, t_max)
    check_episode("longterm", single, (t_max,), cfg)
    if not bool(single.any_detection[0]):
        raise AssertionError("longterm: frame 0 wrote nothing")

    trunk_fn, scan_fn = make_pipelined_episode_runner(model, cfg)
    piped, _, _ = counted_run(
        "pipelined runner (longterm)",
        lambda: scan_fn(frames, zs, init, trunk_fn(frames.image)),
        LAUNCHES_PER_FRAME, t_max)
    check_episode("pipelined", piped, (t_max,), cfg)
    # frame 0 reads the same zeros in both runs (later frames read
    # memories whose float atomics summed in another order)
    v_s, v_p = single.detections.valid[0], piped.detections.valid[0]
    if int(v_s.sum()) != int(v_p.sum()):
        raise AssertionError("pipelined: frame 0's detections differ")
    torch.testing.assert_close(
        piped.detections.scores[0][v_p].sort().values,
        single.detections.scores[0][v_s].sort().values, rtol=1e-3,
        atol=1e-4)

    batched = make_batched_episode_runner(model, cfg)
    mems = MemoryState(*(torch.stack(x) for x in zip(init, single.memory)))
    out, _, _ = counted_run("batched runner (B = 2, longterm)",
                         lambda: batched(batch, zs, mems),
                         LAUNCHES_PER_FRAME, b * t_max)
    check_episode("batched", out, (b, t_max), cfg)

    sem_cfg = base.replace(memory=dataclasses.replace(
        base.memory, memory_type="semantic_gt"))
    sem = EmbodiedDetector(sem_cfg).to("cuda").eval()
    sem.load_state_dict(model.state_dict())
    table = rng.randn(cfg.roi.num_classes + 1, dim).astype(np.float32)
    table[0] = 0.0                      # the class table's zero row 0
    # the pixels' ids index the class table
    sem_frames = frames._replace(
        proj_indices=frames.proj_indices % table.shape[0])
    table = external_memory_state(table, sem_cfg, device="cuda")
    kept = MemoryState(*(x.clone() for x in table))
    ext, _, _ = counted_run("semantic_gt",
                         lambda: make_episode_runner(sem, sem_cfg)(
                             sem_frames, zs, table),
                         LAUNCHES_PER_FRAME_EXTERNAL, t_max)
    check_episode("semantic_gt", ext, (t_max,), sem_cfg)
    for state in (table, ext.memory, ext.first_memory):
        if not (torch.equal(state.features, kept.features) and
                torch.equal(state.obs_count, kept.obs_count)):
            raise AssertionError("semantic_gt: the table changed")
    phase("5b", f"episode modes at 480x640 with no host sync: longterm, "
                f"the pipelined runner, the batched runner (B = {b}) and "
                f"semantic_gt (the table unchanged, no write kernel "
                f"launched), launches a frame as counted")


def kernel_name(key):
    """A profiler key's kernel name, without its namespace or arguments."""
    m = re.search(r"(\w+(<[^()]*>)?)\(", key)
    return m.group(1) if m else key


def profile_run(fn, out_dir, tag, units, unit):
    """Profile one fn() call: op table and chrome trace under out_dir,
    host sync and copy calls, device busy time per `unit`."""
    from torch.profiler import ProfilerActivity, profile
    out_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    table = averages.table(sort_by="cuda_time_total", row_limit=-1)
    (out_dir / f"{tag}_ops.txt").write_text(table)
    trace = out_dir / f"{tag}_trace.json"
    prof.export_chrome_trace(str(trace))
    print("\n".join(table.splitlines()[:30]))
    # the device time of each of the port's kernels in this run
    ours = ("segment_sum", "memory_read", "nms_", "roi_align", "mask_paste",
            "write_select", "ms_deform_attn")
    for e in sorted(averages, key=lambda e: -e.device_time_total):
        if e.device_time_total > 0 and any(k in e.key for k in ours):
            print(f"  in the {tag}: {kernel_name(e.key)} "
                  f"{e.device_time_total / e.count:.1f} us a call x {e.count}")
    write = [e for e in averages if e.device_time_total > 0 and
             any(k in e.key for k in ("mask_paste", "select_kernel",
                                      "observed_kernel"))]
    if write:
        print(f"  in the {tag}: mask paste + write selection "
              f"{sum(e.device_time_total for e in write) / units:.1f} us a "
              f"{unit} ({', '.join(kernel_name(e.key) for e in write)})")
    trace_events = json.loads(trace.read_text())["traceEvents"]
    waits = {name: sum(1 for e in trace_events if e.get("name") == name)
             for name in ("cudaStreamSynchronize", "cudaMemcpyAsync")}
    print(f"  host calls in the {tag}: {waits}")
    ops, busy, span = device_busy(trace_events)
    print(f"  profiled {tag}: {ops} device ops, device busy "
          f"{busy / 1e3:.2f} ms of a {span / 1e3:.2f} ms span "
          f"({busy / 1e3 / units:.2f} ms/{unit} busy; idle share "
          f"{1 - busy / span:.3f} under the profiler)")


def device_busy(trace_events):
    """(device ops, busy us, span us) of a chrome trace: busy time is the
    union of its kernel, copy and set intervals, the span from the first
    one's start to the last one's end."""
    events = sorted(
        (e["ts"], e["ts"] + e["dur"]) for e in trace_events
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                    "gpu_memset"))
    busy, cur = 0.0, list(events[0])
    for s, e in events[1:]:
        if s > cur[1]:
            busy += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    busy += cur[1] - cur[0]
    return len(events), busy, max(e for _, e in events) - events[0][0]


def profile_events(fn):
    """Profile one fn() call: its chrome trace's events."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        return json.loads(trace.read_text())["traceEvents"]


# groups of a frame's device ops, each kernel in the first group whose
# pattern its name matches (cuDNN's convolutions before the matmuls, as
# their implicit GEMMs carry "gemm" in their names too); copies, sets and
# the kernels no pattern matches are "the rest"
OP_GROUPS = (("kernel 8", r"ms_deform_attn"),
             ("convolutions", r"(?i)conv|fprop|dgrad|wgrad|winograd|"
                              r"implicit|nchw|nhwc"),
             ("matmuls", r"(?i)gemm|gemv|cutlass|cublas|matmul|splitk"),
             ("norms", r"(?i)norm|welford"),
             ("elementwise", r"elementwise"))


def device_op_split(trace_events, units):
    """({group: device ms a unit}, [(ms a unit, calls a unit, group,
    kernel name)] from the most time down) of a chrome trace's device
    ops."""
    groups = dict.fromkeys([g for g, _ in OP_GROUPS] + ["the rest"], 0.0)
    ops = collections.defaultdict(lambda: [0.0, 0])
    for e in trace_events:
        if e.get("ph") != "X" or e.get("cat") not in (
                "kernel", "gpu_memcpy", "gpu_memset"):
            continue
        name = e["name"] if e["cat"] == "kernel" else e["cat"]
        group = next((g for g, pat in OP_GROUPS
                      if e["cat"] == "kernel" and re.search(pat, name)),
                     "the rest")
        op = ops[(group, kernel_name(name))]
        op[0] += e["dur"] / 1e3 / units
        op[1] += 1
        groups[group] += e["dur"] / 1e3 / units
    top = sorted(((ms, n / units, g, k) for (g, k), (ms, n) in ops.items()),
                 reverse=True)
    return groups, top


def miniature(cfg, frames):
    """The 64x96 f32 miniature of a config that phases 6, 6b and 10b run
    on the card and on the CPU."""
    return cfg.replace(
        compute_dtype="float32",
        backbone=dataclasses.replace(cfg.backbone, depths=(1, 1, 1, 1)),
        input=dataclasses.replace(cfg.input, height=64, width=96,
                                  max_sequence_length=frames),
        centernet=dataclasses.replace(cfg.centernet, pre_nms_topk_test=64,
                                      post_nms_topk_test=16),
        roi=dataclasses.replace(cfg.roi, detections_per_image=16,
                                num_classes=5),
        memory=dataclasses.replace(cfg.memory, max_cells=64, write_topk=8))


class PasteCall(NamedTuple):
    """One mask paste of the memory write, on the CPU."""
    masks: torch.Tensor
    boxes: torch.Tensor
    out: torch.Tensor      # the pasted bool masks
    valid: object          # the write rows' flags (exact write), else None
    layout: dict           # the keywords of `paste_masks_plain`


class PasteRecorder:
    """Records every mask paste the memory write makes, one a frame: the
    exact write's `paste_masks_observed` and the strided write's
    `paste_masks`."""

    def __enter__(self):
        from embodied_object_detection_tpu_torch.models import detector
        self.detector = detector
        self.saved = observed, strided = (detector.paste_masks_observed,
                                          detector.paste_masks)
        self.calls = []

        def spy_observed(masks, boxes, valid, *args):
            out = observed(masks, boxes, valid, *args)
            self.calls.append(PasteCall(masks.cpu(), boxes.cpu(),
                                        out[0].cpu(), valid.cpu(),
                                        dict(pixel_major=True)))
            return out

        def spy_strided(masks, boxes, *args, x_stride=1):
            out = strided(masks, boxes, *args, x_stride=x_stride)
            self.calls.append(PasteCall(masks.cpu(), boxes.cpu(), out.cpu(),
                                        None, dict(x_stride=x_stride)))
            return out
        detector.paste_masks_observed = spy_observed
        detector.paste_masks = spy_strided
        return self

    def __exit__(self, *exc):
        self.detector.paste_masks_observed, self.detector.paste_masks = \
            self.saved


def align_write_rows(cpu: PasteCall, card: PasteCall) -> PasteCall:
    """The card's paste with its write rows in the CPU's order, where the
    two devices wrote the same rows in another order: the write takes
    its rows in proposal order, and two proposals whose scores lie within
    rounding of a tie can swap places between the devices. A row that
    keeps its place is left; the others are matched one to one to the
    card's rows whose boxes agree within 1e-2 px + 1e-3 of their
    coordinate (and whose flags agree). Without such a matching the card's
    paste is returned as it is, and the comparison raises on it. The
    memory write sums its rows, so it does not depend on their order."""
    n = cpu.boxes.shape[0]
    if n == 0 or card.boxes.shape != cpu.boxes.shape:
        return card
    close = ((cpu.boxes[:, None] - card.boxes[None]).abs() <=
             1e-2 + 1e-3 * cpu.boxes[:, None].abs()).all(-1)
    if cpu.valid is not None and card.valid is not None:
        close &= cpu.valid[:, None] == card.valid[None]
    moved = (~close.diagonal()).nonzero().flatten()
    sub = close[moved][:, moved]
    if not len(moved) or not bool((sub.sum(0) == 1).all()) or \
            not bool((sub.sum(1) == 1).all()):
        return card
    perm = torch.arange(n)
    perm[moved] = moved[sub.float().argmax(1)]
    axis = -1 if card.layout.get("pixel_major") else 0
    print(f"    write rows {moved.tolist()} in another order on the card "
          f"(proposals tied in score to rounding); compared row by row")
    return PasteCall(card.masks[perm], card.boxes[perm],
                     card.out.index_select(axis % card.out.dim(), perm),
                     None if card.valid is None else card.valid[perm],
                     card.layout)


def paste_flips(cpu: PasteCall, card: PasteCall, h: int, w: int):
    """The pixels one frame's write paste differs on between the CPU and
    the card (its rows first aligned, `align_write_rows`), as (rounding,
    input) counts; any other difference raises. A rounding flip lies
    within 1e-5 of the 0.5 threshold in the plain paste of the CPU's masks
    and boxes (the two devices' sums differ in their last bits); at most
    one pixel in 10 000 may be one. An input flip lies between the
    devices' inputs: the plain paste of each device's own masks and boxes
    puts it on that device's side, and the inputs agree (each box
    coordinate within 1e-2 px + 1e-3 of its value, the box tolerance of
    the frame tests and of phase 6; mask probabilities within 1e-4), as at
    a box edge that crosses 0.5 between two pixel centres. The boxes of
    frames whose pastes agree in every pixel already lie up to ~1.8e-2 px
    apart (`scripts/paste_box_gaps.py`), so 1e-2 px alone would hold a
    flip to less than the frames keep."""
    from embodied_object_detection_tpu_torch.ops import mask_paste

    card = align_write_rows(cpu, card)
    if (cpu.valid is None) != (card.valid is None) or (
            cpu.valid is not None and not torch.equal(cpu.valid,
                                                      card.valid)):
        raise AssertionError("the write rows differ between the card and "
                             "the CPU")
    flipped = cpu.out != card.out
    n = int(flipped.sum())
    if not n:
        return 0, 0
    vals = [mask_paste.paste_masks_plain(c.masks, c.boxes, h, w, -1.0,
                                         **c.layout) for c in (cpu, card)]
    rounding = flipped & ((vals[0] - 0.5).abs() < 1e-5)
    box_diff = (cpu.boxes - card.boxes).abs()
    box_gap = float(box_diff.max())
    mask_gap = float((cpu.masks - card.masks).abs().max())
    inputs = flipped & ~rounding & ((vals[0] >= 0.5) == cpu.out) & \
        ((vals[1] >= 0.5) == card.out)
    if bool((box_diff > 1e-2 + 1e-3 * cpu.boxes.abs()).any()) or \
            mask_gap > 1e-4:
        inputs = torch.zeros_like(inputs)
    n_round, n_input = int(rounding.sum()), int(inputs.sum())
    if n_round + n_input != n or n_round > max(1, cpu.out.numel() // 10000):
        gap = float((vals[0][flipped] - 0.5).abs().max())
        raise AssertionError(
            f"{n} pasted pixels differ between the card and the CPU "
            f"({n_round} within 1e-5 of 0.5, {n_input} between the inputs; "
            f"up to {gap:.2e} from 0.5; inputs apart by {box_gap:.2e} px "
            f"and {mask_gap:.2e})")
    return n_round, n_input


def check_against_cpu(test_type="default"):
    """Phase 6 (test_type "default", 2 frames) and 6b ("longterm", 3
    frames: frame 1 reads frame 0's snapshot, frame 2 starts an episode)."""
    from embodied_object_detection_tpu_torch.config import DetectorConfig
    from embodied_object_detection_tpu_torch.models import detector
    from embodied_object_detection_tpu_torch.structures import MemoryState

    frames_n = 2 if test_type == "default" else 3
    cfg = DetectorConfig()
    cfg = miniature(cfg.replace(memory=dataclasses.replace(
        cfg.memory, test_type=test_type)), frames_n)
    resets = np.array([True] + [False] * (frames_n - 1))
    starts = np.array([True, False, True][:frames_n])
    rng = np.random.RandomState(1)
    h, w = cfg.input.height, cfg.input.width
    images = rng.randint(0, 255, (frames_n, h, w, 3)).astype(np.float32)
    projs = rng.randint(0, 64, (frames_n, h, w)).astype(np.int32)
    zs = rng.randn(512, 6).astype(np.float32)
    zs[:, -1] = 0.0
    zs[:, :-1] /= np.linalg.norm(zs[:, :-1], axis=0, keepdims=True)
    # record every paste on both devices, to count threshold flips
    outs, pasted = {}, {}
    for dev in ("cpu", "cuda"):
        with PasteRecorder() as rec:
            model = detector.build_detector(cfg, seed=3, device=dev)
            frames = detector.frame_inputs(images, projs, resets, 64, dev,
                                           episode_start=starts)
            outs[dev] = detector.make_episode_runner(model, cfg)(
                frames, torch.from_numpy(zs).to(dev),
                MemoryState.zeros(64, 512, dev))
        pasted[dev] = rec.calls
    cpu, card = outs["cpu"], outs["cuda"]
    if not torch.equal(cpu.any_detection, card.any_detection.cpu()):
        raise AssertionError("the card and the CPU disagree on writes")
    for t in range(frames_n):
        v_c, v_g = cpu.detections.valid[t], card.detections.valid[t].cpu()
        if int(v_c.sum()) != int(v_g.sum()):
            raise AssertionError(f"frame {t}: detection counts differ")
        s_c = cpu.detections.scores[t][v_c].sort(descending=True).values
        s_g = card.detections.scores[t].cpu()[v_g].sort(
            descending=True).values
        torch.testing.assert_close(s_g, s_c, rtol=1e-4, atol=1e-5)
    if len(pasted["cuda"]) != frames_n or len(pasted["cpu"]) != frames_n:
        raise AssertionError("expected one paste a frame on each device")
    flips = sum(sum(paste_flips(c, g, h, w))
                for c, g in zip(pasted["cpu"], pasted["cuda"]))
    if flips == 0:
        torch.testing.assert_close(card.memory.features.cpu(),
                                   cpu.memory.features, rtol=1e-3, atol=1e-3)
        memory = "memory rtol/atol 1e-3"
    else:
        # a flipped pixel moves a selected pixel's feature to another cell
        # and shifts the every-8th selection after it: the memories are not
        # comparable at 1e-3, and the phase says so
        memory = (f"memory NOT compared: {flips} pasted pixels flipped at "
                  "0.5 (within the flip bound)")
        print(f"  {memory}")
    if not torch.equal(card.memory.obs_count.cpu(), cpu.memory.obs_count):
        raise AssertionError("observation counts differ")
    phase(6 if test_type == "default" else "6b",
          f"small config (64x96, f32, test_type {test_type!r}): the card "
          f"matches the plain CPU path over {frames_n} frames (scores rtol "
          f"1e-4, {flips} pasted pixels flipped, {memory}, "
          f"{int(cpu.detections.valid.sum())} detections)")


EVAL_SCENES, EVAL_CHUNKS, EVAL_FRAMES = 2, 4, 20
# the largest reference map, 110 x 57 cells (the JAX package's
# MemoryConfig.max_cells comment)
EVAL_MAP = (57, 110)


class Recorder:
    """Spies on the evaluation engine: each chunk's starting memory and the
    runner's output, and each scored image's detections, as
    `evaluate_dataset` makes them. With `starts`, chunk i starts from
    `starts[i]` in place of the memory the engine carries."""

    def __init__(self, starts=None):
        from embodied_object_detection_tpu_torch.engine import eval as ev
        self.ev, self.starts = ev, starts
        self.chunks = []
        self.dets = {}

    def __enter__(self):
        from embodied_object_detection_tpu_torch.structures import (
            MemoryState)
        ev, rec = self.ev, self
        self.saved = (ev.make_episode_runner, ev.COCOEvaluator)

        def runner(model, cfg):
            run = rec.saved[0](model, cfg)

            def recorded(frames, zs, memory):
                if rec.starts is not None:
                    memory = MemoryState(*(
                        x.to(memory.features.device)
                        for x in rec.starts[len(rec.chunks)]))
                out = run(frames, zs, memory)
                rec.chunks.append((memory, out))
                return out
            return recorded

        class Evaluator(ev.COCOEvaluator):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                rec.evaluator = self

            def add_detections(self, image_id, boxes, scores, classes):
                rec.dets[image_id] = (np.asarray(boxes), np.asarray(scores),
                                      np.asarray(classes))
                super().add_detections(image_id, boxes, scores, classes)

        ev.make_episode_runner, ev.COCOEvaluator = runner, Evaluator
        return self

    def __exit__(self, *exc):
        self.ev.make_episode_runner, self.ev.COCOEvaluator = self.saved


def runner_alone(model, cfg, ds, zs):
    """ms a frame of the runner alone over the engine's timed chunks (after
    its 5 warm-up chunks), their inputs on the card beforehand, after one
    untimed chunk."""
    from embodied_object_detection_tpu_torch.engine.eval import (
        frames_to_device, host_frame_inputs)
    from embodied_object_detection_tpu_torch.models.detector import (
        make_episode_runner)
    from embodied_object_detection_tpu_torch.structures import MemoryState

    timed = range(min(5, len(ds) - 1), len(ds))
    runner = make_episode_runner(model, cfg)
    inputs = [frames_to_device(host_frame_inputs(ds[i], cfg.memory.max_cells,
                                                 pin=True), "cuda")
              for i in [timed[0], *timed]]
    memory = MemoryState.zeros(cfg.memory.max_cells, cfg.memory.memory_dim,
                               "cuda")
    zs = torch.from_numpy(zs).cuda()
    ms = []
    for frames_in in inputs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        memory = runner(frames_in, zs, memory).memory
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) / EVAL_FRAMES * 1e3)
    return ms[1:]


def run_eval_engine(profile_dir):
    """Phase 10: `engine.eval.evaluate_dataset` at the default config over
    8 in-memory chunks of synthetic episodes (h5py is not needed): the
    timing split, the evaluator's path, launches a frame, host syncs; then
    the runner alone over the engine's timed chunks, already on the card,
    for the chunk's compute without the engine."""
    from embodied_object_detection_tpu_torch import native
    from embodied_object_detection_tpu_torch.config import DetectorConfig
    from embodied_object_detection_tpu_torch.data.synthetic import (
        SyntheticEpisodes)
    from embodied_object_detection_tpu_torch.demo.predictor import (
        load_zs_weight_npy)
    from embodied_object_detection_tpu_torch.engine.eval import (
        evaluate_dataset)
    from embodied_object_detection_tpu_torch.models.detector import (
        build_detector)

    cfg = DetectorConfig()
    model = build_detector(cfg, seed=0, device="cuda")
    t0 = time.perf_counter()
    ds = SyntheticEpisodes(max_sequence_length=EVAL_FRAMES,
                           max_gt=cfg.input.max_gt_boxes,
                           num_scenes=EVAL_SCENES,
                           chunks_per_scene=EVAL_CHUNKS, frames=EVAL_FRAMES,
                           height=cfg.input.height, width=cfg.input.width,
                           map_h=EVAL_MAP[0], map_w=EVAL_MAP[1], seed=0)
    print(f"  {len(ds)} chunks of {EVAL_FRAMES} frames made from seed 0 in "
          f"{time.perf_counter() - t0:.1f} s ({ds.num_cells} cells a scene)")
    zs = load_zs_weight_npy(str(REPO / "embodied_object_detection_tpu_torch"
                                / "data" / "metadata" / "mp3d_clip.npy"))
    core = native.load_eval_core()
    result = {}

    def run():
        result["res"] = evaluate_dataset(model, cfg, ds, zs, verbose=False,
                                         num_workers=2)

    alone_before = runner_alone(model, cfg, ds, zs)
    zero_counters()
    syncs = sync_sites(run)
    launches = read_counters()
    res = result["res"]
    frames = len(ds) * EVAL_FRAMES
    expected = {k: LAUNCHES_PER_FRAME.get(k, 0) * frames for k in launches}
    per_frame = {k: v / frames for k, v in launches.items() if v}
    print(f"  launches over the run ({frames} frames): {launches}; a frame "
          f"{per_frame}")
    if launches != expected:
        raise AssertionError(f"phase 10: launches {launches}, expected "
                             f"{expected} (phase 5's counts a frame)")
    print(f"  host syncs over the run (set-up and {len(ds)} loop "
          f"iterations, sync debug mode 'warn'): {sum(syncs.values())}")
    for site, n in syncs.items():
        print(f"    {n} x {site}")
    inside = [site for site in syncs if "detector.py" in site or
              "_ops.py" in site or "eval.py" not in site]
    if inside or sum(syncs.values()) > 2 * len(ds):
        raise AssertionError(f"phase 10: host syncs outside the chunk end "
                             f"and the detection copy: {inside or syncs}")
    if res.num_images != frames // cfg.input.score_every:
        raise AssertionError(f"phase 10: {res.num_images} images scored, "
                             f"expected {frames // cfg.input.score_every}")
    aps = [res.overall] + [q for q in res.quartiles if q]
    if any(math.isinf(v) for d in aps for v in d.values()):
        raise AssertionError(f"phase 10: infinite AP in {res.overall}")
    t = res.timing
    alone = alone_before + runner_alone(model, cfg, ds, zs)
    engine_ms = t["compute_s_per_chunk"] / EVAL_FRAMES * 1e3
    alone_ms = sum(alone) / len(alone)
    print(f"  the runner alone over the timed chunks, before and after the "
          f"engine: {', '.join(f'{x:.2f}' for x in alone)} ms/frame (mean "
          f"{alone_ms:.2f}); the engine's compute {engine_ms:.2f} ms/frame "
          f"(mean over the same chunks), {engine_ms / alone_ms - 1:+.1%}")
    if profile_dir:
        profile_run(lambda: evaluate_dataset(model, cfg, [ds[0], ds[1]], zs,
                                             verbose=False, num_workers=2),
                    Path(profile_dir), "engine", 2 * EVAL_FRAMES, "frame")
    print(f"  evaluator: {'native C++ core' if core else 'numpy'}")
    print(f"  AP overall {res.overall['AP']:.4f}, AP50 "
          f"{res.overall['AP50']:.4f}; quartiles "
          f"{[round(q.get('AP', float('nan')), 4) for q in res.quartiles]}"
          f" (random weights); {res.num_images} images")
    print(f"  timing: {json.dumps(t)}")
    phase(10, f"eval engine at 480x640 over {len(ds)} chunks of "
              f"{EVAL_FRAMES} frames ({res.num_images} images scored, "
              f"{'native' if core else 'numpy'} evaluator): data "
              f"{t['data_s_per_chunk'] * 1e3:.1f} ms, compute "
              f"{t['compute_s_per_chunk'] * 1e3:.1f} ms, eval "
              f"{t['eval_s_per_chunk'] * 1e3:.1f} ms a chunk, "
              f"{t['frames_per_s']:.2f} frames/s over the timed chunks; "
              f"the runner alone {alone_ms:.2f} ms/frame")


def cell_gap(got, want):
    """The largest distance between two memories' cell features, each over
    the norm of the cell's features in `want` (a running sum over frames
    and pixels, whose small elements are differences of large terms); 0
    where both cells are empty, inf where only `want`'s is."""
    diff = (got - want).norm(dim=-1)
    norm = want.norm(dim=-1)
    gap = torch.where(norm > 0, diff / norm.clamp(min=1e-30),
                      torch.where(diff > 0, float("inf"), 0.0))
    return float(gap.max())


# phase 10b's shift of the miniature's mask logits. The seeded predictor's
# logits lie near 0, so every pasted pixel sits near the 0.5 threshold and
# rounds to either side on the two devices; shifted by +2 (a probability
# of ~0.88 inside a box) only a box's edge crosses it
MASK_LOGIT_SHIFT = 2.0

# phase 10b's cases: (name, golden preset, exact write subsample)
ENGINE_CASES = (("pretrained", "pretrained", True),
                ("implicit exact", "implicit_object_memory", True),
                ("implicit strided", "implicit_object_memory", False))


def check_boxes_classes(card, cpu, where):
    """An image's detections on the card against the CPU's, each ranked by
    score: the same class and boxes within 1e-2 px + 1e-3 of their
    coordinate, row by row. Raises on a miss."""
    (bg, sg, cg), (bc, sc, cc) = card, cpu
    og, oc = np.argsort(-sg, kind="stable"), np.argsort(-sc, kind="stable")
    if not np.array_equal(cg[og], cc[oc]) or not bool(
            (np.abs(bg[og] - bc[oc]) <= 1e-2 + 1e-3 * np.abs(bc[oc])).all()):
        raise AssertionError(f"{where}: detections differ in class or box")


def ap_ranked_by(evaluator, dets, ref):
    """The AP of `dets` (one device's boxes and classes per image) with
    each image's detections given, rank for rank, the scores of `ref`
    (the other device's), over the images and ground truth `evaluator`
    holds. AP ranks all images' detections together, so two detections
    of two images whose scores tie within the held tolerance may swap
    between the devices and move it; this AP is free of such swaps."""
    ev = copy.copy(evaluator)
    ev._dt = collections.defaultdict(lambda: collections.defaultdict(list))
    for im, (boxes, scores, classes) in dets.items():
        order = np.argsort(-scores, kind="stable")
        ev.add_detections(im, boxes[order], np.sort(ref[im][1])[::-1],
                          classes[order])
    return ev.evaluate()["AP"]


def rank_swaps(card, cpu):
    """How many detections take another place on the card than on the
    CPU when every image's detections are ranked together by score, as
    COCO AP ranks them (each image's rows matched by their rank in it)."""
    keys = []
    for dets in (card, cpu):
        rows = [(s, im, r) for im in sorted(dets)
                for r, s in enumerate(np.sort(dets[im][1])[::-1])]
        keys.append([(im, r) for _, im, r in sorted(
            rows, key=lambda t: -t[0])])
    return sum(a != b for a, b in zip(*keys))


def eval_engine_against_cpu():
    """Phase 10b: the protocol at the 64x96 f32 miniature on the card and
    on the CPU, from the same weights and chunks: an image-only golden
    preset, implicit_object_memory, and its strided write.

    The mask predictor's bias is shifted by MASK_LOGIT_SHIFT on both
    devices, so that the write's pastes rarely land on the 0.5 threshold,
    and each CPU chunk starts from the memory its card chunk started from
    (so every chunk's first frame reads the same memory on both). Within a
    chunk, a pasted pixel that still lands on either side (`paste_flips`:
    within 1e-5 of 0.5, or between the two devices' inputs) moves a
    feature, or the every-8th selection of the compacted observed pixels
    after it, to other cells: the frames after it read memories that part
    beyond phase 6's tolerances. So each scored image is held to them
    unless it comes after such a flip in its chunk (counted), each chunk
    with no flip holds its memories (after frame 0 and at its end, each
    cell's features within 1e-3 of its norm, counts equal); a held
    image's detections, ranked by score, also keep their classes and
    boxes (within 1e-2 px + 1e-3 of the coordinate). Where every image was
    held, the AP is held within 0.1 points: the card's boxes and classes
    ranked by the CPU's scores (`ap_ranked_by`) always, and the card's own
    AP where every detection keeps its rank among all images' detections
    (AP ranks them together, and two detections of two images whose
    scores agree within the tolerance may swap; counted). A preset that
    reads the memory must hold images that read a memory its scene
    wrote.

    A chunk's first frame reads the same memory on both devices and is
    held to phase 6's tolerances (scores rtol 1e-4, atol 1e-5); a later
    frame reads memories the two devices wrote, summed in other orders,
    and the f32 drift grows with the frames (on an H100, scores ~1.5e-4
    apart after 5 frames with no flip), so it is held to the episode tolerance
    of tests/test_torch_frame.py (rtol 1e-3, atol 1e-4). Over a chunk
    the memories' small elements drift past phase 6's 1e-3 elementwise
    bound, hence the bound on each cell's norm: every written feature
    has norm 50 (the normalised CLIP feature times the temperature), so
    one feature moved by a flip shifts a cell that summed k features by
    at least 1/k of its norm. At the shift the written boxes cover the 64x96
    image, so the exact write's every-8th compacted pixel is the strided
    grid's: the compaction of a partial observed set is held by phases 4d
    and 6."""
    from embodied_object_detection_tpu_torch.config import parity_config
    from embodied_object_detection_tpu_torch.data.synthetic import (
        SyntheticEpisodes)
    from embodied_object_detection_tpu_torch.engine.eval import (
        evaluate_dataset)
    from embodied_object_detection_tpu_torch.models.detector import (
        build_detector)
    from embodied_object_detection_tpu_torch.ops.memory_ops import (
        semmap_classes)

    frames, chunks_per_scene = 10, 2
    ds = SyntheticEpisodes(max_sequence_length=frames, num_scenes=2,
                           chunks_per_scene=chunks_per_scene, frames=frames,
                           height=64, width=96, map_h=8, map_w=8, seed=1)
    rng = np.random.RandomState(1)
    zs = rng.randn(512, 6).astype(np.float32)
    zs[:, -1] = 0.0
    zs[:, :-1] /= np.linalg.norm(zs[:, :-1], axis=0, keepdims=True)
    summary = []
    for name, preset, exact in ENGINE_CASES:
        cfg = miniature(parity_config(preset), frames)
        cfg = cfg.replace(memory=dataclasses.replace(
            cfg.memory, exact_write_subsample=exact))
        runs = {}
        for dev in ("cuda", "cpu"):
            model = build_detector(cfg, seed=3, device=dev)
            with torch.no_grad():
                model.roi_heads.mask_head.predictor.bias.add_(
                    MASK_LOGIT_SHIFT)
            starts = None if dev == "cuda" else \
                [m for m, _ in runs["cuda"][1].chunks]
            with Recorder(starts) as rec, PasteRecorder() as pastes:
                res = evaluate_dataset(model, cfg, ds, zs, verbose=False,
                                       num_workers=2)
            runs[dev] = (res, rec, pastes.calls)
        (card, rg, pg), (cpu, rc, pc) = runs["cuda"], runs["cpu"]
        if card.num_images != cpu.num_images or \
                sorted(rg.dets) != sorted(rc.dets) or \
                len(pc) != len(ds) * frames or len(pg) != len(pc):
            raise AssertionError(f"phase 10b {name}: images "
                                 f"{card.num_images} vs {cpu.num_images}, "
                                 f"pastes {len(pg)} vs {len(pc)}")
        if [bool(q) for q in card.quartiles] != \
                [bool(q) for q in cpu.quartiles]:
            raise AssertionError(f"phase 10b {name}: quartiles differ")
        # each chunk's first frame whose write paste differs
        parted, n_round, n_input = {}, 0, 0
        for f, (c, g) in enumerate(zip(pc, pg)):
            r, i = paste_flips(c, g, 64, 96)
            n_round, n_input = n_round + r, n_input + i
            if r + i:
                parted.setdefault(f // frames, f)
        reads = cfg.memory.reads_memory()
        held = written = after = late = 0
        drift = 0.0
        for im in sorted(rc.dets):
            chunk, t = divmod(im, frames // cfg.input.score_every)
            f = chunk * frames + t * cfg.input.score_every
            if reads and f > parted.get(chunk, f):
                after += 1
                continue
            (_, s_c, _), (_, s_g, _) = rc.dets[im], rg.dets[im]
            if len(s_c) != len(s_g):
                raise AssertionError(f"phase 10b {name}: image {im}: "
                                     f"{len(s_g)} detections on the card, "
                                     f"{len(s_c)} on the CPU")
            # a chunk's first frame reads the same memory on both devices;
            # a later one, memories the two wrote (summed in other orders)
            s_g, s_c = np.sort(s_g)[::-1], np.sort(s_c)[::-1]
            if reads and t > 0:
                np.testing.assert_allclose(s_g, s_c, rtol=1e-3, atol=1e-4)
                drift = max(drift, float(np.max(
                    np.abs(s_g - s_c) / np.maximum(np.abs(s_c), 1e-30),
                    initial=0.0)))
                late += 1
            else:
                np.testing.assert_allclose(s_g, s_c, rtol=1e-4, atol=1e-5)
            check_boxes_classes(rg.dets[im], rc.dets[im], f"phase 10b {name}: "
                                f"image {im}")
            held += 1
            written += reads and f % (frames * chunks_per_scene) != 0
        # the write: the memories of each chunk with no flip
        worst_gap = 0.0
        for k, ((_, out_g), (_, out_c)) in enumerate(zip(rg.chunks,
                                                         rc.chunks)):
            if k % chunks_per_scene == 0 and not float(
                    out_g.memory.features.abs().max()) > 0:
                raise AssertionError(f"phase 10b {name}: chunk {k} wrote "
                                     "nothing to the memory")
            if k in parted:
                continue
            for m_g, m_c in ((out_g.first_memory, out_c.first_memory),
                             (out_g.memory, out_c.memory)):
                gap = cell_gap(m_g.features.cpu(), m_c.features)
                worst_gap = max(worst_gap, gap)
                if not gap <= 1e-3:
                    raise AssertionError(f"phase 10b {name}: chunk {k}: a "
                                         f"cell's features differ by {gap:.2e}"
                                         " of its norm")
                if not torch.equal(m_g.obs_count.cpu(), m_c.obs_count):
                    raise AssertionError(f"phase 10b {name}: chunk {k}: "
                                         "observation counts differ")
        if reads and not written:
            raise AssertionError(f"phase 10b {name}: no image that reads "
                                 "a memory its scene wrote was held")
        ap_g, ap_c = card.overall["AP"], cpu.overall["AP"]
        q_g, q_c = ([round(q.get("AP", float("nan")), 4) for q in r.quartiles]
                    for r in (card, cpu))
        print(f"  {name}: overall AP card {ap_g:.4f}, CPU {ap_c:.4f}; "
              f"quartile AP card {q_g}, CPU {q_c}; {held} images held "
              f"({held - late} at rtol 1e-4, {late} later in their chunk at "
              f"rtol 1e-3, largest score gap {drift:.2e}; {written} reading "
              f"a memory their scene wrote), {after} after a flip in their "
              f"chunk; flips: {n_round} "
              f"within 1e-5 of 0.5 and {n_input} between the inputs, first "
              f"in chunks {parted}; memories held in "
              f"{len(ds) - len(parted)} of {len(ds)} chunks (cells within "
              f"{worst_gap:.2e} of their norms)")
        if after == 0:
            swaps = rank_swaps(rg.dets, rc.dets)
            ap_r = ap_ranked_by(rg.evaluator, rg.dets, rc.dets)
            print(f"    the card's detections ranked by the CPU's scores: "
                  f"AP {ap_r:.4f}; {swaps} detections take another rank "
                  f"among all images' detections on the card (their "
                  f"scores agree within the tolerance held above)")
            if not abs(ap_r - ap_c) <= 0.1 or (
                    swaps == 0 and not abs(ap_g - ap_c) <= 0.1):
                raise AssertionError(f"phase 10b {name}: AP {ap_g} (ranked "
                                     f"by the CPU's scores {ap_r}) vs "
                                     f"{ap_c}")
        summary.append(f"{name} {held}/{held + after} images and "
                       f"{len(ds) - len(parted)}/{len(ds)} memories held, "
                       f"AP {ap_g:.4f} vs {ap_c:.4f}")
        if name == "implicit exact":
            last_c, last_g = rc.chunks[-1][1], rg.chunks[-1][1]
    # the last chunk's first-frame memory of the implicit run: the CPU's
    # memory through semmap_classes on both devices, then the card's own
    mem = last_c.first_memory
    zs_t = torch.from_numpy(zs)
    sm_c = semmap_classes(mem.features, mem.obs_count, zs_t,
                          cfg.memory.obs_score_thresh)
    sm_g = semmap_classes(mem.features.cuda(), mem.obs_count.cuda(),
                          zs_t.cuda(), cfg.memory.obs_score_thresh).cpu()
    feats = mem.features / mem.features.norm(dim=-1, keepdim=True).clamp(
        min=1e-12)
    top2 = torch.topk(50.0 * feats @ zs_t[:, :-1], 2, dim=-1).values
    near = (top2[:, 0] - top2[:, 1]).abs() <= 1e-5 * top2[:, 0].abs()
    empty = mem.features.abs().amax(dim=-1) == 0     # all logits 0
    differ = sm_c != sm_g
    if bool((differ & ~near).any()):
        raise AssertionError(f"phase 10b: semmap classes differ on "
                             f"{int((differ & ~near).sum())} cells whose "
                             "top two logits are not tied")
    own = last_g.first_memory
    sm_own = semmap_classes(own.features, own.obs_count, zs_t.cuda(),
                            cfg.memory.obs_score_thresh).cpu()
    print(f"  semmap of the last chunk's first memory ({len(sm_c)} cells, "
          f"{int((sm_c >= 0).sum())} classed): the card equals the CPU on "
          f"the CPU's memory but for {int(differ.sum())} cells "
          f"({int((near & ~empty).sum())} written cells with top-two "
          f"logits within 1e-5, {int(empty.sum())} empty ones); on "
          f"the card's own memory {int((sm_own != sm_c).sum())} cells "
          "differ")
    phase("10b", f"eval protocol at 64x96 f32 over {len(ds)} chunks of "
                 f"{frames} frames, card against CPU (mask logits +"
                 f"{MASK_LOGIT_SHIFT}, each CPU chunk from the card's "
                 f"memory): {'; '.join(summary)}; semmap equal but for "
                 "tied logits")


def train_steps(cfg, zs, per_step, label, profile_dir=None):
    """Train the detector at `cfg` (seeded weights) for TRAIN_STEPS AdamW
    steps at B = TRAIN_FRAMES through `engine/train.py:train`, launches
    counted (zeroed just before, read just after, held to `per_step` a
    step); then the sync sites of one more step. Returns (launches, ms
    per step from metrics.json, peak bytes, sync sites)."""
    import shutil
    import tempfile
    from embodied_object_detection_tpu_torch.data.synthetic import (
        synthetic_batch_fn)
    from embodied_object_detection_tpu_torch.engine.train import (
        load_fed_freq_weight, train)
    from embodied_object_detection_tpu_torch.models.detector import (
        build_detector)
    from embodied_object_detection_tpu_torch.parallel.train_step import (
        batch_to_device, make_train_step)

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    cfg = cfg.replace(output_dir=out_dir)
    model = build_detector(cfg, seed=0, device="cuda")
    batch_fn = synthetic_batch_fn(cfg, TRAIN_FRAMES)
    try:
        torch.cuda.reset_peak_memory_stats()
        zero_counters()
        state = train(model, cfg, None, zs, max_iter=TRAIN_STEPS,
                      log_period=1, seed=0, verbose=True, batch_fn=batch_fn)
        torch.cuda.synchronize()
        launches = read_counters()
        peak = torch.cuda.max_memory_allocated()
        lines = [json.loads(x) for x in
                 (Path(out_dir) / "metrics.json").read_text().splitlines()]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    if len(lines) != TRAIN_STEPS:
        raise AssertionError(f"{label}: {len(lines)} metrics lines for "
                             f"{TRAIN_STEPS} steps")
    # a line a step (log_period 1): its losses, and the step's wall time,
    # the wait for its batch plus the step up to the loop's one host read
    nonfinite = [f"step {rec['iteration']}: {k}" for rec in lines
                 for k, v in rec.items() if not math.isfinite(v)]
    if nonfinite:
        raise AssertionError(f"{label}: non-finite losses: {nonfinite}")
    step_ms = [(rec["data_time"] + rec["time"]) * 1e3 for rec in lines]
    print(f"  {label}: launches in the {TRAIN_STEPS}-step run: {launches}")
    for name in kernel_counters():
        expected = per_step.get(name, 0) * TRAIN_STEPS
        if launches[name] != expected:
            raise AssertionError(f"{label}: {name} launched "
                                 f"{launches[name]} times in {TRAIN_STEPS} "
                                 f"steps, expected {expected}")

    # one more step, under the sync debug mode "warn"
    _, step_fn = make_train_step(model, cfg, state.optimizer,
                                 fed_freq_weight=load_fed_freq_weight(cfg))
    batch = batch_to_device(batch_fn(TRAIN_STEPS, np.random.RandomState(9),
                                     1), "cuda")
    zs_d = torch.from_numpy(zs).cuda()
    syncs = sync_sites(lambda: step_fn(state, batch, zs_d))
    print(f"  {label}: ms per step (host clock, batch wait + step to its "
          f"loss read, from metrics.json): "
          f"{', '.join(f'{x:.1f}' for x in step_ms)}; steps 2-3 mean "
          f"{np.mean(step_ms[1:]):.1f}; peak device memory "
          f"{peak / 2 ** 30:.2f} GiB (torch.cuda.max_memory_allocated); "
          f"synchronising calls in one step (sync debug mode 'warn'): "
          f"{sum(syncs.values())}")
    for site, n in syncs.items():
        print(f"    {n} x {site}")
    if profile_dir:
        profile_run(lambda: step_fn(state, batch, zs_d), Path(profile_dir),
                    "train_step", TRAIN_FRAMES, "frame")
    return launches, step_ms, peak, syncs


def random_zs(rng, cfg):
    zs = rng.randn(cfg.roi.zs_weight_dim,
                   cfg.roi.num_classes + 1).astype(np.float32)
    zs[:, -1] = 0.0
    zs[:, :-1] /= np.linalg.norm(zs[:, :-1], axis=0, keepdims=True)
    return zs


def train_config():
    """The default config at B = TRAIN_FRAMES: 2 chunks of 2 frames."""
    from embodied_object_detection_tpu_torch.config import DetectorConfig
    base = DetectorConfig()
    return base.replace(
        solver=dataclasses.replace(base.solver, ims_per_batch=2),
        input=dataclasses.replace(base.input, max_sequence_length=2))


def run_train_path(profile_dir):
    """Phase 8: the default config's training step through the loop, then
    each training knob of slice 11 the same way."""
    cfg = train_config()
    launches, step_ms, peak, syncs = train_steps(
        cfg, random_zs(np.random.RandomState(8), cfg), LAUNCHES_PER_STEP,
        "default", profile_dir)
    phase(8, f"training path: {TRAIN_STEPS} AdamW steps at B = "
             f"{TRAIN_FRAMES} (480x640, bf16), losses finite, "
             f"{np.mean(step_ms[1:]):.1f} ms/step (steps 2-3), peak "
             f"{peak / 2 ** 30:.2f} GiB, launches a step "
             f"{LAUNCHES_PER_STEP}, {sum(syncs.values())} synchronising "
             f"calls in a step")
    run_train_knobs()
    return launches, step_ms, peak


def train_knob_configs():
    """(label, config, zs, launches a step) of each knob of slice 11 at
    B = TRAIN_FRAMES. Under `roi.train_stage_remat` each stage's ROIAlign
    forward runs again in the backward's recompute, and its wrapper counts
    that launch too: 6 a frame instead of 3."""
    import os
    from embodied_object_detection_tpu_torch.data.catalog import METADATA_DIR
    from embodied_object_detection_tpu_torch.demo.predictor import (
        load_zs_weight_npy)
    cfg = train_config()
    rep = dataclasses.replace
    lvis = rep(cfg.roi, num_classes=1203, use_fed_loss=True,
               ignore_zero_cats=True)
    remat_step = dict(LAUNCHES_PER_STEP, roi_align=6 * TRAIN_FRAMES)
    return [
        ("more_pos", cfg.replace(centernet=rep(cfg.centernet,
                                               more_pos=True)),
         random_zs(np.random.RandomState(8), cfg), LAUNCHES_PER_STEP),
        ("train_remat + train_stage_remat",
         cfg.replace(backbone=rep(cfg.backbone, train_remat=True),
                     roi=rep(cfg.roi, train_stage_remat=True)),
         random_zs(np.random.RandomState(8), cfg), remat_step),
        # Detic's LVIS setting: the copied LVIS v1 frequency table and the
        # vendored CLIP embeddings of its 1203 classes
        ("use_fed_loss + ignore_zero_cats (LVIS, 1203 classes)",
         cfg.replace(roi=lvis),
         load_zs_weight_npy(os.path.join(METADATA_DIR,
                                         "lvis_v1_clip_a+cname.npy")),
         LAUNCHES_PER_STEP)]


def run_train_knobs():
    """Phase 8's knobs: more_pos, both remats, the federated loss with
    ignore_zero_cats; then the CLI's training branch when this machine
    has h5py."""
    summary = []
    for label, cfg, zs, per_step in train_knob_configs():
        _, step_ms, peak, syncs = train_steps(cfg, zs, per_step, label)
        summary.append(f"{label}: {np.mean(step_ms[1:]):.1f} ms/step, peak "
                       f"{peak / 2 ** 30:.2f} GiB, "
                       f"{sum(syncs.values())} syncs a step")
    phase(8, "training knobs at B = 4 (480x640, bf16; steps 2-3, host "
             "clock): " + "; ".join(summary))
    try:
        import h5py  # noqa: F401
    except ImportError:
        phase(8, "the CLI's training branch over an h5 root is not run "
                 "here: this machine has no h5py (it writes the synthetic "
                 "root); tests/test_torch_slice11_train.py runs it on the "
                 "CPU")
        return
    run_cli_training()


def run_cli_training():
    """The CLI's training branch on the card: 2 iterations from a
    synthetic h5 root at the 64x96 miniature, then --resume to 3."""
    import tempfile
    from embodied_object_detection_tpu_torch import run
    from embodied_object_detection_tpu_torch.data import (
        generate_synthetic_dataset)
    with tempfile.TemporaryDirectory() as td:
        root = str(Path(td) / "synth")
        generate_synthetic_dataset(root, num_scenes=1, chunks_per_scene=2,
                                   frames=4, height=64, width=96, map_h=8,
                                   map_w=8)
        argv = ["--data-path", root, "--zs-weight", "random",
                "--output-dir", str(Path(td) / "out"), "--opts",
                "backbone.depths=(1,1,1,1)", "input.height=64",
                "input.width=96", "input.max_sequence_length=4",
                "roi.num_classes=5", "memory.max_cells=64",
                "solver.ims_per_batch=1", "solver.checkpoint_period=2"]
        first = run.main(["--max-iter", "2"] + argv)
        second = run.main(["--max-iter", "3", "--resume"] + argv)
    if (first.step, second.step) != (2, 3):
        raise AssertionError(f"CLI training steps {first.step}, "
                             f"{second.step}")
    phase(8, "the CLI's training branch trained 2 iterations from a "
             "synthetic h5 root on the card and resumed to 3")


def check_train_against_cpu():
    """Phase 9: one training step at the 64x96 f32 miniature on the card
    and on the CPU, from the same seeded weights and batch, at a learning
    rate the update can be seen at (base_lr 1e-3, no warmup)."""
    from embodied_object_detection_tpu_torch.config import DetectorConfig
    from embodied_object_detection_tpu_torch.data.synthetic import (
        synthetic_train_batch)
    from embodied_object_detection_tpu_torch.engine.solver import (
        ADAM_EPS, build_optimizer)
    from embodied_object_detection_tpu_torch.models.detector import (
        build_detector)
    from embodied_object_detection_tpu_torch.parallel.train_step import (
        batch_losses, batch_to_device)

    cfg = DetectorConfig()
    cfg = cfg.replace(
        compute_dtype="float32",
        backbone=dataclasses.replace(cfg.backbone, depths=(1, 1, 1, 1)),
        input=dataclasses.replace(cfg.input, height=64, width=96,
                                  max_gt_boxes=4),
        centernet=dataclasses.replace(cfg.centernet, pre_nms_topk_train=64,
                                      post_nms_topk_train=16),
        roi=dataclasses.replace(cfg.roi, detections_per_image=8,
                                num_classes=5),
        memory=dataclasses.replace(cfg.memory, max_cells=64, write_topk=4),
        solver=dataclasses.replace(cfg.solver, base_lr=1e-3,
                                   warmup_factor=1.0))
    batch = synthetic_train_batch(cfg, np.random.RandomState(2), 2, 1)
    zs = np.random.RandomState(4).randn(512, 6).astype(np.float32)
    zs[:, -1] = 0.0
    zs[:, :-1] /= np.linalg.norm(zs[:, :-1], axis=0, keepdims=True)
    res = {}
    for dev in ("cpu", "cuda"):
        model = build_detector(cfg, seed=3, device=dev)
        opt = build_optimizer(model, cfg.solver)
        before = {n: p.detach().cpu().clone()
                  for n, p in model.named_parameters()}
        total, losses = batch_losses(model, cfg, batch_to_device(batch, dev),
                                     torch.from_numpy(zs).to(dev), 0)
        total.backward()
        grads = {n: p.grad.detach().cpu().clone()
                 for n, p in model.named_parameters() if p.grad is not None}
        opt.step()
        res[dev] = ({k: float(v.detach()) for k, v in losses.items()}, grads,
                    {n: p.detach().cpu() - before[n]
                     for n, p in model.named_parameters()},
                    before, dict(zip(opt.names, opt.mults)), opt.lr(0))
    (l_c, g_c, d_c, p0, mult, lr0), (l_g, g_g, d_g, p0_g, _, _) = \
        res["cpu"], res["cuda"]
    for k in l_c:
        if not abs(l_g[k] - l_c[k]) <= 1e-4 * abs(l_c[k]) + 1e-6:
            raise AssertionError(f"phase 9 loss {k}: card {l_g[k]} vs CPU "
                                 f"{l_c[k]}")
    if set(g_c) != set(g_g):
        raise AssertionError("the card and the CPU differ on which "
                             "parameters get a gradient")
    if any(not torch.equal(p0[n], p0_g[n]) for n in p0):
        raise AssertionError("the card and the CPU start from different "
                             "parameters")
    grad_rel = max(float((g_g[n] - g_c[n]).abs().max()) /
                   max(float(g_c[n].abs().max()), 1e-30) for n in g_c)
    if grad_rel > 1e-3:
        raise AssertionError(f"phase 9 gradients differ by {grad_rel:.3e} "
                             "of a tensor's largest")
    # AdamW's first step is -lr mult (f(g) + wd p) with f(g) = g / (|g| +
    # eps) of the clipped gradient. Where the two devices' clipped
    # gradients a, b share a sign, f(a) - f(b) = eps (a - b) / ((|a| + eps)
    # (|b| + eps)), so the updates must agree to that plus f32 rounding
    # (rtol 1e-5 of the update, 2^-23 of the parameter); where a gradient
    # near 0 flips sign, f may differ by up to 2. Every element whose
    # gradient is far above eps on the card must move by at least half of
    # lr mult, so a step that does not update fails.
    clip = cfg.solver.clip_value
    worst, worst_round, flipped, moved, total_n = 0.0, 0.0, 0, 0, 0
    for n in d_c:
        a = g_g.get(n, torch.zeros_like(d_c[n])).clamp(-clip, clip)
        b = g_c.get(n, torch.zeros_like(d_c[n])).clamp(-clip, clip)
        same = torch.sign(a) == torch.sign(b)
        df = torch.where(same, ADAM_EPS * (a - b).abs() /
                         ((a.abs() + ADAM_EPS) * (b.abs() + ADAM_EPS)),
                         torch.full_like(a, 2.0))
        lrm = lr0 * mult.get(n, 0.0)
        rounding = 1e-5 * d_c[n].abs() + 2.0 ** -23 * p0[n].abs()
        bound = lrm * df + rounding
        diff = (d_g[n] - d_c[n]).abs()
        if not bool((diff <= bound).all()):
            raise AssertionError(f"phase 9 update of {n} differs by "
                                 f"{float(diff.max())} (card vs CPU)")
        worst = max(worst, float(torch.where(
            same, diff / bound.clamp(min=1e-30), 0.0).max()))
        # where the gradients agree to within the rounding terms
        worst_round = max(worst_round, float(torch.where(
            same & (lrm * df <= rounding), diff / bound.clamp(min=1e-30),
            0.0).max()))
        flipped += int((~same).sum())
        live = a.abs() > 100 * ADAM_EPS
        if n in mult and not bool(
                (d_g[n][live].abs() >= 0.5 * lrm).all()):
            raise AssertionError(f"phase 9: the card's step left {n} (almost) "
                                 f"unchanged where its gradient is not 0")
        moved += int(live.sum()) if n in mult else 0
        total_n += a.numel()
    if moved == 0:
        raise AssertionError("phase 9: no parameter has a gradient")
    phase(9, f"one training step at 64x96 f32 (B = 2, one padding row, lr "
             f"{lr0:g}): the card matches the CPU, losses within rtol 1e-4, "
             f"gradients within {grad_rel:.2e} of each tensor's largest "
             f"(tolerance 1e-3), updates p_new - p_old within {worst:.3f} of "
             f"lr mult eps|a-b|/((|a|+eps)(|b|+eps)) + 1e-5 |update| + "
             f"2^-23 |p| where the gradients share a sign (the first term "
             f"is f(a) - f(b) exactly, so near 1 where it dominates; "
             f"{worst_round:.3f} where the rounding terms do; {flipped} of "
             f"{total_n} elements flip sign, held within 2 lr mult), "
             f"{moved} elements moved by >= lr mult / 2 on the card")


def time_kernels(rng, launches, train_launches, errs, detr_launches,
                 detr_train_launches):
    from embodied_object_detection_tpu_torch.ops import memory_ops
    from embodied_object_detection_tpu_torch.ops import segment_sum as ss

    seg = None
    for ids in ("random", "coherent"):
        w, idx, cells = segment_sum_inputs(rng, ids)
        rows, lanes = w.shape
        keep = (idx >= 0) & (idx < cells)
        routed = torch.where(keep, idx.long(),
                             torch.full_like(idx, cells).long())
        ms = graph_ms(lambda: ss.segment_sum(w, idx, cells))
        plain_ms = graph_ms(lambda: ss.segment_sum_plain(w, idx, cells))
        lib_ms = graph_ms(lambda: torch.zeros((cells + 1, lanes),
                                              device="cuda").index_add_(
                                                  0, routed, w))
        # the rows with an id in range must be read, the others need not
        live = int(keep.sum())
        added = int(((w != 0) & keep[:, None]).sum())
        b_ms, b_by = bound_ms(live * lanes * 4 + rows * 4 +
                              cells * lanes * 4, added)
        print(f"  segment_sum, {ids} ids ({live} of {rows} rows in range): "
              f"{ms * 1e3:.2f} us kernel, {plain_ms * 1e3:.2f} us plain, "
              f"{lib_ms * 1e3:.2f} us index_add_, bound {b_ms * 1e3:.2f} us "
              f"({b_by})")
        if seg is None:       # the JSON entry: random ids
            seg = {"name": "segment_sum", "route": "cuda",
                   "source": "embodied_object_detection_tpu_torch/csrc/"
                             "segment_sum.cu",
                   "replaces": "embodied_object_detection_tpu/ops/"
                               "pallas_scatter.py:60",
                   "launches": launches["segment_sum"],
                   "max_abs_err": errs["segment_sum"],
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                   "bound_by": b_by, "library_ms": lib_ms}

    read = None
    for ids in ("random", "coherent"):
        feats, obs, proj = memory_read_inputs(rng)
        if ids == "coherent":
            proj = torch.from_numpy(coherent_proj(rng)).cuda()
        ms = graph_ms(lambda: memory_ops.memory_read(feats, obs, proj))
        plain_ms = graph_ms(lambda: memory_ops.memory_read_plain(feats, obs,
                                                                 proj))
        lib_ms = read_yardstick(feats[None], obs[None], proj[None],
                                memory_ops.memory_read(feats, obs,
                                                       proj)[None],
                                f"memory_read ({ids} ids)")
        h, wd = proj.shape
        d = feats.shape[1]
        rows_read = int(torch.unique(proj).numel())
        out_elems = (h // 4) * (wd // 4) * d
        b_ms, b_by = bound_ms(rows_read * d * 4 + obs.numel() * 4 +
                              proj.numel() * 4 + out_elems * 4,
                              out_elems * (16 * 2 + 1))
        print(f"  memory_read, {ids} ids ({rows_read} cells read): "
              f"{ms * 1e3:.2f} us kernel, {plain_ms * 1e3:.2f} us plain, "
              f"{lib_ms * 1e3:.2f} us embedding_bag, bound "
              f"{b_ms * 1e3:.2f} us ({b_by})")
        if read is None:      # the JSON entry: random ids
            read = {"name": "memory_read", "route": "cuda",
                    "source": "embodied_object_detection_tpu_torch/csrc/"
                              "memory_read.cu",
                    "replaces": "embodied_object_detection_tpu/ops/"
                                "memory_ops.py:43",
                    "launches": launches["memory_read"],
                    "max_abs_err": errs["memory_read"],
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": lib_ms}
    kernels = [seg, read] + time_nms(rng, launches, errs) + \
        time_roi_align(rng, launches, errs) + \
        time_roi_align_backward(rng, train_launches, errs) + \
        time_mask_paste(rng, launches, errs) + \
        time_memory_read_batched(rng, train_launches, errs) + \
        time_write_select(rng, launches, errs) + \
        time_ms_deform_attn(rng, detr_launches, detr_train_launches, errs)
    for k in kernels:
        print(f"  {k['name']}: {k['ms'] * 1e3:.1f} us kernel, "
              f"{k['plain_ms'] * 1e3:.1f} us plain, bound "
              f"{k['bound_ms'] * 1e3:.1f} us ({k['bound_by']}), library "
              f"{'-' if k['library_ms'] is None else '%.1f us' % (k['library_ms'] * 1e3)}")
    phase(7, "kernel device times from CUDA graphs of 20 calls x 10 "
             "replays, inputs L2-warm (the plain NMS, which checks its "
             "fixpoint on the host, and the plain ROIAlign backward, torch "
             "autograd, from CUDA events around 20 eager calls; the "
             "deformable attention's backward yardsticks, torch autograd, "
             "graph-captured like the kernels)")
    return kernels


def time_nms(rng, launches, errs):
    """Every NMS shape of the frame, the bypass and the partition's cases;
    the JSON entry is the multiclass one (2048 candidates, 20 classes),
    two of the three calls a frame."""
    from embodied_object_detection_tpu_torch.ops import nms
    entry = None
    part_rng = np.random.RandomState(6)
    for cases, r in ((NMS_CASES, rng), (PARTITION_CASES, part_rng)):
        for name, n, classes, t, ml, shift in cases:
            b, c, v = nms_inputs(r, n, classes, shift)
            disabled = ml and not t > 0
            ms = graph_ms(lambda: nms.nms_keep(b, c, v, t, disabled))
            plain_ms = event_ms(lambda: nms.nms_keep_plain(b, c, v, t,
                                                           disabled))
            # IoU operations of the pairs that need one (i < j, both valid,
            # one class); the sweep is serial and bound by its latency
            _, per_class = torch.unique(c[v], return_counts=True)
            pairs = 0 if disabled else sum(k * (k - 1) // 2
                                           for k in per_class.tolist())
            b_ms, b_by = bound_ms(n * (16 + 4 + 1) + n, 13 * pairs)
            print(f"  nms, {name}: {ms * 1e3:.1f} us kernel, "
                  f"{plain_ms * 1e3:.1f} us plain, bound {b_ms * 1e3:.3f} us "
                  f"({b_by}: {pairs} IoUs); the sweep is serial, bound by "
                  f"latency, not by bytes")
            if name == MULTICLASS_CASE:
                entry = {"name": "nms", "route": "cuda",
                         "source": "embodied_object_detection_tpu_torch/csrc/nms.cu",
                         "replaces": "embodied_object_detection_tpu/ops/nms.py:51",
                         "launches": launches["nms"],
                         "max_abs_err": errs["nms"], "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "library_ms": None}
    return [entry]


def time_roi_align(rng, launches, errs):
    """Both pooler shapes and the training pooler's in bf16; the JSON
    entry is the box pooler's (R = 256, 7 x 7), three of the four calls a
    frame."""
    from embodied_object_detection_tpu_torch.ops import roi_align as ra
    entry = None
    for r, size in ((256, 7), (100, 14), (512, 7)):
        levels, boxes = roi_inputs(rng, r, torch.bfloat16)
        lvl = roi_levels(boxes)
        ms = graph_ms(lambda: ra.roi_align_cuda(levels, boxes, lvl, STRIDES,
                                                size, 2))
        plain_ms = graph_ms(lambda: ra._roi_align_taps(levels, boxes, STRIDES,
                                                       size, 2, lvl))
        v4_ms = graph_ms(lambda: ra._roi_align_matmul(levels, boxes, STRIDES,
                                                      size, 2, lvl))
        c = levels[0].shape[-1]
        out_elems = r * size * size * c
        b_ms, b_by = bound_ms(
            forward_read_bytes(levels, boxes, lvl, size) + r * 20 +
            out_elems * 2, out_elems * (4 * 8 + 1))
        print(f"  roi_align, R = {r}, {size}x{size}, bf16: {ms * 1e3:.1f} us "
              f"kernel, {plain_ms * 1e3:.1f} us plain v1, "
              f"{v4_ms * 1e3:.1f} us plain v4, bound {b_ms * 1e3:.2f} us "
              f"({b_by})")
        if entry is None:
            entry = {"name": "roi_align", "route": "cuda",
                     "source": "embodied_object_detection_tpu_torch/csrc/roi_align.cu",
                     "replaces": "embodied_object_detection_tpu/ops/roi_align.py:229",
                     "launches": launches["roi_align"],
                     "max_abs_err": errs["roi_align"], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None}
    return [entry]


def time_roi_align_backward(rng, launches, errs, r=512):
    """The training pooler's backward (R = 512, 7 x 7 x 256, bf16), three
    calls a frame; its plain version is torch autograd of the tap form."""
    from embodied_object_detection_tpu_torch.ops import roi_align as ra
    levels, boxes = roi_inputs(rng, r, torch.bfloat16)
    lvl = roi_levels(boxes)
    grad = torch.from_numpy(rng.randn(r, 7, 7, 256).astype(np.float32)
                            ).cuda().to(torch.bfloat16)
    shapes = [f.shape[:2] for f in levels]
    ms = graph_ms(lambda: ra.roi_align_backward_cuda(
        grad, shapes, boxes, lvl, STRIDES, 2, torch.bfloat16))
    leaves = [f.requires_grad_(True) for f in levels]
    plain_ms = event_ms(lambda: torch.autograd.grad(
        ra._roi_align_taps(leaves, boxes, STRIDES, 7, 2, lvl), leaves,
        grad.float()))
    c = grad.shape[-1]
    scalar, vector = backward_atomics(levels, boxes, lvl, c)
    contributions = float(scalar)
    b_ms, b_by = bound_ms(grad.numel() * 2 + r * 20 +
                          sum(f.numel() * 2 for f in levels),
                          2 * contributions)
    print(f"  roi_align backward, R = {r}, 7x7, bf16: {ms * 1e3:.1f} us "
          f"kernel, {plain_ms * 1e3:.1f} us plain v1 autograd, "
          f"{contributions:.3e} contributions summed in registers and "
          f"flushed as {vector} float4 atomics, bound {b_ms * 1e3:.2f} us "
          f"({b_by})")
    return [{"name": "roi_align_backward", "route": "cuda",
             "source": "embodied_object_detection_tpu_torch/csrc/roi_align.cu",
             "replaces": "embodied_object_detection_tpu/ops/roi_align.py:229",
             "launches": launches["roi_align_backward"],
             "max_abs_err": errs["roi_align_backward"], "ms": ms,
             "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": None}]


def time_memory_read_batched(rng, launches, errs, b=TRAIN_FRAMES):
    from embodied_object_detection_tpu_torch.ops import memory_ops
    feats = torch.from_numpy(
        (rng.randn(b, 8192, 512) * 4).astype(np.float32)).cuda()
    obs = torch.from_numpy(rng.choice([0.0, 1.0, 2.0, 5.0], (b, 8192))
                           .astype(np.float32)).cuda()
    proj = torch.from_numpy(
        rng.randint(0, 8192, (b, 480, 640)).astype(np.int32)).cuda()
    ms = graph_ms(lambda: memory_ops.memory_read_batched(feats, obs, proj))
    plain_ms = graph_ms(lambda: memory_ops.memory_read_batched_plain(
        feats, obs, proj))
    lib_ms = read_yardstick(feats, obs, proj, memory_ops.memory_read_batched(
        feats, obs, proj), "memory_read_batched")
    d = feats.shape[-1]
    rows_read = sum(int(torch.unique(proj[i]).numel()) for i in range(b))
    out_elems = b * 120 * 160 * d
    b_ms, b_by = bound_ms(rows_read * d * 4 + obs.numel() * 4 +
                          proj.numel() * 4 + out_elems * 4,
                          out_elems * (16 * 2 + 1))
    return [{"name": "memory_read_batched", "route": "cuda",
             "source": "embodied_object_detection_tpu_torch/csrc/memory_read.cu",
             "replaces": "embodied_object_detection_tpu/ops/memory_ops.py:75",
             "launches": launches["memory_read_batched"],
             "max_abs_err": errs["memory_read_batched"], "ms": ms,
             "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": lib_ms}]


def read_yardstick(feats, obs, proj, got, name, pool=4):
    """Time one F.embedding_bag(mode="mean") over bags of the pool x pool
    window ids into the normalised table widened to f32, both prepared
    beforehand (frame b's ids offset by b * cells); print its largest
    difference from the kernel's output `got`. Timed only: the port never
    calls it."""
    import torch.nn.functional as F
    from embodied_object_detection_tpu_torch.ops import memory_ops
    b, cells, d = feats.shape
    h, w = proj.shape[1:]
    table = memory_ops.normalize_memory(feats.reshape(-1, d),
                                        obs.reshape(-1)).to(
                                            torch.bfloat16).float()
    idx = proj.long() + (torch.arange(b, device="cuda") * cells)[:, None,
                                                                 None]
    idx = idx.reshape(b, h // pool, pool, w // pool, pool).permute(
        0, 1, 3, 2, 4).reshape(-1, pool * pool).contiguous()
    lib_ms = graph_ms(lambda: F.embedding_bag(idx, table, mode="mean"))
    diff = float((F.embedding_bag(idx, table, mode="mean").reshape(got.shape)
                  - got).abs().max())
    print(f"  {name}: the F.embedding_bag(mean) yardstick differs from the "
          f"kernel by at most {diff:.3e} ({lib_ms * 1e3:.1f} us)")
    return lib_ms


def time_write_select(rng, launches, errs):
    """The selection on the paste's flags (the frame's path; the JSON
    entry), and the two-pass selection on masks alone beside it. The bound
    counts what the select pass must move: the flags, the counts, the
    selected pixels' mask rows and cell ids, seg_idx and aug."""
    from embodied_object_detection_tpu_torch.ops import mask_paste as mp
    from embodied_object_detection_tpu_torch.ops import memory_ops
    probs, boxes = paste_inputs(rng)
    valid = torch.from_numpy(rng.rand(100) > 0.2).cuda()
    proj = torch.from_numpy(
        rng.randint(0, 8192, (480, 640)).astype(np.int32)).cuda()
    masks, observed, counts = mp.paste_masks_observed(probs, boxes, valid,
                                                      480, 640)
    ms = graph_ms(lambda: memory_ops.write_select(masks, valid, proj, 8,
                                                  observed, counts))
    two_pass_ms = graph_ms(lambda: memory_ops.write_select(masks, valid,
                                                           proj, 8))
    plain_ms = graph_ms(lambda: memory_ops.write_select_plain(
        masks, valid, proj, 8, observed, counts))
    h, w, n = masks.shape
    slots = h * (w // 8)
    seg, _ = memory_ops.write_select(masks, valid, proj, 8, observed, counts)
    filled = int((seg >= 0).sum())
    b_ms, b_by = bound_ms(observed.numel() + counts.numel() * 4 + n +
                          filled * (n + 4) + slots * 4 +
                          slots * (n + 1) * 4, filled * n)
    print(f"  write_select on the paste's flags: {ms * 1e3:.1f} us, bound "
          f"{b_ms * 1e3:.2f} us ({b_by}; {filled} pixels selected); the "
          f"two-pass selection on masks alone {two_pass_ms * 1e3:.1f} us")
    return [{"name": "write_select", "route": "cuda",
             "source": "embodied_object_detection_tpu_torch/csrc/write_select.cu",
             "replaces": "embodied_object_detection_tpu/ops/memory_ops.py:188",
             "launches": launches["write_select"],
             "max_abs_err": errs["write_select"], "ms": ms,
             "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": None}]


def time_mask_paste(rng, launches, errs):
    """The write's paste with its flag epilogue (100 masks into 480 x 640,
    pixel-major bool, the frame's path; the JSON entry), and the paste
    without it beside it; the yardstick is one F.grid_sample
    (align_corners=False, zero padding) and the compare, on a sampling
    grid built beforehand."""
    import torch.nn.functional as F
    from embodied_object_detection_tpu_torch.ops import mask_paste as mp
    masks, boxes = paste_inputs(rng)
    valid = torch.from_numpy(rng.rand(100) > 0.2).cuda()
    n, m, _ = masks.shape
    h, w = 480, 640
    ms = graph_ms(lambda: mp.paste_masks_observed(masks, boxes, valid, h, w))
    bare_ms = graph_ms(lambda: mp.paste_masks(masks, boxes, h, w, 0.5,
                                              pixel_major=True))
    plain_ms = graph_ms(lambda: plain_observed(masks, boxes, valid, h, w))
    xs = torch.arange(w, device="cuda", dtype=torch.float32) + 0.5
    ys = torch.arange(h, device="cuda", dtype=torch.float32) + 0.5
    bw = (boxes[:, 2] - boxes[:, 0]).clamp(min=1e-4)[:, None]
    bh = (boxes[:, 3] - boxes[:, 1]).clamp(min=1e-4)[:, None]
    gx = (xs[None] - boxes[:, 0, None]) / bw * 2.0 - 1.0
    gy = (ys[None] - boxes[:, 1, None]) / bh * 2.0 - 1.0
    grid = torch.stack([gx[:, None, :].expand(n, h, w),
                        gy[:, :, None].expand(n, h, w)], -1).contiguous()

    def library():
        return F.grid_sample(masks[:, None], grid, mode="bilinear",
                             padding_mode="zeros",
                             align_corners=False)[:, 0] >= 0.5

    lib_ms = graph_ms(library)
    lib_flips = int((library().permute(1, 2, 0) !=
                     mp.paste_masks_plain(masks, boxes, h, w, 0.5,
                                          pixel_major=True)).sum())
    tiles = -(-w // mp.TILE_COLS)
    b_ms, b_by = bound_ms(n * m * m * 4 + n * 16 + n + h * w * n + h * w +
                          h * tiles * 4, h * w * n * 10)
    print(f"  mask_paste with the flag epilogue {ms * 1e3:.1f} us, without "
          f"it {bare_ms * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us ({b_by}); "
          f"the grid_sample yardstick disagrees with the plain version on "
          f"{lib_flips} of {h * w * n} pixels")
    return [{"name": "mask_paste", "route": "cuda",
             "source": "embodied_object_detection_tpu_torch/csrc/mask_paste.cu",
             "replaces": "embodied_object_detection_tpu/ops/mask_paste.py:38",
             "launches": launches["mask_paste"],
             "max_abs_err": errs["mask_paste"], "ms": ms,
             "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": lib_ms}]


def plain_observed(masks, boxes, valid, h, w):
    """The plain version of the exact write's paste on the card: the plain
    paste, then its flags and row counts."""
    from embodied_object_detection_tpu_torch.ops import mask_paste as mp
    out = mp.paste_masks_plain(masks, boxes, h, w, 0.5, pixel_major=True)
    observed = (out & valid).any(dim=-1)
    return out, observed, observed.sum(dim=1, keepdim=True,
                                       dtype=torch.int32)


# ------------------------------------------------------------ serving

ROBOT_FRAMES = 20
ROBOT_MAP = 200         # cells a side: the robot demo's 40 m at 0.2 m
# the server's requests: 5 frames, the memory reset before the fourth
SERVER_FRAMES, SERVER_RESET = 5, 3
# launches a frame of the image-only demo: proposal and final NMS, three
# cascade stages; no read, write NMS, mask pooler, paste, selection or
# segment-sum
LAUNCHES_PER_IMAGE = {"nms": 2, "roi_align": 3, **PACKED_PROPOSALS}


def robot_config():
    """The default config with the robot demo's changes: one class per
    proposal, a 200 x 200-cell map."""
    from embodied_object_detection_tpu_torch.config import DetectorConfig
    cfg = DetectorConfig()
    return cfg.replace(
        roi=dataclasses.replace(cfg.roi, one_class_per_proposal=True),
        memory=dataclasses.replace(cfg.memory,
                                   max_cells=ROBOT_MAP * ROBOT_MAP))


def robot_trajectory(rng, frames, h, w, vfov):
    """A synthetic RGB-D trajectory made from a seed: the camera moves and
    turns inside a 12 m x 3 m x 10 m box room; depth is the z distance to
    its walls, floor and ceiling in mm, with 0-mm holes; RGB is noise.
    Returns (images [T, H, W, 3] uint8, depth [T, H, W] f32 mm, xyzhe
    [T, 5] f32)."""
    from embodied_object_detection_tpu_torch.geometry import projector
    xs, ys = (t.numpy().astype(np.float64) for t in
              projector.pixel_scales(w, h, vfov, "cpu"))
    t = np.arange(frames)
    poses = np.stack([0.15 * t - 1.0, np.full(frames, 1.2), 0.1 * t - 0.5,
                      0.2 * t, 0.1 * np.sin(0.5 * t)], 1).astype(np.float32)
    lo = np.array([-6.0, 1.2 - 1.5, -5.0])      # the room's walls
    hi = np.array([6.0, 1.2 + 1.5, 5.0])
    depth = np.empty((frames, h, w), np.float32)
    for f in range(frames):
        T = projector.transform3d(torch.from_numpy(poses[f:f + 1]))[0]
        rot = T[:3, :3].double().numpy()
        ray = np.stack([xs, ys, np.ones_like(xs)], -1) @ rot.T   # z = 1
        pos = poses[f, :3].astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            hits = np.concatenate([(lo - pos) / ray, (hi - pos) / ray], -1)
        hits[~(hits > 0)] = np.inf
        depth[f] = hits.min(-1) * 1000.0
    depth[rng.rand(*depth.shape) < 0.02] = 0.0
    depth[:, :40, :60] = 0.0                   # a hole the sensor missed
    images = rng.randint(0, 255, (frames, h, w, 3)).astype(np.uint8)
    return images, depth, poses


def projector_gap(depth, pose, vfov, got, want):
    """The pixels where the card's projector and the plain CPU projector
    part: (pixels apart outside the boundary band, pixels in the band),
    the band being the pixels whose map coordinate (world x or z over the
    cell size, from the CPU's world points) lies within 1e-4 cells of a
    rounding boundary, or whose height lies within 1e-4 m of the z-clip
    (a comparison the two devices' last bits may decide apart), among the
    pixels with depth."""
    from embodied_object_detection_tpu_torch.demo import robot_demo
    from embodied_object_detection_tpu_torch.geometry import projector
    T = projector.transform3d(torch.from_numpy(pose[None]))[0]
    half = ROBOT_MAP * robot_demo.GRID_CELL_M / 2.0
    world = projector.pixel_to_world(
        torch.from_numpy(depth), T, vfov, torch.tensor([-half, 0.0, -half]),
        depth_scaling=robot_demo.DEPTH_SCALING)
    xz = world[..., [0, 2]].double().numpy() / robot_demo.GRID_CELL_M
    band = (np.abs(np.abs(xz - np.floor(xz)) - 0.5) < 1e-4).any(-1)
    # and the pixels whose height lies within 1e-4 m of the z-clip
    clip = float(pose[1]) + robot_demo.Z_CLIP_M
    band |= np.abs(world[..., 1].double().numpy() - clip) < 1e-4
    band &= depth > 0           # a hole is an outlier on both, at cell 0
    apart = np.zeros(band.shape, bool)
    for g, c in zip(got, want):
        apart |= g.cpu().numpy() != c.numpy()
    return int((apart & ~band).sum()), int(band.sum())


def run_robot_path():
    """Phase 11: the robot demo's path at full width: a 20-frame synthetic
    RGB-D trajectory through `robot_demo.compute_proj_indices` on the card
    and `EmbodiedPredictor`, the projector held to the plain CPU
    projector, the segment-sum and the read at the map's 40 000 cells
    against their plain versions, launches and host syncs a request."""
    from embodied_object_detection_tpu_torch.demo import robot_demo
    from embodied_object_detection_tpu_torch.demo.predictor import (
        EmbodiedPredictor, load_zs_weight_npy)
    from embodied_object_detection_tpu_torch.models.detector import (
        build_detector)

    cfg = robot_config()
    cells = cfg.memory.max_cells
    h, w = cfg.input.height, cfg.input.width
    err_s = check_segment_sum(np.random.RandomState(11), cells, None)
    err_r = check_memory_read(np.random.RandomState(12), cells, None)
    print(f"  at {cells} cells: segment_sum max |kernel - plain| "
          f"{err_s:.3e} (within rows x 2^-24 x sum|w|), memory_read "
          f"{err_r:.3e} (rtol/atol 1e-6)")
    vfov = math.radians(robot_demo.DEFAULT_VFOV_DEG)
    images, depth, poses = robot_trajectory(np.random.RandomState(7),
                                            ROBOT_FRAMES, h, w, vfov)
    model = build_detector(cfg, seed=0, device="cuda")
    zs = load_zs_weight_npy(str(REPO / "embodied_object_detection_tpu_torch"
                                / "data" / "metadata" / "mp3d_clip.npy"))
    t0 = time.perf_counter()
    predictor = EmbodiedPredictor(cfg, model=model, zs_weight=zs)
    print(f"  predictor ready in {time.perf_counter() - t0:.2f} s (kernels "
          f"built and bound at construction)")

    def project(f, device):
        return robot_demo.compute_proj_indices(depth[f], poses[f], vfov,
                                               ROBOT_MAP, device=device)

    apart = band = outliers = 0
    proj_ms, req_ms = [], []
    n_det = []
    zero_counters()
    for f in range(ROBOT_FRAMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, outl = project(f, "cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dets = predictor(images[f], ids, outl)
        t2 = time.perf_counter()
        proj_ms.append((t1 - t0) * 1e3)
        req_ms.append((t2 - t1) * 1e3)
        n_det.append(int(dets.valid.sum()))
        a, b = projector_gap(depth[f], poses[f], vfov, (ids, outl),
                             project(f, "cpu"))
        apart, band = apart + a, band + b
        outliers += int(outl.sum())
        if not (torch.isfinite(dets.boxes).all() and
                torch.isfinite(dets.scores).all()):
            raise AssertionError(f"phase 11 frame {f}: non-finite output")
    launches = read_counters()
    expected = {k: LAUNCHES_PER_FRAME.get(k, 0) * ROBOT_FRAMES
                for k in launches}
    if launches != expected:
        raise AssertionError(f"phase 11: launches {launches}, expected "
                             f"{expected}")
    if apart:
        raise AssertionError(f"phase 11: the card's projector parts from "
                             f"the CPU's at {apart} pixels off the "
                             f"rounding boundaries")
    print(f"  projector: ids and outlier masks equal to the plain CPU "
          f"projector's on {ROBOT_FRAMES} x {h * w} pixels but for {band} "
          f"pixels within 1e-4 cells of a rounding boundary (not held); "
          f"{outliers / ROBOT_FRAMES:.0f} outliers a frame (holes, beyond "
          f"the z-clip)")
    ids, outl = project(0, "cuda")
    syncs = sync_sites(lambda: predictor(images[0], ids, outl))
    print(f"  host syncs of one request (sync debug mode 'warn'): "
          f"{sum(syncs.values())}")
    for site, n in syncs.items():
        print(f"    {n} x {site}")
    inside = [s for s in syncs if not s.startswith("predictor.py")]
    if inside or sum(syncs.values()) != 2:
        raise AssertionError(f"phase 11: expected the guard's copy of the "
                             f"ids and the detections' copy, got {syncs}")
    semmap = predictor.semantic_map(ROBOT_MAP, ROBOT_MAP)
    seen = semmap[semmap >= 0]
    hist = np.bincount(seen, minlength=20)
    print(f"  semantic_map {semmap.shape}: {seen.size} cells observed above "
          f"the intensity threshold, "
          f"{int((predictor.memory.obs_count > 0).sum())} cells observed, "
          f"classes {({int(c): int(hist[c]) for c in np.flatnonzero(hist)})}")
    if not seen.size:
        raise AssertionError("phase 11: the semantic map is empty")
    steady = sorted(req_ms[1:])
    req = steady[len(steady) // 2]
    prj = sorted(proj_ms[1:])[len(proj_ms) // 2]
    print(f"  ms a request {', '.join(f'{x:.2f}' for x in req_ms)}; the "
          f"projector {', '.join(f'{x:.2f}' for x in proj_ms)}")
    print(f"  detections a frame: {n_det}")
    phase(11, f"robot path at 480x640, {cells} cells, {ROBOT_FRAMES} frames: "
              f"median {req:.2f} ms a request + {prj:.2f} ms projector, "
              f"{1000 / (req + prj):.2f} frames/s; launches a request "
              f"{LAUNCHES_PER_FRAME}; projector equal but for {band} "
              f"boundary pixels; host syncs: the ids' guard copy and the "
              f"detections' copy")
    return model, cfg, predictor.memory


def shift_mask_logits(model):
    with torch.no_grad():
        model.roi_heads.mask_head.predictor.bias.add_(MASK_LOGIT_SHIFT)


def sorted_scores(dets):
    v = dets.valid.cpu()
    return dets.scores.cpu()[v].sort(descending=True).values


def hold_scores(name, got, want, fresh):
    """Equal counts, scores within phase 6's tolerances after a fresh
    memory, else within the episode tolerance (rtol 1e-3, atol 1e-4)."""
    g, w = sorted_scores(got), sorted_scores(want)
    if g.numel() != w.numel():
        raise AssertionError(f"{name}: {g.numel()} detections vs "
                             f"{w.numel()}")
    rtol, atol = (1e-4, 1e-5) if fresh else (1e-3, 1e-4)
    torch.testing.assert_close(g, w, rtol=rtol, atol=atol)
    return float((g - w).abs().max()) if g.numel() else 0.0


class WriteSpy:
    """Keeps the memory write's features and its segment-sum's inputs over
    one frame, for `bound`: how far two runs of that write may part."""

    def __enter__(self):
        from embodied_object_detection_tpu_torch.models import detector
        from embodied_object_detection_tpu_torch.ops import memory_ops
        self.modules = detector, memory_ops
        self.saved = seg, write = (memory_ops.segment_sum,
                                   detector.memory_write)
        self.seen = {}

        def spy_seg(wt, idx, n):
            self.seen["seg"] = (wt, idx, n)
            return seg(wt, idx, n)

        def spy_write(feats, *a, **k):
            self.seen["feats"] = feats
            return write(feats, *a, **k)
        memory_ops.segment_sum, detector.memory_write = spy_seg, spy_write
        return self

    def __exit__(self, *exc):
        detector, memory_ops = self.modules
        memory_ops.segment_sum, detector.memory_write = self.saved

    def bound(self, want_f):
        """The largest gap, a memory entry, between `want_f` (the memory
        after the write) and another run of the same write: the
        segment-sum adds in another order each run."""
        from embodied_object_detection_tpu_torch.ops.segment_sum import (
            segment_sum_plain)
        wt, idx, cells = self.seen["seg"]
        keep = (idx >= 0) & (idx < cells)
        rows = torch.bincount(idx[keep].long(), minlength=cells).float()
        abs_acc = segment_sum_plain(wt.abs(), idx, cells)
        count = abs_acc[:, -1].clamp(min=1.0)
        feats = self.seen["feats"].float().abs()
        # the weights' sums part by at most rows x 2^-24 x sum|w| a lane;
        # the [cells, N] x [N, D] product of the parted sums rounds apart
        # by at most (N + 2) x 2^-23 of |acc| @ |features| (N terms, the
        # division); the addition to the memory by 2^-23 of the result
        lane_err = rows[:, None] * 2.0 ** -24 * abs_acc[:, :-1]
        n_terms = abs_acc.shape[1] - 1
        return (lane_err @ feats) / count[:, None] + \
            (n_terms + 2) * 2.0 ** -23 * (abs_acc[:, :-1] @ feats) / \
            count[:, None] + 2.0 ** -23 * want_f.abs()


def match_detections(name, reply, want):
    """Match a reply's detections one to one with `want`'s: the same class,
    the score within phase 6's tolerances and the box within rtol 1e-3,
    atol 1e-2. They are matched, not compared by rank: two detections
    whose scores lie that close may come out in either order."""
    v = want.valid.cpu()
    ws, wb = want.scores.cpu()[v], want.boxes.cpu()[v]
    wc = want.classes.cpu()[v].long()
    rs = torch.tensor(reply["scores"], dtype=torch.float32)
    rb = torch.tensor(reply["boxes"], dtype=torch.float32).reshape(-1, 4)
    rc = torch.tensor(reply["classes"], dtype=torch.long)
    if rs.numel() != ws.numel() or rc.numel() != rs.numel() or \
            rb.shape[0] != rs.numel():
        raise AssertionError(f"{name}: {rs.numel()} scores, {rc.numel()} "
                             f"classes, {rb.shape[0]} boxes vs "
                             f"{ws.numel()} detections")
    rtol, atol = 1e-4, 1e-5
    free = torch.ones(ws.numel(), dtype=torch.bool)
    for i in torch.argsort(rs, descending=True, stable=True).tolist():
        near = (free & (wc == rc[i])
                & ((ws - rs[i]).abs() <= atol + rtol * ws.abs())
                & ((wb - rb[i]).abs() <= 1e-2 + 1e-3 * wb.abs()).all(1))
        j = torch.nonzero(near).flatten()
        if j.numel() == 0:
            raise AssertionError(
                f"{name}: reply detection {i} (class {int(rc[i])}, score "
                f"{float(rs[i]):.6g}, box {rb[i].tolist()}) has no "
                f"counterpart among the predictor's own detections")
        free[j[0]] = False


def post_json(url, payload, timeout=120):
    """(status, reply, encode s, round trip s, decode s) of one POST; the
    round trip includes the server's decoding of the body."""
    import urllib.error
    import urllib.request
    t0 = time.perf_counter()
    body = payload if isinstance(payload, bytes) else \
        json.dumps(payload).encode()
    t1 = time.perf_counter()
    req = urllib.request.Request(url, body, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            code, raw = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, raw = e.code, e.read()
    t2 = time.perf_counter()
    reply = json.loads(raw)
    return code, reply, t1 - t0, t2 - t1, time.perf_counter() - t2


def check_predictor_and_server(robot_model, robot_cfg):
    """Phase 11b: `EmbodiedPredictor` at the 64x96 f32 miniature on the
    card against the CPU (5 frames, the memory reset before the fourth),
    then `make_server` around a full-width predictor, its replies held to
    the predictor's own detections on the same frames."""
    from embodied_object_detection_tpu_torch.config import DetectorConfig
    from embodied_object_detection_tpu_torch.demo.predictor import (
        EmbodiedPredictor, load_zs_weight_npy)
    from embodied_object_detection_tpu_torch.models.detector import (
        build_detector)
    from embodied_object_detection_tpu_torch.serve.server import make_server
    import threading

    frames = 5
    cfg = miniature(DetectorConfig(), frames)
    rng = np.random.RandomState(21)
    images = rng.randint(0, 255, (frames, 64, 96, 3)).astype(np.uint8)
    projs = rng.randint(0, 64, (frames, 64, 96)).astype(np.int32)
    zs = rng.randn(512, 6).astype(np.float32)
    zs[:, -1] = 0.0
    zs[:, :-1] /= np.linalg.norm(zs[:, :-1], axis=0, keepdims=True)
    outs, pasted = {}, {}
    for dev in ("cuda", "cpu"):
        model = build_detector(cfg, seed=3, device=dev)
        shift_mask_logits(model)
        pred = EmbodiedPredictor(cfg, model=model, zs_weight=zs, device=dev)
        with PasteRecorder() as rec:
            outs[dev] = []
            for t in range(frames):
                if t == SERVER_RESET:
                    pred.reset_memory()
                outs[dev].append(pred(images[t], projs[t]))
        pasted[dev] = rec.calls
    flip_since_reset = False
    held, skipped, worst = 0, 0, 0.0
    for t in range(frames):
        if t == SERVER_RESET:
            flip_since_reset = False
        fresh = t in (0, SERVER_RESET)
        if flip_since_reset:
            skipped += 1
        else:
            worst = max(worst, hold_scores(f"phase 11b frame {t}",
                                           outs["cuda"][t], outs["cpu"][t],
                                           fresh))
            held += 1
        flip_since_reset |= sum(paste_flips(pasted["cpu"][t],
                                            pasted["cuda"][t], 64, 96)) > 0
    print(f"  predictor at 64x96 f32, {frames} frames, reset before frame "
          f"{SERVER_RESET}: {held} frames held (first after a reset rtol "
          f"1e-4, later 1e-3), {skipped} after a paste flip not held; "
          f"largest score gap {worst:.3e}")

    # the server around a full-width predictor; then the predictor called
    # directly on each request's frame and the memory the server held
    # before it (its low bits are run-dependent: the write's atomics)
    h, w = robot_cfg.input.height, robot_cfg.input.width
    cells = robot_cfg.memory.max_cells
    rng = np.random.RandomState(22)
    big = rng.randint(0, 255, (SERVER_FRAMES, h, w, 3)).astype(np.uint8)
    big_proj = np.stack([coherent_proj(rng, h, w, cells)
                         for _ in range(SERVER_FRAMES)])
    mp3d = load_zs_weight_npy(str(REPO / "embodied_object_detection_tpu_torch"
                                  / "data" / "metadata" / "mp3d_clip.npy"))
    served = EmbodiedPredictor(robot_cfg, model=robot_model, zs_weight=mp3d)
    server = make_server(served, port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    rows, replies, before = [], [], []
    try:
        import urllib.request
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            if json.loads(r.read()) != {"status": "ok"}:
                raise AssertionError("phase 11b: /healthz")
        for t in range(SERVER_FRAMES):
            body = {"image": big[t].tolist(),
                    "proj_indices": big_proj[t].tolist()}
            if t == SERVER_RESET:
                body["reset_memory"] = True
            before.append(served.memory)
            code, reply, enc, rt, dec = post_json(base + "/predict", body)
            if code != 200:
                raise AssertionError(f"phase 11b: /predict {t} -> {code} "
                                     f"{reply}")
            blob = json.dumps(body)
            t0 = time.perf_counter()
            json.loads(blob)
            body_dec = time.perf_counter() - t0
            replies.append(reply)
            rows.append((len(reply["scores"]), enc, rt, dec, body_dec,
                         len(blob)))
        after = before[1:] + [served.memory]
        zs_body = {"zs_weight": mp3d.tolist(), "names": None}
        code, reply, *_ = post_json(base + "/set_vocabulary", zs_body)
        if code != 200 or reply != {"num_classes": 20}:
            raise AssertionError(f"phase 11b: /set_vocabulary -> {code} "
                                 f"{reply}")
        code, reply, *_ = post_json(base + "/predict", b"{not json")
        if code != 400:
            raise AssertionError(f"phase 11b: a malformed body -> {code} "
                                 f"{reply}")
    finally:
        server.shutdown()
        server.server_close()
    direct = EmbodiedPredictor(robot_cfg, model=robot_model, zs_weight=mp3d)
    direct_ms, bit_equal, mem_err = [], 0, 0.0
    for t in range(SERVER_FRAMES):
        name = f"phase 11b /predict {t}"
        if t == SERVER_RESET:
            direct.reset_memory()
        elif t:
            direct.memory = before[t]
        with WriteSpy() as spy:
            t0 = time.perf_counter()
            want = direct(big[t], big_proj[t])
            direct_ms.append((time.perf_counter() - t0) * 1e3)
        got = want._replace(
            scores=torch.tensor(replies[t]["scores"], dtype=torch.float32),
            valid=torch.ones(len(replies[t]["scores"]), dtype=torch.bool))
        hold_scores(name, got, want, True)
        match_detections(name, replies[t], want)
        bit_equal += torch.equal(sorted_scores(got), sorted_scores(want))
        err = (after[t].features - direct.memory.features).abs()
        bound = spy.bound(direct.memory.features)
        if not bool((err <= bound).all()):
            raise AssertionError(f"{name}: the server's memory beyond the "
                                 f"segment-sum's bound: "
                                 f"{float((err - bound).max()):.3e}")
        if not torch.equal(after[t].obs_count, direct.memory.obs_count):
            raise AssertionError(f"{name}: the server's observation counts "
                                 f"differ")
        mem_err = max(mem_err, float(err.max()))
    for t, (n, enc, rt, dec, bdec, size) in enumerate(rows):
        print(f"  /predict {t}: {n} detections; body {size / 1e6:.1f} MB; "
              f"client encode {enc * 1e3:.1f} ms, round trip {rt * 1e3:.1f} "
              f"ms (of which the body's decode alone takes "
              f"{bdec * 1e3:.1f} ms), reply decode {dec * 1e3:.2f} ms; the "
              f"predictor called directly {direct_ms[t]:.1f} ms")
    rt = sorted(r[2] for r in rows[1:])[len(rows[1:]) // 2] * 1e3
    enc = sorted(r[1] for r in rows[1:])[len(rows[1:]) // 2] * 1e3
    phase("11b", f"predictor at 64x96 f32 matches the CPU over {frames} "
                 f"frames with a reset ({held} held, {skipped} after a "
                 f"paste flip); server at 480x640: /healthz, "
                 f"{SERVER_FRAMES} /predict (one resetting) equal to the "
                 f"predictor's own on the memory the server held, within "
                 f"phase 6's tolerances ({bit_equal} bit-equal scores), the "
                 f"server's memory within the segment-sum's bound (max err "
                 f"{mem_err:.3e}), /set_vocabulary 200, a malformed body "
                 f"400; "
                 f"median round trip {rt:.0f} ms + {enc:.0f} ms encoding a "
                 f"request")


def check_image_demo():
    """Phase 11c: the image-only demo at full width: `predict_api`'s
    `detect` with the LVIS (1203 classes) and COCO vocabularies, launches
    a frame, `VisualizationDemo(parallel=True)` over 6 frames in order,
    and the multiclass NMS's kept set on one frame's LVIS cascade scores
    at score threshold 0 against the plain fixpoint."""
    from embodied_object_detection_tpu_torch.demo import predict_api
    from embodied_object_detection_tpu_torch.demo.demo import (
        VisualizationDemo, resolve_vocabulary)
    from embodied_object_detection_tpu_torch.models.centernet import (
        decode_proposals)
    from embodied_object_detection_tpu_torch.ops import nms
    from embodied_object_detection_tpu_torch.config import DetectorConfig

    rng = np.random.RandomState(31)
    images = rng.randint(0, 255, (6, 480, 640, 3)).astype(np.uint8)
    p = predict_api.Predictor()
    p.setup(cfg=DetectorConfig())
    for vocab in ("lvis", "coco"):
        p.detect(images[0], vocabulary=vocab)       # builds, warms up
        torch.cuda.synchronize()
        zero_counters()
        t0 = time.perf_counter()
        dets = p.detect(images[1], vocabulary=vocab)
        ms = (time.perf_counter() - t0) * 1e3
        launches = read_counters()
        expected = {k: LAUNCHES_PER_IMAGE.get(k, 0) for k in launches}
        if launches != expected:
            raise AssertionError(f"phase 11c {vocab}: launches {launches}, "
                                 f"expected {expected}")
        n = len(p._demo.class_names)
        cls = np.asarray(dets.classes)[np.asarray(dets.valid)]
        print(f"  detect, {vocab} ({n} classes): {ms:.1f} ms, "
              f"{len(cls)} detections above 0.3, classes < {n}: "
              f"{bool((cls < n).all())}")
        if not (cls < n).all() or not np.isfinite(dets.scores).all():
            raise AssertionError(f"phase 11c {vocab}: bad detections")

    # the parallel demo over 6 frames, results in order
    model, cfg = p._model, p._demo.cfg
    zs = p._demo.predictor.zs_weight.cpu().numpy()
    names = p._demo.class_names
    single = [p.detect(im, vocabulary="coco") for im in images]
    demo = VisualizationDemo(cfg, zs, names, model=model, parallel=True)

    class Video:
        def __init__(self):
            self.i = 0

        def read(self):
            if self.i == len(images):
                return False, None
            self.i += 1
            return True, np.ascontiguousarray(images[self.i - 1][:, :, ::-1])

    got = []
    orig = demo._postprocess

    def spy(image_rgb, dets, thresh):
        got.append(dets)
        return orig(image_rgb, dets, thresh)
    demo._postprocess = spy
    t0 = time.perf_counter()
    drawn = list(demo.run_on_video(Video(), 0.5))
    par_s = time.perf_counter() - t0
    demo.predictor.shutdown()
    if len(drawn) != len(images) or len(got) != len(images):
        raise AssertionError("phase 11c: the parallel demo lost frames")
    for i, (g, s) in enumerate(zip(got, single)):
        if not np.array_equal(np.asarray(g.valid), np.asarray(s.valid)) or \
                not np.allclose(np.asarray(g.scores), np.asarray(s.scores),
                                rtol=1e-5, atol=1e-6):
            raise AssertionError(f"phase 11c: parallel result {i} is not "
                                 f"frame {i}'s")

    # the multiclass NMS on one frame's LVIS cascade scores, threshold 0
    zs_l = torch.from_numpy(resolve_vocabulary("lvis")[0]).cuda()
    calls = []
    kernel_keep = nms.nms_keep

    def spy_keep(*args):
        keep = kernel_keep(*args)
        calls.append((args, keep))
        return keep
    # the op counts its launches on the module's `nms_keep`, the spy here
    spy_keep.launches = 0
    with torch.no_grad():
        image = torch.from_numpy(images[2]).cuda().float()
        feats = model.fpn(*model.backbone_raw(image), None)
        hms, regs = model.centernet(feats)
        props = decode_proposals(hms, regs, model.cfg.centernet)
        cascade = model.roi_heads.run_cascade(feats[:3], props, zs_l,
                                              (480, 640))
        scores = torch.sqrt(cascade.mean_scores *
                            props.scores[:, None].clamp(min=0.0))
        nms.nms_keep = spy_keep
        try:
            nms.multiclass_nms(cascade.final_boxes, scores, props.valid,
                               0.0, 0.5, 300)
        finally:
            nms.nms_keep = kernel_keep
    (args, keep), = calls
    plain = nms.nms_keep_plain(*args)
    classes, valid = args[1], args[2]
    if args[0].shape[0] != 2048 or not bool(valid.all()):
        raise AssertionError(f"phase 11c: {args[0].shape[0]} candidates, "
                             f"{int(valid.sum())} valid; expected the full "
                             f"2048 cap")
    if not torch.equal(keep, plain):
        raise AssertionError(f"phase 11c: the NMS kept set differs from "
                             f"the plain fixpoint's on "
                             f"{int((keep != plain).sum())} candidates")
    distinct = int(torch.unique(classes).numel())
    print(f"  multiclass NMS on LVIS cascade scores (threshold 0): 2048 "
          f"candidates of {distinct} classes, ids up to "
          f"{int(classes.max())} (the partition has {nms.CLASS_BINS} bins); "
          f"{int(keep.sum())} kept, equal to the plain fixpoint's")
    phase("11c", f"image-only demo at 480x640: detect with lvis (1203 "
                 f"classes) and coco, launches a frame {LAUNCHES_PER_IMAGE}; "
                 f"the parallel demo's 6 frames in order "
                 f"({par_s / 6 * 1e3:.1f} ms a frame); the NMS kept set "
                 f"equal to the plain fixpoint's over {distinct} classes")


EXPORT_LOADER = """
import json, sys, time
t0 = time.perf_counter()
import torch
from embodied_object_detection_tpu_torch import ops, serve
step = serve.load_frame_step(sys.argv[1])
loaded = time.perf_counter() - t0
args = torch.load(sys.argv[2])
out = step(*[a.cuda() for a in args])
torch.cuda.synchronize()
torch.save([o.cpu() for o in out], sys.argv[3])
bad = [m for m in sys.modules if m.startswith(
    "embodied_object_detection_tpu_torch.") and m.split(".")[1] not in
    ("ops", "serve", "kernels", "structures")]
print(json.dumps({"load_s": loaded, "modules": bad,
                  "launches": ops.segment_sum.segment_sum.launches}))
"""


def check_export(model, cfg, memory):
    """Phase 11d: export the full-width frame step, load it in a fresh
    process that imports only the port's `ops` and `serve` packages, and
    hold its outputs to eager `frame_step`'s on the same inputs."""
    from embodied_object_detection_tpu_torch.serve import export

    build_dir = REPO / "build"
    build_dir.mkdir(exist_ok=True)
    path = build_dir / "frame_step.pt2"
    t0 = time.perf_counter()
    export.save_frame_step(str(path), model, cfg)
    export_s = time.perf_counter() - t0
    h, w = cfg.input.height, cfg.input.width
    rng = np.random.RandomState(41)
    zs = rng.randn(512, cfg.roi.num_classes + 1).astype(np.float32)
    zs /= np.linalg.norm(zs, axis=0, keepdims=True)
    args = [torch.from_numpy(rng.randint(0, 255, (h, w, 3)).astype(
                np.float32)),
            torch.from_numpy(zs), memory.features.cpu(),
            memory.obs_count.cpu(),
            torch.from_numpy(coherent_proj(rng, h, w, cfg.memory.max_cells)),
            torch.zeros((h, w), dtype=torch.bool)]
    torch.save(args, build_dir / "frame_step_inputs.pt")
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-c", EXPORT_LOADER, str(path),
         str(build_dir / "frame_step_inputs.pt"),
         str(build_dir / "frame_step_outputs.pt")],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    proc_s = time.perf_counter() - t0
    if run.returncode:
        raise AssertionError(f"phase 11d: the loading process failed:\n"
                             f"{run.stderr[-3000:]}")
    info = json.loads(run.stdout.strip().splitlines()[-1])
    if info["modules"] or info["launches"] != 1:
        raise AssertionError(f"phase 11d: the loader imported {info}")
    got = torch.load(build_dir / "frame_step_outputs.pt")

    # eager, with the segment-sum's inputs and the write's features kept
    cuda = [a.cuda() for a in args]
    with WriteSpy() as spy:
        out = model.frame_step(*cuda)
    d = out.detections
    for name, g, e in zip(("boxes", "scores", "classes", "valid"), got[:4],
                          d):
        if not torch.equal(g, e.cpu()):
            raise AssertionError(f"phase 11d: exported {name} differ from "
                                 f"eager frame_step's")
    # the memory: the write's segment-sum adds in another order each run
    want_f = cuda[2] + out.write.features_update
    bound = spy.bound(want_f)
    err = (got[4].cuda() - want_f).abs()
    if not bool((err <= bound).all()):
        raise AssertionError(f"phase 11d: memory beyond the segment-sum's "
                             f"bound: {float((err - bound).max()):.3e}")
    if not torch.equal(got[5].cuda(), cuda[3] + out.write.obs_update):
        raise AssertionError("phase 11d: observation counts differ")
    size = path.stat().st_size
    phase("11d", f"frame step exported to build/frame_step.pt2 "
                 f"({size / 2**20:.0f} MiB) in {export_s:.1f} s; loaded in "
                 f"a fresh process importing only ops and serve in "
                 f"{info['load_s']:.1f} s ({proc_s:.1f} s with the run): "
                 f"detections equal to eager frame_step's, memory within "
                 f"the segment-sum's bound (max err {float(err.max()):.3e})")
    return export_s, info["load_s"]


# ---------------------------------------------------------- Deformable-DETR

# the encoder's levels at 480x640: C3-C5 and the stride-64 extra level
DETR_LEVELS = ((60, 80), (30, 40), (15, 20), (8, 10))
DETR_LAUNCHES = 12      # deformable attentions a forward: 6 encoder + 6 decoder
DETR_FRAMES = 24
DETR_STEPS = 3
DETR_VARIANTS = {"single_stage": {},
                 "two_stage_refine_zeroshot": dict(
                     use_zeroshot=True, with_box_refine=True,
                     two_stage=True)}
# sampling-offset and attention-weight kernels from normal(0, 0.1) (the JAX
# init zeroes them): samples spread ~2 level pixels from their references
DETR_ATTN_STD = 0.1


def msda_in_frames(trace_events, per_frame=DETR_LAUNCHES):
    """Kernel 8's device us a call in profiled DETR frames: (encoder,
    decoder), the first half of each frame's launches the encoder's."""
    calls = sorted((e["ts"], e["dur"]) for e in trace_events
                   if e.get("ph") == "X" and e.get("cat") == "kernel" and
                   "ms_deform_attn_fwd" in e["name"])
    enc = [d for i, (_, d) in enumerate(calls) if i % per_frame <
           per_frame // 2]
    dec = [d for i, (_, d) in enumerate(calls) if i % per_frame >=
           per_frame // 2]
    return float(np.mean(enc)), float(np.mean(dec))


def msda_arrays(rng, shapes, q, m, d, p, locality="random"):
    """Kernel 8's test inputs as f32 numpy arrays from `rng`: value
    [S, M, D], locations [Q, M, L, P, 2], attention weights softmaxed over
    (L, P), grad_out [Q, M * D]. The card tests and the CPU test of the
    lane map draw theirs here too. locality "random": locations uniform in
    [-0.1, 1.1] with each level's first point of every (query, head) on an
    edge case (a pixel centre, the first and last centres, 0 and 1, and
    -0.5 / size: a sample on the -1 row or column). "model": the
    Deformable-DETR's, each query's reference at every level plus offsets
    of normal(0, 2) level pixels (DETR_ATTN_STD's spread); at Q = S (the
    encoder) the reference is the query's own pixel centre at its level,
    normalised, else (the decoder) uniform in (0, 1)."""
    s = sum(h * w for h, w in shapes)
    nl = len(shapes)
    value = rng.randn(s, m, d).astype(np.float32)
    if locality == "model":
        if q == s:
            refs = np.concatenate([np.stack(
                [(np.arange(h * w) % w + 0.5) / w,
                 (np.arange(h * w) // w + 0.5) / h], -1) for h, w in shapes])
        else:
            refs = rng.uniform(0.0, 1.0, (q, 2))
        sizes = np.array([(w, h) for h, w in shapes], np.float64)
        locs = (refs[:, None, None, None, :] +
                rng.normal(0.0, 2.0, (q, m, nl, p, 2)) /
                sizes[None, None, :, None, :]).astype(np.float32)
    elif locality == "random":
        locs = rng.uniform(-0.1, 1.1, (q, m, nl, p, 2)).astype(np.float32)
        for lvl, (h, w) in enumerate(shapes):
            for axis, size in ((0, w), (1, h)):
                edge = np.array([(size // 2 + 0.5) / size, 0.5 / size,
                                 (size - 0.5) / size, 0.0, 1.0,
                                 -0.5 / size], np.float32)
                locs[:, :, lvl, 0, axis] = edge[rng.randint(0, 6, (q, m))]
    else:
        raise ValueError(f"locality must be 'random' or 'model', got "
                         f"{locality!r}")
    attn = rng.rand(q, m, nl, p).astype(np.float32)
    attn /= attn.sum(axis=(2, 3), keepdims=True)
    grad = rng.randn(q, m * d).astype(np.float32)
    return value, locs, attn, grad


def msda_inputs(rng, q, m=8, d=32, p=4, shapes=DETR_LEVELS,
                locality="random"):
    """`msda_arrays` on the card."""
    return [torch.from_numpy(a).cuda()
            for a in msda_arrays(rng, shapes, q, m, d, p, locality)]


def msda_corners(locs, shapes=DETR_LEVELS):
    """The corners inside their level over every (query, head, level,
    point), counted from the inputs: those the kernels' design loads."""
    n = 0
    for lvl, (h, w) in enumerate(shapes):
        x0 = torch.floor(locs[:, :, lvl, :, 0] * w - 0.5)
        y0 = torch.floor(locs[:, :, lvl, :, 1] * h - 0.5)
        for dy in (0, 1):
            for dx in (0, 1):
                n += int(((x0 + dx >= 0) & (x0 + dx < w) & (y0 + dy >= 0) &
                          (y0 + dy < h)).sum())
    return n


def rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def msda_check(value, locs, attn, grad, shapes=DETR_LEVELS):
    """The kernels against the plain version on the same inputs: (forward
    max abs err, its share of max |plain|, grad_loc and grad_attn errors
    as shares of the plain autograd's largest, grad_value's max err
    against the exact (f64) sum of its f32 contributions (g * a) * w and
    max err / bound, the bound contributions x 2^-24 x sum|contribution|
    that any summation order keeps, the plain autograd's grad_value's max
    err / bound against the same exact sum, the most contributions on one
    element). A miss raises."""
    from embodied_object_detection_tpu_torch.ops import ms_deform_attn as ma
    out = ma.ms_deform_attn_cuda(value, shapes, locs, attn)
    plain = ma.ms_deform_attn_plain(value, shapes, locs, attn)
    fwd = float((out - plain).abs().max())
    fwd_rel = rel_err(out, plain)
    gv, gl, ga = ma.ms_deform_attn_backward_cuda(grad, value, shapes, locs,
                                                 attn)
    leaves = [t.clone().requires_grad_() for t in (value, locs, attn)]
    (ma.ms_deform_attn_plain(leaves[0], shapes, leaves[1], leaves[2]) *
     grad).sum().backward()
    loc_rel = rel_err(gl, leaves[1].grad)
    attn_rel = rel_err(ga, leaves[2].grad)
    exact, bound, count = ma.ms_deform_attn_grad_value_exact(
        shapes, value, locs, attn, grad)
    err = (gv.double() - exact).abs()
    gv_err = float(err.max())
    ratio = float((err / bound.clamp(min=1e-300)).max())
    plain_err = (leaves[0].grad.double() - exact).abs()
    plain_ratio = float((plain_err / bound.clamp(min=1e-300)).max())
    if fwd_rel > 1e-5 or loc_rel > 1e-5 or attn_rel > 1e-5 or \
            not bool((err <= bound).all()) or \
            not bool((plain_err <= bound).all()):
        raise AssertionError(
            f"ms_deform_attn kernels vs plain: forward {fwd_rel:.3e}, "
            f"grad_loc {loc_rel:.3e}, grad_attn {attn_rel:.3e} (tolerance "
            f"1e-5 of the largest), grad_value max err / bound {ratio:.3f}, "
            f"the plain autograd's grad_value max err / bound "
            f"{plain_ratio:.3f}")
    return (fwd, fwd_rel, loc_rel, attn_rel, gv_err, ratio, plain_ratio,
            int(count.max()))


# phase 12's cases: (name, Q (None: S), M, D, P, locality, levels)
MSDA_CASES = (("encoder", None, 8, 32, 4, "random", 4),
              ("decoder", 100, 8, 32, 4, "random", 4),
              ("D % 4 != 0", 2000, 8, 6, 4, "random", 4),
              ("encoder, model locality", None, 8, 32, 4, "model", 4),
              ("decoder, model locality", 100, 8, 32, 4, "model", 4),
              ("odd L", 2000, 8, 32, 4, "random", 3))


def check_ms_deform_attn(rng):
    """Phase 12: both kernels against the plain version at the encoder's
    (Q = S) and the decoder's (Q = 100) full-width shapes, at D = 6 (rows
    without 16-byte alignment, a quad of 2 channels), on the model's
    locations and on 3 levels (an odd L: the forward's instantiation that
    takes one level at a time); the forward must equal the plain version
    bit for bit."""
    worst_fwd = worst_gv = 0.0
    # the cases after the first two from a generator of their own, so that
    # the later phases draw the same inputs as before them
    extra = np.random.RandomState(12)
    for i, (name, q, m, d, p, locality, nl) in enumerate(MSDA_CASES):
        shapes = DETR_LEVELS[:nl]
        s = sum(h * w for h, w in shapes)
        q = q or s
        fwd, fwd_rel, loc_rel, attn_rel, gv_err, ratio, plain_ratio, most = \
            msda_check(*msda_inputs(rng if i < 2 else extra, q, m, d, p,
                                    shapes, locality), shapes)
        worst_fwd, worst_gv = max(worst_fwd, fwd), max(worst_gv, gv_err)
        print(f"  {name} (Q = {q}, S = {s}, M = {m}, D = {d}, L = {nl}, "
              f"P = {p}, {locality} locations): forward max abs err "
              f"{fwd:.3e} ({fwd_rel:.2e} of max |plain|, bit-equal "
              f"required); grad_loc {loc_rel:.2e} and grad_attn "
              f"{attn_rel:.2e} of the plain autograd's largest (tolerance "
              f"1e-5); grad_value max err {gv_err:.3e} from the exact sum, "
              f"max err / bound {ratio:.3f} (up to {most} contributions on "
              f"one element), the plain autograd's grad_value max err / "
              f"bound {plain_ratio:.3f} from the same sum")
        if fwd != 0.0:
            raise AssertionError(f"phase 12 {name}: the forward differs from "
                                 f"the plain version by {fwd:.3e}")
    phase(12, "ms_deform_attn forward equal to the plain version bit for "
              "bit, its backward's grad_loc and grad_attn within 1e-5 of "
              "the plain autograd's largest, grad_value and the plain "
              "autograd's within contributions x 2^-24 x sum|contribution| "
              "of the exact sum, at the encoder's and the decoder's shapes "
              "on locations in [-0.1, 1.1] with pixel centres, borders and "
              "the -1 row and on the model's locations, at D = 6 and "
              "on 3 levels")
    return {"ms_deform_attn": worst_fwd, "ms_deform_attn_backward": worst_gv}


def detr_zs():
    import os
    from embodied_object_detection_tpu_torch.data.catalog import METADATA_DIR
    from embodied_object_detection_tpu_torch.demo.predictor import (
        load_zs_weight_npy)
    return torch.from_numpy(load_zs_weight_npy(
        os.path.join(METADATA_DIR, "mp3d_clip.npy")))


def run_detr_inference(profile_dir=None):
    """Phase 12b: the full-width detector and detr_inference, both
    variants; launches, host syncs, ms/frame, busy share, peak memory,
    and from 2 profiled frames the device time by op group and kernel 8's
    device time a call (encoder and decoder apart). With `profile_dir`,
    also each variant's device ops a frame into it. Returns the first
    variant's launches and {variant: its numbers}."""
    from embodied_object_detection_tpu_torch.config import DetectorConfig
    from embodied_object_detection_tpu_torch.models.deformable_detr import (
        build_deformable_detr, detr_inference)

    cfg = DetectorConfig()
    h, w = cfg.input.height, cfg.input.width
    rng = np.random.RandomState(50)
    images = torch.from_numpy(rng.randint(0, 255, (DETR_FRAMES, h, w, 3))
                              .astype(np.float32)).cuda()
    zs = detr_zs().cuda()
    first, summary, stats = None, [], {}
    for name, variant in DETR_VARIANTS.items():
        model = build_deformable_detr(cfg, seed=0, device="cuda",
                                      attn_init_std=DETR_ATTN_STD, **variant)
        z = zs if variant.get("use_zeroshot") else None

        def frames(n):
            with torch.no_grad():
                outs = []
                for i in range(n):
                    out = model(images[i], z)
                    outs.append((out, detr_inference(
                        out.logits[-1], out.boxes_cxcywh[-1], (h, w))))
                return outs

        syncs = sync_sites(lambda: frames(1))
        if syncs:
            for site, n in syncs.items():
                print(f"    {n} x {site}")
            raise AssertionError(f"phase 12b {name}: the frame synchronises "
                                 "with the host")
        torch.cuda.reset_peak_memory_stats()
        zero_counters()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs = frames(DETR_FRAMES)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / DETR_FRAMES * 1e3
        launches = read_counters()
        peak = torch.cuda.max_memory_allocated()
        expected = {k: DETR_LAUNCHES * DETR_FRAMES * (k == "ms_deform_attn")
                    for k in launches}
        if launches != expected:
            raise AssertionError(f"phase 12b {name}: launches {launches}, "
                                 f"expected {expected}")
        classes = cfg.roi.num_classes
        for out, dets in outs:
            enc = out.enc_logits
            ok = out.logits.shape == (6, 100, classes) and \
                dets.boxes.shape == (100, 4) and \
                all(bool(torch.isfinite(t).all()) for t in (
                    out.logits, out.boxes_cxcywh, dets.boxes, dets.scores)) \
                and bool((dets.scores[:-1] >= dets.scores[1:]).all()) and \
                (enc is None or (enc.shape == (sum(
                    a * b for a, b in DETR_LEVELS), classes) and
                    bool(torch.isfinite(enc).all())))
            if not ok:
                raise AssertionError(f"phase 12b {name}: bad outputs")
        events = profile_events(lambda: frames(2))
        ops, busy, span = device_busy(events)
        busy_ms = busy / 2e3
        split, top = device_op_split(events, 2)
        enc_us, dec_us = msda_in_frames(events)
        print(f"    device ms a frame by op group: " + ", ".join(
            f"{g} {v:.3f}" for g, v in split.items()) +
            f" (kernel 8 {split['kernel 8'] / sum(split.values()):.3f} of "
            f"the device time); kernel 8 in the frame {enc_us:.1f} us a "
            f"call (encoder), {dec_us:.1f} us (decoder)")
        for ms_op, calls, group, kernel in top[:12]:
            print(f"      {ms_op:.3f} ms, {calls:g} calls a frame, "
                  f"{group}: {kernel}")
        if profile_dir:
            out = Path(profile_dir)
            out.mkdir(parents=True, exist_ok=True)
            (out / f"detr_{name}_ops.txt").write_text("".join(
                f"{ms_op:.4f} ms\t{calls:g}\t{group}\t{kernel}\n"
                for ms_op, calls, group, kernel in top))
        stats[name] = {"ms_per_frame": ms, "busy_ms_per_frame": busy_ms,
                       "device_ops_per_frame": ops / 2, "split_ms": split,
                       "msda_us_encoder": enc_us, "msda_us_decoder": dec_us}
        dets = outs[-1][1]
        print(f"  {name}: {DETR_FRAMES} frames at {h}x{w}, {ms:.2f} ms/frame "
              f"(eager, host clock), 0 host syncs (sync debug mode 'error'), "
              f"launches {launches['ms_deform_attn']} "
              f"({DETR_LAUNCHES} a frame), peak {peak / 2 ** 30:.2f} GiB; "
              f"profiled 2 frames: {ops} device ops, device busy "
              f"{busy_ms:.2f} ms/frame, busy share {busy_ms / ms:.3f} of the "
              f"timed frame ({busy / span:.3f} of the profiled span, under "
              f"the profiler); last frame's top score "
              f"{float(dets.scores[0]):.4f}, class {int(dets.classes[0])}")
        summary.append(f"{name} {ms:.2f} ms/frame, device busy "
                       f"{busy_ms:.2f} ms/frame (busy share "
                       f"{busy_ms / ms:.3f}), peak {peak / 2 ** 30:.2f} GiB")
        first = first or launches
        del model
    phase("12b", f"Deformable-DETR inference at {h}x{w} (ResNet-50, hidden "
                 f"256, 6 + 6 layers, 100 queries, seeded weights): "
                 f"{'; '.join(summary)}; detr_inference to 100 detections, "
                 f"{DETR_LAUNCHES} deformable-attention launches a frame, "
                 "no host sync")
    return first, stats


def detr_gt(rng, h, w, g=8, valid=5):
    from embodied_object_detection_tpu_torch.structures import GroundTruth
    x1 = rng.uniform(0, w * 0.6, g)
    y1 = rng.uniform(0, h * 0.6, g)
    boxes = np.stack([x1, y1, x1 + rng.uniform(16, w * 0.4, g),
                      y1 + rng.uniform(16, h * 0.4, g)], -1)
    live = np.arange(g) < valid
    boxes[~live] = 0.0
    classes = np.where(live, rng.randint(0, 20, g), 0)
    return GroundTruth(torch.from_numpy(boxes.astype(np.float32)),
                       torch.from_numpy(classes.astype(np.int32)),
                       torch.from_numpy(live))


def run_detr_training():
    """Phase 12c: three full-width train steps of the two-stage, box-refine
    detector, each followed by a GroupedOptimizer step."""
    from embodied_object_detection_tpu_torch.config import DetectorConfig
    from embodied_object_detection_tpu_torch.engine.solver import (
        GroupedOptimizer)
    from embodied_object_detection_tpu_torch.models.deformable_detr import (
        build_deformable_detr, detr_train_step_host_matched)

    cfg = DetectorConfig()
    h, w = cfg.input.height, cfg.input.width
    model = build_deformable_detr(cfg, seed=1, device="cuda",
                                  attn_init_std=DETR_ATTN_STD,
                                  with_box_refine=True, two_stage=True)
    opt = GroupedOptimizer(model.named_parameters(), cfg.solver)
    rng = np.random.RandomState(51)
    images = torch.from_numpy(rng.randint(0, 255, (DETR_STEPS + 2, h, w, 3))
                              .astype(np.float32)).cuda()
    gts = [type(g)(*[t.cuda() for t in g])
           for g in (detr_gt(rng, h, w) for _ in range(DETR_STEPS + 2))]

    def step(i):
        (total, aux), grads = detr_train_step_host_matched(
            model, images[i], gts[i], (h, w))
        for n, p in model.named_parameters():
            p.grad = grads[n]
        opt.step()
        return total, aux, grads

    step(0)                                   # cuDNN's first calls
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    step_ms, totals = [], []
    for i in range(1, DETR_STEPS + 1):
        t0 = time.perf_counter()
        total, aux, grads = step(i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        bad = [k for k, v in aux.items() if not math.isfinite(float(v))]
        if bad or not math.isfinite(float(total)):
            raise AssertionError(f"phase 12c: non-finite losses {bad}")
        totals.append(float(total))
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated()
    expected = {k: DETR_LAUNCHES * DETR_STEPS * (
        k in ("ms_deform_attn", "ms_deform_attn_backward")) for k in launches}
    if launches != expected:
        raise AssertionError(f"phase 12c: launches {launches}, expected "
                             f"{expected}")
    norms = {n: float(grads[f"detr.{n}.weight"].abs().sum()) for n in (
        "enc_output", "encoder0.self_attn.sampling_offsets",
        "decoder5.cross_attn.sampling_offsets", "encoder0.self_attn.value_proj",
        "decoder0.cross_attn.value_proj")}
    if not all(v > 0 for v in norms.values()):
        raise AssertionError(f"phase 12c: zero gradients {norms}")
    syncs = sync_sites(lambda: step(DETR_STEPS + 1))
    n_sync = sum(syncs.values())
    for site, n in syncs.items():
        print(f"    {n} x {site}")
    # by design: the GT validity once, one cost matrix a decoder layer and
    # one for the encoder stage (the assignments go back in one pinned,
    # non-blocking copy)
    designed = 1 + 6 + 1
    if n_sync != designed:
        raise AssertionError(f"phase 12c: {n_sync} host syncs a step, "
                             f"designed {designed}")
    print(f"  {DETR_STEPS} steps at {h}x{w}: totals "
          f"{', '.join(f'{t:.3f}' for t in totals)}; ms/step (host clock, "
          f"step + optimizer to a synchronize) "
          f"{', '.join(f'{x:.1f}' for x in step_ms)}; peak "
          f"{peak / 2 ** 30:.2f} GiB; launches {launches['ms_deform_attn']} "
          f"forward + {launches['ms_deform_attn_backward']} backward; "
          f"|grad| sums {', '.join(f'{k} {v:.3e}' for k, v in norms.items())}")
    phase("12c", f"Deformable-DETR training at {h}x{w} (two-stage, box "
                 f"refine, 5 GT boxes): {DETR_STEPS} steps + AdamW, losses "
                 f"finite, {np.mean(step_ms):.1f} ms/step, peak "
                 f"{peak / 2 ** 30:.2f} GiB, {DETR_LAUNCHES} forward and "
                 f"{DETR_LAUNCHES} backward launches a step, {n_sync} host "
                 f"syncs a step (GT validity, 7 cost matrices), gradients on "
                 f"enc_output, sampling_offsets and value_proj")
    return launches


def check_detr_against_cpu():
    """Phase 12d: the detector at 64x96 with ResNet depths (1, 1, 1, 1)
    (the DETR at full width) on the card and on the CPU from the same
    seeded weights: DETROutputs of both variants, and one train step's
    losses and gradients (two-stage, box refine)."""
    from embodied_object_detection_tpu_torch.config import DetectorConfig
    from embodied_object_detection_tpu_torch.models.deformable_detr import (
        build_deformable_detr, detr_train_step_host_matched)

    cfg = DetectorConfig()
    cfg = cfg.replace(
        backbone=dataclasses.replace(cfg.backbone, depths=(1, 1, 1, 1)),
        input=dataclasses.replace(cfg.input, height=64, width=96))
    rng = np.random.RandomState(52)
    image = torch.from_numpy(rng.randint(0, 255, (64, 96, 3)).astype(
        np.float32))
    gt = detr_gt(rng, 64, 96, g=4, valid=3)
    zs = detr_zs()
    worst = {}
    for name, variant in DETR_VARIANTS.items():
        models = {dev: build_deformable_detr(cfg, seed=2, device=dev,
                                             attn_init_std=DETR_ATTN_STD,
                                             **variant)
                  for dev in ("cpu", "cuda")}
        z = zs if variant.get("use_zeroshot") else None
        with torch.no_grad():
            outs = {dev: m(image.to(dev), None if z is None else z.to(dev))
                    for dev, m in models.items()}
        for field, c, g in zip(outs["cpu"]._fields, outs["cpu"],
                               outs["cuda"]):
            if c is None:
                continue
            err = rel_err(g.cpu(), c)
            worst[f"{name} {field}"] = err
            if err > 1e-4:
                raise AssertionError(f"phase 12d {name} {field}: card vs "
                                     f"CPU {err:.3e} of the largest")
    # one train step of the last variant's weights, linear classifier
    variant = dict(with_box_refine=True, two_stage=True)
    res = {}
    for dev in ("cpu", "cuda"):
        model = build_deformable_detr(cfg, seed=3, device=dev,
                                      attn_init_std=DETR_ATTN_STD, **variant)
        (total, aux), grads = detr_train_step_host_matched(
            model, image.to(dev), type(gt)(*[t.to(dev) for t in gt]),
            (64, 96))
        res[dev] = ({k: float(v) for k, v in aux.items()},
                    {k: v.cpu() for k, v in grads.items()})
    (l_c, g_c), (l_g, g_g) = res["cpu"], res["cuda"]
    loss_rel = max(abs(l_g[k] - l_c[k]) / max(abs(l_c[k]), 1e-6) for k in l_c)
    if sorted(l_c) != sorted(l_g) or loss_rel > 1e-4:
        raise AssertionError(f"phase 12d: losses differ by {loss_rel:.3e}")
    noise = 1e-6 * max(float(v.abs().max()) for v in g_c.values())
    grad_ratio = 0.0
    for k, c in g_c.items():
        err = float((g_g[k] - c).abs().max())
        bound = 1e-3 * float(c.abs().max()) + noise
        grad_ratio = max(grad_ratio, err / bound)
        if err > bound:
            raise AssertionError(f"phase 12d: gradient of {k} differs by "
                                 f"{err:.3e} (bound {bound:.3e})")
    print(f"  forward, card vs CPU (share of each output's largest): "
          f"{', '.join(f'{k} {v:.2e}' for k, v in worst.items())}")
    phase("12d", f"Deformable-DETR at 64x96 (ResNet depths 1, DETR at full "
                 f"width), card vs CPU from the same weights: DETROutputs of "
                 f"both variants within {max(worst.values()):.2e} of each "
                 f"output's largest (tolerance 1e-4); one two-stage train "
                 f"step's {len(l_c)} losses within {loss_rel:.2e} (tolerance "
                 f"1e-4) and every gradient within its tolerance, 1e-3 of "
                 f"its largest plus 1e-6 of the step's largest gradient for "
                 f"gradients that are 0 in exact arithmetic (max err / "
                 f"tolerance {grad_ratio:.3f})")


def msda_yardstick(value, shapes, locs, attn):
    """The reference's ms_deform_attn_core_pytorch
    (functions/ms_deform_attn_func.py): one F.grid_sample a level
    (align_corners=False, zero padding), the weighted sum, the reshape."""
    import torch.nn.functional as F
    s, m, d = value.shape
    q, _, l, p, _ = locs.shape
    grids = 2 * locs - 1
    sampled, start = [], 0
    for lid, (h, w) in enumerate(shapes):
        v = value[start:start + h * w].permute(1, 2, 0).reshape(m, d, h, w)
        start += h * w
        sampled.append(F.grid_sample(v, grids[:, :, lid].transpose(0, 1),
                                     mode="bilinear", padding_mode="zeros",
                                     align_corners=False))  # [M, D, Q, P]
    a = attn.transpose(0, 1).reshape(m, 1, q, l * p)
    out = (torch.stack(sampled, -2).flatten(-2) * a).sum(-1)    # [M, D, Q]
    return out.permute(2, 0, 1).reshape(q, m * d)


# phase 7's timed cases of kernels 8 and 8b: (shape, Q (None: S), locality)
MSDA_TIMED = (("encoder", None, "random"), ("decoder", 100, "random"),
              ("encoder", None, "model"), ("decoder", 100, "model"))


def msda_timed_inputs(rng):
    """{(shape, locality): inputs} of phase 7's timed cases: the random
    locations from rng (as phase 7 has always drawn them), the model's
    from a generator of their own."""
    s = sum(h * w for h, w in DETR_LEVELS)
    own = np.random.RandomState(71)
    return {(name, loc): msda_inputs(rng if loc == "random" else own,
                                     q or s, locality=loc)
            for name, q, loc in MSDA_TIMED}


def msda_kernel_ms(ma, value, locs, attn, grad, shapes=DETR_LEVELS):
    """(forward ms, backward ms) a call of the kernels' wrappers, the
    backward's zero fill of grad_value included."""
    return (graph_ms(lambda: ma.ms_deform_attn_cuda(value, shapes, locs,
                                                    attn)),
            graph_ms(lambda: ma.ms_deform_attn_backward_cuda(
                grad, value, shapes, locs, attn)))


def time_ms_deform_attn(rng, launches, train_launches, errs):
    """Both kernels at the encoder's shape (the JSON entries) and the
    decoder's, on random and on the model's locations; on random ones
    beside the plain version and the reference's grid_sample composition
    (for the backward, torch.autograd.grad of each, captured in a CUDA
    graph as the kernels are). Bounds: bytes of value, locations and
    weights read once and the output written once (backward: value,
    locations, weights and grad_out read once, grad_value, grad_loc and
    grad_attn written once), against 10 (backward 26) f32 operations a
    (query, head, level, point, channel). Gathers: the corner bytes each
    kernel copied or loaded and the REDs the backward issued, counted by
    the kernels' lanes in their counting build
    (`ms_deform_attn_tally`), and their rates over the timed kernels'
    times; the counts must be those the inputs give the design (a corner
    inside its level: D x 4 bytes, ceil(D / 4) float4 REDs)."""
    from embodied_object_detection_tpu_torch.ops import ms_deform_attn as ma
    entries = []
    for (name, locality), inputs in msda_timed_inputs(rng).items():
        value, locs, attn, grad = inputs
        shapes = DETR_LEVELS
        q = locs.shape[0]
        m, d = value.shape[1:]
        samples = q * m * len(shapes) * locs.shape[3] * d
        ins = (value.numel() + locs.numel() + attn.numel()) * 4
        tally = ma.ms_deform_attn_tally(value, shapes, locs, attn, grad)
        corners = msda_corners(locs)
        design = {"forward_bytes": corners * d * 4,
                  "backward_bytes": corners * d * 4,
                  "backward_reds": corners * -(-d // 4)}
        if tally != design:
            raise AssertionError(f"phase 7 ms_deform_attn, {name}, "
                                 f"{locality}: the kernels issued {tally}, "
                                 f"the inputs give the design {design}")
        gathered, bwd_gathered = tally["forward_bytes"], \
            tally["backward_bytes"]
        reds = tally["backward_reds"]
        ms, bwd_ms = msda_kernel_ms(ma, value, locs, attn, grad)
        b_ms, b_by = bound_ms(ins + grad.numel() * 4, 10 * samples)
        bb_ms, bb_by = bound_ms(2 * ins + grad.numel() * 4, 26 * samples)
        line = (f"  ms_deform_attn, {name} (Q = {q}), {locality} locations "
                f"(counted by the counting build, equal to the {corners} "
                f"corners inside their level): forward gathered "
                f"{gathered / 1e6:.1f} MB, backward {bwd_gathered / 1e6:.1f} "
                f"MB and {reds / 1e6:.2f} M float4 REDs; forward "
                f"{ms * 1e3:.1f} us kernel ({gathered / ms / 1e9:.2f} TB/s "
                f"of gathers), bound {b_ms * 1e3:.2f} us ({b_by}); backward "
                f"{bwd_ms * 1e3:.1f} us kernel "
                f"({bwd_gathered / bwd_ms / 1e9:.2f} TB/s, "
                f"{reds / bwd_ms / 1e6:.1f} G REDs/s), bound "
                f"{bb_ms * 1e3:.2f} us ({bb_by})")
        if locality != "random":
            print(line)
            continue
        plain_ms = graph_ms(lambda: ma.ms_deform_attn_plain(
            value, shapes, locs, attn))
        lib_ms = graph_ms(lambda: msda_yardstick(value, shapes, locs, attn))
        lib_gap = rel_err(msda_yardstick(value, shapes, locs, attn),
                          ma.ms_deform_attn_cuda(value, shapes, locs, attn))
        leaves = [t.clone().requires_grad_() for t in (value, locs, attn)]
        bwd_plain_ms = graph_ms(lambda: torch.autograd.grad(
            ma.ms_deform_attn_plain(leaves[0], shapes, leaves[1], leaves[2]),
            leaves, grad))
        bwd_lib_ms = graph_ms(lambda: torch.autograd.grad(
            msda_yardstick(leaves[0], shapes, leaves[1], leaves[2]), leaves,
            grad))
        print(f"{line}; forward {plain_ms * 1e3:.1f} us plain, "
              f"{lib_ms * 1e3:.1f} us grid_sample composition ({lib_gap:.1e} "
              f"from the kernel); backward {bwd_plain_ms * 1e3:.1f} us plain "
              f"autograd, {bwd_lib_ms * 1e3:.1f} us grid_sample "
              f"composition's autograd")
        if name == "encoder":
            src = "embodied_object_detection_tpu_torch/csrc/ms_deform_attn.cu"
            ref = "embodied_object_detection_tpu/ops/ms_deform_attn.py:35"
            entries = [
                {"name": "ms_deform_attn", "route": "cuda", "source": src,
                 "replaces": ref, "launches": launches["ms_deform_attn"],
                 "max_abs_err": errs["ms_deform_attn"], "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": lib_ms, "gathered_bytes": gathered,
                 "gather_tb_s": gathered / ms / 1e9},
                {"name": "ms_deform_attn_backward", "route": "cuda",
                 "source": src, "replaces": ref,
                 "launches": train_launches["ms_deform_attn_backward"],
                 "max_abs_err": errs["ms_deform_attn_backward"],
                 "ms": bwd_ms, "plain_ms": bwd_plain_ms, "bound_ms": bb_ms,
                 "bound_by": bb_by, "library_ms": bwd_lib_ms,
                 "gathered_bytes": bwd_gathered,
                 "gather_tb_s": bwd_gathered / bwd_ms / 1e9, "reds": reds}]
    return entries


# ------------------------------------------------------------ slice 11

# the five CenterNet levels of a 480 x 640 frame (strides 8 to 128, the
# FPN's p3-p7) at 256 channels, where the reference's CenterNet tower runs
# DFConv2d
DCN_LEVELS = ((60, 80), (30, 40), (15, 20), (8, 10), (4, 5))
DCN_CHANNELS = 256
# the offsets' std on a unit-variance input: samples cross every border
DCN_OFFSET_STD = 2.0
READ_BATCH = TRAIN_FRAMES


def dcn_blocks(device="cuda", channels=DCN_CHANNELS):
    """{modulated: DeformConvBlock(channels, channels, 3) with bias} from
    a seed. The offset conv's weights are drawn so that the offsets and
    mask logits of a unit-variance input have a std of ~DCN_OFFSET_STD:
    its zero init would only test a plain conv."""
    from embodied_object_detection_tpu_torch.ops.deform_conv import (
        DeformConvBlock)
    blocks = {}
    for modulated in (True, False):
        gen = torch.Generator().manual_seed(1300 + modulated)
        block = DeformConvBlock(channels, channels, 3,
                                with_modulated_dcn=modulated, use_bias=True,
                                generator=gen)
        with torch.no_grad():
            block.offset.weight.normal_(
                0.0, DCN_OFFSET_STD / (9 * channels) ** 0.5, generator=gen)
            block.offset.bias.normal_(0.0, 0.5, generator=gen)
            block.bias.normal_(0.0, 0.1, generator=gen)
        blocks[modulated] = block.to(device)
    return blocks


def dcn_level_inputs(rng, device="cuda", levels=DCN_LEVELS,
                     channels=DCN_CHANNELS):
    """(x [H, W, C], grad_out [H, W, C]) of every level."""
    return [tuple(torch.from_numpy(rng.randn(h, w, channels).astype(
        np.float32)).to(device) for _ in range(2)) for h, w in levels]


def dcn_offsets(block, x):
    """The block's offsets and mask (None unmodulated) on x, as its
    forward makes them, without autograd."""
    import torch.nn.functional as F
    from embodied_object_detection_tpu_torch.ops import deform_conv as dc
    with torch.no_grad(), dc._no_tf32():
        raw = F.conv2d(x.permute(2, 0, 1)[None], block.offset.weight,
                       block.offset.bias, block.stride, block.padding,
                       block.dilation)[0].permute(1, 2, 0)
    k2 = 2 * block.kernel_size ** 2
    if not block.with_modulated_dcn:
        return raw.contiguous(), None
    return raw[..., :k2].contiguous(), torch.sigmoid(raw[..., k2:]).contiguous()


def run_dcn_path(blocks, inputs):
    """Phase 13's main path: each level through `DeformConvBlock`, forward
    and backward (`torch.autograd.grad` of its input and every parameter),
    modulated and not; launches counted (zeroed just before, read just
    after). Returns the launches."""
    zero_counters()
    t0 = time.perf_counter()
    for modulated, block in blocks.items():
        params = list(block.parameters())
        for x, grad_out in inputs:
            leaf = x.clone().requires_grad_()
            out = block(leaf)
            grads = torch.autograd.grad(out, [leaf] + params, grad_out)
            if not all(bool(torch.isfinite(t).all())
                       for t in (out,) + grads):
                raise AssertionError(f"phase 13: a non-finite output or "
                                     f"gradient at {tuple(x.shape)}")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = read_counters()
    calls = len(blocks) * len(inputs)
    for name in kernel_counters():
        want = calls if name in ("deform_im2col",
                                 "deform_im2col_backward") else 0
        if launches[name] != want:
            raise AssertionError(f"phase 13: {name} launched "
                                 f"{launches[name]} times, expected {want}")
    print(f"  {calls} DeformConvBlock forward + backward calls (5 levels, "
          f"modulated and not) in {ms:.1f} ms (host clock, first calls "
          f"included); launches {launches['deform_im2col']} forward, "
          f"{launches['deform_im2col_backward']} backward")
    return launches


def dcn_check(block, x, grad_out):
    """One level's kernels against the plain version on the block's own
    offsets and mask: (columns max abs err, unequal column elements (a
    miss unless 0), op output share, grad_offset and grad_mask
    shares of the plain autograd's largest, grad_x max err from the exact
    (f64) sum and max err / bound, the plain autograd's grad_x max err /
    bound, weight and bias gradient shares). A miss raises."""
    from embodied_object_detection_tpu_torch.ops import deform_conv as dc
    off, mask = dcn_offsets(block, x)
    w = block.weight.detach()
    b = block.bias.detach()
    kh = kw = block.kernel_size
    geo = (block.stride, block.padding, block.dilation)
    cols = dc.deform_im2col_cuda(x, off, mask, kh, kw, *geo)
    plain = dc.deform_im2col_plain(x, off, mask, kh, kw, *geo)
    col_err = float((cols - plain).abs().max())
    unequal = int((cols != plain).sum())
    with torch.no_grad():
        op_rel = rel_err(dc.modulated_deform_conv(x, off, mask, w, b, *geo),
                         dc.modulated_deform_conv_plain(x, off, mask, w, b,
                                                        *geo))
    # the backward through the op (DeformConvFunction) against the plain
    # version's autograd
    live = [x, off] + ([mask] if mask is not None else []) + [w, b]
    leaves = [t.clone().requires_grad_() for t in live]
    lm = leaves[2] if mask is not None else None
    args = (leaves[0], leaves[1], lm, leaves[-2], leaves[-1])
    got = torch.autograd.grad(dc.DeformConvFunction.apply(*args, *geo),
                              leaves, grad_out)
    want = torch.autograd.grad(dc.modulated_deform_conv_plain(*args, *geo),
                               leaves, grad_out)
    off_rel = rel_err(got[1], want[1])
    mask_rel = rel_err(got[2], want[2]) if mask is not None else 0.0
    w_rel, b_rel = rel_err(got[-2], want[-2]), rel_err(got[-1], want[-1])
    gcols = dcn_grad_columns(block, grad_out)
    exact, bound, count = dc.deform_conv_grad_x_exact(x, off, mask, gcols,
                                                      kh, kw, *geo)
    err = (got[0].double() - exact).abs()
    gx_err = float(err.max())
    ratio = float((err / bound.clamp(min=1e-300)).max())
    plain_err = (want[0].double() - exact).abs()
    plain_ratio = float((plain_err / bound.clamp(min=1e-300)).max())
    if unequal or op_rel > 1e-6 or off_rel > 1e-5 or \
            mask_rel > 1e-5 or w_rel > 1e-5 or b_rel > 1e-5 or \
            not bool((err <= bound).all()) or \
            not bool((plain_err <= bound).all()):
        raise AssertionError(
            f"deform_conv kernels vs plain at {tuple(x.shape)}: columns "
            f"{unequal} unequal elements (tolerance 0), output {op_rel:.3e} "
            f"(tolerance 1e-6 of the largest), grad_offset {off_rel:.3e}, "
            f"grad_mask {mask_rel:.3e}, "
            f"grad_weight {w_rel:.3e}, grad_bias {b_rel:.3e} (tolerance "
            f"1e-5), grad_x max err / bound {ratio:.3f}, the plain "
            f"autograd's {plain_ratio:.3f}")
    return (col_err, unequal, op_rel, off_rel, mask_rel, gx_err,
            ratio, plain_ratio, w_rel, b_rel, int(count.max()))


def dcn_grad_columns(block, grad_out):
    """The columns' gradient of the block's op for grad_out, as its
    backward computes it (grad_out @ weight^T in f32)."""
    from embodied_object_detection_tpu_torch.ops import deform_conv as dc
    w = block.weight.detach()
    return dc._matmul_f32(grad_out.reshape(-1, w.shape[-1]),
                          w.reshape(-1, w.shape[-1]).t()).contiguous()


def dcn_counts(block, x, grad_out):
    """(what the backward kernel issued at one level, from its counting
    build (`deform_im2col_backward_tally`), and what its design issues on
    these inputs (`deform_im2col_backward_design`)); they must be equal.
    The columns' gradient is the op's, aligned, so float4 lanes."""
    from embodied_object_detection_tpu_torch.ops import deform_conv as dc
    off, mask = dcn_offsets(block, x)
    kh = kw = block.kernel_size
    geo = (block.stride, block.padding, block.dilation)
    gcols = dcn_grad_columns(block, grad_out)
    tally = dc.deform_im2col_backward_tally(x, off, mask, gcols, kh, kw,
                                            *geo)
    design = dc.deform_im2col_backward_design(x, off, kh, kw, *geo,
                                              quads=x.shape[-1] % 4 == 0)
    if tally != design:
        raise AssertionError(f"phase 13: at {tuple(x.shape)} the backward "
                             f"kernel issued {tally}, its design {design}")
    return tally, design


def dcn_level_ms(block, x, grad_out):
    """(the im2col kernel's ms, the backward kernel's ms on the columns'
    gradient) at one level on the block's own offsets and mask, each in a
    CUDA graph."""
    from embodied_object_detection_tpu_torch.ops import deform_conv as dc
    off, mask = dcn_offsets(block, x)
    kh = kw = block.kernel_size
    geo = (block.stride, block.padding, block.dilation)
    gcols = dcn_grad_columns(block, grad_out)
    return (graph_ms(lambda: dc.deform_im2col_cuda(x, off, mask, kh, kw,
                                                   *geo)),
            graph_ms(lambda: dc.deform_im2col_backward_cuda(
                gcols, x, off, mask, kh, kw, *geo)))


def check_deform_conv(blocks, inputs):
    """Phase 13: the main path through the blocks, then both kernels
    against the plain version at every level, modulated and not, and
    their times there."""
    launches = run_dcn_path(blocks, inputs)
    worst_cols = worst_gx = 0.0
    for modulated, block in blocks.items():
        for x, grad_out in inputs:
            (col_err, unequal, op_rel, off_rel, mask_rel, gx_err, ratio,
             plain_ratio, w_rel, b_rel, most) = dcn_check(
                 block, x, grad_out)
            worst_cols, worst_gx = max(worst_cols, col_err), max(worst_gx,
                                                                 gx_err)
            col_ms, bwd_ms = dcn_level_ms(block, x, grad_out)
            tally, design = dcn_counts(block, x, grad_out)
            print(f"  {'modulated' if modulated else 'unmodulated'} "
                  f"{tuple(x.shape)}: im2col kernel {col_ms * 1e3:.1f} us, "
                  f"backward kernel {bwd_ms * 1e3:.1f} us, "
                  f"{tally['reds']} float4 REDs counted (design "
                  f"{design['reds']}), {tally['grad_columns_bytes'] / 1e6:.2f}"
                  f" MB of grad_columns and "
                  f"{tally['corner_bytes'] / 1e6:.1f} MB of corner rows "
                  f"loaded; columns max err "
                  f"{col_err:.3e} "
                  f"({unequal} unequal elements), output {op_rel:.2e} of "
                  f"the plain version's largest; grad_offset {off_rel:.2e}, "
                  f"grad_mask {mask_rel:.2e}, grad_weight {w_rel:.2e}, "
                  f"grad_bias {b_rel:.2e} of the plain autograd's largest; "
                  f"grad_x max err {gx_err:.3e} from the exact sum, max err "
                  f"/ bound {ratio:.3f} (up to {most} contributions on one "
                  f"pixel), the plain autograd's {plain_ratio:.3f}")
    phase(13, "deform_conv: DeformConvBlock(256, 3) forward and backward on "
              "the five CenterNet levels of a 480x640 frame (60x80 to 4x5), "
              "modulated and not, offsets of std ~2; the im2col kernel's "
              "columns equal to the plain version's, the op within 1e-6 "
              "of the plain version's largest, "
              "grad_offset, grad_mask, grad_weight and grad_bias within "
              "1e-5 of the plain autograd's largest, grad_x and the plain "
              "autograd's within contributions x 2^-24 x sum|contribution| "
              "of the exact sum; the backward's REDs and loaded bytes, "
              "counted by its counting build, equal to its design's (one "
              "float4 RED a valid corner and 4 channels)")
    return launches, {"deform_im2col": worst_cols,
                      "deform_im2col_backward": worst_gx}


def read_backward_cases(rng, device="cuda", cells=8192, d=512, h=480,
                        w=640, batch=READ_BATCH):
    """(name, features, obs, proj, grad_out) at the main path's shapes:
    the eval frame's read on random and on coherent ids (16 x 16-pixel
    squares share a cell), and the train step's batched read at B = 4."""
    cases = []
    for name, b in (("random ids", None), ("coherent ids", None),
                    (f"batched, B = {batch}", batch)):
        n = b or 1
        feats = (rng.randn(n, cells, d) * 4).astype(np.float32)
        obs = rng.choice([0.0, 1.0, 2.0, 5.0], (n, cells)).astype(np.float32)
        if name == "coherent ids":
            proj = coherent_proj(rng, h, w, cells)[None]
        else:
            proj = rng.randint(0, cells, (n, h, w))
        grad = rng.randn(n, h // 4, w // 4, d).astype(np.float32)
        arrays = [feats, obs, proj.astype(np.int32), grad]
        if b is None:
            arrays = [a[0] for a in arrays]
        cases.append((name,) + tuple(torch.from_numpy(np.ascontiguousarray(
            a)).to(device) for a in arrays))
    return cases


def check_read_backward(cases):
    """Phase 13b: `torch.autograd.grad` of the memory read in `features`
    (the single read on random and coherent ids, the batched read), with
    launches counted; then each gradient bit-equal to the window-order
    sum and to a second call, and against the exact (f64) sum:
    the kernel's within the bound of its own arithmetic (an f32 sum
    rounded once to bf16), the plain autograd's (a bf16 sum, as JAX's)
    within the bf16-accumulation bound."""
    from embodied_object_detection_tpu_torch.ops import memory_ops as mo
    zero_counters()
    grads = []
    for name, feats, obs, proj, grad in cases:
        leaf = feats.clone().requires_grad_()
        read = mo.memory_read_batched if feats.dim() == 3 else mo.memory_read
        grads.append(torch.autograd.grad(read(leaf, obs, proj), leaf,
                                         grad)[0])
    torch.cuda.synchronize()
    launches = read_counters()
    for name in kernel_counters():
        want = len(cases) if name == "memory_read_backward" else (
            sum(c[1].dim() == 2 for c in cases) if name == "memory_read"
            else sum(c[1].dim() == 3 for c in cases)
            if name == "memory_read_batched" else 0)
        if launches[name] != want:
            raise AssertionError(f"phase 13b: {name} launched "
                                 f"{launches[name]} times, expected {want}")
    worst = 0.0
    for (name, feats, obs, proj, grad), got in zip(cases, grads):
        ordered = mo.memory_read_grad_window_order(grad, obs, proj)
        again = mo.memory_read_backward_cuda(grad, obs, proj)
        if not torch.equal(got, ordered) or not torch.equal(got, again):
            raise AssertionError(
                f"phase 13b {name}: {int((got != ordered).sum())} elements "
                f"differ from the window-order sum, "
                f"{int((got != again).sum())} from a second call "
                f"(tolerance 0)")
        exact, bound, tight, count = mo.memory_read_grad_exact(grad, obs,
                                                               proj)
        err = (got.double() - exact).abs()
        ratio = float((err / tight.clamp(min=1e-300)).max())
        plain = mo.memory_read_backward_plain(grad, feats, obs, proj)
        plain_err = (plain.double() - exact).abs()
        plain_ratio = float((plain_err / bound.clamp(min=1e-300)).max())
        worst = max(worst, float(err.max()))
        print(f"  {name}: equal to the window-order sum and to a second "
              f"call; max err {float(err.max()):.3e} from the exact "
              f"sum, max err / its f32-sum bound {ratio:.3f} (up to "
              f"{int(count.max())} contributions on one row); the plain "
              f"autograd's max err / the bf16-sum bound {plain_ratio:.3f}; "
              f"{int((got != plain).sum())} of {got.numel()} elements "
              f"differ from the plain autograd")
        if ratio > 1 or plain_ratio > 1:
            raise AssertionError(f"phase 13b {name}: max err / bound "
                                 f"{ratio:.3f}, plain {plain_ratio:.3f}")
    phase("13b", "the memory read's gradient in features at 8192 x 512 and "
                 "480x640 ids (random, coherent) and the batched read at "
                 f"B = {READ_BATCH}: the kernel equal to the window-order "
                 "sum and to a second call; against the exact sum s of the n "
                 "bf16(g / 16) contributions c: the kernel within "
                 "((2^-8 + 2^-23)|s| + (1 + 2^-7) n 2^-24 sum|c|) / "
                 "denominator (an f32 sum rounded once to bf16), the plain "
                 "autograd within n 2^-8 sum|c| / denominator (a bf16 sum)")
    return launches, {"memory_read_backward": worst}


def dcn_yardstick_columns(x, off, mask, kh=3, kw=3, stride=1, padding=1,
                          dilation=1):
    """The deformable columns [Ho * Wo, K * Cin] as one F.grid_sample over
    every (pixel, tap) sample (align_corners=True puts pixel centres on
    integers, zero padding outside), times the mask. Timed only: the port
    never calls it."""
    import torch.nn.functional as F
    h, w, cin = x.shape
    ho, wo = off.shape[:2]
    dev = x.device
    k = kh * kw
    i = torch.arange(ho, device=dev)[:, None, None]
    j = torch.arange(wo, device=dev)[None, :, None]
    a = torch.arange(k, device=dev) // kw
    b = torch.arange(k, device=dev) % kw
    o = off.reshape(ho, wo, k, 2)
    sy = (i * stride - padding + a * dilation).float() + o[..., 0]
    sx = (j * stride - padding + b * dilation).float() + o[..., 1]
    grid = torch.stack([2 * sx / max(w - 1, 1) - 1,
                        2 * sy / max(h - 1, 1) - 1], -1)
    v = F.grid_sample(x.permute(2, 0, 1)[None], grid.reshape(1, ho, wo * k, 2),
                      mode="bilinear", padding_mode="zeros",
                      align_corners=True)[0]                # [C, Ho, Wo*K]
    v = v.reshape(cin, ho * wo, k).permute(1, 2, 0)         # [P, K, C]
    if mask is not None:
        v = v * mask.reshape(ho * wo, k, 1)
    return v.reshape(ho * wo, k * cin)


def dcn_yardstick(x, off, mask, weight, bias, stride=1, padding=1,
                  dilation=1):
    """The deformable convolution as `dcn_yardstick_columns`, then the
    same f32 matmul as the port. Timed only."""
    from embodied_object_detection_tpu_torch.ops import deform_conv as dc
    kh, kw, cin, cout = weight.shape
    ho, wo = off.shape[:2]
    cols = dcn_yardstick_columns(x, off, mask, kh, kw, stride, padding,
                                 dilation)
    out = dc._matmul_f32(cols, weight.reshape(kh * kw * cin, cout)) + bias
    return out.reshape(ho, wo, cout)


def time_deform_conv(blocks, inputs, launches, errs):
    """Rows 9 and 9b at the largest level (60 x 80 x 256, modulated), all
    in CUDA graphs. The JSON entries are the kernels alone: the im2col
    kernel beside `deform_im2col_plain` and the grid_sample columns
    (`dcn_yardstick_columns`); the backward kernel on the columns'
    gradient beside the autograd of each of those in x, offset and mask.
    Each entry's `op` is the op as the port runs it (forward: the kernel
    and the f32 matmul; backward: the two matmuls, the bias sum and the
    kernel) beside the plain version (its autograd) and the grid_sample
    composition with the same matmul (its autograd). Bounds: every input
    read and every output written once over 3.35 TB/s, against the f32
    operations (the matmuls' 2 x P x K x Cin x Cout a product, ~10 a
    column element for the sampling forward, ~26 backward) over 67
    TFLOP/s."""
    from embodied_object_detection_tpu_torch.ops import deform_conv as dc
    block = blocks[True]
    x, grad_out = inputs[0]
    off, mask = dcn_offsets(block, x)
    w, b = block.weight.detach(), block.bias.detach()
    h, wd, cin = x.shape
    cout = w.shape[-1]
    p, k = h * wd, 9
    geo = (1, 1, 1)
    sampled = (x.numel() + off.numel() + mask.numel()) * 4
    col_bytes = p * k * cin * 4

    # the forward kernel alone, then the op
    col_ms = graph_ms(lambda: dc.deform_im2col_cuda(x, off, mask, 3, 3,
                                                    *geo))
    col_plain_ms = graph_ms(lambda: dc.deform_im2col_plain(x, off, mask, 3,
                                                           3, *geo))
    col_lib_ms = graph_ms(lambda: dcn_yardstick_columns(x, off, mask, 3, 3,
                                                        *geo))
    col_b_ms, col_b_by = bound_ms(sampled + col_bytes, 10 * p * k * cin)

    def op():
        with torch.no_grad():
            return dc.modulated_deform_conv(x, off, mask, w, b, *geo)

    ms = graph_ms(op)
    plain_ms = graph_ms(lambda: dc.modulated_deform_conv_plain(
        x, off, mask, w, b, *geo))
    with torch.no_grad():
        lib_ms = graph_ms(lambda: dcn_yardstick(x, off, mask, w, b))
        lib_gap = rel_err(dcn_yardstick(x, off, mask, w, b), op())
    ins = sampled + (w.numel() + b.numel()) * 4
    mm = 2 * p * k * cin * cout
    b_ms, b_by = bound_ms(ins + p * cout * 4, mm + 10 * p * k * cin)

    # the backward kernel alone on the columns' gradient, then the op
    cols = dc.deform_im2col_cuda(x, off, mask, 3, 3, *geo)
    g2 = grad_out.reshape(p, cout)
    w2 = w.reshape(k * cin, cout)
    gcols = dc._matmul_f32(g2, w2.t()).contiguous()
    gx_ms = graph_ms(lambda: dc.deform_im2col_backward_cuda(
        gcols, x, off, mask, 3, 3, *geo))
    sl = [t.clone().requires_grad_() for t in (x, off, mask)]
    gx_plain_ms = graph_ms(lambda: torch.autograd.grad(
        dc.deform_im2col_plain(*sl, 3, 3, *geo), sl, gcols))
    gx_lib_ms = graph_ms(lambda: torch.autograd.grad(
        dcn_yardstick_columns(*sl, 3, 3, *geo), sl, gcols))
    gx_b_ms, gx_b_by = bound_ms(2 * sampled + col_bytes, 26 * p * k * cin)

    def backward():
        dc._matmul_f32(cols.t(), g2)
        g2.sum(0)
        gc = dc._matmul_f32(g2, w2.t()).contiguous()
        return dc.deform_im2col_backward_cuda(gc, x, off, mask, 3, 3, *geo)

    bwd_ms = graph_ms(backward)
    leaves = [t.clone().requires_grad_() for t in (x, off, mask, w, b)]
    bwd_plain_ms = graph_ms(lambda: torch.autograd.grad(
        dc.modulated_deform_conv_plain(*leaves, *geo), leaves, grad_out))
    bwd_lib_ms = graph_ms(lambda: torch.autograd.grad(
        dcn_yardstick(*leaves), leaves, grad_out))
    bb_ms, bb_by = bound_ms(ins + (p * cout + p * k * cin) * 4 + ins,
                            2 * mm + 26 * p * k * cin)
    print(f"  deform_conv at {tuple(x.shape)}, modulated: im2col kernel "
          f"{col_ms * 1e3:.1f} us, {col_plain_ms * 1e3:.1f} us plain, "
          f"{col_lib_ms * 1e3:.1f} us grid_sample columns, bound "
          f"{col_b_ms * 1e3:.2f} us ({col_b_by}); backward kernel "
          f"{gx_ms * 1e3:.1f} us, {gx_plain_ms * 1e3:.1f} us plain "
          f"autograd, {gx_lib_ms * 1e3:.1f} us grid_sample columns' "
          f"autograd, bound {gx_b_ms * 1e3:.2f} us ({gx_b_by})")
    print(f"  the op with its matmuls: forward {ms * 1e3:.1f} us, "
          f"{plain_ms * 1e3:.1f} us plain, {lib_ms * 1e3:.1f} us "
          f"grid_sample composition ({lib_gap:.1e} from the kernel), bound "
          f"{b_ms * 1e3:.2f} us ({b_by}); backward {bwd_ms * 1e3:.1f} us, "
          f"{bwd_plain_ms * 1e3:.1f} us plain autograd, "
          f"{bwd_lib_ms * 1e3:.1f} us composition's autograd, bound "
          f"{bb_ms * 1e3:.2f} us ({bb_by})")
    src = "embodied_object_detection_tpu_torch/csrc/deform_conv.cu"
    ref = "embodied_object_detection_tpu/ops/deform_conv.py:59"
    return [{"name": "deform_im2col", "route": "cuda", "source": src,
             "replaces": ref, "launches": launches["deform_im2col"],
             "max_abs_err": errs["deform_im2col"], "ms": col_ms,
             "plain_ms": col_plain_ms, "bound_ms": col_b_ms,
             "bound_by": col_b_by, "library_ms": col_lib_ms,
             "op": {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": lib_ms}},
            {"name": "deform_im2col_backward", "route": "cuda", "source": src,
             "replaces": ref, "launches": launches["deform_im2col_backward"],
             "max_abs_err": errs["deform_im2col_backward"], "ms": gx_ms,
             "plain_ms": gx_plain_ms, "bound_ms": gx_b_ms,
             "bound_by": gx_b_by, "library_ms": gx_lib_ms,
             "op": {"ms": bwd_ms, "plain_ms": bwd_plain_ms,
                    "bound_ms": bb_ms, "bound_by": bb_by,
                    "library_ms": bwd_lib_ms}}]


def time_read_backward(cases, launches, errs):
    """Row 2b: the read's transpose on each phase 13b case (the JSON entry:
    random ids) in a CUDA graph, beside the plain autograd and the
    autograd of row 2's F.embedding_bag(mean) yardstick over the prepared
    f32 table, both from CUDA events around 20 eager calls (their sorts
    may wait for the host, so they are not captured). Bound:
    grad_out, proj and obs read once and the gradient written once, over
    3.35 TB/s, against one f32 add per distinct (window, row) and channel
    of these ids, plus the rounding and division of each gradient element
    (bytes or operations, the larger)."""
    import torch.nn.functional as F
    from embodied_object_detection_tpu_torch.ops import memory_ops as mo
    entry = None
    for name, feats, obs, proj, grad in cases:
        ms = graph_ms(lambda: mo.memory_read_backward_cuda(grad, obs, proj))
        plain_ms = event_ms(
            lambda: mo.memory_read_backward_plain(grad, feats, obs, proj))
        b = feats.shape[0] if feats.dim() == 3 else 1
        cells, d = feats.shape[-2:]
        h, w = proj.shape[-2:]
        table = mo.normalize_memory(feats.reshape(-1, d), obs.reshape(-1)).to(
            torch.bfloat16).float().requires_grad_()
        idx = (proj.reshape(b, h, w).long() + (torch.arange(
            b, device=proj.device) * cells)[:, None, None]).reshape(
                b, h // 4, 4, w // 4, 4).permute(0, 1, 3, 2, 4).reshape(
                    -1, 16).contiguous()
        g2 = grad.reshape(-1, d)
        lib_ms = event_ms(lambda: torch.autograd.grad(
            F.embedding_bag(idx, table, mode="mean"), table, g2))
        distinct = int((torch.sort(idx, 1).values.diff(dim=1) != 0).sum()) \
            + idx.shape[0]
        rows = b * cells
        b_ms, b_by = bound_ms((grad.numel() + proj.numel() + obs.numel() +
                               rows * d) * 4, distinct * d + 2 * rows * d)
        print(f"  memory_read_backward, {name} ({distinct} distinct (window, "
              f"row) pairs of {idx.numel()} taps): {ms * 1e3:.1f} us kernel, "
              f"{plain_ms * 1e3:.1f} us plain autograd, "
              f"{lib_ms * 1e3:.1f} us embedding_bag autograd, "
              f"bound {b_ms * 1e3:.2f} us ({b_by})")
        if entry is None:
            entry = {"name": "memory_read_backward", "route": "cuda",
                     "source": "embodied_object_detection_tpu_torch/csrc/"
                               "memory_read.cu",
                     "replaces": "embodied_object_detection_tpu/ops/"
                                 "memory_ops.py:43",
                     "launches": launches["memory_read_backward"],
                     "max_abs_err": errs["memory_read_backward"], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib_ms}
    return [entry]


# kernels 10-10c's cases: (name, level shapes, channels) of a frame's p3-p7
# at 480x640 and of the Res5 heads' one C4 level
CANVAS_CASES = (("frame", DCN_LEVELS, 256), ("res5", ((30, 40),), 1024))


def canvas_levels(rng, shapes, channels):
    """bf16 levels [h, w, C] on the card whose groups sit at different
    means and spreads, as a tower convolution's output does."""
    out = []
    for h, w in shapes:
        x = rng.randn(h, w, channels) * rng.uniform(0.5, 3.0, channels) + \
            rng.uniform(-2.0, 2.0, channels)
        out.append(torch.from_numpy(x.astype(np.float32)).cuda().to(
            torch.bfloat16))
    return out


def time_centernet(rng, launches):
    """Phase 7b, rows 10-10c: the CenterNet head's canvas kernels at the
    main path's shapes, each first held to its plain version on the same
    inputs, then timed as phase 7 times the others (their plain versions
    are graph-captured too: none syncs). The pack (a frame's five bf16
    levels onto the 91 x 80 canvas, and Res5's one 1024-channel level)
    and the decode (from the canvas's heads with the scales applied
    inside) bit-equal; the GroupNorm on the canvas (bf16 out, and f32 out
    as the last tower layer writes it) bit-equal too (its sums run in
    PyTorch's own order), zero at the pads, and the same call twice equal.
    Bound: bytes
    once over 3.35 TB/s against f32 operations (the larger). They replace
    no TPU kernel: `csrc/centernet.cu` says why they were added."""
    from embodied_object_detection_tpu_torch.ops import centernet as cn
    src = "embodied_object_detection_tpu_torch/csrc/centernet.cu"

    def entry(name, errs, ms, plain_ms, nbytes, flops):
        b_ms, b_by = bound_ms(nbytes, flops)
        print(f"  {name}: {ms * 1e3:.2f} us kernel, {plain_ms * 1e3:.2f} us "
              f"plain, bound {b_ms * 1e3:.2f} us ({b_by}), largest gap to "
              f"the plain version {errs:.3e}")
        return {"name": name, "route": "cuda", "source": src,
                "replaces": None, "launches": launches[name.split(" ")[0]],
                "max_abs_err": errs, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}

    entries = []
    for case, shapes, c in CANVAS_CASES:
        lay = cn.canvas_layout(shapes)
        levels = canvas_levels(rng, shapes, c)
        used = sum(h * w for h, w in shapes)
        cells = lay.height * lay.width
        args = (lay.flat(), lay.height, lay.width, torch.bfloat16)
        x = cn.pack_levels(levels, lay, torch.bfloat16)
        if not torch.equal(x, cn.pack_levels_plain(levels, *args)):
            raise AssertionError(f"phase 7b: the {case} pack differs from "
                                 f"its plain version")
        entries.append(entry(
            f"centernet_pack ({case})", 0.0,
            graph_ms(lambda: cn.pack_levels(levels, lay, torch.bfloat16)),
            graph_ms(lambda: cn.pack_levels_plain(levels, *args)),
            (used + cells) * c * 2, 0))
        pad = torch.ones((lay.height, lay.width), dtype=torch.bool,
                         device="cuda")
        for (y0, x0), (h, w) in zip(lay.origins, lay.shapes):
            pad[y0:y0 + h, x0:x0 + w] = False
        x[pad] = 7.0                   # a convolution's output at the pads
        bands = [x[r0:r1] for r0, r1 in lay.bands]
        weight = torch.from_numpy(rng.normal(1.0, 0.3, c).astype(
            np.float32)).cuda()
        bias = torch.from_numpy(rng.normal(0.0, 0.3, c).astype(
            np.float32)).cuda()
        for out_f32 in (False, True):
            def kernel():
                return cn.group_norm_relu(bands, weight, bias, lay,
                                          out_f32=out_f32)

            def plain():
                return cn.group_norm_relu_plain(
                    bands, weight, bias, lay.flat(), lay.band_rows(),
                    lay.height, 32, 1e-5, out_f32)
            got = kernel()
            if not torch.equal(got, plain()) or \
                    not bool((got[pad] == 0).all()) or \
                    not torch.equal(kernel(), got):
                raise AssertionError(
                    f"phase 7b: the {case} GroupNorm (out_f32={out_f32}) "
                    f"differs from its plain version, leaves a pad, or "
                    f"repeats otherwise")
            entries.append(entry(
                f"group_norm_relu ({case}{', f32 out' if out_f32 else ''})",
                0.0, graph_ms(kernel), graph_ms(plain),
                used * c * 2 + got.numel() * got.element_size(),
                used * c * 8))
    lay = cn.canvas_layout(DCN_LEVELS)
    outs = lay.levels(torch.from_numpy(
        (rng.randn(lay.height, lay.width, 5) * 3).astype(np.float32)).cuda())
    hms, regs = [o[..., 0] for o in outs], [o[..., 1:] for o in outs]
    scales = torch.from_numpy(rng.uniform(0.5, 1.5, 5).astype(
        np.float32)).cuda()
    strides = (8, 16, 32, 64, 128)
    dargs = (hms, regs, scales, strides, 1e-4)
    for g, w in zip(cn.centernet_decode(*dargs),
                    cn.centernet_decode_plain(*dargs)):
        if not torch.equal(g, w):
            raise AssertionError("phase 7b: the decode differs from its "
                                 "plain version")
    used = sum(h * w for h, w in DCN_LEVELS)
    entries.append(entry(
        "centernet_decode", 0.0, graph_ms(lambda: cn.centernet_decode(*dargs)),
        graph_ms(lambda: cn.centernet_decode_plain(*dargs)),
        used * (5 * 4 + 8 + 6 * 4), used * 30))
    phase("7b", "the CenterNet canvas kernels at 480x640 and Res5's shape: "
                "each bit-equal to its plain version, zero pads; device "
                "times from CUDA graphs of 20 calls x 10 replays")
    return entries


# ------------------------------------------------------------ slice 15

# phase 14's image sizes: letterboxed into 480x640 without a resize (their
# scale is 1), so the in-memory dataset needs no PIL
COCO_SIZES = ((480, 640), (480, 500), (400, 640), (360, 640))
COCO_IMAGES = 16
# launches an image of the single-frame evaluation: proposal and final NMS,
# three cascade stages (no write: no write NMS, mask pooler or paste)
COCO_LAUNCHES_PER_IMAGE = {"nms": 2, "roi_align": 3, **PACKED_PROPOSALS}
COTRAIN_B = 4
COTRAIN_STEPS = 3
# launches a co-training step at B = 4: box and image-label batches the
# proposal NMS at the training top-k and three stages' pools and their
# backward a frame (the image-label pools hold R = 129: 128 proposals and
# the whole-image box); caption batches one R = 1 pool and its backward a
# frame. Box batches decode a frame after the head level by level (autograd
# records it); image-label batches take their proposals without a gradient,
# on the canvas
COTRAIN_LAUNCHES = {
    "box": {"nms": 4, "roi_align": 12, "roi_align_backward": 12,
            "centernet_decode": 4},
    "image": {"nms": 4, "roi_align": 12, "roi_align_backward": 12,
              **{k: 4 * n for k, n in PACKED_PROPOSALS.items()}},
    "caption": {"roi_align": 4, "roi_align_backward": 4},
    "captiontag": {"nms": 4, "roi_align": 12, "roi_align_backward": 12,
                   **{k: 4 * n for k, n in PACKED_PROPOSALS.items()}},
}


def coco_jsons(rng, n, sizes, classes, max_boxes=20):
    """(raw json, federated json, {file_name: uint8 image}): n random
    images of `sizes` in turn with 1 to `max_boxes` GT boxes each. The raw
    json's category ids are the model's class indices (mp3d-style); the
    federated one's are the same classes 1-based, each image with two
    absent classes as neg_category_ids."""
    arrays, images, raw_anns = {}, [], []
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        name = f"im{i:03d}.png"
        arrays[name] = rng.randint(0, 255, (h, w, 3)).astype(np.uint8)
        g = 1 + i * (max_boxes - 1) // max(n - 1, 1)
        cls = rng.randint(0, classes, g)
        absent = [c for c in range(classes) if c not in set(cls.tolist())]
        images.append(dict(id=i + 1, file_name=name, height=h, width=w,
                           neg_category_ids=[c + 1 for c in absent[:2]]))
        for c in cls:
            bw, bh = rng.uniform(w / 16, w / 2), rng.uniform(h / 16, h / 2)
            x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            raw_anns.append(dict(id=len(raw_anns) + 1, image_id=i + 1,
                                 category_id=int(c), bbox=[x, y, bw, bh],
                                 iscrowd=0, area=bw * bh))
    raw = dict(images=images, annotations=raw_anns,
               categories=[dict(id=c, name=f"class{c}")
                           for c in range(classes)])
    fed = dict(images=images,
               annotations=[dict(a, category_id=a["category_id"] + 1)
                            for a in raw_anns],
               categories=[dict(id=c + 1, name=f"class{c}")
                           for c in range(classes)])
    return raw, fed, arrays


def coco_datasets(cfg, raw, fed, arrays):
    """The two protocols' in-memory datasets: (COCO: raw ids, federated:
    1-based ids remapped)."""
    from embodied_object_detection_tpu_torch.data.catalog import (
        ArrayCocoDataset, DatasetEntry)
    kw = dict(height=cfg.input.height, width=cfg.input.width,
              max_gt=cfg.input.max_gt_boxes)
    return (ArrayCocoDataset(DatasetEntry("", ""), arrays, coco=raw,
                             remap_ids=False, **kw),
            ArrayCocoDataset(DatasetEntry("", ""), arrays, coco=fed,
                             remap_ids=True, **kw))


def image_only(cfg):
    """`cfg` as the single-frame path builds it: image_only, with no
    memory write."""
    return cfg.replace(memory=dataclasses.replace(
        cfg.memory, memory_type="image_only", write_memory=False))


def run_coco_eval():
    """Phase 14: `engine/coco.py:evaluate_coco` at the default config
    (480x640, ResNet-50, bf16, 20 classes with raw ids, image_only) over
    COCO_IMAGES in-memory images, under the COCO and the federated
    protocol."""
    from embodied_object_detection_tpu_torch.config import DetectorConfig
    from embodied_object_detection_tpu_torch.engine.coco import evaluate_coco
    from embodied_object_detection_tpu_torch.models.detector import (
        build_detector)

    cfg = image_only(DetectorConfig())
    model = build_detector(cfg, seed=0, device="cuda")
    zs = random_zs(np.random.RandomState(14), cfg)
    raw, fed, arrays = coco_jsons(np.random.RandomState(14), COCO_IMAGES,
                                  COCO_SIZES, cfg.roi.num_classes)
    coco_ds, fed_ds = coco_datasets(cfg, raw, fed, arrays)
    n = len(coco_ds)

    def run(ds=coco_ds, federated=False):
        return evaluate_coco(model, cfg, ds, zs, verbose=False,
                             federated=federated)

    syncs = sync_sites(run)
    batches = -(-n // 8)
    # the sites inside a frame: any whose innermost frame of this
    # repository is not the engine's own loop or its detections copy
    in_frame = {s: k for s, k in syncs.items()
                if not s.startswith(("coco.py:", "eval.py:"))}
    print(f"  warm-up run under the sync debug mode 'warn': "
          f"{sum(syncs.values())} synchronising calls ({batches} batches "
          f"of 8)")
    for site, k in syncs.items():
        print(f"    {k} x {site}")
    if in_frame:
        raise AssertionError(f"phase 14: synchronising calls inside a frame: "
                             f"{in_frame}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated()
    expected = {k: COCO_LAUNCHES_PER_IMAGE.get(k, 0) * n for k in launches}
    if launches != expected:
        raise AssertionError(f"phase 14: launches {launches}, expected "
                             f"{expected}")
    _, busy, _ = device_busy(profile_events(run))
    ms = secs / n * 1e3
    busy_ms = busy / 1e3 / n
    fed_res = run(fed_ds, federated=True)
    for name, r in (("COCO", res), ("federated", fed_res)):
        if not r or not all(math.isfinite(v) for v in r.values()):
            raise AssertionError(f"phase 14 {name}: AP {r}")
    print(f"  COCO protocol: AP {res['AP']:.4f}, AP50 {res['AP50']:.4f}; "
          f"federated (1-based ids remapped, neg_category_ids, 300 "
          f"detections): AP {fed_res['AP']:.4f} (random weights: no "
          f"quality)")
    print(f"  {n} images at {sorted(set(COCO_SIZES))}: {ms:.2f} ms/image "
          f"({1e3 / ms:.2f} images/s, host clock over the run, data and "
          f"scoring included); device busy {busy_ms:.2f} ms/image "
          f"(profiled run), busy share {busy_ms / ms:.3f}; peak device "
          f"memory {peak / 2 ** 30:.2f} GiB; launches an image "
          f"{ {k: v // n for k, v in launches.items() if v} }")
    phase(14, f"single-frame evaluation at 480x640 over {n} images: "
              f"{ms:.2f} ms/image, busy share {busy_ms / ms:.3f}, launches "
              f"an image {COCO_LAUNCHES_PER_IMAGE}, "
              f"{sum(syncs.values())} host syncs in {batches} batches, none "
              f"inside a frame; AP finite under both protocols")
    return launches


def cotraining_sources(rng, cfg, n=8):
    """Four in-memory sources at 480x640 (raw ids, no resize): box
    (1-12 GT boxes), image labels (1-3 tags, no boxes), captions (two an
    image) and captions with tags (image 0 without a caption)."""
    from embodied_object_detection_tpu_torch.data.catalog import (
        ArrayCocoDataset, DatasetEntry)
    h, w, c = cfg.input.height, cfg.input.width, cfg.roi.num_classes
    raw, _, arrays = coco_jsons(rng, n, ((h, w),), c, max_boxes=12)
    cats = raw["categories"]
    plain = [dict(id=im["id"], file_name=im["file_name"], height=h,
                  width=w) for im in raw["images"]]
    tags = [dict(im, pos_category_ids=[int(x) for x in rng.choice(
        c, 1 + i % 3, replace=False)]) for i, im in enumerate(plain)]
    caps = [dict(im, captions=[f"a photo of scene {i}",
                               f"object {i} in a room"])
            for i, im in enumerate(plain)]
    captags = [dict(t, captions=[] if i == 0 else [f"things {i} on a desk"])
               for i, t in enumerate(tags)]
    kw = dict(height=h, width=w, max_gt=cfg.input.max_gt_boxes,
              remap_ids=False)
    return [ArrayCocoDataset(DatasetEntry("", ""), arrays, coco=coco, **kw)
            for coco in (raw, dict(images=tags, categories=cats),
                         dict(images=caps, categories=cats),
                         dict(images=captags, categories=cats))]


COTRAIN_KINDS = ("box", "image", "caption", "captiontag")


def cotraining_batches(cfg, seed=14):
    """COTRAIN_STEPS batches of each ann type at B = COTRAIN_B, from one
    `multi_source_train_batches` stream over the four sources, the
    captions embedded by the CLIP text tower on the card
    (`clip_text_encoder`)."""
    from embodied_object_detection_tpu_torch.data.catalog import (
        MultiDatasetSampler)
    from embodied_object_detection_tpu_torch.engine.coco import (
        multi_source_train_batches)
    srcs = cotraining_sources(np.random.RandomState(seed), cfg)
    sampler = MultiDatasetSampler(srcs, [1.0] * 4, seed=seed)
    stream = multi_source_train_batches(
        sampler, srcs, list(COTRAIN_KINDS), cfg, COTRAIN_B,
        embed_fn=clip_text_encoder("cuda"), seed=seed)
    got = {k: [] for k in COTRAIN_KINDS}
    draws = 0
    while min(len(v) for v in got.values()) < COTRAIN_STEPS:
        kind, batch = next(stream)
        draws += 1
        if len(got[kind]) < COTRAIN_STEPS:
            got[kind].append(batch)
    return got, draws


def cotraining_inputs(kind, batch, zs):
    """A batch of the stream as the step's tensors on zs's device. A
    captiontag batch's row 1 loses its caption (weight 0; it keeps its
    tags) and its row 3 becomes a padding row (frame_valid False), as a
    batch padded to a divisible size carries."""
    from embodied_object_detection_tpu_torch.parallel.train_step import (
        batch_to_device)
    device = zs.device
    if kind == "box":
        return (batch_to_device(batch, device), zs)
    t = [torch.from_numpy(np.ascontiguousarray(x)).to(device)
         for x in batch]
    if kind == "image":
        images, labels, lv = t
        return (images, labels, lv, zs)
    if kind == "caption":
        return tuple(t)
    images, feats, weight, labels, lv = t
    weight = weight.clone()
    weight[1] = 0.0
    weight[3] = 0.0
    fv = torch.ones((images.shape[0],), dtype=torch.bool, device=device)
    fv[3] = False
    return (images, feats, weight, labels, lv, zs, fv)


def cotraining_steps(model, cfg, optimizer):
    """{label: (kind, step_fn)} of phase 14b's five co-training steps."""
    from embodied_object_detection_tpu_torch.parallel import train_step as ts
    loss_step = {
        "image max_size": ("image", ts.make_image_label_train_step(
            model, cfg, "max_size")),
        "image wsddn": ("image", ts.make_image_label_train_step(
            model, cfg, "wsddn")),
        "caption": ("caption", ts.make_caption_train_step(model, cfg)),
        "captiontag": ("captiontag", ts.make_captiontag_train_step(
            model, cfg)),
    }
    steps = {"box": ("box", ts.make_train_step(model, cfg, optimizer)[1])}
    for label, (kind, fn) in loss_step.items():
        steps[label] = (kind, ts.make_loss_step(
            model, cfg, lambda step, *x, fn=fn: fn(*x), optimizer)[1])
    return steps


# the parameter prefixes each co-training step must give a nonzero
# gradient: the trunk and FPN always; the three stage heads where the step
# pools through the cascade (the caption region pools through stage 0
# only); wsddn's prop heads; CenterNet under box supervision alone
_STAGES = tuple(f"roi_heads.box_head{k}" for k in range(3))
COTRAIN_TRAINS = {
    "box": ("backbone.", "fpn.", "centernet.") + _STAGES,
    "image max_size": ("backbone.", "fpn.") + _STAGES,
    "image wsddn": ("backbone.", "fpn.") + _STAGES + tuple(
        f"prop_score{k}." for k in range(3)),
    "caption": ("backbone.", "fpn.", "roi_heads.box_head0"),
    "captiontag": ("backbone.", "fpn.") + _STAGES,
}


def grad_names(model):
    """The names of the parameters whose gradient has a nonzero entry,
    read in one copy."""
    named = [(n, p.grad) for n, p in model.named_parameters()
             if p.grad is not None]
    nonzero = torch.stack([g.ne(0).any() for _, g in named]).tolist()
    return {n for (n, _), nz in zip(named, nonzero) if nz}


def cotrain_config():
    """The default config, image_only, with the wsddn prop heads, at an
    lr the steps move the parameters at (1e-4 from the first step)."""
    from embodied_object_detection_tpu_torch.config import DetectorConfig
    cfg = image_only(DetectorConfig())
    return cfg.replace(
        roi=dataclasses.replace(cfg.roi, with_softmax_prop=True),
        solver=dataclasses.replace(cfg.solver, base_lr=1e-4,
                                   warmup_factor=1.0))


def run_cotraining():
    """Phase 14b: Detic's co-training at 480x640 (bf16), B = 4: three AdamW
    steps of each of box batches (`make_train_step`, the CLI's step),
    image-label batches (max_size, and wsddn with the softmax-prop heads),
    caption and captiontag batches, all drawn from one
    `multi_source_train_batches` stream over four in-memory sources."""
    from embodied_object_detection_tpu_torch.engine.solver import (
        build_optimizer)
    from embodied_object_detection_tpu_torch.models.detector import (
        build_detector)
    from embodied_object_detection_tpu_torch.parallel.train_step import (
        TrainState)

    cfg = cotrain_config()
    batches, draws = cotraining_batches(cfg)
    model = build_detector(cfg, seed=0, device="cuda")
    optimizer = build_optimizer(model, cfg.solver)
    state = TrainState(model=model, optimizer=optimizer, step=0)
    zs = torch.from_numpy(random_zs(np.random.RandomState(15), cfg)).cuda()
    out = {}
    for label, (kind, step) in cotraining_steps(model, cfg,
                                                optimizer).items():
        inputs = [cotraining_inputs(kind, b, zs)
                  for b in batches[kind]]
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        graded = set()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counters()
        ms, values = [], []
        for x in inputs:
            t0 = time.perf_counter()
            state, losses = step(state, *x)
            # the step's one host read: every loss in one copy
            values.append(dict(zip(losses, torch.stack(
                list(losses.values())).float().tolist())))
            ms.append((time.perf_counter() - t0) * 1e3)
            graded |= grad_names(model)
        launches = read_counters()
        peak = torch.cuda.max_memory_allocated()
        expected = {k: COTRAIN_LAUNCHES[kind].get(k, 0) * COTRAIN_STEPS
                    for k in launches}
        if launches != expected:
            raise AssertionError(f"phase 14b {label}: launches {launches}, "
                                 f"expected {expected}")
        bad = [v for v in values if not all(math.isfinite(x)
                                            for x in v.values())]
        moved = {n for n, p in model.named_parameters()
                 if not torch.equal(p.detach(), before[n])}
        unmoved = sorted(graded - moved)
        untrained = [g for g in COTRAIN_TRAINS[label]
                     if not any(n.startswith(g) for n in graded)]
        if bad or unmoved or untrained:
            raise AssertionError(
                f"phase 14b {label}: losses {values}; with a gradient but "
                f"not moved: {unmoved}; no gradient in {untrained}")
        syncs = sync_sites(lambda: step(state, *inputs[0]))
        if syncs:
            raise AssertionError(f"phase 14b {label}: synchronising calls "
                                 f"in a step: {dict(syncs)}")
        per_step = {k: v // COTRAIN_STEPS for k, v in launches.items() if v}
        print(f"  {label}: losses {[round(v['total_loss'], 4) for v in values]}"
              f"; ms a step {', '.join(f'{x:.1f}' for x in ms)} (steps 2-3 "
              f"mean {np.mean(ms[1:]):.1f}; host clock to the loss read); "
              f"peak {peak / 2 ** 30:.2f} GiB; launches a step {per_step}; "
              f"{sum(syncs.values())} synchronising calls in a step; "
              f"{len(moved)} parameter tensors moved, every one of the "
              f"{len(graded)} with a nonzero gradient")
        out[label] = (np.mean(ms[1:]), peak, per_step, sum(syncs.values()))
    phase("14b", f"co-training at 480x640 bf16, B = {COTRAIN_B}, "
                 f"{COTRAIN_STEPS} AdamW steps each from one multi-source "
                 f"stream ({draws} draws): " + "; ".join(
                     f"{k} {v[0]:.1f} ms/step, {v[3]} syncs"
                     for k, v in out.items()) +
          "; losses finite, every parameter with a gradient moved, no "
          "synchronising call in a step, launches as designed")
    return out


def coco_recorder(module):
    """A subclass of `module.COCOEvaluator` that keeps each image's
    detections, and the evaluator, for phase 14c."""
    seen = {}

    class Recorder(module.COCOEvaluator):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen["evaluator"] = self

        def add_detections(self, image_id, boxes_xyxy, scores, classes):
            seen.setdefault("dets", {})[image_id] = (
                np.asarray(boxes_xyxy), np.asarray(scores),
                np.asarray(classes))
            super().add_detections(image_id, boxes_xyxy, scores, classes)

    return Recorder, seen


def weak_grads(model, fn):
    """(loss values, {name: gradient on the CPU}) of fn() on `model`."""
    model.zero_grad(set_to_none=True)
    total, parts = fn()
    total.backward()
    grads = {n: p.grad.detach().cpu().clone()
             for n, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return {k: float(v.detach()) for k, v in parts.items()}, grads


COTRAIN_CHECKS = ("max_size", "wsddn", "caption", "captiontag")


def cotraining_miniature():
    """(config, inputs) of phase 14c: the 64x96 f32 miniature of phase
    14b's config (ResNet depths (1, 1, 1, 1), 5 classes, training top-k
    64 -> 16) and three frames with labels, captions (frame 1 without
    one) and a padding row (frame 2)."""
    cfg = miniature(cotrain_config(), 1)
    cfg = cfg.replace(centernet=dataclasses.replace(
        cfg.centernet, pre_nms_topk_train=64, post_nms_topk_train=16))
    rng = np.random.RandomState(18)
    inputs = dict(
        images=rng.randint(0, 255, (3, 64, 96, 3)).astype(np.float32),
        labels=np.array([[1, 3, 0], [4, 0, 0], [2, 2, 1]], np.int32),
        lv=np.array([[True, True, False], [True, False, False],
                     [True, True, True]]),
        feats=clip_text_encoder("cpu")(["a chair", "", "a lamp"]),
        weight=np.array([1.0, 0.0, 1.0], np.float32),
        fv=np.array([True, True, False]),
        zs=random_zs(np.random.RandomState(17), cfg))
    return cfg, inputs


def cotraining_losses(model, cfg, x, label):
    """(loss values, gradients) of one of COTRAIN_CHECKS on `model`'s
    device: frame 0's `frame_train_weak` (max_size, wsddn), or the
    caption or captiontag step over the three frames."""
    from embodied_object_detection_tpu_torch.parallel import train_step as ts
    dev = next(model.parameters()).device

    def t(name):
        return torch.from_numpy(x[name]).to(dev)

    def fn():
        if label in ("max_size", "wsddn"):
            losses = model.frame_train_weak(
                t("images")[0], t("zs"), t("labels")[0], t("lv")[0],
                variant=label)
            return sum(losses.values()), losses
        if label == "caption":
            return ts.make_caption_train_step(model, cfg)(
                t("images"), t("feats"), t("weight"))
        return ts.make_captiontag_train_step(model, cfg)(
            t("images"), t("feats"), t("weight"), t("labels"), t("lv"),
            t("zs"), frame_valid=t("fv"))
    return weak_grads(model, fn)


def grad_rtol(label, name):
    """The gradient tolerance of `hold_cotraining`: 1e-3 of a tensor's
    largest for the prop heads under wsddn, whose gradient is a
    softmax-weighted sum over proposals that cancels (read 4.32e-4 on the
    card), 1e-4 for every other tensor and label (read at most 3.2e-6)."""
    return 1e-3 if label.endswith("wsddn") and name.startswith(
        "prop_score") else 1e-4


def hold_cotraining(label, card, cpu):
    """The prop heads' fc2 bias, 0 in exact arithmetic (the softmax over
    proposals is shift-invariant), held under 1e-3 of its head's weight
    gradient on both devices; every other tensor and the losses as
    `hold_losses_grads` holds them, at loss rtol 1e-4 and each tensor's
    `grad_rtol`. Returns the largest relative loss error and the largest
    relative gradient errors of the prop heads and of the other
    tensors."""
    (l_g, g_g), (l_c, g_c) = card, cpu
    g_g, g_c = dict(g_g), dict(g_c)
    for n in [n for n in g_c if n.startswith("prop_score")
              and n.endswith("fc2.bias")]:
        gc, gg = g_c.pop(n), g_g.pop(n, None)
        if gg is None:
            raise AssertionError(f"{label}: the devices differ on which "
                                 "parameters get a gradient")
        head = float(g_c[n.replace("bias", "weight")].abs().max())
        if not max(float(gg.abs().max()),
                   float(gc.abs().max())) <= 1e-3 * head:
            raise AssertionError(f"{label}: {n} is not 0")
    worst_l, rel = hold_losses_grads(label, (l_g, g_g), (l_c, g_c), 1e-4,
                                     lambda n: grad_rtol(label, n))
    worst_g = {"prop": 0.0, "other": 0.0}
    for n, e in rel.items():
        group = "prop" if n.startswith("prop_score") else "other"
        worst_g[group] = max(worst_g[group], e)
    return worst_l, worst_g


def check_cotraining_against_cpu():
    """Phase 14c: the 64x96 f32 miniature (`cotraining_miniature`) from
    the same seeded weights on the card and on the CPU: `evaluate_coco`'s
    detections and AP over 4 images under both protocols, held as phase
    10b holds image_only (each image's scores, ranked, within rtol 1e-4,
    atol 1e-5, its classes and boxes within 1e-2 px + 1e-3 of the
    coordinate, AP within 0.1 points, of the card's detections ranked by
    the CPU's scores always and of the card's own where no detection
    changes its rank); then the image-label (max_size, wsddn), caption and
    captiontag losses and gradients (`hold_cotraining`: the ROIAlign
    backward's float atomics sum in any order, so the card is held within
    a bound, not bitwise)."""
    from embodied_object_detection_tpu_torch.engine import coco as ecoco
    from embodied_object_detection_tpu_torch.models.detector import (
        build_detector)

    cfg, x = cotraining_miniature()
    raw, fed, arrays = coco_jsons(np.random.RandomState(16), 4,
                                  ((64, 96), (64, 75), (54, 96), (48, 96)),
                                  cfg.roi.num_classes, max_boxes=6)
    coco_ds, fed_ds = coco_datasets(cfg, raw, fed, arrays)
    runs = {}
    for dev in ("cuda", "cpu"):
        model = build_detector(cfg, seed=3, device=dev)
        real = ecoco.COCOEvaluator
        evals = {}
        try:
            for name, ds, federated in (("COCO", coco_ds, False),
                                        ("federated", fed_ds, True)):
                rec, seen = coco_recorder(ecoco)
                ecoco.COCOEvaluator = rec
                res = ecoco.evaluate_coco(model, cfg, ds, x["zs"], batch=3,
                                          verbose=False, federated=federated)
                evals[name] = (res, seen["dets"], seen["evaluator"])
        finally:
            ecoco.COCOEvaluator = real
        runs[dev] = (evals, {label: cotraining_losses(model, cfg, x, label)
                             for label in COTRAIN_CHECKS})

    (ev_g, weak_g), (ev_c, weak_c) = runs["cuda"], runs["cpu"]
    lines = []
    for name in ("COCO", "federated"):
        (res_g, dets_g, evg), (res_c, dets_c, _) = ev_g[name], ev_c[name]
        if sorted(dets_g) != sorted(dets_c):
            raise AssertionError(f"phase 14c {name}: images differ")
        for im in dets_c:
            s_g = np.sort(dets_g[im][1])[::-1]
            s_c = np.sort(dets_c[im][1])[::-1]
            if len(s_g) != len(s_c):
                raise AssertionError(f"phase 14c {name}: image {im}: "
                                     f"{len(s_g)} vs {len(s_c)} detections")
            np.testing.assert_allclose(s_g, s_c, rtol=1e-4, atol=1e-5)
            check_boxes_classes(dets_g[im], dets_c[im],
                                f"phase 14c {name}: image {im}")
        swaps = rank_swaps(dets_g, dets_c)
        ap_r = ap_ranked_by(evg, dets_g, dets_c)
        if not abs(ap_r - res_c["AP"]) <= 0.1 or (
                swaps == 0 and not abs(res_g["AP"] - res_c["AP"]) <= 0.1):
            raise AssertionError(f"phase 14c {name}: AP {res_g['AP']} "
                                 f"(ranked by the CPU's scores {ap_r}) vs "
                                 f"{res_c['AP']}")
        lines.append(f"{name} AP card {res_g['AP']:.4f}, CPU "
                     f"{res_c['AP']:.4f} ({swaps} rank swaps, "
                     f"{sum(len(d[1]) for d in dets_c.values())} "
                     "detections held)")
    worst_l, worst_g = 0.0, {"prop": 0.0, "other": 0.0}
    for label in COTRAIN_CHECKS:
        wl, wg = hold_cotraining(f"phase 14c {label}", weak_g[label],
                                 weak_c[label])
        worst_l = max(worst_l, wl)
        worst_g = {k: max(v, wg[k]) for k, v in worst_g.items()}
        lines.append(f"{label}: losses {weak_g[label][0]} on the card, "
                     f"{weak_c[label][0]} on the CPU; "
                     f"{len(weak_c[label][1])} gradient tensors, within "
                     f"{wg['other']:.2e} of each tensor's largest "
                     f"(tolerance 1e-4), the prop heads' within "
                     f"{wg['prop']:.2e} (tolerance "
                     f"{grad_rtol(label, 'prop_score'):g})")
    for line in lines:
        print(f"  {line}")
    phase("14c", f"the card against the CPU at 64x96 f32: evaluate_coco's "
                 f"detections and AP (COCO and federated) within phase 10b's "
                 f"tolerances; image-label (max_size, wsddn), caption and "
                 f"captiontag losses within {worst_l:.2e} relative "
                 f"(tolerance 1e-4), gradients within {worst_g['other']:.2e} "
                 f"of each tensor's largest (tolerance 1e-4), wsddn's prop "
                 f"heads' within {worst_g['prop']:.2e} (tolerance 1e-3)")


def run_coco_cli():
    """The on-disk path where PIL is present: `python -m
    embodied_object_detection_tpu_torch.run --coco-json J --coco-json-test
    J2 --max-iter 3` on PNGs in a temporary directory."""
    try:
        from PIL import Image
    except ImportError:
        print("[phase 14] PIL is absent on this machine: the on-disk "
              "`run.py --coco-json` training and evaluation is skipped")
        return
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        raw, _, arrays = coco_jsons(np.random.RandomState(19), 6,
                                    COCO_SIZES, 20)
        for name, arr in arrays.items():
            Image.fromarray(arr).save(Path(tmp) / name)
        train_json = Path(tmp) / "train.json"
        test_json = Path(tmp) / "test.json"
        train_json.write_text(json.dumps(raw))
        test_json.write_text(json.dumps(dict(
            raw, images=raw["images"][:4],
            annotations=[a for a in raw["annotations"]
                         if a["image_id"] <= 4])))
        cmd = [sys.executable, "-m", "embodied_object_detection_tpu_torch.run",
               "--coco-json", str(train_json), "--coco-json-test",
               str(test_json), "--image-root", tmp, "--max-iter", "3",
               "--output-dir", str(Path(tmp) / "out")]
        t0 = time.perf_counter()
        out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                             timeout=600)
        secs = time.perf_counter() - t0
    tail = out.stdout.strip().splitlines()[-3:]
    if out.returncode != 0 or not any(x.startswith("coco:") for x in tail):
        raise AssertionError(f"run.py --coco-json exited {out.returncode}: "
                             f"{out.stdout[-2000:]} {out.stderr[-2000:]}")
    print("\n".join(f"  {x}" for x in tail))
    phase(14, f"run.py --coco-json on 6 PNGs trained 3 iterations and "
              f"evaluated 4 images in {secs:.1f} s")


def check_roi_align_cotraining(rng):
    """Phase 7's co-training shapes of kernels 4 and 4b: R = 129 (128
    training-mix ROIs and the whole-image box, 7 x 7) and R = 1 (the
    whole-image box, the caption region), each held to the plain tap form
    (forward as phase 4b, backward as phase 4f) and timed beside it and
    its bound."""
    from embodied_object_detection_tpu_torch.ops import roi_align as ra
    levels32, boxes = roi_inputs(rng, 128, torch.float32)
    whole = torch.tensor([[0.0, 0.0, 640.0, 480.0]]).cuda()
    rows = []
    for name, b in (("R = 129", torch.cat([boxes, whole])), ("R = 1", whole)):
        r = b.shape[0]
        err32, err_v1, err_v4, _, _, _ = check_roi_case(levels32, b, 7)
        grad = torch.from_numpy(rng.randn(r, 7, 7, 256).astype(np.float32)
                                ).cuda()
        _, s32, s_plain, s_ref, s16, most = check_backward_case(
            levels32, b, grad, strict_plain=False)
        levels = [f.to(torch.bfloat16) for f in levels32]
        lvl = roi_levels(b)
        ms = graph_ms(lambda: ra.roi_align_cuda(levels, b, lvl, STRIDES, 7,
                                                2))
        plain_ms = graph_ms(lambda: ra._roi_align_taps(levels, b, STRIDES, 7,
                                                       2, lvl))
        c = 256
        out_elems = r * 49 * c
        b_ms, b_by = bound_ms(forward_read_bytes(levels, b, lvl) + r * 20 +
                              out_elems * 2, out_elems * (4 * 8 + 1))
        g16 = grad.to(torch.bfloat16)
        shapes = [f.shape[:2] for f in levels]
        bms = graph_ms(lambda: ra.roi_align_backward_cuda(
            g16, shapes, b, lvl, STRIDES, 2, torch.bfloat16))
        leaves = [f.detach().clone().requires_grad_(True) for f in levels]
        bplain = event_ms(lambda: torch.autograd.grad(
            ra._roi_align_taps(leaves, b, STRIDES, 7, 2, lvl), leaves,
            g16.float()))
        scalar, vector = backward_atomics(levels, b, lvl, c)
        bb_ms, bb_by = bound_ms(g16.numel() * 2 + r * 20 +
                                sum(f.numel() * 2 for f in levels),
                                2 * float(scalar))
        print(f"  roi_align {name}, 7x7 (levels "
              f"{sorted(set((lvl + 3).tolist()))}): forward f32 vs v1 (CPU) "
              f"{err32:.2e}, bf16 vs v1 {err_v1:.2e}, vs v4 {err_v4:.2e}; "
              f"bf16 {ms * 1e3:.1f} us kernel, {plain_ms * 1e3:.1f} us plain "
              f"v1, bound {b_ms * 1e3:.2f} us ({b_by}); backward f32 max "
              f"err / bound {s32:.3f} from the exact sum ({s_plain:.3f} "
              f"the CPU autograd's), bf16 {s_ref:.3f} and {s16:.3f}, up to "
              f"{most} contributions on one position; bf16 "
              f"{bms * 1e3:.1f} us kernel ({vector} float4 atomics), "
              f"{bplain * 1e3:.1f} us plain v1 autograd, bound "
              f"{bb_ms * 1e3:.2f} us ({bb_by})")
        rows.append(f"{name} {ms * 1e3:.1f} / {bms * 1e3:.1f} us")
    phase(7, "roi_align forward / backward at the co-training shapes, held "
             "to the plain tap form as phases 4b and 4f: " + "; ".join(rows))


# ------------------------------------------------------------ slice 16

C4_SHAPE = (30, 40)         # the Res5 heads' one level: C4 of 480x640
C4_STRIDES = (16,)
RES5_POOL = 14
# launches a Res5 image: the proposals on a canvas of C4 alone, the
# proposal NMS and the final multiclass NMS, one 14 x 14 pool of the
# proposals on C4
RES5_LAUNCHES_PER_IMAGE = {"nms": 2, "roi_align": 1, **PACKED_PROPOSALS}
# a Res5 training frame: the proposals' decode and NMS, the pool of the
# sampled ROIs (512 of the 2000 proposals and the GT) and its backward
RES5_LAUNCHES_PER_STEP = {"nms": 1, "roi_align": 1, "roi_align_backward": 1,
                          "centernet_decode": 1}
RES5_STEPS = 3
TEXT_MERGES = 300
LVIS_CATEGORIES = (REPO / "embodied_object_detection_tpu_torch" / "data" /
                   "metadata" / "lvis_v1_categories.json")


def c4_inputs(rng, r, whole=0):
    """A C4 level [30, 40, 1024] f32 on the card, and [r, 4] boxes of
    sides 16-900 px that cross the image border, the last `whole` of them
    over the whole 480x640 image (each corner moved up to 8 px)."""
    level = torch.from_numpy(rng.randn(*C4_SHAPE, 1024).astype(np.float32)
                             ).cuda()
    side = np.exp(rng.uniform(np.log(16), np.log(900), r))
    aspect = np.exp(rng.uniform(-0.7, 0.7, r))
    bw, bh = side * np.sqrt(aspect), side / np.sqrt(aspect)
    cx, cy = rng.uniform(-40, 680, r), rng.uniform(-40, 520, r)
    boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], 1)
    if whole:
        boxes[-whole:] = np.array([0.0, 0.0, 640.0, 480.0]) + \
            rng.uniform(-8, 8, (whole, 4))
    return [level], torch.from_numpy(boxes.astype(np.float32)).cuda()


def check_backward_c4(levels, boxes, lvl, grad):
    """Kernel 4b on C4 at 14 x 14, 1024 channels, in f32 within
    contributions x 2^-24 x sum|contribution| of the exact sum of the
    plain tap form's f32 contributions, and in bf16 within 2^-8 |ref| +
    (1 + 2^-8) contributions x 2^-24 x sum|contribution| of the exact sum
    of the bf16 gradient's contributions (phase 4f's bounds, the sums
    taken on the card in f64). Returns (f32 error, its share of the
    bound, the bf16 share, the most contributions on one position)."""
    from embodied_object_detection_tpu_torch.ops import roi_align as ra
    shapes = [f.shape[:2] for f in levels]
    count, exact, mag = exact_contributions(levels, boxes, lvl, grad,
                                            RES5_POOL, C4_STRIDES, "cuda")
    bound = count[:, None].double() * 2.0 ** -24 * mag
    got = ra.roi_align_backward_cuda(grad, shapes, boxes, lvl, C4_STRIDES, 2,
                                     torch.float32)[0].reshape(exact.shape)
    err = (got.double() - exact).abs()
    if not bool((err <= bound).all()):
        raise AssertionError(f"roi_align backward on C4, f32: max err "
                             f"{float(err.max())} from the exact sum beyond "
                             f"n 2^-24 sum|c|")
    g16 = grad.to(torch.bfloat16)
    got16 = ra.roi_align_backward_cuda(g16, shapes, boxes, lvl, C4_STRIDES,
                                       2, torch.bfloat16)[0]
    _, exact16, mag16 = exact_contributions(levels, boxes, lvl, g16,
                                            RES5_POOL, C4_STRIDES, "cuda")
    err16 = (got16.reshape(exact16.shape).double() - exact16).abs()
    tight = 2.0 ** -8 * exact16.abs() + \
        (1 + 2.0 ** -8) * count[:, None].double() * 2.0 ** -24 * mag16
    if not bool((err16 <= tight).all()):
        raise AssertionError(f"roi_align backward on C4, bf16: max err "
                             f"{float(err16.max())} beyond 2^-8 |ref| + "
                             f"n 2^-24 sum|c|")

    def share(e, b):
        return float((e / b.clamp(min=1e-30)).max())

    return (float(err.max()), share(err, bound), share(err16, tight),
            int(count.max()))


def check_roi_align_res5(rng):
    """Phase 7's Res5 shapes of kernels 4 and 4b: one C4 level (30 x 40 x
    1024, stride 16), 14 x 14, s = 2, every ROI on level 0. The forward
    at R = 256 on random boxes and on whole-image boxes (the banded plan)
    and at R = 512, held as phase 4b holds; the backward at R = 512 as
    phase 4f holds; each timed beside the plain tap form and its bound.
    Returns {case: (kernel us, plain us, bound us)}."""
    from embodied_object_detection_tpu_torch.ops import roi_align as ra
    out = {}
    for name, r, whole in (("R = 256 random", 256, 0),
                           ("R = 256 whole-image", 256, 256),
                           ("R = 512 random", 512, 0)):
        levels32, boxes = c4_inputs(rng, r, whole)
        lvl = torch.zeros((r,), dtype=torch.int32, device="cuda")
        if not torch.equal(ra.assign_levels(boxes, 4, 4) - 4, lvl):
            raise AssertionError(f"{name}: a one-level assignment gave a "
                                 "ROI a level other than 0")
        report = {}
        err32, err_v1, err_v4, _, _, stats = check_roi_case(
            levels32, boxes, RES5_POOL, C4_STRIDES, lvl, report)
        lo, med, hi, banded = staged_grids(stats)
        levels = [f.to(torch.bfloat16) for f in levels32]
        ms = graph_ms(lambda: ra.roi_align_cuda(levels, boxes, lvl,
                                                C4_STRIDES, RES5_POOL, 2))
        # the plain form gathers R x 3136 taps x 1024 channels (3.3 GB in
        # f32 at R = 256): CUDA events around eager calls, not a graph
        plain_ms = event_ms(lambda: ra._roi_align_taps(
            levels, boxes, C4_STRIDES, RES5_POOL, 2, lvl), reps=5)
        out_elems = r * RES5_POOL * RES5_POOL * 1024
        b_ms, b_by = bound_ms(
            forward_read_bytes(levels, boxes, lvl, RES5_POOL, C4_STRIDES) +
            r * 20 + out_elems * 2, out_elems * (4 * 8 + 1))
        print(f"  roi_align on C4 30x40x1024, {name}, 14x14: f32 vs v1 (CPU) "
              f"max err {err32:.3e} ({report['bit_equal']:.4f} of the "
              f"outputs bit-equal), bf16 vs v1 {err_v1:.3e}, vs v4 "
              f"{err_v4:.3e}; staged grid positions {lo}-{hi} (median "
              f"{med:g}), {banded} of {r} ROIs in bands; bf16 "
              f"{ms * 1e3:.1f} us kernel, {plain_ms * 1e3:.1f} us plain v1, "
              f"bound {b_ms * 1e3:.2f} us ({b_by})")
        if whole and banded < r:
            raise AssertionError(f"{name}: {r - banded} whole-image ROIs not "
                                 "taken in bands")
        out[name] = (ms * 1e3, plain_ms * 1e3, b_ms * 1e3)
        if r != 512:
            continue
        grad = torch.from_numpy(rng.randn(r, RES5_POOL, RES5_POOL, 1024)
                                .astype(np.float32)).cuda()
        err, s32, s16, most = check_backward_c4(levels32, boxes, lvl, grad)
        g16 = grad.to(torch.bfloat16)
        shapes = [f.shape[:2] for f in levels]
        bms = graph_ms(lambda: ra.roi_align_backward_cuda(
            g16, shapes, boxes, lvl, C4_STRIDES, 2, torch.bfloat16))
        leaves = [f.detach().clone().requires_grad_(True) for f in levels]
        bplain = event_ms(lambda: torch.autograd.grad(
            ra._roi_align_taps(leaves, boxes, C4_STRIDES, RES5_POOL, 2, lvl),
            leaves, g16.float()), reps=3)
        scalar, vector = backward_atomics(levels, boxes, lvl, 1024,
                                          RES5_POOL, C4_STRIDES)
        bb_ms, bb_by = bound_ms(g16.numel() * 2 + r * 20 +
                                levels[0].numel() * 2, 2 * float(scalar))
        print(f"  roi_align backward on C4, R = 512, 14x14x1024: f32 max err "
              f"{err:.3e} = {s32:.3f} of the bound from the exact sum, bf16 "
              f"{s16:.3f} (up to {most} contributions on one position); "
              f"bf16 {bms * 1e3:.1f} us kernel ({vector} float4 atomics, "
              f"{scalar:.3e} contributions), {bplain * 1e3:.1f} us plain v1 "
              f"autograd, bound {bb_ms * 1e3:.2f} us ({bb_by})")
        out["backward R = 512"] = (bms * 1e3, bplain * 1e3, bb_ms * 1e3)
    phase(7, "roi_align forward / backward at the Res5 shapes (C4 30x40x1024 "
             "bf16, 14x14, s = 2, one level), held as phases 4b and 4f: " +
          "; ".join(f"{k} {v[0]:.1f} us (plain {v[1]:.1f}, bound "
                    f"{v[2]:.2f})" for k, v in out.items()))
    return out


def res5_config():
    """The default config with the Res5 heads, as `run.py --coco-json`
    builds the single-frame model."""
    from embodied_object_detection_tpu_torch.config import DetectorConfig
    cfg = image_only(DetectorConfig())
    return cfg.replace(roi=dataclasses.replace(cfg.roi, head_type="res5"))


def res5_train_inputs(ds, steps, device):
    """(image [H, W, 3], GroundTruth) of the first `steps` images of a
    COCO dataset, on `device`."""
    from embodied_object_detection_tpu_torch.structures import GroundTruth
    out = []
    for i in range(steps):
        it = ds[i]
        out.append((torch.from_numpy(np.asarray(it["image"], np.float32)
                                     ).to(device),
                    GroundTruth(*(torch.from_numpy(np.asarray(it[k])).to(
                        device) for k in ("gt_boxes", "gt_classes",
                                          "gt_valid")))))
    return out


def res5_loss_fn(model, zs):
    """A `make_loss_step` loss over one image: `frame_train` with the
    sample drawn from a CUDA generator seeded by the step."""
    def loss_fn(step, image, gt):
        gen = torch.Generator(device=image.device)
        gen.manual_seed(step)
        losses = model.frame_train(image, zs, gt, gen)
        return sum(losses.values()), losses
    return loss_fn


def run_res5():
    """Phase 15: the Res5 detector at the default config (480x640,
    ResNet-50 (3, 4, 6, 3), bf16, 20 classes): `evaluate_coco` over phase
    14's COCO_IMAGES images under both protocols, then RES5_STEPS
    `frame_train` + AdamW steps, one image a step. Returns the model,
    its config and the phase's numbers."""
    from embodied_object_detection_tpu_torch.engine.coco import evaluate_coco
    from embodied_object_detection_tpu_torch.models.detector import (
        build_detector)
    from embodied_object_detection_tpu_torch.models.res5_detector import (
        Res5Detector)
    from embodied_object_detection_tpu_torch.parallel.train_step import (
        make_loss_step)

    cfg = res5_config()
    model = build_detector(cfg, seed=0, device="cuda")
    if not isinstance(model, Res5Detector) or any(
            ".res5." in n or n.startswith("res5") for n, _ in
            model.named_parameters()):
        raise AssertionError("phase 15: build_detector did not build the "
                             "Res5 variant with the shared stage 4")
    zs = random_zs(np.random.RandomState(15), cfg)
    raw, fed, arrays = coco_jsons(np.random.RandomState(14), COCO_IMAGES,
                                  COCO_SIZES, cfg.roi.num_classes)
    coco_ds, fed_ds = coco_datasets(cfg, raw, fed, arrays)
    n = len(coco_ds)

    def run(ds=coco_ds, federated=False):
        return evaluate_coco(model, cfg, ds, zs, verbose=False,
                             federated=federated)

    syncs = sync_sites(run)
    in_frame = {s: k for s, k in syncs.items()
                if not s.startswith(("coco.py:", "eval.py:"))}
    if in_frame:
        raise AssertionError(f"phase 15: synchronising calls inside a frame: "
                             f"{in_frame}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated()
    expected = {k: RES5_LAUNCHES_PER_IMAGE.get(k, 0) * n for k in launches}
    if launches != expected:
        raise AssertionError(f"phase 15: launches {launches}, expected "
                             f"{expected}")
    _, busy, _ = device_busy(profile_events(run))
    ms = secs / n * 1e3
    busy_ms = busy / 1e3 / n
    fed_res = run(fed_ds, federated=True)
    for name, r in (("COCO", res), ("federated", fed_res)):
        if not r or not all(math.isfinite(v) for v in r.values()):
            raise AssertionError(f"phase 15 {name}: AP {r}")
    print(f"  evaluate_coco with the Res5 heads: COCO AP {res['AP']:.4f}, "
          f"federated AP {fed_res['AP']:.4f} (random weights: no quality); "
          f"{n} images: {ms:.2f} ms/image (host clock, data and scoring "
          f"included), device busy {busy_ms:.2f} ms/image (profiled run), "
          f"busy share {busy_ms / ms:.3f}; peak device memory "
          f"{peak / 2 ** 30:.2f} GiB; launches an image "
          f"{ {k: v // n for k, v in launches.items() if v} }; "
          f"{sum(syncs.values())} host syncs in {-(-n // 8)} batches, none "
          f"inside a frame")

    zs_d = torch.from_numpy(zs).cuda()
    inputs = res5_train_inputs(coco_ds, RES5_STEPS + 1, "cuda")
    init_state, step_fn = make_loss_step(model, cfg, res5_loss_fn(model,
                                                                  zs_d))
    state = init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    step_ms, values, l4 = [], [], []
    for image, gt in inputs[:RES5_STEPS]:
        t0 = time.perf_counter()
        state, losses = step_fn(state, image, gt)
        values.append(dict(zip(losses, torch.stack(
            list(losses.values())).float().tolist())))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        l4.append(float(model.backbone.layer4_0.conv1.weight.grad.abs().sum()))
    train_launches = read_counters()
    train_peak = torch.cuda.max_memory_allocated()
    expected = {k: RES5_LAUNCHES_PER_STEP.get(k, 0) * RES5_STEPS
                for k in train_launches}
    if train_launches != expected:
        raise AssertionError(f"phase 15 training: launches {train_launches}, "
                             f"expected {expected}")
    if not all(math.isfinite(x) for v in values for x in v.values()) or \
            not all(x > 0 for x in l4):
        raise AssertionError(f"phase 15 training: losses {values}, "
                             f"|grad layer4_0.conv1| {l4}")
    train_syncs = sync_sites(lambda: step_fn(state, *inputs[RES5_STEPS]))
    print(f"  {RES5_STEPS} frame_train + AdamW steps (one image a step, 512 "
          f"sampled ROIs): total losses "
          f"{[round(v['total_loss'], 4) for v in values]}; "
          f"|grad layer4_0.conv1| {[f'{x:.3e}' for x in l4]} (stage 4 "
          f"trains only through the ROI path); ms a step "
          f"{', '.join(f'{x:.1f}' for x in step_ms)} (host clock to the "
          f"loss read); peak {train_peak / 2 ** 30:.2f} GiB; launches a step "
          f"{ {k: v // RES5_STEPS for k, v in train_launches.items() if v} }"
          f"; {sum(train_syncs.values())} synchronising calls in a step")
    for site, k in train_syncs.items():
        print(f"    {k} x {site}")
    phase(15, f"Res5 at 480x640 bf16: evaluate_coco {ms:.2f} ms/image, busy "
              f"share {busy_ms / ms:.3f}, launches an image "
              f"{RES5_LAUNCHES_PER_IMAGE}, no host sync inside a frame, AP "
              f"finite under both protocols; {RES5_STEPS} training steps "
              f"{np.mean(step_ms[1:]):.1f} ms/step (steps 2-3), launches a "
              f"step {RES5_LAUNCHES_PER_STEP}, losses finite, stage 4 "
              f"trained through kernel 4b")
    return model, cfg


def hold_losses_grads(label, card, cpu, loss_rtol, grad_rtol=1e-4):
    """The card's losses within `loss_rtol` (+ 1e-7) of the CPU's, and its
    gradients within `grad_rtol` (a number, or a function of the tensor's
    name) of each tensor's largest on the CPU plus 1e-6 of the largest of
    any tensor (gradients 0 in exact arithmetic). Returns the largest
    relative loss error and each tensor's relative gradient error (tensors
    above that floor)."""
    (l_g, g_g), (l_c, g_c) = card, cpu
    rtol_of = grad_rtol if callable(grad_rtol) else lambda n: grad_rtol
    worst_l, rel = 0.0, {}
    for k in l_c:
        err = abs(l_g[k] - l_c[k])
        if not err <= loss_rtol * abs(l_c[k]) + 1e-7:
            raise AssertionError(f"{label} {k}: card {l_g[k]} vs CPU "
                                 f"{l_c[k]}")
        worst_l = max(worst_l, err / max(abs(l_c[k]), 1e-30))
    if set(g_g) != set(g_c):
        raise AssertionError(f"{label}: the devices differ on which "
                             "parameters get a gradient")
    floor = 1e-6 * max(float(g.abs().max()) for g in g_c.values())
    for n, gc in g_c.items():
        scale = float(gc.abs().max())
        err = float((g_g[n].cpu() - gc.cpu()).abs().max())
        rtol = rtol_of(n)
        if not err <= rtol * scale + floor:
            raise AssertionError(f"{label}: {n} gradient differs by "
                                 f"{err:.3e} (largest {scale:.3e}, "
                                 f"tolerance {rtol:g})")
        if scale > floor:
            rel[n] = err / scale
    return worst_l, rel


def hold_detections(label, card, cpu):
    """One frame's detections on the card against the CPU's: the same
    count, scores ranked within rtol 1e-4 (atol 1e-5), classes and boxes
    as `check_boxes_classes` holds them (phases 6 and 14c). Returns the
    count."""
    def host(d):
        v = d.valid.cpu().numpy()
        return (d.boxes.cpu().numpy()[v], d.scores.cpu().numpy()[v],
                d.classes.cpu().numpy()[v])
    g, c = host(card), host(cpu)
    if len(g[1]) != len(c[1]):
        raise AssertionError(f"{label}: {len(g[1])} vs {len(c[1])} "
                             "detections")
    np.testing.assert_allclose(np.sort(g[1])[::-1], np.sort(c[1])[::-1],
                               rtol=1e-4, atol=1e-5)
    check_boxes_classes(g, c, label)
    return len(c[1])


def check_res5_against_cpu():
    """Phase 15's miniature: the Res5 detector at 64x96 f32 (ResNet depths
    (1, 1, 1, 1), 5 classes, training top-k 64 -> 16, so 16 proposals and
    the GT stay under the sample size and no draw enters) from the same
    seeded weights on the card and on the CPU: `frame_step`'s detections
    (`hold_detections`), `frame_train`'s losses within rtol 1e-5 and its
    gradients within 1e-4 of each tensor's largest."""
    from embodied_object_detection_tpu_torch.models.detector import (
        build_detector)
    from embodied_object_detection_tpu_torch.structures import GroundTruth
    cfg = miniature(res5_config(), 1)
    cfg = cfg.replace(centernet=dataclasses.replace(
        cfg.centernet, pre_nms_topk_train=64, post_nms_topk_train=16))
    rng = np.random.RandomState(20)
    image = rng.randint(0, 255, (64, 96, 3)).astype(np.float32)
    zs = random_zs(rng, cfg)
    g = cfg.input.max_gt_boxes
    boxes = np.zeros((g, 4), np.float32)
    boxes[:3] = [[16, 16, 90, 60], [4, 30, 40, 62], [50, 2, 70, 20]]
    gt = (boxes, np.array([2, 0, 4] + [0] * (g - 3), np.int32),
          np.arange(g) < 3)
    runs = {}
    for dev in ("cuda", "cpu"):
        model = build_detector(cfg, seed=3, device=dev)
        x = [torch.from_numpy(a).to(dev) for a in (image, zs)]
        dets = model.frame_step(*x).detections
        runs[dev] = (dets, weak_grads(model, lambda: (
            lambda losses: (sum(losses.values()), losses))(
            model.frame_train(*x, GroundTruth(*(torch.from_numpy(a).to(dev)
                                                for a in gt))))))
    n = hold_detections("phase 15 miniature", runs["cuda"][0],
                        runs["cpu"][0])
    wl, rel = hold_losses_grads("phase 15 miniature", runs["cuda"][1],
                                runs["cpu"][1], 1e-5)
    wg = max(rel.values())
    print(f"  Res5 at 64x96 f32: {n} detections held; losses within "
          f"{wl:.2e} relative (tolerance 1e-5), gradients within {wg:.2e} "
          f"of each tensor's largest (tolerance 1e-4)")
    phase(15, f"the Res5 miniature (64x96 f32) on the card matches the CPU: "
              f"{n} detections, losses within {wl:.2e}, gradients within "
              f"{wg:.2e}")


def swin_config(cfg=None, rate=0.2):
    """`cfg` (default: the default config) with the Swin-B trunk at
    stochastic-depth rate `rate`."""
    from embodied_object_detection_tpu_torch.config import DetectorConfig
    cfg = cfg or DetectorConfig()
    return cfg.replace(backbone=dataclasses.replace(
        cfg.backbone, name="swin_b", drop_path_rate=rate))


def run_swin_eval(profile_dir):
    """Phase 15b's eval frame: the default config with the Swin-B trunk
    (480x640, 8192 x 512 memory, bf16), a chunk of T_FRAMES frames through
    `make_episode_runner` with no host sync, as phase 5 runs it."""
    from embodied_object_detection_tpu_torch.models.detector import (
        build_detector, frame_inputs, make_episode_runner)
    from embodied_object_detection_tpu_torch.structures import MemoryState

    cfg = swin_config()
    model = build_detector(cfg, seed=0, device="cuda")
    h, w = cfg.input.height, cfg.input.width
    cells, dim = cfg.memory.max_cells, cfg.memory.memory_dim
    rng = np.random.RandomState(21)
    images = rng.randint(0, 255, (T_FRAMES, h, w, 3)).astype(np.float32)
    projs = rng.randint(0, cells, (T_FRAMES, h, w)).astype(np.int32)
    frames = frame_inputs(images, projs,
                          np.array([True] + [False] * (T_FRAMES - 1)), cells,
                          "cuda")
    zs = torch.from_numpy(random_zs(rng, cfg)).cuda()
    init = MemoryState.zeros(cells, dim, "cuda")
    run = make_episode_runner(model, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, counted_s, launches = counted_run(
        "swin_b", lambda: run(frames, zs, init), LAUNCHES_PER_FRAME,
        T_FRAMES)
    peak = torch.cuda.max_memory_allocated()
    check_episode("swin_b", out, (T_FRAMES,), cfg)
    chunk_s = [counted_s]
    for _ in range(2):
        t0 = time.perf_counter()
        run(frames, zs, out.memory)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
    per_frame = [s / T_FRAMES * 1e3 for s in chunk_s]
    events = profile_events(lambda: run(frames, zs, init))
    ops, busy, _ = device_busy(events)
    busy_ms = busy / 1e3 / T_FRAMES
    groups, _ = device_op_split(events, T_FRAMES)
    t0 = time.perf_counter()
    model.backbone_raw(frames.image)
    torch.cuda.synchronize()
    trunk_ms = (time.perf_counter() - t0) / T_FRAMES * 1e3
    print(f"  Swin-B eval frame: ms a frame over chunks of {T_FRAMES}: "
          f"{', '.join(f'{x:.2f}' for x in per_frame)}; device busy "
          f"{busy_ms:.2f} ms a frame ({ops // T_FRAMES} device ops a frame; "
          f"busy share {busy_ms / min(per_frame):.3f} of the best chunk), by "
          f"group {', '.join(f'{k} {v:.2f}' for k, v in groups.items())} "
          f"ms; batched trunk alone {trunk_ms:.2f} ms a frame; peak device "
          f"memory {peak / 2 ** 30:.2f} GiB; detections a frame "
          f"{out.detections.valid.sum(dim=1).tolist()}")
    if profile_dir:
        profile_run(lambda: run(frames, zs, init), Path(profile_dir),
                    "swin_chunk", T_FRAMES, "frame")
    return min(per_frame), busy_ms, peak


def check_swin_remat(zs):
    """Phase 15b's stochastic-depth check: one flagship step's batch loss
    at B = TRAIN_FRAMES, 480x640, in f32 (so that the two runs part only
    in the f32 atomics' order), with `backbone.train_remat` off and on and
    the coins drawn from one CUDA generator seed: the losses within rtol
    1e-6 and the gradients within 1e-4 of each tensor's largest. Returns
    (dropped coins of the draw, coins drawn, loss error, gradient
    error)."""
    from embodied_object_detection_tpu_torch.data.synthetic import (
        synthetic_batch_fn)
    from embodied_object_detection_tpu_torch.models.detector import (
        build_detector)
    from embodied_object_detection_tpu_torch.parallel.train_step import (
        batch_losses, batch_to_device)
    cfg = swin_config(train_config()).replace(compute_dtype="float32")
    batch = batch_to_device(synthetic_batch_fn(cfg, TRAIN_FRAMES)(
        0, np.random.RandomState(22), 1), "cuda")
    zs_d = torch.from_numpy(zs).cuda()
    runs = []
    dropped = drawn = None
    for remat in (False, True):
        c = cfg.replace(backbone=dataclasses.replace(cfg.backbone,
                                                     train_remat=remat))
        model = build_detector(c, seed=0, device="cuda")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(16)
        total, losses = batch_losses(model, c, batch, zs_d, 0, generator=gen)
        total.backward()
        runs.append(({k: float(v.detach()) for k, v in losses.items()},
                     {n: p.grad for n, p in model.named_parameters()
                      if p.grad is not None}))
        if dropped is None:
            gen.manual_seed(16)
            coins = model.drop_path_coins(TRAIN_FRAMES, gen)
            dropped, drawn = int((~coins).sum()), coins.numel()
        del model
    wl, rel = hold_losses_grads("phase 15b remat", runs[1], runs[0], 1e-6)
    wg = max(rel.values())
    return dropped, drawn, wl, wg


def run_swin_cotraining():
    """Phase 15b's co-training steps with the Swin-B trunk: one caption
    step and one max_size image-label step at B = COTRAIN_B from phase
    14b's stream (captions embedded by the text tower), launches counted,
    the coins drawn from each step's generator."""
    from embodied_object_detection_tpu_torch.models.detector import (
        build_detector)
    from embodied_object_detection_tpu_torch.parallel import train_step as ts
    cfg = swin_config(cotrain_config())
    batches, _ = cotraining_batches(cfg)
    model = build_detector(cfg, seed=0, device="cuda")
    zs = torch.from_numpy(random_zs(np.random.RandomState(15), cfg)).cuda()
    out = {}
    for label, kind, fn in (
            ("caption", "caption", ts.make_caption_train_step(model, cfg)),
            ("image max_size", "image", ts.make_image_label_train_step(
                model, cfg, "max_size"))):
        _, step = ts.make_loss_step(
            model, cfg, lambda st, *x, fn=fn: fn(*x, step=st))
        state = ts.TrainState(model=model, optimizer=ts.build_optimizer(
            model, cfg.solver), step=0)
        x = cotraining_inputs(kind, batches[kind][0], zs)
        step(state, *x)                       # warm-up
        torch.cuda.synchronize()
        zero_counters()
        t0 = time.perf_counter()
        state, losses = step(state, *x)
        total = float(losses["total_loss"])
        ms = (time.perf_counter() - t0) * 1e3
        launches = read_counters()
        expected = {k: COTRAIN_LAUNCHES[kind].get(k, 0) for k in launches}
        if launches != expected or not math.isfinite(total):
            raise AssertionError(f"phase 15b {label}: launches {launches} "
                                 f"(expected {expected}), loss {total}")
        syncs = sync_sites(lambda: step(state, *x))
        out[label] = (ms, sum(syncs.values()))
        print(f"  Swin-B {label} step at B = {COTRAIN_B}: loss {total:.4f}, "
              f"{ms:.1f} ms (host clock to the loss read), launches "
              f"{ {k: v for k, v in launches.items() if v} }, "
              f"{sum(syncs.values())} synchronising calls")
    return out


def check_swin_against_cpu():
    """Phase 15b's miniature: the Swin-B detector (full width, JAX's
    hard-coded trunk) at 64x96 f32, drop_path_rate 0, implicit memory,
    from the same seeded weights on the card and on the CPU: `frame_step`'s
    detections (`hold_detections`), `frame_train`'s losses (rtol 1e-4) and
    gradients (1e-4 of each tensor's largest), training top-k 64 -> 16."""
    from embodied_object_detection_tpu_torch.models.detector import (
        build_detector)
    from embodied_object_detection_tpu_torch.structures import GroundTruth
    cfg = miniature(swin_config(rate=0.0), 1)
    cfg = cfg.replace(centernet=dataclasses.replace(
        cfg.centernet, pre_nms_topk_train=64, post_nms_topk_train=16))
    rng = np.random.RandomState(23)
    h, w = 64, 96
    arrays = dict(
        image=rng.randint(0, 255, (h, w, 3)).astype(np.float32),
        zs=random_zs(rng, cfg),
        memf=rng.randn(64, 512).astype(np.float32),
        memo=rng.randint(0, 3, 64).astype(np.float32),
        proj=rng.randint(0, 64, (h, w)).astype(np.int32),
        outlier=np.zeros((h, w), bool))
    g = cfg.input.max_gt_boxes
    boxes = np.zeros((g, 4), np.float32)
    boxes[:2] = [[8, 8, 40, 40], [30, 10, 90, 60]]
    gt = (boxes, np.array([1, 3] + [0] * (g - 2), np.int32), np.arange(g) < 2)
    runs = {}
    for dev in ("cuda", "cpu"):
        model = build_detector(cfg, seed=3, device=dev)
        t = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
        dets = model.frame_step(t["image"], t["zs"], t["memf"], t["memo"],
                                t["proj"], t["outlier"]).detections
        runs[dev] = (dets, weak_grads(model, lambda: (
            lambda losses: (sum(losses.values()), losses))(
            model.frame_train(t["image"], t["zs"], t["memf"], t["memo"],
                              t["proj"], GroundTruth(*(
                                  torch.from_numpy(a).to(dev) for a in gt))))))
    n = hold_detections("phase 15b miniature", runs["cuda"][0],
                        runs["cpu"][0])
    wl, rel = hold_losses_grads("phase 15b miniature", runs["cuda"][1],
                                runs["cpu"][1], 1e-4)
    return n, wl, max(rel.values())


def run_swin(profile_dir):
    """Phase 15b: the Swin-B trunk's eval frame, TRAIN_STEPS flagship steps
    at B = TRAIN_FRAMES with drop_path_rate 0.2 under train_remat off and
    on (`train_steps`, as phase 8), the remat check, one caption and one
    image-label step, and the miniature against the CPU."""
    ms, busy_ms, peak = run_swin_eval(profile_dir)
    zs = random_zs(np.random.RandomState(8), train_config())
    summary = []
    for remat in (False, True):
        cfg = swin_config(train_config())
        cfg = cfg.replace(backbone=dataclasses.replace(cfg.backbone,
                                                       train_remat=remat))
        label = f"swin_b train_remat={remat}"
        _, step_ms, step_peak, syncs = train_steps(cfg, zs,
                                                   LAUNCHES_PER_STEP, label)
        summary.append(f"{label} {np.mean(step_ms[1:]):.1f} ms/step, peak "
                       f"{step_peak / 2 ** 30:.2f} GiB, "
                       f"{sum(syncs.values())} syncs a step")
    dropped, drawn, wl, wg = check_swin_remat(zs)
    print(f"  train_remat off and on from one coin seed ({dropped} of "
          f"{drawn} coins dropped), f32: losses within {wl:.2e} "
          f"(tolerance 1e-6), gradients within {wg:.2e} of each tensor's "
          f"largest (tolerance 1e-4)")
    co = run_swin_cotraining()
    n, cl, cg = check_swin_against_cpu()
    print(f"  Swin-B at 64x96 f32, rate 0: {n} detections held; losses "
          f"within {cl:.2e} (tolerance 1e-4), gradients within {cg:.2e} "
          f"(tolerance 1e-4)")
    phase("15b", f"Swin-B at 480x640 bf16: eval frame {ms:.2f} ms/frame (best "
                 f"chunk), busy {busy_ms:.2f} ms/frame, peak "
                 f"{peak / 2 ** 30:.2f} GiB, launches a frame "
                 f"{LAUNCHES_PER_FRAME}, no host sync; " + "; ".join(summary) +
          f"; remat equal within {wg:.2e} ({dropped} coins dropped); " +
          "; ".join(f"{k} {v[0]:.1f} ms, {v[1]} syncs" for k, v in co.items())
          + f"; the 64x96 miniature matches the CPU ({n} detections)")


def lvis_names():
    with open(LVIS_CATEGORIES) as f:
        return [c["name"] for c in json.load(f)]


def write_merges(path, texts, n=TEXT_MERGES):
    """A gzip BPE merges table in CLIP's format (a version line, then one
    "a b" pair a line): the `n` most frequent pair merges learned from
    the words of `texts`, ties broken by the pair's order."""
    import gzip
    words = collections.Counter()
    for t in texts:
        for w in re.findall(r"[a-z]+", t.lower()):
            words[tuple(w[:-1]) + (w[-1] + "</w>",)] += 1
    merges = []
    for _ in range(n):
        pairs = collections.Counter()
        for w, c in words.items():
            for a, b in zip(w, w[1:]):
                pairs[(a, b)] += c
        if not pairs:
            break
        best = max(pairs, key=lambda p: (pairs[p], p))
        merges.append(best)
        merged = collections.Counter()
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += c
        words = merged
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges))
    return path


def synthetic_clip_state_dict(seed=15, width=512, layers=12):
    """An openai CLIP text tower's state dict at CLIP-B's shapes (width
    512, 12 layers; the real weights are not in the repository), seeded,
    with CLIP's init scales and norms and biases off their identities."""
    rng = np.random.RandomState(seed)

    def normal(*shape, std):
        return (rng.randn(*shape) * std).astype(np.float32)

    w = width
    sd = {"token_embedding.weight": normal(49408, w, std=0.02),
          "positional_embedding": normal(77, w, std=0.01),
          "text_projection": normal(w, w, std=w ** -0.5),
          "ln_final.weight": 1 + normal(w, std=0.1),
          "ln_final.bias": normal(w, std=0.1)}
    proj_std = (2 * layers) ** -0.5 * w ** -0.5
    for i in range(layers):
        pre = f"transformer.resblocks.{i}"
        for ln in ("ln_1", "ln_2"):
            sd[f"{pre}.{ln}.weight"] = 1 + normal(w, std=0.1)
            sd[f"{pre}.{ln}.bias"] = normal(w, std=0.1)
        sd[f"{pre}.attn.in_proj_weight"] = normal(3 * w, w, std=w ** -0.5)
        sd[f"{pre}.attn.in_proj_bias"] = normal(3 * w, std=0.02)
        sd[f"{pre}.attn.out_proj.weight"] = normal(w, w, std=proj_std)
        sd[f"{pre}.attn.out_proj.bias"] = normal(w, std=0.02)
        sd[f"{pre}.mlp.c_fc.weight"] = normal(4 * w, w, std=(2 * w) ** -0.5)
        sd[f"{pre}.mlp.c_fc.bias"] = normal(4 * w, std=0.02)
        sd[f"{pre}.mlp.c_proj.weight"] = normal(w, 4 * w, std=proj_std)
        sd[f"{pre}.mlp.c_proj.bias"] = normal(w, std=0.02)
    return sd


def clip_text_encoder(device):
    """The CLIP text tower on `device` from `synthetic_clip_state_dict`
    and a merges table learned from the LVIS names, written to a
    temporary directory that is removed once the tokenizer has read
    it."""
    import tempfile
    from embodied_object_detection_tpu_torch.models.text_encoder import (
        CLIPTextEncoder, convert_clip_text_weights)
    with tempfile.TemporaryDirectory() as tmp:
        bpe = write_merges(Path(tmp) / "merges.txt.gz",
                           [n.replace("_", " ") for n in lvis_names()])
        return CLIPTextEncoder(
            convert_clip_text_weights(synthetic_clip_state_dict()),
            str(bpe), device=device)


def run_text_tower(res5_model, res5_cfg):
    """Phase 15c: the full-width CLIP text tower (512 wide, 12 layers, 8
    heads) from `clip_text_encoder`: the 1203 LVIS names with prompt "a "
    through `get_clip_embeddings` on the card and on the CPU, within 1e-5
    of each other and of unit norm; then `build_zs_weight` of the card's
    embeddings into one Res5 image (1203 classes)."""
    from embodied_object_detection_tpu_torch.demo.predictor import (
        build_zs_weight, get_clip_embeddings)
    names = lvis_names()
    card = clip_text_encoder("cuda")
    texts = ["a " + n.replace("_", " ") for n in names]
    t0 = time.perf_counter()
    tokens = card.tokenizer.tokenize(texts)
    tok_ms = (time.perf_counter() - t0) * 1e3
    card.embed_tokens(tokens[:8])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card.embed_tokens(tokens)
    torch.cuda.synchronize()
    tower_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    emb = get_clip_embeddings(names, text_encoder=card)
    vocab_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want = get_clip_embeddings(names, text_encoder=clip_text_encoder("cpu"))
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(emb - want).max())
    norm_err = float(np.abs(np.linalg.norm(emb, axis=-1) - 1).max())
    if emb.shape != (len(names), 512) or not err <= 1e-5 or \
            not norm_err <= 1e-5:
        raise AssertionError(f"phase 15c: embeddings {emb.shape}, card vs "
                             f"CPU {err}, norms off by {norm_err}")
    zs = torch.from_numpy(build_zs_weight(emb)).cuda()
    rng = np.random.RandomState(24)
    image = torch.from_numpy(rng.randint(0, 255, (480, 640, 3)).astype(
        np.float32)).cuda()
    zero_counters()
    dets = res5_model.frame_step(image, zs).detections
    launches = read_counters()
    n = int(dets.valid.sum())
    classes = sorted(set(dets.classes[dets.valid].tolist()))
    if launches != {k: RES5_LAUNCHES_PER_IMAGE.get(k, 0) for k in launches} \
            or not bool(torch.isfinite(dets.scores).all()) or \
            (classes and classes[-1] >= len(names)):
        raise AssertionError(f"phase 15c: launches {launches}, {n} "
                             f"detections of classes {classes[-5:]}")
    print(f"  text tower on {len(names)} LVIS names: tokenizing "
          f"{tok_ms:.1f} ms (host), the tower {tower_ms:.1f} ms on the card "
          f"({tokens.shape[1]} positions, 256 names a forward), "
          f"get_clip_embeddings {vocab_ms:.1f} ms end to end; the CPU's "
          f"{cpu_s:.1f} s; card vs CPU max err {err:.2e}, norms within "
          f"{norm_err:.2e} of 1; one Res5 image on the {len(names)}-class "
          f"zs_weight: {n} detections of {len(classes)} classes, launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    phase("15c", f"CLIP text tower (512 wide, 12 layers, 8 heads, synthesised "
                 f"weights and merges): {len(names)} LVIS names in "
                 f"{vocab_ms:.1f} ms on the card, within {err:.2e} of the "
                 f"CPU; build_zs_weight into a Res5 image ({n} detections); "
                 f"phase 14b's caption and captiontag batches were embedded "
                 f"by this tower")


# ------------------------------------------------------------ phase 16

PAR_LANES, PAR_FRAMES = 2, 4           # (a): lanes x frames
PAR_SCENES, PAR_CHUNKS, PAR_CHUNK_FRAMES = 2, 2, 8     # (b)
BUILD_FRAMES = 20                      # (d)


def free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def lane_of(out, i):
    """Lane i of a batched EpisodeOutputs."""
    from embodied_object_detection_tpu_torch.structures import (
        Detections, MemoryState)
    return (Detections(*(x[i] for x in out.detections)),
            MemoryState(*(x[i] for x in out.memory)),
            MemoryState(*(x[i] for x in out.first_memory)),
            out.any_detection[i])


TRUNK_RTOL = 2e-2      # a lane's trunk features against its own trunk's
MEMORY_RTOL = 1e-5     # a written memory row against the reference step's


class Step(NamedTuple):
    t: int
    frame: object          # FrameInputs of one frame
    carry: object          # the _Stream carried in
    feats: tuple           # the trunk's (C3, C4, C5) of this frame
    new: object            # the _Stream carried out
    out: object            # FrameOutputs


class StepLog:
    """Every `_stream_step` the episode runners take while the log is
    open, in call order: a runner call's frames in order, its lanes in
    order within each frame."""

    def __enter__(self):
        from embodied_object_detection_tpu_torch.models import detector
        self.module, self.real, self.steps = detector, \
            detector._stream_step, []

        def step(model, cfg, frame, zs, carry, zeros, t, feats):
            new, out = self.real(model, cfg, frame, zs, carry, zeros, t,
                                 feats)
            self.steps.append(Step(t, frame, carry, feats, new, out))
            return new, out

        detector._stream_step = step
        return self

    def __exit__(self, *exc):
        self.module._stream_step = self.real

    def runs(self):
        """The steps as runs[call][lane][frame]."""
        calls = []
        for st in self.steps:
            if st.t == 0 and (not calls or calls[-1][-1].t != 0):
                calls.append([])
            calls[-1].append(st)
        return [[c[i::sum(st.t == 0 for st in c)]
                 for i in range(sum(st.t == 0 for st in c))] for c in calls]


def hold_steps(name, model, cfg, zs, lanes, inits):
    """One runner call's lanes (`StepLog.runs()[k]`), each held to the
    same work done lane by lane:
    - the lane's trunk features (its rows of the trunk over every lane's
      frames) within TRUNK_RTOL of each level's largest value in the
      lane's own trunk (`backbone_raw` over its frames, as the single
      runner and the serial protocol run it);
    - frame 0 carries in `inits[i]` and every later frame the memory the
      frame before carried out, bit-equal;
    - each frame's detections and any_detection bit-equal to the
      external-feature runner's on that frame alone, fed the lane's
      features and the memory it carried in; the memory it carried out
      within MEMORY_RTOL of that run's, each cell's row against its
      largest value (the segment-sum's atomics sum in any order), its
      observation counts equal.
    Returns (the worst trunk error, the worst memory error)."""
    from embodied_object_detection_tpu_torch.models.detector import (
        FrameInputs, make_episode_runner)
    ref = make_episode_runner(model, cfg, precompute_backbone="external")
    trunk_err = mem_err = 0.0
    for i, steps in enumerate(lanes):
        with torch.no_grad():
            own = model.backbone_raw(torch.stack([st.frame.image
                                                  for st in steps]))
        for lvl, want in enumerate(own):
            got = torch.stack([st.feats[lvl] for st in steps]).float()
            want = want.float()
            trunk_err = max(trunk_err, float((got - want).abs().max() /
                                             want.abs().max()))
        carried = inits[i]
        for st in steps:
            if not all(torch.equal(x, y) for x, y in zip(st.carry.live,
                                                         carried)):
                raise AssertionError(f"{name} lane {i} frame {st.t}: read "
                                     "another memory than it carried")
            one = ref(FrameInputs(*(None if x is None else x[None]
                                    for x in st.frame)), zs, st.carry.live,
                      tuple(f[None] for f in st.feats))
            if not (all(torch.equal(x[0], y) for x, y in
                        zip(one.detections, st.out.detections)) and
                    torch.equal(one.any_detection[0],
                                st.out.write.any_detection)):
                raise AssertionError(f"{name} lane {i} frame {st.t}: "
                                     "detections differ from the frame "
                                     "run alone on the lane's inputs")
            got, want = st.new.live, one.memory
            if not torch.equal(got.obs_count, want.obs_count):
                raise AssertionError(f"{name} lane {i} frame {st.t}: "
                                     "observation counts")
            scale = want.features.abs().amax(1).clamp(min=1e-30)
            err = float(((got.features - want.features).abs().amax(1) /
                         scale).max())
            if not err <= MEMORY_RTOL:
                raise AssertionError(f"{name} lane {i} frame {st.t}: "
                                     f"memory {err:.2e} off")
            mem_err = max(mem_err, err)
            carried = got
    if not trunk_err <= TRUNK_RTOL:
        raise AssertionError(f"{name}: trunk features {trunk_err:.2e} off "
                             "the lanes' own trunks")
    return trunk_err, mem_err


def frame_dets(d, t):
    v = d.valid[t]
    return (d.boxes[t][v].float().cpu().numpy(),
            d.scores[t][v].float().cpu().numpy(),
            d.classes[t][v].cpu().numpy())


def run_sharded_runner(mesh):
    """Phase 16a: the sharded runner over a one-rank NCCL mesh at the
    default config (480x640, bf16), 2 lanes x 4 frames, random ids; lane
    0 resets at frame 0, lane 1 starts from a random memory and resets at
    frame 2. Launches counted and no host sync under the sync debug mode
    "error" (`counted_run`); every lane-frame of the counted run held to
    the same work done lane by lane (`hold_steps`); the lanes' outputs
    those of their last steps. Then the runner (one trunk over the B x T
    frames) timed against the lanes run one by one through the single
    runner (a trunk a lane), in the order ABBA, three times."""
    from embodied_object_detection_tpu_torch.config import DetectorConfig
    from embodied_object_detection_tpu_torch.models.detector import (
        build_detector, frame_inputs, make_episode_runner)
    from embodied_object_detection_tpu_torch.parallel.eval_step import (
        make_sharded_episode_runner)
    from embodied_object_detection_tpu_torch.structures import MemoryState

    cfg = DetectorConfig()
    model = build_detector(cfg, seed=0, device="cuda")
    h, w = cfg.input.height, cfg.input.width
    cells, dim = cfg.memory.max_cells, cfg.memory.memory_dim
    rng = np.random.RandomState(16)
    b, t = PAR_LANES, PAR_FRAMES
    images = rng.randint(0, 255, (b, t, h, w, 3)).astype(np.float32)
    projs = rng.randint(0, cells, (b, t, h, w)).astype(np.int32)
    resets = np.zeros((b, t), bool)
    resets[0, 0] = resets[1, 2] = True
    frames = frame_inputs(images, projs, resets, cells, "cuda",
                          episode_start=resets)
    mem = MemoryState(
        torch.from_numpy(np.stack([np.zeros((cells, dim), np.float32),
                                   rng.randn(cells, dim).astype(
                                       np.float32) * 4])).cuda(),
        torch.from_numpy(np.stack([np.zeros(cells, np.float32),
                                   rng.randint(0, 3, cells).astype(
                                       np.float32)])).cuda())
    zs = torch.from_numpy(random_zs(rng, cfg)).cuda()
    run = make_sharded_episode_runner(model, cfg, mesh)
    with StepLog() as log:
        out, secs, launches = counted_run(
            f"sharded runner ({b} lanes x {t} frames)",
            lambda: run(frames, zs, mem), LAUNCHES_PER_FRAME, b * t)
    check_episode("sharded runner", out, (b, t), cfg)
    lanes = log.runs()[-1]
    inits = [MemoryState(*(x[i] for x in mem)) for i in range(b)]
    trunk_err, mem_err = hold_steps("phase 16a", model, cfg, zs, lanes,
                                    inits)
    for i, steps in enumerate(lanes):
        ends = (steps[-1].new.live, steps[0].new.live)
        if not all(torch.equal(x[i], y) for m, e in zip(
                (out.memory, out.first_memory), ends)
                for x, y in zip(m, e)) or not all(
                torch.equal(x[i][k], y) for k, st in enumerate(steps)
                for x, y in zip(out.detections, st.out.detections)):
            raise AssertionError(f"phase 16a lane {i}: the outputs are not "
                                 "its steps'")

    # the two designs, in one call: the batched trunk against a trunk a lane
    single = make_episode_runner(model, cfg)
    mine = [frames._replace(**{k: None if v is None else v[i]
                               for k, v in frames._asdict().items()})
            for i in range(b)]
    designs = {"batched": lambda: run(frames, zs, mem),
               "lane by lane": lambda: [single(mine[i], zs, inits[i])
                                        for i in range(b)]}
    times = {k: [] for k in designs}
    for _ in range(3):
        for k in ("batched", "lane by lane", "lane by lane", "batched"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            designs[k]()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) / (b * t) * 1e3)
    ms = {k: float(np.median(v)) for k, v in times.items()}
    print(f"  16a: {b} lanes x {t} frames, every lane-frame bit-equal to "
          f"the frame run alone on the lane's features and carried "
          f"memory, the memory it wrote within {mem_err:.2e} of that "
          f"run's (row-wise), the lanes' trunk rows within "
          f"{trunk_err:.2e} of their own trunks; ms a lane-frame (median "
          f"of 6, ABBA): one trunk over the {b * t} frames "
          f"{ms['batched']:.2f} ({', '.join(f'{x:.2f}' for x in times['batched'])}), "
          f"a trunk a lane {ms['lane by lane']:.2f} "
          f"({', '.join(f'{x:.2f}' for x in times['lane by lane'])}); "
          f"counted run {secs / (b * t) * 1e3:.2f}")
    return launches, ms["batched"], ms["lane by lane"]


class LaneEpisodes:
    """Phase 10's in-memory synthetic chunks, cut to fit; with a class
    table, as a semantic_gt dataset: each chunk carries the table and its
    pixels' ids index it (as phase 5b makes them)."""

    def __init__(self, cfg, table=None):
        from embodied_object_detection_tpu_torch.data.synthetic import (
            SyntheticEpisodes)
        self.inner = SyntheticEpisodes(
            max_sequence_length=PAR_CHUNK_FRAMES,
            max_gt=cfg.input.max_gt_boxes, num_scenes=PAR_SCENES,
            chunks_per_scene=PAR_CHUNKS, frames=PAR_CHUNK_FRAMES,
            height=cfg.input.height, width=cfg.input.width,
            map_h=EVAL_MAP[0], map_w=EVAL_MAP[1], seed=0)
        self.files = self.inner.files
        self.table = table
        self.cache = {}

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, i):
        if i not in self.cache:
            chunk = self.inner[i]
            if self.table is not None:
                chunk = dataclasses.replace(
                    chunk, proj_indices=chunk.proj_indices %
                    self.table.shape[0], memory_features=self.table)
            self.cache[i] = chunk
        return self.cache[i]


def recorded_eval(fn):
    """(EvalResults, {image id: (boxes, scores, classes)}) of fn() with
    the evaluator recording what it is fed."""
    from embodied_object_detection_tpu_torch.engine import eval as ev
    log = {}
    base = ev.COCOEvaluator

    class Recorder(base):
        def add_detections(self, image_id, boxes, scores, classes):
            log[int(image_id)] = (np.asarray(boxes), np.asarray(scores),
                                  np.asarray(classes))
            return super().add_detections(image_id, boxes, scores, classes)

    ev.COCOEvaluator = Recorder
    try:
        res = fn()
    finally:
        ev.COCOEvaluator = base
    return res, log


def run_sharded_eval(mesh):
    """Phase 16b: `evaluate_dataset_sharded` over 2 streams (the scenes of
    phase 10's synthetic chunks, cut to 2 scenes x 2 chunks x 8 frames)
    beside `evaluate_dataset` over the same chunks, at the default config,
    implicit memory and semantic_gt. Launches a frame as phase 5's (5b's
    for semantic_gt); the same images as the serial protocol; every
    lane-frame held to the same work done lane by lane (`hold_steps`),
    each lane's first step carrying in the memory its last step carried
    out (zeros at the start; the class table for semantic_gt, never
    written); each image fed to the evaluator the detections of its lane's
    frame. The AP of both protocols is printed, not held: seeded
    weights give it no meaning. Frames/s: serial, sharded, sharded,
    serial."""
    from embodied_object_detection_tpu_torch.config import DetectorConfig
    from embodied_object_detection_tpu_torch.demo.predictor import (
        load_zs_weight_npy)
    from embodied_object_detection_tpu_torch.engine.eval import (
        evaluate_dataset, evaluate_dataset_sharded, external_memory_state,
        partition_lanes)
    from embodied_object_detection_tpu_torch.models.detector import (
        build_detector)
    from embodied_object_detection_tpu_torch.structures import MemoryState

    base = DetectorConfig()
    zs = load_zs_weight_npy(str(REPO / "embodied_object_detection_tpu_torch"
                                / "data" / "metadata" / "mp3d_clip.npy"))
    zs_t = torch.from_numpy(np.asarray(zs, np.float32)).cuda()
    table = np.concatenate([np.zeros((1, 512), np.float32),
                            zs[:, :-1].T.astype(np.float32)])
    lines = []
    for mode in ("semantic_gt", "implicit"):
        cfg = base if mode == "implicit" else base.replace(
            memory=dataclasses.replace(base.memory, memory_type=mode))
        model = build_detector(cfg, seed=0, device="cuda")
        ds = LaneEpisodes(cfg, table if mode == "semantic_gt" else None)

        def serial_eval():
            return evaluate_dataset(model, cfg, ds, zs, verbose=False,
                                    num_workers=2)

        def sharded_eval():
            return evaluate_dataset_sharded(model, cfg, ds, zs, mesh=mesh,
                                            streams=2, verbose=False,
                                            num_workers=2)

        serial, s_dets = recorded_eval(serial_eval)
        zero_counters()
        with StepLog() as log:
            sharded, p_dets = recorded_eval(sharded_eval)
        launches = read_counters()
        frames = len(ds) * PAR_CHUNK_FRAMES
        per = LAUNCHES_PER_FRAME if mode == "implicit" else \
            LAUNCHES_PER_FRAME_EXTERNAL
        if launches != {k: per.get(k, 0) * frames for k in launches}:
            raise AssertionError(f"phase 16b {mode}: launches {launches}")
        if sharded.num_images != serial.num_images or \
                sorted(p_dets) != sorted(s_dets) or \
                sharded.timing["streams"] != 2.0:
            raise AssertionError(f"phase 16b {mode}: images "
                                 f"{sharded.num_images} vs "
                                 f"{serial.num_images}")
        runs = log.runs()
        lanes = partition_lanes(ds.files, 2)
        if len(runs) != max(len(x) for x in lanes):
            raise AssertionError(f"phase 16b {mode}: {len(runs)} runner "
                                 "calls")
        if cfg.memory.external_memory():
            fixed = external_memory_state(ds[0], cfg, device="cuda")
            inits = [fixed] * 2
        else:
            inits = [MemoryState.zeros(cfg.memory.max_cells,
                                       cfg.memory.memory_dim, "cuda")] * 2
        trunk_err = mem_err = 0.0
        for j, run_lanes in enumerate(runs):
            te, me = hold_steps(f"phase 16b {mode} step {j}", model, cfg,
                                zs_t, run_lanes, inits)
            trunk_err, mem_err = max(trunk_err, te), max(mem_err, me)
            if not cfg.memory.external_memory():
                inits = [steps[-1].new.live for steps in run_lanes]
        im_id = 0
        for idx in range(len(ds)):
            i = next(k for k, lane in enumerate(lanes) if idx in lane)
            steps = runs[lanes[i].index(idx)][i]
            for t in range(0, PAR_CHUNK_FRAMES, cfg.input.score_every):
                if not ds[idx].frame_valid[t]:
                    continue
                d = steps[t].out.detections
                want = (d.boxes[d.valid].float().cpu().numpy(),
                        d.scores[d.valid].float().cpu().numpy(),
                        d.classes[d.valid].cpu().numpy())
                if not all(np.array_equal(x, y) for x, y in
                           zip(p_dets[im_id], want)):
                    raise AssertionError(f"phase 16b {mode}: image {im_id} "
                                         "is not its lane's frame")
                im_id += 1
        # the two protocols timed in one call, unlogged
        again = sharded_eval()
        serial2 = serial_eval()
        fps = [serial.timing["frames_per_s"],
               sharded.timing["frames_per_s"],
               again.timing["frames_per_s"],
               serial2.timing["frames_per_s"]]
        lines.append(
            f"{mode}: frames/s serial {fps[0]:.2f}, sharded {fps[1]:.2f} "
            f"(logged), {fps[2]:.2f}, serial {fps[3]:.2f}; AP sharded "
            f"{sharded.overall['AP']:.4f}, serial "
            f"{serial.overall['AP']:.4f} (seeded weights, not held)")
        print(f"  16b {lines[-1]}; {sharded.num_images} images, each its "
              f"lane's frame; every lane-frame bit-equal to the frame run "
              f"alone on the lane's inputs, memory within {mem_err:.2e}, "
              f"trunk rows within {trunk_err:.2e} of the lanes' own; "
              f"launches { {k: v for k, v in launches.items() if v} }")
        del model
    return lines


def run_dp_steps(mesh):
    """Phase 16c: the data-parallel steps at world size 1 (a one-rank
    all-reduce is the identity): 2 flagship steps at B = 4 and one caption
    step through `make_train_step` / `make_loss_step` with the mesh. Each
    step's losses bit-equal to the plain step's (no mesh) from the same
    state on the same batch; its gradients after the all-reduce
    bit-equal to before it; its parameters bit-equal to the plain
    optimizer's update from the same state and gradients (the ROIAlign
    backward's REDs sum in any order, so two backward passes need not
    give the same bits). Launches a DP flagship step as phase 8's; ms a
    step, DP and plain."""
    from embodied_object_detection_tpu_torch.data.synthetic import (
        synthetic_train_batch)
    from embodied_object_detection_tpu_torch.engine.solver import (
        build_optimizer)
    from embodied_object_detection_tpu_torch.models.detector import (
        build_detector)
    from embodied_object_detection_tpu_torch.parallel import train_step as ts

    cfg = train_config()
    zs = torch.from_numpy(random_zs(np.random.RandomState(8), cfg)).cuda()
    model = build_detector(cfg, seed=0, device="cuda")
    twin = build_detector(cfg, seed=0, device="cuda")
    reduced = []
    real = ts.all_reduce_gradients

    def spy(params, group):
        if group is None:           # the plain step
            return real(params, group)
        before = [None if p.grad is None else p.grad.clone()
                  for p in params]
        real(params, group)
        # a missing gradient goes in as zeros
        reduced.append(all(torch.equal(
            torch.zeros_like(p) if b is None else b, p.grad)
            for b, p in zip(before, params) if p.requires_grad))

    ts.all_reduce_gradients = spy
    try:
        init, dp_step = ts.make_train_step(model, cfg, mesh=mesh)
        state = ts.replicate_state(mesh, init())
        launches = collections.Counter()
        checks = []
        cap_rng = np.random.RandomState(17)
        h, w = cfg.input.height, cfg.input.width
        caption = (
            torch.from_numpy(cap_rng.randint(0, 255, (TRAIN_FRAMES, h, w, 3))
                             .astype(np.float32)).cuda(),
            torch.from_numpy(cap_rng.randn(TRAIN_FRAMES, 512)
                             .astype(np.float32)).cuda(),
            torch.tensor([1.0, 1.0, 0.0, 1.0], device="cuda"))
        for k in range(3):
            snap = copy.deepcopy(model.state_dict())
            opt_snap = copy.deepcopy(state.optimizer.state_dict())
            if k < 2:
                batch = ts.batch_to_device(synthetic_train_batch(
                    cfg, np.random.RandomState(30 + k), TRAIN_FRAMES, 3),
                    "cuda")
                zero_counters()
                state, got = dp_step(state, batch, zs)
                torch.cuda.synchronize()
                launches.update(read_counters())
                fn = ts.make_train_step(twin, cfg)[1]
                plain_inputs = (batch, zs)
            else:
                cap_fn = ts.make_caption_train_step(model, cfg, mesh=mesh)
                init_c, cap_step = ts.make_loss_step(
                    model, cfg, lambda st, *x: cap_fn(*x, step=st),
                    state.optimizer, mesh)
                state, got = cap_step(state, *caption)
                tcap = ts.make_caption_train_step(twin, cfg)
                fn = ts.make_loss_step(twin, cfg,
                                       lambda st, *x: tcap(*x, step=st))[1]
                plain_inputs = caption
            grads = {n: None if p.grad is None else p.grad.clone()
                     for n, p in model.named_parameters()}
            # the plain step from the same state: its losses
            twin.load_state_dict(snap)
            topt = build_optimizer(twin, cfg.solver)
            topt.load_state_dict(opt_snap)
            _, want = fn(ts.TrainState(twin, topt, k), *plain_inputs)
            same_losses = sorted(got) == sorted(want) and all(
                torch.equal(got[n], want[n]) for n in want)
            # the plain optimizer on the DP step's gradients
            twin.load_state_dict(snap)
            topt.load_state_dict(opt_snap)
            for n, p in twin.named_parameters():
                p.grad = grads[n]
            topt.step()
            same_params = all(torch.equal(a, b) for a, b in zip(
                model.parameters(), twin.parameters()))
            checks.append((same_losses, same_params))
            if not (same_losses and same_params and reduced[-1]):
                raise AssertionError(f"phase 16c step {k}: losses equal "
                                     f"{same_losses}, parameters equal "
                                     f"{same_params}, all-reduce identity "
                                     f"{reduced[-1]}")
    finally:
        ts.all_reduce_gradients = real
    per_step = {k: v // 2 for k, v in launches.items()}
    if any(per_step[k] != LAUNCHES_PER_STEP.get(k, 0) for k in per_step):
        raise AssertionError(f"phase 16c: launches a step {per_step}")

    def time_steps(step_fn, st, n=3):
        out = []
        for i in range(n):
            batch = ts.batch_to_device(synthetic_train_batch(
                cfg, np.random.RandomState(40 + i), TRAIN_FRAMES, 3), "cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, _ = step_fn(st, batch, zs)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    dp_ms = time_steps(dp_step, state)
    plain_init, plain_step = ts.make_train_step(twin, cfg)
    plain_ms = time_steps(plain_step, plain_init())
    print(f"  16c: 2 flagship steps and 1 caption step at world size 1: "
          f"losses, reduced gradients and parameters bit-equal to the "
          f"plain steps'; launches a flagship step "
          f"{ {k: v for k, v in per_step.items() if v} }; ms a step (host "
          f"clock, synchronised): DP {', '.join(f'{x:.1f}' for x in dp_ms)}"
          f"; plain {', '.join(f'{x:.1f}' for x in plain_ms)}")
    return per_step, float(np.mean(dp_ms[1:])), float(np.mean(plain_ms[1:]))


def run_build_tools():
    """Phase 16d: the dataset build tools' device part, without h5: the
    world xyz of 20 frames at 480x640 (depth in [0.3, 9.5] m, a turning
    and tilting camera path in quaternions, habitat's depth scale) and
    their map cells at 0.2 m, on the card and on the CPU; xyz within
    1e-5 m, cell ids equal or each differing pixel's cell coordinate
    within 1e-5 m of a rounding boundary on both devices."""
    from embodied_object_detection_tpu_torch.data.build_data import (
        world_xyz)
    from embodied_object_detection_tpu_torch.data.build_memory import (
        world_to_proj_indices)
    rng = np.random.RandomState(18)
    n, h, w = BUILD_FRAMES, 480, 640
    depth = rng.uniform(0.03, 0.95, (n, h, w)).astype(np.float32)
    heading = np.linspace(0.0, 2.5, n)
    rot = np.stack([0.05 * np.sin(heading), np.sin(heading / 2),
                    np.zeros(n), np.cos(heading / 2)], 1)
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    pos = np.stack([np.linspace(0, 3, n), np.full(n, 1.25),
                    np.linspace(0, -2, n)], 1)
    world_xyz(depth[:2], pos[:2], rot[:2], depth_scale=10.0, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = world_xyz(depth, pos, rot, depth_scale=10.0, device="cuda")
    xyz_ms = (time.perf_counter() - t0) / n * 1e3
    cpu = world_xyz(depth, pos, rot, depth_scale=10.0, device="cpu")
    err = float(np.abs(card - cpu).max())
    shift = cpu.reshape(-1, 3).min(0)
    extent = cpu.reshape(-1, 3).max(0) - shift
    mw = int(np.ceil(extent[0] / 0.2)) + 1
    mh = int(np.ceil(extent[2] / 0.2)) + 1
    card_t = torch.from_numpy(card).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids_card = world_to_proj_indices(card_t, shift, 0.2, mw, mh)
    torch.cuda.synchronize()
    ids_ms = (time.perf_counter() - t0) / n * 1e3
    ids_card = ids_card.cpu().numpy()
    ids_cpu = world_to_proj_indices(torch.from_numpy(cpu), shift, 0.2, mw,
                                    mh).numpy()
    bad = np.nonzero(ids_card.reshape(-1) != ids_cpu.reshape(-1))[0]
    for i in bad:
        ok = False
        for axis in (0, 2):
            vs = [(x.reshape(-1, 3)[i, axis] - shift[axis]) / 0.2
                  for x in (card, cpu)]
            if np.round(vs[0]) != np.round(vs[1]):
                ok |= max(abs(v - np.floor(v) - 0.5) * 0.2
                          for v in vs) <= 1e-5
        if not ok:
            raise AssertionError(f"phase 16d: pixel {i}'s cell differs away "
                                 "from a rounding boundary")
    if not err <= 1e-5:
        raise AssertionError(f"phase 16d: xyz card vs CPU {err}")
    print(f"  16d: world xyz of {n} frames at {h}x{w} on the card within "
          f"{err:.2e} m of the CPU; {len(bad)} of {ids_cpu.size} pixels' "
          f"cells differ, each at a rounding boundary; {mw} x {mh} cells; "
          f"xyz {xyz_ms:.2f} ms a frame (host to host, the copies "
          f"included), cell ids {ids_ms:.3f} ms a frame on the card")
    return err, len(bad), xyz_ms


def run_parallel():
    """Phase 16: the parallel paths on a one-rank NCCL process group
    (`parallel/mesh.py:init_distributed` at tcp://127.0.0.1:<free port>),
    so that their collectives run on the card, and the dataset build
    tools' device part."""
    import torch.distributed as dist
    from embodied_object_detection_tpu_torch.config import ParallelConfig
    from embodied_object_detection_tpu_torch.parallel.mesh import (
        init_distributed, make_mesh)
    t0 = time.perf_counter()
    rank, world = init_distributed(f"127.0.0.1:{free_port()}", "cuda",
                                   timeout_s=120)
    try:
        mesh = make_mesh(ParallelConfig())
        if (rank, world, dist.get_backend()) != (0, 1, "nccl") or \
                mesh.data_group is None:
            raise AssertionError(f"phase 16: rank {rank} of {world}, "
                                 f"{dist.get_backend()}")
        launches, lane_ms, lane_by_lane_ms = run_sharded_runner(mesh)
        eval_lines = run_sharded_eval(mesh)
        step_launches, dp_ms, plain_ms = run_dp_steps(mesh)
    finally:
        dist.destroy_process_group()
    err, flipped, xyz_ms = run_build_tools()
    phase(16, f"parallel paths on a one-rank NCCL group: the sharded "
              f"runner ({PAR_LANES} lanes, {lane_ms:.2f} ms a lane-frame "
              f"against {lane_by_lane_ms:.2f} lane by lane, "
              f"launches a lane-frame {LAUNCHES_PER_FRAME}, no host sync), "
              f"evaluate_dataset_sharded ({'; '.join(eval_lines)}), the "
              f"DP steps bit-equal to the plain ones ({dp_ms:.1f} vs "
              f"{plain_ms:.1f} ms a flagship step), the build tools' xyz "
              f"within {err:.1e} m ({flipped} boundary cells, {xyz_ms:.2f} "
              f"ms a frame); {time.perf_counter() - t0:.1f} s")
    return launches, step_launches


# ------------------------------------------------------------- phase 17: RL

RL_ENVS, RL_STEPS, RL_UPDATES = 4, 64, 3    # the RL CLI's defaults
RL_HIDDEN = 512                             # the policy's published width
RL_HW = (64, 64)
SLAM_HW = (228, 304)                        # MonoDepth's input
SLAM_MIN_STEPS = 20
PARAM_RTOL = 1e-5       # card vs CPU: a tensor's parameters after an update
POLICY_ATOL = 1e-4      # card vs CPU: values, log-probs, hidden, entropy
DELTA_RTOL = 1e-4       # card vs CPU: an update p_new - p_old, of its largest
DEPTH_RTOL = 1e-4       # card vs CPU: MonoDepth's depth less the last
                        # convolution's bias, of its own largest magnitude


TF32_OPS = ("convolution", "convolution_backward", "mm", "addmm", "bmm",
            "baddbmm")


def tf32_flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def set_tf32(flags):
    torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32 = flags


def tf32_held_off(label, fn):
    """fn() with TF32 switched on by the caller (phase 17 keeps it on, as
    a caller that wants it for its own models would): each convolution
    and matrix product fn runs, backward included, must see both flags
    off (the RL paths never pass through `build_detector`, and switch
    TF32 off for their own calls), and the caller's flags must be back on
    when fn returns. -> (fn's result, the products seen)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    seen = []

    class Probe(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in TF32_OPS:
                seen.append((name, tf32_flags()))
            return func(*args, **(kwargs or {}))

    saved = tf32_flags()
    set_tf32((True, True))
    try:
        with Probe():
            out = fn()
        torch.cuda.synchronize()
        after = tf32_flags()
    finally:
        set_tf32(saved)
    on = sorted({name for name, flags in seen if any(flags)})
    if not seen or on or after != (True, True):
        raise AssertionError(f"{label}: {len(seen)} products, TF32 on in "
                             f"{on}, caller's flags {after} after the call "
                             "(wanted (True, True))")
    return out, len(seen)


def rl_env_fn(i, rgb_hw=RL_HW, steps=100, scene=None):
    from embodied_object_detection_tpu_torch.rl.nav import make_nav_rl_env
    return make_nav_rl_env(scene_ids=(scene or f"scene{i % 4}",),
                           episodes_per_scene=8, seed=i,
                           max_episode_steps=steps, with_rgb=True,
                           image_hw=rgb_hw)


def no_kernel_launched(label):
    launched = {k: v for k, v in read_counters().items() if v}
    if launched:
        raise AssertionError(f"{label} launched port kernels: {launched}")


def hold_params(label, card, cpu, rtol=PARAM_RTOL):
    """Each card tensor within `rtol` of the CPU tensor's largest
    magnitude; returns the largest such relative error."""
    worst = 0.0
    for k, c in cpu.items():
        err = float((card[k].cpu() - c).abs().max())
        scale = max(float(c.abs().max()), 1e-30)
        if not err <= rtol * scale:
            raise AssertionError(f"{label}: {k} differs by {err:.3e} "
                                 f"(largest {scale:.3e}, rtol {rtol:g})")
        worst = max(worst, err / scale)
    return worst


def ppo_update_on(device, policy, ppo_state, cfg, batch, mb_indices):
    """One PPO update of a copy of `policy` on `device` from `ppo_state`
    (the Adam moments, counts) -> (parameters, metrics)."""
    from embodied_object_detection_tpu_torch.rl.ppo import PPO
    pol = copy.deepcopy(policy).to(device)
    ppo = PPO(pol, cfg)
    ppo.load_state_dict(ppo_state)
    metrics = ppo.update({k: ({kk: vv.to(device) for kk, vv in v.items()}
                              if isinstance(v, dict) else v.to(device))
                          for k, v in batch.items()},
                         mb_indices=mb_indices.to(device))
    return ({k: v.detach().cpu() for k, v in pol.state_dict().items()},
            {k: float(v) for k, v in metrics.items()})


def run_rl_trainer():
    """Phase 17a: the RGB PointNav policy at hidden 512 on 64x64 frames,
    trained by `rl/trainer.py:PPOTrainer` at the CLI's defaults (4 envs x
    64 steps, ppo_epoch 2, num_mini_batch 2) for 3 updates; then one
    update held card against CPU."""
    from embodied_object_detection_tpu_torch.rl.ppo import (
        PPOConfig, minibatch_indices)
    from embodied_object_detection_tpu_torch.rl.trainer import (
        PPOTrainer, PPOTrainerConfig)
    cfg = PPOTrainerConfig(num_envs=RL_ENVS, num_steps=RL_STEPS,
                           num_updates=RL_UPDATES, hidden_size=RL_HIDDEN,
                           with_rgb=True,
                           ppo=PPOConfig(ppo_epoch=2, num_mini_batch=2))
    t0 = time.perf_counter()
    trainer = PPOTrainer(cfg, rl_env_fn, device="cuda")
    setup_s = time.perf_counter() - t0
    step_s, update_ms = [], []
    collect, update = trainer._collect_rollout_step, trainer.ppo.update

    def timed_step(*args):
        t = time.perf_counter()
        out = collect(*args)
        step_s.append(time.perf_counter() - t)
        return out

    def checked_update(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")   # no host sync inside
        try:
            out = update(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        update_ms.append((time.perf_counter() - t) * 1e3)
        return out

    trainer._collect_rollout_step = timed_step
    trainer.ppo.update = checked_update
    zero_counters()
    torch.cuda.reset_peak_memory_stats()
    log = trainer.train()
    peak = torch.cuda.max_memory_allocated()
    no_kernel_launched("phase 17a")
    if len(log) != RL_UPDATES or not all(
            np.isfinite(r[k]) for r in log
            for k in ("value_loss", "action_loss", "dist_entropy")):
        raise AssertionError(f"phase 17a: training log {log}")
    for r in log:
        print(f"  update {r['update']}: value_loss {r['value_loss']:.4f} "
              f"action_loss {r['action_loss']:.5f} entropy "
              f"{r['dist_entropy']:.4f} reward {r['reward']:.3f}")

    # the host syncs of one more env step (by design one: the packed copy)
    hidden = torch.zeros((RL_ENVS, RL_HIDDEN), device="cuda")
    prev = torch.zeros((RL_ENVS,), dtype=torch.int64, device="cuda")
    masks = torch.ones((RL_ENVS,), device="cuda")
    sites = sync_sites(lambda: collect(hidden, prev, masks))
    if sum(sites.values()) != 1:
        raise AssertionError(f"phase 17a: {sum(sites.values())} host syncs "
                             f"in an env step: {dict(sites)}")
    _, act_ops = tf32_held_off("phase 17a env step",
                               lambda: collect(hidden, prev, masks))

    # one update, card against CPU, on the last rollout's batch
    storage = trainer.rollouts
    storage.step = RL_STEPS
    batch = storage.batch("cpu")
    storage.step = 0
    mb = minibatch_indices(cfg.ppo, RL_ENVS,
                           torch.Generator("cuda").manual_seed(17), "cuda")
    state = trainer.ppo.state_dict()
    (p_card, m_card), update_ops = tf32_held_off(
        "phase 17a update", lambda: ppo_update_on(
            "cuda", trainer.policy, state, cfg.ppo, batch, mb))
    p_cpu, m_cpu = ppo_update_on("cpu", trainer.policy, state, cfg.ppo,
                                 batch, mb)
    worst_m = max(abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-30)
                  for k in m_cpu)
    if worst_m > 1e-4:
        raise AssertionError(f"phase 17a: metrics card {m_card} vs CPU "
                             f"{m_cpu}")
    worst_p = hold_params("phase 17a update", p_card, p_cpu)
    before = {k: v.detach().cpu() for k, v in trainer.policy.state_dict()
              .items()}
    worst_d = max(float(((p_card[k] - before[k]) - (p_cpu[k] - before[k]))
                        .abs().max()) /
                  float((p_cpu[k] - before[k]).abs().max())
                  for k in p_cpu if bool((p_cpu[k] != before[k]).any()))
    if not worst_d <= DELTA_RTOL:
        raise AssertionError(f"phase 17a: the update p_new - p_old card vs "
                             f"CPU differs by {worst_d:.3e} of its largest "
                             f"(rtol {DELTA_RTOL:g})")
    trainer.close()
    steps = np.asarray(step_s[RL_STEPS:]) * 1e3     # after the 1st update
    phase("17a", f"PPO trainer, RGB PointNavPolicy hidden {RL_HIDDEN} on "
                 f"{RL_HW[0]}x{RL_HW[1]} frames, {RL_ENVS} envs x "
                 f"{RL_STEPS} steps, ppo_epoch 2 x 2 minibatches, "
                 f"{RL_UPDATES} updates (set-up {setup_s:.1f} s): "
                 f"{np.median(steps):.2f} ms an env step (median, "
                 f"{RL_ENVS} envs; p90 {np.percentile(steps, 90):.2f}), "
                 f"{np.mean(update_ms[1:]):.1f} ms an update (updates 2-3; "
                 f"first {update_ms[0]:.1f}), 1 host sync an env step, none "
                 f"in an update (sync debug mode \"error\"), peak "
                 f"{peak / 2 ** 30:.2f} GiB, no port kernel launched, TF32 "
                 f"off inside the calls under the caller's TF32 on ({act_ops} "
                 f"products in an env step, {update_ops} in an update, "
                 f"backward included); one update card vs CPU: metrics "
                 f"within {worst_m:.1e} (rtol 1e-4), parameters within "
                 f"{worst_p:.1e} of each tensor's largest (rtol "
                 f"{PARAM_RTOL:g}), the update p_new - p_old within "
                 f"{worst_d:.1e} of its largest (rtol {DELTA_RTOL:g})")


def run_rl_resnet_benchmark():
    """Phase 17b: the DD-PPO ResNet policy (resnet50, baseplanes 32, hidden
    512) on 64x64 RGB, card against CPU; a PPOAgent through Benchmark."""
    from embodied_object_detection_tpu_torch.rl.agents import (
        Benchmark, PPOAgent)
    from embodied_object_detection_tpu_torch.rl.resnet_policy import (
        PointNavResNetPolicy)
    rng = np.random.RandomState(171)
    policy = PointNavResNetPolicy(4, RL_HIDDEN, "resnet50", 32,
                                  image_hw=RL_HW, seed=17)
    n, steps = 4, 8

    def obs(lead):
        return {"rgb": torch.from_numpy(rng.randint(
                    0, 256, lead + RL_HW + (3,)).astype(np.float32)),
                "pointgoal_with_gps_compass": torch.from_numpy(
                    (rng.rand(*lead, 2) * [5, 6] - [0, 3]).astype(
                        np.float32))}
    o1, seq = obs((n,)), obs((steps, n))
    h = torch.from_numpy(rng.randn(n, RL_HIDDEN).astype(np.float32))
    prev = torch.from_numpy(rng.randint(0, 4, n))
    masks = torch.tensor([0.0, 1.0, 1.0, 1.0])
    seq_masks = torch.from_numpy((rng.rand(steps, n) > 0.2).astype(
        np.float32))
    actions = torch.from_numpy(rng.randint(0, 4, (steps, n)))
    outs, ops = {}, 0
    for dev in ("cuda", "cpu"):
        pol = copy.deepcopy(policy).to(dev).eval()
        mv = {k: v.to(dev) for k, v in o1.items()}
        sv = {k: v.to(dev) for k, v in seq.items()}

        def act_and_evaluate():
            with torch.no_grad():
                return (pol.act(mv, h.to(dev), prev.to(dev), masks.to(dev),
                                deterministic=True) +
                        pol.evaluate_actions(sv, h.to(dev), actions.to(dev),
                                             seq_masks.to(dev),
                                             actions.to(dev)))
        if dev == "cuda":
            out, ops = tf32_held_off("phase 17b", act_and_evaluate)
        else:
            out = act_and_evaluate()
        outs[dev] = [t.cpu() for t in out]
    if not torch.equal(outs["cuda"][1], outs["cpu"][1]):
        raise AssertionError("phase 17b: deterministic actions differ")
    worst = max(float((g - c).abs().max()) for i, (g, c) in
                enumerate(zip(outs["cuda"], outs["cpu"])) if i != 1)
    if worst > POLICY_ATOL:
        raise AssertionError(f"phase 17b: card vs CPU differ by {worst}")

    env = rl_env_fn(5, steps=50, scene="bench17")
    agent = PPOAgent(policy, RL_HIDDEN, device="cuda")
    zero_counters()
    t0 = time.perf_counter()
    stats = Benchmark(env.habitat_env).evaluate(agent, num_episodes=2)
    secs = time.perf_counter() - t0
    no_kernel_launched("phase 17b")
    env.close()
    if not np.isfinite(stats["distance_to_goal"]):
        raise AssertionError(f"phase 17b: Benchmark {stats}")
    phase("17b", f"PointNavResNetPolicy (resnet50, baseplanes 32, hidden "
                 f"{RL_HIDDEN}) on {RL_HW[0]}x{RL_HW[1]} RGB: act and "
                 f"evaluate_actions ({steps} x {n}) card vs CPU within "
                 f"{worst:.1e} (atol {POLICY_ATOL:g}), TF32 off in its "
                 f"{ops} products, deterministic "
                 f"actions equal; PPOAgent through Benchmark, 2 episodes "
                 f"in {secs:.1f} s: " +
                 ", ".join(f"{k} {v:.3f}" for k, v in stats.items()))


class SegmentSumSpy:
    """Stands in for `rl/slam.py`'s `segment_sum`: calls the wrapper and
    holds each launch bit-equal to `segment_sum_plain` on the same rows
    and ids; keeps the last call's inputs for phase 7."""

    def __init__(self, fn):
        from embodied_object_detection_tpu_torch.ops import segment_sum as ss
        self.fn, self.plain, self.calls, self.last = fn, \
            ss.segment_sum_plain, 0, None

    def __call__(self, w, idx, cells):
        out = self.fn(w, idx, cells)
        want = self.plain(w, idx, cells)
        if not torch.equal(out, want):
            raise AssertionError("phase 17c: kernel 1 differs from "
                                 "segment_sum_plain on the SLAM map")
        self.calls += 1
        self.last = (w.clone(), idx.clone(), cells)
        return out


def run_rl_slam():
    """Phase 17c: MonoDepthNet (3, 4, 6, 3) at 228x304 card vs CPU, then a
    DepthMapperAndPlannerAgent on that estimator over one episode of a
    228x304 RGB grid sim, kernel 1 counting its map."""
    from embodied_object_detection_tpu_torch.rl import slam
    from embodied_object_detection_tpu_torch.rl.agents import Benchmark
    from embodied_object_detection_tpu_torch.rl.monodepth import (
        MonoDepthEstimator)
    from torch.utils.flop_counter import FlopCounterMode
    est = MonoDepthEstimator(device="cuda")
    est.init(seed=17)
    bias = 2.0
    with torch.no_grad():     # depths near 2 m, inside the mapper's range
        est.net.r_conv2.weight.mul_(0.05)
        est.net.r_conv2.bias.fill_(bias)
    rgb = np.random.RandomState(172).randint(0, 256, SLAM_HW + (3,)).astype(
        np.uint8)
    est.predict(rgb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        got = est.predict(rgb)
    torch.cuda.synchronize()
    depth_ms = (time.perf_counter() - t0) / 5 * 1e3
    _, depth_ops = tf32_held_off("phase 17c MonoDepth",
                                 lambda: est.predict(rgb))
    with FlopCounterMode(display=False) as fc:    # this frame's own count
        est.predict(rgb)
    flops = fc.get_total_flops()
    parts = {"E": 0, "D": 0, "MFF": 0, "R": 0}
    for name, ops in fc.get_flop_counts().items():
        if name.count(".") == 1:                  # the net's own children
            child = name.split(".")[1]
            part = ("D" if child.startswith("d_") else "MFF"
                    if child.startswith("mff_") else "R"
                    if child.startswith("r_") else "E")
            parts[part] += sum(ops.values())
    if sum(parts.values()) != flops:
        raise AssertionError(f"phase 17c: MonoDepth FLOPs {parts} do not "
                             f"add up to {flops}")
    cpu_est = MonoDepthEstimator(copy.deepcopy(est.net).cpu(), device="cpu")
    want = cpu_est.predict(rgb)
    # the net's own part: the depth less the last convolution's constant
    body = float((want - bias).abs().max())
    depth_err = float((got.cpu() - want).abs().max()) / body
    if not depth_err <= DEPTH_RTOL:
        raise AssertionError(f"phase 17c: MonoDepth card vs CPU "
                             f"{depth_err:.3e} of the net's part "
                             f"({body:.3e} m)")

    env = rl_env_fn(0, rgb_hw=SLAM_HW, steps=30, scene="slam17")
    sim = env.habitat_env.sim
    agent = slam.DepthMapperAndPlannerAgent(sim, monodepth=est,
                                            device="cuda")
    spy = SegmentSumSpy(slam.segment_sum)
    depths, poses, plan_ms, iters = [], [], [], []
    update_map, compute_depth = agent.update_map, est.compute_depth
    plan = slam.plan_distance_field

    def recorded_update(observations):       # the pose and depth it maps
        poses.append(agent._pose4x4())
        update_map(observations)

    def recorded_depth(rgb):
        depths.append(compute_depth(rgb))
        return depths[-1]

    def timed_plan(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        g = plan(*args, **kw)
        torch.cuda.synchronize()
        plan_ms.append((time.perf_counter() - t) * 1e3)
        iters.append(kw["stats"]["iterations"])
        return g

    agent.update_map, est.compute_depth = recorded_update, recorded_depth
    slam.segment_sum, slam.plan_distance_field = spy, timed_plan
    try:
        zero_counters()
        t0 = time.perf_counter()
        stats = Benchmark(env.habitat_env).evaluate(agent, num_episodes=1)
        secs = time.perf_counter() - t0
        launches = read_counters()
    finally:
        slam.segment_sum, slam.plan_distance_field = spy.fn, plan
    env.close()
    maps = len(depths)
    if maps < SLAM_MIN_STEPS:
        raise AssertionError(f"phase 17c: {maps} map updates (at least "
                             f"{SLAM_MIN_STEPS} wanted)")
    others = {k: v for k, v in launches.items() if v and k != "segment_sum"}
    if launches["segment_sum"] != maps or spy.calls != maps or \
            len(poses) != maps or others:
        raise AssertionError(f"phase 17c: launches {launches}, {maps} map "
                             f"updates, {spy.calls} held")

    # the map, card against CPU, from the same depths and poses
    mapper = slam.DirectDepthMapper(map_size_m=agent.map_size_m,
                                    cell_m=agent.cell_m)
    cpu_map = torch.zeros_like(agent._obstacle_counts, device="cpu")
    card_map = torch.zeros_like(agent._obstacle_counts)
    map_ops = 0
    for depth, pose in zip(depths, poses):
        depth, pose = torch.from_numpy(depth), torch.from_numpy(pose)
        cpu_map += mapper(depth, pose)
        counts, ops = tf32_held_off("phase 17c mapper", lambda: mapper(
            depth.cuda(), pose.cuda()))
        card_map += counts
        map_ops += ops
    if not torch.equal(card_map.cpu(), agent._obstacle_counts.cpu()):
        raise AssertionError("phase 17c: the agent's map is not its views'")
    diff = card_map.cpu() != cpu_map
    moved = float((card_map.cpu() - cpu_map).abs().sum())
    points = float(cpu_map.sum())
    if moved > 1e-3 * points:
        raise AssertionError(f"phase 17c: card map differs from the CPU's "
                             f"by {moved} of {points} points")
    share = ", ".join(f"{k} {v / flops:.0%}" for k, v in parts.items())
    phase("17c", f"MonoDepthNet (3, 4, 6, 3) at {SLAM_HW[0]}x{SLAM_HW[1]}, "
                 f"seeded: {depth_ms:.2f} ms a frame, {flops / 1e9:.1f} GFLOP "
                 f"a frame (counted: {share}), "
                 f"{flops / depth_ms / 1e9:.2f} TFLOP/s, TF32 off in its "
                 f"{depth_ops} convolutions and in the mapper's {map_ops} "
                 f"products; card vs CPU within {depth_err:.1e} of the net's "
                 f"part (the depth less the last bias, largest {body:.3f} m; "
                 f"rtol {DEPTH_RTOL:g}); DepthMapperAndPlannerAgent on it, "
                 f"one episode of {maps} steps in {secs:.1f} s "
                 f"({', '.join(f'{k} {v:.3f}' for k, v in stats.items())}): "
                 f"kernel 1 launched {launches['segment_sum']} times, one a "
                 f"map update ({agent.mapper.map_cells}^2 cells, "
                 f"{SLAM_HW[0] * SLAM_HW[1]} rows), each bit-equal to "
                 f"segment_sum_plain; the map ({points:.0f} points) card vs "
                 f"CPU on the same depths and poses: {int(diff.sum())} cells "
                 f"differ, {moved:.0f} points moved" +
                 (" (a point on a cell boundary whose f32 pose product "
                  "rounds the other way)" if moved else "") +
                 f"; plans {np.median(plan_ms):.1f} ms (median; max "
                 f"{max(plan_ms):.1f}), {int(np.median(iters))} iterations "
                 f"(min {min(iters)}, max {max(iters)})")
    return spy.last, launches["segment_sum"]


def run_rl_ddppo():
    """Phase 17d: DD-PPO at world size 1 over NCCL: the update bit-equal
    to the plain update."""
    import torch.distributed as dist
    from embodied_object_detection_tpu_torch.parallel.mesh import (
        init_distributed)
    from embodied_object_detection_tpu_torch.rl.ddppo import make_ddppo
    from embodied_object_detection_tpu_torch.rl.policy import PointNavPolicy
    from embodied_object_detection_tpu_torch.rl.ppo import (
        PPO, PPOConfig, minibatch_indices)
    rng = np.random.RandomState(173)
    cfg = PPOConfig(ppo_epoch=2, num_mini_batch=2)
    t, n = RL_STEPS, RL_ENVS
    dev = "cuda"
    batch = {"observations": {
                 "pointgoal_with_gps_compass": torch.from_numpy(
                     rng.randn(t, n, 2).astype(np.float32)).to(dev),
                 "rgb": torch.from_numpy(rng.randint(
                     0, 256, (t, n) + RL_HW + (3,)).astype(
                         np.float32)).to(dev)},
             "hidden0": torch.from_numpy(rng.randn(n, RL_HIDDEN).astype(
                 np.float32)).to(dev)}
    for k in ("value_preds", "returns", "masks", "old_log_probs"):
        batch[k] = torch.from_numpy(rng.rand(t, n).astype(np.float32)).to(
            dev)
    batch["masks"] = (batch["masks"] > 0.1).float()
    batch["old_log_probs"] = torch.log(batch["old_log_probs"] * 0.5 + 0.1)
    for k in ("actions", "prev_actions"):
        batch[k] = torch.from_numpy(rng.randint(0, 4, (t, n))).to(dev)
    mb = minibatch_indices(cfg, n, torch.Generator(dev).manual_seed(3), dev)
    base = PointNavPolicy(4, RL_HIDDEN, blind=False, image_hw=RL_HW,
                          seed=18).to(dev)
    plain, dd = copy.deepcopy(base), copy.deepcopy(base)
    # cuDNN's deterministic algorithms for both: a bit-equality needs a
    # convolution backward that repeats
    torch.backends.cudnn.deterministic = True
    rank, world = init_distributed(f"127.0.0.1:{free_port()}", dev,
                                   timeout_s=120)
    try:
        want = PPO(plain, cfg).update(batch, mb_indices=mb)
        if (rank, world, dist.get_backend()) != (0, 1, "nccl"):
            raise AssertionError(f"phase 17d: rank {rank} of {world}")
        got = make_ddppo(dd, cfg).update(batch, mb_indices=mb)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
        torch.backends.cudnn.deterministic = False
    for (k, a), b in zip(plain.state_dict().items(), dd.state_dict().values()):
        if not torch.equal(a, b):
            raise AssertionError(f"phase 17d: {k} differs from the plain "
                                 "update")
    if any(not torch.equal(got[k], want[k]) for k in want):
        raise AssertionError(f"phase 17d: metrics {got} vs {want}")
    phase("17d", f"DD-PPO on a one-rank NCCL group (world {world}): the "
                 f"update of the RGB policy (hidden {RL_HIDDEN}, {t} x {n}, "
                 f"2 x 2 minibatches) bit-equal to the plain update, "
                 f"parameters and metrics")


def run_rl():
    """Phase 17: the RL stack (rl/); returns phase 17c's last map update's
    kernel-1 inputs and its launches for phase 7."""
    t0 = time.perf_counter()
    saved = tf32_flags()
    set_tf32((True, True))      # a caller's: the RL calls switch it off
    try:
        run_rl_trainer()
        run_rl_resnet_benchmark()
        last, launches = run_rl_slam()
        run_rl_ddppo()
    finally:
        set_tf32(saved)
    phase(17, f"the RL stack in {time.perf_counter() - t0:.1f} s, under "
              f"the caller's TF32 on")
    return last, launches


def time_segment_sum_slam(last, launches):
    """Phase 7, kernel 1 at the SLAM mapper's shape (K = 1, the map's
    127^2 cells, a 228x304 depth's rows): phase 17c's last map update,
    beside the plain version, `index_add_` and its bound."""
    from embodied_object_detection_tpu_torch.ops import segment_sum as ss
    w, idx, cells = last
    rows, lanes = w.shape
    keep = (idx >= 0) & (idx < cells)
    routed = torch.where(keep, idx.long(), torch.full_like(idx, cells).long())
    ms = graph_ms(lambda: ss.segment_sum(w, idx, cells))
    plain_ms = graph_ms(lambda: ss.segment_sum_plain(w, idx, cells))
    lib_ms = graph_ms(lambda: torch.zeros((cells + 1, lanes),
                                          device="cuda").index_add_(
                                              0, routed, w))
    # as the other shapes of row 1: the rows in range read, each id read,
    # each cell's K lanes written once (the wrapper's 4-lane padding is
    # its layout, not the function's), the nonzero additions
    live = int(keep.sum())
    added = int(((w != 0) & keep[:, None]).sum())
    b_ms, b_by = bound_ms(live * lanes * 4 + rows * 4 + cells * lanes * 4,
                          added)
    runs = int((idx[1:] != idx[:-1]).sum()) + 1
    print(f"  segment_sum, SLAM map (K = {lanes}, {cells} cells, {rows} "
          f"rows, {live} in range, {runs} runs of equal ids): "
          f"{ms * 1e3:.2f} us kernel, {plain_ms * 1e3:.2f} us plain, "
          f"{lib_ms * 1e3:.2f} us index_add_, bound {b_ms * 1e3:.2f} us "
          f"({b_by}), {launches} launches in phase 17c")

# ---------------------------------------------------------- phase 18

def clip_features_cli(device, names, pth, bpe, out):
    """`dataset_prep clip-features` on `device`: in this process on the
    card, in a child process (returned, running) on the CPU."""
    argv = ["clip-features", "--names", str(names), "--clip-params",
            str(pth), "--out", str(out), "--device", device]
    if device == "cpu":
        return subprocess.Popen(
            [sys.executable, "-m",
             "embodied_object_detection_tpu_torch.tools.dataset_prep"] + argv,
            cwd=REPO, env={**os.environ, "CLIP_BPE_PATH": str(bpe)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    from embodied_object_detection_tpu_torch.tools import dataset_prep
    before = os.environ.get("CLIP_BPE_PATH")
    os.environ["CLIP_BPE_PATH"] = str(bpe)
    try:
        t0 = time.perf_counter()
        dataset_prep.main(argv)
        return (time.perf_counter() - t0) * 1e3
    finally:
        if before is None:
            del os.environ["CLIP_BPE_PATH"]
        else:
            os.environ["CLIP_BPE_PATH"] = before


def run_align_impls():
    """Phase 18b: the default frame at 480x640 with `roi.align_impl` v2 and
    v3 (a 4-frame chunk through `counted_run`), frame 0's detections of
    the two equal, and each impl's 64x96 miniature on the card held to
    the CPU's form of that impl. Returns kernel 4's launches and the
    detections held, by impl."""
    from embodied_object_detection_tpu_torch.config import DetectorConfig
    from embodied_object_detection_tpu_torch.models.detector import (
        build_detector, frame_inputs, make_episode_runner)
    from embodied_object_detection_tpu_torch.structures import MemoryState
    base = DetectorConfig()
    h, w = base.input.height, base.input.width
    cells, dim = base.memory.max_cells, base.memory.memory_dim
    rng = np.random.RandomState(18)
    frames = frame_inputs(
        rng.randint(0, 255, (T_FRAMES, h, w, 3)).astype(np.float32),
        rng.randint(0, cells, (T_FRAMES, h, w)).astype(np.int32),
        np.array([True] + [False] * (T_FRAMES - 1)), cells, "cuda")
    zs = torch.from_numpy(random_zs(rng, base)).cuda()
    mini = dict(image=rng.randint(0, 255, (64, 96, 3)).astype(np.float32),
                memf=rng.randn(64, 512).astype(np.float32),
                memo=rng.randint(0, 3, 64).astype(np.float32),
                proj=rng.randint(0, 64, (64, 96)).astype(np.int32),
                outlier=np.zeros((64, 96), bool))
    first, report = {}, {}
    for impl in ("v2", "v3"):
        cfg = base.replace(roi=dataclasses.replace(base.roi,
                                                   align_impl=impl))
        run = make_episode_runner(build_detector(cfg, seed=0, device="cuda"),
                                  cfg)
        init = MemoryState.zeros(cells, dim, "cuda")
        out, _, launches = counted_run(f"align_impl={impl}",
                                       lambda: run(frames, zs, init),
                                       LAUNCHES_PER_FRAME, T_FRAMES)
        check_episode(f"align_impl={impl}", out, (T_FRAMES,), cfg)
        first[impl] = [t[0] for t in out.detections]
        mcfg = miniature(cfg, 1)
        mini["zs"] = random_zs(np.random.RandomState(181), mcfg)
        dets = {}
        for dev in ("cuda", "cpu"):
            model = build_detector(mcfg, seed=3, device=dev)
            t = {k: torch.from_numpy(v).to(dev) for k, v in mini.items()}
            dets[dev] = model.frame_step(t["image"], t["zs"], t["memf"],
                                         t["memo"], t["proj"],
                                         t["outlier"]).detections
        n = hold_detections(f"phase 18b {impl} miniature", dets["cuda"],
                            dets["cpu"])
        report[impl] = (launches["roi_align"], n)
    for a, b in zip(first["v2"], first["v3"]):
        if not torch.equal(a, b):
            raise AssertionError("phase 18b: frame 0's detections differ "
                                 "between v2 and v3 on the card")
    return report


def check_class_aware_nms():
    """Phase 18c: `class_aware_nms` at 2048 candidates of 20 classes with
    top-k 2048 (so every kept candidate is in the output) on the card,
    equal to the CPU's plain fixpoint; its launches, and its time a call
    eager (host launches included) and on the device (a CUDA graph)."""
    from embodied_object_detection_tpu_torch.ops import class_aware_nms, nms
    rng, n = np.random.RandomState(18), 2048
    # as `nms_inputs` draws them, unsorted: a third of the scores tied at
    # sixteenths, a tenth of the boxes duplicated, 5 % invalid
    xy = rng.uniform(-20, 600, (n, 2)) * np.array([1.0, 0.75])
    boxes = np.concatenate([xy, xy + rng.uniform(8, 200, (n, 2))], 1)
    dup = rng.choice(n - 1, n // 10, replace=False)
    boxes[dup] = boxes[dup + 1]
    scores = rng.rand(n)
    scores[::3] = np.round(scores[::3] * 16) / 16
    args = tuple(torch.from_numpy(a).cuda() for a in (
        boxes.astype(np.float32), scores.astype(np.float32),
        rng.randint(0, 20, n).astype(np.int32), rng.rand(n) > 0.05)) + \
        (0.5, n)
    valid = args[3]
    zero_counters()
    got = class_aware_nms(*args)
    launches = nms.nms_keep.launches
    want = class_aware_nms(*(a.cpu() if isinstance(a, torch.Tensor) else a
                             for a in args))
    for name, g, c in zip(got._fields, got, want):
        if not torch.equal(g.cpu(), c):
            raise AssertionError(f"phase 18c: class_aware_nms {name} "
                                 "differ from the CPU's plain fixpoint")
    if launches != 1:
        raise AssertionError(f"phase 18c: {launches} NMS launches a call")
    return int(got.valid.sum()), int(valid.sum()), event_ms(
        lambda: class_aware_nms(*args)), graph_ms(
        lambda: class_aware_nms(*args))


def run_slice19():
    """Phase 18: the dataset-prep CLI's clip-features on the card against
    its CPU run, the v2 / v3 ROIAlign frames, and class_aware_nms."""
    t_phase = time.perf_counter()
    names = [n.replace("_", " ") for n in lvis_names()]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "names.json").write_text(json.dumps(names))
        torch.save({k: torch.from_numpy(v)
                    for k, v in synthetic_clip_state_dict().items()},
                   tmp / "clip.pth")
        bpe = write_merges(tmp / "merges.txt.gz", names)
        cpu = clip_features_cli("cpu", tmp / "names.json", tmp / "clip.pth",
                                bpe, tmp / "cpu.npy")
        try:
            card_ms = [clip_features_cli("cuda", tmp / "names.json",
                                         tmp / "clip.pth", bpe,
                                         tmp / f"card{i}.npy")
                       for i in range(2)]
            impls = run_align_impls()
            kept, valid, nms_ms, nms_dev_ms = check_class_aware_nms()
            t0 = time.perf_counter()
            log, _ = cpu.communicate(timeout=600)
            cpu_wait = time.perf_counter() - t0
        finally:
            if cpu.poll() is None:
                cpu.kill()
                cpu.wait()
        if cpu.returncode != 0:
            raise AssertionError(f"phase 18a: the CPU command failed:\n{log}")
        got, want = np.load(tmp / "card1.npy"), np.load(tmp / "cpu.npy")
        first = np.load(tmp / "card0.npy")
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    if got.shape != (len(names), 512) or got.dtype != np.float32 or \
            not err <= 1e-5 * scale or not np.array_equal(first, got):
        raise AssertionError(f"phase 18a: {got.shape} {got.dtype}, card vs "
                             f"CPU {err} (largest {scale}); two card runs "
                             f"equal: {np.array_equal(first, got)}")
    print(f"  18a: clip-features on {len(names)} LVIS names through the CLI "
          f"on the card: {card_ms[0]:.1f} ms (checkpoint load included), "
          f"then {card_ms[1]:.1f} ms; card vs CPU max err {err:.2e} "
          f"(largest {scale:.3f}, tolerance 1e-5 of it); the CPU command "
          f"was waited for {cpu_wait:.1f} s after (b) and (c)")
    for impl, (roi, n) in impls.items():
        print(f"  18b: align_impl={impl}: kernel 4 launched {roi} times in "
              f"the {T_FRAMES}-frame chunk; the 64x96 miniature's {n} "
              f"detections held to the CPU's {impl}")
    print(f"  18c: class_aware_nms, 2048 candidates ({valid} valid) of 20 "
          f"classes, t = 0.5: {kept} kept, equal to the CPU's plain "
          f"fixpoint; 1 NMS launch a call; {nms_ms * 1e3:.1f} us a call "
          f"(CUDA events around 20 eager calls), {nms_dev_ms * 1e3:.1f} us "
          f"on the device (CUDA graphs of 20 calls x 10 replays)")
    phase(18, f"clip-features CLI {card_ms[1]:.1f} ms a {len(names)}-name "
              f"vocabulary on the card, within {err:.2e} of the CPU's; "
              f"align_impl v2 / v3 frames at 480x640 on kernel 4 "
              f"({impls['v2'][0]} / {impls['v3'][0]} launches in "
              f"{T_FRAMES} frames), miniatures held to the CPU; "
              f"class_aware_nms equal to the plain fixpoint "
              f"({nms_ms * 1e3:.1f} us eager, {nms_dev_ms * 1e3:.1f} us "
              f"device); "
              f"{time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="profile one eval chunk, the eval engine's "
                             "first 2 chunks and one training step into "
                             "DIR, and write the DETR frames' device ops "
                             "there")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "false); nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import embodied_object_detection_tpu_torch  # noqa: F401  fails alone

    card = smi("name,power.limit")
    print(card)
    phase(1, f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
             f"{torch.cuda.get_device_name(0)}, "
             f"{torch.cuda.device_count()} card(s)")
    build_kernels()
    rng = np.random.RandomState(123)
    errs = {"segment_sum": check_segment_sum(rng),
            "memory_read": check_memory_read(rng),
            "nms": check_nms(rng),
            "roi_align": check_roi_align(rng),
            "mask_paste": check_mask_paste(rng),
            "write_select": check_write_select(rng),
            "memory_read_batched": check_memory_read_batched(rng),
            "roi_align_backward": check_roi_align_backward(rng)}
    launches, _ = run_main_path(args.profile)
    run_episode_modes()
    check_against_cpu()
    check_against_cpu("longterm")
    run_eval_engine(args.profile)
    eval_engine_against_cpu()
    train_launches, _, _ = run_train_path(args.profile)
    check_train_against_cpu()
    robot_model, robot_cfg, robot_memory = run_robot_path()
    check_predictor_and_server(robot_model, robot_cfg)
    check_image_demo()
    check_export(robot_model, robot_cfg, robot_memory)
    errs.update(check_ms_deform_attn(rng))
    detr_launches, _ = run_detr_inference(args.profile)
    detr_train_launches = run_detr_training()
    check_detr_against_cpu()
    blocks = dcn_blocks()
    dcn_inputs = dcn_level_inputs(np.random.RandomState(13))
    dcn_launches, dcn_errs = check_deform_conv(blocks, dcn_inputs)
    read_cases = read_backward_cases(np.random.RandomState(14))
    read_launches, read_errs = check_read_backward(read_cases)
    run_coco_eval()
    run_coco_cli()
    run_cotraining()
    check_cotraining_against_cpu()
    res5_model, res5_cfg = run_res5()
    check_res5_against_cpu()
    run_swin(args.profile)
    run_text_tower(res5_model, res5_cfg)
    del res5_model
    run_parallel()
    slam_last, slam_launches = run_rl()
    run_slice19()
    kernels = time_kernels(rng, launches, train_launches, errs,
                           detr_launches, detr_train_launches) + \
        time_deform_conv(blocks, dcn_inputs, dcn_launches, dcn_errs) + \
        time_read_backward(read_cases, read_launches, read_errs) + \
        time_centernet(rng, launches)
    check_roi_align_cotraining(np.random.RandomState(15))
    check_roi_align_res5(np.random.RandomState(16))
    time_segment_sum_slam(slam_last, slam_launches)
    print(json.dumps({"kernels": kernels}))
    print(smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
