#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lic_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

It drives the port's seven serving paths, its evaluation and codec CLI and
content-adaptive encoding at full width (N=192, M=16), random
weights from a seed (UNTRAINED), through the entry points a user calls, on
a batch of 8 synthetic 512×768 images, and checks them:

* ``source_net`` — plain GDN transforms, the classic dual hyper, 4-slice
  ChARM, the rANS roundtrip;
* ``source_net_wam`` — the same with four ``WinNoShiftAttention`` gates
  (window attention + 3×3/7×7 conv branches) in g_a and g_s;
* ``net_ga`` — the rich transforms (``ResidualBottleneck``,
  ``ResidualBlockWithStride``, the WAM gates), the ELIC hyper, the SWAtten
  slice stacks and the WAM syntax model;
* ``net_unet_ha_hs_dec`` — the same with the decodable U-Net hyper, whose
  window attention (head widths 12, 16, 32, 64) takes the plain route;
* [entro] ``entroformer_cb`` (dim 192, 4 layers, 8 heads) and
  ``entroformer_cb_full`` (dim 384, 6 layers, 6 heads) — plain transforms,
  the ELIC hyper, the checkerboard entroformer context: two B1 drains per
  decode (L 128, the 64-row table in shared memory);
* [ns] ``neural_syntax`` — plain transforms, the classic hyper, the
  spatial context over 4×4 causal patches and the syntax stream: one B1
  drain per wavefront, 110 per decode (L 256, ``GaussianMuCoder``'s
  1,024-row table in device memory), the context head's 3×3 on 2×2 maps
  in B6;

* [vr] ``source_net_vr`` — ``source_net`` with 4 gain units: the
  variable-rate path at 8 per-image rates, its rate control, a
  multi-rate training step and [serve], the dynamic-batching
  ``CodecService`` under threaded load;

then one ``source_net`` forward in bf16 and one at ``is_high`` (N = 384),
``source_net_wam`` at ``is_high`` (head width 48: B4/B5's hd-48
instantiations), and the training step of ``source_net``,
``source_net_wam``, ``entroformer_cb`` and ``neural_syntax`` (B = 8 crops
of 256×256), whose kernels' gradients it then checks.

Each phase prints one line:

1. device: the card's name and power limit, as ``nvidia-smi`` gives them;
2. build: the four CUDA sources (B1 drain, B2 GDN, B3/B6 convs, B4/B5
   attention) built from this checkout into ``build/`` by one ``nvcc``
   each, all started together, with build seconds and ``ptxas`` register
   and spill counts; the host rANS library (``csrc/rans.cpp``);
3. B2, B1, B4 and B5 against their plain versions at the paths' shapes,
   fp32, atol/rtol 1e-5 (B1 bit-exact), a repeat call bit-identical, with
   the kernel's, the plain version's and a library call's times (the
   library call is a yardstick only; nothing on the path calls it); for
   each B2/B4/B5 shape also the bound in ms and the side that sets it, the
   kernel's share of the bound (B2's bound at the 3xTF32 rate where it runs
   on the tensor cores, C > 16), for B4/B5 its time over the yardstick's,
   shared memory per CTA and CTAs per SM, then the kernels' ``ptxas``
   register and spill lines; B1 on escape-heavy stress streams (about 1
   symbol in 17 escapes), with each set's escape share and its bound (the
   bytes of ``_drain_bytes``: rows, values, the payload words consumed,
   lane states and the table entries the symbols need);
4. per path: the zero-init weights (each attention's output projection,
   each residual branch's last conv, WMSA's output and the Swin MLP's
   second layer) get small seeded values, so that every check below sees
   those branches; the same
   model on a small input against its CPU run (plain versions, no kernel),
   stage by stage on the same inputs, so that no rounding flip can spread,
   within 1e-4; the eval forward (finite); the roundtrip ``compress_batch``
   → ``decompress_batch`` (final-state check, reconstruction within 1e-4 of
   the forward's); the exact launch count of every kernel over forward +
   roundtrip, counters zeroed just before and read just after, every
   B3/B6 call of that run with its shapes and flags, read by hooks on the
   ``Conv2d`` modules, and every B4 call with its shape, as B4's wrapper
   records it; ``compress`` → ``decompress`` at B=1; the times; for
   ``source_net``, ``entroformer_cb`` and ``neural_syntax`` also B1
   against its plain version on the streams of that B=8 decode (and for
   ``source_net`` of the B=1 decode and of [cli]'s decode of two 480×640
   streams; each its payload, rows and threaded lane states, recorded from
   another decode of the same streams), bit-exact, with the time and
   escape share.  The small-input check compares each family's own
   stages: the hyper and slice 0's (μ, σ); both checkerboard passes' (μ,
   σ); z2, h2, the context's and the syntax vector's (μ, σ); a σ that is
   the exp of a head's output (entroformer, neural syntax) as log σ, so
   1e-4 bounds σ's relative error.  [small_f64] prints beside it each
   stage's distance from the CPU model in float64 for the card and the
   CPU, and the largest |σ| difference with σ there.
   A path with window attention then checks that every attention branch
   outputs non-zero values and runs its forward once more with
   ``fuse_proj`` (kernel B5 where it takes the shape, else B4 between the
   ``Linear``s, else the plain route): its launches, and g_a's latent and
   the synthesis of the same latent within 1e-4 of the B4 run's (the whole
   forward would compare rounded symbols, where a 1e-6 difference can flip
   one);
5. ``source_net`` in bf16 (``model.to(torch.bfloat16)``, a bf16 input):
   its exact launches, g_a and the synthesis of the fp32 run's latent
   within 3% of the fp32 stages' largest magnitude, the forward finite;
   ``source_net`` at ``is_high``: exact launches (its N = 384 GDNs take the
   plain route, B3 runs at C_in 384), z3 / μ0 / σ0 / reconstruction within
   1e-4 of its CPU run at 128×128, the forward finite; both timed;
6. B4 against its plain version at every (shape, window, heads, masked)
   the paths gave it beyond those of 3; B2 likewise at every (rows, C,
   inverse) that the paths and [eval], [train] and [tune] gave it;
7. B3 and B6 against their plain versions, as in 3, at every distinct
   shape and flag set that the paths gave them in 4-5, with TFLOP/s and the
   bound (both over the FLOPs of the taps that land inside the map: on a
   2×2 map a 3×3 has 16 of its 36) at the 3xTF32 rate (495/3 TFLOP/s: the kernel runs three TF32
   products on the tensor cores) beside the HBM bound, the share of it, the
   time over cuDNN's, and the time of the weight's one-off TF32 prepack
   (cached on the weight, so not inside the kernel times); at the shapes
   the bf16 forward ran, the kernel on bf16 tensors against the plain
   version in float64 on the same values (rtol 2⁻⁸: one bf16 rounding), its
   time beside the fp32 call's (what widening to fp32 and rounding back
   cost) and cuDNN's bf16 time; then the conv
   kernel's shared memory per CTA, CTAs per SM and ``ptxas`` line.

8. [c3]: B4 and B5 at head width 48 (C 384, 8 heads) against their plain
   versions at both gate sizes, as in 3; ``source_net_wam`` at ``is_high``:
   its stages at 128×128 against its CPU run, then one B=8 512×768 forward
   with B4 and one with ``fuse_proj`` (B5), exact launches, the two within
   1e-4 of each other;
9. [train]: ``source_net`` at full width, 6 steps of the port's
   ``train_step`` (``TrainConfig``'s defaults) on B = 8 random 256×256
   crops of seeded ``smooth_images`` (no dataset ships with the
   repository): the first step's launches and backwards against
   ``EXPECTED``, every loss finite and no step skipped, after the last step
   each B3/B6 slot's kernel output against the plain version with the
   updated weights (float64, ``TOL``) and away from the old weights' by
   more than 10·``TOL``, ms per step (median of steps 2-6; forward /
   backward / optimizer by CUDA events), images/s, peak memory, and the top
   kernels of one more step under ``torch.profiler``; [train_wam]:
   ``source_net_wam``, one step through B4 and one with ``fuse_proj`` (B5),
   the same checks;
10. [grad]: at every (kernel, shape) the training steps gave B2-B6, the
   forward through the kernel's autograd.Function against the plain
   version within ``TOL`` (float64; B2 fp32, as in 3), and the gradient
   of a random cotangent through it against autograd of the plain
   version in float64 (B2: its closed form in float64; B6's LeakyReLU
   on float64's side of 0, on the kernel's where the float64
   pre-activation is within ``TOL`` of 0, counted) within ``GRAD_TOL`` of
   each gradient's range (the conv weight gradients ``WGRAD_TOL``), and
   against the fp32 plain gradient within ``FP32_TOL``; the same for the
   B = 1 shapes of [tune].
11. [c5] (for each path, on its model and batch): each image compressed
   alone against ``compress_batch`` (bytes); the single streams decoded in
   one batch, alone and in chunks of 3, 3 and 2, bit-identical and equal
   to the eval forward in the coder's passes; the σ-indexes (scale-table
   rows) of the coder's slice chain, checkerboard passes or wavefronts for
   each image alone against the batch, none differing;
12. [eval] (``source_net``, ``net_unet_ha_hs_dec``): ``evaluate_image`` at
   B = 1 on 512×768, 768×512 and 480×640 (padded to 512×640) images: exact
   launches, its B3/B6 and B4 calls checked in 6-7, metrics finite, the
   scored reconstruction, bpp and MSE against a direct eval forward, ms
   per image;
13. [tune] (``source_net``, ``source_net_wam``): ``content_adaptive_finetune``
   of one 512×768 image, 10 steps (drop at 5; the reference runs 100, drop
   at 50): launches and backwards, every parameter outside g_a
   bit-identical and every g_a leaf moved, B3/B6 with the tuned weights
   against float64, the tuned stream decoded by the untouched model's
   coder, the model's own g_a unchanged, ms per step by phase;
14. [cli] (``source_net``): the codec CLI's directory core on 3 + 2 images
   of two sizes at ``--batch 2``, every file against the eval forward, a
   single-file stream decoded in a directory chunk, MP/s; where PIL
   imports, ``cli.codec.main`` and ``cli.eval.main`` on PNGs it writes
   (``pil=`` says which);
15. [c7] (``source_net``, ``source_net_vr``, the entropy bottleneck's
   ``factor_i`` woken with seeded values as a trained checkpoint has
   them): the z-coder's pmf table, quantized CDFs and digest of a coder on
   the card bit-identical to those of the same weights on the CPU (the
   digests printed), and a 128×128 stream written on the card decoded by
   the CPU model within 1e-4 of the card's decode;
16. [vr] (``source_net_vr``, its EB woken, B = 8 at 512×768): the eval
   forward at rates 0, 1, 1.5, 2 and 3 (bpp strictly rising); the main
   path — forward, ``compress_batch`` and ``decompress_batch`` at the
   per-image rates 0, 0.5, …, 3, 1.25 — with exact launches (those of
   ``source_net``) and its B2/B3/B6 calls checked in 6-7; every stream
   against ``compress`` of its image alone at its rate (bytes), the decode
   within 1e-4 of each image's eval forward at its rate; the forward and
   roundtrip times; [vr_solve] ``solve_rate_for_bpp`` on one image (its
   probes, rate and ms); [vr_train] one ``lmbda_list`` training step on
   4 crops (exact launches and backwards, its shapes into [grad], the
   drawn unit's ``log_gain`` row taking a gradient);
17. [serve] ``CodecService(max_batch=8, max_wait_ms=5)`` over that model:
   24 compress requests from 4 threads at 512×768 and 480×640 with
   rates cycling through those of [vr], then their 24 decompresses; every
   stream equals ``compress`` and every decode ``decompress`` bit for
   bit, no error, the launches those of the batches the service formed;
   p50/p95 latency, mean batch and requests/s;
18. [c8] (``source_net``, ``source_net_vr`` at rate 1.5, EB woken): one
   512×768 stream written by the card coder in its pass of 8, decoded by
   the CPU model of the same weights: the decode equals the card's within
   1e-4 or raises the final-state check (which of the two is printed),
   never other pixels; beside it the σ-rows of the decoder's passes on the
   CPU against the card's, on the card's stream, per slice;
19. [prog] (``source_net``, EB woken; one 512×768 and one 480×640 image,
   which pads): ``ProgressiveCoder`` with both digit models, compress and
   the full decompress with exact launches, the full decode within 1e-4
   of the forward in the coder's passes, a decode at every truncation
   point (MSE no worse than the step before's, 1% slack), a cut blob
   raising; planes, bytes per truncation point, ms and the host's share;
   ``cli.codec.main --progressive`` and ``--truncate_planes`` on a PNG;
20. [han] (``source_net`` with the HAN tail, its zero-init leaves woken):
   the stages and the tail's stages at 128×128 against the CPU model
   within 1e-4, the B = 8 512×768 forward + roundtrip with exact launches
   (the tail takes no kernel), ms with and without the tail, peak memory,
   ``evaluate_image`` at B = 1, the CLIs' ``--post_processing``;
   [han_train] one phase-2 step (B = 8 crops of 256×256): every base leaf
   bit-identical without optimizer state, every HAN leaf with a gradient
   moved, no kernel backward, ms by phase, peak memory.  ``[wall]
   c8_prog_han_s=`` times 18-20, and each of their lines its seconds;
21. [unet] (``net_ha``, ``net_unet_ha_hs``, ``net_unet_ha_hs_1``: the
   U-Net hyper, whose decoder reads the encoder's skips; ``net_unet``,
   ``net_unet_1``, ``net_unet_005_5``: the uncoded latent U-Net; no
   coder takes them): the stages at 128×128 against the CPU model (z3,
   the hyper's scales and means from the latent, slice 0's μ and σ, the
   synthesis) within 1e-4, the B = 8 512×768 eval forward with exact
   launches (B2-B6 in their slots, the U-Net hyper's attentions on the
   plain route), ms and peak memory, ``ChannelCoder`` and
   ``ProgressiveCoder`` raising the JAX package's ``ValueError``;
   [unet_eval] ``evaluate_image`` at B = 1 for ``net_unet_ha_hs`` and
   ``net_unet``, and 3 tune steps of ``net_unet`` (g_a alone moved);
   [unet_train] one training step each of ``net_unet_ha_hs``,
   ``net_unet`` and ``net_unet_ha_hs_1`` (B = 8 crops of 256×256): exact
   launches and backwards, every leaf with a gradient moved,
   ``net_unet_ha_hs_1``'s unread syntax model bit-identical, ms by phase,
   peak memory, the kernel shapes into [grad]; [unet_cli] the train CLI
   with no ``--preset`` (2 steps on PNGs it writes): it builds
   ``net_unet_ha_hs``, as the JAX trainer does.  ``[wall] unet_s=``
   times 21;
22. [rbs] ``net_ga`` with ``transform="rbs"`` (the rich g_a, the
   ``synthesisTransformModel_RBS`` g_s: three ``ResidualBlockUpsample``s,
   whose 3×3 at C 192 runs B6 at 64×96, 128×192 and 256×384, nine
   ``ResidualBottleneck``s, seven IGDNs) and [nolrp] ``source_net`` with
   ``lrp=False``, each driven as the paths of 4 are (``_drive``: the
   stages at 128×128 against the CPU model, the B = 8 512×768 forward and
   roundtrip with exact launches, the B = 1 roundtrip, the times, [c5];
   for rbs the ``fuse_proj`` pass).  The rbs g_s output reaches 1e5 on
   these untrained weights: each of its seven IGDNs squares the map's
   scale and doubles fp32's relative error, the CPU's as much as the
   card's (both ≈ 1e-3 of range from float64 at the output).  So its
   synthesis is compared block by block, each child of g_s and then the
   generated conv before its tanh on the reference's input to it, as a
   share of its range, as the other stages are compared on the same
   upstream values: within 1e-4, or, for a block whose CPU fp32 run is
   itself farther than 5e-5 from float64 (``wam1``, whose attention
   logits reach 1e4 on a map of magnitude 200), the card within twice
   the CPU's distance from float64 ([small_f64] prints both, and the
   blocks so held); its ``fuse_proj`` pass holds the well-conditioned
   blocks at 1e-4 and prints the B4-vs-B5 share of the others.  [rbs_train] one
   training step (B = 8 crops of 256×256) with exact launches and
   backwards, every leaf with a gradient moved, its shapes into [grad];
   B6 at the 256×384 shape at B = 1 in [grad] too;
23. [dormant] each module of ``layers/{misc,vit,haar}.py``, ``GDN1``,
   ``utils/init.py`` and ``utils/analyze.py``'s ERF on the card against
   its CPU run on the same weights, within 1e-4 of the CPU output's
   largest magnitude (Haar and the init draws bit-exact); no module
   launches a kernel, the ERF's 3×3 at C 192 runs B6 through ``Conv2d``;
24. [resume] ``source_net`` training on the card (B = 2 crops of
   256×256): three steps straight, and two steps, ``CheckpointManager``
   save, a fresh model, optimizer and state restored from the file and a
   third step: the parameters bit-identical.  ``[wall] rbs_nolrp_s=``
   and ``dormant_resume_s=`` time 22-24.

Then one JSON line with every kernel's name, route, source, the TPU kernel
it replaces, launches on the main paths, max error, times and bound (B1 as
two rows, one per table route), the card's line, and, last, the device
JSON.  Any failure raises: the exit
code is not 0 and no result line is printed.  It needs no argument and one
card, and exits non-zero without CUDA or outside a checkout of the
repository.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

H, W, BATCH = 512, 768, 8
SEED = 0
LANES = 128
# kernel vs plain: atol/rtol 1e-5.  B3-B6 are held to their plain versions
# run in float64 on the same inputs, and their distance to the fp32 plain
# version is printed beside: on an H100 the B3 kernel lands within 2e-6 of
# float64 at down1 but 1.8e-5 from cuDNN's fp32 result, so cuDNN's own
# rounding, not the kernel's, would decide a comparison in fp32
TOL = 1e-5
RECON_TOL = 1e-4  # model stages and the decoded reconstruction
# H100 SXM peaks (NVIDIA data sheet): fp32 on the CUDA cores, dense TF32
# on the tensor cores, and HBM3 bandwidth.  B3/B6 run three TF32 products
# per fp32 product (3xTF32), so their operations bound is FLOPs at a third
# of the TF32 rate; the other kernels' is FLOPs at the fp32 rate.
PEAK_FP32 = 67e12
PEAK_TF32X3 = 495e12 / 3
PEAK_BYTES = 3.35e12

# [c5]: the decode chunks the codec CLI forms from BATCH streams at --batch 3
C5_CHUNKS = (3, 3, 2)
# [eval]: B = 1 images, Kodak landscape and portrait and one that pads
# (480×640 → 512×640: z maps of 8×10)
EVAL_PRESETS = ("source_net", "net_unet_ha_hs_dec")
EVAL_SIZES = ((512, 768), (768, 512), (480, 640))
# [tune]: content-adaptive encoding, cut from the reference's 100 steps
# (drop at 50) to 10 (drop at 5)
TUNE_PRESETS = ("source_net", "source_net_wam")
TUNE_ITERS, TUNE_DROP = 10, 5
# [cli]: the codec CLI's directory mode on 3 + 2 images of two sizes
CLI_SIZES, CLI_BATCH = ((512, 768),) * 3 + ((480, 640),) * 2, 2
# [c7]: the card-written stream decoded on the CPU (full width, small map)
C7_SIZE = (128, 128)
# [vr]: source_net_vr's eval forward at each rate of VR_SWEEP; the main
# path's per-image rates (0 to 3 by 0.5, then 1.25 for the eighth image);
# the multi-rate training step's λ per gain unit (the preset's λ family)
VR_SWEEP = (0.0, 1.0, 1.5, 2.0, 3.0)
VR_RATES = [0.0, 0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 1.25]
VR_LMBDAS = (0.0025, 0.0067, 0.013, 0.05)
# [serve]: compress requests (then as many decompresses) from SERVE_THREADS
# threads, alternating between two sizes (480×640 pads to 512×640)
SERVE_REQUESTS, SERVE_THREADS = 24, 4
SERVE_SIZES = ((512, 768), (480, 640))
# [c8]: a card-written 512×768 stream (the card coder's pass of 8) decoded
# by the CPU model of the same weights
C8_PRESETS = ("source_net", "source_net_vr")
# [prog]: the progressive coder on source_net, one image of each size
# (480×640 pads to 512×640), both digit models
PROG_SIZES = ((512, 768), (480, 640))
PROG_DIGITS = ("gaussian", "static")
# [han]: source_net with the HAN post-processing tail
HAN_SMALL = 128
# [unet], [unet_train], [unet_eval]: the U-Net-hyper and latent-U-Net
# presets, which no coder takes; the tune's steps and the train CLI's
UNET_PRESETS = ("net_ha", "net_unet_ha_hs", "net_unet_ha_hs_1", "net_unet", "net_unet_1",
                "net_unet_005_5")
UNET_TRAIN = ("net_unet_ha_hs", "net_unet", "net_unet_ha_hs_1")
UNET_EVAL = ("net_unet_ha_hs", "net_unet")
UNET_TUNE_ITERS, UNET_CLI_STEPS = 3, 2
# [entro], [ns]: the entroformer checkerboard and neural-syntax paths,
# driven as the four ChARM paths are (``_drive``)
ENTRO_PATHS = ("entroformer_cb", "entroformer_cb_full")
NS_PATHS = ("neural_syntax",)
# B1 on stress streams at every lane count of the format, on the 64-row
# Gaussian table and GaussianMuCoder's 1,024 rows: three calls of a
# 512×768 wavefront's p_max·c = 24·176 symbols each
B1_LANES = (8, 16, 32, 64, 128, 256)
B1_WAVEFRONT = 24 * 176
# exact launches of each kernel, and calls of each plain route, over forward
# + compress_batch + decompress_batch; each WinNoShiftAttention gate runs 4
# window attentions and 14 B6 convs (3 + 3 ResidualBlocks, the 3x3 and the
# 7x7); the B6 slot also holds h_a.c0, both h_s.c2 and slice 0's two ChARM
# c0 convs of the classic hyper, the ELIC hyper's h_a.c0 and both h_s.c0,
# and each ResidualBlockWithStride's conv2.  The WAM syntax gate (C 64)
# runs B4 at head width 8 but no B6 (C_in 64); the U-Net hyper's 5 window
# attentions take the plain route (3 in h_a, 2 in h_s)
EXPECTED = {
    "source_net": {"gdn": 14, "drain": 4, "conv5s2": 6, "convk_s1": 14,
                   "wba": 0, "wba_proj": 0},
    "source_net_wam": {"gdn": 14, "drain": 4, "conv5s2": 6, "convk_s1": 126,
                       "wba": 32, "wba_proj": 0},
    "source_net_wam+fuse_proj": {"gdn": 7, "drain": 0, "conv5s2": 3, "convk_s1": 61,
                                 "wba": 0, "wba_proj": 16},
    "net_ga": {"gdn": 18, "drain": 4, "conv5s2": 4, "convk_s1": 130,
               "wba": 40, "wba_proj": 0},
    "net_ga+fuse_proj": {"gdn": 9, "drain": 0, "conv5s2": 2, "convk_s1": 63,
                         "wba": 4, "wba_proj": 16},
    "net_unet_ha_hs_dec": {"gdn": 18, "drain": 4, "conv5s2": 4, "convk_s1": 122,
                           "wba": 40, "wba_proj": 0, "wba_plain_route": 12},
    "net_unet_ha_hs_dec+fuse_proj": {"gdn": 9, "drain": 0, "conv5s2": 2, "convk_s1": 60,
                                     "wba": 4, "wba_proj": 16, "wba_plain_route": 5},
    # [entro]: B1 drains the anchors, then the non-anchors (L 128, the
    # 64-row table in shared memory); B6 takes the ELIC hyper's h_a.c0 and
    # both h_s.c0
    **{p: {"gdn": 14, "drain": 2, "conv5s2": 6, "convk_s1": 8} for p in ENTRO_PATHS},
    # [ns]: one B1 drain per wavefront, T = 2·31 + 48 = 110 at 512×768 (L
    # 256, the 1,024-row table in device memory); B6 takes ha_model.c0,
    # hs_model.c2 and the context head's c2 (2×2 maps): once in the
    # forward, once per wavefront in the encode and in the decode
    "neural_syntax": {"gdn": 14, "drain_global": 110, "conv5s2": 6,
                      "convk_s1": 3 + 2 * 110 + 3},
    # [vr]: source_net_vr's forward + roundtrip at 8 rates: source_net's
    # kernels, as many times (the gains are plain elementwise products)
    "source_net_vr": {"gdn": 14, "drain": 4, "conv5s2": 6, "convk_s1": 14},
    "train:source_net_vr": {"gdn": 7, "conv5s2": 3, "convk_s1": 5},
    # one eval forward each
    "source_net+bf16": {"gdn": 7, "drain": 0, "conv5s2": 3, "convk_s1": 5,
                        "wba": 0, "wba_proj": 0},
    "source_net+is_high": {"gdn": 1, "gdn_plain_route": 6, "drain": 0, "conv5s2": 3,
                           "convk_s1": 0, "wba": 0, "wba_proj": 0},
    # [c3]: one eval forward each of source_net_wam at is_high (N = 384, 8
    # heads: head width 48 in all 16 attentions, B4 or B5)
    "source_net_wam+is_high": {"gdn": 1, "gdn_plain_route": 6, "conv5s2": 3, "wba": 16},
    "source_net_wam+is_high+fuse_proj": {"gdn": 1, "gdn_plain_route": 6, "conv5s2": 3,
                                         "wba_proj": 16},
    # [train], [train_wam]: the forward of one training step, B = 8 at
    # 256×256; each launch also has its backward through the kernel's
    # autograd.Function (counted in ``backwards``, held equal to these)
    "train:source_net": {"gdn": 7, "conv5s2": 3, "convk_s1": 5},
    "train:source_net_wam": {"gdn": 7, "conv5s2": 3, "convk_s1": 61, "wba": 16},
    "train:source_net_wam+fuse_proj": {"gdn": 7, "conv5s2": 3, "convk_s1": 61,
                                       "wba_proj": 16},
    "train:entroformer_cb": {"gdn": 7, "conv5s2": 3, "convk_s1": 3},
    "train:neural_syntax": {"gdn": 7, "conv5s2": 3, "convk_s1": 3},
    # [eval]: one B = 1 eval forward per image, the same at every size;
    # [tune]: TUNE_ITERS training steps at B = 1, each launch with its backward
    **{f"eval:source_net@{h}x{w}": {"gdn": 7, "conv5s2": 3, "convk_s1": 5}
       for h, w in EVAL_SIZES},
    **{f"eval:net_unet_ha_hs_dec@{h}x{w}": {"gdn": 9, "conv5s2": 2, "convk_s1": 60,
                                           "wba": 20, "wba_plain_route": 5}
       for h, w in EVAL_SIZES},
    # [prog]: compress (g_a; h_a.c0, both h_s.c2 and slice 0's two c0 in B6)
    # then the full decompress (both h_s.c2, slice 0's c0s, g_s), one pass
    # of 8 each; the planes are coded on the host
    **{f"prog:{dm}@{h}x{w}": {"gdn": 7, "conv5s2": 3, "convk_s1": 9}
       for dm in PROG_DIGITS for h, w in PROG_SIZES},
    # [han]: the tail's 64-channel convs take no kernel slot (C_in 3, 64,
    # 128, 320), so source_net's launches; its phase-2 training step runs
    # the base's kernels forward only
    "han:source_net": {"gdn": 14, "drain": 4, "conv5s2": 6, "convk_s1": 14},
    "eval:han@512x768": {"gdn": 7, "conv5s2": 3, "convk_s1": 5},
    "train:han_phase2": {"gdn": 7, "conv5s2": 3, "convk_s1": 5},
    "tune:source_net": {"gdn": 7 * TUNE_ITERS, "conv5s2": 3 * TUNE_ITERS,
                        "convk_s1": 5 * TUNE_ITERS},
    "tune:source_net_wam": {"gdn": 7 * TUNE_ITERS, "conv5s2": 3 * TUNE_ITERS,
                            "convk_s1": 61 * TUNE_ITERS, "wba": 16 * TUNE_ITERS},
    # [unet]: one B = 8 eval forward each.  The rich transforms, SWAtten and
    # the WAM syntax model launch what net_unet_ha_hs_dec's forward does;
    # the U-Net hyper's convs take no slot (C_in 96, 128, 256, 512 or
    # strided) and its 5 window attentions (7 with two decoders) the plain
    # route; the latent U-Net launches nothing (3×3s at 48-256 channels,
    # plain attention).  net_unet_ha_hs_1 runs no syntax model (nothing
    # reads it: g_s gives RGB), so 16 B4 calls; net_ha has the plain
    # transforms: source_net's g_a / g_s, and slice 0's two c0s in B6
    "unet:net_ha": {"gdn": 7, "conv5s2": 3, "convk_s1": 2, "wba": 4, "wba_plain_route": 5},
    "unet:net_unet_ha_hs": {"gdn": 9, "conv5s2": 2, "convk_s1": 60, "wba": 20,
                            "wba_plain_route": 5},
    "unet:net_unet_ha_hs_1": {"gdn": 9, "conv5s2": 2, "convk_s1": 60, "wba": 16,
                              "wba_plain_route": 7},
    **{f"unet:{p}": {"gdn": 9, "conv5s2": 2, "convk_s1": 60, "wba": 20}
       for p in ("net_unet", "net_unet_1", "net_unet_005_5")},
    # [unet_train]: the forward of one step at B = 8, 256×256 (each kernel
    # launch with its backward); [unet_eval]: one B = 1 forward, and the
    # tune's steps
    "train:net_unet_ha_hs": {"gdn": 9, "conv5s2": 2, "convk_s1": 60, "wba": 20,
                             "wba_plain_route": 5},
    "train:net_unet": {"gdn": 9, "conv5s2": 2, "convk_s1": 60, "wba": 20},
    "train:net_unet_ha_hs_1": {"gdn": 9, "conv5s2": 2, "convk_s1": 60, "wba": 16,
                               "wba_plain_route": 7},
    "eval:net_unet_ha_hs@512x768": {"gdn": 9, "conv5s2": 2, "convk_s1": 60, "wba": 20,
                                    "wba_plain_route": 5},
    "eval:net_unet@512x768": {"gdn": 9, "conv5s2": 2, "convk_s1": 60, "wba": 20},
    "tune:net_unet": {"gdn": 9 * UNET_TUNE_ITERS, "conv5s2": 2 * UNET_TUNE_ITERS,
                      "convk_s1": 60 * UNET_TUNE_ITERS, "wba": 20 * UNET_TUNE_ITERS},
    # [rbs]: net_ga's kernels, and per g_s (the forward's and the decode's)
    # three more B2 (the ResidualBlockUpsamples' IGDNs) and three more B6
    # (their 3x3 at C 192); [nolrp]: source_net's (its LRP stacks take no
    # slot: C_in 240-384, 224, 128)
    "rbs:net_ga": {"gdn": 24, "drain": 4, "conv5s2": 4, "convk_s1": 136, "wba": 40},
    "rbs:net_ga+fuse_proj": {"gdn": 12, "conv5s2": 2, "convk_s1": 66, "wba": 4,
                             "wba_proj": 16},
    "nolrp:source_net": {"gdn": 14, "drain": 4, "conv5s2": 6, "convk_s1": 14},
    "train:rbs": {"gdn": 12, "conv5s2": 2, "convk_s1": 66, "wba": 20},
    # [dormant]: no module of layers/{misc,vit,haar}.py reaches a kernel
    # slot; the ERF's 3x3 at C 192 runs B6 (with its backward)
    "dormant": {"convk_s1": 1},
    # [resume]: the forwards of source_net's three training steps, straight
    # and resumed
    "resume": {"gdn": 7 * 6, "conv5s2": 3 * 6, "convk_s1": 5 * 6},
}
TRAIN_BATCH, TRAIN_CROP, TRAIN_STEPS = 8, 256, 6
# a gradient through a kernel's autograd.Function against autograd of the
# plain version in float64 on the same inputs and cotangent (B2: its
# closed form in float64): max |difference| within GRAD_TOL of the
# reference's largest magnitude.  A conv weight gradient is one fp32 sum
# of B·H·W = 32,768 products per element in cuDNN's backward (the plain
# conv's own, and the JAX package's XLA VJP sums in fp32 too): on an H100
# the 3×3 at 64×64 lands 2.46e-5 of its range off float64, so the B3/B6
# weight gradients are held at WGRAD_TOL.  Every gradient is also held
# within FP32_TOL of autograd of the plain version in fp32 (the same cuDNN
# and matmul calls: the Function's backward is the plain gradient)
GRAD_TOL = 1e-5
WGRAD_TOL = 1e-4
FP32_TOL = 1e-6
PATHS = ("source_net", "source_net_wam", "net_ga", "net_unet_ha_hs_dec")
# the bf16 forward against the fp32 one, stage by stage on the same input:
# within this share of the fp32 stage's largest magnitude (the port's CPU
# test holds bf16 to the JAX bf16 forward at the same share)
BF16_STAGE = 0.03
# a bf16 kernel output against the plain version in float64 on the same
# bf16 values: one bf16 rounding (half an ulp, 2**-9 of the value) over the
# fp32 kernel's own error
BF16_RTOL, BF16_ATOL = 2 ** -8, 1e-5


def _say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def _cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call between CUDA events, after one warm-up."""
    import torch

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


class Tally:
    """Per-kernel sums over the shapes checked: max error, times, bound
    (operations at ``peak`` FLOP/s)."""

    def __init__(self, peak=PEAK_FP32):
        self.peak = peak  # unless add() names the shape's own
        self.err = 0.0
        self.ms = self.plain_ms = 0.0
        self.library_ms = None
        self.bytes_ms = self.ops_ms = self.bound_ms = 0.0

    def add(self, err, ms, plain_ms, library_ms, nbytes, flops, peak=None):
        self.err = max(self.err, err)
        self.ms += ms
        self.plain_ms += plain_ms
        if library_ms is not None:
            self.library_ms = (self.library_ms or 0.0) + library_ms
        b, o = nbytes / PEAK_BYTES * 1e3, flops / (peak or self.peak) * 1e3
        self.bytes_ms += b
        self.ops_ms += o
        self.bound_ms += max(b, o)

    def row(self, **kw):
        return dict(kw, max_abs_err=self.err, ms=round(self.ms, 4),
                    plain_ms=round(self.plain_ms, 4),
                    bound_ms=round(self.bound_ms, 4),
                    bound_by="operations" if self.ops_ms >= self.bytes_ms else "bytes",
                    library_ms=None if self.library_ms is None else round(self.library_ms, 4))


def _vs_plain(name, kernel, plain, args, library=None, reps=5, f64=True):
    """Kernel vs plain at TOL — the plain version run in float64 on the same
    inputs if ``f64`` — and a repeat call bit-identical.  → (max error,
    kernel ms, plain ms, library ms, max difference from the fp32 plain
    version)."""
    import torch

    up = lambda a: a.double() if torch.is_tensor(a) and a.is_floating_point() else a
    with torch.no_grad():
        y = kernel(*args)
        err32 = float((y - plain(*args)).abs().max())
        ref = plain(*map(up, args)) if f64 else plain(*args)
        torch.cuda.synchronize()
        err = float((y.to(ref.dtype) - ref).abs().max())
        torch.testing.assert_close(y.to(ref.dtype), ref, atol=TOL, rtol=TOL,
                                   msg=lambda m: f"{name}: {m}")
        if not torch.equal(kernel(*args), y):
            raise AssertionError(f"{name}: a repeat call is not bit-identical")
        del y, ref
        ms = _cuda_ms(lambda: kernel(*args), reps)
        pms = _cuda_ms(lambda: plain(*args), reps)
        lms = None if library is None else _cuda_ms(library, reps)
    return err, ms, pms, lms, err32


def _roofline(ms, library_ms, nbytes, flops, peak=PEAK_FP32) -> dict:
    """The bound of one call (bytes over the HBM rate or FLOPs over
    ``peak``, the larger), which side sets it, the kernel's share of it and
    its time against the library yardstick."""
    b, o = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    bound = max(b, o)
    return dict(bound_ms=f"{bound:.4f}", bound_by="operations" if o >= b else "bytes",
                share_of_bound=f"{bound / ms:.3f}", vs_library=f"{ms / library_ms:.3f}")


def _escape_share(calls, offsets, nsyms, lanes=LANES):
    """Over drain calls [(decoded (B, S), rows (B, S), s_tot)], the share of
    symbols that escape their table row (a value outside [offset, offset +
    nsyms)) and the share of (stream, chunk of ``lanes``) with an escape,
    the chunks that take the kernel's escape path."""
    import numpy as np

    n_sym = n_esc = n_chunk = n_chunk_esc = 0
    for dec, rows, s_tot in calls:
        rel = dec[:, :s_tot].astype(np.int64) - offsets[rows[:, :s_tot]]
        esc = (rel < 0) | (rel >= nsyms)
        pad = -s_tot % lanes
        chunks = np.pad(esc, ((0, 0), (0, pad))).reshape(esc.shape[0], -1, lanes).any(-1)
        n_sym, n_esc = n_sym + esc.size, n_esc + int(esc.sum())
        n_chunk, n_chunk_esc = n_chunk + chunks.size, n_chunk_esc + int(chunks.sum())
    return n_esc / n_sym, n_chunk_esc / n_chunk


def _drain_bytes(ddev, lanes_in, lanes_out, rows, dec, s_tot) -> int:
    """The bytes one B1 call must move on this run's data: its rows in and
    its values ``dec`` out (``s_tot`` a stream), the payload words it
    consumes (the pointers' advance), the lane states and pointers in and
    out, and of the table only what these symbols need: the two CDF entries
    around each distinct (row, slot) decoded (the escape slot for an
    escape) and the offsets of the rows named.  Not the coarse slot index:
    the port builds it on the host for its own search, and the function
    (``pallas_drain``) does not take it."""
    import torch

    b = rows.shape[0]
    r = rows[:, :s_tot].long()
    rel = dec[:, :s_tot].long() - ddev.offsets[r].long()
    slot = torch.where((rel < 0) | (rel >= ddev.nsyms), ddev.nsyms, rel)
    key = r * ddev.row_len + slot
    entries = torch.unique(torch.cat([key, key + 1])).numel()
    named = torch.unique(r).numel()
    words = int((lanes_out.ptr - lanes_in.ptr).sum())
    lane_words = 2 * (lanes_in.state.numel() + b)
    return 4 * (2 * b * s_tot + words + lane_words + entries + named)


def _drain_vs_plain(calls, ddev, coding):
    """B1 against its plain version on recorded drain calls [(lanes in,
    payload, rows, s_tot)] that thread one decode's lane state: bit-exact
    values, states and pointers.  → (kernel ms, plain ms, max error, lanes
    out, [(decoded, rows, s_tot)] as numpy, bytes of ``_drain_bytes``)."""
    import torch

    ms = pms = 0.0
    err, decoded, nbytes = 0, [], 0
    for lanes_in, payt, rows, s_tot in calls:
        k_lanes, k_dec = coding.rans_drain(ddev, lanes_in, payt, rows, s_tot)
        p_lanes, p_dec = coding.drain_plain(ddev, lanes_in, payt, rows, s_tot)
        torch.cuda.synchronize()
        err = max(err, int((k_dec.long() - p_dec.long()).abs().max()))
        if not (torch.equal(k_dec, p_dec) and torch.equal(k_lanes.state, p_lanes.state)
                and torch.equal(k_lanes.ptr, p_lanes.ptr)):
            raise AssertionError("B1 drain differs from its plain version")
        ms += _cuda_ms(lambda: coding.rans_drain(ddev, lanes_in, payt, rows, s_tot), 5)
        pms += _cuda_ms(lambda: coding.drain_plain(ddev, lanes_in, payt, rows, s_tot), 1)
        decoded.append((k_dec.cpu().numpy(), rows.cpu().numpy(), s_tot))
        nbytes += _drain_bytes(ddev, lanes_in, k_lanes, rows, k_dec, s_tot)
    return ms, pms, err, k_lanes, decoded, nbytes


def _inside_taps(n, n_out, k, stride, pad) -> int:
    """Over the ``n_out`` outputs of one axis of a conv (input ``n``, ``k``
    taps, ``stride``, ``pad`` zeros before), the taps that land inside the
    input: those on the zero padding multiply nothing (5 of 9 per output
    of a 3×3 on a 2×2 map)."""
    return sum(sum(0 <= o * stride - pad + j < n for j in range(k)) for o in range(n_out))


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "lic_tpu_torch")):
        print(
            "chip_smoke: lic_tpu_torch/ not found beside this script; run it "
            "from a checkout of the repository", file=sys.stderr,
        )
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2

    t_main = time.perf_counter()

    # ---- 1. device
    def query(fields):
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60,
        ).stdout.strip()

    smi = query("name,power.limit")
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    _say("device", kind=repr(kind), count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         sm_clock_max_and_now=repr(query("clocks.max.sm,clocks.sm")))

    from lic_tpu_torch import coding
    from lic_tpu_torch.coding import drain as drain_mod
    from lic_tpu_torch.layers import conv_direct, win_attention, window_attn
    from lic_tpu_torch.layers import gdn as gdn_mod
    from lic_tpu_torch.models.compress import set_numerics_flags

    set_numerics_flags()  # no TF32, deterministic cuDNN: stated in code
    counters = {
        "gdn": gdn_mod.gdn_fused, "drain": drain_mod.table_routes["smem"],
        "drain_global": drain_mod.table_routes["global"],
        "conv5s2": conv_direct.conv5s2, "convk_s1": conv_direct.convk_s1,
        "wba": window_attn.window_attention, "wba_proj": window_attn.window_attention_proj,
    }
    # the plain routes on the card, counted as the kernels are
    routes = {"gdn_plain_route": gdn_mod.gdn_plain_route,
              "wba_plain_route": win_attention.wba_plain_route}
    counted = {**counters, **routes}

    # ---- 2. build: one nvcc per CUDA source, all started together
    cuda_libs = {"b1_drain": drain_mod.library, "b2_gdn": gdn_mod.library,
                 "b3_b6_conv": conv_direct.library, "b4_b5_attn": window_attn.library}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(cuda_libs)) as pool:
        list(pool.map(lambda lib: lib(), cuda_libs.values()))
    t_cuda = time.perf_counter() - t0
    for name, lib in cuda_libs.items():
        _say("build", source=os.path.relpath(str(lib.src), ROOT), seconds=f"{lib.seconds:.1f}",
             so=os.path.relpath(str(lib.so), ROOT), ptxas=repr(lib.ptxas() or "cached"))
    host_lib = coding.load_host_rans()
    _say("build", cuda_parallel_s=f"{t_cuda:.1f}", host_rans=os.path.relpath(host_lib, ROOT))

    # B2 runs 3xTF32 on the tensor cores for C > 16, fp32 on the CUDA cores
    # below; B3/B6 run 3xTF32
    tally = {k: Tally(PEAK_TF32X3 if k in ("conv5s2", "convk_s1") else PEAK_FP32)
             for k in counters}
    g = torch.Generator().manual_seed(SEED)

    # ---- 3a. B2 vs plain at the forward's GDN/IGDN shapes (fp32)
    px = lambda f: BATCH * (H // f) * (W // f)  # pixels at 1/f scale
    gdn_shapes = [  # (stage, rows, C, inverse)
        ("g_a.gdn0", px(2), 192, False),
        ("g_a.gdn1", px(4), 192, False),
        ("g_a.gdn2", px(8), 192, False),
        ("g_s.igdn0", px(8), 192, True),
        ("g_s.igdn1", px(4), 192, True),
        ("g_s.igdn2", px(2), 192, True),
        ("g_s.igdn3", px(1), 16, True),
    ]
    for stage, rows, c, inv in gdn_shapes:
        x = torch.randn(rows, c, generator=g).to(dev)
        gamma = (0.1 * torch.eye(c) + 0.01 * torch.rand(c, c, generator=g)).to(dev)
        beta = (1.0 + torch.rand(c, generator=g)).to(dev)
        args = (x, gamma, beta, inv)
        err, ms, pms, _, _ = _vs_plain(stage, gdn_mod.gdn_fused, gdn_mod.gdn_plain, args,
                                      reps=20, f64=False)
        # an image's rows do not depend on the rows around them
        half = rows // 2 + 7
        with torch.no_grad():
            if not torch.equal(gdn_mod.gdn_fused(x[half:].clone(), gamma, beta, inv),
                               gdn_mod.gdn_fused(x, gamma, beta, inv)[half:]):
                raise AssertionError(f"{stage}: B2 rows depend on the rows around them")
        nbytes, flops = 2 * _nbytes(x) + _nbytes(gamma, beta), 2 * rows * c * c
        peak = PEAK_TF32X3 if c > 16 else PEAK_FP32
        tally["gdn"].add(err, ms, pms, None, nbytes, flops, peak)
        rl = _roofline(ms, ms, nbytes, flops, peak)
        _say("b2_gdn", stage=stage, rows=rows, C=c, inverse=inv, max_abs_err=f"{err:.3g}",
             ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}", bound_ms=rl["bound_ms"],
             bound_by=rl["bound_by"], share_of_bound=rl["share_of_bound"],
             peak="3xTF32 165 TFLOP/s" if c > 16 else "fp32 67 TFLOP/s",
             gbytes_per_s=f"{nbytes / ms / 1e6:.0f}")
        del x, args
    _say("b2_occupancy", **dict(zip(("smem_per_cta", "ctas_per_sm"), gdn_mod.occupancy())))
    for line in gdn_mod.library.ptxas():
        _say("b2_ptxas", kernel=repr(line))

    # ---- 3b. B1 vs plain: 4 slice drains threading state, B=8, L=128
    s_slice = (H // 16) * (W // 16) * 48  # 73 728 symbols per slice
    gcoder = coding.GaussianCoder()
    cdfs, offsets = gcoder.codec.cdfs, gcoder.codec.offsets
    sym, idx, pay, ends = coding.random_streams(
        cdfs, offsets, [(SEED + i, True) for i in range(BATCH)], [s_slice] * 4, LANES
    )
    ddev = coding.DeviceRans16Interleaved(cdfs, offsets, LANES, device=dev)
    payt = torch.from_numpy(pay).to(dev)
    # the 4 slice calls of one decode, each slice's lanes those the plain
    # version leaves after the previous slice
    calls, lanes = [], ddev.init_lanes(payt)
    for i in range(4):
        rows = torch.from_numpy(idx[:, i * s_slice : (i + 1) * s_slice].copy()).to(dev)
        calls.append((lanes, payt, rows, s_slice))
        lanes, _ = coding.drain_plain(ddev, lanes, payt, rows, s_slice)
    ms, pms, err, k_lanes, decoded, nbytes = _drain_vs_plain(calls, ddev, coding)
    np.testing.assert_array_equal(np.concatenate([d for d, _, _ in decoded], 1), sym)
    if not (bool((k_lanes.state == 1 << 16).all()) and k_lanes.ptr.tolist() == ends):
        raise AssertionError("B1 drain: final lane states or pointers wrong")
    # bound: the bytes of _drain_bytes; its integer work per symbol has no
    # peak in the table
    tally["drain"].add(err, ms, pms, None, nbytes, 0)
    sym_share, chunk_share = _escape_share(decoded, offsets, ddev.nsyms)
    _say("b1_drain", streams="stress", batch=BATCH, lanes=LANES, slices=4,
         symbols_per_slice=s_slice, bitexact=True, escape_share_symbols=f"{sym_share:.4f}",
         escape_share_chunks=f"{chunk_share:.4f}", ms_4_slices=f"{ms:.3f}",
         plain_ms_4_slices=f"{pms:.3f}", route=drain_mod.route(ddev),
         bound_ms=f"{nbytes / PEAK_BYTES * 1e3:.4f}")
    del payt, calls, decoded
    _b1_lanes_and_routes(dev, coding, drain_mod, tally)

    def cl(t):
        return t.to(dev).contiguous(memory_format=torch.channels_last)

    # ---- 3c. B4 and B5 vs plain at both gate sizes, with the shift mask;
    # library: SDPA (B4), F.linear + SDPA + F.linear (B5) on the windows
    occ = ("smem_per_cta", "ctas_per_sm")
    _attn_vs_plain(192, 8, g, dev, tally, "")
    # [c3]: the hd-48 instantiations (source_net_wam at is_high: C 384, 8 heads)
    _attn_vs_plain(384, 8, g, dev, tally, "c3_")
    for line in window_attn.library.ptxas():
        if "wba" in line:
            _say("b4_b5_ptxas", kernel=repr(line))
    torch.cuda.empty_cache()

    # ---- 4. the paths, with [c5], [eval], [tune] and [cli]; [entro], [ns]
    launches, times, conv_calls, attn_calls, gdn_calls = {}, {}, {}, {}, {}
    train_shapes = {"gdn": {}, "conv": {}, "attn": {}}  # for [grad]
    real_drain_ms = {}  # B1 route → ms of the recorded real B=8 decode's drains
    for preset in PATHS + ENTRO_PATHS + NS_PATHS:
        runs, t, drain_sets = _drive(preset, dev, counted, conv_calls, attn_calls, gdn_calls,
                                     train_shapes)
        launches.update(runs)
        times[preset] = t
        # B1 on the streams of real decodes: B=8, one stream, a CLI chunk
        for label, drains in drain_sets.items():
            ddev_real = drains[0][0]
            route = drain_mod.route(ddev_real)
            ms, pms, err, _, decoded, nbytes = _drain_vs_plain(
                [c[1:] for c in drains], ddev_real, coding)
            sym_share, chunk_share = _escape_share(
                decoded, ddev_real.offsets.cpu().numpy(), ddev_real.nsyms, ddev_real.n_lanes)
            if label == f"{preset} B={BATCH} decode":
                real_drain_ms.setdefault(route, ms)  # source_net's, neural_syntax's
                times[preset]["b1_decode_ms"] = ms
            _say("b1_drain", streams=label, batch=drains[0][3].shape[0], calls=len(drains),
                 lanes=ddev_real.n_lanes, table_rows=ddev_real.rows, route=route,
                 symbols_per_call=sorted({c[4] for c in drains}), bitexact=True,
                 escape_share_symbols=f"{sym_share:.4f}",
                 escape_share_chunks=f"{chunk_share:.4f}", ms=f"{ms:.3f}",
                 ms_per_call=f"{ms / len(drains):.4f}", plain_ms=f"{pms:.3f}",
                 bound_ms=f"{nbytes / PEAK_BYTES * 1e3:.4f}")
            del drains, decoded
        if preset in ENTRO_PATHS + NS_PATHS:
            _say("entro" if preset in ENTRO_PATHS else "ns", preset=preset,
                 launches=runs[preset], **{k: (f"{v:.4f}" if isinstance(v, float) else v)
                                           for k, v in times[preset].items()})
        torch.cuda.empty_cache()

    # ---- [c7], [vr] (with [serve]): the variable-rate slice
    t_vr = time.perf_counter()
    _c7(dev)
    torch.cuda.empty_cache()
    launches.update(_drive_vr(dev, counted, conv_calls, gdn_calls, train_shapes))
    torch.cuda.empty_cache()
    _say("wall", c7_vr_serve_s=f"{time.perf_counter() - t_vr:.1f}")

    # ---- [c8], [prog], [han], [han_train]: card streams on the CPU, the
    # progressive coder and the HAN tail
    t_new = time.perf_counter()
    _c8(dev)
    torch.cuda.empty_cache()
    launches.update(_drive_prog(dev, counted))
    torch.cuda.empty_cache()
    launches.update(_drive_han(dev, counted, conv_calls, gdn_calls, train_shapes))
    torch.cuda.empty_cache()
    _say("wall", c8_prog_han_s=f"{time.perf_counter() - t_new:.1f}")

    # ---- [unet], [unet_train], [unet_eval]: the U-Net-hyper and latent
    # U-Net presets
    t_unet = time.perf_counter()
    launches.update(_drive_unet(dev, counted, conv_calls, attn_calls, gdn_calls, train_shapes))
    torch.cuda.empty_cache()
    _say("wall", unet_s=f"{time.perf_counter() - t_unet:.1f}")

    # ---- [rbs], [nolrp], [rbs_train]; [dormant], [resume]
    t_new = time.perf_counter()
    launches.update(_drive_rbs_nolrp(dev, counted, conv_calls, attn_calls, gdn_calls,
                                     train_shapes))
    torch.cuda.empty_cache()
    _say("wall", rbs_nolrp_s=f"{time.perf_counter() - t_new:.1f}")
    t_new = time.perf_counter()
    launches.update(_dormant(dev, counted))
    launches.update(_resume(dev, counted))
    torch.cuda.empty_cache()
    _say("wall", dormant_resume_s=f"{time.perf_counter() - t_new:.1f}")

    # ---- 5. source_net in bf16 and at is_high, one forward each; [c3]
    # source_net_wam at is_high, with and without fuse_proj
    launches.update(_drive_variants(dev, counted, conv_calls))
    torch.cuda.empty_cache()
    launches.update(_drive_c3(dev, counted, conv_calls))
    torch.cuda.empty_cache()

    # ---- [train], [train_wam]: the training step on the card
    launches.update(_drive_train(dev, counted, train_shapes))
    torch.cuda.empty_cache()
    for run, want in EXPECTED.items():
        want = {k: want.get(k, 0) for k in counted}
        if launches[run] != want:
            raise AssertionError(f"{run}: kernel launches {launches[run]}, expected {want}")
    _say("launches", **{k.replace("+", "_"): v for k, v in launches.items()})

    # ---- 6. B4 vs plain at the paths' other (shape, window, shift)s
    # (a shift mask of the map's window grid stands for the path's own: the
    # kernel adds whichever mask it is given)
    for (shape, ws, nh, masked), by_run in attn_calls.items():
        if (shape, ws, nh, masked) in (((BATCH, H // 4, W // 4, 576), 8, 8, True),
                                       ((BATCH, H // 16, W // 16, 576), 4, 8, True)):
            continue  # checked in 3c
        b, hp, wp, c3 = shape
        c, n, ss = c3 // 3, ws * ws, ws // 2
        hd = c // nh
        rel = (0.5 * torch.randn(nh, n, n, generator=g)).to(dev)
        mask = window_attn.shift_mask(hp, wp, ws, ss, 0, 0, dev) if masked else None
        qkv = torch.randn(b, hp, wp, 3 * c, generator=g).to(dev)
        nwin = b * (hp // ws) * (wp // ws)
        heads = lambda t: t.reshape(nwin, n, nh, hd).transpose(1, 2)
        qkv_w = window_attn.window_partition(qkv, ws)
        q, kk, v = (heads(qkv_w[..., i * c : (i + 1) * c]) for i in range(3))
        amask = rel[None].expand(nwin, -1, -1, -1)
        if mask is not None:
            amask = (rel[None, None] + mask[None, :, None]).expand(b, -1, -1, -1, -1)
            amask = amask.reshape(nwin, nh, n, n)
        flops = nwin * nh * 4 * n * n * hd
        err, ms, pms, lms, err32 = _vs_plain(
            f"wba ws{ws} {(b, hp, wp, c)}", window_attn.window_attention,
            window_attn.wba_plain, (qkv, rel, mask, ws, nh),
            library=lambda: F.scaled_dot_product_attention(q, kk, v, attn_mask=amask),
        )
        nbytes = _nbytes(qkv, rel, mask) + qkv.numel() // 3 * 4
        tally["wba"].add(err, ms, pms, lms, nbytes, flops)
        _say("b4_wba", ws=ws, masked=masked, shape=shape, head_dim=hd,
             path_launches=by_run, max_abs_err=f"{err:.3g}", vs_fp32_plain=f"{err32:.3g}",
             ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}", sdpa_ms=f"{lms:.4f}",
             **_roofline(ms, lms, nbytes, flops),
             **dict(zip(occ, window_attn.occupancy(False, ws, hd, c))))
        del qkv, q, kk, v, qkv_w, amask
    torch.cuda.empty_cache()

    # ---- 6b. B2 vs plain (as in 3a) at every (rows, C, inverse) that the
    # paths, [eval], [train] and [tune] gave it beyond those of 3a
    done = {(rows, c, inv) for _, rows, c, inv in gdn_shapes}
    for rows, c, inv in sorted((set(gdn_calls) | set(train_shapes["gdn"])) - done):
        x = torch.randn(rows, c, generator=g).to(dev)
        gamma = (0.1 * torch.eye(c) + 0.01 * torch.rand(c, c, generator=g)).to(dev)
        beta = (1.0 + torch.rand(c, generator=g)).to(dev)
        err, ms, pms, _, _ = _vs_plain(f"gdn {(rows, c, inv)}", gdn_mod.gdn_fused,
                                      gdn_mod.gdn_plain, (x, gamma, beta, inv), f64=False)
        nbytes, flops = 2 * _nbytes(x) + _nbytes(gamma, beta), 2 * rows * c * c
        peak = PEAK_TF32X3 if c > 16 else PEAK_FP32
        tally["gdn"].add(err, ms, pms, None, nbytes, flops, peak)
        rl = _roofline(ms, ms, nbytes, flops, peak)
        _say("b2_gdn", rows=rows, C=c, inverse=inv, path_launches=gdn_calls.get((rows, c, inv)),
             train_tune_calls=train_shapes["gdn"].get((rows, c, inv)), max_abs_err=f"{err:.3g}",
             ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}", bound_ms=rl["bound_ms"],
             bound_by=rl["bound_by"], share_of_bound=rl["share_of_bound"])
        del x
    torch.cuda.empty_cache()

    # ---- 7. B3 and B6 vs plain at every (shape, flags) the paths gave them;
    # library: cuDNN conv + bias on the same (padded) input
    for key, by_run in conv_calls.items():
        slot, xs, wshape, has_bias, act, has_res = key
        b, cin, hh, ww = xs
        cout, _, k, _ = wshape
        ho, wo = (hh // 2, ww // 2) if slot == "conv5s2" else (hh, ww)
        x = cl(torch.randn(*xs, generator=g))
        wt = cl(torch.randn(*wshape, generator=g) * (cin * k * k) ** -0.5)
        bias = torch.randn(cout, generator=g).to(dev) if has_bias else None
        res = cl(torch.randn(b, cout, ho, wo, generator=g)) if has_res else None
        if slot == "conv5s2":
            xp = F.pad(x, (1, 2, 1, 2))
            args, library = (x, wt, bias), lambda: F.conv2d(xp, wt, bias, stride=2)
        else:
            args, library = (x, wt, bias, act, res), lambda: F.conv2d(x, wt, bias, padding=k // 2)
        err, ms, pms, lms, err32 = _vs_plain(
            f"{slot} {xs} -> {cout} k{k}", counters[slot], getattr(conv_direct, f"{slot}_plain"),
            args, library=library,
        )
        prepack_ms = _cuda_ms(lambda: conv_direct.pack_weight(wt), 5)
        nbytes = _nbytes(x, wt, bias, res) + b * cout * ho * wo * 4
        stride, pad = (2, 1) if slot == "conv5s2" else (1, k // 2)
        flops = (2 * b * cout * cin * _inside_taps(hh, ho, k, stride, pad)
                 * _inside_taps(ww, wo, k, stride, pad))
        tally[slot].add(err, ms, pms, lms, nbytes, flops)
        _say(f"b{3 if slot == 'conv5s2' else 6}_{slot}", shape=xs, c_out=cout, k=k,
             bias=has_bias, act=act, residual=has_res, path_launches=by_run,
             max_abs_err=f"{err:.3g}", vs_fp32_plain=f"{err32:.3g}", ms=f"{ms:.4f}",
             tflops=f"{flops / ms / 1e9:.1f}", plain_ms=f"{pms:.3f}", cudnn_ms=f"{lms:.3f}",
             **_roofline(ms, lms, nbytes, flops, PEAK_TF32X3), peak="3xTF32 165 TFLOP/s",
             weight_prepack_ms=f"{prepack_ms:.4f}")
        if "source_net+bf16" in by_run:
            # bf16 tensors: widened to fp32 at the kernel, the output
            # rounded back; against the plain version in float64
            bargs = tuple(a.bfloat16() if torch.is_tensor(a) else a for a in args)
            up = lambda a: a.double() if torch.is_tensor(a) else a
            with torch.no_grad():
                yb = counters[slot](*bargs)
                ref = getattr(conv_direct, f"{slot}_plain")(*map(up, bargs))
                torch.cuda.synchronize()
                berr = float((yb.double() - ref).abs().max())
                torch.testing.assert_close(yb.double(), ref, atol=BF16_ATOL, rtol=BF16_RTOL,
                                           msg=lambda m: f"{slot} bf16 {xs}: {m}")
                bms = _cuda_ms(lambda: counters[slot](*bargs), 5)
                cudnn_bf16_ms = _cuda_ms(lambda: getattr(conv_direct, f"{slot}_plain")(*bargs), 5)
            del yb, ref
            _say(f"b{3 if slot == 'conv5s2' else 6}_{slot}_bf16", shape=xs, c_out=cout, k=k,
                 dtype="bfloat16", max_abs_err_vs_f64=f"{berr:.3g}", ms=f"{bms:.4f}",
                 fp32_ms=f"{ms:.4f}", cast_cost_ms=f"{bms - ms:.4f}",
                 plain_bf16_ms=f"{cudnn_bf16_ms:.4f}")
    _say("b3_b6_occupancy", **dict(zip(occ, conv_direct.occupancy())))
    for line in conv_direct.library.ptxas():
        _say("b3_b6_ptxas", kernel=repr(line))
    torch.cuda.empty_cache()

    # ---- [grad]: each kernel's backward at every shape the training paths
    # gave it
    _grad_checks(train_shapes, dev, g)
    torch.cuda.empty_cache()

    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "lic_tpu"))
    if bad:
        raise AssertionError(f"the port imported the JAX package or jax: {bad[:5]}")
    meta = {
        "drain": ("rans_drain (table in shared memory)", "cuda",
                  "lic_tpu_torch/csrc/rans_drain.cu", "lic_tpu/coding/pallas_rans.py:93"),
        "drain_global": ("rans_drain (table in device memory)", "cuda",
                         "lic_tpu_torch/csrc/rans_drain.cu", "lic_tpu/coding/pallas_rans.py:93"),
        "gdn": ("gdn_fwd", "cuda", "lic_tpu_torch/csrc/gdn.cu",
                "lic_tpu/layers/pallas_gdn.py:31"),
        "conv5s2": ("conv5s2", "cuda", "lic_tpu_torch/csrc/conv_direct.cu",
                    "lic_tpu/layers/pallas_conv.py:47 (B3; B3' conv5s2_pallas_v2 "
                    "lic_tpu/layers/pallas_conv.py:107 computes the same function)"),
        "wba": ("window_attention", "cuda", "lic_tpu_torch/csrc/window_attn.cu",
                "lic_tpu/layers/pallas_attn.py:112"),
        "wba_proj": ("window_attention_proj", "cuda", "lic_tpu_torch/csrc/window_attn.cu",
                     "lic_tpu/layers/pallas_attn.py:150"),
        "convk_s1": ("convk_s1", "cuda", "lic_tpu_torch/csrc/conv_direct.cu",
                     "lic_tpu/layers/pallas_conv_s1.py:66"),
    }
    rows = []
    for key, (name, route, source, replaces) in meta.items():
        by_path = {run: n[key] for run, n in launches.items() if n[key]}
        rows.append(tally[key].row(
            name=name, route=route, source=source, replaces=replaces,
            launches=sum(by_path.values()), launches_by_path=by_path,
        ))
        if key in ("drain", "drain_global"):  # ms and bound are the stress streams'
            rows[-1]["real_decode_ms"] = round(real_drain_ms["smem" if key == "drain"
                                                             else "global"], 4)
    _say("wall", total_s=f"{time.perf_counter() - t_main:.1f}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def _b1_lanes_and_routes(dev, coding, drain_mod, tally):
    """[b1_lanes] B1 against its plain version on stress streams (1 symbol
    in 17 escaping) at every lane count of ``B1_LANES``, on the 64-row
    Gaussian table and on ``GaussianMuCoder``'s 1,024 rows: B = 8 streams,
    three calls of ``B1_WAVEFRONT`` symbols threading the state, bit-exact,
    each launch counted in the route ``drain_mod.route`` names.  The
    1,024-row table at L = 256 (a 512×768 neural-syntax wavefront) goes
    into the tally of the device-memory route."""
    import torch

    tables = {"gaussian_64": coding.GaussianCoder(), "gaussian_mu_1024": coding.GaussianMuCoder()}
    steps = [B1_WAVEFRONT] * 3
    for tname, coder in tables.items():
        cdfs, offsets = coder.codec.cdfs, coder.codec.offsets
        for lanes in B1_LANES:
            sym, idx, pay, ends = coding.random_streams(
                cdfs, offsets, [(SEED + 40 + i, True) for i in range(BATCH)], steps, lanes)
            ddev = coding.DeviceRans16Interleaved(cdfs, offsets, lanes, device=dev)
            payt = torch.from_numpy(pay).to(dev)
            route = drain_mod.route(ddev)
            calls, lstate = [], ddev.init_lanes(payt)
            for i, m in enumerate(steps):
                rows = torch.from_numpy(idx[:, i * m : (i + 1) * m].copy()).to(dev)
                calls.append((lstate, payt, rows, m))
                lstate, _ = coding.drain_plain(ddev, lstate, payt, rows, m)
            before = drain_mod.table_routes[route].launches
            ms, pms, err, k_lanes, decoded, nbytes = _drain_vs_plain(calls, ddev, coding)
            if drain_mod.table_routes[route].launches == before:
                raise AssertionError(f"B1 L={lanes} {tname}: no launch on the {route} route")
            import numpy as np

            np.testing.assert_array_equal(np.concatenate([d for d, _, _ in decoded], 1), sym)
            if not (bool((k_lanes.state == 1 << 16).all()) and k_lanes.ptr.tolist() == ends):
                raise AssertionError(f"B1 L={lanes} {tname}: final lane states or pointers")
            sym_share, chunk_share = _escape_share(decoded, offsets, ddev.nsyms, lanes)
            if tname == "gaussian_mu_1024" and lanes == 256:
                tally["drain_global"].add(err, ms, pms, None, nbytes, 0)
            _say("b1_lanes", table=tname, rows=cdfs.shape[0], lanes=lanes, route=route,
                 batch=BATCH, calls=len(steps), symbols_per_call=B1_WAVEFRONT, bitexact=True,
                 escape_share_symbols=f"{sym_share:.4f}",
                 escape_share_chunks=f"{chunk_share:.4f}", ms_per_call=f"{ms / 3:.4f}",
                 plain_ms_per_call=f"{pms / 3:.3f}",
                 bound_ms_per_call=f"{nbytes / 3 / PEAK_BYTES * 1e3:.4f}")
            del payt, calls, decoded
    torch.cuda.empty_cache()


def _attn_vs_plain(c, nh, g, dev, tally, tag):
    """B4 and B5 against their plain versions (float64) at both gate sizes
    of a B=8 512×768 map of width ``c`` over ``nh`` heads, with the shift
    mask; library: SDPA (B4), F.linear + SDPA + F.linear (B5) on the
    windows.  Each shape's line goes out under ``tag`` + b4_wba / b5_wba_proj."""
    import torch
    import torch.nn.functional as F

    from lic_tpu_torch.layers import window_attn

    occ = ("smem_per_cta", "ctas_per_sm")
    for hp, wp, ws, ss in ((H // 4, W // 4, 8, 4), (H // 16, W // 16, 4, 2)):
        n, hd = ws * ws, c // nh
        nwin = BATCH * (hp // ws) * (wp // ws)
        rel = (0.5 * torch.randn(nh, n, n, generator=g)).to(dev)
        mask = window_attn.shift_mask(hp, wp, ws, ss, 0, 0, dev)
        qkv = torch.randn(BATCH, hp, wp, 3 * c, generator=g).to(dev)
        x = torch.randn(BATCH, hp, wp, c, generator=g).to(dev)
        wqkv = (torch.randn(3 * c, c, generator=g) * c ** -0.5).to(dev)
        wproj = (torch.randn(c, c, generator=g) * c ** -0.5).to(dev)
        bqkv, bproj = torch.randn(3 * c, generator=g).to(dev), torch.randn(c, generator=g).to(dev)
        amask = (rel[None, None] + mask[None, :, None]).expand(BATCH, -1, -1, -1, -1)
        amask = amask.reshape(nwin, nh, n, n)
        heads = lambda t: t.reshape(nwin, n, nh, hd).transpose(1, 2)
        qkv_w = window_attn.window_partition(qkv, ws)
        q, kk, v = (heads(qkv_w[..., i * c : (i + 1) * c]) for i in range(3))
        x_w = window_attn.window_partition(x, ws)

        def sdpa_proj():
            t = F.linear(x_w, wqkv, bqkv)
            o = F.scaled_dot_product_attention(
                heads(t[..., :c]), heads(t[..., c : 2 * c]), heads(t[..., 2 * c :]),
                attn_mask=amask)
            return F.linear(o.transpose(1, 2).reshape(nwin, n, c), wproj, bproj)

        flops = nwin * nh * 4 * n * n * hd
        err, ms, pms, lms, err32 = _vs_plain(
            f"wba ws{ws} C{c}", window_attn.window_attention, window_attn.wba_plain,
            (qkv, rel, mask, ws, nh),
            library=lambda: F.scaled_dot_product_attention(q, kk, v, attn_mask=amask),
        )
        nbytes = _nbytes(qkv, rel, mask) + qkv.numel() // 3 * 4
        tally["wba"].add(err, ms, pms, lms, nbytes, flops)
        _say(f"{tag}b4_wba", ws=ws, shift=ss, shape=tuple(qkv.shape), head_dim=hd,
             max_abs_err=f"{err:.3g}", vs_fp32_plain=f"{err32:.3g}",
             ms=f"{ms:.3f}", plain_ms=f"{pms:.3f}", sdpa_ms=f"{lms:.3f}",
             **_roofline(ms, lms, nbytes, flops),
             **dict(zip(occ, window_attn.occupancy(False, ws, hd, c))))
        flops5 = flops + 2 * nwin * n * c * 4 * c
        err, ms, pms, lms, err32 = _vs_plain(
            f"wba_proj ws{ws} C{c}", window_attn.window_attention_proj,
            window_attn.wba_proj_plain,
            (x, rel, wqkv, bqkv, wproj, bproj, mask, ws, nh), library=sdpa_proj,
        )
        nbytes = 2 * _nbytes(x) + _nbytes(rel, mask, wqkv, bqkv, wproj, bproj)
        tally["wba_proj"].add(err, ms, pms, lms, nbytes, flops5)
        _say(f"{tag}b5_wba_proj", ws=ws, shift=ss, shape=tuple(x.shape), head_dim=hd,
             max_abs_err=f"{err:.3g}", vs_fp32_plain=f"{err32:.3g}",
             ms=f"{ms:.3f}", plain_ms=f"{pms:.3f}", linear_sdpa_linear_ms=f"{lms:.3f}",
             **_roofline(ms, lms, nbytes, flops5),
             **dict(zip(occ, window_attn.occupancy(True, ws, hd, c))))
        del qkv, x, q, kk, v, qkv_w, x_w, amask
    torch.cuda.empty_cache()


def _counted_forward(model, counters, conv_calls, run, fn):
    """``fn()`` under no_grad with every counter zeroed just before and read
    just after, and the model's B3/B6 calls recorded under ``run``; the
    output checked finite and of the full shape.  → (output, launches)."""
    import torch

    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    hooks = _record_conv_slots(model, conv_calls, run)
    with torch.no_grad():
        out = fn()
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    counts = {k: c.launches for k, c in counters.items()}
    _hooks_agree(run, counts, conv_calls)
    if not (torch.isfinite(out.x_tilde).all() and torch.isfinite(out.bpp)):
        raise AssertionError(f"{run}: non-finite forward output")
    if out.x_tilde.shape != (BATCH, 3, H, W):
        raise AssertionError(f"{run}: shape {tuple(out.x_tilde.shape)}")
    return out, counts


def _drive_c3(dev, counters, conv_calls):
    """[c3] ``source_net_wam`` at ``is_high`` (N = 384 over 8 heads: head
    width 48 in every attention): its stages at 128×128 against its CPU
    run (plain versions) within 1e-4, then one B=8 512×768 eval forward
    with B4 and one with ``fuse_proj`` (B5), launches counted, g_a's latent
    and the synthesis of one latent within 1e-4 of each other.  → {run:
    launches}."""
    import numpy as np
    import torch

    from lic_tpu_torch.data import smooth_images
    from lic_tpu_torch.layers import WindowAttention
    from lic_tpu_torch.models import build_model

    model = build_model("source_net_wam", device=dev, seed=SEED, is_high=True)
    cpu_model = build_model("source_net_wam", device="cpu", seed=SEED, is_high=True)
    woken = _wake_zero_leaves(model, cpu_model)
    x_np = smooth_images(np.random.default_rng(SEED), BATCH, H, W)
    x = torch.from_numpy(x_np).to(dev).contiguous(memory_format=torch.channels_last)
    small = torch.from_numpy(x_np[:1, :, :128, :128].copy())
    errs = _small_vs_cpu(model, cpu_model, small, dev)
    if max(errs.values()) > RECON_TOL:
        raise AssertionError(f"c3: GPU stages disagree with the CPU run: {errs}")
    del cpu_model
    attn = [m for m in model.modules() if isinstance(m, WindowAttention)]
    runs, mp = {}, BATCH * H * W / 1e6
    out, runs["source_net_wam+is_high"] = _counted_forward(
        model, counters, conv_calls, "source_net_wam+is_high", lambda: model(x))
    with torch.no_grad():
        z3 = model.analyze(x)
        syn = model.syntax_from_latent(z3)
        rec = model.synthesize(out.extras["y_hat"], syn)
        ms = _cuda_ms(lambda: model(x), 2)
        for m in attn:
            m.fuse_proj = True
        out5, runs["source_net_wam+is_high+fuse_proj"] = _counted_forward(
            model, counters, conv_calls, "source_net_wam+is_high+fuse_proj", lambda: model(x))
        fz = {"z3": float((model.analyze(x) - z3).abs().max()),
              "synthesis": float((model.synthesize(out.extras["y_hat"], syn) - rec).abs().max())}
        ms5 = _cuda_ms(lambda: model(x), 2)
    if max(fz.values()) > RECON_TOL:
        raise AssertionError(f"c3: the fuse_proj forward differs: {fz}")
    _say("c3_forward", preset="source_net_wam", is_high=True, N=model.cfg.N, head_dim=48,
         leaves_woken=woken, small_vs_cpu_max_err=f"{max(errs.values()):.3g}",
         fuse_proj_vs_b4=json.dumps({k: float(f"{v:.3g}") for k, v in fz.items()}),
         launches=runs["source_net_wam+is_high"],
         launches_fuse_proj=runs["source_net_wam+is_high+fuse_proj"],
         bpp_est=f"{float(out.bpp):.4f}", forward_ms=f"{ms:.2f}", forward_mps=f"{mp / ms * 1e3:.2f}",
         forward_fuse_proj_ms=f"{ms5:.2f}", batch=BATCH, shape=f"{H}x{W}", weights="UNTRAINED")
    return runs


def _small_vs_cpu(model, cpu_model, small, dev):
    """z3, μ0, σ0 and the reconstruction of ``model`` (on the card) against
    ``cpu_model`` on the same 1-image input and the same decoded values.
    → {stage: max abs difference}."""
    import torch

    with torch.no_grad():
        ref = cpu_model(small)
        z3c = cpu_model.analyze(small)
        z3g = model.analyze(small.to(dev).contiguous(memory_format=torch.channels_last))
        med = cpu_model.eb_medians()[None, :, None, None]
        z_hat = torch.round(cpu_model.hyper_encode(z3c) - med) + med
        s_c, m_c = cpu_model.hyper_decode(z_hat)
        s_g, m_g = model.hyper_decode(z_hat.to(dev).contiguous(memory_format=torch.channels_last))
        mu_c, sg_c, _ = cpu_model.charm_entropy_params(m_c, s_c, [], 0)
        mu_g, sg_g, _ = model.charm_entropy_params(m_g, s_g, [], 0)
        syn = cpu_model.syntax_from_latent(z3c)
        rec_g = model.synthesize(ref.extras["y_hat"].to(dev), syn.to(dev))
        errs = {"z3": (z3g.cpu() - z3c), "mu0": (mu_g.cpu() - mu_c),
                "sigma0": (sg_g.cpu() - sg_c), "rec": (rec_g.cpu() - ref.x_tilde)}
    return {k: float(v.abs().max()) for k, v in errs.items()}


def _train_batch(dev):
    """B = 8 random 256×256 crops of seeded ``smooth_images`` (512×768), NCHW
    channels_last on ``dev``: no dataset ships with the repository."""
    import numpy as np
    import torch

    from lic_tpu_torch.data import smooth_images

    rng = np.random.default_rng(SEED + 3)
    imgs = smooth_images(rng, TRAIN_BATCH, H, W)
    crops = []
    for im in imgs:
        top, left = int(rng.integers(0, H - TRAIN_CROP + 1)), int(rng.integers(0, W - TRAIN_CROP + 1))
        crops.append(im[:, top : top + TRAIN_CROP, left : left + TRAIN_CROP])
    return torch.from_numpy(np.stack(crops)).to(dev).contiguous(memory_format=torch.channels_last)


def _record_train_shapes(model, shapes):
    """Pre-hooks recording every GDN call B2 takes (rows, C, inverse) and
    every window attention (route, NHWC shape, ws, heads, masked) into
    ``shapes``, with its count; the B3/B6 calls go through
    ``_record_conv_slots``.  → handles."""
    from lic_tpu_torch.layers import GDN, WindowAttention
    from lic_tpu_torch.layers.gdn import b2_takes

    def bump(d, key):
        d[key] = d.get(key, 0) + 1

    def gdn_hook(m, args):
        b, c, h, w = args[0].shape
        if b2_takes(c):
            bump(shapes["gdn"], (b * h * w, c, m.inverse))

    def attn_hook(m, args):
        x, mask = args
        bump(shapes["attn"], (m.route(x), tuple(x.shape), m.window_size, m.num_heads,
                              mask is not None))

    return ([m.register_forward_pre_hook(gdn_hook) for m in model.modules()
             if isinstance(m, GDN)]
            + [m.register_forward_pre_hook(attn_hook) for m in model.modules()
               if isinstance(m, WindowAttention)])


def _drive_train(dev, counters, shapes):
    """[train]: ``source_net`` at full width, ``TRAIN_STEPS`` steps of the
    port's ``train_step`` (``TrainConfig``'s defaults: λ 0.0025, Adam 1e-4
    after a clip at 1.0, aux Adam 1e-3) on B = 8 256×256 crops.
    [train_wam]: ``source_net_wam``, one step through B4 and one with
    ``fuse_proj`` (B5); [train_entro], [train_ns]: one step each of
    ``entroformer_cb`` and ``neural_syntax``.  Each run: the first step's kernel launches (and
    backwards, equal to them) against ``EXPECTED``, its kernel shapes
    recorded for [grad]; every loss finite and no step skipped; after the
    last step each B3/B6 slot's kernel output equals the plain version
    with the updated weights (float64, ``TOL``) and differs from the one
    with the weights before that step.  ``source_net`` also reports ms
    per step (median of steps 2-6; forward / backward / optimizer by CUDA
    events), images/s, peak memory, and the top kernels of a profiled
    extra step.  → {run: launches}."""
    import torch

    from lic_tpu_torch.config import TrainConfig
    from lic_tpu_torch.layers import WindowAttention, conv_direct
    from lic_tpu_torch.layers.conv import Conv2d
    from lic_tpu_torch.models import build_model
    from lic_tpu_torch.training import create_state, make_optimizer, make_train_step

    batch = _train_batch(dev)
    kernels = ("gdn", "conv5s2", "convk_s1", "wba", "wba_proj")
    runs = {}
    for preset, routes in (("source_net", [False] * TRAIN_STEPS),
                           ("source_net_wam", [False, True]),
                           ("entroformer_cb", [False]), ("neural_syntax", [False])):
        model = build_model(preset, device=dev, seed=SEED).train()
        tc = TrainConfig()
        opt = make_optimizer(model, tc, steps_per_epoch=1000)
        state = create_state(model, opt, tc.seed)
        step_fn = make_train_step(model, tc, opt)
        attn = [m for m in model.modules() if isinstance(m, WindowAttention)]
        slots = {}  # Conv2d module → an input shape it took a kernel slot with

        def slot_hook(m, args, kwargs):
            if m.kernel_slot(args[0]) is not None:
                slots[m] = tuple(args[0].shape)

        times, losses = [], []
        torch.cuda.reset_peak_memory_stats()
        for i, fuse in enumerate(routes):
            for m in attn:
                m.fuse_proj = fuse
            run = f"train:{preset}" + ("+fuse_proj" if fuse else "")
            first = run not in runs
            if i == len(routes) - 1:  # every conv: a one-step run records its slots in it
                before = {m: m.weight.detach().clone() for m in model.modules()
                          if isinstance(m, Conv2d)}
            hooks = []
            if first:
                hooks = (_record_conv_slots(model, shapes["conv"], run)
                         + _record_train_shapes(model, shapes)
                         + [m.register_forward_pre_hook(slot_hook, with_kwargs=True)
                            for m in model.modules() if isinstance(m, Conv2d)])
            torch.cuda.synchronize()
            for k, c in counters.items():
                c.launches = 0
                if hasattr(c, "backwards"):
                    c.backwards = 0
            ev = {}

            def mark(name):
                ev[name] = torch.cuda.Event(enable_timing=True)
                ev[name].record()

            metrics = step_fn(state, batch, on_phase=mark)
            torch.cuda.synchronize()
            for h in hooks:
                h.remove()
            if first:
                runs[run] = {k: c.launches for k, c in counters.items()}
                back = {k: counters[k].backwards for k in kernels}
                if back != {k: runs[run][k] for k in kernels}:
                    raise AssertionError(f"{run}: backwards {back} != launches {runs[run]}")
            loss = float(metrics["loss"])
            if not (torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["aux"])) \
                    or float(metrics["skipped"]):
                raise AssertionError(f"{run} step {i + 1}: loss {loss}, "
                                     f"skipped {float(metrics['skipped'])}")
            losses.append(loss)
            phases = ("start", "forward", "backward", "optimizer")
            times.append([ev[a].elapsed_time(ev[b]) for a, b in zip(phases, phases[1:])])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        # the weight cache: B3/B6 read the weights the last step wrote
        # a slot whose weight took an exactly zero gradient in the last step
        # cannot move (Adam's step is 0 there): entroformer_cb's ELIC h_s at
        # init, whose input ẑ rounds to 0; every other slot must move
        worst_new, least_old, frozen = 0.0, float("inf"), 0
        with torch.no_grad():
            for m, xs in slots.items():
                gen = torch.Generator().manual_seed(len(xs) + xs[1])
                x = torch.randn(xs, generator=gen).to(dev).contiguous(
                    memory_format=torch.channels_last)
                y = m(x)
                slot = m.kernel_slot(x)
                plain = getattr(conv_direct, f"{slot}_plain")
                extra = (m.fused_act,) if slot == "convk_s1" else ()
                b64 = None if m.bias is None else m.bias.double()
                ref = plain(x.double(), m.weight.double(), b64, *extra)
                old = plain(x.double(), before[m].double(), b64, *extra)
                torch.testing.assert_close(y.double(), ref, atol=TOL, rtol=TOL,
                                           msg=lambda s: f"{preset} {slot} after the step: {s}")
                worst_new = max(worst_new, float((y.double() - ref).abs().max()))
                if m.weight.grad is not None and not m.weight.grad.any():
                    frozen += 1
                    if not torch.equal(m.weight, before[m]):
                        raise AssertionError(f"{preset}: a weight with no gradient moved")
                    continue
                least_old = min(least_old, float((y.double() - old).abs().max()))
        if frozen == len(slots) or not least_old > 10 * TOL:
            raise AssertionError(f"{preset}: a B3/B6 output did not move with its weights "
                                 f"({least_old:.3g})")
        line = dict(preset=preset, batch=TRAIN_BATCH, crop=TRAIN_CROP, steps=len(routes),
                    losses=json.dumps([round(v, 4) for v in losses]), skipped=0,
                    launches={r: n for r, n in runs.items() if r.startswith(f"train:{preset}")},
                    b3_b6_slots_checked=len(slots), b3_b6_slots_zero_gradient=frozen,
                    b3_b6_after_step_max_err=f"{worst_new:.3g}",
                    b3_b6_vs_old_weights_min_diff=f"{least_old:.3g}",
                    peak_mem_gib=f"{peak:.2f}")
        if preset == "source_net":
            med = sorted(times[1:], key=sum)[len(times[1:]) // 2]
            step_ms = sum(med)
            line.update(step_ms=f"{step_ms:.2f}", forward_ms=f"{med[0]:.2f}",
                        backward_ms=f"{med[1]:.2f}", optimizer_ms=f"{med[2]:.2f}",
                        images_per_s=f"{TRAIN_BATCH / step_ms * 1e3:.1f}",
                        all_step_ms=json.dumps([round(sum(t), 2) for t in times]))
            _say("train", **line)
            _profile_step(step_fn, state, batch, step_ms)
        elif preset == "source_net_wam":
            line.update(step_ms=json.dumps([round(sum(t), 2) for t in times]),
                        routes=json.dumps(["b4", "b5"]))
            _say("train_wam", **line)
        else:
            line.update(step_ms=f"{sum(times[0]):.2f}", forward_ms=f"{times[0][0]:.2f}",
                        backward_ms=f"{times[0][1]:.2f}", optimizer_ms=f"{times[0][2]:.2f}",
                        note="one step: its first, cuDNN's choices included")
            _say("train_entro" if preset == "entroformer_cb" else "train_ns", **line)
        del model, opt, state, step_fn
        torch.cuda.empty_cache()
    return runs


def _profile_step(step_fn, state, batch, step_ms, top=6):
    """One more step under ``torch.profiler``: its device time by phase
    (forward, backward, optimizer: each kernel counted in the phase whose
    host interval launched it, between ``record_function`` marks at the
    phase ends), the device's busy share of an unprofiled step (device time
    over ``step_ms``, the median step; the profiler slows the host), and
    each phase's ``top``
    kernels by device time, labelled with the op that launched them (a
    transposed conv's gradient as ``convolution_backward[transposed]``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    def mark(name):
        with record_function(f"mark:{name}"):
            pass

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step_fn(state, batch, on_phase=mark)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    at = {e.name[5:]: e.time_range.start for e in events if e.name.startswith("mark:")}
    phases = ("forward", "backward", "optimizer")
    ends = [at[p] for p in phases]
    agg, by_phase = {}, dict.fromkeys(phases, 0.0)
    for e in events:
        if not getattr(e, "kernels", None) or e.name.startswith("mark:"):
            continue
        if not at["start"] <= e.time_range.start <= ends[-1]:
            continue
        phase = next(p for p, end in zip(phases, ends) if e.time_range.start <= end)
        op = e.name
        args = getattr(e, "concrete_inputs", None) or []
        if op == "aten::convolution_backward" and len(args) > 7 and args[7] is True:
            op += "[transposed]"
        for k in e.kernels:
            key = (phase, op, k.name)
            t, n = agg.get(key, (0.0, 0))
            agg[key] = (t + k.duration / 1e3, n + 1)
            by_phase[phase] += k.duration / 1e3
    busy = sum(by_phase.values())
    if busy == 0.0:
        raise AssertionError("the profiler saw no device time in the training step")
    _say("train_profile", device_ms=f"{busy:.2f}", wall_ms_profiled=f"{wall_ms:.2f}",
         busy_share_of_median_step=f"{busy / step_ms:.3f}",
         **{f"{p}_device_ms": f"{t:.2f}" for p, t in by_phase.items()},
         note="an extra (7th) step, profiled")
    for phase in phases:
        rows = sorted(((k, v) for k, v in agg.items() if k[0] == phase), key=lambda kv: -kv[1][0])
        for (_, op, name), (t, n) in rows[:top]:
            _say("train_profile_kernel", step_phase=phase, ms=f"{t:.3f}", calls=n,
                 share_of_phase=f"{t / max(by_phase[phase], 1e-9):.3f}", op=op,
                 kernel=repr(name[:90]))


def _grad_checks(shapes, dev, g):
    """[grad]: at every (kernel, shape) the training and tune steps
    recorded, the forward through the kernel's autograd.Function against
    the plain version (float64; B2 fp32, as in 3a) within ``TOL``, and
    the gradient of a random cotangent through it against autograd of its
    plain version in float64 and fp32 (B2: its closed form; a LeakyReLU's
    derivative on float64's side of 0, but within ``TOL`` of 0 on the
    kernel's side), within ``GRAD_TOL`` of the reference's largest
    magnitude, for every input; each call runs one backward
    (``backwards``)."""
    import torch
    import torch.nn.functional as F

    from lic_tpu_torch.layers import conv_direct, gdn as gdn_mod, window_attn

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    def share(a, b):
        return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-300))

    def case(name, counter, fn, plain, tensors, closed=None, weight_at=None, forward=None,
             **info):
        ins = [t.detach().requires_grad_() for t in tensors]
        b0 = counter.backwards
        y = fn(*ins)
        with torch.no_grad():
            ref_y = (forward or (lambda *t: plain(*[a.double() for a in t])))(*tensors)
            fwd_err = float((y.detach().to(ref_y.dtype) - ref_y).abs().max())
            torch.testing.assert_close(y.detach().to(ref_y.dtype), ref_y, atol=TOL, rtol=TOL,
                                       msg=lambda m: f"{name} {info}: autograd forward: {m}")
        del ref_y
        cot = torch.randn(y.shape, generator=g).to(dev)
        got = torch.autograd.grad(y, ins, cot)
        torch.cuda.synchronize()
        if counter.backwards != b0 + 1:
            raise AssertionError(f"{name}: {counter.backwards - b0} backwards, expected 1")
        if closed is not None:
            ref32 = closed(cot, *[t.detach() for t in tensors])
            ref = closed(cot.double(), *[t.detach().double() for t in tensors])
        else:
            ins32 = [t.detach().requires_grad_() for t in tensors]
            ref32 = torch.autograd.grad(plain(*ins32), ins32, cot)
            ins64 = [t.detach().double().requires_grad_() for t in tensors]
            ref = torch.autograd.grad(plain(*ins64), ins64, cot.double())
        errs = [share(a, b) for a, b in zip(got, ref)]
        errs32 = [share(a, b) for a, b in zip(got, ref32)]
        tols = [WGRAD_TOL if i == weight_at else GRAD_TOL for i in range(len(errs))]
        if any(e > t for e, t in zip(errs, tols)) or max(errs32) > FP32_TOL:
            raise AssertionError(f"{name} {info}: gradients off float64 by {errs}, off the "
                                 f"fp32 plain gradient by {errs32} (shares of their range)")
        _say("grad", kernel=name, **info, inputs=len(ins), forward_err=f"{fwd_err:.3g}",
             err_share_vs_f64=json.dumps([float(f"{e:.3g}") for e in errs]),
             err_share_vs_fp32_plain=f"{max(errs32):.3g}",
             identical_to_fp32_plain=all(torch.equal(a, b) for a, b in zip(got, ref32)),
             backwards=1)
        return max(e for i, e in enumerate(errs) if i != weight_at)

    worst = {}
    for (rows, c, inv), n in sorted(shapes["gdn"].items()):
        gamma = 0.1 * torch.eye(c) + 0.01 * torch.rand(c, c, generator=g)
        e = case("gdn", gdn_mod.gdn_fused, lambda x, gm, bt: gdn_mod.gdn_fused(x, gm, bt, inv),
                 None, [randn(rows, c), gamma.to(dev), (1.0 + torch.rand(c, generator=g)).to(dev)],
                 closed=lambda cot, x, gm, bt: gdn_mod.gdn_plain_backward(cot, x, gm, bt, inv),
                 forward=lambda x, gm, bt: gdn_mod.gdn_plain(x, gm, bt, inv),
                 rows=rows, C=c, inverse=inv, train_calls=n)
        worst["gdn"] = max(worst.get("gdn", 0.0), e)
    cl = lambda t: t.contiguous(memory_format=torch.channels_last)
    for (slot, xs, ws_, has_bias, act, has_res), by_run in sorted(
            shapes["conv"].items(), key=lambda kv: str(kv[0])):
        b, cin, hh, ww = xs
        cout, _, k, _ = ws_
        ts = [cl(randn(*xs)), cl(randn(*ws_, scale=(cin * k * k) ** -0.5))]
        if has_bias:
            ts.append(randn(cout))
        forward, band = None, {}
        if slot == "conv5s2":
            fn = lambda x, w, *bb: conv_direct.conv5s2(x, w, *bb)
            plain = lambda x, w, *bb: conv_direct.conv5s2_plain(x, w, *bb)
        else:
            if has_res:
                ts.append(cl(randn(b, cout, hh, ww)))

            def split(t):
                bias = t[2] if has_bias else None
                res = t[-1] if has_res else None
                return t[0], t[1], bias, act, res

            # the LeakyReLU's side of 0 in the references: float64's own,
            # but where the float64 pre-activation lies within TOL of 0
            # (the forward check's tolerance, inside which the kernel may
            # lie on the other side) the kernel's, which the backward uses
            x0, w0, b0 = split(ts)[:3]
            side = None
            if act == "leaky_relu":
                with torch.no_grad():
                    z64 = F.conv2d(x0.double(), w0.double(),
                                   None if b0 is None else b0.double(), padding=k // 2)
                    near = z64.abs() <= TOL
                    side = torch.where(near, conv_direct.convk_s1(x0, w0, b0, act) >= 0,
                                       z64 >= 0)
                    band = dict(within_tol_of_kink=int(near.sum()),
                                kernel_side_differs=int((side != (z64 >= 0)).sum()))
                del z64, near

            def plain(*t, k=k, split=split, side=side):
                x, w, bias, act_, res = split(t)
                if side is None:
                    return conv_direct.convk_s1_plain(x, w, bias, act_, res)
                z = F.conv2d(x, w, bias, padding=k // 2)
                y = torch.where(side, z, z * conv_direct.LEAKY_SLOPE)
                return y if res is None else y + res

            fn = lambda *t: conv_direct.convk_s1(*split(t))
            forward = lambda *t, split=split: conv_direct.convk_s1_plain(
                *split([a.double() for a in t]))
        e = case(slot, getattr(conv_direct, slot), fn, plain, ts, weight_at=1, forward=forward,
                 shape=xs, c_out=cout, k=k, bias=has_bias, act=act, residual=has_res,
                 train_calls=by_run, **band)
        worst[slot] = max(worst.get(slot, 0.0), e)
    plain_route = 0
    for (route, xs, ws, nh, masked), n in sorted(shapes["attn"].items(), key=str):
        if route == "plain":  # the U-Net hyper's: the plain version, no kernel backward
            plain_route += n
            continue
        b, hp, wp, c = xs
        nn_ = ws * ws
        mask = window_attn.shift_mask(hp, wp, ws, ws // 2, 0, 0, dev) if masked else None
        rel = randn(nh, nn_, nn_, scale=0.5)
        if route == "wba":
            e = case("wba", window_attn.window_attention,
                     lambda q, r: window_attn.window_attention(q, r, mask, ws, nh),
                     lambda q, r: window_attn.wba_plain(q, r, mask, ws, nh),
                     [randn(b, hp, wp, 3 * c), rel], shape=(b, hp, wp, 3 * c), ws=ws, heads=nh,
                     masked=masked, train_calls=n)
        elif route == "wba_proj":
            ts = [randn(*xs), rel, randn(3 * c, c, scale=c ** -0.5), randn(3 * c),
                  randn(c, c, scale=c ** -0.5), randn(c)]
            e = case("wba_proj", window_attn.window_attention_proj,
                     lambda *t: window_attn.window_attention_proj(*t, mask, ws, nh),
                     lambda *t: window_attn.wba_proj_plain(*t, mask, ws, nh),
                     ts, shape=xs, ws=ws, heads=nh, masked=masked, train_calls=n)
        else:
            raise AssertionError(f"a training attention took the {route} route")
        worst[route] = max(worst.get(route, 0.0), e)
    if set(worst) != {"gdn", "conv5s2", "convk_s1", "wba", "wba_proj"}:
        raise AssertionError(f"[grad] covered only {sorted(worst)}")
    _say("grad_summary", **{k: f"{v:.3g}" for k, v in worst.items()}, tol=GRAD_TOL,
         plain_route_attention_calls_not_kernels=plain_route,
         note="worst share of range off float64, conv weight gradients aside")


def _wake_zero_leaves(*models):
    """Seeded values of gain ~0.5 for the all-zero weights (each attention's
    ``proj``, each residual branch's last conv, WMSA's ``linear``, the Swin
    MLP's ``mlp_fc2``), the same on every model given: at their zero init
    those branches add exactly 0 and no check could see them.  → leaves
    woken per model."""
    import torch

    for m in models:
        g = torch.Generator().manual_seed(SEED + 1)
        woken = 0
        with torch.no_grad():
            for name, p in m.named_parameters():
                if name.endswith("weight") and not p.any():
                    fan_in = p[0].numel()
                    p.copy_(torch.randn(p.shape, generator=g) * 0.5 * fan_in ** -0.5)
                    woken += 1
    return woken


def _hooks_agree(run, counts, conv_calls, gdn_calls=None):
    """The launches a run counted equal the calls its hooks recorded."""
    for slot in ("conv5s2", "convk_s1"):
        seen = sum(n.get(run, 0) for key, n in conv_calls.items() if key[0] == slot)
        if seen != counts[slot]:
            raise AssertionError(f"{run}: {counts[slot]} {slot} launches, "
                                 f"{seen} seen by the Conv2d hooks")
    if gdn_calls is not None:
        seen = sum(n.get(run, 0) for n in gdn_calls.values())
        if seen != counts["gdn"]:
            raise AssertionError(f"{run}: {counts['gdn']} gdn launches, "
                                 f"{seen} seen by the GDN hooks")


def _drive_variants(dev, counters, conv_calls):
    """``source_net`` in bf16 and at ``is_high``, one eval forward each with
    its launches counted and its B3/B6 calls recorded.  bf16: g_a and the
    synthesis of the fp32 latent against the fp32 model's, within
    ``BF16_STAGE`` of the fp32 stage's largest magnitude.  is_high: z3, μ0,
    σ0 and the reconstruction against its CPU run at 128×128 (plain
    versions) within 1e-4.  → {run: launches}."""
    import numpy as np
    import torch

    from lic_tpu_torch.data import smooth_images
    from lic_tpu_torch.models import build_model

    x_np = smooth_images(np.random.default_rng(SEED), BATCH, H, W)
    x = torch.from_numpy(x_np).to(dev).contiguous(memory_format=torch.channels_last)
    runs, mp = {}, BATCH * H * W / 1e6

    def counted(run, fn):
        out, runs[run] = _counted_forward(model, counters, conv_calls, run, fn)
        return out

    # bf16: the whole model and its input cast, as the JAX bf16_params run
    model = build_model("source_net", device=dev, seed=SEED)
    with torch.no_grad():
        z3, y_hat = model.analyze(x), model(x).extras["y_hat"]
        syn = model.syntax_from_latent(z3)
        rec = model.synthesize(y_hat, syn)
        model = model.to(torch.bfloat16)
        xb = x.bfloat16()
        out = counted("source_net+bf16", lambda: model(xb))
        errs = {"g_a": (model.analyze(xb).float() - z3).abs().max() / z3.abs().max(),
                "synthesis": (model.synthesize(y_hat.bfloat16(), syn.bfloat16()).float()
                              - rec).abs().max() / rec.abs().max()}
        errs = {k: float(v) for k, v in errs.items()}
        if max(errs.values()) > BF16_STAGE:
            raise AssertionError(f"bf16 stages off the fp32 ones: {errs}")
        ms = _cuda_ms(lambda: model(xb), 3)
    _say("forward", preset="source_net", dtype="bfloat16", finite=True,
         bpp_est=f"{float(out.bpp):.4f}", launches=runs["source_net+bf16"],
         share_of_fp32_range=json.dumps({k: round(v, 5) for k, v in errs.items()}),
         forward_ms=f"{ms:.2f}", forward_mps=f"{mp / ms * 1e3:.2f}", weights="UNTRAINED")
    del model, out, z3, y_hat, syn, rec, xb
    torch.cuda.empty_cache()

    # is_high: N = 384; its GDNs take the plain route, B3 runs at C_in 384
    model = build_model("source_net", device=dev, seed=SEED, is_high=True)
    cpu_model = build_model("source_net", device="cpu", seed=SEED, is_high=True)
    errs = _small_vs_cpu(model, cpu_model, torch.from_numpy(x_np[:1, :, :128, :128].copy()), dev)
    if max(errs.values()) > RECON_TOL:
        raise AssertionError(f"is_high: GPU stages disagree with the CPU run: {errs}")
    with torch.no_grad():
        out = counted("source_net+is_high", lambda: model(x))
        ms = _cuda_ms(lambda: model(x), 3)
    _say("forward", preset="source_net", is_high=True, N=model.cfg.N, finite=True,
         bpp_est=f"{float(out.bpp):.4f}", launches=runs["source_net+is_high"],
         small_vs_cpu_max_err=f"{max(errs.values()):.3g}", forward_ms=f"{ms:.2f}",
         forward_mps=f"{mp / ms * 1e3:.2f}", weights="UNTRAINED")
    return runs


def _record_conv_slots(model, calls, run):
    """Forward pre-hooks on every ``Conv2d`` of ``model``: each call that
    takes the B3 or B6 slot counts one in ``calls[key][run]``, keyed by
    (slot, input shape, weight shape, bias, act, residual).  → handles."""
    from lic_tpu_torch.layers.conv import Conv2d

    def hook(m, args, kwargs):
        x = args[0]
        slot = m.kernel_slot(x)
        if slot is not None:
            res = args[1] if len(args) > 1 else kwargs.get("residual")
            key = (slot, tuple(x.shape), tuple(m.weight.shape), m.bias is not None,
                   m.fused_act, res is not None)
            by_run = calls.setdefault(key, {})
            by_run[run] = by_run.get(run, 0) + 1

    return [m.register_forward_pre_hook(hook, with_kwargs=True)
            for m in model.modules() if isinstance(m, Conv2d)]


def _record_gdn(model, calls, run):
    """Forward pre-hooks on every GDN of ``model``: each call that B2 takes
    counts one in ``calls[(rows, C, inverse)][run]``.  → handles."""
    from lic_tpu_torch.layers import GDN
    from lic_tpu_torch.layers.gdn import b2_takes

    def hook(m, args):
        b, c, h, w = args[0].shape
        if b2_takes(c):
            by_run = calls.setdefault((b * h * w, c, m.inverse), {})
            by_run[run] = by_run.get(run, 0) + 1

    return [m.register_forward_pre_hook(hook) for m in model.modules() if isinstance(m, GDN)]


def _drive(preset, dev, counters, conv_calls, attn_calls, gdn_calls, tune_shapes,
           run=None, **overrides):
    """One path (``preset`` with the config ``overrides``, its runs named
    ``run``, default the preset): the small-input check against the CPU, the main path with
    its launch counts and its B2, B3/B6 and B4 calls (into ``gdn_calls``,
    ``conv_calls`` and ``attn_calls``, by run), the B=1 roundtrip, the
    times (and for a preset with
    window attention the ``fuse_proj`` pass); then [c5], and where the
    preset is one of theirs [eval], [tune] (its kernel shapes into
    ``tune_shapes``) and [cli].
    → ({run: launches}, times, {label: the drain calls of a decode}: the
    B=8 decode of ``source_net``, ``entroformer_cb`` and ``neural_syntax``,
    and for ``source_net`` also its one-stream decode and [cli]'s decode
    of a chunk of two 480×640 streams)."""
    import numpy as np
    import torch

    from lic_tpu_torch.data import smooth_images
    from lic_tpu_torch.layers import WindowAttention, window_attn
    from lic_tpu_torch.models import build_model
    from lic_tpu_torch.models.compress import ChannelCoder
    from lic_tpu_torch.tools.kernel_probe import record_drains

    run = run or preset
    model = build_model(preset, device=dev, seed=SEED, **overrides)
    cpu_model = build_model(preset, device="cpu", seed=SEED, **overrides)
    woken = _wake_zero_leaves(model, cpu_model)
    x_np = smooth_images(np.random.default_rng(SEED), BATCH, H, W)
    x = torch.from_numpy(x_np).to(dev).contiguous(memory_format=torch.channels_last)
    small = torch.from_numpy(x_np[:1, :, :128, :128].copy())

    def on_gpu(t):
        return t.to(dev).contiguous(memory_format=torch.channels_last)

    ref_err = _small_stages(run, model, cpu_model, small, on_gpu)
    del cpu_model

    # the main path: forward + compress_batch → decompress_batch
    coder = ChannelCoder(model, name=run)
    hooks = (_record_conv_slots(model, conv_calls, run)
             + _record_gdn(model, gdn_calls, run))
    _zero(counters)
    with torch.no_grad():
        out = model(x)
    blobs = coder.compress_batch(x)
    rec = coder.decompress_batch(blobs)
    runs = {run: _read(counters)}
    for h in hooks:
        h.remove()
    _hooks_agree(run, runs[run], conv_calls, gdn_calls)
    for key, n in window_attn.window_attention.calls.items():
        attn_calls.setdefault(key, {})[run] = n
    if not (torch.isfinite(out.x_tilde).all() and torch.isfinite(out.bpp)):
        raise AssertionError(f"{run}: non-finite forward output")
    if out.x_tilde.shape != (BATCH, 3, H, W) or rec.shape != out.x_tilde.shape:
        raise AssertionError(f"{run}: shapes {tuple(out.x_tilde.shape)} / {tuple(rec.shape)}")
    # the coder runs its model passes on pass_batch images (BATCH here, on
    # the card): its reference is the forward in those passes
    ref = _pass_forward(model, x)
    rec_err = float((rec - ref).abs().max())
    if rec_err > RECON_TOL:
        raise AssertionError(f"{run}: decoded recon differs from the forward: {rec_err}")
    _say("forward", preset=run, shape=tuple(out.x_tilde.shape),
         bpp_est=f"{float(out.bpp):.4f}", mse=f"{float(out.mse):.5f}", finite=True,
         weights="UNTRAINED", small_vs_cpu_max_err=f"{max(ref_err.values()):.3g}")
    bpp = sum(len(b) for b in blobs) * 8 / (BATCH * H * W)
    x1 = x[:1]
    blob1 = coder.compress(x1)
    rec1_err = float((coder.decompress(blob1) - _pass_forward(model, x1)).abs().max())
    if rec1_err > RECON_TOL:
        raise AssertionError(f"{run}: B=1 roundtrip recon differs from its forward: {rec1_err}")
    drains = {}
    if run in ("source_net", "entroformer_cb") + NS_PATHS:
        drains[f"{run} B={BATCH} decode"] = record_drains(coder, blobs)
    if run == "source_net":
        drains[f"{run} one-stream decode"] = record_drains(coder, [blob1])
    _say("roundtrip", preset=run, streams=BATCH, bpp=f"{bpp:.4f}",
         recon_max_err=f"{rec_err:.3g}", final_state_ok=True, launches=runs[run],
         b1_recon_max_err=f"{rec1_err:.3g}", b1_stream_equals_batch=blob1 == blobs[0])

    # times (UNTRAINED weights: the codec rows are not rate points)
    mp = BATCH * H * W / 1e6
    with torch.no_grad():
        fwd_ms = _cuda_ms(lambda: model(x), 3)
    # the roundtrip includes host rANS: CUDA events around it on the
    # stream, synchronised, span the wall time of each call
    rt = sorted(
        _cuda_ms(lambda: coder.decompress_batch(coder.compress_batch(x)), 1) / 1e3
        for _ in range(3)
    )[1]
    times = dict(forward_ms=fwd_ms, roundtrip_s=rt, codec_bpp=bpp)
    _say("times", preset=run, forward_ms=f"{fwd_ms:.2f}",
         forward_mps=f"{mp / fwd_ms * 1e3:.2f}", roundtrip_s=f"{rt:.3f}",
         roundtrip_mps=f"{mp / rt:.3f}", codec_bpp=f"{bpp:.4f}", weights="UNTRAINED")

    attn = [m for m in model.modules() if isinstance(m, WindowAttention)]
    if attn:
        # the forward with kernel B5 (both projections inside the kernel);
        # first, proof that every attention branch adds non-zero values
        attn_max = []
        hooks = [m.register_forward_hook(lambda m, a, o: attn_max.append(float(o.abs().max())))
                 for m in attn]
        with torch.no_grad():
            z3 = model.analyze(x)
            for h in hooks:
                h.remove()
            if not woken or min(attn_max) == 0.0:
                raise AssertionError(f"{run}: an attention branch adds exactly 0 "
                                     f"({woken} zero-init leaves woken)")
            syn = model.syntax_from_latent(z3)
            if _blockwise_synthesis(model):  # block by block, as _small_stages
                ins, rec_b4 = _gs_blocks(model, out.extras["y_hat"], syn)
            else:
                rec_b4 = model.synthesize(out.extras["y_hat"], syn)
            for m in attn:
                m.fuse_proj = True
            _zero(counters)
            out5 = model(x)
            runs[f"{run}+fuse_proj"] = _read(counters)
            z3_5 = model.analyze(x)
            ill = {}
            if _blockwise_synthesis(model):
                # each well-conditioned block (by [small]) within RECON_TOL
                # of the B4 run's, as a share of its range; an
                # ill-conditioned one (wam1: logits of 1e4, where B5's
                # in-kernel fp32 projections and B4's cuBLAS ones round
                # apart by a share of 1e-2) is printed, not held: B5 at its
                # shape is held by 3c and by net_ga's g_s
                names = [n for n, _ in model.g_s.named_children()] + ["generated_conv"]
                shares = _block_shares(_gs_blocks(model, None, syn, ins)[1], rec_b4)
                tol = _GS_BLOCK_TOL[run]
                ill = {n: f"{e:.3g}" for n, e, t in zip(names, shares, tol) if t > RECON_TOL}
                synthesis_err = max(e for e, t in zip(shares, tol) if t <= RECON_TOL)
            else:
                synthesis_err = float((model.synthesize(out.extras["y_hat"], syn)
                                       - rec_b4).abs().max())
            fwd5_ms = _cuda_ms(lambda: model(x), 3)
            for m in attn:
                m.fuse_proj = False
        errs = {"z3": float((z3_5 - z3).abs().max()), "synthesis": synthesis_err}
        if not torch.isfinite(out5.x_tilde).all() or max(errs.values()) > RECON_TOL:
            raise AssertionError(f"{run}: the fuse_proj forward differs: {errs}")
        times["forward_fuse_proj_ms"] = fwd5_ms
        _say("fuse_proj", preset=run, launches=runs[f"{run}+fuse_proj"],
             **({"ill_conditioned_block_shares": json.dumps(ill)} if ill else {}),
             leaves_woken=woken, attn_out_min_max_abs=f"{min(attn_max):.3g}",
             z3_max_err=f"{errs['z3']:.3g}", synthesis_max_err=f"{errs['synthesis']:.3g}",
             forward_ms=f"{fwd5_ms:.2f}")

    # this slice's phases on the same model: [c5], [eval], [tune], [cli]
    _c5(run, model, coder, x, ref)
    if run in EVAL_PRESETS:
        runs.update(_eval_phase(preset, model, dev, counters, conv_calls, attn_calls,
                                gdn_calls))
    if run in TUNE_PRESETS:
        runs.update(_tune_phase(preset, model, coder, x1, dev, counters, tune_shapes))
    if run == "source_net":
        drains["cli 480x640 chunk of 2"] = _cli_phase(model, coder, dev)
    return runs, times, drains


# what ``_stages`` takes from the CPU run into the card's, so that no
# rounding flip upstream can spread into the stages compared
_GIVEN = ("z_hat", "z2_int", "y_hat", "syn")


def _small_stages(preset, model, cpu_model, small, on_gpu):
    """The small-input check: each of ``_stages`` on the card within
    RECON_TOL of the CPU run (fp32 both).  Beside it, [small_f64] prints
    each stage's distance from the CPU model run in float64 on the same
    values, for the card and for the CPU, and for a log σ stage the
    largest |σ| difference between card and CPU with σ there: what tells
    fp32 rounding (both sides the same distance from float64) from a
    fault (the card alone far from it).  → {stage: max |card − CPU|}."""
    import copy

    import torch

    with torch.no_grad():
        sc = _stages(cpu_model, small)
        sg = _stages(model, on_gpu(small), **{k: on_gpu(sc[k]) for k in _GIVEN if k in sc})
        s64 = _stages(copy.deepcopy(cpu_model).double(), small.double(),
                      **{k: sc[k].double() for k in _GIVEN if k in sc})
    keys = [k for k in sg if k not in _GIVEN]
    ref_err = {k: float((sg[k].cpu() - sc[k]).abs().max()) for k in keys}
    f64 = {}
    for k in keys:
        f64[f"{k}_gpu_vs_f64"] = f"{float((sg[k].cpu().double() - s64[k]).abs().max()):.3g}"
        f64[f"{k}_cpu_vs_f64"] = f"{float((sc[k].double() - s64[k]).abs().max()):.3g}"
    if _blockwise_synthesis(model):
        # each block of g_s on the CPU's input to it, as a share of range
        with torch.no_grad():
            ins, outs = _gs_blocks(cpu_model, sc["y_hat"], sc["syn"])
            _, outs_g = _gs_blocks(model, None, sc["syn"], ins, on_gpu)
            _, outs_64 = _gs_blocks(copy.deepcopy(cpu_model).double(), None,
                                    sc["syn"].double(), [t.double() for t in ins])
        names = [n for n, _ in model.g_s.named_children()] + ["generated_conv"]
        g_c, g_64, c_64 = (_block_shares(outs_g, outs), _block_shares(outs_g, outs_64),
                           _block_shares(outs, outs_64))
        tol = _GS_BLOCK_TOL[preset] = [RECON_TOL if e <= RECON_TOL / 2 else 2 * e
                                       for e in c_64]
        bad = [n for n, a, b, c, t in zip(names, g_c, g_64, c_64, tol)
               if a > RECON_TOL and not (t > RECON_TOL and b <= t)]
        worst = max(range(len(names)), key=lambda i: c_64[i])
        f64.update(gs_blocks_gpu_vs_cpu=f"{max(g_c):.3g}", gs_blocks_gpu_vs_f64=f"{max(g_64):.3g}",
                   gs_blocks_cpu_vs_f64=f"{max(c_64):.3g}", gs_worst_block=names[worst],
                   gs_ill_conditioned=[n for n, t in zip(names, tol) if t > RECON_TOL])
        if bad:
            raise AssertionError(f"{preset}: g_s blocks {bad} off the CPU run by "
                                 f"{[round(a, 7) for a in g_c]} (share of range), off float64 "
                                 f"by {[round(b, 7) for b in g_64]}, the CPU by "
                                 f"{[round(c, 7) for c in c_64]}")
        if k.startswith("log_sigma"):
            d = (sg[k].cpu().exp() - sc[k].exp()).abs().flatten()
            i = int(d.argmax())
            f64[f"{k[4:]}_abs_err"] = f"{float(d[i]):.3g}"
            f64[f"{k[4:]}_there"] = f"{float(sc[k].exp().flatten()[i]):.4g}"
    _say("small_f64", preset=preset, **f64)
    if max(ref_err.values()) > RECON_TOL:
        raise AssertionError(f"{preset}: GPU stages disagree with the CPU run: {ref_err}")
    return ref_err


def _blockwise_synthesis(model) -> bool:
    """Whether the model's synthesis is compared block by block: the rbs
    g_s, whose seven IGDNs each square the map's scale (1e5 at its output
    on untrained weights) and so double fp32's relative error, card's and
    CPU's alike, from one block to the next."""
    return model.cfg.transform == "rbs"


def _gs_blocks(model, y_hat, syn, inputs=None, move=lambda t: t):
    """Each child of ``model.g_s`` on ``inputs[i]`` where given (moved by
    ``move``), else on the previous child's output from ``y_hat``; then
    the generated conv before its tanh on the last input.  → (inputs,
    outputs), one per block."""
    from lic_tpu_torch.models.syntax import batch_conv

    ins, outs, h = [], [], y_hat
    for i, layer in enumerate(model.g_s.children()):
        xin = h if inputs is None else move(inputs[i])
        ins.append(xin)
        h = layer(xin)
        outs.append(h)
    last = h if inputs is None else move(inputs[-1])
    ins.append(last)
    outs.append(batch_conv(model.conv_weights_gen(move(syn)), last))
    return ins, outs


def _block_shares(got, want):
    """max |got − want| over max |want|, block by block."""
    return [float((g.cpu().double() - w.cpu().double()).abs().max())
            / max(float(w.abs().max()), 1e-30) for g, w in zip(got, want)]


# run → each g_s block's tolerance from [small]: RECON_TOL where the CPU's
# fp32 run of the block lies within RECON_TOL / 2 of float64, else twice
# that distance (an ill-conditioned block; the rbs g_s's wam1 takes a map
# of magnitude ≈ 200 after two IGDNs, so its attention logits reach 1e4
# and fp32 keeps ≈ 1e-2 of its output's range, on the CPU as on the card)
_GS_BLOCK_TOL = {}


def _stages(m, xin, z_hat=None, z2_int=None, y_hat=None, syn=None):
    """The model's stages on ``xin``, each on the given upstream values
    where given: charm, z3, the hyper's (scales, means), slice 0's (μ, σ)
    and the synthesis; entroformer, the same with both checkerboard passes
    (the second on the anchors of ``y_hat``); neural syntax, z3, z2, h2,
    the context's (μ, σ) over ``y_hat``, the syntax (μ, σ) and the
    synthesis; a σ that is exp of a head's output (the entroformer's and
    neural syntax's) as that output, log σ.  → {stage: tensor} (with the
    upstream values used)."""
    import torch

    from lic_tpu_torch.layers.entroformer import anchor_map

    z3 = m.analyze(xin)
    if y_hat is None:
        out = m(xin)
        y_hat, syn = out.extras["y_hat"], m.syntax_from_latent(z3)
    st = dict(z3=z3, y_hat=y_hat, syn=syn)
    if not _blockwise_synthesis(m):  # the rbs g_s: block by block, _small_stages
        st["rec"] = m.synthesize(y_hat, syn)
    if m.is_ns:
        z2 = m.ns_hyper_encode(z3)
        z2_int = torch.round(z2) if z2_int is None else z2_int
        h2 = m.ns_hyper_decode(z2_int)
        mu_c, sg_c = m.prediction_model(y_hat, h2, masked=True)
        mu_s, sg_s = m.ns_syntax_params(h2)
        return dict(st, z2=z2, z2_int=z2_int, h2=h2, mu_c=mu_c, log_sigma_c=torch.log(sg_c),
                    mu_s=mu_s, log_sigma_s=torch.log(sg_s))
    if m.cfg.hyper in ("unet", "latent_unet"):
        # the hyper reads the latent (and the U-Net hyper's decoder the
        # encoder's skips), not a rounded ẑ
        scales, means, _ = m.hyper_forward(z3)
        return dict(st, scales=scales, means=means,
                    **dict(zip(("mu0", "sigma0"), m.charm_entropy_params(means, scales, [], 0))))
    if z_hat is None:
        med = m.eb_medians()[None, :, None, None]
        z_hat = torch.round(m.hyper_encode(z3) - med) + med
    scales, means = m.hyper_decode(z_hat)
    st.update(z_hat=z_hat, scales=scales, means=means)
    if m.is_entro:
        mu0, sg0 = m.entro_predict(torch.zeros_like(y_hat), scales, means)
        anchor = anchor_map(y_hat.shape[2], y_hat.shape[3], y_hat)
        mu1, sg1 = m.entro_predict(y_hat * anchor, scales, means)
        # σ = exp(the head's output): compared as that output
        return dict(st, mu0=mu0, log_sigma0=torch.log(sg0), mu1=mu1, log_sigma1=torch.log(sg1))
    mu0, sigma0, _ = m.charm_entropy_params(means, scales, [], 0)
    return dict(st, mu0=mu0, sigma0=sigma0)


def _c5(preset, model, coder, x, fwd):
    """[c5] cross-batch σ-indexes: each image of ``x`` compressed alone
    against ``compress_batch`` of all (bytes); the single streams decoded
    in one ``decompress_batch``, each alone and in chunks of ``C5_CHUNKS``,
    the reconstructions bit-identical and within ``RECON_TOL`` of the
    eval forward ``fwd``; the σ-indexes of each image alone against the
    batch (``tools.batch_probe.coder_rows_differing``).  Raises on any
    difference."""
    import torch

    from lic_tpu_torch.tools.batch_probe import coder_rows_differing

    b = x.shape[0]
    rows_diff = coder_rows_differing(model, coder, x)
    batch_blobs = coder.compress_batch(x)
    singles = [coder.compress(x[i : i + 1]) for i in range(b)]
    same_bytes = sum(s == t for s, t in zip(singles, batch_blobs))
    t0 = time.perf_counter()
    dec_batch = coder.decompress_batch(singles)
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t0
    t0 = time.perf_counter()
    dec_alone = torch.cat([coder.decompress(s) for s in singles])
    torch.cuda.synchronize()
    t_alone = time.perf_counter() - t0
    parts, i = [], 0
    for n in C5_CHUNKS:
        parts.append(coder.decompress_batch(singles[i : i + n]))
        i += n
    dec_chunks = torch.cat(parts)
    identical = {"alone": torch.equal(dec_batch, dec_alone),
                 "chunks": torch.equal(dec_batch, dec_chunks)}
    rec_err = max(float((d - fwd).abs().max()) for d in (dec_batch, dec_alone, dec_chunks))
    _say("c5", preset=preset, batch=b, single_equals_batch_bytes=f"{same_bytes}/{b}",
         decode_bitidentical=json.dumps(identical), chunks=json.dumps(list(C5_CHUNKS)),
         rows_differing_b1_vs_batch=rows_diff,
         recon_max_err=f"{rec_err:.3g}", decode_batch_s=f"{t_batch:.3f}",
         decode_one_by_one_s=f"{t_alone:.3f}")
    if same_bytes != b or not all(identical.values()) or rows_diff or rec_err > RECON_TOL:
        raise AssertionError(f"c5 {preset}: streams or reconstructions depend on the batch")


def _pass_forward(model, x):
    """The eval forward's reconstruction of each image of ``x`` (padded to
    /64) as ``ChannelCoder`` runs its model passes: in passes of
    ``pass_batch`` images, the last filled up with copies."""
    import torch

    from lic_tpu_torch.models.compress import _passes, pass_batch

    with torch.no_grad():
        return _passes(lambda t: model(t).x_tilde, pass_batch(*x.shape[2:], x.device), x)


def _zero(counters):
    import torch

    from lic_tpu_torch.layers import window_attn

    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
        if hasattr(c, "backwards"):
            c.backwards = 0
    window_attn.window_attention.calls.clear()


def _read(counters):
    import torch

    torch.cuda.synchronize()
    return {k: c.launches for k, c in counters.items()}


def _eval_phase(preset, model, dev, counters, conv_calls, attn_calls, gdn_calls):
    """[eval] ``evaluate_image`` at B = 1 on one seeded synthetic image of
    each of ``EVAL_SIZES``: its launches (counters zeroed just before,
    read just after) and its B2, B3/B6 and B4 calls recorded for 6-7; the
    metrics finite; the reconstruction it scored (read by a forward hook)
    within ``RECON_TOL`` of a direct eval forward of the image padded by
    ``F.pad``, and its bpp and MSE recomputed from that forward; ms per
    image (median of 3 calls after the counted one).  → {run: launches}."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from lic_tpu_torch.data import smooth_images
    from lic_tpu_torch.evaluation import evaluate_image
    from lic_tpu_torch.layers import window_attn

    runs = {}
    for h, w in EVAL_SIZES:
        run = f"eval:{preset}@{h}x{w}"
        x = torch.from_numpy(smooth_images(np.random.default_rng(SEED + h + w), 1, h, w))
        x = x.to(dev).contiguous(memory_format=torch.channels_last)
        seen = []
        hooks = _record_conv_slots(model, conv_calls, run) + _record_gdn(model, gdn_calls, run) + [
            model.register_forward_hook(lambda m, a, out: seen.append(out.x_tilde))]
        _zero(counters)
        r = evaluate_image(model, x)
        runs[run] = _read(counters)
        for hk in hooks:
            hk.remove()
        _hooks_agree(run, runs[run], conv_calls, gdn_calls)
        for key, n in window_attn.window_attention.calls.items():
            attn_calls.setdefault(key, {})[run] = n
        if not all(np.isfinite(r[k]) for k in ("bpp", "psnr", "mse", "msssim")):
            raise AssertionError(f"{run}: non-finite metrics {r}")
        ph, pw = -(-h // 64) * 64, -(-w // 64) * 64
        with torch.no_grad():
            ref = model(F.pad(x, (0, pw - w, 0, ph - h), mode="replicate"))
        rec_err = float((seen[0] - ref.x_tilde).abs().max())
        gt = torch.round((x.double() + 1) * 127.5)
        rec = torch.round(torch.clamp((ref.x_tilde[:, :, :h, :w].double().clamp(-1, 1) + 1)
                                      * 127.5, 0, 255))
        mse = float(((rec - gt) ** 2).mean())
        bpp = float(ref.bpp) * ph * pw / (h * w)
        if rec_err > RECON_TOL or abs(r["mse"] - mse) > 1e-3 * mse or abs(r["bpp"] - bpp) > 1e-6 * bpp:
            raise AssertionError(f"{run}: evaluate_image off the direct forward: recon "
                                 f"{rec_err}, mse {r['mse']} vs {mse}, bpp {r['bpp']} vs {bpp}")
        secs = sorted(evaluate_image(model, x)["seconds"] for _ in range(3))
        _say("eval", preset=preset, size=f"{h}x{w}", padded=f"{ph}x{pw}", batch=1,
             bpp=f"{r['bpp']:.4f}", psnr=f"{r['psnr']:.3f}", msssim=f"{r['msssim']:.5f}",
             recon_vs_forward=f"{rec_err:.3g}", launches=runs[run],
             ms_per_image=f"{secs[1] * 1e3:.2f}", first_call_ms=f"{r['seconds'] * 1e3:.2f}",
             weights="UNTRAINED")
    return runs


def _tune_phase(preset, model, coder, x1, dev, counters, shapes):
    """[tune] ``content_adaptive_finetune`` of ``model`` on the B = 1 image
    ``x1`` (``TUNE_ITERS`` steps, the rate drop at ``TUNE_DROP``): the
    launches and backwards of all steps against ``EXPECTED``; the kernel
    shapes of the steps recorded into ``shapes`` for [grad] (the steps run
    on a copy of the model: GDN and attention calls by a global forward
    pre-hook, B3/B6 calls by stand-ins for ``layers.conv``'s kernel
    entry points that call the real ones); every
    parameter outside g_a bit-identical, every g_a leaf moved; each B3/B6
    slot of the tuned g_a against the plain version in float64 with the
    tuned weights (``TOL``); the tuned image's stream, decoded by
    ``coder`` (the untouched model's; the same digest), within
    ``RECON_TOL`` of the tuned model's eval forward (``_pass_forward``);
    ``model``'s g_a as it was; ms per step by phase (CUDA
    events, median of steps 2 on).  → {run: launches}."""
    import torch
    from torch.nn.modules.module import register_module_forward_pre_hook

    from lic_tpu_torch.config import EvalConfig
    from lic_tpu_torch.evaluation import content_adaptive_finetune
    from lic_tpu_torch.layers import GDN, WindowAttention, conv_direct
    from lic_tpu_torch.layers import conv as conv_mod
    from lic_tpu_torch.layers.conv import Conv2d
    from lic_tpu_torch.layers.gdn import b2_takes
    from lic_tpu_torch.models.compress import ChannelCoder

    run = f"tune:{preset}"
    before = {k: v.clone() for k, v in model.state_dict().items()}
    slots = {}  # id(weight) → the input shape of its B3/B6 call

    def record(m, args):
        x = args[0]
        if isinstance(m, GDN) and b2_takes(x.shape[1]):
            key = (x.shape[0] * x.shape[2] * x.shape[3], x.shape[1], m.inverse)
            shapes["gdn"][key] = shapes["gdn"].get(key, 0) + 1
        elif isinstance(m, WindowAttention):
            key = (m.route(x), tuple(x.shape), m.window_size, m.num_heads, args[1] is not None)
            shapes["attn"][key] = shapes["attn"].get(key, 0) + 1

    real = {k: getattr(conv_mod, k) for k in ("conv5s2", "convk_s1")}

    def recording(slot):
        def call(x, weight, bias=None, act=None, residual=None):
            key = (slot, tuple(x.shape), tuple(weight.shape), bias is not None, act,
                   residual is not None)
            by_run = shapes["conv"].setdefault(key, {})
            by_run[run] = by_run.get(run, 0) + 1
            slots[id(weight)] = tuple(x.shape)
            if slot == "conv5s2":
                return real[slot](x, weight, bias)
            return real[slot](x, weight, bias, act, residual)
        return call

    ev, steps = [], []

    def mark(name):
        if name == "start":
            ev.append({})
        ev[-1][name] = torch.cuda.Event(enable_timing=True)
        ev[-1][name].record()

    cfg = EvalConfig(tune_iters=TUNE_ITERS, tune_lr_drop_step=TUNE_DROP)
    hook = register_module_forward_pre_hook(record)
    for k in real:
        setattr(conv_mod, k, recording(k))
    _zero(counters)
    try:
        tuned = content_adaptive_finetune(model, x1, cfg, on_phase=mark)
    finally:
        hook.remove()
        for k, fn in real.items():
            setattr(conv_mod, k, fn)
    launches = _read(counters)
    kernels = ("gdn", "conv5s2", "convk_s1", "wba", "wba_proj")
    back = {k: counters[k].backwards for k in kernels}
    if back != {k: launches[k] for k in kernels}:
        raise AssertionError(f"{run}: backwards {back} != launches {launches}")
    phases = ("start", "forward", "backward", "optimizer")
    for e in ev:
        steps.append([e[a].elapsed_time(e[b]) for a, b in zip(phases, phases[1:])])
    med = sorted(steps[1:], key=sum)[len(steps[1:]) // 2]

    moved, worst = 0, 0.0
    with torch.no_grad():
        for (name, p), q in zip(tuned.named_parameters(), model.parameters()):
            if name.startswith("g_a."):
                moved += not torch.equal(p, q)
            elif not torch.equal(p, q):
                raise AssertionError(f"{run}: {name} moved outside g_a")
        n_ga = sum(1 for n, _ in tuned.named_parameters() if n.startswith("g_a."))
        if moved != n_ga:
            raise AssertionError(f"{run}: {n_ga - moved} of {n_ga} g_a leaves did not move")
        checked = 0
        for m in tuned.g_a.modules():
            if isinstance(m, Conv2d) and id(m.weight) in slots:
                checked += 1
                xs = slots[id(m.weight)]
                xr = torch.randn(xs, generator=torch.Generator().manual_seed(xs[1]))
                xr = xr.to(dev).contiguous(memory_format=torch.channels_last)
                slot = m.kernel_slot(xr)
                extra = (m.fused_act,) if slot == "convk_s1" else ()
                b64 = None if m.bias is None else m.bias.double()
                ref = getattr(conv_direct, f"{slot}_plain")(xr.double(), m.weight.double(), b64,
                                                           *extra)
                y = m(xr)
                torch.testing.assert_close(y.double(), ref, atol=TOL, rtol=TOL,
                                           msg=lambda t: f"{run} {slot} after tuning: {t}")
                worst = max(worst, float((y.double() - ref).abs().max()))
        tuned_coder = ChannelCoder(tuned, name=preset)
        if tuned_coder.digest != coder.digest:
            raise AssertionError(f"{run}: the tuned model's entropy tables changed")
        blob = tuned_coder.compress(x1)
        rec = coder.decompress(blob)
        rec_err = float((rec - _pass_forward(tuned, x1)).abs().max())
        untuned_blob = coder.compress(x1)
        after = model.state_dict()
        if not all(torch.equal(before[k], after[k]) for k in before):
            raise AssertionError(f"{run}: the model itself changed")
    if rec_err > RECON_TOL:
        raise AssertionError(f"{run}: tuned stream decodes {rec_err} off the tuned forward")
    _say("tune", preset=preset, batch=1, shape=tuple(x1.shape[2:]), steps=TUNE_ITERS,
         drop_step=TUNE_DROP, note="cut from 100 steps (drop at 50)",
         ga_leaves_moved=f"{moved}/{n_ga}", others_bitidentical=True,
         b3_b6_slots_checked=checked, b3_b6_vs_f64_tuned_weights=f"{worst:.3g}",
         tuned_stream_bytes=len(blob), untuned_stream_bytes=len(untuned_blob),
         decoded_by_untouched_coder_max_err=f"{rec_err:.3g}", model_ga_restored=True,
         launches_all_steps=launches,
         step_ms=f"{sum(med):.2f}", forward_ms=f"{med[0]:.2f}", backward_ms=f"{med[1]:.2f}",
         optimizer_ms=f"{med[2]:.2f}", all_step_ms=json.dumps([round(sum(t), 2) for t in steps]))
    del tuned, tuned_coder
    return {run: launches}


def _cli_phase(model, coder, dev):
    """[cli] the codec CLI's directory core (``cli.codec.compress_images``
    → ``decompress_streams``) on seeded images of ``CLI_SIZES`` at
    ``--batch CLI_BATCH``: each reconstruction within ``RECON_TOL`` of the
    eval forward of its image (``_pass_forward``); one image compressed
    alone then decoded in the directory's chunks (C5 through the CLI),
    bit-identical; MP/s.  Where PIL imports, also ``cli.codec.main`` and
    ``cli.eval.main`` on PNGs written under ``build/smoke_cli``.  → the
    drain calls of a decode of the chunk of two 480×640 streams."""
    import numpy as np
    import torch

    from lic_tpu_torch.cli import codec as cli_codec
    from lic_tpu_torch.data import smooth_images
    from lic_tpu_torch.data.pad import pad_to_multiple
    from lic_tpu_torch.tools.kernel_probe import record_drains

    rng = np.random.default_rng(SEED + 11)
    items = [(f"im{i}", smooth_images(rng, 1, h, w)[0].transpose(1, 2, 0).copy())
             for i, (h, w) in enumerate(CLI_SIZES)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blobs = cli_codec.compress_images(coder, items, CLI_BATCH)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    recs = dict(cli_codec.decompress_streams(coder, blobs, CLI_BATCH))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    worst = 0.0
    with torch.no_grad():
        for name, img in items:
            x = torch.from_numpy(img.transpose(2, 0, 1)[None]).to(dev)
            xp, (h, w) = pad_to_multiple(x.contiguous(memory_format=torch.channels_last), 64)
            ref = _pass_forward(model, xp)[0, :, :h, :w].permute(1, 2, 0).cpu().numpy()
            worst = max(worst, float(np.abs(recs[name] - ref).max()))
    single = [(items[0][0], coder.compress(
        torch.from_numpy(items[0][1].transpose(2, 0, 1)[None].copy()).to(dev)))]
    mixed = dict(cli_codec.decompress_streams(coder, single + blobs[1:], CLI_BATCH))
    same = single[0][1] == blobs[0][1] and np.array_equal(mixed[items[0][0]], recs[items[0][0]])
    if worst > RECON_TOL or not same:
        raise AssertionError(f"cli: directory decode {worst} off the forward, single-file "
                             f"stream in the chunk identical: {same}")
    mp = sum(h * w for h, w in CLI_SIZES) / 1e6
    try:
        import PIL

        pil = PIL.__version__
    except ImportError:
        pil = "absent"
    _say("cli", preset="source_net", images=len(items), sizes=json.dumps(CLI_SIZES),
         batch=CLI_BATCH, recon_max_err=f"{worst:.3g}", single_file_stream_in_chunk=same,
         compress_s=f"{t1 - t0:.3f}", decompress_s=f"{t2 - t1:.3f}",
         dir_mode_mps=f"{mp / (t2 - t0):.3f}", pil=pil)
    if pil != "absent":
        _cli_mains(model, items)
    return record_drains(coder, [b for _, b in blobs[3:]])


def _cli_mains(model, items):
    """``cli.codec.main`` (directory compress, decompress) and
    ``cli.eval.main`` on PNGs of ``items`` under ``build/smoke_cli``, the
    smoke's weights saved as a ``.npz``: every file written, the decoded
    PNGs of full size, an ``AVG:`` line."""
    import contextlib
    import io
    import shutil

    import numpy as np
    from PIL import Image

    from lic_tpu_torch.cli import codec as cli_codec, eval as cli_eval
    from lic_tpu_torch.utils.checkpoint import save_params

    root = os.path.join(ROOT, "build", "smoke_cli")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "png"))
    for name, img in items:
        Image.fromarray(np.clip((img + 1) * 127.5 + 0.5, 0, 255).astype(np.uint8)).save(
            os.path.join(root, "png", f"{name}.png"))
    weights = os.path.join(root, "w.npz")
    save_params(weights, model)
    device = ["--device", next(model.parameters()).device.type]
    common = ["--weight_path", weights, "--preset", "source_net", "--batch", str(CLI_BATCH),
              *device]
    t0 = time.perf_counter()
    cli_codec.main(["compress", os.path.join(root, "png"), os.path.join(root, "ltc"), *common])
    cli_codec.main(["decompress", os.path.join(root, "ltc"), os.path.join(root, "out"), *common])
    t1 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli_eval.main(["--data_path", os.path.join(root, "png"), "--weight_path", weights,
                       "--preset", "source_net", *device])
    avg = [l for l in out.getvalue().splitlines() if l.startswith("AVG:")]
    sizes = [Image.open(os.path.join(root, "out", f"{n}.png")).size[::-1] for n, _ in items]
    if sizes != [img.shape[:2] for _, img in items] or len(avg) != 1:
        raise AssertionError(f"cli mains: decoded sizes {sizes}, AVG lines {avg}")
    _say("cli_main", codec_compress_decompress_s=f"{t1 - t0:.3f}", files=len(items),
         eval_avg=repr(avg[0]))


def _wake_eb(*models):
    """Seeded values (0.05·N(0, 1), the same on every model given) for the
    entropy bottleneck's all-zero leaves, its ``factor_i``, as a trained
    checkpoint has them: at their zero init the pmf table takes no tanh
    of them, and ROADMAP §C7 hid there.  → leaves woken per model."""
    import torch

    for m in models:
        g = torch.Generator().manual_seed(SEED + 2)
        woken = 0
        with torch.no_grad():
            for _, p in m.entropy_bottleneck.named_parameters():
                if not p.any():
                    p.copy_(0.05 * torch.randn(p.shape, generator=g))
                    woken += 1
    return woken


def _c7(dev):
    """[c7] ``source_net`` and ``source_net_vr`` with their EB woken
    (``_wake_eb``): the z-coder's pmf table, quantized CDFs and digest of
    a coder on the card equal, bit for bit, those of the same weights on
    the CPU (the table is computed on the host, ``entropy/xla_f32.py``);
    a ``C7_SIZE`` stream written on the card decodes with the CPU model,
    within ``RECON_TOL`` of the card's decode."""
    import numpy as np
    import torch

    from lic_tpu_torch.data import smooth_images
    from lic_tpu_torch.models import build_model
    from lic_tpu_torch.models.compress import Z_RANGE, ChannelCoder

    for preset in ("source_net", "source_net_vr"):
        card = build_model(preset, device=dev, seed=SEED)
        cpu = build_model(preset, device="cpu", seed=SEED)
        woken = _wake_eb(card, cpu)
        pmf_card, pmf_cpu = card.eb_pmf_table(-Z_RANGE, Z_RANGE - 1), cpu.eb_pmf_table(
            -Z_RANGE, Z_RANGE - 1)
        c_card, c_cpu = ChannelCoder(card, name=preset), ChannelCoder(cpu, name=preset)
        cdfs_equal = np.array_equal(c_card.z_coder.codec.cdfs, c_cpu.z_coder.codec.cdfs)
        if not (woken and torch.equal(pmf_card, pmf_cpu) and cdfs_equal
                and c_card.digest == c_cpu.digest):
            raise AssertionError(f"c7 {preset}: the card's EB tables differ from the CPU's "
                                 f"(woken {woken}, digests {c_card.digest:#010x} / "
                                 f"{c_cpu.digest:#010x})")
        x = torch.from_numpy(smooth_images(np.random.default_rng(SEED + 7), 1, *C7_SIZE))
        rate = 1.5 if c_card.has_gain else None
        blob = c_card.compress(x.to(dev), rate=rate)
        rec_cpu = c_cpu.decompress(blob)  # raises on a σ-row or CDF mismatch
        rec_card = c_card.decompress(blob).cpu()
        diff = float((rec_cpu - rec_card).abs().max())
        if diff > RECON_TOL:
            raise AssertionError(f"c7 {preset}: the CPU decode is {diff} off the card's")
        _say("c7", preset=preset, eb_leaves_woken=woken, digest_card=f"{c_card.digest:#010x}",
             digest_cpu=f"{c_cpu.digest:#010x}", pmf_bits_equal=True, cdfs_equal=cdfs_equal,
             card_stream_decoded_on_cpu=True, size=C7_SIZE, rate=rate, stream_bytes=len(blob),
             cpu_vs_card_recon_max_diff=f"{diff:.3g}")
        del card, cpu, c_card, c_cpu


def _rate_forward(model, x, rates):
    """``_pass_forward`` at per-image rates: the eval forward of each image
    in the coder's passes, each at its rate."""
    import torch

    from lic_tpu_torch.models.compress import _passes, pass_batch

    r = torch.tensor(rates, dtype=torch.float32, device=x.device)
    with torch.no_grad():
        return _passes(lambda t, rr: model(t, rate=rr).x_tilde,
                       pass_batch(*x.shape[2:], x.device), x, r)


def _drive_vr(dev, counters, conv_calls, gdn_calls, shapes):
    """[vr] ``source_net_vr`` at full width (its EB woken), B = 8 at
    512×768, through the public entry points: the eval forward at each of
    ``VR_SWEEP`` (bpp strictly rising, the 1.5 point between 1 and 2);
    the main path, forward at ``VR_RATES`` + ``compress_batch`` at those
    rates + ``decompress_batch`` with counters zeroed just before and read
    just after (exact launches, its B2/B3/B6 calls recorded for 6-7);
    every stream against ``compress`` of its image alone at its rate,
    bytes; the decode within ``RECON_TOL`` of each image's eval forward at
    its rate; ``solve_rate_for_bpp`` on one image (probes, rate, ms); one
    multi-rate training step (``lmbda_list``) on 4 crops, its launches and
    backwards exact and its kernel shapes recorded for [grad]; then
    [serve] on the same model.  → {run: launches}."""
    import numpy as np
    import torch

    from lic_tpu_torch.config import TrainConfig
    from lic_tpu_torch.data import smooth_images
    from lic_tpu_torch.models import build_model
    from lic_tpu_torch.models.compress import ChannelCoder
    from lic_tpu_torch.serving import solve_rate_for_bpp
    from lic_tpu_torch.training import create_state, make_optimizer, make_train_step

    preset = "source_net_vr"
    model = build_model(preset, device=dev, seed=SEED)
    woken = _wake_eb(model)
    x = torch.from_numpy(smooth_images(np.random.default_rng(SEED + 8), BATCH, H, W)).to(
        dev).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        sweep = {r: float(model(x, rate=r).bpp) for r in VR_SWEEP}
    rising = all(sweep[a] < sweep[b] for a, b in zip(VR_SWEEP, VR_SWEEP[1:]))
    if not (rising and sweep[1.0] < sweep[1.5] < sweep[2.0]):
        raise AssertionError(f"vr: bpp does not rise with the rate: {sweep}")

    coder = ChannelCoder(model, name=preset)
    hooks = _record_conv_slots(model, conv_calls, preset) + _record_gdn(model, gdn_calls, preset)
    _zero(counters)
    with torch.no_grad():
        out = model(x, rate=VR_RATES)
    blobs = coder.compress_batch(x, rates=VR_RATES)
    rec = coder.decompress_batch(blobs)
    runs = {preset: _read(counters)}
    for h in hooks:
        h.remove()
    _hooks_agree(preset, runs[preset], conv_calls, gdn_calls)
    if not (torch.isfinite(out.x_tilde).all() and torch.isfinite(out.bpp)):
        raise AssertionError("vr: non-finite forward output")
    alone = [coder.compress(x[i : i + 1], rate=r) for i, r in enumerate(VR_RATES)]
    if alone != blobs:
        bad = [i for i, (a, b) in enumerate(zip(alone, blobs)) if a != b]
        raise AssertionError(f"vr: streams {bad} differ from their image's compress alone")
    rec_err = float((rec - _rate_forward(model, x, VR_RATES)).abs().max())
    if rec_err > RECON_TOL:
        raise AssertionError(f"vr: decoded recon differs from the forward at its rate: {rec_err}")
    sizes = [len(b) for b in blobs]
    mp = BATCH * H * W / 1e6
    with torch.no_grad():
        fwd_ms = _cuda_ms(lambda: model(x, rate=VR_RATES), 3)
    rt = sorted(_cuda_ms(lambda: coder.decompress_batch(coder.compress_batch(x, rates=VR_RATES)),
                         1) / 1e3 for _ in range(3))[1]
    _say("vr", preset=preset, eb_leaves_woken=woken, weights="UNTRAINED",
         bpp_by_rate=json.dumps({str(r): round(b, 4) for r, b in sweep.items()}),
         rates=json.dumps(VR_RATES), bytes_by_rate=json.dumps(sizes),
         codec_bpp=f"{sum(sizes) * 8 / (BATCH * H * W):.4f}",
         streams_equal_compress_alone=True, recon_max_err=f"{rec_err:.3g}",
         launches=runs[preset], forward_ms=f"{fwd_ms:.2f}",
         forward_mps=f"{mp / fwd_ms * 1e3:.2f}", roundtrip_s=f"{rt:.3f}",
         roundtrip_mps=f"{mp / rt:.3f}")

    # rate control on one image: the bisection's probes are eval forwards
    probes = []
    hook = model.register_forward_hook(lambda m, a, o: probes.append(1))
    x1 = x[:1]
    with torch.no_grad():
        lo, hi = (float(model(x1, rate=r).bpp) for r in (0.0, 3.0))
    probes.clear()
    target = 0.5 * (lo + hi)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rate, est = solve_rate_for_bpp(model, x1, target)
    torch.cuda.synchronize()
    solve_ms = (time.perf_counter() - t0) * 1e3
    hook.remove()
    if not (0.0 < rate < 3.0 and abs(est - target) <= 0.02 * target):
        raise AssertionError(f"vr: solve_rate_for_bpp({target}) → {rate}, {est}")
    _say("vr_solve", target_bpp=f"{target:.4f}", rate=f"{rate:.6f}", est_bpp=f"{est:.4f}",
         probes=len(probes), ms=f"{solve_ms:.1f}", ms_per_probe=f"{solve_ms / len(probes):.1f}")

    del coder
    runs.update(_serve(model, dev, counters))

    # one multi-rate training step: the unit k drawn by the step
    model.train()
    tc = TrainConfig(lmbda_list=VR_LMBDAS)
    opt = make_optimizer(model, tc, steps_per_epoch=1000)
    state = create_state(model, opt, tc.seed)
    step_fn = make_train_step(model, tc, opt)
    batch = _train_batch(dev)[:4]
    run = f"train:{preset}"
    hooks = _record_conv_slots(model, shapes["conv"], run) + _record_train_shapes(model, shapes)
    kernels = ("gdn", "conv5s2", "convk_s1")
    _zero(counters)
    metrics = step_fn(state, batch)
    runs[run] = _read(counters)
    for h in hooks:
        h.remove()
    back = {k: counters[k].backwards for k in kernels}
    if back != {k: runs[run][k] for k in kernels}:
        raise AssertionError(f"{run}: backwards {back} != launches {runs[run]}")
    k = int(metrics["rate"])
    grad = model.log_gain.grad
    if not (torch.isfinite(metrics["loss"]) and not float(metrics["skipped"])
            and torch.isfinite(grad).all() and grad[k].abs().max() > 0):
        raise AssertionError(f"{run}: loss {float(metrics['loss'])}, unit {k}, "
                             f"log_gain grad row {grad[k].abs().max()}")
    _say("vr_train", preset=preset, batch=4, crop=TRAIN_CROP, unit=k, lmbda=VR_LMBDAS[k],
         loss=f"{float(metrics['loss']):.4f}", launches=runs[run], backwards=back,
         log_gain_grad_row_max=f"{float(grad[k].abs().max()):.3g}")
    model.eval()
    return runs


def _serve(model, dev, counters):
    """[serve] ``CodecService(max_batch=8, max_wait_ms=5)`` over the model:
    ``SERVE_REQUESTS`` compress requests from ``SERVE_THREADS`` threads at
    two sizes (512×768 and 480×640, padded to 512×640) and rates cycling
    through ``VR_RATES``, then their decompresses.  Every stream equals
    ``coder.compress`` of its image at its rate and every decode
    ``coder.decompress`` of its stream, bit for bit; no error.  The
    service's launches, counters zeroed before the first request and read
    after the last, equal the model passes of the batches it formed
    (recorded around ``compress_batch`` / ``decompress_batch``).  p50/p95
    latency, mean batch, requests/s.  → {run: launches}."""
    import numpy as np
    import torch

    from lic_tpu_torch.data import smooth_images
    from lic_tpu_torch.models.compress import pass_batch
    from lic_tpu_torch.serving import CodecService

    rng = np.random.default_rng(SEED + 9)
    sizes = SERVE_SIZES
    reqs = [(smooth_images(rng, 1, *sizes[i % 2])[0].transpose(1, 2, 0).copy(),
             VR_RATES[i % len(VR_RATES)]) for i in range(SERVE_REQUESTS)]
    svc = CodecService(model, name="source_net_vr", max_batch=8, max_wait_ms=5)
    coder = svc.coder
    formed = []  # (kind, padded h, w, images) of each batch the service ran
    inner_c, inner_d = coder.compress_batch, coder.decompress_batch

    def compress_batch(xs, rates=None):
        formed.append(("c", *xs.shape[2:], xs.shape[0]))
        return inner_c(xs, rates=rates)

    def decompress_batch(blobs):
        h, w = coder._parse_header(blobs[0])[1:3]
        formed.append(("d", h, w, len(blobs)))
        return inner_d(blobs)

    coder.compress_batch, coder.decompress_batch = compress_batch, decompress_batch
    _zero(counters)
    svc.start()
    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(SERVE_THREADS) as pool:
            futs = list(pool.map(lambda r: svc.submit_compress(r[0], rate=r[1]), reqs))
            blobs = [f.result(timeout=600) for f in futs]
        t1 = time.perf_counter()
        with ThreadPoolExecutor(SERVE_THREADS) as pool:
            futs = list(pool.map(svc.submit_decompress, blobs))
            recs = [f.result(timeout=600) for f in futs]
        t2 = time.perf_counter()
    finally:
        svc.stop()
        coder.compress_batch, coder.decompress_batch = inner_c, inner_d
    runs = {"serve:source_net_vr": _read(counters)}
    stats = svc.stats.snapshot()
    # each batch runs ceil(n / pass_batch) model passes; per pass, compress
    # runs g_a (3 B2, 3 B3), h_a.c0, both h_s.c2 and slice 0's two c0 (5
    # B6); decompress runs both h_s.c2 and slice 0's c0s (4 B6), 4 drains
    # and g_s (4 B2)
    want = {k: 0 for k in counters}
    per_pass = {"c": {"gdn": 3, "conv5s2": 3, "convk_s1": 5},
                "d": {"gdn": 4, "convk_s1": 4, "drain": 4}}
    for kind, h, w, n in formed:
        hp, wp = -(-h // 64) * 64, -(-w // 64) * 64
        passes = -(-n // pass_batch(hp, wp, dev))
        for key, v in per_pass[kind].items():
            want[key] += v * passes
    if runs["serve:source_net_vr"] != want:
        raise AssertionError(f"serve: launches {runs['serve:source_net_vr']}, the batches "
                             f"{formed} need {want}")
    for (img, rate), blob, rec in zip(reqs, blobs, recs):
        x1 = torch.from_numpy(img.transpose(2, 0, 1)[None].copy()).to(dev)
        if blob != coder.compress(x1, rate=rate):
            raise AssertionError(f"serve: a stream at rate {rate} differs from compress")
        direct = coder.decompress(blob)[0].permute(1, 2, 0).cpu().numpy()
        if rec.shape != img.shape or not np.array_equal(rec, direct):
            raise AssertionError("serve: a decode differs from decompress")
    if stats["errors"] or stats["requests"] != 2 * SERVE_REQUESTS:
        raise AssertionError(f"serve: stats {stats}")
    _say("serve", requests=2 * SERVE_REQUESTS, threads=SERVE_THREADS, sizes=json.dumps(sizes),
         rates=json.dumps(VR_RATES), batches=stats["batches"],
         mean_batch=f"{stats['mean_batch']:.2f}", p50_ms=f"{stats['p50_ms']:.1f}",
         p95_ms=f"{stats['p95_ms']:.1f}", errors=stats["errors"],
         compress_req_per_s=f"{SERVE_REQUESTS / (t1 - t0):.2f}",
         decompress_req_per_s=f"{SERVE_REQUESTS / (t2 - t1):.2f}",
         streams_equal_compress=True, decodes_equal_decompress=True,
         batches_formed=json.dumps([f"{k}{n}@{h}x{w}" for k, h, w, n in formed]),
         launches=runs["serve:source_net_vr"])
    return runs


def _c8(dev):
    """[c8] for each of ``C8_PRESETS`` (EB woken, as in [c7]): one 512×768
    stream written by the card coder in its pass of 8 (``source_net_vr``
    at rate 1.5), decoded by the CPU model of the same weights.  The CPU
    decode either equals the card's within ``RECON_TOL`` or raises the
    final-state check's ``ValueError``; other pixels fail the phase, and
    so does a raise where no σ-row differs.  Beside it, the σ-rows of the
    decoder's passes on the CPU against the card's, on the card's stream
    (``tools.batch_probe.rows_card_vs_cpu``)."""
    import numpy as np
    import torch

    from lic_tpu_torch.data import smooth_images
    from lic_tpu_torch.models import build_model
    from lic_tpu_torch.models.compress import ChannelCoder, pass_batch
    from lic_tpu_torch.tools.batch_probe import rows_card_vs_cpu

    for preset in C8_PRESETS:
        t0 = time.perf_counter()
        card = build_model(preset, device=dev, seed=SEED)
        cpu = build_model(preset, device="cpu", seed=SEED)
        woken = _wake_eb(card, cpu)
        c_card, c_cpu = ChannelCoder(card, name=preset), ChannelCoder(cpu, name=preset)
        x = torch.from_numpy(smooth_images(np.random.default_rng(SEED + 13), 1, H, W)).to(
            dev).contiguous(memory_format=torch.channels_last)
        rate = 1.5 if c_card.has_gain else None
        blob = c_card.compress(x, rate=rate)
        rec_card = c_card.decompress(blob).cpu()
        rows = rows_card_vs_cpu(card, cpu, c_card, c_cpu, x, rate=rate)
        t1 = time.perf_counter()
        try:
            rec_cpu = c_cpu.decompress(blob)
            outcome, diff = "equal", float((rec_cpu - rec_card).abs().max())
        except ValueError as e:
            if "final-state" not in str(e):
                raise
            outcome, diff = "raised the final-state check", None
        cpu_s = time.perf_counter() - t1
        if diff is not None and diff > RECON_TOL:
            raise AssertionError(f"c8 {preset}: the CPU decode returned other pixels ({diff})")
        if diff is None and not rows["rows"]:
            raise AssertionError(f"c8 {preset}: the CPU decode raised with no σ-row differing")
        _say("c8", preset=preset, size=f"{H}x{W}", pass_batch_card=pass_batch(H, W, dev),
             pass_batch_cpu=pass_batch(H, W, torch.device("cpu")),
             rate=rate, eb_leaves_woken=woken, stream_bytes=len(blob),
             sigma_rows_differing=rows["rows"], of_symbols=rows["symbols"],
             rows_differing_by_slice=json.dumps(rows["steps"]), cpu_decode=repr(outcome),
             cpu_vs_card_recon_max_diff="n/a" if diff is None else f"{diff:.3g}",
             cpu_decode_s=f"{cpu_s:.2f}", seconds=f"{time.perf_counter() - t0:.1f}")
        del card, cpu, c_card, c_cpu


def _host_timer(coder):
    """Wrap the host coding calls of a ``ProgressiveCoder`` (z-coder,
    trit-plane coder) to add their seconds into the returned dict's
    ``"s"``."""
    spent = {"s": 0.0}
    plane = coder.gauss if coder.gauss is not None else coder.trit
    for obj, names in ((coder.z_coder, ("encode_symbols", "decode_symbols")),
                       (plane, ("encode", "decode"))):
        for name in names:
            inner = getattr(obj, name)

            def timed(*a, _inner=inner, **k):
                t0 = time.perf_counter()
                try:
                    return _inner(*a, **k)
                finally:
                    spent["s"] += time.perf_counter() - t0
            setattr(obj, name, timed)
    return spent


def _drive_prog(dev, counters):
    """[prog] ``ProgressiveCoder`` over ``source_net`` (EB woken) on one
    seeded image of each of ``PROG_SIZES``, both digit models: compress
    then the full decompress with counters zeroed just before and read
    just after (exact launches); the full decode within ``RECON_TOL`` of
    the eval forward in the coder's passes (``_pass_forward``); a decode
    at every truncation point, each MSE against the image no worse than
    the step before's by 1% (``tests/test_progressive.py``); the blob
    cut by 3 bytes raises; the planes, bytes per truncation point, ms of
    compress and full decompress (median of 3) and the host share (the
    host's trit-plane and z coding over the wall time).  Where PIL
    imports, ``cli.codec.main --progressive`` and ``--truncate_planes``
    on a PNG.  → {run: launches}."""
    import numpy as np
    import torch

    from lic_tpu_torch.data import smooth_images
    from lic_tpu_torch.data.pad import pad_to_multiple
    from lic_tpu_torch.models import build_model
    from lic_tpu_torch.models.compress import pass_batch
    from lic_tpu_torch.models.progressive import ProgressiveCoder

    model = build_model("source_net", device=dev, seed=SEED)
    woken = _wake_eb(model)
    runs = {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for i, (h, w) in enumerate(PROG_SIZES):
        x = torch.from_numpy(smooth_images(np.random.default_rng(SEED + 12 + i), 1, h, w)).to(
            dev).contiguous(memory_format=torch.channels_last)
        xp, _ = pad_to_multiple(x, 64)
        ref = _pass_forward(model, xp)[:, :, :h, :w]
        for dm in PROG_DIGITS:
            t_phase = time.perf_counter()
            run = f"prog:{dm}@{h}x{w}"
            coder = ProgressiveCoder(model, name="source_net", digit_model=dm)
            host = _host_timer(coder)
            _zero(counters)
            blob = coder.compress(x)
            rec = coder.decompress(blob)
            runs[run] = _read(counters)
            rec_err = float((rec - ref).abs().max())
            if rec_err > RECON_TOL:
                raise AssertionError(f"{run}: full decode {rec_err} off the forward")
            pts = coder.truncation_points(blob)
            mses = [float(torch.mean((coder.decompress(blob, n) - x) ** 2)) for n, _ in pts]
            worse = [k for k in range(1, len(mses)) if mses[k] > mses[k - 1] * 1.01]
            if worse:
                raise AssertionError(f"{run}: MSE rose at planes {worse}: {mses}")
            try:
                coder.decompress(blob[:-3])
                raise AssertionError(f"{run}: a blob cut by 3 bytes decoded")
            except ValueError:
                pass
            times = {"compress": [], "decompress": []}
            shares = {"compress": [], "decompress": []}
            for _ in range(3):
                for kind, fn in (("compress", lambda: coder.compress(x)),
                                 ("decompress", lambda: coder.decompress(blob))):
                    host["s"] = 0.0
                    _, dt = timed(fn)
                    times[kind].append(dt)
                    shares[kind].append(host["s"] / dt)
            med = {k: sorted(v)[1] for k, v in times.items()}
            share = {k: sorted(v)[1] for k, v in shares.items()}
            planes = [len(p) for p in coder.parse(blob)[4]]
            _say("prog", preset="source_net", size=f"{h}x{w}", digit_model=dm,
                 eb_leaves_woken=woken, pass_batch=pass_batch(*xp.shape[2:], dev),
                 planes_by_slice=json.dumps(planes), stream_bytes=len(blob),
                 bpp=f"{len(blob) * 8 / (h * w):.4f}",
                 bytes_by_truncation_point=json.dumps([b for _, b in pts]),
                 mse_by_truncation_point=json.dumps([float(f"{m:.5g}") for m in mses]),
                 full_decode_vs_forward=f"{rec_err:.3g}", truncated_blob_raises=True,
                 launches=runs[run], compress_ms=f"{med['compress'] * 1e3:.1f}",
                 decompress_ms=f"{med['decompress'] * 1e3:.1f}",
                 host_share_compress=f"{share['compress']:.3f}",
                 host_share_decompress=f"{share['decompress']:.3f}",
                 seconds=f"{time.perf_counter() - t_phase:.1f}", weights="UNTRAINED")
    _cli_flags(model, "prog")
    return runs


def _cli_flags(model, phase):
    """Where PIL imports: the codec CLI on the card with this slice's flags,
    on a seeded 480×640 PNG under ``build/smoke_cli_<phase>`` and the
    model's weights saved as a ``.npz``.  ``prog``: ``--progressive``
    compress, then decompress with ``--truncate_planes 2`` and with all
    planes, the decodes of the sizes of the image and the full one equal
    to ``ProgressiveCoder.decompress`` (uint8); ``han``:
    ``--post_processing`` compress and decompress, and ``cli.eval.main
    --post_processing`` (its ``AVG:`` line)."""
    try:
        from PIL import Image
    except ImportError:
        _say(f"{phase}_cli", pil="absent")
        return
    import contextlib
    import io
    import shutil

    import numpy as np
    import torch

    from lic_tpu_torch.cli import codec as cli_codec, eval as cli_eval
    from lic_tpu_torch.data import smooth_images
    from lic_tpu_torch.utils.checkpoint import save_params

    t0 = time.perf_counter()
    root = os.path.join(ROOT, "build", f"smoke_cli_{phase}")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "png"))
    img = smooth_images(np.random.default_rng(SEED + 14), 1, 480, 640)[0].transpose(1, 2, 0)
    png = os.path.join(root, "png", "a.png")
    Image.fromarray(np.clip((img + 1) * 127.5 + 0.5, 0, 255).astype(np.uint8)).save(png)
    weights = os.path.join(root, "w.npz")
    save_params(weights, model)
    device = next(model.parameters()).device.type
    common = ["--weight_path", weights, "--preset", "source_net", "--device", device]
    out = io.StringIO()
    line = {}
    with contextlib.redirect_stdout(out):
        if phase == "prog":
            from lic_tpu_torch.data.datasets import load_image_uint8, normalize_pm1, to_batch
            from lic_tpu_torch.models.progressive import ProgressiveCoder

            cli_codec.main(["compress", png, os.path.join(root, "a.ltcp"), *common,
                            "--progressive"])
            for n in (2, None):
                extra = [] if n is None else ["--truncate_planes", str(n)]
                cli_codec.main(["decompress", os.path.join(root, "a.ltcp"),
                                os.path.join(root, f"a{n}.png"), *common, "--progressive",
                                *extra])
            with open(os.path.join(root, "a.ltcp"), "rb") as fd:
                blob = fd.read()
            coder = ProgressiveCoder(model, name="source_net")
            x = to_batch(normalize_pm1(load_image_uint8(png))[None], device)
            same_bytes = blob == coder.compress(x)
            for n in (2, None):
                want = cli_codec.to_uint8(coder.decompress(blob, n)[0].permute(1, 2, 0).cpu()
                                          .numpy())
                got = np.asarray(Image.open(os.path.join(root, f"a{n}.png")))
                if not (same_bytes and np.array_equal(got, want)):
                    raise AssertionError(f"prog cli: bytes equal {same_bytes}, decode at "
                                         f"{n} planes differs from decompress")
            line = dict(stream_bytes=len(blob), planes=coder.truncation_points(blob)[-1][0],
                        cli_bytes_equal_compress=True, truncate_planes_2_equal=True)
        else:
            cli_codec.main(["compress", png, os.path.join(root, "a.ltc"), *common,
                            "--post_processing"])
            cli_codec.main(["decompress", os.path.join(root, "a.ltc"),
                            os.path.join(root, "a_rec.png"), *common, "--post_processing"])
            cli_eval.main(["--data_path", os.path.join(root, "png"), "--weight_path", weights,
                           "--preset", "source_net", "--post_processing", "--device", device])
            size = Image.open(os.path.join(root, "a_rec.png")).size[::-1]
            avg = [l for l in out.getvalue().splitlines() if l.startswith("AVG:")]
            if size != img.shape[:2] or len(avg) != 1:
                raise AssertionError(f"han cli: decoded size {size}, AVG lines {avg}")
            line = dict(decoded_size=f"{size[0]}x{size[1]}", eval_avg=repr(avg[0]))
    torch.cuda.synchronize()
    _say(f"{phase}_cli", device=device, **line, seconds=f"{time.perf_counter() - t0:.1f}")


def _wake_han(*models):
    """Seeded values for the HAN's all-zero leaves that ``_wake_zero_leaves``
    leaves (its biases, the LAM and CSAM scales γ), the same on every
    model given: at γ = 0 layer and channel-spatial attention add exactly
    0.  → leaves woken per model."""
    import torch

    for m in models:
        g = torch.Generator().manual_seed(SEED + 4)
        woken = 0
        with torch.no_grad():
            for _, p in m.han.named_parameters():
                if not p.any():
                    fan_in = p[0].numel() if p.dim() > 1 else 4
                    p.copy_(torch.randn(p.shape, generator=g) * 0.5 * fan_in ** -0.5)
                    woken += 1
    return woken


def _drive_han(dev, counters, conv_calls, gdn_calls, shapes):
    """[han] ``source_net`` with ``post_processing=True`` (every all-zero HAN
    leaf woken, the same on the card and the CPU): the stages at
    ``HAN_SMALL``² against the CPU model (``_small_stages``, then the
    tail's: the generated conv's RGB, the HAN features on the CPU's RGB,
    the tail's output), within ``RECON_TOL``; the main path, the B = 8
    512×768 eval forward + ``compress_batch`` → ``decompress_batch`` with
    exact launches (its B2/B3/B6 calls recorded for 6-7), the decode within
    ``RECON_TOL`` of the forward in the coder's passes; the forward's ms
    with and without the tail and its peak memory; ``evaluate_image`` at
    B = 1 (launches, finite metrics); the CLIs' ``--post_processing``.
    [han_train]: one phase-2 step (``freeze_partition``, AdamW, the
    gradient cut at the HAN input) on B = 8 256×256 crops: exact launches
    and no backward through a kernel, every base leaf bit-identical with
    no optimizer state, every HAN leaf with a gradient moved; ms by phase
    and peak memory; its kernel shapes into [grad].  → {run: launches}."""
    import numpy as np
    import torch

    from lic_tpu_torch.config import TrainConfig
    from lic_tpu_torch.data import smooth_images
    from lic_tpu_torch.evaluation import evaluate_image
    from lic_tpu_torch.models import build_model
    from lic_tpu_torch.models.compress import ChannelCoder
    from lic_tpu_torch.training import (create_state, freeze_partition, make_optimizer,
                                        make_train_step)

    t_phase = time.perf_counter()
    model = build_model("source_net", device=dev, seed=SEED, post_processing=True)
    cpu = build_model("source_net", device="cpu", seed=SEED, post_processing=True)
    woken = _wake_zero_leaves(model, cpu) + _wake_han(model, cpu)
    x_np = smooth_images(np.random.default_rng(SEED), BATCH, H, W)
    x = torch.from_numpy(x_np).to(dev).contiguous(memory_format=torch.channels_last)
    small = torch.from_numpy(x_np[:1, :, :HAN_SMALL, :HAN_SMALL].copy())

    def on_gpu(t):
        return t.to(dev).contiguous(memory_format=torch.channels_last)

    base_err = _small_stages("source_net+han", model, cpu, small, on_gpu)
    with torch.no_grad():
        z3 = cpu.analyze(small)
        xt = cpu.g_s(cpu(small).extras["y_hat"])
        syn = cpu.syntax_from_latent(z3)
        rgb_c = cpu._decode_tail(xt, syn, use_post_processing=False)
        stages_c = {"rgb": rgb_c, "han": cpu.han(rgb_c), "tail": cpu._decode_tail(xt, syn)}
        stages_g = {"rgb": model._decode_tail(on_gpu(xt), on_gpu(syn), use_post_processing=False),
                    "han": model.han(on_gpu(rgb_c)),
                    "tail": model._decode_tail(on_gpu(xt), on_gpu(syn))}
    han_err = {k: float((stages_g[k].cpu() - v).abs().max()) for k, v in stages_c.items()}
    han_mag = {k: float(v.abs().max()) for k, v in stages_c.items()}
    if max(han_err.values()) > RECON_TOL:
        raise AssertionError(f"han: the tail's stages on the card are off the CPU's: {han_err}")
    del cpu

    run = "han:source_net"
    coder = ChannelCoder(model, name="source_net+han")
    hooks = _record_conv_slots(model, conv_calls, run) + _record_gdn(model, gdn_calls, run)
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    with torch.no_grad():
        out = model(x)
    peak_fwd = torch.cuda.max_memory_allocated() / 2 ** 30
    blobs = coder.compress_batch(x)
    rec = coder.decompress_batch(blobs)
    runs = {run: _read(counters)}
    for h in hooks:
        h.remove()
    _hooks_agree(run, runs[run], conv_calls, gdn_calls)
    if not (torch.isfinite(out.x_tilde).all() and torch.isfinite(out.bpp)):
        raise AssertionError("han: non-finite forward output")
    rec_err = float((rec - _pass_forward(model, x)).abs().max())
    if rec_err > RECON_TOL:
        raise AssertionError(f"han: decoded recon differs from the forward: {rec_err}")
    mp = BATCH * H * W / 1e6
    with torch.no_grad():
        fwd_ms = _cuda_ms(lambda: model(x), 3)
        base_ms = _cuda_ms(lambda: model(x, use_post_processing=False), 3)
    rt = sorted(_cuda_ms(lambda: coder.decompress_batch(coder.compress_batch(x)), 1) / 1e3
                for _ in range(3))[1]

    erun = "eval:han@512x768"
    _zero(counters)
    r = evaluate_image(model, x[:1])
    runs[erun] = _read(counters)
    if not all(np.isfinite(r[k]) for k in ("bpp", "psnr", "mse", "msssim")):
        raise AssertionError(f"{erun}: non-finite metrics {r}")
    secs = sorted(evaluate_image(model, x[:1])["seconds"] for _ in range(3))
    _say("han", preset="source_net", post_processing=True, leaves_woken=woken,
         small_vs_cpu_max_err=f"{max(base_err.values()):.3g}",
         tail_stages_vs_cpu=json.dumps({k: float(f"{v:.3g}") for k, v in han_err.items()}),
         tail_stage_max_abs=json.dumps({k: round(v, 3) for k, v in han_mag.items()}),
         launches=runs[run], bpp_est=f"{float(out.bpp):.4f}", recon_max_err=f"{rec_err:.3g}",
         forward_ms=f"{fwd_ms:.2f}", forward_without_tail_ms=f"{base_ms:.2f}",
         forward_mps=f"{mp / fwd_ms * 1e3:.2f}", forward_peak_mem_gib=f"{peak_fwd:.2f}",
         roundtrip_s=f"{rt:.3f}", eval_b1_launches=runs[erun],
         eval_b1_ms=f"{secs[1] * 1e3:.2f}", eval_psnr=f"{r['psnr']:.3f}",
         batch=BATCH, shape=f"{H}x{W}", seconds=f"{time.perf_counter() - t_phase:.1f}",
         weights="UNTRAINED")
    del out, rec, coder
    _cli_flags(model, "han")

    # [han_train]: the HAN-only phase
    t_phase = time.perf_counter()
    run = "train:han_phase2"
    model.train()
    tc = TrainConfig()
    labels = freeze_partition(model, True)
    opt = make_optimizer(model, tc, steps_per_epoch=1000, post_processing_phase=True)
    state = create_state(model, opt, tc.seed)
    step_fn = make_train_step(model, tc, opt, post_processing_phase=True)
    batch = _train_batch(dev)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    hooks = _record_conv_slots(model, shapes["conv"], run) + _record_train_shapes(model, shapes)
    ev = {}

    def mark(name):
        ev[name] = torch.cuda.Event(enable_timing=True)
        ev[name].record()

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    metrics = step_fn(state, batch, on_phase=mark)
    runs[run] = _read(counters)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for h in hooks:
        h.remove()
    back = {k: c.backwards for k, c in counters.items() if hasattr(c, "backwards")}
    if any(back.values()):
        raise AssertionError(f"{run}: a kernel's backward ran behind the HAN input: {back}")
    if not torch.isfinite(metrics["loss"]) or float(metrics["skipped"]):
        raise AssertionError(f"{run}: loss {float(metrics['loss'])}, "
                             f"skipped {float(metrics['skipped'])}")
    held = {id(p) for p in opt.main_params}
    moved = dead = 0
    for name, p in model.named_parameters():
        if labels[name] == "freeze":
            if not torch.equal(p, before[name]) or id(p) in held or p in opt.main.state:
                raise AssertionError(f"{run}: base leaf {name} moved or took optimizer state")
        elif p.grad is not None and p.grad.any():
            if torch.equal(p, before[name]):
                raise AssertionError(f"{run}: HAN leaf {name} took a gradient and did not move")
            moved += 1
        else:
            dead += 1
    phases = ("start", "forward", "backward", "optimizer")
    ms = [ev[a].elapsed_time(ev[b]) for a, b in zip(phases, phases[1:])]
    _say("han_train", preset="source_net", training_phase=2, batch=TRAIN_BATCH, crop=TRAIN_CROP,
         loss=f"{float(metrics['loss']):.4f}", launches=runs[run], backwards=back,
         base_leaves_bitidentical=sum(v == "freeze" for v in labels.values()),
         han_leaves_moved=moved, han_leaves_zero_gradient=dead,
         step_ms=f"{sum(ms):.2f}", forward_ms=f"{ms[0]:.2f}", backward_ms=f"{ms[1]:.2f}",
         optimizer_ms=f"{ms[2]:.2f}", peak_mem_gib=f"{peak:.2f}",
         note="one step: its first, cuDNN's choices included",
         seconds=f"{time.perf_counter() - t_phase:.1f}")
    del model, opt, state, step_fn
    return runs


def _drive_unet(dev, counters, conv_calls, attn_calls, gdn_calls, shapes):
    """[unet] each of ``UNET_PRESETS`` at full width, its all-zero weights
    woken: the stages at 128×128 against the CPU model (``_small_stages``:
    z3, the hyper's scales and means, slice 0's μ and σ, the synthesis),
    the B = 8 512×768 eval forward with exact launches (its B2, B3/B6 and
    B4 calls recorded for 6-7), finite, ms and peak memory, and
    ``ChannelCoder`` and ``ProgressiveCoder`` raising the JAX package's
    ``ValueError``; [unet_eval] for ``UNET_EVAL``, ``evaluate_image`` at
    B = 1 on 512×768 (launches, finite metrics) and for ``net_unet``
    ``UNET_TUNE_ITERS`` tune steps (launches and backwards, g_a alone
    moved).  [unet_train]: one training step of each of ``UNET_TRAIN``
    (B = 8 crops of 256×256, ``TrainConfig``'s defaults): exact launches
    and backwards, every leaf with a gradient moved (and
    ``net_unet_ha_hs_1``'s unread syntax model bit-identical, with no
    optimizer state), ms by phase, peak memory, its kernel shapes into
    [grad].  Then the train CLI with no ``--preset``, ``UNET_CLI_STEPS``
    steps on seeded PNGs (where PIL imports): the preset it built.
    → {run: launches}."""
    import numpy as np
    import torch

    from lic_tpu_torch.config import EvalConfig, TrainConfig
    from lic_tpu_torch.data import smooth_images
    from lic_tpu_torch.evaluation import content_adaptive_finetune, evaluate_image
    from lic_tpu_torch.layers import window_attn
    from lic_tpu_torch.models import build_model
    from lic_tpu_torch.models.compress import ChannelCoder
    from lic_tpu_torch.models.progressive import ProgressiveCoder
    from lic_tpu_torch.training import create_state, make_optimizer, make_train_step

    x_np = smooth_images(np.random.default_rng(SEED), BATCH, H, W)
    x = torch.from_numpy(x_np).to(dev).contiguous(memory_format=torch.channels_last)
    small = torch.from_numpy(x_np[:1, :, :128, :128].copy())
    mp = BATCH * H * W / 1e6
    runs = {}

    def on_gpu(t):
        return t.to(dev).contiguous(memory_format=torch.channels_last)

    for preset in UNET_PRESETS:
        t_phase = time.perf_counter()
        run = f"unet:{preset}"
        model = build_model(preset, device=dev, seed=SEED)
        cpu = build_model(preset, device="cpu", seed=SEED)
        woken = _wake_zero_leaves(model, cpu)
        err = _small_stages(preset, model, cpu, small, on_gpu)
        del cpu
        hooks = _record_conv_slots(model, conv_calls, run) + _record_gdn(model, gdn_calls, run)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _zero(counters)
        with torch.no_grad():
            out = model(x)
        runs[run] = _read(counters)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for h in hooks:
            h.remove()
        _hooks_agree(run, runs[run], conv_calls, gdn_calls)
        for key, n in window_attn.window_attention.calls.items():
            attn_calls.setdefault(key, {})[run] = n
        if not (torch.isfinite(out.x_tilde).all() and torch.isfinite(out.bpp)):
            raise AssertionError(f"{run}: non-finite forward output")
        if out.x_tilde.shape != (BATCH, 3, H, W):
            raise AssertionError(f"{run}: shape {tuple(out.x_tilde.shape)}")
        with torch.no_grad():
            fwd_ms = _cuda_ms(lambda: model(x), 2)
        for coder in (ChannelCoder, ProgressiveCoder):
            try:
                coder(model, name=preset)
            except ValueError as e:
                if f"hyper path '{model.cfg.hyper}' is not decodable" not in str(e):
                    raise
            else:
                raise AssertionError(f"{run}: {coder.__name__} took a preset it cannot decode")
        _say("unet", preset=preset, hyper=model.cfg.hyper, leaves_woken=woken,
             small_vs_cpu_max_err=f"{max(err.values()):.3g}", launches=runs[run],
             bpp_est=f"{float(out.bpp):.4f}", bpp_z=f"{float(out.bpp_z):.4f}", finite=True,
             forward_ms=f"{fwd_ms:.2f}", forward_mps=f"{mp / fwd_ms * 1e3:.2f}",
             forward_peak_mem_gib=f"{peak:.2f}", coders_refuse=True, batch=BATCH,
             shape=f"{H}x{W}", seconds=f"{time.perf_counter() - t_phase:.1f}",
             weights="UNTRAINED")
        del out
        if preset in UNET_EVAL:
            t_phase = time.perf_counter()
            erun = f"eval:{preset}@{H}x{W}"
            _zero(counters)
            r = evaluate_image(model, x[:1])
            runs[erun] = _read(counters)
            if not all(np.isfinite(r[k]) for k in ("bpp", "psnr", "mse", "msssim")):
                raise AssertionError(f"{erun}: non-finite metrics {r}")
            line = dict(preset=preset, eval_b1_launches=runs[erun],
                        eval_b1_ms=f"{r['seconds'] * 1e3:.2f}", eval_bpp=f"{r['bpp']:.4f}")
            if preset == "net_unet":
                trun = f"tune:{preset}"
                before = {k: v.clone() for k, v in model.state_dict().items()}
                _zero(counters)
                t0 = time.perf_counter()
                tuned = content_adaptive_finetune(model, x[:1], EvalConfig(
                    tune_iters=UNET_TUNE_ITERS, tune_lr_drop_step=UNET_TUNE_ITERS))
                torch.cuda.synchronize()
                tune_s = time.perf_counter() - t0
                runs[trun] = _read(counters)
                back = {k: c.backwards for k, c in counters.items() if hasattr(c, "backwards")}
                want = {k: runs[trun][k] for k in back}
                moved = {k for k, v in tuned.state_dict().items() if not torch.equal(v, before[k])}
                if back != want or not moved or any(not k.startswith("g_a.") for k in moved):
                    raise AssertionError(f"{trun}: backwards {back}, launches {want}, "
                                         f"moved outside g_a: {sorted(moved)[:3]}")
                line.update(tune_steps=UNET_TUNE_ITERS, tune_launches=runs[trun],
                            tune_g_a_leaves_moved=len(moved),
                            tune_ms_per_step=f"{tune_s / UNET_TUNE_ITERS * 1e3:.1f}")
                del tuned
            _say("unet_eval", **line, seconds=f"{time.perf_counter() - t_phase:.1f}")
        del model
        torch.cuda.empty_cache()

    batch = _train_batch(dev)
    kernels = ("gdn", "conv5s2", "convk_s1", "wba", "wba_proj")
    for preset in UNET_TRAIN:
        t_phase = time.perf_counter()
        run = f"train:{preset}"
        model = build_model(preset, device=dev, seed=SEED).train()
        tc = TrainConfig()
        opt = make_optimizer(model, tc, steps_per_epoch=1000)
        state = create_state(model, opt, tc.seed)
        step_fn = make_train_step(model, tc, opt)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        hooks = _record_conv_slots(model, shapes["conv"], run) + _record_train_shapes(model, shapes)
        ev = {}

        def mark(name):
            ev[name] = torch.cuda.Event(enable_timing=True)
            ev[name].record()

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _zero(counters)
        metrics = step_fn(state, batch, on_phase=mark)
        runs[run] = _read(counters)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for h in hooks:
            h.remove()
        back = {k: counters[k].backwards for k in kernels}
        if back != {k: runs[run][k] for k in kernels}:
            raise AssertionError(f"{run}: backwards {back} != launches {runs[run]}")
        if not (torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["aux"])) \
                or float(metrics["skipped"]):
            raise AssertionError(f"{run}: loss {float(metrics['loss'])}, "
                                 f"skipped {float(metrics['skipped'])}")
        unread = set(model.unread_parameters())
        moved = still = 0
        for name, p in model.named_parameters():
            if name in unread:
                if p.grad is not None or not torch.equal(p, before[name]) or p in opt.main.state:
                    raise AssertionError(f"{run}: unread leaf {name} took a gradient or moved")
            elif p.grad is not None and p.grad.any():
                if torch.equal(p, before[name]):
                    raise AssertionError(f"{run}: {name} took a gradient and did not move")
                moved += 1
            else:
                still += 1
        phases = ("start", "forward", "backward", "optimizer")
        first_ms = sum(ev[a].elapsed_time(ev[b]) for a, b in zip(phases, phases[1:]))
        # a second step, timed by phase: the first includes cuDNN's choices
        step_fn(state, batch, on_phase=mark)
        torch.cuda.synchronize()
        ms = [ev[a].elapsed_time(ev[b]) for a, b in zip(phases, phases[1:])]
        _say("unet_train", preset=preset, batch=TRAIN_BATCH, crop=TRAIN_CROP,
             loss=f"{float(metrics['loss']):.4f}", aux=f"{float(metrics['aux']):.4f}",
             launches=runs[run], backwards=back, leaves_moved=moved,
             leaves_zero_gradient=still, unread_leaves_bitidentical=len(unread),
             aux_group=opt.aux is not None, step_ms=f"{sum(ms):.2f}",
             forward_ms=f"{ms[0]:.2f}", backward_ms=f"{ms[1]:.2f}",
             optimizer_ms=f"{ms[2]:.2f}", first_step_ms=f"{first_ms:.2f}",
             peak_mem_gib=f"{peak:.2f}", images_per_s=f"{TRAIN_BATCH / sum(ms) * 1e3:.1f}",
             seconds=f"{time.perf_counter() - t_phase:.1f}")
        del model, opt, state, step_fn
        torch.cuda.empty_cache()
    _train_cli_default(dev)
    return runs


def _drive_rbs_nolrp(dev, counters, conv_calls, attn_calls, gdn_calls, shapes):
    """[rbs] and [nolrp]: ``_drive`` on ``net_ga`` with ``transform="rbs"``
    and on ``source_net`` with ``lrp=False``; [rbs_train] one training step
    of the rbs config (B = 8 crops of 256×256, ``TrainConfig``'s
    defaults): exact launches and backwards, every leaf with a gradient
    moved, ms by phase, its kernel shapes into [grad], and B6 at the
    ResidualBlockUpsample's 256×384 shape at B = 1 into [grad] as well.
    → {run: launches}."""
    import torch

    from lic_tpu_torch.config import TrainConfig
    from lic_tpu_torch.models import build_model
    from lic_tpu_torch.training import create_state, make_optimizer, make_train_step

    runs = {}
    for preset, run, over in (("net_ga", "rbs:net_ga", dict(transform="rbs")),
                              ("source_net", "nolrp:source_net", dict(lrp=False))):
        t0 = time.perf_counter()
        r, t, _ = _drive(preset, dev, counters, conv_calls, attn_calls, gdn_calls, shapes,
                         run=run, **over)
        runs.update(r)
        _say(run.split(":")[0], preset=preset, **over, launches=r[run],
             seconds=f"{time.perf_counter() - t0:.1f}",
             **{k: f"{v:.4f}" for k, v in t.items()})
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    run = "train:rbs"
    model = build_model("net_ga", device=dev, seed=SEED, transform="rbs").train()
    _wake_zero_leaves(model)
    tc = TrainConfig()
    opt = make_optimizer(model, tc, steps_per_epoch=1000)
    state = create_state(model, opt, tc.seed)
    step_fn = make_train_step(model, tc, opt)
    batch = _train_batch(dev)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    hooks = _record_conv_slots(model, shapes["conv"], run) + _record_train_shapes(model, shapes)
    ev = {}

    def mark(name):
        ev[name] = torch.cuda.Event(enable_timing=True)
        ev[name].record()

    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    metrics = step_fn(state, batch, on_phase=mark)
    runs[run] = _read(counters)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for h in hooks:
        h.remove()
    kernels = ("gdn", "conv5s2", "convk_s1", "wba", "wba_proj")
    back = {k: counters[k].backwards for k in kernels}
    if back != {k: runs[run][k] for k in kernels}:
        raise AssertionError(f"{run}: backwards {back} != launches {runs[run]}")
    if not torch.isfinite(metrics["loss"]) or float(metrics["skipped"]):
        raise AssertionError(f"{run}: loss {float(metrics['loss'])}, "
                             f"skipped {float(metrics['skipped'])}")
    moved = 0
    for name, p in model.named_parameters():
        if p.grad is not None and p.grad.any():
            if torch.equal(p, before[name]):
                raise AssertionError(f"{run}: {name} took a gradient and did not move")
            moved += 1
    phases = ("start", "forward", "backward", "optimizer")
    first_ms = sum(ev[a].elapsed_time(ev[b]) for a, b in zip(phases, phases[1:]))
    # a second step, timed by phase: the first includes cuDNN's choices
    step_fn(state, batch, on_phase=mark)
    torch.cuda.synchronize()
    ms = [ev[a].elapsed_time(ev[b]) for a, b in zip(phases, phases[1:])]
    # the ResidualBlockUpsample's 3x3 at its 256x384 eval shape, under autograd
    shapes["conv"].setdefault(("convk_s1", (1, 192, H // 2, W // 2), (192, 192, 3, 3), True,
                               None, False), {})["rbs:net_ga@B=1"] = 1
    _say("rbs_train", batch=TRAIN_BATCH, crop=TRAIN_CROP, loss=f"{float(metrics['loss']):.4f}",
         launches=runs[run], backwards=back, leaves_moved=moved,
         step_ms=f"{sum(ms):.2f}", forward_ms=f"{ms[0]:.2f}", backward_ms=f"{ms[1]:.2f}",
         optimizer_ms=f"{ms[2]:.2f}", first_step_ms=f"{first_ms:.2f}",
         peak_mem_gib=f"{peak:.2f}", images_per_s=f"{TRAIN_BATCH / sum(ms) * 1e3:.1f}",
         seconds=f"{time.perf_counter() - t0:.1f}")
    return runs


def _dormant(dev, counters):
    """[dormant] each module of ``layers/{misc,vit,haar}.py``, ``GDN1``,
    ``apply_init_scheme`` and the ERF of ``utils/analyze.py``: the card's
    output against the CPU module's on the same weights and input, within
    1e-4 of the CPU output's largest magnitude (Haar bit-exact), with every
    kernel's launches counted over the card's calls.  → {"dormant":
    launches}."""
    import copy

    import torch

    from lic_tpu_torch.layers import GDN1, haar, misc, vit
    from lic_tpu_torch.layers.conv import Conv2d
    from lic_tpu_torch.utils import analyze
    from lic_tpu_torch.utils.init import apply_init_scheme

    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(SEED + 21)

    def gen(i):
        return torch.Generator().manual_seed(SEED + i)

    def img(*shape):
        return torch.randn(*shape, generator=g).clamp(-2, 2)

    x192 = img(2, 192, 16, 24)
    cases = [
        ("GDN1", GDN1(192), x192),
        ("GDN1_inverse", GDN1(192, inverse=True), x192),
        ("vit_latent_syntax", vit.vit_latent_syntax(16, generator=gen(1)), img(2, 3, 16, 16)),
        ("vit_base_patch16_224", vit.vit_base_patch16_224(generator=gen(2)), img(1, 3, 224, 224)),
        ("MaskedConv2d_A", misc.MaskedConv2d(192, 192, 5, "A", generator=gen(3)), x192),
        ("MaskedConv2d_B", misc.MaskedConv2d(192, 192, 5, "B", generator=gen(4)), x192),
        ("GSDN", misc.GSDN(192), x192),
        ("GSDN_inverse", misc.GSDN(192, inverse=True), x192),
        ("LinearAttention", misc.LinearAttention(192, generator=gen(5)), x192),
        ("SpatialSelfAttention", misc.SpatialSelfAttention(192, generator=gen(6)), x192),
        ("BlockTrain", misc.BlockTrain(192, 192, 16 * 24, embed_dim=192, num_heads=12,
                                       generator=gen(7)), x192),
        ("UnetHaHs", misc.UnetHaHs(generator=gen(8)), x192),
    ]
    ha, hs = misc.UnetHa(generator=gen(9)), misc.UnetHs(generator=gen(10))
    _wake_zero_leaves(ha, hs, *[m for _, m, _ in cases])
    errs = {}
    _zero(counters)

    def close(name, got, want):
        if got.dtype == torch.bool:
            return
        err = float((got.cpu() - want).abs().max())
        errs[name] = err / max(float(want.abs().max()), 1e-30)
        if errs[name] > RECON_TOL:
            raise AssertionError(f"dormant {name}: card off its CPU run by {errs[name]:.3g}")

    with torch.no_grad():
        for name, m, x in cases:
            card = copy.deepcopy(m).to(dev)
            close(name, card(x.to(dev)), m.eval()(x))
        z_cpu = ha(x192)
        z_card = copy.deepcopy(ha).to(dev)(x192.to(dev))
        for t, c, name in zip(z_card, z_cpu, ("UnetHa_z", "UnetHa_middle", "UnetHa_skip1",
                                               "UnetHa_inp")):
            close(name, t, c)
        close("UnetHs", copy.deepcopy(hs).to(dev)(*[c.to(dev) for c in z_cpu]), hs(*z_cpu))
        xi = img(2, 3, 64, 96)
        y = haar.haar_dwt2(xi.to(dev))
        if not torch.equal(y.cpu(), haar.haar_dwt2(xi)) or not torch.equal(
                haar.haar_idwt2(y).cpu(), haar.haar_idwt2(haar.haar_dwt2(xi))):
            raise AssertionError("dormant haar: the card's transform is not the CPU's")
        for a, b in zip(haar.haar_pyramid(xi.to(dev), 3), haar.haar_pyramid(xi, 3)):
            if not torch.equal(a.cpu(), b):
                raise AssertionError("dormant haar_pyramid: the card's is not the CPU's")
    net = torch.nn.Module()
    net.c0 = Conv2d(3, 192, 5, 2, (1, 2, 1, 2), generator=gen(11))
    net.c1 = Conv2d(192, 192, 3, 1, 1, generator=gen(12))
    for scheme in ("xavier_uniform", "lecun", "vit2"):
        a = apply_init_scheme(copy.deepcopy(net).to(dev), scheme, gen(13))
        b = apply_init_scheme(copy.deepcopy(net), scheme, gen(13))
        if not all(torch.equal(p.cpu(), q) for p, q in zip(a.parameters(), b.parameters())):
            raise AssertionError(f"dormant apply_init_scheme {scheme}: card's draw differs")
    fn = lambda v: net.c1(torch.nn.functional.gelu(net.c0(v)))
    erf_cpu = analyze.effective_receptive_field(fn, xi)
    net.to(dev, memory_format=torch.channels_last)
    erf_card = analyze.effective_receptive_field(
        fn, xi.to(dev).contiguous(memory_format=torch.channels_last))
    close("effective_receptive_field", torch.from_numpy(erf_card), torch.from_numpy(erf_cpu))
    runs = {"dormant": _read(counters)}
    _say("dormant", modules=len(errs) + 1, launches=runs["dormant"],
         worst=max(errs, key=errs.get), worst_share_of_range=f"{max(errs.values()):.3g}",
         haar_bitexact=True, init_draws_equal=True, seconds=f"{time.perf_counter() - t0:.1f}")
    return runs


def _resume(dev, counters):
    """[resume] ``source_net`` at full width, B = 2 crops of 256×256:
    three training steps straight; then a fresh model, two steps,
    ``CheckpointManager.save``, another fresh model, optimizer and state
    restored from the file, and a third step: every parameter, both Adam
    moments and the counts bit-identical to the straight run's.  → {"resume":
    launches} over the six steps."""
    import shutil

    import torch

    from lic_tpu_torch.config import TrainConfig
    from lic_tpu_torch.models import build_model
    from lic_tpu_torch.training import create_state, make_optimizer, make_train_step
    from lic_tpu_torch.utils.checkpoint import CheckpointManager

    t0 = time.perf_counter()
    tc = TrainConfig()
    batches = [_train_batch(dev)[2 * i : 2 * i + 2] for i in range(3)]
    root = os.path.join(ROOT, "build", "smoke_resume")
    shutil.rmtree(root, ignore_errors=True)

    def fresh():
        model = build_model("source_net", device=dev, seed=SEED).train()
        opt = make_optimizer(model, tc, steps_per_epoch=1000)
        return model, opt, create_state(model, opt, tc.seed), make_train_step(model, tc, opt)

    _zero(counters)
    model_a, opt_a, state_a, step_a = fresh()
    for b in batches:
        step_a(state_a, b)
    model_b, _, state_b, step_b = fresh()
    for b in batches[:2]:
        step_b(state_b, b)
    CheckpointManager(root).save(state_b, 2)
    model_c, opt_c, state_c, step_c = fresh()
    CheckpointManager(root).restore(state_c, 2)
    step_c(state_c, batches[2])
    runs = {"resume": _read(counters)}
    shutil.rmtree(root, ignore_errors=True)
    pa, pc = dict(model_a.named_parameters()), dict(model_c.named_parameters())
    same = [n for n in pa if torch.equal(pa[n], pc[n])]
    moments = all(torch.equal(opt_a.main.state[p][m], opt_c.main.state[q][m])
                  for p, q in zip(opt_a.main_params, opt_c.main_params) for m in ("mu", "nu"))
    if len(same) != len(pa) or not moments or (opt_a.count, opt_c.count, state_c.step) != (3, 3, 3):
        raise AssertionError(f"resume: {len(pa) - len(same)} parameters differ from the straight "
                             f"run (moments equal: {moments}, counts {opt_c.count}/{opt_a.count})")
    _say("resume", steps=3, resumed_at=2, parameters_bitidentical=len(same),
         moments_bitidentical=moments, launches=runs["resume"],
         seconds=f"{time.perf_counter() - t0:.1f}")
    return runs


def _train_cli_default(dev):
    """Where PIL imports: ``cli.train.main`` with no ``--preset`` for
    ``UNET_CLI_STEPS`` steps (B = 2 crops of 256×256) on seeded 512×768
    PNGs under ``build/smoke_cli_unet``; its ``final.npz`` loads strictly
    into ``build_model("net_unet_ha_hs")``, the preset it built."""
    try:
        from PIL import Image
    except ImportError:
        _say("unet_cli", pil="absent")
        return
    import contextlib
    import io
    import shutil

    import numpy as np

    from lic_tpu_torch.cli import train as cli_train
    from lic_tpu_torch.data import smooth_images
    from lic_tpu_torch.models import build_model
    from lic_tpu_torch.utils.checkpoint import load_params

    t0 = time.perf_counter()
    root = os.path.join(ROOT, "build", "smoke_cli_unet")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "png"))
    for i, img in enumerate(smooth_images(np.random.default_rng(SEED + 15), 2, H, W)):
        Image.fromarray(np.clip((img.transpose(1, 2, 0) + 1) * 127.5 + 0.5, 0, 255)
                        .astype(np.uint8)).save(os.path.join(root, "png", f"{i}.png"))
    args = ["--train_data_path", os.path.join(root, "png"), "--batch_size", "2",
            "--crop_size", str(TRAIN_CROP), "--epochs", "1",
            "--steps_per_epoch", str(UNET_CLI_STEPS), "--checkpoint_dir",
            os.path.join(root, "ck"), "--device", dev.type]
    preset = cli_train.build_parser().parse_args(args).preset
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli_train.main(args)
    epoch = [l for l in out.getvalue().splitlines() if l.startswith("[Epoch")]
    load_params(os.path.join(root, "ck", "final.npz"), build_model(preset, device=dev, seed=1))
    if preset != "net_unet_ha_hs" or len(epoch) != 1:
        raise AssertionError(f"unet_cli: built {preset}, epoch lines {epoch}")
    shutil.rmtree(root, ignore_errors=True)
    _say("unet_cli", preset_built=preset, steps=UNET_CLI_STEPS, epoch_line=repr(epoch[0]),
         final_npz_loads_strictly=True, seconds=f"{time.perf_counter() - t0:.1f}")


if __name__ == "__main__":
    sys.exit(main())
