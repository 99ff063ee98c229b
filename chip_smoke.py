"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--phases a,b,...]

Phases, each printing one JSON line:

1. build       -- compile K1 (csrc/fused_retrieval.cu), K2
                  (csrc/quant_candidates.cu) and P1 (csrc/fused_ablation.cu)
                  with nvcc, all three at once; the card's name and power
                  limit from nvidia-smi.
2. kernels     -- K1 in both forms against its plain PyTorch version on
                  the card (D = 1024, k = 10, N in {100000, 100003}, Q in
                  {1, 32, 512}, both metrics, ranks on and off; at N =
                  100,003 also Q in {76, 1024} with ranks, the query
                  chunks of inference_k1; a case with
                  duplicated gallery rows, a row copied to every offset mod
                  128 of a tile with queries at every offset of their tile;
                  the bf16 form with the gallery passed as float32 and as
                  bf16, its values held to the sum-order bound), and both
                  forms' times beside their bounds and library calls at
                  Q in {1, 4, 32, 512}.
3. kernels_k2  -- K2 against its plain version on the card, scores and
                  indices bit-identical (D = 1024, N in {1000000,
                  1000003}, Q in {1, 32, 512}, both metrics, r in {40,
                  128}, and r in {256, 512, 1024} at Q in {1, 32};
                  duplicated gallery rows that straddle the r-th candidate
                  at r = 40, 128 and 1024, 2,000 equal rows at consecutive
                  indices at r = 40 and 1024, a gallery in the selection's
                  worst order), K2 and the exact rerank on
                  float32 and bf16 rows against the plain int8 route, K2's
                  times at the serving shape, at r in {256, 512, 1024} and
                  on the worst order, the int8 route whole (K2's and the
                  plain scan's) at the same r and Q in {1, 32}, and the
                  engine's two int8 routes timed at 10,000 to 1,000,000
                  rows.
4. kernels_int8_wide -- the plain int8 scan at D = 2,048 (past the
                  1,040 columns a float32 sum of int8 products holds
                  exactly) against the int32 product and the scan on the
                  CPU, bit-identical, with TF32 off and on.
5. probe_k1    -- P1's three levels against their plain version (N =
                  102,400, Q in {32, 512}, a d2pos with hits), then P1's
                  levels and K1 in both forms on the probe's own inputs at
                  its two shapes, the serving shape (Q = 32, N = 100,352)
                  and an offline shape (Q = 512, N = 999,424), against
                  their plain versions (P1's plain level 2 timed there); then K1's ablation probe
                  (``scripts/probe_fused_overhead.py``: P1's levels, K1 in
                  both forms, the chunked plain route) at those shapes, 3
                  rounds each, each time beside its bound.
6. encoder     -- the full-width ModifiedResNet50 forward, bf16, batch 32
                  at 224 px: finite outputs, cosine similarity to float32
                  (TF32 off), images/s. Then a copy with its BN statistics
                  calibrated to the batch (one float32 train-mode pass at
                  momentum 1, so eval mode normalizes as a trained net
                  does): its bf16 output's relative L2 distance and
                  minimum cosine to a float64 forward, beside the same for
                  the old fold of BN's scale and shift into bf16 (computed
                  here as a yardstick); the port's cosine held to
                  ``ENCODER_CAL_COS_FLOOR``, and both its readings to
                  the fold's.
7. serve       -- the serving path at full width: a 100,000 x 1024 feature
                  cache with 8 planted rows, ``cli/serve.py::build_engine``
                  on the card, warmup, then /healthz, 20 rounds of 8
                  concurrent /search and one /search_batch of 8 over HTTP
                  (then one dispatch under torch.profiler, outside the
                  counted run). Each top-1 must be its planted row; K1 must
                  have been launched once a dispatch and never fallen back.
                  Then ``serve_sharded``: the same cache served by an
                  engine over 4 shards of the one card
                  (``build_engine(args, mesh=...)``), the same counted run,
                  K1 launched once a dispatch for the card's 4 shards, the
                  cross-shard merge never.
8. serve_quant -- the same with ``--quantize`` over a 1,000,000 x 1024
                  cache (500,000 rows only where the temporary directory
                  cannot hold the larger one): the
                  engine must take the K2 route, K2 must have been launched
                  and never fallen back; then ``serve_quant_sharded`` over
                  4 shards, K2 and the cross-shard merge launched once a
                  dispatch.
9. ivf         -- the IVF and IVF-PQ library (ops/ivf.py, ops/pq.py; plain
                  PyTorch, no kernel of the port) at D = 1024 on the
                  JAX probe's clustered geometry (sqrt(N) blob centres
                  4 N(0, 1), rows a centre plus 0.5 N(0, 1), numpy-seeded):
                  at 100,000 rows ivf_search at nprobe == nlist against
                  ops/distance.retrieve, both metrics; at 1,000,000 rows
                  build_ivf's time and stats, recall@10 of 1,024 perturbed
                  held-out rows at nprobe 1..64, the engine's auto nprobe
                  (tune_nprobe, margin 2, on its proxy: recall >= 0.95),
                  search times at B in {1, 8, 32} beside K1's float32 form
                  over the same rows; IVF-PQ (m = 64): build, train and
                  encode times, recall@10 at rerank factors 4, 16, 64 on
                  bf16 rows and pure, pure self-retrieval of 256 rows,
                  OPQ's rotation orthogonal to 1e-4, search times; the
                  saved files loaded back answering bit for bit; at
                  20,000 rows IVF-PQ at full probe with a covering rerank
                  against retrieve. Full probes are held to the exact
                  route's indices but for near-ties within the expanded
                  form's float32 reach (their count is printed). Each
                  neighbour the probe misses at nprobe >= 4 is recomputed
                  in float64 beside the exact route's 10th: within that
                  reach a near-tie, outside it in a probed cluster a fault
                  of ops/ivf.py (none allowed), outside it in an unprobed
                  cluster the probe's approximation (counts printed).
10. serve_ivf  -- serve_ivf and serve_ivf_pq: the serving path as in
                  ``serve`` over 1,000,000 clustered rows with the 8
                  planted rows, ``--ivf_nlist 0 --ivf_nprobe 0``, then
                  ``--pq_m 64`` started twice with ``--index_cache`` (the
                  second start loads the first's files); no kernel may
                  launch; the startup split into build, tune and the PQ
                  steps.
11. online_ivf -- OnlineIVF at a capacity of 100,000 rows: adds that fill
                  a cluster into the spill and force a repack, then
                  removals, while a second thread searches (live rows of
                  the state it took, no error); after each step a full
                  probe against the masked exact route.
12. inference   -- the offline evaluation end to end: a synthetic Sketchy
                  corpus (25 classes x 110 photos x 4 sketches, about
                  1,100 test queries), a run folder and the full-width
                  encoder's seed-0 weights as ``models/<run>.pt``, then
                  ``cli/inference.py`` on the card (``evaluate_folder`` and
                  the JSON alone where matplotlib is missing): the
                  reference keys, the deduplicated gallery's size, a finite
                  MRR, a non-decreasing topk_acc, each dict's scores
                  recomputed here from its ranks, and the dict against
                  ``evaluate_retrieval`` on the CPU over the same features
                  (ranks within the two float32 distance matrices'
                  measured difference, every key within what that rank
                  tolerance lets it move). Then ``cli/serve.py --folder``
                  without ``--features``: the same gallery paths and rows,
                  8 sketches searched. Prints the decode backend, the
                  gallery embedding's images/s and the wall time split
                  into decode, embed and rank (``run_inference``'s trace).
13. inference_k1 -- ``run_inference`` over a 100,003-row feature cache (the
                  corpus's test photos and random rows), both metrics: K1
                  launched once per 1,024-query chunk with ranks, never
                  falling back; against the same call with the threshold
                  raised above N (the exact route): every query's top-k
                  values at rtol 1e-5 with an 8-ulp floor and its index
                  set exact but for near-ties at the k-th place, then the
                  ranks within the columns near the positive's distance
                  (the probe's rank reach) and the dicts within what that
                  lets each key move; rank moves past the kernels phase's
                  tolerance of 2 are listed. Then ``evaluate_retrieval``
                  whole on both routes at N from 10,000 to 10^6 with Q =
                  1,024, and K1 at Q = 1,024 with ranks beside its bound,
                  its plain version and the library composition.
14. sharded    -- the row-sharded gallery on 4 shards of the one card.
                  First (its own ``sharded_ivf`` line) ShardedIVF,
                  ShardedOnlineIVF (adds into shards that start empty,
                  removals) and sharded IVF-PQ at full probe against
                  their single-device forms at 100,000 rows (the PQ at
                  20,000), then ``serve_ivf_sharded``: ``serve`` over the
                  4 shards with ``--ivf_nlist 0`` at 100,000 clustered
                  rows. Sharded K1 at N = 100,000 (rows 0-15 copied into every
                  other shard, positives in every shard and at its edges),
                  Q in {1, 32, 1024}, both forms, both metrics, ranks on
                  and off: bit for bit unsharded K1, and against its
                  sharded plain version as ``kernels`` holds K1; the
                  copies tie in index order. Then sharded K1 timed beside
                  unsharded K1, its plain version and the library call at
                  Q = 32 and Q = 1,024 with ranks, each call's launches and
                  profiled device time beside the unsharded call's (one
                  launch of each kernel). K1's cross-shard merge kernel
                  bit for bit its plain version on runs with ties within
                  and across shards and unfilled slots, timed. The sharded
                  int8 route at N = 10^6, Q = 32, r = 40 a shard, both
                  metrics: K2 once for the 4 shards (bit for bit its plain
                  version) and one merge, bit for bit its per-shard plain
                  route, timed beside the whole route's library call.
                  ``run_inference`` over the mesh at 100,004 rows: K1 and
                  its positive kernel once a query chunk, the unsharded
                  run's queries, ranks, top-k and dict exactly; at 100,003
                  rows the unsharded route; ``cli/inference.py
                  --n_devices`` past the cards present exits. One engine
                  dispatch of 8 sketches, unsharded and over the 4 shards,
                  timed in 10 alternating pairs without HTTP.
15. train      -- the training path at full width (ModifiedResNet50 with
                  a 125-class head, SketchyV2 labels, so the head's loss is
                  on). One float32 step (TF32 off) of a uint8 triplet batch
                  of 4 on the card and on the CPU, each held against a
                  float64 step on the CPU: the card no farther from it
                  than twice the CPU plus rtol 1e-5 (the loss, each
                  running statistic) or 1e-4 (each gradient's norm; a
                  symmetry's zero as noise on both sides); then Adam from
                  the CPU's gradients on both at rtol 1e-6. ``cli/train.py`` for one
                  bf16 epoch of batches of 32 on a learnable synthetic
                  Sketchy corpus (25 classes x 4 photos x 4 sketches at
                  128 px) with ``--inference``: the four JSONs, finite
                  losses, ``models/<run>.pt``; then ``cli/inference.py
                  --bn_recalibrate per_modality`` and ``serve --folder`` on
                  the trained run, 8 /search requests over HTTP. Five bf16
                  steps on one batch at lr 1e-4 lower the loss. The bf16
                  step at B = 32: median time (CUDA events), images/s,
                  peak memory, the device's busy share over 5 profiled
                  steps, the FLOPs of its convolutions and linear layers
                  (forward x 3 for the backward, x 3 modalities) and their
                  time at the bf16 peak; then 6 steps fed by
                  ``TripletLoader`` as the CLI feeds them: the host's wait
                  on the loader. The training path launches no kernel of
                  the port.
16. train_dp   -- data-parallel training, two ranks on the one card over
                  gloo (scripts/probe_dp_cards.py), held against one
                  process: the flagship's triplet step (B = 32, 16 a
                  rank, float32, TF32 off, augmentation on, two Adam
                  steps at lr 1e-5, every run taking the second from the
                  float64 run's state: losses, the first step's gradient
                  and update within twice the one process's
                  distance from float64 plus rtol 1e-5 and 1e-4 (the
                  losses' distance the widest of the one process's
                  float32 runs in three row orders);
                  augmented rows, running statistics and reduced
                  gradients equal on both ranks),
                  the pix2pix U-Net with dropout (batch 6) and the
                  full-width VAE (batch 64) at rel 1e-5, pix2pix's
                  state within twice the one process's distance from
                  float64 plus 1e-4 (relative L2 of the flat state;
                  cuDNN's deterministic algorithms); the bf16 step at
                  one process (B = 32) and two ranks with the all-reduces
                  a step; cli/train.py on two ranks against one (float32
                  at lr 0, 3 of the train corpus's 25 classes at 128 px): losses
                  at rtol 2e-3, topk_acc equal, MRR at rtol 1e-6.
17. train_tp   -- tensor-parallel training, a 1 data x 2 model grid on
                  the one card over gloo (scripts/probe_tp_cards.py),
                  held against one process at full width with the batch
                  cut to 8 (the triplet, the VAE; the U-Net keeps 6):
                  the flagship's triplet step (float32, TF32 off,
                  augmentation on, one Adam step), two steps each of the
                  pix2pix U-Net with dropout and the VAE: every loss and
                  the triplet's gradient within twice the one process's
                  distance from float64 plus rtol 1e-5 and 1e-4 (the
                  triplet losses' distance the widest of three row
                  orders); rows
                  equal to the one process's, gathered statistics,
                  parameters and pix2pix state equal on both ranks; each
                  rank's bytes of parameters, Adam state and buffers
                  beside one process's; float32 triplet steps timed with
                  their collectives (count, bytes) and the collectives'
                  share; cli/train.py --tp_devices 2 against one process
                  (float32 at lr 0, 128 px, 32 triplets in batches of
                  16) by JAX's CLI rule.
18. drawings   -- the informative-drawings generator at full width (256
                  px, batch 16) from seed-0 weights written as a
                  reference .pth and loaded by cli/drawings.py's loader:
                  float32 (TF32 off) on the card against float64 on the
                  card, the CPU's float32 distance beside it (the card
                  within twice the CPU's plus rtol 1e-5); --bf16 against
                  float32 in uint8 levels (a mean under 6 an image, JAX's
                  bound); a batch's time in both (CUDA events), images/s
                  and the share of each peak from the FLOPs of its convs;
                  cli/drawings.py's main over a synthetic Kaggle corpus
                  (320 photos at 256 px): wall time, images/s, the
                  decode / forward / write split, every PNG within one
                  level of the in-process forward, KaggleCatalogV1
                  finding a contour drawing for every photo; then
                  --corpus sketchy over a small Sketchy corpus.
19. artwork_gen -- AdaIN at 256 px from seed-0 weights written as
                  vgg_normalised.pth and decoder.pth: float32 on the card
                  against float64 (the CPU's beside it, as above) at
                  alpha 1.0 and 0.5, a batch of 8 timed, then
                  cli/artwork_gen.py's main over 64 content and 16 style
                  JPEGs: the style pairing of random.Random(seed), one
                  256 px JPEG a content image, images/s.
20. dilate     -- cli/transformations.py -m dilate on the card over PNGs
                  of six sizes (9 x 13 to 1024 x 767): each output equal
                  bit for bit to dilate_binarize on the CPU.
21. pix2pix    -- pix2pix at full width (256 px, ngf = ndf = 64, the basic
                  PatchGAN, batch norm, vanilla): the float32 G+D step
                  (resnet_9blocks, dropout off, batch 2) on the card and
                  on the CPU against float64 on the card (losses and
                  running statistics within twice the CPU's distance plus
                  rtol 1e-5, parameters plus 1e-4); the warm-up step (G's
                  parameters put, its statistics moved); both generators'
                  steps at batch 6 in float32 and bf16 (bf16 losses and
                  samples within JAX's bounds of float32), timed with
                  their share of peak, busy share and kernel split; then
                  cli/pix2pix.py --mode generate over 160 synthetic
                  Sketchy photos (every PNG within one level of the
                  in-process forward) and --mode train for two epochs
                  (the JSONs, the warm-up's zero G losses, the sample
                  sheet; the U-Net's --continue_train bit for bit the
                  uninterrupted run under deterministic cuDNN).
22. photo2sketch -- the Photo2Sketch VAE at full width (VGG16 at 256 px,
                  z_size 128, dec_rnn_size 512, 20 mixtures, 100 stroke
                  rows: 101 decoder steps; seed-0 weights, the encoder's
                  convs He-initialized): the float32 step (batch 2, eps
                  fed) on the card and on the CPU against float64 on the
                  card (losses within twice the CPU's distance plus rtol
                  1e-5, each gradient before the clip plus 1e-4), then
                  Adam from the CPU's gradients on both at rtol 1e-6;
                  float32 and bf16-encoder steps at batch 64 (bf16 losses
                  within JAX's bounds of float32) timed with their share
                  of peak from VGG's FLOPs, busy time and kernel split of
                  one step, VGG's device time alone and peak memory;
                  greedy generate of 101 steps against the CPU's (pen
                  states equal, or the first fork and its margin) and
                  timed at batch 4 and 64;
                  cli/photo2sketch.py for one epoch at batch 64 with
                  --img_format svg, then jpg, over a synthetic Sketchy
                  corpus with SVGs (20 classes x 8 photos x 2 sketches),
                  then --setup Quickdraw over six synthetic archives (the
                  JSONs, finite losses, models/<run>.pt, the sample SVGs,
                  JSONs and sheet; --model from the saved .pt bit for bit;
                  the wall split into catalog parse, batch build, steps
                  and samples); the rasterizer at batch 64 on the corpus's
                  sketches (stroke-5, stroke-3, the cached points) equal
                  bit for bit to the native C++ rasterizer and the CPU,
                  timed on the card and the host.
23. goldens    -- ``cli/goldens.py`` on the card: the ``ci`` preset (the
                  whole RN50 at 64 px, 12 photos) in bf16 and in float32
                  (``--no-bf16``), each against the port's CPU golden of
                  its precision (the 4-JSON contract, the gallery and
                  query counts, finite losses, a monotone topk_acc, an
                  MRR in (0, 1]; bf16's test loss and float32's two
                  losses within twice the CPU's spread across thread
                  counts), then ``gan_ci`` and ``vae_ci``
                  (finite float32 loss series within rel 0.1 of the CPU
                  goldens: pix2pix's dropout masks come from the device's
                  generator); then ``scripts/probe_ivf.py``'s ``run`` at
                  100,000 clustered rows, one round, B in {1, 8}: K1's
                  float32 form (with and without the norms given) equal
                  to the exact route's top-10 on the near-row queries but
                  for near-ties within float32's reach; the int8 route
                  (K2 at r = 40 and the exact rerank) equal to the plain
                  int8 route bit for bit, each exact neighbour it lacks
                  outside the int8 scan's top 40 (counted); IVF recall@10
                  at nprobe 4, 8 and 16 printed.
24. inventory  -- the flagship encoder's seed-0 fresh init (224 px, 125
                  classes), drawn on the host by ``create_encoder``,
                  held to the digest of JAX's own init
                  (``goldens/torch_jax_init_seed0.json``: each drawn
                  value within 4 float32 ulp, constants equal), with
                  the draw's host seconds; the last modules at full
                  width: InceptionV3 (seed-0 init, its BatchNorm
                  statistics set from one train-mode
                  pass) at 299 px, batch 8, in eval mode in both
                  ``every_feat`` modes, float32 (TF32 off) held to a
                  float64 run on the card within twice the CPU's distance
                  plus rtol 1e-5; one train-mode forward's aux logits (8,
                  classes) and running statistics under the same rule;
                  ``ResidualAttentionBlock`` at CLIP's text width (512,
                  8 heads, 77 tokens, causal mask, batch 8) under the
                  same rule, and a float16 input (``LayerNormFp32``
                  returns float16); ``clip_preprocess`` of 8 uint8 images
                  at 375 x 500 to 224 in both crop modes against the CPU
                  (a pixel may move by one uint8 level where the two
                  float32 sums straddle a rounding edge, counted);
                  ``gram_matrix`` on a VGG relu4 map (8 x 512 x 32 x 32)
                  under the float64 rule. Under 20 s.

Every kernel count is set to 0 just before each counted run (each serve
phase's requests, the probe's runs, each ``inference`` and
``inference_k1`` evaluation) and read just after it; the launch counts in
the kernels line are the sums over those runs: K1's float32 form's from
``serve``, ``inference_k1`` and ``sharded``'s unsharded run at 100,003
rows (``inference`` ranks its small gallery on the exact route), K2's
from ``serve_quant``, K1's bf16 form's and P1's from the probe, the
sharded K1's from ``serve_sharded`` and ``sharded``'s ``run_inference``
over the mesh, the sharded K2's and the cross-shard merge's from
``serve_quant_sharded``, and K1's
and K2's from ``goldens``' run of the IVF probe; the IVF
serve runs, train_dp, train_tp, the generator phases, pix2pix,
photo2sketch and inventory launch none. Any
failed check exits non-zero. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import importlib.util
import itertools
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12  # float32 outside the tensor cores
H100_INT8_OP_PER_S = 1979e12  # int8 tensor cores, dense
H100_BF16_FLOP_PER_S = 989e12  # bf16 tensor cores, dense
D, K = 1024, 10
SERVE_N = 100_000
QUANT_N = 1_000_000  # the int8 route's serving gallery
R = 40  # K2's candidates at the serving engine's k_max 10, rerank_factor 4
R_WIDE = (256, 512, 1024)  # K2's budgets past the JAX engine's 128
PROBE_SHAPES = ((32, 100_352), (512, 999_424))  # (Q, N) of the K1 probe
EVAL_CHUNKS = (76, 1024)  # inference_k1's query chunks: partial, full
SHARDS = 4  # logical shards of the one card in the sharded runs
ROOT = Path(__file__).resolve().parent  # the checkout


def bound(nbytes: float, ops: float, op_rate: float):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / op_rate
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k1_library(q, g, qq, gg, pos2d, with_ranks: bool):
    """One library composition of K1's function: ``torch.cdist`` (float32
    operands) or a bf16 ``torch.matmul`` with the norm arithmetic (bf16
    operands; its bf16 output rounds the cross term, so it is a yardstick
    of speed, not the same function), then ``torch.topk`` and, with ranks,
    the rank count (columns strictly closer than the positive)."""
    import torch

    if q.dtype == torch.bfloat16:
        d = qq + gg - 2.0 * torch.matmul(q, g.T).float()
    else:
        d = torch.cdist(q, g)
    out = torch.topk(d, K, largest=False)
    if with_ranks:
        dpos = torch.gather(d, 1, pos2d.long())
        return out, torch.sum(d < dpos, dim=1)
    return out


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
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


def device_ms(fn, reps: int = 10) -> float:
    """Mean device time of the kernels that ``fn`` launches
    (torch.profiler), without the host work between them, which
    ``time_ms`` also sees where the host, not the device, sets the pace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA) / 1e3 / reps


# ------------------------------------------------------------------ build

def phase_build(state) -> None:
    from concurrent.futures import ThreadPoolExecutor

    from art_sbir_tpu_torch.ops import fused_ablation as fa
    from art_sbir_tpu_torch.ops import quant_fused as qf
    from art_sbir_tpu_torch.ops import retrieval_fused as rf

    def timed_build(module):
        t = time.perf_counter()
        lib = module.KERNEL.build()
        return lib, time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:  # one nvcc per source, together
        built = list(pool.map(timed_build, (rf, qf, fa)))
    secs = time.perf_counter() - t0
    libs = [lib for lib, _ in built]
    ptxas = {lib.name: [ln.strip() for ln in lib.with_suffix(".log")
                        .read_text().splitlines()
                        if "registers" in ln or "spill" in ln]
             for lib in libs}
    import importlib.util

    import torch

    state["card"] = card_line()
    state["pil"] = importlib.util.find_spec("PIL") is not None
    emit({"phase": "build", "ok": True, "nvcc_s": secs,
          "libraries": [lib.name for lib in libs],
          "nvcc_s_each": {lib.name: t for lib, t in built}, "ptxas": ptxas,
          "card": state["card"], "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "pil": state["pil"]})


# ---------------------------------------------------------------- kernels

def _k1_inputs(n, q, metric, gen, ties=False):
    import torch

    from art_sbir_tpu_torch.ops.retrieval_fused import (gallery_norms,
                                                        query_norms)

    dev = torch.device("cuda")
    g = torch.randn((n, D), generator=gen, device=dev)
    if ties:  # rows [n//2, n//2 + 64) duplicate rows [0, 64)
        g[n // 2:n // 2 + 64] = g[:64]
    pos = torch.randint(0, n, (q,), generator=gen, device=dev)
    if ties:
        pos = torch.arange(q, device=dev) % 64
    noise = torch.randn((q, D), generator=gen, device=dev)
    queries = (g[pos] + (0.05 if ties else 1.0) * noise).contiguous()
    qq, gg = query_norms(queries, metric), gallery_norms(g, metric)
    pos2d = pos.to(torch.int32).reshape(-1, 1).contiguous()
    return queries, qq, pos2d, g, gg


def _as_bf16(inputs, metric, held):
    """K1's bf16-form operands for the same data: the queries' norms stay
    float32; the gallery's come from the gallery as the caller holds it
    (``held``: float32, or bf16)."""
    import torch

    from art_sbir_tpu_torch.ops.retrieval_fused import gallery_norms

    queries, qq, pos2d, g, _ = inputs
    g_held = g.to(held)
    return (queries.to(torch.bfloat16), qq, pos2d,
            g_held.to(torch.bfloat16).contiguous(),
            gallery_norms(g_held, metric))


def _compare(out, ref, q, n, with_ranks, rank_tol=2, bound=None,
             swaps=False):
    """Checks of K1 against its plain version; ``rank_tol``: the ranks'
    tolerance, one for all rows or one per row. ``bound`` (the bf16 form):
    the sum-order bound of each row's values (``rf.sum_order_bound`` at the
    plain version's columns), else the float32 form's rtol 1e-5. The top-k
    index sets must be exact, except with ``swaps`` (the bf16 form on the
    ``ties`` inputs, whose small distances lie closer than the bound): a
    column swapped into a set must then lie within twice the row's bound of
    the k-th value. Returns (max |value error|, max rank error, moved
    indices, max error over the bound)."""
    r1, v1, i1, e1 = (t.cpu().numpy() for t in out)
    r0, v0, i0, _ = (t.cpu().numpy() for t in ref)
    check(e1.all(), "K1 certificate")
    same_sets = (np.sort(i1, 1) == np.sort(i0, 1)).all(1)
    over = 0.0
    if bound is None:
        check(same_sets.all(), "K1 top-k index sets")
        check(np.allclose(v1, v0, rtol=1e-5, atol=1e-6), "K1 values rtol 1e-5")
    else:
        # sorted values move by at most the largest bound of their row
        b = bound.cpu().numpy().max(axis=1, keepdims=True)
        check(bool((np.abs(v1 - v0) <= b).all()),
              "K1 bf16 values within the sum-order bound")
        over = float((np.abs(v1 - v0) / np.maximum(b, 1e-30)).max())
        check(swaps or same_sets.all(), "K1 bf16 top-k index sets")
        for row in np.nonzero(~same_sets)[0]:
            swapped = ~np.isin(i1[row], i0[row])
            check(bool((np.abs(v1[row][swapped] - v0[row, -1])
                        <= 2 * b[row]).all()),
                  "K1 bf16 ties: a swapped column lies within the bound of "
                  "the k-th value")
    # rows ordered by (value, index), strictly
    key_ok = (v1[:, 1:] > v1[:, :-1]) | ((v1[:, 1:] == v1[:, :-1])
                                         & (i1[:, 1:] > i1[:, :-1]))
    check(key_ok.all(), "K1 (value, index) order")
    rank_diff = np.abs(r1.astype(np.int64) - r0)
    rank_err = int(rank_diff.max()) if q else 0
    check(bool((rank_diff <= rank_tol).all()) if with_ranks
          else not r1.any(), "K1 ranks within their tolerance")
    return float(np.abs(v1 - v0).max()), rank_err, int((i1 != i0).sum()), over


def _bf16_bound(rf, inputs, ref, metric):
    """The bf16 form's sum-order bound at the plain version's columns (None
    for the float32 form)."""
    import torch

    queries, qq, _, g, gg = inputs
    if g.dtype != torch.bfloat16:
        return None
    return rf.sum_order_bound(queries, g, ref[2], qq, gg, metric)


def _k1_ties(rf, inputs, form):
    """Duplicated rows tie exactly, the smaller index first, and the
    positive's earlier duplicate counts toward its rank."""
    out = rf.fused_sweep_cuda(*inputs, k=K, metric="euclidean",
                              with_ranks=True)
    ref = rf.fused_sweep_reference(*inputs, k=K, metric="euclidean",
                                   with_ranks=True)
    _compare(out, ref, 32, SERVE_N, True,
             bound=_bf16_bound(rf, inputs, ref, "euclidean"), swaps=True)
    v1, i1 = out[1].cpu().numpy(), out[2].cpu().numpy()
    for row in range(32):
        p = row % 64
        idx = list(i1[row])
        check(p in idx and p + SERVE_N // 2 in idx,
              f"ties ({form}): both copies kept")
        a, b = idx.index(p), idx.index(p + SERVE_N // 2)
        check(b == a + 1 and v1[row, a] == v1[row, b],
              f"ties ({form}): exact tie, smaller index first")
    queries, qq, pos2d, g, gg = inputs
    later = rf.fused_sweep_cuda(queries, qq, pos2d + SERVE_N // 2, g, gg,
                                k=K, metric="euclidean", with_ranks=True)
    check(bool((later[0] == out[0] + 1).all()),
          f"ties ({form}): the positive's earlier duplicate counts toward "
          "its rank")


def _k1_offset_copies(rf, gen, q, dtype):
    """A row copied to every offset mod 128 of a tile (128 equal rows over
    N = 100,003) and ``q`` equal queries near it, whose positive is the
    last copy: every copy's value is the same in every query's row (the
    queries at every offset of their query tile), the copies come in index
    order, and the positive's 127 earlier copies count toward its rank."""
    import torch

    from art_sbir_tpu_torch.ops.retrieval_fused import (gallery_norms,
                                                        query_norms)

    n = SERVE_N + 3
    g = torch.randn((n, D), generator=gen, device="cuda")
    src = 5
    copies = sorted([src] + [128 * (7 * o % 781) + o for o in range(128)
                             if o != src])
    g[copies] = g[src].clone()
    x = (g[src] + 0.05 * torch.randn(D, generator=gen, device="cuda"))
    x = x.expand(q, D).contiguous()
    pos = torch.full((q, 1), copies[-1], dtype=torch.int32, device="cuda")
    inputs = (x.to(dtype), query_norms(x, "euclidean"), pos,
              g.to(dtype).contiguous(), gallery_norms(g, "euclidean"))
    ranks, vals, idx, _ = rf.fused_sweep_cuda(*inputs, k=128,
                                              metric="euclidean",
                                              with_ranks=True)
    want = torch.tensor(copies, dtype=torch.int32, device="cuda")
    form = "bf16" if dtype == torch.bfloat16 else "float32"
    check(bool((idx == want[None, :]).all()),
          f"copies at every tile offset ({form}, Q={q}): index order")
    check(bool((vals == vals[0, 0]).all()),
          f"copies at every tile offset ({form}, Q={q}): one value")
    check(bool((ranks == 127).all()),
          f"copies at every tile offset ({form}, Q={q}): the positive's "
          "earlier copies count")


def phase_kernels(state) -> None:
    import torch

    from art_sbir_tpu_torch.ops import retrieval_fused as rf

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    cases, bf16_cases = [], []
    max_err = {"f32": 0.0, "bf16": 0.0}
    max_over = 0.0  # the bf16 form's largest value error over its bound
    # Q in {1, 32, 512}, ranks on and off; at N = 100,003 (inference_k1's
    # gallery) also evaluate_retrieval's query chunks there, ranks on: a
    # full chunk of 1,024 and the partial one of its ~1,100 queries
    for n, qs in ((SERVE_N, (1, 32, 512)),
                  (SERVE_N + 3, (1, 32, 512) + EVAL_CHUNKS)):
        for metric in ("euclidean", "cosine"):
            for q in qs:
                base = _k1_inputs(n, q, metric, gen)
                # the float32 form; the bf16 form with the gallery held as
                # float32, then as bf16
                for form, held in (("f32", None), ("bf16", f32),
                                   ("bf16", bf16)):
                    inputs = (base if held is None
                              else _as_bf16(base, metric, held))
                    for with_ranks in ((True,) if q in EVAL_CHUNKS
                                       else (True, False)):
                        kw = dict(k=K, metric=metric, with_ranks=with_ranks)
                        out = rf.fused_sweep_cuda(*inputs, **kw)
                        ref = rf.fused_sweep_reference(*inputs, **kw)
                        torch.cuda.synchronize()
                        err, rank_err, moved, over = _compare(
                            out, ref, q, n, with_ranks,
                            bound=_bf16_bound(rf, inputs, ref, metric))
                        max_err[form] = max(max_err[form], err)
                        max_over = max(max_over, over)
                        row = [n, q, metric, with_ranks, err, rank_err, moved]
                        if held is None:
                            cases.append(row)
                        else:
                            bf16_cases.append(row + [str(held)[6:]])
                    del inputs
                del base
    # manufactured ties: duplicated rows tie exactly, the smaller index first
    inputs = _k1_inputs(SERVE_N, 32, "euclidean", gen, ties=True)
    _k1_ties(rf, inputs, "float32")
    for held in (f32, bf16):
        _k1_ties(rf, _as_bf16(inputs, "euclidean", held), "bf16")
        bf16_cases.append(["ties", 32, "euclidean", str(held)[6:]])
    del inputs
    # a row at every offset mod 128 of a tile, queries at every offset of
    # their tile (Q = 32: one tile of 32; Q = 40: one of 64)
    for q in (32, 40):
        for dtype in (f32, bf16):
            _k1_offset_copies(rf, gen, q, dtype)
            (cases if dtype == f32 else bf16_cases).append(
                ["copies at every tile offset", q, "euclidean"])

    # times at the serving shape: Q = 32, N = 100,000, euclidean, no ranks
    q, n = 32, SERVE_N
    inputs = _k1_inputs(n, q, "euclidean", gen)
    kw = dict(k=K, metric="euclidean", with_ranks=False)
    kernel_ms = time_ms(lambda: rf.fused_sweep_cuda(*inputs, **kw))
    plain_ms = time_ms(lambda: rf.fused_sweep_reference(*inputs, **kw))
    queries, g = inputs[0], inputs[3]
    library_ms = time_ms(lambda: torch.topk(torch.cdist(queries, g), K,
                                            largest=False))
    kernel_ms2 = time_ms(lambda: rf.fused_sweep_cuda(*inputs, **kw))
    kernel_device_ms = device_ms(lambda: rf.fused_sweep_cuda(*inputs, **kw))
    # the norms around the sweep: the queries' on every search, the
    # gallery's once when the engine is built
    query_norms_ms = time_ms(lambda: rf.query_norms(queries, "euclidean"))
    gallery_norms_ms = time_ms(lambda: rf.gallery_norms(g, "euclidean"))
    ops = 2 * q * n * D
    bound_ms, bound_by = bound(
        4 * (n * D + q * D + n + 2 * q) + q * K * 8 + q * 8, ops,
        H100_F32_FLOP_PER_S)
    state["k1"] = {
        "name": "K1_fused_retrieval", "route": "cuda",
        "source": "art_sbir_tpu_torch/csrc/fused_retrieval.cu",
        "replaces": "art_sbir_tpu/ops/retrieval_pallas.py:365",
        "max_abs_err": max_err["f32"], "ms": min(kernel_ms, kernel_ms2),
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms}
    # the bf16 form at the same shape, on a gallery held in bf16, beside
    # the closest library composition: cuBLAS on bf16 operands with a bf16
    # output (so it rounds the cross term: a yardstick of speed, not the
    # same function), the norm arithmetic, then torch.topk
    b = _as_bf16(inputs, "euclidean", bf16)
    bf16_ms = time_ms(lambda: rf.fused_sweep_cuda(*b, **kw))
    bf16_plain_ms = time_ms(lambda: rf.fused_sweep_reference(*b, **kw))

    def bf16_library():
        cross = torch.matmul(b[0], b[3].T)
        return torch.topk(b[1] + b[4] - 2.0 * cross.float(), K, largest=False)

    bf16_library_ms = time_ms(bf16_library)
    bf16_ms2 = time_ms(lambda: rf.fused_sweep_cuda(*b, **kw))
    bf16_device_ms = device_ms(lambda: rf.fused_sweep_cuda(*b, **kw))
    bf16_bound, bf16_by = bound(
        2 * (n * D + q * D) + 4 * (n + 2 * q) + q * K * 8 + q * 8, ops,
        H100_BF16_FLOP_PER_S)
    state["k1_bf16"] = {
        "name": "K1_fused_retrieval_bf16", "route": "cuda",
        "source": "art_sbir_tpu_torch/csrc/fused_retrieval.cu",
        "replaces": "art_sbir_tpu/ops/retrieval_pallas.py:365",
        "max_abs_err": max_err["bf16"], "ms": min(bf16_ms, bf16_ms2),
        "plain_ms": bf16_plain_ms, "bound_ms": bf16_bound,
        "bound_by": bf16_by, "library_ms": bf16_library_ms}
    del inputs, queries, g, b
    # K1 at other batch buckets of the main path, and at offline-evaluation
    # batches (512, and evaluate_retrieval's chunk of 1,024; ranks on; here,
    # before the serve phases' profiler runs, device_ms is read reliably),
    # in both forms, beside each one's
    # bound, its plain version and the library calls (k1_library)
    by_q = []
    for q, with_ranks in ((1, False), (4, False), (512, True), (1024, True)):
        inputs = _k1_inputs(n, q, "euclidean", gen)
        b = _as_bf16(inputs, "euclidean", bf16)
        kw = dict(k=K, metric="euclidean", with_ranks=with_ranks)
        row = {"q": q, "with_ranks": with_ranks}
        for form, args, op_rate, width in (
                ("f32", inputs, H100_F32_FLOP_PER_S, 4),
                ("bf16", b, H100_BF16_FLOP_PER_S, 2)):
            ms = [time_ms(lambda: rf.fused_sweep_cuda(*args, **kw))]
            row[form + "_plain_ms"] = time_ms(
                lambda: rf.fused_sweep_reference(*args, **kw))
            row[form + "_library_ms"] = time_ms(lambda: k1_library(
                args[0], args[3], args[1], args[4], args[2], with_ranks))
            ms.append(time_ms(lambda: rf.fused_sweep_cuda(*args, **kw)))
            row[form + "_ms"] = min(ms)
            row[form + "_device_ms"] = device_ms(
                lambda: rf.fused_sweep_cuda(*args, **kw))
            row[form + "_bound_ms"] = bound(
                width * (n * D + q * D) + 4 * (n + 2 * q) + q * K * 8 + q * 8,
                2 * q * n * D, op_rate)[0]
        by_q.append(row)
        del inputs, b
    emit({"phase": "kernels", "ok": True, "cases": len(cases) + 1,
          "case_rows": cases, "kernel_ms_runs": [kernel_ms, kernel_ms2],
          **{k: v for k, v in state["k1"].items() if k.endswith("ms")},
          "query_norms_ms": query_norms_ms,
          "gallery_norms_ms": gallery_norms_ms, "by_q": by_q,
          "bf16_cases": len(bf16_cases), "bf16_case_rows": bf16_cases,
          "bf16_kernel_ms_runs": [bf16_ms, bf16_ms2],
          "device_ms": kernel_device_ms, "bf16_device_ms": bf16_device_ms,
          **{"bf16_" + k: v for k, v in state["k1_bf16"].items()
             if k.endswith("ms") or k == "bound_by"},
          "bf16_library": "torch.matmul of bf16 operands (bf16 output), "
                          "the norms, torch.topk",
          "bf16_value_bound": "|d_kernel - d_plain| <= 4 D 2^-23 "
                              "sum_d |q_d g_d| + 2^-22 (|qq| + |gg| + "
                              "2 |cross|) (euclidean), per row "
                              "(rf.sum_order_bound)",
          "bf16_max_abs_err": max_err["bf16"],
          "bf16_max_err_over_bound": max_over})


def _k2_inputs(g, q, metric, gen, near=None):
    """Quantized gallery and queries for K2: random queries, or queries
    within 0.01 of gallery row ``near``."""
    import torch

    from art_sbir_tpu_torch.ops import quant

    qg = quant.quantize_gallery(g, metric)
    x = torch.randn((q, D), generator=gen, device="cuda")
    if near is not None:
        x = g[near] + 0.01 * x
    q8, s_q = quant._quantize_queries(x, metric)
    return q8, s_q, qg.q8, qg.scale, qg.sq_norm


def _k2_worst_order(gen):
    """K2's inputs in the selection's worst order: 32 copies of one query
    over a gallery whose rows are sorted by descending score against it,
    so that every row beats all rows before it."""
    import torch

    from art_sbir_tpu_torch.ops import quant_fused as qf

    g = torch.randn((QUANT_N, D), generator=gen, device="cuda")
    q8, s_q, g8, g_scale, g_sq = _k2_inputs(g, 1, "euclidean", gen)
    del g
    score = qf.approx_scores(q8, s_q, g8, g_scale, g_sq, "euclidean")[0]
    order = torch.argsort(score, descending=True)
    return (q8.expand(32, D).contiguous(), s_q.expand(32).contiguous(),
            g8[order].contiguous(), g_scale[order].contiguous(),
            g_sq[order].contiguous())


def _k2_compare(inputs, r, metric, what):
    import torch

    from art_sbir_tpu_torch.ops import quant_fused as qf

    out = qf.quant_candidates_cuda(*inputs, r=r, metric=metric)
    ref = qf.quant_candidates_reference(*inputs, r=r, metric=metric)
    torch.cuda.synchronize()
    check(bool(out[2].all()), f"K2 certificate ({what})")
    check(torch.equal(out[1], ref[1]), f"K2 indices bit-identical ({what})")
    check(torch.equal(out[0], ref[0]), f"K2 scores bit-identical ({what})")
    return out, float((out[0] - ref[0]).abs().max())


def phase_kernels_k2(state) -> None:
    import torch

    from art_sbir_tpu_torch.ops import quant
    from art_sbir_tpu_torch.ops import quant_fused as qf

    gen = torch.Generator(device="cuda").manual_seed(2)
    cases, max_err = [], 0.0
    for n in (QUANT_N, QUANT_N + 3):
        g = torch.randn((n, D), generator=gen, device="cuda")
        for metric in ("euclidean", "cosine"):
            for q in (1, 32, 512):
                inputs = _k2_inputs(g, q, metric, gen)
                for r in (R, 128) + (R_WIDE if q <= 32 else ()):
                    _, err = _k2_compare(inputs, r, metric,
                                         f"{n} {metric} {q} {r}")
                    max_err = max(max_err, err)
                    cases.append([n, q, metric, r])
                del inputs
        del g
    # duplicated rows: 64 equal copies of one row, spread over the gallery,
    # are the queries' 64 best rows with equal scores; the r-th candidate
    # falls among them, and the earlier indices must win
    g = torch.randn((QUANT_N, D), generator=gen, device="cuda")
    copies = torch.arange(64, device="cuda") * (QUANT_N // 64) + 7
    g[copies] = g[7].clone()
    for metric in ("euclidean", "cosine"):
        inputs = _k2_inputs(g, 32, metric, gen, near=7)
        for r in (R, 128):
            out, err = _k2_compare(inputs, r, metric, f"ties {metric} {r}")
            max_err = max(max_err, err)
            want = copies[:min(r, 64)].to(torch.int32)
            check(bool((out[1][:, :min(r, 64)] == want).all()),
                  "K2 ties: the copies in index order, earlier first")
            check(bool((out[0][:, :min(r, 64)] == out[0][:, :1]).all()),
                  "K2 ties: the copies' scores are equal")
            cases.append(["ties", 32, metric, r])
        del inputs
    del g
    # the same across the 1,024th candidate: 1,100 equal rows
    g = torch.randn((QUANT_N, D), generator=gen, device="cuda")
    copies = torch.arange(1100, device="cuda") * (QUANT_N // 1100) + 7
    g[copies] = g[7].clone()
    for metric in ("euclidean", "cosine"):
        inputs = _k2_inputs(g, 32, metric, gen, near=7)
        out, err = _k2_compare(inputs, 1024, metric, f"ties {metric} 1024")
        max_err = max(max_err, err)
        check(bool((out[1] == copies[:1024].to(torch.int32)).all()),
              "K2 ties at r = 1024: the copies in index order, earlier first")
        check(bool((out[0] == out[0][:, :1]).all()),
              "K2 ties at r = 1024: the copies' scores are equal")
        cases.append(["ties", 32, metric, 1024])
        del inputs
    del g
    # 2,000 equal rows at consecutive indices: the ties cross the selection
    # buffer's flushes and the r-th candidate within a split
    g = torch.randn((QUANT_N, D), generator=gen, device="cuda")
    start = 128 * 1000
    g[start:start + 2000] = g[start].clone()
    for metric in ("euclidean", "cosine"):
        inputs = _k2_inputs(g, 32, metric, gen, near=start)
        for r in (R, 1024):
            out, err = _k2_compare(inputs, r, metric,
                                   f"consecutive ties {metric} {r}")
            max_err = max(max_err, err)
            want = torch.arange(start, start + r, device="cuda",
                                dtype=torch.int32)
            check(bool((out[1] == want).all()),
                  f"K2 consecutive ties at r = {r}: index order")
            cases.append(["consecutive ties", 32, metric, r])
        del inputs
    del g
    worst_inputs = _k2_worst_order(gen)
    for r in (R, 1024):
        _, err = _k2_compare(worst_inputs, r, "euclidean", f"worst order {r}")
        max_err = max(max_err, err)
        cases.append(["worst order", 32, "euclidean", r])

    # the route around K2 on the card: queries near 32 gallery rows, K2 and
    # the exact rerank on float32 and on bf16 rows, against the plain route
    q, n = 32, QUANT_N
    g = torch.randn((n, D), generator=gen, device="cuda")
    rows = torch.randint(0, n, (q,), generator=gen, device="cuda")
    x = g[rows] + 0.05 * torch.randn((q, D), generator=gen, device="cuda")
    for metric in ("euclidean", "cosine"):
        qg = quant.quantize_gallery(g, metric)
        v0, i0 = quant.retrieve_quantized(x, qg, g, k=K, rerank_factor=4)
        for rows_dtype in (torch.float32, torch.bfloat16):
            v1, i1 = quant.retrieve_quantized_fused(
                x, qg, g.to(rows_dtype), k=K, rerank_factor=4,
                device_get=True)
            check(bool((i1[:, 0] == rows.cpu().numpy()).all()),
                  f"int8 route top-1 ({metric}, {rows_dtype})")
            if rows_dtype == torch.float32:
                check(np.array_equal(i1, i0.cpu().numpy())
                      and np.array_equal(v1, v0.cpu().numpy()),
                      f"K2 route equals the plain int8 route ({metric})")
        del qg
    cases.append(["route", q, "both", R])

    # times at the serving shape: Q = 32, N = 1,000,000, r = 40, euclidean
    inputs = _k2_inputs(g, q, "euclidean", gen)
    q8, s_q, g8, g_scale, g_sq = inputs
    kw = dict(r=R, metric="euclidean")
    kernel_ms = time_ms(lambda: qf.quant_candidates_cuda(*inputs, **kw))
    plain_ms = time_ms(lambda: qf.quant_candidates_reference(*inputs, **kw))

    def library():  # int8 product, the score, then top-k
        cross = torch._int_mm(q8, g8.t())
        dot = cross.float() * (s_q[:, None] * g_scale[None, :])
        return torch.topk(g_sq[None, :] - 2.0 * dot, R, largest=False)

    library_ms = time_ms(library)
    kernel_ms2 = time_ms(lambda: qf.quant_candidates_cuda(*inputs, **kw))
    quantize_ms = time_ms(lambda: quant.quantize_gallery(g, "euclidean"),
                          reps=3, warmup=1)

    def k2_bound(q, r):
        return bound(q * D + 4 * q + n * D + 8 * n + 8 * q * r + 4 * q,
                     2 * q * n * D, H100_INT8_OP_PER_S)

    bound_ms, bound_by = k2_bound(q, R)
    state["k2"] = {
        "name": "K2_quant_candidates", "route": "cuda",
        "source": "art_sbir_tpu_torch/csrc/quant_candidates.cu",
        "replaces": "art_sbir_tpu/ops/retrieval_pallas.py:704",
        "max_abs_err": max_err, "ms": min(kernel_ms, kernel_ms2),
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms}
    # K2 past the JAX engine's 128 candidates, at Q = 32 (16 queries a
    # block above r = 512)
    wide = []
    for r in R_WIDE:
        kw = dict(r=r, metric="euclidean")
        ms = time_ms(lambda: qf.quant_candidates_cuda(*inputs, **kw), reps=5)
        r_plain_ms = time_ms(
            lambda: qf.quant_candidates_reference(*inputs, **kw), reps=5)

        def r_library():
            cross = torch._int_mm(q8, g8.t())
            dot = cross.float() * (s_q[:, None] * g_scale[None, :])
            return torch.topk(g_sq[None, :] - 2.0 * dot, r, largest=False)

        r_library_ms = time_ms(r_library, reps=5)
        ms2 = time_ms(lambda: qf.quant_candidates_cuda(*inputs, **kw), reps=5)
        r_bound, r_by = k2_bound(q, r)
        wide.append({"r": r, "ms": min(ms, ms2), "kernel_ms_runs": [ms, ms2],
                     "plain_ms": r_plain_ms, "bound_ms": r_bound,
                     "bound_by": r_by, "library_ms": r_library_ms})
    state["k2"]["r_gt_128"] = wide
    # the worst order for the selection: every row beats all before it
    worst = []
    for r in (R, 1024):
        kw = dict(r=r, metric="euclidean")
        worst.append({
            "r": r,
            "worst_order_ms": time_ms(lambda: qf.quant_candidates_cuda(
                *worst_inputs, **kw), reps=5),
            "ms": time_ms(lambda: qf.quant_candidates_cuda(*inputs, **kw),
                          reps=5)})
    del inputs, q8, g8, worst_inputs
    # K2 at other batch buckets and candidate budgets, beside each bound
    by_q = []
    for q, r in ((1, R), (8, R), (32, 128), (512, R)):
        inputs = _k2_inputs(g, q, "euclidean", gen)
        kw = dict(r=r, metric="euclidean")
        ms = time_ms(lambda: qf.quant_candidates_cuda(*inputs, **kw))
        row = {"q": q, "r": r, "ms": ms, "bound_ms": k2_bound(q, r)[0]}
        if q == 512:  # the offline batch, beside its plain and library calls
            q8, s_q, g8, g_scale, g_sq = inputs

            def q_library():
                cross = torch._int_mm(q8, g8.t())
                dot = cross.float() * (s_q[:, None] * g_scale[None, :])
                return torch.topk(g_sq[None, :] - 2.0 * dot, r, largest=False)

            row["plain_ms"] = time_ms(
                lambda: qf.quant_candidates_reference(*inputs, **kw), reps=5)
            row["library_ms"] = time_ms(q_library, reps=5)
            row["ms_again"] = time_ms(
                lambda: qf.quant_candidates_cuda(*inputs, **kw))
            del q8, g8
        by_q.append(row)
        del inputs
    # the int8 route whole past the JAX engine's 128 candidates
    # (rerank_factor 8, k = r / 8) at Q in {1, 32}: K2's and the plain
    # scan's, each as a dispatch runs it (results to the host), which set
    # the engine's ENGINE_R_MAX
    qg = quant.quantize_gallery(g, "euclidean")
    route_wide = []
    for q, r in itertools.product((1, 32), R_WIDE):
        x = torch.randn((q, D), generator=gen, device="cuda")

        def k2_route():
            return quant.retrieve_quantized_fused(x, qg, g, k=r // 8,
                                                  rerank_factor=8,
                                                  device_get=True)

        def plain_route():
            return [t.cpu().numpy() for t in quant.retrieve_quantized(
                x, qg, g, k=r // 8, rerank_factor=8)]

        a, b = k2_route(), plain_route()
        check(np.array_equal(a[1], b[1]) and np.array_equal(a[0], b[0]),
              f"K2 route equals the plain int8 route at Q = {q}, r = {r}")
        route_wide.append({"q": q, "n": QUANT_N, "k": r // 8, "r": r,
                           "k2_route_ms": time_ms(k2_route, reps=5),
                           "plain_route_ms": time_ms(plain_route, reps=5)})
    del g, qg
    # the engine's two int8 routes as a dispatch runs them (query
    # quantization, candidates, exact rerank, results to the host): K2's
    # and the plain scan's, at galleries from 10,000 rows up
    by_n = []
    for n in (10_000, 50_000, 100_000, 250_000, QUANT_N):
        g = torch.randn((n, D), generator=gen, device="cuda")
        qg = quant.quantize_gallery(g, "euclidean")
        for q in (1, 32):
            x = torch.randn((q, D), generator=gen, device="cuda")

            def k2_route():
                return quant.retrieve_quantized_fused(
                    x, qg, g, k=K, rerank_factor=4, device_get=True)

            def plain_route():
                return [t.cpu().numpy() for t in quant.retrieve_quantized(
                    x, qg, g, k=K, rerank_factor=4)]

            a, b = k2_route(), plain_route()
            check(np.array_equal(a[1], b[1]) and np.array_equal(a[0], b[0]),
                  f"K2 route equals the plain int8 route ({n} rows, Q={q})")
            by_n.append({"n": n, "q": q, "k2_route_ms": time_ms(k2_route),
                         "plain_route_ms": time_ms(plain_route)})
        del g, qg
    emit({"phase": "kernels_k2", "ok": True, "cases": len(cases),
          "case_rows": cases, "kernel_ms_runs": [kernel_ms, kernel_ms2],
          **{k: v for k, v in state["k2"].items() if k.endswith("ms")},
          "bound_by": bound_by, "quantize_gallery_ms": quantize_ms,
          "by_q": by_q, "r_gt_128": wide, "worst_order": worst,
          "route_r_gt_128": route_wide,
          "routes_by_n": by_n})


def phase_kernels_int8_wide(state) -> None:
    """The plain int8 scan on the card at D = 2,048, past the 1,040 columns
    whose int8 products a float32 sum holds exactly: the cross term (float32
    slices summed in int32) equals the int32 product on the CPU, with TF32
    off and on; the plain scan's candidates and scores are bit-identical to
    the CPU's; the plain int8 route finds each query's planted row."""
    import torch

    from art_sbir_tpu_torch.ops import quant
    from art_sbir_tpu_torch.ops import quant_fused as qf

    gen = torch.Generator(device="cuda").manual_seed(4)
    d, n, q = 2048, 20_000, 32
    g = torch.randn((n, d), generator=gen, device="cuda")
    rows = torch.randint(0, n, (q,), generator=gen, device="cuda")
    x = g[rows] + 0.05 * torch.randn((q, d), generator=gen, device="cuda")
    saved = torch.backends.cuda.matmul.allow_tf32
    cases = []
    for metric in ("euclidean", "cosine"):
        qg = quant.quantize_gallery(g, metric)
        q8, s_q = quant._quantize_queries(x, metric)
        want = qf.int8_cross(q8.cpu(), qg.q8.cpu()).float()
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            check(torch.equal(qf.int8_cross(q8, qg.q8).cpu(), want),
                  f"int8 cross term at D = {d} ({metric}, TF32 {tf32})")
        torch.backends.cuda.matmul.allow_tf32 = saved
        args = (q8, s_q, qg.q8, qg.scale, qg.sq_norm)
        out = qf.quant_candidates_reference(*args, r=R, metric=metric)
        ref = qf.quant_candidates_reference(*(t.cpu() for t in args), r=R,
                                            metric=metric)
        check(torch.equal(out[1].cpu(), ref[1])
              and torch.equal(out[0].cpu(), ref[0]),
              f"plain int8 scan at D = {d} equals the CPU's ({metric})")
        _, idx = quant.retrieve_quantized(x, qg, g, k=K, rerank_factor=4)
        check(bool((idx[:, 0] == rows).all()),
              f"plain int8 route top-1 at D = {d} ({metric})")
        route_ms = time_ms(lambda: quant.retrieve_quantized(
            x, qg, g, k=K, rerank_factor=4), reps=5)
        cases.append({"metric": metric, "d": d, "n": n, "q": q, "r": R,
                      "plain_route_ms": route_ms})
        del qg, q8, s_q, out, ref
    emit({"phase": "kernels_int8_wide", "ok": True, "cases": cases})


# --------------------------------------------------------------- probe_k1

def _probe_bounds(q, n):
    """Each probe configuration's bound: its inputs read once, its outputs
    written once, 2*Q*N*D operations at the rate of its operands' type."""
    ops = 2 * q * n * D
    p1 = 2 * (n * D + q * D) + 4 * (n + 3 * q) + 4 * q
    k1 = 2 * (n * D + q * D) + 4 * (n + 2 * q) + q * K * 8 + 4 * q
    k1_f32 = 4 * (n * D + q * D) + 4 * (n + 2 * q) + q * K * 8 + 4 * q
    return {"mm": bound(p1, ops, H100_BF16_FLOP_PER_S),
            "rank": bound(p1, ops, H100_BF16_FLOP_PER_S),
            "top2": bound(p1, ops, H100_BF16_FLOP_PER_S),
            "full": bound(k1, ops, H100_BF16_FLOP_PER_S),
            "full_f32": bound(k1_f32, ops, H100_F32_FLOP_PER_S),
            "xla": bound(k1_f32, ops, H100_BF16_FLOP_PER_S)}


def _probe_shape_checks(q, n):
    """P1's three levels and K1 in both forms, called as the probe calls
    them on the probe's own inputs at (Q, N), against their plain versions.
    K1's ranks may differ from the plain version's by as many columns as lie
    within reach of the positive's distance, or by 2 where fewer lie there:
    the two sum the cross term in different orders, and a million columns
    put a few within that reach. The reach is twice the largest value error
    of the call (a column's and the positive's), at least 4 ulp of the
    positive's distance; the bf16 values are held to the sum-order bound of
    ``rf.sum_order_bound``. Returns P1's rows and K1's, each K1 row with its
    reach, and the plain P1's time at level 2."""
    import torch

    from art_sbir_tpu_torch.ops import fused_ablation as fa
    from art_sbir_tpu_torch.ops import retrieval_fused as rf
    from art_sbir_tpu_torch.ops.distance import _cross
    from art_sbir_tpu_torch.scripts import probe_fused_overhead as probe

    x, g, p, qq, gg, d2pos = probe.make_inputs(n, q, torch.device("cuda"))
    pos2d = p[:, None].contiguous()
    p1_rows, k1_rows = [], []
    for level in fa.LEVELS:
        out = fa.ablate_cuda(x, g, qq, gg, d2pos, pos2d, level=level)
        ref = fa.ablate_reference(x, g, qq, gg, d2pos, pos2d, level=level)
        err = int((out.long() - ref.long()).abs().max())
        tol = n // fa.TILE_N if level == 0 else 2
        check(err <= tol, f"P1 level {level} at Q={q}, N={n} within {tol}")
        p1_rows.append([n, q, level, err])
        del out, ref
    p1_plain_ms = time_ms(lambda: fa.ablate_reference(
        x, g, qq, gg, d2pos, pos2d, level=2), reps=2, warmup=1)
    norms = rf.gallery_norms(g, "euclidean")
    qn = rf.query_norms(x, "euclidean")
    for precision, op in (("default", torch.bfloat16),
                          ("highest", torch.float32)):
        xo, go = x.to(op), g.to(op)
        out = rf.retrieve_fused_core(xo, go, p, k=K, precision=precision,
                                     gg=norms)
        ref = rf.fused_sweep_reference(xo, qn, pos2d, go, norms, k=K,
                                       metric="euclidean", with_ranks=True)
        d = torch.clamp(qn + norms - 2.0 * _cross(xo, go, precision),
                        min=0.0)
        dpos = torch.gather(d, 1, pos2d.long())
        # a column and the positive each move by at most the largest value
        # error that this call shows; 4 ulp of the positive's distance where
        # that is less (the float32 form, whose values agree exactly)
        moved_by = float(torch.max(torch.abs(out[1] - ref[1])))
        reach = torch.clamp(4.0 * (torch.nextafter(
            dpos, torch.full_like(dpos, float("inf"))) - dpos),
            min=2.0 * moved_by)
        near = torch.sum(torch.abs(d - dpos) <= reach, dim=1) - 1
        del d, dpos, reach
        bound = (rf.sum_order_bound(xo, go, ref[2], qn, norms, "euclidean")
                 if op == torch.bfloat16 else None)
        rank_tol = np.maximum(near.cpu().numpy(), 2)
        err, rank_err, moved, _ = _compare(out, ref, q, n, True, rank_tol,
                                           bound=bound)
        k1_rows.append([n, q, precision, err, rank_err, moved,
                        int(rank_tol.max()), 2.0 * moved_by])
        del xo, go, out, ref
    return p1_rows, k1_rows, p1_plain_ms


def phase_probe_k1(state) -> None:
    import torch

    from art_sbir_tpu_torch.ops import fused_ablation as fa
    from art_sbir_tpu_torch.scripts import probe_fused_overhead as probe

    # P1 against its plain version: queries near random rows, four of them
    # equal to their row (distances near 0 for level 2), and d2pos at each
    # row's 1,000th smallest distance, so that about 1,000 columns are hits
    gen = torch.Generator(device="cuda").manual_seed(3)
    n = 102_400
    g = torch.randn((n, D), generator=gen, device="cuda").to(torch.bfloat16)
    gg = torch.sum(g.float() ** 2, dim=1)[None, :]
    cases, max_err = [], 0
    for q in (32, 512):
        pos = torch.randint(0, n, (q,), generator=gen, device="cuda")
        x = (g[pos].float() + 0.7 * torch.randn(
            (q, D), generator=gen, device="cuda")).to(torch.bfloat16)
        x[:4] = g[pos[:4]]
        qq = torch.sum(x.float() ** 2, dim=1, keepdim=True)
        d2 = torch.clamp(qq + gg - 2.0 * (x.float() @ g.float().T), min=0.0)
        d2pos = torch.kthvalue(d2, 1000, dim=1, keepdim=True).values
        del d2
        args = (x, g, qq, gg, d2pos.contiguous(),
                pos.to(torch.int32)[:, None].contiguous())
        for level in fa.LEVELS:
            out = fa.ablate_cuda(*args, level=level)
            ref = fa.ablate_reference(*args, level=level)
            err = int((out.long() - ref.long()).abs().max())
            tol = n // fa.TILE_N if level == 0 else 2
            check(err <= tol, f"P1 level {level} at Q={q} within {tol}")
            if level:
                check(bool((ref >= 900).all()), "P1 d2pos gives hits")
            max_err = max(max_err, err)
            cases.append([n, q, level, err])
        if q == 32:
            p1_plain_ms = time_ms(lambda: fa.ablate_reference(*args, level=2),
                                  reps=5)
        del x, args
    del g, gg
    # the same, and K1 in both forms, at the probe's own shapes and inputs
    k1_cases, p1_plain_by_shape = [], {}
    for q_, n_ in PROBE_SHAPES:
        p1_rows, k1_rows, p1_plain_by_shape[f"{q_}x{n_}"] = \
            _probe_shape_checks(q_, n_)
        cases += p1_rows
        k1_cases += k1_rows
        max_err = max([max_err] + [row[3] for row in p1_rows])
        for row in k1_rows:
            form = state["k1_bf16" if row[2] == "default" else "k1"]
            form["max_abs_err"] = max(form["max_abs_err"], row[3])
        torch.cuda.empty_cache()

    # the probe: every count set to 0 just before its runs, read after
    counters = _counters()
    for c in counters.values():
        c.reset()
    runs = [probe.run(n_, q_, rounds=3, device="cuda", log=lambda _: None)
            for q_, n_ in PROBE_SHAPES]
    torch.cuda.synchronize()
    launches = {name: c.launches for name, c in counters.items()}
    check(all(launches[name] > 0 for name in ("K1", "K1_bf16", "P1")),
          "the probe launched K1 in both forms and P1")
    check(launches["K2"] == 0, "the probe launched no K2")
    check(all(c.fallback_rows == 0 for c in counters.values()),
          "K1 never fell back in the probe")
    state["launches"]["K1_bf16"] = launches["K1_bf16"]
    state["launches"]["P1"] = launches["P1"]
    # the library compositions of K1's function with ranks at the probe's
    # shapes and inputs (k1_library), in both forms
    library = []
    for q_, n_ in PROBE_SHAPES:
        x, g, p, qq, gg, _ = probe.make_inputs(n_, q_, torch.device("cuda"))
        pos2d = p[:, None].contiguous()
        x32, g32 = x.float(), g.float()
        library.append({
            "q": q_, "n": n_,
            "full_library_ms": time_ms(lambda: k1_library(
                x, g, qq, gg, pos2d, True), reps=5),
            "full_f32_library_ms": time_ms(lambda: k1_library(
                x32, g32, qq, gg, pos2d, True), reps=5)})
        del x, g, p, qq, gg, pos2d, x32, g32
        torch.cuda.empty_cache()
    shapes = []
    for res in runs:
        bounds = _probe_bounds(res["q"], res["n"])
        shapes.append({"q": res["q"], "n": res["n"], "rounds": res["rounds"],
                       "configs": {
                           name: {"ms": ms,
                                  "share_of_full": res["share_of_full"][name],
                                  "bound_ms": bounds[name][0],
                                  "bound_by": bounds[name][1]}
                           for name, ms in res["ms"].items()}})
    serving = shapes[0]["configs"]
    state["p1"] = {
        "name": "P1_fused_ablation", "route": "cuda",
        "source": "art_sbir_tpu_torch/csrc/fused_ablation.cu",
        "replaces": "scripts/probe_fused_overhead.py:88",
        "max_abs_err": max_err, "ms": serving["top2"]["ms"],
        "plain_ms": p1_plain_ms, "bound_ms": serving["top2"]["bound_ms"],
        "bound_by": serving["top2"]["bound_by"], "library_ms": None,
        "levels_ms": {name: serving[name]["ms"]
                      for name in ("mm", "rank", "top2")}}
    emit({"phase": "probe_k1", "ok": True, "cases": len(cases),
          "case_rows": cases, "k1_case_rows": k1_cases,
          "p1_plain_ms_level2": p1_plain_ms,
          "p1_plain_ms_level2_probe_shapes": p1_plain_by_shape,
          "launches": launches, "shapes": shapes, "library": library,
          "library_calls": "k1_library: torch.cdist (full_f32) or bf16 "
                           "torch.matmul with the norms (full), torch.topk, "
                           "the rank count"})


# ---------------------------------------------------------------- encoder

def phase_encoder(state) -> None:
    import torch

    from art_sbir_tpu_torch.core.device import ieee_f32
    from art_sbir_tpu_torch.models.resnet import create_encoder
    from art_sbir_tpu_torch.train.prepare import finish_gallery_batch

    ieee_f32()  # the float32 yardstick runs without TF32
    model = create_encoder(device="cuda", seed=0)  # full width, bf16
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randint(0, 256, (32, 224, 224, 3), generator=gen,
                      device="cuda", dtype=torch.uint8)

    def forward():
        with torch.no_grad():
            return model(finish_gallery_batch(x))

    out = forward()
    check(tuple(out.shape) == (32, 1024), "encoder output shape")
    check(bool(torch.isfinite(out).all()), "encoder outputs finite")
    ms = time_ms(forward, reps=10)
    model.compute_dtype = torch.float32
    ref = forward()
    f32_ms = time_ms(forward, reps=5)
    model.compute_dtype = torch.bfloat16
    cos = torch.nn.functional.cosine_similarity(out, ref, dim=1)
    check(float(cos.min()) > 0.99, "bf16 vs float32 cosine > 0.99")
    cal = _calibrated_distances(model, finish_gallery_batch(x))
    check(cal["cos_f64_min"] >= ENCODER_CAL_COS_FLOOR,
          f"calibrated bf16 vs float64 cosine >= {ENCODER_CAL_COS_FLOOR} "
          f"({cal})")
    check(cal["rel_l2_f64"] < cal["fold_rel_l2_f64"]
          and cal["cos_f64_min"] > cal["fold_cos_f64_min"],
          f"calibrated bf16 nearer float64 than the old fold ({cal})")
    emit({"phase": "encoder", "ok": True, "batch": 32, "image_size": 224,
          "dtype": "bfloat16", "ms_per_batch": ms,
          "images_per_s": 32e3 / ms, "f32_ms_per_batch": f32_ms,
          "cos_bf16_f32_min": float(cos.min()),
          "cos_bf16_f32_mean": float(cos.mean()),
          "calibrated": cal, "cos_floor": ENCODER_CAL_COS_FLOOR})


# the calibrated bf16 encoder's least cosine to float64: its first card
# run read 0.9307 with BN in float32 on the conv's rounded output, the old
# fold 0.9139; the floor lies midway, so the fold fails it (PERF.md §6)
ENCODER_CAL_COS_FLOOR = 0.922


def _calibrated_distances(model, x) -> dict:
    """A copy of ``model`` whose BN running statistics are ``x``'s own (a
    float32 train-mode pass at momentum 1): the relative L2 distance and
    least row cosine of its bf16 output to its float64 output, and the
    same for the old fold of BN into bf16 (the conv's output rounded to
    bf16, scale and shift cast to bf16, ``addcmul`` in bf16), put in by
    forward hooks as a yardstick."""
    import copy

    import torch

    from art_sbir_tpu_torch.models.resnet import BatchNorm2d

    cal = copy.deepcopy(model)
    bns = [m for m in cal.modules() if isinstance(m, BatchNorm2d)]
    cal.compute_dtype = torch.float32
    for m in bns:
        m.momentum = 1.0
    cal.train()
    with torch.no_grad():
        cal(x)
    for m in bns:
        m.momentum = model.bn1.momentum
    cal.eval()

    def fold(m, args, out):
        x, bf16 = args[0].to(torch.bfloat16), torch.bfloat16
        scale = m.weight * torch.rsqrt(m.running_var + m.eps)
        shift = m.bias - m.running_mean * scale
        return torch.addcmul(shift.to(bf16)[None, :, None, None], x,
                             scale.to(bf16)[None, :, None, None])

    with torch.no_grad():
        cal.compute_dtype = torch.bfloat16
        port = cal(x).double()
        hooks = [m.register_forward_hook(fold) for m in bns]
        folded = cal(x).double()
        for h in hooks:
            h.remove()
        cal.double().compute_dtype = torch.float64
        ref = cal(x)

    def dist(got):
        cos = torch.nn.functional.cosine_similarity(got, ref, dim=1)
        return (float(torch.linalg.vector_norm(got - ref)
                      / torch.linalg.vector_norm(ref)), float(cos.min()))

    (rel, cos), (fold_rel, fold_cos) = dist(port), dist(folded)
    return {"rel_l2_f64": rel, "cos_f64_min": cos,
            "fold_rel_l2_f64": fold_rel, "fold_cos_f64_min": fold_cos}


# ------------------------------------------------------------------ serve

def _sketches(n: int, size: int = 224) -> np.ndarray:
    """``n`` synthetic line drawings: black strokes on white, uint8 RGB."""
    out = np.full((n, size, size, 3), 255, np.uint8)
    t = np.linspace(0.0, 1.0, 2 * size)[:, None]
    for i in range(n):
        rng = np.random.default_rng(100 + i)
        for _ in range(3 + 3 * i):
            a, b = rng.integers(8, size - 8, (2, 2))
            pts = np.rint(a + t * (b - a)).astype(int)
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    out[i, np.clip(pts[:, 0] + dy, 0, size - 1),
                        np.clip(pts[:, 1] + dx, 0, size - 1)] = 0
    return out


def _post(port: int, path: str, body: dict) -> dict:
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def _counters():
    """The launch counters of every kernel, by the route that runs it."""
    from art_sbir_tpu_torch.ops import fused_ablation as fa
    from art_sbir_tpu_torch.ops import quant_fused as qf
    from art_sbir_tpu_torch.ops import retrieval_fused as rf

    return {"K1": rf.counters, "K1_bf16": rf.bf16_counters, "K2": qf.counters,
            "P1": fa.counters}


def _gallery_features(n: int, planted: np.ndarray, seed: int):
    """(n, D) float32 rows with the planted rows' mean and spread, and the
    planted rows at ``slots``. Rows past 100,000 are drawn on the card."""
    import torch

    rng = np.random.default_rng(seed)
    if n <= SERVE_N:
        feats = rng.standard_normal((n, D), dtype=np.float32)
        feats = feats * planted.std() + planted.mean()
    else:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        feats = torch.randn((n, D), generator=gen, device="cuda")
        feats = (feats * float(planted.std())
                 + float(planted.mean())).cpu().numpy()
    slots = rng.choice(n, 8, replace=False)
    feats[slots] = planted
    return feats, slots


def _planted_rows(sketches: np.ndarray) -> np.ndarray:
    """The embeddings of the sketches by the same seeded fresh init that
    ``build_engine`` serves when no checkpoint exists."""
    import torch

    from art_sbir_tpu_torch.models.resnet import create_encoder
    from art_sbir_tpu_torch.train.prepare import finish_gallery_batch

    enc = create_encoder(device="cuda", seed=0)
    with torch.no_grad():
        return enc(finish_gallery_batch(
            torch.from_numpy(sketches).cuda())).cpu().numpy()


def phase_serve(state) -> None:
    _serve(state, "serve", SERVE_N, route="K1", flags=[])


def phase_serve_quant(state) -> None:
    import shutil
    import tempfile

    # the float32 cache of QUANT_N rows is 4.2 GB on disk; where the
    # temporary directory cannot hold it twice over, serve half as many
    need = 2 * 4 * QUANT_N * D
    n = (QUANT_N if shutil.disk_usage(tempfile.gettempdir()).free >= need
         else QUANT_N // 2)
    _serve(state, "serve_quant", n, route="K2", flags=["--quantize"])


def _serve(state, phase: str, n_rows: int, route: str, flags: list) -> None:
    """``phase``: ``build_engine`` over an ``n_rows`` cache with ``flags``,
    then the counted run (:func:`_serve_engine`); ``phase``_sharded: the
    same cache served by an engine whose gallery is sharded over 4 shards
    of the one card (``build_engine(args, mesh=...)``)."""
    import gc
    import tempfile

    import torch

    from art_sbir_tpu_torch.cli import serve
    from art_sbir_tpu_torch.parallel.mesh import MeshSpec
    from art_sbir_tpu_torch.retrieval.embed import save_image_features

    sketches = _sketches(8)
    with tempfile.TemporaryDirectory() as tmp:
        planted = _planted_rows(sketches)
        feats, slots = _gallery_features(n_rows, planted, seed=0)
        paths = [f"gallery/{i:07d}.jpg" for i in range(n_rows)]
        t0 = time.perf_counter()
        folder = save_image_features("ChipSmoke", "Random", paths, feats,
                                     root=tmp, timestamp="seed0")
        save_s = time.perf_counter() - t0
        del feats
        args = serve.parse_args([
            "-f", "ModifiedResNet_ChipSmoke", "--features", folder,
            "--feature_root", tmp, "--results_root", tmp, "--models_root",
            tmp, "--device", "cuda", "--window_ms", "5", *flags])
        for mesh in (None, MeshSpec(SHARDS).build(["cuda:0"] * SHARDS)):
            _serve_engine(state, phase if mesh is None else phase + "_sharded",
                          args, mesh, n_rows, route, sketches, paths, slots,
                          save_s)
            gc.collect()  # the engine's gallery before the next one's
            torch.cuda.empty_cache()


def _serve_engine(state, phase, args, mesh, n_rows, route, sketches, paths,
                  slots, save_s, extra=None, cached=False) -> None:
    """Build the engine, warm it up, then the counted run: /healthz, 20
    rounds of 8 concurrent /search and one /search_batch of 8 over HTTP;
    then one profiled dispatch outside it. The IVF routes (``ivf``,
    ``ivf_pq``) launch no kernel of the port: every count must stay 0.
    ``extra`` joins the phase's line; ``cached``: the engine must have
    loaded its index from ``--index_cache``."""
    import base64
    import io
    import threading
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from art_sbir_tpu_torch.cli import serve
    from art_sbir_tpu_torch.ops import retrieval_fused as rf

    rounds = 20  # closed loop: 8 clients, each sends again on its answer
    counters = _counters()
    shards = 1 if mesh is None else mesh.size
    cards = 1 if mesh is None else len(mesh.distinct_devices())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, batcher = serve.build_engine(args, mesh=mesh)
    build_s = time.perf_counter() - t0
    startup = dict(getattr(engine, "startup_s", {}))
    if cached:
        check(startup.get("ivf_cached") and startup.get("pq_cached"),
              "the second start loads the index from --index_cache")
    check(engine.route == route and engine.n_shards == shards,
          f"a {n_rows}-row gallery over {shards} shards takes the {route} "
          "route")
    t0 = time.perf_counter()
    serve.warmup(engine, batcher)
    warmup_s = time.perf_counter() - t0
    thread_ms = _fresh_thread_dispatch_ms(engine, sketches[:1])
    dispatches = []  # (batch, seconds) of each engine dispatch
    search_arrays = engine.search_arrays

    def timed_search_arrays(images):
        t = time.perf_counter()
        out = search_arrays(images)
        dispatches.append((len(images), time.perf_counter() - t))
        return out

    engine.search_arrays = timed_search_arrays
    httpd = serve.Server(("127.0.0.1", 0),
                         serve.make_handler(engine, batcher))
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    port = httpd.server_address[1]
    lat, tops, round_s = [], [], []
    try:
        for c in list(counters.values()) + [rf.positive_counters,
                                            rf.merge_counters]:
            c.reset()  # this path's run starts here
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        check(health["gallery_size"] == n_rows
              and health["shards"] == shards, "/healthz gallery size, shards")
        if route.startswith("ivf"):
            check("ivf" in health and ("pq" in health) == (route == "ivf_pq"),
                  "/healthz carries the index's stats")
        if state.get("pil", True):
            from PIL import Image

            def png(a):
                buf = io.BytesIO()
                Image.fromarray(a).save(buf, "PNG")
                return base64.b64encode(buf.getvalue()).decode()

            b64 = [png(s) for s in sketches]

            def one(i):
                t = time.perf_counter()
                out = _post(port, "/search", {"image_b64": b64[i]})
                return time.perf_counter() - t, out["paths"][0]

            t_all = time.perf_counter()
            with ThreadPoolExecutor(8) as pool:
                for _ in range(rounds):
                    t_round = time.perf_counter()
                    res = list(pool.map(one, range(8)))
                    round_s.append(time.perf_counter() - t_round)
                    lat += [r[0] for r in res]
                    tops += [r[1] for r in res]
            wall = time.perf_counter() - t_all
            n_timed = len(dispatches)
            t = time.perf_counter()
            batch = _post(port, "/search_batch", {"images_b64": b64})
            search_batch_ms = 1e3 * (time.perf_counter() - t)
            tops += [r["paths"][0] for r in batch["results"]]
            transport = "http"
        else:  # no PIL on this machine: the engine, from 8 threads
            def one(i):
                t = time.perf_counter()
                _, idx = engine.search_arrays(sketches[i:i + 1])
                return time.perf_counter() - t, paths[int(idx[0, 0])]

            t_all = time.perf_counter()
            with ThreadPoolExecutor(8) as pool:
                for _ in range(rounds):
                    t_round = time.perf_counter()
                    res = list(pool.map(one, range(8)))
                    round_s.append(time.perf_counter() - t_round)
                    lat += [r[0] for r in res]
                    tops += [r[1] for r in res]
            wall = time.perf_counter() - t_all
            n_timed = len(dispatches)
            t = time.perf_counter()
            _, idx = engine.search_arrays(sketches)
            search_batch_ms = 1e3 * (time.perf_counter() - t)
            tops += [paths[int(i)] for i in idx[:, 0]]
            transport = "search_arrays from 8 threads (no PIL)"
        torch.cuda.synchronize()
        launches = {name: c.launches for name, c in counters.items()}
        merges = rf.merge_counters.launches
        fallback = (counters[route].fallback_rows if route in counters
                    else 0)
        n_dispatch = len(dispatches)
        engine.search_arrays = search_arrays
        profile = _profile_dispatch(engine, sketches, prefix=route.lower())
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
        server.join(timeout=10)
    want = [paths[s] for s in slots] * (rounds + 1)
    check(tops == want, "each top-1 is its planted row")
    if route in counters:
        check(launches[route] == cards * n_dispatch,
              f"{route} launched once a card ({cards}) a dispatch over "
              f"{shards} shard(s) on the main path")
        key = route if mesh is None else route + "_sharded"
        state["launches"][key] = (state["launches"].get(key, 0)
                                  + launches[route])
    # the sharded int8 route merges its shards' runs in K1's merge kernel
    # once a dispatch; sharded K1 on one card merges inside its own launch
    want_merges = n_dispatch if mesh is not None and route == "K2" else 0
    check(merges == want_merges, f"the cross-shard merge launched "
          f"{want_merges} times on this path, got {merges}")
    state["launches"]["K1_merge_shards"] = (
        state["launches"].get("K1_merge_shards", 0) + merges)
    check(all(v == 0 for name, v in launches.items() if name != route),
          f"no other kernel than {route} launched on this path")
    check(fallback == 0, f"{route} never fell back")
    n_req = 8 * rounds
    timed = dispatches[:n_timed]
    dispatch_ms = [1e3 * t for _, t in timed]
    del engine
    emit({"phase": phase, "ok": True, "transport": transport,
          "gallery": n_rows, "dim": D, "route": route, "shards": shards,
          "clients": 8, "requests": n_req, "failed": 0, "qps": n_req / wall,
          "p50_ms": 1e3 * float(np.median(lat)),
          "p90_ms": 1e3 * float(np.percentile(lat, 90)),
          "max_ms": 1e3 * max(lat),
          "mean_batch": float(np.mean([b for b, _ in timed])),
          "batches": len(timed), "dispatches": n_dispatch,
          "launches": launches, "merge_launches": merges,
          "fallback_rows": fallback,
          "round_ms_first5": [1e3 * r for r in round_s[:5]],
          "round_ms_max": 1e3 * max(round_s),
          "dispatch_ms_p50": float(np.median(dispatch_ms)),
          "dispatch_ms_max": max(dispatch_ms),
          "dispatch_share_of_wall": sum(t for _, t in timed) / wall,
          "search_batch_of_8_ms": search_batch_ms,
          "fresh_thread_dispatch_ms": thread_ms,
          "save_cache_s": save_s, "build_engine_s": build_s,
          "warmup_s": warmup_s,
          "peak_gpu_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          **({"index": {k: health[k] for k in ("ivf", "pq") if k in health},
              "startup_s": startup} if route.startswith("ivf") else {}),
          **(extra or {})})
    emit({"phase": phase + "_profile", **profile})


def _fresh_thread_dispatch_ms(engine, images) -> list:
    """Two dispatches on each of two threads started one after the other
    (an HTTP handler thread is new for every connection): the first use
    of the CUDA libraries on a thread shows as a slow first dispatch."""
    import threading

    import torch

    out = []

    def run():
        for _ in range(2):
            t = time.perf_counter()
            engine.search_arrays(images)
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t))

    for _ in range(2):
        th = threading.Thread(target=run)
        th.start()
        th.join(timeout=120)
        check(not th.is_alive(), "dispatch on a fresh thread finished")
    return out


def _profile_dispatch(engine, sketches, prefix: str, reps: int = 3) -> dict:
    """Where one coalesced dispatch of 8 queries spends its time: wall
    clock, summed device kernel time by name (torch.profiler), the time of
    the route's kernels (names holding ``<prefix>_`` or ``<prefix>::``), and
    the share of the wall clock with the device idle. Runs after the counted main path; its
    launches are not counted there."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine.search_arrays(sketches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            engine.search_arrays(sketches)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps
    kernels = {}  # device-side events only: kernels and copies
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total:
            kernels[ev.key] = (kernels.get(ev.key, 0.0)
                               + ev.self_device_time_total / 1e3 / reps)
    device_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    kernel_ms = sum(v for k, v in kernels.items()
                    if f"{prefix}_" in k or f"{prefix}::" in k)
    return {"batch": len(sketches), "wall_ms": 1e3 * wall,
            "device_ms": device_ms, f"{prefix}_device_ms": kernel_ms,
            "device_idle_share": max(0.0, 1 - device_ms / (1e3 * wall)),
            "kernels_seen": len(kernels),
            "top_device_ms": [[k[:60], v] for k, v in top]}


# -------------------------------------------------------------------- ivf

IVF_N = 1_000_000  # the IVF phases' gallery
IVF_EXACT_N = 100_000  # ivf_search at full probe against retrieve
PQ_EXACT_N = 20_000  # IVF-PQ at full probe, covering rerank, against retrieve
PQ_M = 64  # bytes a row of the IVF-PQ codes
NPROBES = (1, 2, 4, 8, 16, 32, 64)  # the recall sweep
ONLINE_CAP = 100_000  # the online IVF's buffer


def _blob_geometry(n: int, seed: int, n_extra: int = 0):
    """(n rows, n_extra held-out rows) on the card, float32: the JAX
    probe's clustered geometry (``scripts/probe_ivf.py``): max(4, sqrt(n))
    blob centres drawn as 4 N(0, 1), each row a uniformly drawn centre
    plus 0.5 N(0, 1). numpy draws every number from ``seed`` (the noise in
    8 threads, one spawned stream each)."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    s_c, s_a, *s_n = np.random.SeedSequence(seed).spawn(10)
    n_blobs = max(4, int(np.sqrt(n)))
    centres = 4.0 * np.random.default_rng(s_c).standard_normal(
        (n_blobs, D), dtype=np.float32)
    centres = torch.from_numpy(centres).cuda()
    total = n + n_extra
    assign = np.random.default_rng(s_a).integers(0, n_blobs, total)
    cuts = np.linspace(0, total, len(s_n) + 1).astype(int)

    def noise(i):
        return np.random.default_rng(s_n[i]).standard_normal(
            (cuts[i + 1] - cuts[i], D), dtype=np.float32)

    out = torch.empty((total, D), device="cuda")
    with ThreadPoolExecutor(len(s_n)) as pool:
        for i, part in enumerate(pool.map(noise, range(len(s_n)))):
            lo, hi = cuts[i], cuts[i + 1]
            at = torch.from_numpy(assign[lo:hi]).cuda()
            out[lo:hi] = centres[at] + 0.5 * torch.from_numpy(part).cuda()
    return out[:n], out[n:]


def _near_exact(got, want, q, g, metric: str, what: str) -> dict:
    """``got`` = (values, indices) against the exact route's ``want``,
    which scores the pairwise (expanded) form, where the probes score
    each row directly: the two forms differ by the expanded form's float32
    cancellation: 1e-5 x (|q|^2 + |g|^2) on a squared euclidean distance
    (the reach ``tests/test_torch_serve.py`` allows) and 1e-5 on a cosine
    distance (the same share of the cross term's scale, |q| |g|; a
    float32 sum of 1,024 products errs by about sqrt(1024) x 2^-24 of it
    typically and 1024 x 2^-24 at worst). Values are held within that
    reach plus rtol 1e-5; indices equal but for near-ties, an index whose
    distance lies within the reach of the value at its place in ``want``
    (or, past the k-th, of the k-th value); their count is returned."""
    import torch

    vals, idx = (t.double() for t in got)
    ev, ei = want[0].double(), want[1].long()
    idx = idx.long()
    if metric == "euclidean":
        v, e = vals ** 2, ev ** 2
        norms = (g.double() ** 2).sum(1)
        qq = (q.double() ** 2).sum(1, keepdim=True)
        tol = 1e-5 * e + 1e-5 * (2 * qq + norms[idx.clamp(max=len(g) - 1)]
                                 + norms[ei.clamp(max=len(g) - 1)])
    else:
        v, e = vals, ev
        tol = 1e-5 * e.abs() + 1e-5
    over = float(((v - e).abs() / tol).max())
    check(over <= 1.0,
          f"{what}: the exact route's values within the expanded form's "
          f"reach (worst {over:.3g} of it)")
    differ = (idx != ei).nonzero().tolist()
    for r, j in differ:
        at = (ei[r] == idx[r, j]).nonzero()
        ref = e[r, int(at[0, 0])] if len(at) else e[r, -1]
        check(bool((v[r, j] - ref).abs() <= tol[r, j]),
              f"{what}: query {r}'s index {j} differs from the exact "
              "route's beyond a near-tie")
    return {"max_rel_err": float(((vals - ev).abs()
                                  / ev.abs().clamp_min(1e-12)).max()),
            "near_tie_swaps": len(differ)}


def _held_exact(got, q, g, metric: str, what: str) -> dict:
    """:func:`_near_exact` against ``ops/distance.retrieve``."""
    import torch

    from art_sbir_tpu_torch.ops.distance import retrieve

    _, ev, ei = retrieve(q, g, torch.zeros(len(q), dtype=torch.int32,
                                           device=q.device),
                         k=int(got[0].shape[1]), metric=metric)
    return _near_exact(got, (ev, ei), q, g, metric, what)


def _missing_in_float64(q, g, index, exact, got, nprobe: int) -> dict:
    """Each neighbour of the exact route's top-k that the probe at
    ``nprobe`` misses, recomputed in float64 beside the exact route's k-th
    (squared euclidean): inside the expanded form's float32 reach of the
    k-th (:func:`_near_exact`'s, 1e-5 x (d + 2|q|^2 + |g_m|^2 + |g_k|^2))
    it is a near-tie that the exact route's cancellation can order either
    way. Outside it, a miss whose cluster the probe visited is a fault of
    ``ops/ivf.py``; one whose cluster it did not visit is the probe's
    approximation."""
    import torch

    from art_sbir_tpu_torch.ops import ivf

    exact, got = exact.long(), got.long()
    missing = [(r, int(m)) for r in range(len(q))
               for m in set(exact[r].tolist()) - set(got[r].tolist())]
    n = len(g)
    label = torch.full((n,), -1, dtype=torch.long, device=g.device)
    rows = index.row_ids.long()
    cluster = torch.arange(rows.shape[0], device=g.device)[:, None].expand_as(
        rows)
    label[rows[rows < n]] = cluster[rows < n]
    probed = ivf._probe(q.float(), index.centroids, index.metric, nprobe)
    inside = outside_unprobed = 0
    faults, worst = [], 0.0
    for r, m in missing:
        q64 = q[r].double()
        kth = int(exact[r, -1])
        d_m = float(((g[m].double() - q64) ** 2).sum())
        d_k = float(((g[kth].double() - q64) ** 2).sum())
        reach = 1e-5 * (d_k + 2 * float((q64 ** 2).sum())
                        + float((g[m].double() ** 2).sum())
                        + float((g[kth].double() ** 2).sum()))
        worst = max(worst, abs(d_m - d_k) / reach)
        if abs(d_m - d_k) <= reach:
            inside += 1
        elif bool((probed[r] == label[m]).any()):
            faults.append({"query": r, "row": m, "d64": d_m, "kth_d64": d_k})
        else:
            outside_unprobed += 1
    check(not faults, f"IVF at nprobe {nprobe}: {len(faults)} missing "
          f"neighbours outside float32 reach in probed clusters: "
          f"{faults[:3]}")
    return {"missing": len(missing), "inside_reach": inside,
            "outside_reach_unprobed": outside_unprobed,
            "outside_reach_probed": len(faults),
            "worst_gap_over_reach": worst}


def _engine_proxy(g, n: int):
    """The serving engine's auto-nprobe proxy: 256 perturbed gallery rows
    drawn with numpy's ``default_rng(0)``."""
    import torch

    prng = np.random.default_rng(0)
    sel = prng.integers(0, n, min(256, n))
    rows = g[torch.as_tensor(sel, device=g.device)].cpu().numpy()
    proxy = rows + 0.05 * rows.std() * prng.standard_normal(
        rows.shape).astype(np.float32)
    return torch.from_numpy(proxy).to(g.device), sel


def phase_ivf(state) -> None:
    """The IVF and IVF-PQ library at D = 1024 on the JAX probe's clustered
    geometry: full probe against the exact route (10^5 rows, both
    metrics), the 10^6-row build and its recall sweep, the engine's auto
    nprobe, search times beside K1's float32 form, IVF-PQ (build steps,
    recall by rerank factor, pure self-retrieval, OPQ's rotation, times),
    a covering rerank at full probe against the exact route (20,000
    rows), and the saved index loaded back answering bit for bit."""
    import torch

    from art_sbir_tpu_torch.ops import ivf, pq
    from art_sbir_tpu_torch.ops import retrieval_fused as rf
    from art_sbir_tpu_torch.ops.distance import retrieve_chunked
    from art_sbir_tpu_torch.ops.quant import topk_overlap

    t_phase = time.perf_counter()
    dev = torch.device("cuda")

    def zeros(q):
        return torch.zeros(q, dtype=torch.int32, device=dev)

    line = {"phase": "ivf", "ok": True, "rows": IVF_N, "dim": D, "k": K}
    g, q = _blob_geometry(IVF_EXACT_N, seed=11, n_extra=64)
    line["full_probe_vs_exact"] = {}
    for metric in ("euclidean", "cosine"):
        idx = ivf.build_ivf(g, metric=metric)
        line["full_probe_vs_exact"][metric] = _held_exact(
            ivf.ivf_search(q, idx, g, nprobe=idx.nlist, k=K), q, g, metric,
            f"ivf_search {metric} at nprobe == nlist over {IVF_EXACT_N} rows")
    del g, q, idx
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    g, held = _blob_geometry(IVF_N, seed=12, n_extra=1024)
    line["gallery_s"] = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(12)
    queries = held + 0.05 * held.std() * torch.randn(
        held.shape, generator=gen, device=dev)
    del held
    t0 = time.perf_counter()
    index = ivf.build_ivf(g)  # ends in a host copy of the labels
    line["build_s"] = time.perf_counter() - t0
    line["stats"] = index.stats()
    _, _, exact = retrieve_chunked(queries, g, zeros(len(queries)), k=K,
                                   chunk=256)
    found = {p: ivf.ivf_search(queries, index, g, nprobe=p, k=K)[1]
             for p in NPROBES}
    line["recall_at_nprobe"] = {str(p): topk_overlap(found[p], exact)
                                for p in NPROBES}
    line["missing_vs_float64"] = {
        str(p): _missing_in_float64(queries, g, index, exact, found[p], p)
        for p in NPROBES if p >= 4}
    del found
    proxy, sel = _engine_proxy(g, IVF_N)
    t0 = time.perf_counter()
    tuned = ivf.tune_nprobe(index, g, proxy, k=K,
                            margin=ivf.SERVING_NPROBE_MARGIN)
    line["tune_s"] = time.perf_counter() - t0
    _, _, proxy_exact = retrieve_chunked(proxy, g, zeros(len(proxy)), k=K,
                                         chunk=256)
    proxy_recall = topk_overlap(ivf.ivf_search(proxy, index, g,
                                               nprobe=tuned, k=K)[1],
                                proxy_exact)
    check(proxy_recall >= 0.95,
          f"recall@10 at the tuned nprobe {tuned} on the proxy set "
          f"({proxy_recall}) >= 0.95")
    line.update(tuned_nprobe=tuned, proxy_recall_at_tuned=proxy_recall,
                recall_at_tuned=topk_overlap(ivf.ivf_search(
                    queries, index, g, nprobe=tuned, k=K)[1], exact))
    gg = rf.gallery_norms(g, "euclidean")
    r = tuned * index.pad_width
    times = []
    for b in (1, 8, 32):
        qb = queries[:b].contiguous()

        def search():
            return ivf.ivf_search(qb, index, g, nprobe=tuned, k=K)

        def k1():
            return rf.retrieve_fused(qb, g, zeros(b), k=K, with_ranks=False,
                                     gg=gg)

        gathered = b * r * D * 4
        times.append({
            "b": b, "ms": time_ms(search, reps=10),
            "device_ms": device_ms(search, reps=5),
            "candidates_a_query": r, "gathered_mb": gathered / 1e6,
            "gathered_read_once_ms": 1e3 * gathered / H100_BYTES_PER_S,
            "k1_f32_ms": time_ms(k1, reps=10),
            "k1_bound_ms": bound(4 * IVF_N * D, 2 * b * IVF_N * D,
                                 H100_F32_FLOP_PER_S)[0]})
    line["search_times"] = times
    del gg

    # IVF-PQ over the same rows
    steps = {}
    t0 = time.perf_counter()
    cb, codes = pq.build_ivf_pq(g, index, PQ_M, timings=steps)
    line["pq"] = {"m": PQ_M, "build_s": time.perf_counter() - t0, **steps}
    rows16 = g.to(torch.bfloat16)
    line["pq"]["recall_at_rerank_factor"] = {
        str(f): topk_overlap(pq.ivf_pq_search(
            queries, index, codes, cb, nprobe=tuned, k=K, rows=rows16,
            rerank_factor=f)[1], exact) for f in (4, 16, 64)}
    line["pq"]["recall_pure"] = topk_overlap(pq.ivf_pq_search(
        queries, index, codes, cb, nprobe=tuned, k=K)[1], exact)
    selt = torch.as_tensor(sel, device=dev)
    _, self_ids = pq.ivf_pq_search(g[selt], index, codes, cb, nprobe=tuned,
                                   k=1)
    hits = int((self_ids[:, 0].long() == selt).sum())
    check(hits == len(sel), f"pure IVF-PQ self-retrieval: {hits} of "
          f"{len(sel)} gallery rows find themselves first")
    samp = torch.randperm(IVF_N, generator=torch.Generator().manual_seed(3))[
        :16384].to(dev)
    lab = ivf._assign(g[samp], index.centroids, chunk=16384).long()
    t0 = time.perf_counter()
    opq = pq.train_pq(g[samp] - index.centroids[lab], PQ_M, opq_iters=2)
    rot = opq.rotation
    orth = float((rot @ rot.T - torch.eye(D, device=dev)).abs().max())
    check(orth <= 1e-4, f"OPQ's rotation orthogonal to 1e-4 ({orth})")
    line["pq"].update(self_hits=hits, opq_train_s=time.perf_counter() - t0,
                      opq_orthogonality_err=orth)
    pq_times = []
    for b in (8, 32):
        qb = queries[:b].contiguous()

        def pq_search():
            return pq.ivf_pq_search(qb, index, codes, cb, nprobe=tuned, k=K,
                                    rows=rows16, rerank_factor=64)

        pq_times.append({"b": b, "ms": time_ms(pq_search, reps=10),
                         "device_ms": device_ms(pq_search, reps=5)})
    line["pq"]["search_times"] = pq_times

    # the saved index loads back and answers bit for bit
    files = Path(state["tmp"]) / "ivf_files"
    files.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    ivf.save_ivf(index, files / "ivf.npz")
    pq.save_pq(cb, codes, files / "pq.npz")
    line["save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = ivf.load_ivf(files / "ivf.npz", device=dev)
    lcb, lcodes = pq.load_pq(files / "pq.npz", device=dev)
    line["load_s"] = time.perf_counter() - t0
    q64 = queries[:64]
    for a, b in ((ivf.ivf_search(q64, index, g, nprobe=tuned, k=K),
                  ivf.ivf_search(q64, loaded, g, nprobe=tuned, k=K)),
                 (pq.ivf_pq_search(q64, index, codes, cb, nprobe=tuned, k=K,
                                   rows=rows16, rerank_factor=64),
                  pq.ivf_pq_search(q64, loaded, lcodes, lcb, nprobe=tuned,
                                   k=K, rows=rows16, rerank_factor=64))):
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              "the loaded index answers bit for bit as the built one")
    del g, rows16, codes, lcodes, index, loaded, queries, exact
    torch.cuda.empty_cache()

    g, q = _blob_geometry(PQ_EXACT_N, seed=13, n_extra=64)
    idx = ivf.build_ivf(g)
    cb, codes = pq.build_ivf_pq(g, idx, PQ_M)
    line["pq"]["full_probe_covering_rerank_vs_exact"] = _held_exact(
        pq.ivf_pq_search(q, idx, codes, cb, nprobe=idx.nlist, k=K, rows=g,
                         rerank_factor=PQ_EXACT_N),
        q, g, "euclidean", f"IVF-PQ at full probe, a covering rerank, "
        f"over {PQ_EXACT_N} rows")
    line["phase_s"] = time.perf_counter() - t_phase
    emit(line)
    torch.cuda.empty_cache()


def _clustered_cache(tmp, n: int, planted: np.ndarray, seed: int):
    """(cache folder, paths, planted slots, seconds to save): ``n`` rows
    of :func:`_blob_geometry` scaled to the planted rows' mean and spread,
    the planted rows at seeded slots, written as a feature cache."""
    from art_sbir_tpu_torch.retrieval.embed import save_image_features

    rows, _ = _blob_geometry(n, seed)
    feats = rows.cpu().numpy()
    del rows
    feats *= planted.std() / np.sqrt(16.25)  # the blob rows' spread: 4.03
    feats += planted.mean()
    slots = np.random.default_rng(seed).choice(n, 8, replace=False)
    feats[slots] = planted
    paths = [f"gallery/{i:07d}.jpg" for i in range(n)]
    t0 = time.perf_counter()
    folder = save_image_features("ChipSmoke", "Clustered", paths, feats,
                                 root=tmp, timestamp=f"seed{seed}")
    return folder, paths, slots, time.perf_counter() - t0


def _ivf_args(folder, tmp, *flags):
    from art_sbir_tpu_torch.cli import serve

    return serve.parse_args([
        "-f", "ModifiedResNet_ChipSmoke", "--features", folder,
        "--feature_root", str(tmp), "--results_root", str(tmp),
        "--models_root", str(tmp), "--device", "cuda", "--window_ms", "5",
        "--ivf_nlist", "0", "--ivf_nprobe", "0", *flags])


def phase_serve_ivf(state) -> None:
    """``serve_ivf`` and ``serve_ivf_pq``: the serving path at full width
    over 10^6 clustered rows with the 8 planted sketches' rows, through
    :func:`_serve_engine` as ``serve`` is; ``--ivf_nlist 0 --ivf_nprobe
    0``, then ``--pq_m 64`` (bf16 rerank rows, factor 64) started twice
    with ``--index_cache``: the second start loads the first's files."""
    import gc
    import shutil
    import tempfile

    import torch

    from art_sbir_tpu_torch.cli import serve

    sketches = _sketches(8)
    need = 2 * 4 * IVF_N * D
    n = (IVF_N if shutil.disk_usage(tempfile.gettempdir()).free >= need
         else IVF_N // 2)
    with tempfile.TemporaryDirectory() as tmp:
        folder, paths, slots, save_s = _clustered_cache(
            tmp, n, _planted_rows(sketches), seed=0)
        _serve_engine(state, "serve_ivf", _ivf_args(folder, tmp), None, n,
                      "ivf", sketches, paths, slots, save_s)
        gc.collect()
        torch.cuda.empty_cache()
        args = _ivf_args(folder, tmp, "--pq_m", str(PQ_M), "--index_cache",
                         str(Path(tmp) / "index"))
        t0 = time.perf_counter()
        engine, batcher = serve.build_engine(args)
        first = {"build_engine_s": time.perf_counter() - t0,
                 "startup_s": dict(engine.startup_s)}
        batcher.close()
        check(not (first["startup_s"]["ivf_cached"]
                   or first["startup_s"]["pq_cached"]),
              "the first IVF-PQ start builds its index")
        del engine, batcher
        gc.collect()
        torch.cuda.empty_cache()
        _serve_engine(state, "serve_ivf_pq", args, None, n, "ivf_pq",
                      sketches, paths, slots, save_s,
                      extra={"first_start": first}, cached=True)
        gc.collect()
        torch.cuda.empty_cache()


def phase_online_ivf(state) -> None:
    """The online IVF at a capacity of 10^5 rows, half of them live at the
    build: adds that fill the largest cluster into the spill and force a
    repack, then removals, while a second thread searches. Every search of
    that thread returns live rows of the state it took and raises
    nothing; after each add or removal a search at ``nprobe == nlist``
    equals the masked exact route (:func:`_near_exact`)."""
    import threading

    import torch

    from art_sbir_tpu_torch.ops import ivf
    from art_sbir_tpu_torch.ops.distance import pairwise_distance, top_k

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    n0 = ONLINE_CAP // 2
    buf, held = _blob_geometry(ONLINE_CAP, seed=14, n_extra=8)
    t0 = time.perf_counter()
    oiv = ivf.build_ivf_online(buf, n0)
    build_s = time.perf_counter() - t0
    big = int(np.argmax(oiv._fill))
    free = len(oiv._free_t[big])
    spill = len(oiv._spill_np)
    n_add = free + spill + 64  # past the spill: a repack
    gen = torch.Generator(device="cuda").manual_seed(14)
    near = oiv.centroids[big] + 0.2 * torch.randn((n_add + 8, D),
                                                  generator=gen, device=dev)
    buf[n0:n0 + n_add] = near[:n_add]  # written before any add publishes
    queries = torch.cat([held, near[n_add:]])
    state_lock = threading.Lock()
    shared = {"mask": torch.arange(ONLINE_CAP, device=dev) < n0}
    stop, errors, searched = threading.Event(), [], []

    def searcher():
        while not stop.is_set():
            with state_lock:
                index, sp, mask = oiv.as_index(), oiv.spill, shared["mask"]
            try:
                vals, ids = ivf.ivf_search(queries[:4], index, buf,
                                           nprobe=16, k=K, mask=mask,
                                           spill=sp)
                live = ids[torch.isfinite(vals)].long()
                if not bool(mask[live].all()):
                    raise AssertionError("a search returned a dead row")
                searched.append(int(live.numel()))
            except Exception as e:  # reported by the main thread
                errors.append(repr(e))
                return

    def full_probe(what):
        with state_lock:
            index, sp, mask = oiv.as_index(), oiv.spill, shared["mask"]
        got = ivf.ivf_search(queries, index, buf, nprobe=index.nlist, k=K,
                             mask=mask, spill=sp)
        with torch.no_grad():
            want = top_k(pairwise_distance(queries, buf), K, valid=mask)
        swaps.append(_near_exact(
            got, want, queries, buf, "euclidean",
            f"online IVF after {what}: full probe against the masked exact "
            "route")["near_tie_swaps"])

    worker = threading.Thread(target=searcher)
    worker.start()
    spill_max, checks, swaps = 0, 0, []
    try:
        full_probe("the build")
        for lo in range(n0, n0 + n_add, 32):
            hi = min(lo + 32, n0 + n_add)
            with state_lock:
                oiv.add(list(range(lo, hi)), buf[lo:hi])
                mask = shared["mask"].clone()
                mask[lo:hi] = True
                shared["mask"] = mask
            spill_max = max(spill_max, oiv.stats()["spill_used"])
            full_probe(f"adding rows {lo}-{hi - 1}")
            checks += 1
        gone = list(range(0, 200, 10)) + list(range(n0, n0 + n_add, 7))
        for lo in range(0, len(gone), 16):
            batch = gone[lo:lo + 16]
            with state_lock:
                mask = shared["mask"].clone()
                for rid in batch:
                    oiv.remove(rid)
                    mask[rid] = False
                shared["mask"] = mask
            full_probe(f"removing {len(batch)} rows")
            checks += 1
    finally:
        stop.set()
        worker.join(timeout=120)
    check(not worker.is_alive() and not errors,
          f"the searching thread ran through the churn: {errors[:1]}")
    st = oiv.stats()
    check(spill_max > 0 and st["repacks"] >= 1,
          "the adds filled a cluster into the spill and forced a repack")
    check(st["live_rows"] == n0 + n_add - len(gone), "live rows counted")
    emit({"phase": "online_ivf", "ok": True, "capacity": ONLINE_CAP,
          "initial_rows": n0, "added": n_add, "removed": len(gone),
          "build_s": build_s, "spill_used_max": spill_max, "stats": st,
          "full_probe_checks": checks + 1, "near_tie_swaps": sum(swaps),
          "concurrent_searches": len(searched),
          "phase_s": time.perf_counter() - t_phase})
    del buf, oiv
    torch.cuda.empty_cache()


def _sharded_ivf(state, mesh) -> dict:
    """The sharded IVF routes on the mesh (4 shards of the one card), each
    at full probe against its single-device form: ShardedIVF and
    ShardedOnlineIVF against ivf_search and OnlineIVF (indices equal,
    values at rtol 1e-6), sharded IVF-PQ with a covering rerank against
    the exact route; then ``serve`` over the 4 shards with ``--ivf_nlist
    0`` at 10^5 rows."""
    import gc
    import tempfile

    import torch

    from art_sbir_tpu_torch.ops import ivf, pq

    def same(a, b, what):
        check(torch.equal(a[1].long(), b[1].long())
              and torch.allclose(a[0], b[0], rtol=1e-6, atol=1e-6),
              f"{what} at full probe equals its single-device form")

    out = {}
    g, q = _blob_geometry(SERVE_N, seed=15, n_extra=32)
    t0 = time.perf_counter()
    sh = ivf.build_ivf_sharded(g, SHARDS, devices=mesh.devices)
    out["sharded_build_s"] = time.perf_counter() - t0
    one = ivf.build_ivf(g)
    same(ivf.ivf_search_sharded(q, sh, g, mesh, nprobe=sh.nlist, k=K),
         ivf.ivf_search(q, one, g, nprobe=one.nlist, k=K), "ShardedIVF")
    out["sharded_stats"] = sh.stats()

    n0 = SERVE_N // 2  # the last two shards start empty
    so = ivf.build_ivf_sharded_online(g, n0, SHARDS, devices=mesh.devices)
    oo = ivf.build_ivf_online(g, n0)  # the same build: the same centroids
    mask = torch.arange(SERVE_N, device=g.device) < n0
    added = ((n0, n0 + n0 // 16), (SERVE_N - SERVE_N // 200, SERVE_N))
    for lo, hi in added:  # into shard 2, which starts empty, and shard 3
        so.add(list(range(lo, hi)), g[lo:hi])
        oo.add(list(range(lo, hi)), g[lo:hi])
        mask[lo:hi] = True
    for rid in (list(range(0, n0 // 50, 9))
                + list(range(n0, n0 + n0 // 16, 11))):
        so.remove(rid)
        oo.remove(rid)
        mask[rid] = False
    same(so.search(q, g, mesh, nprobe=so.nlist, k=K, mask=mask),
         oo.search(q, g, nprobe=oo.nlist, k=K, mask=mask),
         "ShardedOnlineIVF")
    out["sharded_online_stats"] = so.stats()
    del sh, one, so, oo

    g2, q2 = g[:PQ_EXACT_N], q
    sh2 = ivf.build_ivf_sharded(g2, SHARDS, devices=mesh.devices)
    cb, codes = pq.build_ivf_pq_sharded(g2, sh2, PQ_M)
    out["sharded_pq_full_probe_vs_exact"] = _held_exact(
        pq.ivf_pq_search_sharded(q2, sh2, codes, cb, mesh, nprobe=sh2.nlist,
                                 k=K, rows=g2, rerank_factor=PQ_EXACT_N),
        q2, g2, "euclidean", "sharded IVF-PQ, a covering rerank")
    del g, q, g2, sh2, codes
    gc.collect()
    torch.cuda.empty_cache()

    sketches = _sketches(8)
    with tempfile.TemporaryDirectory() as tmp:
        folder, paths, slots, save_s = _clustered_cache(
            tmp, SERVE_N, _planted_rows(sketches), seed=1)
        _serve_engine(state, "serve_ivf_sharded", _ivf_args(folder, tmp),
                      mesh, SERVE_N, "ivf", sketches, paths, slots, save_s)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -------------------------------------------------------------- inference

# the synthetic Sketchy corpus of the inference phases: 11,000 sketches,
# whose 10% test split gives about 1,100 queries
CORPUS = dict(n_classes=25, photos_per_class=110, sketches_per_photo=4)
RUN = "ModifiedResNet_SketchyV1_ChipSmoke"
K1_ROWS = 100_003  # the offline gallery of inference_k1
ROUTE_NS = (10_000, 25_000, 50_000, K1_ROWS, 1_000_000)  # route timings
ULPS = 8 * 2.0 ** -23  # the sample distances' floor (see _same_samples)
RANK_TOL = 2  # the kernels phase's rank tolerance (_compare)


STAT_KEYS = ("mean_reciprocal_rank", "size", "count", "mean", "std", "min",
             "25%", "50%", "75%", "max", "topk_acc")
ORDER_KEYS = ("min", "25%", "50%", "75%", "max")


def _scores(ranks: np.ndarray) -> dict:
    """MRR, the eight keys of pandas' ``describe()`` and topk_acc of the
    0-based ``ranks``, computed here (a sort, pandas' linear
    interpolation), apart from the port's ``_describe``."""
    r = np.sort(ranks.astype(np.float64)) + 1.0
    n = len(r)
    mean = r.sum() / n

    def at(p):
        h = p * (n - 1)
        lo = int(h)
        return r[lo] + (h - lo) * (r[min(lo + 1, n - 1)] - r[lo])

    return {"mean_reciprocal_rank": (1.0 / r).sum() / n, "count": float(n),
            "mean": mean, "std": float(np.sqrt(((r - mean) ** 2).sum()
                                               / (n - 1))),
            "min": r[0], "25%": at(0.25), "50%": at(0.5), "75%": at(0.75),
            "max": r[-1],
            "topk_acc": [np.count_nonzero(ranks <= j) / n for j in range(K)]}


def _check_scores(d: dict, ranks: np.ndarray, what: str) -> None:
    """The dict's MRR, rank statistics and topk_acc are those of
    ``ranks`` (rtol 1e-12: sums in another order)."""
    want = _scores(ranks)
    keys = [k for k in want if k != "topk_acc"]
    check(np.allclose([d[k] for k in keys] + list(d["topk_acc"]),
                      [want[k] for k in keys] + want["topk_acc"],
                      rtol=1e-12, atol=0.0),
          f"{what}: MRR, rank statistics and topk_acc come from its ranks")


def _dicts_within(a: dict, b: dict, ranks_b: np.ndarray, tol: np.ndarray,
                  what: str) -> dict:
    """Dict ``a``, whose ranks lie within ``tol`` (per query) of dict
    ``b``'s ``ranks_b``, against ``b`` key by key, by as much as ``tol``
    lets each key move: MRR by the mean of 1/(r - t + 1) - 1/(r + 1),
    topk_acc[j] by the share of queries with r - t <= j < r + t, the mean
    by the mean of t, the order statistics by the largest t, std by
    sqrt(sum t^2 / (Q - 1)); count and size equal. Exact where ``tol`` is
    0 everywhere. Returns each key's difference."""
    q = len(ranks_b)
    r, t = ranks_b.astype(np.float64), tol.astype(np.float64)
    lim = {"mean_reciprocal_rank": float(np.sum(
               1.0 / (np.maximum(r - t, 0) + 1) - 1.0 / (r + 1)) / q),
           "mean": float(t.sum() / q),
           "std": float(np.sqrt(np.sum(t * t) / max(q - 1, 1))),
           **{k: float(t.max(initial=0.0)) for k in ORDER_KEYS}}
    diff = {k: abs(a[k] - b[k]) for k in lim}
    ok = all(diff[k] <= lim[k] + 1e-12 * abs(b[k]) for k in lim)
    for j in range(K):
        straddle = np.count_nonzero((t > 0) & (r - t <= j) & (j < r + t))
        d = abs(a["topk_acc"][j] - b["topk_acc"][j])
        diff[f"topk_acc[{j}]"] = d
        ok = ok and d <= straddle / q + 1e-12
    check(ok and a["count"] == b["count"] and a["size"] == b["size"],
          f"{what}: the dicts within what the rank tolerance lets each key "
          "move")
    return diff


def _rank_tolerance(d, pos: np.ndarray, reach) -> np.ndarray:
    """Per query, the columns other than the positive whose distance in
    ``d`` (Q, N) lies within ``reach`` (a number, or (Q, 1)) of the
    positive's: how far two float32 computations of the same ranks may
    differ. 0 for a query without a positive."""
    import torch

    p = torch.as_tensor(np.where(pos < 0, 0, pos), device=d.device)[:, None]
    dpos = torch.gather(d, 1, p.long())
    near = (torch.sum(torch.abs(d - dpos) <= reach, dim=1) - 1).cpu().numpy()
    return np.where(pos < 0, 0, near)


def _chunked(fn, queries, gallery, chunk: int = 1024):
    """``fn(q, gallery)`` over the query chunks of evaluate_retrieval, so
    that each chunk sees the arithmetic (and the library's kernel choice)
    of the route it stands for."""
    import torch

    return torch.cat([fn(queries[s:s + chunk], gallery)
                      for s in range(0, queries.shape[0], chunk)])


def _same_topk(a: dict, b: dict, metric: str, qq: np.ndarray,
               gg: np.ndarray, what: str):
    """Every query's top-k in evaluate_retrieval's trace ``a`` against
    trace ``b``: the values position by position at rtol 1e-5 with the
    8-ulp floor of ``_same_samples`` (``qq``, ``gg``: the squared norms of
    the queries and the gallery rows), and the index sets equal, except
    that a column only one side holds must lie within twice that
    tolerance of the other side's k-th value (a near-tie at the k-th
    place). Returns (the largest |difference|, on squared distances for
    euclidean; the rows whose sets differ)."""
    va, vb = (t["values"].astype(np.float64) for t in (a, b))
    ia, ib = a["indices"], b["indices"]
    if metric == "euclidean":  # compared as squared distances
        va, vb = va * va, vb * vb
        lim = 1e-5 * vb + ULPS * (qq[:, None] + np.maximum(gg[ia], gg[ib]))
    else:
        lim = 1e-5 * np.abs(vb) + ULPS
    diff = np.abs(va - vb)
    check(bool((diff <= lim).all()),
          f"{what}: every query's top-k values within rtol 1e-5 and the "
          "8-ulp floor")
    a_in_b = (ia[:, :, None] == ib[:, None, :]).any(2)
    b_in_a = (ib[:, :, None] == ia[:, None, :]).any(2)
    near = 2 * lim[:, -1:]
    check(bool((a_in_b | (np.abs(va - vb[:, -1:]) <= near)).all()
               and (b_in_a | (np.abs(vb - va[:, -1:]) <= near)).all()),
          f"{what}: every query's top-k index set the same but for "
          "near-ties at the k-th place")
    return float(diff.max()), int(np.count_nonzero(~a_in_b.all(1)))


def _same_samples(got, want, metric, queries, gallery, sketch_paths,
                  image_paths):
    """The retrieval samples: the same queries; distances position by
    position at rtol 1e-5 with a floor of 8 float32 ulps of the terms that
    cancel, on the squared distance (euclidean: 8 * 2^-23 * (|q|^2 +
    |g|^2)) or on ``1 - cos`` (cosine: 8 * 2^-23); the same paths, except
    two columns whose distances lie within that tolerance may trade places
    (or one cross the k-th place). Returns (largest |difference|, the
    places that traded)."""
    q_row = {str(p): i for i, p in enumerate(sketch_paths)}
    g_row = {str(p): i for i, p in enumerate(image_paths)}
    check(len(got) == len(want), "the same number of retrieval samples")
    worst, traded = 0.0, 0
    for gs, ws in zip(got, want):
        (gk, gv), = gs.items()
        (wk, wv), = ws.items()
        check(gk == wk and len(gv) == len(wv),
              "retrieval samples: the same queries")
        a = np.array([x for _, x in gv], np.float64)
        b = np.array([x for _, x in wv], np.float64)
        worst = max(worst, float(np.abs(a - b).max()))
        if metric == "euclidean":  # compared as squared distances
            q = np.asarray(queries[q_row[gk]], np.float64)
            g2 = np.maximum(*(np.sum(np.asarray(
                gallery[[g_row[p] for p, _ in v]], np.float64) ** 2, axis=1)
                for v in (gv, wv)))
            a, b = a * a, b * b
            lim = 1e-5 * b + ULPS * (q @ q + g2)
        else:
            lim = 1e-5 * np.abs(b) + ULPS
        check(bool((np.abs(a - b) <= lim).all()), "retrieval sample "
              "distances within rtol 1e-5 and the 8-ulp floor")
        other = {p: x for (p, _), x in zip(wv, b)}
        for j, (path, _) in enumerate(gv):
            if path == wv[j][0]:
                continue
            traded += 1
            check((path in other and abs(other[path] - a[j]) <= 2 * lim[j])
                  or abs(a[j] - b[-1]) <= 2 * lim[j],
                  "retrieval samples: paths trade places only within the "
                  "distance tolerance")
    return worst, traded


def phase_inference(state) -> None:
    """``cli/inference.py`` end to end on the card over a synthetic Sketchy
    corpus with the full-width encoder, then ``cli/serve.py --folder``
    without ``--features`` over the same corpus."""
    import torch

    from art_sbir_tpu_torch.cli import inference, serve
    from art_sbir_tpu_torch.core.checkpoint import save_state_dict
    from art_sbir_tpu_torch.data import loader, native_loader
    from art_sbir_tpu_torch.data.synthetic import make_synthetic_sketchy
    from art_sbir_tpu_torch.models.resnet import create_encoder
    from art_sbir_tpu_torch.ops.distance import pairwise_distance
    from art_sbir_tpu_torch.retrieval import rank
    from art_sbir_tpu_torch.retrieval.embed import load_image_features
    from art_sbir_tpu_torch.retrieval.engine import rebuild_test_catalog

    check(state["pil"], "PIL is installed: the inference phase writes its "
          "corpus with it")
    tmp = Path(state["tmp"])
    t0 = time.perf_counter()
    root = make_synthetic_sketchy(tmp / "sketchy", **CORPUS)
    write_s = time.perf_counter() - t0
    run_dir = tmp / "results" / RUN
    run_dir.mkdir(parents=True)
    data_params = {"dataset": "SketchyDatasetV1", "size": 1.0}
    (run_dir / "data_params.json").write_text(json.dumps(data_params))
    (run_dir / "training_params.json").write_text(json.dumps(
        {"image_size": 224, "loss_type": "euclidean"}))
    # the full-width ModifiedResNet50, seed-0 weights, as the run's .pt
    save_state_dict(tmp / "models" / f"{RUN}.pt",
                    create_encoder(device="cuda", seed=0).state_dict())
    test_cat = rebuild_test_catalog(data_params, root)
    try:  # decode_paths' "auto": native where the library builds, else PIL
        native_loader.load()
        backend, native_error = "native", None
    except native_loader.NativeUnavailable as e:
        backend, native_error = "pil", str(e)[-400:]
    plots = importlib.util.find_spec("matplotlib") is not None
    args = ["--folder", RUN, "--results_root", str(tmp / "results"),
            "--models_root", str(tmp / "models"), "--data_root", str(root),
            "--feature_root", str(tmp / "features"), "--device", "cuda"]

    counters = _counters()
    trace = {}  # what run_inference saw: features, ranks, times
    for c in counters.values():  # this path's run starts here
        c.reset()
    t0 = time.perf_counter()
    folder = (RUN, tmp / "results", tmp / "models", root, "cuda",
              tmp / "features")
    if plots:
        inference.rerun_folder(*folder, trace=trace)
    else:  # no matplotlib on this host: the evaluation and its JSON
        out = inference.evaluate_folder(*folder, trace=trace)
        (run_dir / "inference_updated.json").write_text(
            json.dumps(out, indent=4, default=float))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    got = json.loads((run_dir / "inference_updated.json").read_text())

    keys = STAT_KEYS + ("inference_time", "retrieval_samples",
                        "image_features")
    check(set(got) == set(keys), "inference_updated.json has the reference "
          "keys")
    paths, gallery = load_image_features(got["image_features"],
                                         tmp / "features")
    n_gallery = len(set(test_cat.photo_paths))
    check(got["size"] == n_gallery == len(paths),
          "size is the deduplicated test gallery")
    check(np.isfinite(got["mean_reciprocal_rank"]), "MRR finite")
    check(all(b >= a for a, b in zip(got["topk_acc"], got["topk_acc"][1:])),
          "topk_acc does not decrease")
    (card,) = trace["passes"]
    check(n_gallery < rank.FUSED_GALLERY_THRESHOLD and card["route"] == "exact"
          and all(v == 0 for v in launches.values()),
          "a gallery below FUSED_GALLERY_THRESHOLD takes the exact route: "
          "no kernel launched")
    queries = card["queries"].cpu().numpy()
    check(np.array_equal(trace["gallery"].cpu().numpy(), gallery),
          "the cache holds the embedded gallery")
    check(bool(np.isfinite(queries).all()) and queries.shape
          == (len(test_cat), 1024), "query features finite, (Q, 1024)")
    # the same features ranked again on the CPU. The two float32 distance
    # matrices (cuBLAS and the CPU's, chunk by chunk as the route computes
    # them) differ by at most `moved`; a column can change sides of the
    # positive between them only where it lies within 2 * moved of the
    # positive's distance on the card, so a query's ranks may differ by at
    # most the columns there (exact where there are none)
    pos = rank.positive_indices(test_cat.sketch_paths, paths)
    cpu_trace = {}
    cpu = rank.evaluate_retrieval(queries, gallery, test_cat.sketch_paths,
                                  paths, device="cpu", trace=cpu_trace)
    card_ranks, cpu_ranks = card["ranks"], cpu_trace["ranks"]
    qt, gt = torch.from_numpy(queries), torch.from_numpy(gallery)
    d_card = _chunked(pairwise_distance, qt.cuda(), gt.cuda())
    moved = float(torch.max(torch.abs(
        d_card - _chunked(pairwise_distance, qt, gt).cuda())))
    rank_tol = _rank_tolerance(d_card, pos, 2.0 * moved)
    rank_diff = np.abs(card_ranks - cpu_ranks)
    bad = np.nonzero(rank_diff > rank_tol)[0]
    if bad.size:  # what the failure needs to be read: to stderr
        from art_sbir_tpu_torch.ops.distance import rank_of_positive

        d_cpu = _chunked(pairwise_distance, qt, gt)
        p_all = torch.as_tensor(np.where(pos < 0, 0, pos))
        again = {"card": rank_of_positive(d_card.cpu(), p_all).numpy(),
                 "cpu": rank_of_positive(d_cpu, p_all).numpy()}
        print(json.dumps({"inference_rank_failure": {
            "queries": int(bad.size), "moved": moved,
            "first": [{"query": int(i), "pos": int(pos[i]),
                       "card": int(card_ranks[i]), "cpu": int(cpu_ranks[i]),
                       "tol": int(rank_tol[i]),
                       "card_again": int(again["card"][i]),
                       "cpu_again": int(again["cpu"][i]),
                       "card_dpos": float(d_card[i, max(pos[i], 0)]),
                       "cpu_dpos": float(d_cpu[i, max(pos[i], 0)])}
                      for i in bad[:5]]}}), file=sys.stderr, flush=True)
    del d_card
    check(bool((rank_diff <= rank_tol).all()),
          "the card's ranks equal the CPU's but for columns within the two "
          "float32 matrices' difference of the positive's distance")
    _check_scores(got, card_ranks, "the card's dict")
    _check_scores(cpu, cpu_ranks, "the CPU's dict")
    dict_diff = _dicts_within(got, cpu, cpu_ranks, rank_tol,
                              "the card's dict against the CPU's")
    sample_err, traded = _same_samples(
        got["retrieval_samples"], cpu["retrieval_samples"], "euclidean",
        queries, gallery, test_cat.sketch_paths, paths)

    # serve --folder without --features over the same corpus
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    engine, batcher = serve.build_engine(serve.parse_args(
        args[:8] + ["--device", "cuda"]))
    build_s = time.perf_counter() - t0
    try:
        check(engine.image_paths == [str(p) for p in paths],
              "serve --folder: the evaluation's gallery paths")
        rows = engine.gallery.cpu().numpy()
        cos = np.sum(rows * gallery, 1) / (np.linalg.norm(rows, axis=1)
                                          * np.linalg.norm(gallery, axis=1))
        check(float(cos.min()) >= 0.999, "serve --folder: rows within the "
              "bf16 encoder's batch-to-batch tolerance (cosine >= 0.999)")
        sketches = loader.decode_paths(test_cat.sketch_paths[:8], 224,
                                       test_cat.resize_mode)
        t0 = time.perf_counter()
        vals, idx = engine.search_arrays(sketches)
        search_ms = 1e3 * (time.perf_counter() - t0)
        check(idx.shape == (8, 10) and bool(np.isfinite(vals).all())
              and bool((np.diff(vals, axis=1) >= 0).all())
              and bool((idx < len(paths)).all()),
              "serve --folder: 8 sketches searched, ascending finite "
              "distances")
        serve_launches = {name: c.launches for name, c in counters.items()}
        check(engine.route == "exact"
              and all(v == 0 for v in serve_launches.values()),
              "serve --folder over this gallery takes the exact route")
    finally:
        batcher.close()
    state["corpus"] = {"root": root, "cache": got["image_features"],
                       "test_cat": test_cat}
    emit({"phase": "inference", "ok": True, "corpus": CORPUS,
          "queries": len(test_cat), "gallery": n_gallery,
          "decode_backend": backend, "native_error": native_error,
          "plots": plots,
          "corpus_write_s": write_s, "wall_s": wall_s,
          "decode_s": trace["decode_s"],
          "embed_s": trace["gallery_embed_s"] + card["embed_s"],
          "rank_s": card["rank_s"],
          "split_note": "decode runs on embed_batched's prefetch thread, "
                        "inside embed_s; embed_s ends in a synchronize",
          "gallery_embed_images_per_s": n_gallery / trace["gallery_embed_s"],
          "mean_reciprocal_rank": got["mean_reciprocal_rank"],
          "topk_acc": got["topk_acc"], "launches": launches,
          "cpu_rank_diff_rows": int(np.count_nonzero(rank_diff)),
          "cpu_rank_max_diff": int(rank_diff.max()),
          "cpu_rank_tol_max": int(rank_tol.max()),
          "cpu_rank_tol_rows": int(np.count_nonzero(rank_tol)),
          "cpu_distance_max_abs_diff": moved,
          "cpu_stats_equal": all(got[k] == cpu[k] for k in STAT_KEYS),
          "cpu_dict_diff": dict_diff,
          "cpu_mrr": cpu["mean_reciprocal_rank"],
          "cpu_sample_max_abs_diff": sample_err,
          "cpu_sample_places_traded": traded,
          "serve_build_s": build_s, "serve_search_8_ms": search_ms,
          "serve_rows_cos_min": float(cos.min()),
          "serve_rows_bit_identical": bool(np.array_equal(rows, gallery)),
          "serve_rows_max_abs_diff": float(np.abs(rows - gallery).max())})


def _k1_gallery(real, real_paths, n: int, seed: int):
    """(n, D) float32 rows: the ``real`` rows at seeded random slots, the
    rest random with the real rows' per-dimension mean and spread, under
    stems (``r0000000``) that match no sketch."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    real = torch.as_tensor(real, device="cuda")
    feats = (torch.randn((n, real.shape[1]), generator=gen, device="cuda")
             * real.std(0) + real.mean(0))
    slots = torch.randperm(n, generator=gen, device="cuda")[:len(real)]
    feats[slots] = real
    paths = [f"random/r{i:07d}.jpg" for i in range(n)]
    for s, p in zip(slots.tolist(), real_paths):
        paths[s] = str(p)
    return feats.cpu().numpy(), paths


def _route_times(gen) -> list:
    """evaluate_retrieval whole (host work included) on K1's route and on
    the exact route at Q = 1,024 over random galleries of ROUTE_NS rows;
    the better of two calls, one call at 10^6 rows. ``host_s``: its
    positive lookup over the N paths alone (``positive_indices``), which
    both routes run. ``*_rank_ms``: each route's ranking of the chunk alone
    (CUDA events; K1's with the gallery norms and its certificate read)."""
    import torch

    from art_sbir_tpu_torch.ops import retrieval_fused as rf
    from art_sbir_tpu_torch.ops.distance import retrieve
    from art_sbir_tpu_torch.retrieval import rank

    q = 1024
    image_paths = [f"g/g{i}.jpg" for i in range(max(ROUTE_NS))]
    saved, rows = rank.FUSED_GALLERY_THRESHOLD, []
    try:
        for n in ROUTE_NS:
            g = torch.randn((n, D), generator=gen, device="cuda")
            pos = torch.randint(0, n, (q,), generator=gen, device="cuda")
            x = g[pos] + torch.randn((q, D), generator=gen, device="cuda")
            sketch_paths = [f"s/g{p}-1.png" for p in pos.tolist()]
            t0 = time.perf_counter()
            rank.positive_indices(sketch_paths, image_paths[:n])
            row = {"n": n, "q": q, "host_s": time.perf_counter() - t0}
            reps = 1 if n >= 1_000_000 else 2
            row["k1_rank_ms"] = time_ms(lambda: rf.retrieve_fused(
                x, g, pos, k=K, gg=rf.gallery_norms(g, "euclidean")),
                reps=reps + 1, warmup=1)
            row["exact_rank_ms"] = time_ms(lambda: retrieve(x, g, pos, k=K),
                                           reps=reps + 1, warmup=1)
            for name, threshold in (("k1_route_s", 0),
                                    ("exact_route_s", n + 1)):
                rank.FUSED_GALLERY_THRESHOLD = threshold
                best = float("inf")
                for _ in range(reps):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    rank.evaluate_retrieval(x, g, sketch_paths,
                                            image_paths[:n])
                    best = min(best, time.perf_counter() - t0)
                row[name] = best
                torch.cuda.empty_cache()
            rows.append(row)
            del g, x, pos
    finally:
        rank.FUSED_GALLERY_THRESHOLD = saved
    return rows


def phase_inference_k1(state) -> None:
    """``run_inference`` over a feature cache of K1_ROWS rows (the corpus's
    test photos under their real paths, random rows beside them), both
    metrics, on K1's route and, with the threshold raised, the exact one;
    then both routes timed by gallery size and K1 at Q = 1,024 with
    ranks."""
    import torch

    from art_sbir_tpu_torch.ops import retrieval_fused as rf
    from art_sbir_tpu_torch.ops.distance import (PAIRWISE_EPS,
                                                 pairwise_cosine,
                                                 pairwise_sq_l2)
    from art_sbir_tpu_torch.retrieval import engine as engine_mod
    from art_sbir_tpu_torch.retrieval import rank
    from art_sbir_tpu_torch.retrieval.embed import (load_image_features,
                                                    save_image_features)
    from art_sbir_tpu_torch.train.prepare import finish_gallery_batch

    tmp = Path(state["tmp"])
    corpus = state["corpus"]
    test_cat = corpus["test_cat"]
    real_paths, real = load_image_features(corpus["cache"], tmp / "features")
    feats, paths = _k1_gallery(real, real_paths, K1_ROWS, seed=5)
    t0 = time.perf_counter()
    cache = save_image_features("ChipSmoke", "SketchyK1", paths, feats,
                                root=tmp / "features", timestamp="k1")
    save_s = time.perf_counter() - t0
    state["k1_cache"] = cache
    gallery = torch.from_numpy(feats).cuda()
    gg = np.sum(feats.astype(np.float64) ** 2, axis=1)
    del feats
    pos = rank.positive_indices(test_cat.sketch_paths, paths)
    model, restored = engine_mod.restore_encoder(RUN, {}, tmp / "models",
                                                 torch.device("cuda"))
    check(restored, "the run's encoder restored from its .pt")

    def forward(x):
        return model(finish_gallery_batch(x))

    q = len(test_cat)
    chunks = -(-q // 1024)
    counters = _counters()
    metrics, main_launches = [], 0
    for metric in ("euclidean", "cosine"):
        out, tr = {}, {}
        for route, threshold in (("k1", rank.FUSED_GALLERY_THRESHOLD),
                                 ("exact", K1_ROWS + 1)):
            trace = {}
            saved = rank.FUSED_GALLERY_THRESHOLD
            rank.FUSED_GALLERY_THRESHOLD = threshold
            try:
                for c in counters.values():  # the main path's run
                    c.reset()
                t0 = time.perf_counter()
                out[route] = engine_mod.run_inference(
                    forward, test_cat, feature_folder=cache,
                    loss_type=metric, image_size=224,
                    feature_root=tmp / "features", device="cuda",
                    trace=trace)
                out[route]["wall_s"] = time.perf_counter() - t0
                launches = {n: c.launches for n, c in counters.items()}
                fallback = rf.counters.fallback_rows
            finally:
                rank.FUSED_GALLERY_THRESHOLD = saved
            (tr[route],) = trace["passes"]
            if route == "k1":
                check(tr[route]["route"] == "K1" and launches["K1"] == chunks
                      and fallback == 0
                      and all(v == 0 for n, v in launches.items()
                              if n != "K1"),
                      f"K1 launched once per query chunk ({chunks}), never "
                      f"fell back, alone ({metric})")
                main_launches += launches["K1"]
            else:
                check(tr[route]["route"] == "exact"
                      and all(v == 0 for v in launches.values()),
                      f"the raised threshold takes the exact route ({metric})")
        qt = tr["exact"]["queries"]
        check(bool(torch.equal(tr["k1"]["queries"], qt)),
              "the queries embed to the same features in both calls")
        # every query's top-k on K1's route against the exact route's,
        # before the rank reach below may use their difference
        qn = qt.cpu().numpy()
        moved_by, set_rows = _same_topk(
            tr["k1"], tr["exact"], metric,
            np.sum(qn.astype(np.float64) ** 2, axis=1), gg,
            f"K1's route against the exact route ({metric})")
        # the rank tolerance of the probe_k1 phase: the columns within
        # reach of the positive's distance (twice the largest value error
        # between the routes' top-k, held above to rtol 1e-5 and the 8-ulp
        # floor; at least 4 ulp of the positive's distance), counted on
        # the exact route's own distances, squared for euclidean as K1
        # ranks. No floor: a query with no column there ranks exactly
        if metric == "euclidean":
            d = _chunked(lambda a, b: pairwise_sq_l2(a, b, eps=PAIRWISE_EPS),
                         qt, gallery)
        else:
            d = _chunked(pairwise_cosine, qt, gallery)
        p = torch.as_tensor(np.where(pos < 0, 0, pos), device="cuda")[:, None]
        dpos = torch.gather(d, 1, p.long())
        reach = torch.clamp(4.0 * (torch.nextafter(
            dpos, torch.full_like(dpos, float("inf"))) - dpos),
            min=2.0 * moved_by)
        rank_tol = _rank_tolerance(d, pos, reach)
        del d, dpos, reach
        ranks = {r: tr[r]["ranks"] for r in tr}
        diff = np.abs(ranks["k1"] - ranks["exact"])
        check(bool((diff <= rank_tol).all()),
              f"K1's ranks within the rank tolerance of the exact route's "
              f"({metric})")
        moved_rows = np.nonzero(diff)[0]
        over = np.nonzero(diff > RANK_TOL)[0]  # past the kernels phase's
        for route in ("k1", "exact"):  # each dict scores its own ranks
            _check_scores(out[route], ranks[route], f"the {route} route")
        dict_diff = _dicts_within(out["k1"], out["exact"], ranks["exact"],
                                  rank_tol, f"K1's route against the exact "
                                  f"route ({metric})")
        sample_err, traded = _same_samples(
            out["k1"]["retrieval_samples"], out["exact"]["retrieval_samples"],
            metric, qn, gallery.cpu().numpy(), test_cat.sketch_paths, paths)
        metrics.append({
            "metric": metric, "queries": q, "gallery": K1_ROWS,
            "chunks": chunks, "k1_launches": chunks,
            "topk_value_max_abs_diff": moved_by,
            "topk_set_diff_rows": set_rows,
            "rank_diff_rows": int(len(moved_rows)),
            "rank_diff_first": moved_rows.tolist()[:10],
            "rank_max_diff": int(diff.max()),
            "rank_tol_max": int(rank_tol.max()),
            "rank_tol_zero_rows": int(np.count_nonzero(rank_tol == 0)),
            "rank_diff_over_kernels_tol_rows": int(len(over)),
            "rank_diff_over_kernels_tol": [
                [int(i), int(diff[i]), int(rank_tol[i])] for i in over[:10]],
            "mrr": {r: out[r]["mean_reciprocal_rank"] for r in out},
            "topk_acc_k1": out["k1"]["topk_acc"],
            "stats_equal": all(out["k1"][k] == out["exact"][k]
                               for k in STAT_KEYS),
            "dict_diff": dict_diff,
            "sample_max_abs_diff": sample_err,
            "sample_places_traded": traded,
            "wall_s": {r: out[r]["wall_s"] for r in out},
            "rank_s": {r: tr[r]["rank_s"] for r in tr},
            "inference_time_s": {r: out[r]["inference_time"] for r in out}})
        del qt
    state["launches"]["K1"] = state["launches"].get("K1", 0) + main_launches
    del model, gallery
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(6)
    routes = _route_times(gen)
    # K1 at the offline chunk, Q = 1,024 with ranks, N = K1_ROWS, beside its
    # bound, its plain version and the library composition (its device time
    # alone is the kernels phase's, by_q)
    n, qn = K1_ROWS, 1024
    inputs = _k1_inputs(n, qn, "euclidean", gen)
    kw = dict(k=K, metric="euclidean", with_ranks=True)
    ms = [time_ms(lambda: rf.fused_sweep_cuda(*inputs, **kw), reps=10)]
    plain_ms = time_ms(lambda: rf.fused_sweep_reference(*inputs, **kw),
                       reps=5)
    library_ms = time_ms(lambda: k1_library(inputs[0], inputs[3], inputs[1],
                                            inputs[4], inputs[2], True),
                         reps=10)
    ms.append(time_ms(lambda: rf.fused_sweep_cuda(*inputs, **kw), reps=10))
    bound_ms, bound_by = bound(
        4 * (n * D + qn * D + n + 2 * qn) + qn * K * 8 + qn * 8,
        2 * qn * n * D, H100_F32_FLOP_PER_S)
    emit({"phase": "inference_k1", "ok": True, "cache_save_s": save_s,
          "metrics": metrics, "routes_by_n": routes,
          "k1_q1024": {"n": n, "q": qn, "with_ranks": True, "ms": min(ms),
                       "kernel_ms_runs": ms,
                       "plain_ms": plain_ms, "library_ms": library_ms,
                       "library": "torch.cdist, torch.topk, the rank count",
                       "bound_ms": bound_ms, "bound_by": bound_by},
          "launches": {"K1": main_launches}})


# ---------------------------------------------------------------- sharded

SHARD_ROWS = 100_004  # run_inference's sharded gallery: divisible by SHARDS


def _shard_inputs(gen, q: int):
    """(queries, positives, gallery) at N = SERVE_N: rows [0, 16) copied
    into every other shard (at row 100 of the shard), positives over every
    shard, the first ones on row 3 and on its copy in shard 1 and at the
    shards' edges, queries at noise 1.0 from their positives."""
    import torch

    n, nl = SERVE_N, SERVE_N // SHARDS
    g = torch.randn((n, D), generator=gen, device="cuda")
    for s in range(1, SHARDS):
        g[s * nl + 100:s * nl + 116] = g[:16]
    pos = torch.randint(0, n, (q,), generator=gen, device="cuda")
    edges = [3, nl + 103, 0, nl - 1, nl, n - 1, 2 * nl + 100, 3 * nl - 1]
    pos[:min(q, 8)] = torch.tensor(edges[:q], device="cuda")
    x = g[pos] + torch.randn((q, D), generator=gen, device="cuda")
    return x.contiguous(), pos, g


def _call_launches(fn) -> dict:
    """The port's kernel launches of one call of ``fn``, by counter."""
    from art_sbir_tpu_torch.ops import quant_fused as qf
    from art_sbir_tpu_torch.ops import retrieval_fused as rf

    counters = {"K1": rf.counters, "K1_bf16": rf.bf16_counters,
                "positive": rf.positive_counters, "merge": rf.merge_counters,
                "K2": qf.counters}
    for c in counters.values():
        c.reset()
    fn()
    return {name: c.launches for name, c in counters.items()}


def _sharded_k1(state, mesh, gen) -> dict:
    """Sharded K1 against unsharded K1 (bit for bit) and against its
    sharded plain version, then both timed beside the library call."""
    import torch

    from art_sbir_tpu_torch.ops import retrieval_fused as rf

    n, nl = SERVE_N, SERVE_N // SHARDS
    cases, max_err, max_over = [], 0.0, 0.0
    # whether norms taken on each shard have the bits of the whole's slice
    # (the sharded calls slice the whole's where the caller holds it whole)
    g = torch.randn((n, D), generator=gen, device="cuda")
    norms_equal = {m: bool(torch.equal(rf.gallery_norms(g, m), torch.cat(
        [rf.gallery_norms(s, m) for s in g.split(nl)], 1)))
        for m in ("euclidean", "cosine")}
    del g
    for q in (1, 32, 1024):
        x, pos, g = _shard_inputs(gen, q)
        for metric in ("euclidean", "cosine"):
            for precision in ("highest", "default"):
                for with_ranks in (True, False):
                    kw = dict(k=K, precision=precision, metric=metric,
                              with_ranks=with_ranks)
                    what = f"sharded K1 ({q} {metric} {precision} " \
                           f"ranks={with_ranks})"
                    one = rf.retrieve_fused_core(x, g, pos, **kw)
                    out = rf.retrieve_fused_sharded_core(x, g, pos, mesh,
                                                         **kw)
                    ref = rf.retrieve_fused_sharded_core(
                        x, g, pos, mesh, reference=True, **kw)
                    torch.cuda.synchronize()
                    check(all(torch.equal(a, b) for a, b in zip(out, one)),
                          f"{what}: bit for bit unsharded K1")
                    bnd = None
                    if precision == "default":
                        bnd = rf.sum_order_bound(
                            x.to(torch.bfloat16), g.to(torch.bfloat16),
                            ref[2], rf.query_norms(x, metric),
                            rf.gallery_norms(g, metric), metric)
                    err, rank_err, moved, over = _compare(
                        out, ref, q, n, with_ranks, bound=bnd)
                    if precision == "highest":
                        max_err = max(max_err, err)
                    max_over = max(max_over, over)
                    if q > 1 and with_ranks:  # row 3 and its 3 copies
                        copies = [3 + s * nl + 100 * (s > 0)
                                  for s in range(SHARDS)]
                        for row, rank in ((0, 0), (1, 1)):
                            check(out[2][row, :SHARDS].tolist() == copies
                                  and bool((out[1][row, :SHARDS]
                                            == out[1][row, 0]).all())
                                  and int(out[0][row]) == rank,
                                  f"{what}: the copies across shards tie, "
                                  "in index order, earlier ones ranked")
                    cases.append([q, metric, precision, with_ranks, err,
                                  rank_err, moved])
        del x, pos, g
    # times, float32 form, euclidean, shards placed once (as the engine and
    # evaluate_retrieval place them)
    times = []
    for q, with_ranks in ((32, False), (1024, True)):
        x, pos, g = _shard_inputs(gen, q)
        gg = rf.gallery_norms(g, "euclidean")
        shards, ggs = rf.shard_gallery(g, mesh, gg)
        qq = rf.query_norms(x, "euclidean")
        pos2d = pos.to(torch.int32).reshape(-1, 1)
        kw = dict(k=K, with_ranks=with_ranks)
        reps = 20 if q <= 32 else 10
        row = {"q": q, "with_ranks": with_ranks}
        ms = [time_ms(lambda: rf.retrieve_fused_sharded_core(
            x, shards, pos, mesh, gg=ggs, **kw), reps=reps)]
        row["unsharded_ms"] = time_ms(lambda: rf.retrieve_fused_core(
            x, g, pos, gg=gg, **kw), reps=reps)
        row["plain_ms"] = time_ms(lambda: rf.retrieve_fused_sharded_core(
            x, shards, pos, mesh, gg=ggs, reference=True, **kw), reps=5)
        row["library_ms"] = time_ms(lambda: k1_library(x, g, qq, gg, pos2d,
                                                       with_ranks),
                                    reps=reps)
        ms.append(time_ms(lambda: rf.retrieve_fused_sharded_core(
            x, shards, pos, mesh, gg=ggs, **kw), reps=reps))
        row["ms"], row["ms_runs"] = min(ms), ms
        row["device_ms"] = device_ms(lambda: rf.retrieve_fused_sharded_core(
            x, shards, pos, mesh, gg=ggs, **kw))
        row["unsharded_device_ms"] = device_ms(
            lambda: rf.retrieve_fused_core(x, g, pos, gg=gg, **kw))
        row["launches"] = _call_launches(
            lambda: rf.retrieve_fused_sharded_core(x, shards, pos, mesh,
                                                   gg=ggs, **kw))
        row["unsharded_launches"] = _call_launches(
            lambda: rf.retrieve_fused_core(x, g, pos, gg=gg, **kw))
        torch.cuda.synchronize()
        # one device: a positive pass (with ranks), one sweep and its merge
        check(row["launches"] == {"K1": 1, "K1_bf16": 0,
                                  "positive": int(with_ranks), "merge": 0,
                                  "K2": 0},
              f"sharded K1 on one card (Q {q}): one launch of each kernel")
        row["bound_ms"], row["bound_by"] = bound(
            4 * (n * D + q * D + n + 2 * q) + q * K * 8 + q * 8,
            2 * q * n * D, H100_F32_FLOP_PER_S)
        times.append(row)
        del x, pos, g, shards, gg, ggs
    serving = times[0]
    state["k1_sharded"] = {
        "name": "K1_sharded", "route": "cuda",
        "source": "art_sbir_tpu_torch/ops/retrieval_fused.py "
                  "(retrieve_fused_sharded, sweep_shards) + "
                  "art_sbir_tpu_torch/csrc/fused_retrieval.cu "
                  "(k1_positive_shards, k1_sweep_shards) + "
                  "art_sbir_tpu_torch/csrc/k1_sweep.cuh",
        "replaces": "art_sbir_tpu/ops/retrieval_pallas.py:746",
        "max_abs_err": max_err, "ms": serving["ms"],
        "plain_ms": serving["plain_ms"], "bound_ms": serving["bound_ms"],
        "bound_by": serving["bound_by"],
        "library_ms": serving["library_ms"], "shards": SHARDS,
        "device_ms": serving["device_ms"],
        "shape": "Q 32, N 100,000, no ranks, 4 shards of one card"}
    return {"shard_norms_bit_equal": norms_equal,
            "k1_cases": len(cases), "k1_case_rows": cases,
            "k1_bf16_max_err_over_bound": max_over, "k1_times": times}


def _merge_inputs(gen, s: int, q: int, length: int, n: int):
    """(S, Q, L) runs as the sharded routes give them (views of (Q, S, L)
    tensors), each ascending by (value, global index): small-integer values
    (ties within and across runs), shard i's indices in [i * n / S, (i + 1)
    * n / S), the last slots of a few runs unfilled (3e38 at n); (S, Q)
    rank partials and certificates with one 0."""
    import torch

    nl = n // s
    vals = torch.randint(0, 6, (q, s, length), generator=gen,
                         device="cuda").float()
    idx = (torch.rand((q, s, nl), generator=gen, device="cuda")
           .argsort(2)[..., :length].int()
           + nl * torch.arange(s, device="cuda", dtype=torch.int32)[:, None])
    order = torch.argsort(vals.double() * n + idx.double(), dim=2)
    vals, idx = torch.gather(vals, 2, order), torch.gather(idx, 2, order)
    vals[:3, 0, -2:], idx[:3, 0, -2:] = 3.0e38, n
    ranks = torch.randint(0, 1000, (s, q), generator=gen, device="cuda",
                          dtype=torch.int32)
    exact = torch.ones((s, q), dtype=torch.int32, device="cuda")
    exact[s - 1, q - 1] = 0
    return vals.transpose(0, 1), idx.transpose(0, 1), ranks, exact


def _sharded_merge(state, gen) -> dict:
    """K1's cross-shard merge kernel against its plain version, bit for
    bit, at the int8 route's shape on 4 shards (Q 32, k 10) and at 16
    shards of 1,024 queries, then timed at the int8 route's shape."""
    import torch

    from art_sbir_tpu_torch.ops import retrieval_fused as rf

    cases = []
    for s, q in ((SHARDS, 32), (16, 1024)):
        v, i, r, e = _merge_inputs(gen, s, q, K, SERVE_N)
        got = rf.merge_shard_runs_cuda(v, i, K, SERVE_N, ranks=r, exact=e)
        want = rf.merge_shard_runs_reference(v, i, K, SERVE_N, ranks=r,
                                             exact=e)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"the cross-shard merge ({s} runs, {q} queries): bit for bit "
              "its plain version")
        check(int(got[3][-1]) == 0 and int(got[3][0]) == 1,
              "the cross-shard merge ANDs the certificates")
        cases.append([s, q])
    v, i, r, e = _merge_inputs(gen, SHARDS, 32, K, SERVE_N)
    ms = time_ms(lambda: rf.merge_shard_runs_cuda(v, i, K, SERVE_N,
                                                  exact=e))
    plain_ms = time_ms(lambda: rf.merge_shard_runs_reference(
        v, i, K, SERVE_N, exact=e))
    # the runs and certificates read once, the top-k and certificates written
    nbytes = SHARDS * 32 * (8 * K + 4) + 32 * (8 * K + 4)
    bound_ms, bound_by = bound(nbytes, SHARDS * 32 * K, H100_F32_FLOP_PER_S)
    state["k1_merge_shards"] = {
        "name": "K1_merge_shards", "route": "cuda",
        "source": "art_sbir_tpu_torch/ops/retrieval_fused.py "
                  "(merge_shard_runs) + art_sbir_tpu_torch/csrc/"
                  "fused_retrieval.cu (k1_merge_runs)",
        "replaces": "art_sbir_tpu/ops/retrieval_pallas.py:866",
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "shape": "4 runs a query (the int8 route's shards), Q 32, k 10, "
                 "certificates ANDed"}
    return {"merge_cases": cases, "merge_ms": ms, "merge_plain_ms": plain_ms}


def _sharded_k2(state, mesh, gen) -> dict:
    """The sharded int8 route (K2 once for the card's shards, their exact
    rerank at once, K1's merge kernel) against its per-shard plain route,
    bit for bit, then timed."""
    import torch

    from art_sbir_tpu_torch.ops import quant
    from art_sbir_tpu_torch.ops import quant_fused as qf
    from art_sbir_tpu_torch.ops import retrieval_fused as rf

    n, q = QUANT_N, 32
    g = torch.randn((n, D), generator=gen, device="cuda")
    rows = torch.randint(0, n, (q,), generator=gen, device="cuda")
    x = g[rows] + 0.01 * torch.randn((q, D), generator=gen, device="cuda")
    out = {}
    for metric in ("euclidean", "cosine"):
        qgs, gs = quant.shard_quant_gallery(quant.quantize_gallery(g, metric),
                                            g, mesh)
        qf.counters.reset()
        rf.merge_counters.reset()
        v1, i1 = quant.retrieve_quantized_sharded(x, qgs, gs, mesh, k=K,
                                                  rerank_factor=4)
        torch.cuda.synchronize()
        launches, fallback = qf.counters.launches, qf.counters.fallback_rows
        merges = rf.merge_counters.launches
        v0, i0 = quant.retrieve_quantized_sharded(x, qgs, gs, mesh, k=K,
                                                  rerank_factor=4,
                                                  use_kernel=False)
        check(launches == 1 and merges == 1 and fallback == 0,
              f"sharded K2 route ({metric}): K2 once for the card's "
              f"{SHARDS} shards, one merge, no fallback")
        # K2 over the shards against its plain version, bit for bit
        q8, s_q = quant._quantize_queries(x, metric)
        row0 = [i * (n // SHARDS) for i in range(SHARDS)]
        got = qf.quant_candidates_shards_cuda(q8, s_q, qgs, row0, r=R,
                                              metric=metric)
        want = qf.quant_candidates_shards_reference(q8, s_q, qgs, row0, r=R,
                                                    metric=metric)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"K2 over {SHARDS} shards ({metric}): bit for bit its plain "
              "version (candidates in index order, global rows)")
        check(torch.equal(i1, i0) and torch.equal(v1, v0),
              f"sharded K2 route ({metric}): bit for bit the per-shard "
              "plain route")
        check(torch.equal(i1[:, 0], rows.to(i1.dtype)),
              f"sharded K2 route ({metric}): top-1 is the query's row")
        out[metric] = {"launches": launches, "merges": merges,
                       "fallback_rows": fallback}
        del qgs, gs
    qg = quant.quantize_gallery(g, "euclidean")
    qgs, gs = quant.shard_quant_gallery(qg, g, mesh)
    kw = dict(k=K, rerank_factor=4)
    q8, s_q = quant._quantize_queries(x, "euclidean")
    ms = [time_ms(lambda: quant.retrieve_quantized_sharded(
        x, qgs, gs, mesh, **kw))]
    unsharded_ms = time_ms(lambda: quant.retrieve_quantized_fused(
        x, qg, g, **kw))
    plain_ms = time_ms(lambda: quant.retrieve_quantized_sharded(
        x, qgs, gs, mesh, use_kernel=False, **kw), reps=5)

    def library():  # the scan's library composition over the whole gallery
        cross = torch._int_mm(q8, qg.q8.t())
        dot = cross.float() * (s_q[:, None] * qg.scale[None, :])
        return torch.topk(qg.sq_norm[None, :] - 2.0 * dot, R, largest=False)

    def library_route():  # the whole route's library composition
        cross = torch._int_mm(q8, qg.q8.t())
        dot = cross.float() * (s_q[:, None] * qg.scale[None, :])
        cand = torch.topk(qg.sq_norm[None, :] - 2.0 * dot, R,
                          largest=False).indices
        exact = torch.linalg.vector_norm(x[:, None, :] - g[cand] + 1e-6,
                                         dim=2)
        return torch.topk(exact, K, largest=False)

    library_ms = time_ms(library)
    library_route_ms = time_ms(library_route)
    ms.append(time_ms(lambda: quant.retrieve_quantized_sharded(
        x, qgs, gs, mesh, **kw)))
    dev_ms = device_ms(lambda: quant.retrieve_quantized_sharded(
        x, qgs, gs, mesh, **kw))
    unsharded_dev_ms = device_ms(lambda: quant.retrieve_quantized_fused(
        x, qg, g, **kw))
    launches = _call_launches(lambda: quant.retrieve_quantized_sharded(
        x, qgs, gs, mesh, **kw))
    unsharded_launches = _call_launches(
        lambda: quant.retrieve_quantized_fused(x, qg, g, **kw))
    # the scan reads the int8 rows, their scales and norms once; the rerank
    # the S * r candidate rows of each query in float32
    cand = q * SHARDS * R
    t_bytes = (4 * q * D + n * D + 8 * n + 4 * cand * D + 8 * q * K) \
        / H100_BYTES_PER_S
    t_ops = (2 * q * n * D / H100_INT8_OP_PER_S
             + 3 * cand * D / H100_F32_FLOP_PER_S)
    state["k2_sharded"] = {
        "name": "K2_sharded", "route": "cuda",
        "source": "art_sbir_tpu_torch/ops/quant.py "
                  "(retrieve_quantized_sharded) + "
                  "art_sbir_tpu_torch/csrc/quant_candidates.cu "
                  "(k2_quant_candidates_shards)",
        "replaces": "art_sbir_tpu/ops/quant.py:348",
        "max_abs_err": 0.0, "ms": min(ms), "plain_ms": plain_ms,
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_route_ms, "library_scan_ms": library_ms,
        "device_ms": dev_ms, "shards": SHARDS,
        "shape": "Q 32, N 10^6, r 40 a shard, k 10, 4 shards of one card"}
    return {"k2_route": out, "k2_ms_runs": ms,
            "k2_unsharded_route_ms": unsharded_ms,
            "k2_device_ms": dev_ms, "k2_unsharded_device_ms": unsharded_dev_ms,
            "k2_launches": launches,
            "k2_unsharded_launches": unsharded_launches,
            "k2_library_route_ms": library_route_ms,
            "k2_library": "library_ms: torch._int_mm over the whole gallery, "
                          "the score, torch.topk, the gathered rows' exact "
                          "distances, torch.topk (the whole route); "
                          "library_scan_ms: the scan alone"}


def _dispatch_ab(mesh) -> dict:
    """One engine dispatch of 8 sketches (``search_arrays``: the encoder,
    K1 without ranks, the results' transfer) on two engines over the same
    SERVE_N rows, unsharded and over ``mesh``, in 10 pairs of alternating
    order, host clock; no HTTP and no other thread."""
    import torch

    from art_sbir_tpu_torch.models.resnet import create_encoder
    from art_sbir_tpu_torch.retrieval.server import RetrievalEngine
    from art_sbir_tpu_torch.train.prepare import finish_gallery_batch

    enc = create_encoder(device="cuda", seed=0)

    def forward(x):
        return enc(finish_gallery_batch(x))

    gen = torch.Generator(device="cuda").manual_seed(9)
    feats = torch.randn((SERVE_N, D), generator=gen, device="cuda")
    paths = [str(i) for i in range(SERVE_N)]
    engines = {"one": RetrievalEngine(forward, feats, paths, device="cuda"),
               "sharded": RetrievalEngine(forward, feats, paths, mesh=mesh)}
    sketches = _sketches(8)
    out = {name: e.search_arrays(sketches) for name, e in engines.items()}
    check(all(np.array_equal(a, b) for a, b in zip(out["one"],
                                                   out["sharded"])),
          "a dispatch over the mesh: the unsharded engine's results")
    ms = {name: [] for name in engines}
    for i in range(10):
        for name in (("one", "sharded") if i % 2 else ("sharded", "one")):
            torch.cuda.synchronize()
            t = time.perf_counter()
            engines[name].search_arrays(sketches)
            ms[name].append(1e3 * (time.perf_counter() - t))
    return {name: {"median_ms": float(np.median(v)),
                   "quartiles_ms": [float(np.percentile(v, 25)),
                                    float(np.percentile(v, 75))],
                   "runs_ms": v} for name, v in ms.items()}


def phase_sharded(state) -> None:
    """The row-sharded gallery on 4 shards of the one card: sharded K1 and
    the sharded int8 route against unsharded K1 and their plain versions,
    timed; ``run_inference`` over the mesh against the unsharded run at
    SHARD_ROWS rows, and at K1_ROWS rows (not divisible by 4: the
    unsharded route); ``--n_devices`` past the cards present. First the
    sharded IVF routes (:func:`_sharded_ivf`, their own ``sharded_ivf``
    line, and ``serve_ivf_sharded``). (The serving engine over the mesh
    runs in ``serve_sharded`` and ``serve_quant_sharded``.)"""
    import torch

    from art_sbir_tpu_torch.cli import inference as inference_cli
    from art_sbir_tpu_torch.ops import retrieval_fused as rf
    from art_sbir_tpu_torch.parallel.mesh import MeshSpec
    from art_sbir_tpu_torch.retrieval import engine as engine_mod
    from art_sbir_tpu_torch.retrieval.embed import (load_image_features,
                                                    save_image_features)
    from art_sbir_tpu_torch.train.prepare import finish_gallery_batch

    mesh = MeshSpec(SHARDS).build(["cuda:0"] * SHARDS)
    t0 = time.perf_counter()
    emit({"phase": "sharded_ivf", "ok": True, "shards": SHARDS,
          **_sharded_ivf(state, mesh), "phase_s": time.perf_counter() - t0})
    gen = torch.Generator(device="cuda").manual_seed(8)
    line = {"phase": "sharded", "ok": True, "shards": SHARDS}
    line.update(_sharded_k1(state, mesh, gen))
    torch.cuda.empty_cache()
    line.update(_sharded_merge(state, gen))
    line.update(_sharded_k2(state, mesh, gen))
    torch.cuda.empty_cache()
    line["dispatch_8_alternating"] = _dispatch_ab(mesh)
    torch.cuda.empty_cache()

    # run_inference over the mesh, held against the unsharded run
    tmp = Path(state["tmp"])
    test_cat = state["corpus"]["test_cat"]
    real_paths, real = load_image_features(state["corpus"]["cache"],
                                           tmp / "features")
    feats, paths = _k1_gallery(real, real_paths, SHARD_ROWS, seed=7)
    cache = save_image_features("ChipSmoke", "SketchyShards", paths, feats,
                                root=tmp / "features", timestamp="shards")
    del feats
    model, _ = engine_mod.restore_encoder(RUN, {}, tmp / "models",
                                          torch.device("cuda"))

    def forward(x):
        return model(finish_gallery_batch(x))

    # why the embedding splits a batch over distinct devices only: a batch
    # cut into SHARDS parts on one card (cuDNN picks its algorithm by
    # batch) against the whole batch
    batch = torch.from_numpy(_sketches(8)).cuda().repeat(32, 1, 1, 1)
    with torch.no_grad():
        whole = forward(batch).float()
        parts = torch.cat([forward(p).float() for p in batch.chunk(SHARDS)])
    split_diff = float((whole - parts).abs().max())
    del batch, whole, parts
    counters = list(_counters().values()) + [rf.positive_counters]
    chunks = -(-len(test_cat) // 1024)
    runs = {}
    for name, folder, with_mesh in (("one", cache, False),
                                    ("sharded", cache, True),
                                    ("k1_rows", state["k1_cache"], True)):
        trace = {}
        for c in counters:
            c.reset()
        t0 = time.perf_counter()
        got = engine_mod.run_inference(
            forward, test_cat, feature_folder=folder, loss_type="euclidean",
            image_size=224, feature_root=tmp / "features", device="cuda",
            mesh=mesh if with_mesh else None, trace=trace)
        wall = time.perf_counter() - t0
        (sub,) = trace["passes"]
        runs[name] = {"dict": got, "trace": sub, "wall_s": wall,
                      "launches": [c.launches for c in counters],
                      "fallback": rf.counters.fallback_rows}
    k1, k1_bf16, k2, p1, positive = runs["sharded"]["launches"]
    check(runs["sharded"]["trace"]["route"] == "K1_sharded"
          and k1 == chunks and positive == chunks
          and k1_bf16 == k2 == p1 == 0 and runs["sharded"]["fallback"] == 0,
          f"run_inference over the mesh: K1 and its positive launched "
          f"once a query chunk ({chunks}) for the card's {SHARDS} shards, "
          "alone, no fallback")
    state["launches"]["K1_sharded"] = (state["launches"].get("K1_sharded", 0)
                                       + k1)
    one, sh = runs["one"], runs["sharded"]
    check(torch.equal(one["trace"]["queries"], sh["trace"]["queries"]),
          "the mesh's one card embeds the queries as without the mesh")
    for key in ("ranks", "values", "indices"):
        check(np.array_equal(one["trace"][key], sh["trace"][key]),
              f"run_inference over the mesh: the unsharded run's {key}")
    check(all(sh["dict"][key] == one["dict"][key] for key in one["dict"]
              if key != "inference_time"),
          "run_inference over the mesh: the unsharded run's dict")
    k1_rows = runs["k1_rows"]
    k1, k1_bf16, k2, p1, positive = k1_rows["launches"]
    check(k1_rows["trace"]["route"] == "K1" and k1 == chunks
          and positive == 0 and k1_rows["fallback"] == 0,
          f"run_inference over the mesh at {K1_ROWS} rows (not divisible "
          f"by {SHARDS}): unsharded K1, once a query chunk")
    state["launches"]["K1"] = state["launches"].get("K1", 0) + k1
    del model
    torch.cuda.empty_cache()

    # --n_devices past the cards present exits with the mesh's message
    n_cards = torch.cuda.device_count()
    try:
        inference_cli.main(["--folder", RUN, "--results_root",
                            str(tmp / "results"), "--n_devices",
                            str(n_cards + 1)])
        said = ""
    except SystemExit as e:
        said = str(e)
    check(f"only {n_cards} present" in said,
          f"--n_devices {n_cards + 1} on {n_cards} card(s) exits")
    line.update({
        "inference": {
            "rows": SHARD_ROWS, "queries": len(test_cat), "chunks": chunks,
            "launches": {"K1": runs["sharded"]["launches"][0],
                         "positive": runs["sharded"]["launches"][4]},
            "wall_s": {k: v["wall_s"] for k, v in runs.items()},
            "rank_s": {k: v["trace"]["rank_s"] for k, v in runs.items()},
            "mrr": sh["dict"]["mean_reciprocal_rank"],
            "k1_rows_route": k1_rows["trace"]["route"],
            "embed_batch_256_split_in_4_max_abs_diff": split_diff},
        "n_devices_exit": said})
    emit(line)


# ------------------------------------------------------------------ train

# the train phase's learnable Sketchy corpus: 400 sketches of 100 photos
# at 128 px (Sketchy's are 256 px; PIL decodes and resizes those at about
# 11 ms an image on the card's host, which would take the phase past its
# time); the seeded 90/10 split leaves 360 training triplets, 12 steps of
# 32 (the host's decoding sets a step's pace, about 1.2 s)
TRAIN_CORPUS = dict(n_classes=25, photos_per_class=4, sketches_per_photo=4,
                    size=128, learnable=True)
TRAIN_B = 32
CHECK_B = 4  # the card-against-CPU float32 step


def _forward_flops(model, x) -> int:
    """2 x the multiply-adds of ``model``'s convolutions, transposed
    convolutions and linear layers in one forward of ``x``, from their
    shapes (forward hooks)."""
    import torch
    from torch import nn

    total = [0]

    def hook(mod, inp, out):
        if isinstance(mod, nn.Conv2d):
            k = mod.in_channels // mod.groups * mod.kernel_size[0] \
                * mod.kernel_size[1]
            total[0] += 2 * out.numel() * k
        elif isinstance(mod, nn.ConvTranspose2d):
            # each input pixel scatters a k x k x out_channels block
            k = mod.out_channels // mod.groups * mod.kernel_size[0] \
                * mod.kernel_size[1]
            total[0] += 2 * inp[0].numel() * k
        else:
            total[0] += 2 * out.numel() * mod.in_features

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear))]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in handles:
            h.remove()
    return total[0]


def _run_cli(module: str, args: list, cwd: Path, timeout: int = 600) -> str:
    """``python -m <module> <args>`` from ``cwd`` with this checkout on the
    path; its standard output, or a failed check with its error's tail."""
    import os

    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    out = subprocess.run([sys.executable, "-m", module, *map(str, args)],
                         cwd=cwd, env=env, capture_output=True, text=True,
                         timeout=timeout)
    check(out.returncode == 0,
          f"{module} exited {out.returncode}: {out.stderr[-2000:]}")
    return out.stdout


def _one_step(model, u8, cfg, dev, backward: bool = True):
    """One train-mode step's loss parts, embeddings and, with ``backward``,
    gradients and running statistics (all on the CPU), from the uint8
    triplet ``u8``, in the model's dtype."""
    import torch

    from art_sbir_tpu_torch.train.losses import triplet_loss_with_heads
    from art_sbir_tpu_torch.train.prepare import finish_triplet_batch
    from art_sbir_tpu_torch.train.triplet import forward3

    batch = finish_triplet_batch({k: torch.from_numpy(v).to(dev)
                                  for k, v in u8.items()}, train=True)
    dtype = next(model.parameters()).dtype
    batch = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in batch.items()}
    model.train()
    model.zero_grad(set_to_none=True)
    with torch.set_grad_enabled(backward):
        s, p, n = forward3(model, batch)
        losses = triplet_loss_with_heads(cfg, s, p, n, batch["label"])
    out = {"losses": {k: float(v.detach()) for k, v in losses.items()},
           "embeddings": [t[0].detach().cpu().double() for t in (s, p, n)]}
    if backward:
        losses["loss"].backward()
        out["grads"] = {k: v.grad.detach().cpu()
                        for k, v in model.named_parameters()}
        out["stats"] = {k: v.detach().cpu()
                        for k, v in model.state_dict().items()
                        if "running_" in k}
    return out


def _card_against_cpu(rng) -> dict:
    """The full-width flagship's float32 step on the card against the same
    step on the CPU, both held against a float64 step on the CPU: loss,
    embeddings, gradients, running statistics; then Adam from the CPU's
    gradients on both devices.

    float32 at this depth is not exact to 1e-5 on either device (about
    5e-5 of an embedding, 2e-5 of the loss on the CPU in the first runs),
    so each quantity of the card must lie no farther from the float64
    step than twice the CPU's float32 distance from it, plus the stated
    tolerance: rtol 1e-5 for the loss and the running statistics
    (norm-wise a tensor), 1e-4 of each gradient's norm. A gradient below
    1e-6 of the largest is a symmetry's exact zero in rounding noise (the
    attention pool's key bias: the softmax ignores a shift of a head's
    logits), and both float32 sides' must be noise there. Adam from the
    same gradients: rtol 1e-6 of each parameter, of its update (lr) where
    it started at 0."""
    import copy

    import torch

    from art_sbir_tpu_torch.core.device import ieee_f32
    from art_sbir_tpu_torch.models.resnet import create_encoder
    from art_sbir_tpu_torch.train.losses import TripletLossConfig
    from art_sbir_tpu_torch.train.triplet import torch_adam

    ieee_f32()
    cfg = TripletLossConfig.for_dataset("SketchyDatasetV2", "euclidean", True)
    check(cfg.num_heads == 1 and cfg.classification_weight == 0.5,
          "SketchyV2 with classification: one head, weight 0.5")
    cpu = create_encoder(with_classification=True, num_classes=125,
                         compute_dtype=torch.float32, device="cpu", seed=0)
    card = copy.deepcopy(cpu).cuda()
    exact = copy.deepcopy(cpu).double()
    exact.compute_dtype = torch.float64
    u8 = {k: rng.integers(0, 256, (CHECK_B, 224, 224, 3), dtype=np.uint8)
          for k in ("sketch", "positive", "negative")}
    u8["label"] = rng.integers(0, 125, CHECK_B).astype(np.int32)
    t0 = time.perf_counter()
    on_cpu = _one_step(cpu, u8, cfg, "cpu")
    cpu_s = time.perf_counter() - t0
    on_card = _one_step(card, u8, cfg, "cuda")
    t0 = time.perf_counter()
    f64 = _one_step(exact, u8, cfg, "cpu")
    f64_s = time.perf_counter() - t0

    def dist(a, b) -> float:
        return float((a.double() - b.double()).norm() / b.double().norm())

    fails = []

    def held(what, card_err, cpu_err, tol):
        if card_err > 2.0 * cpu_err + tol:
            fails.append(f"{what}: card {card_err:.3g} from float64, CPU "
                         f"{cpu_err:.3g}, tolerance {tol}")

    loss = {k: (abs(on_card["losses"][k] - v) / abs(v),
                abs(on_cpu["losses"][k] - v) / abs(v))
            for k, v in f64["losses"].items()}
    held("loss", *loss["loss"], 1e-5)
    embed = [max(float(((a - b).norm(dim=1) / b.norm(dim=1)).max())
                 for a, b in zip(side["embeddings"], f64["embeddings"]))
             for side in (on_card, on_cpu)]
    scale = max(float(g.norm()) for g in f64["grads"].values())
    grads, zero = {}, []
    for name, g in f64["grads"].items():
        if float(g.norm()) < 1e-6 * scale:
            zero.append(name)
            if max(float(on_card["grads"][name].norm()),
                   float(on_cpu["grads"][name].norm())) >= 1e-6 * scale:
                fails.append(f"gradient of {name}: not rounding noise")
            continue
        grads[name] = (dist(on_card["grads"][name], g),
                       dist(on_cpu["grads"][name], g))
        held(f"gradient of {name}", *grads[name], 1e-4)
    stats = {}
    for name, st in f64["stats"].items():
        stats[name] = (dist(on_card["stats"][name], st),
                       dist(on_cpu["stats"][name], st))
        held(f"running statistic {name}", *stats[name], 1e-5)
    # Adam alone: the CPU's gradients applied on both devices
    lr = 1e-5
    for model in (cpu, card):
        opt = torch_adam(model.parameters(), lr, weight_decay=2e-3)
        dev = next(model.parameters()).device
        for name, p in model.named_parameters():
            p.grad = on_cpu["grads"][name].to(dev)
        opt.step()
    cpu_p = dict(cpu.named_parameters())
    adam_err = 0.0
    for name, p in card.named_parameters():
        ref = cpu_p[name].detach()
        err = (p.detach().cpu() - ref).abs() / (ref.abs() + lr)
        adam_err = max(adam_err, float(err.max()))
    if adam_err > 1e-6:
        fails.append(f"Adam from the same gradients: {adam_err:.3g}")

    def worst(d):
        name = max(d, key=lambda k: d[k][0])
        return {"name": name, "card": d[name][0], "cpu": d[name][1],
                "cpu_max": max(v[1] for v in d.values())}

    out = {"batch": CHECK_B, "cpu_step_s": cpu_s, "f64_step_s": f64_s,
           "losses_cpu": on_cpu["losses"], "losses_card": on_card["losses"],
           "losses_f64": f64["losses"],
           "loss_rel_err_card_cpu": abs(on_card["losses"]["loss"]
                                        - on_cpu["losses"]["loss"])
           / abs(on_cpu["losses"]["loss"]),
           "loss_rel_err_vs_f64": {k: {"card": a, "cpu": b}
                                   for k, (a, b) in loss.items()},
           "embed_rel_err_vs_f64": {"card": embed[0], "cpu": embed[1]},
           "grad_err_vs_f64_worst": worst(grads),
           "grads_zero_by_symmetry": zero,
           "stats_err_vs_f64_worst": worst(stats),
           "adam_rel_err_max": adam_err}
    print(json.dumps({"train_card_vs_cpu": out}), file=sys.stderr,
          flush=True)
    check(not fails, "the card's float32 step against the CPU's: "
          + "; ".join(fails[:5]))
    return out


def _timed_steps(rng) -> dict:
    """The bf16 step at B = 32: the loss falls over five steps on one
    fixed batch at lr 1e-4; median step time, the device's busy share over
    five profiled steps, peak memory and the step's FLOPs."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from art_sbir_tpu_torch.models.resnet import create_encoder
    from art_sbir_tpu_torch.train.losses import TripletLossConfig
    from art_sbir_tpu_torch.train.prepare import finish_triplet_batch
    from art_sbir_tpu_torch.train.triplet import (create_train_state,
                                                  make_train_step)

    model = create_encoder(with_classification=True, num_classes=125,
                           device="cuda", seed=1)
    state = create_train_state(model, lr=1e-4)
    step = make_train_step(TripletLossConfig.for_dataset(
        "SketchyDatasetV2", "euclidean", True))
    u8 = {k: torch.from_numpy(rng.integers(0, 256, (TRAIN_B, 224, 224, 3),
                                           dtype=np.uint8)).cuda()
          for k in ("sketch", "positive", "negative")}
    u8["label"] = torch.from_numpy(
        rng.integers(0, 125, TRAIN_B).astype(np.int32)).cuda()
    batch = finish_triplet_batch(u8, train=True)
    losses = [float(step(state, batch)["loss"]) for _ in range(5)]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"five bf16 steps on one batch lower the loss: {losses}")

    torch.cuda.reset_peak_memory_stats()
    times = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(13):  # 3 warm-up steps, then 10 timed
        start.record()
        step(state, batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            step(state, batch)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    busy_ms = sum(ev.self_device_time_total for ev in prof.key_averages()
                  if ev.device_type == DeviceType.CUDA) / 1e3
    flops = 3 * 3 * _forward_flops(model, batch["sketch"])
    ms = float(np.median(times[3:]))
    # the profiler's own host work lengthens the profiled steps; the idle
    # share of an unprofiled step sets the profiled busy time against the
    # median step
    return {"losses_fixed_batch": losses, "step_ms_median": ms,
            "step_ms_all": times[3:], "images_per_s": 3 * TRAIN_B * 1e3 / ms,
            "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share_profiled": busy_ms / wall_ms,
            "device_busy_ms_per_step": busy_ms / 5,
            "device_idle_share": max(0.0, 1.0 - busy_ms / 5 / ms),
            "peak_memory_bytes": peak, "step_flops": flops,
            "bound_ms": 1e3 * flops / H100_BF16_FLOP_PER_S,
            "bound_by": "operations",
            "share_of_bf16_peak": 1e3 * flops / H100_BF16_FLOP_PER_S / ms}


def _loader_wait(root, steps: int = 6) -> dict:
    """``steps`` bf16 steps fed by ``TripletLoader`` from the corpus as
    ``cli/train.py`` feeds them: the host's time blocked on the loader,
    and the wall time a step."""
    import torch

    from art_sbir_tpu_torch.data import get_datasets
    from art_sbir_tpu_torch.data.loader import TripletLoader
    from art_sbir_tpu_torch.models.resnet import create_encoder
    from art_sbir_tpu_torch.train.losses import TripletLossConfig
    from art_sbir_tpu_torch.train.prepare import finish_triplet_batch
    from art_sbir_tpu_torch.train.triplet import (create_train_state,
                                                  make_train_step)

    train_cat = get_datasets("SketchyV2", size=1.0, root=root)[0]
    state = create_train_state(create_encoder(
        with_classification=True, num_classes=125, device="cuda", seed=2))
    step = make_train_step(TripletLossConfig.for_dataset(
        "SketchyDatasetV2", "euclidean", True))
    it = iter(TripletLoader(train_cat, TRAIN_B, 224))
    wait = 0.0
    step(state, finish_triplet_batch({k: torch.from_numpy(v).cuda()
                                      for k, v in next(it).items()}))
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    for _ in range(steps):
        t = time.perf_counter()
        host = next(it)
        wait += time.perf_counter() - t
        step(state, finish_triplet_batch({k: torch.from_numpy(v).cuda()
                                          for k, v in host.items()}))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_all
    return {"steps": steps, "loader_wait_ms_per_step": 1e3 * wait / steps,
            "wall_ms_per_step": 1e3 * wall / steps,
            "loader_wait_share": wait / wall}


def phase_train(state) -> None:
    """The training path at full width on the card: the float32 step
    against the CPU's, ``cli/train.py`` for one epoch (bf16) on a learnable
    corpus, ``cli/inference.py --bn_recalibrate per_modality`` and
    ``serve --folder`` on the trained run, the loss falling on a fixed
    batch, and the step's numbers."""
    import base64
    import threading

    import torch

    from art_sbir_tpu_torch.cli import serve
    from art_sbir_tpu_torch.data.synthetic import make_synthetic_sketchy
    from art_sbir_tpu_torch.retrieval.engine import rebuild_test_catalog

    check(state["pil"], "PIL is installed: the train phase writes its "
          "corpus with it")
    rng = np.random.default_rng(9)
    t_phase = time.perf_counter()
    parity = _card_against_cpu(rng)
    torch.cuda.empty_cache()

    tmp = Path(state["tmp"]) / "train"
    t0 = time.perf_counter()
    root = make_synthetic_sketchy(tmp / "sketchy", **TRAIN_CORPUS)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _run_cli("art_sbir_tpu_torch.cli.train", [
        "-e", 1, "-b", TRAIN_B, "-d", "SketchyV2", "--model_type",
        "ModifiedResNet_with_classification", "--inference", "--data_root",
        root, "--results_root", tmp / "results"], tmp)
    train_cli_s = time.perf_counter() - t0
    (run_dir,) = (tmp / "results").iterdir()
    run = run_dir.name
    for name in ("data_params", "training", "training_params", "inference"):
        check((run_dir / f"{name}.json").is_file(), f"{name}.json written")
    training = json.loads((run_dir / "training.json").read_text())
    inference = json.loads((run_dir / "inference.json").read_text())
    check(len(training["train_losses"]) == 1
          and np.isfinite(training["train_losses"] + training["test_losses"]
                          ).all(), "one epoch, finite losses")
    check((tmp / "models" / f"{run}.pt").is_file(), "models/<run>.pt saved")
    check(np.isfinite(inference["mean_reciprocal_rank"]), "MRR finite")

    t0 = time.perf_counter()
    said = _run_cli("art_sbir_tpu_torch.cli.inference", [
        "--folder", run, "--results_root", tmp / "results", "--models_root",
        tmp / "models", "--data_root", root, "--feature_root",
        tmp / "features", "--bn_recalibrate", "per_modality"], tmp)
    inference_cli_s = time.perf_counter() - t0
    check("BN running stats recalibrated (per_modality)" in said,
          "cli/inference.py recalibrated per modality")
    recal = json.loads((run_dir / "inference_updated.json").read_text())
    check(np.isfinite(recal["mean_reciprocal_rank"]), "recalibrated MRR "
          "finite")

    # serve --folder on the trained run, a few /search requests over HTTP
    engine, batcher = serve.build_engine(serve.parse_args([
        "-f", run, "--results_root", str(tmp / "results"), "--models_root",
        str(tmp / "models"), "--data_root", str(root), "--device", "cuda"]))
    httpd = serve.Server(("127.0.0.1", 0), serve.make_handler(engine,
                                                              batcher))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    test_cat = rebuild_test_catalog(
        json.loads((run_dir / "data_params.json").read_text()), root)
    hits = 0
    try:
        for i in range(8):
            body = {"image_b64": base64.b64encode(
                Path(test_cat.sketch_paths[i]).read_bytes()).decode()}
            out = _post(httpd.server_address[1], "/search", body)
            check(len(out["paths"]) == 10, "/search answers 10 paths")
            hits += out["paths"][0] == str(test_cat.photo_paths[i])
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
    del engine
    torch.cuda.empty_cache()

    steps = _timed_steps(rng)
    torch.cuda.empty_cache()
    loader = _loader_wait(root)
    emit({"phase": "train", "ok": True, "card_vs_cpu_f32": parity,
          "corpus": TRAIN_CORPUS, "corpus_write_s": write_s,
          "train_cli_s": train_cli_s, "train_cli_steps": training["steps"],
          "train_cli_mean_step_s": training["mean_step_time"],
          "train_losses": training["train_losses"],
          "test_losses": training["test_losses"],
          "mrr": inference["mean_reciprocal_rank"],
          "top1": inference["topk_acc"][0],
          "gallery": inference["size"], "queries": inference["count"],
          "inference_cli_s": inference_cli_s,
          "mrr_per_modality_bn": recal["mean_reciprocal_rank"],
          "serve_top1_hits_of_8": hits, "bf16_step_b32": steps,
          "loader": loader, "phase_s": time.perf_counter() - t_phase})


# ------------------------------------------------------ data parallel

DP_WORLD = 2  # ranks on the one card, over gloo
DP_TIMED = (1, 3)  # warm-up and timed bf16 steps of the two ranks
DP_CLI_DSIZE = 0.12  # 3 of TRAIN_CORPUS's 25 classes: 43 triplets, 2 steps
# of 32


def phase_train_dp(state) -> None:
    """Data-parallel training: two ranks on the one card over gloo (NCCL
    refuses two ranks on one card), held against one process by
    ``scripts/probe_dp_cards.py``'s rules: the flagship's triplet step
    (global batch 32, float32 with TF32 off, augmentation on, two Adam
    steps at lr 1e-5, every run taking the second from the float64 run's
    state; losses, the first step's flat gradient and update no farther
    from float64's than twice the one process's float32
    distance plus rtol 1e-5 and 1e-4, the losses' distance the widest of
    the one process's runs in three row orders, statistics and gradients
    equal on both ranks),
    the pix2pix U-Net with dropout (batch 6; its state against float64's
    under cuDNN's deterministic algorithms) and the full-width VAE
    (batch 64); the bf16 step at one process (B = 32) and two ranks (16
    each) with its all-reduces; ``cli/train.py`` on two ranks against
    one (JAX's CLI rule, float32 at lr 0, 128 px: ``cli_check``)."""
    import torch

    from art_sbir_tpu_torch.data.synthetic import make_synthetic_sketchy
    from art_sbir_tpu_torch.parallel import multihost
    from art_sbir_tpu_torch.scripts import probe_dp_cards as P

    check(state["pil"], "PIL is installed: the phase writes its corpus")
    t_phase = time.perf_counter()
    tmp = Path(state["tmp"]) / "train_dp"
    tmp.mkdir()
    devices = ["cuda:0"] * DP_WORLD
    inputs = P.make_inputs(np.random.default_rng(41), P.FULL, b=TRAIN_B,
                           pix_b=PIX_B, vae_b=P2S_B)
    inputs["u8_timing"] = inputs["u8"]
    t0 = time.perf_counter()
    one_bf16 = P.reference(inputs, P.FULL, "cuda:0", tmp / "ref.pt")
    torch.cuda.empty_cache()
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = multihost.spawn(P.rank_checks, devices, inputs, P.FULL,
                            str(tmp / "ref.pt"), DP_TIMED)
    ranks_s = time.perf_counter() - t0
    bad = P.failures(ranks)

    t0 = time.perf_counter()
    root = make_synthetic_sketchy(tmp / "sketchy", **TRAIN_CORPUS)
    write_s = time.perf_counter() - t0
    cli = P.cli_check(tmp, root, devices, P.FULL, DP_CLI_DSIZE, TRAIN_B)
    bad += ["cli/train.py: " + f for f in cli["failures"]]
    torch.cuda.empty_cache()
    # the readings first, then the verdict: they say where a rule broke
    emit({"phase": "train_dp", "ok": not bad, "failures": bad,
          "backend": ranks["backend"],
          "ranks": devices, "card": state["card"],
          **{k: ranks[k] for k in ("triplet", "pix2pix", "vae")},
          "bf16_step": {"one_process_b32": one_bf16,
                        "rank0_of_two_b16": ranks["bf16"]},
          "cli": cli, "one_process_s": one_s, "ranks_s": ranks_s,
          "corpus_write_s": write_s,
          "phase_s": time.perf_counter() - t_phase})
    check(not bad, "train_dp: " + "; ".join(bad))


# ---------------------------------------------------- tensor parallel

TP_WORLD = 2  # a 1 data x 2 model grid on the one card, over gloo
TP_B = 8  # the triplet's and the VAE's batch (32 and 64 elsewhere): the
# ranks' gathers of ResNet50's and VGG16's conv outputs go through the host
TP_TIMED = (0, 2)  # timed float32 triplet steps (the check's step warmed)
TP_CLI_B = 16
TP_CLI_CORPUS = dict(n_classes=8, photos_per_class=4, sketches_per_photo=1,
                     size=128, learnable=True)  # 2 steps of 16


def phase_train_tp(state) -> None:
    """Tensor-parallel training: a 1 data x 2 model grid on the one card
    over gloo (NCCL refuses two ranks on one card), held against one
    process by ``scripts/probe_tp_cards.py``'s rules at full width, the
    batch cut to ``TP_B`` for the triplet and the VAE (the U-Net keeps
    ``PIX_B``): losses and the triplet's first gradient within twice the
    one process's float32 distance from a float64 step plus rtol 1e-5
    and 1e-4, gathered state equal on both ranks, each rank's bytes
    beside one process's; float32 triplet steps with their collectives;
    ``cli/train.py --tp_devices 2`` against one process (JAX's CLI rule,
    float32 at lr 0, 128 px: ``cli_check``)."""
    import torch

    from art_sbir_tpu_torch.data.synthetic import make_synthetic_sketchy
    from art_sbir_tpu_torch.parallel import multihost
    from art_sbir_tpu_torch.scripts import probe_dp_cards as P
    from art_sbir_tpu_torch.scripts import probe_tp_cards as TPC

    check(state["pil"], "PIL is installed: the phase writes its corpus")
    t_phase = time.perf_counter()
    tmp = Path(state["tmp"]) / "train_tp"
    tmp.mkdir()
    devices = ["cuda:0"] * TP_WORLD
    inputs = P.make_inputs(np.random.default_rng(43), P.FULL, b=TP_B,
                           pix_b=PIX_B, vae_b=TP_B)
    t0 = time.perf_counter()
    TPC.reference(inputs, P.FULL, "cuda:0", tmp / "ref.pt")
    torch.cuda.empty_cache()
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = multihost.spawn(TPC.rank_checks, devices, inputs, P.FULL,
                            str(tmp / "ref.pt"), TP_TIMED, n_model=TP_WORLD)
    ranks_s = time.perf_counter() - t0
    bad = TPC.failures(ranks)

    t0 = time.perf_counter()
    root = make_synthetic_sketchy(tmp / "sketchy", **TP_CLI_CORPUS)
    write_s = time.perf_counter() - t0
    cli = P.cli_check(tmp, root, devices, P.FULL, 1.0, TP_CLI_B,
                      tp=TP_WORLD)
    bad += ["cli/train.py: " + f for f in cli["failures"]]
    torch.cuda.empty_cache()
    # the readings first, then the verdict: they say where a rule broke
    emit({"phase": "train_tp", "ok": not bad, "failures": bad,
          "backend": ranks["backend"], "grid": ranks["grid"],
          "ranks": devices, "card": state["card"],
          "batches": {"triplet": TP_B, "pix2pix": PIX_B, "vae": TP_B},
          **{k: ranks[k] for k in ("triplet", "pix2pix", "vae", "timing")},
          "cli": cli, "one_process_s": one_s, "ranks_s": ranks_s,
          "corpus_write_s": write_s,
          "phase_s": time.perf_counter() - t_phase})
    check(not bad, "train_tp: " + "; ".join(bad))


# ------------------------------------------------------------- generators

GEN_SIZE = 256  # the generators' published resolution
DRAW_B = 16  # cli/drawings.py's default batch
ART_B = 8  # cli/artwork_gen.py's default batch
GEN_CHECK_B = 4  # the drawings' float64 and CPU yardsticks
ART_CHECK_B = 2  # AdaIN's (three 256 px VGG passes an image on the CPU)
DRAW_KAGGLE = dict(n_train=256, n_test=64, size=GEN_SIZE, sketch_types=())
DRAW_SKETCHY = dict(n_classes=3, photos_per_class=4, size=GEN_SIZE)
ART_CONTENT, ART_STYLES = 64, 16


def _he_init(model, seed: int):
    """Conv weights N(0, 2 / fan_in) and zero biases, drawn from a CPU
    ``torch.Generator`` seeded with ``seed``: through AdaIN's 18 convs
    without norms, the fresh init (variance 1 / fan_in, halved by each
    ReLU) shrinks the signal to the last bias, and every stylized image
    would be one colour."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.Conv2d):
                w = mod.weight
                w.copy_(torch.randn(w.shape, generator=gen)
                        * (2.0 / w[0].numel()) ** 0.5)
                mod.bias.zero_()
    return model


def _vs_float64(card_fn, cpu_fn, f64_fn, what: str) -> dict:
    """The card's float32 output and the CPU's, each against a float64
    forward of the same model on the card (norm-wise relative distance,
    and the largest absolute difference): the card within twice the CPU's
    distance plus rtol 1e-5."""
    out = {}
    exact = f64_fn().cpu()
    for side, fn in (("card", card_fn), ("cpu", cpu_fn)):
        got = fn().cpu().double()
        out[side] = {"rel_err": float((got - exact).norm() / exact.norm()),
                     "max_abs_err": float((got - exact).abs().max())}
    check(out["card"]["rel_err"] <= 2 * out["cpu"]["rel_err"] + 1e-5,
          f"{what}: the card's float32 {out['card']['rel_err']:.3g} from "
          f"float64, the CPU's {out['cpu']['rel_err']:.3g}")
    return out


def _kernel_split(fn, top: int = 6) -> dict:
    """One call of ``fn`` under torch.profiler: its device time by kind of
    kernel, from the kernels' names (convolutions, GEMMs and cuDNN's FFT
    convolution kernels, reductions, padding, elementwise work and
    copies, the rest), and the ``top`` kernels by time (names cut to 90
    characters)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kinds = (("conv", ("conv", "gemm", "xmma", "cutlass", "cudnn", "fprop",
                       "sm90_", "sm80_", "fft", "complex")),
             ("reduce", ("reduce",)), ("pad", ("pad",)),
             ("elementwise_copy", ("elementwise", "copy", "nchw", "nhwc",
                                   "transpose")))
    split, named = {}, []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or not ev.self_device_time_total:
            continue
        ms = ev.self_device_time_total / 1e3
        low = ev.key.lower()
        kind = next((k for k, words in kinds
                     if any(w in low for w in words)), "other")
        split[kind] = split.get(kind, 0.0) + ms
        named.append((ms, ev.key[:90]))
    return {"device_ms_by_kind": split,
            "top_kernels_ms": [[n, ms] for ms, n in sorted(named)[::-1][:top]]}


def _gen_timing(fn, flops: int, batch: int, peak: float) -> dict:
    """CUDA-event time of one batch, images/s, the share of ``peak``, and
    where the device time goes (:func:`_kernel_split`)."""
    ms = time_ms(fn, reps=10)
    return {"ms": ms, "device_ms": device_ms(fn, reps=5),
            "images_per_s": batch * 1e3 / ms,
            "bound_ms": 1e3 * flops / peak,
            "share_of_peak": 1e3 * flops / peak / ms, **_kernel_split(fn)}


def phase_drawings(state) -> None:
    """The informative-drawings generator at full width (256 px, batch
    16), seed-0 weights written as a reference ``.pth`` and loaded through
    ``cli/drawings.py``'s own loader: float32 on the card against float64
    (the CPU's float32 beside it), ``--bf16`` against float32 in uint8
    levels, the time of a batch in both; then ``cli/drawings.py``'s
    ``main`` (what ``python -m`` runs) over a synthetic Kaggle corpus
    (every PNG against the in-process forward within one level; the
    Kaggle catalog then finds a sketch for every photo) and over a small
    Sketchy corpus."""
    import copy

    import torch

    from art_sbir_tpu_torch.cli import drawings
    from art_sbir_tpu_torch.core.device import ieee_f32
    from art_sbir_tpu_torch.data import get_datasets
    from art_sbir_tpu_torch.data.loader import decode_paths
    from art_sbir_tpu_torch.data.synthetic import (make_synthetic_kaggle,
                                                   make_synthetic_sketchy)
    from art_sbir_tpu_torch.models import flax_families

    check(state["pil"], "PIL is installed: the phase writes its corpora "
          "with it")
    t_phase = time.perf_counter()
    ieee_f32()
    tmp = Path(state["tmp"]) / "drawings"
    tmp.mkdir()
    pth = tmp / "contour.pth"
    torch.save(flax_families.drawing_generator(0), pth)
    dev = torch.device("cuda")
    gen = drawings.load_generator(str(pth), dev)
    gen16 = drawings.load_generator(str(pth), dev, bf16=True)
    rng = np.random.default_rng(21)
    u8 = torch.from_numpy(rng.integers(0, 256, (DRAW_B, GEN_SIZE, GEN_SIZE,
                                                3), dtype=np.uint8)).cuda()
    x = u8.permute(0, 3, 1, 2).float() / 255.0
    line = {"phase": "drawings", "ok": True, "batch": DRAW_B,
            "size": GEN_SIZE}

    cpu = drawings.load_generator(str(pth), torch.device("cpu"))
    exact = copy.deepcopy(gen).double()
    xs = x[:GEN_CHECK_B]
    with torch.inference_mode():
        line["f32_vs_f64"] = _vs_float64(
            lambda: gen(xs), lambda: cpu(xs.cpu()),
            lambda: exact(xs.double()), "DrawingGenerator")
    del exact, cpu

    f32 = drawings.forward_u8(gen, u8)
    b16 = drawings.forward_u8(gen16, u8, bf16=True)
    diff = (f32.int() - b16.int()).abs().float()
    per_image = diff.mean(dim=(1, 2))
    line["bf16_vs_f32_levels"] = {"mean_max": float(per_image.max()),
                                  "mean": float(per_image.mean()),
                                  "max": float(diff.max())}
    check(float(per_image.max()) < 6.0,
          f"--bf16 within JAX's bound of float32 (a mean under 6 levels an "
          f"image): {float(per_image.max()):.3g}")
    flops = _forward_flops(gen, x[:1])
    line["gflop_per_image"] = flops / 1e9

    def fwd32():
        with torch.inference_mode():
            return gen(x)

    x16 = x.to(torch.bfloat16)

    def fwd16():
        with torch.inference_mode():
            return gen16(x16)

    line["f32"] = _gen_timing(fwd32, flops * DRAW_B, DRAW_B,
                              H100_F32_FLOP_PER_S)
    line["bf16"] = _gen_timing(fwd16, flops * DRAW_B, DRAW_B,
                               H100_BF16_FLOP_PER_S)
    # a measurement for later work, not the CLI's path: the same bf16
    # batch with the weights and input in channels_last (NHWC) memory
    gen16.to(memory_format=torch.channels_last)
    x16 = x16.contiguous(memory_format=torch.channels_last)
    line["bf16_channels_last_ms"] = time_ms(fwd16, reps=10)
    del x, x16, u8, f32, b16, diff
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    kroot = make_synthetic_kaggle(tmp / "kaggle", **DRAW_KAGGLE)
    line["corpus_write_s"] = time.perf_counter() - t0
    stats = drawings.main(["--corpus", "kaggle", "--data_root", str(kroot),
                           "--model", str(pth), "--image_size",
                           str(GEN_SIZE)])
    n = DRAW_KAGGLE["n_train"] + DRAW_KAGGLE["n_test"]
    check(stats["images"] == n, f"cli/drawings.py drew {n} images")
    line["cli_kaggle"] = {**stats, "images_per_s":
                          stats["images"] / stats["wall_s"]}
    photos = sorted((kroot / "images").iterdir())
    from PIL import Image

    worst = 0
    for s in range(0, n, DRAW_B):
        chunk = photos[s: s + DRAW_B]
        want = drawings.forward_u8(gen, torch.from_numpy(
            decode_paths(chunk, GEN_SIZE)).cuda()).cpu().numpy()
        for img, p in zip(want, chunk):
            got = np.asarray(Image.open(kroot / "contour_drawings"
                                        / f"{p.stem}.png"), np.int32)
            worst = max(worst, int(np.abs(got - img).max()))
    line["cli_kaggle"]["png_vs_in_process_max_levels"] = worst
    check(worst <= 1, f"each PNG within one level of the in-process "
          f"forward: {worst}")
    found = 0
    for cat in get_datasets("KaggleV1", size=1.0, root=kroot,
                            sketch_type="contour_drawings"):
        found += sum(cat.sketch_for(i).is_file() for i in range(len(cat)))
        check(len(cat) > 0 and all(cat.sketch_for(i).is_file()
                                   for i in range(len(cat))),
              "KaggleCatalogV1 finds a contour drawing for every photo")
    line["kaggle_catalog_sketches_found"] = found

    sroot = make_synthetic_sketchy(tmp / "sketchy", **DRAW_SKETCHY)
    stats = drawings.main(["--corpus", "sketchy", "--data_root", str(sroot),
                           "--model", str(pth), "--name", "opensketch",
                           "--image_size", str(GEN_SIZE)])
    shards = sorted(d.name for d in (sroot / "opensketch_drawings").iterdir())
    n = DRAW_SKETCHY["n_classes"] * DRAW_SKETCHY["photos_per_class"]
    check(len(shards) == DRAW_SKETCHY["n_classes"] and sum(
        len(list((sroot / "opensketch_drawings" / d).glob("*.png")))
        for d in shards) == n, "--corpus sketchy: one folder a class, "
        "every photo drawn")
    line["cli_sketchy"] = stats
    line["phase_s"] = time.perf_counter() - t_phase
    emit(line)
    torch.cuda.empty_cache()


def phase_artwork_gen(state) -> None:
    """AdaIN style transfer at 256 px: seed-0 weights written as
    ``vgg_normalised.pth`` and ``decoder.pth`` and loaded through
    ``cli/artwork_gen.py``'s own loader; float32 on the card against
    float64 (the CPU's float32 beside it) at alpha 1.0 and 0.5; the time
    of a batch of 8; then ``cli/artwork_gen.py``'s ``main`` over synthetic
    content and style folders: every content image stylized with the
    style ``random.Random(seed)`` draws."""
    import copy
    import random

    import torch
    from PIL import Image

    from art_sbir_tpu_torch.cli import artwork_gen
    from art_sbir_tpu_torch.core.device import ieee_f32
    from art_sbir_tpu_torch.models.adain_net import (AdaINDecoder,
                                                     AdaINEncoder,
                                                     style_transfer)

    check(state["pil"], "PIL is installed: the phase writes its folders "
          "with it")
    t_phase = time.perf_counter()
    ieee_f32()
    tmp = Path(state["tmp"]) / "artwork_gen"
    (tmp / "adain").mkdir(parents=True)
    torch.save(_he_init(AdaINEncoder(), 0).state_dict(),
               tmp / "adain" / "vgg_normalised.pth")
    torch.save(_he_init(AdaINDecoder(), 1).state_dict(),
               tmp / "adain" / "decoder.pth")
    enc, dec = artwork_gen.load_adain(str(tmp / "adain"),
                                      torch.device("cuda"))
    rng = np.random.default_rng(22)

    def images(n):
        return torch.from_numpy(rng.random((n, 3, GEN_SIZE, GEN_SIZE),
                                           dtype=np.float32)).cuda()

    content, style = images(ART_B), images(ART_B)
    line = {"phase": "artwork_gen", "ok": True, "batch": ART_B,
            "size": GEN_SIZE, "f32_vs_f64": {}}
    cpu = [copy.deepcopy(m).cpu() for m in (enc, dec)]
    exact = [copy.deepcopy(m).double() for m in (enc, dec)]
    c, s = content[:ART_CHECK_B], style[:ART_CHECK_B]
    for alpha in (1.0, 0.5):
        with torch.inference_mode():
            line["f32_vs_f64"][str(alpha)] = _vs_float64(
                lambda: style_transfer(enc, dec, c, s, alpha),
                lambda: style_transfer(*cpu, c.cpu(), s.cpu(), alpha),
                lambda: style_transfer(*exact, c.double(), s.double(),
                                       alpha),
                f"style_transfer at alpha {alpha}")
    del cpu, exact
    with torch.inference_mode():
        feat = enc(content[:1])
    flops = 2 * _forward_flops(enc, content[:1]) + _forward_flops(dec, feat)
    line["gflop_per_image"] = flops / 1e9

    def transfer():
        with torch.inference_mode():
            return style_transfer(enc, dec, content, style)

    line["f32"] = _gen_timing(transfer, flops * ART_B, ART_B,
                              H100_F32_FLOP_PER_S)
    del content, style
    torch.cuda.empty_cache()

    folders = {"content": ART_CONTENT, "style": ART_STYLES}
    for name, n in folders.items():
        (tmp / name).mkdir()
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (GEN_SIZE + 32, GEN_SIZE, 3),
                                         dtype=np.uint8)).save(
                tmp / name / f"{name}{i:03d}.jpg")
    stats = artwork_gen.main([
        "--content_dir", str(tmp / "content"), "--style_dir",
        str(tmp / "style"), "--out_dir", str(tmp / "out"), "--model",
        str(tmp / "adain"), "--seed", "3", "--image_size", str(GEN_SIZE)])
    draw = random.Random(3)
    styles = sorted((tmp / "style").glob("*.jpg"))
    want = {f"content{i:03d}": str(draw.choice(styles))
            for i in range(ART_CONTENT)}
    check(stats["pairs"] == want, "cli/artwork_gen.py pairs each content "
          "image with random.Random(seed)'s style")
    outs = sorted((tmp / "out").glob("*.jpg"))
    check(len(outs) == ART_CONTENT and np.asarray(Image.open(outs[0])).shape
          == (GEN_SIZE, GEN_SIZE, 3), "one 256 px JPEG a content image")
    line["cli"] = {k: v for k, v in stats.items() if k != "pairs"}
    line["cli"]["images_per_s"] = stats["images"] / stats["wall_s"]
    line["phase_s"] = time.perf_counter() - t_phase
    emit(line)
    torch.cuda.empty_cache()


DILATE_SIZES = ((257, 301), (64, 64), (481, 333), (1024, 767), (9, 13),
                (640, 480))


def phase_dilate(state) -> None:
    """``cli/transformations.py -m dilate`` on the card over sparse-stroke
    PNGs of mixed sizes: each output equal, bit for bit, to
    ``dilate_binarize`` on the CPU."""
    import torch
    from PIL import Image

    from art_sbir_tpu_torch.cli import transformations
    from art_sbir_tpu_torch.ops.dilate import dilate_binarize

    check(state["pil"], "PIL is installed: the phase writes PNGs with it")
    t_phase = time.perf_counter()
    folder = Path(state["tmp"]) / "dilate" / "sketches"
    folder.mkdir(parents=True)
    rng = np.random.default_rng(23)
    for i, (h, w) in enumerate(DILATE_SIZES):
        img = np.where(rng.random((h, w)) > 0.97, 0, 255).astype(np.uint8)
        img[rng.random((h, w)) > 0.98] = 251
        Image.fromarray(img, mode="L").save(folder / f"s{i}.png")
    t0 = time.perf_counter()
    transformations.main(["-m", "dilate", "-o", str(folder)])
    cli_s = time.perf_counter() - t0
    for i in range(len(DILATE_SIZES)):
        src = torch.from_numpy(np.array(Image.open(folder / f"s{i}.png")))
        got = np.asarray(Image.open(folder.parent / "dilated_sketches"
                                    / f"s{i}.png"))
        check(np.array_equal(got, dilate_binarize(src).numpy()),
              f"dilate on the card equals the CPU bit for bit (s{i}.png)")
    emit({"phase": "dilate", "ok": True, "images": len(DILATE_SIZES),
          "sizes": DILATE_SIZES, "cli_s": cli_s,
          "phase_s": time.perf_counter() - t_phase})


PIX_B = 6  # cli/pix2pix.py's default batch
PIX_CHECK_B = 2  # the float32 step against float64, on the card and the CPU
PIX_STEP_FWD = 3  # a step's FLOPs as this many of its forward passes'
PIX_GEN_CORPUS = dict(n_classes=4, photos_per_class=40, sketches_per_photo=1,
                      size=GEN_SIZE)
PIX_TRAIN_CORPUS = dict(n_classes=3, photos_per_class=4, sketches_per_photo=1,
                        size=GEN_SIZE)


def _pix2pix_state(model) -> dict:
    """Both nets' parameters and running statistics, and the first Adam
    moment of each parameter, in float64 on the CPU."""
    out = {"params": {}, "stats": {}, "exp_avg": {}}
    for side, net, opt in (("G", model.net_g, model.opt_g),
                           ("D", model.net_d, model.opt_d)):
        for k, p in net.named_parameters():
            out["params"][f"{side}.{k}"] = p.detach().cpu().double()
            out["exp_avg"][f"{side}.{k}"] = (
                opt.state[p]["exp_avg"].detach().cpu().double())
        for k, b in net.named_buffers():
            if "running_" in k:
                out["stats"][f"{side}.{k}"] = b.detach().cpu().double()
    return out


def _pix2pix_vs_float64(rng) -> dict:
    """The full-width float32 G+D step (resnet_9blocks, basic, batch,
    vanilla, dropout off, batch ``PIX_CHECK_B``) on the card (TF32 off)
    and on the CPU, each against the same step in float64 on the card:
    the losses and every running statistic (norm-wise a tensor) within
    twice the CPU's distance plus rtol 1e-5; each parameter's gradient
    (its first Adam moment) and the parameters after Adam within twice
    plus 1e-4. Adam's first step is ``lr * g / (|g| + eps)``, whose
    sensitivity to g's relative error is ``eps / (|g| + eps)``, and at
    this depth the float32 gradients lie about 1% from float64 norm-wise
    on both devices: the parameters are held where the step is set by
    its gradient (|g| >= 1e3 eps, and each float32 side's gradient
    within 10% of float64's, so the step is within 1e-4 lr of float64's);
    an element outside that (every element where the tensor's gradient
    lies below 1e-6 of the nets' largest, a symmetry's zero that both
    float32 sides must show too) moves by a step that rounding and eps
    decide, and is held at 2 * lr on both devices (their count is
    printed)."""
    import torch

    from art_sbir_tpu_torch.core.device import ieee_f32
    from art_sbir_tpu_torch.train.gan import Pix2Pix, Pix2PixConfig

    ieee_f32()
    cfg = Pix2PixConfig(use_dropout=False)
    shape = (PIX_CHECK_B, GEN_SIZE, GEN_SIZE)
    batch = {"A": torch.from_numpy(rng.random((shape[0], 3) + shape[1:],
                                              dtype=np.float32)),
             "B": torch.from_numpy(rng.random((shape[0], 1) + shape[1:],
                                              dtype=np.float32))}
    runs, models = {}, {}
    for name, dev in (("card", "cuda"), ("cpu", "cpu"), ("f64", "cuda")):
        model = Pix2Pix(cfg, seed=0, device=dev)
        if name == "f64":
            model.net_g.double(), model.net_d.double()
        t0 = time.perf_counter()
        losses = {k: float(v) for k, v in model.train_step(batch, 1).items()}
        runs[name] = {"losses": losses, "step_s": time.perf_counter() - t0,
                      **_pix2pix_state(model)}
        if name == "card":
            models[name] = model
    exact, lr = runs["f64"], cfg.lr

    def dist(a, b) -> float:
        return float((a - b).norm() / b.norm())

    fails, worst = [], {}

    def held(what, kind, card_err, cpu_err, tol):
        if card_err > worst.get(kind, (-1.0,))[0]:
            worst[kind] = (card_err, cpu_err, what)
        if card_err > 2.0 * cpu_err + tol:
            fails.append(f"{what}: card {card_err:.3g} from float64, CPU "
                         f"{cpu_err:.3g}, tolerance {tol}")

    for k, v in exact["losses"].items():
        if v != 0.0:
            held(f"loss {k}", "loss", *(abs(runs[s]["losses"][k] - v)
                                        / abs(v) for s in ("card", "cpu")),
                 1e-5)
    for k, v in exact["stats"].items():
        held(f"running statistic {k}", "stats",
             *(dist(runs[s]["stats"][k], v) for s in ("card", "cpu")), 1e-5)
    # Adam's first step is lr * g / (|g| + eps), g = exp_avg / (1 - beta1)
    scale = max(float(m.abs().max()) for m in exact["exp_avg"].values())
    eps, noise_elems = 1e-8, 0
    for k, p64 in exact["params"].items():
        m64 = exact["exp_avg"][k]
        if float(m64.abs().max()) <= 1e-6 * scale:  # a symmetry's zero
            noise = torch.ones_like(m64, dtype=torch.bool)
            for s in ("card", "cpu"):
                if float(runs[s]["exp_avg"][k].abs().max()) > 1e-6 * scale:
                    fails.append(f"{s} gradient of {k}: not rounding noise")
        else:
            held(f"gradient (first Adam moment) of {k}", "grads",
                 *(dist(runs[s]["exp_avg"][k], m64) for s in ("card", "cpu")),
                 1e-4)
            # a step set by its gradient: |g| >= 1e3 eps, and each float32
            # side's gradient within 10% of float64's (the sign and size
            # of a smaller one are rounding's)
            noise = m64.abs() / (1.0 - cfg.beta1) < 1e3 * eps
            for s in ("card", "cpu"):
                noise |= ((runs[s]["exp_avg"][k] - m64).abs()
                          > 0.1 * m64.abs())
        noise_elems += int(noise.sum())
        for s in ("card", "cpu"):
            moved = (runs[s]["params"][k] - p64).abs()[noise]
            if moved.numel() and float(moved.max()) > 2 * lr * (1 + 1e-3):
                fails.append(f"{s} parameter {k}: a noise element past 2 lr")
        keep = ~noise
        if keep.any():
            held(f"parameter {k}", "params",
                 *(dist(runs[s]["params"][k][keep], p64[keep])
                   for s in ("card", "cpu")), 1e-4)
    out = {"batch": PIX_CHECK_B, "note": "card, CPU and float64 steps all "
           "at this batch", "losses": {s: runs[s]["losses"] for s in runs},
           "step_s": {s: runs[s]["step_s"] for s in runs},
           "params_small_gradient_elements_held_at_2lr": noise_elems,
           "worst_vs_f64": {kind: {"what": w, "card": c, "cpu": p}
                            for kind, (c, p, w) in worst.items()}}
    print(json.dumps({"pix2pix_f32_vs_f64": out, "fails": fails}),
          file=sys.stderr, flush=True)
    check(not fails, "the card's float32 pix2pix step against float64: "
          + "; ".join(fails[:5]))

    # the warm-up step on the card: G's parameters put, its statistics move
    model = models["card"]
    g_before = {k: v.clone() for k, v in model.net_g.state_dict().items()}
    losses = model.train_step(batch, 2, decoder_only=True)
    after = model.net_g.state_dict()
    check(all(float(losses[k]) == 0.0 for k in ("G_GAN", "G_L1", "G_total")),
          "decoder_only: the G losses are zeros")
    check(all(torch.equal(v, after[k]) for k, v in g_before.items()
              if "running_" not in k and "num_batches" not in k),
          "decoder_only: G's parameters unchanged bit for bit")
    moved = [k for k, v in g_before.items()
             if "running_" in k and not torch.equal(v, after[k])]
    check(len(moved) == sum("running_" in k for k in g_before),
          "decoder_only: every running statistic of G moved")
    out["decoder_only"] = {"g_params_unchanged": True,
                           "g_stats_moved": len(moved)}
    return out


def _pix2pix_timed(net_g: str, rng) -> dict:
    """float32 (TF32 off) and bf16 steps of ``net_g`` with the basic D at
    batch ``PIX_B``, the CLI's defaults (dropout on): the first step's
    losses and the samples after it held bf16 against float32 (JAX's
    bounds: losses rel 0.1, abs 0.05; samples a mean under 0.05); then
    each form's median step (CUDA events), images/s, peak memory, share
    of its peak from the convolutions' FLOPs, the device's busy share
    over 5 profiled steps and the kernel split of one step, and its
    eval-mode ``generate`` time at ``PIX_B`` (``generate_ms``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from art_sbir_tpu_torch.core.device import ieee_f32
    from art_sbir_tpu_torch.train.gan import Pix2Pix, Pix2PixConfig

    ieee_f32()
    shape = (PIX_B, GEN_SIZE, GEN_SIZE)
    batch = {"A": torch.from_numpy(rng.random((PIX_B, 3) + shape[1:],
                                              dtype=np.float32)).cuda(),
             "B": torch.from_numpy(rng.random((PIX_B, 1) + shape[1:],
                                              dtype=np.float32)).cuda()}
    models, first, samples = {}, {}, {}
    for form, bf16 in (("f32", False), ("bf16", True)):
        models[form] = Pix2Pix(Pix2PixConfig(net_g=net_g, bf16=bf16),
                               seed=0, device="cuda")
        first[form] = {k: float(v) for k, v in
                       models[form].train_step(batch, 1).items()}
        samples[form] = models[form].generate(batch["A"])
    for k in ("G_GAN", "G_L1", "D_real", "D_fake"):
        a, b = first["f32"][k], first["bf16"][k]
        check(np.isfinite(b) and abs(b - a) <= max(0.1 * abs(a), 0.05),
              f"{net_g} bf16 loss {k} within JAX's bounds of float32: "
              f"{b:.5g} against {a:.5g}")
    sample_diff = float((samples["f32"] - samples["bf16"]).abs().mean())
    check(samples["bf16"].dtype == torch.float32 and sample_diff < 0.05,
          f"{net_g} bf16 samples within a mean of 0.05 of float32: "
          f"{sample_diff:.4g}")
    del samples
    g_flops = _forward_flops(models["f32"].net_g.eval(), batch["A"][:1])
    d_flops = _forward_flops(models["f32"].net_d.eval(), torch.cat(
        [batch["A"][:1], batch["B"][:1]], 1))
    # a step: G once and D three times forward (fake, real, G's pass);
    # the backward passes counted as twice the forward
    flops = PIX_STEP_FWD * (g_flops + 3 * d_flops) * PIX_B
    out = {"batch": PIX_B, "gflop_g_forward_per_image": g_flops / 1e9,
           "gflop_d_forward_per_image": d_flops / 1e9,
           "step_flops": flops, "step_flops_factor": PIX_STEP_FWD,
           "first_step_losses": first, "bf16_vs_f32_sample_mean_abs":
           sample_diff}
    for form, peak in (("f32", H100_F32_FLOP_PER_S),
                       ("bf16", H100_BF16_FLOP_PER_S)):
        model = models.pop(form)
        seeds = itertools.count(10)

        def step():
            return model.train_step(batch, next(seeds))

        torch.cuda.reset_peak_memory_stats()
        times = []
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(13):  # 3 warm-up steps, then 10 timed
            start.record()
            step()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms = float(np.median(times[3:]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                step()
            torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        busy_ms = sum(ev.self_device_time_total for ev in prof.key_averages()
                      if ev.device_type == DeviceType.CUDA) / 1e3
        with torch.no_grad():  # G in eval mode (its BN on the convs'
            # float32 accumulators in bf16, models/resnet.py::conv_bn)
            gen_ms = time_ms(lambda: model.generate(batch["A"]), reps=10)
        out[form] = {
            "generate_ms": gen_ms,
            "step_ms_median": ms, "step_ms_all": times[3:],
            "images_per_s": PIX_B * 1e3 / ms,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "bound_ms": 1e3 * flops / peak, "bound_by": "operations",
            "share_of_peak": 1e3 * flops / peak / ms,
            "profiled_wall_ms": wall_ms, "device_busy_ms_per_step":
            busy_ms / 5, "device_busy_share_profiled": busy_ms / wall_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / 5 / ms),
            **_kernel_split(step)}
        del model
        torch.cuda.empty_cache()
    return out


def _pix2pix_cli_generate(tmp: Path, ref: Path) -> dict:
    """``cli/pix2pix.py --mode generate`` (its ``main``) over a synthetic
    Sketchy corpus: every PNG within one level of the in-process forward
    of the same weights."""
    import torch
    from PIL import Image

    from art_sbir_tpu_torch.cli import pix2pix
    from art_sbir_tpu_torch.data.loader import decode_paths
    from art_sbir_tpu_torch.data.synthetic import make_synthetic_sketchy
    from art_sbir_tpu_torch.train.gan import Pix2Pix, Pix2PixConfig

    t0 = time.perf_counter()
    root = make_synthetic_sketchy(tmp / "pix_gen", **PIX_GEN_CORPUS)
    corpus_s = time.perf_counter() - t0
    out_dir = tmp / "photo_sketch"
    stats = pix2pix.main(["--mode", "generate", "--data_root", str(root),
                          "--model", str(ref), "--out_dir", str(out_dir)])
    photos = sorted((root / "photos").rglob("*.jpg"))
    n = len(photos)
    check(stats["images"] == n and len(list(out_dir.glob("*.png"))) == n,
          f"cli/pix2pix.py --mode generate wrote one sketch a photo ({n})")
    model = Pix2Pix(Pix2PixConfig(), device="cuda")
    pix2pix.load_weights(model, str(ref))
    worst = 0
    for s in range(0, n, PIX_B):
        chunk = photos[s: s + PIX_B]
        x = torch.from_numpy(decode_paths(chunk, GEN_SIZE)).cuda()
        want = pix2pix.to_uint8(model.generate(
            x.permute(0, 3, 1, 2).float() / 255.0)[:, 0]).cpu().numpy()
        for img, p in zip(want, chunk):
            got = np.asarray(Image.open(out_dir / f"{p.stem}.png"), np.int32)
            worst = max(worst, int(np.abs(got - img).max()))
    check(worst <= 1, f"each generated PNG within one level of the "
          f"in-process forward: {worst}")
    return {**stats, "images_per_s": stats["images"] / stats["wall_s"],
            "corpus_write_s": corpus_s, "png_vs_in_process_max_levels": worst}


def _pix2pix_cli_train(tmp: Path) -> dict:
    """``cli/pix2pix.py --mode train`` (its ``main``) for 2 epochs on
    SketchyPix2Pix at the defaults: the four JSONs, the loss keys and
    series, finite losses, zero G losses in the warm-up epoch, the sample
    sheet and the export. Then the resume check with the U-Net (which has
    no reflection padding, whose backward on the card adds with atomics)
    under deterministic cuDNN: two epochs in one run and one epoch then
    ``--continue_train`` give the same epoch-2 checkpoint bit for bit."""
    import os

    import torch

    from art_sbir_tpu_torch.cli import pix2pix
    from art_sbir_tpu_torch.data.synthetic import make_synthetic_sketchy
    from art_sbir_tpu_torch.train.gan import LOSS_KEYS

    root = make_synthetic_sketchy(tmp / "pix_train", **PIX_TRAIN_CORPUS)
    run_dir = tmp / "pix_runs"
    run_dir.mkdir()
    cwd = os.getcwd()
    os.chdir(run_dir)
    try:
        common = ["--mode", "train", "--data_root", str(root)]
        t0 = time.perf_counter()
        folder = pix2pix.main(common + ["-e", "2"])
        train_s = time.perf_counter() - t0
        files = {name: json.loads((folder / f"{name}.json").read_text())
                 for name in ("data_params", "training", "training_params",
                              "inference")}
        series = files["training"]["train_losses"]
        check(set(series) == set(LOSS_KEYS) and all(
            len(v) == 2 and np.isfinite(v).all() for v in series.values()),
            "cli/pix2pix.py --mode train: the six loss series, two epochs, "
            "finite")
        check(all(series[k][0] == 0.0 for k in ("G_GAN", "G_L1", "G_total")),
              "the warm-up epoch's G losses are zeros")
        check((folder / "samples.png").is_file(), "the sample sheet written")
        check((run_dir / "models" / f"{folder.name}.pt").is_file(),
              "models/<run>.pt written")
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            unet = common + ["--netG", "unet_256"]
            pix2pix.main(unet + ["-e", "2", "--checkpoint_dir", "whole"])
            pix2pix.main(unet + ["-e", "1", "--checkpoint_dir", "split"])
            pix2pix.main(unet + ["-e", "2", "--checkpoint_dir", "split",
                                 "--continue_train"])
        finally:
            torch.backends.cudnn.deterministic = deterministic
        whole = torch.load(run_dir / "whole" / "2.pt", weights_only=True)
        split = torch.load(run_dir / "split" / "2.pt", weights_only=True)
        same = whole["numpy_rng"] == split["numpy_rng"]
        for side in ("g", "d"):
            same &= all(torch.equal(v, split[side]["model"][k])
                        for k, v in whole[side]["model"].items())
            a, b = (whole[side]["optimizer"]["state"],
                    split[side]["optimizer"]["state"])
            same &= a.keys() == b.keys() and all(
                torch.equal(x, y) for k in a
                for x, y in zip(a[k].values(), b[k].values()))
        check(same, "--continue_train from epoch 1 reproduces the "
              "uninterrupted epoch 2's checkpoint bit for bit")
    finally:
        os.chdir(cwd)
    return {"epochs": 2, "train_s": train_s, "losses": series,
            "steps_per_epoch": -(-files["data_params"]["img_number"]
                                 // PIX_B),
            "resume_bitwise": True}


def phase_pix2pix(state) -> None:
    """pix2pix at full width (256 px, ``ngf`` = ``ndf`` = 64, the basic
    PatchGAN, batch norm, vanilla): the float32 G+D step against float64,
    the warm-up step, timed steps of both generators in float32 and bf16,
    then ``cli/pix2pix.py`` in generate mode over a synthetic corpus and
    in train mode (with the resume check). Seed-0 weights are written as
    a reference directory (``latest_net_G.pth``, ``latest_net_D.pth``)."""
    import torch

    from art_sbir_tpu_torch.train.gan import Pix2Pix, Pix2PixConfig

    check(state["pil"], "PIL is installed: the phase writes its corpora "
          "with it")
    t_phase = time.perf_counter()
    tmp = Path(state["tmp"]) / "pix2pix"
    tmp.mkdir()
    rng = np.random.default_rng(31)
    line = {"phase": "pix2pix", "ok": True, "size": GEN_SIZE}
    t0 = time.perf_counter()
    line["f32_vs_f64"] = _pix2pix_vs_float64(rng)
    line["f32_vs_f64"]["check_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    for net_g in ("resnet_9blocks", "unet_256"):
        t0 = time.perf_counter()
        line[net_g] = _pix2pix_timed(net_g, rng)
        line[net_g]["s"] = time.perf_counter() - t0
    ref = tmp / "pix2pix_ref"
    ref.mkdir()
    model = Pix2Pix(Pix2PixConfig(), seed=0, device="cpu")
    torch.save(model.net_g.state_dict(), ref / "latest_net_G.pth")
    torch.save(model.net_d.state_dict(), ref / "latest_net_D.pth")
    line["cli_generate"] = _pix2pix_cli_generate(tmp, ref)
    line["cli_train"] = _pix2pix_cli_train(tmp)
    line["phase_s"] = time.perf_counter() - t_phase
    emit(line)
    torch.cuda.empty_cache()


# ------------------------------------------------------------ photo2sketch

P2S_B = 64  # cli/photo2sketch.py's default batch
P2S_CHECK_B = 2  # the float32 step against float64, on the card and the CPU
P2S_GEN_B = 4  # the CLI's sample sheet
P2S_STEPS = 101  # 100 stroke rows: 101 decoder steps
P2S_STEP_FWD = 3  # a step's FLOPs as this many of its forward passes'
P2S_CORPUS = dict(n_classes=20, photos_per_class=8, sketches_per_photo=2,
                  size=GEN_SIZE, with_svg=True)
P2S_QUICKDRAW = dict(n_train=48, n_valid=8)  # a category: 288 / 48 sketches


def _p2s_trainer(cfg, dev):
    """A seed-0 trainer with the encoder's convs He-initialized
    (``_he_init``, seed 0): through VGG's 13 convs the fresh init
    (variance 1 / fan_in, halved by each ReLU) shrinks the features
    toward the biases, and the checks would hold the decoder alone."""
    from art_sbir_tpu_torch.train.vae import VAETrainer

    trainer = VAETrainer(cfg, seed=0, device=dev)
    _he_init(trainer.model.Image_Encoder.feature, 0)
    return trainer


def _p2s_vs_float64(rng) -> dict:
    """The full-width float32 VAE step (TF32 off) at batch ``P2S_CHECK_B``
    with a fed eps, on the card and on the CPU, each against the same step
    in float64 on the card: the three losses within twice the CPU's
    distance plus rtol 1e-5, each parameter's gradient before the clip
    (norm-wise) within twice plus 1e-4 (a symmetry's zero, conv_att's bias
    under the softmax, as rounding noise on every side). Then Adam from
    the CPU's gradients on both devices, clip included: each parameter at
    rtol 1e-6 of its value (plus lr)."""
    import torch

    from art_sbir_tpu_torch.core.device import ieee_f32
    from art_sbir_tpu_torch.scripts.probe_dp_cards import sketches
    from art_sbir_tpu_torch.train.vae import VAEConfig

    ieee_f32()
    cfg = VAEConfig()
    b = P2S_CHECK_B
    batch = {"photo": torch.from_numpy(rng.standard_normal(
                 (b, 3, GEN_SIZE, GEN_SIZE)).astype(np.float32)),
             "sketch_vector": torch.from_numpy(sketches(rng, b))}
    eps = torch.from_numpy(rng.standard_normal((b, cfg.z_size))
                           .astype(np.float32))
    runs, trainers = {}, {}
    for name, dev in (("card", "cuda"), ("cpu", "cpu"), ("f64", "cuda")):
        trainer = _p2s_trainer(cfg, dev)
        if name == "f64":
            trainer.model.double()
        t0 = time.perf_counter()
        losses = trainer.compute_gradients(batch, eps)
        runs[name] = {
            "losses": {k: float(v) for k, v in losses.items()},
            "step_s": time.perf_counter() - t0,
            "grads": {k: p.grad.detach().cpu().double()
                      for k, p in trainer.model.named_parameters()}}
        trainers[name] = trainer
    exact = runs["f64"]
    fails, worst, tightest = [], {}, [0.0, ""]

    def held(what, kind, card_err, cpu_err, tol):
        if card_err > worst.get(kind, (-1.0,))[0]:
            worst[kind] = (card_err, cpu_err, what)
        used = card_err / (2.0 * cpu_err + tol)  # of the allowance
        if used > tightest[0]:
            tightest[:] = [used, what]
        if used > 1.0:
            fails.append(f"{what}: card {card_err:.3g} from float64, CPU "
                         f"{cpu_err:.3g}, tolerance {tol}")

    for k, v in exact["losses"].items():
        held(f"loss {k}", "loss", *(abs(runs[s]["losses"][k] - v) / abs(v)
                                    for s in ("card", "cpu")), 1e-5)
    scale = max(float(g.norm()) for g in exact["grads"].values())
    zero = []
    for k, g in exact["grads"].items():
        if float(g.norm()) <= 1e-6 * scale:
            zero.append(k)
            if any(float(runs[s]["grads"][k].norm()) > 1e-6 * scale
                   for s in ("card", "cpu")):
                fails.append(f"gradient of {k}: not rounding noise")
            continue
        held(f"gradient of {k}", "grads",
             *(float((runs[s]["grads"][k] - g).norm() / g.norm())
               for s in ("card", "cpu")), 1e-4)
    norms = {s: float(torch.stack([g.square().sum() for g in
                                   runs[s]["grads"].values()]).sum().sqrt())
             for s in runs}
    # Adam alone: the CPU's gradients (clipped on each device) on both
    for name in ("card", "cpu"):
        trainer = trainers[name]
        for k, p in trainer.model.named_parameters():
            p.grad = runs["cpu"]["grads"][k].float().to(p.device)
        trainer.apply_gradients()
    lr = cfg.learning_rate
    cpu_p = dict(trainers["cpu"].model.named_parameters())
    adam_err = max(float(((p.detach().cpu() - cpu_p[k].detach()).abs()
                          / (cpu_p[k].detach().abs() + lr)).max())
                   for k, p in trainers["card"].model.named_parameters())
    if adam_err > 1e-6:
        fails.append(f"Adam from the same gradients: {adam_err:.3g}")
    out = {"batch": b, "losses": {s: runs[s]["losses"] for s in runs},
           "step_s": {s: runs[s]["step_s"] for s in runs},
           "grad_global_norm": norms, "clip_factor": min(
               1.0, cfg.grad_clip / norms["f64"]),
           "grads_zero_by_symmetry": zero, "adam_rel_err_max": adam_err,
           "worst_vs_f64": {kind: {"what": w, "card": c, "cpu": p}
                            for kind, (c, p, w) in worst.items()},
           "tightest_share_of_allowance": {"share": tightest[0],
                                           "what": tightest[1]}}
    print(json.dumps({"photo2sketch_f32_vs_f64": out, "fails": fails}),
          file=sys.stderr, flush=True)
    check(not fails, "the card's float32 VAE step against float64: "
          + "; ".join(fails[:5]))
    return out


def _p2s_timed(rng) -> dict:
    """float32 (TF32 off) and bf16-encoder steps at batch ``P2S_B`` from
    the same seed-0 weights: the first step's losses held bf16 against
    float32 (JAX's bounds: rel 0.05, abs 0.02); then each form's median
    step (CUDA events, 10 after 3), sketches/s, peak memory, the share of
    its peak from VGG's FLOPs (x ``P2S_STEP_FWD``), the device's busy
    time in one profiled step (its idle share against the median) and its
    kernel split, and VGG's forward and backward alone (device time), the
    rest of the step being the decoder's loop, the losses and Adam."""
    import torch

    from art_sbir_tpu_torch.core.device import ieee_f32
    from art_sbir_tpu_torch.scripts.probe_dp_cards import sketches
    from art_sbir_tpu_torch.train.vae import VAEConfig

    ieee_f32()
    batch = {"photo": torch.from_numpy(rng.standard_normal(
                 (P2S_B, 3, GEN_SIZE, GEN_SIZE)).astype(np.float32)).cuda(),
             "sketch_vector": torch.from_numpy(
                 sketches(rng, P2S_B)).cuda()}
    eps = torch.from_numpy(rng.standard_normal((P2S_B, 128))
                           .astype(np.float32)).cuda()
    trainers, first = {}, {}
    for form, bf16 in (("f32", False), ("bf16", True)):
        trainers[form] = _p2s_trainer(VAEConfig(bf16_encoder=bf16), "cuda")
        first[form] = {k: float(v) for k, v in
                       trainers[form].train_step(batch, eps).items()}
    for k, a in first["f32"].items():
        b = first["bf16"][k]
        check(np.isfinite(b) and abs(b - a) <= max(0.05 * abs(a), 0.02),
              f"Photo2Sketch bf16 loss {k} within JAX's bounds of float32: "
              f"{b:.5g} against {a:.5g}")
    vgg_flops = _forward_flops(trainers["f32"].model.Image_Encoder.feature,
                               batch["photo"][:1])
    flops = P2S_STEP_FWD * vgg_flops * P2S_B
    out = {"batch": P2S_B, "gflop_vgg_forward_per_image": vgg_flops / 1e9,
           "step_flops_vgg": flops, "step_flops_factor": P2S_STEP_FWD,
           "first_step_losses": first}
    for form, peak in (("f32", H100_F32_FLOP_PER_S),
                       ("bf16", H100_BF16_FLOP_PER_S)):
        trainer = trainers.pop(form)
        seeds = itertools.count(10)

        def step():
            return trainer.train_step(batch, next(seeds))

        def vgg_pass():
            trainer.model.Image_Encoder.feature(batch["photo"]).float() \
                .sum().backward()

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(13):  # 3 warm-up steps, then 10 timed
            start.record()
            step()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms = float(np.median(times[3:]))
        peak_mem = torch.cuda.max_memory_allocated()
        # one profiled step: the decoder's loop launches about ten
        # thousand kernels a step, and a profiler session over several
        # steps costs tens of seconds of the phase
        split = _kernel_split(step)
        busy_ms = sum(split["device_ms_by_kind"].values())
        vgg_ms = device_ms(vgg_pass, reps=2)
        out[form] = {
            "step_ms_median": ms, "step_ms_all": times[3:],
            "sketches_per_s": P2S_B * 1e3 / ms,
            "peak_memory_bytes": peak_mem,
            "bound_ms": 1e3 * flops / peak, "bound_by": "operations",
            "share_of_peak": 1e3 * flops / peak / ms,
            "device_busy_ms_per_step": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / ms),
            "vgg_fwd_bwd_device_ms": vgg_ms,
            "rest_device_ms": busy_ms - vgg_ms, **split}
        del trainer
        torch.cuda.empty_cache()
    return out


def _p2s_generate(rng) -> dict:
    """Greedy ``generate`` of ``P2S_STEPS`` steps from the same float32
    weights on the card and on the CPU at batch ``P2S_GEN_B``: the pen
    states equal, or the first step where the two sequences fork and the
    CPU's argmax margin there (the smallest margin of every step along the
    CPU's sequence is printed); shapes and finite values checked. Then
    ``generate`` timed on the card at ``P2S_GEN_B`` and ``P2S_B``."""
    import torch

    from art_sbir_tpu_torch.core.device import ieee_f32
    from art_sbir_tpu_torch.ops.gmm import split_decoder_output
    from art_sbir_tpu_torch.train.vae import VAEConfig

    ieee_f32()
    cfg = VAEConfig()
    photos = torch.from_numpy(rng.standard_normal(
        (P2S_B, 3, GEN_SIZE, GEN_SIZE)).astype(np.float32))
    card = _p2s_trainer(cfg, "cuda")
    cpu = _p2s_trainer(cfg, "cpu")
    few = photos[:P2S_GEN_B]
    s_card, a_card = (t.cpu() for t in card.generate(few, P2S_STEPS))
    with torch.no_grad():
        model = cpu.model
        feat, mu, _ = model.Image_Encoder(few)
        dec = model.Sketch_Decoder
        s_cpu, a_cpu = dec.generate(feat, mu, P2S_STEPS)
        # the argmax margins along the CPU's sequence
        h, c = dec._init_state(mu)
        x_em, tokens = dec.attention_cell.embed(feat)
        stroke, margins = dec._start(P2S_GEN_B, mu), []
        for s in range(P2S_STEPS):
            h, c, _ = dec._step(h, c, stroke, x_em, tokens)
            p = split_decoder_output(dec.fc_params(h), cfg.num_mixture)
            margins.append(min(
                float((v[:, 0] - v[:, 1]).min()) for v in (
                    torch.topk(p.log_pi, 2, dim=-1).values,
                    torch.topk(p.pen_logits, 2, dim=-1).values)))
            stroke = s_cpu[:, s]
    check(s_card.shape == (P2S_GEN_B, P2S_STEPS, 5)
          and a_card.shape == (P2S_GEN_B, P2S_STEPS, 64)
          and bool(torch.isfinite(s_card).all())
          and bool(torch.isfinite(a_card).all()),
          "generate: strokes (4, 101, 5) and attention (4, 101, 64), finite")
    differs = ((s_card[..., 2:] != s_cpu[..., 2:]).any(-1)
               | ((s_card[..., :2] - s_cpu[..., :2]).abs() > 1e-3).any(-1))
    fork = [int(t) for t in torch.nonzero(differs.any(0)).flatten()[:1]]
    out = {"batch": P2S_GEN_B, "steps": P2S_STEPS,
           "pen_states_equal": bool(torch.equal(s_card[..., 2:],
                                                s_cpu[..., 2:])),
           "first_fork_step": fork[0] if fork else None,
           "cpu_margin_at_fork": margins[fork[0]] if fork else None,
           "cpu_margin_min": min(margins),
           "cpu_margin_min_step": int(np.argmin(margins)),
           "before_fork_max_abs_err": float(
               (s_card[:, :fork[0] if fork else None]
                - s_cpu[:, :fork[0] if fork else None]).abs().max()),
           "attention_max_abs_err_before_fork": float(
               (a_card[:, :fork[0] if fork else None]
                - a_cpu[:, :fork[0] if fork else None]).abs().max())}
    for b in (P2S_GEN_B, P2S_B):
        x = photos[:b].cuda()
        out[f"ms_b{b}"] = time_ms(lambda: card.generate(x, P2S_STEPS),
                                  reps=5, warmup=1)
        out[f"device_ms_b{b}"] = device_ms(
            lambda: card.generate(x, P2S_STEPS), reps=2)
    return out


def _p2s_raster(s5: np.ndarray, pts: np.ndarray, segs: np.ndarray,
                s3: np.ndarray) -> dict:
    """The rasterizer at batch ``P2S_B`` on the corpus's own sketches:
    ``rasterize_strokes`` on stroke-5 and stroke-3, ``rasterize_prepared``
    on the catalog's cached points, each on the card equal bit for bit to
    the native C++ rasterizer (``ops/raster_native.py``) and to the same
    function on the CPU; the card's times (CUDA events) and its peak
    memory beside the host's (native and the CPU path, one call each)."""
    import torch

    from art_sbir_tpu_torch.ops import raster_native
    from art_sbir_tpu_torch.ops.rasterize import (rasterize_prepared,
                                                  rasterize_strokes)

    cases = {"stroke5": (rasterize_strokes, (s5,), s5),
             "stroke3": (rasterize_strokes, (s3,), s3),
             "prepared": (rasterize_prepared, (pts, segs), s5)}
    out = {"batch": P2S_B}
    raster_native.load()  # the g++ build, outside the host's times
    for name, (fn, args, strokes) in cases.items():
        host = [torch.from_numpy(a) for a in args]
        dev = [a.cuda() for a in host]
        t0 = time.perf_counter()
        native = raster_native.rasterize_batch_native(strokes)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_cpu = fn(*host).numpy()
        cpu_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        on_card = fn(*dev).cpu().numpy()
        peak = torch.cuda.max_memory_allocated() - base
        check(np.array_equal(on_card, native) and np.array_equal(on_card,
                                                                 on_cpu),
              f"rasterizer {name}: the card equals the native rasterizer "
              f"and the CPU bit for bit "
              f"({int((on_card != native).sum())} pixels off native)")
        out[name] = {"card_ms": time_ms(lambda: fn(*dev), reps=10),
                     "card_peak_bytes": peak, "native_host_ms":
                     1e3 * native_s, "torch_cpu_ms": 1e3 * cpu_s,
                     "lit_pixels_mean": float((on_card > 0).sum(
                         axis=(1, 2)).mean())}
    return out


def _p2s_cli(tmp: Path, root: Path, what: str, flags: list) -> dict:
    """``cli/photo2sketch.py`` (its ``main``) for one epoch at batch
    ``P2S_B`` with ``--save_rate 1`` from ``tmp / what``: the four JSONs
    and their keys, finite losses, ``models/<run>.pt``, the sample SVGs,
    JSONs and sheet; the wall time and its split."""
    import os

    from art_sbir_tpu_torch.cli import photo2sketch
    from art_sbir_tpu_torch.train.vae import LOSS_KEYS

    run_dir = tmp / what
    run_dir.mkdir()
    cwd = os.getcwd()
    os.chdir(run_dir)
    try:
        stats = photo2sketch.main(
            ["--data_root", str(root), "--size", "1.0", "--batchsize",
             str(P2S_B), "--max_epoch", "1", "--save_rate", "1"] + flags)
    finally:
        os.chdir(cwd)
    folder = run_dir / stats["folder"]
    files = {name: json.loads((folder / f"{name}.json").read_text())
             for name in ("data_params", "training", "training_params",
                          "inference")}
    for split in ("train_losses", "test_losses"):
        series = files["training"][split]
        check(set(series) == set(LOSS_KEYS) and all(
            len(v) == 1 and np.isfinite(v).all() for v in series.values()),
            f"cli/photo2sketch.py {what}: {split}, one epoch, finite")
    samples = sorted(folder.glob("sample_1_*.json"))
    check(len(samples) == P2S_GEN_B and all(
        np.asarray(json.loads(p.read_text())["image"]).shape
        == (P2S_STEPS, 5) and p.with_suffix(".svg").is_file()
        for p in samples) and (folder / "samples_1.png").is_file(),
        f"cli/photo2sketch.py {what}: four samples (SVG, JSON) and the sheet")
    check((run_dir / stats["model"]).is_file(), "models/<run>.pt written")
    n = files["data_params"]["img_number"]
    return {"sketches": n, "steps": -(-n // P2S_B),
            "losses": files["training"]["train_losses"],
            "model": str(run_dir / stats["model"]),
            **{k: v for k, v in stats.items() if k.endswith("_s")}}


def phase_photo2sketch(state) -> None:
    """Photo2Sketch at full width (VGG16 at 256 px, ``z_size`` 128,
    ``dec_rnn_size`` 512, 20 mixtures, 100 stroke rows, batch 64): the
    float32 step against float64, timed steps in float32 and bf16, the
    greedy decode against the CPU's, then ``cli/photo2sketch.py`` on a
    synthetic Sketchy corpus with SVGs (``--img_format svg``, then
    ``jpg``) and on six synthetic QuickDraw archives, ``--model`` from the
    saved ``.pt``, and the rasterizer on the corpus's sketches."""
    import torch

    from art_sbir_tpu_torch.cli import photo2sketch
    from art_sbir_tpu_torch.data import get_datasets
    from art_sbir_tpu_torch.data.synthetic import (make_synthetic_quickdraw,
                                                   make_synthetic_sketchy)
    from art_sbir_tpu_torch.train.vae import VAEConfig, VAETrainer

    check(state["pil"], "PIL is installed: the phase writes its corpora "
          "with it")
    t_phase = time.perf_counter()
    tmp = Path(state["tmp"]) / "photo2sketch"
    tmp.mkdir()
    rng = np.random.default_rng(37)
    line = {"phase": "photo2sketch", "ok": True, "size": GEN_SIZE}
    for name, fn in (("f32_vs_f64", _p2s_vs_float64), ("steps", _p2s_timed),
                     ("generate", _p2s_generate)):
        t0 = time.perf_counter()
        line[name] = fn(rng)
        line[name]["s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    sketchy = make_synthetic_sketchy(tmp / "sketchy", **P2S_CORPUS)
    quickdraw = make_synthetic_quickdraw(tmp / "quick_draw", seed=5,
                                         **P2S_QUICKDRAW)
    line["corpus_write_s"] = time.perf_counter() - t0
    cli = {}
    for what, root, flags in (
            ("svg", sketchy, ["--img_format", "svg"]),
            ("jpg", sketchy, ["--img_format", "jpg"]),
            ("quickdraw", quickdraw, ["--setup", "Quickdraw"])):
        cli[what] = _p2s_cli(tmp, root, what, flags)
    # --model from the saved .pt restores its parameters bit for bit
    saved = torch.load(cli["svg"]["model"], weights_only=True)
    trainer = VAETrainer(VAEConfig(), seed=1, device="cuda")
    photo2sketch.load_weights(trainer, cli["svg"]["model"])
    got = trainer.model.state_dict()
    check(set(got) == set(saved) and all(
        torch.equal(got[k].cpu(), v) for k, v in saved.items()),
        "--model restores the saved parameters bit for bit")
    line["cli"] = cli

    train_svg = get_datasets("VectorizedSketchyV1", size=1.0,
                             img_format="svg", max_erase_count=1,
                             root=sketchy)[0]
    items = [train_svg.item(i) for i in range(P2S_B)]
    qd = get_datasets("QuickdrawV1", size=1.0, root=quickdraw)[0]
    s3 = np.zeros((P2S_B, 100, 3), np.float32)
    for i, sk in enumerate(qd.sketches[:P2S_B]):
        s3[i, :len(sk)] = sk
    t0 = time.perf_counter()
    line["raster"] = _p2s_raster(
        np.stack([it["sketch_vector"] for it in items]),
        np.stack([it["raster_points"] for it in items]),
        np.stack([it["raster_segs"] for it in items]), s3)
    line["raster"]["s"] = time.perf_counter() - t0
    line["phase_s"] = time.perf_counter() - t_phase
    emit(line)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- goldens

GOLDEN_IVF_N = 100_000  # probe_ivf's gallery in the goldens phase
# The ci preset runs twice, each held to the port's CPU golden of its
# precision. In bf16 (cli/train.py's default, 3 steps of 4) the port's
# CPU run at 1, 2, 4 and 8 intra-op threads (scripts/probe_ci_spread.py),
# from JAX's own seed-0 init, spans final train losses 4.0356-4.5421
# (11.2% of the CPU golden's 4.5421) and test losses 1.30465-1.31094
# (0.481%): bf16 sums move with the order of their products, and the
# card's order is cuDNN's. That train-loss spread tells no runs apart
# (the CPU's bf16 and float32 runs lie 9% apart), so the bf16 run is
# held by its test loss alone, within twice that spread. In float32
# (--no-bf16, TF32 off) the same four CPU runs span train losses
# 4.15099-4.17248 (0.517% of the golden's 4.15441: Adam's sign-like
# first steps carry each run's float32 noise) and test losses
# 1.306114-1.306438 (0.0248%); the card's convolutions (cuDNN's
# algorithms) lie farther from the CPU's than the CPU's thread counts do
# in the test loss, so both losses are held within twice the wider of
# the two spreads.
CI_TEST_RTOL = 0.0097
CI_F32_RTOL = 0.0104
# gan_ci and vae_ci train in float32 (their CLIs' default, TF32 off) for
# two epochs, and the CPU's runs at 1 to 4 threads agree within 3e-6.
# The VAE draws its noise on the host (the same on the card), but G's
# dropout masks come from a generator on the device seeded per step: the
# card's generator (Philox) draws other masks than the CPU's from the
# same seeds, so the card's gan_ci series is another draw of the same
# process, not a rounding of the CPU's. JAX's
# bounds for such a pair (bf16 against float32: rel 0.05, abs 0.02),
# doubled for two epochs of draws on 4-image batches; a broken step (no
# update, a NaN, a wrong sign) moves these losses by far more.
GEN_RTOL, GEN_ATOL = 0.1, 0.04


def _golden_ci(tmp: Path, bf16: bool) -> dict:
    """The ``ci`` preset on the card (``bf16`` False: ``--no-bf16``)
    against the port's CPU golden of that precision."""
    import contextlib

    from art_sbir_tpu_torch.cli import goldens
    from art_sbir_tpu_torch.core.results import RESULT_FILES

    tag = "ci" if bf16 else "ci_f32"
    cpu = json.loads((ROOT / "goldens" / f"torch_{tag}_cpu.json")
                     .read_text())
    tmp.mkdir()
    t0 = time.perf_counter()
    with contextlib.chdir(tmp):  # the CLI exports models/<run>.pt here
        got = goldens.main(["--preset", "ci", "--device", "cuda",
                            "--root", "data", "--results_root", "results",
                            "--out", f"torch_{tag}_cuda.json"]
                           + ([] if bf16 else ["--no-bf16"]))
        runs = sorted(Path("results").iterdir())
        check(len(runs) == 1 and all((runs[0] / f"{name}.json").is_file()
                                     for name in RESULT_FILES),
              f"{tag}: the 4-JSON contract ({sorted(RESULT_FILES)})")
    wall = time.perf_counter() - t0
    check(got["backend"] == "cuda" and "H100" in got.get("device_name", ""),
          f"{tag}: the golden names the card ({got.get('device_name')})")
    check((got["n_gallery"], got["n_queries"])
          == (cpu["n_gallery"], cpu["n_queries"]),
          f"{tag}: gallery and queries {got['n_gallery']}, "
          f"{got['n_queries']} as the CPU golden's {cpu['n_gallery']}, "
          f"{cpu['n_queries']}")
    check(all(np.isfinite([got["final_train_loss"],
                           got["final_test_loss"]])), f"{tag}: finite losses")
    check(got["topk_acc"] == sorted(got["topk_acc"]),
          f"{tag}: topk_acc non-decreasing ({got['topk_acc']})")
    check(0.0 < got["mrr"] <= 1.0, f"{tag}: MRR {got['mrr']} in (0, 1]")
    losses = {}
    for key in ("final_train_loss", "final_test_loss"):
        rtol = (CI_F32_RTOL if not bf16 else
                CI_TEST_RTOL if key == "final_test_loss" else None)
        rel = abs(got[key] - cpu[key]) / abs(cpu[key])
        losses[key] = {"card": got[key], "cpu_golden": cpu[key],
                       "rel": rel, "rtol": rtol}
        if rtol is not None:
            check(rel <= rtol, f"{tag}: {key} {got[key]} within rel {rtol} "
                  f"of the CPU golden's {cpu[key]} (rel {rel:.3g})")
    return {"n_gallery": got["n_gallery"], "n_queries": got["n_queries"],
            "mrr": got["mrr"], "cpu_mrr": cpu["mrr"],
            "chance_mrr": got["chance_mrr"], "topk_acc": got["topk_acc"],
            "losses": losses, "device_name": got["device_name"],
            "power_limit": got["power_limit"], "wall_s": wall,
            "wall_times_s": got["wall_times_s"]}


def _golden_generative(tmp: Path, preset: str) -> dict:
    """``gan_ci`` or ``vae_ci`` on the card against the port's CPU
    golden: the same loss series, finite, within ``GEN_RTOL`` and
    ``GEN_ATOL``."""
    from art_sbir_tpu_torch.cli import goldens

    cpu = json.loads((ROOT / "goldens" / f"torch_{preset}_cpu.json")
                     .read_text())
    got = goldens.main(["--preset", preset, "--device", "cuda", "--root",
                        str(tmp), "--out", str(tmp / f"torch_{preset}.json")])
    check(got["backend"] == "cuda", f"{preset}: recorded on the card")
    worst = {}
    for split in ("train_losses", "test_losses"):
        check(sorted(got.get(split, {})) == sorted(cpu.get(split, {})),
              f"{preset}: the CPU golden's {split} keys")
        for key, want in cpu.get(split, {}).items():
            have = np.asarray(got[split][key], np.float64)
            want = np.asarray(want, np.float64)
            check(have.shape == want.shape and np.isfinite(have).all(),
                  f"{preset}: {split}[{key}] finite, {len(want)} entries")
            err = np.abs(have - want)
            check(bool((err <= GEN_ATOL + GEN_RTOL * np.abs(want)).all()),
                  f"{preset}: {split}[{key}] {have.tolist()} within rel "
                  f"{GEN_RTOL} of the CPU golden's {want.tolist()}")
            worst[f"{split}.{key}"] = float(
                (err / np.maximum(np.abs(want), 1e-12)).max())
    return {"final": {k: v[-1] for k, v in got["train_losses"].items()},
            "worst_rel_to_cpu": worst, "wall_times_s": got["wall_times_s"]}


def phase_goldens(state) -> None:
    """The pipeline goldens' CI presets on the card, then the IVF probe at
    100,000 rows through K1 and K2 (counted)."""
    import torch

    from art_sbir_tpu_torch.ops.quant import (_quantize_queries,
                                              retrieve_quantized)
    from art_sbir_tpu_torch.ops.quant_fused import quant_candidates_reference
    from art_sbir_tpu_torch.scripts import probe_ivf

    t_phase = time.perf_counter()
    tmp = Path(state["tmp"]) / "goldens"
    tmp.mkdir()
    line = {"phase": "goldens", "ok": True,
            "ci": _golden_ci(tmp / "ci", bf16=True),
            "ci_f32": _golden_ci(tmp / "ci_f32", bf16=False)}
    for preset in ("gan_ci", "vae_ci"):
        t0 = time.perf_counter()
        line[preset] = _golden_generative(tmp / preset, preset)
        line[preset]["wall_s"] = time.perf_counter() - t0

    counters = _counters()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    res = probe_ivf.run(GOLDEN_IVF_N, D, rounds=1, clustered=True,
                        device="cuda", batches=(1, 8))
    probe_s = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    fallback = {name: c.fallback_rows for name, c in counters.items()}
    check(launches["K1"] > 0 and launches["K2"] > 0,
          f"probe_ivf launched K1 and K2 ({launches})")
    check(launches["K1_bf16"] == 0 and launches["P1"] == 0,
          f"probe_ivf launched no other kernel ({launches})")
    check(not any(fallback.values()), f"no fallback rows ({fallback})")
    state["launches"]["K1"] = state["launches"].get("K1", 0) + launches["K1"]
    state["launches"]["K2"] = state["launches"].get("K2", 0) + launches["K2"]
    arr = res["arrays"]
    q, g = arr["queries"], arr["gallery"]
    ev, ei = arr["exact"]
    held = {}
    for tag in ("K1 f32", "K1 f32 gg"):  # K1 reports squared distances
        v, i = (t.to(g.device) for t in arr[tag])
        held[tag] = _near_exact((torch.sqrt(torch.clamp(v, min=0.0)), i),
                                (ev, ei), q, g, "euclidean",
                                f"probe_ivf {tag} on the near-row queries")
    # The int8 route returns the exact top-10 of K2's 40 candidates: it
    # equals the plain int8 route bit for bit (K2 is exact by
    # construction), and each neighbour of the exact route's top-10 that
    # it lacks lies outside the int8 scan's top 40 (the route's
    # approximation, counted) or within float32's reach of the route's
    # 10th in float64 (a near-tie, as _missing_in_float64 allows).
    tag = "K2 r40+rerank"
    v, i = (t.to(g.device) for t in arr[tag])
    pv, pi = retrieve_quantized(q, arr["quantized"], g, k=K, rerank_factor=4)
    check(torch.equal(i.long(), pi.long()) and torch.equal(v, pv),
          f"probe_ivf {tag}: the plain int8 route's top-10 bit for bit")
    missing = sum(len(set(ei[r].tolist()) - set(i[r].tolist()))
                  for r in range(len(q)))
    held[tag] = {"equals_plain_route": True, "missing_of_exact": missing,
                 "of": int(ei.numel())}
    for r in range(len(q)):
        held_r = set(i[r].tolist())
        if held_r != set(ei[r].tolist()):
            _, cand, _ = quant_candidates_reference(
                *_quantize_queries(q[r:r + 1].float(), "euclidean"),
                arr["quantized"].q8, arr["quantized"].scale,
                arr["quantized"].sq_norm, r=4 * K, metric="euclidean")
            q64, kth = q[r].double(), int(i[r, -1])
            d_k = float(((g[kth].double() - q64) ** 2).sum())
            for m in (set(ei[r].tolist()) - held_r) & set(cand[0].tolist()):
                d_m = float(((g[m].double() - q64) ** 2).sum())
                reach = 1e-5 * (d_k + 2 * float((q64 ** 2).sum())
                                + float((g[m].double() ** 2).sum())
                                + float((g[kth].double() ** 2).sum()))
                check(abs(d_m - d_k) <= reach,
                      f"probe_ivf {tag}: query {r}'s neighbour {m}, among "
                      f"the int8 top {4 * K}, is missing beyond a near-tie")
    del arr, q, g
    line["probe_ivf"] = {
        "n": GOLDEN_IVF_N, "build_s": res["build_s"], "stats": res["stats"],
        "recall": res["recall"], "ms_per_dispatch": res["ms_per_dispatch"],
        "held_to_exact": held, "launches": launches, "s": probe_s}
    line["phase_s"] = time.perf_counter() - t_phase
    emit(line)
    torch.cuda.empty_cache()


# -------------------------------------------------------------- inventory

INCEPTION_B = 8
INCEPTION_CLASSES = 125  # the reference's classifier head (utils.py:170)
CLIP_TEXT = (512, 8, 77)  # d_model, heads, tokens of CLIP's text tower
CLIP_B = 8
CLIP_IMAGES = (8, 375, 500)  # uint8 photos to clip_preprocess
GRAM_MAP = (8, 512, 32, 32)  # VGG relu4 at 256 px
INVENTORY_S = 20.0


def _calibrated_inception_state(x) -> dict:
    """The seed-0 InceptionV3's state dict (on the CPU) with each
    BatchNorm's running statistics set to a train-mode pass's batch
    statistics over ``x`` on the card (momentum 1 for that pass, dropout
    off), so its eval forward is normalized as a trained one is."""
    import torch

    from art_sbir_tpu_torch.models.inception import create_inception
    from art_sbir_tpu_torch.models.resnet import BatchNorm2d

    model = create_inception(INCEPTION_CLASSES, seed=0).to(x.device)
    for bn in model.modules():
        if isinstance(bn, BatchNorm2d):
            bn.momentum = 1.0
    model.dropout.p = 0.0
    with torch.no_grad():
        model.train()(x)
    return {k: v.cpu() for k, v in model.state_dict().items()}


def _inception(every_feat: bool, sd: dict):
    """An InceptionV3 on the CPU, in eval mode, holding ``sd`` (without the
    aux head's keys where ``every_feat`` makes none)."""
    from art_sbir_tpu_torch.models.inception import InceptionV3

    model = InceptionV3(INCEPTION_CLASSES, every_feat=every_feat)
    own = model.state_dict()
    model.load_state_dict({k: v for k, v in sd.items() if k in own})
    return model.eval()


def _stats_vector(model):
    import torch

    return torch.cat([t.flatten().double().cpu()
                      for k, t in model.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))])


def _encoder_init_digest() -> dict:
    """The flagship's seed-0 fresh init (``ModifiedResNetWithClassification``,
    224 px, 125 classes) drawn on the card's host by ``create_encoder`` onto the
    card, held to ``goldens/torch_jax_init_seed0.json``, the digest of
    JAX's own ``model.init(jax.random.key(0))`` (shapes, sums, sums of
    squares, the bits of each tensor's first 16 values), by
    ``models/flax_draw.py::digest_mismatches``' rule (each drawn value
    within ``DRAW_ULP`` float32 ulp of JAX's, constants equal)."""
    from art_sbir_tpu_torch.models import flax_draw
    from art_sbir_tpu_torch.models.resnet import create_encoder

    want = json.loads((ROOT / "goldens" / "torch_jax_init_seed0.json")
                      .read_text())
    flax_draw.encoder_state.cache_clear()  # time one whole draw
    t0 = time.perf_counter()
    model = create_encoder(with_classification=True, num_classes=125,
                           device="cuda", seed=0)
    draw_s = time.perf_counter() - t0
    check(next(model.parameters()).is_cuda, "the encoder is on the card")
    bad = flax_draw.digest_mismatches(
        {k: v.cpu() for k, v in model.state_dict().items()}, want)
    check(not bad, f"the flagship's seed-0 init against JAX's digest: "
          f"{len(bad)} departures, first {bad[:3]}")
    n = sum(p.numel() for p in model.parameters())
    del model
    return {"tensors": len(want), "parameters": n,
            "draw_and_build_s": draw_s, "departures": len(bad),
            "ulp_bound": flax_draw.DRAW_ULP}


def _families_init_digest() -> dict:
    """Every other family's seed-0 fresh init at the full width of its
    entry point (pix2pix's G and D, the VAE, the drawing generator, the
    AdaIN pair, InceptionV3 with its aux head, the CLIP block at width
    512; ``models/flax_families.py::seed0_draws``), drawn on the card's
    host, each timed whole and printed, and held to
    ``goldens/torch_jax_init_families_seed0.json`` (JAX's own inits,
    ``tests/test_torch_jax_init_families.py``) by ``digest_mismatches``'
    rule."""
    from art_sbir_tpu_torch.models import flax_draw, flax_families

    want = json.loads((ROOT / "goldens" / "torch_jax_init_families_seed0"
                       ".json").read_text())
    draws = flax_families.seed0_draws()
    check(sorted(draws) == sorted(want), f"the digest's families "
          f"{sorted(want)} are the ones drawn {sorted(draws)}")
    flax_families.clear_caches()
    out = {}
    for name, draw in draws.items():
        t0 = time.perf_counter()
        sd = draw()
        draw_s = time.perf_counter() - t0
        bad = flax_draw.digest_mismatches(sd, want[name])
        print(f"inventory: {name} seed-0 init drawn in {draw_s:.3f} s, "
              f"{len(bad)} departures from JAX's digest", flush=True)
        check(not bad, f"{name}'s seed-0 init against JAX's digest: "
              f"{len(bad)} departures, first {bad[:3]}")
        out[name] = {"tensors": len(sd), "float_values": sum(
            t.numel() for t in sd.values() if t.is_floating_point()),
            "draw_s": draw_s, "departures": len(bad)}
    flax_families.clear_caches()
    return out


def phase_inventory(state) -> None:
    """InceptionV3, the CLIP transformer block, ``clip_preprocess`` and
    ``gram_matrix`` on the card (the phase list at the top)."""
    import copy

    import torch

    from art_sbir_tpu_torch.core.device import ieee_f32
    from art_sbir_tpu_torch.models import transformer as T
    from art_sbir_tpu_torch.ops.resize import CLIP_STD, clip_preprocess
    from art_sbir_tpu_torch.ops.style_misc import gram_matrix

    t_phase = time.perf_counter()
    ieee_f32()
    cuda = torch.device("cuda")
    gen = torch.Generator().manual_seed(17)
    line = {"phase": "inventory", "ok": True}
    line["encoder_init"] = _encoder_init_digest()
    line["families_init"] = _families_init_digest()

    x = torch.rand(INCEPTION_B, 3, 299, 299, generator=gen)
    x_cuda = x.to(cuda)
    sd = _calibrated_inception_state(x_cuda)
    inc = {}
    for every_feat in (False, True):
        cpu = _inception(every_feat, sd)
        card = copy.deepcopy(cpu).to(cuda)
        f64 = copy.deepcopy(cpu).double().to(cuda)
        with torch.no_grad():
            outs = {"card": card(x_cuda), "cpu": cpu(x),
                    "f64": f64(x_cuda.double())}
        names = ("logits", "features" if every_feat else "aux")
        entry = {}
        for j, name in enumerate(names):
            if outs["card"][j] is None:
                check(name == "aux" and outs["cpu"][j] is None,
                      f"inception eval: {name} is None on one side only")
                continue
            want = {"logits": (INCEPTION_B, INCEPTION_CLASSES),
                    "features": (INCEPTION_B, 768, 17, 17)}[name]
            check(tuple(outs["card"][j].shape) == want
                  and bool(torch.isfinite(outs["card"][j]).all()),
                  f"inception {name}: shape {tuple(outs['card'][j].shape)} "
                  f"finite, want {want}")
            entry[name] = _vs_float64(lambda: outs["card"][j],
                                      lambda: outs["cpu"][j],
                                      lambda: outs["f64"][j],
                                      f"inception every_feat={every_feat} "
                                      f"{name}")
        with torch.no_grad():
            entry["ms"] = time_ms(lambda: card(x_cuda), reps=5, warmup=2)
        inc[f"every_feat={every_feat}"] = entry
        del card, f64

    # one train-mode forward: the aux head's logits, the running statistics
    cpu = _inception(False, sd)
    card = copy.deepcopy(cpu).to(cuda)
    f64 = copy.deepcopy(cpu).double().to(cuda)
    for m, dev in ((cpu, "cpu"), (card, "cuda"), (f64, "cuda")):
        m.train().dropout.generator = torch.Generator(dev).manual_seed(0)
    x2 = torch.rand(INCEPTION_B, 3, 299, 299, generator=gen)
    with torch.no_grad():
        logits, aux = card(x2.to(cuda))
        cpu(x2)
        f64(x2.to(cuda).double())
    check(tuple(aux.shape) == (INCEPTION_B, INCEPTION_CLASSES)
          and bool(torch.isfinite(aux).all() and torch.isfinite(logits).all()),
          f"inception train mode: aux logits {tuple(aux.shape)}, finite")
    inc["train_mode"] = {"aux_shape": list(aux.shape),
                         "running_stats": _vs_float64(
                             lambda: _stats_vector(card),
                             lambda: _stats_vector(cpu),
                             lambda: _stats_vector(f64),
                             "inception train-mode running statistics")}
    line["inception"] = inc
    del cpu, card, f64

    # the CLIP text block
    d, heads, t = CLIP_TEXT
    block = T.init_weights(T.ResidualAttentionBlock(d, heads), seed=0)
    xt = torch.randn(CLIP_B, t, d, generator=gen)
    mask = T.causal_mask(t)
    card = copy.deepcopy(block).to(cuda)
    f64 = copy.deepcopy(block).double().to(cuda)
    with torch.no_grad():
        outs = {"card": card(xt.to(cuda), mask.to(cuda)),
                "cpu": block(xt, mask),
                "f64": f64(xt.to(cuda).double(), mask.to(cuda).double())}
        half = xt.to(cuda).half()
        ln16 = card.ln_1(half)
        out16 = card(half, mask.to(cuda))
        ms = time_ms(lambda: card(xt.to(cuda), mask.to(cuda)))
    check(ln16.dtype == torch.float16,
          f"LayerNormFp32 of a float16 input returned {ln16.dtype}")
    rel16 = float((out16.double() - outs["f64"]).norm()
                  / outs["f64"].norm())
    check(bool(torch.isfinite(out16).all()) and rel16 < 1e-2,
          f"the block on a float16 input: {rel16:.3g} from float64")
    line["transformer"] = {
        "shape": [CLIP_B, t, d], "heads": heads,
        "float32": _vs_float64(lambda: outs["card"], lambda: outs["cpu"],
                               lambda: outs["f64"], "transformer block"),
        "float16_input": {"ln_dtype": str(ln16.dtype),
                          "out_dtype": str(out16.dtype), "rel_err": rel16},
        "ms": ms}

    # clip_preprocess: the card against the CPU
    n, h, w = CLIP_IMAGES
    u8 = torch.randint(0, 256, (n, h, w, 3), dtype=torch.uint8,
                       generator=gen)
    level = 1.0 / 255.0 / min(CLIP_STD)  # one uint8 level, normalized
    pre = {}
    for crop in (False, True):
        got = clip_preprocess(u8.to(cuda), 224, crop=crop).cpu()
        want = clip_preprocess(u8, 224, crop=crop)
        diff = (got - want).abs()
        moved = int((diff > 1e-5).sum())
        check(got.shape == (n, 224, 224, 3) and got.dtype == torch.float32
              and float(diff.max()) <= level + 1e-5
              and moved <= 1e-3 * diff.numel(),
              f"clip_preprocess crop={crop}: max {float(diff.max()):.3g} "
              f"(one level {level:.3g}), {moved} values moved")
        pre[f"crop={crop}"] = {
            "max_abs_err": float(diff.max()), "values_moved": moved,
            "ms": time_ms(lambda: clip_preprocess(u8.to(cuda), 224,
                                                  crop=crop), reps=5)}
    line["clip_preprocess"] = pre

    fmap = torch.rand(*GRAM_MAP, generator=gen)
    fmap_cuda = fmap.to(cuda)
    line["gram_matrix"] = {
        "shape": list(GRAM_MAP),
        **_vs_float64(lambda: gram_matrix(fmap_cuda),
                      lambda: gram_matrix(fmap),
                      lambda: gram_matrix(fmap_cuda.double()),
                      "gram_matrix"),
        "ms": time_ms(lambda: gram_matrix(fmap_cuda))}

    line["phase_s"] = time.perf_counter() - t_phase
    check(line["phase_s"] < INVENTORY_S,
          f"inventory took {line['phase_s']:.1f} s (limit {INVENTORY_S})")
    emit(line)
    torch.cuda.empty_cache()


# ------------------------------------------------------------------- main

PHASES = ("build", "kernels", "kernels_k2", "kernels_int8_wide", "probe_k1",
          "encoder", "serve", "serve_quant", "ivf", "serve_ivf", "online_ivf",
          "inference", "inference_k1", "sharded", "train", "train_dp",
          "train_tp",
          "drawings", "artwork_gen", "dilate", "pix2pix", "photo2sketch",
          "goldens", "inventory")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--phases", default=None,
        help="comma-separated phases to run (build is always first; "
             "sharded needs inference and inference_k1; train, train_dp, "
             "train_tp, "
             "drawings, artwork_gen, dilate, pix2pix, photo2sketch, "
             "goldens and inventory need no other phase); a "
             "partial run "
             "prints no kernels line and no result line")
    args = parser.parse_args(argv)
    names = PHASES if args.phases is None else ["build"] + [
        p for p in args.phases.split(",") if p != "build"]
    unknown = set(names) - set(PHASES)
    if unknown:
        parser.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "card only", file=sys.stderr)
        return 1
    import art_sbir_tpu_torch  # noqa: F401  (fails outside a checkout)

    walls = {}  # each phase's wall seconds, on standard error as it ends
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        state = {"launches": {}, "tmp": tmp}
        for name in names:
            t0 = time.perf_counter()
            globals()["phase_" + name](state)
            walls[name] = time.perf_counter() - t0
            print(json.dumps({"phase_wall_s": {name: walls[name]},
                              "script_s": time.perf_counter() - t_all}),
                  file=sys.stderr, flush=True)
    print(json.dumps({"phase_walls_s": walls,
                      "script_s": time.perf_counter() - t_all}),
          file=sys.stderr, flush=True)
    if args.phases is not None:
        print("chip_smoke: partial run, phases " + ",".join(names),
              flush=True)
        return 0
    emit({"kernels": [{**state[name.lower()],
                       "launches": state["launches"][name]}
                      for name in ("K1", "K1_bf16", "K2", "P1", "K1_sharded",
                                   "K2_sharded", "K1_merge_shards")]})
    print(state["card"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
