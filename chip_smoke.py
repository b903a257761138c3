#!/usr/bin/env python3
"""Drive the PyTorch port's training and serving paths on one NVIDIA card.

    python3 chip_smoke.py [--out results.json]

It checks; it does not measure the port. The port's times are the
benchmark's (``python3 benchmark/run.py --workload <cell> --seed <n>
--seconds 50 --trace 1``); the only times here are phase 7's, each
kernel's cold time at the shapes the main paths launched.

Phases, each fatal on failure (exit code 1, and no result line):

  1. device: a CUDA device must be present; prints the card's name and
     power limit as nvidia-smi reports them;
  2. build: compiles every kernel of the paths from the sources in this
     checkout (triplegan_tpu_torch/ops/csrc: scale_bias_act.cu, conv3x3.cu
     for float32 convs, conv3x3_sm90.cu for bfloat16 convs), one nvcc per
     source, all started together, and prints each build's seconds;
  2b. doctor: the datasets of phases 3c, 5 and 5c written as their
     distribution files (CIFAR-10 python pickle batches, MNIST idx files
     and SVHN .mat files, 4096 train and 1000 test images each; STL-10
     binaries, 2048 and 256), seeded synthetic images, and converted by
     ``python -m triplegan_tpu_torch.cli prepare`` (cifar10 with its ZCA
     statistics); then ``cli doctor --config
     cifar10_4k`` on the cifar10 shards must exit 0, its device finding
     naming the card and each kernel its probe built, launched once and
     held to its plain twin (``doctor.PROBE``: scale_bias_act forward and
     backward, conv3x3 forward and wgrad, float32 and bfloat16); ``cli
     doctor`` with a data dir that holds nothing must exit 1; and the same
     device probe with its builds sent to an empty directory (a first
     doctor on a new machine: three nvcc builds and the gather's g++). The
     seconds of each prepare, doctor run and cold build;
  3. train: cifar10_4k at full width, ZCA fitted on a 4096-image synthetic
     dataset, through the port's create_state, make_optimizers,
     make_device_train_step and make_eval_step, at two settings:
       shipped: float32, batch 100, share_pseudo_forward off;
       bench:   bfloat16 compute over float32 weights, batch 384,
                share_pseudo_forward on;
     each in both arms (use_pallas True: the Hopper kernels; False: plain
     PyTorch and cuDNN), from the same seeded state, 2 eager steps each
     (the second the first on weights an update wrote). The kernels'
     launch counts, keyed by the shape of each call, are cleared just
     before each arm's steps and read just after: the kernel arm must
     launch each conv kernel at exactly the shapes and counts that the
     step's convs imply (``step_launches``), the epilogue's forward kernel
     the count its layers imply and its backward
     kernel the count of those in passes that carry a gradient (43 a step at
     both settings), the plain arm nothing.
     Losses must be finite; the two arms' step-1 metrics must agree;
  3b. graph: the same two settings and both arms through
     make_scan_device_train_step, 4 steps a chunk captured as one CUDA
     graph, cuDNN deterministic (the eager reference too); 64 steps in the
     schedule, 1 an epoch, so that α_P switches on inside the first chunk
     and the lr decays inside the second. Per arm, the main path is the
     capture and two chunks from a seeded state: the wrappers' counts over
     it must be 5 × step_launches key for key (the capture and its warm-up
     step; replays add none), and a kernel arm must launch the batch-norm
     moments' kernels (``check_moments``; the plain arm launches none); the
     two replays run under torch.profiler, whose device records must hold
     each hand-written kernel (the moments' too) 4 × the count
     a step runs in each chunk (the kernels run inside the graph; the plain
     arm's none) and give the launches the replays made; the chunks must
     equal 8 eager steps from the same state bitwise (every parameter, BN
     stat, Adam moment, and every step's metrics: both reductions, "last"
     and "mean"); the graph's nodes, capture-and-instantiate seconds and
     pool bytes are reported;
  3c. configs: mnist100, svhn1k and cifar10_cond at their published
     widths (``configs_phase``), kernel arm, cuDNN deterministic, each on
     its synthetic device data (60000, 8192 and 50000 train images;
     cifar10_cond fully labeled, with phase 3's ZCA statistics; mnist100
     and svhn1k without ZCA). Per configuration and arm (float32 batch 100;
     bfloat16 over float32 weights at batch 384 for mnist100 and
     cifar10_cond, whose convs take bfloat16 shapes no other arm runs): 2
     eager steps (1 at bfloat16), then one chunk of 4 steps captured as a
     CUDA graph and replayed once under torch.profiler; the chunk must
     equal 4 eager steps from the same state bitwise; the wrappers' counts
     must be (eager + 4 + 1) × step_launches key for key, the replay's
     kernels 4 × a step's by name. Then, on the float32 arm's state, an
     eval step, a class grid and the serving functions
     (``export.make_serving_fns``, batch 100; launches counted), card
     against CPU within 1e-4; two steps card against CPU (phase 4's gate;
     svhn1k and cifar10_cond at a few channels, their published widths
     reported beside the CPU's own spread, ungated); and for svhn1k and
     cifar10_cond, ``train_loop.train`` in this process on the shards phase
     2b prepared, one epoch of 4 steps with its eval, grid and checkpoint,
     its launches counted. Side by side, mnist100 through the CLI as the
     README's recipe: ``cli train`` 8 steps on the mnist shards, then
     ``cli eval`` (train's last error), ``cli sample`` (a grayscale PNG of
     10 rows) and ``cli serve`` (/classify of 28 × 28 × 1 images, /generate,
     SIGTERM → 0);
  3e. cifar10_snresnet (the SN-ResNet G and projection D) at its published
     widths, float32, kernel arm, on synthetic device data with phase 3's
     ZCA statistics: one eager step, then a chunk of K steps (warm-up,
     capture, replay) bitwise equal to K eager steps (D's kept u among the
     state's tensors); the per-sample epilogue launched 18 forwards and 6
     backwards a step; the batch-norm moments as in phase 3b; its launches
     feed phase 7;
  3f. cifar10_stylegan2 (the StyleGAN2 G and D, lazy R1) at its published
     widths, float32, kernel arm, batch 64, on synthetic device data with
     its own ZCA fit: two chunks of K steps from step 0, the first opening
     with D's R1 update (two graphs in one pool), bitwise equal to 2·K eager
     steps; the modulation epilogue launched 21 forwards and 7 backwards a
     step; R1's second-order Functions counted, its wide input gradients
     through the Winograd pipeline; R1's gradient of D, kernel arm against
     plain, on the card; then a replay of each graph under torch.profiler,
     each hand-written kernel (the ``cbn_*`` input scales, the ``mod_*``
     epilogues and ``tconv2_kernel`` among them) run as many times as the
     eager steps' counts give, the transposed conv 15 times a plain step and
     21 an R1 step, and no record of cuDNN's ``dgrad2d_alg1_1``; its
     launches feed phase 7 (the modulation epilogue's and the transposed
     conv's rows);
  3d. digits: the real-data recipe of the port's campaign
     (``triplegan_tpu_torch/tools/digits_experiment.py``) for seed 1 and
     100 labels: ``cli prepare --dataset digits`` from the data file the
     package carries; ``cli train`` of the campaign's stage command
     (mnist100 at its published widths on 1,297 real 28 × 28 images, 300
     epochs of 12 steps, α_P from epoch 100, an eval every 100 epochs, a
     checkpoint every 200, ``scan_steps=4``) through ``cli.main`` in this
     process: its launches must be (4 captured + 1 warm-up) ×
     ``step_launches`` plus 3 evals of 500 images and 3 grids, key for key,
     its 900 replays counted by the runner, three of them profiled (each 4
     × a step's kernels by name); every logged loss finite; the test error
     at most 12.0% (40 JAX and TF runs of the recipe: at most 9.2%); then
     the supervised arm: first 4 of its full-batch steps graphed (a
     one-step ``ScanChunk``) against 4 eager steps on seed 1's labelled
     set, bitwise (losses, parameters, BN statistics, Adam moments); then
     ``supervised_baseline`` (3000 full-batch steps of the Classifier, each
     a replay of one captured step) in this process: its launches (a
     warm-up step, the capture, an eval of 500 images) as implied, key for
     key, its replays counted by the runner, three of them profiled (each a
     step's kernels by name); and ``cli eval``, which must print train's
     last error. Both errors, the seconds, the graphed ms/step and the
     final losses are printed (line "digits"); cuDNN is deterministic, so
     the error is repeatable for a given tree;
  4. card against CPU: two steps of a cut-down config (cifar10_4k's layers
     at a few channels, no noise, dropout or augmentation, argmax
     pseudo-labels) on the card with the kernels and on the CPU with their
     plain versions, on the same batches;
  4b. debug: one eager shipped step on a host batch unchecked and under
     ``utils/debug.py::checkify_step`` (the same metrics); the
     D stream's z poisoned with NaN must raise naming an aten operator, and
     an Inf that first appears in a gradient (on autograd's device thread)
     must raise naming the backward's node and its forward line; one
     ``utils/profiling.py::trace`` window around one step, whose Chrome
     trace must hold each wrapper's hand-written kernels by name;
  5. driver: the train driver (train/loop.py) at cifar10_4k's full width,
     float32, batch 100, kernel arm, on the cifar10 shards and ZCA stats
     that phase 2b's ``cli prepare`` made, 4 steps an epoch with an eval, a
     sample grid and a checkpoint each epoch: through ``python -m triplegan_tpu_torch.cli``,
     an 8-step run, alone (metrics logged at steps 2, 4, 6, 8, test errors
     at 4 and 8, grids at 4 and 8, checkpoints 4 and 8 kept). Then side by
     side: ``eval``, which must print the 8-step run's final error;
     ``sample`` (an RGB PNG 160 wide, 320 high); a 4-step run resumed for 4
     more, whose step-8 checkpoint must equal the
     8-step run's bitwise; a run stopped by a STOP file (exit 75, a
     checkpoint at a step N ≤ 4), then re-run with ``--set scan_steps=4``
     to step 8 (it resumes from N; a chunk of 4 steps as a CUDA graph, then
     single steps), whose step-8 checkpoint must equal the 8-step run's
     bitwise; and one ``train(cfg, max_steps=10)`` with scan_steps=4 in
     this process (one capture, two replays, two single steps), its
     launches counted from just before to just after: the conv launches
     must be (4 captured + 1 warm-up + 2 single) × ``step_launches`` plus
     its three evals' (10 test batches each) and two sample grids', key for
     key, the epilogue counts their implied numbers, every shape one that
     phase 3 launched (so phase 7 holds it against the plain versions);
     each replay under torch.profiler must run each wrapper's kernel 4 ×
     its launches a step; the plain arm launches nothing. Then, alone: an
     eval of that run's final state, which must give its test error; two
     saves of the state (asynchronous, as the loop makes them) whose leaves
     must be equal; and a graphed run of 12 steps, a log every 4, which
     must log at steps 4, 8 and 12;
  5d. deploy: the 8-step run of phase 5 as a user ships it: ``cli export``
     (float32 and int8 ``.pt2``), ``cli serve`` of the run dir, ``cli
     inception``, ``fid``, ``predict`` and ``eval`` from the checkpoint and
     from the artifact, side by side; the float32 artifacts' call pair on
     the card launching each kernel as C's and G's forwards imply (by the
     wrappers and, under torch.profiler, by kernel name), against
     in-process serving (1e-4), the same artifacts on the CPU (1e-4) and the
     int8 artifact (0.05 of the largest logit); predict's labels from the
     checkpoint and the artifact equal; then one more train step, /reload,
     and the server's SIGTERM exit 0;
  5b. host: the host-streamed path at the shipped setting with ddinit and
     the fused classifier (data_on_device off, ddinit on, fused_clf_forward
     on; kernel arm). In this process: ddinit on the card, its launches
     counted (D's stride-1 and G's phase convs at the init batch), its
     parameters within 1e-4·(1 + |p|) of a CPU ddinit of the same inputs,
     D's weight-norm pre-activations on the init batch zero-mean and of
     unit std per channel within 1e-3; then 6 steps of make_train_step fed
     by device_prefetch over the port's BatchSampler (the native gather in
     use), their launches 6 × step_launches of a step whose classifier runs
     at 3B rows, key for key, the first 4 batches on the card bytewise the
     sampler's host batches, and the plain arm's first step from the same
     state agreeing (phase 3's float32 tolerance). Side by side with it:
     two CLI chains (``cli train --set data_on_device=False --set
     ddinit=True --set fused_clf_forward=True``, 4 steps, then resumed to
     8) whose step-8 checkpoints must be equal bitwise, the resumed run
     printing no second ddinit line; and one subprocess per layer variant
     (``--variant-step``: TRIPLEGAN_DROPOUT_BITS=8, TRIPLEGAN_MAXPOOL=reshape
     and maskbwd, TRIPLEGAN_SMALLCIN=patches, TRIPLEGAN_DECONV=transpose),
     each one eager shipped step per arm: launches as the variant implies
     (patches and transpose move convs off the kernels), finite losses,
     step-1 metrics of the two arms agreeing. Then, alone: device_prefetch's
     host buffers pinned, and the host-to-device copies of one profiled
     host-streamed step (none pageable);
  5c. mesh: data parallelism (``parallel/mesh.py``) on stl10 at its
     published widths (96 × 96, batch 128, float32, kernel arm) on the
     stl10 shards phase 2b's ``cli prepare`` made, 2 ranks on the one card
     joined by gloo (NCCL refuses two ranks on one device; gloo stages
     the all-reduces through the host),
     spawned by ``run_local_ranks`` (``mesh_rank``; each rank's wrappers
     count its own launches and report them, keyed by shape). Gates: one
     ``make_train_step`` step on each rank's rows of the global host batch
     (stochastic layers and augmentation off, argmax pseudo-labels) equals
     one process's step on the global batch from the same seeded state
     (every parameter, batch-norm statistic and Adam moment within 2·N·lr,
     95% within lr/100; metrics within 1e-4·(1 + |m|)); 4 device-data steps
     of the shipped stl10 (noise, dropout, augmentation, sampled labels)
     finite, each rank's launches 4 × step_launches at its batch of 64, key
     for key; ``train()`` in each rank, 4 steps and resumed for 4 more
     (host-streamed batches, an eval, a grid and a checkpoint every 4),
     whose files come from the coordinator alone (one metrics.jsonl with
     each record once, one config.json, grids and checkpoints at 4 and 8),
     whose step-4 checkpoint restores on one process bitwise equal to the
     state the ranks saved and continues there to step 8 within the same
     tolerance of the ranks' resumed run; a STOP file that the coordinator
     writes after its first step stops both ranks at step 2, preempted and
     checkpointed; the two ranks' states bitwise equal throughout. Then, in
     this process, an NCCL group of world 1 on the card: 4 eager
     device-data steps against the same 4 steps as one captured CUDA graph
     with the all-reduces inside, bitwise, its launches (2·4 + 1) ×
     step_launches and its replay's kernels counted by name in the profile
     (and whether NCCL's kernels appear there);
  6. serve: as in slice 1: cifar10_4k at full width from seeded weights
     (written and read back in the JAX package's npz export format), per
     compute dtype and arm, an HTTP server on an ephemeral port driven
     through /healthz, /classify, /generate and /metrics; the kernel arm
     must launch 9 epilogues and 7 convs per classify chunk, 4 and 3 per
     generate chunk; outputs checked against each other and the CPU;
  7. kernels: at every (shape, dtype, activation) at which a kernel arm of
     phases 3, 3c, 3d, 3e and 6 launched a kernel (the per-sample epilogue's too,
     phase 3e's; for the epilogue's backward, also the
     gradients it computed), holds the kernel's wrapper to its plain
     PyTorch version on fresh seeded inputs and times both with CUDA events
     (``time_ms``: the L2 flushed by a read and the device held by a spin
     before each run, so that the timed window holds device work only;
     epilogue rows take the median, p10 and p90 of 60 runs), and times the
     one PyTorch call that computes the same function where there is one
     (F.conv2d for the conv forward, torch.nn.grad.conv2d_input and
     conv2d_weight for dgrad and wgrad; none for either scale_bias_act
     kernel). A float32 conv row times conv3x3.cu's kernel, a bfloat16 row
     conv3x3_sm90.cu's; a float32 conv row is also called 20 more times,
     and each call must equal the first bitwise (the kernels sum in a fixed
     order). The shapes include phase 5b's: the classifier at 3B rows,
     ddinit's, the variants'; and phase 5c's: stl10's 96 × 96 layers at a
     rank's batch of 64 (D at 192 rows, Cin = 3 + 10), at the global batch
     of 128, in its evals and its grid; and the doctor probe's. A float32
     forward or input gradient that ``f32_wino_plan`` sends through the
     Winograd pipeline is held to the pipeline's plain twin and to the
     plain direct conv (tolerances below) and timed beside the forward
     kernel (``conv3x3_direct``) and its own bound (its row's "path" is
     "winograd"). Before them, line "winograd_share":
     for each of the benchmark's two cells' configurations (the shipped
     graph arm, phase 3e), the share of a step's float32 forward and
     input-gradient operations that took the pipeline, held to at least
     ``WINOGRAD_SHARE_MIN``. Then the batch-norm moments' kernels (``moments_case``)
     at each shape and dtype this process launched them at and at the
     ragged shape in each dtype, cold: the forward pair against the float64
     twin within its summation bound, the backward against the closed form,
     each timed against its bytes ÷ 3.35 TB/s and against the plain twin;
     and the moments' counters on each graphed path (line
     "bn_moments_counters": the cifar10_4k graph arms, phase 3c's arms,
     phase 3e). Last, the stride-2 transposed conv (``tconv_case``, lines
     "tconv3x3_s2") at each shape phase 3f launched it at: against its
     plain twin in float64, 20 repeats bitwise, timed beside its
     operations bound, the twin and cuDNN's call under its deterministic
     algorithms.

The kernels' JSON line sums each kernel's times over one train step at
each setting (``per_step``: launches per step × that shape's time, with
the source that serves the setting's dtype; "mesh_rank" is one rank's
stl10 step at mesh (2,); "mnist100 float32" and the like are phase 3c's
arms); its top-level numbers are the shipped
setting's. Its launches are the wrappers' counts over every
main path (``launches_counted``; the doctor probes' counted in their
subprocesses and reported in their findings) plus the launches that the
CUDA graph replays of those paths made, counted by kernel name in their profiles
(``launches_replayed``; of phase 3d's 900 train replays and 3000
supervised replays, the three of each that were profiled: a profile that
held every replay would hold millions of kernel records). Every such
profile brackets its calls with 256 launches of a marker kernel on each
side and must keep a marker on each side (``device_kernels``): in some
states of this long process a window has lost its first records. Line
"profile_markers" gives the windows that lost markers, and how many.

The last three lines of standard output are the kernels' JSON summary,
nvidia-smi's line again, and ``{"ok": true, "device": {...}}``.

Tolerances.
- scale_bias_act against plain, float32: |kernel − plain| ≤ 1e-6·(1 +
  |plain|); bfloat16: one bfloat16 ulp. Its backward: dx the same; dk
  and db against the exact (float64) sums of the plain backward's terms
  (t·x, t), within γ_n·Σ|terms|, γ_n = n·2⁻²⁴/(1 − n·2⁻²⁴) with n the
  most float32 additions a term goes through in the kernel (its thread's
  rows, its block's tree, the reduce; 99 and 173 at the widest training
  shapes on an H100), plus one bfloat16 ulp of the value at bfloat16 (the float32
  sum rounded once); ``bwd_sums_excess``.
- conv3x3 against plain: |kernel − plain| ≤ 8·sqrt(K)·2⁻²⁴·(the plain op
  on |inputs|), K the length of each sum (both sum in float32, in other
  orders), plus one bfloat16 ulp of the value where the output is
  bfloat16 (both round a float32 sum once).
- the Winograd pipeline (u = 2⁻²⁴, M = ``winograd_magnitude``: the
  computation on magnitudes, which bounds the terms any rounding acts on;
  n = Cin + 32 additions in an output's chain): against the plain direct
  conv (n + 9·Cin)·u·M, against its plain twin ``winograd_nopad`` 2·n·u·M
  (each within γ_n·M of the exact value).
- checkify: the checked step's metrics within 1e-3·(1 + |m|) of the
  unchecked step's (the train arms' float32 tolerance).
- train arms, step-1 metrics: float32 within 1e-3·(1 + |m|); bfloat16
  within 2 bfloat16 ulps of max(|a|, |b|, 1): the metrics are bfloat16
  scalars and the arms round their bf16 convs differently, so a metric may
  round one ulp apart; the floor at 1 covers c_adv, a mean of terms of
  size ≈0.7 whose own value is ≈4e-4 (on an H100 every metric but c_adv
  agreed bitwise and c_adv within 6.1e-5).
- card against CPU, train: metrics within 1e-4·(1 + |m|); parameters
  within 2·N·lr after N steps (Adam turns a near-zero gradient into a ±lr
  step whose sign the last bits decide), and 95% of them within lr/100.
- serve, kernel arm against plain arm: float32 logits within 1e-4·(1 +
  max|logit|) and images within 1e-4; bfloat16 logits within 16 bfloat16
  ulps of the largest logit. Card against CPU, serve, float32: within
  1e-3·(1 + max|ref|).
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import io
import json
import math
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12     # H100 SXM bfloat16 tensor cores, dense
REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BATCH = 100
N_REQ = 250                   # images per request: chunks 100, 100, 50 (+50 pad)
RAGGED_SHAPE = (7, 13, 11, 37)  # an epilogue off every path: odd C, scalar loads
SBA_REPS = 60                 # cold repetitions of each epilogue row
CONV_REPEATS = 20             # float32 conv calls held bitwise to the first
SPIN_CYCLES = 1_000_000       # ≈0.5 ms of device spin before each timed call
TOTAL_STEPS = 10_000
# phase 3's eager steps an arm: the second is the first whose losses are
# computed from weights an update wrote
TRAIN_STEPS = 2
# (name, compute dtype, batch, share_pseudo_forward)
SETTINGS = [("shipped", "float32", 100, False), ("bench", "bfloat16", 384, True)]


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def save_failing(name: str, **tensors) -> str:
    """Writes a failing call's tensors to an npz under the temporary
    directory (``TMPDIR``); returns its path."""
    import numpy as np

    path = os.path.join(tempfile.gettempdir(), f"{name}-{os.getpid()}-{time.time_ns()}.npz")
    np.savez(path, **{k: t.detach().float().cpu().numpy() for k, t in tensors.items()})
    return path


def emit(key: str, obj):
    print(json.dumps({key: obj}), flush=True)


def public(arm: dict) -> dict:
    """An arm's results without its live objects (keys starting with _)."""
    return {k: v for k, v in arm.items() if not k.startswith("_")}


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def bf16_ulp(v):
    import torch

    mag = torch.clamp_min(v.abs().double(), 2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def max_excess(got, want, dtype) -> tuple:
    """(max |got − want|, max of (|got − want| − tolerance)): ≤ 0 passes."""
    import torch

    err = (got.double() - want.double()).abs()
    if dtype == torch.float32:
        lim = 1e-6 * (1.0 + want.double().abs())
    else:
        lim = bf16_ulp(torch.maximum(got.abs(), want.abs()))
    return float(err.max()), float((err - lim).max())


def time_ms(fn, flush, reps=30, warm=5) -> dict:
    """Device time of one call with L2 flushed before it (cold): median,
    10th and 90th percentile of ``reps`` calls between CUDA events; and the
    mean of a back-to-back loop of ``reps`` calls (warm L2; for small
    kernels, the host's enqueue rate). The flush reads 256 MB (a sum), so
    the L2 holds clean lines and no write-back of other data falls in the
    timed window (a ``zero_`` flush left ≈50 MB dirty, and its write-back
    added ≈6 µs to a wide epilogue on an H100: tools/sba_breakdown.py).
    After each flush the device spins for about half a millisecond before
    the start event, so the host has enqueued the whole call (the wrapper's
    Python included) by the time the window opens: the window holds device
    work only, and the launch and event latency (≈3 µs a call on an H100)."""
    import torch

    for _ in range(warm):
        fn()
    pairs = []
    for _ in range(reps):
        flush.sum()
        torch.cuda._sleep(SPIN_CYCLES)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    cold = [a.elapsed_time(b) for a, b in pairs]
    deciles = statistics.quantiles(cold, n=10) if reps >= 2 else cold * 9
    return {"cold": statistics.median(cold), "p10": deciles[0], "p90": deciles[-1],
            "warm": s.elapsed_time(e) / reps}


# Every launch of the batch-norm moments' kernels this process has made,
# keyed (shape, dtype): ``fold_moments`` adds the counters in before
# ``counts_zero`` clears them, so that phase 7 checks the kernels at each
# shape and dtype any path of this process ran them at.
MOMENTS_SEEN = {"bn_moments": collections.Counter(), "bn_moments_bwd": collections.Counter()}


def fold_moments():
    """Add the moments' counters to ``MOMENTS_SEEN`` and clear them."""
    from triplegan_tpu_torch.ops import scale_bias_act as sba

    for name, counter in (("bn_moments", sba.moments_launches), ("bn_moments_bwd", sba.moments_bwd_launches)):
        MOMENTS_SEEN[name].update(counter)
        counter.clear()


def counts_zero():
    from triplegan_tpu_torch.ops import conv3x3 as cv
    from triplegan_tpu_torch.ops import scale_bias_act as sba

    fold_moments()
    for counter in (sba.launches, sba.bwd_launches, sba.cond_launches, sba.cond_bwd_launches, sba.noise_launches,
                    sba.noise_bwd_launches, cv.fwd_launches, cv.wino_launches, cv.wgrad_launches, cv.tconv_launches):
        counter.clear()


def takes_winograd(key) -> bool:
    """Whether a conv launch key (role, n, h, w, cin, cout, halo, dtype)
    runs the float32 Winograd pipeline (``f32_wino_plan``) rather than the
    forward kernel."""
    from triplegan_tpu_torch.ops import conv3x3 as cv

    role, n, h, w, cin, cout, pad, dtype = key
    return (role != "wgrad" and dtype == "float32"
            and cv.f32_wino_plan(n, h + 2 * pad - 2, w + 2 * pad - 2, cin, cout) is not None)


def counts_read() -> dict:
    """Each kernel's launches since counts_zero, keyed by the call's shape;
    "conv3x3_fwd" counts the forward wrapper's calls, the forward kernel's
    (``fwd_launches``) and the Winograd pipeline's (``wino_launches``),
    each of which must hold only the shapes ``f32_wino_plan`` sends it."""
    from triplegan_tpu_torch.ops import conv3x3 as cv
    from triplegan_tpu_torch.ops import scale_bias_act as sba

    astray = [key for key in cv.fwd_launches if takes_winograd(key)] + [
        key for key in cv.wino_launches if not takes_winograd(key)]
    check(not astray, f"conv launches on the path f32_wino_plan does not give their shape: {astray}")
    return {"scale_bias_act": sba.launches.copy(), "scale_bias_act_bwd": sba.bwd_launches.copy(),
            "conv3x3_fwd": cv.fwd_launches + cv.wino_launches, "conv3x3_wgrad": cv.wgrad_launches.copy()}


def totals(counts: dict) -> dict:
    return {name: c.total() for name, c in counts.items()}


def moments_read() -> dict:
    """The batch-norm moments' counters since counts_zero: the kernels'
    forward pairs and backwards, keyed by (shape, dtype)."""
    from triplegan_tpu_torch.ops import scale_bias_act as sba

    return {"bn_moments": sba.moments_launches.copy(), "bn_moments_bwd": sba.moments_bwd_launches.copy()}


def check_moments(moments: dict, use_pallas: bool, what: str) -> dict:
    """A main path's moments counters: a kernel arm launches the forward
    pair and the backward; a plain arm launches neither. Returns the
    totals."""
    tot = totals(moments)
    if use_pallas:
        check(tot["bn_moments"] > 0 and tot["bn_moments_bwd"] > 0, f"{what}: batch-norm moments {tot}")
    else:
        check(tot["bn_moments"] == tot["bn_moments_bwd"] == 0, f"{what}: the plain arm launched the moments {tot}")
    return tot


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------


def build_phase() -> dict:
    """All sources compiled at once, one nvcc each; seconds per build."""
    from triplegan_tpu_torch.ops import build
    from triplegan_tpu_torch.ops import conv3x3 as cv
    from triplegan_tpu_torch.ops import scale_bias_act as sba

    def timed(name):
        t0 = time.perf_counter()
        build.build(name)
        return time.perf_counter() - t0

    names = ("scale_bias_act", "conv3x3", "conv3x3_sm90")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as ex:
        futs = {name: ex.submit(timed, name) for name in names}
        secs = {name: f.result() for name, f in futs.items()}
    sba._lib()
    cv._lib()
    cv._lib_sm90()
    secs["wall"] = time.perf_counter() - t0
    return secs


# ---------------------------------------------------------------------------
# phase 2b: prepare the datasets and run the doctor, through the CLI
# ---------------------------------------------------------------------------


def probe_counts(runs: int) -> dict:
    """The launches of ``runs`` runs of the doctor's device probe, keyed as
    the wrappers key them: one of each kernel at each ``doctor.PROBE``
    entry a run."""
    from triplegan_tpu_torch import doctor

    counts = {name: collections.Counter() for name in WRAPPER_GROUP}
    for kernel, dtype, shape in doctor.PROBE:
        if kernel == "scale_bias_act":
            counts["scale_bias_act"][tuple(shape), dtype, doctor.PROBE_ACT, doctor.PROBE_SLOPE] += runs
            counts["scale_bias_act_bwd"][tuple(shape), dtype, doctor.PROBE_ACT, doctor.PROBE_SLOPE, "xkb"] += runs
        else:
            n, h, w, cin, cout = shape
            counts["conv3x3_fwd"]["fwd", n, h, w, cin, cout, 1, dtype] += runs
            counts["conv3x3_wgrad"]["wgrad", n, h, w, cin, cout, 1, dtype] += runs
    return counts


def probe_lines_ok(device_line: str, kind: str) -> None:
    """A device finding of the doctor must name the card and each
    ``doctor.PROBE`` entry, its kernel from its source, launched once
    (forward and backward, or forward and wgrad)."""
    from triplegan_tpu_torch import doctor

    check(kind in device_line, f"the doctor's device finding does not name {kind}: {device_line}")
    for kernel, dtype, _ in doctor.PROBE:
        if kernel == "scale_bias_act":
            want = f"scale_bias_act {dtype} (scale_bias_act.cu, launches scale_bias_act 1, scale_bias_act_bwd 1;"
        else:
            want = f"conv3x3 {dtype} ({doctor.CONV_SOURCE[dtype]}, launches conv3x3_fwd 1, conv3x3_wgrad 1;"
        check(want in device_line, f"the doctor's device finding lacks {want!r}:\n{device_line}")


def cold_probe(build_dir: str) -> dict:
    """``doctor.check_device`` in this process with every build sent to
    the empty ``build_dir`` (``enable_build_cache``): what a first ``cli
    doctor`` on a new machine pays, the three nvcc builds and the gather's
    g++ build included; its seconds and each build's."""
    import re

    from triplegan_tpu_torch import doctor
    from triplegan_tpu_torch.ops import build
    from triplegan_tpu_torch.utils.cache import enable_build_cache

    prev = build.BUILD_DIR
    enable_build_cache(build_dir)
    try:
        t0 = time.perf_counter()
        findings, visible, memory = doctor.check_device()
        secs = time.perf_counter() - t0
    finally:
        build.BUILD_DIR = prev
    check(findings[0][0] == "ok", f"the cold device probe: {findings}")
    builds = {src: float(t) for src, t in re.findall(r"([\w.]+\.(?:cu|cpp)) ([\d.]+) s", findings[0][2])}
    check(len(builds) == 4 and len(os.listdir(build_dir)) == 4, f"the cold probe's builds: {builds}")
    return {"seconds": secs, "build_seconds": builds, "visible": visible, "memory_bytes": memory,
            "finding": findings[0][2]}


def doctor_phase(data_root: str, kind: str) -> dict:
    """The datasets of phases 3c, 5 and 5c written as raw distribution
    files (``write_raw``: CIFAR-10 pickle batches, MNIST idx files and SVHN
    .mat files of 4096 train and 1000 test images each; STL-10 binaries of
    ``MESH_TRAIN`` and ``MESH_TEST``), then, side by side: ``cli prepare``
    of each (cifar10 with its ZCA statistics, which the driver then loads),
    followed for cifar10 by ``cli doctor --config cifar10_4k`` on those
    shards, which must exit 0 with a device finding that names the card
    and holds each kernel of ``doctor.PROBE`` to its plain twin after one
    launch; and ``cli doctor --skip-device`` with a data dir that holds
    nothing, which must exit 1 on the data check; and ``cold_probe``, the
    device probe with its builds sent to an empty directory. Seconds of
    each."""
    t0 = time.perf_counter()
    sizes = {"cifar10": (DRIVER_TRAIN, DRIVER_TEST), "mnist": (DRIVER_TRAIN, DRIVER_TEST),
             "svhn": (DRIVER_TRAIN, DRIVER_TEST), "stl10": (MESH_TRAIN, MESH_TEST)}
    raw = {name: os.path.join(data_root, f"raw_{name}") for name in sizes}
    for name, (n_train, n_test) in sizes.items():
        write_raw(raw[name], name, n_train, n_test)
    raw_s = time.perf_counter() - t0
    data_dir, stl_dir = os.path.join(data_root, "data"), os.path.join(data_root, "stl10_data")
    runs = os.path.join(data_root, "doctor_runs")

    def prepare(name, out):
        secs, stdout = cli("prepare", "--dataset", name, "--raw-dir", raw[name], "--data-dir", out)
        check(stdout.strip().splitlines()[-1] == f"prepared {name} → {out}/{name}",
              f"cli prepare {name} printed {stdout[-500:]!r}")
        return secs

    def cifar_then_doctor():
        prep_s = prepare("cifar10", data_dir)
        doc_s, out = cli("doctor", "--config", "cifar10_4k", "--workdir", runs, "--data-dir", data_dir)
        return prep_s, doc_s, out

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(6) as ex:
        f_cifar = ex.submit(cifar_then_doctor)
        f_prep = {name: ex.submit(prepare, name, stl_dir if name == "stl10" else data_dir)
                  for name in ("stl10", "mnist", "svhn")}
        f_missing = ex.submit(cli, "doctor", "--config", "cifar10_4k", "--workdir", runs, "--data-dir",
                              os.path.join(data_root, "empty"), "--skip-device", rc=1)
        f_cold = ex.submit(cold_probe, os.path.join(data_root, "cold_build"))
        prep_cifar_s, doctor_s, out = f_cifar.result()
        prep_s = {name: f.result() for name, f in f_prep.items()}
        missing_s, missing_out = f_missing.result()
        cold = f_cold.result()
    side_by_side_s = time.perf_counter() - t0
    check(all(os.path.exists(os.path.join(data_dir, "cifar10", f)) for f in ("train.npz", "test.npz", "zca_stats.npz")),
          f"cli prepare cifar10 wrote {os.listdir(os.path.join(data_dir, 'cifar10'))}")
    check(any(ln.startswith("✗ data") for ln in missing_out.splitlines()), "the doctor on no data failed no data check")
    device = [ln for ln in out.splitlines() if ln.startswith("✓ device")]
    check(len(device) == 1, f"the doctor printed no passing device finding:\n{out}")
    probe_lines_ok(device[0], kind)
    probe_lines_ok(cold["finding"], kind)
    check(not any(ln.startswith("✗") for ln in out.splitlines()), f"the doctor failed a check:\n{out}")
    counts = probe_counts(2)  # cli doctor's probe and the cold one
    res = {"raw_write_seconds": raw_s, "prepare_cifar10_seconds": prep_cifar_s,
           **{f"prepare_{name}_seconds": secs for name, secs in prep_s.items()},
           "doctor_seconds": doctor_s, "doctor_missing_data_seconds": missing_s, "cold_probe": cold,
           "side_by_side_seconds": side_by_side_s, "doctor_findings": out.strip().splitlines(),
           "launches": totals(counts), "_counts": counts, "_data_dir": data_dir, "_stl10_dir": stl_dir}
    emit("doctor", public(res))
    return res


# ---------------------------------------------------------------------------
# phase 3: training at full width
# ---------------------------------------------------------------------------


def train_cfg(dtype: str, batch: int, share: bool, use_pallas: bool):
    from triplegan_tpu_torch.configs import get_config

    cfg = get_config("cifar10_4k")
    cfg.compute_dtype, cfg.batch_size = dtype, batch
    cfg.share_pseudo_forward, cfg.use_pallas = share, use_pallas
    return cfg


def conv_layers(cfg, env=os.environ):
    """The 3×3 stride-1 convs the kernels take in each network, as (h,
    cin, cout, halo) lists: (Generator's phase convs, Discriminator's,
    Classifier's). The layer variants of ``env`` move some off the kernels:
    ``TRIPLEGAN_SMALLCIN=patches`` the Classifier's convs with 9·Cin ≤ 128
    (a matmul; the Discriminator's weight-norm convs bypass it in the kernel
    arm, as in JAX), ``TRIPLEGAN_DECONV=transpose`` every Generator conv
    (``conv_transpose`` on cuDNN)."""
    s, nc = cfg.image_size, cfg.num_classes
    patches = env.get("TRIPLEGAN_SMALLCIN", "conv") == "patches"
    clf, h, cin = [], s, cfg.channels
    for block in cfg.clf.conv_blocks:
        for w in block:
            if not (patches and 9 * cin <= 128):
                clf.append((h, cin, w, 1))
            cin = w
        h = -(-h // 2)
    if not (patches and 9 * cin <= 128):
        clf.append((h, cin, cfg.clf.tail[0], 0))
    disc, h, cin = [], s, cfg.channels + nc
    widths, strides = cfg.disc.widths, cfg.disc.strides
    for i, (w, st) in enumerate(zip(widths, strides)):
        if st == 1:
            disc.append((h, cin, w, 1))
        cin = w
        if st == 2:
            h = -(-h // 2)
            if cfg.disc.label_reconcat and i + 1 < len(widths):
                cin += nc
    gw = cfg.gen.widths
    gen, h = [], s // 2 ** len(gw)
    for i in range(len(gw) - 1):
        gen.append((h, gw[i], 4 * gw[i + 1], 1))
        h *= 2
    gen.append((h, gw[-1], 4 * cfg.channels, 1))
    if env.get("TRIPLEGAN_DECONV", "subpixel") == "transpose":
        gen = []
    return gen, disc, clf


def fwd_launches(cfg, n, layers) -> collections.Counter:
    """The forward conv launches of one pass over ``layers`` at batch n."""
    return collections.Counter(("fwd", n, h, h, ci, co, p, cfg.compute_dtype) for h, ci, co, p in layers)


def step_launches(cfg, env=os.environ):
    """Every kernel launch of one train step of ``cfg`` with use_pallas,
    under the layer variants of ``env`` (``conv_layers``):
    (Counter of conv launches keyed as the conv wrappers key theirs, (role,
    n, h, w, cin, cout, halo, dtype), {key: the players it runs in},
    epilogue forward launches, epilogue backward launches). Role "fwd" is
    a forward conv, "dgrad" the forward kernel on a cotangent (input (n, h,
    w, cin) the cotangent), "wgrad" the filter gradient of a conv whose
    input is (n, h, w, cin)."""
    b, dt = cfg.batch_size, cfg.compute_dtype
    gen, disc, clf = conv_layers(cfg, env)
    widths, gw = cfg.disc.widths, cfg.gen.widths
    convs, players = collections.Counter(), collections.defaultdict(set)

    def add(where, *key):
        convs[key] += 1
        players[key].add(where)

    def fwd(where, n, layers):
        for h_, ci, co, p in layers:
            add(where, "fwd", n, h_, h_, ci, co, p, dt)

    def bwd(where, n, layers, dw, dx_first):
        for i, (h_, ci, co, p) in enumerate(layers):
            ho = h_ + 2 * p - 2
            if dw:
                add(where, "wgrad", n, h_, h_, ci, co, p, dt)
            if i > 0 or dx_first:
                add(where, "dgrad", n, ho, ho, co, ci, 2 - p, dt)

    share = bool(cfg.share_pseudo_forward)
    fused = bool(cfg.get("fused_clf_forward", False))
    # C's passes in the C update: forwards (2 new under share, one 3B-row
    # pass when fused) and passes that carry a gradient
    c_fwd, c_bwd = (1, 1) if fused else (2 if share else 3, 3)
    # D update: G and C forwards without grad, D's 3B-row pass and backward
    fwd("gen", b, gen)
    fwd("clf", b, clf)
    fwd("disc", 3 * b, disc)
    bwd("disc", 3 * b, disc, dw=True, dx_first=False)
    # G update: G with grad, scored by D (gradient to D's input only)
    fwd("gen", b, gen)
    fwd("disc", b, disc)
    bwd("disc", b, disc, dw=False, dx_first=True)
    bwd("gen", b, gen, dw=True, dx_first=True)
    # C update: G forward, 3 C passes (2 new under share; one of 3B rows
    # when fused), D on the pseudo-pairs
    fwd("gen", b, gen)
    cb = 3 * b if fused else b
    for _ in range(c_fwd):
        fwd("clf", cb, clf)
    # the first kernel conv of C takes a cotangent's dgrad when the conv
    # before it left the kernels (a patched first conv)
    clf_dx_first = env.get("TRIPLEGAN_SMALLCIN", "conv") == "patches" and 9 * cfg.channels <= 128
    for _ in range(c_bwd):
        bwd("clf", cb, clf, dw=True, dx_first=clf_dx_first)
    fwd("disc", b, disc)
    n_g = len(gw) + 1
    n_c = sum(len(bl) for bl in cfg.clf.conv_blocks) + len(cfg.clf.tail)
    n_d = len(widths)
    epilogues = (n_g + n_c + n_d) + (n_g + n_d) + (n_g + c_fwd * n_c + n_d)
    # Backward through an epilogue wherever its pass carries a gradient: D's
    # 3B-row pass in the D update; G and D in the G update; C's passes in
    # the C update (three, under share one of them the D update's kept
    # unlabeled pass; one when fused). The forwards without grad (G and C
    # in the D update, G and D in the C update) have none.
    epilogue_bwds = n_d + (n_g + n_d) + c_bwd * n_c
    return convs, players, epilogues, epilogue_bwds


def check_step_launches(cfg, counts, n: int, what: str, n_evals: int = 0, n_grids: int = 0,
                        n_test: int = None) -> dict:
    """The wrappers' counts (``counts_read``) over ``n`` train steps of
    ``cfg`` with use_pallas against ``step_launches``, plus, for a
    ``train_loop.train`` run, ``n_evals`` evals of the ``n_test`` test
    images (default ``DRIVER_TEST``) through the Classifier and ``n_grids``
    class grids (10 a class) through the Generator: the conv launches key
    for key, and the epilogue's forwards and backwards. Returns the
    counts' totals."""
    convs, _, epilogues, epilogue_bwds = step_launches(cfg)
    gen, _, clf = conv_layers(cfg)
    n_batches = n_evals * -(-(DRIVER_TEST if n_test is None else n_test) // cfg.batch_size)
    want = collections.Counter({key: c * n for key, c in convs.items()})
    for _ in range(n_batches):
        want.update(fwd_launches(cfg, cfg.batch_size, clf))
    for _ in range(n_grids):
        want.update(fwd_launches(cfg, cfg.num_classes * 10, gen))
    got = counts["conv3x3_fwd"] + counts["conv3x3_wgrad"]
    check(got == want, f"{what}: conv launches not implied by {n} steps, {n_evals} evals and {n_grids} grids "
                       f"{dict(got - want)}; implied and not launched {dict(want - got)}")
    launches = totals(counts)
    n_c = sum(len(b) for b in cfg.clf.conv_blocks) + len(cfg.clf.tail)
    want_fwd = epilogues * n + n_batches * n_c + n_grids * (len(cfg.gen.widths) + 1)
    check(launches["scale_bias_act"] == want_fwd and launches["scale_bias_act_bwd"] == epilogue_bwds * n,
          f"{what}: epilogue launches {launches}, want {want_fwd} forwards, {epilogue_bwds * n} backwards")
    return launches


def profile_calls(fn, reps: int, top: int, groups=None) -> dict:
    """torch.profiler over ``reps`` calls of ``fn``: wall and device time
    per call, the device's busy share of the wall time, the kernels
    launched per call, the ``top`` kernels by device time (per call), and
    for each of ``groups`` ({group: name fragments}) the device time and
    launches per call of the kernels whose names hold one of its
    fragments."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    sums = {}
    for group, frags in (groups or {}).items():
        hit = [e for e in kernels if any(f in e.key for f in frags)]
        sums[group] = {"us": sum(e.self_device_time_total for e in hit) / reps,
                       "launches": sum(e.count for e in hit) / reps}
    return {"wall_us": wall_us / reps, "device_us": busy_us / reps, "device_busy_share": busy_us / wall_us,
            "kernels": sum(e.count for e in kernels) / reps, "groups": sums,
            "top_device": [{"name": e.key[:80], "us": e.self_device_time_total / reps, "calls": e.count / reps}
                           for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]]}


def train_arm(setting, use_pallas, data, zca) -> dict:
    import torch

    from triplegan_tpu_torch.configs import make_networks
    from triplegan_tpu_torch.train.schedule import make_optimizers
    from triplegan_tpu_torch.train.state import create_state
    from triplegan_tpu_torch.train.step import (METRICS, make_device_train_step, make_eval_step,
                                                upload_device_data)

    name, dtype, batch, share = setting
    cfg = train_cfg(dtype, batch, share, use_pallas)
    nets = make_networks(cfg)
    opts = make_optimizers(cfg, TOTAL_STEPS)
    state = create_state(cfg, nets, opts, device="cuda")
    dev_data = upload_device_data(data, "cuda")
    step = make_device_train_step(cfg, nets, opts, TOTAL_STEPS, zca_stats=zca)
    torch.cuda.synchronize()

    counts_zero()  # the main path starts here
    metrics = []
    for _ in range(TRAIN_STEPS):
        state, m = step(state, dev_data)
        metrics.append({k: float(v) for k, v in m.items()})  # waits for the step
    counts = counts_read()  # the main path ends here
    launches = totals(counts)

    ev = make_eval_step(cfg, nets, zca)
    n_test = len(data.y_test)
    out = ev(state, {"x": torch.as_tensor(data.x_test, device="cuda"),
                     "y": torch.as_tensor(data.y_test, device="cuda"),
                     "mask": torch.ones(n_test, device="cuda")})
    arm = {"setting": name, "dtype": dtype, "batch": batch, "share_pseudo_forward": share,
           "use_pallas": use_pallas, "steps": TRAIN_STEPS, "launches": launches,
           "launches_per_step": {k: v / TRAIN_STEPS for k, v in launches.items()},
           "eval_correct": int(out["correct"]), "eval_count": int(out["count"]),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "metrics": metrics,
           "_counts": counts}
    for t, m in enumerate(metrics):
        check(sorted(m) == sorted(METRICS), f"metrics {sorted(m)}")
        check(all(math.isfinite(v) for v in m.values()), f"{name} arm {use_pallas}: step {t} {m}")
    if use_pallas:
        check_step_launches(cfg, counts, TRAIN_STEPS, f"{name} kernel arm")
        arm["_players"] = step_launches(cfg)[1]
    else:
        check(not any(launches.values()), f"{name} plain arm launched kernels: {launches}")
    del state, step, dev_data
    torch.cuda.empty_cache()
    return arm


def train_phase():
    import torch

    from triplegan_tpu_torch.data.datasets import synthetic_dataset
    from triplegan_tpu_torch.data.zca import fit_zca

    data = synthetic_dataset(image_size=32, channels=3, num_classes=10, n_train=4096, n_test=256,
                             num_labeled=512)
    zca = fit_zca(data.x_unlabel)
    arms = []
    for setting in SETTINGS:
        pair = {}
        for use_pallas in (True, False):
            torch.cuda.reset_peak_memory_stats()
            pair[use_pallas] = train_arm(setting, use_pallas, data, zca)
            arms.append(pair[use_pallas])
            emit("train", public(pair[use_pallas]))
        a, b = pair[True]["metrics"][0], pair[False]["metrics"][0]
        diffs = {k: abs(a[k] - b[k]) for k in a}
        if setting[1] == "float32":
            lims = {k: 1e-3 * (1 + abs(b[k])) for k in a}
        else:  # two bfloat16 ulps of max(|a|, |b|, 1)
            lims = {k: 2.0 ** (math.floor(math.log2(max(abs(a[k]), abs(b[k]), 1.0))) - 6) for k in a}
        emit("train_arms_agree", {"setting": setting[0], "step": 1, "abs_diff": diffs, "limit": lims})
        for k in a:
            check(diffs[k] <= lims[k], f"{setting[0]}: step-1 {k} differs between arms: {a[k]} vs {b[k]}")
    return arms, data, zca


# ---------------------------------------------------------------------------
# phase 3b: K train steps a dispatch, as a CUDA graph
# ---------------------------------------------------------------------------

GRAPH_K = 4
# 1 step an epoch: α_P switches on at step 2 (inside the first chunk), the
# lr decays from count 7 (inside the second)
GRAPH_TOTAL, GRAPH_WARMUP_EPOCHS, GRAPH_DECAY_FRAC = 64, 2, 6 / 64
# the hand-written kernels as the profiler names them (all in an anonymous
# namespace of their sources; "<" after a template's name, "(" otherwise)
HAND_KERNELS = {"sba_fwd": ("sba_fwd_rows<", "sba_fwd_c3<"), "sba_bwd": ("sba_bwd_rows<", "sba_bwd_c3<"),
                "sba_bwd_reduce": ("sba_bwd_reduce<",), "conv_fwd": ("fwd_kernel<",),
                "conv_wgrad": ("wgrad_kernel<",), "conv_reduce": ("reduce_stream_k(", "reduce_splits("),
                "bnm_fwd": ("bnm_fwd_rows<",), "bnm_reduce": ("bnm_reduce(",), "bnm_bwd": ("bnm_bwd_rows<",),
                "wino_filter": ("wino_filter(",), "wino_input": ("wino_input<",), "wino_gemm": ("wino_gemm<",),
                "wino_output": ("wino_output<",), "cbn_fwd": ("cbn_fwd_rows<",), "cbn_bwd": ("cbn_bwd_rows<",),
                "cbn_bwd_reduce": ("cbn_bwd_reduce<",), "mod_fwd": ("mod_fwd_rows<",),
                "mod_bwd": ("mod_bwd_rows<",), "mod_bwd_reduce": ("mod_bwd_reduce(",),
                "tconv": ("tconv2_kernel<",)}
# Kineto keeps only the device records that lie inside its capture window,
# which is taken on the host's clock; a card timestamp converted to that
# clock can land a little past it (a profile that stopped right after its
# synchronize once lacked a few kernels of the kinds that end a step), so
# each profile of replays leaves this much idle time on both sides of them
PROFILE_MARGIN_S = 0.2
# and, in some states of a long process, a window has lost its first device
# records even so (6 to 13 of them, 0.2 s into the window, in an eager step
# and in a replay alike, while the graph held every kernel node), so each
# window brackets the calls with this many launches of a marker kernel on
# each side: a profile that keeps a marker on both sides kept every record
# between them
PROFILE_MARKERS = 256
PROFILE_MARKER = "spin_kernel"  # torch.cuda._sleep's kernel
PROFILE_WINDOWS = []  # (leading, trailing) markers lost, a window each
# the groups whose launches are each wrapper's own (one a call: a float32
# forward runs the forward kernel or the Winograd pipeline's products)
WRAPPER_GROUP = {"scale_bias_act": ("sba_fwd",), "scale_bias_act_bwd": ("sba_bwd",),
                 "conv3x3_fwd": ("conv_fwd", "wino_gemm"), "conv3x3_wgrad": ("conv_wgrad",)}


def graph_cfg(setting, use_pallas):
    name, dtype, batch, share = setting
    cfg = train_cfg(dtype, batch, share, use_pallas)
    cfg.epochs, cfg.alpha_p_warmup_epochs, cfg.lr_decay_start_frac = GRAPH_TOTAL, GRAPH_WARMUP_EPOCHS, GRAPH_DECAY_FRAC
    return cfg


def device_kernels(fn, reps: int) -> dict:
    """torch.profiler, device activity only, over ``reps`` calls of ``fn``
    (with ``PROFILE_MARGIN_S`` before and after them, and
    ``PROFILE_MARKERS`` marker kernels right before and right after them,
    of which the profile must keep at least one on each side): from its raw
    device records but the markers, the launches and device µs of each
    ``HAND_KERNELS`` group, the launches of NCCL's kernels (names holding
    "nccl"), and the 10 kernels with the most device time (names cut to 80
    characters); and the markers lost."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def markers():
        for _ in range(PROFILE_MARKERS):
            torch.cuda._sleep(100)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        markers()
        for _ in range(reps):
            fn()
        markers()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    events = sorted((e.start_ns(), e.end_ns(), e.name()) for e in prof.profiler.kineto_results.events()
                    if e.device_type() == DeviceType.CUDA)
    marks = [i for i, (_, _, name) in enumerate(events) if PROFILE_MARKER in name]
    inner = [i for i in range(len(events)) if PROFILE_MARKER not in events[i][2]]
    if inner:
        head = sum(i < inner[0] for i in marks)
        tail = sum(i > inner[-1] for i in marks)
        check(head > 0 and tail > 0,
              f"a profile kept {head} markers before its calls' first record and {tail} after their last "
              f"(of {PROFILE_MARKERS} launched on each side): it may have lost some of the calls' records")
    else:
        head, tail = len(marks), 0
        check(len(marks) == 2 * PROFILE_MARKERS, f"a profile with no records of its calls kept {len(marks)} "
                                                 f"of its {2 * PROFILE_MARKERS} markers")
    PROFILE_WINDOWS.append((PROFILE_MARKERS - head, PROFILE_MARKERS - tail))
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for start, end, name in (events[i] for i in inner):
        rec = by_name[name]
        rec[0] += 1
        rec[1] += (end - start) / 1e3
    groups, hand = {}, {}
    for group, frags in HAND_KERNELS.items():
        hit = {name: rec for name, rec in by_name.items()
               if any("(anonymous namespace)::" + f in name for f in frags)}
        groups[group] = {"launches": sum(r[0] for r in hit.values()), "us": sum(r[1] for r in hit.values())}
        hand.update({name[:160]: rec[0] for name, rec in hit.items()})
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {"reps": reps, "markers_lost": 2 * PROFILE_MARKERS - len(marks),
            "groups": groups,
            "nccl": sum(r[0] for name, r in by_name.items() if "nccl" in name.lower()),
            "top_device": [{"name": n[:80], "launches": r[0], "us": r[1]} for n, r in top],
            "_hand": hand, "_all": {name[:160]: rec[0] for name, rec in by_name.items()}}


def replayed_launches(prof: dict) -> dict:
    """Each wrapper's kernel launches that ``device_kernels`` counted."""
    return {name: sum(prof["groups"][g]["launches"] for g in groups) for name, groups in WRAPPER_GROUP.items()}


def moments_replayed(prof: dict) -> dict:
    """The batch-norm moments' forward pairs and backwards that
    ``device_kernels`` counted (by their row kernels)."""
    return {"bn_moments": prof["groups"]["bnm_fwd"]["launches"],
            "bn_moments_bwd": prof["groups"]["bnm_bwd"]["launches"]}


def graph_arm(setting, use_pallas, data, zca) -> dict:
    """One (setting, arm): 2·K eager steps from a seeded state, and two
    chunks of K steps through ``make_scan_device_train_step`` from the same
    state. The main path is the capture (``prepare``: a warm-up step and
    the capture) and the two chunks. The wrappers' counts, zeroed just
    before it, must be (K + 1) × ``step_launches`` key for key after the
    capture and unchanged after the chunks, whose replays run under
    torch.profiler: its device records, counted by kernel name, must hold
    each hand-written kernel K × the count a step runs in each chunk (the
    kernels run inside the graph), and give the launches the replays made.
    The graphed chunks must equal the eager steps bitwise (every
    parameter, BN stat, Adam moment, and every step's metrics, so both
    reductions, "last" and "mean", which run after a replay), with α_P and
    the lr changing inside the chunks."""
    import torch

    from triplegan_tpu_torch.configs import make_networks
    from triplegan_tpu_torch.train import step as S
    from triplegan_tpu_torch.train.schedule import make_optimizers
    from triplegan_tpu_torch.train.state import create_state

    name, dtype, batch, share = setting
    cfg = graph_cfg(setting, use_pallas)
    nets = make_networks(cfg)
    opts = make_optimizers(cfg, GRAPH_TOTAL)
    dev_data = S.upload_device_data(data, "cuda")
    step = S.make_device_train_step(cfg, nets, opts, GRAPH_TOTAL, zca_stats=zca)
    state = create_state(cfg, nets, opts, device="cuda")
    k = GRAPH_K

    eager, ms = S._clone_state(state), []
    for _ in range(2 * k):
        eager, m = step(eager, dev_data)
        ms.append(m)
    alpha = [float(m["alpha_p"]) for m in ms]
    lr = [float(m["lr_frac"]) for m in ms]
    check(alpha[1] == 0.0 < alpha[2] and lr[k + 2] == 1.0 > lr[k + 3],
          f"{name}: α_P {alpha} and lr fraction {lr} do not change inside the chunks")

    runner = S.make_scan_device_train_step(cfg, nets, opts, GRAPH_TOTAL, k, zca_stats=zca,
                                           log=lambda *a, **kw: None)
    chunks, holder = [], {"state": state}

    def one_chunk():
        holder["state"], m = runner(holder["state"], dev_data)
        chunks.append((m, runner.step_metrics))

    counts_zero()  # the main path starts here
    runner.prepare(state, dev_data)
    counts = counts_read()  # the warm-up step and the capture
    prof = device_kernels(one_chunk, reps=2)
    after = counts_read()  # the main path ends here
    moments = moments_read()
    state = holder["state"]
    check(after == counts, f"{name}: a replay counted launches: {totals(after)} vs {totals(counts)}")
    for c, (m, per_step) in enumerate(chunks):
        want = S._stacked(ms[c * k:(c + 1) * k])
        bad = [key for key in S.METRICS if not torch.equal(per_step[key], want[key])]
        for mode in ("last", "mean"):
            got_r, want_r = S._reduce_scan_metrics(per_step, mode), S._reduce_scan_metrics(want, mode)
            bad += [f"{mode} {key}" for key in S.METRICS if not torch.equal(got_r[key], want_r[key])]
        bad += [f"returned {key}" for key in S.METRICS if not torch.equal(m[key], want[key][-1])]
        check(not bad, f"{name} use_pallas={use_pallas}: chunk {c} metrics {bad} differ from the eager steps'")
    got = list(S._state_tensors(state))
    want_tensors = list(S._state_tensors(eager))
    diff = sum(not torch.equal(a, b) for a, b in zip(got, want_tensors))
    check(state.step == eager.step and diff == 0,
          f"{name} use_pallas={use_pallas}: {diff} of {len(got)} state tensors differ from the eager "
          f"steps' after {2 * k} steps")
    check((runner.captures, runner.replays, runner.warmup_steps) == (1, 2, 1),
          f"{name}: {runner.captures} captures, {runner.replays} replays")

    launches = totals(counts)
    n = k + runner.warmup_steps
    per_step = hand_kernels_per_step(counts, n, moments)
    in_chunk = {g: v["launches"] / prof["reps"] for g, v in prof["groups"].items()}
    check(all(in_chunk[g] == k * per_step[g] for g in HAND_KERNELS),
          f"{name} use_pallas={use_pallas}: a replayed chunk ran {in_chunk}, want {k} × {per_step}")
    if use_pallas:
        check_step_launches(cfg, counts, n, f"{name} graph, at capture")
    else:
        check(not any(launches.values()), f"{name} plain graph arm launched kernels: {launches}")
    replayed = dict(replayed_launches(prof), **moments_replayed(prof))
    return {"setting": name, "dtype": dtype, "batch": batch, "use_pallas": use_pallas, "k": k,
            "bitwise_last": True, "bitwise_mean": True, "graph": dict(runner.graph_stats),
            "replays": runner.replays, "launches_counted": launches, "launches_replayed": replayed,
            "launches": {key: launches[key] + replayed[key] for key in launches},
            "replayed_chunks": {"kernels_per_step": per_step, "kernels_in_chunk": in_chunk,
                                "groups": prof["groups"], "top_device": prof["top_device"]},
            "moments": check_moments(moments, use_pallas, f"{name} graph"),
            "_counts": counts, "_moments": moments, "_steps": n}


def hand_kernels_per_step(counts: dict, n_steps: int, moments: dict) -> dict:
    """The hand-written kernels one step runs, by ``HAND_KERNELS`` group,
    from the wrappers' counts and the moments' (``moments_read``) over
    ``n_steps`` steps and the plans: a backward that computes dk or db runs
    ``sba_bwd_reduce`` after it; a float32 forward that ``f32_wino_plan``
    gives a plan runs the four ``wino_*`` kernels, one whose forward plan
    shares tiles out stream-K runs ``fwd_kernel`` and ``reduce_stream_k``;
    a filter gradient split over pixels runs ``reduce_splits``; a moments
    forward runs ``bnm_fwd_rows`` and ``bnm_reduce``, its backward
    ``bnm_bwd_rows``; the per-sample and the modulation epilogues (counts
    "scale_bias_act_cond" and "scale_bias_act_noise", where ``counts`` has
    them, and their "_bwd") run ``cbn_*`` and ``mod_*`` as the per-channel
    one runs ``sba_*``; a stride-2 transposed conv (count "conv3x3_tconv",
    where ``counts`` has it) runs ``tconv2_kernel``."""
    from triplegan_tpu_torch.ops import conv3x3 as cv

    conv_reduce = wino = 0
    for key, c in (counts["conv3x3_fwd"] + counts["conv3x3_wgrad"]).items():
        role, n, h, w, cin, cout, pad, dt = key
        m = n * (h + 2 * pad - 2) * (w + 2 * pad - 2)
        if role == "wgrad":
            splits = (cv.f32_wgrad_plan(m, cin, cout)[2] if dt == "float32" else
                      cv.sm90_wgrad_plan(m, -(-cin // 8) * 8, -(-cout // 8) * 8)[1])
            conv_reduce += c * (splits > 1)
        elif takes_winograd(key):
            wino += c
        elif dt == "float32":
            conv_reduce += c * (cv.f32_fwd_plan(m, cin, cout)[2] > 0)

    def epilogue(fwd_name, group):
        fwd = counts.get(fwd_name, collections.Counter())
        bwd = counts.get(fwd_name + "_bwd", collections.Counter())
        return {group + "_fwd": fwd.total() / n_steps, group + "_bwd": bwd.total() / n_steps,
                group + "_bwd_reduce": sum(c for key, c in bwd.items() if set(key[-1]) & set("kb")) / n_steps}

    return {**epilogue("scale_bias_act", "sba"), **epilogue("scale_bias_act_cond", "cbn"),
            **epilogue("scale_bias_act_noise", "mod"),
            "conv_fwd": (counts["conv3x3_fwd"].total() - wino) / n_steps,
            "conv_wgrad": counts["conv3x3_wgrad"].total() / n_steps, "conv_reduce": conv_reduce / n_steps,
            "bnm_fwd": moments["bn_moments"].total() / n_steps, "bnm_reduce": moments["bn_moments"].total() / n_steps,
            "bnm_bwd": moments["bn_moments_bwd"].total() / n_steps,
            "tconv": counts.get("conv3x3_tconv", collections.Counter()).total() / n_steps,
            **{g: wino / n_steps for g in ("wino_filter", "wino_input", "wino_gemm", "wino_output")}}


def graph_phase(data, zca) -> list:
    """cifar10_4k at full width, both settings and both arms, with cuDNN in
    its deterministic algorithms (as the driver runs; the eager reference
    runs with the same setting): per arm the main path of ``graph_arm``."""
    import torch

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = []
    try:
        for setting in SETTINGS:
            for p in (True, False):
                out.append(graph_arm(setting, p, data, zca))
                emit("graph", public(out[-1]))
                torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = det
    return out


# ---------------------------------------------------------------------------
# phase 3c: the other configurations: mnist100, svhn1k, cifar10_cond
# ---------------------------------------------------------------------------

CONFIGS = ("mnist100", "svhn1k", "cifar10_cond")
# train images of each configuration's synthetic device data: MNIST's and
# CIFAR-10's train sets (cifar10_cond is fully labeled: its sampler draws
# labeled rows from all of them); svhn1k's 1000 labels from 8192
CONFIG_TRAIN = {"mnist100": 60000, "svhn1k": 8192, "cifar10_cond": 50000}
CONFIG_TEST = 1000
# (dtype, batch, eager steps before the chunk): the shipped semantics, and
# bfloat16 over float32 master weights at bench.py's batch for the
# configurations whose convs take shapes no other arm runs in bfloat16
CONFIG_ARMS = {"mnist100": (("float32", BATCH, 2), ("bfloat16", 384, 1)),
               "svhn1k": (("float32", BATCH, 2),),
               "cifar10_cond": (("float32", BATCH, 2), ("bfloat16", 384, 1))}
CONFIG_CPU_BATCH = 8     # the card-against-CPU steps
CONFIG_LOOP_STEPS = 4    # the in-process driver runs (one epoch: an eval, a grid, a checkpoint)
CONFIG_CLI_STEPS = 8     # mnist100 through the CLI (two epochs)
CONFIG_REQ = 4           # images of the mnist100 server's /classify and /generate


def config_cfg(name: str, dtype: str, batch: int):
    """``get_config(name)`` at its published widths, ``dtype`` and
    ``batch``, kernel arm."""
    from triplegan_tpu_torch.configs import get_config

    cfg = get_config(name)
    cfg.compute_dtype, cfg.batch_size, cfg.use_pallas = dtype, batch, True
    return cfg


def config_data(name: str):
    """The configuration's synthetic dataset (``synthetic_dataset`` at its
    image size, channels and labels; ``CONFIG_TRAIN`` train images)."""
    from triplegan_tpu_torch.configs import get_config
    from triplegan_tpu_torch.data.datasets import synthetic_dataset

    cfg = get_config(name)
    return synthetic_dataset(image_size=cfg.image_size, channels=cfg.channels, num_classes=cfg.num_classes,
                             n_train=CONFIG_TRAIN[name], n_test=CONFIG_TEST, num_labeled=cfg.num_labeled)


def config_arm(name: str, dtype: str, batch: int, n_eager: int, data, zca) -> dict:
    """One arm of a configuration on device data, cuDNN deterministic. The
    main path: ``n_eager`` eager steps from a seeded state, then one chunk
    of ``GRAPH_K`` steps through ``make_scan_device_train_step`` (its
    warm-up step, its capture, and one replay under torch.profiler). The
    wrappers' counts, zeroed just before, must be (n_eager + K + 1) ×
    ``step_launches`` key for key, and unchanged by the replay, whose device
    records must hold each hand-written kernel K × the count a step runs;
    the chunk must equal K eager steps from the same state bitwise (every
    state tensor, every step's metrics), which run after it. Leaves the
    state for ``config_serving``."""
    import torch

    from triplegan_tpu_torch.configs import make_networks
    from triplegan_tpu_torch.train import step as S
    from triplegan_tpu_torch.train.schedule import make_optimizers
    from triplegan_tpu_torch.train.state import create_state

    cfg = config_cfg(name, dtype, batch)
    what = f"{name} {dtype} b{batch}"
    nets, opts = make_networks(cfg), make_optimizers(cfg, TOTAL_STEPS)
    dev_data = S.upload_device_data(data, "cuda")
    step = S.make_device_train_step(cfg, nets, opts, TOTAL_STEPS, zca_stats=zca)
    runner = S.make_scan_device_train_step(cfg, nets, opts, TOTAL_STEPS, GRAPH_K, zca_stats=zca,
                                           log=lambda *a, **kw: None)
    state = create_state(cfg, nets, opts, device="cuda")
    k = GRAPH_K
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    counts_zero()  # the main path starts here
    eager = []
    for _ in range(n_eager):
        state, m = step(state, dev_data)
        eager.append(floats(m))
    ref = S._clone_state(state)
    runner.prepare(state, dev_data)
    counts = counts_read()  # the eager steps, the warm-up step and the capture
    moments = moments_read()
    chunk = []
    prof = device_kernels(lambda: chunk.append(runner(state, dev_data)), reps=1)
    check(counts_read() == counts, f"{what}: the replay counted launches")  # the main path ends here
    state = chunk[0][0]
    per_step_m = runner.step_metrics

    ref_ms = []
    for _ in range(k):
        ref, m = step(ref, dev_data)
        ref_ms.append(m)
    want = S._stacked(ref_ms)
    bad = [key for key in S.METRICS if not torch.equal(per_step_m[key], want[key])]
    diff = sum(not torch.equal(a, b) for a, b in zip(S._state_tensors(state), S._state_tensors(ref)))
    check(not bad and diff == 0 and state.step == ref.step == n_eager + k,
          f"{what}: the graphed chunk differs from {k} eager steps: metrics {bad}, {diff} state tensors")
    graphed = [{key: float(v[i]) for key, v in per_step_m.items()} for i in range(k)]
    for t, m in enumerate(eager + graphed):
        check(all(math.isfinite(v) for v in m.values()), f"{what}: step {t + 1} {m}")
    del ref, ref_ms, want

    n = n_eager + k + runner.warmup_steps
    launches = check_step_launches(cfg, counts, n, what)
    per_step = hand_kernels_per_step(counts, n, moments)
    in_chunk = {g: v["launches"] for g, v in prof["groups"].items()}
    check(all(in_chunk[g] == k * per_step[g] for g in HAND_KERNELS),
          f"{what}: the replayed chunk ran {in_chunk}, want {k} × {per_step}")
    replayed = dict(replayed_launches(prof), **moments_replayed(prof))
    return {"config": name, "dtype": dtype, "batch": batch, "eager_steps": n_eager, "k": k,
            "metrics": eager + graphed, "graph": dict(runner.graph_stats), "bitwise": True,
            "launches_counted": launches, "launches_replayed": replayed,
            "launches": {key: launches[key] + replayed[key] for key in launches},
            "launches_per_step": step_totals(cfg),
            "replayed_chunk": {"kernels_per_step": per_step, "groups": prof["groups"],
                               "top_device": prof["top_device"]},
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "_counts": counts, "_moments": moments, "_steps": n, "_players": step_launches(cfg)[1], "_cfg": cfg,
            "_nets": nets, "_state": state}


SNRESNET = "cifar10_snresnet"
SNRESNET_TRAIN = 10000   # its synthetic train images (4,000 of them labeled)
# the per-sample epilogue's launches a step: two class-conditional norms an
# up-block, three up-blocks, three G passes; backwards in G's own update
SNRESNET_COND = (18, 6)


def snresnet_phase(zca) -> dict:
    """cifar10_snresnet at its published widths (the SN-ResNet G and D),
    float32, kernel arm, cuDNN deterministic, on synthetic device data with
    phase 3's ZCA statistics. The main path: one eager step from a seeded
    state, then one chunk of ``GRAPH_K`` steps (its warm-up step, its
    capture, one replay); the chunk must equal ``GRAPH_K`` eager steps from
    the same state bitwise (every state tensor, D's u among them, and every
    step's metrics), and the per-sample epilogue's counts, zeroed just
    before, ``SNRESNET_COND`` a step over the eager, warm-up and captured
    steps. Its counts are a main path's for phase 7."""
    import torch

    from triplegan_tpu_torch.configs import make_networks
    from triplegan_tpu_torch.data.datasets import synthetic_dataset
    from triplegan_tpu_torch.ops import scale_bias_act as sba
    from triplegan_tpu_torch.train import step as S
    from triplegan_tpu_torch.train.schedule import make_optimizers
    from triplegan_tpu_torch.train.state import create_state

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        cfg = config_cfg(SNRESNET, "float32", BATCH)
        data = synthetic_dataset(image_size=cfg.image_size, channels=cfg.channels, num_classes=cfg.num_classes,
                                 n_train=SNRESNET_TRAIN, n_test=CONFIG_TEST, num_labeled=cfg.num_labeled)
        nets, opts = make_networks(cfg), make_optimizers(cfg, TOTAL_STEPS)
        dev_data = S.upload_device_data(data, "cuda")
        step = S.make_device_train_step(cfg, nets, opts, TOTAL_STEPS, zca_stats=zca)
        runner = S.make_scan_device_train_step(cfg, nets, opts, TOTAL_STEPS, GRAPH_K, zca_stats=zca,
                                               log=lambda *a, **kw: None)
        state = create_state(cfg, nets, opts, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        counts_zero()  # the main path starts here
        state, m = step(state, dev_data)
        eager = [floats(m)]
        ref = S._clone_state(state)
        state, _ = runner(state, dev_data)
        counts = dict(counts_read(), scale_bias_act_cond=sba.cond_launches.copy(),
                      scale_bias_act_cond_bwd=sba.cond_bwd_launches.copy())  # the main path ends here
        moments = moments_read()
        per_step_m = runner.step_metrics
        ref_ms = []
        for _ in range(GRAPH_K):
            ref, m = step(ref, dev_data)
            ref_ms.append(m)
        want = S._stacked(ref_ms)
    finally:
        torch.backends.cudnn.deterministic = det
    bad = [key for key in S.METRICS if not torch.equal(per_step_m[key], want[key])]
    diff = sum(not torch.equal(a, b) for a, b in zip(S._state_tensors(state), S._state_tensors(ref)))
    check(not bad and diff == 0, f"{SNRESNET}: the graphed chunk differs from {GRAPH_K} eager steps: "
                                 f"metrics {bad}, {diff} state tensors")
    graphed = [{key: float(v[i]) for key, v in per_step_m.items()} for i in range(GRAPH_K)]
    for t, m in enumerate(eager + graphed):
        check(all(math.isfinite(v) for v in m.values()), f"{SNRESNET}: step {t + 1} {m}")
    n = 1 + GRAPH_K + runner.warmup_steps
    launches = totals(counts)
    want_cond = (SNRESNET_COND[0] * n, SNRESNET_COND[1] * n)
    check((launches["scale_bias_act_cond"], launches["scale_bias_act_cond_bwd"]) == want_cond,
          f"{SNRESNET}: per-sample epilogue launches {launches}, want {want_cond} over {n} steps")
    per_step = {name: {key: c / n for key, c in cnt.items()} for name, cnt in counts.items()}
    return {"config": SNRESNET, "dtype": "float32", "batch": BATCH, "k": GRAPH_K, "metrics": eager + graphed,
            "graph": dict(runner.graph_stats), "bitwise": True, "launches": launches,
            "moments": check_moments(moments, True, SNRESNET),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "_sources": [(f"train {SNRESNET} float32", per_step, {})], "_moments": moments, "_steps": n}


STYLEGAN2 = "cifar10_stylegan2"
STYLEGAN2_TRAIN = 10000   # its synthetic train images (4,000 of them labeled)
STYLEGAN2_BATCH = 64      # the configuration's own (mb 64)
# the modulated convs' epilogue a step: seven modulated convs a G pass, three
# G passes; backwards in G's own update
STYLEGAN2_MOD = (21, 7)
# the stride-2 transposed conv's launches a plain step and a step that opens
# with R1: G's three up-convs in each of its three passes, the input
# gradients of D's three stride-2 convs in D's and G's updates; R1 adds two
# a stride-2 conv (its recorded input gradient, and the penalty's gradient
# through D's forward again)
STYLEGAN2_TCONV = (15, 21)


def stylegan2_counts() -> dict:
    """``counts_read`` with the per-sample and the modulation epilogues'
    counters and the stride-2 transposed conv's."""
    from triplegan_tpu_torch.ops import conv3x3 as cv
    from triplegan_tpu_torch.ops import scale_bias_act as sba

    return dict(counts_read(), conv3x3_tconv=cv.tconv_launches.copy(), scale_bias_act_cond=sba.cond_launches.copy(),
                scale_bias_act_cond_bwd=sba.cond_bwd_launches.copy(),
                scale_bias_act_noise=sba.noise_launches.copy(), scale_bias_act_noise_bwd=sba.noise_bwd_launches.copy())


def stylegan2_phase() -> dict:
    """cifar10_stylegan2 at its published widths (the StyleGAN2 G and D,
    StyleGAN2-ADA's cifar configuration), float32, kernel arm, cuDNN
    deterministic, on synthetic device data, ZCA as configured (its own
    fit). The main path: two chunks of ``GRAPH_K`` steps from step 0, the
    first opening with D's R1 update and the second without (two graphs in
    one pool, three warm-up steps), which must equal 2·``GRAPH_K`` eager
    steps from the same state bitwise (every state tensor, G's w_avg and
    EMA copy among them, and every step's metrics); the modulation
    epilogue's counts ``STYLEGAN2_MOD`` a step over the warm-up and
    captured steps; the eager steps' stride-2 transposed convs
    ``STYLEGAN2_TCONV`` (a plain step, an R1 step); the R1 steps' second-order Functions counted, the
    conv's input gradients through the Winograd pipeline; R1's gradient of
    D on the card, kernel arm against the plain arm, within 1e-3 of its
    norm; then three more chunks, from steps 8, 12 and 16, the first and
    the last each a replay of one of the two graphs under torch.profiler:
    its device records must hold each hand-written kernel as many times as
    the eager steps' counts give (an R1 step's and three plain steps', or
    four plain steps'), and no record of cuDNN's ``dgrad2d_alg1_1``
    (the transposed direction is ``tconv2_kernel``'s). Its counts are a
    main path's for phase 7, which holds each modulation epilogue shape
    and each transposed conv shape against its plain twin."""
    import torch

    from triplegan_tpu_torch.configs import make_networks
    from triplegan_tpu_torch.data.datasets import synthetic_dataset
    from triplegan_tpu_torch.data.zca import fit_zca
    from triplegan_tpu_torch.ops import conv3x3 as cv
    from triplegan_tpu_torch.ops import scale_bias_act as sba
    from triplegan_tpu_torch.train import step as S
    from triplegan_tpu_torch.train.schedule import make_optimizers
    from triplegan_tpu_torch.train.state import create_state

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        cfg = config_cfg(STYLEGAN2, "float32", STYLEGAN2_BATCH)
        data = synthetic_dataset(image_size=cfg.image_size, channels=cfg.channels, num_classes=cfg.num_classes,
                                 n_train=STYLEGAN2_TRAIN, n_test=CONFIG_TEST, num_labeled=cfg.num_labeled)
        zca = fit_zca(data.x_unlabel)
        nets, opts = make_networks(cfg), make_optimizers(cfg, TOTAL_STEPS)
        dev_data = S.upload_device_data(data, "cuda")
        step = S.make_device_train_step(cfg, nets, opts, TOTAL_STEPS, zca_stats=zca)
        runner = S.make_scan_device_train_step(cfg, nets, opts, TOTAL_STEPS, GRAPH_K, zca_stats=zca,
                                               log=lambda *a, **kw: None)
        state = create_state(cfg, nets, opts, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        counts_zero()  # the main path starts here
        for c in (sba.second_order_launches, cv.second_order_launches):
            c.clear()
        ref = S._clone_state(state)
        per_step_m = []
        for _ in range(2):
            state, _ = runner(state, dev_data)
            per_step_m.append(runner.step_metrics)
        counts = stylegan2_counts()
        second = {"conv": cv.second_order_launches.copy(), "epilogue": sba.second_order_launches.copy()}
        wino = cv.wino_launches.copy()  # the main path ends here
        moments = moments_read()
        ref_ms, eager = [], []
        for _ in range(2 * GRAPH_K):
            counts_zero()
            ref, m = step(ref, dev_data)
            ref_ms.append(m)
            eager.append(hand_kernels_per_step(stylegan2_counts(), 1, moments_read()))
        want = S._stacked(ref_ms)
        got = {key: torch.cat([m[key] for m in per_step_m]) for key in S.METRICS}
        bad = [key for key in S.METRICS if not torch.equal(got[key], want[key])]
        diff = sum(not torch.equal(a, b) for a, b in zip(S._state_tensors(state), S._state_tensors(ref)))
        r1 = r1_on_card(cfg, state, dev_data)
        holder = {"state": state}

        def one_chunk():
            holder["state"], _ = runner(holder["state"], dev_data)

        prof = {"plain": device_kernels(one_chunk, reps=1)}  # steps 8 to 11
        one_chunk()  # 12 to 15
        prof["r1"] = device_kernels(one_chunk, reps=1)  # 16 to 19: R1 at 16
    finally:
        torch.backends.cudnn.deterministic = det
    check(not bad and diff == 0, f"{STYLEGAN2}: the graphed chunks differ from {2 * GRAPH_K} eager steps: "
                                 f"metrics {bad}, {diff} state tensors")
    check((runner.captures, runner.replays, runner.warmup_steps) == (2, 5, 3),
          f"{STYLEGAN2}: {runner.captures} captures, {runner.replays} replays and {runner.warmup_steps} warm-ups, "
          f"want 2, 5 and 3")
    check({p: o.count for p, o in state.opt.items()} == {"gen": 8, "disc": 9, "clf": 8},
          f"{STYLEGAN2}: Adam counts {[(p, o.count) for p, o in state.opt.items()]} after one R1 step of 8")
    graphed = [{key: float(v) for key, v in zip(S.METRICS, row)} for row in torch.stack([got[k] for k in S.METRICS], 1)]
    for t, m in enumerate(graphed):
        check(all(math.isfinite(v) for v in m.values()), f"{STYLEGAN2}: step {t} {m}")
    n = 2 * GRAPH_K + runner.warmup_steps  # each captured step counts once, so do the warm-ups
    launches = totals(counts)
    want_mod = (STYLEGAN2_MOD[0] * n, STYLEGAN2_MOD[1] * n)
    check((launches["scale_bias_act_noise"], launches["scale_bias_act_noise_bwd"]) == want_mod,
          f"{STYLEGAN2}: modulation epilogue launches {launches}, want {want_mod} over {n} steps")
    roles = {k[0] for k in second["conv"]}
    check({"dgrad2", "wgrad2"} <= roles and {k[0] for k in second["epilogue"]} == {"channel"},
          f"{STYLEGAN2}: R1's second-order Functions {roles}, {set(second['epilogue'])}")
    wide = [k for k in second["conv"] if k[0] == "dgrad2" and k[4] == 512]
    check(wide and all(("dgrad",) + k[1:] in wino for k in wide),
          f"{STYLEGAN2}: R1's wide input gradients {wide} did not all run through the Winograd pipeline")
    r1_step, plain_step = eager[0], eager[1]
    check(all(e == plain_step for e in eager[1:]), f"{STYLEGAN2}: the plain eager steps ran {eager[1:]}")
    check((plain_step["tconv"], r1_step["tconv"]) == STYLEGAN2_TCONV,
          f"{STYLEGAN2}: the stride-2 transposed conv ran {plain_step['tconv']} times a plain step and "
          f"{r1_step['tconv']} an R1 step, want {STYLEGAN2_TCONV}")
    replayed = collections.Counter()
    chunks = {}
    for name, kernels in (("plain", {g: GRAPH_K * plain_step[g] for g in HAND_KERNELS}),
                          ("r1", {g: r1_step[g] + (GRAPH_K - 1) * plain_step[g] for g in HAND_KERNELS})):
        in_chunk = {g: prof[name]["groups"][g]["launches"] for g in HAND_KERNELS}
        check(in_chunk == kernels, f"{STYLEGAN2}: a replay of the {name} graph ran {in_chunk}, want {kernels}")
        alg1 = {k: c for k, c in prof[name]["_all"].items() if "dgrad2d_alg1_1" in k}
        check(not alg1, f"{STYLEGAN2}: a replay of the {name} graph ran cuDNN's {alg1}")
        replayed.update(replayed_launches(prof[name]))
        replayed.update({"conv3x3_tconv": in_chunk["tconv"],
                         "scale_bias_act_noise": in_chunk["mod_fwd"], "scale_bias_act_noise_bwd": in_chunk["mod_bwd"],
                         "scale_bias_act_cond": in_chunk["cbn_fwd"], "scale_bias_act_cond_bwd": in_chunk["cbn_bwd"]})
        chunks[name] = {"kernels_in_chunk": in_chunk, "groups": prof[name]["groups"],
                        "top_device": prof[name]["top_device"]}
    per_step = {name: {key: c / n for key, c in cnt.items()} for name, cnt in counts.items()}
    return {"config": STYLEGAN2, "dtype": "float32", "batch": STYLEGAN2_BATCH, "k": GRAPH_K, "metrics": graphed,
            "graph": dict(runner.graph_stats), "bitwise": True, "launches": launches,
            "launches_replayed": dict(replayed),
            "kernels_per_step": {"r1": r1_step, "plain": plain_step}, "replayed_chunks": chunks,
            "second_order": {"conv": {str(k): c for k, c in second["conv"].items()},
                             "epilogue": {str(k): c for k, c in second["epilogue"].items()}},
            "r1_on_card": r1, "moments": check_moments(moments, True, STYLEGAN2),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "_sources": [(f"train {STYLEGAN2} float32", per_step, {})], "_steps": n}


def r1_on_card(cfg, state, dev_data) -> dict:
    """R1's gradient of D (the penalty of 64 real images) on the card, in
    the kernel arm and in the plain arm (cuDNN, TF32 off), from the same
    state: their largest leaf gap over the plain gradient's norm."""
    import torch

    from triplegan_tpu_torch.configs import make_networks
    from triplegan_tpu_torch.data import ondevice

    x = ondevice.standard_pipeline(dev_data["x_l"][:STYLEGAN2_BATCH], dtype=torch.float32)
    y = dev_data["y_l"][:STYLEGAN2_BATCH]
    grads = {}
    for pallas in (True, False):
        cfg.use_pallas = pallas
        disc = make_networks(cfg)[1]
        pd = {l: {k: t.detach().clone().requires_grad_(True) for k, t in a.items()}
              for l, a in state.params["disc"].items()}
        xr = x.detach().clone().requires_grad_(True)
        (gx,) = torch.autograd.grad(disc.apply(pd, {}, xr, y, train=True)[0].sum(), xr, create_graph=True)
        pen = torch.square(gx).sum(dim=(1, 2, 3)).mean()
        leaves = [t for a in pd.values() for t in a.values()]
        grads[pallas] = torch.autograd.grad(pen, leaves, allow_unused=True, materialize_grads=True)
    cfg.use_pallas = True
    norm = math.sqrt(sum(float(torch.sum(torch.square(t))) for t in grads[False]))
    gap = max(float((a - b).abs().max()) for a, b in zip(grads[True], grads[False])) / norm
    check(gap <= 1e-3, f"{STYLEGAN2}: R1's gradient of D, kernel arm against plain, {gap} of its norm")
    return {"gap_over_norm": gap, "norm": norm}


def config_serving(arm, data, zca) -> dict:
    """With the float32 arm's trained state, on the card: one eval step on
    the first ``BATCH`` test images, a class grid (10 a class) through the
    Generator, and the serving functions (``export.make_serving_fns``) on
    ``BATCH`` seeded images and z, y, the launches counted from just before
    the eval to just after (C's forward twice, G's twice, at batch
    ``BATCH``); the serving functions against the same functions on the
    CPU within 1e-4."""
    import torch

    from triplegan_tpu_torch.eval.sample import class_grid_inputs, make_sample_fn, to_uint8_grid
    from triplegan_tpu_torch.export import make_serving_fns
    from triplegan_tpu_torch.train.step import make_eval_step

    cfg, nets, state = arm["_cfg"], arm["_nets"], arm["_state"]
    dev = torch.device("cuda")
    classify, generate = make_serving_fns(cfg, nets, state, zca_stats=zca, device=dev)
    ev = make_eval_step(cfg, nets, zca)
    sample = make_sample_fn(cfg, nets)
    gz, gy = class_grid_inputs(cfg, n_per_class=10, seed=SEED)
    images, z, y = served_inputs(cfg, BATCH)
    ti, tz, ty = (torch.from_numpy(a).to(dev) for a in (images, z, y))
    batch = {"x": torch.as_tensor(data.x_test[:BATCH], device=dev),
             "y": torch.as_tensor(data.y_test[:BATCH], device=dev), "mask": torch.ones(BATCH, device=dev)}
    torch.cuda.synchronize()

    counts_zero()  # the main path starts here
    out = ev(state, batch)
    grid = to_uint8_grid(sample(state, gz, gy), cfg.num_classes, 10)
    logits, imgs = classify(ti), generate(tz, ty)
    torch.cuda.synchronize()
    counts = counts_read()  # the main path ends here
    what = f"{cfg.name} serving"
    gen_l, _, clf_l = conv_layers(cfg)
    want = fwd_launches(cfg, BATCH, clf_l) + fwd_launches(cfg, BATCH, gen_l)
    want = want + want
    check(counts["conv3x3_fwd"] == want and not counts["conv3x3_wgrad"],
          f"{what}: conv launches {dict(counts['conv3x3_fwd'])}, want {dict(want)}")
    n_c = sum(len(b) for b in cfg.clf.conv_blocks) + len(cfg.clf.tail)
    n_g = len(cfg.gen.widths) + 1
    launches = totals(counts)
    check(launches["scale_bias_act"] == 2 * (n_c + n_g) and not launches["scale_bias_act_bwd"],
          f"{what}: epilogue launches {launches}, want {2 * (n_c + n_g)} forwards")
    shape = (BATCH, cfg.image_size, cfg.image_size, cfg.channels)
    check(int(out["count"]) == BATCH and 0 <= int(out["correct"]) <= BATCH, f"{what}: eval {out}")
    check(grid.shape == (10 * cfg.image_size, 10 * cfg.image_size, cfg.channels), f"{what}: grid {grid.shape}")
    check(logits.shape == (BATCH, cfg.num_classes) and bool(torch.isfinite(logits).all()), f"{what}: logits")
    check(imgs.shape == shape and float(imgs.abs().max()) <= 1.0, f"{what}: images {tuple(imgs.shape)}")

    cpu_classify, cpu_generate = make_serving_fns(cfg, nets, state, zca_stats=zca, device="cpu")
    t0 = time.perf_counter()
    cpu_logits, cpu_imgs = cpu_classify(torch.from_numpy(images)), cpu_generate(torch.from_numpy(z),
                                                                                torch.from_numpy(y))
    vs_cpu = {"logits_max_abs_diff": max_diff(logits, cpu_logits), "images_max_abs_diff": max_diff(imgs, cpu_imgs),
              "max_abs_logit": float(cpu_logits.abs().max()), "limit": 1e-4,
              "cpu_seconds": time.perf_counter() - t0}
    check(max(vs_cpu["logits_max_abs_diff"], vs_cpu["images_max_abs_diff"]) <= 1e-4,
          f"{what}: the card against the CPU: {vs_cpu}")
    return {"eval_correct": int(out["correct"]), "eval_count": int(out["count"]), "grid_shape": list(grid.shape),
            "launches": launches, "serving_card_vs_cpu": vs_cpu, "_counts": counts}


def config_loop(name: str, data_dir: str, workdir: str) -> dict:
    """``train_loop.train`` of ``name`` at its published widths (float32,
    batch 100, kernel arm) in this process, as ``cli train`` runs it, on the
    shards phase 2b's ``cli prepare`` made (cifar10_cond on cifar10's, with
    its ZCA statistics), ``CONFIG_LOOP_STEPS`` steps: one epoch, its eval,
    grid and checkpoint. Its launches, counted from just before to just
    after, must be the steps' ``step_launches`` plus the eval's (the test
    set through the Classifier) and the grid's (100 images through the
    Generator), key for key."""
    from triplegan_tpu_torch.cli import _apply_overrides
    from triplegan_tpu_torch.configs import get_config
    from triplegan_tpu_torch.train import loop as train_loop

    cfg = _apply_overrides(get_config(name), DRIVER_SETS)
    cfg.workdir, cfg.data_dir = workdir, data_dir
    n = CONFIG_LOOP_STEPS
    counts_zero()  # the main path starts here
    t0 = time.perf_counter()
    res = train_loop.train(cfg, max_steps=n, verbose=False, device="cuda")
    secs = time.perf_counter() - t0
    counts = counts_read()  # the main path ends here
    check(res["steps"] == n and not res["preempted"] and math.isfinite(res["test_error"]),
          f"{name} loop: {res['steps']} steps, test error {res['test_error']}")
    run = os.path.join(workdir, name)
    check(os.path.exists(os.path.join(run, "ckpt", str(n))) and
          os.path.exists(os.path.join(run, f"samples_{n:08d}.png")), f"{name} loop: no checkpoint or grid at {n}")
    launches = check_step_launches(cfg, counts, n, f"{name} loop", n_evals=1, n_grids=1)
    return {"steps": n, "test_error": res["test_error"], "seconds": secs, "launches_counted": launches,
            "launches": launches, "_counts": counts}


def mnist_cli_chain(data_dir: str, workdir: str) -> dict:
    """mnist100 as the README's recipe runs it, through ``python -m
    triplegan_tpu_torch.cli`` on the card, on the shards phase 2b's ``cli
    prepare --dataset mnist`` made: ``train`` for ``CONFIG_CLI_STEPS``
    steps (4 an epoch, an eval, a grid and a checkpoint each), then side by
    side ``eval``, which must print train's last test error; ``sample``, a
    grayscale PNG of 10 rows; and ``serve --config``, which must answer a
    /classify of ``CONFIG_REQ`` 28 × 28 × 1 images with finite logits and a
    /generate with images in [-1, 1], and exit 0 on SIGTERM."""
    run_args = ["--config", "mnist100", "--workdir", workdir, "--data-dir", data_dir]
    sets = [a for kv in DRIVER_SETS for a in ("--set", kv)]
    train_s, out = cli("train", *run_args, *sets, "--max-steps", str(CONFIG_CLI_STEPS))
    done = done_line(out)
    check(done.startswith(f"done: step={CONFIG_CLI_STEPS} "), f"mnist100 cli train: {done}")
    kept = sorted(int(d) for d in os.listdir(os.path.join(workdir, "mnist100", "ckpt")) if d.isdigit())
    check(kept == [4, 8], f"mnist100 cli train kept checkpoints {kept}")
    grid = os.path.join(workdir, "grid.png")
    images = np.random.RandomState(SEED).randint(0, 256, size=(CONFIG_REQ, 28, 28, 1), dtype=np.uint8)
    t0 = time.perf_counter()
    proc, base, serve_start_s = serve_start(run_args)
    try:
        with concurrent.futures.ThreadPoolExecutor(2) as ex:
            f_eval = ex.submit(cli, "eval", *run_args)
            f_sample = ex.submit(cli, "sample", *run_args, "--out", grid, "--n-per-class", "5")
            health = json.loads(http("GET", base + "/healthz")[1])
            check(health["backend"] == "cuda" and health["step"] == CONFIG_CLI_STEPS
                  and health["image_shape"] == [28, 28, 1], f"mnist100 /healthz: {health}")
            logits = load_npy(http("POST", base + "/classify", npy(images), "application/x-npy")[1])
            imgs = load_npy(http("POST", base + "/generate", json.dumps({"n": CONFIG_REQ, "seed": 3}).encode(),
                                 "application/json")[1])
            eval_s, eval_out = f_eval.result()
            sample_s, _ = f_sample.result()
        proc.send_signal(15)
        rest, _ = proc.communicate(timeout=60)
        check(proc.returncode == 0, f"mnist100 cli serve exited {proc.returncode} on SIGTERM:\n{rest[-3000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(logits.shape == (CONFIG_REQ, 10) and bool(np.isfinite(logits).all()), f"mnist100 /classify {logits.shape}")
    check(imgs.shape == (CONFIG_REQ, 28, 28, 1) and float(np.abs(imgs).max()) <= 1.0,
          f"mnist100 /generate {imgs.shape}")
    err_line = eval_out.strip().splitlines()[-1]
    check(err_line == "test error: " + done.split("test_error=")[1], f"mnist100 cli eval printed {err_line!r}, "
                                                                     f"train {done!r}")
    check(png_size(grid) == (5 * 28, 10 * 28, 8, 0), f"mnist100 sample grid IHDR {png_size(grid)}")
    return {"train_seconds": train_s, "final": done, "eval": err_line, "eval_seconds": eval_s,
            "sample_seconds": sample_s, "serve_start_seconds": serve_start_s,
            "side_by_side_seconds": time.perf_counter() - t0, "healthz": health}


def configs_phase(data_dir: str, zca) -> list:
    """mnist100, svhn1k and cifar10_cond at their published widths, kernel
    arm, cuDNN deterministic. Side by side with ``mnist_cli_chain`` (a
    thread running its CLI processes): per configuration, on its synthetic
    device data (``config_data``; cifar10_cond with phase 3's ZCA
    statistics, the others have none), each arm of ``CONFIG_ARMS``
    (``config_arm``), then ``config_serving`` on the float32 arm's state,
    ``card_vs_cpu`` of the configuration (``deterministic``, batch
    ``CONFIG_CPU_BATCH``: mnist100 at its published widths; svhn1k and
    cifar10_cond gated at a few channels, their published widths reported
    ungated) and, for those two, ``config_loop`` on the prepared shards."""
    import shutil

    import torch

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    workdir = tempfile.mkdtemp(prefix="configs_", dir=os.path.dirname(data_dir))
    res, arms = [], []
    ex = concurrent.futures.ThreadPoolExecutor(1)
    try:
        f_cli = ex.submit(mnist_cli_chain, data_dir, os.path.join(workdir, "cli"))
        for name in CONFIGS:
            t0 = time.perf_counter()
            data = config_data(name)
            cz = zca if config_cfg(name, "float32", BATCH).zca else None
            rec = {"config": name, "data_seconds": time.perf_counter() - t0, "train_images": CONFIG_TRAIN[name]}
            mine = [config_arm(name, dtype, batch, n_eager, data, cz) for dtype, batch, n_eager in CONFIG_ARMS[name]]
            for arm in mine:
                emit("config_arm", public(arm))
            rec["serving"] = config_serving(mine[0], data, cz)
            # mnist100 at its published widths; the others' two steps there are
            # ill-conditioned (PERF.md), so they are held at a few channels and
            # their published widths reported beside the CPU's own spread
            cpu_cfg = deterministic(config_cfg(name, "float32", CONFIG_CPU_BATCH))
            if name == "mnist100":
                rec["card_vs_cpu"] = card_vs_cpu(cpu_cfg, data, cz, f"{name} at its widths")
            else:
                rec["card_vs_cpu_published"] = card_vs_cpu(cpu_cfg, data, cz, f"{name} at its widths", gate=False)
                rec["card_vs_cpu"] = card_vs_cpu(few_channels(cpu_cfg), data, cz, f"{name} at a few channels")
                rec["loop"] = config_loop(name, data_dir, os.path.join(workdir, "loop"))
            rec["seconds"] = time.perf_counter() - t0
            arms += mine
            res.append(rec)
            del data
        cli_chain = f_cli.result()
    finally:
        ex.shutdown(wait=True)
        torch.backends.cudnn.deterministic = det
        shutil.rmtree(workdir, ignore_errors=True)
    for rec in res:
        mine = [a for a in arms if a["config"] == rec["config"]]
        rec["arms"] = [public(a) for a in mine]
        rec["_sources"] = [(f"train {a['config']} {a['dtype']}",
                            {name: {key: c / a["_steps"] for key, c in counts.items()}
                             for name, counts in a["_counts"].items()}, a["_players"]) for a in mine]
        rec["_sources"].append((f"serve {rec['config']}", rec["serving"].pop("_counts"), {}))
        rec["_moments"] = {f"{a['config']} {a['dtype']}": (a["dtype"], a["batch"], a["_moments"], a["_steps"])
                           for a in mine}
        if "loop" in rec:
            rec["_sources"].append((f"loop {rec['config']}", rec["loop"].pop("_counts"), {}))
        if rec["config"] == "mnist100":
            rec["cli"] = cli_chain
        emit("config", public(rec))
    del arms
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 3d: digits: one seed of the real-data recipe, both arms
# ---------------------------------------------------------------------------

DIGITS_SEED, DIGITS_LABELS = 1, 100
DIGITS_TEST = 500           # the digits test set: 5 eval batches of 100
DIGITS_ERROR_MAX = 12.0     # percent; 40 JAX and TF runs of the recipe at 100 labels: at most 9.2
DIGITS_BASELINE_STEPS = 3000
DIGITS_PROFILED = (1, 301, 900)  # replays under torch.profiler: the first, α_P's first, the last
DIGITS_B_PROFILED = (1, 1500, 3000)  # the supervised arm's: the first, one midway, the last
DIGITS_B_BITWISE = 4  # supervised steps graphed against eager ones first


def digits_baseline_launches(cfg) -> tuple:
    """The supervised arm's implied launches: (one full-batch step of the
    Classifier at ``cfg.batch_size``: a forward, then every filter gradient
    and every input gradient but the first conv's, as a conv Counter, its
    epilogue forwards and backwards; one eval of ``DIGITS_TEST`` images in
    batches of ``cfg.batch_size``: a conv Counter, its epilogue forwards)."""
    _, _, clf = conv_layers(cfg)
    b, dt = cfg.batch_size, cfg.compute_dtype
    step = fwd_launches(cfg, b, clf)
    for i, (h, ci, co, p) in enumerate(clf):
        step[("wgrad", b, h, h, ci, co, p, dt)] += 1
        if i > 0:
            ho = h + 2 * p - 2
            step[("dgrad", b, ho, ho, co, ci, 2 - p, dt)] += 1
    n_batches = -(-DIGITS_TEST // b)
    evals = collections.Counter({k: c * n_batches for k, c in fwd_launches(cfg, b, clf).items()})
    n_c = sum(len(bl) for bl in cfg.clf.conv_blocks) + len(cfg.clf.tail)
    return step, n_c, n_c, evals, n_c * n_batches


def digits_supervised_bitwise(cfg, k: int) -> dict:
    """``k`` steps of the supervised arm on the labelled set of ``cfg``
    (``baseline_config``'s), graphed (``SupervisedBaseline.step``: a
    one-step ``ScanChunk``, captured at the first step) against ``k`` eager
    steps (``SupervisedBaseline.train_step``) from the same weights and
    per-step noise seeds, in this process and at the arm's shapes: every
    step's loss, and every parameter, BN statistic and Adam moment after
    them, must be equal bitwise. Its launches are no part of the main
    path."""
    import torch

    from triplegan_tpu_torch.data.datasets import load_dataset
    from triplegan_tpu_torch.tools.digits_experiment import SupervisedBaseline
    from triplegan_tpu_torch.train import step as S

    data = load_dataset(cfg.data_dir, cfg.dataset, cfg.num_labeled, cfg.num_classes, cfg.seed)
    eager, graphed = (SupervisedBaseline(cfg, data.x_label, data.y_label, "cuda", noise_seed=cfg.seed)
                      for _ in range(2))
    e_losses = []
    for _ in range(k):
        eager.state, m = eager.train_step(eager.state, eager.data)
        e_losses.append(m["loss"])
    g_losses = [graphed.step() for _ in range(k)]
    check((graphed.chunk.captures, graphed.chunk.replays) == (1, k),
          f"supervised bitwise: {graphed.chunk.captures} captures, {graphed.chunk.replays} replays")
    bad = [i for i, (a, b) in enumerate(zip(e_losses, g_losses)) if not torch.equal(a, b)]
    got, want = list(S._state_tensors(graphed.state)), list(S._state_tensors(eager.state))
    diff = sum(not torch.equal(a, b) for a, b in zip(got, want))
    check(not bad and diff == 0 and graphed.state.step == eager.state.step == k,
          f"the supervised arm's graphed steps differ from its eager steps: losses of steps {bad}, "
          f"{diff} of {len(got)} state tensors")
    return {"steps": k, "state_tensors": len(got), "losses": [float(v) for v in g_losses]}


def digits_phase(root: str) -> dict:
    """The digits recipe for seed ``DIGITS_SEED`` as the campaign
    (``triplegan_tpu_torch/tools/digits_experiment.py``) runs it: ``cli
    prepare --dataset digits`` (from the file the package carries; a
    subprocess); ``cli train`` of its stage command (mnist100 at its
    published widths on 1,297 real 28 × 28 images, 100 labels, 300 epochs
    of 12 steps, α_P from epoch 100, an eval every 100 epochs, a checkpoint
    every 200, ``scan_steps=4``: 900 CUDA graph replays) through
    ``cli.main`` in this process, so that its launches are counted: (4
    captured + 1 warm-up) × ``step_launches`` plus 3 evals of 500 test
    images and 3 grids, key for key, the replays counted by the runner and
    three of them profiled, each holding 4 × a step's kernels by name;
    then ``DIGITS_B_BITWISE`` steps of the supervised arm graphed against
    as many eager steps (``digits_supervised_bitwise``); then the
    supervised arm (``supervised_baseline``, 3000 full-batch steps, each a
    replay of one captured step) in this process, its launches those that
    its warm-up step, its capture and its eval imply, the replays counted
    by its runner and three of them profiled, each holding a step's
    kernels by name; then ``cli eval`` (a subprocess), which must print the
    error train logged last. The replayed launches are those of the
    profiled replays.
    Gates: the Triple-GAN error at most ``DIGITS_ERROR_MAX`` percent, every
    logged loss finite, and the launches."""
    import contextlib
    import shutil

    import torch

    from triplegan_tpu_torch import cli as port_cli
    from triplegan_tpu_torch.cli import _apply_overrides
    from triplegan_tpu_torch.configs import get_config
    from triplegan_tpu_torch.tools import campaign
    from triplegan_tpu_torch.tools.digits_experiment import baseline_config, supervised_baseline
    from triplegan_tpu_torch.train import loop as train_loop
    from triplegan_tpu_torch.train import step as S

    data_dir, workdir = os.path.join(root, "digits_data"), os.path.join(root, "digits_runs")
    cmds = campaign.stage_cmds(DIGITS_SEED, workdir=workdir, data_dir=data_dir, num_labeled=DIGITS_LABELS,
                               epochs=300, warmup_epochs=100, eval_every_epochs=100, ckpt_every_epochs=200,
                               device="cuda", scan_steps=GRAPH_K)
    prepare_s, _ = cli(*cmds["prepare"])
    sets = [kv for flag, kv in zip(cmds["train"], cmds["train"][1:]) if flag == "--set"]
    cfg = _apply_overrides(get_config("mnist100"), sets)
    run_dir = os.path.join(workdir, cfg.name)

    runners = []
    real_scan = train_loop.make_scan_device_train_step

    def keep_runner(*args, **kwargs):
        runners.append(SampledProfiledRunner(real_scan(*args, **kwargs), DIGITS_PROFILED))
        return runners[-1]

    det = torch.backends.cudnn.deterministic
    out = io.StringIO()
    train_loop.make_scan_device_train_step = keep_runner
    try:
        counts_zero()  # the main path starts here
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                port_cli.main(cmds["train"])
        except BaseException:
            sys.stderr.write(out.getvalue()[-4000:])
            raise
        train_s = time.perf_counter() - t0
        counts = counts_read()  # the main path ends here
    finally:
        train_loop.make_scan_device_train_step = real_scan
        torch.backends.cudnn.deterministic = det
    log = out.getvalue()
    done = done_line(log)
    total = 300 * 12
    check(done.startswith(f"done: step={total} "), f"digits train: {done}")
    check(len(runners) == 1, f"digits train made {len(runners)} chunk runners")
    runner = runners[0].runner
    check((runner.captures, runner.replays, runner.warmup_steps) == (1, total // GRAPH_K, 1),
          f"digits graph: {runner.captures} captures, {runner.replays} replays, {runner.warmup_steps} warm-ups")
    counted = runner.captured_steps + runner.warmup_steps
    launches = check_step_launches(cfg, counts, counted, "digits train", n_evals=3, n_grids=3, n_test=DIGITS_TEST)
    per_step = step_totals(cfg)
    for prof in runners[0].profiles:
        got = replayed_launches(prof)
        check(got == {k: GRAPH_K * v for k, v in per_step.items()},
              f"a digits replay ran {got}, want {GRAPH_K} × {per_step}")
    check(len(runners[0].profiles) == len(DIGITS_PROFILED), f"digits: {len(runners[0].profiles)} replays profiled")
    replayed = collections.Counter()
    for prof in runners[0].profiles:
        replayed.update(replayed_launches(prof))

    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    losses = [r for r in recs if "loss_d" in r]
    evals = {r["step"]: r["test_error"] for r in recs if "test_error" in r}
    check(all(math.isfinite(v) for r in losses for k, v in r.items() if k not in ("step", "time")),
          "digits train: a logged loss is not finite")
    check(sorted(evals) == [1200, 2400, 3600], f"digits evals at steps {sorted(evals)}")
    error_pct = float(done.split("test_error=")[1].rstrip("%"))
    check(error_pct <= DIGITS_ERROR_MAX, f"digits seed {DIGITS_SEED}: test error {error_pct}% > {DIGITS_ERROR_MAX}%")
    kept = sorted(int(d) for d in os.listdir(os.path.join(run_dir, "ckpt")) if d.isdigit())
    check(kept == [2400, 3600], f"digits checkpoints {kept}")
    ms = [1e3 * cfg.batch_size / r["images_per_sec"] for r in recs if r.get("images_per_sec")]

    # the supervised arm: each step a replay of one captured step; the
    # wrappers count at the warm-up step and the capture, and the profiled
    # replays must each run a step's kernels by name
    b_cfg = baseline_config(data_dir, DIGITS_SEED, DIGITS_LABELS)
    bitwise = digits_supervised_bitwise(b_cfg, DIGITS_B_BITWISE)
    step_convs, step_fwd, step_bwd, eval_convs, eval_fwd = digits_baseline_launches(b_cfg)
    b_step = {"scale_bias_act": step_fwd, "scale_bias_act_bwd": step_bwd,
              "conv3x3_fwd": sum(c for k, c in step_convs.items() if k[0] != "wgrad"),
              "conv3x3_wgrad": sum(c for k, c in step_convs.items() if k[0] == "wgrad")}
    b_runners, real_chunk = [], S.ScanChunk

    def keep_chunk(*args, **kwargs):
        b_runners.append(SampledProfiledRunner(real_chunk(*args, **kwargs), DIGITS_B_PROFILED))
        return b_runners[-1]

    S.ScanChunk = keep_chunk
    try:
        counts_zero()  # the supervised arm starts here
        t0 = time.perf_counter()
        b_err = supervised_baseline(data_dir, DIGITS_SEED, DIGITS_BASELINE_STEPS, DIGITS_LABELS, log_every=0,
                                    device="cuda")
        baseline_s = time.perf_counter() - t0
        b_counts = counts_read()  # and ends here
    finally:
        S.ScanChunk = real_chunk
    check(len(b_runners) == 1, f"the supervised arm made {len(b_runners)} chunk runners")
    b_runner = b_runners[0].runner
    check((b_runner.captures, b_runner.replays, b_runner.warmup_steps) == (1, DIGITS_BASELINE_STEPS, 1),
          f"supervised graph: {b_runner.captures} captures, {b_runner.replays} replays, "
          f"{b_runner.warmup_steps} warm-ups")
    check(len(b_runners[0].profiles) == len(DIGITS_B_PROFILED),
          f"supervised: {len(b_runners[0].profiles)} replays profiled")
    b_profiled = [replayed_launches(prof) for prof in b_runners[0].profiles]
    check(all(got == b_step for got in b_profiled),
          f"the supervised arm's profiled replays ran {b_profiled} by kernel name, its step {b_step}")
    eval_s, eval_out = cli(*cmds["eval"])
    torch.backends.cudnn.deterministic = det
    err_line = eval_out.strip().splitlines()[-1]
    check(err_line == "test error: " + done.split("test_error=")[1], f"digits cli eval printed {err_line!r}, "
                                                                    f"train {done!r}")
    want_convs = collections.Counter({k: 2 * c for k, c in step_convs.items()}) + eval_convs
    got_convs = b_counts["conv3x3_fwd"] + b_counts["conv3x3_wgrad"]
    b_launches = totals(b_counts)
    check(got_convs == want_convs and b_launches["scale_bias_act"] == 2 * step_fwd + eval_fwd
          and b_launches["scale_bias_act_bwd"] == 2 * step_bwd,
          f"digits supervised arm: launches {b_launches}, conv keys beyond the implied (a warm-up step, "
          f"a capture, an eval) {dict(got_convs - want_convs)}, implied and not launched "
          f"{dict(want_convs - got_convs)}")
    for got in b_profiled:
        replayed.update(got)
    replayed = {k: replayed[k] for k in b_step}
    counts_all = {name: counts[name] + b_counts[name] for name in counts}
    launches_all = {k: launches[k] + b_launches[k] for k in launches}
    final = {k: losses[-1][k] for k in ("loss_d", "loss_g", "loss_c", "c_sup")}
    res = {"seed": DIGITS_SEED, "num_labeled": DIGITS_LABELS, "steps": total, "triplegan_error_pct": error_pct,
           "evals": evals, "baseline_error_pct": 100 * b_err, "baseline_steps": DIGITS_BASELINE_STEPS,
           "final_losses": final, "prepare_seconds": prepare_s, "train_seconds": train_s,
           "graphed_ms_per_step_median": statistics.median(ms), "log_windows": len(ms),
           "eval_seconds_cli": eval_s, "baseline_seconds": baseline_s,
           "graph": {"captures": runner.captures, "replays": runner.replays, "profiled": list(DIGITS_PROFILED),
                     **runner.graph_stats},
           "baseline_graph": {"captures": b_runner.captures, "replays": b_runner.replays,
                              "profiled": list(DIGITS_B_PROFILED), **b_runner.graph_stats},
           "baseline_bitwise": bitwise,
           "markers_lost": {"train": [p["markers_lost"] for p in runners[0].profiles],
                            "supervised": [p["markers_lost"] for p in b_runners[0].profiles]},
           "launches_counted": launches_all, "launches_replayed": replayed,
           "launches": {k: launches_all[k] + replayed[k] for k in launches_all},
           "launches_train": launches, "launches_baseline": b_launches,
           "baseline_profiled": {"step": b_step, "by_name": b_runners[0].profiles[-1]["_hand"]},
           "_sources": [("digits train", counts, {}), ("digits supervised", b_counts, {})], "_counts": counts_all}
    shutil.rmtree(workdir, ignore_errors=True)
    emit("digits", public(res))
    return res


# ---------------------------------------------------------------------------
# phase 4: the train step on the card against the CPU
# ---------------------------------------------------------------------------


def deterministic(cfg):
    """``cfg`` with no input noise, dropout or augmentation and α_P live
    from the first step: a step on the card and on the CPU then computes
    the same update from the same batch (with argmax pseudo-labels)."""
    cfg.disc.input_noise = cfg.disc.input_dropout = cfg.disc.block_dropout = 0.0
    cfg.clf.input_noise = cfg.clf.block_dropout = 0.0
    cfg.aug_translate, cfg.aug_flip = 0, False
    cfg.alpha_p_warmup_epochs = 0
    return cfg


def few_channels(cfg):
    """``cfg`` with cifar10_4k's layer structure (and its own number of
    Generator deconvs) at a few channels, z of 16."""
    cfg.gen.widths = (16,) + (8,) * (len(cfg.gen.widths) - 1)
    cfg.disc.widths = (8, 8, 16, 16, 16, 16)
    cfg.clf.conv_blocks = ((16, 16, 16), (16, 16, 16))
    cfg.clf.tail = (16, 16, 16)
    cfg.z_dim = 16
    return cfg


def card_vs_cpu(cfg, data, zca, what: str, gate: bool = True) -> dict:
    """Two steps of ``cfg`` (``make_train_step``, argmax pseudo-labels) on
    the same batches, drawn on the CPU, from the same seeded state: on the
    card with the kernels and on the CPU with their plain versions. With
    ``gate``: metrics within 1e-4·(1 + |m|); parameters within 2·N·lr, 95%
    within lr/100. Without: the same numbers, and beside them those of the
    CPU's plain arm (use_pallas off: ``F.conv2d``) against the CPU's
    kernel arm (its plain versions), the spread that summation order alone
    gives the reference on one machine."""
    import copy

    import torch

    from triplegan_tpu_torch import bridge
    from triplegan_tpu_torch.configs import make_networks
    from triplegan_tpu_torch.train.schedule import make_optimizers
    from triplegan_tpu_torch.train.state import create_state
    from triplegan_tpu_torch.train.step import METRICS, _make_batch_sampler, make_train_step, \
        upload_device_data

    sample = _make_batch_sampler(cfg)
    cpu_data = upload_device_data(data, "cpu")
    n = 2
    batches = [sample(0, t, cpu_data) for t in range(n)]
    lr = float(cfg.lr_c)
    out, secs = {}, {}
    for dev, use_pallas in [("cuda", True), ("cpu", True)] + ([] if gate else [("cpu", False)]):
        c = copy.deepcopy(cfg)
        c.use_pallas = use_pallas
        nets = make_networks(c)
        opts = make_optimizers(c, 100)
        state = create_state(c, nets, opts, device=dev)
        step = make_train_step(c, nets, opts, 100, zca_stats=zca, pseudo_label_mode="argmax")
        ms = []
        t0 = time.perf_counter()
        for batch in batches:
            b = {s: {k: v.to(dev) for k, v in d.items()} for s, d in batch.items()}
            state, m = step(state, b)
            ms.append({k: float(v) for k, v in m.items()})
        secs[dev if use_pallas else "cpu_plain"] = time.perf_counter() - t0
        params = {p: bridge.flat(state.params[p], state.bn[p]) for p in state.params}
        out[dev, use_pallas] = (ms, {p: {k: v.cpu() for k, v in sd.items()} for p, sd in params.items()})

    def agree(got, want):
        worst = max(abs(a[k] - b[k]) / (1 + abs(b[k])) for a, b in zip(got[0], want[0]) for k in METRICS)
        errs = torch.cat([(got[1][p][k] - v).abs().flatten() for p, sd in want[1].items() for k, v in sd.items()])
        return {"metrics_max_rel_diff": worst, "param_max_abs_diff": float(errs.max()),
                "param_frac_within_lr_100": float((errs <= lr / 100).double().mean())}

    res = {"what": what, "batch": cfg.batch_size, "steps": n, "gated": gate,
           **agree(out["cuda", True], out["cpu", True]), "lr": lr, "seconds": secs,
           "metrics_card": out["cuda", True][0], "metrics_cpu": out["cpu", True][0]}
    if not gate:
        res["cpu_plain_vs_cpu"] = agree(out["cpu", False], out["cpu", True])
    emit("train_card_vs_cpu", res)
    if gate:
        check(res["metrics_max_rel_diff"] <= 1e-4,
              f"{what}: card and CPU train metrics differ by {res['metrics_max_rel_diff']} (relative)")
        check(res["param_max_abs_diff"] <= 2 * n * lr,
              f"{what}: card and CPU params differ by {res['param_max_abs_diff']}")
        check(res["param_frac_within_lr_100"] >= 0.95,
              f"{what}: card/CPU params: {res['param_frac_within_lr_100']}")
    return res


def card_vs_cpu_phase(data, zca) -> dict:
    """``card_vs_cpu`` of cifar10_4k's layers at a few channels, batch 8."""
    from triplegan_tpu_torch.configs import get_config

    cfg = few_channels(deterministic(get_config("cifar10_4k")))
    cfg.batch_size = 8
    return card_vs_cpu(cfg, data, zca, "cifar10_4k at a few channels")


# ---------------------------------------------------------------------------
# phase 4b: the debug tools: checkify_step and a trace window
# ---------------------------------------------------------------------------


def debug_phase(data, zca) -> dict:
    """One eager shipped step (cifar10_4k, float32, batch 100, kernel arm,
    ``make_train_step`` on a host batch from ``BatchSampler``) unchecked
    and under ``utils/debug.py::checkify_step``, whose metrics must equal
    the unchecked step's within phase 3's float32 tolerance; the same
    step with the D stream's ``z`` poisoned (NaN) must raise
    ``NonFiniteError`` naming an aten operator; a step whose first Inf
    appears in a gradient (the derivative of sqrt at 0, run
    by autograd's device thread) must raise naming ``SqrtBackward0``. Then
    one ``utils/profiling.py::trace`` window around one step, whose Chrome
    trace must hold each group of hand-written kernels by name
    (``HAND_KERNELS``, the wrappers' groups); their counts there against
    the launches a step implies are reported (the profiler may drop a
    record at the window's edges: no gate on them)."""
    import torch

    from triplegan_tpu_torch.configs import make_networks
    from triplegan_tpu_torch.data.pipeline import BatchSampler
    from triplegan_tpu_torch.train.schedule import make_optimizers
    from triplegan_tpu_torch.train.state import create_state
    from triplegan_tpu_torch.train.step import make_train_step
    from triplegan_tpu_torch.utils.debug import NonFiniteError, checkify_step
    from triplegan_tpu_torch.utils.profiling import trace

    cfg = train_cfg("float32", BATCH, False, True)
    nets, opts = make_networks(cfg), make_optimizers(cfg, TOTAL_STEPS)
    state = create_state(cfg, nets, opts, device="cuda")
    step = make_train_step(cfg, nets, opts, TOTAL_STEPS, zca)
    host = BatchSampler(data, BATCH, seed=SEED).next_triple(cfg.z_dim, cfg.num_classes)

    def on_card(batch):
        return {k: {kk: torch.as_tensor(v, device="cuda") for kk, v in s.items()} for k, s in batch.items()}

    def metrics(fn, batch):
        return {k: float(v) for k, v in fn(state, on_card(batch))[1].items()}

    checked = checkify_step(step)
    want, got = metrics(step, host), metrics(checked, host)
    for k in want:
        check(abs(got[k] - want[k]) <= 1e-3 * (1 + abs(want[k])), f"checkify changed {k}: {got[k]} vs {want[k]}")
    poisoned = {k: dict(v) for k, v in host.items()}
    poisoned["d"]["z"] = np.full_like(host["d"]["z"], np.nan)
    try:
        checked(state, on_card(poisoned))
        fail("checkify_step let a step with a NaN z through")
    except NonFiniteError as e:
        poisoned_msg = str(e)
    check(poisoned_msg.startswith("NaN or Inf in the output of aten."), f"checkify's error: {poisoned_msg}")

    def grad_step(st, batch):
        x = batch.clone().requires_grad_(True)
        g, = torch.autograd.grad((x.sqrt() * 2.0).sum(), x)
        return st, {"g": g.sum()}

    try:
        checkify_step(grad_step)(None, torch.tensor([0.0, 1.0], device="cuda"))
        fail("checkify_step let an Inf that first appears in a gradient through")
    except NonFiniteError as e:
        grad_msg = str(e)
    check("in the backward of SqrtBackward0" in grad_msg and "its forward at " in grad_msg,
          f"checkify's gradient error: {grad_msg}")

    logdir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        with trace(logdir) as path:
            float(step(state, on_card(host))[1]["loss_c"])
            time.sleep(PROFILE_MARGIN_S)
        with open(path) as f:
            names = [e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
        trace_mb = os.path.getsize(path) / 1e6
    finally:
        import shutil

        shutil.rmtree(logdir, ignore_errors=True)
    frags = {name: [f for g in groups for f in HAND_KERNELS[g]] for name, groups in WRAPPER_GROUP.items()}
    in_trace = {name: sum(1 for n in names if any("(anonymous namespace)::" + f in n for f in frags[name]))
                for name in WRAPPER_GROUP}
    for name, n in in_trace.items():
        check(n > 0, f"the trace window's Chrome trace holds no {name} kernel ({frags[name]})")
    res = {"config": "cifar10_4k float32 batch 100 kernel arm, make_train_step on a host batch",
           "poisoned_error": poisoned_msg, "gradient_error": grad_msg, "trace_kernels": in_trace,
           "trace_kernels_implied": step_totals(cfg), "trace_device_kernels": len(names), "trace_mb": trace_mb}
    emit("debug", res)
    del state, step
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 5: the train driver, checkpoints and resume, through the CLI
# ---------------------------------------------------------------------------

DRIVER_SETS = ["steps_per_epoch=4", "eval_every_epochs=1", "ckpt_every_epochs=1", "log_every=2"]
DRIVER_TRAIN = 4096  # more than cifar10's 3072 pixel values, so that ZCA's covariance is of full rank
DRIVER_TEST = 1000  # test images: 10 eval batches of 100


def synthetic_split(n: int, size: int, rng, channels: int = 3) -> tuple:
    """n seeded images of size × size × channels, class-dependent blobs as
    ``synthetic_dataset`` draws them, and their int32 labels."""
    y = rng.randint(0, 10, size=n).astype(np.int32)
    x = (y[:, None, None, None].astype(np.float32) + 1.0) * (255.0 / 11) + \
        rng.normal(0, 24.0, size=(n, size, size, channels))
    return np.clip(x, 0, 255).astype(np.uint8), y


# the raw writers' datasets: (image size, channels)
RAW_SHAPES = {"cifar10": (32, 3), "stl10": (96, 3), "mnist": (28, 1), "svhn": (32, 3)}


def write_raw(raw_dir: str, dataset: str, n_train: int, n_test: int) -> None:
    """A seeded synthetic dataset (``synthetic_split``: the train images,
    then the test images, from one stream) written as the dataset's
    distribution files, which ``cli prepare`` converts: cifar10 as
    ``cifar-10-batches-py/data_batch_1..5`` (the train images in five
    python pickle batches of rows of 3072 CHW bytes) and ``test_batch``;
    stl10 as ``stl10_binary/{train,test}_X.bin`` (CWH bytes an image) and
    ``_y.bin`` (labels 1..10); mnist as the uncompressed idx files
    ``{train,t10k}-{images-idx3,labels-idx1}-ubyte`` (28 × 28 × 1); svhn as
    ``{train,test}_32x32.mat`` (``X`` (32, 32, 3, N) uint8, ``y`` (N, 1) in
    1..10, 10 for the digit 0)."""
    import pickle

    size, channels = RAW_SHAPES[dataset]
    rng = np.random.RandomState(SEED)
    (x_tr, y_tr), (x_te, y_te) = (synthetic_split(n_train, size, rng, channels),
                                  synthetic_split(n_test, size, rng, channels))
    splits = (("train", x_tr, y_tr), ("test", x_te, y_te))
    if dataset == "cifar10":
        d = os.path.join(raw_dir, "cifar-10-batches-py")
        os.makedirs(d)
        parts = [(f"data_batch_{i + 1}", x_tr[idx], y_tr[idx])
                 for i, idx in enumerate(np.array_split(np.arange(n_train), 5))]
        for name, x, y in parts + [("test_batch", x_te, y_te)]:
            with open(os.path.join(d, name), "wb") as f:
                pickle.dump({b"data": x.transpose(0, 3, 1, 2).reshape(len(x), -1), b"labels": y.tolist()}, f)
    elif dataset == "stl10":
        d = os.path.join(raw_dir, "stl10_binary")
        os.makedirs(d)
        for split, x, y in splits:
            with open(os.path.join(d, f"{split}_X.bin"), "wb") as f:
                f.write(x.transpose(0, 3, 2, 1).tobytes())
            with open(os.path.join(d, f"{split}_y.bin"), "wb") as f:
                f.write((y + 1).astype(np.uint8).tobytes())
    elif dataset == "mnist":
        os.makedirs(raw_dir)
        for split, x, y in splits:
            name = "t10k" if split == "test" else split
            with open(os.path.join(raw_dir, f"{name}-images-idx3-ubyte"), "wb") as f:
                f.write(struct.pack(">IIII", 2051, len(x), size, size) + x.tobytes())
            with open(os.path.join(raw_dir, f"{name}-labels-idx1-ubyte"), "wb") as f:
                f.write(struct.pack(">II", 2049, len(y)) + y.astype(np.uint8).tobytes())
    else:
        from scipy.io import savemat

        check(dataset == "svhn", f"no raw writer for {dataset}")
        os.makedirs(raw_dir)
        for split, x, y in splits:
            savemat(os.path.join(raw_dir, f"{split}_32x32.mat"),
                    {"X": x.transpose(1, 2, 3, 0), "y": np.where(y == 0, 10, y).astype(np.uint8).reshape(-1, 1)})


def cli(*args, timeout=600, rc=0) -> tuple:
    """Run ``python -m triplegan_tpu_torch.cli`` with these arguments from
    this checkout: (seconds, standard output); fails unless it exits
    ``rc``."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "triplegan_tpu_torch.cli", *args], cwd=REPO,
                         capture_output=True, text=True, timeout=timeout)
    secs = time.perf_counter() - t0
    check(out.returncode == rc, f"cli {' '.join(args[:1])} exited {out.returncode}, want {rc}:\n"
                                f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    return secs, out.stdout


def train_args(workdir, data_dir, max_steps, *sets) -> list:
    args = ["train", "--config", "cifar10_4k", "--workdir", workdir, "--data-dir", data_dir]
    for kv in DRIVER_SETS + list(sets):
        args += ["--set", kv]
    return args + ["--max-steps", str(max_steps)]


def done_line(stdout: str) -> str:
    lines = [ln for ln in stdout.splitlines() if ln.startswith("done: ")]
    check(len(lines) == 1, f"no 'done:' line in\n{stdout[-2000:]}")
    return lines[0]


def ckpt_flat(path: str) -> dict:
    """A checkpoint file's leaves by path, on the CPU."""
    import torch

    def walk(tree, prefix=""):
        for k in sorted(tree):
            v = tree[k]
            yield from walk(v, f"{prefix}{k}/") if isinstance(v, dict) else [(prefix + k, v)]

    return dict(walk(torch.load(path, map_location="cpu", weights_only=True)))


def ckpt_equal(a: str, b: str) -> list:
    """The leaves in which two checkpoint files differ (bitwise)."""
    import torch

    fa, fb = ckpt_flat(a), ckpt_flat(b)
    if sorted(fa) != sorted(fb):
        return ["<keys>"]
    return [k for k in fa if not (torch.equal(fa[k], fb[k]) if isinstance(fa[k], torch.Tensor)
                                  else fa[k] == fb[k])]


def png_size(path: str) -> tuple:
    """(width, height, bit depth, color type) from a PNG's IHDR."""
    with open(path, "rb") as f:
        head = f.read(29)
    check(head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR", f"{path} is not a PNG")
    w, h, depth, color = struct.unpack(">IIBB", head[16:26])
    return w, h, depth, color


def stop_and_resume(workdir, data_dir) -> dict:
    """``cli train`` for up to 40 steps, stopped by a STOP file once its
    first step line appears: it must exit 75 having checkpointed a step
    N ≤ 4; then a re-run with ``--set scan_steps=4`` must resume from step
    N and run to step 8 (a chunk of 4 steps as a CUDA graph, captured after
    the restore, then single steps). The caller holds its step-8
    checkpoint to the straight run's."""
    args = [sys.executable, "-m", "triplegan_tpu_torch.cli", *train_args(workdir, data_dir, 40)]
    run_dir = os.path.join(workdir, "cifar10_4k")
    t0 = time.perf_counter()
    proc = subprocess.Popen(args, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env={**os.environ, "PYTHONUNBUFFERED": "1"})
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("step "):
                open(os.path.join(run_dir, "STOP"), "w").close()
                break
        rest, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    secs = time.perf_counter() - t0
    out = "".join(lines) + rest
    check(proc.returncode == 75, f"stopped train exited {proc.returncode}, want 75:\n{out[-3000:]}")
    check("preempted" in out, "stopped train printed no 'preempted' line")
    steps = sorted(int(n) for n in os.listdir(os.path.join(run_dir, "ckpt")) if n.isdigit())
    check(bool(steps) and steps[-1] <= 8 - GRAPH_K, f"stopped train checkpointed {steps}")
    resume_s, out2 = cli(*train_args(workdir, data_dir, 8 - steps[-1], f"scan_steps={GRAPH_K}"))
    check(f"resumed from step {steps[-1]}" in out2, f"re-run did not resume from step {steps[-1]}")
    captured = [ln for ln in out2.splitlines() if ln.startswith(f"graph: captured {GRAPH_K} steps")]
    check(len(captured) == 1, "the graphed re-run printed no capture line")
    return {"stop_seconds": secs, "stopped_at": steps[-1], "resume_seconds": resume_s,
            "resumed_done": done_line(out2), "graphed_capture": captured[0]}


def resume_4_4(workdir, data_dir) -> tuple:
    """``cli train`` for 4 steps, then the same command again: it must
    resume from step 4. (seconds of each run, the second's stdout)."""
    secs = []
    for _ in range(2):
        t, out = cli(*train_args(workdir, data_dir, 4))
        secs.append(t)
    check("resumed from step 4" in out, "second 4-step run did not resume from step 4")
    return secs, out


def driver_cfg(workdir, data_dir, name, *sets):
    from triplegan_tpu_torch.cli import _apply_overrides
    from triplegan_tpu_torch.configs import get_config

    cfg = _apply_overrides(get_config("cifar10_4k"), DRIVER_SETS + list(sets))
    cfg.workdir, cfg.data_dir = os.path.join(workdir, name), data_dir
    return cfg


class ProfiledRunner:
    """A chunk runner of the loop whose every replay runs under
    ``device_kernels`` (its capture, when it needs one, before and outside
    the profile): ``profiles`` holds one per replay."""

    def __init__(self, runner):
        self.runner, self.profiles = runner, []

    def __call__(self, state, data):
        self.runner.prepare(state, data)
        out = []
        self.profiles.append(device_kernels(lambda: out.append(self.runner(state, data)), reps=1))
        return out[0]


class SampledProfiledRunner(ProfiledRunner):
    """``ProfiledRunner`` that profiles only the replays numbered in
    ``which`` (1-based) and counts every call."""

    def __init__(self, runner, which):
        super().__init__(runner)
        self.which, self.calls = set(which), 0

    def __call__(self, state, data):
        self.calls += 1
        if self.calls in self.which:
            return super().__call__(state, data)
        return self.runner(state, data)


def driver_inprocess(data_dir, workdir, train_arms) -> dict:
    """One ``train_loop.train(cfg, max_steps=10)`` of cifar10_4k (float32,
    batch 100, kernel arm) with ``scan_steps=4`` in this process, its
    launches counted from just before to just after: two chunks of 4 steps
    (one capture, two replays) and 2 single steps. The wrappers count at
    capture, in the chunk's warm-up step and in the eager steps, so the
    conv launches must be (4 + 1 + 2) × step_launches(cfg) key for key,
    plus those of its three evals (10 test batches each through the
    Classifier, at steps 4, 8 and 10) and two sample grids (100 images
    through the Generator); the epilogue counts their implied numbers;
    every launch at a shape the shipped train arm of phase 3 launched (so
    phase 7 holds it against the plain versions). Each replay runs under
    torch.profiler (``ProfiledRunner``): its device records must hold each
    wrapper's kernel 4 × its launches a step, and they are the launches
    the replays made. Then the plain arm must launch nothing."""
    import torch

    from triplegan_tpu_torch.train import loop as train_loop

    cfg = driver_cfg(workdir, data_dir, "kernel", f"scan_steps={GRAPH_K}")
    n_steps, n_evals, n_grids = 10, 3, 2
    runners = []
    real_scan = train_loop.make_scan_device_train_step

    def keep_runner(*args, **kwargs):
        runners.append(ProfiledRunner(real_scan(*args, **kwargs)))
        return runners[-1]

    det = torch.backends.cudnn.deterministic
    train_loop.make_scan_device_train_step = keep_runner
    try:
        counts_zero()  # the main path starts here
        res = train_loop.train(cfg, max_steps=n_steps, verbose=False, device="cuda")
        counts = counts_read()  # the main path ends here
        train_loop.make_scan_device_train_step = real_scan
        check(len(runners) == 1, f"the driver made {len(runners)} chunk runners")
        runner = runners[0].runner
        check((runner.captures, runner.replays, runner.warmup_steps) == (1, 2, 1),
              f"driver graph: {runner.captures} captures, {runner.replays} replays")
        counted = runner.captured_steps + runner.warmup_steps + n_steps - runner.n * runner.replays
        launches = check_step_launches(cfg, counts, counted, "driver", n_evals, n_grids)
        shipped = next(a for a in train_arms if a["setting"] == "shipped" and a["use_pallas"])["_counts"]
        for name, c in counts.items():
            unseen = set(c) - set(shipped[name])
            check(not unseen, f"driver launched {name} at shapes phase 3 did not: {sorted(unseen)}")
        check(res["steps"] == n_steps and not res["preempted"], f"driver in-process: {res['steps']} steps")
        per_step = step_totals(cfg)
        replayed = collections.Counter()
        for prof in runners[0].profiles:
            got_r = replayed_launches(prof)
            check(got_r == {k: runner.n * v for k, v in per_step.items()},
                  f"a driver replay ran {got_r}, want {runner.n} × {per_step}")
            replayed.update(got_r)
        graph = {"counted_steps": counted, "captures": runner.captures, "replays": runner.replays,
                 **runner.graph_stats}

        counts_zero()
        plain = train_loop.train(driver_cfg(workdir, data_dir, "plain", "use_pallas=false"), max_steps=2,
                                 verbose=False, device="cuda")
        plain_launches = totals(counts_read())
        check(not any(plain_launches.values()), f"the plain arm's driver launched {plain_launches}")
        check(plain["steps"] == 2, "plain driver run")
    finally:
        train_loop.make_scan_device_train_step = real_scan
        torch.backends.cudnn.deterministic = det
    return {"launches_counted": launches, "launches_replayed": dict(replayed),
            "launches": {k: launches[k] + replayed[k] for k in launches}, "_counts": counts,
            "test_error": res["test_error"], "graph": graph, "_res": res, "_cfg": cfg}


def step_totals(cfg) -> dict:
    """Each wrapper's launches in one train step of ``cfg`` with use_pallas."""
    convs, _, epilogues, epilogue_bwds = step_launches(cfg)
    return {"scale_bias_act": epilogues, "scale_bias_act_bwd": epilogue_bwds,
            "conv3x3_fwd": sum(c for key, c in convs.items() if key[0] != "wgrad"),
            "conv3x3_wgrad": sum(c for key, c in convs.items() if key[0] == "wgrad")}


def driver_rechecks(data_dir, workdir, inproc, n_steps=12) -> dict:
    """With nothing else running: one eval of the in-process run's final
    state, which must give the run's test error; two checkpoint saves of
    that state in turn, as the loop makes them (the first also allocates
    the manager's pinned host buffers), at two step numbers, whose leaves
    must be equal bitwise; and an in-process run of ``n_steps`` steps
    (shipped setting, kernel arm, cuDNN deterministic as the driver runs)
    with ``scan_steps=4``, a log every 4 steps and no eval, grid or
    checkpoint before the end, which must log at every fourth step."""
    import torch

    from triplegan_tpu_torch.ckpt.manager import CheckpointManager
    from triplegan_tpu_torch.configs import make_networks
    from triplegan_tpu_torch.data.pipeline import BatchSampler
    from triplegan_tpu_torch.eval.metrics import evaluate_error
    from triplegan_tpu_torch.train import loop as train_loop
    from triplegan_tpu_torch.train.step import make_eval_step

    res, cfg = inproc["_res"], inproc["_cfg"]
    state = res["state"]
    sampler = BatchSampler(train_loop._resolve_data(cfg), cfg.batch_size)
    zca = train_loop._resolve_zca(cfg, sampler.data, os.path.join(cfg.workdir, cfg.name))
    eval_step = make_eval_step(cfg, make_networks(cfg), zca)
    err = evaluate_error(eval_step, state, train_loop._test_stream(sampler, torch.device("cuda")))
    check(err == res["test_error"], f"re-evaluated error {err} != the run's {res['test_error']}")
    saver = CheckpointManager(os.path.join(workdir, "saves"))
    for step_no in (state.step, state.step + 1):
        check(saver.save(step_no, state), f"save {step_no} refused")
        saver.wait()
    check(not ckpt_equal(os.path.join(saver.directory, str(state.step)),
                         os.path.join(saver.directory, str(state.step + 1))), "the two saves differ")

    det = torch.backends.cudnn.deterministic
    try:
        cfg = driver_cfg(workdir, data_dir, "graphed", f"scan_steps={GRAPH_K}", "log_every=4",
                         "eval_every_epochs=0", "ckpt_every_epochs=0")
        run = train_loop.train(cfg, max_steps=n_steps, verbose=False, device="cuda")
    finally:
        torch.backends.cudnn.deterministic = det
    check(run["steps"] == n_steps, f"graphed loop run: {run['steps']} steps")
    with open(os.path.join(run["workdir"], "metrics.jsonl")) as f:
        logged = sorted(r["step"] for r in map(json.loads, f) if "images_per_sec" in r)
    check(logged == list(range(4, n_steps + 1, 4)), f"graphed loop logged at {logged}")
    return {"reevaluated_error": err, "saves_equal": True, "graphed_loop_logged_at": logged}


def driver_phase(train_arms, data_dir) -> dict:
    """The train driver end to end, through the CLI as a user calls it, on
    cifar10_4k at full width (float32, batch 100, kernel arm; 4 steps an
    epoch, an eval, a sample grid and a checkpoint each epoch, a log every
    2 steps): a straight 8-step run, alone; then, side by side (four
    threads, each running its CLI processes in turn, and this process): ``cli eval`` of the
    straight run, which must print its final test error; ``cli sample``; a
    run of 4 steps resumed for 4 more, whose step-8 checkpoint must equal
    the straight run's bitwise; a run stopped by a STOP file and resumed to
    step 8 as a CUDA graph (``--set scan_steps=4``), bitwise equal to the
    straight run; and the in-process graphed run whose launches are
    counted. Then, alone again, ``driver_rechecks``."""
    # beside the data, whose directory the caller removes: the straight
    # run's w1 stays for the deploy phase
    tmp = tempfile.mkdtemp(prefix="driver_", dir=os.path.dirname(data_dir))
    try:
        w1, w2, w3 = (os.path.join(tmp, w) for w in ("w1", "w2", "w3"))
        run1 = os.path.join(w1, "cifar10_4k")

        straight_s, out = cli(*train_args(w1, data_dir, 8))
        done = done_line(out)
        check(done.startswith("done: step=8 "), f"straight run: {done}")
        with open(os.path.join(run1, "metrics.jsonl")) as f:
            recs = [json.loads(ln) for ln in f]
        logged = [r["step"] for r in recs if "loss_c" in r]
        evals = {r["step"]: r["test_error"] for r in recs if "test_error" in r}
        check(logged == [2, 4, 6, 8], f"metrics logged at steps {logged}")
        check(sorted(evals) == [4, 8], f"test errors logged at steps {sorted(evals)}")
        for it in (4, 8):
            check(os.path.exists(os.path.join(run1, f"samples_{it:08d}.png")), f"no sample grid at {it}")
        kept = sorted(int(n) for n in os.listdir(os.path.join(run1, "ckpt")) if n.isdigit())
        check(kept == [4, 8], f"checkpoints kept {kept}")

        grid = os.path.join(tmp, "grid.png")
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            f_eval = ex.submit(cli, "eval", "--config", "cifar10_4k", "--workdir", w1, "--data-dir", data_dir)
            f_sample = ex.submit(cli, "sample", "--config", "cifar10_4k", "--workdir", w1, "--data-dir", data_dir,
                                 "--out", grid, "--n-per-class", "5")
            f_resume = ex.submit(resume_4_4, w2, data_dir)
            f_stop = ex.submit(stop_and_resume, w3, data_dir)
            inproc = driver_inprocess(data_dir, os.path.join(tmp, "w4"), train_arms)
            eval_s, out = f_eval.result()
            sample_s, _ = f_sample.result()
            resume_s, out2 = f_resume.result()
            stop = f_stop.result()
        side_by_side_s = time.perf_counter() - t0
        err_line = out.strip().splitlines()[-1]
        check(err_line == "test error: " + done.split("test_error=")[1],
              f"cli eval printed {err_line!r}, train {done!r}")
        check(png_size(grid) == (160, 320, 8, 2), f"sample grid IHDR {png_size(grid)}")
        check(done_line(out2) == done, f"resumed run: {done_line(out2)}; straight: {done}")
        diff = ckpt_equal(os.path.join(run1, "ckpt", "8"), os.path.join(w2, "cifar10_4k", "ckpt", "8"))
        check(not diff, f"4+4 resumed checkpoint differs from the straight run's at {diff[:10]}")
        check(stop["resumed_done"] == done, f"graphed re-run: {stop['resumed_done']}; straight: {done}")
        diff = ckpt_equal(os.path.join(run1, "ckpt", "8"), os.path.join(w3, "cifar10_4k", "ckpt", "8"))
        check(not diff, f"the graphed re-run's step-8 checkpoint differs from the eager run's at {diff[:10]}")
        rechecks = driver_rechecks(data_dir, os.path.join(tmp, "w5"), inproc)
    finally:
        import shutil

        for w in ("w2", "w3", "w4", "w5"):
            shutil.rmtree(os.path.join(tmp, w), ignore_errors=True)
    res = {"config": "cifar10_4k float32 batch 100 kernel arm", "_workdir": w1,
           "straight_8_seconds": straight_s, "side_by_side_seconds": side_by_side_s,
           "resume_4_4_seconds": resume_s, "eval_seconds_cli": eval_s, "sample_seconds_cli": sample_s,
           **stop, "graphed_bitwise": True, "final": done,
           "resume_bitwise": True, **{k: v for k, v in inproc.items() if not k.startswith("_")}, **rechecks}
    emit("driver", res)
    return res


# ---------------------------------------------------------------------------
# phase 5d: deploy: export, qualify, score, serve and reload the driver's run
# ---------------------------------------------------------------------------

DEPLOY_SAMPLES = 1000   # generated samples an inception or fid run scores
DEPLOY_PREDICT = 250    # images a predict labels: chunks 100, 100, 50 (+50 pad)


def served_inputs(cfg, n: int):
    """Seeded uint8 images, float32 z and int32 labels, as a client sends them."""
    images = np.random.RandomState(SEED).randint(
        0, 256, size=(n, cfg.image_size, cfg.image_size, cfg.channels), dtype=np.uint8)
    z = np.random.RandomState(3).normal(size=(n, cfg.z_dim)).astype(np.float32)
    return images, z, (np.arange(n) % cfg.num_classes).astype(np.int32)


def max_diff(a, b) -> float:
    return float((a.double().cpu() - b.double().cpu()).abs().max())


def serve_start(run_args) -> tuple:
    """``cli serve`` of ``run_args`` on an ephemeral port: (process, base URL,
    seconds until it printed its "serving on" line)."""
    proc = subprocess.Popen([sys.executable, "-m", "triplegan_tpu_torch.cli", "serve", *run_args, "--port", "0"],
                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env={**os.environ, "PYTHONUNBUFFERED": "1"})
    t0 = time.perf_counter()
    lines = []
    for line in proc.stdout:  # warnings first, if any
        lines.append(line)
        if line.startswith("serving on http://"):
            break
    if not (lines and lines[-1].startswith("serving on http://")):
        proc.kill()
        proc.wait()
        fail(f"cli serve printed:\n{''.join(lines)[-3000:]}")
    return proc, lines[-1].split()[2], time.perf_counter() - t0


def serve_and_reload(proc, base, train_cmd, images, want_logits, before_train) -> dict:
    """The server of ``serve_start`` (``cli serve --config`` of the run dir):
    /healthz serves the newest checkpoint (step 8), /classify of ``images``
    agrees with the artifact's logits; then, once ``before_train()`` has
    returned (the other CLI runs read the run dir's config.json, which a
    train run rewrites), one more ``cli train`` step in the run dir and
    ``POST /reload``: /healthz moves to step 9 and a second /classify
    differs; SIGTERM, and the server exits 0."""
    try:
        health = json.loads(http("GET", base + "/healthz")[1])
        check(health["source"] == "checkpoint" and health["step"] == 8 and "reload" in health["endpoints"]
              and health["backend"] == "cuda", f"/healthz: {health}")
        first = load_npy(http("POST", base + "/classify", npy(images), "application/x-npy")[1])
        diff = float(np.abs(first - want_logits).max())
        check(diff <= 1e-4, f"/classify and the artifact's logits differ by {diff}")
        before_train()
        train_s, out = cli(*train_cmd)
        check(done_line(out).startswith("done: step=9 "), f"the extra train step: {done_line(out)}")
        t1 = time.perf_counter()
        reloaded = json.loads(http("POST", base + "/reload", b"", "application/json")[1])
        reload_s = time.perf_counter() - t1
        check(reloaded == {"reloaded": True, "step": 9}, f"/reload: {reloaded}")
        check(json.loads(http("GET", base + "/healthz")[1])["step"] == 9, "/healthz after /reload")
        second = load_npy(http("POST", base + "/classify", npy(images), "application/x-npy")[1])
        check(not np.array_equal(first, second), "/classify did not change after /reload")
        metrics = http("GET", base + "/metrics")[1].decode()
        check('triplegan_requests_total{endpoint="reload"} 1' in metrics and "triplegan_checkpoint_step 9" in metrics,
              "/metrics after /reload")
        proc.send_signal(15)
        rest, _ = proc.communicate(timeout=60)
        check(proc.returncode == 0, f"cli serve exited {proc.returncode} on SIGTERM:\n{rest[-3000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return {"classify_vs_artifact_max_abs_diff": diff, "classify_vs_artifact_bitwise": diff == 0.0,
            "train_step_seconds": train_s, "reload_seconds": reload_s,
            "max_abs_change_after_reload": float(np.abs(second - first).max()), "sigterm_exit": 0}


def deploy_phase(driver, data_dir) -> dict:
    """Everything a user does with the driver's trained run (cifar10_4k at
    full width, float32, batch 100, kernel arm; checkpoints 4 and 8), through
    the CLI and in this process, the CLI runs side by side (each ``import
    torch`` takes ≈10 s of a process's time):
      * at once: ``cli export --format pt2`` (both players, float32) and
        ``--quantize int8`` at the served batch of 100; ``cli serve --config``
        of the run dir; and ``cli inception``, ``cli fid`` (1000 samples of
        checkpoint 8, the checkpoint's classifier scoring) and ``cli
        predict`` from checkpoint 8 (250 images);
      * once the artifacts are written, ``cli eval --artifact`` (it must
        print the 8-step run's error), ``cli predict --artifact`` (the
        checkpoint's labels) and inception and fid with the artifact as
        ``--scorer-path``; meanwhile, in this process, the main path: the
        float32 artifacts loaded on the card, one classify of seeded uint8
        images and one generate of seeded z, y, the launch counts set to 0
        just before and read just after: each wrapper's launches must equal
        the forward's convs and epilogues of C and G, key for key, and a
        call pair under torch.profiler must run each hand-written kernel as
        often, counted by kernel name in its device records; the artifacts
        against ``make_serving_fns`` on the card (within 1e-4; bitwise
        recorded); the same artifacts moved to the CPU against the card
        (atol 1e-4); the int8 artifact's logits against the float32 ones
        (within 0.05 of the largest logit or of 1); the files' sizes;
      * ``serve_and_reload`` on the server, its extra train step after
        every other CLI run has ended."""
    import torch

    from triplegan_tpu_torch.cli import _load_zca, _restore_run
    from triplegan_tpu_torch.export import load_pt2, make_serving_fns

    t0 = time.perf_counter()
    w1 = driver["_workdir"]
    out = tempfile.mkdtemp(prefix="deploy_", dir=os.path.dirname(data_dir))
    run_args = ["--config", "cifar10_4k", "--workdir", w1, "--data-dir", data_dir]
    at8 = [*run_args, "--step", "8"]  # the extra train step below writes a step 9
    dirs = {"float32": os.path.join(out, "f32"), "int8": os.path.join(out, "int8")}
    paths = {fmt: {kind: os.path.join(d, f"{kind}.pt2") for kind in ("classify", "generate")}
             for fmt, d in dirs.items()}
    f32c = paths["float32"]["classify"]
    pred_in = os.path.join(out, "images.npy")
    p_ckpt, p_art = os.path.join(out, "p_ckpt.npz"), os.path.join(out, "p_art.npz")
    proc, base, serve_start_s = serve_start(run_args)
    ex = concurrent.futures.ThreadPoolExecutor(8)
    try:
        jobs = {f"export_{fmt}": ex.submit(cli, "export", *at8, "--batch-size", str(BATCH), "--out", d,
                                           *(["--quantize", "int8"] if fmt == "int8" else []))
                for fmt, d in dirs.items()}
        cfg, nets, state, workdir, dev, _ = _restore_run(argparse.Namespace(
            config="cifar10_4k", workdir=w1, data_dir=data_dir, set=None, step=8, device="cuda"), mesh=False)
        check(state.step == 8 and cfg.batch_size == BATCH and cfg.compute_dtype == "float32" and cfg.use_pallas,
              f"deploy: the driver's run is at step {state.step}, batch {cfg.batch_size}")
        np.save(pred_in, served_inputs(cfg, DEPLOY_PREDICT)[0])
        samples = ["--n-samples", str(DEPLOY_SAMPLES)]
        for name, args in (("inception", ("inception", *at8, *samples)), ("fid", ("fid", *at8, *samples)),
                           ("predict_checkpoint", ("predict", *at8, "--input", pred_in, "--out", p_ckpt))):
            jobs[name] = ex.submit(cli, *args)
        export_s = {fmt: jobs[f"export_{fmt}"].result()[0] for fmt in dirs}
        for name, args in (("eval_artifact", ("eval", *run_args, "--artifact", f32c)),
                           ("predict_artifact", ("predict", "--artifact", f32c, "--input", pred_in, "--out", p_art)),
                           ("inception_artifact", ("inception", *at8, *samples, "--scorer-path", f32c)),
                           ("fid_artifact", ("fid", *at8, *samples, "--scorer-path", f32c))):
            jobs[name] = ex.submit(cli, *args)
        sizes = {fmt: {kind: os.path.getsize(p) for kind, p in ps.items()} for fmt, ps in paths.items()}

        classify, generate = make_serving_fns(cfg, nets, state, zca_stats=_load_zca(cfg, workdir), device=dev)
        art = {fmt: {kind: load_pt2(p, device=dev) for kind, p in ps.items()} for fmt, ps in paths.items()}
        shape = (BATCH, cfg.image_size, cfg.image_size, cfg.channels)
        check(art["float32"]["classify"].in_specs == ((shape, torch.uint8),), "classify artifact's input spec")
        check(art["float32"]["generate"].in_specs == (((BATCH, cfg.z_dim), torch.float32),
                                                      ((BATCH,), torch.int32)), "generate artifact's input spec")
        images, z, y = served_inputs(cfg, BATCH)
        ti, tz, ty = (torch.from_numpy(a).to(dev) for a in (images, z, y))
        ac, ag = art["float32"]["classify"], art["float32"]["generate"]
        torch.cuda.synchronize()

        counts_zero()  # the main path starts here
        logits = ac(ti)
        imgs = ag(tz, ty)
        torch.cuda.synchronize()
        counts = counts_read()  # the main path ends here
        launches = totals(counts)
        gen_l, _, clf_l = conv_layers(cfg)
        want = fwd_launches(cfg, BATCH, clf_l) + fwd_launches(cfg, BATCH, gen_l)
        check(counts["conv3x3_fwd"] == want, f"an artifact call pair's conv launches "
                                             f"{dict(counts['conv3x3_fwd'])}, want {dict(want)}")
        n_c = sum(len(b) for b in cfg.clf.conv_blocks) + len(cfg.clf.tail)
        n_g = len(cfg.gen.widths) + 1
        want_totals = {"scale_bias_act": n_c + n_g, "scale_bias_act_bwd": 0, "conv3x3_fwd": want.total(),
                       "conv3x3_wgrad": 0}
        check(launches == want_totals, f"an artifact call pair launched {launches}, want {want_totals}")
        # one call pair under the profiler; a profile may lack a record (on an
        # H100 one kept 9 of the 10 conv kernels' records), so up to three are taken
        profiled = []
        for _ in range(3):
            prof = device_kernels(lambda: (ac(ti), ag(tz, ty)), reps=1)
            profiled.append({"by_kernel_name": replayed_launches(prof), "hand_kernels": prof["_hand"]})
            if profiled[-1]["by_kernel_name"] == want_totals:
                break
        by_name = profiled[-1]["by_kernel_name"]
        check(by_name == want_totals, f"the profiled artifact call pairs ran {profiled} by kernel name, want "
                                      f"{want_totals}; the wrappers' launches by call: "
                                      f"{dict(counts['conv3x3_fwd'])}")
        check(logits.shape == (BATCH, cfg.num_classes) and bool(torch.isfinite(logits).all()), "artifact logits")
        check(imgs.shape == shape and float(imgs.abs().max()) <= 1.0, "artifact images")

        ref_logits, ref_imgs = classify(ti), generate(tz, ty)
        vs_inproc = {"logits_max_abs_diff": max_diff(logits, ref_logits),
                     "images_max_abs_diff": max_diff(imgs, ref_imgs),
                     "bitwise": bool(torch.equal(logits, ref_logits) and torch.equal(imgs, ref_imgs))}
        check(max(vs_inproc["logits_max_abs_diff"], vs_inproc["images_max_abs_diff"]) <= 1e-4,
              f"artifact against in-process serving: {vs_inproc}")

        cpu = {kind: load_pt2(p, device="cpu") for kind, p in paths["float32"].items()}
        cpu_logits = cpu["classify"](torch.from_numpy(images))
        cpu_imgs = cpu["generate"](torch.from_numpy(z), torch.from_numpy(y))
        vs_cpu = {"logits_max_abs_diff": max_diff(logits, cpu_logits),
                  "images_max_abs_diff": max_diff(imgs, cpu_imgs),
                  "max_abs_logit": float(cpu_logits.abs().max()), "limit": 1e-4}
        check(max(vs_cpu["logits_max_abs_diff"], vs_cpu["images_max_abs_diff"]) <= 1e-4,
              f"the artifact on the card against the same artifact on the CPU: {vs_cpu}")

        q_logits = art["int8"]["classify"](ti)
        q_imgs = art["int8"]["generate"](tz, ty)
        int8 = {"logits_max_abs_diff": max_diff(q_logits, logits), "images_max_abs_diff": max_diff(q_imgs, imgs),
                "max_abs_logit": float(logits.abs().max()),
                "argmax_agree": float((q_logits.argmax(1) == logits.argmax(1)).float().mean())}
        # the JAX package's bound for its int8 artifact, 0.05, is set on logits
        # of size ≈1 (its tiny test config, which tests/test_torch_export.py
        # keeps); here it scales with the largest logit
        int8["limit"] = 0.05 * max(1.0, int8["max_abs_logit"])
        check(int8["logits_max_abs_diff"] < int8["limit"], f"int8 artifact's logits: {int8}")

        done = {}
        served = serve_and_reload(proc, base, train_args(w1, data_dir, 1), images, logits.cpu().numpy(),
                                  lambda: done.update({name: f.result() for name, f in jobs.items()}))
    finally:
        ex.shutdown(wait=True)
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    side_by_side_s = time.perf_counter() - t0
    del art, cpu
    torch.cuda.empty_cache()

    err = done["eval_artifact"][1].strip().splitlines()[-1]
    check(err == "test error (artifact): " + driver["final"].split("test_error=")[1],
          f"cli eval --artifact printed {err!r}; the run: {driver['final']!r}")
    with np.load(p_ckpt) as a, np.load(p_art) as b:
        check(np.array_equal(a["labels"], b["labels"]), "predict: checkpoint and artifact labels differ")
        predict = {"images": DEPLOY_PREDICT, "labels_equal": True,
                   "logits_max_abs_diff": float(np.abs(a["logits"] - b["logits"]).max())}
    scores = {}
    for name in ("inception", "inception_artifact", "fid", "fid_artifact"):
        line = done[name][1].strip().splitlines()[-1]
        value = float(line.split(": ")[1].split()[0])
        check(math.isfinite(value) and value >= (1.0 if name.startswith("inception") else 0.0),
              f"cli {name}: {line}")
        scores[name] = {"line": line, "value": value}
    res = {"config": "cifar10_4k float32 batch 100 kernel arm, the driver's run at step 8",
           "export_seconds": export_s, "sizes_bytes": sizes,
           "launches": launches, "launches_by_kernel_name": by_name, "profiles": len(profiled),
           "_counts": counts, "artifact_vs_inprocess": vs_inproc, "artifact_card_vs_cpu": vs_cpu,
           "int8_vs_float32": int8, "eval_artifact": err, "predict": predict, "scores": scores,
           "cli_seconds": {name: r[0] for name, r in done.items()},
           "serve": {"start_seconds": serve_start_s, **served},
           "side_by_side_seconds": side_by_side_s, "seconds": time.perf_counter() - t0}
    emit("deploy", public(res))
    return res


# ---------------------------------------------------------------------------
# phase 5b: host-streamed batches, ddinit, the fused classifier, the layer
# variants
# ---------------------------------------------------------------------------

HOST_SETS = ["data_on_device=False", "ddinit=True", "fused_clf_forward=True"]
HOST_STEPS = 6          # counted host-streamed steps; the first 4 byte-checked
HOST_BYTE_STEPS = 4
# the layer variants the JAX package reads from the environment, each at a
# value with which it computes another layer
VARIANTS = [("TRIPLEGAN_DROPOUT_BITS", "8"), ("TRIPLEGAN_MAXPOOL", "reshape"), ("TRIPLEGAN_MAXPOOL", "maskbwd"),
            ("TRIPLEGAN_SMALLCIN", "patches"), ("TRIPLEGAN_DECONV", "transpose")]


def host_cfg(use_pallas):
    """The shipped setting (float32, batch 100, share off) with the three
    options of a host-streamed run: data_on_device off, ddinit, the fused
    classifier."""
    cfg = train_cfg("float32", BATCH, False, use_pallas)
    cfg.data_on_device, cfg.ddinit, cfg.fused_clf_forward = False, True, True
    return cfg


def metrics_agree(a: dict, b: dict, what: str) -> dict:
    """Step metrics of two arms within phase 3's float32 tolerance,
    1e-3·(1 + |m|); returns the differences."""
    diffs = {k: abs(a[k] - b[k]) for k in a}
    for k in a:
        check(diffs[k] <= 1e-3 * (1 + abs(b[k])), f"{what}: step-1 {k} differs between arms: {a[k]} vs {b[k]}")
    return diffs


def wn_preactivations(disc, params, x, y):
    """D's weight-norm pre-activations (conv with g·v/‖v‖ plus b, then the
    head's dense) on (x, y), stochastic layers off, through F.conv2d."""
    import torch

    from triplegan_tpu_torch.nn import layers as L

    y1h = L.onehot(y, disc.num_classes, dtype=x.dtype)
    h = L.label_concat_spatial(x, y1h)
    out = []
    for i, s in enumerate(disc.strides):
        t = L.conv2d_apply(params[f"conv{i}"], h, stride=s)
        out.append(t)
        h = L.leaky_relu(t, disc.lrelu_slope)
        if s == 2 and disc.label_reconcat and i + 1 < len(disc.widths):
            h = L.label_concat_spatial(h, y1h)
    out.append(L.dense_apply(params["head"], torch.cat([L.global_avg_pool(h), y1h], -1)))
    return out


def ddinit_on_card(cfg, nets, state, data, zca) -> tuple:
    """``_apply_ddinit`` on the card, its launches counted (D's stride-1
    convs and G's phase convs, forwards at the init batch); the new
    parameters against a CPU ddinit of the same inputs from the same
    seeded state within 1e-4·(1 + |p|); D's weight-norm pre-activations on
    the init batch zero-mean and of unit std per channel within 1e-3."""
    import torch

    from triplegan_tpu_torch.configs import make_networks
    from triplegan_tpu_torch.train import loop as train_loop
    from triplegan_tpu_torch.train.schedule import make_optimizers
    from triplegan_tpu_torch.train.state import create_state

    dev = torch.device("cuda")
    n = min(cfg.batch_size, len(data.x_unlabel))
    gen, disc, _ = conv_layers(cfg)
    counts_zero()
    new = train_loop._apply_ddinit(cfg, nets, state, data, zca, dev)
    torch.cuda.synchronize()
    counts = counts_read()
    want = fwd_launches(cfg, n, disc) + fwd_launches(cfg, n, gen)
    got = counts["conv3x3_fwd"] + counts["conv3x3_wgrad"]
    check(got == want, f"ddinit conv launches {dict(got - want)}; implied and not launched {dict(want - got)}")
    check(not counts["scale_bias_act"] and not counts["scale_bias_act_bwd"], "ddinit launched epilogues")

    t0 = time.perf_counter()
    cpu_nets = make_networks(cfg)
    cpu_state = create_state(cfg, cpu_nets, make_optimizers(cfg, TOTAL_STEPS), device="cpu")
    cpu_new = train_loop._apply_ddinit(cfg, cpu_nets, cpu_state, data, zca, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    worst = 0.0
    for p in ("gen", "disc"):
        for layer, arrays in cpu_new.params[p].items():
            for k, ref in arrays.items():
                err = ((new.params[p][layer][k].cpu() - ref).abs() / (1 + ref.abs())).max()
                worst = max(worst, float(err))
    check(worst <= 1e-4, f"card and CPU ddinit differ by {worst}·(1 + |p|)")

    x, y, _, _ = train_loop._ddinit_inputs(cfg, data, zca, dev)
    with torch.no_grad():
        pre = wn_preactivations(nets[1], new.params["disc"], x, y)
    mean_dev = max(float(t.reshape(-1, t.shape[-1]).double().mean(0).abs().max()) for t in pre)
    std_dev = max(float((t.reshape(-1, t.shape[-1]).double().std(0, correction=0) - 1).abs().max()) for t in pre)
    check(mean_dev <= 1e-3 and std_dev <= 1e-3,
          f"ddinit pre-activations: per-channel |mean| up to {mean_dev}, |std - 1| up to {std_dev}")
    res = {"batch": n, "launches": totals(counts), "card_vs_cpu_rel": worst, "cpu_ddinit_seconds": cpu_s,
           "preact_max_abs_mean": mean_dev, "preact_max_abs_std_minus_1": std_dev, "layers_checked": len(pre)}
    return new, counts, res


def device_memcpy(fn) -> dict:
    """torch.profiler over one call of ``fn``: the host-to-device copies'
    device records (count, µs), by name (the name says pinned or
    pageable)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and "HtoD" in e.name():
            rec = by_name[e.name()]
            rec[0] += 1
            rec[1] += (e.end_ns() - e.start_ns()) / 1e3
    return {name: {"count": c, "us": us} for name, (c, us) in by_name.items()}


def host_arm(data, zca) -> dict:
    """The host-streamed path in this process (``host_cfg``, kernel arm):
    ddinit first (``ddinit_on_card``); then ``HOST_STEPS`` steps of
    ``make_train_step`` fed by ``device_prefetch`` over the port's
    ``BatchSampler`` (the native gather, which must be in use), counted
    from just before the first to just after the last: the conv launches
    must be ``HOST_STEPS`` × step_launches of a step whose classifier runs
    at 3B rows, key for key, the epilogues their implied numbers; each of
    the first ``HOST_BYTE_STEPS`` batches on the card must equal the
    sampler's host batch bytewise. The plain arm's first step from the
    same ddinit state on the same batch must agree with the kernel arm's
    (phase 3's float32 tolerance) and launch nothing. Leaves the state,
    step, stream and first host batch for ``host_copies``."""
    import torch

    from triplegan_tpu_torch.configs import make_networks
    from triplegan_tpu_torch.data import native
    from triplegan_tpu_torch.data.pipeline import BatchSampler, device_prefetch
    from triplegan_tpu_torch.train import step as S
    from triplegan_tpu_torch.train.schedule import make_optimizers
    from triplegan_tpu_torch.train.state import create_state

    dev = torch.device("cuda")
    cfg = host_cfg(True)
    nets = make_networks(cfg)
    opts = make_optimizers(cfg, TOTAL_STEPS)
    state = create_state(cfg, nets, opts, device="cuda")
    state, dd_counts, dd = ddinit_on_card(cfg, nets, state, data, zca)
    start = S._clone_state(state)

    host = []
    sampler = BatchSampler(data, cfg.batch_size, seed=SEED)

    def stream():
        for b in sampler.triple_iter(cfg.z_dim, cfg.num_classes):
            host.append(b)
            yield b

    batches = device_prefetch(stream(), dev)
    step = S.make_train_step(cfg, nets, opts, TOTAL_STEPS, zca_stats=zca)
    torch.cuda.synchronize()
    seen, metrics = [], []
    counts_zero()  # the main path starts here
    for t in range(HOST_STEPS):
        batch = next(batches)
        if t < HOST_BYTE_STEPS:
            seen.append({(s, k): v.clone() for s, d in batch.items() for k, v in d.items()})
        state, m = step(state, batch)
        metrics.append(m)
    metrics = [{k: float(v) for k, v in m.items()} for m in metrics]  # waits for the steps
    counts = counts_read()  # the main path ends here
    check(native.native_available(), "the sampler's gathers did not go through the native library")
    for t, got in enumerate(seen):
        want = host[t]
        check(len(got) == sum(len(d) for d in want.values()), f"host batch {t}: fields {sorted(got)}")
        for (s, k), v in got.items():
            check(np.array_equal(v.cpu().numpy(), want[s][k]) and v.dtype == torch.from_numpy(want[s][k]).dtype,
                  f"host-streamed step {t}: {s}.{k} on the card differs from the sampler's host batch")
    for t, m in enumerate(metrics):
        check(all(math.isfinite(v) for v in m.values()), f"host-streamed step {t}: {m}")
    convs, players, _, _ = step_launches(cfg)
    check(any(key[1] == 3 * BATCH and key[0] == "fwd" for key in convs) and
          all(not (key[1] == BATCH and key[0] == "wgrad" and "clf" in players[key]) for key in convs),
          "step_launches does not run the classifier at 3B rows")
    launches = check_step_launches(cfg, counts, HOST_STEPS, "host-streamed")

    pcfg = host_cfg(False)
    pstep = S.make_train_step(pcfg, make_networks(pcfg), make_optimizers(pcfg, TOTAL_STEPS), TOTAL_STEPS,
                              zca_stats=zca)
    first = {s: {k: torch.as_tensor(v, device=dev) for k, v in d.items()} for s, d in host[0].items()}
    counts_zero()
    _, pm = pstep(start, first)
    pm = {k: float(v) for k, v in pm.items()}
    check(not any(totals(counts_read()).values()), "the plain arm's host-streamed step launched kernels")
    diffs = metrics_agree(metrics[0], pm, "host-streamed fused")
    arm = {"config": "cifar10_4k float32 batch 100 kernel arm, data_on_device=False, ddinit, fused_clf_forward",
           "steps": HOST_STEPS, "ddinit": dd, "ddinit_launches": dd["launches"], "launches": launches,
           "launches_per_step": {k: v / HOST_STEPS for k, v in launches.items()},
           "native_gather": True, "bytes_checked_steps": HOST_BYTE_STEPS,
           "metrics": metrics, "plain_step1": pm, "arms_abs_diff": diffs,
           "_counts": counts, "_dd_counts": dd_counts, "_players": players,
           "_state": state, "_step": step, "_batches": batches, "_cfg": cfg, "_host0": host[0]}
    return arm


def host_copies(arm) -> dict:
    """With nothing else running: ``device_prefetch``'s host buffers for
    the first host batch must be pinned, and one host-streamed step of
    ``host_arm`` under torch.profiler must make no host-to-device copy from
    pageable memory (its copies' records by name; Kineto does not always
    keep the side stream's copies)."""
    from triplegan_tpu_torch.data.pipeline import _leaves, _PinnedSlot

    check(all(b.is_pinned() for b in _leaves(_PinnedSlot(arm["_host0"]).bufs)),
          "device_prefetch's host buffers are not pinned")
    batches = arm["_batches"]

    def one_step():
        arm["_state"], m = arm["_step"](arm["_state"], next(batches))
        float(m["loss_c"])

    copies = device_memcpy(one_step)
    batches.close()
    check(not any("Pageable" in name for name in copies),
          f"host-streamed copies not all from pinned memory: {sorted(copies)}")
    return {"htod_profiled_step": copies}


def host_cli_chain(workdir, data_dir) -> dict:
    """``cli train`` with the host-streamed options for 4 steps, then the
    same command again: the first applies ddinit once, the second resumes
    from step 4 to 8 and applies no ddinit."""
    secs, outs = [], []
    for _ in range(2):
        t, out = cli(*train_args(workdir, data_dir, 4, *HOST_SETS))
        secs.append(t)
        outs.append(out)
    check(outs[0].count("applied data-dependent weight-norm init") == 1, "the first run printed no ddinit line")
    check("resumed from step 4" in outs[1], "the second host-streamed run did not resume from step 4")
    check("applied data-dependent" not in outs[1], "the resumed host-streamed run applied ddinit again")
    return {"seconds": secs, "done": done_line(outs[1])}


def variant_run(var, value, data_dir) -> dict:
    """One layer variant's step in a subprocess (``--variant-step``), whose
    environment sets it before anything is imported; its JSON line."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--variant-step", data_dir], cwd=REPO,
                         capture_output=True, text=True, timeout=600, env={**os.environ, var: value})
    check(out.returncode == 0, f"variant {var}={value} exited {out.returncode}:\n{out.stdout[-2000:]}\n"
                               f"{out.stderr[-3000:]}")
    res = json.loads(out.stdout.strip().splitlines()[-1])["variant"]
    res["seconds"] = time.perf_counter() - t0
    return res


def variant_step(data_dir):
    """``--variant-step``: one full-width eager shipped step (float32,
    batch 100, share off, device data) in each arm from the same seeded
    state, under the layer variant the environment sets. The kernel arm's
    launches must be what the variant implies (``step_launches``: patches
    and transpose move convs off the kernels), its losses finite; the
    plain arm must launch nothing and agree with it (phase 3's float32
    tolerance). Prints one JSON line with the counted launches."""
    import torch

    from triplegan_tpu_torch.configs import make_networks
    from triplegan_tpu_torch.data.datasets import load_dataset
    from triplegan_tpu_torch.data.zca import ZCAStats
    from triplegan_tpu_torch.nn import layers as L
    from triplegan_tpu_torch.train import step as S
    from triplegan_tpu_torch.train.schedule import make_optimizers
    from triplegan_tpu_torch.train.state import create_state

    env = {k: os.environ[k] for k, _ in VARIANTS if k in os.environ}
    check(len(env) == 1, f"--variant-step needs one variant set, got {env}")
    cfg = train_cfg("float32", BATCH, False, True)
    data = load_dataset(data_dir, "cifar10", cfg.num_labeled, cfg.num_classes, cfg.seed)
    zca = ZCAStats.load(os.path.join(data_dir, "cifar10", "zca_stats.npz"))
    dev_data = S.upload_device_data(data, "cuda")
    metrics = {}
    for use_pallas in (True, False):
        cfg.use_pallas = use_pallas
        nets = make_networks(cfg)
        opts = make_optimizers(cfg, TOTAL_STEPS)
        state = create_state(cfg, nets, opts, device="cuda")
        step = S.make_device_train_step(cfg, nets, opts, TOTAL_STEPS, zca_stats=zca)
        torch.cuda.synchronize()
        counts_zero()  # the main path starts here
        _, m = step(state, dev_data)
        metrics[use_pallas] = {k: float(v) for k, v in m.items()}
        counts = counts_read()  # the main path ends here
        if use_pallas:
            kernel_counts = counts
            check_step_launches(cfg, counts, 1, f"variant {env}")
        else:
            check(not any(totals(counts).values()), f"{env}: the plain arm launched kernels")
        check(all(math.isfinite(v) for v in metrics[use_pallas].values()), f"{env}: {metrics[use_pallas]}")
    diffs = metrics_agree(metrics[True], metrics[False], f"variant {env}")
    read = {"TRIPLEGAN_DECONV": L._DECONV_IMPL, "TRIPLEGAN_MAXPOOL": L._MAXPOOL_IMPL}
    for k, v in env.items():
        check(read.get(k, v) == v, f"{k}={v} was not read at import: the layers use {read.get(k)!r}")
    print(json.dumps({"variant": {
        "env": env, "launches": totals(kernel_counts),
        "counts": {name: [[list(key), c] for key, c in cnt.items()] for name, cnt in kernel_counts.items()},
        "conv_launches_default": sum(step_launches(cfg, {})[0].values()),
        "metrics_kernel": metrics[True], "metrics_plain": metrics[False], "arms_abs_diff": diffs}}), flush=True)


def variant_counts(res) -> dict:
    """A variant run's counts, keyed by tuples again (JSON made them
    lists, the epilogue's shape inside its key too)."""
    def tup(v):
        return tuple(tup(x) for x in v) if isinstance(v, list) else v

    return {name: collections.Counter({tup(key): c for key, c in pairs}) for name, pairs in res["counts"].items()}


def host_phase(data, zca, data_dir) -> dict:
    """Phase 5b: the two host-streamed CLI chains (``host_cli_chain``) and
    the five variants' subprocesses (``variant_run``) side by side, while
    this process runs ``host_arm``; then, alone, ``host_copies``. The two
    chains' step-8 checkpoints must be equal bitwise."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_host_")
    try:
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(2 + len(VARIANTS)) as ex:
            chains = [ex.submit(host_cli_chain, os.path.join(tmp, f"h{i}"), data_dir) for i in range(2)]
            variants = [ex.submit(variant_run, var, value, data_dir) for var, value in VARIANTS]
            arm = host_arm(data, zca)
            chain_res = [f.result() for f in chains]
            variant_res = [f.result() for f in variants]
        side_by_side_s = time.perf_counter() - t0
        diff = ckpt_equal(*(os.path.join(tmp, f"h{i}", "cifar10_4k", "ckpt", "8") for i in range(2)))
        check(not diff, f"the two host-streamed CLI runs' step-8 checkpoints differ at {diff[:10]}")
        check(chain_res[0]["done"] == chain_res[1]["done"], f"host-streamed CLI runs: {chain_res}")
        copies = host_copies(arm)
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    res = {**{k: v for k, v in arm.items() if not k.startswith("_")}, "side_by_side_seconds": side_by_side_s,
           "cli_chains": chain_res, "cli_checkpoints_bitwise": True, "variants": variant_res, **copies,
           "launches_counted": {k: arm["launches"][k] + sum(v["launches"][k] for v in variant_res)
                                + arm["ddinit_launches"][k] for k in arm["launches"]}}
    emit("host", res)
    res.update(_counts=arm["_counts"], _dd_counts=arm["_dd_counts"], _players=arm["_players"],
               _variant_counts=[(v["env"], variant_counts(v)) for v in variant_res])
    return res


# ---------------------------------------------------------------------------
# phase 5c: data parallelism: stl10 on a mesh of 2 ranks
# ---------------------------------------------------------------------------

MESH_WORLD = 2
MESH_STEPS = 4                     # the stochastic path's steps, and the NCCL chunk's
MESH_TRAIN, MESH_TEST = 2048, 256  # the synthetic STL-10's images (96 × 96 × 3)
MESH_NUM_LABELED = 1000            # stl10's num_labeled


def stl10_cfg(deterministic: bool = False):
    """stl10 at its published widths (batch 128, float32, kernel arm) on a
    mesh of ``MESH_WORLD``. ``deterministic``: no noise, dropout or
    augmentation, argmax pseudo-labels (``tests/helpers.py::
    deterministic_config``'s settings), so that a step on the ranks and one
    on the global batch compute the same update."""
    from triplegan_tpu_torch.configs import get_config

    cfg = get_config("stl10")
    cfg.mesh_shape = (MESH_WORLD,)
    if deterministic:
        cfg.disc.input_noise = cfg.disc.input_dropout = cfg.disc.block_dropout = 0.0
        cfg.clf.input_noise = cfg.clf.block_dropout = 0.0
        cfg.aug_translate, cfg.aug_flip = 0, False
        cfg.pseudo_label_mode = "argmax"
    return cfg


def per_rank(cfg, world: int = MESH_WORLD):
    """``cfg`` at one rank's batch: what ``step_launches`` counts a rank."""
    import copy

    out = copy.deepcopy(cfg)
    out.batch_size = cfg.batch_size // world
    return out


def mesh_loop_cfg(workdir, data_dir, name, steps_per_epoch, epochs, mesh=MESH_WORLD):
    """The driver's stl10 run of the mesh phase: deterministic layers,
    host-streamed batches (every rank's sampler draws the global batch, so
    a run on one rank trains on the same batches), an eval, a grid and a
    checkpoint every epoch."""
    cfg = stl10_cfg(deterministic=True)
    cfg.mesh_shape = (mesh,)
    cfg.name, cfg.workdir, cfg.data_dir = name, workdir, data_dir
    cfg.steps_per_epoch, cfg.epochs, cfg.log_every = steps_per_epoch, epochs, steps_per_epoch
    cfg.eval_every_epochs = cfg.ckpt_every_epochs = 1
    cfg.data_on_device = False
    return cfg


def floats(m) -> dict:
    return {k: float(v) for k, v in m.items()}


def state_flat(state) -> dict:
    """Every tensor of a train state by its path (params/, bn/, mu/, nu/),
    on the CPU."""
    trees = {"params": state.params, "bn": state.bn, "mu": {p: o.mu for p, o in state.opt.items()},
             "nu": {p: o.nu for p, o in state.opt.items()}}
    return {f"{kind}/{p}/{layer}/{name}": t.detach().cpu()
            for kind, tree in trees.items() for p, layers in tree.items()
            for layer, arrays in layers.items() for name, t in arrays.items()}


def state_hash(state) -> str:
    from triplegan_tpu_torch.parallel.mesh import state_digest

    return state_digest({"params": state.params, "bn": state.bn, "mu": {p: o.mu for p, o in state.opt.items()},
                         "nu": {p: o.nu for p, o in state.opt.items()}})


def states_agree(got: dict, want: dict, n_steps: int, lr: float, what: str) -> dict:
    """Two flat states within phase 4's tolerance: every parameter, batch-norm
    statistic and Adam moment within 2·N·lr, 95% of them within lr/100."""
    check(sorted(got) == sorted(want), f"{what}: the states hold other tensors")
    errs = np.concatenate([np.abs(np.asarray(got[k], np.float64) - np.asarray(want[k], np.float64)).ravel()
                           for k in sorted(want)])
    res = {"max_abs_diff": float(errs.max()), "frac_within_lr_100": float(np.mean(errs <= lr / 100)),
           "limit": 2 * n_steps * lr, "lr": lr, "steps": n_steps}
    check(res["max_abs_diff"] <= res["limit"], f"{what}: states differ by {res['max_abs_diff']}")
    check(res["frac_within_lr_100"] >= 0.95, f"{what}: {res['frac_within_lr_100']} within lr/100")
    return res


def metrics_within(a: dict, b: dict, what: str) -> float:
    """Metrics within 1e-4·(1 + |m|) (phase 4's); the worst relative gap."""
    check(sorted(a) == sorted(b), f"{what}: metrics {sorted(a)} vs {sorted(b)}")
    worst = max(abs(a[k] - b[k]) / (1 + abs(b[k])) for k in a)
    check(worst <= 1e-4, f"{what}: metrics differ by {worst} (relative): {a} vs {b}")
    return worst


def device_batch(batch, dev):
    import torch

    return {s: {k: torch.as_tensor(v, device=dev) for k, v in d.items()} for s, d in batch.items()}


def mesh_rank(mesh, plan) -> dict:
    """One rank of the mesh phase (``run_local_ranks``: 2 gloo ranks on the
    one card), in order: (1) one ``make_train_step`` step of deterministic
    stl10 on this rank's rows of the global host batch; (2) ``MESH_STEPS``
    device-data steps of the shipped stl10 (noise, dropout, augmentation,
    sampled pseudo-labels), its launches counted from just before to just
    after; (3) the
    driver, ``train()`` 4 steps and resumed for 4 more, with an eval, a
    grid and a checkpoint every 4 (each checkpoint's state hashed when it is
    saved), its launches counted; (4) a ``train()`` run whose coordinator
    writes the STOP file after its first step. States leave as sha256s
    (the coordinator's also as tensors), launch counts keyed by shape."""
    import torch

    from triplegan_tpu_torch.ckpt import manager
    from triplegan_tpu_torch.configs import make_networks
    from triplegan_tpu_torch.configs.base import apply_runtime
    from triplegan_tpu_torch.data.datasets import load_dataset
    from triplegan_tpu_torch.data.pipeline import BatchSampler
    from triplegan_tpu_torch.train import loop
    from triplegan_tpu_torch.train import step as S
    from triplegan_tpu_torch.train.schedule import make_optimizers
    from triplegan_tpu_torch.train.state import create_state
    from triplegan_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(str(mesh.device))
    out = {"rank": mesh.rank, "device": str(dev), "backend": mesh.backend}
    data = load_dataset(plan["data_dir"], "stl10", MESH_NUM_LABELED, 10, SEED)

    # (1) one step on this rank's rows of the global batch
    cfg = apply_runtime(stl10_cfg(deterministic=True))
    nets, opts = make_networks(cfg), make_optimizers(cfg, TOTAL_STEPS)
    state = create_state(cfg, nets, opts, device=dev)
    batch = BatchSampler(data, cfg.batch_size, seed=SEED, rows=mesh.rows(cfg.batch_size)).next_triple(
        cfg.z_dim, cfg.num_classes)
    step = S.make_train_step(cfg, nets, opts, TOTAL_STEPS, pseudo_label_mode="argmax", mesh=mesh)
    tb = device_batch(batch, dev)
    torch.cuda.synchronize()
    counts_zero()
    state, m = step(state, tb)
    out["equiv"] = {"metrics": floats(m), "digest": state_hash(state), "counts": counts_read()}
    if mesh.coordinator:
        out["equiv"]["flat"] = state_flat(state)
    del state, step, tb

    # (2) the shipped stochastic path on device data
    cfg = apply_runtime(stl10_cfg())
    nets, opts = make_networks(cfg), make_optimizers(cfg, TOTAL_STEPS)
    state = create_state(cfg, nets, opts, device=dev)
    step = S.make_device_train_step(cfg, nets, opts, TOTAL_STEPS, mesh=mesh)
    dev_data = S.upload_device_data(data, dev)
    torch.cuda.synchronize()
    ms = []
    counts_zero()  # the main path starts here
    for _ in range(MESH_STEPS):
        state, m = step(state, dev_data)
        ms.append(floats(m))  # waits for the step
    counts = counts_read()  # the main path ends here
    out["stochastic"] = {"metrics": ms, "digest": state_hash(state), "counts": counts,
                         "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    del state, step, dev_data
    torch.cuda.empty_cache()

    # (3) the driver: 4 steps, then resumed for 4 more
    saved, real_save = {}, manager.CheckpointManager.save

    def save(self, step_no, st):
        saved[int(step_no)] = state_hash(st)
        return real_save(self, step_no, st)

    cfg = mesh_loop_cfg(plan["workdir"], plan["data_dir"], "loop", 4, 2)
    manager.CheckpointManager.save = save
    try:
        counts_zero()  # the main path starts here
        t0 = time.perf_counter()
        runs = [loop.train(cfg, max_steps=4, verbose=False, device=dev) for _ in range(2)]
        secs = time.perf_counter() - t0
        counts = counts_read()  # the main path ends here
    finally:
        manager.CheckpointManager.save = real_save
    out["loop"] = {"runs": [{"steps": r["steps"], "preempted": r["preempted"], "test_error": r["test_error"],
                             "metrics": r["metrics"], "digest": state_hash(r["state"])} for r in runs],
                   "saved": saved, "counts": counts, "seconds": secs}
    if mesh.coordinator:
        out["loop"]["flat"] = state_flat(runs[1]["state"])
    del runs

    # (4) a STOP file, written by the coordinator after its first step
    cfg = mesh_loop_cfg(plan["workdir"], plan["data_dir"], "stop", 2, 4)
    stop_file = os.path.join(cfg.workdir, cfg.name, "STOP")
    real_make = loop.make_train_step

    def make(*a, **k):
        inner, calls = real_make(*a, **k), [0]

        def stepping(st, b):
            res = inner(st, b)
            calls[0] += 1
            if calls[0] == 1 and mesh.coordinator:
                open(stop_file, "w").close()
            return res

        return stepping

    loop.make_train_step = make
    try:
        r = loop.train(cfg, verbose=False, device=dev)
    finally:
        loop.make_train_step = real_make
    out["stop"] = {"steps": r["steps"], "preempted": r["preempted"], "digest": state_hash(r["state"])}
    out["collectives_total"] = mesh.collectives
    return out


def single_step(cfg, dev, batch):
    """One step of ``cfg`` on one process (no mesh) from the seeded state
    on ``batch`` (a host batch, through make_train_step): (state, its
    metrics, launches)."""
    import torch

    from triplegan_tpu_torch.configs import make_networks
    from triplegan_tpu_torch.configs.base import apply_runtime
    from triplegan_tpu_torch.train import step as S
    from triplegan_tpu_torch.train.schedule import make_optimizers
    from triplegan_tpu_torch.train.state import create_state

    apply_runtime(cfg)
    nets, opts = make_networks(cfg), make_optimizers(cfg, TOTAL_STEPS)
    state = create_state(cfg, nets, opts, device=dev)
    step = S.make_train_step(cfg, nets, opts, TOTAL_STEPS, pseudo_label_mode="argmax")
    x = device_batch(batch, dev)
    torch.cuda.synchronize()
    counts_zero()
    state, m = step(state, x)
    return state, floats(m), counts_read()


def nccl_chunk(data, data_root, dev) -> dict:
    """An NCCL group of this process alone (world 1, a FileStore) on the
    card: ``MESH_STEPS`` eager device-data steps of the shipped stl10 under
    it, then the same steps from the same state as one chunk of
    ``make_scan_device_train_step``, captured as a CUDA graph with the
    step's all-reduces inside and replayed once under torch.profiler. The
    replay must equal the eager steps bitwise (every state tensor, every
    step's metrics); the wrappers' counts, zeroed just before, must be
    (2·MESH_STEPS + 1) × step_launches (the eager steps, the chunk's
    warm-up step and its capture; the replay adds none) and the replay run
    each hand-written kernel MESH_STEPS × a step's count; whether NCCL
    kernels appear in the replay's device records is reported."""
    import torch
    import torch.distributed as dist

    from triplegan_tpu_torch.configs import make_networks
    from triplegan_tpu_torch.configs.base import apply_runtime
    from triplegan_tpu_torch.parallel.mesh import make_mesh
    from triplegan_tpu_torch.train import step as S
    from triplegan_tpu_torch.train.schedule import make_optimizers
    from triplegan_tpu_torch.train.state import create_state

    cfg = apply_runtime(stl10_cfg())
    cfg.mesh_shape = (1,)
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(data_root, "nccl_store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1, dev)
        nets, opts = make_networks(cfg), make_optimizers(cfg, TOTAL_STEPS)
        state = create_state(cfg, nets, opts, device=dev)
        dev_data = S.upload_device_data(data, dev)
        step = S.make_device_train_step(cfg, nets, opts, TOTAL_STEPS, mesh=mesh)
        runner = S.make_scan_device_train_step(cfg, nets, opts, TOTAL_STEPS, MESH_STEPS,
                                               log=lambda *a, **k: None, mesh=mesh)
        eager, ms = S._clone_state(state), []
        counts_zero()  # the main path starts here
        for _ in range(MESH_STEPS):
            eager, m = step(eager, dev_data)
            ms.append(m)
        runner.prepare(state, dev_data)
        holder = {}

        def one_chunk():
            holder["state"], _ = runner(state, dev_data)

        prof = device_kernels(one_chunk, reps=1)
        counts = counts_read()  # the main path ends here
        moments = moments_read()
        state = holder["state"]
        want = S._stacked(ms)
        bad = [k for k in S.METRICS if not torch.equal(runner.step_metrics[k], want[k])]
        check(not bad, f"nccl chunk: metrics {bad} differ from the eager steps'")
        got, ref = list(S._state_tensors(state)), list(S._state_tensors(eager))
        diff = sum(not torch.equal(a, b) for a, b in zip(got, ref))
        check(state.step == eager.step and diff == 0,
              f"nccl chunk: {diff} of {len(got)} state tensors differ from {MESH_STEPS} eager steps'")
        n = 2 * MESH_STEPS + 1
        launches = check_step_launches(cfg, counts, n, "nccl chunk")
        per_step = hand_kernels_per_step(counts, n, moments)
        in_chunk = {g: v["launches"] for g, v in prof["groups"].items()}
        check(all(in_chunk[g] == MESH_STEPS * per_step[g] for g in HAND_KERNELS),
              f"nccl chunk: the replay ran {in_chunk}, want {MESH_STEPS} × {per_step}")
        replayed = dict(replayed_launches(prof), **moments_replayed(prof))
        res = {"steps": MESH_STEPS, "bitwise": True, "backend": mesh.backend, "collectives": mesh.collectives,
               "graph": dict(runner.graph_stats), "nccl_kernels_in_replay": prof["nccl"],
               "top_device": prof["top_device"],
               "launches_counted": launches, "launches_replayed": replayed,
               "launches": {k: launches[k] + replayed[k] for k in launches}, "_counts": counts}
        del state, eager, runner, step, dev_data
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return res


def mesh_phase(data_root, dev) -> dict:
    """stl10 at its published widths on a mesh of 2 gloo ranks on the one
    card (gloo stages its all-reduces through the host; NCCL refuses two
    ranks on one device), on a seeded synthetic STL-10 in ``prepare``'s
    layout (``MESH_TRAIN`` / ``MESH_TEST`` images of 96 × 96 × 3): the
    ranks' work is ``mesh_rank``. Gates: (1) the ranks' step equals one
    process's step on the global batch from the same seeded state
    (``states_agree``: parameters, batch-norm statistics and Adam moments;
    metrics within 1e-4·(1 + |m|)); (2) the stochastic steps finite, each
    rank's launches ``MESH_STEPS`` × step_launches at its batch of 64, key
    for key; (3) the driver's files written once, by the coordinator (one
    ``metrics.jsonl`` with each record once, ``config.json``, grids and
    checkpoints at 4 and 8); the step-4 checkpoint restored on one process
    bitwise equal to the state the ranks saved, and continued there to
    step 8 within ``states_agree`` of the ranks' resumed run; (4) the STOP
    file stops both ranks at step 2, preempted, checkpointed; and in every
    part the two ranks' states bitwise equal. Then ``nccl_chunk``."""
    import shutil

    import torch

    from triplegan_tpu_torch.ckpt.manager import CheckpointManager
    from triplegan_tpu_torch.configs import make_networks
    from triplegan_tpu_torch.data.datasets import load_dataset
    from triplegan_tpu_torch.data.pipeline import BatchSampler
    from triplegan_tpu_torch.parallel.mesh import run_local_ranks
    from triplegan_tpu_torch.train import loop
    from triplegan_tpu_torch.train.schedule import make_optimizers
    from triplegan_tpu_torch.train.state import create_state

    t_start = time.perf_counter()
    # the shards phase 2b's `cli prepare --dataset stl10` made
    data_dir, workdir = os.path.join(data_root, "stl10_data"), os.path.join(data_root, "mesh_runs")
    data = load_dataset(data_dir, "stl10", MESH_NUM_LABELED, 10, SEED)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r0, r1 = run_local_ranks(mesh_rank, MESH_WORLD, str(dev), backend="gloo", tmpdir=data_root,
                             args=({"data_dir": data_dir, "workdir": workdir},), timeout=900)
    ranks_s = time.perf_counter() - t0
    for part, key in (("equiv", "digest"), ("stochastic", "digest"), ("stop", "digest")):
        check(r0[part][key] == r1[part][key], f"mesh: the ranks' states differ after {part}")
    for a, b in zip(r0["loop"]["runs"], r1["loop"]["runs"]):
        check(a == b, f"mesh driver: the ranks returned {a} and {b}")
    check(r0["loop"]["saved"] == r1["loop"]["saved"], "mesh driver: the ranks saved other states")
    for part in ("equiv", "stochastic"):
        check(r0[part]["counts"] == r1[part]["counts"], f"mesh {part}: the ranks launched other kernels")
    for name, c0 in r0["loop"]["counts"].items():  # the coordinator alone draws the grids (100 rows)
        c0, c1 = collections.Counter(c0), collections.Counter(r1["loop"]["counts"][name])
        rows = [key[0][0] if name.startswith("scale_bias_act") else key[1] for key in c0 - c1]
        check(not c1 - c0 and set(rows) <= {100}, f"mesh driver: the ranks' {name} launches differ "
                                                   f"beyond the coordinator's grids: {dict(c0 - c1)}, {dict(c1 - c0)}")

    # (1) the ranks' step against one process's on the global batch
    cfg = stl10_cfg(deterministic=True)
    lr = float(cfg.lr_c)
    batch = BatchSampler(data, cfg.batch_size, seed=SEED).next_triple(cfg.z_dim, cfg.num_classes)
    single, single_m, single_counts = single_step(cfg, dev, batch)
    equiv = {"state": states_agree(r0["equiv"]["flat"], state_flat(single), 1, lr, "mesh vs one process"),
             "metrics_max_rel_diff": metrics_within(r0["equiv"]["metrics"], single_m, "mesh vs one process"),
             "ranks_bitwise_equal": True}
    del single

    # (2) the stochastic path: finite, and step_launches at a rank's batch
    cfg = stl10_cfg()
    st = r0["stochastic"]
    for t, m in enumerate(st["metrics"]):
        check(all(math.isfinite(v) for v in m.values()), f"mesh stochastic step {t}: {m}")
    counts = {k: collections.Counter(v) for k, v in st["counts"].items()}
    check_step_launches(per_rank(cfg), counts, MESH_STEPS, "mesh rank")
    players = step_launches(per_rank(cfg))[1]

    # (3) the driver: the coordinator's files, a restore and a continuation on one process
    run_dir = os.path.join(workdir, "loop")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    keys = [(r["step"], tuple(sorted(r))) for r in recs]
    check(len(keys) == len(set(keys)), "mesh driver: metrics.jsonl holds a record twice (a second writer)")
    check([r["step"] for r in recs if "loss_d" in r] == [4, 8] and
          [r["step"] for r in recs if "test_error" in r] == [4, 8], f"mesh driver: records at {keys}")
    names = sorted(os.listdir(run_dir))
    check(names == ["ckpt", "config.json", "metrics.jsonl", "samples_00000004.png", "samples_00000008.png"] or
          names == ["ckpt", "config.json", "metrics.jsonl", "samples_00000004.png", "samples_00000008.png", "tb"],
          f"mesh driver: the run dir holds {names}")
    check(sorted(os.listdir(os.path.join(run_dir, "ckpt"))) == ["4", "8"], "mesh driver: checkpoints")
    side = 10 * cfg.image_size  # 10 classes × 10 samples of 96 × 96
    check(png_size(os.path.join(run_dir, "samples_00000008.png"))[:2] == (side, side), "mesh driver: grid size")
    first, second = r0["loop"]["runs"]
    check((first["steps"], second["steps"]) == (4, 8) and not first["preempted"] and not second["preempted"],
          f"mesh driver: runs {first} {second}")
    check(r0["loop"]["saved"][4] == first["digest"] and r0["loop"]["saved"][8] == second["digest"],
          "mesh driver: the saved states are not the runs' states")
    lcfg = mesh_loop_cfg(workdir, data_dir, "continued", 4, 2, mesh=1)
    nets = make_networks(lcfg)
    template = create_state(lcfg, nets, make_optimizers(lcfg, 8), device=dev)
    restored = CheckpointManager(os.path.join(run_dir, "ckpt"), write=False).restore(template, step=4)
    check(state_hash(restored) == r0["loop"]["saved"][4],
          "mesh driver: the step-4 checkpoint restored on one process differs from the state the ranks saved")
    del restored, template
    os.makedirs(os.path.join(workdir, "continued", "ckpt"))
    shutil.copy(os.path.join(run_dir, "ckpt", "4"), os.path.join(workdir, "continued", "ckpt", "4"))
    counts_zero()  # the main path starts here
    t0 = time.perf_counter()
    cont = loop.train(lcfg, verbose=False, device=dev)
    cont_s = time.perf_counter() - t0
    cont_counts = counts_read()  # the main path ends here
    check(cont["steps"] == 8 and not cont["preempted"], f"mesh continuation: {cont['steps']} steps")
    continued = states_agree(r0["loop"]["flat"], state_flat(cont["state"]), 4, lr,
                             "the mesh's resumed run vs one process's continuation")
    del cont

    # (4) the stop
    check(r0["stop"]["preempted"] and r1["stop"]["preempted"] and r0["stop"]["steps"] == r1["stop"]["steps"] == 2,
          f"mesh stop: {r0['stop']} {r1['stop']}")
    check(sorted(os.listdir(os.path.join(workdir, "stop", "ckpt"))) == ["2"], "mesh stop: its checkpoints")

    nccl = nccl_chunk(data, data_root, dev)
    emit("mesh_nccl", public(nccl))

    res = {"config": "stl10", "world": MESH_WORLD, "backend": "gloo", "device": f"{dev} (both ranks)",
           "global_batch": cfg.batch_size, "rank_batch": cfg.batch_size // MESH_WORLD,
           "equivalence": equiv, "continuation": continued, "rank_peak_mem_gb": st["peak_mem_gb"],
           "driver_seconds": r0["loop"]["seconds"], "continuation_seconds": cont_s, "ranks_seconds": ranks_s,
           "stop": r0["stop"]["steps"], "test_error": [r["test_error"] for r in r0["loop"]["runs"]],
           "nccl": public(nccl), "seconds": time.perf_counter() - t_start}
    c = lambda d: {k: collections.Counter(v) for k, v in d.items()}  # noqa: E731
    rank_counts = {name: c(r[part]["counts"]) for name, r, part in
                   (("rank0 equiv", r0, "equiv"), ("rank1 equiv", r1, "equiv"), ("rank0 stochastic", r0, "stochastic"),
                    ("rank1 stochastic", r1, "stochastic"), ("rank0 driver", r0, "loop"), ("rank1 driver", r1, "loop"))}
    counted = collections.Counter()
    for counts_ in list(rank_counts.values()) + [single_counts, cont_counts]:
        counted.update(totals(counts_))
    res["launches_counted"] = dict(counted + collections.Counter(nccl["launches_counted"]))
    res["launches_replayed"] = nccl["launches_replayed"]
    res["launches"] = {k: res["launches_counted"].get(k, 0) + res["launches_replayed"].get(k, 0)
                       for k in nccl["launches"]}
    per_step = {name: {key: n / MESH_STEPS for key, n in cnt.items()}
                for name, cnt in rank_counts["rank0 stochastic"].items()}
    res["_sources"] = [("train mesh_rank", per_step, players),
                       ("mesh single step", single_counts, {}),
                       ("mesh driver rank", rank_counts["rank0 driver"], {}),
                       ("mesh continuation", cont_counts, {}),
                       ("mesh nccl", nccl["_counts"], {})]
    emit("mesh", public(res))
    return res


# ---------------------------------------------------------------------------
# phase 6: serving end to end
# ---------------------------------------------------------------------------


def seeded_jax_export(nets, seed: int) -> dict:
    """Every weight and batch-norm statistic of the port's Generator and
    Classifier drawn from ``seed`` at scales that keep activations O(1)
    through the full-width stack (He-normal kernels; gains, biases and
    statistics near their identities), in the JAX package's flat npz
    export layout."""
    import torch

    from triplegan_tpu_torch import bridge

    g = torch.Generator().manual_seed(seed)
    state = {}
    for player, net in (("gen", nets[0]), ("clf", nets[2])):
        sd = {}
        for key, t in net.state_dict().items():
            name = key.split(".")[1]
            if name in ("w", "v"):
                if t.dim() == 4 and player == "gen":   # (k, k, in, out), stride-2 deconv
                    fan_in = t.shape[0] * t.shape[1] * t.shape[2] / 4
                elif t.dim() == 4:                      # OIHW conv
                    fan_in = t.shape[1] * t.shape[2] * t.shape[3]
                else:                                   # (in, out) dense
                    fan_in = t.shape[0]
                sd[key] = torch.randn(t.shape, generator=g) * (2.0 / fan_in) ** 0.5
            elif name in ("g", "scale"):
                sd[key] = 0.8 + 0.4 * torch.rand(t.shape, generator=g)
            elif name == "var":
                sd[key] = 0.5 + torch.rand(t.shape, generator=g)
            else:  # b, bias, mean
                sd[key] = 0.1 * torch.randn(t.shape, generator=g)
        state[player] = sd
    params, bn = bridge.to_jax(state)
    flat = {}
    for kind, tree in (("params", params), ("bn", bn)):
        for player, layers in tree.items():
            for layer, arrays in layers.items():
                for name, a in arrays.items():
                    flat[f"{kind}/{player}/{layer}/{name}"] = a
    return flat


def seeded_zca(d: int, seed: int):
    from triplegan_tpu_torch.data.zca import ZCAStats

    rng = np.random.RandomState(seed)
    a = rng.normal(size=(d, d)).astype(np.float32) * (0.1 / d ** 0.5)
    return ZCAStats(mean=(rng.normal(size=d) * 0.05).astype(np.float32),
                    whiten=(np.eye(d, dtype=np.float32) + (a + a.T) / 2))


def http(method: str, url: str, body: bytes = None, ctype: str = None):
    req = urllib.request.Request(url, data=body, method=method,
                                 headers={"Content-Type": ctype} if ctype else {})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.read()


def load_npy(body: bytes) -> np.ndarray:
    return np.load(io.BytesIO(body), allow_pickle=False)


def npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def start_arm(cfg, state, zca, images) -> dict:
    """Start one server for one (compute dtype, use_pallas) arm and drive
    the main path through it: /healthz, /classify, /generate twice,
    /metrics, with the kernels' launch counts set to 0 just before and
    read just after. The server keeps running until ``stop_arm``."""
    from triplegan_tpu_torch.configs import make_networks
    from triplegan_tpu_torch.serve import app_from_state, make_server

    app = app_from_state(cfg, make_networks(cfg), state, zca_stats=zca, batch_size=BATCH,
                         device="cuda", meta={"config": cfg.name})
    server = make_server(app, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://127.0.0.1:%d" % server.server_address[1]
    arm = {"dtype": cfg.compute_dtype, "use_pallas": bool(cfg.use_pallas),
           "_app": app, "_server": server, "_thread": thread, "_base": base}
    chunks = -(-N_REQ // BATCH)

    counts_zero()  # the main path starts here
    status, body = http("GET", base + "/healthz")
    health = json.loads(body)
    check(status == 200 and health["status"] == "ok" and health["backend"] == "cuda",
          f"/healthz: {health}")
    status, body = http("POST", base + "/classify", npy(images), "application/x-npy")
    logits = load_npy(body)
    n_classify = totals(counts_read())
    status, body = http("POST", base + "/generate",
                        json.dumps({"n": N_REQ, "seed": 3}).encode(), "application/json")
    imgs = load_npy(body)
    n_generate = {k: v - n_classify[k] for k, v in totals(counts_read()).items()}
    status, body = http("POST", base + "/generate",
                        json.dumps({"n": N_REQ, "seed": 3, "pixels": True}).encode(),
                        "application/json")
    pixels = load_npy(body)
    status, body = http("GET", base + "/metrics")
    metrics = body.decode()
    arm["_counts"] = counts_read()  # the main path ends here
    arm["launches"] = totals(arm["_counts"])

    check(logits.shape == (N_REQ, cfg.num_classes) and logits.dtype == np.float32,
          f"/classify gave {logits.shape} {logits.dtype}")
    check(bool(np.isfinite(logits).all()), "/classify gave non-finite logits")
    shape = (N_REQ, cfg.image_size, cfg.image_size, cfg.channels)
    check(imgs.shape == shape and imgs.dtype == np.float32, f"/generate gave {imgs.shape} {imgs.dtype}")
    check(bool(np.isfinite(imgs).all()) and float(np.abs(imgs).max()) <= 1.0,
          "/generate gave values outside [-1, 1]")
    check(pixels.shape == shape and pixels.dtype == np.uint8, f"/generate pixels gave {pixels.dtype}")
    expect = np.clip((imgs + 1.0) * 127.5, 0, 255).astype(np.uint8)
    check(bool((pixels == expect).all()), "pixels disagree with the [-1, 1] images")
    check('triplegan_requests_total{endpoint="classify"} 1' in metrics
          and 'triplegan_requests_total{endpoint="generate"} 2' in metrics, "/metrics counters")
    if cfg.use_pallas:
        want_c = {"scale_bias_act": 9 * chunks, "scale_bias_act_bwd": 0, "conv3x3_fwd": 7 * chunks,
                  "conv3x3_wgrad": 0}
        want_g = {"scale_bias_act": 4 * chunks, "scale_bias_act_bwd": 0, "conv3x3_fwd": 3 * chunks,
                  "conv3x3_wgrad": 0}
        check(n_classify == want_c, f"classify launched {n_classify}, want {want_c}")
        check(n_generate == want_g, f"generate launched {n_generate}, want {want_g}")
        want = {k: want_c[k] + 2 * want_g[k] for k in want_c}
        check(arm["launches"] == want, f"serving main path launched {arm['launches']}, want {want}")
    else:
        check(not any(arm["launches"].values()), f"the plain arm launched {arm['launches']}")
    arm["_logits"], arm["_imgs"] = logits, imgs
    return arm


def stop_arm(arm):
    arm["_server"].shutdown()
    arm["_server"].server_close()
    arm["_thread"].join(timeout=30)
    check(not arm["_thread"].is_alive(), "server thread did not stop")


def cpu_reference(cfg, state, zca, images, z, y):
    """The plain path on the CPU (float32, use_pallas off) on a few inputs."""
    import torch

    from triplegan_tpu_torch.configs import make_networks
    from triplegan_tpu_torch.export import make_serving_fns

    classify, generate = make_serving_fns(cfg, make_networks(cfg), state, zca_stats=zca, device="cpu")
    return (classify(torch.from_numpy(images)).numpy(),
            generate(torch.from_numpy(z), torch.from_numpy(y)).numpy())


def serve_phase() -> list:
    from triplegan_tpu_torch import bridge
    from triplegan_tpu_torch.configs import get_config, make_networks

    cfg0 = get_config("cifar10_4k")
    d = cfg0.image_size * cfg0.image_size * cfg0.channels
    zca = seeded_zca(d, SEED)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "params.npz")
        np.savez(path, **seeded_jax_export(make_networks(cfg0), SEED))
        state = bridge.load_npz(path)
    images = np.random.RandomState(SEED).randint(
        0, 256, size=(N_REQ, cfg0.image_size, cfg0.image_size, cfg0.channels), dtype=np.uint8)
    z = np.random.RandomState(3).normal(size=(N_REQ, cfg0.z_dim)).astype(np.float32)
    y = (np.arange(N_REQ) % cfg0.num_classes).astype(np.int32)

    arms = {}
    try:
        for dtype in ("float32", "bfloat16"):
            for use_pallas in (True, False):
                cfg = get_config("cifar10_4k")
                cfg.compute_dtype, cfg.use_pallas = dtype, use_pallas
                arms[dtype, use_pallas] = start_arm(cfg, state, zca, images)
    finally:
        for arm in arms.values():
            stop_arm(arm)
    for arm in arms.values():
        emit("serve", public(arm))

    for dtype in ("float32", "bfloat16"):
        k, p = arms[dtype, True], arms[dtype, False]
        scale = float(np.abs(p["_logits"]).max())
        dl = float(np.abs(k["_logits"] - p["_logits"]).max())
        di = float(np.abs(k["_imgs"] - p["_imgs"]).max())
        lim = 1e-4 * (1.0 + scale) if dtype == "float32" else 16 * 2.0 ** -8 * scale
        emit("arms_agree", {"dtype": dtype, "max_logit": scale, "logits_max_abs_diff": dl,
                            "logits_limit": lim, "images_max_abs_diff": di, "images_limit": 1e-4})
        check(dl <= lim, f"{dtype}: kernel and plain arms' logits differ by {dl} > {lim}")
        check(di <= 1e-4, f"{dtype}: kernel and plain arms' images differ by {di}")

    cfg = get_config("cifar10_4k")
    cfg.use_pallas = False
    n = 4
    ref_logits, ref_imgs = cpu_reference(cfg, state, zca, images[:n], z[:n], y[:n])
    card = arms["float32", True]
    for name, got, ref in (("logits", card["_logits"][:n], ref_logits), ("images", card["_imgs"][:n], ref_imgs)):
        diff = float(np.abs(got - ref).max())
        lim = 1e-3 * (1.0 + float(np.abs(ref).max()))
        emit("card_vs_cpu", {"what": name, "max_abs_diff": diff, "limit": lim})
        check(diff <= lim, f"card and CPU {name} differ by {diff} > {lim}")
    return list(arms.values())


# ---------------------------------------------------------------------------
# phase 7: each kernel against its plain version at the paths' shapes
# ---------------------------------------------------------------------------


def conv_case(op, n, h, w, cin, cout, pad, dtype, gen, flush, reps):
    """Check and time one conv kernel call against its plain version and
    the library call that computes the same function. A float32 forward
    that ``f32_wino_plan`` sends through the Winograd pipeline is held to
    the pipeline's plain twin (``winograd_nopad``) and to the plain direct
    conv within the Winograd bounds, and timed beside its own bound (the
    16 products' operations, or the pipeline's bytes: x, V and M each
    written and read, U, y) and beside the forward kernel
    (``conv3x3_direct``)."""
    import torch
    import torch.nn.functional as F

    from triplegan_tpu_torch.ops import conv3x3 as cv
    from triplegan_tpu_torch.ops.winograd import winograd_magnitude, winograd_nopad

    dev = torch.device("cuda")
    x = torch.randn((n, h, w, cin), generator=gen, device=dev).to(dtype)
    ho, wo = h + 2 * pad - 2, w + 2 * pad - 2
    if op == "wgrad":
        g = torch.randn((n, ho, wo, cout), generator=gen, device=dev).to(dtype)
        xp = cv._pad_hw(x, pad)
        run = lambda: cv.conv3x3_wgrad(x, g, pad)  # noqa: E731
        plain = lambda: cv.reference_conv3x3_wgrad(xp, g)  # noqa: E731
        abs_ref = cv.reference_conv3x3_wgrad(xp.abs(), g.abs())
        xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        library = lambda: torch.nn.grad.conv2d_weight(xc, (cout, cin, 3, 3), gc, padding=pad)  # noqa: E731
        k_len = n * ho * wo
        flops = 2.0 * n * ho * wo * 9 * cin * cout
        nbytes = (x.numel() + g.numel()) * x.element_size() + 9 * cin * cout * 4
    else:
        wt = (torch.randn((3, 3, cin, cout), generator=gen, device=dev) / math.sqrt(9 * cin)).to(dtype)
        xp = cv._pad_hw(x, pad)
        run = lambda: cv.conv3x3_nopad(x, wt, pad)  # noqa: E731
        plain = lambda: cv.reference_conv3x3_nopad(xp, wt)  # noqa: E731
        abs_ref = cv.reference_conv3x3_nopad(xp.abs(), wt.abs()).float()
        xc = x.permute(0, 3, 1, 2)
        if op == "fwd":
            wc = wt.permute(3, 2, 0, 1)
            library = lambda: F.conv2d(xc, wc, padding=pad)  # noqa: E731
        else:  # the input gradient of a conv with the unflipped kernel and halo 2 - pad
            w_fwd = wt.flip((0, 1)).transpose(2, 3).permute(3, 2, 0, 1).contiguous()
            size = (n, cout, ho, wo)
            library = lambda: torch.nn.grad.conv2d_input(size, w_fwd, xc, padding=2 - pad)  # noqa: E731
        k_len = 9 * cin
        flops = 2.0 * n * ho * wo * 9 * cin * cout
        nbytes = (x.numel() + wt.numel() + n * ho * wo * cout) * x.element_size()
    wino = cv.f32_wino_plan(n, ho, wo, cin, cout) if op != "wgrad" and dtype == torch.float32 else None
    got = run()
    torch.cuda.synchronize()
    want = plain()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"conv3x3 {op} {(n, h, w, cin, cout, pad)}: {tuple(got.shape)} {got.dtype}")
    err = (got.double() - want.double()).abs()
    if wino is None:
        lim = 8.0 * math.sqrt(k_len) * 2.0 ** -24 * abs_ref.double()
    else:  # n_w = Cin + 32 additions in a Winograd output's chain, M its terms' magnitudes
        n_w, mag = cin + 32, winograd_magnitude(x, wt, pad).double()
        lim = (n_w + 9 * cin) * 2.0 ** -24 * mag
        twin_err = (got.double() - winograd_nopad(x, wt, pad).double()).abs()
        twin_lim = 2 * n_w * 2.0 ** -24 * mag
    if got.dtype == torch.bfloat16:
        lim = lim + bf16_ulp(torch.maximum(got.abs(), want.abs()))
    case = f"conv3x3 {op} {(n, h, w, cin, cout, pad)} {dtype}"
    ins = {"x": x, "g": g} if op == "wgrad" else {"x": x, "w": wt}
    check(bool(torch.isfinite(got).all()), f"conv3x3 {op}: non-finite output")
    if not bool((err <= lim).all()):
        fail(f"{case}: max err {float(err.max())} exceeds tolerance (worst excess {float((err - lim).max())}); "
             f"the call's tensors: {save_failing(f'conv3x3_{op}', **ins, got=got, want=want)}")
    if wino is not None and not bool((twin_err <= twin_lim).all()):
        fail(f"{case}: Winograd pipeline against its plain twin: max err {float(twin_err.max())} exceeds "
             f"tolerance; the call's tensors: {save_failing(f'conv3x3_{op}', **ins, got=got, want=want)}")
    max_err = float(err.max())
    wino_row = {}
    if wino is not None:
        _, tiles, ws = wino
        t_ops = 2.0 * 16 * tiles * cin * cout / F32_FLOPS_PER_S * 1e3
        v_m = ws - 16 * cin * -(-cout // 4) * 4  # V and M, each written once and read once
        t_bytes = (x.numel() + wt.numel() + n * ho * wo * cout + 2 * v_m) * 4 / HBM_BYTES_PER_S * 1e3
        wino_row = {"path": "winograd", "max_err_share": float((err / lim).max()),
                    "twin_err_share": float((twin_err / twin_lim).max()),
                    "wino_bound_ms": max(t_ops, t_bytes), "wino_bound_by": "operations" if t_ops >= t_bytes else "bytes",
                    "products_ms_at_peak": t_ops, "bytes_ms_at_peak": t_bytes}
        del twin_err, twin_lim, mag
    if dtype == torch.float32:  # a fixed summation order: every call gives the first call's bits
        for rep in range(CONV_REPEATS):
            again = run()
            if not torch.equal(again, got):
                fail(f"{case}: call {rep + 2} differs from the first at {int((again != got).sum())} elements; "
                     f"the calls' tensors: {save_failing(f'conv3x3_{op}', **ins, got=got, again=again, want=want)}")
    del abs_ref, err, lim, got, want
    tk = time_ms(run, flush, reps=reps, warm=2)
    tp = time_ms(plain, flush, reps=reps, warm=2)
    tl = time_ms(library, flush, reps=reps, warm=2)
    if wino is not None:
        wino_row["direct_ms"] = time_ms(lambda: cv.conv3x3_direct(x, wt, pad), flush, reps=reps, warm=2)["cold"]
    peak = F32_FLOPS_PER_S if dtype == torch.float32 else BF16_FLOPS_PER_S
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {"ms": tk["cold"], "plain_ms": tp["cold"], "library_ms": tl["cold"],
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "gflop": flops / 1e9, "tflop_s": flops / (tk["cold"] * 1e9),
            "max_abs_err": max_err, "path": "direct", **wino_row}


def tconv_case(n, h, w, cin, cout, gen, flush, reps) -> dict:
    """Check and time one call of the stride-2 transposed conv kernel
    (``tconv3x3_s2``, float32, x (n, h, w, cin) → (n, 2h + 1, 2w + 1,
    cout)): against its plain twin (``F.conv_transpose2d``) in float64 on
    the card within 8·sqrt(4·cin)·2⁻²⁴ of the twin on magnitudes (an output
    sums at most 4·cin products), and every repeat bitwise equal to the
    first call; timed beside its bound (the direct conv's operations,
    2·9·cin·cout a low-resolution pixel, at the float32 peak, or its bytes,
    x, w and y once each), the plain twin in float32 and the same call
    under ``cudnn.deterministic`` (``library_ms``: the algorithm the
    training step took before the kernel)."""
    import torch

    from triplegan_tpu_torch.ops import conv3x3 as cv

    dev = torch.device("cuda")
    x = torch.randn((n, h, w, cin), generator=gen, device=dev)
    wt = torch.randn((3, 3, cin, cout), generator=gen, device=dev) / math.sqrt(9 * cin)
    run = lambda: cv.tconv3x3_s2(x, wt)  # noqa: E731
    plain = lambda: cv.reference_tconv3x3_s2(x, wt)  # noqa: E731
    got = run()
    torch.cuda.synchronize()
    want = cv.reference_tconv3x3_s2(x.double(), wt.double())
    lim = 8.0 * math.sqrt(4 * cin) * 2.0 ** -24 * cv.reference_tconv3x3_s2(x.double().abs(), wt.double().abs())
    case = f"tconv3x3_s2 {(n, h, w, cin, cout)}"
    check(got.shape == want.shape and bool(torch.isfinite(got).all()), f"{case}: {tuple(got.shape)}, non-finite")
    err = (got.double() - want).abs()
    if not bool((err <= lim).all()):
        fail(f"{case}: max err {float(err.max())} exceeds tolerance (worst excess {float((err - lim).max())}); "
             f"the call's tensors: {save_failing('tconv3x3_s2', x=x, w=wt, got=got)}")
    max_err, share = float(err.max()), float((err / lim).max())
    for rep in range(CONV_REPEATS):
        again = run()
        if not torch.equal(again, got):
            fail(f"{case}: call {rep + 2} differs from the first at {int((again != got).sum())} elements; "
                 f"the calls' tensors: {save_failing('tconv3x3_s2', x=x, w=wt, got=got, again=again)}")
    del want, lim, err, got
    tk = time_ms(run, flush, reps=reps, warm=2)
    tp = time_ms(plain, flush, reps=reps, warm=2)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        tl = time_ms(plain, flush, reps=reps, warm=2)
    finally:
        torch.backends.cudnn.deterministic = det
    flops = 2.0 * n * h * w * 9 * cin * cout
    nbytes = (x.numel() + wt.numel() + n * (2 * h + 1) * (2 * w + 1) * cout) * 4
    t_ops, t_bytes = flops / F32_FLOPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {"ms": tk["cold"], "warm_ms": tk["warm"], "plain_ms": tp["cold"], "library_ms": tl["cold"],
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "gflop": flops / 1e9, "tflop_s": flops / (tk["cold"] * 1e9), "block_n": cv.tconv_plan(n, h, w, cin, cout),
            "max_abs_err": max_err, "max_err_share": share}


def sba_case(shape, dtype, act, slope, gen, flush, per_sample=False) -> dict:
    """Check and time one scale_bias_act kernel call against its plain
    version on seeded inputs of the given shape; ``per_sample``: the
    class-conditional epilogue ``scale_bias_act_cond``, k and b (N, C)."""
    import torch

    from triplegan_tpu_torch.ops import scale_bias_act as sba

    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    c = shape[-1]
    kb = (shape[0], c) if per_sample else (c,)
    fn, plain = ((sba.scale_bias_act_cond, sba.reference_scale_bias_act_cond) if per_sample
                 else (sba.scale_bias_act, sba.reference_scale_bias_act))
    # k and b in x's dtype, as the layers pass them
    x = (torch.randn(shape, generator=gen, device=dev) * 2.0).to(dt)
    k = (torch.randn(kb, generator=gen, device=dev) * 0.5 + 1.0).to(dt)
    b = (torch.randn(kb, generator=gen, device=dev) * 0.3).to(dt)
    got = fn(x, k, b, act, slope)
    torch.cuda.synchronize()
    want = plain(x, k, b, act, slope)
    check(got.dtype == dt and got.shape == x.shape, f"{fn.__name__} output {got.dtype} {tuple(got.shape)}")
    err, excess = max_excess(got, want, dt)
    check(excess <= 0, f"{fn.__name__} {act} {slope} {shape} {dtype}: max err {err} exceeds tolerance")
    tk = time_ms(lambda: fn(x, k, b, act, slope), flush, reps=SBA_REPS)
    tp = time_ms(lambda: plain(x, k, b, act, slope), flush, reps=SBA_REPS)
    esize = x.element_size()
    nbytes = 2 * x.numel() * esize + 2 * k.numel() * esize  # x read, y written, k and b read
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * x.numel() / F32_FLOPS_PER_S * 1e3  # mul, add, activation
    return {"max_abs_err": err, "ms": tk["cold"], "p10_ms": tk["p10"], "p90_ms": tk["p90"],
            "warm_ms": tk["warm"], "plain_ms": tp["cold"], "plain_warm_ms": tp["warm"],
            "library_ms": None, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def moments_case(shape, dtype, gen, flush) -> dict:
    """The batch-norm moments' kernels at one shape, cold: the forward pair
    (``bnm_fwd_rows`` and ``bnm_reduce``, float64 sums) against the float64
    twin within its rounding to float32, 2⁻²⁴ of the value, plus
    γ_{n+1}·Σ|terms|/M at u = 2⁻⁵³ (n the kernels' summation depth, one
    more for the division), the backward (``bnm_bwd_rows``) against the
    closed form in float64 within 4 float32 roundings of its two terms; each
    timed against its bytes ÷ 3.35 TB/s (the forward reads x, the backward
    reads x and writes dx) and against the plain twin (its forward;
    autograd's backward of it)."""
    import torch

    from triplegan_tpu_torch.ops import scale_bias_act as sba

    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    c = shape[-1]
    m = math.prod(shape) // c
    x = (torch.randn(shape, generator=gen, device=dev) * 1.5 + 0.3).to(dt)
    dm, dq = (torch.randn(c, generator=gen, device=dev) for _ in range(2))
    got = sba._moments_forward(x)
    dx = sba._moments_backward(x, dm, dq)
    torch.cuda.synchronize()
    u, depth = 2.0 ** -24, sba.moments_plan(m, c, dt)[1]
    xd = x.double().reshape(m, c)
    want = sba.reference_bn_moments(xd)
    share = 0.0
    for g, w, terms in zip(got, want, (xd.abs(), xd * xd)):
        n = (depth + 1) * 2.0 ** -53
        lim = n / (1 - n) * terms.sum(0) / m + u * w.abs()
        share = max(share, float(((g.double() - w).abs() / lim).max()))
    check(share <= 1.0, f"bn_moments {shape} {dtype}: the sums take {share} of their limit")
    want_dx = sba.reference_bn_moments_bwd(x.double(), dm.double(), dq.double())
    lim = 4 * u * (dm.double().abs() / m + (2 * x.double() * dq.double() / m).abs())
    if dt == torch.bfloat16:
        lim = lim + bf16_ulp(want_dx)
    dx_share = float(((dx.double() - want_dx).abs() / lim.clamp_min(1e-300)).max())
    check(dx_share <= 1.0, f"bn_moments backward {shape} {dtype}: dx takes {dx_share} of its limit")
    del xd, want, want_dx
    xr = x.clone().requires_grad_(True)
    outs = sba.reference_bn_moments(xr)
    tf = time_ms(lambda: sba._moments_forward(x), flush, reps=SBA_REPS)
    tb = time_ms(lambda: sba._moments_backward(x, dm, dq), flush, reps=SBA_REPS)
    pf = time_ms(lambda: sba.reference_bn_moments(x), flush, reps=SBA_REPS)
    pb = time_ms(lambda: torch.autograd.grad(outs, xr, (dm, dq), retain_graph=True), flush, reps=SBA_REPS)
    nbytes = x.numel() * x.element_size()
    return {"sum_limit_share": share, "dx_limit_share": dx_share, "depth": depth,
            "blocks": sba.moments_plan(m, c, dt)[0],
            "fwd_ms": tf["cold"], "fwd_p10_ms": tf["p10"], "fwd_p90_ms": tf["p90"], "fwd_warm_ms": tf["warm"],
            "fwd_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "fwd_plain_ms": pf["cold"],
            "bwd_ms": tb["cold"], "bwd_p10_ms": tb["p10"], "bwd_p90_ms": tb["p90"], "bwd_warm_ms": tb["warm"],
            "bwd_bound_ms": 2 * nbytes / HBM_BYTES_PER_S * 1e3, "bwd_plain_ms": pb["cold"], "bound_by": "bytes"}


def bwd_sums_excess(got, terms, depth) -> tuple:
    """A backward's channel sums ``got`` (C,) against the exact (float64)
    sums of their terms ``terms`` (M, C), the plain backward's t·x or t:
    (max |got − exact|, the most by which it exceeds its limit, the largest
    share of its limit it takes). The limit is γ_n·Σ|terms|, γ_n = n·u/(1 −
    n·u) with u = 2⁻²⁴ and n = ``depth``, the most float32 additions a term
    goes through in the kernel (its thread's rows, its block's tree, the
    reduce: ``scale_bias_act.bwd_plan``), plus one bfloat16 ulp of the value
    where ``got`` is bfloat16 (the float32 sum rounded once)."""
    import torch

    exact = terms.double().sum(0)
    u = 2.0 ** -24
    lim = depth * u / (1.0 - depth * u) * terms.double().abs().sum(0)
    if got.dtype == torch.bfloat16:
        lim = lim + bf16_ulp(torch.maximum(got.double().abs(), exact.abs()))
    err = (got.double() - exact).abs()
    return float(err.max()), float((err - lim).max()), float((err / lim.clamp_min(1e-300)).max())


def sba_bwd_case(shape, dtype, act, slope, needs, gen, flush, per_sample=False) -> dict:
    """Check and time one call of the scale_bias_act backward kernel
    (computing the gradients ``needs`` names: "x", "k", "b") against the
    plain backward on seeded inputs of the given shape; ``per_sample``: the
    class-conditional epilogue's backward, k and b (N, C), whose dk and db
    are each sample's sums."""
    import torch

    from triplegan_tpu_torch.ops import scale_bias_act as sba

    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    n, c = shape[0], shape[-1]
    kb = (n, c) if per_sample else (c,)
    x = (torch.randn(shape, generator=gen, device=dev) * 2.0).to(dt)
    g = torch.randn(shape, generator=gen, device=dev).to(dt)
    k = (torch.randn(kb, generator=gen, device=dev) * 0.5 + 1.0).to(dt)
    b = (torch.randn(kb, generator=gen, device=dev) * 0.3).to(dt)
    mask = tuple(grad in needs for grad in "xkb")
    flags = sum(1 << i for i, want_it in enumerate(mask) if want_it)
    if per_sample:
        name, hw = "scale_bias_act_cond backward", x.numel() // (n * c)
        run = lambda: sba._cond_backward(x, k, b, g, act, slope, mask)  # noqa: E731
        plain = lambda: sba.reference_scale_bias_act_cond_bwd(x, k, b, g, act, slope, mask)  # noqa: E731
        depth = sba.cond_bwd_plan(n, hw, c, dt, act, flags, True)[1] if flags & 6 else 0
        t = g * sba.act_grad(x * sba._per_sample(k, x) + sba._per_sample(b, x), act, slope)
        # each sample's sums as columns of their own: (rows a sample, N·C)
        cols = lambda v: v.reshape(n, hw, c).permute(1, 0, 2).reshape(hw, n * c)  # noqa: E731
    else:
        name, m = "scale_bias_act backward", x.numel() // c
        run = lambda: sba._backward(x, k, b, g, act, slope, mask)  # noqa: E731
        plain = lambda: sba.reference_scale_bias_act_bwd(x, k, b, g, act, slope, mask)  # noqa: E731
        depth = sba.bwd_plan(m, c, dt, act, flags, True)[1] if flags & 6 else 0
        t = sba.reference_bwd_t(x, k, b, g, act, slope)
        cols = lambda v: v.reshape(m, c)  # noqa: E731
    got = run()
    torch.cuda.synchronize()
    want = plain()
    check(all(v.data_ptr() % 16 == 0 for v in (x, g)), "seeded inputs off 16-byte alignment")
    errs, shares = [], []
    for grad, i, terms in (("dx", 0, None), ("dk", 1, t * x), ("db", 2, t)):
        if not mask[i]:
            check(got[i] is None, f"{name} computed {grad}, not asked for")
            continue
        check(got[i].dtype == dt and got[i].shape == want[i].shape, f"{name} {grad}: {got[i].dtype}")
        if i == 0:  # bitwise, as it rounds where the plain backward does
            e, excess = max_excess(got[i], want[i], dt)
        else:  # against the exact sums of the plain backward's terms
            e, excess, share = bwd_sums_excess(got[i].reshape(-1), cols(terms), depth)
            shares.append(share)
        check(excess <= 0, f"{name} {grad} {act} {slope} {shape} {dtype}: max err {e} "
                           f"exceeds tolerance by {excess}")
        errs.append(float((got[i].double() - want[i].double()).abs().max()))
    del got, want, t
    tk = time_ms(run, flush, reps=SBA_REPS)
    tp = time_ms(plain, flush, reps=SBA_REPS)
    esize = x.element_size()
    # x and g read, dx written where asked, k and b read, dk and db written
    nbytes = (2 + mask[0]) * x.numel() * esize + (2 + mask[1] + mask[2]) * k.numel() * esize
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 10 * x.numel() / F32_FLOPS_PER_S * 1e3  # z, act', t, dx, two sums
    return {"max_abs_err": max(errs), "sum_depth": depth, "sum_err_share": max(shares, default=None),
            "ms": tk["cold"], "p10_ms": tk["p10"], "p90_ms": tk["p90"],
            "warm_ms": tk["warm"], "plain_ms": tp["cold"], "plain_warm_ms": tp["warm"],
            "library_ms": None, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def noise_inputs(shape, gen):
    """Seeded inputs of the modulation epilogue at ``shape``: x (some of
    its outputs past the clamp of 256), a cotangent, k (N, C), b (C,) and
    q of x's shape but the last axis, float32 on the card."""
    import torch

    dev = torch.device("cuda")
    n, c = shape[0], shape[-1]
    x = 64.0 * torch.randn(shape, generator=gen, device=dev)
    g = torch.randn(shape, generator=gen, device=dev)
    k = torch.randn((n, c), generator=gen, device=dev)
    b = torch.randn(c, generator=gen, device=dev)
    q = torch.randn(shape[:-1], generator=gen, device=dev)
    return x, g, k, b, q


def noise_case(shape, act, slope, clamp, gen, flush) -> dict:
    """The modulation epilogue's forward (``mod_fwd_rows``) at one shape
    against its plain twin on the CPU, equal; timed against its bytes (x
    read, y written, k, b and q read) ÷ 3.35 TB/s and against the plain
    twin on the card."""
    import torch

    from triplegan_tpu_torch.ops import scale_bias_act as sba

    x, _, k, b, q = noise_inputs(shape, gen)
    got = sba._noise_forward(x, k, b, q, act, slope, clamp).cpu()
    want = sba.reference_scale_bias_act_noise(x.cpu(), k.cpu(), b.cpu(), q.cpu(), act, slope, clamp)
    equal = bool(torch.equal(got, want))
    check(equal, f"scale_bias_act_noise {act} {shape}: mod_fwd_rows differs from its plain twin")
    tk = time_ms(lambda: sba._noise_forward(x, k, b, q, act, slope, clamp), flush, reps=SBA_REPS)
    tp = time_ms(lambda: sba.reference_scale_bias_act_noise(x, k, b, q, act, slope, clamp), flush, reps=SBA_REPS)
    nbytes = (2 * x.numel() + k.numel() + b.numel() + q.numel()) * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 5 * x.numel() / F32_FLOPS_PER_S * 1e3  # mul, two adds, activation, clamp
    return {"equal": equal, "max_abs_err": float((got - want).abs().max()), "ms": tk["cold"], "p10_ms": tk["p10"],
            "p90_ms": tk["p90"], "warm_ms": tk["warm"], "plain_ms": tp["cold"], "plain_warm_ms": tp["warm"],
            "library_ms": None, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def noise_bwd_case(shape, act, slope, clamp, needs, gen, flush) -> dict:
    """The modulation epilogue's backward (``mod_bwd_rows`` and, for dk or
    db, ``mod_bwd_reduce``) at one shape and the gradients ``needs`` names
    ("x", "k", "b", "q") against its plain twin on the CPU: dx bitwise, the
    sums dk, db, dq within 1e-5 of the largest plain value's magnitude;
    timed against its bytes (x and the cotangent read, dx written, k, b and
    q read, dk, db and dq written where asked) ÷ 3.35 TB/s and against the
    plain twin on the card."""
    import torch

    from triplegan_tpu_torch.ops import scale_bias_act as sba

    x, g, k, b, q = noise_inputs(shape, gen)
    mask = tuple(grad in needs for grad in "xkbq")
    got = [None if t is None else t.cpu() for t in sba._noise_backward(x, k, b, q, g, act, slope, clamp, mask)]
    want = sba.reference_scale_bias_act_noise_bwd(*(t.cpu() for t in (x, k, b, q, g)), act, slope, clamp, mask)
    dx_bitwise = not mask[0] or bool(torch.equal(got[0], want[0]))
    sums_rel = [float((a - w).abs().max() / w.abs().max()) for a, w, m in zip(got[1:], want[1:], mask[1:]) if m]
    check(dx_bitwise and max(sums_rel, default=0.0) <= 1e-5,
          f"scale_bias_act_noise backward {act} {shape} {needs}: dx bitwise {dx_bitwise}, sums {sums_rel}")
    errs = [float((a - w).abs().max()) for a, w, m in zip(got, want, mask) if m]
    del got, want
    run = lambda: sba._noise_backward(x, k, b, q, g, act, slope, clamp, mask)  # noqa: E731
    plain = lambda: sba.reference_scale_bias_act_noise_bwd(x, k, b, q, g, act, slope, clamp, mask)  # noqa: E731
    tk = time_ms(run, flush, reps=SBA_REPS)
    tp = time_ms(plain, flush, reps=SBA_REPS)
    nbytes = ((2 + mask[0]) * x.numel() + (1 + mask[3]) * q.numel() + (1 + mask[1]) * k.numel()
              + (1 + mask[2]) * b.numel()) * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 12 * x.numel() / F32_FLOPS_PER_S * 1e3  # z, act', the mask, t, dx, three sums
    return {"dx_bitwise": dx_bitwise, "sums_rel": sums_rel, "max_abs_err": max(errs, default=0.0),
            "ms": tk["cold"], "p10_ms": tk["p10"], "p90_ms": tk["p90"], "warm_ms": tk["warm"],
            "plain_ms": tp["cold"], "plain_warm_ms": tp["warm"], "library_ms": None, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# the paths of the benchmark's two cells' configurations, and the least share
# of their float32 forward and input-gradient operations a step that the
# Winograd pipeline must take
WINOGRAD_PATHS = ("train shipped", f"train {SNRESNET} float32")
WINOGRAD_SHARE_MIN = 0.98


def winograd_share(sources) -> dict:
    """For each of ``WINOGRAD_PATHS`` among ``sources`` (``path_launches``'s
    (path, per-step counts, players)): the share of one step's float32
    forward and input-gradient operations (the direct conv's count,
    2·n·ho·wo·9·cin·cout a call) whose calls took the Winograd pipeline,
    which must be at least ``WINOGRAD_SHARE_MIN``."""
    out = {}
    for path, counts, _ in sources:
        if path not in WINOGRAD_PATHS:
            continue
        total = wino = 0.0
        for key, c in counts["conv3x3_fwd"].items():
            role, n, h, w, cin, cout, pad, dtype = key
            flops = c * 2.0 * n * (h + 2 * pad - 2) * (w + 2 * pad - 2) * 9 * cin * cout
            total += flops
            wino += flops * takes_winograd(key)
        out[path] = {"gflop_a_step": total / 1e9, "winograd_share": wino / total}
        check(wino / total >= WINOGRAD_SHARE_MIN, f"{path}: the Winograd pipeline took {wino / total:.4f} of the "
                                                  f"forward and input-gradient operations, under {WINOGRAD_SHARE_MIN}")
    check(set(out) == set(WINOGRAD_PATHS), f"winograd_share found the paths {sorted(out)} of {WINOGRAD_PATHS}")
    return out


def path_launches(train_arms, configs, serve_arms, host, mesh, deploy, doctor, digits) -> list:
    """The keyed launch counts of each main path: the doctor's device
    probes (``cli doctor``'s and the cold one: one launch of each kernel at
    each ``doctor.PROBE`` entry each, in their subprocesses), the first
    kernel-arm run
    of each train setting (per step), phase 3c's (each configuration's
    arms, per step; its eval, grid and serving calls; its driver run), the
    host-streamed fused step (per
    step), its ddinit, each layer variant's step, the mesh phase's stl10
    runs (a rank's stochastic step, per step; the one-process step on the
    global batch; a rank's driver runs and the continuation on one
    process, evals and grids included; the NCCL chunk's eager steps,
    warm-up and capture), each serving dtype (over its main path: one
    /classify and two /generate of 250 images), and the deploy phase's
    artifact call pair."""
    sources, seen = [("doctor probe", doctor["_counts"], {})], set()
    for arm in train_arms:
        if arm["use_pallas"] and arm["setting"] not in seen:
            seen.add(arm["setting"])
            per_step = {name: {key: c / arm["steps"] for key, c in counts.items()}
                        for name, counts in arm["_counts"].items()}
            sources.append(("train " + arm["setting"], per_step, arm["_players"]))
    for rec in configs:
        sources += rec["_sources"]
    per_step = {name: {key: c / host["steps"] for key, c in counts.items()}
                for name, counts in host["_counts"].items()}
    sources.append(("train host_fused", per_step, host["_players"]))
    sources.append(("ddinit", host["_dd_counts"], {}))
    for env, counts in host["_variant_counts"]:
        sources.append(("variant " + ",".join(f"{k}={v}" for k, v in env.items()), counts, {}))
    sources += mesh["_sources"]
    for arm in serve_arms:
        if arm["use_pallas"]:
            sources.append(("serve " + arm["dtype"], arm["_counts"], {}))
    sources.append(("deploy artifact", deploy["_counts"], {}))
    sources += digits["_sources"]
    return sources


def kernel_phase(sources, moments_paths) -> tuple:
    """Every kernel against its plain version at each (shape, dtype,
    activation) that a main path launched it at (the epilogue's backward
    also at the gradients it computed there), plus one ragged epilogue (odd
    channel count) in each dtype, forward and backward, per-channel and
    per-sample; and the batch-norm moments' kernels at each (shape, dtype)
    this process launched them at (``MOMENTS_SEEN``) and at the ragged
    shape in each dtype, with their launches in this process and per step
    on the paths ``moments_paths`` gives (setting: (dtype, batch,
    ``moments_read()``, steps)); the modulation epilogue, forward and
    backward, at each shape and set of gradients a main path launched it
    at; the stride-2 transposed conv at each shape a main path launched it
    at (its roles, an up-conv's forward and a stride-2 conv's input
    gradient, at one row)."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.zeros(256 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
    sba_keys = {(RAGGED_SHAPE, dt, "linear", 0.1): {} for dt in ("float32", "bfloat16")}
    bwd_keys = {(RAGGED_SHAPE, dt, "tanh", 0.1, "xkb"): {} for dt in ("float32", "bfloat16")}
    cond_keys = {(RAGGED_SHAPE, dt, "relu", 0.1): {} for dt in ("float32", "bfloat16")}
    cond_bwd_keys = {(RAGGED_SHAPE, dt, "relu", 0.1, "xkb"): {} for dt in ("float32", "bfloat16")}
    noise_keys, noise_bwd_keys, tconv_keys = {}, {}, {}
    conv_keys, players = {}, collections.defaultdict(set)
    for source, counts, where in sources:
        for (role, *shape, dtype), c in counts.get("conv3x3_tconv", {}).items():
            rec = tconv_keys.setdefault(tuple(shape), {})
            rec[source, role] = rec.get((source, role), 0) + c
        for key, c in counts.get("scale_bias_act_noise", {}).items():
            noise_keys.setdefault(key, {})[source] = c
        for key, c in counts.get("scale_bias_act_noise_bwd", {}).items():
            noise_bwd_keys.setdefault(key, {})[source] = c
        for key, c in counts.get("scale_bias_act_cond", {}).items():
            cond_keys.setdefault(key, {})[source] = c
        for key, c in counts.get("scale_bias_act_cond_bwd", {}).items():
            cond_bwd_keys.setdefault(key, {})[source] = c
        for key, c in counts["scale_bias_act"].items():
            sba_keys.setdefault(key, {})[source] = c
        for key, c in counts["scale_bias_act_bwd"].items():
            bwd_keys.setdefault(key, {})[source] = c
        for name in ("conv3x3_fwd", "conv3x3_wgrad"):
            for key, c in counts[name].items():
                conv_keys.setdefault(key, {})[source] = c
                players[key] |= where.get(key, set())
    sba_rows = []
    for (shape, dtype, act, slope), launches in sorted(sba_keys.items()):
        row = {"shape": list(shape), "dtype": dtype, "act": act, "slope": slope, "launches": launches,
               **sba_case(shape, dtype, act, slope, gen, flush)}
        sba_rows.append(row)
        emit("scale_bias_act", row)
    bwd_rows = []
    for (shape, dtype, act, slope, needs), launches in sorted(bwd_keys.items()):
        row = {"shape": list(shape), "dtype": dtype, "act": act, "slope": slope, "needs": needs,
               "launches": launches, **sba_bwd_case(shape, dtype, act, slope, needs, gen, flush)}
        bwd_rows.append(row)
        emit("scale_bias_act_bwd", row)
    cond_rows = []
    for (shape, dtype, act, slope), launches in sorted(cond_keys.items()):
        row = {"shape": list(shape), "dtype": dtype, "act": act, "slope": slope, "launches": launches,
               **sba_case(shape, dtype, act, slope, gen, flush, per_sample=True)}
        cond_rows.append(row)
        emit("scale_bias_act_cond", row)
    cond_bwd_rows = []
    for (shape, dtype, act, slope, needs), launches in sorted(cond_bwd_keys.items()):
        row = {"shape": list(shape), "dtype": dtype, "act": act, "slope": slope, "needs": needs,
               "launches": launches, **sba_bwd_case(shape, dtype, act, slope, needs, gen, flush, per_sample=True)}
        cond_bwd_rows.append(row)
        emit("scale_bias_act_cond_bwd", row)
    noise_rows = []
    for (shape, dtype, act, slope, clamp), launches in sorted(noise_keys.items()):
        row = {"shape": list(shape), "dtype": dtype, "act": act, "slope": slope, "clamp": clamp,
               "launches": launches, **noise_case(shape, act, slope, clamp, gen, flush)}
        noise_rows.append(row)
        emit("scale_bias_act_noise", row)
    noise_bwd_rows = []
    for (shape, dtype, act, slope, clamp, needs), launches in sorted(noise_bwd_keys.items()):
        row = {"shape": list(shape), "dtype": dtype, "act": act, "slope": slope, "clamp": clamp, "needs": needs,
               "launches": launches, **noise_bwd_case(shape, act, slope, clamp, needs, gen, flush)}
        noise_bwd_rows.append(row)
        emit("scale_bias_act_noise_bwd", row)
    conv_rows = []
    for key, launches in sorted(conv_keys.items()):
        op, n, h, w, cin, cout, pad, dtype = key
        row = {"op": op, "input": [n, h, w, cin], "cout": cout, "halo": pad, "dtype": dtype,
               "where": sorted(players[key]), "launches": launches,
               **conv_case(op, n, h, w, cin, cout, pad, getattr(torch, dtype), gen, flush, reps=5)}
        conv_rows.append(row)
        emit("conv3x3", row)
    tconv_rows = []
    for shape, launches in sorted(tconv_keys.items()):
        row = {"input": list(shape[:4]), "cout": shape[4], "dtype": "float32",
               "launches": {f"{src} {role}": c for (src, role), c in sorted(launches.items())},
               **tconv_case(*shape, gen, flush, reps=5)}
        tconv_rows.append(row)
        emit("tconv3x3_s2", row)
    fold_moments()
    seen = MOMENTS_SEEN["bn_moments"] + MOMENTS_SEEN["bn_moments_bwd"]
    moment_rows = []
    for shape, dtype in sorted(set(seen) | {(RAGGED_SHAPE, dt) for dt in ("float32", "bfloat16")}):
        launches = {"this process": [MOMENTS_SEEN["bn_moments"][shape, dtype],
                                     MOMENTS_SEEN["bn_moments_bwd"][shape, dtype]]}
        for path, (_, _, cnt, n) in moments_paths.items():
            if (shape, dtype) in cnt["bn_moments"] + cnt["bn_moments_bwd"]:
                launches["train " + path] = [cnt["bn_moments"][shape, dtype] / n,
                                             cnt["bn_moments_bwd"][shape, dtype] / n]
        row = {"shape": list(shape), "dtype": dtype, "launches_fwd_bwd": launches,
               **moments_case(shape, dtype, gen, flush)}
        moment_rows.append(row)
        emit("bn_moments", row)
    del flush
    return sba_rows, bwd_rows, cond_rows, cond_bwd_rows, noise_rows, noise_bwd_rows, conv_rows, moment_rows, tconv_rows


# ---------------------------------------------------------------------------
# summary
# ---------------------------------------------------------------------------


def summary(sba_rows, bwd_rows, cond_rows, cond_bwd_rows, noise_rows, noise_bwd_rows, conv_rows, moment_rows,
            tconv_rows, train_runs, serve_arms) -> list:
    """One line per kernel: launches over every main path (the train arms,
    the graph arms', phase 3c's, 3e's and the driver's counted runs, the
    serving arms): the
    wrappers' counts (``launches_counted``: each launch, or each capture
    of one into a graph) plus the launches that the replays of those runs
    made, counted by kernel name in their profiles
    (``launches_replayed``); and times and bounds summed over one train
    step's launches at each setting (``per_step``), the shipped setting's
    also at the top level (the per-sample epilogue's: cifar10_snresnet's,
    the modulation epilogue's: cifar10_stylegan2's, the one setting that
    launches each)."""
    counted, replayed = collections.Counter(), collections.Counter()
    for arm in train_runs + serve_arms:
        counted.update(arm.get("launches_counted", arm["launches"]))
        replayed.update(arm.get("launches_replayed", {}))
    csrc = "triplegan_tpu_torch/ops/csrc/"
    conv_src = {"float32": csrc + "conv3x3.cu", "bfloat16": csrc + "conv3x3_sm90.cu"}
    sba_src = {"float32": csrc + "scale_bias_act.cu", "bfloat16": csrc + "scale_bias_act.cu"}
    kernels = []
    sn_setting, sg_setting = f"{SNRESNET} float32", f"{STYLEGAN2} float32"
    for name, rows, sources, replaces, top_setting in (
        ("scale_bias_act", sba_rows, sba_src, "triplegan_tpu/ops/pallas_fused.py:59", "shipped"),
        ("scale_bias_act_bwd", bwd_rows, sba_src, "triplegan_tpu/ops/pallas_fused.py:117", "shipped"),
        ("scale_bias_act_cond", cond_rows, sba_src, None, sn_setting),
        ("scale_bias_act_cond_bwd", cond_bwd_rows, sba_src, None, sn_setting),
        ("scale_bias_act_noise", noise_rows, sba_src, None, sg_setting),
        ("scale_bias_act_noise_bwd", noise_bwd_rows, sba_src, None, sg_setting),
        ("conv3x3_fwd", [r for r in conv_rows if r["op"] != "wgrad"], conv_src,
         "triplegan_tpu/ops/pallas_conv.py:54", "shipped"),
        ("conv3x3_wgrad", [r for r in conv_rows if r["op"] == "wgrad"], conv_src,
         "triplegan_tpu/ops/pallas_conv.py:104", "shipped"),
    ):
        per_step = {}
        for setting, dtype, batch, _ in SETTINGS + [("host_fused", "float32", BATCH, False),
                                                   ("mesh_rank", "float32", 128 // MESH_WORLD, False)] + [
                (f"{name} {dtype}", dtype, batch, False) for name in CONFIGS for dtype, batch, _ in CONFIG_ARMS[name]
        ] + [(sn_setting, "float32", BATCH, False), (sg_setting, "float32", STYLEGAN2_BATCH, False)]:
            runs = [(r["launches"]["train " + setting], r) for r in rows if "train " + setting in r["launches"]]
            sums = {key: sum(n * r[key] for n, r in runs) for key in ("ms", "plain_ms", "bound_ms")}
            library = [n * r["library_ms"] for n, r in runs if r["library_ms"] is not None]
            ops_bound = sum(n * r["bound_ms"] for n, r in runs if r["bound_by"] == "operations")
            per_step[setting] = {
                "dtype": dtype, "batch": batch, "source": sources[dtype],
                "launches": sum(n for n, _ in runs), **sums,
                "max_abs_err": max((r["max_abs_err"] for _, r in runs), default=None),
                "bound_by": "operations" if ops_bound >= sums["bound_ms"] / 2 else "bytes",
                "library_ms": sum(library) if library else None,
            }
        top = per_step[top_setting]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": top["source"],
            "sources": sources,
            "replaces": replaces,
            "launches": counted[name] + replayed[name],
            "launches_counted": counted[name],
            "launches_replayed": replayed[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{key: top[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "basis": f"top level: sum over one train step's launches at the {top_setting} setting "
                     "(shipped: cifar10_4k, float32, batch 100, share_pseudo_forward off); per_step: "
                     "the same at each setting, for the host-streamed fused-classifier step "
                     "(host_fused), for one rank's step of stl10 on a mesh of 2 (mesh_rank: "
                     "96 x 96, batch 64 a rank), for each arm of phase 3c (mnist100, svhn1k, "
                     "cifar10_cond at their published widths: float32 batch 100, bfloat16 batch 384), "
                     "for phase 3e (cifar10_snresnet, float32, batch 100) and for phase 3f "
                     "(cifar10_stylegan2, float32, batch 64)",
            "per_step": per_step,
        })
    kernels.append(moments_summary(moment_rows, replayed))
    kernels.append(tconv_summary(tconv_rows, counted, replayed))
    return kernels


def tconv_summary(rows, counted, replayed) -> dict:
    """The stride-2 transposed conv's line of the summary: its launches
    (counted by the wrapper, plus those the profiled replays made, by
    kernel name), and one cifar10_stylegan2 step's launches (the rows'
    launches on that path, both roles) times their cold ms, plain ms,
    library ms and bound."""
    path = f"train {STYLEGAN2} float32"
    runs = [(sum(c for src, c in r["launches"].items() if src.startswith(path)), r) for r in rows]
    per_step = {key: sum(n * r[key] for n, r in runs) for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return {"name": "conv3x3_tconv", "route": "cuda", "source": "triplegan_tpu_torch/ops/csrc/conv3x3.cu",
            "replaces": None, "launches": counted["conv3x3_tconv"] + replayed["conv3x3_tconv"],
            "launches_counted": counted["conv3x3_tconv"], "launches_replayed": replayed["conv3x3_tconv"],
            "max_abs_err": max((r["max_abs_err"] for r in rows), default=None),
            "launches_a_step": sum(n for n, _ in runs), **per_step, "bound_by": "operations",
            "basis": f"sum over one {STYLEGAN2} step's launches (R1's amortised as the eager steps ran them; "
                     "float32, batch 64); library: cuDNN's F.conv_transpose2d under cudnn.deterministic"}


def moments_summary(rows, replayed) -> dict:
    """The batch-norm moments' line of the summary: launches in this
    process (``launches_counted``: every forward pair, main paths and their
    checks alike) plus those the profiled replays made (``replayed``, by
    kernel name); and each setting's forward pairs and backwards a step
    (the rows' ``train`` launches) times their cold ms, plain ms and
    bound, the shipped setting's at the top level."""
    per_step = {}
    for row in rows:
        for source, (nf, nb) in row["launches_fwd_bwd"].items():
            if not source.startswith("train "):
                continue
            rec = per_step.setdefault(source[len("train "):], {
                "dtype": row["dtype"], "source": "triplegan_tpu_torch/ops/csrc/scale_bias_act.cu",
                "launches_fwd_bwd": [0, 0], "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": "bytes",
                "library_ms": None, "max_limit_share": 0.0})
            rec["launches_fwd_bwd"] = [rec["launches_fwd_bwd"][0] + nf, rec["launches_fwd_bwd"][1] + nb]
            for key in ("ms", "plain_ms", "bound_ms"):
                rec[key] += nf * row["fwd_" + key] + nb * row["bwd_" + key]
            rec["max_limit_share"] = max(rec["max_limit_share"], row["sum_limit_share"], row["dx_limit_share"])
    top = per_step.get("shipped", {})
    counted = sum(MOMENTS_SEEN["bn_moments"].values())
    return {"name": "bn_moments", "route": "cuda", "source": "triplegan_tpu_torch/ops/csrc/scale_bias_act.cu",
            "replaces": None, "launches": counted + replayed["bn_moments"], "launches_counted": counted,
            "launches_replayed": replayed["bn_moments"],
            "max_limit_share": max((max(r["sum_limit_share"], r["dx_limit_share"]) for r in rows), default=None),
            **{key: top.get(key) for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "basis": "forward pairs (bnm_fwd_rows + bnm_reduce) and backwards (bnm_bwd_rows); top level: sum "
                     "over one shipped train step's launches (cifar10_4k graph arm, float32, batch 100); "
                     "per_step: the same for each graph arm, each arm of phase 3c and phase 3e",
            "per_step": per_step}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write every result as JSON here")
    ap.add_argument("--variant-step", metavar="DATA_DIR", default=None,
                    help="(phase 5b's subprocesses) one step per arm under the layer variant the "
                         "environment sets, on the prepared data in DATA_DIR")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs only on a CUDA device")
    sys.path.insert(0, REPO)
    from triplegan_tpu_torch.utils.platform import resolve_device

    if args.variant_step:
        resolve_device(None)
        variant_step(args.variant_step)
        return

    t_start = time.perf_counter()
    phases = {}

    # 1. device
    dev = resolve_device(None)
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} (count {torch.cuda.device_count()}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda})", flush=True)
    print(smi, flush=True)

    # 2. build
    build_s = build_phase()
    emit("build", build_s)
    phases["build"] = time.perf_counter() - t_start

    data_root = tempfile.mkdtemp(prefix="chip_smoke_data_")
    try:
        # 2b. the datasets through cli prepare, and cli doctor on them
        doctor = doctor_phase(data_root, kind)
        data_dir = doctor["_data_dir"]
        phases["doctor"] = time.perf_counter() - t_start

        # 3. train
        train_arms, data, zca = train_phase()
        phases["train"] = time.perf_counter() - t_start

        # 3b. K train steps a dispatch, as a CUDA graph
        graph_arms = graph_phase(data, zca)
        phases["graph"] = time.perf_counter() - t_start

        # 3c. mnist100, svhn1k and cifar10_cond at their published widths
        configs = configs_phase(data_dir, zca)
        phases["configs"] = time.perf_counter() - t_start

        # 3e. cifar10_snresnet: the SN-ResNet G and D, graphed
        snresnet = snresnet_phase(zca)
        emit("snresnet", {k: v for k, v in snresnet.items() if not k.startswith("_")})
        phases["snresnet"] = time.perf_counter() - t_start

        # 3f. cifar10_stylegan2: the StyleGAN2 G and D with lazy R1, graphed
        stylegan2 = stylegan2_phase()
        emit("stylegan2", {k: v for k, v in stylegan2.items() if not k.startswith("_")})
        phases["stylegan2"] = time.perf_counter() - t_start

        # 3d. digits: one seed of the real-data recipe, both arms
        digits = digits_phase(data_root)
        phases["digits"] = time.perf_counter() - t_start

        # 4. card against CPU
        card_cpu = card_vs_cpu_phase(data, zca)
        phases["card_vs_cpu"] = time.perf_counter() - t_start

        # 4b. checkify_step and a trace window
        debug = debug_phase(data, zca)
        phases["debug"] = time.perf_counter() - t_start

        # 5. the train driver through the CLI, on the shards cli prepare made
        driver = driver_phase(train_arms, data_dir)
        phases["driver"] = time.perf_counter() - t_start

        # 5d. export, qualify, score, serve and reload the driver's run
        deploy = deploy_phase(driver, data_dir)
        phases["deploy"] = time.perf_counter() - t_start

        # 5b. host-streamed batches, ddinit, the fused classifier, the variants
        host = host_phase(data, zca, data_dir)
        phases["host"] = time.perf_counter() - t_start

        # 5c. data parallelism: stl10 on a mesh of 2 ranks
        mesh = mesh_phase(data_root, dev)
        phases["mesh"] = time.perf_counter() - t_start
    finally:
        import shutil

        shutil.rmtree(data_root, ignore_errors=True)

    # 6. serve
    serve_arms = serve_phase()
    torch.cuda.synchronize(dev)
    phases["serve"] = time.perf_counter() - t_start

    # 7. kernels, at the shapes the main paths launched them at
    moments_paths = {arm["setting"]: (arm["dtype"], arm["batch"], arm["_moments"], arm["_steps"])
                     for arm in graph_arms if arm["use_pallas"]}
    for rec in configs:
        moments_paths.update(rec["_moments"])
    moments_paths[f"{SNRESNET} float32"] = ("float32", BATCH, snresnet["_moments"], snresnet["_steps"])
    sources = (path_launches(train_arms, configs, serve_arms, host, mesh, deploy, doctor, digits)
               + snresnet["_sources"] + stylegan2["_sources"])
    emit("winograd_share", winograd_share(sources))
    (sba_rows, bwd_rows, cond_rows, cond_bwd_rows, noise_rows, noise_bwd_rows, conv_rows, moment_rows,
     tconv_rows) = kernel_phase(sources, moments_paths)
    phases["kernels"] = time.perf_counter() - t_start
    emit("phase_end_s", phases)
    lost = [w for w in PROFILE_WINDOWS if any(w)]
    emit("profile_markers", {"windows": len(PROFILE_WINDOWS), "markers_a_side": PROFILE_MARKERS,
                             "windows_that_lost_markers": len(lost), "lost_leading_trailing": lost})

    # the moments' counters on each graphed path (the cifar10_4k graph arms'
    # capture and chunks, phase 3c's arms, phase 3e's steps)
    emit("bn_moments_counters", {path: {"steps": n, **{name: {str(key): c for key, c in cnt.items()}
                                                       for name, cnt in counters.items()}}
                                 for path, (_, _, counters, n) in moments_paths.items()})
    config_runs = [run for rec in configs for run in rec["arms"] + [rec["serving"]] + ([rec["loop"]] if "loop" in rec else [])]
    kernels = summary(sba_rows, bwd_rows, cond_rows, cond_bwd_rows, noise_rows, noise_bwd_rows, conv_rows, moment_rows,
                      tconv_rows, train_arms + graph_arms + config_runs + [driver, host, mesh, deploy, doctor, digits, snresnet,
                                                               stylegan2],
                      serve_arms)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"smi": smi, "kind": kind, "build_s": build_s, "phase_end_s": phases,
                       "sba_rows": sba_rows, "sba_bwd_rows": bwd_rows, "cond_rows": cond_rows,
                       "cond_bwd_rows": cond_bwd_rows, "noise_rows": noise_rows, "noise_bwd_rows": noise_bwd_rows,
                       "conv_rows": conv_rows, "bn_moments_rows": moment_rows, "tconv_rows": tconv_rows,
                       "doctor": public(doctor), "debug": debug,
                       "train": [public(a) for a in train_arms],
                       "graph": [public(a) for a in graph_arms], "configs": [public(r) for r in configs],
                       "card_vs_cpu": card_cpu, "driver": public(driver), "host": public(host),
                       "mesh": public(mesh), "deploy": public(deploy), "digits": public(digits),
                       "snresnet": public(snresnet), "stylegan2": public(stylegan2),
                       "serve": [public(a) for a in serve_arms],
                       "kernels": kernels, "profile_windows": PROFILE_WINDOWS}, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
