"""The training driver: the port of ``triplegan_tpu/train/loop.py``.

``train`` builds the networks, the three Adams and the state, resumes from
the run's newest checkpoint if it has one (else, with ``ddinit``, applies
the data-dependent weight-norm init: ``_apply_ddinit``), and runs the
three-player step on the JAX loop's schedule. With ``data_on_device`` (the
default) the dataset is resident on the device and each step draws its own
batches there (``train/step.py::make_device_train_step``); without it the
host samples the batches (``data/pipeline.py::BatchSampler``, seeded
``seed + step`` so that a resumed run draws a fresh continuation, as
JAX's does) and ``device_prefetch`` stages them onto the device ahead of
``make_train_step``; ``scan_steps`` is then 1, as in JAX (a chunk needs
the data on the device).

* with ``scan_steps`` = K > 1, K steps a call while a whole chunk fits
  before the end (``make_scan_device_train_step``: one CUDA graph replay on
  the card, the same steps eagerly on the CPU; its metrics per
  ``scan_metrics``, "last" or "mean"), and single steps for the rest, as
  the JAX loop's ``lax.scan`` chunks; the logs, evals, checkpoints and the
  stop check below then come at chunk boundaries;
* every ``log_every`` steps (and at the last), the step's metrics are read
  to the host, logged with the images per second since the last log
  (``utils/logging.py``) and printed; the loop reads nothing from the
  device between logs;
* at each ``eval_every_epochs`` boundary, the test error
  (``eval/metrics.py``) and a class grid of samples, written as
  ``samples_<step>.png``; at each ``ckpt_every_epochs`` boundary, a
  checkpoint (``ckpt/manager.py``);
* at the end, the test error again if the last one is stale, and a final
  checkpoint.

Checkpoints are saved asynchronously (``ckpt/manager.py``): the loop
trains on while the previous one is written. Every exit publishes the last
one before ``train`` returns or raises: the normal end, a stop (STOP or
SIGTERM) and an exception alike.

A run stops early on SIGTERM or when ``<run dir>/STOP`` exists (a stale
one is removed at start). The stop is checked at the top of each
iteration, after the step at an epoch boundary, and before each test
batch; a stop skips the rest of that epoch's tail and the final
re-evaluation, still checkpoints, and the result says ``preempted``.
Running the same command again resumes from that checkpoint: the step's
random streams depend only on (seed, step), so the resumed run computes
what an uninterrupted one would.

With ``mesh_shape`` (N,) (or ``multihost``) the run is data-parallel over
N processes, one a card (``parallel/mesh.py``: launched by ``torchrun
--nproc-per-node N``, or joined through the ``multihost_*`` fields): each
rank builds or restores the same state, takes its rows of each batch
(device data: its own draws of ``batch_size // N``; host batches: its
slice of the global batch, which every rank's sampler draws alike) and of
each test batch, and the step, the eval and the stop decision are
collective. The coordinator (rank 0) alone prints, logs, writes grids,
``config.json``, the ZCA cache and checkpoints (every rank waits for the
last one at the end), and polls the ``STOP`` file; the stop is decided for all ranks at
once by an all-reduce of each rank's stop bit, at the loop top every
``TRIPLEGAN_STOP_SYNC_EVERY`` steps (32) and right after an epoch's tail,
after the step at an epoch boundary, before each test batch, and after
the loop, so every rank stops at the same step. A world of another size
than the mesh's, or a mesh of more than one without a process group or
torchrun's environment, raises.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Optional

import torch

from triplegan_tpu_torch.ckpt.manager import CheckpointManager
from triplegan_tpu_torch.configs.base import apply_runtime, display, make_networks, save_config
from triplegan_tpu_torch.data import ondevice
from triplegan_tpu_torch.data.datasets import SemiSupervisedData, load_dataset, synthetic_dataset
from triplegan_tpu_torch.data.pipeline import BatchSampler, device_prefetch
from triplegan_tpu_torch.data.zca import ZCAStats, fit_zca
from triplegan_tpu_torch.eval.metrics import evaluate_error
from triplegan_tpu_torch.eval.sample import class_grid_inputs, make_sample_fn, save_png, to_uint8_grid
from triplegan_tpu_torch.nn.ddinit import ddinit_discriminator, ddinit_generator
from triplegan_tpu_torch.parallel.mesh import mesh_for
from triplegan_tpu_torch.train.schedule import make_optimizers
from triplegan_tpu_torch.train.state import create_state, param_count
from triplegan_tpu_torch.train.step import (make_device_train_step, make_eval_step,
                                            make_scan_device_train_step, make_train_step,
                                            upload_device_data)
from triplegan_tpu_torch.utils.logging import MetricsLogger
from triplegan_tpu_torch.utils.platform import resolve_device


def _ddinit_inputs(cfg, data: SemiSupervisedData, zca: Optional[ZCAStats], device):
    """(x, y, z, y_g) of the data-dependent init: min(batch_size,
    len(x_unlabel)) unlabeled images preprocessed as the train step does but
    without augmentation (rescale and ZCA, train=False), in float32 whatever
    the compute dtype; D's labels y and G's z and labels y_g drawn from a
    ``torch.Generator`` seeded ``seed + 1`` on the CPU (the JAX loop draws
    them from ``PRNGKey(seed + 1)``: other numbers, as every random stream
    of the port), so a run on the card and one on the CPU init from the
    same inputs."""
    n = min(int(cfg.batch_size), len(data.x_unlabel))
    zm, zw = (None, None) if zca is None else (torch.as_tensor(zca.mean, device=device),
                                               torch.as_tensor(zca.whiten, device=device))
    x = ondevice.standard_pipeline(torch.as_tensor(data.x_unlabel[:n], device=device), zca_mean=zm,
                                   zca_whiten=zw, train=False, do_rescale=bool(cfg.get("rescale", True)))
    rng = torch.Generator().manual_seed(int(cfg.seed) + 1)
    y = torch.randint(0, cfg.num_classes, (n,), generator=rng)
    z = torch.randn((n, cfg.z_dim), generator=rng)
    y_g = torch.randint(0, cfg.num_classes, (n,), generator=rng)
    return x, y.to(device), z.to(device), y_g.to(device)


def _apply_ddinit(cfg, nets, state, data: SemiSupervisedData, zca: Optional[ZCAStats], device):
    """Data-dependent weight-norm init (``nn/ddinit.py``) of D and G on the
    batch of ``_ddinit_inputs``; returns the state with the new params."""
    gen, disc, _ = nets
    x, y, z, y_g = _ddinit_inputs(cfg, data, zca, device)
    params = dict(state.params)
    params["disc"] = ddinit_discriminator(disc, state.params["disc"], x, y)
    params["gen"] = ddinit_generator(gen, state.params["gen"], state.bn["gen"], z, y_g)
    return dataclasses.replace(state, params=params)


def _resolve_data(cfg) -> SemiSupervisedData:
    if cfg.dataset == "synthetic":
        return synthetic_dataset(image_size=cfg.image_size, channels=cfg.channels,
                                 num_classes=cfg.num_classes, num_labeled=cfg.num_labeled,
                                 seed=cfg.seed)
    data = load_dataset(cfg.data_dir, cfg.dataset, cfg.num_labeled, cfg.num_classes, cfg.seed)
    want = (cfg.image_size, cfg.image_size, cfg.channels)
    got = tuple(data.x_test.shape[1:])
    if got != want:
        raise ValueError(
            f"dataset '{cfg.dataset}' images are {got}, but the config expects {want}: set "
            f"--set image_size={got[0]} / --set channels={got[-1]} (networks are shape-generic)"
        )
    ymax = int(data.y_test.max())
    if ymax >= cfg.num_classes:
        raise ValueError(f"dataset '{cfg.dataset}' has label {ymax} but num_classes="
                         f"{cfg.num_classes}: set --set num_classes={ymax + 1}")
    return data


def _resolve_zca(cfg, data: SemiSupervisedData, workdir: str,
                 coordinator: bool = True) -> Optional[ZCAStats]:
    """The run dir's copy, else the stats fitted when the data was
    prepared (``{data_dir}/{dataset}/zca_stats.npz``), else a fresh fit on
    the unlabeled pool; the stats chosen are published into the run dir
    (written and renamed, so a reader never sees half a file), so that eval
    and sample whiten as training did. Only the coordinator of a
    data-parallel run reads or writes the run dir's copy (a reader could
    catch its write half done); the other ranks take the prepared stats or
    fit them, which gives the same arrays."""
    if not cfg.zca:
        return None
    cache = os.path.join(workdir, "zca_stats.npz")
    if coordinator and os.path.exists(cache):
        return ZCAStats.load(cache)
    prepared = os.path.join(cfg.data_dir, cfg.dataset, "zca_stats.npz")
    if cfg.dataset != "synthetic" and os.path.exists(prepared):
        stats = ZCAStats.load(prepared)
    else:
        stats = fit_zca(data.x_unlabel)
    if coordinator:
        os.makedirs(workdir, exist_ok=True)
        tmp = f"{cache}.{os.getpid()}.tmp.npz"
        stats.save(tmp)
        os.replace(tmp, cache)
    return stats


class _EvalInterrupted(Exception):
    """A stop (SIGTERM or the STOP file) came during an evaluation, which
    is abandoned."""


def _test_stream(sampler: BatchSampler, device, stop_check=None, mesh=None):
    """The sampler's test batches as tensors on ``device`` (under ``mesh``
    this rank's rows of each); ``stop_check`` is asked before each batch
    and raises ``_EvalInterrupted`` if true (under a mesh it is the
    collective verdict, so every rank stops at the same batch)."""
    for batch in sampler.test_batches():
        if stop_check is not None and stop_check():
            raise _EvalInterrupted()
        if mesh is not None:
            batch = mesh.rank_rows(batch)
        yield {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train(cfg, data: Optional[SemiSupervisedData] = None, max_steps: Optional[int] = None,
          verbose: bool = True, device=None) -> dict:
    """A training run on ``device`` (default the card: ``cuda:LOCAL_RANK``
    under torchrun); returns ``steps``, ``test_error``, ``metrics`` (the
    last logged), ``workdir``, ``state`` and ``preempted``, on every rank
    of a mesh. ``max_steps`` caps the steps this call takes without
    changing the schedule, which follows ``epochs``."""
    dev = resolve_device(device)
    mesh = mesh_for(cfg, dev)  # before any work: a missing group or a mis-sized world raises
    coord = mesh is None or mesh.coordinator
    n_dev = 1 if mesh is None else mesh.world
    if cfg.batch_size % n_dev:
        raise ValueError(f"batch_size {cfg.batch_size} must divide evenly over the {n_dev}-rank data mesh")
    apply_runtime(cfg)
    workdir = os.path.join(cfg.workdir, cfg.name)
    os.makedirs(workdir, exist_ok=True)
    say = print if verbose and coord else (lambda *a, **k: None)
    say(display(cfg))

    if data is None:
        data = _resolve_data(cfg)
    zca = _resolve_zca(cfg, data, workdir, coord)
    steps_per_epoch = int(cfg.steps_per_epoch) or max(len(data.x_unlabel) // cfg.batch_size, 1)
    total_steps = int(cfg.epochs) * steps_per_epoch

    nets = make_networks(cfg)
    optimizers = make_optimizers(cfg, total_steps)
    state = create_state(cfg, nets, optimizers, device=dev)
    say("param counts:", param_count(state))
    on_device = bool(cfg.data_on_device)
    make_step = make_device_train_step if on_device else make_train_step
    step = make_step(cfg, nets, optimizers, total_steps, zca,
                     pseudo_label_mode=cfg.get("pseudo_label_mode", "sample"), mesh=mesh)
    # K steps a call: a CUDA graph on the card. It overwrites the state's
    # tensors in place (the loop keeps no older state). Host-streamed
    # batches come one a step, so there are no chunks then.
    chunk = max(int(cfg.get("scan_steps", 1)), 1) if on_device else 1
    scan = None
    if chunk > 1:
        scan = make_scan_device_train_step(
            cfg, nets, optimizers, total_steps, chunk, zca,
            pseudo_label_mode=cfg.get("pseudo_label_mode", "sample"),
            metrics_mode=str(cfg.get("scan_metrics", "last")), log=say, mesh=mesh)
    eval_step = make_eval_step(cfg, nets, zca, mesh=mesh)

    ckpt = CheckpointManager(os.path.join(workdir, "ckpt"), max_to_keep=cfg.ckpt_keep, mesh=mesh)
    restored = ckpt.restore(state)
    if restored is not None:
        state = restored
        say(f"resumed from step {state.step}", flush=True)
    elif cfg.ddinit:
        state = _apply_ddinit(cfg, nets, state, data, zca, dev)
        say("applied data-dependent weight-norm init", flush=True)
    # Written only after the restore decision: a resume whose config does
    # not fit the checkpoint fails above and leaves the good record alone.
    if coord:
        save_config(cfg, os.path.join(workdir, "config.json"))

    # The sampler's seed takes the resume step, so a resumed run draws a
    # fresh continuation of the host streams (as JAX's loop does); every
    # rank draws the global batch and keeps its rows.
    sampler = BatchSampler(data, cfg.batch_size, seed=int(cfg.seed) + state.step,
                           rows=None if mesh is None else mesh.rows(cfg.batch_size))
    if on_device:
        device_data, batches = upload_device_data(data, dev), None
    else:
        device_data = None
        batches = device_prefetch(sampler.triple_iter(
            cfg.z_dim, cfg.num_classes, skip_c_unlabeled=bool(cfg.get("share_pseudo_forward", False))), dev)
    sample_fn = make_sample_fn(cfg, nets)

    start_step = state.step
    end_step = total_steps if max_steps is None else min(total_steps, start_step + max_steps)
    last_metrics: dict = {}
    test_error = None
    eval_at = -1
    profile_dir = str(cfg.get("profile_dir", "") or "") if coord else ""
    profiler = None
    profile_start = start_step + 2 * chunk
    profile_stop = profile_start + max(int(cfg.get("profile_steps", 10)), chunk)

    # A stop (SIGTERM on any rank, or the STOP file, which the coordinator
    # alone polls: it also removes a stale one at start, so no rank can read
    # last run's) must be decided at the same step on every rank, since the
    # step, the eval and the save are collective: under a mesh the verdict
    # is an all-reduce of the ranks' bits, paid at the loop top only every
    # TRIPLEGAN_STOP_SYNC_EVERY steps (and right after an epoch's tail),
    # after the step at an epoch boundary, before each test batch, and
    # after the loop. One process checks its own bit every time.
    stop = {"sig": None}
    stop_file = os.path.join(workdir, "STOP")
    if coord and os.path.exists(stop_file):
        os.remove(stop_file)  # left by an earlier stopped run
    stop_sync_every = max(1, int(os.environ.get("TRIPLEGAN_STOP_SYNC_EVERY", "32")))

    def _on_sigterm(signum, frame):
        stop["sig"] = signum

    def _global_stop() -> bool:
        local = stop["sig"] is not None or (coord and os.path.exists(stop_file))
        return local if mesh is None else mesh.any(local)

    def _evaluate() -> float:
        return evaluate_error(eval_step, state, _test_stream(sampler, dev, _global_stop, mesh))

    def _end_profile():
        nonlocal profile_dir
        _sync(dev)
        profiler.stop()
        os.makedirs(profile_dir, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
        say(f"wrote profile trace to {profile_dir}", flush=True)
        profile_dir = ""

    try:
        prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:  # not the main thread: no handler
        prev_sigterm = None

    logger = MetricsLogger(workdir, enabled=coord)
    t_log = time.perf_counter()
    steps_since_log = 0
    it = start_step
    stopping = False
    steps_since_sync, sync_now = stop_sync_every, True  # a sync at the first loop top
    try:
        while it < end_step:
            if mesh is None or sync_now or steps_since_sync >= stop_sync_every:
                stopping = _global_stop()
                steps_since_sync, sync_now = 0, False
            if stopping:
                break
            if profile_dir and profiler is None and it >= profile_start:
                _sync(dev)
                acts = [torch.profiler.ProfilerActivity.CPU]
                if dev.type == "cuda":
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                profiler = torch.profiler.profile(activities=acts)
                profiler.start()
            if scan is not None and it + chunk <= end_step:
                state, metrics = scan(state, device_data)
                taken = chunk
            else:
                state, metrics = step(state, device_data if batches is None else next(batches))
                taken = 1
            prev, it = it, it + taken
            steps_since_log += taken
            steps_since_sync += taken
            if profiler is not None and profile_dir and it >= profile_stop:
                _end_profile()

            log_hit = cfg.log_every and (it // cfg.log_every) > (prev // cfg.log_every)
            if log_hit or it == end_step:
                last_metrics = {k: float(v) for k, v in metrics.items()}  # waits for the step
                dt = time.perf_counter() - t_log
                t_log = time.perf_counter()
                imgs_per_sec = steps_since_log * cfg.batch_size / max(dt, 1e-9)
                steps_since_log = 0
                logger.scalars(it, {**last_metrics, "images_per_sec": imgs_per_sec})
                terms = " ".join(f"{k}={v:.4f}" for k, v in sorted(last_metrics.items()))
                say(f"step {it}/{total_steps} [{imgs_per_sec:.0f} img/s] {terms}", flush=True)

            epoch_done = (it // steps_per_epoch) > (prev // steps_per_epoch)
            epoch = it // steps_per_epoch
            if epoch_done and (cfg.eval_every_epochs or cfg.ckpt_every_epochs):
                stopping = _global_stop()  # a stop during the step skips the tail
                steps_since_sync, sync_now = 0, True  # and one during the tail is caught at the top
            if (epoch_done and not stopping and cfg.eval_every_epochs
                    and epoch % cfg.eval_every_epochs == 0):
                try:
                    test_error = _evaluate()
                except _EvalInterrupted:
                    stopping = True
                else:
                    eval_at = it
                    logger.scalars(it, {"test_error": test_error})
                    say(f"epoch {epoch}: test error {100 * test_error:.2f}%", flush=True)
                    if coord:  # the grid is a host-side output: the coordinator's
                        z, labels = class_grid_inputs(cfg, n_per_class=10, seed=cfg.seed)
                        grid = to_uint8_grid(sample_fn(state, z, labels), cfg.num_classes, 10)
                        logger.image(it, "samples", grid)
                        save_png(grid, os.path.join(workdir, f"samples_{it:08d}.png"))
            if (epoch_done and not stopping and cfg.ckpt_every_epochs
                    and epoch % cfg.ckpt_every_epochs == 0):
                ckpt.save(it, state)

        preempted = stopping or _global_stop()
        if profiler is not None and profile_dir:  # the run ended inside the window
            _end_profile()
        if not preempted and (test_error is None or eval_at != it):
            # The error reported must be the final state's, the one that
            # `cli eval` computes from the last checkpoint.
            try:
                test_error = _evaluate()
            except _EvalInterrupted:
                preempted = True
            else:
                logger.scalars(it, {"test_error": test_error})
        ckpt.save(state.step, state)
        ckpt.close()
    finally:
        ckpt.join()  # on an exception's way out too: the save in flight is published
        # The handler stays through the save: a second SIGTERM during it
        # must not kill the process before the checkpoint is published.
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)
        logger.close()
    if preempted:
        say(f"preempted (SIGTERM/STOP): checkpointed at step {state.step}; "
            f"re-run the same command to resume", flush=True)
    return {"steps": state.step, "test_error": test_error, "metrics": last_metrics,
            "workdir": workdir, "state": state, "preempted": preempted}
