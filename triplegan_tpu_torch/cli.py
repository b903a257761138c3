"""Command-line entry points of the port:

    python -m triplegan_tpu_torch.cli train     --config cifar10_4k --workdir runs --data-dir data [--max-steps N]
    python -m triplegan_tpu_torch.cli eval      --config cifar10_4k --workdir runs --data-dir data [--step N] [--artifact A.pt2]
    python -m triplegan_tpu_torch.cli sample    --config cifar10_4k --workdir runs --out grid.png
    python -m triplegan_tpu_torch.cli inception --config cifar10_4k --workdir runs [--scorer-path P]
    python -m triplegan_tpu_torch.cli fid       --config cifar10_4k --workdir runs --data-dir data [--scorer-path P]
    python -m triplegan_tpu_torch.cli export    --config cifar10_4k --workdir runs [--format pt2|npz] [--quantize int8]
    python -m triplegan_tpu_torch.cli serve     --config cifar10_4k --workdir runs [--port 8000]
    python -m triplegan_tpu_torch.cli serve     --classifier classify.pt2 --generator generate.pt2
    python -m triplegan_tpu_torch.cli predict   --config cifar10_4k --workdir runs --input imgs.npy [--artifact A.pt2]
    python -m triplegan_tpu_torch.cli prepare   --dataset cifar10 --raw-dir raw --data-dir data [--download]
    python -m triplegan_tpu_torch.cli doctor    [--config cifar10_4k --workdir runs --data-dir data]

``train`` runs the train driver (``train/loop.py``) in ``<workdir>/<name>``:
metrics, sample grids, checkpoints, and ``config.json``; run again, it
resumes from the newest checkpoint. A run stopped by SIGTERM or a
``<workdir>/<name>/STOP`` file checkpoints and exits with code 75. The
other commands read a checkpoint of that run dir (the newest, or
``--step``): ``eval`` its test error (or, with ``--artifact``, an exported
classifier's, which must match), ``sample`` a grid, ``inception`` and
``fid`` the score of its samples (scored by its own classifier or by
``--scorer-path``), ``export`` its ``.pt2`` artifacts or ``params.npz``,
``predict`` the labels of a file of images, and ``serve`` an HTTP server
(``POST /reload`` serves the newest checkpoint). ``serve`` also takes
exported artifacts (``--classifier``/``--generator``), or a
``params.npz`` in the JAX package's layout (``--params``, or the run dir's
``export/params.npz`` when it has no checkpoint). ``prepare`` converts raw
dataset files into the shards the others read (``data/prepare.py``), and
``doctor`` checks a machine and a run before it starts (``doctor.py``):
its device probe builds the kernels and holds each to its plain twin on
the card; it exits 1 if any check fails.

The run dir's ``config.json`` is merged over the named config as the JAX
CLI does, and ``--set key=value`` overrides any config field, e.g.
``--set use_pallas=false`` for plain PyTorch in place of the Hopper
kernels. Every command runs on the card; ``--device cpu`` runs it on the
CPU.

``train``, ``eval`` and ``sample`` run data-parallel under torchrun, one
process a card (``cuda:LOCAL_RANK``; the CPU with ``--device cpu``)::

    torchrun --nproc-per-node N -m triplegan_tpu_torch.cli train --config stl10 --set 'mesh_shape=(N,)' ...

The ranks share the work and the coordinator (rank 0) prints and writes;
a ``mesh_shape`` that is not the number of processes raises. The other
commands run as one process.

Every command first points the kernels' builds at their directory
(``utils/cache.py::enable_build_cache``): the package's ``_build/`` where
it can be written, else ``~/.cache/triplegan_tpu_torch_build``.
"""

from __future__ import annotations

import argparse
import ast
import os
import signal
import sys


def _apply_overrides(cfg, overrides):
    for kv in overrides or []:
        key, _, raw = kv.partition("=")
        try:
            val = ast.literal_eval(raw)
        except (SyntaxError, ValueError):
            val = {"true": True, "false": False}.get(raw.lower(), raw)
        node = cfg
        *parents, leaf = key.split(".")
        for p in parents:
            if p not in node:
                sys.exit(f"unknown config key '{key}' (no section '{p}')")
            node = node[p]
        if leaf not in node:
            sys.exit(f"unknown config key '{key}'; valid keys in this section: {sorted(node.keys())}")
        node[leaf] = val
    return cfg


def _resolve_paths(cfg, args):
    if getattr(args, "workdir", None):
        cfg.workdir = args.workdir
    if getattr(args, "data_dir", None):
        cfg.data_dir = args.data_dir
    return cfg


def _load_cfg(args):
    """The named config with the run dir's ``config.json`` merged over it
    (if there is one), then ``--workdir``, ``--data-dir`` and ``--set``. The
    run dir is found with those already applied, as the JAX CLI finds it,
    so ``--set name=...`` or ``--set workdir=...`` merges that run's saved
    config, not the named config's."""
    from triplegan_tpu_torch.configs import get_config
    from triplegan_tpu_torch.configs.base import merge_saved

    overrides = getattr(args, "set", None)
    try:
        probe = _apply_overrides(_resolve_paths(get_config(args.config), args), overrides)
        cfg = get_config(args.config)
    except KeyError as e:
        sys.exit(str(e))
    saved = os.path.join(probe.workdir, probe.name, "config.json")
    if os.path.exists(saved):
        merge_saved(cfg, saved)
    return _apply_overrides(_resolve_paths(cfg, args), overrides)


def cmd_train(args):
    from triplegan_tpu_torch.parallel.mesh import is_coordinator
    from triplegan_tpu_torch.train.loop import train

    result = train(_load_cfg(args), max_steps=args.max_steps, device=args.device)
    if result["preempted"]:
        # Stopped and checkpointed, not finished: EX_TEMPFAIL, so that a
        # restart policy runs the same command again (which resumes).
        sys.exit(75)
    if is_coordinator():
        print(f"done: step={result['steps']} test_error={100 * result['test_error']:.2f}%")


def _restore_at(ckpt, state, args, workdir):
    """The newest checkpoint, or the one ``--step`` names."""
    try:
        restored = ckpt.restore(state, step=getattr(args, "step", None))
    except FileNotFoundError as e:
        sys.exit(f"{e} under {workdir}/ckpt")
    if restored is None:
        sys.exit(f"no checkpoint under {workdir}/ckpt")
    return restored


def _restore_run(args, mesh: bool = True):
    """(cfg, networks, restored state, run dir, device, mesh) of the run dir
    that ``args`` names, on ``args.device``; the mesh of ``mesh_shape``
    (None for one process, or with ``mesh=False``:
    ``parallel/mesh.py::mesh_for``)."""
    from triplegan_tpu_torch.ckpt.manager import CheckpointManager
    from triplegan_tpu_torch.configs.base import apply_runtime, make_networks
    from triplegan_tpu_torch.parallel.mesh import mesh_for
    from triplegan_tpu_torch.train.schedule import make_optimizers
    from triplegan_tpu_torch.train.state import create_state
    from triplegan_tpu_torch.utils.platform import resolve_device

    cfg = apply_runtime(_load_cfg(args))
    dev = resolve_device(args.device)
    mesh = mesh_for(cfg, dev) if mesh else None
    workdir = os.path.join(cfg.workdir, cfg.name)
    nets = make_networks(cfg)
    template = create_state(cfg, nets, make_optimizers(cfg, 1), device=dev)
    ckpt = CheckpointManager(os.path.join(workdir, "ckpt"), write=False)
    return cfg, nets, _restore_at(ckpt, template, args, workdir), workdir, dev, mesh


def cmd_eval(args):
    from triplegan_tpu_torch.data.pipeline import BatchSampler
    from triplegan_tpu_torch.eval.metrics import evaluate_error
    from triplegan_tpu_torch.train.loop import _resolve_data, _resolve_zca, _test_stream
    from triplegan_tpu_torch.train.step import make_eval_step

    if args.artifact:
        return _eval_artifact(args)
    cfg, nets, state, workdir, dev, mesh = _restore_run(args)
    if mesh is not None and cfg.batch_size % mesh.world:
        sys.exit(f"batch_size={cfg.batch_size} must divide evenly over the {mesh.world}-rank data mesh")
    coord = mesh is None or mesh.coordinator
    data = _resolve_data(cfg)
    zca = _resolve_zca(cfg, data, workdir, coord)
    sampler = BatchSampler(data, cfg.batch_size)
    err = evaluate_error(make_eval_step(cfg, nets, zca, mesh), state,
                         _test_stream(sampler, dev, mesh=mesh))
    if coord:
        print(f"test error: {100 * err:.2f}%")


def _load_classifier_artifact(path: str, device):
    """The classifier ``.pt2`` artifact at ``path`` on ``device``; exits
    unless there is one there (a classifier takes one input)."""
    from triplegan_tpu_torch.export import load_pt2

    if not os.path.exists(path):
        sys.exit(f"{path}: no such artifact")
    art = load_pt2(path, device=device)
    if len(art.in_specs) != 1:
        sys.exit(f"{path} is not a classifier artifact (it takes {len(art.in_specs)} inputs; "
                 f"a classifier takes 1: uint8 images)")
    return art


def _eval_artifact(args):
    """Artifact qualification: the test error of an exported classifier,
    fed the raw uint8 test images (its input transform is inside), which
    must match the checkpoint's ``eval``. No checkpoint or ZCA is read."""
    import numpy as np

    from triplegan_tpu_torch.serve import batched_apply, numpy_fn
    from triplegan_tpu_torch.train.loop import _resolve_data
    from triplegan_tpu_torch.utils.platform import resolve_device

    cfg = _load_cfg(args)
    dev = resolve_device(args.device)
    art = _load_classifier_artifact(args.artifact, dev)
    (shape, _), = art.in_specs
    data = _resolve_data(cfg)
    x, y = data.x_test, data.y_test
    if tuple(shape[1:]) != tuple(x.shape[1:]):
        sys.exit(f"artifact expects images {tuple(shape[1:])}, test set has {tuple(x.shape[1:])}")
    logits = batched_apply(numpy_fn(art, dev), shape[0], x)
    err = float((np.argmax(logits, axis=-1) != y).mean())
    print(f"test error (artifact): {100 * err:.2f}%")


def cmd_sample(args):
    from triplegan_tpu_torch.eval.sample import class_grid_inputs, make_sample_fn, save_png, to_uint8_grid

    cfg, nets, state, _, _, mesh = _restore_run(args)
    if mesh is not None and not mesh.coordinator:
        return  # the grid is a host-side output: the coordinator's
    z, labels = class_grid_inputs(cfg, n_per_class=args.n_per_class, seed=args.seed)
    grid = to_uint8_grid(make_sample_fn(cfg, nets)(state, z, labels), cfg.num_classes,
                         args.n_per_class)
    save_png(grid, args.out)
    print(f"wrote {args.out}")


def _generate_samples(cfg, gen, state, n: int, seed: int):
    """``n`` class-conditional samples of the restored ``state``, raw [-1, 1]
    NHWC on the state's device, generated in chunks of ``cfg.batch_size``
    (the last padded with zeros, as the JAX CLI pads it). z (normal) and y
    (uniform over the classes) come from a ``torch.Generator`` seeded
    ``seed`` on the host; JAX's ``PRNGKey(seed)`` gives other numbers."""
    import torch

    dev = next(iter(state.params["gen"]["dense"].values())).device
    g = torch.Generator().manual_seed(int(seed))
    z = torch.randn((n, cfg.z_dim), generator=g).to(dev)
    y = torch.randint(0, cfg.num_classes, (n,), generator=g).to(dev)
    chunk = min(n, max(int(cfg.batch_size), 1))
    pieces = []
    with torch.no_grad():
        for i in range(0, n, chunk):
            zi, yi = z[i : i + chunk], y[i : i + chunk]
            pad = chunk - zi.shape[0]
            if pad:  # the last piece at the same shapes
                zi = torch.cat([zi, zi.new_zeros((pad, zi.shape[1]))])
                yi = torch.cat([yi, yi.new_zeros((pad,))])
            out, _ = gen.apply(state.params["gen"], state.bn["gen"], zi, yi, train=False)
            pieces.append(out[: chunk - pad])
    return torch.cat(pieces)


def _load_zca(cfg, workdir):
    """The run dir's ZCA stats (fitted afresh from the data, and published
    there, where the run dir has none); None for non-zca configs."""
    from triplegan_tpu_torch.data.zca import ZCAStats

    if not cfg.zca:
        return None
    cache = os.path.join(workdir, "zca_stats.npz")
    if os.path.exists(cache):
        return ZCAStats.load(cache)
    from triplegan_tpu_torch.train.loop import _resolve_data, _resolve_zca

    return _resolve_zca(cfg, _resolve_data(cfg), workdir)


def _classifier_fn(cfg, clf, state, workdir, features: bool = False):
    """The restored classifier in eval mode as a scorer: generated [-1, 1]
    images (whitened first on zca configs, as training fed it) to logits,
    or with ``features`` to its pooled features (the built-in FID space)."""
    import torch

    from triplegan_tpu_torch.data.zca import apply_zca

    dev = next(iter(state.params["clf"]["head"].values())).device
    zca = _load_zca(cfg, workdir)
    zm = torch.as_tensor(zca.mean, device=dev) if zca else None
    zw = torch.as_tensor(zca.whiten, device=dev) if zca else None

    def score(x):
        with torch.no_grad():
            x = torch.as_tensor(x).to(dev)
            if zm is not None:
                x = apply_zca(x, zm, zw)
            out, _ = clf.apply(state.params["clf"], state.bn["clf"], x, train=False,
                               return_features=features)
            return out[1] if features else out

    return score


def cmd_inception(args):
    """Inception-style score of the run's class-conditional samples: scored
    by the checkpoint's own classifier in eval mode, fed what it saw in
    training (whitened on zca configs), or by ``--scorer-path`` (a
    SavedModel, an ``.npz`` probe or an exported classifier ``.pt2``: see
    ``eval/inception.py::load_scorer``), fed raw [-1, 1] samples."""
    from triplegan_tpu_torch.eval.inception import inception_score, load_scorer

    cfg, nets, state, workdir, dev, _ = _restore_run(args, mesh=False)
    gen, _, clf = nets
    images = _generate_samples(cfg, gen, state, args.n_samples, args.seed)
    if args.scorer_path:
        score = load_scorer(args.scorer_path, outputs=args.scorer_outputs,
                            output_name=args.scorer_output_name, device=dev)
        label = "external-scored"
    else:
        score = _classifier_fn(cfg, clf, state, workdir)
        label = "classifier-scored"
    mean, std = inception_score(score, images, n_splits=args.n_splits)
    print(f"inception score ({label}): {mean:.3f} ± {std:.3f}")


def cmd_fid(args):
    """Fréchet distance between the run's generated samples and real data
    (``eval/fid.py``): in the checkpoint's classifier's pooled-feature space
    (whitened inputs on zca configs), or ``--scorer-path``'s outputs (e.g. a
    SavedModel with ``--scorer-output-name pool_3``), fed raw [-1, 1]
    images."""
    import numpy as np
    import torch

    from triplegan_tpu_torch.eval.fid import fid_score
    from triplegan_tpu_torch.eval.inception import load_scorer
    from triplegan_tpu_torch.train.loop import _resolve_data

    cfg, nets, state, workdir, dev, _ = _restore_run(args, mesh=False)
    gen, _, clf = nets
    generated = _generate_samples(cfg, gen, state, args.n_samples, args.seed)
    data = _resolve_data(cfg)
    real_u8 = data.x_test if args.real_split == "test" else data.x_unlabel
    if args.n_real and args.n_real < len(real_u8):
        sel = np.random.RandomState(args.seed).choice(len(real_u8), args.n_real, replace=False)
        real_u8 = real_u8[sel]
    # real images into the generator's output space, so both sets enter alike
    real = real_u8.astype(np.float32)
    if bool(cfg.get("rescale", True)):
        real = real / 127.5 - 1.0
    real = torch.from_numpy(real).to(dev)
    if args.scorer_path:
        features = load_scorer(args.scorer_path, outputs="logits",  # raw activations: no prob mapping
                               output_name=args.scorer_output_name, device=dev)
        label = "external features"
    else:
        features = _classifier_fn(cfg, clf, state, workdir, features=True)
        label = "classifier GAP features"
    fid = fid_score(features, generated, real, batch_size=max(int(cfg.batch_size), 1))
    print(f"FID ({label}, {len(generated)} gen vs {len(real)} real): {fid:.3f}")


def cmd_export(args):
    """Servable artifacts of a checkpoint (``export.py``): the classifier
    (uint8 images → logits, the input transform inside) and/or the
    generator ((z, y) → images) as ``torch.export`` programs (``.pt2``) that
    run the Hopper kernels on the card, or every player's weights as an
    ``npz`` in the JAX package's layout."""
    from triplegan_tpu_torch.export import export_artifacts

    if args.quantize and args.format == "npz":  # before any restore
        sys.exit("--quantize applies to traced artifacts (pt2); npz stores the raw f32 parameters")
    cfg, nets, state, workdir, dev, _ = _restore_run(args, mesh=False)
    # ZCA is part of the classifier's transform only: a generator-only or
    # npz export loads no data
    need_zca = args.what in ("classifier", "both") and args.format != "npz"
    written = export_artifacts(cfg, nets, state, args.out or os.path.join(workdir, "export"),
                               what=args.what, fmt=args.format, batch_size=args.batch_size,
                               zca_stats=_load_zca(cfg, workdir) if need_zca else None,
                               quantize=args.quantize, device=dev)
    for path in written:
        print(f"exported: {path}")


def _serve_source(args):
    """The ServingApp of ``serve``'s one source: exported artifacts
    (``--classifier``/``--generator``), a ``params.npz`` (``--params``), or
    the run dir of ``--config``: its newest checkpoint (or ``--step``), with
    ``POST /reload``, else its ``export/params.npz``."""
    from triplegan_tpu_torch.serve import app_from_artifacts, app_from_state
    from triplegan_tpu_torch.utils.platform import resolve_device

    if (args.classifier or args.generator) and (args.config or args.params):
        sys.exit("serve takes ONE source: --config (a run dir's checkpoint, or --params) or "
                 "--classifier/--generator (.pt2 artifacts), not both")
    if args.classifier or args.generator:
        if args.quantize:
            sys.exit("--quantize applies to a checkpoint or npz source; an artifact is quantized "
                     "(or not) at export time")
        for path in (args.classifier, args.generator):
            if path and not os.path.exists(path):
                sys.exit(f"{path}: no such artifact")
        return app_from_artifacts(args.classifier, args.generator, meta={"source": "pt2"},
                                  device=args.device)
    if not args.config:
        sys.exit("serve needs --config (a run dir, or --params) or --classifier/--generator "
                 "(.pt2 artifacts)")
    from triplegan_tpu_torch.configs.base import apply_runtime, make_networks

    cfg = apply_runtime(_load_cfg(args))
    dev = resolve_device(args.device)
    run_dir = os.path.join(cfg.workdir, cfg.name)
    ckpt_dir = os.path.join(run_dir, "ckpt")
    has_ckpt = os.path.isdir(ckpt_dir) and any(n.isdigit() for n in os.listdir(ckpt_dir))
    meta = {"config": cfg.name, "use_pallas": bool(cfg.use_pallas), "compute_dtype": cfg.compute_dtype,
            **({"quantize": args.quantize} if args.quantize else {})}
    if has_ckpt and not args.params:
        from triplegan_tpu_torch.ckpt.manager import CheckpointManager
        from triplegan_tpu_torch.serve import make_checkpoint_reloader
        from triplegan_tpu_torch.train.schedule import make_optimizers
        from triplegan_tpu_torch.train.state import create_state

        nets = make_networks(cfg)
        template = create_state(cfg, nets, make_optimizers(cfg, 1), device=dev)
        ckpt = CheckpointManager(ckpt_dir, write=False)
        state = _restore_at(ckpt, template, args, run_dir)
        zca = _load_zca(cfg, run_dir)
        return app_from_state(
            cfg, nets, state, zca_stats=zca, batch_size=args.batch_size, device=dev,
            quantize=args.quantize, meta={"source": "checkpoint", "step": int(state.step), **meta},
            reloader=make_checkpoint_reloader(cfg, nets, ckpt, template, zca_stats=zca,
                                              quantize=args.quantize, device=dev))
    from triplegan_tpu_torch.bridge import load_npz
    from triplegan_tpu_torch.data.zca import ZCAStats

    params_path = args.params or os.path.join(run_dir, "export", "params.npz")
    if not os.path.exists(params_path):
        sys.exit(
            f"no weights under {run_dir}: no checkpoint in {ckpt_dir} (train one with `python -m "
            f"triplegan_tpu_torch.cli train --config {cfg.name} --workdir ...`) and no {params_path} "
            f"(write it with `python -m triplegan_tpu_torch.cli export --config {cfg.name} "
            f"--workdir ... --format npz`)"
        )
    zca = None
    if cfg.zca:
        zca_path = args.zca or os.path.join(run_dir, "zca_stats.npz")
        if not os.path.exists(zca_path):
            sys.exit(f"config {cfg.name} whitens its input (zca=True): pass --zca PATH "
                     f"to the run's zca_stats.npz (looked for {zca_path})")
        zca = ZCAStats.load(zca_path)
    return app_from_state(cfg, make_networks(cfg), load_npz(params_path), zca_stats=zca,
                          batch_size=args.batch_size, device=dev, quantize=args.quantize,
                          meta={"source": "npz", **meta})


def cmd_serve(args):
    from triplegan_tpu_torch.serve import make_server

    app = _serve_source(args)
    server = make_server(app, host=args.host, port=args.port)
    host, port = server.server_address[:2]
    health = app.health()
    print(f"serving on http://{host}:{port} on {health['device']} ({health['device_name']}) "
          f"(endpoints: {', '.join(health['endpoints'])}; GET /healthz)", flush=True)

    def _sigterm(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _sigterm)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("shutting down", flush=True)
    finally:
        server.server_close()


def cmd_predict(args):
    """Offline batch inference: label a file of raw uint8 images (``.npy``
    NHWC, or an ``.npz`` with an ``images`` array) with the run's
    classifier, or with ``--artifact`` (an exported classifier ``.pt2``, its
    transform inside, no checkpoint needed). Writes an ``.npz`` of
    ``logits`` [N, K] float32, ``probs`` (softmax) and ``labels``
    (argmax)."""
    import numpy as np

    from triplegan_tpu_torch.serve import batched_apply, numpy_fn
    from triplegan_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(args.device)

    def load_images(path):
        try:
            arr = np.load(path, allow_pickle=False)
        except FileNotFoundError:
            sys.exit(f"{path}: no such input file")
        except Exception as e:
            sys.exit(f"{path}: not a readable .npy/.npz ({e})")
        if not isinstance(arr, np.ndarray):  # .npz
            if "images" not in arr:
                sys.exit(f"{path}: .npz input must contain an 'images' array")
            arr = arr["images"]
        if arr.dtype != np.uint8 or arr.ndim != 4:
            sys.exit(f"{path}: images must be uint8 [N,H,W,C], got {arr.dtype} {arr.shape}")
        if len(arr) == 0:
            sys.exit(f"{path}: input holds 0 images")
        return arr

    images = load_images(args.input)
    if args.artifact:
        if args.quantize:
            sys.exit("--quantize applies to the checkpoint source; an artifact is already "
                     "quantized (or not) at export time")
        art = _load_classifier_artifact(args.artifact, dev)
        (shape, _), = art.in_specs
        if tuple(shape[1:]) != tuple(images.shape[1:]):
            sys.exit(f"artifact expects images {tuple(shape[1:])}, input has {tuple(images.shape)}")
        logits = batched_apply(numpy_fn(art, dev), shape[0], images)
    else:
        if not args.config:
            sys.exit("predict needs --config (run dir) or --artifact")
        from triplegan_tpu_torch.export import make_serving_fns

        cfg = _load_cfg(args)
        want = (cfg.image_size, cfg.image_size, cfg.channels)
        if tuple(images.shape[1:]) != want:
            sys.exit(f"{cfg.name} expects images {want}, input has {tuple(images.shape)}")
        cfg, nets, state, workdir, dev, _ = _restore_run(args, mesh=False)
        classify, _ = make_serving_fns(cfg, nets, state, zca_stats=_load_zca(cfg, workdir),
                                       device=dev, quantize=args.quantize)
        logits = batched_apply(numpy_fn(classify, dev), int(args.batch_size or cfg.batch_size), images)

    logits = np.asarray(logits, np.float32)
    e = np.exp(logits - logits.max(axis=-1, keepdims=True))
    probs = e / e.sum(axis=-1, keepdims=True)
    labels = logits.argmax(axis=-1).astype(np.int32)
    np.savez(args.out, logits=logits, probs=probs, labels=labels)
    counts = np.bincount(labels, minlength=logits.shape[-1])
    print(f"predicted {len(labels)} images → {args.out} (class counts: {counts.tolist()})")


def cmd_doctor(args):
    """Every check of ``doctor.py``; exits 1 if and only if one fails."""
    from triplegan_tpu_torch.doctor import format_findings, run_doctor

    cfg = workdir = None
    if args.config:
        from triplegan_tpu_torch.configs.base import apply_runtime

        cfg = apply_runtime(_load_cfg(args))
        workdir = os.path.join(cfg.workdir, cfg.name)
    findings = run_doctor(cfg, workdir, skip_device=args.skip_device,
                          device_timeout_s=args.device_timeout, device=args.device)
    print(format_findings(findings))
    if any(lv == "fail" for lv, _, _ in findings):
        sys.exit(1)


def cmd_prepare(args):
    from triplegan_tpu_torch.data.prepare import prepare

    prepare(args.dataset, args.raw_dir, args.data_dir, download=args.download)
    print(f"prepared {args.dataset} → {args.data_dir}/{args.dataset}")


def _device_arg(value: str) -> str:
    if value in ("cuda", "cpu") or (value.startswith("cuda:") and value[5:].isdigit()):
        return value
    raise argparse.ArgumentTypeError(f"invalid device {value!r}: cuda, cuda:N or cpu")


def main(argv=None):
    p = argparse.ArgumentParser(prog="triplegan_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--config", required=True, help="config name, e.g. cifar10_4k")
        sp.add_argument("--workdir", default=None, help="run root: the run dir is <workdir>/<name>")
        sp.add_argument("--data-dir", default=None,
                        help="prepared shards: <data-dir>/<dataset>/{train,test}.npz")
        sp.add_argument("--set", action="append", metavar="KEY=VALUE")
        sp.add_argument("--device", default="cuda", type=_device_arg,
                        help="cuda (cuda:LOCAL_RANK under torchrun), cuda:N or cpu")

    def step_arg(sp):
        sp.add_argument("--step", type=int, default=None,
                        help="checkpoint step to restore (default: the newest kept)")

    sp = sub.add_parser("train", help="train a Triple-GAN (resumes a run dir's newest checkpoint)")
    common(sp)
    sp.add_argument("--max-steps", type=int, default=None)
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("eval", help="the classifier's test error from a checkpoint")
    common(sp)
    step_arg(sp)
    sp.add_argument("--artifact", default=None,
                    help="qualify an exported classifier .pt2 instead: the test set through the "
                         "artifact (uint8 in, its transform inside); must match the checkpoint's")
    sp.set_defaults(fn=cmd_eval)

    sp = sub.add_parser("sample", help="a class-conditional sample grid from a checkpoint")
    common(sp)
    step_arg(sp)
    sp.add_argument("--out", default="samples.png")
    sp.add_argument("--n-per-class", type=int, default=10)
    sp.add_argument("--seed", type=int, default=0)
    sp.set_defaults(fn=cmd_sample)

    def scorer_args(sp, what):
        sp.add_argument("--scorer-path", default=None,
                        help=f"external {what}: a TF SavedModel dir (needs tensorflow), an .npz "
                             f"probe, or an exported classifier .pt2 (eval/inception.load_scorer)")
        sp.add_argument("--scorer-output-name", default=None,
                        help="output tensor name when the SavedModel signature has several (e.g. pool_3)")

    sp = sub.add_parser("inception", help="inception-style score of conditional samples")
    common(sp)
    step_arg(sp)
    sp.add_argument("--n-samples", type=int, default=5000)
    sp.add_argument("--n-splits", type=int, default=10)
    sp.add_argument("--seed", type=int, default=0)
    scorer_args(sp, "scorer")
    sp.add_argument("--scorer-outputs", default="auto", choices=("auto", "logits", "probs"),
                    help="what the external scorer emits; probabilities (given or detected) are "
                         "log-mapped so that the score's softmax recovers them")
    sp.set_defaults(fn=cmd_inception)

    sp = sub.add_parser("fid", help="Fréchet distance of generated samples vs real data")
    common(sp)
    step_arg(sp)
    sp.add_argument("--n-samples", type=int, default=5000)
    sp.add_argument("--n-real", type=int, default=10000,
                    help="cap on real images used for the data-side stats (0 = all)")
    sp.add_argument("--real-split", default="test", choices=("test", "train"),
                    help="real-side images: test set, or the unlabeled train pool")
    sp.add_argument("--seed", type=int, default=0)
    scorer_args(sp, "feature extractor (default: the checkpoint's classifier GAP features)")
    sp.set_defaults(fn=cmd_fid)

    sp = sub.add_parser("export", help="export servable artifacts from a checkpoint")
    common(sp)
    step_arg(sp)
    sp.add_argument("--out", default=None, help="output directory (default: <workdir>/<name>/export)")
    sp.add_argument("--what", default="both", choices=("classifier", "generator", "both"))
    sp.add_argument("--format", default="pt2", choices=("pt2", "npz"),
                    help="pt2: torch.export programs that run the Hopper kernels on the card; "
                         "npz: every player's weights in the JAX package's layout")
    sp.add_argument("--batch-size", type=int, default=None,
                    help="static serving batch of the artifacts (default: cfg.batch_size)")
    sp.add_argument("--quantize", default=None, choices=("int8",),
                    help="weight-only int8 PTQ stored in the artifact (per-output-channel "
                         "scales; qualify with eval --artifact)")
    sp.set_defaults(fn=cmd_export)

    sp = sub.add_parser("serve", help="HTTP inference server (a run dir's checkpoint, an npz, "
                                      "or .pt2 artifacts)")
    sp.add_argument("--config", default=None, help="serve this config's run dir (or --params)")
    sp.add_argument("--workdir", default=None,
                    help="run root: reads <workdir>/<name>/{config.json,ckpt,zca_stats.npz}")
    sp.add_argument("--params", default=None,
                    help="params.npz in the JAX package's layout (either package's `export --format npz`)")
    sp.add_argument("--zca", default=None, help="zca_stats.npz (for zca configs, with --params)")
    sp.add_argument("--classifier", default=None, help="an exported classifier .pt2 to serve")
    sp.add_argument("--generator", default=None, help="an exported generator .pt2 to serve")
    sp.add_argument("--data-dir", default=None)
    sp.add_argument("--set", action="append", metavar="KEY=VALUE")
    step_arg(sp)
    sp.add_argument("--device", default="cuda", type=_device_arg, help="cuda, cuda:N or cpu")
    sp.add_argument("--batch-size", type=int, default=None,
                    help="static serving batch (checkpoint or npz; default cfg.batch_size; "
                         "requests are chunked and padded)")
    sp.add_argument("--quantize", default=None, choices=("int8",),
                    help="serve the weight-only int8 PTQ variant (checkpoint or npz)")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8000, help="0 binds an ephemeral port")
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("predict", help="batch-label raw images with the trained classifier")
    sp.add_argument("--config", default=None)
    sp.add_argument("--workdir", default=None)
    sp.add_argument("--data-dir", default=None)
    sp.add_argument("--set", action="append", metavar="KEY=VALUE")
    step_arg(sp)
    sp.add_argument("--device", default="cuda", type=_device_arg, help="cuda, cuda:N or cpu")
    sp.add_argument("--input", required=True, help=".npy uint8 NHWC images (or .npz with an 'images' key)")
    sp.add_argument("--out", default="predictions.npz", help="output .npz: logits, probs, labels")
    sp.add_argument("--artifact", default=None,
                    help="predict through an exported classifier .pt2 instead of the checkpoint")
    sp.add_argument("--batch-size", type=int, default=None)
    sp.add_argument("--quantize", default=None, choices=("int8",),
                    help="weight-only int8 PTQ (checkpoint source only)")
    sp.set_defaults(fn=cmd_predict)

    from triplegan_tpu_torch.doctor import DEVICE_TIMEOUT_S

    sp = sub.add_parser("doctor", help="diagnose the deployment: the card and the kernels, versions, "
                                       "config, data, mesh, memory, checkpoints")
    sp.add_argument("--config", default=None, help="also check this config's data, mesh and run dir")
    sp.add_argument("--workdir", default=None)
    sp.add_argument("--data-dir", default=None)
    sp.add_argument("--set", action="append", metavar="KEY=VALUE")
    sp.add_argument("--skip-device", action="store_true", help="skip the device probe (a subprocess)")
    sp.add_argument("--device-timeout", type=int, default=DEVICE_TIMEOUT_S,
                    help=f"seconds before the device probe counts as hung (default {DEVICE_TIMEOUT_S}: "
                         f"importing torch, three cold nvcc builds and the gather's g++ build, with room)")
    sp.add_argument("--device", default="cuda", type=_device_arg,
                    help="cuda: build, launch and check every kernel on the card; cpu: the plain "
                         "versions only")
    sp.set_defaults(fn=cmd_doctor)

    sp = sub.add_parser("prepare", help="convert raw dataset files to npz shards")
    sp.add_argument("--dataset", required=True)
    sp.add_argument("--raw-dir", default="",
                    help="directory of raw dataset files (not needed for digits, shapes, shapes16)")
    sp.add_argument("--data-dir", required=True)
    sp.add_argument("--download", action="store_true",
                    help="first fetch and checksum-verify the raw files into --raw-dir (needs the network)")
    sp.set_defaults(fn=cmd_prepare)

    args = p.parse_args(argv)
    from triplegan_tpu_torch.utils.cache import enable_build_cache

    enable_build_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
