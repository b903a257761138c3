"""Command-line entry points of the port:

    python -m triplegan_tpu_torch.cli train  --config cifar10_4k --workdir runs --data-dir data [--max-steps N]
    python -m triplegan_tpu_torch.cli eval   --config cifar10_4k --workdir runs --data-dir data [--step N]
    python -m triplegan_tpu_torch.cli sample --config cifar10_4k --workdir runs --out grid.png
    python -m triplegan_tpu_torch.cli serve  --config cifar10_4k --workdir runs [--port 8000]
    python -m triplegan_tpu_torch.cli serve  --config cifar10_4k --params params.npz --zca zca_stats.npz

``train`` runs the train driver (``train/loop.py``) in ``<workdir>/<name>``:
metrics, sample grids, checkpoints, and ``config.json``; run again, it
resumes from the newest checkpoint. A run stopped by SIGTERM or a
``<workdir>/<name>/STOP`` file checkpoints and exits with code 75. ``eval``
and ``sample`` restore a checkpoint of that run dir (the newest, or
``--step``). ``serve`` serves weights exported by the JAX package
(``python -m triplegan_tpu.cli export --format npz``, which writes
``<workdir>/<name>/export/params.npz``) with the run dir's
``zca_stats.npz``.

The run dir's ``config.json`` is merged over the named config as the JAX
CLI does, and ``--set key=value`` overrides any config field, e.g.
``--set use_pallas=false`` for plain PyTorch in place of the Hopper
kernels. Every command runs on the card; ``--device cpu`` runs it on the
CPU.

``train``, ``eval`` and ``sample`` run data-parallel under torchrun, one
process a card (``cuda:LOCAL_RANK``; the CPU with ``--device cpu``)::

    torchrun --nproc-per-node N -m triplegan_tpu_torch.cli train --config stl10 --set 'mesh_shape=(N,)' ...

The ranks share the work and the coordinator (rank 0) prints and writes;
a ``mesh_shape`` that is not the number of processes raises.
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


def _restore_run(args):
    """(cfg, networks, restored state, run dir, device, mesh) of the run dir
    that ``args`` names, on ``args.device``; the mesh of ``mesh_shape``
    (None for one process: ``parallel/mesh.py::mesh_for``)."""
    from triplegan_tpu_torch.ckpt.manager import CheckpointManager
    from triplegan_tpu_torch.configs.base import apply_runtime, make_networks
    from triplegan_tpu_torch.parallel.mesh import mesh_for
    from triplegan_tpu_torch.train.schedule import make_optimizers
    from triplegan_tpu_torch.train.state import create_state
    from triplegan_tpu_torch.utils.platform import resolve_device

    cfg = apply_runtime(_load_cfg(args))
    dev = resolve_device(args.device)
    mesh = mesh_for(cfg, dev)
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


def cmd_serve(args):
    from triplegan_tpu_torch.bridge import load_npz
    from triplegan_tpu_torch.configs import make_networks
    from triplegan_tpu_torch.data.zca import ZCAStats
    from triplegan_tpu_torch.serve import app_from_state, make_server

    if not args.params and not args.workdir:
        sys.exit("serve needs --workdir (run dir with export/params.npz) or --params")
    cfg = _load_cfg(args)
    run_dir = os.path.join(args.workdir, cfg.name) if args.workdir else None
    params_path = args.params or os.path.join(run_dir, "export", "params.npz")
    if not os.path.exists(params_path):
        sys.exit(
            f"no weights at {params_path}: write them with `python -m "
            f"triplegan_tpu.cli export --config {cfg.name} --workdir ... --format npz`"
        )
    zca = None
    if cfg.zca:
        zca_path = args.zca or (os.path.join(run_dir, "zca_stats.npz") if run_dir else None)
        if not zca_path or not os.path.exists(zca_path):
            sys.exit(f"config {cfg.name} whitens its input (zca=True): pass --zca PATH "
                     f"to the run's zca_stats.npz (looked for {zca_path})")
        zca = ZCAStats.load(zca_path)
    app = app_from_state(
        cfg, make_networks(cfg), load_npz(params_path), zca_stats=zca,
        batch_size=args.batch_size, device=args.device,
        meta={"source": "npz", "config": cfg.name, "use_pallas": bool(cfg.use_pallas),
              "compute_dtype": cfg.compute_dtype},
    )
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
    sp.set_defaults(fn=cmd_eval)

    sp = sub.add_parser("sample", help="a class-conditional sample grid from a checkpoint")
    common(sp)
    step_arg(sp)
    sp.add_argument("--out", default="samples.png")
    sp.add_argument("--n-per-class", type=int, default=10)
    sp.add_argument("--seed", type=int, default=0)
    sp.set_defaults(fn=cmd_sample)

    sp = sub.add_parser("serve", help="HTTP inference server on the port's networks")
    sp.add_argument("--config", required=True, help="config name, e.g. cifar10_4k")
    sp.add_argument("--workdir", default=None,
                    help="run root: reads <workdir>/<name>/{config.json,export/params.npz,zca_stats.npz}")
    sp.add_argument("--params", default=None, help="params.npz from `triplegan_tpu.cli export --format npz`")
    sp.add_argument("--zca", default=None, help="zca_stats.npz (for zca configs)")
    sp.add_argument("--data-dir", default=None)
    sp.add_argument("--set", action="append", metavar="KEY=VALUE")
    sp.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    sp.add_argument("--batch-size", type=int, default=None,
                    help="static serving batch (default cfg.batch_size; requests are chunked+padded)")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8000, help="0 binds an ephemeral port")
    sp.set_defaults(fn=cmd_serve)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
