"""Command-line entry point of the port:

    python -m triplegan_tpu_torch.cli serve --config cifar10_4k --workdir runs [--port 8000]
    python -m triplegan_tpu_torch.cli serve --config cifar10_4k --params params.npz --zca zca_stats.npz

Weights come from the JAX package's framework-free export
(``python -m triplegan_tpu.cli export --format npz``, which writes
``<workdir>/<name>/export/params.npz``), the ZCA statistics from the run
dir's ``zca_stats.npz``, and the run's ``config.json`` is merged over the
named config as the JAX CLI does. ``--set key=value`` overrides any config
field, e.g. ``--set use_pallas=false`` for the plain PyTorch epilogues.
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


def _load_cfg(args):
    """The named config, the run dir's ``config.json`` merged over it (if
    there is one), then ``--set`` overrides."""
    from triplegan_tpu_torch.configs import get_config
    from triplegan_tpu_torch.configs.base import merge_saved

    try:
        cfg = get_config(args.config)
    except KeyError as e:
        sys.exit(str(e))
    if args.workdir:
        cfg.workdir = args.workdir
        saved = os.path.join(args.workdir, cfg.name, "config.json")
        if os.path.exists(saved):
            merge_saved(cfg, saved)
    return _apply_overrides(cfg, args.set)


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


def main(argv=None):
    p = argparse.ArgumentParser(prog="triplegan_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("serve", help="HTTP inference server on the port's networks")
    sp.add_argument("--config", required=True, help="config name, e.g. cifar10_4k")
    sp.add_argument("--workdir", default=None,
                    help="run root: reads <workdir>/<name>/{config.json,export/params.npz,zca_stats.npz}")
    sp.add_argument("--params", default=None, help="params.npz from `triplegan_tpu.cli export --format npz`")
    sp.add_argument("--zca", default=None, help="zca_stats.npz (for zca configs)")
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
