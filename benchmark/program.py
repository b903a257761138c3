"""What the benchmark takes from the program under test besides its entry
points: its config, built from the registry entry the configuration file
names with the file's sizes over it, and a check that the weights the
benchmark makes have the program's layout."""

from __future__ import annotations


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def config(cell):
    """The program's ``ConfigDict`` of ``cell``: the registry entry, the
    configuration file's sizes and the traffic's ``set`` over it."""
    from triplegan_tpu_torch.configs import get_config

    cfg = get_config(cell.config["registry"])
    for key, value in cell.sizes.items():
        if isinstance(value, dict):
            for k, v in value.items():
                if k not in cfg[key]:
                    raise KeyError(f"the program's config has no {key}.{k}")
                cfg[key][k] = _tuples(v)
        else:
            if key not in cfg:
                raise KeyError(f"the program's config has no {key}")
            cfg[key] = _tuples(value)
    return cfg


def check_layout(nets, params: dict, stats: dict) -> None:
    """Raise unless ``params`` and ``stats`` hold exactly the arrays, under
    the same names and shapes, that the program's networks hold."""
    for player, net in zip(("gen", "disc", "clf"), nets):
        want_p, want_s = net.trees()
        for what, want, got in (("parameters", want_p, params[player]), ("statistics", want_s, stats[player])):
            a = {(l, k): tuple(t.shape) for l, arr in want.items() for k, t in arr.items()}
            b = {(l, k): tuple(t.shape) for l, arr in got.items() for k, t in arr.items()}
            if a != b:
                raise ValueError(f"{player}'s {what} differ from the program's layout: program only "
                                 f"{sorted(set(a.items()) - set(b.items()))}, benchmark only "
                                 f"{sorted(set(b.items()) - set(a.items()))}")

