"""The three-player train step and the eval step: the port of
``triplegan_tpu/train/step.py``.

One iteration runs three sequential updates, as the reference's three
``sess.run``s do:

1. D's update, with G and C at their current values;
2. G's update, scored by the *new* D;
3. C's update, seeing the new D and the new G (and G's new BN stats).

Each gradient goes only to the player being updated: its parameters are
the only tensors that require grad in its pass, and ``torch.autograd.grad``
takes the loss's gradient with respect to them (so no filter gradient of
another player's convs is computed). Images another player generated are
detached, as JAX's ``stop_gradient`` does.

Batch-norm running stats advance only in their own player's pass; the
cross-forwards run in train mode but their new stats are dropped. So do a
spectrally normalised D's power-iteration vectors: D's update makes one
iteration from the kept u (its own phase, ``sn``, before ``d_grad``), its
3B-row forward uses them and they become D's new stats; G's and C's
updates call D with those and drop what their calls return. C's
stats chain labeled → unlabeled → generated, or unlabeled → labeled →
generated under ``share_pseudo_forward``; under ``fused_clf_forward`` C
runs one pass over the three streams concatenated (3B rows), whose batch
norm normalizes them jointly, as the JAX option does. D's three kinds of pairs go
through one batched forward of 3B rows (D has no BN, so this is exact).

``share_pseudo_forward`` keeps the graph of C's unlabeled-stream forward,
taken before D's update at C's current parameters, and feeds those logits
to C's loss, so C's gradient flows back through them: the torch form of
JAX's VJP graft.

Randomness (noise, dropout, augmentation, pseudo-label sampling) comes from
one device generator per step, seeded from (state.seed, state.step); the
batch sampler has its own, seeded from (state.seed, state.step, 0x5A5A).
The streams are PyTorch's, not JAX's threefry bits.

A step is a ``TrainStep``: its ``body(state, x, gens, sc)`` takes the
step's generators and its scalars (``SCALARS``: α_P, the lr fraction and
each Adam's lr and bias corrections, computed on the host in float64 and
rounded once to float32) on the device from its caller, and reads nothing
of the step on the host. Called as ``step(state, x)``, it makes both from
(state.seed, state.step) and copies the scalars to the device; the chunk
of ``make_scan_device_train_step`` passes generators that a CUDA graph has
registered and re-seeds them before each replay, and a static scalars
tensor that it refills, so the graph replays exactly what the eager steps
compute.

Under data parallelism (``mesh``, ``parallel/mesh.py``; JAX's
``axis_name``) each rank runs the same step on its rows of the batch:
G's and C's batch norms sync their moments, C's REINFORCE baseline is the
global mean, each player's gradients are averaged over the ranks before
its Adam (one flattened all-reduce a player) and so are the loss metrics;
every generator's seed mixes in the rank (JAX folds in ``axis_index``), so
the ranks' noise, dropout, augmentation and draws differ while their
states stay equal.

The body opens the step's phases in order (``utils/profiling.py::
phase``): ``d_reg`` (the lazy R1 update of D, on the steps that carry
one), ``sn`` (a spectrally normalised D's power iterations; only
there), ``d_grad``, ``d_adam``, ``g_grad``, ``g_adam``, ``c_grad``,
``c_adam``, each a player's update before its Adam and the Adam, and
``end``, which closes the last. A phase lasts until the next opens. Each
opening is a host span in a trace and, on the card, a launch of the
phase's mark kernel, which a CUDA graph replays, so a trace of a replay
divides by phase. Under ``share_pseudo_forward`` C's unlabeled forward
runs in ``d_grad``; under a mesh each player's all-reduce falls in its
``*_grad`` phase. The marks change no value.

StyleGAN2's lazy regularisation (``r1_interval`` k > 0 in the config):
every step whose number is a multiple of k opens with an update of D by
R1 alone, (γ/2)·k·mean ‖∇ₓD(x, y)‖² over the real labelled pairs of D's
stream (``r1_gamma`` γ; the gradient taken with ``create_graph``, so the
penalty's gradient runs the kernels' second-order Functions), and one
Adam step of D's state; D's main update then starts from there, so D's
Adam count advances by two on such a step (``TrainStep.updates``). That
step preprocesses D's labelled images in ``d_reg`` and its main update
reuses them, so every draw of the step is the plain step's. A G with an
EMA copy (``ema_update``) has it lerped after G's Adam with β =
0.5^(B / min(ema_kimg·1000, ema_rampup·B·step)), a scalar of the step. D
is called with the number of row streams it is given (``streams``: the
D update's 3B rows are three) where it takes one.
"""

from __future__ import annotations

import dataclasses
import os
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from triplegan_tpu_torch.data import ondevice
from triplegan_tpu_torch.data.zca import apply_zca
from triplegan_tpu_torch.train import losses
from triplegan_tpu_torch.train.schedule import AdamState, alpha_p_schedule, linear_decay_schedule
from triplegan_tpu_torch.train.state import TrainState
from triplegan_tpu_torch.utils.profiling import phase, span

METRICS = ("loss_d", "loss_g", "loss_c", "d_real", "d_cla", "d_gen", "c_sup", "c_adv",
           "c_pseudo", "alpha_p", "lr_frac")
PLAYERS = ("gen", "disc", "clf")
# what a step reads of its step number, in this order: α_P, the lr
# fraction, then each player's Adam lr and bias corrections
SCALARS = ("alpha_p", "lr_frac") + tuple(f"{v}_{p}" for p in PLAYERS for v in ("lr", "bc1", "bc2"))
_SAMPLER_DOMAIN = 0x5A5A


def compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def _mixed_seed(seed: int, step: int, domain: int, rank: Optional[int] = None) -> int:
    mixed = ((seed * 1_000_003 + step) * 0x9E3779B1 + domain) % (1 << 63)
    if rank is None:  # one process
        return mixed
    return (mixed * 0x85EBCA6B + rank + 1) % (1 << 63)


def step_generator(device: torch.device, seed: int, step: int, domain: int = 0) -> torch.Generator:
    """A generator on ``device`` whose stream depends only on (seed, step,
    domain)."""
    return torch.Generator(device=device).manual_seed(_mixed_seed(seed, step, domain))


def _upload(host: torch.Tensor, dev: torch.device, out: torch.Tensor = None) -> torch.Tensor:
    """A CPU tensor on ``dev`` (copied into ``out`` if given) with no host
    sync: on the card through pinned memory, whose block the caching
    allocator keeps until the copy has run."""
    if dev.type == "cuda":
        host = host.pin_memory()
    if out is None:
        return host.to(dev, non_blocking=True)
    return out.copy_(host, non_blocking=True)


def _with_grad(tree):
    return {layer: {k: t.detach().requires_grad_(True) for k, t in arrays.items()}
            for layer, arrays in tree.items()}


def _leaves(tree):
    return [t for arrays in tree.values() for t in arrays.values()]


def _like(tree, flat):
    it = iter(flat)
    return {layer: {k: next(it) for k in arrays} for layer, arrays in tree.items()}


def _device(state: TrainState) -> torch.device:
    return next(t for arrays in state.params["clf"].values() for t in arrays.values()).device


class TrainStep:
    """``step(state, x) -> (state, metrics)``, one update of the three
    players. ``body(state, x, gens, sc)`` is the step itself: ``gens`` its
    generators, one per entry of ``domains``, and ``sc`` its ``SCALARS`` as
    a float32 vector on the state's device; the body reads neither the
    step nor any device value on the host. ``values(step, counts, reg)``
    gives the scalars on the host in float64, ``counts`` each Adam's count
    and ``reg`` whether the step opens with D's R1 update
    (``regularises``, the one place that decides it).
    ``mesh`` is the mesh the body's collectives run over (None: one
    process); the generators' seeds mix in its rank. ``metrics`` names the
    0-d tensors the body's metrics hold."""

    def __init__(self, body: Callable, values: Callable, domains: Sequence[int], mesh=None,
                 metrics: Sequence[str] = METRICS, reg_every: int = 0):
        self.body, self.values, self.domains, self.mesh = body, values, tuple(domains), mesh
        self.metrics = tuple(metrics)
        self.reg_every = int(reg_every)

    def regularises(self, step: int) -> bool:
        """Whether step ``step`` opens with D's lazy R1 update: the body then
        takes ``reg=True``."""
        return self.reg_every > 0 and step % self.reg_every == 0

    def pattern(self, step: int, n: int) -> Tuple[bool, ...]:
        """``regularises`` of the ``n`` steps from ``step`` on."""
        return tuple(self.regularises(step + i) for i in range(n))

    def run_body(self, state, x, gens, sc, reg: bool):
        return self.body(state, x, gens, sc, **({"reg": True} if reg else {}))

    def updates(self, step: int) -> Dict[str, int]:
        """Each Adam's updates in step ``step``: one, and D's R1 update."""
        reg = self.regularises(step)
        return {p: 1 + (reg and p == "disc") for p in PLAYERS}

    def counts_after(self, counts: Dict[str, int], step: int, n: int) -> Dict[str, int]:
        """Each Adam's count after the ``n`` steps from ``step`` on."""
        counts = dict(counts)
        for i in range(n):
            for p, k in self.updates(step + i).items():
                counts[p] = counts.get(p, 0) + k
        return counts

    def seed_of(self, seed: int, step: int, domain: int) -> int:
        return _mixed_seed(seed, step, domain, None if self.mesh is None else self.mesh.rank)

    def generators(self, device: torch.device, seed: int, step: int) -> List[torch.Generator]:
        return [torch.Generator(device=device).manual_seed(self.seed_of(seed, step, d)) for d in self.domains]

    def scalars(self, state: TrainState, n: int = 1) -> torch.Tensor:
        """The scalars of the ``n`` steps from ``state`` on, (n,
        len(SCALARS)) float32 on the CPU: float64 values rounded once."""
        counts = {p: o.count for p, o in state.opt.items()}
        rows = [self.values(state.step + i, self.counts_after(counts, state.step, i), self.regularises(state.step + i))
                for i in range(n)]
        return torch.tensor(rows, dtype=torch.float64).float()

    def __call__(self, state: TrainState, x):
        dev = _device(state)
        return self.run_body(state, x, self.generators(dev, state.seed, state.step),
                             _upload(self.scalars(state), dev)[0], self.regularises(state.step))


class _Zca:
    """The ZCA arrays on the step's device, made once per device."""

    def __init__(self, stats):
        self.stats = stats
        self.on: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def get(self, dev):
        if self.stats is None:
            return None, None
        if dev not in self.on:
            self.on[dev] = (torch.as_tensor(self.stats.mean, device=dev),
                            torch.as_tensor(self.stats.whiten, device=dev))
        return self.on[dev]


def make_train_step(cfg, nets, optimizers, total_steps: int, zca_stats=None,
                    pseudo_label_mode: str = "sample", mesh=None) -> TrainStep:
    """``(state, batch) -> (state, metrics)``. ``batch`` is the nested dict
    of ``_make_batch_sampler``: streams "d" and "c" with uint8 ``x_l``,
    ``x_u`` (none in "c" under ``share_pseudo_forward``), int ``y_l``, float
    ``z`` and int ``y_g``; stream "g" with ``z`` and ``y_g``. ``metrics``
    holds the 11 scalars of ``METRICS`` as 0-d float32 tensors on the
    state's device. Its body takes one generator. Under ``mesh`` the batch
    is this rank's rows (``Mesh.rank_rows`` of the global batch) and the
    step computes the global batch's update on every rank."""
    gen, disc, clf = nets
    opt_g, opt_d, opt_c = optimizers["gen"], optimizers["disc"], optimizers["clf"]
    alpha = float(cfg.alpha)
    cdt = compute_dtype(cfg)
    steps_per_epoch = max(total_steps // max(int(cfg.epochs), 1), 1)
    ap_sched = alpha_p_schedule(
        float(cfg.alpha_p),
        int(cfg.alpha_p_warmup_epochs) * steps_per_epoch,
        int(cfg.get("alpha_p_ramp_epochs", 0)) * steps_per_epoch,
    )
    lr_now = linear_decay_schedule(1.0, int(cfg.lr_decay_start_frac * total_steps), total_steps)
    zca = _Zca(zca_stats)
    share_fwd = bool(cfg.get("share_pseudo_forward", False))
    fused_clf = bool(cfg.get("fused_clf_forward", False))
    if share_fwd and fused_clf:
        raise ValueError(
            "share_pseudo_forward and fused_clf_forward are mutually "
            "exclusive: the shared-forward C update replaces the fused "
            "3B-row pass entirely, so enabling both would silently measure "
            "shared-only. Pick one."
        )
    non_saturating = bool(cfg.non_saturating_g)
    spectral = getattr(disc, "power_iteration", None)  # a spectrally normalised D
    ema = getattr(gen, "ema_update", None)  # a G with an EMA copy
    reg_every = int(cfg.get("r1_interval", 0) or 0)
    r1_weight = float(cfg.get("r1_gamma", 0.0)) / 2.0 * reg_every
    d_kw = {"streams": 3} if getattr(disc, "mbstd_group", None) else {}  # D's update: three row streams
    extra = ema is not None or reg_every > 0
    if extra and mesh is not None:
        raise ValueError("an EMA copy of G and the lazy R1 update run on one process")
    global_b = int(cfg.batch_size)

    def ema_beta(step: int) -> float:
        if ema is None:
            return 0.0
        nimg = min(float(cfg.gen.ema_kimg) * 1000.0, float(cfg.gen.ema_rampup) * step * global_b)
        return 0.5 ** (global_b / max(nimg, 1e-8))

    def pmean(tree):
        return tree if mesh is None else mesh.pmean_tree(tree)

    def values(step: int, counts: Dict[str, int], reg: bool) -> List[float]:
        """``SCALARS`` at step ``step`` from the counts at its start, and
        where the step has them, the EMA's β and the R1 update's Adam
        scalars (where ``reg``, D's main update reads D's count after
        it)."""
        main = dict(counts, disc=counts["disc"] + reg)
        out = [ap_sched(step), lr_now(step), *(v for p in PLAYERS for v in optimizers[p].scalars(main[p]))]
        if extra:
            out += [ema_beta(step), *optimizers["disc"].scalars(counts["disc"])]
        return out

    def body(state: TrainState, batch, gens, sc, reg: bool = False) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        dev = _device(state)
        (rng,) = gens
        alpha_p_now, lr_frac = sc[0], sc[1]
        adam = {p: sc[2 + 3 * i:5 + 3 * i].unbind() for i, p in enumerate(PLAYERS)}
        params, bn = state.params, state.bn
        opt_d_state = state.opt["disc"]
        zm, zw = zca.get(dev)

        def preprocess(x_uint8):
            return ondevice.standard_pipeline(
                x_uint8, generator=rng, translate=int(cfg.aug_translate),
                flip=bool(cfg.aug_flip), pad_mode=str(cfg.get("aug_pad_mode", "reflect")),
                zca_mean=zm, zca_whiten=zw, train=True, dtype=cdt,
                zca_first=cfg.get("aug_order", "zca_first") == "zca_first",
                do_rescale=bool(cfg.get("rescale", True)),
            )

        def whiten_gen(x_raw):
            return apply_zca(x_raw, zm, zw) if zm is not None else x_raw

        bd = batch["d"]
        y_l, y_gd = bd["y_l"].long(), bd["y_g"].long()
        if reg:  # ============ D's lazy R1 update, on the real labelled pairs ====
            phase("d_reg", dev)
            x_l = preprocess(bd["x_l"])
            x_r = x_l.detach().requires_grad_(True)
            pr = _with_grad(params["disc"])
            logit_r, _ = disc.apply(pr, bn["disc"], x_r, y_l, train=True, generator=rng)
            (g_x,) = torch.autograd.grad(logit_r.sum(), x_r, create_graph=True)
            r1 = torch.mean(torch.sum(torch.square(g_x), dim=tuple(range(1, g_x.dim())))) * r1_weight
            # a leaf R1 does not reach (a bias past the last activation) takes a zero
            # gradient, as StyleGAN2-ADA's real_logits * 0 term gives it
            gr = _like(pr, torch.autograd.grad(r1, _leaves(pr), allow_unused=True, materialize_grads=True))
            pd_r, opt_d_state = opt_d.update(params["disc"], gr, opt_d_state, sc[12:15].unbind())
            params = dict(params, disc=pd_r)
            del x_r, logit_r, g_x, gr, pr

        # ================= D update (G, C at their current values) ==========
        d_sn = {}
        if spectral is not None:  # D's power iterations, from the kept u
            phase("sn", dev)
            d_sn = {"sn": spectral(params["disc"], bn["disc"])}
        phase("d_grad", dev)
        if not reg:
            x_l = preprocess(bd["x_l"])
        x_u = preprocess(bd["x_u"])
        z_d = bd["z"].to(cdt)
        with torch.no_grad():
            x_g = whiten_gen(gen.apply(params["gen"], bn["gen"], z_d, y_gd, train=True, mesh=mesh, generator=rng)[0])
        pc = _with_grad(params["clf"])
        if share_fwd:
            logits_c_u, bn_u = clf.apply(pc, bn["clf"], x_u, train=True, generator=rng, mesh=mesh)
        else:
            with torch.no_grad():
                logits_c_u, _ = clf.apply(params["clf"], bn["clf"], x_u, train=True, generator=rng,
                                          mesh=mesh)
        y_c = losses.sample_pseudo_labels(rng, logits_c_u, pseudo_label_mode)

        b = x_l.shape[0]
        pd = _with_grad(params["disc"])
        logit_all, bn_d_new = disc.apply(pd, bn["disc"], torch.cat([x_l, x_u, x_g]),
                                         torch.cat([y_l, y_c, y_gd]), train=True, generator=rng, **d_sn, **d_kw)
        lr_real, lr_cla, lr_gen = logit_all[:b], logit_all[b:2 * b], logit_all[2 * b:]
        d_total = losses.d_loss(lr_real, lr_cla, lr_gen, alpha)
        d_terms = losses.d_loss_terms(lr_real, lr_cla, lr_gen, alpha)
        gd = pmean(_like(pd, torch.autograd.grad(d_total, _leaves(pd))))
        phase("d_adam", dev)
        pd_new, opt_d_new = opt_d.update(params["disc"], gd, opt_d_state, adam["disc"])

        # ================= G update (scored by the new D) ====================
        phase("g_grad", dev)
        bg = batch["g"]
        z_g, y_gg = bg["z"].to(cdt), bg["y_g"].long()
        pg = _with_grad(params["gen"])
        x_raw, bn_g_new = gen.apply(pg, bn["gen"], z_g, y_gg, train=True, mesh=mesh, generator=rng)
        logit_g, _ = disc.apply(pd_new, bn_d_new, whiten_gen(x_raw), y_gg, train=True,
                                generator=rng)
        g_total = losses.g_loss(logit_g, alpha, non_saturating)
        gg = pmean(_like(pg, torch.autograd.grad(g_total, _leaves(pg))))
        phase("g_adam", dev)
        pg_new, opt_g_new = opt_g.update(params["gen"], gg, state.opt["gen"], adam["gen"])
        if ema is not None:
            bn_g_new = ema(pg_new, bn_g_new, sc[11])

        # ================= C update (sees the new D and G) ===================
        phase("c_grad", dev)
        bc = batch["c"]
        x_l_c = preprocess(bc["x_l"])
        x_u_c = x_u if share_fwd else preprocess(bc["x_u"])
        y_l_c, y_gc = bc["y_l"].long(), bc["y_g"].long()
        z_c = bc["z"].to(cdt)
        with torch.no_grad():
            x_g_c = whiten_gen(gen.apply(pg_new, bn_g_new, z_c, y_gc, train=True, mesh=mesh, generator=rng)[0])
        if share_fwd:
            log_u, y_c2 = logits_c_u, y_c
            log_l, s1 = clf.apply(pc, bn_u, x_l_c, train=True, generator=rng, mesh=mesh)
            log_g, s3 = clf.apply(pc, s1, x_g_c, train=True, generator=rng, mesh=mesh)
        else:
            if fused_clf:
                # one 3B-row pass: BN normalizes the three streams jointly
                log_all, s3 = clf.apply(pc, bn["clf"], torch.cat([x_l_c, x_u_c, x_g_c]),
                                        train=True, generator=rng, mesh=mesh)
                nb = x_l_c.shape[0]
                log_l, log_u, log_g = log_all[:nb], log_all[nb:2 * nb], log_all[2 * nb:]
            else:
                log_l, s1 = clf.apply(pc, bn["clf"], x_l_c, train=True, generator=rng, mesh=mesh)
                log_u, s2 = clf.apply(pc, s1, x_u_c, train=True, generator=rng, mesh=mesh)
                log_g, s3 = clf.apply(pc, s2, x_g_c, train=True, generator=rng, mesh=mesh)
            y_c2 = losses.sample_pseudo_labels(rng, log_u, pseudo_label_mode)
        with torch.no_grad():  # the D signal is stop-gradiented in L_C
            logit_d_cla, _ = disc.apply(pd_new, bn_d_new, x_u_c, y_c2, train=True,
                                        generator=rng)
        c_total, c_terms = losses.c_loss(log_l, y_l_c, logit_d_cla, log_u, y_c2, log_g, y_gc,
                                         alpha, alpha_p_now, mesh)
        gc = pmean(_like(pc, torch.autograd.grad(c_total, _leaves(pc))))
        phase("c_adam", dev)
        pc_new, opt_c_new = opt_c.update(params["clf"], gc, state.opt["clf"], adam["clf"])
        phase("end", dev)

        new_state = TrainState(
            params={"gen": pg_new, "disc": pd_new, "clf": pc_new},
            bn={"gen": bn_g_new, "disc": bn_d_new, "clf": s3},
            opt={"gen": opt_g_new, "disc": opt_d_new, "clf": opt_c_new},
            step=state.step + 1,
            seed=state.seed,
        )
        metrics = {"loss_d": d_total, "loss_g": g_total, "loss_c": c_total, **d_terms,
                   **c_terms}
        metrics = pmean({k: v.detach().float() for k, v in metrics.items()})
        metrics["alpha_p"], metrics["lr_frac"] = alpha_p_now, lr_frac
        return new_state, metrics

    return TrainStep(body, values, (0,), mesh, reg_every=reg_every)


def _make_batch_sampler(cfg):
    """``(seed, step_no, device_data) -> batch``: per-player sub-batches
    drawn on the data's device from a generator seeded by (seed, step_no),
    so any grouping of steps draws the same sequence. Under
    ``share_pseudo_forward`` the "c" stream's x_u is not gathered (the C
    update reuses D's); its indices are still drawn, so the flag leaves
    every used field's sequence unchanged."""
    draw = _make_batch_draw(cfg)

    def sample(seed: int, step_no: int, data):
        return draw(step_generator(data["x_l"].device, seed, step_no, _SAMPLER_DOMAIN), data)

    return sample


def _make_batch_draw(cfg, n_shards: int = 1):
    """``(generator, device_data) -> batch``: ``_make_batch_sampler``'s
    draw from a given generator, ``batch_size // n_shards`` rows a stream
    (a rank's share under a mesh of ``n_shards``)."""
    b = int(cfg.batch_size) // n_shards
    z_dim, n_classes = int(cfg.z_dim), int(cfg.num_classes)
    share_fwd = bool(cfg.get("share_pseudo_forward", False))

    def draw(g: torch.Generator, data):
        dev = data["x_l"].device

        def noise():
            return {"z": torch.randn((b, z_dim), generator=g, device=dev),
                    "y_g": torch.randint(0, n_classes, (b,), generator=g, device=dev)}

        def stream(with_unlabeled=True):
            il = torch.randint(0, data["x_l"].shape[0], (b,), generator=g, device=dev)
            iu = torch.randint(0, data["x_u"].shape[0], (b,), generator=g, device=dev)
            out = {"x_l": data["x_l"][il], "y_l": data["y_l"][il], **noise()}
            if with_unlabeled:
                out["x_u"] = data["x_u"][iu]
            return out

        return {"d": stream(), "c": stream(with_unlabeled=not share_fwd), "g": noise()}

    return draw


def upload_device_data(data, device=None) -> Dict[str, torch.Tensor]:
    """The dataset's training arrays on the device (uint8 images, int64
    labels), for ``make_device_train_step``."""
    from triplegan_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    return {"x_l": torch.as_tensor(data.x_label, device=dev),
            "y_l": torch.as_tensor(data.y_label, device=dev).long(),
            "x_u": torch.as_tensor(data.x_unlabel, device=dev)}


def make_device_train_step(cfg, nets, optimizers, total_steps: int, zca_stats=None,
                           pseudo_label_mode: str = "sample", mesh=None) -> TrainStep:
    """``(state, device_data) -> (state, metrics)``: the dataset stays on
    the device (``upload_device_data``) and each step draws its own
    sub-batches there. Its body takes two generators: the core step's and
    the sampler's (domain 0x5A5A). Under ``mesh`` every rank holds the
    whole dataset and draws ``batch_size // world`` rows a stream from its
    own sampler stream (JAX's ``n_shards`` is the mesh's world)."""
    core = make_train_step(cfg, nets, optimizers, total_steps, zca_stats, pseudo_label_mode, mesh)
    draw = _make_batch_draw(cfg, 1 if mesh is None else mesh.world)

    def body(state: TrainState, data, gens, sc, reg: bool = False):
        rng, rng_batch = gens
        return core.run_body(state, draw(rng_batch, data), (rng,), sc, reg)

    return TrainStep(body, core.values, (0, _SAMPLER_DOMAIN), mesh, reg_every=core.reg_every)


# ---------------------------------------------------------------------------
# Several steps a call: JAX's lax.scan chunk
# ---------------------------------------------------------------------------


def _reduce_scan_metrics(ms: Dict[str, torch.Tensor], mode: str) -> Dict[str, torch.Tensor]:
    """Collapse a chunk's metrics stacked per step ({name: (K,) tensor}):
    ``"last"`` is what a per-step log interval would read; ``"mean"``
    averages over the chunk, so a loss curve keeps every step's
    information."""
    if mode == "mean":
        return {k: torch.mean(v, dim=0) for k, v in ms.items()}
    if mode == "last":
        return {k: v[-1] for k, v in ms.items()}
    raise ValueError(f"scan_metrics must be last|mean, got {mode!r}")


def _stacked(ms: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}


def make_scan_train_step(step_fn, n_steps: int, metrics_mode: str = "last"):
    """``n_steps`` calls of ``step_fn(state, data)`` on the same ``data`` as
    one call, metrics reduced per ``metrics_mode``: JAX's ``lax.scan``
    chunk, as a loop on the host. The driver's chunk is
    ``make_scan_device_train_step``, a CUDA graph on the card."""

    def scanned(state, data):
        ms = []
        for _ in range(n_steps):
            state, m = step_fn(state, data)
            ms.append(m)
        return state, _reduce_scan_metrics(_stacked(ms), metrics_mode)

    return scanned


def make_scan_device_train_step(cfg, nets, optimizers, total_steps: int, n_steps: int, zca_stats=None,
                                pseudo_label_mode: str = "sample", metrics_mode: str = "last",
                                log=print, mesh=None) -> "ScanChunk":
    """``(state, device_data) -> (state, metrics)``: ``n_steps`` steps of
    ``make_device_train_step`` a call, as a ``ScanChunk`` (a CUDA graph on
    the card). ``log`` takes the line that describes each capture."""
    step = make_device_train_step(cfg, nets, optimizers, total_steps, zca_stats, pseudo_label_mode, mesh)
    return ScanChunk(step, n_steps, metrics_mode, log)


class GraphCaptureError(RuntimeError):
    """A chunk could not be captured as a CUDA graph: its step did
    something on the host that a replay cannot repeat."""


def _tree_tensors(tree):
    for v in tree.values():
        yield from _tree_tensors(v) if isinstance(v, dict) else (v,)


def _state_tensors(state: TrainState):
    for tree in (state.params, state.bn, *(o.mu for o in state.opt.values()),
                 *(o.nu for o in state.opt.values())):
        yield from _tree_tensors(tree)


def _copy_tree(dst, src) -> None:
    for k, d in dst.items():
        if isinstance(d, dict):
            _copy_tree(d, src[k])
        else:
            d.copy_(src[k])


def _copy_into(dst: TrainState, src: TrainState) -> None:
    """Write ``src``'s values into ``dst``'s tensors, matched by name."""
    with torch.no_grad():
        _copy_tree(dst.params, src.params)
        _copy_tree(dst.bn, src.bn)
        for p, o in dst.opt.items():
            _copy_tree(o.mu, src.opt[p].mu)
            _copy_tree(o.nu, src.opt[p].nu)


def _clone_tree(tree):
    return {k: _clone_tree(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _clone_state(state: TrainState) -> TrainState:
    return dataclasses.replace(state, params=_clone_tree(state.params), bn=_clone_tree(state.bn),
                               opt={p: AdamState(o.count, _clone_tree(o.mu), _clone_tree(o.nu))
                                    for p, o in state.opt.items()})


# Frames a failed capture's message skips: torch's and the Python library's
_LIBRARY_DIRS = (os.path.dirname(torch.__file__), os.path.dirname(os.__file__))


def _capture_failure(exc: BaseException, n_steps: int) -> str:
    """What a failed capture says: the innermost line outside torch, the
    Python library and the chunk's own frames that the first error went
    through, and that error."""
    chain = []
    e = exc
    while e is not None and e not in chain:
        chain.append(e)
        e = e.__cause__ or e.__context__
    where = "an unknown line"
    for e in reversed(chain):
        frames = [f for f in traceback.extract_tb(e.__traceback__)
                  if not f.filename.startswith(_LIBRARY_DIRS)
                  and not (f.filename == os.path.abspath(__file__) and f.name in ("_capture", "_chunk"))]
        if frames:
            f = frames[-1]
            where = f"{os.path.basename(f.filename)}:{f.lineno} ({f.line})"
            break
    root = chain[-1]
    text = " ".join(str(root).split("\n")[:3])
    return (f"capturing {n_steps} train steps as a CUDA graph failed at {where}: "
            f"{type(root).__name__}: {text}. A captured step may not read a device value on the host "
            f"(.item(), float(), int(), bool() of a tensor), copy a host tensor to the card, or draw "
            f"from a generator the graph has not registered. Nothing ran eagerly in its place.")


def _graph_nodes(graph) -> int:
    """The node count of a captured (not yet destroyed) CUDA graph, from
    the driver's ``cuGraphGetNodes``."""
    import ctypes

    fn = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    fn.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    rc = fn(graph.raw_cuda_graph(), None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {rc}")
    return n.value


def _pool_bytes(pool) -> int:
    """Bytes the caching allocator holds in a graph's private pool."""
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == tuple(pool))


class ScanChunk:
    """``(state, device_data) -> (state, metrics)``: ``n_steps`` steps of a
    device-data ``TrainStep`` a call, each step computing exactly what the
    eager step at its step number computes; the metrics reduced per
    ``metrics_mode`` (``_reduce_scan_metrics``).

    On the card the chunk is one CUDA graph. The first call (or
    ``prepare``) warms the step up on a clone of the state on a side
    stream (one eager step, so lazy set-up happens outside the capture),
    then captures the n steps into one graph, their 2·n generators
    registered with it and their scalars a static (n, len(SCALARS)) tensor,
    and instantiates it. A step that carries D's lazy R1 update
    (``TrainStep.regularises``) runs other work than a plain one, so the
    chunk keeps a graph for each pattern of such steps its calls meet (with
    n dividing the interval, one whose first step carries it and one of
    plain steps), each captured at the first call that needs it after a
    warm-up step of each kind it holds, all in one memory pool (they never
    run at once), and picks one by the call's first step. Every call re-seeds the generators on the host to
    the seeds the eager steps would draw from, copies the n steps' scalars
    (computed on the host) into the static tensor and replays the graph:
    one dispatch for n steps. The graph keeps every step's metrics; the
    reduction runs after the replay, so both modes replay one graph. A
    call whose state or data tensors lie elsewhere in memory, or under
    another ``cudnn.deterministic``, captures anew. A capture that fails
    raises ``GraphCaptureError`` naming the op; the chunk never runs
    eagerly in its place. The kernel wrappers count their launches at
    capture (and in the warm-up step), not at replays. A trace names the
    call, its replay and a capture as the spans ``tg::chunk.call``,
    ``tg::chunk.replay`` and ``tg::chunk.capture``. ``captures``,
    ``replays``, ``captured_steps``, ``warmup_steps`` and ``graph_stats``
    (the current graph's nodes, seconds to capture and instantiate, and
    pool bytes) say what happened; ``step_metrics`` holds the last call's
    metrics of every step ({name: (n,) tensor}).

    On the CPU the same chunk runs eagerly, through the same code.

    Under a mesh the step's collectives are part of the chunk. With NCCL
    they are captured into the graph (one all-reduce first warms the
    communicator up, which NCCL creates lazily and cannot create inside a
    capture). Gloo's collectives stage through the host and cannot be
    captured: a chunk on a CUDA device under a gloo group raises
    ``GraphCaptureError`` naming the backend, and nothing runs eagerly in
    its place.

    Donation, as JAX's ``donate_argnums=0``: the chunk writes the new
    values into the state's own tensors, and the state it returns holds
    those tensors (step and Adam counts advanced by n). A caller that keeps
    an older state must clone it first. The metrics are fresh tensors."""

    def __init__(self, step: TrainStep, n_steps: int, metrics_mode: str = "last", log=print):
        if n_steps < 1:
            raise ValueError(f"a chunk needs at least one step, got {n_steps}")
        _reduce_scan_metrics({}, metrics_mode)  # a bad mode raises here
        self.step, self.n, self.mode, self.log = step, int(n_steps), metrics_mode, log
        self.captures = self.replays = self.captured_steps = self.warmup_steps = 0
        self.graph_stats: Dict[str, float] = {}
        self.step_metrics: Dict[str, torch.Tensor] = {}
        self._graphs: Dict[Tuple[bool, ...], tuple] = {}  # pattern → (graph, gens, scalars, metrics)
        self._key = self._pool = None

    def _chunk(self, state, data, gens, sc, pattern):
        """The chunk's work, eager on the CPU and captured on the card: the
        new state and the metrics stacked per step."""
        ms = []
        for i in range(self.n):
            state, m = self.step.run_body(state, data, gens[i], sc[i], pattern[i])
            ms.append(m)
        return state, _stacked(ms)

    def _advanced(self, state: TrainState) -> TrainState:
        counts = self.step.counts_after({p: o.count for p, o in state.opt.items()}, state.step, self.n)
        return dataclasses.replace(state, step=state.step + self.n,
                                   opt={p: AdamState(counts[p], o.mu, o.nu) for p, o in state.opt.items()})

    def _key_of(self, state: TrainState, data) -> tuple:
        return (tuple(t.data_ptr() for t in _state_tensors(state)),
                tuple((t.data_ptr(), tuple(t.shape)) for t in data.values()),
                torch.backends.cudnn.deterministic)

    def prepare(self, state: TrainState, data) -> None:
        """On the card, capture the graph for this state and data now
        unless the current one fits them; a call does this by itself, and
        a caller may do it first to keep the capture out of a timed call.
        Changes no value of the state."""
        if _device(state).type == "cuda":
            key = self._key_of(state, data)
            if key != self._key:
                self._graphs, self._key, self._pool = {}, None, None  # the old graphs' pool goes first
            pattern = self.step.pattern(state.step, self.n)
            if pattern not in self._graphs:
                with span("chunk.capture"):
                    self._capture(state, data, key, pattern)

    def __call__(self, state: TrainState, data):
        with span("chunk.call"):
            dev = _device(state)
            pattern = self.step.pattern(state.step, self.n)
            if dev.type != "cuda":
                gens = [self.step.generators(dev, state.seed, state.step + i) for i in range(self.n)]
                new, stacked = self._chunk(state, data, gens, self.step.scalars(state, self.n), pattern)
                _copy_into(state, new)
            else:
                self.prepare(state, data)
                graph, graph_gens, scalars, metrics = self._graphs[pattern]
                for i, gens in enumerate(graph_gens):
                    for g, domain in zip(gens, self.step.domains):
                        g.manual_seed(self.step.seed_of(state.seed, state.step + i, domain))
                _upload(self.step.scalars(state, self.n), dev, out=scalars)
                with span("chunk.replay"):
                    graph.replay()
                self.replays += 1
                out = metrics.clone()
                stacked = {k: out[j] for j, k in enumerate(self.step.metrics)}
            self.step_metrics = stacked
            return self._advanced(state), _reduce_scan_metrics(stacked, self.mode)

    def _capture(self, state: TrainState, data, key, pattern) -> None:
        dev = _device(state)
        mesh = self.step.mesh
        if mesh is not None and mesh.backend != "nccl":
            raise GraphCaptureError(
                f"capturing {self.n} train steps as a CUDA graph under a {mesh.backend} process group: "
                f"{mesh.backend}'s collectives on CUDA tensors stage through the host and cannot be "
                f"captured. Use NCCL (one card a rank), or scan_steps=1. Nothing ran eagerly in its place.")
        if mesh is not None:
            mesh.barrier()  # NCCL makes its communicator at the first collective: not in the capture
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for reg in sorted(set(pattern)):  # a warm-up step of each kind the graph holds
                self.step.run_body(_clone_state(state), data, self.step.generators(dev, state.seed, state.step),
                                   _upload(self.step.scalars(state), dev)[0], reg)
                self.warmup_steps += 1
        torch.cuda.current_stream(dev).wait_stream(stream)

        gens = [[torch.Generator(device=dev) for _ in self.step.domains] for _ in range(self.n)]
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for g in (g for pair in gens for g in pair):
            graph.register_generator_state(g)
        sc = _upload(self.step.scalars(state, self.n), dev)  # a static input, outside the graph's pool
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=stream):
                mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")  # a host sync raises where it is
                try:
                    new, stacked = self._chunk(state, data, gens, sc, pattern)
                    _copy_into(state, new)
                    vec = torch.stack([stacked[k] for k in self.step.metrics])
                    del new, stacked
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
        except Exception as e:  # any failure inside the capture: name it, never fall back
            raise GraphCaptureError(_capture_failure(e, self.n)) from e
        nodes = _graph_nodes(graph)
        graph.instantiate()
        seconds = time.perf_counter() - t0
        self._graphs[pattern] = graph, gens, sc, vec
        self._key, self._pool = key, graph.pool()
        self.captures += 1
        self.captured_steps += self.n
        self.graph_stats = {"steps": self.n, "nodes": nodes, "capture_s": seconds,
                            "pool_bytes": _pool_bytes(graph.pool())}
        if any(pattern):
            self.graph_stats["r1_steps"] = sum(pattern)
        self.log(f"graph: captured {self.n} steps as one CUDA graph: {nodes} nodes, "
                 f"{seconds:.3f} s to capture and instantiate, {self.graph_stats['pool_bytes']} bytes "
                 f"of pool{f', {sum(pattern)} with an R1 update' if any(pattern) else ''}", flush=True)


def make_eval_step(cfg, nets, zca_stats=None, mesh=None):
    """``(state, batch) -> {"correct", "count"}``: the classifier's masked
    correct count on a test batch (uint8 ``x``, int ``y``, 0/1 ``mask``),
    eval-mode BN, no augmentation. Under ``mesh`` the batch is this rank's
    rows and both counts are summed over the ranks."""
    _, _, clf = nets
    cdt = compute_dtype(cfg)
    zca = _Zca(zca_stats)

    def eval_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        zm, zw = zca.get(_device(state))
        with torch.no_grad():
            x = ondevice.standard_pipeline(batch["x"], zca_mean=zm, zca_whiten=zw, dtype=cdt,
                                           do_rescale=bool(cfg.get("rescale", True)))
            logits, _ = clf.apply(state.params["clf"], state.bn["clf"], x, train=False)
            pred = torch.argmax(logits, dim=-1)
            mask = batch["mask"]
            out = {"correct": torch.sum((pred == batch["y"].long()) * mask), "count": torch.sum(mask)}
            return out if mesh is None else mesh.psum_tree(out)

    return eval_step
