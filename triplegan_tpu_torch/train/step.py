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
cross-forwards run in train mode but their new stats are dropped. C's
stats chain labeled → unlabeled → generated, or unlabeled → labeled →
generated under ``share_pseudo_forward``. D's three kinds of pairs go
through one batched forward of 3B rows (D has no BN, so this is exact).

``share_pseudo_forward`` keeps the graph of C's unlabeled-stream forward,
taken before D's update at C's current parameters, and feeds those logits
to C's loss, so C's gradient flows back through them: the torch form of
JAX's VJP graft.

Randomness (noise, dropout, augmentation, pseudo-label sampling) comes from
one device generator per step, seeded from (state.seed, state.step); the
batch sampler has its own, seeded from (state.seed, state.step, 0x5A5A).
The streams are PyTorch's, not JAX's threefry bits.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from triplegan_tpu_torch.data import ondevice
from triplegan_tpu_torch.data.zca import apply_zca
from triplegan_tpu_torch.train import losses
from triplegan_tpu_torch.train.schedule import alpha_p_schedule, linear_decay_schedule
from triplegan_tpu_torch.train.state import TrainState

METRICS = ("loss_d", "loss_g", "loss_c", "d_real", "d_cla", "d_gen", "c_sup", "c_adv",
           "c_pseudo", "alpha_p", "lr_frac")
_SAMPLER_DOMAIN = 0x5A5A


def compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def step_generator(device: torch.device, seed: int, step: int, domain: int = 0) -> torch.Generator:
    """A generator on ``device`` whose stream depends only on (seed, step,
    domain)."""
    mixed = ((seed * 1_000_003 + step) * 0x9E3779B1 + domain) % (1 << 63)
    return torch.Generator(device=device).manual_seed(mixed)


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
                    pseudo_label_mode: str = "sample"):
    """``(state, batch) -> (state, metrics)``. ``batch`` is the nested dict
    of ``_make_batch_sampler``: streams "d" and "c" with uint8 ``x_l``,
    ``x_u`` (none in "c" under ``share_pseudo_forward``), int ``y_l``, float
    ``z`` and int ``y_g``; stream "g" with ``z`` and ``y_g``. ``metrics``
    holds the 11 scalars of ``METRICS`` as 0-d tensors."""
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
    if bool(cfg.get("fused_clf_forward", False)):
        raise NotImplementedError("fused_clf_forward is not ported yet (ROADMAP Queue 1)")
    non_saturating = bool(cfg.non_saturating_g)

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        dev = _device(state)
        rng = step_generator(dev, state.seed, state.step)
        alpha_p_now = ap_sched(state.step)
        params, bn = state.params, state.bn
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

        # ================= D update (G, C at their current values) ==========
        bd = batch["d"]
        x_l, x_u = preprocess(bd["x_l"]), preprocess(bd["x_u"])
        y_l, y_gd = bd["y_l"].long(), bd["y_g"].long()
        z_d = bd["z"].to(cdt)
        with torch.no_grad():
            x_g = whiten_gen(gen.apply(params["gen"], bn["gen"], z_d, y_gd, train=True)[0])
        pc = _with_grad(params["clf"])
        if share_fwd:
            logits_c_u, bn_u = clf.apply(pc, bn["clf"], x_u, train=True, generator=rng)
        else:
            with torch.no_grad():
                logits_c_u, _ = clf.apply(params["clf"], bn["clf"], x_u, train=True, generator=rng)
        y_c = losses.sample_pseudo_labels(rng, logits_c_u, pseudo_label_mode)

        b = x_l.shape[0]
        pd = _with_grad(params["disc"])
        logit_all, _ = disc.apply(pd, bn["disc"], torch.cat([x_l, x_u, x_g]),
                                  torch.cat([y_l, y_c, y_gd]), train=True, generator=rng)
        lr_real, lr_cla, lr_gen = logit_all[:b], logit_all[b:2 * b], logit_all[2 * b:]
        d_total = losses.d_loss(lr_real, lr_cla, lr_gen, alpha)
        d_terms = losses.d_loss_terms(lr_real, lr_cla, lr_gen, alpha)
        gd = _like(pd, torch.autograd.grad(d_total, _leaves(pd)))
        pd_new, opt_d_new = opt_d.update(params["disc"], gd, state.opt["disc"])

        # ================= G update (scored by the new D) ====================
        bg = batch["g"]
        z_g, y_gg = bg["z"].to(cdt), bg["y_g"].long()
        pg = _with_grad(params["gen"])
        x_raw, bn_g_new = gen.apply(pg, bn["gen"], z_g, y_gg, train=True)
        logit_g, _ = disc.apply(pd_new, bn["disc"], whiten_gen(x_raw), y_gg, train=True,
                                generator=rng)
        g_total = losses.g_loss(logit_g, alpha, non_saturating)
        gg = _like(pg, torch.autograd.grad(g_total, _leaves(pg)))
        pg_new, opt_g_new = opt_g.update(params["gen"], gg, state.opt["gen"])

        # ================= C update (sees the new D and G) ===================
        bc = batch["c"]
        x_l_c = preprocess(bc["x_l"])
        x_u_c = x_u if share_fwd else preprocess(bc["x_u"])
        y_l_c, y_gc = bc["y_l"].long(), bc["y_g"].long()
        z_c = bc["z"].to(cdt)
        with torch.no_grad():
            x_g_c = whiten_gen(gen.apply(pg_new, bn_g_new, z_c, y_gc, train=True)[0])
        if share_fwd:
            log_u, y_c2 = logits_c_u, y_c
            log_l, s1 = clf.apply(pc, bn_u, x_l_c, train=True, generator=rng)
            log_g, s3 = clf.apply(pc, s1, x_g_c, train=True, generator=rng)
        else:
            log_l, s1 = clf.apply(pc, bn["clf"], x_l_c, train=True, generator=rng)
            log_u, s2 = clf.apply(pc, s1, x_u_c, train=True, generator=rng)
            log_g, s3 = clf.apply(pc, s2, x_g_c, train=True, generator=rng)
            y_c2 = losses.sample_pseudo_labels(rng, log_u, pseudo_label_mode)
        with torch.no_grad():  # the D signal is stop-gradiented in L_C
            logit_d_cla, _ = disc.apply(pd_new, bn["disc"], x_u_c, y_c2, train=True,
                                        generator=rng)
        c_total, c_terms = losses.c_loss(log_l, y_l_c, logit_d_cla, log_u, y_c2, log_g, y_gc,
                                         alpha, alpha_p_now)
        gc = _like(pc, torch.autograd.grad(c_total, _leaves(pc)))
        pc_new, opt_c_new = opt_c.update(params["clf"], gc, state.opt["clf"])

        new_state = TrainState(
            params={"gen": pg_new, "disc": pd_new, "clf": pc_new},
            bn={"gen": bn_g_new, "disc": bn["disc"], "clf": s3},
            opt={"gen": opt_g_new, "disc": opt_d_new, "clf": opt_c_new},
            step=state.step + 1,
            seed=state.seed,
        )
        metrics = {"loss_d": d_total, "loss_g": g_total, "loss_c": c_total, **d_terms,
                   **c_terms}
        metrics = {k: v.detach().float() for k, v in metrics.items()}
        metrics["alpha_p"] = torch.tensor(float(alpha_p_now))
        metrics["lr_frac"] = torch.tensor(float(lr_now(state.step)))
        return new_state, metrics

    return step


def _make_batch_sampler(cfg):
    """``(seed, step_no, device_data) -> batch``: per-player sub-batches
    drawn on the data's device from a generator seeded by (seed, step_no),
    so any grouping of steps draws the same sequence. Under
    ``share_pseudo_forward`` the "c" stream's x_u is not gathered (the C
    update reuses D's); its indices are still drawn, so the flag leaves
    every used field's sequence unchanged."""
    b = int(cfg.batch_size)
    z_dim, n_classes = int(cfg.z_dim), int(cfg.num_classes)
    share_fwd = bool(cfg.get("share_pseudo_forward", False))

    def sample(seed: int, step_no: int, data):
        dev = data["x_l"].device
        g = step_generator(dev, seed, step_no, _SAMPLER_DOMAIN)

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

    return sample


def upload_device_data(data, device=None) -> Dict[str, torch.Tensor]:
    """The dataset's training arrays on the device (uint8 images, int64
    labels), for ``make_device_train_step``."""
    from triplegan_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    return {"x_l": torch.as_tensor(data.x_label, device=dev),
            "y_l": torch.as_tensor(data.y_label, device=dev).long(),
            "x_u": torch.as_tensor(data.x_unlabel, device=dev)}


def make_device_train_step(cfg, nets, optimizers, total_steps: int, zca_stats=None,
                           pseudo_label_mode: str = "sample"):
    """``(state, device_data) -> (state, metrics)``: the dataset stays on
    the device (``upload_device_data``) and each step draws its own
    sub-batches there."""
    core = make_train_step(cfg, nets, optimizers, total_steps, zca_stats, pseudo_label_mode)
    sample = _make_batch_sampler(cfg)

    def step(state: TrainState, data):
        return core(state, sample(state.seed, state.step, data))

    return step


def make_eval_step(cfg, nets, zca_stats=None):
    """``(state, batch) -> {"correct", "count"}``: the classifier's masked
    correct count on a test batch (uint8 ``x``, int ``y``, 0/1 ``mask``),
    eval-mode BN, no augmentation."""
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
            return {"correct": torch.sum((pred == batch["y"].long()) * mask),
                    "count": torch.sum(mask)}

    return eval_step
