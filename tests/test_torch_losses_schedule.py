"""triplegan_tpu_torch.train.losses and .schedule against the JAX package's
``train/losses.py`` and ``train/schedule.py`` (optax's Adam).

Tolerances: loss terms and their gradients rtol = atol = 1e-6 (float32,
the same formulas); schedules exact up to float32 rounding (1e-7
relative); Adam's parameters after 3 updates within 1e-7 + 1e-6·|p|
(float32, the same update in another association order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from tests.helpers import tiny_config  # noqa: E402
from triplegan_tpu.train import losses as JLo  # noqa: E402
from triplegan_tpu.train import schedule as JS  # noqa: E402
from triplegan_tpu_torch.train import losses as TLo  # noqa: E402
from triplegan_tpu_torch.train import schedule as TS  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=1e-6, atol=1e-6)


def _rand(seed, b=16, k=10):
    rng = np.random.RandomState(seed)
    return {
        "logit_real": (rng.normal(size=b) * 3).astype(np.float32),
        "logit_cla": (rng.normal(size=b) * 3).astype(np.float32),
        "logit_gen": (rng.normal(size=b) * 3).astype(np.float32),
        "logits_l": rng.normal(size=(b, k)).astype(np.float32),
        "logits_u": rng.normal(size=(b, k)).astype(np.float32),
        "logits_g": rng.normal(size=(b, k)).astype(np.float32),
        "y_l": rng.randint(0, k, b), "y_c": rng.randint(0, k, b), "y_g": rng.randint(0, k, b),
    }


@pytest.mark.parametrize("non_saturating", [True, False])
def test_d_and_g_losses_and_grads(non_saturating):
    a = _rand(0)
    a["logit_real"][0] = 40.0   # far in the tails: softplus must not cut over
    a["logit_gen"][1] = -40.0
    keys = ("logit_real", "logit_cla", "logit_gen")

    def jd(*ls):
        return JLo.d_loss(*ls, 0.5)

    want, jg = jax.value_and_grad(jd, argnums=(0, 1, 2))(*(jnp.asarray(a[k]) for k in keys))
    ts = [torch.from_numpy(a[k]).requires_grad_() for k in keys]
    got = TLo.d_loss(*ts, 0.5)
    tg = torch.autograd.grad(got, ts)
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    for g1, g2 in zip(tg, jg):
        np.testing.assert_allclose(g1.numpy(), np.asarray(g2), **TOL)
    jt = JLo.d_loss_terms(*(jnp.asarray(a[k]) for k in keys), 0.5)
    tt = TLo.d_loss_terms(*(torch.from_numpy(a[k]) for k in keys), 0.5)
    for k in jt:
        np.testing.assert_allclose(float(tt[k]), float(jt[k]), **TOL)

    want, jg = jax.value_and_grad(lambda l: JLo.g_loss(l, 0.5, non_saturating))(
        jnp.asarray(a["logit_gen"]))
    t = torch.from_numpy(a["logit_gen"]).requires_grad_()
    got = TLo.g_loss(t, 0.5, non_saturating)
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(torch.autograd.grad(got, t)[0].numpy(), np.asarray(jg), **TOL)


@pytest.mark.parametrize("alpha_p", [0.0, 0.1])
def test_c_loss_terms_and_grads(alpha_p):
    a = _rand(1)
    jl = [jnp.asarray(a[k]) for k in ("logits_l", "logits_u", "logits_g")]

    def jc(l_l, l_u, l_g):
        return JLo.c_loss(l_l, jnp.asarray(a["y_l"]), jnp.asarray(a["logit_cla"]), l_u,
                          jnp.asarray(a["y_c"]), l_g, jnp.asarray(a["y_g"]), 0.5, alpha_p)

    (want, jterms), jg = jax.value_and_grad(jc, argnums=(0, 1, 2), has_aux=True)(*jl)
    tl = [torch.from_numpy(a[k]).requires_grad_() for k in ("logits_l", "logits_u", "logits_g")]
    tcla = torch.from_numpy(a["logit_cla"]).requires_grad_()
    got, tterms = TLo.c_loss(tl[0], torch.from_numpy(a["y_l"]), tcla, tl[1],
                             torch.from_numpy(a["y_c"]), tl[2], torch.from_numpy(a["y_g"]),
                             0.5, alpha_p)
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    for k in jterms:
        np.testing.assert_allclose(float(tterms[k].detach()), float(jterms[k]), **TOL)
    grads = torch.autograd.grad(got, tl + [tcla], allow_unused=True)
    for g1, g2 in zip(grads[:3], jg):
        np.testing.assert_allclose(g1.numpy(), np.asarray(g2), **TOL)
    # the D signal is stop-gradiented: no gradient reaches D's logits
    assert grads[3] is None or float(grads[3].abs().max()) == 0.0


def test_pseudo_labels():
    logits = torch.from_numpy(_rand(2)["logits_u"])
    np.testing.assert_array_equal(
        TLo.sample_pseudo_labels(None, logits, "argmax").numpy(),
        np.asarray(JLo.sample_pseudo_labels(None, jnp.asarray(logits.numpy()), "argmax")))
    # sampling follows softmax(logits): frequencies over many draws
    gen = torch.Generator().manual_seed(0)
    lg = torch.tensor([[2.0, 0.0, -1.0]]).expand(20000, 3)
    counts = torch.bincount(TLo.sample_pseudo_labels(gen, lg, "sample"), minlength=3).double()
    p = torch.softmax(lg[0].double(), 0)
    se = (p * (1 - p) / 20000).sqrt()
    assert bool(((counts / 20000 - p).abs() <= 5 * se).all()), counts
    with pytest.raises(ValueError):
        TLo.sample_pseudo_labels(gen, lg, "mode")


def test_schedules_at_boundary_steps():
    lin_j, lin_t = JS.linear_decay_schedule(3e-4, 50, 100), TS.linear_decay_schedule(3e-4, 50, 100)
    for t in (0, 49, 50, 51, 75, 99, 100, 120):
        np.testing.assert_allclose(lin_t(t), float(lin_j(t)), rtol=1e-6, atol=1e-12)
    for ramp in (0, 10):
        aj, at = JS.alpha_p_schedule(0.1, 20, ramp), TS.alpha_p_schedule(0.1, 20, ramp)
        for t in (0, 19, 20, 21, 25, 30, 31, 100):
            np.testing.assert_allclose(at(t), float(aj(t)), rtol=1e-6, atol=1e-9)
    an_j = JS.anneal_every_schedule(lin_j, 0.5, 10)
    an_t = TS.anneal_every_schedule(lin_t, 0.5, 10)
    for t in (0, 9, 10, 11, 55, 99):
        np.testing.assert_allclose(an_t(t), float(an_j(t)), rtol=1e-6, atol=1e-12)


def test_adam_matches_optax_over_3_updates_with_decay():
    cfg = tiny_config()
    cfg.lr_c_anneal_factor, cfg.lr_c_anneal_epochs = 0.5, 1
    total = 4  # decay from step 2; the C anneal every 1 step
    jopts = JS.make_optimizers(cfg, total)
    topts = TS.make_optimizers(cfg, total)
    rng = np.random.RandomState(3)
    p0 = {"l": {"w": rng.normal(size=(4, 5)).astype(np.float32),
                "b": rng.normal(size=5).astype(np.float32)}}
    grads = [{"l": {k: (rng.normal(size=v.shape) * s).astype(np.float32) for k, v in p0["l"].items()}}
             for s in (1.0, 1e-3, 10.0)]
    for player in ("gen", "disc", "clf"):
        jp = jax.tree.map(jnp.asarray, p0)
        js = jopts[player].init(jp)
        tp = {"l": {k: torch.from_numpy(v) for k, v in p0["l"].items()}}
        ts = topts[player].init(tp)
        for g in grads:
            upd, js = jopts[player].update(jax.tree.map(jnp.asarray, g), js, jp)
            jp = optax.apply_updates(jp, upd)
            tp_new, ts = topts[player].update(tp, {"l": {k: torch.from_numpy(v)
                                                          for k, v in g["l"].items()}}, ts)
            assert tp_new is not tp
            tp = tp_new
        assert ts.count == 3
        for k in p0["l"]:
            want = np.asarray(jp["l"][k])
            np.testing.assert_allclose(tp["l"][k].numpy(), want, rtol=1e-6, atol=1e-7,
                                       err_msg=f"{player} {k}")
