"""The Triple-GAN three-player objective: the port of
``triplegan_tpu/train/losses.py``. Every term is computed from
discriminator logits in softplus form:

    log D(x,y)       = -softplus(-logit)
    log (1 - D(x,y)) = -softplus(+logit)

L_D = -E[log D(x_l,y_l)] - α·E[log(1-D(x_u,y_c))] - (1-α)·E[log(1-D(x_g,y_g))]
L_G = -(1-α)·E[log D(x_g,y_g)]  (non-saturating; the minimax form by flag)
L_C = R_L + α·L_adv + α_P·R_P, with the adversarial term as a REINFORCE
surrogate on a stop-gradiented log(1-D), centred by the batch mean that
includes the sample itself.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # log(1 + e^x) without torch's linear cut-over above x = 20.
    return torch.logaddexp(x, torch.zeros_like(x))


def log_sigmoid(logit: torch.Tensor) -> torch.Tensor:
    return -_softplus(-logit)


def log_one_minus_sigmoid(logit: torch.Tensor) -> torch.Tensor:
    return -_softplus(logit)


def _picked_logp(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return torch.take_along_dim(logp, labels.long()[:, None], dim=-1)[:, 0]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over the batch; labels are int class ids."""
    return -torch.mean(_picked_logp(logits, labels))


def d_loss(logit_real, logit_cla, logit_gen, alpha: float) -> torch.Tensor:
    l_real = -torch.mean(log_sigmoid(logit_real))
    l_cla = -torch.mean(log_one_minus_sigmoid(logit_cla))
    l_gen = -torch.mean(log_one_minus_sigmoid(logit_gen))
    return l_real + alpha * l_cla + (1.0 - alpha) * l_gen


def d_loss_terms(logit_real, logit_cla, logit_gen, alpha: float) -> dict:
    """The three terms of L_D, each with its weight, for the metrics."""
    return {
        "d_real": -torch.mean(log_sigmoid(logit_real)),
        "d_cla": alpha * -torch.mean(log_one_minus_sigmoid(logit_cla)),
        "d_gen": (1.0 - alpha) * -torch.mean(log_one_minus_sigmoid(logit_gen)),
    }


def g_loss(logit_gen: torch.Tensor, alpha: float, non_saturating: bool = True) -> torch.Tensor:
    if non_saturating:
        return (1.0 - alpha) * -torch.mean(log_sigmoid(logit_gen))
    return (1.0 - alpha) * torch.mean(log_one_minus_sigmoid(logit_gen))


def sample_pseudo_labels(generator: Optional[torch.Generator], logits_c: torch.Tensor,
                         mode: str = "sample") -> torch.Tensor:
    """y_c from p_c(y|x_u), without gradient: a categorical sample
    (Gumbel-max, as ``jax.random.categorical``) or the argmax."""
    logits_c = logits_c.detach()
    if mode == "argmax":
        return torch.argmax(logits_c, dim=-1)
    if mode != "sample":
        raise ValueError(f"pseudo_label_mode must be sample|argmax, got {mode!r}")
    u = torch.rand(logits_c.shape, generator=generator, device=logits_c.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits_c.float() - torch.log(-torch.log(u)), dim=-1)


def c_adversarial_loss(logit_d_on_cla, logits_c, y_c, alpha: float, mesh=None) -> torch.Tensor:
    """REINFORCE surrogate for α·E_{y~p_c}[log(1 - D(x_u, y))]:
    α · mean(sg(w) · log p_c(y_c | x_u)), w = log(1 - D(x_u, y_c)) less its
    batch mean (the self-included baseline). Under data parallelism the
    baseline is the global batch's mean (averaged over ``mesh``'s ranks),
    or each rank would centre by its own and the sharded gradient would
    differ from the single-device one; w carries no gradient, so nothing
    crosses the ranks backwards here."""
    w = log_one_minus_sigmoid(logit_d_on_cla).detach()
    m = torch.mean(w)
    if mesh is not None:
        m = mesh.pmean(m)
    w = w - m
    return alpha * torch.mean(w * _picked_logp(logits_c, y_c))


def c_loss(logits_c_labeled, y_l, logit_d_on_cla, logits_c_unlabeled, y_c, logits_c_gen, y_g,
           alpha: float, alpha_p, mesh=None):
    """Full L_C and its terms (``c_sup``, ``c_adv``, ``c_pseudo``).
    ``alpha_p`` is a float or a 0-d float32 tensor (the train step's, read
    at the device step); either way α_P·R_P is taken in float32 and
    rounded once to R_P's dtype, as a Python float multiplies. ``mesh``
    as in ``c_adversarial_loss``."""
    r_l = cross_entropy(logits_c_labeled, y_l)
    l_adv = c_adversarial_loss(logit_d_on_cla, logits_c_unlabeled, y_c, alpha, mesh)
    r_p = cross_entropy(logits_c_gen, y_g)
    pseudo = (alpha_p * r_p.float()).to(r_p.dtype)
    total = r_l + l_adv + pseudo
    return total, {"c_sup": r_l, "c_adv": l_adv, "c_pseudo": pseudo}
