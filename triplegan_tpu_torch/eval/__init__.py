"""Evaluation of a run: the classifier's test error, class-conditional
sample grids, the Inception-style score of conditional generation and FID,
as ``triplegan_tpu/eval`` exports them."""

from triplegan_tpu_torch.eval.fid import fid_score, frechet_distance
from triplegan_tpu_torch.eval.inception import inception_score
from triplegan_tpu_torch.eval.metrics import evaluate_error
from triplegan_tpu_torch.eval.sample import make_sample_fn, save_png, to_uint8_grid

__all__ = [
    "evaluate_error",
    "make_sample_fn",
    "to_uint8_grid",
    "save_png",
    "inception_score",
    "fid_score",
    "frechet_distance",
]
