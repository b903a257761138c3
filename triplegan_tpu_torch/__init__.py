"""triplegan_tpu_torch: the PyTorch/CUDA port of ``triplegan_tpu`` for an
NVIDIA Hopper card.

The JAX package beside it is the reference the port is held to; nothing
here imports it, or JAX. This slice serves a trained run: ``cli serve``
answers ``/classify`` and ``/generate`` through the eval-mode Generator and
Classifier, whose per-channel epilogues run on the hand-written
``scale_bias_act`` kernel (``ops/csrc/scale_bias_act.cu``).
"""

__version__ = "0.1.0"
