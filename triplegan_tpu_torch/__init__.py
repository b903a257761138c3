"""triplegan_tpu_torch: the PyTorch/CUDA port of ``triplegan_tpu`` for an
NVIDIA Hopper card.

The JAX package beside it is the reference the port is held to; nothing
here imports it, or JAX. ``cli train`` runs the three-player train step
(``train/step.py``) under the train driver (``train/loop.py``), with
checkpoints and resume (``ckpt/manager.py``); ``cli eval`` and ``cli
sample`` read its checkpoints; ``cli serve`` answers ``/classify`` and
``/generate``. The convs and per-channel epilogues of all three networks
run on hand-written kernels (``ops/csrc``).
"""

__version__ = "0.1.0"
