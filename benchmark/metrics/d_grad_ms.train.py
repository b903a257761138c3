"""d_grad_ms.train: device ms a traced step in phase ``d_grad``, D's update
before its Adam (``phases.py``: the records from the program's
``tg_phase_d_grad`` mark to its next mark)."""

import phases


def read(ctx):
    return phases.phase_ms(ctx, "d_grad")
