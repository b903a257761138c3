"""c_grad_ms.train: device ms a traced step in phase ``c_grad``, C's update
before its Adam (``phases.py``: the records from the program's
``tg_phase_c_grad`` mark to its next mark)."""

import phases


def read(ctx):
    return phases.phase_ms(ctx, "c_grad")
