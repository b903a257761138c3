"""g_grad_ms.train: device ms a traced step in phase ``g_grad``, G's update
before its Adam (``phases.py``: the records from the program's
``tg_phase_g_grad`` mark to its next mark)."""

import phases


def read(ctx):
    return phases.phase_ms(ctx, "g_grad")
