"""adam_ms.train: device ms a traced step in the three Adam updates,
phases ``d_adam``, ``g_adam`` and ``c_adam`` (``phases.py``: the records
from each ``tg_phase_*_adam`` mark of the program to its next mark)."""

import phases


def read(ctx):
    return phases.phase_ms(ctx, "d_adam", "g_adam", "c_adam")
