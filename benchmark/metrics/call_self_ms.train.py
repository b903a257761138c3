"""call_self_ms.train: host ms a step that the program's training call
spends outside its graph replay, read in the traced window: its
``tg::chunk.call`` spans less the ``tg::chunk.replay`` spans they hold
(``phases.py``), over the window's steps. Seeding, scalars, the upload and
the metrics' copy; the replay's wait for room in the launch queue is left
out."""

import phases


def read(ctx):
    return phases.call_self_ms(ctx)
