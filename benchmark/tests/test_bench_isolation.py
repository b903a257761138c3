"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the plain reference loads nothing of the program."""

import os
import subprocess
import sys

from tiny import BENCH, REPO

PROBE = r"""
import sys
sys.path[:0] = [{bench!r}, {tests!r}]
{pre}
import torch
from reference import triplegan as ref
import tiny
sz = tiny.TINY
data = {{"x_u": torch.randint(0, 256, (600, 12, 12, 3), dtype=torch.uint8)}}
data["x_l"], data["y_l"] = data["x_u"][:40].clone(), torch.randint(0, 10, (40,))
p0, stats = ref.make_weights(sz, 5, "cpu")
out = ref.train_steps(p0, data, ref.fit_zca(data["x_u"]), sz, 5, 150, 2)
assert len(out["losses"]) == 2
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _top_level(pre: str) -> set:
    code = PROBE.format(bench=BENCH, tests=os.path.join(BENCH, "tests"), pre=pre)
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_program_or_jax():
    names = _top_level("")
    assert not names & {"jax", "jaxlib", "flax", "triplegan_tpu", "triplegan_tpu_torch"}


def test_the_harness_and_the_program_load_no_jax():
    pre = (f"sys.path.insert(0, {REPO!r})\nimport run, harness, compare, work, traced, calibrate, prove\n"
           f"from kinds import train\nimport triplegan_tpu_torch.train.loop")
    names = _top_level(pre)
    assert "triplegan_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "triplegan_tpu"}


def test_the_reference_sets_its_own_precision():
    """TF32 on in the process (as a program that allowed it would leave
    it): the reference still computes with TF32 off, sets the process's
    flags back after, and computes in TF32 only as the control."""
    import torch
    import torch.nn.functional as F

    import tiny
    from reference import triplegan as ref

    data = {"x_u": torch.randint(0, 256, (600, 12, 12, 3), dtype=torch.uint8)}
    data["x_l"], data["y_l"] = data["x_u"][:40].clone(), torch.randint(0, 10, (40,))
    p0, _ = ref.make_weights(tiny.TINY, 5, "cpu")
    flags = lambda: (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)  # noqa: E731
    seen, conv2d, old = [], F.conv2d, flags()

    def spy(*a, **kw):
        seen.append(flags())
        return conv2d(*a, **kw)

    try:
        F.conv2d = spy
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        for tf32 in (False, True):
            seen.clear()
            ref.train_steps(p0, data, None, tiny.TINY, 5, 150, 1, tf32=tf32)
            assert seen and set(seen) == {(tf32, tf32)}
            assert flags() == (True, True)
    finally:
        F.conv2d = conv2d
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
