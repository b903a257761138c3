"""The port's export (``export.py``) against the JAX package's on the same
numpy-seeded weights: int8 PTQ (``quantize_int8``'s q and scale bitwise
after the bridge; the int8 serving functions), ``export_npz`` (the same
keys and arrays), and the port's traced artifact (``.pt2``): a CPU round
trip bitwise equal to ``make_serving_fns``, the int8 artifact smaller and
close, and the artifact as an IS/FID scorer.

Tolerances: serving functions float32 atol 1e-4 (as ``test_torch_serve``:
the same math in another summation order, ZCA's 768-term dot included);
the int8 artifact within 0.05 of the float32 one (the JAX package's bound
for its int8 artifact); everything else bitwise.
"""

import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from tests.helpers import tiny_config  # noqa: E402
from tests.test_torch_networks import randomize_state  # noqa: E402
from triplegan_tpu import export as jexport  # noqa: E402
from triplegan_tpu.configs.base import make_networks as jax_make_networks  # noqa: E402
from triplegan_tpu.configs.base import save_config  # noqa: E402
from triplegan_tpu.data.zca import fit_zca  # noqa: E402
from triplegan_tpu_torch import bridge  # noqa: E402
from triplegan_tpu_torch import export as texport  # noqa: E402
from triplegan_tpu_torch.configs import base as port_base  # noqa: E402
from triplegan_tpu_torch.data.zca import ZCAStats  # noqa: E402
from triplegan_tpu_torch.eval import inception as tinc  # noqa: E402
from triplegan_tpu_torch.train.schedule import make_optimizers  # noqa: E402
from triplegan_tpu_torch.train.state import create_state  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-4


def _run(tmp, jcfg):
    """JAX config, nets and randomized state of all three players; the
    port's config (through config.json), nets and state (through the
    bridge); ZCA fitted with N > D when the config whitens."""
    jcfg.use_pallas = True
    save_config(jcfg, str(tmp / "config.json"))
    cfg = port_base.merge_saved(port_base.base_config(), str(tmp / "config.json"))
    jnets = jax_make_networks(jcfg)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    inits = [net.init(k) for net, k in zip(jnets, keys)]
    params, bn = randomize_state({p: i[0] for p, i in zip(("gen", "disc", "clf"), inits)},
                                 {p: i[1] for p, i in zip(("gen", "disc", "clf"), inits)}, 0)
    rng = np.random.RandomState(0)
    zca = None
    if jcfg.zca:
        fit_zca(rng.randint(0, 256, size=(1000, 16, 16, 3), dtype=np.uint8)).save(str(tmp / "zca.npz"))
        zca = ZCAStats.load(str(tmp / "zca.npz"))
    return types.SimpleNamespace(
        jcfg=jcfg, cfg=cfg, jnets=jnets, jstate=types.SimpleNamespace(params=params, bn=bn),
        state=bridge.from_jax(params, bn), zca=zca,
        images=rng.randint(0, 256, size=(5, 16, 16, 3), dtype=np.uint8),
        z=rng.normal(size=(5, jcfg.z_dim)).astype(np.float32),
        y=np.array([0, 3, 9, 1, 2], np.int32),
    )


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("export"), tiny_config(zca=True))


def _to_jax_layout(player, t):
    if t.dim() == 4 and player not in bridge._DECONV_PLAYERS:
        t = t.permute(2, 3, 1, 0)  # OIHW -> HWIO
    return t.contiguous().numpy()


def test_quantize_int8_equals_jax_bitwise(run):
    got = texport.quantize_int8(run.state)
    n = 0
    for player in ("gen", "disc", "clf"):
        want = jexport.quantize_int8(run.jstate.params[player])
        for layer, arrays in run.jstate.params[player].items():
            for name, a in arrays.items():
                v = got[player][f"{layer}.{name}"]
                if np.ndim(a) < 2:
                    assert not isinstance(v, texport.QTensor)
                    continue
                w = want[layer][name]
                assert v.q.dtype == torch.int8 and v.scale.dtype == torch.float32
                np.testing.assert_array_equal(_to_jax_layout(player, v.q), np.asarray(w.q))
                np.testing.assert_array_equal(_to_jax_layout(player, v.scale), np.asarray(w.scale))
                n += 1
    assert n >= 10  # every kernel of the three players: dense, deconv, conv, weight-norm v


def test_dequantize_inverts_within_half_a_step(run):
    q = texport.quantize_int8(run.state)
    back = texport.dequantize(q)
    for player, sd in run.state.items():
        for key, t in sd.items():
            if t.dim() < 2:
                assert back[player][key] is sd[key]
                continue
            assert (back[player][key] - t).abs().le(q[player][key].scale / 2 * (1 + 1e-6)).all()


def test_int8_serving_fns_match_jax(run):
    jclassify, jgenerate = jexport.make_serving_fns(run.jcfg, run.jnets, run.jstate, run.zca,
                                                    quantize="int8")
    classify, generate = texport.make_serving_fns(run.cfg, port_base.make_networks(run.cfg), run.state,
                                                  zca_stats=run.zca, device="cpu", quantize="int8")
    np.testing.assert_allclose(classify(torch.from_numpy(run.images)).numpy(),
                               np.asarray(jclassify(jnp.asarray(run.images))), rtol=0, atol=ATOL)
    np.testing.assert_allclose(generate(torch.from_numpy(run.z), torch.from_numpy(run.y)).numpy(),
                               np.asarray(jgenerate(jnp.asarray(run.z), jnp.asarray(run.y))),
                               rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="int8"):
        texport.make_serving_fns(run.cfg, port_base.make_networks(run.cfg), run.state, device="cpu",
                                 quantize="int4")


@pytest.mark.parametrize("source", ["state_dicts", "train_state"])
def test_export_npz_equals_jax(run, source, tmp_path):
    want_path = jexport.export_npz(run.jstate, str(tmp_path / "jax.npz"))
    state = run.state
    if source == "train_state":
        nets = port_base.make_networks(run.cfg)
        trees = {p: bridge.nested(sd) for p, sd in run.state.items()}
        state = create_state(run.cfg, nets, make_optimizers(run.cfg, 1), device="cpu",
                             params={p: t[0] for p, t in trees.items()},
                             bn={p: t[1] for p, t in trees.items()})
    got_path = texport.export_npz(state, str(tmp_path / "port.npz"))
    with np.load(want_path) as want, np.load(got_path) as got:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
    # and the port's serve reads it back into the same state
    back = bridge.load_npz(got_path)
    for player, sd in run.state.items():
        for key, t in sd.items():
            torch.testing.assert_close(back[player][key], t, rtol=0, atol=0)


@pytest.fixture(scope="module")
def artifacts(run, tmp_path_factory):
    out = tmp_path_factory.mktemp("pt2")
    nets = port_base.make_networks(run.cfg)
    paths = texport.export_artifacts(run.cfg, nets, run.state, str(out), batch_size=4,
                                     zca_stats=run.zca, device="cpu")
    return paths, texport.make_serving_fns(run.cfg, nets, run.state, zca_stats=run.zca, device="cpu")


def test_pt2_round_trip_equals_serving_fns_bitwise(artifacts, run):
    (cpath, gpath), (classify, generate) = artifacts
    assert [os.path.basename(p) for p in (cpath, gpath)] == ["classify.pt2", "generate.pt2"]
    c = texport.load_pt2(cpath, device="cpu")
    g = texport.load_pt2(gpath, device="cpu")
    assert c.in_specs == (((4, 16, 16, 3), torch.uint8),)
    assert g.in_specs == (((4, run.jcfg.z_dim), torch.float32), ((4,), torch.int32))
    assert c.meta["kind"] == "classify" and g.meta["kind"] == "generate" and c.meta["batch"] == 4
    targets = {str(n.target) for n in c.program.graph.nodes if n.op == "call_function"}
    assert {"triplegan_torch.conv3x3_fwd.default", "triplegan_torch.scale_bias_act.default"} <= targets
    imgs = torch.from_numpy(run.images[:4])
    z, y = torch.from_numpy(run.z[:4]), torch.from_numpy(run.y[:4])
    assert torch.equal(c(imgs), classify(imgs))
    assert torch.equal(g(z, y), generate(z, y))
    with pytest.raises(Exception):
        c(torch.from_numpy(run.images))  # the static batch: 5 is not 4


def test_int8_pt2_artifact_is_smaller_and_close(tmp_path):
    """The JAX package's check of its int8 artifact, on the port's: the
    classifier at widths where the parameters outweigh the program."""
    jcfg = tiny_config()
    jcfg.clf.conv_blocks = ((32, 32), (64,))
    jcfg.clf.tail = (64, 32)
    r = _run(tmp_path, jcfg)
    nets = port_base.make_networks(r.cfg)
    (fpath,) = texport.export_artifacts(r.cfg, nets, r.state, str(tmp_path / "f"), what="classifier",
                                        batch_size=4, device="cpu")
    (qpath,) = texport.export_artifacts(r.cfg, nets, r.state, str(tmp_path / "q"), what="classifier",
                                        batch_size=4, device="cpu", quantize="int8")
    fsize, qsize = os.path.getsize(fpath), os.path.getsize(qpath)
    assert qsize < 0.6 * fsize, (fsize, qsize)
    imgs = torch.from_numpy(r.images[:4])
    fout = texport.load_pt2(fpath, device="cpu")(imgs)
    qout = texport.load_pt2(qpath, device="cpu")(imgs)
    assert float((qout - fout).abs().max()) < 0.05
    classify, _ = texport.make_serving_fns(r.cfg, nets, r.state, device="cpu", quantize="int8")
    assert torch.equal(qout, classify(imgs))  # the artifact multiplies out what the in-process fn does


def test_export_artifacts_refusals(run, tmp_path):
    nets = port_base.make_networks(run.cfg)
    for fmt in ("stablehlo", "savedmodel"):
        with pytest.raises(ValueError, match="pt2"):
            texport.export_artifacts(run.cfg, nets, run.state, str(tmp_path), fmt=fmt, device="cpu")
    with pytest.raises(ValueError, match="npz stores the raw"):
        texport.export_artifacts(run.cfg, nets, run.state, str(tmp_path), fmt="npz", quantize="int8",
                                 device="cpu")
    with pytest.raises(ValueError, match="classifier\\|generator\\|both"):
        texport.export_artifacts(run.cfg, nets, run.state, str(tmp_path), what="disc", device="cpu")
    assert texport.export_artifacts(run.cfg, nets, run.state, str(tmp_path), fmt="npz",
                                    device="cpu") == [str(tmp_path / "params.npz")]


def test_pt2_classifier_as_inception_and_fid_scorer(artifacts, run):
    """load_scorer on the artifact: float [-1, 1] images go in as the uint8
    pixels they round to, the last chunk is padded to the artifact's batch,
    and the scores equal those of the in-process classifier on the pixels."""
    (cpath, gpath), (classify, _) = artifacts
    scorer = tinc.load_scorer(cpath, outputs="logits", device="cpu")
    assert scorer.preferred_batch == 4
    floats = torch.from_numpy(run.images.astype(np.float32) / 127.5 - 1.0)  # 5: one padded chunk
    want = classify(torch.from_numpy(run.images))
    torch.testing.assert_close(scorer(floats), want, rtol=0, atol=0)
    torch.testing.assert_close(scorer(torch.from_numpy(run.images)), want, rtol=0, atol=0)
    raw = torch.from_numpy(run.images.astype(np.float32))  # [0, 255] floats: taken as pixels
    torch.testing.assert_close(scorer(raw), want, rtol=0, atol=0)

    def reference(x):
        return classify(torch.from_numpy(tinc._to_pixels(x.numpy())))

    assert tinc.inception_score(scorer, floats, n_splits=1) == tinc.inception_score(reference, floats,
                                                                                    n_splits=1, batch_size=4)
    from triplegan_tpu_torch.eval.fid import fid_score

    other = torch.flip(floats, dims=[0])
    assert fid_score(scorer, floats, other) == fid_score(reference, floats, other, batch_size=4)
    with pytest.raises(ValueError, match="expects images of shape"):
        scorer(torch.zeros(2, 8, 8, 3))
    with pytest.raises(ValueError, match="not a classifier artifact"):
        tinc.load_scorer(gpath, device="cpu")
