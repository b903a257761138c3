"""The port's serving path against the JAX package's: make_serving_fns with
ZCA on, weights through the JAX npz export, batched_apply, and the HTTP
surface of an in-thread server on an ephemeral port.

Tolerances: float32 atol 1e-4 on logits and images (same math in another
summation order, ZCA's 768-term dot included).
"""

import io
import json
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from tests.helpers import tiny_config  # noqa: E402
from tests.test_torch_networks import randomize_state  # noqa: E402
from triplegan_tpu.configs.base import make_networks as jax_make_networks  # noqa: E402
from triplegan_tpu.configs.base import save_config  # noqa: E402
from triplegan_tpu.data.zca import fit_zca  # noqa: E402
from triplegan_tpu.export import export_npz  # noqa: E402
from triplegan_tpu.export import make_serving_fns as jax_serving_fns  # noqa: E402
from triplegan_tpu_torch import bridge  # noqa: E402
from triplegan_tpu_torch.configs import base as port_base  # noqa: E402
from triplegan_tpu_torch.data.zca import ZCAStats  # noqa: E402
from triplegan_tpu_torch.export import make_serving_fns  # noqa: E402
from triplegan_tpu_torch.serve import ServingApp, app_from_state, batched_apply, make_server  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-4


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A tiny zca run: JAX config, nets and randomized state; ZCA fit with
    N (1000) > D (768); the port's config and ZCA stats from the run-dir
    files; the JAX npz export."""
    tmp = tmp_path_factory.mktemp("run")
    jcfg = tiny_config(zca=True)
    jcfg.use_pallas = True
    save_config(jcfg, str(tmp / "config.json"))
    cfg = port_base.merge_saved(port_base.base_config(), str(tmp / "config.json"))
    jnets = jax_make_networks(jcfg)
    kg, kd, kc = jax.random.split(jax.random.PRNGKey(0), 3)
    (pg, sg), (pd, sd), (pc, sc) = jnets[0].init(kg), jnets[1].init(kd), jnets[2].init(kc)
    params, bn = randomize_state({"gen": pg, "clf": pc}, {"gen": sg, "clf": sc}, 0)
    params["disc"], bn["disc"] = jax.tree.map(np.asarray, pd), sd  # exported, not ported
    jstate = types.SimpleNamespace(params=params, bn=bn)
    rng = np.random.RandomState(0)
    fit_images = rng.randint(0, 256, size=(1000, 16, 16, 3), dtype=np.uint8)
    fit_zca(fit_images).save(str(tmp / "zca_stats.npz"))
    npz = export_npz(jstate, str(tmp / "params.npz"))
    return types.SimpleNamespace(
        jcfg=jcfg, cfg=cfg, jnets=jnets, jstate=jstate, npz=npz,
        zca=ZCAStats.load(str(tmp / "zca_stats.npz")),
        images=rng.randint(0, 256, size=(5, 16, 16, 3), dtype=np.uint8),
        z=rng.normal(size=(5, jcfg.z_dim)).astype(np.float32),
        y=np.array([0, 3, 9, 1, 2], np.int32),
    )


def _port_fns(run, state, dtype="float32"):
    run.cfg.compute_dtype = dtype
    return make_serving_fns(run.cfg, port_base.make_networks(run.cfg), state,
                            zca_stats=run.zca, device="cpu")


def test_serving_fns_match_jax_with_zca(run):
    jclassify, jgenerate = jax_serving_fns(run.jcfg, run.jnets, run.jstate, run.zca)
    classify, generate = _port_fns(run, bridge.from_jax(run.jstate.params, run.jstate.bn))
    logits = classify(torch.from_numpy(run.images))
    assert logits.dtype == torch.float32 and logits.shape == (5, 10)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jclassify(jnp.asarray(run.images))),
                               rtol=0, atol=ATOL)
    imgs = generate(torch.from_numpy(run.z), torch.from_numpy(run.y))
    assert imgs.dtype == torch.float32 and imgs.shape == (5, 16, 16, 3)
    np.testing.assert_allclose(
        imgs.numpy(), np.asarray(jgenerate(jnp.asarray(run.z), jnp.asarray(run.y))),
        rtol=0, atol=ATOL)


def test_bf16_config_keeps_generator_f32_and_logits_f32(run):
    classify, generate = _port_fns(run, bridge.from_jax(run.jstate.params, run.jstate.bn),
                                   "bfloat16")
    assert classify(torch.from_numpy(run.images)).dtype == torch.float32
    assert generate(torch.from_numpy(run.z), torch.from_numpy(run.y)).dtype == torch.float32


def test_load_npz_of_jax_export(run):
    from_npz = bridge.load_npz(run.npz)
    direct = bridge.from_jax(run.jstate.params, run.jstate.bn)
    assert sorted(from_npz) == ["clf", "gen"]  # the Discriminator is not carried
    for player in direct:
        assert sorted(from_npz[player]) == sorted(direct[player])
        for key, t in direct[player].items():
            torch.testing.assert_close(from_npz[player][key], t, rtol=0, atol=0)
    a = _port_fns(run, from_npz)[0](torch.from_numpy(run.images))
    b = _port_fns(run, direct)[0](torch.from_numpy(run.images))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_to_jax_round_trip(run):
    params, bn = bridge.to_jax(bridge.from_jax(run.jstate.params, run.jstate.bn))
    for player in ("gen", "clf"):
        for tree, ref in ((params, run.jstate.params), (bn, run.jstate.bn)):
            for layer, arrays in ref[player].items():
                for name, a in arrays.items():
                    np.testing.assert_array_equal(tree[player][layer][name], np.asarray(a))


# ---------- batched_apply ----------


def test_batched_apply_chunks_and_pads():
    calls = []

    def fn(a):
        calls.append(np.asarray(a).shape)
        return np.asarray(a) * 2.0

    x = np.arange(10, dtype=np.float32)[:, None]
    np.testing.assert_array_equal(batched_apply(fn, 4, x), x * 2.0)
    assert calls == [(4, 1), (4, 1), (4, 1)]  # tail chunk padded 2→4


def test_batched_apply_multi_arg_and_exact_fit():
    z = np.ones((8, 3), np.float32)
    y = np.arange(8, dtype=np.float32)
    out = batched_apply(lambda z, y: z + y[:, None], 4, z, y)
    np.testing.assert_array_equal(out, z + y[:, None])


def test_batched_apply_rejects_bad_batches():
    with pytest.raises(ValueError, match="empty"):
        batched_apply(lambda a: a, 4, np.zeros((0, 2)))
    with pytest.raises(ValueError, match="mismatched"):
        batched_apply(lambda a: a, 4, np.zeros((3, 2)), np.zeros((4,)))


def test_app_requires_a_fn():
    with pytest.raises(ValueError, match="nothing to serve"):
        ServingApp(device="cpu")


# ---------- live HTTP round trip ----------


@pytest.fixture(scope="module")
def live(run):
    run.cfg.compute_dtype = "float32"
    state = bridge.load_npz(run.npz)
    app = app_from_state(run.cfg, port_base.make_networks(run.cfg), state, zca_stats=run.zca,
                         batch_size=4, meta={"source": "test"}, device="cpu")
    classify, generate = _port_fns(run, state)
    server = make_server(app, port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield classify, generate, app, "http://127.0.0.1:%d" % server.server_address[1]
    server.shutdown()
    server.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


def _post(url, body, ctype):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.read()


def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def test_http_healthz_and_metrics(live):
    _, _, _, base = live
    with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
        h = json.loads(r.read())
    assert h["status"] == "ok" and h["backend"] == "cpu" and h["device_name"] == "cpu"
    assert h["endpoints"] == ["classify", "generate"]
    assert h["classify_batch"] == 4 and h["image_shape"] == [16, 16, 3]
    with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
        assert 'triplegan_serving_batch{fn="classify"} 4' in r.read().decode()


def test_http_classify_matches_fn(live, run):
    classify, _, _, base = live
    status, body = _post(base + "/classify", _npy(run.images), "application/x-npy")
    assert status == 200
    logits = np.load(io.BytesIO(body))
    assert logits.shape == (5, 10) and logits.dtype == np.float32  # 5 = one chunk + pad
    np.testing.assert_allclose(logits, classify(torch.from_numpy(run.images)).numpy(),
                               rtol=0, atol=1e-5)


def test_http_generate_json_and_npz(live, run):
    _, generate, _, base = live
    status, body = _post(base + "/generate", json.dumps({"n": 6, "seed": 3}).encode(),
                         "application/json")
    imgs = np.load(io.BytesIO(body))
    assert status == 200 and imgs.shape == (6, 16, 16, 3) and imgs.dtype == np.float32
    z = np.random.RandomState(3).normal(size=(6, run.jcfg.z_dim)).astype(np.float32)
    y = (np.arange(6) % 10).astype(np.int32)
    np.testing.assert_allclose(imgs, generate(torch.from_numpy(z), torch.from_numpy(y)).numpy(),
                               rtol=0, atol=1e-5)
    _, body = _post(base + "/generate", json.dumps({"n": 6, "seed": 3, "pixels": True}).encode(),
                    "application/json")
    pix = np.load(io.BytesIO(body))
    assert pix.dtype == np.uint8 and pix.shape == (6, 16, 16, 3)
    buf = io.BytesIO()
    np.savez(buf, z=run.z, y=run.y)
    status, body = _post(base + "/generate", buf.getvalue(), "application/octet-stream")
    np.testing.assert_allclose(
        np.load(io.BytesIO(body)),
        generate(torch.from_numpy(run.z), torch.from_numpy(run.y)).numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("route,body,ctype,match", [
    ("/classify", np.zeros((2, 16, 16, 3), np.float32), "application/x-npy", "uint8"),
    ("/classify", np.zeros((2, 8, 8, 3), np.uint8), "application/x-npy", "images must be"),
    ("/generate", {"n": 2, "y": [0, 99]}, "application/json", "labels"),
    ("/generate", {}, "application/json", '"n" or a "y"'),
])
def test_http_bad_input_is_400(live, route, body, ctype, match):
    _, _, app, base = live
    data = json.dumps(body).encode() if isinstance(body, dict) else _npy(body)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + route, data, ctype)
    assert e.value.code == 400
    assert match in json.loads(e.value.read())["error"]


def test_cli_serve_needs_weights(tmp_path):
    from triplegan_tpu_torch.cli import main

    with pytest.raises(SystemExit, match="no weights"):
        main(["serve", "--config", "cifar10_4k", "--workdir", str(tmp_path), "--device", "cpu"])
    with pytest.raises(SystemExit, match="unknown config key"):
        main(["serve", "--config", "cifar10_4k", "--params", "x.npz", "--set", "bogus=1"])
