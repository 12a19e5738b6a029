"""ccvpe_torch/io/pretrained.py (the port's copy of the JAX package's
resolver: URL map, atomic cached download, sha256 check) with the cases of
``tests/test_pretrained.py``, fully offline against a local HTTP server;
and ``--pretrained_b0`` in the port: a B0 state_dict written by
``export_b0`` of a seeded JAX B0 seeds both encoders exactly as JAX's
``create_train_state(pretrained_b0=...)`` does, and a file of the wrong
preset fails fast naming its first mismatched keys, in both packages."""

import functools
import hashlib
import http.server
import os
import threading

import numpy as np
import jax
import pytest
import torch

from ccvpe_tpu.io.torch_import import export_b0, import_b0, import_cvm
from ccvpe_tpu.models import cvm as JC
from ccvpe_tpu.train import loop as JLOOP
from ccvpe_torch.io import pretrained
from ccvpe_torch.io.from_jax import state_dict_from_jax
from ccvpe_torch.models import cvm as TC
from ccvpe_torch.nn import efficientnet as TE
from ccvpe_torch.nn import layers as TI
from ccvpe_torch.train import harness as TH
from ccvpe_torch.train import loop as TLOOP

torch.set_num_threads(2)


class _CountingHandler(http.server.SimpleHTTPRequestHandler):
    requests = []

    def log_message(self, *a):  # silence
        pass

    def do_GET(self):
        type(self).requests.append(self.path)
        super().do_GET()


@pytest.fixture()
def weight_server(tmp_path, monkeypatch):
    """Serve ``tmp_path/srv`` over HTTP; cache in ``tmp_path/cache``.

    Returns (srv_dir, publish) where ``publish(content)`` writes the bytes
    under their true-hash release name and patches URL_MAP['efficientnet-b0']
    to it.
    """
    srv = tmp_path / "srv"
    srv.mkdir()
    handler = type("H", (_CountingHandler,), {"requests": []})
    httpd = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0),
        functools.partial(handler, directory=str(srv)))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}/"
    monkeypatch.setenv("CCVPE_PRETRAINED_URL_BASE", base)
    monkeypatch.setenv("CCVPE_PRETRAINED_CACHE", str(tmp_path / "cache"))

    def publish(content: bytes, name: str | None = None) -> str:
        if name is None:
            prefix = hashlib.sha256(content).hexdigest()[:8]
            name = f"efficientnet-b0-{prefix}.pth"
        (srv / name).write_bytes(content)
        monkeypatch.setitem(pretrained.URL_MAP, "efficientnet-b0", name)
        return name

    yield srv, publish, handler
    httpd.shutdown()
    httpd.server_close()


def test_local_path_passthrough(tmp_path):
    p = tmp_path / "weights.pth"
    p.write_bytes(b"x")
    assert pretrained.resolve(str(p)) == str(p)


def test_missing_local_path_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        pretrained.resolve(str(tmp_path / "nope.pth"))


def test_unknown_spec_raises():
    with pytest.raises(KeyError):
        pretrained.resolve("resnet-50")


def test_canonical_names():
    for spec in ("auto", "b0", "B0", "efficientnet-b0", "EFFICIENTNET-B0"):
        assert pretrained._canonical_name(spec) == "efficientnet-b0"
    assert pretrained._canonical_name("b7") == "efficientnet-b7"


def test_url_maps_match_reference():
    """Every reference url_map entry is present with the same release file
    (reference efficientnet_pytorch/utils.py:701-726)."""
    assert len(pretrained.URL_MAP) == 8
    assert len(pretrained.URL_MAP_ADVPROP) == 9
    assert pretrained.URL_MAP["efficientnet-b0"] == \
        "efficientnet-b0-355c32eb.pth"
    assert pretrained.URL_MAP_ADVPROP["efficientnet-b8"] == \
        "adv-efficientnet-b8-22a8fe65.pth"
    for name, fn in list(pretrained.URL_MAP.items()) + \
            list(pretrained.URL_MAP_ADVPROP.items()):
        assert pretrained._expected_prefix(fn), (name, fn)


def test_download_caches_and_verifies(weight_server):
    srv, publish, handler = weight_server
    content = b"fake-b0-state-dict" * 100
    publish(content)

    path = pretrained.resolve("auto", progress=False)
    assert open(path, "rb").read() == content
    assert len(handler.requests) == 1
    # second resolve: cache hit, no HTTP traffic
    assert pretrained.resolve("b0", progress=False) == path
    assert len(handler.requests) == 1
    # no torn .part files left behind
    assert not [f for f in os.listdir(os.path.dirname(path)) if ".part" in f]


def test_corrupt_cache_detected(weight_server):
    srv, publish, handler = weight_server
    publish(b"good-content")
    path = pretrained.resolve("auto", progress=False)
    with open(path, "wb") as f:
        f.write(b"bit-rotted")
    with pytest.raises(IOError, match="corrupt"):
        pretrained.resolve("auto", progress=False)


def test_corrupt_download_rejected(weight_server, monkeypatch):
    srv, publish, handler = weight_server
    # serve wrong bytes under a hash-named file the content doesn't match
    publish(b"tampered", name="efficientnet-b0-355c32eb.pth")
    with pytest.raises(IOError, match="corrupt"):
        pretrained.resolve("auto", progress=False)


def test_download_retries_then_fails(tmp_path, monkeypatch):
    monkeypatch.setenv("CCVPE_PRETRAINED_URL_BASE",
                       "http://127.0.0.1:1/")  # nothing listens
    monkeypatch.setenv("CCVPE_PRETRAINED_CACHE", str(tmp_path / "cache"))
    monkeypatch.setattr(pretrained.time, "sleep", lambda s: None)
    with pytest.raises(IOError, match="failed to download"):
        pretrained.resolve("auto", progress=False)


def test_advprop_map(weight_server, monkeypatch):
    srv, publish, handler = weight_server
    content = b"advprop-weights"
    prefix = hashlib.sha256(content).hexdigest()[:8]
    name = f"adv-efficientnet-b0-{prefix}.pth"
    (srv / name).write_bytes(content)
    monkeypatch.setitem(pretrained.URL_MAP_ADVPROP, "efficientnet-b0", name)
    path = pretrained.resolve("auto", advprop=True, progress=False)
    assert open(path, "rb").read() == content


@pytest.fixture(autouse=True)
def _fast_jax_init(monkeypatch):
    """JAX's ``create_train_state`` starts from ``cvm.init``, whose random
    draws take about a minute on this CPU (eager or jitted).  Its weights do
    not matter here (the file's encoders replace them), so the JAX side
    starts from the port's seeded init instead, converted by the JAX
    package's own ``import_cvm``."""
    def init(key, cfg, dtype=None):
        net = TLOOP.create_train_state(TC.PRESETS[cfg.name], seed=0, device="cpu").model
        return import_cvm({k: v.numpy().copy() for k, v in net.state_dict().items()})

    monkeypatch.setattr(JC, "init", init)


def _b0_file(path, seed=0) -> str:
    """A raw EfficientNet-B0 state_dict (lukemelas keys) written by
    ``export_b0`` from a seeded B0 tree (seeded with the port's init and
    converted by ``import_b0``: JAX's own random init of a B0 takes half a
    minute here), as ``torch.save`` writes the release files."""
    net = TI.init_uniform_(TE.EfficientNet("b0"), torch.Generator().manual_seed(seed))
    params, state = import_b0({k: v.numpy() for k, v in net.state_dict().items()})
    rng = np.random.default_rng(seed)
    # non-trivial BN statistics, so that a missed buffer shows
    state = jax.tree_util.tree_map(lambda v: v + rng.uniform(0.1, 0.5, v.shape).astype(
        np.float32), state)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in export_b0(params, state).items()},
               str(path))
    return str(path)


def _encoders(sd: dict) -> dict:
    return {k: v for k, v in sd.items() if k.startswith(("grd_efficientnet.", "sat_efficientnet."))
            and "._fc." not in k and not k.endswith("num_batches_tracked")}


def test_pretrained_b0_seeds_both_encoders_as_jax(tmp_path):
    path = _b0_file(tmp_path / "b0.pth")
    jstate = JLOOP.create_train_state(JC.TINY, jax.random.PRNGKey(0), JLOOP.make_optimizer(),
                                      pretrained_b0=path)
    want = _encoders(state_dict_from_jax(jstate.params, jstate.bn_state))
    state = TLOOP.create_train_state(TC.TINY, seed=0, device="cpu", pretrained_b0=path)
    got = _encoders(state.model.state_dict())
    assert set(got) == set(want) and len(got) > 400
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
    # the rest of the model is the seeded init, and the optimizer is fresh
    seeded = TLOOP.create_train_state(TC.TINY, seed=0, device="cpu").model.state_dict()
    for k, v in state.model.state_dict().items():
        if k not in got:
            assert torch.equal(v, seeded[k]), k
    assert not state.optimizer.state_dict()["state"]


def test_pretrained_b0_with_bf16_params(tmp_path):
    path = _b0_file(tmp_path / "b0.pth")
    state = TLOOP.create_train_state(TC.TINY, seed=0, device="cpu", pretrained_b0=path,
                                     param_dtype="bfloat16")
    sd = torch.load(path, weights_only=True)
    w = state.model.sat_efficientnet._conv_stem.weight
    assert w.dtype == torch.bfloat16 and torch.equal(w, sd["_conv_stem.weight"].bfloat16())
    master = dict(zip((k for k, _ in state.model.named_parameters()), state.optimizer.master))
    assert torch.equal(master["grd_efficientnet._conv_stem.weight"], sd["_conv_stem.weight"])


def test_full_b0_into_nano_raises_naming_the_key_in_both_packages(tmp_path):
    path = _b0_file(tmp_path / "b0.pth")
    with pytest.raises(ValueError, match="do not match the configured encoder"):
        JLOOP.create_train_state(JC.NANO, jax.random.PRNGKey(0), JLOOP.make_optimizer(),
                                 pretrained_b0=path)
    with pytest.raises(ValueError, match=r"preset 'NANO'.*_blocks\.0\._bn1\.bias: model wants"):
        TLOOP.create_train_state(TC.NANO, seed=0, device="cpu", pretrained_b0=path)
    with pytest.raises(ValueError, match=r"_blocks\.0\._bn1\.running_mean"):
        TH.Trainer(TC.NANO, device="cpu").init_state(pretrained_b0=path)


def test_train_state_from_torch_checks_shapes(tmp_path):
    sd = TLOOP.create_train_state(TC.TINY, seed=0, device="cpu").model.state_dict()
    with pytest.raises(ValueError, match=r"'tiny.pt' do not match.*preset 'NANO'"):
        TLOOP.train_state_from_torch(sd, TC.NANO, device="cpu", spec="tiny.pt")
    state = TLOOP.train_state_from_torch(sd, TC.TINY, device="cpu", param_dtype="bfloat16")
    assert next(state.model.parameters()).dtype == torch.bfloat16


def test_create_train_state_auto(weight_server, tmp_path):
    """``create_train_state(pretrained_b0='auto')`` downloads the release
    file through the cache and seeds both encoders; a second state hits the
    cache."""
    path = _b0_file(tmp_path / "b0.pth")
    srv, publish, handler = weight_server
    publish(open(path, "rb").read())
    state = TLOOP.create_train_state(TC.TINY, seed=0, device="cpu", pretrained_b0="auto")
    stem = torch.load(path, weights_only=True)["_conv_stem.weight"]
    for enc in (state.model.grd_efficientnet, state.model.sat_efficientnet):
        assert torch.equal(enc._conv_stem.weight.contiguous(), stem)
    TLOOP.create_train_state(TC.TINY, seed=1, device="cpu", pretrained_b0="b0")
    assert len(handler.requests) == 1
