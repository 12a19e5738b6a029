"""ccvpe_torch.data.pipeline, .cache and .native_loader against the JAX
package (ccvpe_tpu.data.pipeline, .cache, .native_loader) and PIL, on the
CPU: collation and epoch/shard/split indices; the Loader's error and
early-exit behaviour; ``device_prefetch`` on the CPU against the same
batches built synchronously; the array cache (the same bytes as the JAX
package's, and samplers reading it give what they give without it); and
the port's own build of the native decoder (Pillow-exact resize, PNG
decode, the batched plan/assemble path bit-identical to the PIL path for
all three datasets), which builds under ``build/ccvpe_torch_native/`` and
never under ``ccvpe_tpu/``."""

import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from ccvpe_tpu.data import cache as JC
from ccvpe_tpu.data import pipeline as JP
from ccvpe_tpu.data import vigor as JV
from ccvpe_torch.data import cache as TC
from ccvpe_torch.data import kitti as TK
from ccvpe_torch.data import native_loader as NL
from ccvpe_torch.data import oxford as TO
from ccvpe_torch.data import pipeline as TP
from ccvpe_torch.data import vigor as TV
from tests.torch_data_roots import (assert_samples_equal, kitti_root, oxford_root,
                                    vigor_root)

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
HW = dict(grd_hw=(32, 64), sat_hw=(64, 64))


# ---------------------------------------------------------------- indices


def test_collate_matches_jax():
    samples = [{"grd": np.full((2, 3, 3), i, np.uint8), "angle": np.float32(i * 1.5),
                "city": ["NewYork", "Seattle"][i % 2], "idx": i} for i in range(3)]
    assert_samples_equal(TP.collate(samples), JP.collate(samples))


@pytest.mark.parametrize("n,bs,pc", [(15, 8, 2), (40, 12, 4), (7, 3, 1)])
def test_epoch_shard_and_split_indices_match_jax(n, bs, pc):
    for shuffle in (False, True):
        np.testing.assert_array_equal(
            TP.epoch_indices(n, shuffle=shuffle, rng=np.random.default_rng(n)),
            JP.epoch_indices(n, shuffle=shuffle, rng=np.random.default_rng(n)))
    idx = np.random.default_rng(1).permutation(n)
    for pi in range(pc):
        np.testing.assert_array_equal(TP.shard_for_process(idx, pi, pc),
                                      JP.shard_for_process(idx, pi, pc))
        np.testing.assert_array_equal(TP.multihost_indices(idx, bs, pi, pc),
                                      JP.multihost_indices(idx, bs, pi, pc))
    with pytest.raises(ValueError):
        TP.multihost_indices(idx, 2 * bs + 1, 0, 2)
    for frac, seed in ((0.2, 0), (0.1, 3)):
        for a, b in zip(TP.train_val_split(n, frac, seed), JP.train_val_split(n, frac, seed)):
            np.testing.assert_array_equal(a, b)


def test_one_process_without_a_process_group():
    assert not torch.distributed.is_initialized()
    assert TP._process_count() == 1 and TP._process_index() == 0
    idx = np.arange(10)
    np.testing.assert_array_equal(TP.shard_for_process(idx), idx)
    loader = TP.Loader(lambda i: {"i": i}, idx, batch_size=4, multihost=True)
    assert loader.batch_size == 4 and len(loader) == 2


# ---------------------------------------------------------------- Loader


def test_loader_propagates_worker_errors():
    def sample(i):
        if i == 5:
            raise OSError("bad file 5")
        return {"i": np.int64(i)}

    got = []
    with pytest.raises(OSError, match="bad file 5"):
        for b in TP.Loader(sample, np.arange(12), batch_size=2, num_workers=2, prefetch=1):
            got.append(b["i"].tolist())
    assert got == [[0, 1], [2, 3]]


def _pipeline_threads():
    """The live threads a Loader or device_prefetch starts: the producers
    and the decode pool."""
    return [t for t in threading.enumerate()
            if t.name.endswith("(produce)") or t.name == "device-prefetch"
            or t.name.startswith("ThreadPoolExecutor")]


def _settled(deadline_s: float = 10.0) -> bool:
    deadline = time.time() + deadline_s
    while _pipeline_threads() and time.time() < deadline:
        time.sleep(0.05)
    return not _pipeline_threads()


def test_loader_releases_its_producer_when_abandoned():
    assert _settled()
    loader = TP.Loader(lambda i: {"i": np.int64(i)}, np.arange(400), batch_size=2,
                       num_workers=2, prefetch=1)
    for b in loader:
        assert _pipeline_threads()
        break
    assert _settled()


# ---------------------------------------------------------------- device_prefetch


def test_device_prefetch_on_the_cpu_equals_the_synchronous_batches(vigor_root):
    idx = TV.VigorIndex.load(vigor_root)
    sampler = TV.VigorSampler(idx, pos_only=False, **HW)
    fn = lambda raw: TV.device_batch(raw, train=True, sat_hw=HW["sat_hw"], device="cpu")
    hosts = list(TP.Loader(sampler, np.arange(len(idx)), batch_size=4, num_workers=2))
    got = list(TP.device_prefetch(iter(hosts), fn, depth=2, device="cpu"))
    assert len(got) == len(hosts) == len(idx) // 4
    for g, raw in zip(got, hosts):
        want = fn(raw)
        for k in want:
            torch.testing.assert_close(g[k], want[k], rtol=0, atol=0)


def test_device_prefetch_passes_strings_and_moves_numbers():
    seen = []
    raw = {"grd": np.ones((2, 3), np.uint8), "angle": np.float32([1, 2]),
           "city": np.asarray(["NewYork", "Seattle"])}
    out = list(TP.device_prefetch([raw], lambda b: seen.append(b) or b, device="cpu"))
    assert len(out) == 1
    b = seen[0]
    assert isinstance(b["grd"], torch.Tensor) and b["grd"].dtype == torch.uint8
    assert isinstance(b["angle"], torch.Tensor) and b["angle"].dtype == torch.float32
    assert isinstance(b["city"], np.ndarray) and b["city"].tolist() == ["NewYork", "Seattle"]


def test_device_prefetch_propagates_errors_and_releases_its_producer():
    def boom(b):
        if int(b["i"]) == 2:
            raise ValueError("assembly failed")
        return b

    batches = [{"i": np.int64(i)} for i in range(5)]
    got = []
    with pytest.raises(ValueError, match="assembly failed"):
        for b in TP.device_prefetch(batches, boom, device="cpu"):
            got.append(int(b["i"]))
    assert got == [0, 1]
    gen = TP.device_prefetch(({"i": np.int64(i)} for i in range(10 ** 6)), lambda b: b,
                             device="cpu")
    next(gen)
    assert any(t.name == "device-prefetch" for t in _pipeline_threads())
    gen.close()
    assert _settled()


def test_device_prefetch_needs_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        next(TP.device_prefetch([{"i": np.int64(0)}], lambda b: b))
    with pytest.raises(RuntimeError, match="CUDA"):
        TV.device_batch({}, train=True)


# ---------------------------------------------------------------- ArrayCache


def test_array_cache_equals_jax_and_feeds_the_samplers(vigor_root, tmp_path):
    idx_t = TV.VigorIndex.load(vigor_root)
    grd_c = TC.ArrayCache.build(idx_t.grd_paths, HW["grd_hw"], str(tmp_path / "grd"))
    sat_c = TC.ArrayCache.build(idx_t.sat_paths, HW["sat_hw"], str(tmp_path / "sat"))
    j = JC.ArrayCache.build(JV.VigorIndex.load(vigor_root).grd_paths, HW["grd_hw"],
                            str(tmp_path / "jgrd"))
    assert (tmp_path / "grd.u8").read_bytes() == (tmp_path / "jgrd.u8").read_bytes()
    assert grd_c.meta == {**j.meta}
    assert len(grd_c) == len(idx_t) and TC.ArrayCache.exists(str(tmp_path / "grd"))
    grd_c = TC.ArrayCache.open(str(tmp_path / "grd"))
    plain = TV.VigorSampler(idx_t, pos_only=False, **HW)
    cached = TV.VigorSampler(idx_t, pos_only=False, grd_cache=grd_c, sat_cache=sat_c, **HW)
    for i in range(len(idx_t)):
        assert_samples_equal(cached(i), plain(i))
    # the path list is the cache's identity: another list rebuilds it
    assert TC.build_or_open(idx_t.grd_paths, HW["grd_hw"], str(tmp_path / "grd")).meta == grd_c.meta
    other = TC.build_or_open(idx_t.grd_paths[:3], HW["grd_hw"], str(tmp_path / "grd"))
    assert len(other) == 3


def test_array_cache_records_unreadable_files(tmp_path):
    c = TC.ArrayCache.build(["/nonexistent/x.png"], (16, 16), str(tmp_path / "bad"))
    assert c.meta["failed"] == ["/nonexistent/x.png"]
    np.testing.assert_array_equal(c[0], np.zeros((16, 16, 3), np.uint8))
    (tmp_path / "bad.json").write_text("{not json")
    assert not TC.ArrayCache.exists(str(tmp_path / "bad"))


def test_kitti_and_oxford_caches_reproduce_the_direct_samplers(kitti_root, oxford_root, tmp_path):
    index = TK.KittiIndex.load(kitti_root, os.path.join(kitti_root, "test1_files.txt"),
                               test=True)
    plain = TK.KittiSampler(index, rotation_range=10, sat_hw=(128, 128))
    n = len(index)
    grd_c = TC.ArrayCache.build([plain.grd_path(i) for i in range(n)], TK.GRD_HW,
                                str(tmp_path / "kgrd"))
    sat_c = TC.ArrayCache.build([plain.sat_path(i) for i in range(n)],
                                plain._sat_raw_hw(plain.sat_path(0)), str(tmp_path / "ksat"))
    cached = TK.KittiSampler(index, rotation_range=10, sat_hw=(128, 128), grd_cache=grd_c,
                             sat_cache=sat_c)
    assert_samples_equal(cached(1), plain(1))
    oidx = TO.OxfordIndex.load(oxford_root, oxford_root + "satellite_map_new.png", "test")
    oplain = TO.OxfordSampler(oidx)
    ogrd = TC.ArrayCache.build([oplain.grd_path(i) for i in range(len(oidx))], TO.GRD_HW,
                               str(tmp_path / "ogrd"))
    assert_samples_equal(TO.OxfordSampler(oidx, grd_cache=ogrd)(2), oplain(2))


# ---------------------------------------------------------------- native decoder


@pytest.fixture(scope="module")
def native():
    if not NL.available():
        pytest.skip(f"native loader unavailable: {NL.build_error()}")
    return NL


def test_native_build_writes_only_its_build_directory(monkeypatch, tmp_path):
    """A first use builds the source with g++ into the build directory (here
    a temporary one), under a name that hashes the source and flags; no
    argument of the compiler names a path under ccvpe_tpu/."""
    calls = []
    real_run = subprocess.run

    def run(cmd, *a, **kw):
        calls.append((list(cmd), kw.get("cwd")))
        return real_run(cmd, *a, **kw)

    monkeypatch.setattr(NL, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(NL, "_lib", None)
    monkeypatch.setattr(NL, "_build_error", None)
    monkeypatch.setattr(NL.subprocess, "run", run)
    if not NL.available():
        pytest.skip(f"native loader unavailable: {NL.build_error()}")
    assert len(calls) == 1
    cmd, cwd = calls[0]
    assert cwd is None and "-ljpeg" in cmd and "-lpng" in cmd and str(NL.SOURCE) in cmd
    assert not any("ccvpe_tpu" in part for part in cmd)
    built = sorted(p.name for p in (tmp_path / "native").iterdir())
    assert built == [NL.library_path().name]
    assert built[0].startswith("libccvpe_dataloader_")


def test_native_resize_matches_pil_exactly(native):
    rng = np.random.default_rng(1)
    for in_hw, out_hw in [((640, 640), (512, 512)),    # VIGOR satellite
                          ((1024, 2048), (320, 640)),   # VIGOR panorama
                          ((375, 1242), (256, 1024)),   # KITTI ground
                          ((800, 800), (512, 512)),     # Oxford crop
                          ((100, 50), (154, 231))]:     # upscale
        img = rng.integers(0, 255, (*in_hw, 3), dtype=np.uint8)
        want = np.asarray(Image.fromarray(img).resize((out_hw[1], out_hw[0]), Image.BILINEAR))
        np.testing.assert_array_equal(native.resize_bilinear(img, out_hw), want)
    with pytest.raises(ValueError):
        native.resize_bilinear(np.zeros((4, 4, 4), np.uint8), (2, 2))


def test_native_decode_and_statuses(native, tmp_path):
    arr = np.random.default_rng(0).integers(0, 255, (123, 217, 3), dtype=np.uint8)
    Image.fromarray(arr).save(tmp_path / "a.png")
    Image.fromarray(arr).save(tmp_path / "b.jpg", quality=95)
    out, status = native.load_batch([str(tmp_path / "a.png")], arr.shape[:2])
    assert status[0] == 0
    np.testing.assert_array_equal(out[0], arr)
    jpg = np.asarray(Image.open(tmp_path / "b.jpg").convert("RGB"))
    out, status, raw = native.load_batch([str(tmp_path / "b.jpg")], arr.shape[:2],
                                         return_sizes=True)
    assert status[0] == 0 and raw[0].tolist() == [123, 217]
    assert np.mean(np.abs(out[0].astype(int) - jpg.astype(int))) < 1.0
    out, statuses = native.load_batch([str(tmp_path / "a.png"), "/nonexistent/f.png"], (64, 64),
                                      n_threads=2)
    assert statuses[0] == 0 and statuses[1] != 0
    want = np.asarray(Image.fromarray(arr).resize((64, 64), Image.BILINEAR))
    np.testing.assert_array_equal(out[0], want)


def test_native_batches_equal_the_pil_batches(native, vigor_root, kitti_root, oxford_root):
    """``Loader(native_batch=True)`` (one C++ decode per image size and batch,
    through the samplers' plan/assemble) gives the per-sample PIL path's
    batches bit for bit, for VIGOR (PNG tiles and panoramas), KITTI (test
    split, host chain and ``device_augment``) and Oxford (eval crops)."""
    idx = TV.VigorIndex.load(vigor_root)
    frozen = np.linspace(0, 359, len(idx))
    samplers = [(TV.VigorSampler(idx, random_orientation=frozen, **HW), len(idx))]
    kidx = TK.KittiIndex.load(kitti_root, os.path.join(kitti_root, "test1_files.txt"),
                              test=True)
    for aug in (False, True):
        samplers.append((TK.KittiSampler(kidx, rotation_range=10, sat_hw=(128, 128),
                                         device_augment=aug), len(kidx)))
    oidx = TO.OxfordIndex.load(oxford_root, oxford_root + "satellite_map_new.png", "val")
    samplers.append((TO.OxfordSampler(oidx), len(oidx)))
    for sampler, n in samplers:
        ref = TP.Loader(sampler, np.arange(n), batch_size=4, num_workers=2, native_batch=False)
        nat = TP.Loader(sampler, np.arange(n), batch_size=4, num_workers=2, native_batch=True)
        assert nat.native_batch and not ref.native_batch
        for a, b in zip(nat, ref):
            assert_samples_equal(a, b)


def test_native_batch_blank_fallback(native, vigor_root):
    idx = TV.VigorIndex.load(vigor_root)
    idx.grd_paths[1] = "/nonexistent/pano.png"
    sampler = TV.VigorSampler(idx, random_orientation=np.zeros(len(idx)), **HW)
    (batch,) = list(TP.Loader(sampler, np.arange(3), batch_size=3, num_workers=2,
                              native_batch=True))
    assert batch["grd"][1].max() == 0 and batch["grd"][0].max() > 0


def test_native_gate_follows_the_environment(native, monkeypatch, vigor_root):
    """The native decoder is opt-in, as in the JAX package:
    ``CCVPE_NATIVE_LOADER=1`` turns on the batch path and the per-image
    decode, which give the PIL path's PNG images."""
    from ccvpe_torch.data import transforms as TT

    idx = TV.VigorIndex.load(vigor_root)
    sampler = TV.VigorSampler(idx, **HW)
    monkeypatch.delenv("CCVPE_NATIVE_LOADER", raising=False)
    assert not TP.Loader(sampler, np.arange(4), batch_size=2).native_batch
    pil = TT.load_image(idx.grd_paths[0], HW["grd_hw"])
    monkeypatch.setenv("CCVPE_NATIVE_LOADER", "1")
    assert TT._use_native()
    assert TP.Loader(sampler, np.arange(4), batch_size=2).native_batch
    np.testing.assert_array_equal(TT.load_image(idx.grd_paths[0], HW["grd_hw"]), pil)
    img, status = TT.load_image_status("/nonexistent/x.png", (8, 8))
    assert status == 1 and img.shape == (8, 8, 3) and img.max() == 0
