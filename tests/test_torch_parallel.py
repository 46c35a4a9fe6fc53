"""limg_tpu_torch.parallel (the mesh and the streaming corpus) vs the JAX
package on the CPU.

The port's mesh is one process driving a tuple of devices; here 8 entries
of ``cpu`` (the kernels' plain versions), against JAX's 8-device virtual
CPU mesh (tests/conftest.py). With dithering off the two compute the same
function: bpp equal, PSNR within 1e-3 dB except where an endpoint flip
(float add order, ROADMAP.md Queue 3) is shown and recorded in ``FLIPS``,
decodes equal. With dithering on, the port draws from ``image_seed`` and
JAX from threefry, so the multichip gate holds the port to
MULTICHIP_EXPECTED.json's tolerance.
"""

import json
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from limg_tpu.config import EncodeConfig as JConfig
from limg_tpu.encoder import encode_image_device as j_encode_image_device
from limg_tpu.parallel import corpus as jcorpus
from limg_tpu.parallel import mesh as jmesh

import chip_smoke
import limg_tpu_torch
from limg_tpu_torch import native
from limg_tpu_torch.config import EncodeConfig, config_from_jax
from limg_tpu_torch.encoder import encode_image_device
from limg_tpu_torch.ops.dither import image_seed
from limg_tpu_torch.ops.fit import ENDPOINT_FIELDS
from limg_tpu_torch.parallel import corpus, mesh, staging
from limg_tpu_torch.regions import encode_image_merged_device, encode_image_merged_fused_device
from tests.conftest import make_test_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# images whose PSNR may differ from JAX's by more than 1e-3 dB, per
# (crush mode, channels), each with the number of its blocks whose rounded
# endpoints are one apart from JAX's
FLIPS = {("none", 3): {}, ("guess", 3): {}, ("guess", 4): {}}


def _images(n=8, h=24, w=24, seed=13):
    rng = np.random.default_rng(seed)
    return np.stack([make_test_image(rng, h, w) for _ in range(n)])


def _endpoint_flips(img, jcfg) -> int:
    """Blocks whose endpoints differ between JAX's encode and the port's."""
    _, jres = j_encode_image_device(jnp.asarray(img), jcfg, jax.random.PRNGKey(0))
    _, tres, _ = encode_image_device(img, config_from_jax(jcfg), 0, "cpu")
    differ = np.zeros(tres.shifts.shape[1], bool)
    for f in ENDPOINT_FIELDS:
        t, j = getattr(tres.decomposition, f).numpy(), np.asarray(getattr(jres.decomposition, f))
        assert np.abs(t - j).max() <= 1, f
        differ |= (t != j).any(axis=0)
    return int(differ.sum())


def test_make_mesh():
    assert mesh.make_mesh(8, device="cpu") == (torch.device("cpu"),) * 8
    assert mesh.make_mesh(device="cpu") == (torch.device("cpu"),)
    with pytest.raises(ValueError):
        mesh.make_mesh(0, device="cpu")
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="visible"):
        mesh.make_mesh(visible + 1, device="cuda")
    if visible == 0:
        with pytest.raises(RuntimeError, match="visible"):
            mesh.make_mesh(device="cuda")


@pytest.mark.parametrize("mode,channels", [("none", 3), ("guess", 3), ("guess", 4)])
def test_corpus_sharded_matches_jax(mode, channels):
    images = _images()
    jcfg = JConfig(error_factor=100, crush_mode=mode, dithering=False, has_alpha=channels == 4)
    want = jmesh.encode_corpus_sharded(images, jcfg, n_devices=8)
    got = mesh.encode_corpus_sharded(images, config_from_jax(jcfg), n_devices=8, device="cpu")
    assert got["psnr"].dtype == want["psnr"].dtype and got["bpp"].dtype == want["bpp"].dtype
    np.testing.assert_array_equal(got["bpp"], want["bpp"])
    off = np.flatnonzero(np.abs(got["psnr"] - want["psnr"]) > 1e-3)
    flips = {int(i): _endpoint_flips(images[i], jcfg) for i in off}
    assert flips == FLIPS[(mode, channels)]
    assert abs(got["mean_psnr"] - got["psnr"].mean()) < 1e-4
    assert abs(got["mean_psnr"] - want["mean_psnr"]) < 1e-3 + 0.01 * len(off)


def test_corpus_sharded_independent_of_mesh_size():
    images = _images()
    cfg = EncodeConfig(error_factor=100, crush_mode="guess", dithering=False)
    outs = [mesh.encode_corpus_sharded(images, cfg, n_devices=n, device="cpu") for n in (1, 2, 8)]
    for out in outs[1:]:
        for k in ("psnr", "bpp", "mean_psnr"):
            np.testing.assert_array_equal(out[k], outs[0][k])
    with pytest.raises(ValueError, match="split evenly"):
        mesh.encode_corpus_sharded(images[:6], cfg, n_devices=4, device="cpu")


def test_corpus_shard_is_one_launch_per_shard(monkeypatch):
    calls = []
    real = mesh.encoder.encode_blocks_kernel

    def counted(packed, *args, **kwargs):
        calls.append(packed.shape[1])
        return real(packed, *args, **kwargs)

    monkeypatch.setattr(mesh.encoder, "encode_blocks_kernel", counted)
    cfg = EncodeConfig(error_factor=100, crush_mode="guess")
    mesh.encode_corpus_sharded(_images(), cfg, n_devices=2, device="cpu")
    assert calls == [4 * 9, 4 * 9]      # 4 images of 9 blocks a shard


# a 750x997 RGBA frame is 2,991,000 bytes: chunks of 1 MiB do not divide it
# (3 frames wrap a ring of 3 three times), chunks of 75 rows do (10 a frame,
# so a ring of 2 wraps 5 times a frame); 16 MiB is more than a whole shard
CHUNK_WALKS = {"ragged_1MiB_ring3": (1 << 20, 3), "75_rows_ring2": (75 * 997 * 4, 2),
               "one_chunk_ring2": (16 << 20, 2)}


@pytest.mark.parametrize("walk", sorted(CHUNK_WALKS))
@pytest.mark.parametrize("frames", [1, 2, 3])
def test_staged_chunk_walk_lands_every_frame(frames, walk):
    """Shard 1 of a batch of 750x997 RGBA frames through the staged upload's
    chunk walk, host buffers in place of pinned ones: every frame lands byte
    for byte and in order, whether a chunk divides a frame or not and however
    often the ring of buffers wraps."""
    chunk, slots = CHUNK_WALKS[walk]
    batch = torch.from_numpy(np.random.default_rng(frames).integers(
        0, 256, (3 * frames, 750, 997, 4), dtype=np.uint8))
    src = batch[frames:2 * frames]
    dst = torch.zeros_like(src)
    ring = [torch.empty(chunk, dtype=torch.uint8) for _ in range(slots)]
    staging._walk(src.reshape(-1), dst.view(-1), ring)
    assert torch.equal(dst, src)


def test_corpus_encodes_a_batch_refilled_in_place_afresh():
    """A caller that refills its batch in place between calls gets the new
    frames' stats: nothing of a batch is kept from one call to the next."""
    cfg = EncodeConfig(error_factor=100, crush_mode="guess")
    batch = _images(n=4, seed=21)
    first = mesh.encode_corpus_sharded(batch, cfg, n_devices=2, seed=5, device="cpu")
    other = _images(n=4, seed=22)
    batch[...] = other
    again = mesh.encode_corpus_sharded(batch, cfg, n_devices=2, seed=5, device="cpu")
    fresh = mesh.encode_corpus_sharded(other.copy(), cfg, n_devices=2, seed=5, device="cpu")
    for k in ("psnr", "bpp", "mean_psnr"):
        np.testing.assert_array_equal(again[k], fresh[k])
    assert not np.array_equal(first["psnr"], again["psnr"])


@pytest.mark.parametrize("fault", [False, True])
def test_corpus_starts_every_staged_upload_before_any_shard_work(monkeypatch, fault):
    """With staging standing in for cards, a fixed-grid corpus call starts
    every shard's upload, each once, before it enqueues any shard's work,
    and a shard waits for its own upload before its work. A shard asked for
    on another device than the one its upload was started for (here shard 0,
    on a device of its own each time) is uploaded anew there, and the uploads
    that no shard took are waited for on leaving."""
    events = []

    class Started:
        def __init__(self, src):
            self.src = src

        def result(self):
            events.append("wait")
            return self.src.clone()

    def start(src, dev):
        events.append("start")
        return Started(src)

    monkeypatch.setattr(staging, "staged", lambda src, dev: True)
    monkeypatch.setattr(staging, "start", start)
    shard = mesh._corpus_shard
    monkeypatch.setattr(mesh, "_corpus_shard", lambda *a: events.append("shard") or shard(*a))
    if fault:
        upload = mesh._upload
        monkeypatch.setattr(mesh, "_upload", lambda batch, k, n_loc, dev: upload(
            batch, 0, n_loc, torch.device("cpu", k)))
    cfg = EncodeConfig(error_factor=100, crush_mode="guess")
    images = _images()
    out = mesh.encode_corpus_sharded(images, cfg, n_devices=4, device="cpu")
    if fault:
        assert events == ["start"] * 4 + ["start", "wait", "shard"] * 4 + ["wait"] * 4
        images = np.concatenate([images[:2]] * 4)
    else:
        assert events == ["start"] * 4 + ["wait", "shard"] * 4
    monkeypatch.undo()
    want = mesh.encode_corpus_sharded(images, cfg, n_devices=4, device="cpu")
    for k in ("psnr", "bpp", "mean_psnr"):
        np.testing.assert_array_equal(out[k], want[k])


def test_blocks_sharded():
    img = make_test_image(np.random.default_rng(4242), 32, 64)
    jcfg = JConfig(error_factor=100, crush_mode="none", dithering=False)
    cfg = config_from_jax(jcfg)
    dec8, psnr8, bpp8 = mesh.encode_image_blocks_sharded(img, cfg, n_devices=8, device="cpu")
    dec1, psnr1, bpp1 = mesh.encode_image_blocks_sharded(img, cfg, n_devices=1, device="cpu")
    assert dec8.shape == (32, 64, 3) and dec8.dtype == np.uint8
    np.testing.assert_array_equal(dec8, dec1)
    assert (psnr8, bpp8) == (psnr1, bpp1)
    jdec, jpsnr, jbpp = jmesh.encode_image_blocks_sharded(img, jcfg, n_devices=8)
    np.testing.assert_array_equal(dec8, jdec)
    assert abs(psnr8 - jpsnr) < 1e-4 and abs(bpp8 - jbpp) < 1e-6
    # 15 blocks over 7 shards: padded with empty blocks, which cost nothing
    dec7, psnr7, bpp7 = mesh.encode_image_blocks_sharded(img[:24, :40], cfg, n_devices=7,
                                                         device="cpu")
    ref = mesh.encode_image_blocks_sharded(img[:24, :40], cfg, n_devices=1, device="cpu")
    np.testing.assert_array_equal(dec7, ref[0])
    assert (psnr7, bpp7) == ref[1:]


@pytest.mark.parametrize("channels", [3, 4])
def test_blocks_sharded_one_shard_is_encode_image(channels):
    """One shard, dithering on: the seed and the block indices are
    encode_image's, so is the decode."""
    img = make_test_image(np.random.default_rng(4243), 37, 61)[..., :channels]
    cfg = EncodeConfig(error_factor=100, crush_mode="ladder", has_alpha=channels == 4)
    dec, psnr, bpp = mesh.encode_image_blocks_sharded(img, cfg, n_devices=1, seed=5,
                                                      device="cpu")
    ref = limg_tpu_torch.encode_image(img, cfg, seed=5, device="cpu")
    np.testing.assert_array_equal(dec, ref["decoded"][..., :channels])
    assert abs(psnr - ref["psnr"]) < 1e-9
    nb = 5 * 8
    header = (3 * 9 * 2 + 3 * 8 + 32) if channels == 3 else (4 * 9 * 2 + 4 * 8 + 32)
    assert abs(bpp - (ref["avg_block_bits"] + header * nb / (37 * 61))) < 1e-9


def test_corpus_sharded_mixed(tmp_path):
    """Two shape buckets, some images given as TGA paths; each bucket's
    pad images do not reach the stats."""
    rng = np.random.default_rng(31)
    imgs = [make_test_image(rng, 32, 40) for _ in range(5)]
    imgs += [make_test_image(rng, 48, 24) for _ in range(3)]
    fill_a = [make_test_image(rng, 32, 40) for _ in range(3)]
    fill_b = [make_test_image(rng, 48, 24) for _ in range(5)]
    items = list(imgs)
    for i in (1, 6):
        items[i] = str(tmp_path / f"img{i}.tga")
        native.write_tga(items[i], imgs[i])
    cfg = EncodeConfig(error_factor=100, crush_mode="guess")
    out = mesh.encode_corpus_sharded_mixed(items, cfg, n_devices=8, seed=2, device="cpu")
    assert out["buckets"] == {"(32, 40, 4)": 5, "(48, 24, 4)": 3}
    direct_a = mesh.encode_corpus_sharded(np.stack(imgs[:5] + fill_a), cfg, n_devices=8,
                                          seed=2, device="cpu")
    direct_b = mesh.encode_corpus_sharded(np.stack(imgs[5:8] + fill_b), cfg, n_devices=8,
                                          seed=2, device="cpu")
    np.testing.assert_array_equal(out["psnr"][:5], direct_a["psnr"][:5])
    np.testing.assert_array_equal(out["bpp"][:5], direct_a["bpp"][:5])
    np.testing.assert_array_equal(out["psnr"][5:], direct_b["psnr"][:3])
    np.testing.assert_array_equal(out["bpp"][5:], direct_b["bpp"][:3])
    assert out["mean_psnr"] == out["psnr"].mean()


@pytest.mark.parametrize("fused", [True, False])
def test_corpus_sharded_merged(fused):
    """Each image is the port's own per-image merged encode with
    image_seed(seed, i), dithering on (those encodes are held against JAX
    in tests/test_torch_merged.py and tests/test_torch_dense.py)."""
    images = _images(h=40, w=48, seed=11)
    images[0, :16, :, :3] = [50, 100, 150]
    cfg = EncodeConfig(error_factor=100)
    out = mesh.encode_corpus_sharded_merged(images, cfg, n_devices=8, seed=3, num_levels=2,
                                            fused=fused, device="cpu")
    encode = encode_image_merged_fused_device if fused else encode_image_merged_device
    for i, img in enumerate(images):
        ref = encode(img, cfg, image_seed(3, i), 2, emit_planes=False, device="cpu")
        assert out["psnr"][i] == mesh._psnr(ref["total_err"], 40 * 48, 3).item()
        assert out["bpp"][i] == ref["mean_bpp"].to(torch.float32).item()
    assert (out["psnr"] > 25).all() and abs(out["mean_psnr"] - out["psnr"].mean()) < 1e-4


def _write_corpus(tmp_path, n=4, h=40, w=56):
    rng = np.random.default_rng(23)
    paths = []
    for i in range(n):
        paths.append(str(tmp_path / f"c{i}.tga"))
        native.write_tga(paths[-1], make_test_image(rng, h, w))
    return paths


def test_corpus_streaming_matches_jax(tmp_path):
    assert native.available()
    paths = _write_corpus(tmp_path)
    paths.insert(2, str(tmp_path / "missing.tga"))
    jcfg = JConfig(error_factor=100, crush_mode="guess", dithering=False)
    want = jcorpus.encode_corpus_streaming(paths, 40, 56, jcfg, use_pallas=False)
    got = corpus.encode_corpus_streaming(paths, 40, 56, config_from_jax(jcfg), pool_threads=2,
                                         device="cpu")
    assert got["failed"] == want["failed"] == [2]
    np.testing.assert_array_equal(got["bpp"], want["bpp"])
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=0, atol=1e-3)

    # the fallback without the native runtime reads the same numbers
    fallback = _streaming_without_native([p for i, p in enumerate(paths) if i != 2])
    keep = [0, 1, 3, 4]
    assert fallback["psnr"] == got["psnr"][keep].tolist()
    assert fallback["bpp"] == got["bpp"][keep].tolist()


def _streaming_without_native(paths) -> dict:
    """encode_corpus_streaming (crush "guess", dithering off) of (40, 56)
    files in a process where the native runtime is disabled."""
    code = ("import json, sys; from limg_tpu_torch.config import EncodeConfig; "
            "from limg_tpu_torch import native; from limg_tpu_torch.parallel import corpus; "
            "assert not native.available(); "
            "out = corpus.encode_corpus_streaming(json.loads(sys.argv[1]), 40, 56, "
            "EncodeConfig(error_factor=100, crush_mode='guess', dithering=False), device='cpu'); "
            "print(json.dumps({k: [float(x) for x in out[k]] for k in ('psnr', 'bpp')} "
            "| {'failed': out['failed']}))")
    env = dict(os.environ, LIMG_TPU_DISABLE_NATIVE="1")
    proc = subprocess.run([sys.executable, "-c", code, json.dumps(paths)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_corpus_streaming_rejects_other_sizes(tmp_path):
    """A file larger or smaller than (height, width) is not staged (the
    pool's readers would write its own size into the slot's buffer) and
    lands in ``failed``, with and without the native runtime."""
    paths = _write_corpus(tmp_path, n=2)
    rng = np.random.default_rng(29)
    for name, (h, w) in (("big", (48, 64)), ("small", (32, 48))):
        paths.insert(1, str(tmp_path / f"{name}.tga"))
        native.write_tga(paths[1], make_test_image(rng, h, w))
    pool = native.StagingPool(1)
    try:
        assert pool.stage(paths[1], 40, 56)[2][0] == native.STATUS_SIZE_MISMATCH
    finally:
        pool.close()
    cfg = EncodeConfig(error_factor=100, crush_mode="guess", dithering=False)
    got = corpus.encode_corpus_streaming(paths, 40, 56, cfg, device="cpu")
    alone = corpus.encode_corpus_streaming([paths[0], paths[3]], 40, 56, cfg, device="cpu")
    assert got["failed"] == [1, 2]
    assert got["psnr"][[0, 3]].tolist() == alone["psnr"].tolist()
    fallback = _streaming_without_native(paths)
    assert fallback["failed"] == [1, 2] and fallback["psnr"] == got["psnr"].tolist()


def test_corpus_streaming_seeds(tmp_path):
    """Image i of a dithered stream is the fixed grid of image_seed(seed, i)."""
    paths = _write_corpus(tmp_path, n=3)
    cfg = EncodeConfig(error_factor=100, crush_mode="ladder")
    got = corpus.encode_corpus_streaming(paths, 40, 56, cfg, seed=9, device="cpu")
    for i, p in enumerate(paths):
        img = native.read_tga(p)
        packed, mask = native.blockify_packed(img)
        psnr, bpp = corpus._encode_packed_stats(*corpus._upload(packed, mask, "cpu"), cfg,
                                                image_seed(9, i))
        assert (got["psnr"][i], got["bpp"][i]) == (psnr.item(), bpp.item())


def test_slot_wait_returns_on_its_own_slot(tmp_path):
    """The loop's wait returns once its own file is staged while another
    file is still being read (a FIFO whose writer has not come yet); the
    pool's await_all would wait for both."""
    assert native.available()
    good = _write_corpus(tmp_path, n=1)[0]
    fifo = str(tmp_path / "slow.tga")
    os.mkfifo(fifo)

    def release():     # opening and closing the writer gives the reader EOF
        with open(fifo, "wb"):
            pass

    safety = threading.Timer(30.0, release)
    safety.start()
    pool = native.StagingPool(2)
    pool._probe = lambda path: (0, 40, 56)     # reading the FIFO's header would wait here
    try:
        slow = pool.stage(fifo, 40, 56)
        slot = pool.stage(good, 40, 56)
        t0 = time.perf_counter()
        corpus._await_slot(slot[2])
        assert time.perf_counter() - t0 < 20.0
        assert slot[2][0] == 1 and slow[2][0] == 0
        safety.cancel()
        release()
        corpus._await_slot(slow[2])
        assert slow[2][0] < 0
    finally:
        safety.cancel()
        pool.close()


def test_dryrun_image_is_the_graft_entry_image():
    for h, w in ((64, 64), (64, 128), (256, 256)):
        np.testing.assert_array_equal(chip_smoke.dryrun_image(h, w),
                                      __graft_entry__._test_image(h, w))


def test_multichip_gate_on_the_cpu_mesh():
    """__graft_entry__.dryrun_multichip's three paths on the port's 8-entry
    CPU mesh, within MULTICHIP_EXPECTED.json's tolerance."""
    got = chip_smoke.multichip_gate(8, "cpu")
    assert set(got) == {"corpus", "blocks", "merged"}
