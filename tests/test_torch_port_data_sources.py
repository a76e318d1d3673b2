"""PyTorch port, the raw-image data plane on the CPU against the JAX
package: the bin tables, R2 presigning (string-equal on fixed credentials
and time), the uint8 pixel packing, the native JPEG decoder, the image and
Dreambooth samplers' batch streams (bit-equal through the native decoder
and through cv2), the url and R2 shard sources, the shard writer and the
shard generator, and ``download_tar``/``upload_file`` against a local HTTP
server."""

import datetime
import http.server
import os
import threading

import numpy as np
import pytest
import torch
from tests.torch_threads import torch_threads  # noqa: F401 (autouse)

cv2 = pytest.importorskip("cv2")

from yat_tpu.data import bins as JB  # noqa: E402
from yat_tpu.data import r2 as JR2  # noqa: E402
from yat_tpu.data import sampler as JS  # noqa: E402
from yat_tpu.data import tar as JT  # noqa: E402
from yat_tpu_torch.data import bins as TB  # noqa: E402
from yat_tpu_torch.data import r2 as TR2  # noqa: E402
from yat_tpu_torch.data import sampler as TS  # noqa: E402
from yat_tpu_torch.data import tar as TT  # noqa: E402

# the 512px bins at several aspect ratios: (height, width) of the sources
SIZES = [(512, 512), (384, 640), (640, 384), (352, 704), (704, 352),
         (500, 333), (300, 480)]


def _jpeg(rng, h, w, quality=90):
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(x * 255 // max(w - 1, 1)), (y * 255 // max(h - 1, 1)),
                    rng.integers(0, 256, (h, w))], -1).astype(np.uint8)
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    return enc.tobytes()


def make_raw_shard(path, n=14, seed=0, broken=(), png=()):
    """``{jpg, txt}`` samples at the sizes above (``broken``: a header that
    parses and a body that does not; ``png``: a PNG in place of the
    JPEG)."""
    rng = np.random.default_rng(seed)
    with TT.TarShardWriter(str(path)) as w:
        for i in range(n):
            h, wd = SIZES[i % len(SIZES)]
            h, wd = h // 4, wd // 4
            sample = {"__key__": f"{i:04d}", "txt": f"caption number {i}"}
            if i in png:
                img = rng.integers(0, 256, (h, wd, 3), np.uint8)
                sample["png"] = cv2.imencode(".png", img)[1].tobytes()
            else:
                data = _jpeg(rng, h, wd)
                if i in broken:
                    data = data[:len(data) // 3] + b"\x00" * 64
                sample["jpg"] = data
            w.write(sample)
    return str(path)


# ---------------------------------------------------------------------------
# bins, presigning, pixel packing
# ---------------------------------------------------------------------------

def test_bins_match_jax():
    for res in (256, 512, 1024, 2048, 768):
        assert TB.bin_for_resolution(res) == JB.bin_for_resolution(res)
    table = TB.ASPECT_RATIO_512_BIN
    for r in np.linspace(0.2, 4.5, 301):
        key = TB.find_closest_ratio(float(r), table)
        assert key == JB.find_closest_ratio(float(r), JB.ASPECT_RATIO_512_BIN)
        assert TB.bucket_size(key, table) == JB.bucket_size(key, table)
        assert TB.latent_size(key, table, 32) == JB.latent_size(key, table,
                                                               32)


@pytest.mark.parametrize("method,bucket,key,expires", [
    ("GET", "bkt", "raw/shard-000001.tar", 604800),
    ("PUT", "my-dataset", "features/shard 7+x.tar", 3600),
    ("GET", "", "a/b/c.tar", 60)])
def test_presign_matches_jax(method, bucket, key, expires):
    now = datetime.datetime(2026, 3, 4, 5, 6, 7,
                            tzinfo=datetime.timezone.utc)
    args = ("AKIDEXAMPLE", "wJalrXUtnFEMI/K7MDENG", "https://acct.r2.cloud"
            "flarestorage.com/")
    got = TR2.R2Client(*args).presign(method, bucket, key, expires, now=now)
    want = JR2.R2Client(*args).presign(method, bucket, key, expires, now=now)
    assert got == want
    assert "X-Amz-Signature=" in got and "X-Amz-Expires=%d" % expires in got
    keys = ["a.tar", "b/c.tar"]
    # real time on both sides: equal within the same second
    for _ in range(3):
        t = TR2.get_secured_urls(*args, bucket or "b", keys)
        j = JR2.get_secured_urls(*args, bucket or "b", keys)
        if t == j:
            break
    assert t == j


def test_pixel_packing_matches_jax():
    import jax.numpy as jnp

    from yat_tpu.frontends import common as JC
    from yat_tpu_torch.frontends import common as TC

    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (2, 5, 7, 3), np.uint8)
    fl = rng.uniform(-1.2, 1.2, (2, 5, 7, 3)).astype(np.float32)
    for x in (u8, fl):
        np.testing.assert_array_equal(TC.pixels_to_u8(x), JC.pixels_to_u8(x))
    assert TC.pixels_to_u8(u8) is u8
    got = TC.u8_to_unit(torch.from_numpy(u8)).numpy()
    want = np.asarray(JC.u8_to_unit(jnp.asarray(u8)))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the native decoder
# ---------------------------------------------------------------------------

def test_native_decoder_matches_jax():
    from yat_tpu.data import native as JN
    from yat_tpu_torch.data import native as TN

    if not JN.available():
        pytest.skip("the JAX package's native decoder did not build here")
    assert TN.available(), TN.unavailable_reason()
    assert TN.unavailable_reason() is None
    path = TN.library_path()
    assert path.parent.name == "_build" and path.exists()
    assert "yat_tpu_torch" in str(path)
    rng = np.random.default_rng(1)
    datas = [_jpeg(rng, h, w) for h, w in SIZES]
    for d in datas:
        assert TN.jpeg_dims(d) == JN.jpeg_dims(d)
    datas.append(b"not a jpeg")
    assert TN.jpeg_dims(datas[-1]) is None
    for th, tw in ((256, 256), (192, 320), (96, 48)):
        got, st = TN.decode_batch(datas, th, tw)
        want, jst = JN.decode_batch(datas, th, tw, u8=True)
        np.testing.assert_array_equal(st, jst)
        assert list(st[:-1]) == [0] * len(SIZES) and st[-1] != 0
        np.testing.assert_array_equal(got[:-1], want[:-1])


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------

def _take(sampler, n):
    out = []
    for b in sampler:
        out.append(b)
        if len(out) == n:
            break
    return out


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.ratio == w.ratio
        assert g.captions == w.captions
        assert g.images.dtype == np.uint8 and g.images.shape == w.images.shape
        np.testing.assert_array_equal(g.images, w.images)
        assert g.is_regularization == w.is_regularization


@pytest.mark.parametrize("native", [True, False], ids=["native", "cv2"])
def test_image_bucket_sampler_matches_jax(tmp_path, native):
    """Two shards (a broken JPEG body replaced by a good sample of its
    batch, a PNG through cv2), the shuffle and the bucket drain order: the
    same batch stream, bit for bit."""
    from yat_tpu.data import native as JN

    if native and not JN.available():
        pytest.skip("the JAX package's native decoder did not build here")
    a = make_raw_shard(tmp_path / "a.tar", n=14, seed=0, broken=(3,),
                       png=(5,))
    b = make_raw_shard(tmp_path / "b.tar", n=14, seed=1)
    bins = TB.bin_for_resolution(512)
    kw = dict(seed=3, shuffle_buffer=6, use_native=native)
    port = TS.ImageBucketSampler(TS.LocalShardSource([a, b], seed=5), 2,
                                 bins, **kw)
    jax_s = JS.ImageBucketSampler(JS.LocalShardSource([a, b], seed=5), 2,
                                  JB.bin_for_resolution(512), **kw)
    assert port.decoder == ("native" if native else "cv2")
    got, want = _take(port, 16), _take(jax_s, 16)
    _same_batches(got, want)
    assert len({g.ratio for g in got}) > 2
    for g in got:
        th, tw = bins[g.ratio]
        assert g.images.shape == (2, th, tw, 3)


def test_image_bucket_sampler_drops_undecodable_batch(tmp_path):
    """Undecodable images never make a batch (none is zero-filled); one
    pass over a finite list of shards ends."""
    path = tmp_path / "bad.tar"
    with TT.TarShardWriter(str(path)) as w:
        for i in range(2):
            w.write({"__key__": f"{i}", "jpg": _jpeg(
                np.random.default_rng(i), 64, 64)[:200] + b"\x00" * 8,
                "txt": "x"})
    s = TS.ImageBucketSampler([str(path)], 2, TB.bin_for_resolution(256))
    assert list(s) == []


def _folder(path, n, seed, captions=()):
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        h, w = SIZES[(i * 3) % len(SIZES)]
        with open(os.path.join(path, f"img_{i:02d}.jpg"), "wb") as f:
            f.write(_jpeg(rng, h // 4, w // 4))
        if i in captions:
            with open(os.path.join(path, f"img_{i:02d}.txt"), "w") as f:
                f.write(f"  own caption {i}  ")
    with open(os.path.join(path, "notes.md"), "w") as f:
        f.write("not an image")
    return str(path)


@pytest.mark.parametrize("reg", ["folder", "shards"])
def test_dreambooth_sampler_matches_jax(tmp_path, reg):
    """Instance passes and regularization passes (a folder, or a finite
    list of shards that starts over) alternate with the same batches,
    captions and ``is_regularization`` as the JAX package."""
    inst = _folder(tmp_path / "inst", 7, 0, captions=(2,))
    kw = dict(num_regularisation_passes=2, seed=4)
    if reg == "folder":
        reg_folder, reg_src = _folder(tmp_path / "reg", 6, 1), None
    else:
        reg_folder = None
        reg_src = [make_raw_shard(tmp_path / "r0.tar", n=6, seed=2),
                   make_raw_shard(tmp_path / "r1.tar", n=5, seed=3)]
    bins = TB.bin_for_resolution(512)
    port = TS.DreamboothSampler(inst, reg_folder, "sks", "dog", 2, 2, bins,
                                reg_shard_source=reg_src, **kw)
    jax_s = JS.DreamboothSampler(inst, reg_folder, "sks", "dog", 2, 2,
                                 JB.bin_for_resolution(512),
                                 reg_shard_source=reg_src, **kw)
    got, want = _take(port, 14), _take(jax_s, 14)
    _same_batches(got, want)
    flags = [g.is_regularization for g in got]
    assert True in flags and False in flags
    caps = {c for g in got for c in g.captions}
    assert "sks dog" in caps and "own caption 2" in caps
    assert "dog" in caps or any(c.startswith("caption number") for c in caps)


# ---------------------------------------------------------------------------
# url and R2 sources
# ---------------------------------------------------------------------------

def _fake_download(calls, src, fail_first=0):
    def download(url, local_path, **kw):
        calls.append(url)
        if len(calls) <= fail_first:
            raise OSError("transient")
        import shutil
        shutil.copy(src, local_path)
    return download


def _drain_paths(source, n):
    out = []
    for p in source:
        assert os.path.exists(p)
        out.append(os.path.basename(p))
        if len(out) == n:
            break
    source.stop()
    return out


def test_url_and_r2_sources_draw_like_jax(tmp_path, monkeypatch):
    """The random draws over urls (weighted) and R2 names, the presigned
    GET of ``features_path/name``, the temp names, a transient failure
    skipped, and each consumed file removed: the same as the JAX
    package's."""
    src = make_raw_shard(tmp_path / "src.tar", n=2)
    runs = {}
    for pkg, S, R2 in (("port", TS, TR2), ("jax", JS, JR2)):
        tmp = str(tmp_path / pkg)
        # each source's worker binds download_tar as it starts, before the
        # first path arrives: one list of calls per source
        calls_u, calls_r = [], []
        monkeypatch.setattr(R2, "download_tar",
                            _fake_download(calls_u, src, fail_first=1))
        u = S.UrlShardSource([f"http://h/{i}.tar" for i in range(5)],
                             seed=2, probs=[1, 2, 3, 4, 5],
                             local_temp_dir=tmp + "u")
        paths_u = _drain_paths(u, 4)
        monkeypatch.setattr(R2, "download_tar",
                            _fake_download(calls_r, src, fail_first=1))
        r = S.RemoteShardSource(
            [f"shard-{i:06d}.tar" for i in range(6)], "raw", "AK", "SK",
            "https://acct.example.com", "bkt", seed=2,
            local_temp_dir=tmp + "r")
        paths_r = _drain_paths(r, 3)
        # the failed call and one per consumed shard (a worker may fetch
        # ahead before it sees stop)
        runs[pkg] = (paths_u, paths_r, calls_u[:5],
                     [c.split("?")[0] for c in calls_r[:4]])
    assert runs["port"] == runs["jax"]
    assert runs["port"][3][0].startswith(
        "https://acct.example.com/bkt/raw/shard-")


def test_remote_source_one_pass_and_failures(tmp_path, monkeypatch):
    """``one_pass`` walks the names once, in order, then ends; 20 failed
    downloads in a row reach the consumer as an error."""
    src = make_raw_shard(tmp_path / "src.tar", n=2)
    calls = []
    monkeypatch.setattr(TR2, "download_tar", _fake_download(calls, src))
    names = [f"shard-{i:06d}.tar" for i in range(3)]
    r = TS.RemoteShardSource(names, "", "AK", "SK", "http://127.0.0.1:9",
                             "b", local_temp_dir=str(tmp_path / "t"),
                             one_pass=True)
    assert len(list(r)) == 3
    assert [c.split("?")[0].rsplit("/", 1)[1] for c in calls] == names
    assert os.listdir(tmp_path / "t") == []

    def always_fail(url, local_path, **kw):
        raise OSError("expired")
    monkeypatch.setattr(TR2, "download_tar", always_fail)
    u = TS.UrlShardSource(["http://x/a.tar"],
                          local_temp_dir=str(tmp_path / "u"))
    with pytest.raises(RuntimeError, match="20 consecutive"):
        next(iter(u))


def test_source_precedence_and_shard_names(tmp_path):
    from yat_tpu.config import TrainingParameters as JParams
    from yat_tpu.frontends import common as JC
    from yat_tpu_torch.config import TrainingParameters
    from yat_tpu_torch.frontends import common as TC

    base = {"batch_size": "1", "learning_rate": "1e-4", "steps": "1",
            "num_steps_per_validation": "10", "validation_prompts": []}
    r2 = {"r2_endpoint": "https://e", "r2_access_key": "a",
          "r2_secret_key": "s", "r2_bucket_name": "b"}
    p = TrainingParameters.from_dict({**base, "local_shard_paths": ["x"],
                                      "urls": ["http://u"]})
    assert isinstance(TC.make_image_source(p), TS.LocalShardSource)
    assert TC.make_image_source(p, one_pass=True) == ["x"]
    p = TrainingParameters.from_dict({**base, "urls": ["http://u/s.tar"]})
    assert isinstance(TC.make_image_source(p), TS.UrlShardSource)
    for extra in ({"num_shards": "3"}, {"r2_tar_files": ["a.tar", "b.tar"]},
                  {}):
        raw = {**base, **r2, **extra}
        p, jp = TrainingParameters.from_dict(raw), JParams.from_dict(raw)
        assert isinstance(TC.make_image_source(p), TS.RemoteShardSource)
        for per_host in (True, False):
            assert TC.r2_shard_names(p, per_host) == JC.r2_shard_names(
                jp, per_host)
    for n in (0, 1, 7):
        for pc in (1, 3):
            for pi in range(pc):
                rng = TC.shard_range_for_host(n, pi, pc)
                assert rng.start >= 0 and rng.stop <= n
    assert TC.shard_range_for_host(7, 2, 3) == range(4, 7)
    p = TrainingParameters.from_dict({**base, "urls": []})
    with pytest.raises(ValueError, match="raw-image shard source"):
        TC.make_image_source(p)
    assert TC.build_feature_sampler(p, 8) is None


# ---------------------------------------------------------------------------
# shard writer and generator
# ---------------------------------------------------------------------------

def _tar_members(path):
    import tarfile
    with tarfile.open(path) as tf:
        return [(m.name, tf.extractfile(m).read()) for m in tf]


def test_shard_writer_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    samples = [{"__key__": f"{i:08d}", "ratio": "1.0",
                "latent.npy": rng.standard_normal((2, 2, 4), np.float32),
                "emb.npy": rng.standard_normal((3, 8), np.float32)}
               for i in range(7)]
    done = {}
    for pkg, T in (("port", TT), ("jax", JT)):
        done[pkg] = []
        with T.ShardWriter(str(tmp_path / pkg / "shard-%06d.tar"),
                           maxcount=3, on_shard_complete=lambda p, i, d=done[
                               pkg]: d.append((os.path.basename(p), i))) as w:
            for s in samples:
                w.write(s)
    assert done["port"] == done["jax"] == [
        ("shard-000000.tar", 0), ("shard-000001.tar", 1),
        ("shard-000002.tar", 2)]
    for name, _ in done["port"]:
        assert _tar_members(tmp_path / "port" / name) == _tar_members(
            tmp_path / "jax" / name)


def test_generate_shards_matches_jax(tmp_path):
    """Re-sharding two source TARs (one with a sample lacking its caption)
    and a caption join by key: the same shards as the JAX package's."""
    from yat_tpu.data import generate_shards as JG
    from yat_tpu_torch.data import generate_shards as TG

    a = make_raw_shard(tmp_path / "a.tar", n=5, seed=0, png=(1,))
    b = tmp_path / "b.tar"
    with TT.TarShardWriter(str(b)) as w:
        w.write({"__key__": "x1", "jpg": b"\xff\xd8junk"})   # no caption
        w.write({"__key__": "x2", "jpg": b"\xff\xd8more", "txt": "two"})
    caps = tmp_path / "caps.tar"
    with TT.TarShardWriter(str(caps)) as w:
        w.write({"__key__": "0001", "json": {"caption": "joined one"}})
        w.write({"__key__": "0003", "txt": "joined three"})
    for kw in ({}, {"caption_sources": [str(caps)]}):
        outs = {}
        for pkg, G in (("port", TG), ("jax", JG)):
            out = tmp_path / f"{pkg}{len(kw)}"
            # a missing source is skipped (the join reads every source)
            missing = [] if kw else [str(tmp_path / "missing.tar")]
            n = G.generate_shards([a, str(b)] + missing, str(out),
                                  shard_size=2, **kw)
            outs[pkg] = (n, sorted(os.listdir(out)))
        assert outs["port"] == outs["jax"]
        for name in outs["port"][1]:
            assert _tar_members(tmp_path / f"port{len(kw)}" / name) == \
                _tar_members(tmp_path / f"jax{len(kw)}" / name)
    assert outs["port"][0] == 2


# ---------------------------------------------------------------------------
# download_tar and upload_file against a local server
# ---------------------------------------------------------------------------

class _Server:
    """A local HTTP server: GET serves ``body`` (slowly when asked), PUT
    stores the body under its path, after ``fail_puts`` 500s."""

    def __init__(self, body=b"", delay=0.0, fail_puts=0):
        store = self.store = {}
        state = {"fails": fail_puts}

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                import time
                for i in range(0, len(body), 4096):
                    self.wfile.write(body[i:i + 4096])
                    if delay:
                        time.sleep(delay)

            def do_PUT(self):
                n = int(self.headers.get("Content-Length", 0))
                data = self.rfile.read(n)
                if state["fails"] > 0:
                    state["fails"] -= 1
                    self.send_response(500)
                    self.end_headers()
                    return
                store[self.path] = data
                self.send_response(200)
                self.end_headers()

            def log_message(self, *a):
                pass

        self.srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=10)


def test_download_tar_and_timeout(tmp_path):
    body = os.urandom(300_000)
    srv = _Server(body)
    try:
        out = TR2.download_tar(srv.url + "/s.tar", str(tmp_path / "d/s.tar"))
        assert open(out, "rb").read() == body
        assert not os.path.exists(out + ".part")
    finally:
        srv.close()
    slow = _Server(body, delay=0.01)
    try:
        target = str(tmp_path / "slow.tar")
        with pytest.raises(TR2.DownloadTimeout):
            TR2.download_tar(slow.url + "/s.tar", target, chunk_size=4096,
                             max_seconds=0.05)
        assert not os.path.exists(target)
        assert not os.path.exists(target + ".part")
    finally:
        slow.close()


def test_upload_file_retries(tmp_path, monkeypatch):
    monkeypatch.setattr(TR2.time, "sleep", lambda s: None)
    f = tmp_path / "x.tar"
    f.write_bytes(b"payload" * 100)
    srv = _Server(fail_puts=2)
    try:
        TR2.upload_file(srv.url + "/b/k/x.tar?sig=1", str(f), retries=3)
        assert srv.store == {"/b/k/x.tar?sig=1": b"payload" * 100}
    finally:
        srv.close()
    bad = _Server(fail_puts=5)
    try:
        with pytest.raises(RuntimeError, match="after 2 attempts"):
            TR2.upload_file(bad.url + "/y", str(f), retries=2)
    finally:
        bad.close()


def test_generate_shards_cli_uploads(tmp_path, capsys):
    """``python -m yat_tpu_torch.data.generate_shards --config ...``: the
    configured local shards re-sharded by ``r2_upload_shard_size`` and each
    finished shard PUT to ``r2_upload_key/`` through presigned URLs that
    the stand-in endpoint of ``chip_smoke.py`` verifies, then removed
    locally."""
    import yaml

    import chip_smoke
    from yat_tpu_torch.data import generate_shards as TG

    src = make_raw_shard(tmp_path / "src.tar", n=5)
    ak, sk, bucket = chip_smoke.S3_KEYS
    with chip_smoke.StandInS3(str(tmp_path / "s3"), *chip_smoke.S3_KEYS) \
            as s3:
        cfg = tmp_path / "cfg.yaml"
        cfg.write_text(yaml.safe_dump({
            "local_shard_paths": [src], "batch_size": "1",
            "learning_rate": "1e-4", "steps": "1",
            "num_steps_per_validation": "1", "r2_endpoint": s3.url,
            "r2_access_key": ak, "r2_secret_key": sk,
            "r2_bucket_name": bucket, "r2_upload_key": "raw",
            "r2_upload_shard_size": "2"}))
        out = tmp_path / "out"
        TG.main(["--config", str(cfg), "--output-dir", str(out)])
    assert "wrote 5 samples" in capsys.readouterr().out
    assert sorted(n for n, _ in s3.stored) == [
        f"raw/shard-00000{i}.tar" for i in range(3)]
    assert s3.rejected == 0 and os.listdir(out) == []
    keys = [e["__key__"] for i in range(3) for e in TT.iter_tar_samples(
        str(tmp_path / "s3" / "raw" / f"shard-00000{i}.tar"))]
    assert keys == [f"{i:08d}" for i in range(5)]
