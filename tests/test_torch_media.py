"""The port's host data path against the JAX package's: the FFmpeg decoder
(``alpro_tpu_torch/media/binding.py``, built from the port's copy of
``decoder.cpp`` and ``tokenizer.cpp`` into ``alpro_tpu_torch/_build/``),
pandas ``.pkl`` datalists and image files.

The decoder tests hold the port's ``MediaDecoder`` to JAX's on one encoded
video (30 frames of 128 × 96, MJPEG in AVI): the probe equal; sampled,
repeated and resized frames, ``read_video`` with sampling,
time windows and sizes, and ``repack_patches`` equal bit for bit; the
native WordPiece ids equal. JAX's binding loads a library built here from
``alpro_tpu/media``'s sources into a temporary directory, so that nothing is
written into the JAX package. They skip only where ``pkg-config --exists
libavformat`` fails. The ``.pkl`` and image tests hold the rows and items to
JAX's where pandas and Pillow are installed, and check the error that names
each where it is not.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import alpro_tpu.media as jmedia
import alpro_tpu.media.binding as jbinding
from alpro_tpu.data import datasets as jds
from alpro_tpu.data.tokenization import make_test_vocab
from alpro_tpu_torch import media as pmedia
from alpro_tpu_torch.data import datasets as pds
from fixtures import write_image_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HAS_FFMPEG = subprocess.run(["pkg-config", "--exists", "libavformat"]).returncode == 0
ffmpeg = pytest.mark.skipif(not HAS_FFMPEG, reason="pkg-config finds no libavformat")


@pytest.fixture(scope="module")
def decoders(tmp_path_factory):
    """(the port's decoder, JAX's binding on its sources built here, the
    test video)."""
    from alpro_tpu_torch.media.binding import MediaDecoder

    port = MediaDecoder()
    tmp = tmp_path_factory.mktemp("media")
    so = str(tmp / "libalpro_media_jax.so")
    flags = subprocess.run(["pkg-config", "--cflags", "--libs", "libavformat", "libavcodec",
                            "libswscale", "libavutil"], check=True, capture_output=True,
                           text=True).stdout.split()
    src = os.path.join(REPO, "alpro_tpu", "media")
    subprocess.run(["g++", "-O3", "-fPIC", "-std=c++17", "-shared",
                    os.path.join(src, "decoder.cpp"), os.path.join(src, "tokenizer.cpp"),
                    "-o", so, *flags], check=True, capture_output=True)
    built = jbinding._ensure_built
    jbinding._ensure_built = lambda: so
    try:
        jax_dec = jbinding.MediaDecoder()
        jax_backend = jmedia.FFmpegVideoBackend()
    finally:
        jbinding._ensure_built = built
    video = str(tmp / "clip.avi")
    assert port.encode_test_video(video, w=128, h=96, n_frames=30, seed=7)
    return port, jax_dec, jax_backend, video, tmp


@ffmpeg
def test_decoder_matches_jax(decoders):
    """Probe, sampled (unsorted and repeated) and resized frames, and the
    patch repack: equal bit for bit."""
    port, jax_dec, _, video, _ = decoders
    assert dataclasses.astuple(port.probe(video)) == dataclasses.astuple(jax_dec.probe(video))
    assert port.probe(video).num_frames == 30 and port.probe("/nonexistent.mp4") is None
    for idx, size in (([0, 7, 15, 29], (0, 0)), ([17, 3, 3], (0, 0)), ([0, 10, 20], (64, 80))):
        got = port.decode_frames(video, idx, *size)
        np.testing.assert_array_equal(got, jax_dec.decode_frames(video, idx, *size))
        assert got.shape[0] == len(idx)
    frames = port.decode_frames(video, [2, 9], 96, 128)
    got = port.repack_patches(frames, 16)
    np.testing.assert_array_equal(got, jax_dec.repack_patches(frames, 16))
    # the collator's numpy repack: the same layout
    T, H, W, C = frames.shape
    numpy_repack = frames.reshape(T, H // 16, 16, W // 16, 16, C).transpose(0, 1, 3, 2, 4, 5)
    np.testing.assert_array_equal(got, numpy_repack.reshape(T, -1, 16 * 16 * C))


@ffmpeg
def test_read_video_through_the_ffmpeg_backend_matches_jax(decoders):
    """``read_video`` on a container path (no backend given: the port's
    FFmpeg backend) against JAX's FFmpeg backend: uniform, seeded ``rand``
    and ``headtail`` sampling, a time window at the container's and at a
    forced rate, a resize: equal bit for bit; too many frames for
    ``uniform``: None from both."""
    _, _, jax_backend, video, _ = decoders
    cases = [dict(num_frm=8), dict(num_frm=8, sampling="rand"),
             dict(num_frm=4, sampling="headtail"), dict(num_frm=4, start_time=0.5, end_time=2.0),
             dict(num_frm=4, start_time=0.2, end_time=0.9, fps=10),
             dict(num_frm=6, height=48, width=64)]
    assert pmedia.read_video(video, 40) is jmedia.read_video(video, 40, backend=jax_backend) \
        is None
    for kw in cases:
        got = pmedia.read_video(video, rng=np.random.default_rng(3), **kw)
        want = jmedia.read_video(video, rng=np.random.default_rng(3), backend=jax_backend, **kw)
        assert got is not None and got.dtype == np.uint8, kw
        np.testing.assert_array_equal(got, want, err_msg=str(kw))
    assert isinstance(pmedia.get_video_backend("auto"), pmedia.FFmpegVideoBackend)
    assert isinstance(pmedia.get_video_backend("npy"), pmedia.NpyVideoBackend)
    with pytest.raises(ValueError, match="unknown video backend"):
        pmedia.get_video_backend("decord")


@ffmpeg
def test_native_wordpiece_matches_jax(decoders):
    port, jax_dec, _, _, tmp = decoders
    vocab = str(tmp / "vocab.txt")
    with open(vocab, "w") as f:
        f.writelines(t + "\n" for t in make_test_vocab())
    texts = ["a dog catches a frisbee", "The CAT jumps!", "", "unknownword here, ok?"]
    got = port.make_tokenizer(vocab)(texts, max_length=8)
    want = jax_dec.make_tokenizer(vocab)(texts, max_length=8)
    for k in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["attention_mask"].sum() > len(texts)


@ffmpeg
def test_retrieval_dataset_decodes_containers_like_jax(decoders):
    """The training dataset over ``.avi`` clips (found by ``_find_video``,
    read through the FFmpeg backend), seeded: items equal to JAX's."""
    port, _, jax_backend, _, tmp = decoders
    vid_dir = tmp / "videos"
    vid_dir.mkdir()
    rows = []
    for i in range(3):
        assert port.encode_test_video(str(vid_dir / f"v{i}.avi"), 64, 48, 12, seed=i)
        rows.append({"vid_id": f"v{i}", "txt": ["a dog runs", "a cat"], "txt_id": i})
    kw = dict(num_frm=4, resize_size=40, crop_size=32, seed=5)
    got = pds.RetrievalDataset(rows, str(vid_dir), **kw)
    want = jds.RetrievalDataset(rows, str(vid_dir), backend=jax_backend, **kw)
    for i in (0, 2, 1):
        a, b = got[i], want[i]
        assert a["clip"].shape == (4, 32, 32, 3)
        np.testing.assert_array_equal(a["clip"], b["clip"])
        assert a["caption"] == b["caption"]


def test_pkl_datalist_matches_jax(tmp_path):
    pd = pytest.importorskip("pandas")
    rows = [{"videoid": 1033, "name": "a dog runs", "page_dir": "000"},
            {"videoid": 2071, "name": "the cat jumps", "page_dir": "001"}]
    path = str(tmp_path / "train.pkl")
    pd.DataFrame(rows).to_pickle(path)
    got = pds.load_datalist(path)
    assert got == jds.load_datalist(path)
    assert [r["vid_id"] for r in got] == ["1033", "2071"] and got[1]["txt"] == "the cat jumps"


def test_image_files_match_jax(tmp_path):
    """PNG and JPEG images (and a ``.npy``) through ``PretrainImageDataset``,
    training and eval: items equal to JAX's; a corrupt JPEG is replaced by
    another row, and a dataset of it alone fails as JAX's does."""
    image = pytest.importorskip("PIL.Image")
    ann, img_dir, rows = write_image_dataset(str(tmp_path), n=3, h=40, w=52)
    for i, ext in ((0, "png"), (1, "jpg")):
        arr = np.load(os.path.join(img_dir, f"img{i:03d}.npy"))
        image.fromarray(arr).save(os.path.join(img_dir, f"pic{i}.{ext}"))
        rows.append({"vid_id": f"pic{i}.{ext}", "txt": f"picture {i}"})
    with open(os.path.join(img_dir, "bad.jpg"), "wb") as f:
        f.write(b"\xff\xd8")
    rows.append({"vid_id": "bad.jpg", "txt": "broken"})
    for is_train in (True, False):
        kw = dict(num_frm=2, resize_size=40, crop_size=32, seed=4, is_train=is_train)
        got, want = pds.PretrainImageDataset(rows, img_dir, **kw), \
            jds.PretrainImageDataset(rows, img_dir, **kw)
        for i in (3, 4, 5, 0, 4):
            a, b = got[i], want[i]
            np.testing.assert_array_equal(a["clip"], b["clip"])
            assert a["caption"] == b["caption"] and a["clip"].shape == (2, 32, 32, 3)
    assert pds.PretrainImageDataset._load(os.path.join(img_dir, "pic0.png")).shape == (40, 52, 3)
    for pkg in (pds, jds):
        with pytest.raises(RuntimeError, match="failed to load any image"):
            pkg.PretrainImageDataset([rows[-1]], img_dir)[0]


def test_missing_packages_raise_naming_them(tmp_path, monkeypatch):
    """Without pandas a ``.pkl`` datalist, and without Pillow an image file,
    raise an ImportError that names the package: no resampling."""
    (tmp_path / "train.pkl").write_bytes(b"")
    (tmp_path / "x.png").write_bytes(b"")
    monkeypatch.setitem(sys.modules, "pandas", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError, match="needs pandas"):
        pds.load_datalist(str(tmp_path / "train.pkl"))
    ds = pds.PretrainImageDataset([{"vid_id": "x.png", "txt": "x"}], str(tmp_path))
    with pytest.raises(ImportError, match="needs Pillow"):
        ds[0]
