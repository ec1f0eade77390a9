"""ctypes binding for libalpro_media.so: the FFmpeg decoder
(``decoder.cpp``) and the WordPiece tokenizer (``tokenizer.cpp``), the JAX
package's ``alpro_tpu/media`` sources copied here, less the reusable
decoder handle (``open_video`` and its C entry points), which nothing in
the port calls, and but for their comments.

Nothing is built at import. The first ``MediaDecoder()`` runs this
directory's ``Makefile`` (``g++`` with FFmpeg's flags from ``pkg-config``)
into ``alpro_tpu_torch/_build/media_<hash>/``, keyed by a hash of the
sources, under a temporary name renamed into place, so concurrent processes
never load a half-written file. A failed build raises ``RuntimeError`` with
the compiler's output; nothing takes the decoder's place.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCES = ("decoder.cpp", "tokenizer.cpp", "Makefile")
_BUILD_ROOT = os.path.join(os.path.dirname(_DIR), "_build")
_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def _ensure_built() -> str:
    """The library's path, built first when this version of the sources
    has none."""
    digest = hashlib.sha256()
    for name in _SOURCES:
        with open(os.path.join(_DIR, name), "rb") as f:
            digest.update(f.read())
    so = os.path.join(_BUILD_ROOT, f"media_{digest.hexdigest()[:16]}", "libalpro_media.so")
    with _LOCK:
        if os.path.exists(so):
            return so
        os.makedirs(os.path.dirname(so), exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        try:
            subprocess.run(["make", "-C", _DIR, f"OUT={tmp}"], check=True,
                           capture_output=True, text=True)
        except (OSError, subprocess.CalledProcessError) as e:
            out = f"{e.stdout}\n{e.stderr}" if isinstance(e, subprocess.CalledProcessError) else e
            raise RuntimeError(f"failed to build libalpro_media.so:\n{out}") from e
        os.replace(tmp, so)
    return so


@dataclasses.dataclass
class VideoInfo:
    num_frames: int
    width: int
    height: int
    fps: float


class MediaDecoder:
    def __init__(self):
        self._lib = ctypes.CDLL(_ensure_built())
        self._lib.alpro_probe.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_double),
        ]
        self._lib.alpro_probe.restype = ctypes.c_int
        self._lib.alpro_decode_frames.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        self._lib.alpro_decode_frames.restype = ctypes.c_int
        self._lib.alpro_encode_test_video.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int64,
        ]
        self._lib.alpro_encode_test_video.restype = ctypes.c_int
        self._lib.alpro_repack_patches.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        self._lib.alpro_repack_patches.restype = ctypes.c_int
        self._lib.alpro_tok_create.argtypes = [ctypes.c_char_p, ctypes.c_int]
        self._lib.alpro_tok_create.restype = ctypes.c_void_p
        self._lib.alpro_tok_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
        ]
        self._lib.alpro_tok_encode.restype = ctypes.c_int
        self._lib.alpro_tok_destroy.argtypes = [ctypes.c_void_p]
        self._lib.alpro_tok_destroy.restype = None

    def probe(self, path: str) -> Optional[VideoInfo]:
        nf = ctypes.c_int64()
        w = ctypes.c_int()
        h = ctypes.c_int()
        fps = ctypes.c_double()
        rc = self._lib.alpro_probe(
            path.encode(), ctypes.byref(nf), ctypes.byref(w), ctypes.byref(h),
            ctypes.byref(fps),
        )
        if rc != 0:
            return None
        return VideoInfo(nf.value, w.value, h.value, fps.value)

    def decode_frames(
        self,
        path: str,
        indices: Sequence[int],
        out_h: int = 0,
        out_w: int = 0,
        native_size: Optional[tuple] = None,
    ) -> Optional[np.ndarray]:
        """Decode the given frame indices → (n, out_h, out_w, 3) uint8 RGB.
        out_h/out_w of 0 keep the native size; callers that already probed
        pass `native_size=(h, w)` to avoid a second container parse."""
        if not (out_h and out_w):
            if native_size is None:
                info = self.probe(path)
                if info is None:
                    return None
                native_size = (info.height, info.width)
            out_h = out_h or native_size[0]
            out_w = out_w or native_size[1]
        oh, ow = out_h, out_w
        idx = np.ascontiguousarray(np.asarray(indices, dtype=np.int64))
        out = np.empty((len(idx), oh, ow, 3), dtype=np.uint8)
        rc = self._lib.alpro_decode_frames(
            path.encode(),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idx), ow, oh,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        if rc != 0:
            return None
        return out

    def encode_test_video(self, path: str, w=128, h=96, n_frames=30, seed=0,
                          start_pts: int = 0) -> bool:
        """start_pts != 0 (in 1/25s units) writes a stream whose first
        timestamp is offset — the nonzero-start-container decode case
        (container inferred from the extension; use .ts for MPEG-TS)."""
        return self._lib.alpro_encode_test_video(
            path.encode(), w, h, n_frames, seed, start_pts
        ) == 0

    def make_tokenizer(self, vocab_path: str, lowercase: bool = True) -> "NativeWordPiece":
        return NativeWordPiece(self._lib, vocab_path, lowercase)

    def repack_patches(self, frames: np.ndarray, patch_size: int = 16) -> np.ndarray:
        """(T, H, W, C) uint8 → (T, N, p·p·C) uint8 patch-major layout
        (the form the patch embedding's matmul consumes)."""
        frames = np.ascontiguousarray(frames, dtype=np.uint8)
        T, H, W, C = frames.shape
        p = patch_size
        out = np.empty((T, (H // p) * (W // p), p * p * C), dtype=np.uint8)
        rc = self._lib.alpro_repack_patches(
            frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            T, H, W, C, p,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        if rc != 0:
            raise ValueError(f"repack failed (rc={rc}): H/W not divisible by {p}")
        return out


class NativeWordPiece:
    """C++ WordPiece tokenizer exposing the collator-facing surface
    (same contract as data/tokenization.py::WordPieceTokenizer)."""

    def __init__(self, lib, vocab_path: str, lowercase: bool = True):
        self._lib = lib
        self._h = lib.alpro_tok_create(vocab_path.encode(), int(lowercase))
        if not self._h:
            raise ValueError(f"failed to load vocab from {vocab_path}")
        # mirror the special ids by reading the vocab file
        self.vocab = {}
        with open(vocab_path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                self.vocab[line.rstrip("\r\n")] = i  # match the C loader (CRLF-safe)
        self.pad_token_id = self.vocab["[PAD]"]
        self.unk_token_id = self.vocab["[UNK]"]
        self.cls_token_id = self.vocab["[CLS]"]
        self.sep_token_id = self.vocab["[SEP]"]
        self.mask_token_id = self.vocab["[MASK]"]
        self._special = {
            self.pad_token_id, self.unk_token_id, self.cls_token_id,
            self.sep_token_id, self.mask_token_id,
        }

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def __call__(self, texts, max_length: int = 40, padding: str = "max_length"):
        ids = np.full((len(texts), max_length), self.pad_token_id, np.int32)
        mask = np.zeros((len(texts), max_length), np.int32)
        for i, t in enumerate(texts):
            n = self._lib.alpro_tok_encode(
                self._h, t.encode(), max_length,
                ids[i].ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
            mask[i, :n] = 1
        return {"input_ids": ids, "attention_mask": mask}

    def get_special_tokens_mask(self, ids, already_has_special_tokens=True):
        return [1 if int(i) in self._special else 0 for i in ids]

    def __del__(self):
        try:
            self._lib.alpro_tok_destroy(self._h)
        except Exception:
            pass


_DECODER_SINGLETON = None


def get_decoder() -> "MediaDecoder":
    """Process-wide cached MediaDecoder: dlopen + ctypes prototype setup once,
    not per batch (the decoder object is stateless; each call opens its own
    demux context, so sharing across threads is safe)."""
    global _DECODER_SINGLETON
    if _DECODER_SINGLETON is None:
        _DECODER_SINGLETON = MediaDecoder()
    return _DECODER_SINGLETON
