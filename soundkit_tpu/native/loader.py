"""ctypes loaders for the native host libraries.

``load()`` returns ``libsoundkit_host.so``: every owned parser and
packer (FLAC, MP3/AAC/Vorbis/Opus walks, GSM, ALAC), built with g++
alone.  ``load_av()`` returns ``libsoundkit_av.so``: the libavcodec
shims behind the oracle decoders (``codecs/avdec.py``) and the avcodec
encoders (``codecs/encoders.AvEncoder``).  Only those users call it;
the batched serving path never needs libav.

Both build lazily with ``make`` on first use when missing or stale
(any of their sources or the Makefile newer than the .so).  A file
lock serialises the build across processes.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import os
import subprocess
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent
LIB_PATH = NATIVE_DIR / "libsoundkit_host.so"
AV_LIB_PATH = NATIVE_DIR / "libsoundkit_av.so"
AV_SOURCES = ("avshim.cpp", "avshim_enc.cpp")
# PGO training loads the -fprofile-generate instrumented build
# directly (tools/pgo_train_walks.py); no rebuild recursion
_OVERRIDE = os.environ.get("SKT_LIB_OVERRIDE")
if _OVERRIDE:
    LIB_PATH = Path(_OVERRIDE)


class NativeBuildError(RuntimeError):
    pass


class AvUnavailable(NativeBuildError):
    """libsoundkit_av.so cannot be built or loaded: libavcodec and
    libavutil (with their headers) are missing on this machine."""


def _sources(av: bool):
    return [
        src for src in (NATIVE_DIR / "src").glob("*.cpp")
        if (src.name in AV_SOURCES) == av
    ] + [NATIVE_DIR / "Makefile"]


def _needs_build(path: Path, av: bool) -> bool:
    if not path.exists():
        return True
    lib_mtime = path.stat().st_mtime
    return any(src.stat().st_mtime > lib_mtime for src in _sources(av))


def _build(path: Path, av: bool) -> None:
    with open(NATIVE_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _needs_build(path, av):
            return  # another process built it while we waited
        proc = subprocess.run(
            ["make", "-C", str(NATIVE_DIR), path.name],
            capture_output=True, text=True,
        )
    if proc.returncode != 0:
        err = AvUnavailable if av else NativeBuildError
        raise err(f"native build of {path.name} failed:\n"
                  f"{proc.stdout}\n{proc.stderr}")


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    if not _OVERRIDE and _needs_build(LIB_PATH, av=False):
        _build(LIB_PATH, av=False)
    lib = ctypes.CDLL(str(LIB_PATH))

    lib.skt_flac_new.restype = ctypes.c_void_p
    lib.skt_flac_free.argtypes = [ctypes.c_void_p]
    lib.skt_flac_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long]
    lib.skt_flac_push.restype = ctypes.c_int
    lib.skt_flac_info.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_longlong),
    ]
    lib.skt_flac_info.restype = ctypes.c_int
    lib.skt_flac_md5.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.skt_flac_pull.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_long,
    ]
    lib.skt_flac_pull.restype = ctypes.c_long
    lib.skt_flac_error.argtypes = [ctypes.c_void_p]
    lib.skt_flac_error.restype = ctypes.c_char_p
    lib.skt_flac_max_block.argtypes = [ctypes.c_void_p]
    lib.skt_flac_max_block.restype = ctypes.c_long
    lib.skt_flac_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long]
    lib.skt_flac_feed.restype = ctypes.c_int
    i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
    lib.skt_flac_next_parts.argtypes = [ctypes.c_void_p, i32p, i32p, i32p, ctypes.c_long]
    lib.skt_flac_next_parts.restype = ctypes.c_int
    u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
    lib.skt_flac_next_segs.argtypes = [
        ctypes.c_void_p, i32p, i32p, i32p, i32p, i32p, u8p,
        ctypes.c_long, ctypes.c_long, ctypes.c_long,
    ]
    lib.skt_flac_next_segs.restype = ctypes.c_int
    lib.skt_flac_export_parts_last.argtypes = [
        ctypes.c_void_p, i32p, i32p, i32p, ctypes.c_long,
    ]
    lib.skt_flac_export_parts_last.restype = ctypes.c_int
    # round-5 batched serving path: drain at push / export per collect
    lib.skt_flac_drain.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
    ]
    lib.skt_flac_drain.restype = ctypes.c_long
    lib.skt_flac_queued.argtypes = [ctypes.c_void_p]
    lib.skt_flac_queued.restype = ctypes.c_long
    lib.skt_flac_reset_queue.argtypes = [ctypes.c_void_p]
    lib.skt_flac_reset_queue.restype = None
    i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")
    lib.skt_flac_queue_stats.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_long, i64p,
    ]
    lib.skt_flac_queue_stats.restype = None
    lib.skt_flac_export_rounds.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_long,
        ctypes.c_long, ctypes.c_long, u32p,
        i32p, i32p, i32p, i32p, i32p,          # seg_*
        i32p, i32p, i32p, i32p, i32p, i32p, i32p,  # warm..wasted
        i32p, i32p, u8p, i32p,                 # assign, bs, valid, meta
        i32p, i32p, i32p, i32p,                # parts_*
    ]
    lib.skt_flac_export_rounds.restype = ctypes.c_long

    _bind_flac_pack(lib)
    _bind_aac(lib)
    _bind_aac_batch(lib)
    _bind_aac_compact(lib)
    _bind_aac_compact_ptrs(lib)
    _bind_aac_v3(lib)
    _bind_mp3(lib)
    _bind_gsm(lib)
    _bind_alac(lib)
    return lib


@functools.lru_cache(maxsize=1)
def load_av() -> ctypes.CDLL:
    """The libavcodec shim library; raises :class:`AvUnavailable`
    where libav is missing."""
    if _needs_build(AV_LIB_PATH, av=True):
        _build(AV_LIB_PATH, av=True)
    try:
        lib = ctypes.CDLL(str(AV_LIB_PATH))
    except OSError as e:
        raise AvUnavailable(f"cannot load {AV_LIB_PATH.name}: {e}") from e
    lib.skt_av_open.restype = ctypes.c_void_p
    lib.skt_av_open.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.skt_av_close.argtypes = [ctypes.c_void_p]
    lib.skt_av_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long]
    lib.skt_av_push.restype = ctypes.c_int
    lib.skt_av_pull_f32.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_long,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.skt_av_pull_f32.restype = ctypes.c_long
    lib.skt_av_err.argtypes = [ctypes.c_void_p]
    lib.skt_av_err.restype = ctypes.c_char_p
    _bind_encoders(lib)
    return lib


def _bind_alac(lib: ctypes.CDLL) -> None:
    from numpy.ctypeslib import ndpointer

    lib.skt_alac_new.restype = ctypes.c_void_p
    lib.skt_alac_new.argtypes = [ctypes.c_char_p, ctypes.c_long]
    lib.skt_alac_free.argtypes = [ctypes.c_void_p]
    for name in ("skt_alac_channels", "skt_alac_sample_size"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p]
    for name in ("skt_alac_sample_rate", "skt_alac_frame_length"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_long
        fn.argtypes = [ctypes.c_void_p]
    lib.skt_alac_error.restype = ctypes.c_char_p
    lib.skt_alac_error.argtypes = [ctypes.c_void_p]
    lib.skt_alac_decode.restype = ctypes.c_long
    lib.skt_alac_decode.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_long,
        ndpointer(np.int32, flags="C_CONTIGUOUS"),
    ]


def _bind_gsm(lib: ctypes.CDLL) -> None:
    from numpy.ctypeslib import ndpointer

    lib.skt_gsm_new.restype = ctypes.c_void_p
    lib.skt_gsm_new.argtypes = [ctypes.c_int]
    lib.skt_gsm_free.argtypes = [ctypes.c_void_p]
    lib.skt_gsm_decode.restype = ctypes.c_long
    lib.skt_gsm_decode.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_long,
        ndpointer(np.int16, flags="C_CONTIGUOUS"),
    ]
    lib.skt_gsm_reset.argtypes = [ctypes.c_void_p]


def _bind_flac_pack(lib: ctypes.CDLL) -> None:
    from numpy.ctypeslib import ndpointer

    i32 = ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64 = ndpointer(np.int64, flags="C_CONTIGUOUS")
    u8 = ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.skt_flac_pack_frames.restype = ctypes.c_long
    lib.skt_flac_pack_frames.argtypes = [
        ctypes.c_long, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, i64, i32, i32, i32, i32, i32,
        ctypes.c_int, ctypes.c_void_p, i32, u8, ctypes.c_long, i64,
    ]
    i16 = ndpointer(np.int16, flags="C_CONTIGUOUS")
    lib.skt_flac_pack_frames16.restype = ctypes.c_long
    lib.skt_flac_pack_frames16.argtypes = [
        ctypes.c_long, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, i64, i32, i32, i32, i32, i32,
        ctypes.c_int, ctypes.c_void_p, i16, u8, ctypes.c_long, i64,
    ]
    lib.skt_flac_pack_frame1.restype = ctypes.c_long
    lib.skt_flac_pack_frame1.argtypes = [
        ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, i32, i32, i32,
        i32, i64, i64, i32, u8, ctypes.c_long,
    ]


def _bind_encoders(lib: ctypes.CDLL) -> None:
    lib.skt_av_enc_open.restype = ctypes.c_void_p
    lib.skt_av_enc_open.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_long,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.skt_av_enc_close.argtypes = [ctypes.c_void_p]
    lib.skt_av_enc_push.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_long,
    ]
    lib.skt_av_enc_push.restype = ctypes.c_int
    lib.skt_av_enc_pull.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long]
    lib.skt_av_enc_pull.restype = ctypes.c_long
    lib.skt_av_enc_extradata.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long]
    lib.skt_av_enc_extradata.restype = ctypes.c_long
    lib.skt_av_enc_frame_size.argtypes = [ctypes.c_void_p]
    lib.skt_av_enc_frame_size.restype = ctypes.c_int


def _bind_aac(lib: ctypes.CDLL) -> None:
    import numpy as np
    from numpy.ctypeslib import ndpointer

    lib.skt_aac_new.restype = ctypes.c_void_p
    lib.skt_aac_new.argtypes = [ctypes.c_int]
    lib.skt_aac_free.argtypes = [ctypes.c_void_p]
    lib.skt_aac_parse_au.restype = ctypes.c_int
    lib.skt_aac_parse_au.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_long,
        ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ndpointer(np.float32, flags="C_CONTIGUOUS"),
    ]
    lib.skt_aac_error.argtypes = [ctypes.c_void_p]
    lib.skt_aac_error.restype = ctypes.c_char_p


def _bind_aac_batch(lib: ctypes.CDLL) -> None:
    import numpy as np
    from numpy.ctypeslib import ndpointer

    lib.skt_aac_parse_batch.restype = ctypes.c_int
    lib.skt_aac_parse_batch.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int,
        ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ndpointer(np.float32, flags="C_CONTIGUOUS"),
    ]


def _bind_aac_compact(lib: ctypes.CDLL) -> None:
    import numpy as np
    from numpy.ctypeslib import ndpointer

    lib.skt_aac_parse_batch_compact.restype = ctypes.c_int
    lib.skt_aac_parse_batch_compact.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int,
        ndpointer(np.int16, flags="C_CONTIGUOUS"),
        ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ndpointer(np.int8, flags="C_CONTIGUOUS"),
        ndpointer(np.int8, flags="C_CONTIGUOUS"),
        ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ndpointer(np.int16, flags="C_CONTIGUOUS"),
        ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ndpointer(np.int32, flags="C_CONTIGUOUS"),
    ]


def _bind_aac_compact_ptrs(lib: ctypes.CDLL) -> None:
    import numpy as np
    from numpy.ctypeslib import ndpointer

    lib.skt_aac_parse_batch_compact_ptrs.restype = ctypes.c_int
    lib.skt_aac_parse_batch_compact_ptrs.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_char_p),
        ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int,
        ctypes.c_int,
        ndpointer(np.int16, flags="C_CONTIGUOUS"),
        ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ndpointer(np.int8, flags="C_CONTIGUOUS"),
        ndpointer(np.int8, flags="C_CONTIGUOUS"),
        ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ndpointer(np.int16, flags="C_CONTIGUOUS"),
        ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ndpointer(np.int32, flags="C_CONTIGUOUS"),
    ]


def _bind_aac_v3(lib: ctypes.CDLL) -> None:
    import numpy as np
    from numpy.ctypeslib import ndpointer

    wire_outs = [
        ndpointer(np.uint16, flags="C_CONTIGUOUS"),  # esc_idx
        ndpointer(np.int16, flags="C_CONTIGUOUS"),   # esc_val
        ndpointer(np.int16, flags="C_CONTIGUOUS"),   # regions
        ndpointer(np.int8, flags="C_CONTIGUOUS"),    # quant
        ndpointer(np.uint8, flags="C_CONTIGUOUS"),   # sf_len
        ndpointer(np.uint8, flags="C_CONTIGUOUS"),   # sf_val
        ndpointer(np.uint8, flags="C_CONTIGUOUS"),   # msis_len
        ndpointer(np.uint8, flags="C_CONTIGUOUS"),   # msis_ms
        ndpointer(np.int8, flags="C_CONTIGUOUS"),    # msis_pos
        ndpointer(np.int8, flags="C_CONTIGUOUS"),    # msis_sign
        ndpointer(np.int8, flags="C_CONTIGUOUS"),    # refl
        ndpointer(np.uint8, flags="C_CONTIGUOUS"),   # crb
        ndpointer(np.uint8, flags="C_CONTIGUOUS"),   # order
        ndpointer(np.uint8, flags="C_CONTIGUOUS"),   # seq
        ndpointer(np.uint8, flags="C_CONTIGUOUS"),   # shape
        ndpointer(np.uint8, flags="C_CONTIGUOUS"),   # chan_valid
        ndpointer(np.int32, flags="C_CONTIGUOUS"),   # overflow
    ]
    lib.skt_aac_parse_batch_v3_ptrs.restype = ctypes.c_int
    lib.skt_aac_parse_batch_v3_ptrs.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_char_p),
        ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int,
        ctypes.c_int,
    ] + wire_outs
    lib.skt_aac_parse_batch_v3.restype = ctypes.c_int
    lib.skt_aac_parse_batch_v3.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int,
    ] + wire_outs

    lib.skt_aac_parse_batch_v4_ptrs.restype = ctypes.c_int
    lib.skt_aac_parse_batch_v4_ptrs.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_char_p),
        ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int,
        ctypes.c_int,
        ndpointer(np.int16, flags="C_CONTIGUOUS"),   # regions
        ndpointer(np.uint8, flags="C_CONTIGUOUS"),   # sf_len
        ndpointer(np.uint8, flags="C_CONTIGUOUS"),   # sf_val
        ndpointer(np.uint8, flags="C_CONTIGUOUS"),   # msis_len
        ndpointer(np.uint8, flags="C_CONTIGUOUS"),   # msis_ms
        ndpointer(np.int8, flags="C_CONTIGUOUS"),    # msis_pos
        ndpointer(np.int8, flags="C_CONTIGUOUS"),    # msis_sign
        ndpointer(np.int8, flags="C_CONTIGUOUS"),    # refl
        ndpointer(np.uint8, flags="C_CONTIGUOUS"),   # crb
        ndpointer(np.uint8, flags="C_CONTIGUOUS"),   # order
        ndpointer(np.uint32, flags="C_CONTIGUOUS"),  # runs
        ndpointer(np.uint8, flags="C_CONTIGUOUS"),   # n_runs
        ndpointer(np.uint16, flags="C_CONTIGUOUS"),  # spec_bit
        ndpointer(np.uint8, flags="C_CONTIGUOUS"),   # pns (u32 view)
        ndpointer(np.uint8, flags="C_CONTIGUOUS"),   # seq
        ndpointer(np.uint8, flags="C_CONTIGUOUS"),   # shape
        ndpointer(np.uint8, flags="C_CONTIGUOUS"),   # chan_valid
        ndpointer(np.uint8, flags="C_CONTIGUOUS"),   # au bytes
        ndpointer(np.int32, flags="C_CONTIGUOUS"),   # max_cw
        ndpointer(np.int32, flags="C_CONTIGUOUS"),   # overflow
    ]


def _bind_mp3(lib: ctypes.CDLL) -> None:
    import numpy as np
    from numpy.ctypeslib import ndpointer

    lib.skt_mp3_new.restype = ctypes.c_void_p
    lib.skt_mp3_free.argtypes = [ctypes.c_void_p]
    lib.skt_mp3_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long]
    lib.skt_mp3_push.restype = ctypes.c_long
    lib.skt_mp3_pop.restype = ctypes.c_int
    lib.skt_mp3_pop.argtypes = [
        ctypes.c_void_p,
        ndpointer(np.int16, flags="C_CONTIGUOUS"),
        ndpointer(np.int16, flags="C_CONTIGUOUS"),
        ndpointer(np.int32, flags="C_CONTIGUOUS"),
    ]
    lib.skt_mp3_pop_batch.restype = ctypes.c_int
    lib.skt_mp3_pop_batch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_int,
        ndpointer(np.int16, flags="C_CONTIGUOUS"),
        ndpointer(np.int16, flags="C_CONTIGUOUS"),
        ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ndpointer(np.int32, flags="C_CONTIGUOUS"),
    ]
    lib.skt_mp3_pop_rounds.restype = None
    lib.skt_mp3_pop_rounds.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_int, ctypes.c_int,
        ndpointer(np.uint8, flags="C_CONTIGUOUS"),  # wire [G, stride]
        ctypes.c_long,  # stride
        ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.c_long, ctypes.c_long, ctypes.c_long,  # field offsets
        ndpointer(np.int32, flags="C_CONTIGUOUS"),  # rate [B]
        ndpointer(np.int32, flags="C_CONTIGUOUS"),  # popped [B]
    ]
