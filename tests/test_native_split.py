"""The host library builds with g++ alone and links no libav; batched
models raise when it cannot load; the compile-cache helper."""
import subprocess

import pytest

from soundkit_tpu.native import loader


def test_host_library_links_no_libav():
    loader.load()
    out = subprocess.run(["ldd", str(loader.LIB_PATH)], capture_output=True,
                         text=True, check=True).stdout
    assert "libavcodec" not in out and "libavutil" not in out
    for src in loader._sources(av=False):
        if src.suffix == ".cpp":
            assert "<libav" not in src.read_text(), src.name


def _fail(*args, **kwargs):
    raise loader.NativeBuildError("forced failure")


def test_batched_aac_raises_when_native_fails(monkeypatch):
    from soundkit_tpu.models.aac_lc_batch import BatchedAacLcDecoder

    monkeypatch.setattr(loader, "load", _fail)
    with pytest.raises(loader.NativeBuildError):
        BatchedAacLcDecoder(2, 2)
    assert BatchedAacLcDecoder(2, 2, use_native=False).wire_counts["v4"] == 0


def test_batched_flac_encoder_raises_when_native_fails(monkeypatch):
    from soundkit_tpu.models.flac_encode_batch import BatchedFlacEncoder

    monkeypatch.setattr(loader, "load", _fail)
    with pytest.raises(loader.NativeBuildError):
        BatchedFlacEncoder(2, 48000, 2)
    BatchedFlacEncoder(2, 48000, 2, use_native=False)


def test_compile_cache_respects_environment(monkeypatch):
    import jax

    from soundkit_tpu.utils import backend

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/else")
    try:
        assert backend.enable_compile_cache() == "/somewhere/else"
        assert jax.config.jax_compilation_cache_dir == before
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        path = backend.enable_compile_cache()
        assert path == str(backend.COMPILE_CACHE_DIR)
        assert backend.COMPILE_CACHE_DIR.name == ".jax_cache"
        assert backend.COMPILE_CACHE_DIR.parent == loader.NATIVE_DIR.parents[1]
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
