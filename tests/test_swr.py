"""The table-driven SILK resampler (utils/swr.py) against the
libswresample stream it was probed from: same output counts per call,
the same samples to float32 rounding, through a flush."""
import ctypes

import numpy as np
import pytest

from soundkit_tpu.utils.swr import SilkResampler


@pytest.fixture(scope="module")
def oracle():
    try:
        ctypes.CDLL("libswresample.so.4")
    except OSError:
        pytest.skip("libswresample is not installed")
    from soundkit_tpu.native.tools.gen_silk_resampler import SwrResampler

    return SwrResampler


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("bw", [0, 1, 2])
def test_table_resampler_matches_libswresample(oracle, bw, channels):
    rate = (8000, 12000, 16000)[bw]
    flen = rate // 50
    ours = SilkResampler(rate, bw, channels)
    ref = oracle(rate, bw, channels)
    rng = np.random.default_rng(bw * 2 + channels)
    for f in range(40):
        frames = 1 + f % 3  # 20/40/60 ms superframes
        x = rng.standard_normal((flen * frames, channels)) * 0.3
        a = ours.process(x, 960 * frames)
        b = ref.process(x, 960 * frames)
        assert a.shape == b.shape, f"frame {f}"
        np.testing.assert_allclose(a, b, atol=5e-7)
    a, b = ours.drain(500), ref.drain(500)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=5e-7)
