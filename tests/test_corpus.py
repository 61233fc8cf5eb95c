"""The in-repo corpus: committed streams match their manifest, and the
run-time generators are deterministic in their seed."""
import hashlib

import numpy as np
import pytest

from corpus import make_corpus as mc

MANIFEST = mc.manifest()


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_committed_stream_matches_manifest(name):
    entry = MANIFEST[name]
    data = (mc.CORPUS_DIR / name).read_bytes()
    assert hashlib.sha256(data).hexdigest() == entry["sha256"]
    assert len(data) == entry["bytes"]
    info = mc.parse_info(name, data)
    assert info["rate"] == entry["rate"] == mc.COMMITTED[name][1]
    assert info["channels"] == entry["channels"] == mc.COMMITTED[name][2]
    assert info["duration"] == pytest.approx(entry["duration"], abs=1e-9)
    assert abs(info["duration"] - mc.COMMITTED[name][3]) < 0.1


def test_committed_corpus_stays_small():
    assert sum(e["bytes"] for e in MANIFEST.values()) < 2_000_000


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_clip_cuts_at_frame_boundaries(name):
    data = mc.load(name)
    short = mc.clip(name, data, 1.0)
    assert data.startswith(short)
    assert 0.9 <= mc.parse_info(name, short)["duration"] <= 1.2


@pytest.mark.parametrize("kind", sorted(mc.GENERATED))
def test_generated_streams_are_seeded(kind):
    a, pcm = mc.generate(kind, 7, 0.5)
    b, _ = mc.generate(kind, 7, 0.5)
    c, _ = mc.generate(kind, 8, 0.5)
    rate, channels = mc.GENERATED[kind]
    assert a == b and a != c
    assert pcm.dtype == np.int16
    assert pcm.shape == (int(0.5 * rate), channels)
