"""chip_smoke.py's phases at B=4 on the CPU device (the script's
main() alone demands a GPU), and the idle-lane rule they exposed."""
import json

import numpy as np
import pytest

import chip_smoke as cs


@pytest.fixture(scope="module")
def meter():
    return cs.CompileMeter()


def test_aac_phase_small(meter):
    rec = cs.phase_aac(meter, lanes=4, seconds=1.5)
    assert rec["wire"]["v4"] > 0 and rec["wire"]["v3"] == 0
    assert rec["min_snr_db"] >= 90.0 and rec["checked_lanes"] == 4


@pytest.mark.parametrize("groups", [
    ("aac", "mp3", "vorbis"),
    ("flac", "opus"),
    cs.TELEPHONY,
])
def test_fleet_groups_phase_small(meter, groups):
    rec = cs.phase_groups(meter, lanes=4, seconds=1.5, groups=groups)
    assert set(rec["groups"]) == set(groups)


def test_flac_encode_phase_small(meter):
    rec = cs.phase_flac_encode(meter, lanes=4, seconds=1.0)
    assert rec["lanes"] == 4 and rec["bytes_out"] > 0


def test_main_refuses_without_gpu(capsys):
    assert cs.main() == 2
    out = capsys.readouterr()
    assert out.out == "" and "needs a GPU" in out.err
    with pytest.raises(json.JSONDecodeError):
        json.loads(out.out or "-")


@pytest.mark.parametrize("use_native", [True, False])
def test_idle_aac_lane_keeps_window_state(use_native):
    """A lane that idles for a few batches (its queue ran dry while
    others decoded) resumes exactly where it stopped: overlap and
    window shape both stay frozen."""
    from corpus import make_corpus as mc
    from soundkit_tpu.models.aac_lc_batch import BatchedAacLcDecoder

    streams, n = cs.rotated_aac(2, 1.5)
    frames = mc.adts_frames(streams[1])
    m = BatchedAacLcDecoder(2, 2, use_native=use_native)
    m.push(0, streams[0])
    m.push(1, b"".join(frames[:30]))
    first = np.asarray(m.decode_batches(40))  # lane 1 idles 10 batches
    m.push(1, b"".join(frames[30:]))
    rest = np.asarray(m.decode_batches(n - 30))
    got = np.concatenate([first[:30, 1], rest[:, 1]])
    got = np.transpose(got, (1, 0, 2)).reshape(2, -1)
    assert cs.snr_db(cs.aac_reference(streams[1]), got) > 90.0
