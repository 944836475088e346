"""The port's device-resident stream (``StreamConfig.device_state``) on the
CPU, as the reference's ``tests/test_stream_device.py`` states its
contracts: at threshold 0 it gives the host-planned stream's rects and
``FrameStats`` and per-frame ``detect``'s rects on every scenario, through
the pipelined submit/retire API, the rung-retry loop and the
decode-overflow fallback; its state lives in a fixed pair of buffers with
no executor build in steady state; the API guards hold; its tail gets the
compaction's live count; and it runs on its detector's device, which is
the card unless the caller names another."""

import numpy as np
import pytest
import torch

from repro_torch.core import Detector, EngineConfig, paper_shaped_cascade
from repro_torch.kernels import packed_tail
from repro_torch.stream import (SCENARIOS, StreamConfig, StreamEngine,
                                VideoDetector, make_video)

SMALL = [3, 4, 5, 6, 8]
KW = dict(mode="wave", step=2, scale_factor=1.3, min_neighbors=2)
HW = 96
HOST_CFG = StreamConfig(tile=12, threshold=0.0, keyframe_interval=4)
DEV_CFG = HOST_CFG._replace(device_state=True)


@pytest.fixture(scope="module")
def detector():
    return Detector(paper_shaped_cascade(0, stage_sizes=SMALL),
                    EngineConfig(**KW), device="cpu")


def frames_of(kind, n=10, seed=3, h=HW, w=HW):
    return [f for f, _gt in make_video(kind, n_frames=n, h=h, w=w,
                                       seed=seed)]


@pytest.mark.parametrize("kind", SCENARIOS)
def test_device_stream_equals_host_and_detect(detector, kind):
    vh = VideoDetector(detector, HOST_CFG)
    vd = VideoDetector(detector, DEV_CFG)
    for f in frames_of(kind):
        rh, sh = vh.process(f)
        rd, sd = vd.process(f)
        assert np.array_equal(rh, rd)
        assert sh == sd                  # mode, counters, level accounting
        assert np.array_equal(rd, detector.detect(f))
    assert vd.xfer_bytes > 0             # the accounting actually ran


@pytest.mark.parametrize("kind", SCENARIOS)
def test_pipelined_submit_retire_matches_sequential(detector, kind):
    # all-full streaks exercise the provisional ahead-dispatch (bitmap
    # stale, verdict sound); mixed scenarios its true-up when a successor's
    # verdict commits after a full refresh
    frames = frames_of(kind, n=12, seed=5)
    seq = VideoDetector(detector, DEV_CFG)
    pipe = VideoDetector(detector, DEV_CFG)
    want = [seq.process(f) for f in frames]
    got, prev = [], None
    for f in frames:                     # depth-2 double-buffered loop
        tok = pipe.submit(f)
        if prev is not None:
            got.append(pipe.retire(prev))
        prev = tok
    got.append(pipe.retire(prev))
    for (rw, sw), (rg, sg) in zip(want, got):
        assert np.array_equal(rw, rg) and sw == sg


def test_retry_grows_rung_and_stays_identical(detector):
    # a static opening (smallest sticky rung), then a pan burst: the first
    # burst frame overflows the rung, retries at a larger one, and still
    # commits the host's result
    cfg_h = HOST_CFG._replace(keyframe_interval=0, full_refresh_frac=0.95,
                              max_changed_frac=0.95)
    frames = (frames_of("static_cctv", n=3, seed=7)
              + frames_of("camera_pan", n=3, seed=7))
    vh = VideoDetector(detector, cfg_h)
    vd = VideoDetector(detector, cfg_h._replace(device_state=True))
    rung0, modes = None, []
    for f in frames:
        rh, sh = vh.process(f)
        rd, sd = vd.process(f)
        rung0 = vd._dev_rung if rung0 is None else rung0
        assert np.array_equal(rh, rd) and sh == sd
        modes.append(sd.mode)
    assert vd._dev_rung > rung0          # the sticky rung actually grew
    assert "incremental" in modes


def test_decode_overflow_falls_back_to_full(detector):
    # decode_cap below the survivor count: rects stay identical, the frame
    # is accounted as a full refresh
    vh = VideoDetector(detector, HOST_CFG)
    vd = VideoDetector(detector, DEV_CFG, decode_cap=4)
    modes = []
    for f in frames_of("static_cctv", n=6, seed=9):
        rh, _sh = vh.process(f)
        rd, sd = vd.process(f)
        modes.append(sd.mode)
        assert np.array_equal(rh, rd)
    assert set(modes) == {"full"}


def test_state_buffers_fixed_and_no_build_in_steady_state(detector):
    """A stream settled into incremental frames writes a fixed pair of
    state buffers (at most two addresses per field) and builds no
    executor after its first incremental frame; the host mirrors stay
    dropped."""
    eng = StreamEngine(detector, DEV_CFG.max_changed_frac)
    vd = VideoDetector(detector, DEV_CFG._replace(keyframe_interval=0),
                       engine=eng)
    ptrs, builds, modes = [], [], []
    for f in frames_of("static_cctv", n=12, seed=11):
        _r, s = vd.process(f)
        modes.append(s.mode)
        ptrs.append(tuple(t.data_ptr() for t in vd._dev_state))
        builds.append(eng.program_builds)
    assert modes[0] == "full" and set(modes[1:]) == {"incremental"}
    assert builds[-1] == builds[1] == 1
    for field in zip(*ptrs[1:]):
        assert len(set(field)) == 2       # ping-pong, nothing new
    assert {p for p in ptrs[1:]} == {ptrs[1], ptrs[2]}
    assert vd._ref is None and vd._bitmap is None


def test_device_stream_api_guards(detector):
    vd = VideoDetector(detector, DEV_CFG)
    frame = frames_of("static_cctv", n=1)[0]
    vd.process(frame)
    with pytest.raises(RuntimeError, match="device-resident"):
        vd.plan_frame(frame)
    with pytest.raises(ValueError, match="device_state"):
        vd.reconfigure(DEV_CFG._replace(device_state=False))
    with pytest.raises(ValueError, match="tile/halo"):
        vd.reconfigure(DEV_CFG._replace(tile=16))
    rects, st = vd.process(frame)
    assert st.mode == "cached"
    with pytest.raises(ValueError):      # cached returns are read-only
        rects[...] = 0
    tok_a, tok_b = vd.submit(frame), vd.submit(frame)
    with pytest.raises(RuntimeError, match="submit order"):
        vd.poll(tok_b)
    vd.retire(tok_a)
    vd.retire(tok_b)
    with pytest.raises(RuntimeError, match="device_state"):
        VideoDetector(detector, HOST_CFG).submit(frame)
    vd.reset()                           # next frame re-opens cleanly
    r2, s2 = vd.process(frame)
    assert s2.mode == "full"
    assert np.array_equal(r2, detector.detect(frame))


def test_cached_frames_count_no_level_and_tail_gets_live_count(
        detector, monkeypatch):
    """Every device step hands the packed tail the compaction's live count
    (0 on a frame that does not commit) and the dense-order prefix; the
    SAT accounting follows the step's levels, so a cached frame counts
    none."""
    calls = []
    real = packed_tail.stage_sums

    def spy(*args, **kw):
        if "s_dense" in kw:              # the stream's tail, not detect's
            calls.append((kw["n_live"], kw["s_dense"]))
        return real(*args, **kw)

    monkeypatch.setattr(packed_tail, "stage_sums", spy)
    eng = StreamEngine(detector)
    vd = VideoDetector(detector, DEV_CFG._replace(keyframe_interval=0),
                       engine=eng)
    frames = frames_of("intermittent_cctv", n=6, seed=4)
    stats = []
    for f in frames:
        before = eng.sat_level_builds
        _r, st = vd.process(f)
        stats.append(st)
        if st.mode != "full":
            assert eng.sat_level_builds - before == st.levels_active
    assert [s.mode for s in stats[1:4]] == ["cached"] * 3
    # one tail per device step, a rung retry's included (live count 0:
    # nothing commits)
    assert len(calls) >= len(frames) - 1
    assert all(n.dim() == 0 and n.dtype == torch.int64 and sd == 0
               for n, sd in calls)             # step 2: the oracle's order
    assert [int(n) for n, _ in calls if int(n)] == [
        st.windows_recomputed for st in stats if st.mode == "incremental"]


def test_stream_device_is_the_detectors():
    casc = paper_shaped_cascade(0, stage_sizes=SMALL)
    if torch.cuda.is_available():
        vd = VideoDetector(Detector(casc, EngineConfig(**KW)), DEV_CFG)
        assert vd.engine.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            VideoDetector(Detector(casc, EngineConfig(**KW)), DEV_CFG)
    vd = VideoDetector(Detector(casc, EngineConfig(**KW), device="cpu"),
                       DEV_CFG)
    vd.process(frames_of("static_cctv", n=1)[0])
    assert all(t.device.type == "cpu" for t in vd._dev_state)
