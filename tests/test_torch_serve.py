"""The port's detection service (``repro_torch.serve``) on the CPU: its
configuration, chunking and first governed flush against the reference
service (``repro.serve``) on the same seeded inputs and rates, and its
own contracts against the port's ``Detector`` and ``VideoDetector``
(one-shot rects equal per-image ``detect``, stream sessions equal a lone
``VideoDetector``, overflow isolated per request, the background
flusher, the deprecated construction surface).

Only decisions, shares and modelled joules are compared with the
reference: latencies, throughput and every rate observed after the first
flush come from wall clocks."""

import warnings

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core import Detector as RDetector  # noqa: E402
from repro.core import EngineConfig as RConfig  # noqa: E402
from repro.core import paper_shaped_cascade as r_cascade  # noqa: E402
from repro.core.training.data import render_scene  # noqa: E402
import repro.serve as rserve  # noqa: E402

from repro_torch.core import Detector, EngineConfig  # noqa: E402
from repro_torch.core import cascade as tcascade  # noqa: E402
from repro_torch.core import paper_shaped_cascade  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro_torch.serve import (DetectorService, FrameRequest,  # noqa: E402
                               PodSpec, Request, ServiceConfig)
from repro_torch.stream import (StreamConfig, VideoDetector,  # noqa: E402
                                make_video)

from helpers import all_pass_cascade  # noqa: E402

SMALL = [3, 4, 5, 6, 8]
KW = dict(mode="wave", pad_multiple=32, step=2, scale_factor=1.3,
          min_neighbors=2)
SCFG = StreamConfig(tile=12, threshold=0.0, keyframe_interval=4)
HW = 96
# the first governed flush: seeded nominal rates (work units / s) under
# which the energy governor slows the big pod to 0.8 GHz and splits the
# eight images 4 / 4 (one program of batch 2 on each side)
RATES = [4.0e5, 1.8e5]


def governed_config(pkg):
    return pkg.ServiceConfig(
        pods=(pkg.PodSpec("big", 1.0, "big"),
              pkg.PodSpec("little", 0.45, "LITTLE")),
        governor="energy", slo_ms=200.0, batch_sizes=(2,))


@pytest.fixture(scope="module")
def detector():
    return Detector(paper_shaped_cascade(0, stage_sizes=SMALL),
                    EngineConfig(**KW), device="cpu")


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(11)
    return [render_scene(rng, 64, 64, n_faces=1)[0] for _ in range(8)]


@pytest.fixture(scope="module")
def first_flush(detector, images):
    """A fresh governed two-pod service of each package, rates seeded
    with ``RATES``, after one flush of ``images``: ``{pkg: (rects,
    stats, service)}``.  The reference's flush builds one program."""
    out = {}
    r_det = RDetector(r_cascade(0, stage_sizes=SMALL), RConfig(**KW))
    for pkg, det in ((rserve, r_det), (tserve, detector)):
        svc = pkg.DetectorService(det, governed_config(pkg))
        svc.seed_rates(RATES)
        rects = svc.detect_many(images)
        out[pkg] = (rects, svc.stats(), svc)
    return out


@pytest.fixture(scope="module")
def videos():
    return [[f for f, _gt in make_video("static_cctv", n_frames=5, h=HW,
                                        w=HW, seed=s)] for s in (0, 1)]


# ------------------------------------------------------- configuration
BAD_CONFIGS = {
    "no_pods": dict(pods=()),
    "zero_speed": dict(pods=(("PodSpec", "a", 0.0),)),
    "max_batch": dict(max_batch=0),
    "batch_sizes": dict(batch_sizes=(0, 2)),
    "empty_batch_sizes": dict(batch_sizes=()),
    "strategy": dict(strategy="scan"),
    "rate_ema": dict(rate_ema=1.5),
    "governor": dict(governor="bogus"),
    "slo_ms": dict(slo_ms=0.0),
    "wake_j": dict(wake_j=-1.0),
    "tier_name": dict(tier_slos={"gold": 10.0}),
    "tier_slo": dict(tier_slos={"realtime": 0.0}),
}


def _build(pkg, kw):
    kw = {k: (tuple(pkg.PodSpec(*p[1:]) for p in v) if k == "pods" and v
              else v) for k, v in kw.items()}
    try:
        pkg.ServiceConfig(**kw)
    except Exception as e:              # noqa: BLE001
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", list(BAD_CONFIGS))
def test_service_config_errors_equal_reference(case):
    got = _build(tserve, BAD_CONFIGS[case])
    assert got is not None and got[0] == "ValueError"
    assert got == _build(rserve, BAD_CONFIGS[case])


def test_service_config_normalises_as_reference():
    kw = dict(batch_sizes=[8, 2, 2, 1], tier_slos={"realtime": 20.0},
              pods=[("big", 1.0, "big"), ("little", 0.5, "LITTLE")])
    cfgs = {}
    for pkg in (rserve, tserve):
        c = pkg.ServiceConfig(**{**kw, "pods": [pkg.PodSpec(*p)
                                                for p in kw["pods"]]})
        cfgs[pkg] = (c.batch_sizes, c.tier_slos,
                     [(p.name, p.speed, p.cluster) for p in c.pods],
                     c.tier_slo_ms("realtime"), c.tier_slo_ms("standard"))
    assert cfgs[tserve] == cfgs[rserve]
    assert tserve.SLO_TIERS == rserve.SLO_TIERS
    assert tserve.GOVERNORS == rserve.GOVERNORS
    assert tserve.SCHEMA_VERSION == rserve.SCHEMA_VERSION == 1


@pytest.mark.parametrize("sizes, max_batch, n", [
    ((1, 2, 4), 4, 7), ((1, 2, 4, 8), 8, 13), ((2,), 8, 5), ((4, 8), 2, 3),
    ((1, 3), 8, 0)])
def test_chunks_equal_reference(detector, sizes, max_batch, n):
    r_det = RDetector(r_cascade(0, stage_sizes=SMALL), RConfig(**KW))
    r = rserve.DetectorService(r_det, rserve.ServiceConfig(
        batch_sizes=sizes, max_batch=max_batch))
    t = DetectorService(detector, ServiceConfig(batch_sizes=sizes,
                                                max_batch=max_batch))
    shard = list(range(n))
    assert t._chunks(shard) == r._chunks(shard)
    assert sum(len(c) for c in t._chunks(shard)) == n


# ----------------------------------------------------------- one-shots
def test_detect_many_equals_detect(detector):
    rng = np.random.default_rng(9)
    shapes = [(64, 64), (64, 64), (70, 90), (100, 60), (64, 64)]
    imgs = [render_scene(rng, h, w, n_faces=1)[0] for h, w in shapes]
    svc = DetectorService(detector, ServiceConfig(
        pods=(PodSpec("big", 1.0), PodSpec("little", 0.4))))
    got = svc.detect_many(imgs)
    for im, rects in zip(imgs, got):
        assert np.array_equal(rects, detector.detect(im))
    st = svc.stats()
    assert st.n_done == len(imgs) == sum(p.images for p in st.pods)
    assert svc.flush() == 0


def test_first_governed_flush_equals_reference(first_flush, detector,
                                               images):
    """Under the same seeded rates the first flush takes the reference's
    decision, shares and modelled joules, and the rects equal per-image
    ``detect`` (and the reference's)."""
    r_rects, r_st, r_svc = first_flush[rserve]
    t_rects, t_st, t_svc = first_flush[tserve]
    for im, t, r in zip(images, t_rects, r_rects):
        assert np.array_equal(t, detector.detect(im))
        assert np.array_equal(t, r)
    rd, td = r_st.as_dict(), t_st.as_dict()
    assert td["energy"] == rd["energy"]
    assert td["energy"]["last_decision"]["ops"] == ["big@0.8GHz",
                                                     "LITTLE@1.4GHz"]
    assert td["last_plan"] == rd["last_plan"]
    assert [p["images"] for p in td["pods"]] == [4, 4]
    for tp, rp in zip(td["pods"], rd["pods"]):
        # ``rate`` is the EMA of a wall-clock rate after this flush
        tp.pop("rate"), rp.pop("rate")
        assert tp == rp
    for key in ("schema_version", "n_done", "makespan_imbalance", "replans",
                "stream", "tail", "fleet"):
        assert td[key] == rd[key], key
    assert set(td) == set(rd)
    assert t_svc._work_units((64, 64)) == r_svc._work_units((64, 64))
    assert t_st.energy.last_decision.work_units == 8 * t_svc._work_units(
        (64, 64))


def test_stats_dict_shim_warns(first_flush):
    st = first_flush[tserve][1]
    with pytest.warns(DeprecationWarning):
        assert st["energy"] == st.as_dict()["energy"]


def test_overflow_isolated_per_request():
    """A batch in which every window survives overflows the shared
    capacity; each request then falls back to per-image ``detect``."""
    arrays = {f: np.asarray(getattr(all_pass_cascade(), f))
              for f in tcascade.FIELDS}
    det = Detector(tcascade.from_numpy(arrays),
                   EngineConfig(mode="wave", step=1, scale_factor=2.0,
                                batch_capacity_fracs=(0.01,),
                                capacity_fracs=(1.0,)), device="cpu")
    imgs = [np.zeros((48, 48), np.float32)] * 2
    with pytest.raises(RuntimeError, match="overflow"):
        det.detect_batch(imgs)
    svc = DetectorService(det)
    reqs = [svc.submit(im) for im in imgs]
    svc.flush()
    for r, im in zip(reqs, imgs):
        assert r.error is None
        assert np.array_equal(r.result(), det.detect(im))


# ------------------------------------------------------------- streams
def _lone(detector, frames, cfg):
    vd = VideoDetector(detector, cfg)
    return [vd.process(f) for f in frames]


def test_stream_sessions_share_a_flush_with_one_shots(detector, videos,
                                                      images):
    """A device-state and a host-planned session, and one-shots, in one
    flush: each session's frames equal a lone ``VideoDetector``'s, in
    order, and the one-shots equal ``detect``."""
    svc = DetectorService(detector, ServiceConfig(
        pods=(PodSpec("big", 1.0), PodSpec("little", 0.4)),
        stream_config=SCFG))
    cfgs = (SCFG._replace(device_state=True), SCFG)
    sessions = [svc.open_stream(cfg) for cfg in cfgs]
    reqs, ones = [], []
    for t in range(5):
        for sess, vid in zip(sessions, videos):
            reqs.append(sess.submit_frame(vid[t]))
        if t < 2:
            ones.append(svc.submit(images[t]))
    assert svc.flush() == 12
    for j, (vid, cfg) in enumerate(zip(videos, cfgs)):
        got = reqs[j::2]
        for r, (rects, stats) in zip(got, _lone(detector, vid, cfg)):
            assert isinstance(r, FrameRequest) and isinstance(r, Request)
            assert np.array_equal(r.result(), rects)
            assert r.stats == stats
        assert [r.stats.frame_idx for r in got] == list(range(5))
    for r, im in zip(ones, images):
        assert np.array_equal(r.result(), detector.detect(im))
    st = svc.stats()
    assert st.stream.sessions == 2 and st.stream.frames_done == 10
    assert st.stream.frame_modes["incremental"] > 0
    assert sum(p.images for p in st.pods) == 12


def test_closed_stream_rejects_frames(detector, videos):
    svc = DetectorService(detector, ServiceConfig(stream_config=SCFG))
    sess = svc.open_stream()
    sess.close()
    with pytest.raises(RuntimeError, match="closed"):
        sess.submit_frame(videos[0][0])
    assert svc.stats().stream.sessions == 0


@pytest.mark.parametrize("device_state", [False, True])
def test_shape_change_completes_with_error(detector, videos, device_state):
    svc = DetectorService(detector, ServiceConfig(stream_config=SCFG))
    sess = svc.open_stream(SCFG._replace(device_state=device_state))
    ok = sess.submit_frame(videos[0][0])
    bad = sess.submit_frame(np.zeros((HW, HW + 2), np.float32))
    svc.flush()
    assert np.array_equal(ok.result(), detector.detect(videos[0][0]))
    with pytest.raises(ValueError, match="shape changed"):
        bad.result()


def test_background_flusher_completes_everything(detector, videos, images):
    svc = DetectorService(detector, ServiceConfig(
        max_batch=2, max_delay_ms=10.0, stream_config=SCFG))
    sess = svc.open_stream(SCFG._replace(device_state=True))
    svc.start()
    try:
        ones = [svc.submit(im) for im in images[:3]]
        frames = [sess.submit_frame(f) for f in videos[0]]
    finally:
        svc.stop()
    for r, im in zip(ones, images):
        assert r.done.is_set() and r.error is None
        assert np.array_equal(r.result(), detector.detect(im))
    lone = _lone(detector, videos[0], SCFG._replace(device_state=True))
    for r, (rects, stats) in zip(frames, lone):
        assert r.done.is_set() and r.error is None
        assert np.array_equal(r.result(), rects) and r.stats == stats
    assert svc.stats().n_done == 8


# --------------------------------------------------------- deprecations
def test_legacy_keywords_warn_and_build_the_same_config(detector):
    kw = dict(pods=(PodSpec("big", 1.0, "big"),), max_batch=4,
              governor="max", slo_ms=80.0)
    with pytest.warns(DeprecationWarning):
        svc = DetectorService(detector, **kw)
    assert svc.config == ServiceConfig(**kw)
    with pytest.raises(TypeError):
        DetectorService(detector, ServiceConfig(), max_batch=2)
    with pytest.raises(ValueError), warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        DetectorService(detector, governor="bogus")


def test_service_runs_on_its_detectors_device(detector):
    """No device of its own: the service's detector (here built with
    ``device="cpu"``) decides where every flush runs."""
    svc = DetectorService(detector)
    assert svc.detector.device == torch.device("cpu")
    assert svc.stream_engine.detector is detector
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Detector(paper_shaped_cascade(0, stage_sizes=SMALL))


def test_first_use_kernel_build_runs_once_across_threads(monkeypatch,
                                                         tmp_path):
    """A service's flusher thread and its caller may launch a kernel for
    the first time at once: the library is built and loaded once, under
    ``native``'s lock, and ``library_loads`` counts the load."""
    import threading
    import time

    from repro_torch.kernels import native

    builds = []

    def fake_build():
        builds.append(threading.get_ident())
        time.sleep(0.05)            # long enough for the threads to meet
        native._library_path(source).touch()

    source = "integral_image.cu"
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "build_all", fake_build)
    monkeypatch.setattr(native.ctypes, "CDLL", lambda path: ("lib", path))
    monkeypatch.setattr(native, "_libs", {})
    loads0 = native.library_loads()
    got = []
    threads = [threading.Thread(target=lambda: got.append(
        native._library(source))) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(builds) == 1
    assert len(set(got)) == 1 and len(got) == 4
    assert native.library_loads() == loads0 + 1
