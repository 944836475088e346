"""The port's fleet scheduler (``repro_torch.serve.fleet``) on the CPU,
against the reference's (``repro.serve.fleet``), following
``tests/test_fleet.py``'s cases.

Both packages get a service whose capacity is an exact multiple of the
64x64 bucket's plan work units per second (``seed_rates``, no wall
clock), and the same calls: admissions and rejections, tiers, every
ladder move of ``rebalance``, sheds and ``FleetStats.as_dict()`` must be
equal.  Frames are submitted one at a time and flushed only on the port:
a session degraded by the fleet gives what a lone ``VideoDetector`` with
the stretched config gives (rects, ``FrameStats``, order), the fleet
flushes tier by tier, realtime first, and co-keyed sessions share one
compaction per round."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core import Detector as RDetector  # noqa: E402
from repro.core import EngineConfig as RConfig  # noqa: E402
from repro.core import paper_shaped_cascade as r_cascade  # noqa: E402
import repro.serve as rserve  # noqa: E402
import repro.stream as rstream  # noqa: E402

from repro_torch.core import Detector, EngineConfig  # noqa: E402
from repro_torch.core import paper_shaped_cascade  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
import repro_torch.stream as tstream  # noqa: E402
from repro_torch.serve import (DetectorService, FleetConfig,  # noqa: E402
                               FleetScheduler, ServiceConfig, SLO_TIERS)
from repro_torch.stream import (StreamConfig, VideoDetector,  # noqa: E402
                                make_video)

SMALL = [3, 4, 5, 6, 8]
KW = dict(mode="wave", pad_multiple=32, step=2, scale_factor=1.3,
          min_neighbors=2)
HW = 64
LADDER = dict(tile=12, threshold=0.0, keyframe_interval=4,
              degrade_keyframe_mult=2.0, max_degrade_level=3)
SCFG = StreamConfig(**LADDER)
PKGS = {"port": (tserve, tstream), "ref": (rserve, rstream)}


@pytest.fixture(scope="module")
def detectors():
    return {"port": Detector(paper_shaped_cascade(0, stage_sizes=SMALL),
                             EngineConfig(**KW), device="cpu"),
            "ref": RDetector(r_cascade(0, stage_sizes=SMALL), RConfig(**KW))}


def make_fleet(detectors, name, capacity_mult=10.0, **fleet_kw):
    """``name``'s service and fleet, capacity ``capacity_mult`` times the
    64x64 bucket's plan work units per second."""
    serve, stream = PKGS[name]
    svc = serve.DetectorService(detectors[name], serve.ServiceConfig(
        stream_config=stream.StreamConfig(**LADDER)))
    units = svc._work_units((HW, HW))
    svc.seed_rates([capacity_mult * units])
    return svc, serve.FleetScheduler(svc, serve.FleetConfig(**fleet_kw)), units


def both(detectors, scenario, capacity_mult, **fleet_kw):
    """Run ``scenario(svc, fleet, units)`` on each package; returns
    ``{name: (result, fleet stats dict)}`` after asserting them equal."""
    out = {}
    for name in PKGS:
        svc, fleet, units = make_fleet(detectors, name, capacity_mult,
                                       **fleet_kw)
        out[name] = (scenario(svc, fleet, units), units,
                     svc.stats().as_dict()["fleet"])
    assert out["port"] == out["ref"]
    return out["port"]


# ----------------------------------------------------------- admission
def test_admission_boundary_accept_then_reject(detectors):
    def scenario(svc, fleet, units):
        got = [fleet.admit((HW, HW), fps=1.0, tier="standard") is not None,
               fleet.admit((HW, HW), fps=1.0, tier="standard") is not None,
               fleet.admit((HW, HW), fps=0.5, tier="best_effort")
               is not None]
        return got, fleet.demand_units_per_s() / units

    (admitted, demand), units, st = both(detectors, scenario, 2.0)
    assert admitted == [True, False, True]
    assert demand == pytest.approx(1.5)
    assert (st["admitted"], st["rejected"], st["sessions"]) == (2, 1, 2)
    assert st["by_tier"] == {"standard": 1, "best_effort": 1}
    assert st["capacity_units_per_s"] == pytest.approx(2.0 * units)
    assert st["plan_groups"] == 1


def test_fleet_requires_calibrated_capacity(detectors):
    for name in PKGS:
        serve, stream = PKGS[name]
        svc = serve.DetectorService(detectors[name], serve.ServiceConfig(
            stream_config=stream.StreamConfig(**LADDER)))
        with pytest.raises(ValueError, match="capacity unknown"):
            serve.FleetScheduler(svc)
        with pytest.raises(ValueError, match="capacity must be positive"):
            serve.FleetScheduler(svc, capacity_units_per_s=0.0)
        fleet = serve.FleetScheduler(svc, capacity_units_per_s=100.0)
        assert svc.stats().fleet.capacity_units_per_s == 100.0
        with pytest.raises(ValueError, match="fps"):
            fleet.admit((HW, HW), fps=0.0)


@pytest.mark.parametrize("kw", [dict(headroom=0.0), dict(headroom=1.5),
                                dict(restore_margin=0.0),
                                dict(degrade_demand_scale=1.2),
                                dict(admission_prior=0.0)])
def test_fleet_config_rejects_what_the_reference_rejects(kw):
    for serve, _stream in PKGS.values():
        with pytest.raises(ValueError, match=next(iter(kw))):
            serve.FleetConfig(**kw)


# ------------------------------------------------ tier-ordered ladder
def test_degradation_order_and_hysteresis_restore(detectors):
    def scenario(svc, fleet, units):
        rt = fleet.admit((HW, HW), fps=1.0, tier="realtime")
        st = fleet.admit((HW, HW), fps=1.0, tier="standard")
        be = fleet.admit((HW, HW), fps=1.0, tier="best_effort")
        for s in (rt, st, be):
            s.note_work_frac(1.0)
        rt.fps = st.fps = be.fps = 1.6        # 4.8 units/s > 3.4 budget
        steps = [fleet.rebalance()]
        levels = [(rt.degrade_level, st.degrade_level, be.degrade_level)]
        configs = [be.session.video.config == be.base_config.degraded(
            be.degrade_level)]
        rt.fps = st.fps = be.fps = 0.25
        for _ in range(SCFG.max_degrade_level + 1):
            steps.append(fleet.rebalance())
            levels.append((rt.degrade_level, st.degrade_level,
                           be.degrade_level))
        steps = [(s["degraded"], s["restored"],
                  round(s["demand_units_per_s"] / units, 9)) for s in steps]
        return steps, levels, configs

    (steps, levels, configs), _units, st = both(detectors, scenario, 4.0)
    assert steps[0][0] > 0 and all(configs)
    rt0, st0, be0 = levels[0]
    assert rt0 == 0 and be0 > 0
    if st0 > 0:
        assert be0 == SCFG.max_degrade_level
    assert sum(s[1] for s in steps[1:]) > 0
    assert levels[-1] == (0, 0, 0)
    assert st["degrade_events"] == steps[0][0]
    assert st["restore_events"] == sum(s[1] for s in steps[1:])


def test_shed_only_after_ladder_exhausted_and_only_best_effort(detectors):
    frames = {name: stream.make_video("static_cctv", n_frames=1, h=HW, w=HW,
                                      seed=0)[0][0]
              for name, (_serve, stream) in PKGS.items()}
    assert np.array_equal(frames["port"], frames["ref"])

    def scenario(svc, fleet, units):
        frame = frames["port"]
        st = fleet.admit((HW, HW), fps=0.4, tier="standard")
        be = fleet.admit((HW, HW), fps=0.4, tier="best_effort")
        st.note_work_frac(1.0)
        be.note_work_frac(1.0)
        st.fps = be.fps = 3.0
        out = [fleet.submit_frame(be, frame).dropped]
        fleet.rebalance()
        out.append((st.degrade_level, be.degrade_level))
        req = fleet.submit_frame(be, frame)
        out += [req.dropped, req.done.is_set(), req.result().shape,
                fleet.submit_frame(st, frame).dropped]
        return out

    got, _units, st = both(detectors, scenario, 1.0)
    cap = SCFG.max_degrade_level
    assert got == [False, (cap, cap), True, True, (0, 4), False]
    assert (st["frames_dropped"], st["frames_submitted"]) == (1, 3)


def test_degraded_configs_equal_reference():
    for kw in (LADDER, dict(threshold=0.01, keyframe_interval=4,
                            degrade_keyframe_mult=2.0,
                            degrade_threshold_add=0.005,
                            max_degrade_level=3),
               dict(keyframe_interval=0)):
        t, r = tstream.StreamConfig(**kw), rstream.StreamConfig(**kw)
        for level in (0, 1, 2, 3, 99):
            assert t.degraded(level)._asdict() == r.degraded(level)._asdict()


# ------------------------------------------ degraded sessions and flushes
def test_degraded_session_equal_to_lone_stretched_detector(detectors):
    """A session degraded before its first frame gives, frame by frame,
    what a lone ``VideoDetector`` with the stretched config gives; at
    threshold 0 full frames are ``detect``'s."""
    det = detectors["port"]
    svc, fleet, _units = make_fleet(detectors, "port", 1.0)
    # 96x96: small enough changed-tile sets for incremental frames
    be = fleet.admit((96, 96), fps=0.2, tier="best_effort")
    be.note_work_frac(1.0)
    be.fps = 4.0
    fleet.rebalance()
    level = be.degrade_level
    assert level > 0
    assert be.session.video.config.keyframe_interval \
        > be.base_config.keyframe_interval
    be.fps = 0.05                 # no rebalance: the degraded config stays
    lone = VideoDetector(det, be.base_config.degraded(level))
    video = make_video("static_cctv", n_frames=6, h=96, w=96, seed=3)
    modes = set()
    for i, (frame, _gt) in enumerate(video):
        req = be.submit_frame(frame)
        fleet.flush()
        rects, stats = lone.process(frame)
        assert req.error is None and not req.dropped
        assert np.array_equal(req.result(timeout=60), rects)
        assert req.stats == stats and stats.frame_idx == i
        modes.add(stats.mode)
        if stats.mode == "full":
            assert np.array_equal(rects, det.detect(frame))
    assert modes == {"full", "incremental"}


def test_flush_runs_tiers_in_order(detectors):
    svc, fleet, _units = make_fleet(detectors, "port", 100.0)
    sessions = {t: fleet.admit((HW, HW), fps=1.0, tier=t)
                for t in reversed(SLO_TIERS)}
    order = []
    real = svc.flush

    def spy(tier=None):
        order.append((tier, sorted({r.tier for r in svc._queue
                                    if r.tier == tier})))
        return real(tier=tier)

    svc.flush = spy
    frame = make_video("static_cctv", n_frames=1, h=HW, w=HW, seed=1)[0][0]
    reqs = [sessions[t].submit_frame(frame) for t in sessions]
    assert fleet.flush() == 3
    assert order == [(t, [t]) for t in SLO_TIERS]
    assert all(r.done.is_set() and r.error is None for r in reqs)


def test_co_keyed_sessions_share_one_compaction(detectors):
    det = detectors["port"]
    svc, fleet, _units = make_fleet(detectors, "port", 100.0)
    a = fleet.admit((96, 96), fps=1.0, tier="standard", tenant="a")
    b = fleet.admit((96, 96), fps=1.0, tier="standard", tenant="b")
    vids = [make_video("static_cctv", n_frames=4, h=96, w=96, seed=s)
            for s in (0, 1)]
    calls = []
    real = svc.stream_engine.incremental

    def counting(frames, masks, hp, wp, active=()):
        calls.append(len(frames))
        return real(frames, masks, hp, wp, active=active)

    svc.stream_engine.incremental = counting
    for t in range(4):
        reqs = [s.submit_frame(v[t][0]) for s, v in zip((a, b), vids)]
        if t == 3:
            builds0 = svc._program_build_count()
        fleet.flush()
        if t == 3:
            assert svc._program_build_count() == builds0
        for r, v in zip(reqs, vids):
            assert np.array_equal(r.result(timeout=60), det.detect(v[t][0]))
    assert calls and all(n == 2 for n in calls)
    assert svc.stats().fleet.plan_groups == 1


def test_release_closes_session_and_frees_demand(detectors):
    svc, fleet, units = make_fleet(detectors, "port", 2.0)
    s = fleet.admit((HW, HW), fps=1.0)
    assert fleet.admit((HW, HW), fps=1.0) is None
    s.close()
    assert s.session.closed and svc.stats().fleet.sessions == 0
    assert fleet.demand_units_per_s() == 0.0
    assert fleet.admit((HW, HW), fps=1.0) is not None


def test_stats_fleet_none_without_scheduler(detectors):
    svc = DetectorService(detectors["port"], ServiceConfig())
    assert svc.stats().fleet is None
    assert svc.stats().as_dict()["fleet"] is None
    FleetScheduler(svc, FleetConfig(), capacity_units_per_s=1.0)
    assert svc.stats().as_dict()["fleet"]["capacity_units_per_s"] == 1.0
