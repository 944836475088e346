"""The port's scheduling package (``repro_torch.scheduling``) against the
reference (``repro.scheduling``) on the same inputs: the detection DAG,
the discrete-event simulator under every policy on the paper's
platforms, the DVFS sweep and optimum, the serving governor's operating
points and selection, the energy ledger, the pod partitioner (including
fault C3, which the port keeps), detection matching, the work model from
a measured profile, and one accuracy-sweep cell.  Everything but the
detectors is plain Python, so results are compared exactly."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import repro.scheduling as R  # noqa: E402
import repro.scheduling.energy as r_energy  # noqa: E402
from repro.core import Detector as RDetector  # noqa: E402
from repro.core import EngineConfig as RConfig  # noqa: E402
from repro.core import paper_shaped_cascade as r_cascade  # noqa: E402
from repro.core.training.data import render_scene as r_render  # noqa: E402

import repro_torch.scheduling as T  # noqa: E402
import repro_torch.scheduling.energy as t_energy  # noqa: E402
from repro_torch.core import Detector, EngineConfig  # noqa: E402
from repro_torch.core import paper_shaped_cascade  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SIZES = [3, 8, 14, 20, 30]
SMALL = [3, 4, 5, 6, 8]
POLICIES = ["SequentialScheduler", "FIFOScheduler", "StaticBlockScheduler",
            "BotlevScheduler", "HEFTScheduler"]
PLATFORMS = {"odroid_2.0": ("odroid_xu4", dict(f_big=2.0)),
             "odroid_1.0": ("odroid_xu4", dict(f_big=1.0)),
             "rpi3b": ("rpi3b", {})}


def fields(x):
    """A dataclass (nested ones too) as a plain tuple, for comparing the
    two packages' records."""
    return dataclasses.astuple(x)


def dag_rows(dag):
    return [fields(t) for t in dag.tasks]


@pytest.fixture(scope="module")
def dags():
    args = (120, 160, SIZES)
    kw = dict(step=2, scale_factor=1.3)
    return (R.build_detection_dag(*args, **kw),
            T.build_detection_dag(*args, **kw))


# ------------------------------------------------------------------ DAG
def test_detection_dag_equals_reference(dags):
    r, t = dags
    assert len(t) == len(r) > 10
    assert dag_rows(t) == dag_rows(r)
    assert np.array_equal(t.bottom_levels(), r.bottom_levels())
    assert np.array_equal(t.bottom_levels(rate=0.45),
                          r.bottom_levels(rate=0.45))
    assert t.successors() == r.successors()
    assert np.array_equal(t.indegrees(), r.indegrees())
    assert t.total_work == r.total_work
    assert t.critical_path_work() == r.critical_path_work()
    t.validate()


@pytest.mark.parametrize("kw", [
    dict(step=1, scale_factor=1.2, n_images=2),
    dict(step=3, scale_factor=1.5, tile_windows=512,
         segments=[(0, 2), (2, 5)]),
], ids=["two_images", "segments"])
def test_detection_dag_options_equal_reference(kw):
    wr = R.WorkModel.geometric(SIZES, rate=0.4)
    wt = T.WorkModel.geometric(SIZES, rate=0.4)
    r = R.build_detection_dag(96, 128, SIZES, work_model=wr, **kw)
    t = T.build_detection_dag(96, 128, SIZES, work_model=wt, **kw)
    assert dag_rows(t) == dag_rows(r)
    assert (T.dag.PIX_DOWNSCALE, T.dag.PIX_INTEGRAL, T.dag.VAR_WINDOW) == (
        R.dag.PIX_DOWNSCALE, R.dag.PIX_INTEGRAL, R.dag.VAR_WINDOW)


# ------------------------------------------------------------- simulator
@pytest.mark.parametrize("platform", list(PLATFORMS))
@pytest.mark.parametrize("policy", POLICIES)
def test_simulate_equals_reference(dags, policy, platform):
    fn, kw = PLATFORMS[platform]
    runs = []
    for pkg, dag in zip((R, T), dags):
        runs.append(pkg.simulate(dag, getattr(pkg, fn)(**kw),
                                 getattr(pkg, policy)(), keep_trace=True))
    r, t = runs
    assert (t.makespan, t.energy, t.avg_power) == (r.makespan, r.energy,
                                                   r.avg_power)
    assert t.busy_seconds == r.busy_seconds
    assert t.trace == r.trace           # every task's core, start and end
    assert (t.n_tasks, t.scheduler, t.platform) == (r.n_tasks, r.scheduler,
                                                    r.platform)
    assert t.cpu_utilization == r.cpu_utilization
    assert T.executor.REF_RATE == R.executor.REF_RATE
    assert T.executor.CONTENTION_ALPHA == R.executor.CONTENTION_ALPHA


# ------------------------------------------------------------------ DVFS
def test_dvfs_sweep_and_optimum_equal_reference():
    def err(s, sf):
        return 0.02 if s <= 2 else 0.5

    kw = dict(height=96, width=96, n_images=1, steps=(1, 2, 4),
              scale_factors=(1.2, 1.5))
    r = R.dvfs_sweep(SIZES, err, **kw)
    t = T.dvfs_sweep(SIZES, err, **kw)
    assert [fields(p) for p in t] == [fields(p) for p in r]
    assert [p.edp for p in t] == [p.edp for p in r]
    for max_error in (0.10, 0.01):
        assert fields(T.optimal_operating_point(t, max_error)) == fields(
            R.optimal_operating_point(r, max_error))


# ----------------------------------------------------- power model tables
def test_power_model_tables_equal_reference():
    for name in ("_A15_VOLTS", "_A7_VOLTS", "_A53_VOLTS", "_IPC",
                 "EXYNOS_BIG_FREQS", "EXYNOS_LITTLE_FREQS"):
        assert getattr(t_energy, name) == getattr(r_energy, name), name
    for fn, kw in (("odroid_xu4", {}), ("odroid_xu4", dict(f_big=0.8,
                                                          f_little=1.0)),
                   ("rpi3b", {}), ("rpi3b", dict(f=1.0)),
                   ("tpu_v5e_pod", dict(n_chips=8, power_state=0.5))):
        rp, tp = getattr(R, fn)(**kw), getattr(T, fn)(**kw)
        assert fields(tp) == fields(rp)
        for rc, tc in zip(rp.clusters, tp.clusters):
            assert (tc.rate, tc.active_power) == (rc.rate, rc.active_power)
    specs = [("fast", "TPUv5e", 4, 1.0), ("slow", "TPUv4", 2, 0.8)]
    assert fields(T.mixed_pod_platform(specs)) == fields(
        R.mixed_pod_platform(specs))
    with pytest.raises(ValueError) as et:
        T.odroid_xu4().cluster("big").at_freq(1.7)
    with pytest.raises(ValueError) as er:
        R.odroid_xu4().cluster("big").at_freq(1.7)
    assert str(et.value) == str(er.value)


@pytest.mark.parametrize("cluster, idle", [("big", None), ("LITTLE", None),
                                           ("big", 0.7)])
def test_pod_operating_points_equal_reference(cluster, idle):
    r = R.pod_operating_points(cluster, idle)
    t = T.pod_operating_points(cluster, idle)
    assert [fields(p) for p in t] == [fields(p) for p in r]
    assert fields(T.parked_point(t)) == fields(R.parked_point(r))


def _decision(d):
    return None if d is None else (fields(d), d.power)


def test_governor_selection_equals_reference():
    rng = np.random.default_rng(0)
    ladders = {pkg: (pkg.pod_operating_points("big"),
                     pkg.pod_operating_points("LITTLE")) for pkg in (R, T)}
    n = 0
    for _ in range(40):
        work = float(rng.choice([0.5, 5.0, 50.0, 500.0, 13360.0]))
        rates = tuple(float(x) for x in rng.uniform(0.0, 120.0, 2))
        slo = float(rng.choice([1e-6, 0.05, 0.5, 5.0, np.inf]))
        tiers = [slo, float(rng.uniform(0.01, 10.0))]
        wake = float(rng.choice([0.0, 0.02, 0.5]))
        for slo_arg in (slo, tiers):
            out = []
            for pkg in (R, T):
                try:
                    out.append(_decision(pkg.select_operating_points(
                        work, rates, ladders[pkg], slo_arg, wake)))
                except ValueError as e:
                    out.append(("ValueError", str(e)))
            assert out[1] == out[0]
            n += out[0][0] != "ValueError"
            # one fixed placement: every pod on a seeded rung or parked
            pick = [int(rng.integers(0, len(lad) + 1))
                    for lad in ladders[R]]
            ev = []
            for pkg in (R, T):
                ops = tuple(lad[i] if i < len(lad) else pkg.parked_point(lad)
                            for lad, i in zip(ladders[pkg], pick))
                ev.append(_decision(pkg.evaluate_operating_points(
                    work, rates, ops, slo_arg, wake)))
            assert ev[1] == ev[0]
        assert T.binding_slo(tiers) == R.binding_slo(tiers)
    assert n > 0
    assert T.binding_slo([]) == R.binding_slo([])


def test_energy_account_equals_reference():
    accts = {}
    for pkg in (R, T):
        big, little = (pkg.pod_operating_points("big"),
                       pkg.pod_operating_points("LITTLE"))
        acct = pkg.EnergyAccount(2)
        ms = [acct.charge_shard((big[2], little[0]), busy_s=[2.0, 4.0],
                                units=[20, 10], slo_s=5.0, wake_J=0.1),
              acct.charge_shard((pkg.parked_point(big), little[0]),
                                busy_s=[0.0, 10.0], units=[0, 5], slo_s=5.0,
                                wake_J=0.1,
                                tier_slos={"realtime": 1.0,
                                           "standard": 12.0}),
              acct.charge_shard((big[0], little[1]), busy_s=[0.5, 0.25],
                                units=[7, 3],
                                tier_slos={"realtime": 1.0})]
        accts[pkg] = (ms, acct.active_J, acct.idle_J, acct.busy_s,
                      acct.work_units, acct.op_names, acct.flushes,
                      acct.slo_met, acct.makespans, acct.total_J,
                      acct.slo_met_by_tier(), acct.summary())
    assert accts[T] == accts[R]


# ------------------------------------------------------- pod partitioner
def _split_grid():
    rng = np.random.default_rng(1)
    grid = [(19, [1.0, 1.0], 2)]
    for _ in range(60):
        n = int(rng.integers(0, 4097))
        rates = [float(x) for x in rng.uniform(0.1, 10.0,
                                               int(rng.integers(1, 7)))]
        if rng.random() < 0.3:
            rates[int(rng.integers(0, len(rates)))] = 0.0
        if not any(rates):
            rates[0] = 1.0
        grid.append((n, rates, int(rng.choice([1, 2, 8]))))
    grid.append((3, [1.0, 2.0], 8))
    grid.append((64, [2.0, 0.0, 1.0], 4))
    return grid


def test_rate_weighted_split_keeps_reference_rounding_fault_c3():
    """Fault C3: with equal rates the largest-remainder unit and the
    ``n % quantum`` leftover both land on pod 0, so the shares differ by
    more than one quantum.  The port keeps the reference's shares."""
    r = R.rate_weighted_split(19, [1.0, 1.0], quantum=2)
    t = T.rate_weighted_split(19, [1.0, 1.0], quantum=2)
    assert r.shares == t.shares == (11, 8)
    assert fields(t) == fields(r)


def test_pod_partitioner_equals_reference():
    rng = np.random.default_rng(2)
    for n, rates, quantum in _split_grid():
        names = [f"p{i}" for i in range(len(rates))]
        r = R.rate_weighted_split(n, rates, names, quantum=quantum)
        t = T.rate_weighted_split(n, rates, names, quantum=quantum)
        assert fields(t) == fields(r), (n, rates, quantum)
        assert t.imbalance == r.imbalance or (np.isnan(t.imbalance)
                                              and np.isnan(r.imbalance))
        measured = [x * float(rng.uniform(0.3, 1.7)) for x in rates]
        for thr in (0.05, 0.15, 10.0):
            rr = R.replan_on_straggle(r, measured, thr)
            tt = T.replan_on_straggle(t, measured, thr)
            assert (tt is None) == (rr is None)
            if rr is not None:
                assert fields(tt) == fields(rr)
        observed = np.where(rng.random(len(rates)) < 0.5, 0.0,
                            rng.uniform(0.0, 20.0, len(rates)))
        for alpha in (0.0, 0.5, 1.0):
            assert np.array_equal(T.update_rates_ema(rates, observed, alpha),
                                  R.update_rates_ema(rates, observed, alpha))
    with pytest.raises(ValueError) as et:
        T.rate_weighted_split(4, [0.0, 0.0])
    with pytest.raises(ValueError) as er:
        R.rate_weighted_split(4, [0.0, 0.0])
    assert str(et.value) == str(er.value)


# --------------------------------------------------------- accuracy side
def test_match_detections_equals_reference():
    rng = np.random.default_rng(3)
    for _ in range(50):
        gt = rng.integers(0, 80, (int(rng.integers(0, 5)), 4)).astype(
            np.float64)
        gt[:, 2:] = rng.integers(10, 40, (len(gt), 2))
        det = np.concatenate([gt + rng.integers(-6, 7, gt.shape),
                              rng.integers(0, 90, (int(rng.integers(0, 4)),
                                                   4))]).astype(np.int32)
        det[:, 2:] = np.maximum(det[:, 2:], 4)
        rng.shuffle(det)
        for thr in (0.4, 0.1):
            assert T.match_detections(det, gt, thr) == \
                R.match_detections(det, gt, thr)
    cells = [R.SweepCell(s, sf, 10, 7, 2, 3) for s in (1, 2, 4)
             for sf in (1.2, 1.5)]
    r_model = R.error_table(cells)
    t_model = T.error_table([T.SweepCell(*fields(c)) for c in cells])
    for s, sf in ((1, 1.2), (2, 1.5), (3, 1.3), (9, 1.1)):
        assert t_model(s, sf) == r_model(s, sf)


@pytest.fixture(scope="module")
def profile_pair():
    """``work_profile`` of one seeded 64x64 scene on both packages'
    detectors (the 5-stage cascade, step 2)."""
    img = r_render(np.random.default_rng(7), 64, 64, n_faces=1)[0]
    kw = dict(mode="wave", step=2, scale_factor=1.3, min_neighbors=2)
    r = RDetector(r_cascade(0, stage_sizes=SMALL), RConfig(**kw))
    t = Detector(paper_shaped_cascade(0, stage_sizes=SMALL),
                 EngineConfig(**kw), device="cpu")
    return r.work_profile(img), t.work_profile(img)


def _work_model(pkg, prof):
    """The work model from level 0's survivors, as the reference's
    ``benchmarks/bench_rit.py`` builds it."""
    lv = prof["per_level"][0]
    return pkg.WorkModel.from_profile(SMALL, lv["alive_counts"],
                                      lv["windows"])


def test_work_model_from_profile_equals_reference(profile_pair):
    rp, tp = profile_pair
    assert tp["total_windows"] == rp["total_windows"]
    assert tp["weak_evals_early_exit"] == rp["weak_evals_early_exit"]
    r, t = _work_model(R, rp), _work_model(T, tp)
    assert np.array_equal(t.stage_sizes, r.stage_sizes)
    assert np.array_equal(t.survival, r.survival)
    for s0, s1 in ((0, 1), (1, 3), (0, 5)):
        assert t.segment_work(1000.0, s0, s1) == r.segment_work(1000.0, s0,
                                                                s1)
    kw = dict(step=2, scale_factor=1.3)
    assert dag_rows(T.build_detection_dag(64, 64, SMALL, work_model=t,
                                          **kw)) == \
        dag_rows(R.build_detection_dag(64, 64, SMALL, work_model=r, **kw))


def test_accuracy_sweep_cell_equals_reference():
    kw = dict(steps=(2,), scale_factors=(1.3,), n_images=2, height=64,
              width=64, seed=3)
    r = R.accuracy_sweep(r_cascade(0, stage_sizes=SMALL), **kw)
    t = T.accuracy_sweep(paper_shaped_cascade(0, stage_sizes=SMALL),
                         device="cpu", **kw)
    assert [fields(c) for c in t] == [fields(c) for c in r]
    assert t[0].n_faces > 0


def test_accuracy_sweep_needs_a_card_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.accuracy_sweep(paper_shaped_cascade(0, stage_sizes=SMALL),
                         steps=(2,), scale_factors=(1.3,), n_images=1,
                         height=32, width=32)


def test_scheduling_and_serve_import_no_jax():
    code = ("import sys, repro_torch.scheduling, repro_torch.serve; "
            "assert 'jax' not in sys.modules, 'jax'; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'repro'")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
