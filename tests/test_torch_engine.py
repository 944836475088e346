"""The port's main path against the reference, on the CPU (every kernel's
plain version): ``Detector.detect`` / ``detect_batch`` with
``use_pallas=True, step=1`` give the reference's ``use_pallas=False``
detections on seeded scenes, with the tail forced through each backend and
both dense heads; and inside the port batch == single and fused == split.
Plus the static-capacity compaction, overflow, plan-cache and device
contracts, and ``chip_smoke.py``'s refusal to run without a card."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core import Detector as RDetector, EngineConfig as RConfig  # noqa: E402
from repro.core import cascade as rcascade, nms as rnms  # noqa: E402
from repro.core.training.data import render_scene  # noqa: E402

from repro_torch.core import Detector, EngineConfig  # noqa: E402
from repro_torch.core import cascade as tcascade  # noqa: E402
from repro_torch.core.engine import nonzero_static, resolve_device  # noqa: E402
from repro_torch.kernels import autotune, ops, packed_window  # noqa: E402

from helpers import all_pass_cascade  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SMALL = [3, 4, 5, 6, 8]
RCASC = rcascade.paper_shaped_cascade(0, stage_sizes=SMALL)
TCASC = tcascade.paper_shaped_cascade(0, stage_sizes=SMALL)
KW = dict(mode="wave", step=1, min_neighbors=2)


def _port(**kw):
    return Detector(TCASC, EngineConfig(**{**KW, **kw}), device="cpu")


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(7)
    return [render_scene(rng, 64, 64, n_faces=1)[0] for _ in range(3)]


@pytest.fixture(scope="module")
def reference(corpus):
    det = RDetector(RCASC, RConfig(**KW))
    return [det.detect(im, group=False) for im in corpus]


# ------------------------------------------------------------- the slice
@pytest.mark.parametrize("head", ["fused", "split"])
@pytest.mark.parametrize("backend", ["gather", "bulk", "pallas"])
def test_port_detections_equal_reference(corpus, reference, backend, head):
    d = _port(use_pallas=True, tail_backend=backend, head_mode=head)
    assert all(m == head for m in d.batch_plan(64, 64, 3).head_modes)
    single = [d.detect(im, group=False) for im in corpus]
    packed = d.detect_batch(corpus, group=False)
    vmap = d.detect_batch(corpus, group=False, strategy="vmap")
    assert sum(len(r) for r in reference) > 0
    for want, a, b, c in zip(reference, single, packed, vmap):
        assert np.array_equal(a, want)
        assert np.array_equal(b, want)
        assert np.array_equal(c, want)
    grouped = d.detect_batch(corpus)
    for want, got in zip(reference, grouped):
        assert np.array_equal(got, rnms.group_rectangles(want, 2))


@pytest.mark.parametrize("lane_block", [(), (16, 128), (8, 256)])
def test_plan_lane_block_and_live_count_reach_kernel_c(corpus, reference,
                                                       monkeypatch,
                                                       lane_block):
    """Every kernel C call gets the plan's lane_block; the packed flush
    and ``detect`` (one image) pass the compaction's live count, the vmap
    strategy (several images' rows) none; rects stay the reference's."""
    calls = []
    real = packed_window.stage_sums

    def spy(*args, n_live=None, lane_block=None, **kw):
        calls.append((n_live, lane_block))
        return real(*args, n_live=n_live, lane_block=lane_block, **kw)

    monkeypatch.setattr(packed_window, "stage_sums", spy)
    d = _port(use_pallas=True, tail_backend="pallas", lane_block=lane_block)
    want_block = d.batch_plan(64, 64, 3).lane_block
    assert want_block == (lane_block or autotune.DEFAULT_TILE)
    for name, run in (
            ("packed", lambda: d.detect_batch(corpus, group=False)),
            ("detect", lambda: [d.detect(im, group=False) for im in corpus]),
            ("vmap", lambda: d.detect_batch(corpus, group=False,
                                            strategy="vmap"))):
        calls.clear()
        for want, got in zip(reference, run()):
            assert np.array_equal(got, want), name
        assert calls, name
        for n_live, block in calls:
            assert (block or autotune.DEFAULT_TILE) == want_block, name
            assert (n_live is None) == (name == "vmap"), name
            if n_live is not None:
                assert n_live.dtype == torch.int64 and n_live.dim() == 0


def test_oracle_path_equals_kernel_path(corpus, reference):
    """use_pallas=False (plain oracle dense waves) gives the same rects."""
    d = _port()
    for want, got in zip(reference, d.detect_batch(corpus, group=False)):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("mode", ["wave", "dense"])
def test_mixed_shapes_batch_equals_single(mode):
    rng = np.random.default_rng(23)
    shapes = [(64, 64), (52, 60), (60, 45), (70, 90)]
    imgs = [render_scene(rng, h, w, n_faces=1)[0] for h, w in shapes]
    for kw in (dict(use_pallas=True, pad_multiple=32),
               dict(step=2, scale_factor=1.3, pad_multiple=64)):
        d = _port(mode=mode, **kw)
        singles = [d.detect(im) for im in imgs]
        for strategy in ("packed", "vmap"):
            for s, b in zip(singles, d.detect_batch(imgs, strategy=strategy)):
                assert np.array_equal(s, b)


def test_alive_counts_equal_reference(corpus):
    ref = RDetector(RCASC, RConfig(**KW))
    port = _port(use_pallas=True, tail_backend="pallas")
    for (r, _), (t, _) in zip(ref.detect_raw(corpus[0]),
                              port.detect_raw(corpus[0])):
        assert np.array_equal(t.alive_counts.numpy(),
                              np.asarray(r.alive_counts))
        assert np.array_equal(t.ys.numpy(), np.asarray(r.ys))
        assert np.array_equal(t.valid.numpy(), np.asarray(r.valid))


def test_batch_alive_counts_sum_the_level_counts(corpus):
    """The packed flush's per-image survivor counts (kernel E's gates and
    counts over the shared list's live prefix, its twin on the CPU) equal
    the level programs' counts summed over levels."""
    d = _port(use_pallas=True, tail_backend="pallas", capacity_fracs=(1.0,))
    head_fn, tail_fn = d.batch_parts(64, 64, 3)
    stack, valid_hw = d._pack_stack(corpus, 64, 64)
    res = tail_fn(*head_fn(*d._stack_to_device(stack, valid_hw)))
    levels = d.detect_batch_raw(corpus)
    assert not bool(res.overflow)
    assert not any(bool(r.overflow.any()) for r, _ in levels)
    per_level = torch.stack([r.alive_counts for r, _ in levels]).sum(0)
    assert torch.equal(res.alive_counts, per_level.T.to(torch.int32))


@pytest.mark.parametrize("backend", ["gather", "bulk", "pallas"])
def test_batch_tail_gates_each_segment_once(corpus, monkeypatch, backend):
    """``tail_fn`` hands each tail segment's sums, whatever the backend, to
    ``ops.tail_gate_counts`` once, with that segment's thresholds, count
    rows and live count; the flush's rects stay the level programs'."""
    d = _port(use_pallas=True, tail_backend=backend, capacity_fracs=(1.0,))
    plan = d.batch_plan(64, 64, 3)
    seen = []
    real = ops.tail_gate_counts

    def spy(ss_run, thr, valid, b_sel, n_live, counts):
        seen.append((ss_run.shape[0], thr.shape[0], counts.shape,
                     int(n_live) <= ss_run.shape[1]))
        return real(ss_run, thr, valid, b_sel, n_live, counts)

    monkeypatch.setattr(ops, "tail_gate_counts", spy)
    got = d.detect_batch(corpus, group=False)
    segs = plan.tail_segments
    assert segs and seen == [(s.s1 - s.s0, s.s1 - s.s0, (s.s1 - s.s0, 3),
                              True) for s in segs]
    for a, b in zip(got, d.detect_batch(corpus, group=False,
                                        strategy="vmap")):
        assert np.array_equal(a, b)


# the packed flush's copy back: its cases, each a config and a batch (faces
# from the corpus, "blank" a zero image, "wide" a 70x90 scene), and which
# images have no rects
_BLANK = np.zeros((64, 64), np.float32)
COPY_BACK_CASES = {
    "one_image_without_rects": (dict(compact_every=1), "f0 blank f1", {1}),
    "no_image_with_rects": (dict(compact_every=1), "blank blank", {0, 1}),
    "dense_only": (dict(mode="dense"), "f0 f1 f2", set()),
    "tail_from_stage_0": (dict(dense_segments=(), compact_every=5),
                          "f0 blank f2", {1}),
    "two_buckets": (dict(pad_multiple=32), "f0 wide f1 wide", set()),
}


@pytest.mark.parametrize("case", COPY_BACK_CASES)
def test_packed_copy_back_equals_vmap_and_detect(corpus, case):
    """The packed flush copies back only the live prefix of its final
    survivor list, whose length the host takes from the plan and the
    flush's counts: past it every lane is dead, and the rects equal the
    reference's, the vmap strategy's and ``detect``'s, image by image."""
    kw, names, empty = COPY_BACK_CASES[case]
    wide = render_scene(np.random.default_rng(30), 70, 90, n_faces=1)[0]
    pick = {"f0": corpus[0], "f1": corpus[1], "f2": corpus[2],
            "blank": _BLANK, "wide": wide}
    imgs = [pick[k] for k in names.split()]
    d = _port(use_pallas=True, tail_backend="pallas", **kw)
    ref = RDetector(RCASC, RConfig(**{**KW, **kw}))
    packed = d.detect_batch(imgs, group=False)
    vmap = d.detect_batch(imgs, group=False, strategy="vmap")
    for i, im in enumerate(imgs):
        single = d.detect(im, group=False)
        assert np.array_equal(packed[i], ref.detect(im, group=False)), i
        assert np.array_equal(packed[i], single), i
        assert np.array_equal(vmap[i], single), i
        assert (len(single) == 0) == (i in empty), i
    buckets: dict = {}
    for im in imgs:
        buckets.setdefault(d._bucket_hw(*im.shape), []).append(im)
    assert len(buckets) == (2 if case == "two_buckets" else 1)
    for (hp, wp), group in buckets.items():
        plan = d.batch_plan(hp, wp, len(group))
        stack, valid_hw = d._pack_stack(group, hp, wp)
        head_fn, tail_fn = d.batch_parts(hp, wp, len(group))
        parts = head_fn(*d._stack_to_device(stack, valid_hw))
        res = tail_fn(*parts)
        head_live = int(parts[0].sum())
        live = d._final_live(plan, res.alive_counts.numpy(), head_live)
        if len(plan.tail_segments) <= 1:   # one compaction, of alive_flat
            assert live == head_live
        assert (live == 0) == (case == "no_image_with_rects")
        assert 0 <= live <= res.valid.numel()
        assert not res.valid[live:].any()
        assert bool((res.img[live:] == -1).all())
        assert int(res.valid[:live].sum()) == int(res.alive_counts[-1].sum())


def test_main_path_launches_no_kernel_on_cpu(corpus):
    ops.reset_launches()
    _port(use_pallas=True, tail_backend="pallas").detect_batch(corpus)
    assert set(ops.launches().values()) == {0}


# ------------------------------------------------------------ compaction
@pytest.mark.parametrize("cap", [1, 5, 17, 40])
def test_nonzero_static_matches_numpy(cap):
    rng = np.random.default_rng(cap)
    mask = rng.random((3, 40)) < 0.3
    idx, count = nonzero_static(torch.from_numpy(mask), cap)
    for row, got, n in zip(mask, idx.numpy(), count.numpy()):
        want = np.flatnonzero(row)[:cap]
        assert n == row.sum()
        assert np.array_equal(got[:len(want)], want)
        assert (got[len(want):] == -1).all()


# -------------------------------------------------------------- contracts
def test_overflow_raises():
    casc = tcascade.from_numpy({f: np.asarray(getattr(all_pass_cascade(), f))
                                for f in tcascade.FIELDS})
    img = np.zeros((96, 96), np.float32)
    kw = dict(mode="wave", step=1, scale_factor=2.0)
    d = Detector(casc, EngineConfig(capacity_fracs=(0.01,), **kw),
                 device="cpu")
    with pytest.raises(RuntimeError, match="overflow"):
        d.detect(img)
    with pytest.raises(RuntimeError, match=r"image\(s\) \[0, 1\]"):
        d.detect_batch([img] * 2, strategy="vmap")
    d = Detector(casc, EngineConfig(batch_capacity_fracs=(0.01,), **kw),
                 device="cpu")
    with pytest.raises(RuntimeError, match="shared capacity overflow"):
        d.detect_batch([img] * 2, strategy="packed")


def test_programs_built_once_per_plan(corpus):
    d = _port(use_pallas=True, tail_backend="pallas")
    d.detect_batch(corpus)
    d.detect(corpus[0])
    builds = d.program_builds
    d.detect_batch(corpus)
    d.detect(corpus[1])
    assert d.program_builds == builds > 0


def test_sub_window_images_yield_empty():
    d = _port(use_pallas=True)
    tiny = np.zeros((10, 10), np.float32)
    assert d.detect(tiny).shape == (0, 4)
    for strategy in ("packed", "vmap"):
        (out,) = d.detect_batch([tiny], strategy=strategy)
        assert out.shape == (0, 4)
    assert d.detect_batch([]) == []


def test_config_errors_match_reference():
    with pytest.raises(ValueError, match="tail_backend"):
        # repro: ignore[TAIL_BACKEND] deliberately invalid backend: this test pins the validation error
        Detector(TCASC, EngineConfig(tail_backend="simd"), device="cpu")  # repro_torch: ignore[TAIL_BACKEND] pins the validation error
    with pytest.raises(ValueError, match="strategy"):
        _port().detect_batch([np.zeros((30, 30), np.float32)],
                             strategy="scan")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Detector(TCASC)
    assert resolve_device("cpu").type == "cpu"


# ------------------------------------------------------------ chip_smoke
def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_card_or_checkout(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the smoke run would proceed")
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    for cwd in (REPO, tmp_path):
        out = _run_smoke(cwd)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
