"""The port's foundations against the reference, on the CPU: cascade arrays,
pyramid indices, integral images, the feature oracle, grouping, the scene
renderer, and import hygiene (the port never imports jax or repro)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core import cascade as rcascade  # noqa: E402
from repro.core import features as rfeatures  # noqa: E402
from repro.core import integral as rintegral  # noqa: E402
from repro.core import nms as rnms  # noqa: E402
from repro.core import pyramid as rpyramid  # noqa: E402
from repro.core.training import data as rdata  # noqa: E402
from repro.configs.viola_jones import DEFAULT_PRETRAINED  # noqa: E402

from repro_torch.core import cascade as tcascade  # noqa: E402
from repro_torch.core import features as tfeatures  # noqa: E402
from repro_torch.core import integral as tintegral  # noqa: E402
from repro_torch.core import nms as tnms  # noqa: E402
from repro_torch.core import pyramid as tpyramid  # noqa: E402
from repro_torch.core.training import data as tdata  # noqa: E402
from repro_torch.configs import viola_jones as tvj  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SMALL = [3, 4, 5, 6, 8]


def _fields(c):
    return {f: np.asarray(getattr(c, f)) for f in rcascade.Cascade._fields}


def _image(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w)
                                                ).astype(np.float32)


# ---------------------------------------------------------------- cascade
@pytest.mark.parametrize("sizes", [None, SMALL])
def test_paper_shaped_cascade_arrays_equal(sizes):
    want = _fields(rcascade.paper_shaped_cascade(0, stage_sizes=sizes))
    got = tcascade.paper_shaped_cascade(0, stage_sizes=sizes).numpy()
    for f in rcascade.Cascade._fields:
        assert got[f].dtype == want[f].dtype, f
        assert np.array_equal(got[f], want[f]), f


def test_paper_cascade_shape():
    c = tvj.paper_cascade(0)
    assert c.n_stages == 25 and c.n_weak == 2913
    assert list(c.stage_sizes()) == tcascade.PAPER_STAGE_SIZES


def test_from_numpy_and_pretrained_equal_reference():
    ref, meta = rcascade.load_cascade(DEFAULT_PRETRAINED)
    got, tmeta = tvj.pretrained()
    assert tmeta == meta
    assert got.numpy().keys() == _fields(ref).keys()
    for f, a in _fields(ref).items():
        assert np.array_equal(got.numpy()[f], a), f
        assert np.array_equal(
            tcascade.from_numpy(_fields(ref)).numpy()[f], a), f
    assert got.bounds == tuple(int(v) for v in np.asarray(ref.stage_offsets))


def test_pretrained_copy_is_the_reference_file():
    # the port reads its own copy of the trained cascade, byte for byte the
    # reference's, from inside its own package
    import hashlib
    port = Path(tvj.DEFAULT_PRETRAINED).resolve()
    assert port.parent == Path(tvj.PRETRAINED_DIR).resolve()
    assert port.is_relative_to(REPO / "src" / "repro_torch")
    digests = {hashlib.sha256(Path(f).read_bytes()).hexdigest()
               for f in (port, DEFAULT_PRETRAINED)}
    assert len(digests) == 1


def test_cascade_to_keeps_bounds_and_validates():
    c = tcascade.paper_shaped_cascade(1, stage_sizes=SMALL)
    assert c.to("cpu").bounds == c.bounds
    bad = c.numpy()
    bad["stage_offsets"] = bad["stage_offsets"][::-1].copy()
    with pytest.raises(ValueError):
        tcascade.from_numpy(bad)


# ---------------------------------------------------------------- pyramid
@pytest.mark.parametrize("hw,sf", [((64, 64), 1.2), ((70, 90), 1.3),
                                   ((480, 640), 1.2), ((23, 40), 1.2)])
def test_pyramid_plan_and_indices_equal(hw, sf):
    want = rpyramid.pyramid_plan(*hw, sf)
    got = tpyramid.pyramid_plan(*hw, sf)
    assert [tuple(lv) for lv in got] == [tuple(lv) for lv in want]
    for lv in got:
        for src, dst in ((hw[0], lv.height), (hw[1], lv.width)):
            assert np.array_equal(tpyramid.downscale_indices(src, dst),
                                  rpyramid.downscale_indices(src, dst))


def test_downscale_nearest_equal():
    img = _image(70, 90, 3)
    want = np.asarray(rpyramid.downscale_nearest(jnp.asarray(img), 41, 57))
    got = tpyramid.downscale_nearest(torch.from_numpy(img), 41, 57)
    assert np.array_equal(got.numpy(), want)
    stack = torch.from_numpy(np.stack([img, img[::-1].copy()]))
    assert np.array_equal(tpyramid.downscale_nearest(stack, 41, 57)[0].numpy(),
                          want)


# --------------------------------------------------------------- integral
@pytest.mark.parametrize("hw", [(48, 64), (160, 160)])
def test_integral_images_match_reference_to_tolerance(hw):
    img = _image(*hw, seed=hw[0])
    ii_r, pair_r = rintegral.integral_images(jnp.asarray(img))
    ii_t, pair_t = tintegral.integral_images(torch.from_numpy(img))
    # SAT bits differ from jnp.cumsum's once sums pass 2^24 (pinned order)
    np.testing.assert_allclose(ii_t.numpy(), np.asarray(ii_r), rtol=1e-6)
    np.testing.assert_allclose(pair_t.numpy(), np.asarray(pair_r),
                               rtol=1e-6, atol=1e-2)
    assert (ii_t[0] == 0).all() and (ii_t[:, 0] == 0).all()


def test_integral_image_pinned_order_is_float64_accumulation():
    img = _image(96, 80, 5)
    got = tintegral.integral_image(torch.from_numpy(img)).numpy()
    cols = np.cumsum(img.astype(np.float64), 0).astype(np.float32)
    want = np.cumsum(cols.astype(np.float64), 1).astype(np.float32)
    assert np.array_equal(got[1:, 1:], want)


def test_window_inv_sigma_matches_reference_to_tolerance():
    img = _image(64, 80, 9)
    _, pair_r = rintegral.integral_images(jnp.asarray(img))
    _, pair_t = tintegral.integral_images(torch.from_numpy(img))
    ys, xs = np.arange(41)[:, None], np.arange(57)[None, :]
    want = np.asarray(rintegral.window_inv_sigma(pair_r, jnp.asarray(ys),
                                                 jnp.asarray(xs), 24))
    got = tintegral.window_inv_sigma(pair_t, torch.from_numpy(ys),
                                     torch.from_numpy(xs), 24)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)
    # given the reference's own tables the arithmetic is bit-equal
    same = tintegral.window_inv_sigma(torch.from_numpy(np.array(pair_r)),
                                      torch.from_numpy(ys),
                                      torch.from_numpy(xs), 24)
    assert np.array_equal(same.numpy(), want)


# --------------------------------------------------------------- features
def test_stage_sum_windows_exact_given_reference_sat():
    casc_r = rcascade.paper_shaped_cascade(0, stage_sizes=SMALL)
    casc_t = tcascade.paper_shaped_cascade(0, stage_sizes=SMALL)
    img = _image(56, 72, 11)
    ii, pair = rintegral.integral_images(jnp.asarray(img))
    rng = np.random.default_rng(4)
    ys = rng.integers(0, 56 - 23, 300).astype(np.int32)
    xs = rng.integers(0, 72 - 23, 300).astype(np.int32)
    inv = np.asarray(rintegral.window_inv_sigma(pair, jnp.asarray(ys),
                                                jnp.asarray(xs), 24))
    ii_t = torch.from_numpy(np.asarray(ii))
    for s in range(len(SMALL)):
        k0, k1 = casc_t.bounds[s], casc_t.bounds[s + 1]
        want = np.asarray(rfeatures.stage_sum_windows(
            casc_r, ii, jnp.asarray(ys), jnp.asarray(xs), jnp.asarray(inv),
            k0, k1))
        got = tfeatures.stage_sum_windows(
            casc_t, ii_t, torch.from_numpy(ys).long(),
            torch.from_numpy(xs).long(), torch.from_numpy(inv), k0, k1)
        assert np.array_equal(got.numpy(), want), s


def test_run_cascade_windows_equal():
    casc_r = rcascade.paper_shaped_cascade(2, stage_sizes=SMALL)
    casc_t = tcascade.paper_shaped_cascade(2, stage_sizes=SMALL)
    img = _image(48, 48, 13)
    ii, pair = rintegral.integral_images(jnp.asarray(img))
    ys = np.repeat(np.arange(25), 25).astype(np.int32)
    xs = np.tile(np.arange(25), 25).astype(np.int32)
    acc_r, exit_r = rfeatures.run_cascade_windows(
        casc_r, ii, pair, jnp.asarray(ys), jnp.asarray(xs))
    acc_t, exit_t = tfeatures.run_cascade_windows(
        casc_t, torch.from_numpy(np.asarray(ii)),
        torch.from_numpy(np.asarray(pair)), torch.from_numpy(ys).long(),
        torch.from_numpy(xs).long())
    assert np.array_equal(acc_t.numpy(), np.asarray(acc_r))
    assert np.array_equal(exit_t.numpy(), np.asarray(exit_r))


# -------------------------------------------------------------------- nms
def _rects(seed, n=60):
    rng = np.random.default_rng(seed)
    xy = rng.integers(0, 80, (n, 2))
    wh = np.repeat(rng.integers(20, 40, (n, 1)), 2, axis=1)
    return np.concatenate([xy, wh], axis=1).astype(np.int32)


@pytest.mark.parametrize("min_neighbors", [0, 1, 3])
def test_group_rectangles_equal(min_neighbors):
    for seed in range(3):
        r = _rects(seed)
        assert np.array_equal(tnms.group_rectangles(r, min_neighbors),
                              rnms.group_rectangles(r, min_neighbors))
        b = np.random.default_rng(seed).integers(0, 3, len(r))
        for g, w in zip(tnms.group_rectangles_batch(r, b, 3, min_neighbors),
                        rnms.group_rectangles_batch(r, b, 3, min_neighbors)):
            assert np.array_equal(g, w)


def test_iou_matrix_equal():
    a, b = _rects(1, 20), _rects(2, 30)
    assert np.array_equal(tnms.iou_matrix(a, b), rnms.iou_matrix(a, b))


# -------------------------------------------------------------- scenes
def test_render_scene_equal():
    for seed in (0, 7):
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(3):
            img_r, box_r = rdata.render_scene(r1, 64, 80, n_faces=2)
            img_t, box_t = tdata.render_scene(r2, 64, 80, n_faces=2)
            assert np.array_equal(img_t, img_r)
            assert np.array_equal(box_t, box_r)


# ---------------------------------------------------------- import hygiene
def test_port_imports_no_jax():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.plan, "
            "repro_torch.kernels.ops, repro_torch.configs.viola_jones; "
            "assert 'jax' not in sys.modules, 'jax'; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'repro'")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_port_file_imports_jax_or_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        bad = _imported_roots(f) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{f.relative_to(REPO)} imports {bad}"
