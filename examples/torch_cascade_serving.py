"""Batched cascade-detection serving on the PyTorch port: request queue
-> shape buckets -> rate-weighted pod shards -> packed ``detect_batch``
-> per-request rects (``examples/cascade_serving.py`` through
``repro_torch``).

    PYTHONPATH=src python examples/torch_cascade_serving.py [--device cpu]

With no ``--device`` it runs on the card (``cuda``) and fails without
one.  It exits non-zero if a batched request's rects differ from the
same image's sequential ``detect``.
"""

import argparse
import sys

import numpy as np

from repro_torch.core import Detector, EngineConfig, paper_shaped_cascade
from repro_torch.core.training.data import render_scene
from repro_torch.device import resolve_device
from repro_torch.serve import DetectorService, PodSpec, ServiceConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the port's batched serving")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    device = resolve_device(ap.parse_args(argv).device)
    print(f"device: {device}")
    # trained-scale cascade; wave engine with serving-friendly buckets
    casc = paper_shaped_cascade(0, stage_sizes=[6, 10, 14, 20, 28,
                                                60, 60, 60, 60, 60])
    det = Detector(casc, EngineConfig(mode="wave", step=2, scale_factor=1.25,
                                      min_neighbors=2, pad_multiple=32),
                   device=device)

    rng = np.random.default_rng(0)
    shapes = [(96, 96)] * 6 + [(70, 90), (100, 60)]
    images = [render_scene(rng, h, w, n_faces=1)[0] for h, w in shapes]

    svc = DetectorService(det, ServiceConfig(
        pods=(PodSpec("big", 1.0), PodSpec("little", 0.4)), max_batch=8))
    svc.warmup(images[0])          # profile-guided capacities + pod rates
    print(f"calibrated capacity fracs: "
          f"{[round(f, 3) for f in svc.detector.config.capacity_fracs]}")

    results = svc.detect_many(images)
    all_same = True
    for i, (im, rects) in enumerate(zip(images, results)):
        same = np.array_equal(rects, svc.detector.detect(im))
        all_same &= same
        print(f"image {i} {im.shape}: {len(rects)} face(s), "
              f"batched==sequential: {same}")

    st = svc.stats()
    print(f"\nthroughput: {st.imgs_per_s:.1f} imgs/s, "
          f"latency p50/p95: {st.latency_ms_p50:.0f}/"
          f"{st.latency_ms_p95:.0f} ms")
    print("pod shares (rate-weighted):",
          {p.name: p.images for p in st.pods},
          f"imbalance {st.makespan_imbalance:.2f}x")
    return 0 if all_same else 1


if __name__ == "__main__":
    sys.exit(main())
