"""Streaming video detection on the PyTorch port: temporal tile reuse
over a CCTV-style synthetic stream, plus concurrent stream sessions
through the serving front-end (``examples/video_stream.py`` through
``repro_torch``).

    PYTHONPATH=src python examples/torch_video_stream.py [--device cpu]

With no ``--device`` it runs on the card (``cuda``) and fails without
one.  It exits non-zero if a streamed frame's rects differ from the
frame's own ``detect``.
"""

import argparse
import sys

import numpy as np

from repro_torch.configs.viola_jones import pretrained
from repro_torch.core import Detector, EngineConfig
from repro_torch.device import resolve_device
from repro_torch.serve import DetectorService, PodSpec, ServiceConfig
from repro_torch.stream import StreamConfig, VideoDetector, make_video


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the port's video streams")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    device = resolve_device(ap.parse_args(argv).device)
    print(f"device: {device}")
    casc, _ = pretrained(device=device)
    det = Detector(casc, EngineConfig(mode="wave", step=2,
                                      scale_factor=1.25, min_neighbors=2),
                   device=device)
    video = make_video("static_cctv", n_frames=10, h=160, w=160, seed=7)
    det = det.calibrated(video[0][0])

    print("== single stream (threshold 0: bit-identical to per-frame) ==")
    vd = VideoDetector(det, StreamConfig(tile=20, threshold=0.0,
                                         keyframe_interval=8))
    all_equal = True
    for frame, _gt in video:
        rects, st = vd.process(frame)
        equal = np.array_equal(rects, det.detect(frame))
        all_equal &= equal
        print(f"frame {st.frame_idx:2d} {st.mode:11s} "
              f"tiles {st.tiles_changed:3d}/{st.tiles_total}  "
              f"windows {st.windows_recomputed:5d}/{st.windows_total}  "
              f"level SATs {st.levels_active}/{st.levels_total}  "
              f"faces {len(rects)}  rects == detect: {equal}")

    print("\n== concurrent streams through DetectorService ==")
    svc = DetectorService(det, ServiceConfig(
        pods=(PodSpec("big", 1.0), PodSpec("little", 0.4)),
        stream_config=StreamConfig(tile=20, threshold=0.0,
                                   keyframe_interval=8)))
    videos = [make_video("static_cctv", n_frames=6, h=160, w=160, seed=s)
              for s in (0, 1, 2)]
    sessions = [svc.open_stream() for _ in videos]
    reqs = [(sess.submit_frame(vid[t][0]))
            for t in range(6) for sess, vid in zip(sessions, videos)]
    svc.flush()
    for r in reqs:
        r.result()
    st = svc.stats()
    print(f"frames done: {st.stream.frames_done}  "
          f"modes: {st.stream.frame_modes}  "
          f"window skip: {st.stream.window_skip_frac:.2f}  "
          f"level skip: {st.stream.level_skip_frac:.2f}")
    print(f"p50 {st.latency_ms_p50:.1f} ms  p95 {st.latency_ms_p95:.1f} "
          f"ms  pods: {[(p.name, p.images) for p in st.pods]}")
    return 0 if all_equal else 1


if __name__ == "__main__":
    sys.exit(main())
