"""The benchmark of the PyTorch / CUDA port (``repro_torch``): batched
face detection through ``Detector.detect_batch`` on one card.  The entry
is ``cascade_bench/run.py``; ``BENCHMARK.json`` at the checkout's root
names the cells."""
