"""The port's examples (``examples/torch_*.py``, the repository's user
surfaces through ``repro_torch`` only) at their own sizes on the CPU
(``--device cpu``): each ``main`` returns 0 (or None), prints the device
it ran on, and its identity lines hold (every batched request's rects
equal its sequential ``detect``; every streamed frame's rects equal the
frame's ``detect``).  Each one's results equal its original's
(``examples/<name>.py`` on JAX, the five run at once in subprocesses):
every line it prints but the timed ones (throughput, latency, the pods'
rate-weighted shares), with the typography the originals print in
Unicode (arrows, dashes, the times sign) spelt in ASCII: ground truth
and detections, the cascade, the modelled schedules, the calibrated
capacities, each image's and frame's rect count and the stream's
statistics, the accuracy cells and the Table-I optimum.  The early-exit
example runs for that on the original's weights (JAX's seed-0
initialisation carried over with ``params_from_reference``; its own
seed-0 weights are drawn by torch's generator, not JAX's), its original
in this process, and every decode step's exit depths are held too.
Without ``--device`` the examples ask for the card and raise here."""

import contextlib
import importlib.util
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ORIGINAL_TIMEOUT = 900
EARLY_EXIT = "torch_early_exit_serving"
# the lines that carry times measured on the host
TIMED = ("throughput:", "pod shares (rate-weighted):", "p50 ")
ASCII = str.maketrans({"\u2192": "->", "\u2014": "-", "\u2013": "-",
                       "\u00d7": "x"})
# example -> (line every image or frame prints, how many)
IDENTITIES = {"torch_cascade_serving": ("batched==sequential: True", 8),
              "torch_video_stream": ("rects == detect: True", 10)}
# example -> a line it prints
PRINTS = {"torch_quickstart": "detections:",
          "torch_cascade_serving": "pod shares (rate-weighted):",
          "torch_video_stream": "frames done: 18",
          "torch_energy_tuned_detection": "Table-I optimum:",
          "torch_early_exit_serving": "exit depth (of 8 groups)"}


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", list(PRINTS))
def test_example_runs_on_the_cpu(name, capsys):
    rc = _load(name).main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert rc in (None, 0), text
    assert text.startswith("device: cpu\n")
    assert PRINTS[name] in text, text
    if name in IDENTITIES:
        line, n = IDENTITIES[name]
        assert text.count(line) == n, text


@pytest.fixture(scope="module")
def originals():
    """Each original example's standard output (JAX on the CPU)."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = {n: subprocess.Popen(
        [sys.executable, os.path.join(EXAMPLES, f"{n[len('torch_'):]}.py")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for n in PRINTS if n != EARLY_EXIT}
    out = {}
    try:
        for n, proc in procs.items():
            text, err = proc.communicate(timeout=ORIGINAL_TIMEOUT)
            assert proc.returncode == 0, err[-3000:]
            out[n] = text
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait()
    return out


def _results(text: str) -> list:
    """The lines of an example's output that carry its results."""
    lines = text.translate(ASCII).splitlines()
    return [ln.replace("  rects == detect: True", "") for ln in lines
            if not ln.startswith(("device: ",) + TIMED)]


def _run(mod, depths: list) -> str:
    """``mod.main`` (on the CPU where it takes ``--device``) with every
    exit depth its ``CascadeBatcher`` observes appended to ``depths``
    (per decode step, each row of the batch); returns what it printed."""
    class Recording(mod.CascadeBatcher):
        def observe(self, slot, depth):
            depths.append((slot, depth))
            return super().observe(slot, depth)

    mod.CascadeBatcher = Recording
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(["--device", "cpu"]) if mod.__name__.startswith(
            "torch_") else mod.main()
    assert rc in (None, 0)
    return buf.getvalue()


def _on_reference_weights(mod):
    """``mod``'s ``build_model`` with the original's weights: the JAX
    model's seed-0 initialisation of the same config."""
    import jax
    from repro.models import build_model as r_build
    from repro_torch.models import params_from_reference
    build = mod.build_model

    def on_them(cfg, device=None):
        model = build(cfg, device=device)
        ref = jax.tree.map(np.asarray, r_build(cfg).init(jax.random.key(0)))
        model.init = lambda _gen: params_from_reference(cfg, ref, device)
        return model
    return on_them


@pytest.mark.parametrize("name", list(PRINTS))
def test_example_gives_its_originals_results(name, originals):
    mod = _load(name)
    if name != EARLY_EXIT:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = mod.main(["--device", "cpu"])
        assert rc in (None, 0)
        got, want = _results(buf.getvalue()), _results(originals[name])
        assert len(want) > 3
        assert got == want
        return
    mod.build_model = _on_reference_weights(mod)
    depths, want_depths = [], []
    got = _results(_run(mod, depths))
    want = _results(_run(_load(EARLY_EXIT[len("torch_"):]), want_depths))
    assert got == want
    assert len(depths) == 16 * 8
    assert depths == want_depths


def test_examples_ask_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load("torch_quickstart").main([])
