"""The PyTorch port's examples (``examples/torch_*.py``) run on the CPU.

Each example is the reference example of the same name ported to
``repro_torch``'s API, with the reference's flags plus ``--device``
(default ``cuda``).  Each runs here as a subprocess at the smallest
sizes its own flags allow, with ``--device cpu``, and must exit 0 and
print the reference example's report lines; all of them start together
in a module fixture, and without ``--device`` each must refuse (no
card here).  ``torch_quickstart.py`` has no size flag (neither has the
reference's), so here it only parses its flags; ``chip_smoke.py`` runs
it whole on the card.

The four examples with size flags run in one subprocess each after the
reference example on the same flags (``_PAIR``): the parameters the
reference's models draw are recorded and carried across to the port's
(``_bridge.params_from_numpy``), in the order they are drawn, and the
counted fields of the two report lines must agree exactly: requests,
tokens, decode steps, occupancy, routed projections, live tiles,
sparsity and crossbars.  Accuracies, losses, times and sampled token
ids are not compared (each package sums float32 in its own order).
"""
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "2"}

# argv: example name, the reference's flags and the port's (JSON lists).
# Runs examples/<name>.py with every init_params of the reference's
# models recorded, then examples/torch_<name>.py with the port's
# init_params handing the recorded trees back in order; a marker line
# splits the two outputs
_PAIR = r"""
import json, runpy, sys
import jax
import numpy as np
from repro.models import cnn as rcnn, encdec as rencdec, transformer as rtfm
from repro_torch import _bridge
from repro_torch.models import cnn as tcnn, encdec as tencdec
from repro_torch.models import transformer as ttfm

name, ref_args, port_args = sys.argv[1], *map(json.loads, sys.argv[2:])
drawn = []

def recording(real):
    def init_params(*a, **kw):
        out = real(*a, **kw)
        drawn.append(jax.tree.map(np.asarray, out))
        return out
    return init_params

def carried(gen, cfg, *a, device="cuda", **kw):
    return _bridge.params_from_numpy(drawn.pop(0), device=device)

for mod in (rcnn, rencdec, rtfm):
    mod.init_params = recording(mod.init_params)
sys.argv = [f"examples/{name}.py", *ref_args]
runpy.run_path(sys.argv[0], run_name="__main__")
print(MARK, flush=True)
for mod in (tcnn, tencdec, ttfm):
    mod.init_params = carried
sys.argv = [f"examples/torch_{name}.py", *port_args]
runpy.run_path(sys.argv[0], run_name="__main__")
assert not drawn, f"{len(drawn)} recorded parameter trees left unused"
"""
MARK = "==== the port's example on the reference's parameters ===="

# {test key: (example, flags)}: every run starts at once in a module
# fixture, so the subprocesses overlap, and each test reads its own.
# A flag "{tmp}/x" names a directory of the run's own ({tmp}/ref/x for
# the reference in a pair run)
RUNS = {
    "quickstart_help": ("quickstart", "--help"),
    **{f"{name}_default": (name,) for name in (
        "quickstart", "prune_cnn_lottery", "train_lm_pruned", "serve_pruned",
        "serve_control_plane")},
}
# {example: its flags}: each runs after the reference example (_PAIR)
PAIRS = {
    "serve_pruned": ("--requests", "3", "--max-new", "3"),
    "serve_control_plane": ("--max-new", "2"),
    "prune_cnn_lottery": ("--steps", "1", "--recipe", "paper", "--ticket-dir",
                          "{tmp}/t"),
    "train_lm_pruned": ("--steps", "2", "--prune-steps", "1", "--batch", "1",
                        "--seq", "8", "--ckpt", "{tmp}/ck"),
}


def _start(argv):
    return subprocess.Popen(argv, cwd=ROOT, env=ENV, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{key: (tmp dir, Popen)} of every entry of ``RUNS`` and ``PAIRS``,
    started now."""
    out = {}
    for key, (name, *args) in RUNS.items():
        tmp = tmp_path_factory.mktemp(key)
        out[key] = (tmp, _start(
            [sys.executable, f"examples/torch_{name}.py",
             *(a.format(tmp=tmp) for a in args)]))
    for name, args in PAIRS.items():
        tmp = tmp_path_factory.mktemp(name)
        (tmp / "ref").mkdir()
        ref = [a.format(tmp=tmp / "ref") for a in args]
        port = [a.format(tmp=tmp) for a in args] + ["--device", "cpu"]
        out[name] = (tmp, _start(
            [sys.executable, "-c", f"MARK = {MARK!r}\n" + _PAIR, name,
             json.dumps(ref), json.dumps(port)]))
    yield out
    for _, proc in out.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _result(runs, key):
    """(tmp dir, return code, stdout, stderr) of one run, once it ends."""
    tmp, proc = runs[key]
    stdout, stderr = proc.communicate(timeout=300)
    return tmp, proc.returncode, stdout, stderr


def _ok(runs, key):
    """(tmp dir, the port's output) of a run that exited 0."""
    tmp, rc, out, err = _result(runs, key)
    assert rc == 0, err[-3000:]
    return tmp, out.split(MARK + "\n")[-1]


def _pair(runs, name):
    """(the reference example's output, the port's) of a pair run."""
    _, rc, out, err = _result(runs, name)
    assert rc == 0, err[-3000:]
    ref, sep, port = out.partition(MARK + "\n")
    assert sep, out[-3000:]
    return ref, port


def test_serve_pruned_on_cpu(runs):
    _, out = _ok(runs, "serve_pruned")
    assert "serving yi-6b-smoke at" in out
    assert "served 3 requests (greedy) |" in out
    assert "bsmm decode: " in out


def test_serve_control_plane_on_cpu(runs):
    _, out = _ok(runs, "serve_control_plane")
    assert "in-flight outputs bit-identical to no-swap oracle: True" in out
    assert "zero-drain hot-swap demo OK" in out


def test_prune_cnn_lottery_on_cpu(runs):
    tmp, out = _ok(runs, "prune_cnn_lottery")
    assert "== ReaLPrune lottery pipeline: resnet18-smoke ==" in out
    assert "recipe: paper (" in out
    assert f"ticket exported to {tmp / 't'} and re-imported" in out
    assert "baseline acc " in out and "hardware: cell savings" in out


def test_train_lm_pruned_on_cpu(runs):
    tmp, out = _ok(runs, "train_lm_pruned")
    assert "== xlstm-125m-smoke:" in out and "2 steps @ B=1 S=8 ==" in out
    assert "dense phase done: loss " in out
    assert "tile-pruned to sparsity " in out
    assert "pruned fine-tune: loss " in out and "crossbars: " in out
    assert (tmp / "ck").is_dir()


def test_quickstart_parses_its_flags(runs):
    _, out = _ok(runs, "quickstart_help")
    assert "--device" in out


@pytest.mark.parametrize("name", ["quickstart", "prune_cnn_lottery",
                                  "train_lm_pruned", "serve_pruned",
                                  "serve_control_plane"])
def test_example_defaults_to_cuda_and_raises_without_a_card(name, runs):
    _, rc, _, err = _result(runs, f"{name}_default")
    assert rc != 0
    assert "CUDA is not available" in err


# {example: the patterns of its counted report fields}: each must match
# in both outputs, with the same groups
COUNTED = {
    "serve_pruned": (
        r"serving (\S+) at ([\d.]+)% sparsity",
        r"served (\d+) requests \((\w+)\) \| (\d+) tokens in (\d+) decode "
        r"steps \| occupancy (\d+)%",
        r"bsmm decode: (\d+) projections routed, (\d+)/(\d+) tiles live "
        r"\((\d+)% skipped\)"),
    "serve_control_plane": (
        r"swap\(b\): accepted=(\w+) gen=(\d+) skipped tiles (\d+)% -> "
        r"(\d+)%",
        r"in-flight outputs bit-identical to no-swap oracle: (\w+)",
        r"probe request served on generation (\d+) ",
        r"report: (\d+) requests \| .* \| deadline misses (\d+) \| swaps "
        r"(\d+)"),
    "prune_cnn_lottery": (
        r"== ReaLPrune lottery pipeline: (\S+) ==",
        r"recipe: (.+)",
        r"winning-ticket sparsity: ([\d.]+)(.*)",
        r"\(sparsity ([\d.]+)%\)",
        r"hardware: cell savings ([\d.]+)%, crossbars (\d+)/(\d+) "
        r"\(-([\d.]+)%\)"),
    "train_lm_pruned": (
        r"== (\S+): ([\d.]+)M params, (\d+) steps @ B=(\d+) S=(\d+) ==",
        r"tile-pruned to sparsity ([\d.]+)% \((.+)\)",
        r"crossbars: (\d+)/(\d+) \(-([\d.]+)%\); cell savings ([\d.]+)%"),
}


@pytest.mark.parametrize("name", sorted(COUNTED))
def test_example_counts_match_the_reference_example(name, runs):
    ref, port = _pair(runs, name)
    for pattern in COUNTED[name]:
        want, got = re.search(pattern, ref), re.search(pattern, port)
        assert want and got, (pattern, ref[-2000:], port[-2000:])
        assert got.groups() == want.groups(), pattern
