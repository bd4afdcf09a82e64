"""The ported examples (``examples/*_torch.py``) against the reference's.

Each pair runs as subprocesses at the same arguments: the reference under
``JAX_PLATFORMS=cpu``, the port with ``--device cpu``.  All twelve start
at once (module fixture) and each case waits for its pair.  The printed lines
must be equal once the host-clock times, the checkpoint path and the
straggler lines (both from the host's clock) are masked.  ``train_lm``'s
losses are masked too: the port draws its parameters from
``torch.Generator`` and the reference from ``jax.random``, so the two runs
train different models; its model line, the steps it logs, the crash,
the checkpoint and the resumed step must be equal, and each example
asserts that its loss fell.  ``serve_lm``'s sampled tokens are masked for
the same reason, and its tok/s (host clock); its lines, configs, prompt
and generation lengths must be equal.  The ported examples also check
their counts against oracles of their own.
"""

import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
TIMEOUT_S = 300
# twelve processes at once: one thread each keeps them from oversubscribing
# the cores (and the other test workers')
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
              "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1"}

# example -> arguments both sides take (analytics at the small scale; the
# training run long enough to checkpoint at step 50 before its crash)
CASES = {
    "quickstart": [],
    "analytics_3way": ["--users", "200", "--friends", "10"],
    "nway_star": [],
    "streaming_counts": [],
    "train_lm": ["--steps", "110", "--d-model", "64", "--layers", "2",
                 "--vocab", "256", "--batch", "4", "--seq", "32"],
    "serve_lm": [],
}

_MASKS = [
    (re.compile(r"\d+\.\d+ ms"), "<ms>"),                 # plan / delta ms
    (re.compile(r"'\d+\.\d+'"), "'<ms>'"),                # execute_many
    (re.compile(r"in \d+\.\d+s"), "in <s>"),              # analytics
    (re.compile(r"dt \d+\.\d+s"), "dt <s>"),              # train steps
    (re.compile(r"\(ckpts in [^)]*\)"), "(ckpts)"),
    # the one kernel quickstart runs: interpret-mode Pallas in the
    # reference, pair_count.cu or its plain version in the port
    (re.compile(r"^(Pallas )?bucket_pair_count \([^)]*\): "),
     "bucket_pair_count: "),
]
_SAMPLES = [(re.compile(r" +\d+\.\d+ tok/s   sample: \[[\d, ]*\]$"),
             " <x> tok/s   sample: <tokens>")]
_LOSSES = [(re.compile(r"loss \d+\.\d+ -> \d+\.\d+"), "loss <x> -> <x>"),
           (re.compile(r"(loss|gnorm) \d+\.\d+"), r"\1 <x>")]


def _normalized(text, name):
    lines = []
    for line in text.splitlines():
        if line.startswith("[ft] straggler"):
            continue
        extra = {"train_lm": _LOSSES, "serve_lm": _SAMPLES}.get(name, [])
        for pattern, repl in _MASKS + extra:
            line = pattern.sub(repl, line)
        lines.append(line)
    return lines


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    procs = {}
    for name, args in CASES.items():
        for side, script, extra, env in [
                ("reference", f"{name}.py", [],
                 {"JAX_PLATFORMS": "cpu"}),
                ("port", f"{name}_torch.py", ["--device", "cpu"], {})]:
            out = tmp_path_factory.mktemp(f"{name}_{side}")
            ckpt = ["--ckpt-dir", str(out / "ckpt")] if name == "train_lm" \
                else []
            procs[name, side] = subprocess.Popen(
                [sys.executable, str(EXAMPLES / script), *args, *ckpt,
                 *extra],
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True,
                env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                     **ONE_THREAD, **env})
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def _finish(proc):
    out, err = proc.communicate(timeout=TIMEOUT_S)
    assert proc.returncode == 0, err[-4000:]
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_ported_example_prints_the_reference_counts(runs, name):
    want = _normalized(_finish(runs[name, "reference"]), name)
    got = _normalized(_finish(runs[name, "port"]), name)
    assert got == want
    assert len(got) >= 5


def test_every_reference_example_is_ported():
    ported = {p.name[:-len("_torch.py")]
              for p in EXAMPLES.glob("*_torch.py")}
    reference = {p.stem for p in EXAMPLES.glob("*.py")} - {
        p.stem for p in EXAMPLES.glob("*_torch.py")}
    assert reference == ported == set(CASES)
