"""Run every dry-run cell and print the peak table, beside an older run.

    PYTHONPATH=src python tools/dryrun_table.py [--out artifacts/dryrun_torch] \
        [--old DIR] [--jobs 4] [--only-table]

Each cell is one ``python -m repro_torch.launch.dryrun`` process (a fake
256- or 512-rank world of its own), ``--jobs`` of them at once: every
(architecture x shape) of ``configs.SHAPES`` on (16, 16), and train_4k
on (2, 16, 16) for the architectures the artifacts directory already
holds a pod2 cell of.  ``--old DIR`` holds an earlier run's artifacts
(e.g. the parent commit's ``artifacts/dryrun_torch``, unpacked with
``git archive``): each cell's row then gives the old peak beside the
new one, and the cells whose fit on one 80 GB card flips.
``--only-table`` prints the table of the artifacts as they are.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import configs  # noqa: E402

POD2 = ("qwen2-1.5b", "seamless-m4t-medium", "qwen3-moe-30b-a3b",
        "llama-3.2-vision-11b", "zamba2-1.2b", "mamba2-370m")


def cells():
    out = [(a, s, False) for a in configs.ARCH_IDS for s in configs.SHAPES]
    return out + [(a, "train_4k", True) for a in POD2]


def name(arch, shape, pod2):
    return f"{arch}__{shape}__{'pod2' if pod2 else 'pod1'}.json"


def run_one(out: pathlib.Path, arch, shape, pod2):
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape, "--out", str(out)]
    if pod2:
        cmd.append("--multi-pod")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    p = subprocess.run(cmd, env=env, capture_output=True, text=True)
    return arch, shape, pod2, p.returncode


def load(directory: pathlib.Path | None, arch, shape, pod2):
    if directory is None:
        return None
    path = directory / name(arch, shape, pod2)
    return json.loads(path.read_text()) if path.exists() else None


def entry(art) -> str:
    if art is None:
        return "not run"
    if not art.get("ok"):
        return "—"
    peak = art["per_device_peak_bytes_est"] / 1e9
    return f"{peak:.1f}{'' if art['fits_80gb'] else '✗'}"


def table(out: pathlib.Path, old: pathlib.Path | None) -> str:
    shapes = list(configs.SHAPES)
    head = shapes + ["train_4k, (2, 16, 16)"]
    rows = ["| arch | " + " | ".join(head) + " |",
            "|---|" + "---|" * len(head)]
    flips = []
    for arch in configs.ARCH_IDS:
        cols = []
        for shape, pod2 in [(s, False) for s in shapes] + [("train_4k",
                                                            True)]:
            new = load(out, arch, shape, pod2)
            was = load(old, arch, shape, pod2)
            cell = entry(new)
            if old is not None and was is not None and was.get("ok"):
                cell = f"{entry(was)} → {cell}"
                if new is not None and new.get("ok") and \
                        new["fits_80gb"] != was["fits_80gb"]:
                    flips.append(f"{arch} × {shape}"
                                 f"{' (2, 16, 16)' if pod2 else ''}: "
                                 f"{'fits' if new['fits_80gb'] else 'no fit'}")
            cols.append(cell)
        rows.append(f"| {arch} | " + " | ".join(cols) + " |")
    text = "\n".join(rows)
    if flips:
        text += "\n\nFits that flip: " + "; ".join(flips) + "."
    return text


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "artifacts" / "dryrun_torch"))
    ap.add_argument("--old", default=None)
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--only-table", action="store_true")
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if not args.only_table:
        todo = [c for c in cells()
                if configs.shape_applicable(configs.get(c[0]), c[1])]
        with ThreadPoolExecutor(args.jobs) as pool:
            for arch, shape, pod2, rc in pool.map(
                    lambda c: run_one(out, *c), todo):
                print(f"{arch} {shape} {'pod2' if pod2 else 'pod1'} "
                      f"rc={rc}", flush=True)
    print(table(out, pathlib.Path(args.old) if args.old else None))


if __name__ == "__main__":
    main()
