"""End-to-end A/B of two trees on one card: ``chip_smoke.py``'s main paths
(``main_path``: the full-width cells in device mode, each with its checks)
from a parent tree and from this one, in turns, each run in a child process
of its own tree so that each builds and loads its own kernels.

    env PYTHONPATH=. python3 scripts/gpu_ab_paths.py --parent build/parent

(the parent a ``git archive`` unpacked under a git-ignored directory; the
order is parent, this, this, parent unless ``--order`` says otherwise;
``--paths`` keeps the main paths whose names hold one of its words, and
``--hybrid`` runs the hybrid flagship's two laws, ``hybrid_main``, too).
Prints each run's sim-s/wall-s lines with the card's name and power limit,
then a table of the rates by tree; exits nonzero if a run failed.  Needs a
card: there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

CHILD = (
    "import sys, tempfile; sys.path.insert(0, '.'); import chip_smoke as cs; "
    "cs.DATA = tempfile.mkdtemp(prefix='ab_'); "
    "cs.log('nvidia-smi: ' + cs.smi_line()); "
    "words = {paths!r}; "
    "cs.MAIN_PATHS = {{k: v for k, v in cs.MAIN_PATHS.items() "
    "if not words or any(w in k for w in words)}}; "
    "cs.main_path() if cs.MAIN_PATHS else None; "
    "{hybrid}"
    "sys.exit(1 if cs.FAILED else 0)"
)
HYBRID = "cs.native_build(); cs.hybrid_main(); "
RATE = re.compile(r"^(.*?): \{.*rounds \d+, ([0-9.]+) sim-s/wall-s")


def run(tree: Path, timeout: int, paths: list, hybrid: bool) -> dict:
    child = CHILD.format(paths=paths, hybrid=HYBRID if hybrid else "")
    proc = subprocess.run([sys.executable, "-c", child], cwd=tree,
                          capture_output=True, text=True, timeout=timeout)
    print(proc.stdout, flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], flush=True)
        raise SystemExit(f"{tree}: main paths failed ({proc.returncode})")
    return {m.group(1): float(m.group(2)) for m in map(
        RATE.match, proc.stdout.splitlines()) if m}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--order", default="PTTP",
                    help="P (parent) and T (this tree), in run order")
    ap.add_argument("--timeout", type=int, default=600)
    ap.add_argument("--paths", nargs="*", default=[],
                    help="keep the main paths whose names hold a word")
    ap.add_argument("--hybrid", action="store_true",
                    help="run the hybrid flagship's two laws too")
    args = ap.parse_args()
    trees = {"P": args.parent.resolve(), "T": Path.cwd()}
    rates = []
    for key in args.order:
        print(f"== main paths from {key}: {trees[key]}", flush=True)
        rates.append((key, run(trees[key], args.timeout, args.paths,
                               args.hybrid)))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"sim-s/wall-s by run ({args.order}; {smi}):")
    for path in rates[0][1]:
        print(f"  {path}: " + " / ".join(
            f"{key} {r.get(path, float('nan')):.3f}" for key, r in rates))
    return 0


if __name__ == "__main__":
    sys.exit(main())
