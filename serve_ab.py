"""Phases 9-12 (DR-routed serving of gemma-2b at full width, the flash
checks, card against CPU, the fixed-length profile) of two trees in turns,
on one CUDA card: another commit's, unpacked under a git-ignored
directory, and this checkout's.

    mkdir -p build/serve_parent
    git archive <commit> | tar -x -C build/serve_parent
    python3 serve_ab.py build/serve_parent

Each turn is a process of its own that imports one tree's ``chip_smoke.py``
and package, builds that tree's kernels (under its own ``build/``) and runs
its ``serve_phases``; the order is other, this, this, other.  Every line a
turn prints is passed on behind its tag; at the end the phase 9 medians and
the phase 12 profile walls of each turn are printed again together.  Exits
non-zero when a turn fails.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
TURN = """
import sys
import torch
root = sys.argv[1]
sys.path[:0] = [root, root + "/src"]
import chip_smoke
from repro_torch.kernels import build
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build.library()
chip_smoke.serve_phases(torch.device("cuda"), chip_smoke.card_line())
"""
KEPT = ("phase 12: profile,", "phase 12: phase 9 medians")


def main(argv: list[str]) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"other": Path(argv[0]).resolve(), "this": REPO}
    if not (trees["other"] / "chip_smoke.py").is_file():
        print(f"serve_ab: no chip_smoke.py in {trees['other']}", file=sys.stderr)
        return 2
    kept, turns = [], {"other": 0, "this": 0}
    for name in ("other", "this", "this", "other"):
        turns[name] += 1
        tag = f"[{name} {turns[name]}]"
        proc = subprocess.run([sys.executable, "-c", TURN, str(trees[name])],
                              cwd=trees[name], capture_output=True, text=True)
        for line in proc.stdout.splitlines():
            print(tag, line, flush=True)
            if line.startswith(KEPT):
                kept.append(f"{tag} {line}")
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            print(f"serve_ab: turn {tag} failed with code {proc.returncode}", file=sys.stderr)
            return 1
    print("\n".join(kept))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
