#!/usr/bin/env python3
"""Time kernels of two checkouts of the port in turns on one GPU.

    python3 kernel_pairs.py --parent DIR [--checks paged,decode]

Runs the named kernel checks of chip_smoke.py (check_<name>: build,
hold each kernel against its plain version, time it with CUDA events)
with the port imported from DIR (for example an unpacked parent commit)
and from this checkout, in 10 pairs of turns (parent, change, change,
parent, ...: each side runs first in half of them), each turn a process
of its own, and prints one line per turn:

    PAIR parent {"package": "...", "ms": {"paged": 0.074, ...}}

A check that times several kernels under one key (check_bwd_branches:
B2 and B3 per case) gives one "ms" entry per kernel, "<key>.<kernel>".

Both versions run on the same card in one call, so their times compare.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
PAIRS = 10


def one_turn(checks: str, package_root: str | None) -> None:
    """Build the kernels of the package under `package_root` (this
    checkout when None), run the checks, print one JSON line."""
    import numpy as np

    import chip_smoke    # this checkout's checks, whichever package they time

    if package_root:
        sys.path.insert(0, package_root)
    from flash_attention_tpu_torch.ops import _cuda

    _cuda.build()
    flush = chip_smoke.L2Flush()
    results: dict = {}
    for name in checks.split(","):
        getattr(chip_smoke, f"check_{name}")(
            np.random.default_rng(chip_smoke.SEED), flush, results)
    print(json.dumps({"package": _cuda.CSRC.parent.as_posix(),
                      "ms": flat_ms(results)}), flush=True)


def flat_ms(results: dict) -> dict:
    """{check key: ms} of a results dict. An entry without its own "ms"
    holds one entry per kernel (check_bwd_branches' {"dq": {...}, "dkv":
    {...}}): each is keyed "<key>.<part>", e.g. "('bwd', 'window').dq"."""
    out = {}
    for key, v in results.items():
        if "ms" in v:
            out[str(key)] = v["ms"]
        else:
            out.update({f"{key}.{part}": sub["ms"] for part, sub in v.items()})
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="root of the other checkout")
    ap.add_argument("--checks", default="paged,decode")
    ap.add_argument("--package-root", help=argparse.SUPPRESS)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one_turn(args.checks, args.package_root)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    order = ["parent", "change", "change", "parent"]
    for i in range(2 * PAIRS):
        which = order[i % 4]
        cmd = [sys.executable, str(HERE / "kernel_pairs.py"), "--one",
               "--checks", args.checks]
        if which == "parent":
            cmd += ["--package-root", str(pathlib.Path(args.parent).resolve())]
        out = subprocess.run(cmd, capture_output=True, text=True, cwd=HERE,
                             timeout=900)
        if out.returncode:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        print(f"PAIR {which} {out.stdout.strip().splitlines()[-1]}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
