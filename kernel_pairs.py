#!/usr/bin/env python3
"""Time kernels of two checkouts of the port in turns on one GPU.

    python3 kernel_pairs.py --parent DIR [--checks paged,decode]
    python3 kernel_pairs.py --parent DIR --checks fa1_tiles,fp32_bwd

Runs the named kernel checks of chip_smoke.py (check_<name>: build,
hold each kernel against its plain version, time it with CUDA events)
with the port imported from DIR (for example an unpacked parent commit)
and from this checkout, in 10 pairs of turns (parent, change, change,
parent, ...: each side runs first in half of them), each turn a process
of its own, and prints one line per turn:

    PAIR parent {"package": "...", "ms": {"paged": 0.074, ...}}

A check that times several kernels under one key (check_bwd_branches:
B2 and B3 per case) gives one "ms" entry per kernel, "<key>.<kernel>";
one that times a list of shapes (check_quant_matmul, check_grouped) one
per shape, "<key>.<shape>"; a row that also has the kernel's device
time alone and the wrapper's host time a call (the B4 / B5 checks) adds
"<key>.device_ms" and "<key>.host_us".

Both versions run on the same card in one call, so their times compare.
The run ends with the summary (`summarize`): per key the parent's and
the change's median and in how many pairs (the i-th parent turn beside
the i-th change turn) the change was faster.

    python3 kernel_pairs.py --summarize LOG

prints that summary again from a saved run's PAIR lines.
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
    """{check key: ms} of a results dict (entries that hold no time, such
    as check_fp32_bwd's gate errors, are left out). An entry without its
    own "ms"
    holds one entry per kernel (check_bwd_branches' {"dq": {...}, "dkv":
    {...}}): each is keyed "<key>.<part>", e.g. "('bwd', 'window').dq". A
    list of rows (check_quant_matmul, check_grouped: one row per timed
    shape) is keyed "<key>.<shape>", e.g. "B7 int4.x(16,14336)
    w(14336,4096)"."""
    out = {}
    for key, v in results.items():
        if isinstance(v, list):
            # Rows of timed shapes; a list of gate errors holds no time.
            out.update({f"{key}.{row['shape']}": row["ms"] for row in v
                        if isinstance(row, dict)})
        elif not isinstance(v, dict):
            continue
        elif "ms" in v:
            out[str(key)] = v["ms"]
            # A row that also measured the kernel alone and the wrapper's
            # host time a call (chip_smoke.host_row).
            for extra in ("device_ms", "host_us"):
                if extra in v:
                    out[f"{key}.{extra}"] = v[extra]
        else:
            out.update({f"{key}.{part}": sub["ms"] for part, sub in v.items()})
    return out


def summarize(lines) -> list[str]:
    """One line per key of the PAIR lines: parent median, change median,
    change / parent, and the pairs (i-th parent turn, i-th change turn)
    in which the change was faster."""
    import statistics

    turns = {"parent": [], "change": []}
    for line in lines:
        if line.startswith("PAIR "):
            _, which, payload = line.split(" ", 2)
            turns[which].append(json.loads(payload)["ms"])
    n = min(len(turns["parent"]), len(turns["change"]))
    out = []
    for key in turns["change"][0] if n else ():
        par = [t[key] for t in turns["parent"][:n] if key in t]
        chg = [t[key] for t in turns["change"][:n]]
        if len(par) != n:
            continue
        mp, mc = statistics.median(par), statistics.median(chg)
        wins = sum(c < p for p, c in zip(par, chg))
        out.append(f"{key}: parent {mp:.4f} change {mc:.4f} ms "
                   f"({mc / mp:.3f}x), change faster in {wins}/{n}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="root of the other checkout")
    ap.add_argument("--checks", default="paged,decode")
    ap.add_argument("--package-root", help=argparse.SUPPRESS)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--summarize", metavar="LOG",
                    help="print the summary of a saved run and exit")
    args = ap.parse_args()
    if args.summarize:
        with open(args.summarize) as f:
            print("\n".join(summarize(f.read().splitlines())))
        return 0
    if args.one:
        one_turn(args.checks, args.package_root)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    order = ["parent", "change", "change", "parent"]
    lines = []
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
        lines.append(f"PAIR {which} {out.stdout.strip().splitlines()[-1]}")
        print(lines[-1], flush=True)
    print("\n".join(summarize(lines)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
