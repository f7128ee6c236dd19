"""Multi-host launcher (port of the JAX package's
`scripts/launch_multihost.py`).

    python -m flash_attention_tpu_torch.scripts.launch_multihost \\
        [--device cuda|cpu] -- prog.py args...

1. Without `--simulate`: run the SAME command on every host (slurm,
   mpirun, a pod scheduler, ...) with the rendezvous in the environment
   (FA_TPU_COORDINATOR / FA_TPU_NUM_PROCESSES / FA_TPU_PROCESS_ID, or
   torchrun's MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK). The
   launcher joins the world once (`initialize_distributed()`), so a host
   that cannot reach its peers fails here, leaves it, and execs the
   command, which joins again with the same contract.

2. `--simulate N`: spawn N local processes, one rank each, joined
   through a file store in a fresh file under `--rendezvous-dir` (a new
   temporary directory by default), so simultaneous launches on one
   host never share a rendezvous. On `--device cpu` they form a gloo
   world; on `--device cuda` each rank takes card LOCAL_RANK modulo the
   visible cards. If one rank fails, the others are stopped; the exit
   code is the first failure's (124 when `--timeout` runs out).

The launched program calls `flash_attention_tpu_torch.parallel.mesh.
initialize_distributed(device=...)`; the launcher passes the rendezvous
through FA_TPU_COORDINATOR / FA_TPU_NUM_PROCESSES / FA_TPU_PROCESS_ID /
LOCAL_RANK and the device through FA_TPU_DEVICE.

`--devices-per-proc` is accepted only as 1: in `torch.distributed` one
rank drives one device (the JAX launcher gives each process several
virtual CPU devices instead); run more ranks for more devices.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time
import uuid


def _command(cmd: list[str]) -> list[str]:
    """The command as this interpreter runs it (a leading `python` is
    this interpreter)."""
    if cmd and os.path.basename(cmd[0]) in ("python", "python3"):
        cmd = cmd[1:]
    return [sys.executable, *cmd]


def _wait_all(procs, timeout_s: float | None) -> int:
    """Wait for every process; when one fails (or the time runs out),
    stop the rest. Returns 0, the first failure's code, or 124."""
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    rc = 0
    while None in [p.poll() for p in procs]:
        failed = [p.returncode for p in procs
                  if p.returncode not in (None, 0)]
        late = deadline is not None and time.monotonic() > deadline
        if failed or late:
            rc = failed[0] if failed else 124
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            return rc
        time.sleep(0.05)
    for p in procs:
        if p.returncode:
            return p.returncode
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m flash_attention_tpu_torch.scripts.launch_multihost")
    ap.add_argument("--simulate", type=int, default=0, metavar="N",
                    help="spawn N local ranks instead of relying on a "
                         "cluster's scheduler")
    ap.add_argument("--devices-per-proc", type=int, default=1,
                    help="must be 1: one rank drives one device")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the ranks' device (cpu: a gloo world); passed "
                         "to the program as FA_TPU_DEVICE")
    ap.add_argument("--rendezvous-dir", default=None,
                    help="directory for the simulated ranks' file store "
                         "(default: a new temporary directory)")
    ap.add_argument("--timeout", type=float, default=None,
                    help="seconds before the simulated ranks are stopped")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="-- prog.py args...")
    args = ap.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no command given (use: launch_multihost -- prog.py ...)")
    if args.devices_per_proc != 1:
        ap.error("--devices-per-proc must be 1: in torch.distributed one "
                 "rank drives one device; launch more ranks instead")
    os.environ["FA_TPU_DEVICE"] = args.device

    if not args.simulate:
        import torch.distributed as dist

        from flash_attention_tpu_torch.parallel.mesh import (
            initialize_distributed,
        )

        initialize_distributed(device=args.device)
        if dist.is_initialized():
            dist.barrier()
            dist.destroy_process_group()
        cmd = _command(cmd)
        os.execv(cmd[0], cmd)

    own_dir = args.rendezvous_dir is None
    rdzv = (tempfile.mkdtemp(prefix="fa_rendezvous_") if own_dir
            else args.rendezvous_dir)
    os.makedirs(rdzv, exist_ok=True)
    store = os.path.join(os.path.abspath(rdzv), f"store-{uuid.uuid4().hex}")
    procs = []
    try:
        for rank in range(args.simulate):
            env = dict(os.environ,
                       FA_TPU_COORDINATOR=f"file://{store}",
                       FA_TPU_NUM_PROCESSES=str(args.simulate),
                       FA_TPU_PROCESS_ID=str(rank),
                       LOCAL_RANK=str(rank),
                       FA_TPU_DEVICE=args.device)
            procs.append(subprocess.Popen(_command(cmd), env=env))
        return _wait_all(procs, args.timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if own_dir:
            shutil.rmtree(rdzv, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
