"""Start ranks as processes of this package, as `torchrun` would, and
collect what each returns: the dry run, the CPU tests and chip_smoke's
data-parallel phase run their ranks through `run_ranks`.

Each rank is `python -m saunet_tpu_torch.parallel.launch <target> <dir>
<device> <threads>` with torchrun's variables (RANK, WORLD_SIZE,
LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR=127.0.0.1, MASTER_PORT). It joins
the process group (`init_data_parallel`), calls `target(mesh, **kwargs)`
with the keyword arguments the parent saved in `<dir>/args.pt`, saves the
result to `<dir>/result<rank>.pt`, checks that it never imported jax, and
leaves the group. Its output goes to `<dir>/rank<rank>.log`.
"""
from __future__ import annotations

import importlib
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

import torch
import torch.distributed as dist

PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    """A TCP port on the loopback interface that was free just now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(path: str, lines: int = 40) -> str:
    try:
        with open(path, errors="replace") as f:
            return "".join(f.readlines()[-lines:])
    except OSError:
        return ""


def run_ranks(n: int, target: str, kwargs: Optional[dict] = None,
              device: Optional[str] = None, threads: Optional[int] = None,
              timeout: float = 600.0, workdir: Optional[str] = None
              ) -> List[object]:
    """Run `target` ('module:function', in this package) on `n` ranks of
    one node and return each rank's result, in rank order.

    device: 'cpu' (gloo), or None / 'cuda' (rank r on card r % cards;
    NCCL when each rank has a card, else gloo). threads: torch's intra-op
    threads in each rank (None: torch's default). Raises with the ranks'
    last output lines if a rank fails or the run outlasts `timeout`; no
    rank outlives the call."""
    module = target.split(":")[0]
    if not module.startswith("saunet_tpu_torch."):
        raise ValueError(f"{target}: ranks run functions of the package")
    own_dir = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="ranks-")
    torch.save(kwargs or {}, os.path.join(workdir, "args.pt"))
    env = dict(os.environ)
    env.update(WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (PACKAGE_ROOT, env.get("PYTHONPATH", "")) if p)
    procs, logs = [], []
    try:
        for rank in range(n):
            logs.append(open(os.path.join(workdir, f"rank{rank}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "saunet_tpu_torch.parallel.launch",
                 target, workdir, device or "", str(threads or 0)],
                env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)),
                stdout=logs[-1], stderr=subprocess.STDOUT,
                cwd=PACKAGE_ROOT))
        deadline = time.monotonic() + timeout
        timed_out = False
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    try:
        codes = [p.returncode for p in procs]
        if any(codes):
            tails = "\n".join(
                f"--- rank {r} (exit {c}) ---\n"
                + _tail(os.path.join(workdir, f"rank{r}.log"))
                for r, c in enumerate(codes))
            why = f"timed out after {timeout} s" if timed_out else "failed"
            raise RuntimeError(f"{target} on {n} rank(s) {why}:\n{tails}")
        return [torch.load(os.path.join(workdir, f"result{r}.pt"),
                           weights_only=False) for r in range(n)]
    finally:
        if own_dir:
            shutil.rmtree(workdir, ignore_errors=True)


def rank_log(workdir: str, rank: int = 0) -> str:
    """The output of `rank` in a `run_ranks` call that was given
    `workdir`."""
    with open(os.path.join(workdir, f"rank{rank}.log"), errors="replace") \
            as f:
        return f.read()


def _rank_main(argv: List[str]) -> int:
    from .mesh import barrier, init_data_parallel

    target, workdir, device, threads = argv
    if int(threads):
        torch.set_num_threads(int(threads))
    mesh = init_data_parallel(device or None)
    module, name = target.split(":")
    fn = getattr(importlib.import_module(module), name)
    # args.pt is written by run_ranks in this package's parent process
    kwargs = torch.load(os.path.join(workdir, "args.pt"), weights_only=False)
    result = fn(mesh, **kwargs)
    if "jax" in sys.modules:
        raise RuntimeError("a rank imported jax")
    tmp = os.path.join(workdir, f"result{mesh.rank}.pt.tmp")
    torch.save(result, tmp)
    os.replace(tmp, os.path.join(workdir, f"result{mesh.rank}.pt"))
    barrier(mesh)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1:]))
