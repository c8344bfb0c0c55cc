"""Run a function on the ranks of a ``torch.distributed`` group, one
process a rank.

:func:`run` starts ``world`` Python processes.  Each initialises the
default process group (``gloo`` over a ``file://`` store in a fresh
temporary directory, with a timeout), calls ``module:function(rank,
world, *args)`` with one torch thread, destroys the group and exits.
:func:`run` waits for all of them at most ``timeout`` seconds: a rank that
fails ends the others at once (a peer blocked in a collective would
otherwise wait out the group's timeout), and a run past the limit is
killed; either raises with the tail of every rank's output.  The ranks
find this package through ``PYTHONPATH``; ``path`` adds directories
(the target's module).

Nothing is written outside the temporary directory, which is removed.
"""

from __future__ import annotations

import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path
from typing import List, Sequence

__all__ = ["run", "init"]

_SRC = str(Path(__file__).resolve().parents[2])


def init(rank: int, world: int, store: str, backend: str = "gloo",
         timeout: float = 60.0) -> None:
    """Initialise the default process group over the file store
    ``store``."""
    import torch.distributed as dist

    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout))


def _tail(path: str, n: int = 3000) -> str:
    with open(path, errors="replace") as f:
        return f.read()[-n:]


def run(target: str, world: int, *, args: Sequence = (),
        timeout: float = 120.0,
        path: Sequence[str] = ()) -> List[str]:
    """Call ``target`` (``"module:function"``) on ``world`` ranks;
    ``args`` must be JSON-serialisable.  Returns each rank's standard
    output."""
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_SRC, *map(str, path)]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    procs, logs = [], []
    try:
        for r in range(world):
            out = os.path.join(tmp, f"rank{r}.out")
            err = os.path.join(tmp, f"rank{r}.err")
            logs.append((out, err))
            with open(out, "w") as fo, open(err, "w") as fe:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.distributed.ranks",
                     target, str(r), str(world), os.path.join(tmp, "store"),
                     str(timeout), json.dumps(list(args))],
                    stdout=fo, stderr=fe, env=env))
        deadline = time.monotonic() + timeout
        failed = None
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.returncode not in (None, 0)]
            if bad or time.monotonic() > deadline:
                failed = (f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                          if bad else f"timed out after {timeout:g} s")
                break
            time.sleep(0.05)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        if failed is None and any(p.returncode for p in procs):
            r = next(r for r, p in enumerate(procs) if p.returncode)
            failed = f"rank {r} exited {procs[r].returncode}"
        if failed is not None:
            tails = "\n".join(f"--- rank {r} ---\n{_tail(o)}\n{_tail(e)}"
                              for r, (o, e) in enumerate(logs))
            raise RuntimeError(f"{target} on {world} ranks: {failed}\n"
                               f"{tails}")
        return [_tail(o, 1 << 20) for o, _ in logs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)


def _main(argv: List[str]) -> None:
    target, rank, world, store, timeout, args = argv
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    init(int(rank), int(world), store, timeout=float(timeout))
    try:
        module, fn = target.split(":")
        getattr(importlib.import_module(module), fn)(
            int(rank), int(world), *json.loads(args))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1:])
