"""Joining and launching a data-parallel group: one process a device.

The port of ``ct_tpu/parallel/distributed.py``. JAX joins hosts into one
runtime and runs one program over all their devices; the port runs one
process a device and joins them in a ``torch.distributed`` group:

  * ``initialize`` joins the group over ``tcp://`` (a no-op for one
    process), the backend NCCL on the card and gloo on the CPU, and
    returns JAX's four counts;
  * ``make_host_local_batch`` places this process's block of the global
    batch on its device (each rank holds only its own block);
  * ``launch`` starts ``ndev`` worker interpreters on a free localhost
    port, each of which joins the group as rank r on device r and calls a
    target given as ``"module:function"`` (so that a worker imports that
    module and never its parent's ``__main__``); it returns rank 0's
    result. It never puts two ranks on one card unless asked
    (``share_device``, over gloo);
  * ``from_environment`` reads a launcher's variables (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), as
    ``torchrun`` sets them;
  * ``cli_entry`` is the CLIs' choice among the three ways to run: one
    process, a launcher's group, or workers spawned for ``--ndev``.
"""

from __future__ import annotations

import datetime
import importlib
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Any, Dict, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

# how long a collective may wait for its peers before it fails
GROUP_TIMEOUT = datetime.timedelta(minutes=10)


def default_backend(device) -> str:
    """NCCL for CUDA devices, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device="cpu") -> Dict[str, Any]:
    """Join the group at ``coordinator_address`` (``host:port``, with or
    without ``tcp://``, or ``env://`` for a launcher's variables and
    store) as rank ``process_id`` of ``num_processes``; a no-op for a
    single process without an address. Returns the counts of JAX's
    ``initialize``: each process holds one device."""
    if ((num_processes is not None and num_processes > 1)
            or coordinator_address is not None) and not dist.is_initialized():
        address = coordinator_address
        if not address.startswith(("tcp://", "env://")):
            address = "tcp://" + address
        dist.init_process_group(backend or default_backend(device),
                                init_method=address,
                                world_size=num_processes or 1,
                                rank=process_id or 0, timeout=GROUP_TIMEOUT)
    world = dist.get_world_size() if dist.is_initialized() else 1
    return {"process_index": dist.get_rank() if dist.is_initialized() else 0,
            "process_count": world, "local_devices": 1,
            "global_devices": world}


def make_host_local_batch(mesh, batch: Dict[str, Any]) -> Dict[str, Any]:
    """This process's block of the global batch (global / process count
    rows) as tensors on its device: the port's global batch is the ranks'
    blocks in rank order, and no rank moves another's."""
    from ct_tpu_torch.data.loader import to_device

    return {k: to_device(v, mesh.device) for k, v in batch.items()}


def from_environment() -> Optional[Dict[str, Any]]:
    """A launcher's group (rank, world_size, local_rank), or None where
    ``RANK`` and ``WORLD_SIZE`` are not set; it is joined by ``env://``,
    which reads ``MASTER_ADDR`` and ``MASTER_PORT`` (and, under
    ``torchrun``, uses its agent's store)."""
    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return None
    return {"rank": int(env["RANK"]), "world_size": int(env["WORLD_SIZE"]),
            "local_rank": int(env.get("LOCAL_RANK", env["RANK"]))}


def rank_device(device) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` for a CUDA request (the
    card set current), the CPU otherwise."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    local = int(os.environ.get("LOCAL_RANK", device.index or 0))
    torch.cuda.set_device(local)
    return torch.device("cuda", local)


def visible_devices(device) -> int:
    """How many devices of ``device``'s type a group could use: the
    visible cards, or 1 for the CPU (gloo ranks share it)."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1


def check_devices(ndev: int, device, share_device: bool = False) -> None:
    """Raise where ``ndev`` ranks on ``device`` would need more cards than
    are visible (and ``share_device`` does not put them on one)."""
    if torch.device(device).type != "cuda" or share_device:
        return
    have = visible_devices(device)
    if ndev > have:
        raise RuntimeError(f"--ndev {ndev} needs {ndev} CUDA devices, but "
                           f"{have} are visible; the port puts one rank on "
                           f"each card")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _resolve(target: str):
    module, name = target.split(":")
    return getattr(importlib.import_module(module), name)


def run_worker(spec_path: str, rank: int) -> None:
    """One rank of ``launch``: the launcher's variables, the group, the
    target; rank 0 pickles its result beside the spec, a failing rank its
    traceback."""
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    world, port = spec["world"], spec["port"]
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK="0" if spec["share_device"] else str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    folder = os.path.dirname(spec_path)
    try:
        dev = rank_device(spec["device"])
        initialize(f"localhost:{port}", world, rank, spec["backend"], dev)
        out = _resolve(spec["target"])(*spec["args"])
        if rank == 0:
            with open(os.path.join(folder, "result.pkl"), "wb") as f:
                pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(folder, f"error.{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(target: str, ndev: int, args: Sequence = (), device="cpu",
           backend: Optional[str] = None, share_device: bool = False,
           timeout: Optional[float] = None) -> Any:
    """Run ``target`` (``"module:function"``, its ``args`` pickled) in
    ``ndev`` ranks of one group on ``device``'s type and return rank 0's
    result. Each rank is a fresh interpreter (``python -m
    ct_tpu_torch.parallel.worker``), so it imports the target's module and
    never the caller's ``__main__``. The backend defaults to NCCL on the
    card (one card a rank: fewer visible cards raise) and gloo on the CPU;
    ``share_device`` puts every rank on card 0, which NCCL refuses, so it
    takes gloo. A failing rank stops the others and raises here with its
    traceback."""
    check_devices(ndev, device, share_device)
    backend = backend or ("gloo" if share_device else default_backend(device))
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    with tempfile.TemporaryDirectory(prefix="ct_tpu_torch_launch_") as tmp:
        spec_path = os.path.join(tmp, "spec.pkl")
        with open(spec_path, "wb") as f:
            pickle.dump({"target": target, "args": tuple(args),
                         "world": ndev, "port": free_port(),
                         "backend": backend,
                         "device": str(torch.device(device)),
                         "share_device": share_device}, f)
        procs = [subprocess.Popen(
            [sys.executable, "-m", "ct_tpu_torch.parallel.worker",
             spec_path, str(r)], env=env) for r in range(ndev)]
        deadline = None if timeout is None else time.monotonic() + timeout
        timed_out = False
        try:
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs):
                    break
                if deadline is not None and time.monotonic() > deadline:
                    timed_out = True
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.terminate()
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        codes = [p.returncode for p in procs]
        if timed_out or any(c != 0 for c in codes):
            errors = []
            for r in range(ndev):
                path = os.path.join(tmp, f"error.{r}.txt")
                if os.path.exists(path):
                    with open(path) as f:
                        errors.append(f"rank {r}:\n{f.read()}")
            why = f"timed out after {timeout} s" if timed_out else \
                f"exit codes {codes}"
            raise RuntimeError(f"a data-parallel worker failed ({why}):\n"
                               + "\n".join(errors))
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            return pickle.load(f)


class Entry(NamedTuple):
    """What ``cli_entry`` did: ``launched`` the workers (``result`` is rank
    0's), or left this process to run, ``joined`` to a launcher's group
    that it must leave at its end (``leave``)."""

    launched: bool
    result: Any = None
    joined: bool = False


def cli_entry(ndev: int, device, target: str, argv: Sequence[str],
              batch_size: int, spawn: bool = True) -> Entry:
    """A CLI's data-parallel entry, before it does any work:

    * in a worker that ``launch`` started (a group exists): run on;
    * under a launcher's environment: join its group (world size 1 too),
      ``ndev`` being 0 or its ``WORLD_SIZE``;
    * ``ndev`` > 1 (0: every visible card, one on the CPU) and ``spawn``:
      start that many workers of ``target`` on ``argv`` and return rank
      0's result;
    * otherwise run on as one process, with no group.

    ``batch_size`` must divide over the ranks."""
    def check_batch(n):
        if batch_size % n:
            raise SystemExit(f"--batch-size {batch_size} must be divisible "
                             f"by --ndev {n}")

    if dist.is_initialized():
        check_batch(dist.get_world_size())
        return Entry(False)
    env = from_environment()
    if env is not None:
        if ndev not in (0, env["world_size"]):
            raise SystemExit(f"--ndev {ndev} in a launcher's group of "
                             f"WORLD_SIZE {env['world_size']}: pass 0 or "
                             f"{env['world_size']}")
        check_batch(env["world_size"])
        initialize("env://", env["world_size"], env["rank"],
                   device=rank_device(device))
        return Entry(False, joined=True)
    n = ndev if ndev > 0 else visible_devices(device)
    if n <= 1 or not spawn:
        return Entry(False)
    check_batch(n)
    return Entry(True, launch(target, n, (list(argv),), device))


def leave(entry: Entry) -> None:
    """Leave the group that ``cli_entry`` joined."""
    if entry.joined and dist.is_initialized():
        dist.destroy_process_group()
