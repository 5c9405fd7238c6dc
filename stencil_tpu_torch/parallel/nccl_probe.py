"""Whether NCCL runs two ranks on one card: the check behind the port's
single-controller mesh (``parallel/mesh.py``).

    python -m stencil_tpu_torch.parallel.nccl_probe

Starts two processes, both on ``cuda:0``, joined by ``torch.distributed``
with the NCCL backend at ``tcp://localhost:<free port>``, and runs one
``all_reduce``. Prints one line per rank with what it saw, and stops both
processes within a minute and a half either way. Exits 0 when both ranks
reported, whatever they reported; 1 without a CUDA device.
"""

from __future__ import annotations

import datetime
import socket
import sys

import torch

TIMEOUT_S = 90


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(rank: int, port: int, queue) -> None:
    import torch.distributed as dist

    try:
        dist.init_process_group(
            "nccl", init_method=f"tcp://localhost:{port}", world_size=2,
            rank=rank, timeout=datetime.timedelta(seconds=60))
        t = torch.ones(4, device="cuda:0")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        queue.put((rank, f"ok, all_reduce gave {t[0].item():g}"))
    except Exception as e:  # what NCCL says is the finding
        lines = [s.strip() for s in str(e).splitlines() if s.strip()]
        queue.put((rank, f"{type(e).__name__}: {' | '.join(lines)[:600]}"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("nccl_probe: torch sees no CUDA device", file=sys.stderr)
        return 1
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, port, queue))
             for r in range(2)]
    for p in procs:
        p.start()
    seen = {}
    try:
        for _ in procs:
            rank, what = queue.get(timeout=TIMEOUT_S)
            seen[rank] = what
    except Exception:
        pass
    for p in procs:
        p.join(timeout=5)
        if p.is_alive():
            p.terminate()
            p.join(timeout=5)
        if p.is_alive():
            p.kill()
            p.join()
    print(f"NCCL {torch.cuda.nccl.version()}, two ranks on "
          f"{torch.cuda.get_device_name(0)}:")
    for rank in range(2):
        print(f"  rank {rank}: {seen.get(rank, 'no report (timed out)')}")
    return 0 if len(seen) == 2 else 2


if __name__ == "__main__":
    raise SystemExit(main())
