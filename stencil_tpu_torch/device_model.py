"""Device memory of the attached card: ``hbm_bytes()``.

Counterpart of ``stencil_tpu/device_model.py:hbm_bytes`` (:133-141), the one
budget three parts of the port size themselves from: the Arnoldi basis of
``krylov.GMRES`` (``_check_basis_budget``), the chunk count of the
out-of-core ``streaming.auto_chunks`` and the CLI's host-resident grid
(``cli.make_grid``). The rest of the JAX module, the TPU's VMEM model and
its table of device kinds, belongs to the plan-tuning port (ROADMAP Queue A)
and is not here.
"""

from __future__ import annotations

import functools
import os

import torch

MIB = 1024 * 1024


@functools.lru_cache(maxsize=8)
def _detected(device: str) -> int:
    dev = torch.device(device)
    if dev.type == "cuda":
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        return int(torch.cuda.get_device_properties(index).total_memory)
    # the CPU: the host's physical memory
    return int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


def hbm_bytes(device="cuda") -> int:
    """Memory of ``device``: ``STENCIL_TPU_HBM_MB`` (MiB) when set, which
    lets a test simulate a small card; else the CUDA device's total memory,
    or on the CPU the host's physical memory. A CUDA device that torch
    cannot see raises, as every entry point of the port does."""
    env = os.environ.get("STENCIL_TPU_HBM_MB")
    if env:
        return int(env) * MIB
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch sees no CUDA "
            "device; pass device='cpu'")
    return _detected(str(device))
