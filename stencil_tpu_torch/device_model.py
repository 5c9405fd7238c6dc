"""Resources of the attached card: memory, shared memory, SMs and L2.

Counterpart of ``stencil_tpu/device_model.py``. The TPU's scarce resource is
VMEM, and its module scales every kernel budget from the VMEM of the chip it
finds. The card's are the shared memory of a block and of an SM, the SM
count, the threads an SM holds and the L2: :func:`budgets` reads them from
``torch.cuda.get_device_properties`` where torch reports them, else from a
table of device kinds matched on the card's name (:data:`BUDGETS_BY_KIND`),
and this module is the one place the port's plans take them from
(``ops/tiled.py``, ``ops/slab.py``, ``parallel/rma.py``).

Bit-exactness contract (the JAX module's, ``device_model.py:11-17``): on an
H100 SXM every budget equals :data:`H100`, the card the plans' cost models
were fitted on, and so does every budget where no card is asked (a plan made
on the CPU), so that plans built in the tests equal plans built on the card.

``STENCIL_TPU_SMEM_KB`` simulates a smaller per-block shared memory (KiB),
the counterpart of ``STENCIL_TPU_VMEM_MB``: the tests prove that plans made
under 48, 100 and 164 KB stay feasible and correct. ``hbm_bytes`` (with
``STENCIL_TPU_HBM_MB``) sizes the Arnoldi basis of ``krylov.GMRES``, the
chunks of ``streaming.auto_chunks`` and the CLI's host-resident grid.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional

import torch

MIB = 1024 * 1024
KIB = 1024
SMEM_ENV = "STENCIL_TPU_SMEM_KB"


@dataclasses.dataclass(frozen=True)
class Budgets:
    """What one card offers the kernels' plans."""

    kind: str             # the card's name, or the table row's
    smem_per_block: int   # shared memory one block may opt in to
    smem_per_sm: int      # shared memory of one SM
    smem_reserved: int    # of it, reserved by the runtime per block
    sm_count: int         # streaming multiprocessors
    threads_per_sm: int   # resident threads of one SM
    l2_bytes: int         # the L2 cache: rma's residency budget


# the card the cost models were fitted on, and the budgets off the card
H100 = Budgets(kind="NVIDIA H100 80GB HBM3", smem_per_block=232_448,
               smem_per_sm=233_472, smem_reserved=1024, sm_count=132,
               threads_per_sm=2048, l2_bytes=50 * MIB)

# public figures by name substring (first match wins, matched lowercase),
# for the fields torch does not report
BUDGETS_BY_KIND = (
    ("h100 pcie", dataclasses.replace(H100, kind="NVIDIA H100 PCIe",
                                      sm_count=114)),
    ("h100", H100),
    ("h200", dataclasses.replace(H100, kind="NVIDIA H200")),
    ("a100", Budgets(kind="NVIDIA A100", smem_per_block=166_912,
                     smem_per_sm=167_936, smem_reserved=1024, sm_count=108,
                     threads_per_sm=2048, l2_bytes=40 * MIB)),
    ("l40s", Budgets(kind="NVIDIA L40S", smem_per_block=101_376,
                     smem_per_sm=102_400, smem_reserved=1024, sm_count=142,
                     threads_per_sm=1536, l2_bytes=96 * MIB)),
)

# torch's property name for each field it reports
_PROPERTIES = {"smem_per_block": "shared_memory_per_block_optin",
               "smem_per_sm": "shared_memory_per_multiprocessor",
               "sm_count": "multi_processor_count",
               "threads_per_sm": "max_threads_per_multi_processor",
               "l2_bytes": "L2_cache_size"}


def kind_budgets(name: str) -> Budgets:
    """The table's row for a card named ``name``; :data:`H100` for a name
    no row matches."""
    low = name.lower()
    for sub, b in BUDGETS_BY_KIND:
        if sub in low:
            return b
    return H100


def from_properties(props) -> Budgets:
    """The budgets of a card from its ``torch.cuda`` properties: each field
    torch reports, the rest from :func:`kind_budgets` of its name."""
    base = kind_budgets(props.name)
    reported = {field: int(getattr(props, attr))
                for field, attr in _PROPERTIES.items()
                if getattr(props, attr, 0)}
    return dataclasses.replace(base, kind=props.name, **reported)


@functools.lru_cache(maxsize=8)
def _detected(index: Optional[int]) -> Budgets:
    if index is None:
        return H100
    return from_properties(torch.cuda.get_device_properties(index))


def _cuda_index(device) -> Optional[int]:
    """The CUDA device a plan is made for: ``device``'s, or the current one
    when ``device`` is None and a card is visible; None on the CPU."""
    if device is None:
        return torch.cuda.current_device() if torch.cuda.is_available() \
            else None
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return dev.index if dev.index is not None \
        else torch.cuda.current_device()


def budgets(device=None) -> Budgets:
    """The budgets of ``device`` (None: the current card, :data:`H100`
    where there is none). ``STENCIL_TPU_SMEM_KB`` replaces the per-block
    shared memory, and with it the SM's (that plus the reserved KB)."""
    b = _detected(_cuda_index(device))
    env = os.environ.get(SMEM_ENV)
    if env:
        per_block = int(env) * KIB
        b = dataclasses.replace(b, smem_per_block=per_block,
                                smem_per_sm=per_block + b.smem_reserved)
    return b


@functools.lru_cache(maxsize=8)
def _detected_hbm(device: str) -> int:
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
    return _detected_hbm(str(device))
