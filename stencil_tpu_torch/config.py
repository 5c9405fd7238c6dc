"""Typed configuration for the CLI.

Counterpart of ``stencil_tpu/config.py`` (``RunConfig``, ``build_parser``,
``parse_args``): the same flags, so every command line of the JAX package
parses unchanged, with ``--platform`` replaced by ``--device`` (default
``cuda``).

TPU tuning flags (``--slots``, ``--slide``, ``--cores``, ``--tap-mode``,
``--embed``, ``--autotune``) are accepted and recorded in the runner's
``plan_info`` under ``ignored``; the machinery they tune does not exist on
the GPU and is removed by design (plan tuning for the card is ROADMAP
Queue A). In solve mode ``solve_cli.run_solve`` reports ``--mesh`` (the
distributed solvers, not ported yet) as an error record, as the JAX
``run_solve`` reports its own refusals.

``--mesh`` and ``--no-overlap`` drive the sharded methods in iterate mode
(``registry.py``); ``--chunks`` the out-of-core ``streamed`` method (other
methods ignore it, as in the JAX package); ``--checkpoint-dir``,
``--dump-image`` and ``--profile`` work in both modes (``cli.py``,
``solve_cli.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

DEFAULT_METHODS = ("xla",)

# TPU-only tuning flags: field -> default. A run records the ones that were
# set to something else, and ignores them.
TPU_TUNING_DEFAULTS = {
    "tap_mode": None, "autotune": False, "slots": 2, "slide": False,
    "cores": 1, "embed": False,
}


@dataclasses.dataclass
class RunConfig:
    """One benchmark run: a grid, a stencil, a method list, a protocol."""

    # problem
    size: Tuple[int, ...] = (512, 512)   # interior shape (-s)
    iterations: int = 1000               # (-i)
    spec: str = "jacobi5"                # named stencil
    radius: Optional[int] = None         # star-stencil radius override
    dtype: str = "float32"

    # execution
    methods: Tuple[str, ...] = DEFAULT_METHODS  # (-m)
    block: Optional[int] = None          # tiled/slab: pins the d0 tile extent
    temporal: int = 1                    # sweeps per kernel launch (k)
    device: str = "cuda"                 # torch device; no CPU fallback

    # accepted for command-line compatibility; ignored (TPU tuning)
    tap_mode: Optional[str] = None
    autotune: object = False
    slots: int = 2
    slide: bool = False
    cores: int = 1
    embed: bool = False

    # steady solver stack: the problem family
    solve: Optional[str] = None

    # the sharded methods' mesh (in solve mode run_solve's error record)
    # and their interior-first split
    mesh: Tuple[int, ...] = ()
    no_overlap: bool = False

    # out-of-core streaming: d0 chunks of the streamed method (None: sized
    # from the device's memory)
    chunks: Optional[int] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 100
    dump_image: Optional[str] = None
    profile_dir: Optional[str] = None

    # boundary conditions: dims that wrap (periodic) or mirror (Neumann)
    periodic: Tuple[object, ...] = ()
    neumann: Tuple[object, ...] = ()

    # solver-mode settings (used only with --solve)
    solver: str = "auto"
    tolerance: float = 1e-5
    precond: Optional[str] = None
    precond_dtype: Optional[str] = None
    smoother: str = "wjacobi"
    gamma: int = 1
    nu_smooth: Tuple[int, int] = (2, 2)
    fine_method: str = "auto"
    restart: int = 16
    warm_start: Optional[str] = None
    velocity: Tuple[float, ...] = ()
    nu: float = 1.0
    scheme: str = "upwind"
    contrast: float = 100.0
    rhs: str = "auto"
    op_kernel: str = "auto"

    # protocol
    repeat: int = 1                      # (-R)
    check: bool = False                  # (-c)
    # None = per-dtype default: 1e-4 for float32, 3e-2 for bfloat16
    check_tolerance: Optional[float] = None
    warmup: int = 1                      # untimed warmup sweeps (x granularity)

    # output
    json_out: Optional[str] = None
    verbose: bool = False

    def periodic_dims(self) -> Tuple[int, ...]:
        """``periodic`` normalized to a tuple of dim indices."""
        if any(str(d) == "all" for d in self.periodic):
            return tuple(range(len(self.size)))
        return tuple(int(d) for d in self.periodic)

    def neumann_dims(self) -> Tuple[int, ...]:
        """``neumann`` normalized to a tuple of dim indices."""
        if any(str(d) == "all" for d in self.neumann):
            return tuple(range(len(self.size)))
        return tuple(int(d) for d in self.neumann)

    def resolved_spec(self):
        from stencil_tpu_torch.core.spec import get_spec, star

        if self.radius is not None:
            return star(len(self.size), self.radius)
        sp = get_spec(self.spec)
        if sp.ndim != len(self.size):
            raise ValueError(
                f"spec {self.spec!r} is {sp.ndim}D but size is "
                f"{len(self.size)}D"
            )
        return sp

    def ignored_tpu_flags(self) -> Dict[str, object]:
        """TPU tuning flags set away from their defaults (ignored)."""
        return {name: getattr(self, name)
                for name, default in TPU_TUNING_DEFAULTS.items()
                if getattr(self, name) != default}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="stencil-tpu-torch",
        description="structured-grid stencil benchmark driver "
                    "(PyTorch/CUDA port)",
    )
    p.add_argument("-s", "--size", type=int, nargs="+", default=[512, 512],
                   help="interior grid shape, e.g. -s 512 512 or -s 256 256 256")
    p.add_argument("-i", "--iterations", type=int, default=1000)
    p.add_argument("--spec", type=str, default="jacobi5",
                   help="named stencil spec (jacobi5/jacobi9/jacobi7/"
                        "jacobi27/star2d_r2/star3d_r2/laplace2d_ho/laplace3d_ho)")
    p.add_argument("-r", "--radius", type=int, default=None,
                   help="star-stencil radius override")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("-m", "--methods", type=str, nargs="+",
                   default=list(DEFAULT_METHODS),
                   help="methods to run: eager, tiled (3D), slab (2D), "
                        "varcoeff (heterogeneous diffusion), sharded, "
                        "sharded_noverlap, sharded_pallas, rma, streamed "
                        "(out-of-core, 3D), or the JAX "
                        "package's names xla, pallas, pallas_temporal, "
                        "pallas_tiled")
    p.add_argument("-b", "--block", type=int, default=None,
                   help="tiled/slab: pin the d0 tile extent (rows per "
                        "tile); default auto")
    p.add_argument("-k", "--temporal", type=int, default=1,
                   help="temporal blocking depth (sweeps per kernel launch)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda); 'cpu' runs the plain "
                        "PyTorch versions of the kernels")
    p.add_argument("--mesh", type=int, nargs="*", default=[],
                   help="sharded methods: the mesh shape, e.g. --mesh 2 2 "
                        "(default one rank per visible CUDA device; ranks "
                        "may share a card)")
    p.add_argument("--no-overlap", action="store_true",
                   help="sharded methods: no interior-first split of the "
                        "step around the halo exchange")
    p.add_argument("--autotune", nargs="?", const="on", default=False,
                   choices=("on", "force"),
                   help="TPU plan tuning: accepted and ignored")
    p.add_argument("--slots", type=int, default=2,
                   help="TPU DMA pipeline depth: accepted and ignored")
    p.add_argument("--slide", action="store_true",
                   help="TPU sliding-window reuse: accepted and ignored")
    p.add_argument("--cores", type=int, default=1,
                   help="TPU core split: accepted and ignored")
    p.add_argument("--embed", action="store_true",
                   help="TPU ragged-grid embedding: accepted and ignored "
                        "(the CUDA kernel clamps ragged tiles)")
    p.add_argument("--chunks", type=int, default=None,
                   help="streamed method: number of host-resident "
                        "d0 chunks (default: sized from the device's "
                        "memory)")
    p.add_argument("--periodic", type=str, nargs="*", default=[],
                   help="dims with periodic (wrap-around) boundaries, e.g. "
                        "--periodic 0 1 or --periodic all (every method; "
                        "on a kernel a periodic last dim needs -k 1)")
    p.add_argument("--neumann", type=str, nargs="*", default=[],
                   help="dims with Neumann (zero-flux mirror) boundaries, "
                        "e.g. --neumann 0 (every method; on a kernel a "
                        "Neumann last dim needs -k 1, a Neumann dim at -k "
                        "> 1 a stencil mirror-symmetric in it)")
    p.add_argument("--tap-mode", type=str, default=None,
                   choices=["slice", "roll", "synth", "rotacc"],
                   help="TPU tap evaluation strategy: accepted and ignored")
    p.add_argument("--solve", type=str, default=None,
                   choices=["poisson", "hetero", "advdiff"],
                   help="steady solver stack: the problem family (poisson, "
                        "hetero, advdiff)")
    p.add_argument("--solver", type=str, default="auto",
                   choices=["auto", "relax", "mg", "fmg", "cg", "pcg",
                            "bicgstab", "gmres"],
                   help="solve mode: auto (pcg for poisson, bicgstab "
                        "otherwise), relax, mg, fmg, cg, pcg, bicgstab, "
                        "gmres")
    p.add_argument("--tol", type=float, default=1e-5, dest="tolerance",
                   help="solve mode: tolerance (Krylov: relative 2-norm; "
                        "mg/relax: max update per iteration)")
    p.add_argument("--precond", type=str, default=None,
                   choices=["none", "mg", "opmg"],
                   help="preconditioner: mg (cg/pcg, the Poisson cycle), "
                        "opmg (bicgstab/gmres, the rediscretized operator "
                        "cycle) "
                        "or none")
    p.add_argument("--precond-dtype", type=str, default=None,
                   choices=["float32", "bfloat16"],
                   help="pcg: dtype of the eager preconditioning cycle")
    p.add_argument("--smoother", type=str, default="wjacobi",
                   choices=["wjacobi", "chebyshev"],
                   help="multigrid smoother")
    p.add_argument("--gamma", type=int, default=1, choices=[1, 2],
                   help="multigrid cycle index: 1 V-cycle, 2 W-cycle")
    p.add_argument("--nu-smooth", type=int, nargs=2, default=[2, 2],
                   metavar=("NU1", "NU2"),
                   help="multigrid pre/post smoothing sweeps")
    p.add_argument("--fine-method", type=str, default="auto",
                   choices=["auto", "xla", "pallas_tiled"],
                   help="multigrid fine level: xla (eager torch ops), "
                        "pallas_tiled (the tiled CUDA kernel, 3D), auto "
                        "(tiled on a card for chebyshev, or wjacobi at "
                        "nu >= 4)")
    p.add_argument("--restart", type=int, default=16,
                   help="gmres: Arnoldi steps per restart cycle")
    p.add_argument("--warm-start", type=str, default=None, choices=["fmg"],
                   help="Krylov initial iterate: one FMG pass")
    p.add_argument("--velocity", type=float, nargs="+", default=[],
                   help="advdiff: velocity per dim (default 1.0 each)")
    p.add_argument("--nu", type=float, default=1.0,
                   help="advdiff: diffusivity")
    p.add_argument("--scheme", type=str, default="upwind",
                   choices=["upwind", "central"],
                   help="advdiff: advection scheme")
    p.add_argument("--contrast", type=float, default=100.0,
                   help="-m varcoeff and --solve hetero: the two-material "
                        "coefficient's ratio hi/lo")
    p.add_argument("--rhs", type=str, default="auto",
                   choices=["auto", "sine", "random", "ones"],
                   help="solve mode right-hand side (auto: the "
                        "manufactured sine for poisson)")
    p.add_argument("--op-kernel", type=str, default="auto",
                   choices=["auto", "xla", "pallas"],
                   help="hetero operator matvec: auto/xla (the eager field "
                        "sweep) or pallas (the tiled kernel's coefficient "
                        "mode, 3D)")
    p.add_argument("-R", "--repeat", type=int, default=1,
                   help="timed wall-clock repeats and marginal-timing "
                        "repeats")
    p.add_argument("-c", "--check-result", action="store_true", dest="check")
    p.add_argument("--check-tolerance", type=float, default=None,
                   help="|err| bar for -c; default 1e-4 (float32) or 3e-2 "
                        "(bfloat16)")
    p.add_argument("--warmup", type=int, default=1,
                   help="untimed warmup sweeps before timing (scaled by "
                        "the method's granularity)")
    p.add_argument("--checkpoint-dir", type=str, default=None,
                   help="directory for periodic checkpoints; an existing "
                        "checkpoint there is resumed")
    p.add_argument("--checkpoint-every", type=int, default=100)
    p.add_argument("--dump-image", type=str, default=None,
                   help="write the final iterate as a heat-map BMP (a "
                        "volume's middle d0 plane)")
    p.add_argument("--json-out", type=str, default=None,
                   help="write results as JSON lines to this path")
    p.add_argument("--profile", type=str, default=None, dest="profile_dir",
                   help="write a torch.profiler trace (CUDA and CPU "
                        "activities) of each method's timed runs to this "
                        "directory")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def parse_args(argv: Optional[Sequence[str]] = None) -> RunConfig:
    ns = build_parser().parse_args(argv)
    fields = {f.name for f in dataclasses.fields(RunConfig)}
    values = {name: getattr(ns, name) for name in fields if hasattr(ns, name)}
    for name, value in values.items():
        if isinstance(value, list):
            values[name] = tuple(value)
    return RunConfig(**values)
