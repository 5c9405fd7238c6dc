"""The hand-written CUDA kernels (stencil_tpu_torch/csrc/tiled_sweep.cu, 3D,
and csrc/slab_sweep.cu, 2D), homogeneous and with a source, the 3D
kernel's Chebyshev, dual, two-level and coefficient modes, its d0 march
(csrc/tiled_march.cu) and the coefficient mode's weights
(csrc/coeff_weights.cu), and the
in-kernel exchange csrc/rma_iterate.cu (every rank's buffers after one
cooperative launch, on Dirichlet, periodic and Neumann walls, in fp32 and
bf16), against their plain PyTorch versions, on an NVIDIA
GPU; and the out-of-core streamed method (stencil_tpu_torch/streaming.py:
pinned host buffers, one tiled launch per chunk, copies on their own
streams ordered by events) bitwise against the in-core tiled method. Marked ``cuda``; without a card
every test skips. This file imports no JAX, so it also runs where only the
port is installed:

    python -m pytest tests/test_torch_cuda.py -q

Tolerance: bitwise (same taps in the same order, the source added after
them, the Chebyshev terms in the same order with the same float32
coefficients, the face means and weights of the coefficient mode in the
same order, built with -fmad=false); the multigrid cycle on the kernel
against the eager cycle 5e-6 (the two reassociate the fine level's
arithmetic)."""

import functools

import numpy as np
import pytest
import torch

from stencil_tpu_torch.core.grid import DirichletBC, HaloGrid
from stencil_tpu_torch.core.spec import get_spec
from stencil_tpu_torch.models.heat import HeatDiffusion
from stencil_tpu_torch.models.poisson import PoissonProblem
from stencil_tpu_torch.multigrid import (
    Multigrid, _cheby_sweep_coeffs, nbsum_spec,
)
from stencil_tpu_torch.ops import eager
from stencil_tpu_torch.ops.layout import pad_source
from stencil_tpu_torch.ops.slab import SlabStencil, make_slab_plan
from stencil_tpu_torch.ops.slab_kernel import slab_sweep
from stencil_tpu_torch.ops.sweep_kernel import sweep_reference
from stencil_tpu_torch.ops.tiled import TiledStencil, make_tiled_plan
from stencil_tpu_torch.ops.tiled_kernel import tiled_sweep

pytestmark = pytest.mark.cuda

BC3 = DirichletBC(values=((0.5, -1.0), (2.0, 0.25), (1.0, 1.5)))
BC2 = DirichletBC(values=((0.5, -1.0), (2.0, 0.25)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _grid(shape, radius, device, seed=1, bc=None):
    x = np.random.default_rng(seed).random(shape).astype(np.float32)
    if bc is None:
        bc = BC3 if len(shape) == 3 else BC2
    return HaloGrid.from_interior(torch.from_numpy(x), halo=radius, bc=bc,
                                  device=device)


def _source(shape, seed=2):
    return np.random.default_rng(seed).normal(size=shape)


@pytest.mark.parametrize("name,shape,k", [
    ("jacobi7", (64, 48, 40), 8), ("jacobi7", (57, 50, 46), 3),
    ("jacobi7", (5, 70, 3), 1), ("jacobi27", (33, 20, 41), 4),
    ("star3d_r2", (30, 31, 32), 2), ("laplace3d_ho", (30, 31, 32), 4)])
def test_kernel_matches_plain(cuda_device, name, shape, k):
    sp = get_spec(name)
    plan = make_tiled_plan(sp, shape, "float32", k)
    cur = plan.layout.pad_grid(_grid(shape, sp.radius, cuda_device))
    before = tiled_sweep.launches
    got = tiled_sweep(cur, cur.clone(), plan)
    want = sweep_reference(cur, plan)
    torch.cuda.synchronize()
    assert tiled_sweep.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("name,shape,k", [
    ("jacobi7", (64, 48, 40), 8), ("jacobi7", (57, 50, 46), 3),
    ("jacobi27", (33, 20, 41), 2)])
def test_tiled_source_matches_plain(cuda_device, name, shape, k):
    sp = get_spec(name)
    plan = make_tiled_plan(sp, shape, "float32", k)
    cur = plan.layout.pad_grid(_grid(shape, sp.radius, cuda_device))
    src = pad_source(plan, _source(shape), -0.01, BC3).to(cuda_device)
    got = tiled_sweep(cur, cur.clone(), plan, src)
    want = sweep_reference(cur, plan, src)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _heat2d():
    return HeatDiffusion((8, 8), dt=0.1).spec  # 5 taps, 2 weight groups


@pytest.mark.parametrize("name,shape,k,t0", [
    ("jacobi5", (512, 512), 16, None), ("jacobi5", (512, 512), 1, None),
    ("jacobi9", (600, 700), 4, 256), ("star2d_r2", (250, 333), 3, None),
    ("laplace2d_ho", (100, 90), 2, 8), ("heat2d", (70, 33), 5, None)])
def test_slab_kernel_matches_plain(cuda_device, name, shape, k, t0):
    sp = _heat2d() if name == "heat2d" else get_spec(name)
    plan = make_slab_plan(sp, shape, "float32", k, t0_fixed=t0)
    cur = plan.layout.pad_grid(_grid(shape, sp.radius, cuda_device))
    before = slab_sweep.launches
    got = slab_sweep(cur, cur.clone(), plan)
    want = sweep_reference(cur, plan)
    torch.cuda.synchronize()
    assert slab_sweep.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("name,shape,k", [
    ("jacobi5", (300, 257), 4), ("jacobi9", (64, 80), 8)])
def test_slab_source_matches_plain(cuda_device, name, shape, k):
    sp = get_spec(name)
    plan = make_slab_plan(sp, shape, "float32", k)
    cur = plan.layout.pad_grid(_grid(shape, sp.radius, cuda_device))
    src = pad_source(plan, _source(shape), -0.01, BC2).to(cuda_device)
    got = slab_sweep(cur, cur.clone(), plan, src)
    want = sweep_reference(cur, plan, src)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_iterate_with_remainder_matches_eager(cuda_device):
    sp = get_spec("jacobi27")
    g = _grid((40, 36, 44), 1, cuda_device)
    got = TiledStencil(sp, (40, 36, 44), sweeps_per_call=4,
                       device=cuda_device).iterate(g, 11)
    want = eager.iterate(g, sp, 11)
    assert torch.equal(got.data, want.data)


@pytest.mark.parametrize("name,shape", [("jacobi5", (61, 75)),
                                        ("jacobi7", (21, 30, 19))])
def test_source_iterate_with_remainder_matches_eager(cuda_device, name,
                                                     shape):
    sp = get_spec(name)
    g = _grid(shape, 1, cuda_device)
    f = _source(shape)
    stencil = SlabStencil if len(shape) == 2 else TiledStencil
    got = stencil(sp, shape, sweeps_per_call=4, device=cuda_device,
                  source=f, source_scale=-0.02).iterate(g, 11)
    scaled = torch.from_numpy(f).float().to(cuda_device) \
        * float(np.float32(-0.02))
    want = eager.iterate(g, sp, 11, scaled)
    assert torch.equal(got.data, want.data)


def test_launch_refuses_cpu_tensor_mix(cuda_device):
    sp = get_spec("jacobi7")
    plan = make_tiled_plan(sp, (8, 8, 8), "float32", 2)
    cur = plan.layout.pad_grid(_grid((8, 8, 8), 1, cuda_device))
    with pytest.raises(ValueError, match="cur on"):
        tiled_sweep(cur, cur.cpu(), plan)
    plan2 = make_slab_plan(get_spec("jacobi5"), (8, 8), "float32", 2)
    cur2 = plan2.layout.pad_grid(_grid((8, 8), 1, cuda_device))
    with pytest.raises(ValueError, match="src on"):
        slab_sweep(cur2, cur2.clone(), plan2, src=cur2.cpu())


def _cheby_coeffs(shape, k, dual, smoother):
    """The multigrid fine level's coefficients: k sweeps, the last the
    residual in dual mode."""
    h = 1.0 / (shape[0] + 1)
    nu = k - 1 if dual else k
    if smoother == "chebyshev":
        co = _cheby_sweep_coeffs(nu, 4.0, 3, h)
    else:
        w = 2.0 / 3.0
        co = ((1.0 - w, w / 6, 0.0, -(w / 6) * h * h),) * nu
    if dual:
        co += ((6.0 / h ** 2, -1.0 / h ** 2, 0.0, 1.0),)
    return co


@pytest.mark.parametrize("shape,k,dual,smoother", [
    ((64, 48, 40), 2, False, "chebyshev"), ((57, 50, 46), 4, False,
                                            "chebyshev"),
    ((33, 20, 41), 1, False, "chebyshev"), ((64, 48, 40), 3, True,
                                            "wjacobi"),
    ((57, 50, 46), 5, True, "chebyshev"), ((31, 31, 31), 3, True,
                                           "chebyshev")])
def test_cheby_modes_match_plain(cuda_device, shape, k, dual, smoother):
    plan = make_tiled_plan(nbsum_spec(3), shape, "float32", k,
                           has_source=True,
                           cheby_coeffs=_cheby_coeffs(shape, k, dual,
                                                      smoother),
                           cheby_dual=dual)
    cur = plan.layout.pad_grid(_grid(shape, 1, cuda_device))
    src = pad_source(plan, _source(shape), 1.0, BC3).to(cuda_device)
    before = (tiled_sweep.cheby_launches, tiled_sweep.dual_launches)
    if dual:
        got = tiled_sweep(cur, cur.clone(), plan, src, out2=cur.clone())
    else:
        got = (tiled_sweep(cur, cur.clone(), plan, src),)
    want = sweep_reference(cur, plan, src)
    want = want if dual else (want,)
    torch.cuda.synchronize()
    assert (tiled_sweep.cheby_launches, tiled_sweep.dual_launches) == (
        before[0] + (not dual), before[1] + dual)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_cheby_iterate_with_remainder_matches_plain(cuda_device):
    shape = (40, 36, 44)
    co = _cheby_coeffs(shape, 3, False, "chebyshev")
    f = _source(shape)
    g = _grid(shape, 1, cuda_device)
    got = TiledStencil(nbsum_spec(3), shape, sweeps_per_call=3,
                       device=cuda_device, source=f,
                       cheby_coeffs=co).iterate(g, 7)
    want = TiledStencil(nbsum_spec(3), shape, sweeps_per_call=3,
                        device="cpu", source=f, cheby_coeffs=co).iterate(
        HaloGrid(data=g.data.cpu(), halo=1, bc=g.bc), 7)
    assert torch.equal(got.data.cpu(), want.data)


@pytest.mark.parametrize("smoother,nu", [("chebyshev", 2), ("wjacobi", 4)])
def test_multigrid_tiled_fine_matches_eager(cuda_device, smoother, nu):
    prob = PoissonProblem(shape=(31, 31, 31), device=cuda_device)
    f = _source(prob.shape).astype(np.float32)
    kw = dict(smoother=smoother, nu1=nu, nu2=nu)
    tiled_sweep.reset_counts()
    got = Multigrid(prob, fine_method="tiled", **kw).runner(f).iterate(
        prob.initial_grid(), 3)
    assert tiled_sweep.dual_launches == 3
    want = Multigrid(prob, **kw).runner(f).iterate(prob.initial_grid(), 3)
    assert (got.data - want.data).abs().max().item() < 5e-6


# ---- the two-level (B1d) and coefficient (B1e) modes ---------------------


@pytest.mark.parametrize("shape,k", [
    ((64, 48, 40), 8), ((57, 50, 46), 3), ((33, 20, 41), 1),
    ((40, 36, 44), 2)])
def test_two_level_matches_plain(cuda_device, shape, k):
    from stencil_tpu_torch.models.wave import WaveEquation

    wave = WaveEquation(shape=shape, dt=0.5, device=cuda_device)
    plan = make_tiled_plan(wave.spec, shape, "float32", k, two_level=True)
    cur = plan.layout.pad_grid(_grid(shape, 1, cuda_device, seed=1))
    prev = plan.layout.pad_grid(_grid(shape, 1, cuda_device, seed=3))
    before = tiled_sweep.two_level_launches
    got = tiled_sweep(cur, cur.clone(), plan, prev=prev, out2=prev.clone())
    want = sweep_reference(cur, plan, prev=prev)
    torch.cuda.synchronize()
    assert tiled_sweep.two_level_launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wave_tiled_with_remainder_matches_eager(cuda_device):
    from stencil_tpu_torch.models.wave import WaveEquation

    shape = (40, 36, 44)
    wave = WaveEquation(shape=shape, device=cuda_device)
    rng = np.random.default_rng(4)
    prev, cur = wave.initial_pair(rng.normal(size=shape),
                                  rng.normal(size=shape))
    got = wave.simulate(prev, cur, 11, method="tiled", sweeps_per_call=4)
    want = wave.simulate(prev, cur, 11, method="eager")
    for g, w in zip(got, want):
        assert torch.equal(g.data, w.data)


def _coeff_field(shape, seed=5):
    return np.random.default_rng(seed).uniform(0.01, 1.0, size=shape)


@pytest.mark.parametrize("shape,k,scales", [
    ((64, 48, 40), 8, (0.125, 1.0, -0.125)),
    ((57, 50, 46), 3, (0.125, 1.0, -0.125)),
    ((33, 20, 41), 1, (-1156.0, 0.0, 1156.0))])
def test_coeff_matches_plain(cuda_device, shape, k, scales):
    from stencil_tpu_torch.ops.tiled import coeff_operand, pad_coeff

    plan = make_tiled_plan(get_spec("jacobi7"), shape, "float32", k,
                           coeff_scales=scales)
    cur = plan.layout.pad_grid(_grid(shape, 1, cuda_device))
    coeff = coeff_operand(plan, pad_coeff(plan, _coeff_field(shape),
                                          BC3).to(cuda_device))
    before = tiled_sweep.coeff_launches
    got = tiled_sweep(cur, cur.clone(), plan, coeff=coeff)
    want = sweep_reference(cur, plan, coeff=coeff)
    torch.cuda.synchronize()
    assert tiled_sweep.coeff_launches == before + 1
    assert torch.equal(got, want)


def test_coeff_apply_reads_the_ghost_ring(cuda_device):
    """The k=1 matvec on a halo-1 input with a random ghost ring equals
    the eager field matvec to fp32 rounding (the two form the weights in
    another precision)."""
    from stencil_tpu_torch.models.diffusion import (
        HeterogeneousPoissonProblem,
    )

    shape = (31, 30, 29)
    a = _coeff_field(shape)
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=tuple(n + 2 for n in shape)).astype(np.float32)).to(cuda_device)
    kernel = HeterogeneousPoissonProblem(shape=shape, a=a, kernel="pallas",
                                         device=cuda_device)
    eager_ = HeterogeneousPoissonProblem(shape=shape, a=a,
                                         device=cuda_device)
    got = kernel.operator_apply(x, kernel.operator_data())
    want = eager_.operator_apply(x, eager_.operator_data())
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() < 1e-5 * scale


# ---- dynamic walls: the kernels' pins (periodic and Neumann faces) ---------


def _walls(ndim, periodic=(), neumann=()):
    bc = BC3 if ndim == 3 else BC2
    return bc.with_periodic(periodic).with_neumann(neumann)


def _refreshed(plan, bc, shape, radius, device, seed=1):
    """A random grid with ``bc`` in ``plan``'s layout, its dynamic ghosts
    refreshed to the launch's depth, as the runners hand it to a launch."""
    from stencil_tpu_torch.ops.layout import refresh_dynamic_layout

    cur = plan.layout.pad_grid(_grid(shape, radius, device, seed, bc))
    return refresh_dynamic_layout(cur, plan.layout, bc, plan.halo)


@pytest.mark.parametrize("name,shape,k,periodic,neumann", [
    ("jacobi7", (64, 48, 40), 8, (0, 1), ()),
    ("jacobi7", (64, 48, 40), 8, (), (0, 1)),
    ("jacobi7", (57, 50, 46), 3, (0,), (1,)),
    ("jacobi27", (33, 20, 41), 4, (1,), (0,)),
    ("laplace3d_ho", (30, 31, 32), 4, (0, 1), ()),
    ("jacobi7", (21, 30, 19), 1, (0, 1, 2), ())])
def test_kernel_pins_match_plain(cuda_device, name, shape, k, periodic,
                                 neumann):
    from stencil_tpu_torch.ops.tiled import dynamic_pins

    sp = get_spec(name)
    bc = _walls(3, periodic, neumann)
    plan = make_tiled_plan(sp, shape, "float32", k)
    cur = _refreshed(plan, bc, shape, sp.radius, cuda_device)
    pins = dynamic_pins(bc, 3)
    before = tiled_sweep.pins_launches
    got = tiled_sweep(cur, cur.clone(), plan, pins=pins)
    want = sweep_reference(cur, plan, pins=pins)
    torch.cuda.synchronize()
    assert tiled_sweep.pins_launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,k,periodic,neumann", [
    ((64, 48, 40), 8, (0, 1), ()), ((57, 50, 46), 3, (0,), (1,))])
def test_tiled_source_pins_match_plain(cuda_device, shape, k, periodic,
                                       neumann):
    from stencil_tpu_torch.ops.tiled import dynamic_pins

    sp = get_spec("jacobi7")
    bc = _walls(3, periodic, neumann)
    plan = make_tiled_plan(sp, shape, "float32", k)
    cur = _refreshed(plan, bc, shape, 1, cuda_device)
    src = pad_source(plan, _source(shape), -0.01, bc).to(cuda_device)
    pins = dynamic_pins(bc, 3)
    before = tiled_sweep.source_pins_launches
    got = tiled_sweep(cur, cur.clone(), plan, src, pins)
    want = sweep_reference(cur, plan, src, pins=pins)
    torch.cuda.synchronize()
    assert tiled_sweep.source_pins_launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,k,periodic,neumann", [
    ((64, 48, 40), 8, (0,), (1,)), ((57, 50, 46), 3, (0, 1), ()),
    ((33, 20, 41), 1, (), (0, 1))])
def test_two_level_pins_match_plain(cuda_device, shape, k, periodic,
                                    neumann):
    from stencil_tpu_torch.models.wave import WaveEquation
    from stencil_tpu_torch.ops.tiled import dynamic_pins

    wave = WaveEquation(shape=shape, dt=0.5, device=cuda_device)
    bc = _walls(3, periodic, neumann)
    plan = make_tiled_plan(wave.spec, shape, "float32", k, two_level=True)
    cur = _refreshed(plan, bc, shape, 1, cuda_device, seed=1)
    prev = _refreshed(plan, bc, shape, 1, cuda_device, seed=3)
    pins = dynamic_pins(bc, 3)
    before = tiled_sweep.two_level_pins_launches
    got = tiled_sweep(cur, cur.clone(), plan, pins=pins, prev=prev,
                      out2=prev.clone())
    want = sweep_reference(cur, plan, prev=prev, pins=pins)
    torch.cuda.synchronize()
    assert tiled_sweep.two_level_pins_launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("shape,k,periodic,neumann", [
    ((64, 48, 40), 8, (0, 1), ()), ((57, 50, 46), 3, (1,), (0,))])
def test_coeff_pins_match_plain(cuda_device, shape, k, periodic, neumann):
    from stencil_tpu_torch.ops.tiled import (
        coeff_operand, dynamic_pins, pad_coeff,
    )

    bc = _walls(3, periodic, neumann)
    plan = make_tiled_plan(get_spec("jacobi7"), shape, "float32", k,
                           coeff_scales=(0.125, 1.0, -0.125))
    cur = _refreshed(plan, bc, shape, 1, cuda_device)
    coeff = coeff_operand(plan, pad_coeff(plan, _coeff_field(shape),
                                          bc).to(cuda_device))
    pins = dynamic_pins(bc, 3)
    before = tiled_sweep.coeff_pins_launches
    got = tiled_sweep(cur, cur.clone(), plan, pins=pins, coeff=coeff)
    want = sweep_reference(cur, plan, coeff=coeff, pins=pins)
    torch.cuda.synchronize()
    assert tiled_sweep.coeff_pins_launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("name,shape,k,t0,periodic,neumann,source", [
    ("jacobi5", (512, 512), 16, None, (0,), (), False),
    ("jacobi5", (512, 512), 16, None, (), (0,), False),
    ("jacobi9", (600, 700), 4, 256, (0,), (), False),
    ("star2d_r2", (250, 333), 3, None, (), (0,), False),
    ("jacobi5", (70, 33), 1, None, (0, 1), (), False),
    ("jacobi5", (300, 257), 4, None, (0,), (), True)])
def test_slab_pins_match_plain(cuda_device, name, shape, k, t0, periodic,
                               neumann, source):
    from stencil_tpu_torch.ops.tiled import dynamic_pins

    sp = get_spec(name)
    bc = _walls(2, periodic, neumann)
    plan = make_slab_plan(sp, shape, "float32", k, t0_fixed=t0)
    cur = _refreshed(plan, bc, shape, sp.radius, cuda_device)
    src = pad_source(plan, _source(shape), -0.01, bc).to(cuda_device) \
        if source else None
    pins = dynamic_pins(bc, 2)
    count = "source_pins_launches" if source else "pins_launches"
    before = getattr(slab_sweep, count)
    got = slab_sweep(cur, cur.clone(), plan, src, pins)
    want = sweep_reference(cur, plan, src, pins=pins)
    torch.cuda.synchronize()
    assert getattr(slab_sweep, count) == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("name,shape,periodic,neumann,source", [
    ("jacobi27", (40, 36, 44), (0, 1), (), False),
    ("jacobi7", (21, 30, 19), (0,), (1,), True),
    ("jacobi5", (61, 75), (0,), (), True),
    ("jacobi9", (64, 80), (), (0,), False)])
def test_pins_iterate_with_remainder_matches_eager(cuda_device, name, shape,
                                                   periodic, neumann,
                                                   source):
    """The runners (11 iterations at k=4: two launches and a remainder,
    each after a refresh) against the eager iterate: bitwise on periodic
    walls; on a Neumann face within 1e-6 of the largest value, where a
    live ghost sums the mirrored taps in another order than the interior
    point it mirrors."""
    sp = get_spec(name)
    g = _grid(shape, 1, cuda_device, bc=_walls(len(shape), periodic,
                                               neumann))
    f = _source(shape) if source else None
    stencil = SlabStencil if len(shape) == 2 else TiledStencil
    got = stencil(sp, shape, sweeps_per_call=4, device=cuda_device,
                  source=f, source_scale=-0.02).iterate(g, 11)
    scaled = None if f is None else \
        torch.from_numpy(f).float().to(cuda_device) * float(np.float32(-0.02))
    want = eager.iterate(g, sp, 11, scaled)
    if neumann:
        assert (got.data - want.data).abs().max().item() \
            <= 1e-6 * want.data.abs().max().item()
    else:
        assert torch.equal(got.data, want.data)


def test_wave_pins_with_remainder_matches_eager(cuda_device):
    from stencil_tpu_torch.models.wave import WaveEquation

    shape = (40, 36, 44)
    wave = WaveEquation(shape=shape, bc=_walls(3, (0,), (1,)),
                        device=cuda_device)
    rng = np.random.default_rng(4)
    prev, cur = wave.initial_pair(rng.normal(size=shape),
                                  rng.normal(size=shape))
    before = tiled_sweep.two_level_pins_launches
    got = wave.simulate(prev, cur, 11, method="tiled", sweeps_per_call=4)
    assert tiled_sweep.two_level_pins_launches == before + 3
    want = wave.simulate(prev, cur, 11, method="eager")
    for g, w in zip(got, want):
        assert (g.data - w.data).abs().max().item() \
            <= 1e-6 * w.data.abs().max().item()


# ---- bfloat16: every mode but the coefficient one ---------------------------


def _bf16(t):
    return t.to(torch.bfloat16)


def _bf16_input(plan, shape, radius, device, bc=None, seed=1, tiny=False):
    """A bf16 padded input of ``plan`` with ``bc`` (refreshed when dynamic):
    random values, or with ``tiny`` values near 0 (fp32 subnormals and
    signed zeros), where the rounding after each op meets the subnormal
    range."""
    from stencil_tpu_torch.ops.layout import refresh_dynamic_layout

    bc = bc if bc is not None else (BC3 if len(shape) == 3 else BC2)
    x = np.random.default_rng(seed).random(shape).astype(np.float32)
    if tiny:
        x = (x - 0.5) * np.float32(1e-37)
        x[::3] = 0.0
        x[1::5] = -0.0
        bc = DirichletBC(values=((1e-38, -1e-39),) * len(shape),
                         periodic=bc.periodic, neumann=bc.neumann)
    g = HaloGrid.from_interior(_bf16(torch.from_numpy(x)), halo=radius,
                               bc=bc, device=device)
    return refresh_dynamic_layout(plan.layout.pad_grid(g), plan.layout, bc,
                                  plan.halo)


@pytest.mark.parametrize("name,shape,k,periodic,neumann,tiny", [
    ("jacobi7", (64, 48, 40), 8, (), (), False),
    ("jacobi7", (57, 50, 46), 3, (), (), False),
    ("jacobi7", (57, 50, 46), 3, (), (), True),
    ("jacobi27", (33, 20, 41), 4, (), (), False),
    ("laplace3d_ho", (30, 31, 32), 4, (), (), False),
    ("star3d_r2", (30, 31, 32), 2, (), (), False),
    ("heat3d", (29, 18, 35), 3, (), (), False),
    ("jacobi7", (64, 48, 40), 8, (0, 1), (), False),
    ("jacobi7", (57, 50, 46), 3, (0,), (1,), True),
    ("laplace3d_ho", (30, 31, 32), 4, (), (0, 1), False)])
def test_bf16_kernel_matches_plain(cuda_device, name, shape, k, periodic,
                                   neumann, tiny):
    from stencil_tpu_torch.ops.tiled import dynamic_pins

    sp = HeatDiffusion((8, 8, 8), dt=0.1).spec if name == "heat3d" \
        else get_spec(name)
    bc = _walls(3, periodic, neumann)
    plan = make_tiled_plan(sp, shape, "bfloat16", k)
    cur = _bf16_input(plan, shape, sp.radius, cuda_device, bc, tiny=tiny)
    pins = dynamic_pins(bc, 3)
    before = (tiled_sweep.bf16_launches, tiled_sweep.pins_launches)
    got = tiled_sweep(cur, cur.clone(), plan, pins=pins)
    want = sweep_reference(cur, plan, pins=pins)
    torch.cuda.synchronize()
    assert (tiled_sweep.bf16_launches, tiled_sweep.pins_launches) == (
        before[0] + 1, before[1] + (not all(pins)))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,k,periodic,neumann,tiny", [
    ((64, 48, 40), 8, (), (), False), ((57, 50, 46), 3, (), (), True),
    ((57, 50, 46), 3, (0,), (1,), False)])
def test_bf16_tiled_source_matches_plain(cuda_device, shape, k, periodic,
                                         neumann, tiny):
    from stencil_tpu_torch.ops.tiled import dynamic_pins

    bc = _walls(3, periodic, neumann)
    plan = make_tiled_plan(get_spec("jacobi7"), shape, "bfloat16", k)
    cur = _bf16_input(plan, shape, 1, cuda_device, bc, tiny=tiny)
    src = pad_source(plan, _source(shape) * (1e-37 if tiny else 1.0), -0.01,
                     bc).to(cuda_device)
    assert src.dtype == torch.bfloat16
    pins = dynamic_pins(bc, 3)
    got = tiled_sweep(cur, cur.clone(), plan, src, pins)
    want = sweep_reference(cur, plan, src, pins=pins)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,k,dual,smoother", [
    ((64, 48, 40), 2, False, "chebyshev"), ((57, 50, 46), 4, False,
                                            "chebyshev"),
    ((64, 48, 40), 3, True, "wjacobi"), ((57, 50, 46), 5, True,
                                         "chebyshev")])
def test_bf16_cheby_modes_match_plain(cuda_device, shape, k, dual,
                                      smoother):
    plan = make_tiled_plan(nbsum_spec(3), shape, "bfloat16", k,
                           has_source=True,
                           cheby_coeffs=_cheby_coeffs(shape, k, dual,
                                                      smoother),
                           cheby_dual=dual)
    cur = _bf16_input(plan, shape, 1, cuda_device)
    src = pad_source(plan, _source(shape), 1.0, BC3).to(cuda_device)
    if dual:
        got = tiled_sweep(cur, cur.clone(), plan, src, out2=cur.clone())
    else:
        got = (tiled_sweep(cur, cur.clone(), plan, src),)
    want = sweep_reference(cur, plan, src)
    want = want if dual else (want,)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("shape,k,periodic,neumann", [
    ((64, 48, 40), 8, (), ()), ((33, 20, 41), 1, (), ()),
    ((57, 50, 46), 3, (0,), (1,))])
def test_bf16_two_level_matches_plain(cuda_device, shape, k, periodic,
                                      neumann):
    from stencil_tpu_torch.models.wave import WaveEquation
    from stencil_tpu_torch.ops.tiled import dynamic_pins

    wave = WaveEquation(shape=shape, dt=0.5, device=cuda_device)
    bc = _walls(3, periodic, neumann)
    plan = make_tiled_plan(wave.spec, shape, "bfloat16", k, two_level=True)
    cur = _bf16_input(plan, shape, 1, cuda_device, bc, seed=1)
    prev = _bf16_input(plan, shape, 1, cuda_device, bc, seed=3)
    pins = dynamic_pins(bc, 3)
    got = tiled_sweep(cur, cur.clone(), plan, pins=pins, prev=prev,
                      out2=prev.clone())
    want = sweep_reference(cur, plan, prev=prev, pins=pins)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name,shape,k,t0,periodic,source,tiny", [
    ("jacobi5", (512, 512), 16, None, (), False, False),
    ("jacobi5", (32, 40), 2, None, (), False, True),
    ("jacobi9", (600, 700), 4, 256, (), False, False),
    ("star2d_r2", (250, 333), 3, None, (), False, False),
    ("jacobi5", (300, 257), 4, None, (), True, False),
    ("jacobi5", (512, 512), 16, None, (0,), False, False),
    ("jacobi9", (64, 80), 8, None, (0,), True, False)])
def test_bf16_slab_matches_plain(cuda_device, name, shape, k, t0, periodic,
                                 source, tiny):
    from stencil_tpu_torch.ops.tiled import dynamic_pins

    sp = get_spec(name)
    bc = _walls(2, periodic)
    plan = make_slab_plan(sp, shape, "bfloat16", k, t0_fixed=t0)
    cur = _bf16_input(plan, shape, sp.radius, cuda_device, bc, tiny=tiny)
    src = pad_source(plan, _source(shape), -0.01, bc).to(cuda_device) \
        if source else None
    pins = dynamic_pins(bc, 2)
    before = slab_sweep.bf16_launches
    got = slab_sweep(cur, cur.clone(), plan, src, pins)
    want = sweep_reference(cur, plan, src, pins=pins)
    torch.cuda.synchronize()
    assert slab_sweep.bf16_launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("name,shape,periodic,source", [
    ("jacobi27", (40, 36, 44), (), False), ("jacobi7", (21, 30, 19), (0,),
                                            True),
    ("jacobi5", (61, 75), (0,), True), ("jacobi9", (64, 80), (), False)])
def test_bf16_iterate_with_remainder_matches_eager(cuda_device, name, shape,
                                                   periodic, source):
    """The bf16 runners over a remainder against the eager bf16 iterate,
    bitwise: both round every op to bf16 in the same order."""
    from stencil_tpu_torch.ops.eager import round_to

    sp = get_spec(name)
    bc = _walls(len(shape), periodic)
    x = np.random.default_rng(1).random(shape).astype(np.float32)
    g = HaloGrid.from_interior(_bf16(torch.from_numpy(x)), halo=1, bc=bc,
                               device=cuda_device)
    f = _source(shape) if source else None
    stencil = SlabStencil if len(shape) == 2 else TiledStencil
    got = stencil(sp, shape, "bfloat16", sweeps_per_call=4,
                  device=cuda_device, source=f,
                  source_scale=-0.02).iterate(g, 11)
    scaled = None if f is None else \
        _bf16(torch.from_numpy(f)).to(cuda_device) \
        * round_to(-0.02, torch.bfloat16)
    want = eager.iterate(g, sp, 11, scaled)
    assert got.data.dtype == torch.bfloat16
    assert torch.equal(got.data, want.data)


def test_bf16_refuses_coeff_and_a_dtype_mix(cuda_device):
    sp = get_spec("jacobi7")
    with pytest.raises(ValueError, match="4-byte dtype"):
        make_tiled_plan(sp, (16, 16, 16), "bfloat16",
                        coeff_scales=(0.1, 1.0, -0.1))
    plan = make_tiled_plan(sp, (8, 8, 8), "bfloat16", 2)
    cur = plan.layout.pad_grid(_grid((8, 8, 8), 1, cuda_device))
    with pytest.raises(ValueError, match="plan dtype"):
        tiled_sweep(cur, cur.clone(), plan)


# ---- B1f: tile subsets, and the sharded kernel path ------------------------


@pytest.mark.parametrize("name,shape,k,tiles,dtype,periodic,neumann,source", [
    ("jacobi7", (64, 48, 40), 8, (8, 16, 16), "float32", (), (), False),
    ("jacobi7", (57, 50, 46), 3, (8, 8, 16), "float32", (0,), (1,), True),
    ("jacobi27", (40, 36, 44), 2, None, "float32", (0, 1), (), False),
    ("star3d_r2", (48, 40, 32), 2, (8, 8, 16), "float32", (), (0,), True),
    ("jacobi7", (64, 48, 40), 8, (16, 16, 16), "bfloat16", (), (), False),
    ("jacobi7", (57, 50, 46), 3, (8, 8, 16), "bfloat16", (0,), (1,), True),
])
def test_subset_launches_match_plain(cuda_device, name, shape, k, tiles,
                                     dtype, periodic, neumann, source):
    """The interior launch, then the edge launch into the same output:
    each bitwise its plain version (the other columns untouched), the pair
    bitwise the full launch; live faces as a mesh's internal ones."""
    from stencil_tpu_torch.ops.sweep_kernel import subset_reference
    from stencil_tpu_torch.ops.tiled import dynamic_pins, partition_tiles

    sp = get_spec(name)
    bc = _walls(3, periodic, neumann)
    plan = make_tiled_plan(sp, shape, dtype, k, tiles=tiles,
                           has_source=source)
    cur = _bf16_input(plan, shape, sp.radius, cuda_device, bc) \
        if dtype == "bfloat16" else _refreshed(plan, bc, shape, sp.radius,
                                               cuda_device)
    nxt = cur.clone()
    nxt[plan.layout.interior_index] = -1.0
    src = pad_source(plan, _source(shape), -0.02, bc).to(cuda_device) \
        if source else None
    pins = dynamic_pins(bc, 3)
    interior, edge = partition_tiles(plan)
    assert interior and edge
    before = (tiled_sweep.subset_launches, tiled_sweep.source_subset_launches)
    part = tiled_sweep(cur, nxt.clone(), plan, src, pins, subset=interior)
    want_part = subset_reference(cur, nxt, plan, interior, src, pins=pins)
    torch.cuda.synchronize()
    assert torch.equal(part, want_part)
    got = tiled_sweep(cur, part.clone(), plan, src, pins, subset=edge)
    want = subset_reference(cur, want_part, plan, edge, src, pins=pins)
    full = tiled_sweep(cur, nxt.clone(), plan, src, pins)
    torch.cuda.synchronize()
    assert tiled_sweep.subset_launches == before[0] + 2
    assert tiled_sweep.source_subset_launches == before[1] + 2 * source
    assert torch.equal(got, want)
    assert torch.equal(got, full)


@pytest.mark.parametrize("sizes,dtype,periodic,neumann", [
    ((2, 2), "float32", (), ()), ((4,), "float32", (0,), (1,)),
    ((2, 2), "bfloat16", (0,), ()), ((2, 2), "float32", (), (0, 1))])
def test_sharded_pallas_matches_tiled(cuda_device, sizes, dtype, periodic,
                                      neumann):
    """``sharded_pallas`` on a mesh whose ranks share the card: the
    interior and edge launches around the in-place exchange on its side
    stream, bitwise the single-device tiled iterate (also the race check
    of the exchange against the interior launch)."""
    from stencil_tpu_torch.parallel.mesh import make_mesh
    from stencil_tpu_torch.parallel.sharded_kernel import (
        ShardedKernelStencil,
    )

    sp = get_spec("jacobi7")
    shape, k, iters = (128, 96, 64), 4, 19
    bc = _walls(3, periodic, neumann)
    x = np.random.default_rng(4).random(shape).astype(np.float32)
    g = HaloGrid.from_interior(torch.from_numpy(x).to(getattr(torch, dtype)),
                               halo=1, bc=bc, device=cuda_device)
    axes = ("x", "y")[:len(sizes)]
    method = ShardedKernelStencil(sp, shape, axis_names=axes, dtype=dtype,
                                  sweeps_per_call=k, tiles=(8, 8, 16))
    mesh = make_mesh(sizes, axes, device=cuda_device)
    tiled_sweep.reset_counts()
    got = method.iterate(g, iters, mesh)
    n_launch = (iters // k + 1) * mesh.size
    assert tiled_sweep.subset_launches == 2 * n_launch
    want = TiledStencil(sp, shape, dtype, sweeps_per_call=k,
                        device=cuda_device).iterate(g, iters)
    torch.cuda.synchronize()
    assert torch.equal(got.data, want.data)


# ---- B3: the in-kernel halo exchange (csrc/rma_iterate.cu) ------------------

RMA_CASES = [  # spec, global shape, mesh, k, iterations
    ("jacobi7", (64, 64, 128), (1,), 2, 8),
    ("jacobi7", (64, 64, 128), (2,), 2, 8),
    ("jacobi7", (64, 64, 128), (2, 2), 2, 8),
    ("box3", (32, 64, 40), (2, 4), 2, 6),
    ("star3_r2", (32, 32, 20), (2, 2), 2, 6),
    ("jacobi5", (64, 40), (4,), 4, 10),
    ("jacobi5", (32, 256), (2, 2), 2, 7),
    ("jacobi7", (48, 40, 36), (3, 2), 3, 7),
]


def _card_mesh(sizes, device):
    """A mesh of ``sizes`` with every rank on ``device`` (``make_mesh``
    spreads the ranks over every visible card)."""
    from stencil_tpu_torch.parallel.mesh import Mesh

    return Mesh(shape=tuple(sizes), axis_names=("x", "y")[:len(sizes)],
                devices=(device,) * int(np.prod(sizes)))


def _rma_spec(name):
    from stencil_tpu_torch.core.spec import box, star

    if name == "box3":
        return box(3, 1)
    if name == "star3_r2":
        return star(3, 2)
    return get_spec(name)


@pytest.mark.parametrize("name,shape,sizes,k,iters", RMA_CASES)
def test_rma_kernel_matches_plain(cuda_device, name, shape, sizes, k, iters):
    """One launch of ``iters // k`` steps (and one of the remainder) on
    every rank's buffers: both slots bitwise the plain version's on the
    same inputs (the kernel runs the sweeps between in shared memory and
    leaves the compute buffers alone); then ``RmaStencil.iterate`` makes
    one launch (plus one for a remainder) and is bitwise the
    single-device eager iterate."""
    from stencil_tpu_torch.parallel.rma import (
        RmaStencil, rma_iterate, rma_iterate_reference,
    )

    sp = _rma_spec(name)
    g = _grid(shape, sp.radius, cuda_device)
    mesh = _card_mesh(sizes, cuda_device)
    method = RmaStencil(sp, shape, sweeps_per_call=k)
    plan = method.plan_for(mesh)
    n_outer, rem = divmod(iters, k)
    bufs = method.scatter(g, mesh, plan)
    want = bufs.clone()
    rma_iterate.reset_counts()
    rma_iterate(bufs, plan, n_outer)
    rma_iterate_reference(want, plan, n_outer)
    if rem:
        rma_iterate(bufs, plan.with_sweeps(rem), 1, n_outer % 2)
        rma_iterate_reference(want, plan.with_sweeps(rem), 1, n_outer % 2)
    torch.cuda.synchronize()
    assert rma_iterate.launches == 1 + bool(rem)
    assert torch.equal(bufs[:, :2], want[:, :2])
    rma_iterate.reset_counts()
    got = method.iterate(g, iters, mesh)
    torch.cuda.synchronize()
    assert rma_iterate.launches == 1 + bool(rem)
    assert torch.equal(got.interior(), eager.iterate(g, sp, iters).interior())


def test_rma_budget_refusal_before_any_launch(cuda_device):
    """160^3 at k=2 on one rank is 3 x 164^3 x 4 B > the card's L2."""
    from stencil_tpu_torch.parallel.mesh import make_mesh
    from stencil_tpu_torch.parallel.rma import RmaStencil, rma_iterate

    shape = (160, 160, 160)
    g = HaloGrid.create(shape, halo=1, device=cuda_device)
    rma_iterate.reset_counts()
    with pytest.raises(ValueError, match="exceeds the L2-resident budget"):
        RmaStencil(get_spec("jacobi7"), shape, sweeps_per_call=2).iterate(
            g, 4, make_mesh((1,), ("x",), device=cuda_device))
    assert rma_iterate.launches == 0


RMA_PINS_CASES = [  # spec, global shape, mesh, k, iterations, periodic,
    # neumann, dtype
    ("jacobi7", (64, 64, 128), (2, 2), 2, 7, (0, 1), (), "float32"),
    ("jacobi7", (64, 64, 128), (2,), 2, 7, (), (0, 1), "float32"),
    ("jacobi27", (32, 32, 40), (2,), 3, 7, (0,), (1,), "float32"),
    ("jacobi7", (32, 32, 40), (1,), 2, 5, (0,), (), "float32"),  # ring of 1
    ("star3_r2", (32, 32, 20), (2, 2), 2, 5, (1,), (0,), "float32"),
    ("jacobi5", (64, 40), (4,), 4, 10, (), (0,), "float32"),
    ("jacobi5", (32, 256), (2, 2), 2, 7, (0,), (), "float32"),
    ("jacobi7", (64, 64, 128), (1,), 2, 7, (), (), "bfloat16"),
    ("jacobi7", (64, 64, 128), (2, 2), 2, 7, (0,), (1,), "bfloat16"),
    ("jacobi27", (32, 32, 40), (2,), 3, 7, (), (0, 1), "bfloat16"),
    ("jacobi5", (64, 40), (4,), 2, 5, (0,), (), "bfloat16"),
]


@pytest.mark.parametrize("name,shape,sizes,k,iters,periodic,neumann,dtype",
                         RMA_PINS_CASES)
def test_rma_kernel_matches_plain_on_dynamic_walls_and_bf16(
        cuda_device, name, shape, sizes, k, iters, periodic, neumann, dtype):
    """Rings (of 1, 2 and more), Neumann mirrors, the local refresh of an
    unsharded dynamic d1 and mixed walls, fp32 and bf16, distinct face
    values: one launch of ``iters // k`` steps and one of the remainder,
    both slots bitwise the plain version's; the counts of
    pins and bf16 launches; ``RmaStencil.iterate`` bitwise the same
    launches' result."""
    from stencil_tpu_torch.parallel.rma import (
        RmaStencil, rma_iterate, rma_iterate_reference,
    )

    sp = _rma_spec(name)
    bc = (BC3 if len(shape) == 3 else BC2)
    if periodic:
        bc = bc.with_periodic(periodic)
    if neumann:
        bc = bc.with_neumann(neumann)
    g = _grid(shape, sp.radius, "cpu", bc=bc)
    g = HaloGrid.from_interior(g.interior().to(getattr(torch, dtype)),
                               halo=sp.radius, bc=bc, device=cuda_device)
    mesh = _card_mesh(sizes, cuda_device)
    method = RmaStencil(sp, shape, dtype, sweeps_per_call=k)
    plan = method.plan_for(mesh, bc)
    n_outer, rem = divmod(iters, k)
    bufs = method.scatter(g, mesh, plan)
    want = bufs.clone()
    rma_iterate.reset_counts()
    rma_iterate(bufs, plan, n_outer)
    rma_iterate_reference(want, plan, n_outer)
    if rem:
        rma_iterate(bufs, plan.with_sweeps(rem), 1, n_outer % 2)
        rma_iterate_reference(want, plan.with_sweeps(rem), 1, n_outer % 2)
    torch.cuda.synchronize()
    n = 1 + bool(rem)
    assert (rma_iterate.launches, rma_iterate.pins_launches,
            rma_iterate.bf16_launches) == (
        n, n * bool(periodic or neumann), n * (dtype == "bfloat16"))
    assert torch.equal(bufs[:, :2], want[:, :2])
    got = method.iterate(g, iters, mesh)
    slot = (n_outer + bool(rem)) % 2
    torch.cuda.synchronize()
    assert torch.equal(got.interior(), method.gather(
        bufs, slot, mesh, plan, g).interior())


RMA_TILE_CASES = [  # spec, global shape, mesh, k, periodic, neumann, dtype,
    # tile (None: the plan's rule)
    ("jacobi7", (16, 12, 20), (1,), 2, (), (), "float32", (3, 5, 8)),
    ("jacobi7", (16, 12, 20), (2,), 2, (), (), "float32", (3, 5, 8)),
    ("jacobi7", (16, 12, 20), (2, 2), 2, (), (), "float32", (3, 5, 8)),
    ("jacobi7", (16, 24, 20), (2, 4), 2, (), (), "float32", (4, 3, 7)),
    ("jacobi7", (12, 12, 20), (1,), 2, (0, 1), (), "float32", (5, 5, 8)),
    ("jacobi7", (16, 12, 20), (2,), 2, (0,), (), "float32", (3, 5, 8)),
    ("jacobi7", (16, 12, 20), (2, 2), 2, (0, 1), (), "float32", (3, 5, 8)),
    ("jacobi7", (24, 12, 20), (4,), 2, (0,), (), "float32", (3, 5, 8)),
    ("jacobi7", (16, 12, 20), (2,), 2, (), (0, 1), "float32", (3, 5, 8)),
    ("jacobi7", (16, 12, 20), (2,), 2, (0,), (1,), "float32", (3, 5, 8)),
    ("star3_r2", (16, 16, 12), (2, 2), 2, (1,), (0,), "float32", (3, 5, 7)),
    ("jacobi27", (12, 16, 10), (2,), 3, (0,), (1,), "float32", (2, 5, 4)),
    ("jacobi5", (32, 20), (2,), 4, (), (0,), "float32", (5, 7)),
    ("jacobi7", (16, 12, 20), (2, 2), 2, (0,), (1,), "bfloat16", (3, 5, 8)),
    ("jacobi7", (64, 64, 128), (2, 2), 2, (), (), "float32", None),
    ("jacobi7", (64, 64, 128), (2,), 2, (), (1,), "bfloat16", None),
]


@pytest.mark.parametrize("name,shape,sizes,k,periodic,neumann,dtype,tile",
                         RMA_TILE_CASES)
def test_rma_tiles_match_plain_on_both_slots(cuda_device, name, shape, sizes,
                                             k, periodic, neumann, dtype,
                                             tile):
    """The tiled schedule at small tiles (many per rank, ragged ones
    included) and at the plan's own: 1, 2 and 3 steps from either slot and
    a remainder launch, both slots bitwise the plain version's on every
    wall kind, in fp32 and bf16."""
    from stencil_tpu_torch.parallel.rma import (
        RmaStencil, make_rma_plan, rma_iterate, rma_iterate_reference,
    )

    sp = _rma_spec(name)
    bc = (BC3 if len(shape) == 3 else BC2)
    if periodic:
        bc = bc.with_periodic(periodic)
    if neumann:
        bc = bc.with_neumann(neumann)
    g = _grid(shape, sp.radius, "cpu", bc=bc)
    g = HaloGrid.from_interior(g.interior().to(getattr(torch, dtype)),
                               halo=sp.radius, bc=bc, device=cuda_device)
    mesh = _card_mesh(sizes, cuda_device)
    method = RmaStencil(sp, shape, dtype, sweeps_per_call=k)
    base = method.plan_for(mesh, bc)
    plan = base if tile is None else make_rma_plan(
        sp, base.local_shape, dtype, sizes, k, bc=bc, tile=tile)
    for slot in (0, 1):
        for steps in (1, 2, 3):
            bufs = method.scatter(g, mesh, plan)
            want = bufs.clone()
            rma_iterate(bufs, plan, steps, slot)
            rma_iterate_reference(want, plan, steps, slot)
            rem = plan.with_sweeps(max(1, k - 1))
            rma_iterate(bufs, rem, 1, (slot + steps) % 2)
            rma_iterate_reference(want, rem, 1, (slot + steps) % 2)
            torch.cuda.synchronize()
            assert torch.equal(bufs[:, :2], want[:, :2]), (slot, steps)


@pytest.mark.parametrize("shape,sizes", [((64, 64, 128), (2, 2)),
                                         ((8, 8, 16), (1,))])
def test_rma_race_soak(cuda_device, shape, sizes):
    """50 launches of 256 steps each from the same buffers, each bitwise
    the plain version's: a race between the tiles' flags and their loads
    would show in one of them."""
    from stencil_tpu_torch.parallel.rma import (
        RmaStencil, rma_iterate, rma_iterate_reference,
    )

    sp = get_spec("jacobi7")
    g = _grid(shape, 1, cuda_device)
    mesh = _card_mesh(sizes, cuda_device)
    method = RmaStencil(sp, shape, sweeps_per_call=2)
    plan = method.plan_for(mesh)
    start = method.scatter(g, mesh, plan)
    want = rma_iterate_reference(start.clone(), plan, 256)[:, :2]
    bad = 0
    for _ in range(50):
        bufs = start.clone()
        rma_iterate(bufs, plan, 256)
        bad += not torch.equal(bufs[:, :2], want)
    torch.cuda.synchronize()
    assert bad == 0


RMA_CARDS_CASES = [  # spec, global shape, mesh, virtual cards, k,
    # iterations, periodic, neumann, dtype, tile (None: the plan's rule)
    ("jacobi7", (64, 64, 128), (2,), 2, 2, 7, (), (), "float32", None),
    ("jacobi7", (64, 64, 128), (2, 2), 2, 2, 7, (), (), "float32", None),
    ("jacobi7", (64, 64, 128), (2, 2), 4, 2, 7, (), (), "float32", None),
    ("jacobi7", (64, 64, 128), (4,), 4, 2, 7, (0,), (), "float32", None),
    ("jacobi7", (64, 64, 128), (2, 2), 4, 2, 7, (0, 1), (), "float32", None),
    ("jacobi7", (64, 64, 128), (2,), 2, 2, 7, (), (1,), "float32", None),
    ("jacobi7", (64, 64, 128), (2, 2), 4, 2, 7, (), (), "bfloat16", None),
    ("box3", (32, 64, 40), (2, 4), 4, 2, 6, (1,), (0,), "float32", None),
    ("jacobi5", (64, 40), (4,), 2, 4, 10, (), (0,), "float32", None),
    ("jacobi7", (16, 12, 20), (2, 2), 4, 2, 5, (0,), (1,), "float32",
     (3, 5, 8)),
    ("jacobi7", (16, 12, 20), (2,), 2, 2, 5, (), (1,), "bfloat16",
     (3, 5, 8)),
]


def _rma_walls(shape, periodic, neumann):
    bc = BC3 if len(shape) == 3 else BC2
    if periodic:
        bc = bc.with_periodic(periodic)
    if neumann:
        bc = bc.with_neumann(neumann)
    return bc


@pytest.mark.parametrize(
    "name,shape,sizes,cards,k,iters,periodic,neumann,dtype,tile",
    RMA_CARDS_CASES)
def test_rma_virtual_cards_match_plain_and_one_card(
        cuda_device, name, shape, sizes, cards, k, iters, periodic, neumann,
        dtype, tile):
    """The kernel across virtual cards (rank i on card i % G of the one
    device, one launch, the protocol's every instruction): from either
    slot, ``iters // k`` steps and a remainder launch, every rank's two
    slots bitwise the plain version's on the same cards and the one-card
    launch's; the counts; ``RmaStencil.iterate`` on virtual cards bitwise
    the one-card iterate; then 20 launches of 128 steps from the same
    buffers, each bitwise (a race across cards would show)."""
    from stencil_tpu_torch.parallel.rma import (
        RmaStencil, make_rma_plan, rma_iterate, rma_iterate_reference,
    )

    sp = _rma_spec(name)
    bc = _rma_walls(shape, periodic, neumann)
    g = _grid(shape, sp.radius, "cpu", bc=bc)
    g = HaloGrid.from_interior(g.interior().to(getattr(torch, dtype)),
                               halo=sp.radius, bc=bc, device=cuda_device)
    mesh = _card_mesh(sizes, cuda_device)
    method = RmaStencil(sp, shape, dtype, sweeps_per_call=k)
    one = method.plan_for(mesh, bc)
    plan = method.plan_for(mesh, bc, virtual_cards=cards)
    if tile is not None:
        one, plan = (make_rma_plan(sp, p.local_shape, dtype, sizes, k,
                                   bc=bc, tile=tile, cards=p.cards,
                                   virtual=p.virtual) for p in (one, plan))
    assert plan.ncards == cards and plan.virtual
    n_outer, rem = divmod(iters, k)
    for slot in (0, 1):
        got = method.scatter(g, mesh, plan)
        want = [p.clone() for p in got]
        single = method.scatter(g, mesh, one)
        rma_iterate.reset_counts()
        for p, bufs in ((plan, got), (one, single)):
            rma_iterate(bufs, p, n_outer, slot)
            if rem:
                rma_iterate(bufs, p.with_sweeps(rem), 1, (slot + n_outer) % 2)
        rma_iterate_reference(want, plan, n_outer, slot)
        if rem:
            rma_iterate_reference(want, plan.with_sweeps(rem), 1,
                                  (slot + n_outer) % 2)
        torch.cuda.synchronize()
        n = 1 + bool(rem)
        assert (rma_iterate.launches, rma_iterate.cards_launches) == (
            2 * n, n)
        for rank, (card, i) in enumerate(plan.places):
            assert torch.equal(got[card][i, :2], want[card][i, :2]), (slot,
                                                                     rank)
            assert torch.equal(got[card][i, :2], single[rank, :2]), (slot,
                                                                    rank)
    if tile is None:
        assert torch.equal(
            method.iterate(g, iters, mesh, virtual_cards=cards).interior(),
            method.iterate(g, iters, mesh).interior())
    start = method.scatter(g, mesh, plan)
    ref = rma_iterate_reference([p.clone() for p in start], plan, 128)
    bad = 0
    for _ in range(20):
        bufs = [p.clone() for p in start]
        rma_iterate(bufs, plan, 128)
        bad += not all(torch.equal(a[:, :2], b[:, :2])
                       for a, b in zip(bufs, ref))
    torch.cuda.synchronize()
    assert bad == 0


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs: rma across real cards")
    return torch.device("cuda", 0), torch.device("cuda", 1)


@pytest.mark.parametrize("sizes,periodic,dtype", [
    ((2,), (), "float32"), ((2, 2), (), "float32"),
    ((2, 2), (0, 1), "float32"), ((2, 2), (), "bfloat16")])
def test_rma_across_two_cards_matches_plain_and_one_card(
        two_cards, sizes, periodic, dtype):
    """A mesh over two real cards (``make_mesh``'s round robin: on (2, 2)
    d1's pushes cross cards, d0's do not): one cooperative launch per card
    with peer stores, every rank's slots bitwise the plain version's and
    the one-card launch's; ``RmaStencil.iterate`` bitwise ``tiled`` at the
    same k."""
    from stencil_tpu_torch.parallel.mesh import Mesh
    from stencil_tpu_torch.parallel.rma import (
        RmaStencil, rma_iterate, rma_iterate_reference,
    )

    shape, k, iters = (64, 64, 128), 2, 7
    sp = get_spec("jacobi7")
    bc = _rma_walls(shape, periodic, ())
    g = _grid(shape, 1, "cpu", bc=bc)
    g = HaloGrid.from_interior(g.interior().to(getattr(torch, dtype)),
                               halo=1, bc=bc, device=two_cards[0])
    n = int(np.prod(sizes))
    mesh = Mesh(shape=sizes, axis_names=("x", "y")[:len(sizes)],
                devices=tuple(two_cards[i % 2] for i in range(n)))
    one_mesh = Mesh(shape=sizes, axis_names=mesh.axis_names,
                    devices=(two_cards[0],) * n)
    method = RmaStencil(sp, shape, dtype, sweeps_per_call=k)
    plan = method.plan_for(mesh, bc)
    one = method.plan_for(one_mesh, bc)
    assert plan.ncards == 2 and not plan.virtual
    got = method.scatter(g, mesh, plan)
    assert [p.device for p in got] == list(two_cards)
    want = [p.clone() for p in got]
    single = method.scatter(g, one_mesh, one)
    rma_iterate.reset_counts()
    rma_iterate(got, plan, iters // k)
    rma_iterate(single, one, iters // k)
    rma_iterate_reference(want, plan, iters // k)
    for dev in two_cards:
        torch.cuda.synchronize(dev)
    assert rma_iterate.cards_launches == 1
    for rank, (card, i) in enumerate(plan.places):
        assert torch.equal(got[card][i, :2], want[card][i, :2]), rank
        assert torch.equal(got[card][i, :2].to(two_cards[0]),
                           single[rank, :2]), rank
    out = method.iterate(g, iters, mesh)
    ref = TiledStencil(sp, shape, dtype, sweeps_per_call=k,
                       device=two_cards[0]).iterate(g, iters)
    for dev in two_cards:
        torch.cuda.synchronize(dev)
    assert torch.equal(out.interior(), ref.interior())


# ---- the d0 march (csrc/tiled_march.cu) -------------------------------------


@pytest.mark.parametrize("name,shape,k,dtype,periodic,neumann,source", [
    ("jacobi7", (64, 48, 40), 1, "float32", (), (), False),
    ("jacobi7", (64, 48, 40), 2, "float32", (), (), True),
    ("jacobi7", (57, 50, 46), 3, "float32", (0, 1), (), False),
    ("jacobi7", (64, 48, 40), 8, "float32", (), (0, 1), True),
    ("jacobi27", (57, 50, 46), 3, "float32", (0,), (1,), False),
    ("star3d_r2", (57, 50, 46), 2, "float32", (), (), True),
    ("jacobi7", (64, 48, 40), 8, "bfloat16", (0, 1), (), False),
    ("jacobi27", (57, 50, 46), 2, "bfloat16", (), (), True),
    ("star3d_r2", (57, 50, 46), 3, "bfloat16", (), (0,), False)])
def test_march_matches_plain_and_window(cuda_device, name, shape, k, dtype,
                                        periodic, neumann, source):
    """One march launch bitwise its plain version and the window
    schedule's launch of the same sweeps, every count of its mode bumped
    once; a plain or source plan marches by default."""
    from stencil_tpu_torch.ops.tiled import dynamic_pins

    sp = get_spec(name)
    bc = _walls(3, periodic, neumann)
    plan = make_tiled_plan(sp, shape, dtype, k, has_source=source)
    window = make_tiled_plan(sp, shape, dtype, k, has_source=source,
                             schedule="window")
    assert plan.schedule == "march" and window.schedule == "window"
    cur = _bf16_input(plan, shape, sp.radius, cuda_device, bc) \
        if dtype == "bfloat16" else _refreshed(plan, bc, shape, sp.radius,
                                               cuda_device)
    src = pad_source(plan, _source(shape), -0.02, bc).to(cuda_device) \
        if source else None
    pins = dynamic_pins(bc, 3)
    tiled_sweep.reset_counts()
    got = tiled_sweep(cur, cur.clone(), plan, src, pins)
    torch.cuda.synchronize()
    live = not all(pins)
    assert (tiled_sweep.march_launches, tiled_sweep.march_source_launches,
            tiled_sweep.march_pins_launches,
            tiled_sweep.march_source_pins_launches,
            tiled_sweep.march_bf16_launches) == (
        1, source, live and not source, live and source,
        dtype == "bfloat16")
    want = sweep_reference(cur, plan, src, pins=pins)
    via_window = tiled_sweep(cur, cur.clone(), window, src, pins)
    torch.cuda.synchronize()
    assert tiled_sweep.march_launches == 1 and tiled_sweep.launches == 2
    assert torch.equal(got, want)
    assert torch.equal(got, via_window)


@pytest.mark.parametrize("dtype,source", [("float32", False),
                                          ("bfloat16", True)])
def test_march_subsets_pair_is_the_full_launch(cuda_device, dtype, source):
    """An interior then an edge subset launch of a march plan into one
    output, each bitwise its plain version, the pair the full launch."""
    from stencil_tpu_torch.ops.sweep_kernel import subset_reference
    from stencil_tpu_torch.ops.tiled import dynamic_pins, partition_tiles

    sp, shape, k = get_spec("jacobi7"), (96, 80, 72), 4
    bc = _walls(3, (0,), (1,))
    plan = make_tiled_plan(sp, shape, dtype, k, tiles=(16, 16, 32),
                           has_source=source)
    assert plan.schedule == "march"
    cur = _bf16_input(plan, shape, sp.radius, cuda_device, bc) \
        if dtype == "bfloat16" else _refreshed(plan, bc, shape, sp.radius,
                                               cuda_device)
    src = pad_source(plan, _source(shape), -0.02, bc).to(cuda_device) \
        if source else None
    nxt = cur.clone()
    nxt[plan.layout.interior_index] = -1.0
    pins = dynamic_pins(bc, 3)
    interior, edge = partition_tiles(plan)
    assert interior and edge
    tiled_sweep.reset_counts()
    part = tiled_sweep(cur, nxt.clone(), plan, src, pins, subset=interior)
    got = tiled_sweep(cur, part.clone(), plan, src, pins, subset=edge)
    full = tiled_sweep(cur, nxt.clone(), plan, src, pins)
    torch.cuda.synchronize()
    assert tiled_sweep.march_subset_launches == 2
    assert tiled_sweep.march_source_subset_launches == 2 * source
    assert torch.equal(part, subset_reference(cur, nxt, plan, interior, src,
                                              pins=pins))
    assert torch.equal(got, subset_reference(cur, part, plan, edge, src,
                                             pins=pins))
    assert torch.equal(got, full)


@pytest.mark.parametrize("shape,k,tiles,periodic,neumann,scales", [
    ((256, 256, 256), 8, None, (), (), (1 / 6, 1.0, -1 / 6)),
    ((57, 50, 46), 3, None, (0, 1), (), (0.125, 1.0, -0.125)),
    ((57, 50, 46), 5, (16, 8, 16), (), (1,), (0.125, 1.0, -0.125)),
    ((63, 63, 63), 1, None, (), (), (-4096.0, 0.0, 4096.0))])
def test_march_coeff_matches_plain_and_window(cuda_device, shape, k, tiles,
                                              periodic, neumann, scales):
    """The weights kernel bitwise its plain version; one march
    coefficient launch through those weights bitwise its plain version
    and the window schedule's launch from the padded a(x), with its
    counts; an interior then an edge subset launch, the pair the full
    launch."""
    from stencil_tpu_torch.ops.sweep_kernel import (
        coeff_weights_reference, subset_reference,
    )
    from stencil_tpu_torch.ops.tiled import (
        dynamic_pins, pad_coeff, partition_tiles,
    )
    from stencil_tpu_torch.ops.tiled_kernel import coeff_weights

    sp = get_spec("jacobi7")
    bc = _walls(3, periodic, neumann)
    plan = make_tiled_plan(sp, shape, "float32", k, tiles=tiles,
                           coeff_scales=scales)
    window = make_tiled_plan(sp, shape, "float32", k, coeff_scales=scales,
                             schedule="window")
    assert plan.schedule == "march" and window.schedule == "window"
    cur = _refreshed(plan, bc, shape, 1, cuda_device)
    a = pad_coeff(plan, _coeff_field(shape), bc).to(cuda_device)
    pins = dynamic_pins(bc, 3)
    before = coeff_weights.launches
    w = coeff_weights(a, plan)
    torch.cuda.synchronize()
    assert coeff_weights.launches == before + 1
    assert torch.equal(w, coeff_weights_reference(a, plan))
    tiled_sweep.reset_counts()
    got = tiled_sweep(cur, cur.clone(), plan, pins=pins, coeff=w)
    torch.cuda.synchronize()
    live = not all(pins)
    assert (tiled_sweep.march_coeff_launches,
            tiled_sweep.march_coeff_pins_launches,
            tiled_sweep.coeff_launches, tiled_sweep.march_pins_launches) \
        == (1, live, 1, 0)
    via_window = tiled_sweep(cur, cur.clone(), window, pins=pins, coeff=a)
    torch.cuda.synchronize()
    assert torch.equal(got, sweep_reference(cur, plan, coeff=w, pins=pins))
    assert torch.equal(got, via_window)
    interior, edge = partition_tiles(plan)
    if interior and edge:
        nxt = cur.clone()
        nxt[plan.layout.interior_index] = -1.0
        part = tiled_sweep(cur, nxt.clone(), plan, pins=pins, coeff=w,
                           subset=interior)
        both = tiled_sweep(cur, part.clone(), plan, pins=pins, coeff=w,
                           subset=edge)
        torch.cuda.synchronize()
        assert torch.equal(part, subset_reference(
            cur, nxt, plan, interior, coeff=w, pins=pins))
        assert torch.equal(both, got)


def test_march_refuses_rather_than_falls_back(cuda_device):
    """A CUDA tensor with a march plan launches the march kernel or
    raises: a geometry the kernel refuses is an error, not a window or
    plain launch."""
    import dataclasses

    sp, shape = get_spec("jacobi7"), (64, 64, 64)
    plan = make_tiled_plan(sp, shape, "float32", 8)
    big = dataclasses.replace(plan, tiles=(64, 64, 64))  # rings overflow
    cur = plan.layout.pad_grid(_grid(shape, 1, cuda_device))
    tiled_sweep.reset_counts()
    with pytest.raises(RuntimeError, match="shared memory"):
        tiled_sweep(cur, cur.clone(), big)
    assert tiled_sweep.launches == 0


# ---- the march's point-table kernel (tiled_march_kernel_tables) ------------


def _march_kernel_launch(cur, nxt, plan, pins, subset=None):
    """One launch of ``plan`` through tiled_march_kernel (the march
    library's ``plain`` entry called directly, as the wrapper calls it
    for every plan the point-table kernel does not take); no count."""
    from stencil_tpu_torch.ops.sweep_kernel import column_ids, launch_tables
    from stencil_tpu_torch.ops.tiled_kernel import tiled_march

    geom, offsets, sizes, weights, uniform, uw, _ = launch_tables(plan, pins)
    cols = (None, 0) if subset is None else (
        column_ids(tuple(subset), cur.device).data_ptr(), len(subset))
    rc = tiled_march._entry["plain"](
        cur.data_ptr(), nxt.data_ptr(), None, geom.ctypes.data, len(geom),
        *cols, offsets.ctypes.data, sizes.ctypes.data, weights.ctypes.data,
        len(offsets) // 3, len(sizes), int(uniform), uw, cur.device.index,
        torch.cuda.current_stream(cur.device).cuda_stream)
    assert rc == 0, rc
    return nxt


@pytest.mark.parametrize("shape,k,periodic,neumann", [
    ((256, 256, 256), 1, (), ()), ((256, 256, 256), 2, (), ()),
    ((256, 256, 256), 4, (), ()), ((256, 256, 256), 8, (), ()),
    ((256, 256, 256), 8, (0, 1), ()), ((57, 50, 46), 3, (0,), (1,)),
    ((64, 48, 40), 5, (), (0, 1))])
def test_march_tables_match_plain_and_window(cuda_device, shape, k, periodic,
                                             neumann):
    """A jacobi7 fp32 launch runs the point-table kernel, bitwise its plain
    version, the window schedule's launch and tiled_march_kernel's launch
    of the same plan; each launch raises ``march_table_launches``,
    ``march_launches`` and ``launches`` by one."""
    from stencil_tpu_torch.ops.tiled import dynamic_pins
    from stencil_tpu_torch.ops.tiled_kernel import point_tables

    sp = get_spec("jacobi7")
    bc = _walls(3, periodic, neumann)
    plan = make_tiled_plan(sp, shape, "float32", k)
    window = make_tiled_plan(sp, shape, "float32", k, schedule="window")
    assert plan.schedule == "march" and point_tables(plan)
    cur = _refreshed(plan, bc, shape, 1, cuda_device)
    pins = dynamic_pins(bc, 3)
    tiled_sweep.reset_counts()
    got = tiled_sweep(cur, cur.clone(), plan, pins=pins)
    torch.cuda.synchronize()
    assert (tiled_sweep.march_table_launches, tiled_sweep.march_launches,
            tiled_sweep.launches) == (1, 1, 1)
    assert tiled_sweep.march_pins_launches == (not all(pins))
    old = _march_kernel_launch(cur, cur.clone(), plan, pins)
    via_window = tiled_sweep(cur, cur.clone(), window, pins=pins)
    torch.cuda.synchronize()
    assert (tiled_sweep.march_table_launches, tiled_sweep.launches) == (1, 2)
    assert torch.equal(got, sweep_reference(cur, plan, pins=pins))
    assert torch.equal(got, old)
    assert torch.equal(got, via_window)


@pytest.mark.parametrize("shape,k,tiles,periodic", [
    ((96, 80, 72), 4, (16, 16, 32), (0,)),
    ((128, 128, 256), 8, (32, 32, 32), ())])
def test_march_tables_subsets_pair_is_the_full_launch(cuda_device, shape, k,
                                                      tiles, periodic):
    """An interior then an edge subset launch through the point-table
    kernel into one output, each bitwise its plain version and
    tiled_march_kernel's subset launch, the pair the full launch; each
    counted in ``march_table_launches`` and ``march_subset_launches``."""
    from stencil_tpu_torch.ops.sweep_kernel import subset_reference
    from stencil_tpu_torch.ops.tiled import dynamic_pins, partition_tiles
    from stencil_tpu_torch.ops.tiled_kernel import point_tables

    sp = get_spec("jacobi7")
    bc = _walls(3, periodic)
    plan = make_tiled_plan(sp, shape, "float32", k, tiles=tiles)
    assert plan.schedule == "march" and point_tables(plan)
    cur = _refreshed(plan, bc, shape, 1, cuda_device)
    nxt = cur.clone()
    nxt[plan.layout.interior_index] = -1.0
    pins = dynamic_pins(bc, 3)
    interior, edge = partition_tiles(plan)
    assert interior and edge
    tiled_sweep.reset_counts()
    part = tiled_sweep(cur, nxt.clone(), plan, pins=pins, subset=interior)
    got = tiled_sweep(cur, part.clone(), plan, pins=pins, subset=edge)
    full = tiled_sweep(cur, nxt.clone(), plan, pins=pins)
    old = _march_kernel_launch(cur, nxt.clone(), plan, pins, interior)
    torch.cuda.synchronize()
    assert (tiled_sweep.march_table_launches,
            tiled_sweep.march_subset_launches, tiled_sweep.launches) \
        == (3, 2, 3)
    assert torch.equal(part, subset_reference(cur, nxt, plan, interior,
                                              pins=pins))
    assert torch.equal(part, old)
    assert torch.equal(got, subset_reference(cur, part, plan, edge,
                                             pins=pins))
    assert torch.equal(got, full)


def test_march_tables_refuse_other_plans(cuda_device):
    """The point-table entry refuses a launch outside its instances (a
    27-tap spec, k = 9) rather than computing it; the wrapper sends those
    to tiled_march_kernel."""
    from stencil_tpu_torch.ops.sweep_kernel import launch_tables
    from stencil_tpu_torch.ops.tiled_kernel import point_tables, tiled_march

    shape = (40, 40, 40)
    for spec, k in ((get_spec("jacobi27"), 2), (get_spec("jacobi7"), 9)):
        plan = make_tiled_plan(spec, shape, "float32", k)
        assert plan.schedule == "march" and not point_tables(plan)
        cur = plan.layout.pad_grid(_grid(shape, spec.radius, cuda_device))
        geom, offsets, sizes, weights, uniform, uw, _ = launch_tables(
            plan, (1, 1, 1, 1))
        rc = tiled_march._entry["tables"](
            cur.data_ptr(), cur.clone().data_ptr(), None, geom.ctypes.data,
            len(geom), None, 0, offsets.ctypes.data, sizes.ctypes.data,
            weights.ctypes.data, len(offsets) // 3, len(sizes), int(uniform),
            uw, 0, torch.cuda.current_stream().cuda_stream)
        assert rc == -4
        tiled_sweep.reset_counts()
        tiled_sweep(cur, cur.clone(), plan)
        torch.cuda.synchronize()
        assert (tiled_sweep.march_launches,
                tiled_sweep.march_table_launches) == (1, 0)


def _table_route_cases():
    from stencil_tpu_torch.core.spec import StencilSpec

    j7 = get_spec("jacobi7")
    faces = ((-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1),
             (0, 0, 1))
    big = (512, 512, 512)
    return [  # label, plan, the point-table kernel takes it
        ("jacobi7 512^3 k=8 (.long)", make_tiled_plan(j7, big, "float32", 8),
         True),
        ("jacobi7 512^3 k=1 (.step)", make_tiled_plan(j7, big, "float32", 1),
         True),
        ("jacobi7 256^3 k=4", make_tiled_plan(j7, (256,) * 3, "float32", 4),
         True),
        ("jacobi7 ragged k=3", make_tiled_plan(j7, (57, 50, 46), "float32",
                                               3), True),
        ("7 taps (a centre and the faces)", make_tiled_plan(
            StencilSpec(name="wj7", ndim=3, radius=1,
                        offsets=((0, 0, 0), *faces),
                        weights=(0.5,) + (1 / 12,) * 6),
            (64,) * 3, "float32", 2), False),
        ("the faces in another order", make_tiled_plan(
            StencilSpec(name="j7r", ndim=3, radius=1, offsets=faces[::-1],
                        weights=(1 / 6,) * 6), (64,) * 3, "float32", 2),
         False),
        ("k=9", make_tiled_plan(j7, (64,) * 3, "float32", 9), False),
        ("k=1, a plane past the passes", make_tiled_plan(
            j7, (16, 72, 72), "float32", 1, tiles=(8, 70, 70)), False),
        ("k=4, a plane past the passes", make_tiled_plan(
            j7, (64,) * 3, "float32", 4, tiles=(16, 52, 56)), False),
        ("star3d_r2", make_tiled_plan(get_spec("star3d_r2"), (64,) * 3,
                                      "float32", 2), False),
        ("jacobi27", make_tiled_plan(get_spec("jacobi27"), (64,) * 3,
                                     "float32", 2), False),
    ]


def test_march_tables_routing(cuda_device):
    """The march library's answer to whether its point-table kernel takes
    a homogeneous fp32 march plan, case by case: jacobi7 at the cells'
    plans, 256^3 k=4 and ragged go; 7 taps, the six faces in another
    order, k > 8, planes past the instance's passes, radius 2 and 27 taps
    stay on tiled_march_kernel. Each plan of 64^3 or less launches through
    the wrapper on the route the answer gives, counted there."""
    from stencil_tpu_torch.ops.tiled_kernel import point_tables

    for label, plan, want in _table_route_cases():
        assert plan.schedule == "march", label
        assert point_tables(plan) == want, label
        if max(plan.interior_shape) > 64:
            continue
        cur = plan.layout.pad_grid(_grid(plan.interior_shape,
                                         plan.spec.radius, cuda_device))
        tiled_sweep.reset_counts()
        got = tiled_sweep(cur, cur.clone(), plan)
        torch.cuda.synchronize()
        assert (tiled_sweep.march_launches,
                tiled_sweep.march_table_launches) == (1, int(want)), label
        assert torch.equal(got, sweep_reference(cur, plan)), label


# ---- the two-level mode on the d0 march (B1d) ------------------------------


@pytest.mark.parametrize("shape,k,dtype,periodic,neumann", [
    ((57, 50, 46), 1, "float32", (), ()),
    ((57, 50, 46), 3, "float32", (), ()),
    ((64, 48, 40), 8, "float32", (), ()),
    ((57, 50, 46), 3, "float32", (0,), (1,)),
    ((64, 48, 40), 8, "float32", (0,), (1,)),
    ((57, 50, 46), 8, "float32", (0,), (1,)),
    ((57, 50, 46), 1, "bfloat16", (0,), (1,)),
    ((57, 50, 46), 3, "bfloat16", (), ()),
    ((64, 48, 40), 8, "bfloat16", (0,), (1,))])
def test_march_two_level_matches_plain_and_window(cuda_device, shape, k,
                                                  dtype, periodic, neumann):
    """One two-level march launch bitwise its plain version and the window
    schedule's launch on both outputs (L_(n+k) and L_(n+k-1)), on Dirichlet
    walls and with periodic 0 and Neumann 1, fp32 and bf16 (k=1 asks for
    the march, which the rule gives only from k=2 on); its counts bumped
    once."""
    from stencil_tpu_torch.models.wave import WaveEquation
    from stencil_tpu_torch.ops.tiled import dynamic_pins

    spec = WaveEquation(shape=shape, dt=0.5, device=cuda_device).spec
    bc = _walls(3, periodic, neumann)
    plan = make_tiled_plan(spec, shape, dtype, k, two_level=True,
                           schedule="march")
    window = make_tiled_plan(spec, shape, dtype, k, two_level=True,
                             schedule="window")
    # the rule: the march from k=2 on, the window at k=1
    assert make_tiled_plan(spec, shape, dtype, k, two_level=True).schedule \
        == ("window" if k == 1 else "march")
    if dtype == "bfloat16":
        cur = _bf16_input(plan, shape, 1, cuda_device, bc, seed=1)
        prev = _bf16_input(plan, shape, 1, cuda_device, bc, seed=3)
    else:
        cur = _refreshed(plan, bc, shape, 1, cuda_device, seed=1)
        prev = _refreshed(plan, bc, shape, 1, cuda_device, seed=3)
    pins = dynamic_pins(bc, 3)
    tiled_sweep.reset_counts()
    got = tiled_sweep(cur, cur.clone(), plan, pins=pins, prev=prev,
                      out2=prev.clone())
    torch.cuda.synchronize()
    live = not all(pins)
    assert (tiled_sweep.march_launches, tiled_sweep.march_two_level_launches,
            tiled_sweep.march_two_level_pins_launches,
            tiled_sweep.two_level_launches, tiled_sweep.march_bf16_launches,
            tiled_sweep.march_pins_launches) == (
        1, 1, live, 1, dtype == "bfloat16", 0)
    want = sweep_reference(cur, plan, prev=prev, pins=pins)
    via_window = tiled_sweep(cur, cur.clone(), window, pins=pins, prev=prev,
                             out2=prev.clone())
    torch.cuda.synchronize()
    assert tiled_sweep.march_launches == 1 and tiled_sweep.launches == 2
    for g, w, v in zip(got, want, via_window):
        assert torch.equal(g, w)
        assert torch.equal(g, v)


def test_march_two_level_refuses_rather_than_falls_back(cuda_device):
    """A CUDA tensor with a two-level march plan launches the march kernel
    or raises: rings the kernel refuses are an error, not a window or
    plain launch."""
    import dataclasses

    from stencil_tpu_torch.models.wave import WaveEquation

    shape = (64, 64, 64)
    spec = WaveEquation(shape=shape, device=cuda_device).spec
    plan = make_tiled_plan(spec, shape, "float32", 8, two_level=True)
    assert plan.schedule == "march"
    big = dataclasses.replace(plan, tiles=(64, 32, 32))  # 2r+3 rings: too big
    cur = plan.layout.pad_grid(_grid(shape, 1, cuda_device))
    tiled_sweep.reset_counts()
    with pytest.raises(RuntimeError, match="shared memory"):
        tiled_sweep(cur, cur.clone(), big, prev=cur.clone(), out2=cur.clone())
    assert tiled_sweep.launches == 0


@pytest.mark.parametrize("dtype,periodic,neumann", [
    ("float32", (), ()), ("float32", (0,), (1,)), ("bfloat16", (), ())])
def test_march_wave_iterate_with_remainder_matches_window(cuda_device, dtype,
                                                          periodic, neumann):
    """``wave_iterate`` on a march plan, two launches of k=4 and a
    remainder of 3, bitwise the same on the window schedule; each launch a
    march two-level one."""
    from stencil_tpu_torch.core.grid import torch_dtype
    from stencil_tpu_torch.models.wave import WaveEquation
    from stencil_tpu_torch.ops.tiled import wave_iterate

    shape = (40, 36, 44)
    bc = _walls(3, periodic, neumann)
    spec = WaveEquation(shape=shape, device=cuda_device).spec
    plan = make_tiled_plan(spec, shape, dtype, 4, two_level=True)
    window = make_tiled_plan(spec, shape, dtype, 4, two_level=True,
                             schedule="window")
    assert plan.schedule == "march"
    cur, prev = (_grid(shape, 1, cuda_device, seed=seed, bc=bc).data
                 .to(torch_dtype(dtype)) for seed in (1, 3))
    tiled_sweep.reset_counts()
    got = wave_iterate(plan, cur, prev, bc, 2, rem=3)
    torch.cuda.synchronize()
    assert tiled_sweep.march_two_level_launches == 3
    assert tiled_sweep.march_two_level_pins_launches == 3 * bool(periodic)
    assert tiled_sweep.launches == 3
    want = wave_iterate(window, cur, prev, bc, 2, rem=3)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---- the Chebyshev and dual modes on the d0 march (B1b, B1c) ----------------


@pytest.mark.parametrize("shape,k,dual,smoother,dtype", [
    ((255, 255, 255), 2, False, "chebyshev", "float32"),
    ((255, 255, 255), 3, True, "chebyshev", "float32"),
    ((255, 255, 255), 5, True, "wjacobi", "float32"),
    ((57, 50, 46), 2, True, "wjacobi", "float32"),
    ((57, 50, 46), 3, False, "chebyshev", "float32"),
    ((57, 50, 46), 4, False, "chebyshev", "float32"),
    ((57, 50, 46), 5, True, "chebyshev", "float32"),
    ((255, 255, 255), 3, True, "chebyshev", "bfloat16"),
    ((57, 50, 46), 2, False, "chebyshev", "bfloat16"),
    ((57, 50, 46), 4, True, "wjacobi", "bfloat16")])
def test_march_cheby_matches_plain_and_window(cuda_device, shape, k, dual,
                                              smoother, dtype):
    """One Chebyshev or dual march launch bitwise its plain version and the
    window schedule's launch, on both outputs in the dual mode, fp32 and
    bf16; its counts bumped once."""
    kw = dict(has_source=True, cheby_dual=dual,
              cheby_coeffs=_cheby_coeffs(shape, k, dual, smoother))
    plan = make_tiled_plan(nbsum_spec(3), shape, dtype, k, schedule="march",
                           **kw)
    window = make_tiled_plan(nbsum_spec(3), shape, dtype, k,
                             schedule="window", **kw)
    cur = _bf16_input(plan, shape, 1, cuda_device) if dtype == "bfloat16" \
        else plan.layout.pad_grid(_grid(shape, 1, cuda_device))
    src = pad_source(plan, _source(shape), 1.0, BC3).to(cuda_device)
    bf16 = dtype == "bfloat16"
    tiled_sweep.reset_counts()
    got = tiled_sweep(cur, cur.clone(), plan, src,
                      out2=cur.clone() if dual else None)
    torch.cuda.synchronize()
    assert (tiled_sweep.march_launches, tiled_sweep.march_cheby_launches,
            tiled_sweep.march_dual_launches, tiled_sweep.dual_launches,
            tiled_sweep.march_cheby_bf16_launches,
            tiled_sweep.march_dual_bf16_launches,
            tiled_sweep.march_bf16_launches) == (
        1, not dual, dual, dual, bf16 and not dual, bf16 and dual, bf16)
    via_window = tiled_sweep(cur, cur.clone(), window, src,
                             out2=cur.clone() if dual else None)
    want = sweep_reference(cur, plan, src)
    torch.cuda.synchronize()
    assert tiled_sweep.march_launches == 1 and tiled_sweep.launches == 2
    for g, w, v in zip(*((t,) if not dual else t
                         for t in (got, want, via_window))):
        assert torch.equal(g, w)
        assert torch.equal(g, v)


@pytest.mark.parametrize("dual,dtype", [(False, "float32"), (True, "float32"),
                                        (True, "bfloat16")])
def test_march_cheby_subsets_pair_is_the_full_launch(cuda_device, dual,
                                                     dtype):
    """An interior then an edge subset launch of a Chebyshev or dual march
    plan into the same outputs, each bitwise its plain version, the pair
    the full launch."""
    from stencil_tpu_torch.ops.sweep_kernel import subset_reference
    from stencil_tpu_torch.ops.tiled import partition_tiles

    shape, k = (96, 80, 72), 3
    plan = make_tiled_plan(nbsum_spec(3), shape, dtype, k, tiles=(16, 16, 32),
                           has_source=True, cheby_dual=dual,
                           cheby_coeffs=_cheby_coeffs(shape, k, dual,
                                                      "chebyshev"),
                           schedule="march")
    cur = _bf16_input(plan, shape, 1, cuda_device) if dtype == "bfloat16" \
        else plan.layout.pad_grid(_grid(shape, 1, cuda_device))
    src = pad_source(plan, _source(shape), 1.0, BC3).to(cuda_device)
    base = [cur.clone() for _ in range(2 if dual else 1)]
    for b in base:
        b[plan.layout.interior_index] = -1.0
    interior, edge = partition_tiles(plan)
    assert interior and edge
    tiled_sweep.reset_counts()

    def launch(outs, subset):
        outs = [o.clone() for o in outs]
        got = tiled_sweep(cur, outs[0], plan, src,
                          out2=outs[1] if dual else None, subset=subset)
        return list(got) if dual else [got]

    part = launch(base, interior)
    got = launch(part, edge)
    full = launch(base, None)
    torch.cuda.synchronize()
    assert tiled_sweep.march_subset_launches == 2
    assert tiled_sweep.march_launches == 3
    for outs, prior, subset in ((part, base, interior), (got, part, edge)):
        want = subset_reference(cur, prior[0], plan, subset, src,
                                out2=prior[1] if dual else None)
        for g, w in zip(outs, want if dual else (want,)):
            assert torch.equal(g, w)
    for g, f in zip(got, full):
        assert torch.equal(g, f)


@pytest.mark.parametrize("name,k,dtype", [
    ("wjacobi", 2, "float32"), ("wjacobi", 4, "float32"),
    ("wjacobi", 2, "bfloat16"), ("residual", 1, "float32")])
def test_march_seven_taps_match_plain_and_window(cuda_device, name, k,
                                                 dtype):
    """The multigrid fine level's 7-tap source plans (the weighted-Jacobi
    smoother, two groups, and the residual), unrolled on the march,
    bitwise their plain version and the window's launch."""
    from stencil_tpu_torch.multigrid import residual_spec, wjacobi_spec

    shape = (57, 50, 46)
    spec = wjacobi_spec(3, 2.0 / 3.0) if name == "wjacobi" \
        else residual_spec(3, 1.0 / 58)
    assert spec.num_taps == 7
    plan = make_tiled_plan(spec, shape, dtype, k, has_source=True)
    window = make_tiled_plan(spec, shape, dtype, k, has_source=True,
                             schedule="window")
    assert plan.schedule == "march"
    cur = _bf16_input(plan, shape, 1, cuda_device) if dtype == "bfloat16" \
        else plan.layout.pad_grid(_grid(shape, 1, cuda_device))
    src = pad_source(plan, _source(shape), -0.01, BC3).to(cuda_device)
    got = tiled_sweep(cur, cur.clone(), plan, src)
    via_window = tiled_sweep(cur, cur.clone(), window, src)
    want = sweep_reference(cur, plan, src)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, via_window)


def test_march_cheby_refuses_rather_than_falls_back(cuda_device):
    """A CUDA tensor with a Chebyshev march plan launches the march kernel
    or raises: rings the kernel refuses are an error, not a window or
    plain launch."""
    import dataclasses

    shape = (64, 64, 64)
    plan = make_tiled_plan(nbsum_spec(3), shape, "float32", 5,
                           has_source=True, cheby_dual=True,
                           cheby_coeffs=_cheby_coeffs(shape, 5, True,
                                                      "chebyshev"),
                           schedule="march")
    big = dataclasses.replace(plan, tiles=(64, 64, 64))  # rings overflow
    cur = plan.layout.pad_grid(_grid(shape, 1, cuda_device))
    src = pad_source(plan, _source(shape), 1.0, BC3).to(cuda_device)
    tiled_sweep.reset_counts()
    with pytest.raises(RuntimeError, match="shared memory"):
        tiled_sweep(cur, cur.clone(), big, src, out2=cur.clone())
    assert tiled_sweep.launches == 0


def test_march_cheby_multigrid_counts(cuda_device, monkeypatch):
    """A Chebyshev V(2,2) at 63^3 on the tiled fine level marches both of
    its fine-level plans: every fine launch a march Chebyshev or dual one,
    and the cycles bitwise those on window plans (the plan maker asked for
    the window)."""
    prob = PoissonProblem(shape=(63, 63, 63), device=cuda_device)
    f = _source(prob.shape).astype(np.float32)
    mg = Multigrid(prob, smoother="chebyshev", fine_method="tiled")
    run = mg.runner(f)
    assert run.plan_info["fine_schedules"] == {
        "pre": "march", "res": "march", "post": "march", "fused": "march"}
    tiled_sweep.reset_counts()
    got = run.iterate(prob.initial_grid(), 3)
    torch.cuda.synchronize()
    assert tiled_sweep.march_dual_launches == 3
    assert tiled_sweep.march_cheby_launches == 3
    assert tiled_sweep.launches == 6
    from stencil_tpu_torch.ops import tiled

    monkeypatch.setattr(tiled, "make_tiled_plan", functools.partial(
        tiled.make_tiled_plan, schedule="window"))
    window = Multigrid(prob, smoother="chebyshev",
                       fine_method="tiled").runner(f)
    assert set(window.plan_info["fine_schedules"].values()) == {"window"}
    want = window.iterate(prob.initial_grid(), 3)
    assert torch.equal(got.data, want.data)


# ---- the 2D d0 march (csrc/slab_march.cu) ----------------------------------


def _slab_spec(name):
    """A 2D spec by name: the spec table's, ``star2d_r1`` (the Poisson
    runner's), or ``upwind3`` (three taps, the kernels' table loop)."""
    from stencil_tpu_torch.core.spec import star, weighted

    if name == "star2d_r1":
        return star(2, 1)
    if name == "upwind3":
        return weighted(2, [((0, 0), 0.5), ((-1, 0), 0.25),
                            ((0, -1), 0.25)])
    return get_spec(name)


@pytest.mark.parametrize("name,shape,k,t0,dtype,periodic,neumann,source", [
    ("jacobi5", (512, 512), 16, None, "float32", (), (), False),
    ("jacobi5", (512, 512), 16, None, "float32", (0,), (), False),
    ("jacobi5", (512, 512), 1, None, "float32", (), (0,), False),
    ("jacobi9", (4096, 4096), 4, 256, "float32", (), (), False),
    ("star2d_r1", (4096, 4096), 8, None, "float32", (0,), (), True),
    ("star2d_r1", (63, 63), 8, None, "float32", (), (0,), True),
    ("star2d_r2", (250, 333), 3, None, "float32", (), (), False),
    ("laplace2d_ho", (250, 333), 3, 16, "float32", (0,), (), True),
    ("upwind3", (61, 70), 5, None, "float32", (0,), (), False),
    ("jacobi5", (512, 512), 16, None, "bfloat16", (), (), False),
    ("jacobi5", (512, 512), 16, None, "bfloat16", (0,), (), False),
    ("star2d_r1", (4096, 4096), 8, None, "bfloat16", (), (), True),
    ("star2d_r2", (251, 333), 3, None, "bfloat16", (0,), (), True),
    ("jacobi9", (63, 63), 8, 8, "bfloat16", (), (0,), False)])
def test_slab_march_matches_plain_and_window(cuda_device, name, shape, k, t0,
                                             dtype, periodic, neumann,
                                             source):
    """One 2D march launch bitwise its plain version and the window
    schedule's launch of the same sweeps, every count of its mode bumped
    once: cfg1, cfg2 at -b 256, the Poisson shapes, the ragged star2d_r2
    (odd row stride; at (251, 333) an odd-sized array, whose last bf16
    word is copied alone), radius 2 with two weight groups, the table loop
    of a 3-tap spec; periodic and Neumann d0 faces; both dtypes."""
    from stencil_tpu_torch.ops.sweep_kernel import dynamic_pins

    sp = _slab_spec(name)
    bc = _walls(2, periodic, neumann)
    plan = make_slab_plan(sp, shape, dtype, k, t0_fixed=t0,
                          schedule="march")
    window = make_slab_plan(sp, shape, dtype, k, t0_fixed=t0,
                            schedule="window")
    assert plan.schedule == "march" and window.schedule == "window"
    cur = _bf16_input(plan, shape, sp.radius, cuda_device, bc) \
        if dtype == "bfloat16" else _refreshed(plan, bc, shape, sp.radius,
                                               cuda_device)
    src = pad_source(plan, _source(shape), -0.02, bc).to(cuda_device) \
        if source else None
    pins = dynamic_pins(bc, 2)
    slab_sweep.reset_counts()
    got = slab_sweep(cur, cur.clone(), plan, src, pins)
    torch.cuda.synchronize()
    live = not all(pins)
    assert (slab_sweep.march_launches, slab_sweep.march_source_launches,
            slab_sweep.march_pins_launches,
            slab_sweep.march_source_pins_launches,
            slab_sweep.march_bf16_launches) == (
        1, source, live and not source, live and source,
        dtype == "bfloat16")
    want = sweep_reference(cur, plan, src, pins=pins)
    via_window = slab_sweep(cur, cur.clone(), window, src, pins)
    torch.cuda.synchronize()
    assert slab_sweep.march_launches == 1 and slab_sweep.launches == 2
    assert torch.equal(got, want)
    assert torch.equal(got, via_window)


@pytest.mark.parametrize("dtype,periodic", [("float32", ()),
                                            ("bfloat16", (0,))])
def test_slab_march_iterate_with_remainder_matches_window(cuda_device,
                                                          dtype, periodic):
    """``SlabStencil.iterate`` on the march, 16 + 5 sweeps at cfg1's k=16
    (a remainder launch of k=5 on the same rings' layout), bitwise the
    window's iterate; each launch counted once on the march."""
    sp, shape = get_spec("jacobi5"), (512, 512)
    bc = _walls(2, periodic)
    g = _grid(shape, 1, cuda_device, bc=bc)
    if dtype == "bfloat16":
        g = HaloGrid.from_interior(_bf16(g.interior()), halo=1, bc=bc,
                                   device=cuda_device)
    slab_sweep.reset_counts()
    got = SlabStencil(sp, shape, dtype, 16, device=cuda_device,
                      schedule="march").iterate(g, 21)
    torch.cuda.synchronize()
    assert slab_sweep.march_launches == 2
    want = SlabStencil(sp, shape, dtype, 16, device=cuda_device,
                       schedule="window").iterate(g, 21)
    torch.cuda.synchronize()
    assert torch.equal(got.interior(), want.interior())


def test_slab_march_refuses_rather_than_falls_back(cuda_device):
    """A CUDA tensor with a 2D march plan launches the march kernel or
    raises: a geometry the kernel refuses is an error, not a window or
    plain launch."""
    import dataclasses

    sp, shape = get_spec("jacobi5"), (512, 512)
    plan = make_slab_plan(sp, shape, "float32", 16, schedule="march")
    big = dataclasses.replace(plan, tiles=(64, 512), sweeps_per_call=32,
                              layout=plan.layout.for_halo(shape, 32))
    cur = big.layout.pad_grid(_grid(shape, 1, cuda_device))
    slab_sweep.reset_counts()
    with pytest.raises(RuntimeError, match="shared memory"):
        slab_sweep(cur, cur.clone(), big)
    assert slab_sweep.launches == 0


@pytest.mark.parametrize("periodic,neumann,k,iters,chunks", [
    ((), (), 8, 19, 4), ((0, 1), (), 4, 8, 3), ((0,), (1,), 2, 5, 5),
    ((), (), 1, 3, 7)])
def test_streamed_bitwise_tiled(cuda_device, periodic, neumann, k, iters,
                                chunks):
    """The out-of-core method on the card (pinned host buffers, a copy
    stream, the compute stream and a download stream) against the
    in-core tiled method at the same k: bitwise, each chunk one launch
    of the tiled kernel, a remainder included."""
    from stencil_tpu_torch.streaming import StreamedStencil

    spec = get_spec("jacobi7")
    shape = (60, 50, 70)
    bc = DirichletBC.reference_default(3)
    if periodic:
        bc = bc.with_periodic(periodic)
    if neumann:
        bc = bc.with_neumann(neumann)
    x0 = torch.from_numpy(
        np.random.default_rng(3).random(shape).astype(np.float32))
    m = StreamedStencil(spec, shape, sweeps_per_call=k, chunks=chunks,
                        device=cuda_device)
    before = tiled_sweep.launches
    got = m.iterate_host(x0, iters, bc=bc)
    steps, rem = divmod(iters, k)
    assert tiled_sweep.launches - before == chunks * (steps + bool(rem))
    assert got.device.type == "cpu"
    grid = HaloGrid.from_interior(x0, halo=1, bc=bc, device=cuda_device)
    want = TiledStencil(spec, shape, sweeps_per_call=k,
                        device=cuda_device).iterate(grid, iters)
    assert torch.equal(got, want.interior().cpu())


def test_streamed_stream_ordering_soak(cuda_device):
    """Many thin chunks over many outer steps, the copies and the kernels
    on three streams ordered only by events: 10 runs, each bitwise the
    in-core result (a missing wait shows as a stale plane)."""
    from stencil_tpu_torch.streaming import StreamedStencil

    spec = get_spec("jacobi7")
    shape = (96, 64, 128)
    bc = DirichletBC.reference_default(3).with_periodic((0,))
    x0 = torch.from_numpy(
        np.random.default_rng(4).random(shape).astype(np.float32))
    grid = HaloGrid.from_interior(x0, halo=1, bc=bc, device=cuda_device)
    want = TiledStencil(spec, shape, sweeps_per_call=2,
                        device=cuda_device).iterate(grid, 24).interior()
    m = StreamedStencil(spec, shape, sweeps_per_call=2, chunks=24,
                        device=cuda_device)
    assert m._host_buffers()[0].is_pinned()
    for _ in range(10):
        assert torch.equal(m.iterate_host(x0, 24, bc=bc), want.cpu())
