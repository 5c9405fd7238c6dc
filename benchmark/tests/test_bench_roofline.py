"""The frozen count against bytes and operations written out by hand."""

import pytest

from benchmark import roofline


def test_homogeneous_k8_launch():
    # 16x12x10 interior, radius 1, every face pinned: the input is read
    # over the interior widened by one cell on each face, the output's
    # interior written once; 8 sweeps of 6 taps (5 adds, 1 multiply)
    one = roofline.Launch(shape=(16, 12, 10), radius=1, sweeps=8,
                          flops_per_point=6)
    assert one.nbytes == 4 * (18 * 14 * 12 + 16 * 12 * 10)
    assert one.ops == 16 * 12 * 10 * 8 * 6


def test_k1_launch():
    one = roofline.Launch(shape=(16, 12, 10), radius=1, sweeps=1,
                          flops_per_point=6)
    assert one.nbytes == 4 * (3024 + 1920)
    assert one.ops == 1920 * 6
    # bytes bound it: 19776 B at 3.35 TB/s
    assert one.bound_s == pytest.approx(19776 / 3.35e12)
    assert roofline.bound_of(one.nbytes, one.ops)[1] == "bytes"


def test_chebyshev_launch():
    # the smoother of k=2: the input and the raw f (read at the points it
    # is added to: the interior), one output; per update the 6 taps,
    # 3 multiplies and 2 adds, and from sweep 2 one more of each
    one = roofline.Launch(shape=(16, 12, 10), radius=1, sweeps=2,
                          flops_per_point=6, mode="cheby")
    assert one.nbytes == 4 * (3024 + 1920 + 1920)
    assert one.ops == 1920 * ((6 + 5) + (6 + 5 + 2))


def test_dual_launch():
    # the fused smooth+residual of k=3 writes a second interior
    one = roofline.Launch(shape=(16, 12, 10), radius=1, sweeps=3,
                          flops_per_point=6, mode="dual")
    assert one.nbytes == 4 * (3024 + 1920 + 1920 + 1920)
    assert one.ops == 1920 * (11 + 13 + 13)


def test_live_faces_and_bf16():
    # d0 live on both faces at k=2: the input needs the launch's 2 ghosts
    # there, the source the first sweep's 1
    one = roofline.Launch(shape=(16, 12, 10), radius=1, sweeps=2,
                          flops_per_point=6, mode="source",
                          dtype="bfloat16", pins=(0, 0, 1, 1))
    assert one.nbytes == 2 * (20 * 14 * 12 + 1920 + 18 * 12 * 10)
    assert one.ops == 1920 * 2 * 7


def test_operations_bound_and_share():
    t, by = roofline.bound_of(1.0, 67e12)
    assert (t, by) == (1.0, "operations")
    work = [{"count": 4, "bound_s": 0.25}, {"count": 2, "bound_s": 0.5}]
    assert roofline.share_percent(work, 4.0) == pytest.approx(50.0)
    assert roofline.share_percent(work, 0.0) is None
    assert roofline.share_percent(None, 1.0) is None


def test_refuses_unknown_mode():
    with pytest.raises(ValueError):
        roofline.Launch(shape=(4, 4, 4), radius=1, sweeps=1,
                        flops_per_point=6, mode="coeff")
