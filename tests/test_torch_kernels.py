"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card, at the main path's shapes.

CUDA kernels have no CPU build, so these tests skip without a card. The
file imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from embodied_object_detection_tpu_torch.ops import memory_ops, segment_sum

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")


@pytest.mark.parametrize("one_cell", [False, True])
def test_segment_sum_kernel_vs_plain(one_cell):
    _need_card()
    rng = np.random.RandomState(16)
    rows, lanes, cells = 38400, 101, 8192
    w = rng.rand(rows, lanes).astype(np.float32)
    w[rng.rand(rows, lanes) < 0.7] = 0.0
    idx = rng.randint(0, cells, rows).astype(np.int32)
    if one_cell:
        idx[:] = 5                                   # worst contention
    idx[::7] = -1
    idx[3::11] = cells + 3
    w_d, idx_d = torch.from_numpy(w).cuda(), torch.from_numpy(idx).cuda()
    got = segment_sum.segment_sum(w_d, idx_d, cells)
    want = segment_sum.segment_sum_plain(w_d, idx_d, cells)
    torch.cuda.synchronize()
    # atomics sum in any order: |err| <= rows in the cell * 2^-24 * sum|w|
    keep = (idx_d >= 0) & (idx_d < cells)
    rows_in_cell = torch.bincount(idx_d[keep].long(), minlength=cells)
    abs_sum = segment_sum.segment_sum_plain(w_d.abs(), idx_d, cells)
    bound = rows_in_cell[:, None] * 2.0 ** -24 * abs_sum + 1e-7
    assert bool(((got - want).abs() <= bound).all())
    # an integer-valued lane (the write's pixel count) is exact
    ones = torch.ones((rows, 1), device="cuda")
    count = segment_sum.segment_sum(ones, idx_d, cells)[:, 0]
    assert torch.equal(count, rows_in_cell.float())


def test_memory_read_kernel_vs_plain():
    _need_card()
    rng = np.random.RandomState(17)
    feats = torch.from_numpy(rng.randn(8192, 512).astype(np.float32)).cuda()
    obs = torch.from_numpy(
        rng.choice([0.0, 1.0, 2.0, 5.0], 8192).astype(np.float32)).cuda()
    proj = torch.from_numpy(
        rng.randint(0, 8192, (480, 640)).astype(np.int32)).cuda()
    got = memory_ops.memory_read(feats, obs, proj)
    want = memory_ops.memory_read_plain(feats, obs, proj)
    torch.cuda.synchronize()
    # the same bf16 rounding per tap; the 16-term f32 mean may sum in
    # another order
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
