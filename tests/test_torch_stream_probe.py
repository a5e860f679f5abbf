"""K4, the streaming probe (cge_tpu_torch.ops.stream_probe), against numpy.

The JAX package's probe (tools/exp_dma_layout.py:28-62) is a Pallas kernel
with no interpret switch, so numpy is the reference here: the sum over the
first two axes of the stack's first (L // 4) * 4 rows, in float64. Shapes
are the probe's three layouts at a small L and C, and an L that is not a
multiple of 4 (its trailing rows are never read). The CUDA kernel is held
against the same twin by the `cuda`-marked case, which skips without a
card.
"""

import numpy as np
import pytest
import torch

from cge_tpu_torch.ops import stream_probe
from cge_tpu_torch.tools import stream_layout

torch.set_num_threads(2)

SEED = 99


def _reference(x):
    n = x.shape[0] // 4 * 4
    return x[:n].astype(np.float64).sum(axis=(0, 1))[None]


def _stack(shape):
    return np.random.default_rng(SEED).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(12, 32, 128), (12, 32, 16),
                                   (12, 4, 128), (11, 32, 16), (3, 8, 16)])
def test_twin_matches_numpy(shape):
    """The padded, compact and flat layouts at L = 12, C = 32, and L = 11
    and 3 (7 and 3 trailing rows unread): [1, w] within 1e-6 of the
    column's sum of |x| (float32 against float64 sums)."""
    x = _stack(shape)
    got = stream_probe.stream_sum(torch.from_numpy(x)).numpy()
    want = _reference(x)
    n = shape[0] // 4 * 4
    bound = 1e-6 * np.abs(x[:n]).sum(axis=(0, 1)).max() + 1e-6
    assert got.shape == (1, shape[2]) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=bound)


def test_trailing_rows_are_never_read():
    """Rows past the last whole step change nothing: NaN there still gives
    the sum of the whole steps."""
    x = _stack((10, 8, 16))
    x[8:] = np.nan
    got = stream_probe.stream_sum(torch.from_numpy(x)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(
        got, stream_probe.stream_sum_plain(torch.from_numpy(x[:8])).numpy())
    assert stream_probe.stream_bytes(torch.from_numpy(x)) == 8 * 8 * 16 * 4


def test_cpu_wrapper_runs_the_twin():
    before = dict(stream_probe.LAUNCHES)
    x = torch.from_numpy(_stack((8, 4, 16)))
    torch.testing.assert_close(stream_probe.stream_sum(x),
                               stream_probe.stream_sum_plain(x),
                               rtol=0, atol=0)
    assert stream_probe.LAUNCHES == before


def test_stream_layout_tool(capsys):
    """The tool at its tiny size: three layouts, each within its bound."""
    assert stream_layout.main(["--device", "cpu", "--clusters", "10",
                               "--c", "8"]) == 0
    out = capsys.readouterr().out
    assert out.count("max |K4 - twin|") == 3
    assert "MISMATCH" not in out and "ms not measured" in out


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4800, 128, 16), (4800, 16, 128),
                                   (402, 128, 128), (11, 32, 16)])
def test_kernel_matches_twin_on_card(shape):
    """K4 on the card against its twin on the card: within 1e-6 of the
    column's sum of |x| (the kernel adds per thread, per block and then
    across blocks in a fixed order; torch in its own)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    x = torch.from_numpy(_stack(shape)).cuda()
    n = stream_probe.LAUNCHES["stream_probe"]
    got = stream_probe.stream_sum(x)
    assert stream_probe.LAUNCHES["stream_probe"] == n + 1
    want = stream_probe.stream_sum_plain(x)
    rows = shape[0] // 4 * 4
    bound = 1e-6 * float(x[:rows].abs().sum(dim=(0, 1)).max()) + 1e-6
    assert float((got - want).abs().max()) <= bound
    with pytest.raises(ValueError):
        stream_probe.stream_sum(x[:, :, :3].contiguous())   # w must divide 256
