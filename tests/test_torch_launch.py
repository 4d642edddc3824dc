"""The port's shared launch path and the dense decode's split planner, on
the CPU: the splits of the T axis cover it exactly, are never shorter than
the minimum, and keep the block count bounded; the wrappers' common checks
raise on a CPU tensor handed to them; nothing is built or resolved while a
wrapper runs its plain version."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402

SHAPES = [(4, 5, 96), (4, 5, 128), (4, 5, 4096), (1, 5, 4096), (4, 5, 1000), (6, 5, 4096),
          (32, 5, 4096), (1, 1, 100_000), (1, 5, 63), (1, 5, 64), (64, 8, 8192), (8, 5, 200)]


@pytest.mark.parametrize("B,KV,T", SHAPES, ids=[f"B{b}-KV{k}-T{t}" for b, k, t in SHAPES])
def test_splits_cover_the_cache_once_and_stay_bounded(B, KV, T):
    n = da_ops.plan_splits(B, KV, T)
    bounds = da_ops.split_bounds(T, n)
    assert n >= 1 and len(bounds) == n
    assert bounds[0][0] == 0 and bounds[-1][1] == T
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))     # no gap, no overlap
    if n > 1:
        assert min(stop - start for start, stop in bounds) >= da_ops.MIN_SPLIT
    # two blocks per SM at most; one split when B * KV fills the card
    assert n == 1 or B * KV * n <= 2 * da_ops.SMS
    if B * KV > da_ops.SMS or T < 2 * da_ops.MIN_SPLIT:
        assert n == 1


def test_short_caches_and_full_batches_take_one_split():
    assert da_ops.plan_splits(4, 5, 96) == 1           # the launcher's cache: no scratch, one kernel
    assert da_ops.plan_splits(4, 5, 4096) == 13        # 260 blocks on 132 SMs
    assert da_ops.plan_splits(64, 5, 4096) == 1


def test_require_cuda_raises_on_cpu_tensors():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="CUDA device"):
        _build.require_cuda("rmsnorm", x, torch.ones(8))
    with pytest.raises(ValueError, match="CUDA device"):
        _build.require_cuda("decode_attention", x)


def test_plain_versions_resolve_no_entry_point():
    """A CPU tensor takes the plain version: the library is neither built
    nor loaded and no C entry point is resolved."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 40, generator=g)
    rms_ops.rmsnorm(x, torch.ones(40))
    k = torch.randn(2, 6, 1, 8, generator=g)
    out = da_ops.decode_attention(torch.randn(2, 1, 1, 8, generator=g), k, k,
                                  torch.tensor([3, 6], dtype=torch.int32))
    assert out.shape == (2, 1, 1, 8)
    assert rms_ops._RT.fn is None and da_ops._RT.fn is None
