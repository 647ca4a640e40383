"""The sketch kernel's launch plan and column arithmetic, held on the CPU.

``repro_torch.kernels.sketch_update.plan`` computes the launch from the
shapes alone (the path, the grid, the blocks the rows are split over, the
shared memory, the scratch and the fastmod constant), so its rules are
checked here without a card; ``fastmod`` mirrors the kernel's remainder
by an invariant divisor and must equal ``x % width`` for every uint32.
The plain version is held to the Pallas kernel (interpret mode) on skewed
stacked keys, exactly: the sketch counts 1.0s, exact below 2**24.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.generators import zipf_keys
from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels.sketch_update import (CLUSTER, MAX_WIDTH, SHARED_BYTES, fastmod,
                                               fastmod_magic, plan, sketch_update)


# (depth, width): rows of a block under 200 KiB, then above it
RULE_SHAPES = [(1, 1), (4, 3), (4, 2048), (4, 8192), (6, 8192), (1, MAX_WIDTH - 1),
               (8, 8192), (2, 40_961), (5, 20_000), (7, 12_000), (8, MAX_WIDTH)]


@pytest.mark.parametrize("depth,width", RULE_SHAPES)
def test_plan_rules(depth, width):
    """A block's rows, each padded to 16 bytes, fit in its shared memory;
    rows are split over the fewest blocks of a cluster (a power of two)
    that makes them fit; the clusters of a call fit on the card at once
    unless there are more workers than clusters; the scratch holds the
    tickets and one partial sketch a cluster."""
    for w, n in [(1, 10_000_000), (3, 5000), (35, 0)]:
        p = plan(w, n, depth, width, resident_clusters=15)
        assert p.path == ("shared" if p.split == 1 else "split")
        assert p.split in (1, 2, 4, 8) and p.split * p.rows_per_block >= depth
        assert p.rows_per_block * width * 4 <= p.shared_bytes <= SHARED_BYTES
        assert p.shared_bytes % 16 == 0
        if p.split > 1:  # the fewest blocks: half as many would not fit
            assert -(-depth // (p.split // 2)) * width * 4 > SHARED_BYTES
        assert p.grid == (p.clusters * CLUSTER, w) and p.clusters >= 1
        assert p.clusters * w <= max(15, w)
        assert p.partial_shape[:2] == (p.clusters, w) and p.partial_shape[2] >= depth * width
        assert p.scratch_ints == w * CLUSTER + int(np.prod(p.partial_shape))


@pytest.mark.parametrize("w,n,depth,width,want", [
    (1, 10_000_000, 4, 2048, ("shared", (120, 1), 15, 1, 32_768)),   # the batch path
    (1, 10_000_000, 4, 8192, ("shared", (120, 1), 15, 1, 131_072)),
    (1, 10_000_000, 8, 8192, ("split", (120, 1), 15, 2, 131_072)),   # 256 KiB of rows
    (1, 1000, 1, 1000, ("shared", (8, 1), 1, 1, 4000)),
    (35, 285_714, 4, 2048, ("shared", (8, 35), 1, 1, 32_768)),
    (3, 2_000_000, 5, 20_000, ("split", (40, 3), 5, 4, 160_000)),
    (1, 32_768, 4, 2048, ("shared", (8, 1), 1, 1, 32_768)),          # one cluster's step
    (1, 32_768 * 10, 4, 2048, ("shared", (80, 1), 10, 1, 32_768)),
    (1, 40_000, 3, 1001, ("shared", (16, 1), 2, 1, 12_048)),        # rows padded to 1004
    (1, 2**20 + 7, 2, 40_961, ("split", (120, 1), 15, 2, 163_856)),
])
def test_plan_at_known_shapes(w, n, depth, width, want):
    p = plan(w, n, depth, width, resident_clusters=15)
    assert (p.path, p.grid, p.clusters, p.split, p.shared_bytes) == want


@pytest.mark.parametrize("depth,width", [(0, 2048), (9, 2048), (4, 0), (1, MAX_WIDTH + 1)])
def test_plan_rejects_what_the_kernel_does_not_take(depth, width):
    with pytest.raises(ValueError, match="depth"):
        plan(1, 100, depth, width, resident_clusters=15)


EDGES = np.array([0, 1, 2**31, 2**32 - 1], dtype=np.uint64)


@pytest.mark.parametrize("widths", [range(1, 1026), range(1026, 2051), range(2051, 3076),
                                    range(3076, 4101), [2**20 + 7, 2**31 - 1, 2**32 - 1]],
                         ids=["1-1025", "1026-2050", "2051-3075", "3076-4100", "large"])
def test_fastmod_equals_the_remainder(widths):
    """fastmod(x, 2**64 // width + 1 mod 2**64, width) == x % width for x in
    {0, 1, width - 1, width, width + 1, 2**31, 2**32 - 1} and 10,000
    seeded uint32, with the uint64 arithmetic the kernel does and with
    Python ints."""
    rng = np.random.default_rng(len(widths))
    rand = rng.integers(0, 2**32, 10_000, dtype=np.uint64)
    for width in widths:
        magic = fastmod_magic(width)
        near = np.array([width - 1, width, width + 1], dtype=np.uint64) % np.uint64(2**32)
        x = np.concatenate([EDGES, near, rand])
        np.testing.assert_array_equal(fastmod(x, magic, width), x % np.uint64(width))
        for v in (0, 1, width - 1, width, width + 1, 2**31, 2**32 - 1):
            v %= 2**32
            assert fastmod(v, magic, width) == v % width


def test_fastmod_constant_is_lemires():
    assert fastmod_magic(1) == 1  # 2**64 + 1 mod 2**64
    assert fastmod_magic(3) == 0x5555555555555556
    assert fastmod_magic(2048) == 2**53 + 1


@pytest.mark.parametrize("depth,width", [(4, 2048), (3, 1000), (8, 777)])
def test_plain_version_equals_pallas_on_skewed_stacked_keys(depth, width):
    """Three workers of skewed keys (exponent 2.0) with invalid records: the
    port's sketch of the stacked [3, n] keys (its wrapper, on the CPU the
    plain version) equals the Pallas kernel (interpret mode) run on each
    worker's keys, exactly."""
    w, n = 3, 700
    keys = zipf_keys(w * n, num_keys=300, exponent=2.0, seed=depth + width).astype(np.int32)
    valid = np.random.default_rng(width).random(w * n) < 0.85
    got = sketch_update(torch.as_tensor(keys).view(w, n), torch.as_tensor(valid).view(w, n),
                        depth=depth, width=width)
    assert got.shape == (w, depth, width) and got.dtype == torch.float32
    for i in range(w):
        sl = slice(i * n, (i + 1) * n)
        want = jops.count_sketch(jnp.asarray(keys[sl]), jnp.asarray(valid[sl]), depth=depth,
                                 width=width)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
        assert float(got[i].max()) > 0.5 * valid[sl].sum()  # the hot key's cells
    np.testing.assert_array_equal(
        tops.count_sketch(torch.as_tensor(keys[:n]), torch.as_tensor(valid[:n]), depth=depth,
                          width=width).numpy(), got[0].numpy())
