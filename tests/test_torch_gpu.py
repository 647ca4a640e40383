"""The CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA device and the CUDA toolkit (the kernels are built from
``src/repro_torch/kernels/csrc`` at first use); without a device they skip.
Every output of the routing and batch kernels must be equal exactly; the
flash-attention kernel sums in another order than its plain version, so it
is held within 2e-5 in float32 and 2e-2 in bf16 (the reference's own
tolerances, ``tests/test_flash_kernel.py``).  On the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.histogram import CountMinSketch, Histogram
from repro_torch.core.partitioner import kip_update, uniform_partitioner
from repro_torch.core.replay import BatchJob
from repro_torch.core.streaming import StreamingJob
from repro_torch.core.drm import DRConfig
from repro_torch.data.generators import drifting_zipf, zipf_keys
from repro_torch.kernels import ops
from repro_torch.kernels.dispatch_count import dispatch_count, dispatch_count_plain
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.kernels.lookup_dispatch import lookup_dispatch, lookup_dispatch_plain
from repro_torch.kernels.partition_apply import partition_apply, partition_apply_plain
from repro_torch.kernels.route_bucketize import route_bucketize, route_bucketize_plain
from repro_torch.kernels.sketch_update import sketch_update, sketch_update_plain

pytestmark = pytest.mark.gpu
SENT = 2**31 - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _case(w, n, parts, splits, empty, seed):
    stream = zipf_keys(w * n, num_keys=5000, exponent=1.2, seed=seed)
    if empty:
        p = uniform_partitioner(parts)
    else:
        hist = Histogram.exact(stream).top(64)
        p = kip_update(uniform_partitioner(parts, heavy_capacity=128), hist)
        if splits:
            p = p.with_splits({int(hist.keys[i]): d for i, d in enumerate(splits)})
    rng = np.random.default_rng(seed)
    valid = rng.random((w, n)) < 0.9
    keys = np.where(valid, stream.reshape(w, n), SENT).astype(np.int32)
    vals = rng.normal(size=(w, n, 2)).astype(np.float32)
    return p, keys, valid, vals


@pytest.mark.parametrize("w,n,lanes,cap,num_partitions,splits,empty", [
    (1, 1000, 1, 2048, 0, None, False),
    (3, 1000, 3, 200, 8, (4, 3), False),
    (4, 5000, 4, 700, 16, None, True),
    (8, 65536, 8, 4096, 32, (8,), False),
    (2, 2048, 1000, 8, 0, None, False),
])
def test_kernels_equal_plain_versions(cuda, w, n, lanes, cap, num_partitions, splits, empty):
    p, keys, valid, vals = _case(w, n, max(lanes, num_partitions), splits, empty, n)
    k, v, x = (torch.as_tensor(a, device=cuda) for a in (keys, valid, vals))
    t = p.tables(cuda)
    for pad_empty in (True, False):
        hk, hp, hr = ops.pad_heavy_tables(t, num_partitions=num_partitions, pad_empty=pad_empty)
        kw = dict(seed=p.seed, num_hosts=p.num_hosts, num_lanes=lanes,
                  num_partitions=num_partitions)
        before = (lookup_dispatch.launches, route_bucketize.launches)
        got = lookup_dispatch(k, v, hk, hp, t.host_to_part, hr, **kw)
        want = lookup_dispatch_plain(k, v, hk, hp, t.host_to_part, hr, **kw)
        for g, x_ in zip(got, want):
            assert torch.equal(g, x_)
        got = route_bucketize(k, v, x, hk, hp, t.host_to_part, hr, capacity=cap,
                              key_fill=SENT, **kw)
        want = route_bucketize_plain(k, v, x, hk, hp, t.host_to_part, hr, capacity=cap,
                                     key_fill=SENT, **kw)
        torch.cuda.synchronize()
        for g, x_ in zip(got, want):
            assert torch.equal(g, x_)
        assert (lookup_dispatch.launches, route_bucketize.launches) == (before[0] + 1,
                                                                        before[1] + 1)


def test_streaming_job_card_equals_cpu(cuda):
    batches = list(drifting_zipf(4, 16384, num_keys=5000, exponent=1.3, drift_every=2, seed=2))
    jobs = {}
    for device in (cuda, "cpu"):
        jobs[str(device)] = StreamingJob(device=device, num_workers=4, num_partitions=16,
                                         state_capacity=8192,
                                         dr=DRConfig(imbalance_trigger=1.1,
                                                     migration_cost_weight=0.2))
        jobs[str(device)].run(batches)
    card, cpu = jobs["cuda"], jobs["cpu"]
    for a, b in zip(card.metrics, cpu.metrics):
        assert (a.imbalance, a.repartitioned, a.relative_migration, a.overflow, a.reason,
                a.shipped_rows) == (b.imbalance, b.repartitioned, b.relative_migration,
                                    b.overflow, b.reason, b.shipped_rows)
    assert torch.equal(card.state_keys.cpu(), cpu.state_keys)
    assert torch.equal(card.state_vals.cpu(), cpu.state_vals)


@pytest.mark.parametrize("w,n,b,num_hosts,sentinels", [
    (1, 100_000, 256, 4096, False),
    (35, 3000, 0, 4096, True),          # empty heavy table
    (4, 50_000, 256, 4096, True),       # sentinel keys hit pad rows: part 0
    (2, 20_000, 16384, 8192, False),    # tables past the default 48 KB
])
def test_partition_apply_equals_plain(cuda, w, n, b, num_hosts, sentinels):
    rng = np.random.default_rng(n + b)
    keys = zipf_keys(w * n, num_keys=50_000, exponent=1.1, seed=b).astype(np.int32)
    live = np.unique(keys)[: b // 2] if b else np.zeros(0, np.int32)
    hk = np.concatenate([live, np.full(b - len(live), SENT, np.int32)]).astype(np.int32)
    hp = np.concatenate([rng.integers(0, 35, len(live)), np.zeros(b - len(live))])
    if sentinels:
        keys[rng.random(len(keys)) < 0.1] = SENT
    args = [torch.as_tensor(a, dtype=torch.int32, device=cuda) for a in
            (keys.reshape(w, n), hk, hp, rng.integers(0, 35, num_hosts))]
    before = partition_apply.launches
    got = partition_apply(*args, seed=3, num_hosts=num_hosts)
    want = partition_apply_plain(*args, seed=3, num_hosts=num_hosts)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and partition_apply.launches == before + 1


@pytest.mark.parametrize("w,n,num_parts", [(1, 1_000_000, 35), (3, 5000, 1),
                                           (2, 70_000, 1024), (8, 2048, 7)])
def test_dispatch_count_equals_plain(cuda, w, n, num_parts):
    rng = np.random.default_rng(n)
    dest = rng.integers(-2, num_parts + 2, (w, n)).astype(np.int32)
    valid = rng.random((w, n)) < 0.8
    d, v = torch.as_tensor(dest, device=cuda), torch.as_tensor(valid, device=cuda)
    before = dispatch_count.launches
    got = dispatch_count(d, v, num_parts=num_parts)
    want = dispatch_count_plain(d, v, num_parts=num_parts)
    torch.cuda.synchronize()
    assert all(torch.equal(g, x) for g, x in zip(got, want))
    assert dispatch_count.launches == before + 1
    got1 = dispatch_count(d[0].contiguous(), v[0].contiguous(), num_parts=num_parts)
    assert all(torch.equal(g, x[0]) for g, x in zip(got1, want))


@pytest.mark.parametrize("w,depth,width", [(1, 4, 2048), (1, 8, 8192), (3, 1, 1000),
                                           (2, 8, 2048), (1, 4, 8192)])
def test_sketch_update_equals_plain(cuda, w, depth, width):
    rng = np.random.default_rng(width + depth)
    keys = zipf_keys(w * 200_000, num_keys=100_000, exponent=1.4, seed=depth)
    k = torch.as_tensor(keys.astype(np.int32).reshape(w, -1), device=cuda)
    v = torch.as_tensor(rng.random(k.shape) < 0.9, device=cuda)
    before = sketch_update.launches
    got = sketch_update(k, v, depth=depth, width=width)
    want = sketch_update_plain(k, v, depth=depth, width=width)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and sketch_update.launches == before + 1
    cms = CountMinSketch(depth, width)
    cms.update(keys[: k.shape[1]][v[0].cpu().numpy()])
    np.testing.assert_array_equal(got[0].cpu().numpy().astype(np.float64), cms.table)


def test_batch_job_card_equals_cpu(cuda):
    keys = zipf_keys(400_000, num_keys=50_000, exponent=1.2, seed=12)
    dr = DRConfig(mode="batch", lam=4.0, eps=0.003)
    before = partition_apply.launches
    card = BatchJob(35, dr=dr, device=cuda).run(keys)
    cpu = BatchJob(35, dr=dr, device="cpu").run(keys)
    assert partition_apply.launches == before + 2
    assert (card.imbalance_before, card.imbalance_after, card.replayed_records) == (
        cpu.imbalance_before, cpu.imbalance_after, cpu.replayed_records)
    assert card.assignments.device.type == "cuda"
    assert torch.equal(card.assignments.cpu(), cpu.assignments)
    np.testing.assert_array_equal(card.assignments.cpu().numpy(),
                                  card.partitioner.lookup_np(keys))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,p,sq,hd", [
    (1, 8, 1, 256), (1, 8, 100, 256), (1, 8, 300, 256),      # gemma-2b: MQA, P = 8
    (3, 2, 7, 16), (2, 2, 300, 64), (4, 1, 129, 128), (2, 2, 100, 192), (1, 4, 2048, 128),
])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 96)])
def test_flash_attention_equals_plain(cuda, dtype, g, p, sq, hd, causal, window):
    gen = torch.Generator(device=cuda).manual_seed(sq * hd + g)
    q = torch.randn((g, p, sq, hd), generator=gen, device=cuda).to(dtype)
    k = torch.randn((g, sq, hd), generator=gen, device=cuda).to(dtype)
    v = torch.randn((g, sq, hd), generator=gen, device=cuda).to(dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape and bool(torch.isfinite(got).all())
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_attention_q_offset_and_unequal_lengths(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((2, 3, 50, 64), generator=gen, device=cuda)
    k = torch.randn((2, 170, 64), generator=gen, device=cuda)
    v = torch.randn((2, 170, 64), generator=gen, device=cuda)
    for causal, window in ((True, 0), (True, 40), (False, 0)):
        got = flash_attention(q, k, v, causal=causal, window=window, q_offset=120)
        want = flash_attention_plain(q, k, v, causal=causal, window=window, q_offset=120)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_flash_attention_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 8, 64, 256), dtype=torch.bfloat16, device=cuda)
    k = torch.zeros((1, 64, 256), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(NotImplementedError, match="attn_p_bf16"):
        flash_attention(q, k, k, causal=True, p_bf16=True)
    for hd in (8, 24, 272):
        qh, kh = torch.zeros((1, 8, 64, hd), device=cuda), torch.zeros((1, 64, hd), device=cuda)
        with pytest.raises(ValueError, match="head_dim"):
            flash_attention(qh, kh, kh, causal=True)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(2, 3), k, k, causal=True)


def test_serve_engine_card_equals_cpu(cuda):
    """Smoke gemma-2b and gemma3 in float32 (TF32 off): the card's engine
    gives the CPU's tokens, with one flash launch per layer per prefill."""
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model
    from repro_torch.models.modules import Policy
    from repro_torch.serve.engine import Request, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    for arch in ("gemma-2b", "gemma3-27b"):
        cfg = reduce_for_smoke(get_config(arch))
        pol = Policy()
        params = model.init_params(cfg, 0, pol, device="cpu")
        card_params = {k: _to(v, cuda) for k, v in params.items()}
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, cfg.vocab_size, 20).astype(np.int32) for _ in range(3)]
        out = {}
        before = flash_attention.launches
        for dev, p in (("cpu", params), (cuda, card_params)):
            reqs = [Request(i, pr, 5) for i, pr in enumerate(prompts)]
            ServeEngine(cfg, p, pol, slots=2, max_len=32, device=dev).run(reqs)
            out[str(dev)] = [r.out_tokens for r in reqs]
        assert flash_attention.launches == before + 3 * cfg.num_layers
        assert out["cuda"] == out["cpu"]


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)
