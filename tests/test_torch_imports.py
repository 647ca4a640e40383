"""The port's boundary: it imports with jax blocked, imports neither jax nor
the reference package anywhere, targets the CUDA device by default, and
hands a CUDA tensor only to a kernel, never to a plain version."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.kernels.dispatch_count as dc_mod
import repro_torch.kernels.flash_attention as fa_mod
import repro_torch.kernels.lookup_dispatch as ld_mod
import repro_torch.kernels.partition_apply as pa_mod
import repro_torch.kernels.route_bucketize as rb_mod
import repro_torch.kernels.sketch_update as su_mod
from repro_torch.compat import resolve_device
from repro_torch.core.replay import BatchJob
from repro_torch.core.streaming import StreamingJob
from repro_torch.kernels import build
from repro_torch.kernels.ref import lookup_dispatch_ref, route_bucketize_ref

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "flash_mutations.py", REPO / "route_mutations.py",
    REPO / "rank_ab.py", REPO / "route_ab.py", REPO / "sketch_ab.py", REPO / "dist_probe.py",
    REPO / "tests" / "dist_cases.py", REPO / "tests" / "train_dist_cases.py"]
SENT = 2**31 - 1


def test_import_with_jax_blocked():
    """Every module of the package imports with ``jax`` and ``repro``
    unimportable."""
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "assert 'repro_torch.models.xlstm' in names\n"
        "assert 'repro_torch.models.encdec' in names\n"
        "assert 'repro_torch.models.ssm' in names\n"
        "assert 'repro_torch.exchange.dist' in names\n"
        "assert {'repro_torch.train.compression', 'repro_torch.launch.pipeline',\n"
        "        'repro_torch.launch.sharding', 'repro_torch.launch.mesh'} <= set(names)\n"
        "for n in names: importlib.import_module(n)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'jaxlib', 'repro.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print(len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO / "src",
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 20


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}:{node.lineno} imports {name}"


def test_streaming_job_defaults_to_cuda():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        assert StreamingJob().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            StreamingJob()
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
    assert StreamingJob(device="cpu").state_keys.device.type == "cpu"


def test_batch_job_defaults_to_cuda():
    if torch.cuda.is_available():
        assert BatchJob(8).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            BatchJob(8)
    res = BatchJob(8, device="cpu").run(np.arange(1000))
    assert res.assignments.device.type == "cpu"


def _inputs():
    rng = np.random.default_rng(0)
    keys = torch.as_tensor(rng.integers(0, 2**30, (2, 300)).astype(np.int32))
    valid = torch.ones((2, 300), dtype=torch.bool)
    vals = torch.ones((2, 300, 1), dtype=torch.float32)
    hk = torch.full((128,), SENT, dtype=torch.int32)
    hp = torch.zeros(128, dtype=torch.int32)
    h2p = torch.as_tensor(np.arange(4096, dtype=np.int32) % 4)
    return keys, valid, vals, hk, hp, h2p


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    keys, valid, vals, hk, hp, h2p = _inputs()
    before = (ld_mod.lookup_dispatch.launches, rb_mod.route_bucketize.launches)
    got = ld_mod.lookup_dispatch(keys, valid, hk, hp, h2p, num_lanes=4)
    for g, w in zip(got, lookup_dispatch_ref(keys, valid, hk, hp, h2p, num_lanes=4)):
        assert torch.equal(g, w)
    got = rb_mod.route_bucketize(keys, valid, vals, hk, hp, h2p, num_lanes=4,
                                 capacity=64, key_fill=SENT)
    want = route_bucketize_ref(keys, valid, vals, hk, hp, h2p, num_lanes=4,
                               capacity=64, key_fill=SENT)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the least-load pick (a load vector with a split table) too
    hr = torch.ones(128, dtype=torch.int32)
    loads = torch.arange(4, dtype=torch.float32)
    got = ld_mod.lookup_dispatch(keys, valid, hk, hp, h2p, hr, num_lanes=4, num_partitions=4,
                                 part_loads=loads)
    for g, w in zip(got, lookup_dispatch_ref(keys, valid, hk, hp, h2p, num_lanes=4,
                                             heavy_repl=hr, num_partitions=4,
                                             part_loads=loads)):
        assert torch.equal(g, w)
    assert (ld_mod.lookup_dispatch.launches, rb_mod.route_bucketize.launches) == before


def test_cuda_tensor_never_reaches_a_plain_version(monkeypatch):
    """A CUDA tensor goes to the kernel path (here: to the library build,
    made to fail) and never to a plain version; a tensor on any other
    non-CPU device is refused."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def plain_called(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    class NoLibrary(RuntimeError):
        pass

    def no_library():
        raise NoLibrary("kernel path taken")

    monkeypatch.setattr(ld_mod, "lookup_dispatch_plain", plain_called)
    monkeypatch.setattr(rb_mod, "route_bucketize_plain", plain_called)
    monkeypatch.setattr(pa_mod, "partition_apply_plain", plain_called)
    monkeypatch.setattr(dc_mod, "dispatch_count_plain", plain_called)
    monkeypatch.setattr(su_mod, "sketch_update_plain", plain_called)
    monkeypatch.setattr(fa_mod, "flash_attention_plain", plain_called)
    monkeypatch.setattr(build, "library", no_library)
    with FakeTensorMode():
        keys = torch.zeros((2, 300), dtype=torch.int32, device="cuda")
        valid = torch.ones((2, 300), dtype=torch.bool, device="cuda")
        vals = torch.ones((2, 300, 1), dtype=torch.float32, device="cuda")
        hk = torch.full((128,), SENT, dtype=torch.int32, device="cuda")
        hp = torch.zeros(128, dtype=torch.int32, device="cuda")
        h2p = torch.zeros(4096, dtype=torch.int32, device="cuda")
        assert keys.device.type == "cuda"
        with pytest.raises(NoLibrary):
            ld_mod.lookup_dispatch(keys, valid, hk, hp, h2p, num_lanes=4)
        with pytest.raises(NoLibrary):
            rb_mod.route_bucketize(keys, valid, vals, hk, hp, h2p, num_lanes=4,
                                   capacity=64, key_fill=SENT)
        # the least-load pick goes to the kernels as well
        hr = torch.ones(128, dtype=torch.int32, device="cuda")
        loads = torch.zeros(8, dtype=torch.float32, device="cuda")
        with pytest.raises(NoLibrary):
            ld_mod.lookup_dispatch(keys, valid, hk, hp, h2p, hr, num_lanes=4,
                                   num_partitions=8, part_loads=loads)
        with pytest.raises(NoLibrary):
            rb_mod.route_bucketize(keys, valid, vals, hk, hp, h2p, hr, num_lanes=4,
                                   capacity=64, key_fill=SENT, num_partitions=8,
                                   part_loads=loads)
        with pytest.raises(ValueError, match="part_loads"):
            ld_mod.lookup_dispatch(keys, valid, hk, hp, h2p, hr, num_lanes=4,
                                   num_partitions=4, part_loads=loads)
        with pytest.raises(ValueError, match="part_loads"):
            rb_mod.route_bucketize(keys, valid, vals, hk, hp, h2p, hr, num_lanes=4,
                                   capacity=64, key_fill=SENT, num_partitions=8,
                                   part_loads=loads.to(torch.float64))
        with pytest.raises(NoLibrary):
            pa_mod.partition_apply(keys, hk, hp, h2p)
        with pytest.raises(NoLibrary):
            none = torch.empty(0, dtype=torch.int32, device="cuda")
            pa_mod.partition_apply(keys, none, none, h2p)  # B = 0 is taken
        with pytest.raises(NoLibrary):
            dc_mod.dispatch_count(keys, valid, num_parts=1024)
        with pytest.raises(NoLibrary):
            su_mod.sketch_update(keys, valid, depth=8, width=1000)
        # checked before any launch
        with pytest.raises(ValueError, match="int32"):
            ld_mod.lookup_dispatch(keys.long(), valid, hk, hp, h2p, num_lanes=4)
        with pytest.raises(ValueError, match="power of two"):
            pa_mod.partition_apply(keys, hk, hp, h2p, num_hosts=1000)
        with pytest.raises(ValueError, match="num_parts"):
            dc_mod.dispatch_count(keys, valid, num_parts=1025)
        with pytest.raises(ValueError, match="depth"):
            su_mod.sketch_update(keys, valid, depth=9)
        with pytest.raises(ValueError, match="bool"):
            su_mod.sketch_update(keys, keys, depth=2)
        def qkv(g, p, sq, sk, hd, dtype=torch.bfloat16):
            return (torch.zeros((g, p, sq, hd), dtype=dtype, device="cuda"),
                    torch.zeros((g, sk, hd), dtype=dtype, device="cuda"),
                    torch.zeros((g, sk, hd), dtype=dtype, device="cuda"))

        with pytest.raises(NoLibrary):
            fa_mod.flash_attention(*qkv(2, 8, 100, 100, 256), causal=True)  # ragged Sq
        with pytest.raises(NoLibrary):
            fa_mod.flash_attention(*qkv(3, 1, 1, 7, 16, torch.float32), causal=False,
                                   window=96)
        with pytest.raises(NoLibrary):
            fa_mod.flash_attention(*qkv(1, 8, 64, 64, 256), causal=True, p_bf16=True)
        for hd in (24, 8, 272):
            with pytest.raises(ValueError, match="head_dim"):
                fa_mod.flash_attention(*qkv(1, 2, 64, 64, hd), causal=True)
        with pytest.raises(ValueError, match="float32 or all bf16"):
            fa_mod.flash_attention(*qkv(1, 2, 64, 64, 64, torch.float16), causal=True)
        # the backward (the models' layout): its kernel is taken, its plain version never
        monkeypatch.setattr(fa_mod, "flash_attention_bwd_plain", plain_called)
        monkeypatch.setattr(fa_mod, "flash_attention_bwd_seq_major_plain", plain_called)

        def qkv_s(b, sq, sk, g, p, hd, dtype=torch.bfloat16):
            return (torch.zeros((b, sq, g, p, hd), dtype=dtype, device="cuda"),
                    torch.zeros((b, sk, g, hd), dtype=dtype, device="cuda"),
                    torch.zeros((b, sk, g, hd), dtype=dtype, device="cuda"))

        for dtype, hd in ((torch.bfloat16, 256), (torch.float32, 16), (torch.bfloat16, 128)):
            q, k, v = qkv_s(1, 100, 100, 2, 5, hd, dtype)
            with pytest.raises(NoLibrary):
                fa_mod.flash_attention_bwd_seq_major(q, k, v, q, q, causal=True, window=32)
        for hd in (48, 8, 272):
            q, k, v = qkv_s(1, 64, 64, 1, 2, hd, torch.float32)
            with pytest.raises(ValueError, match="head_dim"):
                fa_mod.flash_attention_bwd_seq_major(q, k, v, q, q, causal=True)
        q, k, v = qkv_s(1, 64, 64, 1, 2, 64)
        with pytest.raises(ValueError, match="float32 or"):
            fa_mod.flash_attention_bwd_seq_major(q, k, v, q, q.float(), causal=True)
        with pytest.raises(ValueError, match="does not match"):
            fa_mod.flash_attention_bwd_seq_major(q, k, qkv_s(1, 64, 32, 1, 2, 64)[2], q, q,
                                                 causal=True)
        q, k, v = qkv_s(2, 64, 64, 1, 8, 256)
        with pytest.raises(NoLibrary):
            fa_mod.flash_attention_bwd_seq_major(q, k, v, q.reshape(2, 64, -1),
                                                 q.reshape(2, 64, -1), causal=True)
    meta = [t.to("meta") for t in _inputs()]
    with pytest.raises(ValueError, match="CUDA"):
        ld_mod.lookup_dispatch(meta[0], meta[1], *meta[3:], num_lanes=4)
    with pytest.raises(ValueError, match="CUDA"):
        pa_mod.partition_apply(meta[0], *meta[3:])
    with pytest.raises(ValueError, match="CUDA"):
        dc_mod.dispatch_count(meta[0], meta[1], num_parts=4)
    with pytest.raises(ValueError, match="CUDA"):
        su_mod.sketch_update(meta[0], meta[1])
    with pytest.raises(ValueError, match="CUDA"):
        fa_mod.flash_attention(torch.zeros((1, 1, 4, 16), device="meta"),
                               torch.zeros((1, 4, 16), device="meta"),
                               torch.zeros((1, 4, 16), device="meta"), causal=True)


def test_scan_covers_the_failure_domain_modules():
    """The scan above reaches the fault seam and lane health, the port's own
    copies of the reference's ``exchange/faults.py`` and
    ``control/health.py``."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert {"src/repro_torch/exchange/faults.py", "src/repro_torch/control/health.py"} <= names


def test_scan_covers_the_topology_modules():
    """The scan reaches ``launch/mesh.py``, the port's own counterpart of
    the reference's ``exchange_topology_of``, which imports with jax
    blocked and builds the topology from the exchange spec module alone."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert "src/repro_torch/launch/mesh.py" in names
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "from repro_torch.launch.mesh import exchange_topology_of\n"
            "t = exchange_topology_of(8, lanes_per_host=4)\n"
            "print(t.num_lanes, t.lanes_per_host, t.num_hosts)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO / "src",
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == ["8", "4", "2"]


def test_scan_covers_the_moe_modules():
    """The scan reaches the MoE layer and the expert placement, which import
    with jax blocked."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert {"src/repro_torch/moe/layer.py", "src/repro_torch/moe/kip_placement.py",
            "src/repro_torch/moe/__init__.py"} <= names
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "from repro_torch.moe.kip_placement import PlacementController\n"
            "from repro_torch.moe.layer import moe_apply\n"
            "from repro_torch.control import PlacementPolicy\n"
            "print(PlacementController(16, 4).placement.n_shards)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO / "src",
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == ["4"]


def test_scan_covers_the_baseline_modules():
    """The scan reaches the paper's baselines, which import with jax
    blocked, as do the sketches and the generator that came with them."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert "src/repro_torch/core/baselines.py" in names
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "from repro_torch.core import LossyCounting, SpaceSaving, make_baseline\n"
            "from repro_torch.core.baselines import readj_update\n"
            "from repro_torch.core.histogram import Histogram\n"
            "from repro_torch.data.generators import host_skew_keys\n"
            "keys = host_skew_keys(1000, seed=1)\n"
            "update, prev = make_baseline('readj', 4)\n"
            "part = readj_update(prev, Histogram.exact(keys).top(8), 4)\n"
            "ss, lc = SpaceSaving(4), LossyCounting(0.1)\n"
            "ss.update(keys); lc.update(keys)\n"
            "print(part.num_heavy, ss.memory_items, update is readj_update)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO / "src",
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == ["8", "4", "True"]


def test_scan_covers_the_ssm_module():
    """The scan reaches the Mamba mixer, which imports with jax blocked and
    runs a chunked forward on the CPU."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert "src/repro_torch/models/ssm.py" in names
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import torch\n"
            "from repro_torch.models.modules import Policy\n"
            "from repro_torch.models.ssm import init_mamba, mamba_forward\n"
            "p = init_mamba(torch.Generator().manual_seed(0), 16, expand=2, d_state=4, d_conv=4)\n"
            "y, st = mamba_forward(p, torch.ones((1, 8, 16)), Policy(), d_state=4, chunk=4)\n"
            "print(tuple(y.shape), tuple(st['ssm'].shape), tuple(st['conv'].shape))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO / "src",
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split("\n")[0] == "(1, 8, 16) (1, 32, 4) (1, 3, 32)"


def test_scan_covers_the_gradient_sync_pipeline_and_sharding_modules():
    """The scan reaches the int8 gradient sync, the pipeline, the sharding
    rules and the mesh helpers, which import with jax blocked, touch no
    device and no process group, and give the production meshes' specs."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert {"src/repro_torch/train/compression.py", "src/repro_torch/launch/pipeline.py",
            "src/repro_torch/launch/sharding.py", "src/repro_torch/launch/mesh.py",
            "tests/train_dist_cases.py"} <= names
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import torch, torch.distributed as dist\n"
            "from repro_torch.configs.registry import get_config\n"
            "from repro_torch.launch import mesh, pipeline, sharding\n"
            "from repro_torch.models import model\n"
            "from repro_torch.models.modules import Policy\n"
            "from repro_torch.train import compression\n"
            "assert not dist.is_initialized()\n"
            "cfg = get_config('stablelm-1.6b')\n"
            "m = mesh.make_production_mesh()\n"
            "p = model.abstract_params(cfg, Policy(tp=mesh.tp_size(m)))\n"
            "s = sharding.param_shardings(p, m, sharding.default_options(cfg))\n"
            "print(s['layers'][0]['attn']['wq'].spec, mesh.dp_size(m), torch.cuda.is_initialized())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO / "src",
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "(None, 'model', None) 16 False"


def test_device_mesh_and_gradient_sync_refuse_a_group_of_the_wrong_size():
    """A (2, 2) mesh over 3 ranks, a sync over 4 replicas on 2 ranks: both
    raise before touching a collective."""
    import types

    from repro_torch.launch.mesh import MeshShape, device_mesh
    from repro_torch.train.compression import compressed_grad_sync

    group = types.SimpleNamespace(world_size=3, rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="3 ranks"):
        device_mesh(MeshShape((2, 2), ("data", "model")), group)
    with pytest.raises(ValueError, match="4 replicas"):
        compressed_grad_sync(types.SimpleNamespace(world_size=2, rank=0),
                             MeshShape((4, 2), ("data", "model")), ("data",))
    # the replicas along the named axes are what must match
    compressed_grad_sync(types.SimpleNamespace(world_size=2, rank=0),
                         MeshShape((2, 4), ("data", "model")), ("data",))


def test_policy_mesh_still_raises_naming_the_next_slice(tmp_path):
    """``Policy.mesh`` takes a ProcessMesh (a mesh laid over a group's
    ranks); a bare MeshShape, which has no ranks, or anything else raises
    ``ValueError``, and so does a mesh beside stacked EP shards."""
    import mesh_cases
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.modules import Policy

    with pytest.raises(ValueError, match="bare MeshShape"):
        Policy(mesh=make_production_mesh())
    with pytest.raises(ValueError, match="ProcessMesh"):
        Policy(mesh=object())
    with mesh_cases.one_rank_mesh(tmp_path) as pm:
        assert Policy(mesh=pm).mesh is pm
        with pytest.raises(ValueError, match="ep_shards"):
            Policy(mesh=pm, ep_shards=4)
