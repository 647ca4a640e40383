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
    REPO / "chip_smoke.py", REPO / "flash_mutations.py"]
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
