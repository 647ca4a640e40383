"""Do the flash kernel's checks catch a broken kernel?  (Needs one CUDA card.)

    python3 flash_mutations.py

Builds the port's kernels from copies of ``src/`` in a temporary directory,
each with one deliberate fault in ``csrc/flash_attention.cu``, and reads
what the checks of ``chip_smoke.py`` phase 10 and of
``tests/test_torch_gpu.py`` read on it:

* ``excess``: bf16 outputs with float32 softmax weights (``p_bf16=False``)
  against the float32 plain version on the same inputs, beyond half a bf16
  ulp (phase 10 holds the kernel to 2e-4, and needs the plain version with
  bf16 weights, the control, above it), and the plain tolerance's reading;
* ``gemma``: a depth-2 gemma-2b prefill with ``Policy(attn_p_bf16=True)``
  in bf16, card against CPU, relative to each reading's scale: the logits,
  each layer's attention output against the plain version on the card's
  own inputs, and the first layer's attention output against the CPU's
  (``test_gemma_prefill_with_bf16_softmax_weights_card_equals_cpu``,
  limits 2e-2);
* ``load``: the gemma 2048-token shape on four streams at once beside a
  busy copy, every output equal bit for bit to a launch on an idle card
  (``test_flash_attention_is_deterministic_under_concurrent_load``).

The faults: P_lo dropped (one PV product on bf16 P), a causal mask off by
one, the block's first kv tile dropped, and the K/V ring without its
"empty" barriers (the wait on "full" alone, which may pass one phase
early).  The unchanged kernel must pass every check, and each of the first
three faults must fail the check named beside it; the fourth is a race
that needs a load slower than two tiles of compute, so its reading is
printed, not required.  Exits 0 when all of that holds.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
CU = Path("src/repro_torch/kernels/csrc/flash_attention.cu")
EXCESS_LIMIT = 2e-4
GEMMA_LIMIT = 2e-2


def _replace(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise AssertionError(f"mutation anchor found {text.count(old)} times: {old!r}")
    return text.replace(old, new)


MUTATIONS = {
    "drop P_lo": lambda t: _replace(
        t, "    if (!s.p_bf16) pv_steps<NCH>(acc, plo, vd, std::make_integer_sequence<int, "
           "4 * NCH>{});\n", ""),
    "causal mask off by one": lambda t: _replace(
        t, "          if (s.causal) ok = ok && kpos <= qpos;\n",
        "          if (s.causal) ok = ok && kpos < qpos;\n"),
    "first kv tile dropped": lambda t: _replace(
        t, "    // online softmax over this thread's two rows (a quad shares a row)\n",
        "    if (i == 0)\n#pragma unroll\n      for (int x = 0; x < 32; ++x) sc[x] = kNegInf;\n"
        "    // online softmax over this thread's two rows (a quad shares a row)\n"),
    "no empty barriers": lambda t: _replace(_replace(
        t, "    if (phase > 0) mbar_wait(empty0 + 8 * st, (phase - 1) & 1);\n", ""),
        "      mbar_wait(empty0 + 8 * st, phase & 1);\n", ""),
}
# which probe must fail on each fault
CAUGHT_BY = {"drop P_lo": "excess", "causal mask off by one": "gemma",
             "first kv tile dropped": "gemma", "no empty barriers": None}


def probe_excess() -> bool:
    import chip_smoke
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    kernel = control = err = 0.0
    cases = [(1, 8, sq, 256) for sq in (100, 512, 2048)]
    cases += [(2, 2, 300, 192), (4, 2, 300, 128), (2, 1, 300, 64)]
    for g, p, sq, hd in cases:
        q = torch.randn((g, p, sq, hd), generator=gen, device=dev).to(bf16)
        k = torch.randn((g, sq, hd), generator=gen, device=dev).to(bf16)
        v = torch.randn((g, sq, hd), generator=gen, device=dev).to(bf16)
        for causal, window in ((True, 0), (False, 0), (True, 96)):
            kw = dict(causal=causal, window=window)
            ref = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
            got = flash_attention(q, k, v, **kw)
            want = flash_attention_plain(q, k, v, **kw)
            err = max(err, float((got.float() - want.float()).abs().max()))
            kernel = max(kernel, chip_smoke.excess_over_bf16_rounding(got, ref))
            control = max(control, chip_smoke.excess_over_bf16_rounding(
                flash_attention_plain(q, k, v, p_bf16=True, **kw), ref))
    ok = kernel <= EXCESS_LIMIT < control and err <= 2e-2
    print(f"    excess: kernel {kernel:.4g} (limit {EXCESS_LIMIT:g}), control {control:.4g}; "
          f"max abs error against the plain version {err:.4g} (limit 2e-2)", flush=True)
    return ok


def probe_gemma() -> bool:
    import dataclasses

    import chip_smoke
    from repro_torch.configs.registry import get_config
    from repro_torch.models import attention, model
    from repro_torch.models.modules import Policy

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    seen = {"cpu": [], "cuda": []}
    model_flash = attention.flash_attention

    def recorded(q, k, v, **kw):
        out = model_flash(q, k, v, **kw)
        seen[q.device.type].append((q, k, v, kw, out))
        return out

    def rel(got, want):
        got, want = got.float().cpu(), want.float().cpu()
        return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))

    attention.flash_attention = recorded
    cfg = dataclasses.replace(get_config("gemma-2b"), num_layers=2)
    pol = Policy(param_dtype=bf16, compute_dtype=bf16, attn_p_bf16=True)
    params = model.init_params(cfg, 0, pol, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 200)))
    want, _ = model.prefill(params, {"tokens": toks}, cfg, pol, max_len=208)
    got, _ = model.prefill(chip_smoke._to(params, dev), {"tokens": toks.to(dev)}, cfg, pol,
                           max_len=208)
    logits = rel(got[0, :, :cfg.vocab_size], want[0, :, :cfg.vocab_size])
    own = [rel(out, model_flash(q.cpu(), k.cpu(), v.cpu(), **kw))
           for q, k, v, kw, out in seen["cuda"]]
    first = rel(seen["cuda"][0][-1], seen["cpu"][0][-1])
    print(f"    gemma: logits {logits:.4g}, attention against the plain version "
          f"{', '.join(f'{x:.4g}' for x in own)}, first layer's attention against the CPU "
          f"{first:.4g} (limits {GEMMA_LIMIT:g})", flush=True)
    return max(logits, first, *own) <= GEMMA_LIMIT


def probe_load() -> bool:
    from repro_torch.kernels.flash_attention import flash_attention

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    q = torch.randn((1, 8, 2048, 256), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((1, 2048, 256), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((1, 2048, 256), generator=gen, device=dev).to(torch.bfloat16)
    src = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    streams = [torch.cuda.Stream() for _ in range(5)]
    differ = total = 0
    for p_bf16 in (False, True):
        want = flash_attention(q, k, v, causal=True, p_bf16=p_bf16)
        torch.cuda.synchronize()
        outs = []
        for _ in range(24):
            with torch.cuda.stream(streams[4]):
                for _ in range(4):
                    dst.copy_(src)
            for st in streams[:4]:
                with torch.cuda.stream(st):
                    outs.append(flash_attention(q, k, v, causal=True, p_bf16=p_bf16))
        torch.cuda.synchronize()
        differ += sum(not torch.equal(out, want) for out in outs)
        total += len(outs)
    print(f"    load: {differ} of {total} outputs differ from the idle card's", flush=True)
    return differ == 0


PROBES = {"excess": probe_excess, "gemma": probe_gemma, "load": probe_load}


def run_probe(root: Path, name: str) -> bool:
    """One probe in a fresh process that imports the port from ``root``."""
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable, str(REPO / "flash_mutations.py"), "--probe", name],
                          env=env, cwd=REPO, timeout=900)
    return proc.returncode == 0


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_mutations: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--probe"]:
        return 0 if PROBES[sys.argv[2]]() else 1
    good = True
    print("unchanged kernel", flush=True)
    for name in PROBES:
        passed = run_probe(REPO, name)
        good &= passed
        print(f"  {name}: {'pass' if passed else 'FAIL'}", flush=True)
    with tempfile.TemporaryDirectory(prefix="flash_mutations_") as tmp:
        for fault, mutate in MUTATIONS.items():
            root = Path(tmp) / fault.replace(" ", "_")
            shutil.copytree(REPO / "src", root / "src",
                            ignore=shutil.ignore_patterns("__pycache__"))
            (root / CU).write_text(mutate((REPO / CU).read_text()))
            print(f"fault: {fault}", flush=True)
            for name in PROBES:
                passed = run_probe(root, name)
                caught = CAUGHT_BY[fault] == name
                if caught:
                    good &= not passed
                print(f"  {name}: {'pass' if passed else 'FAIL'}"
                      f"{' (must fail)' if caught else ''}", flush=True)
    print("all faults caught, unchanged kernel passes" if good else "NOT as required")
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())
