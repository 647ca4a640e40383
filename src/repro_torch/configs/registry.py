"""Architecture registry: ``--arch <id>`` resolution."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, SHAPES, ShapeConfig, cells_for, reduce_for_smoke

_MODULES = {
    "whisper-base": "repro_torch.configs.whisper_base",
    "gemma3-27b": "repro_torch.configs.gemma3_27b",
    "deepseek-coder-33b": "repro_torch.configs.deepseek_coder_33b",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick_400b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    import importlib

    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).CONFIG


def all_cells() -> list[tuple[str, str]]:
    """Every (arch, shape) pair that must pass the dry-run."""
    return [(a, s) for a in ARCH_IDS for s in cells_for(get_config(a))]
