"""Assigned architecture configs (``--arch <id>``).

Each module defines ``CONFIG`` (the exact assigned full-scale config,
with its source citation) and ``smoke_config()`` (the reduced variant
used by CPU smoke tests: 2 layers, d_model<=512, <=4 experts).

The port's copy of ``repro.configs``, all ten ids: the decoder-only
attention architectures (``deepseek_v3_671b``, ``phi3_5_moe_42b``,
``qwen3_8b``, ``phi3_mini_3_8b``, ``minitron_4b``, ``gemma2_2b``), the
SSM one (``xlstm_350m``), the hybrid one (``zamba2_1_2b``), the
encoder-decoder one (``whisper_large_v3``) and the vision one
(``phi_3_vision_4_2b``).
"""

from __future__ import annotations

import importlib

ARCHITECTURES = (
    "whisper_large_v3",
    "minitron_4b",
    "xlstm_350m",
    "qwen3_8b",
    "phi3_mini_3_8b",
    "deepseek_v3_671b",
    "zamba2_1_2b",
    "phi3_5_moe_42b",
    "phi_3_vision_4_2b",
    "gemma2_2b",
)

# CLI ids (dashed) -> module names
ARCH_IDS = {
    "whisper-large-v3": "whisper_large_v3",
    "minitron-4b": "minitron_4b",
    "xlstm-350m": "xlstm_350m",
    "qwen3-8b": "qwen3_8b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "zamba2-1.2b": "zamba2_1_2b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "gemma2-2b": "gemma2_2b",
}


def get_config(arch_id: str):
    mod_name = ARCH_IDS.get(arch_id, arch_id.replace("-", "_").replace(".", "_"))
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def get_smoke_config(arch_id: str):
    mod_name = ARCH_IDS.get(arch_id, arch_id.replace("-", "_").replace(".", "_"))
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.smoke_config()


def all_arch_ids() -> list[str]:
    return list(ARCH_IDS)
