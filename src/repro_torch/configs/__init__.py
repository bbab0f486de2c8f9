"""Architecture registry of the port: `--arch <id>` resolves here (port of
`repro.configs`).

Every reference architecture is listed and built by the port (`PORTED`);
`_PENDING` is empty: `get_config` raises `NotImplementedError` for an
architecture listed there, naming the ROADMAP item that brings it.
"""
from __future__ import annotations

import importlib

ARCHS = {
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b_a66b",
    "llama3.2-3b": "llama32_3b",
    "qwen1.5-32b": "qwen15_32b",
    "minicpm3-4b": "minicpm3_4b",
    "phi4-mini-3.8b": "phi4_mini_38b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "rwkv6-7b": "rwkv6_7b",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "hubert-xlarge": "hubert_xlarge",
}

#: Architectures the port builds, and what any other would wait for.
PORTED = ("llama3.2-3b", "phi4-mini-3.8b", "qwen1.5-32b",
          "recurrentgemma-9b", "minicpm3-4b", "phi3.5-moe-42b-a6.6b",
          "kimi-k2-1t-a32b", "rwkv6-7b", "llama-3.2-vision-11b",
          "hubert-xlarge")
_PENDING: dict[str, str] = {}

# Paper Table 2 code schemes (used by the EC checkpoint layer)
CODE_SCHEMES = ("30-of-42", "112-of-136", "180-of-210")


def get_config(arch: str, smoke: bool = False):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; expected one of {list(ARCHS)}")
    if arch not in PORTED:
        raise NotImplementedError(
            f"{arch} is not ported yet: it needs {_PENDING[arch]}")
    mod = importlib.import_module(f".{ARCHS[arch]}", __package__)
    return mod.SMOKE if smoke else mod.CONFIG


def all_archs() -> list[str]:
    return list(ARCHS)
