"""Architecture registry of the port: `--arch <id>` resolves here (port of
`repro.configs`).

Every reference architecture is listed; `get_config` returns the ones
whose layers the port has, and raises `NotImplementedError` naming the
ROADMAP item that brings the rest.
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

#: Architectures the port can build, and what the others wait for.
PORTED = ("llama3.2-3b", "phi4-mini-3.8b", "qwen1.5-32b",
          "recurrentgemma-9b", "minicpm3-4b", "phi3.5-moe-42b-a6.6b",
          "kimi-k2-1t-a32b")
_PENDING = {
    "rwkv6-7b": "its RWKV6 blocks (`rwkv`, ROADMAP A9.3)",
    "llama-3.2-vision-11b": "its cross-attention blocks (`cross_attn`, "
                            "ROADMAP A9.4)",
    "hubert-xlarge": "an encoder-only front end with embedding-free inputs "
                     "(ROADMAP A9.5)",
}

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
