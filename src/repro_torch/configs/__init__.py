"""Architecture registry of the port: `--arch <id>` resolves here (port of
`repro.configs`).

Every reference architecture is listed and built by the port (`PORTED`);
`_PENDING` is empty: `get_config` raises `NotImplementedError` for an
architecture listed there, naming the ROADMAP item that brings it.
`PORT_ONLY` names the architectures the port builds that the reference
has not (the published Kimi K2 Instruct, whole and as one rank of
32-way expert parallelism); `all_archs()` lists the reference's alone.
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

#: arch -> (module, its configuration's name there, its SMOKE's name)
PORT_ONLY = {
    "kimi-k2-instruct": ("kimi_k2_instruct", "CONFIG", "SMOKE"),
    "kimi-k2-instruct-ep32": ("kimi_k2_instruct", "EP32", "EP32_SMOKE"),
}

# Paper Table 2 code schemes (used by the EC checkpoint layer)
CODE_SCHEMES = ("30-of-42", "112-of-136", "180-of-210")


def get_config(arch: str, smoke: bool = False):
    if arch in PORT_ONLY:
        module, full, small = PORT_ONLY[arch]
        mod = importlib.import_module(f".{module}", __package__)
        return getattr(mod, small if smoke else full)
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; expected one of "
                       f"{list(ARCHS) + list(PORT_ONLY)}")
    if arch not in PORTED:
        raise NotImplementedError(
            f"{arch} is not ported yet: it needs {_PENDING[arch]}")
    mod = importlib.import_module(f".{ARCHS[arch]}", __package__)
    return mod.SMOKE if smoke else mod.CONFIG


def all_archs() -> list[str]:
    return list(ARCHS)
