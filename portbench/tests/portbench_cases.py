"""Small stand-ins for the cells, for the CPU tests: each block kind at the
port's SMOKE widths (2 layers), under a short closed-loop mix, held to the
real cell's limits file."""
from __future__ import annotations

import copy
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import spec as S  # noqa: E402

CELLS = {"mla": "minicpm3-4b.prefill-2k", "attn_moe": "phi3.5-moe-16l.prefill-2k"}

SMOKE = {
    "mla": {"arch": "minicpm3-4b", "config": {
        "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 4,
        "q_lora_rank": 32, "kv_lora_rank": 24, "qk_nope_head_dim": 16,
        "qk_rope_head_dim": 8, "v_head_dim": 16, "intermediate_size": 128,
        "vocab_size": 512, "rms_norm_eps": 1e-05, "rope_theta": 10000.0,
        "tie_word_embeddings": False}},
    "attn_moe": {"arch": "phi3.5-moe-42b-a6.6b", "config": {
        "hidden_size": 128, "num_attention_heads": 8, "num_key_value_heads": 2,
        "intermediate_size": 96, "num_local_experts": 4,
        "num_experts_per_tok": 2, "vocab_size": 512, "rms_norm_eps": 1e-05,
        "rope_theta": 10000.0, "tie_word_embeddings": False,
        "capacity_factor": 1.25}},
}


def small_spec(kind: str, batch: int = 2, prompt: int = 64) -> S.Spec:
    """The real cell of `kind`, its configuration at SMOKE widths and 2
    layers and its mix cut to `batch` x `prompt`; its limits as they are."""
    sp = S.load(CELLS[kind])
    sp.config = {**copy.deepcopy(sp.config), **copy.deepcopy(SMOKE[kind]),
                 "smoke": True, "layers": 2}
    sp.traffic = {**sp.traffic, "batch": batch, "prompt_len": prompt,
                  "warmup_batches": 1}
    return sp
