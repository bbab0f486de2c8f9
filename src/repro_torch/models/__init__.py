"""Models of the port (port of `repro.models`): the configuration schema,
the dense `attn` blocks and the `Transformer` assembly."""
from .config import (BLOCK_KINDS, MLAConfig, ModelConfig, MoEConfig, Segment,
                     uniform_segments)
from .model import (Transformer, abstract_params, forward, init_cache,
                    init_params, pad_cache_to, params_from_jax,
                    params_to_tree)

__all__ = ["BLOCK_KINDS", "MLAConfig", "ModelConfig", "MoEConfig", "Segment",
           "uniform_segments", "Transformer", "abstract_params", "forward",
           "init_cache", "init_params", "pad_cache_to", "params_from_jax",
           "params_to_tree"]
