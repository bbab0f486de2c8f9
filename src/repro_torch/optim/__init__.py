"""The optimizer of the port (port of `repro.optim`): AdamW with fp32
master weights, updated in place, and int8 gradient compression."""
from .adamw import (AdamWConfig, adamw_init, adamw_update,
                    bf16_dtensor_parameters, clip_by_global_norm, cosine_lr,
                    global_norm)
from .compress import compress_grads, decompress_grads

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "bf16_dtensor_parameters", "cosine_lr",
           "global_norm", "clip_by_global_norm",
           "compress_grads", "decompress_grads"]
