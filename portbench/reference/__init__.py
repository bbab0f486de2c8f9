"""The plain reference: the model's prefill in float32 PyTorch, one file
per block kind (`<kind>.py`, `layer(x, weights, config, precision,
follow)`), the whole model in `model.py`. It imports nothing of the
program (`repro_torch`), of JAX or of the JAX package."""
