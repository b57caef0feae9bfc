"""PyTorch / CUDA port of channelestimationtransformer_tpu for NVIDIA Hopper.

The JAX package is the reference; every module here mirrors its counterpart
there, and every Pallas kernel on a ported path becomes a hand-written CUDA
kernel under ``ops/cuda/``. Entry points run on the card unless the caller
passes ``device="cpu"``.
"""
