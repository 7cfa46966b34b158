"""PyTorch/CUDA port of msmctts_tpu for NVIDIA Hopper (H100).

The serving half of the CSMSC main path: text -> MultiStagePredictor ->
codebook snap -> MSMCVQGAN.synthesis -> HiFi-GAN, and the autoencoder's
analysis-synthesis round trip. The layout mirrors ``msmctts_tpu`` module for
module; the two Pallas kernels on this path are hand-written CUDA kernels
under ``csrc/`` (see ``ops/vq.py`` and ``ops/resblock.py``).
"""

__version__ = "0.1.0"
