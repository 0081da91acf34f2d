"""bvsc_tpu_torch: the bitrate-scalable variational speech codec in PyTorch
and CUDA, for NVIDIA Hopper (H100).

A port of the JAX package ``bvsc_tpu``, which stays beside it as the
reference.  This package imports torch, numpy and scipy only: nothing of JAX
and nothing of ``bvsc_tpu``.  Entry points run on the first CUDA card
unless the caller passes ``device='cpu'``.
"""

from bvsc_tpu_torch.codec import BVRNNCodecModel
from bvsc_tpu_torch.config import CodecConfig, VocoderConfig, load_config

__all__ = ["BVRNNCodecModel", "CodecConfig", "VocoderConfig", "load_config"]
