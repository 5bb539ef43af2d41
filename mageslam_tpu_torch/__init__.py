"""mageslam_tpu_torch — the monocular keyframe SLAM engine in PyTorch + CUDA.

A port of the JAX package ``mageslam_tpu`` (kept beside it as the
reference).  The layout mirrors the JAX package module for module, with the
same function and field names, so each counterpart is easy to find.  The
frontend's fused FAST + NMS + Gaussian-blur stage is a hand-written CUDA
kernel (``csrc/fast_detect.cu``, built with ``nvcc`` at first use); every
other stage is plain PyTorch.  The entry points (``MageSlamTorchFused``,
``DeviceEngine``) run on the CUDA card unless the caller passes
``device="cpu"``.

The package imports ``torch`` and never ``jax``, and nothing of the JAX
package: its settings classes are its own copy (``config.py``).
"""

from mageslam_tpu_torch.config import MageSlamSettings  # noqa: F401

__all__ = ["MageSlamSettings"]
