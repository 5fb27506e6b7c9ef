"""colmap_tpu_torch — the PyTorch / CUDA port of colmap_tpu for NVIDIA Hopper.

The port mirrors the JAX package's tree and public names, module by module,
so each function here is found under the same path as its JAX counterpart.
It imports torch and never jax or colmap_tpu; the host-only modules it needs
(database, bitmap, camera database, synthetic renderer) are copies.

Entry points run on the card unless the caller asks for another device;
there is no device fallback. The one TPU kernel on the correspondence front
end (the fused descriptor matcher) is a hand-written CUDA kernel on the
int8 tensor cores, `csrc/matcher_top2.cu`, bound in
`features/hopper_matcher.py`.
"""

__version__ = "0.1.0"

import torch as _torch

# The DLT/SVD minimal solvers and the DoG thresholds need true f32 matrix
# products (the JAX package sets jax_default_matmul_precision="highest" for
# the same reason); TF32 keeps ~10 mantissa bits.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
