"""The port's domain-size pooling SIFT against the JAX package on one
200x150 image, at the tolerances stated in tests/test_torch_sift_variants.py
(descriptor bytes within one uint8 level >= 99.9%, measured 100%). A file
of its own: the JAX package's CPU compile of the ten pooled descriptor
passes takes ~45 s.
"""

import torch

from test_torch_sift_variants import check_variant_parity, image  # noqa: F401

torch.set_num_threads(2)


def test_dsp_keypoints_and_descriptors_match_jax(image):  # noqa: F811
    check_variant_parity(image, "domain_size_pooling", 0.999)
