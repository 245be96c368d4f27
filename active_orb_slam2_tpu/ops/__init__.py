"""Vision ops (L2): ORB extraction + descriptor matching, batched.

Replaces the reference's ``src/ORBextractor.cc`` and ``src/ORBmatcher.cc``
[U] with masked, fixed-shape kernels (SURVEY.md §7.1): FAST as a
whole-image vectorized score map, feature distribution as per-cell top-k,
matching as tiled Hamming matrices computed by a ±1 bit-matmul.
"""

from active_orb_slam2_tpu.ops.image import (  # noqa: F401
    gaussian_blur, resize_bilinear, pad_image,
)
from active_orb_slam2_tpu.ops.fast import fast_score_map  # noqa: F401
from active_orb_slam2_tpu.ops.orb import (  # noqa: F401
    OrbFeatures, build_extractor, descriptor_pattern,
)
from active_orb_slam2_tpu.ops.matching import (  # noqa: F401
    hamming_matrix, pm_descriptors, match_mutual,
    search_by_projection, rotation_consistency_mask,
)
