"""Geometry core: SE3/Sim3 ops, camera models, triangulation, alignment.

Array-program equivalent of the reference's Eigen/g2o math types
(``Thirdparty/g2o/g2o/types/{se3quat.h, sim3.h, se3_ops.h}`` [U]) and
``src/Converter.cc`` [U] — here everything is a flat jnp array so it
vmaps/shards freely.
"""

from active_orb_slam2_tpu.geometry.se3 import (  # noqa: F401
    quat_normalize, quat_mul, quat_conj, quat_rotate, quat_to_mat,
    mat_to_quat, quat_from_axis_angle,
    se3_identity, se3_compose, se3_inverse, se3_apply, se3_exp, se3_log,
    se3_retract, se3_to_mat44, mat44_to_se3,
    sim3_identity, sim3_compose, sim3_inverse, sim3_apply, sim3_exp,
    sim3_log, sim3_from_se3, sim3_to_se3,
)
from active_orb_slam2_tpu.geometry.projection import (  # noqa: F401
    CameraParams, project, project_stereo, backproject, in_frustum,
    predict_scale,
)
from active_orb_slam2_tpu.geometry.triangulation import (  # noqa: F401
    triangulate_dlt, triangulate_pairs,
)
from active_orb_slam2_tpu.geometry.horn import (  # noqa: F401
    horn_align, umeyama_alignment,
)
