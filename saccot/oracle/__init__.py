from saccot.oracle.saccot import (  # noqa: F401
    compat_scores,
    enumerate_triangles,
    umeyama,
    count_inliers,
    sac_cot,
)
