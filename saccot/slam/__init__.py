from saccot.slam.posegraph import optimize_pose_graph, PoseGraph  # noqa: F401
from saccot.slam.ba import bundle_adjust, BAProblem  # noqa: F401
