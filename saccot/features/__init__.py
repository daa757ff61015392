from saccot.features.neighbors import knn  # noqa: F401
from saccot.features.normals import estimate_normals  # noqa: F401
from saccot.features.resolution import mesh_resolution  # noqa: F401
from saccot.features.iss import iss_keypoints  # noqa: F401
from saccot.features.shot import shot_descriptors  # noqa: F401
from saccot.features.fpfh import fpfh_descriptors  # noqa: F401
