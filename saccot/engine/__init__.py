from saccot.engine.sac_cot import register_pair, RegistrationResult  # noqa: F401
from saccot.engine.svd3 import umeyama  # noqa: F401
from saccot.engine.icp import IcpParams, icp, icp_batch  # noqa: F401
from saccot.engine.baselines import (  # noqa: F401
    ransac_register_pair, edge_guided_register_pair, sampler_ablation,
)
