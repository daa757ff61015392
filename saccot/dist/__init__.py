from saccot.dist.mesh import make_mesh, init_distributed  # noqa: F401
from saccot.dist.sweep import make_sweep_fn  # noqa: F401
