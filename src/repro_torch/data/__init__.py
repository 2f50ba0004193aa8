"""Data generators and loaders of the port."""
from .darcy import darcy_matvec, sample_darcy_batch, solve_darcy  # noqa: F401
from .grf import grf_2d  # noqa: F401
from .loader import CachedDataset, StatelessLoader  # noqa: F401
from .navier_stokes import sample_ns_batch, solve_ns_vorticity  # noqa: F401
