"""Data generators and loaders of the port."""
from .carshapes import latent_grid_coords, sample_car_batch  # noqa: F401
from .darcy import darcy_matvec, sample_darcy_batch, solve_darcy  # noqa: F401
from .grf import grf_2d, grf_sphere, sphere_field  # noqa: F401
from .loader import CachedDataset, StatelessLoader  # noqa: F401
from .navier_stokes import sample_ns_batch, solve_ns_vorticity  # noqa: F401
from .swe import sample_swe_batch, solve_swe_linear  # noqa: F401
from .tokens import lm_inputs, token_batch  # noqa: F401
