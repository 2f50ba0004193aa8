"""The paper's own operator configurations (TFNO on Navier-Stokes, FNO on
Darcy flow, SFNO on the spherical shallow-water equations), and their
reduced smoke variants."""
from repro_torch.models.fno import FNOConfig
from repro_torch.models.sfno import SFNOConfig

# TFNO on Navier-Stokes (CP-factorised weights, §4.6) — paper-scale
TFNO_NS = FNOConfig(
    in_channels=1, out_channels=1, hidden_channels=64,
    lifting_channels=256, projection_channels=256,
    n_layers=4, modes=(42, 42), factorization="cp", rank=0.5,
)

# FNO on Darcy (dense weights)
FNO_DARCY = FNOConfig(
    in_channels=1, out_channels=1, hidden_channels=64,
    lifting_channels=256, projection_channels=256,
    n_layers=4, modes=(32, 32), factorization="dense",
)

# SFNO on the spherical SWE (256x512 grid in the paper)
SFNO_SWE = SFNOConfig(
    in_channels=3, out_channels=3, hidden_channels=64, n_layers=4,
    nlat=256, nlon=512, lmax=128, mmax=128,
    lifting_channels=128, projection_channels=128,
)

# Reduced smoke variants
TFNO_NS_SMOKE = FNOConfig(
    in_channels=1, out_channels=1, hidden_channels=16,
    lifting_channels=16, projection_channels=16,
    n_layers=2, modes=(8, 8), factorization="cp",
)
FNO_DARCY_SMOKE = FNOConfig(
    in_channels=1, out_channels=1, hidden_channels=16,
    lifting_channels=16, projection_channels=16, n_layers=2, modes=(8, 8),
)
SFNO_SWE_SMOKE = SFNOConfig(
    in_channels=3, out_channels=3, hidden_channels=8, n_layers=2,
    nlat=16, nlon=32, lmax=8, mmax=8, lifting_channels=8, projection_channels=8,
)
