"""The paper's own operator configurations (TFNO on Navier-Stokes, FNO on
Darcy flow, SFNO on the spherical shallow-water equations, GINO on
Shape-Net Car, the U-Net baseline), and their reduced smoke variants."""
from repro_torch.models.fno import FNOConfig
from repro_torch.models.gino import GINOConfig
from repro_torch.models.sfno import SFNOConfig
from repro_torch.models.unet import UNetConfig

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

# GINO on Shape-Net Car (64^3 latent grid in the paper)
GINO_CAR = GINOConfig(
    in_features=1, out_features=1, hidden=64, latent_grid=32, k_neighbors=8,
    fno=FNOConfig(
        in_channels=32, out_channels=32, hidden_channels=64,
        lifting_channels=64, projection_channels=64,
        n_layers=4, modes=(12, 12, 12), positional_embedding=False,
    ),
)

UNET_BASELINE = UNetConfig(in_channels=1, out_channels=1, base_width=32, depth=3)

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
GINO_CAR_SMOKE = GINOConfig(
    in_features=1, out_features=1, hidden=8, latent_grid=4, k_neighbors=4,
    fno=FNOConfig(
        in_channels=8, out_channels=8, hidden_channels=8,
        lifting_channels=8, projection_channels=8, n_layers=1,
        modes=(2, 2, 2), positional_embedding=False,
    ),
)
