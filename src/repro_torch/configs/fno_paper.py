"""The paper's own FNO configurations (TFNO on Navier-Stokes, FNO on
Darcy flow), and their reduced smoke variants."""
from repro_torch.models.fno import FNOConfig

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
