"""The paper's FNO configuration on Darcy flow, and its reduced smoke
variant."""
from repro_torch.models.fno import FNOConfig

# FNO on Darcy (dense weights)
FNO_DARCY = FNOConfig(
    in_channels=1, out_channels=1, hidden_channels=64,
    lifting_channels=256, projection_channels=256,
    n_layers=4, modes=(32, 32), factorization="dense",
)

# Reduced smoke variant
FNO_DARCY_SMOKE = FNOConfig(
    in_channels=1, out_channels=1, hidden_channels=16,
    lifting_channels=16, projection_channels=16, n_layers=2, modes=(8, 8),
)
