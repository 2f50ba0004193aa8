"""Model configurations of the port."""
from .fno_paper import (  # noqa: F401
    FNO_DARCY,
    FNO_DARCY_SMOKE,
    GINO_CAR,
    GINO_CAR_SMOKE,
    SFNO_SWE,
    SFNO_SWE_SMOKE,
    TFNO_NS,
    TFNO_NS_SMOKE,
    UNET_BASELINE,
)
