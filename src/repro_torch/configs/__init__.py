"""Model configurations of the port."""
from .fno_paper import FNO_DARCY, FNO_DARCY_SMOKE, TFNO_NS, TFNO_NS_SMOKE  # noqa: F401
