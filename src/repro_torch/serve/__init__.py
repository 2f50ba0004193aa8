"""Serving engines of the port."""
from .engine import EngineBase  # noqa: F401
from .operator import FieldRequest, OperatorEngine, content_key  # noqa: F401
from .scheduler import Scheduler  # noqa: F401
