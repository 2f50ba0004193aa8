"""Serving engines of the port: one protocol (``submit / tick / drain /
stats``) over ``LMEngine`` (continuous-batching LM decode with chunked
prefill and per-request sampling) and ``OperatorEngine`` (micro-batched
FNO/SFNO field inference), both fed by a shared ``Scheduler``.
``ServeEngine`` is the earlier name of ``LMEngine``."""
from .engine import Engine, EngineBase, LMEngine, Request, ServeEngine  # noqa: F401
from .operator import FieldRequest, OperatorEngine, content_key  # noqa: F401
from .sampler import (  # noqa: F401
    GREEDY,
    SamplingParams,
    apply_top_k,
    apply_top_p,
    request_key,
    sample_token,
)
from .scheduler import POLICIES, Scheduler  # noqa: F401
