"""Serving engines of the port: one protocol (``submit / tick / drain /
stats``) over ``LMEngine`` (continuous-batching LM decode with chunked
prefill and per-request sampling), ``PagedLMEngine`` (the same over a
paged KV cache with prefix sharing and copy-on-write) and
``OperatorEngine`` (micro-batched FNO/SFNO field inference), all fed by
a shared ``Scheduler``; ``AsyncServeFrontend`` puts an async, deadline-
accounting front on any of them.  ``ServeEngine`` is the earlier name of
``LMEngine``."""
from .engine import Engine, EngineBase, LMEngine, Request, ServeEngine  # noqa: F401
from .operator import FieldRequest, OperatorEngine  # noqa: F401
from .paged import (  # noqa: F401
    NULL_BLOCK,
    AsyncServeFrontend,
    BlockPool,
    PagedLMEngine,
    PrefixIndex,
    content_key,
)
from .sampler import (  # noqa: F401
    GREEDY,
    SamplingParams,
    apply_top_k,
    apply_top_p,
    request_key,
    sample_token,
)
from .scheduler import POLICIES, Scheduler  # noqa: F401
