"""repro_torch.serve.paged — paged KV-block serving.

:class:`BlockPool` (fixed-size KV blocks, free list, refcounts, COW),
:class:`PrefixIndex` (trie over prompt blocks -> shared blocks; its
module also holds :func:`content_key`, the content hash of operator
fields), :class:`PagedLMEngine` (the LM slot engine over block tables,
bit-identical to the dense path), and :class:`AsyncServeFrontend`
(submit_async / stream with per-request deadline accounting).
"""
from .engine import PagedLMEngine  # noqa: F401
from .frontend import AsyncServeFrontend  # noqa: F401
from .pool import NULL_BLOCK, BlockPool  # noqa: F401
from .prefix import PrefixIndex, content_key  # noqa: F401
