"""Site scopes: which precision site the code running now belongs to.

The counterpart of the reference's ``jax.named_scope`` wiring: the
precision helpers (``SitePrecision.stabilize/quantize/contract``), the
contraction wrappers and the ``fft_out`` blocks run their work inside
``site_scope(site)``, and ``repro_torch.analyze`` attributes every op it
records to the innermost open scope.  A scope launches nothing and
changes no value; with no listener it costs a list push and pop.

The autograd engine runs a backward on its own thread (the device thread
for CUDA tensors), where no scope is open.  So a listener hears each
scope's range of autograd sequence numbers, the numbers the nodes that
the scope's ops create carry, and attributes a backward op through the
node that runs it (``torch._C._current_autograd_node``), as the
reference's name stack attributes it through its ``transpose(jvp(...))``
frames.
"""
from __future__ import annotations

import threading
from typing import List, Optional

_local = threading.local()

#: the active scope listener: ``opened() -> token`` and ``closed(site,
#: token)`` (``repro_torch.analyze.dataflow``'s recorder sets it); None
#: costs one check a scope
listener = None


def _stack() -> List[str]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def current_site() -> Optional[str]:
    """The innermost open scope's site on this thread, or None."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


class site_scope:
    """``with site_scope("fno/layer0/spectral/contract"): ...``"""

    __slots__ = ("site", "_listener", "_token")

    def __init__(self, site: str):
        self.site = site

    def __enter__(self) -> "site_scope":
        _stack().append(self.site)
        self._listener = lis = listener
        if lis is not None:
            self._token = lis.opened()
        return self

    def __exit__(self, *exc) -> None:
        _local.stack.pop()
        if self._listener is not None:
            self._listener.closed(self.site, self._token)
