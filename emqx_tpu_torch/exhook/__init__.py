"""The ExHook gRPC extension boundary, the port's copy of
``emqx_tpu/exhook/``.

* :mod:`~emqx_tpu_torch.exhook.manager` — broker side: streams hook
  points to external HookProvider servers (advisory and notification
  semantics, per-server timeout and deny/ignore failure policy);
  ``BrokerNode`` starts it from ``exhook.servers``.
* :mod:`~emqx_tpu_torch.exhook.server` — the match sidecar: a
  HookProvider keeping a filter mirror on the card fresh from the
  subscription delta feed and serving micro-batched topic matches with
  the card's hash walk.
* :mod:`~emqx_tpu_torch.exhook.rpc` — hand-written service glue over the
  ``protoc``-generated messages (``exhook_pb2``, the reference's
  descriptor byte for byte).
"""

from .manager import ExHookManager, ServerSpec
from .rpc import pb

__all__ = ["ExHookManager", "ServerSpec", "pb"]
