"""Hand-written gRPC service glue for the exhook protos.

The port's copy of ``emqx_tpu/exhook/rpc.py``, unchanged: the same
method table and paths, over the port's ``exhook_pb2`` (whose serialized
descriptor is the reference's byte for byte, so that both packages'
messages are one set of classes in a process that imports both).

``grpc_tools`` (the protoc gRPC plugin) is not available in this
environment, so the service stubs that ``protoc`` would generate are
written by hand: messages come from ``exhook_pb2`` (generated by plain
``protoc --python_out``, see ``protos/regen.sh``), and this module wires
them to ``grpc`` method handlers.  Wire-compatible with stubs generated
the usual way — the method paths are ``/<package>.<Service>/<Method>``.

Behavioral reference for the service surface:
``apps/emqx_exhook/priv/protos/exhook.proto`` [U] (SURVEY.md §2.3).
"""

from __future__ import annotations

import grpc

from . import exhook_pb2 as pb

__all__ = [
    "HOOK_METHODS",
    "HookProviderStub",
    "MirrorSyncStub",
    "add_hook_provider_to_server",
    "add_mirror_sync_to_server",
    "bind_unary_stub",
    "add_unary_service",
    "pb",
]


def bind_unary_stub(stub, channel, pkg: str, service: str, methods) -> None:
    """Attach unary-unary callables for ``methods`` (name -> (req, resp))
    to ``stub`` — the shared hand-written-stub builder (no grpc_tools in
    this environment); paths match normally-generated stubs."""
    for name, (req, resp) in methods.items():
        setattr(stub, name, channel.unary_unary(
            f"/{pkg}.{service}/{name}",
            request_serializer=req.SerializeToString,
            response_deserializer=resp.FromString,
        ))


def add_unary_service(servicer, server, pkg: str, service: str,
                      methods, extra_handlers=None) -> None:
    """Register every implemented unary method of ``servicer``;
    unimplemented ones return UNIMPLEMENTED (callers treat as ignore)."""
    handlers = dict(extra_handlers or {})
    for name, (req, resp) in methods.items():
        fn = getattr(servicer, name, None)
        if fn is None:
            continue
        handlers[name] = grpc.unary_unary_rpc_method_handler(
            fn,
            request_deserializer=req.FromString,
            response_serializer=resp.SerializeToString,
        )
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(f"{pkg}.{service}", handlers),)
    )

_PKG = "emqx.exhook.v2"

# method name -> (request message, response message); order mirrors the proto
HOOK_METHODS = {
    "OnProviderLoaded": (pb.ProviderLoadedRequest, pb.LoadedResponse),
    "OnProviderUnloaded": (pb.ProviderUnloadedRequest, pb.EmptySuccess),
    "OnClientConnect": (pb.ClientConnectRequest, pb.EmptySuccess),
    "OnClientConnack": (pb.ClientConnackRequest, pb.EmptySuccess),
    "OnClientConnected": (pb.ClientConnectedRequest, pb.EmptySuccess),
    "OnClientDisconnected": (pb.ClientDisconnectedRequest, pb.EmptySuccess),
    "OnClientAuthenticate": (pb.ClientAuthenticateRequest, pb.ValuedResponse),
    "OnClientAuthorize": (pb.ClientAuthorizeRequest, pb.ValuedResponse),
    "OnClientSubscribe": (pb.ClientSubscribeRequest, pb.EmptySuccess),
    "OnClientUnsubscribe": (pb.ClientUnsubscribeRequest, pb.EmptySuccess),
    "OnSessionCreated": (pb.SessionCreatedRequest, pb.EmptySuccess),
    "OnSessionSubscribed": (pb.SessionSubscribedRequest, pb.EmptySuccess),
    "OnSessionUnsubscribed": (pb.SessionUnsubscribedRequest, pb.EmptySuccess),
    "OnSessionResumed": (pb.SessionResumedRequest, pb.EmptySuccess),
    "OnSessionDiscarded": (pb.SessionDiscardedRequest, pb.EmptySuccess),
    "OnSessionTakenover": (pb.SessionTakenoverRequest, pb.EmptySuccess),
    "OnSessionTerminated": (pb.SessionTerminatedRequest, pb.EmptySuccess),
    "OnMessagePublish": (pb.MessagePublishRequest, pb.ValuedResponse),
    "OnMessageDelivered": (pb.MessageDeliveredRequest, pb.EmptySuccess),
    "OnMessageDropped": (pb.MessageDroppedRequest, pb.EmptySuccess),
    "OnMessageAcked": (pb.MessageAckedRequest, pb.EmptySuccess),
}

_MIRROR_UNARY = {
    "ApplyDeltas": (pb.DeltaBatch, pb.SnapshotAck),
    "MatchBatch": (pb.MatchBatchRequest, pb.MatchBatchResponse),
    "FilterTable": (pb.FilterTableRequest, pb.FilterTableResponse),
    "Stats": (pb.StatsRequest, pb.StatsResponse),
}


class HookProviderStub:
    """Client stub; works over both sync and aio channels."""

    def __init__(self, channel) -> None:
        bind_unary_stub(self, channel, _PKG, "HookProvider", HOOK_METHODS)


class MirrorSyncStub:
    def __init__(self, channel) -> None:
        bind_unary_stub(self, channel, _PKG, "MirrorSync", _MIRROR_UNARY)
        self.InstallSnapshot = channel.stream_unary(
            f"/{_PKG}.MirrorSync/InstallSnapshot",
            request_serializer=pb.SnapshotChunk.SerializeToString,
            response_deserializer=pb.SnapshotAck.FromString,
        )


def add_hook_provider_to_server(servicer, server) -> None:
    """Register a HookProvider servicer.  Methods the servicer doesn't
    implement return UNIMPLEMENTED (the manager treats that as IGNORE)."""
    add_unary_service(servicer, server, _PKG, "HookProvider", HOOK_METHODS)


def add_mirror_sync_to_server(servicer, server) -> None:
    extra = {}
    if hasattr(servicer, "InstallSnapshot"):
        extra["InstallSnapshot"] = grpc.stream_unary_rpc_method_handler(
            servicer.InstallSnapshot,
            request_deserializer=pb.SnapshotChunk.FromString,
            response_serializer=pb.SnapshotAck.SerializeToString,
        )
    add_unary_service(servicer, server, _PKG, "MirrorSync", _MIRROR_UNARY,
                      extra_handlers=extra)
