#!/bin/sh
# Regenerate exhook_pb2.py from exhook.proto.  Plain protoc only —
# service stubs are hand-written in ../rpc.py (grpc_tools not available).
cd "$(dirname "$0")/../../.." || exit 1
exec protoc --python_out=emqx_tpu_torch/exhook -Iemqx_tpu_torch/exhook/protos \
    emqx_tpu_torch/exhook/protos/exhook.proto
