"""gRPC api.Dgraph service — the reference's primary client API.

Copy of dgraph_tpu/api/grpc_server.py for the PyTorch port, in front of the
port's Node. The service name and messages are the JAX server's, so a JAX
client gets the same responses from either server.

Semantics: edgraph/server.go:373 (Query — also carries mutations for
commit-now and upsert flows), :213 (Alter), :462 (CommitOrAbort). The wire
contract is protos/api.proto; the service and method stubs are
hand-written with grpc's generic-handler API because this image ships protoc
for messages but no grpc codegen plugin.

Method map (service name "dgraph_tpu.api.Dgraph"):
  Query          Request    -> Response    query and/or mutations, one txn
  Mutate         Request    -> Response    mutation-only convenience
  Alter          Operation  -> Payload     schema / drop_attr / drop_all
  CommitOrAbort  TxnContext -> TxnContext  commit (or abort when .aborted)
  CheckVersion   Check      -> Version
"""

from __future__ import annotations

import json
import time
from concurrent import futures

import grpc

from ..coord.zero import TxnConflict
from ..query import mutation as mut
from ..query.task import TaskError
from ..utils.errors import Unavailable
from ..protos import api_pb2 as pb
from .server import Node

SERVICE = "dgraph_tpu.api.Dgraph"


def _txn_proto(ctx) -> pb.TxnContext:
    return pb.TxnContext(
        start_ts=ctx.start_ts, commit_ts=ctx.commit_ts, aborted=ctx.aborted,
        keys=[k.hex() if isinstance(k, bytes) else str(k) for k in ctx.keys],
        preds=sorted(ctx.preds))


class DgraphService:
    """One embedded Node behind the public gRPC surface."""

    def __init__(self, node: Node) -> None:
        self.node = node

    # -- RPC bodies ---------------------------------------------------------

    def query(self, req: pb.Request, context) -> pb.Response:
        t0 = time.perf_counter_ns()
        try:
            resp = pb.Response()
            start_ts = req.start_ts or None
            if req.mutations:
                # query-first upsert ordering (edgraph doQueryInUpsert); a
                # mutation-only Request is the q="" degenerate case
                muts = [{
                    "cond": m.cond[4:-1] if m.cond.startswith("@if(") else m.cond,
                    "set": m.set_nquads.decode(),
                    "delete": m.del_nquads.decode(),
                    "set_json": json.loads(m.set_json) if m.set_json else None,
                    "delete_json": (json.loads(m.delete_json)
                                    if m.delete_json else None),
                } for m in req.mutations]
                out, uid_map, ctx = self.node.upsert(
                    req.query, muts, variables=dict(req.vars) or None,
                    start_ts=start_ts, commit_now=req.commit_now)
                if req.query:
                    resp.json = json.dumps(out).encode()
                # blank nodes come back as "_:a" -> uid; the api returns
                # {"a": uid} like the reference's Assigned.Uids
                resp.uids.update({k[2:]: v for k, v in uid_map.items()
                                  if str(k).startswith("_:")})
                resp.txn.CopyFrom(_txn_proto(ctx))
            elif req.query:
                if start_ts is None and not req.read_only:
                    # lazy txn open: a txn whose first op is a query must be
                    # able to mutate at the same start_ts afterward
                    start_ts = self.node.new_txn().start_ts
                out, ctx = self.node.query(
                    req.query, dict(req.vars) or None, start_ts=start_ts,
                    read_only=req.read_only)
                resp.json = json.dumps(out).encode()
                resp.txn.CopyFrom(_txn_proto(ctx))
            resp.latency.total_ns = time.perf_counter_ns() - t0
            return resp
        except TxnConflict as e:
            context.abort(grpc.StatusCode.ABORTED, str(e))
        except (TaskError, mut.MutationError, ValueError) as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))

    def mutate(self, req: pb.Request, context) -> pb.Response:
        return self.query(req, context)

    def alter(self, op: pb.Operation, context) -> pb.Payload:
        try:
            self.node.alter(schema_text=op.schema, drop_attr=op.drop_attr,
                            drop_all=op.drop_all)
            return pb.Payload(data=b"Done")
        except Exception as e:  # schema parse errors etc.
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))

    def commit_or_abort(self, txn: pb.TxnContext, context) -> pb.TxnContext:
        try:
            if txn.aborted:
                self.node.abort(txn.start_ts)
                return pb.TxnContext(start_ts=txn.start_ts, aborted=True)
            commit_ts = self.node.commit(txn.start_ts)
            return pb.TxnContext(start_ts=txn.start_ts, commit_ts=commit_ts)
        except TxnConflict as e:
            context.abort(grpc.StatusCode.ABORTED, str(e))
        except mut.MutationError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))

    def check_version(self, _req: pb.Check, context) -> pb.Version:
        return pb.Version(tag="dgraph-tpu")

    # -- wiring -------------------------------------------------------------

    def handler(self) -> grpc.GenericRpcHandler:
        def u(fn, req_cls, resp_cls):
            return grpc.unary_unary_rpc_method_handler(
                fn, request_deserializer=req_cls.FromString,
                response_serializer=resp_cls.SerializeToString)
        return grpc.method_handlers_generic_handler(SERVICE, {
            "Query": u(self.query, pb.Request, pb.Response),
            "Mutate": u(self.mutate, pb.Request, pb.Response),
            "Alter": u(self.alter, pb.Operation, pb.Payload),
            "CommitOrAbort": u(self.commit_or_abort, pb.TxnContext,
                               pb.TxnContext),
            "CheckVersion": u(self.check_version, pb.Check, pb.Version),
        })


def serve_grpc(node: Node, addr: str = "localhost:9080",
               max_workers: int = 8, tls_cert: str | None = None,
               tls_key: str | None = None) -> tuple[grpc.Server, int]:
    """Start a grpc server bound to addr; returns (server, bound port) —
    pass port 0 to pick a free one. Caller stops it. A cert+key pair turns
    on server-side TLS (x/tls_helper.go surface)."""
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers((DgraphService(node).handler(),))
    if tls_cert and tls_key:
        with open(tls_key, "rb") as kf, open(tls_cert, "rb") as cf:
            creds = grpc.ssl_server_credentials(((kf.read(), cf.read()),))
        port = server.add_secure_port(addr, creds)
    else:
        port = server.add_insecure_port(addr)
    if port == 0:
        # grpc signals bind failure by returning 0, not raising
        raise Unavailable(f"could not bind gRPC listener on {addr}")
    server.start()
    return server, port
