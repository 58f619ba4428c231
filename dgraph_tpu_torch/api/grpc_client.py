"""gRPC client with the reference client's txn surface (pydgraph-style).

Copy of dgraph_tpu/api/grpc_client.py for the PyTorch port; it talks to the
port's server and to the JAX package's alike (same service, same messages).

    client = DgraphClient("localhost:9080")
    client.alter(schema="name: string @index(exact) .")
    txn = client.txn()
    txn.mutate(set_nquads='_:a <name> "alice" .')
    txn.commit()
    resp = client.txn(read_only=True).query('{ q(func: has(name)) { name } }')

Hand-written stubs over channel.unary_unary (no grpc codegen plugin in this
image); wire contract in protos/api.proto.
"""

from __future__ import annotations

import json

import grpc

from ..protos import api_pb2 as pb

SERVICE = "dgraph_tpu.api.Dgraph"


class TxnAborted(Exception):
    pass


class DgraphClient:
    def __init__(self, addr: str = "localhost:9080",
                 channel: grpc.Channel | None = None) -> None:
        self.channel = channel or grpc.insecure_channel(addr)

        def stub(method, req_cls, resp_cls):
            return self.channel.unary_unary(
                f"/{SERVICE}/{method}",
                request_serializer=req_cls.SerializeToString,
                response_deserializer=resp_cls.FromString)

        self._query = stub("Query", pb.Request, pb.Response)
        self._alter = stub("Alter", pb.Operation, pb.Payload)
        self._commit = stub("CommitOrAbort", pb.TxnContext, pb.TxnContext)
        self._version = stub("CheckVersion", pb.Check, pb.Version)

    def alter(self, schema: str = "", drop_attr: str = "",
              drop_all: bool = False) -> None:
        self._alter(pb.Operation(schema=schema, drop_attr=drop_attr,
                                 drop_all=drop_all))

    def check_version(self) -> str:
        return self._version(pb.Check()).tag

    def txn(self, read_only: bool = False) -> "Txn":
        return Txn(self, read_only)

    def close(self) -> None:
        self.channel.close()


class Txn:
    """One transaction: queries and mutations share a start_ts; commit()
    finalizes (reference client semantics: first op opens the txn lazily)."""

    def __init__(self, client: DgraphClient, read_only: bool) -> None:
        self.client = client
        self.read_only = read_only
        self.start_ts = 0
        self.finished = False

    def query(self, q: str, variables: dict | None = None) -> dict:
        req = pb.Request(query=q, start_ts=self.start_ts,
                         read_only=self.read_only)
        if variables:
            req.vars.update({k: str(v) for k, v in variables.items()})
        resp = self._call(req)
        # read-only txns pin start_ts too: repeatable reads at one snapshot
        if resp.txn.start_ts and not self.start_ts:
            self.start_ts = resp.txn.start_ts
        return json.loads(resp.json) if resp.json else {}

    def mutate(self, set_nquads: str = "", del_nquads: str = "",
               set_json=None, delete_json=None,
               commit_now: bool = False) -> dict[str, int]:
        if self.read_only:
            raise TxnAborted("read-only txn cannot mutate")
        m = pb.Mutation(set_nquads=set_nquads.encode(),
                        del_nquads=del_nquads.encode())
        if set_json is not None:
            m.set_json = json.dumps(set_json).encode()
        if delete_json is not None:
            m.delete_json = json.dumps(delete_json).encode()
        req = pb.Request(mutations=[m], commit_now=commit_now,
                         start_ts=self.start_ts)
        resp = self._call(req)
        self.start_ts = resp.txn.start_ts
        if commit_now:
            self.finished = True
        return dict(resp.uids)

    def upsert(self, q: str, set_nquads: str = "", del_nquads: str = "",
               commit_now: bool = True) -> tuple[dict, dict[str, int]]:
        """Query + conditional mutation in one request (upsert block)."""
        m = pb.Mutation(set_nquads=set_nquads.encode(),
                        del_nquads=del_nquads.encode())
        req = pb.Request(query=q, mutations=[m], commit_now=commit_now,
                         start_ts=self.start_ts)
        resp = self._call(req)
        if resp.txn.start_ts:
            self.start_ts = resp.txn.start_ts
        if commit_now:
            self.finished = True
        return (json.loads(resp.json) if resp.json else {}), dict(resp.uids)

    def commit(self) -> int:
        if self.finished:
            raise TxnAborted("txn already finished")
        self.finished = True
        if not self.start_ts or self.read_only:
            # read-only start_ts is a snapshot pin, not a server-side txn
            return 0
        try:
            out = self.client._commit(pb.TxnContext(start_ts=self.start_ts))
            return out.commit_ts
        except grpc.RpcError as e:
            if e.code() == grpc.StatusCode.ABORTED:
                raise TxnAborted(e.details()) from None
            raise

    def discard(self) -> None:
        if self.finished or not self.start_ts or self.read_only:
            self.finished = True
            return
        self.finished = True
        self.client._commit(pb.TxnContext(start_ts=self.start_ts,
                                          aborted=True))

    def _call(self, req: pb.Request) -> pb.Response:
        try:
            return self.client._query(req)
        except grpc.RpcError as e:
            if e.code() == grpc.StatusCode.ABORTED:
                self.finished = True
                raise TxnAborted(e.details()) from None
            raise
