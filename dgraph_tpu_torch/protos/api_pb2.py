"""Messages of the public client API (protos/api.proto), for the PyTorch port.

The wire contract is the JAX package's: package `dgraph_tpu.api`, the same
messages and field numbers, so a client of either package talks to a server
of the other and the method paths `/dgraph_tpu.api.Dgraph/<Method>` stay
the same. The descriptor below is `protoc`'s serialized api.proto.

Why a private descriptor pool. A module generated by `protoc` registers
its file in protobuf's process-wide default pool. The JAX package's
api_pb2 already registers `dgraph_tpu.api.Request` and the rest there, and
a process may load both packages (the cross-package tests do): a second
registration of the same symbols under another file name raises
`TypeError: duplicate symbol`. Renaming the package would change the wire.
So the port builds its message classes in a pool of its own; the classes
are distinct Python types that serialize and parse the same bytes.
"""

from google.protobuf import descriptor_pb2, descriptor_pool, message_factory

_SERIALIZED = (
    b'\n\x1b\x64graph_tpu/protos/api.proto\x12\x0e\x64graph_tpu.api\"\xf1\x01\n\x07Request\x12\r\n\x05query\x18\x01 \x01(\t\x12/\n\x04vars\x18\x02 \x03(\x0b\x32!.dgraph_tpu.api.Request.VarsEntry\x12\x10\n\x08start_ts\x18\x03 \x01(\x04\x12+\n\tmutations\x18\x04 \x03(\x0b\x32\x18.dgraph_tpu.api.Mutation\x12\x12\n\ncommit_now\x18\x05 \x01(\x08\x12\x11\n\tread_only\x18\x06 \x01(\x08\x12\x13\n\x0b\x62\x65st_effort\x18\x07 \x01(\x08\x1a+\n\tVarsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"g\n\x08Mutation\x12\x12\n\nset_nquads\x18\x01 \x01(\x0c\x12\x12\n\ndel_nquads\x18\x02 \x01(\x0c\x12\x10\n\x08set_json\x18\x03 \x01(\x0c\x12\x13\n\x0b\x64\x65lete_json\x18\x04 \x01(\x0c\x12\x0c\n\x04\x63ond\x18\x05 \x01(\t\"\xca\x01\n\x08Response\x12\x0c\n\x04json\x18\x01 \x01(\x0c\x12\'\n\x03txn\x18\x02 \x01(\x0b\x32\x1a.dgraph_tpu.api.TxnContext\x12(\n\x07latency\x18\x03 \x01(\x0b\x32\x17.dgraph_tpu.api.Latency\x12\x30\n\x04uids\x18\x04 \x03(\x0b\x32\".dgraph_tpu.api.Response.UidsEntry\x1a+\n\tUidsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x04:\x02\x38\x01\"_\n\nTxnContext\x12\x10\n\x08start_ts\x18\x01 \x01(\x04\x12\x11\n\tcommit_ts\x18\x02 \x01(\x04\x12\x0f\n\x07\x61\x62orted\x18\x03 \x01(\x08\x12\x0c\n\x04keys\x18\x04 \x03(\t\x12\r\n\x05preds\x18\x05 \x03(\t\"[\n\x07Latency\x12\x12\n\nparsing_ns\x18\x01 \x01(\x04\x12\x15\n\rprocessing_ns\x18\x02 \x01(\x04\x12\x13\n\x0b\x65ncoding_ns\x18\x03 \x01(\x04\x12\x10\n\x08total_ns\x18\x04 \x01(\x04\"@\n\tOperation\x12\x0e\n\x06schema\x18\x01 \x01(\t\x12\x11\n\tdrop_attr\x18\x02 \x01(\t\x12\x10\n\x08\x64rop_all\x18\x03 \x01(\x08\"\x17\n\x07Payload\x12\x0c\n\x04\x64\x61ta\x18\x01 \x01(\x0c\"\x07\n\x05\x43heck\"\x16\n\x07Version\x12\x0b\n\x03tag\x18\x01 \x01(\tb\x06proto3')

_FILE = descriptor_pb2.FileDescriptorProto.FromString(_SERIALIZED)
_FILE.name = "dgraph_tpu_torch/protos/api.proto"
POOL = descriptor_pool.DescriptorPool()
DESCRIPTOR = POOL.Add(_FILE)


def _cls(name: str):
    return message_factory.GetMessageClass(
        POOL.FindMessageTypeByName(f"dgraph_tpu.api.{name}"))


Request = _cls("Request")
Mutation = _cls("Mutation")
Response = _cls("Response")
TxnContext = _cls("TxnContext")
Latency = _cls("Latency")
Operation = _cls("Operation")
Payload = _cls("Payload")
Check = _cls("Check")
Version = _cls("Version")
