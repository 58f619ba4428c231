"""Messages of the internal cluster protocol (protos/internal.proto), for
the PyTorch port.

The wire contract is the JAX package's: package `dgraph_tpu.internal`, the
same messages and field numbers, so the gRPC method paths
`/dgraph_tpu.internal.Worker/<Method>` and `/dgraph_tpu.internal.Zero/<Method>`
stay the same and a worker, Zero or client of either package talks to the
other's. The descriptor below is `protoc`'s serialized internal.proto.

As in api_pb2, the messages are built in a descriptor pool of the port's
own: the JAX module registers `dgraph_tpu.internal.*` in protobuf's default
pool, and a process that loads both packages would otherwise fail with
`TypeError: duplicate symbol`. The classes are distinct Python types that
serialize and parse the same bytes.
"""

from google.protobuf import descriptor_pb2, descriptor_pool, message_factory

_SERIALIZED = (
    b'\n dgraph_tpu/protos/internal.proto\x12\x13dgraph_tpu.internal"\xf9\x01\n\x0b'
    b'TaskRequest\x12\x0c\n\x04attr\x18\x01 \x01(\t\x12\x10\n\x08frontier\x18\x02 \x01(\x0c\x12\x14\n\x0chas_frontier\x18'
    b'\x03 \x01(\x08\x12\x11\n\tfunc_name\x18\x04 \x01(\t\x12\x16\n\x0efunc_args_json\x18\x05 \x01(\t\x12\x0c\n\x04lang\x18\x06 \x01'
    b'(\t\x12\x12\n\nfacet_keys\x18\x07 \x03(\t\x12\r\n\x05first\x18\x08 \x01(\x05\x12\x0f\n\x07reverse\x18\t \x01(\x08\x12\x0f\n\x07re'
    b'ad_ts\x18\n \x01(\x04\x12\x13\n\x0bmin_applied\x18\x0b \x01(\x04\x12!\n\x0creplica_read\x18\x0c \x01(\x08R\x0brepl'
    b'icaRead"\xad\x01\n\x0cTaskResponse\x12\x13\n\x0bmatrix_flat\x18\x01 \x01(\x0c\x12\x16\n\x0ematrix_offs'
    b'ets\x18\x02 \x01(\x0c\x12\x11\n\tdest_uids\x18\x03 \x01(\x0c\x12\x0e\n\x06counts\x18\x04 \x03(\x03\x12\x19\n\x11value_matrix'
    b'_json\x18\x05 \x01(\t\x12\x19\n\x11facet_matrix_json\x18\x06 \x01(\t\x12\x17\n\x0ftraversed_edges\x18\x07 '
    b'\x01(\x03"\x13\n\x11MembershipRequest"V\n\x12MembershipResponse\x12\x0f\n\x07tablets\x18\x01 '
    b'\x03(\t\x12\x15\n\rmax_commit_ts\x18\x02 \x01(\x04\x12\x18\n\x10pred_commit_json\x18\x03 \x01(\t"K\n\rMuta'
    b'teRequest\x12\x10\n\x08start_ts\x18\x01 \x01(\x04\x12(\n\x05edges\x18\x02 \x03(\x0b2\x19.dgraph_tpu.inte'
    b'rnal.Edge"|\n\x04Edge\x12\x0f\n\x07subject\x18\x01 \x01(\x04\x12\x0c\n\x04attr\x18\x02 \x01(\t\x12\x12\n\nobject_u'
    b'id\x18\x03 \x01(\x04\x12\x12\n\nvalue_json\x18\x04 \x01(\t\x12\n\n\x02op\x18\x05 \x01(\x05\x12\x0c\n\x04lang\x18\x06 \x01(\t\x12\x13\n\x0bfa'
    b'cets_json\x18\x07 \x01(\t"D\n\x0eMutateResponse\x12\x0c\n\x04keys\x18\x01 \x03(\x0c\x12\x15\n\rconflict_'
    b'keys\x18\x02 \x03(\x0c\x12\r\n\x05preds\x18\x03 \x03(\t"D\n\x0fDecisionRequest\x12\x10\n\x08start_ts\x18\x01 \x01'
    b'(\x04\x12\x11\n\tcommit_ts\x18\x02 \x01(\x04\x12\x0c\n\x04keys\x18\x03 \x03(\x0c"\x12\n\x10DecisionResponse"O\n\rA'
    b'ppendRequest\x12\x0c\n\x04term\x18\x01 \x01(\x04\x12\r\n\x05index\x18\x02 \x01(\x04\x12\x0c\n\x04data\x18\x03 \x01(\x0c\x12\x13\n\x0bl'
    b'eader_addr\x18\x04 \x01(\t";\n\x0eAppendResponse\x12\n\n\x02ok\x18\x01 \x01(\x08\x12\x0c\n\x04term\x18\x02 \x01(\x04'
    b'\x12\x0f\n\x07log_len\x18\x03 \x01(\x04"-\n\x0ePromoteRequest\x12\x0c\n\x04term\x18\x01 \x01(\x04\x12\r\n\x05peers\x18\x02'
    b' \x03(\t"+\n\x0fPromoteResponse\x12\n\n\x02ok\x18\x01 \x01(\x08\x12\x0c\n\x04term\x18\x02 \x01(\x04"V\n\x0bVoteReq'
    b'uest\x12\x0c\n\x04term\x18\x01 \x01(\x04\x12\x15\n\rmax_commit_ts\x18\x02 \x01(\x04\x12\x0f\n\x07log_len\x18\x03 \x01(\x04\x12\x11'
    b'\n\tcandidate\x18\x04 \x01(\t"-\n\x0cVoteResponse\x12\x0f\n\x07granted\x18\x01 \x01(\x08\x12\x0c\n\x04term\x18\x02'
    b' \x01(\x04"F\n\x10HeartbeatRequest\x12\x0c\n\x04term\x18\x01 \x01(\x04\x12\x13\n\x0bleader_addr\x18\x02 \x01(\t\x12'
    b'\x0f\n\x07members\x18\x03 \x03(\t"-\n\x11HeartbeatResponse\x12\x0c\n\x04term\x18\x01 \x01(\x04\x12\n\n\x02ok\x18\x02 '
    b'\x01(\x08"\x0f\n\rStatusRequest"\xe5\x01\n\x0eStatusResponse\x12\x0c\n\x04term\x18\x01 \x01(\x04\x12\x0f\n\x07log'
    b'_len\x18\x02 \x01(\x04\x12\x0e\n\x06leader\x18\x03 \x01(\x08\x12\x15\n\rmax_commit_ts\x18\x04 \x01(\x04\x12\x0f\n\x07tablets'
    b'\x18\x05 \x03(\t\x12\x14\n\x0ctablet_bytes\x18\x06 \x01(\x04\x12\x19\n\x11tablet_sizes_json\x18\x07 \x01(\t\x12(\n\x10t'
    b'ablet_load_json\x18\x08 \x01(\tR\x0etabletLoadJson\x12!\n\x0cmetrics_json\x18\t \x01(\tR'
    b'\x0bmetricsJson"d\n\x0bSortRequest\x12\x0c\n\x04attr\x18\x01 \x01(\t\x12\x0c\n\x04uids\x18\x02 \x01(\x0c\x12\x0c\n\x04d'
    b'esc\x18\x03 \x01(\x08\x12\x0c\n\x04lang\x18\x04 \x01(\t\x12\x0f\n\x07read_ts\x18\x05 \x01(\x04\x12\x0c\n\x04need\x18\x06 \x01(\x03"\x1c\n\x0cSo'
    b'rtResponse\x12\x0c\n\x04uids\x18\x01 \x01(\x0c"\x1e\n\rSchemaRequest\x12\r\n\x05preds\x18\x01 \x03(\t"%\n\x0e'
    b'SchemaResponse\x12\x13\n\x0bschema_json\x18\x01 \x01(\t"\x1d\n\x10ZeroLeaseRequest\x12\t\n\x01n'
    b'\x18\x01 \x01(\x04""\n\x11ZeroLeaseResponse\x12\r\n\x05first\x18\x01 \x01(\x04"Z\n\x11ZeroCommitRequ'
    b'est\x12\x10\n\x08start_ts\x18\x01 \x01(\x04\x12\x15\n\rconflict_keys\x18\x02 \x03(\x0c\x12\r\n\x05preds\x18\x03 \x03(\t\x12'
    b'\r\n\x05abort\x18\x04 \x01(\x08"8\n\x12ZeroCommitResponse\x12\x11\n\tcommit_ts\x18\x01 \x01(\x04\x12\x0f\n\x07a'
    b'borted\x18\x02 \x01(\x08"4\n\x11ZeroTabletRequest\x12\x0c\n\x04attr\x18\x01 \x01(\t\x12\x11\n\tread_only'
    b'\x18\x02 \x01(\x08"#\n\x12ZeroTabletResponse\x12\r\n\x05group\x18\x01 \x01(\x05"1\n\x12ZeroConnectRe'
    b'quest\x12\x0c\n\x04addr\x18\x01 \x01(\t\x12\r\n\x05group\x18\x02 \x01(\x05"8\n\x13ZeroConnectResponse\x12\r\n'
    b'\x05group\x18\x01 \x01(\x05\x12\x12\n\nreplica_id\x18\x02 \x01(\x05"\x12\n\x10ZeroStateRequest"V\n\x0fZero'
    b'ShipRequest\x12\x0c\n\x04term\x18\x01 \x01(\x04\x12\x0b\n\x03seq\x18\x02 \x01(\x04\x12\x12\n\nstate_json\x18\x03 \x01(\t\x12\x14'
    b'\n\x0cmembers_json\x18\x04 \x01(\t"9\n\x10ZeroShipResponse\x12\n\n\x02ok\x18\x01 \x01(\x08\x12\x0c\n\x04term'
    b'\x18\x02 \x01(\x04\x12\x0b\n\x03seq\x18\x03 \x01(\x04"?\n\x0fZeroVoteRequest\x12\x0c\n\x04term\x18\x01 \x01(\x04\x12\x0b\n\x03seq\x18'
    b'\x02 \x01(\x04\x12\x11\n\tcandidate\x18\x03 \x01(\t"1\n\x10ZeroVoteResponse\x12\x0f\n\x07granted\x18\x01 \x01('
    b'\x08\x12\x0c\n\x04term\x18\x02 \x01(\x04"E\n\x0fZeroPingRequest\x12\x0c\n\x04term\x18\x01 \x01(\x04\x12\x13\n\x0bleader_a'
    b'ddr\x18\x02 \x01(\t\x12\x0f\n\x07members\x18\x03 \x03(\t"<\n\x10ZeroPingResponse\x12\x0c\n\x04term\x18\x01 \x01(\x04'
    b'\x12\n\n\x02ok\x18\x02 \x01(\x08\x12\x0e\n\x06leader\x18\x03 \x01(\x08"\'\n\x11ZeroStateResponse\x12\x12\n\nstate_j'
    b'son\x18\x01 \x01(\t"\x13\n\x11FetchStateRequest"V\n\x12FetchStateResponse\x12\x10\n\x08snap'
    b'shot\x18\x01 \x01(\x0c\x12\x0b\n\x03wal\x18\x02 \x01(\x0c\x12\x13\n\x0bsession_seq\x18\x03 \x01(\x04\x12\x0c\n\x04term\x18\x04 \x01(\x04"i'
    b'\n\x14PredicateDataRequest\x12\x0c\n\x04attr\x18\x01 \x01(\t\x12\x0f\n\x07read_ts\x18\x02 \x01(\x04\x12\x10\n\x08sta'
    b'rt_ts\x18\x03 \x01(\x04\x12\r\n\x05after\x18\x04 \x01(\x0c\x12\x11\n\tmax_bytes\x18\x05 \x01(\x04"R\n\x15PredicateDa'
    b'taResponse\x12\x0f\n\x07records\x18\x01 \x03(\x0c\x12\x0c\n\x04keys\x18\x02 \x03(\x0c\x12\x0c\n\x04next\x18\x03 \x01(\x0c\x12\x0c\n\x04d'
    b'one\x18\x04 \x01(\x08" \n\rIngestRequest\x12\x0f\n\x07records\x18\x01 \x03(\x0c""\n\x0eIngestRespons'
    b'e\x12\x10\n\x08ingested\x18\x01 \x01(\x04"&\n\x16DeletePredicateRequest\x12\x0c\n\x04attr\x18\x01 \x01(\t"'
    b'\x19\n\x17DeletePredicateResponse"w\n\x12TabletDeltaRequest\x12\x12\n\x04attr\x18\x01 \x01'
    b'(\tR\x04attr\x12\x19\n\x08since_ts\x18\x02 \x01(\x04R\x07sinceTs\x12\x17\n\x07read_ts\x18\x03 \x01(\x04R\x06readTs'
    b'\x12\x19\n\x08start_ts\x18\x04 \x01(\x04R\x07startTs"\x82\x01\n\x13TabletDeltaResponse\x12\x18\n\x07recor'
    b'ds\x18\x01 \x03(\x0cR\x07records\x12\x12\n\x04keys\x18\x02 \x03(\x0cR\x04keys\x12\x1c\n\twatermark\x18\x03 \x01(\x04R\twa'
    b'termark\x12\x1f\n\x0bfull_resync\x18\x04 \x01(\x08R\nfullResyncb\x06proto3'
)

_FILE = descriptor_pb2.FileDescriptorProto.FromString(_SERIALIZED)
_FILE.name = "dgraph_tpu_torch/protos/internal.proto"
POOL = descriptor_pool.DescriptorPool()
DESCRIPTOR = POOL.Add(_FILE)


def _cls(name: str):
    return message_factory.GetMessageClass(
        POOL.FindMessageTypeByName(f"dgraph_tpu.internal.{name}"))


TaskRequest = _cls("TaskRequest")
TaskResponse = _cls("TaskResponse")
MembershipRequest = _cls("MembershipRequest")
MembershipResponse = _cls("MembershipResponse")
MutateRequest = _cls("MutateRequest")
Edge = _cls("Edge")
MutateResponse = _cls("MutateResponse")
DecisionRequest = _cls("DecisionRequest")
DecisionResponse = _cls("DecisionResponse")
AppendRequest = _cls("AppendRequest")
AppendResponse = _cls("AppendResponse")
PromoteRequest = _cls("PromoteRequest")
PromoteResponse = _cls("PromoteResponse")
VoteRequest = _cls("VoteRequest")
VoteResponse = _cls("VoteResponse")
HeartbeatRequest = _cls("HeartbeatRequest")
HeartbeatResponse = _cls("HeartbeatResponse")
StatusRequest = _cls("StatusRequest")
StatusResponse = _cls("StatusResponse")
SortRequest = _cls("SortRequest")
SortResponse = _cls("SortResponse")
SchemaRequest = _cls("SchemaRequest")
SchemaResponse = _cls("SchemaResponse")
ZeroLeaseRequest = _cls("ZeroLeaseRequest")
ZeroLeaseResponse = _cls("ZeroLeaseResponse")
ZeroCommitRequest = _cls("ZeroCommitRequest")
ZeroCommitResponse = _cls("ZeroCommitResponse")
ZeroTabletRequest = _cls("ZeroTabletRequest")
ZeroTabletResponse = _cls("ZeroTabletResponse")
ZeroConnectRequest = _cls("ZeroConnectRequest")
ZeroConnectResponse = _cls("ZeroConnectResponse")
ZeroStateRequest = _cls("ZeroStateRequest")
ZeroShipRequest = _cls("ZeroShipRequest")
ZeroShipResponse = _cls("ZeroShipResponse")
ZeroVoteRequest = _cls("ZeroVoteRequest")
ZeroVoteResponse = _cls("ZeroVoteResponse")
ZeroPingRequest = _cls("ZeroPingRequest")
ZeroPingResponse = _cls("ZeroPingResponse")
ZeroStateResponse = _cls("ZeroStateResponse")
FetchStateRequest = _cls("FetchStateRequest")
FetchStateResponse = _cls("FetchStateResponse")
PredicateDataRequest = _cls("PredicateDataRequest")
PredicateDataResponse = _cls("PredicateDataResponse")
IngestRequest = _cls("IngestRequest")
IngestResponse = _cls("IngestResponse")
DeletePredicateRequest = _cls("DeletePredicateRequest")
DeletePredicateResponse = _cls("DeletePredicateResponse")
TabletDeltaRequest = _cls("TabletDeltaRequest")
TabletDeltaResponse = _cls("TabletDeltaResponse")
